// Host emulation of bloom_positions_kernel (csrc/hitset_bloom.cu) for the
// CPU tests; built by bloom_emulate.py with g++, never part of the port's
// CUDA build.
//
// bloom_device.inc is csrc/hitset_bloom.cu up to its host entry: the hash,
// the magic reciprocal (bloom_mod, computed on the host as the entry does),
// the remainder, the kernel and its grid (bloom_blocks).  The CUDA builtins
// they use are defined below; the grid the entry would launch runs one
// thread at a time, block by block, so the grid-stride loop takes the same
// steps as on the card.
//
//   bloom_emulate INPUT OUTPUT
//
// INPUT holds an int64 job count, then per job three int64 (b, nhash,
// nbits) and b uint32 hashes.  OUTPUT gets per job the (b, nhash) uint32
// positions, then four int64: the magic m, sh1, sh2 and the grid's blocks.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(...)
#define __restrict__

struct Dim {
  unsigned x;
};
static Dim threadIdx, blockIdx, gridDim;

static inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
template <class T>
static inline T __ldg(const T* p) {
  return *p;
}

#include "bloom_device.inc"

static void read_exact(FILE* f, void* p, size_t n) {
  if (n && fread(p, 1, n, f) != n) {
    fprintf(stderr, "short read\n");
    exit(2);
  }
}

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: bloom_emulate INPUT OUTPUT\n");
    return 2;
  }
  FILE* in = fopen(argv[1], "rb");
  FILE* out = fopen(argv[2], "wb");
  if (!in || !out) return 2;
  int64_t jobs;
  read_exact(in, &jobs, 8);
  for (int64_t j = 0; j < jobs; j++) {
    int64_t hdr[3];
    read_exact(in, hdr, sizeof hdr);
    const long long b = hdr[0];
    const int nhash = (int)hdr[1];
    std::vector<uint32_t> h(b), pos(b * nhash);
    read_exact(in, h.data(), b * 4);
    const BloomMod mod = bloom_mod((uint32_t)hdr[2]);
    gridDim.x = bloom_blocks(b);
    for (blockIdx.x = 0; blockIdx.x < gridDim.x; blockIdx.x++)
      for (threadIdx.x = 0; threadIdx.x < BLOOM_THREADS; threadIdx.x++)
        bloom_positions_kernel(h.data(), pos.data(), b, nhash, mod);
    fwrite(pos.data(), 4, pos.size(), out);
    const int64_t tail[4] = {mod.m, mod.sh1, mod.sh2, gridDim.x};
    fwrite(tail, 8, 4, out);
  }
  fclose(out);
  fclose(in);
  return 0;
}
