// Bloom-filter bit positions of the hit sets on Hopper (sm_90a).
//
// Replaces the XLA device code of ceph_tpu/osd/hitset.py bloom_positions
// (xp=jnp, one jitted dispatch through _device_positions, :70-120):
//   out[b, i] = hash32_2(h[b], i) % nbits      for i in [0, nhash)
// on [B] uint32 object hashes -> [B, nhash] uint32 positions, nhash <= 32
// (bloom_geometry) and nbits any value in [1, 2^32 - 1], as a rule no power
// of two.  The plain version is ceph_tpu_torch/osd/hitset.py
// bloom_positions_torch, whose eager PyTorch took 151 CUDA kernels a call.
//
// What bounds it on the H100: a call reads 4 bytes a hash and writes
// 4 * nhash; at B = 65,536 and nhash = 4 that is 1.25 MiB, 0.39 us at
// 3.35 TB/s, and about 40 integer operations a position (the rjenkins mix,
// the remainder).  Either is far below a launch and the two copies a call
// makes, so the call is bound by its launch and copies, not by this kernel.
// The design is the simplest that keeps every call to one launch:
//   - one thread per hash, the seeds in a loop, so a hash is loaded once;
//     a warp's stores cover 32 * nhash consecutive words;
//   - `% nbits` by a runtime divisor goes through a 32-bit magic reciprocal
//     (Granlund and Montgomery's round-up method, valid for every 32-bit
//     dividend and divisor): the entry computes (m, sh1, sh2) once per
//     launch on the host, and a lane pays one __umulhi, a subtract, an add,
//     two shifts and a multiply-subtract; no 64-bit division per lane;
//   - the grid strides, so any B takes one launch.
// hash32_2 and its mix are those of csrc/crush.cu (the rjenkins hash of
// crush/hash.c), copied so each source builds alone.

#include <cuda_runtime.h>

#include <cstdint>

constexpr int BLOOM_THREADS = 256;
constexpr int BLOOM_MAX_NHASH = 32;
constexpr long long BLOOM_MAX_BLOCKS = 132 * 16;

#define BLOOM_HASH_SEED 1315423911u

__device__ __forceinline__ void bloom_mix(uint32_t& a, uint32_t& b,
                                          uint32_t& c) {
  a -= b; a -= c; a ^= c >> 13;
  b -= c; b -= a; b ^= a << 8;
  c -= a; c -= b; c ^= b >> 13;
  a -= b; a -= c; a ^= c >> 12;
  b -= c; b -= a; b ^= a << 16;
  c -= a; c -= b; c ^= b >> 5;
  a -= b; a -= c; a ^= c >> 3;
  b -= c; b -= a; b ^= a << 10;
  c -= a; c -= b; c ^= b >> 15;
}

__device__ __forceinline__ uint32_t bloom_hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = BLOOM_HASH_SEED ^ a ^ b, x = 231232u, y = 1232u;
  bloom_mix(a, b, h);
  bloom_mix(x, a, h);
  bloom_mix(b, y, h);
  return h;
}

// n / d = (t + ((n - t) >> sh1)) >> sh2 with t = umulhi(m, n), for every
// 32-bit n and 1 <= d < 2^32 (Granlund and Montgomery 1994, figure 4.1).
struct BloomMod {
  uint32_t d, m;
  int sh1, sh2;
};

// host: l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1 (< 2^32)
static BloomMod bloom_mod(uint32_t d) {
  int l = 0;
  while (l < 32 && (1ull << l) < d) l++;
  const uint64_t m = ((((uint64_t)1 << l) - d) << 32) / d + 1;
  return {d, (uint32_t)m, l < 1 ? l : 1, l > 1 ? l - 1 : 0};
}

__device__ __forceinline__ uint32_t bloom_rem(uint32_t n, const BloomMod& p) {
  const uint32_t t = __umulhi(p.m, n);
  const uint32_t q = (t + ((n - t) >> p.sh1)) >> p.sh2;
  return n - q * p.d;
}

__global__ void __launch_bounds__(BLOOM_THREADS)
    bloom_positions_kernel(const uint32_t* __restrict__ hashes,
                           uint32_t* __restrict__ out, long long b,
                           int nhash, BloomMod mod) {
  const long long stride = (long long)gridDim.x * BLOOM_THREADS;
  for (long long i = (long long)blockIdx.x * BLOOM_THREADS + threadIdx.x;
       i < b; i += stride) {
    const uint32_t h = __ldg(hashes + i);
    uint32_t* o = out + i * nhash;
    for (int s = 0; s < nhash; s++)
      o[s] = bloom_rem(bloom_hash32_2(h, (uint32_t)s), mod);
  }
}

static unsigned bloom_blocks(long long b) {
  const long long need = (b + BLOOM_THREADS - 1) / BLOOM_THREADS;
  return (unsigned)(need < BLOOM_MAX_BLOCKS ? need : BLOOM_MAX_BLOCKS);
}

// ---- host entry ----

extern "C" {

// hashes: device pointer to b uint32; out: device pointer to b x nhash
// uint32; both 4-byte aligned.  Returns a cudaError_t.
int bloom_positions(const void* hashes, void* out, long long b, int nhash,
                    unsigned nbits, int device, void* stream) {
  if (b < 1 || nhash < 1 || nhash > BLOOM_MAX_NHASH || nbits < 1 ||
      reinterpret_cast<uintptr_t>(hashes) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 4)
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  bloom_positions_kernel<<<bloom_blocks(b), BLOOM_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hashes), static_cast<uint32_t*>(out), b,
      nhash, bloom_mod(nbits));
  return (int)cudaGetLastError();
}

}  // extern "C"
