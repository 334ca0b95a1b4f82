// Bloom-filter bit positions and sealed bitsets of the hit sets on Hopper
// (sm_90a).
//
// Replaces the XLA device code of ceph_tpu/osd/hitset.py bloom_positions
// (xp=jnp, one jitted dispatch through _device_positions, :70-120), and the
// host scatter-OR that BloomHitSet.insert_batch runs on its output (:164-176).
// Two entries:
//
// bloom_positions: out[b, i] = hash32_2(h[b], i) % nbits for i in [0, nhash)
// on [B] uint32 object hashes -> [B, nhash] uint32 positions, nhash <= 32
// (bloom_geometry) and nbits any value in [1, 2^32 - 1], as a rule no power
// of two.  The query side (contains_batch) uses it.  Its plain version is
// ceph_tpu_torch/osd/hitset.py bloom_positions_torch.
//
// bloom_seal: S hit sets of one geometry sealed in one launch.  Set s holds
// hashes[offsets[s] .. offsets[s + 1]); its row of out ([S, nwords] uint32,
// nwords = ceil(nbits / 32)) gets bit p for every position p of every hash,
// word p >> 5, bit p & 31, so the row's little-endian bytes cut to
// ceil(nbits / 8) are the reference's bitset (bits[p >> 3] |= 1 << (p & 7)),
// trailing bits zero.  Its plain version is ops/bloom_kernels.py
// bloom_seal_plain.
//
// What bounds them on the H100: bloom_positions reads 4 bytes a hash and
// writes 4 * nhash; at B = 65,536 and nhash = 4 that is 1.25 MiB, 0.39 us at
// 3.35 TB/s, and about 88 lane instructions a position (the rjenkins mix,
// the remainder), 0.69 us at 33.5 T/s.  A tier's rotation seals each PG's
// set alone, about 16 hashes at 6,385 bits: 64 bytes in, 800 out and 64
// positions, nanoseconds of either.  So a seal is bound by its launch and
// copies, and the design keeps it to one launch, one copy in and one copy
// out, and seals any number of sets in that one launch:
//   - one block a set (and more, striding over chunks of BLOOM_SEAL_CHUNK
//     hashes, for a set too large for one block), a thread per (hash,
//     seed) pair, so a set of 16 hashes at nhash 4 is one pass of 64 lanes;
//   - the set's bitset lives in shared memory (up to BLOOM_SEAL_SMEM_WORDS
//     words, 1,859,584 bits): zeroed, then every position ORed in with a
//     shared-memory atomicOr, then after __syncthreads written out in
//     coalesced words; a block that owns its whole set stores its row, one
//     of several chunks ORs its nonzero words into the row with global
//     atomics;
//   - a bitset past the shared budget ORs each position straight into its
//     row with a global atomicOr; the entry zeroes the rows first whenever
//     any block ORs into them (a memset before the kernel);
//   - `% nbits` by a runtime divisor goes through a 32-bit magic reciprocal
//     (Granlund and Montgomery's round-up method, valid for every 32-bit
//     dividend and divisor): the entry computes (m, sh1, sh2) once per
//     launch on the host, and a lane pays one __umulhi, a subtract, an add,
//     two shifts and a multiply-subtract; the seal splits a pair index into
//     hash and seed with the same method (divisor nhash).
// bloom_positions keeps one thread per hash with the seeds in a loop, so a
// hash is loaded once, and a grid that strides, so any B takes one launch.
// hash32_2 and its mix are those of csrc/crush.cu (the rjenkins hash of
// crush/hash.c), copied so each source builds alone.

#include <cuda_runtime.h>

#include <cstdint>

constexpr int BLOOM_THREADS = 256;
constexpr int BLOOM_MAX_NHASH = 32;
constexpr long long BLOOM_MAX_BLOCKS = 132 * 16;
constexpr int BLOOM_SEAL_THREADS = 256;
constexpr int BLOOM_SEAL_CHUNK = 512;           // hashes a block takes a pass
constexpr int BLOOM_SEAL_SMEM_WORDS = 232448 / 4;   // a block's 227 KB
constexpr long long BLOOM_SEAL_MAX_CHUNKS = 65535;  // gridDim.y

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

__device__ __forceinline__ uint32_t bloom_quot(uint32_t n, const BloomMod& p) {
  const uint32_t t = __umulhi(p.m, n);
  return (t + ((n - t) >> p.sh1)) >> p.sh2;
}

__device__ __forceinline__ uint32_t bloom_rem(uint32_t n, const BloomMod& p) {
  return n - bloom_quot(n, p) * p.d;
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

// One block a set, or gridDim.y blocks a set, each taking the chunks
// blockIdx.y, blockIdx.y + gridDim.y, ... of BLOOM_SEAL_CHUNK hashes.  With
// `shared` the set's bitset is built in dynamic shared memory of nwords
// words; a block stores its row when it is its set's only block
// (gridDim.y == 1), else ORs its nonzero words into the zeroed row.
// Without it every position is ORed into the zeroed row.  by_seed divides
// a (hash, seed) pair's index by nhash.
extern __shared__ uint32_t bloom_seal_bits[];

__global__ void __launch_bounds__(BLOOM_SEAL_THREADS)
    bloom_seal_kernel(const uint32_t* __restrict__ hashes,
                      const int* __restrict__ offsets,
                      uint32_t* __restrict__ out, int nwords, int nhash,
                      BloomMod mod, BloomMod by_seed, bool shared) {
  const long long lo = offsets[blockIdx.x], hi = offsets[blockIdx.x + 1];
  uint32_t* row = out + (long long)blockIdx.x * nwords;
  const long long first = lo + (long long)blockIdx.y * BLOOM_SEAL_CHUNK;
  const long long step = (long long)gridDim.y * BLOOM_SEAL_CHUNK;
  // a chunk block with nothing of its set: the row is zeroed already
  if (gridDim.y > 1 && first >= hi) return;
  uint32_t* bits = shared ? bloom_seal_bits : row;
  if (shared) {
    for (int w = threadIdx.x; w < nwords; w += BLOOM_SEAL_THREADS)
      bloom_seal_bits[w] = 0;
    __syncthreads();
  }
  for (long long c = first; c < hi; c += step) {
    const long long left = hi - c;
    const uint32_t pairs = (uint32_t)(left < BLOOM_SEAL_CHUNK
                                          ? left : BLOOM_SEAL_CHUNK) * nhash;
    for (uint32_t j = threadIdx.x; j < pairs; j += BLOOM_SEAL_THREADS) {
      const uint32_t i = bloom_quot(j, by_seed);
      const uint32_t p = bloom_rem(
          bloom_hash32_2(__ldg(hashes + c + i), j - i * nhash), mod);
      atomicOr(bits + (p >> 5), 1u << (p & 31));
    }
  }
  if (!shared) return;
  __syncthreads();
  if (gridDim.y == 1) {
    for (int w = threadIdx.x; w < nwords; w += BLOOM_SEAL_THREADS)
      row[w] = bloom_seal_bits[w];
  } else {
    for (int w = threadIdx.x; w < nwords; w += BLOOM_SEAL_THREADS) {
      const uint32_t v = bloom_seal_bits[w];
      if (v) atomicOr(row + w, v);
    }
  }
}

// A seal's launch: gridDim.y covers the largest set in chunks, up to the
// grid's limit; the rows are zeroed first where a block ORs into them.
struct BloomSealPlan {
  unsigned sets, chunks;
  bool shared, zero_rows;
  size_t smem;
};

static BloomSealPlan bloom_seal_plan(long long sets, long long max_set,
                                     long long nwords) {
  long long chunks = (max_set + BLOOM_SEAL_CHUNK - 1) / BLOOM_SEAL_CHUNK;
  chunks = chunks < 1 ? 1 : chunks;
  chunks = chunks < BLOOM_SEAL_MAX_CHUNKS ? chunks : BLOOM_SEAL_MAX_CHUNKS;
  const bool shared = nwords <= BLOOM_SEAL_SMEM_WORDS;
  return {(unsigned)sets, (unsigned)chunks, shared, !shared || chunks > 1,
          shared ? (size_t)nwords * 4 : 0};
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

// hashes: device pointer to the n uint32 hashes of all sets; offsets:
// device pointer to sets + 1 int32, offsets[0] = 0, offsets[sets] = n, not
// decreasing; max_set: the largest offsets[s + 1] - offsets[s]; out: device
// pointer to sets x ceil(nbits / 32) uint32.  All 4-byte aligned.  Returns
// a cudaError_t.
int bloom_seal(const void* hashes, const void* offsets, void* out, int sets,
               long long max_set, int nhash, unsigned nbits, int device,
               void* stream) {
  if (sets < 1 || max_set < 0 || nhash < 1 || nhash > BLOOM_MAX_NHASH ||
      nbits < 1 || reinterpret_cast<uintptr_t>(hashes) % 4 ||
      reinterpret_cast<uintptr_t>(offsets) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 4)
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long nwords = ((long long)nbits + 31) / 32;
  const BloomSealPlan plan = bloom_seal_plan(sets, max_set, nwords);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.zero_rows) {
    err = cudaMemsetAsync(out, 0, (size_t)sets * nwords * 4, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (plan.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(bloom_seal_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BLOOM_SEAL_SMEM_WORDS * 4);
    if (err != cudaSuccess) return (int)err;
  }
  bloom_seal_kernel<<<dim3(plan.sets, plan.chunks), BLOOM_SEAL_THREADS,
                      plan.smem, s>>>(static_cast<const uint32_t*>(hashes),
                           static_cast<const int*>(offsets),
                           static_cast<uint32_t*>(out), (int)nwords, nhash,
                           bloom_mod(nbits), bloom_mod((uint32_t)nhash),
                           plan.shared);
  return (int)cudaGetLastError();
}

// bloom_seal with its copies, for a caller on the host: host_in (pinned)
// holds the sets + 1 int32 offsets, then the n uint32 hashes; they go up to
// dev_in (as many int32), one bloom_seal seals every set into dev_out, and
// the rows come down to host_out (pinned, sets x ceil(nbits / 32) uint32).
// Returns once they are there (the stream synchronised), a cudaError_t.
int bloom_seal_staged(const void* host_in, void* dev_in, long long n,
                      void* dev_out, void* host_out, int sets,
                      long long max_set, int nhash, unsigned nbits,
                      int device, void* stream) {
  if (sets < 1 || n < 0 || nbits < 1) return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemcpyAsync(dev_in, host_in, ((size_t)sets + 1 + n) * 4,
                        cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  const int rc = bloom_seal(static_cast<int*>(dev_in) + sets + 1, dev_in,
                            dev_out, sets, max_set, nhash, nbits, device,
                            stream);
  if (rc != (int)cudaSuccess) return rc;
  err = cudaMemcpyAsync(host_out, dev_out,
                        (size_t)sets * (((size_t)nbits + 31) / 32) * 4,
                        cudaMemcpyDeviceToHost, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamSynchronize(s);
}

}  // extern "C"
