// GF(2^8) row-weighted XOR fold of shard streams on Hopper (sm_90a).
//
// Replaces the XLA device code of the coded-compute kernels,
// ceph_tpu/compute/kernels.py make_device_eval (run through
// ceph_tpu/ec/plan.py _build_compute / compute_eval):
//   out[b, l] = XOR over r of w[r] * data[b, r, l]   (GF(2^8), poly 0x11d)
// on (B, rows, lanes) uint8 -> (B, lanes) uint8.  No weights means every
// w[r] = 1: a plain XOR fold (the gf_fold compute kernel); the
// gf_fingerprint kernel gives each row its own nonzero weight.
//
// What bounds it on the H100: every input byte is read once, and the rest
// is tiny (B * lanes output bytes, one weight byte per row); at the scan's
// (44, 262144, 32) that is 352 MiB, 0.110 ms at 3.35 TB/s.  The design:
//   - the work is along rows, not batch items (B = 44 at the scan's shape,
//     the card has 132 SMs), so each item's rows are cut into chunks and
//     the grid strides over (item, chunk) tiles, about as many as the card
//     holds blocks at once (fold_grid);
//   - a thread loads 16 bytes at a time (4 bytes when lanes % 16 != 0), the
//     block's threads on neighbouring vectors, FOLD_UNROLL loads in flight
//     before any arithmetic.  The thread stride is a multiple of the
//     vectors per row, so a thread always meets the same lanes and keeps
//     one packed accumulator for them, and its row advances by a constant
//     (no division per vector);
//   - weighted rows cost no multiply per byte: a thread keeps eight
//     bit-plane accumulators, P[s] = XOR of the rows whose weight has bit s
//     set (one AND and one XOR per word and bit, a LOP3), and after its
//     last row turns them into the fold once, by Horner on packed words:
//     acc = P[7], then acc = xtime(acc) ^ P[s] for s = 6 .. 0 (multiplying
//     by x is GF(2)-linear, so sum_r w[r] x_r = sum_s x^s P[s]).  All-ones
//     weights take the plain XOR path, as the reference specialises them;
//   - partials reduce by warp shuffle (lanes that share a slot), then in
//     shared memory, and tiles combine with atomicXor on the 32-bit output
//     words, which the entry zeroes first on the same stream.  XOR is
//     associative and commutative, so the order of the atomics does not
//     change a bit of the result, and there is no second pass, workspace
//     or launch: a tile adds lanes / 4 global atomics.
// The arithmetic stays under the byte bound: weighted, about 14 lane
// operations per 4-byte word (8 LOP3s, the masks of a row's weight shared
// by its 4 words, the loads); plain, one XOR per word.

#include <cuda_runtime.h>

#include <cstdint>

constexpr int FOLD_THREADS = 256;
constexpr int FOLD_MAX_LANES = 1024;  // the shared partials: lanes / 4 words
constexpr int FOLD_UNROLL = 4;        // vector loads in flight per thread
constexpr int FOLD_MAX_TARGET = 1 << 16;

// the grid of one launch: chunks per item, rows per chunk, blocks
struct FoldGrid {
  long long chunks, rows_per_chunk;
  unsigned blocks;
};

// vpr vectors per row; target: the blocks the card holds at once.  Chunks
// are cut so that the tiles fill the card about once, but no chunk is
// shorter than one unrolled step of the block.
static FoldGrid fold_grid(long long b, long long rows, int vpr, int target) {
  const long long stride = (FOLD_THREADS / vpr) * vpr;
  const long long min_rows = FOLD_UNROLL * (stride / vpr);
  long long chunks = (target + b - 1) / b;
  const long long most = rows / min_rows;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  const long long per = (rows + chunks - 1) / chunks;
  chunks = (rows + per - 1) / per;
  long long tiles = b * chunks;
  if (tiles > 4LL * target) tiles = 4LL * target;
  return FoldGrid{chunks, per, (unsigned)tiles};
}

__device__ __forceinline__ uint32_t fold_xtime(uint32_t v) {
  const uint32_t hi = (v >> 7) & 0x01010101u;
  return ((v << 1) & 0xfefefefeu) ^ (hi * 0x1du);
}

template <int NW>
struct FoldVec {
  uint32_t w[NW];
};

template <int NW>
__device__ __forceinline__ FoldVec<NW> fold_load(const uint8_t* p) {
  FoldVec<NW> v;
  if constexpr (NW == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    v.w[0] = q.x;
    v.w[1] = q.y;
    v.w[2] = q.z;
    v.w[3] = q.w;
  } else {
    v.w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
  return v;
}

// P[s] ^= v where bit s of the row's weight is set (branch-free masks)
template <int NW, bool WEIGHTED>
__device__ __forceinline__ void fold_add(uint32_t (&acc)[WEIGHTED ? 8 : 1][NW],
                                         const FoldVec<NW>& v, uint32_t w) {
  if constexpr (WEIGHTED) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const uint32_t m = 0u - ((w >> s) & 1u);
#pragma unroll
      for (int i = 0; i < NW; ++i) acc[s][i] ^= v.w[i] & m;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) acc[0][i] ^= v.w[i];
  }
}

// NW: 32-bit words per vector (4: 16-byte loads; 1: 4-byte loads).
// data: b items of rows x lanes bytes; weights: one byte per row (unused
// when !WEIGHTED); out: b x lanes / 4 words, zero before the launch.
template <int NW, bool WEIGHTED>
__global__ void __launch_bounds__(FOLD_THREADS)
    gf_fold_kernel(const uint8_t* __restrict__ data,
                   const uint8_t* __restrict__ weights,
                   uint32_t* __restrict__ out, long long b, long long rows,
                   int lanes, long long chunks, long long rows_per_chunk) {
  __shared__ uint32_t part[FOLD_MAX_LANES / 4];
  constexpr int VB = 4 * NW;  // bytes per vector
  const int t = (int)threadIdx.x;
  const int vpr = lanes / VB;
  const int stride = (FOLD_THREADS / vpr) * vpr;  // threads that load
  const int dr = stride / vpr;                    // rows per block step
  const int nwords = lanes / 4;
  for (int i = t; i < nwords; i += FOLD_THREADS) part[i] = 0;
  __syncthreads();
  const long long tiles = b * chunks;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long item = tile / chunks;
    const long long r0 = (tile - item * chunks) * rows_per_chunk;
    const long long r1 =
        r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;
    uint32_t acc[WEIGHTED ? 8 : 1][NW];
#pragma unroll
    for (int s = 0; s < (WEIGHTED ? 8 : 1); ++s)
#pragma unroll
      for (int i = 0; i < NW; ++i) acc[s][i] = 0;
    if (t < stride) {
      const uint8_t* item_base = data + item * rows * lanes;
      const uint8_t* p = item_base + r0 * lanes + (long long)t * VB;
      const uint8_t* const end = item_base + r1 * lanes;
      const uint8_t* wp = WEIGHTED ? weights + r0 + t / vpr : nullptr;
      const long long step = (long long)stride * VB;
      for (; p + (FOLD_UNROLL - 1) * step < end; p += FOLD_UNROLL * step) {
        FoldVec<NW> v[FOLD_UNROLL];
        uint32_t w[FOLD_UNROLL];
#pragma unroll
        for (int u = 0; u < FOLD_UNROLL; ++u) {
          v[u] = fold_load<NW>(p + u * step);
          w[u] = WEIGHTED ? __ldg(wp + u * dr) : 1u;
        }
#pragma unroll
        for (int u = 0; u < FOLD_UNROLL; ++u)
          fold_add<NW, WEIGHTED>(acc, v[u], w[u]);
        if constexpr (WEIGHTED) wp += FOLD_UNROLL * dr;
      }
      for (; p < end; p += step) {
        fold_add<NW, WEIGHTED>(acc, fold_load<NW>(p),
                               WEIGHTED ? __ldg(wp) : 1u);
        if constexpr (WEIGHTED) wp += dr;
      }
    }
    uint32_t res[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint32_t x = acc[WEIGHTED ? 7 : 0][i];
      if constexpr (WEIGHTED) {
#pragma unroll
        for (int s = 6; s >= 0; --s) x = fold_xtime(x) ^ acc[s][i];
      }
      res[i] = x;
    }
    // lanes of a warp that meet the same slot: XOR across them by shuffle
    // when the slots tile the warp, then one leader per slot
    bool lead = t < stride;
    if (32 % vpr == 0) {
      for (int off = 16; off >= vpr; off >>= 1)
#pragma unroll
        for (int i = 0; i < NW; ++i)
          res[i] ^= __shfl_xor_sync(0xffffffffu, res[i], off);
      lead = (t & 31) < vpr;
    }
    if (lead) {
      const int slot = t % vpr;
#pragma unroll
      for (int i = 0; i < NW; ++i)
        if (res[i]) atomicXor(&part[slot * NW + i], res[i]);
    }
    __syncthreads();
    for (int i = t; i < nwords; i += FOLD_THREADS) {
      const uint32_t x = part[i];
      if (x) atomicXor(out + item * nwords + i, x);
      part[i] = 0;
    }
    __syncthreads();
  }
}

namespace {

// blocks the card holds at once, per device and kernel, asked once
int g_targets[64][4];

template <int NW, bool WEIGHTED>
cudaError_t launch(const uint8_t* data, const uint8_t* weights,
                   uint32_t* out, long long b, long long rows, int lanes,
                   int device, cudaStream_t stream) {
  constexpr int which = (NW == 4 ? 2 : 0) + (WEIGHTED ? 1 : 0);
  int target = device >= 0 && device < 64 ? g_targets[device][which] : 0;
  if (target == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gf_fold_kernel<NW, WEIGHTED>, FOLD_THREADS, 0);
    if (err != cudaSuccess) return err;
    target = sms * (per_sm > 0 ? per_sm : 1);
    if (target > FOLD_MAX_TARGET) target = FOLD_MAX_TARGET;
    if (device >= 0 && device < 64) g_targets[device][which] = target;
  }
  const FoldGrid g = fold_grid(b, rows, lanes / (4 * NW), target);
  gf_fold_kernel<NW, WEIGHTED><<<g.blocks, FOLD_THREADS, 0, stream>>>(
      data, weights, out, b, rows, lanes, g.chunks, g.rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// weights: device pointer to `rows` bytes, or null for all-ones rows; data:
// device pointer to b x rows x lanes bytes, 16-byte aligned; out: device
// pointer to b x lanes bytes, 4-byte aligned, which this zeroes and then
// folds into.  Returns a cudaError_t.
int gf_fold(const void* weights, int device, const void* data, void* out,
            long long b, long long rows, int lanes, void* stream) {
  if (b < 1 || rows < 1 || lanes < 4 || lanes % 4 || lanes > FOLD_MAX_LANES ||
      reinterpret_cast<uintptr_t>(data) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 4)
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, (size_t)(b * lanes), st);
  if (err != cudaSuccess) return (int)err;
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* w = static_cast<const uint8_t*>(weights);
  auto* o = static_cast<uint32_t*>(out);
  if (lanes % 16 == 0)
    err = w ? launch<4, true>(d, w, o, b, rows, lanes, device, st)
            : launch<4, false>(d, w, o, b, rows, lanes, device, st);
  else
    err = w ? launch<1, true>(d, w, o, b, rows, lanes, device, st)
            : launch<1, false>(d, w, o, b, rows, lanes, device, st);
  return (int)err;
}

}  // extern "C"
