// Zero-seeded crc32c (Castagnoli, reflected, no inversion) of N equal blocks
// on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ceph_tpu/ops/crc_pallas.py _crc_kernel /
// _crc_call (reached from crc32c_blocks_words).  That kernel multiplies each
// word's bit planes by a precomputed (8L, 32) GF(2) matrix on the MXU and is
// limited to blocks of at most 8 KiB; this one takes any block length that is
// a multiple of 4 bytes (the main path's hinfo chunks are 512 KiB).
//
// What bounds it on the H100: every block byte is read once and 4 bytes are
// written per block, so it is HBM-bound: the main path's 704 blocks of
// 512 KiB are 352 MiB, 0.11 ms at 3.35 TB/s.  The table-driven crc costs
// four shared-memory lookups and about seven integer instructions per 4
// bytes, under 0.02 ms for those blocks when the card is full.
//
// What the design does about it: a crc is a serial chain, so parallelism has
// to come from splitting each block.  One thread block (up to 256 threads)
// takes one crc block at a time, in a grid-stride loop so that the
// slicing-by-4 tables it builds in shared memory serve many blocks.  The
// block is viewed as front-padded with zeros to threads x span bytes (leading
// zeros leave a zero-seeded crc unchanged); each thread computes the
// zero-seeded crc of its own contiguous span with 16-byte loads where the
// layout allows.  The partial crcs are then folded in a tree: at level l the
// left partial is advanced through span << l zero bytes by a 32x32 GF(2)
// matrix and XORed into the right one (crc(A||B) = Z_|B|(crc(A)) ^ crc(B)),
// the math of ceph_tpu/ops/checksum.py's tree combine.  The host builds the
// matrices for the span lengths and passes them by value.  With 704 blocks of
// 512 KiB on 132 SMs, one warp per block would leave most of the card idle;
// that is why a thread block, not a warp, takes a crc block.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#define CRC_MAX_LEVELS 8
#define CRC_MAX_THREADS (1 << CRC_MAX_LEVELS)
#define CRC_POLY 0x82F63B78u

struct AdvanceParams {
  // cols[l][b]: the crc that bit b advances to through (span << l) zeros
  uint32_t cols[CRC_MAX_LEVELS][32];
};

__device__ __forceinline__ uint32_t gf2_apply(const uint32_t* cols,
                                              uint32_t v) {
  uint32_t out = 0u;
#pragma unroll
  for (int b = 0; b < 32; ++b) out ^= cols[b] & (0u - ((v >> b) & 1u));
  return out;
}

__device__ __forceinline__ uint32_t crc_word(const uint32_t (*tab)[256],
                                             uint32_t crc, uint32_t w) {
  crc ^= w;
  return tab[3][crc & 0xffu] ^ tab[2][(crc >> 8) & 0xffu] ^
         tab[1][(crc >> 16) & 0xffu] ^ tab[0][crc >> 24];
}

template <bool VEC4>
__global__ void __launch_bounds__(CRC_MAX_THREADS)
    crc_kernel(const __grid_constant__ AdvanceParams p, int levels,
               const uint8_t* __restrict__ blocks, long long n_blocks,
               long long length, long long span, uint32_t* __restrict__ out) {
  __shared__ uint32_t tab[4][256];
  __shared__ uint32_t part[CRC_MAX_THREADS];
  const int t = threadIdx.x;
  const int nt = blockDim.x;

  // slicing-by-4 tables: tab[0] is the bytewise table, tab[k][i] advances
  // tab[k-1][i] by one more zero byte
  for (int i = t; i < 256; i += nt) {
    uint32_t c = (uint32_t)i;
    for (int b = 0; b < 8; ++b) c = (c & 1u) ? (c >> 1) ^ CRC_POLY : c >> 1;
    tab[0][i] = c;
  }
  __syncthreads();
  for (int k = 1; k < 4; ++k) {
    for (int i = t; i < 256; i += nt) {
      const uint32_t c = tab[k - 1][i];
      tab[k][i] = (c >> 8) ^ tab[0][c & 0xffu];
    }
    __syncthreads();
  }

  const long long pad = span * nt - length;
  long long lo = (long long)t * span - pad;
  long long hi = lo + span;
  lo = lo < 0 ? 0 : lo;
  hi = hi < 0 ? 0 : hi;
  for (long long n = blockIdx.x; n < n_blocks; n += gridDim.x) {
    const uint8_t* base = blocks + n * length;
    uint32_t crc = 0u;
    if constexpr (VEC4) {
      const uint4* v = reinterpret_cast<const uint4*>(base + lo);
      const long long nv = (hi - lo) / 16;
      for (long long q = 0; q < nv; ++q) {
        const uint4 u = __ldg(v + q);
        crc = crc_word(tab, crc, u.x);
        crc = crc_word(tab, crc, u.y);
        crc = crc_word(tab, crc, u.z);
        crc = crc_word(tab, crc, u.w);
      }
    } else {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(base + lo);
      const long long nw = (hi - lo) / 4;
      for (long long q = 0; q < nw; ++q) crc = crc_word(tab, crc, __ldg(w + q));
    }
    part[t] = crc;
    __syncthreads();
    for (int l = 0; l < levels; ++l) {
      const int stride = 1 << l;
      if ((t & (2 * stride - 1)) == 0)
        part[t] = gf2_apply(p.cols[l], part[t]) ^ part[t + stride];
      __syncthreads();
    }
    if (t == 0) out[n] = part[0];
    __syncthreads();  // part[] is rewritten by the next block
  }
}

extern "C" {

// cols: host array of levels * 32 uint32 (advance matrices for span << l
// zero bytes).  blocks: device pointer to n_blocks * length bytes, 16-byte
// aligned; out: device pointer to n_blocks uint32.  Threads = 1 << levels,
// each covering `span` bytes of the front-padded block.  Returns a
// cudaError_t.
int crc32c_blocks(const uint32_t* cols, int levels, int device,
                  const void* blocks, long long n_blocks, long long length,
                  long long span, void* out, void* stream) {
  const int threads = 1 << levels;
  if (levels < 0 || levels > CRC_MAX_LEVELS || n_blocks < 1 || length < 4 ||
      length % 4 != 0 || span < 4 || span % 4 != 0 ||
      span * threads < length)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  AdvanceParams p;
  memset(&p, 0, sizeof(p));
  memcpy(p.cols, cols, sizeof(uint32_t) * 32 * levels);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // enough resident blocks to fill every SM (2048 threads, 32 blocks each)
  const int per_sm = 2048 / threads < 32 ? 2048 / threads : 32;
  long long grid = (long long)sms * per_sm;
  if (grid > n_blocks) grid = n_blocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(blocks);
  uint32_t* dst = static_cast<uint32_t*>(out);
  if (length % 16 == 0 && span % 16 == 0)
    crc_kernel<true><<<(unsigned)grid, threads, 0, st>>>(
        p, levels, src, n_blocks, length, span, dst);
  else
    crc_kernel<false><<<(unsigned)grid, threads, 0, st>>>(
        p, levels, src, n_blocks, length, span, dst);
  return (int)cudaGetLastError();
}

}  // extern "C"
