// Compressibility scores of each row of a (B, S) uint8 batch on Hopper
// (sm_90a): the 256-bin byte histogram, the order-0 entropy in bits per byte
// and the best self-match fraction over 18 probe lags, in one launch.
//
// Replaces XLA device code, not a Pallas kernel: ceph_tpu/compressor/
// scoring.py _byte_histograms_dev, _entropy_dev and _match_fraction_dev
// (:86-112).  There the histogram is a one-hot (B, S, 256) float32 sum
// (64 MiB for one 64 KiB span), the entropy a second pass over it, and each
// probe lag a compare and a mean over the row.  Written op by op in eager
// PyTorch the same scores take about 60 launches per call.  This kernel
// computes all three from one read of each row.
//
// What it computes, exactly as the reference does:
//  * hist[b][v]: the count of byte v in row b (int32);
//  * entropy[b] = sum over the bins with count > 0 of -p * log2(max(p,
//    1e-30)), p = count * r(S) in float32, r(n) = 1/n rounded to float32
//    (XLA turns the division by the constant S into that product; the bins
//    are summed in a fixed order that differs from XLA's: agreement within a
//    tolerance, not bit for bit);
//  * match[b] = max(0, max over lags L < S of count_L * r(S - L)), count_L
//    the positions i >= L with x[i] == x[i - L]: XLA's float32 mean, a sum
//    (exact below 2^24) times the rounded reciprocal, bit for bit.
//
// What bounds it on the H100.  Each byte is read once and 1032 bytes are
// written per row: a 64 KiB span is 20 ns of HBM time.  The operations are
// one histogram increment and 18 compare-and-counts per byte (fewer near a
// short row's start), about 19 lane-operations a byte: 1.25 M for a span,
// 37 ns at the card's integer issue rate.  So at the store's shapes it is
// bound by operations, and at (1, 65536) by the launch itself (a few
// microseconds) long before either.
//
// What the design does about it (PERF.md has its times):
//  * A row is split over up to SCORE_MAX_CHUNKS thread blocks of 256
//    threads (grid: rows x chunks), so the store's single 64 KiB span runs
//    on 16 SMs and not on one.  Chunk c takes tiles c, c + C, ... of 4096
//    bytes; each tile goes through shared memory behind a 512-byte halo
//    (the largest lag) read from device memory, so chunks share nothing but
//    their sums.  Loads are 16-byte vectors when S and the base are 16-byte
//    aligned, else bytes; bytes outside the row read as 0 and are never
//    counted.
//  * Thread t takes tile bytes t, t + 256, ...: a warp's 32 lanes read 32
//    consecutive bytes for each byte and each lag, no bank conflicts.
//  * Histograms in shared memory, one per warp (shared-memory atomics; a
//    constant row serialises them 32 ways, the worst case), merged per bin
//    and added into the row's histogram in device memory (zeroed by the
//    launcher) with one atomic per nonzero bin.
//  * The 18 lag counts in registers, summed over a warp by shuffles and over
//    the warps in shared memory, then added into the row's counts in device
//    memory.  The chunk that finishes last (a ticket per row, after a
//    fence) reads the row's sums back and computes the entropy, one warp
//    over the 256 bins in a fixed order, and the match fraction.

#include <cuda_runtime.h>
#include <cstdint>

#define SCORE_THREADS 256
#define SCORE_WARPS (SCORE_THREADS / 32)
#define SCORE_PER_THREAD 16                              // bytes per tile
#define SCORE_TILE (SCORE_THREADS * SCORE_PER_THREAD)    // 4096
#define SCORE_HALO 512                                   // the largest lag
#define SCORE_NLAGS 18
#define SCORE_MAX_CHUNKS 64                              // blocks per row
#define SCORE_SCRATCH (SCORE_NLAGS + 1)                  // ints per row
#define SCORE_FULL 0xffffffffu

// scoring.py _PROBE_LAGS
__constant__ int kScoreLags[SCORE_NLAGS] = {1,  2,  3,   4,   6,   8,
                                            12, 16, 24,  32,  48,  64,
                                            96, 128, 192, 256, 384, 512};

// hist_out (rows x 256) and scratch (rows x SCORE_SCRATCH: the 18 lag counts
// and the chunks-done ticket) are zero at launch.
__global__ void __launch_bounds__(SCORE_THREADS)
    score_kernel(const uint8_t* __restrict__ data, long long s,
                 int* __restrict__ hist_out, float* __restrict__ entropy_out,
                 float* __restrict__ match_out, int* __restrict__ scratch) {
  __shared__ int whist[SCORE_WARPS][256];
  __shared__ __align__(16) uint8_t buf[SCORE_HALO + SCORE_TILE];
  __shared__ int lag_part[SCORE_WARPS][SCORE_NLAGS];
  __shared__ int hist[256];
  __shared__ float frac[SCORE_NLAGS];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const int chunk = blockIdx.y, chunks = gridDim.y;
  const uint8_t* src = data + row * s;
  int* row_hist = hist_out + row * 256;
  int* row_lags = scratch + row * SCORE_SCRATCH;
  const bool vec =
      s % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;

  for (int i = tid; i < SCORE_WARPS * 256; i += SCORE_THREADS)
    (&whist[0][0])[i] = 0;
  int cnt[SCORE_NLAGS];
#pragma unroll
  for (int l = 0; l < SCORE_NLAGS; ++l) cnt[l] = 0;

  for (long long base = (long long)chunk * SCORE_TILE; base < s;
       base += (long long)chunks * SCORE_TILE) {
    __syncthreads();  // the last tile's reads are done
    if (vec) {
      const long long off = base + 16LL * tid;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (off < s) v = *reinterpret_cast<const uint4*>(src + off);
      *reinterpret_cast<uint4*>(buf + SCORE_HALO + 16 * tid) = v;
      if (tid < SCORE_HALO / 16) {
        const long long h = base - SCORE_HALO + 16LL * tid;
        uint4 w = make_uint4(0, 0, 0, 0);
        if (h >= 0) w = *reinterpret_cast<const uint4*>(src + h);
        *reinterpret_cast<uint4*>(buf + 16 * tid) = w;
      }
    } else {
      for (int j = tid; j < SCORE_HALO + SCORE_TILE; j += SCORE_THREADS) {
        const long long g = base - SCORE_HALO + j;
        buf[j] = (g >= 0 && g < s) ? src[g] : 0;
      }
    }
    __syncthreads();
    for (int j = 0; j < SCORE_PER_THREAD; ++j) {
      const int p = j * SCORE_THREADS + tid;
      const long long g = base + p;
      if (g >= s) break;
      const int x = buf[SCORE_HALO + p];
      atomicAdd(&whist[warp][x], 1);
#pragma unroll
      for (int l = 0; l < SCORE_NLAGS; ++l) {
        const int lag = kScoreLags[l];
        cnt[l] += (g >= lag && buf[SCORE_HALO + p - lag] == x) ? 1 : 0;
      }
    }
  }

#pragma unroll
  for (int l = 0; l < SCORE_NLAGS; ++l) {
    int v = cnt[l];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(SCORE_FULL, v, off);
    if (lane == 0) lag_part[warp][l] = v;
  }
  __syncthreads();  // every warp's histogram and lag counts are in

  // this chunk's sums into the row's, then a ticket: the last chunk of the
  // row finishes it
  int c = 0;
  for (int w = 0; w < SCORE_WARPS; ++w) c += whist[w][tid];
  if (c) atomicAdd(&row_hist[tid], c);
  if (tid < SCORE_NLAGS) {
    int total = 0;
    for (int w = 0; w < SCORE_WARPS; ++w) total += lag_part[w][tid];
    if (total) atomicAdd(&row_lags[tid], total);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&row_lags[SCORE_NLAGS], 1) == chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  hist[tid] = __ldcg(&row_hist[tid]);
  if (tid < SCORE_NLAGS) {
    const int lag = kScoreLags[tid];
    frac[tid] = lag < s ? __fmul_rn((float)__ldcg(&row_lags[tid]),
                                    __fdiv_rn(1.0f, (float)(s - lag)))
                        : 0.0f;
  }
  __syncthreads();

  if (warp == 0) {
    const float rs = __fdiv_rn(1.0f, (float)s);
    float sum = 0.0f;
    for (int i = 0; i < 8; ++i) {
      const int n = hist[lane * 8 + i];
      if (n > 0) {
        const float p = __fmul_rn((float)n, rs);
        sum += -p * log2f(fmaxf(p, 1e-30f));
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(SCORE_FULL, sum, off);
    if (lane == 0) {
      float best = 0.0f;
      for (int l = 0; l < SCORE_NLAGS; ++l)
        if (kScoreLags[l] < s) best = fmaxf(best, frac[l]);
      entropy_out[row] = sum;
      match_out[row] = best;
    }
  }
}

// thread blocks per row: one per 4096-byte tile, at most SCORE_MAX_CHUNKS
static inline int score_chunks(long long s) {
  const long long tiles = (s + SCORE_TILE - 1) / SCORE_TILE;
  return (int)(tiles < SCORE_MAX_CHUNKS ? tiles : SCORE_MAX_CHUNKS);
}

extern "C" {

int score_scratch_ints(void) { return SCORE_SCRATCH; }

// data: device pointer to b rows of s bytes; hist: b x 256 int32, entropy
// and match: b float32 each; scratch: b x score_scratch_ints() int32.  hist
// and scratch are zeroed here.  Returns a cudaError_t.
int score_blocks(const void* data, int device, long long b, long long s,
                 void* hist, void* entropy, void* match, void* scratch,
                 void* stream) {
  if (b < 1 || b > 0x7fffffffLL || s < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(hist, 0, (size_t)b * 256 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(scratch, 0, (size_t)b * SCORE_SCRATCH * sizeof(int),
                        st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)b, (unsigned)score_chunks(s));
  score_kernel<<<grid, SCORE_THREADS, 0, st>>>(
      static_cast<const uint8_t*>(data), s, static_cast<int*>(hist),
      static_cast<float*>(entropy), static_cast<float*>(match),
      static_cast<int*>(scratch));
  return (int)cudaGetLastError();
}

}  // extern "C"
