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
// 37 ns at the card's issue rate.  So at the store's shapes it is bound by
// operations, and at (1, 65536) by the launch and the cross-block sum (a
// few microseconds) long before either.  Byte compares are integer logic,
// which only the ALU pipe executes, at half the issue rate; the design
// moves what it can to the FMA pipe.
//
// What the design does about it (PERF.md has its times):
//  * Lags on packed words.  A thread owns 16 contiguous bytes at a time, as
//    four 32-bit words in registers.  The word L bytes earlier is a word of
//    a 16-byte shared-memory read (L a multiple of 16: one read a lag), a
//    word of the own or the two preceding vectors (L a multiple of 4 up to
//    32), or a funnel shift of two of them (L = 1, 2, 3, 6).  A word pair
//    costs two LOP3s on the ALU and three FMA-pipe instructions, no compare:
//    y = ((a ^ b) & 0x7f7f7f7f) + 0x7f7f7f7f (the add a multiply-add by a
//    constant-memory 1) has bit 7 set where a byte's low 7 bits differ, so
//    f = ~(y | (a ^ b)) has bit 7 set in exactly the equal bytes, junk below
//    it; the sum of f's bytes as unsigned minus their sum as signed is 256
//    for each byte with bit 7 set, two dot products (dp4a) into the lag's
//    counter, whatever the junk.
//  * Lane-private histogram columns.  Bin v of lane l is the shared int at
//    v * 32 + l, shared by the block's 8 warps (a shared atomic add): the 32
//    lanes of a warp always hit 32 banks, whatever the data.  A row of
//    zeros costs what random bytes cost.  The atomics sit between the lags,
//    so that they issue while the ALU works.  The 32 columns are summed once
//    per block, each thread taking one bin, skewed so that a warp's reads
//    meet no bank twice.
//  * Warps walk, blocks do not wait.  A block takes a contiguous run of its
//    row's 4096-byte tiles and gives each warp a contiguous run of 512-byte
//    steps.  A warp keeps its current step in one of two shared slots,
//    behind a copy of the previous one (the halo, the largest lag), loads
//    the next step into registers while it counts the current one, and
//    meets no other warp until its run ends.  Blocks per row: as many as
//    the card holds at once (its SMs times the blocks an SM holds) over B,
//    at most one a tile; a 64 KiB span runs on 16 SMs, a 16 MiB batch of
//    256 spans as one block a row, in one wave.
//  * A workspace that resets itself.  Where a row has several blocks, each
//    writes its partial histogram and lag counts plainly into its own slot
//    of the workspace and takes a ticket; the block with the row's last
//    ticket sums the slots, writes hist, entropy and match, and zeroes the
//    slots and the ticket.  The workspace is zero before and after every
//    launch, so the wrapper zeroes it once, when it allocates it, and the
//    launcher makes no memset.  A row with one block writes its outputs
//    directly.
//  * One output buffer: a row of hist, entropy and match is 258 int32 words
//    (the two floats as their bits), copied back in one piece.

#include <cuda_runtime.h>
#include <cstdint>

#define SCORE_THREADS 256
#define SCORE_WARPS (SCORE_THREADS / 32)
#define SCORE_VEC 16                                     // bytes a thread owns
#define SCORE_TILE (SCORE_THREADS * SCORE_VEC)           // 4096
#define SCORE_STEP (32 * SCORE_VEC)            // a warp's bytes at a time
#define SCORE_HALO 512                                   // the largest lag
#define SCORE_NLAGS 18
#define SCORE_OUT_COLS 258                               // hist, entropy, match
#define SCORE_SLOT (256 + SCORE_NLAGS)                   // a block's partials
// The launcher fills the card with at most SCORE_MAX_TARGET blocks: a row
// has several blocks only when B x blocks per row <= that, so the workspace
// holds a ticket per row and a slot per block for any such grid.
#define SCORE_MAX_TARGET 1024
#define SCORE_WORKSPACE (SCORE_MAX_TARGET + SCORE_MAX_TARGET * SCORE_SLOT)
// a lag counter gains 256 per equal byte, at most 4096 a step: folded into
// the warp's sums long before it could wrap
#define SCORE_FLUSH_STEPS (1 << 19)
#define SCORE_FULL 0xffffffffu
#define SCORE_MIN_BLOCKS 3  // an SM holds 3 blocks (80 registers a thread)

// scoring.py _PROBE_LAGS
__constant__ int kScoreLags[SCORE_NLAGS] = {1,  2,  3,   4,   6,   8,
                                            12, 16, 24,  32,  48,  64,
                                            96, 128, 192, 256, 384, 512};
// Multipliers in constant memory, which ptxas cannot fold: with them an
// add and an address become multiply-adds, which issue on the FMA pipe,
// beside the logic that only the ALU pipe executes.
__constant__ uint32_t kScoreOne = 1;
__constant__ uint32_t kScoreColumn = 32;  // ints between a lane's bins

// 16 bytes of a row from position g on; bytes outside [0, s) read as 0.  With
// `vec` (S and the base 16-byte aligned) g is a multiple of 16 and a vector
// in the row is one load.
__device__ __forceinline__ uint4 score_load(const uint8_t* src, long long g,
                                            long long s, bool vec) {
  if (vec && g >= 0 && g < s) return *reinterpret_cast<const uint4*>(src + g);
  uint32_t w[4] = {0, 0, 0, 0};
  for (int k = 0; k < 16; ++k) {
    const long long i = g + k;
    if (i >= 0 && i < s) w[k >> 2] |= (uint32_t)src[i] << (8 * (k & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Edge vectors (a row's first 512 bytes, its last partial vector): bit i
// set where byte i of the vector counts for lag L.  `pos` is the vector's
// position in the row (capped: only pos < 512 matters), `len` its bytes
// inside the row.
__device__ __forceinline__ uint32_t score_valid(int pos, int len, int lag) {
  const int lo = lag - pos < 0 ? 0 : (lag - pos > 16 ? 16 : lag - pos);
  return (0xffffu << lo) & ((1u << len) - 1u) & 0xffffu;
}

// 0xff in byte k of word j where bit 4j + k of `valid` is set
__device__ __forceinline__ uint32_t score_lanes(uint32_t valid, int j) {
  return (((valid >> (4 * j)) & 0xfu) * 0x00204081u & 0x01010101u) * 0xffu;
}

// d = LUT(a, b, c) bit by bit: LOP3, one ALU instruction.  Written out so
// that ptxas keeps each of the two below one instruction, rather than
// sharing a ^ b between them at the cost of a third.
template <uint32_t kLut>
__device__ __forceinline__ uint32_t score_lop3(uint32_t a, uint32_t b,
                                               uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c), "n"(kLut));
  return d;
#else
  uint32_t d = 0;
  for (int i = 0; i < 32; ++i) {
    const int k = (((a >> i) & 1) << 2) | (((b >> i) & 1) << 1) | ((c >> i) & 1);
    d |= ((kLut >> k) & 1u) << i;
  }
  return d;
#endif
}
#define SCORE_LUT_XOR_AND 0x28u  // (a ^ b) & c
#define SCORE_LUT_NOR_XOR 0x09u  // ~(a | (b ^ c))

// 256 into acc for each byte that a and b share (within mask)
template <bool kEdge>
__device__ __forceinline__ void score_count(uint32_t a, uint32_t b,
                                            uint32_t mask, uint32_t& acc) {
  // bit 7 of y: the byte's low 7 bits differ (no carry leaves a byte);
  // with the top bits' own difference, ~(y | (a ^ b)) has bit 7 set in
  // exactly the equal bytes, and junk below it
  const uint32_t y =
      score_lop3<SCORE_LUT_XOR_AND>(a, b, 0x7f7f7f7fu) * kScoreOne +
      0x7f7f7f7fu;
  uint32_t f = score_lop3<SCORE_LUT_NOR_XOR>(y, a, b);
  if (kEdge) f &= mask;
  // the bytes' sum as unsigned minus their sum as signed is 256 for each
  // byte with bit 7 set: two dot products on the FMA pipe, whatever the
  // junk, in place of a mask and a shift on the ALU
  acc = (uint32_t)__dp4a((int)f, -1, (int)__dp4a(f, 0x01010101u, acc));
}

// L <= 32: the word L bytes before own word j from the 12-word window
// (the vectors at -32 and -16, then the own one)
template <bool kEdge, int L>
__device__ __forceinline__ void score_near(const uint32_t (&win)[12], int pos,
                                           int len, uint32_t& acc) {
  constexpr int q = L / 4, r = L % 4;
  const uint32_t valid = kEdge ? score_valid(pos, len, L) : 0xffffu;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t b;
    if constexpr (r == 0)
      b = win[8 + j - q];
    else
      b = __funnelshift_r(win[7 + j - q], win[8 + j - q], 32 - 8 * r);
    score_count<kEdge>(win[8 + j], b, kEdge ? score_lanes(valid, j) : 0u,
                       acc);
  }
}

// L a multiple of 16: one 16-byte read of shared memory
template <bool kEdge, int L>
__device__ __forceinline__ void score_far(const uint8_t* at,
                                          const uint32_t (&win)[12], int pos,
                                          int len, uint32_t& acc) {
  const uint4 v = *reinterpret_cast<const uint4*>(at - L);
  const uint32_t b[4] = {v.x, v.y, v.z, v.w};
  const uint32_t valid = kEdge ? score_valid(pos, len, L) : 0xffffu;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    score_count<kEdge>(win[8 + j], b[j], kEdge ? score_lanes(valid, j) : 0u,
                       acc);
}

// One thread's 16 bytes (own, at `at` in its warp's buffer): histogram and
// the 18 lags.  kEdge: the row's first 512 bytes or its end, with per-byte
// masks.  The histogram's shared atomics are spread between the lags, so
// that they issue while the ALU works.
template <bool kEdge>
__device__ __forceinline__ void score_vector(const uint8_t* at, uint4 own,
                                             int pos, int len, int* col,
                                             uint32_t (&acc)[SCORE_NLAGS]) {
  const uint4 m = *reinterpret_cast<const uint4*>(at - 32);
  const uint4 p = *reinterpret_cast<const uint4*>(at - 16);
  const uint32_t win[12] = {m.x, m.y, m.z, m.w, p.x,   p.y,
                            p.z, p.w, own.x, own.y, own.z, own.w};
  auto hist = [&](int i) {
    if (!kEdge || i < len)
      atomicAdd(&col[((win[8 + (i >> 2)] >> (8 * (i & 3))) & 0xffu) *
                     kScoreColumn],
                1);
  };
  score_near<kEdge, 1>(win, pos, len, acc[0]);
  hist(0);
  score_near<kEdge, 2>(win, pos, len, acc[1]);
  hist(1);
  score_near<kEdge, 3>(win, pos, len, acc[2]);
  hist(2);
  score_near<kEdge, 4>(win, pos, len, acc[3]);
  hist(3);
  score_near<kEdge, 6>(win, pos, len, acc[4]);
  hist(4);
  score_near<kEdge, 8>(win, pos, len, acc[5]);
  hist(5);
  score_near<kEdge, 12>(win, pos, len, acc[6]);
  hist(6);
  score_near<kEdge, 16>(win, pos, len, acc[7]);
  hist(7);
  score_near<kEdge, 24>(win, pos, len, acc[8]);
  hist(8);
  score_near<kEdge, 32>(win, pos, len, acc[9]);
  hist(9);
  score_far<kEdge, 48>(at, win, pos, len, acc[10]);
  hist(10);
  score_far<kEdge, 64>(at, win, pos, len, acc[11]);
  hist(11);
  score_far<kEdge, 96>(at, win, pos, len, acc[12]);
  hist(12);
  score_far<kEdge, 128>(at, win, pos, len, acc[13]);
  hist(13);
  score_far<kEdge, 192>(at, win, pos, len, acc[14]);
  hist(14);
  score_far<kEdge, 256>(at, win, pos, len, acc[15]);
  hist(15);
  score_far<kEdge, 384>(at, win, pos, len, acc[16]);
  score_far<kEdge, 512>(at, win, pos, len, acc[17]);
}

// the lag counters into the warp's sums (all 32 lanes call)
__device__ __forceinline__ void score_flush(uint32_t (&acc)[SCORE_NLAGS],
                                            int* warp_lags, int lane) {
#pragma unroll
  for (int l = 0; l < SCORE_NLAGS; ++l) {
    int v = (int)(acc[l] >> 8);
    acc[l] = 0;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(SCORE_FULL, v, off);
    if (lane == 0) warp_lags[l] += v;
  }
}

// grid (rows, blocks per row); block c of a row takes tiles [c * per,
// (c + 1) * per).  Outputs: hist, entropy and match are the columns 0, 256
// and 257 of a (rows, SCORE_OUT_COLS) int32 buffer.  ws: SCORE_WORKSPACE
// ints, zero at launch and left zero (used only with several blocks a row).
__global__ void __launch_bounds__(SCORE_THREADS, SCORE_MIN_BLOCKS)
    score_kernel(const uint8_t* __restrict__ data, long long s, long long per,
                 int* hist_out, float* entropy_out, float* match_out,
                 int* __restrict__ ws) {
  __shared__ int colhist[256 * 32];  // bin v of lane l at v * 32 + l
  // per warp: its step (512 bytes) in one of two slots, behind a copy of
  // the slot-1 step, so the 512 bytes before either slot are the last step
  __shared__ __align__(16) uint8_t buf[SCORE_WARPS][3 * SCORE_STEP];
  __shared__ int lag_part[SCORE_WARPS][SCORE_NLAGS];
  __shared__ int hist[256];
  __shared__ float frac[SCORE_NLAGS];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  const int chunk = blockIdx.y, chunks = gridDim.y;
  const long long tiles = (s + SCORE_TILE - 1) / SCORE_TILE;
  const long long first = (long long)chunk * per;
  const long long end = first + per < tiles ? first + per : tiles;
  const uint8_t* src = data + row * s;
  const bool vec =
      s % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;

  for (int i = tid; i < 256 * 32 / 4; i += SCORE_THREADS)
    reinterpret_cast<uint4*>(colhist)[i] = make_uint4(0, 0, 0, 0);
  if (tid < SCORE_WARPS * SCORE_NLAGS) (&lag_part[0][0])[tid] = 0;
  uint32_t acc[SCORE_NLAGS];
#pragma unroll
  for (int l = 0; l < SCORE_NLAGS; ++l) acc[l] = 0;
  __syncthreads();  // the columns are zero

  // the block's bytes [lo, hi) in steps of 512, a contiguous run of steps
  // per warp: warps share nothing but the histogram columns, and a step
  // needs no barrier of the block
  const long long lo = first * SCORE_TILE;
  const long long hi = end * SCORE_TILE < s ? end * SCORE_TILE : s;
  const long long steps = (hi - lo + SCORE_STEP - 1) / SCORE_STEP;
  const long long per_warp = (steps + SCORE_WARPS - 1) / SCORE_WARPS;
  const long long from = warp * per_warp;
  const long long to = from + per_warp < steps ? from + per_warp : steps;
  uint8_t* wb = buf[warp];
  int slot = 0;
  uint8_t* at = wb + SCORE_STEP + SCORE_VEC * lane;  // own vector's place
  if (from < to) {
    // step i of the warp's n starts at start + 512 i.  Steps [inner, full)
    // lie in [512, s): every lane there takes the path without masks, and
    // its vector is one plain load when `vec`
    const long long start = lo + from * SCORE_STEP;
    const int n = (int)(to - from);
    const int inner =
        start >= SCORE_HALO
            ? 0
            : (int)((SCORE_HALO - start + SCORE_STEP - 1) / SCORE_STEP);
    const long long whole = (s - start) / SCORE_STEP;
    const int full = whole < n ? (int)whole : n;
    long long g = start + SCORE_VEC * lane;
    uint4 own = score_load(src, g, s, vec);
    *reinterpret_cast<uint4*>(wb + SCORE_VEC * lane) =
        score_load(src, g - SCORE_STEP, s, vec);
    *reinterpret_cast<uint4*>(at) = own;
    __syncwarp();
    for (int i = 0, since = 0;; ++i) {
      const bool more = i + 1 < n;
      uint4 next = make_uint4(0, 0, 0, 0);
      if (more)
        next = vec && i + 1 < full
                   ? *reinterpret_cast<const uint4*>(src + g + SCORE_STEP)
                   : score_load(src, g + SCORE_STEP, s, vec);
      if (i >= inner && i < full) {
        score_vector<false>(at, own, SCORE_HALO, SCORE_VEC, colhist + lane,
                            acc);
      } else if (g < s) {
        score_vector<true>(at, own, g < SCORE_HALO ? (int)g : SCORE_HALO,
                           s - g < SCORE_VEC ? (int)(s - g) : SCORE_VEC,
                           colhist + lane, acc);
      }
      if (++since == SCORE_FLUSH_STEPS) {
        score_flush(acc, lag_part[warp], lane);
        since = 0;
      }
      if (!more) break;
      __syncwarp();  // the warp's reads of this step and its halo are done
      slot ^= 1;
      at = wb + (1 + slot) * SCORE_STEP + SCORE_VEC * lane;
      *reinterpret_cast<uint4*>(at) = next;
      if (slot) *reinterpret_cast<uint4*>(wb + SCORE_VEC * lane) = next;
      own = next;
      g += SCORE_STEP;
      __syncwarp();
    }
  }
  score_flush(acc, lag_part[warp], lane);
  __syncthreads();  // every column and warp sum is in

  // this block's count of bin tid, over the 32 lane columns (skewed: a
  // warp's 32 reads hit 32 banks)
  int c = 0;
  for (int i = 0; i < 32; ++i) c += colhist[tid * 32 + ((i + tid) & 31)];
  int lags = 0;
  if (tid < SCORE_NLAGS)
    for (int w = 0; w < SCORE_WARPS; ++w) lags += lag_part[w][tid];

  if (chunks > 1) {
    // partials into this block's slot, then a ticket: the block with the
    // row's last one sums the slots and leaves them and the ticket zero
    int* slots = ws + SCORE_MAX_TARGET + row * chunks * SCORE_SLOT;
    int* mine = slots + chunk * SCORE_SLOT;
    mine[tid] = c;
    if (tid < SCORE_NLAGS) mine[256 + tid] = lags;
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(&ws[row], 1) == chunks - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    c = 0;
    lags = 0;
#pragma unroll 8
    for (int k = 0; k < chunks; ++k) c += __ldcg(&slots[k * SCORE_SLOT + tid]);
    if (tid < SCORE_NLAGS)
      for (int k = 0; k < chunks; ++k)
        lags += __ldcg(&slots[k * SCORE_SLOT + 256 + tid]);
    for (int k = 0; k < chunks; ++k) {
      slots[k * SCORE_SLOT + tid] = 0;
      if (tid < SCORE_NLAGS) slots[k * SCORE_SLOT + 256 + tid] = 0;
    }
    if (tid == 0) ws[row] = 0;
  }

  hist_out[row * SCORE_OUT_COLS + tid] = c;
  hist[tid] = c;
  if (tid < SCORE_NLAGS) {
    const int lag = kScoreLags[tid];
    frac[tid] = lag < s ? __fmul_rn((float)lags,
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
      entropy_out[row * SCORE_OUT_COLS] = sum;
      match_out[row * SCORE_OUT_COLS] = best;
    }
  }
}

// Blocks per row for a (b, s) batch on a card that holds `target` blocks at
// once (at most SCORE_MAX_TARGET): target / b, at least 1 and at most one a
// tile, so b x blocks <= target whenever a row has more than one; *per gets
// the tiles each block walks.  (More, shorter blocks lose to their fixed
// cost at the store's shapes: PERF.md.)
static inline int score_grid(long long b, long long s, int target,
                             long long* per) {
  const long long tiles = (s + SCORE_TILE - 1) / SCORE_TILE;
  long long chunks = target / b;
  if (chunks < 1) chunks = 1;
  if (chunks > tiles) chunks = tiles;
  *per = (tiles + chunks - 1) / chunks;
  return (int)((tiles + *per - 1) / *per);
}

extern "C" {

int score_scratch_ints(void) { return SCORE_WORKSPACE; }

// data: device pointer to b rows of s bytes; hist, entropy and match: the
// columns 0, 256 and 257 of a b x 258 int32 buffer (row-major); workspace:
// score_scratch_ints() int32, zero (the wrapper zeroes it once; every launch
// leaves it zero).  Returns a cudaError_t.
int score_blocks(const void* data, int device, long long b, long long s,
                 void* hist, void* entropy, void* match, void* workspace,
                 void* stream) {
  if (b < 1 || b > 0x7fffffffLL || s < 1 ||
      static_cast<int*>(entropy) != static_cast<int*>(hist) + 256 ||
      static_cast<int*>(match) != static_cast<int*>(hist) + 257)
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // blocks the card holds at once, per device, asked once
  static int targets[64];
  int target = device >= 0 && device < 64 ? targets[device] : 0;
  if (target == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, score_kernel, SCORE_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    target = sms * (per_sm > 0 ? per_sm : 1);
    if (target > SCORE_MAX_TARGET) target = SCORE_MAX_TARGET;
    if (device >= 0 && device < 64) targets[device] = target;
  }
  long long per = 0;
  const int chunks = score_grid(b, s, target, &per);
  score_kernel<<<dim3((unsigned)b, (unsigned)chunks), SCORE_THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), s, per, static_cast<int*>(hist),
      static_cast<float*>(entropy), static_cast<float*>(match),
      static_cast<int*>(workspace));
  return (int)cudaGetLastError();
}

}  // extern "C"
