// GF(2^8) matrix x stripe-batch product on Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of ceph_tpu/ops/gf_pallas.py:
//   gf_matmul_spec <- _spec_kernel / _spec_call: registered encode generators
//   gf_matmul_gen  <- _gen_kernel / _gen_call: runtime (decode) matrices
// Both compute out[b, j, :] = XOR_i M[j][i] * data[b, i, :] over GF(2^8) with
// polynomial 0x11d, on the byte layout (B, K, S) -> (B, R, S).  Both work on
// packed 32-bit words (four bytes each); xtime multiplies the four by x.
//
// What bounds them on the H100: each input byte is read once and each output
// byte written once, (K + R) * S bytes per stripe; RS 8+3 at B = 64 stripes of
// 8 x 512 KiB moves 352 MiB, 0.110 ms at 3.35 TB/s.  The arithmetic must stay
// under that: shifts and logic ops issue at 64 lanes per clock per SM, so at
// 1.75 GHz the card runs about 14.8 T of them per second.
//
// Both entries launch one kernel, gf_horner_kernel: a Horner schedule per
// output.  P[j][s], the XOR of the inputs whose coefficient in row j has bit
// s set, is all a row needs: row j = P[j][top], then acc = xtime(acc) ^
// P[j][s] for s = top - 1 .. 0 (multiplying by x is GF(2)-linear, so this
// equals the sum of the coefficient products bit for bit).  RS 8+3 needs 14
// xtime per column word (row 0, all ones, none; rows 1 and 2 seven each)
// against the 56 of a ladder of powers per input, and one XOR per set
// coefficient bit (83).  The design against what held the ladder kernels at
// 33-67 % of their bound:
//   - xtime per word: 7 * R * ceil(K / 8) instead of 7 * K.  This is more than
//     the ladder only when R > 8 within one group; then the ladder would be
//     cheaper, and no switch is kept for that case (decode matrices have R <=
//     m rows).
//   - loads in flight: a thread loads all inputs of a group (up to 8, each
//     two 16-byte vectors at V = 8) before any arithmetic, so 16 independent
//     loads are in flight per thread.  Groups run one after another, each
//     XORing its Horner result into the R accumulators held in registers.
//   - selection: the matrix is resolved on the host into one input mask per
//     (group, output, bit) and each (group, output)'s top bit, passed by value
//     as a __grid_constant__ parameter (no __constant__ symbol, racy across
//     streams, and no compile per matrix).  The kernel is templated on R and
//     V and unrolls the 8 inputs of a group with compile-time indices, so
//     every mask test is warp-uniform and indexes the parameter statically.
//   - indexing: the stripe comes from blockIdx.y (a loop when B > 65535), the
//     column from the block and thread; there is no division per vector.
// Loads and stores are 16 bytes per thread on neighbouring addresses (V = 8:
// two uint4 per input, a block's threads apart: 256, or 128 on rows of at
// most 4 KiB, see horner_grid).  When S % 16 != 0 the kernel walks single
// words (V = 1) with the same schedule.
// Compiled (cuobjdump -sass; tools/kernel_shapes.py gf --sass counts it),
// RS 8+3 at V = 8 executes about 217 instructions per column word, 159 of
// them on the ALU pipe: 86 XORs, 14 xtime of 5 (3 ALU, 2 IMAD), about 49
// of mask tests and uniform branches, and 12 of addresses, loads and
// stores; 112 registers, no spills.  At V = 4 the compiler turns the 4-XOR
// branch bodies into predicated XORs that issue whether selected or not,
// which doubles the time, so V = 8 it is.
//
// The two entries differ only in where the schedule comes from.
// gf_matmul_spec takes it from the caller: ops/gf_kernels.spec_schedule
// builds it once per registered generator (tens of microseconds in numpy).
// gf_matmul_gen takes the coefficients, as the TPU generic kernel takes its
// matrix as a runtime operand (one build for every erasure pattern), and
// derives the schedule in its host C entry on every launch (horner_schedule,
// r * k * 8 bit tests, under a microsecond).
// Compiled, the R = 1 function (V = 8) holds 1312 instructions, 504 of them
// XORs (63 bodies of 8 words) and 56 xtime shifts (7 steps of 8 words); R = 3
// holds 3296 (1536 XORs, 168 shifts); 91 and 112 registers, no spills.  A
// column word executes one XOR per set coefficient bit and one per (group,
// row), 5 instructions per xtime step, and at most the function's remaining
// ones over its 8 words (66 at R = 1, 115 at R = 3: mask tests, branches,
// addresses, loads, stores).  So the one-row decode of a lost data shard (an
// all-ones row, no xtime) takes at most 75 per column word and the three-row
// decode of shards 0, 4 and 9 (87 set bits, every top 7) at most 310, where
// the ladder spent 56 xtime steps (280 instructions) and 8 R masked XORs.
// On the cluster's 4 KiB rows the 128-thread blocks took (2048, 8, 4096) to
// 3 rows from 0.0698 to 0.0466 ms back to back, one row unchanged at 0.028
// (tools/kernel_shapes.py gf on an H100 80GB HBM3 at 700 W).

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#define GF_MAX_R 16
#define GF_MAX_K 64
#define GF_GROUP 8  // inputs held in registers at once
#define GF_MAX_G (GF_MAX_K / GF_GROUP)

struct HornerParams {
  uint8_t mask[GF_MAX_G][GF_MAX_R][8];  // bit i: input 8g + i is in P[j][s]
  int8_t top[GF_MAX_G][GF_MAX_R];       // highest s of a nonzero mask, or -1
};

// The Horner schedule of an r x k row-major matrix, exactly as
// ops/gf_kernels.spec_schedule builds it: bit i of mask[g][j][s] is bit s of
// M[j][8g + i], top[g][j] the highest s with a nonzero mask or -1.  About
// r * k * 8 bit tests, so gf_matmul_gen derives it on every launch.
inline void horner_schedule(const uint8_t* coef, int r, int k,
                            HornerParams* p) {
  memset(p, 0, sizeof(*p));
  for (int j = 0; j < r; ++j)
    for (int i = 0; i < k; ++i)
      for (int s = 0; s < 8; ++s)
        if (coef[j * k + i] >> s & 1u)
          p->mask[i / GF_GROUP][j][s] |= (uint8_t)(1u << (i % GF_GROUP));
  const int groups = (k + GF_GROUP - 1) / GF_GROUP;
  for (int g = 0; g < groups; ++g)
    for (int j = 0; j < r; ++j) {
      int top = -1;
      for (int s = 7; s >= 0 && top < 0; --s)
        if (p->mask[g][j][s]) top = s;
      p->top[g][j] = (int8_t)top;
    }
}

template <int V>
struct Vec {
  uint32_t w[V];
};

__device__ __forceinline__ uint32_t xtime(uint32_t v) {
  // multiply the four packed bytes by x: shift, drop the carries across
  // bytes, reduce each byte whose bit 7 was set by 0x1d
  const uint32_t hi = (v >> 7) & 0x01010101u;
  return ((v << 1) & 0xfefefefeu) ^ (hi * 0x1du);
}

// A thread's column vector: V words per input, read as two uint4 a block's
// T threads apart (V = 8) or as one word (V = 1).  `second` says whether the
// second uint4 lies inside the row.
constexpr int kThreads = 256;

template <int V, int T>
__device__ __forceinline__ Vec<V> load_cols(const uint8_t* p, bool second) {
  Vec<V> v;
  if constexpr (V == 1) {
    v.w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  } else {
#pragma unroll
    for (int u = 0; u < V / 4; ++u) {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (u == 0 || second)
        q = __ldg(reinterpret_cast<const uint4*>(p + u * T * 16));
      v.w[4 * u] = q.x;
      v.w[4 * u + 1] = q.y;
      v.w[4 * u + 2] = q.z;
      v.w[4 * u + 3] = q.w;
    }
  }
  return v;
}

template <int V, int T>
__device__ __forceinline__ void store_cols(uint8_t* p, const Vec<V>& v,
                                           bool second) {
  if constexpr (V == 1) {
    *reinterpret_cast<uint32_t*>(p) = v.w[0];
  } else {
#pragma unroll
    for (int u = 0; u < V / 4; ++u)
      if (u == 0 || second)
        *reinterpret_cast<uint4*>(p + u * T * 16) =
            make_uint4(v.w[4 * u], v.w[4 * u + 1], v.w[4 * u + 2],
                       v.w[4 * u + 3]);
  }
}

// n_col: column vectors per input row, each V words (V = 8: counted in uint4,
// two per thread).  Thread (blockIdx.x, threadIdx.x) of a block of T owns one
// column of every stripe blockIdx.y, blockIdx.y + gridDim.y, ...
template <int R, int V, int T>
__global__ void __launch_bounds__(T)
    gf_horner_kernel(const __grid_constant__ HornerParams p, int k,
                     const uint8_t* __restrict__ data,
                     uint8_t* __restrict__ out, long long n_col, long long b,
                     long long s_bytes) {
  constexpr int kBytes = V == 1 ? 4 : 16;    // bytes per access
  constexpr int kPerThread = V == 8 ? 2 : 1;  // accesses per input row
  const long long col = (long long)blockIdx.x * (T * kPerThread) + threadIdx.x;
  if (col >= n_col) return;
  const bool second = kPerThread == 2 && col + T < n_col;
  const int groups = (k + GF_GROUP - 1) / GF_GROUP;
  for (long long st = blockIdx.y; st < b; st += gridDim.y) {
    const uint8_t* src = data + st * k * s_bytes + col * kBytes;
    Vec<V> acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int q = 0; q < V; ++q) acc[j].w[q] = 0u;
    for (int g = 0; g < groups; ++g) {
      const int kg = min(GF_GROUP, k - g * GF_GROUP);
      const uint8_t* in = src + g * GF_GROUP * s_bytes;
      Vec<V> x[GF_GROUP];
#pragma unroll
      for (int i = 0; i < GF_GROUP; ++i) {
        if (i < kg) {
          x[i] = load_cols<V, T>(in + i * s_bytes, second);
        } else {
#pragma unroll
          for (int q = 0; q < V; ++q) x[i].w[q] = 0u;
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int top = p.top[g][j];
        Vec<V> h;
#pragma unroll
        for (int q = 0; q < V; ++q) h.w[q] = 0u;
#pragma unroll
        for (int s = 7; s >= 0; --s) {
          if (s > top) continue;
          if (s < top) {
#pragma unroll
            for (int q = 0; q < V; ++q) h.w[q] = xtime(h.w[q]);
          }
          const unsigned m = p.mask[g][j][s];
#pragma unroll
          for (int i = 0; i < GF_GROUP; ++i) {
            if (m & (1u << i)) {
#pragma unroll
              for (int q = 0; q < V; ++q) h.w[q] ^= x[i].w[q];
            }
          }
        }
#pragma unroll
        for (int q = 0; q < V; ++q) acc[j].w[q] ^= h.w[q];
      }
    }
    uint8_t* dst = out + st * R * s_bytes + col * kBytes;
#pragma unroll
    for (int j = 0; j < R; ++j)
      store_cols<V, T>(dst + j * s_bytes, acc[j], second);
  }
}

// The launch's grid for b stripes of s bytes: V = 8 (wide) when s % 16 == 0,
// x over the row's column vectors, y over the stripes (at most 65535, the
// kernel loops over the rest).  A row of at most 256 uint4 (4 KiB, the
// cluster's stripe unit) would leave the second uint4 of every thread of a
// 256-thread block idle, and the thread would still compute on its zeros:
// such rows take blocks of 128 threads, each with two uint4 per input.
struct HornerGrid {
  bool wide;
  int threads;
  long long n_col;
  unsigned x, y;
};

inline HornerGrid horner_grid(long long b, long long s) {
  HornerGrid g;
  g.wide = s % 16 == 0;
  g.n_col = g.wide ? s / 16 : s / 4;
  g.threads = g.wide && g.n_col <= kThreads ? kThreads / 2 : kThreads;
  const long long per_block = g.wide ? 2 * g.threads : g.threads;
  g.x = (unsigned)((g.n_col + per_block - 1) / per_block);
  g.y = (unsigned)(b < 65535 ? b : 65535);
  return g;
}

namespace {  // host launchers, nvcc only: tools/gf_emulate.py stops here

// Instantiate one kernel per (R, V, T): R in 1..GF_MAX_R, (V, T) in
// {(1, 256), (8, 256), (8, 128)}.
#define GF_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

int launch_horner(const HornerParams& p, int r, int k, const uint8_t* data,
                  uint8_t* out, long long b, long long s,
                  cudaStream_t stream) {
  const HornerGrid g = horner_grid(b, s);
  const dim3 grid(g.x, g.y);
#define GF_HORNER_CASE(RR)                                                 \
  case RR:                                                                 \
    if (!g.wide)                                                           \
      gf_horner_kernel<RR, 1, kThreads><<<grid, kThreads, 0, stream>>>(    \
          p, k, data, out, g.n_col, b, s);                                 \
    else if (g.threads == kThreads)                                        \
      gf_horner_kernel<RR, 8, kThreads><<<grid, kThreads, 0, stream>>>(    \
          p, k, data, out, g.n_col, b, s);                                 \
    else                                                                   \
      gf_horner_kernel<RR, 8, kThreads / 2>                                \
          <<<grid, kThreads / 2, 0, stream>>>(p, k, data, out, g.n_col, b, \
                                              s);                          \
    break;
  switch (r) {
    GF_CASES(GF_HORNER_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GF_HORNER_CASE
  return (int)cudaGetLastError();
}

bool bad_shape(int r, int k, long long b, long long s) {
  return r < 1 || r > GF_MAX_R || k < 1 || k > GF_MAX_K || b < 1 || s < 4 ||
         s % 4 != 0;
}

}  // namespace

extern "C" {

// masks: host array of ceil(k / 8) * r * 8 uint8 (group, row, bit) and tops
// of ceil(k / 8) * r int8 (group, row), as ops/gf_kernels.spec_schedule
// builds them; data (b, k, s) and out (b, r, s) are device pointers, 16-byte
// aligned.  Returns a cudaError_t.
int gf_matmul_spec(const uint8_t* masks, const int8_t* tops, int r, int k,
                   int device, const void* data, void* out, long long b,
                   long long s, void* stream) {
  if (bad_shape(r, k, b, s)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  HornerParams p;
  memset(&p, 0, sizeof(p));
  const int groups = (k + GF_GROUP - 1) / GF_GROUP;
  for (int g = 0; g < groups; ++g)
    for (int j = 0; j < r; ++j) {
      p.top[g][j] = tops[g * r + j];
      for (int st = 0; st < 8; ++st)
        p.mask[g][j][st] = masks[(g * r + j) * 8 + st];
    }
  return launch_horner(p, r, k, static_cast<const uint8_t*>(data),
                       static_cast<uint8_t*>(out), b, s,
                       static_cast<cudaStream_t>(stream));
}

// coef: host array of r * k uint8 (row-major matrix), whose schedule is
// derived here on every launch.  Otherwise as above.
int gf_matmul_gen(const uint8_t* coef, int r, int k, int device,
                  const void* data, void* out, long long b, long long s,
                  void* stream) {
  if (bad_shape(r, k, b, s)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  HornerParams p;
  horner_schedule(coef, r, k, &p);
  return launch_horner(p, r, k, static_cast<const uint8_t*>(data),
                       static_cast<uint8_t*>(out), b, s,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
