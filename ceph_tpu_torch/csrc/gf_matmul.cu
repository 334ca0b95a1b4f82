// GF(2^8) matrix x stripe-batch product on Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of ceph_tpu/ops/gf_pallas.py:
//   gf_matmul_spec <- _spec_kernel / _spec_call: registered encode generators
//   gf_matmul_gen  <- _gen_kernel / _gen_call: runtime (decode) matrices
// Both compute out[b, j, :] = XOR_i M[j][i] * data[b, i, :] over GF(2^8) with
// polynomial 0x11d, on the byte layout (B, K, S) -> (B, R, S).
//
// What bounds it on the H100: each input byte is read once and each output
// byte written once, (K + R) * S bytes per stripe; RS 8+3 at B = 64 stripes of
// 8 x 512 KiB moves 352 MiB, 0.11 ms at 3.35 TB/s.  The arithmetic is seven
// xtime steps per input word (about 5 integer instructions each) plus one XOR
// per set coefficient bit (spec) or one AND-XOR (a LOP3) per output row and
// bit (gen): some 40 instructions per 4 input bytes, 0.09 ms for that batch
// at the card's 33.5 T lane-instructions per second.  So the kernel needs
// both HBM and integer issue near their peaks at once.
//
// What the design does about it: one thread owns one 16-byte column vector
// (uint4, four packed words) of one stripe and walks all K inputs, so every
// load and store is 16 bytes per thread on consecutive addresses, and the
// product never touches memory except as input and output.  The R
// accumulators live in registers (R is a template parameter, the inner loops
// unroll).  The ladder runs on uint32, so the >> 7 is a logical shift.  The
// matrix travels by value as a __grid_constant__ kernel parameter: no
// __constant__ symbol (module-global, racy across streams) and no compile per
// matrix.
//   spec: the host resolves M into the XOR selection sel[i][s], whose bit j is
//         bit s of M[j][i]; the kernel XORs ladder power s of input i into
//         the selected accumulators only (branches uniform across the grid).
//   gen:  the kernel reads M[j][i] and ANDs each power with -(M >> s & 1),
//         the mask form of the TPU generic kernel: one build for every matrix.
// S only needs to be a multiple of 4: when S % 16 != 0 the kernel walks
// single words (V = 1) instead of uint4 vectors.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

#define GF_MAX_R 16
#define GF_MAX_K 64

struct SpecParams {
  uint16_t sel[GF_MAX_K][8];  // bit j: XOR power s of input i into output j
};

struct GenParams {
  uint8_t coef[GF_MAX_R][GF_MAX_K];
};

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

template <int V>
__device__ __forceinline__ Vec<V> load_vec(const uint8_t* p);

template <>
__device__ __forceinline__ Vec<4> load_vec<4>(const uint8_t* p) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  return Vec<4>{{u.x, u.y, u.z, u.w}};
}

template <>
__device__ __forceinline__ Vec<1> load_vec<1>(const uint8_t* p) {
  return Vec<1>{{__ldg(reinterpret_cast<const uint32_t*>(p))}};
}

template <int V>
__device__ __forceinline__ void store_vec(uint8_t* p, const Vec<V>& v);

template <>
__device__ __forceinline__ void store_vec<4>(uint8_t* p, const Vec<4>& v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
}

template <>
__device__ __forceinline__ void store_vec<1>(uint8_t* p, const Vec<1>& v) {
  *reinterpret_cast<uint32_t*>(p) = v.w[0];
}

template <int R, int V>
__global__ void __launch_bounds__(256)
    gf_spec_kernel(const __grid_constant__ SpecParams p, int k,
                   const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                   long long n_vec, long long total, long long s_bytes) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step) {
    const long long b = t / n_vec;
    const long long off = (t - b * n_vec) * (4 * V);
    const uint8_t* src = data + b * k * s_bytes + off;
    Vec<V> acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int q = 0; q < V; ++q) acc[j].w[q] = 0u;
    for (int i = 0; i < k; ++i) {
      Vec<V> x = load_vec<V>(src + i * s_bytes);
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const unsigned sel = p.sel[i][s];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (sel & (1u << j)) {
#pragma unroll
            for (int q = 0; q < V; ++q) acc[j].w[q] ^= x.w[q];
          }
        }
        if (s != 7) {
#pragma unroll
          for (int q = 0; q < V; ++q) x.w[q] = xtime(x.w[q]);
        }
      }
    }
    uint8_t* dst = out + b * R * s_bytes + off;
#pragma unroll
    for (int j = 0; j < R; ++j) store_vec<V>(dst + j * s_bytes, acc[j]);
  }
}

template <int R, int V>
__global__ void __launch_bounds__(256)
    gf_gen_kernel(const __grid_constant__ GenParams p, int k,
                  const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                  long long n_vec, long long total, long long s_bytes) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step) {
    const long long b = t / n_vec;
    const long long off = (t - b * n_vec) * (4 * V);
    const uint8_t* src = data + b * k * s_bytes + off;
    Vec<V> acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int q = 0; q < V; ++q) acc[j].w[q] = 0u;
    for (int i = 0; i < k; ++i) {
      Vec<V> x = load_vec<V>(src + i * s_bytes);
      uint32_t c[R];
#pragma unroll
      for (int j = 0; j < R; ++j) c[j] = p.coef[j][i];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const uint32_t mask = 0u - ((c[j] >> s) & 1u);
#pragma unroll
          for (int q = 0; q < V; ++q) acc[j].w[q] ^= x.w[q] & mask;
        }
        if (s != 7) {
#pragma unroll
          for (int q = 0; q < V; ++q) x.w[q] = xtime(x.w[q]);
        }
      }
    }
    uint8_t* dst = out + b * R * s_bytes + off;
#pragma unroll
    for (int j = 0; j < R; ++j) store_vec<V>(dst + j * s_bytes, acc[j]);
  }
}

namespace {

constexpr int kThreads = 256;

// Grid size for `total` vectors: one thread each, capped so the grid-stride
// loop covers the rest.
unsigned grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

// Instantiate one kernel per (R, V): R in 1..GF_MAX_R, V in {1, 4}.
#define GF_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

int launch_spec(const SpecParams& p, int r, int k, const uint8_t* data,
                uint8_t* out, long long b, long long s, cudaStream_t stream) {
  const int v = (s % 16 == 0) ? 4 : 1;
  const long long n_vec = s / (4 * v);
  const long long total = b * n_vec;
  const unsigned grid = grid_for(total);
#define GF_SPEC_CASE(RR)                                                    \
  case RR:                                                                  \
    if (v == 4)                                                             \
      gf_spec_kernel<RR, 4><<<grid, kThreads, 0, stream>>>(p, k, data, out, \
                                                           n_vec, total, s); \
    else                                                                    \
      gf_spec_kernel<RR, 1><<<grid, kThreads, 0, stream>>>(p, k, data, out, \
                                                           n_vec, total, s); \
    break;
  switch (r) {
    GF_CASES(GF_SPEC_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GF_SPEC_CASE
  return (int)cudaGetLastError();
}

int launch_gen(const GenParams& p, int r, int k, const uint8_t* data,
               uint8_t* out, long long b, long long s, cudaStream_t stream) {
  const int v = (s % 16 == 0) ? 4 : 1;
  const long long n_vec = s / (4 * v);
  const long long total = b * n_vec;
  const unsigned grid = grid_for(total);
#define GF_GEN_CASE(RR)                                                    \
  case RR:                                                                 \
    if (v == 4)                                                            \
      gf_gen_kernel<RR, 4><<<grid, kThreads, 0, stream>>>(p, k, data, out, \
                                                          n_vec, total, s); \
    else                                                                   \
      gf_gen_kernel<RR, 1><<<grid, kThreads, 0, stream>>>(p, k, data, out, \
                                                          n_vec, total, s); \
    break;
  switch (r) {
    GF_CASES(GF_GEN_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GF_GEN_CASE
  return (int)cudaGetLastError();
}

bool bad_shape(int r, int k, long long b, long long s) {
  return r < 1 || r > GF_MAX_R || k < 1 || k > GF_MAX_K || b < 1 || s < 4 ||
         s % 4 != 0;
}

}  // namespace

extern "C" {

// sel: host array of k * 8 uint16 (row i, ladder step s); data (b, k, s) and
// out (b, r, s) are device pointers, 16-byte aligned.  Returns a cudaError_t.
int gf_matmul_spec(const uint16_t* sel, int r, int k, int device,
                   const void* data, void* out, long long b, long long s,
                   void* stream) {
  if (bad_shape(r, k, b, s)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  SpecParams p;
  memset(&p, 0, sizeof(p));
  for (int i = 0; i < k; ++i)
    for (int st = 0; st < 8; ++st) p.sel[i][st] = sel[i * 8 + st];
  return launch_spec(p, r, k, static_cast<const uint8_t*>(data),
                     static_cast<uint8_t*>(out), b, s,
                     static_cast<cudaStream_t>(stream));
}

// coef: host array of r * k uint8 (row-major matrix).  Otherwise as above.
int gf_matmul_gen(const uint8_t* coef, int r, int k, int device,
                  const void* data, void* out, long long b, long long s,
                  void* stream) {
  if (bad_shape(r, k, b, s)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  GenParams p;
  memset(&p, 0, sizeof(p));
  for (int j = 0; j < r; ++j)
    for (int i = 0; i < k; ++i) p.coef[j][i] = coef[j * k + i];
  return launch_gen(p, r, k, static_cast<const uint8_t*>(data),
                    static_cast<uint8_t*>(out), b, s,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
