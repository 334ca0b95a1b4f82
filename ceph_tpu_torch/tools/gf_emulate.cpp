// Host emulation of the GF(2^8) kernel (csrc/gf_matmul.cu) for the CPU tests;
// built by gf_emulate.py with g++, never part of the port's CUDA build.
//
// gf_device.inc is csrc/gf_matmul.cu up to its host launchers: the schedule
// derivation of the gf_matmul_gen entry (horner_schedule), the launch's grid
// (horner_grid) and gf_horner_kernel itself.  The CUDA builtins they use are
// defined below.  The kernel uses no warp collective and no shared memory, so
// the grid runs serially, block by block and thread by thread, with the grid
// and the parameter a launch would get.
//
//   gf_emulate INPUT OUTPUT
//
// INPUT holds an int64 job count, then per job four int64 (r, k, b, s), the
// r x k row-major matrix (uint8) and the (b, k, s) data (uint8).  OUTPUT gets
// per job the derived masks (ceil(k / 8), r, 8) uint8, the tops (ceil(k / 8),
// r) int8 and the (b, r, s) product, each in that order.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#define __device__
#define __forceinline__ inline
#define __global__
#define __grid_constant__
#define __launch_bounds__(x)

struct uint4 {
  uint32_t x, y, z, w;
};
static inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z,
                               uint32_t w) {
  return uint4{x, y, z, w};
}
template <class T>
static inline T __ldg(const T* p) {
  return *p;
}
static inline int min(int a, int b) { return a < b ? a : b; }

struct Dim3 {
  unsigned x, y, z;
};
static Dim3 threadIdx, blockIdx, gridDim;

#include "gf_device.inc"

template <int R, int V, int T>
static void run_grid(const HornerParams& p, int k, const uint8_t* data,
                     uint8_t* out, const HornerGrid& g, long long b,
                     long long s) {
  gridDim = Dim3{g.x, g.y, 1};
  for (unsigned by = 0; by < g.y; ++by)
    for (unsigned bx = 0; bx < g.x; ++bx)
      for (unsigned t = 0; t < (unsigned)T; ++t) {
        blockIdx = Dim3{bx, by, 0};
        threadIdx = Dim3{t, 0, 0};
        gf_horner_kernel<R, V, T>(p, k, data, out, g.n_col, b, s);
      }
}

static bool launch(const HornerParams& p, int r, int k, const uint8_t* data,
                   uint8_t* out, long long b, long long s) {
  const HornerGrid g = horner_grid(b, s);
#define GF_EMU_CASE(RR)                                             \
  case RR:                                                          \
    if (!g.wide)                                                    \
      run_grid<RR, 1, kThreads>(p, k, data, out, g, b, s);          \
    else if (g.threads == kThreads)                                 \
      run_grid<RR, 8, kThreads>(p, k, data, out, g, b, s);          \
    else                                                            \
      run_grid<RR, 8, kThreads / 2>(p, k, data, out, g, b, s);      \
    return true;
  switch (r) {
    GF_EMU_CASE(1) GF_EMU_CASE(2) GF_EMU_CASE(3) GF_EMU_CASE(4)
    GF_EMU_CASE(5) GF_EMU_CASE(6) GF_EMU_CASE(7) GF_EMU_CASE(8)
    GF_EMU_CASE(9) GF_EMU_CASE(10) GF_EMU_CASE(11) GF_EMU_CASE(12)
    GF_EMU_CASE(13) GF_EMU_CASE(14) GF_EMU_CASE(15) GF_EMU_CASE(16)
    default:
      return false;
  }
#undef GF_EMU_CASE
}

template <class T>
static std::vector<T> take(FILE* f, long long n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != (size_t)n) {
    fprintf(stderr, "short input\n");
    exit(2);
  }
  return v;
}

template <class T>
static void put(FILE* f, const T* p, long long n) {
  if (n && fwrite(p, sizeof(T), n, f) != (size_t)n) {
    fprintf(stderr, "short write\n");
    exit(2);
  }
}

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: gf_emulate INPUT OUTPUT\n");
    return 2;
  }
  FILE* f = fopen(argv[1], "rb");
  FILE* o = fopen(argv[2], "wb");
  if (!f || !o) return 2;
  const long long jobs = take<long long>(f, 1)[0];
  for (long long n = 0; n < jobs; ++n) {
    const std::vector<long long> h = take<long long>(f, 4);
    const int r = (int)h[0], k = (int)h[1];
    const long long b = h[2], s = h[3];
    if (r < 1 || r > GF_MAX_R || k < 1 || k > GF_MAX_K || b < 1 || s < 4 ||
        s % 4) {
      fprintf(stderr, "job %lld: shape (%d, %d, %lld, %lld) out of range\n",
              n, r, k, b, s);
      return 2;
    }
    const auto coef = take<uint8_t>(f, (long long)r * k);
    const auto data = take<uint8_t>(f, b * k * s);
    HornerParams p;
    horner_schedule(coef.data(), r, k, &p);
    std::vector<uint8_t> out((size_t)(b * r * s), 0);
    if (!launch(p, r, k, data.data(), out.data(), b, s)) return 2;
    const int groups = (k + GF_GROUP - 1) / GF_GROUP;
    for (int g = 0; g < groups; ++g)
      for (int j = 0; j < r; ++j) put(o, p.mask[g][j], 8);
    for (int g = 0; g < groups; ++g) put(o, p.top[g], r);
    put(o, out.data(), (long long)out.size());
  }
  fclose(f);
  return fclose(o) == 0 ? 0 : 2;
}
