// Host emulation of crush_kernel (csrc/crush.cu) for the CPU tests; built by
// crush_emulate.py with g++, never part of the port's CUDA build.
//
// crush_device.inc is csrc/crush.cu up to its extern "C" launcher.  The CUDA
// builtins it uses are defined below: a warp is 32 std::threads, and every
// warp collective (ballot, any, shuffle) meets at a barrier of the lanes its
// mask names, so the kernel's own refill, regroup and reduction code runs.
//
//   crush_emulate INPUT OUTPUT
//
// INPUT holds a header of 18 int64 (nb, ms, n_weight, max_devices,
// max_depth, n, the 11 ChooseProgram fields, warps), then items (int32),
// recips (int64), sizes, types (int32), dev_weight (int64), the 514 ln table
// entries (int64) and xs (int32).  OUTPUT gets the (n, result_max) int32
// placements.

#include <atomic>
#include <barrier>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __forceinline__ inline
#define __global__
#define __grid_constant__
#define __launch_bounds__(x)
#define __shared__ static   // every warp writes the same table values

struct Dim {
  unsigned x;
};
thread_local Dim threadIdx, blockIdx;
static const Dim blockDim = {32};   // one block is one warp here

template <class T>
static inline T __ldg(const T* p) {
  return *p;
}
static inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
static inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline unsigned long long __umul64hi(unsigned long long a,
                                           unsigned long long b) {
  return (unsigned long long)(((unsigned __int128)a * b) >> 64);
}

// barriers for every aligned group of 1, 2, ..., 32 lanes of one warp
struct Warp {
  std::unique_ptr<std::barrier<>> bars[6][32];
  unsigned long long slots[32];
  Warp() {
    for (int l = 0; l < 6; ++l)
      for (int b = 0; b < 32; b += 1 << l)
        bars[l][b].reset(new std::barrier<>(1 << l));
  }
};
thread_local Warp* tl_warp;

static int lane_id() { return (int)(threadIdx.x & 31u); }

static std::barrier<>& group_barrier(unsigned mask) {
  const int size = __builtin_popcount(mask), base = __builtin_ctz(mask);
  const unsigned want =
      size == 32 ? 0xffffffffu : ((1u << size) - 1u) << base;
  if (mask != want || (size & (size - 1)) || lane_id() < base ||
      lane_id() >= base + size) {
    fprintf(stderr, "lane %d: a collective on mask %08x\n", lane_id(), mask);
    abort();
  }
  return *tl_warp->bars[__builtin_ctz(size)][base];
}

template <class T>
static T exchange(unsigned mask, T v, int src) {
  std::barrier<>& b = group_barrier(mask);
  unsigned long long word = 0;
  memcpy(&word, &v, sizeof v);
  tl_warp->slots[lane_id()] = word;
  b.arrive_and_wait();
  word = tl_warp->slots[src];
  b.arrive_and_wait();
  memcpy(&v, &word, sizeof v);
  return v;
}

template <class T>
static T __shfl_sync(unsigned mask, T v, int src) {
  return exchange(mask, v, src);
}
template <class T>
static T __shfl_xor_sync(unsigned mask, T v, int off) {
  return exchange(mask, v, lane_id() ^ off);
}
static unsigned __ballot_sync(unsigned mask, int pred) {
  std::barrier<>& b = group_barrier(mask);
  tl_warp->slots[lane_id()] = pred != 0;
  b.arrive_and_wait();
  unsigned bits = 0;
  for (int l = 0; l < 32; ++l)
    if ((mask >> l & 1u) && tl_warp->slots[l]) bits |= 1u << l;
  b.arrive_and_wait();
  return bits;
}
static int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0;
}
static void __syncthreads() { tl_warp->bars[5][0]->arrive_and_wait(); }
static unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}

#include "crush_device.inc"

template <class T>
static std::vector<T> take(FILE* f, long long n) {
  std::vector<T> v(n);
  if (fread(v.data(), sizeof(T), n, f) != (size_t)n) {
    fprintf(stderr, "short input\n");
    exit(2);
  }
  return v;
}

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: crush_emulate INPUT OUTPUT\n");
    return 2;
  }
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  const std::vector<long long> h = take<long long>(f, 18);
  const int nb = h[0], ms = h[1], nw = h[2], warps = h[17];
  const long long n = h[5];
  const auto items = take<int>(f, (long long)nb * ms);
  const auto recips = take<unsigned long long>(f, (long long)nb * ms);
  const auto sizes = take<int>(f, nb), types = take<int>(f, nb);
  const auto dev_weight = take<long long>(f, nw);
  const auto tabs = take<long long>(f, CRUSH_LN_ENTRIES);
  const auto xs = take<int>(f, n);
  fclose(f);

  CrushParams p;
  p.result_max = h[6];
  p.firstn = h[7];
  p.recurse = h[8];
  p.take = h[9];
  p.count = h[10];
  p.numrep = h[11];
  p.target_type = h[12];
  p.tries = h[13];
  p.leaf_tries = h[14];
  p.vary_r = h[15];
  p.stable = h[16];
  p.ln_tables = tabs.data();
  p.items = items.data();
  p.recips = recips.data();
  p.sizes = sizes.data();
  p.types = types.data();
  p.dev_weight = dev_weight.data();
  p.nb = nb;
  p.ms = ms;
  p.n_weight = nw;
  p.max_devices = h[3];
  p.max_depth = h[4];
  p.xs = xs.data();
  p.n = n;
  std::vector<int> out((size_t)n * p.result_max, 0);
  p.out = out.data();
  unsigned long long counter = 0;
  p.next = &counter;

  std::vector<std::unique_ptr<Warp>> ws;
  for (int w = 0; w < warps; ++w) ws.emplace_back(new Warp());
  std::vector<std::thread> lanes;
  for (int w = 0; w < warps; ++w)
    for (unsigned l = 0; l < 32; ++l)
      lanes.emplace_back([&, w, l] {
        tl_warp = ws[w].get();
        threadIdx.x = l;
        blockIdx.x = w;
        crush_kernel(p);
      });
  for (auto& t : lanes) t.join();
  FILE* g = fopen(argv[2], "wb");
  if (!g || fwrite(out.data(), 4, out.size(), g) != out.size()) return 2;
  fclose(g);
  return 0;
}
