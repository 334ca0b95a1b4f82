// Host emulation of score_kernel (csrc/compress_score.cu) for the CPU tests;
// built by score_emulate.py with g++, never part of the port's CUDA build.
//
// score_device.inc is csrc/compress_score.cu up to its extern "C" launcher.
// The CUDA builtins it uses are defined below: a thread block is 256
// fibers (ucontext) on one OS thread, switched round robin whenever one
// waits; __syncthreads is a barrier of all of them, __syncwarp and a warp
// shuffle meet at a barrier of the warp's 32 lanes, and shared memory is the kernel's
// function-static arrays.  The grid the launcher would use (rows x
// score_grid(b, s, target)) runs one block at a time, the blocks of a row in
// reverse order (so the row is finished by whichever block takes the last
// ticket, not by block C - 1).  Every job runs on one workspace, zeroed once
// before the first, as the wrapper keeps it on the card.  Fibers keep the
// emulation cheap on a loaded machine: no OS thread sleeps or wakes at a
// barrier.
//
//   score_emulate INPUT OUTPUT
//
// INPUT holds an int64 job count, then per job three int64 (b, s, target:
// the blocks the emulated card holds at once) and the (b, s) uint8 rows.
// OUTPUT gets per job the (b, 258) int32 output rows (histogram, entropy
// and match fraction, the floats as their bits), then three int64: the
// blocks per row, the tiles per block and the number of workspace ints
// that are not zero after the job.

#include <setjmp.h>
#include <ucontext.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(...)
#define __shared__ static
#define __constant__ static const
#define __align__(n) __attribute__((aligned(n)))

struct uint4 {
  uint32_t x, y, z, w;
};
static inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z,
                               uint32_t w) {
  return uint4{x, y, z, w};
}
struct Dim {
  unsigned x, y;
};
constexpr int kThreads = 256;
static Dim g_thread[kThreads], blockIdx, gridDim;
static int g_cur;  // the fiber running now
#define threadIdx (g_thread[g_cur])

// a fiber is entered once through makecontext/swapcontext and switched
// with _setjmp/_longjmp from then on (swapcontext saves the signal mask, a
// system call per switch)
static ucontext_t g_sched, g_fiber[kThreads];
static jmp_buf g_sched_jb, g_fiber_jb[kThreads];
static bool g_started[kThreads];

struct Barrier {
  int n, arrived;
  unsigned gen;
};
// what each fiber waits for: the scheduler skips it until that barrier's
// generation moves on
static Barrier* g_wait_bar[kThreads];
static unsigned g_wait_gen[kThreads];

static void barrier_wait(Barrier& b) {
  const unsigned gen = b.gen;
  if (++b.arrived == b.n) {
    b.arrived = 0;
    ++b.gen;
    return;
  }
  g_wait_bar[g_cur] = &b;
  g_wait_gen[g_cur] = gen;
  if (!_setjmp(g_fiber_jb[g_cur])) _longjmp(g_sched_jb, 1);
  g_wait_bar[g_cur] = nullptr;
}
static Barrier g_block = {kThreads, 0, 0};
static Barrier g_warp[kThreads / 32];

static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
// one OS thread: a fiber switch happens only at a barrier, so these need
// no atomics
static inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}
static inline void __threadfence() {}
static inline int __ldcg(const int* p) { return *p; }
static inline uint32_t __dp4a(uint32_t a, uint32_t b, uint32_t c) {
  for (int k = 0; k < 32; k += 8) c += ((a >> k) & 0xffu) * ((b >> k) & 0xffu);
  return c;
}
static inline int __dp4a(int a, int b, int c) {
  uint32_t sum = (uint32_t)c;  // wraps as the card's 32-bit sum does
  for (int k = 0; k < 32; k += 8)
    sum += (uint32_t)((int)(int8_t)(a >> k) * (int)(int8_t)(b >> k));
  return (int)sum;
}
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi,
                                       unsigned shift) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (shift & 31));
}

static unsigned long long g_slots[kThreads];

static void __syncthreads() { barrier_wait(g_block); }
static void __syncwarp() { barrier_wait(g_warp[threadIdx.x >> 5]); }

template <class T>
static T __shfl_xor_sync(unsigned mask, T v, int off) {
  if (mask != 0xffffffffu) {
    fprintf(stderr, "a shuffle on mask %08x\n", mask);
    abort();
  }
  const int tid = (int)threadIdx.x, warp = tid >> 5;
  unsigned long long word = 0;
  memcpy(&word, &v, sizeof v);
  g_slots[tid] = word;
  barrier_wait(g_warp[warp]);
  word = g_slots[(warp << 5) | ((tid & 31) ^ off)];
  barrier_wait(g_warp[warp]);
  memcpy(&v, &word, sizeof v);
  return v;
}

#include "score_device.inc"

// the launch a fiber runs, and whether it has returned
static struct {
  const uint8_t* data;
  long long s, per;
  int *out, *ws;
} g_args;
static bool g_done[kThreads];

static void fiber_main() {
  score_kernel(g_args.data, g_args.s, g_args.per, g_args.out,
               reinterpret_cast<float*>(g_args.out + 256),
               reinterpret_cast<float*>(g_args.out + 257), g_args.ws);
  g_done[g_cur] = true;
  _longjmp(g_sched_jb, 1);  // never returns through uc_link
}

// every thread of one block, round robin until all have returned
static void run_block(Dim block, std::vector<char>& stacks) {
  blockIdx = block;
  const size_t stack = stacks.size() / kThreads;
  for (int t = 0; t < kThreads; ++t) {
    g_thread[t] = Dim{(unsigned)t, 0};
    g_done[t] = false;
    g_started[t] = false;
    g_wait_bar[t] = nullptr;
    getcontext(&g_fiber[t]);
    g_fiber[t].uc_stack.ss_sp = stacks.data() + t * stack;
    g_fiber[t].uc_stack.ss_size = stack;
    g_fiber[t].uc_link = nullptr;
    makecontext(&g_fiber[t], fiber_main, 0);
  }
  for (int left = kThreads; left > 0;) {
    left = 0;
    for (int t = 0; t < kThreads; ++t) {
      if (g_done[t]) continue;
      if (g_wait_bar[t] && g_wait_bar[t]->gen == g_wait_gen[t]) {
        ++left;  // still waiting: no switch
        continue;
      }
      g_cur = t;
      if (!_setjmp(g_sched_jb)) {
        if (g_started[t]) _longjmp(g_fiber_jb[t], 1);
        g_started[t] = true;
        swapcontext(&g_sched, &g_fiber[t]);
      }
      left += !g_done[t];
    }
  }
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
    fprintf(stderr, "usage: score_emulate INPUT OUTPUT\n");
    return 2;
  }
  FILE* f = fopen(argv[1], "rb");
  FILE* o = fopen(argv[2], "wb");
  if (!f || !o) return 2;
  for (auto& w : g_warp) w = Barrier{32, 0, 0};
  std::vector<char> stacks((size_t)kThreads * (64 << 10));
  std::vector<int> ws(SCORE_WORKSPACE, 0);  // zeroed once, for every job
  const long long jobs = take<long long>(f, 1)[0];
  for (long long n = 0; n < jobs; ++n) {
    const std::vector<long long> h = take<long long>(f, 3);
    const long long b = h[0], s = h[1], target = h[2];
    if (b < 1 || s < 1 || target < 1 || target > SCORE_MAX_TARGET) {
      fprintf(stderr, "job %lld: (%lld, %lld) on %lld blocks out of range\n",
              n, b, s, target);
      return 2;
    }
    // 16-byte aligned, as a tensor on the card is
    const size_t bytes = ((size_t)(b * s) + 15) / 16 * 16;
    std::unique_ptr<uint8_t, decltype(&free)> data(
        static_cast<uint8_t*>(aligned_alloc(16, bytes)), &free);
    const std::vector<uint8_t> rows = take<uint8_t>(f, b * s);
    memcpy(data.get(), rows.data(), (size_t)(b * s));
    std::vector<int> out((size_t)b * SCORE_OUT_COLS, 0);
    long long per = 0;
    const int chunks = score_grid(b, s, (int)target, &per);
    gridDim = Dim{(unsigned)b, (unsigned)chunks};
    g_args = {data.get(), s, per, out.data(), ws.data()};
    for (long long row = 0; row < b; ++row)
      for (int chunk = chunks - 1; chunk >= 0; --chunk)
        run_block(Dim{(unsigned)row, (unsigned)chunk}, stacks);
    put(o, out.data(), b * SCORE_OUT_COLS);
    long long tail[3] = {chunks, per, 0};
    for (int v : ws) tail[2] += v != 0;
    put(o, tail, 3);
  }
  fclose(f);
  fclose(o);
  return 0;
}
