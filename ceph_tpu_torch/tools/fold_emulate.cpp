// Host emulation of gf_fold_kernel (csrc/gf_fold.cu) for the CPU tests;
// built by fold_emulate.py with g++, never part of the port's CUDA build.
//
// fold_device.inc is csrc/gf_fold.cu up to its host launchers: the launch's
// grid (fold_grid) and the kernel itself.  The CUDA builtins they use are
// defined below: a thread block is 256 fibers (ucontext) on one OS thread,
// switched round robin whenever one waits; __syncthreads is a barrier of all
// of them, a warp shuffle meets at a barrier of the warp's 32 lanes, shared
// memory is the kernel's function-static array and an atomic is a plain
// read-modify-write (one OS thread).  The grid the launcher would choose for
// a card that holds `target` blocks at once runs one block at a time, in
// reverse order, on an output that starts zeroed, as the entry zeroes it.
//
//   fold_emulate INPUT OUTPUT
//
// INPUT holds an int64 job count, then per job five int64 (b, rows, lanes,
// target, weighted), the rows weight bytes when weighted and the
// (b, rows, lanes) uint8 data.  OUTPUT gets per job the (b, lanes) fold,
// then two int64: the chunks per item and the blocks of the grid.

#include <setjmp.h>
#include <ucontext.h>

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
#define __restrict__
#define __shared__ static

struct uint4 {
  uint32_t x, y, z, w;
};
struct Dim {
  unsigned x;
};
constexpr int kThreads = 256;
static Dim g_thread[kThreads], blockIdx, gridDim;
static int g_cur;  // the fiber running now
#define threadIdx (g_thread[g_cur])

template <class T>
static inline T __ldg(const T* p) {
  return *p;
}
// one OS thread: a fiber switch happens only at a barrier
static inline uint32_t atomicXor(uint32_t* p, uint32_t v) {
  const uint32_t old = *p;
  *p = old ^ v;
  return old;
}

// a fiber is entered once through makecontext/swapcontext and switched
// with _setjmp/_longjmp from then on
static ucontext_t g_sched, g_fiber[kThreads];
static jmp_buf g_sched_jb, g_fiber_jb[kThreads];
static bool g_started[kThreads], g_done[kThreads];

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
static uint32_t g_slots[kThreads];

static void __syncthreads() { barrier_wait(g_block); }

static uint32_t __shfl_xor_sync(unsigned mask, uint32_t v, int off) {
  if (mask != 0xffffffffu) {
    fprintf(stderr, "a shuffle on mask %08x\n", mask);
    abort();
  }
  const int tid = (int)threadIdx.x, warp = tid >> 5;
  g_slots[tid] = v;
  barrier_wait(g_warp[warp]);
  v = g_slots[(warp << 5) | ((tid & 31) ^ off)];
  barrier_wait(g_warp[warp]);
  return v;
}

#include "fold_device.inc"

// the launch a fiber runs
static struct {
  void (*kernel)(const uint8_t*, const uint8_t*, uint32_t*, long long,
                 long long, int, long long, long long);
  const uint8_t *data, *weights;
  uint32_t* out;
  long long b, rows, chunks, per;
  int lanes;
} g_args;

static void fiber_main() {
  g_args.kernel(g_args.data, g_args.weights, g_args.out, g_args.b,
                g_args.rows, g_args.lanes, g_args.chunks, g_args.per);
  g_done[g_cur] = true;
  _longjmp(g_sched_jb, 1);  // never returns through uc_link
}

// every thread of one block, round robin until all have returned
static void run_block(unsigned block, std::vector<char>& stacks) {
  blockIdx = Dim{block};
  const size_t stack = stacks.size() / kThreads;
  for (int t = 0; t < kThreads; ++t) {
    g_thread[t] = Dim{(unsigned)t};
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
    fprintf(stderr, "usage: fold_emulate INPUT OUTPUT\n");
    return 2;
  }
  FILE* f = fopen(argv[1], "rb");
  FILE* o = fopen(argv[2], "wb");
  if (!f || !o) return 2;
  for (auto& w : g_warp) w = Barrier{32, 0, 0};
  std::vector<char> stacks((size_t)kThreads * (64 << 10));
  const long long jobs = take<long long>(f, 1)[0];
  for (long long n = 0; n < jobs; ++n) {
    const std::vector<long long> h = take<long long>(f, 5);
    const long long b = h[0], rows = h[1], target = h[3];
    const int lanes = (int)h[2];
    const bool weighted = h[4] != 0;
    if (b < 1 || rows < 1 || lanes < 4 || lanes % 4 ||
        lanes > FOLD_MAX_LANES || target < 1 || target > FOLD_MAX_TARGET) {
      fprintf(stderr, "job %lld: (%lld, %lld, %d) on %lld blocks out of"
              " range\n", n, b, rows, lanes, target);
      return 2;
    }
    const std::vector<uint8_t> w =
        take<uint8_t>(f, weighted ? rows : 0);
    // 16-byte aligned, as a tensor on the card is
    const size_t bytes = (size_t)(b * rows * lanes);
    std::unique_ptr<uint8_t, decltype(&free)> data(
        static_cast<uint8_t*>(aligned_alloc(16, (bytes + 15) / 16 * 16)),
        &free);
    const std::vector<uint8_t> raw = take<uint8_t>(f, (long long)bytes);
    memcpy(data.get(), raw.data(), bytes);
    std::vector<uint32_t> out((size_t)(b * lanes / 4), 0);
    const int nw = lanes % 16 == 0 ? 4 : 1;
    const FoldGrid g = fold_grid(b, rows, lanes / (4 * nw), (int)target);
    g_args.kernel = nw == 4 ? (weighted ? gf_fold_kernel<4, true>
                                        : gf_fold_kernel<4, false>)
                            : (weighted ? gf_fold_kernel<1, true>
                                        : gf_fold_kernel<1, false>);
    g_args.data = data.get();
    g_args.weights = weighted ? w.data() : nullptr;
    g_args.out = out.data();
    g_args.b = b;
    g_args.rows = rows;
    g_args.lanes = lanes;
    g_args.chunks = g.chunks;
    g_args.per = g.rows_per_chunk;
    gridDim = Dim{g.blocks};
    for (unsigned blk = g.blocks; blk-- > 0;) run_block(blk, stacks);
    put(o, reinterpret_cast<const uint8_t*>(out.data()), b * lanes);
    const long long tail[2] = {g.chunks, (long long)g.blocks};
    put(o, tail, 2);
  }
  fclose(f);
  return fclose(o) == 0 ? 0 : 2;
}
