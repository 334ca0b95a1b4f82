// Host emulation of the xor_sched kernels (csrc/xor_sched.cu) for the CPU
// tests; built by xsched_emulate.py with g++, never part of the port's CUDA
// build.
//
// xsched_device.inc is csrc/xor_sched.cu up to its host launchers: the
// block-size choice (xs_threads) and the two kernels.  The CUDA builtins
// they use are defined below: a thread block is blockDim.x fibers
// (ucontext) on one OS thread, switched round robin whenever one waits at
// __syncthreads; the dynamic shared memory is one static array.  The grid
// is min(tiles, TARGET) blocks, run one at a time in reverse order, so a
// small TARGET makes blocks walk several tiles.
//
//   xsched_emulate INPUT OUTPUT
//
// INPUT holds an int64 job count, then per job ten int64 (kind: 0 regions,
// 1 gf; n_ops, n_regions, n_in, out_base, n_out, target, and for regions
// n_objects, region_bytes, 0, for gf b, k * 2^32 + r, s), the n_ops x 3
// int32 tape, then the arena (regions: n_objects x n_regions x
// region_bytes) or the data (gf: b x k x s).  OUTPUT gets per job the
// arena after the launch or the (b, r, s) product, then two int64: the
// threads and the blocks of the launch.

#include <setjmp.h>
#include <ucontext.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(...)
#define __restrict__
#define __shared__
#define __align__(n) __attribute__((aligned(n)))

struct Dim {
  unsigned x;
};
constexpr int kMaxThreads = 128;
static Dim g_thread[kMaxThreads], blockIdx, gridDim, blockDim;
static int g_cur;  // the fiber running now
#define threadIdx (g_thread[g_cur])

template <class T>
static inline T __ldg(const T* p) {
  return *p;
}

// a fiber is entered once through makecontext/swapcontext and switched
// with _setjmp/_longjmp from then on
static ucontext_t g_sched, g_fiber[kMaxThreads];
static jmp_buf g_sched_jb, g_fiber_jb[kMaxThreads];
static bool g_started[kMaxThreads], g_done[kMaxThreads];

struct Barrier {
  int n, arrived;
  unsigned gen;
};
static Barrier* g_wait_bar[kMaxThreads];
static unsigned g_wait_gen[kMaxThreads];
static Barrier g_block = {kMaxThreads, 0, 0};

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

static void __syncthreads() { barrier_wait(g_block); }

#include "xsched_device.inc"

__attribute__((aligned(16))) unsigned char xs_smem[XS_SMEM_MAX];

// the launch a fiber runs
static struct {
  int kind, n_ops, n_regions, n_in, out_base, n_out, k, r;
  const int* tape;
  uint8_t* arena;
  const uint8_t* data;
  uint8_t* out;
  long long n_objects, cols, b, words;
} g_args;

static void fiber_main() {
  if (g_args.kind == 0 && g_args.k == 4)  // k: the value bytes
    xs_regions_kernel<uint32_t>(
        g_args.tape, g_args.n_ops, reinterpret_cast<uint32_t*>(g_args.arena),
        g_args.n_objects, g_args.n_regions, g_args.cols, g_args.n_in,
        g_args.out_base, g_args.n_out);
  else if (g_args.kind == 0)
    xs_regions_kernel<uint8_t>(g_args.tape, g_args.n_ops, g_args.arena,
                               g_args.n_objects, g_args.n_regions,
                               g_args.cols, g_args.n_in, g_args.out_base,
                               g_args.n_out);
  else
    xs_gf_kernel(g_args.tape, g_args.n_ops,
                 reinterpret_cast<const uint32_t*>(g_args.data),
                 reinterpret_cast<uint32_t*>(g_args.out), g_args.b, g_args.k,
                 g_args.r, g_args.words, g_args.out_base);
  g_done[g_cur] = true;
  _longjmp(g_sched_jb, 1);  // never returns through uc_link
}

// every thread of one block, round robin until all have returned
static void run_block(unsigned block, int nt, std::vector<char>& stacks) {
  blockIdx = Dim{block};
  blockDim = Dim{(unsigned)nt};
  g_block = Barrier{nt, 0, 0};
  const size_t stack = stacks.size() / kMaxThreads;
  for (int t = 0; t < nt; ++t) {
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
  for (int left = nt; left > 0;) {
    left = 0;
    for (int t = 0; t < nt; ++t) {
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
    fprintf(stderr, "usage: xsched_emulate INPUT OUTPUT\n");
    return 2;
  }
  FILE* f = fopen(argv[1], "rb");
  FILE* o = fopen(argv[2], "wb");
  if (!f || !o) return 2;
  std::vector<char> stacks((size_t)kMaxThreads * (64 << 10));
  const long long jobs = take<long long>(f, 1)[0];
  for (long long n = 0; n < jobs; ++n) {
    const std::vector<long long> h = take<long long>(f, 10);
    g_args.kind = (int)h[0];
    g_args.n_ops = (int)h[1];
    g_args.n_regions = (int)h[2];
    g_args.n_in = (int)h[3];
    g_args.out_base = (int)h[4];
    g_args.n_out = (int)h[5];
    const long long target = h[6];
    const std::vector<int> tape = take<int>(f, 3LL * g_args.n_ops);
    g_args.tape = tape.data();
    int nt = 0;
    long long tiles = 0;
    std::vector<uint32_t> buf, out;  // 4-byte aligned, as on the card
    if (g_args.kind == 0) {
      g_args.n_objects = h[7];
      const long long rbytes = h[8];
      const int vb = rbytes % 4 == 0 ? 4 : 1;
      g_args.k = vb;
      g_args.cols = rbytes / vb;
      nt = xs_threads(g_args.n_regions, vb);
      const long long bytes = g_args.n_objects * g_args.n_regions * rbytes;
      buf.assign((size_t)(bytes + 3) / 4, 0);
      const std::vector<uint8_t> raw = take<uint8_t>(f, bytes);
      memcpy(buf.data(), raw.data(), (size_t)bytes);
      g_args.arena = reinterpret_cast<uint8_t*>(buf.data());
      tiles = g_args.n_objects * ((g_args.cols + nt - 1) / (nt ? nt : 1));
    } else {
      g_args.b = h[7];
      g_args.k = (int)(h[8] >> 32);
      g_args.r = (int)(h[8] & 0xffffffff);
      const long long s = h[9];
      g_args.words = s / 4;
      nt = xs_threads(g_args.n_regions, 4);
      const long long bytes = g_args.b * g_args.k * s;
      buf.assign((size_t)bytes / 4, 0);
      const std::vector<uint8_t> raw = take<uint8_t>(f, bytes);
      memcpy(buf.data(), raw.data(), (size_t)bytes);
      g_args.data = reinterpret_cast<const uint8_t*>(buf.data());
      out.assign((size_t)(g_args.b * g_args.r * s / 4), 0);
      g_args.out = reinterpret_cast<uint8_t*>(out.data());
      tiles = g_args.b * ((g_args.words + nt - 1) / (nt ? nt : 1));
    }
    if (nt == 0 || target < 1) {
      fprintf(stderr, "job %lld: %d regions fit no block\n", n,
              g_args.n_regions);
      return 2;
    }
    const long long blocks = tiles < target ? tiles : target;
    gridDim = Dim{(unsigned)blocks};
    memset(xs_smem, 0xA5, sizeof xs_smem);  // no stale zeros to lean on
    for (long long blk = blocks; blk-- > 0;)
      run_block((unsigned)blk, nt, stacks);
    if (g_args.kind == 0)
      put(o, g_args.arena,
          g_args.n_objects * g_args.n_regions * g_args.cols * g_args.k);
    else
      put(o, g_args.out, g_args.b * g_args.r * g_args.words * 4);
    const long long tail[2] = {nt, blocks};
    put(o, tail, 2);
  }
  fclose(f);
  return fclose(o) == 0 ? 0 : 2;
}
