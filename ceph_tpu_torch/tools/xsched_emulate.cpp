// Host emulation of the xor_sched kernels (csrc/xor_sched.cu) for the CPU
// tests; built by xsched_emulate.py with g++, never part of the port's CUDA
// build.
//
// xsched_device.inc is csrc/xor_sched.cu up to its host launchers: the
// shared-memory sizing (xs_region_buffers, xs_gf_smem) and the kernels.
// The CUDA names they use are defined below: a thread block is XS_THREADS
// fibers (ucontext) on one OS thread, switched round robin whenever one
// waits at __syncthreads; the dynamic shared memory is one static array;
// uint4 and int4 are 16-byte structs; __byte_perm picks bytes as the card
// does.  An asynchronous copy (__pipeline_memcpy_async) is a memcpy that
// lands, per job, either when it is issued ("early") or only when the
// thread waits for its group (__pipeline_wait_prior, "late"): a kernel
// that reads a buffer before waiting for it fails the late run, one that
// copies into a buffer still in use fails the early run, and a copy still
// pending when a thread ends is an error.  The grid is min(tiles, TARGET)
// blocks, run one at a time in reverse order, so a small TARGET makes
// blocks walk several tiles.
//
//   xsched_emulate INPUT OUTPUT
//
// INPUT holds an int64 job count, then per job twelve int64 (kind: 0
// regions, 1 gf; n_ops, n_regions, n_in, out_base, n_out, target; for
// regions n_objects, region_bytes, 0, for gf b, k * 2^32 + r, s; then the
// column bytes of a regions job (16, 4 or 1; 0 for gf), and 1 for early
// copies or 0 for late), the n_ops x 4 int32 branch-free tape, then the
// arena (regions: n_objects x n_regions x region_bytes) or the data (gf:
// b x k x s).  OUTPUT gets per job the arena after the launch or the (b,
// r, s) product, then four int64: the threads and blocks of the launch,
// the column bytes (regions) or copy bytes (gf), and the input buffers
// (regions; 1 for gf).

#include <setjmp.h>
#include <ucontext.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(...)
#define __restrict__
#define __shared__
#define __align__(n) __attribute__((aligned(n)))

using std::min;

struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};
struct alignas(16) int4 {
  int x, y, z, w;
};

// bytes of {y:x} picked by the low three bits of each selector nibble
static inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}

struct Dim {
  unsigned x;
};
constexpr int kMaxThreads = 32;
static Dim g_thread[kMaxThreads], blockIdx, gridDim, blockDim;
static int g_cur;  // the fiber running now
#define threadIdx (g_thread[g_cur])

template <class T>
static inline T __ldg(const T* p) {
  return *p;
}

// the asynchronous copies: per thread, the copies not landed yet with
// their group (the count of commits before them)
struct Copy {
  void* dst;
  const void* src;
  size_t n;
  long long group;
};
static std::vector<Copy> g_pending[kMaxThreads];
static long long g_commits[kMaxThreads];
static bool g_early;  // copies land when issued

static void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t zfill = 0) {
  if ((n != 4 && n != 8 && n != 16) || zfill != 0 ||
      reinterpret_cast<uintptr_t>(dst) % n ||
      reinterpret_cast<uintptr_t>(src) % n) {
    fprintf(stderr, "bad async copy of %zu bytes\n", n);
    exit(3);
  }
  if (g_early)
    memcpy(dst, src, n);
  else
    g_pending[g_cur].push_back(Copy{dst, src, n, g_commits[g_cur]});
}

static void __pipeline_commit() { ++g_commits[g_cur]; }

// every group but the newest `prior` committed ones has landed
static void __pipeline_wait_prior(size_t prior) {
  std::vector<Copy>& p = g_pending[g_cur];
  const long long upto = g_commits[g_cur] - (long long)prior;
  std::vector<Copy> left;
  for (const Copy& c : p) {
    if (c.group < upto)
      memcpy(c.dst, c.src, c.n);
    else
      left.push_back(c);
  }
  p.swap(left);
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
  int kind, n_ops, n_regions, n_in, out_base, n_out, k, r, vb, nbuf;
  const int4* tape;
  uint8_t* arena;
  const uint8_t* data;
  uint8_t* out;
  long long n_objects, cols, b, s;
} g_args;

static void fiber_main() {
  if (g_args.kind == 0 && g_args.vb == 16)
    xs_regions_kernel<uint4>(
        g_args.tape, g_args.n_ops, reinterpret_cast<uint4*>(g_args.arena),
        g_args.n_objects, g_args.n_regions, g_args.cols, g_args.n_in,
        g_args.out_base, g_args.n_out, g_args.nbuf);
  else if (g_args.kind == 0 && g_args.vb == 4)
    xs_regions_kernel<uint32_t>(
        g_args.tape, g_args.n_ops, reinterpret_cast<uint32_t*>(g_args.arena),
        g_args.n_objects, g_args.n_regions, g_args.cols, g_args.n_in,
        g_args.out_base, g_args.n_out, g_args.nbuf);
  else if (g_args.kind == 0)
    xs_regions_kernel<uint8_t>(g_args.tape, g_args.n_ops, g_args.arena,
                               g_args.n_objects, g_args.n_regions,
                               g_args.cols, g_args.n_in, g_args.out_base,
                               g_args.n_out, g_args.nbuf);
  else if (g_args.vb == 16)
    xs_gf_kernel<16>(g_args.tape, g_args.n_ops, g_args.data, g_args.out,
                     g_args.b, g_args.k, g_args.r, g_args.s,
                     g_args.n_regions, g_args.out_base);
  else
    xs_gf_kernel<4>(g_args.tape, g_args.n_ops, g_args.data, g_args.out,
                    g_args.b, g_args.k, g_args.r, g_args.s, g_args.n_regions,
                    g_args.out_base);
  if (!g_pending[g_cur].empty()) {
    fprintf(stderr, "thread %d ended with %zu copies pending\n", g_cur,
            g_pending[g_cur].size());
    exit(3);
  }
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
    g_pending[t].clear();
    g_commits[t] = 0;
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
    const std::vector<long long> h = take<long long>(f, 12);
    g_args.kind = (int)h[0];
    g_args.n_ops = (int)h[1];
    g_args.n_regions = (int)h[2];
    g_args.n_in = (int)h[3];
    g_args.out_base = (int)h[4];
    g_args.n_out = (int)h[5];
    const long long target = h[6];
    g_early = h[11] != 0;
    // 16-byte aligned, as the card's allocations are
    const std::vector<int4> tape = take<int4>(f, g_args.n_ops);
    g_args.tape = tape.data();
    long long tiles = 0;
    std::vector<uint4> buf, out;
    bool fits = g_args.n_ops % XS_BATCH == 0;
    if (g_args.kind == 0) {
      g_args.n_objects = h[7];
      const long long rbytes = h[8];
      g_args.vb = (int)h[10];
      fits = fits && (g_args.vb == 16 || g_args.vb == 4 || g_args.vb == 1) &&
             rbytes % g_args.vb == 0;
      g_args.nbuf = fits ? xs_region_buffers(g_args.n_regions, g_args.n_in,
                                             g_args.n_ops, g_args.vb)
                         : 0;
      fits = fits && g_args.nbuf > 0;
      g_args.cols = fits ? rbytes / g_args.vb : 0;
      const long long bytes = g_args.n_objects * g_args.n_regions * rbytes;
      buf.assign((size_t)(bytes + 15) / 16, uint4{0, 0, 0, 0});
      const std::vector<uint8_t> raw = take<uint8_t>(f, bytes);
      memcpy(buf.data(), raw.data(), (size_t)bytes);
      g_args.arena = reinterpret_cast<uint8_t*>(buf.data());
      tiles = g_args.n_objects *
              ((g_args.cols + XS_THREADS - 1) / XS_THREADS);
    } else {
      g_args.b = h[7];
      g_args.k = (int)(h[8] >> 32);
      g_args.r = (int)(h[8] & 0xffffffff);
      g_args.s = h[9];
      g_args.vb = g_args.s % 16 == 0 ? 16 : 4;  // the copy bytes
      g_args.nbuf = 1;
      fits = fits && g_args.s % 4 == 0 &&
             xs_gf_smem(g_args.n_regions, g_args.n_ops, g_args.k) <=
                 XS_SMEM_MAX;
      const long long bytes = g_args.b * g_args.k * g_args.s;
      buf.assign((size_t)(bytes + 15) / 16, uint4{0, 0, 0, 0});
      const std::vector<uint8_t> raw = take<uint8_t>(f, bytes);
      memcpy(buf.data(), raw.data(), (size_t)bytes);
      g_args.data = reinterpret_cast<const uint8_t*>(buf.data());
      out.assign((size_t)(g_args.b * g_args.r * g_args.s + 15) / 16,
                 uint4{0, 0, 0, 0});
      g_args.out = reinterpret_cast<uint8_t*>(out.data());
      tiles = g_args.b * ((g_args.s + XS_GF_TILE - 1) / XS_GF_TILE);
    }
    if (!fits || target < 1) {
      fprintf(stderr, "job %lld: no launch of %d regions fits\n", n,
              g_args.n_regions);
      return 2;
    }
    const long long blocks = tiles < target ? tiles : target;
    gridDim = Dim{(unsigned)blocks};
    memset(xs_smem, 0xA5, sizeof xs_smem);  // no stale zeros to lean on
    for (long long blk = blocks; blk-- > 0;)
      run_block((unsigned)blk, XS_THREADS, stacks);
    if (g_args.kind == 0)
      put(o, g_args.arena, g_args.n_objects * g_args.n_regions * h[8]);
    else
      put(o, g_args.out, g_args.b * g_args.r * g_args.s);
    const long long tail[4] = {XS_THREADS, blocks, g_args.vb, g_args.nbuf};
    put(o, tail, 4);
  }
  fclose(f);
  return fclose(o) == 0 ? 0 : 2;
}
