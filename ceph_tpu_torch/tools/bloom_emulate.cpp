// Host emulation of the hit-set kernels (csrc/hitset_bloom.cu) for the CPU
// tests; built by bloom_emulate.py with g++, never part of the port's CUDA
// build.
//
// bloom_device.inc is csrc/hitset_bloom.cu up to its host entry: the hash,
// the magic reciprocal (bloom_mod, computed on the host as the entry does),
// the remainder, both kernels and their launch shapes (bloom_blocks,
// bloom_seal_plan).  The CUDA names they use are defined below.
//
// bloom_positions_kernel runs on the grid the entry launches, one thread at
// a time, block by block, so the grid-stride loop takes the same steps as on
// the card.  bloom_seal_kernel runs as the entry launches it: the rows start
// as garbage (0xA5 bytes) and are zeroed where the plan says the entry
// zeroes them; a block is BLOOM_SEAL_THREADS fibers (ucontext) on one OS
// thread, switched round robin, in rising or falling thread order, whenever
// one waits at __syncthreads; its dynamic shared memory is one static array
// filled with 0xA5 bytes before each block; atomicOr is a plain OR (one OS
// thread).  Blocks run one at a time in reverse order.  So a kernel that
// reads its bitset before every thread has zeroed its words, writes a row
// before every thread has ORed its positions, or leans on zeroed memory,
// gives wrong rows.
//
//   bloom_emulate INPUT OUTPUT
//
// INPUT holds an int64 job count, then per job an int64 kind.  Kind 0
// (bloom_positions): three int64 (b, nhash, nbits) and b uint32 hashes;
// OUTPUT gets the (b, nhash) uint32 positions, then four int64: the magic
// m, sh1, sh2 and the grid's blocks.  Kind 1 (bloom_seal): five int64 (n,
// sets, nhash, nbits, 1 for falling thread order or 0), n uint32 hashes and
// sets + 1 int32 offsets; OUTPUT gets the (sets, ceil(nbits / 32)) uint32
// rows, then four int64: the grid's blocks a set, 1 if the bitsets were in
// shared memory, 1 if the rows were zeroed first, the shared bytes.

#include <setjmp.h>
#include <ucontext.h>

#include <algorithm>
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

struct Dim {
  unsigned x, y;
};
constexpr int kMaxThreads = 256;
static Dim g_thread[kMaxThreads], blockIdx, gridDim;
static int g_cur;  // the thread running now
#define threadIdx (g_thread[g_cur])

static inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
template <class T>
static inline T __ldg(const T* p) {
  return *p;
}
static inline uint32_t atomicOr(uint32_t* p, uint32_t v) {
  const uint32_t old = *p;
  *p = old | v;
  return old;
}

// a fiber is entered once through makecontext/swapcontext and switched
// with _setjmp/_longjmp from then on
static ucontext_t g_sched, g_fiber[kMaxThreads];
static jmp_buf g_sched_jb, g_fiber_jb[kMaxThreads];
static bool g_started[kMaxThreads], g_done[kMaxThreads],
    g_waiting[kMaxThreads];
static unsigned g_wait_gen[kMaxThreads];
static struct {
  int n, arrived;
  unsigned gen;
} g_bar;

static void __syncthreads() {
  const unsigned gen = g_bar.gen;
  if (++g_bar.arrived == g_bar.n) {
    g_bar.arrived = 0;
    ++g_bar.gen;
    return;
  }
  g_waiting[g_cur] = true;
  g_wait_gen[g_cur] = gen;
  if (!_setjmp(g_fiber_jb[g_cur])) _longjmp(g_sched_jb, 1);
  g_waiting[g_cur] = false;
}

#include "bloom_device.inc"

uint32_t bloom_seal_bits[BLOOM_SEAL_SMEM_WORDS];

// the seal a fiber runs
static struct {
  const uint32_t* hashes;
  const int* offsets;
  uint32_t* out;
  int nwords, nhash;
  BloomMod mod, by_seed;
  bool shared;
} g_seal;

static void fiber_main() {
  bloom_seal_kernel(g_seal.hashes, g_seal.offsets, g_seal.out, g_seal.nwords,
                    g_seal.nhash, g_seal.mod, g_seal.by_seed, g_seal.shared);
  g_done[g_cur] = true;
  // an ended thread no longer holds a barrier back
  if (--g_bar.n > 0 && g_bar.arrived == g_bar.n) {
    g_bar.arrived = 0;
    ++g_bar.gen;
  }
  _longjmp(g_sched_jb, 1);  // never returns through uc_link
}

// every thread of one block, round robin until all have returned
static void run_block(bool falling, std::vector<char>& stacks) {
  const int nt = BLOOM_SEAL_THREADS;
  const size_t stack = stacks.size() / kMaxThreads;
  g_bar = {nt, 0, 0};
  for (int t = 0; t < nt; ++t) {
    g_thread[t] = Dim{(unsigned)t, 0};
    g_done[t] = g_started[t] = g_waiting[t] = false;
    getcontext(&g_fiber[t]);
    g_fiber[t].uc_stack.ss_sp = stacks.data() + t * stack;
    g_fiber[t].uc_stack.ss_size = stack;
    g_fiber[t].uc_link = nullptr;
    makecontext(&g_fiber[t], fiber_main, 0);
  }
  for (int left = nt; left > 0;) {
    left = 0;
    bool moved = false;
    for (int k = 0; k < nt; ++k) {
      const int t = falling ? nt - 1 - k : k;
      if (g_done[t]) continue;
      if (g_waiting[t] && g_bar.gen == g_wait_gen[t]) {
        ++left;  // still waiting: no switch
        continue;
      }
      moved = true;
      g_cur = t;
      if (!_setjmp(g_sched_jb)) {
        if (g_started[t]) _longjmp(g_fiber_jb[t], 1);
        g_started[t] = true;
        swapcontext(&g_sched, &g_fiber[t]);
      }
      left += !g_done[t];
    }
    if (left && !moved) {
      fprintf(stderr, "block (%u, %u): every thread waits\n", blockIdx.x,
              blockIdx.y);
      exit(3);
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

static void positions_job(FILE* in, FILE* out) {
  const std::vector<int64_t> hdr = take<int64_t>(in, 3);
  const long long b = hdr[0];
  const int nhash = (int)hdr[1];
  const std::vector<uint32_t> h = take<uint32_t>(in, b);
  std::vector<uint32_t> pos(b * nhash);
  const BloomMod mod = bloom_mod((uint32_t)hdr[2]);
  gridDim = Dim{bloom_blocks(b), 1};
  g_cur = 0;
  for (blockIdx.x = 0; blockIdx.x < gridDim.x; blockIdx.x++)
    for (g_thread[0].x = 0; g_thread[0].x < BLOOM_THREADS; g_thread[0].x++)
      bloom_positions_kernel(h.data(), pos.data(), b, nhash, mod);
  put(out, pos.data(), (long long)pos.size());
  const int64_t tail[4] = {mod.m, mod.sh1, mod.sh2, gridDim.x};
  put(out, tail, 4);
}

static void seal_job(FILE* in, FILE* out, std::vector<char>& stacks) {
  const std::vector<int64_t> hdr = take<int64_t>(in, 5);
  const long long n = hdr[0], sets = hdr[1];
  const int nhash = (int)hdr[2];
  const uint32_t nbits = (uint32_t)hdr[3];
  const bool falling = hdr[4] != 0;
  const std::vector<uint32_t> h = take<uint32_t>(in, n);
  const std::vector<int> offsets = take<int>(in, sets + 1);
  long long max_set = 0;
  for (long long s = 0; s < sets; ++s)
    if (offsets[s + 1] - offsets[s] > max_set)
      max_set = offsets[s + 1] - offsets[s];
  const long long nwords = ((long long)nbits + 31) / 32;
  const BloomSealPlan plan = bloom_seal_plan(sets, max_set, nwords);
  std::vector<uint32_t> rows(sets * nwords, 0xA5A5A5A5u);
  if (plan.zero_rows) std::fill(rows.begin(), rows.end(), 0u);
  g_seal = {h.data(), offsets.data(), rows.data(), (int)nwords, nhash,
            bloom_mod(nbits), bloom_mod((uint32_t)nhash), plan.shared};
  gridDim = Dim{plan.sets, plan.chunks};
  for (long long x = plan.sets; x-- > 0;)
    for (long long y = plan.chunks; y-- > 0;) {
      blockIdx = Dim{(unsigned)x, (unsigned)y};
      memset(bloom_seal_bits, 0xA5, sizeof bloom_seal_bits);
      run_block(falling, stacks);
    }
  put(out, rows.data(), (long long)rows.size());
  const int64_t tail[4] = {plan.chunks, plan.shared, plan.zero_rows,
                           (int64_t)plan.smem};
  put(out, tail, 4);
}

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: bloom_emulate INPUT OUTPUT\n");
    return 2;
  }
  FILE* in = fopen(argv[1], "rb");
  FILE* out = fopen(argv[2], "wb");
  if (!in || !out) return 2;
  std::vector<char> stacks((size_t)kMaxThreads * (32 << 10));
  const int64_t jobs = take<int64_t>(in, 1)[0];
  for (int64_t j = 0; j < jobs; j++) {
    const int64_t kind = take<int64_t>(in, 1)[0];
    if (kind == 0)
      positions_job(in, out);
    else
      seal_job(in, out, stacks);
  }
  fclose(in);
  return fclose(out) == 0 ? 0 : 2;
}
