// Bulk CRUSH placement: one rule over N inputs on Hopper (sm_90a).
//
// Replaces the XLA dispatch jax.jit(jax.vmap(one)) of ceph_tpu/crush/kernel.py
// compile_rule (kernel.py:374), which XLA fuses into one device program: a
// vmapped nest of lax.while_loops (_descend, _leaf_choose, the firstn retry
// loop, the indep rounds).  It is no Pallas kernel's counterpart.  Eager
// PyTorch runs the same nest as a host-driven loop with a sync per trip
// (the plain version, crush/kernel.py crush_do_rule_batch_plain); here one
// thread runs the whole rule for one input x and computes exactly what
// _choose_firstn_jax and _choose_indep_jax compute: the descent, tries and
// leaf tries, vary_r and stable, collision checks, is_out rejection against
// the weight vector, NONE at the tail (firstn) or in place (indep).
//
// What bounds it on the H100.  Operations, not bytes: 2^20 inputs read 4 MB
// and write 12-44 MB, while each input draws about 80 straw2 items per
// replica on the 10k-OSD map.  A draw is a hash32_3 (five mix rounds of 9
// subtract/shift/xor steps, 27 instructions each), a crush_ln (a bit length,
// a 32x64-bit product and three table lookups) and a signed 64-bit division,
// which has no instruction on the card and runs as a software routine.  The
// bound counted from the plain version's draws is in PERF.md.
//
// What the design does about it.  It keeps the arithmetic exact and simple:
// the division stays a 64-bit division (a reciprocal per bucket item that is
// proven bit-exact would cut it, in a later change).  The map stays in
// device memory (0.4 MB for 10k OSDs) and L2, read through the read-only
// path; the 514 int64 ln table entries sit in shared memory, because their
// index depends on the data.  The rule rides by value in a __grid_constant__
// parameter, so one build serves every rule and map.  out and out2 are
// per-thread arrays of CRUSH_MAX_RESULT entries (local memory).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#define CRUSH_MAX_RESULT 32
#define CRUSH_LN_ENTRIES 514     // RH_LH_TBL (258 entries), then LL_TBL (256)
#define CRUSH_THREADS 128
#define CRUSH_ITEM_NONE INT_MIN
#define CRUSH_ITEM_UNDEF (-0x7FFFFFFF)
#define CRUSH_HASH_SEED 1315423911u

struct CrushParams {
  const long long* ln_tables;
  const int* items;              // (nb, ms), bucket row = -1 - id
  const long long* weights;      // (nb, ms) 16.16
  const int* sizes;              // (nb,)
  const int* types;              // (nb,)
  const long long* dev_weight;   // (n_weight,) 16.16 in/out vector
  int nb, ms, n_weight, max_devices, max_depth;
  // ChooseProgram, in its field order
  int result_max, firstn, recurse, take, count, numrep, target_type, tries,
      leaf_tries, vary_r, stable;
  const int* xs;
  long long n;
  int* out;                      // (n, result_max)
};

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= b; a -= c; a ^= c >> 13;
  b -= c; b -= a; b ^= a << 8;
  c -= a; c -= b; c ^= b >> 13;
  a -= b; a -= c; a ^= c >> 12;
  b -= c; b -= a; b ^= a << 16;
  c -= a; c -= b; c ^= b >> 5;
  a -= b; a -= c; a ^= c >> 3;
  b -= c; b -= a; b ^= a << 10;
  c -= a; c -= b; c ^= b >> 15;
}

__device__ __forceinline__ uint32_t hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = CRUSH_HASH_SEED ^ a ^ b, x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
  return h;
}

__device__ __forceinline__ uint32_t hash32_3(uint32_t a, uint32_t b,
                                             uint32_t c) {
  uint32_t h = CRUSH_HASH_SEED ^ a ^ b ^ c, x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

// 2^44 * log2(u + 1) in fixed point (mapper.c crush_ln); u <= 0xffff
__device__ __forceinline__ long long crush_ln(uint32_t u,
                                              const long long* tabs) {
  uint32_t x = u + 1u;
  int iexpon = 15;
  if (!(x & 0x18000u)) {
    const int bits = 16 - (32 - __clz(x));
    x <<= bits;
    iexpon = 15 - bits;
  }
  const int index1 = (int)((x >> 8) << 1);
  const long long rh = tabs[index1 - 256];
  long long lh = tabs[index1 + 1 - 256];
  // the product passes 2^63 at the lowest index; C takes it in uint64
  const unsigned long long xl64 =
      ((unsigned long long)x * (unsigned long long)rh) >> 48;
  lh += tabs[258 + (int)(xl64 & 0xffu)];
  return ((long long)iexpon << 44) + (lh >> 4);
}

__device__ __forceinline__ int bucket_row(const CrushParams& p, int item) {
  const long long row = -1LL - item;
  return row < 0 ? 0 : (row >= p.nb ? p.nb - 1 : (int)row);
}

// straw2: the item of the largest draw ln(hash16) / weight, the first of
// equal draws; a row with no positive weight gives its first item
__device__ int straw2(const CrushParams& p, const long long* tabs, int row,
                      uint32_t x, uint32_t r) {
  const int size = __ldg(p.sizes + row);
  const int* ids = p.items + (long long)row * p.ms;
  const long long* ws = p.weights + (long long)row * p.ms;
  long long best = LLONG_MIN;
  int best_i = 0;
  for (int i = 0; i < size; ++i) {
    const long long w = __ldg(ws + i);
    if (w <= 0) continue;
    const uint32_t u = hash32_3(x, (uint32_t)__ldg(ids + i), r) & 0xffffu;
    const long long ln = crush_ln(u, tabs) - 0x1000000000000LL;
    const long long draw = -((-ln) / w);   // -ln >= 0, w > 0: truncation
    if (draw > best) {
      best = draw;
      best_i = i;
    }
  }
  return __ldg(ids + best_i);
}

struct Pick {
  int item;
  bool empty_bad;   // met an empty bucket: the caller retries
  bool type_bad;    // dead end of the wrong type: the caller gives up
};

// from `item` down to an item of `target` (kernel.py _descend)
__device__ Pick descend(const CrushParams& p, const long long* tabs, int item,
                        uint32_t x, uint32_t r, int target) {
  bool empty = false;
  for (int depth = 0; depth < p.max_depth + 1 && item < 0; ++depth) {
    const int row = bucket_row(p, item);
    if (__ldg(p.types + row) == target) break;
    if (__ldg(p.sizes + row) == 0) {
      empty = true;
      break;
    }
    item = straw2(p, tabs, row, x, r);
  }
  const bool ok_type =
      item < 0 ? __ldg(p.types + bucket_row(p, item)) == target : target == 0;
  return {item, empty, !empty && (!ok_type || item >= p.max_devices)};
}

// weight-vector rejection (mapper.c is_out); a bucket id reads entry 0, as
// the JAX version's clip does (its answer is never used)
__device__ bool is_out(const CrushParams& p, int item, uint32_t x) {
  if (item >= p.n_weight || p.n_weight == 0) return true;
  const long long w = __ldg(p.dev_weight + (item < 0 ? 0 : item));
  if (w == 0) return true;
  if (w >= 0x10000) return false;
  return (long long)(hash32_2(x, (uint32_t)item) & 0xffffu) >= w;
}

// the chooseleaf recursion: one device under `domain` (kernel.py
// _leaf_choose); collisions against out2[0 .. limit)
__device__ int leaf_choose(const CrushParams& p, const long long* tabs,
                           int domain, uint32_t x, int rep_base, int parent_r,
                           int stride, const int* out2, int limit,
                           bool& failed) {
  for (int ft = 0; ft < p.leaf_tries; ++ft) {
    const int r = rep_base + parent_r + stride * ft;
    const Pick c = descend(p, tabs, domain, x, (uint32_t)r, 0);
    if (c.empty_bad || c.type_bad) continue;
    bool collide = false;
    for (int i = 0; i < limit; ++i) collide |= out2[i] == c.item;
    if (collide || is_out(p, c.item, x)) continue;
    failed = false;
    return c.item;
  }
  failed = true;
  return CRUSH_ITEM_NONE;
}

// kernel.py _choose_firstn_jax: placed items packed from the front
__device__ void choose_firstn(const CrushParams& p, const long long* tabs,
                              uint32_t x, int* out, int* out2) {
  int outpos = 0;
  for (int rep = 0; rep < p.count; ++rep) {
    for (int ft = 0; ft < p.tries; ++ft) {
      const int r = rep + ft;
      const Pick c = descend(p, tabs, p.take, x, (uint32_t)r, p.target_type);
      if (c.type_bad) break;                       // skip this replica
      if (c.empty_bad) continue;
      bool collide = false;
      for (int i = 0; i < outpos; ++i) collide |= out[i] == c.item;
      if (collide) continue;
      int leaf = CRUSH_ITEM_NONE;
      if (p.recurse) {
        const int sub_r =
            p.vary_r > 0 ? (p.vary_r - 1 >= 31 ? 0 : r >> (p.vary_r - 1)) : 0;
        bool failed;
        leaf = leaf_choose(p, tabs, c.item, x, p.stable ? 0 : outpos, sub_r, 1,
                           out2, outpos, failed);
        if (failed) continue;
      }
      if (p.target_type == 0 && is_out(p, c.item, x)) continue;
      out[outpos] = c.item;
      out2[outpos] = leaf;
      ++outpos;
      break;
    }
  }
}

// kernel.py _choose_indep_jax: every slot keeps its position
__device__ void choose_indep(const CrushParams& p, const long long* tabs,
                             uint32_t x, int* out, int* out2) {
  const int left0 = p.count;
  for (int i = 0; i < left0; ++i) out[i] = out2[i] = CRUSH_ITEM_UNDEF;
  int left = left0;
  for (int ft = 0; ft < p.tries && left > 0; ++ft) {
    for (int rep = 0; rep < left0; ++rep) {
      if (out[rep] != CRUSH_ITEM_UNDEF) continue;
      const int r = rep + p.numrep * ft;
      const Pick c = descend(p, tabs, p.take, x, (uint32_t)r, p.target_type);
      if (c.type_bad) {
        out[rep] = out2[rep] = CRUSH_ITEM_NONE;
        --left;
        continue;
      }
      if (c.empty_bad) continue;
      bool collide = false;
      for (int i = 0; i < left0; ++i) collide |= out[i] == c.item;
      if (collide) continue;
      int leaf = CRUSH_ITEM_NONE;
      if (p.recurse) {
        bool failed;
        leaf = leaf_choose(p, tabs, c.item, x, rep, r, p.numrep, out2, 0,
                           failed);
        if (failed) continue;
      }
      if (p.target_type == 0 && is_out(p, c.item, x)) continue;
      out[rep] = c.item;
      if (p.recurse) out2[rep] = leaf;
      --left;
    }
  }
  for (int i = 0; i < left0; ++i) {
    if (out[i] == CRUSH_ITEM_UNDEF) out[i] = CRUSH_ITEM_NONE;
    if (out2[i] == CRUSH_ITEM_UNDEF) out2[i] = CRUSH_ITEM_NONE;
  }
}

__global__ void __launch_bounds__(CRUSH_THREADS)
    crush_kernel(const __grid_constant__ CrushParams p) {
  __shared__ long long tabs[CRUSH_LN_ENTRIES];
  for (int i = threadIdx.x; i < CRUSH_LN_ENTRIES; i += blockDim.x)
    tabs[i] = __ldg(p.ln_tables + i);
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const uint32_t x = (uint32_t)__ldg(p.xs + i);
  int out[CRUSH_MAX_RESULT], out2[CRUSH_MAX_RESULT];
  for (int j = 0; j < p.result_max; ++j) out[j] = out2[j] = CRUSH_ITEM_NONE;
  if (p.firstn)
    choose_firstn(p, tabs, x, out, out2);
  else
    choose_indep(p, tabs, x, out, out2);
  const int* res = p.recurse ? out2 : out;
  int* dst = p.out + i * p.result_max;
  for (int j = 0; j < p.result_max; ++j) dst[j] = res[j];
}

extern "C" {

// ln_tables, items, weights, sizes, types, dev_weight: device pointers to the
// dense map (crush/kernel.py DenseMap, ln_tables); rule: host pointer to the
// 11 ints of a ChooseProgram (crush/kernel.py), in its field order; xs:
// device pointer to n int32; out: device pointer to n * result_max int32.
// Returns a cudaError_t.
int crush_do_rule_batch(const void* ln_tables, const void* items,
                        const void* weights, const void* sizes,
                        const void* types, const void* dev_weight, int nb,
                        int ms, int n_weight, int max_devices, int max_depth,
                        const int* rule, int device, const void* xs,
                        long long n, void* out, void* stream) {
  CrushParams p;
  p.result_max = rule[0];
  p.firstn = rule[1];
  p.recurse = rule[2];
  p.take = rule[3];
  p.count = rule[4];
  p.numrep = rule[5];
  p.target_type = rule[6];
  p.tries = rule[7];
  p.leaf_tries = rule[8];
  p.vary_r = rule[9];
  p.stable = rule[10];
  if (nb < 1 || ms < 1 || n_weight < 0 || max_depth < 0 || n < 1 ||
      p.result_max < 1 || p.result_max > CRUSH_MAX_RESULT || p.count < 0 ||
      p.count > p.result_max)
    return (int)cudaErrorInvalidValue;
  p.ln_tables = static_cast<const long long*>(ln_tables);
  p.items = static_cast<const int*>(items);
  p.weights = static_cast<const long long*>(weights);
  p.sizes = static_cast<const int*>(sizes);
  p.types = static_cast<const int*>(types);
  p.dev_weight = static_cast<const long long*>(dev_weight);
  p.nb = nb;
  p.ms = ms;
  p.n_weight = n_weight;
  p.max_devices = max_devices;
  p.max_depth = max_depth;
  p.xs = static_cast<const int*>(xs);
  p.n = n;
  p.out = static_cast<int*>(out);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (n + CRUSH_THREADS - 1) / CRUSH_THREADS;
  crush_kernel<<<(unsigned)grid, CRUSH_THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
