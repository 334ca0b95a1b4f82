// Bulk CRUSH placement: one rule over N inputs on Hopper (sm_90a).
//
// Replaces the XLA dispatch jax.jit(jax.vmap(one)) of ceph_tpu/crush/kernel.py
// compile_rule (kernel.py:374), which XLA fuses into one device program: a
// vmapped nest of lax.while_loops (_descend, _leaf_choose, the firstn retry
// loop, the indep rounds).  It is no Pallas kernel's counterpart.  Eager
// PyTorch runs the same nest as a host-driven loop with a sync per trip
// (the plain version, crush/kernel.py crush_do_rule_batch_plain).  This
// kernel computes exactly what _choose_firstn_jax and _choose_indep_jax
// compute: the descent, tries and leaf tries, vary_r and stable, collision
// checks, is_out rejection against the weight vector, NONE at the tail
// (firstn) or in place (indep).
//
// What bounds it on the H100.  Operations, not bytes: 2^20 inputs read 4 MB
// and write 12-44 MB, while each input draws about 80 straw2 items per
// replica on the 10k-OSD map.  A draw is a hash32_3 (five mix rounds of 9
// subtract/shift/xor steps), a crush_ln (a bit length, a 32x64-bit product
// and three table lookups) and a quotient.  The hash's xors and right shifts
// issue only on the integer ALU pipe, 16 lanes per clock per scheduler, half
// the issue rate; its subtracts on it or, as IMAD, on the FMA pipe.  The
// bound in PERF.md counts the issue slots and what only one pipe can take.
//
// What the design does about it.
//
// Lanes refilled from a work counter.  Each lane holds one input's state (x,
// rep/try/outpos for firstn, slot/round/slots left for indep, a pending leaf
// retry, the out and out2 rows) and runs one step at a time: one try, that
// is the descent from take to the target type, the collision check, the
// leaf choice and is_out, after which the lane advances its own state as
// choose_firstn / choose_indep of mapper.c would.  A lane whose input is done
// writes its row and takes the next input: the warp's free lanes take a
// batch with one atomicAdd by a leader on a per-launch counter and share it
// out by rank.  A persistent grid (as many blocks as fit on the SMs) runs
// until the counter passes n.  A warp no longer waits at a retry loop for
// its slowest lane: a lane that retries spends one more step while the
// others go on with their next replica or input.  Every lane starts each
// step at take, so the warp walks root -> rack -> host together, as the
// one-thread-per-input kernel did, and a step costs one try.  A leaf retry
// (chooseleaf's inner loop, set_chooseleaf_tries) is a step of its own: the
// lanes that retry a leaf skip the outer descent and join the others at the
// leaf level.  (Kept inside the step, a leaf retry held the warp for its
// whole loop: on an H100, 14.03 ms against 11.59 ms for the EC rule with a
// rebalance vector over 2^20 inputs, and no faster with all OSDs in;
// PERF.md section 6.)
//
// The tail.  Once the counter is dry a warp's lanes go idle one by one while
// its last inputs finish.  Then the warp regroups: its L remaining inputs
// are copied (shuffles) to groups of 32 / L lanes, rounded down to a power
// of two, and a group's lanes split each bucket's items among them and
// keep the smallest quotient by a shuffle reduction.  The group's lanes
// hold the same state and run the same control flow; the rank-0 lane
// writes the row.  A launch of fewer inputs than the grid has lanes runs
// this way from its second step on.
//
// Bit-exactness.  Each input's own sequence of operations is the one the
// per-input loops run: the same tries with the same r in the same order,
// the same draws, the same collision checks against the same out/out2
// prefix, the same state updates.  Only the interleaving across inputs
// changes, and inputs share no state (each lane owns its rows, the map and
// tables are read-only), so every row is what the per-input loops give.  A
// group's reduction returns the first of the smallest quotients, as one
// lane scanning the items in order would.
//
// The quotient.  A draw is -((2^48 - crush_ln(u)) / w), truncating; the
// dividend n lies in [0, 2^48] and w is a 16.16 item weight in [1, 2^32 - 1].
// The signed 64-bit division has no instruction and ran as an 83-instruction
// routine.  Instead each item carries m = ceil(2^(49+s) / w), s = ceil(log2
// w), packed as m | s << 56 (crush/kernel.py straw2_reciprocal proves it):
// n / w = umulhi(n << 15, m) >> s exactly over the whole range.  The largest
// draw is then the smallest quotient, the first of equal ones.  A weight <= 0
// packs as 0 and is skipped, as the division skipped it.
//
// Memory.  The map stays in device memory (0.4 MB ids, 0.4 MB reciprocals
// for 10k OSDs) and L2, read through the read-only path; the 514 int64 ln
// table entries sit in shared memory, because their index depends on the
// data.  The rule rides by value in a __grid_constant__ parameter, so one
// build serves every rule and map.  out and out2 are per-lane arrays of
// CRUSH_MAX_RESULT entries (local memory), reset when a lane takes an input.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#define CRUSH_MAX_RESULT 32
#define CRUSH_LN_ENTRIES 514     // RH_LH_TBL (258 entries), then LL_TBL (256)
#define CRUSH_THREADS 128
#define CRUSH_ITEM_NONE INT_MIN
#define CRUSH_ITEM_UNDEF (-0x7FFFFFFF)
#define CRUSH_HASH_SEED 1315423911u
#define CRUSH_RECIP_SHIFT 56     // a reciprocal packs m | s << 56

struct CrushParams {
  const long long* ln_tables;
  const int* items;                    // (nb, ms), bucket row = -1 - id
  const unsigned long long* recips;    // (nb, ms) m | s << 56; 0: w <= 0
  const int* sizes;                    // (nb,)
  const int* types;                    // (nb,)
  const long long* dev_weight;         // (n_weight,) 16.16 in/out vector
  int nb, ms, n_weight, max_devices, max_depth;
  // ChooseProgram, in its field order
  int result_max, firstn, recurse, take, count, numrep, target_type, tries,
      leaf_tries, vary_r, stable;
  const int* xs;
  long long n;
  int* out;                            // (n, result_max)
  unsigned long long* next;            // the work counter, zeroed per launch
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

// The lanes that share one input: `size` (a power of two) lanes aligned in
// the warp, this lane's rank among them and their mask.  Until the work
// counter is dry every lane has its own input (size 1); after it, the warp
// regroups its remaining inputs over all its lanes.
struct Group {
  int size, sub;
  unsigned mask;
};

__device__ __forceinline__ int bucket_row(const CrushParams& p, int item) {
  const long long row = -1LL - item;
  return row < 0 ? 0 : (row >= p.nb ? p.nb - 1 : (int)row);
}

// straw2: the item of the largest draw -(n / w), n = 2^48 - ln(hash16), i.e.
// of the smallest quotient, the first of equal ones; a row with no positive
// weight gives its first item.  A group's lanes draw every g.size-th item
// from their rank on and then keep the smallest quotient, the lowest index
// of equal ones, so they all return what one lane drawing all items would.
__device__ int straw2(const CrushParams& p, const long long* tabs,
                      const Group& g, int row, uint32_t x, uint32_t r) {
  const int size = __ldg(p.sizes + row);
  const int* ids = p.items + (long long)row * p.ms;
  const unsigned long long* rcs = p.recips + (long long)row * p.ms;
  unsigned long long best = ULLONG_MAX;
  int best_i = INT_MAX;
#pragma unroll 1
  for (int i = g.sub; i < size; i += g.size) {
    const unsigned long long rc = __ldg(rcs + i);
    if (rc == 0) continue;
    const uint32_t u = hash32_3(x, (uint32_t)__ldg(ids + i), r) & 0xffffu;
    const unsigned long long n = 0x1000000000000ULL - crush_ln(u, tabs);
    const unsigned long long q =
        __umul64hi(n << 15, rc & ((1ULL << CRUSH_RECIP_SHIFT) - 1)) >>
        (rc >> CRUSH_RECIP_SHIFT);
    if (q < best) {
      best = q;
      best_i = i;
    }
  }
  for (int off = 1; off < g.size; off <<= 1) {
    const unsigned long long other_q = __shfl_xor_sync(g.mask, best, off);
    const int other_i = __shfl_xor_sync(g.mask, best_i, off);
    if (other_q < best || (other_q == best && other_i < best_i)) {
      best = other_q;
      best_i = other_i;
    }
  }
  return __ldg(ids + (best_i == INT_MAX ? 0 : best_i));
}

struct Pick {
  int item;
  bool empty_bad;   // met an empty bucket: the caller retries
  bool type_bad;    // dead end of the wrong type: the caller gives up
};

// from `item` down to an item of `target` (kernel.py _descend)
__device__ Pick descend(const CrushParams& p, const long long* tabs,
                        const Group& g, int item, uint32_t x, uint32_t r,
                        int target) {
  bool empty = false;
  for (int depth = 0; depth < p.max_depth + 1 && item < 0; ++depth) {
    const int row = bucket_row(p, item);
    if (__ldg(p.types + row) == target) break;
    if (__ldg(p.sizes + row) == 0) {
      empty = true;
      break;
    }
    item = straw2(p, tabs, g, row, x, r);
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

__device__ __forceinline__ bool collides(const int* row, int limit, int item) {
  bool hit = false;
  for (int i = 0; i < limit; ++i) hit |= row[i] == item;
  return hit;
}

// One lane's input: firstn keeps (rep, ft, pos = outpos), indep (rep = slot,
// ft = round, pos = slots left); lf > 0 marks a leaf retry of `cand` that
// the next step takes up at leaf try lf.
struct Lane {
  long long i;
  uint32_t x;
  int rep, ft, pos, lf, cand;
};

// Move the lane to its next try (firstn: the next replica once the tries
// run out; indep: the next open slot, then the next round).  True when the
// input is done.
__device__ bool settle(const CrushParams& p, Lane& s, const int* out) {
  if (p.firstn) {
    while (s.rep < p.count && s.ft >= p.tries) {
      ++s.rep;
      s.ft = 0;
    }
    return s.rep >= p.count;
  }
  for (;;) {
    if (s.pos <= 0 || s.ft >= p.tries) return true;
    while (s.rep < p.count && out[s.rep] != CRUSH_ITEM_UNDEF) ++s.rep;
    if (s.rep < p.count) return false;
    ++s.ft;
    s.rep = 0;
  }
}

// Take input i; true when it is done at once (no replica to place).
__device__ bool lane_start(const CrushParams& p, Lane& s, long long i,
                           int* out, int* out2) {
  s.i = i;
  s.x = (uint32_t)__ldg(p.xs + i);
  s.rep = s.ft = s.lf = 0;
  s.pos = p.firstn ? 0 : p.count;
  s.cand = CRUSH_ITEM_NONE;
  const int open = p.firstn ? 0 : p.count;
  for (int j = 0; j < p.result_max; ++j)
    out[j] = out2[j] = j < open ? CRUSH_ITEM_UNDEF : CRUSH_ITEM_NONE;
  return settle(p, s, out);
}

enum Verdict { FAIL, PLACE, GIVE_UP, LEAF };

// One try of the lane's input (choose_firstn / choose_indep of mapper.c, one
// trip of their inner loops), or one leaf try of a pending leaf retry; true
// when the input is done.
__device__ bool lane_step(const CrushParams& p, const long long* tabs,
                          const Group& g, Lane& s, int* out, int* out2) {
  const int r = p.firstn ? s.rep + s.ft : s.rep + p.numrep * s.ft;
  Verdict v = LEAF;
  int item = s.cand, leaf = CRUSH_ITEM_NONE;
  if (s.lf == 0) {
    const Pick c =
        descend(p, tabs, g, p.take, s.x, (uint32_t)r, p.target_type);
    item = c.item;
    if (c.type_bad)
      v = GIVE_UP;
    else if (c.empty_bad ||
             collides(out, p.firstn ? s.pos : p.count, c.item))
      v = FAIL;
    else if (p.recurse)
      s.cand = c.item;
    else
      v = PLACE;
  }
  if (v == LEAF) {
    // the chooseleaf recursion (kernel.py _leaf_choose): one device under
    // s.cand, collisions against out2[0 .. limit)
    int base, limit, stride;
    if (p.firstn) {
      base = (p.stable ? 0 : s.pos) +
             (p.vary_r > 0 ? (p.vary_r - 1 >= 31 ? 0 : r >> (p.vary_r - 1))
                           : 0);
      limit = s.pos;
      stride = 1;
    } else {
      base = s.rep + r;
      limit = 0;
      stride = p.numrep;
    }
    v = FAIL;
    if (s.lf < p.leaf_tries) {
      const Pick c = descend(p, tabs, g, s.cand, s.x,
                             (uint32_t)(base + stride * s.lf), 0);
      ++s.lf;
      if (!c.empty_bad && !c.type_bad && !collides(out2, limit, c.item) &&
          !is_out(p, c.item, s.x)) {
        leaf = c.item;
        v = PLACE;
      } else if (s.lf < p.leaf_tries) {
        return false;   // the next step takes up leaf try s.lf
      }
    }
    s.lf = 0;
  }
  if (v == PLACE && p.target_type == 0 && is_out(p, item, s.x)) v = FAIL;
  if (p.firstn) {
    if (v == PLACE) {
      out[s.pos] = item;
      out2[s.pos] = leaf;
      ++s.pos;
    }
    if (v == FAIL) {
      ++s.ft;
    } else {
      ++s.rep;
      s.ft = 0;
    }
  } else {
    if (v == PLACE) {
      out[s.rep] = item;
      if (p.recurse) out2[s.rep] = leaf;
      --s.pos;
    } else if (v == GIVE_UP) {
      out[s.rep] = out2[s.rep] = CRUSH_ITEM_NONE;
      --s.pos;
    }
    ++s.rep;
  }
  return settle(p, s, out);
}

__device__ void lane_write(const CrushParams& p, const Lane& s,
                           const int* out, const int* out2) {
  const int* res = p.recurse ? out2 : out;
  int* dst = p.out + s.i * p.result_max;
  for (int j = 0; j < p.result_max; ++j)
    dst[j] = res[j] == CRUSH_ITEM_UNDEF ? CRUSH_ITEM_NONE : res[j];
}

// After the counter is dry: spread the warp's `live` remaining inputs (one
// per set bit of `heads`, each held by its group's rank-0 lane) over groups
// of `size` lanes, copying each input's state to its new group.
__device__ void regroup(const CrushParams& p, unsigned heads, int live,
                        int size, Group& g, Lane& s, bool& busy, int* out,
                        int* out2) {
  const unsigned lane = threadIdx.x & 31u;
  const int k = (int)lane / size;
  int src = (int)lane;
  if (k < live) {
    unsigned m = heads;
    for (int j = 0; j < k; ++j) m &= m - 1u;
    src = __ffs(m) - 1;
  }
  s.i = __shfl_sync(0xffffffffu, s.i, src);
  s.x = __shfl_sync(0xffffffffu, s.x, src);
  s.rep = __shfl_sync(0xffffffffu, s.rep, src);
  s.ft = __shfl_sync(0xffffffffu, s.ft, src);
  s.pos = __shfl_sync(0xffffffffu, s.pos, src);
  s.lf = __shfl_sync(0xffffffffu, s.lf, src);
  s.cand = __shfl_sync(0xffffffffu, s.cand, src);
  for (int j = 0; j < p.result_max; ++j) {
    out[j] = __shfl_sync(0xffffffffu, out[j], src);
    out2[j] = __shfl_sync(0xffffffffu, out2[j], src);
  }
  busy = k < live;
  g.size = size;
  g.sub = (int)lane & (size - 1);
  g.mask = size == 32 ? 0xffffffffu
                      : ((1u << size) - 1u) << (lane & ~(unsigned)(size - 1));
}

__global__ void __launch_bounds__(CRUSH_THREADS)
    crush_kernel(const __grid_constant__ CrushParams p) {
  __shared__ long long tabs[CRUSH_LN_ENTRIES];
  for (int i = threadIdx.x; i < CRUSH_LN_ENTRIES; i += blockDim.x)
    tabs[i] = __ldg(p.ln_tables + i);
  __syncthreads();
  const unsigned lane = threadIdx.x & 31u;
  int out[CRUSH_MAX_RESULT], out2[CRUSH_MAX_RESULT];
  Lane s;
  Group g = {1, 0, 1u << lane};
  bool busy = false, dry = false;   // dry: every input is handed out
  for (;;) {
    if (!dry) {
      const unsigned idle = __ballot_sync(0xffffffffu, !busy);
      if (idle) {
        const int leader = __ffs(idle) - 1;
        unsigned long long base = 0;
        if (lane == (unsigned)leader)
          base = atomicAdd(p.next, (unsigned long long)__popc(idle));
        base = __shfl_sync(0xffffffffu, base, leader);
        dry = base + __popc(idle) >= (unsigned long long)p.n;
        if (!busy) {
          const unsigned long long i =
              base + __popc(idle & ((1u << lane) - 1u));
          if (i < (unsigned long long)p.n) {
            if (lane_start(p, s, (long long)i, out, out2))
              lane_write(p, s, out, out2);
            else
              busy = true;
          }
        }
      }
    } else {
      // no input is left to take: lanes whose input is done join the
      // groups of the inputs still running, so the warp's last inputs
      // draw each bucket's items on several lanes at once
      const unsigned heads = __ballot_sync(0xffffffffu, busy && g.sub == 0);
      const int live = __popc(heads);
      if (live == 0) break;
      int size = g.size;
      while (size < 32 && live * size * 2 <= 32) size *= 2;
      if (size > g.size) regroup(p, heads, live, size, g, s, busy, out, out2);
    }
    if (!__any_sync(0xffffffffu, busy)) continue;
    if (busy && lane_step(p, tabs, g, s, out, out2)) {
      if (g.sub == 0) lane_write(p, s, out, out2);
      busy = false;
    }
  }
}

extern "C" {

// ln_tables, items, recips, sizes, types, dev_weight: device pointers to the
// dense map (crush/kernel.py DenseMap, ln_tables); rule: host pointer to the
// 11 ints of a ChooseProgram (crush/kernel.py), in its field order; xs:
// device pointer to n int32; out: device pointer to n * result_max int32;
// next: device pointer to one 8-byte word, the work counter, which this call
// zeroes on `stream` before the launch.  Returns a cudaError_t.
int crush_do_rule_batch(const void* ln_tables, const void* items,
                        const void* recips, const void* sizes,
                        const void* types, const void* dev_weight, int nb,
                        int ms, int n_weight, int max_devices, int max_depth,
                        const int* rule, int device, const void* xs,
                        long long n, void* out, void* next, void* stream) {
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
  p.recips = static_cast<const unsigned long long*>(recips);
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
  p.next = static_cast<unsigned long long*>(next);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crush_kernel,
                                                      CRUSH_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(p.next, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  const long long need = (n + CRUSH_THREADS - 1) / CRUSH_THREADS;
  const long long fit = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  crush_kernel<<<(unsigned)(need < fit ? need : fit), CRUSH_THREADS, 0, st>>>(
      p);
  return (int)cudaGetLastError();
}

}  // extern "C"
