// The XOR-schedule kernel on Hopper (sm_90a): one compiled XOR program
// (ceph_tpu_torch/ec/xsched.py XorProgram) run over a batch of columns.
//
// Replaces XLA code, not a Pallas kernel: the `xor_sched` plan kind of
// ceph_tpu/ec/plan.py (_sched_impl, :864-893), which unrolls the program
// into one elementwise XOR per op over bit planes, and the host tape of
// the bitmatrix codecs (ceph_tpu/native/src/xor_sched.cc), which the
// reference runs on the CPU.  Plain PyTorch would launch one elementwise
// kernel per op (74-254 a call at the MSR repair matrices, 100 and more
// for a liberation decode), so the program runs here in one launch.
//
// The program's tape is (dst, a, b) triples over a region space of
// n_regions per object — [0, n_in) inputs, [n_in, out_base) reusable
// temporaries, [out_base, out_base + n_out) outputs — with the copy,
// accumulate and zero-fill forms of native/src/xor_sched.cc.  The kernel
// runs the branch-free form of that tape (ops/xor_kernels.py
// branch_free_tape, lowered once per program and cached with the upload):
// every op is r[dst] = r[a] ^ r[b] over the regions plus one region Z that
// is always zero (a copy is a ^ Z, an accumulate dst ^ a, a zero fill
// Z ^ Z), each index already scaled to its byte offset in shared memory
// (region x the region's stride) and padded with Z ^ Z ops to a multiple
// of XS_BATCH.  An op is an int4 (dst, a, b, 0): one broadcast 16-byte
// shared load and no decode, where three 16-bit fields would cost shifts
// and masks per op, and the kernel's parameter space or __constant__
// memory would hold only short tapes.  Slots are reused once their last
// reader has run, so ops run in tape order; dst may alias a or b.
//
// Two entries share the executor (xs_run):
//   - xor_sched_regions runs the tape over a uint8 arena (n_objects,
//     n_regions, region_bytes): input regions are read, output regions
//     written; temporary regions are scratch the kernel leaves untouched.
//     This serves the bitmatrix codecs (a chunk's packets are regions)
//     and the encode service's packed batches (one object per stripe);
//   - xor_sched_gf runs an XorSchedule of a GF(2^8) matrix's bit
//     expansion over (B, K, S) bytes into (B, R, S), the function of
//     _sched_impl and of gf_matmul on the same matrix, bit-sliced: input
//     region 8i + j is bit plane j of row i, output row r packs from
//     regions out_base + 8r + j.
//
// Design.  A block is one warp (XS_THREADS = 32) and walks tiles of 32
// columns, so a one-stripe arena (1, 45, 2048) is 4 tiles on 4 SMs and a
// packed batch thousands; the grid holds as many blocks as the card keeps
// resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and they
// stride over the rest.  A thread owns one column of its tile and walks
// the whole tape for it; its value in every region lives in shared memory
// laid out [region][thread], so consecutive threads read consecutive
// bytes and no op needs a barrier.  Ops are read from the staged tape
// XS_BATCH at a time into registers, a batch ahead, and each op's operand
// loads are issued before the previous op's store (an operand that is
// that op's dst takes its result from the register), so a shared load's
// latency overlaps the op before it.
//   - Region entry: a column is 16 bytes (uint4) where region_bytes and
//     the arena allow it, else 4 (uint32) or 1.  The smem holds the tape,
//     two input buffers, then the temporaries, the outputs and Z.  A
//     tile's inputs come in with cp.async (__pipeline_memcpy_async, one
//     copy per region and thread; each region's slice of a tile is
//     contiguous in device memory and in the layout), all in flight at
//     once; the next tile's inputs load into the other buffer while this
//     tile's tape runs.  The staged tape has one copy per buffer, its
//     input offsets shifted onto that buffer, so an op costs the same in
//     both.  Outputs go out as coalesced 16-byte stores.  Where two input
//     buffers do not fit 227 KB, one does (the next tile's copies then
//     start after this tile's stores); where a 16-byte column fits in
//     neither, a narrower one is taken.
//   - GF entry: a thread takes 32 bytes of each input row of its tile
//     (16 at 16t and 16 at 512 + 16t of the tile's 1024, so every copy
//     and store is coalesced), copied with cp.async into a staging buffer,
//     then transposes them into 8 plane words (xs_bitslice: an 8x8 bit
//     transpose on each 64-bit quarter, then __byte_perm gathers byte j of
//     the four into plane j), so each tape op moves 32 useful bits.  The
//     planes are the regions of the tape; each output row is transposed
//     back (xs_unslice) and stored.  The staging buffer is free once
//     unpacked, so the next tile's copies are issued before this tile's
//     tape runs.  S % 16 == 0 copies 16 bytes at a time; other S % 4 == 0
//     copies and stores 4-byte words, none past the end of the row; bytes
//     past it ride along in their own bit positions and are never stored.
//   - A tape longer than the resident chunk (XS_TAPE_CHUNK ops, counting
//     both buffers' copies) is staged chunk by chunk inside each tile,
//     between barriers that every thread reaches (the tile loop's bounds
//     are the block's).
//
// What bounds it on the H100: every input byte is read once and every
// output byte written once (temporaries stay on chip).  A tape op costs
// two shared loads, an XOR and a shared store per column: 16 bytes of a
// region column, or 32 bit-sliced bytes of a GF column, per op.  At the
// main paths' tapes (42-259 ops) that is under the card's issue rate at
// its memory rate, so a large batch is bound by its bytes; a one-stripe
// arena or one recovery fragment is bound by one tile's chain of ops
// (each waits on its shared loads) and, at the call, by the host's launch.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

constexpr int XS_THREADS = 32;       // a block: one warp, a tile's columns
constexpr int XS_BATCH = 8;          // tape ops read into registers at once
constexpr int XS_TAPE_CHUNK = 512;   // tape ops staged in shared memory
constexpr int XS_SMEM_MAX = 232448;  // what one block may use on an H100
constexpr int XS_GF_TILE = 32 * XS_THREADS;  // bytes of a row per GF tile
constexpr int XS_GF_STRIDE = 4 * XS_THREADS;  // a plane region's bytes

// the staged tape, then the working set
extern __shared__ __align__(16) unsigned char xs_smem[];

// Ops of the staged tape: `copies` copies of the whole tape when they fit
// XS_TAPE_CHUNK (resident), else one chunk.
__host__ __device__ static int xs_tape_ops(int n_ops, int copies) {
  return (long long)n_ops * copies <= XS_TAPE_CHUNK ? n_ops * copies
                                                   : XS_TAPE_CHUNK;
}

// Shared memory of the region entry: the tape, nbuf input buffers, the
// other regions and Z, vb bytes a column.
static long long xs_region_smem(int n_regions, int n_in, int n_ops, int vb,
                                int nbuf) {
  return 16LL * xs_tape_ops(n_ops, nbuf) +
         (long long)(nbuf * n_in + n_regions - n_in + 1) * vb * XS_THREADS;
}

// Input buffers of the region entry at vb bytes a column: 2, 1 where only
// one fits, 0 where none does.
static int xs_region_buffers(int n_regions, int n_in, int n_ops, int vb) {
  for (int nbuf = 2; nbuf >= 1; --nbuf)
    if (xs_region_smem(n_regions, n_in, n_ops, vb, nbuf) <= XS_SMEM_MAX)
      return nbuf;
  return 0;
}

// Shared memory of the GF entry: the tape, the planes and Z, the staging
// buffer of k rows.
static long long xs_gf_smem(int n_regions, int n_ops, int k) {
  return 16LL * xs_tape_ops(n_ops, 1) +
         (long long)(n_regions + 1) * XS_GF_STRIDE + (long long)k * XS_GF_TILE;
}

__device__ __forceinline__ uint4 xs_xor(uint4 a, uint4 b) {
  uint4 r;
  r.x = a.x ^ b.x;
  r.y = a.y ^ b.y;
  r.z = a.z ^ b.z;
  r.w = a.w ^ b.w;
  return r;
}
__device__ __forceinline__ uint32_t xs_xor(uint32_t a, uint32_t b) {
  return a ^ b;
}
__device__ __forceinline__ uint8_t xs_xor(uint8_t a, uint8_t b) {
  return (uint8_t)(a ^ b);
}

// A byte offset of the branch-free tape (regions at their logical places)
// moved to this launch's layout: inputs into the buffer at in_shift, the
// rest past the extra input buffers.
__device__ __forceinline__ int xs_place(int off, int in_bytes, int in_shift,
                                        int rest_shift) {
  return off < in_bytes ? off + in_shift : off + rest_shift;
}

__device__ __forceinline__ void xs_stage(int4* tape_s,
                                         const int4* __restrict__ tape,
                                         int first, int n, int in_bytes,
                                         int in_shift, int rest_shift) {
  for (int i = (int)threadIdx.x; i < n; i += XS_THREADS) {
    int4 op = tape[first + i];
    op.x = xs_place(op.x, in_bytes, in_shift, rest_shift);
    op.y = xs_place(op.y, in_bytes, in_shift, rest_shift);
    op.z = xs_place(op.z, in_bytes, in_shift, rest_shift);
    tape_s[i] = op;
  }
}

// n ops (a multiple of XS_BATCH) over the column at `col`, in tape order.
// Each op's loads are issued before the previous op's store, so a load's
// latency overlaps that op: an operand that is the previous op's dst may
// have been read before the store, and takes the previous result from its
// register instead.  The tape is read XS_BATCH ops at a time, a batch
// ahead.
template <typename V>
__device__ __forceinline__ void xs_ops(const int4* tape_s, int n,
                                       unsigned char* col) {
  if (n == 0) return;
  int4 cur[XS_BATCH];
#pragma unroll
  for (int j = 0; j < XS_BATCH; ++j) cur[j] = tape_s[j];
  V x = *reinterpret_cast<const V*>(col + cur[0].y);
  V y = *reinterpret_cast<const V*>(col + cur[0].z);
  V r = x;
  int prev = -1;  // the previous op's dst
  for (int i0 = 0; i0 < n; i0 += XS_BATCH) {
    // the next batch (the last one reads its own ops again: valid offsets
    // whose loads are dropped)
    const int at = i0 + XS_BATCH < n ? i0 + XS_BATCH : i0;
    int4 nxt[XS_BATCH];
#pragma unroll
    for (int j = 0; j < XS_BATCH; ++j) nxt[j] = tape_s[at + j];
#pragma unroll
    for (int j = 0; j < XS_BATCH; ++j) {
      const int4 op = cur[j];
      if (op.y == prev) x = r;
      if (op.z == prev) y = r;
      const int4 next = j + 1 < XS_BATCH ? cur[j + 1] : nxt[0];
      const V xn = *reinterpret_cast<const V*>(col + next.y);
      const V yn = *reinterpret_cast<const V*>(col + next.z);
      r = xs_xor(x, y);
      *reinterpret_cast<V*>(col + op.x) = r;
      prev = op.x;
      x = xn;
      y = yn;
    }
#pragma unroll
    for (int j = 0; j < XS_BATCH; ++j) cur[j] = nxt[j];
  }
}

// The whole tape over this thread's column.  Resident: the staged copy
// for this input buffer.  Otherwise every chunk is staged here for it,
// between barriers that every thread of the block reaches.
template <typename V>
__device__ void xs_run(int4* tape_s, const int4* __restrict__ tape,
                       int n_ops, bool resident, int buf, int in_bytes,
                       int rest_shift, unsigned char* col) {
  if (resident) {
    xs_ops<V>(tape_s + buf * n_ops, n_ops, col);
    return;
  }
  for (int c0 = 0; c0 < n_ops; c0 += XS_TAPE_CHUNK) {
    const int n = min(n_ops - c0, XS_TAPE_CHUNK);
    __syncthreads();  // every thread is done with the last chunk
    xs_stage(tape_s, tape, c0, n, in_bytes, buf * in_bytes, rest_shift);
    __syncthreads();
    xs_ops<V>(tape_s, n, col);
  }
}

// one column of an input region into shared memory: cp.async for 16 and
// 4 bytes, a plain load and store for 1 (cp.async takes 4, 8 or 16)
template <typename V>
__device__ __forceinline__ void xs_copy_in(unsigned char* dst,
                                           const V* src) {
  __pipeline_memcpy_async(dst, src, sizeof(V));
}
template <>
__device__ __forceinline__ void xs_copy_in<uint8_t>(unsigned char* dst,
                                                    const uint8_t* src) {
  *dst = *src;
}

// the input regions of one tile into input buffer `buf`
template <typename V>
__device__ __forceinline__ void xs_regions_load(const V* arena,
                                                long long tile,
                                                long long per_obj,
                                                int n_regions,
                                                long long cols, int n_in,
                                                unsigned char* work,
                                                int buf) {
  const int t = (int)threadIdx.x;
  const long long obj = tile / per_obj;
  const long long c = (tile - obj * per_obj) * XS_THREADS + t;
  if (c >= cols) return;
  const V* src = arena + obj * n_regions * cols + c;
  unsigned char* dst =
      work + ((long long)buf * n_in * XS_THREADS + t) * sizeof(V);
  for (int r = 0; r < n_in; ++r)
    xs_copy_in<V>(dst + (long long)r * XS_THREADS * sizeof(V),
                  src + r * cols);
}

// arena: n_objects x n_regions x cols values of V (cols = region_bytes /
// sizeof(V)); outputs written in place.  tape: n_ops (dst, a, b, 0) byte
// offsets at a stride of sizeof(V) x XS_THREADS a region.
template <typename V>
__global__ void __launch_bounds__(XS_THREADS)
    xs_regions_kernel(const int4* __restrict__ tape, int n_ops, V* arena,
                      long long n_objects, int n_regions, long long cols,
                      int n_in, int out_base, int n_out, int nbuf) {
  const int t = (int)threadIdx.x;
  const int stride = (int)sizeof(V) * XS_THREADS;
  const int in_bytes = n_in * stride;
  const int rest_shift = (nbuf - 1) * in_bytes;
  const bool resident = (long long)n_ops * nbuf <= XS_TAPE_CHUNK;
  int4* tape_s = reinterpret_cast<int4*>(xs_smem);
  unsigned char* work = xs_smem + 16 * xs_tape_ops(n_ops, nbuf);
  unsigned char* col = work + t * (int)sizeof(V);
  // Z, this thread's column of it: zero for the whole launch
  for (int i = 0; i < (int)sizeof(V); ++i)
    col[n_regions * stride + rest_shift + i] = 0;
  if (resident)
    for (int b = 0; b < nbuf; ++b)
      xs_stage(tape_s + b * n_ops, tape, 0, n_ops, in_bytes, b * in_bytes,
               rest_shift);
  __syncthreads();
  const long long per_obj = (cols + XS_THREADS - 1) / XS_THREADS;
  const long long tiles = n_objects * per_obj;
  long long tile = blockIdx.x;
  if (tile < tiles) {
    xs_regions_load<V>(arena, tile, per_obj, n_regions, cols, n_in, work,
                       0);
    __pipeline_commit();
  }
  for (int buf = 0; tile < tiles; tile += gridDim.x) {
    __pipeline_wait_prior(0);  // this tile's inputs are in
    const long long next = tile + gridDim.x;
    if (nbuf == 2 && next < tiles) {
      xs_regions_load<V>(arena, next, per_obj, n_regions, cols, n_in, work,
                         buf ^ 1);
      __pipeline_commit();
    }
    xs_run<V>(tape_s, tape, n_ops, resident, buf, in_bytes, rest_shift,
              col);
    const long long obj = tile / per_obj;
    const long long c = (tile - obj * per_obj) * XS_THREADS + t;
    if (c < cols) {
      V* dst = arena + obj * n_regions * cols + c;
      for (int r = out_base; r < out_base + n_out; ++r)
        dst[r * cols] =
            *reinterpret_cast<const V*>(col + r * stride + rest_shift);
    }
    if (nbuf == 1 && next < tiles) {
      xs_regions_load<V>(arena, next, per_obj, n_regions, cols, n_in, work,
                         0);
      __pipeline_commit();
    }
    if (nbuf == 2) buf ^= 1;
  }
}

// 8x8 bit transpose of the 8 bytes (lo, hi): bit j of byte m becomes bit
// m of byte j.  Its own inverse.
__device__ __forceinline__ void xs_transpose8(uint32_t& lo, uint32_t& hi) {
  uint32_t t;
  t = (lo ^ (lo >> 7)) & 0x00AA00AAu;
  lo ^= t ^ (t << 7);
  t = (hi ^ (hi >> 7)) & 0x00AA00AAu;
  hi ^= t ^ (t << 7);
  t = (lo ^ (lo >> 14)) & 0x0000CCCCu;
  lo ^= t ^ (t << 14);
  t = (hi ^ (hi >> 14)) & 0x0000CCCCu;
  hi ^= t ^ (t << 14);
  t = (lo ^ (hi << 4)) & 0xF0F0F0F0u;
  lo ^= t;
  hi ^= t >> 4;
}

// 4x4 byte transpose: byte j of word i becomes byte i of word j.  Its own
// inverse.
__device__ __forceinline__ void xs_transpose4(uint32_t& a0, uint32_t& a1,
                                              uint32_t& a2, uint32_t& a3) {
  const uint32_t p = __byte_perm(a0, a1, 0x5140),
                 q = __byte_perm(a0, a1, 0x7362),
                 u = __byte_perm(a2, a3, 0x5140),
                 v = __byte_perm(a2, a3, 0x7362);
  a0 = __byte_perm(p, u, 0x5410);
  a1 = __byte_perm(p, u, 0x7632);
  a2 = __byte_perm(q, v, 0x5410);
  a3 = __byte_perm(q, v, 0x7632);
}

// 32 bytes (little-endian words w[0..7]) -> 8 plane words: bit m of w[j]
// becomes bit j of byte m of the 32
__device__ __forceinline__ void xs_bitslice(uint32_t* w) {
#pragma unroll
  for (int g = 0; g < 4; ++g) xs_transpose8(w[2 * g], w[2 * g + 1]);
  uint32_t p[8] = {w[0], w[2], w[4], w[6], w[1], w[3], w[5], w[7]};
  xs_transpose4(p[0], p[1], p[2], p[3]);
  xs_transpose4(p[4], p[5], p[6], p[7]);
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = p[j];
}

// the inverse of xs_bitslice
__device__ __forceinline__ void xs_unslice(uint32_t* w) {
  xs_transpose4(w[0], w[1], w[2], w[3]);
  xs_transpose4(w[4], w[5], w[6], w[7]);
  uint32_t p[8] = {w[0], w[4], w[1], w[5], w[2], w[6], w[3], w[7]};
#pragma unroll
  for (int g = 0; g < 4; ++g) xs_transpose8(p[2 * g], p[2 * g + 1]);
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = p[j];
}

// A GF tile's k input rows into the staging buffer, laid out [row][half]
// [thread] 16 bytes each; CP = 16 (S % 16 == 0) or 4 bytes a copy, none
// past the row
template <int CP>
__device__ __forceinline__ void xs_gf_load(const uint8_t* data,
                                           long long tile,
                                           long long per_item, int k,
                                           long long s,
                                           unsigned char* stage) {
  const int t = (int)threadIdx.x;
  const long long item = tile / per_item;
  const long long c0 = (tile - item * per_item) * XS_GF_TILE;
  const long long left = s - c0;
  const uint8_t* row = data + item * k * s + c0;
  for (int i = 0; i < k; ++i, row += s)
    for (int h = 0; h < 2; ++h) {
      const int at = h * (XS_GF_TILE / 2) + 16 * t;
      unsigned char* dst = stage + ((2 * i + h) * XS_THREADS + t) * 16;
      if (CP == 16) {
        if (at < left) __pipeline_memcpy_async(dst, row + at, 16);
      } else {
        for (int q = 0; q < 16; q += 4)
          if (at + q < left) __pipeline_memcpy_async(dst + q, row + at + q, 4);
      }
    }
}

// the staged rows of a tile -> their bit planes, regions 8i + j
__device__ __forceinline__ void xs_gf_unpack(const unsigned char* stage,
                                             int k, unsigned char* col) {
  const int t = (int)threadIdx.x;
  for (int i = 0; i < k; ++i) {
    const uint4 a =
        *reinterpret_cast<const uint4*>(stage + (2 * i * XS_THREADS + t) * 16);
    const uint4 b = *reinterpret_cast<const uint4*>(
        stage + ((2 * i + 1) * XS_THREADS + t) * 16);
    uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    xs_bitslice(w);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(col + (8 * i + j) * XS_GF_STRIDE) = w[j];
  }
}

// the tile's r output rows, packed back from regions out_base + 8q + j
template <int CP>
__device__ __forceinline__ void xs_gf_store(uint8_t* out, long long tile,
                                            long long per_item, int r,
                                            long long s, int out_base,
                                            const unsigned char* col) {
  const int t = (int)threadIdx.x;
  const long long item = tile / per_item;
  const long long c0 = (tile - item * per_item) * XS_GF_TILE;
  const long long left = s - c0;
  uint8_t* row = out + item * r * s + c0;
  for (int q = 0; q < r; ++q, row += s) {
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j] = *reinterpret_cast<const uint32_t*>(
          col + (out_base + 8 * q + j) * XS_GF_STRIDE);
    xs_unslice(w);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = h * (XS_GF_TILE / 2) + 16 * t;
      if (CP == 16) {
        if (at < left) {
          uint4 v;
          v.x = w[4 * h];
          v.y = w[4 * h + 1];
          v.z = w[4 * h + 2];
          v.w = w[4 * h + 3];
          *reinterpret_cast<uint4*>(row + at) = v;
        }
      } else {
        for (int q4 = 0; q4 < 4; ++q4)
          if (at + 4 * q4 < left)
            *reinterpret_cast<uint32_t*>(row + at + 4 * q4) = w[4 * h + q4];
      }
    }
  }
}

// data: b x k x s bytes, out: b x r x s; the tape's input regions are the
// 8k bit planes, its outputs the 8r; tape offsets at XS_GF_STRIDE a region
template <int CP>
__global__ void __launch_bounds__(XS_THREADS)
    xs_gf_kernel(const int4* __restrict__ tape, int n_ops,
                 const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                 long long b, int k, int r, long long s, int n_regions,
                 int out_base) {
  const int t = (int)threadIdx.x;
  const bool resident = n_ops <= XS_TAPE_CHUNK;
  int4* tape_s = reinterpret_cast<int4*>(xs_smem);
  unsigned char* planes = xs_smem + 16 * xs_tape_ops(n_ops, 1);
  unsigned char* stage = planes + (n_regions + 1) * XS_GF_STRIDE;
  unsigned char* col = planes + 4 * t;
  *reinterpret_cast<uint32_t*>(col + n_regions * XS_GF_STRIDE) = 0u;  // Z
  if (resident) xs_stage(tape_s, tape, 0, n_ops, 0, 0, 0);
  __syncthreads();
  const long long per_item = (s + XS_GF_TILE - 1) / XS_GF_TILE;
  const long long tiles = b * per_item;
  long long tile = blockIdx.x;
  if (tile < tiles) {
    xs_gf_load<CP>(data, tile, per_item, k, s, stage);
    __pipeline_commit();
  }
  for (; tile < tiles; tile += gridDim.x) {
    __pipeline_wait_prior(0);
    xs_gf_unpack(stage, k, col);
    const long long next = tile + gridDim.x;
    if (next < tiles) {  // the staging buffer is free once unpacked
      xs_gf_load<CP>(data, next, per_item, k, s, stage);
      __pipeline_commit();
    }
    xs_run<uint32_t>(tape_s, tape, n_ops, resident, 0, 0, 0, col);
    xs_gf_store<CP>(out, tile, per_item, r, s, out_base, col);
  }
}

namespace {

constexpr int XS_KERNELS = 5;  // regions uint4, uint32, uint8; gf 16, 4

// per device: its SM count, whether each kernel may take XS_SMEM_MAX
// bytes of dynamic shared memory, and each kernel's resident blocks an
// SM at the shared memory of its last launch
int g_sms[64];
bool g_smem_set[64][XS_KERNELS];
size_t g_occ_smem[64][XS_KERNELS];
int g_occ_blocks[64][XS_KERNELS];

cudaError_t xs_set_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

// The grid of a launch: every tile, up to what the card holds at once at
// this shared memory; the blocks stride over the rest.
template <typename F>
cudaError_t xs_prepare(F kernel, int which, int device, size_t smem,
                       long long tiles, unsigned* blocks) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSuccess;
  if (g_sms[device] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  if (!g_smem_set[device][which]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, XS_SMEM_MAX);
    if (err != cudaSuccess) return err;
    g_smem_set[device][which] = true;
  }
  if (g_occ_smem[device][which] != smem || g_occ_blocks[device][which] < 1) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        XS_THREADS, smem);
    if (err != cudaSuccess) return err;
    g_occ_smem[device][which] = smem;
    g_occ_blocks[device][which] = per_sm < 1 ? 1 : per_sm;
  }
  const long long cap = (long long)g_sms[device] * g_occ_blocks[device][which];
  *blocks = (unsigned)(tiles < cap ? tiles : cap);
  return cudaSuccess;
}

bool xs_tape_ok(const void* tape, int n_ops, int n_regions, int n_in,
                int out_base, int n_out) {
  return n_ops >= 0 && n_ops % XS_BATCH == 0 &&
         reinterpret_cast<uintptr_t>(tape) % 16 == 0 && n_regions >= 1 &&
         n_in >= 0 && out_base >= n_in && n_out >= 0 &&
         out_base + n_out == n_regions;
}

template <typename V>
cudaError_t xs_launch_regions(int which, const int4* tape, int n_ops,
                              int device, void* arena, long long n_objects,
                              int n_regions, long long region_bytes,
                              int n_in, int out_base, int n_out, int nbuf,
                              cudaStream_t st) {
  const long long cols = region_bytes / (long long)sizeof(V);
  const long long tiles =
      n_objects * ((cols + XS_THREADS - 1) / XS_THREADS);
  const size_t smem =
      (size_t)xs_region_smem(n_regions, n_in, n_ops, sizeof(V), nbuf);
  unsigned blocks = 0;
  cudaError_t err = xs_prepare(xs_regions_kernel<V>, which, device, smem,
                               tiles, &blocks);
  if (err != cudaSuccess) return err;
  xs_regions_kernel<V><<<blocks, XS_THREADS, smem, st>>>(
      tape, n_ops, static_cast<V*>(arena), n_objects, n_regions, cols, n_in,
      out_base, n_out, nbuf);
  return cudaGetLastError();
}

template <int CP>
cudaError_t xs_launch_gf(int which, const int4* tape, int n_ops, int device,
                         const void* data, void* out, long long b, int k,
                         int r, long long s, int n_regions, int out_base,
                         cudaStream_t st) {
  const long long tiles = b * ((s + XS_GF_TILE - 1) / XS_GF_TILE);
  const size_t smem = (size_t)xs_gf_smem(n_regions, n_ops, k);
  unsigned blocks = 0;
  cudaError_t err =
      xs_prepare(xs_gf_kernel<CP>, which, device, smem, tiles, &blocks);
  if (err != cudaSuccess) return err;
  xs_gf_kernel<CP><<<blocks, XS_THREADS, smem, st>>>(
      tape, n_ops, static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), b, k, r, s, n_regions, out_base);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The column bytes the region entry takes for a program of n_regions
// regions (n_in inputs) and a branch-free tape of n_ops ops: the widest of
// 16, 4 and 1 that is at most `widest` and fits a block's shared memory,
// 0 when none fits.
int xor_sched_column_bytes(int n_regions, int n_in, int n_ops, int widest) {
  for (int vb = 16; vb >= 1; vb /= 4)
    if (vb <= widest && xs_region_buffers(n_regions, n_in, n_ops, vb) > 0)
      return vb;
  return 0;
}

// 1 when the GF entry's working set (n_regions planes, k staged rows, a
// tape of n_ops ops) fits a block's shared memory, else 0.
int xor_sched_gf_fits(int n_regions, int n_ops, int k) {
  return xs_gf_smem(n_regions, n_ops, k) <= XS_SMEM_MAX ? 1 : 0;
}

// tape: device pointer to n_ops x 4 int32, the branch-free tape at a
// stride of vb x 32 bytes a region (n_ops a multiple of 8); arena: device
// pointer to n_objects x n_regions x region_bytes bytes, vb-aligned, with
// region_bytes % vb == 0 (vb: 16, 4 or 1).  Returns a cudaError_t.
int xor_sched_regions(const void* tape, int n_ops, int vb, int device,
                      void* arena, long long n_objects, int n_regions,
                      long long region_bytes, int n_in, int out_base,
                      int n_out, void* stream) {
  if (n_objects < 1 || region_bytes < 1 ||
      (vb != 16 && vb != 4 && vb != 1) || region_bytes % vb ||
      reinterpret_cast<uintptr_t>(arena) % vb ||
      !xs_tape_ok(tape, n_ops, n_regions, n_in, out_base, n_out))
    return (int)cudaErrorInvalidValue;
  const int nbuf = xs_region_buffers(n_regions, n_in, n_ops, vb);
  if (nbuf == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = xs_set_device(device);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* tp = static_cast<const int4*>(tape);
  if (vb == 16)
    err = xs_launch_regions<uint4>(0, tp, n_ops, device, arena, n_objects,
                                   n_regions, region_bytes, n_in, out_base,
                                   n_out, nbuf, st);
  else if (vb == 4)
    err = xs_launch_regions<uint32_t>(1, tp, n_ops, device, arena,
                                      n_objects, n_regions, region_bytes,
                                      n_in, out_base, n_out, nbuf, st);
  else
    err = xs_launch_regions<uint8_t>(2, tp, n_ops, device, arena, n_objects,
                                     n_regions, region_bytes, n_in,
                                     out_base, n_out, nbuf, st);
  return (int)err;
}

// tape: device pointer to n_ops x 4 int32, the branch-free tape at a
// stride of 128 bytes a region, over n_regions = 8k + slots + 8r regions;
// data: device pointer to b x k x s bytes, out: b x r x s, both 4-byte
// aligned, s % 4 == 0 (16-byte copies where s % 16 == 0 and both are
// 16-byte aligned).  Returns a cudaError_t.
int xor_sched_gf(const void* tape, int n_ops, int device, const void* data,
                 void* out, long long b, int k, int r, long long s,
                 int n_regions, int out_base, void* stream) {
  const auto dp = reinterpret_cast<uintptr_t>(data),
             op = reinterpret_cast<uintptr_t>(out);
  if (b < 1 || k < 1 || r < 1 || s < 4 || s % 4 || dp % 4 || op % 4 ||
      !xs_tape_ok(tape, n_ops, n_regions, 8 * k, out_base, 8 * r) ||
      !xor_sched_gf_fits(n_regions, n_ops, k))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = xs_set_device(device);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* tp = static_cast<const int4*>(tape);
  if (s % 16 == 0 && dp % 16 == 0 && op % 16 == 0)
    err = xs_launch_gf<16>(3, tp, n_ops, device, data, out, b, k, r, s,
                           n_regions, out_base, st);
  else
    err = xs_launch_gf<4>(4, tp, n_ops, device, data, out, b, k, r, s,
                          n_regions, out_base, st);
  return (int)err;
}

}  // extern "C"
