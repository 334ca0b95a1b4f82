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
// The tape: int32 triples (dst, a, b) over a region space of n_regions
// per object — [0, n_in) inputs, [n_in, out_base) reusable temporaries,
// [out_base, out_base + n_out) outputs — with the encoding of
// native/src/xor_sched.cc:
//   b >= 0           r[dst] = r[a] ^ r[b]
//   b == -1, a >= 0  r[dst] = r[a]          (copy)
//   b == -2          r[dst] ^= r[a]         (accumulate)
//   a == -1          r[dst] = 0             (zero fill)
// Slots are reused once their last reader has run, so ops run in tape
// order; dst may alias a or b exactly.
//
// Two entries share the executor:
//   - xor_sched_regions runs the tape over a uint8 arena (n_objects,
//     n_regions, region_bytes): input regions are read, output regions
//     written; temporary regions are scratch the kernel leaves untouched.
//     This serves the bitmatrix codecs (a chunk's packets are regions)
//     and the encode service's packed batches (one object per stripe);
//   - xor_sched_gf runs an XorSchedule of a GF(2^8) matrix's bit
//     expansion over (B, K, S) bytes into (B, R, S), the function of
//     _sched_impl and of gf_matmul on the same matrix: a thread loads one
//     32-bit word of each input row, input region 8i + j is word_i >> j
//     (bit j of each of its 4 bytes lands in bit 0 of that byte; the
//     other bits ride along and are masked off at the end, since XOR
//     never mixes bit positions), and output row r packs as the OR over
//     j of (region(out_base + 8r + j) & 0x01010101) << j.
//
// Design: one thread owns one column (4 bytes, or 1 byte when a region's
// length is no multiple of 4) of one object and walks the whole tape for
// it, so the order of the ops needs no synchronisation.  The column's
// value in every region lives in shared memory, laid out [region][thread]
// (consecutive threads on consecutive banks); the tape is uniform across
// the block and is staged in shared memory, XS_TAPE_CHUNK ops at a time
// (once, before the column loop, when it fits).  Blocks stride over
// (object, column tile) tiles, so a decode of one object with millions
// of bytes and a packed batch of thousands of one-stripe objects both
// fill the card.  The block size shrinks from 128 threads until the
// working set fits the 227 KB a block may use.
//
// What bounds it on the H100: every input byte is read once and every
// output byte written once (temporaries stay on chip); the ops cost two
// shared loads, one shared store and one XOR per column each, about
// n_ops x 4 instructions per 4 bytes of a column.  At the tapes of the
// main paths (42-254 ops, 28-48 inputs) that is 4-20 instructions per
// byte moved, under the card's issue rate at its memory rate for the
// smaller tapes; the larger are bound by the instructions.

#include <cuda_runtime.h>

#include <cstdint>

constexpr int XS_MAX_THREADS = 128;
constexpr int XS_MIN_THREADS = 32;
constexpr int XS_TAPE_CHUNK = 1024;  // ops staged in shared memory at once
constexpr int XS_TAPE_BYTES = XS_TAPE_CHUNK * 3 * 4;
constexpr int XS_SMEM_MAX = 232448;  // what one block may use on an H100

// the staged tape, then the working set [region][thread]
extern __shared__ __align__(16) unsigned char xs_smem[];

// The threads of a block for a working set of n_regions values of vb
// bytes each a thread: the largest power of two from XS_MAX_THREADS down
// to XS_MIN_THREADS that fits, or 0 when none does.
static int xs_threads(int n_regions, int vb) {
  for (int t = XS_MAX_THREADS; t >= XS_MIN_THREADS; t /= 2)
    if (XS_TAPE_BYTES + (long long)n_regions * vb * t <= XS_SMEM_MAX)
      return t;
  return 0;
}

static size_t xs_smem_bytes(int n_regions, int vb, int threads) {
  return (size_t)XS_TAPE_BYTES + (size_t)n_regions * vb * threads;
}

__device__ __forceinline__ void xs_stage(int* tape_s,
                                         const int* __restrict__ tape,
                                         int first, int n, int nt, int t) {
  for (int i = t; i < 3 * n; i += nt) tape_s[i] = tape[3 * first + i];
}

template <typename V>
__device__ __forceinline__ void xs_ops(const int* tape_s, int n, V* work,
                                       int nt, int t) {
  for (int i = 0; i < n; ++i) {
    const int dst = tape_s[3 * i], a = tape_s[3 * i + 1],
              b = tape_s[3 * i + 2];
    V* d = work + dst * nt + t;
    if (b >= 0)
      *d = (V)(work[a * nt + t] ^ work[b * nt + t]);
    else if (b == -2)
      *d = (V)(*d ^ work[a * nt + t]);
    else if (a >= 0)
      *d = work[a * nt + t];
    else
      *d = (V)0;
  }
}

// The whole tape over this thread's column.  Resident: the tape was
// staged once, before the column loop.  Otherwise every chunk is staged
// here, between barriers that every thread of the block reaches (the
// column loop's bounds are the block's, not the thread's).
template <typename V>
__device__ void xs_run(int* tape_s, const int* __restrict__ tape, int n_ops,
                       bool resident, V* work, int nt, int t) {
  if (resident) {
    xs_ops<V>(tape_s, n_ops, work, nt, t);
    return;
  }
  for (int c0 = 0; c0 < n_ops; c0 += XS_TAPE_CHUNK) {
    const int n = n_ops - c0 < XS_TAPE_CHUNK ? n_ops - c0 : XS_TAPE_CHUNK;
    __syncthreads();  // every thread is done with the last chunk
    xs_stage(tape_s, tape, c0, n, nt, t);
    __syncthreads();
    xs_ops<V>(tape_s, n, work, nt, t);
  }
}

// arena: n_objects x n_regions x cols values of V (cols = region_bytes /
// sizeof(V)); outputs written in place.
template <typename V>
__global__ void __launch_bounds__(XS_MAX_THREADS)
    xs_regions_kernel(const int* __restrict__ tape, int n_ops, V* arena,
                      long long n_objects, int n_regions, long long cols,
                      int n_in, int out_base, int n_out) {
  int* tape_s = reinterpret_cast<int*>(xs_smem);
  V* work = reinterpret_cast<V*>(xs_smem + XS_TAPE_BYTES);
  const int nt = (int)blockDim.x, t = (int)threadIdx.x;
  const bool resident = n_ops <= XS_TAPE_CHUNK;
  if (resident) {
    xs_stage(tape_s, tape, 0, n_ops, nt, t);
    __syncthreads();
  }
  const long long per_obj = (cols + nt - 1) / nt;
  const long long tiles = n_objects * per_obj;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long obj = tile / per_obj;
    const long long col = (tile - obj * per_obj) * nt + t;
    const bool active = col < cols;
    V* base = arena + obj * n_regions * cols + col;
    for (int r = 0; r < n_in; ++r)
      work[r * nt + t] = active ? base[r * cols] : (V)0;
    xs_run<V>(tape_s, tape, n_ops, resident, work, nt, t);
    if (active)
      for (int r = out_base; r < out_base + n_out; ++r)
        base[r * cols] = work[r * nt + t];
  }
}

// data: b x k x words 32-bit words, out: b x r x words; the tape's input
// regions are the 8k bit planes, its outputs the 8r.
__global__ void __launch_bounds__(XS_MAX_THREADS)
    xs_gf_kernel(const int* __restrict__ tape, int n_ops,
                 const uint32_t* __restrict__ data,
                 uint32_t* __restrict__ out, long long b, int k, int r,
                 long long words, int out_base) {
  int* tape_s = reinterpret_cast<int*>(xs_smem);
  uint32_t* work = reinterpret_cast<uint32_t*>(xs_smem + XS_TAPE_BYTES);
  const int nt = (int)blockDim.x, t = (int)threadIdx.x;
  const bool resident = n_ops <= XS_TAPE_CHUNK;
  if (resident) {
    xs_stage(tape_s, tape, 0, n_ops, nt, t);
    __syncthreads();
  }
  const long long per_item = (words + nt - 1) / nt;
  const long long tiles = b * per_item;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long item = tile / per_item;
    const long long col = (tile - item * per_item) * nt + t;
    const bool active = col < words;
    const uint32_t* src = data + item * k * words + col;
    for (int i = 0; i < k; ++i) {
      const uint32_t x = active ? __ldg(src + i * words) : 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) work[(8 * i + j) * nt + t] = x >> j;
    }
    xs_run<uint32_t>(tape_s, tape, n_ops, resident, work, nt, t);
    if (active) {
      uint32_t* dst = out + item * r * words + col;
      for (int row = 0; row < r; ++row) {
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v |= (work[(out_base + 8 * row + j) * nt + t] & 0x01010101u) << j;
        dst[row * words] = v;
      }
    }
  }
}

namespace {

// per device: its SM count, and whether each kernel may take XS_SMEM_MAX
// bytes of dynamic shared memory
int g_sms[64];
bool g_smem_set[64][3];

template <typename F>
cudaError_t xs_prepare(F kernel, int which, int device, int* sms) {
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
  *sms = g_sms[device];
  return cudaSuccess;
}

cudaError_t xs_set_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

// blocks of a launch: every tile, up to what the card holds at once
// (2048 threads an SM); the blocks stride over the rest
unsigned xs_blocks(long long tiles, int sms, int threads) {
  long long cap = (long long)sms * (2048 / threads);
  if (cap < 1) cap = 1;
  return (unsigned)(tiles < cap ? tiles : cap);
}

bool xs_tape_ok(int n_ops, int n_regions, int n_in, int out_base,
                int n_out) {
  return n_ops >= 0 && n_regions >= 1 && n_in >= 0 && out_base >= n_in &&
         n_out >= 0 && out_base + n_out == n_regions;
}

}  // namespace

extern "C" {

// The block size a launch takes for n_regions values of vb bytes (4 or
// 1), 0 when even XS_MIN_THREADS threads do not fit.
int xor_sched_threads(int n_regions, int vb) {
  return xs_threads(n_regions, vb);
}

// tape: device pointer to n_ops x 3 int32; arena: device pointer to
// n_objects x n_regions x region_bytes bytes (4-byte aligned when
// region_bytes % 4 == 0).  Returns a cudaError_t.
int xor_sched_regions(const void* tape, int n_ops, int device, void* arena,
                      long long n_objects, int n_regions,
                      long long region_bytes, int n_in, int out_base,
                      int n_out, void* stream) {
  if (n_objects < 1 || region_bytes < 1 ||
      !xs_tape_ok(n_ops, n_regions, n_in, out_base, n_out))
    return (int)cudaErrorInvalidValue;
  const bool words = region_bytes % 4 == 0;
  if (words && reinterpret_cast<uintptr_t>(arena) % 4)
    return (int)cudaErrorInvalidValue;
  const int vb = words ? 4 : 1;
  const int threads = xs_threads(n_regions, vb);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = xs_set_device(device);
  if (err != cudaSuccess) return (int)err;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* tp = static_cast<const int*>(tape);
  const long long cols = region_bytes / vb;
  const long long tiles = n_objects * ((cols + threads - 1) / threads);
  const size_t smem = xs_smem_bytes(n_regions, vb, threads);
  int sms = 0;
  if (words) {
    err = xs_prepare(xs_regions_kernel<uint32_t>, 0, device, &sms);
    if (err != cudaSuccess) return (int)err;
    xs_regions_kernel<uint32_t>
        <<<xs_blocks(tiles, sms, threads), threads, smem, st>>>(
            tp, n_ops, static_cast<uint32_t*>(arena), n_objects, n_regions,
            cols, n_in, out_base, n_out);
  } else {
    err = xs_prepare(xs_regions_kernel<uint8_t>, 1, device, &sms);
    if (err != cudaSuccess) return (int)err;
    xs_regions_kernel<uint8_t>
        <<<xs_blocks(tiles, sms, threads), threads, smem, st>>>(
            tp, n_ops, static_cast<uint8_t*>(arena), n_objects, n_regions,
            cols, n_in, out_base, n_out);
  }
  return (int)cudaGetLastError();
}

// tape: device pointer to n_ops x 3 int32 over n_regions = 8k + slots +
// 8r regions; data: device pointer to b x k x s bytes, out: b x r x s,
// both 4-byte aligned, s % 4 == 0.  Returns a cudaError_t.
int xor_sched_gf(const void* tape, int n_ops, int device, const void* data,
                 void* out, long long b, int k, int r, long long s,
                 int n_regions, int out_base, void* stream) {
  if (b < 1 || k < 1 || r < 1 || s < 4 || s % 4 ||
      reinterpret_cast<uintptr_t>(data) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 4 ||
      !xs_tape_ok(n_ops, n_regions, 8 * k, out_base, 8 * r))
    return (int)cudaErrorInvalidValue;
  const int threads = xs_threads(n_regions, 4);
  if (threads == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = xs_set_device(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = xs_prepare(xs_gf_kernel, 2, device, &sms);
  if (err != cudaSuccess) return (int)err;
  const long long words = s / 4;
  const long long tiles = b * ((words + threads - 1) / threads);
  xs_gf_kernel<<<xs_blocks(tiles, sms, threads), threads,
                 xs_smem_bytes(n_regions, 4, threads),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tape), n_ops,
      static_cast<const uint32_t*>(data), static_cast<uint32_t*>(out), b, k,
      r, words, out_base);
  return (int)cudaGetLastError();
}

}  // extern "C"
