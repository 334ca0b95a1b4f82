// Zero-seeded crc32c (Castagnoli, reflected, no inversion) of N equal blocks
// on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ceph_tpu/ops/crc_pallas.py _crc_kernel /
// _crc_call (reached from crc32c_blocks_words).  That kernel multiplies each
// word's bit planes by a precomputed (8L, 32) GF(2) matrix on the MXU and is
// limited to blocks of at most 8 KiB; this one takes any block length that is
// a multiple of 4 bytes (the main path's hinfo chunks are 512 KiB).
//
// What bounds it on the H100.  Every byte is read once and 4 bytes are
// written per block: the main path's 704 blocks of 512 KiB are 352 MiB,
// 0.110 ms at 3.35 TB/s.  A table-driven crc costs four 4-byte shared-memory
// lookups per 4-byte word, so the shared memory must serve one lookup per
// data byte: 352 M lookups for those blocks.  An SM's shared memory serves
// 32 banks x 4 bytes per clock, i.e. 32 lookups per clock when the 32 lanes
// of a warp hit 32 different banks: 352 M / (132 SMs x 32) = 83 k clocks,
// about 0.05 ms at 1.75 GHz, under the HBM bound.  With one table shared by
// all lanes, random data sends the 32 lanes to random banks; the busiest bank
// then takes about 3.5 lookups per request, which puts the lookups alone at
// about 0.18 ms, above the HBM bound.  The compiled loop issues 21
// instructions per word: 15 to turn its four bytes into addresses (3
// shifts, 4 shift-multiplies, 4 masks, 4 multiply-adds), 4 loads and 2
// three-input XORs.  92 M words x 21 = 1.9 G lane-instructions, about
// 0.065 ms at 128 lanes per SM per clock, also under the HBM bound.
//
// What the design does about it.
//  * Lane-private, conflict-free tables.  A block is viewed as front-padded
//    with zeros to whole 128-byte rows (leading zeros leave a zero-seeded crc
//    unchanged).  In a warp, lane j takes word j of every row and keeps its
//    own state, stepped by s = Z128(s ^ w): Z128, the advance through 128
//    zero bytes, is linear, so it is four 256-entry byte tables, the same
//    four lookups and XORs per word as slicing-by-4.  The tables sit in
//    shared memory once per lane, entry (table k, index i, lane j) at word
//    (k * 256 + i) * 32 + j, so lane j always reads bank j: 128 KiB, one
//    thread block of 32 warps per SM.
//  * Coalesced loads.  Each warp load is one 128-byte row.  A warp loads
//    the next eight rows before it hashes the current eight, so it always
//    has loads in flight.
//  * A grid balanced over bytes.  One thread block per SM; the rows of all
//    blocks of the launch are split evenly over all warps, whatever the
//    block count (192 or 704 blocks on 132 SMs leave no SM doubly loaded).
//    A warp's run of rows inside one crc block ends with a per-lane step:
//    on the run's last row lane j advances through 128 - 4j bytes (a 32x32
//    GF(2) matrix per lane, conflict-free in shared memory), so the XOR of
//    the 32 lane states (one REDUX) is the run's zero-seeded crc.  That is
//    advanced through the rows after the run, one warp-wide matrix product
//    (a column per lane, one REDUX) per set bit of the row count, and
//    atomically XORed into the block's crc (crc(A||B) = Z_|B|(crc(A)) ^
//    crc(B)).  No __syncthreads runs after the tables are built.
//
// The host (ceph_tpu_torch/ops/crc_kernels.py kernel_consts) builds the byte
// tables and matrices once; they do not depend on the block length.  Each
// thread block reads them once from device memory and writes the 32 copies
// with conflict-free stores.  Times against the bound are in PERF.md.

#include <cuda_runtime.h>
#include <cstdint>

#define CRC_LANES 32
#define CRC_WARPS 32                      // warps per thread block
#define CRC_UNROLL 8                      // rows loaded ahead per warp
#define CRC_ADV_LEVELS 24                 // row advances for 2^0 .. 2^23 rows
// word offsets of the constants (TAB, FIN, ADV of crc_kernels.py):
// [k * 256 + i] is Z128(i << 8k); [FIN + b * 32 + j] column b of
// Z(128 - 4j); [ADV + l * 32 + b] column b of Z(128 << l)
#define CRC_FIN (4 * 256)
#define CRC_ADV (CRC_FIN + 32 * CRC_LANES)
#define CRC_CONSTS (CRC_ADV + CRC_ADV_LEVELS * 32)
// shared memory: the byte tables once per lane, then FIN and ADV as given
#define CRC_SMEM_WORDS (CRC_FIN * CRC_LANES + CRC_CONSTS - CRC_FIN)
#define CRC_SMEM_BYTES (CRC_SMEM_WORDS * 4)

// s = Z128(x) with lane-private tables; `tab` is already offset by the lane
__device__ __forceinline__ uint32_t z128(const uint32_t* tab, uint32_t x) {
  return tab[(x & 0xffu) << 5] ^ tab[(256u + ((x >> 8) & 0xffu)) << 5] ^
         tab[(512u + ((x >> 16) & 0xffu)) << 5] ^ tab[(768u + (x >> 24)) << 5];
}

__global__ void __launch_bounds__(CRC_WARPS * 32, 1)
    crc_kernel(const uint32_t* __restrict__ consts,
               const uint8_t* __restrict__ blocks, long long n_blocks,
               long long length, long long rows, int pad,
               uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* fin = smem + CRC_FIN * CRC_LANES;
  uint32_t* adv = fin + (CRC_ADV - CRC_FIN);
  // each table word is read once and stored once per lane; thread t starts
  // at copy t mod 32, so the 32 stores of a warp hit 32 banks
  for (int e = threadIdx.x; e < CRC_FIN; e += blockDim.x) {
    const uint32_t v = __ldg(consts + e);
#pragma unroll
    for (int j = 0; j < CRC_LANES; ++j)
      smem[e * CRC_LANES + ((j + e) & (CRC_LANES - 1))] = v;
  }
  for (int i = threadIdx.x; i < CRC_CONSTS - CRC_FIN; i += blockDim.x)
    fin[i] = __ldg(consts + CRC_FIN + i);
  __syncthreads();

  const unsigned lane = threadIdx.x & 31u;
  const uint32_t* tab = smem + lane;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  const long long warp =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long total = n_blocks * rows;
  long long lo = total * warp / warps;
  const long long hi = total * (warp + 1) / warps;
  long long n = lo / rows;
  long long r0 = lo - n * rows;
  // words of row 0 that fall in the front pad read as zero
  const bool in_pad = (int)(lane * 4) < pad;
  while (lo < hi) {
    const long long r1 = rows < r0 + (hi - lo) ? rows : r0 + (hi - lo);
    const long long last = r1 - 1;
    // word `lane` of row 0 of the front-padded block (never read in the pad)
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(blocks + n * length - pad) + lane;
    uint32_t s = 0u;
    long long r = r0;
    if (r == 0 && pad != 0 && r < last) {
      s = z128(tab, in_pad ? 0u : __ldg(src));
      r = 1;
    }
    // groups of CRC_UNROLL rows; the next group's loads are issued before
    // the current group is hashed, so a warp always has loads in flight
    if (r + CRC_UNROLL <= last) {
      uint32_t w[CRC_UNROLL], nw[CRC_UNROLL] = {};
#pragma unroll
      for (int u = 0; u < CRC_UNROLL; ++u) w[u] = __ldg(src + (r + u) * 32);
      for (; r + CRC_UNROLL <= last; r += CRC_UNROLL) {
        const bool more = r + 2 * CRC_UNROLL <= last;
        if (more) {
#pragma unroll
          for (int u = 0; u < CRC_UNROLL; ++u)
            nw[u] = __ldg(src + (r + CRC_UNROLL + u) * 32);
        }
#pragma unroll
        for (int u = 0; u < CRC_UNROLL; ++u) s = z128(tab, s ^ w[u]);
#pragma unroll
        for (int u = 0; u < CRC_UNROLL; ++u) w[u] = nw[u];
      }
    }
    for (; r < last; ++r) s = z128(tab, s ^ __ldg(src + r * 32));
    const uint32_t x =
        s ^ ((last == 0 && in_pad) ? 0u : __ldg(src + last * 32));
    // last row: lane j advances through 128 - 4j bytes
    uint32_t v = 0u;
#pragma unroll
    for (int b = 0; b < 32; ++b)
      v ^= fin[b * 32 + lane] & (0u - ((x >> b) & 1u));
    uint32_t p = __reduce_xor_sync(0xffffffffu, v);
    // through the rows after the run: lane b contributes column b
    long long after = rows - r1;
    for (int l = 0; after != 0; ++l, after >>= 1)
      if (after & 1)
        p = __reduce_xor_sync(0xffffffffu,
                              adv[l * 32 + lane] & (0u - ((p >> lane) & 1u)));
    if (lane == 0) atomicXor(out + n, p);
    lo += r1 - r0;
    ++n;
    r0 = 0;
  }
}

extern "C" {

int crc32c_smem_bytes(void) { return CRC_SMEM_BYTES; }

// consts: device pointer to CRC_CONSTS uint32 (crc_kernels.kernel_consts).
// blocks: device pointer to n_blocks * length bytes, 16-byte aligned, each
// block front-padded by `pad` zero bytes to `rows` rows of 128 bytes; out:
// device pointer to n_blocks uint32, zeroed here and then XORed into.
// Returns a cudaError_t.
int crc32c_blocks(const void* consts, int device, const void* blocks,
                  long long n_blocks, long long length, long long rows,
                  int pad, void* out, void* stream) {
  if (n_blocks < 1 || length < 4 || length % 4 != 0 || pad < 0 ||
      pad >= 128 || pad % 4 != 0 || rows * 128 - pad != length ||
      rows >= (1LL << CRC_ADV_LEVELS))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(crc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CRC_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // one thread block per SM, fewer when there are fewer rows than warps
  const long long total = n_blocks * rows;
  long long grid = (total + CRC_WARPS - 1) / CRC_WARPS;
  if (grid > sms) grid = sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, (size_t)n_blocks * 4, st);
  if (err != cudaSuccess) return (int)err;
  crc_kernel<<<(unsigned)grid, CRC_WARPS * 32, CRC_SMEM_BYTES, st>>>(
      static_cast<const uint32_t*>(consts),
      static_cast<const uint8_t*>(blocks), n_blocks, length, rows, pad,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
