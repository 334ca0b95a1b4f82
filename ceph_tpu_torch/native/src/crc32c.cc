// crc32c (Castagnoli) for the port's host code: the messenger's per-frame
// preamble and payload crcs and every host crc32c of bytes-like data
// (ceph_tpu_torch/ops/checksum.py crc32c).  A copy of the crc32c part of
// the JAX package's ceph_tpu/native/src/checksum.cc (ceph_tpu_crc32c and
// ceph_tpu_crc32c_zeros, the slicing-by-8 tables, the SSE4.2 three-lane
// path and the zero-run matrices), so both packages compute the same crcs.
//
// Reference semantics: ceph_crc32c(seed, data, len) with NO pre/post
// inversion; data == NULL means "len zero bytes" (the reference's
// src/include/crc32c.h:43-50); ceph_crc32c_zeros is the O(log len)
// advance through a run of zeros (src/common/crc32c.cc:216-239), here
// GF(2) 32x32 matrix squaring computed at load.
//
// Build: g++ -O3 -shared -fPIC (driven by ceph_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// crc32c (Castagnoli, reflected poly 0x82F63B78), slicing-by-8
// ---------------------------------------------------------------------------

static uint32_t crc_table[8][256];

static void crc32c_init_tables() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = crc_table[0][i];
    for (int t = 1; t < 8; t++) {
      c = crc_table[0][c & 0xff] ^ (c >> 8);
      crc_table[t][i] = c;
    }
  }
}

// GF(2) 32x32 matrices for zero-run folding (column b = image of bit b).
static void gf2_matmul_vec(const uint32_t m[32], uint32_t *crc) {
  uint32_t out = 0, v = *crc;
  for (int b = 0; v; b++, v >>= 1)
    if (v & 1) out ^= m[b];
  *crc = out;
}

static void gf2_matmul_mat(const uint32_t a[32], const uint32_t b[32],
                           uint32_t out[32]) {
  for (int i = 0; i < 32; i++) {
    uint32_t v = b[i];
    gf2_matmul_vec(a, &v);
    out[i] = v;
  }
}

// zero_mat[r] advances a crc through 2^r zero bytes.
static uint32_t zero_mat[64][32];

static void crc32c_init_zero_mats() {
  for (int b = 0; b < 32; b++) {  // one zero byte
    uint32_t s = 1u << b;
    zero_mat[0][b] = crc_table[0][s & 0xff] ^ (s >> 8);
  }
  for (int r = 1; r < 64; r++)
    gf2_matmul_mat(zero_mat[r - 1], zero_mat[r - 1], zero_mat[r]);
}

uint32_t ceph_tpu_crc32c_zeros(uint32_t crc, uint64_t len) {
  for (int r = 0; len; r++, len >>= 1)
    if (len & 1) gf2_matmul_vec(zero_mat[r], &crc);
  return crc;
}

static uint32_t crc32c_sw(uint32_t crc, const uint8_t *data, uint64_t len) {
  while (len && (reinterpret_cast<uintptr_t>(data) & 7)) {
    crc = crc_table[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
    len--;
  }
  while (len >= 8) {
    uint64_t w;
    std::memcpy(&w, data, 8);
    w ^= crc;
    crc = crc_table[7][w & 0xff] ^ crc_table[6][(w >> 8) & 0xff] ^
          crc_table[5][(w >> 16) & 0xff] ^ crc_table[4][(w >> 24) & 0xff] ^
          crc_table[3][(w >> 32) & 0xff] ^ crc_table[2][(w >> 40) & 0xff] ^
          crc_table[1][(w >> 48) & 0xff] ^ crc_table[0][(w >> 56) & 0xff];
    data += 8;
    len -= 8;
  }
  while (len--) crc = crc_table[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
  return crc;
}

#if defined(__x86_64__)
// Hardware CRC32C (the SSE4.2 crc32 instruction computes exactly the
// Castagnoli reflected CRC) — the crc32c_intel_fast role
// (the reference's src/common/crc32c_intel_fast.c); ~10x the
// slicing-by-8 tables.
__attribute__((target("sse4.2")))
static uint32_t crc32c_hw_1way(uint32_t crc, const uint8_t *data,
                               uint64_t len) {
  uint64_t c = crc;
  while (len >= 8) {
    uint64_t w;
    std::memcpy(&w, data, 8);
    c = __builtin_ia32_crc32di(c, w);
    data += 8;
    len -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (len--) c32 = __builtin_ia32_crc32qi(c32, *data++);
  return c32;
}

// The crc32 instruction has ~3-cycle latency, 1-cycle throughput: a
// single dependency chain caps at ~2.7 B/cycle.  Three independent
// lanes fill the pipeline (~8 B/cycle), recombined through zero-run
// advance folds — the standard interleave the reference's asm tier
// implements with PCLMULQDQ folding.
__attribute__((target("sse4.2")))
static uint32_t crc32c_hw(uint32_t crc, const uint8_t *data, uint64_t len) {
  constexpr uint64_t MIN3 = 3 * 256;
  if (len < MIN3) return crc32c_hw_1way(crc, data, len);
  uint64_t lane = (len / 24) * 8;  // 8-byte-aligned lane length
  const uint8_t *pa = data, *pb = data + lane, *pc = data + 2 * lane;
  uint64_t a = crc, b = 0, c = 0;
  for (uint64_t i = 0; i < lane; i += 8) {
    uint64_t wa, wb, wc;
    std::memcpy(&wa, pa + i, 8);
    std::memcpy(&wb, pb + i, 8);
    std::memcpy(&wc, pc + i, 8);
    a = __builtin_ia32_crc32di(a, wa);
    b = __builtin_ia32_crc32di(b, wb);
    c = __builtin_ia32_crc32di(c, wc);
  }
  uint64_t tail = len - 3 * lane;
  uint32_t a32 = static_cast<uint32_t>(a);
  uint32_t b32 = static_cast<uint32_t>(b);
  uint32_t c32 = static_cast<uint32_t>(c);
  // result = advance(a, 2*lane + tail) ^ advance(b, lane + tail) ^
  //          crc(c seeded 0 over partC+tail).  Advances are O(log n)
  //          zero-run vector folds — race-free, cache-free, and cheap
  //          against >=768-byte lanes.
  c32 = crc32c_hw_1way(c32, data + 3 * lane, tail);
  a32 = ceph_tpu_crc32c_zeros(a32, 2 * lane + tail);
  b32 = ceph_tpu_crc32c_zeros(b32, lane + tail);
  return a32 ^ b32 ^ c32;
}

static bool have_sse42() {
  static const bool ok = __builtin_cpu_supports("sse4.2");
  return ok;
}
#endif

uint32_t ceph_tpu_crc32c(uint32_t crc, const uint8_t *data, uint64_t len) {
  if (data == nullptr) return ceph_tpu_crc32c_zeros(crc, len);
#if defined(__x86_64__)
  if (have_sse42()) return crc32c_hw(crc, data, len);
#endif
  return crc32c_sw(crc, data, len);
}

}  // extern "C"

namespace {
struct CrcTablesInit {
  CrcTablesInit() {
    crc32c_init_tables();
    crc32c_init_zero_mats();
  }
};
CrcTablesInit crc_tables_init;
}  // namespace
