// Host-side block compression codecs for ceph_tpu_torch.
//
// Capability parity with the reference's compressor plugins
// (the reference's src/compressor/{lz4,snappy}/): the reference links
// liblz4/libsnappy; this build has neither, so both block formats are
// implemented here from their public format specifications.  The framing
// above (compression_header, required-ratio gate) lives in Python
// (ceph_tpu_torch/compressor); these are the raw block codecs.  A copy of
// the JAX package's ceph_tpu/native/src/compress.cc: the compressed bytes
// of the two packages are the same.
//
//   - LZ4 block format: token (4b literal len | 4b match len-4), 255-run
//     length extensions, 2-byte LE match offset, last-5-bytes-literal and
//     12-byte end-of-match rules per the spec.
//   - Snappy format: varint uncompressed length, then tagged elements
//     (literal / copy with 1, 2 or 4 byte offsets).
//
// Both compressors are greedy hash-table matchers tuned for throughput,
// not ratio records; both decompressors bounds-check untrusted input and
// return -1 on corruption.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

static inline uint32_t read32(const uint8_t *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

static inline uint16_t read16(const uint8_t *p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}

static inline void write16(uint8_t *p, uint16_t v) { memcpy(p, &v, 2); }

// Fibonacci-style multiplicative hash of a 4-byte window.
static inline uint32_t hash4(uint32_t v, int bits) {
  return (v * 2654435761u) >> (32 - bits);
}

// Length of the common prefix of a and b, at most limit.
static inline uint64_t match_length(const uint8_t *a, const uint8_t *b,
                                    uint64_t limit) {
  uint64_t n = 0;
  while (n + 8 <= limit) {
    uint64_t x, y;
    memcpy(&x, a + n, 8);
    memcpy(&y, b + n, 8);
    if (x != y) {
      return n + (__builtin_ctzll(x ^ y) >> 3);
    }
    n += 8;
  }
  while (n < limit && a[n] == b[n]) n++;
  return n;
}

// ---------------------------------------------------------------------------
// LZ4 block format
// ---------------------------------------------------------------------------

static const int LZ4_HASH_BITS = 16;
static const uint64_t LZ4_MFLIMIT = 12;      // last match must start before n-12
static const uint64_t LZ4_LASTLITERALS = 5;  // final 5 bytes are always literals
static const uint32_t LZ4_MAX_OFFSET = 65535;

uint64_t ceph_tpu_lz4_compress_bound(uint64_t n) {
  return n + n / 255 + 16;
}

// Returns compressed size, or -1 if dst_cap is too small.
int64_t ceph_tpu_lz4_compress(const uint8_t *src, uint64_t n, uint8_t *dst,
                              uint64_t dst_cap) {
  uint8_t *op = dst;
  uint8_t *oend = dst + dst_cap;
  uint32_t table[1u << LZ4_HASH_BITS];
  memset(table, 0xff, sizeof(table));

  uint64_t anchor = 0, pos = 0;
  const uint64_t mflimit = n > LZ4_MFLIMIT ? n - LZ4_MFLIMIT : 0;
  const uint64_t matchlimit = n > LZ4_LASTLITERALS ? n - LZ4_LASTLITERALS : 0;

  auto emit = [&](uint64_t lit_start, uint64_t lit_len, uint32_t offset,
                  uint64_t mlen) -> bool {
    // worst-case bytes for this sequence
    uint64_t need = 1 + lit_len / 255 + 1 + lit_len + 2 + mlen / 255 + 1;
    if (op + need > oend) return false;
    uint8_t *token = op++;
    uint64_t ll = lit_len;
    if (ll >= 15) {
      *token = 15 << 4;
      ll -= 15;
      while (ll >= 255) { *op++ = 255; ll -= 255; }
      *op++ = (uint8_t)ll;
    } else {
      *token = (uint8_t)(ll << 4);
    }
    memcpy(op, src + lit_start, lit_len);
    op += lit_len;
    if (mlen == 0) return true;  // final literal-only sequence
    write16(op, (uint16_t)offset);
    op += 2;
    uint64_t ml = mlen - 4;
    if (ml >= 15) {
      *token |= 15;
      ml -= 15;
      while (ml >= 255) { *op++ = 255; ml -= 255; }
      *op++ = (uint8_t)ml;
    } else {
      *token |= (uint8_t)ml;
    }
    return true;
  };

  if (n >= LZ4_MFLIMIT + 1) {
    while (pos < mflimit) {
      uint32_t seq = read32(src + pos);
      uint32_t h = hash4(seq, LZ4_HASH_BITS);
      uint32_t ref = table[h];
      table[h] = (uint32_t)pos;
      if (ref != 0xffffffffu && pos - ref <= LZ4_MAX_OFFSET &&
          read32(src + ref) == seq) {
        uint64_t mlen =
            4 + match_length(src + ref + 4, src + pos + 4, matchlimit - (pos + 4));
        if (!emit(anchor, pos - anchor, (uint32_t)(pos - ref), mlen)) return -1;
        pos += mlen;
        anchor = pos;
      } else {
        pos++;
      }
    }
  }
  if (!emit(anchor, n - anchor, 0, 0)) return -1;
  return op - dst;
}

// Returns decompressed size, or -1 on malformed input / undersized dst.
int64_t ceph_tpu_lz4_decompress(const uint8_t *src, uint64_t n, uint8_t *dst,
                                uint64_t dst_cap) {
  const uint8_t *ip = src, *iend = src + n;
  uint8_t *op = dst, *oend = dst + dst_cap;

  while (ip < iend) {
    uint8_t token = *ip++;
    uint64_t ll = token >> 4;
    if (ll == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        ll += b;
      } while (b == 255);
    }
    if (ip + ll > iend || op + ll > oend) return -1;
    memcpy(op, ip, ll);
    ip += ll;
    op += ll;
    if (ip == iend) break;  // last sequence has no match
    if (ip + 2 > iend) return -1;
    uint32_t offset = read16(ip);
    ip += 2;
    if (offset == 0 || (uint64_t)(op - dst) < offset) return -1;
    uint64_t ml = (token & 15);
    if (ml == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        ml += b;
      } while (b == 255);
    }
    ml += 4;
    if (op + ml > oend) return -1;
    const uint8_t *match = op - offset;
    if (offset >= 8) {
      // non-overlapping enough for 8-byte strides
      uint64_t i = 0;
      for (; i + 8 <= ml; i += 8) memcpy(op + i, match + i, 8);
      for (; i < ml; i++) op[i] = match[i];
    } else {
      for (uint64_t i = 0; i < ml; i++) op[i] = match[i];
    }
    op += ml;
  }
  return op - dst;
}

// ---------------------------------------------------------------------------
// Snappy format
// ---------------------------------------------------------------------------

static const int SNAPPY_HASH_BITS = 14;

uint64_t ceph_tpu_snappy_compress_bound(uint64_t n) {
  return 32 + n + n / 6;
}

static inline uint8_t *snappy_emit_literal(uint8_t *op, const uint8_t *lit,
                                           uint64_t len) {
  uint64_t l = len - 1;
  if (l < 60) {
    *op++ = (uint8_t)(l << 2);
  } else {
    int count = 0;
    uint64_t tmp = l;
    while (tmp > 0) { count++; tmp >>= 8; }
    *op++ = (uint8_t)((59 + count) << 2);
    for (int i = 0; i < count; i++) *op++ = (uint8_t)(l >> (8 * i));
  }
  memcpy(op, lit, len);
  return op + len;
}

// One copy element, length 4..64, offset < 65536.
static inline uint8_t *snappy_emit_copy_chunk(uint8_t *op, uint32_t offset,
                                              uint64_t len) {
  if (len < 12 && offset < 2048) {
    *op++ = (uint8_t)(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
    *op++ = (uint8_t)offset;
  } else {
    *op++ = (uint8_t)(2 | ((len - 1) << 2));
    write16(op, (uint16_t)offset);
    op += 2;
  }
  return op;
}

static inline uint8_t *snappy_emit_copy(uint8_t *op, uint32_t offset,
                                        uint64_t len) {
  while (len >= 68) {
    op = snappy_emit_copy_chunk(op, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    op = snappy_emit_copy_chunk(op, offset, 60);
    len -= 60;
  }
  return snappy_emit_copy_chunk(op, offset, len);
}

int64_t ceph_tpu_snappy_compress(const uint8_t *src, uint64_t n, uint8_t *dst,
                                 uint64_t dst_cap) {
  if (n >= (1ull << 32)) return -1;  // snappy length fields are 32-bit
  if (dst_cap < ceph_tpu_snappy_compress_bound(n)) return -1;
  uint8_t *op = dst;
  // varint uncompressed length
  uint64_t v = n;
  while (v >= 0x80) {
    *op++ = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  *op++ = (uint8_t)v;

  uint32_t table[1u << SNAPPY_HASH_BITS];
  memset(table, 0xff, sizeof(table));

  uint64_t anchor = 0, pos = 0;
  const uint64_t limit = n > 15 ? n - 15 : 0;  // keep 4-byte reads in bounds
  while (pos < limit) {
    uint32_t seq = read32(src + pos);
    uint32_t h = hash4(seq, SNAPPY_HASH_BITS);
    uint32_t ref = table[h];
    table[h] = (uint32_t)pos;
    if (ref != 0xffffffffu && pos - ref <= 65535 && read32(src + ref) == seq) {
      uint64_t mlen = 4 + match_length(src + ref + 4, src + pos + 4, n - pos - 4);
      if (pos > anchor) op = snappy_emit_literal(op, src + anchor, pos - anchor);
      op = snappy_emit_copy(op, (uint32_t)(pos - ref), mlen);
      pos += mlen;
      anchor = pos;
    } else {
      pos++;
    }
  }
  if (n > anchor) op = snappy_emit_literal(op, src + anchor, n - anchor);
  return op - dst;
}

// Parses the varint length header; returns it, or -1 if malformed.
int64_t ceph_tpu_snappy_uncompressed_length(const uint8_t *src, uint64_t n) {
  uint64_t v = 0;
  int shift = 0;
  for (uint64_t i = 0; i < n && shift < 35; i++) {
    v |= (uint64_t)(src[i] & 0x7f) << shift;
    if (!(src[i] & 0x80)) return (int64_t)v;
    shift += 7;
  }
  return -1;
}

int64_t ceph_tpu_snappy_decompress(const uint8_t *src, uint64_t n, uint8_t *dst,
                                   uint64_t dst_cap) {
  // skip varint header
  uint64_t hdr = 0;
  while (hdr < n && (src[hdr] & 0x80)) hdr++;
  if (hdr >= n) return -1;
  hdr++;
  int64_t want = ceph_tpu_snappy_uncompressed_length(src, n);
  if (want < 0 || (uint64_t)want > dst_cap) return -1;

  const uint8_t *ip = src + hdr, *iend = src + n;
  uint8_t *op = dst, *oend = dst + dst_cap;
  while (ip < iend) {
    uint8_t tag = *ip++;
    uint32_t kind = tag & 3;
    if (kind == 0) {  // literal
      uint64_t len = (tag >> 2) + 1;
      if (len > 60) {
        int count = (int)len - 60;
        if (ip + count > iend) return -1;
        len = 0;
        for (int i = 0; i < count; i++) len |= (uint64_t)ip[i] << (8 * i);
        len += 1;
        ip += count;
      }
      if (ip + len > iend || op + len > oend) return -1;
      memcpy(op, ip, len);
      ip += len;
      op += len;
    } else {
      uint64_t len;
      uint32_t offset;
      if (kind == 1) {
        if (ip >= iend) return -1;
        len = ((tag >> 2) & 7) + 4;
        offset = ((uint32_t)(tag >> 5) << 8) | *ip++;
      } else if (kind == 2) {
        if (ip + 2 > iend) return -1;
        len = (tag >> 2) + 1;
        offset = read16(ip);
        ip += 2;
      } else {
        if (ip + 4 > iend) return -1;
        len = (tag >> 2) + 1;
        offset = read32(ip);
        ip += 4;
      }
      if (offset == 0 || (uint64_t)(op - dst) < offset || op + len > oend)
        return -1;
      const uint8_t *match = op - offset;
      for (uint64_t i = 0; i < len; i++) op[i] = match[i];
      op += len;
    }
  }
  return (op - dst) == want ? want : -1;
}

}  // extern "C"
