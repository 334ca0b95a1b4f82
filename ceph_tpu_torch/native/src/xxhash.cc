// xxHash32 and xxHash64 (from the public spec; seedable) for the port's host
// checksums: the Checksummer's xxhash32 / xxhash64 csum types.  A copy of the
// xxhash functions of the JAX package's ceph_tpu/native/src/checksum.cc
// (ceph_tpu_xxh32, ceph_tpu_xxh64 and their *_blocks loops), so both packages
// write the same csum bytes.
//
// Build: g++ -O3 -shared -fPIC (driven by ceph_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// xxHash32 / xxHash64 (from the public spec; seedable)
// ---------------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}
static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}
static inline uint32_t read32(const uint8_t *p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
static inline uint64_t read64(const uint8_t *p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

static const uint32_t P32_1 = 2654435761u, P32_2 = 2246822519u,
                      P32_3 = 3266489917u, P32_4 = 668265263u,
                      P32_5 = 374761393u;

uint32_t ceph_tpu_xxh32(const uint8_t *data, uint64_t len, uint32_t seed) {
  const uint8_t *p = data, *end = data + len;
  uint32_t h;
  if (len >= 16) {
    uint32_t v1 = seed + P32_1 + P32_2, v2 = seed + P32_2, v3 = seed,
             v4 = seed - P32_1;
    const uint8_t *limit = end - 16;
    do {
      v1 = rotl32(v1 + read32(p) * P32_2, 13) * P32_1; p += 4;
      v2 = rotl32(v2 + read32(p) * P32_2, 13) * P32_1; p += 4;
      v3 = rotl32(v3 + read32(p) * P32_2, 13) * P32_1; p += 4;
      v4 = rotl32(v4 + read32(p) * P32_2, 13) * P32_1; p += 4;
    } while (p <= limit);
    h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h = seed + P32_5;
  }
  h += (uint32_t)len;
  while (p + 4 <= end) {
    h = rotl32(h + read32(p) * P32_3, 17) * P32_4;
    p += 4;
  }
  while (p < end) {
    h = rotl32(h + (*p) * P32_5, 11) * P32_1;
    p++;
  }
  h ^= h >> 15; h *= P32_2; h ^= h >> 13; h *= P32_3; h ^= h >> 16;
  return h;
}

static const uint64_t P64_1 = 11400714785074694791ull,
                      P64_2 = 14029467366897019727ull,
                      P64_3 = 1609587929392839161ull,
                      P64_4 = 9650029242287828579ull,
                      P64_5 = 2870177450012600261ull;

static inline uint64_t xxh64_round(uint64_t acc, uint64_t input) {
  return rotl64(acc + input * P64_2, 31) * P64_1;
}
static inline uint64_t xxh64_merge(uint64_t h, uint64_t v) {
  h ^= xxh64_round(0, v);
  return h * P64_1 + P64_4;
}

uint64_t ceph_tpu_xxh64(const uint8_t *data, uint64_t len, uint64_t seed) {
  const uint8_t *p = data, *end = data + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P64_1 + P64_2, v2 = seed + P64_2, v3 = seed,
             v4 = seed - P64_1;
    const uint8_t *limit = end - 32;
    do {
      v1 = xxh64_round(v1, read64(p)); p += 8;
      v2 = xxh64_round(v2, read64(p)); p += 8;
      v3 = xxh64_round(v3, read64(p)); p += 8;
      v4 = xxh64_round(v4, read64(p)); p += 8;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh64_merge(h, v1);
    h = xxh64_merge(h, v2);
    h = xxh64_merge(h, v3);
    h = xxh64_merge(h, v4);
  } else {
    h = seed + P64_5;
  }
  h += len;
  while (p + 8 <= end) {
    h ^= xxh64_round(0, read64(p));
    h = rotl64(h, 27) * P64_1 + P64_4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)read32(p) * P64_1;
    h = rotl64(h, 23) * P64_2 + P64_3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P64_5;
    h = rotl64(h, 11) * P64_1;
    p++;
  }
  h ^= h >> 33; h *= P64_2; h ^= h >> 29; h *= P64_3; h ^= h >> 32;
  return h;
}

void ceph_tpu_xxh32_blocks(const uint8_t *data, uint64_t nblocks,
                           uint64_t block_size, uint32_t seed, uint32_t *out) {
  for (uint64_t i = 0; i < nblocks; i++)
    out[i] = ceph_tpu_xxh32(data + i * block_size, block_size, seed);
}

void ceph_tpu_xxh64_blocks(const uint8_t *data, uint64_t nblocks,
                           uint64_t block_size, uint64_t seed, uint64_t *out) {
  for (uint64_t i = 0; i < nblocks; i++)
    out[i] = ceph_tpu_xxh64(data + i * block_size, block_size, seed);
}

}  // extern "C"
