// AES-256-GCM for msgr2 secure mode.
//
// A copy of the JAX package's ceph_tpu/native/src/aesgcm.cc, so a port peer
// and a JAX peer seal and open the same secure frames.
//
// Reference parity: the reference encrypts secure-mode frames with
// AES-GCM through OpenSSL (the reference's src/msg/async/crypto_onwire.cc
// AES128GCM_OnWireTxHandler).  This is an independent implementation of
// the published algorithms (FIPS-197 AES, NIST SP 800-38D GCM): a
// portable software path that runs anywhere, plus an AES-NI/PCLMULQDQ
// fast path compiled with per-function target attributes and selected
// at runtime (the build stays plain -O3, no -march flags).
//
// Contract (bound via ctypes in ceph_tpu_torch/native/__init__.py):
//   seal: out = ciphertext(ptlen) || tag(16), returns 0
//   open: ctlen INCLUDES the 16-byte tag; out = plaintext; returns 0,
//         or -1 on tag mismatch (out is zeroed — never release
//         unauthenticated plaintext)

#include <cstdint>
#include <cstring>

#if defined(__x86_64__) || defined(__i386__)
#define CEPH_TPU_X86 1
#include <immintrin.h>
#include <wmmintrin.h>
#endif

namespace {

// ---------------------------------------------------------------- AES core

static const uint8_t SBOX[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67,
    0x2b, 0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59,
    0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7,
    0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1,
    0x71, 0xd8, 0x31, 0x15, 0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05,
    0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83,
    0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29,
    0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b,
    0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf, 0xd0, 0xef, 0xaa,
    0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c,
    0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc,
    0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19,
    0x73, 0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee,
    0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49,
    0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4,
    0xea, 0x65, 0x7a, 0xae, 0x08, 0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6,
    0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a, 0x70,
    0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9,
    0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e,
    0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf, 0x8c, 0xa1,
    0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0,
    0x54, 0xbb, 0x16};

static const uint8_t RCON[15] = {0x00, 0x01, 0x02, 0x04, 0x08, 0x10,
                                 0x20, 0x40, 0x80, 0x1b, 0x36, 0x6c,
                                 0xd8, 0xab, 0x4d};

struct AesKey {
    // AES-256: 14 rounds, 15 round keys of 16 bytes
    uint8_t rk[15][16];
};

static void key_expand(const uint8_t key[32], AesKey* ks) {
    uint8_t w[60][4];  // Nb*(Nr+1) = 60 words
    memcpy(w, key, 32);
    for (int i = 8; i < 60; i++) {
        uint8_t t[4];
        memcpy(t, w[i - 1], 4);
        if (i % 8 == 0) {
            uint8_t tmp = t[0];  // RotWord
            t[0] = SBOX[t[1]] ^ RCON[i / 8];
            t[1] = SBOX[t[2]];
            t[2] = SBOX[t[3]];
            t[3] = SBOX[tmp];
        } else if (i % 8 == 4) {
            for (int j = 0; j < 4; j++) t[j] = SBOX[t[j]];
        }
        for (int j = 0; j < 4; j++) w[i][j] = w[i - 8][j] ^ t[j];
    }
    memcpy(ks->rk, w, 240);
}

static inline uint8_t xtime(uint8_t x) {
    return (uint8_t)((x << 1) ^ ((x >> 7) * 0x1b));
}

static void encrypt_block_soft(const AesKey* ks, const uint8_t in[16],
                               uint8_t out[16]) {
    uint8_t s[16];
    for (int i = 0; i < 16; i++) s[i] = in[i] ^ ks->rk[0][i];
    for (int round = 1; round <= 14; round++) {
        uint8_t t[16];
        // SubBytes + ShiftRows fused: t[c*4+r] = SBOX[s[((c+r)%4)*4+r]]
        for (int c = 0; c < 4; c++)
            for (int r = 0; r < 4; r++)
                t[c * 4 + r] = SBOX[s[((c + r) & 3) * 4 + r]];
        if (round < 14) {
            for (int c = 0; c < 4; c++) {  // MixColumns
                uint8_t* p = t + c * 4;
                uint8_t a0 = p[0], a1 = p[1], a2 = p[2], a3 = p[3];
                uint8_t x = a0 ^ a1 ^ a2 ^ a3;
                p[0] = a0 ^ x ^ xtime(a0 ^ a1);
                p[1] = a1 ^ x ^ xtime(a1 ^ a2);
                p[2] = a2 ^ x ^ xtime(a2 ^ a3);
                p[3] = a3 ^ x ^ xtime(a3 ^ a0);
            }
        }
        for (int i = 0; i < 16; i++) s[i] = t[i] ^ ks->rk[round][i];
    }
    memcpy(out, s, 16);
}

// ---------------------------------------------------------------- GHASH

// GF(2^128) multiply, right-shift formulation (SP 800-38D 6.3).
// Portable fallback; the PCLMUL path below replaces it on x86-64.
static void gf_mult_soft(const uint8_t X[16], const uint8_t Y[16],
                         uint8_t out[16]) {
    uint8_t Z[16] = {0};
    uint8_t V[16];
    memcpy(V, Y, 16);
    for (int i = 0; i < 128; i++) {
        if (X[i >> 3] & (0x80u >> (i & 7)))
            for (int j = 0; j < 16; j++) Z[j] ^= V[j];
        int lsb = V[15] & 1;
        for (int j = 15; j > 0; j--)
            V[j] = (uint8_t)((V[j] >> 1) | (V[j - 1] << 7));
        V[0] >>= 1;
        if (lsb) V[0] ^= 0xE1;
    }
    memcpy(out, Z, 16);
}

struct Ghash {
    uint8_t H[16];
    uint8_t Y[16];
    bool use_clmul;
};

#ifdef CEPH_TPU_X86
__attribute__((target("aes")))
static void key_expand_ni_store(const uint8_t key[32], AesKey* ks) {
    // AES-256 key schedule via AESKEYGENASSIST (FIPS-197 expansion on
    // 128-bit lanes; the standard two-lane assist pattern)
    __m128i k0 = _mm_loadu_si128((const __m128i*)key);
    __m128i k1 = _mm_loadu_si128((const __m128i*)(key + 16));
    __m128i* out = (__m128i*)ks->rk;
    _mm_storeu_si128(out + 0, k0);
    _mm_storeu_si128(out + 1, k1);
    auto assist1 = [](__m128i a, __m128i b) {  // i%8==0 step
        b = _mm_shuffle_epi32(b, 0xff);
        a = _mm_xor_si128(a, _mm_slli_si128(a, 4));
        a = _mm_xor_si128(a, _mm_slli_si128(a, 4));
        a = _mm_xor_si128(a, _mm_slli_si128(a, 4));
        return _mm_xor_si128(a, b);
    };
#define EXPAND_ROUND(idx, rc)                                           \
    {                                                                   \
        __m128i t = _mm_aeskeygenassist_si128(k1, rc);                  \
        k0 = assist1(k0, t);                                            \
        _mm_storeu_si128(out + idx, k0);                                \
        if (idx < 14) {                                                 \
            __m128i t2 = _mm_aeskeygenassist_si128(k0, 0);              \
            t2 = _mm_shuffle_epi32(t2, 0xaa);                           \
            k1 = _mm_xor_si128(k1, _mm_slli_si128(k1, 4));              \
            k1 = _mm_xor_si128(k1, _mm_slli_si128(k1, 4));              \
            k1 = _mm_xor_si128(k1, _mm_slli_si128(k1, 4));              \
            k1 = _mm_xor_si128(k1, t2);                                 \
            _mm_storeu_si128(out + idx + 1, k1);                        \
        }                                                               \
    }
    EXPAND_ROUND(2, 0x01)
    EXPAND_ROUND(4, 0x02)
    EXPAND_ROUND(6, 0x04)
    EXPAND_ROUND(8, 0x08)
    EXPAND_ROUND(10, 0x10)
    EXPAND_ROUND(12, 0x20)
    EXPAND_ROUND(14, 0x40)
#undef EXPAND_ROUND
}

__attribute__((target("aes")))
static void encrypt_block_ni(const AesKey* ks, const uint8_t in[16],
                             uint8_t out[16]) {
    const __m128i* rk = (const __m128i*)ks->rk;
    __m128i s = _mm_loadu_si128((const __m128i*)in);
    s = _mm_xor_si128(s, _mm_loadu_si128(rk));
    for (int r = 1; r < 14; r++)
        s = _mm_aesenc_si128(s, _mm_loadu_si128(rk + r));
    s = _mm_aesenclast_si128(s, _mm_loadu_si128(rk + 14));
    _mm_storeu_si128((__m128i*)out, s);
}

// CTR over 4 blocks per iteration: AESENC pipelines across
// independent lanes, which is where AES-NI's throughput lives
__attribute__((target("aes")))
static void ctr_xor_ni(const AesKey* ks, uint8_t ctr[16],
                       const uint8_t* in, uint8_t* out, uint64_t len) {
    const __m128i* rk = (const __m128i*)ks->rk;
    uint32_t c = ((uint32_t)ctr[12] << 24) | ((uint32_t)ctr[13] << 16) |
                 ((uint32_t)ctr[14] << 8) | ctr[15];
    uint64_t off = 0;
    while (off < len) {
        __m128i blk[4];
        int lanes = (len - off > 48) ? 4 : (int)((len - off + 15) / 16);
        for (int l = 0; l < lanes; l++) {
            uint8_t cb[16];
            memcpy(cb, ctr, 12);
            uint32_t cc = ++c;
            cb[12] = (uint8_t)(cc >> 24);
            cb[13] = (uint8_t)(cc >> 16);
            cb[14] = (uint8_t)(cc >> 8);
            cb[15] = (uint8_t)cc;
            blk[l] = _mm_xor_si128(_mm_loadu_si128((__m128i*)cb),
                                   _mm_loadu_si128(rk));
        }
        for (int r = 1; r < 14; r++) {
            __m128i k = _mm_loadu_si128(rk + r);
            for (int l = 0; l < lanes; l++)
                blk[l] = _mm_aesenc_si128(blk[l], k);
        }
        __m128i klast = _mm_loadu_si128(rk + 14);
        for (int l = 0; l < lanes; l++)
            blk[l] = _mm_aesenclast_si128(blk[l], klast);
        for (int l = 0; l < lanes && off < len; l++) {
            uint8_t kb[16];
            _mm_storeu_si128((__m128i*)kb, blk[l]);
            uint64_t n = len - off < 16 ? len - off : 16;
            for (uint64_t i = 0; i < n; i++)
                out[off + i] = (uint8_t)(in[off + i] ^ kb[i]);
            off += n;
        }
    }
    ctr[12] = (uint8_t)(c >> 24);
    ctr[13] = (uint8_t)(c >> 16);
    ctr[14] = (uint8_t)(c >> 8);
    ctr[15] = (uint8_t)c;
}

// GHASH multiply via carry-less multiply + the standard bit-reflected
// reduction (SP 800-38D poly, Gueron/Kounavis formulation)
__attribute__((target("pclmul,ssse3")))
static void gf_mult_clmul(const uint8_t X[16], const uint8_t Y[16],
                          uint8_t out[16]) {
    const __m128i BSWAP =
        _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                     15);
    __m128i a = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)X),
                                 BSWAP);
    __m128i b = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i*)Y),
                                 BSWAP);
    __m128i t0 = _mm_clmulepi64_si128(a, b, 0x00);
    __m128i t1 = _mm_clmulepi64_si128(a, b, 0x10);
    __m128i t2 = _mm_clmulepi64_si128(a, b, 0x01);
    __m128i t3 = _mm_clmulepi64_si128(a, b, 0x11);
    t1 = _mm_xor_si128(t1, t2);
    t2 = _mm_slli_si128(t1, 8);
    t1 = _mm_srli_si128(t1, 8);
    t0 = _mm_xor_si128(t0, t2);   // low 128
    t3 = _mm_xor_si128(t3, t1);   // high 128
    // bit-reflection handling: shift the 256-bit product left by one
    __m128i lo = t0, hi = t3;
    __m128i lo_l = _mm_slli_epi64(lo, 1);
    __m128i lo_r = _mm_srli_epi64(lo, 63);
    __m128i hi_l = _mm_slli_epi64(hi, 1);
    __m128i hi_r = _mm_srli_epi64(hi, 63);
    __m128i carry_lo = _mm_slli_si128(lo_r, 8);
    __m128i carry_hi = _mm_or_si128(_mm_slli_si128(hi_r, 8),
                                    _mm_srli_si128(lo_r, 8));
    lo = _mm_or_si128(lo_l, carry_lo);
    hi = _mm_or_si128(hi_l, carry_hi);
    // reduce modulo x^128 + x^7 + x^2 + x + 1
    __m128i t7 = _mm_slli_epi64(lo, 57);
    __m128i t8 = _mm_slli_epi64(lo, 62);
    __m128i t9 = _mm_slli_epi64(lo, 63);
    __m128i tmp = _mm_xor_si128(t7, _mm_xor_si128(t8, t9));
    __m128i tl = _mm_slli_si128(tmp, 8);
    __m128i th = _mm_srli_si128(tmp, 8);
    lo = _mm_xor_si128(lo, tl);
    __m128i r1 = _mm_srli_epi64(lo, 1);
    __m128i r2 = _mm_srli_epi64(lo, 2);
    __m128i r7 = _mm_srli_epi64(lo, 7);
    __m128i red = _mm_xor_si128(r1, _mm_xor_si128(r2, r7));
    red = _mm_xor_si128(red, th);
    hi = _mm_xor_si128(hi, _mm_xor_si128(lo, red));
    _mm_storeu_si128((__m128i*)out, _mm_shuffle_epi8(hi, BSWAP));
}

static bool cpu_has_aes() {
    return __builtin_cpu_supports("aes") &&
           __builtin_cpu_supports("pclmul") &&
           __builtin_cpu_supports("ssse3");
}
#else
static bool cpu_has_aes() { return false; }
#endif

static void ghash_update(Ghash* g, const uint8_t* data, uint64_t len) {
    uint8_t blk[16];
    for (uint64_t off = 0; off < len; off += 16) {
        uint64_t n = len - off < 16 ? len - off : 16;
        memset(blk, 0, 16);
        memcpy(blk, data + off, n);
        for (int i = 0; i < 16; i++) g->Y[i] ^= blk[i];
#ifdef CEPH_TPU_X86
        if (g->use_clmul) {
            gf_mult_clmul(g->Y, g->H, g->Y);
            continue;
        }
#endif
        gf_mult_soft(g->Y, g->H, g->Y);
    }
}

static void ctr_xor_soft(const AesKey* ks, uint8_t ctr[16],
                         const uint8_t* in, uint8_t* out,
                         uint64_t len) {
    uint8_t kb[16];
    for (uint64_t off = 0; off < len; off += 16) {
        // increment the 32-bit big-endian counter (inc32)
        for (int i = 15; i >= 12; i--)
            if (++ctr[i]) break;
        encrypt_block_soft(ks, ctr, kb);
        uint64_t n = len - off < 16 ? len - off : 16;
        for (uint64_t i = 0; i < n; i++)
            out[off + i] = (uint8_t)(in[off + i] ^ kb[i]);
    }
}

static void gcm_crypt(const uint8_t* key, const uint8_t iv[12],
                      const uint8_t* aad, uint64_t aadlen,
                      const uint8_t* in, uint64_t len, uint8_t* out,
                      uint8_t tag[16], bool ghash_over_out) {
    AesKey ks;
    bool ni = cpu_has_aes();
#ifdef CEPH_TPU_X86
    if (ni)
        key_expand_ni_store(key, &ks);
    else
#endif
        key_expand(key, &ks);

    Ghash g;
    g.use_clmul = ni;
    memset(g.Y, 0, 16);
    uint8_t zero[16] = {0};
#ifdef CEPH_TPU_X86
    if (ni)
        encrypt_block_ni(&ks, zero, g.H);
    else
#endif
        encrypt_block_soft(&ks, zero, g.H);

    uint8_t j0[16];
    memcpy(j0, iv, 12);
    j0[12] = j0[13] = j0[14] = 0;
    j0[15] = 1;

    uint8_t ctr[16];
    memcpy(ctr, j0, 16);
#ifdef CEPH_TPU_X86
    if (ni)
        ctr_xor_ni(&ks, ctr, in, out, len);
    else
#endif
        ctr_xor_soft(&ks, ctr, in, out, len);

    ghash_update(&g, aad, aadlen);
    ghash_update(&g, ghash_over_out ? out : in, len);
    uint8_t lens[16];
    uint64_t ab = aadlen * 8, cb = len * 8;
    for (int i = 0; i < 8; i++) {
        lens[i] = (uint8_t)(ab >> (56 - 8 * i));
        lens[8 + i] = (uint8_t)(cb >> (56 - 8 * i));
    }
    ghash_update(&g, lens, 16);

    uint8_t ek0[16];
#ifdef CEPH_TPU_X86
    if (ni)
        encrypt_block_ni(&ks, j0, ek0);
    else
#endif
        encrypt_block_soft(&ks, j0, ek0);
    for (int i = 0; i < 16; i++) tag[i] = (uint8_t)(g.Y[i] ^ ek0[i]);
}

}  // namespace

extern "C" {

int ceph_tpu_aesgcm_seal(const uint8_t* key, const uint8_t* iv12,
                         const uint8_t* aad, uint64_t aadlen,
                         const uint8_t* pt, uint64_t ptlen,
                         uint8_t* out) {
    gcm_crypt(key, iv12, aad, aadlen, pt, ptlen, out, out + ptlen,
              /*ghash_over_out=*/true);
    return 0;
}

int ceph_tpu_aesgcm_open(const uint8_t* key, const uint8_t* iv12,
                         const uint8_t* aad, uint64_t aadlen,
                         const uint8_t* ct, uint64_t ctlen,
                         uint8_t* out) {
    if (ctlen < 16) return -1;
    uint64_t len = ctlen - 16;
    uint8_t tag[16];
    gcm_crypt(key, iv12, aad, aadlen, ct, len, out, tag,
              /*ghash_over_out=*/false);
    uint8_t diff = 0;  // constant-time tag compare
    for (int i = 0; i < 16; i++) diff |= (uint8_t)(tag[i] ^ ct[len + i]);
    if (diff) {
        memset(out, 0, len);
        return -1;
    }
    return 0;
}

}  // extern "C"
