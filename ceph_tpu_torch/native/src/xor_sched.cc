// Host executor for compiled XOR schedules (ceph_tpu_torch/ec/xsched.py):
// a copy of the JAX package's ceph_tpu/native/src/xor_sched.cc, so both
// packages run the same tape the same way.
//
// Below ~2 KiB regions a per-op numpy executor is bound by one dispatch
// per XOR, not by XOR work.  Here ec/xsched.py lowers a schedule once into
// a flat int32 op tape over a uniform region arena, and the entire
// program — every temp, every output row, for N packed objects — runs in
// a single Python->native transition with word-wide unrolled XOR loops.
// This is the tape of the `device="cpu"` bitmatrix codecs; on a CUDA card
// the same tape runs in csrc/xor_sched.cu.
//
// Region arena: (n_objects, n_regions, region_bytes) contiguous
// uint8.  Per object the region index space is the schedule's:
// [0, n_in) input columns, [n_in, n_in+n_slots) reusable temp slots,
// [n_in+n_slots, n_regions) output rows.  The same tape replays for
// every object (cross-OBJECT batching: thousands of 4 KiB objects
// are one call).
//
// Op encoding — int32 triples (dst, a, b):
//   b >= 0           region[dst] = region[a] ^ region[b]
//   b == -1, a >= 0  region[dst] = region[a]              (copy)
//   b == -2          region[dst] ^= region[a]             (accumulate)
//   a == -1          region[dst] = 0                      (zero fill)
//
// Aliasing: dst may equal a or b EXACTLY (the slot-donation trick the
// scheduler's linear-scan allocator uses); the loops read and write
// element-wise forward, which is well-defined for exact aliasing.
//
// Build: g++ -O3 -shared -fPIC (driven by ceph_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>

extern "C" {

// from crc32c.cc
uint32_t ceph_tpu_crc32c(uint32_t crc, const uint8_t *data, uint64_t len);

}  // extern "C"

namespace {

inline void xor2(uint8_t *d, const uint8_t *a, const uint8_t *b,
                 uint64_t n) {
    uint64_t i = 0;
    for (; i + 32 <= n; i += 32) {
        uint64_t a0, a1, a2, a3, b0, b1, b2, b3;
        std::memcpy(&a0, a + i, 8);
        std::memcpy(&a1, a + i + 8, 8);
        std::memcpy(&a2, a + i + 16, 8);
        std::memcpy(&a3, a + i + 24, 8);
        std::memcpy(&b0, b + i, 8);
        std::memcpy(&b1, b + i + 8, 8);
        std::memcpy(&b2, b + i + 16, 8);
        std::memcpy(&b3, b + i + 24, 8);
        a0 ^= b0; a1 ^= b1; a2 ^= b2; a3 ^= b3;
        std::memcpy(d + i, &a0, 8);
        std::memcpy(d + i + 8, &a1, 8);
        std::memcpy(d + i + 16, &a2, 8);
        std::memcpy(d + i + 24, &a3, 8);
    }
    for (; i + 8 <= n; i += 8) {
        uint64_t x, y;
        std::memcpy(&x, a + i, 8);
        std::memcpy(&y, b + i, 8);
        x ^= y;
        std::memcpy(d + i, &x, 8);
    }
    for (; i < n; ++i) d[i] = a[i] ^ b[i];
}

inline void xacc(uint8_t *d, const uint8_t *a, uint64_t n) {
    xor2(d, d, a, n);
}

}  // namespace

extern "C" {

// Run the whole op tape over every object of the arena: ONE call per
// batch, zero per-XOR dispatch cost.  `tape` is (n_ops, 3) int32 in
// the encoding above; `arena` is (n_objects, n_regions, rbytes)
// contiguous.  Refs are validated by the Python lowering (the tape is
// memoized next to the schedule it was lowered from), not re-checked
// per op here.
void ceph_tpu_xsched_exec(const int32_t *tape, uint64_t n_ops,
                          uint8_t *arena, uint64_t n_regions,
                          uint64_t rbytes, uint64_t n_objects) {
    for (uint64_t o = 0; o < n_objects; ++o) {
        uint8_t *base = arena + o * n_regions * rbytes;
        const int32_t *op = tape;
        for (uint64_t t = 0; t < n_ops; ++t, op += 3) {
            const int32_t dst = op[0], a = op[1], b = op[2];
            uint8_t *d = base + (uint64_t)dst * rbytes;
            if (b >= 0) {
                xor2(d, base + (uint64_t)a * rbytes,
                     base + (uint64_t)b * rbytes, rbytes);
            } else if (b == -2) {
                xacc(d, base + (uint64_t)a * rbytes, rbytes);
            } else if (a >= 0) {
                if (d != base + (uint64_t)a * rbytes)
                    std::memcpy(d, base + (uint64_t)a * rbytes,
                                rbytes);
            } else {
                std::memset(d, 0, rbytes);
            }
        }
    }
}

// Per-shard cumulative crc32c over contiguous region spans of the
// SAME arena the tape just ran over — the HashInfo ledger of a packed
// multi-object encode batch without one Python crc call per shard per
// stripe.  `spans` is (n_spans, 3) int32 rows (region_start, count,
// crc_slot), region_start indexed over the FLAT arena (object-major,
// exactly how the packer laid regions out); each span folds
// count*rbytes bytes into crcs[crc_slot] in order, so multi-stripe
// shards accumulate stripe by stripe like HashInfo::append.
void ceph_tpu_xsched_crc_spans(const uint8_t *arena, uint64_t rbytes,
                               const int32_t *spans, uint64_t n_spans,
                               uint32_t *crcs) {
    const int32_t *s = spans;
    for (uint64_t i = 0; i < n_spans; ++i, s += 3) {
        const uint64_t start = (uint64_t)s[0];
        const uint64_t len = (uint64_t)s[1] * rbytes;
        crcs[s[2]] = ceph_tpu_crc32c(crcs[s[2]],
                                     arena + start * rbytes, len);
    }
}

}  // extern "C"
