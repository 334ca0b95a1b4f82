"""The hit-set kernels' own code (csrc/hitset_bloom.cu), run on the CPU
through its g++ emulation (ceph_tpu_torch/tools/bloom_emulate.py), against
the numpy bloom_positions and BloomHitSet.insert_batch of the JAX package.

bloom_positions: chip_smoke.py phase 3g's cases, B in {8, 37, 1024, 65536,
65536 + 17}, nhash in {1, 4, 7, 32} and nbits in {8, 6236, 1048573,
2^31 - 1}; then the magic reciprocal's edges (nbits 1, 2, 3, powers of two
and their neighbours, 2^32 - 1) against Python's integers, on dividends
that cross every power of two, and the grid-stride loop on a batch larger
than one launch's threads.  Every position is held bit for bit.

bloom_seal: each row's bytes against the bits the JAX BloomHitSet's
insert_batch sets in an empty set, byte for byte, trailing bits zero, with
a block's threads run in rising and in falling order between barriers:
empty sets, 1, 7 and 8 hashes, sets past a block's 256 threads and past a
block's 512-hash chunk (several blocks a set), duplicate hashes, S = 1 and
S = 128, nbits 8, 6,236, 6,385 (the tier's default geometry), 1,048,573
and one past the shared-memory budget (the global-memory path), nhash 1, 4
and 32.  Then copies of the kernel with a barrier or the bitset's zeroing
cut out must give wrong rows.
"""

import numpy as np
import pytest

from ceph_tpu.osd import hitset as jhs
from ceph_tpu_torch.ops import rjenkins
from ceph_tpu_torch.osd import hitset as hs
from ceph_tpu_torch.tools import bloom_emulate

SEED = 20261017
BATCHES = (8, 37, 1024, 65536, 65536 + 17)
NHASH = (1, 4, 7, 32)
NBITS = (8, 6236, 1048573, (1 << 31) - 1)


def _hashes(n: int, seed: int) -> np.ndarray:
    h = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint64)
    h = h.astype(np.uint32)
    h[:3] = (0, 0xFFFFFFFF, 0x80000000)[:n]
    return h


@pytest.mark.parametrize("batch", BATCHES)
def test_kernel_equals_numpy_on_phase_3g_cases(batch):
    jobs = [(_hashes(batch, SEED + batch + nhash), nbits, nhash)
            for nhash in NHASH for nbits in NBITS]
    for (h, nbits, nhash), (got, _info) in zip(
            jobs, bloom_emulate.emulate_many(jobs)):
        want = hs.bloom_positions(h, nbits, nhash)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, jhs.bloom_positions(h, nbits, nhash, xp=np))


def _divisors() -> list:
    out = {1, 2, 3, 5, 7, 641, 6700417, (1 << 32) - 1}
    for k in range(1, 32):
        out.update({(1 << k) - 1, 1 << k, (1 << k) + 1})
    return sorted(d for d in out if 1 <= d < 1 << 32)


def test_magic_reciprocal_remainder_is_exact_for_every_divisor():
    """The remainder through (m, sh1, sh2) against Python's `%` of the same
    hash32_2 values, for divisors at and around every power of two and
    2^32 - 1; the dividends are the hashes, so any value can occur."""
    h = _hashes(4096, SEED)
    jobs = [(h, d, 2) for d in _divisors()]
    hashed = [[rjenkins.hash32_2_int(int(x), s) for s in range(2)]
              for x in h]
    for (_h, d, _n), (got, info) in zip(jobs,
                                        bloom_emulate.emulate_many(jobs)):
        assert 0 < info["m"] < 1 << 32 or d == 1
        want = np.array([[v % d for v in row] for row in hashed],
                        dtype=np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f"nbits {d}")


def test_grid_stride_covers_a_batch_past_one_launch():
    """More hashes than the launch's blocks x threads: each thread takes
    several, and every position is still written once and right."""
    batch = 132 * 16 * 256 + 1000
    h = _hashes(batch, SEED + 1)
    (got, info), = bloom_emulate.emulate_many([(h, 9586, 7)])
    assert info["blocks"] == 132 * 16
    np.testing.assert_array_equal(got, hs.bloom_positions(h, 9586, 7))


# the seal's shared bitset holds BLOOM_SEAL_SMEM_WORDS (227 KB / 4) words
SHARED_WORDS = 232448 // 4
SEAL_NBITS = (8, 6236, 6385, 1048573, SHARED_WORDS * 32 + 1)
SEAL_NHASH = (1, 4, 32)
ORDERS = ("rising", "falling")


def _seal_sets(seed: int, sizes) -> list:
    rng = np.random.default_rng(seed)
    sets = [_hashes(n, int(rng.integers(1 << 30))) for n in sizes]
    # duplicates: five hashes, each many times over
    sets.append(np.repeat(_hashes(5, seed + 1), 13))
    return sets


def _jax_bits(hashes, nbits: int, nhash: int) -> np.ndarray:
    ref = jhs.BloomHitSet(nbits=nbits, nhash=nhash)
    ref.insert_batch(hashes, device=False)
    return ref.bits


def _assert_rows(rows, sets, nbits: int, nhash: int) -> None:
    nbytes = (nbits + 7) // 8
    assert rows.shape == (len(sets), (nbits + 31) // 32)
    for i, (row, h) in enumerate(zip(rows, sets)):
        got = row.view(np.uint8)
        np.testing.assert_array_equal(got[:nbytes], _jax_bits(h, nbits,
                                                              nhash),
                                      err_msg=f"set {i} of {len(h)} hashes")
        assert not got[nbytes:].any()
        assert not (nbits % 8 and got[nbytes - 1] >> (nbits % 8))


@pytest.mark.parametrize("nhash", SEAL_NHASH)
@pytest.mark.parametrize("nbits", SEAL_NBITS)
def test_seal_equals_jax_insert_batch(nbits, nhash):
    """One launch over 128 sets (the tier's wave: sizes 0 to 40, and 0, 1,
    7, 8, 300 and duplicates), one over a single set of 8, one whose
    1,100-hash set takes three blocks, each in both thread orders."""
    wave = _seal_sets(SEED + nbits + nhash, [0, 1, 7, 8, 300] + list(
        np.random.default_rng(nbits).integers(0, 41, 122)))
    assert len(wave) == 128
    one = [_hashes(8, SEED + 3)]
    chunked = _seal_sets(SEED + 4, [1100, 7])
    jobs = [(sets, nbits, nhash, order) for sets in (wave, one, chunked)
            for order in ORDERS]
    shared = nbits <= SHARED_WORDS * 32
    for (sets, _nb, _nh, order), (rows, info) in zip(
            jobs, bloom_emulate.emulate_seals(jobs)):
        _assert_rows(rows, sets, nbits, nhash)
        assert info["shared"] == shared
        assert info["chunks"] == (3 if sets is chunked else 1)
        assert info["zeroed"] == (not shared or sets is chunked)
        assert info["smem"] == (4 * ((nbits + 31) // 32) if shared else 0)


# (text of csrc/hitset_bloom.cu, replacement): each cut must give wrong rows
SEAL_MUTATIONS = {
    "no barrier after zeroing": (
        "      bloom_seal_bits[w] = 0;\n    __syncthreads();\n",
        "      bloom_seal_bits[w] = 0;\n"),
    "no barrier before the write-out": (
        "  if (!shared) return;\n  __syncthreads();\n",
        "  if (!shared) return;\n"),
    "bitset not zeroed": (
        "      bloom_seal_bits[w] = 0;\n", "      (void)w;\n"),
}


@pytest.mark.parametrize("mutation", list(SEAL_MUTATIONS))
def test_seal_mutations_are_caught(mutation, tmp_path):
    """A copy of the device code with a barrier or the zeroing cut out,
    built outside the checkout, gives rows that differ from the JAX bits
    in at least one thread order; the real code gives the right ones."""
    text, new = SEAL_MUTATIONS[mutation]
    src = bloom_emulate.device_source()
    assert src.count(text) == 1
    nbits, nhash = 6385, 4
    sets = _seal_sets(SEED + 5, [16, 27, 9, 300, 3])
    want = [_jax_bits(h, nbits, nhash) for h in sets]
    jobs = [(sets, nbits, nhash, order) for order in ORDERS]
    nbytes = (nbits + 7) // 8

    def right(results) -> bool:
        return all(np.array_equal(row.view(np.uint8)[:nbytes], w)
                   for rows, _info in results for row, w in zip(rows, want))

    assert right(bloom_emulate.emulate_seals(jobs))
    assert not right(bloom_emulate.emulate_seals(
        jobs, source=src.replace(text, new), build_dir=tmp_path))
