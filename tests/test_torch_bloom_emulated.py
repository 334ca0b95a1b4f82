"""The hit-set hash kernel's own code (csrc/hitset_bloom.cu), run on the CPU
through its g++ emulation (ceph_tpu_torch/tools/bloom_emulate.py), against
the numpy bloom_positions of both packages.

The cases are chip_smoke.py phase 3g's: B in {8, 37, 1024, 65536,
65536 + 17}, nhash in {1, 4, 7, 32} and nbits in {8, 6236, 1048573,
2^31 - 1}; then the magic reciprocal's edges (nbits 1, 2, 3, powers of two
and their neighbours, 2^32 - 1) against Python's integers, on dividends
that cross every power of two, and the grid-stride loop on a batch larger
than one launch's threads.  Every position is held bit for bit.
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
