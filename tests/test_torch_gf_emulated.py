"""The GF(2^8) kernel's own code (ceph_tpu_torch/csrc/gf_matmul.cu) run on
the CPU by ceph_tpu_torch/tools/gf_emulate.py (g++, the grid run serially
block by block and thread by thread), as the gf_matmul_gen entry runs it
on the card: the schedule derived from the coefficients in the C entry,
the launch's grid, the kernel.  Held bit for bit against
gf_matmul_gen_plain (the ladder of the TPU generic kernel), against
spec_schedule for the derived masks and tops, and, for a sample of decode
matrices, against the JAX generic kernel in interpret mode.  Every output
is an integer, so the tolerance is exact equality.
"""

import itertools
import shutil

import numpy as np
import pytest
import torch

from ceph_tpu.ops import gf_pallas
from ceph_tpu_torch.models import reed_solomon as rs
from ceph_tpu_torch.ops import gf_kernels
from ceph_tpu_torch.tools import gf_emulate

K, M = 8, 3


@pytest.fixture(scope="module")
def emulator():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's host emulation")
    return gf_emulate.build()


def _decode_rows(lost) -> np.ndarray:
    """The RS 8+3 reed_sol_van decode matrix of the erased chunks `lost`
    from the first 8 survivors, as ec_util and the codec build it."""
    have = [i for i in range(K + M) if i not in lost][:K]
    return rs.decode_matrix(rs.reed_sol_van_matrix(K, M), K, list(lost), have)


def _plain(matrix, data: np.ndarray) -> np.ndarray:
    return gf_kernels.gf_matmul_gen_plain(matrix,
                                          torch.from_numpy(data)).numpy()


def _random(r, k, seed, zeros=0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 256, (r, k)).astype(np.uint8)
    m[rng.random((r, k)) < zeros] = 0
    return m


def _zero_row_and_column() -> np.ndarray:
    m = _decode_rows((0, 4, 9)).copy()
    m[1] = 0
    m[:, 5] = 0
    return m


# erasures -> chunk bytes: the one-row decodes at a degraded cluster
# read's 4096 bytes (128-thread blocks, two uint4 per thread), the two-row
# ones on single words (2052), the three-row ones on a tail block where
# one thread has a second uint4 (12304)
DECODE_CHUNKS = {1: 4096, 2: 2052, 3: 12304}


@pytest.mark.parametrize("erasures", sorted(DECODE_CHUNKS))
def test_emulated_gen_on_every_rs8_3_decode_matrix(emulator, erasures):
    """Every erasure pattern of RS 8+3 with `erasures` chunks lost (11, 55
    and 165 patterns) in one emulator call: the kernel recovers the lost
    chunks, equals the plain version, and its entry derives the schedule
    spec_schedule builds."""
    s = DECODE_CHUNKS[erasures]
    rng = np.random.default_rng(800 + erasures)
    data = rng.integers(0, 256, (2, K, s), dtype=np.uint8)
    parity = _plain(rs.reed_sol_van_matrix(K, M), data)
    chunks = np.concatenate([data, parity], axis=1)
    patterns = list(itertools.combinations(range(K + M), erasures))
    jobs = []
    for lost in patterns:
        have = [i for i in range(K + M) if i not in lost][:K]
        jobs.append((_decode_rows(lost), np.ascontiguousarray(
            chunks[:, have])))
    results = gf_emulate.emulate_many(jobs)
    assert len(results) == {1: 11, 2: 55, 3: 165}[erasures]
    for lost, (mat, survivors), (out, masks, tops) in zip(patterns, jobs,
                                                          results):
        assert np.array_equal(out, chunks[:, list(lost)]), lost
        assert np.array_equal(out, _plain(mat, survivors)), lost
        want_masks, want_tops = gf_kernels.spec_schedule(mat)
        assert np.array_equal(masks, want_masks), lost
        assert np.array_equal(tops, want_tops), lost


# (matrix, stripes, chunk bytes)
SHAPE_CASES = {
    # more than one group of 8 inputs: a full second group, a one-input tail
    "k10": (lambda: _random(4, 10, 10), 3, 4096),
    "k17": (lambda: _random(3, 17, 17, zeros=0.2), 2, 2048),
    # the kernel's limits
    "r16k64": (lambda: _random(16, 64, 64), 1, 4096),
    "k1": (lambda: _random(2, 1, 1), 4, 64),
    # top -1 for a (group, row) and an input no row selects
    "zero row and column": (_zero_row_and_column, 2, 4096),
    # the column paths: single words (S % 16 != 0); rows of at most 256
    # uint4, which take 128-thread blocks (2048: one uint4 per thread,
    # 4096: two); a row of 257 uint4 in a 256-thread block (only thread 0
    # has a second); a block of 512 and one column past it; the smallest
    # chunk
    "S=2052": (lambda: _decode_rows((0, 4, 9)), 2, 2052),
    "S=2048": (lambda: _decode_rows((0, 4, 9)), 2, 2048),
    "S=4096": (lambda: _decode_rows((0, 4, 9)), 2, 4096),
    "S=4112": (lambda: _decode_rows((0, 4, 9)), 2, 4112),
    "S=12304": (lambda: _decode_rows((0, 4, 9)), 2, 12304),
    "S=4": (lambda: _decode_rows((2,)), 3, 4),
    # more stripes than the grid's 65535 rows: the kernel's stripe loop
    "B=65537": (lambda: _decode_rows((1, 10)), 65537, 16),
}


@pytest.mark.parametrize("case", list(SHAPE_CASES))
def test_emulated_gen_matches_plain(emulator, case):
    make, b, s = SHAPE_CASES[case]
    mat = make()
    data = np.random.default_rng(len(case) + s).integers(
        0, 256, (b, mat.shape[1], s), dtype=np.uint8)
    got = gf_emulate.emulate(mat, data)
    assert got.shape == (b, mat.shape[0], s)
    assert np.array_equal(got, _plain(mat, data))


@pytest.mark.parametrize("seed", range(8))
def test_emulated_schedule_matches_spec_schedule(emulator, seed):
    """The C entry's derivation of the masks and tops equals spec_schedule
    on random matrices of every size within the kernel's limits, a fifth
    of the coefficients zero."""
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(16):
        r = int(rng.integers(1, gf_kernels.MAX_R + 1))
        k = int(rng.integers(1, gf_kernels.MAX_K + 1))
        mat = _random(r, k, int(rng.integers(2**32)), zeros=0.2)
        jobs.append((mat, rng.integers(0, 256, (1, k, 16), dtype=np.uint8)))
    for (mat, data), (out, masks, tops) in zip(
            jobs, gf_emulate.emulate_many(jobs)):
        want_masks, want_tops = gf_kernels.spec_schedule(mat)
        assert np.array_equal(masks, want_masks)
        assert np.array_equal(tops, want_tops)
        assert np.array_equal(out, _plain(mat, data))


@pytest.fixture
def pallas_interpret():
    """The Pallas kernels in interpret mode on the CPU."""
    gf_pallas.FORCE_INTERPRET = True
    try:
        yield gf_pallas
    finally:
        gf_pallas.FORCE_INTERPRET = False
        gf_pallas._gen_call.cache_clear()


@pytest.mark.parametrize("lost", [(0,), (9,), (3, 9), (0, 4, 9)],
                         ids=lambda lost: "lost " + " ".join(map(str, lost)))
def test_emulated_gen_matches_jax_gen_kernel(emulator, pallas_interpret,
                                             lost):
    """Decode matrices (never registered) through the JAX generic kernel
    and through the emulated CUDA kernel give the same bytes."""
    mat = _decode_rows(lost)
    assert gf_pallas._coeff_key(mat) not in gf_pallas._registered
    data = np.random.default_rng(sum(lost) + 3).integers(
        0, 256, (2, K, 1024), dtype=np.uint8)
    want = pallas_interpret.gf_matmul_pallas(mat, data)
    assert np.array_equal(gf_emulate.emulate(mat, data), np.asarray(want))
