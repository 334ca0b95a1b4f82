"""The fold kernel's own code (csrc/gf_fold.cu) run on the CPU through a g++
emulation (ceph_tpu_torch/tools/fold_emulate.py: a thread block of 256
fibers, __syncthreads and warp shuffles as barriers), held bit for bit
against its plain version, gf_fold_plain, and against the JAX package's host
oracle, ceph_tpu.compute.kernels.host_eval.

Every shape runs with all-ones rows (the XOR path), with the gf_fingerprint
kernel's weights, and with random weights that include zero.  The shapes
cover the 16-byte path (lanes 32, 64 and 1024) and the 4-byte one (lanes 12
and 48, where the vectors per row do not tile a warp and the shuffles are
skipped), one row and ragged row counts, and the ragged edge of a chunk.
GRIDS run on cards that hold few blocks at once, so that an item's rows
split into chunks on several blocks, and on one that holds fewer blocks
than the tiles, so that blocks walk several tiles: every chunk's partial
reaches the output through the atomics.
"""

import shutil

import numpy as np
import pytest
import torch

from ceph_tpu.compute import kernels as jkernels
from ceph_tpu_torch.compute import kernels as kernels
from ceph_tpu_torch.ops import fold_kernels
from ceph_tpu_torch.tools import fold_emulate

SEED = 20261019
H100 = fold_emulate.H100_TARGET
# (B, rows, lanes), on the H100's grid
SHAPES = ((44, 1024, 32), (33, 1, 32), (7, 129, 32), (1, 3, 32),
          (5, 300, 64), (3, 77, 12), (4, 131, 48), (2, 40, 1024))
# (B, rows, lanes, blocks the card holds): chunks per item, tiles per block
GRIDS = ((1, 5000, 32, 8),            # 1 item in 8 chunks, one a block
         (3, 4100, 32, 8),            # 3 chunks per item, 9 tiles
         (1, 3000, 64, 4),            # 4 chunks of 750 rows
         (7, 2000, 32, 1),            # 7 tiles on 4 blocks: blocks loop
         (2, 2500, 12, 4))            # the 4-byte path in 2 chunks each
WEIGHTS = ("ones", "fingerprint", "random")


def _weights(kind: str, rows: int, rng):
    if kind == "ones":
        return None
    if kind == "fingerprint":
        return kernels.GfFingerprint().row_weights(rows).reshape(-1)
    return rng.integers(0, 256, rows, dtype=np.uint8)


@pytest.fixture(scope="module")
def emulated():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to build the kernel's CPU emulation")
    rng = np.random.default_rng(SEED)
    jobs = []
    for b, rows, lanes, target in ([(*s, H100) for s in SHAPES]
                                   + list(GRIDS)):
        for kind in WEIGHTS:
            data = rng.integers(0, 256, (b, rows, lanes), dtype=np.uint8)
            data[:, ::5, ::3] = 0              # zero bytes in every row
            jobs.append(((b, rows, lanes, target), kind,
                         _weights(kind, rows, rng), data))
    outs = fold_emulate.emulate_many([(w, d) for _s, _k, w, d in jobs],
                                     [s[3] for s, _k, _w, _d in jobs])
    return {(shape, kind): (w, d, out)
            for (shape, kind, w, d), out in zip(jobs, outs)}


def _check(w, d, out):
    plain = fold_kernels.gf_fold_plain(
        None if w is None else torch.from_numpy(w.copy()),
        torch.from_numpy(d))
    np.testing.assert_array_equal(out, plain.numpy())
    ones = np.ones((1, d.shape[1]), dtype=np.uint8)
    oracle = jkernels.host_eval(ones if w is None else w[None, :], d)
    np.testing.assert_array_equal(out, oracle)


@pytest.mark.parametrize("kind", WEIGHTS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_emulated_fold_equals_plain_and_host_oracle(emulated, shape, kind):
    w, d, (out, grid) = emulated[((*shape, H100), kind)]
    _check(w, d, out)
    assert grid["blocks"] >= 1


@pytest.mark.parametrize("kind", WEIGHTS)
@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_emulated_fold_across_blocks(emulated, grid, kind):
    w, d, (out, got) = emulated[(grid, kind)]
    _check(w, d, out)
    b, rows, _lanes, target = grid
    assert got["chunks"] > 1 or got["blocks"] < b
    assert got["blocks"] <= 4 * target


def test_fold_grid_keeps_chunks_to_whole_steps(emulated):
    """A chunk is never shorter than one unrolled step of the block (the
    launcher's FOLD_UNROLL x stride), and the tiles cover every row."""
    for (b, rows, lanes, target), kind in emulated:
        if kind != "ones":
            continue
        _w, _d, (_out, got) = emulated[((b, rows, lanes, target), kind)]
        vpr = lanes // (16 if lanes % 16 == 0 else 4)
        step_rows = 4 * (256 // vpr)
        per = -(-rows // got["chunks"])
        assert got["chunks"] == 1 or per >= step_rows
        assert got["chunks"] * per >= rows
