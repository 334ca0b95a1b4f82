"""The scoring kernel's own code (csrc/compress_score.cu) run on the CPU
through a g++ emulation (ceph_tpu_torch/tools/score_emulate.py: a thread
block of 256 threads, __syncthreads and warp shuffles as barriers), held
against its plain version, score_blocks_plain, and the JAX functions it
replaces.

The shapes are those of chip_smoke's phase 3f kernel check, S in {1, 3,
511, 512, 513, 4097, 65536, 64 x 4096 + 17} (16-byte vector loads and byte
loads, one tile and many, rows shorter than the largest lag), with B cut for
the CPU, and every data kind, on the grid the launcher picks for an H100.
GRIDS add cards that hold fewer blocks at once, so that small batches take
the other grid choices: rows whose tiles do not split evenly over their
blocks, a batch large enough to cut the blocks per row, and one block
walking more than 63 tiles (its lag counters fold into the warp sums
midway).  All jobs share one workspace, zeroed once, as on the card; it is
zero again after every job.  The emulator runs a row's thread blocks in
reverse order, so the block that finishes the row is not the last one.
Histograms and match fractions are held bit for bit, the entropy within
score_kernels.ENTROPY_TOL.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.compressor import scoring as jscoring
from ceph_tpu_torch.ops import score_kernels
from ceph_tpu_torch.tools import score_emulate
from test_torch_compressor import KINDS, make_blocks

SEED = 20261018
SHAPES = ((64, 1), (24, 3), (8, 511), (8, 512), (8, 513), (4, 4097),
          (2, 65536), (1, 64 * 4096 + 17))
H100 = score_emulate.H100_TARGET
# (B, S, blocks the card holds): blocks per row and tiles per block
GRIDS = ((1, 16384, 8),               # 4 blocks of 1 tile
         (3, 16384, 8),               # 2 blocks of 2 tiles
         (8, 16384, 8),               # 1 block of 4 tiles
         (2, 65536, 6),               # 3 blocks of 6, 6 and 4 tiles
         (1, 64 * 4096 + 17, 8),      # 8 blocks of 9 tiles, the last 2
         (1, 64 * 4096 + 17, 1))      # 1 block of 65 tiles


@pytest.fixture(scope="module")
def emulated():
    rng = np.random.default_rng(SEED)
    jobs = [((b, s, H100), kind, make_blocks(kind, b, s, rng))
            for b, s in SHAPES for kind in KINDS]
    jobs += [(grid, kind, make_blocks(kind, *grid[:2], rng))
             for grid in GRIDS for kind in KINDS]
    outs = score_emulate.emulate_many([blocks for _g, _k, blocks in jobs],
                                      [grid[2] for grid, _k, _b in jobs])
    return {(grid, kind): (blocks, out)
            for (grid, kind, blocks), out in zip(jobs, outs)}


def _equals_plain(blocks, hist, entropy, match):
    p_hist, p_entropy, p_match = score_kernels.score_blocks_plain(
        torch.from_numpy(blocks))
    np.testing.assert_array_equal(hist, p_hist.numpy())
    assert match.tobytes() == p_match.numpy().tobytes()
    np.testing.assert_allclose(entropy, p_entropy.numpy(), rtol=0,
                               atol=score_kernels.ENTROPY_TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_code_equals_plain(emulated, shape, kind):
    blocks, (hist, entropy, match, _grid) = emulated[(*shape, H100), kind]
    _equals_plain(blocks, hist, entropy, match)
    np.testing.assert_array_equal(
        hist, np.asarray(jscoring._byte_histograms_dev(blocks)))
    assert match.tobytes() == np.asarray(
        jscoring._match_fraction_dev(blocks)).tobytes()


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_grids_equal_plain(emulated, grid, kind):
    blocks, (hist, entropy, match, _grid) = emulated[grid, kind]
    _equals_plain(blocks, hist, entropy, match)


@pytest.mark.parametrize("kind", KINDS)
def test_workspace_is_zero_after_every_job(emulated, kind):
    """The block that finishes a row zeroes its slots and its ticket, so
    the next launch finds the workspace as the wrapper allocated it."""
    left = {grid: out[3]["left"] for (grid, k), (_b, out) in emulated.items()
            if k == kind}
    assert left == dict.fromkeys(left, 0)


def test_grids_take_each_choice(emulated):
    """GRIDS reach what they are named for: the blocks per row and tiles per
    block of the launcher's own rule (score_grid), as the emulator ran them."""
    got = [(emulated[grid, "zeros"][1][3]["blocks"],
            emulated[grid, "zeros"][1][3]["tiles"]) for grid in GRIDS]
    assert got == [(4, 1), (2, 2), (1, 4), (3, 6), (8, 9), (1, 65)]
    # on the H100's grid a 64 KiB span spreads over a block a tile
    assert emulated[(2, 65536, H100), "zeros"][1][3] == {
        "blocks": 16, "tiles": 1, "left": 0}
