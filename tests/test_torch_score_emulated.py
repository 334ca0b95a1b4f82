"""The scoring kernel's own code (csrc/compress_score.cu) run on the CPU
through a g++ emulation (ceph_tpu_torch/tools/score_emulate.py: a thread
block of 256 threads, __syncthreads and warp shuffles as barriers), held
against its plain version, score_blocks_plain, and the JAX functions it
replaces.

The shapes are those of chip_smoke's phase 3f kernel check, S in {1, 3,
511, 512, 513, 4097, 65536, 64 x 4096 + 17} (16-byte vector loads and byte
loads, one tile and many, rows shorter than the largest lag, more tiles
than a row's thread blocks), with B cut for the CPU, and every data kind.
The emulator runs a row's thread blocks in reverse order, so the block
that finishes the row is not the last chunk.  Histograms and match fractions are held bit for bit, the
entropy within score_kernels.ENTROPY_TOL.
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


@pytest.fixture(scope="module")
def emulated():
    rng = np.random.default_rng(SEED)
    batches = [(shape, kind, make_blocks(kind, *shape, rng))
               for shape in SHAPES for kind in KINDS]
    outs = score_emulate.emulate_many([b for _s, _k, b in batches])
    return {(shape, kind): (blocks, out)
            for (shape, kind, blocks), out in zip(batches, outs)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_code_equals_plain(emulated, shape, kind):
    blocks, (hist, entropy, match) = emulated[shape, kind]
    p_hist, p_entropy, p_match = score_kernels.score_blocks_plain(
        torch.from_numpy(blocks))
    np.testing.assert_array_equal(hist, p_hist.numpy())
    assert match.tobytes() == p_match.numpy().tobytes()
    np.testing.assert_allclose(entropy, p_entropy.numpy(), rtol=0,
                               atol=score_kernels.ENTROPY_TOL)
    np.testing.assert_array_equal(
        hist, np.asarray(jscoring._byte_histograms_dev(blocks)))
    assert match.tobytes() == np.asarray(
        jscoring._match_fraction_dev(blocks)).tobytes()
