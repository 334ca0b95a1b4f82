"""ceph_tpu_torch crc32c layer against the JAX package, on the CPU.

The port's host crc32c, its zero-run folding, the plain version of its
batched crc kernel and the kernel's launch plan are held bit-for-bit
against ceph_tpu.ops.checksum and the Pallas kernel of
ceph_tpu.ops.crc_pallas (run in interpret mode).  Inputs come from numpy
with fixed seeds; the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ops import checksum as jck
from ceph_tpu.ops import crc_pallas
from ceph_tpu_torch.ops import checksum as tck
from ceph_tpu_torch.ops import crc_kernels

SEEDS = (0, 0xFFFFFFFF, 0xDEADBEEF)


@pytest.fixture
def crc_interpret():
    """The Pallas crc kernel in interpret mode; the flag is baked into
    the cached call, so the cache is cleared on the way out."""
    crc_pallas.FORCE_INTERPRET = True
    try:
        yield crc_pallas
    finally:
        crc_pallas.FORCE_INTERPRET = False
        crc_pallas._crc_call.cache_clear()


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n", [0, 1, 3, 64, 1000, 4097, 70001])
def test_host_crc32c_matches(n):
    rng = np.random.default_rng(n)
    buf = rng.integers(0, 256, n, dtype=np.uint8)
    for seed in SEEDS:
        want = jck.crc32c(seed, buf.tobytes())
        assert tck.crc32c(seed, buf) == want
        assert tck.crc32c(seed, buf.tobytes()) == want
        assert tck.crc32c(seed, memoryview(bytearray(buf))) == want


@pytest.mark.parametrize("length", [0, 1, 7, 64, 4096, 1 << 20, 12345678])
def test_crc32c_zeros_matches(length):
    for seed in SEEDS:
        assert tck.crc32c_zeros(seed, length) == \
            jck.crc32c_zeros(seed, length)
    assert tck.crc32c(0x1234, None, length) == jck.crc32c(0x1234, None,
                                                           length)


def test_crc32c_combine_matches():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, 500, dtype=np.uint8).tobytes()
    ca = jck.crc32c(0xFFFFFFFF, a)
    cb = jck.crc32c(0, b)
    assert tck.crc32c_combine(ca, cb, len(b)) == \
        jck.crc32c_combine(ca, cb, len(b)) == jck.crc32c(0xFFFFFFFF, a + b)


def test_crc_matrices_match():
    assert np.array_equal(tck._cell_matrix(), jck._cell_matrix())
    for length in (64, 4096, 524288):
        assert np.array_equal(tck._zero_advance_matrix(length),
                              jck._zero_advance_matrix(length))


@pytest.mark.parametrize("length,n", [(4096, 5), (4096, 130), (512, 9),
                                      (64, 3)])
@pytest.mark.parametrize("init", SEEDS)
def test_crc_plain_matches_pallas_kernel(crc_interpret, length, n, init):
    rng = np.random.default_rng(11 + length + n)
    data = rng.integers(0, 256, (n, length), dtype=np.uint8)
    words = jnp.asarray(data.view(np.int32))
    want = np.asarray(crc_interpret.crc32c_blocks_words(words, length,
                                                        init=init))
    got = crc_kernels.crc32c_blocks(torch.from_numpy(data), length, init)
    assert np.array_equal(_u32(got), want)
    assert np.array_equal(_u32(tck.crc32c_batch(torch.from_numpy(data),
                                                init)), want)


@pytest.mark.parametrize("length", [32, 96, 16384])
def test_crc_batch_matches_jax(length):
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, (6, length), dtype=np.uint8)
    for init in (0xFFFFFFFF, 0):
        want = np.asarray(jck.crc32c_batch_tpu(data, init=init))
        got = tck.crc32c_batch(torch.from_numpy(data), init)
        assert np.array_equal(_u32(got), want)


def test_partial_bits_and_combine_match_jax():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (4, 200), dtype=np.uint8)
    jc = jck.make_crc_consts(200)
    tc = tck.make_crc_consts(200)
    jbits = np.asarray(jck.crc32c_partial_bits(jnp.asarray(data), jc))
    tbits = tck.crc32c_partial_bits(torch.from_numpy(data), tc)
    assert np.array_equal(tbits.numpy(), jbits)
    adv_j = jck.make_combine_advance(200)
    adv_t = torch.tensor(tck._zero_advance_matrix(200).T,
                         dtype=torch.float32)
    jcomb = np.asarray(jck.crc32c_combine_bits(jnp.asarray(jbits[:2]),
                                               jnp.asarray(jbits[2:]),
                                               adv_j))
    tcomb = tck.crc32c_combine_bits(tbits[:2], tbits[2:], adv_t)
    assert np.array_equal(tcomb.numpy(), jcomb)
    assert np.array_equal(_u32(tck.crc32c_pack_bits(tcomb)),
                          np.asarray(jck.crc32c_pack_bits(
                              jnp.asarray(jcomb))))


@pytest.mark.parametrize("length", [36, 544, 4096, 524288])
def test_kernel_launch_plan_folds_to_the_crc(length):
    """The CUDA kernel's split (threads x span of the front-padded
    block) and its tree of advance matrices, replayed on the host, give
    the block's crc."""
    levels, span, cols = crc_kernels.launch_plan(length)
    threads = 1 << levels
    pad = threads * span - length
    assert 0 <= pad and span % 4 == 0 and threads <= 256
    data = np.random.default_rng(length).integers(0, 256, length,
                                                  dtype=np.uint8)
    parts = []
    for t in range(threads):
        lo, hi = max(t * span - pad, 0), max((t + 1) * span - pad, 0)
        parts.append(tck.crc32c(0, data[lo:hi]))
    parts = np.array(parts, dtype=np.uint32)
    for lvl in range(levels):
        parts = tck.advance(cols[lvl * 32:(lvl + 1) * 32],
                            parts[0::2]) ^ parts[1::2]
    assert int(parts[0]) == jck.crc32c(0, data.tobytes())


def test_blocks_wrapper_checks_and_out():
    data = torch.from_numpy(np.arange(64, dtype=np.uint8))
    with pytest.raises(ValueError):
        crc_kernels.crc32c_blocks(data, 6)
    with pytest.raises(ValueError):
        crc_kernels.crc32c_blocks(data, 48)
    out = torch.empty(4, dtype=torch.int32)
    res = crc_kernels.crc32c_blocks(data, 16, 0xFFFFFFFF, out=out)
    assert res is out
    want = [jck.crc32c(0xFFFFFFFF, bytes(range(i, i + 16)))
            for i in range(0, 64, 16)]
    assert list(_u32(out)) == want
    assert crc_kernels.crc32c_blocks.launches == 0
