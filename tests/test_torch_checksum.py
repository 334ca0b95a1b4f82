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


def _kernel_tables():
    c = crc_kernels.kernel_consts()
    assert c.shape == (crc_kernels.N_CONSTS,)
    return (c[crc_kernels.TAB:crc_kernels.FIN].reshape(4, 256),
            c[crc_kernels.FIN:crc_kernels.ADV].reshape(32, 32),
            c[crc_kernels.ADV:].reshape(crc_kernels.ADV_LEVELS, 32))


def _columns(mat: np.ndarray) -> np.ndarray:
    """(out_bit, in_bit) 0/1 matrix -> (32,) uint32 columns."""
    weights = np.int64(1) << np.arange(32, dtype=np.int64)
    return (mat.astype(np.int64) * weights[:, None]).sum(0).astype(np.uint32)


def test_kernel_z128_tables_match_jax_zero_advance():
    """Table k, entry i is the 128-zero-byte advance of byte i at byte
    position k, as ceph_tpu's own advance matrix gives it."""
    tab, _, _ = _kernel_tables()
    mat = jck._zero_advance_matrix(128).astype(np.int64)    # (out, in)
    byte_bits = (np.arange(256)[None, :] >> np.arange(8)[:, None]) & 1
    weights = np.int64(1) << np.arange(32, dtype=np.int64)
    for k in range(4):
        out_bits = (mat[:, 8 * k:8 * k + 8] @ byte_bits) % 2  # (32, 256)
        want = (out_bits * weights[:, None]).sum(0).astype(np.uint32)
        assert np.array_equal(tab[k], want)


def test_kernel_lane_and_row_advances_match_jax():
    """Lane j's last-row advance is Z(128 - 4j); row-advance level l is
    Z(128 << l)."""
    _, fin, adv = _kernel_tables()
    for j in range(32):
        assert np.array_equal(fin[:, j],
                              _columns(jck._zero_advance_matrix(128 - 4 * j)))
    for lvl in range(crc_kernels.ADV_LEVELS):
        assert np.array_equal(adv[lvl],
                              _columns(jck._zero_advance_matrix(128 << lvl)))


def _replay_kernel(blocks: np.ndarray, n_warps: int) -> np.ndarray:
    """csrc/crc32c.cu's arithmetic on the host: the launch's rows split
    evenly over n_warps warps; each warp's run of rows inside a block is
    hashed lane-interleaved (lane j takes word j of every row, steps
    s = Z128(s ^ w), and on the run's last row advances through 128 - 4j
    bytes), the lane states XOR into the run's crc, which is advanced
    through the rows after the run and XORed into the block's crc."""
    n, length = blocks.shape
    rows, pad = crc_kernels.launch_plan(length)
    assert rows * 128 - pad == length and 0 <= pad < 128 and pad % 4 == 0
    tab, fin, adv = _kernel_tables()
    padded = np.zeros((n, rows * 128), dtype=np.uint8)
    padded[:, pad:] = blocks
    words = padded.view("<u4").reshape(n, rows, 32)
    out = np.zeros(n, dtype=np.uint32)
    total = n * rows
    for g in range(n_warps):
        lo, hi = total * g // n_warps, total * (g + 1) // n_warps
        while lo < hi:
            blk, r0 = divmod(lo, rows)
            r1 = min(rows, r0 + hi - lo)
            s = np.zeros(32, dtype=np.uint32)
            for r in range(r0, r1 - 1):
                x = s ^ words[blk, r]
                s = (tab[0][x & 0xFF] ^ tab[1][(x >> 8) & 0xFF]
                     ^ tab[2][(x >> 16) & 0xFF] ^ tab[3][x >> 24])
            x = s ^ words[blk, r1 - 1]
            lanes = np.zeros(32, dtype=np.uint32)
            for b in range(32):
                lanes ^= ((x >> np.uint32(b)) & np.uint32(1)) * fin[b]
            part = np.bitwise_xor.reduce(lanes)
            after, lvl = rows - r1, 0
            while after:
                if after & 1:
                    part = tck.advance(adv[lvl], part)
                after, lvl = after >> 1, lvl + 1
            out[blk] ^= part
            lo += r1 - r0
    return out


@pytest.mark.parametrize("n_warps", [1, 5])
@pytest.mark.parametrize("length", [36, 544, 2052, 4096, 524288])
def test_kernel_launch_plan_replays_the_crc(length, n_warps):
    """The CUDA kernel's plan and constants, replayed on the host, give
    ceph_tpu's crc32c of every block, with warp runs that end inside
    blocks (5 warps) and that cover whole blocks (1 warp)."""
    data = np.random.default_rng(length).integers(0, 256, (3, length),
                                                  dtype=np.uint8)
    got = _replay_kernel(data, n_warps)
    assert [int(v) for v in got] == [jck.crc32c(0, row.tobytes())
                                     for row in data]


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
