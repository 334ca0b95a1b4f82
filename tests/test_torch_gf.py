"""ceph_tpu_torch GF(2^8) layer against the JAX package, on the CPU.

The port's host tables and helpers, the plain versions of its two GF
kernels, the spec kernel's schedule (replayed on the CPU) and its
bit-decomposition product are held bit-for-bit against ceph_tpu.ops.gf and
the Pallas kernels of ceph_tpu.ops.gf_pallas (run in interpret mode).
Inputs come from numpy with fixed seeds; every output is an integer, so the
tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ceph_tpu.models import reed_solomon as jrs
from ceph_tpu.ops import gf as jgf
from ceph_tpu.ops import gf_pallas
from ceph_tpu_torch.models import reed_solomon as trs
from ceph_tpu_torch.ops import gf as tgf
from ceph_tpu_torch.ops import gf_kernels

PALLAS_SHAPES = [(2, 1, 512, 1), (4, 2, 1024, 2), (8, 3, 1536, 1)]


@pytest.fixture
def pallas_interpret():
    """The Pallas words kernels in interpret mode on the CPU; the set of
    registered matrices is restored afterwards."""
    saved = set(gf_pallas._registered)
    gf_pallas.FORCE_INTERPRET = True
    try:
        yield gf_pallas
    finally:
        gf_pallas.FORCE_INTERPRET = False
        gf_pallas._registered.clear()
        gf_pallas._registered.update(saved)
        gf_pallas._spec_call.cache_clear()
        gf_pallas._gen_call.cache_clear()


def test_host_tables_equal():
    assert np.array_equal(tgf.GF_EXP, jgf.GF_EXP)
    assert np.array_equal(tgf.GF_LOG, jgf.GF_LOG)
    a = np.repeat(np.arange(256, dtype=np.uint8), 256)
    b = np.tile(np.arange(256, dtype=np.uint8), 256)
    assert np.array_equal(tgf.gf_mul(a, b), jgf.gf_mul(a, b))
    for x in range(1, 256):
        assert tgf.gf_inv(x) == jgf.gf_inv(x)
        assert tgf.gf_div(7, x) == jgf.gf_div(7, x)
        assert tgf.gf_pow(x, 13) == jgf.gf_pow(x, 13)


@pytest.mark.parametrize("r,k", [(1, 2), (3, 8), (4, 10), (8, 8)])
def test_matrix_to_bits_equal(r, k):
    rng = np.random.default_rng(100 + r * k)
    m = rng.integers(0, 256, (r, k)).astype(np.uint8)
    assert np.array_equal(tgf.gf_matrix_to_bits(m), jgf.gf_matrix_to_bits(m))


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (8, 3), (10, 4)])
def test_invert_matrix_equal(k, m):
    coding = jrs.reed_sol_van_matrix(k, m)
    have = list(range(m, k + m))            # drop the first m data chunks
    gen = np.zeros((k, k), dtype=np.uint8)
    for row, c in enumerate(have):
        if c < k:
            gen[row, c] = 1
        else:
            gen[row] = coding[c - k]
    assert np.array_equal(tgf.gf_invert_matrix(gen),
                          jgf.gf_invert_matrix(gen))


def test_invert_singular_raises_like_jax():
    sing = np.array([[1, 1], [1, 1]], dtype=np.uint8)
    with pytest.raises(np.linalg.LinAlgError):
        jgf.gf_invert_matrix(sing)
    with pytest.raises(np.linalg.LinAlgError):
        tgf.gf_invert_matrix(sing)


@pytest.mark.parametrize("k,m,s,b", PALLAS_SHAPES)
def test_spec_plain_matches_pallas_spec_kernel(pallas_interpret, k, m, s, b):
    mat = jrs.reed_sol_van_matrix(k, m)
    pallas_interpret.register_matrix(mat)
    assert pallas_interpret._coeff_key(mat) in pallas_interpret._registered
    rng = np.random.default_rng(20 + k)
    data = rng.integers(0, 256, (b, k, s), dtype=np.uint8)
    want = pallas_interpret.gf_matmul_pallas(mat, data)
    got = gf_kernels.gf_matmul_spec_plain(mat, torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,m,s,b", PALLAS_SHAPES)
def test_gen_plain_matches_pallas_gen_kernel(pallas_interpret, k, m, s, b):
    rng = np.random.default_rng(30 + k)
    mat = rng.integers(0, 256, (m, k)).astype(np.uint8)
    assert pallas_interpret._coeff_key(mat) not in \
        pallas_interpret._registered
    data = rng.integers(0, 256, (b, k, s), dtype=np.uint8)
    want = pallas_interpret.gf_matmul_pallas(mat, data)
    got = gf_kernels.gf_matmul_gen_plain(mat, torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want)


def test_gen_plain_matches_pallas_on_decode_rows(pallas_interpret):
    """Decode rows (unregistered) through both generic kernels recover
    the erased data chunk."""
    k, m = 4, 2
    mat = jrs.reed_sol_van_matrix(k, m)
    rng = np.random.default_rng(14)
    data = rng.integers(0, 256, (k, 512), dtype=np.uint8)
    chunks = np.concatenate([data, jgf.gf_matmul_ref(mat, data)], axis=0)
    have = [1, 2, 3, 4]
    dmat = trs.decode_matrix(mat, k, [0], have)
    assert np.array_equal(dmat, jrs.decode_matrix(mat, k, [0], have))
    want = pallas_interpret.gf_matmul_pallas(dmat, chunks[have])
    got = gf_kernels.gf_matmul_gen_plain(dmat,
                                         torch.from_numpy(chunks[have]))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy()[0], data[0])


@pytest.mark.parametrize("s", [512, 544, 1024])
def test_gf2_matmul_bytes_matches_jax(s):
    rng = np.random.default_rng(40 + s)
    mat = rng.integers(0, 256, (3, 8)).astype(np.uint8)
    mbits = jgf.gf_matrix_to_bits(mat)
    data = rng.integers(0, 256, (2, 8, s), dtype=np.uint8)
    want = np.asarray(jgf.gf2_matmul_bytes(jnp.asarray(mbits),
                                           jnp.asarray(data)))
    got = tgf.gf2_matmul_bytes(mbits, torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("s", [36, 544, 2048])
def test_device_entry_routes_by_registration(s):
    """gf_matmul_device on CPU tensors: the registered generator takes
    the spec plain version, anything else the gen one; both equal the
    numpy oracle, for ragged S too, and nothing counts as a launch."""
    mat = trs.reed_sol_van_matrix(8, 3)
    gf_kernels.register_matrix(mat)
    rng = np.random.default_rng(50 + s)
    other = rng.integers(0, 256, (2, 8)).astype(np.uint8)
    data = rng.integers(0, 256, (3, 8, s), dtype=np.uint8)
    before = (gf_kernels.gf_matmul_spec.launches,
              gf_kernels.gf_matmul_gen.launches)
    for m in (mat, other):
        got = tgf.gf_matmul_device(m, torch.from_numpy(data)).numpy()
        for i in range(3):
            assert np.array_equal(got[i], jgf.gf_matmul_ref(m, data[i]))
    out = torch.empty((3, 3, s), dtype=torch.uint8)
    res = gf_kernels.gf_matmul(mat, torch.from_numpy(data), out=out)
    assert res is out
    assert np.array_equal(out.numpy()[1], jgf.gf_matmul_ref(mat, data[1]))
    assert (gf_kernels.gf_matmul_spec.launches,
            gf_kernels.gf_matmul_gen.launches) == before


def test_plain_rejects_unaligned_chunks():
    mat = np.ones((1, 2), dtype=np.uint8)
    with pytest.raises(ValueError):
        gf_kernels.gf_matmul_gen_plain(mat, torch.zeros((2, 6),
                                                        dtype=torch.uint8))
    with pytest.raises(ValueError):
        gf_kernels.gf_matmul_spec_plain(mat, torch.zeros((3, 8),
                                                         dtype=torch.uint8))


def _random(r, k, seed):
    return np.random.default_rng(seed).integers(0, 256, (r, k)).astype(
        np.uint8)


def _zero_row():
    m = trs.reed_sol_van_matrix(8, 3)
    m[1] = 0
    return m


def _zero_col():
    m = trs.reed_sol_van_matrix(8, 3)
    m[:, 5] = 0
    return m


def _spec_replay(matrix, data):
    """The spec kernel's schedule, replayed on int32 words in its order:
    for each group of up to 8 inputs, each row runs Horner from its top
    bit down and its result XORs into the row's accumulator."""
    masks, tops = gf_kernels.spec_schedule(matrix)
    r, k = np.asarray(matrix).shape
    w = gf_kernels._words(data, k)
    acc = [torch.zeros_like(w[..., 0, :]) for _ in range(r)]
    for g in range(masks.shape[0]):
        x = [w[..., g * gf_kernels.GROUP + i, :]
             for i in range(min(gf_kernels.GROUP, k - g * gf_kernels.GROUP))]
        for j in range(r):
            top = int(tops[g, j])
            h = torch.zeros_like(acc[j])
            for s in range(top, -1, -1):
                if s < top:
                    h = gf_kernels._xtime(h)
                for i, xi in enumerate(x):
                    if (int(masks[g, j, s]) >> i) & 1:
                        h = h ^ xi
            acc[j] = acc[j] ^ h
    return torch.stack(acc, dim=-2).view(torch.uint8)


# (matrix, stripes, chunk bytes): the spec kernel's schedule cases: one
# group and two (10+4), a one-input tail group (K = 9), the kernel's
# limits (R = 16, K = 64), k = 1, a Cauchy generator, a zero row (top -1)
# and a zero column, and chunk lengths that are no multiple of 512 bytes
# (544) or of 16 (2052).  The replay walks words one by one; how the
# kernel splits a row into uint4 columns, and its tail of the last block
# of columns, can be checked only on the card (chip_smoke.py phase 2).
SPEC_CASES = {
    "rs8+3": (lambda: trs.reed_sol_van_matrix(8, 3), 2, 1024),
    "rs4+2": (lambda: trs.reed_sol_van_matrix(4, 2), 3, 512),
    "rs10+4": (lambda: trs.reed_sol_van_matrix(10, 4), 2, 1024),
    "k9": (lambda: _random(3, 9, 9), 2, 512),
    "r16k64": (lambda: _random(16, 64, 64), 1, 512),
    "k1": (lambda: trs.reed_sol_van_matrix(1, 2), 2, 512),
    "cauchy6+3": (lambda: trs.cauchy_good_matrix(6, 3), 2, 512),
    "zero_row": (_zero_row, 2, 512),
    "zero_col": (_zero_col, 2, 512),
    "s544": (lambda: trs.reed_sol_van_matrix(8, 3), 2, 544),
    "s2052": (lambda: trs.reed_sol_van_matrix(8, 3), 2, 2052),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_replay_matches_pallas_spec_kernel(pallas_interpret, case):
    """The spec kernel's schedule (groups of 8 inputs, Horner per row from
    its top bit, XOR into the accumulators), replayed on int32 words,
    equals the JAX specialised kernel and the plain version.  Pallas takes
    chunks of whole 512-byte rows, so a shorter tail is zero-padded for it
    and cut off after (the product is word by word)."""
    make, b, s = SPEC_CASES[case]
    mat = make()
    k = mat.shape[1]
    data = np.random.default_rng(70 + s + k).integers(
        0, 256, (b, k, s), dtype=np.uint8)
    got = _spec_replay(mat, torch.from_numpy(data))
    assert got.shape == (b, mat.shape[0], s)
    assert torch.equal(got, gf_kernels.gf_matmul_spec_plain(
        mat, torch.from_numpy(data)))
    pallas_interpret.register_matrix(mat)
    padded = np.zeros((b, k, -(-s // 512) * 512), dtype=np.uint8)
    padded[..., :s] = data
    want = pallas_interpret.gf_matmul_pallas(mat, padded)[..., :s]
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_schedule_masks_and_tops(case):
    """masks[g, j, s] bit i is bit s of M[j, 8g + i]; tops[g, j] is the
    highest s with a nonzero mask, -1 for none; shapes follow the groups."""
    mat = SPEC_CASES[case][0]()
    r, k = mat.shape
    masks, tops = gf_kernels.spec_schedule(mat)
    groups = -(-k // gf_kernels.GROUP)
    assert masks.shape == (groups, r, 8) and masks.dtype == np.uint8
    assert tops.shape == (groups, r) and tops.dtype == np.int8
    for g in range(groups):
        for j in range(r):
            for s in range(8):
                want = sum(1 << i for i in range(gf_kernels.GROUP)
                           if g * 8 + i < k and (mat[j, g * 8 + i] >> s) & 1)
                assert masks[g, j, s] == want
            set_s = [s for s in range(8) if masks[g, j, s]]
            assert tops[g, j] == (max(set_s) if set_s else -1)


def test_spec_schedule_xtime_count_rs8_3():
    """RS 8+3 needs 14 xtime steps per column word on the Horner schedule
    (row 0 is all ones; rows 1 and 2 reach bit 7), against the 56 of a
    ladder of powers per input, and 83 XORs for its 83 set bits."""
    masks, tops = gf_kernels.spec_schedule(trs.reed_sol_van_matrix(8, 3))
    assert tops.tolist() == [[0, 7, 7]]
    assert int(np.maximum(tops, 0).sum()) == 14
    assert int(np.unpackbits(masks).sum()) == 83


@settings(max_examples=25, deadline=None)
@given(r=st.integers(1, gf_kernels.MAX_R), k=st.integers(1, gf_kernels.MAX_K),
       words=st.integers(1, 3), seed=st.integers(0, 2**32 - 1))
def test_spec_replay_matches_plain_property(r, k, words, seed):
    """Any matrix within the kernel's limits: the replayed schedule equals
    the plain version bit for bit."""
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 256, (r, k)).astype(np.uint8)
    mat[rng.random((r, k)) < 0.2] = 0
    data = torch.from_numpy(rng.integers(0, 256, (2, k, 4 * words),
                                         dtype=np.uint8))
    assert torch.equal(_spec_replay(mat, data),
                       gf_kernels.gf_matmul_spec_plain(mat, data))
