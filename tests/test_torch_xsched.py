"""The port's XOR-schedule compiler and the `xor_sched` plan kind
(ceph_tpu_torch/ec/xsched.py, ec/plan.py, ops/xor_kernels.py) against the
JAX package's, on the CPU.

Every matrix compiles in both packages: the bitmatrix trio's generators
for every legal k at w = 7 (liberation), 6 (blaum_roth) and 8
(liber8tion), with their decode rows, and the GF(2^8) matrices the
schedule-vs-matmul pick sees (MSR 4/3/6 reconstructions and projections,
MSR 5/5/9 projections, RS 4+2, cauchy_good 8+3, RS 6+3, RS 8+3): the ops,
outputs, slot counts, XOR counts, tapes and the pick are equal.
`plan.repair` and `xor_sched_direct` are held against the reference's
`plan.repair` and its host fold, the native tape and the host tier
against the reference's, and the `xor_sched` kernel's own code (through
ceph_tpu_torch/tools/xsched_emulate.py, g++) against its plain versions
on the trio's encode and decode tapes, the MSR repair programs, a tape
longer than the kernel stages at once, 16-, 4- and 1-byte columns, ragged
last tiles, one and two input buffers, copies that land early or late, a
zero row and a single-copy row, GF chunk sizes that are no multiple of 32,
and grids whose blocks walk several tiles.  The branch-free tape the
kernel runs is held against the original tape on random tapes
(hypothesis) and on the trio's and MSR's programs.  Everything compared is
bytes or integers: the tolerance is exact equality.
"""

import itertools
import shutil

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ceph_tpu.ec import plan as jplan
from ceph_tpu.ec import xsched as jxsched
from ceph_tpu.models import bitmatrix as jbmx
from ceph_tpu.ops import gf as jgf
from ceph_tpu_torch.ec import plan, xsched
from ceph_tpu_torch.ec.registry import create_erasure_code
from ceph_tpu_torch.models import bitmatrix as bmx
from ceph_tpu_torch.models import reed_solomon as rs
from ceph_tpu_torch.ops import gf, xor_kernels
from ceph_tpu_torch.tools import xsched_emulate

SEED = 20261018
CPU = torch.device("cpu")
TRIO = {"liberation": 7, "blaum_roth": 6, "liber8tion": 8}
TRIO_SPACE = [(t, k) for t, w in TRIO.items() for k in range(2, w + 1)]


def _bitmatrix(technique: str, k: int, models=bmx) -> np.ndarray:
    w = TRIO[technique]
    if technique == "liberation":
        return models.liberation_bitmatrix(k, w)
    if technique == "blaum_roth":
        return models.blaum_roth_bitmatrix(k, w)
    return models.liber8tion_bitmatrix(k)


def _same_schedule(mine, ref) -> None:
    for field in ("sig", "n_in", "n_out", "n_slots", "ops", "outputs",
                  "xors_naive", "xors_scheduled"):
        assert getattr(mine, field) == getattr(ref, field), field
    pm, pr = xsched.lower_program(mine), jxsched.lower_program(ref)
    assert (pm.n_regions, pm.n_ops, pm.out_base) == \
        (pr.n_regions, pr.n_ops, pr.out_base)
    assert np.array_equal(pm.tape, pr.tape)


@pytest.mark.parametrize("technique,k", TRIO_SPACE)
def test_trio_schedules_and_tapes_equal_jax(technique, k):
    """The generator and the decode rows of the first two chunks (every
    1- and 2-erasure pattern at k = 4) compile to the reference's
    program, tape for tape."""
    w = TRIO[technique]
    bm = _bitmatrix(technique, k)
    assert np.array_equal(bm, _bitmatrix(technique, k, jbmx))
    mats = [bm]
    n = k + 2
    patterns = ([(0, 1)] if k != 4 else
                [e for r in (1, 2) for e in itertools.combinations(range(n),
                                                                   r)])
    for erased in patterns:
        have = tuple(i for i in range(n) if i not in erased)[:k]
        rows = bmx.decode_bitmatrix(bm, k, w, have, tuple(erased))
        assert np.array_equal(rows, jbmx.decode_bitmatrix(
            bm, k, w, have, tuple(erased)))
        mats.append(rows)
    for mat in mats:
        _same_schedule(xsched.compile_matrix(mat),
                       jxsched.compile_matrix(mat))


def _gf_matrices() -> dict:
    out = {"rs 4+2": rs.reed_sol_van_matrix(4, 2),
           "cauchy_good 8+3": rs.cauchy_good_matrix(8, 3),
           "rs 6+3": rs.reed_sol_van_matrix(6, 3),
           "rs 8+3": rs.reed_sol_van_matrix(8, 3)}
    c = create_erasure_code({"plugin": "ec_msr", "k": "4", "m": "3",
                             "d": "6", "device": "cpu"})
    for lost in range(7):
        helpers = tuple(h for h in range(7) if h != lost)
        out[f"msr 4/3/6 rebuild {lost}"] = c.repair_matrix(lost, helpers)
        out[f"msr 4/3/6 project {lost}"] = c.repair_vector(lost)[None, :]
    c = create_erasure_code({"plugin": "ec_msr", "k": "5", "m": "5",
                             "d": "9", "device": "cpu"})
    for lost in (0, 9):
        out[f"msr 5/5/9 project {lost}"] = c.repair_vector(lost)[None, :]
        out[f"msr 5/5/9 rebuild {lost}"] = c.repair_matrix(
            lost, tuple(h for h in range(10) if h != lost))
    return out


GF_MATRICES = _gf_matrices()
# the counts the compiler gives (naive -> scheduled XORs), and the pick
EXPECTED_PICK = {"rs 4+2": (128, 74, True),
                 "cauchy_good 8+3": (463, 244, True),
                 "rs 6+3": (428, 187, True), "rs 8+3": (563, 270, False),
                 "msr 4/3/6 rebuild 0": (444, 221, True),
                 "msr 4/3/6 rebuild 6": (584, 254, True),
                 "msr 5/5/9 project 0": (62, 42, True),
                 "msr 5/5/9 project 9": (137, 75, True)}


@pytest.mark.parametrize("name", sorted(GF_MATRICES))
def test_gf_pick_equals_jax(name):
    """plan._sched_for + prefer_schedule pick exactly where the
    reference's do, with the reference's program."""
    mat = GF_MATRICES[name]
    mine, ref = plan._sched_for(mat), jplan._sched_for(mat)
    assert (mine is None) == (ref is None)
    if mine is None:
        return
    _same_schedule(mine, ref)
    assert xsched.prefer_schedule(mine) == jxsched.prefer_schedule(ref)
    if name in EXPECTED_PICK:
        assert (mine.xors_naive, mine.xors_scheduled,
                xsched.prefer_schedule(mine)) == EXPECTED_PICK[name]


@pytest.mark.parametrize("name", ["msr 4/3/6 rebuild 0",
                                  "msr 4/3/6 rebuild 1",
                                  "msr 4/3/6 project 3",
                                  "msr 5/5/9 project 9", "rs 4+2",
                                  "rs 8+3"])
@pytest.mark.parametrize("shape", [(2, 64), (1, 30), (3, 4099)])
def test_repair_equals_jax(name, shape):
    """plan.repair on the CPU (the xor_sched kind's plain version, or the
    GF kernels' plain versions where the pick refuses) against the
    reference's plan.repair and its host fold, 3-D and 2-D, with chunk
    sizes that are no multiple of 4."""
    mat = GF_MATRICES[name]
    rng = np.random.default_rng(SEED)
    b, s = shape
    data = rng.integers(0, 256, (b, mat.shape[1], s), dtype=np.uint8)
    want = np.stack([jgf.gf_matmul_host(mat, d) for d in data])
    got = plan.repair(mat, data, CPU)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    ref = jplan.repair(mat, data)
    if ref is not None:
        assert np.array_equal(got, ref)
    assert np.array_equal(plan.repair(mat, data[0], CPU), want[0])


def test_xor_sched_direct_pick(monkeypatch):
    """The direct consumer pick: a function on the kernel's GF entry
    where the schedule wins, None under the kill switch or for a dense
    matrix, bit-exact with the GF product."""
    mat = rs.cauchy_good_matrix(4, 2)
    fn = plan.xor_sched_direct(mat)
    assert fn is not None
    assert (jplan.xor_sched_direct(mat) is not None) == (fn is not None)
    data = np.random.default_rng(SEED).integers(0, 256, (3, 4, 130),
                                                dtype=np.uint8)
    out = fn(torch.from_numpy(data)).numpy()
    assert np.array_equal(out, np.stack([gf.gf_matmul_ref(mat, d)
                                         for d in data]))
    assert plan.xor_sched_direct(rs.reed_sol_van_matrix(8, 3)) is None
    monkeypatch.setenv("CEPH_TPU_XSCHED", "0")
    assert plan.xor_sched_direct(mat) is None
    assert jplan.xor_sched_direct(mat) is None


def test_prefer_schedule_policy(monkeypatch):
    """The policy knobs are live and read as the reference reads them."""
    sparse = xsched.compile_matrix(bmx.liberation_bitmatrix(4, 7))
    dense = xsched.compile_matrix(gf.gf_matrix_to_bits(
        rs.reed_sol_van_matrix(8, 3)))
    assert dense.xors_scheduled > 256 and not xsched.prefer_schedule(dense)
    assert not xsched.prefer_schedule(sparse)
    monkeypatch.setenv("CEPH_TPU_XSCHED_MIN_REDUCTION", "0")
    assert xsched.prefer_schedule(sparse)
    monkeypatch.setenv("CEPH_TPU_XSCHED_MAX_OPS", "40")
    assert not xsched.prefer_schedule(sparse)
    monkeypatch.setenv("CEPH_TPU_XSCHED_MAX_OPS", "300")
    assert xsched.prefer_schedule(dense)
    monkeypatch.setenv("CEPH_TPU_XSCHED", "0")
    assert not xsched.prefer_schedule(sparse)
    assert plan._sched_for(rs.reed_sol_van_matrix(4, 2)) is None


def test_dense_memo_rejudged_when_the_ceiling_rises(monkeypatch):
    """A matrix too dense for the ceiling is remembered by count and
    compiled once the ceiling is raised, as in the reference."""
    mat = np.random.default_rng(SEED).integers(1, 256, (6, 6),
                                               dtype=np.uint8)
    assert plan._sched_for(mat) is None
    assert jplan._sched_for(mat) is None
    monkeypatch.setenv("CEPH_TPU_XSCHED_MAX_OPS", "100000")
    _same_schedule(plan._sched_for(mat), jplan._sched_for(mat))


@pytest.mark.parametrize("shape,ps,objects", [((8, 16), 64, 1),
                                              ((14, 28), 33, 3),
                                              ((24, 48), 16, 7)])
def test_tiers_equal_jax(shape, ps, objects):
    """naive row-walk == host tier == native tape == the region entry's
    plain version, in both packages, on random matrices and packed
    multi-object arenas."""
    rng = np.random.default_rng(SEED)
    for _trial in range(3):
        bm = rng.integers(0, 2, shape, dtype=np.uint8)
        pk = rng.integers(0, 256, (objects, shape[1], ps), dtype=np.uint8)
        want = jxsched.naive_xor_matmul(bm, pk)
        assert np.array_equal(xsched.naive_xor_matmul(bm, pk), want)
        sched = xsched.compile_matrix(bm)
        out = np.zeros((objects, shape[0], ps), dtype=np.uint8)
        xsched.execute_host(sched, [pk[:, i] for i in range(shape[1])],
                            [out[:, r] for r in range(shape[0])])
        assert np.array_equal(out, want)
        prog = xsched.lower_program(sched)
        arena = np.zeros((objects, prog.n_regions, ps), dtype=np.uint8)
        arena[:, :shape[1]] = pk
        ref_arena = arena.copy()
        plain = torch.from_numpy(arena.copy())
        xsched.execute_native(prog, arena)
        jxsched.execute_native(jxsched.lower_program(
            jxsched.compile_matrix(bm)), ref_arena)
        assert np.array_equal(arena, ref_arena)
        assert np.array_equal(arena[:, prog.out_base:], want)
        xor_kernels.xor_sched_regions(prog, plain)
        assert np.array_equal(plain.numpy(), arena)
        naive = xsched.naive_program(bm, f"naive-{_trial}-{shape}")
        flat = np.zeros((objects, naive.n_regions, ps), dtype=np.uint8)
        flat[:, :shape[1]] = pk
        xsched.execute_native(naive, flat)
        assert np.array_equal(flat[:, naive.out_base:], want)


def test_crc_spans_equal_jax():
    rng = np.random.default_rng(SEED)
    arena = rng.integers(0, 256, (3, 5, 64), dtype=np.uint8)
    spans = np.array([(0, 2, 0), (3, 1, 1), (5, 2, 0), (14, 1, 2)],
                     dtype=np.int32)
    mine = np.full(3, 0xFFFFFFFF, dtype=np.uint32)
    ref = mine.copy()
    xsched.crc_regions_native(arena, spans, mine)
    jxsched.crc_regions_native(arena, spans, ref)
    assert mine.tolist() == ref.tolist()


def test_native_kill_switch_and_stats(monkeypatch):
    assert xsched.native_available()
    monkeypatch.setenv("CEPH_TPU_NATIVE_XSCHED", "0")
    assert not xsched.native_available()
    st = plan.stats()["xsched"]
    assert set(st) == set(jplan.stats()["xsched"])
    assert st["native_enabled"] is False


# -- the kernel's own code, emulated -------------------------------------

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build the emulator")


def _region_jobs():
    rng = np.random.default_rng(SEED)
    jobs = {}
    for technique, k in (("liberation", 4), ("blaum_roth", 4),
                         ("liber8tion", 4)):
        bm = _bitmatrix(technique, k)
        w = TRIO[technique]
        for label, rows in (("encode", bm), ("decode 0 1",
                                             bmx.decode_bitmatrix(
                                                 bm, k, w, (2, 3, 4, 5),
                                                 (0, 1)))):
            prog = xsched.lower_program(xsched.compile_matrix(rows))
            jobs[f"{technique} {label}"] = (prog, (3, 2048), 16)
    dense = rng.integers(0, 2, (40, 80), dtype=np.uint8)
    jobs["naive tape past a staged chunk"] = (
        xsched.naive_program(dense, "emulated-dense"), (2, 256), 2)
    lib = xsched.lower_program(xsched.compile_matrix(_bitmatrix(
        "liberation", 4)))
    jobs["1-byte columns"] = (lib, (2, 1027), 3)
    jobs["packed one-stripe objects, blocks walk tiles"] = (lib, (96, 16),
                                                            5)
    return jobs


REGION_JOBS = _region_jobs()


@needs_gxx
def test_region_entry_emulated_equals_plain():
    """xs_regions_kernel itself: output regions equal the plain version,
    input regions unchanged, temporaries untouched."""
    rng = np.random.default_rng(SEED)
    cases, arenas = [], []
    for name, (prog, (objects, rbytes), target) in REGION_JOBS.items():
        arena = rng.integers(0, 256, (objects, prog.n_regions, rbytes),
                             dtype=np.uint8)
        cases.append(("regions", prog, arena, target))
        arenas.append((name, prog, arena))
    for (name, prog, arena), (got, threads, blocks) in zip(
            arenas, xsched_emulate.emulate_many(cases)):
        plain = torch.from_numpy(arena.copy())
        xor_kernels.xor_sched_regions_plain(prog, plain)
        base = prog.out_base
        assert np.array_equal(got[:, base:], plain.numpy()[:, base:]), name
        assert np.array_equal(got[:, :base], arena[:, :base]), name
        assert threads in (32, 64, 128) and blocks >= 1, name


def _gf_jobs():
    rng = np.random.default_rng(SEED)
    odd = np.array([[0, 0, 0], [1, 0, 0], [5, 7, 9]], dtype=np.uint8)
    jobs = {}
    for name in ("msr 4/3/6 rebuild 0", "msr 4/3/6 rebuild 6",
                 "msr 5/5/9 project 9", "rs 4+2"):
        jobs[name] = (GF_MATRICES[name], (2, 1028), 3)
    jobs["zero row and copy rows"] = (odd, (3, 64), 1)
    jobs["random 6 x 10"] = (rng.integers(0, 256, (6, 10), dtype=np.uint8),
                             (1, 520), 2)
    return jobs


GF_JOBS = _gf_jobs()


@needs_gxx
def test_gf_entry_emulated_equals_gf_product():
    """xs_gf_kernel itself on compiled programs of GF matrices: equal to
    the GF product (gf_matmul_ref), the plain version and the
    reference's host fold."""
    rng = np.random.default_rng(SEED)
    cases, inputs = [], []
    for name, (mat, (b, s), target) in GF_JOBS.items():
        prog = xsched.lower_program(xsched.compile_matrix(
            gf.gf_matrix_to_bits(mat)))
        data = rng.integers(0, 256, (b, mat.shape[1], s), dtype=np.uint8)
        cases.append(("gf", prog, data, target))
        inputs.append((name, mat, prog, data))
    for (name, mat, prog, data), (got, _threads, _blocks) in zip(
            inputs, xsched_emulate.emulate_many(cases)):
        want = np.stack([jgf.gf_matmul_host(mat, d) for d in data])
        assert np.array_equal(got, want), name
        plain = xor_kernels.xor_sched_gf(prog, torch.from_numpy(data))
        assert np.array_equal(plain.numpy(), want), name


# -- the branch-free tape and the redesigned kernel, emulated -------------

def _run_branch_free(dtape: np.ndarray, stride: int, a: torch.Tensor) -> None:
    """The kernel's tape over a (N, n_regions + 1, L) tensor whose last
    region is Z: r[dst] = r[a] ^ r[b], byte offsets back to regions."""
    for dst, x, y, _pad in dtape.tolist():
        a[:, dst // stride] = a[:, x // stride] ^ a[:, y // stride]


def _same_as_run_tape(prog, stride: int, seed: int) -> None:
    dtape = xor_kernels.branch_free_tape(prog, stride)
    z = prog.n_regions
    assert dtape.dtype == np.int32 and dtape.shape[1] == 4
    assert len(dtape) % xor_kernels.BATCH == 0
    assert len(dtape) - prog.n_ops < xor_kernels.BATCH
    assert (dtape[:, :3] % stride == 0).all() and (dtape[:, 3] == 0).all()
    assert (dtape[prog.n_ops:, :3] == z * stride).all()
    assert (dtape[:, 0] != z * stride)[:prog.n_ops].all()  # Z stays zero
    rng = np.random.default_rng(seed)
    want = torch.from_numpy(rng.integers(0, 256, (2, z + 1, 5),
                                         dtype=np.uint8))
    want[:, z] = 0
    got = want.clone()
    xor_kernels._run_tape(prog.tape, want[:, :z])
    _run_branch_free(dtape, stride, got)
    assert torch.equal(got[:, :z], want[:, :z])
    assert not got[:, z].any()


@st.composite
def _random_programs(draw):
    """Tapes of every form: XORs, copies, accumulates and zero fills, with
    dst drawn from the operands' own regions as often as not."""
    n_in = draw(st.integers(0, 6))
    n_slots = draw(st.integers(0, 4))
    n_out = draw(st.integers(1, 4))
    n_regions = n_in + n_slots + n_out
    writable = list(range(n_in, n_regions))
    region = st.integers(0, n_regions - 1)
    ops = []
    for _ in range(draw(st.integers(0, 40))):
        kind = draw(st.sampled_from(("xor", "copy", "acc", "zero")))
        a, b = draw(region), draw(region)
        dst = draw(st.sampled_from(writable))
        if draw(st.booleans()) and kind != "zero":
            alias = [r for r in ((a, b) if kind == "xor" else (a,))
                     if r >= n_in]
            dst = draw(st.sampled_from(alias)) if alias else dst
        ops.append({"xor": (dst, a, b), "copy": (dst, a, -1),
                    "acc": (dst, a, -2), "zero": (dst, -1, -1)}[kind])
    tape = np.asarray(ops, dtype=np.int32).reshape(-1, 3)
    return xsched.XorProgram(sig=f"random-{len(ops)}", n_in=n_in,
                             n_out=n_out, n_slots=n_slots,
                             n_regions=n_regions, tape=tape,
                             n_ops=len(ops))


@settings(max_examples=200, deadline=None)
@given(prog=_random_programs(), stride=st.sampled_from((32, 128, 512)),
       seed=st.integers(0, 2**32 - 1))
def test_branch_free_tape_equals_run_tape_on_random_tapes(prog, stride,
                                                          seed):
    """Every op form, dst aliasing a or b, in tape order: the kernel's
    tape computes what the original tape computes, region for region."""
    _same_as_run_tape(prog, stride, seed)


def _named_programs() -> dict:
    progs = {}
    for technique, k in TRIO_SPACE:
        bm = _bitmatrix(technique, k)
        w = TRIO[technique]
        have = tuple(range(2, k + 2))
        for label, rows in (("encode", bm), ("decode 0 1",
                                             bmx.decode_bitmatrix(
                                                 bm, k, w, have, (0, 1)))):
            progs[f"{technique} {k} {label}"] = xsched.lower_program(
                xsched.compile_matrix(rows))
        progs[f"{technique} {k} naive"] = xsched.naive_program(
            bm, f"naive-{technique}-{k}")
    for name, mat in GF_MATRICES.items():
        sched = plan._sched_for(mat)
        if sched is not None:
            progs[name] = xsched.lower_program(sched)
    return progs


NAMED_PROGRAMS = _named_programs()


@pytest.mark.parametrize("name", sorted(NAMED_PROGRAMS))
def test_branch_free_tape_equals_run_tape_on_programs(name):
    """The trio's encode, decode and naive tapes and the MSR and RS
    programs of the GF pick, at the region entry's 16-byte stride and the
    GF entry's plane stride."""
    prog = NAMED_PROGRAMS[name]
    for stride in (16 * xor_kernels.THREADS, xor_kernels.GF_STRIDE):
        _same_as_run_tape(prog, stride, SEED)


_LIB = REGION_JOBS["liberation encode"][0]
_DENSE_PROG = REGION_JOBS["naive tape past a staged chunk"][0]
# 220 inputs: two 16-byte input buffers do not fit a block, one does
_WIDE_PROG = xsched.naive_program(
    np.random.default_rng(SEED + 1).integers(0, 2, (24, 220),
                                             dtype=np.uint8),
    "emulated-wide-one-buffer")
# name: (program, (objects, region bytes), target, options, expected
# (column bytes, input buffers))
REDESIGN_REGION_JOBS = {
    "16-byte columns, ragged last tile": (_LIB, (3, 800), 4, {}, (16, 2)),
    "4-byte columns, ragged last tile": (_LIB, (2, 180), 3, {}, (4, 2)),
    "4-byte columns on a 16-byte arena": (_LIB, (2, 2048), 5,
                                          {"column_bytes": 4}, (4, 2)),
    "1-byte columns, ragged last tile": (_LIB, (3, 77), 2, {}, (1, 2)),
    "one-stripe arena (1, 45, 2048)": (_LIB, (1, 2048), 132, {}, (16, 2)),
    "packed batch, blocks walk tiles through both buffers": (
        _LIB, (40, 2048), 7, {}, (16, 2)),
    "tape longer than the resident chunk": (_DENSE_PROG, (3, 1040), 2, {},
                                            (16, 2)),
    "one input buffer, chunked tape": (_WIDE_PROG, (2, 1040), 3, {},
                                       (16, 1)),
}


@needs_gxx
@pytest.mark.parametrize("copies", ["late", "early"])
@pytest.mark.parametrize("name", sorted(REDESIGN_REGION_JOBS))
def test_region_entry_redesign_emulated(name, copies):
    """xs_regions_kernel on its branch-free tape, at each column width and
    layout the launcher picks, with the asynchronous copies landing as
    late or as early as the card may land them: outputs equal the plain
    version, inputs and temporaries untouched."""
    prog, (objects, rbytes), target, opts, (width, bufs) = \
        REDESIGN_REGION_JOBS[name]
    rng = np.random.default_rng(SEED + len(name))
    arena = rng.integers(0, 256, (objects, prog.n_regions, rbytes),
                         dtype=np.uint8)
    [(got, threads, blocks, got_width, got_bufs)] = \
        xsched_emulate.emulate_many(
            [("regions", prog, arena, target, {**opts, "copies": copies})],
            detail=True)
    plain = torch.from_numpy(arena.copy())
    xor_kernels.xor_sched_regions_plain(prog, plain)
    base = prog.out_base
    assert np.array_equal(got[:, base:], plain.numpy()[:, base:])
    assert np.array_equal(got[:, :base], arena[:, :base])
    tiles = objects * -(-(rbytes // width) // xor_kernels.THREADS)
    assert (threads, blocks) == (xor_kernels.THREADS, min(tiles, target))
    assert (got_width, got_bufs) == (width, bufs)
    if name.startswith(("tape longer", "one input")):
        assert prog.n_ops * bufs > 512  # past XS_TAPE_CHUNK


_GF_DENSE = np.random.default_rng(SEED + 2).integers(1, 256, (6, 8),
                                                     dtype=np.uint8)
# name: (matrix, (B, S), target, expected copy bytes)
REDESIGN_GF_JOBS = {
    "S % 32 == 16, 16-byte copies": (GF_MATRICES["msr 4/3/6 rebuild 0"],
                                     (2, 1040), 3, 16),
    "S % 16 == 8, 4-byte copies, blocks walk tiles": (
        GF_MATRICES["msr 4/3/6 rebuild 6"], (3, 1000), 2, 4),
    "S % 16 == 4 over several tiles": (GF_MATRICES["msr 5/5/9 project 9"],
                                       (1, 3092), 2, 4),
    "S = 4": (GF_MATRICES["rs 4+2"], (5, 4), 3, 4),
    "S = 3 x 1024, whole tiles": (GF_MATRICES["msr 4/3/6 rebuild 4"],
                                  (2, 3072), 4, 16),
    "tape longer than the resident chunk": (_GF_DENSE, (2, 2064), 3, 16),
}


@needs_gxx
@pytest.mark.parametrize("copies", ["late", "early"])
@pytest.mark.parametrize("name", sorted(REDESIGN_GF_JOBS))
def test_gf_entry_bitsliced_emulated(name, copies):
    """xs_gf_kernel, bit-sliced, on chunk sizes that are no multiple of 32
    (a ragged last tile, 4-byte copies that stop at the row's end), whole
    tiles and a chunked tape: equal to the GF product of the reference's
    host fold and to the plain version."""
    mat, (b, s), target, cp = REDESIGN_GF_JOBS[name]
    sched = xsched.compile_matrix(gf.gf_matrix_to_bits(mat),
                                  sig=f"emulated-gf-{name}")
    prog = xsched.lower_program(sched)
    if name.startswith("tape longer"):
        assert prog.n_ops > 512  # past XS_TAPE_CHUNK
    rng = np.random.default_rng(SEED + len(name))
    data = rng.integers(0, 256, (b, mat.shape[1], s), dtype=np.uint8)
    [(got, threads, blocks, got_cp, _bufs)] = xsched_emulate.emulate_many(
        [("gf", prog, data, target, {"copies": copies})], detail=True)
    want = np.stack([jgf.gf_matmul_host(mat, d) for d in data])
    assert np.array_equal(got, want)
    plain = xor_kernels.xor_sched_gf_plain(prog, torch.from_numpy(data))
    assert np.array_equal(plain.numpy(), want)
    assert got_cp == cp
    assert (threads, blocks) == (xor_kernels.THREADS,
                                 min(b * -(-s // 1024), target))
