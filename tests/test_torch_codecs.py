"""The port's erasure-code plugin family (lrc, shec, clay, ec_msr) against
the JAX package's, on the CPU.

Every case builds one profile twice, through
ceph_tpu.ec.registry.create_erasure_code and through the port's registry
with `device="cpu"` (the GF kernels' plain versions), and holds the two
to each other: matrices, geometry, chunk mapping, chunks, decodes,
minimum_to_decode answers, CLAY's sub-chunk repair, MSR's fractional
repair and the LRC crush rules.  Inputs come from numpy generators with
fixed seeds; every output is bytes, integers or errnos, so the tolerance
is exact equality.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from ceph_tpu.crush.map import build_flat_cluster as jbuild_flat_cluster
from ceph_tpu.ec.interface import ErasureCodeError as JErasureCodeError
from ceph_tpu.ec.registry import create_erasure_code as jcreate
from ceph_tpu.ops import gf_pallas
from ceph_tpu.osd.osdmap import OSDMap as JOSDMap
from ceph_tpu.osd.osdmap import PgId as JPgId
from ceph_tpu_torch.crush import kernel as crush_kernel
from ceph_tpu_torch.crush.map import build_flat_cluster
from ceph_tpu_torch.ec import dispatch, plan
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import create_erasure_code
from ceph_tpu_torch.ec.torch_plugin import ErasureCodeTorch
from ceph_tpu_torch.ops import gf, gf_kernels
from ceph_tpu_torch.osd.osdmap import (OSDMap, OSDMapMapping, PgId,
                                       TYPE_ERASURE)

SEED = 20261017
# BASELINE config 3: k=8 m=4 l=4 as explicit layers (the kml shorthand
# cannot express it: (k+m)/l = 3 groups do not divide k=8)
CONFIG3 = {"plugin": "lrc", "mapping": "DDDDDDDD____",
           "layers": json.dumps([["DDDDDDDDcc__", ""], ["DDDD______c_", ""],
                                 ["____DDDD___c", ""]])}
PROFILES = {
    "lrc 4/2/3": {"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
    "lrc 8/4/6": {"plugin": "lrc", "k": "8", "m": "4", "l": "6"},
    "lrc config 3": CONFIG3,
    "lrc explicit": {"plugin": "lrc", "mapping": "DDD__",
                     "layers": '[["DDDc_", ""], ["DDD_c", ""]]'},
    "lrc cascade": {"plugin": "lrc", "mapping": "__DDD__DD",
                    "layers": '[ [ "_cDDD_cDD", "" ], [ "c_DDD____", "" ],'
                              ' [ "_____cDDD", "" ], ]'},
    "shec 4/3/2 multiple": {"plugin": "shec", "k": "4", "m": "3", "c": "2"},
    "shec 4/3/2 single": {"plugin": "shec", "k": "4", "m": "3", "c": "2",
                          "technique": "single"},
    "clay 4/2/5": {"plugin": "clay", "k": "4", "m": "2", "d": "5"},
    "clay 8/4/11": {"plugin": "clay", "k": "8", "m": "4", "d": "11"},
    "clay 4/2/5 shec": {"plugin": "clay", "k": "4", "m": "2", "d": "5",
                        "scalar_mds": "shec"},
    "msr 2/2/3": {"plugin": "ec_msr", "k": "2", "m": "2", "d": "3"},
    "msr 4/3/6": {"plugin": "ec_msr", "k": "4", "m": "3", "d": "6"},
    "msr 5/5/9": {"plugin": "ec_msr", "k": "5", "m": "5", "d": "9"},
}
CLAY = [name for name in PROFILES if name.startswith("clay")]
MSR = [name for name in PROFILES if name.startswith("msr")]
MAX_SETS = 40   # erasure sets per profile past which a seeded sample runs


@pytest.fixture(autouse=True, scope="module")
def restore_registered_generators():
    """Leave both packages' process-wide tables of registered generators
    as the module found them.  The codecs here register dozens (every
    LRC layer, every CLAY sub-codec), and other test files in the same
    worker assert that a matrix is or is not registered (tables capped
    at 64 entries; RS(4, 1) is a decode row elsewhere)."""
    jax_saved = set(gf_pallas._registered)
    port_saved = dict(gf_kernels._registered)
    yield
    gf_pallas._registered.clear()
    gf_pallas._registered.update(jax_saved)
    gf_kernels._registered.clear()
    gf_kernels._registered.update(port_saved)


def _pair(name: str):
    profile = PROFILES[name]
    return (jcreate(dict(profile)),
            create_erasure_code({**profile, "device": "cpu"}))


def _matrices(codec) -> dict:
    """The codec's state as numpy arrays: its generator(s) and, for the
    composite codecs, those of the codecs it is built from."""
    if hasattr(codec, "layers"):
        return {f"layer {i}": layer.erasure_code.matrix
                for i, layer in enumerate(codec.layers)}
    if hasattr(codec, "mds"):
        return {"mds": codec.mds.matrix, "pft": codec.pft_matrix}
    if hasattr(codec, "gen"):
        return {"gen": codec.gen, "parity": codec.parity_mat}
    return {"matrix": codec.matrix}


def _object(codec, seed: int) -> bytes:
    """Two alignment units and a ragged tail: padding in the last chunk."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, 2 * codec.get_alignment() + 17,
                        dtype=np.uint8).tobytes()


def _erasure_sets(n: int, m: int, seed: int) -> list:
    sets = [c for r in range(1, m + 1)
            for c in itertools.combinations(range(n), r)]
    if len(sets) <= MAX_SETS:
        return sets
    rng = np.random.default_rng(seed)
    singles = [s for s in sets if len(s) == 1]
    rest = [s for s in sets if len(s) > 1]
    pick = rng.choice(len(rest), MAX_SETS - len(singles), replace=False)
    return singles + [rest[i] for i in sorted(pick)]


def _outcome(fn):
    """A call's result, or the errno of the ErasureCodeError it raised."""
    try:
        return fn()
    except (ErasureCodeError, JErasureCodeError) as e:
        return ("errno", e.errno)


def _as_bytes(chunks: dict) -> dict:
    return {i: bytes(v) for i, v in chunks.items()}


@pytest.mark.parametrize("name", PROFILES)
def test_geometry_and_matrices_match_jax(name):
    jc, tc = _pair(name)
    for key, mat in _matrices(jc).items():
        assert np.array_equal(np.asarray(mat), _matrices(tc)[key]), key
    for attr in ("get_chunk_count", "get_data_chunk_count",
                 "get_coding_chunk_count", "get_sub_chunk_count",
                 "get_alignment", "get_chunk_mapping",
                 "supports_fractional_repair"):
        assert getattr(tc, attr)() == getattr(jc, attr)(), attr
    sub = tc.get_sub_chunk_count()
    for size in (1, 4096, 100_000, 1 << 20):
        chunk = tc.get_chunk_size(size)
        assert chunk == jc.get_chunk_size(size), size
        # what the GF kernels take: sub-chunks of a multiple of 4 bytes
        # (S % 4 == 0), and here of 32
        assert chunk % sub == 0 and (chunk // sub) % 32 == 0, (size, chunk)


@pytest.mark.parametrize("name", PROFILES)
def test_chunks_match_jax(name):
    jc, tc = _pair(name)
    n = tc.get_chunk_count()
    obj = _object(tc, SEED)
    want = set(range(n))
    chunks = _as_bytes(tc.encode(want, obj))
    assert chunks == _as_bytes(jc.encode(want, obj))
    assert bytes(tc.decode_concat(chunks))[:len(obj)] == obj


@pytest.mark.parametrize("name", PROFILES)
def test_decodes_match_jax(name):
    """Every erasure set up to the coding count (a seeded sample past
    MAX_SETS): the recovered chunks equal the JAX codec's and the
    originals, or both codecs refuse with the same errno."""
    jc, tc = _pair(name)
    n, m = tc.get_chunk_count(), tc.get_coding_chunk_count()
    full = _as_bytes(tc.encode(set(range(n)), _object(tc, SEED + 1)))
    recovered = 0
    for lost in _erasure_sets(n, m, SEED):
        avail = {i: c for i, c in full.items() if i not in lost}
        got = _outcome(lambda: _as_bytes(tc.decode(set(lost), avail)))
        assert got == _outcome(lambda: _as_bytes(jc.decode(set(lost),
                                                           avail))), lost
        if isinstance(got, dict):
            assert got == {i: full[i] for i in lost}, lost
            recovered += 1
    assert recovered > 0


@pytest.mark.parametrize("name", PROFILES)
def test_minimum_to_decode_matches_jax(name):
    jc, tc = _pair(name)
    n, m = tc.get_chunk_count(), tc.get_coding_chunk_count()
    k = tc.get_data_chunk_count()
    for lost in _erasure_sets(n, m, SEED + 2):
        avail = set(range(n)) - set(lost)
        for want in ({lost[0]}, set(lost), {tc.chunk_index(i)
                                             for i in range(k)}):
            assert _outcome(lambda: tc.minimum_to_decode(want, avail)) == \
                _outcome(lambda: jc.minimum_to_decode(want, avail)), (lost,
                                                                      want)


@pytest.mark.parametrize("name", CLAY)
def test_clay_repair_matches_jax(name):
    """Single-node repair from d helpers that send only the sub-chunk
    ranges minimum_to_decode names."""
    jc, tc = _pair(name)
    n = tc.get_chunk_count()
    full = _as_bytes(tc.encode(set(range(n)), _object(tc, SEED + 3)))
    chunk_size = len(full[0])
    sc = chunk_size // tc.get_sub_chunk_count()
    for lost in range(n):
        avail = set(range(n)) - {lost}
        minimum = tc.minimum_to_decode({lost}, avail)
        assert minimum == jc.minimum_to_decode({lost}, avail)
        assert len(minimum) == tc.d
        partial = {node: b"".join(full[node][off * sc:(off + cnt) * sc]
                                  for off, cnt in ranges)
                   for node, ranges in minimum.items()}
        assert len(next(iter(partial.values()))) < chunk_size
        got = _as_bytes(tc.decode({lost}, partial, chunk_size=chunk_size))
        assert got == _as_bytes(jc.decode({lost}, partial,
                                          chunk_size=chunk_size))
        assert got == {lost: full[lost]}


@pytest.mark.parametrize("name", MSR)
def test_msr_repair_matches_jax(name):
    """repair_project, repair_syms and repair of every lost chunk, from
    the helpers minimum_to_repair picks."""
    jc, tc = _pair(name)
    n = tc.get_chunk_count()
    full = _as_bytes(tc.encode(set(range(n)), _object(tc, SEED + 4)))
    for lost in range(n):
        avail = set(range(n)) - {lost}
        helpers = tc.minimum_to_repair(lost, avail)
        assert helpers == jc.minimum_to_repair(lost, avail)
        frags = {h: tc.repair_project(lost, full[h]) for h in helpers}
        assert frags == {h: jc.repair_project(lost, full[h])
                         for h in helpers}
        order = tuple(sorted(frags))
        stacked = np.stack([np.frombuffer(frags[h], np.uint8)
                            for h in order])
        assert np.array_equal(tc.repair_syms(lost, order, stacked),
                              np.asarray(jc.repair_syms(lost, order,
                                                        stacked)))
        assert tc.repair(lost, frags) == jc.repair(lost, frags) == full[lost]


def _crush_maps(racks: bool):
    per_rack = 2 if racks else 0
    return (jbuild_flat_cluster(16, osds_per_host=2, hosts_per_rack=per_rack),
            build_flat_cluster(16, osds_per_host=2, hosts_per_rack=per_rack))


@pytest.mark.parametrize("extra", [
    {}, {"crush-failure-domain": "osd"},
    {"crush-locality": "rack", "crush-failure-domain": "host"},
    {"crush-steps": '[["choose", "rack", 2], ["chooseleaf", "host", 4]]'}],
    ids=["default", "osd", "locality", "steps"])
def test_lrc_create_rule_matches_jax(extra):
    profile = {"plugin": "lrc", "k": "4", "m": "2", "l": "3", **extra}
    if "crush-steps" in extra:
        profile = {**CONFIG3, **extra}
    jc = jcreate(dict(profile))
    tc = create_erasure_code({**profile, "device": "cpu"})
    jmap, tmap = _crush_maps(racks=bool(extra) and "osd" not in str(extra))
    jno, tno = jc.create_rule("lrc", jmap), tc.create_rule("lrc", tmap)
    assert tno == jno >= 0
    jr, tr = jmap.rules[jno], tmap.rules[tno]
    assert [(s.op, s.arg1, s.arg2) for s in tr.steps] == \
        [(s.op, s.arg1, s.arg2) for s in jr.steps]
    assert tr.rule_type == jr.rule_type == 3
    assert tc.create_rule("lrc", tmap) == jc.create_rule("lrc", jmap) == -17


def test_lrc_locality_pool_goes_to_the_host_mapper():
    """A two-step locality rule is not the placement kernel's: the pool's
    PGs are placed by the host mapper, equal to the JAX map's."""
    profile = {"plugin": "lrc", "k": "4", "m": "2", "l": "3",
               "crush-locality": "rack", "crush-failure-domain": "host"}
    maps = []
    for cls, create, dev in ((JOSDMap, jcreate, {}),
                             (OSDMap, create_erasure_code, {"device": "cpu"})):
        m = cls.build_simple(24, osds_per_host=2)
        m.crush = (jbuild_flat_cluster if cls is JOSDMap
                   else build_flat_cluster)(24, osds_per_host=2,
                                            hosts_per_rack=4)
        codec = create({**profile, **dev})
        ruleno = codec.create_rule("lrc", m.crush)
        m.erasure_code_profiles["lrc"] = profile
        m.create_pool("lrcpool", type_=TYPE_ERASURE,
                      size=codec.get_chunk_count(), pg_num=32,
                      crush_rule=ruleno, erasure_code_profile="lrc")
        maps.append((m, ruleno, codec.get_chunk_count()))
    (jm, _, _), (tm, ruleno, size) = maps
    with pytest.raises(NotImplementedError, match="host mapper"):
        crush_kernel.rule_program(tm.crush, ruleno, size)
    mapping = OSDMapMapping(tm, device="cpu")
    pool = tm.lookup_pool("lrcpool")
    for ps in range(32):
        got = mapping.get(PgId(pool, ps))
        assert got == tm.pg_to_up_acting_osds(PgId(pool, ps))
        assert got == jm.pg_to_up_acting_osds(JPgId(pool, ps)), ps
        assert sum(o >= 0 for o in got[0]) == size


def test_profile_errors_match_jax():
    cases = [
        # SHEC validation (tests/test_shec.py)
        {"plugin": "shec", "k": "4", "m": "3"},
        {"plugin": "shec", "k": "0", "m": "3", "c": "2"},
        {"plugin": "shec", "k": "4", "m": "0", "c": "2"},
        {"plugin": "shec", "k": "4", "m": "3", "c": "0"},
        {"plugin": "shec", "k": "4", "m": "3", "c": "4"},
        {"plugin": "shec", "k": "13", "m": "3", "c": "2"},
        {"plugin": "shec", "k": "12", "m": "12", "c": "2"},
        {"plugin": "shec", "k": "3", "m": "4", "c": "2"},
        {"plugin": "shec", "k": "x", "m": "3", "c": "2"},
        {"plugin": "shec", "k": "4", "m": "3", "c": "2",
         "technique": "bogus"},
        # LRC kml and layers
        {"plugin": "lrc", "k": "4", "m": "2", "l": "4"},
        {"plugin": "lrc", "k": "5", "m": "1", "l": "3"},
        {"plugin": "lrc", "k": "4", "m": "2"},
        {"plugin": "lrc", "k": "4", "m": "2", "l": "x"},
        {"plugin": "lrc", "k": "4", "m": "2", "l": "3",
         "mapping": "DD__DD__"},
        {"plugin": "lrc"},
        {"plugin": "lrc", "layers": '[["DDc",""]]'},
        {"plugin": "lrc", "mapping": "DD_", "layers": "not json"},
        {"plugin": "lrc", "mapping": "DD_", "layers": '[["DDc_", ""]]'},
        # CLAY and MSR
        {"plugin": "clay", "k": "4", "m": "2", "d": "6"},
        {"plugin": "clay", "k": "4", "m": "2", "scalar_mds": "bogus"},
        {"plugin": "ec_msr", "k": "4", "m": "3", "d": "3"},
        {"plugin": "ec_msr", "k": "4", "m": "3", "d": "7"},
        {"plugin": "ec_msr", "k": "4", "m": "3", "d": "6", "w": "16"},
    ]
    for profile in cases:
        got = _outcome(lambda: create_erasure_code({**profile,
                                                    "device": "cpu"}))
        assert got == _outcome(lambda: jcreate(dict(profile))), profile
        assert isinstance(got, tuple), profile


@pytest.mark.parametrize("technique", ["liberation", "blaum_roth",
                                       "liber8tion"])
def test_bitmatrix_techniques_equal_jax(technique):
    """The jerasure bitmatrix techniques build the port's bitmatrix codec
    (once refused with errno 2): profile, geometry, every chunk and the
    decode of every one- and two-erasure pattern equal the JAX codec's."""
    profile = {"plugin": "jerasure", "technique": technique, "k": "4",
               "m": "2", "packetsize": "64"}
    tc = create_erasure_code({**profile, "device": "cpu"})
    jc = jcreate(dict(profile))
    assert type(tc).__name__ == "ErasureCodeTorchBitmatrix"
    assert {k: v for k, v in tc.get_profile().items() if k != "device"} \
        == jc.get_profile()
    assert np.array_equal(tc.bitmatrix, jc.bitmatrix)
    assert tc.get_alignment() == jc.get_alignment()
    n = tc.get_chunk_count()
    data = np.random.default_rng(SEED).bytes(2 * tc.get_alignment() + 17)
    tchunks, jchunks = tc.encode(range(n), data), jc.encode(range(n), data)
    assert [bytes(tchunks[i]) for i in range(n)] == \
        [bytes(jchunks[i]) for i in range(n)]
    size = len(jchunks[0])
    for lost in itertools.chain.from_iterable(
            itertools.combinations(range(n), r) for r in (1, 2)):
        have = {i: bytes(jchunks[i]) for i in range(n) if i not in lost}
        got = tc.decode(set(lost), have, size)
        want = jc.decode(set(lost), have, size)
        assert {i: bytes(got[i]) for i in lost} == \
            {i: bytes(want[i]) for i in lost}, lost


@pytest.mark.parametrize("name", PROFILES)
def test_device_reaches_every_sub_codec(name):
    _jc, tc = _pair(name)
    assert tc.get_profile()["device"] == "cpu"
    subs = [tc]
    if hasattr(tc, "layers"):
        subs += [layer.erasure_code for layer in tc.layers]
    if hasattr(tc, "mds"):
        subs.append(tc.mds)
    assert all(c.device.type == "cpu" for c in subs)


@pytest.mark.parametrize("plugin", ["lrc", "shec", "clay", "ec_msr"])
def test_no_silent_cpu(monkeypatch, plugin):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    profile = {"plugin": plugin}
    if plugin == "lrc":
        profile.update(k="4", m="2", l="3")
    with pytest.raises(RuntimeError):
        create_erasure_code(profile)


@pytest.mark.parametrize("shape", [(25, 70), (16, 64), (17, 64), (16, 65),
                                   (1, 130)])
def test_plan_tiles_wide_products(monkeypatch, shape):
    """A product past one launch's R <= 16, K <= 64 runs as launches of
    at most that, rows into their slices of the output and inputs
    XOR-accumulated, equal to the numpy oracle."""
    r, k = shape
    rng = np.random.default_rng(SEED + r * 1000 + k)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    data = rng.integers(0, 256, (3, k, 96), dtype=np.uint8)
    launches = []
    real = gf.gf_matmul_device

    def spy(m, d):
        launches.append(np.shape(m))
        return real(m, d)

    monkeypatch.setattr(gf, "gf_matmul_device", spy)
    got = plan.matmul(mat, data, torch.device("cpu"))
    assert np.array_equal(got, np.stack([gf.gf_matmul_ref(mat, d)
                                         for d in data]))
    assert len(launches) == -(-r // gf_kernels.MAX_R) * -(-k
                                                          // gf_kernels.MAX_K)
    assert all(a <= gf_kernels.MAX_R and b <= gf_kernels.MAX_K
               for a, b in launches)
    # (D, S) fragments, as MSR's repair hands them, take the same tiling
    assert np.array_equal(
        dispatch.gf_matmul(mat, data[0], torch.device("cpu")),
        gf.gf_matmul_ref(mat, data[0]))


@pytest.mark.parametrize("name", ["clay 4/2/5", "clay 8/4/11"])
def test_clay_decodes_batch_its_planes(monkeypatch, name):
    """CLAY's MDS sub-codec is an ErasureCodeTorch, so each group of
    planes that share an intersection score goes to its decode_batch in
    one call: as many calls as groups, every plane once, and no
    plane-by-plane decode_chunks."""
    _jc, tc = _pair(name)
    n = tc.get_chunk_count()
    full = _as_bytes(tc.encode(set(range(n)), _object(tc, SEED + 5)))
    calls, per_plane = [], []
    real = ErasureCodeTorch.decode_batch

    def spy(self, have, erasures, survivors):
        calls.append(survivors.shape[0])
        return real(self, have, erasures, survivors)

    monkeypatch.setattr(ErasureCodeTorch, "decode_batch", spy)
    monkeypatch.setattr(tc.mds, "decode_chunks",
                        lambda *a: per_plane.append(a))
    for lost in ({0}, {1, n - 1}):
        calls.clear()
        avail = {i: c for i, c in full.items() if i not in lost}
        assert _as_bytes(tc.decode(lost, avail)) == {i: full[i]
                                                      for i in lost}
        erased = {i if i < tc.k else i + tc.nu for i in lost}
        for i in range(tc.k + tc.nu, tc.q * tc.t):
            if len(erased) < tc.m:
                erased.add(i)
        groups = len({i // tc.q for i in erased}) + 1
        assert 1 <= len(calls) <= groups
        assert sum(calls) == tc.get_sub_chunk_count()
    assert per_plane == []
