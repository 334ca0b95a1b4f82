"""The port's OSD map (ceph_tpu_torch.common.encoding, osd/osdmap,
tools/osdmaptool) against the JAX package, on the CPU.

Every map is built the same way, from a seed, in both packages.  The
port's `OSDMapMapping(m, device="cpu")` runs the placement kernel's plain
PyTorch version; it is held against the JAX host path,
`OSDMap.pg_to_up_acting_osds`, never against the JAX `OSDMapMapping`,
which differs from that host path on some pools (ROADMAP.md C3, pinned
below).  Encoded maps, placements and tool output are bytes or integers,
so the tolerance is exact equality throughout.  The JAX tests of
tests/test_osdmap.py are also replayed against the port's names.
"""

import contextlib
import functools
import inspect
import io
import types

import numpy as np
import pytest
import torch

import test_osdmap as jax_cases
from ceph_tpu.common import encoding as jenc
from ceph_tpu.crush import map as jmap
from ceph_tpu.osd import osdmap as josdmap
from ceph_tpu.tools import osdmaptool as jtool
from ceph_tpu_torch.common import encoding as tenc
from ceph_tpu_torch.crush import kernel as tkernel
from ceph_tpu_torch.crush import map as tmap
from ceph_tpu_torch.osd import osdmap as tosdmap
from ceph_tpu_torch.tools import osdmaptool as ttool

SEED = 20261017
PACKAGES = {"jax": (josdmap, jmap), "port": (tosdmap, tmap)}


# -- encoding --------------------------------------------------------------


def _primitives(enc_cls):
    enc = enc_cls()
    enc.u8(7)
    enc.u16(0xBEEF)
    enc.u32(0xDEADBEEF)
    enc.u32(-1)
    enc.u64(-2)
    enc.s32(-5)
    enc.s64(-12345678901234)
    enc.f64(3.5)
    enc.bool(True)
    enc.string("héllo")
    enc.bytes(b"\x00\x01")
    enc.bytes(memoryview(b"view"))
    enc.list([1, 2, 3], enc_cls.u16)
    enc.map({"a": 1, "b": 2}, enc_cls.string, enc_cls.u32)
    enc.optional(None, enc_cls.u32)
    enc.optional(9, enc_cls.u32)
    return enc.to_bytes()


def _blocks(enc_cls):
    """Nested versioned blocks with data after them."""
    enc = enc_cls()
    enc.start(2, 1)
    enc.u32(42)
    enc.start(5, 3)
    enc.string("inner")
    enc.finish()
    enc.string("new field an old decoder skips")
    enc.finish()
    enc.u32(777)
    return enc.to_bytes()


@pytest.mark.parametrize("build", [_primitives, _blocks])
def test_encoder_writes_the_jax_bytes(build):
    assert build(tenc.Encoder) == build(jenc.Encoder)


def test_decoder_reads_the_jax_bytes():
    dec = tenc.Decoder(_primitives(jenc.Encoder))
    assert [dec.u8(), dec.u16(), dec.u32(), dec.u32(), dec.u64(), dec.s32(),
            dec.s64(), dec.f64(), dec.bool(), dec.string(), dec.bytes(),
            bytes(dec.bytes_view()), dec.list(tenc.Decoder.u16),
            dec.map(tenc.Decoder.string, tenc.Decoder.u32),
            dec.optional(tenc.Decoder.u32), dec.optional(tenc.Decoder.u32)
            ] == [7, 0xBEEF, 0xDEADBEEF, 0xFFFFFFFF, 2**64 - 2, -5,
                  -12345678901234, 3.5, True, "héllo", b"\x00\x01", b"view",
                  [1, 2, 3], {"a": 1, "b": 2}, None, 9]
    assert dec.remaining() == 0
    dec = tenc.Decoder(_blocks(jenc.Encoder))
    assert dec.start(1) == 2 and dec.u32() == 42
    dec.finish()                        # skips the inner block and the tail
    assert dec.u32() == 777


def _compat_newer(mod):
    enc = mod.Encoder()
    enc.start(5, 3)
    enc.u32(1)
    enc.finish()
    mod.Decoder(enc.to_bytes()).start(2)


def _exhausted(mod):
    mod.Decoder(b"\x01\x00").u32()


def _length_past_buffer(mod):
    mod.Decoder(b"\x01\x01\xff\x00\x00\x00\x00").start(1)


def _short_string(mod):
    mod.Decoder(b"\x05\x00\x00\x00abc").string()


@pytest.mark.parametrize("case", [_compat_newer, _exhausted,
                                  _length_past_buffer, _short_string])
def test_decoder_rejects_what_jax_rejects(case):
    with pytest.raises(jenc.DecodeError):
        case(jenc)
    with pytest.raises(tenc.DecodeError):
        case(tenc)


# -- the same seeded maps in both packages ----------------------------------


def _scenario(pkg: str, name: str):
    """A 24-OSD map (6 hosts) with a replicated pool (size 3, 64 PGs) and
    an EC pool (indep over hosts, size 6, 32 PGs), altered as `name` says;
    every choice comes from SEED, so both packages build the same map."""
    om, _cm = PACKAGES[pkg]
    rng = np.random.default_rng(SEED)
    m = om.OSDMap.build_simple(24, osds_per_host=4)
    m.erasure_code_profiles["p42"] = {"plugin": "jerasure", "k": "4",
                                      "m": "2"}
    m.create_pool("rep", size=3, pg_num=64)
    m.create_pool("ec", type_=om.TYPE_ERASURE, size=6, pg_num=32,
                  crush_rule=m.crush.add_simple_rule(
                      "ec", "default", "host", "", "indep",
                      pool_type="erasure"),
                  erasure_code_profile="p42")
    osds = rng.permutation(24).tolist()
    down, out, half = osds[:3], osds[3:6], osds[6:8]
    pgs = [om.PgId(1 + i % 2, int(ps)) for i, ps in
           enumerate(rng.integers(0, 32, 8))]
    every = name == "all"
    if name in ("down_out", "all"):
        for o in down:
            m.osd_state[o] &= ~om.CEPH_OSD_UP
        for o in out:
            m.osd_weight[o] = 0
        for o in half:
            m.osd_weight[o] = 0x8000
    if name in ("pg_temp", "all"):
        m.pg_temp[pgs[0]] = osds[10:13]
        m.pg_temp[pgs[1]] = [down[0]] + osds[13:18]
        m.pg_temp[pgs[2]] = osds[18:21]
        m.primary_temp[pgs[2]] = osds[19]
        m.primary_temp[pgs[3]] = osds[20]
    if name in ("upmap", "all"):
        m.pg_upmap[pgs[4]] = osds[8:11] if pgs[4].pool == 1 else osds[8:14]
        m.pg_upmap[pgs[5]] = [out[0]] + osds[9:11]      # rejected: out
        m.pg_upmap_items[pgs[5]] = [(osds[12], osds[13])]
        for pg in pgs[5:]:
            up = m.pg_to_up_acting_osds(pg)[0]
            spare = [o for o in osds[8:] if o not in up]
            m.pg_upmap_items.setdefault(pg, []).append((up[1], spare[0]))
    if name in ("primary_affinity", "all"):
        m.osd_primary_affinity = [
            int(a) for a in rng.choice([0, 0x4000, 0x8000, 0x10000], 24)]
    if name in ("incremental", "all"):
        inc = om.Incremental(epoch=m.epoch + 1)
        inc.new_state[osds[21]] = om.CEPH_OSD_UP       # XOR: down
        inc.new_weight[osds[22]] = 0
        inc.new_pg_temp[pgs[6]] = osds[14:17]
        inc.new_primary_temp[pgs[6]] = osds[15]
        inc.new_pg_upmap_items[pgs[7]] = [(osds[0], osds[23])]
        inc.new_erasure_code_profiles["p21"] = {"k": "2", "m": "1"}
        m.apply_incremental(inc)
        if every:
            inc2 = om.Incremental(epoch=m.epoch + 1)
            inc2.new_pg_temp[pgs[0]] = []                 # removes
            inc2.old_pg_upmap.append(pgs[4])
            m.apply_incremental(inc2)
    return m


SCENARIOS = ["healthy", "down_out", "pg_temp", "upmap", "primary_affinity",
             "incremental", "all"]


def _all_pgs(m):
    return [tosdmap.PgId(pid, ps) for pid, pool in m.pools.items()
            for ps in range(pool.pg_num)]


def _jpg(pg):
    return josdmap.PgId(pg.pool, pg.ps)


@pytest.mark.parametrize("name", SCENARIOS)
def test_osdmap_encodes_to_the_jax_bytes(name):
    jm, tm = _scenario("jax", name), _scenario("port", name)
    data = tm.encode()
    assert data == jm.encode()
    # each package decodes the other's bytes into the same map
    from_jax = tosdmap.OSDMap.decode(jm.encode())
    from_port = josdmap.OSDMap.decode(data)
    assert from_jax.encode() == data == from_port.encode()
    assert (from_jax.pg_temp, from_jax.pg_upmap_items) == (
        tm.pg_temp, tm.pg_upmap_items)
    assert from_jax.osd_primary_affinity == tm.osd_primary_affinity


@pytest.mark.parametrize("name", SCENARIOS)
def test_host_path_matches_jax_on_every_pg(name):
    jm, tm = _scenario("jax", name), _scenario("port", name)
    for pg in _all_pgs(tm):
        assert tm.pg_to_up_acting_osds(pg) == jm.pg_to_up_acting_osds(
            _jpg(pg)), pg


@pytest.mark.parametrize("name", SCENARIOS)
def test_mapping_matches_the_jax_host_path(name):
    jm, tm = _scenario("jax", name), _scenario("port", name)
    mapping = tosdmap.OSDMapMapping(tm, device="cpu")
    want = {}
    for pg in _all_pgs(tm):
        want[pg] = jm.pg_to_up_acting_osds(_jpg(pg))
        assert mapping.get(pg) == want[pg], pg
    by_osd = {}
    for pg, (up, *_rest) in want.items():
        for o in up:
            if o != tmap.CRUSH_ITEM_NONE:
                by_osd.setdefault(o, []).append(pg)
    assert mapping.pgs_by_osd() == by_osd


def test_mapping_flattens_the_map_once_per_update(monkeypatch):
    """One DenseMap serves both pools' rules and sizes of an update."""
    m = _scenario("port", "down_out")
    m.create_pool("rep2", size=2, pg_num=16)
    built = []
    real = tkernel.DenseMap.from_crush_map

    def count(*args, **kw):
        built.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(tkernel.DenseMap, "from_crush_map", count)
    mapping = tosdmap.OSDMapMapping(m, device="cpu")
    assert len(built) == 1
    for pg in _all_pgs(m):
        assert mapping.get(pg) == m.pg_to_up_acting_osds(pg)


def test_cached_map_follows_incrementals():
    """The placement memo keys on the epoch: an OSD marked down through
    an incremental is gone from the next answer, in both packages."""
    for pkg in PACKAGES:
        om, _cm = PACKAGES[pkg]
        m = _scenario(pkg, "healthy")
        m.enable_placement_cache()
        pg = om.PgId(2, 5)
        before = m.pg_to_up_acting_osds(pg)
        victim = before[0][1]
        inc = om.Incremental(epoch=m.epoch + 1)
        inc.new_state[victim] = om.CEPH_OSD_UP
        m.apply_incremental(inc)
        after = m.pg_to_up_acting_osds(pg)
        assert after[0][1] == tmap.CRUSH_ITEM_NONE
        assert after[0][:1] + after[0][2:] == before[0][:1] + before[0][2:]


def _reweighted_crush(pkg: str, crush, rng):
    """A copy of `crush` with one straw2 host's first item at half its
    weight (what an `osd crush reweight` commits as new_crush)."""
    from ceph_tpu.crush import serialize as jser
    from ceph_tpu_torch.crush import serialize as tser
    ser = jser if pkg == "jax" else tser
    doc = ser.to_json(crush)
    hosts = [b for b in doc["buckets"] if b["items"]
             and all(i >= 0 for i in b["items"])]
    host = hosts[int(rng.integers(len(hosts)))]
    host["weights"][0] //= 2
    return ser.from_json(doc)


@pytest.mark.parametrize("name", SCENARIOS)
def test_memoised_placement_follows_weights_crush_and_state(name):
    """A cache-enabled port map places through the process-wide raw
    memo, keyed on the crush map's digest and the weights: through
    incrementals that reweight an OSD, swap the crush map and mark OSDs
    down and up, it answers as the JAX host path on every PG."""
    jm, tm = _scenario("jax", name), _scenario("port", name)
    tm.enable_placement_cache()
    rng = np.random.default_rng(SEED + 23)

    def same():
        for pg in _all_pgs(tm):
            assert tm.pg_to_up_acting_osds(pg) == jm.pg_to_up_acting_osds(
                _jpg(pg)), (tm.epoch, pg)
    same()
    for step in ("weight", "crush", "state", "weight"):
        o = int(rng.integers(24))
        w = int(rng.choice([0, 0x8000, 0x10000]))
        seed = int(rng.integers(1 << 30))
        for pkg, m in (("jax", jm), ("port", tm)):
            om, _cm = PACKAGES[pkg]
            inc = om.Incremental(epoch=m.epoch + 1)
            if step == "weight":
                inc.new_weight[o] = w
            elif step == "crush":
                inc.new_crush = _reweighted_crush(
                    pkg, m.crush, np.random.default_rng(seed))
            else:
                inc.new_state[o] = om.CEPH_OSD_UP      # XOR: flips up
            m.apply_incremental(inc)
        same()


def test_placement_memo_places_each_pg_once_across_maps(monkeypatch):
    """Three cache-enabled maps decoded from one encoding (the daemons of
    one cluster in one process) run CRUSH once per PG between them, and
    an epoch that changes neither the crush map nor the weights runs it
    for none."""
    m = _scenario("port", "down_out")
    data = m.encode()
    monkeypatch.setattr(tosdmap, "_RAW_MEMO", {})
    runs = []
    real = tosdmap.crush_mapper.crush_do_rule

    def counted(*args, **kw):
        runs.append(args[2])
        return real(*args, **kw)

    monkeypatch.setattr(tosdmap.crush_mapper, "crush_do_rule", counted)
    maps = [tosdmap.OSDMap.decode(data) for _ in range(3)]
    for x in maps:
        x.enable_placement_cache()
    pgs = _all_pgs(m)
    first = [[x.pg_to_up_acting_osds(pg) for pg in pgs] for x in maps]
    assert len(runs) == len(pgs)
    assert first[0] == first[1] == first[2] == [
        m.pg_to_up_acting_osds(pg) for pg in pgs]
    up = next(o for o in range(24) if m.is_up(o))
    for x in maps:
        inc = tosdmap.Incremental(epoch=x.epoch + 1)
        inc.new_state[up] = tosdmap.CEPH_OSD_UP
        x.apply_incremental(inc)
    m.osd_state[up] &= ~tosdmap.CEPH_OSD_UP
    later = [[x.pg_to_up_acting_osds(pg) for pg in pgs] for x in maps]
    assert len(runs) == 2 * len(pgs)     # m, uncached, ran its own once
    assert later[0] == later[1] == later[2] == [
        m.pg_to_up_acting_osds(pg) for pg in pgs] != first[0]


# -- ROADMAP.md C3: pools the JAX OSDMapMapping maps wrong -------------------


def _c3_map(pkg: str, fault: str):
    """OSDMap.build_simple(16, osds_per_host=4) with one size-3, 256-PG
    pool on a rule the JAX batched mapper computes wrong (C1, C2)."""
    om, cm = PACKAGES[pkg]
    m = om.OSDMap.build_simple(16, osds_per_host=4)
    if fault == "vary_r_0":
        steps = [cm.RuleStep(cm.CRUSH_RULE_SET_CHOOSELEAF_VARY_R, 0),
                 cm.RuleStep(cm.CRUSH_RULE_TAKE, -1),
                 cm.RuleStep(cm.CRUSH_RULE_CHOOSELEAF_FIRSTN, 0, 1),
                 cm.RuleStep(cm.CRUSH_RULE_EMIT)]
    else:
        m.crush.choose_total_tries = 5
        steps = [cm.RuleStep(cm.CRUSH_RULE_TAKE, -1),
                 cm.RuleStep(cm.CRUSH_RULE_CHOOSELEAF_FIRSTN, 4, 1),
                 cm.RuleStep(cm.CRUSH_RULE_EMIT)]
    ruleno = m.crush.add_rule(cm.Rule(fault, steps))
    m.create_pool("c3", size=3, pg_num=256, crush_rule=ruleno)
    return m


# fault: (PGs of 256 where the JAX mapping differs, the first such ps,
# the JAX mapping's up set there, the host path's)
C3 = {"vary_r_0": (236, 0, [13, 0, 9], [13, 1, 8]),
      "firstn_past_size": (3, 96, [0, 9], [0, 9, 7])}


@pytest.mark.parametrize("fault", sorted(C3))
def test_port_mapping_equals_the_host_path_on_c3_pools(fault):
    jm, tm = _c3_map("jax", fault), _c3_map("port", fault)
    mapping = tosdmap.OSDMapMapping(tm, device="cpu")
    for pg in _all_pgs(tm):
        want = jm.pg_to_up_acting_osds(_jpg(pg))
        assert mapping.get(pg) == want == tm.pg_to_up_acting_osds(pg), pg


@pytest.mark.parametrize("fault", sorted(C3))
def test_jax_mapping_differs_from_its_host_path_on_c3_pools(fault):
    """Pins the reference fault the port does not copy: the JAX
    OSDMapMapping._update guards only choose_args, so these pools go
    through its batched mapper and come out wrong."""
    n_bad, ps, jax_up, host_up = C3[fault]
    jm = _c3_map("jax", fault)
    mapping = josdmap.OSDMapMapping(jm, use_tpu=True)
    bad = [pg for pg in _all_pgs(jm)
           if mapping.get(_jpg(pg)) != jm.pg_to_up_acting_osds(_jpg(pg))]
    assert len(bad) == n_bad and bad[0].ps == ps
    pg = josdmap.PgId(1, ps)
    assert mapping.get(pg)[0] == jax_up
    assert jm.pg_to_up_acting_osds(pg)[0] == host_up


# -- osdmaptool --------------------------------------------------------------


def _run_tool(run, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run(argv, **kw)
    return rc, out.getvalue(), err.getvalue()


def _tool_flow(run, path, crush_out):
    """The flow of tests/test_osdmap.py::test_osdmaptool, with the dumps."""
    steps = [[path, "--createsimple", "8", "--with-default-pool"],
             [path, "--print"],
             [path, "--test-map-pgs"],
             [path, "--test-map-pgs-dump", "--pool", "1"],
             [path, "--test-map-pg", "1.3"],
             [path, "--export-crush", crush_out],
             [path, "--import-crush", crush_out],
             [path, "--mark-up-in", "--print", "--test-map-pgs"]]
    return [run(argv) for argv in steps]


def test_osdmaptool_prints_what_the_jax_tool_prints(tmp_path):
    outs = {}
    for name, run in (("jax", jtool.run),
                      ("port", functools.partial(ttool.run, device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        outs[name] = _tool_flow(lambda argv: _run_tool(run, argv),
                                str(d / "osdmap"), str(d / "crush.json"))
        outs[name + " map"] = (d / "osdmap").read_bytes()
        outs[name + " crush"] = (d / "crush.json").read_text()
    assert outs["port"] == [
        (rc, out.replace(str(tmp_path / "jax"), str(tmp_path / "port")),
         err) for rc, out, err in outs["jax"]]
    assert all(rc == 0 for rc, _out, _err in outs["port"])
    assert outs["port map"] == outs["jax map"]
    assert outs["port crush"] == outs["jax crush"]


def test_osdmaptool_reads_the_other_tools_map_files(tmp_path):
    """A map written by either tool loads in the other: both print the
    same map from it, and what one tool writes back the other decodes to
    the same bytes."""
    seeded = _scenario("port", "all")
    for writer, reader in (("jax", "port"), ("port", "jax")):
        path = str(tmp_path / f"{writer}.osdmap")
        if writer == "jax":
            assert _run_tool(jtool.run, [path, "--createsimple", "24",
                                         "--with-default-pool"])[0] == 0
        else:
            with open(path, "wb") as f:
                f.write(seeded.encode())
        argv = [path, "--print"]
        want = _run_tool(jtool.run, argv)
        got = _run_tool(ttool.run, argv, device="cpu")
        assert got == want and got[0] == 0
        run = jtool.run if reader == "jax" else functools.partial(
            ttool.run, device="cpu")
        assert _run_tool(run, [path, "--mark-up-in"])[0] == 0
        with open(path, "rb") as f:
            data = f.read()
        assert (tosdmap.OSDMap.decode(data).encode()
                == josdmap.OSDMap.decode(data).encode())


def test_no_silent_cpu(monkeypatch, tmp_path):
    m = _scenario("port", "healthy")
    path = str(tmp_path / "osdmap")
    with open(path, "wb") as f:
        f.write(m.encode())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tosdmap.OSDMapMapping(m)
    with pytest.raises(RuntimeError):
        ttool.run([path, "--test-map-pgs"])
    # a pool the kernel does not take raises too: the device comes first
    c3 = _c3_map("port", "vary_r_0")
    with pytest.raises(RuntimeError):
        tosdmap.OSDMapMapping(c3)
    # the rest of the tool needs no device
    assert _run_tool(ttool.run, [path, "--print"])[0] == 0


# -- the JAX tests of tests/test_osdmap.py, replayed on the port ------------

PORT_NAMES = {
    "Decoder": tenc.Decoder, "DecodeError": tenc.DecodeError,
    "Encoder": tenc.Encoder, "CRUSH_ITEM_NONE": tmap.CRUSH_ITEM_NONE,
    "OSDMapMapping": functools.partial(tosdmap.OSDMapMapping, device="cpu"),
    **{name: getattr(tosdmap, name) for name in (
        "CEPH_OSD_EXISTS", "CEPH_OSD_IN", "CEPH_OSD_UP", "Incremental",
        "OSDMap", "PgId", "PgPool", "TYPE_ERASURE", "TYPE_REPLICATED",
        "ceph_stable_mod")}}
# test_osdmaptool imports the JAX tool inside its body; the tool is held
# against the port's above
REPLAYED = sorted(name for name, fn in vars(jax_cases).items()
                  if name.startswith("test_") and callable(fn)
                  and name != "test_osdmaptool")


def _on_the_port(fn):
    """fn with the JAX package's names in its globals bound to the port's."""
    missing = {n for n in fn.__code__.co_names
               for mod in (josdmap, jenc) if n in vars(mod) and not
               isinstance(vars(mod)[n], types.ModuleType)} - set(PORT_NAMES)
    assert not missing, missing
    return types.FunctionType(fn.__code__, {**fn.__globals__, **PORT_NAMES},
                              fn.__name__, fn.__defaults__, fn.__closure__)


@pytest.mark.parametrize("name", REPLAYED)
def test_jax_osdmap_case_on_the_port(name):
    fn = _on_the_port(getattr(jax_cases, name))
    kwargs = {}
    if "osdmap" in inspect.signature(fn).parameters:
        # the `osdmap` fixture of tests/test_osdmap.py, on the port
        m = tosdmap.OSDMap.build_simple(12, osds_per_host=3)
        m.create_pool("data", size=3, pg_num=32)
        kwargs["osdmap"] = m
    fn(**kwargs)
