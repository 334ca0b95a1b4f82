"""The port's CRUSH placement (ceph_tpu_torch.crush, ops/rjenkins,
tools/crushtool) against the JAX package, on the CPU.

The port's `compile_rule(..., device="cpu")` runs the placement kernel's
plain PyTorch version; it is held against `ceph_tpu.crush.kernel`'s
compile_rule (JAX on the CPU) and against the port's copy of the exact
host mapper, which `tests/test_crush_oracle.py` ties to the reference's
mapper.c.  Every output is an integer placement, a hash or a byte string,
so the tolerance is exact equality.  The JAX kernel is imported inside the
tests, as tests/test_crush.py does, because it turns on jax_enable_x64.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ceph_tpu.crush import compiler as jcompiler
from ceph_tpu.crush import map as jmap
from ceph_tpu.crush import mapper as jmapper
from ceph_tpu.crush import serialize as jserialize
from ceph_tpu.ops import rjenkins as jrj
from ceph_tpu.tools import crushtool as jcrushtool
from ceph_tpu_torch.crush import compiler as tcompiler
from ceph_tpu_torch.crush import kernel as tkernel
from ceph_tpu_torch.crush import mapper as tmapper
from ceph_tpu_torch.crush import serialize as tserialize
from ceph_tpu_torch.crush.map import (
    CRUSH_BUCKET_LIST, CRUSH_ITEM_NONE, CRUSH_RULE_CHOOSE_FIRSTN, ChooseArg,
    RuleStep,
)
from ceph_tpu_torch.ops import crush_kernels
from ceph_tpu_torch.ops import rjenkins as trj
from ceph_tpu_torch.tools import crushtool as tcrushtool
from ceph_tpu_torch.tools import kernel_shapes
from ceph_tpu_torch.tools.kernel_shapes import (draw_paths, parse_sass, pipe,
                                                random_crush_case)


def _ec_rule(cmap, leaf_tries=5):
    """The EC rule of tests/test_crush.py: SET_CHOOSELEAF_TRIES + chooseleaf
    indep over hosts (works on either package's CrushMap)."""
    return cmap.add_rule(jmap.Rule("ec", [
        jmap.RuleStep(jmap.CRUSH_RULE_SET_CHOOSELEAF_TRIES, leaf_tries),
        jmap.RuleStep(jmap.CRUSH_RULE_TAKE, cmap.name_to_item("default")),
        jmap.RuleStep(jmap.CRUSH_RULE_CHOOSELEAF_INDEP, 0,
                      cmap.type_id("host")),
        jmap.RuleStep(jmap.CRUSH_RULE_EMIT),
    ], rule_type=3))


def _to_port(jax_map):
    """The reference's state carried across: a JAX-package CrushMap as the
    port's CrushMap."""
    return tserialize.from_json(json.loads(json.dumps(
        jserialize.to_json(jax_map))))


def _pad(lst, n):
    return lst + [CRUSH_ITEM_NONE] * (n - len(lst))


def _host_rows(cmap, ruleno, xs, result_max, weight=None):
    return np.array([_pad(tmapper.crush_do_rule(cmap, ruleno, int(x),
                                                result_max, weight),
                          result_max) for x in xs], dtype=np.int64)


def _reweighted():
    cmap = jmap.build_flat_cluster(64, osds_per_host=4)
    cmap.add_simple_rule("data", "default", "host", mode="firstn")
    _ec_rule(cmap)
    return cmap


_W64 = [int(v) for v in np.random.default_rng(5).integers(0, 0x10001, 64)]

# name -> (map constructor on the JAX package's model, rule, result_max,
# weight vector, inputs): the maps of tests/test_crush.py
CASES = {
    "flat": (lambda: _simple(jmap.build_flat_cluster(64, 4), "host"),
             0, 3, None, 512),
    "racks": (lambda: _simple(jmap.build_flat_cluster(96, 4, 4), "host"),
              0, 3, None, 512),
    "ec_indep_11": (lambda: _with_ec(jmap.build_flat_cluster(96, 4, 4)),
                    0, 11, None, 512),
    "reweighted_rule0": (_reweighted, 0, 3, _W64, 512),
    "reweighted_rule1": (_reweighted, 1, 8, _W64, 512),
    "choose_osd": (lambda: _simple(jmap.build_flat_cluster(40, 40), "osd"),
                   0, 3, None, 1024),
}


def _simple(cmap, domain):
    cmap.add_simple_rule("data", "default", domain, mode="firstn")
    return cmap


def _with_ec(cmap):
    _ec_rule(cmap)
    return cmap


@pytest.fixture(scope="module")
def jax_placements():
    """One JAX compile_rule per case, shared by the tests of this module."""
    from ceph_tpu.crush.kernel import compile_rule

    out = {}
    for name, (build, ruleno, rmax, weight, n) in CASES.items():
        out[name] = compile_rule(build(), ruleno, rmax, weight=weight)(
            np.arange(n))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_compile_rule_matches_jax_kernel(case, jax_placements):
    build, ruleno, rmax, weight, n = CASES[case]
    got = tkernel.compile_rule(_to_port(build()), ruleno, rmax,
                               weight=weight, device="cpu")(np.arange(n))
    assert got.dtype == np.int32 and got.shape == (n, rmax)
    assert np.array_equal(got, jax_placements[case])


@pytest.mark.parametrize("case", sorted(CASES))
def test_compile_rule_matches_host_mapper(case):
    build, ruleno, rmax, weight, n = CASES[case]
    cmap = _to_port(build())
    xs = np.arange(n)
    got = tkernel.compile_rule(cmap, ruleno, rmax, weight=weight,
                               device="cpu")(xs)
    assert np.array_equal(got, _host_rows(cmap, ruleno, xs, rmax, weight))


@pytest.mark.parametrize("case", ["racks", "reweighted_rule1"])
def test_host_mapper_copy_matches_jax_package(case):
    build, ruleno, rmax, weight, _ = CASES[case]
    jax_map = build()
    cmap = _to_port(jax_map)
    for x in range(0, 4096, 37):
        assert tmapper.crush_do_rule(cmap, ruleno, x, rmax, weight) == \
            jmapper.crush_do_rule(jax_map, ruleno, x, rmax, weight)


def test_empty_host_bucket_is_retried_like_the_host_mapper():
    cmap = jmap.build_flat_cluster(64, osds_per_host=4)
    empty = cmap.add_bucket(None, cmap.type_id("host"), "empty")
    cmap.buckets[-1].add_item(empty.id, 0x40000)
    cmap.add_simple_rule("data", "default", "host", mode="firstn")
    _ec_rule(cmap)
    port = _to_port(cmap)
    xs = np.arange(512)
    for ruleno, rmax in ((0, 3), (1, 6)):
        got = tkernel.compile_rule(port, ruleno, rmax, device="cpu")(xs)
        assert np.array_equal(got, _host_rows(port, ruleno, xs, rmax))


# -- random hierarchies against the host mapper ----------------------------


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), levels=st.integers(1, 4),
       firstn=st.booleans(), leaf=st.booleans(),
       result_max=st.integers(1, 12))
def test_plain_matches_host_mapper_on_random_hierarchies(
        seed, levels, firstn, leaf, result_max):
    """Random 1-4 level straw2 hierarchies, tunables, weights and rules.
    A firstn step past result_max is refused (ROADMAP.md C, fault 2), and
    crushtool's bulk path then answers through the host mapper."""
    cmap, weight, numrep = random_crush_case(
        seed, levels, firstn, leaf, result_max, numrep_past=3)
    xs = np.random.default_rng(seed).integers(0, 2**31, 24)
    if firstn and numrep > result_max:
        with pytest.raises(NotImplementedError):
            tkernel.compile_rule(cmap, 0, result_max, weight=weight,
                                 device="cpu")
    got = tcrushtool._bulk_do_rule(cmap, 0, xs, result_max, weight,
                                   device="cpu")
    assert np.array_equal(got, _host_rows(cmap, 0, xs, result_max, weight))


# -- module parity ---------------------------------------------------------


def _words(rng, n):
    w = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 0xFFFFFFFF, 0, 0xFFFFFFFF]
    return w


def test_rjenkins_numpy_and_torch_match_the_jax_package():
    rng = np.random.default_rng(11)
    a, b, c, d, e = (_words(rng, 4096) for _ in range(5))
    b[:4] = [0, 0, 0xFFFFFFFF, 0xFFFFFFFF]
    assert np.array_equal(trj.hash32(a), jrj.hash32(a))
    assert np.array_equal(trj.hash32_2(a, b), jrj.hash32_2(a, b))
    assert np.array_equal(trj.hash32_3(a, b, c), jrj.hash32_3(a, b, c))
    assert np.array_equal(trj.hash32_4(a, b, c, d), jrj.hash32_4(a, b, c, d))
    assert np.array_equal(trj.hash32_5(a, b, c, d, e),
                          jrj.hash32_5(a, b, c, d, e))
    t = [torch.from_numpy(v.astype(np.int64)) for v in (a, b, c, d)]
    # negative int32 inputs read as their uint32 bit patterns
    neg = [torch.from_numpy(v.view(np.int32)) for v in (a, b, c, d)]
    for args in (t, neg):
        assert np.array_equal(trj.hash32_2_torch(*args[:2]).numpy(),
                              jrj.hash32_2(a, b).astype(np.int64))
        assert np.array_equal(trj.hash32_3_torch(*args[:3]).numpy(),
                              jrj.hash32_3(a, b, c).astype(np.int64))
        assert np.array_equal(trj.hash32_4_torch(*args).numpy(),
                              jrj.hash32_4(a, b, c, d).astype(np.int64))
    for s in (b"", b"a", b"rbd_data.1234", bytes(range(37))):
        assert trj.ceph_str_hash_rjenkins(s) == jrj.ceph_str_hash_rjenkins(s)


def test_crush_ln_on_all_inputs_matches_jax():
    import jax.numpy as jnp
    from ceph_tpu.crush.kernel import crush_ln_jax

    u = np.arange(0x10000, dtype=np.int64)
    want = np.asarray(crush_ln_jax(jnp.asarray(u)))
    assert np.array_equal(tkernel.crush_ln(torch.from_numpy(u)).numpy(),
                          want)
    assert np.array_equal(want, jmapper.crush_ln_vec(u))


# -- serialize and compiler --------------------------------------------------

CRUSH_TEXT = """\
# begin crush map
tunable choose_local_tries 0
tunable choose_local_fallback_tries 0
tunable choose_total_tries 50
tunable chooseleaf_descend_once 1
tunable chooseleaf_vary_r 1
tunable chooseleaf_stable 1

# devices
device 0 osd.0 class hdd
device 1 osd.1 class ssd
device 2 osd.2 class hdd
device 3 osd.3 class ssd
device 4 osd.4 class hdd
device 5 osd.5 class hdd

# types
type 0 osd
type 1 host
type 11 root

# buckets
host host0 {
\tid -2
\talg straw2
\thash 0\t# rjenkins1
\titem osd.0 weight 1.00000
\titem osd.1 weight 1.00000
}
host host1 {
\tid -3
\talg straw2
\thash 0
\titem osd.2 weight 1.00000
\titem osd.3 weight 1.00000
}
host host2 {
\tid -4
\talg straw2
\thash 0
\titem osd.4 weight 1.00000
\titem osd.5 weight 2.00000
}
root default {
\tid -1
\talg straw2
\thash 0
\titem host0 weight 2.00000
\titem host1 weight 2.00000
\titem host2 weight 3.00000
}

# rules
rule replicated_rule {
\tid 0
\ttype replicated
\tmin_size 1
\tmax_size 10
\tstep take default
\tstep chooseleaf firstn 0 type host
\tstep emit
}
rule hdd_rule {
\tid 1
\ttype replicated
\tmin_size 1
\tmax_size 10
\tstep take default class hdd
\tstep chooseleaf firstn 0 type host
\tstep emit
}
# end crush map
"""


def test_compile_text_and_json_match_the_jax_package():
    port = tcompiler.compile_text(CRUSH_TEXT)
    ref = jcompiler.compile_text(CRUSH_TEXT)
    assert tserialize.to_json(port) == jserialize.to_json(ref)
    # the reference's state carried across, and back
    assert tserialize.to_json(tserialize.from_json(
        jserialize.to_json(ref))) == jserialize.to_json(ref)
    assert jserialize.to_json(jserialize.from_json(
        tserialize.to_json(port))) == tserialize.to_json(port)


def test_decompile_matches_the_jax_package():
    port = tcompiler.compile_text(CRUSH_TEXT)
    ref = jcompiler.compile_text(CRUSH_TEXT)
    text = tcompiler.decompile(port)
    assert text == jcompiler.decompile(ref)
    assert tserialize.to_json(tcompiler.compile_text(text)) == \
        jserialize.to_json(jcompiler.compile_text(text))


# -- crushtool -------------------------------------------------------------


def _run_tool(run, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run(argv, **kw)
    return rc, out.getvalue(), err.getvalue()


def test_crushtool_test_prints_what_the_jax_tool_prints(tmp_path):
    path = tmp_path / "map.txt"
    path.write_text(CRUSH_TEXT)
    argv = ["-i", str(path), "--test", "--num-rep", "3", "--max-x", "511",
            "--show-mappings", "--show-utilization", "--show-statistics",
            "--show-bad-mappings", "--weight", "4", "0.5", "--weight", "1",
            "0"]
    port = _run_tool(tcrushtool.run, argv, device="cpu")
    ref = _run_tool(jcrushtool.run, argv)
    assert port == ref
    assert port[0] == 0 and "CRUSH rule 1 x 511 [" in port[1]


def test_crushtool_compile_and_decompile_match_the_jax_tool(tmp_path):
    src = tmp_path / "map.txt"
    src.write_text(CRUSH_TEXT)
    for run, name in ((tcrushtool.run, "port"), (jcrushtool.run, "ref")):
        assert run(["-c", str(src), "-o", str(tmp_path / f"{name}.json")]) \
            == 0
        assert run(["-d", str(tmp_path / f"{name}.json"), "-o",
                    str(tmp_path / f"{name}.txt")]) == 0
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "ref.txt").read_text()


# -- where the JAX kernel and the host mapper part ---------------------------


def _choose_args_map():
    cmap = jmap.build_flat_cluster(16, osds_per_host=4)
    cmap.add_simple_rule("data", "default", "host", mode="firstn")
    root = cmap.buckets[-1]
    cmap.choose_args = {-1: jmap.ChooseArg(weight_set=[
        [w // 4 if i % 2 else w for i, w in enumerate(root.weights)]])}
    return cmap


def _vary_r_rule_map():
    cmap = jmap.build_flat_cluster(16, osds_per_host=4)
    cmap.add_rule(jmap.Rule("vary_r", [
        jmap.RuleStep(jmap.CRUSH_RULE_SET_CHOOSELEAF_VARY_R, 0),
        jmap.RuleStep(jmap.CRUSH_RULE_TAKE, -1),
        jmap.RuleStep(jmap.CRUSH_RULE_CHOOSELEAF_FIRSTN, 0, 1),
        jmap.RuleStep(jmap.CRUSH_RULE_EMIT)]))
    return cmap


def _two_groups_map():
    cmap = jmap.build_flat_cluster(16, osds_per_host=4)
    cmap.add_rule(jmap.Rule("two", [
        jmap.RuleStep(jmap.CRUSH_RULE_TAKE, -1),
        jmap.RuleStep(jmap.CRUSH_RULE_CHOOSELEAF_FIRSTN, 2, 1),
        jmap.RuleStep(jmap.CRUSH_RULE_EMIT),
        jmap.RuleStep(jmap.CRUSH_RULE_TAKE, -1),
        jmap.RuleStep(jmap.CRUSH_RULE_CHOOSE_FIRSTN, 2, 0),
        jmap.RuleStep(jmap.CRUSH_RULE_EMIT)]))
    return cmap


def _firstn_past_map():
    """A firstn step asking for more replicas (4) than the tests'
    result_max (3), with few tries so that replicas are skipped."""
    cmap = jmap.build_flat_cluster(16, osds_per_host=4)
    cmap.choose_total_tries = 5
    cmap.add_rule(jmap.Rule("firstn4", [
        jmap.RuleStep(jmap.CRUSH_RULE_TAKE, -1),
        jmap.RuleStep(jmap.CRUSH_RULE_CHOOSELEAF_FIRSTN, 4, 1),
        jmap.RuleStep(jmap.CRUSH_RULE_EMIT)]))
    return cmap


FAULTS = {"choose_args": _choose_args_map, "vary_r_step": _vary_r_rule_map,
          "two_groups": _two_groups_map,
          "firstn_past_result_max": _firstn_past_map}


def _heavy_item_map():
    """A host weighing 2^32 in the root: past the 32-bit item weights the
    kernel's reciprocals are proven for."""
    cmap = jmap.build_flat_cluster(16, osds_per_host=4)
    cmap.add_simple_rule("data", "default", "host", mode="firstn")
    cmap.buckets[-1].weights[0] = 1 << 32
    return cmap


# shapes the batched mapper refuses and crushtool answers through the host
# mapper: the reference faults, and weights past the reciprocals' proof
HOST_MAPPER_SHAPES = {**FAULTS, "item_weight_past_32_bits": _heavy_item_map}


@pytest.mark.parametrize("fault,least", [("choose_args", 129),
                                         ("firstn_past_result_max", 2)])
def test_jax_kernel_parts_from_the_host_mapper(fault, least):
    """Pins the reference faults the port refuses (ROADMAP.md C): the JAX
    compile_rule ignores choose_args that the host mapper honours, and
    stops a firstn step at result_max tries where the host mapper goes on
    past a skipped replica."""
    from ceph_tpu.crush.kernel import compile_rule

    cmap = FAULTS[fault]()
    ruleno = len(cmap.rules) - 1
    xs = np.arange(256)
    got = compile_rule(cmap, ruleno, 3)(xs)
    want = np.array([_pad(jmapper.crush_do_rule(cmap, ruleno, int(x), 3), 3)
                     for x in xs])
    assert (got != want).any(axis=1).sum() >= least


@pytest.mark.parametrize("fault", sorted(HOST_MAPPER_SHAPES))
def test_unhonoured_shapes_go_to_the_host_mapper(fault, tmp_path):
    jax_map = HOST_MAPPER_SHAPES[fault]()
    cmap = _to_port(jax_map)
    ruleno = len(cmap.rules) - 1
    with pytest.raises(NotImplementedError):
        tkernel.compile_rule(cmap, ruleno, 3, device="cpu")
    path = tmp_path / "map.json"
    path.write_text(json.dumps(tserialize.to_json(cmap)))
    rc, out, _ = _run_tool(tcrushtool.run, [
        "-i", str(path), "--test", "--rule", str(ruleno), "--num-rep", "3",
        "--max-x", "127", "--show-mappings"], device="cpu")
    want = "".join(
        f"CRUSH rule {ruleno} x {x} [" + ",".join(
            str(v) for v in tmapper.crush_do_rule(cmap, ruleno, x, 3))
        + "]\n" for x in range(128))
    assert rc == 0 and out == want


@pytest.mark.parametrize("shape", ["local_tries", "list_bucket",
                                   "chained", "result_max_33",
                                   "missing_bucket"])
def test_compile_rule_refuses_what_the_kernel_does_not_take(shape):
    cmap = _to_port(_simple(jmap.build_flat_cluster(16, 4), "host"))
    rmax = 3
    if shape == "local_tries":
        cmap.choose_local_tries = 2
    elif shape == "list_bucket":
        cmap.buckets[-2].alg = CRUSH_BUCKET_LIST
    elif shape == "chained":
        cmap.rules[0].steps.insert(2, RuleStep(CRUSH_RULE_CHOOSE_FIRSTN, 2,
                                               1))
    elif shape == "result_max_33":
        rmax = 33
    else:
        cmap.buckets[-1].add_item(-40, 0x10000)
    with pytest.raises(NotImplementedError):
        tkernel.compile_rule(cmap, 0, rmax, device="cpu")


def test_kernel_wrapper_checks_its_inputs():
    cmap = _to_port(_simple(jmap.build_flat_cluster(16, 4), "host"))
    run = tkernel.compile_rule(cmap, 0, 3, device="cpu")
    dm, prog = run.dense_map, run.program
    xs = torch.arange(8, dtype=torch.int32)
    assert torch.equal(crush_kernels.crush_do_rule_batch(dm, prog, xs),
                       torch.from_numpy(run(np.arange(8))))
    with pytest.raises(ValueError):
        crush_kernels.crush_do_rule_batch(dm, prog, xs.to(torch.int64))
    with pytest.raises(ValueError):
        crush_kernels.crush_do_rule_batch(dm, prog._replace(result_max=33),
                                          xs)
    with pytest.raises(ValueError):
        crush_kernels.crush_do_rule_batch(
            tkernel.DenseMap(**{**dm.__dict__,
                                "weights": dm.weights.to(torch.int32)}),
            prog, xs)


def test_no_silent_cpu(monkeypatch, tmp_path):
    cmap = _to_port(_simple(jmap.build_flat_cluster(16, 4), "host"))
    path = tmp_path / "map.json"
    path.write_text(json.dumps(tserialize.to_json(cmap)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tkernel.compile_rule(cmap, 0, 3)
    with pytest.raises(RuntimeError):
        tcrushtool.run(["-i", str(path), "--test", "--num-rep", "3"])
    # a shape the kernel does not take raises too: the device comes first
    cmap.choose_args = {-1: ChooseArg(weight_set=[[0x10000] * 4])}
    with pytest.raises(RuntimeError):
        tkernel.compile_rule(cmap, 0, 3)


# -- the kernel's straw2 reciprocals -----------------------------------------


def _divide(n: int, packed: int) -> int:
    """The kernel's quotient: umulhi(n << 15, m) >> s."""
    m = packed & ((1 << tkernel.RECIP_SHIFT) - 1)
    return (((n << 15) * m) >> 64) >> (packed >> tkernel.RECIP_SHIFT)


def _map_item_weights(cmap) -> set:
    return {w for b in cmap.buckets.values() for w in b.weights}


def _random_map_weights() -> set:
    out = set()
    for seed in range(24):
        cmap, weight, _ = random_crush_case(seed, 1 + seed % 4, seed % 2 == 0,
                                            seed % 4 < 2, 1 + seed % 12)
        out |= _map_item_weights(cmap)
    return out


RECIP_WEIGHTS = {
    "sweep": lambda: {1, 2, 3, 0xFFFF, 0x10000, 0xC80000, 0xFFFFFFFF}
    | {(1 << j) + d for j in range(1, 33) for d in (-1, 0, 1)}
    - {1 << 32, (1 << 32) + 1},
    "map_10k": lambda: _map_item_weights(
        jmap.build_flat_cluster(10000, osds_per_host=20, hosts_per_rack=10)),
    "random_maps": _random_map_weights,
}


@pytest.mark.parametrize("source", sorted(RECIP_WEIGHTS))
def test_straw2_reciprocal_divides_exactly(source):
    """crush/kernel.straw2_reciprocal: the proof's inequality, which makes
    n // w == (n * m) >> (49 + s) for every n in [0, 2^48], and the kernel's
    two-step form of it at the ends of the range and around multiples of
    w, against Python's integer division."""
    weights = sorted(w for w in RECIP_WEIGHTS[source]() if w > 0)
    assert weights and max(weights) <= 0xFFFFFFFF
    rng = np.random.default_rng(len(weights))
    top = 1 << 48
    for w in weights:
        packed = tkernel.straw2_reciprocal(w)
        m = packed & ((1 << tkernel.RECIP_SHIFT) - 1)
        s = packed >> tkernel.RECIP_SHIFT
        k = 49 + s
        e = m * w - (1 << k)
        assert 0 <= e < w and e * top < 1 << k
        assert m < 1 << 51 and s <= 32 and packed < 1 << 63
        last = top // w
        ks = {0, 1, 2, last - 1, last, last + 1} | {
            int(v) for v in rng.integers(0, last + 1, 64)}
        ns = {0, 1, top - 1, top} | {
            k * w + d for k in ks for d in (-1, 0, 1) if 0 <= k * w + d <= top}
        for n in ns:
            assert _divide(n, packed) == n // w, (w, n)


def test_straw2_reciprocal_skips_and_refuses():
    assert tkernel.straw2_reciprocal(0) == 0
    assert tkernel.straw2_reciprocal(-5) == 0
    with pytest.raises(NotImplementedError):
        tkernel.straw2_reciprocal(1 << 32)
    with pytest.raises(NotImplementedError):
        tkernel.DenseMap.from_crush_map(_to_port(_heavy_item_map()), None,
                                        torch.device("cpu"))
    cmap = _to_port(_reweighted())
    dm = tkernel.DenseMap.from_crush_map(cmap, None, torch.device("cpu"))
    want = [[tkernel.straw2_reciprocal(int(w)) for w in row]
            for row in dm.weights.tolist()]
    assert dm.recips.dtype == torch.int64 and dm.recips.tolist() == want


def test_plain_counts_the_draws_it_makes():
    cmap = _to_port(_simple(jmap.build_flat_cluster(16, 4), "osd"))
    run = tkernel.compile_rule(cmap, 0, 1, device="cpu")
    stats = {}
    tkernel.crush_do_rule_batch_plain(
        run.dense_map, run.program, torch.arange(100, dtype=torch.int32),
        stats)
    # one replica, CHOOSE over osds of 4 hosts: every input descends root
    # (4 hosts) then a host (4 osds) at least once; all weights are 1.0, so
    # is_out never hashes
    assert stats["draws"] >= 800 and stats["is_out_hashes"] == 0


# the shape of a straw2 loop in cuobjdump -sass: a dead-item skip, a block
# a draw may skip, the division's 32-bit fast path beside its CALL
SASS = """\
\t\tFunction : _Z12crush_kernel11CrushParams
        /*0000*/                   MOV R1, c[0x0][0x28] ;          /* 0x000 */
                                                                   /* 0x000 */
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;          /* 0x000 */
        /*0020*/              @!P0 BRA 0x90 ;                       /* 0x000 */
        /*0030*/               @P1 BRA 0x50 ;                       /* 0x000 */
        /*0040*/                   SHF.L.U32 R3, R3, 0x1, RZ ;      /* 0x000 */
        /*0050*/              @!P2 BRA 0x80 ;                       /* 0x000 */
        /*0060*/                   CALL.REL.NOINC 0xc0 ;            /* 0x000 */
        /*0070*/                   BRA 0x90 ;                       /* 0x000 */
        /*0080*/                   MUFU.RCP R4, R4 ;                /* 0x000 */
        /*0090*/                   ISETP.GE.AND P0, PT, R2, R5, PT ;
        /*00a0*/              @!P0 BRA P3, 0x10 ;                   /* 0x000 */
        /*00b0*/                   EXIT ;                           /* 0x000 */
        /*00c0*/                   IADD3 R6, R6, 0x1, RZ ;          /* 0x000 */
        /*00d0*/                   RET.REL.NODEC R16 0x0 ;          /* 0x000 */
        /*00e0*/                   BRA 0xe0;                        /* 0x000 */
"""

# the same loop with the reciprocal in place of the division: no CALL; the
# draw's ln table load (LDS) lies past a dead-item skip and a skippable
# block, then a 64-bit product, a compare and a select
SASS_RECIPROCAL = """\
\t\tFunction : _Z12crush_kernel11CrushParams
        /*0000*/                   MOV R1, c[0x0][0x28] ;          /* 0x000 */
        /*0010*/                   LDG.E.64.CONSTANT R2, [R4.64] ;  /* 0x000 */
        /*0020*/              @!P0 BRA 0xa0 ;                       /* 0x000 */
        /*0030*/                   LOP3.LUT R3, R3, R6, RZ, 0x3c, !PT ;
        /*0040*/               @P1 BRA 0x60 ;                       /* 0x000 */
        /*0050*/                   SHF.L.U32 R3, R3, 0x1, RZ ;      /* 0x000 */
        /*0060*/                   LDS.64 R8, [R3] ;                /* 0x000 */
        /*0070*/                   IMAD.WIDE.U32 R10, R8, R2, RZ ;  /* 0x000 */
        /*0080*/                   ISETP.GE.U32.AND P2, PT, R10, R12, PT ;
        /*0090*/                   SEL R13, R14, R13, !P2 ;         /* 0x000 */
        /*00a0*/                   IADD3 R5, R5, 0x1, RZ ;          /* 0x000 */
        /*00b0*/                   ISETP.GE.AND P0, PT, R5, R7, PT ;
        /*00c0*/              @!P0 BRA 0x10 ;                       /* 0x000 */
        /*00d0*/                   EXIT ;                           /* 0x000 */
        /*00e0*/                   BRA 0xe0;                        /* 0x000 */
"""


@pytest.mark.parametrize("listing,size,want", [
    # head -> CALL (5), the routine (2), return -> the loop's branch (3);
    # ISETP only on the ALU pipe, IADD3 and IADD3 in the routine on either
    pytest.param(SASS, 15, {
        "loop": ["0x10", "0xa0"], "span": 10, "via": "CALL.REL.NOINC",
        "to_via": 5, "routine": 2, "after_via": 3, "per_draw": 10,
        "alu_per_draw": 1, "fma_per_draw": 0, "either_per_draw": 2},
        id="division_call"),
    # head -> LDS (5, past the normalisation), LDS -> the branch (6 more);
    # LOP3, ISETP, SEL, ISETP only on the ALU pipe, IMAD.WIDE only on the
    # FMA pipe, IADD3 on either
    pytest.param(SASS_RECIPROCAL, 15, {
        "loop": ["0x10", "0xc0"], "span": 12, "via": "LDS.64",
        "to_via": 5, "routine": 0, "after_via": 6, "per_draw": 11,
        "alu_per_draw": 4, "fma_per_draw": 1, "either_per_draw": 1},
        id="reciprocal_no_call"),
])
def test_draw_count_follows_the_shortest_path_through_the_division(
        listing, size, want):
    """kernel_shapes.draw_paths, which counts the SASS instructions a draw
    executes for the operations bound, by the pipes that can issue them:
    through the division's CALL and its routine where the loop has
    one, else through the ln table load."""
    funcs = parse_sass(listing)
    code = funcs["_Z12crush_kernel11CrushParams"]
    assert len(code) == size
    assert draw_paths(code) == [want]


@pytest.mark.parametrize("op,want", [
    ("LOP3.LUT", "alu"), ("SHF.R.U32.HI", "alu"), ("SHF.L.U64.HI", "alu"),
    ("ISETP.GE.U32.AND.EX", "alu"), ("SEL", "alu"), ("LEA.HI.X.SX32", "alu"),
    ("IADD3", "either"), ("IADD3.X", "either"), ("SHF.L.U32", "either"),
    ("IMAD.SHL.U32", "either"), ("IMAD.MOV.U32", "either"),
    ("IMAD.IADD", "either"), ("LEA", "either"), ("IMAD.WIDE.U32", "fma"),
    ("IMAD.HI.U32", "fma"), ("IMAD.X", "fma"), ("LDS.128", "issue"),
    ("BRA", "issue"), ("ULDC.64", "issue"),
])
def test_sass_pipe_of_an_instruction(op, want):
    """kernel_shapes.pipe: what only the ALU pipe can issue (logic, right
    and funnel shifts, compares, selects), only the FMA pipe (multiplies),
    either (adds, one-word left shifts, moves, address sums), or neither."""
    assert pipe(op) == want


@pytest.mark.parametrize("draw_ops,alu,fma,by", [
    (200, 90, 10, "issue"), (200, 120, 10, "alu"), (200, 30, 110, "fma"),
])
def test_crush_bound_takes_the_slowest_of_issue_and_pipes(
        monkeypatch, draw_ops, alu, fma, by):
    """The operations bound: issue time at 33.5 T/s, or what only one pipe
    can issue at half that rate, whichever is longer."""
    monkeypatch.setattr(kernel_shapes, "DRAW_OPS", draw_ops)
    monkeypatch.setattr(kernel_shapes, "DRAW_ALU_OPS", alu)
    monkeypatch.setattr(kernel_shapes, "DRAW_FMA_OPS", fma)
    draws = 10 ** 9
    want = {"issue": draws * draw_ops / kernel_shapes.INT_OPS_PER_S,
            "alu": draws * alu / kernel_shapes.PIPE_OPS_PER_S,
            "fma": draws * fma / kernel_shapes.PIPE_OPS_PER_S}[by] * 1e3
    got = kernel_shapes.crush_bound_ms(
        {"draws": draws, "is_out_hashes": 0}, 1, 1)
    assert got == pytest.approx(want, rel=1e-12)
