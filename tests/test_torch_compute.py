"""The port's coded-compute library (ceph_tpu_torch.compute, ec/plan.
compute_eval, ops/fold_kernels, osd/ec_util.decode_many) against the JAX
package's, on the CPU; mirrors tests/test_compute.py.

Every result here is bytes and is held bit for bit: the first-k
result-domain decode over every k-subset of the coded shards against the
JAX kernel's host reference and the JAX shard_eval_batch; the fold's plain
version against the JAX device body make_device_eval (jitted on the CPU) and
host_eval; ragged sizes and the zero pad; decode_many against the JAX one;
the commutation gate across techniques; and every nonlinear kernel's
canonical JSON, EINVAL cases included.
"""

import itertools
import json

import jax
import numpy as np
import pytest
import torch

from ceph_tpu import compute as jcompute
from ceph_tpu.compute import kernels as jkernels
from ceph_tpu.ec.registry import create_erasure_code as jcreate
from ceph_tpu.osd import ec_util as jec_util
from ceph_tpu_torch import compute
from ceph_tpu_torch.compute import kernels
from ceph_tpu_torch.ec import plan
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import create_erasure_code
from ceph_tpu_torch.ops import fold_kernels
from ceph_tpu_torch.osd import ec_util

SEED = 20261021
SHAPES = [(2, 1), (3, 2), (4, 2), (6, 3)]
SIZES = [1, 100, 4096, 3 * 4096 + 123, 8 * 4096 + 1]
LINEAR = ["gf_fold", "gf_fingerprint"]


def _codecs(k: int, m: int, technique: str = "reed_sol_van"):
    profile = {"technique": technique, "k": str(k), "m": str(m)}
    port = create_erasure_code({**profile, "plugin": "ec_torch",
                                "device": "cpu"})
    ref = jcreate({**profile, "plugin": "ec_jax"})
    unit = port.get_chunk_size(k * 4096)
    assert unit == ref.get_chunk_size(k * 4096)
    return port, ref, ec_util.StripeInfo(k, k * unit)


def _shards(codec, sinfo, data: bytes):
    padded = data + bytes(-len(data) % sinfo.get_stripe_width())
    return ec_util.encode(sinfo, codec, padded,
                          range(codec.get_chunk_count()))


def _combine(kern, k: int, dec) -> bytes:
    dec = bytes(dec)
    return kern.combine([dec[i * kern.lanes:(i + 1) * kern.lanes]
                         for i in range(k)])


@pytest.mark.parametrize("k,m", SHAPES)
@pytest.mark.parametrize("name", LINEAR)
def test_linear_kernels_commute_first_k(k, m, name):
    """Every k-subset of the k+m coded shards, decoded in the result
    domain (one decode_many call for all subsets), gives the JAX kernel's
    host reference; the per-shard results equal the JAX
    shard_eval_batch's."""
    kern, jkern = compute.get_kernel(name), jcompute.get_kernel(name)
    assert kern.linear and jkern.linear
    codec, _ref_codec, sinfo = _codecs(k, m)
    assert codec.supports_result_decode()
    rng = np.random.default_rng(SEED + 17 * k + m)
    data = rng.integers(0, 256, 2 * sinfo.get_stripe_width() + 321,
                        dtype=np.uint8).tobytes()
    shards = _shards(codec, sinfo, data)
    want = bytes(jkern.reference(data, {}, k=k,
                                 chunk=sinfo.get_chunk_size()))
    assert bytes(kern.reference(data, {}, k=k,
                                chunk=sinfo.get_chunk_size())) == want
    n = codec.get_chunk_count()
    results = compute.shard_eval_batch(kern, [shards[i] for i in range(n)],
                                       {}, device="cpu")
    jresults = jcompute.shard_eval_batch(
        jkern, [bytes(shards[i]) for i in range(n)], {})
    assert [bytes(r) for r in results] == [bytes(r) for r in jresults]
    subsets = list(itertools.combinations(range(n), k))
    rsinfo = ec_util.StripeInfo(k, k * kern.lanes)
    decoded = ec_util.decode_many(
        rsinfo, codec, [{i: results[i] for i in ids} for ids in subsets])
    for ids, dec in zip(subsets, decoded):
        assert _combine(kern, k, dec) == want, (name, k, m, ids)


@pytest.mark.parametrize("weights", ["ones", "fingerprint", "random"])
@pytest.mark.parametrize("shape", [(1, 1, 32), (3, 5, 32), (7, 129, 32),
                                   (2, 1000, 64), (4, 33, 12)], ids=str)
def test_fold_plain_equals_the_jax_device_body(shape, weights):
    """gf_fold_plain against make_device_eval(w) jitted on the CPU (the
    XLA code the kernel replaces) and against host_eval."""
    b, rows, lanes = shape
    rng = np.random.default_rng(SEED + rows)
    data = rng.integers(0, 256, shape, dtype=np.uint8)
    data[:, ::3, ::2] = 0
    if weights == "ones":
        w = np.ones(rows, dtype=np.uint8)
    elif weights == "fingerprint":
        w = np.array(kernels.GfFingerprint().row_weights(rows)).reshape(-1)
    else:
        w = rng.integers(0, 256, rows, dtype=np.uint8)
    want = np.asarray(jax.jit(jkernels.make_device_eval(w[None, :]))(data))
    np.testing.assert_array_equal(want, jkernels.host_eval(w[None, :], data))
    wt = None if weights == "ones" else torch.from_numpy(w)
    got = fold_kernels.gf_fold_plain(wt, torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.full((b, 1, lanes), 7, dtype=torch.uint8)
    assert fold_kernels.gf_fold(wt, torch.from_numpy(data), out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(
        plan.compute_eval(f"test/{weights}", w, data,
                          torch.device("cpu")), want)


def test_fingerprint_weights_are_the_reference_stream():
    """A fresh default_rng(0xCE9) stream per row count (never a slice of a
    longer one), memoized; both packages draw the same bytes."""
    port, ref = kernels.GfFingerprint(), jkernels.GfFingerprint()
    for rows in (0, 1, 7, 1000, 4096, 262144, 1000):
        got = port.row_weights(rows)
        np.testing.assert_array_equal(got, ref.row_weights(rows))
        if rows:
            np.testing.assert_array_equal(
                got, np.random.default_rng(0xCE9).integers(
                    1, 256, (1, rows), dtype=np.uint8))
        assert not got.flags.writeable


@pytest.mark.parametrize("name", LINEAR)
def test_linear_kernels_ragged_sizes_and_pad_invariance(name):
    kern = compute.get_kernel(name)
    codec, _ref, sinfo = _codecs(3, 2)
    rng = np.random.default_rng(SEED + 5)
    streams = []
    for size in SIZES:
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        shards = _shards(codec, sinfo, data)
        streams.extend(shards[i] for i in range(5))
    streams += [b"", b"\x01" * 31]
    batched = compute.shard_eval_batch(kern, streams, {}, device="cpu")
    jbatched = jcompute.shard_eval_batch(
        jcompute.get_kernel(name), [bytes(s) for s in streams], {})
    assert [bytes(r) for r in batched] == [bytes(r) for r in jbatched]
    for stream, got in zip(streams, batched):
        assert bytes(got) == bytes(kern.eval_stream(stream))
    data = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    for pad in (1, 24, 64, 4096):
        one, padded = compute.shard_eval_batch(
            kern, [data, data + bytes(pad)], {}, device="cpu")
        assert bytes(one) == bytes(padded) == bytes(kern.eval_stream(data))


@pytest.mark.parametrize("k,m", [(4, 2), (8, 3)])
def test_decode_many_equals_jax(k, m):
    """Mixed survivor sets and lengths: the port's decode_many gives the
    JAX decode_many's bytes, request by request."""
    codec, ref_codec, _sinfo = _codecs(k, m)
    rsinfo = ec_util.StripeInfo(k, k * 32)
    jrsinfo = jec_util.StripeInfo(k, k * 32)
    rng = np.random.default_rng(SEED + k)
    maps = []
    for n, lost in enumerate([(), (0,), (1,), (0,), (0, 2), (), (1,)]):
        stripes = 1 + n % 3
        data = rng.integers(0, 256, stripes * k * 32, dtype=np.uint8)
        shards = _shards(codec, rsinfo, data.tobytes())
        have = [i for i in range(k + m) if i not in lost][:k]
        maps.append({i: bytes(shards[i]) for i in have})
    got = ec_util.decode_many(rsinfo, codec, maps)
    want = jec_util.decode_many(jrsinfo, ref_codec, maps)
    assert [bytes(g) for g in got] == [bytes(w) for w in want]


@pytest.mark.parametrize("technique", ["reed_sol_van", "reed_sol_r6_op",
                                       "cauchy_orig", "cauchy_good"])
@pytest.mark.parametrize("mapping", [None, "_DD_D"])
def test_supports_result_decode_parity(technique, mapping):
    profile = {"technique": technique, "k": "3", "m": "2"}
    if mapping:
        profile["mapping"] = mapping
    if technique == "reed_sol_r6_op":
        profile["m"] = "2"
    port = create_erasure_code({**profile, "plugin": "ec_torch",
                                "device": "cpu"})
    ref = jcreate({**profile, "plugin": "ec_jax"})
    assert port.supports_result_decode() == ref.supports_result_decode()
    assert port.supports_result_decode() == (
        not technique.startswith("cauchy") and mapping is None)


def test_wide_words_and_layered_codecs_are_refused():
    """w = 16 answers False in the reference; the port's codec refuses the
    profile itself.  LRC has no result decode in either package."""
    ref = jcreate({"plugin": "ec_jax", "technique": "reed_sol_van",
                   "k": "4", "m": "2", "w": "16"})
    assert not ref.supports_result_decode()
    with pytest.raises(ErasureCodeError):
        create_erasure_code({"plugin": "ec_torch", "technique":
                             "reed_sol_van", "k": "4", "m": "2", "w": "16",
                             "device": "cpu"})
    lrc = create_erasure_code({"plugin": "lrc", "k": "4", "m": "2", "l": "3",
                               "device": "cpu"})
    jlrc = jcreate({"plugin": "lrc", "k": "4", "m": "2", "l": "3"})
    for codec in (lrc, jlrc):
        fn = getattr(codec, "supports_result_decode", None)
        assert fn is None or not fn()


def test_registry_has_the_reference_kernel_set():
    port = compute.registered_kernels()
    ref = jcompute.registered_kernels()
    assert sorted(port) == sorted(ref)
    for name, kern in port.items():
        assert (kern.linear, kern.approx_capable, kern.qos_class,
                kern.lanes) == (ref[name].linear, ref[name].approx_capable,
                                ref[name].qos_class, ref[name].lanes)
    assert {n for n, k in port.items() if k.linear} == set(LINEAR)


def _records(rng) -> bytes:
    vals = rng.integers(0, 1 << 32, 500, dtype=np.uint64)
    return vals.astype("<u8").tobytes() + b"tail"


NONLINEAR_CASES = [
    ("count", {"record": 8, "cmp": "lt", "value": 1 << 31}),
    ("sum", {"record": 8, "off": 0, "len": 8, "cmp": "ge",
             "value": 1 << 30}),
    ("min", {"record": 8}),
    ("max", {"record": 4, "off": 1, "len": 2, "cmp": "ne", "value": 7}),
    ("filter", {"record": 8, "cmp": "lt", "value": 1 << 31, "limit": 7}),
    ("compress_score", {}),
    ("compress_score", {"block": 512}),
    ("dot_score", {"dim": 4, "query": [1.0, -2.0, 0.5, 3.0]}),
]


# random bytes read as float32 vectors hold infinities and NaNs: dot_score
# overflows in both packages alike
@pytest.mark.filterwarnings("ignore:.*encountered in matmul:RuntimeWarning")
@pytest.mark.parametrize("name,args", NONLINEAR_CASES,
                         ids=[f"{n}-{i}" for i, (n, _a) in
                              enumerate(NONLINEAR_CASES)])
def test_nonlinear_kernels_canon_json_bytes(name, args):
    rng = np.random.default_rng(SEED + 3)
    datas = [_records(rng), b"", b"\x00" * 16384,
             rng.integers(0, 256, 16384, dtype=np.uint8).tobytes(),
             # from 64 KiB on the scoring counts with score_blocks' plain
             # version (device="cpu"), below it on the host
             rng.integers(0, 8, 1 << 17, dtype=np.uint8).tobytes()]
    port, ref = compute.get_kernel(name), jcompute.get_kernel(name)
    for data in datas:
        got = port.eval_object(data, args, device="cpu")
        assert got == ref.eval_object(data, args)
        assert got == port.reference(data, args, device="cpu")
        json.loads(got)


def test_malformed_wire_args_surface_as_einval():
    kern, jkern = compute.get_kernel("count"), jcompute.get_kernel("count")
    for bad in ({"record": None}, {"record": "x"}, {"record": 1 << 70},
                {"cmp": "lt", "value": -1}, {"cmp": "lt", "value": None},
                {"cmp": "between"}, {"record": 8, "off": 4, "len": 8}):
        with pytest.raises(compute.ComputeError) as got:
            kern.eval_object(b"\x00" * 64, bad, device="cpu")
        with pytest.raises(jcompute.ComputeError) as want:
            jkern.eval_object(b"\x00" * 64, bad)
        assert got.value.rc == want.value.rc == compute.EINVAL
    dot = compute.get_kernel("dot_score")
    with pytest.raises(compute.ComputeError):
        dot.eval_object(b"\x00" * 64,
                        {"dim": 4, "query": ["a", "b", "c", "d"]})
    with pytest.raises(compute.ComputeError):
        dot.validate_args({"dim": None, "query": []})
    with pytest.raises(compute.ComputeError):
        compute.get_kernel("compress_score").eval_object(
            b"x", {"block": 0}, device="cpu")
    for raw in ("[1]", "nope"):
        with pytest.raises(compute.ComputeError):
            kernels.parse_args(raw)
    assert kernels.parse_args("") == {} == jkernels.parse_args("")
    assert compute.canon_json({"b": 1, "a": [2]}) == \
        jcompute.canon_json({"b": 1, "a": [2]})


def test_kill_switch_env(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_COMPUTE", "0")
    assert not compute.env_enabled() and not jcompute.env_enabled()
    monkeypatch.setenv("CEPH_TPU_COMPUTE", "1")
    assert compute.env_enabled() and jcompute.env_enabled()


def test_shard_eval_needs_a_device(monkeypatch):
    """No device named and no card: the scan raises instead of running on
    the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        compute.shard_eval_batch(compute.get_kernel("gf_fold"),
                                 [b"\x01" * 64], {})
