"""The port's coded-inference library (ceph_tpu_torch.inference and
ec/plan.inference_eval) against the JAX package's, on the CPU; mirrors the
host half of tests/test_inference.py.

The store-time build (spec and object bytes), the host forwards
(`shard_forward`, `exact_forward`) and the Fisher combine are numpy copies,
held bit for bit.  The per-shard forwards on the device, `inference_eval`
(torch.einsum, float32 at the highest matmul precision) and
InferShardKernel.shard_eval, are held against the JAX inference_eval (XLA
on the CPU) and the numpy forward within a float32 tolerance: the sums run
in another order, so each element may differ by a few ulps of the
magnitudes summed, and the test allows RTOL times the largest |value| of
the result (with dim <= 256 terms, 1e-5 is over a hundred times the
float32 epsilon that one reordered dot product can move).
"""

import itertools

import numpy as np
import pytest

from ceph_tpu.ec import plan as jplan
from ceph_tpu.inference import fisher as jfisher
from ceph_tpu.inference import kernels as jkernels
from ceph_tpu.inference import model as jmodel
from ceph_tpu.inference import registry as jregistry
from ceph_tpu_torch import compute
from ceph_tpu_torch.ec import plan
from ceph_tpu_torch.inference import fisher, kernels, model, registry

RTOL = 1e-5
BUILDS = [("linear", 2, 1), ("linear", 3, 2), ("linear", 4, 2),
          ("mlp", 2, 1), ("mlp", 3, 2), ("mlp", 6, 2)]


def _built(pkg_registry, kind, k, m, dim=24, out=36, seed=5, chunk=512):
    hidden = 24 if kind == "mlp" else 0   # divisible by every k here
    return pkg_registry.build(
        f"t-{kind}-{k}-{m}", kind,
        pkg_registry.make_model(kind, dim, out, seed=seed, hidden=hidden),
        k, m, chunk)


def _streams(spec, blobs):
    data = blobs[registry.params_oid(spec["name"])]
    return data, model.object_streams(spec, data)


def _queries(dim, nq=12, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (nq, dim)).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("kind,k,m", BUILDS)
def test_build_spec_and_blobs_identical(kind, k, m):
    spec, blobs = _built(registry, kind, k, m)
    jspec, jblobs = _built(jregistry, kind, k, m)
    assert spec == jspec
    assert blobs == jblobs
    params = registry.make_model(kind, 24, 36, seed=9,
                                 hidden=24 if kind == "mlp" else 0)
    jparams = jregistry.make_model(kind, 24, 36, seed=9,
                                   hidden=24 if kind == "mlp" else 0)
    assert params.keys() == jparams.keys()
    for name in params:
        assert params[name].tobytes() == jparams[name].tobytes()


@pytest.mark.parametrize("kind,k,m", BUILDS)
def test_host_forwards_and_combine_bit_equal(kind, k, m):
    spec, blobs = _built(registry, kind, k, m)
    data, streams = _streams(spec, blobs)
    q = _queries(int(spec["dim"]))
    for i, s in enumerate(streams):
        assert model.shard_forward(spec, s, q).tobytes() == \
            jmodel.shard_forward(spec, s, q).tobytes(), i
    exact = model.exact_forward(spec, data, q)
    assert exact.tobytes() == jmodel.exact_forward(spec, data, q).tobytes()
    parts = {i: model.shard_forward(spec, streams[i], q) for i in range(k)}
    fused = {j: model.shard_forward(spec, streams[k + j], q)
             for j in range(m)}
    for lost in itertools.chain.from_iterable(
            itertools.combinations(range(k), n) for n in range(m + 1)):
        dp = {i: p for i, p in parts.items() if i not in lost}
        for budget in (None, 0.05, 1e-300):
            got = fisher.combine(spec, dp, fused, q, budget)
            want = jfisher.combine(spec, dp, fused, q, budget)
            assert (got is None) == (want is None), (lost, budget)
            if got is not None:
                assert got[0].tobytes() == want[0].tobytes()
                assert got[1:] == want[1:]


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_inference_eval_against_jax(kind):
    """The port's forwards (torch.einsum on the CPU) against the JAX
    inference_eval (XLA on the CPU) and the numpy forward, within RTOL."""
    spec, blobs = _built(registry, kind, 6, 2, dim=64, out=96)
    _data, streams = _streams(spec, blobs)
    params = [model.unpack_stream(spec, s) for s in streams]
    if kind == "linear":
        ops = (np.stack([p["table"] for p in params]),)
    else:
        ops = tuple(np.stack([p[n] for p in params])
                    for n in ("w1", "b1", "w2"))
    q = _queries(64, nq=9)
    got = plan.inference_eval(kind, ops, q, "cpu")
    want = jplan.inference_eval(kind, ops, q, jkernels.plan_sig(spec))
    assert want is not None
    _close(got, want)
    for i, s in enumerate(streams):
        _close(got[i], model.shard_forward(spec, s, q))


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_infer_shard_kernel_against_jax(kind):
    """InferShardKernel.shard_eval on the port (device="cpu") against the
    JAX kernel's, stream by stream, with a short stream answering empty;
    the exact `infer` kernel's result blob is byte-identical."""
    spec, blobs = _built(registry, kind, 3, 2)
    data, streams = _streams(spec, blobs)
    q = _queries(int(spec["dim"]))
    args = {"model": spec, "q": kernels.encode_queries(q), "stream": 0}
    payloads = list(streams) + [bytes(7)]
    port = compute.get_kernel("infer_shard")
    ref = jkernels.InferShardKernel()
    got = port.shard_eval(payloads, args, device="cpu")
    want = ref.shard_eval(payloads, args)
    assert got[-1] == want[-1] == b""
    for g, w in zip(got[:-1], want[:-1]):
        _close(np.frombuffer(g, "<f4"), np.frombuffer(w, "<f4"))
    infer = compute.get_kernel("infer")
    blob = infer.eval_object(data, args, device="cpu")
    assert blob == jkernels.InferKernel().eval_object(data, args)
    assert kernels.decode_result(blob)["scores"].tobytes() == \
        model.exact_forward(spec, data, q).tobytes()
    with pytest.raises(compute.ComputeError):
        port.validate_args({**args, "stream": 5})
    with pytest.raises(compute.ComputeError):
        port.eval_object(data, args, device="cpu")


@pytest.mark.parametrize("kind,k,m", [("linear", 2, 1), ("linear", 3, 2),
                                      ("linear", 4, 2), ("mlp", 2, 1),
                                      ("mlp", 3, 2)])
def test_bound_honesty_across_all_patterns(kind, k, m):
    """Every (data subset, fused subset) pattern either refuses (more
    missing than fused answered) or serves with true relative error within
    the estimate, and the port's estimate is the JAX package's."""
    spec, blobs = _built(registry, kind, k, m)
    data, streams = _streams(spec, blobs)
    q = _queries(int(spec["dim"]))
    exact = model.exact_forward(spec, data, q)
    eref = float(np.linalg.norm(exact)) or 1.0
    parts = {i: model.shard_forward(spec, streams[i], q) for i in range(k)}
    fused = {j: model.shard_forward(spec, streams[k + j], q)
             for j in range(m)}
    served = refused = 0
    for nd in range(k + 1):
        for dsub in itertools.combinations(range(k), nd):
            for nf in range(m + 1):
                for fsub in itertools.combinations(range(m), nf):
                    dp = {i: parts[i] for i in dsub}
                    fp = {j: fused[j] for j in fsub}
                    res = fisher.combine(spec, dp, fp, q, None)
                    jres = jfisher.combine(spec, dp, fp, q, None)
                    if k - nd > nf:
                        assert res is None and jres is None
                        refused += 1
                        continue
                    scores, est, substituted = res
                    assert substituted == k - nd
                    assert est == jres[1]
                    rel = float(np.linalg.norm(scores - exact)) / eref
                    assert rel <= max(est, 1e-6), (dsub, fsub, rel, est)
                    served += 1
    assert served and refused


def test_structural_error_and_budget_gate():
    spec, _blobs = _built(registry, "linear", 3, 2)
    qscale = fisher.query_scale(_queries(24))
    assert qscale == jfisher.query_scale(_queries(24))
    for present, fused in (([0, 1, 2], []), ([0, 1], [0]), ([0], [0]),
                           ([0, 1], []), ([0], [0, 1])):
        assert fisher.structural_error(spec, present, fused, qscale) == \
            jfisher.structural_error(spec, present, fused, qscale)
    assert fisher.check_budget(0.01, 0.05) and fisher.check_budget(1.0, None)
    assert not fisher.check_budget(0.06, 0.05)


def test_result_blob_and_manifest_validation():
    scores = np.arange(24, dtype=np.float32).reshape(4, 6) / 7.0
    blob = kernels.result_blob(scores, "approx", 0.0125, 2)
    assert blob == jkernels.result_blob(scores, "approx", 0.0125, 2)
    out = kernels.decode_result(blob)
    assert out["scores"].tobytes() == scores.tobytes()
    assert (out["mode"], out["substituted"]) == ("approx", 2)
    spec, _blobs = _built(registry, "linear", 2, 1)
    model.validate_spec(spec)
    for mutate in (lambda s: s.pop("kind"), lambda s: s.update(kind="rnn"),
                   lambda s: s.update(k=0),
                   lambda s: s.update(shard_rows=[1])):
        bad = dict(spec)
        mutate(bad)
        with pytest.raises(ValueError):
            model.validate_spec(bad)
        with pytest.raises(ValueError):
            jmodel.validate_spec(bad)
    q = _queries(24)
    assert kernels.encode_queries(q) == jkernels.encode_queries(q)
    for raw in ("!!", kernels.encode_queries(q[:, :5])):
        with pytest.raises(compute.ComputeError):
            kernels.decode_queries(spec, raw)
    with pytest.raises(compute.ComputeError):
        kernels.parse_infer_args({"model": spec, "q": "", "budget": "x"})
