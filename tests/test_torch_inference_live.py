"""Coded inference served through the port's OSDs (ceph_tpu_torch.osd.inference
and the client's `store_model` and `infer`) against the JAX package's, on
the CPU; mirrors the live-cluster tests of tests/test_inference.py.

Each history runs on a port cluster (port OSDs on `device="cpu"`) and on a
JAX cluster with the same seeded model and queries.  Exact serving
(exact=True) must be bit-identical to the CEPH_TPU_INFERENCE=0
read-then-infer leg and to the JAX cluster's; budget-served scores must be
within INFER_RTOL of the JAX cluster's (the shard forwards are
`plan.inference_eval`'s torch.einsum here and XLA there) and within the
budget of the exact scores; the stored model's shards and the engines'
op, query, fallback and error counters must equal the JAX cluster's.
"""

import os
import time

import numpy as np
import pytest

from ceph_tpu_torch.inference import registry as tregistry

from test_torch_osd import both, ec_profile, run
from torch_cluster_helpers import Cluster
from torch_cluster_helpers import one_torch_thread  # noqa: F401
from torch_mon_helpers import pkg

#: relative norm of a port score matrix against the JAX cluster's: the
#: contributions are float32 sums of at most `dim` terms taken in another
#: order
INFER_RTOL = 1e-5
BUDGET = 0.05
COUNTERS = ("ops", "queries", "exact_fallbacks", "errors")


def _serving_osd_config():
    return {"osd_heartbeat_interval": 3.0}


async def _serve(cluster, kind, mkind="linear", dim=32, out=64, seed=21):
    await cluster.client.create_ec_pool("ipool", ec_profile(kind, 3, 2),
                                        pg_num=8)
    io = cluster.client.open_ioctx("ipool")
    registry = pkg(kind, "inference.registry")
    hidden = 24 if mkind == "mlp" else 0  # split over k_model = 2
    spec = await io.store_model(
        "m0", mkind, registry.make_model(mkind, dim, out, seed=seed,
                                         hidden=hidden), m=1)
    return io, spec


async def _killswitch(io, spec, q):
    os.environ["CEPH_TPU_INFERENCE"] = "0"
    try:
        return await io.infer(spec, q)
    finally:
        del os.environ["CEPH_TPU_INFERENCE"]


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _counters(cluster) -> dict:
    out = {key: 0 for key in COUNTERS}
    for osd in cluster.osds.values():
        perf = osd.inference.perf_dump()
        for key in COUNTERS:
            out[key] += perf[key]
    return out


def _close_to_jax(scores: dict) -> None:
    """Every budget-served score matrix of the port run within INFER_RTOL
    of the JAX run's (same queries, same order)."""
    assert len(scores["torch"]) == len(scores["jax"]) > 0
    for got, want in zip(scores["torch"], scores["jax"]):
        assert got.shape == want.shape
        assert _rel(got, want) <= INFER_RTOL


@pytest.mark.parametrize("mkind", ["linear", "mlp"])
def test_killswitch_parity_and_approx_budget_live(mkind):
    """exact=True through the code is bit-identical to the
    CEPH_TPU_INFERENCE=0 leg and to the JAX cluster's; budget serving
    stays within the budget of the exact scores and close to the JAX
    cluster's; the counters attribute the ops as the JAX engines do."""
    served_scores = {}

    async def work(cluster, kind):
        io, spec = await _serve(cluster, kind, mkind)
        rng = np.random.default_rng(2)
        replies, served_scores[kind] = [], []
        for _ in range(4):
            q = rng.standard_normal((8, 32)).astype(np.float32)
            ex = await io.infer(spec, q, exact=True)
            assert ex["mode"] == "exact" and ex["est_error"] == 0.0
            ref = await _killswitch(io, spec, q)
            assert ref["mode"] == "exact"
            assert ex["scores"].tobytes() == ref["scores"].tobytes()
            served = await io.infer(spec, q, budget=BUDGET)
            assert served["est_error"] <= BUDGET
            assert _rel(served["scores"], ex["scores"]) <= BUDGET
            replies.append(ex["scores"].tobytes())
            served_scores[kind].append(served["scores"])
        counters = _counters(cluster)
        assert counters["ops"] >= 8 and counters["exact_fallbacks"] >= 4
        assert counters["errors"] == 0
        replies.append(counters)
        return replies
    both(work, num_osds=5, osds_per_host=5,
         osd_config=_serving_osd_config())
    _close_to_jax(served_scores)


def test_shard_loss_served_within_budget_live():
    """A dead serving-stream holder: queries keep serving through the
    survivors (fused substitution or the exact fallback), within the
    budget of the pre-loss exact scores and close to the JAX
    cluster's."""
    served_scores = {}

    async def work(cluster, kind):
        io, spec = await _serve(cluster, kind)
        q = np.random.default_rng(4).standard_normal(
            (8, 32)).astype(np.float32)
        ex = await io.infer(spec, q, exact=True)
        acting, primary = cluster.mon.osdmap.pg_to_acting_osds(
            io.object_pg(spec["params_oid"]))
        nstreams = int(spec["k"]) + int(spec["m"])
        victim = next(o for o in acting[:nstreams]
                      if o != primary and o >= 0)
        await cluster.kill_osd(victim)
        await cluster.mark_down(victim)
        await cluster.wait_for_clean(60.0)
        res = await io.infer(spec, q, budget=BUDGET)
        assert res["est_error"] <= BUDGET
        assert _rel(res["scores"], ex["scores"]) <= BUDGET
        served_scores[kind] = [res["scores"]]
        after = await io.infer(spec, q, exact=True)
        assert after["scores"].tobytes() == ex["scores"].tobytes()
        return [ex["scores"].tobytes(), victim]
    both(work, num_osds=5, osds_per_host=5,
         osd_config=_serving_osd_config())
    _close_to_jax(served_scores)


def test_straggler_first_sufficient_live():
    """One slow serving-stream holder: the hedged sub-infer fan-out
    completes from the first structurally sufficient arrival set in a
    fraction of the injected delay, within budget."""
    delay = 2.0

    async def work(cluster, kind):
        io, spec = await _serve(cluster, kind)
        q = np.random.default_rng(6).standard_normal(
            (8, 32)).astype(np.float32)
        ex = await io.infer(spec, q, exact=True)
        await io.infer(spec, q)  # warm the latency model + admission
        acting, primary = cluster.mon.osdmap.pg_to_acting_osds(
            io.object_pg(spec["params_oid"]))
        nstreams = int(spec["k"]) + int(spec["m"])
        slow = next(o for o in acting[:nstreams]
                    if o != primary and o >= 0)
        cluster.osds[slow].msgr.inject_internal_delays = delay
        try:
            t0 = time.monotonic()
            res = await io.infer(spec, q, budget=BUDGET)
            elapsed = time.monotonic() - t0
        finally:
            cluster.osds[slow].msgr.inject_internal_delays = 0
        assert elapsed < delay, elapsed
        assert res["est_error"] <= BUDGET
        assert _rel(res["scores"], ex["scores"]) <= BUDGET
        return [ex["scores"].tobytes()]
    both(work, num_osds=5, osds_per_host=5,
         osd_config=_serving_osd_config())


def test_store_model_demands_ec_pool_and_validates():
    """store_model on a replicated pool and infer with a malformed spec
    both raise RadosError, not engine tracebacks."""
    async def main():
        from ceph_tpu_torch.rados.client import RadosError

        cluster = Cluster(num_osds=4)
        await cluster.start()
        try:
            await cluster.client.create_replicated_pool("rp", size=3,
                                                        pg_num=8)
            io = cluster.client.open_ioctx("rp")
            with pytest.raises(RadosError):
                await io.store_model(
                    "m1", "linear",
                    tregistry.make_model("linear", 8, 8, seed=1))
            with pytest.raises(RadosError):
                await io.infer({"kind": "rnn"}, np.zeros((1, 8)))
        finally:
            await cluster.stop()

    run(main())


@pytest.mark.parametrize("kind", ["torch", "jax"])
def test_stripe_unit_layout_and_below_k_streams(kind):
    """Two behaviours of the reference that the port copies (ROADMAP C8,
    C9), each run on both packages.  On a pool whose profile sets its
    stripe_unit, store_model still lays the model out at 4096-byte units,
    so every query meets a layout mismatch and takes the exact path.
    With fewer than k serving streams' holders up (the object still
    decodable from the pool's parity shards), the engine answers EAGAIN
    until the client gives up; the exact path still serves."""
    async def main():
        cluster = Cluster(num_osds=6, osds_per_host=1, kinds=[kind] * 6,
                          mon_kind=kind, client_kind=kind)
        await cluster.start()
        try:
            await cluster.client.create_ec_pool(
                "su", {**ec_profile(kind, 3, 2), "stripe_unit": "8192"},
                pg_num=8)
            io = cluster.client.open_ioctx("su")
            registry = pkg(kind, "inference.registry")
            spec = await io.store_model(
                "m0", "linear", registry.make_model("linear", 32, 64,
                                                    seed=21), m=1)
            q = np.random.default_rng(8).standard_normal(
                (8, 32)).astype(np.float32)
            ex = await io.infer(spec, q, exact=True)
            served = await io.infer(spec, q, budget=BUDGET)
            mismatch = sum(o.inference.perf_dump()["layout_mismatch"]
                           for o in cluster.osds.values())
            assert spec["chunk"] == 4096
            assert served["mode"] == "exact" and mismatch == 1
            assert served["scores"].tobytes() == ex["scores"].tobytes()
            # a pool at the default unit, where both packages' layouts
            # match; two of its model's three serving streams' holders
            # down
            await cluster.client.create_ec_pool(
                "dk", ec_profile(kind, 3, 2), pg_num=8)
            io = cluster.client.open_ioctx("dk")
            spec = await io.store_model(
                "m1", "linear", registry.make_model("linear", 32, 64,
                                                    seed=21), m=1)
            ex = await io.infer(spec, q, exact=True)
            assert (await io.infer(spec, q, budget=BUDGET))["mode"] \
                != "exact"
            acting, primary = cluster.mon.osdmap.pg_to_acting_osds(
                io.object_pg(spec["params_oid"]))
            victims = [o for o in acting[:3] if o != primary][:2]
            for v in victims:
                await cluster.kill_osd(v)
                await cluster.mark_down(v)
            await cluster.wait_for_clean(60.0)
            impatient = cluster.new_client(kind, max_retries=2)
            await impatient.connect()
            try:
                iio = impatient.open_ioctx("dk")
                err = pkg(kind, "rados.client").RadosError
                with pytest.raises(err) as e:
                    await iio.infer(spec, q, budget=BUDGET)
                assert e.value.rc == -11
                res = await iio.infer(spec, q, exact=True)
                assert res["mode"] == "exact"
                assert res["scores"].tobytes() == ex["scores"].tobytes()
            finally:
                await impatient.shutdown()
        finally:
            await cluster.stop()
    run(main(), 120)
