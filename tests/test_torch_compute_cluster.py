"""Coded compute through the port's OSDs (ceph_tpu_torch.osd.compute and the
client's `compute`) against the JAX package's, on the CPU; mirrors
tests/test_compute_cluster.py.

Each scan runs on a port cluster (port OSDs on `device="cpu"`, whose
sub-computes fold their shards with gf_fold's plain version) and on a JAX
cluster with the same seeded objects: every answer must be bit-identical
to the JAX cluster's and to the CEPH_TPU_COMPUTE=0 read-then-compute leg,
the engines' counters (`pushdown_objects`, `fallback_objects`, `waves`)
must equal the JAX cluster's, and the stores must be equal.  The linear
scans move no sub-read bytes.  A mixed cluster serves scans whose JAX
primaries fan out to port OSDs and the reverse, and a result-domain decode
that raises answers EIO for its wave's objects, with no retry.
"""

import json
import os
import time

import numpy as np

from ceph_tpu_torch.osd import daemon as tdaemon
from ceph_tpu_torch.osd import ec_util as tec_util

from test_torch_osd import both, ec_profile, run
from torch_cluster_helpers import Cluster
from torch_cluster_helpers import one_torch_thread  # noqa: F401

ENGINE_COUNTERS = ("ops", "objects", "pushdown_objects",
                   "fallback_objects", "waves", "result_bytes", "errors")


async def _fill(io, n, seed=7, size=8192):
    payloads = {}
    rng = np.random.default_rng(seed)
    for i in range(n):
        data = rng.integers(0, 256, size + 17 * i,
                            dtype=np.uint8).tobytes()
        payloads[f"o{i}"] = data
        await io.write_full(f"o{i}", data)
    return payloads


async def _killswitch(io, kernel, oids, args=None):
    """The CEPH_TPU_COMPUTE=0 leg: client-side read-then-compute."""
    os.environ["CEPH_TPU_COMPUTE"] = "0"
    try:
        return await io.compute(kernel, oids, args)
    finally:
        del os.environ["CEPH_TPU_COMPUTE"]


def _as_bytes(results):
    return {o: bytes(r) for o, r in sorted(results.items())}


def _engine_counters(cluster):
    out = {key: 0 for key in ENGINE_COUNTERS}
    for o in cluster.osds.values():
        perf = o.compute.perf()
        for key in ENGINE_COUNTERS:
            out[key] += perf[key]
    return out


def _subread_bytes(cluster):
    return sum(o.perf["subread_bytes"] for o in cluster.osds.values())


def test_scan_pushdown_matches_read_then_compute():
    """A linear AND a nonlinear kernel: pushdown results equal the
    client-side read-then-compute leg and the JAX cluster's, the linear
    pushdown moves no sub-read bytes, and the engines' counters
    attribute the paths as the JAX engines do."""
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "cpool", ec_profile(kind, 2, 2), pg_num=8)
        io = cluster.client.open_ioctx("cpool")
        payloads = await _fill(io, 10)
        oids = sorted(payloads)
        before = _subread_bytes(cluster)
        results, errors = await io.compute("gf_fold", oids)
        assert not errors and set(results) == set(oids)
        # the pushdown moved ZERO payload bytes
        assert _subread_bytes(cluster) == before
        ref, referr = await _killswitch(io, "gf_fold", oids)
        assert not referr
        assert _as_bytes(results) == _as_bytes(ref)
        # the parity leg DID move the payloads over sub-reads
        assert _subread_bytes(cluster) > before
        res, err = await io.compute("count", oids, {"record": 8})
        assert not err
        for oid, r in res.items():
            assert json.loads(r)["count"] == len(payloads[oid]) // 8
        ref2, _ = await _killswitch(io, "count", oids, {"record": 8})
        assert _as_bytes(res) == _as_bytes(ref2)
        counters = _engine_counters(cluster)
        assert counters["pushdown_objects"] == len(oids)
        assert counters["fallback_objects"] == len(oids)
        res3, err3 = await io.compute("gf_fold", ["nope"])
        assert not res3 and err3 == {"nope": -2}
        return [_as_bytes(results), _as_bytes(res), counters,
                _engine_counters(cluster)]
    both(work, num_osds=5, osds_per_host=5)


def test_scan_p99_flat_under_one_slow_osd():
    """One acting-set OSD delayed 2 s: the hedged first-k sub-compute
    fan-out completes every object from the other shards in a fraction of
    the delay, bit-exactly."""
    delay = 2.0

    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "spool", ec_profile(kind, 2, 2), pg_num=8)
        io = cluster.client.open_ioctx("spool")
        payloads = await _fill(io, 8, seed=9)
        oids = sorted(payloads)
        ref, _ = await io.compute("gf_fold", oids)
        counts = {o: 0 for o in cluster.osds}
        for oid in oids:
            _a, p = cluster.mon.osdmap.pg_to_acting_osds(io.object_pg(oid))
            counts[p] = counts.get(p, 0) + 1
        slow = min(sorted(counts), key=lambda o: counts[o])
        targets = [oid for oid in oids
                   if cluster.mon.osdmap.pg_to_acting_osds(
                       io.object_pg(oid))[1] != slow]
        assert targets
        cluster.osds[slow].msgr.inject_internal_delays = delay
        try:
            t0 = time.monotonic()
            results, errors = await io.compute("gf_fold", targets)
            elapsed = time.monotonic() - t0
        finally:
            cluster.osds[slow].msgr.inject_internal_delays = 0
        assert not errors
        assert {o: bytes(results[o]) for o in targets} == \
            {o: bytes(ref[o]) for o in targets}
        assert elapsed < delay, elapsed
        return [_as_bytes(ref), targets]
    both(work, num_osds=5, osds_per_host=5)


def test_scan_survives_a_dead_osd():
    """A dead acting-set member: the remaining shards still complete
    every object, bit-exact (a data shard's result decoded from a parity
    shard's in the result domain)."""
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "dpool", ec_profile(kind, 2, 2), pg_num=8)
        io = cluster.client.open_ioctx("dpool")
        payloads = await _fill(io, 6, seed=13)
        oids = sorted(payloads)
        ref, _ = await io.compute("gf_fold", oids)
        victim = max(cluster.osds)
        await cluster.kill_osd(victim)
        await cluster.mark_down(victim)
        await cluster.wait_for_clean(60.0)
        results, errors = await io.compute("gf_fold", oids)
        assert not errors
        assert _as_bytes(results) == _as_bytes(ref)
        fp, fperr = await io.compute("gf_fingerprint", oids)
        assert not fperr
        fpref, _ = await _killswitch(io, "gf_fingerprint", oids)
        assert _as_bytes(fp) == _as_bytes(fpref)
        return [_as_bytes(results), _as_bytes(fp),
                _engine_counters(cluster)]
    both(work, num_osds=5, osds_per_host=5)


def test_compute_on_replicated_pool_and_scoring_kernels():
    """Replicated pools take the fallback for every kernel; the scoring
    kernels return their canonical JSON; an unknown kernel is EINVAL."""
    async def work(cluster, kind):
        await cluster.client.create_replicated_pool("rp", size=3, pg_num=8)
        io = cluster.client.open_ioctx("rp")
        rng = np.random.default_rng(3)
        noisy = rng.integers(0, 256, 16384, dtype=np.uint8).tobytes()
        await io.write_full("noisy", noisy)
        await io.write_full("flat", b"\x00" * 16384)
        emb = np.zeros((4, 8), dtype=np.float32)
        emb[2] = 1.0
        await io.write_full("emb", emb.tobytes())
        out = []
        res, err = await io.compute("compress_score", ["noisy", "flat"])
        assert not err
        assert json.loads(res["noisy"])["entropy_bpb"] > 7.5
        assert json.loads(res["flat"])["entropy_bpb"] == 0.0
        ref, _ = await _killswitch(io, "compress_score", ["noisy", "flat"])
        assert _as_bytes(res) == _as_bytes(ref)
        out.append(_as_bytes(res))
        res, err = await io.compute("dot_score", ["emb"],
                                    {"dim": 8, "query": [1.0] * 8})
        assert not err
        assert json.loads(res["emb"])["best"] == 2
        out.append(_as_bytes(res))
        res, err = await io.compute("gf_fold", ["noisy"])
        assert not err
        ref, _ = await _killswitch(io, "gf_fold", ["noisy"])
        assert bytes(res["noisy"]) == bytes(ref["noisy"])
        out.append(_as_bytes(res))
        res, err = await io.compute("no_such_kernel", ["noisy"])
        assert not res and err == {"noisy": -22}
        out.append(_engine_counters(cluster))
        return out
    both(work)


def test_scan_traces_name_the_compute_stages():
    """A scan leaves `compute` and `subcompute` stage samples in the
    primaries' critical-path histograms, as the JAX daemons' do."""
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "tpool", ec_profile(kind, 2, 2), pg_num=8)
        io = cluster.client.open_ioctx("tpool")
        await _fill(io, 6, seed=21)
        _res, err = await io.compute("gf_fold", [f"o{i}" for i in range(6)])
        assert not err
        stages = set()
        for osd in cluster.osds.values():
            stages.update(osd.tracer.stage_perf())
        assert any(s.startswith("compute") for s in stages), stages
        assert any("subcompute" in s for s in stages), stages
        # which stages waited in a queue is the host's timing
        return sorted(s for s in stages if s in ("compute", "subcompute"))
    both(work, num_osds=5, osds_per_host=5)


def _mixed_scan(kinds):
    """gf_fold, gf_fingerprint and count over a jerasure 2+2 pool on a
    cluster of `kinds`, healthy and with one OSD dead; returns the
    answers, the engines' counters and which packages' primaries fanned
    out to which packages' OSDs."""
    async def main():
        cluster = Cluster(num_osds=5, osds_per_host=5, kinds=kinds,
                          mon_kind="jax", client_kind="torch")
        await cluster.start()
        try:
            await cluster.client.create_ec_pool(
                "mx", {"plugin": "jerasure", "technique": "reed_sol_van",
                       "k": "2", "m": "2", "crush-failure-domain": "osd",
                       "tpu": "false"}, pg_num=8)
            await cluster.wait_for_clean()
            io = cluster.client.open_ioctx("mx")
            payloads = await _fill(io, 12, seed=17)
            oids = sorted(payloads)
            fan = set()
            for oid in oids:
                acting, p = cluster.mon.osdmap.pg_to_acting_osds(
                    io.object_pg(oid))
                fan |= {(kinds[p], kinds[o]) for o in acting
                        if o >= 0 and o != p}
            answers = []
            for kernel, args in (("gf_fold", None), ("gf_fingerprint", None),
                                 ("count", {"record": 8})):
                res, err = await io.compute(kernel, oids, args)
                assert not err, (kernel, err)
                ref, referr = await _killswitch(io, kernel, oids, args)
                assert not referr and _as_bytes(res) == _as_bytes(ref)
                answers.append(_as_bytes(res))
            await cluster.kill_osd(1)
            await cluster.mark_down(1)
            await cluster.wait_for_clean(60.0)
            res, err = await io.compute("gf_fold", oids)
            assert not err
            answers.append(_as_bytes(res))
            return answers, _engine_counters(cluster), fan
        finally:
            await cluster.stop()
    return run(main(), 120)


def test_mixed_cluster_primaries_fan_out_across_packages():
    """JAX primaries fan sub-computes out to port OSDs and port
    primaries to JAX OSDs: the answers equal the read-then-compute leg's
    and an all-JAX cluster's, healthy and with an OSD dead."""
    mixed, mcount, fan = _mixed_scan(["torch", "jax"] * 2 + ["torch"])
    assert {("jax", "torch"), ("torch", "jax")} <= fan, fan
    jax_only, jcount, _ = _mixed_scan(["jax"] * 5)
    assert mixed == jax_only
    assert mcount == jcount


def test_raising_result_decode_answers_eio(monkeypatch):
    """A result-domain decode that raises is not retried object by
    object on another path: the wave's objects answer EIO, and the
    engine counts the errors."""
    async def main():
        cluster = Cluster(num_osds=5, osds_per_host=5)
        await cluster.start()
        try:
            await cluster.client.create_ec_pool(
                "ep", ec_profile("torch", 2, 2), pg_num=8)
            io = cluster.client.open_ioctx("ep")
            payloads = await _fill(io, 6, seed=23)
            oids = sorted(payloads)
            good, err = await io.compute("gf_fold", oids)
            assert not err and set(good) == set(oids)
            calls = []

            def failing(*a, **kw):
                calls.append(len(a[2]))
                raise RuntimeError("launch failed")

            monkeypatch.setattr(tec_util, "decode_many", failing)
            monkeypatch.setattr(tec_util, "decode", failing)
            res, err = await io.compute("gf_fold", oids)
            assert not res
            assert err == {oid: tdaemon.EIO for oid in oids}
            assert calls and sum(calls) == len(oids)
            assert _engine_counters(cluster)["errors"] == len(oids)
        finally:
            await cluster.stop()
    run(main())


def test_fallback_lock_edges_in_the_static_graph():
    """The full-decode fallback under the port's lockdep: it takes the
    reference's `osd.clslock` -> `osd.objlock` nesting, and every
    order edge the port's daemons record in the scan is an edge of the
    JAX package's static lock graph (ceph_tpu/analysis/lockgraph.py).
    The port's checker keeps its own graph, so this run adds nothing to
    the one tests/test_static_analysis.py reads back."""
    import ceph_tpu
    from ceph_tpu.analysis.core import build_project
    from ceph_tpu.analysis.lockgraph import build_lock_graph
    from ceph_tpu_torch.common import lockdep as tlockdep

    async def main():
        cluster = Cluster(num_osds=6, osds_per_host=1)
        await cluster.start()
        try:
            await cluster.client.create_ec_pool(
                "lk", ec_profile("torch", 2, 2), pg_num=8)
            await cluster.client.create_replicated_pool("lr", size=3,
                                                        pg_num=8)
            for pool in ("lk", "lr"):
                io = cluster.client.open_ioctx(pool)
                payloads = await _fill(io, 6, seed=29)
                oids = sorted(payloads)
                for kernel, args in (("count", {"record": 8}),
                                     ("compress_score", None),
                                     ("gf_fold", None)):
                    _res, err = await io.compute(kernel, oids, args)
                    assert not err, (pool, kernel, err)
            assert sum(o.compute.perf()["fallback_objects"]
                       for o in cluster.osds.values()) == 5 * 6
        finally:
            await cluster.stop()

    was = tlockdep.enabled
    tlockdep.enabled = True
    tlockdep.reset()
    try:
        run(main())
        recorded = {(a, b) for a, bs in tlockdep._edges.items()
                    for b in bs}
    finally:
        tlockdep.enabled = was
        tlockdep.reset()
    assert ("osd.clslock", "osd.objlock") in recorded, recorded
    adj, _ = build_lock_graph(build_project(
        [os.path.dirname(os.path.abspath(ceph_tpu.__file__))]))
    assert not [e for e in recorded if e[1] not in adj.get(e[0], set())]
