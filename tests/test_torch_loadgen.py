"""The port's open-loop load harness (ceph_tpu_torch.loadgen) against the
JAX package's, on the CPU.

The non-slow tests of tests/test_loadgen.py run their bodies with the
`ceph_tpu` names bound to the port's (`on_port`; the file's scripted
`_FakeTarget` rebuilt on the port's Target, so its sheds are the port's
SheddedOp).  Two bodies import `ceph_tpu` inside themselves (the embedded
target on a LocalCluster, `rados bench --tenants`), so they are written out
here on the port: the embedded cluster on `device="cpu"`, and the bench
through the port's rados CLI, in process and as `python -m
ceph_tpu_torch.tools.rados --device cpu ... bench --tenants` against a
port cluster.  Then the port's own: under a fixed seed every tenant's
schedule, the merged schedule and its fingerprint, and the Zipf sampler
equal the JAX functions' outputs.
"""

import argparse
import asyncio
import functools
import json
import subprocess
import sys
import types

import numpy as np
import pytest

from ceph_tpu import loadgen as jloadgen
from ceph_tpu.tools import rados as jrados
from ceph_tpu_torch import loadgen as tloadgen
from ceph_tpu_torch.tools import rados as trados

from torch_cluster_helpers import Cluster
from torch_cluster_helpers import one_torch_thread  # noqa: F401
from test_torch_osd_units import on_port

import test_loadgen as j_loadgen


def _port_fake_target(g):
    """test_loadgen._FakeTarget on the port's Target, its methods bound to
    the port's names."""
    src = j_loadgen._FakeTarget
    ns = {k: (types.FunctionType(v.__code__, g, v.__name__, v.__defaults__,
                                 v.__closure__)
              if isinstance(v, types.FunctionType) else v)
          for k, v in vars(src).items()
          if k not in ("__dict__", "__weakref__")}
    return type(src.__name__, (tloadgen.Target,), ns)


def port_body(name: str):
    fn = on_port(j_loadgen, name,
                 run_embedded=functools.partial(tloadgen.run_embedded,
                                                device="cpu"))
    fn.__globals__["_FakeTarget"] = _port_fake_target(fn.__globals__)
    return fn


@pytest.mark.parametrize("name", [
    "test_histogram_percentiles_match_numpy_oracle",
    "test_histogram_memory_is_bounded",
    "test_histogram_merge_equals_union",
    "test_histogram_edges",
    "test_parse_blend",
    "test_schedule_deterministic_under_fixed_seed",
    "test_schedule_is_time_ordered_and_rate_shaped",
    "test_deterministic_mode_spacing",
    "test_runner_accounts_shed_and_errors_separately",
    "test_runner_open_loop_measures_queueing_delay",
    "test_runner_bounds_inflight_and_counts_drops",
    "test_runner_per_tenant_breakdown_is_bounded",
    "test_open_loop_1000_tenants_embedded_smoke",
])
def test_loadgen(name):
    port_body(name)()


def test_embedded_target_op_kinds_move_real_bytes():
    from ceph_tpu_torch.rados.embedded import LocalCluster

    async def main():
        cluster = LocalCluster(num_osds=4, device="cpu")
        try:
            cluster.create_replicated_pool("p", size=2, pg_num=8)
            tgt = tloadgen.EmbeddedTarget(cluster.open_ioctx("p"))
            await tgt.setup(8, 4096)
            assert await tgt.op("t", "read", 3, 4096) == 4096
            assert await tgt.op("t", "ranged", 3, 4096) == 1024
            assert await tgt.op("t", "stat", 3, 4096) == 0
            assert await tgt.op("t", "write", 3, 4096) == 4096
        finally:
            cluster.shutdown()

    asyncio.run(asyncio.wait_for(main(), 120))


def _bench_args(**kw):
    args = dict(seconds=1, mode="seq", block_size=2048, concurrency=4,
                read_skew=1.0, objects=16, seed=5, tenants=50,
                arrival_rate=4.0, blend="read=0.6,write=0.2,stat=0.2")
    args.update(kw)
    return args


def _check_report(rep: dict, tenants: int) -> None:
    assert rep["mode"] == "loadgen"
    assert rep["tenants"] == tenants
    assert rep["completed"] > 0
    assert rep["errors"] == 0
    assert rep["p99_ms"] > 0
    assert abs(sum(rep["blend"].values()) - 1.0) < 1e-9


def test_cli_bench_tenants_flag_drives_loadgen(capsys):
    """`rados bench <s> seq --tenants N --arrival-rate R --blend ...`
    delegates to the port's open-loop harness over the networked client:
    in process (the CLI's `_bench`), then through the CLI as a process."""
    async def main():
        cluster = Cluster(num_osds=3, osds_per_host=3)
        await cluster.start()
        try:
            await cluster.client.create_replicated_pool(
                "b", size=2, pg_num=8)
            io = cluster.client.open_ioctx("b")
            assert await trados._bench(
                io, argparse.Namespace(**_bench_args())) == 0
            in_process = capsys.readouterr().out
            a = _bench_args(tenants=20, arrival_rate=5.0,
                            blend="read=0.7,write=0.3")
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "ceph_tpu_torch.tools.rados",
                "--device", "cpu", "-m", cluster.mon.addr, "-p", "b",
                "bench", str(a["seconds"]), "seq",
                "-b", str(a["block_size"]), "--objects", str(a["objects"]),
                "--seed", str(a["seed"]), "--tenants", str(a["tenants"]),
                "--arrival-rate", str(a["arrival_rate"]),
                "--blend", a["blend"],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            out, err = await proc.communicate()
            assert proc.returncode == 0, err
            return in_process, out
        finally:
            await cluster.stop()

    in_process, out = asyncio.run(asyncio.wait_for(main(), 120))
    _check_report(json.loads(in_process), 50)
    rep = json.loads(out)
    _check_report(rep, 20)
    assert rep["blend"] == {"read": 0.7, "write": 0.3}


# -- the port's own: schedules equal the JAX functions' ------------------

@pytest.mark.parametrize("seed", [0, 9, 123])
def test_schedules_and_fingerprints_equal_the_jax_packages(seed):
    blend = "read=0.5,write=0.2,stat=0.1,ranged=0.1,infer=0.1"
    for poisson in (True, False):
        jspec = jloadgen.TenantSpec(
            name="t7", arrival_rate=40.0, zipf_theta=1.2, objects=32,
            poisson=poisson, blend=jloadgen.parse_blend(blend))
        tspec = tloadgen.TenantSpec(
            name="t7", arrival_rate=40.0, zipf_theta=1.2, objects=32,
            poisson=poisson, blend=tloadgen.parse_blend(blend))
        assert tspec.seed_for(seed) == jspec.seed_for(seed)
        assert [tuple(vars(e).values()) for e in
                tloadgen.tenant_events(tspec, 3.0, seed=seed)] == \
            [tuple(vars(e).values()) for e in
             jloadgen.tenant_events(jspec, 3.0, seed=seed)]
    jt = jloadgen.make_tenants(60, rate=3.0, zipf_theta=0.9, objects=40)
    tt = tloadgen.make_tenants(60, rate=3.0, zipf_theta=0.9, objects=40)
    assert [tuple(vars(e).values()) for e in
            tloadgen.merged_schedule(tt, 2.0, seed=seed)] == \
        [tuple(vars(e).values()) for e in
         jloadgen.merged_schedule(jt, 2.0, seed=seed)]
    assert tloadgen.schedule_fingerprint(tt, 2.0, seed=seed) == \
        jloadgen.schedule_fingerprint(jt, 2.0, seed=seed)
    for theta in (0.0, 0.99, 1.1):
        assert np.array_equal(trados.zipf_indices(theta, 1000, 5000, seed),
                              jrados.zipf_indices(theta, 1000, 5000, seed))
