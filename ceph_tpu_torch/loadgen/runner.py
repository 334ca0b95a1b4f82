"""The open-loop engine (port of ceph_tpu/loadgen/runner.py).

Closed-loop load (send -> await -> send) hides queueing delay: when
the system slows down, the generator slows down with it and the
latency numbers stay flattering.  Open loop fires every op at its
SCHEDULED arrival time regardless of completions, and measures
latency from that scheduled instant — so a backlog shows up as tail
latency, which is the number a million independent clients actually
experience.

Memory discipline: latencies stream into bounded log-bucket
histograms (loadgen/stats.py), the schedule is merged lazily (one
pending event per tenant), and in-flight tasks are capped — an op
past the cap is counted `dropped` (overload accounting), never
silently queued without bound.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Iterable, Sequence

from ceph_tpu_torch.loadgen.stats import GoodputMeter, LatencyHistogram
from ceph_tpu_torch.loadgen.targets import SheddedOp, Target
from ceph_tpu_torch.loadgen.workload import TenantSpec, merged_schedule


async def run_open_loop(target: Target,
                        tenants: Sequence[TenantSpec],
                        duration: float, seed: int = 0,
                        max_outstanding: int = 10_000,
                        per_tenant: Iterable[str] = (),
                        drain_timeout: float = 30.0) -> Dict:
    """Drive `target` with every tenant's merged schedule; returns the
    report dict (aggregate goodput + streaming percentiles, plus a
    per-tenant breakdown for the names in `per_tenant` — tracking
    every tenant of a 10k sweep would itself be an unbounded
    buffer)."""
    agg_h = LatencyHistogram()
    agg_g = GoodputMeter()
    tracked = {name: (LatencyHistogram(), GoodputMeter())
               for name in per_tenant}
    offered = 0
    inflight: set = set()
    loop = asyncio.get_running_loop()
    t0 = loop.time()

    async def fire(ev, sched_abs: float) -> None:
        t = tracked.get(ev.tenant)
        try:
            moved = await target.op(ev.tenant, ev.kind, ev.obj,
                                    ev.size)
        except SheddedOp:
            agg_g.shed += 1
            if t is not None:
                t[1].shed += 1
        except asyncio.CancelledError:
            raise
        except Exception:
            agg_g.errors += 1
            if t is not None:
                t[1].errors += 1
        else:
            lat = loop.time() - sched_abs
            agg_h.record(lat)
            # infer events carry their QUERY batch in ev.size: credit
            # scored queries (the serving goodput unit) alongside the
            # score bytes the target moved
            if ev.kind == "infer":
                agg_g.scored(ev.size, moved)
            else:
                agg_g.ok(moved)
            if t is not None:
                t[0].record(lat)
                if ev.kind == "infer":
                    t[1].scored(ev.size, moved)
                else:
                    t[1].ok(moved)

    for ev in merged_schedule(tenants, duration, seed):
        sched_abs = t0 + ev.t
        delay = sched_abs - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        offered += 1
        if len(inflight) >= max_outstanding:
            agg_g.dropped += 1
            t = tracked.get(ev.tenant)
            if t is not None:
                t[1].dropped += 1
            continue
        task = loop.create_task(fire(ev, sched_abs))
        inflight.add(task)
        task.add_done_callback(inflight.discard)

    if inflight:
        _done, pending = await asyncio.wait(set(inflight),
                                            timeout=drain_timeout)
        for p in pending:
            p.cancel()
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)
            agg_g.dropped += len(pending)
    elapsed = loop.time() - t0

    report: Dict = {
        "tenants": len(tenants),
        "offered": offered,
        "elapsed_s": round(elapsed, 3),
        **agg_g.to_dict(elapsed),
        **agg_h.to_dict(),
    }
    if tracked:
        report["per_tenant"] = {
            name: {**g.to_dict(elapsed), **h.to_dict()}
            for name, (h, g) in tracked.items()}
    return report


async def run_embedded(tenants: Sequence[TenantSpec],
                       duration: float, seed: int = 0,
                       objects: int = 64, object_size: int = 4096,
                       num_osds: int = 6,
                       per_tenant: Iterable[str] = (),
                       cluster=None, device=None) -> Dict:
    """One-call harness over the embedded LocalCluster (the smoke /
    bench-probe substrate): builds the cluster + pool on `device` (CUDA
    unless the caller names another), prefills the shared hot set, runs
    the open loop, tears down."""
    from ceph_tpu_torch.loadgen.targets import EmbeddedTarget
    from ceph_tpu_torch.rados.embedded import LocalCluster

    own = cluster is None
    if own:
        cluster = LocalCluster(num_osds=num_osds, device=device)
    try:
        if cluster.osdmap.lookup_pool("loadgen") < 0:
            cluster.create_replicated_pool("loadgen", size=2,
                                           pg_num=16)
        io = cluster.open_ioctx("loadgen")
        target = EmbeddedTarget(io)
        await target.setup(objects, object_size)
        return await run_open_loop(target, tenants, duration,
                                   seed=seed, per_tenant=per_tenant)
    finally:
        if own:
            cluster.shutdown()
