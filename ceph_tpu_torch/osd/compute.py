"""Primary-side coded-compute engine (the MOSDCompute op body; port of
ceph_tpu/osd/compute.py).

The hedged-read pattern applied to computation itself (ROADMAP item
5; ceph_tpu_torch/compute has the algebra): a client names a kernel +
many oids, and the primary

* groups the wave per PG and, for GF-LINEAR kernels on codecs whose
  shards satisfy the position-wise code relation
  (`supports_result_decode`), fans ONE sub-compute op per acting OSD
  covering every object in the wave.  Each OSD evaluates the kernel
  over ALL its local shards of the wave in one fold launch per length
  group and returns R bytes per shard — the payloads never move.  The
  fan-out rides the HedgeTracker (osd/hedge.py) with need=k: the FIRST
  k same-version shard-results complete each
  object, stragglers recruit spares at their p95 mark and are
  cancelled cleanly, and the decode happens in the RESULT DOMAIN — a
  tiny GF combine of k R-byte vectors through the same
  ec_util.decode path the data plane uses, at lane width.

* for NONLINEAR kernels (record aggregates, entropy/dot scoring) —
  and for codecs/pools outside the commutation gate — takes the
  FULL-DECODE FALLBACK: reconstruct each object through the normal
  hedged first-k read and evaluate on the logical bytes.  Results,
  not payloads, still cross the client wire.

Lock order: the fallback evaluates under the per-object CLS lock and
THEN the object lock — the same `osd.clslock` -> `osd.objlock` order
`_op_call`'s registered methods take dynamically.  Taking it here, in
statically visible nesting, puts the edge in the lint-time lock-order
graph (ceph_tpu/analysis/lockgraph.py, the JAX package's static
graph the port's runtime edges are held against) so the runtime⊆static
cross-check needs no dynamic-dispatch baseline entry for it.

Device placement: each OSD folds its local shards of a wave on the
daemon's device (`kern.shard_eval(..., device=d.device)`: one
`gf_fold` launch per length group on the card); the primary's
result-domain decode goes through the pool's codec, on the same
device, so a lost data shard's result is rebuilt on `gf_matmul_gen`
at lane width; the fallback's nonlinear kernels evaluate on the
daemon's device where they have device work (`compress_score` on
`score_blocks`).  A result-domain decode that raises is not retried
object by object: the wave's objects answer EIO.

Scheduling: compute ops run under the dedicated `compute` mClock
class and the tenant admission gate (the daemon wires both before
`execute`), so a scan storm cannot starve client I/O.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Dict, List, Optional, Tuple

from ceph_tpu_torch import compute as compute_mod
from ceph_tpu_torch.common import tracing
from ceph_tpu_torch.compute import ComputeError, ComputeKernel
from ceph_tpu_torch.compute import kernels as compute_kernels
from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE
from ceph_tpu_torch.msg.messages import MOSDSubCompute
from ceph_tpu_torch.ops.rjenkins import ceph_str_hash_rjenkins
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd import scheduler as sched_mod
from ceph_tpu_torch.osd.osdmap import PgId, TYPE_ERASURE
from ceph_tpu_torch.osd.pg_log import ZERO, ev
from ceph_tpu_torch.rados.embedded import OI_ATTR

log = logging.getLogger("osd.compute")

EAGAIN = -11
ENOENT = -2
EIO = -5
EBUSY = -16
EINVAL = -22

#: concurrent full-decode evaluations per wave (each one is a hedged
#: EC read; unbounded fan-out would monopolize the sub-read paths)
FALLBACK_CONCURRENCY = 8


def _codec_pushdown_ok(codec) -> bool:
    fn = getattr(codec, "supports_result_decode", None)
    return bool(fn()) if callable(fn) else False


class ComputeEngine:
    """One per daemon: wave orchestration + local shard evaluation."""

    def __init__(self, daemon):
        self.d = daemon
        self.counters: Dict[str, int] = {
            "ops": 0, "objects": 0, "pushdown_objects": 0,
            "fallback_objects": 0, "waves": 0, "result_bytes": 0,
            "subcompute_items": 0, "errors": 0,
            # the port's launch accounting: linear waves pushed down,
            # the length groups this OSD folded (one gf_fold launch
            # each on the card), and the result-domain survivor-set
            # groups with a data shard's result missing (one
            # gf_matmul_gen launch each)
            "pushdown_waves": 0, "fold_groups": 0,
            "result_decode_groups": 0,
        }

    def perf(self) -> Dict[str, Any]:
        return dict(self.counters)

    # -- client op body (runs under the compute mClock class) --------------

    async def execute(self, msg) -> Tuple[int, Dict[str, Tuple[int, bytes]],
                                          Dict[str, Any]]:
        d = self.d
        kern = compute_mod.get_kernel(msg.kernel)
        if kern is None:
            return EINVAL, {}, {"error": f"unknown kernel {msg.kernel!r}"}
        try:
            args = compute_kernels.parse_args(msg.args)
            kern.validate_args(args)
        except ComputeError as e:
            return e.rc, {}, {"error": str(e)}
        pool = d.osdmap.pools.get(msg.pool) if d.osdmap else None
        if pool is None:
            return EAGAIN, {}, {}
        self.counters["ops"] += 1
        results: Dict[str, Tuple[int, bytes]] = {}
        by_pg: Dict[PgId, List[str]] = {}
        from ceph_tpu_torch.osd.daemon import is_internal_name

        for oid in dict.fromkeys(msg.oids):
            if not oid or is_internal_name(oid):
                results[oid] = (EINVAL, b"")
                continue
            raw = PgId(pool.id, ceph_str_hash_rjenkins(oid.encode()))
            by_pg.setdefault(pool.raw_pg_to_pg(raw), []).append(oid)
        pushdown = fallback = 0

        async def run_pg(pg: PgId, oids: List[str]
                         ) -> Tuple[bool, Dict[str, Tuple[int,
                                                          bytes]]]:
            state = d.pgs.get(pg)
            if state is None or state.primary != d.osd_id:
                return False, {oid: (EAGAIN, b"") for oid in oids}
            if state.state != "active":
                try:
                    await asyncio.wait_for(state.active_event.wait(),
                                           10.0)
                except asyncio.TimeoutError:
                    return False, {oid: (EAGAIN, b"")
                                   for oid in oids}
            # per-kernel capability, not a blanket nonlinear gate:
            # GF-linear kernels push down exactly; approx_capable
            # kernels (inference/) push down with a result-domain
            # approximate combine of their own
            use_push = False
            if pool.type == TYPE_ERASURE and (
                    kern.linear or kern.approx_capable):
                use_push = _codec_pushdown_ok(d._codec(pool.id))
            self.counters["waves"] += 1
            if use_push and not kern.linear:
                # approx_capable pushdown: the inference engine owns
                # the per-shard fan-out and the Fisher result-domain
                # combine (a GF decode of nonlinear results would be
                # meaningless)
                return True, await d.inference.wave(
                    state, pool, oids, kern, msg.args, args)
            if use_push:
                self.counters["pushdown_waves"] += 1
                return True, await self._wave_pushdown(
                    state, pool, oids, kern, msg.args, args)
            return False, await self._wave_fallback(
                state, pool, oids, kern, args)

        # per-PG waves run concurrently: each wave's sub-compute
        # fan-out is already parallel across its acting set, and
        # overlapping the waves hides the per-PG round trips (the
        # scan is one op — it must not serialize on PG count)
        groups = sorted(by_pg.items(),
                        key=lambda kv: (kv[0].pool, kv[0].ps))
        waves = await asyncio.gather(
            *(run_pg(pg, oids) for pg, oids in groups))
        for pushed, wave in waves:
            good = sum(1 for rc, _r in wave.values() if rc == 0)
            if pushed:
                pushdown += good
            else:
                fallback += good
            results.update(wave)
        self.counters["objects"] += len(results)
        self.counters["pushdown_objects"] += pushdown
        self.counters["fallback_objects"] += fallback
        self.counters["errors"] += sum(1 for rc, _r in results.values()
                                       if rc not in (0, ENOENT))
        self.counters["result_bytes"] += sum(
            len(r) for rc, r in results.values() if rc == 0)
        out = {"kernel": msg.kernel, "pushdown": pushdown,
               "fallback": fallback,
               "result_bytes": sum(len(r) for rc, r in results.values()
                                   if rc == 0)}
        return 0, results, out

    # -- the pushdown wave (linear kernels over coded shards) --------------

    async def _wave_pushdown(self, state, pool, oids: List[str],
                             kern: ComputeKernel, args_raw: str,
                             args: Dict[str, Any]
                             ) -> Dict[str, Tuple[int, bytes]]:
        d = self.d
        pg = state.pg
        codec = d._codec(pool.id)
        k = codec.get_data_chunk_count()
        jobs: List[Tuple[int, Any]] = []
        for idx, osd in enumerate(state.acting):
            if osd == CRUSH_ITEM_NONE or not d.osdmap.is_up(osd):
                continue

            def job(shard=idx, osd=osd):
                return self._shard_job(pg, shard, osd, oids,
                                       kern, args_raw, args)

            jobs.append((osd, job))
        if len(jobs) < k:
            # below-k up members can never complete an object: an
            # explicit retry, not a false ENOENT
            return {oid: (EAGAIN, b"") for oid in oids}

        def collate(raw) -> Dict[str, Dict[str, Dict[int, bytes]]]:
            """(shard, ok, items) results -> oid -> version ->
            {shard: result}."""
            acc: Dict[str, Dict[str, Dict[int, bytes]]] = {}
            for shard, ok, items in raw:
                if not ok:
                    continue
                for oid, (rc, ver, res) in zip(oids, items):
                    if rc == 0:
                        acc.setdefault(oid, {}).setdefault(
                            ver, {})[shard] = res
            return acc

        def indefinite(raw) -> Tuple[bool, set]:
            """(any flight failed, oids with a non-ENOENT shard
            error): evidence that an empty candidate set proves
            NOTHING about absence — those oids answer EAGAIN, never
            ENOENT (the MissingLoc have-vs-unfound distinction)."""
            any_fail = False
            problem: set = set()
            for _shard, ok, items in raw:
                if not ok:
                    any_fail = True
                    continue
                for oid, (rc, _ver, _res) in zip(oids, items):
                    if rc not in (0, ENOENT):
                        problem.add(oid)
            return any_fail, problem

        def sufficient(raw) -> bool:
            acc = collate(raw)
            return all(
                any(len(shards) >= k for shards in acc.get(
                    oid, {}).values())
                for oid in oids)

        raw, ran_all = await d.hedge.gather(
            jobs, need=k, sufficient=sufficient,
            failed=lambda res: not res[1], label="subcompute")
        acc = collate(raw)
        any_fail, problem = indefinite(raw)
        rsinfo = ec_util.StripeInfo(k, k * kern.lanes)
        out: Dict[str, Tuple[int, bytes]] = {}
        picked: List[Tuple[str, Dict[int, bytes]]] = []
        for oid in oids:
            groups = {v: shards for v, shards in
                      acc.get(oid, {}).items() if len(shards) >= k}
            if not groups:
                # absence must be PROVEN: a failed flight, an early
                # (hedged) exit, or any shard-level error leaves the
                # question open — the client retries instead of
                # recording a live object as missing
                definite = ran_all and not any_fail and \
                    oid not in problem and not acc.get(oid)
                out[oid] = (ENOENT if definite else EAGAIN, b"")
                continue
            ver = max(groups, key=self._ver_key)
            try:
                # acked-write invariant: a k-group at a version older
                # than the newest acked one (its holders down, stale
                # shards answering) must not serve — same guard as
                # the read path's _require_fresh
                d._require_fresh(state, pool, oid, self._ver_key(ver))
            except Exception:
                out[oid] = (EAGAIN, b"")
                continue
            try:
                picked.append((oid, ec_util.fastest_survivors(
                    codec, groups[ver], k,
                    prefer=d._shard_rank(state))))
            except Exception:
                out[oid] = (EIO, b"")
        # ONE result-domain decode per survivor-set group, not per
        # object: decode_many concatenates same-survivor-set result
        # vectors and GF-combines the whole wave in one dispatch (the
        # recovery-wave fold, at lane width) — a per-object decode
        # would pay a guarded device round trip per 32-byte vector
        self.counters["result_decode_groups"] += sum(
            1 for group in {tuple(sorted(m)) for _oid, m in picked}
            if any(i not in group for i in range(k)))
        async with tracing.child_span(
                f"compute decode x{len(picked)}"):
            try:
                decoded: List[Optional[bytes]] = \
                    await asyncio.to_thread(
                        self._result_decode_many, rsinfo, codec,
                        [chosen for _oid, chosen in picked])
            except Exception:
                # no per-object retry on another path: the failing
                # launch is the answer, EIO for the wave's objects
                log.exception("osd.%d: result-domain decode of %d"
                              " objects in %s failed", d.osd_id,
                              len(picked), pg)
                decoded = [None] * len(picked)
        for (oid, _chosen), dec in zip(picked, decoded):
            if dec is None:
                out[oid] = (EIO, b"")
                continue
            view = memoryview(dec)
            parts = [view[i * kern.lanes:(i + 1) * kern.lanes]
                     for i in range(k)]
            out[oid] = (0, kern.combine(parts))
        return out

    @staticmethod
    def _result_decode_many(rsinfo, codec, maps: List[Dict[int,
                                                           bytes]]
                            ) -> List[bytes]:
        """Batched result-domain decode, one launch per survivor set
        of the wave.  It raises as the decode raises: the reference's
        per-object retry through ec_util.decode is not ported."""
        if not maps:
            return []
        return list(ec_util.decode_many(rsinfo, codec, maps))

    @staticmethod
    def _ver_key(ver: str):
        try:
            return ev(ver)
        except Exception:
            return ZERO

    async def _shard_job(self, pg: PgId, shard: int, osd: int,
                         oids: List[str], kern: ComputeKernel,
                         args_raw: str, args: Dict[str, Any]
                         ) -> Tuple[int, bool, List[Tuple[int, str,
                                                          bytes]]]:
        """One acting member's sub-compute: local shards evaluate in
        process (same batched path the remote handler uses); remote
        shards ride MOSDSubCompute.  Returns (shard, ok, items) —
        ok=False is a transport fault the hedged gather treats as a
        failed flight (recruit a spare now)."""
        import time as _time

        d = self.d
        t0 = _time.monotonic()
        if osd == d.osd_id:
            items = [(pg, shard, oid) for oid in oids]
            out = await self.eval_local_shards(items, kern, args)
            # the local eval feeds the EWMA too: self ranks by its
            # actual store+eval latency, not a synthetic zero
            d.hedge.observe(osd, _time.monotonic() - t0)
            return shard, True, out
        tid = d._next_tid()
        msg = MOSDSubCompute(
            tid, kern.name, args_raw,
            [(pg.pool, pg.ps, shard, oid) for oid in oids],
            d._epoch())
        reply = await d._request(osd, msg, tid)
        # every sub-compute round trip feeds the per-peer latency
        # model (sub-compute jobs cost eval time, not just payload
        # RTT — without this the p95 marks stay at the sub-read
        # prior and every wave hedges spuriously)
        ok = reply is not None and reply.rc == 0 and \
            len(reply.results) == len(oids)
        d.hedge.observe(osd, _time.monotonic() - t0, ok=ok)
        if not ok:
            return shard, False, []
        self.counters["subcompute_items"] += len(reply.results)
        # results stay views of the reply frame (lane-width each)
        return shard, True, list(reply.results)

    def _shard_missing(self, pg: PgId, shard: int, oid: str) -> bool:
        """True when this OSD's CURRENT shard of the object is in its
        own pg-log missing set (a behind/backfilling copy whose
        on-disk bytes predate acked writes)."""
        d = self.d
        state = d.pgs.get(pg)
        pool = d.osdmap.pools.get(pg.pool) if d.osdmap else None
        if state is None or pool is None:
            return False
        if shard != state.my_shard(d.osd_id, pool.type):
            return False
        try:
            return oid in d._load_log(state, pool).missing
        except Exception:
            return False

    # -- local shard evaluation (primary's own shard AND the replica
    #    handler's body) ----------------------------------------------------

    async def eval_local_shards(
            self, items: List[Tuple[PgId, int, str]],
            kern: ComputeKernel, args: Dict[str, Any]
    ) -> List[Tuple[int, str, bytes]]:
        """Kernel-evaluate every locally held shard of a wave: reads
        stay on the event loop (store reads are memory-speed), the
        batched kernel dispatch runs off-loop — ONE plan-cached
        device call for all same-length shards of the wave."""
        d = self.d
        metas: List[Tuple[int, str]] = []
        payloads: List[Any] = []
        rows: List[Optional[int]] = []
        for pg, shard, oid in items:
            if self._shard_missing(pg, shard, oid):
                # the missing guard of _handle_sub_read_inner: my
                # CURRENT shard of an object in my missing set is
                # known-stale on disk — serving its kernel result
                # could complete the object at a rolled-back version
                metas.append((ENOENT, ""))
                rows.append(None)
                continue
            rc, data, at = d._read_shard(pg, shard, oid)
            ver = ""
            if rc == 0:
                try:
                    oi = json.loads(at[OI_ATTR])
                    ver = str(oi.get("version") or "")
                    if oi.get("whiteout"):
                        rc = ENOENT
                except (KeyError, ValueError):
                    rc = EIO
            if rc != 0:
                metas.append((rc, ""))
                rows.append(None)
                continue
            metas.append((0, ver))
            rows.append(len(payloads))
            payloads.append(data)
        if payloads:
            if kern.linear:
                self.counters["fold_groups"] += len(
                    {-(-len(p) // kern.lanes) for p in payloads})
            # the mClock grant covers exactly the batched eval — the
            # stage that contends with client I/O for CPU/device time.
            # An op slot is NOT held across the wave's remote round
            # trips (a parked scan must never occupy the op queue's
            # in-flight slots while it waits on peers).
            async with tracing.child_span(
                    f"compute eval {kern.name} x{len(payloads)}"):
                evaluated = await d.scheduler.run(
                    kern.qos_class, 1.0 + len(payloads) / 256.0,
                    lambda: asyncio.to_thread(
                        kern.shard_eval, payloads, args,
                        device=d.device))
        else:
            evaluated = []
        out: List[Tuple[int, str, bytes]] = []
        for (rc, ver), row in zip(metas, rows):
            out.append((rc, ver,
                        evaluated[row] if row is not None else b""))
        return out

    # -- the full-decode fallback (nonlinear kernels / unsupported
    #    codecs) -------------------------------------------------------------

    async def _wave_fallback(self, state, pool, oids: List[str],
                             kern: ComputeKernel,
                             args: Dict[str, Any]
                             ) -> Dict[str, Tuple[int, bytes]]:
        d = self.d
        if pool.type == TYPE_ERASURE:
            sinfo = d._sinfo(pool.id)
            k = d._codec(pool.id).get_data_chunk_count()
            chunk = sinfo.get_chunk_size()
        else:
            k, chunk = 1, 0
        sem = asyncio.Semaphore(FALLBACK_CONCURRENCY)

        async def one(oid: str) -> Tuple[int, bytes]:
            async with sem:
                # cls-ordered locking: serialize against object-class
                # RMW methods (cls lock) and in-flight writes (object
                # lock) so the kernel sees ONE committed version —
                # and the clslock -> objlock order is statically
                # visible here (see module docstring)
                async with state.obj_lock(f"_cls_\x00{oid}"):
                    async with state.obj_lock(oid):
                        rc, data = await d._op_read(state, pool, oid,
                                                    0, 0)
                        if rc != 0:
                            return rc, b""
                        async with tracing.child_span(
                                f"compute eval {kern.name}"):
                            try:
                                # the eval charges the kernel's mClock
                                # class (the CPU stage; the hedged
                                # read above holds no op slot)
                                res = await d.scheduler.run(
                                    kern.qos_class, 1.0,
                                    lambda: asyncio.to_thread(
                                        kern.reference, data, args,
                                        k, chunk, device=d.device))
                            except ComputeError as e:
                                return e.rc, b""
                            except asyncio.CancelledError:
                                raise
                            except sched_mod.QueueFull:
                                return EBUSY, b""
                            except Exception:
                                log.exception(
                                    "osd.%d: kernel %s failed on %r",
                                    d.osd_id, kern.name, oid)
                                return EIO, b""
                        return 0, res

        done = await asyncio.gather(*(one(oid) for oid in oids))
        return dict(zip(oids, done))
