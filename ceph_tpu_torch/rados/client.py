"""Networked RADOS client (Objecter + librados roles; port of the
write, read, xattr, omap, object-class, watch/notify, listing,
coded-compute and inference slice of ceph_tpu/rados/client.py).

Reference parity: Objecter (the reference's src/osdc/Objecter.cc) —
placement computed client-side with the same CRUSH/OSDMap math the OSDs
use (`_calc_target` Objecter.cc:2692), ops tagged with the client's map
epoch and resent when the map changes or the primary bounces them
(EAGAIN / replay_epoch), lossy connections simply re-established —
and librados::IoCtx (librados_cxx.cc:1247) as the user-facing surface.

Placement runs per PG on the host.  Scans (`compute`) and model serving
(`store_model`, `load_model`, `infer`) run on the OSDs, which fold the
shards where they live; the client does device work only in the
read-then-compute legs of the kill switches (CEPH_TPU_COMPUTE=0,
CEPH_TPU_INFERENCE=0), where a nonlinear kernel evaluates on the
client's `device` (CUDA unless the caller names another).  Omap,
object classes (`execute`) and watch/notify are served by the OSDs as
in the reference; a watch's keepalive task ends with `shutdown`.  Not
in this slice (ROADMAP A7): snapshots.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import logging
from typing import Any, Dict, List, Optional, Tuple

from ceph_tpu_torch.common import flags
from ceph_tpu_torch.msg import Connection, Messenger
from ceph_tpu_torch.msg.messages import (
    MAuth,
    MAuthReply,
    MGetMap,
    MMonCommand,
    MMonCommandReply,
    MOSDCommand,
    MOSDCommandReply,
    MOSDCompute,
    MOSDComputeReply,
    MOSDMapMsg,
    MOSDOp,
    MOSDOpReply,
    MWatchNotify,
    MWatchNotifyAck,
    Message,
    OSDOp,
    decode_kv_map,
    encode_kv_map,
    encode_str_list,
)
from ceph_tpu_torch.ops.rjenkins import ceph_str_hash_rjenkins
from ceph_tpu_torch.osd.osdmap import OSDMap, PgId

log = logging.getLogger(__name__)

EAGAIN = -11
ENOENT = -2
EBUSY = -16
ESTALE = -116

#: QoS tenant identity riding MOSDOp v4.  A ContextVar instead of a
#: parameter on every I/O call: the S3 gateway authenticates a request
#: and every rados op that request fans into inherits the tenant with
#: zero signature churn (each asyncio task gets its own copy).  An
#: explicit `IoCtx.tenant` overrides it.
CURRENT_TENANT: contextvars.ContextVar[str] = contextvars.ContextVar(
    "rados_tenant", default="")


@contextlib.contextmanager
def tenant_scope(tenant: str):
    """Ops submitted inside the scope carry `tenant` (unless the
    IoCtx pins its own)."""
    token = CURRENT_TENANT.set(tenant)
    try:
        yield
    finally:
        CURRENT_TENANT.reset(token)


def full_jitter(base: float, attempt: int, cap: float = 5.0) -> float:
    """Retry sleep with FULL jitter: U(0, min(cap, base * 2^attempt)).

    The op/mon hunt loops used fixed (or linearly ramped) sleeps —
    when a device breaker trips cluster-wide, every client that failed
    in the same instant would retry in the same instant, and keep
    re-colliding each round (the thundering-herd resonance the AWS
    backoff analysis quantifies).  Sampling the WHOLE window decorrelates
    the herd in one round while keeping the same mean pressure."""
    import random

    return random.uniform(0.0, min(cap, base * (2 ** attempt)))


class RadosError(Exception):
    def __init__(self, rc: int, what: str = ""):
        super().__init__(f"rc={rc} {what}")
        self.rc = rc


class ObjectNotFound(RadosError):
    pass


class ServiceTracker:
    """Client half of dmClock delta/rho piggybacking (the dmclock
    ServiceTracker role).

    Per tenant it counts completions cluster-wide (all-phase and
    reservation-phase); per (tenant, OSD) it remembers how many of
    those happened at OTHER OSDs as of the tenant's last op there.
    An outgoing MOSDOp to OSD s then carries

        delta = 1 + other-OSD completions since the last op to s
        rho   = 1 + other-OSD reservation completions since then

    and s advances its mClock tags by delta x cost — so a tenant
    spreading load over N primaries is charged at each for what the
    other N-1 served, and its reservation/limit hold CLUSTER-wide
    instead of N-times over.  With one OSD (or the piggyback off)
    both collapse to 1: classic local mClock."""

    #: bounded bookkeeping: (tenant, osd) rows beyond this are evicted
    #: (their delta restarts at 1 — an under-charge for one op, not
    #: an error)
    STATE_CAP = 4096

    def __init__(self):
        # tenant -> [completions, reservation-phase completions]
        self._done: Dict[str, List[int]] = {}
        # (tenant, osd) -> [done_here, done_here_resv,
        #                   seen_other, seen_other_resv]
        self._srv: Dict[Tuple[str, int], List[int]] = {}

    def obtain(self, tenant: str, osd: int) -> Tuple[int, int]:
        """(delta, rho) for an op to `osd`; advances the per-server
        marker (call once per send)."""
        tot = self._done.setdefault(tenant, [0, 0])
        st = self._srv.get((tenant, osd))
        if st is None:
            if len(self._srv) >= self.STATE_CAP:
                # evict arbitrary rows; see STATE_CAP
                for key in list(self._srv)[:self.STATE_CAP // 4]:
                    del self._srv[key]
            st = self._srv[(tenant, osd)] = [0, 0, 0, 0]
        other = tot[0] - st[0]
        other_resv = tot[1] - st[1]
        delta = 1 + max(other - st[2], 0)
        rho = 1 + max(other_resv - st[3], 0)
        st[2], st[3] = other, other_resv
        return delta, rho

    def note_reply(self, tenant: str, osd: int, phase: str) -> None:
        """Count a completed (scheduled) op: the reply's qos_phase
        says which dmClock phase the grant won."""
        tot = self._done.setdefault(tenant, [0, 0])
        tot[0] += 1
        st = self._srv.get((tenant, osd))
        if st is None:
            st = self._srv[(tenant, osd)] = [0, 0, 0, 0]
        st[0] += 1
        if phase == "reservation":
            tot[1] += 1
            st[1] += 1


class RadosClient:
    def __init__(self, mon_addr, name: Optional[str] = None,
                 op_timeout: float = 10.0, max_retries: int = 30,
                 secret: Optional[str] = None, secure: bool = False,
                 config: Optional[dict] = None, device=None):
        # mon_addr: one address, a comma-separated list, or a list —
        # the client hunts across them on failure (MonClient hunting)
        if isinstance(mon_addr, str):
            self.mon_addrs = [a for a in mon_addr.split(",") if a]
        else:
            self.mon_addrs = list(mon_addr)
        self._mon_idx = 0
        if name is None:
            # entity names must be GLOBALLY unique: the OSDs' reqid
            # dedup cache keys on (client name, tid), and two clients
            # sharing a name would replay each other's cached replies
            # (the mon-assigned global_id role, MonClient::get_global_id)
            import uuid

            name = f"client.{uuid.uuid4().hex[:12]}"
        from ceph_tpu_torch.common.auth import parse_secret

        self.msgr = Messenger(name, secret=parse_secret(secret))
        self.msgr.secure = secure
        self.msgr.local_fastpath = True
        self.msgr.dispatcher = self._dispatch
        # ms_compress_* applies to EVERY messenger, not just daemons —
        # without this a cluster-wide compression setting silently
        # skips client links
        self.msgr.apply_compress_config(config or {})
        # blkin-role tracing: when trace_all is on, every submitted op
        # opens a client span and carries its context to the OSDs
        from ceph_tpu_torch.common.tracing import Tracer

        self.tracer = Tracer(name)
        self.trace_all = bool((config or {}).get("client_trace_all"))
        self.osdmap: Optional[OSDMap] = None
        # where the kill-switch legs evaluate a kernel (resolved when
        # one runs: CUDA unless the caller names another device)
        self.device = device
        self.op_timeout = op_timeout
        self.max_retries = max_retries
        # random tid base: a RESTARTED daemon client reusing a fixed
        # name (mds.a, mgr.x) must not collide with its previous
        # incarnation's reqids in OSD dedup caches
        import random as _random

        self._tid = _random.getrandbits(48)
        # dmClock piggyback state (CEPH_TPU_DMCLOCK): shared across
        # this client's ioctxs — delta/rho are per (tenant, OSD)
        self.qos_tracker = ServiceTracker()
        self._futures: Dict[int, asyncio.Future] = {}
        self._map_waiters: List[asyncio.Event] = []
        self._placement_cache: Dict[Tuple[int, PgId], int] = {}
        # (pool, oid, cookie) -> (ioctx, callback); re-registered with
        # the primary on every map change (linger resend role)
        self._watches: Dict[Tuple[int, str, int], tuple] = {}
        self._watch_cookie = 0
        self._watch_keepalive: Optional[asyncio.Task] = None

    def _next_watch_cookie(self) -> int:
        self._watch_cookie += 1
        return self._watch_cookie

    def _ensure_watch_keepalive(self) -> None:
        """Watches must survive silent TCP drops, not just map
        changes: periodically re-register every live watch (the
        registration is idempotent on the primary)."""
        if self._watch_keepalive is None or \
                self._watch_keepalive.done():
            self._watch_keepalive = \
                asyncio.get_running_loop().create_task(
                    self._watch_keepalive_loop())

    async def _watch_keepalive_loop(self) -> None:
        while self._watches:
            await asyncio.sleep(3.0)
            await self._reregister_watches()

    @property
    def mon_addr(self) -> str:
        return self.mon_addrs[self._mon_idx % len(self.mon_addrs)]

    def _hunt_mon(self) -> None:
        """Rotate to the next mon in the monmap after a failure."""
        stale = self.msgr._conns.get(self.mon_addr)
        if stale is not None:
            stale.close()
        self._mon_idx += 1

    # -- lifecycle ---------------------------------------------------------

    async def connect(self) -> None:
        await self.msgr.bind()
        last: Optional[Exception] = None
        for _attempt in range(3 * len(self.mon_addrs)):
            try:
                mon = await self.msgr.connect(self.mon_addr)
                await mon.send(MGetMap(subscribe=True))
            except (ConnectionError, OSError) as e:
                last = e
                self._hunt_mon()
                await asyncio.sleep(full_jitter(0.2, _attempt, cap=2.0))
                continue
            for _ in range(500):
                if self.osdmap is not None:
                    return
                await asyncio.sleep(0.01)
            self._hunt_mon()
        raise TimeoutError(f"no osdmap from any mon ({last!r})")

    async def shutdown(self) -> None:
        # the keepalive is the client's own task, not the messenger's:
        # cancel it and wait for it to end, so no watch outlives the
        # client (the messenger's shutdown cancels the re-registrations
        # it spawned on map changes)
        task, self._watch_keepalive = self._watch_keepalive, None
        if task is not None:
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task
        await self.msgr.shutdown()

    # -- dispatch ----------------------------------------------------------

    async def _dispatch(self, conn: Connection, msg: Message) -> None:
        if isinstance(msg, MOSDMapMsg):
            if self._advance_map(msg):
                for event in self._map_waiters:
                    event.set()
                self._map_waiters.clear()
                if self._watches:
                    # primaries may have moved: re-register watches
                    self.msgr._spawn(self._reregister_watches())
        elif isinstance(msg, MWatchNotify):
            # run the callback, then ack so the notifier unblocks
            for (pool, oid, cookie), (ioctx, cb) in \
                    list(self._watches.items()):
                if pool == msg.pool and oid == msg.oid and \
                        cookie == msg.cookie:
                    try:
                        res = cb(msg.payload)
                        if asyncio.iscoroutine(res):
                            await res
                    except Exception:
                        log.exception("watch callback failed")
            try:
                await conn.send(MWatchNotifyAck(msg.notify_id,
                                                msg.cookie))
            except (ConnectionError, OSError):
                pass
        elif isinstance(msg, (MAuthReply, MOSDOpReply, MMonCommandReply,
                              MOSDCommandReply, MOSDComputeReply)):
            fut = self._futures.pop(msg.tid, None)
            if fut is not None and not fut.done():
                fut.set_result(msg)

    def _advance_map(self, msg: MOSDMapMsg) -> bool:
        """Advance the local map from a publish: contiguous
        incrementals apply directly; a gap (or a fresh client) falls
        back to the full map or a refresh pull."""
        from ceph_tpu_torch.osd.osdmap import Incremental

        advanced = False
        if msg.incrementals and self.osdmap is not None:
            for raw in msg.incrementals:
                inc = Incremental.decode(raw)
                if inc.epoch <= self.osdmap.epoch:
                    continue
                if inc.epoch != self.osdmap.epoch + 1:
                    break  # gap: handled below
                self.osdmap.apply_incremental(inc)
                advanced = True
            if advanced and msg.epoch <= self.osdmap.epoch:
                return True
        if msg.full_map is not None:
            newmap = OSDMap.decode(msg.full_map)
            newmap.enable_placement_cache()
            if self.osdmap is None or newmap.epoch > self.osdmap.epoch:
                self.osdmap = newmap
                return True
            return advanced
        if self.osdmap is not None and msg.epoch > self.osdmap.epoch:
            # inc-only publish we could not apply: pull a fresh map
            self.msgr._spawn(self.refresh_map())
        return advanced

    async def _reregister_watches(self) -> None:
        for (pool, oid, cookie), (ioctx, _cb) in \
                list(self._watches.items()):
            try:
                await ioctx._submit(
                    oid, [OSDOp("watch", args={"cookie": cookie})])
            except Exception:
                pass  # next map change retries

    def _next_tid(self) -> int:
        self._tid += 1
        return self._tid

    def _primary_cached(self, osdmap: OSDMap, pg: PgId) -> int:
        """Placement memoized per (epoch, pg): the host CRUSH mapper
        costs milliseconds per PG and the answer is a pure function of
        the map (Objecter keeps the same cache implicitly in its
        session targets)."""
        key = (osdmap.epoch, pg)
        hit = self._placement_cache.get(key)
        if hit is None:
            _acting, hit = osdmap.pg_to_acting_osds(pg)
            if len(self._placement_cache) > 4096:
                self._placement_cache.clear()
            self._placement_cache[key] = hit
        return hit

    async def wait_for_new_map(self, timeout: float = 5.0) -> None:
        event = asyncio.Event()
        self._map_waiters.append(event)
        try:
            await asyncio.wait_for(event.wait(), timeout)
        except asyncio.TimeoutError:
            pass

    async def refresh_map(self) -> None:
        try:
            mon = await self.msgr.connect(self.mon_addr)
            await mon.send(MGetMap(subscribe=True))
        except (ConnectionError, OSError):
            # called from op-retry paths: a dead/faulted mon must not
            # crash the op — hunt and let the caller's retry loop spin
            self._hunt_mon()
        await self.wait_for_new_map(1.0)

    # -- cephx tickets (MonClient auth role) -------------------------------

    async def auth_get_ticket(self) -> bytes:
        """Fetch a mon-granted cephx ticket (two-step challenge proof,
        CephxServiceHandler shape) and attach it to every subsequent
        outbound connection's hello.  Services validate the ticket
        offline and bind the connection's session key to it."""
        from ceph_tpu_torch.common import auth as auth_mod

        keyring = self.msgr.secret
        if keyring is None:
            raise RadosError(-95, "auth disabled (no keyring)")
        mon = await self.msgr.connect(self.mon_addr)

        async def ask(msg):
            fut = asyncio.get_running_loop().create_future()
            self._futures[msg.tid] = fut
            try:
                await mon.send(msg)
                return await asyncio.wait_for(fut, self.op_timeout)
            finally:
                self._futures.pop(msg.tid, None)

        entity = self.msgr.entity_name
        r1 = await ask(MAuth(self._next_tid(), entity, 1))
        if r1.rc != 0:
            raise RadosError(r1.rc, "auth stage 1 refused")
        client_challenge = auth_mod.new_nonce()
        proof = auth_mod.auth_proof(
            keyring.active_key, entity, client_challenge,
            bytes(r1.server_challenge))
        r2 = await ask(MAuth(self._next_tid(), entity, 2,
                             kid=keyring.active,
                             client_challenge=client_challenge,
                             proof=proof))
        if r2.rc != 0:
            raise RadosError(r2.rc, "auth proof rejected")
        self.msgr.ticket = bytes(r2.ticket)
        return self.msgr.ticket

    # -- mon commands ------------------------------------------------------

    async def mon_command(self, cmd: Dict[str, Any]
                          ) -> Tuple[int, Dict[str, Any]]:
        last: Optional[Exception] = None
        resubscribe = False
        for attempt in range(max(4, 3 * len(self.mon_addrs))):
            tid = self._next_tid()
            fut: asyncio.Future = \
                asyncio.get_running_loop().create_future()
            self._futures[tid] = fut
            try:
                mon = await self.msgr.connect(self.mon_addr)
                if resubscribe:
                    # the dropped connection carried the map
                    # subscription: renew it or map updates silently
                    # stop flowing to this client
                    await mon.send(MGetMap(subscribe=True))
                    resubscribe = False
                await mon.send(MMonCommand(tid, cmd))
                reply = await asyncio.wait_for(fut, self.op_timeout)
                if reply.rc == -11 and "quorum" in str(
                        reply.out.get("error", "")):
                    # election in progress: wait it out and retry
                    # (jittered — every client sees the same election)
                    last = RadosError(-11, str(reply.out))
                    await asyncio.sleep(full_jitter(0.8, attempt,
                                                    cap=4.0))
                    continue
                return reply.rc, reply.out
            except (asyncio.TimeoutError, ConnectionError,
                    OSError) as e:
                # a restarted/dead mon leaves a stale cached connection
                # that may not have seen EOF yet: drop it, hunt to the
                # next mon in the monmap, retry after a jittered beat
                last = e
                self._hunt_mon()
                resubscribe = True
                await asyncio.sleep(full_jitter(0.6, attempt, cap=4.0))
            finally:
                self._futures.pop(tid, None)
        raise RadosError(EAGAIN, f"mon command {cmd!r} failed ({last!r})")

    async def osd_command(self, osd_id: int, cmd: Dict[str, Any]
                          ) -> Tuple[int, Dict[str, Any]]:
        """`ceph tell osd.N <cmd>`: the OSD admin surface over the
        wire (perf dump, dump_pgs, scrub, ...)."""
        osdmap = self.osdmap
        if osdmap is None or not osdmap.is_up(osd_id):
            raise RadosError(ENOENT, f"osd.{osd_id} not up")
        addr = osdmap.osd_addrs.get(osd_id)
        if addr is None:
            raise RadosError(ENOENT, f"osd.{osd_id} has no address")
        last: Optional[Exception] = None
        for attempt in range(2):
            tid = self._next_tid()
            fut: asyncio.Future = \
                asyncio.get_running_loop().create_future()
            self._futures[tid] = fut
            try:
                await self.msgr.send_to(addr, MOSDCommand(tid, cmd))
                reply = await asyncio.wait_for(fut, self.op_timeout)
                return reply.rc, reply.out
            except (asyncio.TimeoutError, ConnectionError, OSError) as e:
                last = e
                await asyncio.sleep(full_jitter(0.4, attempt, cap=2.0))
            finally:
                self._futures.pop(tid, None)
        # same error contract as mon_command/_submit: RadosError, not
        # raw transport exceptions
        raise RadosError(EAGAIN,
                         f"tell osd.{osd_id} {cmd!r} failed ({last!r})")

    async def create_replicated_pool(self, name: str, size: int = 3,
                                     pg_num: int = 32) -> int:
        rc, out = await self.mon_command({
            "prefix": "osd pool create", "name": name,
            "pool_type": "replicated", "size": size, "pg_num": pg_num})
        if rc != 0:
            raise RadosError(rc, str(out))
        await self._wait_for_pool(name)
        return out["pool_id"]

    async def create_ec_pool(self, name: str, profile: Dict[str, str],
                             pg_num: int = 32,
                             profile_name: str = "") -> int:
        profile_name = profile_name or f"{name}_profile"
        rc, out = await self.mon_command({
            "prefix": "osd erasure-code-profile set",
            "name": profile_name, "profile": profile})
        if rc != 0:
            raise RadosError(rc, str(out))
        rc, out = await self.mon_command({
            "prefix": "osd pool create", "name": name,
            "pool_type": "erasure", "erasure_code_profile": profile_name,
            "pg_num": pg_num})
        if rc != 0:
            raise RadosError(rc, str(out))
        await self._wait_for_pool(name)
        return out["pool_id"]

    async def _wait_for_pool(self, name: str) -> None:
        for _ in range(500):
            if self.osdmap is not None and \
                    self.osdmap.lookup_pool(name) >= 0:
                return
            await asyncio.sleep(0.01)
        raise TimeoutError(f"pool {name!r} never appeared in the map")

    def open_ioctx(self, pool_name: str,
                   tenant: str = "") -> "IoCtx":
        pool_id = self.osdmap.lookup_pool(pool_name)
        if pool_id < 0:
            raise KeyError(f"no pool {pool_name!r}")
        io = IoCtx(self, pool_id)
        io.tenant = tenant
        return io

    async def df(self) -> Dict[str, Any]:
        """Cluster + per-pool usage (the librados cluster_stat /
        get_pool_stats roles behind `ceph df` / `rados df`): pulls
        each up OSD's statfs over the tell surface and aggregates.
        Raw bytes are what the stores hold (all copies/chunks);
        logical objects divide the raw head count by the pool's
        replication/stripe width (approximate mid-recovery)."""
        async def one(osd: int):
            # an unreachable OSD degrades the report, never fails it
            try:
                rc, out = await self.osd_command(osd,
                                                 {"prefix": "statfs"})
                return out if rc == 0 else None
            except (RadosError, ConnectionError, OSError,
                    asyncio.TimeoutError):
                return None

        reports = await asyncio.gather(
            *(one(o) for o in self.osdmap.get_up_osds()))
        total = avail = used = 0
        raw: Dict[int, Dict[str, int]] = {}
        for out in reports:
            if out is None:
                continue
            total += int(out.get("total", 0))
            avail += int(out.get("available", 0))
            used += int(out.get("allocated", 0))
            for pid, st in out.get("pools", {}).items():
                agg = raw.setdefault(int(pid),
                                     {"objects": 0, "bytes": 0})
                agg["objects"] += int(st.get("objects", 0))
                agg["bytes"] += int(st.get("bytes", 0))
        pools = []
        # every pool in the map is listed (zeros when no OSD reported
        # it yet), like the reference's `ceph df`
        for pid, pool in sorted(self.osdmap.pools.items()):
            agg = raw.get(pid, {"objects": 0, "bytes": 0})
            width = max(1, getattr(pool, "size", 1))
            pools.append({
                "id": pid, "name": pool.name,
                # ceiling: a degraded pool (fewer copies than size)
                # must not under-count its logical objects to zero
                "objects": -(-agg["objects"] // width),
                "objects_raw": agg["objects"],
                "bytes_used": agg["bytes"]})
        return {"cluster": {"total_bytes": total,
                            "avail_bytes": avail,
                            "used_bytes": used},
                "pools": pools}


class IoCtx:
    """librados::IoCtx over the wire."""

    def __init__(self, client: RadosClient, pool_id: int):
        self.client = client
        self.pool_id = pool_id
        # QoS tenant pinned to this IoCtx ("" = inherit the ambient
        # tenant_scope / CURRENT_TENANT)
        self.tenant = ""

    @property
    def pool(self):
        return self.client.osdmap.pools[self.pool_id]

    def object_pg(self, name: str) -> PgId:
        ps = ceph_str_hash_rjenkins(name.encode())
        return self.pool.raw_pg_to_pg(PgId(self.pool_id, ps))

    # -- op submission (Objecter::_op_submit + resend discipline) ----------

    async def _submit(self, oid: str, ops: List[OSDOp]) -> MOSDOpReply:
        client = self.client
        last_error: Optional[Exception] = None
        # ONE tid for the op's whole lifetime: a resend after a lost
        # reply carries the same reqid, so the primary's dedup cache
        # can replay the stored reply instead of re-executing a
        # non-idempotent op (append, exec) — the osd_reqid_t
        # discipline (PrimaryLogPG check_in_progress_op)
        tid = client._next_tid()
        span = None
        owned = False  # root span in this client's tracer ring
        if client.trace_all:
            span = client.tracer.start(
                f"{'+'.join(op.op for op in ops)} {oid}")
            owned = True
        else:
            # ambient trace (an S3 frontend's ingress span, or any
            # caller running under tracing.current_span): the rados
            # submit becomes a child stage in THAT tree, and the op
            # carries its context to the OSDs
            from ceph_tpu_torch.common import tracing

            parent = tracing.current_span.get()
            if parent is not None and parent:
                span = parent.child(
                    f"rados {'+'.join(op.op for op in ops)} {oid}")
        try:
            return await self._submit_traced(oid, ops, tid, span)
        finally:
            if span is not None:
                if owned:
                    client.tracer.finish(span)
                else:
                    span.finish()

    async def _submit_traced(self, oid: str, ops: List[OSDOp],
                             tid: int, span) -> MOSDOpReply:
        client = self.client
        last_error: Optional[Exception] = None
        for attempt in range(client.max_retries):
            osdmap = client.osdmap
            # placement recomputed per attempt: a pg_num split between
            # retries remaps the object to a CHILD pg, and the primary
            # bounces misdirected ops with EAGAIN until we follow
            pg = self.object_pg(oid)
            primary = client._primary_cached(osdmap, pg)
            addr = osdmap.osd_addrs.get(primary, None) \
                if primary >= 0 else None
            if addr is None or not osdmap.is_up(primary):
                await client.wait_for_new_map(1.0)
                continue
            fut: asyncio.Future = \
                asyncio.get_running_loop().create_future()
            client._futures[tid] = fut
            tenant = self.tenant or CURRENT_TENANT.get()
            qos_delta = qos_rho = 1
            if tenant and flags.enabled("CEPH_TPU_DMCLOCK"):
                qos_delta, qos_rho = \
                    client.qos_tracker.obtain(tenant, primary)
            try:
                msg = MOSDOp(tid, client.msgr.entity_name, pg, oid,
                             ops, osdmap.epoch,
                             tenant=tenant,
                             qos_delta=qos_delta,
                             qos_rho=qos_rho)
                if span is not None:
                    # propagation follows the sampling decision: an
                    # unsampled ambient trace (gateway sampling off)
                    # must leave the OSD to its own
                    # osd_trace_sample_rate instead of forcing the
                    # whole downstream tree retained
                    if span.sampled:
                        msg.trace = span.context
                    span.event(f"sent to osd.{primary}"
                               + (f" (retry {attempt})" if attempt
                                  else ""))
                await client.msgr.send_to(addr, msg)
                reply = await asyncio.wait_for(fut, client.op_timeout)
                if span is not None:
                    span.event("reply")
            except (ConnectionError, OSError) as e:
                last_error = e
                client._futures.pop(tid, None)
                await client.refresh_map()
                continue
            except asyncio.TimeoutError as e:
                last_error = e
                client._futures.pop(tid, None)
                await client.refresh_map()
                continue
            if reply.rc == EAGAIN:
                # wrong/new primary or pg not active: wait for progress.
                # The floor sleep matters: during bring-up/peering churn
                # maps arrive continuously, and without it the retry
                # budget burns in milliseconds while PGs are still
                # peering (Objecter's backoff discipline).  Jittered:
                # a cluster-wide bounce must not resynchronize every
                # client's resend onto the same instant.
                await client.wait_for_new_map(0.5)
                await asyncio.sleep(0.05 + full_jitter(0.2, 0))
                continue
            if tenant and getattr(reply, "qos_phase", ""):
                # a scheduled completion: feeds the NEXT op's
                # delta/rho (EAGAIN bounces above never reached the
                # scheduler and carry no phase)
                client.qos_tracker.note_reply(
                    tenant, primary, reply.qos_phase)
            return reply
        raise RadosError(EAGAIN, f"op on {oid!r} exhausted retries"
                                 f" ({last_error!r})")

    # -- public API --------------------------------------------------------

    async def write_full(self, oid: str, data: bytes) -> Dict[str, Any]:
        """Returns the op's out map — for EC pools it carries
        {"data_crc": crc32c of the written bytes}, the OSD-computed
        content digest (librados returnvec role)."""
        reply = await self._submit(oid, [OSDOp("write_full", data=data)])
        if reply.rc != 0:
            raise RadosError(reply.rc, f"write_full {oid!r}")
        return reply.out or {}

    async def write(self, oid: str, data: bytes, offset: int) -> None:
        reply = await self._submit(
            oid, [OSDOp("write", offset=offset, data=data)])
        if reply.rc != 0:
            raise RadosError(reply.rc, f"write {oid!r}@{offset}")

    async def read(self, oid: str, offset: int = 0,
                   length: int = 0) -> bytes:
        reply = await self._submit(
            oid, [OSDOp("read", offset=offset, length=length)])
        if reply.rc == ENOENT:
            raise ObjectNotFound(reply.rc, oid)
        if reply.rc != 0:
            raise RadosError(reply.rc, f"read {oid!r}")
        # local-fastpath replies carry zero-copy views of the OSD's
        # buffers; the public API hands out real bytes (callers
        # json-decode, hash, and cache them).  Wire replies decode to
        # bytes already, so this materializes nothing there.
        data = reply.data
        return data if isinstance(data, bytes) else bytes(data)

    async def stat(self, oid: str) -> Dict[str, Any]:
        reply = await self._submit(oid, [OSDOp("stat")])
        if reply.rc == ENOENT:
            raise ObjectNotFound(reply.rc, oid)
        if reply.rc != 0:
            raise RadosError(reply.rc, f"stat {oid!r}")
        return reply.out

    async def remove(self, oid: str) -> None:
        reply = await self._submit(oid, [OSDOp("remove")])
        if reply.rc == ENOENT:
            raise ObjectNotFound(reply.rc, oid)
        if reply.rc != 0:
            raise RadosError(reply.rc, f"remove {oid!r}")

    async def append(self, oid: str, data: bytes) -> None:
        reply = await self._submit(oid, [OSDOp("append", data=data)])
        if reply.rc != 0:
            raise RadosError(reply.rc, f"append {oid!r}")

    # -- coded compute (scan/aggregate/score pushdown) ---------------------

    async def compute(self, kernel: str, oids: List[str],
                      args: Optional[Dict[str, Any]] = None,
                      wave: int = 1024
                      ) -> Tuple[Dict[str, bytes], Dict[str, int]]:
        """Run a registered compute kernel over many objects WHERE
        THEY LIVE (MOSDCompute, ceph_tpu_torch/compute): one SET-valued op
        per primary per wave, only kernel results come back.  Returns
        ({oid: result bytes}, {oid: rc}) — partial results survive
        per-object errors, the scan-shaped contract.

        Kill switch CEPH_TPU_COMPUTE=0 falls back to client-side
        read-then-compute with the same kernel reference
        implementations — bit-identical results, every payload byte
        over the wire (the parity leg the tests drive)."""
        from ceph_tpu_torch import compute as compute_mod

        if not compute_mod.env_enabled():
            return await self._compute_client_side(kernel, oids, args)
        import json as _json

        client = self.client
        args_raw = _json.dumps(args, sort_keys=True) if args else ""
        results: Dict[str, bytes] = {}
        errors: Dict[str, int] = {}
        pending = list(dict.fromkeys(oids))
        for attempt in range(client.max_retries):
            if not pending:
                break
            osdmap = client.osdmap
            by_primary: Dict[str, List[str]] = {}
            next_pending: List[str] = []
            for oid in pending:
                pg = self.object_pg(oid)
                primary = client._primary_cached(osdmap, pg)
                addr = osdmap.osd_addrs.get(primary) \
                    if primary >= 0 and osdmap.is_up(primary) else None
                if addr is None:
                    next_pending.append(oid)
                    continue
                by_primary.setdefault(addr, []).append(oid)
            sem = asyncio.Semaphore(8)

            async def one_wave(addr: str, part: List[str]) -> None:
                async with sem:
                    tid = client._next_tid()
                    fut: asyncio.Future = \
                        asyncio.get_running_loop().create_future()
                    client._futures[tid] = fut
                    try:
                        await client.msgr.send_to(addr, MOSDCompute(
                            tid, client.msgr.entity_name,
                            self.pool_id, part, kernel, args_raw,
                            osdmap.epoch,
                            tenant=self.tenant
                            or CURRENT_TENANT.get()))
                        # a scan wave legitimately outlives a single
                        # op's budget: scale the wait with the wave
                        reply = await asyncio.wait_for(
                            fut, client.op_timeout
                            + len(part) / 100.0)
                    except (ConnectionError, OSError,
                            asyncio.TimeoutError):
                        next_pending.extend(part)
                        await client.refresh_map()
                        return
                    finally:
                        client._futures.pop(tid, None)
                    if reply.rc == EAGAIN:
                        next_pending.extend(part)
                        return
                    if reply.rc != 0:
                        for oid in part:
                            errors[oid] = reply.rc
                        return
                    for oid in part:
                        rc, data = reply.results.get(oid, (EAGAIN,
                                                           b""))
                        if rc == 0:
                            results[oid] = data if isinstance(
                                data, bytes) else bytes(data)
                        elif rc == EAGAIN:
                            next_pending.append(oid)
                        else:
                            errors[oid] = rc

            # waves fly concurrently (bounded): the scan is one
            # logical op — it must not serialize on primary count or
            # wave count
            await asyncio.gather(*(
                one_wave(addr, batch[lo:lo + wave])
                for addr, batch in by_primary.items()
                for lo in range(0, len(batch), wave)))
            if next_pending:
                await client.wait_for_new_map(0.5)
                await asyncio.sleep(0.05 + full_jitter(0.2, 0))
            pending = next_pending
        for oid in pending:
            errors.setdefault(oid, EAGAIN)
        return results, errors

    async def _compute_client_side(self, kernel: str,
                                   oids: List[str],
                                   args: Optional[Dict[str, Any]]
                                   ) -> Tuple[Dict[str, bytes],
                                              Dict[str, int]]:
        """CEPH_TPU_COMPUTE=0: read every object and evaluate the
        kernel locally — the bit-exact parity oracle for the pushdown
        path (and its bytes-moved foil in the bench).  A nonlinear
        kernel evaluates on the client's device."""
        from ceph_tpu_torch import compute as compute_mod
        from ceph_tpu_torch.device import resolve_device
        from ceph_tpu_torch.osd.osdmap import TYPE_ERASURE

        kern = compute_mod.get_kernel(kernel)
        if kern is None:
            raise RadosError(-22, f"unknown kernel {kernel!r}")
        kargs = args or {}
        try:
            kern.validate_args(kargs)
        except compute_mod.ComputeError as e:
            raise RadosError(e.rc, str(e))
        device = resolve_device(self.client.device)
        pool = self.pool
        k, chunk = 1, 0
        if pool.type == TYPE_ERASURE:
            # default osd_pool_erasure_code_stripe_unit (the linear
            # kernels' striping parameter; clusters overriding it
            # must scan with CEPH_TPU_COMPUTE=1)
            k, chunk = self._ec_geometry()
        results: Dict[str, bytes] = {}
        errors: Dict[str, int] = {}
        sem = asyncio.Semaphore(16)

        async def one(oid: str) -> None:
            async with sem:
                try:
                    data = await self.read(oid)
                except ObjectNotFound:
                    errors[oid] = ENOENT
                    return
                except RadosError as e:
                    errors[oid] = e.rc
                    return
            try:
                results[oid] = kern.reference(data, kargs, k, chunk,
                                              device=device)
            except compute_mod.ComputeError as e:
                errors[oid] = e.rc

        await asyncio.gather(*(one(oid)
                               for oid in dict.fromkeys(oids)))
        return results, errors

    def _ec_geometry(self) -> Tuple[int, int]:
        """(k, chunk size) of this EC pool's stripe at the default
        osd_pool_erasure_code_stripe_unit of 4096, whatever unit the
        profile sets.  The codec gives the geometry alone: it encodes
        nothing, so it is built on the CPU."""
        from ceph_tpu_torch.ec.registry import create_erasure_code

        profile = self.client.osdmap.erasure_code_profiles[
            self.pool.erasure_code_profile]
        codec = create_erasure_code({**profile, "device": "cpu"})
        k = codec.get_data_chunk_count()
        return k, codec.get_chunk_size(k * 4096)

    # -- coded inference serving (Fisher-fused approximate scoring) --------

    async def store_model(self, name: str, kind: str, params,
                          m: int = 1, fisher_info=None
                          ) -> Dict[str, Any]:
        """Shard + Fisher-fuse a model into THIS EC pool's stripe
        geometry (ceph_tpu_torch/inference/registry): the pool's k data
        chunks carry the k_model = k_pool - m data parameter shards
        plus the m fused shards, and the manifest object carries the
        calibrated spec.  Returns the spec."""
        from ceph_tpu_torch.inference import registry as inf_registry
        from ceph_tpu_torch.osd.osdmap import TYPE_ERASURE

        pool = self.pool
        if pool.type != TYPE_ERASURE:
            raise RadosError(-22, "store_model needs an EC pool")
        k_pool, chunk = self._ec_geometry()
        if not 0 < m < k_pool:
            raise RadosError(-22, f"bad fused-shard count m={m}")
        spec, blobs = inf_registry.build(
            name, kind, params, k_pool - m, m, chunk,
            fisher_info=fisher_info)
        for oid, blob in blobs.items():
            await self.write_full(oid, blob)
        return spec

    async def load_model(self, name: str) -> Dict[str, Any]:
        """Read + cache a stored model's manifest (the spec rides
        every query's args, so the cache makes a query one round
        trip, not two)."""
        cache = getattr(self, "_model_cache", None)
        if cache is None:
            cache = self._model_cache = {}
        spec = cache.get(name)
        if spec is None:
            import json as _json

            from ceph_tpu_torch.inference import registry as inf_registry

            spec = _json.loads(
                await self.read(inf_registry.manifest_oid(name)))
            cache[name] = spec
        return spec

    async def infer(self, name, queries, exact: bool = False,
                    budget: Optional[float] = None
                    ) -> Dict[str, Any]:
        """Score a query batch against a stored model THROUGH the
        code (MOSDCompute `infer`): per-shard forward passes run on
        the OSDs holding the serving streams, the primary combines
        the first sufficient arrival set (Fisher-averaged when fused
        shards substitute for stragglers), and the per-query error
        budget — `osd_inference_error_budget` when None — gates every
        approximate result.  exact=True demands the bit-exact
        full-decode path.  Returns the decoded result dict:
        scores (nq x out float32), mode, est_error, substituted.

        Kill switch CEPH_TPU_INFERENCE=0 falls back to client-side
        read-then-infer with the same host reference forward —
        bit-identical result bytes, every parameter byte over the
        wire (the parity leg tests/test_torch_inference_live.py
        drives)."""
        from ceph_tpu_torch import inference as inf_mod
        from ceph_tpu_torch.inference import kernels as inf_kernels
        from ceph_tpu_torch.inference import model as inf_model

        spec = name if isinstance(name, dict) \
            else await self.load_model(name)
        try:
            inf_model.validate_spec(spec)
        except ValueError as e:
            raise RadosError(-22, str(e))
        if not inf_mod.env_enabled():
            return await self._infer_client_side(spec, queries)
        args: Dict[str, Any] = {
            "model": spec,
            "q": inf_kernels.encode_queries(queries),
        }
        if exact:
            args["exact"] = True
        if budget is not None:
            args["budget"] = float(budget)
        oid = spec["params_oid"]
        results, errors = await self.compute(
            inf_mod.INFER_KERNEL, [oid], args)
        if oid not in results:
            raise RadosError(errors.get(oid, EAGAIN),
                             f"infer {spec.get('name')!r}")
        return inf_kernels.decode_result(results[oid])

    async def _infer_client_side(self, spec: Dict[str, Any],
                                 queries) -> Dict[str, Any]:
        """CEPH_TPU_INFERENCE=0: read the whole params object and run
        the host reference forward — the same exact_forward + blob
        the engine's exact fallback uses, so the result bytes are
        bit-identical to exact=True serving."""
        from ceph_tpu_torch.inference import kernels as inf_kernels
        from ceph_tpu_torch.inference import model as inf_model

        data = await self.read(spec["params_oid"])
        scores = inf_model.exact_forward(spec, data, queries)
        return inf_kernels.decode_result(
            inf_kernels.result_blob(scores, "exact", 0.0, 0))

    # -- object classes ----------------------------------------------------

    async def execute(self, oid: str, cls: str, method: str,
                      data: bytes = b"") -> bytes:
        """Run an object-class method server-side (rados_exec role).
        Returns the method's output bytes; errors raise RadosError
        with the method's rc."""
        reply = await self._submit(
            oid, [OSDOp("call", data=data,
                        args={"cls": cls, "method": method})])
        if reply.rc == ENOENT:
            raise ObjectNotFound(reply.rc, oid)
        if reply.rc != 0:
            raise RadosError(reply.rc, f"exec {cls}.{method} on {oid!r}")
        data = reply.data
        return data if isinstance(data, bytes) else bytes(data)

    # -- xattrs ------------------------------------------------------------

    async def setxattr(self, oid: str, name: str, value: bytes) -> None:
        reply = await self._submit(
            oid, [OSDOp("setxattr", data=value, args={"name": name})])
        if reply.rc != 0:
            raise RadosError(reply.rc, f"setxattr {oid!r}.{name}")

    async def rmxattr(self, oid: str, name: str) -> None:
        reply = await self._submit(
            oid, [OSDOp("rmxattr", args={"name": name})])
        if reply.rc != 0:
            raise RadosError(reply.rc, f"rmxattr {oid!r}.{name}")

    async def getxattr(self, oid: str, name: str) -> bytes:
        reply = await self._submit(
            oid, [OSDOp("getxattr", args={"name": name})])
        if reply.rc != 0:
            raise RadosError(reply.rc, f"getxattr {oid!r}.{name}")
        return reply.data

    async def getxattrs(self, oid: str) -> Dict[str, bytes]:
        reply = await self._submit(oid, [OSDOp("getxattrs")])
        if reply.rc != 0:
            raise RadosError(reply.rc, f"getxattrs {oid!r}")
        return {k: v.encode("latin-1")
                for k, v in reply.out.get("xattrs", {}).items()}

    # -- omap (replicated pools only, like the reference) ------------------

    async def omap_set(self, oid: str,
                       kv: Dict[str, bytes]) -> None:
        reply = await self._submit(
            oid, [OSDOp("omap_set", data=encode_kv_map(kv))])
        if reply.rc != 0:
            raise RadosError(reply.rc, f"omap_set {oid!r}")

    async def omap_rm_keys(self, oid: str, keys: List[str]) -> None:
        reply = await self._submit(
            oid, [OSDOp("omap_rm", data=encode_str_list(keys))])
        if reply.rc != 0:
            raise RadosError(reply.rc, f"omap_rm {oid!r}")

    async def omap_get(self, oid: str) -> Dict[str, bytes]:
        reply = await self._submit(oid, [OSDOp("omap_get")])
        if reply.rc == ENOENT:
            raise ObjectNotFound(reply.rc, oid)
        if reply.rc != 0:
            raise RadosError(reply.rc, f"omap_get {oid!r}")
        return decode_kv_map(reply.data) if reply.data else {}

    # -- watch / notify ----------------------------------------------------

    async def watch(self, oid: str, callback) -> int:
        """Register a watch; callback(payload: bytes) fires on every
        notify.  Returns the watch cookie (linger op role — the client
        re-registers automatically when the map changes)."""
        cookie = self.client._next_watch_cookie()
        self.client._watches[(self.pool_id, oid, cookie)] = \
            (self, callback)
        reply = await self._submit(
            oid, [OSDOp("watch", args={"cookie": cookie})])
        if reply.rc != 0:
            self.client._watches.pop((self.pool_id, oid, cookie), None)
            raise RadosError(reply.rc, f"watch {oid!r}")
        self.client._ensure_watch_keepalive()
        return cookie

    async def unwatch(self, oid: str, cookie: int) -> None:
        self.client._watches.pop((self.pool_id, oid, cookie), None)
        reply = await self._submit(
            oid, [OSDOp("watch", args={"cookie": cookie,
                                       "unwatch": True})])
        if reply.rc != 0:
            raise RadosError(reply.rc, f"unwatch {oid!r}")

    async def notify(self, oid: str,
                     payload: bytes = b"") -> Dict[str, Any]:
        """Fire a notify; returns {"acked": [...], "missed": [...]}."""
        reply = await self._submit(
            oid, [OSDOp("notify", data=payload)])
        if reply.rc != 0:
            raise RadosError(reply.rc, f"notify {oid!r}")
        return reply.out

    async def list_objects(self) -> List[str]:
        """pgls across every PG of the pool (ListObjects role)."""
        names: set = set()
        seen_pgs: set = set()
        for ps in range(self.pool.pg_num):
            pg = self.pool.raw_pg_to_pg(PgId(self.pool_id, ps))
            if pg in seen_pgs:
                continue
            seen_pgs.add(pg)
            client = self.client
            for attempt in range(client.max_retries):
                osdmap = client.osdmap
                _a, primary = osdmap.pg_to_acting_osds(pg)
                addr = osdmap.osd_addrs.get(primary) \
                    if primary >= 0 and osdmap.is_up(primary) else None
                if addr is None:
                    await client.wait_for_new_map(1.0)
                    continue
                tid = client._next_tid()
                fut: asyncio.Future = \
                    asyncio.get_running_loop().create_future()
                client._futures[tid] = fut
                try:
                    await client.msgr.send_to(
                        addr, MOSDOp(tid, client.msgr.entity_name, pg,
                                     "", [OSDOp("pgls")], osdmap.epoch))
                    reply = await asyncio.wait_for(fut,
                                                   client.op_timeout)
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    client._futures.pop(tid, None)
                    await client.refresh_map()
                    continue
                if reply.rc == EAGAIN:
                    await client.wait_for_new_map(0.5)
                    continue
                if reply.rc == 0:
                    names.update(reply.out.get("objects", []))
                break
        return sorted(names)
