"""Op scheduler: QoS arbitration between client and background work
(port of ceph_tpu/osd/scheduler.py).

Reference parity: the OSD's op queue
(the reference's src/osd/scheduler/mClockScheduler.h — dmClock tags
with per-class reservation/weight/limit; src/common/WeightedPriorityQueue.h
— the WPQ alternative; op classes in src/osd/scheduler/OpSchedulerItem.h:
client, background_recovery, background_best_effort, scrub).

The reference queues OpSchedulerItems into sharded work queues; here
the daemon's work units are coroutines, so the scheduler is an ADMIT
gate: work of class c calls `await scheduler.run(c, cost, fn)` and the
grant loop decides WHEN it starts, with at most `max_concurrent`
in-flight grants.  Two disciplines:

- WPQScheduler: deficit-weighted round robin over class FIFOs.
- MClockScheduler: dmClock-lite — each class carries
  (reservation, weight, limit) in ops/sec; a queued item gets an
  R-tag (reservation deadline), P-tag (proportional-share virtual
  time), L-tag (limit gate).  Selection: any class behind its
  reservation goes first (lowest R-tag); otherwise the lowest P-tag
  among classes under their limit.  This is the same tag algebra as
  the reference's dmclock library (src/dmclock/), minus the
  distributed delta/rho piggybacking (single-OSD scope here).

Multi-tenant extension (the million-client front door): client ops
carrying a tenant identity (MOSDOp v4) schedule as per-tenant classes
`client.<tenant>` with their own (reservation, weight, limit)
profiles — the typed `osd_mclock_tenant_*` options supply the default
triple and per-tenant overrides — so one abusive tenant contends
against its own tags, not against everyone's.  Queues are BOUNDED
(`max_queue_depth` per class, explicit overflow policy) and
introspectable via `stats()`, which is the signal the admission gate
(osd/admission.py) keys off.
"""

from __future__ import annotations

import asyncio
import contextvars
import time
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from ceph_tpu_torch.common import tracing

CLIENT = "client"
RECOVERY = "background_recovery"
SCRUB = "background_scrub"
BEST_EFFORT = "background_best_effort"
#: coded-compute scans (MOSDCompute): their own dmClock class so a
#: 10k-object scan contends against its OWN tags — a small
#: reservation keeps scans progressing under client load, the weight
#: sits below client I/O, and the limit caps how hard a scan storm
#: can push (scans must never starve the data path)
COMPUTE = "compute"
#: coded inference queries (the `infer` kernels): latency-sensitive
#: serving, so a reservation like compute's but a tighter limit — a
#: query storm is shed back to the client (EBUSY) before it can
#: squeeze the data path or the compute scans
INFERENCE = "inference"

#: per-tenant client classes are `client.<tenant>`
TENANT_PREFIX = CLIENT + "."

# (reservation ops/s, weight, limit ops/s or 0 = unlimited) — the
# shape of osd_mclock_profile "balanced": client weighted highest,
# recovery guaranteed a floor so a client flood cannot starve it
DEFAULT_PROFILES: Dict[str, Tuple[float, float, float]] = {
    CLIENT: (50.0, 10.0, 0.0),
    RECOVERY: (25.0, 3.0, 200.0),
    SCRUB: (5.0, 1.0, 50.0),
    BEST_EFFORT: (0.0, 1.0, 50.0),
    COMPUTE: (10.0, 2.0, 400.0),
    INFERENCE: (10.0, 3.0, 300.0),
}

#: bookkeeping cap for per-tenant class state: at millions of tenants
#: the tag/queue maps must stay bounded — idle tenants' entries are
#: pruned once the map outgrows this
TENANT_STATE_CAP = 4096


#: mClock class of the op currently executing under a run() grant.
#: Downstream services key per-class state off this (the encode
#: service's hot/cold arrival-density router) instead of threading a
#: class argument through every call chain.
_current_class: contextvars.ContextVar[str] = contextvars.ContextVar(
    "ceph_tpu_op_class", default="")


def current_class() -> str:
    """Scheduler class of the currently-running op, '' outside any
    grant (direct calls, tests, startup)."""
    return _current_class.get()


#: dmClock grant phase of the currently-running op: "reservation"
#: (granted against the class's r-tag constraint) or "priority"
#: (proportional-share phase).  Replies carry it back so the client's
#: ServiceTracker can count rho — reservation-phase completions —
#: separately from delta (all completions), per the dmClock paper.
PHASE_RESERVATION = "reservation"
PHASE_PRIORITY = "priority"

_current_phase: contextvars.ContextVar[str] = contextvars.ContextVar(
    "ceph_tpu_grant_phase", default="")


def current_phase() -> str:
    """dmClock phase of the currently-running op's grant, '' outside
    any grant or under a non-mClock scheduler."""
    return _current_phase.get()


def tenant_class(tenant: str) -> str:
    """Scheduler class for a tenant's client ops ('' = the shared
    default class)."""
    return f"{TENANT_PREFIX}{tenant}" if tenant else CLIENT


def stage_class(op_class: str) -> str:
    """Trace-stage key for a scheduler class: per-tenant classes fold
    into the shared `client` stage (a million tenants must not mint a
    million stage histograms)."""
    return CLIENT if op_class.startswith(TENANT_PREFIX) else op_class


class QueueFull(RuntimeError):
    """Overflow policy 'shed': the class queue is at max_queue_depth.
    The daemon maps this to EBUSY — the client sees an explicit
    refusal, never an op silently parked on an unbounded list."""

    def __init__(self, op_class: str, depth: int):
        super().__init__(f"{op_class} queue full ({depth})")
        self.op_class = op_class
        self.depth = depth


class _Item:
    __slots__ = ("cost", "fn", "future", "r_tag", "p_tag",
                 "delta", "rho")

    def __init__(self, cost: float, fn, future,
                 delta: int = 1, rho: int = 1):
        self.cost = cost
        self.fn = fn
        self.future = future
        self.r_tag = 0.0
        self.p_tag = 0.0
        # dmClock piggyback multipliers: completions this tenant saw
        # cluster-wide (delta: all; rho: reservation-phase) at OTHER
        # OSDs since its last request here, plus one for this op.
        # 1/1 — a single-OSD or piggyback-off op — reduces every tag
        # formula below to classic single-server mClock.
        self.delta = max(int(delta), 1)
        self.rho = max(int(rho), 1)


class OpSchedulerBase:
    """Admit gate: run(cls, cost, fn) parks until granted."""

    def __init__(self, max_concurrent: int = 8,
                 max_queue_depth: int = 1024,
                 overflow: str = "shed"):
        self.max_concurrent = max_concurrent
        # bounded per-class queues with an EXPLICIT overflow policy:
        # "shed" raises QueueFull at enqueue, "block" parks the caller
        # until the class drains below the bound (backpressure)
        self.max_queue_depth = int(max_queue_depth)
        if overflow not in ("shed", "block"):
            raise ValueError(f"unknown overflow policy {overflow!r}")
        self.overflow = overflow
        self._in_flight = 0
        self._queues: Dict[str, List[_Item]] = {}
        # live queued-item count, maintained incrementally: _queued()
        # was a sum over EVERY class queue, which at thousands of
        # tenant classes made each grant-loop pass O(tenants)
        self._nqueued = 0
        self._wake = asyncio.Event()
        self._drained = asyncio.Event()
        self._grant_task: Optional[asyncio.Task] = None
        self._stopping = False
        self.granted: Dict[str, int] = {}
        self.shed: Dict[str, int] = {}
        self.cancelled_before_grant = 0
        self.fast_lane: Dict[str, int] = {}

    def start(self) -> None:
        if self._grant_task is None:
            self._grant_task = asyncio.get_running_loop().create_task(
                self._grant_loop())

    async def stop(self) -> None:
        self._stopping = True
        self._wake.set()
        self._drained.set()
        if self._grant_task is not None:
            self._grant_task.cancel()
            try:
                await self._grant_task
            except asyncio.CancelledError:
                pass
            self._grant_task = None
        for q in self._queues.values():
            for item in q:
                if not item.future.done():
                    item.future.cancel()
            q.clear()
        self._nqueued = 0

    async def run(self, op_class: str, cost: float,
                  fn: Callable[[], Awaitable[Any]], *,
                  qos_delta: int = 1, qos_rho: int = 1) -> Any:
        """Queue fn under op_class; execute once granted.

        qos_delta/qos_rho are the dmClock piggyback multipliers from
        the client's ServiceTracker (completions it saw at other OSDs
        since its last op here, plus one): tags advance by
        delta x cost so per-tenant rates hold CLUSTER-wide, not
        per-OSD.  1/1 (the default) is classic local mClock."""
        if self._stopping:
            # a latched-stopped scheduler must fail fast: start()
            # would spawn a grant loop that exits immediately and the
            # queued future would park the caller forever
            raise RuntimeError("scheduler stopped")
        fast_phase = None
        if self._nqueued == 0 and \
                self._in_flight < self.max_concurrent:
            fast_phase = self._fast_charge(
                op_class, max(cost, 1.0), qos_delta, qos_rho)
        if fast_phase:
            # uncontended fast grant: nothing is queued and a slot is
            # free, so the grant loop's future/enqueue/select round
            # trip (two loop hops + an O(classes) scan per op) buys
            # nothing — charge the class's tags exactly as the queued
            # path would (fairness accounting stays intact; an
            # over-limit class is refused here and queues normally)
            # and run.  The trace span still marks the stage, with
            # zero wait.
            self._in_flight += 1
            self.granted[op_class] = self.granted.get(op_class, 0) + 1
            q_span = tracing.start_child(
                f"queue.{stage_class(op_class)}", cls=op_class)
            q_span.set_attr("fast", True)
            q_span.finish()
            tok = _current_class.set(op_class)
            ptok = _current_phase.set(fast_phase)
            try:
                return await fn()
            finally:
                _current_phase.reset(ptok)
                _current_class.reset(tok)
                self._in_flight -= 1
                self._wake.set()
        self.start()
        # queue WAIT is a pipeline stage: per-mClock-class span
        # covering the bounded-queue BLOCK wait and the enqueue-to-
        # grant wait — under saturation the block wait IS the queueing
        # delay, and it must attribute here, not to the op's self-time
        # (tenant classes fold into `queue.client` so stage names stay
        # bounded; the exact class rides as an attr)
        q_span = tracing.start_child(
            f"queue.{stage_class(op_class)}", cls=op_class)
        try:
            while len(self._queues.get(op_class, ())) >= \
                    self.max_queue_depth:
                if self.overflow == "shed":
                    self.shed[op_class] = \
                        self.shed.get(op_class, 0) + 1
                    q_span.set_attr("shed", True)
                    raise QueueFull(op_class,
                                    len(self._queues[op_class]))
                # block: wait for the class to drain below the bound
                self._drained.clear()
                await self._drained.wait()
                if self._stopping:
                    raise RuntimeError("scheduler stopped")
            fut: asyncio.Future = \
                asyncio.get_running_loop().create_future()
            item = _Item(max(cost, 1.0), fn, fut,
                         qos_delta, qos_rho)
            self._enqueue(op_class, item)
            self._nqueued += 1
            self._wake.set()
            try:
                phase = await fut  # grant (dmClock phase it won)
            except asyncio.CancelledError:
                # cancelled AFTER the grant landed: the slot was
                # consumed and fn never ran — release it or the leak
                # eventually deadlocks every class (cancelled-before-
                # grant is handled by the grant loop when it pops the
                # done future, and its tag charge is refunded there)
                if fut.done() and not fut.cancelled():
                    self._in_flight -= 1
                    self._wake.set()
                q_span.set_attr("cancelled", True)
                raise
        finally:
            q_span.finish()
        tok = _current_class.set(op_class)
        ptok = _current_phase.set(phase or "")
        try:
            return await fn()
        finally:
            _current_phase.reset(ptok)
            _current_class.reset(tok)
            self._in_flight -= 1
            self._wake.set()

    def try_acquire(self, op_class: str, cost: float,
                    qos_delta: int = 1, qos_rho: int = 1):
        """Synchronous twin of run()'s uncontended fast grant — the
        sub-chunk write fast lane.  Succeeds ONLY under the exact
        conditions the fast grant would (nothing queued, a slot free,
        the class's dmClock tags advanced and within limit), with
        identical accounting: granted counts, tag charges, and the
        queue stage span all land as if run() had fast-granted, so
        QoS fairness and the per-stage histograms cannot drift between
        lanes.  Returns the dmClock grant phase (a truthy string) on
        success, False on refusal; the caller MUST pair a truthy
        return with release()."""
        if self._stopping or self._nqueued != 0 or \
                self._in_flight >= self.max_concurrent:
            return False
        phase = self._fast_charge(op_class, max(cost, 1.0),
                                  qos_delta, qos_rho)
        if not phase:
            return False
        self._in_flight += 1
        self.granted[op_class] = self.granted.get(op_class, 0) + 1
        self.fast_lane[op_class] = self.fast_lane.get(op_class, 0) + 1
        q_span = tracing.start_child(
            f"queue.{stage_class(op_class)}", cls=op_class)
        q_span.set_attr("fast", True)
        q_span.finish()
        return phase

    def release(self) -> None:
        """Release a try_acquire slot (mirrors run()'s finally)."""
        self._in_flight -= 1
        self._wake.set()

    # -- subclass surface --------------------------------------------------

    def _enqueue(self, op_class: str, item: _Item) -> None:
        raise NotImplementedError

    def _select(self) -> Optional[Tuple[str, _Item, str]]:
        """Pick the next granted item: (class, item, dmClock phase)."""
        raise NotImplementedError

    def _uncharge(self, op_class: str, item: _Item) -> None:
        """Return a cancelled-before-grant item's tag/service charge:
        the work never ran, so the class must not be debited for it."""

    def _fast_charge(self, op_class: str, cost: float,
                     delta: int = 1, rho: int = 1):
        """Charge the class's tags for an uncontended immediate grant
        (the enqueue+select accounting, minus the queue).  Returns
        the grant phase (truthy string); False = the class may not
        run right now (rate-gated) and must take the queued path."""
        return PHASE_PRIORITY

    def _queued(self) -> int:
        return self._nqueued

    def stats(self) -> Dict[str, Any]:
        """The introspection surface the admission gate (and
        qos_status) reads: grant concurrency, per-class depth,
        grant/shed counters, the bound and its policy."""
        return {
            "max_concurrent": self.max_concurrent,
            "in_flight": self._in_flight,
            "queued": self._queued(),
            "max_queue_depth": self.max_queue_depth,
            "overflow": self.overflow,
            "queue_depths": {c: len(q)
                             for c, q in self._queues.items() if q},
            "granted": dict(self.granted),
            "queue_shed": dict(self.shed),
            "cancelled_before_grant": self.cancelled_before_grant,
            "fast_lane": dict(self.fast_lane),
        }

    async def _grant_loop(self) -> None:
        while not self._stopping:
            while self._in_flight < self.max_concurrent:
                picked = self._select()
                if picked is None:
                    break
                op_class, item, phase = picked
                self._nqueued -= 1
                self._drained.set()
                if item.future.done():
                    # caller vanished before the grant: no slot was
                    # consumed, and the item's tag charge goes back so
                    # the class is not debited for unrun work
                    self.cancelled_before_grant += 1
                    self._uncharge(op_class, item)
                    continue
                self._in_flight += 1
                self.granted[op_class] = \
                    self.granted.get(op_class, 0) + 1
                item.future.set_result(phase)
            self._wake.clear()
            if self._queued() == 0 or \
                    self._in_flight >= self.max_concurrent:
                await self._wake.wait()
            else:
                # everything queued is rate-gated: poll shortly
                await asyncio.sleep(0.005)


class WPQScheduler(OpSchedulerBase):
    """Weighted fair queueing over per-class FIFOs
    (WeightedPriorityQueue.h role): grant the class with the smallest
    weight-normalized service so sustained load shares
    proportionally — a high-weight flood slows, never starves, the
    others."""

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 max_concurrent: int = 8,
                 max_queue_depth: int = 1024,
                 overflow: str = "shed"):
        super().__init__(max_concurrent, max_queue_depth, overflow)
        self.weights = weights or {
            c: w for c, (_r, w, _l) in DEFAULT_PROFILES.items()}
        self._served: Dict[str, float] = {}  # weight-normalized

    def _enqueue(self, op_class: str, item: _Item) -> None:
        q = self._queues.setdefault(op_class, [])
        if not q:
            # a class waking from idle must not replay its idle time
            # as a burst: catch its virtual service up to the floor of
            # the currently-backlogged classes
            active = [self._served.get(c, 0.0)
                      for c, qq in self._queues.items() if qq]
            floor = min(active) if active else 0.0
            self._served[op_class] = max(
                self._served.get(op_class, 0.0), floor)
        q.append(item)

    def _select(self) -> Optional[Tuple[str, _Item, str]]:
        best = None
        for op_class, q in self._queues.items():
            if not q:
                continue
            key = self._served.get(op_class, 0.0)
            if best is None or key < best[1]:
                best = (op_class, key)
        if best is None:
            return None
        op_class = best[0]
        item = self._queues[op_class].pop(0)
        self._served[op_class] = self._served.get(op_class, 0.0) + \
            item.cost / max(self.weights.get(op_class, 1.0), 1e-9)
        return op_class, item, PHASE_PRIORITY

    def _uncharge(self, op_class: str, item: _Item) -> None:
        self._served[op_class] = self._served.get(op_class, 0.0) - \
            item.cost / max(self.weights.get(op_class, 1.0), 1e-9)

    def _fast_charge(self, op_class: str, cost: float,
                     delta: int = 1, rho: int = 1):
        # same service charge the pop in _select takes (an idle-floor
        # catch-up is moot: the fast path only runs with EVERY queue
        # empty, so there is no backlogged floor to respect).  WPQ is
        # not dmClock: the piggyback multipliers are ignored.
        self._served[op_class] = self._served.get(op_class, 0.0) + \
            cost / max(self.weights.get(op_class, 1.0), 1e-9)
        return PHASE_PRIORITY


class MClockScheduler(OpSchedulerBase):
    """dmClock-lite tag scheduler (mClockScheduler.h role) with
    per-tenant client classes."""

    def __init__(self,
                 profiles: Optional[
                     Dict[str, Tuple[float, float, float]]] = None,
                 max_concurrent: int = 8,
                 max_queue_depth: int = 1024,
                 overflow: str = "shed",
                 tenant_default: Tuple[float, float, float] = (
                     0.0, 1.0, 0.0),
                 tenant_profiles: Optional[
                     Dict[str, Tuple[float, float, float]]] = None):
        super().__init__(max_concurrent, max_queue_depth, overflow)
        self.profiles = dict(profiles or DEFAULT_PROFILES)
        # tenant classes: per-tenant override else the default triple
        # (osd_mclock_tenant_{reservation,weight,limit})
        self.tenant_default = tuple(tenant_default)
        self.tenant_profiles = {
            t: tuple(p) for t, p in (tenant_profiles or {}).items()}
        self._last_r: Dict[str, float] = {}
        self._last_p: Dict[str, float] = {}
        self._last_l: Dict[str, float] = {}

    def profile_of(self, op_class: str) -> Tuple[float, float, float]:
        """(reservation, weight, limit) for a class: explicit profile,
        else the tenant override / tenant default for `client.<t>`
        classes, else best-effort."""
        p = self.profiles.get(op_class)
        if p is not None:
            return p
        if op_class.startswith(TENANT_PREFIX):
            t = op_class[len(TENANT_PREFIX):]
            return self.tenant_profiles.get(t, self.tenant_default)
        return (0.0, 1.0, 0.0)

    def _prune_idle_tenants(self) -> None:
        """Tenant-class bookkeeping stays bounded: once the tag maps
        outgrow TENANT_STATE_CAP, drop tenant classes with EMPTY
        queues (their tags re-seed from now on the next burst, which
        is exactly the idle-floor discipline anyway)."""
        if len(self._last_p) <= TENANT_STATE_CAP:
            return
        for c in [c for c in self._last_p
                  if c.startswith(TENANT_PREFIX)
                  and not self._queues.get(c)]:
            self._last_p.pop(c, None)
            self._last_r.pop(c, None)
            self._last_l.pop(c, None)
            self._queues.pop(c, None)

    def _enqueue(self, op_class: str, item: _Item) -> None:
        now = time.monotonic()
        r, w, l = self.profile_of(op_class)
        if r > 0:
            # the max(now, ...) floor IS the idle-tag-replay guard: a
            # tenant that slept cannot bank reservation credit and
            # replay it as an instantaneous burst.  rho scales the
            # advance by the reservation-phase completions this tenant
            # won at OTHER OSDs since its last op here (dmClock): the
            # reservation is then honored cluster-wide, not N-times
            # over by N primaries.
            item.r_tag = max(now, self._last_r.get(op_class, 0.0)
                             + item.cost * item.rho / r)
            self._last_r[op_class] = item.r_tag
        else:
            item.r_tag = float("inf")
        item.p_tag = max(now, self._last_p.get(op_class, 0.0)) \
            + item.cost * item.delta / max(w, 1e-9)
        self._last_p[op_class] = item.p_tag
        self._queues.setdefault(op_class, []).append(item)
        self._prune_idle_tenants()

    def _uncharge(self, op_class: str, item: _Item) -> None:
        """A cancelled-before-grant op returns its full cost: the R/P
        charge taken at enqueue AND the limit charge _select just
        took when it popped the dead item."""
        r, w, l = self.profile_of(op_class)
        if r > 0 and op_class in self._last_r:
            self._last_r[op_class] -= item.cost * item.rho / r
        if op_class in self._last_p:
            self._last_p[op_class] -= \
                item.cost * item.delta / max(w, 1e-9)
        if l > 0 and op_class in self._last_l:
            self._last_l[op_class] -= item.cost * item.delta / l

    def _fast_charge(self, op_class: str, cost: float,
                     delta: int = 1, rho: int = 1):
        # dmClock tags advance exactly as _enqueue + _charge_limit
        # would have; an over-limit class is REFUSED (it must queue
        # behind its L-tag like always — the fast path never launders
        # QoS)
        now = time.monotonic()
        if not self._limit_ok(op_class, now):
            return False
        r, w, l = self.profile_of(op_class)
        phase = PHASE_PRIORITY
        if r > 0:
            r_next = self._last_r.get(op_class, 0.0) \
                + cost * max(rho, 1) / r
            if r_next <= now:
                # the grant lands inside the reservation constraint:
                # this is the phase a queued _select pass 1 would
                # have used
                phase = PHASE_RESERVATION
            self._last_r[op_class] = max(now, r_next)
        self._last_p[op_class] = \
            max(now, self._last_p.get(op_class, 0.0)) \
            + cost * max(delta, 1) / max(w, 1e-9)
        if l > 0:
            self._last_l[op_class] = \
                max(now, self._last_l.get(op_class, 0.0)) \
                + cost * max(delta, 1) / l
        self._prune_idle_tenants()
        return phase

    def _limit_ok(self, op_class: str, now: float) -> bool:
        _r, _w, l = self.profile_of(op_class)
        if l <= 0:
            return True
        return self._last_l.get(op_class, 0.0) <= now

    def _charge_limit(self, op_class: str, item: _Item,
                      now: float) -> None:
        _r, _w, l = self.profile_of(op_class)
        if l > 0:
            self._last_l[op_class] = \
                max(now, self._last_l.get(op_class, 0.0)) \
                + item.cost * item.delta / l

    def _select(self) -> Optional[Tuple[str, _Item, str]]:
        now = time.monotonic()
        # phase 1: reservations behind schedule (constraint-based)
        best = None
        for op_class, q in self._queues.items():
            if q and q[0].r_tag <= now:
                if best is None or q[0].r_tag < best[1]:
                    best = (op_class, q[0].r_tag)
        if best is not None:
            op_class = best[0]
            item = self._queues[op_class].pop(0)
            self._charge_limit(op_class, item, now)
            return op_class, item, PHASE_RESERVATION
        # phase 2: proportional share among classes under their limit
        best = None
        for op_class, q in self._queues.items():
            if q and self._limit_ok(op_class, now):
                if best is None or q[0].p_tag < best[1]:
                    best = (op_class, q[0].p_tag)
        if best is None:
            return None  # everything rate-gated: grant loop polls
        op_class = best[0]
        item = self._queues[op_class].pop(0)
        self._charge_limit(op_class, item, now)
        return op_class, item, PHASE_PRIORITY

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        out["tenant_classes"] = sum(
            1 for c in self._last_p if c.startswith(TENANT_PREFIX))
        return out


#: kwargs only the mClock discipline understands (make_scheduler
#: filters them for WPQ so one config surface serves both)
_MCLOCK_ONLY = ("profiles", "tenant_default", "tenant_profiles")


def make_scheduler(kind: str, **kwargs):
    """osd_op_queue option: 'mclock_scheduler' (default) or 'wpq'."""
    if kind in ("wpq", "WPQ"):
        for key in _MCLOCK_ONLY:
            kwargs.pop(key, None)
        return WPQScheduler(**kwargs)
    return MClockScheduler(**kwargs)
