"""Per-tenant admission control in front of the op queue (port of
ceph_tpu/osd/admission.py).

The mClock tags (osd/scheduler.py) arbitrate among ops that are
ALREADY queued — but by the time an over-limit tenant's op sits in
the queue it has a parsed message, an op-tracker slot, and is about
to pull encode-service / hedge / tier resources through the execute
stage.  The admission gate is the cheaper refusal: a per-tenant token
bucket charged at the tenant's mClock LIMIT rate, consulted before
the op enters the QoS queue.  Under-limit tenants pass at a dict
lookup's cost; an over-limit tenant is first DELAYED (up to
`osd_mclock_admission_max_delay_ms`, which smooths bursts without
refusing them) and then SHED with an explicit EBUSY — so one abusive
tenant's flood is bounced at the front door instead of starving the
rest in the queue.

dmclock's delayed-tag throttling plays this role in the reference
(the client-side delta/rho loop); single-OSD scope here, so a plain
bucket is the honest equivalent.

Hot-accept-path discipline (ROADMAP item 2 tail): at extreme tenant
counts the gate itself must cost nothing when it passes untouched.
``try_admit()`` is the SYNCHRONOUS fast path — one O(1) bucket
lookup, no coroutine allocation, no per-op profile resolution (the
tenant's mClock limit is cached IN the bucket entry with a short
TTL, so the `client.<tenant>` class-string build and the profile
dict walk happen once per tenant per TTL window, not once per op).
Only an op the bucket cannot cover falls to the awaitable ``admit``
slow path, where the delay sleep / shed verdict lives.

Bounded state: tenant buckets live in an LRU capped at
`_BUCKET_CAP`; per-tenant decision counters are capped the same way
(the perf-dump `tenants` map must not itself become the unbounded
buffer the lint rule bans).
"""

from __future__ import annotations

import asyncio
import os

from ceph_tpu_torch.common import flags
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

from ceph_tpu_torch.common import tracing

ADMIT = "admit"
DELAY = "delay"
SHED = "shed"

_BUCKET_CAP = 4096
# how long a bucket's cached mClock limit serves before the profile
# resolver is consulted again (config pushes land within this window)
_LIMIT_TTL_S = 1.0

# bucket entry slots: [tokens, last_refill, cached_limit,
#                      limit_expiry]
_TOKENS, _LAST, _LIMIT, _EXPIRY = 0, 1, 2, 3


class AdmissionGate:
    """Token-bucket admission per tenant, rate = the tenant's mClock
    limit (0 = unlimited: always admit)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 profile_of: Optional[
                     Callable[[str], Tuple[float, float, float]]]
                 = None):
        config = config or {}
        self.enabled = bool(config.get(
            "osd_mclock_admission_enable", True)) and \
            flags.enabled("CEPH_TPU_QOS")
        # burst: seconds' worth of the limit rate a sleeping tenant
        # may spend instantly on wake (bucket capacity)
        self.burst_s = float(config.get(
            "osd_mclock_admission_burst", 2.0))
        self.max_delay_s = float(config.get(
            "osd_mclock_admission_max_delay_ms", 50.0)) / 1e3
        # (r, w, limit) resolver — shared with the scheduler so one
        # option surface drives both stages
        self._profile_of = profile_of or (lambda t: (0.0, 1.0, 0.0))
        # tenant -> [tokens, last_refill]; LRU-bounded
        self._buckets: "OrderedDict[str, list]" = OrderedDict()
        self.counters = {ADMIT: 0, DELAY: 0, SHED: 0}
        self._tenant_counters: "OrderedDict[str, Dict[str, int]]" = \
            OrderedDict()

    def _limit(self, tenant: str) -> float:
        return float(self._profile_of(tenant)[2])

    def _bucket(self, tenant: str, now: float) -> list:
        """O(1) on the hot path: one dict lookup + LRU touch.  The
        tenant's limit rides in the entry and refreshes on a short
        TTL — the per-op profile resolution (a `client.<t>` string
        build plus profile-map walks) was a measurable cost at
        extreme tenant counts."""
        b = self._buckets.get(tenant)
        if b is None:
            limit = self._limit(tenant)
            b = [limit * self.burst_s, now, limit,
                 now + _LIMIT_TTL_S]
            self._buckets[tenant] = b
            while len(self._buckets) > _BUCKET_CAP:
                self._buckets.popitem(last=False)
        else:
            self._buckets.move_to_end(tenant)
            if now >= b[_EXPIRY]:
                b[_LIMIT] = self._limit(tenant)
                b[_EXPIRY] = now + _LIMIT_TTL_S
        return b

    def _count(self, tenant: str, decision: str) -> None:
        self.counters[decision] += 1
        c = self._tenant_counters.get(tenant)
        if c is None:
            c = {ADMIT: 0, DELAY: 0, SHED: 0}
            self._tenant_counters[tenant] = c
            while len(self._tenant_counters) > _BUCKET_CAP:
                self._tenant_counters.popitem(last=False)
        else:
            self._tenant_counters.move_to_end(tenant)
        c[decision] += 1

    def try_admit(self, tenant: str,
                  cost: float = 1.0) -> Optional[str]:
        """The allocation-free SYNCHRONOUS fast path: ADMIT when the
        gate passes the op untouched (disabled gate, unlimited
        tenant, or the bucket covers the cost) — no coroutine object,
        no profile resolution, one bucket lookup.  None means the
        slow path must decide (delay or shed): callers then
        ``await admit(tenant, cost)``."""
        if not self.enabled:
            return ADMIT
        now = time.monotonic()
        b = self._bucket(tenant, now)
        limit = b[_LIMIT]
        if limit <= 0:
            self._count(tenant, ADMIT)
            return ADMIT
        cap = max(limit * self.burst_s, cost)
        b[_TOKENS] = min(cap, b[_TOKENS] + (now - b[_LAST]) * limit)
        b[_LAST] = now
        if b[_TOKENS] >= cost:
            b[_TOKENS] -= cost
            self._count(tenant, ADMIT)
            return ADMIT
        return None

    async def admit(self, tenant: str, cost: float = 1.0) -> str:
        """Returns ADMIT (possibly after an in-gate delay, counted
        DELAY) or SHED.  Unlimited tenants and a disabled gate admit
        unconditionally.  Hot-path callers should consult
        ``try_admit`` first and only await here on its None — this
        coroutine re-runs the fast path, so calling both never
        double-charges."""
        fast = self.try_admit(tenant, cost)
        if fast is not None:
            return fast
        b = self._buckets[tenant]
        limit = b[_LIMIT]
        wait = (cost - b[_TOKENS]) / limit
        if wait <= self.max_delay_s:
            # the delay IS the charge: the refill during the sleep
            # covers the op.  The smoothing sleep is a pipeline stage
            # an op can visibly spend its time in — span it (no-op
            # when the op is untraced; an instant ADMIT above costs
            # no wall time and gets no span)
            b[_TOKENS] -= cost
            self._count(tenant, DELAY)
            async with tracing.child_span("admission",
                                          tenant=tenant) as sp:
                sp.set_attr("decision", DELAY)
                await asyncio.sleep(wait)
            return ADMIT
        self._count(tenant, SHED)
        tracing.event(f"admission shed tenant={tenant}")
        return SHED

    # -- observability -----------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """qos_status shape: global + per-tenant decisions, live
        bucket levels, the gate's knobs."""
        return {
            "enabled": self.enabled,
            "burst_s": self.burst_s,
            "max_delay_ms": self.max_delay_s * 1e3,
            "decisions": dict(self.counters),
            "tenants": {
                t: {**c,
                    "limit_ops": self._limit(t),
                    "tokens": round(self._buckets.get(
                        t, [0.0])[0], 3)}
                for t, c in self._tenant_counters.items()},
        }

    def perf(self) -> Dict[str, Any]:
        """perf-dump `qos.admission` shape (numeric leaves only; the
        prometheus flattener turns `tenants` into tenant-labeled
        rows)."""
        return {
            "enabled": int(self.enabled),
            "admitted": self.counters[ADMIT],
            "delayed": self.counters[DELAY],
            "shed": self.counters[SHED],
            "tenants": {
                t: {"admitted": c[ADMIT], "delayed": c[DELAY],
                    "shed": c[SHED]}
                for t, c in self._tenant_counters.items()},
        }
