"""Straggler-tolerant hedged scheduling for EC sub-reads (port of
ceph_tpu/osd/hedge.py).

At scale the tail, not the median, is the product: an EC read that
`asyncio.gather`s ALL acting shards inherits the latency of the
slowest OSD, so one degraded peer sets p99 for the whole pool.  Coded
computation treats stragglers as the normal case — over-provision the
fan-out and complete from the first k arrivals (rateless/coded
redundancy scheduling, arXiv:1804.10331, arXiv:1811.02144).  Any-k
decode matrices are runtime operands of the decode kernel, so
completing from an arbitrary k-subset costs nothing on the decode
side; this module supplies the scheduling side:

* **PeerStats** — per-peer response-time EWMA + exponentially
  weighted variance, fed from every sub-read round trip.  Idle time
  decays both toward the prior with a configurable half-life, so an
  OSD that was slow (or down) re-earns trust instead of carrying a
  stale penalty forever.  Each peer also carries its own
  `common.circuit.CircuitBreaker` (one instance per peer):
  consecutive sub-read failures trip it, and a degraded peer ranks
  LAST in fan-out choice instead of being hedged against repeatedly.
* **HedgeTracker.gather** — the hedged-gather primitive: issue the k
  fastest-ranked sub-reads plus Δ speculative extras
  (`osd_hedge_delta`, escalating by one while the EWMA spread across
  peers is high), return as soon as the caller's `sufficient`
  predicate holds (any k DISTINCT shards landing on one version),
  fire a delayed hedge — the next-ranked spare sub-read — when a
  flight outlives its peer's p95-EWMA mark, and cancel stragglers
  cleanly: every spawned task is awaited before return, so a
  cancelled sub-read can neither leak nor corrupt connection framing
  (frame seq numbers are allocated under the connection send lock —
  see msg.Connection._send_signed).

Kill switches: CEPH_TPU_HEDGE=0 (env) or osd_hedge_enable=false both
restore the all-shard gather bit for bit; hedged and unhedged reads
return identical bytes either way — hedging only changes WHEN enough
arrivals exist, never what is decoded from them.
"""

from __future__ import annotations

import asyncio
import logging
import math
import os

from ceph_tpu_torch.common import flags
import time
from typing import (
    Any, Awaitable, Callable, Dict, List, Optional, Sequence, Tuple,
)

from ceph_tpu_torch.common import tracing
from ceph_tpu_torch.common.circuit import CLOSED, CircuitBreaker

log = logging.getLogger("osd.hedge")

__all__ = ["HedgeTracker", "PeerStats", "env_enabled"]

# z-score of the 95th percentile under the normal approximation of the
# RTT distribution (mean = EWMA, var = EW variance)
_Z95 = 1.645


def env_enabled() -> bool:
    return flags.enabled("CEPH_TPU_HEDGE")


class PeerStats:
    """One peer's response-time model: EWMA + EW variance + breaker."""

    __slots__ = ("osd", "alpha", "halflife", "prior", "ewma", "var",
                 "samples", "failures", "last_at", "breaker", "_clock")

    def __init__(self, osd: int, alpha: float, halflife: float,
                 prior: float,
                 clock: Callable[[], float] = time.monotonic):
        self.osd = osd
        self.alpha = alpha
        self.halflife = halflife
        self.prior = prior
        self.ewma = prior
        self.var = 0.0
        self.samples = 0
        self.failures = 0
        self.last_at = clock()
        self._clock = clock
        # the breaker state machine, one instance per peer: short
        # base backoff — a sub-read peer recovers on network timescales,
        # not accelerator-runtime ones
        self.breaker = CircuitBreaker(f"peer.{osd}", base_backoff=1.0,
                                      max_backoff=30.0, clock=clock)

    def _decay(self, now: float) -> None:
        """Drift the model toward the prior over idle time: trust is
        re-earned with a half-life, in both directions — a recovered
        OSD stops ranking last, a long-idle fast peer stops looking
        better than it currently is."""
        dt = now - self.last_at
        if dt <= 0:
            return
        self.last_at = now
        f = 0.5 ** (dt / self.halflife) if self.halflife > 0 else 0.0
        self.ewma = self.prior + (self.ewma - self.prior) * f
        self.var *= f

    def observe(self, rtt_s: float, ok: bool = True) -> None:
        now = self._clock()
        self._decay(now)
        self.samples += 1
        if ok:
            self.breaker.record_success()
        else:
            if self.breaker.state != CLOSED:
                # a sub-read reaching a peer whose backoff expired IS
                # its half-open probe: claim the probe slot so this
                # failure RE-trips with an escalated backoff.
                # (record_failure is a no-op in expired-OPEN — without
                # this a persistently dead peer is degraded for one
                # base backoff window and then reported healthy
                # forever.)
                self.breaker.allow()
            self.failures += 1
            self.breaker.record_failure()
        # failures still feed the RTT model: the timeout a failed
        # sub-read cost IS this peer's current response time
        self._feed(rtt_s)

    def observe_censored(self, elapsed_s: float) -> None:
        """A flight cancelled at `elapsed_s` is a RIGHT-CENSORED
        sample: the peer's RTT is AT LEAST that, and nothing more is
        known.  It may only move the model UP — a straggler cancelled
        the moment faster peers complete must not be taught the
        winners' latency (it would then rank among the fastest and
        tax every subsequent read).  The breaker is NOT fed: a cancel
        is the race being lost, not evidence of peer health either
        way."""
        self._decay(self._clock())
        if elapsed_s <= self.ewma:
            return
        self.samples += 1
        self._feed(elapsed_s)

    def _feed(self, rtt_s: float) -> None:
        d = rtt_s - self.ewma
        self.ewma += self.alpha * d
        self.var = max(0.0,
                       (1.0 - self.alpha) * (self.var
                                             + self.alpha * d * d))

    def ewma_now(self) -> float:
        """The decayed-as-of-now EWMA — ranking must see re-earned
        trust, not the estimate frozen at the last observation."""
        self._decay(self._clock())
        return self.ewma

    def p95(self) -> float:
        self._decay(self._clock())
        return self.ewma + _Z95 * math.sqrt(self.var)

    def degraded(self) -> bool:
        return self.breaker.degraded()

    def snapshot(self) -> Dict[str, Any]:
        self._decay(self._clock())
        return {
            "ewma_ms": round(self.ewma * 1e3, 3),
            "p95_ms": round(self.p95() * 1e3, 3),
            "samples": self.samples,
            "failures": self.failures,
            "state_code": self.breaker.stats()["state_code"],
        }


async def _traced_job(factory, span):
    """Run one sub-read job under its per-peer span (installed as the
    task's current span, so the wire context a _request stamps onto
    MOSDSubRead parents the replica's span to THIS sub-read, not to
    the whole op): cancellation (a straggler cut loose) is annotated
    so the critical-path reducer keeps the span off the path — the op
    never waited for it."""
    token = tracing.current_span.set(span) if span else None
    try:
        return await factory()
    except asyncio.CancelledError:
        span.set_attr("cancelled", True)
        span.event("cancelled straggler")
        raise
    finally:
        if token is not None:
            tracing.current_span.reset(token)
        span.finish()


class _Flight:
    """One in-flight hedgeable sub-read task's bookkeeping."""

    __slots__ = ("peer", "t0", "deadline", "is_hedge", "hedge_fired",
                 "span")

    def __init__(self, peer: int, t0: float, deadline: float,
                 is_hedge: bool, span=tracing.NULL_SPAN):
        self.peer = peer
        self.t0 = t0
        self.deadline = deadline
        self.is_hedge = is_hedge
        self.hedge_fired = False
        self.span = span


class HedgeTracker:
    """Per-daemon peer latency model + the hedged-gather primitive."""

    def __init__(self, who: str = "osd",
                 config: Optional[Dict[str, Any]] = None,
                 clock: Callable[[], float] = time.monotonic):
        cfg = config or {}
        self.who = who
        self.enabled = env_enabled() and bool(
            cfg.get("osd_hedge_enable", True))
        self.delta = int(cfg.get("osd_hedge_delta", 1))
        self.alpha = float(cfg.get("osd_hedge_ewma_alpha", 0.25))
        self.halflife = float(cfg.get("osd_hedge_decay_halflife", 30.0))
        self.prior_s = float(
            cfg.get("osd_hedge_rtt_prior_ms", 10.0)) / 1e3
        self.delay_floor_s = float(
            cfg.get("osd_hedge_delay_floor_ms", 2.0)) / 1e3
        self.delay_cap_s = float(
            cfg.get("osd_hedge_delay_cap_ms", 1000.0)) / 1e3
        self.spread_escalate = float(
            cfg.get("osd_hedge_spread_escalate", 4.0))
        self._clock = clock
        self.peers: Dict[int, PeerStats] = {}
        self.counters: Dict[str, int] = {
            "gathers": 0, "hedged_gathers": 0, "early_completions": 0,
            "hedges_fired": 0, "hedge_wins": 0,
            "cancelled_subreads": 0, "escalations": 0,
        }

    # -- the latency model -------------------------------------------------

    def peer(self, osd: int) -> PeerStats:
        st = self.peers.get(osd)
        if st is None:
            st = self.peers[osd] = PeerStats(
                osd, self.alpha, self.halflife, self.prior_s,
                clock=self._clock)
        return st

    def observe(self, osd: int, rtt_s: float, ok: bool = True) -> None:
        self.peer(osd).observe(rtt_s, ok=ok)

    def rank_key(self, osd: int) -> tuple:
        """Sort key for fan-out choice: healthy peers by decayed EWMA,
        breaker-degraded peers last (they are probed only when the
        faster ranks cannot complete the read — never hedged against
        repeatedly), osd id as the deterministic tiebreak."""
        st = self.peers.get(osd)
        if st is None:
            return (0, self.prior_s, osd)
        return (1 if st.degraded() else 0, st.ewma_now(), osd)

    def hedge_delay_s(self, osd: int) -> float:
        """How long a flight to this peer may run before it is treated
        as straggling and a spare sub-read is recruited: the peer's
        p95-EWMA mark, clamped to [floor, cap]."""
        st = self.peers.get(osd)
        p95 = st.p95() if st is not None else self.prior_s
        return min(max(p95, self.delay_floor_s), self.delay_cap_s)

    def spread(self) -> float:
        """Max-p95 over min-EWMA across non-degraded sampled peers — a
        high ratio means the tail is currently wide and Δ should
        escalate."""
        ewmas = []
        p95s = []
        for st in self.peers.values():
            if st.samples == 0 or st.degraded():
                continue
            ewmas.append(max(st.ewma_now(), 1e-9))
            p95s.append(st.p95())
        if len(ewmas) < 2:
            return 1.0
        return max(p95s) / min(ewmas)

    def effective_delta(self) -> int:
        """Δ speculative extras beyond k, +1 while the EWMA spread is
        high (the rateless over-provisioning knob, demand-driven)."""
        if self.spread() > self.spread_escalate:
            self.counters["escalations"] += 1
            return self.delta + 1
        return self.delta

    # -- the gather primitive ----------------------------------------------

    async def gather(
            self,
            jobs: Sequence[Tuple[int, Callable[[], Awaitable[Any]]]],
            need: Optional[int] = None,
            sufficient: Optional[Callable[[List[Any]], bool]] = None,
            failed: Optional[Callable[[Any], bool]] = None,
            label: str = "subread",
    ) -> Tuple[List[Any], bool]:
        """Run (peer, job-factory) pairs; return (results, ran_all).

        need=None (or hedging disabled, or no spare fan-out) runs every
        job concurrently and awaits them all — the all-shard mode, bit
        identical to a bare gather but with named, cancellation-safe
        tasks.  With need=k and spare jobs available, jobs launch in
        EWMA rank order (k + Δ initially), a flight that outlives its
        peer's p95 recruits the next-ranked spare, a job the `failed`
        predicate rejects (transport fault / no candidates) recruits a
        spare immediately, and the call returns as soon as `sufficient`
        accepts the collected results — stragglers are cancelled AND
        awaited, so no task outlives the call.

        ran_all is True only when every job ran to completion: an
        early (hedged) exit can never masquerade as an exhaustive
        probe.

        label names the per-flight stage spans ("subread" for the EC
        read fan-out, "subcompute" for coded-compute sub-ops) so each
        workload class gets its own row in the critical-path stage
        histograms."""
        jobs = list(jobs)
        if not jobs:
            return [], True
        self.counters["gathers"] += 1
        loop = asyncio.get_running_loop()
        hedged = (self.enabled and need is not None and 0 < need
                  and sufficient is not None and len(jobs) > need)
        if not hedged:
            tasks = [loop.create_task(
                _traced_job(factory,
                            tracing.start_child(
                                f"{label} osd.{peer}")),
                name=f"hedge:{self.who}:all:{peer}")
                for peer, factory in jobs]
            try:
                results = await asyncio.gather(*tasks)
            except BaseException:
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                raise
            return list(results), True

        self.counters["hedged_gathers"] += 1
        order = sorted(jobs, key=lambda j: self.rank_key(j[0]))
        flights: Dict[asyncio.Task, _Flight] = {}
        results: List[Any] = []
        next_i = 0
        ran_all = True
        early_exit = False

        def launch(is_hedge: bool) -> Optional[asyncio.Task]:
            nonlocal next_i
            if next_i >= len(order):
                return None
            peer, factory = order[next_i]
            next_i += 1
            span = tracing.start_child(f"{label} osd.{peer}",
                                       hedge=is_hedge)
            task = loop.create_task(
                _traced_job(factory, span),
                name=f"hedge:{self.who}:{peer}:{next_i}")
            now = loop.time()
            flights[task] = _Flight(
                peer, now, now + self.hedge_delay_s(peer), is_hedge,
                span=span)
            if is_hedge:
                self.counters["hedges_fired"] += 1
                tracing.event(f"hedge fired -> osd.{peer}")
            return task

        for _ in range(min(len(order), need + self.effective_delta())):
            launch(False)
        try:
            while flights:
                timeout = None
                if next_i < len(order):
                    now = loop.time()
                    unfired = [fl.deadline - now
                               for fl in flights.values()
                               if not fl.hedge_fired]
                    if unfired:
                        timeout = max(0.0, min(unfired))
                done, _pending = await asyncio.wait(
                    set(flights), timeout=timeout,
                    return_when=asyncio.FIRST_COMPLETED)
                if not done:
                    # hedge timer: every overdue flight recruits one
                    # spare (ranked next) exactly once
                    now = loop.time()
                    for fl in list(flights.values()):
                        if not fl.hedge_fired and now >= fl.deadline:
                            fl.hedge_fired = True
                            if launch(True) is None:
                                break
                    continue
                for task in done:
                    fl = flights.pop(task)
                    try:
                        res = task.result()
                    except asyncio.CancelledError:
                        ran_all = False
                        continue
                    except Exception:
                        # a sub-read job that RAISES (they normally
                        # report transport faults in-band) still only
                        # costs its slot: recruit the next spare.
                        # Logged loudly — with the kill switch off the
                        # same raise would propagate, and a swallowed
                        # error must not make hedged mode the mode
                        # where bugs hide
                        log.exception(
                            "%s: hedged sub-read job to osd.%d "
                            "raised (recruiting a spare)",
                            self.who, fl.peer)
                        ran_all = False
                        launch(False)
                        continue
                    results.append(res)
                    if failed is not None and failed(res):
                        # transport fault or no candidates from that
                        # shard: recruit a spare now instead of
                        # waiting for a hedge timer
                        fl.span.set_attr("failed", True)
                        launch(False)
                    elif fl.is_hedge:
                        self.counters["hedge_wins"] += 1
                        fl.span.set_attr("hedge_win", True)
                        tracing.event(f"hedge win osd.{fl.peer}")
                if sufficient(results):
                    if flights or next_i < len(order):
                        self.counters["early_completions"] += 1
                        ran_all = False
                    early_exit = True
                    return results, ran_all
                if not flights:
                    # every flight completed yet the results are
                    # still insufficient — candidates `failed` does
                    # not reject (hinfo-corrupt payloads, version-
                    # divergent generations) satisfy nothing: go
                    # WIDE, like the all-shard gather would.  This
                    # wave proved the ranked prefix insufficient;
                    # recruiting spares one per wave would serialize
                    # the residual probes into O(n) round trips on
                    # exactly the degraded reads hedging exists to
                    # speed up.
                    while launch(False) is not None:
                        pass
            return results, ran_all and next_i >= len(order)
        finally:
            if flights:
                self.counters["cancelled_subreads"] += len(flights)
                now = loop.time()
                for task, fl in flights.items():
                    task.cancel()
                    if early_exit:
                        # a straggler cancelled by EARLY COMPLETION
                        # feeds its elapsed time as a right-censored
                        # sample (observe_censored: moves the model
                        # up only, breaker untouched) — a peer whose
                        # flights always out-live their hedge mark
                        # ratchets upward and drops out of the
                        # fan-out, while one cancelled the instant
                        # faster peers answered learns nothing.
                        # EXTERNAL cancellation (the client op / the
                        # daemon dying) charges nobody: that elapsed
                        # time is the canceller's impatience, not the
                        # peer's latency.
                        self.peer(fl.peer).observe_censored(
                            max(now - fl.t0, 0.0))
                # awaiting the cancelled tasks is the no-leak
                # guarantee: nothing spawned here outlives the gather
                await asyncio.gather(*flights, return_exceptions=True)

    # -- observability -----------------------------------------------------

    def perf(self) -> Dict[str, Any]:
        """Numeric-only nested snapshot for `perf dump` (the
        prometheus flattener turns the `peers` map into peer-labeled
        rows)."""
        return {
            "enabled": int(self.enabled),
            **self.counters,
            "peers": {f"osd.{osd}": st.snapshot()
                      for osd, st in sorted(self.peers.items())},
        }

    def status(self) -> Dict[str, Any]:
        """The hedge_status admin/tell surface: config + counters +
        the live per-peer model with breaker states."""
        peers = {}
        for osd, st in sorted(self.peers.items()):
            snap = st.snapshot()
            snap["breaker"] = st.breaker.stats()["state"]
            peers[f"osd.{osd}"] = snap
        return {
            "enabled": self.enabled,
            "delta": self.delta,
            "spread": round(self.spread(), 3),
            "spread_escalate": self.spread_escalate,
            "delay_floor_ms": self.delay_floor_s * 1e3,
            "delay_cap_ms": self.delay_cap_s * 1e3,
            "decay_halflife_s": self.halflife,
            "counters": dict(self.counters),
            "peers": peers,
        }
