"""Paxos + elections for the multi-monitor control plane (port of
ceph_tpu/mon/paxos.py).

Reference parity: the reference's src/mon/Paxos.cc (collect/last/begin/
accept/commit/lease state machine, PN = (n/100+1)*100+rank, one in-flight
proposal, peon catch-up by sharing committed values),
the reference's src/mon/ElectionLogic.cc + Elector.cc (epoch-numbered
elections, lowest rank in the connected majority wins, victory broadcast),
re-designed for this framework's asyncio messenger.

Shape notes (where this deliberately differs from the reference, for
honesty):
- One Paxos instance carries one value stream (OSDMap incrementals);
  the reference multiplexes several PaxosServices over one Paxos.
- Peons serve OSDMap reads from committed state regardless of lease —
  epochs are monotonic and every consumer already handles staleness by
  pulling ranges; the lease's load-bearing role here is leader liveness
  (a peon whose lease expires calls an election), matching the
  reference's failure-detection effect if not its read gating.
- Committed values ship inside the COMMIT message (the reference also
  does this for peons that missed the BEGIN).

Durability: every accept/commit writes through the mon's KeyValueDB in
the same transaction as the map it produces (MonitorDBStore discipline);
an in-memory dict stands in when the mon runs storeless (unit tests).
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Any, Awaitable, Callable, Dict, List, Optional, Set

from ceph_tpu_torch.common import lockdep
from ceph_tpu_torch.msg.messages import MMonElection, MMonPaxos

log = logging.getLogger("mon.paxos")

# MMonElection kinds
E_PROPOSE = 1
E_ACK = 2
E_VICTORY = 3
E_PING = 4
E_PONG = 5

# mon_election_default_strategy values (ElectionLogic.h)
STRATEGY_CLASSIC = 1
STRATEGY_CONNECTIVITY = 3

# MMonPaxos ops (Paxos.h op names)
OP_COLLECT = 1
OP_LAST = 2
OP_BEGIN = 3
OP_ACCEPT = 4
OP_COMMIT = 5
OP_LEASE = 6
OP_PULL = 7   # peon asks leader for committed values it missed
OP_FULL = 8   # leader ships a full-state snapshot past a trimmed log

DEFAULTS = {
    "mon_lease": 2.0,
    "mon_lease_renew_interval_factor": 0.4,
    "mon_election_timeout": 2.5,
    "mon_accept_timeout": 2.0,
    "paxos_max_log": 1024,
    "mon_election_default_strategy": STRATEGY_CLASSIC,
    "mon_elector_ping_interval": 0.4,
    "mon_elector_score_halflife": 4.0,
    "mon_elector_ignore_propose_margin": 0.05,
}


class ConnectionTracker:
    """Peer-reachability scores for CONNECTIVITY elections.

    Reference parity: the reference's src/mon/ConnectionTracker.cc —
    each mon scores every peer by the fraction of recent ping epochs it
    answered, decayed with a half-life so old history fades.  The
    reference gossips full per-peer report blobs and averages everyone's
    view of a candidate; here each mon keeps its own view and candidates
    self-report one aggregate in the PROPOSE message — the two views are
    averaged at the voter (same signal, one float on the wire).
    """

    def __init__(self, half_life: float = 4.0):
        self.half_life = max(0.1, float(half_life))
        # peer -> [score, last_report_monotonic]; unseen peers score 1.0
        # (a freshly-booted quorum must be electable before any pings)
        self._scores: Dict[int, List[float]] = {}

    def report(self, peer: int, ok: bool,
               now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        ent = self._scores.get(peer)
        if ent is None:
            ent = [1.0, now]
            self._scores[peer] = ent
        score, last = ent
        # decay the old estimate toward this observation: weight halves
        # every half_life seconds of elapsed time (so a peer that stops
        # answering slides to 0 at a rate set by config, not ping count)
        w = 0.5 ** (max(0.0, now - last) / self.half_life)
        ent[0] = score * w + (0.0 + ok) * (1.0 - w)
        ent[1] = now

    def score(self, peer: int) -> float:
        ent = self._scores.get(peer)
        return 1.0 if ent is None else ent[0]

    def my_score(self, n: int, me: int) -> float:
        """Aggregate: mean reachability of every OTHER mon from here —
        a mon with lossy links sees low scores everywhere, so its own
        candidacy self-reports weak (get_total_connection_score role)."""
        others = [self.score(p) for p in range(n) if p != me]
        return sum(others) / len(others) if others else 1.0

    def best_link(self, n: int, me: int) -> float:
        """Max peer score: distinguishes 'I am healthy, THAT peer is
        lossy' (max ~1: some link is solid) from 'MY links are lossy'
        (max low: every view is degraded).  The mean cannot tell the
        two apart — both drag it down."""
        others = [self.score(p) for p in range(n) if p != me]
        return max(others) if others else 1.0


class MemStore:
    """Dict-shaped stand-in for the KeyValueDB when the mon is
    storeless; same get/transaction surface the mon uses."""

    def __init__(self) -> None:
        self.kv: Dict[tuple, bytes] = {}

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        return self.kv.get((table, bytes(key)))

    def get_iterator(self, table: str):
        return sorted((k[1], v) for k, v in self.kv.items()
                      if k[0] == table)

    class _Txn:
        def __init__(self, kv):
            self.kv = kv
            self.ops: List = []

        def set(self, table, key, val):
            self.ops.append(("set", table, bytes(key), bytes(val)))

        def rm_range_keys(self, table, lo, hi):
            self.ops.append(("rm_range", table, bytes(lo), bytes(hi)))

    def get_transaction(self):
        return self._Txn(self.kv)

    def submit_transaction_sync(self, t) -> None:
        for op in t.ops:
            if op[0] == "set":
                self.kv[(op[1], op[2])] = op[3]
            else:
                _tag, table, lo, hi = op
                for k in [k for k in self.kv
                          if k[0] == table and lo <= k[1] < hi]:
                    del self.kv[k]


class Elector:
    """Elections (ElectionLogic.cc strategies): CLASSIC — the lowest
    rank a majority can reach wins; CONNECTIVITY — candidates carry a
    reachability score and voters defer to the best-connected candidate
    (rank only breaks ties), so a flapping low-rank mon stops winning."""

    def __init__(self, rank: int, n: int,
                 send: Callable[[int, Any], Awaitable[None]],
                 on_win: Callable[[int, Set[int]], Awaitable[None]],
                 on_lose: Callable[[int, int], Awaitable[None]],
                 config: Dict[str, Any]):
        self.rank = rank
        self.n = n
        self.send = send
        self.on_win = on_win      # (epoch, quorum)
        self.on_lose = on_lose    # (epoch, leader)
        self.config = config
        self.epoch = 0            # persisted by the mon across restarts
        self.leader: Optional[int] = None
        self.quorum: Set[int] = set()
        self.electing = False
        self._acks: Set[int] = set()
        self._timer: Optional[asyncio.Task] = None
        # single promise per epoch: (epoch, rank) last acked — without
        # this, two proposers can both assemble a majority in the same
        # epoch (the split-vote a promise rules out)
        self._promised: tuple = (0, -1)
        self.strategy = int(config.get(
            "mon_election_default_strategy", STRATEGY_CLASSIC))
        self.tracker = ConnectionTracker(float(config.get(
            "mon_elector_score_halflife", 4.0)))
        self._ping_task: Optional[asyncio.Task] = None
        self._pong_pending: Set[int] = set()
        # boot grace: a peer still booting (messenger bound, elector
        # not yet dispatching) must not poison the tracker before it
        # had a chance to answer — but only for a bounded time, or a
        # permanently dark peer would keep a perfect score forever
        self._ever_ponged: Set[int] = set()
        self._first_ping: Dict[int, float] = {}
        self._last_dethrone = 0.0
        # retained: asyncio holds tasks weakly — an unreferenced
        # dethrone election could be GC'd mid-flight
        self._dethrone_task: Optional[asyncio.Task] = None

    @property
    def majority(self) -> int:
        return self.n // 2 + 1

    def _margin(self) -> float:
        return float(self.config.get(
            "mon_elector_ignore_propose_margin", 0.05))

    def my_score(self) -> float:
        return self.tracker.my_score(self.n, self.rank)

    def _should_defer(self, msg: Any) -> bool:
        """CONNECTIVITY vote: defer to a candidate that is better
        connected than me (averaging its self-report with my own view of
        it — the reference averages every mon's report); within the
        margin, fall back to rank priority so equal-health quorums still
        converge on rank like CLASSIC."""
        if self.strategy != STRATEGY_CONNECTIVITY:
            return msg.rank < self.rank
        cand = (msg.score + self.tracker.score(msg.rank)) / 2.0
        mine = self.my_score()
        m = self._margin()
        if cand > mine + m:
            return True
        if cand < mine - m:
            return False
        return msg.rank < self.rank

    async def start(self) -> None:
        if self.strategy == STRATEGY_CONNECTIVITY and self.n > 1:
            self._ping_task = asyncio.get_running_loop().create_task(
                self._ping_loop())
        await self.call_election()

    async def _ping_loop(self) -> None:
        """Mon-to-mon liveness probes feeding the tracker (Elector's
        send_peer_ping/begin_peer_ping role): a peer that misses the
        round-trip by the next cycle scores a failure.  Probes run
        concurrently under a timeout — a blackholed peer (dropped-SYN
        partition, the very case CONNECTIVITY exists for) must not
        stall the other peers' probes behind its TCP connect."""
        interval = float(self.config.get(
            "mon_elector_ping_interval", 0.4))
        boot_grace = float(self.config.get(
            "mon_election_timeout", 2.5))

        async def probe(peer: int) -> None:
            try:
                await asyncio.wait_for(
                    self.send(peer, MMonElection(
                        E_PING, self.epoch, self.rank)),
                    timeout=max(interval, 0.1))
            except Exception:
                pass  # the missed pong is the signal

        while True:
            now = time.monotonic()
            for peer in self._pong_pending:
                if peer in self._ever_ponged or \
                        now - self._first_ping.get(peer, now) \
                        > boot_grace:
                    self.tracker.report(peer, False)
            self._pong_pending = {p for p in range(self.n)
                                  if p != self.rank}
            for peer in self._pong_pending:
                self._first_ping.setdefault(peer, now)
            await asyncio.gather(*(probe(p)
                                   for p in self._pong_pending))
            self._maybe_dethrone(now)
            await asyncio.sleep(interval)

    def _maybe_dethrone(self, now: float) -> None:
        """Scores are otherwise only consulted at election time — a
        sitting leader whose links collapse would reign as long as the
        odd lease squeaks through.  A peon dethrones only on ABSOLUTE
        evidence: the leader's link to me has collapsed (score below
        the bar) AND I hold at least one solid link (a mon whose OWN
        links are lossy sees everyone low, including the leader — a
        relative mine-vs-leader comparison would let the flapping node
        itself thrash elections).  Rate-limited to one per election
        timeout so a borderline score can't thrash either."""
        if self.electing or self.leader is None or \
                self.leader == self.rank:
            return
        cooldown = float(self.config.get("mon_election_timeout", 2.5))
        if now - self._last_dethrone < cooldown:
            return
        lead = self.tracker.score(self.leader)
        best = self.tracker.best_link(self.n, self.rank)
        if lead < 0.5 and best >= 0.75:
            self._last_dethrone = now
            log.warning("mon.%d: leader mon.%d connectivity score %.2f"
                        " collapsed (my best link %.2f) — calling"
                        " election", self.rank, self.leader, lead, best)
            self._dethrone_task = asyncio.get_running_loop() \
                .create_task(self.call_election())

    async def call_election(self) -> None:
        # campaign above every epoch seen OR promised: a promise given
        # to another candidate in epoch e blocks acks at e, so my bid
        # must exceed it to collect fresh promises
        self.epoch = max(self.epoch, self._promised[0]) + 1
        if self.epoch % 2 == 0:   # odd = electing (Elector convention)
            self.epoch += 1
        self.electing = True
        self.leader = None
        self._acks = {self.rank}
        self._promised = (self.epoch, self.rank)
        if self.n == 1:
            await self._declare_victory()
            return
        log.info("mon.%d: calling election (epoch %d)", self.rank,
                 self.epoch)
        for peer in range(self.n):
            if peer != self.rank:
                await self.send(peer, MMonElection(
                    E_PROPOSE, self.epoch, self.rank,
                    score=self.my_score()))
        self._arm_timer()

    def _arm_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
        timeout = float(self.config.get("mon_election_timeout", 2.5))
        timeout *= 1.0 + random.random() * 0.3

        async def expire():
            await asyncio.sleep(timeout)
            if self.electing:
                await self.call_election()

        self._timer = asyncio.get_running_loop().create_task(expire())

    async def _declare_victory(self) -> None:
        self.epoch += 1            # even = stable
        self.electing = False
        self.leader = self.rank
        self.quorum = set(self._acks)
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        log.info("mon.%d: won election epoch %d (quorum %s)", self.rank,
                 self.epoch, sorted(self.quorum))
        for peer in range(self.n):
            if peer != self.rank:
                await self.send(peer, MMonElection(
                    E_VICTORY, self.epoch, self.rank,
                    quorum=sorted(self.quorum)))
        await self.on_win(self.epoch, self.quorum)

    async def handle(self, msg: MMonElection) -> None:
        if msg.kind == E_PING:
            await self.send(msg.rank, MMonElection(
                E_PONG, msg.epoch, self.rank))
            return
        if msg.kind == E_PONG:
            self._pong_pending.discard(msg.rank)
            self._ever_ponged.add(msg.rank)
            self.tracker.report(msg.rank, True)
            return
        if msg.kind == E_PROPOSE:
            if self._should_defer(msg):
                # one promise per epoch: ack only a bid NEWER than the
                # last promise (re-ack the same candidate is fine)
                pe, pr = self._promised
                if msg.epoch < pe or (msg.epoch == pe
                                      and msg.rank != pr):
                    return  # promised elsewhere; its timeout rebids
                self._promised = (msg.epoch, msg.rank)
                self.epoch = max(self.epoch, msg.epoch)
                self.electing = True
                self.leader = None
                self._arm_timer()   # re-elect if it never wins
                await self.send(msg.rank, MMonElection(
                    E_ACK, msg.epoch, self.rank))
            else:
                # I am the better candidate (lower rank under CLASSIC;
                # better-connected under CONNECTIVITY): push my own
                # candidacy — the strategy's convergence rule
                await self.call_election()
        elif msg.kind == E_ACK:
            if self.electing and msg.epoch == self.epoch:
                self._acks.add(msg.rank)
                if len(self._acks) >= self.majority:
                    await self._declare_victory()
            elif not self.electing and self.leader == self.rank and \
                    msg.epoch == self.epoch - 1 and \
                    msg.rank not in self.quorum:
                # late ack from a slow peer: absorb it into the quorum
                # (it gets commits/leases either way — only the stat
                # surface and victory broadcast record membership)
                self.quorum.add(msg.rank)
        elif msg.kind == E_VICTORY:
            if msg.epoch >= self.epoch:
                self.epoch = msg.epoch
                self.electing = False
                self.leader = msg.rank
                self.quorum = set(msg.quorum or [])
                if self._timer is not None:
                    self._timer.cancel()
                    self._timer = None
                await self.on_lose(msg.epoch, msg.rank)
                if msg.rank > self.rank and self._should_preempt(msg):
                    # a worse candidate leads while I am alive: take
                    # the quorum back (Ceph: a booting lower rank calls
                    # an election and wins it) — under CONNECTIVITY
                    # only when I am demonstrably better connected,
                    # else a lossy low-rank mon thrashes the quorum
                    await self.call_election()

    def _should_preempt(self, msg: MMonElection) -> bool:
        if self.strategy != STRATEGY_CONNECTIVITY:
            return True
        return self.my_score() > \
            self.tracker.score(msg.rank) + self._margin()

    def shutdown(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._ping_task is not None:
            self._ping_task.cancel()
            self._ping_task = None
        if self._dethrone_task is not None:
            self._dethrone_task.cancel()
            self._dethrone_task = None


class Paxos:
    """One Paxos value stream (the OSDMap incremental log)."""

    def __init__(self, rank: int, n: int,
                 send: Callable[[int, Any], Awaitable[None]],
                 store,
                 apply_fn: Callable[[int, bytes, Any], None],
                 snapshot_fn: Callable[[], bytes],
                 install_fn: Callable[[int, bytes, Any], None],
                 config: Dict[str, Any]):
        """apply_fn(version, value, txn): apply one committed value and
        stage any derived durable state into txn.
        snapshot_fn() -> full-state blob for OP_FULL catch-up.
        install_fn(version, blob, txn): adopt a full-state snapshot."""
        self.rank = rank
        self.n = n
        self.send = send
        self.store = store if store is not None else MemStore()
        self.apply_fn = apply_fn
        self.snapshot_fn = snapshot_fn
        self.install_fn = install_fn
        self.config = dict(DEFAULTS)
        self.config.update(config or {})
        # durable state
        self.last_pn = 0          # highest PN promised (collect)
        self.accepted_pn = 0      # PN of the collect we accepted
        # PN of MY current reign (leader only).  accepted_pn can be
        # overwritten by a rival's higher-PN collect while we still
        # think we lead; proposing with accepted_pn would then make two
        # proposers share one PN and peons would accept both BEGINs for
        # the same version — divergent commits.  _begin proposes with
        # _my_pn and steps down on mismatch (quorum-safety guard).
        self._my_pn = 0
        self.last_committed = 0
        self.first_committed = 0
        self.uncommitted: Optional[tuple] = None  # (pn, v, value)
        self._load()
        # volatile
        self.leading = False
        self.quorum: Set[int] = set()
        self.active = False       # leader: collect phase done
        self.lease_expiry = 0.0   # peon: monotonic deadline
        self._last: Dict[int, MMonPaxos] = {}
        self._accepts: Set[int] = set()
        self._begin_version = 0
        self._accept_event: Optional[asyncio.Event] = None
        self._propose_lock = lockdep.Lock("paxos.propose")
        self._lease_task: Optional[asyncio.Task] = None
        self.on_leader_dead: Optional[Callable[[], Awaitable[None]]] = \
            None

    # -- durability --------------------------------------------------------

    def _load(self) -> None:
        g = self.store.get
        self.last_pn = int((g("paxos", b"last_pn") or b"0").decode())
        self.accepted_pn = int(
            (g("paxos", b"accepted_pn") or b"0").decode())
        self.last_committed = int(
            (g("paxos", b"last_committed") or b"0").decode())
        self.first_committed = int(
            (g("paxos", b"first_committed") or b"0").decode())
        unc = g("paxos", b"uncommitted")
        if unc:
            pn, v, value = unc.split(b":", 2)
            self.uncommitted = (int(pn), int(v), value)

    def _stage(self, t) -> None:
        t.set("paxos", b"last_pn", str(self.last_pn).encode())
        t.set("paxos", b"accepted_pn", str(self.accepted_pn).encode())
        t.set("paxos", b"last_committed",
              str(self.last_committed).encode())
        t.set("paxos", b"first_committed",
              str(self.first_committed).encode())
        if self.uncommitted is not None:
            pn, v, value = self.uncommitted
            t.set("paxos", b"uncommitted",
                  b"%d:%d:" % (pn, v) + value)
        else:
            t.set("paxos", b"uncommitted", b"")

    def _persist(self, mutate=None) -> None:
        t = self.store.get_transaction()
        self._stage(t)
        if mutate is not None:
            mutate(t)
        self.store.submit_transaction_sync(t)

    def log_value(self, v: int) -> Optional[bytes]:
        return self.store.get("paxos_log", v.to_bytes(8, "big"))

    def _stage_log(self, t, v: int, value: bytes) -> None:
        t.set("paxos_log", v.to_bytes(8, "big"), value)
        max_log = int(self.config["paxos_max_log"])
        floor = max(0, v - max_log)
        if floor > self.first_committed:
            t.rm_range_keys("paxos_log", (0).to_bytes(8, "big"),
                            floor.to_bytes(8, "big"))
            self.first_committed = floor

    # -- helpers -----------------------------------------------------------

    @property
    def majority(self) -> int:
        return self.n // 2 + 1

    def _new_pn(self) -> int:
        pn = (max(self.last_pn, self.accepted_pn) // 100 + 1) * 100 \
            + self.rank
        self.last_pn = pn
        return pn

    def lease_valid(self) -> bool:
        if self.leading:
            return self.active
        return time.monotonic() < self.lease_expiry

    # -- leader ------------------------------------------------------------

    async def leader_init(self, quorum: Set[int]) -> None:
        """Collect phase (Paxos::collect): learn peers' state, recover
        any uncommitted value, bring stragglers up to date."""
        self.leading = True
        self.active = False
        self.quorum = set(quorum)
        self._stop_lease()
        if self.n == 1:
            if self.uncommitted is not None:
                # a value accepted but not committed before a crash:
                # with no peers its fate is ours alone — commit it
                pn, v, value = self.uncommitted
                if v == self.last_committed + 1:
                    self._commit_value(v, value)
            self._my_pn = self.accepted_pn
            self.active = True
            return
        pn = self._new_pn()
        self.accepted_pn = pn
        self._my_pn = pn
        self._persist()
        self._last = {}
        collect = MMonPaxos(OP_COLLECT, pn=pn,
                            last_committed=self.last_committed,
                            first_committed=self.first_committed)
        # all peers, not just the election quorum: a mon whose ack
        # arrived late still syncs and receives leases — only the
        # MAJORITY gate below decides progress
        for peer in range(self.n):
            if peer != self.rank:
                await self.send(peer, collect)
        # wait for a majority of LASTs (self counts)
        deadline = time.monotonic() + float(
            self.config["mon_accept_timeout"])
        while len(self._last) + 1 < self.majority:
            if time.monotonic() > deadline:
                log.warning("mon.%d: collect timed out (%d/%d)",
                            self.rank, len(self._last) + 1,
                            self.majority)
                if self.on_leader_dead is not None:
                    await self.on_leader_dead()
                return
            await asyncio.sleep(0.02)
        # sync FORWARD first: a lagging (or freshly revived, storeless)
        # mon that wins on rank priority must adopt the quorum's
        # committed history before proposing anything — otherwise it
        # would fork acknowledged commits.  Pull from the most advanced
        # peer and wait until caught up.
        max_lc = max([last.last_committed
                      for last in self._last.values()]
                     + [self.last_committed])
        if max_lc > self.last_committed:
            ahead = max(self._last,
                        key=lambda p: self._last[p].last_committed)
            log.info("mon.%d: behind quorum (lc %d < %d), pulling from"
                     " mon.%d", self.rank, self.last_committed, max_lc,
                     ahead)
            await self.send(ahead, MMonPaxos(
                OP_PULL, last_committed=self.last_committed))
            while self.last_committed < max_lc:
                if time.monotonic() > deadline:
                    log.warning("mon.%d: catch-up timed out (lc %d <"
                                " %d)", self.rank, self.last_committed,
                                max_lc)
                    if self.on_leader_dead is not None:
                        await self.on_leader_dead()
                    return
                await asyncio.sleep(0.02)
        # adopt the newest uncommitted value seen (highest accepted_pn)
        best = self.uncommitted
        for last in self._last.values():
            if last.version and last.value:
                cand = (last.pn, last.version, last.value)
                if cand[1] == self.last_committed + 1 and \
                        (best is None or cand[0] > best[0]):
                    best = cand
        # bring lagging peers up to date
        for peer, last in self._last.items():
            if last.last_committed < self.last_committed:
                await self._share(peer, last.last_committed)
        self.active = True
        self._start_lease()
        if best is not None and best[1] == self.last_committed + 1:
            log.info("mon.%d: re-proposing uncommitted v%d from pn %d",
                     self.rank, best[1], best[0])
            await self._begin(best[2])

    async def _share(self, peer: int, peer_lc: int) -> None:
        """Ship committed values (or a snapshot past the trim floor)."""
        if peer_lc < self.first_committed:
            await self.send(peer, MMonPaxos(
                OP_FULL, last_committed=self.last_committed,
                value=self.snapshot_fn()))
            return
        values = {}
        for v in range(peer_lc + 1, self.last_committed + 1):
            val = self.log_value(v)
            if val is None:
                await self.send(peer, MMonPaxos(
                    OP_FULL, last_committed=self.last_committed,
                    value=self.snapshot_fn()))
                return
            values[v] = val
        await self.send(peer, MMonPaxos(
            OP_COMMIT, pn=self.accepted_pn,
            last_committed=self.last_committed, values=values))

    async def propose(self, value: bytes) -> bool:
        """Leader-only: replicate one value; True once committed on a
        majority.  Serialized — one in-flight proposal (Paxos.cc's
        single-pipeline discipline)."""
        async with self._propose_lock:
            if not (self.leading and self.active):
                return False
            return await self._begin(value)

    async def _begin(self, value: bytes) -> bool:
        v = self.last_committed + 1
        pn = self._my_pn
        if pn != self.accepted_pn or not self.leading:
            # a rival's higher-PN collect superseded this reign between
            # proposals (see _my_pn) — step down instead of proposing
            # under a PN that is no longer exclusively ours
            log.warning("mon.%d: reign pn %d superseded by %d —"
                        " stepping down", self.rank, pn,
                        self.accepted_pn)
            self.leading = False
            self.active = False
            self._stop_lease()
            if self.on_leader_dead is not None:
                await self.on_leader_dead()
            return False
        self.uncommitted = (pn, v, value)
        self._persist()
        self._accepts = {self.rank}
        self._begin_version = v
        self._accept_event = asyncio.Event()
        if self.n > 1:
            msg = MMonPaxos(OP_BEGIN, pn=pn, version=v, value=value,
                            last_committed=self.last_committed)
            for peer in range(self.n):
                if peer != self.rank:
                    await self.send(peer, msg)
            try:
                await asyncio.wait_for(
                    self._accept_event.wait(),
                    float(self.config["mon_accept_timeout"]))
            except asyncio.TimeoutError:
                log.warning("mon.%d: begin v%d pn %d: no majority"
                            " (%d/%d) — stepping down", self.rank, v,
                            pn, len(self._accepts), self.majority)
                self.active = False
                if self.on_leader_dead is not None:
                    await self.on_leader_dead()
                return False
        self._commit_value(v, value)
        if self.n > 1:
            commit = MMonPaxos(OP_COMMIT, pn=pn,
                               last_committed=self.last_committed,
                               values={v: value})
            for peer in range(self.n):
                if peer != self.rank:
                    await self.send(peer, commit)
        return True

    def _commit_value(self, v: int, value: bytes) -> None:
        """Durable commit + apply in ONE store transaction."""
        assert v == self.last_committed + 1
        self.last_committed = v
        self.uncommitted = None

        def mutate(t):
            self._stage_log(t, v, value)
            self.apply_fn(v, value, t)

        self._persist(mutate)

    # -- lease -------------------------------------------------------------

    def _start_lease(self) -> None:
        self._stop_lease()
        if self.n == 1:
            return

        async def lease_loop():
            lease = float(self.config["mon_lease"])
            interval = lease * float(
                self.config["mon_lease_renew_interval_factor"])
            while self.leading and self.active:
                msg = MMonPaxos(OP_LEASE,
                                last_committed=self.last_committed,
                                lease=lease)
                for peer in range(self.n):
                    if peer != self.rank:
                        try:
                            await self.send(peer, msg)
                        except Exception:
                            pass
                await asyncio.sleep(interval)

        self._lease_task = asyncio.get_running_loop().create_task(
            lease_loop())

    def _stop_lease(self) -> None:
        if self._lease_task is not None:
            self._lease_task.cancel()
            self._lease_task = None

    # -- peon / message handling -------------------------------------------

    def become_peon(self) -> None:
        self.leading = False
        self.active = False
        self._stop_lease()
        self.lease_expiry = time.monotonic() + float(
            self.config["mon_lease"])

    async def handle(self, from_rank: int, msg: MMonPaxos) -> None:
        op = msg.op
        if op == OP_COLLECT:
            if msg.pn > max(self.last_pn, self.accepted_pn):
                if self.leading:
                    # a rival reign with a higher PN exists: demote NOW
                    # (election-resets-paxos discipline,
                    # the reference's src/mon/Paxos.cc handle_collect
                    # via election) — a stale leader must never keep
                    # proposing under the rival's PN
                    log.warning("mon.%d: higher-pn collect %d from"
                                " mon.%d while leading — demoting",
                                self.rank, msg.pn, from_rank)
                    self.leading = False
                    self.active = False
                    self._stop_lease()
                self.last_pn = msg.pn
                self.accepted_pn = msg.pn
                reply = MMonPaxos(
                    OP_LAST, pn=msg.pn,
                    last_committed=self.last_committed,
                    first_committed=self.first_committed)
                if self.uncommitted is not None:
                    upn, uv, uval = self.uncommitted
                    reply.pn = msg.pn
                    reply.version = uv
                    reply.value = uval
                    # carry the accepting PN so the leader can pick the
                    # newest among competing uncommitted values
                    reply.uncommitted_pn = upn
                self._persist()
                await self.send(from_rank, reply)
            # a stale collect is ignored (its proposer will retry with
            # a higher PN after the next election)
        elif op == OP_LAST:
            if self.leading and msg.pn == self.accepted_pn:
                m = msg
                if m.version and m.uncommitted_pn:
                    m.pn = m.uncommitted_pn
                self._last[from_rank] = m
        elif op == OP_BEGIN:
            if msg.pn >= self.accepted_pn:
                if self.leading and from_rank != self.rank:
                    self.leading = False
                    self.active = False
                    self._stop_lease()
                self.accepted_pn = msg.pn
                self.uncommitted = (msg.pn, msg.version, msg.value)
                self._persist()
                self.lease_expiry = time.monotonic() + float(
                    self.config["mon_lease"])
                await self.send(from_rank, MMonPaxos(
                    OP_ACCEPT, pn=msg.pn, version=msg.version))
        elif op == OP_ACCEPT:
            # version must match the CURRENT proposal: the pn is
            # constant across a reign, so a stale in-flight accept for
            # the previous value would otherwise count toward this
            # one's majority (commit without a true majority)
            if self.leading and msg.pn == self.accepted_pn and \
                    msg.version == getattr(self, "_begin_version", -1):
                self._accepts.add(from_rank)
                if len(self._accepts) >= self.majority and \
                        self._accept_event is not None:
                    self._accept_event.set()
        elif op == OP_COMMIT:
            await self._handle_commit(from_rank, msg)
        elif op == OP_LEASE:
            self.lease_expiry = time.monotonic() + (msg.lease or float(
                self.config["mon_lease"]))
            if msg.last_committed > self.last_committed:
                await self.send(from_rank, MMonPaxos(
                    OP_PULL, last_committed=self.last_committed))
        elif op == OP_PULL:
            # answered by ANYONE holding newer committed history (a
            # catching-up leader pulls from a peon; a gapped peon pulls
            # from the leader) — committed values are immutable, so
            # sharing them is always safe
            if msg.last_committed < self.last_committed:
                await self._share(from_rank, msg.last_committed)
        elif op == OP_FULL:
            if msg.last_committed > self.last_committed:
                v = msg.last_committed
                self.last_committed = v
                self.first_committed = v
                self.uncommitted = None

                def mutate(t):
                    self.install_fn(v, msg.value, t)

                self._persist(mutate)

    async def _handle_commit(self, from_rank: int,
                             msg: MMonPaxos) -> None:
        applied = False
        for v in sorted(msg.values or {}):
            if v == self.last_committed + 1:
                self._commit_value(v, msg.values[v])
                applied = True
        if msg.last_committed > self.last_committed:
            # gap: ask the leader for the missing range
            await self.send(from_rank, MMonPaxos(
                OP_PULL, last_committed=self.last_committed))
        if applied:
            self.lease_expiry = time.monotonic() + float(
                self.config["mon_lease"])

    def shutdown(self) -> None:
        self._stop_lease()
