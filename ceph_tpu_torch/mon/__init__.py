"""Mini-monitor: the cluster control plane, single- or multi-instance
(port of ceph_tpu/mon/__init__.py).

Reference parity: Monitor + OSDMonitor
(the reference's src/mon/Monitor.cc, OSDMonitor.cc).  With one mon the
PaxosService commit discipline survives as: every map mutation is an
epoch bump whose incremental is pushed to all subscribers.  With a
multi-mon monmap, every mutation is a Paxos proposal (mon/paxos.py:
collect/begin/accept/commit/lease + rank-priority elections); only the
leader mutates, peons forward boot/failure/commands to it (MForward
role) and serve map reads from their committed state; a 2-of-3 quorum
survives the loss of any one mon, including the leader mid-write.

Covered OSDMonitor behaviors:
- OSD lifecycle: MOSDBoot marks up + records the address
  (OSDMonitor::prepare_boot); liveness beacons double as boot.
- Failure adjudication (prepare_failure OSDMonitor.cc:2739,
  check_failure :3156-3185): an OSD is marked down when enough distinct
  reporters (mon_osd_min_down_reporters) have current failure reports
  and the oldest report has aged past an ADAPTIVE grace: base
  osd_heartbeat_grace plus a laggy term from the target's own history
  (halflife-decayed laggy_probability/laggy_interval, the :3180-3185
  math) — flapping OSDs earn longer grace.
- Pool/profile commands (OSDMonitor.cc:7373-7712): erasure-code-profile
  set (validated by instantiating the codec), pool create
  replicated/erasure (EC pools get a rule from the codec like
  create_rule), osd down/out/in, status/health.
- Health checks (mon/health_check.h role): OSD_DOWN / PG_DEGRADED
  summary served by `status` and `health` commands.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.common import lockdep
from ceph_tpu_torch.ec.registry import create_erasure_code
from ceph_tpu_torch.mon import paxos as paxos_mod
from ceph_tpu_torch.msg import Connection, Messenger
from ceph_tpu_torch.msg.messages import (
    MAuth,
    MAuthReply,
    MConfig,
    MLog,
    Message,
    MGetMap,
    MMonCommand,
    MMonCommandReply,
    MMonElection,
    MMonForward,
    MMonForwardReply,
    MMonPaxos,
    MOSDBoot,
    MOSDFailure,
    MOSDMapMsg,
    decode_message,
)
from ceph_tpu_torch.osd.osdmap import (
    CEPH_OSD_DESTROYED,
    CEPH_OSD_IN,
    CEPH_OSD_UP,
    Incremental,
    OSDMap,
    TYPE_ERASURE,
    TYPE_REPLICATED,
)

log = logging.getLogger("mon")

DEFAULTS = {
    "mon_osd_min_down_reporters": 2,
    "osd_heartbeat_grace": 20.0,
    "mon_osd_laggy_halflife": 3600.0,
    "mon_osd_laggy_weight": 0.3,
    "mon_osd_adjust_heartbeat_grace": True,
}


def _mon_codec(profile: Dict[str, str]):
    """The codec a profile names, built on the host: the mon validates
    profiles and asks for the pool's rule and chunk count, and never
    encodes.  The profile committed to the map stays as the client sent
    it."""
    return create_erasure_code({**profile, "device": "cpu"})


class FailureReport:
    __slots__ = ("first_reported", "last_reported", "failed_for")

    def __init__(self, now: float, failed_for: float):
        self.first_reported = now
        self.last_reported = now
        self.failed_for = failed_for


class MonDaemon:
    """One monitor instance (rank r of a monmap of n; n=1 keeps the
    single-authoritative shape with zero consensus traffic)."""

    def __init__(self, num_osds: int, osds_per_host: int = 2,
                 config: Optional[Dict[str, Any]] = None,
                 store=None, rank: int = 0,
                 mon_addrs: Optional[List[str]] = None):
        self.config = dict(DEFAULTS)
        self.config.update(config or {})
        from ceph_tpu_torch.common.auth import parse_secret

        self.rank = rank
        self.mon_addrs: List[str] = list(mon_addrs or [])
        self.msgr = Messenger(
            f"mon.{rank}", secret=parse_secret(
                self.config.get("auth_secret")))
        self.msgr.secure = bool(self.config.get("auth_secure"))
        self.msgr.local_fastpath = bool(
            self.config.get("ms_local_fastpath", True))
        self.msgr.dispatcher = self._dispatch
        self.msgr.inject_socket_failures = int(
            self.config.get("ms_inject_socket_failures", 0) or 0)
        self.msgr.inject_internal_delays = float(
            self.config.get("ms_inject_internal_delays", 0) or 0)
        self.msgr.apply_compress_config(self.config)
        # durable state (the MonitorDBStore role,
        # the reference's src/mon/MonitorDBStore.h): every commit writes
        # the incremental, the resulting full map, and the auxiliary
        # adjudication state into the KeyValueDB in one transaction, so
        # a mon restart is a reload, not cluster amnesia
        self.store = store
        self._subscribers: List[Connection] = []
        self._inc_log: Dict[int, bytes] = {}
        self._inc_log_max = 1000
        # failure bookkeeping (OSDMonitor::failure_info_t)
        self._failure_reports: Dict[int, Dict[int, FailureReport]] = {}
        # laggy history for adaptive grace (osd_xinfo_t)
        self._laggy_probability: Dict[int, float] = {}
        self._laggy_interval: Dict[int, float] = {}
        self._down_at: Dict[int, float] = {}
        self._up_from: Dict[int, int] = {}  # boot epoch per osd
        self._check_task: Optional[asyncio.Task] = None
        self._lease_watch_task: Optional[asyncio.Task] = None
        # one map mutation in flight at a time (the PaxosService
        # single-proposal round): handlers read the map, build an
        # incremental, and propose under this lock
        self._mutation_lock = lockdep.Lock("mon.mutation")
        # centralized config (ConfigMonitor role): {section: {k: v}},
        # quorum-replicated through paxos, pushed to subscribers
        self._config_kv: Dict[str, Dict[str, str]] = {}
        self._config_version = 0
        # cluster log ring (LogMonitor role): one place to read a
        # multi-daemon incident instead of grepping N process logs
        from collections import deque

        self._cluster_log: "deque" = deque(maxlen=2048)
        # crash reports (the mgr crash module role, kept on the mon so
        # reports are quorum-replicated and survive any single daemon):
        # crash_id -> report dict (+ "archived" flag)
        self._crash: Dict[str, Dict[str, Any]] = {}
        # forwarded-command reply routing (MForward role)
        self._fwd_tid = 0
        self._fwd_pending: Dict[int, Tuple[Connection, int]] = {}
        self.paxos: Optional[paxos_mod.Paxos] = None
        self.elector: Optional[paxos_mod.Elector] = None
        if store is not None and self._load_store():
            return
        self.osdmap = OSDMap.build_simple(num_osds,
                                          osds_per_host=osds_per_host)
        # all OSDs start down (exist + in); boot marks them up
        for osd in range(num_osds):
            self.osdmap.osd_state[osd] &= ~CEPH_OSD_UP
        # from here the map mutates only via apply_incremental
        self.osdmap.enable_placement_cache()
        if store is not None:
            self._persist(None)

    def _load_store(self) -> bool:
        raw = self.store.get("mon", b"osdmap_full")
        if raw is None:
            return False
        self.osdmap = OSDMap.decode(raw)
        self.osdmap.enable_placement_cache()
        # load at most the newest _inc_log_max incrementals (the store
        # is trimmed on commit, but never trust unbounded history)
        loaded = [(int.from_bytes(key, "big"), val)
                  for key, val in self.store.get_iterator("osdmap")]
        for epoch, val in loaded[-self._inc_log_max:]:
            self._inc_log[epoch] = val
        cfg = self.store.get("mon", b"config")
        if cfg:
            doc = json.loads(cfg.decode())
            self._config_kv = doc.get("kv", {})
            self._config_version = int(doc.get("version", 0))
        crash = self.store.get("mon", b"crash")
        if crash:
            self._crash = json.loads(crash.decode())
        aux = self.store.get("mon", b"aux")
        if aux:
            doc = json.loads(aux.decode())
            self._laggy_probability = {
                int(k): v for k, v in doc["laggy_probability"].items()}
            self._laggy_interval = {
                int(k): v for k, v in doc["laggy_interval"].items()}
            self._up_from = {int(k): v
                             for k, v in doc["up_from"].items()}
        log.info("mon: reloaded epoch %d from store", self.osdmap.epoch)
        return True

    def _stage_mon(self, t, inc_raw: Optional[bytes]) -> None:
        """Stage the mon's map state into a store transaction."""
        if inc_raw is not None:
            t.set("osdmap",
                  self.osdmap.epoch.to_bytes(8, "big"), inc_raw)
            # keep the durable inc log bounded like the in-memory one
            floor = max(0, self.osdmap.epoch - self._inc_log_max)
            t.rm_range_keys("osdmap", (0).to_bytes(8, "big"),
                            floor.to_bytes(8, "big"))
        t.set("mon", b"osdmap_full", self.osdmap.encode())
        t.set("mon", b"config", json.dumps({
            "kv": self._config_kv,
            "version": self._config_version,
        }).encode())
        t.set("mon", b"crash", json.dumps(self._crash).encode())
        t.set("mon", b"aux", json.dumps({
            "laggy_probability": self._laggy_probability,
            "laggy_interval": self._laggy_interval,
            "up_from": self._up_from,
        }).encode())

    def _persist(self, inc_raw: Optional[bytes]) -> None:
        """One durable transaction per commit (Paxos commit point)."""
        t = self.store.get_transaction()
        self._stage_mon(t, inc_raw)
        self.store.submit_transaction_sync(t)

    # -- lifecycle ---------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        # native prewarm rides msgr.bind (Messenger._prewarm_native)
        addr = await self.msgr.bind(host, port)
        self._check_task = asyncio.get_running_loop().create_task(
            self._check_failures_loop())
        if not self.mon_addrs and self.rank == 0:
            # standalone mon: a 1-entry monmap — paxos runs the same
            # commit pipeline with zero consensus traffic
            self.mon_addrs = [addr]
        if self.mon_addrs:
            await self.start_consensus()
        return addr

    async def set_peers(self, mon_addrs: List[str]) -> None:
        """Install the monmap (addresses by rank) once every mon is
        bound, then start elections; for dynamically-bound test
        clusters this replaces passing mon_addrs to the constructor."""
        self.mon_addrs = list(mon_addrs)
        await self.start_consensus()

    async def start_consensus(self) -> None:
        n = len(self.mon_addrs)
        self.paxos = paxos_mod.Paxos(
            self.rank, n, self._send_rank, self.store,
            self._paxos_apply, self._paxos_snapshot,
            self._paxos_install, self.config)
        self.paxos.on_leader_dead = self._on_quorum_lost
        self.elector = paxos_mod.Elector(
            self.rank, n, self._send_rank, self._on_win,
            self._on_lose, self.config)
        if self.store is not None:
            raw = self.store.get("mon", b"election_epoch")
            if raw:
                self.elector.epoch = int(raw)
        await self.elector.start()
        if n > 1:
            self._lease_watch_task = \
                asyncio.get_running_loop().create_task(
                    self._lease_watch())

    async def shutdown(self) -> None:
        if self._check_task is not None:
            self._check_task.cancel()
        if self._lease_watch_task is not None:
            self._lease_watch_task.cancel()
        if self.elector is not None:
            self.elector.shutdown()
        if self.paxos is not None:
            self.paxos.shutdown()
        await self.msgr.shutdown()

    @property
    def addr(self) -> str:
        return self.msgr.addr

    def is_leader(self) -> bool:
        return self.elector is None or self.elector.leader == self.rank

    # -- consensus plumbing ------------------------------------------------

    async def _send_rank(self, peer: int, msg: Message) -> None:
        if hasattr(msg, "from_rank"):
            msg.from_rank = self.rank
        try:
            await self.msgr.send_to(self.mon_addrs[peer], msg)
        except (ConnectionError, OSError):
            pass  # elections/leases tolerate drops; paxos retries

    def _save_election_epoch(self) -> None:
        if self.store is not None and self.elector is not None:
            t = self.store.get_transaction()
            t.set("mon", b"election_epoch",
                  str(self.elector.epoch).encode())
            self.store.submit_transaction_sync(t)

    async def _on_win(self, epoch: int, quorum) -> None:
        self._save_election_epoch()
        self._failure_reports.clear()  # re-reported by live OSDs
        await self.paxos.leader_init(set(quorum))

    async def _on_lose(self, epoch: int, leader: int) -> None:
        self._save_election_epoch()
        self.paxos.become_peon()

    async def _on_quorum_lost(self) -> None:
        await self.elector.call_election()

    async def _lease_watch(self) -> None:
        """Peon-side leader failure detection: an expired lease (no
        leader traffic) calls a new election (Paxos lease timeout)."""
        while True:
            await asyncio.sleep(0.3)
            if self.elector is None or self.elector.electing:
                continue
            if self.is_leader():
                continue
            if not self.paxos.lease_valid():
                log.warning("mon.%d: lease expired — leader %s silent,"
                            " calling election", self.rank,
                            self.elector.leader)
                await self.elector.call_election()

    def _paxos_apply(self, v: int, value: bytes, t) -> None:
        """Committed-value application (every mon, leader and peon).
        Values are tagged: b"M"+incremental (map mutation) or
        b"C"+json (centralized config mutation) — the PaxosService
        multiplexing role collapsed onto one tag byte; untagged values
        are legacy map incrementals."""
        if value[:1] == b"R":
            doc = json.loads(value[1:].decode())
            op = doc.get("op")
            if op == "post":
                rep = doc["report"]
                self._crash.setdefault(rep["crash_id"], rep)
            elif op == "archive":
                rep = self._crash.get(doc["crash_id"])
                if rep is not None:
                    rep["archived"] = True
            elif op == "archive_all":
                for rep in self._crash.values():
                    rep["archived"] = True
            elif op == "rm":
                self._crash.pop(doc["crash_id"], None)
            self._stage_mon(t, None)
            return
        if value[:1] == b"C":
            doc = json.loads(value[1:].decode())
            section, name = doc["section"], doc["name"]
            if doc.get("value") is None:
                self._config_kv.get(section, {}).pop(name, None)
                if not self._config_kv.get(section, True):
                    self._config_kv.pop(section, None)
            else:
                sect = self._config_kv.setdefault(section, {})
                sect[name] = str(doc["value"])
            self._config_version = v
            self._stage_mon(t, None)
            self._push_config()
            return
        if value[:1] == b"M":
            value = value[1:]
        inc = Incremental.decode(value)
        self.osdmap.apply_incremental(inc)
        self._inc_log[inc.epoch] = value
        while len(self._inc_log) > self._inc_log_max:
            del self._inc_log[min(self._inc_log)]
        self._stage_mon(t, value)
        self._publish()

    def _paxos_snapshot(self) -> bytes:
        """OP_FULL payload: EVERY replicated state — the map AND the
        centralized config (a snapshot that missed config would
        silently re-persist a stale kv on the caught-up mon)."""
        m = self.osdmap.encode()
        cfg = json.dumps({"kv": self._config_kv,
                          "version": self._config_version}).encode()
        crash = json.dumps(self._crash).encode()
        return (len(m).to_bytes(8, "big") + m
                + len(cfg).to_bytes(8, "big") + cfg
                + len(crash).to_bytes(8, "big") + crash)

    def _paxos_install(self, v: int, blob: bytes, t) -> None:
        """Full-state catch-up past a trimmed log (OP_FULL)."""
        mlen = int.from_bytes(blob[:8], "big")
        self.osdmap = OSDMap.decode(blob[8:8 + mlen])
        self.osdmap.enable_placement_cache()
        rest = blob[8 + mlen:]
        if rest:
            clen = int.from_bytes(rest[:8], "big")
            doc = json.loads(rest[8:8 + clen].decode())
            self._config_kv = doc.get("kv", {})
            self._config_version = int(doc.get("version", 0))
            self._push_config()
            rest = rest[8 + clen:]
        if rest:  # crash table (older snapshots simply lack it)
            rlen = int.from_bytes(rest[:8], "big")
            self._crash = json.loads(rest[8:8 + rlen].decode())
        self._inc_log.clear()
        self._stage_mon(t, None)
        self._publish()
        log.info("mon.%d: installed full snapshot at epoch %d",
                 self.rank, self.osdmap.epoch)

    # -- map mutation ------------------------------------------------------

    async def _commit(self, inc: Incremental) -> bool:
        """Replicate one incremental through Paxos (leader only; the
        n=1 fast path commits inline with zero network traffic).
        Caller holds _mutation_lock.  Returns False when quorum could
        not commit — the caller surfaces EAGAIN and the client retries."""
        if self.paxos is None:
            # pre-consensus (constructor persistence only)
            raw = inc.encode()
            self.osdmap.apply_incremental(inc)
            self._inc_log[inc.epoch] = raw
            if self.store is not None:
                self._persist(raw)
            self._publish()
            return True
        # re-stamp under the mutation lock: the handler built the inc
        # against the map as it read it; the epoch must be the commit
        # point's successor
        inc.epoch = self.osdmap.epoch + 1
        return await self.paxos.propose(b"M" + inc.encode())

    def _push_config(self) -> None:
        msg = MConfig(self._config_version, self._config_kv)
        for conn in list(self._subscribers):
            if not conn.closed:
                self.msgr._spawn(self._send_quiet(conn, msg))

    def clog(self, level: str, who: str, message: str) -> None:
        """Append one cluster-log entry (LogMonitor ingest)."""
        self._cluster_log.append({
            "stamp": time.time(), "level": level, "who": who,
            "message": message})

    def _publish(self) -> None:
        """Push the new epoch to subscribers as the committing
        incremental alone — every subscriber (daemon or client) applies
        epochs in order and pulls missing ranges with MGetMap on a gap,
        so re-encoding and shipping the full map per commit would be
        O(map x subscribers) of pure waste."""
        epoch = self.osdmap.epoch
        inc = self._inc_log.get(epoch)
        if inc is not None:
            msg = MOSDMapMsg(epoch, incrementals=[inc])
        else:  # no incremental for this epoch: fall back to a full map
            msg = MOSDMapMsg(epoch, full_map=self.osdmap.encode())
        for conn in list(self._subscribers):
            if conn.closed:
                self._subscribers.remove(conn)
                continue
            self.msgr._spawn(self._send_quiet(conn, msg))

    async def _send_quiet(self, conn: Connection, msg: Message) -> None:
        try:
            await conn.send(msg)
        except (ConnectionError, OSError):
            pass

    # -- dispatch ----------------------------------------------------------

    async def _dispatch(self, conn: Connection, msg: Message) -> None:
        if isinstance(msg, MOSDBoot):
            if self.is_leader():
                await self._handle_boot(msg)
            else:
                await self._forward(msg)
        elif isinstance(msg, MGetMap):
            # served from committed state on ANY mon: epochs are
            # monotonic and consumers pull ranges, so a peon answering
            # slightly behind the leader is safe by construction
            if msg.subscribe and conn not in self._subscribers:
                self._subscribers.append(conn)
                # unconditionally — an EMPTY snapshot is load-bearing:
                # a resubscriber whose overrides were removed while it
                # was away must revert them
                await self._send_quiet(conn, MConfig(
                    self._config_version, self._config_kv))
            cur = self.osdmap.epoch
            since = msg.since_epoch
            if since and all(e in self._inc_log
                             for e in range(since + 1, cur + 1)):
                await conn.send(MOSDMapMsg(
                    cur, incrementals=[self._inc_log[e]
                                       for e in range(since + 1,
                                                      cur + 1)]))
            else:
                await conn.send(MOSDMapMsg(
                    cur, full_map=self.osdmap.encode(),
                    gap_unfillable=bool(since)))
        elif isinstance(msg, MOSDFailure):
            if self.is_leader():
                await self._handle_failure(msg)
            else:
                await self._forward(msg)
        elif isinstance(msg, MMonCommand):
            if self.is_leader():
                rc, out = await self.handle_command(msg.cmd)
                await conn.send(MMonCommandReply(msg.tid, rc, out))
            else:
                await self._forward(msg, conn, msg.tid)
        elif isinstance(msg, MLog):
            if self.is_leader():
                for e in msg.entries:
                    self._cluster_log.append(dict(e))
            else:
                await self._forward(msg)
        elif isinstance(msg, MAuth):
            await self._handle_auth(conn, msg)
        elif isinstance(msg, MMonElection):
            if self.elector is not None:
                await self.elector.handle(msg)
        elif isinstance(msg, MMonPaxos):
            if self.paxos is not None and msg.from_rank >= 0:
                await self.paxos.handle(msg.from_rank, msg)
        elif isinstance(msg, MMonForward):
            await self._handle_forward(conn, msg)
        elif isinstance(msg, MMonForwardReply):
            pending = self._fwd_pending.pop(msg.fwd_tid, None)
            if pending is not None:
                client_conn, tid = pending
                await self._send_quiet(client_conn, MMonCommandReply(
                    tid, msg.rc, msg.out))

    async def _handle_auth(self, conn: Connection, msg: MAuth) -> None:
        """Mon-as-KDC ticket service (CephxServiceHandler role): stage
        1 hands out a server challenge, stage 2 validates the client's
        proof of key possession and grants a signed expiring ticket.
        Served by ANY mon — the keyring is cluster-wide state."""
        from ceph_tpu_torch.common import auth as auth_mod

        keyring = self.msgr.secret
        if keyring is None:
            await self._send_quiet(conn, MAuthReply(msg.tid, -95))
            return
        if msg.stage == 1:
            challenge = auth_mod.new_nonce()
            conn._auth_challenge = challenge
            await self._send_quiet(conn, MAuthReply(
                msg.tid, 0, server_challenge=challenge))
            return
        challenge = getattr(conn, "_auth_challenge", b"")
        key = keyring.get(msg.kid)
        ok = (bool(challenge) and key is not None
              and auth_mod.check_proof(key, msg.entity,
                                       bytes(msg.client_challenge),
                                       challenge, bytes(msg.proof)))
        if not ok:
            log.warning("mon.%d: auth proof failure for %r", self.rank,
                        msg.entity)
            await self._send_quiet(conn, MAuthReply(msg.tid, -13))
            return
        conn._auth_challenge = b""  # single use
        ticket = auth_mod.make_ticket(keyring, msg.entity)
        await self._send_quiet(conn, MAuthReply(msg.tid, 0,
                                                ticket=ticket))

    async def _forward(self, msg: Message,
                       conn: Optional[Connection] = None,
                       tid: Optional[int] = None) -> None:
        """Relay a client message to the leader (MForward role).
        Commands get reply routing via fwd_tid; boot/failure reports
        are fire-and-forget (their effect shows up in the next map)."""
        leader = self.elector.leader if self.elector else None
        if leader is None or leader == self.rank:
            if conn is not None and tid is not None:
                await self._send_quiet(conn, MMonCommandReply(
                    tid, -11, {"error": "no quorum leader (election"
                                        " in progress); retry"}))
            return
        fwd_tid = 0
        if conn is not None and tid is not None:
            self._fwd_tid += 1
            fwd_tid = self._fwd_tid
            self._fwd_pending[fwd_tid] = (conn, tid)
            while len(self._fwd_pending) > 1024:
                self._fwd_pending.pop(next(iter(self._fwd_pending)))
        try:
            await self.msgr.send_to(
                self.mon_addrs[leader],
                MMonForward(fwd_tid, msg.TAG, msg.encode()))
        except (ConnectionError, OSError):
            self._fwd_pending.pop(fwd_tid, None)

    async def _handle_forward(self, conn: Connection,
                              msg: MMonForward) -> None:
        """Leader side of the relay."""
        try:
            inner = decode_message(msg.inner_tag, msg.inner_payload)
        except Exception:
            log.exception("mon.%d: bad forwarded message", self.rank)
            return
        if not self.is_leader():
            return  # leadership moved mid-flight; sender will refresh
        if isinstance(inner, MMonCommand):
            rc, out = await self.handle_command(inner.cmd)
            if msg.fwd_tid:
                await self._send_quiet(conn, MMonForwardReply(
                    msg.fwd_tid, rc, out))
        elif isinstance(inner, MOSDBoot):
            await self._handle_boot(inner)
        elif isinstance(inner, MOSDFailure):
            await self._handle_failure(inner)
        elif isinstance(inner, MLog):
            for e in inner.entries:
                self._cluster_log.append(dict(e))

    # -- boot / failure ----------------------------------------------------

    async def _handle_boot(self, msg: MOSDBoot) -> None:
        osd = msg.osd
        if not (0 <= osd < self.osdmap.max_osd):
            return
        now = time.monotonic()
        # returning after a mon-ordered down: update laggy history
        # (OSDMonitor laggy tracking feeding the adaptive grace)
        down_at = self._down_at.pop(osd, None)
        if down_at is not None:
            halflife = self.config["mon_osd_laggy_halflife"]
            weight = self.config["mon_osd_laggy_weight"]
            interval = now - down_at
            decay = 0.5 ** (interval / halflife)
            self._laggy_probability[osd] = min(
                1.0, self._laggy_probability.get(osd, 0.0) * decay
                + weight)
            self._laggy_interval[osd] = (
                self._laggy_interval.get(osd, 0.0) * decay
                + interval * weight)
        self._failure_reports.pop(osd, None)
        async with self._mutation_lock:
            if self.osdmap.is_up(osd) and \
                    self.osdmap.osd_addrs.get(osd) == msg.addr:
                return
            inc = Incremental(epoch=self.osdmap.epoch + 1)
            inc.new_up_osds[osd] = msg.addr
            if not self.osdmap.is_in(osd):
                inc.new_weight[osd] = CEPH_OSD_IN
            if self.osdmap.is_destroyed(osd):
                # a lost OSD that comes back rejoins with normal probe
                # semantics (its declared-gone window is over)
                inc.new_state[osd] = CEPH_OSD_DESTROYED  # XOR: clear
            if not await self._commit(inc):
                return  # no quorum; the OSD's boot loop retries
        self._up_from[osd] = self.osdmap.epoch
        log.info("mon.%d: osd.%d booted at %s (epoch %d)", self.rank,
                 osd, msg.addr, self.osdmap.epoch)

    async def _handle_failure(self, msg: MOSDFailure) -> None:
        target = msg.target_osd
        if not self.osdmap.is_up(target):
            return
        # a report from before the target's current boot is about a
        # previous incarnation (OSDMonitor::prepare_failure epoch check)
        if msg.epoch < self._up_from.get(target, 0):
            return
        reports = self._failure_reports.setdefault(target, {})
        now = time.monotonic()
        report = reports.get(msg.reporter)
        if report is None:
            reports[msg.reporter] = FailureReport(now, msg.failed_for)
        else:
            report.last_reported = now
            report.failed_for = msg.failed_for
        await self._check_failure(target, now)

    def _grace(self, target: int) -> float:
        """Adaptive grace (OSDMonitor.cc:3180-3185): base + decayed
        laggy_probability * laggy_interval."""
        grace = float(self.config["osd_heartbeat_grace"])
        if self.config["mon_osd_adjust_heartbeat_grace"]:
            prob = self._laggy_probability.get(target, 0.0)
            interval = self._laggy_interval.get(target, 0.0)
            if prob > 0.05 and interval > 0:
                grace += prob * interval
        return grace

    async def _check_failure(self, target: int, now: float) -> None:
        reports = self._failure_reports.get(target, {})
        if len(reports) < int(self.config["mon_osd_min_down_reporters"]):
            return
        oldest = min(r.first_reported for r in reports.values())
        max_failed = max(r.failed_for for r in reports.values())
        if max(now - oldest, max_failed) < self._grace(target):
            return
        log.info("mon.%d: marking osd.%d down (%d reporters, grace"
                 " %.1fs)", self.rank, target, len(reports),
                 self._grace(target))
        self.clog("WRN", f"mon.{self.rank}",
                  f"osd.{target} marked down ({len(reports)}"
                  " reporters)")
        self._failure_reports.pop(target, None)
        self._down_at[target] = now
        async with self._mutation_lock:
            if not self.osdmap.is_up(target):
                return
            inc = Incremental(epoch=self.osdmap.epoch + 1)
            inc.new_state[target] = CEPH_OSD_UP  # XOR: up -> down
            await self._commit(inc)

    async def _check_failures_loop(self) -> None:
        while True:
            await asyncio.sleep(0.25)
            if not self.is_leader():
                # failure adjudication is the leader's job; a peon's
                # stale report set resets on the next election win
                continue
            now = time.monotonic()
            for target in list(self._failure_reports):
                await self._check_failure(target, now)

    # -- commands (MonCommands.h / OSDMonitor command surface) -------------

    async def handle_command(self, cmd: Dict[str, Any]
                             ) -> Tuple[int, Dict[str, Any]]:
        prefix = cmd.get("prefix", "")
        try:
            handler = {
                "osd erasure-code-profile set": self._cmd_profile_set,
                "osd erasure-code-profile get": self._cmd_profile_get,
                "osd pool create": self._cmd_pool_create,
                "osd pool set": self._cmd_pool_set,
                "osd pool mksnap": self._cmd_snap_create,
                "osd pool rmsnap": self._cmd_snap_remove,
                "osd down": self._cmd_osd_down,
                "osd out": self._cmd_osd_out,
                "osd in": self._cmd_osd_in,
                "osd lost": self._cmd_osd_lost,
                "osd pg-upmap-items": self._cmd_pg_upmap_items,
                "osd rm-pg-upmap-items": self._cmd_rm_pg_upmap_items,
                "status": self._cmd_status,
                "health": self._cmd_health,
                "mon stat": self._cmd_mon_stat,
                "config set": self._cmd_config_set,
                "config rm": self._cmd_config_rm,
                "config get": self._cmd_config_get,
                "log last": self._cmd_log_last,
                "crash post": self._cmd_crash_post,
                "crash ls": self._cmd_crash_ls,
                "crash ls-new": self._cmd_crash_ls,
                "crash info": self._cmd_crash_info,
                "crash archive": self._cmd_crash_archive,
                "crash archive-all": self._cmd_crash_archive,
                "crash rm": self._cmd_crash_rm,
            }.get(prefix)
            if handler is None:
                return -22, {"error": f"unknown command {prefix!r}"}
            return await handler(cmd)
        except Exception as e:  # command errors must not kill the mon
            log.exception("mon: command %r failed", prefix)
            return -22, {"error": str(e)}

    async def _cmd_profile_set(self, cmd) -> Tuple[int, Dict[str, Any]]:
        name = cmd["name"]
        profile = dict(cmd["profile"])
        _mon_codec(profile)  # validate before committing
        async with self._mutation_lock:
            inc = Incremental(epoch=self.osdmap.epoch + 1)
            inc.new_erasure_code_profiles[name] = profile
            if not await self._commit(inc):
                return -11, {"error": "no quorum; retry"}
        return 0, {}

    async def _cmd_profile_get(self, cmd) -> Tuple[int, Dict[str, Any]]:
        profile = self.osdmap.erasure_code_profiles.get(cmd["name"])
        if profile is None:
            return -2, {"error": "no such profile"}
        return 0, {"profile": profile}

    async def _cmd_pool_create(self, cmd) -> Tuple[int, Dict[str, Any]]:
        name = cmd["name"]
        if self.osdmap.lookup_pool(name) >= 0:
            return 0, {"pool_id": self.osdmap.lookup_pool(name)}
        pg_num = int(cmd.get("pg_num", 32))
        pool_type = cmd.get("pool_type", "replicated")
        # the WHOLE build runs under the mutation lock: the scratch map
        # allocates the next pool id, and two concurrent creates off
        # the same map would otherwise mint the same id (one pool
        # silently clobbering the other)
        async with self._mutation_lock:
            return await self._pool_create_locked(
                cmd, name, pg_num, pool_type)

    async def _pool_create_locked(self, cmd, name, pg_num, pool_type):
        # stage on a SCRATCH map, then commit the result through an
        # Incremental like every other mutation: the change replays via
        # apply_incremental on every daemon and lands in the inc log
        scratch = OSDMap.decode(self.osdmap.encode())
        if pool_type == "erasure":
            profile_name = cmd.get("erasure_code_profile", "default")
            profile = self.osdmap.erasure_code_profiles.get(profile_name)
            if profile is None:
                return -2, {"error": f"no profile {profile_name!r}"}
            codec = _mon_codec(profile)
            ruleno = codec.create_rule(f"{name}_rule", scratch.crush)
            pool = scratch.create_pool(
                name, type_=TYPE_ERASURE, size=codec.get_chunk_count(),
                pg_num=pg_num, crush_rule=ruleno,
                erasure_code_profile=profile_name)
        else:
            size = int(cmd.get("size", 3))
            pool = scratch.create_pool(
                name, type_=TYPE_REPLICATED, size=size, pg_num=pg_num)
        inc = Incremental(epoch=self.osdmap.epoch + 1)
        inc.new_pools[pool.id] = pool
        if pool_type == "erasure":
            inc.new_crush = scratch.crush  # carries the new EC rule
        if not await self._commit(inc):
            return -11, {"error": "no quorum; retry"}
        return 0, {"pool_id": pool.id}

    async def _cmd_pool_set(self, cmd) -> Tuple[int, Dict[str, Any]]:
        """`osd pool set <name> pg_num <n>` — PG splitting
        (OSDMonitor's pg_num ratchet).  Growth only: live PG merging
        is out of scope (documented deviation; the reference gained
        merge in nautilus)."""
        var = cmd.get("var")
        if var != "pg_num":
            return -22, {"error": f"unsupported pool var {var!r}"}
        try:
            val = int(cmd["val"])
        except (KeyError, ValueError):
            return -22, {"error": "pg_num must be an integer"}
        async with self._mutation_lock:
            pool, inc = self._pool_snap_inc(cmd["name"])
            if pool is None:
                return -2, {"error": "no such pool"}
            if val < pool.pg_num:
                return -22, {"error": "pg_num can only grow (PG merge"
                                      " unsupported)"}
            if val == pool.pg_num:
                return 0, {"pg_num": val}
            pool.pg_num = val
            pool.pgp_num = val
            if not await self._commit(inc):
                return -11, {"error": "no quorum; retry"}
        log.info("mon.%d: pool %s pg_num -> %d (epoch %d)", self.rank,
                 cmd["name"], val, self.osdmap.epoch)
        return 0, {"pg_num": val, "epoch": self.osdmap.epoch}

    def _pool_snap_inc(self, name: str):
        """Scratch-copy a pool for a snap mutation; returns
        (pool_copy, incremental) or (None, None) when no such pool."""
        pool_id = self.osdmap.lookup_pool(name)
        if pool_id < 0:
            return None, None
        from ceph_tpu_torch.common.encoding import Decoder, Encoder

        enc = Encoder()
        self.osdmap.pools[pool_id].encode(enc)
        from ceph_tpu_torch.osd.osdmap import PgPool

        pool = PgPool.decode(Decoder(enc.to_bytes()))
        inc = Incremental(epoch=self.osdmap.epoch + 1)
        inc.new_pools[pool.id] = pool
        return pool, inc

    async def _cmd_snap_create(self, cmd) -> Tuple[int, Dict[str, Any]]:
        """Self-managed snapshot id allocation (the
        OSDMonitor selfmanaged_snap_create role): bump the pool's
        snap_seq through an Incremental and hand the id back."""
        async with self._mutation_lock:
            pool, inc = self._pool_snap_inc(cmd["name"])
            if pool is None:
                return -2, {"error": "no such pool"}
            pool.snap_seq += 1
            if not await self._commit(inc):
                return -11, {"error": "no quorum; retry"}
        return 0, {"snap_id": pool.snap_seq}

    async def _cmd_snap_remove(self, cmd) -> Tuple[int, Dict[str, Any]]:
        """Retire a snap id: lands in pool.removed_snaps; primaries trim
        clones when they observe the new map (snap trim role)."""
        async with self._mutation_lock:
            pool, inc = self._pool_snap_inc(cmd["name"])
            if pool is None:
                return -2, {"error": "no such pool"}
            snap_id = int(cmd["snap_id"])
            if snap_id <= 0 or snap_id > pool.snap_seq:
                return -22, {"error": f"bad snap id {snap_id}"}
            if snap_id not in pool.removed_snaps:
                pool.removed_snaps.append(snap_id)
                pool.removed_snaps.sort()
            if not await self._commit(inc):
                return -11, {"error": "no quorum; retry"}
        return 0, {}

    async def _cmd_osd_down(self, cmd) -> Tuple[int, Dict[str, Any]]:
        osd = int(cmd["osd"])
        async with self._mutation_lock:
            if self.osdmap.is_up(osd):
                inc = Incremental(epoch=self.osdmap.epoch + 1)
                inc.new_state[osd] = CEPH_OSD_UP
                if not await self._commit(inc):
                    return -11, {"error": "no quorum; retry"}
        return 0, {}

    async def _cmd_osd_out(self, cmd) -> Tuple[int, Dict[str, Any]]:
        osd = int(cmd["osd"])
        async with self._mutation_lock:
            if self.osdmap.is_in(osd):
                inc = Incremental(epoch=self.osdmap.epoch + 1)
                inc.new_weight[osd] = 0
                if not await self._commit(inc):
                    return -11, {"error": "no quorum; retry"}
        return 0, {}

    async def _cmd_osd_in(self, cmd) -> Tuple[int, Dict[str, Any]]:
        osd = int(cmd["osd"])
        async with self._mutation_lock:
            if not self.osdmap.is_in(osd):
                inc = Incremental(epoch=self.osdmap.epoch + 1)
                inc.new_weight[osd] = CEPH_OSD_IN
                if not await self._commit(inc):
                    return -11, {"error": "no quorum; retry"}
        return 0, {}

    async def _cmd_osd_lost(self, cmd) -> Tuple[int, Dict[str, Any]]:
        """`osd lost <id> --yes-i-really-mean-it`: declare a dead
        OSD's data permanently gone (OSDMonitor.cc `osd lost`).  Marks
        DESTROYED so recovery probes count it as definitively absent —
        the escape hatch that lets unfound-object adjudication finish
        when a source will never return."""
        osd = int(cmd["osd"])
        if not cmd.get("yes_i_really_mean_it"):
            return -1, {"error": "this makes data loss permanent; pass"
                                 " yes_i_really_mean_it"}
        if not self.osdmap.exists(osd):
            return -2, {"error": f"osd.{osd} does not exist"}
        if self.osdmap.is_up(osd):
            return -16, {"error": f"osd.{osd} is up — only a down osd"
                                  " can be declared lost"}
        async with self._mutation_lock:
            if not self.osdmap.is_destroyed(osd):
                inc = Incremental(epoch=self.osdmap.epoch + 1)
                inc.new_state[osd] = CEPH_OSD_DESTROYED  # XOR: set
                if not await self._commit(inc):
                    return -11, {"error": "no quorum; retry"}
        return 0, {"epoch": self.osdmap.epoch}

    async def _cmd_pg_upmap_items(self, cmd) -> Tuple[int, Dict[str, Any]]:
        """`osd pg-upmap-items <pool.ps> <from> <to> [...]` — the
        balancer's remap primitive (OSDMonitor.cc `osd pg-upmap-items`
        command).  Validates pairs against the live map before
        committing (maybe_remove_pg_upmaps discipline)."""
        from ceph_tpu_torch.osd.osdmap import PgId

        pool_id, ps = cmd["pgid"].split(".")
        pg = PgId(int(pool_id), int(ps))
        if pg.pool not in self.osdmap.pools or \
                pg.ps >= self.osdmap.pools[pg.pool].pg_num:
            return -2, {"error": f"pg {cmd['pgid']} does not exist"}
        pairs = [(int(a), int(b)) for a, b in cmd["mappings"]]
        if not pairs:
            return -22, {"error": "empty mappings (use"
                                  " rm-pg-upmap-items to clear)"}
        pool = self.osdmap.pools[pg.pool]
        raw, _pps = self.osdmap._pg_to_raw_osds(pool, pg)
        for src, dst in pairs:
            if not (self.osdmap.exists(dst) and self.osdmap.is_in(dst)):
                return -22, {"error": f"target osd.{dst} not in"}
            if src == dst:
                return -22, {"error": "identity mapping"}
            if src not in raw:
                # a src outside the CRUSH raw mapping would commit as
                # permanent dead state _apply_upmap never matches
                # (maybe_remove_pg_upmaps rejection)
                return -22, {"error": f"osd.{src} is not in the raw"
                                      f" mapping of {cmd['pgid']}"}
        inc = Incremental(epoch=self.osdmap.epoch + 1)
        inc.new_pg_upmap_items[pg] = pairs
        async with self._mutation_lock:
            if not await self._commit(inc):
                return -11, {"error": "no quorum; retry"}
        return 0, {"epoch": self.osdmap.epoch}

    async def _cmd_rm_pg_upmap_items(self, cmd) -> Tuple[int, Dict[str, Any]]:
        from ceph_tpu_torch.osd.osdmap import PgId

        pool_id, ps = cmd["pgid"].split(".")
        pg = PgId(int(pool_id), int(ps))
        if pg not in self.osdmap.pg_upmap_items:
            return 0, {}
        inc = Incremental(epoch=self.osdmap.epoch + 1)
        inc.old_pg_upmap_items.append(pg)
        async with self._mutation_lock:
            if not await self._commit(inc):
                return -11, {"error": "no quorum; retry"}
        return 0, {"epoch": self.osdmap.epoch}

    async def _cmd_config_set(self, cmd) -> Tuple[int, Dict[str, Any]]:
        """`ceph config set <who> <name> <value>` (ConfigMonitor):
        who = global | osd | mon | mds | osd.N ... — quorum-committed,
        pushed to every subscriber, durable across restarts."""
        section, name = cmd.get("who", "global"), cmd.get("name")
        if not name:
            return -22, {"error": "missing option name"}
        async with self._mutation_lock:
            ok = await self.paxos.propose(b"C" + json.dumps({
                "section": section, "name": name,
                "value": str(cmd.get("value", ""))}).encode())
            if not ok:
                return -11, {"error": "no quorum; retry"}
        self.clog("INF", f"mon.{self.rank}",
                  f"config set {section}/{name}")
        return 0, {"version": self._config_version}

    async def _cmd_config_rm(self, cmd) -> Tuple[int, Dict[str, Any]]:
        section, name = cmd.get("who", "global"), cmd.get("name")
        if not name:
            return -22, {"error": "missing option name"}
        async with self._mutation_lock:
            ok = await self.paxos.propose(b"C" + json.dumps({
                "section": section, "name": name,
                "value": None}).encode())
            if not ok:
                return -11, {"error": "no quorum; retry"}
        return 0, {"version": self._config_version}

    async def _cmd_config_get(self, cmd) -> Tuple[int, Dict[str, Any]]:
        who = cmd.get("who")
        if who:
            return 0, {"config": self._config_kv.get(who, {}),
                       "version": self._config_version}
        return 0, {"config": self._config_kv,
                   "version": self._config_version}

    async def _cmd_log_last(self, cmd) -> Tuple[int, Dict[str, Any]]:
        """`ceph log last [n]` — the cluster log tail."""
        n = int(cmd.get("num", 20))
        return 0, {"entries": list(self._cluster_log)[-n:]}

    # -- crash reports (pybind/mgr/crash + ceph-crash roles) ---------------
    #
    # Daemons post a report when they die unexpectedly; reports are
    # quorum-replicated (tag b"R"), surface as a RECENT_CRASH health
    # warning until archived, and survive mon restarts via the store
    # snapshot.

    CRASH_RECENT_S = 14 * 86400  # RECENT_CRASH window (reference dflt)

    async def _cmd_crash_post(self, cmd) -> Tuple[int, Dict[str, Any]]:
        rep = dict(cmd.get("report") or {})
        if not rep.get("crash_id"):
            return -22, {"error": "report needs a crash_id"}
        rep.setdefault("timestamp", time.time())
        async with self._mutation_lock:
            ok = await self.paxos.propose(b"R" + json.dumps(
                {"op": "post", "report": rep}).encode())
            if not ok:
                return -11, {"error": "no quorum; retry"}
        self.clog("ERR", f"mon.{self.rank}",
                  f"daemon {rep.get('entity', '?')} crashed:"
                  f" {rep['crash_id']}")
        return 0, {"crash_id": rep["crash_id"]}

    async def _cmd_crash_ls(self, cmd) -> Tuple[int, Dict[str, Any]]:
        new_only = cmd.get("prefix") == "crash ls-new"
        out = [{"crash_id": cid,
                "entity": rep.get("entity", ""),
                "timestamp": rep.get("timestamp", 0),
                "archived": bool(rep.get("archived"))}
               for cid, rep in sorted(self._crash.items())
               if not (new_only and rep.get("archived"))]
        return 0, {"crashes": out}

    async def _cmd_crash_info(self, cmd) -> Tuple[int, Dict[str, Any]]:
        rep = self._crash.get(cmd.get("id", ""))
        if rep is None:
            return -2, {"error": "no such crash"}
        return 0, {"report": rep}

    async def _cmd_crash_archive(self, cmd
                                 ) -> Tuple[int, Dict[str, Any]]:
        if cmd.get("prefix") == "crash archive-all":
            doc = {"op": "archive_all"}
        else:
            cid = cmd.get("id", "")
            if cid not in self._crash:
                return -2, {"error": "no such crash"}
            doc = {"op": "archive", "crash_id": cid}
        async with self._mutation_lock:
            if not await self.paxos.propose(
                    b"R" + json.dumps(doc).encode()):
                return -11, {"error": "no quorum; retry"}
        return 0, {}

    async def _cmd_crash_rm(self, cmd) -> Tuple[int, Dict[str, Any]]:
        cid = cmd.get("id", "")
        if cid not in self._crash:
            return -2, {"error": "no such crash"}
        async with self._mutation_lock:
            if not await self.paxos.propose(b"R" + json.dumps(
                    {"op": "rm", "crash_id": cid}).encode()):
                return -11, {"error": "no quorum; retry"}
        return 0, {}

    async def _cmd_mon_stat(self, cmd) -> Tuple[int, Dict[str, Any]]:
        """Quorum observability (`ceph mon stat` role)."""
        out = {"rank": self.rank, "num_mons": len(self.mon_addrs) or 1,
               "addrs": self.mon_addrs}
        if self.elector is not None:
            out["leader"] = self.elector.leader
            out["election_epoch"] = self.elector.epoch
            out["quorum"] = sorted(self.elector.quorum)
        if self.paxos is not None:
            out["last_committed"] = self.paxos.last_committed
            out["lease_valid"] = self.paxos.lease_valid()
        return 0, out

    async def _cmd_status(self, cmd) -> Tuple[int, Dict[str, Any]]:
        up = self.osdmap.get_up_osds()
        rc, health = await self._cmd_health(cmd)
        return 0, {
            "epoch": self.osdmap.epoch,
            "num_osds": self.osdmap.max_osd,
            "num_up_osds": len(up),
            "num_in_osds": sum(1 for o in range(self.osdmap.max_osd)
                               if self.osdmap.is_in(o)),
            "pools": {p.name: {"id": p.id, "type": p.type,
                               "size": p.size, "pg_num": p.pg_num}
                      for p in self.osdmap.pools.values()},
            "health": health,
        }

    async def _cmd_health(self, cmd) -> Tuple[int, Dict[str, Any]]:
        checks: Dict[str, Dict[str, Any]] = {}
        down = [o for o in range(self.osdmap.max_osd)
                if self.osdmap.exists(o) and self.osdmap.is_down(o)]
        if down:
            checks["OSD_DOWN"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(down)} osds down",
                "detail": [f"osd.{o} is down" for o in down]}
        degraded = 0
        for pool in self.osdmap.pools.values():
            for ps in range(pool.pg_num):
                from ceph_tpu_torch.osd.osdmap import PgId
                acting, _p = self.osdmap.pg_to_acting_osds(
                    PgId(pool.id, ps))
                alive = [o for o in acting
                         if o >= 0 and self.osdmap.is_up(o)]
                if len(alive) < len([o for o in acting if o >= 0]) or \
                        len(alive) < pool.size:
                    degraded += 1
        if degraded:
            checks["PG_DEGRADED"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{degraded} pgs degraded"}
        recent = [cid for cid, rep in self._crash.items()
                  if not rep.get("archived")
                  and time.time() - rep.get("timestamp", 0)
                  < self.CRASH_RECENT_S]
        if recent:
            checks["RECENT_CRASH"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(recent)} daemons have recently"
                           " crashed",
                "detail": sorted(recent)}
        status = "HEALTH_OK" if not checks else "HEALTH_WARN"
        return 0, {"status": status, "checks": checks}
