"""OSD daemon: the data-plane node (port of the client write, read,
degraded-read, snapshot, recovery, backfill, scrub, PG split,
coded-compute and coded-inference slice of ceph_tpu/osd/daemon.py).

Reference parity: ceph-osd (the reference's src/osd/OSD.cc,
PrimaryLogPG.cc, ECBackend.cc, ReplicatedBackend.cc) re-designed on an
asyncio event loop:

- boot: connect the mon, MOSDBoot, subscribe to map epochs
  (OSD::init OSD.cc:3283 + monc subscribe);
- client ops (MOSDOp) hit the primary's op engine: version assignment +
  pg log entry (PrimaryLogPG::execute_ctx), EC encode / replica fan-out
  as sub-writes carrying the log entry (ECBackend::submit_transaction
  ECBackend.cc:1502 -> :2066, ReplicatedBackend's repop), client acked
  when every up shard committed;
- peering on map change (PeeringState roles): primary queries shard
  infos+logs (GetInfo/GetLog), elects the authoritative log (max
  last_update), pushes it to peers who merge + rewind divergent entries
  (PGLog.h:1241-1247), computes per-shard missing sets, recovers
  missing objects (EC reconstruct + push — the RecoveryOp role,
  ECBackend.h:249), then activates and drains queued ops;
- reads gather the first k shards (hedged, osd/hedge.py) and decode
  through the encode service when a data shard is lost;
- pg_num growth splits local PGs (PG::split_into PG.cc:578): objects
  rehashed on the host move to their child PG's collection, the
  parent's log and missing set are partitioned, and a child's first
  peering sweeps every up OSD for split state;
- scans (MOSDCompute) run through the compute engine
  (osd/compute.py): linear kernels fan one MOSDSubCompute per acting
  member, each OSD folds its local shards and the primary decodes the
  first k results in the result domain; nonlinear kernels and the
  exact inference path take the full-decode fallback; Fisher-fused
  model serving rides the inference engine (osd/inference.py);
- OSD<->OSD heartbeats (OSD.cc:5235 handle_osd_ping) with failure
  reports to the mon after the local grace (OSD.cc:5889 send_failures).

Device placement: every EC encode and decode goes through the codec the
daemon builds on its own device (`device=`, CUDA unless the caller names
another; the pool's profile carries none): on the card the encode
service batches concurrent writes into one fused GF + crc32c call
(gf_matmul_spec, crc32c_blocks), degraded reads and recovery decode on
gf_matmul_gen (one launch per survivor set of a wave), a recovery wave
re-encodes in one gf_matmul_spec launch, and MSR repair rebuilds each
(lost, helper set) group in one gf_matmul_gen product.  A sub-compute
folds the OSD's local shards of a wave with one gf_fold launch per
length group, the primary's result-domain decode of a wave with a data
shard's result missing is one gf_matmul_gen launch per survivor set at
lane width, the fallback's compress_score scores on score_blocks and
the inference shard forwards run on the same device.  Scrub's digests
and the hinfo checks are the host's native crc32c.  Placement, and the
split's rehash of objects, are per PG on the host; everything else is
host control-plane.

Omap, object classes and watch/notify are served as in the reference
(omap on replicated pools only; EC pools answer EOPNOTSUPP), and so are
self-managed snapshots: a write under a snap context clones the head on
the host store of every shard first (make_writeable), a read at a snap
resolves to the head or a clone, a remove of a head with clones leaves
a whiteout, and the primary trims clones of removed snaps in the
background.  Not in this slice (ROADMAP A8): the admin socket.  A
decode that raises is not retried on a host twin or object by object: a
recovery leaves the object missing for the next interval to retry, and a
scan's result-domain decode answers EIO for its wave's objects.
"""

from __future__ import annotations

import asyncio
import bisect
import json
import logging
import math
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ceph_tpu_torch.common import buffer as buffer_mod
from ceph_tpu_torch.common import flags, lockdep, tracing
from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.registry import create_erasure_code
from ceph_tpu_torch.msg import Connection, Messenger
from ceph_tpu_torch.msg.messages import (
    MConfig,
    MLog,
    Message,
    MGetMap,
    MOSDBoot,
    MOSDCommand,
    MOSDCommandReply,
    MOSDCompute,
    MOSDComputeReply,
    MOSDFailure,
    MOSDMapMsg,
    MOSDOp,
    MOSDOpReply,
    MOSDSubCompute,
    MOSDSubComputeReply,
    MOSDSubRead,
    MOSDSubReadReply,
    MOSDSubWrite,
    MOSDSubWriteReply,
    MPGLogMsg,
    MPGQuery,
    MPing,
    MWatchNotify,
    MWatchNotifyAck,
    PING,
    PING_REPLY,
    ShardOp,
    decode_kv_map,
    decode_str_list,
    encode_kv_map,
)
from ceph_tpu_torch.ops import checksum as cks
from ceph_tpu_torch.os import ObjectId, ObjectStore, Transaction
from ceph_tpu_torch.os.groupcommit import GroupCommitter
from ceph_tpu_torch.os.memstore import MemStore
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.admission import AdmissionGate, SHED
from ceph_tpu_torch.osd.encode_service import EncodeService
from ceph_tpu_torch.osd.hedge import HedgeTracker
from ceph_tpu_torch.osd.tier import TierAgent
from ceph_tpu_torch.osd import scheduler as sched_mod
from ceph_tpu_torch.osd.osdmap import OSDMap, PgId, TYPE_ERASURE, TYPE_REPLICATED
from ceph_tpu_torch.osd.pg_log import (
    PGLog,
    PGMETA_OID,
    ZERO,
    ev,
    make_entry,
)
from ceph_tpu_torch.rados.embedded import (
    HINFO_ATTR,
    OI_ATTR,
    SS_ATTR,
    shard_collection,
)

log = logging.getLogger("osd")

EAGAIN = -11
ENOENT = -2
ESTALE = -116
EIO = -5
EBUSY = -16
EINVAL = -22
EOPNOTSUPP = -95

DEFAULTS = {
    "osd_heartbeat_interval": 1.0,
    "osd_heartbeat_grace": 4.0,
    "osd_heartbeat_max_peers": 10,
    "osd_sub_op_timeout": 5.0,
    "osd_min_pg_log_entries": 100,
    "osd_pool_erasure_code_stripe_unit": 4096,
}

# client ops whose replay must return the stored reply instead of
# re-executing (non-idempotent mutations; the reqid dedup scope — the
# reference tracks reqids for completed writes, PrimaryLogPG log reqids)
_MUTATING_CLIENT_OPS = frozenset({
    "write_full", "write", "append", "remove", "setxattr", "rmxattr",
    "omap_set", "omap_rm", "call"})

# rollback-generation shard object (ECBackend keeps the previous shard
# generation until a write commits everywhere, so a partial overwrite
# can never destroy the last completed write's reconstructability —
# the ghobject generation / rollback machinery of ECTransaction)
RB_PREFIX = "_rbgen_"

# snapshot clone objects: "<head>\x16<cloneid>" (the ghobject snap
# field role).  The separator is unprintable so client object names can
# never collide with clone names.
SNAP_SEP = "\x16"

# sealed hit sets persist in the pg-meta object's omap under this key
# prefix (the reference persists hit_set archives as PG objects; one
# omap namespace per PG plays that role on this substrate)
HITSET_OMAP_PREFIX = "hitset_"


# user xattrs are namespaced so they can never collide with internal
# attrs (OI/SS/hinfo) — the reference splits "_"-prefixed internals the
# same way (object_info vs user xattr namespace)
USER_ATTR_PREFIX = "u:"


def clone_name(oid: str, cloneid: int) -> str:
    return f"{oid}{SNAP_SEP}{cloneid}"


def is_internal_name(name: str) -> bool:
    """Names clients may not address and pgls must not list."""
    return name.startswith(RB_PREFIX) or SNAP_SEP in name


def _hinfo_chunk_ok(at: Dict[str, bytes], shard: int,
                    payload: bytes) -> bool:
    """Does this shard payload match its recorded hinfo chunk crc?
    Shards without chunk hashes (RMW-era objects) pass — version
    agreement is their consistency story.  The ONE hash-check rule,
    shared by read-path selection and scrub."""
    try:
        hi = ec_util.HashInfo.from_dict(json.loads(at[HINFO_ATTR]))
    except (KeyError, ValueError):
        return True
    if not hi.has_chunk_hash():
        return True
    return cks.crc32c(0xFFFFFFFF, payload) == hi.get_chunk_hash(shard)


class _SkipApply(Exception):
    """Internal: a sub-write adjudicated as a superseded straggler —
    ack success without applying."""


class UnfoundObject(Exception):
    """Raised when an op needs an object whose acked data is currently
    unlocatable (all sources down); mapped to EAGAIN so the client
    retries until recovery finds a source."""


class PGState:
    """In-memory PG bookkeeping (PG + PeeringState role)."""

    def __init__(self, pg: PgId):
        self.pg = pg
        self.acting: List[int] = []
        self.primary = -1
        self.state = "inactive"          # inactive|peering|active
        self.interval_epoch = 0          # same_interval_since
        self.log: Optional[PGLog] = None  # my shard's log (lazy)
        self.next_version = 1            # primary: next log version
        self.peer_missing: Dict[int, Dict[str, tuple]] = {}
        self.active_event = asyncio.Event()
        self.peering_task: Optional[asyncio.Task] = None
        # objects recovery could not reconstruct yet (pg_missing with no
        # found location); re-peered when the up set changes
        self.unfound = False
        # snap ids this primary has already trimmed from its objects
        self.trimmed_snaps: Set[int] = set()
        self.trim_task: Optional[asyncio.Task] = None
        # in-place recovery retry for unfound leftovers (no interval
        # change to trigger re-peering)
        self._unfound_retry: Optional[asyncio.Task] = None
        # per-object write serialization + primary-side extent cache
        # (the ECBackend ExtentCache role): oid -> {"version", "size",
        # "stripes": {stripe_start: logical stripe bytes}}.  Coherent
        # because the primary serializes writes per object and the
        # cache is dropped on any interval change.
        self.obj_locks: Dict[str, list] = {}  # oid -> [Lock, refcount]
        self.extent_cache: "OrderedDict[str, Dict[str, Any]]" = \
            OrderedDict()

    def obj_lock(self, oid: str) -> "_ObjLockCtx":
        """Refcounted per-object lock: the entry is only evictable when
        NO task holds or awaits it.  (A bare `not lock.locked()` sweep
        races the release->waiter-wakeup window of asyncio.Lock, which
        could hand two writers the same object.)"""
        entry = self.obj_locks.get(oid)
        if entry is None:
            entry = self.obj_locks[oid] = [_ObjLock(), 0]
        return _ObjLockCtx(self.obj_locks, oid, entry)

    def my_shard(self, osd: int, pool_type: int) -> int:
        if pool_type == TYPE_REPLICATED:
            return -1
        try:
            return self.acting.index(osd)
        except ValueError:
            return -1


def _lock_class(oid: str) -> str:
    """lockdep class of an object lock key (lock classes, not
    instances — the reference's lockdep model)."""
    if oid.startswith("sub\x00"):
        return "osd.sublock"
    if oid.startswith("_cls_\x00"):
        return "osd.clslock"
    return "osd.objlock"


class _ObjLock:
    """asyncio.Lock-equivalent mutex with a SYNCHRONOUS uncontended
    acquire (`try_acquire`) — the object-lock half of the sub-chunk
    write fast lane.  The async semantics mirror CPython's
    asyncio.Lock exactly (FIFO waiter wakeup; a waiter cancelled
    after being woken passes the wakeup on), so contended acquirers
    behave as before; the sync path only wins the lock when it is
    free with no waiters, which preserves FIFO fairness."""

    __slots__ = ("_locked", "_waiters")

    def __init__(self) -> None:
        self._locked = False
        self._waiters: Optional[deque] = None

    def locked(self) -> bool:
        return self._locked

    def try_acquire(self) -> bool:
        """Take the lock without suspending iff it is free and nobody
        is queued for it (a queued waiter keeps FIFO priority)."""
        if self._locked or self._waiters:
            return False
        self._locked = True
        return True

    async def acquire(self) -> bool:
        if not self._locked and not self._waiters:
            self._locked = True
            return True
        if self._waiters is None:
            self._waiters = deque()
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append(fut)
        try:
            try:
                await fut
            finally:
                self._waiters.remove(fut)
        except asyncio.CancelledError:
            # woken then cancelled: the wakeup must not be lost
            if not self._locked:
                self._wake_up_first()
            raise
        self._locked = True
        return True

    def release(self) -> None:
        if not self._locked:
            raise RuntimeError("release of unlocked _ObjLock")
        self._locked = False
        self._wake_up_first()

    def _wake_up_first(self) -> None:
        if not self._waiters:
            return
        fut = self._waiters[0]
        if not fut.done():
            fut.set_result(True)


class _ObjLockCtx:
    """Context manager pairing an _ObjLock with a user refcount so
    idle entries can be dropped without racing pending acquirers.
    Acquisitions feed lockdep (CEPH_TPU_LOCKDEP=1) for order-inversion
    detection."""

    def __init__(self, table: Dict[str, list], oid: str, entry: list):
        self._table = table
        self._oid = oid
        self._entry = entry

    async def __aenter__(self):
        if lockdep.enabled:
            self._cls = _lock_class(self._oid)
            # remember the acquiring task: the recovery wave enters in
            # gather() subtasks and exits from the parent, and the
            # release must come off the stack the acquire went onto
            self._ld_task = lockdep.acquire(self._cls)
        self._entry[1] += 1
        # obj-lock WAIT is a pipeline stage: span only when contended
        # (an uncontended acquire is a no-op, not time the op spent)
        lk_span = tracing.start_child("objlock") \
            if self._entry[0].locked() else tracing.NULL_SPAN
        try:
            await self._entry[0].acquire()
        except BaseException:
            self._entry[1] -= 1
            if lockdep.enabled:
                lockdep.release(self._cls, getattr(
                    self, "_ld_task", None))
            lk_span.set_attr("cancelled", True)
            lk_span.finish()
            raise
        lk_span.finish()
        return self

    async def __aexit__(self, *exc):
        self._entry[0].release()
        if lockdep.enabled and getattr(self, "_cls", None):
            lockdep.release(self._cls, getattr(self, "_ld_task", None))
        self._entry[1] -= 1
        if self._entry[1] == 0 and \
                self._table.get(self._oid) is self._entry:
            del self._table[self._oid]
        return False

    def try_enter(self) -> bool:
        """Synchronous uncontended acquire — the obj-lock half of the
        sub-chunk fast lane: same lock, refcount, eviction, and
        lockdep discipline as `async with`, minus the coroutine
        round trip (and minus the objlock span, which is
        contended-only anyway).  False = contended; take the async
        path.  Pair a True return with `exit_sync()`."""
        if lockdep.enabled:
            self._cls = _lock_class(self._oid)
            self._ld_task = lockdep.acquire(self._cls)
        if not self._entry[0].try_acquire():
            if lockdep.enabled:
                lockdep.release(self._cls, self._ld_task)
            return False
        self._entry[1] += 1
        return True

    def exit_sync(self) -> None:
        self._entry[0].release()
        if lockdep.enabled and getattr(self, "_cls", None):
            lockdep.release(self._cls, getattr(self, "_ld_task", None))
        self._entry[1] -= 1
        if self._entry[1] == 0 and \
                self._table.get(self._oid) is self._entry:
            del self._table[self._oid]


class OSDDaemon:
    def __init__(self, osd_id: int, mon_addr,
                 store: Optional[ObjectStore] = None,
                 config: Optional[Dict[str, Any]] = None,
                 device=None):
        self.osd_id = osd_id
        # every codec, the hit-set hash and the tier run here: CUDA
        # unless the caller names another device; raises without CUDA
        self.device = resolve_device(device)
        # one mon address, a comma-separated list, or a list: the OSD
        # hunts to the next mon when the current one goes quiet
        # (MonClient hunting role)
        if isinstance(mon_addr, str):
            self.mon_addrs = [a for a in mon_addr.split(",") if a]
        else:
            self.mon_addrs = list(mon_addr)
        self._mon_idx = 0
        self.config = dict(DEFAULTS)
        self.config.update(config or {})
        from ceph_tpu_torch.common.auth import parse_secret

        self.msgr = Messenger(
            f"osd.{osd_id}", secret=parse_secret(
                self.config.get("auth_secret")))
        self.msgr.secure = bool(self.config.get("auth_secure"))
        self.msgr.local_fastpath = bool(
            self.config.get("ms_local_fastpath", True))
        self.msgr.dispatcher = self._dispatch
        self._apply_msgr_injection()
        # heartbeat_inject_failure: while now < this, the daemon goes
        # heartbeat-silent (no pings, no replies) without dying
        self._hb_mute_until = 0.0
        self.store = store if store is not None else MemStore()
        self._own_store = store is None
        # group commit (os/groupcommit.py): concurrent durable txns
        # share ONE kv sync commit + ONE block fsync through a
        # kv_sync_thread-style commit lane; engages only on stores
        # that amortize barriers (TPUStore), inline otherwise.  Kill
        # switches CEPH_TPU_GROUP_COMMIT=0 / osd_group_commit_enable
        self.committer = GroupCommitter(self.store,
                                        who=f"osd.{osd_id}",
                                        config=self.config)
        self.osdmap: Optional[OSDMap] = None
        self.pgs: Dict[PgId, PGState] = {}
        # pg_num per pool as of the last map processed: growth triggers
        # local PG splitting (PG::split_into role)
        self._pool_pg_nums: Dict[int, int] = {}
        # children minted by a split: their first peering sweeps all up
        # OSDs (the data lives on the PARENT's members, which the
        # child's acting mapping knows nothing about)
        self._split_children: Set[PgId] = set()
        self._codecs: Dict[int, Any] = {}
        self._tid = 0
        self._futures: Dict[int, asyncio.Future] = {}
        self._hb_last_rx: Dict[int, float] = {}
        self._hb_task: Optional[asyncio.Task] = None
        self._map_event = asyncio.Event()
        self._stopping = False
        self._last_boot_sent = 0.0
        self._last_map_rx = time.monotonic()
        # data-path transfer/dispatch accounting (perf-counter tier);
        # tests assert small writes/reads move O(stripe), not O(object)
        self.perf = {"subread_bytes": 0, "subwrite_bytes": 0,
                     "encode_dispatches": 0, "decode_dispatches": 0,
                     # objects this shard received as RECOVERY pushes
                     # (installs of entries from its missing set) —
                     # the log-based-vs-backfill discriminator: a
                     # revived OSD with an intact store recovers only
                     # the log diff, not the whole PG
                     "recovery_installs": 0,
                     # repair-bandwidth accounting (ALL codecs): bytes
                     # the recovery engine pulled over the wire vs
                     # bytes of lost chunks it rebuilt — the scrapeable
                     # bytes-read-per-repaired-byte ratio the
                     # regenerating-code path is judged by
                     "recovery_bytes_read": 0,
                     "recovery_bytes_repaired": 0,
                     # fractional-repair engine: waves served by the
                     # MSR repair path vs objects that fell back to
                     # the classic k-read reconstruct
                     "repair_fragments": 0,
                     "repair_objects": 0,
                     "repair_fallbacks": 0}
        # async micro-batching encode/decode front end: concurrent EC
        # ops share fused launches on the card; inline when the codec
        # is on the CPU or CEPH_TPU_ENCODE_SERVICE=0
        self.encode_service = EncodeService(who=f"osd.{osd_id}")
        # hot-set tracking + decoded-object read tier (HitSet + the
        # PrimaryLogPG agent role); kill switch CEPH_TPU_TIER=0 /
        # osd_tier_enable=false
        self.tier = TierAgent(who=f"osd.{osd_id}", config=self.config,
                              device=self.device)
        # straggler-tolerant reads: per-peer sub-read latency EWMAs +
        # the hedged first-k gather primitive (osd/hedge.py); kill
        # switches CEPH_TPU_HEDGE=0 / osd_hedge_enable=false
        self.hedge = HedgeTracker(who=f"osd.{osd_id}",
                                  config=self.config)
        # coded compute: the MOSDCompute scan engine (osd/compute.py)
        # — linear kernels run ON the coded shards (gf_fold on this
        # daemon's device) with first-k result-domain decode;
        # nonlinear kernels take the full-decode fallback.  Scheduled
        # under its own `compute` mClock class + the tenant admission
        # gate.
        from ceph_tpu_torch.osd.compute import ComputeEngine
        from ceph_tpu_torch.osd.inference import InferenceEngine

        self.compute = ComputeEngine(self)
        self.inference = InferenceEngine(self)
        self._promote_tasks: Set[asyncio.Task] = set()
        # watch/notify: (pool, oid) -> {(client, cookie): Connection}
        self.watchers: Dict[Tuple[int, str],
                            Dict[Tuple[str, int], Connection]] = {}
        self._notify_seq = 0
        self._pending_notifies: Dict[int, Dict[str, Any]] = {}
        # post-write repairs scheduled and not yet finished, (pg, oid)
        self._pending_repairs: Set[Tuple[PgId, str]] = set()
        # object classes (ClassHandler::open_all role)
        from ceph_tpu_torch.cls import default_handler

        self.class_handler = default_handler()
        # completed-op replay cache (osd_reqid_t dedup): a client
        # resend after a lost reply gets the STORED reply instead of
        # re-executing a non-idempotent op.  Keyed (client, tid);
        # bounded.  Survives neither restart nor failover — the
        # reference carries reqids in the PG log for those cases.
        self._completed_ops: "OrderedDict[Tuple[str, int], Tuple]" = \
            OrderedDict()
        # QoS op scheduler (mClock/WPQ role): client vs recovery vs
        # scrub arbitration at the execute stage; tenant-tagged client
        # ops (MOSDOp v4) schedule as per-tenant `client.<t>` classes
        # with the osd_mclock_tenant_* dmClock triples, behind a
        # token-bucket admission gate (osd/admission.py).  Kill
        # switches: CEPH_TPU_QOS=0 / osd_mclock_tenant_enable=false
        # collapse every tenant back into the shared client class.
        tenant_profiles: Dict[str, tuple] = {}
        raw_profiles = str(self.config.get(
            "osd_mclock_tenant_profiles", "") or "")
        if raw_profiles:
            try:
                tenant_profiles = {
                    t: tuple(float(x) for x in triple)
                    for t, triple in json.loads(raw_profiles).items()}
            except (ValueError, TypeError):
                log.warning("osd.%d: bad osd_mclock_tenant_profiles"
                            " %r ignored", osd_id, raw_profiles)
        tenant_default = (
            float(self.config.get("osd_mclock_tenant_reservation",
                                  0.0)),
            float(self.config.get("osd_mclock_tenant_weight", 1.0)),
            float(self.config.get("osd_mclock_tenant_limit", 0.0)))
        self.scheduler = sched_mod.make_scheduler(
            str(self.config.get("osd_op_queue", "mclock_scheduler")),
            max_concurrent=int(self.config.get(
                "osd_op_num_threads", 8)),
            max_queue_depth=int(self.config.get(
                "osd_scheduler_queue_depth", 1024)),
            overflow=str(self.config.get(
                "osd_scheduler_overflow", "shed")),
            tenant_default=tenant_default,
            tenant_profiles=tenant_profiles)
        self._qos_tenants_enabled = (
            flags.enabled("CEPH_TPU_QOS")
            and bool(self.config.get("osd_mclock_tenant_enable",
                                     True))
            and isinstance(self.scheduler,
                           sched_mod.MClockScheduler))
        # sub-chunk op fast lane (scheduler.try_acquire + sync obj
        # lock): identical admission/QoS accounting, minus the per-op
        # queue/objlock coroutine micro-costs.  CEPH_TPU_OP_FAST_LANE=0
        # pins every op to the queued path (behavioral twin).
        self._op_fast_lane = flags.enabled("CEPH_TPU_OP_FAST_LANE")
        profile_of = (
            (lambda t: self.scheduler.profile_of(
                sched_mod.tenant_class(t)))
            if self._qos_tenants_enabled else (lambda t: (0.0, 1.0,
                                                          0.0)))
        self.admission = AdmissionGate(config=self.config,
                                       profile_of=profile_of)
        if not self._qos_tenants_enabled:
            self.admission.enabled = False
        # backfill/recovery throttle (osd_max_backfills role): at most
        # N PGs may run _recover_pg concurrently on this OSD.  An
        # elasticity event (osd out/in, revive) re-peers MANY PGs at
        # once; without the cap their plan waves all contend for
        # scheduler slots and device dispatches at the same time and
        # client reservations starve exactly when the cluster is
        # already degraded.
        self._backfill_sem = asyncio.Semaphore(
            max(int(self.config.get("osd_max_backfills", 1)), 1))
        self.perf["backfills_active"] = 0
        self.perf["backfill_waits"] = 0
        # op tracking + background scrub + admin socket
        from ceph_tpu_torch.osd.op_tracker import OpTracker

        self.op_tracker = OpTracker(
            history_size=int(self.config.get("osd_op_history_size",
                                             20)),
            complaint_time=float(self.config.get(
                "osd_op_complaint_time", 30.0)),
            who=f"osd.{osd_id}")
        self._scrub_task: Optional[asyncio.Task] = None
        self._admin_socket = None
        self.scrub_stats = {"objects": 0, "errors": 0, "repaired": 0}
        # stage-span tracing: head-sampled ring retention (the bulk),
        # tail-based exemplar retention via the op tracker (the ops
        # worth explaining keep their full tree even at rate 0)
        self.tracer = tracing.Tracer(
            f"osd.{osd_id}",
            sample_rate=float(self.config.get(
                "osd_trace_sample_rate", 1.0)),
            enabled=bool(self.config.get("osd_trace_enable", True)))
        self.encode_service.tracer = self.tracer

    @property
    def mon_addr(self) -> str:
        return self.mon_addrs[self._mon_idx % len(self.mon_addrs)]

    def _hunt_mon(self) -> None:
        stale = self.msgr._conns.get(self.mon_addr)
        if stale is not None:
            stale.close()
        self._mon_idx += 1

    # -- lifecycle ---------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        # prewarm the native library OFF-loop before the store mounts:
        # msgr.bind prewarms too (Messenger._prewarm_native, the shared
        # choke point every daemon and client crosses), but the store's
        # mkfs/mount below can touch native csum BEFORE bind runs
        from ceph_tpu_torch import native
        if not native.prewarmed():
            await asyncio.to_thread(native.get_lib)
        if self.device.type == "cuda":
            # the kernels' build (or library load) and the CUDA context,
            # off-loop and before boot: the first write's encode must
            # not pay them inside a sub-op's osd_sub_op_timeout
            await asyncio.to_thread(self._prewarm_device)
        if self._own_store:
            self.store.mkfs()
            self.store.mount()
        self._load_split_meta()
        addr = await self.msgr.bind(host, port)
        for _attempt in range(2 * len(self.mon_addrs)):
            try:
                mon = await self.msgr.connect(self.mon_addr)
                await mon.send(MGetMap(subscribe=True))
                await mon.send(MOSDBoot(self.osd_id, addr))
                break
            except (ConnectionError, OSError):
                self._hunt_mon()
                await asyncio.sleep(0.2)
        # wait until the map marks us up (prepare_boot round trip;
        # _post_map_epoch keeps re-sending boot if adjudication lags)
        for _ in range(200):
            if self.osdmap is not None and \
                    self.osdmap.is_up(self.osd_id) and \
                    self.osdmap.osd_addrs.get(self.osd_id) == addr:
                break
            await asyncio.sleep(0.02)
        self._hb_task = asyncio.get_running_loop().create_task(
            self._heartbeat_loop())
        scrub_iv = float(self.config.get("osd_scrub_interval", 0))
        if scrub_iv > 0:
            self._scrub_task = asyncio.get_running_loop().create_task(
                self._scrub_loop(scrub_iv))
        admin_path = self.config.get("admin_socket", "")
        if admin_path:
            self._start_admin_socket(admin_path)
        return addr

    def _prewarm_device(self) -> None:
        from ceph_tpu_torch.ops import _build

        # every kernel library, gf_fold's included: the first
        # sub-compute's fold must not build inside the primary's
        # osd_sub_op_timeout either
        _build.load()
        torch.empty(1, device=self.device)

    def _admin_commands(self):
        """name -> (handler, help): one admin surface served both by
        the local admin socket and by MOSDCommand over the wire (the
        `ceph tell osd.N` / OSD::do_command role)."""
        return {
            "dump_ops_in_flight": (
                lambda cmd: self.op_tracker.dump_in_flight(),
                "show in-flight client ops"),
            "dump_historic_ops": (
                lambda cmd: self.op_tracker.dump_historic(),
                "show recently completed client ops"),
            "perf dump": (
                lambda cmd: self._cmd_perf_dump(),
                "data-path transfer/dispatch counters + tier/"
                "encode-service sub-sections"),
            "tier_status": (
                lambda cmd: self.tier.status(),
                "read-tier cache occupancy + hit/miss/promote/evict"
                " counters"),
            "hedge_status": (
                lambda cmd: self.hedge.status(),
                "hedged-read scheduler: per-peer latency EWMAs/p95 +"
                " breaker states, hedges fired/won, cancelled"
                " sub-reads, Δ escalation"),
            "hitset_dump": (
                lambda cmd: self._cmd_hitset_dump(),
                "per-PG hot-set stacks + persisted hitset omap keys"),
            "dump_pgs": (
                lambda cmd: {str(pg): {"state": st.state,
                                       "primary": st.primary,
                                       "acting": list(st.acting)}
                             for pg, st in list(self.pgs.items())},
                "per-PG state"),
            "scrub_stats": (
                lambda cmd: dict(self.scrub_stats),
                "lifetime scrub object/error/repair counters"),
            "encode_service": (
                lambda cmd: self.encode_service.stats(),
                "micro-batching encode service: batch/fill/wait"
                " histograms, queue depth, inline fallbacks"),
            "qos_status": (
                lambda cmd: self._cmd_qos_status(),
                "per-tenant mClock QoS: scheduler grant/queue state,"
                " tenant profiles, admission-gate admit/delay/shed"
                " decisions and live bucket levels"),
            "store_status": (
                lambda cmd: self._cmd_store_status(),
                "backing object store: type, fsid, mount state,"
                " statfs, and the durability counters (journal"
                " replays/bytes, csum read failures, deferred-queue"
                " depth, fsyncs)"),
            "dump_traces": (
                lambda cmd: {"spans": self.tracer.dump(
                    int(cmd["trace_id"], 16)
                    if cmd.get("trace_id") else None)},
                "blkin-role spans collected on this daemon"),
            "dump_op_trace": (
                lambda cmd: self._cmd_dump_op_trace(
                    cmd.get("trace_id", "")),
                "render one tail-exemplar op's span tree with"
                " critical-path stage self-times (no trace_id lists"
                " the retained exemplars)"),
            "statfs": (
                lambda cmd: self._cmd_statfs(),
                "store usage + per-pool object/byte breakdown"),
            "inference_status": (
                lambda cmd: self.inference.perf_dump(),
                "coded inference serving: query/approx/fallback"
                " counters, substituted streams, and the estimated"
                " relative-error histogram"),
        }

    def _cmd_perf_dump(self) -> Dict[str, Any]:
        """Flat data-path counters plus the nested observability
        sections the prometheus exporter flattens: tier (hit-set +
        cache) and encode_service (micro-batching counters +
        per-profile batch/fill stats)."""
        out: Dict[str, Any] = dict(self.perf)
        out["tier"] = self.tier.counters()
        svc = self.encode_service.stats()
        out["encode_service"] = {
            k: (int(v) if isinstance(v, bool) else v)
            for k, v in svc.items()
            if isinstance(v, (bool, int, float))}
        out["encode_service"]["profiles"] = {
            label: {k: v for k, v in st.items()
                    if isinstance(v, (int, float, dict))
                    and not isinstance(v, bool)}
            for label, st in svc.get("profiles", {}).items()}
        # hedged-read scheduler: counters + the per-peer EWMA model
        # (the prometheus flattener turns `peers` into peer-labeled
        # rows)
        out["hedge"] = self.hedge.perf()
        # coded-compute engine: pushdown-vs-fallback split + result
        # bytes moved (the scan observability surface)
        out["compute"] = self.compute.perf()
        # coded inference serving: approx-vs-exact split + the
        # est_error histogram (flattens to ceph_osd_inference_* rows)
        out["inference"] = self.inference.perf_dump()
        # per-tenant QoS: scheduler queue/grant state + admission
        # decisions (`tenants` flattens to tenant-labeled rows)
        out["qos"] = self._qos_perf()
        # backing-store durability counters (TPUStore; MemStore has
        # none) — flattens to ceph_osd_store_* gauges
        pc = getattr(self.store, "perf_counters", None)
        if callable(pc):
            out["store"] = {k: v for k, v in pc().items()
                            if isinstance(v, (int, float))}
        # group commit: batches / txns-per-batch histogram / window-
        # vs-budget flushes (fsyncs_saved rides the store section as
        # gc_fsyncs_saved) — ceph_osd_group_commit_* rows
        gc = self.committer.stats()
        out["group_commit"] = {
            k: (int(v) if isinstance(v, bool) else v)
            for k, v in gc.items()
            if isinstance(v, (bool, int, float))}
        out["group_commit"]["txns_per_batch_hist"] = \
            dict(gc["txns_per_batch_hist"])
        # op tracker: lifetime op count, in-flight gauge, slow-op and
        # tail-exemplar totals
        out["op_tracker"] = self.op_tracker.perf()
        # critical-path tracing: per-stage self-time histograms (the
        # `stage` label map flattens to ceph_osd_trace_stage_* rows)
        out["trace"] = {
            "enabled": int(self.tracer.enabled),
            "sample_rate": self.tracer.sample_rate,
            **self.tracer.counters,
            "stage": self.tracer.stage_perf(),
        }
        return out

    def _cmd_dump_op_trace(self, trace_id: str) -> Dict[str, Any]:
        """One tail-exemplar op's journey: the span tree, the
        critical-path stage decomposition, and a rendered text tree
        (self-time per span) — the operator's answer to 'which stage
        did this slow op spend its time in'."""
        if not trace_id:
            return {"exemplars": self.op_tracker.exemplar_ids()}
        doc = self.op_tracker.get_trace(trace_id)
        if doc is None:
            return {"error": f"no exemplar for trace {trace_id!r}",
                    "exemplars": self.op_tracker.exemplar_ids()}
        cp = doc.get("critical_path") or {}
        rendered = [
            "{}{} [{}] self={:.3f}ms span={:.3f}ms".format(
                "  " * e.get("depth", 0), e.get("name", ""),
                e.get("stage", ""), e.get("self_us", 0) / 1e3,
                e.get("span_us", 0) / 1e3)
            for e in cp.get("path", [])]
        return {**doc, "rendered": rendered}

    def _cmd_store_status(self) -> Dict[str, Any]:
        """The operator view of the backing store: what engine, which
        disk (fsid), is it mounted, how full, and whether the
        durability machinery (deferred WAL, csum reads) has been
        exercised or is reporting failures."""
        pc = getattr(self.store, "perf_counters", None)
        return {
            "type": type(self.store).__name__,
            "fsid": getattr(self.store, "fsid", ""),
            "mounted": bool(getattr(self.store, "_mounted", True)),
            "statfs": self.store.statfs(),
            "perf": pc() if callable(pc) else {},
            "group_commit": self.committer.stats(),
        }

    def _qos_perf(self) -> Dict[str, Any]:
        """Nested `qos` perf-dump section: numeric scheduler state
        plus the admission gate's decision counters, with per-tenant
        rows under the `tenants` label map."""
        st = self.scheduler.stats()
        adm = self.admission.perf()
        adm["admission_enabled"] = adm.pop("enabled", 0)
        tenants: Dict[str, Dict[str, Any]] = {
            t: dict(c) for t, c in adm.pop("tenants", {}).items()}
        for cls, depth in st.get("queue_depths", {}).items():
            if cls.startswith(sched_mod.TENANT_PREFIX):
                t = cls[len(sched_mod.TENANT_PREFIX):]
                tenants.setdefault(t, {})["queue_depth"] = depth
        for cls, n in st.get("granted", {}).items():
            if cls.startswith(sched_mod.TENANT_PREFIX):
                t = cls[len(sched_mod.TENANT_PREFIX):]
                tenants.setdefault(t, {})["granted"] = n
        return {
            "enabled": int(self._qos_tenants_enabled),
            "in_flight": st["in_flight"],
            "queued": st["queued"],
            "max_concurrent": st["max_concurrent"],
            "max_queue_depth": st["max_queue_depth"],
            "queue_shed": sum(st.get("queue_shed", {}).values()),
            "cancelled_before_grant":
                st.get("cancelled_before_grant", 0),
            **adm,
            "tenants": tenants,
        }

    def _cmd_qos_status(self) -> Dict[str, Any]:
        """The operator view of 'who is being served, delayed, shed,
        and under what profile' — scheduler + admission in one
        dump."""
        out: Dict[str, Any] = {
            "enabled": self._qos_tenants_enabled,
            "scheduler": self.scheduler.stats(),
            "admission": self.admission.status(),
        }
        if isinstance(self.scheduler, sched_mod.MClockScheduler):
            out["tenant_default"] = list(
                self.scheduler.tenant_default)
            out["tenant_profiles"] = {
                t: list(p) for t, p in
                self.scheduler.tenant_profiles.items()}
        return out

    def _cmd_hitset_dump(self) -> Dict[str, Any]:
        """Live per-PG stacks + the hitset omap keys persisted on this
        daemon's shard collections (the kv omap prefix archive)."""
        out: Dict[str, Any] = {"stacks": self.tier.hitset_dump(),
                               "persisted": {}}
        for pg, state in list(self.pgs.items()):
            pool = self.osdmap.pools.get(pg.pool) \
                if self.osdmap else None
            if pool is None:
                continue
            shard = state.my_shard(self.osd_id, pool.type)
            try:
                omap = self.store.omap_get(self._cid(pg, shard),
                                           ObjectId(PGMETA_OID))
            except (KeyError, IOError):
                continue
            keys = sorted(k for k in omap
                          if k.startswith(HITSET_OMAP_PREFIX))
            if keys:
                out["persisted"][str(pg)] = keys
        return out

    async def _cmd_statfs(self) -> Dict[str, Any]:
        """Store usage plus a per-pool breakdown from this OSD's own
        shard collections (the MPGStats/osd_stat_t reporting role,
        pulled over the tell surface instead of pushed): bytes are
        RAW stored bytes on THIS osd (chunks for EC, one copy for
        replicated); objects count heads only.  Yields between PGs —
        a large OSD's scan must not stall heartbeats and client I/O
        sharing the event loop."""
        out: Dict[str, Any] = dict(self.store.statfs())
        pools: Dict[int, Dict[str, int]] = {}
        for pg, state in list(self.pgs.items()):
            await asyncio.sleep(0)
            pool = self.osdmap.pools.get(pg.pool)
            if pool is None:
                continue
            try:
                my_shard = state.my_shard(self.osd_id, pool.type)
            except Exception:
                continue
            agg = pools.setdefault(pg.pool,
                                   {"objects": 0, "bytes": 0})
            for i, name in enumerate(
                    self._list_shard_objects(pg, my_shard)):
                if i % 256 == 255:
                    await asyncio.sleep(0)
                try:
                    st = self.store.stat(self._cid(pg, my_shard),
                                         ObjectId(name))
                except (KeyError, IOError, OSError):
                    continue
                agg["bytes"] += int(st.get("size", 0))
                if not is_internal_name(name):
                    agg["objects"] += 1
        out["pools"] = {str(k): v for k, v in pools.items()}
        return out

    def _start_admin_socket(self, path: str) -> None:
        from ceph_tpu_torch.common.admin_socket import AdminSocket

        loop = asyncio.get_running_loop()

        def wrap(fn):
            # the asok serve thread is synchronous: run coroutine
            # handlers on the daemon loop and wait for the result
            def call(cmd):
                out = fn(cmd)
                if asyncio.iscoroutine(out):
                    return asyncio.run_coroutine_threadsafe(
                        out, loop).result(30)
                return out
            return call

        sock = AdminSocket(path, version=f"ceph_tpu osd.{self.osd_id}")
        for name, (fn, help_text) in self._admin_commands().items():
            sock.register_command(name, wrap(fn), help_text)
        sock.init()
        self._admin_socket = sock

    async def stop(self) -> None:
        self._stopping = True
        for task in list(self._promote_tasks):
            task.cancel()
        if self._promote_tasks:
            await asyncio.gather(*list(self._promote_tasks),
                                 return_exceptions=True)
        await self.scheduler.stop()
        # after the scheduler drained: no new client ops enqueue, and
        # any encode futures still in flight resolve before teardown
        await self.encode_service.stop()
        # flush the group-commit window: every acked txn is durable
        # and no caller is stranded on an unresolved commit future
        await self.committer.stop()
        if self._admin_socket is not None:
            # shutdown joins the serve thread: keep that wait OFF the
            # shared event loop (co-hosted daemons keep running)
            await asyncio.to_thread(self._admin_socket.shutdown)
        if self._scrub_task is not None:
            self._scrub_task.cancel()
        if self._hb_task is not None:
            self._hb_task.cancel()
        for ps in self.pgs.values():
            if ps.peering_task is not None:
                ps.peering_task.cancel()
            if ps._unfound_retry is not None:
                ps._unfound_retry.cancel()
        await self.msgr.shutdown()
        if self._own_store:
            self.store.umount()

    async def kill(self) -> None:
        """Crash: drop off the network without unmounting cleanly."""
        self._stopping = True
        if self._hb_task is not None:
            self._hb_task.cancel()
        if self._scrub_task is not None:
            self._scrub_task.cancel()
        for task in list(self._promote_tasks):
            task.cancel()
        await self.scheduler.stop()
        await self.encode_service.stop()
        # drain the commit lane even on crash-style teardown: an
        # ACKED txn sitting in a worker-thread batch must reach the
        # store before the harness power-cuts it (unacked window
        # txns flush too — they simply commit unacked, which the
        # crash model allows; acked-but-lost is what it forbids)
        await self.committer.stop()
        for ps in self.pgs.values():
            if ps.peering_task is not None:
                ps.peering_task.cancel()
            if ps._unfound_retry is not None:
                ps._unfound_retry.cancel()
        await self.msgr.shutdown()

    # -- plumbing ----------------------------------------------------------

    def _next_tid(self) -> int:
        self._tid += 1
        return self._tid

    def _codec(self, pool_id: int):
        codec = self._codecs.get(pool_id)
        if codec is None:
            pool = self.osdmap.pools[pool_id]
            profile = self.osdmap.erasure_code_profiles[
                pool.erasure_code_profile]
            # built on this daemon's device: the profile in the map
            # carries none
            codec = create_erasure_code(
                {**profile, "device": str(self.device)})
            self._codecs[pool_id] = codec
        return codec

    def _sinfo(self, pool_id: int) -> ec_util.StripeInfo:
        codec = self._codec(pool_id)
        k = codec.get_data_chunk_count()
        # per-profile stripe_unit override, falling back to the global
        # default — the reference's erasure-code-profile stripe_unit
        # key (OSDMonitor.cc parse_erasure_code_profile; option
        # osd_pool_erasure_code_stripe_unit options.cc:2662).  Larger
        # units amortize per-chunk costs (crc lane combines, region-op
        # setup) on big-object pools.
        pool = self.osdmap.pools[pool_id]
        profile = self.osdmap.erasure_code_profiles.get(
            pool.erasure_code_profile, {})
        base = int(profile.get(
            "stripe_unit",
            self.config["osd_pool_erasure_code_stripe_unit"]))
        unit = codec.get_chunk_size(k * base)
        return ec_util.StripeInfo(k, k * unit)

    def _op_fast_lane_ok(self, pool, nbytes: int) -> bool:
        """Gate for the sub-chunk client-op fast lane: EC-pool ops
        whose payload fits in one chunk (the small-object band the
        encode service packs into native tape batches).  Anything
        bigger keeps the queued path — large ops are the ones mClock
        reordering actually helps."""
        if not self._op_fast_lane or pool.type != TYPE_ERASURE:
            return False
        try:
            return nbytes <= self._sinfo(pool.id).get_chunk_size()
        except Exception:
            return False

    async def _traced_subwrite(self, osd: int, msg: Message,
                               tid: int) -> Optional[Message]:
        """Per-peer `subwrite osd.N` stage span around the ack wait —
        the write-side twin of hedge.py's per-peer subread spans, so a
        slow replica's ack attributes to ITS span instead of opaque
        osd_op self-time.  child_span installs the span as current, so
        _request stamps the wire context with the PER-PEER span and
        the replica's sub_write tree parents under it."""
        async with tracing.child_span(f"subwrite osd.{osd}", peer=osd):
            return await self._request(osd, msg, tid)

    async def _request(self, osd: int, msg: Message,
                       tid: int) -> Optional[Message]:
        """Send to a peer OSD and await the tid-matched reply; None on
        timeout/fault (caller treats the shard as unavailable)."""
        addr = self.osdmap.osd_addrs.get(osd)
        if addr is None:
            return None
        if isinstance(msg, (MOSDSubWrite, MOSDSubRead)) and \
                msg.trace is None:
            # sub-ops fanned out under a SAMPLED client op inherit its
            # span as parent (blkin's "span per sub-op" shape); the
            # hedged sub-read fan-out rides the same tail field
            # (MOSDSubRead v4).  Unsampled ops do NOT propagate: the
            # peer would pay span + ring retention for a trace nobody
            # keeps (tail exemplars are primary-local trees)
            parent = tracing.current_span.get()
            if parent is not None and parent.sampled and \
                    parent.context is not None:
                msg.trace = parent.context
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._futures[tid] = fut
        try:
            await self.msgr.send_to(addr, msg)
            return await asyncio.wait_for(
                fut, self.config["osd_sub_op_timeout"])
        except (ConnectionError, OSError, asyncio.TimeoutError):
            return None
        finally:
            self._futures.pop(tid, None)

    def _resolve(self, tid: int, msg: Message) -> bool:
        fut = self._futures.get(tid)
        if fut is not None and not fut.done():
            fut.set_result(msg)
            return True
        return False

    # -- dispatch ----------------------------------------------------------

    async def _dispatch(self, conn: Connection, msg: Message) -> None:
        if isinstance(msg, MConfig):
            self._apply_central_config(msg)
            return
        if isinstance(msg, MOSDMapMsg):
            self._handle_map(msg)
        elif isinstance(msg, MPing):
            await self._handle_ping(conn, msg)
        elif isinstance(msg, MOSDOp):
            await self._handle_client_op(conn, msg)
        elif isinstance(msg, MOSDCompute):
            await self._handle_compute_op(conn, msg)
        elif isinstance(msg, MOSDSubWrite):
            await self._handle_sub_write(conn, msg)
        elif isinstance(msg, MOSDSubRead):
            await self._handle_sub_read(conn, msg)
        elif isinstance(msg, MOSDSubCompute):
            await self._handle_sub_compute(conn, msg)
        elif isinstance(msg, (MOSDSubWriteReply, MOSDSubReadReply,
                              MOSDSubComputeReply)):
            self._resolve(msg.tid, msg)
        elif isinstance(msg, MWatchNotifyAck):
            self._handle_notify_ack(conn, msg)
        elif isinstance(msg, MPGQuery):
            await self._handle_pg_query(conn, msg)
        elif isinstance(msg, MPGLogMsg):
            if msg.is_reply:
                self._resolve(msg.tid, msg)  # late replies just drop
            else:
                await self._handle_pg_log_push(conn, msg)
        elif isinstance(msg, MOSDCommand):
            await self._handle_osd_command(conn, msg)

    async def _handle_osd_command(self, conn: Connection,
                                  msg: MOSDCommand) -> None:
        """`ceph tell osd.N` surface: the admin-socket command table
        served over the wire (OSD::do_command role)."""
        prefix = msg.cmd.get("prefix", "")
        entry = self._admin_commands().get(prefix)
        try:
            if entry is not None:
                out = entry[0](msg.cmd)
                if asyncio.iscoroutine(out):
                    out = await out  # async handlers (statfs scan)
                rc = 0
            elif prefix == "scrub":
                # trigger an immediate scrub of my primary PGs and
                # report the run's totals (`ceph tell osd.N scrub`)
                out = {"objects": 0, "errors": 0, "repaired": 0}
                for pg, state in list(self.pgs.items()):
                    if state.primary != self.osd_id or \
                            state.state != "active" or self.osdmap is None:
                        continue
                    pool = self.osdmap.pools.get(pg.pool)
                    if pool is None:
                        continue
                    run = await self.scrub_pg(state, pool)
                    for key in out:
                        out[key] += run[key]
                rc = 0
            else:
                rc, out = EINVAL, {"error": f"unknown command {prefix!r}"}
        except Exception as e:
            log.exception("osd.%d: command %r failed", self.osd_id,
                          prefix)
            rc, out = EINVAL, {"error": str(e)}
        await conn.send(MOSDCommandReply(msg.tid, rc, out))

    # -- map handling ------------------------------------------------------

    def _apply_central_config(self, msg: MConfig) -> None:
        """ConfigMonitor push: overlay centralized options with the
        reference's mask precedence (global < osd < osd.N), coerced to
        the local option's existing type.  Loops read config per tick,
        so changes take effect live."""
        merged: Dict[str, str] = {}
        for section in ("global", "osd", f"osd.{self.osd_id}"):
            merged.update(msg.values.get(section, {}))
        if not hasattr(self, "_central_baseline"):
            self._central_baseline: Dict[str, Any] = {}
        # a key REMOVED centrally reverts to its pre-override value
        # (config rm must take effect live, not at next restart)
        for name in list(self._central_baseline):
            if name not in merged:
                val = self._central_baseline.pop(name)
                log.info("osd.%d: config %s -> %r (central override"
                         " removed)", self.osd_id, name, val)
                if val is None:
                    # the option had NO local value before the central
                    # override: restore absence, not a None mapping
                    self.config.pop(name, None)
                else:
                    self.config[name] = val
        for name, raw in merged.items():
            cur = self.config.get(name)
            val: Any = raw
            try:
                if isinstance(cur, bool):
                    val = str(raw).lower() in ("1", "true", "yes", "on")
                elif isinstance(cur, int):
                    val = int(raw)
                elif isinstance(cur, float):
                    val = float(raw)
            except (TypeError, ValueError):
                log.warning("osd.%d: bad central config %s=%r",
                            self.osd_id, name, raw)
                continue
            if self.config.get(name) != val:
                self._central_baseline.setdefault(name, cur)
                log.info("osd.%d: config %s -> %r (centralized)",
                         self.osd_id, name, val)
                self.config[name] = val
        self._apply_msgr_injection()
        # sample_rate is deliberately NOT FLAG_STARTUP (options.py): a
        # central `config set osd osd_trace_sample_rate ...` must reach
        # the live Tracer, whose copy was taken at construction
        try:
            self.tracer.sample_rate = float(self.config.get(
                "osd_trace_sample_rate", self.tracer.sample_rate))
        except (TypeError, ValueError):
            pass

    def _apply_msgr_injection(self) -> None:
        """Push ms_inject_* config into the live messenger (the options
        take effect on the next frame, like the reference's md_config
        observer on AsyncMessenger).  Each option parses independently
        — one bad value must neither block the other nor vanish
        silently."""
        try:
            self.msgr.inject_socket_failures = int(
                self.config.get("ms_inject_socket_failures", 0) or 0)
        except (TypeError, ValueError):
            log.warning("osd.%d: ignoring bad ms_inject_socket_"
                        "failures=%r", self.osd_id,
                        self.config.get("ms_inject_socket_failures"))
        try:
            self.msgr.inject_internal_delays = float(
                self.config.get("ms_inject_internal_delays", 0) or 0)
        except (TypeError, ValueError):
            log.warning("osd.%d: ignoring bad ms_inject_internal_"
                        "delays=%r", self.osd_id,
                        self.config.get("ms_inject_internal_delays"))
        self.msgr.apply_compress_config(self.config)

    def _clog(self, level: str, message: str) -> None:
        """Fire one cluster-log entry at the mon (MLog role)."""
        entry = {"stamp": time.time(), "level": level,
                 "who": f"osd.{self.osd_id}", "message": message}

        async def send():
            try:
                await self.msgr.send_to(self.mon_addr, MLog([entry]))
            except (ConnectionError, OSError):
                pass

        self.msgr._spawn(send())

    def _handle_map(self, msg: MOSDMapMsg) -> None:
        """Advance the local map EPOCH BY EPOCH."""
        self._last_map_rx = time.monotonic()
        self._handle_map_inner(msg)

    def _handle_map_inner(self, msg: MOSDMapMsg) -> None:
        """Advance the local map EPOCH BY EPOCH.

        Interval detection (_scan_pgs) is only correct if every epoch is
        observed in order: a skipped epoch can hide a primary change, so
        a daemon would keep writing under an interval its replicas have
        already fenced off.  Incrementals apply contiguously; a gap
        triggers a pull of the missing range from the mon (the
        handle_osd_map / osdmap subscribe discipline, OSD.cc)."""
        from ceph_tpu_torch.osd.osdmap import Incremental

        applied = False
        if msg.incrementals and self.osdmap is not None:
            for raw in msg.incrementals:
                inc = Incremental.decode(raw)
                if inc.epoch <= self.osdmap.epoch:
                    continue
                if inc.epoch != self.osdmap.epoch + 1:
                    log.debug("osd.%d: inc %d does not follow %d,"
                              " pulling range", self.osd_id, inc.epoch,
                              self.osdmap.epoch)
                    self._request_map_range()
                    return
                prev_up = set(self.osdmap.get_up_osds())
                self.osdmap.apply_incremental(inc)
                log.debug("osd.%d: advanced to epoch %d (inc)",
                          self.osd_id, self.osdmap.epoch)
                self._post_map_epoch(prev_up)
                applied = True
        if applied or msg.full_map is None:
            return
        newmap = OSDMap.decode(msg.full_map)
        if self.osdmap is not None and newmap.epoch <= self.osdmap.epoch:
            return
        if self.osdmap is not None and \
                newmap.epoch > self.osdmap.epoch + 1 and \
                not msg.gap_unfillable:
            self._request_map_range()
            return
        prev_up = set(self.osdmap.get_up_osds()) \
            if self.osdmap is not None else set()
        if self.osdmap is not None and msg.gap_unfillable:
            log.warning("osd.%d: adopting full map %d over a gap from"
                        " %d (mon inc log trimmed)", self.osd_id,
                        newmap.epoch, self.osdmap.epoch)
        self.osdmap = newmap
        # mutation-through-incrementals contract: enable placement memo
        self.osdmap.enable_placement_cache()
        self._post_map_epoch(prev_up)

    def _request_map_range(self) -> None:
        """Pull the incrementals between my epoch and the mon's."""
        now = time.monotonic()
        if now - getattr(self, "_last_range_req", 0.0) < 0.2:
            return
        self._last_range_req = now
        self.msgr._spawn(self.msgr.send_to(
            self.mon_addr,
            MGetMap(since_epoch=self.osdmap.epoch, subscribe=False)))

    _META_CID = "osd_meta"

    def _load_split_meta(self) -> None:
        """Split bookkeeping survives restarts: a durable OSD that was
        down across a pg_num increase must still redistribute its
        on-disk objects when it boots into the grown map."""
        try:
            omap = self.store.omap_get(self._META_CID,
                                       ObjectId("split_state"))
            doc = json.loads(omap["v"])
            self._pool_pg_nums = {int(k): v
                                  for k, v in doc["pg_nums"].items()}
            self._split_children = {PgId(p, ps)
                                    for p, ps in doc["children"]}
        except (KeyError, ValueError):
            pass

    def _save_split_meta(self, t: Optional[Transaction] = None) -> None:
        own = t is None
        if own:
            t = Transaction()
        if not self.store.collection_exists(self._META_CID):
            t.create_collection(self._META_CID)
        t.omap_setkeys(self._META_CID, ObjectId("split_state"), {
            "v": json.dumps({
                "pg_nums": self._pool_pg_nums,
                "children": sorted([p.pool, p.ps]
                                   for p in self._split_children),
            }).encode()})
        if own:
            self.store.queue_transaction(t)

    def _check_pool_splits(self) -> None:
        """pg_num growth observed: redistribute local PG state.  Safe
        across multi-epoch jumps — stable-mod placement depends only on
        the FINAL pg_num, so folding several growth steps into one
        redistribution lands objects exactly where stepwise splitting
        would."""
        changed = False
        for pool in self.osdmap.pools.values():
            old = self._pool_pg_nums.get(pool.id)
            if old != pool.pg_num:
                changed = True
            self._pool_pg_nums[pool.id] = pool.pg_num
            if old is None or pool.pg_num <= old:
                continue
            try:
                self._split_pool_pgs(pool, old, pool.pg_num)
            except Exception:
                log.exception("osd.%d: split of pool %d (%d->%d)"
                              " failed", self.osd_id, pool.id, old,
                              pool.pg_num)
        if changed:
            self._save_split_meta()

    @staticmethod
    def _head_name(name: str) -> str:
        """Companion object -> owning head (rollback generations and
        snap clones split WITH their head)."""
        if name.startswith(RB_PREFIX):
            name = name[len(RB_PREFIX):]
        return name.split(SNAP_SEP, 1)[0]

    def _split_pool_pgs(self, pool, old_num: int, new_num: int) -> None:
        """PG::split_into (PG.cc:578) re-designed for this store: move
        each object (with its companions) whose stable-mod placement
        under new_num leaves its parent into the child's shard
        collection, and partition the parent's PG log/missing by
        object the same way.  Children inherit the parent's
        last_update/log_tail, so auth-log election at the child's
        first peering prefers members holding split state."""
        from ceph_tpu_torch.ops.rjenkins import ceph_str_hash_rjenkins
        from ceph_tpu_torch.osd.osdmap import _calc_mask, ceph_stable_mod
        from ceph_tpu_torch.osd.pg_log import PGInfo

        # total-order barrier: the split both READS pgmeta from the
        # store and re-stages it, so any client txn still in the
        # group-commit window must land first — and because this
        # function never awaits, nothing can slip into the window
        # while it runs
        self.committer.flush_sync()
        mask = _calc_mask(new_num)
        if pool.type == TYPE_ERASURE:
            shard_list = list(
                range(self._codec(pool.id).get_chunk_count()))
        else:
            shard_list = [-1]

        def child_ps_of(head: str) -> int:
            return ceph_stable_mod(
                ceph_str_hash_rjenkins(head.encode()), new_num, mask)

        for ps in range(old_num):
            parent = PgId(pool.id, ps)
            for shard in shard_list:
                cid = self._cid(parent, shard)
                if not self.store.collection_exists(cid):
                    continue
                plog = PGLog.load(self.store, cid)
                moves: Dict[int, List[str]] = {}
                for o in self.store.list_objects(cid):
                    name = str(o)
                    if name == PGMETA_OID:
                        continue
                    cps = child_ps_of(self._head_name(name))
                    if cps != ps:
                        moves.setdefault(cps, []).append(name)
                child_entries: Dict[int, List[dict]] = {}
                keep_entries = []
                for e in plog.entries:
                    cps = child_ps_of(self._head_name(e.get("oid", "")))
                    if cps == ps:
                        keep_entries.append(e)
                    else:
                        child_entries.setdefault(cps, []).append(e)
                child_missing: Dict[int, Dict[str, tuple]] = {}
                keep_missing = {}
                for oid, v in plog.missing.items():
                    cps = child_ps_of(self._head_name(oid))
                    if cps == ps:
                        keep_missing[oid] = v
                    else:
                        child_missing.setdefault(cps, {})[oid] = v
                touched = (set(moves) | set(child_entries)
                           | set(child_missing))
                if not touched:
                    continue
                t = Transaction()
                for cps in touched:
                    ccid = self._cid(PgId(pool.id, cps), shard)
                    if not self.store.collection_exists(ccid):
                        t.create_collection(ccid)
                    for name in moves.get(cps, []):
                        t.collection_move_rename(
                            cid, ObjectId(name), ccid, ObjectId(name))
                    clog = PGLog(
                        PGInfo(last_update=plog.info.last_update,
                               log_tail=plog.info.log_tail),
                        child_entries.get(cps, []),
                        child_missing.get(cps, {}))
                    clog.stage(t, ccid)
                plog.entries = keep_entries
                plog.missing = keep_missing
                plog.stage(t, cid)
                self.store.queue_transaction(t)
                log.info("osd.%d: split %s shard %s: %d objects to %d"
                         " children", self.osd_id, parent, shard,
                         sum(len(v) for v in moves.values()),
                         len(touched))
            # parent's cached log is stale after the partition
            ps_state = self.pgs.get(parent)
            if ps_state is not None:
                ps_state.log = None
        for cps in range(old_num, new_num):
            child = PgId(pool.id, cps)
            self._split_children.add(child)
            cstate = self.pgs.get(child)
            if cstate is not None:
                cstate.log = None

    def _post_map_epoch(self, prev_up: Set[int]) -> None:
        """Per-epoch bookkeeping after the local map advanced."""
        self._check_pool_splits()
        # reset the heartbeat clock for peers that just came (back) up:
        # their last_rx predates the outage and would otherwise make us
        # insta-report the freshly booted peer as failed again
        # (maybe_update_heartbeat_peers role, OSD.cc)
        now = time.monotonic()
        for osd in self.osdmap.get_up_osds():
            if osd not in prev_up:
                self._hb_last_rx[osd] = now
        self._map_event.set()
        self._map_event = asyncio.Event()
        # falsely marked down while alive: re-boot (MOSDAlive role).
        # NOT while heartbeat-muted — an injected heartbeat outage must
        # look dead to the cluster, so re-booting through it would
        # defeat the injection (recovery happens when the mute expires)
        if not self.osdmap.is_up(self.osd_id) and not self._stopping \
                and now >= self._hb_mute_until \
                and self.msgr.addr and \
                time.monotonic() - self._last_boot_sent > 1.0:
            self._last_boot_sent = time.monotonic()
            self.msgr._spawn(self.msgr.send_to(
                self.mon_addr, MOSDBoot(self.osd_id, self.msgr.addr)))
        self._scan_pgs()

    def _scan_pgs(self) -> None:
        """Map epoch changed: find my PGs, detect interval changes,
        kick peering where I'm primary (the load_pgs/advance_pg role)."""
        for pool in self.osdmap.pools.values():
            for ps_num in range(pool.pg_num):
                pg = PgId(pool.id, ps_num)
                acting, primary = self.osdmap.pg_to_acting_osds(pg)
                in_acting = self.osd_id in [
                    o for o in acting if o != CRUSH_ITEM_NONE]
                state = self.pgs.get(pg)
                if state is None:
                    if not in_acting:
                        continue
                    state = PGState(pg)
                    self.pgs[pg] = state
                if state.acting != acting or state.primary != primary:
                    # every member records EVERY membership change —
                    # including intervals it is not part of.  Skipping
                    # the not-in-acting epochs would make a member that
                    # leaves and rejoins with identical membership see
                    # "no change" and keep an interval stamp its peers
                    # have long fenced off.  Deterministic because
                    # _handle_map advances epoch by epoch, so all
                    # daemons observe the same acting-change epochs
                    # (same_interval_since discipline).
                    state.acting = acting
                    state.primary = primary
                    state.interval_epoch = self.osdmap.epoch
                    state.state = "inactive"
                    state.active_event.clear()
                    # primary-side extent cache and read tier are only
                    # coherent within one interval — a new primary may
                    # have applied writes this daemon never saw
                    state.extent_cache.clear()
                    self.tier.drop_pg(pg)
                    if state.peering_task is not None:
                        state.peering_task.cancel()
                        state.peering_task = None
                    if state._unfound_retry is not None:
                        state._unfound_retry.cancel()
                        state._unfound_retry = None
                if not in_acting:
                    state.state = "inactive"
                    state.active_event.clear()
                    if state.peering_task is not None:
                        state.peering_task.cancel()
                        state.peering_task = None
                    continue
                if primary == self.osd_id and state.peering_task is None \
                        and (state.state == "inactive" or
                             (state.state == "active" and state.unfound)):
                    # an unfound-carrying PG re-peers on ANY map change:
                    # a revived stray may now hold the needed shards
                    state.state = "peering"
                    state.active_event.clear()
                    state.peering_task = \
                        asyncio.get_running_loop().create_task(
                            self._peer_pg(state, pool))
                self._note_trim_candidates(state, pool)

    # -- heartbeats --------------------------------------------------------

    async def _handle_ping(self, conn: Connection, msg: MPing) -> None:
        if time.monotonic() < self._hb_mute_until:
            return  # injected heartbeat failure: swallow pings silently
        if msg.from_osd >= 0:
            self._hb_last_rx[msg.from_osd] = time.monotonic()
        if msg.kind == PING:
            await conn.send(MPing(PING_REPLY, msg.stamp,
                                  epoch=self._epoch(),
                                  from_osd=self.osd_id))

    def _epoch(self) -> int:
        return self.osdmap.epoch if self.osdmap is not None else 0

    def _heartbeat_peers(self) -> Set[int]:
        """Bounded peer set (OSD.cc maybe_update_heartbeat_peers role):
        OSDs sharing a PG with me, plus my ring neighbors in the sorted
        up set so detection coverage stays connected, capped at
        osd_heartbeat_max_peers.  The full N x N mesh is quadratic
        traffic and saturates loops past ~8 daemons."""
        pg_peers: Set[int] = set()
        for state in self.pgs.values():
            for osd in state.acting:
                if osd != CRUSH_ITEM_NONE and osd != self.osd_id:
                    pg_peers.add(osd)
        ring: Set[int] = set()
        up = [o for o in self.osdmap.get_up_osds() if o != self.osd_id]
        if up:
            # ring neighbors by rank around my id
            pos = bisect.bisect_left(up, self.osd_id)
            ring.add(up[pos % len(up)])
            ring.add(up[(pos - 1) % len(up)])
        cap = int(self.config.get("osd_heartbeat_max_peers", 10))
        pg_peers = {p for p in pg_peers
                    if self.osdmap.is_up(p) and p not in ring}
        # the cap trims only the PG-peer overflow — ring neighbors are
        # the connectedness guarantee (a naive global sort-and-truncate
        # would leave the highest-id OSDs unmonitored by everyone)
        keep = max(0, cap - len(ring))
        if len(pg_peers) > keep:
            pg_peers = set(sorted(pg_peers)[:keep])
        return ring | pg_peers

    async def _heartbeat_loop(self) -> None:
        interval = self.config["osd_heartbeat_interval"]
        grace = self.config["osd_heartbeat_grace"]
        while not self._stopping:
            await asyncio.sleep(interval)
            try:
                await self._heartbeat_once(interval, grace)
            except asyncio.CancelledError:
                raise
            except Exception:
                # this loop carries failure detection AND the mon-
                # subscription keepalive: one bad iteration must
                # never kill it for the daemon's lifetime (a silent
                # death here recreates the mapless-zombie wedge)
                log.exception("osd.%d: heartbeat iteration failed",
                              self.osd_id)

    async def _heartbeat_once(self, interval: float,
                              grace: float) -> None:
        now = time.monotonic()
        # mon session keepalive: a restarted mon loses subscriber
        # connections silently, and a BOOT whose subscription
        # sends were injected/faulted away leaves this daemon
        # mapless — in both cases maps go quiet.  This check runs
        # BEFORE the mapless guard below: osdmap None is the
        # WORST staleness, not an exemption (a zombie OSD that
        # never re-subscribes wedges recovery cluster-wide; found
        # by the injection thrasher).
        if now - self._last_map_rx > max(5.0, 4 * interval):
            self._last_map_rx = now
            epoch = self.osdmap.epoch if self.osdmap else 0
            # a MAPLESS renew is abnormal (boot subscription
            # lost); a steady-state renew on an idle cluster is
            # routine and must not spam the log
            (log.info if epoch == 0 else log.debug)(
                "osd.%d: mon quiet at epoch %s; re-subscribing",
                self.osd_id, epoch or "none")
            # hunt: rotating through the monmap finds a serving
            # peer behind a dead mon / dropped conn
            self._hunt_mon()
            try:
                await self.msgr.send_to(
                    self.mon_addr,
                    MGetMap(since_epoch=epoch, subscribe=True))
                if self.osdmap is None and self.msgr.addr:
                    # never booted into the map either: the mon
                    # may not know this daemon exists at all
                    await self.msgr.send_to(
                        self.mon_addr,
                        MOSDBoot(self.osd_id, self.msgr.addr))
            except (ConnectionError, OSError):
                pass  # this mon down too; next cycle hunts on
        if self.osdmap is None:
            return
        # one-shot injected heartbeat outage
        # (heartbeat_inject_failure = seconds of silence): mute
        # pings AND replies for that long, then self-clear.  Peers
        # see a dead heartbeat surface on a live daemon — exactly
        # the failure the mon's reporter quorum must adjudicate.
        inj = float(self.config.get(
            "heartbeat_inject_failure", 0) or 0)
        if inj > 0 and now >= self._hb_mute_until:
            self.config["heartbeat_inject_failure"] = 0
            self._hb_mute_until = now + inj
            log.warning("osd.%d: injecting %.1fs heartbeat"
                        " failure", self.osd_id, inj)
        if now < self._hb_mute_until:
            self._hb_resume_stale = True
            return
        if getattr(self, "_hb_resume_stale", False):
            # coming out of a mute: every peer timestamp is stale by
            # the mute length — restart the clocks or this daemon
            # would instantly (and falsely) report every peer failed
            self._hb_resume_stale = False
            self._hb_last_rx.clear()
            # and if the outage got us (rightly) marked down, no map
            # event will re-fire the MOSDAlive path — re-boot now
            if not self.osdmap.is_up(self.osd_id) and self.msgr.addr:
                self._last_boot_sent = now
                try:
                    await self.msgr.send_to(
                        self.mon_addr,
                        MOSDBoot(self.osd_id, self.msgr.addr))
                except (ConnectionError, OSError):
                    pass
        self.op_tracker.check_slow()
        peers = self._heartbeat_peers()
        # prune state for ex-peers so a later re-add restarts fresh
        for gone in set(self._hb_last_rx) - peers:
            self._hb_last_rx.pop(gone, None)

        async def ping_one(peer: int) -> None:
            addr = self.osdmap.osd_addrs.get(peer)
            if addr is None:
                return
            self._hb_last_rx.setdefault(peer, now)
            try:
                await self.msgr.send_to(
                    addr, MPing(PING, now, epoch=self._epoch(),
                                from_osd=self.osd_id))
            except (ConnectionError, OSError):
                pass
            elapsed = now - self._hb_last_rx[peer]
            if elapsed > grace:
                # report to mon (send_failures, OSD.cc:5889)
                try:
                    await self.msgr.send_to(
                        self.mon_addr,
                        MOSDFailure(peer, self.osd_id, elapsed,
                                    self._epoch()))
                except (ConnectionError, OSError):
                    pass

        await asyncio.gather(*(ping_one(p) for p in peers))

    # -- local shard store helpers -----------------------------------------

    def _cid(self, pg: PgId, shard: int) -> str:
        return shard_collection(pg, shard)

    def _load_log(self, state: PGState, pool) -> PGLog:
        if state.log is None:
            shard = state.my_shard(self.osd_id, pool.type)
            state.log = PGLog.load(self.store, self._cid(state.pg, shard))
        return state.log

    def _apply_shard_ops(self, t: Transaction, cid: str, oid: str,
                         ops: List[ShardOp],
                         save_rollback: bool = False) -> None:
        obj = ObjectId(oid)
        if not self.store.collection_exists(cid):
            t.create_collection(cid)
        if save_rollback:
            # preserve the current generation before overwriting: until
            # this write commits on every shard, the previous version
            # must stay reconstructable
            try:
                self.store.stat(cid, obj)
            except (KeyError, IOError):
                pass
            else:
                t.clone(cid, obj, ObjectId(RB_PREFIX + oid))
        for op in ops:
            if op.op == "create":
                t.touch(cid, obj)
            elif op.op == "truncate":
                t.truncate(cid, obj, op.size)
            elif op.op == "write":
                t.write(cid, obj, op.offset, len(op.data), op.data)
            elif op.op == "setattr":
                t.setattr(cid, obj, op.name, op.value)
            elif op.op == "rmattr":
                t.rmattr(cid, obj, op.name)
            elif op.op == "omap_set":
                t.omap_setkeys(cid, obj, decode_kv_map(op.data))
            elif op.op == "omap_rm":
                t.omap_rmkeys(cid, obj, decode_str_list(op.data))
            elif op.op == "omap_clear":
                t.omap_clear(cid, obj)
            elif op.op == "remove":
                t.remove(cid, obj)
                # the rollback clone goes with it: a deleted object
                # whose clone survives is RESURRECTABLE — the
                # rollback-aware recovery gather would reassemble the
                # pre-remove generation from k surviving clones and
                # reinstall an object the client was told is gone
                t.remove(cid, ObjectId(RB_PREFIX + oid))
            elif op.op == "clone":
                # snapshot clone-on-write (make_writeable role): copy
                # the shard's CURRENT state to the clone object.  A
                # shard that doesn't hold the object yet (degraded)
                # simply skips — recovery will reconstruct the clone.
                try:
                    self.store.stat(cid, obj)
                except (KeyError, IOError):
                    pass
                else:
                    t.clone(cid, obj, ObjectId(op.name))
            else:
                raise ValueError(f"unknown shard op {op.op!r}")

    def _read_shard(self, pg: PgId, shard: int, oid: str,
                    offset: int = 0, length: int = 0
                    ) -> Tuple[int, bytes, Dict[str, bytes]]:
        """Local shard read with attrs; rc<0 on missing/corrupt.
        offset/length push the range down to the STORE so a ranged read
        costs O(range) of store I/O, not O(shard)."""
        cid = self._cid(pg, shard)
        obj = ObjectId(oid)
        try:
            data = self.store.read(cid, obj, offset, length)
            attrs = self.store.getattrs(cid, obj)
        except KeyError:
            return ENOENT, b"", {}
        except IOError:
            return EIO, b"", {}
        return 0, data, attrs

    # -- sub-ops (replica side) --------------------------------------------

    async def _handle_sub_write(self, conn: Connection,
                                msg: MOSDSubWrite) -> None:
        if msg.trace is not None:
            # tracer.span installs the span as current: the replica-
            # side stage spans below (kv_commit/fsync in the store,
            # contended objlock) attach to THIS tree — the place the
            # write actually pays its durability cost must not render
            # as an opaque span
            async with self.tracer.span(
                    f"sub_write {msg.oid} shard {msg.shard}",
                    context=msg.trace):
                await self._handle_sub_write_inner(conn, msg)
            return
        await self._handle_sub_write_inner(conn, msg)

    async def _handle_sub_write_inner(self, conn: Connection,
                                      msg: MOSDSubWrite) -> None:
        state = self.pgs.get(msg.pg)
        # fencing: a primary from an older interval must not mutate
        if state is not None and msg.epoch < state.interval_epoch:
            log.debug("osd.%d: sub-write %s/%s fenced: epoch %d <"
                      " interval %d", self.osd_id, msg.pg, msg.oid,
                      msg.epoch, state.interval_epoch)
            await conn.send(MOSDSubWriteReply(msg.tid, ESTALE, msg.shard))
            return
        if state is not None:
            # a newer-interval primary's write also fences older ones
            state.interval_epoch = max(state.interval_epoch, msg.epoch)
        pool = self.osdmap.pools.get(msg.pg.pool) if self.osdmap else None
        cid = self._cid(msg.pg, msg.shard)
        if state is None:
            state = self.pgs.setdefault(msg.pg, PGState(msg.pg))
        try:
            # dispatch is concurrent per message, so two sub-writes to
            # one object can otherwise apply OUT OF ORDER — a delayed
            # older write overwriting a newer one leaves stale data
            # under a current-looking log (the reference's sequential
            # per-PG op queue makes this impossible; here the object
            # lock + version monotonicity restores it)
            async with state.obj_lock(f"sub\x00{msg.shard}\x00"
                                      f"{msg.oid}"):
                if pool is not None:
                    plog = self._load_log(state, pool)
                else:
                    plog = state.log or PGLog()
                    state.log = plog
                # version floor = newer of (stored OI, newest PG
                # log entry for this object).  The log term is
                # load-bearing after a DELETE: the remove erases
                # the object's own version history, and without it
                # a straggler sub-write of an older write would
                # silently RESURRECT the deleted object.
                def current_floor() -> Optional[tuple]:
                    floor = self._oi_version(
                        self._read_shard(msg.pg, msg.shard, msg.oid,
                                         0, 1)[2])
                    for le in reversed(plog.entries):
                        if le.get("oid") == msg.oid:
                            lv = ev(le["version"])
                            if floor is None or lv > floor:
                                floor = lv
                            break
                    return floor

                if msg.log_entry is not None:
                    # CLIENT write ordering guard
                    incoming = self._sub_write_version(msg)
                    floor = current_floor() \
                        if incoming is not None else None
                    if incoming is not None and floor is not None \
                            and incoming < floor:
                        # a late straggler that already lost the race:
                        # the newer state supersedes it — ack without
                        # applying (idempotent-outcome discipline).
                        # The reply is sent OUTSIDE the lock: a send
                        # wedged on a dead peer must never park this
                        # (shard, object)'s write lock.
                        raise _SkipApply()
                elif msg.oid not in plog.missing:
                    # RECOVERY/REPAIR sub-write (no log entry) to an
                    # object this shard is NOT missing.  Legitimate
                    # below-floor installs (divergent rewind, rollback
                    # reinstall) always target objects in the missing
                    # set; outside it, a below-floor install is a stale
                    # push — one that timed out at the primary, stayed
                    # in flight, and was overtaken by a newer client
                    # write — and applying it would silently roll this
                    # copy back under a current-looking PG log.  The
                    # guard token decides: the push applies only if the
                    # plan OBSERVED (adjudicated over) this shard's
                    # current state.  Covers removes too: a stale
                    # rollback-purge remove must not destroy an object
                    # a client has since recreated.
                    floor = current_floor()
                    if floor is not None:
                        rec_v = self._sub_write_version(msg)
                        observed = msg.guard is not None and \
                            msg.guard >= floor
                        if rec_v is not None:
                            if rec_v < floor and not observed:
                                raise _SkipApply()
                        elif any(op.op == "remove" for op in msg.ops):
                            # includes rollback trims: guard=prior keeps
                            # a stale trim from eating the FRESH clone a
                            # later write just preserved
                            if not observed:
                                raise _SkipApply()
                t = Transaction()
                self._apply_shard_ops(
                    t, cid, msg.oid, msg.ops,
                    save_rollback=msg.log_entry is not None)
                if msg.log_entry is not None:
                    version = ev(msg.log_entry["version"])
                    if version > plog.info.last_update:
                        plog.append(msg.log_entry)
                        plog.trim_to(
                            int(self.config["osd_min_pg_log_entries"]))
                # a write (client or recovery push) fills the object in
                if msg.log_entry is None and msg.oid in plog.missing:
                    self.perf["recovery_installs"] += 1
                plog.missing.pop(msg.oid, None)
                plog.stage(t, cid)
                # replica-side group commit: concurrent sub-writes on
                # this shard share one barrier (safe under the
                # per-(shard,object) lock — the await resolves only
                # when THIS txn is durable, so acks stay honest)
                await self.committer.queue_transaction(t)
        except _SkipApply:
            pass
        except Exception:
            log.exception("osd.%d: sub-write %s/%s failed",
                          self.osd_id, msg.pg, msg.oid)
            await conn.send(MOSDSubWriteReply(msg.tid, EIO, msg.shard))
            return
        await conn.send(MOSDSubWriteReply(msg.tid, 0, msg.shard))

    @staticmethod
    def _sub_write_version(msg: MOSDSubWrite) -> Optional[tuple]:
        """The object generation this sub-write installs: the log
        entry's version (client writes) or the OI attr riding the ops
        (recovery installs); None for version-less ops (remove,
        attr-only tweaks) which must always apply."""
        if msg.log_entry is not None:
            return ev(msg.log_entry["version"])
        for op in msg.ops:
            if op.op == "setattr" and op.name == OI_ATTR:
                try:
                    v = json.loads(op.value).get("version")
                    return ev(v) if v else None
                except (ValueError, AttributeError):
                    return None
        return None

    async def _handle_sub_read(self, conn: Connection,
                               msg: MOSDSubRead) -> None:
        if getattr(msg, "trace", None) is not None:
            # tracer.span installs the span as current so replica-side
            # annotations (tier recording, store spans) land in this
            # tree
            async with self.tracer.span(
                    f"sub_read {msg.oid} shard {msg.shard}",
                    context=msg.trace):
                await self._handle_sub_read_inner(conn, msg)
            return
        await self._handle_sub_read_inner(conn, msg)

    async def _handle_sub_read_inner(self, conn: Connection,
                                     msg: MOSDSubRead) -> None:
        state = self.pgs.get(msg.pg)
        pool = self.osdmap.pools.get(msg.pg.pool) if self.osdmap else None
        if self.tier.enabled and state is not None and \
                getattr(msg, "record", False) and \
                not is_internal_name(msg.oid) and \
                msg.oid != PGMETA_OID:
            # replica-side hot-set observability for CLIENT reads only
            # (msg.record rides from the primary's _op_read gather);
            # scrub/recovery/stat sub-reads would drown the skew
            # signal.  Promotion decisions stay with the primary's
            # own hitset.
            self.tier.record_read(msg.pg, msg.oid)
            if self.tier.sealed_pending():
                self._persist_sealed_hitsets()
        if state is not None and pool is not None:
            plog = self._load_log(state, pool)
            # the missing guard protects my CURRENT shard only; stray
            # reads of prior-interval shard collections are always fair
            # game (they serve the MissingLoc search)
            if msg.shard == state.my_shard(self.osd_id, pool.type) and \
                    msg.oid in plog.missing:
                await conn.send(MOSDSubReadReply(
                    msg.tid, ENOENT, shard=msg.shard))
                return
        if getattr(msg, "repair", None) is not None:
            await self._answer_repair_read(conn, msg, pool)
            return
        rc, data, attrs = self._read_shard(
            msg.pg, msg.shard, msg.oid,
            msg.offset if msg.length else 0, msg.length)
        omap: Dict[str, bytes] = {}
        if rc == 0 and msg.want_omap:
            try:
                omap = self.store.omap_get(
                    self._cid(msg.pg, msg.shard), ObjectId(msg.oid))
            except (KeyError, IOError):
                omap = {}
        await conn.send(MOSDSubReadReply(
            msg.tid, rc, data, attrs if msg.want_attrs else {},
            shard=msg.shard, omap=omap))

    async def _answer_repair_read(self, conn: Connection,
                                  msg: MOSDSubRead, pool) -> None:
        """Helper side of regenerating-code repair: read my full
        chunk, project it against the codec's repair vector for the
        lost chunk, ship the beta = chunk/alpha byte fragment.  Any
        mismatch with the primary's view of the codec (no fractional
        repair, alpha drift, misaligned chunk) answers EOPNOTSUPP —
        the primary treats that helper as failed and, past d
        survivors, falls back to the classic k-read path."""
        lost, alpha = msg.repair
        rc, data, attrs = self._read_shard(msg.pg, msg.shard, msg.oid,
                                           0, 0)
        if rc == 0:
            codec = self._codec(pool.id) if pool is not None else None
            if codec is None or \
                    not getattr(codec, "supports_fractional_repair",
                                lambda: False)() or \
                    codec.get_sub_chunk_count() != alpha or \
                    len(data) % max(alpha, 1):
                rc, data = EOPNOTSUPP, b""
            else:
                try:
                    frag = await asyncio.to_thread(
                        codec.repair_project, lost, data)
                    self.perf["repair_fragments"] += 1
                    data = frag
                except Exception:
                    rc, data = EOPNOTSUPP, b""
        await conn.send(MOSDSubReadReply(
            msg.tid, rc, data if rc == 0 else b"",
            attrs if msg.want_attrs and rc == 0 else {},
            shard=msg.shard))

    # -- peering -----------------------------------------------------------

    async def _handle_pg_query(self, conn: Connection,
                               msg: MPGQuery) -> None:
        pool = self.osdmap.pools.get(msg.pg.pool) if self.osdmap else None
        state = self.pgs.setdefault(msg.pg, PGState(msg.pg))
        # answering a peering query is a BARRIER: once we reply, no
        # older-interval primary may commit further writes here, or the
        # new interval could roll back an acked write (the PeeringState
        # Reset discipline — the reply's content must stay authoritative)
        state.interval_epoch = max(state.interval_epoch, msg.epoch)
        if msg.shard is not None:
            # explicit-shard query (split-child stray sweep): answer
            # from that shard's collection directly — a stray cannot
            # be located through an acting set it is not part of
            shard = msg.shard
            plog = PGLog.load(self.store,
                              self._cid(msg.pg, shard))
        else:
            shard = state.my_shard(self.osd_id, pool.type) if pool \
                else -1
            if pool is not None:
                plog = self._load_log(state, pool)
            else:
                plog = state.log or PGLog()
        info = plog.info.to_dict()
        info["missing"] = {k: list(v) for k, v in plog.missing.items()}
        # shard object listing rides along so the primary can build
        # backfill sets for peers too far behind the log tail
        info["objects"] = self._list_shard_objects(msg.pg, shard)
        await conn.send(MPGLogMsg(msg.tid, msg.pg, shard, info,
                                  list(plog.entries),
                                  epoch=self._epoch(),
                                  from_osd=self.osd_id, is_reply=True))

    def _list_shard_objects(self, pg: PgId, shard: int) -> List[str]:
        cid = self._cid(pg, shard)
        try:
            return sorted(str(o) for o in self.store.list_objects(cid)
                          if str(o) != PGMETA_OID
                          and not str(o).startswith(RB_PREFIX))
        except KeyError:
            return []

    async def _handle_pg_log_push(self, conn: Connection,
                                  msg: MPGLogMsg) -> None:
        """Primary pushed the authoritative log: merge + rewind, persist,
        reply with my resulting missing set."""
        from ceph_tpu_torch.osd.pg_log import PGInfo

        pool = self.osdmap.pools.get(msg.pg.pool) if self.osdmap else None
        state = self.pgs.setdefault(msg.pg, PGState(msg.pg))
        if pool is None:
            return
        state.interval_epoch = max(state.interval_epoch, msg.epoch)
        plog = self._load_log(state, pool)
        auth_info = PGInfo.from_dict(msg.info)
        missing = plog.merge(auth_info, msg.entries)
        # keep pre-existing missing entries not superseded by the merge
        for oid, need in list(plog.missing.items()):
            missing.setdefault(oid, need)
        plog.missing = missing
        cid = self._cid(msg.pg, msg.shard)
        t = Transaction()
        if not self.store.collection_exists(cid):
            t.create_collection(cid)
        plog.stage(t, cid)
        # peering barrier: the adopted log must not reorder around an
        # open group-commit window (commit_now drains, then commits)
        await self.committer.commit_now(t)
        info = plog.info.to_dict()
        info["missing"] = {k: list(v) for k, v in plog.missing.items()}
        await conn.send(MPGLogMsg(msg.tid, msg.pg, msg.shard, info, [],
                                  epoch=self._epoch(),
                                  from_osd=self.osd_id, is_reply=True))

    async def _peer_pg(self, state: PGState, pool) -> None:
        """Primary peering: GetInfo/GetLog -> auth election -> push ->
        missing -> recover -> active."""
        pg = state.pg
        try:
            my_shard = state.my_shard(self.osd_id, pool.type)
            plog = self._load_log(state, pool)
            # 1. collect infos+logs(+object listings) from up shards
            peers: Dict[int, tuple] = {}
            peers[my_shard] = (plog.info, list(plog.entries),
                               dict(plog.missing),
                               self._list_shard_objects(pg, my_shard))
            peer_shards: Dict[int, int] = {}  # shard -> osd
            for idx, osd in enumerate(state.acting):
                shard = idx if pool.type == TYPE_ERASURE else -1
                if osd == CRUSH_ITEM_NONE or osd == self.osd_id or \
                        not self.osdmap.is_up(osd):
                    continue
                if pool.type == TYPE_REPLICATED and shard == -1:
                    shard_key = -(idx + 2)  # unique key per replica
                else:
                    shard_key = shard
                tid = self._next_tid()
                # the query carries the INTERVAL epoch, not the live
                # one: replies to it are the interval barrier, and
                # sub-writes of this interval are stamped with the same
                # value so they pass the fence the barrier establishes
                reply = await self._request(
                    osd, MPGQuery(tid, pg, state.interval_epoch,
                                  self.osd_id), tid)
                if reply is None or reply.pg != pg:
                    continue
                from ceph_tpu_torch.osd.pg_log import PGInfo

                info = PGInfo.from_dict(reply.info)
                peer_missing = {k: ev(v) for k, v in
                                reply.info.get("missing", {}).items()}
                peers[shard_key] = (info, reply.entries, peer_missing,
                                    reply.info.get("objects", []))
                peer_shards[shard_key] = osd
            if pg in self._split_children:
                # split child: its data was minted on the PARENT's
                # members, which this acting mapping knows nothing
                # about.  One exhaustive (up-OSDs x shards) info/log
                # sweep lets the auth election see the split state;
                # per-object recovery already probes strays.  (The
                # reference instead instantiates children directly on
                # the parent's OSDs; this sweep is the asyncio-shaped
                # equivalent, paid only at the first post-split
                # peering.)
                await self._sweep_split_strays(state, pool, peers,
                                               peer_shards)
            # pre-merge heads: needed for the backfill decision below
            pre_lu = {k: v[0].last_update for k, v in peers.items()}
            # 2. elect authoritative log (max last_update, then longest)
            auth_key = max(
                peers,
                key=lambda s: (peers[s][0].last_update,
                               len(peers[s][1]),
                               s == my_shard))
            auth_info, auth_entries = peers[auth_key][0], \
                peers[auth_key][1]
            # 3. adopt locally if I'm not authoritative
            if auth_key != my_shard:
                my_missing = plog.merge(auth_info, auth_entries)
                for oid, need in my_missing.items():
                    plog.missing.setdefault(oid, need)
                cid = self._cid(pg, my_shard)
                t = Transaction()
                if not self.store.collection_exists(cid):
                    t.create_collection(cid)
                plog.stage(t, cid)
                # peering barrier: drain the window, commit inline
                await self.committer.commit_now(t)
            # 4. push auth log to peers; collect their missing sets
            state.peer_missing = {}
            auth_wire_info = plog.info.to_dict()
            for shard_key, osd in peer_shards.items():
                shard = shard_key if shard_key >= -1 else -1
                tid = self._next_tid()
                reply = await self._request(
                    osd, MPGLogMsg(tid, pg, shard, auth_wire_info,
                                   list(plog.entries),
                                   epoch=state.interval_epoch,
                                   from_osd=self.osd_id), tid)
                if reply is None or reply.pg != pg:
                    continue
                state.peer_missing[shard_key] = {
                    k: ev(v)
                    for k, v in reply.info.get("missing", {}).items()}
            # 4b. backfill: a shard whose pre-merge head predates the
            # auth log tail cannot be caught up by log replay — every
            # object in the auth shard's listing is potentially stale
            # (the scan-based backfill of PeeringState)
            tail = plog.info.log_tail
            if tail > ZERO:
                auth_objects = peers[auth_key][3]
                if auth_key != my_shard and pre_lu[my_shard] < tail:
                    for obj in auth_objects:
                        plog.missing.setdefault(obj, ZERO)
                for shard_key in peer_shards:
                    if pre_lu.get(shard_key, ZERO) < tail:
                        pm = state.peer_missing.setdefault(shard_key, {})
                        for obj in auth_objects:
                            pm.setdefault(obj, ZERO)
            # 5. recovery: self first, then peers
            await self._recover_pg(state, pool, peer_shards)
            # 6. activate (possibly with unfound objects: reads of those
            # fail until a map change brings a shard source back)
            state.unfound = bool(plog.missing) or \
                any(bool(m) for m in state.peer_missing.values())
            state.next_version = plog.info.last_update[1] + 1
            plog.info.same_interval_since = state.interval_epoch
            plog.info.last_epoch_started = self._epoch()
            state.state = "active"
            state.active_event.set()
            # a split child that peered once has adopted its state
            # from the parent's members; later peerings are normal
            if pg in self._split_children:
                self._split_children.discard(pg)
                self._save_split_meta()
            if state.unfound:
                self._clog("WRN", f"pg {pg} active with unfound"
                                  " objects (sources down?)")
                # leftover missing entries are not only map-change
                # driven: a recovery PUSH can fail on a transient
                # timeout with no interval change, and nothing else
                # would ever retry it — keep retrying in place with
                # backoff (the DoRecovery requeue discipline)
                self._schedule_unfound_retry(state, pool)
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("osd.%d: peering %s failed", self.osd_id, pg)
            state.state = "inactive"
            # retry: peering must not park the PG forever on a transient
            # failure (a peer bouncing mid-query)
            if not self._stopping:
                asyncio.get_running_loop().create_task(
                    self._retry_peering(state))
        finally:
            state.peering_task = None

    async def _sweep_split_strays(self, state: PGState, pool,
                                  peers: Dict[int, tuple],
                                  peer_shards: Dict[int, int]) -> None:
        """Collect split-child state from OUTSIDE the acting mapping:
        every up OSD is asked for every shard collection of this pg.
        Hits join the auth-log election under synthetic keys (never
        push/recovery targets — those stay acting-only; the per-object
        gather finds the stray payloads on its own)."""
        from ceph_tpu_torch.osd.pg_log import PGInfo

        pg = state.pg
        if pool.type == TYPE_ERASURE:
            shard_list = list(
                range(self._codec(pool.id).get_chunk_count()))
        else:
            shard_list = [-1]
        # my own non-acting shard collections (an ex-parent member's
        # parent-shard index need not match its child acting slot)
        my_shard = state.my_shard(self.osd_id, pool.type)
        for shard in shard_list:
            if shard == my_shard:
                continue
            cid = self._cid(pg, shard)
            if not self.store.collection_exists(cid):
                continue
            lplog = PGLog.load(self.store, cid)
            if lplog.info.last_update > ZERO:
                key = -(10_000 + self.osd_id * 64 + shard + 2)
                peers[key] = (lplog.info, list(lplog.entries),
                              dict(lplog.missing),
                              self._list_shard_objects(pg, shard))
        # (osd, shard) pairs already covered: the acting loop asked
        # each acting member for ITS OWN slot only — an acting member
        # may still hold split state under a DIFFERENT shard index
        # (its parent slot), so acting OSDs are swept for the others
        covered = {(osd, sk if sk >= -1 else -1)
                   for sk, osd in peer_shards.items()}
        covered |= {(self.osd_id, shard) for shard in shard_list}

        async def ask(osd: int, shard: int):
            tid = self._next_tid()
            reply = await self._request(
                osd, MPGQuery(tid, pg, state.interval_epoch,
                              self.osd_id, shard=shard), tid)
            return osd, shard, reply

        jobs = [ask(osd, shard)
                for osd in self.osdmap.get_up_osds()
                for shard in shard_list
                if (osd, shard) not in covered]
        results = await asyncio.gather(*jobs) if jobs else []
        for osd, shard, reply in results:
            if reply is None or reply.pg != pg:
                continue
            info = PGInfo.from_dict(reply.info)
            if info.last_update <= ZERO:
                continue  # nothing split onto this OSD
            key = -(10_000 + osd * 64 + shard + 2)
            peers[key] = (info, reply.entries,
                          {k: ev(v) for k, v in
                           reply.info.get("missing", {}).items()},
                          reply.info.get("objects", []))

    def _schedule_unfound_retry(self, state: PGState, pool) -> None:
        """Re-run recovery for an active PG that still carries missing
        entries, with backoff, until it drains or the interval moves
        on (then peering owns it again).  Armed from EVERY path that
        can leave entries behind without an interval change —
        activation, failed recovery pushes, scrub repairs."""
        interval = state.interval_epoch
        if state._unfound_retry is not None:
            return
        state.unfound = True

        def live_peers() -> Dict[int, int]:
            out: Dict[int, int] = {}
            for idx, osd in enumerate(state.acting):
                if osd == CRUSH_ITEM_NONE or osd == self.osd_id or \
                        not self.osdmap.is_up(osd):
                    continue
                out[idx if pool.type == TYPE_ERASURE
                    else -(idx + 2)] = osd
            return out

        async def retry() -> None:
            backoff = 1.0
            try:
                while not self._stopping and state.state == "active" \
                        and state.interval_epoch == interval \
                        and state.unfound:
                    await asyncio.sleep(backoff)
                    backoff = min(backoff * 2, 8.0)
                    if state.state != "active" or \
                            state.interval_epoch != interval:
                        return
                    plog = self._load_log(state, pool)
                    await self._recover_pg(state, pool, live_peers())
                    state.unfound = bool(plog.missing) or \
                        any(bool(m)
                            for m in state.peer_missing.values())
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("osd.%d: unfound retry of %s failed",
                              self.osd_id, state.pg)
            finally:
                state._unfound_retry = None

        state._unfound_retry = \
            asyncio.get_running_loop().create_task(retry())

    async def _retry_peering(self, state: PGState) -> None:
        await asyncio.sleep(0.5)
        if self._stopping or state.state != "inactive" or \
                state.peering_task is not None or self.osdmap is None:
            return
        pool = self.osdmap.pools.get(state.pg.pool)
        if pool is None or state.primary != self.osd_id:
            return
        state.state = "peering"
        state.peering_task = asyncio.get_running_loop().create_task(
            self._peer_pg(state, pool))

    # -- recovery ----------------------------------------------------------

    async def _read_candidates(
            self, pg: PgId, shard: int, osd: int, oid: str,
            include_rollback: bool,
            offset: int = 0, length: int = 0,
            record: bool = False
    ) -> Tuple[List[Tuple[int, bytes, Dict[str, bytes]]], bool]:
        """Read one (shard, osd)'s main object — and, when asked, its
        rollback generation — as selection candidates.  offset/length
        trim the shard payload to the requested chunk range (the
        get_want_to_read_shards range discipline).

        Second return: True iff every query got a DEFINITIVE answer
        (the copy exists, rc=0, or definitively does not, ENOENT).  A
        dead peer or transport failure is NOT evidence of absence —
        conflating the two is how acked writes get garbage-collected
        as "divergent creates" (the MissingLoc have-vs-unfound
        distinction, the reference's src/osd/MissingLoc.h)."""
        names = [oid]
        if include_rollback:
            names.append(RB_PREFIX + oid)
        out: List[Tuple[int, bytes, Dict[str, bytes]]] = []
        definitive = True
        for name in names:
            t0 = time.monotonic()
            if osd == self.osd_id:
                rc, data, at = self._read_shard(
                    pg, shard, name, offset if length else 0, length)
                # the local read feeds the EWMA too: self ranks by its
                # actual store latency, not a synthetic zero
                self.hedge.observe(osd, time.monotonic() - t0,
                                   ok=rc in (0, ENOENT))
                if rc == 0:
                    out.append((shard, data, at))
                elif rc != ENOENT:
                    definitive = False
                continue
            tid = self._next_tid()
            reply = await self._request(
                osd, MOSDSubRead(tid, pg, shard, name, offset, length,
                                 record=record and name == oid),
                tid)
            # every sub-read round trip feeds the per-peer latency
            # model; a timeout/fault charges the peer its full cost
            # and trips its breaker toward rank-last.  A fast reply
            # carrying an ERROR rc (EIO from a dying store) is a
            # fault too — counting it a success would rank the peer
            # FASTEST while it serves nothing.  (A CANCELLED request
            # never reaches here — cancelled RTTs would poison the
            # model with the canceller's impatience.)
            self.hedge.observe(osd, time.monotonic() - t0,
                               ok=reply is not None
                               and reply.rc in (0, ENOENT))
            if reply is not None and reply.rc == 0:
                self.perf["subread_bytes"] += len(reply.data)
                out.append((shard, reply.data, reply.attrs))
            elif reply is None or reply.rc != ENOENT:
                definitive = False
        return out, definitive

    async def _gather_object_shards(
            self, state: PGState, pool, oid: str,
            exclude_missing: bool = True,
            include_rollback: bool = False,
            offset: int = 0, length: int = 0,
            record: bool = False,
            need: Optional[int] = None,
            verify_hinfo: bool = False,
            selection_out: Optional[list] = None
    ) -> Tuple[List[Tuple[int, bytes, Dict[str, bytes]]], bool]:
        """Collect available (shard, payload, attrs) candidates for an
        object from up acting shards, CONCURRENTLY (local read for mine,
        sub-reads for peers).  include_rollback adds each shard's
        preserved previous generation; offset/length restrict each
        shard's payload to a chunk range.

        need=k opts the gather into HEDGED mode (osd/hedge.py): the k
        fastest-ranked shards plus Δ speculative extras launch first,
        stragglers recruit spares at their peer's p95-EWMA mark, and
        the gather returns as soon as `need` DISTINCT shards agree on
        one version (_select_consistent with the same need/
        verify_hinfo the caller will apply) — stragglers are cancelled
        and awaited, never leaked.  Recovery/absence probes pass
        need=None and keep the exhaustive all-shard semantics.

        Second return: True iff every acting member was probed and
        answered definitively (a down member, failed query, or hedged
        early completion means the gather proves nothing about
        absence)."""
        pg = state.pg
        plog = self._load_log(state, pool)
        jobs: List[Tuple[int, Any]] = []
        complete = True
        for idx, osd in enumerate(state.acting):
            shard = idx if pool.type == TYPE_ERASURE else -1
            if osd == CRUSH_ITEM_NONE:
                continue
            if not self.osdmap.is_up(osd):
                if not self.osdmap.is_destroyed(osd):
                    complete = False
                continue
            if osd == self.osd_id and exclude_missing and \
                    oid in plog.missing:
                continue
            shard_key = idx if pool.type == TYPE_ERASURE else -(idx + 2)
            if exclude_missing and \
                    oid in state.peer_missing.get(shard_key, {}):
                # a copy scrub adjudicated bad (or a peer known to
                # lack the object) must never serve as a repair
                # source — the data stays on disk but is excluded
                # from selection
                continue

            def job(shard=shard, osd=osd):
                return self._read_candidates(
                    pg, shard, osd, oid, include_rollback, offset,
                    length, record=record)

            jobs.append((osd, job))
        sufficient = None
        if need is not None:
            # CRC verdicts memoized across the gather's completion
            # waves: the results list keeps every candidate alive, so
            # id(attrs) keys stay valid for the memo's whole lifetime
            hinfo_memo: Dict[int, bool] = {}

            def sufficient(results):
                cands = [c for sub, _ok in results for c in sub]
                sel = self._select_consistent(
                    cands, need=need, verify_hinfo=verify_hinfo,
                    hinfo_memo=hinfo_memo)
                if sel[0] is None:
                    return False
                # hand the winning (version, chosen, oi) back to the
                # caller: the accepting sufficient() call ran on
                # exactly the candidates being returned, so hedged
                # readers skip re-selecting (and re-verifying hinfo
                # CRCs over) the same payloads
                if selection_out is not None:
                    selection_out[:] = [sel]
                return True
        results, ran_all = await self.hedge.gather(
            jobs, need=need, sufficient=sufficient,
            failed=(lambda res: not res[0])
            if need is not None else None)
        complete = complete and ran_all and \
            all(ok for _sub, ok in results)
        return [c for sub, _ok in results for c in sub], complete

    async def _gather_and_select(
            self, state: PGState, pool, oid: str, *, need: int,
            verify_hinfo: bool = False, offset: int = 0,
            length: int = 0, record: bool = False
    ) -> Tuple[List[Tuple[int, bytes, Dict[str, bytes]]], bool,
               Optional[tuple], Dict[int, bytes], Optional[dict]]:
        """Hedged gather + consistent selection in ONE step:
        (candidates, complete, version, chosen, oi).  The selection
        from the gather's accepting sufficiency check is reused when
        the gather exited early (it ran on exactly the returned
        candidates) and recomputed otherwise (all-shard mode, kill
        switch, insufficient) — the reuse-or-recompute contract lives
        here once, not at every read site."""
        sel: list = []
        candidates, complete = await self._gather_object_shards(
            state, pool, oid, offset=offset, length=length,
            record=record, need=need, verify_hinfo=verify_hinfo,
            selection_out=sel)
        if not candidates:
            return [], complete, None, {}, None
        version, chosen, oi = sel[0] if sel else \
            self._select_consistent(candidates, need=need,
                                    verify_hinfo=verify_hinfo)
        return candidates, complete, version, chosen, oi

    async def _gather_stray_shards(
            self, state: PGState, pool, oid: str,
            have: Set[Tuple[int, int]],
            length: int = 0
    ) -> Tuple[List[Tuple[int, bytes, Dict[str, bytes]]], bool]:
        """Search shards OUTSIDE the acting mapping: prior-interval
        members may hold the only up-to-date copies after several
        remaps (the MissingLoc / might_have_unfound role,
        the reference's src/osd/MissingLoc.h).  Queries every up OSD for
        every shard collection of this pg not already in `have`
        ((shard, osd) pairs).

        Second return: True iff the search was EXHAUSTIVE — every OSD
        that could possibly hold a stray copy was probed and answered.
        Any down-but-existing OSD makes it False: it might be the sole
        holder of the newest acked write (might_have_unfound)."""
        pg = state.pg
        if pool.type == TYPE_ERASURE:
            shard_list = list(
                range(self._codec(pool.id).get_chunk_count()))
        else:
            shard_list = [-1]
        # a DESTROYED (`osd lost`) OSD is definitively absent by admin
        # decree — only plain-down OSDs leave the search inconclusive
        complete = all(self.osdmap.is_up(o) or self.osdmap.is_destroyed(o)
                       for o in range(self.osdmap.max_osd)
                       if self.osdmap.exists(o))
        jobs = [self._read_candidates(pg, shard, osd, oid,
                                      include_rollback=True,
                                      length=length)
                for osd in self.osdmap.get_up_osds()
                for shard in shard_list
                if (shard, osd) not in have]
        results = await asyncio.gather(*jobs) if jobs else []
        complete = complete and all(ok for _sub, ok in results)
        return [c for sub, _ok in results for c in sub], complete

    def _shard_rank(self, state: PGState):
        """Shard-index sort key fed by the hedge tracker's per-peer
        EWMAs: survivor-set choices (decode inputs, recovery's
        chosen-k) prefer shards whose source OSDs are currently
        fastest, degraded peers last.  The EWMA is quantized to
        OCTAVES here — the live model decays and takes samples
        between two calls in the same recovery wave, and a raw-float
        key would let that jitter normalize identical survivor sets
        differently and split decode_many's batches; only a genuine
        (2x) speed difference may reorder shards."""
        acting = list(state.acting)

        def key(shard: int) -> tuple:
            osd = acting[shard] if 0 <= shard < len(acting) \
                else CRUSH_ITEM_NONE
            if osd == CRUSH_ITEM_NONE:
                return (2, 1 << 30, shard)
            degraded, ewma, _osd = self.hedge.rank_key(osd)
            return (degraded, int(math.log2(max(ewma, 1e-6))), shard)

        return key

    @staticmethod
    def _oi_version(at: Dict[str, bytes]) -> Optional[tuple]:
        try:
            oi = json.loads(at[OI_ATTR])
            version = oi.get("version")
            return ev(version) if version else ZERO
        except (KeyError, ValueError):
            return None

    def _select_consistent(
            self, candidates: List[Tuple[int, bytes, Dict[str, bytes]]],
            need: int, verify_hinfo: bool = False,
            hinfo_memo: Optional[Dict[int, bool]] = None
    ) -> Tuple[Optional[tuple], Dict[int, bytes], Optional[dict]]:
        """Newest object version reconstructible from >= need distinct
        shards.

        Mixing shard generations corrupts EC decode and lets stale data
        win reads, so every multi-shard consumer picks ONE version: the
        newest one enough shards agree on.  An unacked write that
        reached < need shards is thereby rolled back to the last
        completed write (the role of ECBackend's rollback-aware log).
        Returns (version, {shard: payload}, object_info) or
        (None, {}, None).

        hinfo_memo (id(attrs) -> verdict) lets a caller that re-runs
        selection over a growing candidate list — the hedged gather's
        sufficiency check, once per completion wave — pay each
        payload's CRC verification once instead of once per wave.
        Only valid while the caller keeps the candidate tuples alive
        (id() reuse) and candidates are immutable, both true there.
        """
        groups: Dict[tuple, Dict[int, bytes]] = {}
        ois: Dict[tuple, dict] = {}
        for shard, payload, at in candidates:
            version = self._oi_version(at)
            if version is None:
                continue
            if verify_hinfo:
                if HINFO_ATTR not in at:
                    continue  # EC shard without its ledger: suspicious
                if hinfo_memo is None:
                    ok = _hinfo_chunk_ok(at, shard, payload)
                else:
                    ok = hinfo_memo.get(id(at))
                    if ok is None:
                        ok = hinfo_memo[id(at)] = _hinfo_chunk_ok(
                            at, shard, payload)
                if not ok:
                    continue  # corrupt shard: erasure
            groups.setdefault(version, {}).setdefault(shard, payload)
            ois.setdefault(version, json.loads(at[OI_ATTR]))
        for version in sorted(groups, reverse=True):
            members = groups[version]
            if len(members) >= need:
                return version, members, ois[version]
        return None, {}, None

    # -- snapshots (self-managed snaps, SnapMapper-lite) -------------------
    #
    # SnapSet JSON on every head shard (SS_ATTR): {"seq", "clones":
    # [{"cloneid", "snaps", "size"}]} — the object_snaps/SnapSet role
    # (the reference's src/osd/osd_types.h SnapSet,
    # src/osd/PrimaryLogPG.cc make_writeable).  Clone shard objects are
    # "<oid>\x16<cloneid>" in the same collections, recovered/backfilled
    # like any object.

    @staticmethod
    def _decode_ss(at: Dict[str, bytes]) -> Dict[str, Any]:
        try:
            return json.loads(at[SS_ATTR])
        except (KeyError, ValueError):
            return {"seq": 0, "clones": []}

    async def _head_info(self, state: PGState, pool, oid: str
                         ) -> Tuple[Optional[dict], Dict[str, Any]]:
        """(object_info | None, snapset) of the head via a 1-byte
        ranged gather (attrs ride along).  Raises UnfoundObject when
        the head exists per the log but no copy is locatable."""
        need = self._codec(pool.id).get_data_chunk_count() \
            if pool.type == TYPE_ERASURE else 1
        candidates, _complete, version, chosen, oi = \
            await self._gather_and_select(state, pool, oid,
                                          need=need, length=1)
        if not candidates:
            self._block_if_unfound(state, pool, oid)
            return None, {"seq": 0, "clones": []}
        if version is None:
            self._block_if_unfound(state, pool, oid)
            return None, {"seq": 0, "clones": []}
        self._require_fresh(state, pool, oid, version)
        src = next(iter(chosen))
        for shard, _payload, at in candidates:
            if shard == src and self._oi_version(at) == version:
                return oi, self._decode_ss(at)
        return oi, {"seq": 0, "clones": []}

    async def _snap_clone_prep(
            self, state: PGState, pool, oid: str,
            snapc_seq: int, snapc_snaps: List[int],
            head: Optional[Tuple[Optional[dict], Dict[str, Any]]] = None
    ) -> Tuple[List[ShardOp], Optional[bytes]]:
        """make_writeable: if the object predates the newest snap,
        emit clone ops (prepended to the write on every shard) and the
        updated SnapSet attr bytes.  Returns ([], None) when no snap
        bookkeeping applies to this write.  Callers that already hold
        the head's (oi, ss) pass them via `head` to skip the re-read
        (both reads happen under the same object lock)."""
        if snapc_seq <= 0:
            return [], None
        oi, ss = head if head is not None \
            else await self._head_info(state, pool, oid)
        # never mutate a caller-held SnapSet (the clones list would
        # alias through a shallow copy)
        ss = {**ss, "clones": list(ss.get("clones", []))}
        clone_ops: List[ShardOp] = []
        if oi is not None and not oi.get("whiteout") and \
                ss.get("seq", 0) < snapc_seq:
            covered = sorted(s for s in snapc_snaps
                             if s > ss.get("seq", 0))
            if covered:
                cloneid = covered[-1]
                clone_ops.append(
                    ShardOp("clone", name=clone_name(oid, cloneid)))
                ss.setdefault("clones", []).append(
                    {"cloneid": cloneid, "snaps": covered,
                     "size": oi.get("size", 0)})
        ss["seq"] = max(ss.get("seq", 0), snapc_seq)
        return clone_ops, json.dumps(ss).encode()

    async def _resolve_read_snap(self, state: PGState, pool, oid: str,
                                 snap_id: int) -> Optional[str]:
        """Map (oid, snap_id) -> the object holding that snap's data:
        the head (data unchanged since the snap) or a clone.  None =
        did not exist at that snap (PrimaryLogPG find_object_context
        snap resolution)."""
        oi, ss = await self._head_info(state, pool, oid)
        if oi is None and not ss.get("clones"):
            return None
        prev = 0
        for clone in sorted(ss.get("clones", []),
                            key=lambda c: c["cloneid"]):
            # a clone covers the snap range (prev_cloneid, cloneid],
            # but only the snaps RECORDED in it existed with this
            # object alive — a snap in the range but not in the list
            # predates the object's creation (ENOENT at that snap)
            if prev < snap_id <= clone["cloneid"]:
                if snap_id in clone["snaps"]:
                    return clone_name(oid, clone["cloneid"])
                return None
            prev = clone["cloneid"]
        if oi is not None and not oi.get("whiteout") and \
                snap_id > ss.get("seq", 0):
            # no write has landed since that snap: head IS the snap.
            # A snap <= seq with no covering clone predates the
            # object's creation (the head was first written under a
            # newer snap context) — ENOENT.
            return oid
        return None

    def _note_trim_candidates(self, state: PGState, pool) -> None:
        """Spawn a background trim when the pool's removed_snaps grew
        (the snap trim role; scan-based SnapMapper-lite)."""
        removed = set(getattr(pool, "removed_snaps", []))
        pending = removed - state.trimmed_snaps
        if not pending or state.primary != self.osd_id or \
                state.state != "active" or state.trim_task is not None:
            return
        state.trim_task = asyncio.get_running_loop().create_task(
            self._trim_pg_snaps(state, pool, pending))

    async def _trim_pg_snaps(self, state: PGState, pool,
                             pending: Set[int]) -> None:
        try:
            my_shard = state.my_shard(self.osd_id, pool.type)
            # heads only: clones carry a STALE SnapSet copied by the
            # store-level clone op and must never drive trim decisions
            heads = [name for name in
                     self._list_shard_objects(state.pg, my_shard)
                     if not is_internal_name(name)]
            for oid in heads:
                async with state.obj_lock(oid):
                    await self._trim_object(state, pool, oid, pending)
            state.trimmed_snaps |= pending
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("osd.%d: snap trim %s failed", self.osd_id,
                          state.pg)
        finally:
            state.trim_task = None
            # snaps removed WHILE this trim ran would otherwise wait
            # for an unrelated map change: re-check immediately
            if not self._stopping and self.osdmap is not None:
                cur = self.osdmap.pools.get(state.pg.pool)
                if cur is not None:
                    self._note_trim_candidates(state, cur)

    async def _trim_object(self, state: PGState, pool, oid: str,
                           pending: Set[int]) -> None:
        oi, ss = await self._head_info(state, pool, oid)
        clones = ss.get("clones", [])
        if not clones:
            return
        keep = []
        doomed = []
        for clone in clones:
            live = [s for s in clone["snaps"] if s not in pending]
            if live:
                clone["snaps"] = live
                keep.append(clone)
            else:
                doomed.append(clone)
        if not doomed:
            return
        ss["clones"] = keep
        n_shards = self._codec(pool.id).get_chunk_count() \
            if pool.type == TYPE_ERASURE else 1
        shards = range(n_shards) if pool.type == TYPE_ERASURE else [-1]
        for clone in doomed:
            entry = self._next_entry(
                state, pool, clone_name(oid, clone["cloneid"]),
                "delete")
            await self._submit_shard_writes(
                state, pool, clone_name(oid, clone["cloneid"]),
                {s: [ShardOp("remove")] for s in shards}, entry)
        if oi is not None and oi.get("whiteout") and not keep:
            # deleted head kept alive only for its clones: finish it
            entry = self._next_entry(state, pool, oid, "delete")
            await self._submit_shard_writes(
                state, pool, oid,
                {s: [ShardOp("remove")] for s in shards}, entry)
        elif oi is not None:
            entry = self._next_entry(state, pool, oid, "modify",
                                     oi.get("size", 0))
            ss_raw = json.dumps(ss).encode()
            await self._submit_shard_writes(
                state, pool, oid,
                {s: [ShardOp("setattr", name=SS_ATTR, value=ss_raw)]
                 for s in shards}, entry)

    async def _fetch_omap_any(self, state: PGState, pool, oid: str
                              ) -> Optional[Dict[str, bytes]]:
        """Best-effort omap fetch from any up holder (recovery needs
        the omap too, or a recovered replica silently loses it)."""
        plog = self._load_log(state, pool)
        if oid not in plog.missing:
            try:
                return self.store.omap_get(self._cid(state.pg, -1),
                                           ObjectId(oid))
            except (KeyError, IOError):
                pass
        for osd in state.acting:
            if osd == CRUSH_ITEM_NONE or osd == self.osd_id or \
                    not self.osdmap.is_up(osd):
                continue
            tid = self._next_tid()
            reply = await self._request(
                osd, MOSDSubRead(tid, state.pg, -1, oid, 0, 1,
                                 want_omap=True), tid)
            if reply is not None and reply.rc == 0:
                return reply.omap
        return None

    # -- scrub (daemon-side scheduled scrub; PG.cc scrub + be_deep_scrub
    # roles) ---------------------------------------------------------------

    async def _scrub_loop(self, interval: float) -> None:
        """Background scrub: walk my primary PGs comparing shard
        payloads against their recorded digests, repairing through the
        recovery path."""
        while not self._stopping:
            await asyncio.sleep(interval)
            if self.osdmap is None:
                continue
            for pg, state in list(self.pgs.items()):
                if state.primary != self.osd_id or \
                        state.state != "active":
                    continue
                pool = self.osdmap.pools.get(pg.pool)
                if pool is None:
                    continue
                try:
                    await self.scrub_pg(state, pool)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    log.exception("osd.%d: scrub %s failed",
                                  self.osd_id, pg)

    async def scrub_pg(self, state: PGState, pool) -> Dict[str, int]:
        """Scrub one PG; returns this run's {objects, errors,
        repaired}.  Exposed for tests and an admin trigger."""
        run = {"objects": 0, "errors": 0, "repaired": 0}
        my_shard = state.my_shard(self.osd_id, pool.type)
        scrub_interval_epoch = state.interval_epoch
        # union the listings across the ACTING set: a straggler copy
        # (e.g. one that missed a remove fan-out) may exist only on a
        # peer shard, invisible to the primary's own listing — the
        # reference's scrub maps cover every shard for the same reason
        name_set = set(self._list_shard_objects(state.pg, my_shard))

        async def peer_listing(osd: int):
            tid = self._next_tid()
            return await self._request(
                osd, MPGQuery(tid, state.pg, state.interval_epoch,
                              self.osd_id), tid)

        peers = [osd for osd in state.acting
                 if osd != CRUSH_ITEM_NONE and osd != self.osd_id
                 and self.osdmap.is_up(osd)]
        for reply in await asyncio.gather(*(peer_listing(o)
                                            for o in peers)):
            if reply is not None:
                name_set.update(reply.info.get("objects", []))
        names = sorted(n for n in name_set if not is_internal_name(n))
        for oid in names:
            # QoS admit BEFORE taking the object lock: a scrub item
            # parked in the queue while holding the lock would stall
            # that object's client ops behind the lowest-priority class
            async def scrub_one(oid=oid):
                async with state.obj_lock(oid):
                    if state.state != "active" or \
                            state.interval_epoch != scrub_interval_epoch:
                        return False
                    await self._scrub_object(state, pool, oid, run)
                    return True

            if not await self.scheduler.run(sched_mod.SCRUB, 1.0,
                                            scrub_one):
                # an interval change mid-scrub hands the PG to
                # peering; repairs computed against the old acting set
                # would corrupt state — abort, next pass rescans
                break
        self.scrub_stats["objects"] += run["objects"]
        self.scrub_stats["errors"] += run["errors"]
        self.scrub_stats["repaired"] += run["repaired"]
        if run["errors"]:
            self._clog("ERR", f"scrub {state.pg}: {run['errors']}"
                              f" inconsistencies, {run['repaired']}"
                              " repaired")
        return run

    @staticmethod
    def _newest_log_entry(plog, oid: str) -> Optional[Dict[str, Any]]:
        for le in reversed(plog.entries):
            if le.get("oid") == oid:
                return le
        return None

    async def _scrub_object(self, state: PGState, pool, oid: str,
                            run: Dict[str, int]) -> None:
        run["objects"] += 1
        plog = self._load_log(state, pool)
        if oid in plog.missing or \
                any(oid in m for m in state.peer_missing.values()):
            return  # recovery owns this object right now
        newest = self._newest_log_entry(plog, oid)
        if newest is not None and newest.get("op") == "delete":
            # the log says this object was DELETED: any surviving copy
            # is a straggler that missed the remove fan-out — purge it
            # rather than adjudicating it as data (reinstalling would
            # resurrect a deletion the client was acked for)
            await self._purge_deleted_stragglers(state, pool, oid,
                                                 ev(newest["version"]))
            return
        # gather with explicit per-copy identity: (acting position,
        # osd, payload, attrs) — candidate order from the generic
        # gather cannot identify WHICH replica a copy came from
        copies: List[Tuple[int, int, bytes, Dict[str, bytes]]] = []

        async def fetch(idx: int, osd: int, shard: int) -> None:
            if osd == self.osd_id:
                rc, data, at = self._read_shard(state.pg, shard, oid)
            else:
                tid = self._next_tid()
                reply = await self._request(
                    osd, MOSDSubRead(tid, state.pg, shard, oid), tid)
                if reply is None or reply.rc != 0:
                    return
                rc, data, at = 0, reply.data, reply.attrs
            if rc == 0:
                copies.append((idx, osd, data, at))

        jobs = []
        expected: List[Tuple[int, int]] = []
        for idx, osd in enumerate(state.acting):
            if osd == CRUSH_ITEM_NONE or not self.osdmap.is_up(osd):
                continue
            shard = idx if pool.type == TYPE_ERASURE else -1
            expected.append((idx, osd))
            jobs.append(fetch(idx, osd, shard))
        await asyncio.gather(*jobs)
        if not copies:
            return
        # an up acting member that should hold the object but returned
        # nothing IS an inconsistency (a silently lost copy) — count it
        # and repair it like a corrupt one
        absent = [(idx, osd) for idx, osd in expected
                  if not any(c[0] == idx for c in copies)]
        k = self._codec(pool.id).get_data_chunk_count() \
            if pool.type == TYPE_ERASURE else 1
        versions: Dict[tuple, int] = {}
        for _idx, _osd, _data, at in copies:
            v = self._oi_version(at)
            if v is not None:
                versions[v] = versions.get(v, 0) + 1
        auth = [v for v, n in versions.items() if n >= k]
        if not auth:
            # no version reaches k among the acting HEADS — a
            # soft-failed write fan-out left mixed generations.
            # Re-select across heads + rollback generations + strays
            # and reinstall every acting shard (the roll-forward/
            # roll-back decision ECBackend encodes in log entries,
            # recomputed from the data itself).
            run["errors"] += 1
            if await self._repair_mixed_generations(state, pool, oid):
                run["repaired"] += 1
            return
        version = max(auth)
        bad: List[Tuple[int, int]] = []  # (acting idx, osd)
        # a copy at any OTHER version than the adjudicated one is
        # stale (older: missed a write fan-out; newer: an unacked
        # partial that lost — ECBackend would roll it back).  Without
        # this, a soft-timed-out shard stays divergent forever while
        # the k-quorum masks it, and redundancy silently degrades.
        for idx, osd, _payload, at in copies:
            if self._oi_version(at) != version:
                bad.append((idx, osd))
        if pool.type == TYPE_ERASURE:
            # hinfo chunk crcs identify the corrupt shard exactly
            # (be_deep_scrub re-hash, ECBackend.cc:2494); RMW-era
            # objects without chunk hashes fall back to the version
            # agreement already checked above
            for idx, osd, payload, at in copies:
                if self._oi_version(at) != version:
                    continue
                if not _hinfo_chunk_ok(at, idx, payload):
                    bad.append((idx, osd))
        else:
            # replicated: a STRICT majority digest wins; dissenters are
            # corrupt.  A tie (1-vs-1 on a 2-copy object) is
            # undecidable — repairing on a tie can destroy the good
            # copy, so it is reported and left alone (inconsistent).
            digests: Dict[int, List[Tuple[int, int]]] = {}
            voters = 0
            for idx, osd, payload, at in copies:
                if self._oi_version(at) != version:
                    continue
                voters += 1
                d = cks.crc32c(0xFFFFFFFF, payload)
                digests.setdefault(d, []).append((idx, osd))
            if len(digests) > 1:
                majority = max(digests.values(), key=len)
                if len(majority) * 2 > voters:
                    # EXTEND: version-stale copies collected above must
                    # not be discarded by the digest adjudication
                    bad.extend(who for members in digests.values()
                               if members is not majority
                               for who in members)
                else:
                    run["errors"] += 1
                    log.warning(
                        "osd.%d: scrub %s/%s: digest tie (%d groups),"
                        " cannot adjudicate — left inconsistent",
                        self.osd_id, state.pg, oid, len(digests))
                    return
        bad.extend(absent)
        if not bad:
            return
        run["errors"] += len(bad)
        log.warning("osd.%d: scrub %s/%s: %d bad cop%s at %s",
                    self.osd_id, state.pg, oid, len(bad),
                    "y" if len(bad) == 1 else "ies", bad)
        repaired = await self._scrub_repair(state, pool, oid, bad,
                                            version)
        run["repaired"] += repaired

    async def _purge_deleted_stragglers(self, state: PGState, pool,
                                        oid: str,
                                        del_version: tuple) -> None:
        """Remove copies of an object the log says was deleted at
        del_version from every acting shard that still holds one."""
        pg = state.pg
        for idx, osd in enumerate(state.acting):
            if osd == CRUSH_ITEM_NONE:
                continue
            shard = idx if pool.type == TYPE_ERASURE else -1
            if osd == self.osd_id:
                rc, _d, at = self._read_shard(pg, shard, oid, 0, 1)
                if rc == 0:
                    v = self._oi_version(at)
                    if v is None or v < del_version:
                        t = Transaction()
                        cid = self._cid(pg, shard)
                        t.remove(cid, ObjectId(oid))
                        t.remove(cid, ObjectId(RB_PREFIX + oid))
                        # scrub barrier: bypass the window (drain +
                        # inline) so the purge cannot reorder around
                        # in-window client txns
                        await self.committer.commit_now(t)
                        log.info("osd.%d: scrub purged deleted"
                                 " straggler %s/%s (shard %d)",
                                 self.osd_id, pg, oid, shard)
            elif self.osdmap.is_up(osd):
                cands, _ok = await self._read_candidates(
                    pg, shard, osd, oid, include_rollback=False,
                    offset=0, length=1)
                for _s, _p, at in cands:
                    v = self._oi_version(at)
                    if v is None or v < del_version:
                        tid = self._next_tid()
                        await self._request(
                            osd, MOSDSubWrite(
                                tid, pg, shard, oid,
                                [ShardOp("remove")],
                                state.interval_epoch, None,
                                self.osd_id, guard=del_version), tid)
                        log.info("osd.%d: scrub purged deleted"
                                 " straggler %s/%s on osd.%d",
                                 self.osd_id, pg, oid, osd)

    async def _repair_mixed_generations(self, state: PGState, pool,
                                        oid: str) -> bool:
        """Reinstall one consistent generation of an object whose
        acting heads disagree below reconstructibility: select the
        newest version reaching k across heads + rollback generations
        + strays, rebuild, and install on EVERY acting shard."""
        candidates, _c1 = await self._gather_object_shards(
            state, pool, oid, exclude_missing=False,
            include_rollback=True)
        have = {(idx if pool.type == TYPE_ERASURE else -1, osd)
                for idx, osd in enumerate(state.acting)
                if osd != CRUSH_ITEM_NONE}
        strays, _c2 = await self._gather_stray_shards(
            state, pool, oid, have)
        candidates += strays

        def attrs_of(version, chosen) -> Dict[str, bytes]:
            src = next(iter(chosen))
            for shard, _payload, at in candidates:
                if shard == src and self._oi_version(at) == version:
                    return at
            return {}

        targets = []
        for idx, osd in enumerate(state.acting):
            if osd == CRUSH_ITEM_NONE or osd == self.osd_id or \
                    not self.osdmap.is_up(osd):
                continue
            targets.append((idx if pool.type == TYPE_ERASURE
                            else -(idx + 2), osd))
        guard = self._plan_guard(candidates)
        if pool.type == TYPE_REPLICATED:
            version, chosen, _oi = self._select_consistent(
                candidates, need=1)
            if version is None:
                return False
            plan = {"kind": "replicated", "oid": oid,
                    "targets": targets, "i_need": True,
                    "guard": guard,
                    "payload": {-1: chosen[next(iter(chosen))]},
                    "attrs": attrs_of(version, chosen),
                    "omap": await self._fetch_omap_any(
                        state, pool, oid)}
        else:
            codec = self._codec(pool.id)
            k = codec.get_data_chunk_count()
            version, chosen, _oi = self._select_consistent(
                candidates, need=k, verify_hinfo=True)
            if version is None:
                return False  # genuinely below k: recovery/rollback
                # adjudication owns this on the next peering
            chosen_k = ec_util.choose_decode_set(
                codec, chosen, k, prefer=self._shard_rank(state),
                first_k=True)
            plan = {"kind": "ec", "oid": oid, "targets": targets,
                    "i_need": True, "guard": guard,
                    "chosen": chosen_k,
                    "attrs": attrs_of(version, chosen), "omap": None}
            if not await self._batch_reconstruct(pool, [plan]):
                return False
        await self._recover_commit(state, pool, plan)
        log.info("osd.%d: %s/%s: reinstalled generation %s across"
                 " the acting set", self.osd_id, state.pg, oid,
                 version)
        return True

    async def _scrub_repair(self, state: PGState, pool, oid: str,
                            bad: List[Tuple[int, int]],
                            version: tuple) -> int:
        """Repair through the recovery path: drop the corrupt copies,
        mark them missing AT THE OBJECT'S authoritative version (not
        the PG head's last_update — recovery's need_v guard compares
        against this, and an inflated version makes the located,
        correct copy look too old to install), reconstruct + push."""
        peer_shards = self._acting_peer_shards(state, pool)
        plog = self._load_log(state, pool)
        my_cid = self._cid(state.pg,
                           state.my_shard(self.osd_id, pool.type))
        for idx, osd in bad:
            shard_key = idx if pool.type == TYPE_ERASURE else -(idx + 2)
            # mark missing WITHOUT removing the data: recovery's
            # install overwrites the stale copy atomically, so a
            # failed push leaves the old (degraded but real) copy
            # instead of destroying it — repeated drop-then-fail
            # cycles under load would otherwise bleed away every copy
            # of the authoritative generation one scrub at a time
            if osd == self.osd_id:
                t = Transaction()
                plog.missing[oid] = version
                # DURABLE missing marker: a crash before recovery must
                # resume the repair, not strand reduced redundancy
                # (scrub barrier: drained bypass, never windowed)
                plog.stage(t, my_cid)
                await self.committer.commit_now(t)
            else:
                state.peer_missing.setdefault(shard_key, {})[oid] = \
                    version
        await self._recover_object(state, pool, oid, peer_shards)
        # count repaired only if recovery actually restored everything
        still_bad = (oid in plog.missing) or any(
            oid in m for m in state.peer_missing.values())
        if still_bad:
            # arm the in-place retry: nothing else re-runs recovery
            # for entries created outside peering
            self._schedule_unfound_retry(state, pool)
        return 0 if still_bad else len(bad)

    async def _recover_pg(self, state: PGState, pool,
                          peer_shards: Dict[int, int]) -> None:
        """Recover missing objects: mine by reconstruct, peers by push.

        Three phases, shaped for the device (the RecoveryOp batching of
        ECBackend.h:249, re-designed TPU-first):
        1. PLAN — gather candidate shards for EVERY missing object
           concurrently (each gather already fans its sub-reads out).
        2. RECONSTRUCT — group EC objects by survivor-shard set and
           decode + re-encode each group's concatenated stripe streams
           in ONE device dispatch per group (dispatch-per-object would
           pay host<->device latency O(objects) times).
        3. COMMIT — install/push all objects concurrently.
        """
        pg = state.pg
        # the per-OSD backfill cap: PGs queue here, not in the device
        # layer.  Taken BEFORE any object lock (same slot/lock
        # discipline as the pacing token below — a capped PG holds
        # nothing a client op could be waiting on).
        if self._backfill_sem.locked():
            self.perf["backfill_waits"] = \
                self.perf.get("backfill_waits", 0) + 1
        async with self._backfill_sem:
            self.perf["backfills_active"] = \
                self.perf.get("backfills_active", 0) + 1
            try:
                await self._recover_pg_throttled(state, pool,
                                                peer_shards)
            finally:
                self.perf["backfills_active"] -= 1

    async def _recover_pg_throttled(self, state: PGState, pool,
                                    peer_shards: Dict[int, int]
                                    ) -> None:
        pg = state.pg
        plog = self._load_log(state, pool)
        my_shard = state.my_shard(self.osd_id, pool.type)
        # union of all objects anyone is missing
        todo: Set[str] = set(plog.missing)
        for missing in state.peer_missing.values():
            todo.update(missing)
        order = sorted(todo)
        # fixed-size waves bound memory (shard streams + reconstructed
        # payloads resident at once) and in-flight probe RPCs while
        # keeping the per-wave dispatch batching win
        WAVE = 64
        for lo in range(0, len(order), WAVE):
            wave = order[lo:lo + WAVE]
            # each object's lock is held from plan through commit:
            # client writes to an object being recovered wait (and vice
            # versa), so a push selected at version v can never be
            # overtaken by a concurrent write at v+1 on the primary
            # (the wait_for_degraded_object serialization; the replica-
            # side guard token covers the timed-out-push-in-flight case)
            #
            # LOCK/SLOT DISCIPLINE: client ops wait for obj locks while
            # INSIDE bounded scheduler slots, so a lock holder must
            # never wait on a slot grant — blocked clients would pin
            # every slot and wedge the grant loop.  QoS pacing for
            # recovery therefore uses a pacing token (a slot acquired
            # and released BEFORE touching any lock); plan and commit
            # themselves run outside the scheduler.
            held: Dict[str, Any] = {}

            async def _noop():
                return None

            async def plan_locked(oid: str):
                # push-only objects (a peer is behind, this primary is
                # whole) are BACKFILL work: they ride the best-effort
                # class so a drain/add wave cannot eat the reservation
                # budget client ops share with genuine self-recovery
                cls = sched_mod.RECOVERY if oid in plog.missing \
                    else sched_mod.BEST_EFFORT
                await self.scheduler.run(cls, 1.0, _noop)
                ctx = state.obj_lock(oid)
                await ctx.__aenter__()
                held[oid] = ctx
                return await self._recover_plan(
                    state, pool, oid, peer_shards)

            try:
                results = await asyncio.gather(
                    *(plan_locked(oid) for oid in wave),
                    return_exceptions=True)
                plans = []
                for oid, plan in zip(wave, results):
                    if isinstance(plan, Exception):
                        # an unrecoverable object stays missing; the
                        # next interval retries
                        log.error(
                            "osd.%d: recovery plan of %s/%s failed",
                            self.osd_id, pg, oid, exc_info=plan)
                        continue
                    if isinstance(plan, BaseException):  # Cancelled
                        raise plan
                    if plan is not None:
                        plans.append(plan)
                reconstructed = await self._batch_reconstruct(
                    pool, [p for p in plans
                           if p["kind"] in ("ec", "ec_repair")])
                plans = [p for p in plans
                         if p["kind"] not in ("ec", "ec_repair")
                         or p in reconstructed]
                # commits run OUTSIDE the QoS scheduler: object locks
                # are held here, and client ops blocked on those locks
                # sit inside scheduler slots — commits queued behind
                # them would deadlock the slot pool.  The wave is
                # already QoS-paced by its plan phase.
                t_commit = time.monotonic()
                commits = await asyncio.gather(
                    *(self._recover_commit(state, pool, plan)
                      for plan in plans),
                    return_exceptions=True)
                # (the port's own stage: the wave's installs and pushes)
                self.tracer.record_stages({"recover_commit": int(
                    (time.monotonic() - t_commit) * 1e6)})
                for plan, res in zip(plans, commits):
                    if isinstance(res, Exception):
                        log.error(
                            "osd.%d: recovery commit of %s/%s failed",
                            self.osd_id, pg, plan["oid"], exc_info=res)
                    elif isinstance(res, BaseException):
                        raise res
            finally:
                for ctx in held.values():
                    await ctx.__aexit__(None, None, None)
        # persist whatever missing state remains
        cid = self._cid(pg, my_shard)
        t = Transaction()
        if not self.store.collection_exists(cid):
            t.create_collection(cid)
        plog.stage(t, cid)
        # recovery barrier: drained bypass, never windowed
        await self.committer.commit_now(t)

    async def _recover_object(self, state: PGState, pool, oid: str,
                              peer_shards: Dict[int, int]) -> None:
        """Single-object recovery (scrub repair's and
        wait_for_degraded's entry point): plan, reconstruct, commit —
        the unbatched form of _recover_pg.  CONTRACT: the caller holds
        state.obj_lock(oid) (every current caller does), which is what
        serializes this install against concurrent client writes."""
        plan = await self._recover_plan(state, pool, oid, peer_shards)
        if plan is None:
            return
        if plan["kind"] in ("ec", "ec_repair") and \
                not await self._batch_reconstruct(pool, [plan]):
            return
        await self._recover_commit(state, pool, plan)

    async def _recover_plan(self, state: PGState, pool, oid: str,
                            peer_shards: Dict[int, int],
                            allow_repair: bool = True
                            ) -> Optional[Dict[str, Any]]:
        """Locate and select an object's authoritative copy; returns a
        commit plan or None (unfound — stays missing).

        allow_repair=False forces the classic full-chunk plan even for
        regenerating codecs — the recursion target when the repair
        fast path hits a complication (too few helpers, fragment
        fetch/verify failure)."""
        pg = state.pg
        plog = self._load_log(state, pool)
        state.extent_cache.pop(oid, None)  # recovery rewrites shards
        targets = [(shard_key, osd)
                   for shard_key, osd in peer_shards.items()
                   if oid in state.peer_missing.get(shard_key, {})]
        i_need = oid in plog.missing
        # REPAIR-AWARE probe sizing: when every missing target is the
        # SAME single chunk of a regenerating codec, the plan needs
        # only versions and attrs from the survivors — 1-byte thin
        # reads — because the payload will be rebuilt from beta-size
        # repair fragments shipped by d helpers, never from full
        # chunks.  Any complication downgrades to the classic plan.
        repair_lost: Optional[int] = None
        if allow_repair and pool.type == TYPE_ERASURE and \
                self._repair_enabled():
            codec0 = self._codec(pool.id)
            lost_set = {sk for sk, _o in targets}
            if i_need:
                lost_set.add(state.my_shard(self.osd_id, pool.type))
            if len(lost_set) == 1 and \
                    codec0.supports_fractional_repair():
                cand = next(iter(lost_set))
                if 0 <= cand < codec0.get_chunk_count():
                    repair_lost = cand
        probe_len = 1 if repair_lost is not None else 0
        t_read = time.monotonic()
        # include_rollback: an acked write that later partial writes
        # pushed off some heads may survive only in acting members'
        # rollback generations — recovery (and especially the
        # no-version purge decision below) must see them
        candidates, acting_complete = await self._gather_object_shards(
            state, pool, oid, include_rollback=True, length=probe_len)
        # always search strays during recovery: after several remaps the
        # newest acked version may exist only on prior-interval members
        have = set()
        for idx, osd in enumerate(state.acting):
            if osd != CRUSH_ITEM_NONE:
                have.add((idx if pool.type == TYPE_ERASURE else -1, osd))
        strays, stray_complete = await self._gather_stray_shards(
            state, pool, oid, have, length=probe_len)
        candidates += strays
        self.tracer.record_stages(
            {"recover_read": int((time.monotonic() - t_read) * 1e6)})
        probes_complete = acting_complete and stray_complete
        # the newest version the PG log says was acked — recovery may
        # not install anything OLDER unless every possible source was
        # probed (otherwise a stale stray copy silently rolls back an
        # acked write while its real holder is down)
        need_v = plog.missing.get(oid) or ZERO
        for shard_key, _osd in targets:
            nv = state.peer_missing.get(shard_key, {}).get(oid) or ZERO
            if nv > need_v:
                need_v = nv
        # causality token for the pushes: the newest version this plan
        # OBSERVED anywhere.  A replica whose state moved past this
        # after the plan was made (a newer client write landed) refuses
        # the push — that push is by definition stale.
        guard = self._plan_guard(candidates, need_v)

        # DELETE-AWARE adjudication: if the authoritative log's newest
        # word on this object is a delete (and nothing recreated it
        # after), the recovered state is ABSENT.  Without this check a
        # stale replica's older generation reaches k/1 candidates and
        # recovery would faithfully REINSTALL it — resurrecting an
        # acked remove (found by the thrash model checker).  The
        # reference encodes deletes in the missing set as
        # "need > have, item.is_delete()" (PGLog) for the same reason.
        newest = self._newest_log_entry(plog, oid)
        if newest is not None and newest.get("op") == "delete" and \
                ev(newest["version"]) >= need_v:
            dv = ev(newest["version"])
            if dv > guard:
                guard = dv
            holders = await self._locate_holders(pg, pool, oid)
            log.info("osd.%d: %s/%s: newest log entry is a delete at"
                     " %s — propagating removal (%d stale holders)",
                     self.osd_id, pg, oid, dv, len(holders))
            return {"kind": "remove", "oid": oid, "targets": targets,
                    "i_need": i_need, "purge": True, "guard": guard,
                    "purge_locations": holders}

        if not candidates:
            if not probes_complete:
                # zero copies found but a possible source is down or
                # unreachable: the object is UNFOUND, not deleted.
                # Removing here would garbage-collect an acked write
                # whose only holders are temporarily dead.  Keep it
                # missing; the PG stays unfound and re-peers on every
                # map change until a source comes back (the reference
                # blocks recovery the same way until might_have_unfound
                # is drained or an OSD is declared lost).
                log.warning(
                    "osd.%d: %s/%s unfound (0 copies located, probes"
                    " incomplete — possible source down)",
                    self.osd_id, pg, oid)
                return None
            # object does not exist at any authoritative source: the
            # divergent entry was a create nobody kept — remove it
            return {"kind": "remove", "oid": oid, "targets": targets,
                    "i_need": i_need, "guard": guard}

        def _attrs_of(version, chosen) -> Dict[str, bytes]:
            src = next(iter(chosen))
            for shard, _payload, at in candidates:
                if shard == src and self._oi_version(at) == version:
                    return at
            return {}

        if pool.type == TYPE_REPLICATED:
            version, chosen, _oi = self._select_consistent(
                candidates, need=1)
            if version is None:
                return None  # no readable copy with object_info: retry
            if not probes_complete and need_v > version:
                log.warning(
                    "osd.%d: %s/%s unfound at acked version %s (best"
                    " located %s, probes incomplete — possible source"
                    " down)", self.osd_id, pg, oid, need_v, version)
                return None
            return {"kind": "replicated", "oid": oid,
                    "targets": targets, "i_need": i_need,
                    "guard": guard,
                    "payload": {-1: chosen[next(iter(chosen))]},
                    "attrs": _attrs_of(version, chosen),
                    "omap": await self._fetch_omap_any(
                        state, pool, oid)}

        codec = self._codec(pool.id)
        k = codec.get_data_chunk_count()
        # thin probes carry 1-byte payloads, so the per-shard CRC
        # ledger cannot be checked here; the repair path instead
        # verifies the REBUILT stream against the ledger and falls
        # back to this plan (full reads, verify_hinfo) on mismatch
        version, chosen, _oi = self._select_consistent(
            candidates, need=k, verify_hinfo=repair_lost is None)
        if version is None:
            if not probes_complete:
                # not enough same-version shards REACHABLE yet: the
                # object stays missing (unfound), a later interval
                # retries when sources return
                log.warning("osd.%d: %s/%s unfound (candidate versions"
                            " %s, probes incomplete)", self.osd_id, pg,
                            oid, sorted({self._oi_version(at)
                                         for _s, _p, at in candidates
                                         if self._oi_version(at)}))
                return None
            # EVERY possible source answered and no version — head or
            # rollback generation — reaches k shards: the logged entry
            # was an in-progress write that never committed on enough
            # shards (its older generations were already consumed or
            # the object was removed before it).  Roll back to the last
            # complete state, which the candidate set proved is
            # "object absent" — the role of ECBackend's rollback of
            # uncommitted log entries (ECBackend.cc try_state_to_reads
            # rollback path, PGLog rollback metadata).  An acked write
            # can never land here: ack requires every shard durable, so
            # some version would reconstruct.
            log.warning("osd.%d: %s/%s: no reconstructible version"
                        " after exhaustive probe — rolling back the"
                        " uncommitted entry (remove)",
                        self.osd_id, pg, oid)
            # locate the partial fragments so the purge removes
            # exactly the holders (quiet + O(holders), not a
            # cluster-wide broadcast)
            holders = await self._locate_holders(pg, pool, oid)
            return {"kind": "remove", "oid": oid, "targets": targets,
                    "i_need": i_need, "purge": True, "guard": guard,
                    "purge_locations": holders}
        if not probes_complete and need_v > version:
            log.warning(
                "osd.%d: %s/%s unfound at acked version %s (best"
                " located %s, probes incomplete — possible source"
                " down)", self.osd_id, pg, oid, need_v, version)
            return None
        if repair_lost is not None:
            # rank the helper pool by the hedge tracker's EWMAs (the
            # same octave-quantized key the decode survivor choice
            # uses) and keep every eligible shard: the fragment fetch
            # hedges over the tail as straggler replacements
            rank = self._shard_rank(state)
            acting = list(state.acting)
            helper_pool = [
                s for s in sorted(chosen, key=rank)
                if s != repair_lost and 0 <= s < len(acting)
                and acting[s] != CRUSH_ITEM_NONE
                and self.osdmap.is_up(acting[s])]
            if len(helper_pool) >= codec.repair_degree():
                return {"kind": "ec_repair", "oid": oid,
                        "targets": targets, "i_need": i_need,
                        "lost": repair_lost,
                        "helpers": [(s, acting[s])
                                    for s in helper_pool],
                        "guard": guard,
                        "attrs": _attrs_of(version, chosen),
                        "version": version, "omap": None, "pg": pg,
                        "state": state,
                        "peer_shards": dict(peer_shards)}
            # fewer than d up acting helpers hold this version: the
            # repair math needs exactly d, so take the classic k-read
            # plan (which may also use strays/rollback generations)
            return await self._recover_plan(
                state, pool, oid, peer_shards, allow_repair=False)
        # normalize to k shards (what decode consumes) pulled from the
        # FASTEST survivor set — the hedge tracker's EWMA rank is
        # stable across a wave, so equal survivor sets batch together
        # exactly as the old first-k normalization did
        chosen_k = ec_util.choose_decode_set(
            codec, chosen, k, prefer=self._shard_rank(state),
            first_k=True)
        return {"kind": "ec", "oid": oid, "targets": targets,
                "i_need": i_need, "chosen": chosen_k, "guard": guard,
                "attrs": _attrs_of(version, chosen), "omap": None}

    async def _batch_reconstruct(self, pool,
                                 ec_plans: List[Dict[str, Any]]
                                 ) -> List[Dict[str, Any]]:
        """Fill each EC plan's `payload` (all n shard streams): decode
        groups that share a survivor set in one dispatch each, then
        re-encode every successful object's data in one dispatch total
        — shard streams are chunk-aligned, so cross-object batching is
        plain concatenation along the stripe axis.  Both legs await
        the encode service, so concurrent recovery waves (and client
        writes) share device dispatches.  A group whose batch fails
        is retried item by item by the service on the same codec, so
        one malformed object cannot livelock the rest of the PG;
        returns the plans that got payloads.

        `ec_repair` plans take the regenerating-code leg first
        (_batch_repair: beta-size fragments from d helpers, one
        plan-cached dispatch per helper set); a repair that cannot
        complete is RE-PLANNED classic (allow_repair=False, full reads
        + hinfo verify) in place and rejoins the decode leg — the
        caller's plan identity is preserved by mutating the dict."""
        if not ec_plans:
            return []
        repair_plans = [p for p in ec_plans if p["kind"] == "ec_repair"]
        ec_plans = [p for p in ec_plans if p["kind"] != "ec_repair"]
        done_repair: List[Dict[str, Any]] = []
        if repair_plans:
            repaired, fallbacks = await self._batch_repair(
                pool, repair_plans)
            done_repair.extend(repaired)
            for p in fallbacks:
                self.perf["repair_fallbacks"] += 1
                try:
                    p2 = await self._recover_plan(
                        p["state"], pool, p["oid"], p["peer_shards"],
                        allow_repair=False)
                except Exception:
                    log.exception(
                        "osd.%d: classic re-plan of %s after repair"
                        " fallback failed", self.osd_id, p["oid"])
                    continue
                if p2 is None:
                    continue
                p.clear()
                p.update(p2)
                if p["kind"] == "ec":
                    ec_plans.append(p)
                else:
                    # adjudicated remove: needs no reconstruct, commit
                    # handles it — but it must count as "done" so the
                    # wave's commit phase keeps the plan
                    done_repair.append(p)
        if not ec_plans:
            return done_repair
        codec = self._codec(pool.id)
        sinfo = self._sinfo(pool.id)
        n = codec.get_chunk_count()
        chunk = sinfo.get_chunk_size()
        width = sinfo.get_stripe_width()
        maps = [p["chosen"] for p in ec_plans]
        for p in ec_plans:
            self.perf["recovery_bytes_read"] += sum(
                len(b) for b in p["chosen"].values())
        # one fold per distinct survivor set (the service/ec_util
        # decode_many contract), counted as such
        self.perf["decode_dispatches"] += len(
            {tuple(sorted(m)) for m in maps})
        t_dec = time.monotonic()
        results = await self.encode_service.decode_many(sinfo, codec,
                                                        maps)
        datas: Dict[str, bytes] = {}
        for p, res in zip(ec_plans, results):
            if isinstance(res, BaseException):
                # no host twin: the encode service already retried the
                # failed batch item by item on this codec and device,
                # so this is the object's own error (below-k
                # survivors, malformed streams, a failed launch).  It
                # stays missing and the next interval retries it, as
                # an unrecoverable plan does.
                log.error("osd.%d: reconstruct of %s failed",
                          self.osd_id, p["oid"], exc_info=res)
                continue
            datas[p["oid"]] = res
        done = [p for p in ec_plans if p["oid"] in datas]
        if not done:
            return []
        # (the port's own stage, inside recover_decode: the re-encode)
        t_enc = time.monotonic()
        try:
            all_data = b"".join(datas[p["oid"]] for p in done)
            self.perf["encode_dispatches"] += 1
            full = await self.encode_service.encode(
                sinfo, codec, all_data, range(n))
            offsets: Dict[int, int] = {s: 0 for s in range(n)}
            for p in done:
                span = len(datas[p["oid"]])
                shard_len = (span // width) * chunk
                payload = {}
                for s in range(n):
                    payload[s] = full.get(s, b"")[
                        offsets[s]:offsets[s] + shard_len]
                    offsets[s] += shard_len
                p["payload"] = payload
        except Exception:
            done2 = []
            for p in done:
                try:
                    self.perf["encode_dispatches"] += 1
                    p["payload"] = await self.encode_service.encode(
                        sinfo, codec, datas[p["oid"]], range(n))
                    done2.append(p)
                except Exception:
                    log.exception("osd.%d: re-encode of %s failed",
                                  self.osd_id, p["oid"])
            done = done2
        now = time.monotonic()
        self.tracer.record_stages(
            {"recover_decode": int((now - t_dec) * 1e6),
             "recover_encode": int((now - t_enc) * 1e6)})
        return done + done_repair

    def _repair_enabled(self) -> bool:
        """Repair-aware recovery kill switch: CEPH_TPU_MSR_REPAIR=0
        (env) or osd_msr_repair_enable=false (config) forces the
        classic k-read reconstruct for every object.  Results are
        bit-identical either way — repair and full decode agree by
        construction — so the switch exists for triage, not safety."""
        if not flags.enabled("CEPH_TPU_MSR_REPAIR"):
            return False
        return bool(self.config.get("osd_msr_repair_enable", True))

    async def _batch_repair(
            self, pool, plans: List[Dict[str, Any]]
    ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
        """Regenerating-code leg of _batch_reconstruct: fetch beta =
        chunk/alpha byte fragments from d helpers per object (hedged —
        stragglers recruit the next-ranked helper), then rebuild every
        lost chunk with ONE plan-cached dispatch per (lost, helper
        set) group: fragment streams of same-group objects concatenate
        along the byte axis, so cross-object batching is free exactly
        as in the decode leg.  Returns (done, fallbacks); fallback
        plans re-enter planning as classic full reads.

        The rebuilt stream is verified against the shard's crc32c
        ledger (hinfo) before it counts — fragments themselves cannot
        be CRC-checked, so a corrupt helper surfaces HERE and demotes
        the object to the verified classic path."""
        codec = self._codec(pool.id)
        alpha = codec.get_sub_chunk_count()
        d = codec.repair_degree()
        t_read = time.monotonic()

        async def fetch_one(plan: Dict[str, Any]
                            ) -> Optional[Dict[int, bytes]]:
            pg, oid = plan["pg"], plan["oid"]
            lost, want_v = plan["lost"], plan["version"]

            async def frag_job(shard: int, osd: int):
                ts = time.monotonic()
                if osd == self.osd_id:
                    rc, data, at = self._read_shard(pg, shard, oid,
                                                    0, 0)
                    self.hedge.observe(osd, time.monotonic() - ts,
                                       ok=rc in (0, ENOENT))
                    if rc != 0 or self._oi_version(at) != want_v:
                        return None
                    try:
                        frag = await asyncio.to_thread(
                            codec.repair_project, lost, data)
                    except Exception:
                        return None
                    self.perf["repair_fragments"] += 1
                    return (shard, frag)
                tid = self._next_tid()
                m = MOSDSubRead(tid, pg, shard, oid)
                m.repair = (lost, alpha)
                reply = await self._request(osd, m, tid)
                self.hedge.observe(osd, time.monotonic() - ts,
                                   ok=reply is not None
                                   and reply.rc in (0, ENOENT))
                if reply is None or reply.rc != 0 or \
                        self._oi_version(reply.attrs) != want_v:
                    # EOPNOTSUPP (codec drift), a stale version, or a
                    # transport fault all just fail this helper; the
                    # hedge recruits the next-ranked one
                    return None
                self.perf["subread_bytes"] += len(reply.data)
                return (shard, reply.data)

            jobs = [(osd, (lambda s=shard, o=osd: frag_job(s, o)))
                    for shard, osd in plan["helpers"]]

            def sufficient(results) -> bool:
                return len({r[0] for r in results
                            if r is not None}) >= d

            results, _all = await self.hedge.gather(
                jobs, need=d, sufficient=sufficient,
                failed=lambda r: r is None, label="repair_read")
            frags: Dict[int, bytes] = {}
            for r in results:
                if r is not None:
                    frags.setdefault(r[0], r[1])
            if len(frags) < d:
                return None
            # exactly d fragments in helper-rank order feed the math
            rank = {s: i for i, (s, _o) in enumerate(plan["helpers"])}
            keep = sorted(frags, key=lambda s: rank.get(s, 1 << 30))[:d]
            if len({len(frags[s]) for s in keep}) != 1:
                return None  # ragged shard lengths: not one version
            self.perf["recovery_bytes_read"] += sum(
                len(frags[s]) for s in keep)
            return {s: frags[s] for s in keep}

        fetched = await asyncio.gather(*(fetch_one(p) for p in plans))
        self.tracer.record_stages(
            {"recover_read": int((time.monotonic() - t_read) * 1e6)})

        t_dec = time.monotonic()
        done: List[Dict[str, Any]] = []
        fallbacks: List[Dict[str, Any]] = []
        groups: Dict[tuple, List[Dict[str, Any]]] = {}
        for plan, frags in zip(plans, fetched):
            if frags is None:
                fallbacks.append(plan)
                continue
            plan["_frags"] = frags
            groups.setdefault(
                (plan["lost"], tuple(sorted(frags))), []).append(plan)
        for (lost, helpers), group in groups.items():
            try:
                stacked = np.concatenate(
                    [np.stack([np.frombuffer(p["_frags"][h],
                                             dtype=np.uint8)
                               for h in helpers]) for p in group],
                    axis=1)
                syms = await asyncio.to_thread(
                    codec.repair_syms, lost, helpers, stacked)
                off = 0
                for p in group:
                    flen = len(p["_frags"][helpers[0]])
                    stream = codec.repair_assemble(
                        syms[:, off:off + flen])
                    off += flen
                    if not _hinfo_chunk_ok(p["attrs"], lost, stream):
                        log.warning(
                            "osd.%d: repaired chunk of %s fails its"
                            " crc ledger — falling back to verified"
                            " full decode", self.osd_id, p["oid"])
                        fallbacks.append(p)
                        continue
                    p["payload"] = {lost: stream}
                    self.perf["repair_objects"] += 1
                    done.append(p)
            except Exception:
                log.exception(
                    "osd.%d: batched repair of %d objects (lost=%d)"
                    " failed", self.osd_id, len(group), lost)
                fallbacks.extend(group)
        for p in plans:
            p.pop("_frags", None)
        self.tracer.record_stages(
            {"recover_decode": int((time.monotonic() - t_dec) * 1e6)})
        return done, fallbacks

    async def _locate_holders(self, pg: PgId, pool,
                              oid: str) -> List[Tuple[int, int]]:
        """(shard, osd) pairs of every up OSD holding any copy/fragment
        of oid — the purge target list for rollback/delete propagation."""
        if pool.type == TYPE_ERASURE:
            shard_list = list(
                range(self._codec(pool.id).get_chunk_count()))
        else:
            shard_list = [-1]
        probes = [(shard, osd)
                  for osd in self.osdmap.get_up_osds()
                  for shard in shard_list if osd != self.osd_id]
        results = await asyncio.gather(
            *(self._read_candidates(pg, shard, osd, oid,
                                    include_rollback=True)
              for shard, osd in probes))
        return [(shard, osd)
                for (shard, osd), (cands, _ok)
                in zip(probes, results) if cands]

    def _plan_guard(self, candidates, *extra) -> tuple:
        """Newest object version a recovery plan observed: max over the
        probed candidates' OI versions and any extra versions (need_v,
        adjudicated version).  Stamped on the plan's pushes so replicas
        can refuse pushes that predate their current state."""
        guard = ZERO
        for v in extra:
            if v is not None and v > guard:
                guard = v
        for _s, _p, at in candidates:
            v = self._oi_version(at)
            if v is not None and v > guard:
                guard = v
        return guard

    async def _recover_commit(self, state: PGState, pool,
                              plan: Dict[str, Any]) -> None:
        """Apply one plan: remove everywhere, or install the
        reconstructed copy wherever it's missing (concurrent pushes)."""
        pg = state.pg
        plog = self._load_log(state, pool)
        my_shard = state.my_shard(self.osd_id, pool.type)
        oid = plan["oid"]
        targets = plan["targets"]
        i_need = plan["i_need"]
        # recovery rewrites shards (or removes the object): the tier
        # entry may describe pre-adjudication state
        self.tier.invalidate(pg, oid)

        if plan["kind"] == "remove":
            async def remove_peer(shard_key: int, osd: int) -> None:
                shard = shard_key if shard_key >= -1 else -1
                tid = self._next_tid()
                # recovery ops carry the INTERVAL epoch: a live-epoch
                # stamp would raise replica fences above this interval
                # and fence out every subsequent client write
                reply = await self._request(
                    osd, MOSDSubWrite(tid, pg, shard, oid,
                                      [ShardOp("remove")],
                                      state.interval_epoch, None,
                                      self.osd_id,
                                      guard=plan.get("guard")), tid)
                # the remove RESOLVES the missing entry: the rollback
                # adjudicated "object does not exist" as the recovered
                # state.  Leaving peer_missing populated would re-plan
                # the same remove from the unfound-retry loop forever —
                # the silent livelock that parked k2m2 thrash runs with
                # an active+unfound PG and an empty log.
                if reply is None or reply.rc != 0:
                    log.warning(
                        "osd.%d: recovery remove of %s/%s on osd.%d"
                        " failed (%s)", self.osd_id, pg, oid, osd,
                        "timeout" if reply is None else reply.rc)
                    return
                if shard_key in state.peer_missing:
                    state.peer_missing[shard_key].pop(oid, None)

            removals = list(targets)
            if plan.get("purge"):
                # rolling back an uncommitted entry must also drop the
                # partial shards that DO exist — on acting members AND
                # on strays — or the orphan fragments resurface as
                # below-k candidates on every later read.  The plan
                # phase located the exact holders.
                seen = {(sk if sk >= -1 else -1, osd)
                        for sk, osd in removals}
                for shard, osd in plan.get("purge_locations", []):
                    if (shard, osd) not in seen:
                        removals.append((shard, osd))
            await asyncio.gather(*(remove_peer(sk, osd)
                                   for sk, osd in removals))
            if plan.get("purge") and not i_need:
                # my own partial shard goes too (I may hold data while
                # not being in my own missing set)
                t = Transaction()
                cid = self._cid(pg, my_shard)
                t.remove(cid, ObjectId(oid))
                try:
                    # recovery barrier: drained bypass, never windowed
                    await self.committer.commit_now(t)
                except KeyError:
                    pass
            if i_need:
                t = Transaction()
                cid = self._cid(pg, my_shard)
                t.remove(cid, ObjectId(oid))
                plog.missing.pop(oid, None)
                plog.stage(t, cid)
                try:
                    await self.committer.commit_now(t)
                except KeyError:
                    pass
            return

        payload = plan["payload"]
        obj_attrs = plan["attrs"]
        omap_payload = plan["omap"]

        async def install(shard: int, osd: int,
                          shard_key: Optional[int] = None) -> None:
            buf = payload.get(shard if pool.type == TYPE_ERASURE else -1,
                              b"")
            ops = [ShardOp("create"), ShardOp("truncate", size=0),
                   ShardOp("write", 0, buf)]
            for name, value in obj_attrs.items():
                ops.append(ShardOp("setattr", name=name, value=value))
            if pool.type == TYPE_REPLICATED:
                # authoritative omap REPLACES the target's: clear
                # first or deleted keys resurrect on the recovered copy
                ops.append(ShardOp("omap_clear"))
                if omap_payload:
                    ops.append(ShardOp(
                        "omap_set", data=encode_kv_map(omap_payload)))
            if osd == self.osd_id:
                t = Transaction()
                cid = self._cid(pg, shard)
                self._apply_shard_ops(t, cid, oid, ops)
                plog.missing.pop(oid, None)
                plog.stage(t, cid)
                # recovery install barrier: drained bypass
                await self.committer.commit_now(t)
            else:
                tid = self._next_tid()
                reply = await self._request(
                    osd, MOSDSubWrite(tid, pg, shard, oid, ops,
                                      state.interval_epoch, None,
                                      self.osd_id,
                                      guard=plan.get("guard")), tid)
                if reply is None or reply.rc != 0:
                    # the push did NOT land: leave this target in
                    # peer_missing so the next interval retries it
                    log.warning(
                        "osd.%d: recovery push of %s/%s to osd.%d"
                        " failed (%s)", self.osd_id, pg, oid, osd,
                        "timeout" if reply is None else reply.rc)
                    return
            # mark THIS target recovered as soon as its own push
            # lands: a failed sibling push must not cause successful
            # targets to be re-pushed next interval
            self.perf["recovery_bytes_repaired"] += len(buf)
            if shard_key is not None:
                state.peer_missing.get(shard_key, {}).pop(oid, None)

        jobs = []
        if i_need:
            jobs.append(install(my_shard, self.osd_id))
        for shard_key, osd in targets:
            jobs.append(install(shard_key if shard_key >= -1 else -1,
                                osd, shard_key))
        await asyncio.gather(*jobs)

    # -- client op engine (primary) ----------------------------------------

    async def _handle_client_op(self, conn: Connection,
                                msg: MOSDOp) -> None:
        op_id = self.op_tracker.create(
            f"osd_op({msg.client} {msg.pg} {msg.oid!r} "
            f"{[op.op for op in msg.ops]})")
        # EVERY op gets a root span while tracing is enabled (NULL_SPAN
        # when off): it parents the stage spans fanned out below via
        # contextvar, continues the client's trace when a wire context
        # rides in, and feeds the critical-path stage histograms +
        # tail-exemplar retention at finish.  Head sampling only gates
        # ring retention, never span existence.
        span = self.tracer.start(
            f"osd_op {msg.oid} {'+'.join(o.op for o in msg.ops)}",
            context=msg.trace)
        token = tracing.current_span.set(span) if span else None
        try:
            await self._handle_client_op_tracked(conn, msg, op_id)
        finally:
            op = self.op_tracker.finish(op_id)
            if token is not None:
                tracing.current_span.reset(token)
            self._finish_op_span(span, op)

    def _finish_op_span(self, span, op) -> None:
        """Close an op's root span and run the critical-path pipeline:
        per-stage self-times into the streaming histograms, and — for
        ops in the tail (complaint-time or rolling-p99 breach) — the
        FULL span tree retained as an exemplar (dump_op_trace /
        dump_historic_ops)."""
        if not span:
            return
        # finish() returns the rendered tree when sampling already
        # built one — the tail hook reuses it instead of rendering the
        # same spans twice
        tree = self.tracer.finish(span)
        if op is not None and self.op_tracker.is_tail(op.duration):
            # the tail pays for its full explanation: rendered tree +
            # critical path WITH the per-span path
            if tree is None:
                tree = span.tree_dicts()
            cp = tracing.critical_path(tree)
            self.tracer.record_stages(cp["stages"])
            self.op_tracker.retain_trace(op, {
                "trace_id": f"{span.trace_id:016x}",
                "description": op.description,
                "duration_ms": round((op.duration or 0.0) * 1e3, 3),
                "critical_path": cp,
                "spans": tree,
            })
        else:
            # the bulk pays only the allocation-light reduction: no
            # dict rendering, stages straight into the histograms
            cp = tracing.critical_path_spans(span)
            self.tracer.record_stages(cp["stages"])

    async def _handle_client_op_tracked(self, conn: Connection,
                                        msg: MOSDOp,
                                        op_id: int) -> None:
        if self.osdmap is None:
            await conn.send(MOSDOpReply(msg.tid, EAGAIN))
            return
        pool = self.osdmap.pools.get(msg.pg.pool)
        state = self.pgs.get(msg.pg)
        # placement comes from the PGState cache maintained per epoch by
        # _scan_pgs — recomputing CRUSH per op costs ~ms in the host
        # mapper and is pure waste (the reference's PG lookup is a map)
        primary = state.primary if state is not None else -1
        if pool is None or primary != self.osd_id or state is None:
            await conn.send(MOSDOpReply(
                msg.tid, EAGAIN, replay_epoch=self._epoch()))
            return
        # misdirected-op check (handle_misdirected_op role): a client
        # on a pre-split map addresses the PARENT pg; the parent's
        # acting set may be unchanged, so no fence fires — but
        # executing here would land the object in a PG it no longer
        # maps to (permanently invisible to post-split readers).
        # EAGAIN + replay_epoch makes the client refresh and resend to
        # the child.
        if msg.oid and not is_internal_name(msg.oid) and \
                not any(op.op == "pgls" for op in msg.ops):
            # pgls (and other PG-addressed ops) target the pg itself,
            # with no object name to place
            from ceph_tpu_torch.ops.rjenkins import ceph_str_hash_rjenkins

            raw = PgId(pool.id,
                       ceph_str_hash_rjenkins(msg.oid.encode()))
            if pool.raw_pg_to_pg(raw) != msg.pg:
                await conn.send(MOSDOpReply(
                    msg.tid, EAGAIN, replay_epoch=self._epoch()))
                return
        if state.state != "active":
            # queue until peering completes (waiting_for_active)
            self.op_tracker.mark(op_id, "waiting_for_active")
            try:
                await asyncio.wait_for(state.active_event.wait(), 10.0)
            except asyncio.TimeoutError:
                await conn.send(MOSDOpReply(
                    msg.tid, EAGAIN, replay_epoch=self._epoch()))
                return
            # a parked op must not execute as a zombie in a LATER
            # interval than it was sent for — the client already
            # resent it there (require_same_or_newer_map discipline)
            if msg.epoch < state.interval_epoch:
                await conn.send(MOSDOpReply(
                    msg.tid, EAGAIN, replay_epoch=self._epoch()))
                return
        self.op_tracker.mark(op_id, "started")
        # reqid dedup: a resend of an op this primary already executed
        # gets the stored reply — re-running a non-idempotent op
        # (append, exec) would double-apply it
        reqid = (msg.client, msg.tid)
        cached = self._completed_ops.get(reqid)
        if cached is not None:
            rc, data, out = cached
        else:
            # QoS admit: cost scales with payload so a stream of
            # huge writes is charged accordingly (mClock item cost)
            nbytes = sum(len(op.data) for op in msg.ops)
            cost = 1.0 + nbytes / (1 << 20)
            tenant = getattr(msg, "tenant", "") or ""
            # dmClock piggyback: the client's ServiceTracker counted
            # its completions at OTHER OSDs since its last op here —
            # the tag advance below charges this class for them, so
            # reservation/limit hold cluster-wide (CEPH_TPU_DMCLOCK=0
            # pins both to 1: classic per-OSD mClock)
            qos_delta = qos_rho = 1
            if flags.enabled("CEPH_TPU_DMCLOCK"):
                qos_delta = getattr(msg, "qos_delta", 1)
                qos_rho = getattr(msg, "qos_rho", 1)
            op_class = sched_mod.CLIENT
            admitted = True
            if tenant and self._qos_tenants_enabled:
                op_class = sched_mod.tenant_class(tenant)
                # the admission gate runs BEFORE the op queue: an
                # over-limit tenant is delayed/shed here, before its
                # op consumes a queue slot or any encode-service/
                # hedge/tier resources at the execute stage.  The
                # synchronous fast path carries the common under-
                # limit accept with zero per-op allocation; only a
                # bucket miss awaits the delay/shed slow path.
                decision = self.admission.try_admit(tenant, cost)
                if decision is None:
                    decision = await self.admission.admit(tenant,
                                                          cost)
                if decision == SHED:
                    admitted = False
            try:
                qos_phase = ""
                if not admitted:
                    rc, data, out = EBUSY, b"", {}
                elif self._op_fast_lane_ok(pool, nbytes) and \
                        (qos_phase := self.scheduler.try_acquire(
                            op_class, cost, qos_delta, qos_rho)):
                    # sub-chunk fast lane: the scheduler charges the
                    # class's dmClock tags exactly as run()'s fast
                    # grant would (fairness accounting identical,
                    # over-limit classes refused into the queued
                    # path), minus the per-op lambda/coroutine round
                    # trip the stage histograms priced on tiny writes
                    try:
                        rc, data, out = await self._execute_ops(
                            state, pool, msg, conn)
                    finally:
                        self.scheduler.release()
                else:
                    async def _run_and_stamp():
                        # the grant phase is only visible inside the
                        # granted context; capture it for the reply
                        nonlocal qos_phase
                        qos_phase = sched_mod.current_phase()
                        return await self._execute_ops(state, pool,
                                                       msg, conn)

                    qos_phase = ""
                    rc, data, out = await self.scheduler.run(
                        op_class, cost, _run_and_stamp,
                        qos_delta=qos_delta, qos_rho=qos_rho)
            except asyncio.CancelledError:
                raise
            except sched_mod.QueueFull:
                # bounded-queue overflow: explicit refusal, the
                # client sees EBUSY instead of an unbounded park
                rc, data, out = EBUSY, b"", {}
            except UnfoundObject:
                rc, data, out = EAGAIN, b"", {}
            except Exception:
                log.exception("osd.%d: op %r failed", self.osd_id, msg)
                rc, data, out = EIO, b"", {}
            # dedup-cache replies of non-idempotent MUTATING ops only
            # (the reference tracks reqids for completed writes alone):
            # read-only replays are idempotent, and caching their
            # payloads would pin up to 4096 objects' data in memory.
            # Mutating errors ARE cached — an op vector can partially
            # commit before the failing op (e.g. append ok, omap EIO),
            # so re-executing the resend would double-apply the prefix.
            # EAGAIN alone commits nothing and must re-execute; an
            # EBUSY shed never started, so a resend must get a fresh
            # admission decision, not a cached refusal.
            if rc not in (EAGAIN, EBUSY) and \
                    any(op.op in _MUTATING_CLIENT_OPS
                        for op in msg.ops):
                self._completed_ops[reqid] = (rc, data, out)
                while len(self._completed_ops) > 4096:
                    self._completed_ops.popitem(last=False)
        await conn.send(MOSDOpReply(
            msg.tid, rc, data, out,
            replay_epoch=self._epoch() if rc == EAGAIN else 0,
            qos_phase=qos_phase if cached is None else ""))

    # -- coded compute (MOSDCompute, osd/compute.py) -----------------------

    async def _handle_compute_op(self, conn: Connection,
                                 msg: MOSDCompute) -> None:
        """Client scan op: admission gate first (an over-limit
        tenant's scan is delayed/shed before it consumes anything),
        then the engine fans out.  The dedicated `compute` mClock
        class is charged at the EVAL stage (eval_local_shards), not
        around the whole op — a wave parked on remote sub-computes
        must not occupy in-flight op slots while it waits."""
        op_id = self.op_tracker.create(
            f"compute({msg.client} {msg.kernel} n={len(msg.oids)})")
        span = self.tracer.start(
            f"compute_op {msg.kernel} n{len(msg.oids)}")
        token = tracing.current_span.set(span) if span else None
        try:
            if self.osdmap is None:
                await conn.send(MOSDComputeReply(msg.tid, EAGAIN))
                return
            self.op_tracker.mark(op_id, "started")
            # admission cost on the client-op scale (1.0 ~ one small
            # op): a wave scales sublinearly — per-object work is a
            # lane-width kernel eval, not a payload move
            cost = 1.0 + len(msg.oids) / 256.0
            tenant = getattr(msg, "tenant", "") or ""
            admitted = True
            if tenant and self._qos_tenants_enabled:
                decision = self.admission.try_admit(tenant, cost)
                if decision is None:
                    decision = await self.admission.admit(tenant,
                                                          cost)
                if decision == SHED:
                    admitted = False
            try:
                if not admitted:
                    rc, results, out = EBUSY, {}, {}
                else:
                    rc, results, out = await self.compute.execute(msg)
            except asyncio.CancelledError:
                raise
            except sched_mod.QueueFull:
                rc, results, out = EBUSY, {}, {}
            except Exception:
                log.exception("osd.%d: compute op %r failed",
                              self.osd_id, msg)
                rc, results, out = EIO, {}, {}
            await conn.send(MOSDComputeReply(
                msg.tid, rc, results, out,
                replay_epoch=self._epoch() if rc == EAGAIN else 0))
        finally:
            op = self.op_tracker.finish(op_id)
            if token is not None:
                tracing.current_span.reset(token)
            self._finish_op_span(span, op)

    async def _handle_sub_compute(self, conn: Connection,
                                  msg: MOSDSubCompute) -> None:
        """Shard side of the pushdown: evaluate the kernel over every
        local shard named by the wave — ONE batched plan-cached
        dispatch — and return (rc, version, result) per item.  Only
        kernel results (R bytes each) go back over the wire."""
        from ceph_tpu_torch import compute as compute_mod
        from ceph_tpu_torch.compute import ComputeError
        from ceph_tpu_torch.compute import kernels as compute_kernels

        async def body() -> None:
            kern = compute_mod.get_kernel(msg.kernel)
            # per-kernel capability gate (not blanket linear-only):
            # approx_capable kernels run per-shard too, with the
            # primary doing a result-domain approximate combine
            if kern is None or not (kern.linear or
                                    kern.approx_capable):
                await conn.send(MOSDSubComputeReply(msg.tid, EINVAL))
                return
            try:
                args = compute_kernels.parse_args(msg.args)
            except ComputeError as e:
                await conn.send(MOSDSubComputeReply(msg.tid, e.rc))
                return
            items = [(PgId(pool, ps), shard, oid)
                     for pool, ps, shard, oid in msg.items]
            try:
                results = await self.compute.eval_local_shards(
                    items, kern, args)
            except sched_mod.QueueFull:
                # compute-class overflow: explicit refusal — the
                # primary's hedged gather treats it as a failed
                # flight and recruits a spare
                await conn.send(MOSDSubComputeReply(msg.tid, EBUSY))
                return
            await conn.send(MOSDSubComputeReply(msg.tid, 0, results))

        if msg.trace is not None:
            async with self.tracer.span(
                    f"sub_compute {msg.kernel} x{len(msg.items)}",
                    context=msg.trace):
                await body()
            return
        await body()

    async def _execute_ops(self, state: PGState, pool, msg: MOSDOp,
                           conn: Optional[Connection] = None
                           ) -> Tuple[int, bytes, Dict[str, Any]]:
        rc, data, out = 0, b"", {}
        if is_internal_name(msg.oid):
            # rollback generations and snap clones are internal
            # bookkeeping, not client-addressable objects
            return EINVAL, b"", {}
        # interval the op was admitted under: sub-writes are stamped
        # with this so a demoted primary's parked op cannot pass replica
        # fencing with a fresher live epoch
        state_admit_epoch = state.interval_epoch
        snapc = (msg.snapc_seq, msg.snapc_snaps) \
            if msg.snapc_seq > 0 else None
        read_oid = msg.oid
        if msg.snap_id > 0:
            # snap reads resolve to the head or a clone server-side
            resolved = await self._resolve_read_snap(
                state, pool, msg.oid, msg.snap_id)
            if resolved is None:
                return ENOENT, b"", {}
            read_oid = resolved
        for op in msg.ops:
            if op.op == "write_full":
                rc, out = await self._op_write_full(state, pool,
                                                    msg.oid, op.data,
                                                    state_admit_epoch,
                                                    snapc)
            elif op.op == "write":
                rc = await self._op_write(state, pool, msg.oid,
                                          op.offset, op.data,
                                          state_admit_epoch, snapc)
            elif op.op == "read":
                rc, data = await self._op_read(state, pool, read_oid,
                                               op.offset, op.length)
            elif op.op == "stat":
                rc, out = await self._op_stat(state, pool, read_oid)
            elif op.op == "append":
                rc = await self._op_write(state, pool, msg.oid,
                                          0, op.data,
                                          state_admit_epoch, snapc,
                                          append=True)
            elif op.op == "remove":
                rc = await self._op_remove(state, pool, msg.oid,
                                           state_admit_epoch, snapc)
            elif op.op == "setxattr":
                rc = await self._op_setxattr(state, pool, msg.oid,
                                             op.args["name"], op.data,
                                             state_admit_epoch, snapc)
            elif op.op == "rmxattr":
                rc = await self._op_setxattr(state, pool, msg.oid,
                                             op.args["name"], None,
                                             state_admit_epoch, snapc)
            elif op.op == "getxattr":
                rc, data = await self._op_getxattr(state, pool,
                                                   read_oid,
                                                   op.args["name"])
            elif op.op == "getxattrs":
                rc, out = await self._op_getxattrs(state, pool,
                                                   read_oid)
            elif op.op == "omap_set":
                rc = await self._op_omap_write(state, pool, msg.oid,
                                               "omap_set", op.data,
                                               state_admit_epoch,
                                               snapc)
            elif op.op == "omap_rm":
                rc = await self._op_omap_write(state, pool, msg.oid,
                                               "omap_rm", op.data,
                                               state_admit_epoch,
                                               snapc)
            elif op.op == "omap_get":
                rc, data = await self._op_omap_get(state, pool,
                                                   read_oid)
            elif op.op == "watch":
                rc = self._op_watch(state, pool, msg, conn,
                                    op.args.get("cookie", 0),
                                    op.args.get("unwatch", False))
            elif op.op == "notify":
                rc, out = await self._op_notify(state, pool, msg.oid,
                                                op.data)
            elif op.op == "call":
                rc, data = await self._op_call(
                    state, pool, read_oid, op.args.get("cls", ""),
                    op.args.get("method", ""), op.data,
                    state_admit_epoch, snapc,
                    read_only=msg.snap_id > 0)
            elif op.op == "pgls":
                rc, out = self._op_pgls(state, pool)
            else:
                rc = EINVAL
            if rc < 0:
                break
        return rc, data, out

    def _up_shard_targets(self, state: PGState, pool
                          ) -> List[Tuple[int, int]]:
        """[(shard, osd)] for up acting members; shard=-1 replicated."""
        out = []
        for idx, osd in enumerate(state.acting):
            if osd == CRUSH_ITEM_NONE or not self.osdmap.is_up(osd):
                continue
            shard = idx if pool.type == TYPE_ERASURE else -1
            out.append((shard, osd))
        return out

    def _min_size(self, pool) -> int:
        if pool.type == TYPE_ERASURE:
            codec = self._codec(pool.id)
            return max(pool.min_size, codec.get_data_chunk_count())
        return max(1, pool.min_size or 1)

    async def _submit_shard_writes(
            self, state: PGState, pool, oid: str,
            shard_ops: Dict[int, List[ShardOp]],
            entry: Optional[dict],
            admit_epoch: Optional[int] = None) -> int:
        """Fan out sub-writes to up shards (local applies directly);
        all must ack (sub_write_committed discipline).

        Sub-writes carry admit_epoch — the interval the op was admitted
        under — not the live epoch, so an op parked across an interval
        change can never outrun replica fencing."""
        pg = state.pg
        # EVERY primary mutation funnels through here: drop the
        # decoded-object tier entry BEFORE any shard changes so a
        # concurrent-looking read can never see post-write cached bytes
        self.tier.invalidate(pg, oid)
        if admit_epoch is None:
            admit_epoch = state.interval_epoch
        # fenced by a newer interval (a peering query outran our map, or
        # the interval changed after this op was admitted): stop
        # writing, incl. the local shard apply
        if self._epoch() < state.interval_epoch or \
                admit_epoch < state.interval_epoch:
            log.debug("osd.%d: write %s/%s fenced: admit %d, epoch %d,"
                      " interval %d", self.osd_id, pg, oid, admit_epoch,
                      self._epoch(), state.interval_epoch)
            return EAGAIN
        targets = self._up_shard_targets(state, pool)
        if len(targets) < self._min_size(pool):
            log.debug("osd.%d: write %s/%s: %d up targets < min_size %d",
                      self.osd_id, pg, oid, len(targets),
                      self._min_size(pool))
            return EAGAIN
        plog = self._load_log(state, pool)
        pending = []
        local_task: Optional[asyncio.Task] = None
        for shard, osd in targets:
            ops = shard_ops.get(shard)
            if ops is None:
                continue
            if osd == self.osd_id:
                t = Transaction()
                cid = self._cid(pg, shard)
                self._apply_shard_ops(t, cid, oid, ops,
                                      save_rollback=entry is not None)
                if entry is not None and \
                        ev(entry["version"]) > plog.info.last_update:
                    plog.append(entry)
                    plog.trim_to(
                        int(self.config["osd_min_pg_log_entries"]))
                plog.missing.pop(oid, None)
                plog.stage(t, cid)
                # group commit, concurrent with the remote fan-out:
                # the local barrier and the replica RTTs overlap, and
                # concurrent writers share one fsync.  The task is
                # created here (in the same sync section as the
                # plog.append above) so commit-lane order matches
                # version order.
                local_task = asyncio.get_running_loop().create_task(
                    self.committer.queue_transaction(t))
                # if this op is cancelled mid-gather the commit still
                # completes (as the old inline commit already had);
                # pre-retrieve so an orphaned failure cannot log
                # "exception never retrieved"
                local_task.add_done_callback(
                    lambda tk: None if tk.cancelled()
                    else tk.exception())
            else:
                tid = self._next_tid()
                self.perf["subwrite_bytes"] += sum(
                    len(op.data) for op in ops)
                pending.append(self._traced_subwrite(
                    osd, MOSDSubWrite(tid, pg, shard, oid, ops,
                                      admit_epoch, entry,
                                      self.osd_id), tid))
        replies = await asyncio.gather(*pending) if pending else []
        if local_task is not None:
            # raises what the local apply raised (as the inline call
            # did) — but only after the remote acks are in, so a local
            # failure cannot strand already-sent sub-writes unawaited
            await local_task
        # a shard that failed mid-write recovers via peering on the next
        # interval (its pg log lags); the write succeeds if enough
        # shards committed (min_size durability floor)
        acked = 1 + sum(1 for r in replies
                        if r is not None and r.rc == 0)
        if acked < self._min_size(pool):
            log.debug("osd.%d: write %s/%s: %d acks < min_size %d"
                      " (rcs=%s)", self.osd_id, pg, oid, acked,
                      self._min_size(pool),
                      [None if r is None else r.rc for r in replies])
            return EAGAIN
        full = len([s for s, _o in targets
                    if shard_ops.get(s) is not None])
        if entry is not None and acked == full:
            # every shard committed: the preserved previous generation
            # can never be needed again — trim it (the role of
            # ECBackend's rollback trim as log entries commit).  Awaited
            # (not fire-and-forget) so a sequential client's NEXT
            # overwrite — which clones a fresh rollback — cannot race
            # with this trim and lose its clone.
            await self._trim_rollbacks(state, oid, targets, admit_epoch,
                                       prior=ev(entry["prior"]))
        elif acked < full:
            # a shard missed the write WITHOUT an interval change (an
            # alive-but-slow peer timed out).  The reference's
            # invariant — sub-write failure implies peer death implies
            # re-peer implies log repair — does not hold for a soft
            # timeout, so nothing would fix the mixed-version object
            # until the next remap; EC reads below k would EIO.
            # Repair the object now through the scrub-repair path.
            self._schedule_object_repair(state, pool, oid)
        return 0

    def _schedule_object_repair(self, state: PGState, pool,
                                oid: str) -> None:
        """Deduplicated async single-object repair after a partially
        failed write fan-out."""
        key = (state.pg, oid)
        if key in self._pending_repairs or self._stopping:
            return
        self._pending_repairs.add(key)

        async def repair() -> None:
            try:
                # give straggler sub-writes a moment to land: the slow
                # peer may still apply, making the repair a no-op scan
                await asyncio.sleep(1.0)
                interval = state.interval_epoch
                async with state.obj_lock(oid):
                    if self._stopping or state.state != "active" or \
                            state.interval_epoch != interval or \
                            state.primary != self.osd_id:
                        return  # peering owns repair across intervals
                    run = {"objects": 0, "errors": 0, "repaired": 0}
                    await self._scrub_object(state, pool, oid, run)
                    if run["errors"]:
                        log.info(
                            "osd.%d: post-write repair of %s/%s:"
                            " %d inconsistencies, %d repaired",
                            self.osd_id, state.pg, oid,
                            run["errors"], run["repaired"])
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("osd.%d: post-write repair of %s/%s"
                              " failed", self.osd_id, state.pg, oid)
            finally:
                self._pending_repairs.discard(key)

        asyncio.get_running_loop().create_task(repair())

    async def _trim_rollbacks(self, state: PGState, oid: str,
                              targets: List[Tuple[int, int]],
                              epoch: int,
                              prior: Optional[tuple] = None) -> None:
        """Best-effort removal of each shard's rollback clone.

        guard=prior (the committed entry's previous generation): the
        clone this trim targets captured exactly that generation, so a
        trim that outlives its write — times out, stays in flight, and
        lands after a LATER write preserved a fresh clone — fails the
        replica's guard check instead of eating the fresh clone."""
        pg = state.pg
        rb = RB_PREFIX + oid
        pending = []
        for shard, osd in targets:
            try:
                if osd == self.osd_id:
                    cid = self._cid(pg, shard)
                    t = Transaction()
                    t.remove(cid, ObjectId(rb))
                    # post-ack trim rides the window (FIFO keeps it
                    # ordered before any later overwrite's clone)
                    await self.committer.queue_transaction(t)
                else:
                    tid = self._next_tid()
                    pending.append(self._request(
                        osd, MOSDSubWrite(tid, pg, shard, rb,
                                          [ShardOp("remove")],
                                          epoch, None, self.osd_id,
                                          guard=prior),
                        tid))
            except (KeyError, ConnectionError, OSError):
                pass  # a stale clone is only garbage
        if pending:
            # awaited on the client write path (post-ack, pre-return):
            # a slow peer here must not hide in osd_op self-time
            async with tracing.child_span("rollback_trim"):
                await asyncio.gather(*pending, return_exceptions=True)

    def _next_entry(self, state: PGState, pool, oid: str, op: str,
                    size: int = 0) -> dict:
        plog = self._load_log(state, pool)
        prior = plog.info.last_update
        version = (self._epoch(), state.next_version)
        state.next_version += 1
        return make_entry(version, prior, oid, op, size)

    async def _op_write_full(self, state: PGState, pool, oid: str,
                             data: bytes,
                             admit_epoch: Optional[int] = None,
                             snapc=None) -> Tuple[int, Dict[str, Any]]:
        # per-object lock on EVERY pool type: SnapSet updates are
        # read-modify-write and must not race other writes or trim.
        # Uncontended (the dominant small-write case), the lock is
        # taken synchronously (no per-op objlock coroutine round trip);
        # the contended path below is unchanged (span and all)
        ctx = state.obj_lock(oid)
        if ctx.try_enter():
            try:
                if pool.type == TYPE_ERASURE:
                    state.extent_cache.pop(oid, None)
                return await self._op_write_full_locked(
                    state, pool, oid, data, admit_epoch, snapc)
            finally:
                ctx.exit_sync()
        async with ctx:
            if pool.type == TYPE_ERASURE:
                state.extent_cache.pop(oid, None)
            return await self._op_write_full_locked(
                state, pool, oid, data, admit_epoch, snapc)

    async def _op_write_full_locked(
            self, state: PGState, pool, oid: str, data: bytes,
            admit_epoch: Optional[int] = None, snapc=None
    ) -> Tuple[int, Dict[str, Any]]:
        if isinstance(data, bytearray) or (
                isinstance(data, memoryview) and not data.readonly):
            # caller-mutable buffer (possible via the loopback fast
            # path): snapshot BEFORE the stores adopt views of it, or
            # a client reusing its buffer would corrupt durable shards
            # under already-recorded hinfo crcs
            data = bytes(data)
        clone_ops: List[ShardOp] = []
        ss_raw: Optional[bytes] = None
        if snapc is not None:
            clone_ops, ss_raw = await self._snap_clone_prep(
                state, pool, oid, snapc[0], snapc[1])
        out: Dict[str, Any] = {}
        if pool.type == TYPE_ERASURE:
            codec = self._codec(pool.id)
            sinfo = self._sinfo(pool.id)
            width = sinfo.get_stripe_width()
            pad = -len(data) % width
            # data may be a zero-copy memoryview of the op frame; only
            # materialize when padding actually forces a copy — and
            # then exactly ONE copy into a right-sized buffer (the
            # bytes(data) + bytes(pad) concat paid two)
            if pad:
                padbuf = bytearray(len(data) + pad)
                padbuf[:len(data)] = data
                padded = memoryview(padbuf).toreadonly()
            else:
                padded = data
            # awaited BEFORE the version is allocated: concurrent
            # writes batch their encodes into shared device dispatches
            # (encode_service), and no suspension point sits between
            # _next_entry and _submit_shard_writes — log entries still
            # land in version order
            shards, hinfo, data_crc = \
                await self.encode_service.encode_with_hinfo(
                    sinfo, codec, padded,
                    range(codec.get_chunk_count()),
                    logical_len=len(data))
        entry = self._next_entry(state, pool, oid, "modify", len(data))
        oi = json.dumps({"size": len(data),
                         "version": entry["version"]}).encode()
        if pool.type == TYPE_REPLICATED:
            ops = [ShardOp("create"), ShardOp("truncate", size=0),
                   ShardOp("write", 0, data),
                   ShardOp("setattr", name=OI_ATTR, value=oi)]
            shard_ops = {-1: ops}
        else:
            if data_crc is not None:
                # content digest back to the client (the librados
                # returnvec role): a gateway can derive its ETag from
                # this instead of re-reading the whole object
                out["data_crc"] = data_crc
            hinfo_raw = json.dumps(hinfo.to_dict()).encode()
            shard_ops = {}
            for shard in range(codec.get_chunk_count()):
                buf = shards.get(shard, b"")
                shard_ops[shard] = [
                    ShardOp("create"), ShardOp("truncate", size=0),
                    ShardOp("write", 0, buf),
                    ShardOp("setattr", name=OI_ATTR, value=oi),
                    ShardOp("setattr", name=HINFO_ATTR, value=hinfo_raw)]
        self._apply_snap_ops(shard_ops, clone_ops, ss_raw)
        rc = await self._submit_shard_writes(state, pool, oid,
                                             shard_ops, entry,
                                             admit_epoch)
        return rc, out

    @staticmethod
    def _apply_snap_ops(shard_ops: Dict[int, List[ShardOp]],
                        clone_ops: List[ShardOp],
                        ss_raw: Optional[bytes]) -> None:
        """Prepend the clone (captures pre-write state) and append the
        updated SnapSet attr on every shard's op list."""
        for ops in shard_ops.values():
            if clone_ops:
                ops[:0] = list(clone_ops)
            if ss_raw is not None:
                ops.append(ShardOp("setattr", name=SS_ATTR,
                                   value=ss_raw))

    async def _op_write(self, state: PGState, pool, oid: str,
                        offset: int, data: bytes,
                        admit_epoch: Optional[int] = None,
                        snapc=None, append: bool = False) -> int:
        """Partial-extent write.  Replicated: direct range write.
        EC: stripe-level read-modify-write (the start_rmw pipeline).
        Both under the per-object lock (SnapSet RMW must not race).
        append=True resolves the offset to the current object end
        INSIDE the lock so concurrent appends serialize correctly."""
        if isinstance(data, bytearray) or (
                isinstance(data, memoryview) and not data.readonly):
            # snapshot caller-mutable buffers before any store adopts a
            # view of them (same guard as _op_write_full_locked)
            data = bytes(data)
        async with state.obj_lock(oid):
            await self._wait_for_degraded(state, pool, oid)
            if append:
                oi, _ss = await self._head_info(state, pool, oid)
                offset = oi.get("size", 0) \
                    if oi is not None and not oi.get("whiteout") else 0
            if pool.type == TYPE_ERASURE:
                return await self._ec_rmw(state, pool, oid, offset,
                                          data, admit_epoch, snapc)
            clone_ops: List[ShardOp] = []
            ss_raw: Optional[bytes] = None
            if snapc is not None:
                clone_ops, ss_raw = await self._snap_clone_prep(
                    state, pool, oid, snapc[0], snapc[1])
            # stat BEFORE the version allocation: _next_entry consumes
            # state.next_version, and a suspension between allocation
            # and _submit_shard_writes would let a cancellation strand
            # the version (pg-log gap) or a concurrent write submit a
            # LATER version first (out-of-order log append) — the same
            # discipline _op_write_full_locked documents for its
            # encode awaits
            rc, old_size = await self._stat_size(state, pool, oid)
            new_size = max(old_size if rc == 0 else 0,
                           offset + len(data))
            entry = self._next_entry(state, pool, oid, "modify")
            oi = json.dumps({"size": new_size,
                             "version": entry["version"]}).encode()
            ops = [ShardOp("create"),
                   ShardOp("write", offset, data),
                   ShardOp("setattr", name=OI_ATTR, value=oi)]
            shard_ops = {-1: ops}
            self._apply_snap_ops(shard_ops, clone_ops, ss_raw)
            return await self._submit_shard_writes(state, pool, oid,
                                                   shard_ops, entry,
                                                   admit_epoch)

    async def _ec_rmw(self, state: PGState, pool, oid: str,
                      offset: int, data: bytes,
                      admit_epoch: Optional[int],
                      snapc=None) -> int:
        """Stripe-level EC read-modify-write (ECBackend start_rmw ->
        try_state_to_reads -> try_reads_to_commit,
        the reference's src/osd/ECBackend.cc:1858-2087, with the
        ExtentCache role played by state.extent_cache).

        Reads ONLY the touched stripes' chunk ranges (served from the
        extent cache when a preceding write on this object covered
        them), merges the new bytes, re-encodes just those stripes in
        one batched dispatch, and writes back per-shard chunk RANGES.
        Cumulative shard hashes cannot survive a mid-stream overwrite,
        so the hinfo drops its chunk hashes (the reference's
        set_total_chunk_size_clear_hash overwrite discipline); version
        agreement carries read consistency, scrub recomputes digests."""
        codec = self._codec(pool.id)
        sinfo = self._sinfo(pool.id)
        width = sinfo.get_stripe_width()
        chunk = sinfo.get_chunk_size()
        k = codec.get_data_chunk_count()
        n = codec.get_chunk_count()

        clone_ops: List[ShardOp] = []
        ss_raw: Optional[bytes] = None
        if snapc is not None:
            clone_ops, ss_raw = await self._snap_clone_prep(
                state, pool, oid, snapc[0], snapc[1])

        start, span = sinfo.offset_len_to_stripe_bounds(
            (offset, len(data)))
        cache = state.extent_cache.get(oid)

        old_size = None
        merged: Optional[bytearray] = None
        if cache is not None:
            missing_stripes = [
                s for s in range(start, start + span, width)
                if s not in cache["stripes"]]
            old_size = cache["size"]
            old_padded = -(-old_size // width) * width
            if not any(s < old_padded for s in missing_stripes):
                # cache + zero-fill covers the whole span: no reads
                merged = bytearray(span)
                for s in range(start, start + span, width):
                    frag = cache["stripes"].get(s)
                    if frag is not None:
                        merged[s - start:s - start + width] = frag
        if merged is None:
            # read the touched stripes' chunk ranges from the acting
            # shards and reconstruct the span
            chunk_off = (start // width) * chunk
            chunk_len = (span // width) * chunk
            candidates, _complete, version, good, oi = \
                await self._gather_and_select(
                    state, pool, oid, need=k, offset=chunk_off,
                    length=chunk_len)
            # an unfound object must not be zero-filled and overwritten
            # as if it never existed — block the write like the reads
            if not candidates:
                self._block_if_unfound(state, pool, oid)
            merged = bytearray(span)
            if candidates:
                if version is None:
                    self._block_if_unfound(state, pool, oid)
                    self._schedule_object_repair(state, pool, oid)
                    return EAGAIN
                self._require_fresh(state, pool, oid, version)
                old_size = oi.get("size", 0)
                old_padded = -(-old_size // width) * width
                # shards may come back short when the range reaches past
                # the old object end: pad to the span's chunk length
                frag_len = min(
                    chunk_len,
                    max(0, (old_padded // width) * chunk
                        - chunk_off))
                if frag_len > 0:
                    chosen_frags = ec_util.choose_decode_set(
                        codec, good, k,
                        prefer=self._shard_rank(state))
                    if chosen_frags is None:
                        return EIO
                    frags = {}
                    for s, payload in chosen_frags.items():
                        # view of the sub-read frame; pad the short-
                        # shard case with ONE right-sized copy
                        buf = memoryview(payload)[:frag_len]
                        if len(buf) < frag_len:
                            pb = bytearray(frag_len)
                            pb[:len(buf)] = buf
                            buf = memoryview(pb).toreadonly()
                        frags[s] = buf
                    self.perf["decode_dispatches"] += 1
                    decoded = await self.encode_service.decode(
                        sinfo, codec, frags)
                    merged[:len(decoded)] = decoded
            else:
                old_size = 0
        # overlay the client bytes
        rel = offset - start
        merged[rel:rel + len(data)] = data
        new_size = max(old_size or 0, offset + len(data))

        # re-encode awaited BEFORE the version is allocated (same
        # ordering discipline as _op_write_full_locked): concurrent
        # RMWs share a batched dispatch through the encode service.
        # ZERO materializations of the merged span: the local
        # bytearray never escapes or mutates past this point, so a
        # frozen view serves the encode AND the extent cache.
        self.perf["encode_dispatches"] += 1
        merged_b = memoryview(merged).toreadonly()
        shards = await self.encode_service.encode(
            sinfo, codec, merged_b, range(n))
        entry = self._next_entry(state, pool, oid, "modify", new_size)
        oi_raw = json.dumps({"size": new_size,
                             "version": entry["version"]}).encode()
        hinfo = ec_util.HashInfo(n)
        hinfo.set_total_chunk_size_clear_hash(
            (-(-new_size // width)) * chunk)
        hinfo_raw = json.dumps(hinfo.to_dict()).encode()
        chunk_off = (start // width) * chunk
        shard_ops = {}
        for shard in range(n):
            frag = shards.get(shard, b"")
            shard_ops[shard] = [
                ShardOp("create"),
                ShardOp("write", chunk_off, frag),
                ShardOp("setattr", name=OI_ATTR, value=oi_raw),
                ShardOp("setattr", name=HINFO_ATTR, value=hinfo_raw)]
        self._apply_snap_ops(shard_ops, clone_ops, ss_raw)
        rc = await self._submit_shard_writes(state, pool, oid,
                                             shard_ops, entry,
                                             admit_epoch)
        if rc == 0:
            self._cache_put(state, oid, entry["version"], new_size,
                            start, merged_b, width)
        else:
            state.extent_cache.pop(oid, None)
        return rc

    # extent-cache bookkeeping (bounded; coherent under the per-object
    # lock + single-primary discipline; dropped on interval change)
    _CACHE_MAX_STRIPES = 256

    def _cache_put(self, state: PGState, oid: str, version, size: int,
                   start: int, span_bytes: bytes, width: int) -> None:
        entry = state.extent_cache.get(oid)
        if entry is None or entry.get("version") is None:
            entry = {"version": version, "size": size, "stripes": {}}
        entry["version"] = version
        entry["size"] = size
        for s in range(0, len(span_bytes), width):
            entry["stripes"][start + s] = span_bytes[s:s + width]
        state.extent_cache.pop(oid, None)
        state.extent_cache[oid] = entry
        total = sum(len(e["stripes"])
                    for e in state.extent_cache.values())
        while total > self._CACHE_MAX_STRIPES and state.extent_cache:
            _old_oid, old_e = state.extent_cache.popitem(last=False)
            total -= len(old_e["stripes"])

    async def _stat_size(self, state: PGState, pool, oid: str
                         ) -> Tuple[int, int]:
        rc, out = await self._op_stat(state, pool, oid)
        return rc, out.get("size", 0)

    def _pg_is_clean(self, state: PGState, pool, oid: str) -> bool:
        plog = self._load_log(state, pool)
        if oid in plog.missing:
            return False
        return not any(oid in m for m in state.peer_missing.values())

    async def _wait_for_degraded(self, state: PGState, pool,
                                 oid: str) -> None:
        """wait_for_degraded_object role (PrimaryLogPG.cc): a PARTIAL
        mutation (extent write, EC RMW, xattr, omap) on an object some
        acting member is missing must not proceed — on the missing
        replica it would create a hole-ridden partial object under a
        current-looking version.  Recover the object inline first
        (caller holds the object lock, so background recovery of this
        object cannot interleave); if it stays missing, the data is
        unfound and the op blocks (EAGAIN) rather than inventing state.

        Full-object overwrites (write_full, remove) do NOT come here:
        they supersede every shard's content and double as recovery-by-
        overwrite."""
        if self._pg_is_clean(state, pool, oid):
            return
        await self._recover_object(state, pool, oid,
                                   self._acting_peer_shards(state, pool))
        if not self._pg_is_clean(state, pool, oid):
            raise UnfoundObject(oid)

    def _acting_peer_shards(self, state: PGState, pool
                            ) -> Dict[int, int]:
        """shard_key -> osd for every UP acting member except me (EC:
        positional shard; replicated: unique -(idx+2) key per replica)."""
        peer_shards: Dict[int, int] = {}
        for idx, osd in enumerate(state.acting):
            if osd == CRUSH_ITEM_NONE or osd == self.osd_id or \
                    not self.osdmap.is_up(osd):
                continue
            shard_key = idx if pool.type == TYPE_ERASURE else -(idx + 2)
            peer_shards[shard_key] = osd
        return peer_shards

    def _block_if_unfound(self, state: PGState, pool, oid: str) -> None:
        """Called when an op could not locate/decode an object's data:
        if the PG log still says the object exists (it is in a missing
        set), the acked bytes live on a source that is currently down
        or unprobed — UNFOUND.  Block the op (EAGAIN via UnfoundObject,
        the waiting_for_unreadable_object role) instead of reporting
        ENOENT/EIO or zero-filling — any of those would invent a
        deletion or corruption the log never recorded."""
        if not self._pg_is_clean(state, pool, oid):
            raise UnfoundObject(oid)

    def _acked_version(self, state: PGState, pool, oid: str) -> tuple:
        """Newest version any missing set records as acked for oid."""
        plog = self._load_log(state, pool)
        need = plog.missing.get(oid) or ZERO
        for m in state.peer_missing.values():
            nv = m.get(oid) or ZERO
            if nv > need:
                need = nv
        return need

    def _require_fresh(self, state: PGState, pool, oid: str,
                       version) -> None:
        """Serving a version OLDER than the acked one in a missing set
        would expose a rolled-back write while its real holder is down
        (reads and recovery must agree on the acked-write invariant —
        recovery's need_v guard is the other half)."""
        if version is not None and \
                self._acked_version(state, pool, oid) > version:
            raise UnfoundObject(oid)

    # -- read tier agent (HitSet + PrimaryLogPG agent role) ----------------

    def _persist_sealed_hitsets(self) -> None:
        """Archive sealed hit sets into the pg-meta object's omap
        under the hitset_ key prefix (hit_set persistence role),
        trimming entries that decayed off the stack."""
        for pg, seq, hs in self.tier.pop_sealed():
            state = self.pgs.get(pg)
            pool = self.osdmap.pools.get(pg.pool) \
                if self.osdmap else None
            if state is None or pool is None:
                continue
            shard = state.my_shard(self.osd_id, pool.type)
            cid = self._cid(pg, shard)
            meta = ObjectId(PGMETA_OID)
            t = Transaction()
            t.touch(cid, meta)
            t.omap_setkeys(cid, meta, {
                f"{HITSET_OMAP_PREFIX}{seq:08d}":
                    json.dumps(hs.to_dict()).encode()})
            stale = seq - max(self.tier.hit_set_count - 1, 1)
            if stale >= 1:
                # trim a WINDOW, not just one key: sealed-ring
                # overflow (quiet persisting path) can skip seqs, and
                # a single-key trim would strand their archives in
                # the omap forever
                t.omap_rmkeys(cid, meta, [
                    f"{HITSET_OMAP_PREFIX}{s:08d}"
                    for s in range(max(1, stale - 63), stale + 1)])
            try:
                self.store.queue_transaction(t)
            except (KeyError, IOError):
                pass  # shard collection gone (interval churn)

    def _tier_kick_promote(self, state: PGState, pool,
                           oid: str) -> None:
        """Spawn one deduplicated, inflight-capped promotion task."""
        if self._stopping or \
                not self.tier.begin_promote(state.pg, oid):
            return
        task = asyncio.get_running_loop().create_task(
            self._tier_promote(state, pool, oid))
        self._promote_tasks.add(task)
        task.add_done_callback(self._promote_tasks.discard)

    async def _tier_promote(self, state: PGState, pool,
                            oid: str) -> None:
        """Agent promotion: decode the whole object ONCE through the
        cold read path and install the bytes in the tier.  Runs under
        the mClock background_best_effort class (client reads keep
        their reservation; a promotion storm is throttled, never
        starves I/O) and under the per-object lock, so the install
        cannot race a writer's invalidation."""
        pg = state.pg
        interval = state.interval_epoch
        installed = False
        span = self.tracer.start(f"tier_promote {pg} {oid}")
        # install as current: create_task copied the kicking READ's
        # context, so without this the promotion's queue/objlock stage
        # spans would parent into the CLIENT op's tree and the
        # still-running promote would own the op's critical-path tail
        token = tracing.current_span.set(span if span else None)
        try:
            async def decode_and_install():
                nonlocal installed
                async with state.obj_lock(oid):
                    if self._stopping or state.state != "active" or \
                            state.interval_epoch != interval or \
                            state.primary != self.osd_id:
                        span.event("aborted: interval/teardown")
                        return
                    rc, payload = await self._op_read(
                        state, pool, oid, 0, 0, use_tier=False)
                    if rc != 0:
                        span.event(f"decode rc={rc}")
                        return
                    # the decode awaited: re-check the interval (it
                    # only ever advances) — a map flap during the
                    # decode may have let another primary commit
                    # writes this daemon never saw, and drop_pg has
                    # already run; installing would cache stale bytes
                    # nothing will invalidate
                    if self._stopping or \
                            state.interval_epoch != interval or \
                            state.primary != self.osd_id:
                        span.event("aborted: interval moved mid-decode")
                        return
                    self.tier.end_promote(pg, oid,
                                          buffer_mod.adopt(payload))
                    installed = True
                    span.event(f"promoted {len(payload)}B")
            await self.scheduler.run(sched_mod.BEST_EFFORT, 4.0,
                                     decode_and_install)
        except asyncio.CancelledError:
            pass                      # daemon teardown
        except (RuntimeError, UnfoundObject):
            pass                      # scheduler stopped / degraded
        except Exception:
            log.exception("osd.%d: tier promote %s/%s failed",
                          self.osd_id, pg, oid)
        finally:
            tracing.current_span.reset(token)
            if not installed:
                self.tier.end_promote(pg, oid, None)
            self.tracer.finish(span)

    @staticmethod
    def _tier_slice(data: bytes, offset: int, length: int) -> bytes:
        """Slice a cached decoded object exactly like the cold path
        slices its decode output (same offset/length semantics, so the
        bypass is bit-identical).  Returns a VIEW — the reply encoder
        writes it to the wire without materializing."""
        if offset >= len(data):
            return b""
        view = memoryview(data)
        if length:
            return view[offset:offset + length]
        if offset:
            return view[offset:]
        return data

    async def _op_read(self, state: PGState, pool, oid: str,
                       offset: int, length: int,
                       use_tier: bool = True
                       ) -> Tuple[int, bytes]:
        # hot-set tracking + read tier: record the read, serve a
        # promoted EC object straight from the decoded-object cache
        # (zero EC plan dispatches), and kick an agent promotion when
        # the hit count crosses osd_tier_promote_min_recency.
        # use_tier=False is the promotion decode itself (and the
        # coherency tests' cold-path oracle).
        tracked = (use_tier and self.tier.enabled
                   and not is_internal_name(oid))
        if tracked:
            self.tier.record_read(state.pg, oid)
            if self.tier.sealed_pending():
                self._persist_sealed_hitsets()
            if pool.type == TYPE_ERASURE:
                cached = self.tier.lookup(state.pg, oid)
                if cached is not None:
                    return 0, self._tier_slice(cached, offset, length)
                # promote signal only on a miss: a steady-state tier
                # hit skips the archived-bloom probes entirely
                hit_count = self.tier.hit_count(state.pg, oid)
                if self.tier.wants_promote(state.pg, oid, hit_count):
                    self._tier_kick_promote(state, pool, oid)
        if pool.type == TYPE_REPLICATED:
            # fast path: primary serves from its own copy when the
            # object is fully recovered (the reference's normal read)
            if self._pg_is_clean(state, pool, oid):
                shard = state.my_shard(self.osd_id, pool.type)
                rc, data, at = self._read_shard(state.pg, shard, oid)
                if rc == 0 and OI_ATTR in at:
                    oi = json.loads(at[OI_ATTR])
                    if oi.get("whiteout"):
                        return ENOENT, b""
                    # view slices end to end: the reply encoder
                    # writes the range straight from the store buffer
                    view = memoryview(data)[:oi.get("size",
                                                    len(data))]
                    if length:
                        view = view[offset:offset + length]
                    elif offset:
                        view = view[offset:]
                    return 0, view
                if rc == ENOENT:
                    return ENOENT, b""
            candidates, _complete, version, chosen, oi = \
                await self._gather_and_select(state, pool, oid,
                                              need=1, record=tracked)
            if not candidates:
                self._block_if_unfound(state, pool, oid)
                return ENOENT, b""
            if version is None:
                self._block_if_unfound(state, pool, oid)
                return EIO, b""
            self._require_fresh(state, pool, oid, version)
            if oi.get("whiteout"):
                return ENOENT, b""
            # view slices over the sub-read reply's frame buffer
            view = memoryview(chosen[next(iter(chosen))])
            view = view[:oi.get("size", len(view))]
            if length:
                view = view[offset:offset + length]
            elif offset:
                view = view[offset:]
            return 0, view
        codec = self._codec(pool.id)
        sinfo = self._sinfo(pool.id)
        k = codec.get_data_chunk_count()
        width = sinfo.get_stripe_width()
        chunk = sinfo.get_chunk_size()
        if length > 0:
            # ranged read: fetch ONLY the touched stripes' chunk ranges
            # (get_want_to_read_shards, ECBackend.cc:2380) — a 4 KiB
            # read of a large object moves O(stripe), not O(object).
            # Consistency rides version agreement; the whole-shard crc
            # cannot be checked on a fragment (scrub's job).
            start, span = sinfo.offset_len_to_stripe_bounds(
                (offset, length))
            chunk_off = (start // width) * chunk
            chunk_len = (span // width) * chunk
            candidates, _complete, version, good, oi = \
                await self._gather_and_select(
                    state, pool, oid, need=k, offset=chunk_off,
                    length=chunk_len, record=tracked)
            if not candidates:
                self._block_if_unfound(state, pool, oid)
                return ENOENT, b""
            if version is None:
                self._block_if_unfound(state, pool, oid)
                # clean PG but no k-agreement: a soft-failed write
                # left mixed generations — repair + client retry
                self._schedule_object_repair(state, pool, oid)
                return EAGAIN, b""
            self._require_fresh(state, pool, oid, version)
            if oi.get("whiteout"):
                return ENOENT, b""
            size = oi.get("size", 0)
            if offset >= size:
                return 0, b""
            padded = -(-size // width) * width
            frag_len = min(chunk_len,
                           max(0, (padded // width) * chunk - chunk_off))
            if frag_len <= 0:
                return 0, b""
            chosen_frags = ec_util.choose_decode_set(
                codec, good, k, prefer=self._shard_rank(state))
            if chosen_frags is None:
                return EIO, b""
            frags = {}
            for s, payload in chosen_frags.items():
                # view of the sub-read frame; the short-shard case
                # (reads past the object end) pads with ONE
                # right-sized copy
                buf = memoryview(payload)[:frag_len]
                if len(buf) < frag_len:
                    pb = bytearray(frag_len)
                    pb[:len(buf)] = buf
                    buf = memoryview(pb).toreadonly()
                frags[s] = buf
            self.perf["decode_dispatches"] += 1
            data = await self.encode_service.decode(sinfo, codec,
                                                    frags)
            rel = offset - start
            return 0, memoryview(data)[
                rel:rel + min(length, size - offset)]
        # newest version with >= k intact same-version shards wins;
        # hinfo crc drops corrupt shards (handle_sub_read's verify)
        candidates, _complete, version, good, oi = \
            await self._gather_and_select(state, pool, oid, need=k,
                                          verify_hinfo=True,
                                          record=tracked)
        if not candidates:
            self._block_if_unfound(state, pool, oid)
            return ENOENT, b""
        if version is None:
            self._block_if_unfound(state, pool, oid)
            self._schedule_object_repair(state, pool, oid)
            return EAGAIN, b""
        self._require_fresh(state, pool, oid, version)
        if oi.get("whiteout"):
            return ENOENT, b""
        size = oi.get("size", 0)
        frags = ec_util.choose_decode_set(
            codec, good, k, prefer=self._shard_rank(state))
        if frags is None:
            return EIO, b""
        self.perf["decode_dispatches"] += 1
        data = await self.encode_service.decode(sinfo, codec, frags)
        # view slices over the decode output
        view = memoryview(data)[:size]
        if length:
            view = view[offset:offset + length]
        elif offset:
            view = view[offset:]
        return 0, view

    async def _op_stat(self, state: PGState, pool, oid: str
                       ) -> Tuple[int, Dict[str, Any]]:
        # stat needs attrs + version agreement only: fetch one byte per
        # shard, not the whole payload — and only the first `need`
        # consistent answers (hedged)
        need = self._codec(pool.id).get_data_chunk_count() \
            if pool.type == TYPE_ERASURE else 1
        candidates, _complete, version, _chosen, oi = \
            await self._gather_and_select(state, pool, oid,
                                          need=need, length=1)
        if not candidates:
            self._block_if_unfound(state, pool, oid)
            return ENOENT, {}
        if version is None:
            self._block_if_unfound(state, pool, oid)
            return EIO, {}
        self._require_fresh(state, pool, oid, version)
        if oi.get("whiteout"):
            return ENOENT, {}
        return 0, {"size": oi.get("size", 0),
                   "version": oi.get("version")}

    async def _op_remove(self, state: PGState, pool, oid: str,
                         admit_epoch: Optional[int] = None,
                         snapc=None) -> int:
        async with state.obj_lock(oid):
            state.extent_cache.pop(oid, None)
            # the whiteout decision depends on the HEAD's SnapSet, not
            # on whether the deleting client supplied a snap context: a
            # snapless client's remove must never orphan live clones
            oi, ss = await self._head_info(state, pool, oid)
            if oi is None or oi.get("whiteout"):
                return ENOENT
            clone_ops: List[ShardOp] = []
            ss_raw: Optional[bytes] = None
            if snapc is not None:
                clone_ops, ss_raw = await self._snap_clone_prep(
                    state, pool, oid, snapc[0], snapc[1],
                    head=(oi, ss))
                if ss_raw is not None:
                    ss = json.loads(ss_raw)
            if pool.type == TYPE_REPLICATED:
                shards = [-1]
            else:
                shards = list(
                    range(self._codec(pool.id).get_chunk_count()))
            if clone_ops or ss.get("clones"):
                # snapshots still reference this object's data: the
                # head becomes a WHITEOUT carrying the SnapSet until
                # every clone is trimmed (the snapdir/whiteout role)
                entry = self._next_entry(state, pool, oid, "modify")
                oi_raw = json.dumps(
                    {"size": 0, "whiteout": True,
                     "version": entry["version"]}).encode()
                ops = [ShardOp("truncate", size=0),
                       ShardOp("setattr", name=OI_ATTR, value=oi_raw)]
                shard_ops = {s: list(ops) for s in shards}
                self._apply_snap_ops(shard_ops, clone_ops,
                                     ss_raw or json.dumps(ss).encode())
                return await self._submit_shard_writes(
                    state, pool, oid, shard_ops, entry, admit_epoch)
            entry = self._next_entry(state, pool, oid, "delete")
            shard_ops = {s: [ShardOp("remove")] for s in shards}
            return await self._submit_shard_writes(state, pool, oid,
                                                   shard_ops, entry,
                                                   admit_epoch)

    # -- xattr / omap client ops (the ObjectOperation attr surface) --------

    async def _op_setxattr(self, state: PGState, pool, oid: str,
                           name: str, value: Optional[bytes],
                           admit_epoch: Optional[int],
                           snapc=None) -> int:
        """Set (value) or remove (value=None) a USER xattr — a logged,
        versioned write on every shard (attrs are object metadata and
        ride with the object through snapshots and recovery)."""
        async with state.obj_lock(oid):
            await self._wait_for_degraded(state, pool, oid)
            oi, _ss = await self._head_info(state, pool, oid)
            if oi is None or oi.get("whiteout"):
                return ENOENT
            clone_ops: List[ShardOp] = []
            ss_raw: Optional[bytes] = None
            if snapc is not None:
                clone_ops, ss_raw = await self._snap_clone_prep(
                    state, pool, oid, snapc[0], snapc[1],
                    head=(oi, _ss))
            entry = self._next_entry(state, pool, oid, "modify",
                                     oi.get("size", 0))
            oi_raw = json.dumps({"size": oi.get("size", 0),
                                 "version": entry["version"]}).encode()
            key = USER_ATTR_PREFIX + name
            if value is None:
                attr_op = ShardOp("rmattr", name=key)
            else:
                attr_op = ShardOp("setattr", name=key, value=value)
            ops = [attr_op,
                   ShardOp("setattr", name=OI_ATTR, value=oi_raw)]
            if pool.type == TYPE_REPLICATED:
                shard_ops = {-1: list(ops)}
            else:
                n = self._codec(pool.id).get_chunk_count()
                shard_ops = {s: list(ops) for s in range(n)}
            self._apply_snap_ops(shard_ops, clone_ops, ss_raw)
            return await self._submit_shard_writes(state, pool, oid,
                                                   shard_ops, entry,
                                                   admit_epoch)

    async def _op_getxattr(self, state: PGState, pool, oid: str,
                           name: str) -> Tuple[int, bytes]:
        rc, attrs = await self._gather_user_attrs(state, pool, oid)
        if rc != 0:
            return rc, b""
        value = attrs.get(name)
        if value is None:
            return -61, b""  # ENODATA
        return 0, value

    async def _op_getxattrs(self, state: PGState, pool, oid: str
                            ) -> Tuple[int, Dict[str, Any]]:
        rc, attrs = await self._gather_user_attrs(state, pool, oid)
        if rc != 0:
            return rc, {}
        # JSON reply surface: values as latin-1-safe strings
        return 0, {"xattrs": {k: v.decode("latin-1")
                              for k, v in attrs.items()}}

    async def _gather_user_attrs(self, state: PGState, pool, oid: str
                                 ) -> Tuple[int, Dict[str, bytes]]:
        need = self._codec(pool.id).get_data_chunk_count() \
            if pool.type == TYPE_ERASURE else 1
        candidates, _complete, version, chosen, oi = \
            await self._gather_and_select(state, pool, oid,
                                          need=need, length=1)
        if not candidates:
            self._block_if_unfound(state, pool, oid)
            return ENOENT, {}
        if version is None:
            self._block_if_unfound(state, pool, oid)
            return EIO, {}
        self._require_fresh(state, pool, oid, version)
        if oi.get("whiteout"):
            return ENOENT, {}
        src = next(iter(chosen))
        for shard, _payload, at in candidates:
            if shard == src and self._oi_version(at) == version:
                return 0, {k[len(USER_ATTR_PREFIX):]: v
                           for k, v in at.items()
                           if k.startswith(USER_ATTR_PREFIX)}
        return 0, {}

    # -- watch / notify (linger op surface, Objecter linger role) ----------

    async def _op_omap_write(self, state: PGState, pool, oid: str,
                             kind: str, payload: bytes,
                             admit_epoch: Optional[int],
                             snapc=None) -> int:
        """omap set/rm — REPLICATED pools only, like the reference
        (EC pools reject omap: PrimaryLogPG EOPNOTSUPP).  Honors the
        write snap context like data writes do (make_writeable clones
        before ANY mutation, omap included — the store-level clone op
        copies omap, so snap reads of the clone see the old keys)."""
        if pool.type == TYPE_ERASURE:
            return EOPNOTSUPP
        async with state.obj_lock(oid):
            await self._wait_for_degraded(state, pool, oid)
            oi, ss = await self._head_info(state, pool, oid)
            clone_ops: List[ShardOp] = []
            ss_raw: Optional[bytes] = None
            if snapc is not None:
                clone_ops, ss_raw = await self._snap_clone_prep(
                    state, pool, oid, snapc[0], snapc[1],
                    head=(oi, ss))
            size = oi.get("size", 0) \
                if oi is not None and not oi.get("whiteout") else 0
            entry = self._next_entry(state, pool, oid, "modify", size)
            oi_raw = json.dumps({"size": size,
                                 "version": entry["version"]}).encode()
            ops = [ShardOp("create"),
                   ShardOp(kind, data=payload),
                   ShardOp("setattr", name=OI_ATTR, value=oi_raw)]
            shard_ops = {-1: ops}
            self._apply_snap_ops(shard_ops, clone_ops, ss_raw)
            return await self._submit_shard_writes(state, pool, oid,
                                                   shard_ops, entry,
                                                   admit_epoch)

    async def _op_omap_get(self, state: PGState, pool, oid: str
                           ) -> Tuple[int, bytes]:
        if pool.type == TYPE_ERASURE:
            return EOPNOTSUPP, b""
        # existence/whiteout gate first: stores differ on whether a
        # never-created object's omap read errors, and a
        # snapshot-deleted (whiteout) head must read as gone
        oi, _ss = await self._head_info(state, pool, oid)
        if oi is None or oi.get("whiteout"):
            return ENOENT, b""
        # omap is identical on every replica; serve locally when clean,
        # else from any up replica via a want_omap sub-read
        if self._pg_is_clean(state, pool, oid):
            cid = self._cid(state.pg, -1)
            try:
                omap = self.store.omap_get(cid, ObjectId(oid))
            except (KeyError, IOError):
                return ENOENT, b""
            return 0, encode_kv_map(omap)
        for idx, osd in enumerate(state.acting):
            if osd == CRUSH_ITEM_NONE or not self.osdmap.is_up(osd) \
                    or osd == self.osd_id:
                continue
            tid = self._next_tid()
            reply = await self._request(
                osd, MOSDSubRead(tid, state.pg, -1, oid, 0, 1,
                                 want_omap=True), tid)
            if reply is not None and reply.rc == 0:
                return 0, encode_kv_map(reply.omap)
        return EAGAIN, b""

    # -- watch / notify (linger op surface, Objecter linger role) ----------

    def _op_watch(self, state: PGState, pool, msg: MOSDOp,
                  conn: Optional[Connection], cookie: int,
                  unwatch: bool) -> int:
        """Register/unregister this connection as a watcher of the
        object.  Watch state is primary-local and in-memory — clients
        re-register on map changes (the Objecter linger resend role)."""
        key = (pool.id, msg.oid)
        table = self.watchers.setdefault(key, {})
        if unwatch:
            table.pop((msg.client, cookie), None)
            if not table:
                self.watchers.pop(key, None)
            return 0
        if conn is None:
            return EINVAL
        table[(msg.client, cookie)] = conn
        return 0

    async def _op_call(self, state: PGState, pool, oid: str,
                       cls: str, method: str, data: bytes,
                       admit_epoch: int, snapc,
                       read_only: bool = False) -> Tuple[int, bytes]:
        """`exec` op: run a registered object-class method
        (ClassHandler::ClassMethod::exec, PrimaryLogPG::do_osd_ops
        CEPH_OSD_OP_CALL).  Concurrent calls on one object serialize
        on a per-object cls lock, so read-modify-write methods
        (numops, lock) are atomic against each other; each inner op
        additionally takes the normal object lock on its own.  A WR
        method's writes go down the pool's own write path, so on an
        EC pool they encode through the encode service."""
        from ceph_tpu_torch.cls import ClsError, MethodContext

        # method input stays the wire decode's zero-copy view: class
        # methods parse through cls.as_text (str() decodes any
        # buffer) or take bytes() themselves where they genuinely
        # need to own the payload
        entry = self.class_handler.lookup(cls, method)
        if entry is None:
            return EINVAL, b""
        fn, flags = entry
        from ceph_tpu_torch.cls import WR as CLS_WR

        if read_only and flags & CLS_WR:
            # a WR method at a snap would mutate the immutable clone
            # the read resolved to (the reference's -EROFS for writes
            # at a non-head snapid)
            return -30, b""  # EROFS
        ctx = MethodContext(self, state, pool, oid, admit_epoch,
                            snapc, flags)
        async with state.obj_lock(f"_cls_\x00{oid}"):
            try:
                return 0, await fn(ctx, data)
            except ClsError as e:
                return e.rc, b""
            except UnfoundObject:
                raise
            except Exception:
                log.exception("osd.%d: cls %s.%s on %r failed",
                              self.osd_id, cls, method, oid)
                return EIO, b""

    async def _op_notify(self, state: PGState, pool, oid: str,
                         payload: bytes
                         ) -> Tuple[int, Dict[str, Any]]:
        """Fan the notify out to every live watcher and wait for acks
        (watch_notify timeout discipline)."""
        key = (pool.id, oid)
        table = dict(self.watchers.get(key, {}))
        live = {k: c for k, c in table.items() if not c.closed}
        self._notify_seq += 1
        notify_id = self._notify_seq
        if not live:
            return 0, {"acked": [], "missed": []}
        event = asyncio.Event()
        pending = {"want": set(live), "acks": set(), "event": event}
        self._pending_notifies[notify_id] = pending
        try:
            for (client, cookie), wconn in live.items():
                try:
                    await wconn.send(MWatchNotify(
                        notify_id, pool.id, oid, payload, cookie))
                except (ConnectionError, OSError):
                    pending["want"].discard((client, cookie))
            # acks may have landed during the sends (each send is a
            # yield point), and failed sends shrink the want set — only
            # wait if someone is still outstanding
            if pending["want"] - pending["acks"]:
                try:
                    await asyncio.wait_for(
                        event.wait(),
                        float(self.config.get("osd_notify_timeout",
                                              5.0)))
                except asyncio.TimeoutError:
                    pass
            # watchers are identified by (client, cookie): cookies are
            # per-client counters and collide across clients
            acked = sorted([cl, c] for cl, c in pending["acks"])
            missed = sorted([cl, c] for cl, c in
                            pending["want"] - pending["acks"])
            return 0, {"acked": acked, "missed": missed}
        finally:
            self._pending_notifies.pop(notify_id, None)

    def _handle_notify_ack(self, conn: Connection,
                           msg: MWatchNotifyAck) -> None:
        pending = self._pending_notifies.get(msg.notify_id)
        if pending is None:
            return
        for who in list(pending["want"]):
            if who[1] == msg.cookie and \
                    who[0] == conn.peer_name:
                pending["acks"].add(who)
        if pending["acks"] >= pending["want"]:
            pending["event"].set()

    def _op_pgls(self, state: PGState, pool
                 ) -> Tuple[int, Dict[str, Any]]:
        shard = state.my_shard(self.osd_id, pool.type)
        cid = self._cid(state.pg, shard)
        names = []
        try:
            for o in self.store.list_objects(cid):
                name = str(o)
                if name == PGMETA_OID or is_internal_name(name):
                    continue
                try:  # whiteouts (deleted heads kept for snaps) hidden
                    oi = json.loads(self.store.getattr(
                        cid, o, OI_ATTR))
                    if oi.get("whiteout"):
                        continue
                except (KeyError, ValueError):
                    pass
                names.append(name)
        except KeyError:
            pass
        return 0, {"objects": sorted(names)}
