"""MDS role: the filesystem metadata server (port of
ceph_tpu/mds/__init__.py).

Reference parity: the ceph-mds daemon
(Ceph's src/mds/MDSDaemon.cc, MDCache.cc, Server.cc) — a
single ACTIVE metadata server owns the namespace, serializes every
metadata mutation, and stores directories as objects in a METADATA
pool (one object per directory fragment, dentries in omap —
CDir::commit, src/mds/CDir.cc).  Clients send MClientRequest ops for
metadata and do file DATA I/O directly against the data pool.

Re-designs vs the reference, deliberate:

- The MDS JOURNAL (MDLog/EUpdate role, src/mds/journal.cc): every
  metadata mutation — including compound ones like rename — is first
  appended as ONE fenced journal entry (cls_journal on `mds_journal`),
  then applied write-through to the directory objects.  Takeover
  replays entries past the applied watermark before serving, so a
  crash mid-compound-op always converges to the journaled state:
  a SIGKILL mid-rename yields exactly-src (append never landed) or
  exactly-dst (append landed, replay finishes it) — never both, never
  neither.
- FENCING (the mon-blocklist role): the journal object carries an
  epoch; takeover bumps it (cls `take_over`) and every append/trim
  from the deposed epoch fails EPERM server-side — a partitioned
  ex-active physically cannot mutate metadata, with no cross-host
  clock comparison anywhere.  Staleness detection for lock takeover
  uses RENEWAL COUNTERS aged by the standby's own monotonic clock.
- Active/standby election rides cls_lock: the active MDS holds an
  exclusive lock on the `mds_lock` object (renewed on a heartbeat
  interval, stored with its address); a standby polls, breaks a stale
  lock, and takes over (the mon's MDSMap beacon machinery, collapsed
  onto the object-lock it ultimately implements).
- Inode numbers come from an atomic numops counter object (InoTable
  role, src/mds/InoTable.h).
- MULTI-ACTIVE (the multimds/Migrator/MDBalancer role, re-designed):
  N ranks each own a static namespace partition — root-parented
  entries at rank 0, everything under top-level dir c at hash(c)
  (the export-pin shape, src/mds/MDSMap.h, as a hash rule instead of
  an operator attribute).  Because metadata lives in SHARED rados
  behind guarded per-object ops, ranks are serialization domains, not
  data silos: each rank has its own lock object, journal and standby
  chain; foreign directories are readable by any rank (uncached);
  exactly one rank ever mutates a given directory object.  Cross-rank
  FILE renames are a durable-intent protocol: the src rank journals a
  rename_intent, the DST rank links the dentry under its own lock,
  journal and fencing epoch (peer_link, idempotent), then the src
  rank commits the removal + a rename_finish marker — takeover
  re-drives unfinished intents.  Top-level rmdir asks the owner rank
  to adjudicate emptiness and fence creates (peer_rmdir_begin/done,
  TTL-bounded dying mark); the owner removes the dir object under its
  own epoch.  DIRECTORY renames that re-home a subtree run the
  SUBTREE EXPORT protocol (the Migrator role, src/mds/Migrator.cc):
  the importer rank re-creates the tree under fresh inos in its own
  fencing domain and the exporter purges the old objects — no
  cross-rank epoch comparison anywhere (see _export_subtree).
  Clients route by the same rule from the published mds_map object.

Layout in the metadata pool:
  mds_lock[.r]             cls_lock state + rank r's MDS addr (xattr)
  mds_journal[.r]          fenced journal (cls_journal omap entries)
  mds_map                  JSON: {"num_ranks": N}
  mds_ino                  omap: {"next": counter} (shared, atomic)
  dir.<ino:x>              omap: dentry name -> inode JSON
File data objects (data pool): fsdata.<ino:x>.<blockno:016x>
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Any, Dict, Optional, Tuple

from ceph_tpu_torch.common import lockdep
from ceph_tpu_torch.msg import Connection, Messenger
from ceph_tpu_torch.msg.messages import (
    MClientCaps,
    MClientReply,
    MClientRequest,
    Message,
)
from ceph_tpu_torch.rados.client import (
    IoCtx,
    ObjectNotFound,
    RadosClient,
    RadosError,
)

log = logging.getLogger("mds")

EPERM = -1
ENOENT = -2
EIO = -5
EEXIST = -17
EXDEV = -18
ENOTDIR = -20
EISDIR = -21
EINVAL = -22
ENOTEMPTY = -39
ESTALE = -116

EROFS = -30
EAGAIN = -11
EFBIG = -27
EBUSY = -16

ROOT_INO = 1
LOCK_OBJ = "mds_lock"
INO_OBJ = "mds_ino"
JOURNAL_OBJ = "mds_journal"
MDSMAP_OBJ = "mds_map"
# SnapServer role (src/mds/SnapServer.h): the cluster-wide snapshot
# table.  One omap key per snapshot (never read-modify-written, so
# ranks write concurrently without coordination): key = the data-pool
# snapid zero-padded, value = JSON {name, ino, meta_snap, data_snap,
# ctime}.  COW itself is the RADOS self-managed snap machinery: each
# CephFS snapshot allocates ONE snapid per pool (metadata + data);
# every writer (MDS dir-omap mutations, client file-data writes)
# carries the union of live snapids as its snap context, so the OSDs
# clone heads before the first post-snap mutation.  ".snap" paths
# resolve by reading dir objects AT the metadata snapid and file
# blocks AT the data snapid.
SNAPTABLE_OBJ = "mds_snaptable"
# version counter key inside the snap table's omap (NUL prefix keeps
# it clear of the 16-hex-digit snapshot keys): bumped atomically (cls
# numops) on every table mutation.  Snap contexts published to clients
# carry it, and clients REFUSE to regress — a reply from a rank that
# missed the fan-out can no longer downgrade a fresher context.
SNAPVER_KEY = "\x00ver"
SNAP_DIR = ".snap"
ADDR_ATTR = "mds.addr"
# advance the applied watermark (and trim) after this many entries
APPLIED_BATCH = 16


def rank_lock_obj(rank: int) -> str:
    """Per-rank active/standby lock object (rank 0 keeps the legacy
    name so single-active layouts survive an upgrade)."""
    return LOCK_OBJ if rank == 0 else f"{LOCK_OBJ}.{rank}"


def rank_journal_obj(rank: int) -> str:
    return JOURNAL_OBJ if rank == 0 else f"{JOURNAL_OBJ}.{rank}"


def owner_rank(path: str, num_ranks: int) -> int:
    """Subtree partitioning rule shared by MDS daemons and clients
    (the export-pin role, Ceph's src/mds/MDSMap.h mds_export
    pinning re-designed as static hashing): an op belongs to the rank
    owning the MUTATED PARENT directory — root-parented ops (top-level
    dentries) at rank 0, deeper ops at hash(first component).  With
    metadata in shared rados behind guarded per-object ops, ranks are
    serialization domains, not data silos: foreign dirs are readable
    by anyone (uncached), and exactly one rank mutates any given
    directory object."""
    if num_ranks <= 1:
        return 0
    parts = [p for p in path.split("/") if p]
    if len(parts) <= 1:
        return 0
    from ceph_tpu_torch.ops.rjenkins import ceph_str_hash_rjenkins

    return ceph_str_hash_rjenkins(parts[0].encode()) % num_ranks


def dir_obj(ino: int) -> str:
    return f"dir.{ino:x}"


def data_obj(ino: int, blockno: int) -> str:
    return f"fsdata.{ino:x}.{blockno:016x}"


class MDSDaemon:
    """Single-active metadata server with standby takeover."""

    def __init__(self, mon_addr: str, metadata_pool: str,
                 data_pool: str, name: str = "a",
                 lock_interval: float = 1.0,
                 secret: "Optional[str]" = None,
                 secure: bool = False,
                 config: "Optional[dict]" = None,
                 rank: int = 0, num_ranks: int = 1):
        self.mon_addr = mon_addr
        self.metadata_pool = metadata_pool
        self.data_pool = data_pool
        self.name = name
        self.lock_interval = lock_interval
        # multi-active: this daemon serves ONE rank (standbys for a
        # rank run with the same rank number); see owner_rank()
        self.rank = int(rank)
        self.num_ranks = int(num_ranks)
        self.lock_obj = rank_lock_obj(self.rank)
        self.journal_obj = rank_journal_obj(self.rank)
        self._peer_tid = 0
        self._peer_futs: Dict[int, asyncio.Future] = {}
        self.ops_served = 0  # client ops this daemon executed
        # cross-rank rename intents journaled but not yet finished
        # (crash recovery drives them to completion on takeover)
        self._pending_intents: Dict[int, Dict[str, Any]] = {}
        # subtree exports in flight (Migrator role): intent seq ->
        # {"intent": op, "imported": op?}; re-driven on takeover
        self._pending_exports: Dict[int, Dict[str, Any]] = {}
        # imports WE completed, by intent id -> new root ino (the
        # importer-side idempotency record, rebuilt from the journal)
        self._imports: Dict[str, int] = {}
        # frozen subtree path prefixes (normalized) -> expiry: client
        # mutations under them bounce EAGAIN while a dump is the
        # authoritative copy (TTL-bounded: a crashed coordinator
        # cannot wedge the subtree)
        self._frozen_subtrees: Dict[str, float] = {}
        # top-level dirs another rank is removing: our creates into
        # them bounce until the mark clears or expires (peer_rmdir)
        self._dying_dirs: Dict[int, float] = {}
        from ceph_tpu_torch.common.auth import parse_secret

        self.client = RadosClient(mon_addr, name=f"mds.{name}",
                                  secret=secret, secure=secure,
                                  config=config)
        self.msgr = Messenger(f"mds.{name}",
                              secret=parse_secret(secret))
        self.msgr.secure = secure
        self.msgr.local_fastpath = True
        self.msgr.dispatcher = self._dispatch
        # ms_compress_* applies to the MDS service messenger too
        self.msgr.apply_compress_config(config or {})
        self.meta: Optional[IoCtx] = None
        self.data_io: Optional[IoCtx] = None
        self.state = "standby"
        # dirty-free write-through cache: dir ino -> {name: inode dict}
        self._dirs: Dict[int, Dict[str, dict]] = {}
        self._lock_task: Optional[asyncio.Task] = None
        self._stopping = False
        # namespace mutations serialize through one lock (the MDS's
        # whole reason to exist); reads go lock-free off the cache
        self._mutation_lock = lockdep.Lock("mds.mutation")
        # journal state (valid while active)
        self._epoch = 0        # fencing epoch from journal take_over
        self._seq = 0          # next journal sequence
        self._applied_mark = 0  # last watermark pushed to the journal
        # renewal-counter staleness (no cross-host clocks): last seen
        # renewal blob + the LOCAL monotonic time it changed
        self._renew_counter = 0
        self._seen_renewal: Optional[Tuple[bytes, float]] = None
        # test failpoints (the reference's failpoint/killpoint role):
        # simulate a crash just before/after the journal append
        self._fail_before_journal = False
        self._fail_after_journal = False
        # -- client caps (the Locker.cc grant/recall role) ----------------
        # per-inode capability table keyed by the client's Connection:
        # a session IS its connection here (death of either evicts the
        # caps, so a reconnecting client starts capless and re-reads).
        # Modes: "r" (may cache attrs + serve reads locally; many
        # holders) and "rw" (may additionally buffer dirty size/mtime;
        # exclusive).  Grants ride metadata replies; recalls are
        # MClientCaps revoke/ack round trips whose acks carry the
        # holder's dirty attrs (the cap-flush discipline).
        self._caps: Dict[int, Dict[Any, str]] = {}
        self._caps_lock = lockdep.Lock("mds.caps")
        self._cap_tid = 0
        self._cap_acks: Dict[int, asyncio.Future] = {}
        self.cap_revoke_timeout = 3.0
        self.msgr.on_connection_fault = self._conn_fault
        # -- snapshots (SnapServer/SnapRealm role) ------------------------
        # data-pool snap context published to clients (rides replies
        # and cap revokes so writers COW against every live snap),
        # versioned by the table's counter (regression guard)
        self._data_snapc: Tuple[int, list] = (0, [])
        self._snapc_ver = 0
        # snap-table read cache: every .snap path op consults the
        # table; re-reading the omap per lookup would make snapshot
        # tree walks O(table) round trips each.  Invalidated by our
        # own mutations + peer fan-out; the TTL self-heals a missed
        # fan-out.
        self._snap_cache: Optional[Tuple[float, int,
                                         Dict[str, dict]]] = None
        self._snap_cache_ttl = 2.0
        # snapid -> metadata-pool IoCtx with read_snap set (immutable
        # once created; reads of dir omap at that snap)
        self._snap_ios: Dict[int, IoCtx] = {}
        # (dir ino, meta snapid) -> entries; immutable so cacheable,
        # bounded by wholesale eviction
        self._snap_dirs: Dict[Tuple[int, int], Dict[str, dict]] = {}

    # -- lifecycle ---------------------------------------------------------

    async def start(self, port: int = 0) -> str:
        await self.client.connect()
        self.meta = self.client.open_ioctx(self.metadata_pool)
        self.data_io = self.client.open_ioctx(self.data_pool)
        addr = await self.msgr.bind(port=port)
        self._lock_task = asyncio.get_running_loop().create_task(
            self._lock_loop())
        return addr

    async def stop(self) -> None:
        self._stopping = True
        if self._lock_task is not None:
            self._lock_task.cancel()
            try:
                await self._lock_task
            except asyncio.CancelledError:
                pass
        if self.state == "active":
            try:
                await self.meta.execute(self.lock_obj, "lock", "unlock",
                                        json.dumps({
                                            "name": "active",
                                            "owner": self.name,
                                        }).encode())
            except Exception:
                pass
        await self.msgr.shutdown()
        await self.client.shutdown()

    # -- active/standby via cls_lock (MDSMap beacon role) ------------------

    async def _lock_loop(self) -> None:
        while not self._stopping:
            try:
                await self._try_acquire_or_renew()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("mds.%s: lock loop error", self.name)
            await asyncio.sleep(self.lock_interval)

    async def _try_acquire_or_renew(self) -> None:
        req = json.dumps({"name": "active", "type": "exclusive",
                          "owner": self.name,
                          "tag": "mds"}).encode()
        try:
            await self.meta.execute(self.lock_obj, "lock", "lock", req)
        except RadosError:
            # someone else is active: stale-ness check via RENEWAL
            # COUNTERS aged by OUR monotonic clock — never comparing
            # wall clocks across hosts (a skewed clock must not
            # trigger a false takeover)
            if self.state == "active":
                # lost our own lock (broken by a standby while we were
                # partitioned): step down, drop caches.  The journal
                # epoch fence already made our writes impotent.
                log.warning("mds.%s: lost the active lock, standby",
                            self.name)
                self.state = "standby"
                self._dirs.clear()
                self._drop_all_caps()
            try:
                raw = await self.meta.getxattr(self.lock_obj, "renewal")
                now = time.monotonic()
                if self._seen_renewal is None or \
                        self._seen_renewal[0] != raw:
                    self._seen_renewal = (raw, now)
                    return  # counter moved: holder is live
                if now - self._seen_renewal[1] < \
                        self.lock_interval * 5:
                    return  # unchanged, but not for long enough
                holder = json.loads(raw)[0]
                await self.meta.execute(
                    self.lock_obj, "lock", "break_lock",
                    json.dumps({"name": "active",
                                "locker": holder}).encode())
                log.warning("mds.%s: broke stale lock of mds.%s",
                            self.name, holder)
            except (RadosError, ObjectNotFound, ValueError):
                pass
            return
        # lock held (fresh or renewal): stamp a counter + the address
        self._renew_counter += 1
        await self.meta.setxattr(
            self.lock_obj, "renewal",
            json.dumps([self.name, self._renew_counter]).encode())
        await self.meta.setxattr(self.lock_obj, ADDR_ATTR,
                                 self.msgr.addr.encode())
        if self.state != "active":
            await self._take_over()
            # publish the rank layout so clients route without
            # out-of-band config (the MDSMap role, one JSON object)
            await self.meta.write_full(
                MDSMAP_OBJ,
                json.dumps({"num_ranks": self.num_ranks}).encode())

    async def _take_over(self) -> None:
        """Fence the previous active, replay its journal tail, serve.
        (MDLog replay + the mon-blocklist fencing role.)"""
        out = await self.meta.execute(self.journal_obj, "journal",
                                      "take_over", b"")
        self._epoch = int(out.decode())
        self._dirs.clear()  # cold cache: reload from rados
        await self._ensure_root()
        # snap contexts BEFORE any replayed mutation: replayed dir
        # writes and purges must COW against every live snapshot
        await self._refresh_snapc()
        await self._sweep_pending_snaps()
        await self._replay_journal()
        log.info("mds.%s: ACTIVE at %s (epoch %d)", self.name,
                 self.msgr.addr, self._epoch)
        self.state = "active"
        if self._pending_intents:
            # crashed mid cross-rank rename: drive each intent to its
            # journaled conclusion (state must be active first — the
            # peer RPCs below go through live messengers)
            await self._finish_pending_renames()
        if self._pending_exports:
            await self._finish_pending_exports()

    async def _replay_journal(self) -> None:
        from ceph_tpu_torch.cls.journal import ENTRY_PREFIX

        raw = await self.meta.execute(self.journal_obj, "journal",
                                      "get_state", b"")
        st = json.loads(raw.decode())
        applied = int(st["applied"])
        try:
            omap = await self.meta.omap_get(self.journal_obj)
        except ObjectNotFound:
            omap = {}
        entries = sorted(
            (int(k[len(ENTRY_PREFIX):]), v)
            for k, v in omap.items() if k.startswith(ENTRY_PREFIX))
        top = applied
        pending: Dict[int, Dict[str, Any]] = {}
        exports: Dict[int, Dict[str, Any]] = {}
        imports: Dict[str, int] = {}
        for seq, blob in entries:
            ops = json.loads(blob.decode())
            # intent/finish pairing spans the applied watermark: an
            # intent may be applied (and trimmed from replay's range)
            # while its finish never landed — scan ALL retained
            # entries for pairing, apply only the un-applied ones
            for op in ops:
                kind = op.get("op")
                if kind == "rename_intent":
                    pending[seq] = op
                elif kind == "rename_finish":
                    pending.pop(int(op.get("intent_seq", -1)), None)
                elif kind == "export_intent":
                    exports[seq] = {"intent": op}
                elif kind == "export_imported":
                    rec = exports.get(int(op.get("intent_seq", -1)))
                    if rec is not None:
                        rec["imported"] = op
                elif kind == "export_finish":
                    exports.pop(int(op.get("intent_seq", -1)), None)
                elif kind == "import_done":
                    imports[op["id"]] = int(op["root"])
                elif kind == "import_forget":
                    imports.pop(op.get("id", ""), None)
            if seq <= applied:
                continue
            await self._apply_ops(ops)
            top = seq
        self._pending_intents = pending
        self._pending_exports = exports
        self._imports = imports
        self._seq = max(top, applied) + 1
        self._applied_mark = top
        await self.meta.execute(
            self.journal_obj, "journal", "set_applied",
            json.dumps({"epoch": self._epoch, "applied": top,
                        "from": applied}).encode())
        if top > applied:
            log.info("mds.%s: replayed %d journal entries",
                     self.name, top - applied)

    async def _ensure_root(self) -> None:
        try:
            await self.meta.omap_get(dir_obj(ROOT_INO))
        except ObjectNotFound:
            await self.meta.omap_set(dir_obj(ROOT_INO), {})
            await self.meta.omap_set(INO_OBJ,
                                     {"next": str(ROOT_INO + 1).encode()})

    async def _alloc_ino(self) -> int:
        out = await self.meta.execute(
            INO_OBJ, "numops", "add",
            json.dumps({"key": "next", "value": 1}).encode())
        return int(float(out.decode()))

    # -- directory cache (write-through; CDir::fetch/commit roles) ---------

    async def _load_dir(self, ino: int,
                        owned: bool = True) -> Dict[str, dict]:
        """owned=False: a FOREIGN directory (another rank mutates it)
        — always read through to rados, never cache: the write-through
        cache is only coherent for dirs this rank exclusively
        mutates."""
        if owned:
            cached = self._dirs.get(ino)
            if cached is not None:
                return cached
        try:
            omap = await self.meta.omap_get(dir_obj(ino))
        except ObjectNotFound:
            raise MDSError(ENOENT, f"no directory {ino:x}")
        entries = {name: json.loads(raw.decode())
                   for name, raw in omap.items()}
        if owned:
            self._dirs[ino] = entries
        return entries

    async def _guarded(self, method: str, oid: str, req: dict) -> None:
        """Epoch-guarded apply write (cls journal guarded_*): the
        fence xattr on each object refuses any epoch OLDER than one
        that already touched it — the apply-phase half of fencing (a
        deposed active can at most re-apply state the new active
        already replayed, which is idempotent)."""
        req = dict(req, epoch=self._epoch)
        await self.meta.execute(oid, "journal", method,
                                json.dumps(req).encode())

    async def _apply_ops(self, ops) -> None:
        """Apply one journal entry's ops write-through (idempotent:
        absolute sets/removes, so replay after a partial apply
        converges).  Every write is epoch-guarded."""
        for op in ops:
            kind = op["op"]
            if kind == "dentry":
                dir_ino, name, inode = op["dir"], op["name"], op["inode"]
                val = None if inode is None else json.dumps(inode)
                await self._guarded("guarded_update",
                                    dir_obj(dir_ino),
                                    {"set": {name: val}})
                # update ONLY an already-loaded cache entry: seeding a
                # partial entry here would later be served as the
                # complete directory (lazy _load_dir fills cold dirs)
                if inode is None:
                    self._dirs.get(dir_ino, {}).pop(name, None)
                elif dir_ino in self._dirs:
                    self._dirs[dir_ino][name] = inode
            elif kind == "mkdirobj":
                await self._guarded("guarded_update",
                                    dir_obj(op["ino"]), {"set": {}})
            elif kind == "rmdirobj":
                try:
                    await self._guarded("guarded_remove",
                                        dir_obj(op["ino"]), {})
                except RadosError as e:
                    if e.rc != ENOENT:
                        raise
                self._dirs.pop(op["ino"], None)
            elif kind in ("rename_intent", "rename_finish",
                          "export_intent", "export_imported",
                          "export_finish", "import_done",
                          "import_forget"):
                # bookkeeping entries for the cross-rank rename and
                # subtree-export protocols: no object mutation —
                # replay pairs them up (_replay_journal) and the
                # takeover finishers drive unfinished ones
                pass
            elif kind == "purgefile":
                # a rename clobbered a file: its data objects have no
                # dentry left to purge them through — best-effort
                # server-side purge (the PurgeQueue role)
                size = int(op.get("size", 0))
                bs = max(1, int(op.get("block_size", 1 << 22)))
                for blk in range((size + bs - 1) // bs):
                    try:
                        await self.data_io.remove(
                            data_obj(op["ino"], blk))
                    except (ObjectNotFound, RadosError):
                        pass

    class _CrashPoint(Exception):
        """Test failpoint fired: simulate the daemon dying here."""

    async def _commit(self, ops) -> int:
        """One compound metadata update (the EUpdate role): fenced
        journal append FIRST, then write-through apply.  The append is
        the commit point — a crash after it is finished by the next
        active's replay; a fenced append (EPERM: a newer epoch took
        over) steps this MDS down without touching anything.
        Returns the entry's journal seq (rename intents reference
        it)."""
        if self._fail_before_journal:
            await self._simulate_crash()
            raise self._CrashPoint()
        seq = self._seq
        self._seq += 1
        try:
            await self.meta.execute(
                self.journal_obj, "journal", "append",
                json.dumps({"epoch": self._epoch, "seq": seq,
                            "entry": ops}).encode())
        except RadosError as e:
            if e.rc == EPERM:
                log.warning("mds.%s: journal append fenced — a newer"
                            " active exists; stepping down",
                            self.name)
                self.state = "standby"
                self._dirs.clear()
                self._drop_all_caps()
                raise MDSError(ESTALE, "fenced by a newer active")
            # transient rados failure: the mutation did NOT commit;
            # stay active (stepping down on EAGAIN would turn OSD
            # churn into MDS failover storms)
            raise MDSError(EIO, f"journal append failed ({e.rc})")
        if self._fail_after_journal:
            await self._simulate_crash()
            raise self._CrashPoint()
        try:
            await self._apply_ops(ops)
        except RadosError as e:
            if e.rc == EPERM:
                # a newer epoch fenced the APPLY phase mid-op: the
                # entry IS journaled — the new active's replay commits
                # it.  Step down and tell the client to re-resolve
                # (retrying against us would double-report failure for
                # an op that took effect).
                log.warning("mds.%s: apply fenced mid-op — stepping"
                            " down (the entry is journaled; the new"
                            " active replays it)", self.name)
                self.state = "standby"
                self._dirs.clear()
                self._drop_all_caps()
                raise MDSError(ESTALE, "fenced during apply")
            raise
        if seq - self._applied_mark >= APPLIED_BATCH:
            prev = self._applied_mark
            self._applied_mark = seq
            try:
                await self.meta.execute(
                    self.journal_obj, "journal", "set_applied",
                    json.dumps({"epoch": self._epoch, "applied": seq,
                                "from": prev}).encode())
            except RadosError:
                pass  # fenced trim: the new active owns the journal
        return seq

    async def _simulate_crash(self) -> None:
        """Failpoint: die like a SIGKILL — stop serving instantly,
        leave all rados state exactly as it is."""
        self._stopping = True
        self.state = "killed"
        if self._lock_task is not None:
            self._lock_task.cancel()
        await self.msgr.shutdown()

    @staticmethod
    def _dentry(dir_ino: int, name: str, inode) -> dict:
        return {"op": "dentry", "dir": dir_ino, "name": name,
                "inode": inode}

    # -- client caps (Locker grant/recall) ---------------------------------

    def _conn_fault(self, conn) -> None:
        """A client connection died: its session's caps die with it
        (the session-eviction role) — no ack will ever come."""
        for ino in list(self._caps):
            self._caps[ino].pop(conn, None)
            if not self._caps[ino]:
                del self._caps[ino]
        # unblock any revoke waiting on this conn
        for tid, fut in list(self._cap_acks.items()):
            if getattr(fut, "_cap_conn", None) is conn and \
                    not fut.done():
                fut.set_result({})

    async def _revoke_caps(self, ino: int,
                           keep: Any = None) -> Dict[str, Any]:
        """Recall every cap on ino except `keep`'s; returns the merged
        dirty attrs flushed back in the acks ({} if none).  An
        unresponsive holder is evicted after cap_revoke_timeout — a
        dead client must not wedge the namespace (Locker's
        session-autoclose discipline)."""
        return (await self._revoke_many([ino], keep=keep)).get(ino, {})

    async def _revoke_many(self, inos, keep: Any = None
                           ) -> Dict[int, Dict[str, Any]]:
        """Recall caps on every listed inode at once: ALL revokes go
        out first, then ALL acks are awaited under ONE shared timeout
        — a directory rename recalling thousands of inodes (or N
        unresponsive holders) costs one cap_revoke_timeout total, not
        one per inode, while this stall holds _caps_lock and usually
        the mutation lock."""
        merged: Dict[int, Dict[str, Any]] = {}
        async with self._caps_lock:
            waits = []
            for ino in inos:
                holders = self._caps.get(ino)
                if not holders:
                    continue
                for conn, _mode in list(holders.items()):
                    if conn is keep:
                        continue
                    self._cap_tid += 1
                    tid = self._cap_tid
                    fut: asyncio.Future = \
                        asyncio.get_running_loop().create_future()
                    fut._cap_conn = conn
                    self._cap_acks[tid] = fut
                    # the recall itself carries the (possibly empty)
                    # snap context: a recalled writer must COW its
                    # very next write — or stop cloning after the
                    # last rmsnap — before any MDS round trip
                    revoke_attrs = {"snapc": [
                        self._snapc_ver,
                        self._data_snapc[0],
                        list(self._data_snapc[1])]}
                    try:
                        await conn.send(MClientCaps("revoke", ino,
                                                    tid=tid,
                                                    attrs=revoke_attrs))
                    except (ConnectionError, OSError):
                        self._cap_acks.pop(tid, None)
                        holders.pop(conn, None)
                        continue
                    waits.append((ino, conn, tid, fut))
            if waits:
                await asyncio.wait([f for _i, _c, _t, f in waits],
                                   timeout=self.cap_revoke_timeout)
            for ino, conn, tid, fut in waits:
                holders = self._caps.get(ino, {})
                if fut.done():
                    attrs = fut.result()
                    if attrs.get("size_max") is not None:
                        m = merged.setdefault(ino, {})
                        m["size_max"] = max(
                            int(m.get("size_max", 0)),
                            int(attrs["size_max"]))
                        if attrs.get("mtime") is not None:
                            m["mtime"] = max(
                                float(m.get("mtime", 0)),
                                float(attrs["mtime"]))
                        if attrs.get("path"):
                            m["path"] = attrs["path"]
                else:
                    log.warning("mds.%s: cap revoke on %x timed out;"
                                " evicting session", self.name, ino)
                    try:
                        conn.close()
                    except Exception:
                        pass
                self._cap_acks.pop(tid, None)
                holders.pop(conn, None)
                if not holders:
                    self._caps.pop(ino, None)
        return merged

    async def _revoke_all_caps(self) -> list:
        """Recall EVERY outstanding cap (directory rename: all cached
        descendant paths go stale cluster-wide) in ONE batched round.
        Returns the flushed dirty attrs, each carrying the holder's
        path, for the caller to persist BEFORE the rename moves those
        paths."""
        merged = await self._revoke_many(list(self._caps))
        return [fl for fl in merged.values()
                if fl.get("size_max") is not None]

    async def _acquire_cap(self, conn, ino: int,
                           want: str) -> Tuple[str, Dict[str, Any]]:
        """Try to grant `want` to conn; returns (granted_mode,
        flushed_attrs_from_conflicting_holders)."""
        if conn is None or want not in ("r", "rw"):
            return "", {}
        flush: Dict[str, Any] = {}
        async with self._caps_lock:
            holders = self._caps.get(ino, {})
            conflict = any(
                c is not conn and (want == "rw" or m == "rw")
                for c, m in holders.items())
        if conflict:
            flush = await self._revoke_caps(ino, keep=conn)
        async with self._caps_lock:
            holders = self._caps.setdefault(ino, {})
            # re-check under the lock: a rival grant may have landed
            # between the revoke and here — then no cap this time
            # (correctness first; the client just doesn't cache)
            if any(c is not conn and (want == "rw" or m == "rw")
                   for c, m in holders.items()):
                if not holders:
                    self._caps.pop(ino, None)
                return "", flush
            holders[conn] = want
        return want, flush

    async def _apply_flush(self, flush: Dict[str, Any],
                           path: str) -> None:
        """Persist dirty attrs collected by a recall (the cap-flush
        commit): max-merge the size under the mutation lock."""
        if flush.get("size_max") is None or not path:
            return
        async with self._mutation_lock:
            await self._apply_flush_locked(flush, path)

    async def _apply_flush_locked(self, flush: Dict[str, Any],
                                  path: str) -> None:
        """As _apply_flush, for callers already holding the mutation
        lock (mutation handlers persisting bystander flushes)."""
        if flush.get("size_max") is None or not path:
            return
        try:
            parent, name, inode = await self._resolve(path)
        except MDSError:
            return  # path raced away; flush has nowhere to land
        if inode is None or inode.get("type") != "file":
            return
        new = max(inode.get("size", 0), int(flush["size_max"]))
        if new != inode.get("size"):
            inode["size"] = new
            inode["mtime"] = float(flush.get("mtime", self._now()))
            await self._commit([self._dentry(parent, name, inode)])

    def _drop_all_caps(self) -> None:
        """Step-down/shutdown: tell every holder to forget its caps
        (no ack expected — we may be fenced already), then clear."""
        sent = set()
        for ino, holders in self._caps.items():
            for conn in holders:
                if id(conn) in sent:
                    continue
                sent.add(id(conn))
                try:
                    self.msgr._spawn(conn.send(
                        MClientCaps("evict", 0)))
                except Exception:
                    pass
        self._caps.clear()

    # -- path resolution (MDCache::path_traverse role) ---------------------

    async def _resolve(self, path: str) -> Tuple[int, str,
                                                 Optional[dict]]:
        """path -> (parent dir ino, leaf name, inode | None).
        '/' resolves to (0, '', root-pseudo-inode)."""
        parts = [p for p in path.split("/") if p]
        if SNAP_DIR in parts:
            # every MUTATION resolves through here: snapshots are
            # read-only (snap-aware reads branch before _resolve)
            raise MDSError(EROFS, path)
        if not parts:
            return 0, "", {"ino": ROOT_INO, "type": "dir", "mode": 0o755,
                           "size": 0, "mtime": 0}
        # ownership per dir along the walk: the root object belongs to
        # rank 0; every dir under top-level component c belongs to
        # hash(c) — only OWNED dirs may be served from (and fill) the
        # write-through cache
        subtree_owned = self.num_ranks <= 1 or \
            self._subtree_rank(parts[0]) == self.rank
        cur = ROOT_INO
        for i, part in enumerate(parts[:-1]):
            owned = (self.rank == 0) if cur == ROOT_INO \
                else subtree_owned
            entries = await self._load_dir(cur, owned=owned)
            inode = entries.get(part)
            if inode is None:
                raise MDSError(ENOENT, "/".join(parts[:i + 1]))
            if inode["type"] != "dir":
                raise MDSError(ENOTDIR, part)
            cur = inode["ino"]
        owned = (self.rank == 0) if cur == ROOT_INO else subtree_owned
        entries = await self._load_dir(cur, owned=owned)
        return cur, parts[-1], entries.get(parts[-1])

    # -- multi-active plumbing (Migrator/peer coordination role) -----------

    def _subtree_rank(self, first_component: str) -> int:
        """The ONE rank serving every path under top-level component
        c — the single source of the partition rule (owner_rank and
        _dir_owned derive from it)."""
        if self.num_ranks <= 1:
            return 0
        from ceph_tpu_torch.ops.rjenkins import ceph_str_hash_rjenkins

        return ceph_str_hash_rjenkins(
            first_component.encode()) % self.num_ranks

    def _dir_owned(self, path: str) -> bool:
        """Is the directory OBJECT addressed by path mutated by this
        rank?  (Root belongs to rank 0; dirs under top-level component
        c to hash(c).)"""
        parts = [p for p in path.split("/") if p]
        if not parts:
            return self.num_ranks <= 1 or self.rank == 0
        return self._subtree_rank(parts[0]) == self.rank

    async def _peer_request(self, rank: int, op: str, args: dict,
                            timeout: Optional[float] = None):
        """MDS-to-MDS RPC over the service messenger (the reference's
        MMDSPeerRequest role): address discovered from the peer rank's
        lock object.  NEVER call while holding the mutation lock — the
        peer's handler may take ITS mutation lock, and two ranks
        calling each other would deadlock.  Default timeout exceeds
        the peer's cap_revoke_timeout: a revoke waiting out a dead
        holder must not time out at the caller first."""
        if timeout is None:
            timeout = self.cap_revoke_timeout + 2.0
        raw = await self.meta.getxattr(rank_lock_obj(rank), ADDR_ATTR)
        addr = raw.decode()
        self._peer_tid += 1
        tid = self._peer_tid
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._peer_futs[tid] = fut
        try:
            conn = await self.msgr.connect(addr)
            await conn.send(MClientRequest(tid, op, args))
            reply = await asyncio.wait_for(fut, timeout)
            return reply.rc, reply.out
        finally:
            self._peer_futs.pop(tid, None)

    async def _op_peer_revoke(self, args,
                              conn=None) -> Tuple[int, Dict[str, Any]]:
        """Peer rank asks us to revoke caps / drop dir-cache entries
        it is about to invalidate (cross-rank rename coordination).
        MUST run without the mutation lock: two ranks cross-renaming
        into each other would deadlock otherwise."""
        if args.get("revoke_all"):
            await self._revoke_many(list(self._caps))
            self._dirs.clear()
        else:
            await self._revoke_many(list(args.get("inos", [])))
            for ino in args.get("invalidate_dirs", []):
                self._dirs.pop(int(ino), None)
        return 0, {}

    # -- request dispatch (Server::handle_client_request role) -------------

    async def _dispatch(self, conn: Connection, msg: Message) -> None:
        if isinstance(msg, MClientReply):
            # a peer rank answering our _peer_request
            fut = self._peer_futs.get(msg.tid)
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return
        if isinstance(msg, MClientCaps):
            if msg.op == "ack":
                fut = self._cap_acks.get(msg.tid)
                if fut is not None and not fut.done():
                    fut.set_result(msg.attrs)
            elif msg.op == "release":
                # voluntary cap return (dirty attrs were flushed via a
                # regular setattr first): just drop the table entry
                holders = self._caps.get(msg.ino)
                if holders is not None:
                    holders.pop(conn, None)
                    if not holders:
                        self._caps.pop(msg.ino, None)
            return
        if not isinstance(msg, MClientRequest):
            return
        if self.state != "active":
            await conn.send(MClientReply(msg.tid, ESTALE,
                                         {"error": "not active"}))
            return
        handler = getattr(self, f"_op_{msg.op}", None)
        if handler is None:
            await conn.send(MClientReply(msg.tid, EINVAL,
                                         {"error": f"bad op {msg.op}"}))
            return
        if self.num_ranks > 1 and not msg.op.startswith("peer_"):
            # subtree routing guard: a misrouted op must bounce, not
            # execute — executing here would mutate a dir object a
            # DIFFERENT rank caches and serializes
            path = msg.args.get("path") or msg.args.get("src") or "/"
            want = owner_rank(path, self.num_ranks)
            if want != self.rank:
                await conn.send(MClientReply(
                    msg.tid, ESTALE,
                    {"error": "misrouted", "rank": want}))
                return
        if self._frozen_subtrees and msg.op in self.MUTATING_OPS:
            # a frozen subtree is mid-export: its dump is the
            # authoritative copy, so mutations under it must wait
            # (EAGAIN; clients retry) — reads stay fine
            now = time.monotonic()
            paths = [self._norm_path(msg.args.get(k, ""))
                     for k in ("path", "src", "dst")
                     if msg.args.get(k)]
            for pref, exp in list(self._frozen_subtrees.items()):
                if exp <= now:
                    self._frozen_subtrees.pop(pref, None)
                    continue
                if any(p == pref or p.startswith(pref + "/")
                       for p in paths):
                    await conn.send(MClientReply(
                        msg.tid, EAGAIN,
                        {"error": "subtree migrating; retry"}))
                    return
        self.ops_served += 1
        try:
            if msg.op in ("lookup", "readdir", "stat", "readlink",
                          "peer_revoke", "rename", "rmdir", "lssnap",
                          "peer_snap_refresh", "peer_subtree_thaw"):
                # reads are lock-free; rename/rmdir manage their own
                # locking (they must release it around peer RPCs);
                # peer_revoke must never wait on the mutation lock
                # (its caller holds its own — distributed deadlock)
                rc, out = await handler(msg.args, conn)
            else:
                async with self._mutation_lock:
                    rc, out = await handler(msg.args, conn)
        except MDSError as e:
            rc, out = e.rc, {"error": str(e)}
        except ObjectNotFound:
            rc, out = ENOENT, {}
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("mds.%s: op %s failed", self.name, msg.op)
            rc, out = EIO, {}
        if rc == 0 and isinstance(out, dict):
            # piggyback the data-pool snap context on every reply so
            # clients' direct-to-OSD file writes COW against every
            # live snapshot (the SnapRealm-propagation role).  An
            # EMPTY context is published too: after the last rmsnap
            # clients must STOP cloning against the removed snapid,
            # or post-trim clones leak unreclaimably
            out.setdefault("_dsnapc", [self._snapc_ver,
                                       self._data_snapc[0],
                                       list(self._data_snapc[1])])
        try:
            await conn.send(MClientReply(msg.tid, rc, out))
        except (ConnectionError, OSError):
            pass

    # -- metadata ops ------------------------------------------------------

    @staticmethod
    def _now() -> float:
        return time.time()

    async def _op_mkdir(self, args,
                        conn=None) -> Tuple[int, Dict[str, Any]]:
        parent, name, existing = await self._resolve(args["path"])
        if not name:
            return EEXIST, {}
        if self._dying(parent):
            return ESTALE, {"error": "parent dir is being removed"}
        if existing is not None:
            return EEXIST, {}
        ino = await self._alloc_ino()
        inode = {"ino": ino, "type": "dir",
                 "mode": args.get("mode", 0o755),
                 "size": 0, "mtime": self._now()}
        await self._commit([{"op": "mkdirobj", "ino": ino},
                            self._dentry(parent, name, inode)])
        return 0, {"inode": inode}

    async def _op_create(self, args,
                         conn=None) -> Tuple[int, Dict[str, Any]]:
        parent, name, existing = await self._resolve(args["path"])
        if not name:
            return EISDIR, {}
        if self._dying(parent):
            return ESTALE, {"error": "parent dir is being removed"}
        if existing is not None:
            if existing["type"] == "dir":
                return EISDIR, {}
            if args.get("exclusive"):
                return EEXIST, {}
            # open of an existing file: recall conflicting holders
            # (an opener wanting rw must flush/stop every caching
            # reader; a reader-opener must flush a foreign writer)
            cap, flush = await self._acquire_cap(
                conn, existing["ino"], args.get("want", ""))
            if flush.get("size_max") is not None:
                existing["size"] = max(existing.get("size", 0),
                                       int(flush["size_max"]))
                existing["mtime"] = float(
                    flush.get("mtime", self._now()))
                await self._commit([self._dentry(parent, name,
                                                 existing)])
            return 0, {"inode": existing, "cap": cap}
        ino = await self._alloc_ino()
        inode = {"ino": ino, "type": "file",
                 "mode": args.get("mode", 0o644),
                 "size": 0, "mtime": self._now(),
                 "block_size": int(args.get("block_size", 1 << 22))}
        await self._commit([self._dentry(parent, name, inode)])
        cap, _ = await self._acquire_cap(conn, ino,
                                         args.get("want", ""))
        return 0, {"inode": inode, "cap": cap}

    async def _op_symlink(self, args,
                          conn=None) -> Tuple[int, Dict[str, Any]]:
        parent, name, existing = await self._resolve(args["path"])
        if not name or existing is not None:
            return EEXIST, {}
        if self._dying(parent):
            return ESTALE, {"error": "parent dir is being removed"}
        ino = await self._alloc_ino()
        inode = {"ino": ino, "type": "symlink",
                 "mode": 0o777, "size": len(args["target"]),
                 "mtime": self._now(), "target": args["target"]}
        await self._commit([self._dentry(parent, name, inode)])
        return 0, {"inode": inode}

    async def _op_lookup(self, args,
                         conn=None) -> Tuple[int, Dict[str, Any]]:
        if self._split_snap_path(args["path"]) is not None:
            return await self._snap_lookup(args)
        _parent, _name, inode = await self._resolve(args["path"])
        if inode is None:
            return ENOENT, {}
        want = args.get("want", "")
        if not want:
            return 0, {"inode": inode}
        # grant a cap so the client may cache this answer; recalling a
        # foreign writer first means the size we serve (and the flush
        # we persist) is current — the rdlock-revokes-Fw discipline
        cap, flush = await self._acquire_cap(conn, inode["ino"], want)
        if flush.get("size_max") is not None:
            await self._apply_flush(flush, args["path"])
            _p, _n, inode = await self._resolve(args["path"])
            if inode is None:
                return ENOENT, {}
        return 0, {"inode": inode, "cap": cap}

    _op_stat = _op_lookup

    async def _op_readlink(self, args,
                           conn=None) -> Tuple[int, Dict[str, Any]]:
        if self._split_snap_path(args["path"]) is not None:
            inode = await self._snap_resolve(args["path"])
        else:
            _p, _n, inode = await self._resolve(args["path"])
        if inode is None:
            return ENOENT, {}
        if inode["type"] != "symlink":
            return EINVAL, {}
        return 0, {"target": inode["target"]}

    async def _op_readdir(self, args,
                          conn=None) -> Tuple[int, Dict[str, Any]]:
        if self._split_snap_path(args["path"]) is not None:
            return await self._snap_readdir(args)
        _parent, _name, inode = await self._resolve(args["path"])
        if inode is None:
            return ENOENT, {}
        if inode["type"] != "dir":
            return ENOTDIR, {}
        entries = await self._load_dir(
            inode["ino"], owned=self._dir_owned(args["path"]))
        return 0, {"entries": {n: i for n, i in sorted(entries.items())}}

    async def _op_unlink(self, args,
                         conn=None) -> Tuple[int, Dict[str, Any]]:
        parent, name, inode = await self._resolve(args["path"])
        if inode is None:
            return ENOENT, {}
        if inode["type"] == "dir":
            return EISDIR, {}
        # recall ALL caps (requester's too — the inode is dying); a
        # writer's flushed size feeds the purge block count
        flush = await self._revoke_caps(inode["ino"])
        if flush.get("size_max") is not None:
            inode["size"] = max(inode.get("size", 0),
                                int(flush["size_max"]))
        await self._commit([self._dentry(parent, name, None)])
        return 0, {"inode": inode}  # client purges the data objects

    async def _op_rmdir(self, args,
                        conn=None) -> Tuple[int, Dict[str, Any]]:
        """Manages its OWN locking (like rename): removing a TOP-LEVEL
        dir another rank owns runs the peer_rmdir protocol — the owner
        adjudicates emptiness under ITS mutation lock and fences new
        creates with a dying mark, so an empty-check here cannot race
        a create committing there; the owner also removes the dir
        object under its own fencing epoch (cross-rank epochs are
        incomparable)."""
        parts = [p for p in args["path"].split("/") if p]
        foreign = None
        if self.num_ranks > 1 and len(parts) == 1:
            r = self._subtree_rank(parts[0])
            if r != self.rank:
                foreign = r
        if foreign is None:
            async with self._mutation_lock:
                parent, name, inode = await self._resolve(
                    args["path"])
                if inode is None:
                    return ENOENT, {}
                if inode["type"] != "dir":
                    return ENOTDIR, {}
                entries = await self._load_dir(
                    inode["ino"],
                    owned=self._dir_owned(args["path"]))
                if entries:
                    return ENOTEMPTY, {}
                await self._revoke_caps(inode["ino"])
                await self._commit([
                    self._dentry(parent, name, None),
                    {"op": "rmdirobj", "ino": inode["ino"]}])
                return 0, {}
        async with self._mutation_lock:
            parent, name, inode = await self._resolve(args["path"])
            if inode is None:
                return ENOENT, {}
            if inode["type"] != "dir":
                return ENOTDIR, {}
        try:
            rc, out = await self._peer_request(
                foreign, "peer_rmdir_begin", {"ino": inode["ino"]})
        except (RadosError, ObjectNotFound, ConnectionError, OSError,
                asyncio.TimeoutError):
            return ESTALE, {"error": "owner rank unavailable"}
        if rc != 0:
            return rc, out
        removed = False
        async with self._mutation_lock:
            _p2, _n2, cur = await self._resolve(args["path"])
            if cur is not None and cur["ino"] == inode["ino"]:
                await self._revoke_caps(inode["ino"])
                # dentry removal only — the OWNER removes the dir
                # object in peer_rmdir_done under its epoch.  Crash
                # before done: the dying mark expires and the object
                # leaks invisibly (logged there), never corrupts.
                await self._commit([self._dentry(parent, name, None)])
                removed = True
        try:
            await self._peer_request(
                foreign, "peer_rmdir_done",
                {"ino": inode["ino"], "removed": removed})
        except (RadosError, ObjectNotFound, ConnectionError, OSError,
                asyncio.TimeoutError):
            log.warning("mds.%s: peer_rmdir_done to rank %d lost;"
                        " dir object %x may leak", self.name,
                        foreign, inode["ino"])
        return (0, {}) if removed else (ESTALE,
                                        {"error": "dentry raced away"})

    async def _op_rename(self, args,
                         conn=None) -> Tuple[int, Dict[str, Any]]:
        """Rename (manages its OWN locking — _dispatch leaves it
        lock-free so the cross-rank path can release the mutation lock
        around peer RPCs; two ranks cross-renaming into each other
        while holding their locks would deadlock).

        Cross-rank protocol (the Migrator handshake re-designed for
        shared rados): the SRC rank journals a durable rename_intent,
        then asks the DST rank to link the dentry UNDER ITS OWN
        mutation lock, journal and fencing epoch (peer_link) — only
        the object owner ever mutates a directory object, so dst-side
        concurrency and cache coherence are its own single-rank
        problem.  The src rank then commits the src-dentry removal
        plus a rename_finish marker.  A crash leaves the intent in the
        src journal; takeover re-drives it (peer_link is idempotent).

        DIRECTORY renames that would RE-HOME a subtree (src and dst
        top-level hashes differ) run the SUBTREE EXPORT protocol
        (_export_subtree — the Migrator role): the importer rank
        re-creates the tree under fresh inos in its own fencing
        domain, so no cross-rank epoch comparison ever happens."""
        src_parts = [p for p in args["src"].split("/") if p]
        dst_parts = [p for p in args["dst"].split("/") if p]
        if not src_parts or not dst_parts:
            return EINVAL, {}
        if self.num_ranks > 1 and \
                self._subtree_rank(src_parts[0]) != \
                self._subtree_rank(dst_parts[0]):
            # re-homing applies only to DIRECTORY renames: peek at the
            # src type (lock-free read; _export_subtree re-validates
            # under the lock and bounces ESTALE on a race)
            try:
                _p, _n, peek = await self._resolve(args["src"])
            except MDSError as e:
                return e.rc, {}
            if peek is not None and peek.get("type") == "dir":
                return await self._export_subtree(args, src_parts,
                                                  dst_parts)
        dst_rank = owner_rank(args["dst"], self.num_ranks)
        if self.num_ranks > 1 and dst_rank != self.rank:
            return await self._rename_cross_rank(args, dst_rank,
                                                 src_parts, dst_parts)
        async with self._mutation_lock:
            return await self._rename_local(args, src_parts,
                                            dst_parts)

    def _dir_move_ranks(self, src_parts, dst_parts,
                        is_dir: bool) -> Tuple[int, Optional[int]]:
        """For a DIRECTORY rename: (subtree rank serving the moved
        paths, or EXDEV-sentinel None if the move would re-home)."""
        s = self._subtree_rank(src_parts[0])
        d = self._subtree_rank(dst_parts[0])
        return s, (s if s == d else None)

    async def _rename_local(self, args, src_parts, dst_parts
                            ) -> Tuple[int, Dict[str, Any]]:
        src_parent, src_name, inode = await self._resolve(args["src"])
        if inode is None:
            return ENOENT, {}
        dst_parent, dst_name, existing = await self._resolve(
            args["dst"])
        if not dst_name:
            return EINVAL, {}
        # VALIDATE FIRST: recalls collect writers' dirty sizes, and an
        # error return after a recall would discard a flush that only
        # _commit can persist
        if existing is not None:
            if existing["type"] == "dir":
                if inode["type"] != "dir":
                    return EISDIR, {}
                if await self._load_dir(
                        existing["ino"],
                        owned=self._dir_owned(args["dst"])):
                    return ENOTEMPTY, {}
            elif inode["type"] == "dir":
                return ENOTDIR, {}
        if inode["type"] == "dir" and self.num_ranks > 1:
            sub, ok = self._dir_move_ranks(src_parts, dst_parts, True)
            if ok is None:
                # the src became a dir after _op_rename's peek: a
                # retry takes the subtree-export path
                return ESTALE, {"error": "src changed; retry"}
            if sub != self.rank:
                # paths under the moved dir are served by rank `sub`:
                # its clients' path caches (and its path-keyed state)
                # must flush.  Called WITHOUT our mutation lock?  No —
                # peer_revoke never takes the peer's mutation lock, so
                # holding ours here cannot deadlock.
                try:
                    await self._peer_request(
                        sub, "peer_revoke", {"revoke_all": True})
                except (RadosError, ObjectNotFound, ConnectionError,
                        OSError, asyncio.TimeoutError):
                    return ESTALE, {"error": "subtree rank"
                                             " unavailable"}
        # recall caps on the moved inode (cached paths go stale) and
        # fold a writer's dirty size into the dentry we re-link; the
        # clobbered target's caps go too (it is dying), its flushed
        # size feeding the purge.  Renaming a DIRECTORY invalidates
        # every descendant's cached PATH on every client — paths are
        # the cache key, so recall everything (dir renames are rare;
        # the reference's per-dentry lease recall is finer-grained)
        if inode["type"] == "dir":
            # bystander writers' flushed sizes must land while their
            # paths still resolve (we hold the mutation lock)
            for fl in await self._revoke_all_caps():
                await self._apply_flush_locked(fl, fl.get("path", ""))
        flush = await self._revoke_caps(inode["ino"])
        if flush.get("size_max") is not None:
            inode["size"] = max(inode.get("size", 0),
                                int(flush["size_max"]))
        if existing is not None and existing["ino"] != inode["ino"]:
            eflush = await self._revoke_caps(existing["ino"])
            if eflush.get("size_max") is not None:
                existing["size"] = max(existing.get("size", 0),
                                       int(eflush["size_max"]))
        # ONE journal entry carries both dentry ops: rename is
        # crash-atomic — the append is the commit point, replay
        # finishes a half-applied rename (journal.cc EUpdate role).
        # Clobbered targets are cleaned up in the same entry: an empty
        # dir's object is removed, a file's data objects purged.
        ops = [self._dentry(dst_parent, dst_name, inode)]
        if (src_parent, src_name) != (dst_parent, dst_name):
            ops.append(self._dentry(src_parent, src_name, None))
            if existing is not None and existing["ino"] != inode["ino"]:
                if existing["type"] == "dir":
                    ops.append({"op": "rmdirobj",
                                "ino": existing["ino"]})
                elif existing["type"] == "file":
                    ops.append({"op": "purgefile",
                                "ino": existing["ino"],
                                "size": existing.get("size", 0),
                                "block_size": existing.get(
                                    "block_size", 1 << 22)})
        await self._commit(ops)
        return 0, {"inode": inode}

    async def _rename_cross_rank(self, args, dst_rank, src_parts,
                                 dst_parts
                                 ) -> Tuple[int, Dict[str, Any]]:
        async with self._mutation_lock:
            src_parent, src_name, inode = await self._resolve(
                args["src"])
            if inode is None:
                return ENOENT, {}
            if inode["type"] == "dir":
                sub, ok = self._dir_move_ranks(src_parts, dst_parts,
                                               True)
                if ok is None:
                    # raced into a dir post-peek: retry re-routes to
                    # the subtree-export path
                    return ESTALE, {"error": "src changed; retry"}
            flush = await self._revoke_caps(inode["ino"])
            if flush.get("size_max") is not None:
                inode["size"] = max(inode.get("size", 0),
                                    int(flush["size_max"]))
            intent_seq = await self._commit([
                {"op": "rename_intent", "src_dir": src_parent,
                 "src_name": src_name, "dst": args["dst"],
                 "inode": inode}])
        # dir rename: the subtree rank's clients hold the moving
        # paths (no lock held: peer RPCs)
        if inode["type"] == "dir":
            target = self._subtree_rank(src_parts[0])
            if target != self.rank:
                try:
                    await self._peer_request(
                        target, "peer_revoke", {"revoke_all": True})
                except (RadosError, ObjectNotFound, ConnectionError,
                        OSError, asyncio.TimeoutError):
                    async with self._mutation_lock:
                        await self._commit([{
                            "op": "rename_finish",
                            "intent_seq": intent_seq}])
                    return ESTALE, {"error": "subtree rank"
                                             " unavailable"}
            else:
                for fl in await self._revoke_all_caps():
                    await self._apply_flush(fl, fl.get("path", ""))
        try:
            rc, out = await self._peer_request(
                dst_rank, "peer_link",
                {"dst": args["dst"], "inode": inode})
        except (RadosError, ObjectNotFound, ConnectionError, OSError,
                asyncio.TimeoutError):
            rc, out = ESTALE, {"error": "dst rank unavailable"}
        async with self._mutation_lock:
            if rc != 0:
                await self._commit([{"op": "rename_finish",
                                     "intent_seq": intent_seq}])
                return rc, out
            cur_p, cur_n, cur = await self._resolve(args["src"])
            if cur is not None and cur.get("ino") == inode["ino"]:
                await self._commit([
                    self._dentry(src_parent, src_name, None),
                    {"op": "rename_finish",
                     "intent_seq": intent_seq}])
                return 0, {"inode": inode}
        # the src dentry changed while the lock was released (a
        # concurrent op won the race): compensate — unlink the dst
        # dentry we just linked, value-checked so a NEWER dst write
        # survives
        try:
            await self._peer_request(
                dst_rank, "peer_unlink_ifmatch",
                {"dst": args["dst"], "ino": inode["ino"]})
        except (RadosError, ObjectNotFound, ConnectionError, OSError,
                asyncio.TimeoutError):
            log.warning("mds.%s: rename compensation to rank %d"
                        " failed; dst keeps the link", self.name,
                        dst_rank)
        async with self._mutation_lock:
            await self._commit([{"op": "rename_finish",
                                 "intent_seq": intent_seq}])
        return ESTALE, {"error": "src dentry raced away"}

    async def _finish_pending_renames(self) -> None:
        """Takeover recovery: every journaled rename_intent without a
        rename_finish is re-driven — peer_link again (idempotent at
        the dst), then src removal + finish.  If the src dentry no
        longer carries the ino the intent names, the rename already
        finished (or lost a race) — just close the intent."""
        for seq, intent in sorted(self._pending_intents.items()):
            args = {"src": None, "dst": intent["dst"]}
            inode = intent["inode"]
            dst_rank = owner_rank(intent["dst"], self.num_ranks)
            src_dir, src_name = intent["src_dir"], intent["src_name"]
            try:
                entries = await self._load_dir(src_dir)
                cur = entries.get(src_name)
            except MDSError:
                cur = None
            if cur is None or cur.get("ino") != inode["ino"]:
                await self._commit([{"op": "rename_finish",
                                     "intent_seq": seq}])
                continue
            try:
                rc, _out = await self._peer_request(
                    dst_rank, "peer_link",
                    {"dst": intent["dst"], "inode": inode})
            except (RadosError, ObjectNotFound, ConnectionError,
                    OSError, asyncio.TimeoutError):
                log.warning("mds.%s: pending rename intent %d: dst"
                            " rank %d unreachable; left pending",
                            self.name, seq, dst_rank)
                continue  # stays pending; next takeover retries
            ops = [{"op": "rename_finish", "intent_seq": seq}]
            if rc == 0:
                ops.insert(0, self._dentry(src_dir, src_name, None))
            await self._commit(ops)
        self._pending_intents.clear()

    # -- subtree migration (Migrator/MExportDir role) ----------------------
    #
    # A directory rename whose src and dst top-level components hash
    # to different ranks RE-HOMES the subtree.  Per-rank fencing
    # epochs are incomparable, so ownership of the existing dir
    # OBJECTS cannot move — instead, like the reference's Migrator
    # (Ceph's src/mds/Migrator.cc: EXPORT serializes the
    # subtree metadata and the importer re-journals it as its own),
    # the importer re-creates the subtree under FRESH inos in its own
    # fencing domain and the exporter purges the old objects:
    #
    #   A (owner of the src dentry) journals export_intent
    #   S (subtree rank) dumps the tree and FREEZES it (EAGAIN
    #     to mutations under the prefix, TTL-bounded)
    #   T (new subtree rank) allocates new inos, rewrites dir
    #     entries (dir children remapped, file inos unchanged — data
    #     objects never move), journals ONE import entry
    #   D (owner of the dst dentry) links dst -> new root (peer_link)
    #   A removes the src dentry, S purges the old dir objects
    #     (snap-context aware: snapshots... see the EBUSY guard),
    #   A journals export_finish.
    #
    # Crash at any point re-drives from the journal: import is
    # idempotent (intent-id keyed), link is idempotent, purge is
    # ENOENT-tolerant.  Deposed-active writes stay harmless with NO
    # cross-rank epoch comparison: stale writes can only touch the
    # OLD objects (garbage awaiting purge) or A's own chain (same-
    # rank fencing).  Subtrees referenced by CephFS snapshots refuse
    # to migrate (EBUSY): snapshot resolution keys dirs by ino and
    # the re-created tree has new inos.

    EXPORT_FREEZE_TTL = 30.0
    EXPORT_MAX_DIRS = 2048
    MUTATING_OPS = frozenset((
        "mkdir", "create", "symlink", "unlink", "rmdir", "rename",
        "setattr", "mksnap", "rmsnap"))

    @staticmethod
    def _norm_path(path: str) -> str:
        return "/" + "/".join(p for p in path.split("/") if p)

    async def _export_subtree(self, args, src_parts, dst_parts
                              ) -> Tuple[int, Dict[str, Any]]:
        src_path = self._norm_path(args["src"])
        dst_path = self._norm_path(args["dst"])
        if dst_path == src_path or \
                dst_path.startswith(src_path + "/"):
            return EINVAL, {"error": "dst inside the moved subtree"}
        async with self._mutation_lock:
            src_parent, src_name, inode = await self._resolve(
                src_path)
            if inode is None:
                return ENOENT, {}
            if inode["type"] != "dir":
                # raced to a non-dir: the ordinary rename paths apply
                return ESTALE, {"error": "src changed; retry"}
            _dp, dn, existing = await self._resolve(dst_path)
            if not dn:
                return EINVAL, {}
            if existing is not None:
                # migration does not clobber (the reference freezes
                # only clean exports too); callers remove dst first
                return EEXIST, {"error": "dst exists"}
            intent_id = f"x{self.rank}.{self._epoch}.{self._seq}"
            seq = await self._commit([{
                "op": "export_intent", "id": intent_id,
                "src_dir": src_parent, "src_name": src_name,
                "src": src_path, "dst": dst_path, "inode": inode}])
            intent = {
                "seq": seq, "src_dir": src_parent,
                "src_name": src_name, "src": src_path,
                "dst": dst_path, "inode": inode, "id": intent_id}
        # freeze HERE too: ops on the src dentry itself (rename/
        # rmdir/mksnap of a TOP-LEVEL dir) route to the dentry owner
        # — this rank — not the subtree rank, and must bounce while
        # the export runs
        self._frozen_subtrees[src_path] = \
            time.monotonic() + self.EXPORT_FREEZE_TTL
        return await self._export_drive(intent)

    async def _export_drive(self, it: Dict[str, Any]
                            ) -> Tuple[int, Dict[str, Any]]:
        """Drive one export intent end to end (initial run and
        takeover re-drive share this).  NEVER called holding the
        mutation lock (peer RPCs inside)."""
        seq = it["seq"]
        inode = it["inode"]
        src_parts = [p for p in it["src"].split("/") if p]
        dst_parts = [p for p in it["dst"].split("/") if p]
        s_rank = self._subtree_rank(src_parts[0])
        t_rank = self._subtree_rank(dst_parts[0])
        d_rank = owner_rank(it["dst"], self.num_ranks)
        # every rank's clients hold soon-stale paths: recall all caps
        for r in range(self.num_ranks):
            try:
                if r == self.rank:
                    for fl in await self._revoke_all_caps():
                        await self._apply_flush(fl,
                                                fl.get("path", ""))
                else:
                    await self._peer_request(
                        r, "peer_revoke", {"revoke_all": True})
            except (RadosError, ObjectNotFound, ConnectionError,
                    OSError, asyncio.TimeoutError):
                return ESTALE, {"error": f"rank {r} unavailable"}
        # dump + freeze at the subtree rank
        rc, out = await self._peer_call(
            s_rank, "peer_subtree_dump",
            {"root": inode["ino"], "prefix": it["src"],
             "max_dirs": self.EXPORT_MAX_DIRS})
        if rc != 0:
            await self._close_export(seq, it["src"])
            return rc, out
        dirs = out["dirs"]
        old_inos = [d["ino"] for d in dirs]
        # import at the new subtree rank (idempotent by intent id)
        rc, iout = await self._peer_call(
            t_rank, "peer_subtree_import",
            {"id": it["id"], "dirs": dirs, "root": inode["ino"]})
        if rc != 0:
            await self._peer_call(s_rank, "peer_subtree_thaw",
                                  {"prefix": it["src"]})
            await self._close_export(seq, it["src"])
            return rc, iout
        new_root = int(iout["root"])
        async with self._mutation_lock:
            await self._commit([{
                "op": "export_imported", "intent_seq": seq,
                "id": it["id"], "old_inos": old_inos,
                "new_root": new_root,
                "created": list(iout.get("created", []))}])
        return await self._export_finish_phase(
            seq, it, old_inos, new_root, s_rank, d_rank)

    async def _export_finish_phase(self, seq: int, it: Dict[str, Any],
                                   old_inos, new_root: int,
                                   s_rank: int, d_rank: int
                                   ) -> Tuple[int, Dict[str, Any]]:
        new_inode = dict(it["inode"], ino=new_root)
        rc, out = await self._peer_call(
            d_rank, "peer_link", {"dst": it["dst"],
                                  "inode": new_inode})
        if rc != 0:
            # dst raced into existence: leave the intent open (a
            # takeover retries once the conflict clears) — the new
            # objects are unreachable garbage until then.  Thaw: the
            # re-drive DISCARDS the stale import and re-dumps, so the
            # src must stay usable.
            await self._peer_call(s_rank, "peer_subtree_thaw",
                                  {"prefix": it["src"]})
            self._frozen_subtrees.pop(it["src"], None)
            return rc, out
        async with self._mutation_lock:
            try:
                cur = (await self._load_dir(it["src_dir"])).get(
                    it["src_name"])
            except MDSError:
                cur = None
            if cur is not None and \
                    cur.get("ino") == it["inode"]["ino"]:
                await self._commit([self._dentry(
                    it["src_dir"], it["src_name"], None)])
        rc, _pout = await self._peer_call(
            s_rank, "peer_subtree_purge",
            {"inos": old_inos, "prefix": it["src"]})
        self._frozen_subtrees.pop(it["src"], None)
        if rc != 0:
            # old objects linger; the intent stays open so a takeover
            # re-purges (idempotent).  The rename itself is complete.
            log.warning("mds.%s: export purge at rank %d failed;"
                        " will re-drive", self.name, s_rank)
            return 0, {"inode": new_inode}
        await self._close_export(seq)
        return 0, {"inode": new_inode}

    async def _close_export(self, seq: int,
                            src_path: Optional[str] = None) -> None:
        async with self._mutation_lock:
            await self._commit([{"op": "export_finish",
                                 "intent_seq": seq}])
        self._pending_exports.pop(seq, None)
        if src_path is not None:
            self._frozen_subtrees.pop(src_path, None)

    async def _peer_call(self, rank: int, op: str, args: dict
                         ) -> Tuple[int, Dict[str, Any]]:
        """peer_request that treats self-rank uniformly (the local
        fastpath makes a self-RPC cheap) and folds transport errors
        into ESTALE."""
        try:
            return await self._peer_request(rank, op, args,
                                            timeout=20.0)
        except (RadosError, ObjectNotFound, ConnectionError, OSError,
                asyncio.TimeoutError):
            return ESTALE, {"error": f"rank {rank} unreachable"}

    async def _finish_pending_exports(self) -> None:
        """Takeover: re-drive every journaled export_intent without a
        matching export_finish."""
        for seq, rec in sorted(self._pending_exports.items()):
            op = rec["intent"]
            it = {"seq": seq, "src_dir": op["src_dir"],
                  "src_name": op["src_name"], "src": op["src"],
                  "dst": op["dst"], "inode": op["inode"],
                  "id": op["id"]}
            try:
                if "imported" in rec:
                    await self._redrive_imported(seq, it,
                                                 rec["imported"])
                else:
                    # not imported yet: if the src dentry still names
                    # the old ino, redo the whole drive; else the
                    # export never really started — close it
                    try:
                        cur = (await self._load_dir(
                            it["src_dir"])).get(it["src_name"])
                    except MDSError:
                        cur = None
                    if cur is not None and \
                            cur.get("ino") == it["inode"]["ino"]:
                        await self._export_drive(it)
                    else:
                        await self._close_export(seq, it["src"])
            except Exception:
                log.exception("mds.%s: export re-drive %d failed;"
                              " left pending", self.name, seq)

    async def _redrive_imported(self, seq: int, it: Dict[str, Any],
                                imp: Dict[str, Any]) -> None:
        """Re-drive an export that crashed after the import.  The
        imported copy may be STALE: if the source thawed and took
        mutations since, re-linking it would silently discard them —
        so the copy is only finished when the dst link already
        LANDED; otherwise it is discarded and the export redone from
        a fresh dump."""
        src_parts = [p for p in it["src"].split("/") if p]
        dst_parts = [p for p in it["dst"].split("/") if p]
        s_rank = self._subtree_rank(src_parts[0])
        t_rank = self._subtree_rank(dst_parts[0])
        d_rank = owner_rank(it["dst"], self.num_ranks)
        new_root = int(imp["new_root"])
        try:
            _dp, _dn, dst_cur = await self._resolve(it["dst"])
        except MDSError:
            dst_cur = None
        if dst_cur is not None and dst_cur.get("ino") == new_root:
            # the link landed before the crash: the imported tree IS
            # the live one — finish (src unlink + old purge)
            await self._export_finish_phase(
                seq, it, imp["old_inos"], new_root, s_rank, d_rank)
            return
        # link never landed: the imported copy is unreachable and
        # possibly stale — discard it (purge the new objects, drop
        # the importer's idempotency record)
        await self._peer_call(
            t_rank, "peer_subtree_forget",
            {"id": it["id"], "inos": list(imp.get("created", []))})
        try:
            cur = (await self._load_dir(it["src_dir"])).get(
                it["src_name"])
        except MDSError:
            cur = None
        if cur is not None and cur.get("ino") == it["inode"]["ino"]:
            # source intact: redo the export under a FRESH intent id
            # (the forget dropped the old id's record)
            it = dict(it, id=it["id"] + f".r{self._epoch}")
            await self._export_drive(it)
        else:
            # source moved on (post-thaw user activity): the export
            # is moot
            await self._close_export(seq, it["src"])

    async def _op_peer_subtree_dump(self, args, conn=None
                                    ) -> Tuple[int, Dict[str, Any]]:
        """Subtree-rank half: serialize the tree (the MExportDir
        payload role) and freeze the prefix.  Runs under OUR mutation
        lock, so the dump is a consistent cut."""
        root = int(args["root"])
        max_dirs = int(args.get("max_dirs", self.EXPORT_MAX_DIRS))
        out_dirs: List[Dict[str, Any]] = []
        todo = [root]
        while todo:
            if len(out_dirs) >= max_dirs:
                return EFBIG, {"error": "subtree too large to"
                                        " migrate"}
            ino = todo.pop()
            try:
                entries = await self._load_dir(ino, owned=True)
            except MDSError:
                entries = {}  # half-created dir object: export empty
            out_dirs.append({"ino": ino, "entries": entries})
            todo.extend(e["ino"] for e in entries.values()
                        if e.get("type") == "dir")
        # snapshots key dirs by ino; a migrated (re-inoed) subtree
        # would orphan them — refuse BEFORE freezing
        self._snap_invalidate()
        recs = await self._snap_records()
        inos = {d["ino"] for d in out_dirs}
        if any(r["ino"] in inos for r in recs.values()):
            return EBUSY, {"error": "subtree has snapshots"}
        self._frozen_subtrees[self._norm_path(args["prefix"])] = \
            time.monotonic() + self.EXPORT_FREEZE_TTL
        return 0, {"dirs": out_dirs}

    async def _op_peer_subtree_thaw(self, args, conn=None
                                    ) -> Tuple[int, Dict[str, Any]]:
        """Abort path: release the freeze early (lock-free — pure
        in-memory state; the TTL is the backstop)."""
        self._frozen_subtrees.pop(
            self._norm_path(args.get("prefix", "")), None)
        return 0, {}

    async def _op_peer_subtree_import(self, args, conn=None
                                      ) -> Tuple[int, Dict[str, Any]]:
        """New-subtree-rank half: re-create the dirs under fresh inos
        in OUR fencing domain (the importer re-journals the metadata
        as its own — Migrator.cc import).  Idempotent by intent id."""
        intent = args["id"]
        if intent in self._imports:
            return 0, {"root": self._imports[intent]}
        dirs = args["dirs"]
        mapping = {int(d["ino"]): await self._alloc_ino()
                   for d in dirs}
        ops: List[Dict[str, Any]] = []
        for d in dirs:
            new_ino = mapping[int(d["ino"])]
            ops.append({"op": "mkdirobj", "ino": new_ino})
            for name, ent in d["entries"].items():
                ent = dict(ent)
                if ent.get("type") == "dir":
                    ent["ino"] = mapping.get(int(ent["ino"]),
                                             ent["ino"])
                ops.append(self._dentry(new_ino, name, ent))
        root_new = mapping[int(args["root"])]
        ops.append({"op": "import_done", "id": intent,
                    "root": root_new})
        await self._commit(ops)
        self._imports[intent] = root_new
        return 0, {"root": root_new,
                   "created": sorted(mapping.values())}

    async def _op_peer_subtree_forget(self, args, conn=None
                                      ) -> Tuple[int, Dict[str, Any]]:
        """Discard a stale import: remove the created (never-linked)
        dir objects and drop the idempotency record, so the
        coordinator's re-drive can import a FRESH dump.  The forget
        is journaled — a takeover must not resurrect the record."""
        intent = args.get("id", "")
        ops = [{"op": "rmdirobj", "ino": int(i)}
               for i in args.get("inos", [])]
        ops.append({"op": "import_forget", "id": intent})
        await self._commit(ops)
        self._imports.pop(intent, None)
        return 0, {}

    async def _op_peer_subtree_purge(self, args, conn=None
                                     ) -> Tuple[int, Dict[str, Any]]:
        """Subtree-rank half: drop the exported (now garbage) dir
        objects and thaw the prefix.  guarded_remove is fenced by OUR
        chain and tolerant of already-gone objects."""
        ops = [{"op": "rmdirobj", "ino": int(i)}
               for i in args.get("inos", [])]
        if ops:
            await self._commit(ops)
        self._frozen_subtrees.pop(
            self._norm_path(args.get("prefix", "")), None)
        return 0, {}

    async def _op_peer_link(self, args,
                            conn=None) -> Tuple[int, Dict[str, Any]]:
        """Dst half of a cross-rank rename, executed by the OWNER of
        the dst directory under ITS mutation lock/journal/epoch.
        Idempotent: a replayed intent whose link already landed
        returns success without re-journaling."""
        inode = args["inode"]
        dst_parent, dst_name, existing = await self._resolve(
            args["dst"])
        if not dst_name:
            return EINVAL, {}
        if self._dying(dst_parent):
            return ESTALE, {"error": "dst dir is being removed"}
        if existing is not None and existing["ino"] == inode["ino"]:
            return 0, {}
        if existing is not None:
            if existing["type"] == "dir":
                if inode["type"] != "dir":
                    return EISDIR, {}
                if await self._load_dir(
                        existing["ino"],
                        owned=self._dir_owned(args["dst"])):
                    return ENOTEMPTY, {}
            elif inode["type"] == "dir":
                return ENOTDIR, {}
        inos = [inode["ino"]]
        if existing is not None:
            inos.append(existing["ino"])
        merged = await self._revoke_many(inos)
        if existing is not None and                 merged.get(existing["ino"], {}).get("size_max")                 is not None:
            existing["size"] = max(
                existing.get("size", 0),
                int(merged[existing["ino"]]["size_max"]))
        ops = [self._dentry(dst_parent, dst_name, inode)]
        if existing is not None and existing["ino"] != inode["ino"]:
            if existing["type"] == "dir":
                ops.append({"op": "rmdirobj", "ino": existing["ino"]})
            elif existing["type"] == "file":
                ops.append({"op": "purgefile", "ino": existing["ino"],
                            "size": existing.get("size", 0),
                            "block_size": existing.get("block_size",
                                                       1 << 22)})
        await self._commit(ops)
        return 0, {}

    async def _op_peer_unlink_ifmatch(self, args, conn=None
                                      ) -> Tuple[int, Dict[str, Any]]:
        """Compensation: remove the dst dentry IFF it still carries
        the ino a failed cross-rank rename linked (value-checked — a
        newer write to the same name survives)."""
        dst_parent, dst_name, cur = await self._resolve(args["dst"])
        if cur is not None and cur.get("ino") == args.get("ino"):
            await self._revoke_caps(cur["ino"])
            await self._commit([self._dentry(dst_parent, dst_name,
                                             None)])
        return 0, {}

    # -- top-level rmdir across ranks (owner-side adjudication) ------------

    def _dying(self, ino: int) -> bool:
        exp = self._dying_dirs.get(ino)
        if exp is None:
            return False
        if exp <= time.monotonic():
            self._dying_dirs.pop(ino, None)
            return False
        return True

    async def _op_peer_rmdir_begin(self, args, conn=None
                                   ) -> Tuple[int, Dict[str, Any]]:
        """Rank 0 wants to remove a top-level dir WE own: adjudicate
        emptiness under OUR mutation lock and fence new creates into
        it with a dying mark (TTL-bounded so a crashed remover cannot
        wedge the dir forever)."""
        ino = int(args["ino"])
        entries = await self._load_dir(ino, owned=True)
        if entries:
            return ENOTEMPTY, {}
        self._dying_dirs[ino] = time.monotonic() + 10.0
        return 0, {}

    async def _op_peer_rmdir_done(self, args, conn=None
                                  ) -> Tuple[int, Dict[str, Any]]:
        """Close the protocol: if the dentry removal committed, WE
        remove the (empty) directory object under OUR epoch; either
        way the dying mark clears."""
        ino = int(args["ino"])
        self._dying_dirs.pop(ino, None)
        if args.get("removed"):
            await self._commit([{"op": "rmdirobj", "ino": ino}])
        return 0, {}

    async def _op_setattr(self, args,

                          conn=None) -> Tuple[int, Dict[str, Any]]:
        parent, name, inode = await self._resolve(args["path"])
        if inode is None:
            return ENOENT, {}
        # a foreign setattr invalidates cached attrs everywhere else;
        # a foreign writer's dirty size folds in first so an explicit
        # truncate wins over it but a size_max merge sees it
        flush = await self._revoke_caps(inode["ino"], keep=conn)
        changed = False
        if flush.get("size_max") is not None and "size" not in args:
            new = max(inode.get("size", 0), int(flush["size_max"]))
            changed = new != inode.get("size")
            inode["size"] = new
        for key in ("size", "mode", "mtime"):
            if key in args:
                inode[key] = args[key]
                changed = True
        if args.get("size_max") is not None:
            # concurrent writers race size updates: take the max
            # (the size-extending cap flush discipline)
            new = max(inode.get("size", 0), int(args["size_max"]))
            changed = changed or new != inode.get("size")
            inode["size"] = new
        if changed:
            inode["mtime"] = args.get("mtime", self._now())
            await self._commit([self._dentry(parent, name, inode)])
        return 0, {"inode": inode}

    # -- snapshots (SnapServer + SnapRealm + snapdir roles) ----------------
    #
    # Reference parity: src/mds/SnapServer.h (snapid allocation +
    # global snap table), src/mds/snap.cc SnapRealm (which snaps cover
    # an inode), src/mds/Server.cc handle_client_mksnap/rmsnap and the
    # client's ".snap" pseudo-directory (src/client/Client.cc
    # vinodeno_t snapid traversal).  Re-design: COW is delegated
    # entirely to RADOS self-managed snapshots (one snapid per pool
    # per CephFS snapshot) instead of past-parent dentry versioning —
    # dir omap objects clone on the owning rank's next mutation, file
    # data objects clone on the clients' next writes, and ".snap"
    # reads resolve against those snapids.  Point-in-time is the
    # mksnap window (in-flight writes racing mksnap may land on
    # either side), matching the reference's non-linearizable snap
    # semantics.

    @staticmethod
    def _split_snap_path(path: str):
        """'/a/b/.snap/s1/c' -> (['a','b'], ['s1','c']); None when the
        path has no .snap component."""
        parts = [p for p in path.split("/") if p]
        if SNAP_DIR not in parts:
            return None
        i = parts.index(SNAP_DIR)
        return parts[:i], parts[i + 1:]

    async def _snap_records(self) -> Dict[str, dict]:
        """The global snap table: omap key -> record dict (cached
        briefly; version and records come from ONE omap read so they
        are mutually consistent)."""
        now = time.monotonic()
        if self._snap_cache is not None and \
                now - self._snap_cache[0] < self._snap_cache_ttl:
            return self._snap_cache[2]
        try:
            omap = await self.meta.omap_get(SNAPTABLE_OBJ)
        except ObjectNotFound:
            omap = {}
        ver = 0
        recs: Dict[str, dict] = {}
        for k, v in omap.items():
            if k == SNAPVER_KEY:
                ver = int(float(v.decode()))
            elif not k.startswith("\x00"):
                recs[k] = json.loads(v.decode())
        self._snap_cache = (now, ver, recs)
        return recs

    def _snap_invalidate(self) -> None:
        self._snap_cache = None

    async def _bump_snap_ver(self) -> int:
        raw = await self.meta.execute(
            SNAPTABLE_OBJ, "numops", "add",
            json.dumps({"key": SNAPVER_KEY, "value": 1}).encode())
        return int(float(raw.decode()))

    async def _dir_snaps(self, ino: int) -> Dict[str, dict]:
        """Snapshots taken ON directory ino: name -> record.  PENDING
        rows (mksnap in flight or crashed mid-way) are invisible —
        they exist only so their snapids stay accounted for."""
        return {rec["name"]: rec
                for rec in (await self._snap_records()).values()
                if rec["ino"] == ino and not rec.get("pending")}

    async def _refresh_snapc(self) -> None:
        """Recompute both pools' write snap contexts from the snap
        table and arm them on this rank's IoCtxs (the SnapRealm
        get_snap_context role, collapsed to one global realm)."""
        self._snap_invalidate()
        recs = (await self._snap_records()).values()
        self._snapc_ver = self._snap_cache[1] \
            if self._snap_cache is not None else 0
        meta_snaps = sorted((r["meta_snap"] for r in recs),
                            reverse=True)
        data_snaps = sorted((r["data_snap"] for r in recs),
                            reverse=True)
        self.meta.set_snap_context(
            meta_snaps[0] if meta_snaps else 0, meta_snaps)
        self.data_io.set_snap_context(
            data_snaps[0] if data_snaps else 0, data_snaps)
        self._data_snapc = (data_snaps[0] if data_snaps else 0,
                            data_snaps)

    def _snap_io(self, meta_snap: int) -> IoCtx:
        io = self._snap_ios.get(meta_snap)
        if io is None:
            io = self.client.open_ioctx(self.metadata_pool)
            io.snap_set_read(meta_snap)
            self._snap_ios[meta_snap] = io
        return io

    async def _load_dir_snap(self, ino: int,
                             meta_snap: int) -> Dict[str, dict]:
        """Directory entries as of a metadata snapid (reads resolve to
        the head or a clone server-side).  Immutable -> cacheable."""
        key = (ino, meta_snap)
        cached = self._snap_dirs.get(key)
        if cached is not None:
            return cached
        try:
            omap = await self._snap_io(meta_snap).omap_get(
                dir_obj(ino))
        except ObjectNotFound:
            raise MDSError(ENOENT, f"no directory {ino:x}@{meta_snap}")
        entries = {name: json.loads(raw.decode())
                   for name, raw in omap.items()}
        if len(self._snap_dirs) >= 512:
            self._snap_dirs.clear()
        self._snap_dirs[key] = entries
        return entries

    async def _snap_base(self, base_parts) -> dict:
        """Resolve the directory the .snap component hangs off (at
        head)."""
        if not base_parts:
            return {"ino": ROOT_INO, "type": "dir", "mode": 0o755,
                    "size": 0, "mtime": 0}
        _p, _n, inode = await self._resolve("/" + "/".join(base_parts))
        if inode is None:
            raise MDSError(ENOENT, "/".join(base_parts))
        if inode["type"] != "dir":
            raise MDSError(ENOTDIR, "/".join(base_parts))
        return inode

    async def _snap_resolve(self, path: str) -> Optional[dict]:
        """Resolve a path BELOW .snap/<name> to its inode as of that
        snapshot, annotated with the data snapid for file reads.
        Returns None for ENOENT mid-walk."""
        base, rest = self._split_snap_path(path)
        dir_inode = await self._snap_base(base)
        if not rest:  # the .snap pseudo-directory itself
            return {"ino": 0, "type": "dir", "mode": 0o555,
                    "size": 0, "mtime": 0, "readonly": True}
        snaps = await self._dir_snaps(dir_inode["ino"])
        rec = snaps.get(rest[0])
        if rec is None:
            return None
        cur = dict(dir_inode)
        for comp in rest[1:]:
            if cur["type"] != "dir":
                raise MDSError(ENOTDIR, comp)
            entries = await self._load_dir_snap(cur["ino"],
                                                rec["meta_snap"])
            nxt = entries.get(comp)
            if nxt is None:
                return None
            cur = dict(nxt)
        cur["snapid"] = rec["data_snap"]
        cur["readonly"] = True
        return cur

    async def _snap_lookup(self, args) -> Tuple[int, Dict[str, Any]]:
        """lookup/stat on a .snap path: never grants caps (snapshots
        are immutable; nothing to keep coherent)."""
        base, rest = self._split_snap_path(args["path"])
        if not rest:  # the .snap pseudo-directory itself
            await self._snap_base(base)  # existence check
            return 0, {"inode": {"ino": 0, "type": "dir",
                                 "mode": 0o555, "size": 0, "mtime": 0,
                                 "readonly": True}}
        inode = await self._snap_resolve(args["path"])
        if inode is None:
            return ENOENT, {}
        return 0, {"inode": inode}

    async def _snap_readdir(self, args) -> Tuple[int, Dict[str, Any]]:
        base, rest = self._split_snap_path(args["path"])
        dir_inode = await self._snap_base(base)
        snaps = await self._dir_snaps(dir_inode["ino"])
        if not rest:
            # ls /a/.snap -> one pseudo-dir per snapshot
            entries = {
                name: {"ino": dir_inode["ino"], "type": "dir",
                       "mode": 0o555, "size": 0,
                       "mtime": rec.get("ctime", 0),
                       "snapid": rec["data_snap"], "readonly": True}
                for name, rec in snaps.items()}
            return 0, {"entries": dict(sorted(entries.items()))}
        rec = snaps.get(rest[0])
        if rec is None:
            return ENOENT, {}
        cur_ino, cur_type = dir_inode["ino"], "dir"
        for comp in rest[1:]:
            if cur_type != "dir":
                return ENOTDIR, {}
            entries = await self._load_dir_snap(cur_ino,
                                                rec["meta_snap"])
            nxt = entries.get(comp)
            if nxt is None:
                return ENOENT, {}
            cur_ino, cur_type = nxt["ino"], nxt["type"]
        if cur_type != "dir":
            return ENOTDIR, {}
        entries = await self._load_dir_snap(cur_ino, rec["meta_snap"])
        out = {}
        for name, inode in sorted(entries.items()):
            inode = dict(inode)
            inode["snapid"] = rec["data_snap"]
            inode["readonly"] = True
            out[name] = inode
        return 0, {"entries": out}

    async def _op_mksnap(self, args,
                         conn=None) -> Tuple[int, Dict[str, Any]]:
        """Snapshot the directory at args['path'] under args['name']
        (handle_client_mksnap).  Ordering: allocate snapids -> publish
        in the snap table -> refresh every rank's and client's snap
        context (peer fan-out + cap recall) -> ack.  A crash before
        the table write leaks only pool snapids (harmless, trimmed as
        empty); after it, the snapshot exists and takeover republishes
        contexts."""
        name = args.get("name", "")
        if not name or "/" in name or name == SNAP_DIR:
            return EINVAL, {}
        if self._split_snap_path(args["path"]) is not None:
            return EROFS, {}
        _p, _n, inode = await self._resolve(args["path"])
        if inode is None:
            return ENOENT, {}
        if inode["type"] != "dir":
            return ENOTDIR, {}
        self._snap_invalidate()
        if name in await self._dir_snaps(inode["ino"]):
            return EEXIST, {}
        # Phase 1 — allocate snapids and record them as a PENDING
        # table row BEFORE any advertisement.  Pending rows are
        # invisible to .snap readers but their snapids ride every
        # write context, so clones created against them stay
        # accounted for: a crash mid-mksnap leaves a row the
        # takeover sweeps (releasing the snapids into removed_snaps,
        # which trims the clones) instead of a permanent leak.
        # OUR metadata write context stays on the pre-snap side: the
        # cap-flush persists below must not clone against the new
        # snapid, or the snapshot would record capped writers' stale
        # (possibly zero) sizes forever.
        meta_ctx = (self.meta.snapc_seq, list(self.meta.snapc_snaps))
        data_snap = await self.data_io.create_selfmanaged_snap()
        meta_snap = await self.meta.create_selfmanaged_snap()
        self.meta.set_snap_context(*meta_ctx)  # defer metadata arming
        rec = {"name": name, "ino": inode["ino"],
               "meta_snap": meta_snap, "data_snap": data_snap,
               "ctime": self._now(), "pending": True,
               "rank": self.rank}
        row_key = f"{data_snap:016x}"
        await self.meta.omap_set(
            SNAPTABLE_OBJ, {row_key: json.dumps(rec).encode()})
        # Phase 2 — bump the DURABLE table version, then arm the
        # client-facing data context at that version and recall every
        # cap: each recall carries the new context (a capped writer
        # COWs its very next write), and the acks return dirty sizes,
        # persisted on the pre-snapshot side of the metadata.  The
        # durable bump precedes any advertisement, so a crash here
        # leaves table-ver >= every advertised ver and a takeover's
        # refresh can still correct the clients (regression guard
        # compares >=).
        self._snapc_ver = await self._bump_snap_ver()
        self._data_snapc = (data_snap,
                            [data_snap] + list(self._data_snapc[1]))
        flushed = await self._revoke_all_caps()
        for fl in flushed:
            await self._apply_flush_locked(fl, fl.get("path", ""))
        # Phase 3 — finalize the row: the snapshot becomes visible.
        rec.pop("pending")
        await self.meta.omap_set(
            SNAPTABLE_OBJ, {row_key: json.dumps(rec).encode()})
        await self._bump_snap_ver()
        await self._refresh_snapc()
        await self._snap_fanout()
        return 0, {"snapid": data_snap}

    async def _op_rmsnap(self, args,
                         conn=None) -> Tuple[int, Dict[str, Any]]:
        """Remove a snapshot: drop the table row, then release both
        pool snapids — the OSDs' snap-trim machinery reclaims the
        clones (handle_client_rmsnap + snap trim)."""
        name = args.get("name", "")
        _p, _n, inode = await self._resolve(args["path"])
        if inode is None:
            return ENOENT, {}
        self._snap_invalidate()  # adjudicate on fresh table state
        snaps = await self._dir_snaps(inode["ino"])
        rec = snaps.get(name)
        if rec is None:
            return ENOENT, {}
        # release the pool snapids FIRST (tolerating already-gone), so
        # a transient failure leaves the table row in place and a
        # retried rmsnap reaches the remove calls again — dropping the
        # row first would strand the snapids outside removed_snaps and
        # their clones would never trim
        for io, snapid in ((self.data_io, rec["data_snap"]),
                           (self.meta, rec["meta_snap"])):
            try:
                await io.remove_selfmanaged_snap(snapid)
            except RadosError as e:
                if e.rc != ENOENT:
                    raise
        await self.meta.omap_rm_keys(
            SNAPTABLE_OBJ, [f"{rec['data_snap']:016x}"])
        await self._bump_snap_ver()
        self._snap_ios.pop(rec["meta_snap"], None)
        self._snap_dirs = {k: v for k, v in self._snap_dirs.items()
                           if k[1] != rec["meta_snap"]}
        await self._refresh_snapc()
        await self._snap_fanout()
        return 0, {}

    async def _op_lssnap(self, args,
                         conn=None) -> Tuple[int, Dict[str, Any]]:
        _p, _n, inode = await self._resolve(args["path"])
        if inode is None:
            return ENOENT, {}
        snaps = await self._dir_snaps(inode["ino"])
        return 0, {"snaps": [
            {"name": n, "snapid": r["data_snap"],
             "ctime": r.get("ctime", 0)}
            for n, r in sorted(snaps.items())]}

    async def _sweep_pending_snaps(self) -> None:
        """Takeover: a PENDING row for our rank is a crashed mksnap —
        release its pool snapids (removed_snaps -> the OSDs trim any
        clones clients already created against them) and drop the
        row.  Other ranks' pending rows are their own in-flight or
        crashed mksnaps; their successors sweep them."""
        self._snap_invalidate()
        for key, rec in (await self._snap_records()).items():
            if not rec.get("pending") or \
                    rec.get("rank", 0) != self.rank:
                continue
            log.warning("mds.%s: sweeping crashed mksnap %r "
                        "(snapid %s)", self.name, rec.get("name"),
                        rec.get("data_snap"))
            for io, snapid in ((self.data_io, rec["data_snap"]),
                               (self.meta, rec["meta_snap"])):
                try:
                    await io.remove_selfmanaged_snap(snapid)
                except RadosError as e:
                    if e.rc != ENOENT:
                        raise
            await self.meta.omap_rm_keys(SNAPTABLE_OBJ, [key])
            await self._bump_snap_ver()
        self._snap_invalidate()
        await self._refresh_snapc()

    async def _op_peer_snap_refresh(self, args, conn=None
                                    ) -> Tuple[int, Dict[str, Any]]:
        """Another rank changed the snap table: re-arm our snap
        contexts (lock-free — pure IoCtx state, no dir mutation)."""
        await self._refresh_snapc()
        return 0, {}

    async def _snap_fanout(self) -> None:
        """Tell every other rank to refresh its snap context.
        Best-effort: a rank that misses it refreshes on takeover, and
        its stale window only shifts the snapshot's point-in-time for
        dirs it owns (same non-linearizable semantics as the
        reference)."""
        for rank in range(self.num_ranks):
            if rank == self.rank:
                continue
            try:
                await self._peer_request(rank, "peer_snap_refresh",
                                         {}, timeout=3.0)
            except Exception:
                log.warning("mds.%s: snap refresh to rank %d failed",
                            self.name, rank)


class MDSError(Exception):
    def __init__(self, rc: int, what: str = ""):
        super().__init__(f"rc={rc} {what}")
        self.rc = rc
