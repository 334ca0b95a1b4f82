"""Crash-consistency fault injection for TPUStore (port of
ceph_tpu/os/faultstore.py).

The CrashMonkey/ALICE shape (systematic crash-point exploration,
persistence-ordering checking) on this substrate: a recording shim
under TPUStore's block file and KV logs every write, fsync barrier and
KV batch; from that trace every LEGAL post-crash disk image is
synthesized mechanically — prefix cuts at each event, un-synced block
writes dropped in subsets (the reorder approximation), the last
pending write torn mid-sector — and each image is remounted and
checked against the workload's model:

- mount always succeeds (no schedule may brick the store);
- the observable state equals the model at EXACTLY the last durable
  KV commit — in particular every transaction whose `on_commit` fired
  before the cut is fully visible (acked implies durable);
- journal replay is idempotent, including a second power cut DURING
  replay (the double-crash schedule re-cuts the replay's own writes);
- every read verifies clean (per-blob crc32c — lost un-synced bytes
  under a committed onode surface as csum failures, never as silent
  garbage);
- the freelist and the blob map agree: no extent is both free and
  referenced, no two blobs overlap.

Durability model (what "legal" means here):
- block pwrites are volatile until the next fsync barrier; writes
  after the last barrier may individually persist, vanish or tear;
- KV batches are atomic (the SQLite guarantee) and PREFIX-durable:
  a sync batch (`submit_transaction_sync`) is a barrier; non-sync
  batches after the last barrier may be lost, but only from the tail.

`BrokenBlockStore` / `BrokenCommitStore` are deliberately-broken
subclasses (pre-commit fsync removed / commit point demoted to a
non-sync batch) used as harness self-tests: the same sweep MUST catch
them.

Kill switch: CEPH_TPU_CRASH_INJECT=0 disables power-cut synthesis in
cluster harnesses (kill_osd degrades to a plain process-crash close,
which loses nothing the process handed to the OS).

The stores run on the device they are given (`device=`, passed on to
TPUStore: CUDA unless the caller names another), where the blob checksums
of every write and verified read go.  The device changes no byte of the
trace: block writes, barriers and KV batches are the JAX package's, so the
synthesized images and their digests are too.
"""

from __future__ import annotations

import hashlib
import os as _os

from ceph_tpu_torch.common import flags
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

from ceph_tpu_torch.kv import KeyValueDB, SQLiteDB
from ceph_tpu_torch.kv import Transaction as KVTransaction
from ceph_tpu_torch.os import ObjectId, ObjectStore, Transaction
from ceph_tpu_torch.os.memstore import MemStore
from ceph_tpu_torch.os.tpustore import P_ONODE, TPUStore, _Onode

SECTOR = 512  # torn-write granularity (partial-sector tears cut inside)
KV_PREFIXES = ("S", "O", "M", "F", "D")

# event kinds in the recorded trace
EV_WRITE = "write"    # (offset, bytes)
EV_SYNC = "sync"      # block fsync barrier
EV_KV = "kv"          # (ops, sync_flag)
EV_MARK = "mark"      # (label,) — ack/txn markers ride the trace


def crash_inject_enabled() -> bool:
    return flags.enabled("CEPH_TPU_CRASH_INJECT")


class CrashLog:
    """The recorded persistence trace: every block write, fsync
    barrier and KV batch, in program order."""

    def __init__(self) -> None:
        self.events: List[Tuple] = []

    def block_write(self, offset: int, data: bytes) -> None:
        self.events.append((EV_WRITE, offset, bytes(data)))

    def block_sync(self) -> None:
        self.events.append((EV_SYNC,))

    def kv_commit(self, ops: List[Tuple], sync: bool) -> None:
        self.events.append((EV_KV, list(ops), sync))

    def mark(self, label) -> None:
        self.events.append((EV_MARK, label))

    def __len__(self) -> int:
        return len(self.events)


class RecordingKV(KeyValueDB):
    """Pass-through KV wrapper that records each batch into the
    CrashLog before handing it to the real backend.  `on_commit_event`
    lets the owning store compact its trace on KV-only workloads
    (omap/pg-log traffic produces no block writes, so the block-side
    hooks alone would never fire)."""

    def __init__(self, inner: KeyValueDB, log: CrashLog,
                 on_commit_event=None) -> None:
        self._inner = inner
        self._log = log
        self._on_commit_event = on_commit_event

    def create_and_open(self) -> None:
        self._inner.create_and_open()

    def close(self) -> None:
        self._inner.close()

    def get_transaction(self) -> KVTransaction:
        return self._inner.get_transaction()

    def submit_transaction(self, t: KVTransaction) -> None:
        self._log.kv_commit(t.ops, sync=False)
        self._inner.submit_transaction(t)
        if self._on_commit_event is not None:
            self._on_commit_event()

    def submit_transaction_sync(self, t: KVTransaction) -> None:
        self._log.kv_commit(t.ops, sync=True)
        self._inner.submit_transaction_sync(t)
        if self._on_commit_event is not None:
            self._on_commit_event()

    def get(self, prefix: str, key: bytes):
        return self._inner.get(prefix, key)

    def get_iterator(self, prefix: str, start: bytes = b"",
                     end: Optional[bytes] = None):
        return self._inner.get_iterator(prefix, start, end)


def _dump_kv(kv: KeyValueDB) -> List[Tuple[str, bytes, bytes]]:
    out: List[Tuple[str, bytes, bytes]] = []
    for prefix in KV_PREFIXES:
        for key, value in kv.get_iterator(prefix):
            out.append((prefix, bytes(key), bytes(value or b"")))
    return out


class FaultStore(TPUStore):
    """TPUStore with the recording shim armed: identical behavior, but
    every persistence primitive lands in `self.crashlog` so post-crash
    images can be synthesized from the trace.  The trace covers THIS
    mount only; `mount` captures the pre-existing on-disk state as
    the base image synthesis overlays."""

    def __init__(self, path: str, config=None,
                 crashlog: Optional[CrashLog] = None, device=None):
        super().__init__(path, config, device=device)
        self.crashlog = crashlog if crashlog is not None else CrashLog()
        self._kv = RecordingKV(self._kv, self.crashlog,
                               on_commit_event=self._maybe_compact)
        self.base_block: bytes = b""
        self.base_kv: List[Tuple[str, bytes, bytes]] = []
        # long-lived stores (persistent clusters) fold the durable
        # trace prefix into the base image so RAM stays bounded in
        # events-since-last-barrier, not bytes-ever-written.  The
        # sweep disables this: it needs the whole trace.
        self.trace_compact_threshold: Optional[int] = 4096

    def mount(self) -> None:
        self.capture_base()
        super().mount()

    def capture_base(self) -> None:
        """Snapshot the current on-disk state as the synthesis base
        and restart the trace — everything already down here is, by
        definition, durable."""
        self.base_block = b""
        if _os.path.exists(self._block_path):
            with open(self._block_path, "rb") as f:
                self.base_block = f.read()
        self.base_kv = []
        meta = _os.path.join(self.path, "meta.db")
        if _os.path.exists(meta):
            kv = SQLiteDB(meta)
            kv.create_and_open()
            self.base_kv = _dump_kv(kv)
            kv.close()
        self.crashlog.events.clear()

    def _pwrite(self, offset: int, data: bytes) -> None:
        self.crashlog.block_write(offset, data)
        super()._pwrite(offset, data)
        self._maybe_compact()

    def _block_sync(self) -> None:
        self.crashlog.block_sync()
        super()._block_sync()
        self._maybe_compact()

    def _maybe_compact(self) -> None:
        if self.trace_compact_threshold is not None and \
                len(self.crashlog.events) >= \
                self.trace_compact_threshold:
            self.compact_trace()

    def compact_trace(self) -> None:
        """Fold the durable prefix of the trace into the base image.
        The fold extends to the last sync KV batch but may not cross
        an un-synced block write (one after the last fsync barrier) —
        everything folded survives every legal crash, so synthesis
        from (new base, remaining tail) is byte-identical.  A KV-only
        prefix (omap/pg-log traffic, no block writes) folds on its
        sync batches alone.  Ack marks inside the fold are dropped
        (they refer to txns that are now unconditionally durable)."""
        events = self.crashlog.events
        last_sync = -1
        last_kv_sync = -1
        for i, ev in enumerate(events):
            if ev[0] == EV_SYNC:
                last_sync = i
            elif ev[0] == EV_KV and ev[2]:
                last_kv_sync = i
        fold = last_kv_sync + 1
        for i, ev in enumerate(events[:fold]):
            if ev[0] == EV_WRITE and i > last_sync:
                fold = i  # un-synced write: everything after stays
                break
        if fold <= 0:
            return
        prefix = events[:fold]
        self.base_block = _apply_writes(
            self.base_block,
            [(ev[1], ev[2]) for ev in prefix if ev[0] == EV_WRITE])
        kv: Dict[Tuple[str, bytes], bytes] = {
            (p, k): v for p, k, v in self.base_kv}
        for ev in prefix:
            if ev[0] != EV_KV:
                continue
            for op, p, k, v in ev[1]:
                if op == "set":
                    kv[(p, k)] = v
                elif op == "rm":
                    kv.pop((p, k), None)
                elif op == "rm_prefix":
                    for pk in [pk for pk in kv if pk[0] == p]:
                        del kv[pk]
                elif op == "rm_range":
                    for pk in [pk for pk in kv
                               if pk[0] == p and k <= pk[1] < v]:
                        del kv[pk]
        self.base_kv = sorted(
            (p, k, v) for (p, k), v in kv.items())
        del events[:fold]

    # -- scripted bit-rot --------------------------------------------------

    def inject_bitrot(self, cid: str, oid: ObjectId, span: int = 0,
                      byte: int = 0, mask: int = 0x40) -> int:
        """Flip one byte inside a stored blob (silent media corruption
        — the csum layer, not the journal, must catch this on read).
        Returns the corrupted device offset."""
        onode = self._get_onode(cid, oid)
        blob = onode.blobs[span]
        cur = self._pread(blob.offset + byte, 1)
        # bypass the recorder: bit-rot is not a legal write and must
        # not look like one in the trace
        TPUStore._pwrite(self, blob.offset + byte,
                         bytes([cur[0] ^ mask]))
        self._block.flush()
        return blob.offset + byte

    # -- power-cut crash ---------------------------------------------------

    def crash_powercut(self) -> None:
        """Simulate a POWER CUT (not just a process crash): close the
        handles without flushing, then rewrite the directory to the
        minimal legal post-crash image — un-synced block writes
        dropped, KV cut at the last sync batch.  A subsequent
        TPUStore(path).mount() sees exactly what a machine that lost
        power would."""
        events = list(self.crashlog.events)
        base_block, base_kv = self.base_block, list(self.base_kv)
        self.crash()
        block, ops = build_image(events, len(events), drop_pending=True,
                                 kv_keep="min", base_block=base_block)
        write_image(self.path, block, ops, base_kv=base_kv)


class BrokenBlockStore(FaultStore):
    """Harness SELF-TEST seam: the pre-commit block fsync is removed
    (the barrier neither happens nor is recorded), so direct writes
    stay forever un-synced — the exact bug class the sweep exists to
    catch.  Never mount this outside the self-test."""

    def _block_sync(self) -> None:  # no barrier, no record
        pass


class BrokenCommitStore(FaultStore):
    """Self-test twin: the commit point is demoted to a non-sync KV
    batch, so an acked transaction can vanish in a power cut — the
    sweep must flag the lost ack."""

    def __init__(self, path: str, config=None,
                 crashlog: Optional[CrashLog] = None, device=None):
        super().__init__(path, config, crashlog, device=device)

        class _Demote(RecordingKV):
            def submit_transaction_sync(self, t):
                self.submit_transaction(t)

        self._kv = _Demote(self._kv._inner, self.crashlog,
                           on_commit_event=self._maybe_compact)


# -- post-crash image synthesis --------------------------------------------


def durable_kv_prefix(events: List[Tuple], cut: int,
                      kv_keep: str = "min") -> List[List[Tuple]]:
    """KV batches surviving a crash after events[:cut].  `min` keeps
    batches up to the last SYNC batch (power cut loses the un-synced
    tail); `max` keeps every batch before the cut (they MAY survive —
    but always as a prefix, the WAL append order)."""
    batches: List[Tuple[List[Tuple], bool]] = [
        (ev[1], ev[2]) for ev in events[:cut] if ev[0] == EV_KV]
    if kv_keep == "max":
        return [ops for ops, _s in batches]
    last_sync = -1
    for n, (_ops, sync) in enumerate(batches):
        if sync:
            last_sync = n
    return [ops for ops, _s in batches[:last_sync + 1]]


def _apply_writes(base: bytes,
                  writes: List[Tuple[int, bytes]]) -> bytes:
    """Overlay (offset, data) writes onto a base block image, growing
    it as needed — the ONE write-apply semantics shared by crash
    synthesis and trace compaction (whose contract is that folding
    must be byte-identical to synthesizing from the full trace)."""
    size = len(base)
    for off, data in writes:
        size = max(size, off + len(data))
    buf = bytearray(size)
    buf[:len(base)] = base
    for off, data in writes:
        buf[off:off + len(data)] = data
    return bytes(buf)


def synthesize_block(events: List[Tuple], cut: int,
                     drop: frozenset = frozenset(),
                     drop_pending: bool = False,
                     torn: Optional[Tuple[int, int]] = None,
                     base_block: bytes = b"") -> bytes:
    """The block file a crash after events[:cut] could leave.  Writes
    before the last fsync barrier are durable in order; writes after
    it are pending — `drop` removes chosen ones (indices into events),
    `drop_pending` removes them all, `torn=(idx, keep)` applies only
    the first `keep` bytes of one pending write."""
    last_sync = -1
    for i, ev in enumerate(events[:cut]):
        if ev[0] == EV_SYNC:
            last_sync = i
    writes: List[Tuple[int, bytes]] = []
    for i, ev in enumerate(events[:cut]):
        if ev[0] != EV_WRITE:
            continue
        _k, off, data = ev
        if i > last_sync:
            if drop_pending or i in drop:
                continue
            if torn is not None and torn[0] == i:
                data = data[:torn[1]]
        writes.append((off, data))
    return _apply_writes(base_block, writes)


def build_image(events: List[Tuple], cut: int, *,
                drop: frozenset = frozenset(),
                drop_pending: bool = False,
                torn: Optional[Tuple[int, int]] = None,
                kv_keep: str = "min",
                base_block: bytes = b"",
                ) -> Tuple[bytes, List[List[Tuple]]]:
    """(block bytes, durable KV batches) for one crash schedule."""
    block = synthesize_block(events, cut, drop=drop,
                             drop_pending=drop_pending, torn=torn,
                             base_block=base_block)
    return block, durable_kv_prefix(events, cut, kv_keep)


def write_image(path: str, block: bytes,
                kv_batches: List[List[Tuple]],
                base_kv: Optional[List[Tuple[str, bytes, bytes]]] = None,
                ) -> None:
    """Write a synthesized post-crash image into `path` (replacing
    whatever is there): block file + a fresh KV seeded from `base_kv`
    with the durable batch prefix applied on top."""
    if _os.path.exists(path):
        shutil.rmtree(path)
    _os.makedirs(path)
    with open(_os.path.join(path, "block"), "wb") as f:
        f.write(block)
    kv = SQLiteDB(_os.path.join(path, "meta.db"))
    kv.create_and_open()
    # batches apply in order; concatenating into one sqlite commit is
    # equivalent (ops are order-preserving) and far cheaper per image
    merged = kv.get_transaction()
    for prefix, key, value in (base_kv or []):
        merged.set(prefix, key, value)
    for ops in kv_batches:
        merged.ops.extend(ops)
    kv.submit_transaction(merged)
    kv.close()


def image_digest(block: bytes, kv_batches: List[List[Tuple]],
                 ) -> bytes:
    """Cheap identity of a synthesized image (dedupe remount checks
    for schedules that collapse to the same disk state)."""
    h = hashlib.sha256()
    h.update(block)
    for ops in kv_batches:
        for op in ops:
            h.update(repr(op).encode())
    return h.digest()


# -- model + invariants ----------------------------------------------------


def snapshot_store(store: ObjectStore) -> Dict[str, Dict[str, Tuple]]:
    """Canonical observable state of a mounted store: every object's
    bytes, xattrs, omap and header across every collection.  IOError
    (csum failure) propagates — a checksum violation IS a sweep
    violation."""
    out: Dict[str, Dict[str, Tuple]] = {}
    for cid in store.list_collections():
        objs: Dict[str, Tuple] = {}
        for oid in store.list_objects(cid):
            objs[str(oid)] = (
                store.read(cid, oid),
                dict(store.getattrs(cid, oid)),
                dict(store.omap_get(cid, oid)),
                store.omap_get_header(cid, oid),
            )
        out[cid] = objs
    return out


def check_alloc_consistency(store: TPUStore) -> None:
    """Freelist/blob-map agreement: no device extent may be both free
    and referenced by a committed onode, and no two blobs overlap."""
    free = sorted(store._alloc.free)
    blobs: List[Tuple[int, int, str]] = []
    for key, raw in store._kv.get_iterator(P_ONODE):
        onode = _Onode.from_bytes(raw)
        for span, blob in onode.blobs.items():
            if blob.stored_len:
                blobs.append((blob.offset, blob.stored_len,
                              f"{key!r}:{span}"))
    blobs.sort()
    for (o1, l1, w1), (o2, l2, w2) in zip(blobs, blobs[1:]):
        if o2 < o1 + l1:
            raise AssertionError(
                f"blob overlap: {w1}@{o1}+{l1} vs {w2}@{o2}+{l2}")
    for off, length, who in blobs:
        for f_off, f_len in free:
            if off < f_off + f_len and f_off < off + length:
                raise AssertionError(
                    f"extent both free and referenced: {who}@{off}"
                    f"+{length} overlaps free ({f_off},{f_len})")


class Violation(Exception):
    """One crash schedule broke an invariant."""


class CrashSweep:
    """Run a workload on a recording store, then explore every crash
    point: synthesize each legal post-crash image, remount, check the
    invariants.  `store_cls` swaps in a deliberately broken store for
    the harness self-test; every store the sweep builds runs on
    `device`."""

    def __init__(self, workdir: str,
                 store_cls: Callable[..., FaultStore] = FaultStore,
                 config=None, device=None):
        self.workdir = str(workdir)
        self.store_cls = store_cls
        self.config = config
        self.device = device
        self.events: List[Tuple] = []
        # model snapshots: snapshots[i] = observable state after txn i
        # (snapshots[0] = post-setup state)
        self.snapshots: List[Dict] = []
        # cumulative txn count at each sync commit boundary: with
        # group commit (record(batch=K)) one sync covers K txns, so
        # the durable ceiling at sync j is _sync_txns[j-1], not j
        self._sync_txns: List[int] = []
        self.base_block: bytes = b""
        self.base_kv: List[Tuple[str, bytes, bytes]] = []

    # -- recording run -----------------------------------------------------

    def record(self, workload: Optional[Callable] = None,
               txns: int = 24, seed: int = 0,
               batch: int = 1) -> None:
        """Run the workload once on a recording store and a MemStore
        model in lockstep, keeping the trace and per-txn model
        snapshots.  Recording starts after setup (mkfs + collection),
        whose durable state becomes the synthesis base.

        batch > 1 records through the GROUP-COMMIT path: every K txns
        ride ONE store.submit_batch (one sync commit, shared fsync,
        per-txn acks after the shared barrier) — the merged batch must
        still be a legal trace, txns cut mid-window must vanish
        WHOLESALE (none acked), and acked txns must never vanish.
        The model still applies per txn, so snapshots stay per-txn
        and _sync_txns maps each sync commit to the txn count it made
        durable."""
        live_dir = _os.path.join(self.workdir, "live")
        if _os.path.exists(live_dir):
            shutil.rmtree(live_dir)
        store = self.store_cls(live_dir, config=self.config,
                               device=self.device)
        store.trace_compact_threshold = None  # the sweep IS the trace
        store.mkfs()
        store.mount()
        model = MemStore()
        model.mkfs()
        model.mount()
        for target in (store, model):
            t = Transaction()
            t.create_collection("cc")
            target.queue_transaction(t)
        # base image: what is durably down before the workload starts
        # (the setup commits are sync; the block file is still empty)
        with open(store._block_path, "rb") as f:
            self.base_block = f.read()
        self.base_kv = _dump_kv(store._kv)
        store.crashlog.events.clear()
        self.snapshots = [snapshot_store(model)]
        self._sync_txns = []
        batch = max(int(batch), 1)
        window: List[Transaction] = []
        work = list((workload or default_workload)(txns, seed))
        for i, txn in enumerate(work):
            txn.register_on_commit(
                lambda i=i: store.crashlog.mark(("ack", i + 1)))
            mtxn = Transaction()
            mtxn.ops = list(txn.ops)
            model.queue_transaction(mtxn)
            window.append(txn)
            if len(window) >= batch or i == len(work) - 1:
                if len(window) == 1:
                    store.queue_transaction(window[0])
                else:
                    errs = [e for e in store.submit_batch(window) if e]
                    if errs:
                        raise errs[0]
                self._sync_txns.append(i + 1)
                window = []
            self.snapshots.append(snapshot_store(model))
        self.events = list(store.crashlog.events)
        store.umount()
        model.umount()

    # -- exploration -------------------------------------------------------

    def _schedules(self, cut: int, torn: bool = True):
        """Legal crash schedules at one cut: all-pending-lost,
        all-pending-applied, each single pending write dropped
        (reorder approximation, capped), and the last pending write
        torn mid-sector."""
        pending: List[int] = []
        last_sync = -1
        for i, ev in enumerate(self.events[:cut]):
            if ev[0] == EV_SYNC:
                last_sync = i
        for i, ev in enumerate(self.events[:cut]):
            if ev[0] == EV_WRITE and i > last_sync:
                pending.append(i)
        yield {"drop_pending": True}
        if pending:
            yield {}
            for i in pending[:3]:
                yield {"drop": frozenset([i])}
            if torn:
                last = pending[-1]
                data = self.events[last][2]
                if len(data) > 1:
                    keep = (len(data) // SECTOR) * SECTOR
                    if keep in (0, len(data)):
                        keep = max(1, len(data) // 2)  # mid-sector tear
                    yield {"torn": (last, keep)}

    def _legal_window(self, cut: int) -> Tuple[int, int]:
        """(ack floor, durable commit ceiling) in txn numbers for a
        power cut after events[:cut]."""
        floor = ceiling = 0
        syncs = 0
        for ev in self.events[:cut]:
            if ev[0] == EV_KV and ev[2]:
                syncs += 1
                # one sync commit may cover a whole group-commit
                # batch: the ceiling is the txn count that sync made
                # durable (identity when recorded un-batched)
                ceiling = self._sync_txns[syncs - 1] \
                    if syncs <= len(self._sync_txns) else syncs
            elif ev[0] == EV_MARK and isinstance(ev[1], tuple) \
                    and ev[1][0] == "ack":
                floor = max(floor, ev[1][1])
        return floor, ceiling

    def check_image(self, img: str, cut: int) -> None:
        """Mount the synthesized image and check every invariant."""
        floor, ceiling = self._legal_window(cut)
        if floor > ceiling:
            raise Violation(
                f"acked txn {floor} not durable at cut {cut} "
                f"(durable ceiling {ceiling})")
        store = TPUStore(img, config=self.config, device=self.device)
        try:
            store.mount()  # invariant: mount always succeeds
        except Exception as e:
            raise Violation(f"mount failed at cut {cut}: {e!r}")
        try:
            try:
                state = snapshot_store(store)
            except IOError as e:
                raise Violation(
                    f"csum failure at cut {cut} (floor {floor}): {e}")
            # the durable KV prefix pins the state exactly: the
            # observable store is a function of (KV prefix, journal),
            # and every referenced byte is either synced or journaled
            if ceiling >= len(self.snapshots) or \
                    state != self.snapshots[ceiling]:
                raise Violation(
                    f"state at cut {cut} is not the model at txn "
                    f"{ceiling} (acked floor {floor})")
            try:
                check_alloc_consistency(store)
            except AssertionError as e:
                raise Violation(f"alloc at cut {cut}: {e}")
        finally:
            store.umount()

    def _double_crash(self, img: str, cut: int) -> int:
        """Re-crash DURING the first remount's journal replay: record
        the replay's own writes, cut them again at every point, and
        require the SECOND remount to still satisfy the invariants.
        Returns the number of inner crash points checked."""
        store = FaultStore(img, config=self.config, device=self.device)
        try:
            store.mount()  # replay runs here, recorded
        except Exception as e:
            raise Violation(f"replay mount failed at cut {cut}: {e!r}")
        replay_events = list(store.crashlog.events)
        replay_base_block = store.base_block
        replay_base_kv = store.base_kv
        store.crash()
        if not replay_events:
            return 0
        points = 0
        img2 = _os.path.join(self.workdir, "img2")
        for inner in range(1, len(replay_events) + 1):
            block, ops = build_image(
                replay_events, inner, drop_pending=True, kv_keep="min",
                base_block=replay_base_block)
            write_image(img2, block, ops, base_kv=replay_base_kv)
            self.check_image(img2, cut)
            points += 1
        return points

    def run(self, workload: Optional[Callable] = None,
            txns: int = 24, seed: int = 0,
            max_points: Optional[int] = None,
            stride: int = 1, torn: bool = True,
            double_crash: bool = True,
            batch: int = 1) -> Dict[str, Any]:
        """The sweep: record, then explore.  `stride`/`max_points`
        bound smoke runs (tier-1 sizes via CEPH_TPU_CRASH_SWEEP_*);
        batch > 1 records through submit_batch (group commit armed);
        returns {points, violations, double_crash_points, ...}."""
        self.record(workload=workload, txns=txns, seed=seed,
                    batch=batch)
        img = _os.path.join(self.workdir, "img")
        points = 0
        dc_points = 0
        violations: List[str] = []
        seen: set = set()
        cuts = list(range(1, len(self.events) + 1, max(1, stride)))
        if cuts and cuts[-1] != len(self.events):
            cuts.append(len(self.events))
        dc_budget = 3  # double-crash legs are the expensive tail
        for cut in cuts:
            if max_points is not None and points >= max_points:
                break
            # ack⇒durable is checked PER CUT, before any image-digest
            # dedup: the ack mark changes no disk byte, so the cut
            # right after an ack dedups to the pre-ack image — hiding
            # exactly the inversion (floor > ceiling) a broken commit
            # point produces
            floor, ceiling = self._legal_window(cut)
            if floor > ceiling:
                points += 1
                violations.append(
                    f"acked txn {floor} not durable at cut {cut} "
                    f"(durable ceiling {ceiling})")
                continue
            # un-synced KV batches may also SURVIVE (as a prefix):
            # explore the max variant whenever it differs from min
            kv_keeps = ["min"]
            if len(durable_kv_prefix(self.events, cut, "max")) != \
                    len(durable_kv_prefix(self.events, cut, "min")):
                kv_keeps.append("max")
            for sched in self._schedules(cut, torn=torn):
                for kv_keep in kv_keeps:
                    if max_points is not None and \
                            points >= max_points:
                        break
                    points += 1
                    try:
                        block, ops = build_image(
                            self.events, cut, kv_keep=kv_keep,
                            base_block=self.base_block, **sched)
                        # identical images need only one remount
                        # check, but each schedule still counts as a
                        # crash point
                        digest = image_digest(block, ops)
                        fresh = digest not in seen
                        if fresh:
                            seen.add(digest)
                            write_image(img, block, ops,
                                        base_kv=self.base_kv)
                            self.check_image(img, cut)
                        if double_crash and kv_keep == "min" \
                                and sched.get("drop_pending") \
                                and dc_budget > 0 and _has_defer(
                                    self.events, cut):
                            dc_budget -= 1
                            # ALWAYS rewrite: check_image's mount has
                            # already replayed + trimmed the journal
                            # inside `img`, so reusing it would hand
                            # _double_crash an empty replay trace
                            write_image(img, block, ops,
                                        base_kv=self.base_kv)
                            dc_points += self._double_crash(img, cut)
                    except Violation as e:
                        violations.append(str(e))
        return {"points": points,
                "distinct_images": len(seen),
                "double_crash_points": dc_points,
                "events": len(self.events),
                "txns": len(self.snapshots) - 1,
                "violations": violations}


def _has_defer(events: List[Tuple], cut: int) -> bool:
    """True when the durable KV prefix at this cut still carries
    deferred-journal entries (a double-crash-during-replay leg is only
    interesting when replay has work to do)."""
    live: set = set()
    for ops in durable_kv_prefix(events, cut, "min"):
        for op, prefix, key, _value in ops:
            if prefix != "D":
                continue
            if op == "set":
                live.add(key)
            elif op == "rm":
                live.discard(key)
            elif op in ("rm_prefix", "rm_range"):
                live.clear()
    return bool(live)


# -- default workload ------------------------------------------------------


def default_workload(txns: int = 24, seed: int = 0):
    """Mixed write/overwrite/deferred/omap workload: small in-place
    overwrites (the deferred WAL path), COW rewrites, multi-span
    objects, zero/truncate, xattr/omap churn, clone and remove — every
    TPUStore persistence path, deterministic per seed."""
    import random

    rng = random.Random(seed)
    oids = [ObjectId(f"o{i}") for i in range(6)]
    sizes: Dict[str, int] = {}  # current sizes, drives legal overwrites

    def payload(n: int) -> bytes:
        return bytes(rng.getrandbits(8) for _ in range(n))

    for i in range(txns):
        t = Transaction()
        kind = i % 8
        oid = oids[rng.randrange(len(oids))]
        if kind == 0 or str(oid) not in sizes:
            # fresh/base write: big enough that overwrites can defer,
            # occasionally multi-span (COW across blob boundaries)
            n = 70_000 if i % 5 == 0 else rng.randrange(4096, 9000)
            t.write("cc", oid, 0, n, payload(n))
            sizes[str(oid)] = n
        elif kind in (1, 2, 3):
            # small in-place overwrite: the deferred-WAL path
            n = rng.randrange(16, 600)
            off = rng.randrange(0, max(1, sizes[str(oid)] - n))
            t.write("cc", oid, off, n, payload(n))
        elif kind == 4:
            n = rng.randrange(100, 2000)
            off = rng.randrange(0, sizes[str(oid)])
            t.zero("cc", oid, off, n)
            t.omap_setkeys("cc", oid, {f"k{i}": payload(12)})
            sizes[str(oid)] = max(sizes[str(oid)], off + n)
        elif kind == 5:
            new = max(1, sizes[str(oid)] // 2)
            t.truncate("cc", oid, new)
            t.setattr("cc", oid, f"a{i % 3}", payload(8))
            sizes[str(oid)] = new
        elif kind == 6:
            dst = ObjectId(f"{oid.name}_c{i}")
            t.clone("cc", oid, dst)
            sizes[str(dst)] = sizes[str(oid)]
        else:
            t.remove("cc", oid)
            t.omap_setheader("cc", oids[0], payload(6))
            sizes.pop(str(oid), None)
        yield t
