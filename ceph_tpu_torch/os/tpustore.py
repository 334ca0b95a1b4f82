"""TPUStore: the BlueStore-role persistent ObjectStore (port of
ceph_tpu/os/tpustore.py).

Reference parity: BlueStore (the reference's src/os/bluestore/) at
architecture level — a raw block file managed by an extent Allocator,
object metadata (onodes: size, blob map, xattrs) in a KeyValueDB, omap in
the same KV, per-blob checksums verified on every read (_verify_csum,
BlueStore.cc:9636-9663), inline compression behind the required-ratio
gate (_do_alloc_write, BlueStore.cc:13459-13606).

Write model: objects are covered by fixed logical spans of
`max_blob_size`; a write copies-on-writes every touched span — new data
always lands in freshly allocated extents, and the KV batch that commits
the new blob map also returns the old extents to the freelist, so a crash
between the two leaves the old object intact (BlueStore's no-overwrite
discipline) — EXCEPT small overwrites of existing uncompressed blobs,
which take BlueStore's deferred-write path: the new bytes ride the KV
commit batch itself (the WAL), the transaction skips the block-file
fsync entirely, and the in-place overwrite is applied after the commit
point and journal-trimmed in batches; mount replays any pending
entries (BlueStore.cc _deferred_queue/_deferred_replay).

Device hook: per-blob crc32c runs through the batched Checksummer path
(the crc kernel on CUDA for 8 or more blocks), and compression candidates
are pre-scored on the device (ceph_tpu_torch.compressor.scoring, the
`score_blocks` kernel for spans of 64 KiB and more) before any host codec
runs.  The store runs on the device it is given: CUDA unless the caller
names another (no CUDA and no device raises); `device="cpu"` runs the
kernels' plain versions.  The device changes no byte on disk: block file,
onodes, blob JSON, compression headers, csum layout and KV prefixes are
the JAX package's, so a store written by one package mounts in the other.
"""

from __future__ import annotations

import json
import os as _os
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ceph_tpu_torch.common import checksummer as csum_mod
from ceph_tpu_torch.common import tracing
from ceph_tpu_torch.common.checksummer import CSUM_NONE, Checksummer
from ceph_tpu_torch.compressor import (Compressor, gate, get_comp_mode_type,
                                       scoring)
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.kv import SQLiteDB
from ceph_tpu_torch.os import ObjectId, ObjectStore, Transaction

# KV prefixes (BlueStore's column families)
P_SUPER = "S"
P_ONODE = "O"
P_OMAP = "M"
P_FREELIST = "F"
P_DEFER = "D"   # deferred-write WAL (BlueStore deferred_transaction_t)


class Allocator:
    """First-fit extent allocator over the block file (Allocator role)."""

    def __init__(self) -> None:
        self.free: List[Tuple[int, int]] = []  # sorted (offset, length)
        self.device_size = 0

    def init_add_free(self, offset: int, length: int) -> None:
        self.free.append((offset, length))
        self._merge()

    def _merge(self) -> None:
        self.free.sort()
        merged: List[Tuple[int, int]] = []
        for off, ln in self.free:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + ln)
            else:
                merged.append((off, ln))
        self.free = merged

    def allocate(self, length: int) -> int:
        """Returns the offset; grows the logical device when fragmented."""
        for i, (off, ln) in enumerate(self.free):
            if ln >= length:
                if ln == length:
                    self.free.pop(i)
                else:
                    self.free[i] = (off + length, ln - length)
                return off
        off = self.device_size
        self.device_size += length
        return off

    def release(self, offset: int, length: int) -> None:
        if length:
            self.free.append((offset, length))
            self._merge()

    def to_json(self) -> dict:
        return {"free": self.free, "device_size": self.device_size}

    @classmethod
    def from_json(cls, d: dict) -> "Allocator":
        a = cls()
        a.free = [tuple(e) for e in d["free"]]
        a.device_size = int(d["device_size"])
        return a


class _Blob:
    """One stored span: extent + csum + compression metadata."""

    __slots__ = ("offset", "stored_len", "raw_len", "csum_data",
                 "comp_alg", "comp_msg", "csum_type", "csum_block")

    def __init__(self, offset: int, stored_len: int, raw_len: int,
                 csum_data: bytes, comp_alg: Optional[int],
                 comp_msg: Optional[int], csum_type: int = 1,  # CSUM_NONE
                 csum_block: int = 4096):
        self.offset = offset
        self.stored_len = stored_len
        self.raw_len = raw_len
        self.csum_data = csum_data
        self.comp_alg = comp_alg
        self.comp_msg = comp_msg
        # blobs carry their own csum params (bluestore_blob_t does the
        # same) so a config change never invalidates existing data
        self.csum_type = csum_type
        self.csum_block = csum_block

    def to_json(self) -> list:
        return [self.offset, self.stored_len, self.raw_len,
                self.csum_data.hex(), self.comp_alg, self.comp_msg,
                self.csum_type, self.csum_block]

    @classmethod
    def from_json(cls, d: list) -> "_Blob":
        return cls(d[0], d[1], d[2], bytes.fromhex(d[3]), d[4], d[5],
                   d[6] if len(d) > 6 else 1,
                   d[7] if len(d) > 7 else 4096)


class _Onode:
    def __init__(self) -> None:
        self.size = 0
        self.blobs: Dict[int, _Blob] = {}  # span index -> blob
        self.xattrs: Dict[str, str] = {}   # hex-encoded values
        self.omap_header = ""
        self.alloc_hint_flags = 0

    def to_bytes(self) -> bytes:
        return json.dumps({
            "size": self.size,
            "blobs": {str(k): b.to_json() for k, b in self.blobs.items()},
            "xattrs": self.xattrs,
            "omap_header": self.omap_header,
            "alloc_hint_flags": self.alloc_hint_flags,
        }).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "_Onode":
        d = json.loads(raw)
        o = cls()
        o.size = d["size"]
        o.blobs = {int(k): _Blob.from_json(v)
                   for k, v in d["blobs"].items()}
        o.xattrs = d["xattrs"]
        o.omap_header = d.get("omap_header", "")
        o.alloc_hint_flags = d.get("alloc_hint_flags", 0)
        return o


class TPUStore(ObjectStore):
    def __init__(self, path: str, config=None, device=None):
        self.path = path
        # where the blob csums and the compression pre-scores run
        self.device = resolve_device(device)
        self._config = config
        self._kv = SQLiteDB(_os.path.join(path, "meta.db"))
        self._block_path = _os.path.join(path, "block")
        self._block = None
        self._alloc = Allocator()
        self._lock = threading.RLock()
        self._txc: Optional[Dict[bytes, Optional[_Onode]]] = None
        self._txc_colls: set = set()
        # extents freed by the in-flight transaction; returned to the
        # allocator only after the KV commit succeeds (BlueStore defers
        # release until after kv commit) so no op in the same transaction
        # — or a crash before the commit point — can overwrite data still
        # referenced by committed onodes
        self._txc_release: List[Tuple[int, int]] = []
        # deferred-write WAL state: entries journaled by the in-flight
        # txn, and applied-but-not-yet-trimmed journal keys
        self._txc_defer: List[Tuple[int, bytes, bytes]] = []
        self._txc_direct = False
        # (journal key, extent offset, length) applied but untrimmed
        self._pending_defer: List[Tuple[bytes, int, int]] = []
        self._defer_seq = 0
        # journaled-but-not-yet-applied bytes, keyed by blob offset:
        # reads (including later ops in the SAME txn) must see the
        # deferred data even though the block file still holds the old
        # bytes until the post-commit apply
        self._defer_overlay: Dict[int, bytes] = {}
        self._compressor: Optional[Compressor] = None
        self._mounted = False
        # config (bluestore_* options)
        self.max_blob_size = 64 * 1024
        self.prefer_deferred_size = 32 * 1024
        self.deferred_batch = 32
        self.csum_type = csum_mod.CSUM_CRC32C
        self.csum_block_size = 4096
        self.comp_mode = 0  # COMP_NONE unless configured
        self.required_ratio = gate.DEFAULT_REQUIRED_RATIO
        # store identity: written once at mkfs, read back at mount —
        # a remount of the same directory must present the same fsid
        # (the BlueStore fsid file role; cluster harnesses assert a
        # revived OSD got ITS disk back, not a fresh one)
        self.fsid: str = ""
        # durability/observability counters (l_bluestore_* perf role);
        # surfaced by the daemon's `store_status` and perf dump
        self.perf: Dict[str, int] = {
            "kv_commits": 0,
            "block_fsyncs": 0,
            "deferred_writes": 0,
            "deferred_bytes": 0,
            "journal_replays": 0,
            "journal_replayed_entries": 0,
            "journal_replayed_bytes": 0,
            "csum_read_failures": 0,
            # group commit (submit_batch): merged-batch accounting —
            # barriers the batching amortized away vs one-txn commits
            "gc_batches": 0,
            "gc_txns": 0,
            "gc_fsyncs_saved": 0,
            "gc_kv_commits_saved": 0,
        }
        self._load_config()

    def _load_config(self) -> None:
        if self._config is None:
            self.comp_mode = 0  # none
            return
        self.csum_type = csum_mod.get_csum_string_type(
            self._config.get("bluestore_csum_type"))
        self.csum_block_size = int(
            self._config.get("bluestore_csum_block_size"))
        self.max_blob_size = int(
            self._config.get("bluestore_compression_max_blob_size"))
        self.comp_mode = get_comp_mode_type(
            self._config.get("bluestore_compression_mode")) or 0
        self.required_ratio = float(
            self._config.get("bluestore_compression_required_ratio"))
        alg = self._config.get("bluestore_compression_algorithm")
        self._compressor = Compressor.create(alg) if alg else None

    # -- lifecycle ---------------------------------------------------------

    def mkfs(self) -> None:
        _os.makedirs(self.path, exist_ok=True)
        # the block file (and its directory entry) must be durable
        # BEFORE the superblock commit below: a store whose KV says it
        # is valid but whose block file's dirent died with the power
        # would fail mount
        with open(self._block_path, "ab"):
            pass
        dirfd = _os.open(self.path, _os.O_RDONLY)
        try:
            _os.fsync(dirfd)
        finally:
            _os.close(dirfd)
        self._kv.create_and_open()
        t = self._kv.get_transaction()
        t.set(P_SUPER, b"format", b"tpustore-1")
        t.set(P_SUPER, b"fsid", uuid.uuid4().hex.encode())
        t.set(P_FREELIST, b"state",
              json.dumps(self._alloc.to_json()).encode())
        # mkfs is a durability point: a power cut right after must
        # still find a mountable store
        self._kv.submit_transaction_sync(t)
        self._kv.close()

    def mount(self) -> None:
        self._kv.create_and_open()
        fmt = self._kv.get(P_SUPER, b"format")
        if fmt != b"tpustore-1":
            raise RuntimeError(f"{self.path}: not a tpustore ({fmt!r})")
        self.fsid = (self._kv.get(P_SUPER, b"fsid") or b"").decode()
        state = self._kv.get(P_FREELIST, b"state")
        self._alloc = Allocator.from_json(json.loads(state))
        self._block = open(self._block_path, "r+b")
        self._replay_deferred()
        self._mounted = True

    def _block_sync(self) -> None:
        """The block-file durability barrier: everything written
        before this survives a power cut (the ONE choke point, so a
        fault-injecting subclass can record — or deliberately omit —
        the barrier)."""
        self._block.flush()
        _os.fsync(self._block.fileno())
        self.perf["block_fsyncs"] += 1

    def _replay_deferred(self) -> None:
        """Apply journaled in-place writes that may not have reached
        the block file before a crash (idempotent — a crash DURING
        replay just replays again on the next mount), then trim."""
        keys = []
        for key, value in self._kv.get_iterator(P_DEFER):
            off = int.from_bytes(value[:8], "little")
            self._pwrite(off, value[8:])
            keys.append(key)
            self._defer_seq = max(self._defer_seq, int(key))
            self.perf["journal_replayed_entries"] += 1
            self.perf["journal_replayed_bytes"] += len(value) - 8
        if keys:
            self.perf["journal_replays"] += 1
            self._block_sync()
            t = self._kv.get_transaction()
            for key in keys:
                t.rmkey(P_DEFER, key)
            # trim loss is benign (replay is idempotent and KV batches
            # are prefix-durable), so the trim rides a NORMAL commit
            self._kv.submit_transaction(t)

    def _flush_deferred(self) -> None:
        """Make applied deferred writes durable on the block file,
        then trim their journal entries (one fsync per batch — the
        amortization that makes small overwrites cheap)."""
        if not self._pending_defer:
            return
        self._block_sync()
        t = self._kv.get_transaction()
        for key, _off, _ln in self._pending_defer:
            t.rmkey(P_DEFER, key)
        self._kv.submit_transaction(t)
        self._pending_defer = []

    def umount(self) -> None:
        if self._block is not None:
            self._flush_deferred()
        if self._block is not None:
            self._block_sync()
            self._block.close()
            self._block = None
        self._kv.close()
        self._mounted = False

    def crash(self) -> None:
        """Process-crash seam for tests/harnesses: abandon the store
        WITHOUT the clean umount's deferred flush + fsync.  Bytes
        already handed to the OS survive (process-crash semantics — a
        remount replays the deferred WAL); a power cut additionally
        loses un-synced state, which FaultStore.crash_powercut
        synthesizes on top of this."""
        if self._block is not None:
            try:
                # hand userspace-buffered bytes to the OS page cache
                # (a crashed process loses nothing it already wrote);
                # deliberately NO fsync and NO journal trim
                self._block.flush()
            except ValueError:
                pass
            self._block.close()
            self._block = None
        self._kv.close()
        self._mounted = False
        self._pending_defer = []
        self._defer_overlay.clear()

    def perf_counters(self) -> Dict[str, int]:
        """Durability counters + live gauges (the perf-dump `store`
        section / `store_status` payload)."""
        out = dict(self.perf)
        out["deferred_queue_depth"] = len(self._pending_defer)
        return out

    # -- onode cache-free helpers ------------------------------------------

    @staticmethod
    def _okey(cid: str, oid: ObjectId) -> bytes:
        return f"{cid}\0{oid}".encode()

    def _get_onode(self, cid: str, oid: ObjectId,
                   create: bool = False) -> _Onode:
        # read-your-writes within the transaction being applied
        key = self._okey(cid, oid)
        if self._txc is not None and key in self._txc:
            cached = self._txc[key]
            if cached is None:
                if not create:
                    raise KeyError(f"{cid}/{oid}")
            else:
                return cached
        raw = self._kv.get(P_ONODE, key)
        if raw is None or (self._txc is not None
                           and self._txc.get(key, raw) is None):
            if not create:
                raise KeyError(f"{cid}/{oid}")
            if cid not in self._txc_colls and \
                    self._kv.get(P_SUPER, b"coll." + cid.encode()) is None:
                raise KeyError(f"no collection {cid}")
            onode = _Onode()
        else:
            onode = _Onode.from_bytes(raw)
        if self._txc is not None:
            self._txc[key] = onode
        return onode

    def _put_onode(self, kvt, cid: str, oid: ObjectId,
                   onode: _Onode) -> None:
        key = self._okey(cid, oid)
        if self._txc is not None:
            self._txc[key] = onode
        kvt.set(P_ONODE, key, onode.to_bytes())

    def _drop_onode(self, kvt, cid: str, oid: ObjectId) -> None:
        key = self._okey(cid, oid)
        if self._txc is not None:
            self._txc[key] = None
        kvt.rmkey(P_ONODE, key)

    # -- block io ----------------------------------------------------------

    def _pwrite(self, offset: int, data: bytes) -> None:
        self._block.seek(offset)
        self._block.write(data)

    def _pwrite_direct(self, offset: int, data: bytes) -> None:
        """A write that must be durable at THIS transaction's commit
        (marks the txn as needing the pre-commit block fsync)."""
        self._txc_direct = True
        self._pwrite(offset, data)

    def _pread(self, offset: int, length: int) -> bytes:
        self._block.seek(offset)
        out = self._block.read(length)
        if len(out) < length:
            out += bytes(length - len(out))
        return out

    # -- write path (_do_alloc_write) --------------------------------------

    def _span_write(self, kvt, onode: _Onode, span: int,
                    raw: bytes, write_len: Optional[int] = None,
                    write_off: int = 0) -> None:
        """Store one logical span COW-style: compress-candidate scoring,
        gate, csum, allocate, write; old extent freed in the same batch.

        Small overwrites (write_len <= prefer_deferred_size) of an
        existing uncompressed blob take the DEFERRED path instead: the
        bytes are journaled into this txn's KV batch and applied
        in-place after the commit point — no COW, no per-write block
        fsync."""
        old = onode.blobs.get(span)
        if (write_len is not None and old is not None
                and old.comp_alg is None
                and old.stored_len >= len(raw) > 0
                and write_len <= self.prefer_deferred_size
                and not (self.comp_mode and self._compressor)):
            csum_data = bytearray()
            if self.csum_type != CSUM_NONE:
                padded_len = -(-len(raw) // self.csum_block_size) * \
                    self.csum_block_size
                padded = raw + bytes(padded_len - len(raw))
                Checksummer.calculate(
                    self.csum_type, self.csum_block_size, 0,
                    padded_len, padded, csum_data, device=self.device)
            self._defer_seq += 1
            key = f"{self._defer_seq:020d}".encode()
            # journal ONLY the touched byte range (BlueStore journals
            # the modified chunks, not the whole blob — a 50-byte
            # overwrite must not WAL 64 KiB); crash replay applies the
            # delta over the intact pre-image, matching the committed
            # csum computed over the merged span
            delta = raw[write_off:write_off + write_len]
            kvt.set(P_DEFER, key,
                    (old.offset + write_off).to_bytes(8, "little")
                    + delta)
            self._txc_defer.append(
                (old.offset + write_off, delta, key))
            self.perf["deferred_writes"] += 1
            self.perf["deferred_bytes"] += len(delta)
            self._defer_overlay[old.offset] = bytes(raw)
            if old.stored_len > len(raw):
                # the shrunken tail is unreferenced: free it
                self._txc_release.append(
                    (old.offset + len(raw), old.stored_len - len(raw)))
            onode.blobs[span] = _Blob(
                old.offset, len(raw), len(raw), bytes(csum_data),
                None, None, csum_type=self.csum_type,
                csum_block=self.csum_block_size)
            return
        payload, header = raw, None
        if self.comp_mode and self._compressor is not None and raw:
            # device pre-score: skip the host codec for incompressible
            # spans (COMP_FORCE bypasses the prescreen — forced means
            # forced)
            arr = np.frombuffer(raw, dtype=np.uint8)[None, :]
            if self.comp_mode == gate.COMP_FORCE or bool(
                    scoring.compress_decision(
                        arr, self.required_ratio, device=self.device)[0]):
                payload, header = gate.maybe_compress(
                    raw, self._compressor, self.comp_mode,
                    onode.alloc_hint_flags, self.required_ratio)
        csum_data = bytearray()
        if self.csum_type != CSUM_NONE:
            padded_len = -(-len(payload) // self.csum_block_size) * \
                self.csum_block_size
            padded = payload + bytes(padded_len - len(payload))
            Checksummer.calculate(self.csum_type, self.csum_block_size, 0,
                                  padded_len, padded, csum_data,
                                  device=self.device)
        offset = self._alloc.allocate(len(payload)) if payload else 0
        if payload:
            self._pwrite_direct(offset, payload)
        onode.blobs[span] = _Blob(
            offset, len(payload), len(raw), bytes(csum_data),
            header.alg if header else None,
            header.compressor_message if header else None,
            csum_type=self.csum_type, csum_block=self.csum_block_size)
        if old is not None and old.stored_len:
            self._txc_release.append((old.offset, old.stored_len))

    def _span_read(self, blob: _Blob) -> bytes:
        overlay = self._defer_overlay.get(blob.offset)
        if overlay is not None and len(overlay) >= blob.stored_len:
            payload = overlay[:blob.stored_len]
        else:
            payload = self._pread(blob.offset, blob.stored_len)
        if blob.csum_type != CSUM_NONE and blob.csum_data:
            padded_len = -(-len(payload) // blob.csum_block) * \
                blob.csum_block
            padded = payload + bytes(padded_len - len(payload))
            bad = Checksummer.verify(
                blob.csum_type, blob.csum_block, 0, padded_len,
                padded, blob.csum_data, device=self.device)
            if bad >= 0:
                self.perf["csum_read_failures"] += 1
                raise IOError(
                    f"csum mismatch at blob offset {bad}"
                    f" (device offset {blob.offset + bad})")
        if blob.comp_alg is not None:
            header = gate.CompressionHeader(
                blob.comp_alg, blob.raw_len, blob.comp_msg)
            payload = gate.decompress(payload, header)
        return payload

    def _object_write(self, kvt, cid: str, oid: ObjectId, offset: int,
                      data: bytes) -> None:
        onode = self._get_onode(cid, oid, create=True)
        end = offset + len(data)
        span0 = offset // self.max_blob_size
        span1 = (end - 1) // self.max_blob_size if data else span0
        pos = 0
        for span in range(span0, span1 + 1):
            s_start = span * self.max_blob_size
            s_end = s_start + self.max_blob_size
            w_start = max(offset, s_start)
            w_end = min(end, s_end)
            old_blob = onode.blobs.get(span)
            span_len = min(self.max_blob_size,
                           max(onode.size, w_end) - s_start)
            if old_blob is not None:
                raw = bytearray(self._span_read(old_blob))
                if len(raw) < span_len:
                    raw.extend(bytes(span_len - len(raw)))
            else:
                raw = bytearray(span_len)
            raw[w_start - s_start:w_end - s_start] = \
                data[pos:pos + (w_end - w_start)]
            pos += w_end - w_start
            self._span_write(kvt, onode, span, bytes(raw),
                             write_len=w_end - w_start,
                             write_off=w_start - s_start)
        onode.size = max(onode.size, end)
        self._put_onode(kvt, cid, oid, onode)

    def _object_remove(self, kvt, cid: str, oid: ObjectId) -> None:
        try:
            onode = self._get_onode(cid, oid)
        except KeyError:
            return
        for blob in onode.blobs.values():
            if blob.stored_len:
                self._txc_release.append((blob.offset, blob.stored_len))
        self._drop_onode(kvt, cid, oid)
        okey = self._okey(cid, oid)
        kvt.rm_range_keys(P_OMAP, okey + b"\0", okey + b"\1")

    # -- transaction apply --------------------------------------------------

    def queue_transaction(self, txn: Transaction) -> None:
        err = self._submit_merged([txn])
        if err is not None:
            raise err

    def submit_batch(self, txns) -> list:
        """Group commit: N transactions, ONE commit point.  The KV
        batches merge into a single submit_transaction_sync and the
        direct block writes share a single pre-commit fsync — N
        concurrent writers buy one barrier instead of N (the BlueStore
        kv_sync_thread amortization).  Read-your-writes spans the
        batch (txn i sees txn j<i's onodes/collections), so the
        merged batch applies byte-identically to committing each txn
        in order.  If ANY apply fails, the merged attempt is rolled
        back untouched (nothing was submitted) and the batch replays
        through the one-txn path so exactly the failing txn reports
        its error and the rest still commit — per-txn isolation at
        per-txn cost, paid only on the error path."""
        if not txns:
            return []
        if len(txns) == 1:
            try:
                self.queue_transaction(txns[0])
                return [None]
            except Exception as e:
                return [e]
        if self._submit_merged(txns) is None:
            return [None] * len(txns)
        results = []
        for txn in txns:
            try:
                self.queue_transaction(txn)
                results.append(None)
            except Exception as e:
                results.append(e)
        return results

    def _submit_merged(self, txns) -> Optional[Exception]:
        """Apply+commit a FIFO list of transactions as one commit unit
        (the one-txn path is the degenerate batch).  Returns None on
        success — all on_commit callbacks fired — or the first apply
        exception, with the store rolled back as if nothing ran."""
        with self._lock:
            kvt = self._kv.get_transaction()
            self._txc = {}
            self._txc_colls = set()
            self._txc_release = []
            self._txc_defer = []
            self._txc_direct = False
            direct_txns = 0
            # a failed apply must not leak half a batch: restore the
            # allocator (extents allocated by earlier ops) and the
            # deferred overlay, and submit nothing; pending releases
            # are simply discarded, so nothing was freed and nothing
            # freed was reusable mid-batch
            alloc_snapshot = (list(self._alloc.free),
                              self._alloc.device_size)
            overlay_snapshot = dict(self._defer_overlay)
            try:
                for txn in txns:
                    txn_direct_before = self._txc_direct
                    self._txc_direct = False
                    for op in txn.ops:
                        self._apply(kvt, op)
                    if self._txc_direct:
                        direct_txns += 1
                    self._txc_direct = \
                        self._txc_direct or txn_direct_before
            except Exception as e:
                self._alloc.free, self._alloc.device_size = alloc_snapshot
                self._txc_release = []
                self._defer_overlay = overlay_snapshot
                self._txc_defer = []
                self._txc = None
                self._txc_colls = set()
                return e
            finally:
                self._txc = None
                self._txc_colls = set()
            # the persisted freelist is the post-commit truth: allocator
            # state with this transaction's releases applied — but the
            # in-memory allocator only sees them after the commit point
            if self._txc_release:
                final_alloc = Allocator()
                final_alloc.free = list(self._alloc.free)
                final_alloc.device_size = self._alloc.device_size
                for off, ln in self._txc_release:
                    final_alloc.release(off, ln)
                state_json = final_alloc.to_json()
            else:
                state_json = self._alloc.to_json()
            kvt.set(P_FREELIST, b"state",
                    json.dumps(state_json).encode())
            # data first, then the metadata commit point — but a
            # purely-deferred txn carries its data IN the KV batch and
            # skips the block fsync entirely (the deferred-write win)
            if self._txc_direct:
                with tracing.child_span_sync("fsync"):
                    self._block_sync()
            # the commit point IS the durability point: once this
            # returns, on_commit fires and the ack must survive a
            # power cut — so the batch goes down SYNC (BlueStore syncs
            # its RocksDB WAL the same way; the WAL-mode NORMAL
            # default only survives process death, and an acked write
            # that vanishes on power loss is the one failure nothing
            # upstack can repair)
            with tracing.child_span_sync("kv_commit"):
                self._kv.submit_transaction_sync(kvt)
            self.perf["kv_commits"] += 1
            # apply deferred in-place writes AFTER the commit point:
            # their durability is the journal entry; the block file
            # catches up here and fsyncs lazily in batches
            for off, delta, key in self._txc_defer:
                self._pwrite(off, delta)
                self._pending_defer.append((key, off, len(delta)))
            if self._txc_defer:
                # the block file has caught up: overlays are stale
                # (a newer same-txn overlay was already overwritten by
                # its own later _span_write call)
                self._defer_overlay.clear()
            self._txc_defer = []
            # releases overlapping a pending journal entry must wait
            # for the journal trim: a crash would otherwise REPLAY the
            # stale bytes over whatever reallocated the extent
            # (BlueStore holds deferred extents out of the freelist
            # for the same reason)
            if self._txc_release and self._pending_defer and any(
                    r_off < d_off + d_ln and d_off < r_off + r_ln
                    for r_off, r_ln in self._txc_release
                    for _k, d_off, d_ln in self._pending_defer):
                self._flush_deferred()
            elif len(self._pending_defer) >= self.deferred_batch:
                self._flush_deferred()
            for off, ln in self._txc_release:
                self._alloc.release(off, ln)
            self._txc_release = []
            if len(txns) > 1:
                # group-commit accounting: what the batch saved vs N
                # one-txn commits (fsyncs only count when more than
                # one member would have paid one)
                self.perf["gc_batches"] += 1
                self.perf["gc_txns"] += len(txns)
                self.perf["gc_kv_commits_saved"] += len(txns) - 1
                self.perf["gc_fsyncs_saved"] += max(direct_txns - 1, 0)
        # per-txn acks fire only after the SHARED barrier, in batch
        # order — the ack=>durable contract is per txn, the barrier is
        # per batch
        for txn in txns:
            for cb in txn.on_commit:
                cb()
        return None

    def _apply(self, kvt, op) -> None:
        kind = op[0]
        if kind == "mkcoll":
            kvt.set(P_SUPER, b"coll." + op[1].encode(), b"1")
            self._txc_colls.add(op[1])  # visible within this txn
        elif kind == "rmcoll":
            kvt.rmkey(P_SUPER, b"coll." + op[1].encode())
        elif kind == "touch" or kind == "alloc_hint":
            cid, oid = op[1], op[2]
            onode = self._get_onode(cid, oid, create=True)
            if kind == "alloc_hint":
                onode.alloc_hint_flags = op[5]
            self._put_onode(kvt, cid, oid, onode)
        elif kind == "write":
            _k, cid, oid, offset, data = op
            if not isinstance(data, (bytes, bytearray, memoryview)):
                data = bytes(data)  # StridedBuf: durable store is a copy anyway
            self._object_write(kvt, cid, oid, offset, data)
        elif kind == "zero":
            _k, cid, oid, offset, length = op
            self._object_write(kvt, cid, oid, offset, bytes(length))
        elif kind == "truncate":
            _k, cid, oid, size = op
            onode = self._get_onode(cid, oid, create=True)
            if size < onode.size:
                keep_spans = -(-size // self.max_blob_size) if size else 0
                for span in [s for s in onode.blobs if s >= keep_spans]:
                    blob = onode.blobs.pop(span)
                    if blob.stored_len:
                        self._txc_release.append(
                            (blob.offset, blob.stored_len))
                onode.size = size
                # partial tail span: rewrite truncated
                if size % self.max_blob_size and (size // self.max_blob_size) in onode.blobs:
                    tail_span = size // self.max_blob_size
                    raw = self._span_read(onode.blobs[tail_span])
                    self._span_write(kvt, onode, tail_span,
                                     raw[:size % self.max_blob_size])
            else:
                onode.size = size
            self._put_onode(kvt, cid, oid, onode)
        elif kind == "remove":
            self._object_remove(kvt, op[1], op[2])
        elif kind == "clone":
            _k, cid, src, dst = op
            data = self.read(cid, src)
            src_onode = self._get_onode(cid, src)
            self._object_remove(kvt, cid, dst)
            dst_onode = _Onode()
            dst_onode.xattrs = dict(src_onode.xattrs)
            dst_onode.omap_header = src_onode.omap_header
            dst_onode.alloc_hint_flags = src_onode.alloc_hint_flags
            self._put_onode(kvt, cid, dst, dst_onode)
            self._object_write(kvt, cid, dst, 0, data)
            # omap copy
            okey_src = self._okey(cid, src)
            okey_dst = self._okey(cid, dst)
            for key, value in list(self._kv.get_iterator(
                    P_OMAP, okey_src + b"\0", okey_src + b"\1")):
                kvt.set(P_OMAP, okey_dst + b"\0" + key[len(okey_src) + 1:],
                        value)
        elif kind == "move":
            _k, src_cid, src, dst_cid, dst = op
            onode = self._get_onode(src_cid, src)
            self._drop_onode(kvt, src_cid, src)
            self._put_onode(kvt, dst_cid, dst, onode)
            okey_src = self._okey(src_cid, src)
            okey_dst = self._okey(dst_cid, dst)
            for key, value in list(self._kv.get_iterator(
                    P_OMAP, okey_src + b"\0", okey_src + b"\1")):
                kvt.set(P_OMAP, okey_dst + b"\0" + key[len(okey_src) + 1:],
                        value)
                kvt.rmkey(P_OMAP, key)
        elif kind == "setattr":
            _k, cid, oid, name, value = op
            onode = self._get_onode(cid, oid, create=True)
            onode.xattrs[name] = value.hex()
            self._put_onode(kvt, cid, oid, onode)
        elif kind == "rmattr":
            _k, cid, oid, name = op
            onode = self._get_onode(cid, oid)
            onode.xattrs.pop(name, None)
            self._put_onode(kvt, cid, oid, onode)
        elif kind == "omap_setkeys":
            _k, cid, oid, keys = op
            okey = self._okey(cid, oid)
            for key, value in keys.items():
                kvt.set(P_OMAP, okey + b"\0" + key.encode(), value)
        elif kind == "omap_rmkeys":
            _k, cid, oid, keys = op
            okey = self._okey(cid, oid)
            for key in keys:
                kvt.rmkey(P_OMAP, okey + b"\0" + key.encode())
        elif kind == "omap_clear":
            okey = self._okey(op[1], op[2])
            kvt.rm_range_keys(P_OMAP, okey + b"\0", okey + b"\1")
        elif kind == "omap_setheader":
            _k, cid, oid, header = op
            onode = self._get_onode(cid, oid, create=True)
            onode.omap_header = header.hex()
            self._put_onode(kvt, cid, oid, onode)
        else:
            raise ValueError(f"unknown transaction op {kind!r}")

    # -- reads --------------------------------------------------------------

    def read(self, cid: str, oid: ObjectId, offset: int = 0,
             length: int = 0) -> bytes:
        with self._lock:
            onode = self._get_onode(cid, oid)
            if length == 0:
                length = max(onode.size - offset, 0)
            end = min(offset + length, onode.size)
            if end <= offset:
                return b""
            out = bytearray()
            span0 = offset // self.max_blob_size
            span1 = (end - 1) // self.max_blob_size
            for span in range(span0, span1 + 1):
                s_start = span * self.max_blob_size
                blob = onode.blobs.get(span)
                covered = min(self.max_blob_size, onode.size - s_start)
                if blob is None:
                    raw = bytes(covered)
                else:
                    raw = self._span_read(blob)
                    if len(raw) < covered:  # hole inside the span
                        raw += bytes(covered - len(raw))
                r_start = max(offset, s_start) - s_start
                r_end = min(end, s_start + self.max_blob_size) - s_start
                out += raw[r_start:r_end]
            return bytes(out)

    def stat(self, cid: str, oid: ObjectId) -> Dict[str, Any]:
        with self._lock:
            onode = self._get_onode(cid, oid)
            return {"size": onode.size}

    def getattr(self, cid: str, oid: ObjectId, name: str) -> bytes:
        with self._lock:
            return bytes.fromhex(self._get_onode(cid, oid).xattrs[name])

    def getattrs(self, cid: str, oid: ObjectId) -> Dict[str, bytes]:
        with self._lock:
            return {k: bytes.fromhex(v)
                    for k, v in self._get_onode(cid, oid).xattrs.items()}

    def omap_get(self, cid: str, oid: ObjectId) -> Dict[str, bytes]:
        with self._lock:
            okey = self._okey(cid, oid)
            return {key[len(okey) + 1:].decode(): value
                    for key, value in self._kv.get_iterator(
                        P_OMAP, okey + b"\0", okey + b"\1")}

    def omap_get_header(self, cid: str, oid: ObjectId) -> bytes:
        with self._lock:
            return bytes.fromhex(self._get_onode(cid, oid).omap_header)

    def list_collections(self) -> List[str]:
        with self._lock:
            return sorted(
                key[len(b"coll."):].decode()
                for key, _v in self._kv.get_iterator(P_SUPER, b"coll.")
                if key.startswith(b"coll."))

    def list_objects(self, cid: str) -> List[ObjectId]:
        with self._lock:
            prefix = f"{cid}\0".encode()
            out = []
            for key, _v in self._kv.get_iterator(
                    P_ONODE, prefix, prefix + b"\xff"):
                name = key[len(prefix):].decode()
                if "@" in name:
                    base, snap_s = name.rsplit("@", 1)
                    out.append(ObjectId(base, int(snap_s)))
                else:
                    out.append(ObjectId(name))
            return sorted(out, key=str)

    def statfs(self) -> Dict[str, int]:
        with self._lock:
            free = sum(ln for _off, ln in self._alloc.free)
            return {"total": max(self._alloc.device_size, 1),
                    "available": free,
                    "allocated": self._alloc.device_size - free,
                    "stored": self._alloc.device_size - free}
