"""MemStore: the in-RAM ObjectStore used by tests and diskless daemons
(port of ceph_tpu/os/memstore.py).

Reference parity: the reference's src/os/memstore/MemStore.h:30 — same
role: full ObjectStore semantics with no durability, letting OSD logic
run without a device.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

from ceph_tpu_torch.common.buffer import is_immutable
from ceph_tpu_torch.os import ObjectId, ObjectStore, Transaction


class _Object:
    """data is a bytearray OR an adopted immutable buffer
    (bytes/memoryview) — the reference MemStore holds refcounted
    bufferlists, sharing the writer's pages zero-copy (MemStore.h
    BufferlistObject); a full-object write here adopts the submitted
    buffer by reference and any later mutating op promotes it to a
    private bytearray first."""

    __slots__ = ("data", "xattrs", "omap", "omap_header")

    def __init__(self) -> None:
        self.data = bytearray()
        self.xattrs: Dict[str, bytes] = {}
        self.omap: Dict[str, bytes] = {}
        self.omap_header = b""

    def mutable(self) -> bytearray:
        if not isinstance(self.data, bytearray):
            self.data = bytearray(self.data)
        return self.data

    def clone(self) -> "_Object":
        out = _Object()
        if isinstance(self.data, bytearray):
            out.data = bytearray(self.data)
        else:
            # adopted buffers are immutable (MemStore._immutable):
            # share them — the refcounted-bufferlist COW discipline;
            # a later mutating op promotes through mutable()
            out.data = self.data
        out.xattrs = dict(self.xattrs)
        out.omap = dict(self.omap)
        out.omap_header = self.omap_header
        return out


# full-object writes at least this large are adopted by reference
_ADOPT_MIN = 64 * 1024


class MemStore(ObjectStore):
    def __init__(self) -> None:
        self._colls: Dict[str, Dict[ObjectId, _Object]] = {}
        self._lock = threading.RLock()
        self._mounted = False
        # in-RAM stores still carry an identity: the cluster harness
        # asserts a revived OSD remounted the SAME store (fsid match),
        # and MemStore must answer that question too
        self.fsid = ""

    def mkfs(self) -> None:
        import uuid

        self._colls.clear()
        self.fsid = uuid.uuid4().hex

    def mount(self) -> None:
        self._mounted = True

    def umount(self) -> None:
        self._mounted = False

    # -- transaction apply -------------------------------------------------

    def queue_transaction(self, txn: Transaction) -> None:
        with self._lock:
            for op in txn.ops:
                self._apply(op)
        for cb in txn.on_commit:
            cb()

    @staticmethod
    def _immutable(data) -> bool:
        """Only provably-immutable buffers are adopted by reference: a
        WRITABLE view (or a readonly view over a caller-mutable base)
        could change under the recorded crcs after the op returns.
        The base-chain walk lives in common.buffer.is_immutable (the
        reference's bufferlists are refcounted immutable pages — same
        guarantee)."""
        return is_immutable(data)

    def _obj(self, cid: str, oid: ObjectId, create: bool = False) -> _Object:
        coll = self._colls[cid]
        if oid not in coll:
            if not create:
                raise KeyError(f"{cid}/{oid}")
            coll[oid] = _Object()
        return coll[oid]

    def _apply(self, op) -> None:
        kind = op[0]
        if kind == "mkcoll":
            self._colls.setdefault(op[1], {})
        elif kind == "rmcoll":
            self._colls.pop(op[1], None)
        elif kind == "touch":
            self._obj(op[1], op[2], create=True)
        elif kind == "write":
            _k, cid, oid, offset, data = op
            obj = self._obj(cid, oid, create=True)
            size = len(obj.data)
            if offset == 0 and size == 0:
                if len(data) >= _ADOPT_MIN and self._immutable(data):
                    # adopt by reference (class docstring): zero-copy
                    obj.data = data
                elif len(data) >= _ADOPT_MIN:
                    # writable buffer: the caller may legally reuse it
                    # after the op returns — snapshot
                    obj.data = bytes(data)
                else:
                    obj.data = bytearray(data)
                return
            buf = obj.mutable()
            if offset == size:
                # append fast path: one memcpy, no zero-fill pass
                buf += data
                return
            end = offset + len(data)
            if size < offset:
                buf.extend(b"\0" * (offset - size))
                buf += data
                return
            buf[offset:end] = data
        elif kind == "zero":
            _k, cid, oid, offset, length = op
            obj = self._obj(cid, oid, create=True)
            buf = obj.mutable()
            end = offset + length
            if len(buf) < end:
                buf.extend(b"\0" * (end - len(buf)))
            buf[offset:end] = b"\0" * length
        elif kind == "truncate":
            _k, cid, oid, size = op
            obj = self._obj(cid, oid, create=True)
            if len(obj.data) > size:
                if isinstance(obj.data, bytearray):
                    del obj.data[size:]
                else:
                    obj.data = obj.data[:size]  # zero-copy narrow
            else:
                obj.mutable().extend(b"\0" * (size - len(obj.data)))
        elif kind == "remove":
            self._colls[op[1]].pop(op[2], None)
        elif kind == "clone":
            _k, cid, src, dst = op
            self._colls[cid][dst] = self._obj(cid, src).clone()
        elif kind == "move":
            _k, src_cid, src, dst_cid, dst = op
            obj = self._colls[src_cid].pop(src)
            self._colls.setdefault(dst_cid, {})[dst] = obj
        elif kind == "alloc_hint":
            self._obj(op[1], op[2], create=True)
        elif kind == "setattr":
            self._obj(op[1], op[2], create=True).xattrs[op[3]] = op[4]
        elif kind == "rmattr":
            self._obj(op[1], op[2]).xattrs.pop(op[3], None)
        elif kind == "omap_setkeys":
            self._obj(op[1], op[2], create=True).omap.update(op[3])
        elif kind == "omap_rmkeys":
            obj = self._obj(op[1], op[2])
            for key in op[3]:
                obj.omap.pop(key, None)
        elif kind == "omap_clear":
            self._obj(op[1], op[2]).omap.clear()
        elif kind == "omap_setheader":
            self._obj(op[1], op[2], create=True).omap_header = op[3]
        else:
            raise ValueError(f"unknown transaction op {kind!r}")

    # -- reads -------------------------------------------------------------

    def read(self, cid: str, oid: ObjectId, offset: int = 0,
             length: int = 0) -> bytes:
        with self._lock:
            obj = self._obj(cid, oid)
            if length == 0:
                length = max(len(obj.data) - offset, 0)
            return bytes(obj.data[offset:offset + length])

    def stat(self, cid: str, oid: ObjectId) -> Dict[str, Any]:
        with self._lock:
            obj = self._obj(cid, oid)
            return {"size": len(obj.data)}

    def getattr(self, cid: str, oid: ObjectId, name: str) -> bytes:
        with self._lock:
            return self._obj(cid, oid).xattrs[name]

    def getattrs(self, cid: str, oid: ObjectId) -> Dict[str, bytes]:
        with self._lock:
            return dict(self._obj(cid, oid).xattrs)

    def omap_get(self, cid: str, oid: ObjectId) -> Dict[str, bytes]:
        with self._lock:
            return dict(self._obj(cid, oid).omap)

    def omap_get_header(self, cid: str, oid: ObjectId) -> bytes:
        with self._lock:
            return self._obj(cid, oid).omap_header

    def list_collections(self) -> List[str]:
        with self._lock:
            return sorted(self._colls)

    def list_objects(self, cid: str) -> List[ObjectId]:
        with self._lock:
            return sorted(self._colls.get(cid, {}), key=str)

    def statfs(self) -> Dict[str, int]:
        with self._lock:
            used = sum(len(o.data) for c in self._colls.values()
                       for o in c.values())
        return {"total": 1 << 40, "available": (1 << 40) - used,
                "allocated": used, "stored": used}
