"""ObjectStore: the local storage engine abstraction (port of
ceph_tpu/os/__init__.py).

Reference parity: ObjectStore + Transaction (the reference's
src/os/ObjectStore.h, src/os/Transaction.h): compound
transactions of object mutations (touch/write/zero/truncate/remove/clone,
xattrs, omap, alloc hints) applied atomically to collections of objects.
Backends: MemStore (RAM, tests — src/os/memstore/) and TPUStore (the
BlueStore-role engine: raw block file + allocator + KV metadata + inline
compression/checksums — src/os/bluestore/).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ceph_tpu_torch.common.buffer import is_immutable

# alloc hints (ObjectStore.h CEPH_OSD_ALLOC_HINT_FLAG_*)
ALLOC_HINT_SEQUENTIAL_WRITE = 1
ALLOC_HINT_RANDOM_WRITE = 2
ALLOC_HINT_COMPRESSIBLE = 32
ALLOC_HINT_INCOMPRESSIBLE = 64


@dataclass(frozen=True)
class ObjectId:
    """ghobject-lite: (name, snap); collections scope the pool/pg."""

    name: str
    snap: int = -2  # CEPH_NOSNAP

    def __str__(self) -> str:
        return self.name if self.snap == -2 else f"{self.name}@{self.snap}"


class Transaction:
    """Ordered op list; applied atomically by queue_transaction."""

    def __init__(self) -> None:
        self.ops: List[Tuple] = []
        self.on_commit: List[Callable[[], None]] = []

    # -- collection ops ---------------------------------------------------

    def create_collection(self, cid: str) -> None:
        self.ops.append(("mkcoll", cid))

    def remove_collection(self, cid: str) -> None:
        self.ops.append(("rmcoll", cid))

    # -- object data ops --------------------------------------------------

    def touch(self, cid: str, oid: ObjectId) -> None:
        self.ops.append(("touch", cid, oid))

    def write(self, cid: str, oid: ObjectId, offset: int,
              length: int, data: bytes) -> None:
        """Buffers are CLAIMED, not copied (the reference Transaction
        holds bufferlist refs, src/os/Transaction.h — writers never
        mutate a buffer after queueing it); anything not PROVABLY
        immutable (common.buffer.is_immutable walks the base chain —
        a readonly view over a caller-mutable bytearray is still
        caller-mutable) is snapshotted."""
        assert length == len(data)
        if not is_immutable(data):
            data = bytes(data)
        self.ops.append(("write", cid, oid, offset, data))

    def zero(self, cid: str, oid: ObjectId, offset: int,
             length: int) -> None:
        self.ops.append(("zero", cid, oid, offset, length))

    def truncate(self, cid: str, oid: ObjectId, size: int) -> None:
        self.ops.append(("truncate", cid, oid, size))

    def remove(self, cid: str, oid: ObjectId) -> None:
        self.ops.append(("remove", cid, oid))

    def clone(self, cid: str, src: ObjectId, dst: ObjectId) -> None:
        self.ops.append(("clone", cid, src, dst))

    def collection_move_rename(self, src_cid: str, src: ObjectId,
                               dst_cid: str, dst: ObjectId) -> None:
        self.ops.append(("move", src_cid, src, dst_cid, dst))

    def set_alloc_hint(self, cid: str, oid: ObjectId,
                       expected_object_size: int,
                       expected_write_size: int, flags: int) -> None:
        self.ops.append(("alloc_hint", cid, oid, expected_object_size,
                         expected_write_size, flags))

    # -- xattrs -----------------------------------------------------------

    def setattr(self, cid: str, oid: ObjectId, name: str,
                value: bytes) -> None:
        self.ops.append(("setattr", cid, oid, name, bytes(value)))

    def setattrs(self, cid: str, oid: ObjectId,
                 attrs: Dict[str, bytes]) -> None:
        for name, value in attrs.items():
            self.setattr(cid, oid, name, value)

    def rmattr(self, cid: str, oid: ObjectId, name: str) -> None:
        self.ops.append(("rmattr", cid, oid, name))

    # -- omap -------------------------------------------------------------

    def omap_setkeys(self, cid: str, oid: ObjectId,
                     keys: Dict[str, bytes]) -> None:
        self.ops.append(("omap_setkeys", cid, oid,
                         {k: bytes(v) for k, v in keys.items()}))

    def omap_rmkeys(self, cid: str, oid: ObjectId,
                    keys: List[str]) -> None:
        self.ops.append(("omap_rmkeys", cid, oid, list(keys)))

    def omap_clear(self, cid: str, oid: ObjectId) -> None:
        self.ops.append(("omap_clear", cid, oid))

    def omap_setheader(self, cid: str, oid: ObjectId,
                       header: bytes) -> None:
        self.ops.append(("omap_setheader", cid, oid, bytes(header)))

    def register_on_commit(self, cb: Callable[[], None]) -> None:
        self.on_commit.append(cb)

    def append(self, other: "Transaction") -> None:
        self.ops.extend(other.ops)
        self.on_commit.extend(other.on_commit)

    def empty(self) -> bool:
        return not self.ops


class ObjectStore:
    """The transactional store interface (ObjectStore.h)."""

    def mount(self) -> None:
        raise NotImplementedError

    def umount(self) -> None:
        raise NotImplementedError

    def mkfs(self) -> None:
        raise NotImplementedError

    def queue_transaction(self, txn: Transaction) -> None:
        """Apply atomically; run on_commit callbacks after durability."""
        raise NotImplementedError

    def submit_batch(self, txns: List[Transaction]
                     ) -> List[Optional[Exception]]:
        """Group commit: apply a FIFO batch of transactions, sharing
        durability barriers where the engine can (TPUStore merges the
        KV batches into ONE sync commit and the direct writes into ONE
        block fsync).  Per-txn outcome list: None = committed (its
        on_commit callbacks have fired), an Exception = that txn failed
        and nothing of it was applied.  The base implementation is the
        semantic reference: each txn commits individually, in order —
        engines may amortize barriers but must not change which states
        are durable-visible at each ack."""
        results: List[Optional[Exception]] = []
        for txn in txns:
            try:
                self.queue_transaction(txn)
                results.append(None)
            except Exception as e:
                results.append(e)
        return results

    # -- reads ------------------------------------------------------------

    def read(self, cid: str, oid: ObjectId, offset: int = 0,
             length: int = 0) -> bytes:
        """length 0 = to end of object.  Raises KeyError if absent."""
        raise NotImplementedError

    def stat(self, cid: str, oid: ObjectId) -> Dict[str, Any]:
        raise NotImplementedError

    def exists(self, cid: str, oid: ObjectId) -> bool:
        try:
            self.stat(cid, oid)
            return True
        except KeyError:
            return False

    def getattr(self, cid: str, oid: ObjectId, name: str) -> bytes:
        raise NotImplementedError

    def getattrs(self, cid: str, oid: ObjectId) -> Dict[str, bytes]:
        raise NotImplementedError

    def omap_get(self, cid: str, oid: ObjectId) -> Dict[str, bytes]:
        raise NotImplementedError

    def omap_get_header(self, cid: str, oid: ObjectId) -> bytes:
        raise NotImplementedError

    def list_collections(self) -> List[str]:
        raise NotImplementedError

    def collection_exists(self, cid: str) -> bool:
        return cid in self.list_collections()

    def list_objects(self, cid: str) -> List[ObjectId]:
        raise NotImplementedError

    def statfs(self) -> Dict[str, int]:
        raise NotImplementedError
