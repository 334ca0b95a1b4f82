"""RadosStriper: byte-addressed striped objects over an IoCtx (port of
ceph_tpu/rados/striper.py).

Reference parity: libradosstriper
(Ceph's src/libradosstriper/RadosStriperImpl.cc) — a logical
"striped object" soid maps onto rados objects `soid.%016x`, byte
ranges spread RAID-0 style across a stripe set (stripe_unit x
stripe_count, object_size per backing object), layout + logical size
recorded on the FIRST object so any client can reopen the stream.

Layout math is the Striper::file_to_extents shape
(Ceph's src/osdc/Striper.cc): offset -> (stripe unit index,
object set, object within set, in-object offset).
"""

from __future__ import annotations

import asyncio
import json
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ceph_tpu_torch.rados.client import IoCtx, ObjectNotFound, RadosError

LOCK_NAME = "striper.lock"
LOCK_DURATION = 30.0

DEFAULT_STRIPE_UNIT = 512 * 1024
DEFAULT_STRIPE_COUNT = 4
DEFAULT_OBJECT_SIZE = 4 << 20

LAYOUT_ATTR = "striper.layout"


class RadosStriper:
    """libradosstriper::RadosStriper role over one IoCtx."""

    def __init__(self, ioctx: IoCtx,
                 stripe_unit: int = DEFAULT_STRIPE_UNIT,
                 stripe_count: int = DEFAULT_STRIPE_COUNT,
                 object_size: int = DEFAULT_OBJECT_SIZE):
        if object_size % stripe_unit:
            raise RadosError(-22, "object_size % stripe_unit != 0")
        self.ioctx = ioctx
        self._renewals: Dict[str, "asyncio.Task"] = {}
        self.stripe_unit = stripe_unit
        self.stripe_count = stripe_count
        self.object_size = object_size

    @staticmethod
    def _obj(soid: str, objectno: int) -> str:
        return f"{soid}.{objectno:016x}"

    async def _layout(self, soid: str) -> Dict[str, Any]:
        try:
            raw = await self.ioctx.getxattr(self._obj(soid, 0),
                                            LAYOUT_ATTR)
        except RadosError as e:
            if e.rc in (-2, -61):   # ENOENT / ENODATA
                raise ObjectNotFound(-2, soid)
            raise
        return json.loads(raw.decode())

    async def _save_layout(self, soid: str, size: int,
                           max_size: Optional[int] = None) -> None:
        """max_size is the HIGH-WATER size: truncate only zeroes data,
        so backing objects can outlive `size` — remove() walks the
        high-water extent or it would orphan them (the reference
        striper tracks this via the object-set it actually deletes)."""
        await self.ioctx.setxattr(
            self._obj(soid, 0), LAYOUT_ATTR,
            json.dumps({"stripe_unit": self.stripe_unit,
                        "stripe_count": self.stripe_count,
                        "object_size": self.object_size,
                        "size": size,
                        "max_size": size if max_size is None
                        else max_size}).encode())

    # -- exclusive op lock (RadosStriperImpl lock-on-first-object) --------

    async def _lock(self, soid: str, timeout: float = 10.0) -> str:
        """Exclusive cls_lock on object 0: append/write/truncate/remove
        are read-modify-writes of the stored layout (size), and two
        unsynchronized appends would both read size S and overwrite
        each other — the reference serializes these under a cls lock
        on the first object (RadosStriperImpl.cc aioWrite/truncate
        lockObject).  Busy-waits with backoff until acquired; taken
        with a 30s duration so a crashed holder expires instead of
        bricking the object (lock_info_t expiration)."""
        cookie = uuid.uuid4().hex
        req = json.dumps({"name": LOCK_NAME, "type": "exclusive",
                          "cookie": cookie, "duration": LOCK_DURATION,
                          "owner": f"striper.{cookie[:8]}"}).encode()
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            try:
                await self.ioctx.execute(self._obj(soid, 0), "lock",
                                         "lock", req)
                break
            except RadosError as e:
                if e.rc != -16:   # EBUSY: another striper op holds it
                    raise
                if asyncio.get_running_loop().time() > deadline:
                    raise
                await asyncio.sleep(0.02)
        # renewal heartbeat: an op outliving the duration (recovery
        # stalls, huge objects) must not silently lose its exclusion —
        # re-locking with the same (owner, cookie) extends the expiry
        # (the reference renews across long ops); a CRASHED holder
        # stops renewing and expires within LOCK_DURATION
        async def renew():
            while True:
                await asyncio.sleep(LOCK_DURATION / 3)
                try:
                    await self.ioctx.execute(self._obj(soid, 0),
                                             "lock", "lock", req)
                except Exception:
                    return  # lost/removed: the op will fail on its own
        task = asyncio.get_running_loop().create_task(renew())
        self._renewals[cookie] = task
        return cookie

    async def _unlock(self, soid: str, cookie: str) -> None:
        task = self._renewals.pop(cookie, None)
        if task is not None:
            task.cancel()
        req = json.dumps({"name": LOCK_NAME, "cookie": cookie,
                          "owner": f"striper.{cookie[:8]}"}).encode()
        try:
            await self.ioctx.execute(self._obj(soid, 0), "lock",
                                     "unlock", req)
        except (ObjectNotFound, RadosError):
            pass  # object 0 removed with the stream: lock died with it

    def _extents(self, offset: int, length: int,
                 layout: Dict[str, Any] = None
                 ) -> List[Tuple[int, int, int]]:
        """byte range -> [(objectno, in-object offset, span)] — the
        file_to_extents RAID-0 walk.  Geometry comes from the STORED
        layout when given (reads/truncates of an existing stream must
        follow how it was written, not this handle's defaults)."""
        if layout is not None:
            su = layout["stripe_unit"]
            sc = layout["stripe_count"]
            osz = layout["object_size"]
        else:
            su, sc, osz = (self.stripe_unit, self.stripe_count,
                           self.object_size)
        per_set = osz * sc           # bytes per object set
        units_per_obj = osz // su
        out: List[Tuple[int, int, int]] = []
        end = offset + length
        while offset < end:
            unit = offset // su      # global stripe unit index
            in_unit = offset % su
            setno = offset // per_set
            unit_in_set = unit % (sc * units_per_obj)
            obj_in_set = unit_in_set % sc
            row = unit_in_set // sc  # unit row within the object
            objectno = setno * sc + obj_in_set
            obj_off = row * su + in_unit
            span = min(su - in_unit, end - offset)
            out.append((objectno, obj_off, span))
            offset += span
        return out

    # -- API (libradosstriper surface) -------------------------------------

    async def write(self, soid: str, data: bytes,
                    offset: int = 0) -> None:
        cookie = await self._lock(soid)
        try:
            await self._write_locked(soid, data, offset)
        finally:
            await self._unlock(soid, cookie)

    async def _write_locked(self, soid: str, data: bytes,
                            offset: int) -> None:
        layout_size = offset + len(data)
        try:
            cur = await self._layout(soid)
        except ObjectNotFound:
            cur = None  # fresh stream
        # any OTHER error propagates: treating a transient read
        # failure as "fresh" would rewrite the stored size downward
        # (silent truncation)
        max_size = layout_size
        if cur is not None:
            if (cur["stripe_unit"], cur["stripe_count"],
                    cur["object_size"]) != (self.stripe_unit,
                                            self.stripe_count,
                                            self.object_size):
                raise RadosError(-22, "layout mismatch with existing"
                                      " striped object")
            layout_size = max(cur["size"], layout_size)
            max_size = max(cur.get("max_size", cur["size"]),
                           layout_size)
        jobs = []
        pos = 0
        for objectno, obj_off, span in self._extents(offset, len(data)):
            chunk = data[pos:pos + span]
            pos += span
            jobs.append(self.ioctx.write(self._obj(soid, objectno),
                                         chunk, obj_off))
        if jobs:
            await asyncio.gather(*jobs)
        await self._save_layout(soid, layout_size, max_size)

    async def write_full(self, soid: str, data: bytes) -> None:
        try:
            await self.remove(soid)
        except ObjectNotFound:
            pass
        await self.write(soid, data, 0)

    async def append(self, soid: str, data: bytes) -> None:
        """size read + write UNDER ONE LOCK: two appends that both read
        size S would otherwise write the same extents, silently
        overwriting each other."""
        await self._layout(soid)  # exist-check BEFORE locking (below)
        cookie = await self._lock(soid)
        try:
            size = (await self._layout_or_cleanup(soid))["size"]
            await self._write_locked(soid, data, size)
        finally:
            await self._unlock(soid, cookie)

    async def _layout_or_cleanup(self, soid: str) -> Dict[str, Any]:
        """Layout read INSIDE the op lock.  If the stream vanished
        between the pre-lock exist-check and here (a concurrent
        remove), our lock exec has re-created object 0 as a bare
        lock holder — delete it before failing, or every such race
        leaks a phantom object (we hold the lock, so the delete
        cannot race another writer)."""
        try:
            return await self._layout(soid)
        except ObjectNotFound:
            try:
                await self.ioctx.remove(self._obj(soid, 0))
            except Exception:
                pass
            raise

    async def read(self, soid: str, offset: int = 0,
                   length: int = 0) -> bytes:
        layout = await self._layout(soid)
        size = layout["size"]
        if offset >= size:
            return b""
        if length == 0 or offset + length > size:
            length = size - offset

        async def one(objectno: int, obj_off: int, span: int) -> bytes:
            try:
                buf = await self.ioctx.read(
                    self._obj(soid, objectno), obj_off, span)
            except ObjectNotFound:
                return bytes(span)   # sparse
            if len(buf) < span:
                buf += bytes(span - len(buf))
            return buf

        parts = await asyncio.gather(
            *(one(*ext)
              for ext in self._extents(offset, length, layout)))
        return b"".join(parts)

    async def size(self, soid: str) -> int:
        return (await self._layout(soid))["size"]

    async def stat(self, soid: str) -> Dict[str, Any]:
        return dict(await self._layout(soid))

    async def remove(self, soid: str) -> None:
        # under the op lock like every other layout RMW: an unlocked
        # remove racing an append could delete extents the append is
        # writing and then be resurrected by its _save_layout.
        # Existence is checked BEFORE locking: the lock exec would
        # CREATE object 0 (a WR exec creates), so probing a missing
        # soid would otherwise litter the pool with lock-only orphans
        await self._layout(soid)
        cookie = await self._lock(soid)
        try:
            await self._remove_locked(soid)
        finally:
            await self._unlock(soid, cookie)

    async def _remove_locked(self, soid: str) -> None:
        layout = await self._layout_or_cleanup(soid)
        per_set = layout["object_size"] * layout["stripe_count"]
        # walk the HIGH-WATER extent: a truncate only zeroes/removes
        # data objects, so objects past the current size may exist
        hw = max(layout["size"], layout.get("max_size", layout["size"]))
        nsets = max(1, -(-hw // per_set))
        nobjs = nsets * layout["stripe_count"]

        async def rm(objectno: int) -> None:
            try:
                await self.ioctx.remove(self._obj(soid, objectno))
            except ObjectNotFound:
                pass

        # shadows concurrently; the layout holder (object 0) LAST so a
        # crashed remove leaves the stream reopenable, never orphaned
        if nobjs > 1:
            await asyncio.gather(*(rm(i) for i in range(1, nobjs)))
        await rm(0)

    async def truncate(self, soid: str, size: int) -> None:
        await self._layout(soid)  # exist-check BEFORE locking (remove())
        cookie = await self._lock(soid)
        try:
            layout = await self._layout_or_cleanup(soid)
            hw = max(layout["size"],
                     layout.get("max_size", layout["size"]))
            if size > layout["size"]:
                await self._save_layout(soid, size, max(hw, size))
                return
            su = layout["stripe_unit"]
            sc = layout["stripe_count"]
            per_set = layout["object_size"] * sc
            nsets = max(1, -(-hw // per_set))
            # objects whose FIRST stored byte is past the new end hold
            # no live data: actually remove them (the reference
            # truncates/deletes backing objects, RadosStriperImpl.cc
            # truncate) — zeroing alone would orphan space
            removed = set()
            for objectno in range(nsets * sc):
                if objectno == 0:
                    continue  # layout holder stays
                first = ((objectno // sc) * per_set
                         + (objectno % sc) * su)
                if first >= size:
                    removed.add(objectno)
                    try:
                        await self.ioctx.remove(
                            self._obj(soid, objectno))
                    except ObjectNotFound:
                        pass
            # zero the dropped range (up to the high-water mark) on
            # the objects that survive
            for objectno, obj_off, span in self._extents(
                    size, hw - size, layout):
                if objectno in removed:
                    continue
                try:
                    await self.ioctx.write(self._obj(soid, objectno),
                                           bytes(span), obj_off)
                except ObjectNotFound:
                    pass
            await self._save_layout(soid, size, size)
        finally:
            await self._unlock(soid, cookie)
