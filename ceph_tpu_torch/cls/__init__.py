"""cls role: object classes (server-side stored procedures)
(port of ceph_tpu/cls/__init__.py).

Reference parity: the ClassHandler + cls SDK
(Ceph's src/osd/ClassHandler.h, src/objclass/objclass.h, and
the classes under src/cls/).  A client `exec` op names (class, method,
input); the primary runs the registered handler ATOMICALLY under the
object lock, giving it read/write access to the object through the
same op engine ops a client would use — so class writes are logged,
replicated, and recovered like any other write.

The reference loads .so plugins; here classes are python callables in
a registry (the plugin_registry pattern used by EC/compressor), and
the in-tree classes mirror the reference's most-used ones:

- hello    (src/cls/hello/cls_hello.cc — the SDK demo)
- lock     (src/cls/lock/ — advisory exclusive/shared object locks)
- numops   (src/cls/numops/ — atomic arithmetic on stored values)

Method flags mirror CLS_METHOD_RD/CLS_METHOD_WR: a method registered
RD-only is refused write access, and calling a WR method sends the
op down the write path (version bump) like the reference does.
"""

from __future__ import annotations

import json
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

RD = 1   # CLS_METHOD_RD
WR = 2   # CLS_METHOD_WR


def as_text(data, encoding: str = "utf-8") -> str:
    """Decode a method payload (bytes OR a zero-copy wire/store view)
    to text without materializing an intermediate bytes object —
    str(buffer, encoding) reads any buffer directly.  The cls-SDK
    twin of common/buffer.as_buffer for the JSON-argument idiom."""
    if isinstance(data, str):
        return data
    return str(data, encoding)

ENOENT = -2
EINVAL = -22
EPERM = -1
EBUSY = -16
ENOATTR = -61


class ClsError(Exception):
    """Raised by class methods to return an error rc to the client."""

    def __init__(self, rc: int, what: str = ""):
        super().__init__(f"rc={rc} {what}")
        self.rc = rc


class MethodContext:
    """The objclass.h surface handed to a running method: object I/O
    routed through the hosting OSD's op engine (cls_cxx_read,
    cls_cxx_write_full, cls_cxx_getxattr, cls_cxx_map_* roles).
    Write access requires the method's WR flag.

    Snapshots are not ported (ROADMAP A7): a method never runs under a
    write snap context, so the writes carry none."""

    def __init__(self, daemon, state, pool, oid: str,
                 admit_epoch: int, flags: int):
        self._d = daemon
        self._state = state
        self._pool = pool
        self.oid = oid
        self._admit_epoch = admit_epoch
        self._flags = flags

    def _need_wr(self) -> None:
        if not self._flags & WR:
            raise ClsError(EPERM, "method not registered WR")

    # -- reads -------------------------------------------------------------

    async def read(self, offset: int = 0, length: int = 0):
        """Object bytes as a ZERO-COPY readonly view of the read
        path's buffer (frozen decode output / store buffer / frame
        view): RD-only methods that only slice or compare never pay a
        whole-object copy.  Methods that genuinely need to own the
        payload (caching it across awaits, returning it to the wire
        after a subsequent write) take bytes() themselves; JSON
        parsing goes through `cls.as_text`."""
        from ceph_tpu_torch.common.buffer import as_buffer

        rc, data = await self._d._op_read(self._state, self._pool,
                                          self.oid, offset, length)
        if rc != 0:
            raise ClsError(rc, "read")
        buf = as_buffer(data)
        if isinstance(buf, bytes):
            return buf
        view = buf if isinstance(buf, memoryview) else memoryview(buf)
        return view.toreadonly()

    async def stat(self) -> Dict[str, Any]:
        rc, out = await self._d._op_stat(self._state, self._pool,
                                         self.oid)
        if rc != 0:
            raise ClsError(rc, "stat")
        return out

    async def getxattr(self, name: str) -> bytes:
        rc, data = await self._d._op_getxattr(self._state, self._pool,
                                              self.oid, name)
        if rc != 0:
            raise ClsError(rc, f"getxattr {name!r}")
        return data

    async def omap_get(self) -> Dict[str, bytes]:
        from ceph_tpu_torch.msg.messages import decode_kv_map

        rc, data = await self._d._op_omap_get(self._state, self._pool,
                                              self.oid)
        if rc != 0:
            raise ClsError(rc, "omap_get")
        return decode_kv_map(data) if data else {}

    # -- writes (flags-gated) ----------------------------------------------

    async def write_full(self, data: bytes) -> None:
        self._need_wr()
        rc, _out = await self._d._op_write_full(
            self._state, self._pool, self.oid, data,
            self._admit_epoch)
        if rc != 0:
            raise ClsError(rc, "write_full")

    async def write(self, offset: int, data: bytes) -> None:
        self._need_wr()
        rc = await self._d._op_write(
            self._state, self._pool, self.oid, offset, data,
            self._admit_epoch)
        if rc != 0:
            raise ClsError(rc, "write")

    async def setxattr(self, name: str, value: Optional[bytes]) -> None:
        self._need_wr()
        rc = await self._d._op_setxattr(
            self._state, self._pool, self.oid, name, value,
            self._admit_epoch)
        if rc != 0:
            raise ClsError(rc, f"setxattr {name!r}")

    async def omap_set(self, kv: Dict[str, bytes]) -> None:
        from ceph_tpu_torch.msg.messages import encode_kv_map

        self._need_wr()
        rc = await self._d._op_omap_write(
            self._state, self._pool, self.oid, "omap_set",
            encode_kv_map(kv), self._admit_epoch)
        if rc != 0:
            raise ClsError(rc, "omap_set")

    async def omap_rm_keys(self, keys) -> None:
        from ceph_tpu_torch.msg.messages import encode_str_list

        self._need_wr()
        rc = await self._d._op_omap_write(
            self._state, self._pool, self.oid, "omap_rm",
            encode_str_list(list(keys)), self._admit_epoch)
        if rc != 0:
            raise ClsError(rc, "omap_rm_keys")

    async def remove(self) -> None:
        self._need_wr()
        rc = await self._d._op_remove(self._state, self._pool,
                                      self.oid, self._admit_epoch)
        if rc != 0:
            raise ClsError(rc, "remove")


Method = Callable[[MethodContext, bytes], Awaitable[bytes]]


class ClassHandler:
    """cls registry: (class, method) -> (handler, flags)."""

    def __init__(self):
        self._methods: Dict[Tuple[str, str], Tuple[Method, int]] = {}

    def register(self, cls: str, method: str, flags: int,
                 fn: Method) -> None:
        self._methods[(cls, method)] = (fn, flags)

    def method(self, cls: str, method: str, flags: int):
        def deco(fn: Method) -> Method:
            self.register(cls, method, flags, fn)
            return fn
        return deco

    def lookup(self, cls: str, method: str
               ) -> Optional[Tuple[Method, int]]:
        return self._methods.get((cls, method))

    def list_classes(self) -> Dict[str, list]:
        out: Dict[str, list] = {}
        for (cls, method) in sorted(self._methods):
            out.setdefault(cls, []).append(method)
        return out


def default_handler() -> ClassHandler:
    """The in-tree classes, registered (ClassHandler::open_all role)."""
    from ceph_tpu_torch.cls import dir as dir_cls
    from ceph_tpu_torch.cls import hello, journal, lock, numops

    handler = ClassHandler()
    dir_cls.register(handler)
    hello.register(handler)
    journal.register(handler)
    lock.register(handler)
    numops.register(handler)
    return handler
