"""Op targets the open-loop runner can drive (port of
ceph_tpu/loadgen/targets.py).

One async interface, three substrates:

- EmbeddedTarget: the in-process `rados/embedded.py` LocalCluster —
  the whole storage slice with no wire, the shape the smoke tier and
  the bench knee-sweep use.
- RadosTarget: the networked `rados/client.py` IoCtx — ops carry the
  tenant identity in MOSDOp v4, so the OSD-side mClock tenant classes
  and the admission gate see exactly who is asking.
- S3Target: raw HTTP/1.1 + sigv4 against `rgw/s3_frontend.py` (the
  stock-client shape; the gateway maps the authenticated access key
  to the rados tenant).

`op()` returns payload bytes moved; a QoS shed (EBUSY from the
admission gate / a full scheduler queue, or S3 503) raises SheddedOp
so the runner accounts it as shed, not error.
"""

from __future__ import annotations

import asyncio
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

EBUSY = -16


class SheddedOp(Exception):
    """The service refused the op under QoS pressure (not a failure:
    the admission gate doing its job)."""


class Target:
    async def setup(self, objects: int, object_size: int) -> None:
        raise NotImplementedError

    async def op(self, tenant: str, kind: str, obj: int,
                 size: int) -> int:
        raise NotImplementedError

    async def close(self) -> None:
        pass


def _payload(size: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


@functools.lru_cache(maxsize=64)
def _write_payload(size: int, slot: int) -> bytes:
    """Write payloads memoized by (size, slot): writers address only
    `obj & 7` slots, and regenerating an rng + size bytes per op
    would bill generator overhead as service latency (open-loop
    latency is measured from scheduled arrival)."""
    return _payload(size, seed=slot + 2)


# -- coded inference serving (the `infer` blend op) -----------------------

#: the one shared model every infer op scores against (stored lazily
#: on the first infer op, so blends without `infer` pay nothing)
INFER_MODEL = "lg-model"
INFER_DIM = 32
INFER_OUT = 48


@functools.lru_cache(maxsize=256)
def _infer_queries(nq: int, slot: int) -> np.ndarray:
    """Deterministic query batches memoized by (batch, object slot) —
    same rationale as _write_payload: the generator must not bill
    query synthesis as service latency."""
    return np.random.default_rng(0xC0DE ^ slot).standard_normal(
        (nq, INFER_DIM)).astype(np.float32)


def _infer_blobs():
    """(spec, blobs) for the shared loadgen model with a fixed
    host-side layout — the read-then-infer substrate for targets
    whose pool has no coded serving layout (replicated pools, the
    embedded slice)."""
    from ceph_tpu_torch.inference import registry

    return registry.build(
        INFER_MODEL, "linear",
        registry.make_model("linear", INFER_DIM, INFER_OUT, seed=7),
        k=2, m=1, chunk=1024)


class EmbeddedTarget(Target):
    """Drives an embedded LocalCluster IoCtx (synchronous calls; the
    embedded slice has no event loop of its own to starve)."""

    def __init__(self, io) -> None:
        self.io = io
        self._objects = 0
        self._infer_spec = None

    async def setup(self, objects: int, object_size: int) -> None:
        data = _payload(object_size, seed=1)
        for i in range(objects):
            self.io.write_full(f"lg-{i}", data)
        self._objects = objects

    def _infer(self, obj: int, nq: int) -> int:
        """The embedded slice has no compute wire, so infer ops take
        the read-then-infer shape (the CEPH_TPU_INFERENCE=0 path):
        read the params object, host exact forward, credit the score
        bytes.  The model is stored lazily on the first infer op."""
        from ceph_tpu_torch.inference import model as inf_model
        from ceph_tpu_torch.inference import registry as inf_registry

        if self._infer_spec is None:
            spec, blobs = _infer_blobs()
            for oid, blob in blobs.items():
                self.io.write_full(oid, blob)
            self._infer_spec = spec
        spec = self._infer_spec
        data = self.io.read(inf_registry.params_oid(INFER_MODEL))
        scores = inf_model.exact_forward(
            spec, data, _infer_queries(max(nq, 1), obj & 7))
        return scores.nbytes

    async def op(self, tenant: str, kind: str, obj: int,
                 size: int) -> int:
        io = self.io
        name = f"lg-{obj % max(self._objects, 1)}"
        if kind == "read":
            return len(io.read(name))
        if kind == "ranged":
            return len(io.read(name, offset=size // 4,
                               length=max(size // 4, 1)))
        if kind == "stat":
            io.stat(name)
            return 0
        if kind == "infer":
            return self._infer(obj, size)
        # write: per-tenant namespace so writers never collide with
        # the shared read set
        io.write_full(f"lg-w-{tenant}-{obj & 7}",
                      _write_payload(size, obj & 7))
        return size


class RadosTarget(Target):
    """Drives a networked RadosClient IoCtx with the tenant identity
    threaded per op (MOSDOp v4)."""

    def __init__(self, io) -> None:
        self.io = io
        self._objects = 0
        self._infer_spec = None
        self._infer_via_read = False
        self._infer_lock = asyncio.Lock()

    async def setup(self, objects: int, object_size: int) -> None:
        data = _payload(object_size, seed=1)
        await asyncio.gather(*(self.io.write_full(f"lg-{i}", data)
                               for i in range(objects)))
        self._objects = objects

    async def _infer_model(self):
        """Lazily store the shared model: through the coded layout
        (store_model) when the pool is EC — infer ops then ride the
        MOSDCompute serving path — else as raw objects served by the
        client-side read-then-infer shape."""
        from ceph_tpu_torch.rados.client import RadosError

        async with self._infer_lock:
            if self._infer_spec is None:
                from ceph_tpu_torch.inference import registry
                try:
                    self._infer_spec = await self.io.store_model(
                        INFER_MODEL, "linear",
                        registry.make_model("linear", INFER_DIM,
                                            INFER_OUT, seed=7))
                except RadosError:
                    spec, blobs = _infer_blobs()
                    for oid, blob in blobs.items():
                        await self.io.write_full(oid, blob)
                    self._infer_spec = spec
                    self._infer_via_read = True
        return self._infer_spec

    async def _infer(self, obj: int, nq: int) -> int:
        from ceph_tpu_torch.inference import model as inf_model
        from ceph_tpu_torch.inference import registry as inf_registry

        spec = self._infer_spec or await self._infer_model()
        queries = _infer_queries(max(nq, 1), obj & 7)
        if self._infer_via_read:
            data = await self.io.read(
                inf_registry.params_oid(INFER_MODEL))
            return inf_model.exact_forward(spec, data, queries).nbytes
        res = await self.io.infer(spec, queries)
        return res["scores"].nbytes

    async def op(self, tenant: str, kind: str, obj: int,
                 size: int) -> int:
        from ceph_tpu_torch.rados.client import RadosError, tenant_scope

        io = self.io
        name = f"lg-{obj % max(self._objects, 1)}"
        try:
            with tenant_scope(tenant):
                if kind == "read":
                    return len(await io.read(name))
                if kind == "ranged":
                    return len(await io.read(
                        name, offset=size // 4,
                        length=max(size // 4, 1)))
                if kind == "stat":
                    await io.stat(name)
                    return 0
                if kind == "infer":
                    return await self._infer(obj, size)
                await io.write_full(f"lg-w-{tenant}-{obj & 7}",
                                    _write_payload(size, obj & 7))
                return size
        except RadosError as e:
            if e.rc == EBUSY:
                raise SheddedOp(tenant) from e
            raise


class S3Target(Target):
    """Raw-socket S3 client (sigv4 per request, the MiniS3 shape from
    the http test tier) with a small connection pool — open-loop
    concurrency must not serialize on one socket."""

    def __init__(self, addr: str, access: str, secret: str,
                 bucket: str = "loadgen", pool: int = 16) -> None:
        host, _, port = addr.rpartition(":")
        self.host, self.port = host, int(port)
        self.access, self.secret = access, secret
        self.bucket = bucket
        self._free: List[Tuple[asyncio.StreamReader,
                               asyncio.StreamWriter]] = []
        self._pool_cap = pool
        self._objects = 0

    async def _request(self, method: str, path: str,
                       headers: Optional[Dict[str, str]] = None,
                       body: bytes = b"") -> Tuple[int, bytes]:
        # one retry on a fresh connection: a pooled keep-alive socket
        # the server closed since its last use answers with EOF
        for attempt in (0, 1):
            pooled = bool(self._free) and attempt == 0
            try:
                return await self._request_once(method, path,
                                                headers, body,
                                                use_pool=pooled)
            except (ConnectionError, OSError,
                    asyncio.IncompleteReadError):
                if attempt or not pooled:
                    raise
        raise AssertionError("unreachable")

    async def _request_once(self, method: str, path: str,
                            headers: Optional[Dict[str, str]],
                            body: bytes,
                            use_pool: bool) -> Tuple[int, bytes]:
        from ceph_tpu_torch.rgw.s3_frontend import sign_request

        if use_pool and self._free:
            reader, writer = self._free.pop()
        else:
            reader, writer = await asyncio.open_connection(
                self.host, self.port, limit=8 << 20)
        try:
            hdrs = {"Host": f"{self.host}:{self.port}",
                    **(headers or {})}
            hdrs = sign_request(method, path, {}, hdrs, body,
                                self.access, self.secret)
            hdrs["Content-Length"] = str(len(body))
            req = [f"{method} {path} HTTP/1.1\r\n"]
            for k, v in hdrs.items():
                req.append(f"{k}: {v}\r\n")
            req.append("\r\n")
            writer.write("".join(req).encode() + body)
            await writer.drain()
            status_line = await reader.readline()
            if not status_line.strip():
                # EOF: the peer closed this (stale pooled) connection
                raise ConnectionError("connection closed by peer")
            status = int(status_line.split()[1])
            rhdrs: Dict[str, str] = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                rhdrs[k.strip().lower()] = v.strip()
            length = int(rhdrs.get("content-length", "0"))
            # HEAD replies carry Content-Length but NO body bytes
            rbody = await reader.readexactly(length) \
                if length and method != "HEAD" else b""
            if len(self._free) < self._pool_cap and \
                    rhdrs.get("connection", "").lower() != "close":
                self._free.append((reader, writer))
            else:
                writer.close()
            return status, rbody
        except BaseException:
            writer.close()
            raise

    def _key(self, obj: int) -> str:
        return f"/{self.bucket}/lg-{obj % max(self._objects, 1)}"

    async def setup(self, objects: int, object_size: int) -> None:
        status, _ = await self._request("PUT", f"/{self.bucket}")
        if status not in (200, 409):
            raise RuntimeError(f"bucket create failed: {status}")
        data = _payload(object_size, seed=1)
        for i in range(objects):
            status, _ = await self._request(
                "PUT", f"/{self.bucket}/lg-{i}", body=data)
            if status != 200:
                raise RuntimeError(f"prefill failed: {status}")
        self._objects = objects

    async def op(self, tenant: str, kind: str, obj: int,
                 size: int) -> int:
        if kind == "infer":
            # no S3 verb maps to coded scoring; misconfigured blends
            # must surface, not silently count as writes
            raise RuntimeError("s3 target does not serve infer ops")
        if kind == "read":
            status, body = await self._request("GET", self._key(obj))
        elif kind == "ranged":
            lo = size // 4
            hi = lo + max(size // 4, 1) - 1
            status, body = await self._request(
                "GET", self._key(obj),
                headers={"Range": f"bytes={lo}-{hi}"})
        elif kind == "stat":
            status, body = await self._request("HEAD", self._key(obj))
            body = b""
        else:
            body = b""
            status, _ = await self._request(
                "PUT", f"/{self.bucket}/lg-w-{tenant}-{obj & 7}",
                body=_payload(size, obj))
        if status == 503:
            raise SheddedOp(tenant)
        if status not in (200, 206):
            raise RuntimeError(f"s3 {kind} -> {status}")
        return len(body) if kind != "write" else size

    async def close(self) -> None:
        for _r, w in self._free:
            try:
                w.close()
            except Exception:
                pass
        self._free.clear()
