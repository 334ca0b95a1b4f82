"""CephFS client role: POSIX-shaped filesystem over the cluster (port of
ceph_tpu/cephfs/__init__.py).

Reference parity: libcephfs / the kernel client
(Ceph's src/libcephfs.cc, src/client/Client.cc): metadata ops
go to the MDS (MClientRequest), file DATA reads/writes go straight to
the OSDs as striped objects (Client::_read/_write via the Objecter,
filer/striper layout).  The MDS address is discovered from the
mds_lock object in the metadata pool (the MDSMap role).

CLIENT CAPS (Client.cc caps + mds/Locker.cc): metadata replies can
GRANT a capability on the inode ("r": cache attrs and serve stat/read
locally; "rw": additionally buffer dirty size/mtime and flush on
close/recall) — so a hot stat/read loop costs ZERO MDS round trips.
Coherence is recall-based: when another client's access conflicts, the
MDS sends MClientCaps revoke; this client folds its dirty attrs into
the ack and drops the cached entries.  Caps die with the MDS
connection (failover = start capless) and carry a TTL as a belt
against partitions where the recall cannot reach us.

File layout: fixed-block striping `fsdata.<ino:x>.<blockno:016x>` in
the data pool (file_layout_t object_size, default 4 MiB), sparse like
the reference (absent blocks read as zeros).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional, Set

from ceph_tpu_torch.mds import (
    ADDR_ATTR,
    MDSMAP_OBJ,
    data_obj,
    owner_rank,
    rank_lock_obj,
)
from ceph_tpu_torch.msg.messages import MClientCaps, MClientRequest
from ceph_tpu_torch.rados.client import (
    IoCtx,
    ObjectNotFound,
    RadosClient,
    RadosError,
)

log = logging.getLogger("cephfs")

ENOENT = -2
ESTALE = -116
EROFS = -30


class CephFSError(Exception):
    def __init__(self, rc: int, what: str = ""):
        super().__init__(f"rc={rc} {what}")
        self.rc = rc


class CephFS:
    """Mounted filesystem handle (libcephfs ceph_mount role)."""

    def __init__(self, client: RadosClient, metadata_pool: str,
                 data_pool: str, caps_ttl: float = 60.0):
        self.client = client
        self.meta = client.open_ioctx(metadata_pool)
        self.data = client.open_ioctx(data_pool)
        self._tid = 0
        # one address per MDS RANK (multi-active subtree partitioning;
        # rank layout discovered from the mds_map object)
        self._mds_addrs: Dict[int, str] = {}
        self._num_ranks: Optional[int] = None
        # -- caps state (Client.cc cap cache) ------------------------------
        self.caps_ttl = caps_ttl
        self._caps: Dict[int, str] = {}            # ino -> "r"|"rw"
        self._cap_expiry: Dict[int, float] = {}    # ino -> monotonic
        # the Connection each cap was granted on: a silent reconnect
        # makes a NEW conn at the same addr, and the MDS evicted our
        # caps when the old one died — identity, not liveness, is the
        # validity test
        self._cap_conn: Dict[int, Any] = {}
        self._attr_cache: Dict[str, dict] = {}     # path -> inode
        self._ino_paths: Dict[int, Set[str]] = {}  # reverse index
        # ino -> buffered dirty attrs awaiting flush (rw caps only)
        self._dirty: Dict[int, Dict[str, Any]] = {}
        # snapid -> data-pool IoCtx reading at that snapshot
        self._snap_ios: Dict[int, IoCtx] = {}
        # snap-context version (regression guard): a reply from an MDS
        # rank that missed the snap fan-out must not downgrade a
        # fresher context another rank already gave us
        self._snapc_ver = 0
        # observability (tests assert the zero-round-trip property)
        self.mds_requests = 0
        # requests sent again after a send whose reply did not come
        # (the first send may have taken effect: ROADMAP C14)
        self.mds_resends = 0
        self.cap_hits = 0
        # route cap recalls arriving on the shared rados messenger
        client.fs_caps_handler = self._handle_caps

    # -- caps cache (Client.cc insert_trace / handle_caps roles) -----------

    # bound on cached caps (the mds_max_caps_per_client role): a tree
    # walk over millions of files must not grow the mount's memory
    # forever — past the bound the soonest-expiring quarter is shed
    max_caps = 4096

    def _record_cap(self, path: str, inode: dict, cap: str,
                    conn: Any = None) -> None:
        """conn: the connection the reply that granted this cap rode in
        on (stamped into the reply by _request).  It must NOT be read
        from shared mutable state: a concurrent request can reconnect
        and rebind such state while this reply is in flight, and the
        cap would then pass the conn-identity check against a session
        the MDS never granted it on."""
        if not cap or not isinstance(inode, dict) or conn is None:
            return
        ino = inode["ino"]
        if ino not in self._caps and len(self._caps) >= self.max_caps:
            self._trim_caps()
        self._caps[ino] = cap
        self._cap_expiry[ino] = time.monotonic() + self.caps_ttl
        self._cap_conn[ino] = conn
        self._attr_cache[path] = inode
        self._ino_paths.setdefault(ino, set()).add(path)

    def _trim_caps(self) -> None:
        victims = sorted(self._cap_expiry,
                         key=self._cap_expiry.get)[:self.max_caps // 4]
        for ino in victims:
            if ino in self._dirty:
                continue  # never shed unflushed state
            # voluntary release goes to the conn the cap was granted
            # on (its rank's session)
            conn = self._cap_conn.get(ino)
            self._drop_ino(ino)
            if conn is not None and not conn.closed:
                # best-effort voluntary return so the MDS table shrinks
                # too and later writers skip a recall round trip
                try:
                    self.client.msgr._spawn(conn.send(
                        MClientCaps("release", ino)))
                except Exception:
                    pass

    def _drop_ino(self, ino: int) -> None:
        self._caps.pop(ino, None)
        self._cap_expiry.pop(ino, None)
        self._cap_conn.pop(ino, None)
        for path in self._ino_paths.pop(ino, set()):
            self._attr_cache.pop(path, None)

    def _drop_all_caps(self) -> None:
        self._caps.clear()
        self._cap_expiry.clear()
        self._cap_conn.clear()
        self._attr_cache.clear()
        self._ino_paths.clear()
        # dirty sizes survive — close()/flush() re-sends them through
        # the ordinary setattr path, which retries across failover

    def _cap_valid(self, ino: int) -> bool:
        """A cap is usable only while its TTL holds AND the connection
        it was granted on is alive — a dead conn means the MDS has
        already evicted us (or a new MDS knows nothing of us)."""
        if ino not in self._caps:
            return False
        if time.monotonic() > self._cap_expiry.get(ino, 0.0):
            self._drop_ino(ino)
            return False
        granted_on = self._cap_conn.get(ino)
        if granted_on is None or granted_on.closed or \
                self.client.msgr._conns.get(
                    granted_on.peer_addr) is not granted_on:
            # the granting connection is gone (or a reconnect minted a
            # new one): that MDS evicted us with it, so every cached
            # answer granted on it is suspect (other ranks' sessions
            # are independent and keep their caps)
            self._drop_conn_caps(granted_on)
            return False
        return True

    def _drop_conn_caps(self, conn) -> None:
        for ino in [i for i, c in self._cap_conn.items()
                    if c is conn or c is None]:
            self._drop_ino(ino)

    def _drop_addr_caps(self, addr: str) -> None:
        """Failover hygiene: a rank's address was re-discovered, so
        anything granted over connections to the OLD address came from
        a possibly-fenced incarnation — even if that conn is still
        open (a hung-but-connected deposed active must not keep
        serving stale cached attrs until TTL)."""
        for ino in [i for i, c in self._cap_conn.items()
                    if c is None or getattr(c, "peer_addr", None)
                    == addr]:
            self._drop_ino(ino)

    def _cached_inode(self, path: str) -> Optional[dict]:
        inode = self._attr_cache.get(path)
        if inode is not None and self._cap_valid(inode["ino"]):
            self.cap_hits += 1
            return inode
        return None

    async def _handle_caps(self, conn, msg: MClientCaps) -> None:
        """MDS-initiated recall: fold dirty attrs into the ack, drop
        the cache.  op=evict (MDS stepping down) drops everything, no
        ack expected."""
        if msg.op == "evict":
            self._drop_all_caps()
            return
        if msg.op != "revoke":
            return
        snapc = msg.attrs.get("snapc")
        if snapc is not None:
            # a recall after mksnap carries the fresh snap context —
            # arm it NOW so our next write clones, even with no
            # further MDS round trip
            self._apply_snapc(snapc)
        # the ack carries our dirty attrs INCLUDING the path: recalls
        # driven by a directory rename persist bystander flushes by
        # path while those paths still resolve
        attrs = self._dirty.pop(msg.ino, {})
        self._drop_ino(msg.ino)
        try:
            await conn.send(MClientCaps("ack", msg.ino, tid=msg.tid,
                                        attrs=attrs))
        except (ConnectionError, OSError):
            # conn died mid-ack: the MDS evicts us on timeout/fault,
            # but the buffered attrs never reached it — restore them
            # so close()/flush() re-sends through the ordinary path.
            # MERGE, never setdefault: a concurrent write during the
            # send may have re-dirtied the ino with a SMALLER size_max,
            # and dropping the older high-water mark would let the
            # eventual flush truncate acknowledged data
            if attrs:
                d = self._dirty.get(msg.ino)
                if d is None:
                    self._dirty[msg.ino] = attrs
                else:
                    d["size_max"] = max(
                        int(d.get("size_max", 0)),
                        int(attrs.get("size_max", 0)))
                    if d.get("mtime") is None and \
                            attrs.get("mtime") is not None:
                        d["mtime"] = attrs["mtime"]

    def _note_dirty(self, ino: int, path: str, size: int,
                    mtime: float) -> None:
        d = self._dirty.setdefault(ino, {"size_max": 0})
        d["size_max"] = max(int(d.get("size_max", 0)), size)
        d["mtime"] = mtime
        d["path"] = path

    async def _flush_dirty_path(self, path: str) -> None:
        """Flush any buffered attrs recorded FOR this path — keyed on
        the dirty table itself, not the attr cache, so a failover
        (which clears the cache but keeps dirty records) cannot skip
        the flush."""
        for ino, d in list(self._dirty.items()):
            if d.get("path") == path:
                await self._flush_dirty(ino)

    async def _flush_dirty(self, ino: int) -> None:
        """Push buffered size/mtime to the MDS (cap flush): done on
        close/fsync; recall-time flushes ride the ack instead."""
        d = self._dirty.pop(ino, None)
        if d is None:
            return
        args = {"path": d["path"], "size_max": d["size_max"]}
        if d.get("mtime") is not None:
            args["mtime"] = d["mtime"]
        try:
            await self._request("setattr", args)
        except CephFSError:
            pass  # path raced away (unlink/rename revoked us already)

    # -- MDS session -------------------------------------------------------

    async def _num_mds_ranks(self) -> int:
        """Rank-layout discovery (MDSMap role): published by the
        active MDS; absent on a still-booting cluster — fall back to
        single-active until it appears."""
        if self._num_ranks is not None:
            return self._num_ranks
        try:
            import json as _json

            raw = await self.meta.read(MDSMAP_OBJ)
            self._num_ranks = int(_json.loads(
                raw.decode()).get("num_ranks", 1))
        except Exception:
            return 1
        return self._num_ranks

    def _rank_of(self, op: str, args: Dict[str, Any],
                 num_ranks: int) -> int:
        """The rank serving this op: same parent-directory rule the
        daemons enforce (owner_rank); rename routes to the SRC owner,
        which coordinates the dst rank itself."""
        path = args.get("path") or args.get("src") or "/"
        return owner_rank(path, num_ranks)

    async def _discover_mds(self, rank: int = 0) -> str:
        for _ in range(100):
            try:
                raw = await self.meta.getxattr(rank_lock_obj(rank),
                                               ADDR_ATTR)
                return raw.decode()
            except (ObjectNotFound, RadosError):
                await asyncio.sleep(0.1)
        raise CephFSError(
            ESTALE, f"no active MDS for rank {rank} published"
                    " an address")

    async def _request(self, op: str, args: Dict[str, Any]
                       ) -> Dict[str, Any]:
        """Send one metadata op to the owning rank; on ESTALE/timeout
        re-discover and resend (Client session reconnect role)."""
        last: Optional[BaseException] = None
        self.mds_requests += 1
        # EAGAIN (subtree mid-migration) has its OWN budget: the
        # freeze can legitimately last up to the MDS's 30s export TTL
        # plus peer timeouts, far beyond the connection-retry budget
        eagain_left = 150  # x0.3s ~ 45s
        attempt = 0
        while attempt < 30:
            attempt += 1
            rank = self._rank_of(op, args, await self._num_mds_ranks())
            if rank not in self._mds_addrs:
                self._mds_addrs[rank] = await self._discover_mds(rank)
                # fresh discovery: whatever this rank granted was from
                # a possibly-dead incarnation — conn-identity checks
                # in _cap_valid retire those caps lazily
            # ride the rados client's messenger + future table:
            # MClientReply resolves through its dispatcher like any
            # other tid-matched reply
            tid = self.client._next_tid()
            fut: asyncio.Future = \
                asyncio.get_running_loop().create_future()
            self.client._futures[tid] = fut
            sent = False
            try:
                conn = await self.client.msgr.connect(
                    self._mds_addrs[rank])
                await conn.send(MClientRequest(tid, op, args))
                sent = True
                reply = await asyncio.wait_for(fut, 10.0)
            except (ConnectionError, OSError,
                    asyncio.TimeoutError) as e:
                last = e
                self.mds_resends += sent
                old = self._mds_addrs.pop(rank, None)  # re-discover
                if old is not None:
                    self._drop_addr_caps(old)
                await asyncio.sleep(0.3)
                continue
            finally:
                self.client._futures.pop(tid, None)
            if reply.rc == ESTALE:
                # standby answered, or the rank layout changed under
                # us (misrouted): re-discover both
                old = self._mds_addrs.pop(rank, None)
                if old is not None:
                    self._drop_addr_caps(old)
                self._num_ranks = None
                await asyncio.sleep(0.3)
                continue
            if reply.rc == -11 and eagain_left > 0:
                # EAGAIN: subtree frozen (migrating) — wait it out
                # without burning the connection-retry budget
                eagain_left -= 1
                attempt -= 1
                last = CephFSError(-11, "subtree migrating")
                await asyncio.sleep(0.3)
                continue
            if reply.rc != 0:
                raise CephFSError(reply.rc,
                                  f"{op} {args.get('path', '')!r}"
                                  f" {reply.out.get('error', '')}")
            dsnapc = reply.out.pop("_dsnapc", None)
            if dsnapc is not None:
                # the MDS publishes the data-pool snap context on
                # every reply: our direct-to-OSD writes must COW
                # against every live CephFS snapshot
                self._apply_snapc(dsnapc)
            self._trace_reply(op, args, reply.out)
            # stamp the conn this reply rode in on: any cap in the
            # reply was granted on THAT session (see _record_cap)
            reply.out["_conn"] = conn
            return reply.out
        raise CephFSError(ESTALE, f"{op}: no MDS reachable ({last!r})")

    def _trace_reply(self, op: str, args: Dict[str, Any],
                     out: Dict[str, Any]) -> None:
        """Fold a mutation's reply back into OUR cap cache (the
        insert_trace role): the MDS only recalls OTHER clients'
        caps, so our own cached attrs would go stale without this."""
        if op == "setattr":
            inode = out.get("inode")
            if inode and args["path"] in self._attr_cache:
                self._attr_cache[args["path"]] = inode
        elif op in ("unlink", "rmdir"):
            self._drop_path(args["path"])
        elif op == "rename":
            self._drop_path(args["src"])
            self._drop_path(args["dst"])

    def _drop_path(self, path: str) -> None:
        inode = self._attr_cache.get(path)
        if inode is not None:
            self._drop_ino(inode["ino"])

    # -- namespace ops -----------------------------------------------------

    @staticmethod
    def _snap_mkdir_target(path: str):
        """'/a/b/.snap/s1' -> ('/a/b', 's1') — mkdir/rmdir inside a
        .snap pseudo-directory IS snapshot create/remove (the
        reference's mkdir-on-snapdir semantics)."""
        parts = [p for p in path.split("/") if p]
        if len(parts) >= 2 and parts[-2] == ".snap":
            return "/" + "/".join(parts[:-2]), parts[-1]
        return None

    async def mkdir(self, path: str, mode: int = 0o755) -> None:
        snap = self._snap_mkdir_target(path)
        if snap is not None:
            await self.mksnap(snap[0], snap[1])
            return
        await self._request("mkdir", {"path": path, "mode": mode})

    async def rmdir(self, path: str) -> None:
        snap = self._snap_mkdir_target(path)
        if snap is not None:
            await self.rmsnap(snap[0], snap[1])
            return
        await self._request("rmdir", {"path": path})

    # -- snapshots (.snap pseudo-directory surface) ------------------------

    async def mksnap(self, path: str, name: str) -> int:
        out = await self._request("mksnap",
                                  {"path": path, "name": name})
        return out.get("snapid", 0)

    async def rmsnap(self, path: str, name: str) -> None:
        await self._request("rmsnap", {"path": path, "name": name})

    async def lssnap(self, path: str) -> List[dict]:
        out = await self._request("lssnap", {"path": path})
        return out["snaps"]

    def _apply_snapc(self, v) -> None:
        """[ver, seq, snaps] from an MDS: apply unless it would
        REGRESS the version — a rank that missed the snap fan-out
        serves a stale context, and downgrading would make our next
        write skip COW for a live snapshot."""
        if v[0] >= self._snapc_ver:
            self._snapc_ver = v[0]
            self.data.set_snap_context(v[1], v[2])

    def _snap_data_io(self, snapid: int) -> IoCtx:
        """Data-pool IoCtx reading at a snapshot (cached; snapshots
        are immutable)."""
        io = self._snap_ios.get(snapid)
        if io is None:
            if len(self._snap_ios) >= 64:
                self._snap_ios.clear()  # bounded: rebuilt on demand
            io = IoCtx(self.client, self.data.pool_id)
            io.snap_set_read(snapid)
            self._snap_ios[snapid] = io
        return io

    async def listdir(self, path: str) -> List[str]:
        out = await self._request("readdir", {"path": path})
        return list(out["entries"])

    async def readdir(self, path: str) -> Dict[str, dict]:
        out = await self._request("readdir", {"path": path})
        return out["entries"]

    async def stat(self, path: str) -> dict:
        cached = self._cached_inode(path)
        if cached is not None:
            return dict(cached)   # zero MDS round trips
        out = await self._request("stat", {"path": path, "want": "r"})
        self._record_cap(path, out["inode"], out.get("cap", ""),
                         out.get("_conn"))
        return out["inode"]

    async def exists(self, path: str) -> bool:
        try:
            await self.stat(path)
            return True
        except CephFSError as e:
            if e.rc == ENOENT:
                return False
            raise

    async def symlink(self, target: str, path: str) -> None:
        await self._request("symlink", {"path": path, "target": target})

    async def readlink(self, path: str) -> str:
        out = await self._request("readlink", {"path": path})
        return out["target"]

    async def rename(self, src: str, dst: str) -> None:
        # our own dirty size must land while the dentry still exists
        # at src (the MDS folds FOREIGN writers via recall; ours is
        # local knowledge it cannot recall mid-request)
        await self._flush_dirty_path(src)
        await self._request("rename", {"src": src, "dst": dst})

    async def unlink(self, path: str) -> None:
        # flush our own buffered size first: the MDS purges by size
        await self._flush_dirty_path(path)
        out = await self._request("unlink", {"path": path})
        inode = out["inode"]
        # purge the file's data objects (the client-driven purge;
        # the reference queues this on the MDS PurgeQueue)
        bs = inode.get("block_size", 1 << 22)
        blocks = (inode.get("size", 0) + bs - 1) // bs
        await asyncio.gather(*(
            _ignore_enoent(self.data.remove(
                data_obj(inode["ino"], b)))
            for b in range(blocks)))

    async def truncate(self, path: str, size: int) -> None:
        if ".snap" in path.split("/"):
            # guard BEFORE touching data objects: the snap-aware stat
            # below would resolve to the live ino and the head purge
            # would destroy the live file before the MDS said EROFS
            raise CephFSError(EROFS, path)
        await self._flush_dirty_path(path)
        inode = await self.stat(path)
        if inode["type"] != "file":
            raise CephFSError(-21, path)  # EISDIR
        bs = inode.get("block_size", 1 << 22)
        if size < inode["size"]:
            first_dead = (size + bs - 1) // bs
            last = (inode["size"] + bs - 1) // bs
            await asyncio.gather(*(
                _ignore_enoent(self.data.remove(
                    data_obj(inode["ino"], b)))
                for b in range(first_dead, last)))
            if size % bs:
                await self.data.write(
                    data_obj(inode["ino"], size // bs),
                    bytes(bs - size % bs), size % bs)
        await self._request("setattr", {"path": path, "size": size})

    # -- file I/O ----------------------------------------------------------

    async def open(self, path: str, flags: str = "r",
                   mode: int = 0o644,
                   block_size: int = 1 << 22) -> "File":
        """block_size is the file_layout_t object_size: fixed at
        create time, ignored on existing files."""
        create = any(f in flags for f in "wax")
        writable = create or "+" in flags
        if ".snap" in path.split("/") and (create or writable):
            raise CephFSError(EROFS, path)
        want = "rw" if writable else "r"
        if create:
            out = await self._request(
                "create", {"path": path, "mode": mode,
                           "exclusive": "x" in flags,
                           "block_size": block_size, "want": want})
            inode = out["inode"]
            self._record_cap(path, inode, out.get("cap", ""),
                             out.get("_conn"))
            if "w" in flags and inode.get("size", 0) > 0:
                await self.truncate(path, 0)
                inode = await self.stat(path)
        else:
            cached = self._cached_inode(path)
            if cached is not None and not writable:
                inode = dict(cached)
            else:
                out = await self._request(
                    "stat", {"path": path, "want": want})
                inode = out["inode"]
                self._record_cap(path, inode, out.get("cap", ""),
                                 out.get("_conn"))
            if inode["type"] == "dir":
                raise CephFSError(-21, path)
        return File(self, path, inode, writable=writable)

    # convenience one-shots (qa-workunit style helpers)

    async def write_file(self, path: str, data: bytes) -> None:
        f = await self.open(path, "w")
        await f.write(0, data)
        await f.close()

    async def read_file(self, path: str) -> bytes:
        f = await self.open(path, "r")
        try:
            # read() revalidates and clamps to the CURRENT size
            return await f.read(0, 1 << 62)
        finally:
            await f.close()


async def _ignore_enoent(coro) -> None:
    try:
        await coro
    except ObjectNotFound:
        pass


class File:
    """An open file handle (Fh role): offset I/O over striped data
    objects, size flushed to the MDS on write/close."""

    def __init__(self, fs: CephFS, path: str, inode: dict,
                 writable: bool):
        self.fs = fs
        self.path = path
        self.inode = inode
        self.writable = writable
        self._max_written = inode.get("size", 0)

    @property
    def block_size(self) -> int:
        return self.inode.get("block_size", 1 << 22)

    def _extents(self, offset: int, length: int):
        out = []
        end = offset + length
        while offset < end:
            blockno = offset // self.block_size
            in_off = offset % self.block_size
            span = min(self.block_size - in_off, end - offset)
            out.append((blockno, in_off, span))
            offset += span
        return out

    async def _revalidate(self) -> None:
        """Refresh the inode before trusting its size: served from the
        cap cache when we still hold the cap (zero round trips), else
        re-stat — a revoke since open means someone changed it."""
        cached = self.fs._cached_inode(self.path)
        if cached is not None:
            self.inode = cached
        else:
            self.inode = await self.fs.stat(self.path)

    async def read(self, offset: int, length: int) -> bytes:
        await self._revalidate()
        size = self.inode.get("size", 0)
        if offset >= size:
            return b""
        length = min(length, size - offset)

        # a snapshot inode reads its data AT the snapshot's snapid
        snapid = self.inode.get("snapid", 0)
        io = self.fs._snap_data_io(snapid) if snapid else self.fs.data

        async def one(blockno: int, in_off: int, span: int) -> bytes:
            try:
                buf = await io.read(
                    data_obj(self.inode["ino"], blockno), in_off, span)
            except ObjectNotFound:
                return bytes(span)
            if len(buf) < span:
                buf += bytes(span - len(buf))
            return buf

        parts = await asyncio.gather(
            *(one(*ext) for ext in self._extents(offset, length)))
        return b"".join(parts)

    async def write(self, offset: int, data: bytes) -> int:
        if not self.writable:
            raise CephFSError(EROFS, self.path)
        pos = 0
        jobs = []
        for blockno, in_off, span in self._extents(offset, len(data)):
            chunk = data[pos:pos + span]
            pos += span
            jobs.append(self.fs.data.write(
                data_obj(self.inode["ino"], blockno), chunk, in_off))
        await asyncio.gather(*jobs)
        end = offset + len(data)
        if end > self._max_written:
            self._max_written = end
            now = time.time()
            ino = self.inode["ino"]
            if self.fs._caps.get(ino) == "rw" and \
                    self.fs._cap_valid(ino):
                # rw cap held: BUFFER the size locally (the Fw dirty-
                # caps discipline) — no MDS round trip per write.  It
                # flushes on close/fsync, or rides the revoke ack if
                # another client conflicts first.
                if end > self.inode.get("size", 0):
                    self.inode = dict(self.inode, size=end, mtime=now)
                    self.fs._attr_cache[self.path] = self.inode
                self.fs._note_dirty(ino, self.path, end, now)
            else:
                # capless: write-through size flush, max-merged on the
                # MDS so concurrent writers never shrink each other
                out = await self.fs._request(
                    "setattr", {"path": self.path, "size_max": end})
                self.inode = out["inode"]
        return len(data)

    async def append(self, data: bytes) -> int:
        await self._revalidate()
        return await self.write(self.inode.get("size", 0), data)

    async def flush(self) -> None:
        """fsync-of-metadata: push any buffered size/mtime now."""
        await self.fs._flush_dirty(self.inode["ino"])

    async def close(self) -> None:
        ino = self.inode["ino"]
        await self.fs._flush_dirty(ino)
        if self.writable and self.fs._caps.get(ino) == "rw":
            # voluntarily return the exclusive cap so other clients'
            # opens don't pay a recall round trip (dirty already
            # flushed above, so the release carries nothing) — to the
            # conn it was granted on (that rank's session)
            conn = self.fs._cap_conn.get(ino)
            self.fs._drop_ino(ino)
            if conn is not None and not conn.closed:
                try:
                    await conn.send(MClientCaps("release", ino))
                except (ConnectionError, OSError):
                    pass
