"""RBD role: block images striped over rados objects (port of
ceph_tpu/rbd/__init__.py).

Reference parity: librbd (Ceph's src/librbd/ — librbd.cc API
surface, ObjectMap/image layout in src/librbd/image/CreateRequest.cc):

- an image is an id, a header object `rbd_header.<id>` (metadata in
  omap: size, order, snapshots), and data objects
  `rbd_data.<id>.<objectno:016x>`, each covering 2^order bytes;
- `rbd_directory` maps name <-> id (src/cls/rbd dir_* methods);
- byte-range I/O maps to object extents (the Striper role,
  src/osdc/Striper.cc:file_to_extents) and fans out in parallel —
  absent data objects read as zeros (sparse images);
- erasure-coded backends use a separate data pool (`rbd create
  --data-pool`, librbd data_pool feature): metadata/omap stays on a
  replicated pool (omap is unsupported on EC pools, here as in the
  reference) while data objects live on the EC pool;
- the EXCLUSIVE LOCK feature (librbd::ExclusiveLock,
  src/librbd/ExclusiveLock.h): a writer auto-acquires a cls_lock on
  the header object on its first mutation and renews it on a
  heartbeat; a second writer is refused (EBUSY) while the holder is
  live and breaks the lock only after its renewal counter goes stale
  by the CHALLENGER's own clock — two clients can no longer interleave
  the header's read-modify-write (snapc/size updates);
- snapshots ride the pool's self-managed snap machinery: snap_create
  allocates a snap id and folds it into the image's write snap
  context, so ordinary clone-on-write in the OSDs preserves the
  snapshot state; reading at a snap sets the read-snap on the data
  ioctx (librbd::Image::snap_set).

- LAYERING (librbd clone v2, src/librbd/ parent I/O through ImageCtx
  and cls_rbd children records): a clone is a new image whose header
  carries a parent link {pool, image, snap, overlap}; reads of absent
  child objects fall through to the parent AT THE SNAP (up to the
  overlap), the first partial write to an absent object COPIES UP the
  parent's object content, and flatten() copies every remaining
  parent-backed object down and severs the link.  Clone requires a
  PROTECTED snapshot; unprotect refuses while children exist
  (cls_rbd children bookkeeping lives in the parent's header meta).
- OBJECT MAP (librbd::ObjectMap, src/librbd/object_map/): a 2-bit
  per-object state bitmap in `rbd_object_map.<id>` (requires
  exclusive-lock, as in the reference).  Writes mark objects EXISTS
  before data lands; discard/remove mark NONEXISTENT; reads skip the
  data round-trip for NONEXISTENT objects, and image remove deletes
  only mapped objects instead of probing every index.

The reference keeps image state in cls_rbd stored procedures; here the
same records live directly in header-object omap — the cls-lite layer
can host them later without changing the layout.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Dict, List, Optional

from ceph_tpu_torch.common import lockdep
from ceph_tpu_torch.rados.client import IoCtx, ObjectNotFound, RadosError

RBD_DIRECTORY = "rbd_directory"
RBD_TRASH = "rbd_trash"
DEFAULT_ORDER = 22  # 4 MiB objects, the reference default


def _header(image_id: str) -> str:
    return f"rbd_header.{image_id}"


def _data(image_id: str, objectno: int) -> str:
    return f"rbd_data.{image_id}.{objectno:016x}"


def _object_map(image_id: str) -> str:
    return f"rbd_object_map.{image_id}"


# object-map states (ObjectMap.h OBJECT_*)
OM_NONEXISTENT = 0
OM_EXISTS = 1


class RBD:
    """Image management surface (librbd::RBD)."""

    async def create(self, ioctx: IoCtx, name: str, size: int,
                     order: int = DEFAULT_ORDER,
                     data_pool: Optional[str] = None,
                     exclusive_lock: bool = False,
                     object_map: bool = False,
                     journaling: bool = False) -> str:
        """Create an image; returns its id.  data_pool places the data
        objects on a different (e.g. erasure-coded) pool while
        metadata stays on this replicated pool (--data-pool role)."""
        if not (12 <= order <= 26):
            raise RadosError(-22, f"order {order} out of range")
        # FRESH unique id per create (the reference allocates one from
        # rbd_directory too): remove+recreate must never reuse an id,
        # or leftovers from a partially failed remove would resurface
        # as data inside the new image
        import os as _os

        image_id = f"{ioctx.pool_id:x}{_os.urandom(6).hex()}"
        # header FIRST, name claim SECOND: a crash in between leaves
        # only an invisible orphan header (garbage, reclaimable name) —
        # the reverse order left a claimed name with no header that
        # could never be recreated
        features = ["exclusive-lock"] if exclusive_lock else []
        if object_map:
            if not exclusive_lock:
                # the reference gates object-map on exclusive-lock:
                # an unserialized bitmap would race its own writers
                raise RadosError(-22, "object-map requires"
                                      " exclusive-lock")
            features.append("object-map")
        if journaling:
            if not exclusive_lock:
                # librbd gates journaling on exclusive-lock too: the
                # event stream needs one writer ordering it
                raise RadosError(-22, "journaling requires"
                                      " exclusive-lock")
            features.append("journaling")
        meta = {"name": name, "size": size, "order": order,
                "snaps": {}, "snap_seq": 0, "data_pool": data_pool,
                "features": features}
        await ioctx.omap_set(_header(image_id),
                             {"rbd": json.dumps(meta).encode()})
        try:
            await ioctx.execute(
                RBD_DIRECTORY, "dir", "add",
                json.dumps({"key": f"name_{name}",
                            "value": image_id}).encode())
        except RadosError:
            # name taken — but a previous crash may have left a claim
            # whose header never landed (the old create order): that
            # name is RECLAIMABLE, anything else is a real EEXIST
            directory = await self._dir(ioctx)
            old_id = directory.get(name)
            stale = old_id is not None
            if stale:
                try:
                    await ioctx.omap_get(_header(old_id))
                    stale = False  # live image: real conflict
                except ObjectNotFound:
                    pass
            if not stale:
                await _ignore_enoent(ioctx.remove(_header(image_id)))
                raise RadosError(-17, f"image {name!r} exists")
            try:
                # value-checked removal: only the EXACT stale claim we
                # adjudicated dies — a racing reclaimer who already
                # replaced it must not lose its fresh claim
                await ioctx.execute(
                    RBD_DIRECTORY, "dir", "remove",
                    json.dumps({"key": f"name_{name}",
                                "value": old_id}).encode())
                await ioctx.execute(
                    RBD_DIRECTORY, "dir", "add",
                    json.dumps({"key": f"name_{name}",
                                "value": image_id}).encode())
            except RadosError:
                # lost the reclaim race: clean up our header, surface
                # EEXIST like any other conflict
                await _ignore_enoent(ioctx.remove(_header(image_id)))
                raise RadosError(-17, f"image {name!r} exists")
        return image_id

    async def clone(self, p_ioctx: IoCtx, parent_name: str,
                    snap_name: str, c_ioctx: IoCtx, clone_name: str,
                    data_pool: Optional[str] = None,
                    exclusive_lock: bool = False,
                    object_map: bool = False) -> str:
        """Clone from a PROTECTED parent snapshot (librbd clone v2,
        rbd_op clone).  The child starts with zero data objects;
        every read falls through to the parent at the snap until
        writes copy objects up."""
        parent = await self.open(p_ioctx, parent_name)
        snap = parent.meta["snaps"].get(snap_name)
        if snap is None:
            raise ObjectNotFound(-2, snap_name)
        if not snap.get("protected"):
            raise RadosError(-22, f"snap {snap_name!r} is not"
                                  " protected")
        child_id = await self.create(
            c_ioctx, clone_name, size=snap["size"],
            order=parent.meta["order"], data_pool=data_pool,
            exclusive_lock=exclusive_lock, object_map=object_map)
        child = Image(c_ioctx, clone_name, child_id)
        await child.refresh()
        child.meta["parent"] = {
            "pool_id": p_ioctx.pool_id, "image_id": parent.id,
            "snap_name": snap_name, "snap_id": snap["id"],
            "overlap": snap["size"]}
        child.meta["features"] = sorted(
            set(child.meta["features"]) | {"layering"})
        await child._save()
        # children bookkeeping on the parent (cls_rbd children role),
        # under the parent header lock: concurrent clones or an
        # unprotect racing this registration must serialize, or a
        # child record is lost and unprotect orphans the clone
        cookie = await _header_lock(p_ioctx, parent.id)
        try:
            await parent.refresh()
            snap = parent.meta["snaps"].get(snap_name)
            if snap is None or not snap.get("protected"):
                raise RadosError(
                    -22, f"snap {snap_name!r} lost protection during"
                         " clone")
            kids = parent.meta.setdefault("children", [])
            kids.append({"pool_id": c_ioctx.pool_id,
                         "image_id": child_id,
                         "snap_name": snap_name})
            await parent._save()
        except Exception:
            await _ignore_enoent(self.remove(c_ioctx, clone_name))
            raise
        finally:
            await _header_unlock(p_ioctx, parent.id, cookie)
        return child_id

    async def remove(self, ioctx: IoCtx, name: str) -> None:
        directory = await self._dir(ioctx)
        image_id = directory.get(name)
        if image_id is None:
            raise ObjectNotFound(-2, name)
        img = await self.open(ioctx, name)
        if img.meta["snaps"]:
            raise RadosError(-39, "image has snapshots")  # ENOTEMPTY
        if img.meta.get("children"):
            raise RadosError(-39, "image has dependent clones")
        await self._destroy(ioctx, img)
        try:
            # value-checked: if a concurrent create already reclaimed
            # the name with a fresh id, its claim must survive
            await ioctx.execute(
                RBD_DIRECTORY, "dir", "remove",
                json.dumps({"key": f"name_{name}",
                            "value": image_id}).encode())
        except RadosError:
            pass

    @staticmethod
    async def _destroy(ioctx: IoCtx, img: "Image") -> None:
        """Delete an image's data/map/journal/header (shared by
        remove() and trash_rm(); directory/trash bookkeeping is the
        caller's)."""
        image_id = img.id
        objects = (img.size() + img.object_size - 1) // img.object_size
        todo = range(objects)
        if img._om_enabled():
            # object-map acceleration: delete only objects the map
            # says exist instead of probing every index
            om = await img._om_load()
            todo = [i for i in range(objects)
                    if img._om_get(om, i) == OM_EXISTS]
        await asyncio.gather(*(
            _ignore_enoent(img.data_ioctx.remove(_data(image_id, i)))
            for i in todo))
        await _ignore_enoent(ioctx.remove(_object_map(image_id)))
        if img._journal is not None:
            await img._journal.destroy()
        parent = img.meta.get("parent")
        if parent is not None:
            await img._deregister_child()
        await _ignore_enoent(ioctx.remove(_header(image_id)))

    # -- trash (librbd api/Trash.cc role) ----------------------------------
    #
    # `rbd trash mv` detaches the NAME (the image becomes invisible to
    # open/ls) but keeps every object; restore re-claims a name, rm
    # destroys for real once the deferment window has passed.  The
    # safety property: an accidental delete is reversible until purge.

    async def trash_mv(self, ioctx: IoCtx, name: str,
                       delay: float = 0.0) -> str:
        directory = await self._dir(ioctx)
        image_id = directory.get(name)
        if image_id is None:
            raise ObjectNotFound(-2, name)
        img = await self.open(ioctx, name)
        try:
            if img.meta.get("children"):
                raise RadosError(-39, "image has dependent clones")
            if img.meta.get("migration"):
                raise RadosError(-16, "image is migrating")  # EBUSY
        finally:
            # the open may have acquired the exclusive lock (journal
            # replay); never leak it past the mv
            await img.close()
        now = time.time()
        # trash entry FIRST, then drop the name: a crash in between
        # leaves the image findable in BOTH (restore converges);
        # the reverse order would leave it findable in NEITHER
        await ioctx.omap_set(RBD_TRASH, {image_id: json.dumps({
            "name": name, "moved_at": now,
            "deferment_end": now + max(0.0, delay)}).encode()})
        try:
            await ioctx.execute(
                RBD_DIRECTORY, "dir", "remove",
                json.dumps({"key": f"name_{name}",
                            "value": image_id}).encode())
        except RadosError:
            pass  # name already re-claimed: trash entry still valid
        return image_id

    async def trash_ls(self, ioctx: IoCtx) -> List[Dict[str, Any]]:
        try:
            omap = await ioctx.omap_get(RBD_TRASH)
        except ObjectNotFound:
            return []
        out = []
        for image_id, raw in sorted(omap.items()):
            doc = json.loads(raw.decode())
            out.append(dict(doc, id=image_id))
        return out

    async def _trash_entry(self, ioctx: IoCtx,
                           image_id: str) -> Dict[str, Any]:
        try:
            omap = await ioctx.omap_get(RBD_TRASH)
        except ObjectNotFound:
            omap = {}
        raw = omap.get(image_id)
        if raw is None:
            raise ObjectNotFound(-2, f"no trash entry {image_id}")
        return json.loads(raw.decode())

    async def trash_restore(self, ioctx: IoCtx, image_id: str,
                            new_name: Optional[str] = None) -> str:
        doc = await self._trash_entry(ioctx, image_id)
        name = new_name or doc["name"]
        try:
            await ioctx.execute(
                RBD_DIRECTORY, "dir", "add",
                json.dumps({"key": f"name_{name}",
                            "value": image_id}).encode())
        except RadosError:
            # trash_mv's crash window leaves the image findable in
            # BOTH the directory and the trash; if the existing claim
            # already maps this exact id, restore just converges
            if (await self._dir(ioctx)).get(name) != image_id:
                raise RadosError(-17, f"name {name!r} is taken")
        await ioctx.omap_rm_keys(RBD_TRASH, [image_id])
        return name

    async def trash_rm(self, ioctx: IoCtx, image_id: str,
                       force: bool = False) -> None:
        doc = await self._trash_entry(ioctx, image_id)
        await self._trash_rm_doc(ioctx, image_id, doc, force)

    async def _trash_rm_doc(self, ioctx: IoCtx, image_id: str,
                            doc: Dict[str, Any],
                            force: bool) -> None:
        if not force and time.time() < doc.get("deferment_end", 0):
            raise RadosError(
                -1, "deferment window has not passed"
                    " (use force)")  # EPERM
        img = Image(ioctx, doc["name"], image_id)
        try:
            await img.refresh()
        except ObjectNotFound:
            # a prior trash_rm crashed after destroying the header:
            # the entry is the only leftover — drop it and converge
            await ioctx.omap_rm_keys(RBD_TRASH, [image_id])
            return
        if img.meta.get("children"):
            raise RadosError(-39, "image has dependent clones")
        for snap_name, snap in list(img.meta["snaps"].items()):
            if snap.get("protected"):
                raise RadosError(-16,
                                 f"snap {snap_name!r} is protected")
        for snap_name in list(img.meta["snaps"]):
            await img.snap_remove(snap_name)
        await self._destroy(ioctx, img)
        try:
            # the trash_mv crash window can leave the NAME claimed in
            # the directory too; value-checked removal so a phantom
            # entry never outlives the destroyed image
            await ioctx.execute(
                RBD_DIRECTORY, "dir", "remove",
                json.dumps({"key": f"name_{doc['name']}",
                            "value": image_id}).encode())
        except RadosError:
            pass  # name not claimed (the normal case) or re-claimed
        await ioctx.omap_rm_keys(RBD_TRASH, [image_id])

    async def trash_purge(self, ioctx: IoCtx) -> int:
        """Destroy every entry whose deferment has expired; returns
        how many were reclaimed."""
        n = 0
        for entry in await self.trash_ls(ioctx):
            if time.time() < entry.get("deferment_end", 0):
                continue
            try:
                await self._trash_rm_doc(ioctx, entry["id"], entry,
                                         force=False)
                n += 1
            except RadosError as e:
                if e.rc not in (-16, -39):
                    raise  # real I/O failure — surface it
                continue  # protected snaps / clones: left in trash
        return n

    async def list(self, ioctx: IoCtx) -> List[str]:
        return sorted(await self._dir(ioctx))

    async def open(self, ioctx: IoCtx, name: str) -> "Image":
        directory = await self._dir(ioctx)
        image_id = directory.get(name)
        if image_id is None:
            raise ObjectNotFound(-2, name)
        img = Image(ioctx, name, image_id)
        try:
            await img.refresh()
        except ObjectNotFound:
            # a half-created image (claim without header, pre-crash):
            # clear error instead of a raw header miss; create() can
            # reclaim the name
            raise RadosError(
                -5, f"image {name!r} has no header (interrupted"
                    " create?); re-create to reclaim the name")
        # journaling feature: replay events a crashed writer appended
        # but never applied (librbd::Journal open-time replay)
        await img._journal_replay()
        return img

    async def _dir(self, ioctx: IoCtx) -> Dict[str, str]:
        try:
            omap = await ioctx.omap_get(RBD_DIRECTORY)
        except ObjectNotFound:
            return {}
        return {k[len("name_"):]: v.decode()
                for k, v in omap.items() if k.startswith("name_")}


async def _ignore_enoent(coro) -> None:
    try:
        await coro
    except ObjectNotFound:
        pass


META_LOCK = "rbd_meta_lock"


async def _header_lock(ioctx: IoCtx, image_id: str,
                       timeout: float = 10.0) -> str:
    """Exclusive cls lock serializing header-metadata RMWs that span
    HANDLES (children registration, protection adjudication) — the
    cls_rbd single-writer discipline.  Expires (duration) so a crashed
    holder cannot brick the image."""
    import time as _time
    import uuid as _uuid

    cookie = _uuid.uuid4().hex[:12]
    req = json.dumps({"name": META_LOCK, "type": "exclusive",
                      "cookie": cookie, "duration": 15.0,
                      "owner": f"rbdmeta.{cookie}"}).encode()
    deadline = _time.monotonic() + timeout
    while True:
        try:
            await ioctx.execute(_header(image_id), "lock", "lock", req)
            return cookie
        except RadosError as e:
            if e.rc != -16 or _time.monotonic() > deadline:
                raise
            await asyncio.sleep(0.02)


async def _header_unlock(ioctx: IoCtx, image_id: str,
                         cookie: str) -> None:
    req = json.dumps({"name": META_LOCK, "cookie": cookie,
                      "owner": f"rbdmeta.{cookie}"}).encode()
    try:
        await ioctx.execute(_header(image_id), "lock", "unlock", req)
    except (ObjectNotFound, RadosError):
        pass  # header removed with the image: lock died with it


class Image:
    """An open image (librbd::Image): byte-addressed I/O + snaps."""

    LOCK_NAME = "rbd_lock"
    LOCK_RENEW = 1.0       # holder renewal period (seconds)
    LOCK_STALE = 5         # challenger: renewals missed before break

    def __init__(self, ioctx: IoCtx, name: str, image_id: str):
        # a dedicated ioctx: image snap context must not leak into the
        # caller's other I/O
        self.ioctx = IoCtx(ioctx.client, ioctx.pool_id)
        # data objects may live on a separate (EC) pool; bound in
        # refresh() once the header names it
        self.data_ioctx = self.ioctx
        self.name = name
        self.id = image_id
        self.meta: Dict[str, Any] = {}
        self._read_snap: Optional[str] = None
        # exclusive-lock state (feature-gated); per-HANDLE cookie so
        # two handles of one client contend like strangers (librbd's
        # cookie role) and closing one cannot unlock the other
        import uuid as _uuid

        self._lock_owned = False
        self._lock_cookie = _uuid.uuid4().hex[:12]
        self._lock_task: Optional[asyncio.Task] = None
        self._renew_n = 0
        self._seen_renewal = None  # (raw, my monotonic) for staleness
        # layering: parent reader handle, bound lazily in _parent()
        self._parent_img: Optional["Image"] = None
        # object map: in-memory bitmap cache (authoritative while the
        # exclusive lock is held, the reference's in-memory ObjectMap);
        # _om_lock serializes load+mutate so parallel per-object write
        # tasks can never fork the bitmap and lose marks
        self._om_cache: Optional[bytearray] = None
        self._om_lock = lockdep.Lock("rbd.om")
        # serializes absent-check + copyup: without it two concurrent
        # partial writes to one absent object both copy up and the
        # second copyup erases the first write's chunk (librbd guards
        # this with a server-side object-absent condition)
        self._copyup_lock = lockdep.Lock("rbd.copyup")
        # journaling (feature-gated): write-ahead event log; see
        # ceph_tpu_torch.rbd.journal.  _replaying suppresses re-journaling
        # while replay applies events through the ordinary op methods
        self._journal = None
        self._replaying = False

    # -- metadata ----------------------------------------------------------

    async def refresh(self) -> None:
        omap = await self.ioctx.omap_get(_header(self.id))
        self.meta = json.loads(omap["rbd"].decode())
        # derived caches follow the header: a peer may have changed
        # the map or the parent link since they were filled
        self._om_cache = None
        self._parent_img = None
        data_pool = self.meta.get("data_pool")
        if data_pool and self.data_ioctx is self.ioctx:
            self.data_ioctx = self.ioctx.client.open_ioctx(data_pool)
        self._apply_snapc()
        if "journaling" in self.meta.get("features", []):
            from ceph_tpu_torch.rbd.journal import ImageJournal

            if self._journal is None:
                self._journal = ImageJournal(self.ioctx, self.id)
            await self._journal.open()

    async def _save(self) -> None:
        await self.ioctx.omap_set(
            _header(self.id), {"rbd": json.dumps(self.meta).encode()})

    def _apply_snapc(self) -> None:
        snaps = sorted((s["id"] for s in self.meta["snaps"].values()),
                       reverse=True)
        self.data_ioctx.set_snap_context(self.meta["snap_seq"], snaps)

    # -- journaling (librbd::Journal role) ---------------------------------

    async def _j_append(self, ev) -> Optional[int]:
        """Write-ahead: journal the event before applying it (no-op
        without the feature, and during replay)."""
        if self._journal is None or self._replaying:
            return None
        return await self._journal.append(ev)

    async def _j_commit(self, seq: Optional[int]) -> None:
        if seq is not None and self._journal is not None:
            await self._journal.commit(seq)

    async def _journal_replay(self) -> None:
        """Apply events a crashed writer journaled but never applied
        (seq above the commit position).  Events are idempotent
        full-state mutations, so at-least-once re-application is
        safe; snap ops tolerate already-done errors."""
        if self._journal is None:
            return
        committed = int(self._journal.hdr.get("committed", 0))
        events = await self._journal.events_since(committed)
        if not events:
            return
        self._replaying = True
        try:
            for ev in events:
                try:
                    await self._apply_event(ev)
                except RadosError:
                    pass  # snap already created/removed, etc.
                await self._journal.commit(ev["seq"])
        finally:
            self._replaying = False

    async def _apply_event(self, ev) -> None:
        op = ev["op"]
        if op == "write":
            await self.write(ev["offset"], ev["data"])
        elif op == "discard":
            await self.discard(ev["offset"], ev["length"])
        elif op == "resize":
            await self.resize(ev["size"])
        elif op == "snap_create":
            await self.snap_create(ev["snap_name"])
        elif op == "snap_remove":
            await self.snap_remove(ev["snap_name"])
        elif op == "snap_rollback":
            await self.snap_rollback(ev["snap_name"])

    @property
    def object_size(self) -> int:
        return 1 << self.meta["order"]

    def size(self) -> int:
        if self._read_snap is not None:
            return self.meta["snaps"][self._read_snap]["size"]
        return self.meta["size"]

    async def stat(self) -> Dict[str, Any]:
        return {"size": self.size(), "order": self.meta["order"],
                "obj_size": self.object_size,
                "num_objs": (self.size() + self.object_size - 1)
                // self.object_size}

    # -- extent mapping (Striper::file_to_extents role) --------------------

    def _extents(self, offset: int, length: int):
        """(objectno, in-object offset, length) covering the range."""
        out = []
        end = offset + length
        while offset < end:
            objectno = offset // self.object_size
            in_off = offset % self.object_size
            span = min(self.object_size - in_off, end - offset)
            out.append((objectno, in_off, span))
            offset += span
        return out

    # -- layering (parent I/O, librbd ImageCtx parent role) ---------------

    def _has_parent(self) -> bool:
        return self.meta.get("parent") is not None

    async def _parent(self) -> "Image":
        """The parent image opened read-only AT THE CLONE SNAP."""
        if self._parent_img is None:
            p = self.meta["parent"]
            p_ioctx = IoCtx(self.ioctx.client, p["pool_id"])
            # open by id: the parent may have been renamed since
            img = Image(p_ioctx, "", p["image_id"])
            await img.refresh()
            img.snap_set(p["snap_name"])
            self._parent_img = img
        return self._parent_img

    def _effective_overlap(self) -> int:
        if self._read_snap is not None:
            snap = self.meta["snaps"][self._read_snap]
            return snap.get("parent_overlap",
                            self.meta["parent"]["overlap"])
        return self.meta["parent"]["overlap"]

    async def _parent_read(self, objectno: int, in_off: int,
                           span: int) -> bytes:
        """Read the byte range from the parent at the snap, clamped to
        the overlap (the READ snap's recorded overlap when reading at
        a snapshot); beyond-overlap bytes are zeros."""
        start = objectno * self.object_size + in_off
        end = min(start + span, self._effective_overlap())
        if end <= start:
            return bytes(span)
        parent = await self._parent()
        buf = await parent.read(start, end - start)
        return buf + bytes(span - len(buf))

    async def _copyup(self, objectno: int) -> None:
        """First partial write to an absent child object: copy the
        parent's content for that object down (librbd CopyupRequest).
        Idempotent — re-running after a crash converges."""
        content = await self._parent_read(objectno, 0,
                                          self.object_size)
        content = content.rstrip(b"\x00")
        await self.data_ioctx.write_full(_data(self.id, objectno),
                                         content)
        await self._om_mark(objectno, OM_EXISTS)

    async def _child_object_absent(self, objectno: int) -> bool:
        if self._om_enabled():
            om = await self._om_load()
            return self._om_get(om, objectno) == OM_NONEXISTENT
        try:
            await self.data_ioctx.stat(_data(self.id, objectno))
            return False
        except ObjectNotFound:
            return True

    async def _deregister_child(self) -> None:
        p = self.meta.get("parent")
        if p is None:
            return
        p_ioctx = IoCtx(self.ioctx.client, p["pool_id"])
        parent = Image(p_ioctx, "", p["image_id"])
        try:
            cookie = await _header_lock(p_ioctx, p["image_id"])
        except ObjectNotFound:
            return
        try:
            await parent.refresh()
            kids = [c for c in parent.meta.get("children", [])
                    if c["image_id"] != self.id]
            parent.meta["children"] = kids
            await parent._save()
        except ObjectNotFound:
            pass
        finally:
            await _header_unlock(p_ioctx, p["image_id"], cookie)

    async def flatten(self) -> None:
        """Copy every still-parent-backed object down, then sever the
        parent link (librbd flatten)."""
        if not self._has_parent():
            return
        await self._ensure_lock()
        overlap = self.meta["parent"]["overlap"]
        objects = -(-overlap // self.object_size)
        sem = asyncio.Semaphore(8)

        async def one(objectno: int) -> None:
            async with sem:
                if await self._child_object_absent(objectno):
                    await self._copyup(objectno)

        await asyncio.gather(*(one(i) for i in range(objects)))
        await self._deregister_child()
        self.meta["parent"] = None
        self.meta["features"] = [f for f in self.meta["features"]
                                 if f != "layering"]
        await self._save()
        self._parent_img = None

    # -- object map (librbd::ObjectMap role) ------------------------------

    def _om_enabled(self) -> bool:
        return "object-map" in self.meta.get("features", [])

    async def _om_load(self) -> bytearray:
        if self._om_cache is not None:
            return self._om_cache
        objects = -(-self.meta["size"] // self.object_size)
        nbytes = -(-objects // 4)  # 2 bits per object
        try:
            raw = bytearray(await self.ioctx.read(
                _object_map(self.id)))
        except ObjectNotFound:
            raw = bytearray()
        if len(raw) < nbytes:
            raw.extend(bytes(nbytes - len(raw)))
        self._om_cache = raw
        return raw

    @staticmethod
    def _om_get(om: bytearray, objectno: int) -> int:
        return (om[objectno // 4] >> ((objectno % 4) * 2)) & 3

    async def _om_mark(self, objectno: int, state: int) -> None:
        if not self._om_enabled():
            return
        async with self._om_lock:
            om = await self._om_load()
            if objectno // 4 >= len(om):
                om.extend(bytes(objectno // 4 + 1 - len(om)))
            shift = (objectno % 4) * 2
            om[objectno // 4] = (om[objectno // 4] & ~(3 << shift)) \
                | (state << shift)
            await self.ioctx.write_full(_object_map(self.id),
                                        bytes(om))

    async def rebuild_object_map(self) -> None:
        """Scan actual data objects and rewrite the map (rbd
        object-map rebuild)."""
        await self._ensure_lock()
        objects = -(-self.meta["size"] // self.object_size)
        om = bytearray(-(-objects // 4))
        sem = asyncio.Semaphore(8)

        async def probe(i: int) -> None:
            async with sem:
                try:
                    await self.data_ioctx.stat(_data(self.id, i))
                    om[i // 4] |= OM_EXISTS << ((i % 4) * 2)
                except ObjectNotFound:
                    pass

        await asyncio.gather(*(probe(i) for i in range(objects)))
        self._om_cache = om
        await self.ioctx.write_full(_object_map(self.id), bytes(om))

    async def diff_objects(self) -> List[int]:
        """Object indexes with data (fast-diff lite): straight from
        the map when enabled, probe otherwise."""
        objects = -(-self.meta["size"] // self.object_size)
        if self._om_enabled():
            om = await self._om_load()
            return [i for i in range(objects)
                    if self._om_get(om, i) == OM_EXISTS]
        sem = asyncio.Semaphore(8)

        async def probe(i: int) -> bool:
            async with sem:
                try:
                    await self.data_ioctx.stat(_data(self.id, i))
                    return True
                except ObjectNotFound:
                    return False

        hits = await asyncio.gather(*(probe(i)
                                      for i in range(objects)))
        return [i for i, hit in enumerate(hits) if hit]

    # -- I/O ---------------------------------------------------------------

    async def read(self, offset: int, length: int) -> bytes:
        size = self.size()
        if offset >= size:
            return b""
        length = min(length, size - offset)
        om = await self._om_load() if self._om_enabled() and \
            self._read_snap is None else None

        async def one(objectno: int, in_off: int, span: int) -> bytes:
            if om is not None and \
                    self._om_get(om, objectno) == OM_NONEXISTENT:
                # map says absent: skip the data round-trip entirely
                if self._has_parent():
                    return await self._parent_read(objectno, in_off,
                                                   span)
                return bytes(span)
            try:
                buf = await self.data_ioctx.read(
                    _data(self.id, objectno), in_off, span)
            except ObjectNotFound:
                if self._has_parent():
                    # clone fallthrough: the parent provides content
                    # until a write copies the object up (also for
                    # reads at a CHILD snap — the parent is frozen at
                    # its own snap, so its content is time-invariant)
                    return await self._parent_read(objectno, in_off,
                                                   span)
                return bytes(span)  # sparse: absent object reads zeros
            if len(buf) < span:  # short object tail is sparse too
                buf += bytes(span - len(buf))
            return buf

        parts = await asyncio.gather(
            *(one(*ext) for ext in self._extents(offset, length)))
        return b"".join(parts)

    # -- exclusive lock (librbd::ExclusiveLock role) -----------------------

    def _exclusive_enabled(self) -> bool:
        return "exclusive-lock" in self.meta.get("features", [])

    async def _ensure_lock(self) -> None:
        """Lock-on-write policy: the first mutation acquires; a live
        peer holder means EBUSY; a stale holder (renewal counter
        unchanged for LOCK_STALE periods of OUR clock) is broken."""
        if not self._exclusive_enabled() or self._lock_owned:
            return
        import time

        req = json.dumps({"name": self.LOCK_NAME, "type": "exclusive",
                          "owner": self.ioctx.client.msgr.entity_name,
                          "cookie": self._lock_cookie,
                          "tag": "rbd"}).encode()
        deadline = time.monotonic() + \
            self.LOCK_RENEW * (self.LOCK_STALE + 2)
        while True:
            try:
                await self.ioctx.execute(_header(self.id), "lock",
                                         "lock", req)
                break
            except RadosError:
                pass
            if time.monotonic() > deadline:
                raise RadosError(
                    -16, f"image {self.name!r} is exclusively"
                         " locked by a live client")  # EBUSY
            try:
                raw = await self.ioctx.getxattr(
                    _header(self.id), "rbd.lock.renewal")
            except Exception:
                raw = b""
            now = time.monotonic()
            if self._seen_renewal is None or \
                    self._seen_renewal[0] != raw:
                self._seen_renewal = (raw, now)
            elif now - self._seen_renewal[1] > \
                    self.LOCK_RENEW * self.LOCK_STALE:
                # holder dead: break (by its full locker identity from
                # the cls lock state, not just the stamp) and retry
                try:
                    info = json.loads((await self.ioctx.execute(
                        _header(self.id), "lock", "get_info",
                        json.dumps({"name": self.LOCK_NAME})
                        .encode())).decode())
                    for locker in info.get("lockers", {}).values():
                        await self.ioctx.execute(
                            _header(self.id), "lock", "break_lock",
                            json.dumps({
                                "name": self.LOCK_NAME,
                                "locker": locker["owner"],
                                "cookie": locker.get("cookie", ""),
                            }).encode())
                except (RadosError, ValueError, KeyError):
                    pass
                self._seen_renewal = None
            await asyncio.sleep(self.LOCK_RENEW / 2)
        self._lock_owned = True
        # the header may have moved while someone else held the lock:
        # re-read it UNDER the lock so our read-modify-writes (snapc,
        # size, snaps) start from the current state
        await self.refresh()
        # the refresh may have just revealed a migration fence set
        # since we opened — fail the acquiring mutation, not the ones
        # after it
        try:
            self._fence_migration_source()
        except RadosError:
            await self.release_exclusive_lock()
            raise
        await self._renew_lock_stamp()
        self._lock_task = asyncio.get_running_loop().create_task(
            self._lock_renew_loop())

    async def _renew_lock_stamp(self) -> None:
        self._renew_n += 1
        await self.ioctx.setxattr(
            _header(self.id), "rbd.lock.renewal",
            json.dumps([self.ioctx.client.msgr.entity_name,
                        self._lock_cookie, self._renew_n]).encode())

    async def _lock_renew_loop(self) -> None:
        misses = 0
        try:
            while self._lock_owned:
                await asyncio.sleep(self.LOCK_RENEW)
                try:
                    await self._renew_lock_stamp()
                    misses = 0
                except Exception:
                    misses += 1
                    if misses * 2 >= self.LOCK_STALE:
                        # cannot prove liveness anymore: DEMOTE before
                        # a challenger breaks the lock, or two writers
                        # would interleave the header RMW — the next
                        # mutation re-acquires cleanly
                        self._lock_owned = False
                        return
        except asyncio.CancelledError:
            pass

    async def release_exclusive_lock(self) -> None:
        if not self._lock_owned:
            return
        self._lock_owned = False
        if self._lock_task is not None:
            self._lock_task.cancel()
            self._lock_task = None
        try:
            await self.ioctx.execute(
                _header(self.id), "lock", "unlock",
                json.dumps({
                    "name": self.LOCK_NAME,
                    "owner": self.ioctx.client.msgr.entity_name,
                    "cookie": self._lock_cookie,
                }).encode())
        except RadosError:
            pass

    async def close(self) -> None:
        """Release the exclusive lock (librbd close)."""
        await self.release_exclusive_lock()

    # -- I/O (mutators) ----------------------------------------------------

    def _fence_migration_source(self) -> None:
        """A migration source is write-fenced (Migration.cc prepare
        semantics re-designed as a header flag): clients must switch
        to the destination image, whose writes are the live ones."""
        if self.meta.get("migration"):
            raise RadosError(-30, "image is a migration source"
                                  " (write-fenced)")  # EROFS

    async def write(self, offset: int, data: bytes) -> int:
        if self._read_snap is not None:
            raise RadosError(-30, "image is open at a snapshot")  # EROFS
        if offset + len(data) > self.meta["size"]:
            raise RadosError(-27, "write past image size")  # EFBIG
        self._fence_migration_source()
        await self._ensure_lock()
        seq = await self._j_append({"op": "write", "offset": offset,
                                    "data": data})
        pos = 0
        jobs = []
        for objectno, in_off, span in self._extents(offset, len(data)):
            chunk = data[pos:pos + span]
            pos += span
            jobs.append(self._write_object(objectno, in_off, span,
                                           chunk))
        await asyncio.gather(*jobs)
        await self._j_commit(seq)
        return len(data)

    async def _write_object(self, objectno: int, in_off: int,
                            span: int, chunk: bytes) -> None:
        """One object's slice of a write: copyup-then-write for
        partial writes into a parent-backed absent object (librbd
        AbstractObjectWriteRequest copyup path), object-map EXISTS
        before data lands."""
        full = in_off == 0 and span == self.object_size
        if self._has_parent() and not full and \
                objectno * self.object_size \
                < self.meta["parent"]["overlap"]:
            async with self._copyup_lock:
                if await self._child_object_absent(objectno):
                    await self._copyup(objectno)
        await self._om_mark(objectno, OM_EXISTS)
        await self.data_ioctx.write(_data(self.id, objectno), chunk,
                                    in_off)

    async def discard(self, offset: int, length: int) -> None:
        """Deallocate a range: whole objects are removed (returning
        them to sparse), partial spans are zeroed."""
        if self._read_snap is not None:
            raise RadosError(-30, "image is open at a snapshot")
        self._fence_migration_source()
        await self._ensure_lock()
        seq = await self._j_append({"op": "discard", "offset": offset,
                                    "length": length})
        overlap = self.meta["parent"]["overlap"] \
            if self._has_parent() else 0
        jobs = []
        for objectno, in_off, span in self._extents(offset, length):
            name = _data(self.id, objectno)
            full = in_off == 0 and span == self.object_size
            if full and objectno * self.object_size >= overlap:
                jobs.append(self._discard_object(objectno, name))
            else:
                # parent-backed range (or partial span): removal would
                # EXPOSE the parent's bytes again — zero instead
                jobs.append(self._write_object(objectno, in_off, span,
                                               bytes(span)))
        await asyncio.gather(*jobs)
        await self._j_commit(seq)

    async def _discard_object(self, objectno: int, name: str) -> None:
        await _ignore_enoent(self.data_ioctx.remove(name))
        await self._om_mark(objectno, OM_NONEXISTENT)

    async def resize(self, new_size: int) -> None:
        if self._read_snap is not None:
            raise RadosError(-30, "image is open at a snapshot")
        self._fence_migration_source()
        await self._ensure_lock()
        seq = await self._j_append({"op": "resize", "size": new_size})
        old = self.meta["size"]
        if new_size < old:
            # drop whole objects past the end; zero the partial tail
            first_dead = (new_size + self.object_size - 1) \
                // self.object_size
            last = (old + self.object_size - 1) // self.object_size
            dead = range(first_dead, last)
            if self._om_enabled():
                om = await self._om_load()
                dead = [i for i in dead
                        if self._om_get(om, i) == OM_EXISTS]
            await asyncio.gather(*(
                self._discard_object(i, _data(self.id, i))
                for i in dead))
            if new_size % self.object_size:
                # through the copyup-aware path: a raw zero-write
                # would CREATE the tail object and cut off parent
                # fallthrough for its still-live head bytes
                tail = new_size % self.object_size
                await self._write_object(
                    new_size // self.object_size, tail,
                    self.object_size - tail,
                    bytes(self.object_size - tail))
            if self._has_parent():
                # shrink shrinks the parent overlap permanently
                # (librbd: overlap = min(overlap, size))
                self.meta["parent"]["overlap"] = min(
                    self.meta["parent"]["overlap"], new_size)
        self.meta["size"] = new_size
        await self._save()
        await self._j_commit(seq)

    # -- snapshots (librbd snap_create/list/remove/set) --------------------

    async def snap_create(self, snap_name: str) -> int:
        if snap_name in self.meta["snaps"]:
            raise RadosError(-17, f"snap {snap_name!r} exists")
        self._fence_migration_source()
        await self._ensure_lock()
        jseq = await self._j_append({"op": "snap_create",
                                     "snap_name": snap_name})
        snap_id = await self.data_ioctx.create_selfmanaged_snap()
        entry = {"id": snap_id, "size": self.meta["size"]}
        if self._has_parent():
            # snapshot-time parent overlap: a later shrink clamps the
            # HEAD overlap, but reads at this snap must keep seeing
            # what was parent-visible when it was taken (librbd
            # parent_overlap per snap)
            entry["parent_overlap"] = self.meta["parent"]["overlap"]
        self.meta["snaps"][snap_name] = entry
        self.meta["snap_seq"] = max(self.meta["snap_seq"], snap_id)
        self._apply_snapc()
        await self._save()
        await self._j_commit(jseq)
        return snap_id

    async def snap_list(self) -> List[Dict[str, Any]]:
        return [{"name": n, **s}
                for n, s in sorted(self.meta["snaps"].items(),
                                   key=lambda kv: kv[1]["id"])]

    async def snap_protect(self, snap_name: str) -> None:
        """Protect a snap so clones may reference it (librbd
        snap_protect; unprotect refuses while children exist)."""
        snap = self.meta["snaps"].get(snap_name)
        if snap is None:
            raise ObjectNotFound(-2, snap_name)
        snap["protected"] = True
        await self._save()

    async def snap_unprotect(self, snap_name: str) -> None:
        # children check + protection clear under the header lock:
        # a clone() registering concurrently must either land before
        # (we refuse) or after (it sees protection gone and aborts)
        cookie = await _header_lock(self.ioctx, self.id)
        try:
            await self.refresh()
            snap = self.meta["snaps"].get(snap_name)
            if snap is None:
                raise ObjectNotFound(-2, snap_name)
            kids = [c for c in self.meta.get("children", [])
                    if c.get("snap_name") == snap_name]
            if kids:
                raise RadosError(
                    -16, f"snap {snap_name!r} has"
                         f" {len(kids)} clone(s)")  # EBUSY
            snap["protected"] = False
            await self._save()
        finally:
            await _header_unlock(self.ioctx, self.id, cookie)

    async def snap_is_protected(self, snap_name: str) -> bool:
        snap = self.meta["snaps"].get(snap_name)
        if snap is None:
            raise ObjectNotFound(-2, snap_name)
        return bool(snap.get("protected"))

    async def snap_remove(self, snap_name: str) -> None:
        snap = self.meta["snaps"].get(snap_name)
        if snap is None:
            raise ObjectNotFound(-2, snap_name)
        if snap.get("protected"):
            raise RadosError(-16, f"snap {snap_name!r} is protected")
        jseq = await self._j_append({"op": "snap_remove",
                                     "snap_name": snap_name})
        self.meta["snaps"].pop(snap_name)
        self._apply_snapc()
        await self._save()
        await self.data_ioctx.remove_selfmanaged_snap(snap["id"])
        await self._j_commit(jseq)

    def snap_set(self, snap_name: Optional[str]) -> None:
        """Open the image read-only at a snapshot (None = head)."""
        if snap_name is None:
            self._read_snap = None
            self.data_ioctx.snap_set_read(0)
            return
        snap = self.meta["snaps"].get(snap_name)
        if snap is None:
            raise ObjectNotFound(-2, snap_name)
        self._read_snap = snap_name
        self.data_ioctx.snap_set_read(snap["id"])

    async def snap_rollback(self, snap_name: str) -> None:
        """Copy the snap's content back over the head (librbd
        snap_rollback: reads at the snap, writes to the head)."""
        snap = self.meta["snaps"].get(snap_name)
        if snap is None:
            raise ObjectNotFound(-2, snap_name)
        jseq = await self._j_append({"op": "snap_rollback",
                                     "snap_name": snap_name})
        # the rollback's internal resize/writes re-journal unless
        # suppressed: ONE rollback event stands for the whole copy
        was_replaying, self._replaying = self._replaying, True
        try:
            await self._snap_rollback_inner(snap_name, snap)
        finally:
            self._replaying = was_replaying
        await self._j_commit(jseq)

    async def _snap_rollback_inner(self, snap_name: str,
                                   snap) -> None:
        reader = Image(self.ioctx, self.name, self.id)
        await reader.refresh()  # binds data_ioctx (data_pool images)
        reader.snap_set(snap_name)
        if self.meta["size"] != snap["size"]:
            await self.resize(snap["size"])
        step = self.object_size
        for off in range(0, snap["size"], step):
            span = min(step, snap["size"] - off)
            buf = await reader.read(off, span)
            await self.write(off, buf)
