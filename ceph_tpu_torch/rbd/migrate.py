"""RBD deep-copy and live migration (port of
ceph_tpu/rbd/migrate.py).

Reference parity:
- deep-copy (Ceph's src/librbd/deep_copy/, `rbd deep cp`):
  copy an image INCLUDING its snapshot history — each snapshot is
  re-created on the destination with the data that was visible at
  that snapshot, replayed oldest-first as delta passes over a moving
  head (SnapshotCopyRequest + ObjectCopyRequest roles).  Works across
  pools AND across clusters (src/dst are just IoCtxs).
- migration (Ceph's src/librbd/api/Migration.cc, `rbd
  migration prepare/execute/commit/abort`): move an image to another
  pool while it stays readable — the destination is linked to the
  source through the PARENT machinery (the reference literally models
  the migration source as a parent), so reads fall through and
  execute() is a flatten.  Re-design simplifications, documented:
  the source is write-fenced by a header flag rather than hidden
  behind the destination's name, clients open the DESTINATION name
  after prepare, and snapshotted images must use deep_copy (offline)
  instead — replaying snapshot history into a destination that is
  concurrently taking new writes needs write-at-snap-context
  machinery the head-only path avoids.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ceph_tpu_torch.rados.client import IoCtx, ObjectNotFound, RadosError
from ceph_tpu_torch.rbd import (
    RBD,
    Image,
    _header,
    _header_lock,
    _header_unlock,
)

EROFS = -30
EINVAL = -22
EBUSY = -16


async def deep_copy(src_ioctx: IoCtx, src_name: str,
                    dst_ioctx: IoCtx, dst_name: str,
                    data_pool: Optional[str] = None,
                    concurrency: int = 8) -> str:
    """Copy src -> dst with full snapshot history; returns the new
    image id.  Delta passes: each snapshot (ascending id), then the
    head — an object range is written only when it differs from the
    previous pass's content, so unchanged data moves once."""
    rbd = RBD()
    src = await rbd.open(src_ioctx, src_name)
    feats = set(src.meta.get("features", []))
    # journaling is enabled AFTER the copy: there are no concurrent
    # writers to order during it, and journaling each bulk write
    # would move every byte twice (journal event + data object)
    dst_id = await rbd.create(
        dst_ioctx, dst_name, size=0, order=src.meta["order"],
        data_pool=src.meta.get("data_pool")
        if data_pool is None else data_pool,
        exclusive_lock="exclusive-lock" in feats,
        object_map="object-map" in feats)
    dst = await rbd.open(dst_ioctx, dst_name)
    snaps = sorted(src.meta["snaps"].items(),
                   key=lambda kv: kv[1]["id"])
    passes = [(name, s["size"], bool(s.get("protected")))
              for name, s in snaps]
    passes.append((None, src.size(), False))
    objsz = src.object_size
    prev_reader: Optional[Image] = None
    prev_size = 0
    sem = asyncio.Semaphore(concurrency)
    try:
        for snap_name, size, protected in passes:
            # the first pass reuses the probe handle; later passes
            # need a second concurrent handle (prev snap + this one)
            reader = src if prev_reader is None \
                else await rbd.open(src_ioctx, src_name)
            reader.snap_set(snap_name)
            if dst.size() != size:
                await dst.resize(size)

            sparse_ok = not src._has_parent()

            async def _absent(img: Image, objno: int) -> bool:
                from ceph_tpu_torch.rbd import _data

                try:
                    # stat resolves at the handle's read snap, like
                    # any read op
                    await img.data_ioctx.stat(_data(img.id, objno))
                    return False
                except ObjectNotFound:
                    return True

            async def one(off: int, span: int, rd=reader) -> None:
                async with sem:
                    objno = off // objsz
                    if sparse_ok and await _absent(rd, objno) and (
                            prev_reader is None
                            or off >= prev_size
                            or await _absent(prev_reader, objno)):
                        # absent in BOTH passes: nothing changed and
                        # nothing to write — a sparse image skips the
                        # two full-object reads (parent-backed images
                        # cannot skip: absent still reads through)
                        return
                    cur = await rd.read(off, span)
                    if prev_reader is not None and off < prev_size:
                        old = await prev_reader.read(
                            off, min(span, prev_size - off))
                        old = old + bytes(span - len(old))
                    else:
                        old = bytes(span)
                    if cur != old:
                        await dst.write(off, cur)

            await asyncio.gather(*(
                one(off, min(objsz, size - off))
                for off in range(0, size, objsz)))
            if snap_name is not None:
                await dst.snap_create(snap_name)
                if protected:
                    await dst.snap_protect(snap_name)
            if prev_reader is not None:
                await prev_reader.close()  # retired as diff base
            prev_reader, prev_size = reader, size
        if "journaling" in feats:
            dst.meta["features"] = sorted(
                set(dst.meta["features"]) | {"journaling"})
            await dst._save()
    finally:
        if prev_reader is not None:
            await prev_reader.close()
        await dst.close()
    return dst_id


# -- migration (Migration.cc prepare/execute/commit/abort) ----------------


async def migration_prepare(src_ioctx: IoCtx, src_name: str,
                            dst_ioctx: IoCtx, dst_name: str,
                            data_pool: Optional[str] = None) -> str:
    """Create the destination linked to the source via the parent
    machinery and write-fence the source.  Clients switch to the
    destination name; reads of not-yet-copied data fall through."""
    import json as _json

    rbd = RBD()
    src = await rbd.open(src_ioctx, src_name)
    if src.meta["snaps"]:
        raise RadosError(EINVAL, "snapshotted image: use deep_copy"
                                 " (offline) instead")
    if src.meta.get("migration"):
        raise RadosError(EBUSY, f"{src_name!r} already migrating")
    # the reference refuses to prepare an in-use image (Migration.cc
    # checks watchers); the analog here is a held exclusive lock.
    # Images WITHOUT exclusive-lock have no open-ness signal — as
    # with the reference's requirement, the operator must quiesce
    # writers first (pre-prepare handles that never refresh cannot
    # be fenced).
    if "exclusive-lock" in src.meta.get("features", []):
        try:
            info = _json.loads((await src_ioctx.execute(
                _header(src.id), "lock", "get_info",
                _json.dumps({"name": Image.LOCK_NAME})
                .encode())).decode())
            if info.get("lockers"):
                raise RadosError(EBUSY,
                                 f"{src_name!r} is in use"
                                 " (exclusive lock held)")
        except RadosError as e:
            if e.rc == EBUSY:
                raise
    feats = set(src.meta.get("features", []))
    dst_id = await rbd.create(
        dst_ioctx, dst_name, size=src.size(),
        order=src.meta["order"],
        data_pool=src.meta.get("data_pool")
        if data_pool is None else data_pool,
        exclusive_lock="exclusive-lock" in feats,
        object_map="object-map" in feats,
        journaling="journaling" in feats)
    dst = Image(dst_ioctx, dst_name, dst_id)
    await dst.refresh()
    dst.meta["parent"] = {
        "pool_id": src_ioctx.pool_id, "image_id": src.id,
        "snap_name": None, "snap_id": None,
        "overlap": src.size(), "migration": True}
    dst.meta["features"] = sorted(
        set(dst.meta["features"]) | {"layering"})
    dst.meta["migration_source"] = {
        "pool_id": src_ioctx.pool_id, "image_id": src.id,
        "name": src_name, "state": "prepared"}
    await dst._save()
    # child registration + write fence on the source, under its
    # header lock (the clone() discipline): remove(src) now refuses
    # (dependent child) and writers get EROFS on their next header
    # refresh.  On ANY failure the half-made destination is rolled
    # back (clone()'s except-cleanup discipline) — a dst with a
    # parent link but no child record would break permanently when
    # the unfenced source is removed.
    try:
        cookie = await _header_lock(src_ioctx, src.id)
        try:
            await src.refresh()
            src.meta.setdefault("children", []).append(
                {"pool_id": dst_ioctx.pool_id, "image_id": dst_id,
                 "snap_name": None})
            src.meta["migration"] = {"dst_pool": dst_ioctx.pool_id,
                                     "dst_id": dst_id,
                                     "state": "prepared"}
            await src._save()
        finally:
            await _header_unlock(src_ioctx, src.id, cookie)
    except Exception:
        dst.meta.pop("parent", None)  # plain remove, no deregister
        dst.meta.pop("migration_source", None)
        await dst._save()
        try:
            await rbd.remove(dst_ioctx, dst_name)
        except Exception:
            pass
        raise
    return dst_id


async def migration_execute(dst_ioctx: IoCtx, dst_name: str,
                            image: Optional[Image] = None) -> None:
    """Copy everything down (flatten through the migration link).
    For exclusive-lock images with a LIVE writer, pass that writer's
    open handle as `image` — flatten then runs under the lock it
    already holds (the reference executes migration inside librbd for
    the same reason); a second handle would wait out the holder and
    fail EBUSY."""
    rbd = RBD()
    dst = image if image is not None \
        else await rbd.open(dst_ioctx, dst_name)
    ms = dst.meta.get("migration_source")
    if ms is None:
        raise RadosError(EINVAL, f"{dst_name!r} is not a migration"
                                 " destination")
    try:
        if dst.meta.get("parent"):
            await dst.flatten()
        ms["state"] = "executed"
        dst.meta["migration_source"] = ms
        await dst._save()
        # reflect state on the (fenced) source header for operators
        src_io = IoCtx(dst_ioctx.client, ms["pool_id"])
        src = Image(src_io, ms["name"], ms["image_id"])
        try:
            await src.refresh()
            if src.meta.get("migration"):
                src.meta["migration"]["state"] = "executed"
                await src._save()
        except Exception:
            pass  # source header gone: commit already ran elsewhere
    finally:
        if image is None:  # never close a caller-owned handle
            await dst.close()


async def migration_commit(dst_ioctx: IoCtx, dst_name: str) -> None:
    """Finalize: delete the drained source, clear the link."""
    rbd = RBD()
    dst = await rbd.open(dst_ioctx, dst_name)
    ms = dst.meta.get("migration_source")
    if ms is None:
        raise RadosError(EINVAL, f"{dst_name!r} is not a migration"
                                 " destination")
    if ms.get("state") != "executed":
        raise RadosError(EINVAL, "execute the migration first")
    src_io = IoCtx(dst_ioctx.client, ms["pool_id"])
    src = Image(src_io, ms["name"], ms["image_id"])
    try:
        await src.refresh()
        # drop the fence so remove() may proceed, then delete
        src.meta.pop("migration", None)
        await src._save()
        await rbd.remove(src_io, ms["name"])
    except ObjectNotFound:
        pass  # already removed: idempotent commit retry.  Any OTHER
        # failure must propagate BEFORE migration_source is cleared,
        # or the orphaned (possibly still fenced) source loses its
        # only retry path
    dst.meta.pop("migration_source", None)
    await dst._save()
    await dst.close()


async def migration_abort(dst_ioctx: IoCtx, dst_name: str) -> None:
    """Back out: drop the destination, unfence the source."""
    rbd = RBD()
    dst = await rbd.open(dst_ioctx, dst_name)
    ms = dst.meta.get("migration_source")
    if ms is None:
        raise RadosError(EINVAL, f"{dst_name!r} is not a migration"
                                 " destination")
    if ms.get("state") == "executed":
        raise RadosError(EINVAL, "already executed: commit or keep")
    await dst.close()
    # unfence the source FIRST: if it fails, dst still exists and
    # abort can be retried — the reverse order would strand a
    # permanently write-fenced source with no remaining handle on it
    src_io = IoCtx(dst_ioctx.client, ms["pool_id"])
    src = Image(src_io, ms["name"], ms["image_id"])
    try:
        await src.refresh()
        src.meta.pop("migration", None)
        await src._save()
    except ObjectNotFound:
        pass  # source already gone: nothing to unfence
    await rbd.remove(dst_ioctx, dst_name)  # deregisters the child
