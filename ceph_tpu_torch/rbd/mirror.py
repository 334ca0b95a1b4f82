"""rbd-mirror role: journal-based one-way image replication (port of
ceph_tpu/rbd/mirror.py).

Reference parity: Ceph's src/tools/rbd_mirror/ — the mirror
daemon registers as a client of the primary image's journal, bootstraps
a secondary image (full sync), then tails the journal and replays each
event onto the secondary (ImageReplayer), persisting its position so
replication resumes where it left off and the primary's journal is
only trimmed past every peer's position.

Re-design notes: the reference mirrors across CLUSTERS over its own
RPC; here source and destination are (pool) ioctxs — a second cluster
is just a second RadosClient's ioctx, same code path.  Replay applies
events through the ordinary Image ops (write/discard/resize/snap_*),
so the secondary stays a plain image readable at any moment.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ceph_tpu_torch.common.periodic import PeriodicDaemon
from ceph_tpu_torch.rados.client import IoCtx, RadosError
from ceph_tpu_torch.rbd import RBD, Image
from ceph_tpu_torch.rbd.journal import ImageJournal

log = logging.getLogger("rbd.mirror")


class MirrorReplayer(PeriodicDaemon):
    """Replicates ONE image src -> dst (ImageReplayer role)."""

    def __init__(self, src_ioctx: IoCtx, dst_ioctx: IoCtx,
                 image_name: str, peer_name: str = "mirror"):
        self.src_ioctx = src_ioctx
        self.dst_ioctx = dst_ioctx
        self.image_name = image_name
        self.peer_name = peer_name
        self._rbd = RBD()
        self._tick_what = f"rbd-mirror {image_name}"

    async def _tick(self) -> None:
        await self.replay_once()

    async def bootstrap(self) -> None:
        """Full sync: create the secondary image and copy current
        content, having FIRST registered our journal position — events
        that land during the copy replay afterwards (idempotent), so
        nothing between position-grab and copy-end is lost."""
        src = await self._rbd.open(self.src_ioctx, self.image_name)
        if src._journal is None:
            raise RadosError(-22, f"{self.image_name}: journaling"
                                  " feature required for mirroring")
        # position BEFORE the copy (at-least-once handoff)
        await src._journal.peer_set(self.peer_name,
                                    src._journal.hdr.get("committed",
                                                         0))
        try:
            await self._rbd.open(self.dst_ioctx, self.image_name)
            exists = True
        except Exception:
            exists = False
        if not exists:
            await self._rbd.create(
                self.dst_ioctx, self.image_name, src.size(),
                order=src.meta["order"])
        dst = await self._rbd.open(self.dst_ioctx, self.image_name)
        if dst.size() != src.size():
            await dst.resize(src.size())
        # sparse-aware copy: only objects that exist on the primary
        step = src.object_size
        for objectno in await src.diff_objects():
            off = objectno * step
            span = min(step, src.size() - off)
            if span <= 0:
                continue
            data = await src.read(off, span)
            await dst.write(off, data)
        await src.close()
        await dst.close()

    async def replay_once(self) -> int:
        """One tail-and-apply pass; returns events applied."""
        journal = ImageJournal(self.src_ioctx, await self._image_id())
        pos = await journal.peer_get(self.peer_name)
        events = await journal.events_since(pos)
        if not events:
            return 0
        dst = await self._rbd.open(self.dst_ioctx, self.image_name)
        applied = 0
        try:
            for ev in events:
                await self._apply(dst, ev)
                pos = ev["seq"]
                applied += 1
        finally:
            await dst.close()
            await journal.peer_set(self.peer_name, pos)
        return applied

    async def _image_id(self) -> str:
        directory = await self._rbd._dir(self.src_ioctx)
        image_id = directory.get(self.image_name)
        if image_id is None:
            raise RadosError(-2, self.image_name)
        return image_id

    async def _apply(self, dst: Image, ev) -> None:
        op = ev["op"]
        try:
            if op == "write":
                if ev["offset"] + len(ev["data"]) > dst.size():
                    # a replayed prefix can momentarily lag a resize
                    await dst.resize(ev["offset"] + len(ev["data"]))
                await dst.write(ev["offset"], ev["data"])
            elif op == "discard":
                await dst.discard(ev["offset"], ev["length"])
            elif op == "resize":
                await dst.resize(ev["size"])
            elif op == "snap_create":
                await dst.snap_create(ev["snap_name"])
            elif op == "snap_remove":
                await dst.snap_remove(ev["snap_name"])
            elif op == "snap_rollback":
                await dst.snap_rollback(ev["snap_name"])
        except RadosError as e:
            # at-least-once replay: snap already there / already gone
            # after a crash between apply and position save
            if op.startswith("snap"):
                log.debug("mirror %s: replay %s tolerated: %s",
                          self.image_name, op, e)
            else:
                raise

    # -- continuous mode (the rbd-mirror daemon loop) ----------------------

    # continuous mode: start(interval)/stop() from PeriodicDaemon
