"""cephfs-mirror role: snapshot-based one-way directory replication (port
of ceph_tpu/cephfs/mirror.py).

Reference parity: Ceph's src/tools/cephfs_mirror/ — the
mirror daemon watches a source directory's snapshots and incrementally
replicates each new snapshot to a remote filesystem, creating the
same-named snapshot there once the content matches; snapshots deleted
at the source are pruned from the remote (PeerReplayer
do_synchronize/propagate_snap_deletes).

Re-design notes: source and destination are CephFS mounts — a second
cluster is just a second RadosClient's mount, same code path (the
rbd-mirror stance).  Sync is SNAPSHOT-DIFF: the first snapshot is a
full tree copy; every later one walks the source snapshot against the
PREVIOUS source snapshot and only touches entries whose (ino, type,
size, mtime) changed — the remote head is then frozen with mksnap.
The remote directory is mirror-managed: out-of-band writes to it
between syncs may be clobbered or shadow-deleted, as with the
reference's requirement that the peer path be dedicated to the
mirror.  Overwrites that change neither size nor mtime are invisible
to the diff (the client's buffered-attr discipline never surfaces
them); the reference's ctime heuristic shares this blind spot.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional

from ceph_tpu_torch.cephfs import CephFS, CephFSError
from ceph_tpu_torch.common.periodic import PeriodicDaemon

log = logging.getLogger("cephfs.mirror")

ENOENT = -2


class DirMirror(PeriodicDaemon):
    """Replicates ONE directory's snapshots src -> dst (the
    PeerReplayer role)."""

    def __init__(self, src: CephFS, dst: CephFS, path: str):
        self.src = src
        self.dst = dst
        self.path = "/" + "/".join(p for p in path.split("/") if p)
        self._tick_what = f"cephfs-mirror {self.path}"
        # observability
        self.snaps_synced = 0
        self.files_copied = 0
        self.entries_deleted = 0

    async def _tick(self) -> None:
        await self.sync_once()

    # -- one sync pass -----------------------------------------------------

    async def sync_once(self) -> int:
        """Replicate every source snapshot the destination lacks (in
        snapid order) and prune destination snapshots the source
        dropped.  Returns the number of snapshots created.

        Snapshot identity is (name, SOURCE snapid), not name alone:
        the synced source snapid is recorded remotely (a state file
        beside — never inside — the mirrored tree, the reference's
        peer snap metadata role), so a snapshot deleted and re-created
        under the same name between passes is detected and re-synced."""
        src_snaps = await self.src.lssnap(self.path)
        src_snaps.sort(key=lambda s: s["snapid"])
        try:
            dst_have = {s["name"]
                        for s in await self.dst.lssnap(self.path)}
        except CephFSError as e:
            if e.rc != ENOENT:
                raise
            await self._ensure_dir(self.dst, self.path)
            dst_have = set()
        synced_ids = await self._load_state()
        src_ids = {s["name"]: s["snapid"] for s in src_snaps}
        # prune: dropped at the source, or re-created under an old name
        pruned = False
        for name in sorted(dst_have):
            if name in src_ids and \
                    synced_ids.get(name, src_ids[name]) == \
                    src_ids[name]:
                continue
            await self.dst.rmsnap(self.path, name)
            dst_have.discard(name)
            synced_ids.pop(name, None)
            pruned = True
        created = 0
        prev: Optional[str] = None
        for snap in src_snaps:
            name = snap["name"]
            if name in dst_have:
                prev = name  # diff base for the next new snapshot
                continue
            await self._sync_tree(
                self._snap_root(name),
                self.path,
                self._snap_root(prev) if prev else None)
            await self.dst.mksnap(self.path, name)
            synced_ids[name] = snap["snapid"]
            await self._save_state(synced_ids)
            self.snaps_synced += 1
            created += 1
            prev = name
        if created == 0 and pruned:
            # state changed only by pruning; an idle pass writes
            # nothing to the destination
            await self._save_state(synced_ids)
        return created

    # remote bookkeeping: which SOURCE snapid each remote snapshot was
    # synced from — kept OUTSIDE the mirrored tree so the sync's
    # delete-extraneous pass never eats it

    def _state_path(self) -> str:
        tag = self.path.strip("/").replace("/", "_") or "root"
        return f"/.cephfs-mirror/{tag}.json"

    async def _load_state(self) -> Dict[str, int]:
        import json
        try:
            raw = await self.dst.read_file(self._state_path())
            return {k: int(v) for k, v in json.loads(raw).items()}
        except (CephFSError, ValueError):
            return {}

    async def _save_state(self, ids: Dict[str, int]) -> None:
        import json
        await self._ensure_dir(self.dst, "/.cephfs-mirror")
        await self.dst.write_file(self._state_path(),
                                  json.dumps(ids).encode())

    def _snap_root(self, snap_name: str) -> str:
        return f"{self.path}/.snap/{snap_name}" if self.path != "/" \
            else f"/.snap/{snap_name}"

    @staticmethod
    async def _ensure_dir(fs: CephFS, path: str) -> None:
        parts = [p for p in path.split("/") if p]
        for i in range(len(parts)):
            sub = "/" + "/".join(parts[:i + 1])
            try:
                await fs.mkdir(sub)
            except CephFSError as e:
                if e.rc != -17:  # EEXIST
                    raise

    async def _sync_tree(self, src_dir: str, dst_dir: str,
                         prev_dir: Optional[str]) -> None:
        """Make dst_dir (head) match src_dir (a snapshot view),
        diffing against prev_dir (the previously synced snapshot view)
        to skip unchanged entries."""
        src_entries = await self.src.readdir(src_dir)
        at_dst_root = dst_dir == "/"
        if at_dst_root:
            # only when mirroring INTO the root does the state dir
            # live inside the synced tree; deeper a ".cephfs-mirror"
            # entry is ordinary user data and must replicate
            src_entries.pop(".cephfs-mirror", None)
        prev_entries: Dict[str, dict] = {}
        if prev_dir is not None:
            try:
                prev_entries = await self.src.readdir(prev_dir)
            except CephFSError:
                prev_entries = {}
        try:
            dst_entries = await self.dst.readdir(dst_dir)
        except CephFSError as e:
            if e.rc != ENOENT:
                raise
            await self._ensure_dir(self.dst, dst_dir)
            dst_entries = {}
        if at_dst_root:
            dst_entries.pop(".cephfs-mirror", None)
        # remove entries the source snapshot does not have
        for name in sorted(set(dst_entries) - set(src_entries)):
            await self._rm_tree(f"{dst_dir}/{name}")
        for name, inode in sorted(src_entries.items()):
            src_p = f"{src_dir}/{name}"
            dst_p = f"{dst_dir}/{name}"
            prev_i = prev_entries.get(name)
            kind = inode["type"]
            existed = name in dst_entries
            if existed and dst_entries[name].get("type") != kind:
                # type flip (file <-> dir <-> symlink) — judged against
                # the DESTINATION's actual type, so it triggers even
                # with no diff base: start clean
                await self._rm_tree(dst_p)
                existed = False
                prev_i = None
            if kind == "dir":
                if not existed:
                    try:
                        await self.dst.mkdir(dst_p)
                    except CephFSError as e:
                        if e.rc != -17:
                            raise
                await self._sync_tree(
                    src_p, dst_p,
                    f"{prev_dir}/{name}"
                    if prev_dir is not None and prev_i is not None
                    else None)
            elif kind == "symlink":
                target = await self.src.readlink(src_p)
                if existed:
                    try:
                        if await self.dst.readlink(dst_p) == target:
                            continue
                    except CephFSError:
                        pass
                    await self._rm_tree(dst_p)
                await self.dst.symlink(target, dst_p)
            else:  # file
                if existed and prev_i is not None and \
                        self._unchanged(prev_i, inode):
                    continue
                data = await self.src.read_file(src_p)
                await self.dst.write_file(dst_p, data)
                if len(data) < int(inode.get("size", 0)):
                    # sparse tail: size recorded past written blocks
                    await self.dst.truncate(dst_p,
                                            int(inode["size"]))
                self.files_copied += 1

    @staticmethod
    def _unchanged(prev_i: dict, cur_i: dict) -> bool:
        return (prev_i.get("ino") == cur_i.get("ino")
                and prev_i.get("size") == cur_i.get("size")
                and prev_i.get("mtime") == cur_i.get("mtime"))

    async def _rm_tree(self, path: str) -> None:
        try:
            st = await self.dst.stat(path)
        except CephFSError as e:
            if e.rc == ENOENT:
                return
            raise
        if st["type"] == "dir":
            for name in await self.dst.listdir(path):
                await self._rm_tree(f"{path}/{name}")
            await self.dst.rmdir(path)
        else:
            await self.dst.unlink(path)
        self.entries_deleted += 1

