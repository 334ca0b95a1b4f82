"""CephFS subvolumes (the mgr/volumes module role; port of
ceph_tpu/cephfs/volumes.py).

Reference parity: Ceph's src/pybind/mgr/volumes/ — the `fs
subvolume`/`fs subvolumegroup` surface: named, independently managed
directory trees under a conventional /volumes layout, with per-
subvolume metadata, snapshots, and quota bookkeeping; the module is
what CSI drivers and OpenStack Manila drive.

Re-design notes: the module logic runs client-side over the ordinary
CephFS mount (the reference's module also just manipulates paths over
libcephfs from inside the mgr).  Quota is recorded as intent and
enforced at resize/info time by walking the subtree — this build's
MDS has no per-dir byte accounting (rstats gap, documented).
Subvolume snapshots are real CephFS snapshots on the subvolume
directory (.snap machinery)."""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from ceph_tpu_torch.cephfs import CephFS, CephFSError

NOGROUP = "_nogroup"
ROOT = "/volumes"
META = ".meta"

ENOENT = -2
EEXIST = -17
ENOTEMPTY = -39


class VolumeClient:
    """`fs subvolume` / `fs subvolumegroup` operations over a
    mount."""

    def __init__(self, fs: CephFS):
        self.fs = fs

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _group_path(group: Optional[str]) -> str:
        return f"{ROOT}/{group or NOGROUP}"

    def _subvol_path(self, name: str,
                     group: Optional[str] = None) -> str:
        return f"{self._group_path(group)}/{name}"

    async def _mkdirs(self, path: str) -> None:
        parts = [p for p in path.split("/") if p]
        for i in range(len(parts)):
            try:
                await self.fs.mkdir("/" + "/".join(parts[:i + 1]))
            except CephFSError as e:
                if e.rc != EEXIST:
                    raise

    async def _meta(self, path: str) -> Dict[str, Any]:
        try:
            return json.loads(await self.fs.read_file(
                f"{path}/{META}"))
        except CephFSError as e:
            if e.rc != ENOENT:
                raise
            raise CephFSError(ENOENT, f"no subvolume at {path}")

    async def _save_meta(self, path: str, doc: Dict[str, Any]) -> None:
        await self.fs.write_file(f"{path}/{META}",
                                 json.dumps(doc).encode())

    # -- subvolume groups --------------------------------------------------

    async def group_create(self, group: str) -> None:
        await self._mkdirs(self._group_path(group))

    async def group_ls(self) -> List[str]:
        try:
            names = await self.fs.listdir(ROOT)
        except CephFSError as e:
            if e.rc != ENOENT:
                raise
            return []
        return sorted(n for n in names if n != NOGROUP)

    async def group_rm(self, group: str) -> None:
        path = self._group_path(group)
        if await self.fs.listdir(path):
            raise CephFSError(ENOTEMPTY, f"group {group} has"
                                         " subvolumes")
        await self.fs.rmdir(path)

    # -- subvolumes --------------------------------------------------------

    async def create(self, name: str, group: Optional[str] = None,
                     size: Optional[int] = None,
                     mode: int = 0o755) -> str:
        """`fs subvolume create`; returns the data path."""
        path = self._subvol_path(name, group)
        await self._mkdirs(path)
        try:
            await self._meta(path)
            raise CephFSError(EEXIST, f"subvolume {name} exists")
        except CephFSError as e:
            if e.rc != ENOENT:
                raise
        await self._save_meta(path, {
            "name": name, "group": group or NOGROUP,
            "size": size, "mode": mode,
            "created": time.time(), "state": "complete"})
        return path

    async def getpath(self, name: str,
                      group: Optional[str] = None) -> str:
        """`fs subvolume getpath` — the mount path CSI hands out."""
        path = self._subvol_path(name, group)
        await self._meta(path)  # existence check
        return path

    async def ls(self, group: Optional[str] = None) -> List[str]:
        try:
            names = await self.fs.listdir(self._group_path(group))
        except CephFSError as e:
            if e.rc != ENOENT:
                raise
            return []
        return sorted(names)

    async def info(self, name: str,
                   group: Optional[str] = None) -> Dict[str, Any]:
        """`fs subvolume info`: metadata + usage (subtree walk — the
        rstats role done the slow, honest way)."""
        path = self._subvol_path(name, group)
        doc = await self._meta(path)
        used = await self._du(path)
        return dict(doc, path=path, bytes_used=used,
                    bytes_quota=doc.get("size"))

    async def _du(self, path: str) -> int:
        total = 0
        for fname, inode in (await self.fs.readdir(path)).items():
            if inode["type"] == "dir":
                total += await self._du(f"{path}/{fname}")
            elif fname != META:
                total += int(inode.get("size", 0))
        return total

    async def resize(self, name: str, new_size: int,
                     group: Optional[str] = None,
                     no_shrink: bool = False) -> Dict[str, Any]:
        path = self._subvol_path(name, group)
        doc = await self._meta(path)
        used = await self._du(path)
        if no_shrink and doc.get("size") and \
                new_size < int(doc["size"]):
            raise CephFSError(-22, "would shrink (no_shrink set)")
        doc["size"] = int(new_size)
        await self._save_meta(path, doc)
        return {"size": doc["size"], "bytes_used": used}

    async def rm(self, name: str, group: Optional[str] = None,
                 force: bool = False) -> None:
        path = self._subvol_path(name, group)
        try:
            await self._meta(path)
        except CephFSError:
            if not force:
                raise
            # force: a half-created subvolume (dir without .meta) must
            # still be removable — fall through to the tree delete if
            # the directory exists at all
            if not await self.fs.exists(path):
                return
        snaps = await self.fs.lssnap(path)
        if snaps:
            raise CephFSError(ENOTEMPTY,
                              f"subvolume {name} has snapshots")
        await self._rm_tree(path)

    async def _rm_tree(self, path: str) -> None:
        for fname, inode in (await self.fs.readdir(path)).items():
            if inode["type"] == "dir":
                await self._rm_tree(f"{path}/{fname}")
            else:
                await self.fs.unlink(f"{path}/{fname}")
        await self.fs.rmdir(path)

    # -- subvolume snapshots (`fs subvolume snapshot *`) -------------------

    async def snapshot_create(self, name: str, snap: str,
                              group: Optional[str] = None) -> None:
        path = self._subvol_path(name, group)
        await self._meta(path)
        await self.fs.mksnap(path, snap)

    async def snapshot_ls(self, name: str,
                          group: Optional[str] = None
                          ) -> List[Dict[str, Any]]:
        path = self._subvol_path(name, group)
        await self._meta(path)
        return await self.fs.lssnap(path)

    async def snapshot_rm(self, name: str, snap: str,
                          group: Optional[str] = None) -> None:
        path = self._subvol_path(name, group)
        await self.fs.rmsnap(path, snap)
