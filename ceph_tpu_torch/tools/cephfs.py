"""cephfs CLI: drive a CephFS filesystem from the shell (port of
ceph_tpu/tools/cephfs.py).

Reference parity: the cephfs-shell tool + the `ceph fs subvolume`
command family (Ceph's src/tools/cephfs/shell,
src/pybind/mgr/volumes) collapsed onto one non-interactive CLI:
namespace ops, file transfer, snapshots (.snap surface), and
subvolume management.

    python -m ceph_tpu_torch.tools.cephfs -m MON ls /
    ... put local.bin /dir/file     get /dir/file out.bin
    ... snap create /dir name       snap ls /dir
    ... subvolume create name --group g
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ceph_tpu_torch.cephfs import CephFS, CephFSError
from ceph_tpu_torch.rados.client import RadosClient
from ceph_tpu_torch.tools import fileio


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cephfs")
    ap.add_argument("-m", "--mon", required=True)
    ap.add_argument("--meta", default="cephfs.meta")
    ap.add_argument("--data", default="cephfs.data")
    ap.add_argument("--secret", default="")
    sub = ap.add_subparsers(dest="cmd", required=True)

    for name in ("ls", "stat", "rmdir", "rm", "cat"):
        p = sub.add_parser(name)
        p.add_argument("path")
    mk = sub.add_parser("mkdir")
    mk.add_argument("path")
    mk.add_argument("-p", "--parents", action="store_true")
    mv = sub.add_parser("mv")
    mv.add_argument("src")
    mv.add_argument("dst")
    pu = sub.add_parser("put")
    pu.add_argument("local", help="local file, or - for stdin")
    pu.add_argument("path")
    ge = sub.add_parser("get")
    ge.add_argument("path")
    ge.add_argument("local", help="local file, or - for stdout")
    sn = sub.add_parser("snap")
    sn.add_argument("verb", choices=["create", "ls", "rm"])
    sn.add_argument("path")
    sn.add_argument("name", nargs="?", default="")
    sv = sub.add_parser("subvolume")
    sv.add_argument("verb", choices=["create", "ls", "rm", "getpath",
                                     "info", "resize"])
    sv.add_argument("name", nargs="?", default="")
    sv.add_argument("--group", default=None)
    sv.add_argument("--size", type=int, default=None)

    args = ap.parse_args(argv)
    try:
        return asyncio.run(_run(args))
    except CephFSError as e:
        print(f"cephfs: {e}", file=sys.stderr)
        return 1


async def _run(args) -> int:
    client = RadosClient(args.mon, secret=args.secret or None)
    await client.connect()
    try:
        fs = CephFS(client, args.meta, args.data)
        return await _dispatch(fs, args)
    finally:
        await client.shutdown()


async def _mkdirs(fs: CephFS, path: str) -> None:
    parts = [p for p in path.split("/") if p]
    for i in range(len(parts)):
        try:
            await fs.mkdir("/" + "/".join(parts[:i + 1]))
        except CephFSError as e:
            if e.rc != -17:  # EEXIST
                raise


async def _dispatch(fs: CephFS, args) -> int:
    cmd = args.cmd
    if cmd == "ls":
        for name, inode in sorted(
                (await fs.readdir(args.path)).items()):
            kind = {"dir": "d", "symlink": "l"}.get(
                inode.get("type"), "-")
            print(f"{kind} {inode.get('size', 0):>10} {name}")
        return 0
    if cmd == "stat":
        print(json.dumps(await fs.stat(args.path), sort_keys=True))
        return 0
    if cmd == "mkdir":
        if args.parents:
            await _mkdirs(fs, args.path)
        else:
            await fs.mkdir(args.path)
        return 0
    if cmd == "rmdir":
        await fs.rmdir(args.path)
        return 0
    if cmd == "rm":
        await fs.unlink(args.path)
        return 0
    if cmd == "mv":
        await fs.rename(args.src, args.dst)
        return 0
    if cmd == "put":
        data = await fileio.read_stdin() if args.local == "-" else \
            await fileio.read_bytes(args.local)
        await fs.write_file(args.path, data)
        return 0
    if cmd in ("get", "cat"):
        data = await fs.read_file(args.path)
        if cmd == "cat" or args.local == "-":
            sys.stdout.buffer.write(data)
        else:
            await fileio.write_bytes(args.local, data)
        return 0
    if cmd == "snap":
        if args.verb == "create":
            snapid = await fs.mksnap(args.path, args.name)
            print(json.dumps({"snapid": snapid}))
        elif args.verb == "ls":
            for s in await fs.lssnap(args.path):
                print(json.dumps(s))
        elif args.verb == "rm":
            await fs.rmsnap(args.path, args.name)
        return 0
    if cmd == "subvolume":
        from ceph_tpu_torch.cephfs.volumes import VolumeClient

        vc = VolumeClient(fs)
        if args.verb == "create":
            path = await vc.create(args.name, group=args.group,
                                   size=args.size)
            print(json.dumps({"path": path}))
        elif args.verb == "ls":
            print(json.dumps(await vc.ls(group=args.group)))
        elif args.verb == "rm":
            await vc.rm(args.name, group=args.group)
        elif args.verb == "getpath":
            print(await vc.getpath(args.name, group=args.group))
        elif args.verb == "info":
            print(json.dumps(await vc.info(args.name,
                                           group=args.group),
                             sort_keys=True))
        elif args.verb == "resize":
            if args.size is None:
                print("resize needs --size", file=sys.stderr)
                return 22
            print(json.dumps(await vc.resize(args.name, args.size,
                                             group=args.group)))
        return 0
    print(f"unknown command {cmd}", file=sys.stderr)
    return 22


if __name__ == "__main__":
    sys.exit(main())
