"""`rbd` CLI parity: block-image admin against a live cluster (port of
ceph_tpu/tools/rbd.py).

Reference: Ceph's src/tools/rbd/ — the block-storage
workhorse CLI: create/ls/info/rm, resize, snapshot management
(create/ls/protect/unprotect/rollback/rm), clone/flatten/children,
export/import, and mirroring control.  One process, one command.

Usage examples:
  python -m ceph_tpu_torch.tools.rbd -m HOST:PORT -p rbd create img --size 64M
  python -m ceph_tpu_torch.tools.rbd -m HOST:PORT -p rbd ls
  python -m ceph_tpu_torch.tools.rbd -m HOST:PORT -p rbd info img
  python -m ceph_tpu_torch.tools.rbd -m HOST:PORT -p rbd snap create img@s1
  python -m ceph_tpu_torch.tools.rbd -m HOST:PORT -p rbd snap protect img@s1
  python -m ceph_tpu_torch.tools.rbd -m HOST:PORT -p rbd clone img@s1 child
  python -m ceph_tpu_torch.tools.rbd -m HOST:PORT -p rbd flatten child
  python -m ceph_tpu_torch.tools.rbd -m HOST:PORT -p rbd export img ./img.bin
  python -m ceph_tpu_torch.tools.rbd -m HOST:PORT -p rbd import ./img.bin img2
  python -m ceph_tpu_torch.tools.rbd -m HOST:PORT -p rbd mirror img --dst-pool backup
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ceph_tpu_torch.rados.client import RadosClient, RadosError
from ceph_tpu_torch.rbd import RBD, Image
from ceph_tpu_torch.tools import fileio


def _size(text: str) -> int:
    """64M / 1G / 4096 -> bytes."""
    text = text.strip().upper()
    mult = 1
    for suffix, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30),
                      ("T", 1 << 40)):
        if text.endswith(suffix):
            mult, text = m, text[:-1]
            break
    return int(float(text) * mult)


def _img_snap(spec: str):
    """img[@snap] -> (img, snap|None)."""
    name, _, snap = spec.partition("@")
    return name, (snap or None)


async def _run(args) -> int:
    client = RadosClient(args.mon, secret=args.secret or None)
    await client.connect()
    try:
        ioctx = client.open_ioctx(args.pool)
        rbd = RBD()
        return await _dispatch(client, ioctx, rbd, args)
    finally:
        await client.shutdown()


async def _dispatch(client, ioctx, rbd: RBD, args) -> int:
    cmd = args.cmd
    if cmd == "create":
        await rbd.create(ioctx, args.image, _size(args.size),
                         order=args.order,
                         data_pool=args.data_pool,
                         exclusive_lock=args.exclusive_lock
                         or args.object_map or args.journaling,
                         object_map=args.object_map,
                         journaling=args.journaling)
        return 0
    if cmd == "ls":
        for name in await rbd.list(ioctx):
            print(name)
        return 0
    if cmd == "rm":
        await rbd.remove(ioctx, args.image)
        return 0
    if cmd == "info":
        img = await rbd.open(ioctx, args.image)
        meta = img.meta
        doc = {"name": args.image, "id": img.id,
               "size": meta["size"], "order": meta["order"],
               "object_size": img.object_size,
               "features": meta.get("features", []),
               "data_pool": meta.get("data_pool"),
               "snapshots": sorted(meta.get("snaps", {})),
               }
        if meta.get("parent"):
            p = meta["parent"]
            doc["parent"] = (f"pool{p['pool_id']}/"
                             f"{p['image_id']}@{p['snap_name']}")
        await img.close()
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0
    if cmd == "resize":
        img = await rbd.open(ioctx, args.image)
        await img.resize(_size(args.size))
        await img.close()
        return 0
    if cmd == "snap":
        return await _snap(ioctx, rbd, args)
    if cmd == "clone":
        parent, snap = _img_snap(args.parent)
        if snap is None:
            print("clone needs parent@snap", file=sys.stderr)
            return 22
        await rbd.clone(ioctx, parent, snap, ioctx, args.child,
                        data_pool=args.data_pool)
        return 0
    if cmd == "flatten":
        img = await rbd.open(ioctx, args.image)
        await img.flatten()
        await img.close()
        return 0
    if cmd == "children":
        img = await rbd.open(ioctx, args.image)
        for child in img.meta.get("children", []):
            print(f"pool{child['pool_id']}/{child['image_id']}"
                  f"@{child['snap_name']}")
        await img.close()
        return 0
    if cmd == "export":
        name, snap = _img_snap(args.image)
        img = await rbd.open(ioctx, name)
        if snap:
            img.snap_set(snap)
        out = sys.stdout.buffer if args.path == "-" \
            else await fileio.open_file(args.path, "wb")
        try:
            step = img.object_size
            total = img.size()
            for off in range(0, total, step):
                chunk = await img.read(off, min(step, total - off))
                await asyncio.to_thread(out.write, chunk)
        finally:
            if out is not sys.stdout.buffer:
                await asyncio.to_thread(out.close)  # flush off-loop
            await img.close()
        return 0
    if cmd == "import":
        data = await fileio.read_stdin() if args.path == "-" \
            else await fileio.read_bytes(args.path)
        await rbd.create(ioctx, args.image, len(data),
                         order=args.order)
        img = await rbd.open(ioctx, args.image)
        step = img.object_size
        for off in range(0, len(data), step):
            await img.write(off, data[off:off + step])
        await img.close()
        return 0
    if cmd == "mirror":
        from ceph_tpu_torch.rbd.mirror import MirrorReplayer

        dst_io = client.open_ioctx(args.dst_pool)
        m = MirrorReplayer(ioctx, dst_io, args.image)
        await m.bootstrap()
        applied = await m.replay_once()
        print(json.dumps({"bootstrapped": True,
                          "events_replayed": applied}))
        return 0
    if cmd == "deep-cp":
        from ceph_tpu_torch.rbd.migrate import deep_copy

        dst_io = client.open_ioctx(args.dest_pool) \
            if args.dest_pool else ioctx
        new_id = await deep_copy(ioctx, args.image, dst_io,
                                 args.dest, data_pool=args.data_pool)
        print(json.dumps({"id": new_id}))
        return 0
    if cmd == "migration":
        from ceph_tpu_torch.rbd import migrate as _mg

        dst_io = client.open_ioctx(args.dest_pool) \
            if args.dest_pool else ioctx
        if args.verb == "prepare":
            if not args.dest:
                print("migration prepare needs a dest image",
                      file=sys.stderr)
                return 22
            new_id = await _mg.migration_prepare(
                ioctx, args.image, dst_io, args.dest,
                data_pool=args.data_pool)
            print(json.dumps({"id": new_id, "state": "prepared"}))
            return 0
        fn = {"execute": _mg.migration_execute,
              "commit": _mg.migration_commit,
              "abort": _mg.migration_abort}[args.verb]
        await fn(dst_io, args.image)
        print(json.dumps({"state": args.verb}))
        return 0
    if cmd == "bench":
        return await _bench(ioctx, rbd, args)
    if cmd == "replay":
        from ceph_tpu_torch.rbd.replay import replay_trace

        img = await rbd.open(ioctx, args.image)
        # stream the trace off-loop in bounded batches: traces can be
        # multi-GiB, and a sync file handle would block the loop
        stats = await replay_trace(fileio.iter_lines(args.trace), img,
                                   speed=args.speed)
        await img.close()
        print(json.dumps(stats))
        return 0
    if cmd == "trash":
        if args.verb == "mv":
            image_id = await rbd.trash_mv(ioctx, args.target,
                                          delay=args.delay)
            print(json.dumps({"id": image_id}))
        elif args.verb == "ls":
            for e in await rbd.trash_ls(ioctx):
                print(json.dumps(e))
        elif args.verb == "restore":
            name = await rbd.trash_restore(ioctx, args.target,
                                           new_name=args.name)
            print(json.dumps({"name": name}))
        elif args.verb == "rm":
            await rbd.trash_rm(ioctx, args.target, force=args.force)
        elif args.verb == "purge":
            n = await rbd.trash_purge(ioctx)
            print(json.dumps({"removed": n}))
        return 0
    print(f"unknown command {cmd}", file=sys.stderr)
    return 22


async def _snap(ioctx, rbd: RBD, args) -> int:
    name, snap = _img_snap(args.spec)
    img = await rbd.open(ioctx, name)
    try:
        verb = args.verb
        if verb == "ls":
            for s in await img.snap_list():
                print(json.dumps(s))
            return 0
        if snap is None:
            print("need image@snap", file=sys.stderr)
            return 22
        if verb == "create":
            await img.snap_create(snap)
        elif verb == "rm":
            await img.snap_remove(snap)
        elif verb == "protect":
            await img.snap_protect(snap)
        elif verb == "unprotect":
            await img.snap_unprotect(snap)
        elif verb == "rollback":
            await img.snap_rollback(snap)
        else:
            print(f"unknown snap verb {verb}", file=sys.stderr)
            return 22
        return 0
    finally:
        await img.close()


async def _bench(ioctx, rbd: RBD, args) -> int:
    """`rbd bench` (tools/rbd/action/Bench.cc role): drive the image
    with N concurrent sequential/random IOs and report ops/s, MB/s."""
    import time as _time

    io_size = _size(args.io_size)
    total = _size(args.io_total)
    img = await rbd.open(ioctx, args.image)
    if img.size() < io_size:
        print("image smaller than --io-size", file=sys.stderr)
        return 22
    ops = max(1, total // io_size)
    span = img.size() - io_size
    # deterministic LCG offsets for rand (no retry loops, replayable)
    state = 0x5DEECE66D

    def offsets():
        nonlocal state
        pos = 0
        for _ in range(ops):
            if args.io_pattern == "rand":
                state = (state * 6364136223846793005 + 1442695040888963407) \
                    & ((1 << 64) - 1)
                yield (state >> 16) % (span + 1) if span else 0
            else:
                yield pos
                pos = (pos + io_size) % (span + 1 if span else 1)

    payload = bytes(io_size)
    sem = asyncio.Semaphore(args.io_threads)
    did = {"read": 0, "write": 0}
    target = img
    trace_fh = None
    if getattr(args, "trace", None):
        from ceph_tpu_torch.rbd.replay import ImageTracer

        trace_fh = open(args.trace, "w")
        target = ImageTracer(img, trace_fh)

    async def one(i: int, off: int) -> None:
        async with sem:
            write = args.io_type == "write" or (
                args.io_type == "readwrite" and i % 2 == 0)
            if write:
                await target.write(off, payload)
                did["write"] += 1
            else:
                await target.read(off, io_size)
                did["read"] += 1

    t0 = _time.perf_counter()
    await asyncio.gather(*(one(i, off)
                           for i, off in enumerate(offsets())))
    dt = _time.perf_counter() - t0
    await target.close()
    if trace_fh is not None:
        trace_fh.close()
    print(json.dumps({
        "io_type": args.io_type, "io_size": io_size, "ops": ops,
        "reads": did["read"], "writes": did["write"],
        "elapsed_s": round(dt, 4),
        "ops_per_sec": round(ops / dt, 2),
        "mb_per_sec": round(ops * io_size / dt / (1 << 20), 2)}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rbd")
    ap.add_argument("-m", "--mon", required=True)
    ap.add_argument("-p", "--pool", default="rbd")
    ap.add_argument("--secret", default="")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create")
    c.add_argument("image")
    c.add_argument("--size", required=True)
    c.add_argument("--order", type=int, default=22)
    c.add_argument("--data-pool", default=None)
    c.add_argument("--exclusive-lock", action="store_true")
    c.add_argument("--object-map", action="store_true")
    c.add_argument("--journaling", action="store_true")

    sub.add_parser("ls")
    for name in ("rm", "info", "flatten", "children"):
        sp = sub.add_parser(name)
        sp.add_argument("image")
    r = sub.add_parser("resize")
    r.add_argument("image")
    r.add_argument("--size", required=True)
    s = sub.add_parser("snap")
    s.add_argument("verb",
                   choices=["create", "ls", "rm", "protect",
                            "unprotect", "rollback"])
    s.add_argument("spec", help="image or image@snap")
    cl = sub.add_parser("clone")
    cl.add_argument("parent", help="image@snap")
    cl.add_argument("child")
    cl.add_argument("--data-pool", default=None)
    e = sub.add_parser("export")
    e.add_argument("image", help="image or image@snap")
    e.add_argument("path")
    i = sub.add_parser("import")
    i.add_argument("path")
    i.add_argument("image")
    i.add_argument("--order", type=int, default=22)
    mi = sub.add_parser("mirror")
    mi.add_argument("image")
    mi.add_argument("--dst-pool", required=True)
    dc = sub.add_parser("deep-cp")
    dc.add_argument("image")
    dc.add_argument("dest")
    dc.add_argument("--dest-pool", default=None)
    dc.add_argument("--data-pool", default=None)
    mg = sub.add_parser("migration")
    mg.add_argument("verb", choices=["prepare", "execute",
                                     "commit", "abort"])
    mg.add_argument("image")
    mg.add_argument("dest", nargs="?", default=None,
                    help="dest image (prepare only)")
    mg.add_argument("--dest-pool", default=None)
    mg.add_argument("--data-pool", default=None)
    be = sub.add_parser("bench")
    be.add_argument("image")
    be.add_argument("--io-type", choices=["write", "read",
                                          "readwrite"],
                    default="write")
    be.add_argument("--io-size", default="4K")
    be.add_argument("--io-total", default="16M")
    be.add_argument("--io-pattern", choices=["seq", "rand"],
                    default="seq")
    be.add_argument("--io-threads", type=int, default=16)
    be.add_argument("--trace", default=None,
                    help="record the workload as a JSONL trace")
    rp = sub.add_parser("replay")
    rp.add_argument("trace")
    rp.add_argument("image")
    rp.add_argument("--speed", type=float, default=1.0,
                    help="pacing multiplier (0 = full speed)")
    tr = sub.add_parser("trash")
    tr.add_argument("verb", choices=["mv", "ls", "restore", "rm",
                                     "purge"])
    tr.add_argument("target", nargs="?", default="",
                    help="image name (mv) or image id (restore/rm)")
    tr.add_argument("--delay", type=float, default=0.0)
    tr.add_argument("--force", action="store_true")
    tr.add_argument("--name", default=None,
                    help="restore under a different name")

    args = ap.parse_args(argv)
    try:
        return asyncio.run(_run(args))
    except RadosError as e:
        print(f"rbd: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
