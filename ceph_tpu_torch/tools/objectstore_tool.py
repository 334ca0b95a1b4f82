"""ceph-objectstore-tool parity: offline object-store surgery (port of
ceph_tpu/tools/objectstore_tool.py).

Reference: the reference's src/tools/ceph_objectstore_tool.cc — open a
stopped OSD's store directly and list/extract/remove objects, dump
attrs/omap, list PGs.  The daemon must NOT be running on the store
(single-writer mount, like the reference's fsck-style open).

The store's blob csums are verified on the device the tool runs on: CUDA
unless `--device` (or `main`'s `device=`) names another, e.g. `cpu`; no
CUDA and no device raises.  The output is the JAX tool's, byte for byte.

Usage:
  python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR
    [--device DEV] op
    where op: list-pgs | list [--cid CID] | info --cid C --obj O |
    get-bytes --cid C --obj O [--file F] | dump-omap --cid C --obj O |
    get-attrs --cid C --obj O | remove --cid C --obj O | fsck
"""

from __future__ import annotations

import argparse
import json
import sys

from ceph_tpu_torch.os import ObjectId, Transaction
from ceph_tpu_torch.os.tpustore import TPUStore


def _out(obj) -> None:
    print(json.dumps(obj, indent=2, sort_keys=True))


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(prog="objectstore-tool")
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--device", default=None,
                    help="where blob csums are verified (default: cuda)")
    sub = ap.add_subparsers(dest="op", required=True)
    sub.add_parser("list-pgs")
    ls = sub.add_parser("list")
    ls.add_argument("--cid", default="")
    for name in ("info", "get-bytes", "dump-omap", "get-attrs",
                 "remove"):
        p = sub.add_parser(name)
        p.add_argument("--cid", required=True)
        p.add_argument("--obj", required=True)
        if name == "get-bytes":
            p.add_argument("--file", default="-")
    sub.add_parser("fsck")
    args = ap.parse_args(argv)

    store = TPUStore(args.data_path,
                     device=args.device if args.device else device)
    store.mount()
    try:
        return _dispatch(store, args)
    finally:
        store.umount()


def _dispatch(store: TPUStore, args) -> int:
    if args.op == "list-pgs":
        # pg collections are "<pool>.<ps hex>[s<shard>]_head"
        for cid in sorted(store.list_collections()):
            if cid.endswith("_head"):
                print(cid)
        return 0
    if args.op == "list":
        cids = [args.cid] if args.cid else \
            sorted(store.list_collections())
        for cid in cids:
            for oid in sorted(str(o) for o in store.list_objects(cid)):
                print(json.dumps([cid, oid]))
        return 0
    if args.op == "fsck":
        # walk everything; broken reads surface as errors
        problems = []
        n_objects = 0
        for cid in store.list_collections():
            for obj in store.list_objects(cid):
                n_objects += 1
                try:
                    store.read(cid, obj)
                    store.getattrs(cid, obj)
                except Exception as e:
                    problems.append([cid, str(obj), repr(e)])
        _out({"objects": n_objects, "errors": problems})
        return 0 if not problems else 1
    oid = ObjectId(args.obj)
    if args.op == "info":
        data = store.read(args.cid, oid)
        attrs = store.getattrs(args.cid, oid)
        _out({"cid": args.cid, "oid": args.obj, "size": len(data),
              "attrs": {k: v.decode("latin-1")
                        for k, v in sorted(attrs.items())}})
        return 0
    if args.op == "get-bytes":
        data = store.read(args.cid, oid)
        if args.file == "-":
            sys.stdout.buffer.write(data)
        else:
            with open(args.file, "wb") as f:
                f.write(data)
        return 0
    if args.op == "dump-omap":
        _out({k: v.decode("latin-1")
              for k, v in sorted(store.omap_get(args.cid,
                                                oid).items())})
        return 0
    if args.op == "get-attrs":
        _out({k: v.decode("latin-1")
              for k, v in sorted(store.getattrs(args.cid,
                                                oid).items())})
        return 0
    if args.op == "remove":
        t = Transaction()
        t.remove(args.cid, oid)
        store.queue_transaction(t)
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
