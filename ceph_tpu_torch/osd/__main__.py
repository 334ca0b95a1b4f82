"""Run an OSD daemon as a real process: python -m ceph_tpu_torch.osd (port
of ceph_tpu/osd/__main__.py).

    python -m ceph_tpu_torch.osd --id N --mon ADDR [--store-path P]
        [--device D] [--port PORT] [--config JSON]

With --store-path the OSD hosts a persistent TPUStore (survives the
process, like an OSD's disk); without it, an in-memory MemStore.  The
OSD's codecs and store run on --device: CUDA unless another is named,
and the process fails when CUDA is missing and no device is given.
Prints `OSD_ADDR <host:port>` once booted into the map.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import sys

from ceph_tpu_torch.common import flags
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.os.memstore import MemStore
from ceph_tpu_torch.osd.daemon import OSDDaemon


async def _main() -> None:
    if flags.get("CEPH_TPU_DEBUG"):
        logging.basicConfig(level=logging.DEBUG)
    ap = argparse.ArgumentParser()
    ap.add_argument("--id", type=int, required=True)
    ap.add_argument("--mon", type=str, required=True)
    ap.add_argument("--store-path", type=str, default="")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of the codecs and the store"
                         " (default: cuda)")
    ap.add_argument("--config", type=str, default="{}",
                    help="JSON osd config overrides")
    args = ap.parse_args()
    try:
        device = resolve_device(args.device)
        if args.store_path:
            from ceph_tpu_torch.os.tpustore import TPUStore

            store = TPUStore(args.store_path, device=device)
            if not os.path.exists(os.path.join(args.store_path,
                                               "block")):
                os.makedirs(args.store_path, exist_ok=True)
                store.mkfs()
            store.mount()
        else:
            store = MemStore()
            store.mkfs()
            store.mount()
        osd = OSDDaemon(args.id, args.mon, store=store,
                        config=json.loads(args.config), device=device)
        addr = await osd.start(port=args.port)
    except (KeyboardInterrupt, asyncio.CancelledError):
        raise
    except BaseException as e:
        # boot died (no device, bad store, bind failure, mount
        # corruption): post a crash report before exiting (the
        # ceph-crash role) — best-effort over a FRESH connection, never
        # masks the error
        from ceph_tpu_torch.common.crash import post_crash

        await post_crash(args.mon, f"osd.{args.id}", e)
        raise
    print(f"OSD_ADDR {addr}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await osd.stop()
        store.umount()


if __name__ == "__main__":
    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        sys.exit(0)
