"""Run an MDS as a real process: python -m ceph_tpu_torch.mds (port of
ceph_tpu/mds/__main__.py).

Prints `MDS_ADDR <host:port>` once bound (ceph-helpers run_mds role).
The daemon starts standby and becomes active when it wins the
mds_lock; standbys take over from a dead active automatically.
"""

from __future__ import annotations

import argparse
import asyncio
import sys

from ceph_tpu_torch.mds import MDSDaemon


async def _main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mon", type=str, required=True)
    ap.add_argument("--name", type=str, default="a")
    ap.add_argument("--metadata-pool", type=str, default="cephfs.meta")
    ap.add_argument("--data-pool", type=str, default="cephfs.data")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--secret", type=str, default="",
                    help="cluster cephx keyring")
    ap.add_argument("--secure", action="store_true",
                    help="on-wire encryption (requires --secret)")
    args = ap.parse_args()
    mds = MDSDaemon(args.mon, args.metadata_pool, args.data_pool,
                    name=args.name, secret=args.secret or None,
                    secure=args.secure)
    addr = await mds.start(port=args.port)
    print(f"MDS_ADDR {addr}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await mds.stop()


if __name__ == "__main__":
    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        sys.exit(0)
