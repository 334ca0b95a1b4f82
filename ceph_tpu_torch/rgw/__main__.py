"""Run the S3 gateway as a real process: python -m ceph_tpu_torch.rgw (port
of ceph_tpu/rgw/__main__.py).

    python -m ceph_tpu_torch.rgw --mon ADDR --access-key AK --secret-key SK
        [--port PORT] [--data-pool P] [--meta-pool P] [--device D]

The radosgw role: connects to the cluster, serves S3-over-HTTP with
sigv4 auth.  The gateway's RADOS client runs on --device (its
read-then-compute legs): CUDA unless another is named, and the process
fails when CUDA is missing and no device is given.  Prints
`RGW_ADDR <host:port>` once bound.
"""

from __future__ import annotations

import argparse
import asyncio
import sys

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.rados.client import RadosClient
from ceph_tpu_torch.rgw import RGWLite
from ceph_tpu_torch.rgw.s3_frontend import S3Frontend


async def _main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mon", type=str, required=True,
                    help="mon address(es), comma-separated")
    ap.add_argument("--port", type=int, default=7480)  # radosgw default
    ap.add_argument("--data-pool", type=str, default="rgw.data")
    ap.add_argument("--meta-pool", type=str, default="rgw.meta")
    ap.add_argument("--access-key", type=str, required=True)
    ap.add_argument("--secret-key", type=str, required=True)
    ap.add_argument("--secret", type=str, default="",
                    help="cluster cephx keyring")
    ap.add_argument("--secure", action="store_true",
                    help="on-wire encryption (requires --secret)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of the RADOS client"
                         " (default: cuda)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    client = RadosClient(args.mon, name="client.rgw",
                         secret=args.secret or None,
                         secure=args.secure, device=device)
    await client.connect()
    rgw = RGWLite(client, args.data_pool, args.meta_pool)
    fe = S3Frontend(rgw, {args.access_key: args.secret_key})
    addr = await fe.start(port=args.port)
    print(f"RGW_ADDR {addr}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await fe.stop()
        await client.shutdown()


if __name__ == "__main__":
    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        sys.exit(0)
