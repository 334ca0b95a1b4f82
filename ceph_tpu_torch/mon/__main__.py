"""Run a mini-mon as a real process: python -m ceph_tpu_torch.mon (port of
ceph_tpu/mon/__main__.py).

Prints `MON_ADDR <host:port>` on stdout once bound (the ceph-helpers
run_mon contract: callers parse the address to wire up OSDs/clients).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ceph_tpu_torch.mon import MonDaemon


async def _main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-osds", type=int, required=True)
    ap.add_argument("--osds-per-host", type=int, default=2)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--rank", type=int, default=0,
                    help="this mon's rank in the monmap")
    ap.add_argument("--mon-addrs", type=str, default="",
                    help="comma-separated monmap (host:port by rank);"
                         " enables multi-mon quorum.  This mon binds"
                         " its own rank's port from the list.")
    ap.add_argument("--config", type=str, default="{}",
                    help="JSON mon config overrides")
    ap.add_argument("--store-path", type=str, default="",
                    help="durable MonitorDBStore (SQLite); a restart"
                         " on the same path reloads cluster state")
    args = ap.parse_args()
    store = None
    if args.store_path:
        from ceph_tpu_torch.kv import SQLiteDB

        store = SQLiteDB(args.store_path)
        store.create_and_open()
    mon_addrs = [a for a in args.mon_addrs.split(",") if a]
    host, port = "127.0.0.1", args.port
    if mon_addrs:
        host, port_s = mon_addrs[args.rank].rsplit(":", 1)
        port = int(port_s)
    mon = MonDaemon(args.num_osds, osds_per_host=args.osds_per_host,
                    config=json.loads(args.config), store=store,
                    rank=args.rank, mon_addrs=mon_addrs)
    addr = await mon.start(host=host, port=port)
    print(f"MON_ADDR {addr}", flush=True)
    try:
        await asyncio.Event().wait()  # serve until killed
    finally:
        await mon.shutdown()


if __name__ == "__main__":
    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        sys.exit(0)
