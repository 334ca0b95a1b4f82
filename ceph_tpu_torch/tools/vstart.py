"""vstart: one-shot dev/test cluster launcher (src/vstart.sh role; port of
ceph_tpu/tools/vstart.py).

Spawns real processes of this package — N mons (Paxos quorum when >1),
M OSDs (TPUStore-backed under --data-dir unless --memstore), an
optional MDS pair and S3 gateway — wires them together, waits for
health, and prints a ready-to-source environment block.  `--stop` tears down a running
cluster by pidfile.  The OSDs and the gateway run on `--device`: CUDA
unless another is named (each daemon fails without CUDA and without a
device).  The MDS does no device work and takes no `--device`.

Usage:
  python -m ceph_tpu_torch.tools.vstart --data-dir DIR \
      --mons 3 --osds 4 [--mds] [--rgw] [--secret auto] [--secure]
      [--device D]
  python -m ceph_tpu_torch.tools.vstart --data-dir DIR --stop
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time


def _spawn(data_dir: str, tag: str, args, env_extra=None):
    env = dict(os.environ)
    env.update(env_extra or {})
    logf = open(os.path.join(data_dir, f"{tag}.log"), "w")
    proc = subprocess.Popen([sys.executable, "-u", "-m", *args],
                            stdout=subprocess.PIPE, stderr=logf,
                            text=True, env=env)
    return proc


def _read_tag(proc, tag: str, timeout: float = 90.0) -> str:
    import select

    deadline = time.monotonic() + timeout
    buf = ""
    while time.monotonic() < deadline:
        # poll the pipe so a wedged (silent, non-exiting) daemon cannot
        # block readline forever
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready:
            continue
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"daemon exited rc={proc.poll()}")
        buf = line
        if line.startswith(tag):
            return line.split()[1]
    raise TimeoutError(f"no {tag} line (last: {buf!r})")


def _free_ports(n: int):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _pids_path(data_dir: str) -> str:
    return os.path.join(data_dir, "vstart.pids")


def stop(data_dir: str) -> int:
    path = _pids_path(data_dir)
    if not os.path.exists(path):
        print(f"no running cluster under {data_dir}")
        return 1
    with open(path) as f:
        pids = [int(x) for x in f.read().split()]
    for pid in pids:
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    time.sleep(1.0)
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    os.remove(path)
    print(f"stopped {len(pids)} daemons")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vstart")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--mons", type=int, default=1)
    ap.add_argument("--osds", type=int, default=3)
    ap.add_argument("--mds", action="store_true",
                    help="also start an active+standby MDS pair"
                         " (creates cephfs.meta/cephfs.data pools)")
    ap.add_argument("--rgw", action="store_true",
                    help="also start the S3 gateway (creates rgw"
                         " pools; access key 'vstart'/'vstartsecret')")
    ap.add_argument("--secret", default="",
                    help="cephx keyring hex, or 'auto' to generate")
    ap.add_argument("--secure", action="store_true",
                    help="on-wire encryption (needs --secret)")
    ap.add_argument("--memstore", action="store_true",
                    help="MemStore OSDs (no durable data dir)")
    ap.add_argument("--device", default=None,
                    help="torch device of the OSDs and the gateway"
                         " (default: cuda)")
    ap.add_argument("--stop", action="store_true")
    args = ap.parse_args(argv)

    if args.stop:
        return stop(args.data_dir)
    device = ["--device", args.device] if args.device else []

    os.makedirs(args.data_dir, exist_ok=True)
    secret = args.secret
    if secret == "auto":
        from ceph_tpu_torch.common import auth

        secret = auth.generate_secret()
        with open(os.path.join(args.data_dir, "keyring"), "w") as f:
            f.write(secret + "\n")
    base_cfg = {"mon_osd_min_down_reporters": 1}
    if secret:
        base_cfg["auth_secret"] = secret
    if args.secure:
        base_cfg["auth_secure"] = True

    procs = []

    def _bail(exc):
        # a daemon failed to come up: kill everything already spawned
        # so a botched start never strands orphans with no pidfile
        for p in procs:
            if p.poll() is None:
                p.kill()
        raise exc

    # mons (static monmap so multi-mon quorum forms).  NOTE: the port
    # probe is a TOCTOU (freed before the mons bind) — acceptable for
    # a dev/test launcher; a lost race surfaces as a clean bail here.
    ports = _free_ports(args.mons)
    monmap = ",".join(f"127.0.0.1:{p}" for p in ports)
    for rank in range(args.mons):
        p = _spawn(args.data_dir, f"mon.{rank}", [
            "ceph_tpu_torch.mon", "--num-osds", str(args.osds),
            "--osds-per-host", "1", "--rank", str(rank),
            "--mon-addrs", monmap,
            "--store-path",
            os.path.join(args.data_dir, f"mon.{rank}.db"),
            "--config", json.dumps(base_cfg)])
        procs.append(p)
    try:
        for p in procs:
            _read_tag(p, "MON_ADDR")
    except Exception as e:
        _bail(e)
    # osds
    for i in range(args.osds):
        osd_args = ["ceph_tpu_torch.osd", "--id", str(i), "--mon", monmap,
                    "--config", json.dumps(base_cfg)] + device
        if not args.memstore:
            osd_args += ["--store-path",
                         os.path.join(args.data_dir, f"osd.{i}")]
        p = _spawn(args.data_dir, f"osd.{i}", osd_args)
        procs.append(p)
    try:
        for p in procs[args.mons:]:
            _read_tag(p, "OSD_ADDR")
    except Exception as e:
        _bail(e)

    async def finish():
        from ceph_tpu_torch.rados.client import RadosClient

        client = RadosClient(monmap, secret=secret or None,
                             secure=args.secure)
        await client.connect()
        try:
            if args.mds:
                await client.create_replicated_pool(
                    "cephfs.meta", size=min(2, args.osds), pg_num=8)
                await client.create_replicated_pool(
                    "cephfs.data", size=min(2, args.osds), pg_num=8)
            if args.rgw:
                await client.create_replicated_pool(
                    "rgw.meta", size=min(2, args.osds), pg_num=8)
                await client.create_replicated_pool(
                    "rgw.data", size=min(2, args.osds), pg_num=8)
            rc, out = await client.mon_command({"prefix": "status"})
            return out
        finally:
            await client.shutdown()

    try:
        status = asyncio.run(finish())
    except Exception as e:
        _bail(e)

    if args.mds:
        for name in ("a", "b"):
            p = _spawn(args.data_dir, f"mds.{name}", [
                "ceph_tpu_torch.mds", "--name", name, "--mon", monmap,
                "--metadata-pool", "cephfs.meta",
                "--data-pool", "cephfs.data"]
                + (["--secret", secret] if secret else [])
                + (["--secure"] if args.secure else []))
            procs.append(p)
            try:
                _read_tag(p, "MDS_ADDR")
            except Exception as e:
                _bail(e)

    rgw_addr = ""
    if args.rgw:
        rgw_ports = _free_ports(1)
        p = _spawn(args.data_dir, "rgw", [
            "ceph_tpu_torch.rgw", "--mon", monmap,
            "--port", str(rgw_ports[0]),
            "--access-key", "vstart", "--secret-key", "vstartsecret"]
            + (["--secret", secret] if secret else [])
            + (["--secure"] if args.secure else []) + device)
        procs.append(p)
        try:
            rgw_addr = _read_tag(p, "RGW_ADDR")
        except Exception as e:
            _bail(e)

    with open(_pids_path(args.data_dir), "w") as f:
        f.write(" ".join(str(p.pid) for p in procs))

    print(f"CLUSTER_UP mons={args.mons} osds={args.osds}"
          f" up={status.get('num_up_osds')}")
    print(f"export CEPH_TPU_MON={monmap}")
    if secret:
        print(f"export CEPH_TPU_SECRET={secret}")
    if rgw_addr:
        print(f"export CEPH_TPU_RGW=http://{rgw_addr}")
    print(f"# stop: python -m ceph_tpu_torch.tools.vstart"
          f" --data-dir {args.data_dir} --stop")
    return 0


if __name__ == "__main__":
    sys.exit(main())
