"""`rados` CLI parity: object I/O + pool admin against a live cluster (port
of ceph_tpu/tools/rados.py).

Reference: the reference's src/tools/rados/rados.cc — the workhorse
admin CLI: put/get/rm/ls/stat/append, xattr and omap surfaces,
mkpool/lspools, bench, plus `ceph`-style mon/osd commands (`status`,
`health`, `tell`).  One process, one command, JSON-friendly output.

`--device` names the torch device of the client's own device work (the
read-then-compute legs of `scan` under CEPH_TPU_COMPUTE=0): CUDA unless
another is named, and the command fails when CUDA is missing and no
device is given.

Usage examples:
  python -m ceph_tpu_torch.tools.rados -m HOST:PORT lspools
  python -m ceph_tpu_torch.tools.rados -m HOST:PORT mkpool data --size 3
  python -m ceph_tpu_torch.tools.rados -m HOST:PORT -p data put obj ./file
  python -m ceph_tpu_torch.tools.rados -m HOST:PORT -p data get obj -
  python -m ceph_tpu_torch.tools.rados -m HOST:PORT -p data ls
  python -m ceph_tpu_torch.tools.rados -m HOST:PORT status
  python -m ceph_tpu_torch.tools.rados -m HOST:PORT tell 0 perf dump
  python -m ceph_tpu_torch.tools.rados -m HOST:PORT -p data bench 5 write
  python -m ceph_tpu_torch.tools.rados -m HOST:PORT -p data scan gf_fold
  python -m ceph_tpu_torch.tools.rados -m HOST:PORT -p data scan count \\
      --args '{"record":8,"cmp":"lt","value":10}'
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

import numpy as np

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.rados.client import RadosClient, RadosError
from ceph_tpu_torch.tools import fileio


def _out(obj) -> None:
    print(json.dumps(obj, indent=2, sort_keys=True))


async def _run(args) -> int:
    secret = args.secret
    if not secret and args.keyring:
        secret = (await fileio.read_text(args.keyring)).strip()
    client = RadosClient(args.mon, secret=secret or None,
                         device=args.device)
    await client.connect()
    try:
        return await _dispatch(client, args)
    finally:
        await client.shutdown()


async def _dispatch(client: RadosClient, args) -> int:
    cmd = args.cmd
    if cmd == "lspools":
        for pool in client.osdmap.pools.values():
            print(pool.name)
        return 0
    if cmd == "mkpool":
        if args.ec_profile:
            profile = json.loads(args.ec_profile)
            await client.create_ec_pool(args.name, profile,
                                        pg_num=args.pg_num)
        else:
            await client.create_replicated_pool(
                args.name, size=args.size, pg_num=args.pg_num)
        return 0
    if cmd == "status" or cmd == "health":
        rc, out = await client.mon_command({"prefix": cmd})
        _out(out)
        return 0 if rc == 0 else 1
    if cmd == "crash":
        rc, out = await client.mon_command(
            {"prefix": f"crash {args.verb}", "id": args.id})
        _out(out)
        return 0 if rc == 0 else 1
    if cmd == "df":
        _out(await client.df())
        return 0
    if cmd == "tell":
        rc, out = await client.osd_command(
            args.osd, {"prefix": " ".join(args.tell_cmd)})
        _out(out)
        return 0 if rc == 0 else 1

    # object commands need a pool
    if not args.pool:
        print("error: -p/--pool required", file=sys.stderr)
        return 2
    io = client.open_ioctx(args.pool)
    if cmd == "put":
        data = await fileio.read_stdin() if args.file == "-" else \
            await fileio.read_bytes(args.file)
        await io.write_full(args.obj, data)
        return 0
    if cmd == "get":
        data = await io.read(args.obj)
        if args.file == "-":
            sys.stdout.buffer.write(data)
        else:
            await fileio.write_bytes(args.file, data)
        return 0
    if cmd == "append":
        data = await fileio.read_stdin() if args.file == "-" else \
            await fileio.read_bytes(args.file)
        await io.append(args.obj, data)
        return 0
    if cmd == "rm":
        await io.remove(args.obj)
        return 0
    if cmd == "ls":
        for name in await io.list_objects():
            print(name)
        return 0
    if cmd == "stat":
        _out(await io.stat(args.obj))
        return 0
    if cmd == "setxattr":
        await io.setxattr(args.obj, args.name, args.value.encode())
        return 0
    if cmd == "getxattr":
        sys.stdout.buffer.write(await io.getxattr(args.obj, args.name))
        return 0
    if cmd == "listxattr":
        for k in sorted(await io.getxattrs(args.obj)):
            print(k)
        return 0
    if cmd == "setomapval":
        await io.omap_set(args.obj, {args.name: args.value.encode()})
        return 0
    if cmd == "listomapvals":
        for k, v in sorted((await io.omap_get(args.obj)).items()):
            print(f"{k}: {v.decode('latin-1')}")
        return 0
    if cmd == "scan":
        return await _scan(io, args)
    if cmd == "bench":
        return await _bench(io, args)
    print(f"error: unknown command {cmd!r}", file=sys.stderr)
    return 2


async def _scan(io, args) -> int:
    """`rados scan <kernel> [obj ...]` — the coded-compute front
    door: run a registered kernel over the named objects (default:
    every object in the pool) where they live, print per-object
    results.  Linear kernels (gf_fold, gf_fingerprint) print hex
    digests; JSON-result kernels (count/sum/min/max/filter,
    compress_score, dot_score) print decoded JSON."""
    kargs = json.loads(args.kernel_args) if args.kernel_args else None
    oids = args.objs or await io.list_objects()
    if not oids:
        _out({"results": {}, "errors": {}})
        return 0
    results, errors = await io.compute(args.kernel, oids, kargs)
    rendered = {}
    for oid, res in sorted(results.items()):
        try:
            rendered[oid] = json.loads(res)
        except (ValueError, UnicodeDecodeError):
            rendered[oid] = bytes(res).hex()
    _out({"kernel": args.kernel,
          "results": rendered,
          "errors": {k: v for k, v in sorted(errors.items())}})
    return 0 if not errors else 1


def zipf_indices(theta: float, n: int, count: int,
                 seed: int = 0) -> np.ndarray:
    """Deterministic Zipf(theta) sample of `count` object ranks in
    [0, n): P(rank i) ∝ 1/(i+1)^theta, rank 0 hottest.  theta=0 is
    uniform.  Seeded rng so bench legs (and the tier regression tests
    built on them) are reproducible."""
    ranks = np.arange(1, max(int(n), 1) + 1, dtype=np.float64)
    weights = ranks ** -float(theta)
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    u = np.random.default_rng(seed).random(int(count))
    return np.searchsorted(cdf, u).astype(np.int64)


async def _bench(io, args) -> int:
    """`rados bench <seconds> write|seq` (rados.cc bench role).

    `seq --read-skew <theta>` runs the skewed-read leg: prefill
    --objects objects, then hammer them with a deterministic
    Zipf(theta) index stream — the workload shape that demonstrates
    (and regression-tests) read-tier hit rates.

    `--tenants N` switches the bench to the OPEN-LOOP multi-tenant
    harness (ceph_tpu_torch/loadgen): N simulated tenants fire ops on a
    Poisson schedule at --arrival-rate ops/s each with the --blend
    op mix, latency measured from scheduled arrival (queueing delay
    counted), goodput + streaming p50/p95/p99 reported."""
    if getattr(args, "tenants", 0) > 0:
        return await _bench_loadgen(io, args)
    size = args.block_size
    payload = np.random.default_rng(0).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    deadline = time.monotonic() + args.seconds
    done = [0]

    theta = float(getattr(args, "read_skew", 0.0) or 0.0)
    if args.mode == "seq" and theta > 0:
        n_objs = int(args.objects)
        for i in range(n_objs):
            await io.write_full(f"bench_z_{i}", payload)
        # the measurement window opens AFTER the prefill: writing
        # --objects payloads must not eat into the read leg
        deadline = time.monotonic() + args.seconds

        async def skewed_reader(slot: int) -> None:
            idx = zipf_indices(theta, n_objs, 65536,
                               seed=int(args.seed) + slot)
            pos = 0
            while time.monotonic() < deadline:
                i = int(idx[pos % len(idx)])
                pos += 1
                await io.read(f"bench_z_{i}")
                done[0] += 1

        t0 = time.monotonic()
        await asyncio.gather(*(skewed_reader(s)
                               for s in range(args.concurrency)))
        secs = max(time.monotonic() - t0, 1e-9)
        _out({"mode": "seq", "read_skew": theta, "objects": n_objs,
              "ops": done[0], "seconds": round(secs, 3),
              "ops_per_sec": round(done[0] / secs, 2),
              "mib_per_sec": round(done[0] * size / secs / (1 << 20),
                                   2)})
        return 0

    async def writer(slot: int) -> None:
        i = 0
        while time.monotonic() < deadline:
            await io.write_full(f"bench_{slot}_{i}", payload)
            done[0] += 1
            i += 1

    async def reader(slot: int) -> None:
        i = 0
        while time.monotonic() < deadline:
            try:
                await io.read(f"bench_{slot}_{i}")
            except RadosError:
                i = 0
                continue
            done[0] += 1
            i += 1

    t0 = time.monotonic()
    fn = writer if args.mode == "write" else reader
    await asyncio.gather(*(fn(s) for s in range(args.concurrency)))
    secs = time.monotonic() - t0
    _out({"mode": args.mode, "ops": done[0], "seconds": round(secs, 3),
          "ops_per_sec": round(done[0] / secs, 2),
          "mib_per_sec": round(done[0] * size / secs / (1 << 20), 2)})
    return 0


async def _bench_loadgen(io, args) -> int:
    """Open-loop multi-tenant leg: the CLI front door onto the
    loadgen subsystem (ceph_tpu_torch/loadgen)."""
    from ceph_tpu_torch.loadgen import (
        RadosTarget, make_tenants, parse_blend, run_open_loop,
    )

    blend = parse_blend(getattr(args, "blend", "") or "")
    # --read-skew is the tenants' zipf theta here, taken literally:
    # an explicit 0 means uniform popularity (same semantics as the
    # closed-loop skewed-read leg)
    tenants = make_tenants(
        int(args.tenants), rate=float(args.arrival_rate),
        blend=blend, zipf_theta=float(args.read_skew),
        objects=int(args.objects), object_size=int(args.block_size))
    target = RadosTarget(io)
    await target.setup(int(args.objects), int(args.block_size))
    report = await run_open_loop(target, tenants,
                                 duration=float(args.seconds),
                                 seed=int(args.seed))
    _out({"mode": "loadgen", "blend": blend, **report})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rados")
    ap.add_argument("-m", "--mon", required=True,
                    help="mon address host:port")
    ap.add_argument("-p", "--pool", default="")
    ap.add_argument("--secret", default="",
                    help="cephx-lite hex secret for a keyed cluster")
    ap.add_argument("-k", "--keyring", default="",
                    help="file holding the hex secret")
    ap.add_argument("--device", default=None,
                    help="torch device of the client's compute legs"
                         " (default: cuda)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("lspools")
    mk = sub.add_parser("mkpool")
    mk.add_argument("name")
    mk.add_argument("--size", type=int, default=3)
    mk.add_argument("--pg-num", type=int, default=32)
    mk.add_argument("--ec-profile", default="",
                    help="JSON EC profile (makes an EC pool)")
    sub.add_parser("status")
    sub.add_parser("health")
    sub.add_parser("df")
    cr = sub.add_parser("crash")
    cr.add_argument("verb", choices=["ls", "ls-new", "info",
                                     "archive", "archive-all", "rm"])
    cr.add_argument("id", nargs="?", default="")
    tell = sub.add_parser("tell")
    tell.add_argument("osd", type=int)
    tell.add_argument("tell_cmd", nargs="+")
    for name in ("put", "get", "append"):
        p = sub.add_parser(name)
        p.add_argument("obj")
        p.add_argument("file")
    for name in ("rm", "stat", "listxattr", "listomapvals"):
        p = sub.add_parser(name)
        p.add_argument("obj")
    sub.add_parser("ls")
    for name in ("setxattr", "setomapval"):
        p = sub.add_parser(name)
        p.add_argument("obj")
        p.add_argument("name")
        p.add_argument("value")
    gx = sub.add_parser("getxattr")
    gx.add_argument("obj")
    gx.add_argument("name")
    scan = sub.add_parser("scan")
    scan.add_argument("kernel",
                      help="registered compute kernel (gf_fold,"
                           " gf_fingerprint, count, sum, min, max,"
                           " filter, compress_score, dot_score)")
    scan.add_argument("objs", nargs="*",
                      help="objects to scan (default: whole pool)")
    scan.add_argument("--args", default="", dest="kernel_args",
                      help="kernel args as JSON, e.g."
                           " '{\"record\":8,\"cmp\":\"lt\","
                           "\"value\":10}'")
    bench = sub.add_parser("bench")
    bench.add_argument("seconds", type=int)
    bench.add_argument("mode", choices=["write", "seq"])
    bench.add_argument("-b", "--block-size", type=int,
                       default=4 << 20)
    bench.add_argument("-t", "--concurrency", type=int, default=16)
    bench.add_argument("--read-skew", type=float, default=0.0,
                       dest="read_skew", metavar="THETA",
                       help="seq mode: zipfian read skew exponent"
                            " (0 = uniform scan)")
    bench.add_argument("--objects", type=int, default=64,
                       help="seq --read-skew: prefilled object count")
    bench.add_argument("--seed", type=int, default=0,
                       help="seq --read-skew: deterministic rng seed")
    bench.add_argument("--tenants", type=int, default=0,
                       help="open-loop mode: number of simulated"
                            " tenants (0 = classic closed-loop"
                            " bench)")
    bench.add_argument("--arrival-rate", type=float, default=2.0,
                       dest="arrival_rate", metavar="OPS_PER_SEC",
                       help="open-loop mode: per-tenant Poisson"
                            " arrival rate")
    bench.add_argument("--blend", default="",
                       help="open-loop mode: op mix, e.g."
                            " read=0.7,write=0.2,stat=0.1"
                            " (kinds: read write stat ranged)")
    args = ap.parse_args(argv)
    try:
        args.device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        return asyncio.run(_run(args))
    except RadosError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
