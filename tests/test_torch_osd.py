"""The port's OSD daemon and RADOS client (ceph_tpu_torch.osd.daemon,
.rados.client) against the JAX package's, on the CPU.

Each workload runs twice, on the same seeded data: once through a cluster
of JAX daemons and a JAX client (`ec_jax` pools on its host path), once
through port daemons on `device="cpu"` and a port client (`ec_torch`
pools).  The replies (read bytes, stat and write_full out maps, the
data_crc of each write, error codes), every MemStore's objects (shard
bytes, the OI, hinfo and user xattrs) and every pg-meta omap (pg info, log
entries, missing sets) must be equal.  The workloads mirror
tests/test_cluster.py (boot and health, the replicated pool, the EC pool
with a ranged read and a partial overwrite, the degraded read after a
kill, the OSD marked down through the mon), tests/test_ec_rmw.py (random-offset overwrites against an oracle,
stripe-sized sub-reads and sub-writes) and tests/test_client_ops.py
(append and xattrs, replicated and EC).  The EC workloads run a second
time with CEPH_TPU_FUSE_MIN_BYTES=0, which engages the encode service's
batched fused body (ec_util.encode_many_with_hinfo) on the port's CPU
codec.
"""

import asyncio

import numpy as np
import pytest

from ceph_tpu_torch.osd import daemon as tdaemon

from torch_cluster_helpers import Cluster
from torch_cluster_helpers import one_torch_thread  # noqa: F401
from torch_mon_helpers import pkg

KINDS = ("jax", "torch")


def run(coro, timeout: float = 120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def ec_profile(kind: str, k: int, m: int) -> dict:
    """The same RS profile under each package's plugin name; the JAX
    codec on its host path (the port is held against the JAX host path,
    ROADMAP C1-C3)."""
    if kind == "jax":
        return {"plugin": "ec_jax", "technique": "reed_sol_van",
                "k": str(k), "m": str(m), "crush-failure-domain": "osd",
                "tpu": "false"}
    return {"plugin": "ec_torch", "technique": "reed_sol_van",
            "k": str(k), "m": str(m), "crush-failure-domain": "osd"}


def rand(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def snapshot(cluster) -> dict:
    """{osd: {collection: {object: (bytes, xattrs, omap)}}} of every
    store, the killed OSDs' included, the split bookkeeping (`osd_meta`:
    pg_num per pool and the split children) among them."""
    out = {}
    for osd_id, store in sorted(cluster.stores.items()):
        colls = {}
        for cid in store.list_collections():
            objs = {}
            for oid in store.list_objects(cid):
                objs[str(oid)] = (store.read(cid, oid),
                                  store.getattrs(cid, oid),
                                  store.omap_get(cid, oid))
            colls[cid] = objs
        out[osd_id] = colls
    return out


async def _rc(coro):
    """The call's result, or its RadosError code."""
    try:
        return await coro
    except Exception as e:      # RadosError of either package
        rc = getattr(e, "rc", None)
        if rc is None:
            raise
        return ("rc", rc)


def both(workload, num_osds: int = 4, osds_per_host: int = 2,
         timeout: float = 120, **cluster_kw) -> dict:
    """Run `workload(cluster, kind)` on a JAX and on a port cluster;
    assert equal replies and equal stores; return each run's extras.
    (An OSD marked down by mistake would change the map epochs, and with
    them the versions the runs share: the harness's heartbeat grace is
    past any stall of a loaded host.)  `cluster_kw` goes to Cluster
    (osd_config, mon_config)."""
    results = {}
    for kind in KINDS:
        async def main(kind=kind):
            cluster = Cluster(num_osds=num_osds, osds_per_host=osds_per_host,
                              kinds=[kind] * num_osds, mon_kind=kind,
                              client_kind=kind, **cluster_kw)
            await cluster.start()
            try:
                replies = await workload(cluster, kind)
                await asyncio.sleep(0.2)   # trims and late commits land
                return replies, snapshot(cluster), cluster
            finally:
                await cluster.stop()
        results[kind] = run(main(), timeout)
    jrep, jsnap, _ = results["jax"]
    trep, tsnap, _ = results["torch"]
    assert trep == jrep
    assert tsnap.keys() == jsnap.keys()
    for osd_id in jsnap:
        assert tsnap[osd_id].keys() == jsnap[osd_id].keys(), osd_id
        for cid in jsnap[osd_id]:
            assert tsnap[osd_id][cid] == jsnap[osd_id][cid], (osd_id, cid)
    return results


@pytest.fixture(params=[None, "0"], ids=["inline", "fused_batches"])
def fuse(request, monkeypatch):
    if request.param is None:
        monkeypatch.delenv("CEPH_TPU_FUSE_MIN_BYTES", raising=False)
    else:
        monkeypatch.setenv("CEPH_TPU_FUSE_MIN_BYTES", request.param)
    return request.param


def one_per_pg(io, n: int):
    """n object names, each in a PG of its own."""
    names, pgs = [], set()
    i = 0
    while len(names) < n:
        name = f"o{i}"
        pg = io.object_pg(name)
        if pg not in pgs:
            pgs.add(pg)
            names.append(name)
        i += 1
    return names


def _batched(cluster) -> int:
    return sum(o.encode_service.counters["batched"]
               for o in cluster.osds.values())


# -- tests/test_cluster.py -------------------------------------------------

def test_cluster_boot_and_health():
    async def work(cluster, kind):
        rc, out = await cluster.client.mon_command({"prefix": "status"})
        assert rc == 0
        assert out["num_up_osds"] == 4
        assert out["health"]["status"] == "HEALTH_OK"
        return [rc, out["num_up_osds"], out["health"]["status"],
                cluster.mon.osdmap.epoch]
    both(work)


def test_replicated_pool_over_the_wire():
    async def work(cluster, kind):
        await cluster.client.create_replicated_pool("rbd", size=3, pg_num=8)
        io = cluster.client.open_ioctx("rbd")
        payloads = {f"obj-{i}": rand(i, 20_000 + i) for i in range(8)}
        replies = [await io.write_full(n, d) for n, d in payloads.items()]
        for name, data in payloads.items():
            got = await io.read(name)
            assert got == data
            replies.append(got)
        replies.append(await io.stat("obj-0"))
        assert replies[-1]["size"] == 20_000
        replies.append(await io.list_objects())
        assert replies[-1] == sorted(payloads)
        await io.remove("obj-3")
        replies.append(await _rc(io.read("obj-3")))
        assert replies[-1] == ("rc", tdaemon.ENOENT)
        return replies
    both(work)


def test_ec_pool_over_the_wire(fuse):
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "ecpool", ec_profile(kind, 2, 1), pg_num=8)
        io = cluster.client.open_ioctx("ecpool")
        data = rand(7, 100_000)
        replies = [await io.write_full("big", data)]
        assert "data_crc" in replies[0]
        replies.append(await io.read("big"))
        assert replies[-1] == data
        replies.append(await io.read("big", 100, 500))
        assert replies[-1] == data[100:600]
        await io.write("big", b"X" * 1000, 4096)
        expect = bytearray(data)
        expect[4096:5096] = b"X" * 1000
        replies.append(await io.read("big"))
        assert replies[-1] == bytes(expect)
        # a few writes in flight together, one to a PG (so each PG's
        # version order is fixed): the service may batch their encodes
        objs = {name: rand(20 + i, 10_000 * (i + 1))
                for i, name in enumerate(one_per_pg(io, 6))}
        outs = await asyncio.gather(*(io.write_full(n, d)
                                      for n, d in objs.items()))
        replies.append(outs)
        for name, d in objs.items():
            assert await io.read(name) == d
        if kind == "torch" and fuse == "0":
            assert _batched(cluster) > 0
        return replies
    both(work)


def test_ec_degraded_read_after_kill(fuse):
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "ecpool", ec_profile(kind, 2, 1), pg_num=8)
        io = cluster.client.open_ioctx("ecpool")
        payloads = {f"o{i}": rand(100 + i, 50_000) for i in range(6)}
        replies = [await io.write_full(n, d) for n, d in payloads.items()]
        await cluster.kill_osd(0)
        await cluster.mark_down(0)
        await cluster.wait_for_osd_down(0)
        for name, data in payloads.items():
            got = await io.read(name)
            assert got == data
            replies.append(got)
        rc, health = await cluster.client.mon_command({"prefix": "health"})
        assert health["status"] == "HEALTH_WARN"
        assert "OSD_DOWN" in health["checks"]
        replies.append((rc, health["status"], sorted(health["checks"])))
        return replies
    both(work)


#: tests/cluster_helpers.py's heartbeat grace: short enough that the
#: peers' failure reports mark a killed OSD down within seconds
REPORT_GRACE = {"osd_heartbeat_grace": 2.5}


def test_failure_reports_mark_a_dead_osd_down():
    """tests/test_cluster.py's kill with no mark_down: on an idle cluster
    the surviving OSDs' heartbeats miss the dead one, they report it,
    and the mon marks it down.  The JAX and the port cluster end on the
    same map epochs, up set and health."""
    def once(kind: str):
        async def main():
            cluster = Cluster(num_osds=4, kinds=[kind] * 4, mon_kind=kind,
                              client_kind=kind, osd_config=REPORT_GRACE,
                              mon_config=REPORT_GRACE)
            await cluster.start()
            try:
                await cluster.wait_for_clean()
                booted = cluster.mon.osdmap.epoch
                await cluster.kill_osd(2)
                # only the peers' failure reports can do this
                await cluster.wait_for_osd_down(2, timeout=20.0)
                osdmap = cluster.mon.osdmap
                rc, health = await cluster.client.mon_command(
                    {"prefix": "health"})
                assert rc == 0
                return (booted, osdmap.epoch, osdmap.get_up_osds(),
                        health["status"], sorted(health["checks"]))
            finally:
                await cluster.stop()
        return run(main(), 60)

    jax, port = once("jax"), once("torch")
    assert port == jax
    assert port[2] == [0, 1, 3] and port[3] == "HEALTH_WARN"
    assert "OSD_DOWN" in port[4]


# -- tests/test_ec_rmw.py --------------------------------------------------

def test_random_offset_overwrites_match_oracle(fuse):
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "ec", ec_profile(kind, 2, 1), pg_num=8)
        io = cluster.client.open_ioctx("ec")
        rng = np.random.default_rng(11)
        model = bytearray()
        replies = [await io.write_full(
            "obj", bytes(rng.integers(0, 256, 50_000, dtype=np.uint8)))]
        model[:] = await io.read("obj")
        for step in range(25):
            off = int(rng.integers(0, 70_000))
            ln = int(rng.integers(1, 9_000))
            payload = bytes(rng.integers(0, 256, ln, dtype=np.uint8))
            await io.write("obj", payload, off)
            if off + ln > len(model):
                model.extend(bytes(off + ln - len(model)))
            model[off:off + ln] = payload
            if step % 5 == 4:
                assert await io.read("obj") == bytes(model), step
        assert await io.read("obj") == bytes(model)
        for _ in range(10):
            off = int(rng.integers(0, len(model)))
            ln = int(rng.integers(1, 5_000))
            got = await io.read("obj", offset=off, length=ln)
            assert got == bytes(model[off:off + ln])
            replies.append(got)
        replies.append(await io.stat("obj"))
        return replies
    both(work)


def _primary_of(cluster, kind: str, pool_name: str, oid: str):
    osdmap = cluster.mon.osdmap
    pool = [p for p in osdmap.pools.values() if p.name == pool_name][0]
    ps = pkg(kind, "ops.rjenkins").ceph_str_hash_rjenkins(oid.encode())
    pg = pool.raw_pg_to_pg(pkg(kind, "osd.osdmap").PgId(pool.id, ps))
    _acting, primary = osdmap.pg_to_acting_osds(pg)
    return cluster.osds[primary]


def test_small_writes_and_reads_move_stripes_not_objects(fuse):
    """A 100-byte overwrite and a 4 KiB ranged read of a 4 MiB EC 8+3
    object move O(stripe) sub-op bytes, with ONE encode for the write."""
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "ec", ec_profile(kind, 8, 3), pg_num=8)
        io = cluster.client.open_ioctx("ec")
        obj = rand(1, 4 << 20)
        replies = [await io.write_full("big", obj)]
        prim = _primary_of(cluster, kind, "ec", "big")
        stripe_w = 8 * 4096
        base = dict(prim.perf)
        await io.write("big", b"x" * 100, 1_000_003)
        moved = (prim.perf["subread_bytes"] - base["subread_bytes"]
                 + prim.perf["subwrite_bytes"] - base["subwrite_bytes"])
        enc = prim.perf["encode_dispatches"] - base["encode_dispatches"]
        assert moved < 6 * stripe_w, moved
        assert enc == 1
        got = await io.read("big", offset=1_000_000, length=200)
        assert got == obj[1_000_000:1_000_003] + b"x" * 100 + \
            obj[1_000_103:1_000_200]
        # the ranged read on an object of its own, read once (a second
        # read of a hot object may promote it whole into the read tier)
        obj2 = rand(2, 4 << 20)
        replies.append(await io.write_full("big2", obj2))
        prim2 = _primary_of(cluster, kind, "ec", "big2")
        base_r = prim2.perf["subread_bytes"]
        got2 = await io.read("big2", offset=2_000_000, length=4096)
        assert got2 == obj2[2_000_000:2_004_096]
        moved_r = prim2.perf["subread_bytes"] - base_r
        assert moved_r < 4 * stripe_w, moved_r
        return replies + [moved, enc, got, moved_r, got2]
    both(work, num_osds=12, osds_per_host=3, timeout=180)


# -- tests/test_client_ops.py ----------------------------------------------

def test_append_and_xattrs_replicated():
    async def work(cluster, kind):
        await cluster.client.create_replicated_pool("p", size=3, pg_num=8)
        io = cluster.client.open_ioctx("p")
        await io.write_full("obj", b"hello")
        await io.append("obj", b" world")
        await io.append("obj", b"!")
        replies = [await io.read("obj")]
        assert replies[0] == b"hello world!"
        for i in range(8):
            await io.append("obj", bytes([65 + i]))
        replies.append(await io.read("obj"))
        await io.setxattr("obj", "color", b"blue")
        await io.setxattr("obj", "shape", b"round")
        replies.append(await io.getxattr("obj", "color"))
        assert replies[-1] == b"blue"
        replies.append(await io.getxattrs("obj"))
        assert replies[-1] == {"color": b"blue", "shape": b"round"}
        await io.rmxattr("obj", "color")
        replies.append(await _rc(io.getxattr("obj", "color")))
        replies.append(await _rc(io.setxattr("nope", "a", b"b")))
        assert replies[-1][0] == replies[-2][0] == "rc"
        return replies
    both(work)


def test_append_and_xattrs_ec(fuse):
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "ec", ec_profile(kind, 2, 2), pg_num=8)
        io = cluster.client.open_ioctx("ec")
        blob = rand(4, 30_000)
        replies = [await io.write_full("obj", blob)]
        await io.append("obj", b"tail" * 100)
        replies.append(await io.read("obj"))
        assert replies[-1] == blob + b"tail" * 100
        await io.setxattr("obj", "k", b"v")
        replies.append(await io.getxattr("obj", "k"))
        assert replies[-1] == b"v"
        replies.append(await io.stat("obj"))
        return replies
    both(work, num_osds=5)


def test_concurrent_appends_serialize():
    """The JAX test's concurrent appends on the port alone: their order
    is the scheduler's, so only the oracle's property is compared."""
    async def main():
        cluster = Cluster(num_osds=4)
        await cluster.start()
        try:
            await cluster.client.create_replicated_pool("p", size=3,
                                                        pg_num=8)
            io = cluster.client.open_ioctx("p")
            await io.write_full("obj", b"hello world!")
            await asyncio.gather(*(io.append("obj", bytes([65 + i]))
                                   for i in range(8)))
            data = await io.read("obj")
            assert len(data) == len(b"hello world!") + 8
            assert sorted(data[-8:]) == list(range(65, 73))
        finally:
            await cluster.stop()
    run(main())
