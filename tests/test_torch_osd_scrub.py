"""The port's scrub and scrub repair (ceph_tpu_torch.osd.daemon) against the
JAX package's, on the CPU.

Each workload runs on a JAX cluster (`ec_jax` on its host path) and on a
port cluster (`ec_torch` on `device="cpu"`), on the same seeded data, and
the replies (each scrub run's object, error and repair counts, reads) and
every MemStore's objects, xattrs and pg-meta omaps must be equal, as in
tests/test_torch_osd.py.  The workloads mirror tests/test_scrub_optracker.py:
a corrupt EC shard found by hinfo crc and rebuilt through recovery, replicated
bit rot outvoted and repaired, the background loop (`osd_scrub_interval`)
repairing with no client read, a two-copy digest tie reported and left
alone; and the `ceph tell osd.N scrub` and `scrub_stats` commands.  Each
shard is corrupted in the victim's store behind its daemon's back.  The EC
workload runs a second time with CEPH_TPU_FUSE_MIN_BYTES=0.
"""

import asyncio

from torch_cluster_helpers import one_torch_thread  # noqa: F401
from torch_mon_helpers import pkg
from test_torch_osd import both, ec_profile, fuse, rand  # noqa: F401

RUN_KEYS = ("objects", "errors", "repaired")


def _corrupt(cluster, kind: str, osd_id: int, pg, shard: int, oid: str,
             offset: int, data: bytes) -> str:
    """Overwrite bytes of a shard object in an OSD's store directly;
    returns its collection."""
    os_mod = pkg(kind, "os")
    cid = pkg(kind, "rados.embedded").shard_collection(pg, shard)
    t = os_mod.Transaction()
    t.write(cid, os_mod.ObjectId(oid), offset, len(data), data)
    cluster.stores[osd_id].queue_transaction(t)
    return cid


def _read(cluster, kind: str, osd_id: int, cid: str, oid: str) -> bytes:
    return cluster.stores[osd_id].read(cid, pkg(kind, "os").ObjectId(oid))


def _primary(cluster, io, oid: str):
    pg = io.object_pg(oid)
    _acting, primary = cluster.mon.osdmap.pg_to_acting_osds(pg)
    osd = cluster.osds[primary]
    return pg, osd, osd.pgs[pg], osd.osdmap.pools[pg.pool]


def test_scrub_detects_and_repairs_corrupt_ec_shard(fuse):
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "ec", ec_profile(kind, 2, 2), pg_num=8)
        io = cluster.client.open_ioctx("ec")
        data = rand(8, 50_000)
        replies = [await io.write_full("obj", data)]
        pg, prim, state, pool = _primary(cluster, io, "obj")
        victim = state.acting[1]
        cid = pkg(kind, "rados.embedded").shard_collection(pg, 1)
        raw = _read(cluster, kind, victim, cid, "obj")
        _corrupt(cluster, kind, victim, pg, 1, "obj", 100,
                 b"\xde\xad\xbe\xef")
        assert _read(cluster, kind, victim, cid, "obj") != raw
        res = await prim.scrub_pg(state, pool)
        assert res["errors"] >= 1 and res["repaired"] >= 1
        await cluster.wait_for_clean()
        assert _read(cluster, kind, victim, cid, "obj") == raw
        replies.append(await io.read("obj"))
        assert replies[-1] == data
        res2 = await prim.scrub_pg(state, pool)
        assert res2["errors"] == 0
        return replies + [[r[k] for k in RUN_KEYS] for r in (res, res2)]
    both(work, num_osds=5)


def test_scrub_detects_and_repairs_replicated_bitrot():
    # one OSD per host: the size-3 pool really holds three copies
    async def work(cluster, kind):
        await cluster.client.create_replicated_pool("p", size=3, pg_num=8)
        io = cluster.client.open_ioctx("p")
        replies = [await io.write_full("obj", b"pristine" * 2000)]
        pg, prim, state, pool = _primary(cluster, io, "obj")
        victim = [o for o in state.acting if o != prim.osd_id][0]
        cid = _corrupt(cluster, kind, victim, pg, -1, "obj", 0, b"rot")
        res = await prim.scrub_pg(state, pool)
        assert res["errors"] >= 1 and res["repaired"] >= 1
        await cluster.wait_for_clean()
        assert _read(cluster, kind, victim, cid, "obj") == \
            b"pristine" * 2000
        return replies + [[res[k] for k in RUN_KEYS]]
    both(work, osds_per_host=1)


def test_scheduled_scrub_loop_catches_corruption():
    async def work(cluster, kind):
        await cluster.client.create_replicated_pool("p", size=3, pg_num=8)
        io = cluster.client.open_ioctx("p")
        replies = [await io.write_full("obj", b"good" * 3000)]
        pg, prim, state, _pool = _primary(cluster, io, "obj")
        victim = [o for o in state.acting if o != prim.osd_id][0]
        cid = _corrupt(cluster, kind, victim, pg, -1, "obj", 8, b"BAD!")
        for _ in range(60):
            if prim.scrub_stats["repaired"] >= 1:
                break
            await asyncio.sleep(0.2)
        else:
            raise TimeoutError("scheduled scrub never repaired")
        await cluster.wait_for_clean()
        assert _read(cluster, kind, victim, cid, "obj") == b"good" * 3000
        replies.append(prim.scrub_stats["repaired"])
        return replies
    both(work, osds_per_host=1, osd_config={"osd_scrub_interval": 0.4})


def test_scrub_refuses_two_copy_digest_tie():
    # two hosts: the size-3 pool places two copies
    async def work(cluster, kind):
        await cluster.client.create_replicated_pool("p", size=3, pg_num=8)
        io = cluster.client.open_ioctx("p")
        replies = [await io.write_full("obj", b"truth" * 2000)]
        pg, prim, state, pool = _primary(cluster, io, "obj")
        victim = [o for o in state.acting if o != prim.osd_id][0]
        cid = _corrupt(cluster, kind, victim, pg, -1, "obj", 0, b"rot")
        res = await prim.scrub_pg(state, pool)
        assert res["errors"] >= 1
        assert res["repaired"] == 0
        assert _read(cluster, kind, prim.osd_id, cid, "obj") == \
            b"truth" * 2000
        return replies + [[res[k] for k in RUN_KEYS]]
    both(work)


def test_scrub_tell_command_repairs_and_counts():
    """`ceph tell osd.N scrub` scrubs the OSD's primary PGs now and
    answers the run's totals; `scrub_stats` keeps the lifetime sums."""
    async def work(cluster, kind):
        await cluster.client.create_replicated_pool("p", size=3, pg_num=8)
        io = cluster.client.open_ioctx("p")
        replies = [await io.write_full(f"o{i}", rand(i, 3000 + i))
                   for i in range(6)]
        pg, prim, state, _pool = _primary(cluster, io, "o2")
        victim = [o for o in state.acting if o != prim.osd_id][0]
        cid = _corrupt(cluster, kind, victim, pg, -1, "o2", 5, b"XX")
        rc, out = await cluster.client.osd_command(prim.osd_id,
                                                   {"prefix": "scrub"})
        assert rc == 0
        assert out["errors"] >= 1 and out["repaired"] >= 1
        assert out["objects"] >= 1
        assert _read(cluster, kind, victim, cid, "o2") == rand(2, 3002)
        rc2, stats = await cluster.client.osd_command(
            prim.osd_id, {"prefix": "scrub_stats"})
        assert rc2 == 0 and stats == out
        rc3, again = await cluster.client.osd_command(prim.osd_id,
                                                      {"prefix": "scrub"})
        assert rc3 == 0 and again["errors"] == 0
        return replies + [rc, out, rc2, stats, rc3, again]
    both(work, osds_per_host=1)
