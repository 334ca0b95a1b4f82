"""PG splits in the port's OSD (ceph_tpu_torch.osd.daemon) against the JAX
package's, on the CPU; mirrors tests/test_split.py.

Each history runs on a port cluster and on a JAX cluster (port OSDs on
`device="cpu"`, JAX OSDs and `ec_jax` pools on the host path) with the same
seeded objects, and the replies and every MemStore must be equal, the
`osd_meta` split bookkeeping (pg_num per pool, the split children) and the
pg-meta logs included: pg_num growth from 4 to 16 with data at rest on a
replicated and an EC pool, a mixed cluster of both packages splitting
together, and a port OSD that was down across the growth and
redistributes its objects at boot.  The split under a live write load is
marked slow, as its reference is; the autoscaler's growth waits for the
port's mgr (ROADMAP A11).
"""

import asyncio

import numpy as np
import pytest

from ceph_tpu.ops.rjenkins import ceph_str_hash_rjenkins as jhash
from ceph_tpu.osd import osdmap as josdmap
from ceph_tpu_torch.ops.rjenkins import ceph_str_hash_rjenkins as thash
from ceph_tpu_torch.osd import osdmap as tosdmap

from test_torch_osd import both, ec_profile, run, snapshot
from torch_cluster_helpers import Cluster
from torch_cluster_helpers import one_torch_thread  # noqa: F401
from torch_mon_helpers import pkg


def test_stable_mod_split_children():
    """The port's rjenkins, _calc_mask and ceph_stable_mod equal the JAX
    package's on seeded names, and objects move only to children of
    their parent (ps + k*old_num) — the invariant that makes local
    splitting complete."""
    rng = np.random.default_rng(0)
    names = [f"obj-{i}" for i in range(500)] + [
        rng.bytes(int(n)).hex() for n in rng.integers(1, 40, 200)]
    for old, new in ((8, 16), (8, 32), (4, 12), (4, 16)):
        mask_old, mask_new = tosdmap._calc_mask(old), \
            tosdmap._calc_mask(new)
        assert (mask_old, mask_new) == (josdmap._calc_mask(old),
                                        josdmap._calc_mask(new))
        for name in names:
            h = thash(name.encode())
            assert h == jhash(name.encode()), name
            ps_old = tosdmap.ceph_stable_mod(h, old, mask_old)
            ps_new = tosdmap.ceph_stable_mod(h, new, mask_new)
            assert (ps_old, ps_new) == (
                josdmap.ceph_stable_mod(h, old, mask_old),
                josdmap.ceph_stable_mod(h, new, mask_new))
            assert ps_new % old == ps_old % old or ps_new == ps_old, \
                (old, new, ps_old, ps_new)
            if ps_new != ps_old:
                assert ps_new >= old  # always a NEW pg, never another


def _payloads(n, seed=7):
    return {f"obj-{i}": np.random.default_rng(seed + i).integers(
        0, 256, 2000 + 997 * i % 30000, dtype=np.uint8).tobytes()
        for i in range(n)}


async def _grow(cluster, pool: str, pg_num: int) -> None:
    rc, out = await cluster.client.mon_command(
        {"prefix": "osd pool set", "name": pool, "var": "pg_num",
         "val": pg_num})
    assert rc == 0, out
    await cluster.client.wait_for_new_map()
    await cluster.wait_for_clean(timeout=60.0)


def _split_meta(cluster) -> dict:
    """Each live OSD's split bookkeeping, as it holds it in memory."""
    return {i: (dict(o._pool_pg_nums),
                sorted((p.pool, p.ps) for p in o._split_children))
            for i, o in sorted(cluster.osds.items())}


@pytest.mark.parametrize("pool_kind", ["replicated", "ec"])
def test_split_preserves_data(pool_kind):
    """Grow pg_num 4->16 with data at rest: every object reads back
    through its NEW placement, the new PGs go active, a delete routes to
    the new placement too, and every store equals the JAX cluster's."""
    async def work(cluster, kind):
        if pool_kind == "ec":
            await cluster.client.create_ec_pool(
                "sp", ec_profile(kind, 2, 1), pg_num=4)
        else:
            await cluster.client.create_replicated_pool("sp", size=3,
                                                        pg_num=4)
        io = cluster.client.open_ioctx("sp")
        payloads = _payloads(24)
        for oid, data in payloads.items():
            await io.write_full(oid, data)
        moved = sum(1 for oid in payloads
                    if tosdmap.ceph_stable_mod(
                        thash(oid.encode()), 16,
                        tosdmap._calc_mask(16)) >= 4)
        assert moved > 0  # the test actually exercises movement
        await _grow(cluster, "sp", 16)
        replies = [moved]
        for oid, data in payloads.items():
            got = await io.read(oid)
            assert got == data, f"{oid} lost through split"
            replies.append(io.object_pg(oid).ps)
        await io.remove("obj-0")
        err = pkg(kind, "rados.client").ObjectNotFound
        with pytest.raises(err):
            await io.read("obj-0")
        replies.append(sorted(await io.list_objects()))
        replies.append(_split_meta(cluster))
        return replies
    both(work, num_osds=6, osds_per_host=2, timeout=180)


def _mixed_history(kinds):
    """A jerasure 2+1 pool and a replicated pool on a cluster of `kinds`
    split 4 -> 16 with data at rest; returns the reads and the stores."""
    async def main():
        cluster = Cluster(num_osds=6, osds_per_host=1, kinds=kinds,
                          mon_kind="jax", client_kind="jax")
        await cluster.start()
        try:
            await cluster.client.create_ec_pool(
                "ec", {"plugin": "jerasure", "technique": "reed_sol_van",
                       "k": "2", "m": "1", "crush-failure-domain": "osd",
                       "tpu": "false"}, pg_num=4)
            await cluster.client.create_replicated_pool("rep", size=2,
                                                        pg_num=4)
            await cluster.wait_for_clean()
            payloads = _payloads(16, seed=31)
            for pool in ("ec", "rep"):
                io = cluster.client.open_ioctx(pool)
                for oid, data in payloads.items():
                    await io.write_full(oid, data)
            await _grow(cluster, "ec", 16)
            await _grow(cluster, "rep", 16)
            reads = []
            for pool in ("ec", "rep"):
                io = cluster.client.open_ioctx(pool)
                for oid, data in payloads.items():
                    got = await io.read(oid)
                    assert got == data, (pool, oid)
                    reads.append((pool, io.object_pg(oid).ps))
            await asyncio.sleep(0.2)
            return reads, snapshot(cluster)
        finally:
            await cluster.stop()
    return run(main(), 180)


def test_mixed_cluster_splits_together():
    """OSDs of both packages split the same pools together: every object
    reads back, and every store equals an all-JAX cluster's after the
    same history (`osd_meta` included)."""
    mixed = _mixed_history(["torch", "jax"] * 3)
    jax_only = _mixed_history(["jax"] * 6)
    assert mixed[0] == jax_only[0]
    assert mixed[1] == jax_only[1]


def test_osd_down_across_growth_splits_at_boot():
    """A port OSD killed before the growth and revived after it: its
    store still holds the parent PGs' objects, the split bookkeeping it
    loads at boot says the pool had 4 PGs, and the first map it sees
    redistributes them; the cluster's stores then equal the JAX
    cluster's after the same history."""
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "sp", ec_profile(kind, 2, 1), pg_num=4)
        io = cluster.client.open_ioctx("sp")
        payloads = _payloads(16, seed=41)
        for oid, data in payloads.items():
            await io.write_full(oid, data)
        victim = 5
        await cluster.kill_osd(victim)
        await cluster.mark_down(victim)
        await cluster.wait_for_clean(timeout=60.0)
        await _grow(cluster, "sp", 16)
        # its store: the parent PGs' shards, the pre-growth pg_num
        old_colls = sorted(c for c in cluster.stores[victim]
                           .list_collections()
                           if c.startswith(f"{io.pool_id}."))
        await cluster.revive_osd(victim)
        await cluster.wait_for_osd_up(victim)
        await cluster.wait_for_clean(timeout=60.0)
        revived = cluster.osds[victim]
        assert revived._pool_pg_nums[io.pool_id] == 16
        for oid, data in payloads.items():
            assert await io.read(oid) == data, oid
        # no object is left in a PG its name no longer hashes to
        store = cluster.stores[victim]
        for cid in store.list_collections():
            if not cid.startswith(f"{io.pool_id}."):
                continue
            ps = int(cid.split(".", 1)[1].split("_")[0].split("s")[0], 16)
            for o in store.list_objects(cid):
                name = str(o)
                if name.startswith("_"):
                    continue
                assert io.object_pg(name).ps == ps, (cid, name)
        return [old_colls, _split_meta(cluster)]
    both(work, num_osds=6, osds_per_host=2, timeout=180)


@pytest.mark.slow
def test_split_under_live_writes():
    """pg_num grows while a write workload runs on a port cluster;
    model-checked reads after settling (tests/test_split.py's flow)."""
    async def main():
        cluster = Cluster(num_osds=6, osds_per_host=2)
        await cluster.start()
        try:
            await cluster.client.create_ec_pool(
                "lw", ec_profile("torch", 2, 1), pg_num=8)
            io = cluster.client.open_ioctx("lw")
            model = {}
            maybe: dict = {}
            stop = False

            async def workload():
                seq = 0
                while not stop:
                    seq += 1
                    oid = f"obj-{seq % 20}"
                    data = bytes([seq % 256]) * (1500 + seq % 9000)
                    maybe.setdefault(oid, []).append(data)
                    try:
                        await io.write_full(oid, data)
                        model[oid] = data
                        maybe[oid] = []
                    except Exception:
                        pass
                    await asyncio.sleep(0)

            task = asyncio.get_running_loop().create_task(workload())
            try:
                await asyncio.sleep(1.5)
                rc, out = await cluster.client.mon_command(
                    {"prefix": "osd pool set", "name": "lw",
                     "var": "pg_num", "val": 32})
                assert rc == 0, out
                await asyncio.sleep(3.0)  # write THROUGH the split
            finally:
                stop = True
                await task
            assert len(model) >= 10
            await cluster.wait_for_clean(timeout=90.0)
            for oid, data in model.items():
                got = await io.read(oid)
                legal = [data] + maybe.get(oid, [])
                assert any(got == want for want in legal), \
                    f"{oid} diverged through live split"
        finally:
            await cluster.stop()

    run(main(), 240)


def _short_shards(cluster, io, names) -> list:
    """(object, pg, slot, osd) of every up acting member that lacks the
    object's shard at its slot."""
    kind = cluster.kinds[next(iter(cluster.osds))]
    shard_collection = pkg(kind, "rados.embedded").shard_collection
    object_id = pkg(kind, "os").ObjectId
    short = []
    for name in names:
        pg = io.object_pg(name)
        acting, _primary = cluster.mon.osdmap.pg_to_acting_osds(pg)
        for slot, osd in enumerate(acting):
            if osd not in cluster.osds:
                continue
            try:
                cluster.stores[osd].stat(shard_collection(pg, slot),
                                         object_id(name))
            except (KeyError, IOError):
                short.append((name, str(pg), slot, osd))
    return short


def test_slot_move_leaves_a_shard_unrebuilt_in_both_packages():
    """Reference fault C7, copied by the port: an OSD marked out remaps
    an EC PG (CRUSH indep), and a surviving member moves to another slot.
    Its cached pg log is still the old slot's collection's, so it answers
    peering for the new slot as if that slot's shards were there; the
    primary rebuilds nothing on it and the PG goes clean one shard short
    for those objects.  (Split children on such PGs inherit it; phase 3k
    meets it with three OSDs down.)  The port's stores equal the JAX
    package's, the short shards included."""
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "sl", ec_profile(kind, 2, 1), pg_num=8)
        io = cluster.client.open_ioctx("sl")
        names = [f"o{i}" for i in range(24)]
        for name in names:
            await io.write_full(name, bytes([len(name)]) * 5000)
        assert not _short_shards(cluster, io, names)
        await cluster.kill_osd(3)
        await cluster.mark_down(3)
        await cluster.mark_out(3)
        await cluster.wait_for_clean(timeout=60.0)
        short = _short_shards(cluster, io, names)
        assert short
        for name in names:
            assert await io.read(name) == bytes([len(name)]) * 5000
        return short
    both(work, num_osds=4, osds_per_host=1)
