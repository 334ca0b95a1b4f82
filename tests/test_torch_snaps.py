"""The port's self-managed snapshots (ceph_tpu_torch.osd.daemon's
make_writeable clones, snap reads, whiteouts and trim; the RADOS client's
snap context and read snap) against the JAX package's, on the CPU.

tests/test_snaps.py case for case through `torch_rbd_helpers.run_both`: each
JAX test body on JAX daemons and again with its `ceph_tpu` names bound to
the port's, on port daemons, its own assertions holding the bytes at head
and at every snap, and every store equal between the runs.  Then the cases
the JAX tests lack, each history on a JAX cluster and on a port one (or a
mixed one) with equal replies and equal stores:
- a JAX client on port OSDs, and a port client on JAX OSDs, taking
  snapshots on a replicated and an EC pool;
- a clone made while one shard's OSD is down, the OSD revived and
  recovered, the object read at the snap;
- a PG split with clones at rest;
- object classes at a snap on an EC object: a read method is served, write
  methods (numops add, hello record_hello) answer EROFS;
- a scrub of an EC whiteout (ROADMAP C13).
"""

import asyncio

import pytest

import test_snaps as j_snaps

from test_torch_osd import _rc, both, ec_profile, rand, snapshot
from torch_cluster_helpers import Cluster
from torch_cluster_helpers import one_torch_thread  # noqa: F401
from torch_rbd_helpers import run_both

EROFS = -30


@pytest.mark.parametrize("name", [
    "test_replicated_snap_round_trip_and_trim",
    "test_ec_snap_round_trip",
    "test_remove_with_snaps_whiteout_then_trim",
    "test_snap_before_creation_is_enoent",
])
def test_jax_snap_tests_on_both_packages(name):
    run_both(j_snaps, name)


async def _snap_history(cluster, plugin_kind: str) -> list:
    """Snap, overwrite (full and partial), read at each snap, remove with
    clones (whiteout), trim one snap: on a replicated and an EC pool.
    The pools go clean before the first write, so that every PG has
    peered at the same epoch in every run."""
    client = cluster.client
    await client.create_replicated_pool("rep", size=3, pg_num=8)
    await cluster.wait_for_clean()
    await client.create_ec_pool("ec", ec_profile(plugin_kind, 2, 2),
                                pg_num=8)
    await cluster.wait_for_clean()
    replies = []
    for pool in ("rep", "ec"):
        io = client.open_ioctx(pool)
        v1, v2, v3 = rand(1, 50_000), rand(2, 61_000), rand(3, 9_000)
        await io.write_full("obj", v1)
        await io.write_full("gone", v1[:7_000])
        s1 = await io.create_selfmanaged_snap()
        await io.write_full("obj", v2)
        s2 = await io.create_selfmanaged_snap()
        await io.write("obj", v3, 20_000)
        await io.remove("gone")
        head = bytearray(v2)
        head[20_000:29_000] = v3
        for snap, want in ((s1, v1), (s2, v2), (0, bytes(head))):
            io.snap_set_read(snap)
            got = await io.read("obj")
            assert got == want
            replies.append(len(got))
        io.snap_set_read(s2)
        replies.append(await io.read("gone") == v1[:7_000])
        io.snap_set_read(0)
        replies.append(await _rc(io.read("gone")))
        replies.append(await io.list_objects())
        await io.remove_selfmanaged_snap(s1)
        await asyncio.sleep(1.0)
        io.snap_set_read(s2)
        replies.append(await io.read("obj") == v2)
        io.snap_set_read(0)
    return replies


_RUNS: dict = {}


def _run_cluster(osd_kind: str, mon_kind: str, client_kind: str):
    """The history's replies and stores on a cluster of these kinds (each
    kind of cluster runs once in this module)."""
    key = (osd_kind, mon_kind, client_kind)
    if key not in _RUNS:
        _RUNS[key] = _run_history(*key)
    return _RUNS[key]


def _run_history(osd_kind: str, mon_kind: str, client_kind: str):
    async def main():
        cluster = Cluster(num_osds=5, osds_per_host=1,
                          kinds=[osd_kind] * 5, mon_kind=mon_kind,
                          client_kind=client_kind)
        await cluster.start()
        try:
            replies = await _snap_history(cluster, osd_kind)
            await asyncio.sleep(0.2)
            return replies, snapshot(cluster)
        finally:
            await cluster.stop()
    return asyncio.run(asyncio.wait_for(main(), 180))


@pytest.mark.parametrize("osd_kind, client_kind", [
    ("torch", "jax"), ("jax", "torch"),
], ids=["jax_client_port_osds", "port_client_jax_osds"])
def test_mixed_clusters_take_snapshots(osd_kind, client_kind):
    """A client of one package snapshots on OSDs (and a mon) of the other:
    the same replies and the same stores as an all-JAX cluster."""
    jrep, jsnap = _run_cluster("jax", "jax", "jax")
    mrep, msnap = _run_cluster(osd_kind, osd_kind, client_kind)
    assert mrep == jrep
    assert msnap == jsnap


def test_clone_while_a_shard_is_down_then_recovered():
    """EC 2+2: a snap, one shard's OSD killed and marked down, the object
    overwritten (the clone lands on the up shards), read at the snap
    degraded; the OSD revived, the PG recovered, the snap read again."""
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "ec", ec_profile(kind, 2, 2), pg_num=4)
        io = cluster.client.open_ioctx("ec")
        v1, v2 = rand(11, 40_000), rand(12, 45_000)
        await io.write_full("obj", v1)
        s1 = await io.create_selfmanaged_snap()
        acting, primary = cluster.client.osdmap.pg_to_acting_osds(
            io.object_pg("obj"))
        victim = next(o for o in acting if o != primary)
        await cluster.kill_osd(victim)
        await cluster.mark_down(victim)
        await io.write_full("obj", v2)
        replies = [victim]
        io.snap_set_read(s1)
        assert await io.read("obj") == v1
        io.snap_set_read(0)
        assert await io.read("obj") == v2
        await cluster.revive_osd(victim)
        await cluster.wait_for_clean(timeout=60.0)
        for snap, want in ((s1, v1), (0, v2)):
            io.snap_set_read(snap)
            got = await io.read("obj")
            assert got == want
            replies.append(len(got))
        io.snap_set_read(0)
        return replies
    both(work, num_osds=5, osds_per_host=1, timeout=180)


def test_pg_split_with_clones():
    """Objects with clones at rest when pg_num grows 4 -> 16: each OSD
    moves a head and its clones to the child PG together; heads read back
    through the new placement.  A clone is in no log entry of its own, so
    where a child PG maps to other OSDs than its parent, backfill moves
    the head and not its clones: reading such an object at the snap
    answers ENOENT, in the JAX package as in the port (ROADMAP C12).  Both
    packages' answers, object by object, must be equal, and so must the
    stores after a trim of the snap."""
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "sp", ec_profile(kind, 2, 1), pg_num=4)
        io = cluster.client.open_ioctx("sp")
        old = {f"obj-{i}": rand(30 + i, 3_000 + 977 * i) for i in range(12)}
        for oid, data in old.items():
            await io.write_full(oid, data)
        s1 = await io.create_selfmanaged_snap()
        new = {oid: rand(60 + i, 2_000 + 611 * i)
               for i, oid in enumerate(old)}
        for oid, data in new.items():
            await io.write_full(oid, data)
        before = {oid: io.object_pg(oid) for oid in old}
        rc, out = await cluster.client.mon_command(
            {"prefix": "osd pool set", "name": "sp", "var": "pg_num",
             "val": 16})
        assert rc == 0, out
        await cluster.client.wait_for_new_map()
        await cluster.wait_for_clean(timeout=60.0)
        replies = []
        for oid in old:
            io.snap_set_read(s1)
            got = await _rc(io.read(oid))
            replies.append(got == old[oid] or got)
            io.snap_set_read(0)
            assert await io.read(oid) == new[oid]
            replies.append(io.object_pg(oid).ps)
        # every object that stayed in its PG reads at the snap
        assert all(replies[2 * i] is True for i, oid in enumerate(old)
                   if io.object_pg(oid) == before[oid])
        s2 = await io.create_selfmanaged_snap()
        await io.remove_selfmanaged_snap(s1)
        await asyncio.sleep(1.0)
        io.snap_set_read(s2)
        for oid in old:
            assert await io.read(oid) == new[oid]
        io.snap_set_read(0)
        return replies
    both(work, num_osds=6, osds_per_host=2, timeout=180)


def test_object_classes_at_a_snap_on_an_ec_object():
    """At a snap an object-class call resolves to the clone: a read
    method runs there, write methods answer EROFS and change nothing."""
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "ec", ec_profile(kind, 2, 1), pg_num=4)
        io = cluster.client.open_ioctx("ec")
        await io.write_full("greeting", b"first")
        s1 = await io.create_selfmanaged_snap()
        await io.write_full("greeting", b"second version")
        io.snap_set_read(s1)
        replies = [await io.execute("greeting", "hello", "say_hello",
                                    b"snap")]
        for cls, method, data in (("numops", "add", b'{"key": "n",'
                                   b' "value": 1}'),
                                  ("hello", "record_hello", b"at snap")):
            rc = await _rc(io.execute("greeting", cls, method, data))
            assert rc == ("rc", EROFS)
            replies.append(rc)
        assert await io.read("greeting") == b"first"
        io.snap_set_read(0)
        assert await io.read("greeting") == b"second version"
        replies.append(await _rc(io.execute("greeting", "hello",
                                            "record_hello", b"head")))
        return replies
    both(work, num_osds=4, osds_per_host=2, timeout=180)


def test_snap_history_is_identical_on_both_packages():
    """The mixed-cluster history on an all-port cluster: the replies and
    stores of the all-JAX cluster."""
    jrep, jsnap = _run_cluster("jax", "jax", "jax")
    trep, tsnap = _run_cluster("torch", "torch", "torch")
    assert trep == jrep
    assert tsnap == jsnap


def test_scrub_of_an_ec_whiteout():
    """A removed EC object with clones keeps its head as a whiteout: its
    shards are truncated while the hinfo keeps the old size, so scrub
    reports every copy bad and its repair leaves the snap unreadable
    (ENOENT at the snap; ROADMAP C13), in the JAX package as in the port.
    The snap reads before the scrub, and the scrub's counts, the answers
    after it and the stores must be equal."""
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "ec", ec_profile(kind, 2, 2), pg_num=4)
        await cluster.wait_for_clean()
        io = cluster.client.open_ioctx("ec")
        v1 = rand(21, 30_000)
        await io.write_full("obj", v1)
        s1 = await io.create_selfmanaged_snap()
        await io.remove("obj")
        io.snap_set_read(s1)
        assert await io.read("obj") == v1
        _acting, primary = cluster.client.osdmap.pg_to_acting_osds(
            io.object_pg("obj"))
        rc, out = await cluster.client.osd_command(primary,
                                                   {"prefix": "scrub"})
        assert rc == 0
        assert out["errors"] >= 1
        at_snap = await _rc(io.read("obj"))
        io.snap_set_read(0)
        return [rc, out, at_snap == v1 or at_snap,
                await _rc(io.read("obj"))]
    both(work, num_osds=5, osds_per_host=1, timeout=180)
