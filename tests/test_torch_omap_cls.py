"""Omap, object classes and watch/notify in the port's OSD daemon and RADOS
client (ceph_tpu_torch.osd.daemon, .rados.client, .cls) against the JAX
package's, on the CPU.

Each workload runs on a JAX cluster and on a port cluster (`both` of
tests/test_torch_osd.py): the replies and every MemStore (objects, xattrs,
omap, pg logs) must be equal.  The workloads mirror
tests/test_client_ops.py (the omap round trip with a kill, an out, a revive
and recovery; watch/notify between two clients), the four tests of
tests/test_cls.py and the cls call in tests/test_lockdep.py's cluster
workload, which here runs under the port's lockdep with every recorded
order edge in the JAX package's static lock graph.  Then the port's own:
an object-class write on an EC 2+1 object goes down the EC write path
(numops, which keeps its value in omap, answers EOPNOTSUPP there in both
packages), omap on an EC pool answers EOPNOTSUPP, and mixed clusters both
ways (a port client on JAX OSDs, a JAX client on port OSDs) give the
answers and stores of an all-JAX run.
"""

import asyncio
import json
import os

import pytest

from torch_cluster_helpers import Cluster
from torch_cluster_helpers import one_torch_thread  # noqa: F401
from test_torch_osd import _rc, both, ec_profile, run, snapshot

REQ = json.dumps({"key": "n", "value": 7}).encode()


def _req(**kw) -> bytes:
    return json.dumps(kw).encode()


async def _rep_pool(cluster, name: str = "p", size: int = 3) -> object:
    await cluster.client.create_replicated_pool(name, size=size, pg_num=8)
    return cluster.client.open_ioctx(name)


# -- tests/test_client_ops.py ------------------------------------------------

def test_omap_round_trip_and_recovery():
    """Omap set, rm and get; the omap survives a kill (read from a peer),
    a write while the dead OSD is out, and its revival and recovery."""
    async def workload(cluster, kind):
        io = await _rep_pool(cluster)
        out = []
        await io.write_full("idx", b"")
        await io.omap_set("idx", {"k1": b"v1", "k2": b"v2", "k3": b"v3"})
        await io.omap_rm_keys("idx", ["k2"])
        out.append(await io.omap_get("idx"))
        await cluster.kill_osd(0)
        await cluster.mark_down(0)
        out.append(await io.omap_get("idx"))
        await cluster.mark_out(0)
        await io.omap_set("idx", {"k4": b"v4"})
        await cluster.mark_in(0)
        await cluster.revive_osd(0)
        await cluster.wait_for_osd_up(0)
        await cluster.wait_for_clean()
        out.append(await io.omap_get("idx"))
        out.append(await _rc(io.omap_get("nosuch")))
        return out

    res = both(workload, num_osds=4)
    assert res["torch"][0][0] == {"k1": b"v1", "k3": b"v3"}
    assert res["torch"][0][2] == {"k1": b"v1", "k3": b"v3", "k4": b"v4"}


def _names(res, me: str):
    """A notify reply with the harness client's random name as "me"."""
    return {k: sorted([("me" if who == me else who), c] for who, c in v)
            for k, v in res.items()}


def test_watch_notify():
    """Watchers are (client, cookie) pairs: two clients' watchers are
    notified and acked; an unwatched cookie is no longer notified."""
    async def workload(cluster, kind):
        io = await _rep_pool(cluster)
        await io.write_full("obj", b"watched")
        me = cluster.client.msgr.entity_name
        out = []
        got: list = []
        cookie = await io.watch("obj", lambda p: got.append(p))
        out.append(_names(await io.notify("obj", b"ping-1"), me))
        client2 = cluster.new_client(kind, name="client.2")
        await client2.connect()
        try:
            io2 = client2.open_ioctx("p")
            got2: list = []
            c2 = await io2.watch("obj", lambda p: got2.append(p))
            out.append(_names(await io.notify("obj", b"ping-2"), me))
            out.append((cookie, c2, list(got), list(got2)))
            await io2.unwatch("obj", c2)
        finally:
            await client2.shutdown()
        if kind == "torch":
            # the port's shutdown waits for its keepalive task to end
            assert client2._watch_keepalive is None
        out.append(_names(await io.notify("obj", b"ping-3"), me))
        await io.unwatch("obj", cookie)
        out.append(_names(await io.notify("obj", b"ping-4"), me))
        out.append(list(got))
        return out

    res = both(workload, num_osds=4)
    out = res["torch"][0]
    assert out[0] == {"acked": [["me", 1]], "missed": []}
    assert out[1] == {"acked": [["client.2", 1], ["me", 1]], "missed": []}
    assert out[4] == {"acked": [], "missed": []}
    assert out[5] == [b"ping-1", b"ping-2", b"ping-3"]


# -- tests/test_cls.py -------------------------------------------------------

def test_hello_round_trip():
    async def workload(cluster, kind):
        io = await _rep_pool(cluster)
        return [await io.execute("obj", "hello", "say_hello", b"tpu"),
                await io.execute("obj", "hello", "record_hello", b"ceph"),
                await io.execute("obj", "hello", "replay"),
                await io.read("obj"),
                # double-record refuses (EEXIST from inside the class)
                await _rc(io.execute("obj", "hello", "record_hello",
                                     b"x")),
                # an unknown class or method is EINVAL, not a crash
                await _rc(io.execute("obj", "nosuch", "m"))]

    out = both(workload, num_osds=4, osds_per_host=1)["torch"][0]
    assert out[0] == b"Hello, tpu!"
    assert out[2] == out[3] == b"Hello, ceph!"
    assert out[4] == ("rc", -17) and out[5] == ("rc", -22)


def test_numops_atomic_increments():
    """Concurrent adds on one key all land (the class runs atomically
    under the object-class lock); mul, and div by zero refused."""
    async def workload(cluster, kind):
        io = await _rep_pool(cluster)
        req = _req(key="ctr", value=1)
        await asyncio.gather(*(io.execute("counter", "numops", "add", req)
                               for _ in range(20)))
        return [await io.omap_get("counter"),
                await io.execute("counter", "numops", "mul",
                                 _req(key="ctr", value=3)),
                await _rc(io.execute("counter", "numops", "div",
                                     _req(key="ctr", value=0)))]

    out = both(workload, num_osds=4, osds_per_host=1)["torch"][0]
    assert float(out[0]["ctr"].decode()) == 20.0
    assert float(out[1].decode()) == 60.0
    assert out[2] == ("rc", -22)


def test_lock_exclusive_shared():
    async def workload(cluster, kind):
        io = await _rep_pool(cluster)
        out = []
        await io.execute("img", "lock", "lock", _req(
            name="l", type="exclusive", owner="client.a", cookie="c1"))
        # renewal by the same owner and cookie is fine
        await io.execute("img", "lock", "lock", _req(
            name="l", type="exclusive", owner="client.a", cookie="c1"))
        out.append(await _rc(io.execute("img", "lock", "lock", _req(
            name="l", type="exclusive", owner="client.b", cookie="c2"))))
        out.append(await _rc(io.execute("img", "lock", "unlock", _req(
            name="l", owner="client.b", cookie="c2"))))
        out.append(json.loads(await io.execute(
            "img", "lock", "get_info", _req(name="l"))))
        # break_lock evicts; then shared lockers coexist
        await io.execute("img", "lock", "break_lock", _req(
            name="l", locker="client.a", cookie="c1"))
        for owner, cookie in (("client.b", "c2"), ("client.c", "c3")):
            await io.execute("img", "lock", "lock", _req(
                name="l", type="shared", owner=owner, cookie=cookie))
        out.append(json.loads(await io.execute(
            "img", "lock", "get_info", _req(name="l"))))
        return out

    out = both(workload, num_osds=4, osds_per_host=1)["torch"][0]
    assert out[0] == ("rc", -16) and out[1][0] == "rc"
    assert out[2]["type"] == "exclusive" and len(out[2]["lockers"]) == 1
    assert len(out[3]["lockers"]) == 2


def test_cls_writes_replicate_and_survive_failover():
    """State a class method wrote is served by the next primary."""
    async def workload(cluster, kind):
        io = await _rep_pool(cluster)
        out = [await io.execute("obj", "numops", "add", REQ)]
        _acting, primary = cluster.mon.osdmap.pg_to_acting_osds(
            io.object_pg("obj"))
        await cluster.kill_osd(primary)
        await cluster.mark_down(primary)
        out.append(await io.execute("obj", "numops", "add", REQ))
        return out

    out = both(workload, num_osds=4, osds_per_host=1)["torch"][0]
    assert [float(v.decode()) for v in out] == [7.0, 14.0]


# -- the port's own ----------------------------------------------------------

def test_cls_write_on_an_ec_object_takes_the_ec_path():
    """`hello.record_hello` on an EC 2+1 object writes its data and xattr
    down the EC write path (shards and hinfo equal to the JAX package's);
    numops, whose value lives in omap, answers EOPNOTSUPP there as in the
    reference, and so do omap set and get."""
    async def workload(cluster, kind):
        await cluster.client.create_ec_pool(
            "ec", ec_profile(kind, 2, 1), pg_num=8)
        io = cluster.client.open_ioctx("ec")
        await io.write_full("other", b"x" * 10000)
        return [await io.execute("greet", "hello", "record_hello", b"ec"),
                await io.read("greet"),
                await io.execute("greet", "hello", "replay"),
                await _rc(io.execute("greet", "numops", "add", REQ)),
                await _rc(io.execute("ctr", "numops", "add", REQ)),
                await _rc(io.omap_set("other", {"a": b"1"})),
                await _rc(io.omap_get("other"))]

    out = both(workload, num_osds=4)["torch"][0]
    assert out[1] == out[2] == b"Hello, ec!"
    assert out[3:] == [("rc", -95)] * 4


def test_cls_lock_edges_in_the_static_graph():
    """tests/test_lockdep.py's cluster workload (writes, a cls exec,
    scrub) on port OSDs under the port's lockdep: the exec nests
    `osd.clslock` -> `osd.objlock`, and every order edge recorded is an
    edge of the JAX package's static lock graph
    (ceph_tpu/analysis/lockgraph.py)."""
    import ceph_tpu
    from ceph_tpu.analysis.core import build_project
    from ceph_tpu.analysis.lockgraph import build_lock_graph
    from ceph_tpu_torch.common import lockdep as tlockdep

    async def main():
        cluster = Cluster(num_osds=3)
        await cluster.start()
        try:
            io = await _rep_pool(cluster, "ld", size=2)
            await io.write_full("obj", b"x" * 9000)
            await io.write("obj", b"yyy", 100)
            await io.execute("ctr", "numops", "add", _req(key="n",
                                                          value=2))
            for osd_id in sorted(cluster.osds):
                await cluster.client.osd_command(osd_id,
                                                 {"prefix": "scrub"})
            await cluster.wait_for_clean(timeout=30.0)
            assert await io.read("obj", 100, 3) == b"yyy"
        finally:
            await cluster.stop()

    was = tlockdep.enabled
    tlockdep.enabled = True
    tlockdep.reset()
    try:
        run(main())
        recorded = {(a, b) for a, bs in tlockdep._edges.items()
                    for b in bs}
    finally:
        tlockdep.enabled = was
        tlockdep.reset()
    assert ("osd.clslock", "osd.objlock") in recorded, recorded
    adj, _ = build_lock_graph(build_project(
        [os.path.dirname(os.path.abspath(ceph_tpu.__file__))]))
    assert not [e for e in recorded if e[1] not in adj.get(e[0], set())]


MIXES = {
    "jax": dict(kinds=["jax"] * 4, mon_kind="jax", client_kind="jax"),
    "port_client_on_jax_osds": dict(kinds=["jax"] * 4, mon_kind="jax",
                                    client_kind="torch"),
    "jax_client_on_port_osds": dict(kinds=["torch"] * 4, mon_kind="torch",
                                    client_kind="jax"),
}


def _mixed_run(mix: str):
    async def main():
        cluster = Cluster(num_osds=4, osds_per_host=1, **MIXES[mix])
        await cluster.start()
        try:
            io = await _rep_pool(cluster)
            me = cluster.client.msgr.entity_name
            out = []
            await io.write_full("idx", b"head")
            await io.omap_set("idx", {"a": b"1", "b": b"2"})
            await io.omap_rm_keys("idx", ["a"])
            out.append(await io.omap_get("idx"))
            out.append(await io.execute("ctr", "numops", "add", REQ))
            out.append(await io.execute("ctr", "numops", "add", REQ))
            out.append(await io.omap_get("ctr"))
            out.append(await io.execute("g", "hello", "record_hello",
                                        b"mix"))
            out.append(await io.execute("g", "hello", "replay"))
            got: list = []
            cookie = await io.watch("idx", lambda p: got.append(p))
            out.append(_names(await io.notify("idx", b"n1"), me))
            await io.unwatch("idx", cookie)
            out.append(_names(await io.notify("idx", b"n2"), me))
            out.append(list(got))
            await asyncio.sleep(0.2)
            return out, snapshot(cluster)
        finally:
            await cluster.stop()
    return run(main())


@pytest.mark.parametrize("mix", ["port_client_on_jax_osds",
                                 "jax_client_on_port_osds"])
def test_mixed_clusters_answer_as_an_all_jax_one(mix):
    """A port client on JAX OSDs and a JAX client on port OSDs: the omap,
    the object-class results, the notify acks (the OSD matches an ack to
    its watcher by the client's entity name on the wire) and the stores
    are those of an all-JAX run."""
    want, want_snap = _mixed_run("jax")
    got, got_snap = _mixed_run(mix)
    assert got == want
    assert got[6] == {"acked": [["me", 1]], "missed": []}
    assert got_snap == want_snap
