"""CephFS histories the JAX package's tests do not cover, compared between
the packages on the CPU: a file system on an EC 2+1 data pool, and mixed
clusters (an MDS of one package over OSDs of the other, and a standby of
one package taking over from an active of the other and replaying its
journal).

Each history runs once on a reference cluster (JAX OSDs, JAX MDS daemons,
a JAX client) and once on the cluster under test; both runs share one
fake clock and one seeded stream of names (torch_cephfs_helpers.bind),
their answers must be equal, and so must every store.  The on-disk
format (directory objects, the journal, the snap table, `mds_map`,
`mds_ino`, the data objects) is the state the packages share: nothing
is converted when an MDS of the other package takes over.
"""

import asyncio
import importlib
import time as _time

import numpy as np
import pytest

from torch_cephfs_helpers import bind, clock_free, compare, run_workload
from torch_cluster_helpers import one_torch_thread  # noqa: F401
from torch_rgw_helpers import harness

ROOT = {"jax": "ceph_tpu", "torch": "ceph_tpu_torch"}
EC21 = {"plugin": "ec_jax", "technique": "reed_sol_van", "k": "2",
        "m": "1", "crush-failure-domain": "osd"}
MiB = 1 << 20


def _pkg(kind: str, name: str):
    return importlib.import_module(f"{ROOT[kind]}.{name}")


def _bytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


async def _wait_active(mds, timeout: float = 30.0) -> None:
    deadline = _time.monotonic() + timeout
    while mds.state != "active":
        assert _time.monotonic() < deadline, (mds.name, mds.state)
        await asyncio.sleep(0.05)


def test_ec21_data_pool_history():
    """On an EC 2+1 data pool (4 MiB blocks over 2 data shards): a 9 MiB
    file written in three pieces, 100 KB overwritten mid-file across a
    block edge, a snapshot, a further overwrite and an append, the file
    read at the snapshot and at head, truncated to a size inside a
    block, read again, and the snapshot removed.  Every read is held
    against a numpy copy of the file at its version."""
    async def work(cluster, kind):
        mds_mod, fs_mod = _pkg(kind, "mds"), _pkg(kind, "cephfs")
        await cluster.client.create_replicated_pool("fs.meta", size=2,
                                                    pg_num=4)
        await cluster.client.create_ec_pool("fs.data", dict(EC21),
                                            pg_num=4)
        mds = mds_mod.MDSDaemon(cluster.mon.addr, "fs.meta", "fs.data",
                                lock_interval=0.3)
        await mds.start()
        try:
            await _wait_active(mds)
            fs = fs_mod.CephFS(cluster.client, "fs.meta", "fs.data")
            rng = np.random.default_rng(23)
            head = np.frombuffer(_bytes(rng, 9 * MiB), np.uint8).copy()
            await fs.mkdir("/ec")
            f = await fs.open("/ec/big", "w")
            for lo, hi in ((0, 3 * MiB), (3 * MiB, 7 * MiB + 5),
                           (7 * MiB + 5, 9 * MiB)):
                await f.write(lo, head[lo:hi].tobytes())
            await f.close()
            patch = _bytes(rng, 100_000)
            off = 4 * MiB - 50_000
            await _write_at(fs, "/ec/big", off, patch)
            head[off:off + len(patch)] = np.frombuffer(patch, np.uint8)
            at_s1 = head.tobytes()
            await fs.mksnap("/ec", "s1")
            patch2 = _bytes(rng, 70_000)
            off2 = 6 * MiB + 12_345
            await _write_at(fs, "/ec/big", off2, patch2)
            head[off2:off2 + len(patch2)] = np.frombuffer(patch2, np.uint8)
            tail = _bytes(rng, 300_000)
            await _write_at(fs, "/ec/big", 9 * MiB, tail)
            head = np.concatenate([head, np.frombuffer(tail, np.uint8)])
            got_snap = await fs.read_file("/ec/.snap/s1/big")
            got_head = await fs.read_file("/ec/big")
            assert got_snap == at_s1
            assert got_head == head.tobytes()
            cut = 5 * MiB + 777
            await fs.truncate("/ec/big", cut)
            got_cut = await fs.read_file("/ec/big")
            assert got_cut == head[:cut].tobytes()
            assert await fs.read_file("/ec/.snap/s1/big") == at_s1
            st = await fs.stat("/ec/big")
            await fs.rmsnap("/ec", "s1")
            return [len(got_snap), len(got_head), len(got_cut), st["size"],
                    await fs.listdir("/ec"),
                    await fs.listdir("/ec/.snap")]
        finally:
            await mds.stop()
    run_workload(work, cluster_kw={"num_osds": 4}, timeout=240)


async def _write_at(fs, path: str, offset: int, data: bytes) -> None:
    f = await fs.open(path, "r+")
    try:
        await f.write(offset, data)
    finally:
        await f.close()


# -- mixed clusters --------------------------------------------------------

# (OSDs, the active MDS, the standby, in package kinds); the reference
# run is all JAX
_MIXED = {
    "jax_mds_on_port_osds": ("torch", "jax", "jax"),
    "port_standby_replays_jax_journal": ("jax", "jax", "torch"),
    "jax_standby_replays_port_journal": ("torch", "torch", "jax"),
}


async def _one_shot_rename(fs_mod, client, addr: str, src: str,
                           dst: str) -> None:
    """One unretried rename request (tests/test_cephfs.py's): the active
    dies after its journal append and never answers."""
    msgs = _pkg("jax" if fs_mod.__name__.startswith("ceph_tpu.")
                else "torch", "msg.messages")
    tid = client._next_tid()
    fut = asyncio.get_running_loop().create_future()
    client._futures[tid] = fut
    try:
        await client.msgr.send_to(addr, msgs.MClientRequest(
            tid, "rename", {"src": src, "dst": dst}))
        await asyncio.wait_for(fut, 3.0)
    except Exception:
        pass
    finally:
        client._futures.pop(tid, None)


async def _takeover_history(cluster, osd_kind, active_kind, standby_kind):
    """An active writes a tree and a snapshot, journals a rename and dies
    before applying it; the standby breaks its lock, replays the journal
    (the rename lands), and a client of the standby's package reads
    every file at head and at the snapshot and writes one more."""
    await cluster.client.create_replicated_pool("fs.meta", size=2,
                                                pg_num=4)
    await cluster.client.create_ec_pool("fs.data", dict(EC21), pg_num=4)
    a = _pkg(active_kind, "mds").MDSDaemon(
        cluster.mon.addr, "fs.meta", "fs.data", name="a",
        lock_interval=0.3)
    await a.start()
    await _wait_active(a)
    b = _pkg(standby_kind, "mds").MDSDaemon(
        cluster.mon.addr, "fs.meta", "fs.data", name="b",
        lock_interval=0.3)
    await b.start()
    clients = []
    try:
        rc_a = cluster.new_client(active_kind)
        await rc_a.connect()
        clients.append(rc_a)
        fs_mod = _pkg(active_kind, "cephfs")
        fs_a = fs_mod.CephFS(rc_a, "fs.meta", "fs.data")
        rng = np.random.default_rng(29)
        files = {"/d1/x": _bytes(rng, 300_000),
                 "/d1/y": _bytes(rng, 5 * MiB + 3)}
        await fs_a.mkdir("/d1")
        await fs_a.mkdir("/d2")
        for path, data in files.items():
            await fs_a.write_file(path, data)
        await fs_a.mksnap("/d1", "s1")
        patch = _bytes(rng, 40_000)
        await _write_at(fs_a, "/d1/y", 4 * MiB - 1000, patch)
        y = bytearray(files["/d1/y"])
        y[4 * MiB - 1000:4 * MiB - 1000 + len(patch)] = patch
        a._fail_after_journal = True
        await _one_shot_rename(fs_mod, rc_a, a.msgr.addr, "/d1/x",
                               "/d2/x")
        await _wait_active(b)
        rc_b = cluster.new_client(standby_kind)
        await rc_b.connect()
        clients.append(rc_b)
        fs_b = _pkg(standby_kind, "cephfs").CephFS(rc_b, "fs.meta",
                                                   "fs.data")
        out = [sorted(await fs_b.listdir("/d1")),
               sorted(await fs_b.listdir("/d2"))]
        assert await fs_b.read_file("/d2/x") == files["/d1/x"]
        assert await fs_b.read_file("/d1/y") == bytes(y)
        assert await fs_b.read_file("/d1/.snap/s1/y") == files["/d1/y"]
        assert await fs_b.read_file("/d1/.snap/s1/x") == files["/d1/x"]
        await fs_b.write_file("/d2/z", b"after the takeover")
        assert await fs_b.read_file("/d2/z") == b"after the takeover"
        out.append(sorted(await fs_b.listdir("/d2")))
        out.append((await fs_b.stat("/d1/y"))["size"])
        return out
    finally:
        await b.stop()
        if a.client is not None:
            await a.client.shutdown()
        for rc in clients:
            await rc.shutdown()


@pytest.mark.parametrize("case", sorted(_MIXED))
def test_mixed_cluster_takeover(case):
    """The history of `_takeover_history` on an all-JAX cluster and on
    the mixed one: equal answers, equal stores."""
    base = float(int(_time.time()))
    snaps, replies = {}, {}
    for label, kinds in (("jax", ("jax",) * 3), ("torch", _MIXED[case])):
        snaps[label] = []
        with pytest.MonkeyPatch.context() as mp:
            # the clocks and the seeded names; no module is rebound:
            # each daemon is of the package the case names
            bind(mp, "jax", (), snaps[label], base)
            cluster = clock_free(harness(kinds[0], snaps[label]))(
                num_osds=4)

            async def main():
                await cluster.start()
                try:
                    return await _takeover_history(cluster, *kinds)
                finally:
                    await cluster.stop()
            replies[label] = asyncio.run(asyncio.wait_for(main(), 180))
    assert replies["torch"] == replies["jax"]
    compare(snaps)


# -- ROADMAP C14: a resent snapshot request --------------------------------

class _ShortWaits:
    """A cephfs module's `asyncio` with the client's reply wait cut to
    `limit` seconds (its 10 s, for a test)."""

    def __init__(self, limit: float):
        self._limit = limit

    def wait_for(self, aw, timeout):
        return asyncio.wait_for(aw, min(timeout, self._limit))

    def __getattr__(self, name):
        return getattr(asyncio, name)


def test_resent_mksnap_answers_eexist_in_both_packages():
    """ROADMAP C14, copied by the port: the client resends a request
    whose reply outlives its wait (`CephFS._request`, 10 s) and the MDS
    keeps no record of completed requests, so the resent `mksnap` answers
    EEXIST for the snapshot its first send made (and a resent `rmsnap`
    ENOENT).  Here the MDS holds its reply to the first send 1.5 s and
    the client waits 0.5 s a send: `mksnap` raises rc -17 though that
    first send made the snapshot, which exists once."""
    async def work(cluster, kind):
        mds_mod, fs_mod = _pkg(kind, "mds"), _pkg(kind, "cephfs")
        await cluster.client.create_replicated_pool("fs.meta", size=2,
                                                    pg_num=4)
        await cluster.client.create_replicated_pool("fs.data", size=2,
                                                    pg_num=4)
        mds = mds_mod.MDSDaemon(cluster.mon.addr, "fs.meta", "fs.data",
                                lock_interval=0.3)
        op, calls = mds._op_mksnap, []

        async def slow_mksnap(args, conn=None):
            out = await op(args, conn)
            calls.append(out[0])
            if len(calls) == 1:
                await asyncio.sleep(1.5)    # the first send's reply is late
            return out
        mds._op_mksnap = slow_mksnap
        await mds.start()
        try:
            await _wait_active(mds)
            fs = fs_mod.CephFS(cluster.client, "fs.meta", "fs.data")
            await fs.mkdir("/d")
            await fs.write_file("/d/f", b"before the snapshot")
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(fs_mod, "asyncio", _ShortWaits(0.5))
                with pytest.raises(fs_mod.CephFSError) as err:
                    await fs.mksnap("/d", "s1")
            snaps = [s["name"] for s in await fs.lssnap("/d")]
            assert snaps == ["s1"]
            assert await fs.read_file("/d/.snap/s1/f") == \
                b"before the snapshot"
            return [err.value.rc, calls[0], snaps]
        finally:
            await mds.stop()
    replies = run_workload(work, cluster_kw={"num_osds": 3}, timeout=120)
    assert replies["jax"][:2] == [-17, 0]    # EEXIST; the first send made it


def test_stalled_active_serves_after_its_lock_is_broken_in_both_packages():
    """ROADMAP C15, copied by the port: an active MDS steps down only when
    its own lock call fails (`MDSDaemon._try_acquire_or_renew`), and
    `_dispatch` serves while `state` says active, so an active whose
    renewals stall past five lock intervals goes on answering after a
    standby broke its lock and took the rank: two daemons serve one rank.
    Here the active's renewals stop (its lock loop's body does nothing),
    the standby takes over, and the stalled active still answers a
    `readdir` from the client that was routed to it."""
    async def work(cluster, kind):
        mds_mod, fs_mod = _pkg(kind, "mds"), _pkg(kind, "cephfs")
        await cluster.client.create_replicated_pool("fs.meta", size=2,
                                                    pg_num=4)
        await cluster.client.create_replicated_pool("fs.data", size=2,
                                                    pg_num=4)
        old = mds_mod.MDSDaemon(cluster.mon.addr, "fs.meta", "fs.data",
                                name="a", lock_interval=0.3)
        new = mds_mod.MDSDaemon(cluster.mon.addr, "fs.meta", "fs.data",
                                name="b", lock_interval=0.3)
        await old.start()
        try:
            await _wait_active(old)
            await new.start()
            fs = fs_mod.CephFS(cluster.client, "fs.meta", "fs.data")
            await fs.mkdir("/d")
            await fs.write_file("/d/f", b"one")

            async def stalled():
                return None
            old._try_acquire_or_renew = stalled     # no renewal, no step-down
            await _wait_active(new)
            served = old.ops_served
            listing = await fs.listdir("/d")        # routed to the old active
            return [old.state, new.state, old.ops_served - served, listing]
        finally:
            await new.stop()
            await old.stop()
    replies = run_workload(work, cluster_kw={"num_osds": 3}, timeout=120)
    assert replies["jax"] == ["active", "active", 1, ["f"]]
