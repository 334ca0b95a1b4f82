"""The port's OSD daemons and client on one wire with the JAX package's, the
edges of the slice, and the port's OSD process entry point, on the CPU.

- a JAX RadosClient against port OSDs (port mon), a port RadosClient
  against JAX OSDs (JAX mon), and one cluster with OSDs of both packages
  in a `jerasure` 4+2 pool (the name both registries know), clients of
  both packages reading each other's bytes, healthy and degraded;
- omap on an EC pool answers EOPNOTSUPP, as in the reference; omap,
  object classes and watch/notify are served, and so are snapshot writes
  and snap reads (equal to the JAX OSDs' replies and stores);
  recovery of a peer's missing object and a post-write repair run, and
  a pg_num increase after them splits the port OSDs' PGs; an OSD with
  no CUDA and no device named raises;
- four `python -m ceph_tpu_torch.osd --device cpu` processes under an
  in-loop port mon serve a port client's writes and reads.
"""

import asyncio
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ceph_tpu_torch.osd import daemon as tdaemon
from ceph_tpu_torch.msg.messages import OSDOp

from test_torch_osd import _rc, snapshot
from torch_cluster_helpers import FAST_CONFIG, FAST_MON_CONFIG, Cluster
from torch_cluster_helpers import one_torch_thread  # noqa: F401
from torch_mon_helpers import pkg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(coro, timeout: float = 120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def rand(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def profile(plugin: str, k: int, m: int) -> dict:
    # "tpu": "false" keeps a JAX codec on its host path; the port's
    # codec ignores the key
    return {"plugin": plugin, "technique": "reed_sol_van", "k": str(k),
            "m": str(m), "crush-failure-domain": "osd", "tpu": "false"}


async def _write_read(cluster, client, pool: str, payloads: dict):
    io = client.open_ioctx(pool)
    for name, data in payloads.items():
        await io.write_full(name, data)
    for name, data in payloads.items():
        assert await io.read(name) == data
        assert await io.read(name, 1000, 3000) == data[1000:4000]


@pytest.mark.parametrize("osd_kind, client_kind, plugin", [
    ("torch", "jax", "ec_torch"),
    ("jax", "torch", "ec_jax"),
], ids=["jax_client_port_osds", "port_client_jax_osds"])
def test_client_of_one_package_on_osds_of_the_other(osd_kind, client_kind,
                                                    plugin):
    async def main():
        cluster = Cluster(num_osds=4, kinds=[osd_kind] * 4,
                          mon_kind=osd_kind, client_kind=client_kind)
        await cluster.start()
        try:
            await cluster.client.create_ec_pool(
                "ec", profile(plugin, 2, 1), pg_num=8)
            await cluster.client.create_replicated_pool("rep", size=2,
                                                        pg_num=8)
            payloads = {f"o{i}": rand(i, 30_000 + 999 * i)
                        for i in range(5)}
            await _write_read(cluster, cluster.client, "ec", payloads)
            await _write_read(cluster, cluster.client, "rep", payloads)
            io = cluster.client.open_ioctx("ec")
            await io.write("o1", b"Z" * 5000, 12_345)
            want = bytearray(payloads["o1"])
            want[12_345:17_345] = b"Z" * 5000
            assert await io.read("o1") == bytes(want)
            await io.setxattr("o2", "k", b"v")
            assert await io.getxattrs("o2") == {"k": b"v"}
            assert await io.list_objects() == sorted(payloads)
        finally:
            await cluster.stop()
    run(main())


@pytest.mark.parametrize("mon_kind", ["torch", "jax"])
def test_mixed_cluster_jerasure_pool(mon_kind):
    """OSDs of both packages in one jerasure 4+2 pool: every object's
    shards land on daemons of both kinds; clients of both packages read
    every byte back, healthy and with two OSDs (one of each kind)
    killed."""
    kinds = ["torch", "jax"] * 3

    async def main():
        cluster = Cluster(num_osds=6, osds_per_host=1, kinds=kinds,
                          mon_kind=mon_kind, client_kind="torch")
        await cluster.start()
        other = cluster.new_client("jax")
        await other.connect()
        try:
            await cluster.client.create_ec_pool(
                "ec", profile("jerasure", 4, 2), pg_num=8)
            await cluster.wait_for_clean()
            port_io = cluster.client.open_ioctx("ec")
            jax_io = other.open_ioctx("ec")
            payloads = {f"o{i}": rand(50 + i, 40_000 + 4321 * i)
                        for i in range(8)}
            for i, (name, data) in enumerate(payloads.items()):
                io = port_io if i % 2 else jax_io
                await io.write_full(name, data)
            for io in (port_io, jax_io):
                for name, data in payloads.items():
                    assert await io.read(name) == data
            await port_io.write("o3", b"p" * 777, 30_001)
            want = bytearray(payloads["o3"])
            want[30_001:30_778] = b"p" * 777
            payloads["o3"] = bytes(want)
            # the same object's shards in every store: the hinfo written
            # by either package's primary is the one the other checks
            for victim in (0, 1):
                await cluster.kill_osd(victim)
                await cluster.mark_down(victim)
            await cluster.wait_for_clean()
            for io in (port_io, jax_io):
                for name, data in payloads.items():
                    assert await io.read(name) == data
        finally:
            await other.shutdown()
            await cluster.stop()
    run(main(), 180)


# -- the edges of the slice -------------------------------------------------

def test_later_families_answer_eopnotsupp():
    async def main():
        cluster = Cluster(num_osds=4, client_kind="jax")
        await cluster.start()
        try:
            await cluster.client.create_replicated_pool("rep", size=2,
                                                        pg_num=8)
            await cluster.client.create_ec_pool(
                "ec", profile("ec_torch", 2, 1), pg_num=8)
            io = cluster.client.open_ioctx("rep")
            await io.write_full("obj", b"data")
            jerr = pkg("jax", "rados.client").RadosError
            # omap, object classes and watch/notify are served
            await io.omap_set("obj", {"a": b"1"})
            assert await io.omap_get("obj") == {"a": b"1"}
            assert await io.execute("obj", "hello", "say_hello") == \
                b"Hello, world!"
            cookie = await io.watch("obj", lambda payload: None)
            res = await io.notify("obj", b"x")
            assert res["acked"] == [[cluster.client.msgr.entity_name,
                                     cookie]]
            await io.unwatch("obj", cookie)
            # omap on an EC pool answers EOPNOTSUPP, as in the reference
            eio = cluster.client.open_ioctx("ec")
            await eio.write_full("obj", b"data")
            for call in (eio.omap_set("obj", {"a": b"1"}),
                         eio.omap_get("obj")):
                with pytest.raises(jerr) as e:
                    await call
                assert e.value.rc == tdaemon.EOPNOTSUPP
            # the port client's own wire ops answer the same
            tio = cluster.new_client("torch")
            await tio.connect()
            try:
                reply = await tio.open_ioctx("ec")._submit(
                    "obj", [OSDOp("omap_get")])
                assert reply.rc == tdaemon.EOPNOTSUPP
            finally:
                await tio.shutdown()
        finally:
            await cluster.stop()
    run(main())


def _snap_ops(osd_kind: str):
    """Snapshot writes and snap reads from a JAX client on OSDs (and a
    mon) of `osd_kind`: the replies and every store."""
    async def main():
        cluster = Cluster(num_osds=4, kinds=[osd_kind] * 4,
                          mon_kind=osd_kind, client_kind="jax")
        await cluster.start()
        try:
            await cluster.client.create_replicated_pool("rep", size=2,
                                                        pg_num=8)
            await cluster.wait_for_clean()
            io = cluster.client.open_ioctx("rep")
            await io.write_full("obj", b"data")
            snap = await io.create_selfmanaged_snap()
            replies = [snap, await _rc(io.write_full("obj", b"new"))]
            io.snap_set_read(snap)
            replies.append(await _rc(io.read("obj")))
            io.snap_set_read(0)
            replies.append(await _rc(io.read("obj")))
            await asyncio.sleep(0.2)
            return replies, snapshot(cluster)
        finally:
            await cluster.stop()
    return run(main())


def test_snap_writes_and_reads_are_served():
    """The snapshot half of the edges above, served since snapshots were
    ported: a JAX client's snap-context write clones the head and its
    snap read returns the old bytes, on port OSDs as on JAX OSDs, with
    equal replies and equal stores."""
    trep, tsnap = _snap_ops("torch")
    jrep, jsnap = _snap_ops("jax")
    assert trep[1:] == [{}, b"data", b"new"]
    assert trep == jrep
    assert tsnap == jsnap


def test_pg_split_after_recovery_and_repair():
    """The recovery of a peer's missing object and the post-write repair
    run to their end; then a pg_num increase splits the port OSDs' PGs
    (it raised before the split slice): every OSD records the new pg_num
    in its `osd_meta` collection and the object reads back through its
    new placement."""
    async def main():
        cluster = Cluster(num_osds=4)
        await cluster.start()
        try:
            await cluster.client.create_ec_pool(
                "ec", profile("ec_torch", 2, 1), pg_num=8)
            await cluster.wait_for_clean()
            io = cluster.client.open_ioctx("ec")
            await io.write_full("obj", b"q" * 10_000)
            pg = io.object_pg("obj")
            _acting, primary = cluster.mon.osdmap.pg_to_acting_osds(pg)
            osd = cluster.osds[primary]
            state = osd.pgs[pg]
            pool = osd.osdmap.pools[pg.pool]
            # a clean PG: recovery has nothing to do
            assert state.peer_missing == {} or \
                not any(state.peer_missing.values())
            await osd._recover_pg(state, pool, {})
            # a peer missing the object: recovery pushes it back
            peers = osd._acting_peer_shards(state, pool)
            key = next(iter(peers))
            _rc, _d, attrs = osd._read_shard(
                pg, state.my_shard(osd.osd_id, pool.type), "obj", 0, 1)
            version = osd._oi_version(attrs)
            state.peer_missing = {key: {"obj": version}}
            installs = cluster.osds[peers[key]].perf["recovery_installs"]
            await osd._recover_pg(state, pool, peers)
            assert not any(state.peer_missing.values())
            assert osd.perf["recovery_bytes_repaired"] > 0
            assert cluster.osds[peers[key]].perf["recovery_installs"] \
                == installs
            # the post-write repair is scheduled once and finishes
            osd._schedule_object_repair(state, pool, "obj")
            osd._schedule_object_repair(state, pool, "obj")
            assert osd._pending_repairs == {(pg, "obj")}
            await cluster._wait(lambda: not osd._pending_repairs, 10.0,
                                "the post-write repair never finished")
            assert await io.read("obj") == b"q" * 10_000
            # a pg_num increase splits PGs
            rc, out = await cluster.client.mon_command(
                {"prefix": "osd pool set", "name": "ec", "var": "pg_num",
                 "val": 16})
            assert rc == 0, out
            await cluster.client.wait_for_new_map()
            await cluster.wait_for_clean(timeout=60.0)
            for o in cluster.osds.values():
                assert o._pool_pg_nums[pg.pool] == 16
                meta = json.loads(o.store.omap_get(
                    "osd_meta", tdaemon.ObjectId("split_state"))["v"])
                assert meta["pg_nums"][str(pg.pool)] == 16
            assert await io.read("obj") == b"q" * 10_000
        finally:
            await cluster.stop()
    run(main())


def test_osd_without_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdaemon.OSDDaemon(0, "127.0.0.1:1")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdaemon.OSDDaemon(0, "127.0.0.1:1", device="cuda")
    assert tdaemon.OSDDaemon(0, "127.0.0.1:1", device="cpu").device.type \
        == "cpu"


def _spawn_osd(osd_id: int, mon_addr: str, *extra, env=None):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               **(env or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.osd", "--id", str(osd_id),
         "--mon", mon_addr, *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def test_osd_process_without_cuda_and_no_device_exits_nonzero():
    # no card visible to the process, wherever the test runs
    proc = _spawn_osd(0, "127.0.0.1:1", env={"CUDA_VISIBLE_DEVICES": ""})
    out, err = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert "CUDA" in err and "OSD_ADDR" not in out


def test_osd_processes_serve_a_port_client():
    async def main():
        # the harness's timings (tests/torch_cluster_helpers.py)
        mon = pkg("torch", "mon").MonDaemon(
            4, osds_per_host=1, config=dict(FAST_MON_CONFIG))
        addr = await mon.start()
        procs = [_spawn_osd(i, addr, "--device", "cpu",
                            "--config", json.dumps(FAST_CONFIG))
                 for i in range(4)]
        client = None
        try:
            async def booted(proc):
                line = await asyncio.to_thread(proc.stdout.readline)
                assert line.startswith("OSD_ADDR "), \
                    (line, proc.stderr.read() if proc.poll() else "")
            await asyncio.gather(*(booted(p) for p in procs))
            client = pkg("torch", "rados.client").RadosClient([addr])
            await client.connect()
            await client.create_ec_pool("ec", profile("ec_torch", 2, 2),
                                        pg_num=8)
            io = client.open_ioctx("ec")
            payloads = {f"p{i}": rand(70 + i, 64_000 + i) for i in range(6)}
            for name, data in payloads.items():
                await io.write_full(name, data)
            for name, data in payloads.items():
                assert await io.read(name) == data
            assert await io.list_objects() == sorted(payloads)
        finally:
            if client is not None:
                await client.shutdown()
            for p in procs:
                p.kill()
            for p in procs:
                await asyncio.to_thread(p.wait)
                p.stdout.close()
                p.stderr.close()
            await mon.shutdown()
    run(main(), 120)
