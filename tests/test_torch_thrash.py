"""The thrasher tier on the port (ceph_tpu_torch OSDs, on the CPU).

tests/test_thrash.py's hedged-read leg runs its body on port daemons
(`on_port`, JaxShapedCluster).  Then one short seeded kill-and-revive run
of that file's `_run_thrash` on a persistent cluster: six port OSDs on
FaultStores, EC 2+2, at least eight thrash actions over a 25 s window of
writes and removes; each kill power-cuts the OSD's store
(CEPH_TPU_CRASH_INJECT is armed by default) and each revive remounts its
directory.  The window gives the runner's 20-acked-write gate room: the
acked rate on FaultStores was 1.7-8.9 writes/s with the file alone and
2.7-3.3 under six test workers, so a 3 s window fell short.  The file's two
invariants hold: every object reads back as its last acked state or a
later unacked attempt, and every stored shard equals the re-encode of that
state.  (The slow full-length profiles of test_thrash.py are left to the
JAX package, and its device-injection toggle tests a host fallback the
port does not have.)  Last, ROADMAP C10 pinned in both packages: an
acked overwrite left unfound by a fenced partial write.
"""

import asyncio
import functools

import pytest

from ceph_tpu_torch.ec.registry import create_erasure_code
from ceph_tpu_torch.os import faultstore

from torch_cluster_helpers import (Cluster, JaxShapedCluster, port_profile,
                                   tpustore_factory)
from torch_cluster_helpers import one_torch_thread  # noqa: F401
from test_torch_osd_units import on_port

import test_thrash as j_thrash


def test_thrash_hedged_reads_under_delay_injection():
    on_port(j_thrash, "test_thrash_hedged_reads_under_delay_injection",
            Cluster=JaxShapedCluster)()


def _cpu_codec(profile: dict):
    return create_erasure_code({**port_profile(profile), "device": "cpu"})


def test_thrash_kill_revive_on_persistent_faultstores(tmp_path):
    assert faultstore.crash_inject_enabled()
    cluster = functools.partial(
        JaxShapedCluster,
        store_factory=tpustore_factory(tmp_path, fault=True),
        persistent=True)
    run_thrash = on_port(j_thrash, "_run_thrash", Cluster=cluster,
                         create_erasure_code=_cpu_codec)
    asyncio.run(asyncio.wait_for(run_thrash(
        seed=1234, num_osds=6, osds_per_host=1,
        pool={"kind": "ec", "pg_num": 8, "profile": {
            "plugin": "ec_jax", "technique": "reed_sol_van",
            "k": "2", "m": "2", "crush-failure-domain": "osd"}},
        min_alive=4, duration_s=25.0, min_actions=8, n_objects=12,
        clean_timeout=120.0), 300))


@pytest.mark.parametrize("kind", ["torch", "jax"])
def test_fenced_partial_write_leaves_an_acked_overwrite_unfound(kind):
    """ROADMAP C10, in both packages: an EC write_full whose sub-writes
    reach too few shards before an interval change fences the rest (an
    `osd down` racing the write) leaves mixed versions; the client's
    resend in the new interval is acked on every live shard, yet the
    object stays unfound, its reads answering EAGAIN, until the down OSD
    returns (the primary keeps the fenced shards in its peer-missing sets
    and waits for the down one's probe)."""
    from test_torch_osd import ec_profile

    async def main():
        cluster = Cluster(num_osds=6, osds_per_host=1, kinds=[kind] * 6,
                          mon_kind=kind, client_kind=kind)
        await cluster.start()
        client = None
        try:
            await cluster.client.create_ec_pool("p", ec_profile(kind, 2, 2),
                                                pg_num=1)
            await cluster.wait_for_clean()
            io = cluster.client.open_ioctx("p")
            await io.write_full("obj", b"A" * 20_000)
            acting, primary = cluster.mon.osdmap.pg_to_acting_osds(
                io.object_pg("obj"))
            victim, *fenced = [o for o in acting if o != primary]
            epoch = cluster.mon.osdmap.epoch
            for f in fenced:
                osd = cluster.osds[f]

                async def late(conn, msg, osd=osd,
                               inner=osd._handle_sub_write):
                    # this shard's sub-writes land after the new map
                    while osd.osdmap.epoch <= epoch:
                        await asyncio.sleep(0.02)
                    await asyncio.sleep(0.3)
                    return await inner(conn, msg)
                osd._handle_sub_write = late
            await cluster.kill_osd(victim)
            write = asyncio.ensure_future(io.write_full("obj",
                                                        b"B" * 20_000))
            await asyncio.sleep(0.2)
            await cluster.mark_down(victim)
            assert "data_crc" in await write          # acked
            for f in fenced:
                del cluster.osds[f]._handle_sub_write
            client = cluster.new_client(kind, max_retries=3)
            await client.connect()
            with pytest.raises(Exception) as err:
                await client.open_ioctx("p").read("obj")
            assert getattr(err.value, "rc", None) == -11
            await cluster.revive_osd(victim)
            await cluster.wait_for_osd_up(victim)
            assert await io.read("obj") == b"B" * 20_000
        finally:
            if client is not None:
                await client.shutdown()
            await cluster.stop()

    asyncio.run(asyncio.wait_for(main(), 120))
