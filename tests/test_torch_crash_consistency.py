"""The port's crash-consistency tier (ceph_tpu_torch.os.faultstore and the
persistent mode of tests/torch_cluster_helpers.py) against the JAX
package's, on the CPU.

Every non-slow test of tests/test_crash_consistency.py but the Prometheus
scrape (which needs `mgr/`, not ported) runs its body with the `ceph_tpu`
names bound to the port's (`on_port`): the stores and the sweep on
`device="cpu"`, the clusters on port daemons (JaxShapedCluster, which marks
a killed OSD down through the mon).  Then the port's own: the sweep's
recorded trace and the digest of every cut's post-crash image equal the JAX
package's for the default workload at two seeds, and a persistent cluster
history (a power cut, a plain crash, revives on the same directories) ends
in equal stores in both packages.
"""

import asyncio
import functools

import numpy as np
import pytest

from ceph_tpu.os import faultstore as jfault
from ceph_tpu_torch.os import faultstore as tfault
from ceph_tpu_torch.os.tpustore import TPUStore

from torch_cluster_helpers import Cluster, JaxShapedCluster, tpustore_factory
from torch_cluster_helpers import one_torch_thread  # noqa: F401
from test_torch_osd import ec_profile, rand, snapshot
from test_torch_osd_units import call, on_port

import test_crash_consistency as j_crash

CPU_OVERRIDES = {
    "FaultStore": functools.partial(tfault.FaultStore, device="cpu"),
    "TPUStore": functools.partial(TPUStore, device="cpu"),
    "CrashSweep": functools.partial(tfault.CrashSweep, device="cpu"),
    "Cluster": JaxShapedCluster,
    "tpustore_factory": tpustore_factory,
}


def port_body(name: str):
    return on_port(j_crash, name, **CPU_OVERRIDES)


@pytest.mark.parametrize("name", [
    "test_crash_sweep_mixed_workload_zero_violations",
    "test_crash_sweep_is_seed_sensitive_but_stable",
    "test_sweep_catches_store_without_block_fsync",
    "test_sweep_catches_store_without_sync_commit",
    "test_powercut_preserves_acked_writes",
    "test_double_crash_inside_replay_is_idempotent",
    "test_bitrot_detected_not_silently_served",
    "test_snapshot_store_matches_itself_across_remount",
])
def test_store(name, tmp_path):
    call(port_body(name), tmp_path=tmp_path)


def test_durable_kv_prefix_semantics():
    port_body("test_durable_kv_prefix_semantics")()


@pytest.mark.parametrize("name", [
    "test_persistent_cluster_kill_remount_acked_data",
    "test_persistent_revive_recovers_via_pg_log",
    "test_bitrot_repaired_from_peers_by_scrub",
    "test_revive_with_fresh_store_trips_fsid_assert",
])
def test_persistent_cluster(name, tmp_path):
    call(port_body(name), tmp_path=tmp_path)


def test_crash_inject_kill_switch(tmp_path, monkeypatch):
    call(port_body("test_crash_inject_kill_switch"), tmp_path=tmp_path,
         monkeypatch=monkeypatch)


# -- the port's own: traces and images equal the JAX package's -------------

def _cut_digests(events, base_block) -> list:
    """The digest of the minimal post-crash image at every cut."""
    return [jfault.image_digest(*jfault.build_image(
        events, cut, drop_pending=True, kv_keep="min",
        base_block=base_block)) for cut in range(1, len(events) + 1)]


@pytest.mark.parametrize("seed", [0, 7])
def test_sweep_trace_and_images_equal_the_jax_packages(seed, tmp_path):
    jsweep = jfault.CrashSweep(str(tmp_path / "jax"))
    tsweep = tfault.CrashSweep(str(tmp_path / "torch"), device="cpu")
    jrep = jsweep.run(jfault.default_workload, seed=seed)
    trep = tsweep.run(tfault.default_workload, seed=seed)
    assert trep["violations"] == [] == jrep["violations"]
    assert trep == jrep
    assert tsweep.events == jsweep.events
    assert tsweep.base_block == jsweep.base_block
    # the synthesis of the port is the JAX package's, image for image
    tdigests = [tfault.image_digest(*tfault.build_image(
        tsweep.events, cut, drop_pending=True, kv_keep="min",
        base_block=tsweep.base_block))
        for cut in range(1, len(tsweep.events) + 1)]
    assert tdigests == _cut_digests(jsweep.events, jsweep.base_block)
    assert len(set(tdigests)) > 1


def test_group_commit_sweep_trace_equals_the_jax_packages(tmp_path):
    """The same, recorded through submit_batch (group commit armed)."""
    jsweep = jfault.CrashSweep(str(tmp_path / "jax"))
    tsweep = tfault.CrashSweep(str(tmp_path / "torch"), device="cpu")
    jrep = jsweep.run(txns=10, seed=3, batch=4, max_points=40)
    trep = tsweep.run(txns=10, seed=3, batch=4, max_points=40)
    assert trep == jrep and not trep["violations"]
    assert tsweep.events == jsweep.events


# -- a persistent cluster history in both packages -------------------------

def test_persistent_history_ends_in_equal_stores(tmp_path, monkeypatch):
    """FaultStore-backed OSDs of each package (EC 2+1, 4 OSDs): writes, a
    power cut of one OSD while armed, writes while it is down and out, its
    revive on the same directory; then a plain crash (the flag off) of
    another, writes, its revive.  Every fsid survives, every read is
    exact, and the replies and stores (fsid aside) equal the JAX run's."""
    results = {}
    for kind in ("jax", "torch"):
        monkeypatch.delenv("CEPH_TPU_CRASH_INJECT", raising=False)

        def factory(osd_id, k, kind=kind):
            return tpustore_factory(tmp_path / kind, fault=True)(osd_id, k)

        async def main(kind=kind, factory=factory):
            cluster = Cluster(num_osds=4, osds_per_host=1,
                              kinds=[kind] * 4, mon_kind=kind,
                              client_kind=kind, store_factory=factory,
                              persistent=True)
            await cluster.start()
            try:
                await cluster.client.create_ec_pool(
                    "p", ec_profile(kind, 2, 1), pg_num=4)
                io = cluster.client.open_ioctx("p")
                payloads = {f"a{i}": rand(30 + i, 20_000 + 999 * i)
                            for i in range(6)}
                replies = [await io.write_full(n, d)
                           for n, d in payloads.items()]
                for victim, armed in ((1, True), (2, False)):
                    if not armed:
                        monkeypatch.setenv("CEPH_TPU_CRASH_INJECT", "0")
                    await cluster.kill_osd(victim)
                    await cluster.mark_down(victim)
                    await cluster.wait_for_osd_down(victim)
                    await cluster.mark_out(victim)
                    more = {f"b{victim}.{i}": rand(50 + 10 * victim + i,
                                                   9_000 + 777 * i)
                            for i in range(4)}
                    replies += [await io.write_full(n, d)
                                for n, d in more.items()]
                    payloads.update(more)
                    await cluster.revive_osd(victim)
                    await cluster.wait_for_osd_up(victim)
                    await cluster.mark_in(victim)
                    await cluster.wait_for_clean(timeout=60)
                for name, data in payloads.items():
                    got = await io.read(name)
                    assert got == data, name
                    replies.append(got)
                assert all(cluster.stores[i].fsid == cluster.fsids[i]
                           for i in range(4))
                replies.append(sorted(
                    (i, cluster.stores[i].perf["journal_replays"] > 0)
                    for i in (1, 2)))
                await asyncio.sleep(0.2)   # trims and late commits land
                return replies, snapshot(cluster)
            finally:
                await cluster.stop()

        results[kind] = asyncio.run(asyncio.wait_for(main(), 180))
    (jrep, jsnap), (trep, tsnap) = results["jax"], results["torch"]
    assert trep == jrep
    assert tsnap.keys() == jsnap.keys()
    for osd_id in jsnap:
        assert tsnap[osd_id] == jsnap[osd_id], osd_id
    assert np.sum([len(c) for c in tsnap[0].values()]) > 0
