"""The port's recovery and backfill (ceph_tpu_torch.osd.daemon) against the
JAX package's, on the CPU.

Each workload runs on a JAX cluster (`ec_jax` pools on its host path) and on
a port cluster (`ec_torch` on `device="cpu"`), on the same seeded data, as
in tests/test_torch_osd.py: the replies, the perf counts the reference's
tests assert, and every MemStore's objects, xattrs and pg-meta omaps must be
equal.  The workloads mirror tests/test_cluster.py (an OSD revived after
writes it missed, replicated and EC; an unfound object whose reads block
until a source returns; `osd lost` completing the stray probe; a recovery
wave batched into few decode and encode dispatches; an injected heartbeat
outage), tests/test_msr.py (MSR repair from beta-fragments, and its kill
switch), a post-write repair after a slow peer's sub-write timed out, and
clusters mixing JAX and port OSDs, where primaries of one package recover
the other's OSDs.  Killed OSDs are marked down through the mon (the
harness's heartbeat grace is 60 s).  The EC workloads run a second time
with CEPH_TPU_FUSE_MIN_BYTES=0 (the encode service's batched body).
"""

import asyncio

import numpy as np

from torch_cluster_helpers import Cluster
from torch_cluster_helpers import one_torch_thread  # noqa: F401
from test_torch_osd import (both, ec_profile, fuse,  # noqa: F401
                            rand, run, snapshot)


async def _down(cluster, osd_id: int, out: bool = True) -> None:
    """Kill an OSD, mark it down (and out) through the mon."""
    await cluster.kill_osd(osd_id)
    await cluster.mark_down(osd_id)
    await cluster.wait_for_osd_down(osd_id)
    if out:
        await cluster.mark_out(osd_id)


async def _back(cluster, osd_id: int, mark_in: bool = True) -> None:
    """Revive an OSD on its surviving store (and mark it in)."""
    await cluster.revive_osd(osd_id)
    await cluster.wait_for_osd_up(osd_id)
    if mark_in:
        await cluster.mark_in(osd_id)


def _perf(cluster, key: str) -> int:
    return sum(o.perf[key] for o in cluster.osds.values())


# -- tests/test_cluster.py -------------------------------------------------

def test_osd_revive_rejoins_and_recovers():
    async def work(cluster, kind):
        await cluster.client.create_replicated_pool("rbd", size=3,
                                                    pg_num=8)
        io = cluster.client.open_ioctx("rbd")
        await io.write_full("before", b"before-kill " * 1000)
        await _down(cluster, 1)
        payloads = {f"during-{i}": bytes([i]) * 10_000 for i in range(6)}
        replies = [await io.write_full(n, d) for n, d in payloads.items()]
        await _back(cluster, 1)
        await cluster.wait_for_clean()
        replies.append(await io.read("before"))
        assert replies[-1] == b"before-kill " * 1000
        for name, data in payloads.items():
            assert await io.read(name) == data
        store = cluster.stores[1]
        recovered = {str(o) for cid in store.list_collections()
                     for o in store.list_objects(cid)}
        assert any(name in recovered for name in payloads)
        replies.append(sorted(n for n in payloads if n in recovered))
        replies.append(cluster.osds[1].perf["recovery_installs"])
        return replies
    both(work)


def test_ec_revive_recovers_shards(fuse):
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "ecpool", ec_profile(kind, 2, 1), pg_num=8)
        io = cluster.client.open_ioctx("ecpool")
        await _down(cluster, 3)
        payloads = {f"x{i}": rand(i, 30_000) for i in range(5)}
        replies = [await io.write_full(n, d) for n, d in payloads.items()]
        await _back(cluster, 3)
        await cluster.wait_for_clean()
        for name, data in payloads.items():
            assert await io.read(name) == data
        # the recovered shards on osd.3 must carry a reconstruction
        await _down(cluster, 0, out=False)
        for name, data in payloads.items():
            got = await io.read(name)
            assert got == data
            replies.append(got)
        # (the survivor sets a wave decodes from follow the peers'
        # latency ranks, so the decode dispatches are left out)
        replies.append([_perf(cluster, k) for k in (
            "recovery_bytes_read", "recovery_bytes_repaired",
            "encode_dispatches")])
        return replies
    both(work)


def test_unfound_object_blocks_reads_until_source_returns(fuse):
    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "ecpool", ec_profile(kind, 2, 1), pg_num=8)
        io = cluster.client.open_ioctx("ecpool")
        payload = bytes(range(256)) * 64
        replies = [await io.write_full("victim", payload)]
        acting, _p = cluster.mon.osdmap.pg_to_acting_osds(
            io.object_pg("victim"))
        dead = [o for o in acting if o >= 0][1:3]
        for osd in dead:
            await _down(cluster, osd, out=False)
        for osd in dead:
            await cluster.mark_out(osd)
        # below k: the read blocks (EAGAIN resends), it does not ENOENT
        read = asyncio.get_running_loop().create_task(io.read("victim"))
        done, _pending = await asyncio.wait([read], timeout=3.0)
        assert not done, read.result()
        await _back(cluster, dead[0])
        replies.append(await asyncio.wait_for(read, 60.0))
        assert replies[-1] == payload
        await cluster.wait_for_clean(60)
        replies.append(dead)
        return replies
    both(work)


def test_osd_lost_completes_probe_adjudication():
    async def work(cluster, kind):
        await cluster.client.create_replicated_pool("p", size=2, pg_num=8)
        io = cluster.client.open_ioctx("p")
        replies = [await io.write_full("o", b"z" * 1000)]
        pg = io.object_pg("o")
        acting, primary = cluster.mon.osdmap.pg_to_acting_osds(pg)
        victim = next(o for o in range(4) if o not in acting)
        await _down(cluster, victim, out=False)
        posd = cluster.osds[primary]
        state = posd.pgs[pg]
        pool = posd.osdmap.pools[pg.pool]
        # a plain-down OSD leaves the stray search inconclusive
        _c, complete = await posd._gather_stray_shards(state, pool, "o",
                                                       set())
        assert not complete
        replies.append(complete)
        rc, _out = await cluster.client.mon_command(
            {"prefix": "osd lost", "osd": victim})
        assert rc != 0
        replies.append(rc)
        await cluster.mark_lost(victim)
        await cluster._wait(
            lambda: posd.osdmap is not None
            and posd.osdmap.is_destroyed(victim),
            10.0, "lost state never reached the OSDs")
        _c, complete = await posd._gather_stray_shards(state, pool, "o",
                                                       set())
        assert complete
        replies.append(complete)
        rc, _out = await cluster.client.mon_command(
            {"prefix": "osd lost", "osd": acting[0],
             "yes_i_really_mean_it": True})
        assert rc != 0
        replies.append(rc)
        replies.append(await io.read("o"))
        assert replies[-1] == b"z" * 1000
        return replies
    both(work)


def test_recovery_batches_device_dispatches(fuse):
    n_objects = 24

    async def work(cluster, kind):
        await cluster.client.create_ec_pool(
            "ecb", ec_profile(kind, 2, 1), pg_num=8)
        io = cluster.client.open_ioctx("ecb")
        replies = [await io.write_full(f"b{i}", bytes([i]) * 6000)
                   for i in range(n_objects)]
        base = {k: _perf(cluster, k)
                for k in ("decode_dispatches", "encode_dispatches")}
        await _down(cluster, 3)
        await cluster.wait_for_clean(60)
        dec = _perf(cluster, "decode_dispatches") - \
            base["decode_dispatches"]
        enc = _perf(cluster, "encode_dispatches") - \
            base["encode_dispatches"]
        # one decode per survivor set and one re-encode per wave, not
        # one per object
        assert 0 < dec < n_objects, dec
        assert 0 < enc < n_objects, enc
        for i in range(n_objects):
            assert await io.read(f"b{i}") == bytes([i]) * 6000
        return replies + [enc]
    both(work)


#: tests/cluster_helpers.py's heartbeat grace: the peers report a muted
#: OSD within seconds
REPORT_GRACE = {"osd_heartbeat_grace": 2.5}


def test_heartbeat_inject_failure_marks_down_then_recovers():
    """The JAX test with its short grace: osd.2, muted through central
    config, is reported and marked down while alive, and boots itself
    back when the outage ends.  Both packages end on the same up set."""
    def once(kind: str):
        async def main():
            cluster = Cluster(num_osds=4, kinds=[kind] * 4, mon_kind=kind,
                              client_kind=kind, osd_config=REPORT_GRACE,
                              mon_config=REPORT_GRACE)
            await cluster.start()
            try:
                assert cluster.mon.osdmap.is_up(2)
                rc, _ = await cluster.client.mon_command(
                    {"prefix": "config set", "who": "osd.2",
                     "name": "heartbeat_inject_failure", "value": "8"})
                assert rc == 0
                await cluster.wait_for_osd_down(2)
                assert not cluster.osds[2]._stopping
                rc2, _ = await cluster.client.mon_command(
                    {"prefix": "config rm", "who": "osd.2",
                     "name": "heartbeat_inject_failure"})
                assert rc2 == 0
                await cluster.wait_for_osd_up(2, timeout=30.0)
                await cluster.wait_for_clean(30)
                return (rc, rc2, cluster.mon.osdmap.get_up_osds())
            finally:
                await cluster.stop()
        return run(main(), 90)

    jax, port = once("jax"), once("torch")
    assert port == jax == (0, 0, [0, 1, 2, 3])


# -- tests/test_msr.py -----------------------------------------------------

def msr_profile(kind: str) -> dict:
    out = {"plugin": "ec_msr", "k": "2", "m": "2", "d": "3",
           "crush-failure-domain": "osd"}
    if kind == "jax":
        out["tpu"] = "false"
    return out


async def _thrash_msr_pool(cluster, kind):
    """tests/test_msr.py's scenario: write an MSR pool, lose one OSD,
    mark it out, wait for clean, read every object back."""
    await cluster.client.create_ec_pool("msrpool", msr_profile(kind),
                                        pg_num=4)
    io = cluster.client.open_ioctx("msrpool")
    payloads = {f"o{i}": rand(300 + i, 30_000 + 17 * i) for i in range(6)}
    replies = [await io.write_full(n, d) for n, d in payloads.items()]
    await _down(cluster, 0)
    await cluster.wait_for_clean(60)
    for name, data in payloads.items():
        got = await io.read(name)
        assert got == data
        replies.append(got)
    return replies


def test_cluster_repair_aware_recovery():
    async def work(cluster, kind):
        replies = await _thrash_msr_pool(cluster, kind)
        repaired = _perf(cluster, "repair_objects")
        fallbacks = _perf(cluster, "repair_fallbacks")
        assert repaired > 0, "no object took the repair path"
        assert _perf(cluster, "repair_fragments") >= 3 * repaired
        for osd in cluster.osds.values():
            if osd.perf["repair_objects"] and not fallbacks:
                read = osd.perf["recovery_bytes_read"]
                made = osd.perf["recovery_bytes_repaired"]
                assert read <= 1.6 * made, (read, made)
        # (a hedged fragment fetch may recruit one more helper, or fall
        # back, under load: the counts are asserted, not compared)
        return replies
    both(work, num_osds=5)


def test_cluster_repair_kill_switch(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_MSR_REPAIR", "0")

    async def work(cluster, kind):
        replies = await _thrash_msr_pool(cluster, kind)
        assert _perf(cluster, "repair_objects") == 0
        assert _perf(cluster, "repair_fragments") == 0
        return replies
    both(work, num_osds=5)


# -- the post-write repair ---------------------------------------------------

#: a sub-op timeout short enough for the test, and a delay past it and
#: past the repair's one-second settle
SLOW_CONFIG = {"osd_sub_op_timeout": 2.0}
SLOW_DELAY = 5.0


def _delay_first_sub_write(osd, oid: str, delay: float) -> list:
    """Hold this OSD's first client sub-write of `oid` for `delay`
    seconds before handling it (a slow but live peer); returns the list
    the hold appends to once it has passed."""
    handle = osd._handle_sub_write
    held: list = []

    async def slow(conn, msg):
        if msg.oid == oid and msg.log_entry is not None and not held:
            held.append(msg.tid)
            await asyncio.sleep(delay)
        return await handle(conn, msg)
    osd._handle_sub_write = slow
    return held


def test_post_write_repair_heals_a_timed_out_shard(fuse):
    """One peer's sub-write of an overwrite outlasts osd_sub_op_timeout
    with no interval change: the write succeeds on the other shards, the
    primary's post-write repair (a scrub of the object) reinstalls the
    new version on the slow shard, and every shard ends at it."""
    def once(kind: str):
        async def main():
            cluster = Cluster(num_osds=4, kinds=[kind] * 4, mon_kind=kind,
                              client_kind=kind, osd_config=SLOW_CONFIG)
            await cluster.start()
            try:
                await cluster.client.create_ec_pool(
                    "ec", ec_profile(kind, 2, 1), pg_num=8)
                io = cluster.client.open_ioctx("ec")
                old, new = rand(1, 40_000), rand(2, 40_000)
                replies = [await io.write_full("obj", old)]
                acting, primary = cluster.mon.osdmap.pg_to_acting_osds(
                    io.object_pg("obj"))
                slow = [o for o in acting if o != primary][0]
                held = _delay_first_sub_write(cluster.osds[slow], "obj",
                                              SLOW_DELAY)
                epoch = cluster.mon.osdmap.epoch
                replies.append(await io.write_full("obj", new))
                assert held, "the slow peer never saw the write"
                # the repair settles for a second, then scrubs the object
                prim = cluster.osds[primary]
                await cluster._wait(
                    lambda: not prim._pending_repairs, 10.0,
                    "the post-write repair never finished")
                await asyncio.sleep(SLOW_DELAY)  # the late sub-write lands
                assert cluster.mon.osdmap.epoch == epoch
                replies.append(await io.read("obj"))
                assert replies[-1] == new
                pg = io.object_pg("obj")
                versions = set()
                for idx, osd in enumerate(acting):
                    rc, _d, attrs = cluster.osds[osd]._read_shard(
                        pg, idx, "obj", 0, 1)
                    assert rc == 0
                    versions.add(prim._oi_version(attrs))
                assert len(versions) == 1, versions
                replies.append(sorted(versions))
                return replies, snapshot(cluster)
            finally:
                await cluster.stop()
        return run(main(), 90)

    jax, port = once("jax"), once("torch")
    assert port == jax


# -- mixed clusters ----------------------------------------------------------

#: a profile both registries know: `jerasure` builds ec_jax (on its host
#: path) in the JAX package and ec_torch in the port
MIXED_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "2", "m": "2", "crush-failure-domain": "osd",
                 "tpu": "false"}
MIXED_KINDS = ("torch", "jax", "torch", "jax", "torch", "jax")


def test_mixed_primaries_recover_the_other_packages_osds(fuse):
    """Kill a port OSD, write, revive it: the PGs it holds, JAX primaries
    among them, recover it; then the same for a JAX OSD, port primaries
    among its recoverers.  The stores end equal to an all-JAX run's."""
    def once(kinds):
        async def main():
            cluster = Cluster(num_osds=6, osds_per_host=2, kinds=kinds)
            await cluster.start()
            try:
                await cluster.client.create_ec_pool("ec", MIXED_PROFILE,
                                                    pg_num=8)
                io = cluster.client.open_ioctx("ec")
                base = {f"b{i}": rand(40 + i, 20_000) for i in range(6)}
                for name, data in base.items():
                    await io.write_full(name, data)
                pushers = []
                for victim, step in ((0, 1), (1, 2)):
                    await _down(cluster, victim)
                    for i in range(6):
                        await io.write_full(f"s{step}.{i}",
                                            rand(60 + 10 * step + i,
                                                 15_000))
                    before = {o: d.perf["recovery_bytes_repaired"]
                              for o, d in cluster.osds.items()}
                    await _back(cluster, victim)
                    await cluster.wait_for_clean(60)
                    pushers.append(sorted(
                        o for o, d in cluster.osds.items()
                        if d.perf["recovery_bytes_repaired"]
                        > before.get(o, 0)))
                for name, data in base.items():
                    assert await io.read(name) == data
                for step in (1, 2):
                    for i in range(6):
                        assert await io.read(f"s{step}.{i}") == \
                            rand(60 + 10 * step + i, 15_000)
                await asyncio.sleep(0.2)
                return pushers, snapshot(cluster)
            finally:
                await cluster.stop()
        return run(main(), 150)

    mixed_pushers, mixed = once(list(MIXED_KINDS))
    # the port OSD (0) was recovered by a JAX primary among others, the
    # JAX OSD (1) by a port primary among others
    assert any(MIXED_KINDS[o] == "jax" for o in mixed_pushers[0]), \
        mixed_pushers
    assert any(MIXED_KINDS[o] == "torch" for o in mixed_pushers[1]), \
        mixed_pushers
    jax_pushers, alone = once(["jax"] * len(MIXED_KINDS))
    assert mixed_pushers == jax_pushers
    assert mixed == alone


def test_kill_write_revive_converges_every_shard_to_the_reference(fuse):
    """Every shard object of a revived port OSD equals the JAX cluster's
    after the same history, bytes, xattrs and pg-meta, in a replicated
    and an EC pool at once."""
    async def work(cluster, kind):
        await cluster.client.create_replicated_pool("rep", size=3,
                                                    pg_num=8)
        await cluster.client.create_ec_pool(
            "ec", ec_profile(kind, 2, 1), pg_num=8)
        rio = cluster.client.open_ioctx("rep")
        eio = cluster.client.open_ioctx("ec")
        rng = np.random.default_rng(5)
        sizes = [int(s) for s in rng.integers(1, 60_000, 8)]
        for i, n in enumerate(sizes):
            await rio.write_full(f"r{i}", rand(200 + i, n))
            await eio.write_full(f"e{i}", rand(300 + i, n))
        # out as well: a PG left with 2 of 3 shards is under min_size
        await _down(cluster, 2)
        replies = []
        for i, n in enumerate(sizes[:4]):
            replies.append(await rio.write_full(f"r{i}", rand(400 + i, n)))
            replies.append(await eio.write_full(f"e{i}",
                                                rand(500 + i, n)))
        await rio.remove("r5")
        await eio.remove("e5")
        await _back(cluster, 2)
        await cluster.wait_for_clean(60)
        for i, n in enumerate(sizes):
            if i == 5:
                continue
            new = i < 4
            assert await rio.read(f"r{i}") == \
                rand((400 if new else 200) + i, n)
            assert await eio.read(f"e{i}") == \
                rand((500 if new else 300) + i, n)
        replies.append(sorted(await rio.list_objects()))
        replies.append(sorted(await eio.list_objects()))
        return replies
    both(work)
