"""The port's monitors (ceph_tpu_torch.mon, .mon.paxos), mirroring
tests/test_election_connectivity.py and the mon-only parts of
tests/test_quorum.py, with 3-mon quorums driven by a bare Messenger client
(tests/torch_mon_helpers.py).

The election units (connection tracker, vote, preempt and dethrone rules)
run on both packages' modules with the same inputs and must agree.  The
quorum tests are the JAX file's: lowest rank wins, mutations replicate to
every mon with byte-identical maps, a peon forwards commands, the leader's
loss fails over and the survivors keep committing, a peon's loss leaves the
quorum, a rejoining mon catches up, and a lossy rank 0 stops leading under
the CONNECTIVITY strategy.  The JAX test's leader kill under a client write
load needs the OSD daemons (the next slice).  Then the port's own process
entry point: three `python -m ceph_tpu_torch.mon` processes on SQLite
stores elect, commit, survive a kill -9 of the leader, and the killed rank
restarts from its store and catches up.  Last, ROADMAP C5, a fault of the
reference that the port copies: a `health` walk longer than the lease's
slack costs the quorum an election, in both packages.  Every async test
runs under its own timeout.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys

import pytest

from ceph_tpu.mon import paxos as jpaxos
from ceph_tpu.msg import messages as jmessages
from ceph_tpu_torch.common import auth
from ceph_tpu_torch.mon import paxos as tpaxos
from ceph_tpu_torch.msg import messages as tmessages

from torch_mon_helpers import FAST_QUORUM, MonClient, MonQuorum

BOTH = pytest.mark.parametrize("pm, mm", [(tpaxos, tmessages),
                                          (jpaxos, jmessages)],
                               ids=["torch", "jax"])

CONN_QUORUM = {
    **FAST_QUORUM,
    "mon_election_default_strategy": tpaxos.STRATEGY_CONNECTIVITY,
    "mon_elector_ping_interval": 0.15,
    "mon_elector_score_halflife": 1.0,
}


def run(coro, timeout: float = 60):
    asyncio.run(asyncio.wait_for(coro, timeout))


# -- unit: tracker + vote rule ----------------------------------------------

@BOTH
def test_tracker_decay_and_scores(pm, mm):
    t = pm.ConnectionTracker(half_life=1.0)
    assert t.score(1) == 1.0          # unseen peers start healthy
    # decay is TIME-based (dt=0 first touch is a no-op): one half-life
    # of sustained failure halves the score
    t.report(1, False, now=0.0)
    t.report(1, False, now=1.0)
    t.report(1, False, now=2.0)
    assert abs(t.score(1) - 0.25) < 1e-9
    # recovery climbs back at the same half-life
    t.report(1, True, now=3.0)
    t.report(1, True, now=4.0)
    assert t.score(1) > 0.5
    # aggregate: mean over the OTHER ranks
    t.report(2, False, now=4.0)
    lo, hi = sorted([t.score(1), t.score(2)])
    assert abs(t.my_score(3, 0) - (lo + hi) / 2) < 1e-9


def _elector(pm, rank, n, strategy, config=None):
    async def _noop(*a):
        pass
    cfg = {"mon_election_default_strategy": strategy}
    cfg.update(config or {})
    return pm.Elector(rank, n, _noop, _noop, _noop, cfg)


@BOTH
def test_defer_rule_classic_is_rank_only(pm, mm):
    e = _elector(pm, 1, 3, pm.STRATEGY_CLASSIC)
    e.tracker.report(0, False, now=0.0)   # even a dead-looking mon.0
    assert e._should_defer(mm.MMonElection(1, 1, 0, score=0.0))
    assert not e._should_defer(mm.MMonElection(1, 1, 2, score=1.0))


@BOTH
def test_defer_rule_connectivity(pm, mm):
    e = _elector(pm, 1, 3, pm.STRATEGY_CONNECTIVITY)
    # all healthy: near-tie falls back to rank priority
    assert e._should_defer(mm.MMonElection(1, 1, 0, score=1.0))
    assert not e._should_defer(mm.MMonElection(1, 1, 2, score=1.0))
    # mon.0 looks lossy from here AND self-reports weak: refuse it
    for now in (0.0, 1.0, 2.0):
        e.tracker.report(0, False, now=now)
    assert not e._should_defer(mm.MMonElection(1, 1, 0, score=0.2))
    # a better-connected HIGHER rank beats me once I am the lossy one
    for now in (0.0, 1.0, 2.0):
        e.tracker.report(2, False, now=now)  # my links are bad
    assert e._should_defer(mm.MMonElection(1, 1, 2, score=1.0))


@BOTH
def test_victory_preempt_gated_by_score(pm, mm):
    e = _elector(pm, 0, 3, pm.STRATEGY_CONNECTIVITY)
    win = mm.MMonElection(3, 4, 1, quorum=[1, 2])
    # healthy everywhere: scores tie, no preempt thrash
    assert not e._should_preempt(win)
    # I can reach everyone but the tracker says mon.1 flaps: take over
    for now in (0.0, 1.0, 2.0):
        e.tracker.report(1, False, now=now)
    e.tracker.report(2, True, now=2.0)
    assert e._should_preempt(win)
    # classic always preempts on rank
    assert _elector(pm, 0, 3,
                    pm.STRATEGY_CLASSIC)._should_preempt(win)


@BOTH
def test_dethrone_requires_absolute_evidence(pm, mm):
    """The dethrone trigger must fire for a healthy peon watching the
    leader's link collapse — and must NOT fire from the lossy mon
    itself, whose view of EVERYONE (leader included) is degraded."""
    async def run():
        fired = []

        async def _noop():
            pass

        e = _elector(pm, 1, 3, pm.STRATEGY_CONNECTIVITY,
                     {"mon_election_timeout": 0.0,
                      "mon_elector_score_halflife": 1.0})
        e.leader = 0
        e.electing = False
        e.call_election = lambda: fired.append(1) or _noop()
        # healthy view: leader fine -> no trigger
        e._maybe_dethrone(now=100.0)
        assert not fired
        # leader collapsed, my link to mon.2 is solid -> trigger
        for now in (0.0, 1.0, 2.0, 3.0):
            e.tracker.report(0, False, now=now)
        e.tracker.report(2, True, now=3.0)
        e._maybe_dethrone(now=100.0)
        assert fired
        # lossy node: every view degraded, no solid link -> no trigger
        e2 = _elector(pm, 0, 3, pm.STRATEGY_CONNECTIVITY,
                      {"mon_election_timeout": 0.0,
                       "mon_elector_score_halflife": 1.0})
        e2.leader = 1
        e2.electing = False
        e2.call_election = lambda: fired.append(2) or _noop()
        for now in (0.0, 1.0, 2.0, 3.0):
            e2.tracker.report(1, False, now=now)
            e2.tracker.report(2, False, now=now)
        e2._maybe_dethrone(now=100.0)
        assert 2 not in fired, "lossy mon dethroned a healthy leader"
        await asyncio.sleep(0)  # drain the spawned election task

    asyncio.run(run())


# -- integration: lossy mon.0 loses the quorum lead -------------------------

def test_lossy_rank0_stops_leading():
    """3-mon quorum under CONNECTIVITY: healthy cluster elects mon.0
    (rank tie-break), then mon.0's links turn lossy — leadership must
    settle on a healthy mon and mon.0 must not win it back while it
    flaps (the ElectionLogic.cc scenario the strategy exists for)."""
    async def run_():
        cluster = MonQuorum(num_osds=2, config=dict(CONN_QUORUM))
        await cluster.start()
        try:
            assert cluster.mons[0].is_leader()
            # every ~4th frame on any mon.0 connection kills it —
            # pings still occasionally round-trip (a flap, not a death)
            cluster.mons[0].msgr.inject_socket_failures = 4
            # let probes drag mon.0's score down and the quorum re-form:
            # wait, up to a bound, until both healthy mons agree on a
            # leader other than mon.0 (a fixed 3 s was not always enough
            # on a loaded host, where fewer frames fail in that time)
            loop = asyncio.get_running_loop()
            settle_by = loop.time() + 30.0

            def settled() -> bool:
                views = set()
                for rank in (1, 2):
                    el = cluster.mons[rank].elector
                    if el.electing or el.leader is None:
                        return False
                    views.add(el.leader)
                return len(views) == 1 and 0 not in views

            while not settled():
                assert loop.time() < settle_by, \
                    "the healthy mons never agreed on a leader but mon.0"
                await asyncio.sleep(0.1)
            observed = set()
            deadline = asyncio.get_running_loop().time() + 6.0
            while asyncio.get_running_loop().time() < deadline:
                for rank in (1, 2):
                    el = cluster.mons[rank].elector
                    if not el.electing and el.leader is not None:
                        observed.add(el.leader)
                await asyncio.sleep(0.1)
            assert observed, "healthy mons never reached a stable view"
            assert 0 not in observed, (
                f"flapping mon.0 still won leadership: {observed}")
            # the healthy pair holds a working quorum meanwhile (poll:
            # a sampled instant may land mid-election)
            healthy = [cluster.mons[r] for r in (1, 2)]
            for _ in range(40):
                if any(m.is_leader() for m in healthy):
                    break
                await asyncio.sleep(0.1)
            assert any(m.is_leader() for m in healthy)
        finally:
            await cluster.stop()

    run(run_(), 90)


# -- quorum (tests/test_quorum.py, mon-only) ---------------------------------


async def _pool(client, name, pg_num=4):
    rc, out = await client.command(
        {"prefix": "osd pool create", "name": name, "pg_num": pg_num,
         "pool_type": "replicated", "size": 2})
    assert rc == 0, out
    return out["pool_id"]


def test_election_lowest_rank_wins():
    async def main():
        q = MonQuorum(num_osds=2)
        await q.start()
        try:
            assert {m.elector.leader for m in q.mons.values()} == {0}
            assert q.mons[0].is_leader() and not q.mons[1].is_leader()
        finally:
            await q.stop()

    run(main())


def test_mutations_replicate_to_all_mons():
    async def main():
        q = MonQuorum(num_osds=3)
        await q.start()
        client = MonClient(q.mon_addrs)
        try:
            await _pool(client, "qpool")
            await q.wait_for_epoch(q.leader.osdmap.epoch)
            assert len({m.paxos.last_committed
                        for m in q.mons.values()}) == 1
            assert len({m.osdmap.encode() for m in q.mons.values()}) == 1
            assert all(m.osdmap.lookup_pool("qpool") >= 0
                       for m in q.mons.values())
        finally:
            await client.shutdown()
            await q.stop()

    run(main())


def test_command_via_peon_is_forwarded():
    async def main():
        q = MonQuorum(num_osds=2)
        await q.start()
        peon = MonClient([q.mon_addrs[2]])
        try:
            await _pool(peon, "fwd")
            rc, out = await peon.command({"prefix": "mon stat"})
            assert rc == 0 and out["leader"] == 0
            assert sorted(out["quorum"]) == [0, 1, 2]
        finally:
            await peon.shutdown()
            await q.stop()

    run(main())


def test_leader_kill_fails_over_and_serves():
    async def main():
        q = MonQuorum(num_osds=3)
        await q.start()
        client = MonClient(q.mon_addrs)
        try:
            await _pool(client, "fail")
            await q.kill_mon(0)
            await q.wait_for_quorum(timeout=20.0)
            assert q.leader.rank in (1, 2)
            rc, out = await client.command({"prefix": "status"})
            assert rc == 0 and "fail" in out["pools"]
            await _pool(client, "after")
            await q.wait_for_epoch(q.leader.osdmap.epoch)
            assert len({m.osdmap.encode() for m in q.mons.values()}) == 1
        finally:
            await client.shutdown()
            await q.stop()

    run(main(), 120)


def test_peon_kill_quorum_continues():
    async def main():
        q = MonQuorum(num_osds=2)
        await q.start()
        client = MonClient(q.mon_addrs)
        try:
            await q.kill_mon(2)
            await _pool(client, "p2")
            assert q.mons[0].is_leader()
        finally:
            await client.shutdown()
            await q.stop()

    run(main())


def test_rejoining_mon_catches_up():
    async def main():
        q = MonQuorum(num_osds=2)
        await q.start()
        client = MonClient(q.mon_addrs)
        try:
            await q.kill_mon(2)
            for i in range(5):
                await _pool(client, f"cu{i}")
            lead_lc = q.mons[0].paxos.last_committed
            await q.revive_mon(2)
            await q.wait_for(
                lambda: q.mons[2].paxos is not None
                and q.mons[2].paxos.last_committed >= lead_lc, 10.0,
                "the revived mon never caught up")
            assert q.mons[2].osdmap.lookup_pool("cu4") >= 0
            assert q.mons[2].osdmap.encode() == q.mons[0].osdmap.encode()
        finally:
            await client.shutdown()
            await q.stop()

    run(main(), 90)


def test_subscriber_follows_every_commit():
    """A client subscribed through MGetMap receives the full map, then one
    incremental per commit; applied in order they give each mon's map."""
    from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap

    async def main():
        q = MonQuorum(num_osds=6)
        await q.start()
        client = MonClient(q.mon_addrs)
        try:
            await client.subscribe()
            await _pool(client, "sub", pg_num=16)
            for osd in (1, 4):
                assert (await client.command(
                    {"prefix": "osd out", "osd": osd}))[0] == 0
            epoch = q.leader.osdmap.epoch
            await q.wait_for_epoch(epoch)
            m, seen = None, 0
            for _ in range(100):
                for msg in client.maps[seen:]:
                    if msg.full_map:
                        m = OSDMap.decode(msg.full_map)
                    for raw in msg.incrementals:
                        inc = Incremental.decode(raw)
                        if m is not None and inc.epoch == m.epoch + 1:
                            m.apply_incremental(inc)
                seen = len(client.maps)
                if m is not None and m.epoch == epoch:
                    break
                await asyncio.sleep(0.05)
            assert m is not None and m.epoch == epoch
            assert m.encode() == q.mons[0].osdmap.encode()
        finally:
            await client.shutdown()
            await q.stop()

    run(main())


# -- the process entry point ---------------------------------------------------


def _spawn(rank, addrs, store, config):
    return subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.mon", "--num-osds", "20",
         "--osds-per-host", "2", "--rank", str(rank), "--mon-addrs",
         ",".join(addrs), "--store-path", store, "--config",
         json.dumps(config)], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)


def _free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_mon_processes_survive_a_leader_kill_and_restart(tmp_path):
    """Three `python -m ceph_tpu_torch.mon` processes on SQLite stores,
    signed and secure: quorum, commands, kill -9 of the leader, a commit
    through the new leader, the killed rank restarted from its store and
    caught up, and every store's map equal to the subscriber's."""
    from ceph_tpu_torch.kv import SQLiteDB
    from ceph_tpu_torch.osd.osdmap import OSDMap

    secret = auth.generate_secret()
    config = {**FAST_QUORUM, "auth_secret": secret, "auth_secure": True,
              "ms_local_fastpath": False,
              "ms_compress_methods": "snappy,zlib"}
    addrs = [f"127.0.0.1:{p}" for p in _free_ports(3)]
    stores = [str(tmp_path / f"mon{r}") for r in range(3)]
    procs = {r: _spawn(r, addrs, stores[r], config) for r in range(3)}

    async def main():
        for p in procs.values():
            line = await asyncio.to_thread(p.stdout.readline)
            assert line.startswith("MON_ADDR"), line
        client = MonClient(addrs, secret=secret, secure=True,
                           compress_methods="snappy,zlib")
        try:
            for _ in range(100):
                rc, out = await client.command({"prefix": "mon stat"})
                if rc == 0 and len(out.get("quorum", [])) == 3:
                    break
                await asyncio.sleep(0.1)
            leader = out["leader"]
            await _pool(client, "proc", pg_num=8)
            assert (await client.command({"prefix": "osd out",
                                          "osd": 3}))[0] == 0
            procs[leader].send_signal(signal.SIGKILL)
            procs[leader].wait()
            client.target = (leader + 1) % 3
            for _ in range(200):
                rc, out = await client.command({"prefix": "mon stat"})
                if rc == 0 and out.get("leader") not in (None, leader) \
                        and not out.get("election_epoch", 1) % 2:
                    break
                await asyncio.sleep(0.1)
            assert out["leader"] != leader
            assert (await client.command({"prefix": "osd in",
                                          "osd": 3}))[0] == 0
            rc, status = await client.command({"prefix": "status"})
            epoch = status["epoch"]
            procs[leader] = _spawn(leader, addrs, stores[leader], config)
            line = await asyncio.to_thread(procs[leader].stdout.readline)
            assert line.startswith("MON_ADDR"), line
            for _ in range(200):
                client.target = leader
                rc, out = await client.command({"prefix": "mon stat"})
                if rc == 0 and out.get("last_committed", 0) >= \
                        status.get("last_committed", 0) and \
                        len(out.get("quorum", [])) == 3:
                    break
                await asyncio.sleep(0.1)
            await client.subscribe()
            await asyncio.wait_for(client.map_event.wait(), 10)
            return epoch
        finally:
            await client.shutdown()

    try:
        epoch = asyncio.run(asyncio.wait_for(main(), 120))
    finally:
        for p in procs.values():
            p.kill()
            p.wait()
    maps = []
    for path in stores:
        db = SQLiteDB(path)
        db.create_and_open()
        maps.append(OSDMap.decode(db.get("mon", b"osdmap_full")))
        db.close()
    assert {m.epoch for m in maps} == {epoch}
    assert len({m.encode() for m in maps}) == 1
    assert maps[0].lookup_pool("proc") >= 0 and maps[0].is_in(3)


# -- ROADMAP C5: the health walk holds the leader past its lease ---------------


@pytest.mark.parametrize("kind", ["torch", "jax"])
def test_health_walk_outlasting_the_lease_forces_an_election(kind):
    """Reference fault C5, copied by the port: `health` maps every PG on the
    host inside the leader's event loop, so a walk longer than the lease's
    slack (mon_lease 0.8 s, renewed every 0.32 s here) starves the leases
    and the peons call an election.  The smallest case found: 20 OSDs, one
    replicated pool of 1,024 PGs, a walk of 1.5-2.1 s (256 PGs, 0.44-0.47
    s, keeps the quorum)."""
    async def main():
        q = MonQuorum((kind,) * 3, num_osds=20, osds_per_host=2)
        await q.start()
        client = MonClient(q.mon_addrs, kind=kind)
        try:
            await _pool(client, "walk", pg_num=1024)
            # a loaded host can stall the shared loop past a lease while
            # the pool commits, and the peons then elect: read the
            # election epochs only from a settled quorum at the new map
            # (no mon electing, so `q.leader` is set)
            await q.wait_for_quorum()
            await q.wait_for_epoch(max(m.osdmap.epoch
                                       for m in q.mons.values()))
            await q.wait_for_quorum()
            before = {r: m.elector.epoch for r, m in q.mons.items()}
            assert not any(m.elector.electing for m in q.mons.values())
            rc, out = await client.command({"prefix": "health"},
                                           timeout=60)
            assert rc == 0 and out["status"] == "HEALTH_WARN"
            await q.wait_for(
                lambda: all(m.elector.epoch > before[r]
                            for r, m in q.mons.items()), 10.0,
                "the walk did not cost the quorum an election")
            await q.wait_for_quorum()
        finally:
            await client.shutdown()
            await q.stop()

    run(main(), 90)
