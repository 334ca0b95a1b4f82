"""The port's lockdep (ceph_tpu_torch.common.lockdep) against the JAX
package's (ceph_tpu.common.lockdep), mirroring tests/test_lockdep.py.

The same acquisition sequences go through both checkers: each flags the
same inversions (direct and transitive) and allows the same same-class
nesting, and both record the same order edges.  The JAX test's cluster
workload needs the OSD daemons and the client, which come with a later
slice; here a 3-mon quorum of the port's mons runs its commands under
lockdep (the mutation lock, Paxos' propose lock) and its orders stay
acyclic.
"""

import asyncio

import pytest

from ceph_tpu.common import lockdep as jld
from ceph_tpu_torch.common import lockdep as tld

from torch_mon_helpers import MonClient, MonQuorum

BOTH = [pytest.param(tld, id="torch"), pytest.param(jld, id="jax")]


@pytest.fixture
def lockdep_on():
    was = (tld.enabled, jld.enabled)
    for mod in (tld, jld):
        mod.enabled = True
        mod.reset()
    try:
        yield
    finally:
        tld.enabled, jld.enabled = was
        for mod in (tld, jld):
            mod.reset()


def test_flag_is_registered_with_the_jax_default():
    from ceph_tpu.common import flags as jflags
    from ceph_tpu_torch.common import flags as tflags

    t = tflags.registry()["CEPH_TPU_LOCKDEP"]
    j = jflags.registry()["CEPH_TPU_LOCKDEP"]
    assert (t["default"], t["scope"]) == (j["default"], j["scope"])


@pytest.mark.parametrize("ld", BOTH)
def test_order_inversion_detected(lockdep_on, ld):
    a, b = asyncio.Lock(), asyncio.Lock()

    async def main():
        async with ld.guard(a, "A"):
            async with ld.guard(b, "B"):
                pass
        with pytest.raises(ld.LockOrderInversion):
            async with ld.guard(b, "B"):
                async with ld.guard(a, "A"):
                    pass

    asyncio.run(asyncio.wait_for(main(), 10))
    assert ld._edges == {"A": {"B"}}


@pytest.mark.parametrize("ld", BOTH)
def test_same_class_nesting_allowed(lockdep_on, ld):
    a, b = asyncio.Lock(), asyncio.Lock()

    async def main():
        async with ld.guard(a, "objlock"):
            async with ld.guard(b, "objlock"):
                pass

    asyncio.run(asyncio.wait_for(main(), 10))
    assert not ld._edges.get("objlock")


@pytest.mark.parametrize("ld", BOTH)
def test_transitive_cycle_detected(lockdep_on, ld):
    la, lb, lc = asyncio.Lock(), asyncio.Lock(), asyncio.Lock()

    async def main():
        async with ld.guard(la, "A"):
            async with ld.guard(lb, "B"):
                pass
        async with ld.guard(lb, "B"):
            async with ld.guard(lc, "C"):
                pass
        with pytest.raises(ld.LockOrderInversion):
            async with ld.guard(lc, "C"):
                async with ld.guard(la, "A"):
                    pass

    asyncio.run(asyncio.wait_for(main(), 10))
    assert ld._edges == {"A": {"B"}, "B": {"C"}}


def test_named_locks_record_the_same_edges_in_both(lockdep_on):
    """lockdep.Lock (the named-class lock the mons use) nested the same
    way records the same edge set in both packages."""
    async def main(ld):
        outer, inner = ld.Lock("mon.mutation"), ld.Lock("paxos.propose")
        async with outer:
            async with inner:
                pass
        return {k: set(v) for k, v in ld._edges.items()}

    assert asyncio.run(main(tld)) == asyncio.run(main(jld)) == {
        "mon.mutation": {"paxos.propose"}}


def test_mon_quorum_lock_orders_are_clean(lockdep_on):
    """Commands through a 3-mon port quorum under lockdep: no inversion is
    raised and the recorded order graph is acyclic."""
    async def main():
        q = MonQuorum(num_osds=4)
        await q.start()
        client = MonClient(q.mon_addrs)
        try:
            rc, out = await client.command(
                {"prefix": "osd pool create", "name": "ld", "pg_num": 4,
                 "pool_type": "replicated", "size": 2})
            assert rc == 0, out
            for osd in (1, 2):
                assert (await client.command(
                    {"prefix": "osd out", "osd": osd}))[0] == 0
            rc, out = await client.command({"prefix": "status"})
            assert rc == 0 and "ld" in out["pools"]
        finally:
            await client.shutdown()
            await q.stop()

    asyncio.run(asyncio.wait_for(main(), 60))
    assert "paxos.propose" in tld._edges.get("mon.mutation", set())
    for src in tld._edges:
        for dst in tld._edges[src]:
            assert not tld._reachable(dst, src), (src, dst)
