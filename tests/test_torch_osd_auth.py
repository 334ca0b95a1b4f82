"""The data-path halves of the JAX package's auth, quorum and lockdep tests,
on port clusters (the mon halves are in tests/test_torch_auth.py,
test_torch_mon.py and test_torch_lockdep.py).

Mirrors tests/test_auth.py's keyed cluster (keyed clients read and write,
unkeyed and wrong-keyed ones get no map), key rotation overlap, ticket
grant and use, and secure mode on the wire; tests/test_quorum.py's leader
kill under a write load (no acked write lost); and tests/test_lockdep.py's
cluster workload under the lock-order checker, cut to the slice: writes,
an overwrite, concurrent EC writes and an EC RMW (its object-class call
and scrub wait for their slice, ROADMAP A4b).
"""

import asyncio

import pytest

from ceph_tpu_torch.common import auth, lockdep
from ceph_tpu_torch.msg.messages import MAuth

from torch_cluster_helpers import Cluster
from torch_cluster_helpers import one_torch_thread  # noqa: F401
from torch_mon_helpers import FAST_QUORUM


def run(coro, timeout: float = 120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture
def wire_transport():
    """Real sockets for the test that observes wire bytes."""
    import ceph_tpu_torch.msg as msg_mod

    old = msg_mod.LOCAL_FASTPATH
    msg_mod.LOCAL_FASTPATH = False
    yield
    msg_mod.LOCAL_FASTPATH = old


def keyed(secret, secure=False, **kw):
    return Cluster(num_osds=3,
                   osd_config={"auth_secret": secret, "auth_secure": secure},
                   mon_config={"auth_secret": secret, "auth_secure": secure},
                   client_secret=secret, client_secure=secure, **kw)


def test_keyed_cluster_accepts_keyed_rejects_unkeyed():
    secret = auth.generate_secret()

    async def main():
        cluster = keyed(secret)
        await cluster.start()
        try:
            await cluster.client.create_replicated_pool("p", size=2,
                                                        pg_num=8)
            io = cluster.client.open_ioctx("p")
            await io.write_full("obj", b"signed payload " * 100)
            assert await io.read("obj") == b"signed payload " * 100
            for bad in (None, auth.generate_secret()):
                intruder = cluster.new_client("torch", secret=bad)
                with pytest.raises(Exception):
                    await asyncio.wait_for(intruder.connect(), 3.0)
                await intruder.shutdown()
        finally:
            await cluster.stop()
    run(main())


def test_key_rotation_overlap():
    old_k, new_k = auth.generate_secret(), auth.generate_secret()

    async def main():
        cluster = keyed(f"2:{new_k},1:{old_k}")
        await cluster.start()
        try:
            await cluster.client.create_replicated_pool("p", size=2,
                                                        pg_num=4)
            oldie = cluster.new_client("torch", secret=f"1:{old_k}")
            await oldie.connect()
            io = oldie.open_ioctx("p")
            await io.write_full("o", b"old-key client payload")
            assert await io.read("o") == b"old-key client payload"
            await oldie.shutdown()
            stranger = cluster.new_client(
                "torch", secret=f"9:{auth.generate_secret()}")
            with pytest.raises(Exception):
                await asyncio.wait_for(stranger.connect(), 3.0)
            await stranger.shutdown()
        finally:
            await cluster.stop()
    run(main())


def test_ticket_grant_and_use():
    secret = auth.generate_secret()

    async def main():
        cluster = keyed(secret)
        await cluster.start()
        try:
            ticket = await cluster.client.auth_get_ticket()
            entity, _base = auth.check_ticket(auth.parse_secret(secret),
                                              ticket)
            assert entity == cluster.client.msgr.entity_name
            await cluster.client.create_replicated_pool("t", size=2,
                                                        pg_num=4)
            io = cluster.client.open_ioctx("t")
            await io.write_full("obj", b"ticketed io")
            assert await io.read("obj") == b"ticketed io"
            # a forged proof is refused
            bad = cluster.new_client("torch")
            await bad.connect()
            mon = await bad.msgr.connect(bad.mon_addr)
            fut = asyncio.get_running_loop().create_future()
            tid = bad._next_tid()
            bad._futures[tid] = fut
            await mon.send(MAuth(tid, "client.evil", 2, kid=0,
                                 client_challenge=b"x" * 16,
                                 proof=b"bogus!!!"))
            assert (await asyncio.wait_for(fut, 5.0)).rc != 0
            await bad.shutdown()
        finally:
            await cluster.stop()
    run(main())


def test_secure_mode_encrypts_the_wire(wire_transport):
    secret = auth.generate_secret()
    marker = b"SUPER-SECRET-PAYLOAD-MARKER"

    async def main():
        cluster = keyed(secret, secure=True)
        await cluster.start()
        try:
            await cluster.client.create_ec_pool(
                "enc", {"plugin": "ec_torch", "k": "2", "m": "1",
                        "crush-failure-domain": "osd"}, pg_num=4)
            io = cluster.client.open_ioctx("enc")
            sniffed = bytearray()
            import ceph_tpu_torch.msg as msg_mod

            orig_oc = msg_mod.asyncio.open_connection

            async def tee_oc(*args, **kw):
                r, w = await orig_oc(*args, **kw)
                ow = w.write

                def tee(data, _ow=ow):
                    sniffed.extend(data)
                    return _ow(data)

                w.write = tee
                return r, w

            msg_mod.asyncio.open_connection = tee_oc
            try:
                payload = marker * 200
                await io.write_full("obj", payload)
                assert await io.read("obj") == payload
            finally:
                msg_mod.asyncio.open_connection = orig_oc
            assert len(sniffed) > len(payload)
            assert marker not in bytes(sniffed)
            plain = cluster.new_client("torch", secure=False)
            with pytest.raises(Exception):
                await asyncio.wait_for(plain.connect(), 4.0)
            await plain.shutdown()
        finally:
            await cluster.stop()
    run(main())


def test_leader_kill_mid_write_load():
    """tests/test_quorum.py: kill the leader mon while writes run; no
    acked write may be lost."""
    async def main():
        cluster = Cluster(num_osds=4, osds_per_host=1, num_mons=3,
                          mon_config=dict(FAST_QUORUM))
        await cluster.start()
        try:
            await cluster.client.create_replicated_pool("load", size=3,
                                                        pg_num=8)
            io = cluster.client.open_ioctx("load")
            acked, maybe = {}, {}

            async def workload():
                seq = 0
                while True:
                    seq += 1
                    oid = f"o-{seq % 12}"
                    data = bytes([seq % 256]) * (1000 + seq % 5000)
                    maybe.setdefault(oid, []).append(data)
                    try:
                        await io.write_full(oid, data)
                        acked[oid] = data
                        maybe[oid] = []
                    except Exception:
                        pass
                    await asyncio.sleep(0)

            task = asyncio.get_running_loop().create_task(workload())
            try:
                await asyncio.sleep(2.0)
                await cluster.kill_mon(0)
                await cluster.wait_for_quorum(timeout=20.0)
                await asyncio.sleep(3.0)
            finally:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
            assert len(acked) >= 5
            await cluster.wait_for_clean(timeout=60.0)
            for oid, data in acked.items():
                got = await io.read(oid)
                assert any(got == want
                           for want in [data] + maybe.get(oid, [])), oid
        finally:
            await cluster.stop()
    run(main(), 180)


@pytest.fixture
def lockdep_on():
    was = lockdep.enabled
    lockdep.enabled = True
    lockdep.reset()
    try:
        yield
    finally:
        lockdep.enabled = was
        lockdep.reset()


def test_cluster_lock_orders_are_clean(lockdep_on):
    """tests/test_lockdep.py's workload under the checker, cut to the
    slice: an order inversion between the OSD's lock classes raises."""
    async def main():
        cluster = Cluster(num_osds=3, osds_per_host=1)
        await cluster.start()
        try:
            await cluster.client.create_replicated_pool("ld", size=2,
                                                        pg_num=4)
            await cluster.client.create_ec_pool(
                "ldec", {"plugin": "ec_torch", "k": "2", "m": "1",
                         "crush-failure-domain": "osd"}, pg_num=4)
            io = cluster.client.open_ioctx("ld")
            ec = cluster.client.open_ioctx("ldec")
            await io.write_full("obj", b"x" * 9000)
            await io.write("obj", b"yyy", 100)
            await asyncio.gather(*(ec.write_full(f"e{i}", b"z" * 20_000)
                                   for i in range(4)))
            await ec.write("e1", b"w" * 5000, 3000)
            await cluster.wait_for_clean(timeout=30.0)
            assert await io.read("obj", 100, 3) == b"yyy"
            assert (await ec.read("e1"))[3000:8000] == b"w" * 5000
        finally:
            await cluster.stop()
    run(main())
