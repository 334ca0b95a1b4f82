"""The port's group commit (ceph_tpu_torch.os.groupcommit and
TPUStore.submit_batch) against the JAX package's, on the CPU.

The tests of tests/test_group_commit.py that tests/test_torch_osd_units.py
does not already run (there: the MemStore committer) run their bodies with
the `ceph_tpu` names bound to the port's (`on_port`): stores on
`device="cpu"`, clusters on port daemons.  Three bodies import `ceph_tpu`
modules inside themselves (the messenger's fast-path switch, the wire
decode of a sub-read reply, the codec and ec_util views), so they are
written out here on the port's modules.  Then the port's own: the merged
commit of a batch writes the same block file and KV (fsid aside) as the
JAX store's, and a merged batch on a FaultStore records the JAX trace.
"""

import asyncio
import functools
import os

import numpy as np
import pytest

from ceph_tpu.kv import SQLiteDB as JSQLiteDB
from ceph_tpu.os import ObjectId as JObjectId
from ceph_tpu.os import Transaction as JTransaction
from ceph_tpu.os import faultstore as jfault
from ceph_tpu.os.tpustore import TPUStore as JTPUStore
from ceph_tpu_torch.os import ObjectId, Transaction
from ceph_tpu_torch.os import faultstore as tfault
from ceph_tpu_torch.os.tpustore import TPUStore

from torch_cluster_helpers import JaxShapedCluster, tpustore_factory
from torch_cluster_helpers import one_torch_thread  # noqa: F401
from test_torch_osd_units import call, on_port

import test_group_commit as j_gc

CPU_OVERRIDES = {
    "FaultStore": functools.partial(tfault.FaultStore, device="cpu"),
    "TPUStore": functools.partial(TPUStore, device="cpu"),
    "CrashSweep": functools.partial(tfault.CrashSweep, device="cpu"),
    "Cluster": JaxShapedCluster,
    "tpustore_factory": tpustore_factory,
}


def port_body(name: str):
    return on_port(j_gc, name, **CPU_OVERRIDES)


@pytest.mark.parametrize("name", [
    "test_submit_batch_one_barrier_for_n_txns",
    "test_submit_batch_read_your_writes_spans_the_batch",
    "test_submit_batch_failure_isolated_per_txn",
    "test_committer_concurrent_txns_share_one_fsync",
    "test_committer_flush_sync_is_a_total_order_barrier",
    "test_committer_commit_now_drains_first",
    "test_committer_error_reaches_the_right_caller",
    "test_committer_stop_drains_and_latches_inline",
    "test_crash_sweep_with_group_commit_armed",
    "test_batched_sweep_still_catches_broken_stores",
    "test_cut_inside_accumulating_window",
    "test_group_commit_on_persistent_cluster",
])
def test_store_and_committer(name, tmp_path):
    call(port_body(name), tmp_path=tmp_path)


def test_submit_batch_base_impl_on_memstore():
    port_body("test_submit_batch_base_impl_on_memstore")()


def test_committer_kill_switch_is_inline_parity(tmp_path, monkeypatch):
    call(port_body("test_committer_kill_switch_is_inline_parity"),
         tmp_path=tmp_path, monkeypatch=monkeypatch)


# -- bodies that import ceph_tpu themselves, on the port's modules ---------

EC_PROFILE = {"plugin": "ec_torch", "technique": "reed_sol_van",
              "k": "2", "m": "1", "crush-failure-domain": "osd"}


def test_zero_copy_bit_exact_readback_under_thrash(monkeypatch):
    """tests/test_group_commit.py's zero-copy leg on the port: writes and
    reads through the socket path (the port messenger's local fast path
    off), the client mutating its buffer after every ack; the stores and
    every readback hold the bytes as written."""
    from ceph_tpu_torch import msg as msg_mod

    monkeypatch.setattr(msg_mod, "LOCAL_FASTPATH", False)

    async def main():
        cluster = JaxShapedCluster(num_osds=3, osds_per_host=3)
        await cluster.start()
        try:
            await cluster.client.create_ec_pool(
                "zc", profile=EC_PROFILE, pg_num=4)
            io = cluster.client.open_ioctx("zc")
            rng = np.random.default_rng(7)
            originals = {}
            for i in range(6):
                buf = bytearray(
                    rng.integers(0, 256, 16384, dtype=np.uint8).tobytes())
                originals[f"t{i}"] = bytes(buf)
                await io.write_full(f"t{i}", buf)
                for j in range(len(buf)):
                    buf[j] = 0xAA
            for i in range(6):
                got = await io.read(f"t{i}")
                assert isinstance(got, bytes)
                assert got == originals[f"t{i}"], f"t{i} corrupted"
                got = await io.read(f"t{i}", offset=1000, length=500)
                assert got == originals[f"t{i}"][1000:1500]
        finally:
            await cluster.stop()

    asyncio.run(asyncio.wait_for(main(), 180))


def test_sub_read_reply_data_is_a_view():
    from ceph_tpu_torch.msg.messages import MOSDSubReadReply

    msg = MOSDSubReadReply(1, 0, b"x" * 4096, {}, shard=0)
    back = MOSDSubReadReply.decode(msg.encode())
    assert isinstance(back.data, memoryview)
    assert bytes(back.data) == b"x" * 4096


def test_encode_decode_views_are_immutable_and_exact():
    from ceph_tpu_torch.common.buffer import is_immutable
    from ceph_tpu_torch.ec.registry import create_erasure_code
    from ceph_tpu_torch.osd import ec_util

    codec = create_erasure_code(
        {"plugin": "ec_torch", "technique": "reed_sol_van",
         "k": "2", "m": "1", "device": "cpu"})
    sinfo = ec_util.StripeInfo(2, 8192)
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()
    shards = ec_util.encode(sinfo, codec, data, range(3))
    for i, shard in shards.items():
        assert is_immutable(shard), f"shard {i} is caller-mutable"
    out = ec_util.decode(sinfo, codec,
                         {0: bytes(shards[0]), 1: bytes(shards[1])})
    assert bytes(out) == data
    out = ec_util.decode(sinfo, codec,
                         {0: bytes(shards[0]), 2: bytes(shards[2])})
    assert bytes(out) == data


# -- the port's own: the merged commit writes the JAX store's bytes --------

def _batch(T, O, seed: int) -> list:
    """Eight transactions of one merged batch: fresh writes across span
    boundaries, small overwrites (the deferred WAL), a clone, xattrs and
    omap, a zero and a remove."""
    rng = np.random.default_rng(seed)

    def data(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    txns = []
    for i in range(4):
        t = T()
        n = 70_000 + 4_321 * i
        t.write("cc", O(f"o{i}"), 0, n, data(n))
        t.setattr("cc", O(f"o{i}"), "a", data(8))
        txns.append(t)
    t = T()
    t.write("cc", O("o0"), 100, 300, data(300))
    t.omap_setkeys("cc", O("o1"), {"k": data(12)})
    txns.append(t)
    t = T()
    t.clone("cc", O("o1"), O("o1c"))
    txns.append(t)
    t = T()
    t.zero("cc", O("o2"), 5_000, 1_000)
    t.write("cc", O("o3"), 66_000, 200, data(200))
    txns.append(t)
    t = T()
    t.remove("cc", O("o2"))
    txns.append(t)
    return txns


def _kv_dump(kv) -> list:
    out = []
    for prefix in jfault.KV_PREFIXES:
        for key, value in kv.get_iterator(prefix):
            if (prefix, bytes(key)) != ("S", b"fsid"):
                out.append((prefix, bytes(key), bytes(value or b"")))
    return out


@pytest.mark.parametrize("rounds", [1, 3])
def test_merged_commit_writes_the_jax_stores_block_file_and_kv(rounds,
                                                                tmp_path):
    disks = {}
    for kind, S, T, O in (("jax", JTPUStore, JTransaction, JObjectId),
                          ("torch", functools.partial(TPUStore,
                                                      device="cpu"),
                           Transaction, ObjectId)):
        path = str(tmp_path / kind)
        s = S(path)
        s.mkfs()
        s.mount()
        t = T()
        t.create_collection("cc")
        s.queue_transaction(t)
        perf = []
        for r in range(rounds):
            acked = []
            txns = _batch(T, O, seed=r)
            for i, txn in enumerate(txns):
                txn.register_on_commit(lambda i=i: acked.append(i))
            assert s.submit_batch(txns) == [None] * len(txns)
            assert acked == list(range(len(txns)))
            perf.append(dict(s.perf))
        reads = {str(o): s.read("cc", o) for o in s.list_objects("cc")}
        s.umount()
        with open(os.path.join(path, "block"), "rb") as f:
            block = f.read()
        kv = JSQLiteDB(os.path.join(path, "meta.db"))
        kv.create_and_open()
        disks[kind] = (block, _kv_dump(kv), perf, reads)
        kv.close()
    assert disks["torch"][0] == disks["jax"][0]
    assert disks["torch"][1] == disks["jax"][1]
    assert disks["torch"][2] == disks["jax"][2]
    assert disks["torch"][3] == disks["jax"][3]
    assert disks["torch"][2][-1]["gc_batches"] == rounds


def test_merged_batch_records_the_jax_trace(tmp_path):
    traces = {}
    for kind, mod, kw, T, O in (
            ("jax", jfault, {}, JTransaction, JObjectId),
            ("torch", tfault, {"device": "cpu"}, Transaction, ObjectId)):
        s = mod.FaultStore(str(tmp_path / kind), **kw)
        s.mkfs()
        s.mount()
        t = T()
        t.create_collection("cc")
        s.queue_transaction(t)
        s.crashlog.events.clear()
        assert s.submit_batch(_batch(T, O, seed=5)) == [None] * 8
        traces[kind] = list(s.crashlog.events)
        s.umount()
    assert traces["torch"] == traces["jax"]
    # one sync KV commit for the eight transactions
    assert sum(ev[0] == "kv" and ev[2] for ev in traces["torch"]) == 1
