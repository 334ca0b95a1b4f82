"""Pools of the port's LRC, SHEC and CLAY codecs in the embedded cluster,
against the JAX package's cluster, on the CPU.

24 OSDs on 12 hosts carry an LRC k=4 m=2 l=3 pool, BASELINE config 3's
layered LRC (k=8 m=4 l=4, 12 chunks), a SHEC 4/3/2 and a CLAY 4/2/5 pool,
each over hosts.  The same seeded objects go into a JAX `LocalCluster`
and a port `LocalCluster(device="cpu")`; the stores (shard bytes, object
info and hinfo xattrs), reads after OSD losses, scrub verdicts and
repairs are bytes or integers, so the tolerance is exact equality.  An
LRC codec has a chunk mapping, so these pools take ec_util's
stripe-by-stripe path, and hinfo is held to the host crc32c of every
shard as well.
"""

import json

import numpy as np
import pytest
from test_torch_codecs import restore_registered_generators  # noqa: F401

from ceph_tpu.os import ObjectId as JObjectId
from ceph_tpu.os import Transaction as JTransaction
from ceph_tpu.rados import embedded as jemb
from ceph_tpu_torch.ops import checksum as cks
from ceph_tpu_torch.os import ObjectId, Transaction
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.rados import embedded as temb

SEED = 20261018
SIZES = (1, 40_000, 1 << 20)
CONFIG3 = {"plugin": "lrc", "mapping": "DDDDDDDD____",
           "layers": json.dumps([["DDDDDDDDcc__", ""], ["DDDD______c_", ""],
                                 ["____DDDD___c", ""]]),
           "crush-failure-domain": "host"}
PROFILES = {
    "lrc": {"plugin": "lrc", "k": "4", "m": "2", "l": "3",
            "crush-failure-domain": "host"},
    "config3": CONFIG3,
    "shec": {"plugin": "shec", "k": "4", "m": "3", "c": "2",
             "crush-failure-domain": "host"},
    "clay": {"plugin": "clay", "k": "4", "m": "2", "d": "5",
             "crush-failure-domain": "host"},
}
NAMES = {"jax": (jemb, JObjectId, JTransaction),
         "port": (temb, ObjectId, Transaction)}


def _cluster(pkg: str):
    if pkg == "jax":
        c = jemb.LocalCluster(num_osds=24, osds_per_host=2)
    else:
        c = temb.LocalCluster(num_osds=24, osds_per_host=2, device="cpu")
    for name, profile in PROFILES.items():
        c.create_erasure_pool(name, profile, pg_num=8)
    return c


@pytest.fixture(scope="module")
def written():
    rng = np.random.default_rng(SEED)
    objs = {(pool, f"{pool}-{size}"): rng.bytes(size)
            for pool in PROFILES for size in SIZES}
    clusters = {pkg: _cluster(pkg) for pkg in NAMES}
    for c in clusters.values():
        for (pool, name), data in objs.items():
            c.open_ioctx(pool).write_full(name, data)
    yield clusters, objs
    for c in clusters.values():
        c.shutdown()


def _stores(c):
    out = {}
    for osd, store in c.stores.items():
        for cid in store.list_collections():
            for oid in store.list_objects(cid):
                out[osd, cid, str(oid)] = (store.read(cid, oid),
                                           store.getattrs(cid, oid))
    return out


def test_stores_hold_the_jax_bytes(written):
    clusters, objs = written
    assert _stores(clusters["port"]) == _stores(clusters["jax"])
    assert clusters["port"].osdmap.encode() == \
        clusters["jax"].osdmap.encode()
    port = clusters["port"]
    for (pool, name), data in objs.items():
        io = port.open_ioctx(pool)
        assert io.read(name) == data
        codec = port._codec(io.pool_id)
        assert len(io.acting(io.object_pg(name))[0]) == \
            codec.get_chunk_count()


@pytest.mark.parametrize("pool", PROFILES)
def test_hinfo_is_the_host_crc_of_every_shard(written, pool):
    clusters, _objs = written
    c = clusters["port"]
    io = c.open_ioctx(pool)
    name = f"{pool}-{1 << 20}"
    pg = io.object_pg(name)
    acting, _primary = io.acting(pg)
    for shard, osd in enumerate(acting):
        store, cid = c.stores[osd], temb.shard_collection(pg, shard)
        buf = store.read(cid, ObjectId(name))
        hinfo = ec_util.HashInfo.from_dict(json.loads(
            store.getattr(cid, ObjectId(name), temb.HINFO_ATTR)))
        assert hinfo.get_chunk_hash(shard) == cks.crc32c(0xFFFFFFFF, buf)
        assert hinfo.get_total_chunk_size() == len(buf)


@pytest.mark.parametrize("pool", PROFILES)
@pytest.mark.parametrize("lost", [(0,), (1,), (0, 2), (1, -1)],
                         ids=["data", "other", "two data", "data parity"])
def test_reads_after_osds_down_match_jax(written, pool, lost):
    clusters, objs = written
    for (opool, name), data in objs.items():
        if opool != pool:
            continue
        reads = []
        for c in clusters.values():
            io = c.open_ioctx(pool)
            acting, _primary = io.acting(io.object_pg(name))
            down = [acting[i] for i in lost]
            for osd in down:
                c.mark_osd_down(osd)
            reads.append(bytes(io.read(name)))
            for osd in down:
                c.mark_osd_up(osd)
        assert reads == [data, data], (name, lost)


@pytest.mark.parametrize("pool", PROFILES)
def test_scrub_and_repair_match_jax(written, pool):
    """A flipped byte in one shard and a removed shard: the same scrub
    verdicts, exact reads, the same repairs and stores, clean rescrubs."""
    clusters, objs = written
    name = f"{pool}-40000"
    verdicts = []
    for pkg, c in clusters.items():
        mod, oid_cls, txn_cls = NAMES[pkg]
        io = c.open_ioctx(pool)
        pg = io.object_pg(name)
        acting, _primary = io.acting(pg)
        oid = oid_cls(name)
        assert io.deep_scrub(name) == []
        store, cid = c.stores[acting[1]], mod.shard_collection(pg, 1)
        buf = bytearray(store.read(cid, oid))
        buf[77] ^= 0x5A
        t = txn_cls()
        t.write(cid, oid, 0, len(buf), bytes(buf))
        store.queue_transaction(t)
        t = txn_cls()
        t.remove(mod.shard_collection(pg, 3), oid)
        c.stores[acting[3]].queue_transaction(t)
        verdicts.append((io.deep_scrub(name), bytes(io.read(name)),
                         io.repair(name), io.deep_scrub(name),
                         bytes(io.read(name))))
    assert verdicts[0] == verdicts[1]
    scrub, read, repaired, rescrub, reread = verdicts[1]
    assert [s for s, _why in scrub] == [1, 3] and "crc" in scrub[0][1]
    assert read == reread == objs[pool, name]
    assert repaired == [1, 3] and rescrub == []
    assert _stores(clusters["port"]) == _stores(clusters["jax"])
