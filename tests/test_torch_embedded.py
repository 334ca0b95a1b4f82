"""The port's embedded cluster (ceph_tpu_torch.rados.embedded over
os/memstore, osd/osdmap and osd/ec_util) against the JAX package's, on the
CPU.

The same seeded workload runs on a JAX `LocalCluster` (profile
`plugin=jerasure`, so the `ec_jax` codec) and on a port
`LocalCluster(device="cpu")`, whose codecs run the GF kernels' plain
PyTorch versions.  Stores, shards, xattrs, reads and scrub verdicts are
bytes or integers, so the tolerance is exact equality throughout.  The
JAX tests of tests/test_embedded_rados.py are also replayed against the
port's names.
"""

import functools
import inspect
import types

import numpy as np
import pytest
import torch

import test_embedded_rados as jax_cases
from ceph_tpu.ec.interface import ErasureCodeError as JErasureCodeError
from ceph_tpu.os import ObjectId as JObjectId
from ceph_tpu.os import Transaction as JTransaction
from ceph_tpu.rados import embedded as jemb
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.os import ObjectId, Transaction
from ceph_tpu_torch.rados import embedded as temb

SEED = 20261017
SIZES = (0, 1, 4095, 4096, 100_000, 1 << 20)
PROFILES = {
    "ec42": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4",
             "m": "2", "crush-failure-domain": "host"},
    "ec83": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "8",
             "m": "3", "crush-failure-domain": "osd"},
}
POOLS = (*PROFILES, "repl")
NAMES = {"jax": (jemb, JObjectId, JTransaction),
         "port": (temb, ObjectId, Transaction)}


def _cluster(pkg: str):
    """12 OSDs on 6 hosts: RS 4+2 over hosts, RS 8+3 over OSDs, a size-3
    replicated pool; 16 PGs each."""
    if pkg == "jax":
        c = jemb.LocalCluster(num_osds=12, osds_per_host=2)
    else:
        c = temb.LocalCluster(num_osds=12, osds_per_host=2, device="cpu")
    for name, profile in PROFILES.items():
        c.create_erasure_pool(name, profile, pg_num=16)
    c.create_replicated_pool("repl", size=3, pg_num=16)
    return c


@pytest.fixture
def written():
    """Both clusters after the same seeded writes: every size into every
    pool -> ({"jax": cluster, "port": cluster}, {(pool, name): data})."""
    rng = np.random.default_rng(SEED)
    objs = {(pool, f"{pool}-{size}"): rng.bytes(size)
            for pool in POOLS for size in SIZES}
    clusters = {pkg: _cluster(pkg) for pkg in NAMES}
    for c in clusters.values():
        for (pool, name), data in objs.items():
            c.open_ioctx(pool).write_full(name, data)
    yield clusters, objs
    for c in clusters.values():
        c.shutdown()


def _stores(c):
    """{(osd, cid, oid): (bytes, xattrs)} of every object of every store."""
    out = {}
    for osd, store in c.stores.items():
        for cid in store.list_collections():
            for oid in store.list_objects(cid):
                out[osd, cid, str(oid)] = (store.read(cid, oid),
                                           store.getattrs(cid, oid))
    return out


def _both(written, fn):
    """fn(ioctx of a pool) on both clusters -> (jax, port)."""
    clusters, _objs = written
    return tuple(fn(lambda pool, c=c: c.open_ioctx(pool))
                 for c in clusters.values())


def _outcome(fn):
    """fn()'s bytes, or the name of the error it raised."""
    try:
        return bytes(fn())
    except (KeyError, ErasureCodeError, JErasureCodeError) as e:
        return type(e).__name__


def test_stores_hold_the_jax_bytes(written):
    clusters, objs = written
    jax_stores, port_stores = (_stores(c) for c in clusters.values())
    assert port_stores == jax_stores
    assert {attr for _data, attrs in port_stores.values()
            for attr in attrs} == {temb.OI_ATTR, temb.HINFO_ATTR}
    assert clusters["port"].osdmap.encode() == \
        clusters["jax"].osdmap.encode()
    for (pool, name), data in objs.items():
        io = clusters["port"].open_ioctx(pool)
        assert io.read(name) == data
        assert io.stat(name) == {"size": len(data)}


@pytest.mark.parametrize("pool", PROFILES)
@pytest.mark.parametrize("lost", ["none", "one", "m"])
def test_reads_after_osds_down_match_jax(written, pool, lost):
    """Each object read with none, one or m of its data shards' OSDs down
    (so the read decodes m data shards), then the OSDs marked up again."""
    clusters, objs = written
    m = int(PROFILES[pool]["m"])
    n_down = {"none": 0, "one": 1, "m": m}[lost]
    for (opool, name), data in objs.items():
        if opool != pool:
            continue
        reads = []
        for c in clusters.values():
            io = c.open_ioctx(pool)
            acting, _primary = io.acting(io.object_pg(name))
            for osd in acting[:n_down]:
                c.mark_osd_down(osd)
            reads.append(_outcome(lambda: io.read(name)))
            for osd in acting[:n_down]:
                c.mark_osd_up(osd)
        assert reads == [data, data], (name, lost)


def test_ranged_reads_match_jax(written):
    _clusters, objs = written
    ranges = [(0, 1), (1, 4095), (4095, 2), (100, 0), (12345, 50_000),
              (99_999, 10), (1 << 19, 4096), ((1 << 20) - 1, 1),
              (2 << 20, 5)]
    for (pool, name), data in objs.items():
        if len(data) not in (4095, 100_000, 1 << 20):
            continue
        for off, length in ranges:
            got = _both(written, lambda io: _outcome(
                lambda: io(pool).read(name, off, length)))
            end = off + length if length > 0 else len(data)
            want = data if off <= 0 and length <= 0 else data[off:end]
            assert got == (want, want), (name, off, length)


@pytest.mark.parametrize("pool", PROFILES)
def test_scrub_and_repair_match_jax(written, pool):
    """A flipped byte in one shard and a removed shard: the same deep
    scrub verdicts, reads still exact, the same repairs, the same stores
    after repair, and clean scrubs."""
    clusters, objs = written
    name, data = f"{pool}-{1 << 20}", objs[pool, f"{pool}-{1 << 20}"]
    verdicts = []
    for pkg, c in clusters.items():
        mod, oid_cls, txn_cls = NAMES[pkg]
        io = c.open_ioctx(pool)
        pg = io.object_pg(name)
        acting, _primary = io.acting(pg)
        oid = oid_cls(name)
        assert io.deep_scrub(name) == []
        store = c.stores[acting[1]]
        cid = mod.shard_collection(pg, 1)
        buf = bytearray(store.read(cid, oid))
        buf[777] ^= 0x5A
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
    assert read == reread == data and repaired == [1, 3] and rescrub == []
    jax_stores, port_stores = (_stores(c) for c in clusters.values())
    assert port_stores == jax_stores


def test_replicated_pool_matches_jax(written):
    clusters, objs = written
    name, data = "repl-100000", objs["repl", "repl-100000"]
    got = []
    for c in clusters.values():
        io = c.open_ioctx("repl")
        acting, _p = io.acting(io.object_pg(name))
        c.mark_osd_down(acting[0])
        got.append((bytes(io.read(name)), io.stat(name), io.deep_scrub(name),
                    io.repair(name)))
    assert got[0] == got[1] == (data, {"size": len(data)}, [], [])


def test_remove_and_list_match_jax(written):
    clusters, objs = written
    for pool in POOLS:
        for size in (1, 4096):
            for c in clusters.values():
                c.open_ioctx(pool).remove(f"{pool}-{size}")
        listed = _both(written, lambda io: io(pool).list_objects())
        assert listed[0] == listed[1] == sorted(
            n for (p, n) in objs if p == pool
            and n not in (f"{pool}-1", f"{pool}-4096"))
        gone = _both(written, lambda io: _outcome(
            lambda: io(pool).read(f"{pool}-1")))
        assert gone == ("KeyError", "KeyError")
    assert _stores(clusters["port"]) == _stores(clusters["jax"])


def test_tpustores_and_bitmatrix_pools(tmp_path):
    """Once refusals, both run now: a TPUStore-backed cluster's OSDs hold
    TPUStores on the cluster's device, and a pool of a bitmatrix
    technique (liberation) is created, written, read back healthy and
    with two shards' OSDs down, and holds the JAX cluster's stores."""
    c = temb.LocalCluster(num_osds=6, store_path=str(tmp_path), device="cpu")
    assert all(type(s).__name__ == "TPUStore" and s.device.type == "cpu"
               for s in c.stores.values())
    c.shutdown()
    profile = {"plugin": "jerasure", "technique": "liberation", "k": "4",
               "m": "2", "packetsize": "64", "crush-failure-domain": "osd"}
    rng = np.random.default_rng(SEED)
    objs = {f"lib-{size}": rng.bytes(size) for size in SIZES}
    clusters = {"jax": jemb.LocalCluster(num_osds=8, osds_per_host=2),
                "port": temb.LocalCluster(num_osds=8, osds_per_host=2,
                                          device="cpu")}
    for c in clusters.values():
        c.create_erasure_pool("libpool", dict(profile), pg_num=8)
        io = c.open_ioctx("libpool")
        for name, data in objs.items():
            io.write_full(name, data)
    try:
        assert _stores(clusters["port"]) == _stores(clusters["jax"])
        assert clusters["port"].osdmap.encode() == \
            clusters["jax"].osdmap.encode()
        name = f"lib-{1 << 20}"
        for c in clusters.values():
            io = c.open_ioctx("libpool")
            assert all(io.read(n) == d for n, d in objs.items())
            acting, _primary = io.acting(io.object_pg(name))
            for osd in acting[:2]:
                c.mark_osd_down(osd)
            assert bytes(io.read(name)) == objs[name]
    finally:
        for c in clusters.values():
            c.shutdown()


def test_profiles_in_the_map_carry_no_device():
    c = temb.LocalCluster(num_osds=8, osds_per_host=2, device="cpu")
    c.create_erasure_pool("ecpool", PROFILES["ec42"], pg_num=8)
    assert c.osdmap.erasure_code_profiles == {"ecpool_profile":
                                              PROFILES["ec42"]}
    codec = c._codec(c.osdmap.lookup_pool("ecpool"))
    assert codec.device.type == "cpu"


def test_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        temb.LocalCluster(num_osds=6)


# -- the JAX tests of tests/test_embedded_rados.py, replayed on the port ----

PORT_NAMES = {"ObjectId": ObjectId, "Transaction": Transaction,
              "HINFO_ATTR": temb.HINFO_ATTR,
              "LocalCluster": functools.partial(temb.LocalCluster,
                                                device="cpu"),
              "shard_collection": temb.shard_collection}
REPLAYED = sorted(name for name, fn in vars(jax_cases).items()
                  if name.startswith("test_") and callable(fn))


@pytest.mark.parametrize("name", REPLAYED)
def test_jax_embedded_case_on_the_port(name, tmp_path):
    fn = getattr(jax_cases, name)
    missing = {n for n in fn.__code__.co_names if n in vars(jemb) and not
               isinstance(vars(jemb)[n], types.ModuleType)} - set(PORT_NAMES)
    assert not missing, missing
    fn = types.FunctionType(fn.__code__, {**fn.__globals__, **PORT_NAMES},
                            fn.__name__, fn.__defaults__, fn.__closure__)
    kwargs = {}
    if "tmp_path" in inspect.signature(fn).parameters:
        kwargs["tmp_path"] = tmp_path
    if "cluster" in inspect.signature(fn).parameters:
        # the `cluster` fixture of tests/test_embedded_rados.py, on the port
        c = temb.LocalCluster(num_osds=8, osds_per_host=2, device="cpu")
        c.create_erasure_pool("ecpool", jax_cases.EC_PROFILE, pg_num=16)
        c.create_replicated_pool("repl", size=3, pg_num=16)
        kwargs["cluster"] = c
    fn(**kwargs)
