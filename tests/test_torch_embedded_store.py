"""The port's store-backed cluster (`LocalCluster(store_path=...)`, one
TPUStore per OSD) against the JAX package's, on the CPU.

The same seeded workload runs on a JAX `LocalCluster(store_path=...)` and
on a port `LocalCluster(store_path=..., device="cpu")`: RS 4+2 over hosts,
RS 8+3 over OSDs and a size-3 replicated pool, once with the stores'
defaults and once with a `config` that compresses (lz4, aggressive) and
sets an 8 KiB EC stripe unit.  Every store's objects, xattrs (object info
and the hinfo ledger), block file and KV contents but its fsid, the reads
after losses, the deep-scrub verdicts and the repairs are bytes or
integers: the tolerance is exact equality throughout.  The stores are then
unmounted, mounted again on the same directories and read back.
"""

import numpy as np
import pytest

from ceph_tpu.common.config import Config as JConfig
from ceph_tpu.os import ObjectId as JObjectId
from ceph_tpu.os import Transaction as JTransaction
from ceph_tpu.os.tpustore import TPUStore as JTPUStore
from ceph_tpu.rados import embedded as jemb
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.os import ObjectId, Transaction
from ceph_tpu_torch.os.tpustore import TPUStore
from ceph_tpu_torch.rados import embedded as temb

SEED = 20261017
SIZES = (0, 1, 4095, 100_000, 400_000)
BIG = SIZES[-1]          # the scrub test's object: two blobs per RS 4+2 shard
PROFILES = {
    "ec42": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4",
             "m": "2", "crush-failure-domain": "host"},
    "ec83": {"plugin": "jerasure", "technique": "reed_sol_van", "k": "8",
             "m": "3", "crush-failure-domain": "osd"},
}
POOLS = (*PROFILES, "repl")
CONFIGS = {"defaults": {},
           "compressed": {"bluestore_compression_mode": "aggressive",
                          "bluestore_compression_algorithm": "lz4",
                          "osd_pool_erasure_code_stripe_unit": 8192}}
PKGS = {"jax": (jemb, JObjectId, JTransaction, JConfig, JTPUStore, {}),
        "port": (temb, ObjectId, Transaction, Config, TPUStore,
                 {"device": "cpu"})}


def _config(pkg, opts):
    if not opts:
        return None
    cfg = PKGS[pkg][3]()
    for name, value in opts.items():
        cfg.set_val(name, value)
    return cfg


def _payload(size, rng):
    """Half text, half random bytes: some spans compress, some do not."""
    text = b"".join(rng.choice([b"rados ", b"object ", b"shard "],
                               size // 10 + 1))
    return (text[:size // 2] + rng.bytes(size))[:size]


@pytest.fixture(params=CONFIGS)
def written(request, tmp_path):
    """Both clusters after the same seeded writes: every size into every
    pool -> ({"jax": cluster, "port": cluster}, {(pool, name): data},
    config name)."""
    rng = np.random.default_rng(SEED)
    objs = {(pool, f"{pool}-{size}"): _payload(size, rng)
            for pool in POOLS for size in SIZES}
    clusters = {}
    for pkg, (mod, *_rest, kw) in PKGS.items():
        c = mod.LocalCluster(num_osds=12, osds_per_host=2,
                             store_path=str(tmp_path / pkg),
                             config=_config(pkg, CONFIGS[request.param]),
                             **kw)
        for name, profile in PROFILES.items():
            c.create_erasure_pool(name, profile, pg_num=16)
        c.create_replicated_pool("repl", size=3, pg_num=16)
        for (pool, name), data in objs.items():
            c.open_ioctx(pool).write_full(name, data)
        clusters[pkg] = c
    yield clusters, objs, request.param
    for c in clusters.values():
        c.shutdown()


def _stores(c):
    """{osd: (objects, KV contents but the fsid, block file)}."""
    out = {}
    for osd, store in c.stores.items():
        objs = {}
        for cid in store.list_collections():
            for oid in store.list_objects(cid):
                objs[cid, str(oid)] = (store.read(cid, oid),
                                       store.getattrs(cid, oid))
        kv = {prefix: [(k, v) for k, v in store._kv.get_iterator(prefix)
                       if (prefix, k) != ("S", b"fsid")]
              for prefix in "SOMFD"}
        store._block.flush()
        with open(store._block_path, "rb") as f:
            out[osd] = (objs, kv, f.read())
    return out


def _outcome(fn):
    try:
        return bytes(fn())
    except (KeyError, IOError) as e:
        return type(e).__name__


def test_stores_hold_the_jax_bytes(written):
    clusters, objs, config = written
    port, jax = (_stores(c) for c in (clusters["port"], clusters["jax"]))
    assert port == jax
    assert all(isinstance(s, TPUStore) and s.device.type == "cpu"
               for s in clusters["port"].stores.values())
    assert clusters["port"]._stripe_unit == (8192 if config == "compressed"
                                            else temb.STRIPE_UNIT)
    compressed = {b.comp_alg is not None
                  for s in clusters["port"].stores.values()
                  for cid in s.list_collections()
                  for oid in s.list_objects(cid)
                  for b in s._get_onode(cid, oid).blobs.values()}
    assert compressed == ({False, True} if config == "compressed"
                          else {False})
    for (pool, name), data in objs.items():
        io = clusters["port"].open_ioctx(pool)
        assert io.read(name) == data
        assert io.stat(name) == {"size": len(data)}


@pytest.mark.parametrize("pool", PROFILES)
@pytest.mark.parametrize("lost", ["one", "m"])
def test_reads_after_osds_down_match_jax(written, pool, lost):
    clusters, objs, _config_name = written
    n_down = {"one": 1, "m": int(PROFILES[pool]["m"])}[lost]
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


@pytest.mark.parametrize("pool", PROFILES)
def test_scrub_and_repair_match_jax(written, pool):
    """A flipped byte in one shard's block file (the store's csum catches
    it) and a removed shard: the same scrub verdicts, exact reads, the same
    repairs and stores."""
    clusters, objs, _config_name = written
    name, data = f"{pool}-{BIG}", objs[pool, f"{pool}-{BIG}"]
    verdicts = []
    for pkg, c in clusters.items():
        mod, oid_cls, txn_cls, *_rest = PKGS[pkg]
        io = c.open_ioctx(pool)
        pg = io.object_pg(name)
        acting, _primary = io.acting(pg)
        oid = oid_cls(name)
        assert io.deep_scrub(name) == []
        store = c.stores[acting[1]]
        blob = store._get_onode(mod.shard_collection(pg, 1), oid).blobs[0]
        store._block.flush()
        with open(store._block_path, "r+b") as f:
            f.seek(blob.offset + 777)
            b = f.read(1)
            f.seek(blob.offset + 777)
            f.write(bytes([b[0] ^ 0x5A]))
        t = txn_cls()
        t.remove(mod.shard_collection(pg, 3), oid)
        c.stores[acting[3]].queue_transaction(t)
        verdicts.append((io.deep_scrub(name), bytes(io.read(name)),
                         io.repair(name), io.deep_scrub(name),
                         bytes(io.read(name)),
                         store.perf_counters()["csum_read_failures"]))
    assert verdicts[0] == verdicts[1]
    scrub, read, repaired, rescrub, reread, failures = verdicts[1]
    assert [s for s, _why in scrub] == [1, 3]
    assert read == reread == data and repaired == [1, 3] and rescrub == []
    assert failures >= 1
    assert _stores(clusters["port"]) == _stores(clusters["jax"])


def test_remount_round_trip(written, tmp_path):
    """shutdown(), then every OSD's store mounted again on its directory:
    the same objects read back, in both packages, and the stores are still
    each other's twins."""
    clusters, objs, config = written
    for pkg, c in clusters.items():
        _mod, _oid, _txn, _cfg, store_cls, kw = PKGS[pkg]
        fsids = {osd: s.fsid for osd, s in c.stores.items()}
        c.shutdown()
        for osd in c.stores:
            s = store_cls(f"{tmp_path / pkg}/osd.{osd}",
                          config=_config(pkg, CONFIGS[config]), **kw)
            s.mount()
            assert s.fsid == fsids[osd]
            c.stores[osd] = s
        for (pool, name), data in objs.items():
            assert c.open_ioctx(pool).read(name) == data, (pkg, name)
    assert _stores(clusters["port"]) == _stores(clusters["jax"])
