"""Embedded single-process RADOS: the end-to-end storage slice (port of
ceph_tpu/rados/embedded.py).

SURVEY.md §7 step 6 — every layer below the wire, in one process:
`put(obj)` hashes the name onto a PG (ceph_str_hash_rjenkins, the
hobject_t hash), CRUSH places the PG's acting set, the object stripes
through ECUtil, the card encodes all stripes in one batched GF matmul
(`gf_matmul_spec`), and each shard lands in its OSD's ObjectStore with
the cumulative-crc HashInfo ledger in an xattr (the hinfo_key of
ECBackend).  `get` reads any k shards — reconstructing through
minimum_to_decode + the decode kernel (`gf_matmul_gen`) when shards are
lost or fail their checksums.  Deep scrub re-hashes every shard against
its ledger (ECBackend::be_deep_scrub); repair re-encodes and rewrites bad
shards (RecoveryOp).

Every codec of a cluster runs on the cluster's device: CUDA unless the
caller names another (no CUDA and no device raises); `device="cpu"` runs
the kernels' plain versions.  The device is not part of the map: the
erasure-code profiles stored in the OSDMap, and its encoded bytes, are
those of the JAX package's cluster.  This module is the harness for
BASELINE config #5's object write shape.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.registry import create_erasure_code
from ceph_tpu_torch.ops import checksum as cks
from ceph_tpu_torch.ops.rjenkins import ceph_str_hash_rjenkins
from ceph_tpu_torch.os import ObjectId, ObjectStore, Transaction
from ceph_tpu_torch.os.memstore import MemStore
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.osdmap import (
    CEPH_OSD_UP,
    Incremental,
    OSDMap,
    PgId,
    TYPE_ERASURE,
    TYPE_REPLICATED,
)

OI_ATTR = "_"            # object_info_t xattr key
HINFO_ATTR = ec_util.HINFO_KEY
SS_ATTR = "snapset"      # SnapSet xattr key (SS_ATTR role)
STRIPE_UNIT = 4096       # osd_pool_erasure_code_stripe_unit's default


def shard_collection(pg: PgId, shard: int) -> str:
    """cid for a PG shard (spg_t: `<pool>.<ps>s<shard>_head`)."""
    return f"{pg.pool}.{pg.ps:x}s{shard}_head" if shard >= 0 else \
        f"{pg.pool}.{pg.ps:x}_head"


class LocalCluster:
    """N ObjectStores + an OSDMap, no networking."""

    def __init__(self, num_osds: int = 6, osds_per_host: int = 2,
                 store_path: Optional[str] = None, device=None):
        if store_path is not None:
            raise NotImplementedError(
                "store_path: the TPUStore-backed cluster (os/tpustore.py) is"
                " not ported yet (ROADMAP.md A4); the port's OSDs hold"
                " MemStores")
        self.device = resolve_device(device)
        self.osdmap = OSDMap.build_simple(num_osds,
                                          osds_per_host=osds_per_host)
        # the embedded cluster mutates its map only through
        # apply_incremental (mark_osd_down/up), so the per-epoch
        # placement memo is safe — and the open-loop load harness
        # issues enough ops that an uncached CRUSH walk per op would
        # measure the mapper, not the store
        self.osdmap.enable_placement_cache()
        self.stores: Dict[int, ObjectStore] = {}
        self._codecs: Dict[int, object] = {}
        for osd in range(num_osds):
            store: ObjectStore = MemStore()
            store.mkfs()
            store.mount()
            self.stores[osd] = store

    def shutdown(self) -> None:
        for store in self.stores.values():
            store.umount()

    # -- pool management ---------------------------------------------------

    def create_replicated_pool(self, name: str, size: int = 3,
                               pg_num: int = 32):
        return self.osdmap.create_pool(name, size=size, pg_num=pg_num)

    def create_erasure_pool(self, name: str, profile: Dict[str, str],
                            pg_num: int = 32,
                            profile_name: Optional[str] = None):
        """EC-profile flow of OSDMonitor.cc:7373-7712: store the profile in
        the map, build the codec, create its crush rule, create the pool."""
        profile = dict(profile)
        profile_name = profile_name or f"{name}_profile"
        codec = self._create_codec(profile)
        self.osdmap.erasure_code_profiles[profile_name] = profile
        ruleno = codec.create_rule(f"{name}_rule", self.osdmap.crush)
        assert ruleno >= 0
        pool = self.osdmap.create_pool(
            name, type_=TYPE_ERASURE, size=codec.get_chunk_count(),
            pg_num=pg_num, crush_rule=ruleno,
            erasure_code_profile=profile_name)
        self._codecs[pool.id] = codec
        return pool

    def _codec(self, pool_id: int):
        codec = self._codecs.get(pool_id)
        if codec is None:
            pool = self.osdmap.pools[pool_id]
            profile = self.osdmap.erasure_code_profiles[
                pool.erasure_code_profile]
            codec = self._create_codec(profile)
            self._codecs[pool_id] = codec
        return codec

    def _create_codec(self, profile: Dict[str, str]):
        """A codec on the cluster's device; the profile itself, as the map
        stores it, carries no device."""
        return create_erasure_code({**profile, "device": str(self.device)})

    def open_ioctx(self, pool_name: str) -> "IoCtx":
        pool_id = self.osdmap.lookup_pool(pool_name)
        if pool_id < 0:
            raise KeyError(f"no pool {pool_name!r}")
        return IoCtx(self, pool_id)

    # -- failure injection -------------------------------------------------

    def mark_osd_down(self, osd: int) -> None:
        inc = Incremental(epoch=self.osdmap.epoch + 1)
        inc.new_state[osd] = CEPH_OSD_UP
        self.osdmap.apply_incremental(inc)

    def mark_osd_up(self, osd: int) -> None:
        if self.osdmap.is_down(osd):
            inc = Incremental(epoch=self.osdmap.epoch + 1)
            inc.new_state[osd] = CEPH_OSD_UP
            self.osdmap.apply_incremental(inc)


class IoCtx:
    """librados::IoCtx shape over the embedded cluster."""

    def __init__(self, cluster: LocalCluster, pool_id: int):
        self.cluster = cluster
        self.pool_id = pool_id

    @property
    def pool(self):
        return self.cluster.osdmap.pools[self.pool_id]

    # -- placement ---------------------------------------------------------

    def object_pg(self, name: str) -> PgId:
        ps = ceph_str_hash_rjenkins(name.encode())
        return self.pool.raw_pg_to_pg(PgId(self.pool_id, ps))

    def acting(self, pg: PgId) -> Tuple[List[int], int]:
        return self.cluster.osdmap.pg_to_acting_osds(pg)

    # -- EC helpers --------------------------------------------------------

    def _sinfo(self, codec) -> ec_util.StripeInfo:
        k = codec.get_data_chunk_count()
        unit = codec.get_chunk_size(k * STRIPE_UNIT)
        return ec_util.StripeInfo(k, k * unit)

    # -- write -------------------------------------------------------------

    def write_full(self, name: str, data: bytes) -> None:
        pg = self.object_pg(name)
        acting, _primary = self.acting(pg)
        if self.pool.type == TYPE_REPLICATED:
            oi = json.dumps({"size": len(data)}).encode()
            for osd in acting:
                if osd == CRUSH_ITEM_NONE:
                    continue
                store = self.cluster.stores[osd]
                cid = shard_collection(pg, -1)
                t = Transaction()
                if not store.collection_exists(cid):
                    t.create_collection(cid)
                oid = ObjectId(name)
                t.truncate(cid, oid, 0)
                t.write(cid, oid, 0, len(data), data)
                t.setattr(cid, oid, OI_ATTR, oi)
                store.queue_transaction(t)
            return

        codec = self.cluster._codec(self.pool_id)
        sinfo = self._sinfo(codec)
        width = sinfo.get_stripe_width()
        padded = data + bytes(-len(data) % width)
        shards = ec_util.encode(sinfo, codec, padded,
                                range(codec.get_chunk_count()))
        hinfo = ec_util.HashInfo(codec.get_chunk_count())
        hinfo.append(0, shards)
        oi = json.dumps({"size": len(data)}).encode()
        hinfo_raw = json.dumps(hinfo.to_dict()).encode()
        for shard, osd in enumerate(acting):
            if osd == CRUSH_ITEM_NONE:
                continue
            store = self.cluster.stores[osd]
            cid = shard_collection(pg, shard)
            t = Transaction()
            if not store.collection_exists(cid):
                t.create_collection(cid)
            oid = ObjectId(name)
            t.truncate(cid, oid, 0)
            buf = shards.get(shard, b"")  # zero-length object: no chunks
            t.write(cid, oid, 0, len(buf), buf)
            t.setattr(cid, oid, OI_ATTR, oi)
            t.setattr(cid, oid, HINFO_ATTR, hinfo_raw)
            store.queue_transaction(t)

    # -- read --------------------------------------------------------------

    def _gather_shards(self, name: str, pg: PgId, acting: List[int],
                       verify: bool = True
                       ) -> Tuple[Dict[int, bytes], Optional[int], dict]:
        """Read every reachable shard; returns (shards, size, hinfo)."""
        shards: Dict[int, bytes] = {}
        size: Optional[int] = None
        hinfo: dict = {}
        for shard, osd in enumerate(acting):
            if osd == CRUSH_ITEM_NONE or \
                    self.cluster.osdmap.is_down(osd):
                continue
            store = self.cluster.stores[osd]
            cid = shard_collection(pg, shard)
            oid = ObjectId(name)
            try:
                buf = store.read(cid, oid)
                oi = json.loads(store.getattr(cid, oid, OI_ATTR))
                hi = json.loads(store.getattr(cid, oid, HINFO_ATTR))
            except (KeyError, IOError, ValueError):
                continue  # missing or failed csum -> treat as erasure
            if verify:
                # hinfo cumulative crc check (handle_sub_read,
                # ECBackend.cc:1010): shard bytes must match the ledger
                ledger = ec_util.HashInfo.from_dict(hi)
                if ledger.has_chunk_hash() and cks.crc32c(
                        0xFFFFFFFF, buf) != ledger.get_chunk_hash(shard):
                    continue  # corrupt shard -> erasure
            shards[shard] = buf
            size = oi["size"]
            hinfo = hi
        return shards, size, hinfo

    def read(self, name: str, offset: int = 0,
             length: int = 0) -> bytes:
        """Full read, or a ranged read when offset/length given
        (length 0 = to the end) — the librados read(off, len) shape
        the load harness's ranged-GET blend drives."""
        pg = self.object_pg(name)
        acting, _primary = self.acting(pg)
        if self.pool.type == TYPE_REPLICATED:
            for osd in acting:
                if osd == CRUSH_ITEM_NONE or \
                        self.cluster.osdmap.is_down(osd):
                    continue
                store = self.cluster.stores[osd]
                try:
                    cid = shard_collection(pg, -1)
                    data = store.read(cid, ObjectId(name))
                    oi = json.loads(store.getattr(cid, ObjectId(name),
                                                  OI_ATTR))
                    return self._slice(data[:oi["size"]], offset,
                                       length)
                except (KeyError, IOError):
                    continue
            raise KeyError(name)

        codec = self.cluster._codec(self.pool_id)
        sinfo = self._sinfo(codec)
        shards, size, _hinfo = self._gather_shards(name, pg, acting)
        if size is None:
            raise KeyError(name)
        k = codec.get_data_chunk_count()
        # data positions honor the chunk mapping
        # (get_want_to_read_shards, ECBackend.cc:2380)
        want = {codec.chunk_index(i) for i in range(k)}
        # plan the read like objects_read_and_reconstruct: which shards
        # do we need, given what's available?
        minimum = codec.minimum_to_decode(want, set(shards))
        use = {s: shards[s] for s in minimum if s in shards}
        data = ec_util.decode(sinfo, codec, use)
        return self._slice(data[:size], offset, length)

    @staticmethod
    def _slice(data: bytes, offset: int, length: int) -> bytes:
        if offset <= 0 and length <= 0:
            return data
        end = offset + length if length > 0 else len(data)
        return data[max(offset, 0):end]

    def stat(self, name: str) -> Dict[str, int]:
        pg = self.object_pg(name)
        acting, _primary = self.acting(pg)
        shard = -1 if self.pool.type == TYPE_REPLICATED else 0
        for s, osd in enumerate(acting):
            if osd == CRUSH_ITEM_NONE or self.cluster.osdmap.is_down(osd):
                continue
            cid = shard_collection(pg, shard if shard < 0 else s)
            try:
                oi = json.loads(self.cluster.stores[osd].getattr(
                    cid, ObjectId(name), OI_ATTR))
                return {"size": oi["size"]}
            except (KeyError, IOError):
                continue
        raise KeyError(name)

    def remove(self, name: str) -> None:
        pg = self.object_pg(name)
        acting, _primary = self.acting(pg)
        for shard, osd in enumerate(acting):
            if osd == CRUSH_ITEM_NONE:
                continue
            sh = -1 if self.pool.type == TYPE_REPLICATED else shard
            t = Transaction()
            t.remove(shard_collection(pg, sh), ObjectId(name))
            try:
                self.cluster.stores[osd].queue_transaction(t)
            except KeyError:
                pass

    def list_objects(self) -> List[str]:
        names = set()
        for pool_pg in range(self.pool.pg_num):
            pg = PgId(self.pool_id, pool_pg)
            acting, _p = self.acting(pg)
            for shard, osd in enumerate(acting):
                if osd == CRUSH_ITEM_NONE or \
                        self.cluster.osdmap.is_down(osd):
                    continue
                sh = -1 if self.pool.type == TYPE_REPLICATED else shard
                cid = shard_collection(pg, sh)
                store = self.cluster.stores[osd]
                if cid in store.list_collections():
                    names.update(str(o) for o in store.list_objects(cid))
        return sorted(names)

    # -- scrub / repair (be_deep_scrub + RecoveryOp) -----------------------

    def deep_scrub(self, name: str) -> List[Tuple[int, str]]:
        """Re-hash every shard against the hinfo ledger; returns
        [(shard, problem)] inconsistencies."""
        pg = self.object_pg(name)
        acting, _primary = self.acting(pg)
        problems: List[Tuple[int, str]] = []
        if self.pool.type == TYPE_REPLICATED:
            copies = {}
            for osd in acting:
                if osd == CRUSH_ITEM_NONE or \
                        self.cluster.osdmap.is_down(osd):
                    continue
                try:
                    copies[osd] = self.cluster.stores[osd].read(
                        shard_collection(pg, -1), ObjectId(name))
                except (KeyError, IOError) as e:
                    problems.append((osd, f"unreadable: {e}"))
            digests = {osd: cks.crc32c(0xFFFFFFFF, c)
                       for osd, c in copies.items()}
            if len(set(digests.values())) > 1:
                problems.append((-1, f"digest mismatch: {digests}"))
            return problems
        for shard, osd in enumerate(acting):
            if osd == CRUSH_ITEM_NONE or self.cluster.osdmap.is_down(osd):
                problems.append((shard, "shard unavailable"))
                continue
            store = self.cluster.stores[osd]
            cid = shard_collection(pg, shard)
            oid = ObjectId(name)
            try:
                buf = store.read(cid, oid)
                hi = ec_util.HashInfo.from_dict(
                    json.loads(store.getattr(cid, oid, HINFO_ATTR)))
            except (KeyError, IOError, ValueError) as e:
                problems.append((shard, f"unreadable: {e}"))
                continue
            if hi.has_chunk_hash() and cks.crc32c(
                    0xFFFFFFFF, buf) != hi.get_chunk_hash(shard):
                problems.append((shard, "hinfo crc mismatch"))
        return problems

    def repair(self, name: str) -> List[int]:
        """Reconstruct and rewrite bad/missing shards; returns repaired
        shard ids (the RecoveryOp role)."""
        pg = self.object_pg(name)
        acting, _primary = self.acting(pg)
        if self.pool.type == TYPE_REPLICATED:
            data = self.read(name)
            self.write_full(name, data)
            return []
        codec = self.cluster._codec(self.pool_id)
        sinfo = self._sinfo(codec)
        shards, size, hinfo = self._gather_shards(name, pg, acting)
        if size is None:
            raise KeyError(name)
        bad = [s for s, _p in self.deep_scrub(name)]
        data = ec_util.decode(
            sinfo, codec,
            {s: b for s, b in shards.items()})
        padded = data
        full = ec_util.encode(sinfo, codec, padded,
                              range(codec.get_chunk_count()))
        oi = json.dumps({"size": size}).encode()
        hinfo_raw = json.dumps(hinfo).encode()
        repaired = []
        for shard in bad:
            osd = acting[shard] if shard < len(acting) else CRUSH_ITEM_NONE
            if osd == CRUSH_ITEM_NONE or self.cluster.osdmap.is_down(osd):
                continue
            store = self.cluster.stores[osd]
            cid = shard_collection(pg, shard)
            t = Transaction()
            if not store.collection_exists(cid):
                t.create_collection(cid)
            oid = ObjectId(name)
            t.truncate(cid, oid, 0)
            t.write(cid, oid, 0, len(full[shard]), full[shard])
            t.setattr(cid, oid, OI_ATTR, oi)
            t.setattr(cid, oid, HINFO_ATTR, hinfo_raw)
            store.queue_transaction(t)
            repaired.append(shard)
        return repaired
