"""OSDMap: the epoch-versioned cluster map (port of ceph_tpu/osd/osdmap.py).

Reference parity: OSDMap (the reference's src/osd/OSDMap.{h,cc}) and
pg_pool_t (src/osd/osd_types.{h,cc}):

- pools carry type (replicated/erasure), size/min_size, pg_num/pgp_num
  with the stable-mod masks, crush rule, and an erasure-code-profile name;
  EC profiles are cluster data stored in the map (SURVEY.md §5.6);
- placement: raw_pg_to_pps (hashpspool mixing, osd_types.cc:1793) ->
  crush do_rule with the in/out weight vector (OSDMap.cc:2436-2454) ->
  upmap overrides -> up filtering (shift for replicated, NONE-holes for
  EC) -> primary affinity -> pg_temp/primary_temp overrides
  (_pg_to_up_acting_osds, OSDMap.cc:2668);
- Incremental: per-epoch deltas (new_state is XOR), applied in order;
- OSDMapMapping: whole-map bulk placement — the pps of every PG of a pool
  go through one launch of the CUDA placement kernel
  (ceph_tpu_torch.ops.crush_kernels) per (rule, size) (the
  ParallelPGMapper role, src/osd/OSDMapMapping.h:18,173).

`OSDMap.encode` writes the bytes the JAX package's OSDMap writes for the
same map, and each package decodes the other's.
"""

from __future__ import annotations

import hashlib
import json
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.crush import kernel as crush_kernel
from ceph_tpu_torch.crush import mapper as crush_mapper
from ceph_tpu_torch.crush.map import (CRUSH_ITEM_NONE, CrushMap,
                                     build_flat_cluster)
from ceph_tpu_torch.crush.serialize import from_json, to_json
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ops import rjenkins

log = logging.getLogger("ceph_tpu_torch.osdmap")

# osd state bits (ceph_osd_state)
CEPH_OSD_EXISTS = 1
CEPH_OSD_UP = 2
CEPH_OSD_DESTROYED = 4

CEPH_OSD_IN = 0x10000
CEPH_OSD_OUT = 0
CEPH_OSD_MAX_PRIMARY_AFFINITY = 0x10000
CEPH_OSD_DEFAULT_PRIMARY_AFFINITY = 0x10000

# pool types (pg_pool_t)
TYPE_REPLICATED = 1
TYPE_ERASURE = 3

# pg_pool_t flags
FLAG_HASHPSPOOL = 1 << 2

# raw CRUSH placements of every cache-enabled map in the process, keyed
# on everything crush_do_rule reads: the crush map's digest, the in/out
# weights, the rule, the pps and the size.  The daemons and clients of
# one cluster in one process hold equal maps, so a map epoch places each
# PG once instead of once a map; epochs that change neither the crush map
# nor the weights (pool snaps, downs, boots) place nothing anew.
_RAW_MEMO: Dict[Tuple, Tuple[int, ...]] = {}
_RAW_MEMO_MAX = 1 << 17

# cluster flags (OSDMap CEPH_OSDMAP_*)
FLAG_NAMES = {
    "pauserd": 1 << 0, "pausewr": 1 << 1, "noup": 1 << 5,
    "nodown": 1 << 6, "noout": 1 << 7, "noin": 1 << 8,
    "nobackfill": 1 << 9, "norebalance": 1 << 18, "norecover": 1 << 10,
    "noscrub": 1 << 11, "nodeep-scrub": 1 << 12,
}


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """Stable modulo for smooth pg_num growth (include/ceph_hash-adjacent)."""
    return x & bmask if (x & bmask) < b else x & (bmask >> 1)


def _calc_mask(n: int) -> int:
    return (1 << max(n - 1, 1).bit_length()) - 1


@dataclass(frozen=True)
class PgId:
    """pg_t: (pool, seed)."""

    pool: int
    ps: int

    def __str__(self) -> str:
        return f"{self.pool}.{self.ps:x}"

    @staticmethod
    def parse(s: str) -> "PgId":
        pool_s, ps_s = s.split(".")
        return PgId(int(pool_s), int(ps_s, 16))


class PgPool:
    def __init__(self, pool_id: int, name: str,
                 type_: int = TYPE_REPLICATED, size: int = 3,
                 min_size: int = 0, pg_num: int = 32,
                 crush_rule: int = 0, erasure_code_profile: str = "",
                 flags: int = FLAG_HASHPSPOOL):
        self.id = pool_id
        self.name = name
        self.type = type_
        self.size = size
        # reference defaults: replicated size - size/2; EC pools get k+1
        # from the profile at creation (OSDMap.create_pool does that)
        self.min_size = min_size or max(size - size // 2, 1)
        self.pg_num = pg_num
        self.pgp_num = pg_num
        self.crush_rule = crush_rule
        self.erasure_code_profile = erasure_code_profile
        self.flags = flags
        self.opts: Dict[str, object] = {}  # pool_opts_t (csum/compression)
        self.last_change = 0
        # self-managed snapshots (pg_pool_t snap_seq / removed_snaps):
        # snap ids are allocated by the mon from snap_seq; removed ids
        # accumulate until every OSD has trimmed them
        self.snap_seq = 0
        self.removed_snaps: List[int] = []

    @property
    def pg_num_mask(self) -> int:
        return _calc_mask(self.pg_num)

    @property
    def pgp_num_mask(self) -> int:
        return _calc_mask(self.pgp_num)

    def can_shift_osds(self) -> bool:
        return self.type == TYPE_REPLICATED

    def is_erasure(self) -> bool:
        return self.type == TYPE_ERASURE

    def raw_pg_to_pg(self, pg: PgId) -> PgId:
        return PgId(pg.pool,
                    ceph_stable_mod(pg.ps, self.pg_num, self.pg_num_mask))

    def raw_pg_to_pps(self, pg: PgId) -> int:
        if self.flags & FLAG_HASHPSPOOL:
            return int(rjenkins.hash32_2(
                ceph_stable_mod(pg.ps, self.pgp_num, self.pgp_num_mask),
                pg.pool))
        return ceph_stable_mod(
            pg.ps, self.pgp_num, self.pgp_num_mask) + pg.pool

    def all_pps(self) -> np.ndarray:
        """raw_pg_to_pps of every PG of the pool, ps = 0 .. pg_num - 1, as
        an int64 array (ceph_stable_mod and hash32_2 on numpy arrays)."""
        ps = np.arange(self.pg_num, dtype=np.int64)
        mask = self.pgp_num_mask
        folded = np.where((ps & mask) < self.pgp_num, ps & mask,
                          ps & (mask >> 1))
        if self.flags & FLAG_HASHPSPOOL:
            return rjenkins.hash32_2(folded, self.id).astype(np.int64)
        return folded + self.id

    # -- encoding ----------------------------------------------------------

    def encode(self, enc: Encoder) -> None:
        # v2 changes the meaning of opts values (str -> JSON), so compat
        # is 2 as well: a v1-only decoder must reject, not misread.
        # v3 appends snap_seq/removed_snaps (readable by v2 logic? no —
        # appended fields are version-gated below, compat stays 2).
        enc.start(3, 2)
        enc.s64(self.id)
        enc.string(self.name)
        enc.u8(self.type)
        enc.u32(self.size)
        enc.u32(self.min_size)
        enc.u32(self.pg_num)
        enc.u32(self.pgp_num)
        enc.s32(self.crush_rule)
        enc.string(self.erasure_code_profile)
        enc.u64(self.flags)
        enc.u32(self.last_change)
        # JSON-encode opt values so typed pool opts (ints/floats for
        # csum/compression settings) survive an encode/decode round-trip
        enc.map(self.opts, Encoder.string,
                lambda e, v: e.string(json.dumps(v)))
        enc.u64(self.snap_seq)
        enc.list(self.removed_snaps, Encoder.u64)
        enc.finish()

    @classmethod
    def decode(cls, dec: Decoder) -> "PgPool":
        struct_v = dec.start(3)
        pool = cls(dec.s64(), dec.string())
        pool.type = dec.u8()
        pool.size = dec.u32()
        pool.min_size = dec.u32()
        pool.pg_num = dec.u32()
        pool.pgp_num = dec.u32()
        pool.crush_rule = dec.s32()
        pool.erasure_code_profile = dec.string()
        pool.flags = dec.u64()
        pool.last_change = dec.u32()
        raw_opts = dec.map(Decoder.string, Decoder.string)
        if struct_v >= 2:
            pool.opts = {k: json.loads(v) for k, v in raw_opts.items()}
        else:  # v1 encoded opts as bare str(v); values stay strings
            pool.opts = raw_opts
        if struct_v >= 3:
            pool.snap_seq = dec.u64()
            pool.removed_snaps = dec.list(Decoder.u64)
        dec.finish()
        return pool


class OSDMap:
    def __init__(self) -> None:
        self.epoch = 0
        self.fsid = ""
        self.max_osd = 0
        self.osd_state: List[int] = []
        self.osd_weight: List[int] = []          # 16.16 in/out weight
        self.osd_addrs: Dict[int, str] = {}
        self.osd_primary_affinity: Optional[List[int]] = None
        self.pools: Dict[int, PgPool] = {}
        self.crush = CrushMap()
        self.erasure_code_profiles: Dict[str, Dict[str, str]] = {}
        self.flags = 0
        self.pg_temp: Dict[PgId, List[int]] = {}
        self.primary_temp: Dict[PgId, int] = {}
        self.pg_upmap: Dict[PgId, List[int]] = {}
        self.pg_upmap_items: Dict[PgId, List[Tuple[int, int]]] = {}
        self.pool_max = 0  # monotone pool-id counter; ids never reused
        # placement memo (the OSDMapMapping precompute role,
        # the reference's src/osd/OSDMapMapping.h:18 — it
        # caches every PG's mapping per epoch).  OPT-IN: off on a raw
        # map (tests and tools freely poke osd_state/pg_temp between
        # queries); daemons and clients that mutate their map ONLY
        # through apply_incremental / whole-map install set
        # enable_placement_cache() after each map change.  Entries
        # key on (epoch, pg) and the store resets on epoch change.
        self._cache_placement = False
        self._pcache: Dict[PgId, Tuple] = {}
        self._pcache_epoch = -1
        self._crush_digest: Optional[Tuple] = None  # (epoch, crush, digest)

    def enable_placement_cache(self) -> None:
        """Owner promises mutation-through-incrementals (or whole-map
        install) from here on — daemons/clients call this after every
        map change; raw maps in tools/tests stay uncached so direct
        state surgery between queries stays safe."""
        self._cache_placement = True

    def _invalidate_placement(self) -> None:
        self._pcache.clear()
        self._pcache_epoch = self.epoch

    # -- osd state ---------------------------------------------------------

    def set_max_osd(self, n: int) -> None:
        self._invalidate_placement()
        self.max_osd = n
        while len(self.osd_state) < n:
            self.osd_state.append(0)
            self.osd_weight.append(CEPH_OSD_OUT)

    def exists(self, osd: int) -> bool:
        return (0 <= osd < self.max_osd
                and self.osd_state[osd] & CEPH_OSD_EXISTS != 0)

    def is_up(self, osd: int) -> bool:
        return self.exists(osd) and self.osd_state[osd] & CEPH_OSD_UP != 0

    def is_down(self, osd: int) -> bool:
        return not self.is_up(osd)

    def is_destroyed(self, osd: int) -> bool:
        """Data declared permanently gone (`osd lost` / destroy —
        OSDMap.h is_destroyed): probes may treat this OSD as
        definitively absent rather than merely unreachable."""
        return (self.exists(osd)
                and self.osd_state[osd] & CEPH_OSD_DESTROYED != 0)

    def is_in(self, osd: int) -> bool:
        return self.exists(osd) and self.osd_weight[osd] > 0

    def is_out(self, osd: int) -> bool:
        return not self.is_in(osd)

    def get_weight(self, osd: int) -> int:
        return self.osd_weight[osd]

    def get_up_osds(self) -> List[int]:
        return [o for o in range(self.max_osd) if self.is_up(o)]

    def get_primary_affinity(self, osd: int) -> int:
        if self.osd_primary_affinity is None:
            return CEPH_OSD_DEFAULT_PRIMARY_AFFINITY
        return self.osd_primary_affinity[osd]

    def test_flag(self, name: str) -> bool:
        return bool(self.flags & FLAG_NAMES[name])

    # -- pools ---------------------------------------------------------------

    def lookup_pool(self, name: str) -> int:
        for pid, pool in self.pools.items():
            if pool.name == name:
                return pid
        return -1

    def get_pg_pool(self, pool_id: int) -> Optional[PgPool]:
        return self.pools.get(pool_id)

    # -- placement (OSDMap.cc:2436-2750) -------------------------------------

    def _find_rule(self, pool: PgPool) -> int:
        return (pool.crush_rule
                if 0 <= pool.crush_rule < len(self.crush.rules) else -1)

    def _pg_to_raw_osds(self, pool: PgPool, pg: PgId
                        ) -> Tuple[List[int], int]:
        pps = pool.raw_pg_to_pps(pg)
        ruleno = self._find_rule(pool)
        raw: List[int] = []
        if ruleno >= 0 and self._cache_placement:
            key = (self._crush_token(), tuple(self.osd_weight), ruleno,
                   pps, pool.size)
            hit = _RAW_MEMO.get(key)
            if hit is None:
                hit = tuple(crush_mapper.crush_do_rule(
                    self.crush, ruleno, pps, pool.size, self.osd_weight,
                    self.crush.choose_args or None))
                if len(_RAW_MEMO) >= _RAW_MEMO_MAX:
                    _RAW_MEMO.clear()
                _RAW_MEMO[key] = hit
            raw = list(hit)
        elif ruleno >= 0:
            raw = list(crush_mapper.crush_do_rule(
                self.crush, ruleno, pps, pool.size, self.osd_weight,
                self.crush.choose_args or None))
        self._remove_nonexistent(pool, raw)
        return raw, pps

    def _crush_token(self) -> bytes:
        """The crush map's digest, taken once an epoch (and again if the
        map was swapped for another object)."""
        held = self._crush_digest
        if held is None or held[0] != self.epoch or held[1] is not self.crush:
            text = json.dumps(to_json(self.crush), sort_keys=True)
            held = (self.epoch, self.crush, hashlib.blake2b(
                text.encode(), digest_size=16).digest())
            self._crush_digest = held
        return held[2]

    def _remove_nonexistent(self, pool: PgPool, osds: List[int]) -> None:
        if pool.can_shift_osds():
            osds[:] = [o for o in osds if self.exists(o)]
        else:
            osds[:] = [o if self.exists(o) else CRUSH_ITEM_NONE
                       for o in osds]

    def _apply_upmap(self, pool: PgPool, raw_pg: PgId,
                     raw: List[int]) -> None:
        pg = pool.raw_pg_to_pg(raw_pg)
        explicit = self.pg_upmap.get(pg)
        if explicit is not None:
            if any(o != CRUSH_ITEM_NONE and 0 <= o < self.max_osd
                   and self.osd_weight[o] == 0 for o in explicit):
                # a marked-out target rejects the whole explicit mapping
                # AND short-circuits pg_upmap_items
                # (OSDMap::_apply_upmap early return, OSDMap.cc:2466-2476)
                return
            raw[:] = list(explicit)
            # applied mapping falls through to pg_upmap_items
            # (OSDMap.cc:2478-2481 "continue to check and apply")
        for src, dst in self.pg_upmap_items.get(pg, []):
            exists = False
            pos = -1
            for i, osd in enumerate(raw):
                if osd == dst:
                    exists = True
                    break
                if osd == src and pos < 0 and not (
                        dst != CRUSH_ITEM_NONE and 0 <= dst < self.max_osd
                        and self.osd_weight[dst] == 0):
                    pos = i
            if not exists and pos >= 0:
                raw[pos] = dst

    def _raw_to_up(self, pool: PgPool, raw: List[int]) -> List[int]:
        if pool.can_shift_osds():
            return [o for o in raw if self.exists(o) and self.is_up(o)]
        return [o if (o != CRUSH_ITEM_NONE and self.exists(o)
                      and self.is_up(o)) else CRUSH_ITEM_NONE
                for o in raw]

    @staticmethod
    def _pick_primary(osds: List[int]) -> int:
        for o in osds:
            if o != CRUSH_ITEM_NONE:
                return o
        return -1

    def _apply_primary_affinity(self, seed: int, pool: PgPool,
                                osds: List[int], primary: int
                                ) -> Tuple[List[int], int]:
        pa = self.osd_primary_affinity
        if pa is None:
            return osds, primary
        if all(o == CRUSH_ITEM_NONE
               or pa[o] == CEPH_OSD_DEFAULT_PRIMARY_AFFINITY
               for o in osds):
            return osds, primary
        pos = -1
        for i, o in enumerate(osds):
            if o == CRUSH_ITEM_NONE:
                continue
            a = pa[o]
            if a < CEPH_OSD_MAX_PRIMARY_AFFINITY and (
                    int(rjenkins.hash32_2(seed, o)) >> 16) >= a:
                if pos < 0:
                    pos = i  # fallback; keep looking
            else:
                pos = i
                break
        if pos < 0:
            return osds, primary
        primary = osds[pos]
        if pool.can_shift_osds() and pos > 0:
            osds = [osds[pos]] + osds[:pos] + osds[pos + 1:]
        return osds, primary

    def _get_temp_osds(self, pool: PgPool, raw_pg: PgId
                       ) -> Tuple[List[int], int]:
        pg = pool.raw_pg_to_pg(raw_pg)
        temp: List[int] = []
        for o in self.pg_temp.get(pg, []):
            if not self.exists(o) or self.is_down(o):
                if not pool.can_shift_osds():
                    temp.append(CRUSH_ITEM_NONE)
            else:
                temp.append(o)
        temp_primary = self.primary_temp.get(pg, -1)
        if temp_primary == -1 and temp:
            temp_primary = self._pick_primary(temp)
        return temp, temp_primary

    def pg_to_up_acting_osds(self, pg: PgId
                             ) -> Tuple[List[int], int, List[int], int]:
        """-> (up, up_primary, acting, acting_primary)."""
        if not self._cache_placement:
            return self._pg_to_up_acting_uncached(pg)
        if self._pcache_epoch != self.epoch:
            self._invalidate_placement()
        hit = self._pcache.get(pg)
        if hit is not None:
            up, upp, acting, actp = hit
            return list(up), upp, list(acting), actp
        out = self._pg_to_up_acting_uncached(pg)
        self._pcache[pg] = (tuple(out[0]), out[1], tuple(out[2]), out[3])
        return out

    def _pg_to_up_acting_uncached(self, pg: PgId
                                  ) -> Tuple[List[int], int, List[int], int]:
        pool = self.get_pg_pool(pg.pool)
        if pool is None or pg.ps >= pool.pg_num:
            return [], -1, [], -1
        acting, acting_primary = self._get_temp_osds(pool, pg)
        raw, pps = self._pg_to_raw_osds(pool, pg)
        self._apply_upmap(pool, pg, raw)
        up = self._raw_to_up(pool, raw)
        up_primary = self._pick_primary(up)
        up, up_primary = self._apply_primary_affinity(
            pps, pool, up, up_primary)
        if not acting:
            acting = list(up)
            if acting_primary == -1:
                acting_primary = up_primary
        return up, up_primary, acting, acting_primary

    def pg_to_acting_osds(self, pg: PgId) -> Tuple[List[int], int]:
        _up, _upp, acting, primary = self.pg_to_up_acting_osds(pg)
        return acting, primary

    # -- map building ------------------------------------------------------

    @classmethod
    def build_simple(cls, num_osds: int, osds_per_host: int = 4,
                     epoch: int = 1, fsid: str = "tpu-fsid") -> "OSDMap":
        m = cls()
        m.epoch = epoch
        m.fsid = fsid
        m.crush = build_flat_cluster(num_osds, osds_per_host=osds_per_host)
        m.set_max_osd(num_osds)
        for o in range(num_osds):
            m.osd_state[o] = CEPH_OSD_EXISTS | CEPH_OSD_UP
            m.osd_weight[o] = CEPH_OSD_IN
        if not m.crush.rules:
            m.crush.add_simple_rule("replicated_rule", "default", "host")
        return m

    def create_pool(self, name: str, type_: int = TYPE_REPLICATED,
                    size: int = 3, pg_num: int = 32, crush_rule: int = 0,
                    erasure_code_profile: str = "") -> PgPool:
        pool_id = max(self.pool_max, max(self.pools, default=0)) + 1
        self.pool_max = pool_id
        min_size = 0
        if type_ == TYPE_ERASURE:
            profile = self.erasure_code_profiles.get(
                erasure_code_profile, {})
            min_size = int(profile.get("k", max(size - 1, 1))) + 1
        pool = PgPool(pool_id, name, type_=type_, size=size,
                      min_size=min_size, pg_num=pg_num,
                      crush_rule=crush_rule,
                      erasure_code_profile=erasure_code_profile)
        pool.last_change = self.epoch
        self.pools[pool_id] = pool
        self._invalidate_placement()
        return pool

    # -- incrementals (OSDMap::Incremental) --------------------------------

    def apply_incremental(self, inc: "Incremental") -> None:
        assert inc.epoch == self.epoch + 1, \
            f"incremental {inc.epoch} does not follow {self.epoch}"
        self.epoch = inc.epoch
        if inc.new_max_osd is not None:
            self.set_max_osd(inc.new_max_osd)
        if inc.new_flags is not None:
            self.flags = inc.new_flags
        for name, profile in inc.new_erasure_code_profiles.items():
            self.erasure_code_profiles[name] = dict(profile)
        for name in inc.old_erasure_code_profiles:
            self.erasure_code_profiles.pop(name, None)
        for pool_id, pool in inc.new_pools.items():
            self.pools[pool_id] = pool
        for pool_id in inc.old_pools:
            self.pools.pop(pool_id, None)
            for d in (self.pg_temp, self.primary_temp, self.pg_upmap,
                      self.pg_upmap_items):
                for pg in [pg for pg in d if pg.pool == pool_id]:
                    del d[pg]
        for osd, addr in inc.new_up_osds.items():
            self.osd_state[osd] |= CEPH_OSD_EXISTS | CEPH_OSD_UP
            self.osd_addrs[osd] = addr
        for osd, xor_bits in inc.new_state.items():
            self.osd_state[osd] ^= xor_bits
        for osd, weight in inc.new_weight.items():
            self.osd_state[osd] |= CEPH_OSD_EXISTS
            self.osd_weight[osd] = weight
        for pg, osds in inc.new_pg_temp.items():
            if osds:
                self.pg_temp[pg] = list(osds)
            else:
                self.pg_temp.pop(pg, None)
        for pg, primary in inc.new_primary_temp.items():
            if primary >= 0:
                self.primary_temp[pg] = primary
            else:
                self.primary_temp.pop(pg, None)
        for pg, osds in inc.new_pg_upmap.items():
            self.pg_upmap[pg] = list(osds)
        for pg in inc.old_pg_upmap:
            self.pg_upmap.pop(pg, None)
        for pg, items in inc.new_pg_upmap_items.items():
            self.pg_upmap_items[pg] = list(items)
        for pg in inc.old_pg_upmap_items:
            self.pg_upmap_items.pop(pg, None)
        if inc.new_crush is not None:
            self.crush = inc.new_crush

    # -- encoding -----------------------------------------------------------

    def encode(self) -> bytes:
        enc = Encoder()
        enc.start(1, 1)
        enc.u32(self.epoch)
        enc.string(self.fsid)
        enc.u32(self.max_osd)
        enc.list(self.osd_state, Encoder.u32)
        enc.list(self.osd_weight, Encoder.u32)
        enc.map(self.osd_addrs, Encoder.s32, Encoder.string)
        enc.optional(self.osd_primary_affinity,
                     lambda e, v: e.list(v, Encoder.u32))
        enc.u32(len(self.pools))
        for pool in self.pools.values():
            pool.encode(enc)
        enc.map(self.erasure_code_profiles, Encoder.string,
                lambda e, p: e.map(p, Encoder.string, Encoder.string))
        enc.u64(self.flags)
        enc.map(self.pg_temp, _enc_pg,
                lambda e, v: e.list(v, Encoder.s32))
        enc.map(self.primary_temp, _enc_pg, Encoder.s32)
        enc.map(self.pg_upmap, _enc_pg,
                lambda e, v: e.list(v, Encoder.s32))
        enc.map(self.pg_upmap_items, _enc_pg,
                lambda e, v: e.list(
                    v, lambda e2, p: (e2.s32(p[0]), e2.s32(p[1]))))
        enc.bytes(json.dumps(to_json(self.crush)).encode())
        enc.finish()
        return enc.to_bytes()

    @classmethod
    def decode(cls, data: bytes) -> "OSDMap":
        dec = Decoder(data)
        dec.start(1)
        m = cls()
        m.epoch = dec.u32()
        m.fsid = dec.string()
        max_osd = dec.u32()
        m.osd_state = dec.list(Decoder.u32)
        m.osd_weight = dec.list(Decoder.u32)
        m.max_osd = max_osd
        m.osd_addrs = dec.map(Decoder.s32, Decoder.string)
        m.osd_primary_affinity = dec.optional(
            lambda d: d.list(Decoder.u32))
        n_pools = dec.u32()
        for _ in range(n_pools):
            pool = PgPool.decode(dec)
            m.pools[pool.id] = pool
        m.erasure_code_profiles = dec.map(
            Decoder.string,
            lambda d: d.map(Decoder.string, Decoder.string))
        m.flags = dec.u64()
        m.pg_temp = dec.map(_dec_pg, lambda d: d.list(Decoder.s32))
        m.primary_temp = dec.map(_dec_pg, Decoder.s32)
        m.pg_upmap = dec.map(_dec_pg, lambda d: d.list(Decoder.s32))
        m.pg_upmap_items = dec.map(
            _dec_pg, lambda d: d.list(lambda d2: (d2.s32(), d2.s32())))
        m.crush = from_json(json.loads(dec.bytes()))
        dec.finish()
        return m


def _enc_pg(enc: Encoder, pg: PgId) -> None:
    enc.s64(pg.pool)
    enc.u32(pg.ps)


def _dec_pg(dec: Decoder) -> PgId:
    return PgId(dec.s64(), dec.u32())


@dataclass
class Incremental:
    epoch: int
    new_max_osd: Optional[int] = None
    new_flags: Optional[int] = None
    new_pools: Dict[int, PgPool] = field(default_factory=dict)
    old_pools: List[int] = field(default_factory=list)
    new_erasure_code_profiles: Dict[str, Dict[str, str]] = field(
        default_factory=dict)
    old_erasure_code_profiles: List[str] = field(default_factory=list)
    new_up_osds: Dict[int, str] = field(default_factory=dict)
    new_state: Dict[int, int] = field(default_factory=dict)   # XOR bits
    new_weight: Dict[int, int] = field(default_factory=dict)
    new_pg_temp: Dict[PgId, List[int]] = field(default_factory=dict)
    new_primary_temp: Dict[PgId, int] = field(default_factory=dict)
    new_pg_upmap: Dict[PgId, List[int]] = field(default_factory=dict)
    old_pg_upmap: List[PgId] = field(default_factory=list)
    new_pg_upmap_items: Dict[PgId, List[Tuple[int, int]]] = field(
        default_factory=dict)
    old_pg_upmap_items: List[PgId] = field(default_factory=list)
    new_crush: Optional[CrushMap] = None

    def encode(self) -> bytes:
        """Wire codec (OSDMap::Incremental encode role) — lets the mon
        keep an incremental log and daemons replay the map stream epoch
        by epoch (interval detection depends on seeing EVERY epoch)."""
        enc = Encoder()
        enc.start(1, 1)
        enc.u32(self.epoch)
        enc.optional(self.new_max_osd, Encoder.u32)
        enc.optional(self.new_flags, Encoder.u64)
        enc.u32(len(self.new_pools))
        for pool in self.new_pools.values():
            pool.encode(enc)
        enc.list(self.old_pools, Encoder.s64)
        enc.map(self.new_erasure_code_profiles, Encoder.string,
                lambda e, p: e.map(p, Encoder.string, Encoder.string))
        enc.list(self.old_erasure_code_profiles, Encoder.string)
        enc.map(self.new_up_osds, Encoder.s32, Encoder.string)
        enc.map(self.new_state, Encoder.s32, Encoder.u32)
        enc.map(self.new_weight, Encoder.s32, Encoder.u32)
        enc.map(self.new_pg_temp, _enc_pg,
                lambda e, v: e.list(v, Encoder.s32))
        enc.map(self.new_primary_temp, _enc_pg, Encoder.s32)
        enc.map(self.new_pg_upmap, _enc_pg,
                lambda e, v: e.list(v, Encoder.s32))
        enc.list(self.old_pg_upmap, _enc_pg)
        enc.map(self.new_pg_upmap_items, _enc_pg,
                lambda e, v: e.list(
                    v, lambda e2, p: (e2.s32(p[0]), e2.s32(p[1]))))
        enc.list(self.old_pg_upmap_items, _enc_pg)
        enc.optional(self.new_crush,
                     lambda e, c: e.bytes(
                         json.dumps(to_json(c)).encode()))
        enc.finish()
        return enc.to_bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Incremental":
        dec = Decoder(data)
        dec.start(1)
        inc = cls(epoch=dec.u32())
        inc.new_max_osd = dec.optional(Decoder.u32)
        inc.new_flags = dec.optional(Decoder.u64)
        for _ in range(dec.u32()):
            pool = PgPool.decode(dec)
            inc.new_pools[pool.id] = pool
        inc.old_pools = dec.list(Decoder.s64)
        inc.new_erasure_code_profiles = dec.map(
            Decoder.string,
            lambda d: d.map(Decoder.string, Decoder.string))
        inc.old_erasure_code_profiles = dec.list(Decoder.string)
        inc.new_up_osds = dec.map(Decoder.s32, Decoder.string)
        inc.new_state = dec.map(Decoder.s32, Decoder.u32)
        inc.new_weight = dec.map(Decoder.s32, Decoder.u32)
        inc.new_pg_temp = dec.map(_dec_pg,
                                  lambda d: d.list(Decoder.s32))
        inc.new_primary_temp = dec.map(_dec_pg, Decoder.s32)
        inc.new_pg_upmap = dec.map(_dec_pg,
                                   lambda d: d.list(Decoder.s32))
        inc.old_pg_upmap = dec.list(_dec_pg)
        inc.new_pg_upmap_items = dec.map(
            _dec_pg, lambda d: d.list(lambda d2: (d2.s32(), d2.s32())))
        inc.old_pg_upmap_items = dec.list(_dec_pg)
        raw = dec.optional(Decoder.bytes)
        if raw is not None:
            inc.new_crush = from_json(json.loads(raw))
        dec.finish()
        return inc


class OSDMapMapping:
    """Bulk whole-map placement (OSDMapMapping + ParallelPGMapper).

    Where the reference shards PGs over a thread pool, every PG's pps of a
    pool go through one launch of the placement kernel on `device` (CUDA
    unless the caller names another; no CUDA and no device raises).  The
    map is flattened once per update, for its one weight vector.  A pool
    goes to the exact host path (`OSDMap.pg_to_up_acting_osds`) only when
    the kernel does not take its rule or the map (crush.kernel raises
    NotImplementedError: choose_args, the rule steps the JAX kernel drops,
    a firstn step past the pool size, non-straw2 buckets); a fault on the
    card raises.
    """

    def __init__(self, osdmap: OSDMap, device=None):
        self._map = osdmap
        self._device = resolve_device(device)
        self._by_pool: Dict[int, List[Tuple[List[int], int, List[int],
                                            int]]] = {}
        self._update()

    def _update(self) -> None:
        m = self._map
        dense: Optional[crush_kernel.DenseMap] = None
        # each (ruleno, size) resolves at most once per update, an
        # unsupported ruleno is remembered so sibling pools skip it, and
        # the pools answered by the host path are logged
        programs: Dict[Tuple[int, int],
                       Optional[crush_kernel.ChooseProgram]] = {}
        unsupported_rules: set = set()
        host_pools: List[int] = []
        for pool_id, pool in m.pools.items():
            entries = []
            rows: Optional[list] = None
            ruleno = m._find_rule(pool)
            pps = pool.all_pps()
            if ruleno >= 0 and ruleno not in unsupported_rules:
                key = (ruleno, pool.size)
                if key not in programs:
                    try:
                        programs[key] = crush_kernel.rule_program(
                            m.crush, ruleno, pool.size)
                        if dense is None:
                            dense = crush_kernel.DenseMap.from_crush_map(
                                m.crush, m.osd_weight, self._device)
                    except NotImplementedError:
                        programs[key] = None
                        unsupported_rules.add(ruleno)
                if programs[key] is not None:
                    rows = crush_kernel.place(dense, programs[key],
                                              pps).tolist()
            if rows is None and ruleno >= 0:
                host_pools.append(pool_id)
            pps_list = pps.tolist()
            for ps in range(pool.pg_num):
                pg = PgId(pool_id, ps)
                if rows is None:
                    entries.append(m.pg_to_up_acting_osds(pg))
                    continue
                raw = rows[ps]
                m._remove_nonexistent(pool, raw)
                m._apply_upmap(pool, pg, raw)
                up = m._raw_to_up(pool, raw)
                up_primary = m._pick_primary(up)
                up, up_primary = m._apply_primary_affinity(
                    pps_list[ps], pool, up, up_primary)
                acting, acting_primary = m._get_temp_osds(pool, pg)
                if not acting:
                    acting = list(up)
                    if acting_primary == -1:
                        acting_primary = up_primary
                entries.append((up, up_primary, acting, acting_primary))
            self._by_pool[pool_id] = entries
        if host_pools:
            log.info(
                "OSDMapMapping: pools %s placed by the host mapper (CRUSH"
                " rule or map not taken by the placement kernel)",
                host_pools)

    def get(self, pg: PgId) -> Tuple[List[int], int, List[int], int]:
        return self._by_pool[pg.pool][pg.ps]

    def pgs_by_osd(self) -> Dict[int, List[PgId]]:
        out: Dict[int, List[PgId]] = {}
        for pool_id, entries in self._by_pool.items():
            for ps, (up, _upp, _acting, _ap) in enumerate(entries):
                for o in up:
                    if o != CRUSH_ITEM_NONE:
                        out.setdefault(o, []).append(PgId(pool_id, ps))
        return out
