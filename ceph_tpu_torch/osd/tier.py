"""Read-tier agent: hot EC objects decode once, then serve from memory
(port of ceph_tpu/osd/tier.py).

Reference parity: the cache-tier agent of PrimaryLogPG (agent_work /
maybe_promote, hit_set_* bookkeeping) and the pool tiering knobs
(osd_tier_promote_min_recency family).  Flat-substrate redesign: the
reference promotes objects between POOLS; here every byte already lives in
the OSDs' stores, so what a skewed read workload repeatedly pays is the EC
decode.  The tier therefore caches DECODED OBJECT BYTES on the primary: a
hot object decodes once, and every later read is a memory slice,
bit-identical to the cold path.

Coherency contract (what makes the bypass safe):
- entries live on the PRIMARY only, keyed (pg, oid);
- every mutation funnels through the primary's shard writes, recovery or
  scrub repair, each of which invalidates first;
- interval changes drop the PG's entries wholesale.

Observability rides common/perf_counters: hit / miss / promote / evict /
invalidate u64 counters, an inflight gauge, and a read-frequency
histogram fed at every hit-set rotation.  The subsystem sits behind
CEPH_TPU_TIER=0 (the env kill switch, common/flags) and the
osd_tier_enable option.  The agent's hit sets hash their rotations on
`device` (CUDA unless the caller names another); every other decision
runs on the host.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.common import flags, tracing
from ceph_tpu_torch.common.perf_counters import PerfCounters
from ceph_tpu_torch.osd import hitset as hitset_mod

# read-frequency histogram bounds: reads-per-object-per-period buckets
READ_FREQ_BOUNDS = [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0]


def env_enabled() -> bool:
    return flags.enabled("CEPH_TPU_TIER")


class TierAgent:
    """Per-daemon hot-set tracker + decoded-object read cache."""

    def __init__(self, who: str = "osd",
                 config: Optional[Dict[str, Any]] = None, device=None):
        cfg = config or {}
        self.who = who
        # where the hit sets hash their rotations (HitSetStack)
        self.device = device
        self.enabled = env_enabled() and bool(
            cfg.get("osd_tier_enable", True))
        self.hit_set_count = int(cfg.get("osd_hit_set_count", 4))
        self.hit_set_period = float(cfg.get("osd_hit_set_period", 10.0))
        self.hit_set_target_size = int(
            cfg.get("osd_hit_set_target_size", 1024))
        self.hit_set_fpp = float(cfg.get("osd_hit_set_bloom_fpp", 0.05))
        self.hit_set_kind = str(cfg.get("osd_hit_set_type", "bloom"))
        self.promote_min_recency = int(
            cfg.get("osd_tier_promote_min_recency", 2))
        self.cache_bytes_max = int(
            cfg.get("osd_tier_cache_bytes", 64 << 20))
        self.promote_max_inflight = int(
            cfg.get("osd_tier_promote_max_inflight", 4))
        self.promote_backoff_s = float(
            cfg.get("osd_tier_promote_backoff", 5.0))
        # decoded-object cache: (pg, oid) -> {"data", "version",
        # "promoted_at"}; OrderedDict gives the LRU order
        self.cache: "OrderedDict[Tuple[Any, str], Dict[str, Any]]" = \
            OrderedDict()
        self.cache_bytes = 0
        self.stacks: Dict[Any, hitset_mod.HitSetStack] = {}
        self._promoting: Set[Tuple[Any, str]] = set()
        # sealed-but-unpersisted hitsets (pg, seq, hitset), drained by
        # the daemon's persistence hook
        self._sealed: List[tuple] = []
        # objects whose decoded size exceeds the whole cache budget:
        # remembered so a giant hot object cannot re-trigger a
        # whole-object promotion decode on every read (cleared when
        # the object is rewritten — its size may have changed)
        self._oversize: Set[Tuple[Any, str]] = set()
        # failed promotions back off (monotonic deadline): a hot but
        # unreadable object (ENOENT / whiteout / degraded) must not
        # re-run a full decode attempt on every read
        self._backoff: Dict[Tuple[Any, str], float] = {}
        self.perf = PerfCounters(f"{who}.tier")
        for name, desc in (
                ("hit", "reads served from the decoded-object tier"),
                ("miss", "tier-eligible reads that took the cold path"),
                ("promote", "objects promoted into the tier"),
                ("promote_fail", "promotions aborted (read error/race)"),
                ("promote_skipped",
                 "promotions not started (inflight cap/dup)"),
                ("evict", "entries evicted under the byte budget"),
                ("invalidate", "entries dropped by mutations"),
                ("hitset_rotations", "sealed hit-set periods"),
                ("records", "reads recorded into the open hit set")):
            self.perf.add_u64_counter(name, desc)
        self.perf.add_u64("inflight", "promotions currently running")
        self.perf.add_u64("cached_objects", "entries in the tier")
        self.perf.add_u64("cached_bytes", "bytes held by the tier")
        self.perf.add_histogram(
            "read_freq", READ_FREQ_BOUNDS,
            "reads per object per hit-set period (fed on rotation)")

    # -- hit-set recording -------------------------------------------------

    def _stack(self, pg) -> hitset_mod.HitSetStack:
        st = self.stacks.get(pg)
        if st is None:
            st = self.stacks[pg] = hitset_mod.HitSetStack(
                count=self.hit_set_count,
                period=self.hit_set_period,
                target_size=self.hit_set_target_size,
                fpp=self.hit_set_fpp,
                kind=self.hit_set_kind,
                device=self.device)
        return st

    def record_read(self, pg, oid: str) -> None:
        """Record one read into the open hit set.  Rotation is
        read-driven: the first read past the period boundary seals
        the open set (one device-batched bloom insert) — the sealed
        set is queued for the daemon to persist (pop_sealed).

        Deliberately does NOT compute the promote signal: a
        steady-state tier hit must not pay archived-bloom membership
        probes — callers ask hit_count() only after a cache miss."""
        if not self.enabled:
            return
        st = self._stack(pg)
        if st.due():
            self._rotate(pg, st)
        st.insert(hitset_mod.hash_oid(oid))
        self.perf.inc("records")

    def hit_count(self, pg, oid: str) -> int:
        """The promote signal: sets (open + archived) containing oid."""
        if not self.enabled:
            return 0
        st = self.stacks.get(pg)
        if st is None:
            return 0
        return st.hit_count(hitset_mod.hash_oid(oid))

    def note_read(self, pg, oid: str) -> int:
        """record_read + hit_count in one call (probes and tests; the
        daemon's read path splits them to keep tier hits cheap)."""
        if not self.enabled:
            return 0
        self.record_read(pg, oid)
        return self.hit_count(pg, oid)

    def _rotate(self, pg, st: hitset_mod.HitSetStack) -> None:
        for n in st.read_frequencies():
            self.perf.hinc("read_freq", float(n))
        sealed = st.rotate()
        self.perf.inc("hitset_rotations")
        self._sealed.append((pg, st.seq, sealed))
        del self._sealed[:-16]  # ring: persistence is best-effort

    def sealed_pending(self) -> bool:
        return bool(self._sealed)

    def pop_sealed(self) -> List[tuple]:
        """[(pg, seq, hitset)] sealed since the last call — the daemon
        persists each via the pg-meta omap prefix."""
        out, self._sealed = self._sealed, []
        return out

    def rotate_all(self) -> None:
        """Force-seal every open set (tests and the admin surface)."""
        for pg, st in list(self.stacks.items()):
            self._rotate(pg, st)

    # -- decoded-object cache ----------------------------------------------

    def lookup(self, pg, oid: str) -> Optional[bytes]:
        """Decoded bytes for (pg, oid), or None.  Counts hit/miss."""
        if not self.enabled:
            return None
        key = (pg, oid)
        entry = self.cache.get(key)
        if entry is None:
            self.perf.inc("miss")
            # annotate the op's span (no-op untraced): a tier miss
            # means the read pays the cold decode path below
            tracing.event("tier miss")
            return None
        self.cache.move_to_end(key)
        self.perf.inc("hit")
        tracing.event("tier hit")
        return entry["data"]

    def wants_promote(self, pg, oid: str, hit_count: int) -> bool:
        if not self.enabled or hit_count < self.promote_min_recency:
            return False
        key = (pg, oid)
        if key in self.cache or key in self._promoting or \
                key in self._oversize:
            return False
        until = self._backoff.get(key)
        if until is not None:
            if until > time.monotonic():
                return False
            del self._backoff[key]
        return True

    def begin_promote(self, pg, oid: str) -> bool:
        """Claim the promotion slot; False when capped or duplicate."""
        key = (pg, oid)
        if not self.enabled or key in self._promoting or \
                key in self.cache or \
                len(self._promoting) >= self.promote_max_inflight:
            self.perf.inc("promote_skipped")
            return False
        self._promoting.add(key)
        self.perf.set("inflight", len(self._promoting))
        return True

    def end_promote(self, pg, oid: str,
                    data: Optional[bytes]) -> None:
        key = (pg, oid)
        self._promoting.discard(key)
        self.perf.set("inflight", len(self._promoting))
        if data is None:
            self.perf.inc("promote_fail")
            if len(self._backoff) > 4096:
                self._backoff.clear()  # bounded, rebuilt on demand
            self._backoff[key] = time.monotonic() + \
                self.promote_backoff_s
            return
        self.install(pg, oid, data)
        self.perf.inc("promote")

    def install(self, pg, oid: str, data: bytes) -> None:
        if not self.enabled:
            return
        key = (pg, oid)
        if len(data) > self.cache_bytes_max:
            # a single over-budget object never fits: refuse it
            # WITHOUT evicting the rest of the hot set, and remember
            # it so the agent stops re-decoding it on every read
            self._oversize.add(key)
            if len(self._oversize) > 4096:
                self._oversize.clear()   # bounded, rebuilt on demand
            return
        old = self.cache.pop(key, None)
        if old is not None:
            self.cache_bytes -= len(old["data"])
        # coherence is invalidate-first + drop_pg, not versioning:
        # the entry carries no version on purpose
        self.cache[key] = {"data": bytes(data),
                           "promoted_at": time.monotonic()}
        self.cache_bytes += len(data)
        while self.cache_bytes > self.cache_bytes_max and \
                len(self.cache) > 1:
            _k, victim = self.cache.popitem(last=False)
            self.cache_bytes -= len(victim["data"])
            self.perf.inc("evict")
        self._gauges()

    def invalidate(self, pg, oid: str) -> None:
        self._oversize.discard((pg, oid))
        self._backoff.pop((pg, oid), None)
        entry = self.cache.pop((pg, oid), None)
        if entry is not None:
            self.cache_bytes -= len(entry["data"])
            self.perf.inc("invalidate")
            self._gauges()

    def drop_pg(self, pg) -> None:
        """Interval change: primary-scope state is no longer coherent."""
        for key in [k for k in self.cache if k[0] == pg]:
            self.cache_bytes -= len(self.cache.pop(key)["data"])
            self.perf.inc("invalidate")
        self._oversize = {k for k in self._oversize if k[0] != pg}
        self._backoff = {k: v for k, v in self._backoff.items()
                         if k[0] != pg}
        self.stacks.pop(pg, None)
        self._gauges()

    def _gauges(self) -> None:
        self.perf.set("cached_objects", len(self.cache))
        self.perf.set("cached_bytes", self.cache_bytes)

    # -- observability -----------------------------------------------------

    def counters(self) -> Dict[str, Any]:
        """Flat perf view (ints + the read_freq histogram dict) merged
        into the daemon's `perf dump` and scraped by prometheus."""
        return self.perf.dump()

    def status(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "cached_objects": len(self.cache),
            "cached_bytes": self.cache_bytes,
            "cache_bytes_max": self.cache_bytes_max,
            "promote_min_recency": self.promote_min_recency,
            "promotions_inflight": len(self._promoting),
            "counters": self.perf.dump(),
            "objects": [{"pg": str(k[0]), "oid": k[1],
                         "bytes": len(e["data"])}
                        for k, e in list(self.cache.items())[-32:]],
        }

    def hitset_dump(self) -> Dict[str, Any]:
        return {str(pg): st.dump() for pg, st in self.stacks.items()}
