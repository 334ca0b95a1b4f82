"""Per-PG op log: crash consistency + divergence repair (port of
ceph_tpu/osd/pg_log.py).

Reference parity: PGLog (the reference's src/osd/PGLog.h) — the per-PG
replicated journal that lets a crashed/partitioned shard rejoin: the
primary elects the authoritative log (max last_update — GetLog,
PeeringState.h:249), peers merge it (`merge_log` PGLog.h:1247), entries
the authoritative log does not contain are divergent and rewound
(`rewind_divergent_log` PGLog.h:1241 — here: the touched object is
marked missing and recovered to the authoritative state), and objects
written past a peer's last_update form its missing set, driving
log-based recovery.  A peer whose last_update predates the log tail
cannot be caught up by log replay and needs backfill (whole-PG scan).

Design: entries are JSON-friendly dicts (they ride MPGLogMsg / sub-op
messages); the log and pg info persist in the pgmeta object's omap of
the shard's collection, committed in the SAME ObjectStore transaction as
the data mutation they journal — the store's transactional atomicity
gives the log its WAL semantics.

eversion_t = (epoch, version), ordered lexicographically.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from ceph_tpu_torch.os import ObjectId, Transaction

PGMETA_OID = "_pgmeta_"
K_INFO = "info"
K_LOG = "log"
K_MISSING = "missing"

Ever = Tuple[int, int]


def ev(v) -> Ever:
    """Coerce a wire-form [epoch, version] to a comparable tuple."""
    return (int(v[0]), int(v[1]))


ZERO: Ever = (0, 0)


def make_entry(version: Ever, prior: Ever, oid: str, op: str,
               size: int = 0) -> Dict[str, Any]:
    """op: 'modify' (incl. create) | 'delete'."""
    return {"version": list(version), "prior": list(prior),
            "oid": oid, "op": op, "size": size}


class PGInfo:
    """pg_info_t role: identity + log bounds of one shard's PG state."""

    def __init__(self, last_update: Ever = ZERO, log_tail: Ever = ZERO,
                 same_interval_since: int = 0, last_epoch_started: int = 0):
        self.last_update = last_update
        self.log_tail = log_tail
        self.same_interval_since = same_interval_since
        self.last_epoch_started = last_epoch_started

    def to_dict(self) -> Dict[str, Any]:
        return {"last_update": list(self.last_update),
                "log_tail": list(self.log_tail),
                "same_interval_since": self.same_interval_since,
                "last_epoch_started": self.last_epoch_started}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PGInfo":
        return cls(ev(d["last_update"]), ev(d["log_tail"]),
                   int(d.get("same_interval_since", 0)),
                   int(d.get("last_epoch_started", 0)))


class PGLog:
    """Ordered entries (oldest first) + info, with merge/rewind."""

    def __init__(self, info: Optional[PGInfo] = None,
                 entries: Optional[List[Dict[str, Any]]] = None,
                 missing: Optional[Dict[str, Ever]] = None):
        self.info = info or PGInfo()
        self.entries: List[Dict[str, Any]] = entries or []
        # objects whose on-disk state lags the log head (pg_missing_t):
        # oid -> version needed ((0,0) = unknown, recover to auth state).
        # Persisted so a shard that crashes mid-recovery still knows what
        # it must not serve.
        self.missing: Dict[str, Ever] = missing or {}

    # -- append / trim -----------------------------------------------------

    def append(self, entry: Dict[str, Any]) -> None:
        version = ev(entry["version"])
        assert version > self.info.last_update, \
            f"log entry {version} <= head {self.info.last_update}"
        self.entries.append(entry)
        self.info.last_update = version

    def trim_to(self, keep: int) -> None:
        """Keep at most `keep` entries; advances log_tail."""
        if len(self.entries) > keep:
            cut = self.entries[:len(self.entries) - keep]
            self.entries = self.entries[len(cut):]
            self.info.log_tail = ev(cut[-1]["version"])

    # -- queries -----------------------------------------------------------

    def versions(self) -> Dict[Ever, Dict[str, Any]]:
        return {ev(e["version"]): e for e in self.entries}

    def objects_newer_than(self, bound: Ever) -> Dict[str, Ever]:
        """oid -> latest version, over entries with version > bound.
        `delete` entries count too (the peer must learn the delete)."""
        out: Dict[str, Ever] = {}
        for e in self.entries:
            if ev(e["version"]) > bound:
                out[e["oid"]] = ev(e["version"])
        return out

    # -- merge (merge_log + rewind_divergent_log) --------------------------

    def merge(self, auth_info: PGInfo,
              auth_entries: List[Dict[str, Any]]) -> Dict[str, Ever]:
        """Adopt the authoritative log; returns this shard's missing set
        {oid: version needed}.

        Divergence point = the newest local version that also appears in
        the authoritative log.  Local entries past it are divergent ->
        their objects are missing (to be recovered to auth state);
        authoritative entries past it are ops this shard never saw ->
        missing too.  If the local head predates the auth log tail, log
        replay can't catch up: every object in the auth log window is
        missing and the caller should treat the peer as backfill.
        """
        auth_versions = {ev(e["version"]) for e in auth_entries}
        missing: Dict[str, Ever] = {}

        # divergence point: newest local version the auth log also knows
        # (in its entries, or at/before its tail = in its trimmed past)
        common: Ever = ZERO
        divergent: List[Dict[str, Any]] = []
        if not self.entries:
            common = self.info.last_update
        else:
            for e in reversed(self.entries):
                version = ev(e["version"])
                if version in auth_versions or \
                        version <= auth_info.log_tail:
                    common = version
                    break
                divergent.append(e)
            # no break -> common stays ZERO: whole local log divergent

        for e in divergent:  # rewind_divergent_log
            missing[e["oid"]] = ZERO  # unknown good version yet

        # adopt auth entries newer than the divergence point
        for e in auth_entries:
            version = ev(e["version"])
            if version > common:
                missing[e["oid"]] = version

        # divergent objects with no auth entry: roll back to whatever the
        # auth primary holds now (recovery source resolves it); keep ZERO
        self.entries = [dict(e) for e in auth_entries]
        self.info.last_update = auth_info.last_update
        self.info.log_tail = auth_info.log_tail
        return missing

    # -- persistence -------------------------------------------------------

    def stage(self, t: Transaction, cid: str) -> None:
        """Write info+log+missing into the transaction (same txn as the
        data mutation it journals)."""
        t.omap_setkeys(cid, ObjectId(PGMETA_OID), {
            K_INFO: json.dumps(self.info.to_dict()).encode(),
            K_LOG: json.dumps(self.entries).encode(),
            K_MISSING: json.dumps(
                {k: list(v) for k, v in self.missing.items()}).encode(),
        })

    @classmethod
    def load(cls, store, cid: str) -> "PGLog":
        try:
            omap = store.omap_get(cid, ObjectId(PGMETA_OID))
        except KeyError:
            return cls()
        if K_INFO not in omap:
            return cls()
        missing = {k: ev(v) for k, v in json.loads(
            omap.get(K_MISSING, b"{}")).items()}
        return cls(PGInfo.from_dict(json.loads(omap[K_INFO])),
                   json.loads(omap.get(K_LOG, b"[]")), missing)
