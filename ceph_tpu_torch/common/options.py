"""Typed option schema (port of
ceph_tpu/common/options.py).

Reference parity: the Option registry
(the reference's src/common/options.cc — 1,649 typed `Option(...)`
definitions; schema in options.h): each option carries type, level,
default (optionally HDD/SSD variants), min/max, enum values, description,
see_also, and flags.  This module keeps the same schema and declares the
options this framework actually consumes; `ceph_tpu_torch.common.config` layers
values over these defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# levels (Option::level_t)
LEVEL_BASIC = "basic"
LEVEL_ADVANCED = "advanced"
LEVEL_DEV = "dev"

# flags (Option::flag_t)
FLAG_RUNTIME = 1 << 0       # may change at runtime
FLAG_STARTUP = 1 << 1       # only at daemon startup
FLAG_CREATE = 1 << 2        # only at cluster/daemon creation


@dataclass
class Option:
    name: str
    type: str                       # int | uint | float | bool | str | size | secs
    default: Any
    level: str = LEVEL_ADVANCED
    desc: str = ""
    long_desc: str = ""
    min: Optional[float] = None
    max: Optional[float] = None
    enum_values: Tuple[str, ...] = ()
    see_also: Tuple[str, ...] = ()
    flags: int = FLAG_RUNTIME
    daemon_default: Dict[str, Any] = field(default_factory=dict)

    _CASTS = {"int": int, "uint": int, "float": float, "size": int,
              "secs": float, "bool": None, "str": str}

    _SIZE_SUFFIXES = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30,
                      "t": 1 << 40, "p": 1 << 50}

    def cast(self, value: Any) -> Any:
        """Parse/validate a raw (usually string) value; raises ValueError."""
        if self.type == "size" and isinstance(value, str):
            s = value.strip().lower()
            if s.endswith("b"):
                s = s[:-1]
            if s.endswith("i"):
                s = s[:-1]
            if s and s[-1] in self._SIZE_SUFFIXES:
                try:
                    value = int(float(s[:-1]) * self._SIZE_SUFFIXES[s[-1]])
                except ValueError:
                    raise ValueError(
                        f"{self.name}: {value!r} is not a size")
            else:
                value = s  # bare number, possibly after stripping B
        if self.type == "bool":
            if isinstance(value, bool):
                out: Any = value
            elif str(value).lower() in ("true", "1", "yes", "on"):
                out = True
            elif str(value).lower() in ("false", "0", "no", "off"):
                out = False
            else:
                raise ValueError(f"{self.name}: {value!r} is not a bool")
        else:
            caster = self._CASTS.get(self.type)
            if caster is None:
                raise ValueError(f"{self.name}: unknown type {self.type}")
            try:
                out = caster(value)
            except (TypeError, ValueError):
                raise ValueError(
                    f"{self.name}: {value!r} is not a {self.type}")
        if self.enum_values and out not in self.enum_values:
            raise ValueError(
                f"{self.name}: {out!r} not in {self.enum_values}")
        if self.min is not None and out < self.min:
            raise ValueError(f"{self.name}: {out} < min {self.min}")
        if self.max is not None and out > self.max:
            raise ValueError(f"{self.name}: {out} > max {self.max}")
        return out


def _opts() -> List[Option]:
    A, B, D = LEVEL_ADVANCED, LEVEL_BASIC, LEVEL_DEV
    return [
        # -- erasure code (options.cc:2662-2709) --------------------------
        Option("osd_pool_default_erasure_code_profile", "str",
               "plugin=jerasure technique=reed_sol_van k=2 m=2", A,
               desc="default erasure code profile"),
        Option("osd_pool_erasure_code_stripe_unit", "size", 4096, A,
               desc="chunk size for EC pools"),
        Option("osd_erasure_code_plugins", "str", "jerasure isa lrc", A,
               desc="EC plugins to preload", flags=FLAG_STARTUP),
        Option("erasure_code_dir", "str", "", A,
               desc="plugin directory (module path prefix here)",
               flags=FLAG_STARTUP),
        # -- compression / checksums (options.cc:4236-4311) ---------------
        Option("bluestore_compression_algorithm", "str", "snappy", A,
               enum_values=("", "snappy", "zlib", "zstd", "lz4", "brotli",
                            "none"),
               desc="default blob compressor"),
        Option("bluestore_compression_mode", "str", "none", A,
               enum_values=("none", "passive", "aggressive", "force"),
               desc="when to compress"),
        Option("bluestore_compression_required_ratio", "float", 0.875, A,
               min=0.0, max=1.0,
               desc="compressed size must be below this ratio of raw"),
        Option("bluestore_compression_min_blob_size", "size", 8192, A),
        Option("bluestore_compression_max_blob_size", "size", 65536, A),
        Option("bluestore_csum_type", "str", "crc32c", A,
               enum_values=("none", "crc32c", "crc32c_16", "crc32c_8",
                            "xxhash32", "xxhash64"),
               desc="per-block checksum algorithm"),
        Option("bluestore_csum_block_size", "size", 4096, D),
        # -- tpu dispatch --------------------------------------------------
        Option("tpu_ec_batch_stripes", "uint", 16, A,
               desc="stripes coalesced per EC device dispatch"),
        Option("tpu_min_dispatch_bytes", "size", 65536, A,
               desc="below this the host codec runs instead of the TPU"),
        # -- messenger / failure detection (options.cc:875-1108) ----------
        Option("ms_inject_socket_failures", "uint", 0, D,
               desc="inject a socket failure every Nth message"),
        Option("ms_inject_internal_delays", "float", 0.0, D),
        # -- wire compression (ms_osd_compress_mode family) ----------------
        Option("ms_compress_methods", "str", "", A,
               desc="csv of accepted wire compression methods, in"
                    " preference order (empty = off)"),
        Option("ms_compress_min_size", "size", 4096, A,
               desc="frames below this never compress"),
        Option("ms_compress_secure", "bool", False, A,
               desc="allow compression on AEAD-secured connections"
                    " (length side channel: off by default)"),
        Option("ms_dispatch_throttle_bytes", "size", 100 << 20, A),
        # -- elections (options.cc mon_election_*, ElectionLogic.h) --------
        Option("mon_election_default_strategy", "uint", 1, A,
               min=1, max=3,
               desc="1=classic (rank priority), 3=connectivity"
                    " (reachability-scored candidates)"),
        Option("mon_elector_ping_interval", "secs", 0.4, A,
               min=0.05, max=10.0,
               desc="mon-to-mon liveness probe period feeding the"
                    " connection tracker"),
        Option("mon_elector_score_halflife", "secs", 4.0, A,
               min=0.1, max=3600.0,
               desc="connectivity score decay half-life"),
        Option("mon_elector_ignore_propose_margin", "float", 0.05, A,
               min=0.0, max=1.0,
               desc="score difference below which rank breaks the tie"),
        Option("osd_heartbeat_interval", "secs", 6.0, A, min=0.1, max=60),
        Option("osd_heartbeat_grace", "secs", 20.0, A),
        Option("mon_osd_min_down_reporters", "uint", 2, A),
        Option("mon_osd_laggy_halflife", "secs", 3600.0, A),
        Option("mon_osd_laggy_weight", "float", 0.3, A, min=0.0, max=1.0),
        Option("mon_osd_adjust_heartbeat_grace", "bool", True, A),
        Option("heartbeat_inject_failure", "uint", 0, D),
        # -- hot-set tracking / read tier (HitSet.h + the tier agent;
        #    flat-substrate redesign: the tier caches DECODED objects
        #    on the primary, not a second pool) -----------------------
        Option("osd_tier_enable", "bool", True, A,
               desc="hot-set tracking + decoded-object read tier"
                    " (env kill switch: CEPH_TPU_TIER=0)",
               flags=FLAG_STARTUP),
        Option("osd_hit_set_count", "uint", 4, A, min=1, max=32,
               desc="hit sets per PG stack (open + archived)"),
        Option("osd_hit_set_period", "secs", 10.0, A,
               desc="seconds before the open hit set seals+rotates"),
        Option("osd_hit_set_target_size", "uint", 1024, A,
               desc="expected insertions per bloom hit set"),
        Option("osd_hit_set_bloom_fpp", "float", 0.05, A,
               min=0.0, max=0.5,
               desc="bloom hit-set false-positive probability"),
        Option("osd_hit_set_type", "str", "bloom", A,
               enum_values=("bloom", "explicit_hash"),
               desc="hit-set implementation"),
        Option("osd_tier_promote_min_recency", "uint", 2, A, min=1,
               desc="hit count across the stack before an EC object"
                    " is promoted into the decoded-object tier"),
        Option("osd_tier_cache_bytes", "size", 64 << 20, A,
               desc="decoded-object tier byte budget (LRU evicts"
                    " beyond it)"),
        Option("osd_tier_promote_max_inflight", "uint", 4, A, min=1,
               desc="concurrent agent promotions per daemon"),
        Option("osd_tier_promote_backoff", "secs", 5.0, A,
               desc="cool-down before re-attempting a failed"
                    " promotion of the same object"),
        # -- hedged reads (straggler-tolerant first-k sub-reads;
        #    osd/hedge.py — rateless/coded redundancy scheduling) ------
        Option("osd_hedge_enable", "bool", True, A,
               desc="hedged first-k EC sub-reads + per-peer latency"
                    " EWMAs (env kill switch: CEPH_TPU_HEDGE=0)",
               flags=FLAG_STARTUP),
        Option("osd_hedge_delta", "uint", 1, A, min=0, max=16,
               desc="speculative extra sub-reads beyond k in the"
                    " initial hedged fan-out (escalates by one while"
                    " the EWMA spread is high)",
               see_also=("osd_hedge_spread_escalate",)),
        Option("osd_hedge_ewma_alpha", "float", 0.25, A,
               min=0.01, max=1.0,
               desc="EWMA/EW-variance weight per sub-read RTT sample"),
        Option("osd_hedge_decay_halflife", "secs", 30.0, A,
               min=0.1, max=3600.0,
               desc="idle half-life decaying a peer's latency model"
                    " toward the prior — recovered OSDs re-earn trust"),
        Option("osd_hedge_rtt_prior_ms", "float", 10.0, A, min=0.0,
               desc="RTT prior (ms) for unsampled peers and the decay"
                    " target"),
        Option("osd_hedge_delay_floor_ms", "float", 2.0, A, min=0.0,
               desc="minimum straggler mark (ms) before a flight"
                    " recruits a spare sub-read"),
        Option("osd_hedge_delay_cap_ms", "float", 1000.0, A, min=1.0,
               desc="maximum straggler mark (ms) — bounds how long a"
                    " cold model waits before hedging"),
        Option("osd_hedge_spread_escalate", "float", 4.0, A, min=1.0,
               desc="max-p95/min-EWMA ratio across peers beyond which"
                    " the speculative Δ escalates by one"),
        # -- op queue / per-tenant QoS (mClockScheduler.h +
        #    osd_mclock_* family; tenant extension: client ops carry
        #    a tenant identity and schedule as `client.<tenant>`
        #    classes with their own dmClock triples, gated by a
        #    token-bucket admission stage before the queue) ----------
        Option("osd_op_queue", "str", "mclock_scheduler", A,
               enum_values=("mclock_scheduler", "wpq"),
               desc="op scheduling discipline", flags=FLAG_STARTUP),
        Option("osd_op_num_threads", "uint", 8, A, min=1,
               desc="max concurrent scheduler grants (the admit"
                    " gate's in-flight bound)"),
        Option("osd_scheduler_queue_depth", "uint", 1024, A, min=1,
               desc="per-class op queue bound; overflow follows"
                    " osd_scheduler_overflow"),
        Option("osd_scheduler_overflow", "str", "shed", A,
               enum_values=("shed", "block"),
               desc="bounded-queue overflow policy: shed=EBUSY the"
                    " caller, block=backpressure until the class"
                    " drains"),
        Option("osd_mclock_tenant_enable", "bool", True, A,
               desc="schedule tenant-tagged client ops as per-tenant"
                    " mClock classes (env kill switch:"
                    " CEPH_TPU_QOS=0)", flags=FLAG_STARTUP),
        Option("osd_mclock_tenant_reservation", "float", 0.0, A,
               min=0.0,
               desc="default per-tenant reservation (ops/s; 0 = no"
                    " floor)"),
        Option("osd_mclock_tenant_weight", "float", 1.0, A, min=0.01,
               desc="default per-tenant proportional-share weight"),
        Option("osd_mclock_tenant_limit", "float", 0.0, A, min=0.0,
               desc="default per-tenant limit (ops/s; 0 = unlimited)"
                    " — also the admission gate's bucket rate"),
        Option("osd_mclock_tenant_profiles", "str", "", A,
               desc="per-tenant overrides as JSON:"
                    ' {"<tenant>": [reservation, weight, limit]}'),
        Option("osd_mclock_admission_enable", "bool", True, A,
               desc="token-bucket admission gate ahead of the op"
                    " queue: over-limit tenants are delayed then shed"
                    " (EBUSY) before consuming execute-stage"
                    " resources"),
        Option("osd_mclock_admission_burst", "secs", 2.0, A, min=0.0,
               desc="bucket capacity in seconds' worth of the"
                    " tenant's limit rate"),
        Option("osd_mclock_admission_max_delay_ms", "float", 50.0, A,
               min=0.0,
               desc="max in-gate smoothing delay before an over-limit"
                    " op is shed instead"),
        # -- coded inference serving (ceph_tpu/inference) ------------------
        Option("osd_inference_error_budget", "float", 0.05, A,
               min=0.0, max=1e6,
               desc="default per-query relative error budget for"
                    " Fisher-fused approximate serving: an arrival"
                    " set whose structural error bound exceeds it"
                    " (or a caller demanding exactness) takes the"
                    " exact full-decode fallback"),
        # -- critical-path tracing (common/tracing.py: stage spans,
        #    head sampling for ring retention, tail-exemplar trees) ---
        Option("osd_trace_enable", "bool", True, A,
               desc="stage-span tracing + critical-path attribution"
                    " (env kill switch: CEPH_TPU_TRACE=0)",
               flags=FLAG_STARTUP),
        Option("osd_trace_sample_rate", "float", 1.0, A,
               min=0.0, max=1.0,
               desc="head-sampling probability that a locally-rooted"
                    " trace is retained in the dump_traces ring —"
                    " stage histograms and tail exemplars see every"
                    " op regardless"),
        # -- osd/pg --------------------------------------------------------
        Option("osd_pool_default_size", "uint", 3, B),
        Option("osd_pool_default_min_size", "uint", 0, A),
        Option("osd_pool_default_pg_num", "uint", 32, B),
        Option("osd_max_backfills", "uint", 1, A),
        Option("osd_recovery_max_active", "uint", 0, A),
        Option("osd_scrub_auto_repair", "bool", False, A),
        # -- logging -------------------------------------------------------
        Option("log_file", "str", "", B, flags=FLAG_STARTUP),
        Option("log_max_recent", "uint", 500, A),
        Option("debug_osd", "str", "1/5", A),
        Option("debug_ec", "str", "1/5", A),
        Option("debug_crush", "str", "1/5", A),
        Option("debug_compressor", "str", "1/5", A),
        Option("debug_ms", "str", "0/5", A),
        Option("debug_mon", "str", "1/5", A),
        Option("debug_bluestore", "str", "1/5", A),
        # -- admin socket --------------------------------------------------
        Option("admin_socket", "str", "", A, flags=FLAG_STARTUP,
               desc="path to the unix admin socket"),
    ]


OPTIONS: Dict[str, Option] = {o.name: o for o in _opts()}


def get_option(name: str) -> Option:
    return OPTIONS[name]
