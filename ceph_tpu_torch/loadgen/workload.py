"""Tenant specs + deterministic open-loop arrival schedules (port of
ceph_tpu/loadgen/workload.py).

Each simulated tenant is an independent client: its own arrival rate
(Poisson or deterministic), its own op blend (read/write/stat/ranged
GET), and its own zipf object-popularity stream (the deterministic
`zipf_indices` sampler from ceph_tpu_torch/tools/rados.py, so bench legs
and regression tests replay bit-identical schedules).  Schedules are
generated lazily per tenant and merged time-ordered, so a
10,000-tenant sweep holds one event per tenant in memory, not the
whole cross product.
"""

from __future__ import annotations

import heapq
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List

import numpy as np

from ceph_tpu_torch.tools.rados import zipf_indices

OP_KINDS = ("read", "write", "stat", "ranged", "infer")

#: default blend: read-mostly with a write/stat/ranged tail — the
#: object-store shape the north star describes
DEFAULT_BLEND: Dict[str, float] = {
    "read": 0.70, "write": 0.15, "stat": 0.10, "ranged": 0.05}


def parse_blend(spec: str) -> Dict[str, float]:
    """'read=0.7,write=0.2,stat=0.1' -> normalized weight dict.
    Unknown kinds raise; missing kinds weigh 0."""
    if not spec:
        return dict(DEFAULT_BLEND)
    out: Dict[str, float] = {}
    for part in spec.split(","):
        name, _, w = part.strip().partition("=")
        if name not in OP_KINDS:
            raise ValueError(
                f"unknown op kind {name!r} (want {OP_KINDS})")
        out[name] = float(w) if w else 1.0
    total = sum(out.values())
    if total <= 0:
        raise ValueError(f"blend {spec!r} sums to zero")
    return {k: v / total for k, v in out.items()}


@dataclass(frozen=True)
class TenantSpec:
    """One simulated tenant's workload shape."""

    name: str
    arrival_rate: float                 # ops/sec offered (open loop)
    blend: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_BLEND))
    zipf_theta: float = 1.0             # object popularity skew
    objects: int = 64                   # shared hot-set size addressed
    object_size: int = 4096             # write payload / read size
    poisson: bool = True                # False: deterministic spacing
    infer_batch: int = 8                # queries per `infer` op

    def seed_for(self, base_seed: int) -> int:
        """Stable per-tenant seed: crc32 of the name folded with the
        run seed (hash() is salted per process — useless here)."""
        return (zlib.crc32(self.name.encode()) ^ (base_seed * 0x9E3779B1)) \
            & 0x7FFFFFFF


@dataclass(frozen=True)
class OpEvent:
    """One scheduled operation: fire at t (seconds from run start)
    regardless of completions — that is what makes the loop open."""

    t: float
    tenant: str
    kind: str
    obj: int
    size: int


def make_tenants(n: int, rate: float = 2.0,
                 blend: Dict[str, float] = None,
                 zipf_theta: float = 1.0, objects: int = 64,
                 object_size: int = 4096,
                 name_prefix: str = "t") -> List[TenantSpec]:
    blend = dict(blend or DEFAULT_BLEND)
    return [TenantSpec(name=f"{name_prefix}{i}", arrival_rate=rate,
                       blend=blend, zipf_theta=zipf_theta,
                       objects=objects, object_size=object_size)
            for i in range(n)]


def tenant_events(spec: TenantSpec, duration: float,
                  seed: int = 0) -> Iterator[OpEvent]:
    """Lazy, deterministic event stream for one tenant over
    [0, duration).  Poisson mode draws exponential inter-arrivals;
    deterministic mode spaces ops evenly with a seeded phase (so
    thousands of same-rate tenants don't fire in lockstep)."""
    rate = float(spec.arrival_rate)
    if rate <= 0 or duration <= 0:
        return
    rng = np.random.default_rng(spec.seed_for(seed))
    # expected count with headroom; Poisson tails are cut at duration
    est = max(4, int(rate * duration * 2) + 8)
    if spec.poisson:
        gaps = rng.exponential(1.0 / rate, size=est)
        times = np.cumsum(gaps)
    else:
        phase = rng.random() / rate
        times = phase + np.arange(est) / rate
    times = times[times < duration]
    count = len(times)
    if count == 0:
        return
    kinds = list(spec.blend.keys())
    weights = np.array([spec.blend[k] for k in kinds], dtype=np.float64)
    kind_idx = rng.choice(len(kinds), size=count, p=weights)
    objs = zipf_indices(spec.zipf_theta, spec.objects, count,
                        seed=spec.seed_for(seed) ^ 0x5F5E5F)
    for i in range(count):
        kind = kinds[int(kind_idx[i])]
        # infer ops size in QUERIES (the per-tenant batch knob), not
        # payload bytes — goodput credits scored queries for them
        yield OpEvent(t=float(times[i]), tenant=spec.name, kind=kind,
                      obj=int(objs[i]),
                      size=spec.infer_batch if kind == "infer"
                      else spec.object_size)


def merged_schedule(tenants: Iterable[TenantSpec], duration: float,
                    seed: int = 0) -> Iterator[OpEvent]:
    """All tenants' event streams merged time-ordered, lazily: the
    heap holds ONE pending event per tenant.  Ties break on tenant
    name so the merge itself is deterministic."""
    streams = [tenant_events(t, duration, seed) for t in tenants]
    keyed = (((ev.t, ev.tenant, ev) for ev in s) for s in streams)
    for _t, _name, ev in heapq.merge(*keyed):
        yield ev


def schedule_fingerprint(tenants: Iterable[TenantSpec],
                         duration: float, seed: int = 0) -> int:
    """crc32 over the full merged schedule — the cheap determinism
    proof (same seed -> same fingerprint, across processes)."""
    crc = 0
    for ev in merged_schedule(tenants, duration, seed):
        crc = zlib.crc32(
            f"{ev.t:.9f}|{ev.tenant}|{ev.kind}|{ev.obj}".encode(), crc)
    return crc
