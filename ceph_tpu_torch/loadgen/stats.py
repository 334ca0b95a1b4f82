"""Streaming latency + goodput accounting for the open-loop harness (port
of ceph_tpu/loadgen/stats.py).

HdrHistogram role: latency samples land in log-spaced buckets
(~4.4% relative resolution from 1 us to ~200 s) held in a few hundred
integer counters — memory is CONSTANT in the op count, so a
million-op sweep accounts exactly like a ten-op one and the
`unbounded-latency-buffer` lint rule has nothing to flag here.
Percentiles come from a cumulative walk over the buckets; merging two
histograms is element-wise addition, which is how per-tenant
recorders roll up into the aggregate report.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

# bucket geometry: shared by every histogram so merge() is plain
# element-wise addition
_LO = 1e-6            # 1 us floor: everything faster lands in bin 0
_HI = 200.0           # 200 s ceiling: everything slower saturates
_PER_OCTAVE = 16      # 2^(1/16) growth => ~4.4% relative error
_NBINS = int(math.log2(_HI / _LO) * _PER_OCTAVE) + 2


class LatencyHistogram:
    """Bounded-memory latency recorder with percentile queries."""

    __slots__ = ("bins", "count", "total", "max")

    def __init__(self) -> None:
        self.bins: List[int] = [0] * _NBINS
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    @staticmethod
    def _index(seconds: float) -> int:
        if seconds <= _LO:
            return 0
        return min(_NBINS - 1,
                   int(math.log2(seconds / _LO) * _PER_OCTAVE) + 1)

    @staticmethod
    def _edge(index: int) -> float:
        """Upper edge of a bucket (what percentile() reports): the
        true sample is within ~4.4% below it."""
        if index <= 0:
            return _LO
        return _LO * 2.0 ** (index / _PER_OCTAVE)

    def record(self, seconds: float) -> None:
        if seconds < 0.0:
            seconds = 0.0
        self.bins[self._index(seconds)] += 1
        self.count += 1
        self.total += seconds
        if seconds > self.max:
            self.max = seconds

    def merge(self, other: "LatencyHistogram") -> None:
        for i, n in enumerate(other.bins):
            if n:
                self.bins[i] += n
        self.count += other.count
        self.total += other.total
        if other.max > self.max:
            self.max = other.max

    def percentile(self, q: float) -> Optional[float]:
        """Latency (seconds) at quantile q in [0, 1]; None when
        empty.  Reports the bucket's upper edge, capped at the
        observed max so p100 of one sample is that sample."""
        if self.count == 0:
            return None
        want = max(1, math.ceil(q * self.count))
        cum = 0
        for i, n in enumerate(self.bins):
            cum += n
            if cum >= want:
                return min(self._edge(i), self.max) if self.max \
                    else self._edge(i)
        return self.max

    def mean(self) -> Optional[float]:
        return (self.total / self.count) if self.count else None

    def to_perf_histogram(self) -> Dict[str, object]:
        """Prometheus-shaped export ({bounds, buckets, count, sum}):
        the fine log buckets fold per-octave so a stage histogram
        costs ~28 exposition rows, not ~450.  Bounds are upper edges
        in SECONDS; the mgr flattener renders cumulative
        `_bucket{le=...}` rows plus `_count`/`_sum`."""
        bounds: List[float] = []
        buckets: List[int] = []
        i = 1
        while i < _NBINS:
            j = min(i + _PER_OCTAVE, _NBINS)
            bounds.append(round(self._edge(j - 1), 9))
            buckets.append(self.bins[0] + sum(self.bins[i:j])
                           if i == 1 else sum(self.bins[i:j]))
            i = j
        return {"bounds": bounds, "buckets": buckets,
                "count": self.count, "sum": round(self.total, 6)}

    def to_dict(self) -> Dict[str, float]:
        """Percentile summary in milliseconds (report shape)."""
        out: Dict[str, float] = {"count": self.count}
        for q, name in ((0.5, "p50_ms"), (0.95, "p95_ms"),
                        (0.99, "p99_ms")):
            v = self.percentile(q)
            out[name] = round(v * 1e3, 3) if v is not None else None
        out["max_ms"] = round(self.max * 1e3, 3) if self.count else None
        out["mean_ms"] = round(self.mean() * 1e3, 3) \
            if self.count else None
        return out


class GoodputMeter:
    """Completed-work accounting: ops and payload bytes that finished
    SUCCESSFULLY (sheds, errors and drops are counted, not credited —
    goodput is the metric the north star is judged by, not offered
    throughput)."""

    __slots__ = ("ops", "bytes", "queries", "shed", "errors",
                 "dropped")

    def __init__(self) -> None:
        self.ops = 0
        self.bytes = 0
        self.queries = 0
        self.shed = 0
        self.errors = 0
        self.dropped = 0

    def ok(self, nbytes: int) -> None:
        self.ops += 1
        self.bytes += int(nbytes)

    def scored(self, nqueries: int, nbytes: int) -> None:
        """One completed `infer` op: credit the scored-query payload
        (queries are the goodput unit of the serving workload; the
        score bytes still count toward byte goodput)."""
        self.ops += 1
        self.queries += int(nqueries)
        self.bytes += int(nbytes)

    def merge(self, other: "GoodputMeter") -> None:
        self.ops += other.ops
        self.bytes += other.bytes
        self.queries += other.queries
        self.shed += other.shed
        self.errors += other.errors
        self.dropped += other.dropped

    def to_dict(self, elapsed_s: float) -> Dict[str, float]:
        dt = max(elapsed_s, 1e-9)
        out = {
            "completed": self.ops,
            "shed": self.shed,
            "errors": self.errors,
            "dropped": self.dropped,
            "ops_per_sec": round(self.ops / dt, 2),
            "goodput_mib_s": round(self.bytes / dt / (1 << 20), 3),
        }
        if self.queries:
            out["queries"] = self.queries
            out["queries_per_sec"] = round(self.queries / dt, 2)
        return out
