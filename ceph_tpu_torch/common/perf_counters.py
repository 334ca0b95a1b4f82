"""Performance counters (port of ceph_tpu/common/perf_counters.py).

Reference parity: PerfCounters
(the reference's src/common/perf_counters.h): typed counters built through
PerfCountersBuilder (u64 counters, time counters, averages with
count+sum, histograms), grouped per subsystem with an index range, held in
a PerfCountersCollection, and dumped as JSON by the admin socket's
`perf dump` / described by `perf schema`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

# perf counter types (perf_counters.h enum)
PERFCOUNTER_U64 = 1
PERFCOUNTER_TIME = 2
PERFCOUNTER_LONGRUNAVG = 4
PERFCOUNTER_COUNTER = 8
PERFCOUNTER_HISTOGRAM = 0x10


class _Counter:
    __slots__ = ("name", "type", "desc", "value", "count", "sum",
                 "histogram")

    def __init__(self, name: str, type_: int, desc: str,
                 histogram_bounds: Optional[List[float]] = None):
        self.name = name
        self.type = type_
        self.desc = desc
        self.value = 0
        self.count = 0
        self.sum = 0.0
        self.histogram = ([0] * (len(histogram_bounds) + 1)
                          if histogram_bounds is not None else None)


class PerfCounters:
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._counters: Dict[str, _Counter] = {}
        self._bounds: Dict[str, List[float]] = {}

    # -- build ------------------------------------------------------------

    def add_u64_counter(self, name: str, desc: str = "") -> None:
        self._counters[name] = _Counter(
            name, PERFCOUNTER_U64 | PERFCOUNTER_COUNTER, desc)

    def add_u64(self, name: str, desc: str = "") -> None:
        self._counters[name] = _Counter(name, PERFCOUNTER_U64, desc)

    def add_time_avg(self, name: str, desc: str = "") -> None:
        self._counters[name] = _Counter(
            name, PERFCOUNTER_TIME | PERFCOUNTER_LONGRUNAVG, desc)

    def add_histogram(self, name: str, bounds: List[float],
                      desc: str = "") -> None:
        self._counters[name] = _Counter(
            name, PERFCOUNTER_HISTOGRAM, desc, histogram_bounds=bounds)
        self._bounds[name] = list(bounds)

    # -- update -----------------------------------------------------------

    def inc(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[name].value += amount

    def dec(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._counters[name].value -= amount

    def set(self, name: str, value: int) -> None:
        with self._lock:
            self._counters[name].value = value

    def tinc(self, name: str, seconds: float) -> None:
        with self._lock:
            c = self._counters[name]
            c.count += 1
            c.sum += seconds

    def hinc(self, name: str, sample: float) -> None:
        with self._lock:
            c = self._counters[name]
            bounds = self._bounds[name]
            idx = len(bounds)
            for i, bound in enumerate(bounds):
                if sample <= bound:
                    idx = i
                    break
            c.histogram[idx] += 1
            c.count += 1
            c.sum += sample

    def time_it(self, name: str):
        """Context manager feeding a time_avg counter."""
        return _Timer(self, name)

    # -- read -------------------------------------------------------------

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters[name].value

    def avg(self, name: str) -> float:
        with self._lock:
            c = self._counters[name]
            return c.sum / c.count if c.count else 0.0

    def dump(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        with self._lock:
            for name, c in self._counters.items():
                if c.type & PERFCOUNTER_LONGRUNAVG:
                    out[name] = {"avgcount": c.count, "sum": c.sum,
                                 "avgtime": c.sum / c.count if c.count
                                 else 0.0}
                elif c.type & PERFCOUNTER_HISTOGRAM:
                    out[name] = {"count": c.count, "sum": c.sum,
                                 "buckets": list(c.histogram),
                                 "bounds": self._bounds[name]}
                else:
                    out[name] = c.value
        return out

    def schema(self) -> Dict[str, Any]:
        with self._lock:
            return {name: {"type": c.type, "description": c.desc}
                    for name, c in self._counters.items()}


class _Timer:
    def __init__(self, counters: PerfCounters, name: str):
        self._counters = counters
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._counters.tinc(self._name, time.perf_counter() - self._t0)
        return False


class PerfCountersCollection:
    """All of a process's PerfCounters; `perf dump` walks this."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._loggers: Dict[str, PerfCounters] = {}

    def add(self, counters: PerfCounters) -> None:
        with self._lock:
            self._loggers[counters.name] = counters

    def remove(self, name: str) -> None:
        with self._lock:
            self._loggers.pop(name, None)

    def get(self, name: str) -> Optional[PerfCounters]:
        with self._lock:
            return self._loggers.get(name)

    def dump(self, logger: str = "") -> Dict[str, Any]:
        with self._lock:
            loggers = dict(self._loggers)
        return {name: pc.dump() for name, pc in loggers.items()
                if not logger or name == logger}

    def schema(self) -> Dict[str, Any]:
        with self._lock:
            loggers = dict(self._loggers)
        return {name: pc.schema() for name, pc in loggers.items()}
