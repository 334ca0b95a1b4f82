"""OpTracker (port of ceph_tpu/osd/op_tracker.py): in-flight op registry
+ historic ring + slow-op warnings
+ tail-exemplar trace retention.

Reference parity: TrackedOp/OpTracker
(the reference's src/common/TrackedOp.h) — every client op is wrapped
in a tracked record with an event timeline; `dump_ops_in_flight` and
`dump_historic_ops` are served over the admin socket, and ops older
than the warn threshold raise slow-op warnings (the
`osd_op_complaint_time` discipline).

Tail-exemplar retention (the tracing layer's retention policy): ops
whose duration breaches `osd_op_complaint_time` OR the tracker's own
rolling p99 keep their FULL span tree + critical-path breakdown — in
the historic entry (dump_historic_ops shows the per-stage self-times)
and in a bounded by-trace-id ring served by `dump_op_trace`.  Head
sampling can be 0 and the tail still explains itself.

Locking: the admin-socket serve THREAD dumps while the event loop
mutates — every structural OR per-op mutation (create/mark/finish/
check_slow's warned flip) takes `_lock`, so a dump can never observe
a half-updated event list or double-count slow ops.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

log = logging.getLogger("osd")

#: how many tail-exemplar traces the by-trace-id ring keeps
EXEMPLAR_CAP = 32

#: rolling-p99 warmup: below this many completed ops the percentile
#: estimate is noise, so only the complaint threshold gates retention
P99_MIN_SAMPLES = 100


class TrackedOp:
    __slots__ = ("description", "start", "events", "warned",
                 "duration", "trace")

    def __init__(self, description: str):
        self.description = description
        self.start = time.monotonic()
        self.events: List[tuple] = [(self.start, "initiated")]
        self.warned = False
        self.duration: Optional[float] = None  # set at finish
        # tail exemplar: {"trace_id", "critical_path", "spans"} for
        # ops retained by the tail policy, else None
        self.trace: Optional[Dict[str, Any]] = None

    def mark(self, event: str) -> None:
        self.events.append((time.monotonic(), event))

    def age(self) -> float:
        return time.monotonic() - self.start

    def dump(self) -> Dict[str, Any]:
        out = {
            "description": self.description,
            "age": round(self.age(), 6),
            "duration": round(self.events[-1][0] - self.start, 6),
            "events": [{"time": round(t - self.start, 6), "event": e}
                       for t, e in self.events],
        }
        if self.trace is not None:
            out["trace_id"] = self.trace.get("trace_id", "")
            cp = self.trace.get("critical_path") or {}
            out["stages_us"] = dict(cp.get("stages", {}))
        return out


class OpTracker:
    """Bounded registry: live ops by id + a historic ring of completed
    ops (osd_op_history_size role) + the tail-exemplar trace ring."""

    def __init__(self, history_size: int = 20,
                 complaint_time: float = 30.0,
                 who: str = "osd"):
        self._live: Dict[int, TrackedOp] = {}
        self._seq = 0
        self._history: deque = deque(maxlen=history_size)
        self.complaint_time = complaint_time
        self.who = who
        self.slow_ops = 0  # lifetime count of ops that breached
        self.ops_total = 0  # lifetime ops created
        self._lock = threading.Lock()
        # rolling op-duration histogram: the p99 the tail-exemplar
        # policy compares against (constant memory, loadgen/stats.py)
        from ceph_tpu_torch.loadgen.stats import LatencyHistogram

        self._durations = LatencyHistogram()
        # trace_id (hex) -> exemplar doc; LRU-bounded
        self._exemplars: "OrderedDict[str, Dict[str, Any]]" = \
            OrderedDict()
        self.tail_exemplars = 0  # lifetime retained

    def create(self, description: str) -> int:
        with self._lock:
            self._seq += 1
            self.ops_total += 1
            self._live[self._seq] = TrackedOp(description)
            return self._seq

    def mark(self, op_id: int, event: str) -> None:
        with self._lock:
            op = self._live.get(op_id)
            if op is not None:
                op.mark(event)

    def finish(self, op_id: int,
               event: str = "done") -> Optional[TrackedOp]:
        """Retire a live op into the historic ring; returns the op (its
        `duration` now set, fed to the rolling histogram) so the
        caller can decide tail retention."""
        with self._lock:
            op = self._live.pop(op_id, None)
            if op is not None:
                op.mark(event)
                op.duration = op.events[-1][0] - op.start
                self._durations.record(op.duration)
                self._history.append(op)
            return op

    # -- tail-exemplar policy ---------------------------------------------

    def is_tail(self, duration: Optional[float]) -> bool:
        """Does this completed op belong to the tail worth explaining?
        True past `osd_op_complaint_time`, or past the rolling p99
        once enough samples exist for the estimate to mean anything."""
        if duration is None:
            return False
        if duration >= self.complaint_time:
            return True
        with self._lock:
            if self._durations.count < P99_MIN_SAMPLES:
                return False
            p99 = self._durations.percentile(0.99)
        return p99 is not None and duration >= p99

    def retain_trace(self, op: TrackedOp,
                     doc: Dict[str, Any]) -> None:
        """Attach a tail exemplar ({"trace_id", "critical_path",
        "spans"}) to a finished op and index it by trace id for
        dump_op_trace.  The historic ring holds the same doc, so
        dump_historic_ops shows the per-stage breakdown."""
        with self._lock:
            op.trace = doc
            tid = doc.get("trace_id", "")
            if tid:
                self._exemplars[tid] = doc
                self._exemplars.move_to_end(tid)
                while len(self._exemplars) > EXEMPLAR_CAP:
                    self._exemplars.popitem(last=False)
            self.tail_exemplars += 1

    def get_trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            doc = self._exemplars.get(trace_id)
            if doc is not None:
                self._exemplars.move_to_end(trace_id)
            return doc

    def exemplar_ids(self) -> List[str]:
        with self._lock:
            return list(self._exemplars)

    # -- slow-op warnings --------------------------------------------------

    def check_slow(self) -> List[TrackedOp]:
        """Warn once per op that breaches the complaint threshold
        (the OpTracker check_ops_in_flight role).  The warned flip and
        the slow_ops count happen UNDER the lock — an admin-thread
        dump racing this loop sees each op counted exactly once."""
        slow = []
        with self._lock:
            for op in self._live.values():
                if not op.warned and op.age() > self.complaint_time:
                    op.warned = True
                    self.slow_ops += 1
                    slow.append(op)
        for op in slow:  # logging outside the lock
            log.warning("%s: slow op (%.1fs >= %.1fs): %s",
                        self.who, op.age(), self.complaint_time,
                        op.description)
        return slow

    # -- dump surfaces -----------------------------------------------------

    def dump_in_flight(self) -> Dict[str, Any]:
        with self._lock:
            ops = [op.dump() for op in list(self._live.values())]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic(self) -> Dict[str, Any]:
        with self._lock:
            ops = [op.dump() for op in list(self._history)]
        return {"num_ops": len(ops), "ops": ops,
                "slow_ops_total": self.slow_ops}

    def perf(self) -> Dict[str, Any]:
        """Numeric perf-dump section: lifetime op count, the in-flight
        gauge, slow-op/exemplar totals, and the rolling latency marks
        the tail policy uses."""
        with self._lock:
            p99 = self._durations.percentile(0.99)
            return {
                "ops_total": self.ops_total,
                "ops_in_flight": len(self._live),
                "slow_ops": self.slow_ops,
                "tail_exemplars": self.tail_exemplars,
                "exemplars_held": len(self._exemplars),
                "complaint_time_s": self.complaint_time,
                "rolling_p99_ms": round(p99 * 1e3, 3)
                if p99 is not None else 0.0,
            }
