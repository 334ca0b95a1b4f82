"""Distributed tracing spans (the blkin/zipkin role) + critical-path
attribution (port of ceph_tpu/common/tracing.py).

Reference parity: the reference's src/blkin/ + the OSD/Messenger
tracepoints behind `osd_blkin_trace_all` — a client op carries a trace
context across the wire; every daemon it touches contributes spans
(parent-linked, timestamped, annotated) so one request's journey
(client -> primary -> replica sub-ops) reconstructs as a tree.  The
reference emits LTTng events consumed by an external zipkin collector;
this build keeps spans IN the daemons (bounded ring per Tracer) and
exposes them over the admin-socket/tell surface (`dump_traces`), which
fits the single-binary deployment the way the asok perf dump does.

Propagation: a (trace_id, span_id) pair rides in MOSDOp / MOSDSubWrite
/ MOSDSubRead / MOSDSubCompute (versioned tail fields — untraced
peers skip them).

Stage names are a span's first whitespace token (`stage_of`): the
pipeline seams emit `admission`, `queue.<class>`, `objlock`,
`encode_wait`/`encode_flush`, `subread osd.N` / `subwrite osd.N`,
`kv_commit_wait`/`fsync`, and the coded-compute workload adds
`compute_op` (the scan op root), `subcompute osd.N` (per-peer
hedged sub-compute flights) and `compute ...` (kernel evaluation /
result-domain decode) — each workload class gets its own rows in
the stage histograms.
Inside a daemon the active span travels by contextvar, so nested sends
(the primary's sub-ops fanned out under the op task) attach the right
parent without threading a span through every call signature.

Clock discipline: every DURATION comes from `time.monotonic()` — an
NTP step mid-span must not corrupt latencies — while each span keeps
ONE wall-clock anchor (`start`) captured at creation for display.
Events record monotonic offsets from the span start.

Critical-path analysis: `critical_path(spans)` walks a finished span
tree backward from the root's end and attributes every instant of the
op's wall time to exactly one span — the LATEST-ENDING overlapping
child owns its interval (recursively), the gaps are the parent's
self-time.  Children annotated `cancelled` (hedged stragglers cut
loose at early completion) are real work but NOT on the path: the op
never waited for them.  Per-stage self-times aggregate into bounded
log-bucket streaming histograms (loadgen/stats.py LatencyHistogram),
surfaced as the `trace` perf-dump section and prometheus
`ceph_osd_trace_stage_*` rows.

Sampling: head-based for the bulk — a locally-rooted trace is RETAINED
in the ring with probability `sample_rate`; a trace arriving with a
wire context inherits its parent's (already made) decision.  Retention
is separate from existence: spans are still built for unsampled ops so
the per-stage histograms see every op and the TAIL can keep its full
tree (the OpTracker exemplar ring) even at sample rate 0.

Kill switch: CEPH_TPU_TRACE=0 (env, re-read per trace) or constructing
the Tracer with enabled=False makes `start()` return the NULL_SPAN
singleton — every downstream annotation is a no-op attribute lookup.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import random
import os

from ceph_tpu_torch.common import flags
import secrets
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "NULL_SPAN", "Span", "Tracer", "child_span", "child_span_sync",
    "critical_path", "critical_path_spans", "current_span",
    "env_enabled", "event", "stage_of", "start_child",
]

# the span the running task is working under (primary op execution
# sets it; sub-op sends read it) — context propagates per asyncio task
current_span: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("ceph_tpu_torch_current_span", default=None)

#: per-trace span-tree bound: a runaway fan-out must not turn one op's
#: trace into an unbounded buffer (overflow spans are counted, dropped)
TREE_CAP = 512


def env_enabled() -> bool:
    return flags.enabled("CEPH_TPU_TRACE")


# span/trace ids need uniqueness, not unpredictability — a PRNG
# seeded once from the CSPRNG is an order of magnitude cheaper per id
# than os.urandom, and ids are minted on the op hot path
_rand = random.Random(secrets.randbits(64))


def _id64() -> int:
    return _rand.getrandbits(63) | 1  # nonzero


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name",
                 "service", "start", "end", "events", "attrs",
                 "links", "sampled", "_t0", "_end", "_tree",
                 "_dropped")

    def __init__(self, trace_id: int, span_id: int, parent_id: int,
                 name: str, service: str, sampled: bool = True,
                 tree: Optional[list] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.service = service
        # wall-clock anchor (display only): one syscall per trace —
        # children derive theirs from the root's in child()
        self.start = time.time() if tree is None else 0.0
        self._t0 = time.monotonic()     # duration source
        self._end: Optional[float] = None
        self.end: Optional[float] = None  # wall end (display only)
        # events / links allocate lazily: most spans on the hot path
        # carry neither, and three empty containers per span add up
        self.events: Optional[List[Tuple[float, str]]] = None
        self.attrs: Dict[str, Any] = {}
        # span links: contexts this span SERVED without parenting them
        # (one batched device dispatch serving N ops' encodes)
        self.links: Optional[List[Tuple[int, int]]] = None
        self.sampled = sampled
        # the local trace buffer, owned by the local root and shared
        # by every descendant created through child()
        self._tree: list = tree if tree is not None else [self]
        self._dropped = 0

    def __bool__(self) -> bool:
        return True

    def event(self, what: str) -> None:
        if self.events is None:
            self.events = []
        self.events.append((time.monotonic() - self._t0, what))

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def link(self, context: Optional[Tuple[int, int]]) -> None:
        if context is not None:
            if self.links is None:
                self.links = []
            self.links.append((int(context[0]), int(context[1])))

    def child(self, name: str, **attrs: Any) -> "Span":
        """A child span in the same local tree (bounded): the in-daemon
        complement of start(context=...) for spans that never cross
        the wire."""
        sp = Span(self.trace_id, _id64(), self.span_id, name,
                  self.service, sampled=self.sampled, tree=self._tree)
        root = self._tree[0]
        # derive the wall anchor from the root's (one time.time() per
        # TRACE, not per span — children are on the op hot path)
        sp.start = root.start + (sp._t0 - root._t0)
        if attrs:
            sp.attrs.update(attrs)
        if len(self._tree) < TREE_CAP:
            self._tree.append(sp)
        else:
            root._dropped += 1
        return sp

    def finish(self) -> None:
        if self._end is None:
            self._end = time.monotonic()
            self.end = self.start + (self._end - self._t0)

    @property
    def duration_s(self) -> float:
        return (self._end if self._end is not None
                else time.monotonic()) - self._t0

    @property
    def context(self) -> Optional[Tuple[int, int]]:
        """What goes on the wire: (trace_id, my span id)."""
        return (self.trace_id, self.span_id)

    def to_dict(self) -> Dict[str, Any]:
        root = self._tree[0]
        out = {"trace_id": f"{self.trace_id:016x}",
               "span_id": f"{self.span_id:016x}",
               "parent_id": f"{self.parent_id:016x}"
                            if self.parent_id else "",
               "name": self.name, "service": self.service,
               "start": self.start,
               # offset from the local root's start: what the
               # critical-path reducer orders by (monotonic-derived,
               # NTP-step immune)
               "t0_us": int((self._t0 - root._t0) * 1e6),
               "duration_us": int(self.duration_s * 1e6),
               "events": [{"t": self.start + dt,
                           "offset_us": int(dt * 1e6), "what": w}
                          for dt, w in (self.events or ())]}
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.links:
            out["links"] = [f"{t:016x}/{s:016x}" for t, s in self.links]
        return out

    def tree_dicts(self) -> List[Dict[str, Any]]:
        """The local span tree (roots only own one), dict-rendered."""
        out = [sp.to_dict() for sp in self._tree]
        if self._dropped:
            out[0].setdefault("attrs", {})["dropped_spans"] = \
                self._dropped
        return out


class _NullSpan:
    """The disabled-tracing twin: every annotation is a no-op, the
    wire context is None (nothing propagates), bool() is False so
    call sites can gate on `if span:`."""

    __slots__ = ()
    trace_id = 0
    span_id = 0
    parent_id = 0
    name = ""
    service = ""
    sampled = False
    start = 0.0
    end = None
    events: list = []
    attrs: dict = {}
    links: list = []
    duration_s = 0.0
    context = None

    def __bool__(self) -> bool:
        return False

    def event(self, what: str) -> None:
        pass

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def link(self, context) -> None:
        pass

    def child(self, name: str, **attrs: Any) -> "_NullSpan":
        return self

    def finish(self) -> None:
        pass

    def to_dict(self) -> Dict[str, Any]:
        return {}

    def tree_dicts(self) -> List[Dict[str, Any]]:
        return []


NULL_SPAN = _NullSpan()


def start_child(name: str, **attrs: Any):
    """Child of the task's current span, or NULL_SPAN when untraced.
    Caller owns finish() — prefer child_span()/child_span_sync() which
    finish on every path."""
    parent = current_span.get()
    if parent is None or not parent:
        return NULL_SPAN
    return parent.child(name, **attrs)


def event(what: str) -> None:
    """Annotate the current span (no-op when untraced): the cheap
    seam for leaf layers (tier hit/miss, breaker outcomes) that must
    not depend on a Tracer."""
    span = current_span.get()
    if span is not None:
        span.event(what)


@contextlib.asynccontextmanager
async def child_span(name: str, **attrs: Any):
    """Async stage-span helper: child of the current span, installed
    as current for the body, finished on EVERY path.  Cancellation is
    annotated (`cancelled` attr + event) — the critical-path reducer
    keeps cancelled spans off the path."""
    parent = current_span.get()
    if parent is None or not parent:
        yield NULL_SPAN
        return
    span = parent.child(name, **attrs)
    token = current_span.set(span)
    try:
        yield span
    except asyncio.CancelledError:
        span.set_attr("cancelled", True)
        span.event("cancelled")
        raise
    finally:
        current_span.reset(token)
        span.finish()


@contextlib.contextmanager
def child_span_sync(name: str, **attrs: Any):
    """Sync twin of child_span for non-async seams (store commits,
    scheduler internals) running on the op task's context."""
    parent = current_span.get()
    if parent is None or not parent:
        yield NULL_SPAN
        return
    span = parent.child(name, **attrs)
    token = current_span.set(span)
    try:
        yield span
    finally:
        current_span.reset(token)
        span.finish()


# ---------------------------------------------------------------------------
# Critical-path attribution
# ---------------------------------------------------------------------------


def stage_of(name: str) -> str:
    """Stage key of a span name: the first whitespace token
    ('subread osd.3' -> 'subread')."""
    return name.split(" ", 1)[0] if name else "unknown"


def _cp_walk(rec: tuple, lo: int, hi: int,
             kids: Dict[Any, list], stages: Dict[str, int],
             path: Optional[List[Dict[str, Any]]],
             depth: int) -> None:
    """Attribute [lo, hi) of a span's interval: walk backward from hi,
    hand each stretch to the latest-ending overlapping non-cancelled
    child, keep the gaps as this span's self-time.  rec is the
    normalized (span_id, name, t0_us, dur_us) tuple."""
    children = []
    for c in kids.get(rec[0], ()):
        c0, c1 = max(c[2], lo), min(c[2] + c[3], hi)
        if c1 > c0:
            children.append((c0, c1, c))
    cursor = hi
    self_us = 0
    while children and cursor > lo:
        live = [(c0, min(c1, cursor), c)
                for c0, c1, c in children if c0 < cursor]
        live = [t for t in live if t[1] > t[0]]
        if not live:
            break
        c0, c1, c = max(live, key=lambda t: (t[1], t[0]))
        self_us += cursor - c1
        _cp_walk(c, c0, c1, kids, stages, path, depth + 1)
        cursor = c0
        children = [e for e in children if e[2] is not c]
    self_us += max(cursor - lo, 0)
    st = stage_of(rec[1])
    stages[st] = stages.get(st, 0) + self_us
    if path is not None:
        path.append({"name": rec[1], "stage": st, "depth": depth,
                     "self_us": self_us, "span_us": hi - lo})


def _cp_reduce(recs: List[tuple], want_path: bool) -> Dict[str, Any]:
    """Shared reducer body over normalized (span_id, name, t0_us,
    dur_us, parent_id, cancelled) records."""
    by_id = {r[0] for r in recs}
    kids: Dict[Any, list] = {}
    roots = []
    for r in recs:
        if r[5]:
            continue  # cancelled: ran, but the op never waited for it
        if r[4] and r[4] in by_id:
            kids.setdefault(r[4], []).append(r)
        else:
            roots.append(r)
    if not roots:
        return {"total_us": 0, "stages": {}, "path": []}
    root = min(roots, key=lambda r: r[2])
    lo, hi = root[2], root[2] + root[3]
    stages: Dict[str, int] = {}
    path: Optional[List[Dict[str, Any]]] = [] if want_path else None
    _cp_walk(root, lo, hi, kids, stages, path, 0)
    if path is not None:
        path.reverse()  # the walk appends leaves-first
    return {"total_us": hi - lo, "stages": stages,
            "path": path if path is not None else []}


def critical_path(spans: Iterable[Dict[str, Any]],
                  want_path: bool = True) -> Dict[str, Any]:
    """Per-stage self-time on the critical path of one finished span
    tree (to_dict shape: span_id/parent_id/t0_us/duration_us/attrs).

    Walks backward from the root's end: at every instant the op was
    waiting on exactly one span — the latest-ending overlapping child
    (recursively), or the parent itself in the gaps.  Parallel hedged
    children therefore attribute to the LONGEST child; a cancelled
    straggler (attrs.cancelled) is excluded — it ran, but nothing
    waited for it.  Returns {"total_us", "stages": {stage: self_us},
    "path": [{name, stage, depth, self_us, span_us}, ...]} with the
    path listed root-first (empty when want_path=False)."""
    recs = [(s["span_id"], s.get("name", ""), s.get("t0_us", 0),
             s.get("duration_us", 0), s.get("parent_id") or "",
             bool((s.get("attrs") or {}).get("cancelled")))
            for s in spans if s]
    return _cp_reduce(recs, want_path)


def critical_path_spans(root: Span,
                        want_path: bool = False) -> Dict[str, Any]:
    """The hot-path twin of critical_path: reduces a live Span tree
    WITHOUT rendering dicts (per-op overhead at sample rate 0 is this
    function plus span bookkeeping — keep it allocation-light)."""
    if not root:
        return {"total_us": 0, "stages": {}, "path": []}
    t0 = root._t0
    recs = []
    for s in root._tree:
        recs.append((s.span_id, s.name,
                     int((s._t0 - t0) * 1e6),
                     int(s.duration_s * 1e6),
                     s.parent_id,
                     bool(s.attrs.get("cancelled"))))
    return _cp_reduce(recs, want_path)


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------

#: bound on distinct stage histograms per tracer: stage names come
#: from span names (first token), which are code-controlled — the cap
#: is a backstop against an attr leaking into a name
STAGE_CAP = 64

# lazily bound loadgen.stats.LatencyHistogram (loadgen pulls in the
# rados stack; the tracer must stay importable from anywhere)
_LatencyHistogram = None


class Tracer:
    """Per-daemon span collector: bounded ring, head sampling,
    per-stage critical-path histograms, admin-socket dump."""

    def __init__(self, service: str, max_spans: int = 2048,
                 sample_rate: float = 1.0, enabled: bool = True):
        self.service = service
        self._done: deque = deque(maxlen=max_spans)
        self.sample_rate = float(sample_rate)
        self._enabled = bool(enabled)
        # per-stage critical-path self-time histograms (bounded
        # log-bucket, constant memory — loadgen/stats.py)
        self.stage_hist: Dict[str, Any] = {}
        self.counters: Dict[str, int] = {
            "traces": 0, "spans_retained": 0, "stage_samples": 0}
        # the admin-socket serve THREAD dumps (dump_traces/perf dump)
        # while the event loop appends: structural mutations of the
        # ring and the stage map take this lock, as do their snapshots
        # (in-place histogram increments are read-torn at worst)
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        # env re-read per trace: the kill switch takes effect without
        # rebuilding daemons
        return self._enabled and env_enabled()

    @enabled.setter
    def enabled(self, value: bool) -> None:
        self._enabled = bool(value)

    def start(self, name: str,
              context: Optional[Tuple[int, int]] = None,
              sampled: Optional[bool] = None) -> Span:
        """New local-root span: child of `context` ((trace_id,
        parent_span_id) from the wire or a local parent's .context),
        or a fresh root trace when context is None.  A wire context
        inherits the sender's sampling decision; a fresh root samples
        at `sample_rate` — unsampled spans are still BUILT (stage
        histograms and tail exemplars need them), just not retained in
        the ring.  NULL_SPAN when tracing is off."""
        if not self.enabled:
            return NULL_SPAN
        if context is not None:
            trace_id, parent = int(context[0]), int(context[1])
            if sampled is None:
                sampled = True
        else:
            trace_id, parent = _id64(), 0
            if sampled is None:
                sampled = (self.sample_rate > 0.0
                           and _rand.random() < self.sample_rate)
        self.counters["traces"] += 1
        return Span(trace_id, _id64(), parent, name, self.service,
                    sampled=bool(sampled))

    def finish(self, span: Span
               ) -> Optional[List[Dict[str, Any]]]:
        """Finish a local root: its whole tree lands in the ring when
        sampled (children finished via child_span land with it).
        Returns the rendered tree when one was built — callers that
        also need the dicts (the tail-exemplar hook) reuse it instead
        of rendering twice."""
        if not span:
            return None
        span.finish()
        if not span.sampled:
            return None
        tree = span.tree_dicts()
        self.counters["spans_retained"] += len(tree)
        with self._lock:
            self._done.extend(tree)
        return tree

    @contextlib.asynccontextmanager
    async def span(self, name: str,
                   context: Optional[Tuple[int, int]] = None,
                   sampled: Optional[bool] = None,
                   set_current: bool = True):
        """Root-span context manager: start + install as current +
        finish on every path — the idiomatic fix for the span-leak
        lint rule."""
        sp = self.start(name, context=context, sampled=sampled)
        token = current_span.set(sp) if (set_current and sp) else None
        try:
            yield sp
        finally:
            if token is not None:
                current_span.reset(token)
            self.finish(sp)

    def record_stages(self, stages: Dict[str, int]) -> None:
        """Feed one op's critical-path decomposition (stage -> micro-
        seconds of self-time) into the streaming histograms."""
        global _LatencyHistogram
        if _LatencyHistogram is None:  # lazy: loadgen imports rados
            from ceph_tpu_torch.loadgen.stats import LatencyHistogram

            _LatencyHistogram = LatencyHistogram
        for stage, us in stages.items():
            h = self.stage_hist.get(stage)
            if h is None:
                with self._lock:   # structural insert vs dump snapshot
                    if len(self.stage_hist) >= STAGE_CAP:
                        continue
                    h = self.stage_hist.setdefault(
                        stage, _LatencyHistogram())
            h.record(us / 1e6)
            self.counters["stage_samples"] += 1

    def stage_perf(self) -> Dict[str, Any]:
        """Per-stage nested perf section: the streaming histogram in
        prometheus {bounds, buckets, count, sum} shape plus p50/p99
        gauges (the flattener renders ceph_osd_trace_stage_* rows)."""
        out: Dict[str, Any] = {}
        with self._lock:
            items = sorted(self.stage_hist.items())
        for stage, h in items:
            p50, p99 = h.percentile(0.5), h.percentile(0.99)
            out[stage] = {
                "self_seconds": h.to_perf_histogram(),
                "count": h.count,
                "p50_ms": round(p50 * 1e3, 3) if p50 is not None
                else 0.0,
                "p99_ms": round(p99 * 1e3, 3) if p99 is not None
                else 0.0,
            }
        return out

    def dump(self, trace_id: Optional[int] = None) -> List[Dict]:
        with self._lock:
            out = list(self._done)
        if trace_id is not None:
            want = f"{trace_id:016x}"
            out = [s for s in out if s["trace_id"] == want]
        return out
