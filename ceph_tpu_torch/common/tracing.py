"""Trace spans: what `child_span_sync` reaches (port of the part of
ceph_tpu/common/tracing.py that the store uses).

TPUStore wraps its two durability barriers, the block-file fsync and the
KV commit, in `child_span_sync("fsync")` and `child_span_sync("kv_commit")`.
A span is recorded only under a current span (the `current_span`
contextvar, set by whoever traces an op); untraced, the helper yields
`NULL_SPAN` and costs one contextvar read.  The Tracer, the wire
propagation, the critical-path reducer and the async helpers wait for the
daemon slice.
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import secrets
import time
from typing import Any, Dict, Optional

__all__ = ["NULL_SPAN", "Span", "child_span_sync", "current_span"]

# the span the running task is working under — context propagates per
# asyncio task
current_span: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("ceph_tpu_torch_current_span", default=None)

#: per-trace span-tree bound: a runaway fan-out must not turn one op's
#: trace into an unbounded buffer (overflow spans are counted, dropped)
TREE_CAP = 512


# span/trace ids need uniqueness, not unpredictability — a PRNG
# seeded once from the CSPRNG is an order of magnitude cheaper per id
# than os.urandom, and ids are minted on the op hot path
_rand = random.Random(secrets.randbits(64))


def _id64() -> int:
    return _rand.getrandbits(63) | 1  # nonzero


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name",
                 "service", "start", "end", "attrs", "sampled", "_t0",
                 "_end", "_tree", "_dropped")

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
        self.attrs: Dict[str, Any] = {}
        self.sampled = sampled
        # the local trace buffer, owned by the local root and shared
        # by every descendant created through child()
        self._tree: list = tree if tree is not None else [self]
        self._dropped = 0

    def __bool__(self) -> bool:
        return True

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


class _NullSpan:
    """The untraced twin: a child of it is itself, finish() is a no-op,
    bool() is False so call sites can gate on `if span:`."""

    __slots__ = ()
    trace_id = 0
    span_id = 0
    parent_id = 0
    name = ""
    service = ""
    sampled = False
    start = 0.0
    end = None
    attrs: dict = {}
    duration_s = 0.0

    def __bool__(self) -> bool:
        return False

    def child(self, name: str, **attrs: Any) -> "_NullSpan":
        return self

    def finish(self) -> None:
        pass


NULL_SPAN = _NullSpan()


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
