"""lockdep: lock-order inversion detection for the asyncio runtime (port of
ceph_tpu/common/lockdep.py).

Reference parity: the reference's src/common/lockdep.cc — every lock
acquisition records "B taken while holding A" edges in a global order
graph; an acquisition that would close a cycle is a potential deadlock
and is reported at ACQUISITION time, long before any real interleaving
hits it.

Why this framework needs less than pthread lockdep — the in-tree
argument for §5.2 (race detection): every daemon runs ONE asyncio event
loop, so data races on plain Python state are impossible — state only
changes at explicit `await` points, and all mutual exclusion is
asyncio.Lock-shaped.  The remaining hazard class is therefore exactly
lock-order deadlock between coroutines (plus the slot/lock coupling
documented at the QoS scheduler), which this module detects.

Model: lock CLASSES, not instances (as in the reference) — the object
lock of obj-1 and obj-2 are the same class.  Same-class nesting is
allowed (the recovery wave legally holds many object locks via
independent subtasks; a single task re-entering the same class is the
caller's documented discipline).  Cross-class cycles are flagged.

Enabled via CEPH_TPU_LOCKDEP=1 (tests) — the hooks are no-ops
otherwise, so the production path pays one attribute check.
"""

from __future__ import annotations

import asyncio
import logging
import os

from ceph_tpu_torch.common import flags
import weakref
from typing import Dict, List, Optional, Set

log = logging.getLogger("lockdep")

enabled = flags.get("CEPH_TPU_LOCKDEP") == "1"

# class -> classes acquired while holding it
_edges: Dict[str, Set[str]] = {}
# task -> stack of held lock classes.  Keyed by the Task OBJECT under
# a weak reference, never id(task): a task that dies with entries on
# its stack (legal — see _ObjLockCtx's cross-task handoff in the OSD
# recovery wave) must not bequeath phantom "held" locks to a later
# task that happens to recycle its id, which would fabricate order
# edges between locks no task ever nested.
_held: "weakref.WeakKeyDictionary[asyncio.Task, List[str]]" = \
    weakref.WeakKeyDictionary()


class LockOrderInversion(Exception):
    """Acquiring this lock class here can deadlock: the reverse order
    is already on record."""


def _reachable(src: str, dst: str) -> bool:
    seen: Set[str] = set()
    stack = [src]
    while stack:
        node = stack.pop()
        if node == dst:
            return True
        if node in seen:
            continue
        seen.add(node)
        stack.extend(_edges.get(node, ()))
    return False


def acquire(cls: str) -> Optional[asyncio.Task]:
    """Record an acquisition of lock class `cls` by the current task;
    raises LockOrderInversion on a would-be cycle.  Returns the task
    whose stack recorded it, for callers that may release from a
    different task (pass it back to `release`)."""
    if not enabled:
        return None
    task = asyncio.current_task()
    if task is None:
        return None
    held = _held.get(task)
    if held is None:
        held = _held[task] = []
    for h in held:
        if h == cls:
            continue  # same-class nesting: allowed (see docstring)
        if cls not in _edges.get(h, ()):  # new edge h -> cls
            if _reachable(cls, h):
                order = " -> ".join(held + [cls])
                log.error("lockdep: ORDER INVERSION acquiring %s "
                          "while holding %s (existing order has "
                          "%s -> ... -> %s)", cls, held, cls, h)
                raise LockOrderInversion(order)
            _edges.setdefault(h, set()).add(cls)
    held.append(cls)
    return task


def release(cls: str, task: Optional[asyncio.Task] = None) -> None:
    """Drop `cls` from a task's held stack — by default the current
    task's; pass the task `acquire` returned when the releasing task
    differs from the acquiring one (lock handed across tasks)."""
    if not enabled:
        return
    if task is None:
        task = asyncio.current_task()
    if task is None:
        return
    held = _held.get(task)
    if held:
        try:
            held.reverse()
            held.remove(cls)
            held.reverse()
        except ValueError:
            pass
        if not held:
            _held.pop(task, None)


def reset() -> None:
    """Test hook: clear the global order graph."""
    _edges.clear()
    _held.clear()


async def _tracked_acquire(lock: asyncio.Lock,
                           cls: str) -> Optional[asyncio.Task]:
    """The one copy of the acquire pairing: record with lockdep, take
    the lock, un-record if the take itself fails (cancellation while
    queued).  Returns the recording task for cross-task release."""
    task = acquire(cls)
    try:
        await lock.acquire()
    except BaseException:
        release(cls, task)
        raise
    return task


class Lock(asyncio.Lock):
    """asyncio.Lock whose `async with` feeds the order graph under a
    fixed class name: `self._mutation_lock = lockdep.Lock("mds.mutation")`.
    The class string follows the static analyzer's labeling (module
    tail + attr name stripped of `_lock`), so runtime-observed edges
    line up 1:1 with ceph_tpu/analysis/lockgraph.py's graph."""

    def __init__(self, cls: str):
        super().__init__()
        self.lockdep_class = cls

    async def __aenter__(self):
        # enter/exit of one `async with` always run in the same task,
        # so the current-task release below is the right stack; no
        # per-entry state may live on self (a waiter queued inside
        # __aenter__ would race the holder's __aexit__)
        await _tracked_acquire(self, self.lockdep_class)
        return None

    async def __aexit__(self, *exc):
        self.release()
        release(self.lockdep_class)


class guard:
    """Async context manager pairing an asyncio.Lock with lockdep
    tracking: `async with lockdep.guard(lock, "mds.mutation"): ...`
    Single-use per instance; the instance remembers the acquiring
    task, so exiting from a different task releases correctly."""

    def __init__(self, lock: asyncio.Lock, cls: str):
        self._lock = lock
        self._cls = cls
        self._task: Optional[asyncio.Task] = None

    async def __aenter__(self):
        self._task = await _tracked_acquire(self._lock, self._cls)
        return self

    async def __aexit__(self, *exc):
        self._lock.release()
        release(self._cls, self._task)
