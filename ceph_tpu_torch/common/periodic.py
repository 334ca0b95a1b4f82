"""Shared start/stop plumbing for background one-tick daemons (port of
ceph_tpu/common/periodic.py).

The mirror/sync agents (rbd-mirror, cephfs-mirror, rgw multisite) all
run the same shape: a loop that calls one idempotent tick, logs and
survives tick failures, and sleeps interruptibly until stopped.  One
implementation here so the next backoff or shutdown-ordering fix lands
everywhere at once."""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

log = logging.getLogger("periodic")


class PeriodicDaemon:
    """Mixin: subclasses implement `_tick()` (one idempotent pass) and
    may set `_tick_what` for log lines."""

    _tick_what: str = "tick"
    _task: Optional[asyncio.Task] = None
    _stop_evt: Optional[asyncio.Event] = None

    async def _tick(self) -> None:
        raise NotImplementedError

    async def start(self, interval: float = 1.0) -> None:
        self._stop_evt = asyncio.Event()
        stop = self._stop_evt

        async def loop():
            while not stop.is_set():
                try:
                    await self._tick()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    log.exception("%s failed; retrying",
                                  self._tick_what)
                try:
                    await asyncio.wait_for(stop.wait(), interval)
                except asyncio.TimeoutError:
                    pass

        self._task = asyncio.get_running_loop().create_task(loop())

    async def stop(self) -> None:
        if self._stop_evt is not None:
            self._stop_evt.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
