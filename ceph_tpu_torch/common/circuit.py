"""Closed/open/half-open circuit breaker (port of the `CircuitBreaker`
class and its state constants from ceph_tpu/common/circuit.py).

The OSD's hedged reads keep one breaker per peer (`osd/hedge.py`): a peer
that keeps failing sub-reads is ranked last until a probe succeeds.  The
reference module also guards device dispatch with breakers (`device_call`,
the family registry, fault injection); the port has no device guard — a
launch runs or raises — so none of that is here.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict

from ceph_tpu_torch.common import flags

__all__ = ["CLOSED", "OPEN", "HALF_OPEN", "CircuitBreaker"]

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


def _env_float(name: str, default: float) -> float:
    try:
        return flags.flag_float(name, default)
    except ValueError:
        return default


class CircuitBreaker:
    """Closed/open/half-open breaker for one peer.

    closed    requests flow; `fail_threshold` CONSECUTIVE failures
              (or one timeout) trip it open.
    open      the peer reads as degraded (ranked last) until the
              backoff expires; the backoff doubles per trip
              with full jitter, capped at `max_backoff`.
    half_open exactly ONE probe dispatch is admitted; success
              re-closes the breaker (and resets the backoff), failure
              re-opens it with the next backoff step.  Concurrent
              callers while the probe is in flight are refused.
    """

    __slots__ = ("family", "fail_threshold", "base_backoff",
                 "max_backoff", "_clock", "_rng", "_lock", "_state",
                 "_retry_at", "_opens", "_probing", "counters")

    def __init__(self, family: str, fail_threshold: int = None,
                 base_backoff: float = None, max_backoff: float = None,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Callable[[], float] = random.random):
        self.family = family
        self.fail_threshold = int(
            fail_threshold if fail_threshold is not None
            else _env_float("CEPH_TPU_BREAKER_THRESHOLD", 3))
        self.base_backoff = float(
            base_backoff if base_backoff is not None
            else _env_float("CEPH_TPU_BREAKER_BACKOFF_S", 0.5))
        self.max_backoff = float(
            max_backoff if max_backoff is not None
            else _env_float("CEPH_TPU_BREAKER_BACKOFF_MAX_S", 30.0))
        self._clock = clock
        self._rng = rng
        self._lock = threading.Lock()
        self._state = CLOSED
        self._retry_at = 0.0
        self._opens = 0          # consecutive opens: the backoff exponent
        self._probing = False
        self.counters: Dict[str, int] = {
            "successes": 0, "failures": 0, "consecutive": 0,
            "trips": 0, "probes": 0, "recoveries": 0,
            "watchdog_timeouts": 0,
        }

    # -- state machine -----------------------------------------------------

    def allow(self) -> bool:
        """Admission check — MUTATING: an open breaker whose backoff
        expired transitions to half-open and hands THIS caller the
        probe slot.  Use `degraded()` for a read-only peek."""
        with self._lock:
            if self._state == CLOSED:
                return True
            now = self._clock()
            if self._state == OPEN and now >= self._retry_at:
                self._state = HALF_OPEN
                self._probing = True
                self.counters["probes"] += 1
                return True
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                self.counters["probes"] += 1
                return True
            return False

    def degraded(self) -> bool:
        """Read-only: True while requests would be refused (open
        with an unexpired backoff, or a probe already in flight)."""
        with self._lock:
            if self._state == CLOSED:
                return False
            if self._state == HALF_OPEN:
                return self._probing
            return self._clock() < self._retry_at

    def record_success(self) -> None:
        with self._lock:
            self.counters["successes"] += 1
            self.counters["consecutive"] = 0
            if self._state != CLOSED:
                self.counters["recoveries"] += 1
            self._state = CLOSED
            self._probing = False
            self._opens = 0

    def record_failure(self, timeout: bool = False) -> None:
        with self._lock:
            self.counters["failures"] += 1
            self.counters["consecutive"] += 1
            if timeout:
                self.counters["watchdog_timeouts"] += 1
            if self._state == HALF_OPEN:
                self._trip_locked()       # failed probe: back off more
            elif self._state == CLOSED and (
                    timeout
                    or self.counters["consecutive"]
                    >= self.fail_threshold):
                self._trip_locked()

    def _trip_locked(self) -> None:
        self.counters["trips"] += 1
        self._state = OPEN
        self._probing = False
        self._opens += 1
        # full jitter (AWS style): U(0, min(cap, base * 2^(opens-1))).
        # Uniform-from-zero is deliberate — a fleet of breakers tripped
        # by one cluster-wide event must not probe in lockstep.
        ceiling = min(self.max_backoff,
                      self.base_backoff * (2 ** (self._opens - 1)))
        self._retry_at = self._clock() + self._rng() * ceiling

    # -- observability -----------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            now = self._clock()
            return {
                "state": self._state,
                "state_code": _STATE_CODE[self._state],
                "retry_in_s": round(max(self._retry_at - now, 0.0), 3)
                if self._state == OPEN else 0.0,
                **self.counters,
            }

