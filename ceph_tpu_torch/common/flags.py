"""Kill-switch registry: every ``CEPH_TPU_*`` toggle the port reads, in one
audited seam (port of ceph_tpu/common/flags.py).

Each flag is declared once with its default, its scope (whether a live flip
takes effect at once or only at the next start) and a one-line description.
Reads go through `get` / `enabled`, writes through `set_flag` / `clear`,
which fire the `on_flip` hooks and append to a bounded audit log.  The
backing store stays ``os.environ``, so flags inherit into subprocesses and
tests that set the environment directly keep working.  The variable names
are the JAX package's: they are the protocol.

The table declares the flags the port's modules read; later slices add
theirs as they port the code that reads them.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "register", "get", "enabled", "flag_float", "flag_int", "set_flag", "clear", "on_flip",
    "remove_hook", "flips", "clear_flips", "registry", "UnregisteredFlag",
]


class UnregisteredFlag(KeyError):
    """A flag name no `register()` call declared."""


class _Flag:
    __slots__ = ("name", "default", "scope", "desc")

    def __init__(self, name: str, default: Optional[str],
                 scope: str, desc: str):
        self.name = name
        self.default = default
        self.scope = scope
        self.desc = desc


_REGISTRY: Dict[str, _Flag] = {}
_HOOKS: List[Callable[[str, Optional[str], Optional[str]], None]] = []
_FLIPS: List[Dict[str, Any]] = []
_FLIPS_CAP = 4096
_lock = threading.Lock()
_UNSET = object()


def register(name: str, default: Optional[str] = None,
             scope: str = "process", desc: str = "") -> None:
    """Declare a flag.  Idempotent; re-registration with a different
    default is an error."""
    if scope not in ("process", "startup", "inject"):
        raise ValueError(f"unknown flag scope {scope!r}")
    with _lock:
        cur = _REGISTRY.get(name)
        if cur is not None:
            if cur.default != default:
                raise ValueError(
                    f"{name} re-registered with default {default!r}"
                    f" (was {cur.default!r})")
            return
        _REGISTRY[name] = _Flag(name, default, scope, desc)


def _flag(name: str) -> _Flag:
    f = _REGISTRY.get(name)
    if f is None:
        raise UnregisteredFlag(
            f"{name} is not in the kill-switch registry "
            "(ceph_tpu_torch/common/flags.py): register it there")
    return f


def get(name: str, default: Any = _UNSET) -> Optional[str]:
    """Raw string value: the environment override if present, else the
    call-site `default` if given, else the registered default.  Read on
    every call."""
    f = _flag(name)
    d = f.default if default is _UNSET else default
    return os.environ.get(name, d)


def enabled(name: str) -> bool:
    """On unless unset with a falsy default, empty, or ``"0"``."""
    return get(name) not in (None, "", "0")


def flag_float(name: str, default: Any = _UNSET) -> float:
    v = get(name, default)
    return float(v if v is not None else 0.0)


def flag_int(name: str, default: Any = _UNSET) -> int:
    v = get(name, default)
    # int("3.0") raises: go through float
    return int(float(v if v is not None else 0))


def _audit(name: str, old: Optional[str], new: Optional[str]) -> None:
    _FLIPS.append({"t": time.monotonic(), "flag": name,
                   "old": old, "new": new})
    del _FLIPS[:-_FLIPS_CAP]
    for hook in list(_HOOKS):
        try:
            hook(name, old, new)
        except Exception:
            # a broken observer must not turn a flip into an op failure
            pass


def set_flag(name: str, value: str) -> None:
    """Flip a flag: write the environment, record the flip, fire hooks."""
    f = _flag(name)
    with _lock:
        old = os.environ.get(name, f.default)
        os.environ[name] = str(value)
        _audit(name, old, str(value))


def clear(name: str) -> None:
    """Reset a flag to its registered default (drop the override)."""
    f = _flag(name)
    with _lock:
        old = os.environ.get(name)
        if old is None:
            return
        os.environ.pop(name, None)
        _audit(name, old, f.default)


def on_flip(hook: Callable[[str, Optional[str], Optional[str]],
                           None]) -> None:
    """Observe flips: hook(name, old, new) fires inside set_flag / clear."""
    _HOOKS.append(hook)


def remove_hook(hook: Callable) -> None:
    try:
        _HOOKS.remove(hook)
    except ValueError:
        pass


def flips() -> List[Dict[str, Any]]:
    """The audit log (bounded), oldest first."""
    return list(_FLIPS)


def clear_flips() -> None:
    del _FLIPS[:]


def registry() -> Dict[str, Dict[str, Any]]:
    """Every declared flag with its default, scope, description and
    current value."""
    return {
        name: {"default": f.default, "scope": f.scope, "desc": f.desc,
               "value": os.environ.get(name, f.default)}
        for name, f in sorted(_REGISTRY.items())}


# ---------------------------------------------------------------------
# The registry table: the flags the port's modules read.
# ---------------------------------------------------------------------

register("CEPH_TPU_COMPUTE", "1", "process",
         "coded-compute pushdown; 0 = read-then-compute")
register("CEPH_TPU_INFERENCE", "1", "process",
         "coded inference serving; 0 = exact full-decode only")
register("CEPH_TPU_TIER", "1", "process",
         "hot-set read tier; 0 = every read from the store")
register("CEPH_TPU_LOCKDEP", "0", "startup",
         "runtime lock-order detector")
register("CEPH_TPU_DEBUG", None, "startup",
         "daemon debug logging")

# -- the OSD data path --------------------------------------------------
register("CEPH_TPU_HEDGE", "1", "process",
         "hedged shard reads; 0 = single-attempt gathers")
register("CEPH_TPU_TRACE", "1", "process",
         "critical-path span layer; 0 = spans off")
register("CEPH_TPU_ENCODE_SERVICE", "1", "startup",
         "micro-batching encode service; 0 = inline encodes")
register("CEPH_TPU_ENCODE_BATCH_WINDOW_MS", "1.0", "startup",
         "encode-service batch window milliseconds")
register("CEPH_TPU_ENCODE_BATCH_BYTES", str(8 << 20), "startup",
         "encode-service batch byte ceiling")
register("CEPH_TPU_GROUP_COMMIT", "1", "startup",
         "group-commit fsync barriers; 0 = one commit per txn")
register("CEPH_TPU_GROUP_COMMIT_WINDOW_MS", "0.5", "startup",
         "group-commit accumulation window (ms)")
register("CEPH_TPU_GROUP_COMMIT_TXNS", "64", "startup",
         "group-commit max transactions per batch")
register("CEPH_TPU_GROUP_COMMIT_BYTES", str(4 << 20), "startup",
         "group-commit max payload bytes per batch")
register("CEPH_TPU_FUSE_MIN_BYTES", None, "process",
         "object-size floor for the fused encode+crc dispatch")

# -- QoS / scheduling ---------------------------------------------------
register("CEPH_TPU_QOS", "1", "startup",
         "per-tenant mClock classes + admission gate; 0 = one "
         "shared client class")
register("CEPH_TPU_DMCLOCK", "1", "process",
         "distributed mClock delta/rho piggybacking: MOSDOp carries "
         "per-tenant service deltas so tags are cluster-consistent; "
         "0 = per-OSD tags only")
register("CEPH_TPU_OP_FAST_LANE", "1", "startup",
         "sub-chunk write fast lane; 0 = every op queues")
register("CEPH_TPU_BREAKER_THRESHOLD", "3", "process",
         "consecutive failures before a peer breaker opens")
register("CEPH_TPU_BREAKER_BACKOFF_S", "0.5", "process",
         "initial open-state backoff seconds")
register("CEPH_TPU_BREAKER_BACKOFF_MAX_S", "30.0", "process",
         "open-state backoff ceiling seconds")
