"""Crash reporting (the src/ceph-crash.in + pybind/mgr/crash role; port
of ceph_tpu/common/crash.py).

A daemon that dies of an unhandled exception posts a structured
report to the monitors before exiting; reports are quorum-replicated,
listed/inspected/archived via `crash ls/info/archive/rm` commands,
and raise a RECENT_CRASH health warning until archived — the
reference's crash-dump-directory scanner collapsed into a direct
post (our daemons are python; the traceback IS the crash dump)."""

from __future__ import annotations

import time
import traceback
from typing import Any, Dict, Optional


def make_report(entity: str,
                exc: Optional[BaseException] = None) -> Dict[str, Any]:
    ts = time.time()
    rep: Dict[str, Any] = {
        "crash_id": f"{time.strftime('%Y-%m-%dT%H:%M:%S', time.gmtime(ts))}"
                    f".{int(ts * 1e6) % 1000000:06d}_{entity}",
        "entity": entity,
        "timestamp": ts,
        "ceph_version": "ceph-tpu",
    }
    if exc is not None:
        rep["exception"] = repr(exc)
        rep["backtrace"] = traceback.format_exception(
            type(exc), exc, exc.__traceback__)
    return rep


async def post_crash(mon_addr: str, entity: str,
                     exc: Optional[BaseException] = None,
                     secret: Optional[str] = None) -> Optional[str]:
    """Best-effort post over a fresh mon connection (the dying
    daemon's own client state cannot be trusted).  Returns the crash
    id, or None if the monitors were unreachable."""
    from ceph_tpu_torch.rados.client import RadosClient

    rep = make_report(entity, exc)
    client = RadosClient(mon_addr, name=f"crash.{entity}",
                         secret=secret)
    try:
        await client.connect()
        rc, _out = await client.mon_command(
            {"prefix": "crash post", "report": rep})
        return rep["crash_id"] if rc == 0 else None
    except Exception:
        return None  # never mask the original failure
    finally:
        try:
            await client.shutdown()
        except Exception:
            pass
