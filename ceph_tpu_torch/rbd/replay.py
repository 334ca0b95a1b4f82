"""rbd-replay role: record an image workload, replay it elsewhere (port of
ceph_tpu/rbd/replay.py).

Reference parity: Ceph's src/rbd_replay/ — the reference
captures librbd API traces (lttng) into a .rbd-replay file and
`rbd-replay` re-executes them against another image, preserving
relative timing (--pacing) for performance studies and regression
reproduction.

Re-design: the trace is JSONL — one op per line {ts, op, offset,
length} (write payloads are synthesized on replay, as the reference's
anonymized traces do; a `data` field carries real bytes when fidelity
matters).  Recording is a transparent Image wrapper (no lttng in this
runtime — the API seam is the tracepoint), and `rbd bench --trace`
records its generated workload directly."""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Dict, List, Optional, TextIO

from ceph_tpu_torch.rbd import Image


class ImageTracer:
    """Wraps an open Image; every data-path op is executed AND logged
    (the lttng tracepoint role at the API seam)."""

    def __init__(self, image: Image, out: TextIO,
                 record_data: bool = False):
        self.image = image
        self._out = out
        self._record_data = record_data
        self._t0 = time.perf_counter()

    def _log(self, op: str, **fields) -> None:
        rec = {"ts": round(time.perf_counter() - self._t0, 6),
               "op": op}
        rec.update(fields)
        self._out.write(json.dumps(rec) + "\n")

    async def write(self, offset: int, data: bytes) -> int:
        n = await self.image.write(offset, data)
        extra = {"data": data.hex()} if self._record_data else {}
        self._log("write", offset=offset, length=len(data), **extra)
        return n

    async def read(self, offset: int, length: int) -> bytes:
        buf = await self.image.read(offset, length)
        self._log("read", offset=offset, length=length)
        return buf

    async def discard(self, offset: int, length: int) -> None:
        await self.image.discard(offset, length)
        self._log("discard", offset=offset, length=length)

    async def resize(self, new_size: int) -> None:
        await self.image.resize(new_size)
        self._log("resize", size=new_size)

    async def close(self) -> None:
        self._out.flush()
        await self.image.close()


def _payload(length: int, offset: int) -> bytes:
    """Deterministic synthetic payload (anonymized-trace replay):
    offset-seeded so re-replays are reproducible."""
    pat = (offset & 0xFF).to_bytes(1, "big")
    return pat * length


async def _as_aiter(lines):
    """Normalize a sync or async line iterable to async, so callers
    can stream (fileio.iter_lines) or pass a plain list."""
    if hasattr(lines, "__aiter__"):
        async for line in lines:
            yield line
    else:
        for line in lines:
            yield line


async def replay_trace(lines, image: Image, speed: float = 1.0,
                       max_lag: float = 30.0) -> Dict[str, Any]:
    """Re-execute a recorded trace against `image`, pacing ops by
    their recorded timestamps scaled by 1/speed (speed=0 -> as fast
    as possible).  `lines` may be any sync or async iterable of trace
    lines.  Returns {ops, reads, writes, elapsed_s}."""
    stats = {"ops": 0, "reads": 0, "writes": 0}
    t0 = time.perf_counter()   # pacing clock (rebased on capped gaps)
    t_start = t0               # wall clock (never rebased)
    async for line in _as_aiter(lines):
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        if speed > 0:
            due = rec.get("ts", 0.0) / speed
            lag = due - (time.perf_counter() - t0)
            if lag > 0:
                # CAP a huge recorded idle gap and REBASE the clock
                # by the forgiven part: a plain skip would disable
                # pacing for the rest of the trace, a plain cap would
                # make every later op pay max_lag again
                await asyncio.sleep(min(lag, max_lag))
                if lag > max_lag:
                    t0 -= lag - max_lag
        op = rec.get("op")
        if op == "write":
            data = bytes.fromhex(rec["data"]) if "data" in rec \
                else _payload(int(rec["length"]), int(rec["offset"]))
            await image.write(int(rec["offset"]), data)
            stats["writes"] += 1
        elif op == "read":
            await image.read(int(rec["offset"]),
                             int(rec["length"]))
            stats["reads"] += 1
        elif op == "discard":
            await image.discard(int(rec["offset"]),
                                int(rec["length"]))
        elif op == "resize":
            await image.resize(int(rec["size"]))
        else:
            continue  # unknown op: skip (forward compatibility)
        stats["ops"] += 1
    stats["elapsed_s"] = round(time.perf_counter() - t_start, 4)
    return stats
