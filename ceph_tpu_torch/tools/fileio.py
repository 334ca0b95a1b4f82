"""Async local-file helpers for the CLI tools (port of
ceph_tpu/tools/fileio.py).

The tools run their command inside the same event loop that drives the
messenger (heartbeats, replies, watch/notify); a local read/write that
stalls on a slow filesystem would stall all of it.  Every local-disk
touch rides a worker thread instead — this is the fix shape for the
analyzer's `async-blocking` rule.
"""

from __future__ import annotations

import asyncio


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _read_text(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def _write_bytes(path: str, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(data)


async def read_bytes(path: str) -> bytes:
    return await asyncio.to_thread(_read_bytes, path)


async def read_text(path: str) -> str:
    return await asyncio.to_thread(_read_text, path)


async def write_bytes(path: str, data: bytes) -> None:
    await asyncio.to_thread(_write_bytes, path, data)


async def open_file(path: str, mode: str = "r"):
    """open() off-loop; the returned file object's own reads/writes
    should also ride asyncio.to_thread when they can be large."""
    return await asyncio.to_thread(open, path, mode)


async def iter_lines(path: str, batch: int = 1024):
    """Stream a text file line by line without slurping it: `batch`
    lines per worker-thread hop keeps both the event loop and memory
    bounded for multi-GiB traces."""
    import itertools
    fh = await asyncio.to_thread(open, path)
    try:
        while True:
            chunk = await asyncio.to_thread(
                lambda: list(itertools.islice(fh, batch)))
            if not chunk:
                return
            for line in chunk:
                yield line
    finally:
        await asyncio.to_thread(fh.close)


async def read_stdin() -> bytes:
    """Drain stdin off-loop: a slow pipe producer would otherwise
    stall the event loop exactly like a slow local file."""
    import sys
    return await asyncio.to_thread(sys.stdin.buffer.read)
