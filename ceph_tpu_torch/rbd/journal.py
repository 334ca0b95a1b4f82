"""RBD image journaling: write-ahead event log per image (port of
ceph_tpu/rbd/journal.py).

Reference parity: the generic journaler (Ceph's src/journal/
Journaler.h — numbered journal objects, append position, commit
position, trimming) specialized for images the way librbd/journal/
does: every mutating image op is recorded as an event BEFORE it is
applied to the data objects, so a crash between journal append and
data apply replays the event on next open (librbd::Journal replay),
and an rbd-mirror peer can tail the event stream to replicate the
image (tools/rbd_mirror role — see ceph_tpu_torch.rbd.mirror).

Re-design notes: the reference splays entries across K objects for
parallel append bandwidth; this build keeps ONE active chunk object
(appends in an asyncio daemon serialize anyway) with size-based
rollover, and tracks {first, active, committed} in a small header doc.
Entries are versioned encoder blocks, so chunks scan forward without
a separate index and can grow fields.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Dict

from ceph_tpu_torch.common import lockdep
from ceph_tpu_torch.common.encoding import DecodeError, Decoder, Encoder

DEFAULT_CHUNK_MAX = 4 << 20  # rollover threshold per journal object


def _hdr(image_id: str) -> str:
    return f"rbd_journal.{image_id}"


def _chunk(image_id: str, n: int) -> str:
    return f"rbd_journal.{image_id}.{n:08x}"


def encode_event(seq: int, ev: Dict[str, Any]) -> bytes:
    enc = Encoder()
    enc.start(1, 1)
    enc.u64(seq)
    enc.string(ev.get("op", ""))
    enc.u64(int(ev.get("offset", 0)))
    enc.u64(int(ev.get("length", 0)))
    enc.bytes(bytes(ev.get("data", b"")))
    enc.string(ev.get("snap_name", ""))
    enc.u64(int(ev.get("size", 0)))
    enc.finish()
    return enc.to_bytes()


def decode_events(raw: bytes) -> list:
    dec = Decoder(raw)
    out = []
    while dec.remaining() > 0:
        try:
            dec.start(1)
            ev = {"seq": dec.u64(), "op": dec.string(),
                  "offset": dec.u64(), "length": dec.u64(),
                  "data": dec.bytes(), "snap_name": dec.string(),
                  "size": dec.u64()}
            dec.finish()
        except DecodeError:
            # torn tail from a crashed append: everything before it is
            # intact (entries are self-delimiting); the tail is the
            # un-acked event whose op never returned — drop it
            break
        out.append(ev)
    return out


class ImageJournal:
    """One image's event journal over its metadata ioctx."""

    def __init__(self, ioctx, image_id: str,
                 chunk_max: int = DEFAULT_CHUNK_MAX):
        self.ioctx = ioctx
        self.image_id = image_id
        self.chunk_max = chunk_max
        self.hdr: Dict[str, Any] = {}
        self.seq = 0          # last allocated
        self._active_size = 0
        self._append_lock = lockdep.Lock("journal.append")
        # out-of-order completions (concurrent writes): the commit
        # POSITION only advances over a CONTIGUOUS prefix — marking
        # seq N committed while N-1 is still applying must not let a
        # crash skip N-1's replay (librbd's commit-position tracker)
        self._done: set = set()

    # -- header ------------------------------------------------------------

    async def _load_hdr(self) -> None:
        try:
            raw = await self.ioctx.read(_hdr(self.image_id))
            self.hdr = json.loads(raw.decode())
        except Exception:
            self.hdr = {"first": 0, "active": 0, "committed": 0,
                        "chunk_last": {}}

    async def _save_hdr(self) -> None:
        await self.ioctx.write_full(
            _hdr(self.image_id), json.dumps(self.hdr).encode())

    async def open(self) -> None:
        """Bind to the on-disk journal: scan the active chunk to find
        the true last seq (the header only records it on rollover —
        per-append header writes would double every journal I/O)."""
        await self._load_hdr()
        self.seq = int(self.hdr.get("committed", 0))
        for n_str, last in self.hdr.get("chunk_last", {}).items():
            self.seq = max(self.seq, int(last))
        raw = await self._read_chunk(self.hdr["active"])
        self._active_size = len(raw)
        for ev in decode_events(raw):
            self.seq = max(self.seq, ev["seq"])

    async def _read_chunk(self, n: int) -> bytes:
        try:
            return await self.ioctx.read(_chunk(self.image_id, n))
        except Exception:
            return b""

    # -- append / commit / trim -------------------------------------------

    async def append(self, ev: Dict[str, Any]) -> int:
        """Journal one event; returns its seq once DURABLE (the
        write-ahead contract: callers apply the mutation only after
        this returns)."""
        async with self._append_lock:
            self.seq += 1
            seq = self.seq
            blob = encode_event(seq, ev)
            if self._active_size + len(blob) > self.chunk_max and \
                    self._active_size > 0:
                # rollover: seal the active chunk (record its last
                # seq for trim adjudication), open the next
                self.hdr.setdefault("chunk_last", {})[
                    str(self.hdr["active"])] = seq - 1
                self.hdr["active"] += 1
                self._active_size = 0
                await self._save_hdr()
            await self.ioctx.append(
                _chunk(self.image_id, self.hdr["active"]), blob)
            self._active_size += len(blob)
            return seq

    async def commit(self, seq: int) -> None:
        """Advance the commit position: events <= seq are applied to
        the image and need no replay.  Persisted lazily-but-monotonic;
        a stale commit pointer only means harmless re-replay of
        idempotent events (the reference's client commit position has
        the same at-least-once contract)."""
        committed = int(self.hdr.get("committed", 0))
        if seq <= committed:
            return
        self._done.add(seq)
        new = committed
        while new + 1 in self._done:
            new += 1
            self._done.discard(new)
        if new == committed:
            return  # a gap below seq is still applying
        self.hdr["committed"] = new
        await self._save_hdr()
        await self._trim()

    async def _trim(self) -> None:
        """Remove chunks whose every entry is committed AND below the
        mirror floor (peers registered in the header pin the stream
        the way the reference's registered journal clients do)."""
        floor = int(self.hdr.get("committed", 0))
        for peer_seq in self.hdr.get("peers", {}).values():
            floor = min(floor, int(peer_seq))
        chunk_last = self.hdr.get("chunk_last", {})
        removed = False
        for n_str in sorted(chunk_last, key=int):
            if int(chunk_last[n_str]) > floor:
                break
            try:
                await self.ioctx.remove(_chunk(self.image_id,
                                               int(n_str)))
            except Exception:
                pass
            del chunk_last[n_str]
            self.hdr["first"] = int(n_str) + 1
            removed = True
        if removed:
            await self._save_hdr()

    # -- replay / tail -----------------------------------------------------

    async def events_since(self, seq: int) -> list:
        """Every journaled event with seq > the given position, in
        order (the Journaler replay/ObjectPlayer role)."""
        out = []
        for n in range(int(self.hdr.get("first", 0)),
                       int(self.hdr.get("active", 0)) + 1):
            raw = await self._read_chunk(n)
            for ev in decode_events(raw):
                if ev["seq"] > seq:
                    out.append(ev)
        return out

    # -- mirror-peer positions (journal client registry role) -------------

    async def peer_get(self, peer: str) -> int:
        await self._load_hdr()
        return int(self.hdr.get("peers", {}).get(peer, 0))

    async def peer_set(self, peer: str, seq: int) -> None:
        self.hdr.setdefault("peers", {})[peer] = int(seq)
        await self._save_hdr()
        await self._trim()

    async def destroy(self) -> None:
        for n in range(int(self.hdr.get("first", 0)),
                       int(self.hdr.get("active", 0)) + 1):
            try:
                await self.ioctx.remove(_chunk(self.image_id, n))
            except Exception:
                pass
        try:
            await self.ioctx.remove(_hdr(self.image_id))
        except Exception:
            pass
