"""Versioned wire encoding (port of ceph_tpu/common/encoding.py).

Reference parity: the encode/decode framework (the reference's
src/include/encoding.h): little-endian primitives,
length-prefixed strings/containers, and versioned struct blocks —
ENCODE_START(v, compat, bl) writes (struct_v u8, struct_compat u8,
struct_len u32) and DECODE_FINISH skips any unknown tail, which is what
makes rolling upgrades possible.  This module provides the same contract
for this framework's maps and messages, and writes the same bytes as the
JAX package's module, so a map encoded by either package decodes in the
other.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, List, Optional, Tuple


class Encoder:
    def __init__(self) -> None:
        self._parts: List[bytes] = []
        self._len = 0
        self._blocks: List[Tuple[int, int]] = []  # (part index, len so far)

    # -- primitives -------------------------------------------------------

    def _raw(self, b: bytes) -> None:
        self._parts.append(b)
        self._len += len(b)

    def u8(self, v: int) -> None:
        self._raw(struct.pack("<B", v))

    def u16(self, v: int) -> None:
        self._raw(struct.pack("<H", v))

    def u32(self, v: int) -> None:
        self._raw(struct.pack("<I", v & 0xFFFFFFFF))

    def u64(self, v: int) -> None:
        self._raw(struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF))

    def s32(self, v: int) -> None:
        self._raw(struct.pack("<i", v))

    def s64(self, v: int) -> None:
        self._raw(struct.pack("<q", v))

    def f64(self, v: float) -> None:
        self._raw(struct.pack("<d", v))

    def bool(self, v: bool) -> None:
        self.u8(1 if v else 0)

    def bytes(self, v: bytes) -> None:
        self.u32(len(v))
        # bytes passes through untouched; memoryview rides as-is into
        # the join (bulk data must not pay an extra pass here)
        self._raw(v if isinstance(v, (bytes, memoryview))
                  else bytes(v))

    def string(self, v: str) -> None:
        self.bytes(v.encode("utf-8"))

    # -- containers -------------------------------------------------------

    def list(self, items, encode_item: Callable[["Encoder", Any], None]
             ) -> None:
        self.u32(len(items))
        for item in items:
            encode_item(self, item)

    def map(self, d: Dict, encode_key, encode_val) -> None:
        self.u32(len(d))
        for key in d:
            encode_key(self, key)
            encode_val(self, d[key])

    def optional(self, v, encode_val) -> None:
        self.bool(v is not None)
        if v is not None:
            encode_val(self, v)

    # -- versioned blocks (ENCODE_START / ENCODE_FINISH) ------------------

    def start(self, version: int, compat: int) -> None:
        self.u8(version)
        self.u8(compat)
        self._parts.append(b"\x00\x00\x00\x00")  # length hole
        self._blocks.append((len(self._parts) - 1, self._len))
        self._len += 4

    def finish(self) -> None:
        idx, len_before = self._blocks.pop()
        body_len = self._len - len_before - 4
        self._parts[idx] = struct.pack("<I", body_len)

    def to_bytes(self) -> bytes:
        assert not self._blocks, "unfinished encode block"
        return b"".join(self._parts)


class DecodeError(ValueError):
    pass


class Decoder:
    def __init__(self, data: bytes, offset: int = 0):
        self._data = memoryview(data)
        self._pos = offset
        self._ends: List[int] = []  # struct block end offsets

    def remaining(self) -> int:
        end = self._ends[-1] if self._ends else len(self._data)
        return end - self._pos

    def _take(self, n: int) -> memoryview:
        if self.remaining() < n:
            raise DecodeError(
                f"buffer exhausted: need {n}, have {self.remaining()}")
        out = self._data[self._pos:self._pos + n]
        self._pos += n
        return out

    # -- primitives -------------------------------------------------------

    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def s32(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def s64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def bool(self) -> bool:
        return self.u8() != 0

    def bytes(self) -> bytes:
        n = self.u32()
        return bytes(self._take(n))

    def bytes_view(self) -> memoryview:
        """Zero-copy bulk-data read: a view into the frame buffer.
        For multi-MiB payload fields the bytes() copy is a full extra
        pass over the data."""
        n = self.u32()
        return self._take(n)

    def string(self) -> str:
        return self.bytes().decode("utf-8")

    # -- containers -------------------------------------------------------

    def list(self, decode_item: Callable[["Decoder"], Any]) -> List[Any]:
        n = self.u32()
        return [decode_item(self) for _ in range(n)]

    def map(self, decode_key, decode_val) -> Dict:
        n = self.u32()
        out = {}
        for _ in range(n):
            key = decode_key(self)
            out[key] = decode_val(self)
        return out

    def optional(self, decode_val) -> Optional[Any]:
        return decode_val(self) if self.bool() else None

    # -- versioned blocks (DECODE_START / DECODE_FINISH) ------------------

    def start(self, compat_expected: int) -> int:
        """Returns struct_v; raises if the encoder's compat is newer than
        what this decoder understands (the cross-version contract)."""
        struct_v = self.u8()
        struct_compat = self.u8()
        if struct_compat > compat_expected:
            raise DecodeError(
                f"struct compat {struct_compat} > understood"
                f" {compat_expected}")
        length = self.u32()
        if self.remaining() < length:
            raise DecodeError("struct length beyond buffer")
        self._ends.append(self._pos + length)
        return struct_v

    def finish(self) -> None:
        """Skip any tail a newer encoder appended (DECODE_FINISH)."""
        end = self._ends.pop()
        if self._pos > end:
            raise DecodeError("struct overread")
        self._pos = end
