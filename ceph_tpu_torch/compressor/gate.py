"""Compress-or-not policy, mirroring BlueStore's write-path gate (port of
ceph_tpu/compressor/gate.py).

Reference: BlueStore::_do_alloc_write (BlueStore.cc:13459-13606) —
per-pool mode/algorithm overrides, alloc-hint interaction
(COMPRESSIBLE/INCOMPRESSIBLE), and the required-ratio accept test
(`result_len <= want_len` where want = raw * required_ratio, :13545-13585);
the compression header carries algorithm + original length
(bluestore_compression_header_t).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ceph_tpu_torch.compressor import (
    ALLOC_HINT_COMPRESSIBLE,
    ALLOC_HINT_INCOMPRESSIBLE,
    COMP_AGGRESSIVE,
    COMP_FORCE,
    COMP_NONE,
    COMP_PASSIVE,
    Compressor,
)

DEFAULT_REQUIRED_RATIO = 0.875  # bluestore_compression_required_ratio


@dataclass
class CompressionHeader:
    """bluestore_compression_header_t analog: rides ahead of the payload."""

    alg: int
    original_length: int
    compressor_message: Optional[int] = None


def want_compress(mode: int, alloc_hints: int = 0) -> bool:
    """Mode x hint decision (BlueStore.cc:13475-13497)."""
    if mode == COMP_NONE:
        return False
    if mode == COMP_FORCE:
        return True
    if mode == COMP_PASSIVE:
        return bool(alloc_hints & ALLOC_HINT_COMPRESSIBLE)
    if mode == COMP_AGGRESSIVE:
        return not (alloc_hints & ALLOC_HINT_INCOMPRESSIBLE)
    return False


def maybe_compress(
    data: bytes,
    compressor: Optional[Compressor],
    mode: int = COMP_AGGRESSIVE,
    alloc_hints: int = 0,
    required_ratio: float = DEFAULT_REQUIRED_RATIO,
) -> Tuple[bytes, Optional[CompressionHeader]]:
    """Returns (payload, header); header is None when stored raw.

    The accept test mirrors the reference's required-ratio gate:
    compressed length must be <= len(data) * required_ratio, else the raw
    bytes are stored and the attempt counts as rejected.  Unlike
    BlueStore (where bluestore_compression_header_t rides the stored
    payload and counts against want_len), the header here lives in onode
    metadata, so no header bytes are part of the comparison.
    """
    if compressor is None or not data or not want_compress(mode, alloc_hints):
        return data, None
    compressed, message = compressor.compress(data)
    want_len = int(len(data) * required_ratio)
    if len(compressed) > want_len:
        return data, None
    return compressed, CompressionHeader(
        alg=compressor.get_type(),
        original_length=len(data),
        compressor_message=message,
    )


def decompress(payload: bytes, header: Optional[CompressionHeader]) -> bytes:
    if header is None:
        return payload
    from ceph_tpu_torch.compressor import get_comp_alg_name

    compressor = Compressor.create(get_comp_alg_name(header.alg))
    if compressor is None:
        raise ValueError(
            f"no codec for algorithm {header.alg} in this build")
    out = compressor.decompress(payload, header.compressor_message)
    if len(out) != header.original_length:
        raise ValueError("decompressed length mismatch")
    return out
