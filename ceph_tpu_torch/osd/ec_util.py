"""EC stripe arithmetic and shard hashing (the main-path subset of
ceph_tpu/osd/ec_util.py).

ECUtil parity:

- StripeInfo (stripe_info_t): logical <-> chunk offset maps over
  stripe_width = k * chunk_size rows;
- encode / decode: whole-object buffers through the codec, all stripes of
  an object stacked into one (B, k, chunk) batch and one device call;
- encode_with_hinfo: encode plus the per-shard cumulative crc32c ledger
  (HashInfo), fused on the device: on a CUDA codec the parity and every
  chunk's crc come from one call (ec/plan.encode_with_crc) and fold into
  the ledger on the host.  On the CPU it is encode plus the host crc.

Shards leave as read-only memoryviews of buffers nothing writes again.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ops import checksum as cks


class StripeInfo:
    """stripe_info_t: stripe_width = stripe_size (k) x chunk_size."""

    def __init__(self, stripe_size: int, stripe_width: int):
        if stripe_width % stripe_size:
            raise ValueError(f"stripe width {stripe_width} is not a multiple"
                             f" of {stripe_size} chunks")
        self.stripe_width = stripe_width
        self.chunk_size = stripe_width // stripe_size

    def logical_offset_is_stripe_aligned(self, logical: int) -> bool:
        return logical % self.stripe_width == 0

    def get_stripe_width(self) -> int:
        return self.stripe_width

    def get_chunk_size(self) -> int:
        return self.chunk_size

    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return (-(-offset // self.stripe_width)) * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - offset % self.stripe_width

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        rem = offset % self.stripe_width
        return offset + (self.stripe_width - rem) if rem else offset

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        if offset % self.stripe_width:
            raise ValueError(f"offset {offset} is not stripe aligned")
        return (offset // self.stripe_width) * self.chunk_size

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        if offset % self.chunk_size:
            raise ValueError(f"offset {offset} is not chunk aligned")
        return (offset // self.chunk_size) * self.stripe_width

    def aligned_offset_len_to_chunk(self, off_len: Tuple[int, int]
                                    ) -> Tuple[int, int]:
        off, length = off_len
        return (self.aligned_logical_offset_to_chunk_offset(off),
                self.aligned_logical_offset_to_chunk_offset(length))

    def offset_len_to_stripe_bounds(self, off_len: Tuple[int, int]
                                    ) -> Tuple[int, int]:
        off, length = off_len
        start = self.logical_to_prev_stripe_offset(off)
        end_len = self.logical_to_next_stripe_offset((off - start) + length)
        return start, end_len


def _frozen_view(arr: np.ndarray) -> memoryview:
    arr.setflags(write=False)
    return arr.data


def encode(sinfo: StripeInfo, ec_impl, data,
           want: Iterable[int]) -> Dict[int, memoryview]:
    """Whole-object encode: (stripes x width) -> per-shard chunk streams.

    Input must be stripe-aligned (callers zero-pad).  All stripes go
    through the codec in one batched call when the codec exposes
    encode_batch and an identity chunk mapping.
    """
    logical_size = len(data)
    if logical_size % sinfo.get_stripe_width():
        raise ValueError(f"{logical_size} bytes are not stripe aligned")
    want = set(want)
    out: Dict[int, memoryview] = {}
    if logical_size == 0:
        return out

    width = sinfo.get_stripe_width()
    chunk = sinfo.get_chunk_size()
    n_stripes = logical_size // width
    k = width // chunk
    n = ec_impl.get_chunk_count()

    if ec_impl.get_chunk_size(width) != chunk:
        raise ErasureCodeError(
            22, f"stripe unit {chunk} is incompatible with the codec's"
            f" alignment: a {width}-byte stripe encodes to"
            f" {ec_impl.get_chunk_size(width)}-byte chunks")

    if hasattr(ec_impl, "encode_batch") and not ec_impl.get_chunk_mapping():
        arr = np.frombuffer(data, dtype=np.uint8).reshape(n_stripes, k, chunk)
        # shard-stream layout: one contiguous transpose up front, then
        # the matmul and the per-shard views all work on contiguous rows
        streams = np.ascontiguousarray(np.moveaxis(arr, 1, 0))
        streams.setflags(write=False)
        streams = streams.reshape(k, n_stripes * chunk)
        parity = np.ascontiguousarray(ec_impl.encode_batch(streams[None])[0])
        parity.setflags(write=False)
        for i in range(n):
            if i in want:
                out[i] = streams[i].data if i < k else parity[i - k].data
        return out

    # generic path: per-stripe through the interface (chunk mappings)
    parts: Dict[int, List[bytes]] = {i: [] for i in want}
    mv = memoryview(data)
    for s in range(n_stripes):
        encoded = ec_impl.encode(want, mv[s * width:(s + 1) * width])
        for i, buf in encoded.items():
            parts[i].append(buf)
    return {i: memoryview(b"".join(bufs)) for i, bufs in parts.items()}


def encode_with_hinfo(sinfo: StripeInfo, ec_impl, data,
                      want: Iterable[int],
                      logical_len: Optional[int] = None
                      ) -> Tuple[Dict[int, memoryview], "HashInfo",
                                 Optional[int]]:
    """Whole-object encode + per-shard cumulative crc32c in one step
    (ECTransaction::generate_transactions followed by HashInfo::append).

    On a codec that runs on a CUDA device with a plain generator matrix,
    parity and the crc of every chunk come from one fused device call;
    elsewhere it is `encode` plus the host crc.  The logical content
    crc32c over data[:logical_len], when asked for, rides along.
    """
    if (getattr(ec_impl, "use_tpu", False)
            and getattr(ec_impl, "matrix", None) is not None
            and not ec_impl.get_chunk_mapping()
            and hasattr(ec_impl, "encode_batch_with_crc")):
        fused = _encode_with_hinfo_device(sinfo, ec_impl, data, want,
                                          logical_len)
        if fused is not None:
            return fused
    shards = encode(sinfo, ec_impl, data, want)
    hinfo = HashInfo(ec_impl.get_chunk_count())
    hinfo.append(0, shards)
    return shards, hinfo, _data_crc(data, logical_len)


def _data_crc(data, logical_len: Optional[int]) -> Optional[int]:
    if logical_len is None:
        return None
    return cks.crc32c(0xFFFFFFFF, memoryview(data)[:logical_len])


def fold_ledger(crc0: np.ndarray, chunk: int) -> List[int]:
    """(B, n) zero-seeded per-stripe chunk crcs -> the n cumulative shard
    crcs from seed 0xFFFFFFFF, by the streaming identity
    crc(c, chunk) = crc32c_zeros(c, len) ^ crc32c(0, chunk)."""
    cols = cks.advance_columns(chunk)
    c = np.full(crc0.shape[1], 0xFFFFFFFF, dtype=np.uint32)
    for row in np.asarray(crc0, dtype=np.uint32):
        c = cks.advance(cols, c) ^ row
    return [int(x) for x in c]


def _encode_with_hinfo_device(sinfo: StripeInfo, ec_impl, data,
                              want: Iterable[int],
                              logical_len: Optional[int]):
    """Fused device tier of encode_with_hinfo.  None when the geometry
    does not fit (the generic path owns the error)."""
    width = sinfo.get_stripe_width()
    chunk = sinfo.get_chunk_size()
    if (len(data) == 0 or len(data) % width
            or ec_impl.get_chunk_size(width) != chunk):
        return None
    n_stripes = len(data) // width
    k = width // chunk
    n = ec_impl.get_chunk_count()
    arr = np.frombuffer(data, dtype=np.uint8).reshape(n_stripes, k, chunk)
    parity, crc0 = ec_impl.encode_batch_with_crc(arr, init=0)
    hinfo = HashInfo(n)
    hinfo.cumulative_shard_hashes = fold_ledger(crc0, chunk)
    hinfo.total_chunk_size = n_stripes * chunk
    want = set(want)
    shards: Dict[int, memoryview] = {}
    for i in range(n):
        if i in want:
            src = arr[:, i, :] if i < k else parity[:, i - k, :]
            shards[i] = _frozen_view(np.ascontiguousarray(src).reshape(-1))
    return shards, hinfo, _data_crc(data, logical_len)


def decode(sinfo: StripeInfo, ec_impl,
           to_decode: Mapping[int, bytes]) -> memoryview:
    """Per-shard chunk streams -> the original logical byte stream."""
    if not to_decode:
        raise ValueError("no shards to decode from")
    chunk = sinfo.get_chunk_size()
    width = sinfo.get_stripe_width()
    k = width // chunk
    total = len(next(iter(to_decode.values())))
    if total % chunk or any(len(b) != total for b in to_decode.values()):
        raise ValueError("shard streams must be equal whole chunks")
    if total == 0:
        return memoryview(b"")
    n_stripes = total // chunk

    def stream(i: int) -> np.ndarray:
        return np.frombuffer(to_decode[i], dtype=np.uint8).reshape(
            n_stripes, chunk)

    have = tuple(sorted(to_decode))
    want = tuple(range(k))
    erased = tuple(i for i in want if i not in to_decode)
    if not erased and not ec_impl.get_chunk_mapping():
        # the stack is the interleave
        return _frozen_view(np.stack([stream(i) for i in range(k)],
                                     axis=1).reshape(-1))
    if hasattr(ec_impl, "decode_batch") and not ec_impl.get_chunk_mapping() \
            and len(have) >= k:
        survivors = np.stack([stream(i) for i in have[:k]], axis=1)
        recovered = ec_impl.decode_batch(have[:k], erased, survivors)
        cols = [stream(i) if i in to_decode
                else np.asarray(recovered[:, erased.index(i), :])
                for i in range(k)]
        return _frozen_view(np.stack(cols, axis=1).reshape(-1))

    out = []
    views = {i: memoryview(buf) for i, buf in to_decode.items()}
    for s in range(n_stripes):
        chunks = {i: mv[s * chunk:(s + 1) * chunk]
                  for i, mv in views.items()}
        out.append(ec_impl.decode_concat(chunks))
    return memoryview(b"".join(out))


class HashInfo:
    """Cumulative per-shard crc32c ledger (ECUtil.h HashInfo)."""

    def __init__(self, num_chunks: int = 0):
        self.total_chunk_size = 0
        self.cumulative_shard_hashes: List[int] = [0xFFFFFFFF] * num_chunks
        self.projected_total_chunk_size = 0

    def append(self, old_size: int, to_append: Mapping[int, bytes]) -> None:
        if old_size != self.total_chunk_size:
            raise ValueError(f"append at {old_size}, ledger holds"
                             f" {self.total_chunk_size}")
        appended = 0
        for shard, buf in to_append.items():
            appended = len(buf)
            if self.has_chunk_hash():
                self.cumulative_shard_hashes[shard] = cks.crc32c(
                    self.cumulative_shard_hashes[shard], buf)
        self.total_chunk_size += appended

    def clear(self) -> None:
        self.total_chunk_size = 0
        self.cumulative_shard_hashes = [
            0xFFFFFFFF] * len(self.cumulative_shard_hashes)

    def get_chunk_hash(self, shard: int) -> int:
        return self.cumulative_shard_hashes[shard]

    def get_total_chunk_size(self) -> int:
        return self.total_chunk_size

    def get_total_logical_size(self, sinfo: StripeInfo) -> int:
        return self.total_chunk_size * (
            sinfo.get_stripe_width() // sinfo.get_chunk_size())

    def has_chunk_hash(self) -> bool:
        return bool(self.cumulative_shard_hashes)

    def set_total_chunk_size_clear_hash(self, new_chunk_size: int) -> None:
        self.cumulative_shard_hashes = []
        self.total_chunk_size = new_chunk_size

    # -- wire/xattr form --------------------------------------------------

    def to_dict(self) -> dict:
        return {"total_chunk_size": self.total_chunk_size,
                "cumulative_shard_hashes": list(self.cumulative_shard_hashes)}

    @classmethod
    def from_dict(cls, d: dict) -> "HashInfo":
        hi = cls(0)
        hi.total_chunk_size = int(d["total_chunk_size"])
        hi.cumulative_shard_hashes = [
            int(x) for x in d["cumulative_shard_hashes"]]
        return hi
