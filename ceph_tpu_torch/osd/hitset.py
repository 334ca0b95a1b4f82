"""HitSet: hot-set tracking for the read tier (port of
ceph_tpu/osd/hitset.py).

Reference parity: HitSet (the reference's src/osd/HitSet.h:35): a
probabilistic set of recently touched objects, kept per PG as a decaying
stack of N sets rotated on a period, read by the tier agent's promote and
evict decisions.  Two implementations, as in the reference:

- BloomHitSet: fixed false-positive budget, constant memory;
- ExplicitHashHitSet: exact 32-bit hash set (the small-PG case).

A batch of object hashes maps to its k bloom bit positions through the
rjenkins hash CRUSH uses (`hash32_2(h, i) % nbits`, probe i salted by seed
i).  `positions_for` (the query side) and `seal_bits` (the insert side)
keep the reference's policy: a batch of fewer than DEVICE_MIN_BATCH hashes
is hashed on the host; a larger one goes to the device the caller names
(CUDA unless told otherwise, and never silently the host).  On a CUDA
device each is one launch of a kernel of csrc/hitset_bloom.cu
(ops/bloom_kernels.py) with one pinned copy each way: `positions_for`
brings back the uint32 positions, `seal_bits` the set's bitset, built on
the card (where the reference brings back positions and scatter-ORs them
on the host).  On the CPU device the kernels' plain versions compute the
same (`bloom_positions_torch`, on ops/rjenkins.hash32_2_torch, and
bloom_kernels.bloom_seal_plain).  The host hashes a handful in Python
integers and memoizes each hash's positions per geometry, so a hit-count
probe of a hot object (one per archived set and read) is a dictionary
lookup, where the reference pays numpy's per-call cost; the numpy
`bloom_positions` is the oracle of all three.  All are equal bit for bit.
There is no breaker and no compile cache: a device call runs or raises.

Object names enter as the 32-bit Jenkins string hash the PG mapper uses
(`ceph_str_hash_rjenkins`), so the hot-set key space is the reference's
hobject hash space.
"""

from __future__ import annotations

import base64
import functools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ops import bloom_kernels, rjenkins

# batches below this hash on the host: a device call per handful of oids
# costs more latency than it saves
DEVICE_MIN_BATCH = 8

_LN2 = float(np.log(2.0))


def hash_oid(oid: str) -> int:
    """Object name -> the 32-bit Jenkins hash the PG mapper uses
    (hobject_t::get_hash role)."""
    return rjenkins.ceph_str_hash_rjenkins(oid.encode())


def bloom_geometry(target_size: int, fpp: float) -> tuple:
    """(nbits, nhash) for `target_size` insertions at false-positive
    probability `fpp` (bloom_filter::compute_optimal_parameters)."""
    n = max(int(target_size), 1)
    p = min(max(float(fpp), 1e-9), 0.5)
    nbits = int(np.ceil(-n * np.log(p) / (_LN2 * _LN2)))
    nbits = max(nbits, 8)
    nhash = max(1, int(round(nbits / n * _LN2)))
    return nbits, min(nhash, 32)


def bloom_positions(hashes, nbits: int, nhash: int) -> np.ndarray:
    """[B] uint32 oid hashes -> [B, nhash] uint32 bloom bit positions, on
    the host (numpy, uint32 wraparound): position i uses seed i."""
    h = np.asarray(hashes).astype(np.uint32).reshape(-1, 1)
    seeds = np.arange(nhash, dtype=np.uint32).reshape(1, -1)
    return (rjenkins.hash32_2(h, seeds) % np.uint32(nbits)).astype(np.uint32)


def bloom_positions_torch(hashes: torch.Tensor, nbits: int,
                          nhash: int) -> torch.Tensor:
    """[B] integer tensor of oid hashes -> [B, nhash] int64 positions in
    [0, nbits), on the tensor's device (the words ride in int64, masked
    to 32 bits, so `%` sees the same unsigned value numpy does)."""
    h = (hashes.to(torch.int64) & 0xFFFFFFFF).reshape(-1, 1)
    seeds = torch.arange(nhash, dtype=torch.int64,
                         device=hashes.device).reshape(1, -1)
    return rjenkins.hash32_2_torch(h, seeds) % int(nbits)


@functools.lru_cache(maxsize=1 << 16)
def _positions_one(h: int, nbits: int, nhash: int) -> tuple:
    """One uint32 hash's bloom positions, in Python integers."""
    return tuple(rjenkins.hash32_2_int(h, i) % nbits for i in range(nhash))


def positions_for(hashes, nbits: int, nhash: int,
                  device=None) -> np.ndarray:
    """Dispatch policy: the host for batches under DEVICE_MIN_BATCH, the
    device (resolve_device(device)) for every larger batch.  Both paths
    give the same uint32 positions."""
    arr = np.asarray(hashes, dtype=np.uint32).reshape(-1)
    if arr.size == 0:
        return np.zeros((0, nhash), dtype=np.uint32)
    if arr.size < DEVICE_MIN_BATCH:
        return np.array([_positions_one(int(h), nbits, nhash) for h in arr],
                        dtype=np.uint32)
    return bloom_kernels.positions_host(arr, nbits, nhash,
                                        resolve_device(device))


def seal_bits(hashes, nbits: int, nhash: int, device=None) -> np.ndarray:
    """[N] uint32 hashes -> the (nbits + 7) // 8 uint8 bitset
    BloomHitSet.insert_batch builds from them in an empty set, with
    positions_for's policy: the host under DEVICE_MIN_BATCH, else one seal
    on resolve_device(device) (one launch on a card)."""
    arr = np.asarray(hashes, dtype=np.uint32).reshape(-1)
    if arr.size >= DEVICE_MIN_BATCH:
        return bloom_kernels.seal_host(arr, (0, arr.size), nbits, nhash,
                                       resolve_device(device))[0]
    bits = np.zeros((nbits + 7) // 8, dtype=np.uint8)
    for h in arr:
        for p in _positions_one(int(h), nbits, nhash):
            bits[p >> 3] |= 1 << (p & 7)
    return bits


class BloomHitSet:
    """Bloom-filter hit set (HitSet.h:117 BloomHitSet role)."""

    kind = "bloom"

    def __init__(self, target_size: int = 1024, fpp: float = 0.05,
                 nbits: Optional[int] = None,
                 nhash: Optional[int] = None):
        self.target_size = int(target_size)
        self.fpp = float(fpp)
        if nbits is None or nhash is None:
            nbits, nhash = bloom_geometry(target_size, fpp)
        self.nbits = int(nbits)
        self.nhash = int(nhash)
        self.bits = np.zeros((self.nbits + 7) // 8, dtype=np.uint8)
        self.count = 0  # insertions (callers dedup)

    # -- insert / query ----------------------------------------------------

    def insert_batch(self, hashes, device=None) -> None:
        arr = np.asarray(hashes, dtype=np.uint32).reshape(-1)
        if arr.size == 0:
            return
        self.bits |= seal_bits(arr, self.nbits, self.nhash, device=device)
        self.count += int(arr.size)

    def insert(self, h: int) -> None:
        self.insert_batch([h])

    def contains_batch(self, hashes, device=None) -> np.ndarray:
        arr = np.asarray(hashes, dtype=np.uint32).reshape(-1)
        if arr.size == 0:
            return np.zeros(0, dtype=bool)
        pos = positions_for(arr, self.nbits, self.nhash, device=device)
        got = (self.bits[pos >> 3] >> (pos & 7)) & 1
        return got.all(axis=1)

    def contains(self, h: int) -> bool:
        bits = self.bits
        return all(bits[p >> 3] >> (p & 7) & 1 for p in _positions_one(
            int(np.uint32(h)), self.nbits, self.nhash))

    # -- wire --------------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "target_size": self.target_size,
                "fpp": self.fpp, "nbits": self.nbits,
                "nhash": self.nhash, "count": self.count,
                "bits": base64.b64encode(self.bits.tobytes()).decode()}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BloomHitSet":
        hs = cls(d.get("target_size", 1024), d.get("fpp", 0.05),
                 nbits=d["nbits"], nhash=d["nhash"])
        hs.count = int(d.get("count", 0))
        raw = np.frombuffer(base64.b64decode(d["bits"]), dtype=np.uint8)
        hs.bits = raw.copy()
        return hs


class ExplicitHashHitSet:
    """Exact 32-bit-hash hit set (HitSet.h ExplicitHashHitSet role)."""

    kind = "explicit_hash"

    def __init__(self, target_size: int = 1024, fpp: float = 0.0):
        self.target_size = int(target_size)
        self.hashes: set = set()

    @property
    def count(self) -> int:
        return len(self.hashes)

    def insert_batch(self, hashes, device=None) -> None:
        arr = np.asarray(hashes, dtype=np.uint32).reshape(-1)
        self.hashes.update(int(x) for x in arr)

    def insert(self, h: int) -> None:
        self.hashes.add(int(np.uint32(h)))

    def contains_batch(self, hashes, device=None) -> np.ndarray:
        arr = np.asarray(hashes, dtype=np.uint32).reshape(-1)
        return np.array([int(x) in self.hashes for x in arr], dtype=bool)

    def contains(self, h: int) -> bool:
        return int(np.uint32(h)) in self.hashes

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "target_size": self.target_size,
                "count": self.count, "hashes": sorted(self.hashes)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExplicitHashHitSet":
        hs = cls(d.get("target_size", 1024))
        hs.hashes = {int(x) for x in d.get("hashes", ())}
        return hs


_KINDS = {BloomHitSet.kind: BloomHitSet,
          ExplicitHashHitSet.kind: ExplicitHashHitSet}


def hitset_from_dict(d: Dict[str, Any]):
    return _KINDS[d["kind"]].from_dict(d)


class HitSetStack:
    """Per-PG decaying stack of hit sets (pg_pool_t hit_set_count /
    hit_set_period role).

    The open period keeps exact per-hash read counts (also the
    read-frequency histogram's source); `rotate()` seals it into a bloom or
    explicit set with one batched insert on `device` and pushes it on the
    archive, dropping the oldest beyond `count` (the decay).  `hit_count()`
    answers "in how many recent periods was this object read": open
    presence plus archived membership."""

    def __init__(self, count: int = 4, period: float = 10.0,
                 target_size: int = 1024, fpp: float = 0.05,
                 kind: str = "bloom", device=None):
        self.count = max(int(count), 1)
        self.period = float(period)
        self.target_size = int(target_size)
        self.fpp = float(fpp)
        self.kind = kind if kind in _KINDS else "bloom"
        self.device = device
        self.open_counts: Dict[int, int] = {}
        self.archived: List[Any] = []
        self.opened = time.monotonic()
        self.seq = 0          # rotation sequence (persistence key)

    # -- recording ---------------------------------------------------------

    def insert(self, h: int) -> None:
        h = int(np.uint32(h))
        self.open_counts[h] = self.open_counts.get(h, 0) + 1

    def due(self, now: Optional[float] = None) -> bool:
        if self.period <= 0:
            return False
        return (now if now is not None
                else time.monotonic()) - self.opened >= self.period

    def rotate(self) -> Any:
        """Seal the open period into an archived set (one batched insert
        of every unique hash of the period) and reset.  Returns the sealed
        set (the caller persists it)."""
        sealed = _KINDS[self.kind](self.target_size, self.fpp)
        if self.open_counts:
            sealed.insert_batch(
                np.fromiter(self.open_counts.keys(), dtype=np.uint32,
                            count=len(self.open_counts)),
                device=self.device)
        self.archived.append(sealed)
        # keep count-1 archived: open + archived = count sets in all
        while len(self.archived) > max(self.count - 1, 0):
            self.archived.pop(0)
        self.open_counts = {}
        self.opened = time.monotonic()
        self.seq += 1
        return sealed

    # -- queries -----------------------------------------------------------

    def open_count(self, h: int) -> int:
        return self.open_counts.get(int(np.uint32(h)), 0)

    def hit_count(self, h: int) -> int:
        """Recency: the number of sets (open + archived) holding h; the
        open set adds its exact read count, so a burst inside one period
        registers as hot."""
        h = int(np.uint32(h))
        n = self.open_counts.get(h, 0)
        for s in self.archived:
            if s.contains(h):
                n += 1
        return n

    def read_frequencies(self) -> List[int]:
        """Per-object read counts of the open period (histogram feed)."""
        return list(self.open_counts.values())

    def dump(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "count": self.count,
            "period": self.period,
            "seq": self.seq,
            "open": {"objects": len(self.open_counts),
                     "reads": sum(self.open_counts.values()),
                     "age": round(time.monotonic() - self.opened, 3)},
            "archived": [{"kind": s.kind, "count": s.count}
                         for s in self.archived],
        }
