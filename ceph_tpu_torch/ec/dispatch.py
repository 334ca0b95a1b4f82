"""Device dispatch helpers for the erasure codecs (port of
ceph_tpu/ec/dispatch.py).

The GF matmul goes to the device the codec was built for: the CUDA
kernels on a card, their plain versions on the CPU.  There is no circuit
breaker and no host fallback: on a CUDA device a failure raises.  The
bounded LRU cache keyed by erasure signature (the
ErasureCodeIsaTableCache role) is shared by every codec instance.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Hashable

import numpy as np
import torch

from ceph_tpu_torch.ec import plan


def gf_matmul(mat: np.ndarray, data: np.ndarray,
              device: torch.device) -> np.ndarray:
    """(R,K) GF(2^8) matrix x (K,S) or (B,K,S) uint8 -> (R,S) or (B,R,S),
    on `device`."""
    arr = np.asarray(data, dtype=np.uint8)
    if arr.ndim == 2:
        return plan.matmul(mat, arr[None], device)[0]
    return plan.matmul(mat, arr, device)


def gf_repair_matmul(mat: np.ndarray, data: np.ndarray,
                     device: torch.device) -> np.ndarray:
    """Repair twin of gf_matmul for the regenerating-code path:
    helper-side projections (1 x alpha) and primary-side reconstructions
    (alpha x d) through plan.repair, where a matrix whose compiled XOR
    program wins by op count runs on the `xor_sched` kernel and any
    other on the GF matmul kernels.  (R,K) x (K,S) or (B,K,S) -> (R,S)
    or (B,R,S), on `device`; a launch runs or raises."""
    return plan.repair(mat, data, device)


class LruCache:
    """Tiny bounded LRU (decode tables keyed by erasure signature).
    Overflow evicts the least-recently-used entry only."""

    def __init__(self, cap: int = 256):
        self._store: OrderedDict = OrderedDict()
        self.cap = cap

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._store

    _MISS = object()

    def peek(self, key: Hashable, default=None):
        """Lookup + LRU touch without computing on miss."""
        hit = self._store.get(key, self._MISS)
        if hit is self._MISS:
            return default
        self._store.move_to_end(key)
        return hit

    def put(self, key: Hashable, value) -> None:
        self._store[key] = value
        self._store.move_to_end(key)
        if len(self._store) > self.cap:
            self._store.popitem(last=False)

    def clear(self) -> None:
        self._store.clear()

    def get_or_compute(self, key: Hashable, compute: Callable):
        hit = self._store.get(key, self._MISS)
        if hit is not self._MISS:
            self._store.move_to_end(key)
            return hit
        value = compute()
        self.put(key, value)
        return value


# ---------------------------------------------------------------------------
# Shared decode-rows cache
# ---------------------------------------------------------------------------

# Inverted decode submatrices keyed by (codec signature, survivors,
# erasures), process-wide: identical profiles share rows on purpose and
# distinct ones never, because the key leads with the codec signature.
# Lookups take a lock (peek's get-then-move is not atomic under
# concurrent eviction); the inversion itself runs outside it.
_decode_rows = LruCache(cap=512)
_decode_rows_stats = {"hits": 0, "misses": 0}
_decode_rows_lock = threading.Lock()


def shared_decode_rows(key: Hashable, compute: Callable):
    """Fetch (or invert-and-cache) decode rows for one (codec sig,
    erasure pattern)."""
    with _decode_rows_lock:
        hit = _decode_rows.peek(key, LruCache._MISS)
        if hit is not LruCache._MISS:
            _decode_rows_stats["hits"] += 1
            return hit
        _decode_rows_stats["misses"] += 1
    value = compute()
    with _decode_rows_lock:
        _decode_rows.put(key, value)
    return value


def decode_rows_stats() -> dict:
    with _decode_rows_lock:
        return {**_decode_rows_stats, "entries": len(_decode_rows)}
