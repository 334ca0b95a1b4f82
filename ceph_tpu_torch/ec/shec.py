"""SHEC, the shingled erasure code (k, m, c) (port of ceph_tpu/ec/shec.py).

The reference's shec plugin (ErasureCodeShec.{h,cc}):

- generator: the jerasure Vandermonde RS coding matrix with a sliding
  window of columns zeroed per parity row, so that each parity "shingle"
  covers only part of the data (shec_reedsolomon_coding_matrix);
  technique=multiple searches the (m1,c1)/(m2,c2) splits for the least
  recovery-efficiency metric (shec_calc_recovery_efficiency1), single
  uses one band;
- decode: per erasure pattern, search the parity subsets (fewest parities
  first) for an invertible recovery submatrix (shec_make_decoding_matrix)
  and cache it keyed by the (want, avails) signature
  (ErasureCodeShecTableCache);
- validation: 0 < c <= m <= k <= 12, k+m <= 20; w is 8 (the reference
  falls back to 8 on a bad w; GF(2^16/32) shingles are not provided).

The recovery search and inversion are host numpy (tiny matrices); the
encode and decode products run on the codec's device through
dispatch.gf_matmul.  The generator is not registered, so they all run
on gf_matmul_gen, as the JAX codec's run its generic kernel.
"""


from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Set, Tuple

import numpy as np

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec import dispatch
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError, to_int
from ceph_tpu_torch.models import reed_solomon as rs
from ceph_tpu_torch.ops import gf


def recovery_efficiency1(k: int, m1: int, m2: int, c1: int, c2: int) -> float:
    """shec_calc_recovery_efficiency1: mean chunks read to recover."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [10 ** 8] * k
    r_e1 = 0.0
    for m_band, c_band, _row0 in ((m1, c1, 0), (m2, c2, m1)):
        for rr in range(m_band):
            start = ((rr * k) // m_band) % k
            end = (((rr + c_band) * k) // m_band) % k
            width = ((rr + c_band) * k) // m_band - (rr * k) // m_band
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc], width)
                cc = (cc + 1) % k
            r_e1 += width
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


def shec_matrix(k: int, m: int, c: int, technique: str) -> np.ndarray:
    """The shingled generator rows (m, k) over GF(2^8)."""
    if technique == "single":
        m1, c1 = 0, 0
    else:
        best = None
        for c1_try in range(c // 2 + 1):
            for m1_try in range(m + 1):
                c2 = c - c1_try
                m2 = m - m1_try
                if m1_try < c1_try or m2 < c2:
                    continue
                if (m1_try == 0) != (c1_try == 0):
                    continue
                if (m2 == 0) != (c2 == 0):
                    continue
                r = recovery_efficiency1(k, m1_try, m2, c1_try, c2)
                if r < 0:
                    continue
                if best is None or r < best[0] - 1e-12:
                    best = (r, m1_try, c1_try)
        if best is None:
            raise ErasureCodeError(22, f"no valid shec split for"
                                   f" k={k} m={m} c={c}")
        _, m1, c1 = best
    m2, c2 = m - m1, c - c1

    matrix = rs.reed_sol_van_matrix(k, m).copy()
    for band_m, band_c, row0 in ((m1, c1, 0), (m2, c2, m1)):
        for rr in range(band_m):
            end = ((rr * k) // band_m) % k
            start = (((rr + band_c) * k) // band_m) % k
            cc = start
            while cc != end:
                matrix[row0 + rr, cc] = 0
                cc = (cc + 1) % k
    return matrix


class ErasureCodeShec(ErasureCode):
    TECHNIQUES = ("single", "multiple")
    DEFAULT_K, DEFAULT_M, DEFAULT_C, DEFAULT_W = 4, 3, 2, 8

    def __init__(self, technique: str = "multiple") -> None:
        super().__init__()
        if technique not in self.TECHNIQUES:
            raise ErasureCodeError(
                22, f"technique={technique} is not a valid coding technique")
        self.technique = technique
        self.c = 0
        self.w = 8
        self.matrix: Optional[np.ndarray] = None
        self.device = None
        self._decode_cache = dispatch.LruCache(256)

    # -- init -------------------------------------------------------------

    def init(self, profile: Dict[str, str]) -> None:
        profile["technique"] = self.technique
        has = [name for name in ("k", "m", "c") if profile.get(name)]
        if not has:
            self.k, self.m, self.c = (
                self.DEFAULT_K, self.DEFAULT_M, self.DEFAULT_C)
            profile.update(
                {"k": str(self.k), "m": str(self.m), "c": str(self.c)})
        elif len(has) != 3:
            raise ErasureCodeError(22, "(k, m, c) must all be chosen")
        else:
            self.k = to_int("k", profile, str(self.DEFAULT_K))
            self.m = to_int("m", profile, str(self.DEFAULT_M))
            self.c = to_int("c", profile, str(self.DEFAULT_C))
        k, m, c = self.k, self.m, self.c
        if k <= 0 or m <= 0 or c <= 0:
            raise ErasureCodeError(22, "k, m, c must be positive")
        if m < c:
            raise ErasureCodeError(22, f"c={c} must be <= m={m}")
        if k > 12:
            raise ErasureCodeError(22, f"k={k} must be <= 12")
        if k + m > 20:
            raise ErasureCodeError(22, f"k+m={k + m} must be <= 20")
        if k < m:
            raise ErasureCodeError(22, f"m={m} must be <= k={k}")
        self.w = to_int("w", profile, str(self.DEFAULT_W))
        if self.w != 8:
            # the reference silently falls back to 8 on bad w; GF(2^16/32)
            # shingles are not provided
            self.w = 8
            profile["w"] = "8"
        self.device = resolve_device(profile.get("device") or None)
        super().init(profile)
        self.matrix = shec_matrix(k, m, c, self.technique)

    # -- geometry ---------------------------------------------------------

    def get_alignment(self) -> int:
        return self.k * self.w * 4

    # -- kernels ----------------------------------------------------------

    def _matmul(self, mat: np.ndarray, data: np.ndarray) -> np.ndarray:
        return dispatch.gf_matmul(mat, data, self.device)

    def encode_chunks(self, want_to_encode: Set[int],
                      encoded: Dict[int, bytearray]) -> None:
        k, m = self.k, self.m
        # in-place reads + buffer-view writes: the bytes()/tobytes()
        # round trip copied every chunk twice more per encode
        data = np.stack([
            np.frombuffer(encoded[i], dtype=np.uint8)
            for i in range(k)])
        parity = np.ascontiguousarray(self._matmul(self.matrix, data))
        for j in range(m):
            encoded[k + j][:] = parity[j].data

    # -- recovery-set search (shec_make_decoding_matrix) ------------------

    def _search_recovery(self, want: Tuple[int, ...],
                         avails: Tuple[int, ...]):
        """-> (rows, cols, inv_matrix, minimum) for an erasure signature.

        rows: chunk ids feeding the solve; cols: data ids recovered;
        inv: (len, len) GF inverse mapping chunk values -> data values;
        minimum: chunk ids to read (reference `minimum` array semantics).
        """
        return self._decode_cache.get_or_compute(
            (want, avails), lambda: self._search_recovery_uncached(want, avails))

    def _search_recovery_uncached(self, want: Tuple[int, ...],
                                  avails: Tuple[int, ...]):
        k, m = self.k, self.m
        want_arr = list(want)
        # a wanted missing parity forces wanting its whole data window
        for i in range(m):
            if want_arr[k + i] and not avails[k + i]:
                for j in range(k):
                    if self.matrix[i, j]:
                        want_arr[j] = 1

        best = None  # (dup, ek, rows, cols, inv)
        for pp in range(1 << m):
            parities = [i for i in range(m) if pp & (1 << i)]
            ek = len(parities)
            if best is not None and ek > best[1]:
                continue
            if any(not avails[k + p] for p in parities):
                continue
            rows = set()
            cols = set()
            for i in range(k):
                if want_arr[i] and not avails[i]:
                    cols.add(i)
            for p in parities:
                rows.add(k + p)
                for j in range(k):
                    if self.matrix[p, j]:
                        cols.add(j)
                        if avails[j]:
                            rows.add(j)
            if len(rows) != len(cols):
                continue
            dup = len(rows)
            if dup == 0:
                best = (0, ek, [], [], None)
                break
            if best is not None and dup >= best[0]:
                continue
            row_ids = sorted(rows)
            col_ids = sorted(cols)
            sub = np.zeros((dup, dup), dtype=np.uint8)
            for ri, r in enumerate(row_ids):
                for ci, col in enumerate(col_ids):
                    if r < k:
                        sub[ri, ci] = 1 if r == col else 0
                    else:
                        sub[ri, ci] = self.matrix[r - k, col]
            try:
                inv = gf.gf_invert_matrix(sub)
            except np.linalg.LinAlgError:
                continue  # singular: this parity subset can't recover
            best = (dup, ek, row_ids, col_ids, inv)

        if best is None:
            result = None
        else:
            dup, ek, row_ids, col_ids, inv = best
            minimum = set(row_ids)
            for i in range(k):
                if want_arr[i] and avails[i]:
                    minimum.add(i)
            for i in range(m):
                if want[k + i] and avails[k + i] and (k + i) not in minimum:
                    # an available wanted parity still has to be read unless
                    # it is re-computable purely from wanted data
                    if any(self.matrix[i, j] and not want_arr[j]
                           for j in range(k)):
                        minimum.add(k + i)
            result = (row_ids, col_ids, inv, sorted(minimum))
        return result

    def _signature(self, want_to_read: Set[int], available: Set[int]):
        n = self.k + self.m
        want = tuple(1 if i in want_to_read else 0 for i in range(n))
        avails = tuple(1 if i in available else 0 for i in range(n))
        return want, avails

    # -- decode planning --------------------------------------------------

    def _minimum_to_decode(self, want_to_read: Set[int],
                           available_chunks: Set[int]) -> Set[int]:
        if not want_to_read:
            return set()
        if want_to_read <= available_chunks:
            return set(want_to_read)
        want, avails = self._signature(want_to_read, available_chunks)
        result = self._search_recovery(want, avails)
        if result is None:
            raise ErasureCodeError(
                5, "can't find recover matrix for erasure pattern")
        return set(result[3])

    # -- decode -----------------------------------------------------------

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Mapping[int, bytes],
                      decoded: Dict[int, bytearray]) -> None:
        k, m = self.k, self.m
        available = set(chunks)
        want, avails = self._signature(set(want_to_read), available)
        result = self._search_recovery(want, avails)
        if result is None:
            raise ErasureCodeError(
                5, "can't find recover matrix for erasure pattern")
        row_ids, col_ids, inv, _minimum = result
        if row_ids:
            # np.stack owns the copy it needs at read time; recovered
            # columns land back as buffer views (writes target erased
            # buffers only — disjoint from the stacked sources)
            src = np.stack([
                np.frombuffer(decoded[r], dtype=np.uint8)
                for r in row_ids])
            out = np.ascontiguousarray(self._matmul(inv, src))
            for ci, col in enumerate(col_ids):
                decoded[col][:] = out[ci].data
        # wanted missing parity: re-encode from (now complete) data windows
        lost_parity = [i for i in range(m)
                       if (k + i) in want_to_read and (k + i) not in available]
        if lost_parity:
            data = np.stack([
                np.frombuffer(decoded[i], dtype=np.uint8)
                for i in range(k)])
            parity = np.ascontiguousarray(
                self._matmul(self.matrix[lost_parity, :], data))
            for row, i in enumerate(lost_parity):
                decoded[k + i][:] = parity[row].data
