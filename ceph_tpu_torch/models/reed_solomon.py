"""Generator-matrix constructions for Reed-Solomon and Cauchy codes
(port of ceph_tpu/models/reed_solomon.py, w=8).

These reproduce the published constructions of jerasure's reed_sol.c and
cauchy.c (Plank's tutorial and its 2003 correction), so that encoded
chunks are bit-identical with jerasure's for technique=reed_sol_van /
reed_sol_r6_op / cauchy_orig at w=8.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ops.gf import (gf_const_to_bits, gf_div, gf_inv,
                                   gf_invert_matrix, gf_matmul_ref, gf_mul,
                                   gf_pow)


def _mul(a: int, b: int) -> int:
    return int(gf_mul(a, b))


def reed_sol_van_matrix(k: int, m: int) -> np.ndarray:
    """(m, k) coding matrix, jerasure reed_sol_vandermonde_coding_matrix(w=8):
    extended Vandermonde -> systematic by column ops -> coding columns
    scaled so the first coding row is all ones."""
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for w=8")
    rows, cols = k + m, k
    v = np.zeros((rows, cols), dtype=np.int64)
    v[0, 0] = 1
    if rows > 1:
        v[rows - 1, cols - 1] = 1
        for i in range(1, rows - 1):
            acc = 1
            for j in range(cols):
                v[i, j] = acc
                acc = _mul(acc, i)
    # systematize (column ops)
    for i in range(k):
        if v[i, i] == 0:
            for j in range(i + 1, k):
                if v[i, j] != 0:
                    v[:, [i, j]] = v[:, [j, i]]
                    break
            else:
                raise ValueError("vandermonde not reducible")
        if v[i, i] != 1:
            c = gf_inv(int(v[i, i]))
            for r in range(rows):
                v[r, i] = _mul(int(v[r, i]), c)
        for j in range(k):
            if j != i and v[i, j] != 0:
                c = int(v[i, j])
                for r in range(rows):
                    v[r, j] ^= _mul(int(v[r, i]), c)
    # scale coding columns so coding row 0 is all ones
    coding = v[k:]
    for j in range(k):
        if coding[0, j] not in (0, 1):
            c = gf_inv(int(coding[0, j]))
            for r in range(m):
                coding[r, j] = _mul(int(coding[r, j]), c)
    return coding.astype(np.uint8)


def reed_sol_r6_matrix(k: int) -> np.ndarray:
    """(2, k) RAID-6 matrix: row0 = ones (P), row1 = powers of 2 (Q).

    jerasure reed_sol_r6_coding_matrix; technique=reed_sol_r6_op.
    """
    m = np.zeros((2, k), dtype=np.uint8)
    m[0, :] = 1
    for j in range(k):
        m[1, j] = gf_pow(2, j)
    return m


def cauchy_orig_matrix(k: int, m: int) -> np.ndarray:
    """(m, k) Cauchy matrix: element (i, j) = 1 / (i XOR (m + j)) in GF(2^8).

    jerasure cauchy_original_coding_matrix; technique=cauchy_orig.
    """
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for w=8")
    out = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            out[i, j] = gf_div(1, i ^ (m + j))
    return out


def cauchy_good_matrix(k: int, m: int) -> np.ndarray:
    """Improved Cauchy matrix (jerasure cauchy_good technique).

    Divide column j by element (0, j) so row 0 is all ones, then for each
    later row pick, among the row's own elements, the divisor that gives
    the fewest ones in the bit matrix.
    """
    mat = cauchy_orig_matrix(k, m)
    for j in range(k):
        a = int(mat[0, j])
        if a != 1:
            mat[:, j] = gf_mul(mat[:, j], np.uint8(gf_inv(a)))

    def row_ones(row: np.ndarray) -> int:
        return int(sum(gf_const_to_bits(int(c)).sum() for c in row))

    for i in range(1, m):
        best = mat[i].copy()
        best_ones = row_ones(best)
        for div in set(int(c) for c in mat[i] if c > 1):
            cand = gf_mul(mat[i], np.uint8(gf_inv(div)))
            ones = row_ones(cand)
            if ones < best_ones:
                best, best_ones = cand, ones
        mat[i] = best
    return mat


def decode_matrix(coding: np.ndarray, k: int, erasures: list[int],
                  have: list[int]) -> np.ndarray:
    """Rows mapping the k chosen surviving chunks -> the erased chunks.

    Build the generator rows of the k surviving chunks, invert, then
    express every erased chunk (data via the inverse, coding via
    re-encoding) as a GF(2^8) combination of the survivors.

    coding: (m, k) coding matrix.  have: exactly k surviving chunk ids in the
    order their buffers will be stacked.  Returns (len(erasures), k).
    """
    if len(have) != k:
        raise ValueError(f"need exactly {k} survivors, got {len(have)}")
    gen = np.zeros((k, k), dtype=np.uint8)
    for row, c in enumerate(have):
        if c < k:
            gen[row, c] = 1
        else:
            gen[row] = coding[c - k]
    inv = gf_invert_matrix(gen)  # survivors -> original data
    out = np.zeros((len(erasures), k), dtype=np.uint8)
    for row, e in enumerate(erasures):
        if e < k:
            out[row] = inv[e]
        else:
            # erased coding chunk: coding_row @ inv
            out[row] = gf_matmul_ref(coding[e - k : e - k + 1], inv)[0]
    return out
