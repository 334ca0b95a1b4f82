"""Fixed-point log2 lookup tables for straw2 (crush_ln); a copy of
ceph_tpu/crush/ln_table.py.

The reference ships precomputed tables (src/crush/
crush_ln_table.h) with the generating formulas in comments:

  RH_LH_tbl[2k]   = 2^48 / (1 + k/128)        (reciprocal, high part)
  RH_LH_tbl[2k+1] = 2^48 * log2(1 + k/128)    (log, high part)
  LL_tbl[j]       = 2^48 * log2(1 + j/2^15)   (log, low part)

We *generate* the tables from those formulas rather than embedding 258+256
magic numbers.  Empirically-determined rounding of the reference generator
(verified entry-by-entry against the shipped header):

  - RH entries round *up* (ceil);
  - LH and LL entries round down (floor);
  - LH[k=128] is clamped to 0xffff00000000 (never indexed by crush_ln —
    x>>8 <= 255 — but matched for table equality);
  - LL entries 2..254 carry a constant +0x147700000 bias over the exact
    floor — an artifact of the original generator that is part of the
    de-facto wire behavior (the Linux kernel ships the same values), so we
    reproduce it as a protocol constant.

Exactness here is what makes `placement diff = 0` against reference
crushtool possible (BASELINE.md config #4).
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np

_LL_INTERIOR_BIAS = 0x147700000


def _ceil_frac(f: Fraction) -> int:
    return -((-f.numerator) // f.denominator)


def build_rh_lh_table() -> np.ndarray:
    out = np.zeros(258, dtype=np.int64)
    for k in range(129):
        out[2 * k] = _ceil_frac(Fraction(2**48 * 128, 128 + k))
        if k == 0:
            lh = 0
        elif k == 128:
            lh = 0xFFFF00000000
        else:
            lh = math.floor(Fraction(2**48) * Fraction(math.log2(1 + k / 128.0)))
        out[2 * k + 1] = lh
    return out


def build_ll_table() -> np.ndarray:
    out = np.zeros(256, dtype=np.int64)
    for j in range(256):
        v = math.floor(Fraction(2**48) * Fraction(math.log2(1 + j / 2**15)))
        if 2 <= j <= 254:
            v += _LL_INTERIOR_BIAS
        out[j] = v
    return out


RH_LH_TBL = build_rh_lh_table()
LL_TBL = build_ll_table()


def crush_ln(xin: int) -> int:
    """2^44 * log2(xin + 1), the straw2 fixed-point log (mapper.c:248-290)."""
    x = (int(xin) + 1) & 0xFFFFFFFF
    iexpon = 15
    if not (x & 0x18000):
        bits = 16 - (x & 0x1FFFF).bit_length()
        x <<= bits
        iexpon = 15 - bits
    index1 = (x >> 8) << 1
    rh = int(RH_LH_TBL[index1 - 256])
    lh = int(RH_LH_TBL[index1 + 1 - 256])
    xl64 = (x * rh) >> 48
    result = iexpon << 44
    index2 = xl64 & 0xFF
    lh = lh + int(LL_TBL[index2])
    result += lh >> 4
    return result


def straw2_draws(u16: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Vectorized numpy draw: ln(u)/weight with S64_MIN for zero weights.

    u16: uint32 array of 16-bit hash values; weights: uint32 16.16 fixed.
    Mirrors generate_exponential_distribution (mapper.c:334-359).
    """
    lns = np.array([crush_ln(int(u)) for u in u16.ravel()],
                   dtype=np.int64).reshape(u16.shape)
    ln = lns - 0x1000000000000
    w = weights.astype(np.int64)
    draws = np.where(w > 0, _div64(ln, w), np.int64(-(2**63)))
    return draws


def _div64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """C-style truncating signed 64-bit division (div64_s64)."""
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) != (b < 0), -q, q).astype(np.int64)
