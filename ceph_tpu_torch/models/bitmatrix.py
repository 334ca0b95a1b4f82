"""GF(2) bitmatrix constructions for the RAID-6 bit-matrix codes (a copy
of ceph_tpu/models/bitmatrix.py: the port imports nothing of the JAX
package).

Reference parity: the jerasure plugin's bitmatrix trio
(src/erasure-code/jerasure/ErasureCodeJerasure.cc:452 liberation, :476
blaum_roth, :488-513 liber8tion in Ceph's tree).  The constructions are
written from the published definitions:

- liberation: Plank, "The RAID-6 Liberation Codes" (FAST 2008).
  w prime, k <= w, m = 2.  P block = k identities; Q block's X_i is
  the i-step bit rotation plus, for i > 0, one extra 1 at row
  (i*(w-1)/2) mod w, column (row + i - 1) mod w — the minimal-density
  construction from the paper (kw + k - 1 total ones).
- blaum_roth: Blaum & Roth, "On Lowest Density MDS Codes" (IT 1999).
  w + 1 prime, k <= w, m = 2.  Q block's X_i = C^i where C is
  multiplication by x in the ring GF(2)[x]/(1 + x + ... + x^w)
  (subdiagonal shift with an all-ones last column).
- liber8tion: Plank, "The RAID-6 Liber8tion Code" (w = 8, m = 2,
  k <= 8).  Upstream's X matrices are a hard-coded exhaustive-search
  table (liber8tion.c) that is not available in this tree; this build
  derives the X_i from the GF(2^8) companion ladder (X_i = C^i over
  poly 0x11d), which keeps the technique's contract — an MDS RAID-6
  bitmatrix at w=8 with single-XOR-per-bit P — but does NOT claim
  wire-level chunk compatibility with upstream liber8tion (density is
  not minimal either).  Documented deviation, not an oversight.

Matrix convention matches jerasure's bitmatrix layout: (m*w, k*w)
with out_bit[j*w + r] = XOR over data bits [i*w + c] where
bm[j*w + r, i*w + c] == 1; data bit (i, c) is packet c of data chunk
i (jerasure_bitmatrix_encode packet semantics).
"""

from __future__ import annotations

import numpy as np


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    i = 2
    while i * i <= n:
        if n % i == 0:
            return False
        i += 1
    return True


def liberation_bitmatrix(k: int, w: int) -> np.ndarray:
    """(2w, kw) liberation coding bitmatrix (FAST'08 construction)."""
    if not _is_prime(w):
        raise ValueError(f"liberation: w={w} must be prime")
    if k > w:
        raise ValueError(f"liberation: k={k} must be <= w={w}")
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        for i in range(w):
            bm[i, j * w + i] = 1                    # P: identity blocks
            bm[w + i, j * w + (j + i) % w] = 1      # Q: rotation by j
        if j > 0:
            i = (j * ((w - 1) // 2)) % w            # the extra 1
            bm[w + i, j * w + (i + j - 1) % w] = 1
    return bm


def _ladder_bitmatrix(c_mat: np.ndarray, k: int) -> np.ndarray:
    """(2w, kw) RAID-6 bitmatrix with X_i = C^i: P = identities,
    Q = the companion ladder of c_mat (shared by blaum_roth and
    liber8tion, which differ only in their rings)."""
    w = c_mat.shape[0]
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    x = np.eye(w, dtype=np.uint8)
    for j in range(k):
        bm[:w, j * w:(j + 1) * w] = np.eye(w, dtype=np.uint8)
        bm[w:, j * w:(j + 1) * w] = x
        x = (c_mat.astype(np.uint32) @ x) & 1
    return bm


def blaum_roth_bitmatrix(k: int, w: int) -> np.ndarray:
    """(2w, kw) Blaum-Roth coding bitmatrix (ring construction)."""
    if not _is_prime(w + 1):
        raise ValueError(f"blaum_roth: w+1={w + 1} must be prime")
    if k > w:
        raise ValueError(f"blaum_roth: k={k} must be <= w={w}")
    # C = multiplication by x in GF(2)[x]/(1 + x + ... + x^w):
    # x * x^c = x^{c+1} for c < w-1; x * x^{w-1} = x^w = sum_t x^t
    c_mat = np.zeros((w, w), dtype=np.uint8)
    for r in range(1, w):
        c_mat[r, r - 1] = 1
    c_mat[:, w - 1] ^= 1
    return _ladder_bitmatrix(c_mat, k)


def _companion_gf256() -> np.ndarray:
    """Multiplication-by-x matrix of GF(2^8)/0x11d on coefficient bits."""
    c = np.zeros((8, 8), dtype=np.uint8)
    for r in range(1, 8):
        c[r, r - 1] = 1
    # x^8 = x^4 + x^3 + x^2 + 1 (0x1d)
    for bit in (0, 2, 3, 4):
        c[bit, 7] ^= 1
    return c


def liber8tion_bitmatrix(k: int) -> np.ndarray:
    """(16, 8k) w=8 RAID-6 bitmatrix (module docstring: companion-
    ladder derivation, not upstream's searched table)."""
    if k > 8:
        raise ValueError(f"liber8tion: k={k} must be <= 8")
    return _ladder_bitmatrix(_companion_gf256(), k)


def packet_views(buf, w: int, packetsize: int) -> list:
    """One chunk's buffer -> its w per-packet (blocks, packetsize)
    numpy views, zero-copy.

    The jerasure packet convention this module's matrices index:
    a chunk of b*w*packetsize bytes is b repeats of w packets;
    bitmatrix column i*w + c selects packet c of chunk i across every
    block.  ``packet_views(chunk_i, w, ps)[c]`` IS that column — a
    strided view over the caller's buffer (bytearray, memoryview or
    ndarray; writable buffers yield writable views, so coding/
    recovered chunks are written in place).  The XOR-schedule host
    tier (ec/xsched.execute_host) runs directly over these views —
    no stack, no transpose, no copies."""
    if isinstance(buf, np.ndarray):
        # a non-contiguous array would make reshape COPY — writes
        # into the views would land in the throwaway copy, not the
        # caller's buffer.  Refuse loudly rather than corrupt parity.
        assert buf.flags.c_contiguous, \
            "packet_views needs a contiguous buffer"
        arr = buf.reshape(-1)
    else:
        arr = np.frombuffer(buf, dtype=np.uint8)
    arr = arr.reshape(-1, w, packetsize)
    return [arr[:, c, :] for c in range(w)]


def gf2_inv(mat: np.ndarray) -> np.ndarray:
    """Invert a square 0/1 matrix over GF(2) (Gaussian elimination)."""
    n = mat.shape[0]
    assert mat.shape == (n, n)
    a = mat.astype(np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        pivot = None
        for r in range(col, n):
            if a[r, col]:
                pivot = r
                break
        if pivot is None:
            raise ValueError("singular GF(2) matrix")
        if pivot != col:
            a[[col, pivot]] = a[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] ^= a[col]
                inv[r] ^= inv[col]
    return inv


def decode_bitmatrix(bm: np.ndarray, k: int, w: int,
                     have: tuple, erasures: tuple) -> np.ndarray:
    """Rows mapping k surviving chunks' bits -> the erased chunks' bits.

    bm is the (m*w, k*w) coding matrix; chunk ids 0..k-1 are data,
    k..k+m-1 coding.  `have` lists the k surviving chunk ids (in the
    order their packets will be stacked); returns
    (len(erasures)*w, k*w) GF(2) rows (the isa-plugin decode strategy
    — invert the surviving submatrix — in bit-space).
    """
    kw = k * w
    full = np.concatenate([np.eye(kw, dtype=np.uint8), bm], axis=0)
    gs = np.concatenate(
        [full[c * w:(c + 1) * w] for c in have], axis=0)   # (kw, kw)
    inv = gf2_inv(gs)
    rows = []
    for e in erasures:
        target = full[e * w:(e + 1) * w]                   # (w, kw)
        rows.append((target.astype(np.uint32) @ inv) & 1)
    return np.concatenate(rows, axis=0).astype(np.uint8)
