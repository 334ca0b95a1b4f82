"""GF(2^8) algebra for erasure coding (port of ceph_tpu/ops/gf.py).

Field: GF(2^8) with primitive polynomial 0x11d and generator x (= 2), the
field jerasure/gf-complete and isa-l use for w=8, so encoded chunks are
bit-identical with theirs.

The host half (tables, scalar ops, the numpy oracle `gf_matmul_ref`,
matrix inversion and the GF(2) bit decomposition) is a copy of the
reference module's.  The device half has two forms:

* `gf2_matmul_bytes`: the bit-decomposition product (an integer matmul of
  the (8R, 8K) GF(2) matrix against the data's bit planes, reduced mod 2)
  as plain PyTorch.  It is the twin of the JAX XLA path and stays off the
  CUDA main path.
* `gf_matmul_device`: the entry the codec uses; it routes to the
  hand-written CUDA kernels of ops/gf_kernels.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ops import gf_kernels

# ---------------------------------------------------------------------------
# Field tables (host, numpy)
# ---------------------------------------------------------------------------

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, jerasure/gf-complete w=8 default
GF_ORDER = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)  # doubled to skip the mod-255 on reads
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:510] = exp[0:255]
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a, b):
    """Elementwise GF(2^8) product of uint8 arrays (numpy)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = GF_EXP[GF_LOG[a] + GF_LOG[b]]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return int(GF_EXP[255 - GF_LOG[a]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] - GF_LOG[b]) % 255])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] * n) % 255])


def gf_matmul_ref(m: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Reference GF(2^8) matmul on host: (R,K) x (K,S) -> (R,S), XOR-accumulate.

    Independent oracle for the kernels.
    """
    m = np.asarray(m, dtype=np.uint8)
    d = np.asarray(d, dtype=np.uint8)
    r, k = m.shape
    out = np.zeros((r, d.shape[1]), dtype=np.uint8)
    for j in range(r):
        acc = np.zeros(d.shape[1], dtype=np.uint8)
        for i in range(k):
            c = int(m[j, i])
            if c == 0:
                continue
            if c == 1:
                acc ^= d[i]
            else:
                acc ^= gf_mul(np.full((), c, np.uint8), d[i])
        out[j] = acc
    return out


def gf_invert_matrix(a: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss-Jordan elimination (host)."""
    a = np.array(a, dtype=np.uint8)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"not a square matrix: {a.shape}")
    aug = np.concatenate([a, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if aug[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise np.linalg.LinAlgError("singular GF(2^8) matrix")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv = gf_inv(int(aug[col, col]))
        aug[col] = gf_mul(aug[col], np.full((), inv, np.uint8))
        for row in range(n):
            if row != col and aug[row, col] != 0:
                aug[row] ^= gf_mul(aug[col], np.full((), aug[row, col], np.uint8))
    return aug[:, n:]


# ---------------------------------------------------------------------------
# Bit-decomposition: GF(2^8) matrix -> GF(2) matrix
# ---------------------------------------------------------------------------


def gf_const_to_bits(c: int) -> np.ndarray:
    """8x8 GF(2) matrix of 'multiply by c': column b = bits(c * x^b)."""
    cols = []
    for b in range(8):
        v = gf_mul(np.full((), c, np.uint8), np.full((), 1 << b, np.uint8))
        cols.append([(int(v) >> o) & 1 for o in range(8)])
    return np.array(cols, dtype=np.uint8).T  # (out_bit, in_bit)


def gf_matrix_to_bits(m: np.ndarray) -> np.ndarray:
    """(R,K) GF(2^8) matrix -> (8R, 8K) GF(2) 0/1 matrix.

    Row j*8+o, col i*8+b is bit o of (m[j,i] * x^b): output bit (j,o) is the
    XOR over data bits (i,b) selected by this matrix.
    """
    m = np.asarray(m, dtype=np.uint8)
    r, k = m.shape
    out = np.zeros((8 * r, 8 * k), dtype=np.uint8)
    for j in range(r):
        for i in range(k):
            out[j * 8 : j * 8 + 8, i * 8 : i * 8 + 8] = gf_const_to_bits(int(m[j, i]))
    return out


# ---------------------------------------------------------------------------
# Device half (PyTorch)
# ---------------------------------------------------------------------------


def _unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """(..., K, S) uint8 -> (..., 8K, S) bit planes (LSB-first per byte)."""
    k, s = data.shape[-2], data.shape[-1]
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = (data[..., :, None, :] >> shifts[None, :, None]) & 1
    return bits.reshape(*data.shape[:-2], k * 8, s)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8R, S) 0/1 int32 -> (..., R, S) uint8 (LSB-first per byte)."""
    r8, s = bits.shape[-2], bits.shape[-1]
    b = bits.reshape(*bits.shape[:-2], r8 // 8, 8, s).to(torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32,
                                 device=bits.device))[None, :, None]
    return torch.sum(b * weights, dim=-2).to(torch.uint8)


def gf2_matmul_bytes(mbits, data: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matmul by bit decomposition: mbits (8R, 8K) 0/1, data
    (..., K, S) uint8 -> (..., R, S) uint8.

    The contraction runs in float32 (exact: the sums are at most 8K,
    far below 2^24), then is reduced mod 2.  Plain PyTorch, off the
    CUDA main path: the kernels of ops/gf_kernels.py replace it there.
    """
    mb = torch.as_tensor(np.asarray(mbits), device=data.device).to(
        torch.float32)
    bits = _unpack_bits(data).to(torch.float32)
    prod = torch.matmul(mb, bits)          # (..., 8R, S)
    par = prod.to(torch.int32) & 1
    return _pack_bits(par)


def gf_matmul_device(m: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """(R,K) GF(2^8) matrix x (..., K, S) uint8 tensor -> (..., R, S).

    Routes to ops/gf_kernels.gf_matmul: gf_matmul_spec for registered
    generators, gf_matmul_gen for every other matrix.  On
    a CUDA tensor that launches a kernel (never the bit decomposition);
    on a CPU tensor it runs the kernels' plain versions.
    """
    return gf_kernels.gf_matmul(m, data)
