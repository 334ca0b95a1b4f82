"""GF(2^8) matrix x stripe-batch kernels (port of ceph_tpu/ops/gf_pallas.py).

Two CUDA kernels in csrc/gf_matmul.cu share the packed-word xtime ladder:
each 32-bit word carries 4 data bytes, and multiplying a word by x (the
GF(2^8) doubling step, polynomial 0x11d) is

    hi  = (v >> 7) & 0x01010101      # bit 7 of every byte, logical shift
    out = ((v << 1) & 0xfefefefe) ^ (hi * 0x1d)

A coefficient c contributes the XOR of the ladder powers selected by its
set bits.

* `gf_matmul_spec` serves the generators registered by codecs
  (`register_matrix`, at most 64): the host resolves the matrix into the
  XOR selection per (input, ladder step), and the kernel XORs each power
  into the selected outputs only.
* `gf_matmul_gen` serves every other matrix (the decode rows, which vary
  with the erasure pattern): the kernel ANDs each power with the mask
  -(c >> s & 1).  One build covers every matrix.

The interface is bytes: (..., K, S) uint8 in, (..., R, S) uint8 out, any
S % 4 == 0.  On a CUDA tensor each wrapper launches its kernel or raises;
on a CPU tensor it runs the plain version below, which repeats the same
ladder on int32 words in PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ops import _build

MAX_R = 16  # GF_MAX_R / GF_MAX_K of csrc/gf_matmul.cu
MAX_K = 64

_MFE = int(0xFEFEFEFE) - (1 << 32)  # as signed int32 literals

# Encode matrices registered by codecs: these (and only these) take the
# specialised kernel; everything else takes the generic one.
_registered: set = set()


def _coeff_key(matrix: np.ndarray) -> tuple:
    m = np.asarray(matrix, dtype=np.uint8)
    return tuple(tuple(int(c) for c in row) for row in m)


def register_matrix(matrix: np.ndarray) -> None:
    """Mark a generator matrix as hot: it takes the specialised kernel."""
    if len(_registered) < 64:
        _registered.add(_coeff_key(matrix))


def is_registered(matrix: np.ndarray) -> bool:
    return _coeff_key(matrix) in _registered


# ---------------------------------------------------------------------------
# Plain versions (PyTorch, int32 words)
# ---------------------------------------------------------------------------


def _words(data: torch.Tensor, k: int) -> torch.Tensor:
    """(..., K, S) uint8 -> (..., K, S/4) int32 view (little-endian)."""
    if data.dtype != torch.uint8 or data.dim() < 2 or data.shape[-2] != k:
        raise ValueError(f"expected (..., {k}, S) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if data.shape[-1] % 4:
        raise ValueError(f"chunk size {data.shape[-1]} is not a multiple of 4")
    return data.contiguous().view(torch.int32)


def _xtime(v: torch.Tensor) -> torch.Tensor:
    """Multiply every packed byte by x.  torch has no logical shift for
    int32, so the arithmetic >> 7 is masked to the four byte-low bits,
    which drops the sign bits it smears in."""
    hi = (v >> 7) & 0x01010101
    return ((v << 1) & _MFE) ^ (hi * 0x1D)


def gf_matmul_spec_plain(matrix: np.ndarray,
                         data: torch.Tensor) -> torch.Tensor:
    """The specialised kernel's arithmetic: coefficients decide, on the
    host, which ladder powers XOR into which output."""
    coeffs = np.asarray(matrix, dtype=np.uint8)
    r, k = coeffs.shape
    w = _words(data, k)
    acc = [None] * r
    u = [w[..., i, :] for i in range(k)]
    for s in range(8):
        for j in range(r):
            for i in range(k):
                if (int(coeffs[j, i]) >> s) & 1:
                    acc[j] = u[i] if acc[j] is None else acc[j] ^ u[i]
        if s != 7:
            u = [_xtime(x) for x in u]
    zero = torch.zeros_like(w[..., 0, :])
    out = torch.stack([zero if a is None else a for a in acc], dim=-2)
    return out.view(torch.uint8)


def gf_matmul_gen_plain(matrix: np.ndarray,
                        data: torch.Tensor) -> torch.Tensor:
    """The generic kernel's arithmetic: every power is ANDed with the
    mask -(c >> s & 1) of its coefficient bit and XORed into the row."""
    coeffs = np.asarray(matrix, dtype=np.uint8)
    r, k = coeffs.shape
    w = _words(data, k)
    bits = (coeffs[:, :, None] >> np.arange(8)) & 1          # (R, K, 8)
    mask = torch.from_numpy(-bits.astype(np.int32)).to(w.device)
    acc = torch.zeros((*w.shape[:-2], r, w.shape[-1]), dtype=torch.int32,
                      device=w.device)
    for i in range(k):
        p = w[..., i, :].unsqueeze(-2)                       # (..., 1, W)
        for s in range(8):
            acc ^= p & mask[:, i, s, None]
            if s != 7:
                p = _xtime(p)
    return acc.view(torch.uint8)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _into(out: torch.Tensor | None, res: torch.Tensor) -> torch.Tensor:
    if out is None:
        return res
    out.copy_(res)
    return out


def _check_cuda(matrix: np.ndarray, data: torch.Tensor,
                out: torch.Tensor | None) -> tuple:
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    if m.ndim != 2:
        raise ValueError(f"matrix must be (R, K), got {m.shape}")
    r, k = m.shape
    if not (1 <= r <= MAX_R and 1 <= k <= MAX_K):
        raise ValueError(f"matrix {m.shape} exceeds the kernel's "
                         f"R <= {MAX_R}, K <= {MAX_K}")
    if data.dtype != torch.uint8 or data.dim() < 2 or data.shape[-2] != k:
        raise ValueError(f"expected (..., {k}, S) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    s = data.shape[-1]
    if s < 4 or s % 4:
        raise ValueError(f"chunk size {s} is not a positive multiple of 4")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")
    shape = (*data.shape[:-2], r, s)
    if out is None:
        out = torch.empty(shape, dtype=torch.uint8, device=data.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.uint8
          or out.device != data.device or not out.is_contiguous()
          or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous, 16-byte aligned uint8 "
                         f"{shape} tensor on {data.device}")
    b = data.numel() // (k * s)
    return m, r, k, s, b, out


def gf_matmul_spec(matrix: np.ndarray, data: torch.Tensor,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """The specialised kernel: (..., K, S) uint8 -> (..., R, S) uint8."""
    if data.device.type == "cpu":
        return _into(out, gf_matmul_spec_plain(matrix, data))
    m, r, k, s, b, out = _check_cuda(matrix, data, out)
    if b == 0:
        return out
    bits = (m[:, :, None] >> np.arange(8)) & 1                 # (R, K, 8)
    sel = np.ascontiguousarray(
        (bits.astype(np.uint16) << np.arange(r, dtype=np.uint16)[:, None,
                                                                  None])
        .sum(axis=0, dtype=np.uint16))                         # (K, 8)
    lib = _build.load()["gf_matmul"]
    gf_matmul_spec.launches += 1
    _build.check(lib.gf_matmul_spec(
        sel.ctypes.data, r, k, data.device.index or 0, data.data_ptr(),
        out.data_ptr(), b, s, torch.cuda.current_stream(data.device)
        .cuda_stream), "gf_matmul_spec")
    return out


def gf_matmul_gen(matrix: np.ndarray, data: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """The generic kernel: (..., K, S) uint8 -> (..., R, S) uint8."""
    if data.device.type == "cpu":
        return _into(out, gf_matmul_gen_plain(matrix, data))
    m, r, k, s, b, out = _check_cuda(matrix, data, out)
    if b == 0:
        return out
    lib = _build.load()["gf_matmul"]
    gf_matmul_gen.launches += 1
    _build.check(lib.gf_matmul_gen(
        m.ctypes.data, r, k, data.device.index or 0, data.data_ptr(),
        out.data_ptr(), b, s, torch.cuda.current_stream(data.device)
        .cuda_stream), "gf_matmul_gen")
    return out


gf_matmul_spec.launches = 0
gf_matmul_gen.launches = 0


def gf_matmul(matrix: np.ndarray, data: torch.Tensor,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """(R,K) GF(2^8) matrix x (..., K, S) uint8 -> (..., R, S) uint8:
    the specialised kernel for registered matrices, the generic one for
    all others."""
    if is_registered(matrix):
        return gf_matmul_spec(matrix, data, out)
    return gf_matmul_gen(matrix, data, out)
