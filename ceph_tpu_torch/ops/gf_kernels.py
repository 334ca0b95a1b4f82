"""GF(2^8) matrix x stripe-batch kernels (port of ceph_tpu/ops/gf_pallas.py).

The CUDA kernel of csrc/gf_matmul.cu works on packed 32-bit words: each
word carries 4 data bytes, and multiplying a word by x (the GF(2^8)
doubling step, polynomial 0x11d) is

    hi  = (v >> 7) & 0x01010101      # bit 7 of every byte, logical shift
    out = ((v << 1) & 0xfefefefe) ^ (hi * 0x1d)

Both wrappers launch one CUDA kernel, which runs a Horner schedule per
output: with P[j][s] the XOR of the inputs whose coefficient in row j has
bit s set, row j is acc = P[j][top], then acc = xtime(acc) ^ P[j][s] for
s from top - 1 down to 0 (multiplying by x is GF(2)-linear, so this
equals the sum of the coefficient products bit for bit).  The inputs are
held in registers in groups of up to 8; the schedule is one input mask
per (group, output, bit) and each (group, output)'s top bit.  The two
differ in where the schedule comes from:

* `gf_matmul_spec` serves the generators registered by codecs
  (`register_matrix`, at most 64): `spec_schedule` builds each one's
  schedule once, here, and the launch passes it.
* `gf_matmul_gen` serves every other matrix (the decode rows, which vary
  with the erasure pattern): the launch passes the coefficients and the
  C entry derives the same schedule from them on every launch, so one
  build covers every matrix and nothing is cached per matrix.

The interface is bytes: (..., K, S) uint8 in, (..., R, S) uint8 out, any
S % 4 == 0.  On a CUDA tensor each wrapper launches its kernel or raises;
on a CPU tensor it runs the plain version below, a ladder of powers on
int32 words in PyTorch (an independent algorithm: the oracle the kernel
is held against).
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ops import _build

MAX_R = 16  # GF_MAX_R / GF_MAX_K / GF_GROUP of csrc/gf_matmul.cu
MAX_K = 64
GROUP = 8   # inputs the kernel holds in registers at once

_MFE = int(0xFEFEFEFE) - (1 << 32)  # as signed int32 literals

# Encode matrices registered by codecs: these (and only these) go through
# gf_matmul_spec; everything else through gf_matmul_gen.  Each keeps its
# spec_schedule, built once here instead of on every launch (numpy takes
# tens of microseconds of host time for it).
_registered: dict = {}


def _coeff_key(matrix: np.ndarray) -> tuple:
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    return m.shape, m.tobytes()


def register_matrix(matrix: np.ndarray) -> None:
    """Mark a generator matrix as hot: it goes through gf_matmul_spec."""
    key = _coeff_key(matrix)
    if key not in _registered and len(_registered) < 64:
        _registered[key] = spec_schedule(matrix)


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
    """gf_matmul_spec's plain version: coefficients decide, on the host,
    which ladder powers XOR into which output."""
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


def spec_schedule(matrix: np.ndarray) -> tuple:
    """The kernel's schedule of a matrix, as the kernel receives it.

    Returns (masks, tops): masks (G, R, 8) uint8 with G = ceil(K / 8),
    bit i of masks[g, j, s] set when bit s of M[j, 8g + i] is set (so
    P[j][s] of group g is the XOR of the inputs its bits select); tops
    (G, R) int8, the highest s with a nonzero mask in group g, row j, or
    -1 when the group adds nothing to row j."""
    m = np.asarray(matrix, dtype=np.uint8)
    r, k = m.shape
    g = -(-k // GROUP)
    padded = np.zeros((r, g * GROUP), dtype=np.uint8)
    padded[:, :k] = m
    bits = (padded.reshape(r, g, GROUP, 1) >> np.arange(8, dtype=np.uint8)) & 1
    masks = (bits << np.arange(GROUP, dtype=np.uint8)[:, None]).sum(
        axis=2, dtype=np.uint8).transpose(1, 0, 2)            # (G, R, 8)
    nz = masks != 0
    tops = np.where(nz.any(axis=-1), 7 - np.argmax(nz[..., ::-1], axis=-1),
                    -1).astype(np.int8)
    return np.ascontiguousarray(masks), np.ascontiguousarray(tops)


def gf_matmul_gen_plain(matrix: np.ndarray,
                        data: torch.Tensor) -> torch.Tensor:
    """gf_matmul_gen's plain version, the TPU generic kernel's ladder:
    every power is ANDed with the mask -(c >> s & 1) of its coefficient
    bit and XORed into the row."""
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
    """The kernel on a registered matrix's stored schedule: (..., K, S)
    uint8 -> (..., R, S) uint8."""
    if data.device.type == "cpu":
        return _into(out, gf_matmul_spec_plain(matrix, data))
    m, r, k, s, b, out = _check_cuda(matrix, data, out)
    if b == 0:
        return out
    sched = _registered.get(_coeff_key(m))
    masks, tops = sched if sched is not None else spec_schedule(m)
    lib = _build.load()["gf_matmul"]
    gf_matmul_spec.launches += 1
    _build.check(lib.gf_matmul_spec(
        masks.ctypes.data, tops.ctypes.data, r, k, data.device.index or 0,
        data.data_ptr(), out.data_ptr(), b, s,
        torch.cuda.current_stream(data.device).cuda_stream),
        "gf_matmul_spec")
    return out


def gf_matmul_gen(matrix: np.ndarray, data: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel on any matrix, its schedule derived by the C entry on
    every launch: (..., K, S) uint8 -> (..., R, S) uint8."""
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
    gf_matmul_spec for registered matrices, gf_matmul_gen for all
    others."""
    if is_registered(matrix):
        return gf_matmul_spec(matrix, data, out)
    return gf_matmul_gen(matrix, data, out)
