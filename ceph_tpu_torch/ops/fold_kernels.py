"""GF(2^8) row-weighted XOR fold of shard streams (port of the XLA device
code of ceph_tpu/compute/kernels.py, `make_device_eval`).

`gf_fold(weights, data)` folds a (B, rows, lanes) uint8 batch into
(B, 1, lanes): out[b, 0, l] = XOR over r of w[r] * data[b, r, l] in GF(2^8)
(polynomial 0x11d).  `weights` is None for all-ones rows, a plain XOR fold
(the gf_fold compute kernel), or a (rows,) uint8 tensor on the batch's device
(the gf_fingerprint kernel's row weights).  On a CUDA tensor it launches the
kernel of csrc/gf_fold.cu (one launch a call) or raises; on a CPU tensor it
runs the plain version, `gf_fold_plain`: a GF table multiply, then a
pairwise XOR tree over the rows, written independently of the kernel's
bit-plane accumulation.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.ops.gf import GF_EXP, GF_LOG

MAX_LANES = 1024    # FOLD_MAX_LANES of csrc/gf_fold.cu

# the 256 x 256 product table, row a holding a * x for every byte x
_MUL = np.zeros((256, 256), dtype=np.uint8)
_MUL[1:, 1:] = GF_EXP[GF_LOG[1:, None] + GF_LOG[None, 1:]]
_mul_tables: dict = {}


def _mul_table(device: torch.device) -> torch.Tensor:
    got = _mul_tables.get(device)
    if got is None:
        got = _mul_tables[device] = torch.from_numpy(_MUL.reshape(-1)).to(
            device)
    return got


def _check(weights, data: torch.Tensor) -> None:
    if data.dim() != 3 or data.dtype != torch.uint8:
        raise ValueError(f"expected (B, rows, lanes) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if weights is not None and (
            weights.dtype != torch.uint8 or weights.dim() != 1
            or weights.shape[0] != data.shape[1]
            or weights.device != data.device):
        raise ValueError(f"weights must be a ({data.shape[1]},) uint8 tensor"
                         f" on {data.device}")


def gf_fold_plain(weights, data: torch.Tensor) -> torch.Tensor:
    """(B, rows, lanes) uint8 -> (B, 1, lanes) uint8 in plain PyTorch on
    the tensor's device."""
    _check(weights, data)
    x = data
    if weights is not None:
        idx = weights.to(torch.int64)[None, :, None] * 256 + data.to(
            torch.int64)
        x = _mul_table(data.device)[idx]
    if x.shape[1] == 0:
        return torch.zeros((x.shape[0], 1, x.shape[2]), dtype=torch.uint8,
                           device=data.device)
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        top = x[:, :half] ^ x[:, half:2 * half]
        if x.shape[1] % 2:
            top[:, :1] ^= x[:, -1:]
        x = top
    return x.clone() if x is data else x


def gf_fold(weights, data: torch.Tensor,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """(B, rows, lanes) uint8 -> (B, 1, lanes) uint8: the CUDA kernel on a
    CUDA tensor (contiguous, 16-byte aligned, lanes a multiple of 4 up to
    MAX_LANES), the plain version on a CPU tensor."""
    _check(weights, data)
    if data.device.type == "cpu":
        res = gf_fold_plain(weights, data)
        if out is None:
            return res
        out.copy_(res)
        return out
    b, rows, lanes = data.shape
    if lanes < 4 or lanes % 4 or lanes > MAX_LANES:
        raise ValueError(f"lanes {lanes} is not a multiple of 4 in"
                         f" [4, {MAX_LANES}]")
    if not data.is_contiguous() or data.data_ptr() % 16:
        raise ValueError("data must be contiguous and 16-byte aligned")
    if weights is not None and not weights.is_contiguous():
        raise ValueError("weights must be contiguous")
    shape = (b, 1, lanes)
    if out is None:
        out = torch.empty(shape, dtype=torch.uint8, device=data.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.uint8
          or out.device != data.device or not out.is_contiguous()
          or out.data_ptr() % 4):
        raise ValueError(f"out must be a contiguous, 4-byte aligned uint8"
                         f" {shape} tensor on {data.device}")
    if b == 0:
        return out
    if rows == 0:
        return out.zero_()
    lib = _build.load()["gf_fold"]
    gf_fold.launches += 1
    _build.check(lib.gf_fold(
        None if weights is None else weights.data_ptr(),
        data.device.index or 0, data.data_ptr(), out.data_ptr(), b, rows,
        lanes, torch.cuda.current_stream(data.device).cuda_stream),
        "gf_fold")
    return out


gf_fold.launches = 0
