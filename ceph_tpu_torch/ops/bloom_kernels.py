"""Bloom-filter bit positions of the hit sets (port of the XLA device code
of ceph_tpu/osd/hitset.py, `bloom_positions` with xp=jnp).

`bloom_positions(hashes, nbits, nhash)` maps a [B] tensor of uint32 object
hashes (int32 bit patterns, or any integer tensor whose values are uint32)
to the [B, nhash] positions `hash32_2(h, i) % nbits`, seed i for position
i, as int32 bit patterns of the uint32 values.  On a CUDA tensor it
launches the kernel of csrc/hitset_bloom.cu, one launch a call, or raises;
on a CPU tensor it runs the plain version, osd/hitset.py
`bloom_positions_torch` (rjenkins in eager PyTorch, `%` in int64).
"""

from __future__ import annotations

import torch

from ceph_tpu_torch.ops import _build

MAX_NHASH = 32          # BLOOM_MAX_NHASH of csrc/hitset_bloom.cu
MAX_NBITS = (1 << 32) - 1


def _check(hashes: torch.Tensor, nbits: int, nhash: int) -> None:
    if hashes.dim() != 1 or hashes.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"expected a [B] int32 or int64 tensor, got"
                         f" {tuple(hashes.shape)} {hashes.dtype}")
    if not 1 <= int(nhash) <= MAX_NHASH:
        raise ValueError(f"nhash {nhash} is not in [1, {MAX_NHASH}]")
    if not 1 <= int(nbits) <= MAX_NBITS:
        raise ValueError(f"nbits {nbits} is not in [1, 2^32 - 1]")


def bloom_positions_plain(hashes: torch.Tensor, nbits: int,
                          nhash: int) -> torch.Tensor:
    """[B] -> [B, nhash] int32 bit patterns of the uint32 positions, in
    plain PyTorch on the tensor's device."""
    from ceph_tpu_torch.osd.hitset import bloom_positions_torch

    _check(hashes, nbits, nhash)
    pos = bloom_positions_torch(hashes, int(nbits), int(nhash))
    return torch.where(pos >= 1 << 31, pos - (1 << 32), pos).to(torch.int32)


def bloom_positions(hashes: torch.Tensor, nbits: int, nhash: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """[B] -> [B, nhash] int32: the CUDA kernel on a CUDA tensor (int32,
    contiguous), the plain version on a CPU tensor."""
    _check(hashes, nbits, nhash)
    if hashes.device.type == "cpu":
        res = bloom_positions_plain(hashes, nbits, nhash)
        if out is None:
            return res
        out.copy_(res)
        return out
    if hashes.dtype != torch.int32 or not hashes.is_contiguous():
        raise ValueError("hashes on the card must be a contiguous int32"
                         " tensor")
    shape = (hashes.shape[0], int(nhash))
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=hashes.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.int32
          or out.device != hashes.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 {shape} tensor on"
                         f" {hashes.device}")
    if hashes.shape[0] == 0:
        return out
    lib = _build.load()["hitset_bloom"]
    bloom_positions.launches += 1
    _build.check(lib.bloom_positions(
        hashes.data_ptr(), out.data_ptr(), hashes.shape[0], int(nhash),
        int(nbits), hashes.device.index or 0,
        torch.cuda.current_stream(hashes.device).cuda_stream),
        "bloom_positions")
    return out


bloom_positions.launches = 0
