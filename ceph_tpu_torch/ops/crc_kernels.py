"""Batched crc32c kernel (port of ceph_tpu/ops/crc_pallas.py).

`crc32c_blocks` computes the crc32c of N equal blocks with the CUDA kernel
of csrc/crc32c.cu: the zero-seeded crc of each block, then the seed's
advance through `length` zero bytes XORed in, exactly as the TPU entry
`crc32c_blocks_words` does.  Unlike the TPU kernel (blocks of at most
8 KiB) it takes any length that is a multiple of 4.

One thread block takes one crc block; each of its threads computes the
zero-seeded crc of one span of the block front-padded with zeros to
threads x span bytes, and the partials fold in a tree whose 32x32 GF(2)
zero-advance matrices (for span, 2 span, 4 span, ...) are built here.

On a CPU tensor the wrapper runs the plain version,
ops/checksum.crc32c_batch.  Crcs come back as int32 bit patterns.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.ops import checksum as cks

_MAX_THREADS = 256  # CRC_MAX_THREADS of csrc/crc32c.cu
_MIN_SPAN = 64      # bytes a thread takes at least before the block widens


@functools.lru_cache(maxsize=64)
def launch_plan(length: int) -> tuple:
    """(levels, span, advance columns (levels * 32,) uint32) for blocks
    of `length` bytes: 2^levels threads of `span` bytes each."""
    threads = 1
    while threads < _MAX_THREADS and length // (2 * threads) >= _MIN_SPAN:
        threads *= 2
    unit = 16 if length % 16 == 0 else 4     # 16-byte loads when aligned
    span = -(-length // threads)
    span = -(-span // unit) * unit
    levels = threads.bit_length() - 1
    cols = np.concatenate(
        [cks.advance_columns(span << lvl) for lvl in range(levels)]
        or [np.zeros(0, np.uint32)]).astype(np.uint32)
    return levels, span, np.ascontiguousarray(cols)


def crc32c_blocks(blocks: torch.Tensor, length: int, init: int = 0,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """crc32c(init, block) of every `length`-byte block of a contiguous
    uint8 tensor (numel a multiple of `length`) -> (N,) int32 bits."""
    if blocks.dtype != torch.uint8:
        raise ValueError(f"blocks must be uint8, got {blocks.dtype}")
    if length < 4 or length % 4 or blocks.numel() % length:
        raise ValueError(f"{blocks.numel()} bytes do not split into blocks of"
                         f" {length} (a positive multiple of 4)")
    n = blocks.numel() // length
    if blocks.device.type == "cpu":
        res = cks.crc32c_batch(blocks.reshape(n, length), init)
        if out is None:
            return res
        out.copy_(res)
        return out
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must be 16-byte aligned")
    if out is None:
        out = torch.empty(n, dtype=torch.int32, device=blocks.device)
    elif (tuple(out.shape) != (n,) or out.dtype != torch.int32
          or out.device != blocks.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 ({n},) tensor on "
                         f"{blocks.device}")
    if n == 0:
        return out
    levels, span, cols = launch_plan(length)
    lib = _build.load()["crc32c"]
    crc32c_blocks.launches += 1
    _build.check(lib.crc32c_blocks(
        cols.ctypes.data, levels, blocks.device.index or 0,
        blocks.data_ptr(), n, length, span, out.data_ptr(),
        torch.cuda.current_stream(blocks.device).cuda_stream),
        "crc32c_blocks")
    seed = cks.crc32c_zeros(init, length)
    if seed:
        out ^= cks.as_int32(seed)
    return out


crc32c_blocks.launches = 0
