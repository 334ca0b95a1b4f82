"""Batched crc32c kernel (port of ceph_tpu/ops/crc_pallas.py).

`crc32c_blocks` computes the crc32c of N equal blocks with the CUDA kernel
of csrc/crc32c.cu: the zero-seeded crc of each block, then the seed's
advance through `length` zero bytes XORed in, exactly as the TPU entry
`crc32c_blocks_words` does.  Unlike the TPU kernel (blocks of at most
8 KiB) it takes any length that is a multiple of 4.

The kernel views each block as front-padded with zeros to whole 128-byte
rows (leading zeros leave a zero-seeded crc unchanged) and splits all
rows of the launch evenly over its warps.  In a warp's run of rows inside
one block, lane j reads word j of every row and steps its own state with
s = Z128(s ^ w), Z128 being the advance through 128 zero bytes; on the
run's last row lane j advances through 128 - 4j bytes instead.  The XOR
of the 32 lane states is the run's crc, which is advanced through the
rows after the run and XORed into the block's crc.  The constants the
kernel needs are built here once (`kernel_consts`) and do not depend on
the block length; `launch_plan` gives the per-length row count and pad.

On a CPU tensor the wrapper runs the plain version,
ops/checksum.crc32c_batch.  Crcs come back as int32 bit patterns.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.ops import checksum as cks

ROW = 128          # bytes per row: one 4-byte word per lane of a warp
LANES = 32
ADV_LEVELS = 24    # row-advance matrices for 2^0 .. 2^23 rows: blocks
                   # under 2 GiB (the launcher refuses longer ones)

# word offsets into kernel_consts(); FIN and ADV are CRC_FIN and CRC_ADV
# of csrc/crc32c.cu
TAB = 0                        # [k * 256 + i]: Z128(i << 8k)
FIN = TAB + 4 * 256            # [b * 32 + j]: column b of Z(128 - 4j)
ADV = FIN + 32 * LANES         # [l * 32 + b]: column b of Z(128 << l)
N_CONSTS = ADV + ADV_LEVELS * 32


class LaunchPlan(NamedTuple):
    rows: int   # 128-byte rows of the front-padded block
    pad: int    # zero bytes in front of the block, 0 <= pad < 128


def launch_plan(length: int) -> LaunchPlan:
    """Rows and front pad of a `length`-byte block (length % 4 == 0)."""
    rows = -(-length // ROW)
    return LaunchPlan(rows, rows * ROW - length)


@functools.lru_cache(maxsize=1)
def kernel_consts() -> np.ndarray:
    """(N_CONSTS,) uint32: the Z128 byte tables, the per-lane last-row
    advances and the row-advance matrices, laid out as the kernel reads
    them (offsets TAB, FIN, ADV)."""
    z128 = cks.advance_columns(ROW)
    byte = np.arange(256, dtype=np.uint32)
    tab = np.stack([cks.advance(z128, byte << np.uint32(8 * k))
                    for k in range(4)])
    fin = np.stack([cks.advance_columns(ROW - 4 * j)
                    for j in range(LANES)], axis=1)          # (b, j)
    adv = np.stack([cks.advance_columns(ROW << lvl)
                    for lvl in range(ADV_LEVELS)])           # (l, b)
    out = np.concatenate([tab.ravel(), fin.ravel(), adv.ravel()])
    return np.ascontiguousarray(out, dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _device_consts(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(kernel_consts().view(np.int32)).to(device)


def smem_bytes() -> int:
    """Dynamic shared memory per thread block of the CUDA kernel."""
    return int(_build.load()["crc32c"].crc32c_smem_bytes())


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
    rows, pad = launch_plan(length)
    lib = _build.load()["crc32c"]
    consts = _device_consts(blocks.device)
    crc32c_blocks.launches += 1
    _build.check(lib.crc32c_blocks(
        consts.data_ptr(), blocks.device.index or 0, blocks.data_ptr(), n,
        length, rows, pad, out.data_ptr(),
        torch.cuda.current_stream(blocks.device).cuda_stream),
        "crc32c_blocks")
    seed = cks.crc32c_zeros(init, length)
    if seed:
        out ^= cks.as_int32(seed)
    return out


crc32c_blocks.launches = 0
