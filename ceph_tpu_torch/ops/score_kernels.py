"""Compressibility scores of a batch of blocks (port of the XLA device code
of ceph_tpu/compressor/scoring.py, `_byte_histograms_dev`, `_entropy_dev`
and `_match_fraction_dev`).

`score_blocks` returns, for each row of a (B, S) uint8 tensor, its 256-bin
byte histogram (int32), its order-0 entropy in bits per byte (float32) and
its best self-match fraction over the probe lags (float32), as views of the
one (B, 258) int32 buffer that `score_blocks_packed` returns (the floats as
their bits in the last two columns; `unpack` splits it).  On a CUDA tensor
it launches the kernel of csrc/compress_score.cu, one launch per call; on a
CPU tensor it runs the plain version, `score_blocks_plain`.

Histograms and match fractions equal the reference's bit for bit.  A
lag's fraction is its count times r(S - lag), r(n) being 1/n rounded to
float32: XLA compiles the reference's float32 mean (a division by a
constant) into that product, which can differ from count / (S - lag)
rounded once in the last bit.  The entropy's p is likewise count * r(S);
its float32 terms are summed in another order than XLA's, so it agrees
within ENTROPY_TOL.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ops import _build

# scoring.py _PROBE_LAGS: every period p with p | some lag is caught
PROBE_LAGS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96,
              128, 192, 256, 384, 512)
# bits per byte: float32 terms of at most 0.53 each, 256 of them summed in
# two orders differ by a few ulps of a sum of at most 8
ENTROPY_TOL = 2e-6
# a packed output row: 256 histogram counts, entropy and match as bits
OUT_COLS = 258


def _check(blocks: torch.Tensor) -> None:
    if blocks.dim() != 2 or blocks.dtype != torch.uint8:
        raise ValueError(f"expected (B, S) uint8, got {tuple(blocks.shape)}"
                         f" {blocks.dtype}")


def _reciprocal(n: int, device) -> torch.Tensor:
    """1/n rounded to float32, as a 0-dim tensor."""
    return torch.tensor(np.float32(1) / np.float32(n), device=device)


def score_blocks_plain(blocks: torch.Tensor):
    """(B, S) uint8 -> (hist (B, 256) int32, entropy (B,) float32,
    match (B,) float32) in plain PyTorch on the tensor's device."""
    _check(blocks)
    b, s = blocks.shape
    dev = blocks.device
    offset = (blocks.to(torch.int64)
              + 256 * torch.arange(b, device=dev)[:, None])
    hist = torch.bincount(offset.reshape(-1), minlength=256 * b) \
        .reshape(b, 256).to(torch.int32)
    p = hist.to(torch.float32) * _reciprocal(s, dev)
    terms = torch.where(p > 0, -p * torch.log2(torch.clamp(p, min=1e-30)),
                        torch.zeros((), device=dev))
    entropy = terms.sum(dim=1)
    best = torch.zeros(b, dtype=torch.float32, device=dev)
    for lag in PROBE_LAGS:
        if lag >= s:
            break
        count = (blocks[:, lag:] == blocks[:, :-lag]).sum(dim=1)
        frac = count.to(torch.float32) * _reciprocal(s - lag, dev)
        best = torch.maximum(best, frac)
    return hist, entropy, best


def pack(hist: torch.Tensor, entropy: torch.Tensor,
         match: torch.Tensor) -> torch.Tensor:
    """(hist, entropy, match) -> the (B, OUT_COLS) int32 buffer."""
    return torch.cat([hist, entropy.view(torch.int32)[:, None],
                      match.view(torch.int32)[:, None]], dim=1)


def unpack(packed: torch.Tensor):
    """(B, OUT_COLS) int32 -> (hist, entropy, match), views of it."""
    return (packed[:, :256], packed[:, 256].view(torch.float32),
            packed[:, 257].view(torch.float32))


# per CUDA device index: (the kernel's workspace, its address).  Zeroed once
# when allocated and left zero by every launch; it serves the current
# stream, one call at a time (the port runs no threads).  Its size is fixed
# (score_scratch_ints()), so it never grows.
_workspaces: dict = {}
_launch = None      # the C entry, looked up once


def _workspace(dev: torch.device) -> int:
    global _launch
    got = _workspaces.get(dev.index)
    if got is None:
        lib = _build.load()["compress_score"]
        _launch = lib.score_blocks
        ws = torch.zeros(lib.score_scratch_ints(), dtype=torch.int32,
                         device=dev)
        got = _workspaces[dev.index] = (ws, ws.data_ptr())
    return got[1]


def score_blocks_packed(blocks: torch.Tensor) -> torch.Tensor:
    """(B, S) uint8 -> (B, OUT_COLS) int32: per row the 256 histogram
    counts, then the entropy's and the match fraction's float32 bits.  The
    CUDA kernel on a CUDA tensor (contiguous, S >= 1), one allocation and one
    launch a call; the plain version, packed, on a CPU tensor."""
    _check(blocks)
    dev = blocks.device
    if dev.type == "cpu":
        return pack(*score_blocks_plain(blocks))
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    b, s = blocks.shape
    if s < 1:
        raise ValueError("blocks must have at least one byte per row")
    out = torch.empty((b, OUT_COLS), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    ws = _workspace(dev)
    at = out.data_ptr()
    score_blocks_packed.launches += 1
    # the current stream's handle without building a torch.cuda.Stream
    # (a few microseconds a call)
    _build.check(_launch(blocks.data_ptr(), dev.index, b, s, at, at + 4 * 256,
                         at + 4 * 257, ws,
                         torch._C._cuda_getCurrentRawStream(dev.index)),
                 "score_blocks")
    return out


score_blocks_packed.launches = 0


def score_blocks(blocks: torch.Tensor):
    """(B, S) uint8 -> (hist (B, 256) int32, entropy (B,) float32,
    match (B,) float32), views of `score_blocks_packed(blocks)`."""
    return unpack(score_blocks_packed(blocks))
