"""Compressibility scores of a batch of blocks (port of the XLA device code
of ceph_tpu/compressor/scoring.py, `_byte_histograms_dev`, `_entropy_dev`
and `_match_fraction_dev`).

`score_blocks` returns, for each row of a (B, S) uint8 tensor, its 256-bin
byte histogram (int32), its order-0 entropy in bits per byte (float32) and
its best self-match fraction over the probe lags (float32).  On a CUDA
tensor it launches the kernel of csrc/compress_score.cu, one launch per
call; on a CPU tensor it runs the plain version, `score_blocks_plain`.

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


def score_blocks(blocks: torch.Tensor):
    """(B, S) uint8 -> (hist (B, 256) int32, entropy (B,) float32,
    match (B,) float32): the CUDA kernel on a CUDA tensor (contiguous,
    S >= 1), the plain version on a CPU tensor."""
    _check(blocks)
    if blocks.device.type == "cpu":
        return score_blocks_plain(blocks)
    if not blocks.is_contiguous():
        raise ValueError("blocks must be contiguous")
    b, s = blocks.shape
    if s < 1:
        raise ValueError("blocks must have at least one byte per row")
    hist = torch.empty((b, 256), dtype=torch.int32, device=blocks.device)
    entropy = torch.empty(b, dtype=torch.float32, device=blocks.device)
    match = torch.empty(b, dtype=torch.float32, device=blocks.device)
    if b == 0:
        return hist, entropy, match
    lib = _build.load()["compress_score"]
    # per row: the lag counts and the ticket of the thread blocks that
    # share it (zeroed by the launcher, like the histograms)
    scratch = torch.empty(b * lib.score_scratch_ints(), dtype=torch.int32,
                          device=blocks.device)
    score_blocks.launches += 1
    _build.check(lib.score_blocks(
        blocks.data_ptr(), blocks.device.index or 0, b, s, hist.data_ptr(),
        entropy.data_ptr(), match.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(blocks.device).cuda_stream),
        "score_blocks")
    return hist, entropy, match


score_blocks.launches = 0
