"""Batched compressibility scoring (port of ceph_tpu/compressor/scoring.py).

The reference decides compress-vs-skip per blob *after* running the codec,
rejecting results above `bluestore_compression_required_ratio`
(BlueStore.cc:13545-13585).  Here an order-0 entropy estimate over byte
histograms, and a self-match probe over 18 lags, predict the achievable
ratio before any host codec runs, so incompressible blobs (encrypted,
already-compressed) skip the codec entirely.  The final required-ratio gate
(ceph_tpu_torch.compressor.gate) still applies to actual codec output,
preserving reference semantics.

Every public function takes the device it runs on (CUDA unless the caller
names another; no CUDA and no device raises).  A batch of fewer than
MIN_DEVICE_BYTES takes the numpy host functions, as the reference's does.
From that size on, on CUDA one launch of the `score_blocks` kernel
(ops/score_kernels.py, csrc/compress_score.cu) computes histograms,
entropy and match fractions together into one packed buffer, copied back
in one piece; on the CPU its plain PyTorch version does.  The route
depends only on the device passed and the size.  Results come back as
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device, to_device
from ceph_tpu_torch.ops import score_kernels


def byte_histograms_host(blocks: np.ndarray) -> np.ndarray:
    """(B, S) uint8 -> (B, 256) int32 byte histograms (numpy).

    One offset-bincount over the whole batch: row i's bytes are
    shifted into the disjoint range [256*i, 256*(i+1)), so a single
    np.bincount of the flattened batch produces every row's histogram
    at once — no per-row Python loop."""
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    b, _s = blocks.shape
    if b == 0:
        return np.zeros((0, 256), dtype=np.int32)
    offset = blocks.astype(np.intp) + \
        256 * np.arange(b, dtype=np.intp)[:, None]
    return np.bincount(offset.ravel(),
                       minlength=256 * b).reshape(b, 256) \
        .astype(np.int32)


def entropy_bits_per_byte_host(blocks: np.ndarray) -> np.ndarray:
    return entropy_from_histograms(byte_histograms_host(blocks),
                                   blocks.shape[1])


def entropy_from_histograms(hist: np.ndarray, s: int) -> np.ndarray:
    """(B, 256) byte counts of rows of `s` bytes -> (B,) float32 order-0
    entropy in bits/byte, in float64 on the host (the reference's host
    arithmetic, whichever device counted the bytes)."""
    p = np.asarray(hist).astype(np.float64) / s
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(p > 0, -p * np.log2(p), 0.0)
    return terms.sum(axis=1).astype(np.float32)


MIN_DEVICE_BYTES = 64 * 1024  # below this the host path wins on latency

# lags probed for periodicity: every period p with p | some lag is caught
# (covers power-of-two, ×3 and common text/record strides up to 512)
_PROBE_LAGS = score_kernels.PROBE_LAGS


def _match_fraction_host(blocks: np.ndarray) -> np.ndarray:
    """(B, S) -> (B,) best self-match fraction over the probe lags."""
    b, s = blocks.shape
    best = np.zeros(b, dtype=np.float32)
    for lag in _PROBE_LAGS:
        if lag >= s:
            break
        frac = (blocks[:, lag:] == blocks[:, :-lag]).mean(axis=1)
        best = np.maximum(best, frac.astype(np.float32))
    return best


def _device_scores(blocks, device):
    """(hist, entropy, match) numpy arrays from one score_blocks call on
    `device`, or None when the batch is under MIN_DEVICE_BYTES."""
    dev = resolve_device(device)
    if isinstance(blocks, torch.Tensor):
        if blocks.numel() < MIN_DEVICE_BYTES:
            return None
        t = blocks.to(dev).contiguous()
    else:
        arr = np.asarray(blocks)
        if arr.nbytes < MIN_DEVICE_BYTES:
            return None
        t = to_device(arr, dev)
    # one copy back: the packed rows, split on the host
    packed = score_kernels.score_blocks_packed(t).cpu().numpy()
    return (packed[:, :256], packed[:, 256].view(np.float32),
            packed[:, 257].view(np.float32))


def _host(blocks) -> np.ndarray:
    if isinstance(blocks, torch.Tensor):
        return blocks.cpu().numpy()
    return np.asarray(blocks)


def byte_histograms(blocks, device=None) -> np.ndarray:
    """(B, S) uint8 -> (B, 256) int32 byte histograms."""
    scores = _device_scores(blocks, device)
    if scores is not None:
        return scores[0]
    return byte_histograms_host(_host(blocks))


def entropy_bits_per_byte(blocks, device=None) -> np.ndarray:
    """(B, S) uint8 -> (B,) float32 order-0 entropy in bits/byte."""
    scores = _device_scores(blocks, device)
    if scores is not None:
        return scores[1]
    return entropy_bits_per_byte_host(_host(blocks))


def match_fraction(blocks, device=None) -> np.ndarray:
    """(B, S) uint8 -> (B,) float32: best self-match fraction over the
    probe lags — a cheap repetition signal that catches periodic data
    whose byte histogram is uniform (LZ compresses it, entropy doesn't
    see it)."""
    scores = _device_scores(blocks, device)
    if scores is not None:
        return scores[2]
    return _match_fraction_host(_host(blocks))


def compress_decision(blocks, required_ratio: float = 0.875,
                      margin: float = 0.05,
                      match_threshold: float = 0.5, device=None):
    """(B, S) uint8 -> (B,) bool: worth running the codec?

    True when either (a) the order-0 entropy bound predicts a ratio
    comfortably under `required_ratio` (`margin` absorbs codec overhead
    vs the bound), or (b) the lag-probe repetition signal fires —
    periodic data (e.g. a repeating 256-byte random pattern) has a
    uniform histogram yet compresses far below required_ratio, so
    entropy alone would permanently skip the codec for it.

    Known false-negative class: data whose only redundancy is
    long-range, aperiodic matches (period not dividing any probe lag,
    or match distance > 512).  Such spans are stored raw; COMP_FORCE
    mode bypasses this prescreen entirely at the store layer.

    On the device route one score_blocks call gives entropy and match
    together; the comparisons below are the reference's numpy ones on
    the float32 results (a float32 array against a Python float)."""
    scores = _device_scores(blocks, device)
    if scores is None:
        arr = _host(blocks)
        entropy = entropy_bits_per_byte_host(arr)
    else:
        entropy = scores[1]
    est_ratio = np.asarray(entropy) / 8.0
    entropy_ok = est_ratio <= (required_ratio + margin)
    if entropy_ok.all():  # common path: no need for the lag probe
        return entropy_ok
    match = _match_fraction_host(arr) if scores is None else scores[2]
    repetitive = np.asarray(match) >= match_threshold
    return entropy_ok | repetitive
