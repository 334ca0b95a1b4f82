"""Bloom-filter bit positions and sealed bitsets of the hit sets (port of
the XLA device code of ceph_tpu/osd/hitset.py, `bloom_positions` with
xp=jnp, and of the host scatter-OR of its `BloomHitSet.insert_batch`).

`bloom_positions(hashes, nbits, nhash)` maps a [B] tensor of uint32 object
hashes (int32 bit patterns, or any integer tensor whose values are uint32)
to the [B, nhash] positions `hash32_2(h, i) % nbits`, seed i for position
i, as int32 bit patterns of the uint32 values.

`bloom_seal(hashes, offsets, nbits, nhash, max_set)` seals S sets of one
geometry, the largest of max_set hashes: set s holds
hashes[offsets[s]:offsets[s + 1]], and row s of the [S, ceil(nbits / 32)]
int32 result has bit p & 31 of word p >> 5 set for every position p of
its hashes, so the row's little-endian bytes cut to ceil(nbits / 8) are
the bitset `BloomHitSet.insert_batch` builds in an empty set.

On a CUDA tensor each launches its kernel of csrc/hitset_bloom.cu, one
launch a call, or raises; on a CPU tensor each runs its plain version
(`bloom_positions_torch` of osd/hitset.py, and `bloom_seal_plain`, a bool
tensor of nbits a set, set and packed).  `positions_host` and
`seal_host` take and give host arrays: on a card through one staging copy
each way, in pinned buffers kept between calls, and one synchronisation
(`seal_host` in one call of the entry bloom_seal_staged, which makes the
copies, the launch and the synchronisation).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ceph_tpu_torch.ops import _build

MAX_NHASH = 32          # BLOOM_MAX_NHASH of csrc/hitset_bloom.cu
MAX_NBITS = (1 << 32) - 1


def _stream(device: torch.device) -> int:
    """The handle of the device's current stream (no Stream object)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _check(hashes: torch.Tensor, nbits: int, nhash: int) -> None:
    if hashes.dim() != 1 or hashes.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"expected a [B] int32 or int64 tensor, got"
                         f" {tuple(hashes.shape)} {hashes.dtype}")
    if not 1 <= int(nhash) <= MAX_NHASH:
        raise ValueError(f"nhash {nhash} is not in [1, {MAX_NHASH}]")
    if not 1 <= int(nbits) <= MAX_NBITS:
        raise ValueError(f"nbits {nbits} is not in [1, 2^32 - 1]")


def seal_words(nbits: int) -> int:
    """32-bit words of a sealed row."""
    return (int(nbits) + 31) // 32


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
        int(nbits), hashes.device.index or 0, _stream(hashes.device)),
        "bloom_positions")
    return out


bloom_positions.launches = 0


def _check_seal(hashes: torch.Tensor, offsets: torch.Tensor, nbits: int,
                nhash: int) -> None:
    _check(hashes, nbits, nhash)
    if offsets.dim() != 1 or offsets.shape[0] < 1 or offsets.dtype not in (
            torch.int32, torch.int64):
        raise ValueError(f"expected [S + 1] int32 or int64 offsets, got"
                         f" {tuple(offsets.shape)} {offsets.dtype}")
    if offsets.device != hashes.device:
        raise ValueError("hashes and offsets lie on different devices")


def bloom_seal_plain(hashes: torch.Tensor, offsets: torch.Tensor,
                     nbits: int, nhash: int) -> torch.Tensor:
    """[N] hashes cut into S sets at offsets [S + 1] -> [S, seal_words]
    int32 rows, in plain PyTorch on the tensors' device: each set's bool
    tensor of nbits set at its positions, then packed eight to a byte."""
    from ceph_tpu_torch.osd.hitset import bloom_positions_torch

    _check_seal(hashes, offsets, nbits, nhash)
    dev = hashes.device
    sets, nwords = offsets.shape[0] - 1, seal_words(nbits)
    offsets = offsets.to(torch.int64)
    owner = torch.repeat_interleave(torch.arange(sets, device=dev),
                                    offsets[1:] - offsets[:-1])
    pos = bloom_positions_torch(hashes, int(nbits), int(nhash))
    bits = torch.zeros((sets, nwords * 32), dtype=torch.bool, device=dev)
    bits[owner.reshape(-1, 1).expand_as(pos), pos] = True
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                           device=dev)
    packed = (bits.view(sets, nwords * 4, 8).to(torch.uint8) * weights).sum(
        -1, dtype=torch.uint8)
    return packed.view(torch.int32)


def bloom_seal(hashes: torch.Tensor, offsets: torch.Tensor, nbits: int,
               nhash: int, max_set: int,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """[N] hashes cut into S sets at offsets [S + 1] -> [S, seal_words]
    int32: the CUDA kernel on CUDA tensors (both int32, contiguous; one
    launch for every set), the plain version on CPU tensors.  `max_set`,
    the largest set (the caller knows it from its host offsets), sizes
    the launch's grid."""
    _check_seal(hashes, offsets, nbits, nhash)
    if hashes.device.type == "cpu":
        res = bloom_seal_plain(hashes, offsets, nbits, nhash)
        if out is None:
            return res
        out.copy_(res)
        return out
    if (hashes.dtype != torch.int32 or offsets.dtype != torch.int32
            or not hashes.is_contiguous() or not offsets.is_contiguous()):
        raise ValueError("hashes and offsets on the card must be contiguous"
                         " int32 tensors")
    sets = offsets.shape[0] - 1
    shape = (sets, seal_words(nbits))
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=hashes.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.int32
          or out.device != hashes.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 {shape} tensor on"
                         f" {hashes.device}")
    if sets == 0:
        return out
    lib = _build.load()["hitset_bloom"]
    bloom_seal.launches += 1
    _build.check(lib.bloom_seal(
        hashes.data_ptr(), offsets.data_ptr(), out.data_ptr(), sets,
        int(max_set), int(nhash), int(nbits), hashes.device.index or 0,
        _stream(hashes.device)), "bloom_seal")
    return out


bloom_seal.launches = 0


class _Staging:
    """One card's staging buffers, kept between calls and grown to the
    largest: pinned int32 up and down on the host, int32 up and down on
    the card.  A call ends in a synchronisation of the stream, so the next
    may overwrite them; the lock keeps threads from sharing a call's."""

    def __init__(self):
        self.lock = threading.Lock()
        self.cards: dict = {}

    def buffers(self, device: torch.device, n_up: int, n_down: int):
        have = self.cards.get(device)
        if have is None or have[0].numel() < n_up or have[2].numel() < n_down:
            n_up = 1 << max(n_up, have[0].numel() if have else 1, 1) \
                .bit_length()
            n_down = 1 << max(n_down, have[2].numel() if have else 1, 1) \
                .bit_length()
            up = torch.empty(n_up, dtype=torch.int32, pin_memory=True)
            down = torch.empty(n_down, dtype=torch.int32, pin_memory=True)
            have = self.cards[device] = (
                up, torch.empty(n_up, dtype=torch.int32, device=device),
                torch.empty(n_down, dtype=torch.int32, device=device), down,
                up.numpy(), down.numpy())
        return have


_STAGING = _Staging()


def positions_host(hashes: np.ndarray, nbits: int, nhash: int,
                   device: torch.device) -> np.ndarray:
    """[B] uint32 host hashes -> [B, nhash] uint32 positions on `device`:
    on a card one pinned copy in, one launch, one pinned copy out and its
    synchronisation."""
    arr = np.ascontiguousarray(hashes, dtype=np.uint32).reshape(-1)
    if device.type == "cpu":
        return bloom_positions_plain(torch.from_numpy(arr.astype(np.int64)),
                                     nbits, nhash).numpy().view(np.uint32)
    n, m = arr.size, arr.size * int(nhash)
    with _STAGING.lock:
        up, up_d, down_d, down, up_np, down_np = _STAGING.buffers(device, n,
                                                                  m)
        up_np[:n] = arr.view(np.int32)
        up_d[:n].copy_(up[:n], non_blocking=True)
        bloom_positions(up_d[:n], nbits, nhash,
                        out=down_d[:m].view(n, int(nhash)))
        down[:m].copy_(down_d[:m])  # one copy, one synchronisation
        return down_np[:m].view(np.uint32).reshape(n, int(nhash)).copy()


def seal_host(hashes: np.ndarray, offsets, nbits: int, nhash: int,
              device: torch.device) -> np.ndarray:
    """[N] uint32 host hashes cut into S sets at offsets [S + 1] -> [S,
    ceil(nbits / 8)] uint8 bitsets on `device`.  On a card one call of the
    entry bloom_seal_staged: the offsets and hashes go up in one copy from
    a pinned buffer, one launch seals every set (counted on
    bloom_seal.launches), and the rows come down in one copy to a pinned
    buffer and its synchronisation."""
    arr = np.ascontiguousarray(hashes, dtype=np.uint32).reshape(-1)
    offsets = np.asarray(offsets, dtype=np.int64).reshape(-1)
    n, sets, nbytes = arr.size, offsets.size - 1, (int(nbits) + 7) // 8
    if device.type == "cpu":
        words = bloom_seal_plain(torch.from_numpy(arr.astype(np.int64)),
                                 torch.from_numpy(offsets), nbits, nhash)
        return words.numpy().view(np.uint8)[:, :nbytes]
    if not 1 <= int(nhash) <= MAX_NHASH or not 1 <= int(nbits) <= MAX_NBITS:
        raise ValueError(f"nhash {nhash} or nbits {nbits} out of range")
    if sets < 1:
        return np.zeros((0, nbytes), dtype=np.uint8)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    device = torch.device("cuda", index)
    nwords = seal_words(nbits)
    k, m = sets + 1 + n, sets * nwords
    lib = _build.load()["hitset_bloom"]
    with _STAGING.lock:
        up, up_d, down_d, down, up_np, down_np = _STAGING.buffers(device, k,
                                                                  m)
        up_np[:sets + 1] = offsets
        up_np[sets + 1:k] = arr.view(np.int32)
        bloom_seal.launches += 1
        _build.check(lib.bloom_seal_staged(
            up.data_ptr(), up_d.data_ptr(), n, down_d.data_ptr(),
            down.data_ptr(), sets, int(np.diff(offsets).max()), int(nhash),
            int(nbits), index, _stream(device)), "bloom_seal")
        return down_np[:m].view(np.uint8).reshape(sets, nwords * 4)[
            :, :nbytes].copy()
