"""Compiled XOR programs on the card: the `xor_sched` kernel of
csrc/xor_sched.cu (it replaces the XLA lowering of ceph_tpu/ec/plan.py's
`xor_sched` plan kind, `_sched_impl`, and the host tape the reference's
bitmatrix codecs run).

Both entries take an `XorProgram` (ec/xsched.py: a flat int32 tape of
(dst, a, b) triples over inputs, reusable temporaries and outputs) and
launch the kernel once:

* `xor_sched_regions(prog, arena)` runs the tape over a uint8 arena
  (n_objects, n_regions, region_bytes), or (n_regions, region_bytes) for
  one object, in place: input regions are read and output regions
  written.  The temporary regions are scratch: the kernel keeps
  temporaries on chip and leaves those regions as they were, the plain
  version (like the host tape) writes them;
* `xor_sched_gf(prog, data)` runs the program of a GF(2^8) matrix's bit
  expansion (`xsched.compile_matrix(gf.gf_matrix_to_bits(m))`) over the
  bit planes of (..., K, S) bytes and returns (..., R, S): the product
  `gf_matmul(m, data)`, with S % 4 == 0 on the card.

The kernel runs the program's branch-free tape (`branch_free_tape`: every
op r[dst] = r[a] ^ r[b], with one always-zero region, in shared-memory
byte offsets), lowered once per program and column width and cached with
its upload.  On a CUDA tensor each entry launches the kernel or raises;
on a CPU tensor it runs the plain version below, one PyTorch op per tape
op (the `_sched_impl` lowering, which is what a kernel-less port would
launch on the card).  Each entry counts its launches.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ceph_tpu_torch.ops import _build

# csrc/xor_sched.cu: the columns of a tile (XS_THREADS), the unit the
# device tape is padded to (XS_BATCH) and a bit-plane region's bytes in the
# GF entry (XS_GF_STRIDE)
THREADS = 32
BATCH = 8
GF_STRIDE = 4 * THREADS


def branch_free_tape(prog, stride: int) -> np.ndarray:
    """The tape as the kernel runs it: (n, 4) int32 rows (dst, a, b, 0),
    each r[dst] = r[a] ^ r[b] over the program's regions and one region
    Z = n_regions that is always zero (a copy is a ^ Z, an accumulate
    dst ^ a, a zero fill Z ^ Z), every region index scaled to its byte
    offset (index x stride), in tape order, padded with Z ^ Z ops to a
    multiple of BATCH."""
    t = np.asarray(prog.tape, dtype=np.int64).reshape(-1, 3)
    dst, a, b = t[:, 0], t[:, 1], t[:, 2]
    z = prog.n_regions
    xor, acc = b >= 0, b == -2
    copy = ~xor & ~acc & (a >= 0)
    out = np.full((-(-len(t) // BATCH) * BATCH, 4), z, dtype=np.int64)
    out[:len(t), 0] = dst
    out[:len(t), 1] = np.where(xor | copy, a, np.where(acc, dst, z))
    out[:len(t), 2] = np.where(xor, b, np.where(acc, a, z))
    out[:, :3] *= stride
    out[:, 3] = 0
    return np.ascontiguousarray(out, dtype=np.int32)


# the branch-free tapes on the card, one lowering and upload per
# (program, device, column bytes)
_tapes: OrderedDict = OrderedDict()
_tapes_lock = threading.Lock()
_TAPES_CAP = 256


def _stream(device: torch.device) -> int:
    """The handle of the device's current stream.  (torch.cuda.
    current_stream builds a Stream object a call, which took most of a
    launch's host time.)"""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _device_tape(prog, device: torch.device, widest: int) -> tuple:
    """(column bytes, device tape) of a program: for the region entry the
    widest column of at most `widest` bytes (16, 4 or 1) whose working set
    fits a block, for the GF entry (`widest` 0) its 4-byte plane words;
    ValueError when the program does not fit."""
    key = (prog.sig, prog.n_regions, prog.n_ops, device, widest)
    with _tapes_lock:
        got = _tapes.get(key)
        if got is not None:
            _tapes.move_to_end(key)
            return got
    lib = _build.load()["xor_sched"]
    n_pad = -(-prog.n_ops // BATCH) * BATCH
    if widest:
        vb = lib.xor_sched_column_bytes(prog.n_regions, prog.n_in, n_pad,
                                        widest)
        stride = vb * THREADS
    else:
        vb = 4 if lib.xor_sched_gf_fits(prog.n_regions, n_pad,
                                        prog.n_in // 8) else 0
        stride = GF_STRIDE
    if vb == 0:
        raise ValueError(f"a program of {prog.n_regions} regions does not"
                         " fit a thread block's shared memory")
    got = (vb, torch.from_numpy(branch_free_tape(prog, stride)).to(device))
    with _tapes_lock:
        _tapes[key] = got
        if len(_tapes) > _TAPES_CAP:
            _tapes.popitem(last=False)
    return got


def _run_tape(tape, a: torch.Tensor) -> None:
    """The tape over a (N, n_regions, L) tensor, op by op, in place."""
    for dst, x, y in tape.tolist():
        if y >= 0:
            a[:, dst] = a[:, x] ^ a[:, y]
        elif y == -2:
            a[:, dst] ^= a[:, x]
        elif x >= 0:
            a[:, dst] = a[:, x]
        else:
            a[:, dst] = 0


def _arena_view(prog, arena: torch.Tensor) -> torch.Tensor:
    if arena.dtype != torch.uint8 or arena.dim() not in (2, 3) \
            or arena.shape[-2] != prog.n_regions:
        raise ValueError(f"expected a ({prog.n_regions}, bytes) or (objects,"
                         f" {prog.n_regions}, bytes) uint8 arena, got "
                         f"{tuple(arena.shape)} {arena.dtype}")
    if not arena.is_contiguous():
        raise ValueError("the arena must be contiguous")
    return arena if arena.dim() == 3 else arena.unsqueeze(0)


def xor_sched_regions_plain(prog, arena: torch.Tensor) -> torch.Tensor:
    """The region entry's plain version: the tape over the arena, in
    place, on the arena's device; returns the arena."""
    _run_tape(prog.tape, _arena_view(prog, arena))
    return arena


def xor_sched_regions(prog, arena: torch.Tensor) -> torch.Tensor:
    """Run `prog` over every object of a contiguous uint8 arena in place
    (output regions written): one kernel launch on a CUDA tensor, the
    plain version on a CPU tensor.  Returns the arena."""
    a = _arena_view(prog, arena)
    dev = arena.device
    if dev.type == "cpu":
        return xor_sched_regions_plain(prog, arena)
    n_objects, n_regions, rbytes = a.shape
    if n_objects == 0 or rbytes == 0:
        return arena
    ptr = a.data_ptr()
    widest = (16 if rbytes % 16 == 0 and ptr % 16 == 0 else
              4 if rbytes % 4 == 0 and ptr % 4 == 0 else 1)
    vb, tape = _device_tape(prog, dev, widest)
    lib = _build.load()["xor_sched"]
    xor_sched_regions.launches += 1
    _build.check(lib.xor_sched_regions(
        tape.data_ptr(), len(tape), vb, dev.index, ptr, n_objects,
        n_regions, rbytes, prog.n_in, prog.out_base, prog.n_out,
        _stream(dev)), "xor_sched_regions")
    return arena


def _gf_shape(prog, data: torch.Tensor) -> tuple:
    if prog.n_in % 8 or prog.n_out % 8:
        raise ValueError(f"a GF program maps 8K bit planes to 8R, not"
                         f" {prog.n_in} to {prog.n_out}")
    k, r = prog.n_in // 8, prog.n_out // 8
    if data.dtype != torch.uint8 or data.dim() < 2 or data.shape[-2] != k:
        raise ValueError(f"expected (..., {k}, S) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    return k, r, data.shape[-1]


def xor_sched_gf_plain(prog, data: torch.Tensor) -> torch.Tensor:
    """The GF entry's plain version: unpack the bit planes, run the
    tape over them op by op, pack the output rows."""
    k, r, s = _gf_shape(prog, data)
    lead = data.shape[:-2]
    d = data.reshape(-1, k, s)
    planes = torch.empty((d.shape[0], prog.n_regions, s), dtype=torch.uint8,
                         device=data.device)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    planes[:, :8 * k] = ((d[:, :, None, :] >> shifts[None, None, :, None])
                         & 1).reshape(-1, 8 * k, s)
    _run_tape(prog.tape, planes)
    bits = planes[:, prog.out_base:].reshape(-1, r, 8, s).to(torch.int32)
    packed = (bits << shifts.to(torch.int32)[None, None, :, None]).sum(dim=2)
    return packed.to(torch.uint8).reshape(*lead, r, s)


def xor_sched_gf(prog, data: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """(..., K, S) uint8 -> (..., R, S) uint8 through `prog` (the program
    of an (R, K) GF(2^8) matrix's bit expansion): one kernel launch on a
    CUDA tensor (contiguous, 4-byte aligned, S % 4 == 0), the plain
    version on a CPU tensor."""
    k, r, s = _gf_shape(prog, data)
    shape = (*data.shape[:-2], r, s)
    if data.device.type == "cpu":
        res = xor_sched_gf_plain(prog, data)
        if out is None:
            return res
        out.copy_(res)
        return out
    if s < 4 or s % 4:
        raise ValueError(f"chunk size {s} is not a positive multiple of 4")
    if not data.is_contiguous() or data.data_ptr() % 4:
        raise ValueError("data must be contiguous and 4-byte aligned")
    if out is None:
        out = torch.empty(shape, dtype=torch.uint8, device=data.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.uint8
          or out.device != data.device or not out.is_contiguous()
          or out.data_ptr() % 4):
        raise ValueError(f"out must be a contiguous, 4-byte aligned uint8 "
                         f"{shape} tensor on {data.device}")
    b = data.numel() // (k * s)
    if b == 0:
        return out
    dev = data.device
    _vb, tape = _device_tape(prog, dev, 0)
    lib = _build.load()["xor_sched"]
    xor_sched_gf.launches += 1
    _build.check(lib.xor_sched_gf(
        tape.data_ptr(), len(tape), dev.index, data.data_ptr(),
        out.data_ptr(), b, k, r, s, prog.n_regions, prog.out_base,
        _stream(dev)), "xor_sched_gf")
    return out


xor_sched_regions.launches = 0
xor_sched_gf.launches = 0
