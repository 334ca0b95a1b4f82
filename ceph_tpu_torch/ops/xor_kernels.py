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

On a CUDA tensor each entry launches the kernel or raises; on a CPU
tensor it runs the plain version below, one PyTorch op per tape op (the
`_sched_impl` lowering, which is what a kernel-less port would launch on
the card).  Each entry counts its launches.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from ceph_tpu_torch.ops import _build

# the tapes on the card, one upload per (program, device)
_tapes: OrderedDict = OrderedDict()
_tapes_lock = threading.Lock()
_TAPES_CAP = 256


def _device_tape(prog, device: torch.device) -> torch.Tensor:
    key = (prog.sig, prog.n_regions, prog.n_ops, device)
    with _tapes_lock:
        got = _tapes.get(key)
        if got is not None:
            _tapes.move_to_end(key)
            return got
    got = torch.from_numpy(prog.tape.copy()).to(device)
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
    if arena.device.type == "cpu":
        return xor_sched_regions_plain(prog, arena)
    n_objects, n_regions, rbytes = a.shape
    if n_objects == 0 or rbytes == 0:
        return arena
    lib = _build.load()["xor_sched"]
    vb = 4 if rbytes % 4 == 0 else 1
    if lib.xor_sched_threads(n_regions, vb) == 0:
        raise ValueError(f"a program of {n_regions} regions does not fit a"
                         " thread block's shared memory")
    if vb == 4 and a.data_ptr() % 4:
        raise ValueError("the arena must be 4-byte aligned")
    tape = _device_tape(prog, arena.device)
    xor_sched_regions.launches += 1
    _build.check(lib.xor_sched_regions(
        tape.data_ptr(), prog.n_ops, arena.device.index or 0, a.data_ptr(),
        n_objects, n_regions, rbytes, prog.n_in, prog.out_base, prog.n_out,
        torch.cuda.current_stream(arena.device).cuda_stream),
        "xor_sched_regions")
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
    lib = _build.load()["xor_sched"]
    if lib.xor_sched_threads(prog.n_regions, 4) == 0:
        raise ValueError(f"a program of {prog.n_regions} regions does not"
                         " fit a thread block's shared memory")
    tape = _device_tape(prog, data.device)
    xor_sched_gf.launches += 1
    _build.check(lib.xor_sched_gf(
        tape.data_ptr(), prog.n_ops, data.device.index or 0, data.data_ptr(),
        out.data_ptr(), b, k, r, s, prog.n_regions, prog.out_base,
        torch.cuda.current_stream(data.device).cuda_stream), "xor_sched_gf")
    return out


xor_sched_regions.launches = 0
xor_sched_gf.launches = 0
