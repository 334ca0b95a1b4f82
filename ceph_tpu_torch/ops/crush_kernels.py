"""Bulk CRUSH placement kernel (replaces the XLA dispatch
`jax.jit(jax.vmap(one))` of ceph_tpu/crush/kernel.py compile_rule).

`crush_do_rule_batch` places N inputs through one rule resolved by
`ceph_tpu_torch.crush.kernel.rule_program` on a `DenseMap`, with the CUDA
kernel of csrc/crush.cu: each lane of a persistent grid runs one input's
tries (descent, collision checks, leaf choice, weight-vector rejection) a
step at a time in its own registers and local arrays, and takes the next
input from a per-launch work counter when its input is done, so a warp
never waits on one lane's retries.  A straw2 draw divides by an exact
per-item reciprocal (`DenseMap.recips`).  The map is read from device
memory (it stays in L2), the ln tables from shared memory.  The rule
rides by value, so one build serves every rule and map.

On a CPU tensor the wrapper runs the plain version,
`ceph_tpu_torch.crush.kernel.crush_do_rule_batch_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from ceph_tpu_torch.crush.kernel import (
    MAX_RESULT, ChooseProgram, DenseMap, crush_do_rule_batch_plain,
    ln_tables,
)
from ceph_tpu_torch.ops import _build

_DTYPES = {"items": torch.int32, "weights": torch.int64,
           "recips": torch.int64, "sizes": torch.int32,
           "types": torch.int32, "dev_weight": torch.int64}


def crush_do_rule_batch(dm: DenseMap, program: ChooseProgram,
                        xs: torch.Tensor,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Place every input of the (N,) int32 tensor `xs` -> (N, result_max)
    int32, NONE-padded as crush_do_rule pads (firstn at the tail, indep in
    place).  The map's tensors must lie on xs's device."""
    if xs.dtype != torch.int32 or xs.dim() != 1:
        raise ValueError(f"xs must be a 1-D int32 tensor, got {xs.dtype}"
                         f" {tuple(xs.shape)}")
    if not 1 <= program.result_max <= MAX_RESULT:
        raise ValueError(f"result_max {program.result_max} outside"
                         f" 1..{MAX_RESULT}")
    if not 0 <= program.count <= program.result_max:
        raise ValueError(f"count {program.count} outside 0..result_max")
    for name, dtype in _DTYPES.items():
        t = getattr(dm, name)
        if t.device != xs.device or t.dtype != dtype:
            raise ValueError(f"dense map {name} must be {dtype} on"
                             f" {xs.device}, got {t.dtype} on {t.device}")
    n = xs.shape[0]
    shape = (n, program.result_max)
    if xs.device.type == "cpu":
        res = crush_do_rule_batch_plain(dm, program, xs)
        if out is None:
            return res
        out.copy_(res)
        return out
    if not all(getattr(dm, name).is_contiguous() for name in _DTYPES) \
            or not xs.is_contiguous():
        raise ValueError("the dense map and xs must be contiguous")
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=xs.device)
    elif (tuple(out.shape) != shape or out.dtype != torch.int32
          or out.device != xs.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 {shape} tensor on"
                         f" {xs.device}")
    if n == 0:
        return out
    lib = _build.load()["crush"]
    tables = ln_tables(xs.device)
    rule = (ctypes.c_int * len(program))(*program)
    nb, ms = dm.items.shape
    # the work counter, on the launch's stream (the launcher zeroes it there)
    counter = torch.empty(1, dtype=torch.int64, device=xs.device)
    crush_do_rule_batch.launches += 1
    _build.check(lib.crush_do_rule_batch(
        tables.data_ptr(), dm.items.data_ptr(), dm.recips.data_ptr(),
        dm.sizes.data_ptr(), dm.types.data_ptr(), dm.dev_weight.data_ptr(),
        nb, ms, dm.dev_weight.shape[0], dm.max_devices, dm.max_depth, rule,
        xs.device.index or 0, xs.data_ptr(), n, out.data_ptr(),
        counter.data_ptr(),
        torch.cuda.current_stream(xs.device).cuda_stream),
        "crush_do_rule_batch")
    return out


crush_do_rule_batch.launches = 0
