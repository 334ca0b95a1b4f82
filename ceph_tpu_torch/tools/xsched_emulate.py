"""Run the xor_sched kernels' own code (csrc/xor_sched.cu) on the CPU.

A CUDA kernel has no interpret mode, and a CPU test run has no card.
`emulate_many` compiles csrc/xor_sched.cu's device code with the host's
g++ against xsched_emulate.cpp, which defines the CUDA names the kernels
use: a thread block is 32 fibers on one OS thread, `__syncthreads` a
barrier of all of them, the 16-byte vector types plain structs,
`__byte_perm` the card's byte pick, and an asynchronous copy
(`__pipeline_memcpy_async`) a memcpy that lands when it is issued
("early") or only when the thread waits for its group ("late").  It runs
xs_regions_kernel and xs_gf_kernel themselves on the branch-free tape
that ops/xor_kernels.py lowers for the card (`branch_free_tape`), with
the shared-memory layout the launcher picks (column bytes, one or two
input buffers, a resident or chunked tape) on a grid of min(tiles,
target) blocks, so the CPU tests hold the 16-, 4- and 1-byte columns,
the ragged last tile, the chunked tape, blocks that walk several tiles
through both input buffers and the bit-sliced GF entry at any S % 4 == 0
against the plain versions (tests/test_torch_xsched.py).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ceph_tpu_torch.ops import xor_kernels

_HERE = Path(__file__).resolve().parent
_SRC = _HERE.parent / "csrc" / "xor_sched.cu"
_MAIN = _HERE / "xsched_emulate.cpp"
_BUILD = _HERE.parent / "_build" / "emulate"
_CUT = "namespace {"    # xor_sched.cu's host launchers start here


def build() -> Path:
    """The emulator binary, compiled on first use (cached by the sources'
    hash); RuntimeError without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the emulator cannot be built")
    src = _SRC.read_text()
    device = src[: src.index(_CUT)]
    digest = hashlib.sha256((device + _MAIN.read_text()).encode()) \
        .hexdigest()[:16]
    exe = _BUILD / f"xsched_emulate-{digest}"
    if not exe.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        (_BUILD / "xsched_device.inc").write_text(device)
        # xor_sched.cu's CUDA headers: xsched_emulate.cpp defines what it
        # uses
        for header in ("cuda_runtime.h", "cuda_pipeline.h"):
            (_BUILD / header).write_text("#pragma once\n")
        tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
        # -U_FORTIFY_SOURCE: the fibers _longjmp between stacks, which a
        # fortified longjmp would refuse
        res = subprocess.run([gxx, "-O2", "-std=c++17", "-U_FORTIFY_SOURCE",
                              "-Wno-unknown-pragmas", "-fno-strict-aliasing",
                              f"-I{_BUILD}", "-o", str(tmp), str(_MAIN)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"g++ xsched_emulate.cpp exited"
                               f" {res.returncode}:\n{res.stderr}")
        tmp.replace(exe)
    return exe


def _widest(region_bytes: int) -> int:
    return 16 if region_bytes % 16 == 0 else 4 if region_bytes % 4 == 0 \
        else 1


def emulate_many(jobs, detail: bool = False) -> list:
    """jobs: ("regions", prog, arena (n_objects, n_regions, bytes) uint8,
    target[, options]) or ("gf", prog, data (B, K, S) uint8, target[,
    options]) -> [(result, threads, blocks), ...]: the arena after the
    launch, or the (B, R, S) product, as the card computes them on a grid
    of min(tiles, target) blocks.  options: "column_bytes" (a regions
    job's column width, 16, 4 or 1; default the widest its region bytes
    allow), "copies" ("late", the default, or "early").  With `detail`,
    each result also carries the column bytes (regions) or copy bytes
    (gf) and the input buffers of the launch."""
    parts = [np.array([len(jobs)], dtype=np.int64)]
    shapes = []
    for kind, prog, arr, target, *rest in jobs:
        opts = rest[0] if rest else {}
        arr = np.ascontiguousarray(arr, dtype=np.uint8)
        early = {"late": 0, "early": 1}[opts.get("copies", "late")]
        if kind == "regions":
            n_obj, n_reg, rbytes = arr.shape
            if n_reg != prog.n_regions:
                raise ValueError("arena regions differ from the program's")
            vb = opts.get("column_bytes", _widest(rbytes))
            stride = vb * xor_kernels.THREADS
            tail = [n_obj, rbytes, 0, vb, early]
            shapes.append(arr.shape)
        else:
            b, k, s = arr.shape
            r = prog.n_out // 8
            stride = xor_kernels.GF_STRIDE
            tail = [b, (k << 32) | r, s, 0, early]
            shapes.append((b, r, s))
        tape = xor_kernels.branch_free_tape(prog, stride)
        head = [0 if kind == "regions" else 1, len(tape), prog.n_regions,
                prog.n_in, prog.out_base, prog.n_out, target, *tail]
        parts += [np.array(head, dtype=np.int64), tape, arr]
    with tempfile.TemporaryDirectory() as tmp:
        inp, outp = Path(tmp) / "in.bin", Path(tmp) / "out.bin"
        inp.write_bytes(b"".join(a.tobytes() for a in parts))
        subprocess.run([str(build()), str(inp), str(outp)], check=True,
                       capture_output=True, text=True, timeout=600)
        raw = outp.read_bytes()
    res, at = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out = np.frombuffer(raw, np.uint8, n, at).reshape(shape)
        at += n
        threads, blocks, width, bufs = np.frombuffer(raw, np.int64, 4, at)
        at += 32
        res.append((out, int(threads), int(blocks), int(width), int(bufs))
                   if detail else (out, int(threads), int(blocks)))
    if at != len(raw):
        raise RuntimeError(f"emulator wrote {len(raw)} bytes, expected {at}")
    return res
