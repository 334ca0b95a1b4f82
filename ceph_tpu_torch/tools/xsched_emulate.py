"""Run the xor_sched kernels' own code (csrc/xor_sched.cu) on the CPU.

A CUDA kernel has no interpret mode, and a CPU test run has no card.
`emulate_many` compiles csrc/xor_sched.cu's device code with the host's
g++ against xsched_emulate.cpp, which defines the CUDA builtins the kernels
use: a thread block is blockDim.x fibers on one OS thread and
`__syncthreads` a barrier of all of them.  It runs xs_regions_kernel and
xs_gf_kernel themselves with the block size the launcher picks
(xs_threads) on a grid of min(tiles, target) blocks, so the CPU tests
hold the tape staging (resident and chunked), the 4- and 1-byte columns,
the ragged last tile and blocks that walk several tiles against the plain
versions (tests/test_torch_xsched.py).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE.parent / "csrc" / "xor_sched.cu"
_MAIN = _HERE / "xsched_emulate.cpp"
_BUILD = _HERE.parent / "_build" / "emulate"
_CUT = "namespace {"    # xor_sched.cu's host launchers start here

# blocks an H100 holds at once of 128-thread blocks (2048 threads an SM)
H100_TARGET = 132 * 16


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
        # xor_sched.cu's one CUDA header: xsched_emulate.cpp defines what
        # it uses
        (_BUILD / "cuda_runtime.h").write_text("#pragma once\n")
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


def emulate_many(jobs) -> list:
    """jobs: ("regions", prog, arena (n_objects, n_regions, bytes) uint8,
    target) or ("gf", prog, data (B, K, S) uint8, target) -> [(result,
    threads, blocks), ...]: the arena after the launch, or the (B, R, S)
    product, as the card computes them on a grid of min(tiles, target)
    blocks."""
    parts = [np.array([len(jobs)], dtype=np.int64)]
    shapes = []
    for kind, prog, arr, target in jobs:
        arr = np.ascontiguousarray(arr, dtype=np.uint8)
        head = [prog.n_ops, prog.n_regions, prog.n_in, prog.out_base,
                prog.n_out, target]
        if kind == "regions":
            n_obj, n_reg, rbytes = arr.shape
            if n_reg != prog.n_regions:
                raise ValueError("arena regions differ from the program's")
            head = [0, *head, n_obj, rbytes, 0]
            shapes.append(arr.shape)
        else:
            b, k, s = arr.shape
            r = prog.n_out // 8
            head = [1, *head, b, (k << 32) | r, s]
            shapes.append((b, r, s))
        parts += [np.array(head, dtype=np.int64),
                  np.ascontiguousarray(prog.tape, dtype=np.int32), arr]
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
        threads, blocks = np.frombuffer(raw, np.int64, 2, at)
        at += 16
        res.append((out, int(threads), int(blocks)))
    if at != len(raw):
        raise RuntimeError(f"emulator wrote {len(raw)} bytes, expected {at}")
    return res
