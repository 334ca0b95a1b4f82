"""Run the fold kernel's own code (csrc/gf_fold.cu) on the CPU.

A CUDA kernel has no interpret mode, and a CPU test run has no card.
`emulate_many` compiles csrc/gf_fold.cu's device code with the host's g++
against fold_emulate.cpp, which defines the CUDA builtins the kernel uses: a
thread block is 256 fibers on one OS thread, `__syncthreads` a barrier of
all of them and a warp shuffle a barrier of its 32 lanes.  It runs
gf_fold_kernel itself on the grid the launcher would choose for a card that
holds a given number of blocks at once, so the CPU tests hold the kernel's
bit-plane accumulation, its 16- and 4-byte vector paths, its shuffles and
shared partials, and the atomics that combine an item's chunks across
blocks against the plain version (tests/test_torch_fold_emulated.py).
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
_SRC = _HERE.parent / "csrc" / "gf_fold.cu"
_MAIN = _HERE / "fold_emulate.cpp"
_BUILD = _HERE.parent / "_build" / "emulate"
_CUT = "namespace {"    # gf_fold.cu's host launchers start here

# the blocks an H100 holds at once of the weighted 16-byte kernel: 132 SMs,
# 4 blocks of 256 threads at its 64 registers
H100_TARGET = 132 * 4


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
    exe = _BUILD / f"fold_emulate-{digest}"
    if not exe.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        (_BUILD / "fold_device.inc").write_text(device)
        # gf_fold.cu's one CUDA header: fold_emulate.cpp defines what it uses
        (_BUILD / "cuda_runtime.h").write_text("#pragma once\n")
        tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
        # -U_FORTIFY_SOURCE: the fibers _longjmp between stacks, which a
        # fortified longjmp would refuse
        res = subprocess.run([gxx, "-O2", "-std=c++17", "-U_FORTIFY_SOURCE",
                              "-Wno-unknown-pragmas", "-fno-strict-aliasing",
                              f"-I{_BUILD}", "-o", str(tmp), str(_MAIN)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"g++ fold_emulate.cpp exited"
                               f" {res.returncode}:\n{res.stderr}")
        tmp.replace(exe)
    return exe


def emulate_many(jobs, targets=None) -> list:
    """[(weights (rows,) uint8 or None, data (B, rows, lanes) uint8), ...]
    -> [(out (B, 1, lanes) uint8, grid), ...]: what the card computes for
    gf_fold, each job on the grid the launcher picks for a card holding
    `targets[i]` blocks at once (default H100_TARGET).  grid: {"chunks":
    chunks per item, "blocks": blocks of the launch}."""
    jobs = [(None if w is None else np.ascontiguousarray(w, np.uint8)
             .reshape(-1), np.ascontiguousarray(d, dtype=np.uint8))
            for w, d in jobs]
    targets = [H100_TARGET] * len(jobs) if targets is None else targets
    parts = [np.array([len(jobs)], dtype=np.int64)]
    for (w, d), target in zip(jobs, targets, strict=True):
        b, rows, lanes = d.shape
        parts.append(np.array((b, rows, lanes, target, w is not None),
                              dtype=np.int64))
        if w is not None:
            parts.append(w)
        parts.append(d)
    with tempfile.TemporaryDirectory() as tmp:
        inp, outp = Path(tmp) / "in.bin", Path(tmp) / "out.bin"
        inp.write_bytes(b"".join(a.tobytes() for a in parts))
        subprocess.run([str(build()), str(inp), str(outp)], check=True,
                       capture_output=True, text=True, timeout=600)
        raw = outp.read_bytes()
    res, at = [], 0
    for _w, d in jobs:
        b, _rows, lanes = d.shape
        out = np.frombuffer(raw, np.uint8, b * lanes, at).reshape(b, 1, lanes)
        at += out.size
        chunks, blocks = np.frombuffer(raw, np.int64, 2, at).tolist()
        at += 16
        res.append((out, {"chunks": chunks, "blocks": blocks}))
    if at != len(raw):
        raise RuntimeError(f"emulator wrote {len(raw)} bytes, expected {at}")
    return res
