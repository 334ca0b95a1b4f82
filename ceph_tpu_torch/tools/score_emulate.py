"""Run the scoring kernel's own code (csrc/compress_score.cu) on the CPU.

A CUDA kernel has no interpret mode, and a CPU test run has no card.
`emulate_many` compiles csrc/compress_score.cu's device code with the host's
g++ against score_emulate.cpp, which defines the CUDA builtins the kernel
uses: a thread block is 256 fibers on one OS thread, `__syncthreads` a
barrier of all of them and a warp shuffle a barrier of its 32 lanes.  It runs
score_kernel itself, on the grid the launcher would choose for a card that
holds a given number of blocks at once, with every job on one workspace
zeroed once, so the CPU tests hold the kernel's packed-word lag counts,
lane-column histograms, tiles, halos, partial sums across blocks and the
workspace's self-reset against the plain version
(tests/test_torch_score_emulated.py).
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
_SRC = _HERE.parent / "csrc" / "compress_score.cu"
_MAIN = _HERE / "score_emulate.cpp"
_BUILD = _HERE.parent / "_build" / "emulate"


def build() -> Path:
    """The emulator binary, compiled on first use (cached by the sources'
    hash); RuntimeError without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the emulator cannot be built")
    src = _SRC.read_text()
    device = src[: src.index('extern "C" {')]
    digest = hashlib.sha256((device + _MAIN.read_text()).encode()) \
        .hexdigest()[:16]
    exe = _BUILD / f"score_emulate-{digest}"
    if not exe.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        (_BUILD / "score_device.inc").write_text(device)
        # compress_score.cu's one CUDA header: score_emulate.cpp defines
        # what it uses
        (_BUILD / "cuda_runtime.h").write_text("#pragma once\n")
        tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
        # -U_FORTIFY_SOURCE: the fibers _longjmp between stacks, which a
        # fortified longjmp would refuse
        res = subprocess.run([gxx, "-O2", "-std=c++17", "-U_FORTIFY_SOURCE",
                              "-fno-strict-aliasing", f"-I{_BUILD}", "-o",
                              str(tmp), str(_MAIN)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"g++ score_emulate.cpp exited"
                               f" {res.returncode}:\n{res.stderr}")
        tmp.replace(exe)
    return exe


# the blocks an H100 holds at once: 132 SMs, 3 blocks of score_kernel each
H100_TARGET = 132 * 3


def emulate_many(batches, targets=None) -> list:
    """[(B, S) uint8, ...] -> [(hist (B, 256) int32, entropy (B,) float32,
    match (B,) float32, grid), ...]: what the card computes for score_blocks,
    each batch on the grid the launcher picks for a card holding
    `targets[i]` blocks at once (default H100_TARGET).  grid: {"blocks":
    blocks per row, "tiles": tiles per block, "left": the workspace's
    nonzero ints after the batch (the kernel leaves none)}."""
    batches = [np.ascontiguousarray(d, dtype=np.uint8) for d in batches]
    targets = [H100_TARGET] * len(batches) if targets is None else targets
    parts = [np.array([len(batches)], dtype=np.int64)]
    for d, target in zip(batches, targets, strict=True):
        parts += [np.array((*d.shape, target), dtype=np.int64), d]
    with tempfile.TemporaryDirectory() as tmp:
        inp, outp = Path(tmp) / "in.bin", Path(tmp) / "out.bin"
        inp.write_bytes(b"".join(a.tobytes() for a in parts))
        subprocess.run([str(build()), str(inp), str(outp)], check=True,
                       capture_output=True, text=True, timeout=600)
        raw = outp.read_bytes()
    res, at = [], 0
    for d in batches:
        b = d.shape[0]
        out = np.frombuffer(raw, np.int32, b * 258, at).reshape(b, 258)
        at += out.nbytes
        blocks, tiles, left = np.frombuffer(raw, np.int64, 3, at).tolist()
        at += 24
        res.append((out[:, :256], out[:, 256].view(np.float32),
                    out[:, 257].view(np.float32),
                    {"blocks": blocks, "tiles": tiles, "left": left}))
    if at != len(raw):
        raise RuntimeError(f"emulator wrote {len(raw)} bytes, expected {at}")
    return res
