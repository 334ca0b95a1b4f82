"""Run the hit-set hash kernel's own code (csrc/hitset_bloom.cu) on the CPU.

A CUDA kernel has no interpret mode, and a CPU test run has no card.
`emulate_many` compiles csrc/hitset_bloom.cu's device code with the host's
g++ against bloom_emulate.cpp, which defines the CUDA builtins it uses
(`__umulhi`, `__ldg`, the thread and block indices), and runs
bloom_positions_kernel on the grid the entry launches, one thread at a
time, with the magic reciprocal the entry computes.  So the CPU tests hold
the kernel's hash, its 32-bit magic-reciprocal remainder and its
grid-stride loop against numpy (tests/test_torch_bloom_emulated.py).
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
_SRC = _HERE.parent / "csrc" / "hitset_bloom.cu"
_MAIN = _HERE / "bloom_emulate.cpp"
_BUILD = _HERE.parent / "_build" / "emulate"
_CUT = "// ---- host entry ----"


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
    exe = _BUILD / f"bloom_emulate-{digest}"
    if not exe.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        (_BUILD / "bloom_device.inc").write_text(device)
        (_BUILD / "cuda_runtime.h").write_text("#pragma once\n")
        tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
        res = subprocess.run([gxx, "-O2", "-std=c++17", f"-I{_BUILD}",
                              "-o", str(tmp), str(_MAIN)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"g++ bloom_emulate.cpp exited"
                               f" {res.returncode}:\n{res.stderr}")
        tmp.replace(exe)
    return exe


def emulate_many(jobs) -> list:
    """[(hashes [B] uint32, nbits, nhash), ...] -> [(positions [B, nhash]
    uint32, info), ...]: what the card computes for bloom_positions.  info:
    {"m", "sh1", "sh2": the magic reciprocal of nbits, "blocks": the
    launch's grid}."""
    jobs = [(np.ascontiguousarray(h, dtype=np.uint32).reshape(-1),
             int(nbits), int(nhash)) for h, nbits, nhash in jobs]
    parts = [np.array([len(jobs)], dtype=np.int64)]
    for h, nbits, nhash in jobs:
        parts.append(np.array((h.size, nhash, nbits), dtype=np.int64))
        parts.append(h)
    exe = build()
    with tempfile.TemporaryDirectory() as tmp:
        inp, outp = Path(tmp) / "in", Path(tmp) / "out"
        inp.write_bytes(b"".join(p.tobytes() for p in parts))
        res = subprocess.run([str(exe), str(inp), str(outp)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"bloom_emulate exited {res.returncode}:"
                               f" {res.stderr}")
        raw = outp.read_bytes()
    results, off = [], 0
    for h, _nbits, nhash in jobs:
        n = h.size * nhash * 4
        pos = np.frombuffer(raw, np.uint32, h.size * nhash, off).reshape(
            h.size, nhash)
        m, sh1, sh2, blocks = np.frombuffer(raw, np.int64, 4, off + n)
        results.append((pos.copy(), {"m": int(m), "sh1": int(sh1),
                                     "sh2": int(sh2), "blocks": int(blocks)}))
        off += n + 32
    return results
