"""Run the GF(2^8) kernel's own code (csrc/gf_matmul.cu) on the CPU.

A CUDA kernel has no interpret mode, and a CPU test run has no card.
`emulate_many` compiles csrc/gf_matmul.cu's code up to its host launchers
with the host's g++ against gf_emulate.cpp, which defines the CUDA builtins
the kernel uses and runs the grid serially.  Each job goes through what the
`gf_matmul_gen` entry does on the card: the schedule derived from the
coefficients (horner_schedule), the launch's grid (horner_grid) and
gf_horner_kernel on every block and thread of it, so the CPU tests hold the
kernel's own code against the plain version
(tests/test_torch_gf_emulated.py).
"""

from __future__ import annotations

import hashlib
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE.parent / "csrc" / "gf_matmul.cu"
_MAIN = _HERE / "gf_emulate.cpp"
_BUILD = _HERE.parent / "_build" / "emulate"
_CUT = "namespace {"    # gf_matmul.cu's host launchers start here


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
    exe = _BUILD / f"gf_emulate-{digest}"
    if not exe.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        (_BUILD / "gf_device.inc").write_text(device)
        # gf_matmul.cu's one CUDA header: gf_emulate.cpp defines what it uses
        (_BUILD / "cuda_runtime.h").write_text("#pragma once\n")
        tmp = exe.with_suffix(".tmp")
        res = subprocess.run([gxx, "-O2", "-std=c++17",
                              "-fno-strict-aliasing", f"-I{_BUILD}", "-o",
                              str(tmp), str(_MAIN)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"g++ gf_emulate.cpp exited"
                               f" {res.returncode}:\n{res.stderr}")
        tmp.replace(exe)
    return exe


def emulate_many(jobs) -> list:
    """[(matrix (R, K), data (B, K, S) uint8), ...] -> [(out (B, R, S)
    uint8, masks (G, R, 8) uint8, tops (G, R) int8), ...]: what the card
    computes for gf_matmul_gen, and the schedule its entry derived."""
    jobs = [(np.ascontiguousarray(m, dtype=np.uint8),
             np.ascontiguousarray(d, dtype=np.uint8)) for m, d in jobs]
    parts = [np.array([len(jobs)], dtype=np.int64)]
    for m, d in jobs:
        r, k = m.shape
        b, _, s = d.shape
        parts += [np.array([r, k, b, s], dtype=np.int64), m, d]
    with tempfile.TemporaryDirectory() as tmp:
        inp, outp = Path(tmp) / "in.bin", Path(tmp) / "out.bin"
        inp.write_bytes(b"".join(a.tobytes() for a in parts))
        subprocess.run([str(build()), str(inp), str(outp)], check=True,
                       capture_output=True, text=True, timeout=600)
        raw = outp.read_bytes()
    res, at = [], 0
    for m, d in jobs:
        r, k = m.shape
        b, _, s = d.shape
        g = -(-k // 8)
        masks = np.frombuffer(raw, np.uint8, g * r * 8, at).reshape(g, r, 8)
        at += masks.size
        tops = np.frombuffer(raw, np.int8, g * r, at).reshape(g, r)
        at += tops.size
        out = np.frombuffer(raw, np.uint8, b * r * s, at).reshape(b, r, s)
        at += out.size
        res.append((out, masks, tops))
    if at != len(raw):
        raise RuntimeError(f"emulator wrote {len(raw)} bytes, expected {at}")
    return res


def emulate(matrix, data) -> np.ndarray:
    """One job: (R, K) matrix x (B, K, S) uint8 -> (B, R, S) uint8."""
    return emulate_many([(matrix, data)])[0][0]
