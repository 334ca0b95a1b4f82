"""Run the placement kernel's own code (csrc/crush.cu) on the CPU.

A CUDA kernel has no interpret mode, and a CPU test run has no card.
`emulate` compiles csrc/crush.cu's device code with the host's g++ against
crush_emulate.cpp, which defines the CUDA builtins the kernel uses: a warp
is 32 threads, and every warp collective meets at a barrier of the lanes it
names.  It runs crush_kernel itself, refill, lane steps, the tail's regroup
and the group reduction included, so the CPU tests hold the kernel's logic
against the plain version (tests/test_torch_crush_emulated.py).
"""

from __future__ import annotations

import hashlib
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

_HERE = Path(__file__).resolve().parent
_SRC = _HERE.parent / "csrc" / "crush.cu"
_MAIN = _HERE / "crush_emulate.cpp"
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
    exe = _BUILD / f"crush_emulate-{digest}"
    if not exe.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        (_BUILD / "crush_device.inc").write_text(device)
        # crush.cu's one CUDA header: crush_emulate.cpp defines what it uses
        (_BUILD / "cuda_runtime.h").write_text("#pragma once\n")
        tmp = exe.with_suffix(".tmp")
        res = subprocess.run([gxx, "-O2", "-std=c++20", "-pthread",
                              f"-I{_BUILD}", "-o", str(tmp), str(_MAIN)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"g++ crush_emulate.cpp exited"
                               f" {res.returncode}:\n{res.stderr}")
        tmp.replace(exe)
    return exe


def emulate(dm, program, xs, warps: int = 4) -> np.ndarray:
    """crush_kernel on `warps` emulated warps: (N,) inputs -> (N,
    result_max) int32, what the card computes."""
    from ceph_tpu_torch.crush.kernel import ln_tables

    xs = np.asarray(xs, dtype=np.int32)
    nb, ms = dm.items.shape
    head = np.array([nb, ms, dm.dev_weight.shape[0], dm.max_devices,
                     dm.max_depth, xs.size, *program, warps], dtype=np.int64)
    cpu = torch.device("cpu")
    parts = [head, dm.items.cpu().numpy().astype(np.int32),
             dm.recips.cpu().numpy().astype(np.int64),
             dm.sizes.cpu().numpy().astype(np.int32),
             dm.types.cpu().numpy().astype(np.int32),
             dm.dev_weight.cpu().numpy().astype(np.int64),
             ln_tables(cpu).numpy().astype(np.int64), xs]
    with tempfile.TemporaryDirectory() as tmp:
        inp, outp = Path(tmp) / "in.bin", Path(tmp) / "out.bin"
        inp.write_bytes(b"".join(a.tobytes() for a in parts))
        subprocess.run([str(build()), str(inp), str(outp)], check=True,
                       capture_output=True, text=True, timeout=3600)
        return np.fromfile(outp, dtype=np.int32).reshape(
            xs.size, program.result_max)
