"""Run the hit-set kernels' own code (csrc/hitset_bloom.cu) on the CPU.

A CUDA kernel has no interpret mode, and a CPU test run has no card.
`emulate_many` and `emulate_seals` compile csrc/hitset_bloom.cu's device
code with the host's g++ against bloom_emulate.cpp, which defines the CUDA
names it uses (`__umulhi`, `__ldg`, `atomicOr`, `__syncthreads`, the
thread and block indices, the dynamic shared memory).
`emulate_many` runs bloom_positions_kernel on the grid the entry launches,
one thread at a time, with the magic reciprocal the entry computes.
`emulate_seals` runs bloom_seal_kernel on the grid and shared memory the
entry's plan gives (bloom_seal_plan): a block is 256 fibers switched at
each `__syncthreads`, in rising or falling thread order, with its shared
memory and the unzeroed rows full of garbage.  So the CPU tests hold the
kernels' hash, their 32-bit magic-reciprocal remainder and quotient, the
grid-stride loop, the shared bitset, its barriers, the chunked blocks and
the global-memory path against numpy (tests/test_torch_bloom_emulated.py);
`source` runs a changed copy of the device code instead, built in
`build_dir` (mutation checks).
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


def device_source() -> str:
    """csrc/hitset_bloom.cu up to its host entry: what the emulator runs."""
    src = _SRC.read_text()
    return src[: src.index(_CUT)]


def build(source: str | None = None, build_dir: Path | None = None) -> Path:
    """The emulator binary for `source` (default: device_source()),
    compiled on first use into `build_dir` (default: the package's
    _build/emulate), cached by the sources' hash; RuntimeError without g++
    or when it does not compile."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the emulator cannot be built")
    device = device_source() if source is None else source
    digest = hashlib.sha256((device + _MAIN.read_text()).encode()) \
        .hexdigest()[:16]
    where = _BUILD if build_dir is None else Path(build_dir)
    exe = where / f"bloom_emulate-{digest}"
    if not exe.exists():
        work = where / f"bloom-{digest}"
        work.mkdir(parents=True, exist_ok=True)
        (work / "bloom_device.inc").write_text(device)
        (work / "cuda_runtime.h").write_text("#pragma once\n")
        tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
        # -U_FORTIFY_SOURCE: the fibers _longjmp between stacks, which a
        # fortified longjmp would refuse
        res = subprocess.run([gxx, "-O2", "-std=c++17", "-U_FORTIFY_SOURCE",
                              f"-I{work}", "-o", str(tmp), str(_MAIN)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"g++ bloom_emulate.cpp exited"
                               f" {res.returncode}:\n{res.stderr}")
        tmp.replace(exe)
    return exe


def _run(parts: list, source: str | None = None,
         build_dir: Path | None = None) -> bytes:
    exe = build(source, build_dir)
    with tempfile.TemporaryDirectory() as tmp:
        inp, outp = Path(tmp) / "in", Path(tmp) / "out"
        inp.write_bytes(b"".join(p.tobytes() for p in parts))
        res = subprocess.run([str(exe), str(inp), str(outp)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"bloom_emulate exited {res.returncode}:"
                               f" {res.stderr}")
        return outp.read_bytes()


def emulate_many(jobs) -> list:
    """[(hashes [B] uint32, nbits, nhash), ...] -> [(positions [B, nhash]
    uint32, info), ...]: what the card computes for bloom_positions.  info:
    {"m", "sh1", "sh2": the magic reciprocal of nbits, "blocks": the
    launch's grid}."""
    jobs = [(np.ascontiguousarray(h, dtype=np.uint32).reshape(-1),
             int(nbits), int(nhash)) for h, nbits, nhash in jobs]
    parts = [np.array([len(jobs)], dtype=np.int64)]
    for h, nbits, nhash in jobs:
        parts.append(np.array((0, h.size, nhash, nbits), dtype=np.int64))
        parts.append(h)
    raw = _run(parts)
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


def emulate_seals(jobs, source: str | None = None,
                  build_dir: Path | None = None) -> list:
    """[(sets: [S] uint32 hash arrays, nbits, nhash[, order]), ...] ->
    [(rows [S, ceil(nbits / 32)] uint32, info), ...]: what the card
    computes for one bloom_seal launch over the sets.  order: "rising"
    (the default) or "falling", the order in which a block's threads run
    between barriers.  info: {"chunks": the grid's blocks a set, "shared":
    the bitsets were built in shared memory, "zeroed": the rows were
    zeroed before the kernel, "smem": the launch's shared bytes}."""
    parts = [np.array([len(jobs)], dtype=np.int64)]
    shapes = []
    for sets, nbits, nhash, *order in jobs:
        arrays = [np.asarray(h, dtype=np.uint32).reshape(-1) for h in sets]
        offsets = np.zeros(len(arrays) + 1, dtype=np.int32)
        np.cumsum([a.size for a in arrays], out=offsets[1:])
        falling = {"rising": 0, "falling": 1}[order[0] if order else
                                               "rising"]
        hashes = np.concatenate(arrays) if arrays else np.zeros(0, np.uint32)
        parts += [np.array((1, hashes.size, len(arrays), nhash, nbits,
                            falling), dtype=np.int64), hashes, offsets]
        shapes.append((len(arrays), (int(nbits) + 31) // 32))
    raw = _run(parts, source, build_dir)
    results, off = [], 0
    for sets, nwords in shapes:
        rows = np.frombuffer(raw, np.uint32, sets * nwords, off).reshape(
            sets, nwords)
        off += sets * nwords * 4
        chunks, shared, zeroed, smem = np.frombuffer(raw, np.int64, 4, off)
        off += 32
        results.append((rows.copy(), {"chunks": int(chunks),
                                      "shared": bool(shared),
                                      "zeroed": bool(zeroed),
                                      "smem": int(smem)}))
    if off != len(raw):
        raise RuntimeError(f"emulator wrote {len(raw)} bytes, expected {off}")
    return results
