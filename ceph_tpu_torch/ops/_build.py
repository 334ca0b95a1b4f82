"""Build and bind the CUDA kernels of ``ceph_tpu_torch/csrc``.

Each ``csrc/*.cu`` source compiles on first use, with one ``nvcc`` process
per source started together, into its own shared library with a plain C
interface under ``ceph_tpu_torch/_build/``, which is loaded with ctypes.
A library is reused while the hash of the sources and flags is unchanged.
A failed build raises: nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)      # a host int array (the rule)

# C entry points and their argument types (every pointer and the stream
# as c_void_p, so ctypes never truncates them to 32-bit ints)
_SIGNATURES = {
    "gf_matmul": {
        "gf_matmul_spec": (_P, _P, _I, _I, _I, _P, _P, _LL, _LL, _P),
        "gf_matmul_gen": (_P, _I, _I, _I, _P, _P, _LL, _LL, _P),
    },
    "crc32c": {
        "crc32c_blocks": (_P, _I, _P, _LL, _LL, _LL, _I, _P, _P),
        "crc32c_smem_bytes": (),
    },
    "compress_score": {
        "score_blocks": (_P, _I, _LL, _LL, _P, _P, _P, _P, _P),
        "score_scratch_ints": (),
    },
    "gf_fold": {
        "gf_fold": (_P, _I, _P, _P, _LL, _LL, _I, _P),
    },
    "hitset_bloom": {
        "bloom_positions": (_P, _P, _LL, _I, ctypes.c_uint, _I, _P),
        "bloom_seal": (_P, _P, _P, _I, _LL, _I, ctypes.c_uint, _I, _P),
        "bloom_seal_staged": (_P, _P, _LL, _P, _P, _I, _LL, _I,
                              ctypes.c_uint, _I, _P),
    },
    "xor_sched": {
        "xor_sched_regions": (_P, _I, _I, _I, _P, _LL, _I, _LL, _I, _I, _I,
                              _P),
        "xor_sched_gf": (_P, _I, _I, _P, _P, _LL, _I, _I, _LL, _I, _I, _P),
        "xor_sched_column_bytes": (_I, _I, _I, _I),
        "xor_sched_gf_fits": (_I, _I, _I),
    },
    "crush": {
        "crush_do_rule_batch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _PI, _I, _P, _LL, _P, _P, _P),
    },
}

_libs: dict | None = None
_lock = threading.Lock()
build_seconds: float | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))  # toolkit default
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH);"
                       " the CUDA kernels cannot be built")


def _digest(sources: list) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(sources):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build_all() -> dict:
    t0 = time.perf_counter()
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = _digest(sources + sorted(SRC_DIR.glob("*.cuh")))
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for src in sources:
        lib = BUILD_DIR / f"{src.stem}-{digest}.so"
        if lib.exists():
            continue
        tmp = BUILD_DIR / f"{src.stem}-{digest}.{os.getpid()}.tmp"
        procs[src.stem] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}-{digest}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    libs = {}
    for src in sources:
        lib = ctypes.CDLL(str(BUILD_DIR / f"{src.stem}-{digest}.so"))
        for fn, argtypes in _SIGNATURES.get(src.stem, {}).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[src.stem] = lib
    global build_seconds
    build_seconds = time.perf_counter() - t0
    return libs


def load() -> dict:
    """{source stem: ctypes.CDLL}, building on first call."""
    global _libs
    with _lock:
        if _libs is None:
            _libs = _build_all()
        return _libs


def build_logs() -> dict:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    for each source compiled by this build."""
    digest = _digest(sorted(SRC_DIR.glob("*.cu"))
                     + sorted(SRC_DIR.glob("*.cuh")))
    return {p.stem.rsplit("-", 1)[0]: p.read_text()
            for p in sorted(BUILD_DIR.glob(f"*-{digest}.log"))}


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
