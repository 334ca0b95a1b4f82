"""The port's host C++ library: the lz4 and snappy block codecs, xxhash,
crc32c, AES-256-GCM and the XOR-schedule tape executor.

Sources live in ``ceph_tpu_torch/native/src`` (copies of the JAX package's
``compress.cc``, ``aesgcm.cc`` and ``xor_sched.cc``, and of the xxhash and
the crc32c functions of its ``checksum.cc``).  They
are host code: the first call to `get_lib` compiles them with ``g++`` into
one shared library under ``ceph_tpu_torch/_build/`` (reused while the
sources' hash is unchanged) and binds it with ctypes, here and on the
machine with the card alike.  A failed build raises: nothing goes
unregistered or falls back to slower code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _sources() -> list:
    return sorted(SRC_DIR.glob("*.cc"))


def _build() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    so_path = BUILD_DIR / f"libceph_tpu_torch_native-{h.hexdigest()[:16]}.so"
    if so_path.exists():
        return so_path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's host codecs, hashes"
                           " and AES-GCM cannot be built")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
    res = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp),
                          *map(str, _sources())],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"g++ of the native sources exited"
                           f" {res.returncode}:\n{res.stderr}")
    os.replace(tmp, so_path)
    return so_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32, u64, i64 = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int64
    lib.ceph_tpu_crc32c.restype = u32
    lib.ceph_tpu_crc32c.argtypes = [u32, u8p, u64]
    lib.ceph_tpu_crc32c_zeros.restype = u32
    lib.ceph_tpu_crc32c_zeros.argtypes = [u32, u64]
    lib.ceph_tpu_xxh32.restype = u32
    lib.ceph_tpu_xxh32.argtypes = [u8p, u64, u32]
    lib.ceph_tpu_xxh64.restype = u64
    lib.ceph_tpu_xxh64.argtypes = [u8p, u64, u64]
    lib.ceph_tpu_xxh32_blocks.restype = None
    lib.ceph_tpu_xxh32_blocks.argtypes = [u8p, u64, u64, u32,
                                          ctypes.POINTER(ctypes.c_uint32)]
    lib.ceph_tpu_xxh64_blocks.restype = None
    lib.ceph_tpu_xxh64_blocks.argtypes = [u8p, u64, u64, u64,
                                          ctypes.POINTER(ctypes.c_uint64)]
    for alg in ("lz4", "snappy"):
        bound = getattr(lib, f"ceph_tpu_{alg}_compress_bound")
        bound.restype = u64
        bound.argtypes = [u64]
        for op in ("compress", "decompress"):
            fn = getattr(lib, f"ceph_tpu_{alg}_{op}")
            fn.restype = i64
            fn.argtypes = [u8p, u64, u8p, u64]
    lib.ceph_tpu_snappy_uncompressed_length.restype = i64
    lib.ceph_tpu_snappy_uncompressed_length.argtypes = [u8p, u64]
    for op in ("seal", "open"):     # msgr2 secure mode (aesgcm.cc)
        fn = getattr(lib, f"ceph_tpu_aesgcm_{op}")
        fn.restype = ctypes.c_int
        fn.argtypes = [u8p, u8p, u8p, u64, u8p, u64, u8p]
    i32p = ctypes.POINTER(ctypes.c_int32)
    # the XOR-schedule tape and its crc spans (xor_sched.cc)
    lib.ceph_tpu_xsched_exec.restype = None
    lib.ceph_tpu_xsched_exec.argtypes = [i32p, u64, u8p, u64, u64, u64]
    lib.ceph_tpu_xsched_crc_spans.restype = None
    lib.ceph_tpu_xsched_crc_spans.argtypes = [
        u8p, u64, i32p, u64, ctypes.POINTER(ctypes.c_uint32)]
    return lib


def get_lib() -> ctypes.CDLL:
    """The native library, built on the first call; raises if it cannot be
    built."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(_build())))
        return _lib


def prewarmed() -> bool:
    """True once get_lib() has built and bound the library: callers that
    prewarm the build off an event loop (the messenger's bind) can skip
    the hop."""
    return _lib is not None
