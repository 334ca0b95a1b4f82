"""Compression framework (port of ceph_tpu/compressor/__init__.py).

Reference seam: the reference's src/compressor/Compressor.h — the
`Compressor` ABC (algorithms none/snappy/zlib/zstd/lz4/brotli, pool modes
none/passive/aggressive/force, `compress`/`decompress`, factory by name via
the generic PluginRegistry at Compressor.cc:69-102, including the "random"
teuthology algorithm :72-78).

Device addition: batched compressibility scoring
(ceph_tpu_torch.compressor.scoring) runs a byte-histogram entropy estimate
and a self-match probe on the card (the `score_blocks` CUDA kernel) so the
BlueStore-style write path can decide compress-vs-skip before spending host
CPU on the codec.  The algorithm ids are the JAX package's (and the
reference's): they are written into blob metadata on disk.
"""

from __future__ import annotations

import random as _random
from typing import List, Optional, Tuple

from ceph_tpu_torch.common.plugin_registry import PluginRegistry

# algorithm ids, matching the reference enum values (Compressor.h:35-47)
COMP_ALG_NONE = 0
COMP_ALG_SNAPPY = 1
COMP_ALG_ZLIB = 2
COMP_ALG_ZSTD = 3
COMP_ALG_LZ4 = 4
COMP_ALG_BROTLI = 5

COMPRESSION_ALGORITHMS: List[Tuple[str, int]] = [
    ("none", COMP_ALG_NONE),
    ("snappy", COMP_ALG_SNAPPY),
    ("zlib", COMP_ALG_ZLIB),
    ("zstd", COMP_ALG_ZSTD),
    ("lz4", COMP_ALG_LZ4),
    ("brotli", COMP_ALG_BROTLI),
]

# pool compression modes (Compressor.h:64-69)
COMP_NONE = 0        # compress never
COMP_PASSIVE = 1     # compress if hinted COMPRESSIBLE
COMP_AGGRESSIVE = 2  # compress unless hinted INCOMPRESSIBLE
COMP_FORCE = 3       # compress always

_MODE_NAMES = {COMP_NONE: "none", COMP_PASSIVE: "passive",
               COMP_AGGRESSIVE: "aggressive", COMP_FORCE: "force"}

# alloc-hint flags relevant to compression (os/ObjectStore.h alloc hints)
ALLOC_HINT_COMPRESSIBLE = 1
ALLOC_HINT_INCOMPRESSIBLE = 2


def get_comp_alg_name(alg: int) -> str:
    for name, a in COMPRESSION_ALGORITHMS:
        if a == alg:
            return name
    return "???"


def get_comp_alg_type(name: str) -> Optional[int]:
    for n, a in COMPRESSION_ALGORITHMS:
        if n == name:
            return a
    return None


def get_comp_mode_name(mode: int) -> str:
    return _MODE_NAMES.get(mode, "???")


def get_comp_mode_type(name: str) -> Optional[int]:
    for mode, n in _MODE_NAMES.items():
        if n == name:
            return mode
    return None


class Compressor:
    """Abstract codec: bytes in, bytes out.

    The reference's `compressor_message` side-channel (an optional int32
    rides the blob metadata, e.g. zlib window bits) is kept: `compress`
    returns (payload, message) and `decompress` takes the message back.
    """

    def __init__(self, alg: int, type_name: str):
        self.alg = alg
        self.type_name = type_name

    def get_type_name(self) -> str:
        return self.type_name

    def get_type(self) -> int:
        return self.alg

    def compress(self, data: bytes) -> Tuple[bytes, Optional[int]]:
        raise NotImplementedError

    def decompress(self, data: bytes,
                   compressor_message: Optional[int] = None) -> bytes:
        raise NotImplementedError

    # -- factory ----------------------------------------------------------

    @staticmethod
    def create(type_name: str) -> Optional["Compressor"]:
        """Factory by algorithm name; None if unknown/unavailable.

        Mirrors Compressor::create (Compressor.cc:69-102), including
        "random" which picks a real algorithm per instance.
        """
        _ensure_builtin_plugins()
        if type_name == "random":
            candidates = [n for n, _ in COMPRESSION_ALGORITHMS
                          if n != "none" and
                          PluginRegistry.instance().get("compressor", n)]
            type_name = _random.choice(candidates)
        if not any(n == type_name for n, _ in COMPRESSION_ALGORITHMS):
            return None
        if type_name == "none":
            return None  # reference returns nullptr for "none" too
        plugin = PluginRegistry.instance().get_or_load("compressor", type_name)
        if plugin is None:
            return None
        return plugin.factory()

    @staticmethod
    def create_by_alg(alg: int) -> Optional["Compressor"]:
        return Compressor.create(get_comp_alg_name(alg))


class CompressionPlugin:
    """Named factory (reference: CompressionPlugin.h)."""

    def __init__(self, name: str, factory):
        self.name = name
        self.factory = factory


_builtins_loaded = False


def _ensure_builtin_plugins() -> None:
    global _builtins_loaded
    if _builtins_loaded:
        return
    _builtins_loaded = True
    from ceph_tpu_torch.compressor import plugins

    plugins.register_all(PluginRegistry.instance())


def available_algorithms() -> List[str]:
    """Names with a working codec in this build (zstd/brotli are gated)."""
    _ensure_builtin_plugins()
    reg = PluginRegistry.instance()
    return [n for n, _ in COMPRESSION_ALGORITHMS
            if n != "none" and reg.get("compressor", n) is not None]
