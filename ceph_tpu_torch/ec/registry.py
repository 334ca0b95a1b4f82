"""Erasure-code plugin registry (port of ceph_tpu/ec/registry.py).

The ErasureCodePluginRegistry role: a process-wide table of named codec
factories with a version stamp, and `create_erasure_code(profile)`, which
resolves the profile's `plugin` (default `ec_torch`; `jerasure` and `isa`
are aliases of it, and route the bitmatrix techniques `liberation`,
`blaum_roth` and `liber8tion` to ec/bitmatrix_plugin.py as the reference
does; `lrc`, `shec`, `clay` and `ec_msr` are the layered,
shingled, coupled-layer and product-matrix codecs), builds the codec and
checks that it echoes the profile back, as the reference asserts.

Profile keys are those of the JAX plugins plus `device` (a torch device
string; absent means CUDA), which every codec keeps in its profile and
hands on to the codecs it is built from.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import ceph_tpu_torch
from ceph_tpu_torch.ec.interface import (ErasureCode, ErasureCodeError,
                                         ErasureCodeProfile)
from ceph_tpu_torch.ec.torch_plugin import ErasureCodeTorch

PLUGIN_VERSION = ceph_tpu_torch.__version__

Factory = Callable[[ErasureCodeProfile], ErasureCode]


class ErasureCodePlugin:
    """A named factory with a version stamp."""

    def __init__(self, name: str, factory: Factory,
                 version: str = PLUGIN_VERSION):
        self.name = name
        self.factory = factory
        self.version = version


class ErasureCodePluginRegistry:
    _instance: Optional["ErasureCodePluginRegistry"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._plugins: Dict[str, ErasureCodePlugin] = {}

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
                _register_builtin(cls._instance)
            return cls._instance

    def add(self, name: str, plugin: ErasureCodePlugin) -> int:
        with self._lock:
            if name in self._plugins:
                return -17  # EEXIST, same as the reference
            self._plugins[name] = plugin
            return 0

    def get(self, name: str) -> Optional[ErasureCodePlugin]:
        with self._lock:
            return self._plugins.get(name)

    def remove(self, name: str) -> int:
        with self._lock:
            return 0 if self._plugins.pop(name, None) else -2

    def factory(self, plugin_name: str,
                profile: ErasureCodeProfile) -> ErasureCode:
        plugin = self.get(plugin_name)
        if plugin is None:
            raise ErasureCodeError(2, f"no erasure-code plugin {plugin_name}")
        codec = plugin.factory(profile)
        prof = codec.get_profile()
        for key, val in profile.items():
            if prof.get(key) != val:
                raise ErasureCodeError(
                    22, f"plugin {plugin_name} dropped profile key {key}")
        return codec

    def names(self):
        with self._lock:
            return sorted(self._plugins)


def _torch_factory(profile: ErasureCodeProfile) -> ErasureCode:
    from ceph_tpu_torch.ec.bitmatrix_plugin import ErasureCodeTorchBitmatrix

    tech = profile.get("technique", "reed_sol_van")
    device = profile.get("device") or None
    if tech in ErasureCodeTorchBitmatrix.TECHNIQUES:
        codec: ErasureCode = ErasureCodeTorchBitmatrix(technique=tech,
                                                       device=device)
    else:
        codec = ErasureCodeTorch(technique=tech, device=device)
    codec.init(profile)
    return codec


def _lrc_factory(profile: ErasureCodeProfile) -> ErasureCode:
    from ceph_tpu_torch.ec.lrc import ErasureCodeLrc

    codec = ErasureCodeLrc()
    codec.init(profile)
    return codec


def _shec_factory(profile: ErasureCodeProfile) -> ErasureCode:
    from ceph_tpu_torch.ec.shec import ErasureCodeShec

    codec = ErasureCodeShec(
        technique=profile.setdefault("technique", "multiple"))
    codec.init(profile)
    return codec


def _clay_factory(profile: ErasureCodeProfile) -> ErasureCode:
    from ceph_tpu_torch.ec.clay import ErasureCodeClay

    codec = ErasureCodeClay()
    codec.init(profile)
    return codec


def _msr_factory(profile: ErasureCodeProfile) -> ErasureCode:
    from ceph_tpu_torch.ec.msr import ErasureCodeMsr

    codec = ErasureCodeMsr()
    codec.init(profile)
    return codec


def _register_builtin(reg: ErasureCodePluginRegistry) -> None:
    # `jerasure` and `isa` are aliases of `ec_torch`, as the JAX package
    # maps them to `ec_jax`, so that reference profiles (plugin=jerasure
    # technique=reed_sol_van, the osd_pool_default_erasure_code_profile)
    # resolve to the port's codec
    for name in ("ec_torch", "jerasure", "isa"):
        reg.add(name, ErasureCodePlugin(name, _torch_factory))
    for name, factory in (("lrc", _lrc_factory), ("shec", _shec_factory),
                          ("clay", _clay_factory), ("ec_msr", _msr_factory)):
        reg.add(name, ErasureCodePlugin(name, factory))


def create_erasure_code(profile: ErasureCodeProfile) -> ErasureCode:
    """Build a codec from a reference-style profile string map."""
    plugin = profile.get("plugin", "ec_torch")
    return ErasureCodePluginRegistry.instance().factory(plugin, dict(profile))
