"""Generic named-plugin registry (port of
ceph_tpu/common/plugin_registry.py).

Reference seam: ceph::PluginRegistry
(the reference's src/common/PluginRegistry.h:44-65) — a per-type map of
named plugins with dynamic loading (`load(type, name)` dlopens
`libceph_<type>_<name>.so` and calls `__ceph_plugin_init`).  The compressor
framework resolves its plugins through it (Compressor.cc:69-102); the
erasure-code framework has its own specialized registry
(ceph_tpu_torch.ec.registry) just like the reference.

Here dynamic loading is `importlib` of `ceph_tpu_<type>_<name>` modules
exposing `__ceph_plugin_init__(registry)`.
"""

from __future__ import annotations

import importlib
import threading
from typing import Any, Dict, Optional


class Plugin:
    """Base class for registrable plugins; subclasses add factories."""

    def __init__(self, name: str):
        self.name = name


class PluginRegistry:
    _instance: Optional["PluginRegistry"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._plugins: Dict[str, Dict[str, Any]] = {}

    @classmethod
    def instance(cls) -> "PluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def add(self, type_: str, name: str, plugin: Any) -> int:
        with self._lock:
            by_name = self._plugins.setdefault(type_, {})
            if name in by_name:
                return -17  # EEXIST
            by_name[name] = plugin
            return 0

    def remove(self, type_: str, name: str) -> int:
        with self._lock:
            by_name = self._plugins.get(type_, {})
            return 0 if by_name.pop(name, None) is not None else -2

    def get(self, type_: str, name: str) -> Optional[Any]:
        with self._lock:
            return self._plugins.get(type_, {}).get(name)

    def get_or_load(self, type_: str, name: str) -> Optional[Any]:
        plugin = self.get(type_, name)
        if plugin is not None:
            return plugin
        module_name = f"ceph_tpu_{type_}_{name}"
        try:
            module = importlib.import_module(module_name)
        except ImportError:
            return None
        init = getattr(module, "__ceph_plugin_init__", None)
        if init is None:
            return None
        init(self)
        return self.get(type_, name)
