"""Layered typed configuration (port of
ceph_tpu/common/config.py).

Reference parity: md_config_t (the reference's src/common/config.cc) and
its source precedence (SURVEY.md §5.6): compiled default < conf file <
mon centralized config < environment < CLI < runtime override.  Observers
(md_config_obs_t) are notified with the set of changed keys on
apply_changes, enabling live reconfiguration (e.g. BlueStore re-reading
bluestore_csum_type, BlueStore.cc:4457).

Conf files are ini-style like ceph.conf: [global]/[osd]/[osd.0] sections,
later/more-specific sections win.
"""

from __future__ import annotations

import configparser
import os
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Set

from ceph_tpu_torch.common.options import OPTIONS

# precedence, low to high (config.cc source ranking)
SOURCES = ("default", "file", "mon", "env", "cli", "runtime")

Observer = Callable[[Set[str]], None]


class Config:
    def __init__(self, entity: str = "client") -> None:
        self.entity = entity  # e.g. "osd.3" / "mon.a" / "client"
        self._lock = threading.RLock()
        self._values: Dict[str, Dict[str, Any]] = {s: {} for s in SOURCES}
        self._observers: List[tuple] = []  # (keys, callback)
        self._staged: Set[str] = set()

    # -- reads ------------------------------------------------------------

    def get(self, name: str) -> Any:
        opt = OPTIONS.get(name)
        with self._lock:
            for source in reversed(SOURCES):
                if name in self._values[source]:
                    return self._values[source][name]
        if opt is None:
            raise KeyError(name)
        return opt.default

    def get_val(self, name: str) -> Any:
        return self.get(name)

    def source_of(self, name: str) -> str:
        with self._lock:
            for source in reversed(SOURCES):
                if name in self._values[source]:
                    return source
        return "default"

    def show_config(self) -> Dict[str, Any]:
        return {name: self.get(name) for name in sorted(OPTIONS)}

    def diff(self) -> Dict[str, Dict[str, Any]]:
        """Non-default values with their source (`config diff`)."""
        out: Dict[str, Dict[str, Any]] = {}
        for name, opt in OPTIONS.items():
            val = self.get(name)
            if val != opt.default:
                out[name] = {"current": val, "default": opt.default,
                             "source": self.source_of(name)}
        return out

    # -- writes -----------------------------------------------------------

    def set_val(self, name: str, value: Any, source: str = "runtime",
                apply: bool = True) -> None:
        if source not in SOURCES or source == "default":
            raise ValueError(f"bad config source {source}")
        opt = OPTIONS.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name}")
        cast = opt.cast(value)
        with self._lock:
            self._values[source][name] = cast
            self._staged.add(name)
        if apply:
            self.apply_changes()

    def rm_val(self, name: str, source: str = "runtime",
               apply: bool = True) -> None:
        with self._lock:
            if self._values[source].pop(name, None) is not None:
                self._staged.add(name)
        if apply:
            self.apply_changes()

    def apply_changes(self) -> Set[str]:
        with self._lock:
            changed = set(self._staged)
            self._staged.clear()
            observers = list(self._observers)
        for keys, callback in observers:
            relevant = changed if keys is None else (changed & keys)
            if relevant:
                callback(relevant)
        return changed

    # -- observers (md_config_obs_t) --------------------------------------

    def add_observer(self, callback: Observer,
                     keys: Optional[Iterable[str]] = None) -> None:
        with self._lock:
            self._observers.append(
                (set(keys) if keys is not None else None, callback))

    def remove_observer(self, callback: Observer) -> None:
        with self._lock:
            self._observers = [(k, cb) for k, cb in self._observers
                               if cb is not callback]

    # -- bulk sources -----------------------------------------------------

    def parse_env(self, env: Optional[Dict[str, str]] = None) -> None:
        """CEPH_TPU_<OPTION_NAME>=value environment overrides."""
        env = os.environ if env is None else env
        for key, val in env.items():
            if not key.startswith("CEPH_TPU_"):
                continue
            name = key[len("CEPH_TPU_"):].lower()
            if name in OPTIONS:
                self.set_val(name, val, source="env", apply=False)
        self.apply_changes()

    def parse_argv(self, argv: List[str]) -> List[str]:
        """--name=value / --name value CLI overrides; returns leftovers."""
        leftover: List[str] = []
        i = 0
        while i < len(argv):
            arg = argv[i]
            if arg.startswith("--"):
                body = arg[2:]
                if "=" in body:
                    name, val = body.split("=", 1)
                    name = name.replace("-", "_")
                    if name in OPTIONS:
                        self.set_val(name, val, source="cli", apply=False)
                        i += 1
                        continue
                else:
                    name = body.replace("-", "_")
                    if name in OPTIONS and i + 1 < len(argv):
                        self.set_val(name, argv[i + 1], source="cli",
                                     apply=False)
                        i += 2
                        continue
            leftover.append(arg)
            i += 1
        self.apply_changes()
        return leftover

    def parse_config_file(self, path: str) -> None:
        """ceph.conf-style ini: [global] < [<type>] < [<type>.<id>]."""
        parser = configparser.ConfigParser(strict=False)
        with open(path) as f:
            parser.read_string(f.read())
        entity_type = self.entity.split(".")[0]
        sections = ["global", entity_type, self.entity]
        for section in sections:
            if not parser.has_section(section):
                continue
            for name, val in parser.items(section):
                name = name.replace(" ", "_")
                if name in OPTIONS:
                    self.set_val(name, val, source="file", apply=False)
        self.apply_changes()

    def set_mon_vals(self, values: Dict[str, Any]) -> None:
        """Centralized config pushed by the monitor (ConfigMonitor)."""
        for name, val in values.items():
            if name in OPTIONS:
                self.set_val(name, val, source="mon", apply=False)
        self.apply_changes()


_global_config: Optional[Config] = None
_global_lock = threading.Lock()


def global_config() -> Config:
    global _global_config
    with _global_lock:
        if _global_config is None:
            _global_config = Config()
        return _global_config
