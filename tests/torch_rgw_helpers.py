"""Run the JAX package's gateway tests on both packages and compare the
stores (the harness of tests/test_torch_rgw.py and tests/test_torch_s3.py).

`run_both(module, name)` calls the JAX test `module.name` twice: once as
it is, on a cluster of JAX daemons, and once with every name its test
modules take from `ceph_tpu` bound to the port's object of the same name,
on port daemons (`device="cpu"`).  Both runs go through the port harness
(tests/torch_cluster_helpers.py), which snapshots every MemStore when the
test stops its cluster; the two runs' snapshots must be equal.  So the
test's own assertions hold the port's answers, and the snapshots its
stores, to the JAX package's.

What the runs share, so that their stores can be equal:
- one clock.  The gateway names write ids, upload ids and version ids,
  and stamps every mtime, after `time.time()`; `cls.lock` stamps lock
  expiries.  Both packages' modules get one FakeClock, started at the
  same second for the two runs and ticking 1 ms a call, so the same
  calls see the same times.
- the gateway's random user keys (`os.urandom` called from the gateway
  module), drawn from one seeded stream per run.
- one stripe write in flight (`aio_window=1`): the JAX tests' gateways
  write a PUT's stripes eight at a time, and two stripes in one PG would
  take their log versions in arrival order.
"""

from __future__ import annotations

import asyncio
import importlib
import os
import random
import sys
import time as _time

import pytest

import ceph_tpu.cls.lock as jlock
import ceph_tpu.rgw.gateway as jgateway
import ceph_tpu_torch.cls.lock as tlock
import ceph_tpu_torch.rgw.gateway as tgateway

from torch_cluster_helpers import Cluster as _PortHarness
from torch_cluster_helpers import port_profile
from test_torch_osd import snapshot
from test_torch_osd_units import _port_of

KINDS = ("jax", "torch")


class FakeClock:
    """The `time` module of the gateways and cls.lock: time() ticks 1 ms
    a call from `base`; everything else is the real module's."""

    def __init__(self, base: float):
        self._t = float(base)

    def time(self) -> float:
        self._t += 0.001
        return self._t

    def time_ns(self) -> int:
        return int(round(self.time() * 1e9))

    def __getattr__(self, name):
        return getattr(_time, name)


def _seeded_urandom(seed: int):
    """os.urandom, but drawn from a seeded stream when the gateway module
    calls it (its generated user keys); every other caller is served by
    the real one."""
    real = os.urandom
    rng = random.Random(seed)
    gateways = {jgateway.__name__, tgateway.__name__}

    def urandom(n: int) -> bytes:
        if sys._getframe(1).f_globals.get("__name__") in gateways:
            return rng.randbytes(n)
        return real(n)
    return urandom


def _window_one(cls):
    class RGWLite(cls):
        def __init__(self, *args, **kw):
            kw.setdefault("aio_window", 1)
            super().__init__(*args, **kw)
    RGWLite.__qualname__ = cls.__qualname__
    return RGWLite


def harness(kind: str, snaps: list):
    """tests/cluster_helpers.Cluster's constructor and calls, on the port
    harness with daemons and client of package `kind`; `stop` first
    records every store in `snaps`."""

    class Cluster(_PortHarness):
        def __init__(self, num_osds: int = 4, osds_per_host: int = 2,
                     osd_config=None, mon_config=None, **kw):
            super().__init__(num_osds, osds_per_host,
                             kinds=[kind] * num_osds, mon_kind=kind,
                             client_kind=kind, osd_config=osd_config,
                             mon_config=mon_config, **kw)

        async def start(self) -> None:
            await super().start()
            if kind == "torch":
                create = self.client.create_ec_pool

                async def create_ec_pool(name, profile, *a, **kw):
                    return await create(name, port_profile(profile),
                                        *a, **kw)
                self.client.create_ec_pool = create_ec_pool

        async def stop(self) -> None:
            await asyncio.sleep(0.2)   # trims and late commits land
            snaps.append(snapshot(self))
            await super().stop()

    return Cluster


def bind(mp: pytest.MonkeyPatch, kind: str, modules, snaps: list,
         base: float) -> None:
    """Patch the test `modules` (and the gateways' clocks) for a run of
    package `kind`."""
    clock = FakeClock(base)
    for mod in (jgateway, tgateway, jlock, tlock):
        mp.setattr(mod, "time", clock)
    mp.setattr(os, "urandom", _seeded_urandom(0))
    for mod in modules:
        for name, value in list(vars(mod).items()):
            if kind == "torch":
                port = _port_of(name, value)
                if port is not value:
                    mp.setattr(mod, name, port)
        if kind == "torch":
            left = [n for n, v in vars(mod).items()
                    if getattr(v, "__module__", "").startswith("ceph_tpu.")
                    and callable(v)]
            assert not left, (mod.__name__, left)
        if hasattr(mod, "Cluster"):
            mp.setattr(mod, "Cluster", harness(kind, snaps))
        if hasattr(mod, "RGWLite"):
            mp.setattr(mod, "RGWLite", _window_one(getattr(mod, "RGWLite")))


def compare(snaps: dict) -> None:
    """Equal stores, OSD by OSD and collection by collection."""
    jsnaps, tsnaps = snaps["jax"], snaps["torch"]
    assert len(tsnaps) == len(jsnaps) >= 1
    for jsnap, tsnap in zip(jsnaps, tsnaps):
        assert tsnap.keys() == jsnap.keys()
        for osd_id in jsnap:
            assert tsnap[osd_id].keys() == jsnap[osd_id].keys(), osd_id
            for cid in jsnap[osd_id]:
                assert tsnap[osd_id][cid] == jsnap[osd_id][cid], \
                    (osd_id, cid)


def run_both(module, name: str, modules=()) -> None:
    """`module.name()` on a JAX and on a port cluster; equal stores.
    `modules`: the other test modules whose helpers the test calls."""
    base = float(int(_time.time()))
    snaps = {}
    for kind in KINDS:
        snaps[kind] = []
        with pytest.MonkeyPatch.context() as mp:
            bind(mp, kind, (module, *modules), snaps[kind], base)
            getattr(module, name)()
    compare(snaps)


def run_workload(workload, cluster_kw=None, timeout: float = 180) -> dict:
    """`workload(cluster, pkg)` on a JAX and on a port cluster, where
    `pkg(name)` is the package's `rgw.<name>` module; equal replies and
    equal stores.  Returns each run's replies."""
    base = float(int(_time.time()))
    snaps, replies = {}, {}
    for kind in KINDS:
        snaps[kind] = []
        root = "ceph_tpu" if kind == "jax" else "ceph_tpu_torch"

        def pkg(name, root=root):
            return importlib.import_module(f"{root}.rgw.{name}")

        with pytest.MonkeyPatch.context() as mp:
            bind(mp, kind, (), snaps[kind], base)
            cluster = harness(kind, snaps[kind])(**(cluster_kw or {}))

            async def main():
                await cluster.start()
                try:
                    return await workload(cluster, pkg)
                finally:
                    await cluster.stop()
            replies[kind] = asyncio.run(asyncio.wait_for(main(), timeout))
    assert replies["torch"] == replies["jax"]
    compare(snaps)
    return replies
