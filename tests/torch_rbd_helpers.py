"""Run the JAX package's snapshot, striper and RBD tests on both packages
and compare the stores (the harness of tests/test_torch_snaps.py,
test_torch_striper.py and test_torch_rbd.py).

`run_both(module, name)` calls the JAX test `module.name` twice, as
tests/torch_rgw_helpers.run_both does: once on JAX daemons and a JAX
client, once with every name its module takes from `ceph_tpu` bound to
the port's object of the same name, on port daemons (`device="cpu"`).
The test's own assertions hold the port's replies and image bytes (at
head and at every snap it reads); the snapshots of every MemStore, taken
when the test stops its cluster, must be equal between the runs.

What the runs share, so that their stores can be equal:
- one clock: the `time` of both packages' `rbd`, `rbd.replay` and
  `cls.lock` modules is one FakeClock (trash stamps and deferments, lock
  expiries), started at the same second for both runs;
- the random names: `os.urandom` called from an `rbd` module (image ids)
  and `uuid.uuid4` called from an `rbd` module, the striper (lock
  cookies, header-lock cookies) or the RADOS client (its entity name,
  which lock owners and renewal stamps carry) draw from one seeded
  stream per run.
  The port's modules stay as they are; only the test pins them.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import sys
import time as _time
import uuid

import pytest

import ceph_tpu.cls.lock as jlock
import ceph_tpu.rados.client as jclient
import ceph_tpu.rados.striper as jstriper
import ceph_tpu.rbd as jrbd
import ceph_tpu.rbd.journal as jjournal
import ceph_tpu.rbd.migrate as jmigrate
import ceph_tpu.rbd.mirror as jmirror
import ceph_tpu.rbd.replay as jreplay
import ceph_tpu_torch.cls.lock as tlock
import ceph_tpu_torch.rados.client as tclient
import ceph_tpu_torch.rados.striper as tstriper
import ceph_tpu_torch.rbd as trbd
import ceph_tpu_torch.rbd.journal as tjournal
import ceph_tpu_torch.rbd.migrate as tmigrate
import ceph_tpu_torch.rbd.mirror as tmirror
import ceph_tpu_torch.rbd.replay as treplay

from torch_rgw_helpers import FakeClock, compare, harness
from test_torch_osd_units import _port_of

KINDS = ("jax", "torch")

# the modules whose random draws are pinned
_SEEDED = {m.__name__ for m in (jrbd, jjournal, jmigrate, jmirror, jreplay,
                                jstriper, jclient, trbd, tjournal,
                                tmigrate, tmirror, treplay, tstriper,
                                tclient)}


def seeded_randomness(mp: pytest.MonkeyPatch, seed: int = 0,
                      seeded=frozenset(_SEEDED)) -> None:
    """os.urandom and uuid.uuid4 from one seeded stream when a module
    named in `seeded` (by default an RBD module, the striper or the RADOS
    client) calls them; every other caller gets the real ones."""
    rng = random.Random(seed)
    real_urandom, real_uuid4 = os.urandom, uuid.uuid4

    def caller_seeded() -> bool:
        return sys._getframe(2).f_globals.get("__name__") in seeded

    def urandom(n: int) -> bytes:
        if caller_seeded():
            return rng.randbytes(n)
        return real_urandom(n)

    def uuid4() -> uuid.UUID:
        if caller_seeded():
            return uuid.UUID(bytes=rng.randbytes(16), version=4)
        return real_uuid4()

    mp.setattr(os, "urandom", urandom)
    mp.setattr(uuid, "uuid4", uuid4)


# a CLI process whose RBD, striper and RADOS-client randomness draws from
# a seeded stream: `python -c SEEDED_MAIN SEED MODULE ARGS...`
SEEDED_MAIN = """
import os, random, runpy, sys, uuid
seed, module = int(sys.argv[1]), sys.argv[2]
del sys.argv[1:3]
rng = random.Random(seed)
real_urandom, real_uuid4 = os.urandom, uuid.uuid4
roots = ("ceph_tpu.rbd", "ceph_tpu.rados", "ceph_tpu_torch.rbd",
         "ceph_tpu_torch.rados")
def seeded():
    return sys._getframe(2).f_globals.get("__name__", "").startswith(roots)
def urandom(n):
    return rng.randbytes(n) if seeded() else real_urandom(n)
def uuid4():
    if seeded():
        return uuid.UUID(bytes=rng.randbytes(16), version=4)
    return real_uuid4()
os.urandom, uuid.uuid4 = urandom, uuid4
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def bind(mp: pytest.MonkeyPatch, kind: str, modules, snaps: list,
         base: float) -> None:
    """Patch the test `modules`, the clocks and the random draws for a
    run of package `kind`."""
    clock = FakeClock(base)
    for mod in (jrbd, trbd, jreplay, treplay, jlock, tlock):
        mp.setattr(mod, "time", clock)
    seeded_randomness(mp)
    for mod in modules:
        if kind == "torch":
            for name, value in list(vars(mod).items()):
                port = _port_of(name, value)
                if port is not value:
                    mp.setattr(mod, name, port)
            left = [n for n, v in vars(mod).items()
                    if getattr(v, "__module__", "").startswith("ceph_tpu.")
                    and callable(v)]
            assert not left, (mod.__name__, left)
        if hasattr(mod, "Cluster"):
            mp.setattr(mod, "Cluster", harness(kind, snaps))


def run_both(module, name: str, *args, modules=()) -> None:
    """`module.name(*args)` on a JAX and on a port cluster; equal
    stores.  `modules`: the other test modules whose helpers it calls."""
    base = float(int(_time.time()))
    snaps = {}
    for kind in KINDS:
        snaps[kind] = []
        with pytest.MonkeyPatch.context() as mp:
            bind(mp, kind, (module, *modules), snaps[kind], base)
            getattr(module, name)(*args)
    if snaps["jax"] or snaps["torch"]:
        compare(snaps)


def in_any_order(snap: dict) -> dict:
    """A store snapshot without what the arrival order of concurrent ops
    decides: the order and versions of each PG log's entries and the
    version in each object info.  The rest (data, the other attrs, omap)
    is kept as it is."""
    out = {}
    for osd_id, colls in snap.items():
        out[osd_id] = {}
        for cid, objs in colls.items():
            out[osd_id][cid] = cobjs = {}
            for name, (data, attrs, omap) in objs.items():
                attrs, omap = dict(attrs), dict(omap)
                if "_" in attrs:
                    info = json.loads(attrs["_"])
                    info.pop("version", None)
                    attrs["_"] = info
                if "log" in omap:
                    entries = json.loads(omap["log"])
                    for e in entries:
                        e.pop("version", None)
                        e.pop("prior", None)
                    omap["log"] = sorted(json.dumps(e, sort_keys=True)
                                         for e in entries)
                cobjs[name] = (data, attrs, omap)
    return out


def run_workload(workload, cluster_kw=None, timeout: float = 180,
                 any_order: bool = False) -> dict:
    """`workload(cluster, kind)` on a JAX and on a port cluster; equal
    replies and equal stores (with `any_order`, equal but for the order
    of concurrent ops: `in_any_order`).  Returns each run's replies."""
    base = float(int(_time.time()))
    snaps, replies = {}, {}
    for kind in KINDS:
        snaps[kind] = []
        with pytest.MonkeyPatch.context() as mp:
            bind(mp, kind, (), snaps[kind], base)
            cluster = harness(kind, snaps[kind])(**(cluster_kw or {}))

            async def main():
                await cluster.start()
                try:
                    return await workload(cluster, kind)
                finally:
                    await cluster.stop()
            replies[kind] = asyncio.run(asyncio.wait_for(main(), timeout))
    assert replies["torch"] == replies["jax"]
    if any_order:
        snaps = {k: [in_any_order(s) for s in v] for k, v in snaps.items()}
    compare(snaps)
    return replies
