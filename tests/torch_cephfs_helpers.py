"""Run the JAX package's CephFS, MDS and crash/volume tests on both
packages and compare the stores (the harness of tests/test_torch_cephfs*.py
and tests/test_torch_mds*.py).

`run_both(module, name)` calls the JAX test `module.name` twice, as
tests/torch_rbd_helpers.run_both does: once on JAX daemons, a JAX client
and JAX MDS daemons, once with every name its module takes from
`ceph_tpu` bound to the port's object of the same name, on port daemons
(`device="cpu"`); the modules a test body imports itself
(`from ceph_tpu.mds import MDSError`) are the port's in that run.  The
test's own assertions hold the port's replies and
file bytes (at head and at every snapshot it reads); the snapshots of
every MemStore, taken when the test stops its cluster, must be equal
between the runs (`normalized`, below).

What the runs share, so that their stores can be equal:
- one clock: the `time` of both packages' `mds`, `cephfs` and
  `cephfs.volumes` modules is one FakeClock (inode mtimes, snapshot
  ctimes, subvolume stamps), and that of both packages' `cls.lock`
  another (lock stamps: the rank locks' renewals call it as often as
  the wall clock says, and must not move the inode times), each started
  at the same second for both runs.  Monotonic time (lock staleness,
  cap TTLs, subtree freezes) stays the real one: the daemons' progress
  rides on it;
- the random names: `os.urandom` and `uuid.uuid4` called from an `mds`,
  `cephfs` or RADOS-client module (client entity names) draw from one
  seeded stream per run.

What the wall clock decides, and `normalized` leaves out of the
comparison: an MDS renews its rank lock every `lock_interval` seconds of
real time (a `renewal` counter and its address on the lock object), and
a run that takes longer renews more often (and a renewal after a
snapshot of the metadata pool clones the lock object).  So the rank-lock
objects' `renewal`, `mds.addr` and snapset xattrs, their clones, the
PG-log entries that those renewals wrote, and the log versions they
shifted (the object infos' `version`,
every log entry's `version` and `prior`, and the PG's `last_update` /
`last_complete` info) are compared as sets without versions, as
torch_rbd_helpers.in_any_order compares concurrent ops.  Every object's
data, every other xattr and every other omap key is compared as it is.
The clusters keep every PG log entry (a trim keeps the newest entries,
and how many of those are renewals is the wall clock's) and seal no hit
set on the wall clock (`clock_free`).
The port's modules stay as they are; only the test pins them.
"""

from __future__ import annotations

import asyncio
import json
import re
import sys
import time as _time

import pytest

import ceph_tpu.cephfs as jcephfs
import ceph_tpu.cephfs.mirror as jmirror
import ceph_tpu.cephfs.volumes as jvolumes
import ceph_tpu.cls.lock as jlock
import ceph_tpu.mds as jmds
import ceph_tpu.rados.client as jclient
import ceph_tpu_torch.cephfs as tcephfs
import ceph_tpu_torch.cephfs.mirror as tmirror
import ceph_tpu_torch.cephfs.volumes as tvolumes
import ceph_tpu_torch.cls.lock as tlock
import ceph_tpu_torch.common.crash  # noqa: F401  (bound in _LOCAL_IMPORTS)
import ceph_tpu_torch.mds as tmds
import ceph_tpu_torch.rados.client as tclient

import torch_rbd_helpers
from ceph_tpu.osd.daemon import SNAP_SEP
from torch_rgw_helpers import FakeClock, harness
from test_torch_osd_units import _port_of

KINDS = ("jax", "torch")

# the modules whose random draws are pinned
_SEEDED = {m.__name__ for m in (jmds, jcephfs, jvolumes, jmirror, jclient,
                                tmds, tcephfs, tvolumes, tmirror, tclient)}

# the objects the wall clock writes: an MDS's rank locks (`mds_lock`,
# `mds_lock.<rank>`), their renewal xattrs, and the clones that a
# renewal under a metadata-pool snap context makes
_LOCK_HEAD = re.compile(r"mds_lock(\.\d+)?")
_CLOCKED_ATTRS = ("u:renewal", "u:mds.addr", "snapset")
CLOCK_FREE = {"osd_min_pg_log_entries": 1 << 20,
              "osd_hit_set_period": 3600.0}

# the JAX modules a test imports inside its body: bound to the port's for
# the port run (a body's own `from ceph_tpu.mds import MDSError`)
_LOCAL_IMPORTS = ("mds", "cephfs", "cephfs.volumes", "cephfs.mirror",
                  "msg.messages", "rados.client", "common.crash")


def seeded_randomness(mp: pytest.MonkeyPatch, seed: int = 0) -> None:
    """os.urandom and uuid.uuid4 from one seeded stream when an MDS,
    CephFS or RADOS-client module calls them; every other caller gets
    the real ones."""
    torch_rbd_helpers.seeded_randomness(mp, seed, _SEEDED)


# a cephfs CLI process whose RADOS-client, CephFS and MDS randomness
# draws from a seeded stream and whose CephFS clock is a FakeClock from a
# fixed second: `python -c CLI_MAIN SEED MODULE ARGS...`
CLI_MAIN = """
import importlib, os, random, runpy, sys, time, uuid
seed, module = int(sys.argv[1]), sys.argv[2]
del sys.argv[1:3]
root = module.split(".")[0]
rng = random.Random(seed)
real_urandom, real_uuid4 = os.urandom, uuid.uuid4
roots = tuple(f"{root}.{m}" for m in ("rados", "cephfs", "mds"))
def seeded():
    return sys._getframe(2).f_globals.get("__name__", "").startswith(roots)
def urandom(n):
    return rng.randbytes(n) if seeded() else real_urandom(n)
def uuid4():
    if seeded():
        return uuid.UUID(bytes=rng.randbytes(16), version=4)
    return real_uuid4()
os.urandom, uuid.uuid4 = urandom, uuid4
class FakeClock:
    def __init__(self, base):
        self._t = float(base)
    def time(self):
        self._t += 0.001
        return self._t
    def __getattr__(self, name):
        return getattr(time, name)
clock = FakeClock(1.7e9 + seed)
for name in ("cephfs", "cephfs.volumes", "mds"):
    importlib.import_module(f"{root}.{name}").time = clock
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def _clocked(name: str) -> bool:
    """A rank-lock object or one of its clones, by its name."""
    return _LOCK_HEAD.fullmatch(name.split(SNAP_SEP)[0]) is not None


def normalized(snap: dict) -> dict:
    """A store snapshot without what the wall clock decides (see the
    module docstring)."""
    out = {}
    for osd_id, colls in snap.items():
        out[osd_id] = {}
        for cid, objs in colls.items():
            out[osd_id][cid] = cobjs = {}
            for name, (data, attrs, omap) in objs.items():
                attrs, omap = dict(attrs), dict(omap)
                if _clocked(name) and SNAP_SEP in name:
                    continue
                if _clocked(name):
                    for key in _CLOCKED_ATTRS:
                        attrs.pop(key, None)
                if "_" in attrs:
                    try:
                        info = json.loads(attrs["_"])
                    except ValueError:
                        info = None
                    if isinstance(info, dict):
                        info.pop("version", None)
                        info.pop("prior_version", None)
                        attrs["_"] = info
                if "log" in omap:
                    entries = [e for e in json.loads(omap["log"])
                               if not _clocked(str(e.get("oid", "")))]
                    for e in entries:
                        e.pop("version", None)
                        e.pop("prior", None)
                    omap["log"] = sorted(json.dumps(e, sort_keys=True)
                                         for e in entries)
                if "info" in omap:
                    try:
                        info = json.loads(omap["info"])
                    except ValueError:
                        info = None
                    if isinstance(info, dict):
                        for key in ("last_update", "last_complete",
                                    "log_tail"):
                            info.pop(key, None)
                        omap["info"] = info
                cobjs[name] = (data, attrs, omap)
    return out


def compare(snaps: dict) -> None:
    """Equal stores, OSD by OSD and collection by collection, but for
    what the wall clock decides."""
    jsnaps, tsnaps = snaps["jax"], snaps["torch"]
    assert len(tsnaps) == len(jsnaps) >= 1
    for jsnap, tsnap in zip(jsnaps, tsnaps):
        jsnap, tsnap = normalized(jsnap), normalized(tsnap)
        assert tsnap.keys() == jsnap.keys()
        for osd_id in jsnap:
            assert tsnap[osd_id].keys() == jsnap[osd_id].keys(), osd_id
            for cid in jsnap[osd_id]:
                tobjs, jobjs = tsnap[osd_id][cid], jsnap[osd_id][cid]
                assert tobjs.keys() == jobjs.keys(), (osd_id, cid)
                for name in jobjs:
                    assert tobjs[name] == jobjs[name], (osd_id, cid, name)


def clock_free(cls):
    """The harness Cluster `cls` with no PG log trimmed (a trim keeps
    the newest entries, and how many of those are lock renewals is the
    wall clock's) and no hit set sealed on the wall clock."""
    class Cluster(cls):
        def __init__(self, *args, osd_config=None, **kw):
            super().__init__(*args, osd_config={**CLOCK_FREE,
                                                **(osd_config or {})},
                             **kw)
    return Cluster


def bind(mp: pytest.MonkeyPatch, kind: str, modules, snaps: list,
         base: float) -> None:
    """Patch the test `modules`, the clocks and the random draws for a
    run of package `kind`."""
    clock, lock_clock = FakeClock(base), FakeClock(base)
    for mod in (jmds, tmds, jcephfs, tcephfs, jvolumes, tvolumes):
        mp.setattr(mod, "time", clock)
    for mod in (jlock, tlock):
        mp.setattr(mod, "time", lock_clock)
    seeded_randomness(mp)
    if kind == "torch":
        for name in _LOCAL_IMPORTS:
            mp.setitem(sys.modules, f"ceph_tpu.{name}",
                       sys.modules[f"ceph_tpu_torch.{name}"])
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
            mp.setattr(mod, "Cluster", clock_free(harness(kind, snaps)))


def run_both(module, name: str, *args, modules=(), kinds=KINDS) -> None:
    """`module.name(*args)` on a JAX and on a port cluster; equal
    stores.  `modules`: the other test modules whose helpers it calls."""
    base = float(int(_time.time()))
    snaps = {}
    for kind in kinds:
        snaps[kind] = []
        with pytest.MonkeyPatch.context() as mp:
            bind(mp, kind, (module, *modules), snaps[kind], base)
            getattr(module, name)(*args)
    if snaps["jax"] or snaps["torch"]:
        compare(snaps)


def run_workload(workload, cluster_kw=None, timeout: float = 180) -> dict:
    """`workload(cluster, kind)` on a JAX and on a port cluster; equal
    replies and equal stores.  Returns each run's replies."""
    base = float(int(_time.time()))
    snaps, replies = {}, {}
    for kind in KINDS:
        snaps[kind] = []
        with pytest.MonkeyPatch.context() as mp:
            bind(mp, kind, (), snaps[kind], base)
            cluster = clock_free(harness(kind, snaps[kind]))(
                **(cluster_kw or {}))

            async def main():
                await cluster.start()
                try:
                    return await workload(cluster, kind)
                finally:
                    await cluster.stop()
            replies[kind] = asyncio.run(asyncio.wait_for(main(), timeout))
    assert replies["torch"] == replies["jax"]
    compare(snaps)
    return replies
