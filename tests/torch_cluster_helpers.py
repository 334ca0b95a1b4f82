"""In-loop cluster harness for the port's tests (the role of
tests/cluster_helpers.py): one mon and N OSD daemons on loopback inside one
asyncio loop, with a RadosClient.

`kinds` names each OSD's package ("torch" for ceph_tpu_torch, "jax" for the
JAX package ceph_tpu), so one cluster can hold OSDs of both; `mon_kind` and
`client_kind` pick the mons' and the client's package the same way.  Port
OSDs, and a port client's read-then-compute legs, run on the CPU.  With `num_mons` > 1 the mons form a quorum
(kill_mon drops one off the network); `client_secret` and
`client_secure` key the client as the JAX harness does (the daemons take
theirs in `osd_config` / `mon_config`).  kill_osd drops a daemon off the
network without a clean shutdown; revive_osd boots a fresh daemon of
either package on the MemStore that survived it (tests/cluster_helpers.py's
MemStore contract); mark_down, mark_out, mark_in and mark_lost are the
mon's `osd down|out|in|lost` commands.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Sequence

import pytest
import torch

from torch_mon_helpers import pkg

# tests/cluster_helpers.py's timings, but a heartbeat grace no stall of a
# loaded test host reaches: an OSD marked down by mistake would change the
# map epochs, and with them the versions a JAX and a port run must share.
# Tests kill an OSD and mark it down through the mon (mark_down).
FAST_CONFIG = {
    "osd_heartbeat_interval": 0.3,
    "osd_heartbeat_grace": 60.0,
    "osd_sub_op_timeout": 8.0,
}
FAST_MON_CONFIG = {
    "mon_osd_min_down_reporters": 1,
    "osd_heartbeat_grace": 60.0,
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Import into a test module to run it with one intra-op thread: the
    daemons' CPU codec works on small buffers, which one thread does as
    fast, and a pool's threads spinning after each call would load every
    other test sharing the host."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class Cluster:
    def __init__(self, num_osds: int = 4, osds_per_host: int = 2,
                 kinds: Optional[Sequence[str]] = None,
                 mon_kind: str = "torch", client_kind: str = "torch",
                 osd_config: Optional[dict] = None,
                 mon_config: Optional[dict] = None,
                 num_mons: int = 1,
                 client_secret: Optional[str] = None,
                 client_secure: bool = False):
        self.num_osds = num_osds
        self.osds_per_host = osds_per_host
        self.kinds = list(kinds) if kinds is not None \
            else ["torch"] * num_osds
        assert len(self.kinds) == num_osds
        self.mon_kind = mon_kind
        self.client_kind = client_kind
        self.osd_config = dict(FAST_CONFIG)
        self.osd_config.update(osd_config or {})
        self.mon_config = dict(FAST_MON_CONFIG)
        self.mon_config.update(mon_config or {})
        self.num_mons = num_mons
        self.client_secret = client_secret
        self.client_secure = client_secure
        self.mons: Dict[int, object] = {}
        self.mon_addrs: List[str] = []
        self.osds: Dict[int, object] = {}
        self.stores: Dict[int, object] = {}
        self.client = None

    @property
    def mon(self):
        """The quorum's leader (any live mon while there is none)."""
        live = list(self.mons.values())
        for m in live:
            if m.is_leader():
                return m
        return live[0] if live else None

    async def start(self) -> None:
        for rank in range(self.num_mons):
            self.mons[rank] = pkg(self.mon_kind, "mon").MonDaemon(
                self.num_osds, osds_per_host=self.osds_per_host,
                config=dict(self.mon_config), rank=rank)
        self.mon_addrs = [await m.start() for m in self.mons.values()]
        if self.num_mons > 1:
            for m in self.mons.values():
                await m.set_peers(self.mon_addrs)
            await self.wait_for_quorum()
        for osd_id, kind in enumerate(self.kinds):
            store = pkg(kind, "os.memstore").MemStore()
            store.mkfs()
            store.mount()
            self.stores[osd_id] = store
            await self._boot_osd(osd_id)
        self.client = self.new_client(self.client_kind)
        await self.client.connect()

    async def _boot_osd(self, osd_id: int) -> None:
        kind = self.kinds[osd_id]
        cls = pkg(kind, "osd.daemon").OSDDaemon
        extra = {"device": "cpu"} if kind == "torch" else {}
        osd = cls(osd_id, self.mon_addrs, store=self.stores[osd_id],
                  config=dict(self.osd_config), **extra)
        self.osds[osd_id] = osd
        await osd.start()

    def new_client(self, kind: str, **kw):
        """An unconnected RadosClient of package `kind` on these mons
        (keyed like the harness's client unless `kw` says otherwise)."""
        kw.setdefault("secret", self.client_secret)
        kw.setdefault("secure", self.client_secure)
        if kind == "torch":
            # the kill-switch legs' kernels run on the CPU here
            kw.setdefault("device", "cpu")
        return pkg(kind, "rados.client").RadosClient(self.mon_addrs, **kw)

    async def stop(self) -> None:
        if self.client is not None:
            await self.client.shutdown()
        for osd in self.osds.values():
            await osd.stop()
        for store in self.stores.values():
            try:
                store.umount()
            except Exception:
                pass
        for mon in self.mons.values():
            await mon.shutdown()

    async def wait_for_quorum(self, timeout: float = 15.0) -> None:
        def _quorum() -> bool:
            leaders = {m.elector.leader for m in self.mons.values()
                       if m.elector is not None
                       and not m.elector.electing}
            return len(leaders) == 1 and None not in leaders

        await self._wait(_quorum, timeout, "mons never formed a quorum")

    async def kill_mon(self, rank: int) -> None:
        """Drop a mon off the network without a clean shutdown."""
        mon = self.mons.pop(rank)
        await mon.msgr.shutdown()
        if mon._check_task is not None:
            mon._check_task.cancel()
        if mon._lease_watch_task is not None:
            mon._lease_watch_task.cancel()
        if mon.elector is not None:
            mon.elector.shutdown()
        if mon.paxos is not None:
            mon.paxos.shutdown()

    async def kill_osd(self, osd_id: int) -> None:
        """Crash an OSD: it drops off the network without a clean
        shutdown (its MemStore stays readable in `stores`)."""
        await self.osds.pop(osd_id).kill()

    async def revive_osd(self, osd_id: int,
                         kind: Optional[str] = None) -> None:
        """Boot a fresh daemon at the dead rank on the MemStore that
        survived the kill (nothing was lost: no remount).  `kind` picks
        the new daemon's package (default: the dead one's)."""
        assert osd_id not in self.osds
        if kind is not None:
            self.kinds[osd_id] = kind
        await self._boot_osd(osd_id)

    async def _osd_command(self, prefix: str, osd_id: int, **extra):
        rc, out = await self.client.mon_command(
            {"prefix": prefix, "osd": osd_id, **extra})
        assert rc == 0, (prefix, osd_id, out)

    async def mark_down(self, osd_id: int) -> None:
        """Tell the mon the OSD is down (no heartbeat grace to wait)."""
        await self._osd_command("osd down", osd_id)

    async def mark_out(self, osd_id: int) -> None:
        await self._osd_command("osd out", osd_id)

    async def mark_in(self, osd_id: int) -> None:
        await self._osd_command("osd in", osd_id)

    async def mark_lost(self, osd_id: int) -> None:
        await self._osd_command("osd lost", osd_id,
                                yes_i_really_mean_it=True)

    async def wait_for_osd_down(self, osd_id: int,
                                timeout: float = 30.0) -> None:
        await self._wait(lambda: self.mon.osdmap.is_down(osd_id),
                         timeout, f"osd.{osd_id} never marked down")

    async def wait_for_osd_up(self, osd_id: int,
                              timeout: float = 30.0) -> None:
        await self._wait(lambda: self.mon.osdmap.is_up(osd_id),
                         timeout, f"osd.{osd_id} never marked up")

    async def wait_for_clean(self, timeout: float = 30.0) -> None:
        """Every PG of every pool active on its primary, every live
        daemon at the mon's epoch."""
        def _clean() -> bool:
            epoch = self.mon.osdmap.epoch
            for osd in self.osds.values():
                if osd.osdmap is None or osd.osdmap.epoch < epoch:
                    return False
            for pool in self.mon.osdmap.pools.values():
                for ps in range(pool.pg_num):
                    pg = pkg(self.mon_kind, "osd.osdmap").PgId(pool.id, ps)
                    _a, primary = self.mon.osdmap.pg_to_acting_osds(pg)
                    if primary < 0 or primary not in self.osds:
                        return False
                    # the primary's own package's PgId keys its pgs
                    key = pkg(self.kinds[primary], "osd.osdmap").PgId(
                        pool.id, ps)
                    state = self.osds[primary].pgs.get(key)
                    if state is None or state.state != "active" or \
                            state.unfound:
                        return False
            return True

        await self._wait(_clean, timeout, "cluster never went clean")

    async def _wait(self, cond, timeout: float, what: str) -> None:
        for _ in range(int(timeout / 0.05)):
            if cond():
                return
            await asyncio.sleep(0.05)
        raise TimeoutError(what)
