"""Monitor quorums for the port's tests: MonDaemons of either package in one
asyncio loop, and a bare-Messenger client that sends mon commands and
follows the published maps.

`MonQuorum(kinds=("torch", "jax", "jax"))` starts one mon per rank, of the
package its kind names (the JAX package's ceph_tpu or the port's
ceph_tpu_torch).  Mons of one package meet through that package's
in-process fast path where they may; a JAX mon and a port mon always meet
over TCP, since each package keeps its own local registry.
`MonClient(mon_addrs, kind)` is the mon-command half of the JAX package's
RadosClient (which needs the OSD slice): a Messenger of its own kind that
sends MMonCommand to a mon, retries on EAGAIN (an election in progress)
and on a dead mon, and subscribes to the map stream (MGetMap) with every
MOSDMapMsg collected in `maps`.
"""

from __future__ import annotations

import asyncio
import importlib
from typing import Dict, List, Optional

# the JAX package's quorum timings (tests/test_quorum.py FAST_QUORUM)
FAST_QUORUM = {
    "mon_lease": 0.8,
    "mon_election_timeout": 1.0,
    "mon_accept_timeout": 1.5,
}

PACKAGES = {"jax": "ceph_tpu", "torch": "ceph_tpu_torch"}


def pkg(kind: str, module: str):
    """`module` (dotted, below the package) of the package `kind` names."""
    return importlib.import_module(f"{PACKAGES[kind]}.{module}")


class MonQuorum:
    def __init__(self, kinds=("torch", "torch", "torch"), num_osds: int = 4,
                 osds_per_host: int = 1, config: Optional[dict] = None):
        self.kinds = list(kinds)
        self.num_osds = num_osds
        self.osds_per_host = osds_per_host
        self.config = dict(FAST_QUORUM)
        self.config.update(config or {})
        self.mons: Dict[int, object] = {}
        self.mon_addrs: List[str] = []

    def _make(self, rank: int):
        cls = pkg(self.kinds[rank], "mon").MonDaemon
        return cls(self.num_osds, osds_per_host=self.osds_per_host,
                   config=dict(self.config), rank=rank)

    async def start(self) -> None:
        for rank in range(len(self.kinds)):
            self.mons[rank] = self._make(rank)
        self.mon_addrs = [await m.start() for m in self.mons.values()]
        if len(self.kinds) > 1:
            for m in self.mons.values():
                await m.set_peers(self.mon_addrs)
        await self.wait_for_quorum()

    @property
    def leader(self):
        for m in self.mons.values():
            if m.is_leader() and m.elector is not None \
                    and not m.elector.electing:
                return m
        return None

    async def wait_for(self, cond, timeout: float, what: str) -> None:
        deadline = asyncio.get_running_loop().time() + timeout
        while not cond():
            if asyncio.get_running_loop().time() > deadline:
                raise AssertionError(what)
            await asyncio.sleep(0.05)

    async def wait_for_quorum(self, timeout: float = 15.0) -> None:
        def quorum() -> bool:
            leaders = {m.elector.leader for m in self.mons.values()
                       if m.elector is not None and not m.elector.electing}
            return len(leaders) == 1 and None not in leaders and \
                any(m.paxos is not None and m.paxos.leading
                    and m.paxos.active for m in self.mons.values())

        await self.wait_for(quorum, timeout, "mons never formed a quorum")

    async def wait_for_epoch(self, epoch: int, timeout: float = 10.0) -> None:
        await self.wait_for(
            lambda: all(m.osdmap.epoch >= epoch for m in self.mons.values()),
            timeout, f"mons never reached epoch {epoch}")

    async def kill_mon(self, rank: int) -> None:
        """Drop a mon off the network without a clean shutdown."""
        mon = self.mons.pop(rank)
        await mon.msgr.shutdown()
        for task in (mon._check_task, mon._lease_watch_task):
            if task is not None:
                task.cancel()
        if mon.elector is not None:
            mon.elector.shutdown()
        if mon.paxos is not None:
            mon.paxos.shutdown()

    async def revive_mon(self, rank: int) -> None:
        """A fresh mon at the dead rank's address; it rejoins and catches
        up through collect / OP_FULL."""
        host, port = self.mon_addrs[rank].rsplit(":", 1)
        mon = self.mons[rank] = self._make(rank)
        await mon.start(host=host, port=int(port))
        await mon.set_peers(self.mon_addrs)

    async def stop(self) -> None:
        for mon in self.mons.values():
            await mon.shutdown()
        self.mons.clear()


class MonClient:
    def __init__(self, mon_addrs: List[str], kind: str = "torch",
                 secret=None, secure: bool = False,
                 compress_methods: str = ""):
        self.kind = kind
        self.mod = pkg(kind, "msg.messages")
        self.msgr = pkg(kind, "msg").Messenger("client.admin", secret=secret)
        self.msgr.secure = secure
        if compress_methods:
            self.msgr.apply_compress_config(
                {"ms_compress_methods": compress_methods,
                 "ms_compress_min_size": 0})
        self.msgr.dispatcher = self._dispatch
        self.mon_addrs = list(mon_addrs)
        self.target = 0
        self._tid = 0
        self._futures: Dict[int, asyncio.Future] = {}
        self.maps: List[object] = []
        self.map_event = asyncio.Event()

    async def _dispatch(self, conn, msg) -> None:
        if isinstance(msg, (self.mod.MMonCommandReply,
                            self.mod.MAuthReply)):
            fut = self._futures.pop(msg.tid, None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
        elif isinstance(msg, self.mod.MOSDMapMsg):
            self.maps.append(msg)
            self.map_event.set()

    async def command(self, cmd: dict, timeout: float = 5.0,
                      attempts: int = 20):
        """-> (rc, out) from the leader (a peon forwards)."""
        last = None
        for _ in range(attempts):
            tid = self.next_tid()
            fut = asyncio.get_running_loop().create_future()
            self._futures[tid] = fut
            try:
                conn = await self.msgr.connect(self.mon_addrs[self.target])
                await conn.send(self.mod.MMonCommand(tid, cmd))
                reply = await asyncio.wait_for(fut, timeout)
            except (asyncio.TimeoutError, ConnectionError, OSError) as e:
                last = e
                self.target = (self.target + 1) % len(self.mon_addrs)
                await asyncio.sleep(0.1)
                continue
            finally:
                self._futures.pop(tid, None)
            if reply.rc == -11:
                last = reply.out
                await asyncio.sleep(0.2)
                continue
            return reply.rc, reply.out
        raise AssertionError(f"mon command {cmd!r} failed: {last!r}")

    async def request(self, msg, timeout: float = 5.0):
        """Send `msg` (which carries a tid) to the current mon and await
        the reply with that tid."""
        fut = asyncio.get_running_loop().create_future()
        self._futures[msg.tid] = fut
        try:
            conn = await self.msgr.connect(self.mon_addrs[self.target])
            await conn.send(msg)
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._futures.pop(msg.tid, None)

    def next_tid(self) -> int:
        self._tid += 1
        return self._tid

    async def subscribe(self, since_epoch: int = 0) -> None:
        conn = await self.msgr.connect(self.mon_addrs[self.target])
        await conn.send(self.mod.MGetMap(since_epoch=since_epoch,
                                         subscribe=True))

    async def shutdown(self) -> None:
        await self.msgr.shutdown()
