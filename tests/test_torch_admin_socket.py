"""The port's admin socket (ceph_tpu_torch.common.admin_socket, and the
OSD's `admin_socket` option that starts it) against the JAX package's, on
the CPU.

tests/test_common.py's admin socket cases on the port's AdminSocket,
Config and perf counters; tests/test_scrub_optracker.py's
`test_admin_socket_dump_ops` through `torch_cephfs_helpers.run_both` on
both packages' clusters (equal stores); and port OSDs booted with
`admin_socket` set, each serving `version`, `perf dump`,
`dump_ops_in_flight`, `dump_historic_ops` and `help` on its own socket
from boot, and removing it at `stop`.
"""

import asyncio
import os

import pytest

import test_common as j_common
import test_scrub_optracker as j_scrub

from test_torch_osd_units import call, on_port
from torch_cephfs_helpers import run_both
from torch_cluster_helpers import Cluster, one_torch_thread  # noqa: F401

_ADMIN_CASES = [
    "test_admin_socket_version",
    "test_admin_socket_perf_dump",
    "test_admin_socket_config_get_set",
    "test_admin_socket_help_and_unknown",
    "test_admin_socket_custom_command",
    "test_admin_socket_perf_dump_filter",
]


@pytest.fixture
def port_admin(tmp_path):
    """tests/test_common.py's `admin` fixture on the port's classes."""
    from ceph_tpu_torch.common import admin_socket as asok
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.common.perf_counters import (
        PerfCounters, PerfCountersCollection)

    coll = PerfCountersCollection()
    pc = PerfCounters("osd")
    pc.add_u64_counter("ops")
    pc.inc("ops", 7)
    coll.add(pc)
    sock = asok.AdminSocket(str(tmp_path / "asok"), config=Config(),
                            perf=coll, version="16.0.0-tpu")
    sock.init()
    yield sock
    sock.shutdown()


@pytest.mark.parametrize("name", _ADMIN_CASES)
def test_admin_socket_on_the_port(name, port_admin):
    call(on_port(j_common, name), admin=port_admin)


def test_admin_socket_dump_ops(tmp_path):
    run_both(j_scrub, "test_admin_socket_dump_ops", tmp_path)


def test_osd_admin_socket_option(tmp_path):
    """Each port OSD given `admin_socket` serves its admin commands on
    it from boot (`version`, `perf dump`, `dump_ops_in_flight`,
    `dump_historic_ops`), and `stop` removes the socket."""
    from ceph_tpu_torch.common.admin_socket import admin_socket_request

    class AsokCluster(Cluster):
        async def _boot_osd(self, osd_id: int) -> None:
            paths[osd_id] = str(tmp_path / f"osd.{osd_id}.asok")
            self.osd_config["admin_socket"] = paths[osd_id]
            await super()._boot_osd(osd_id)

    paths = {}

    async def main():
        cluster = AsokCluster(num_osds=3)
        await cluster.start()
        try:
            await cluster.client.create_replicated_pool("p", size=3,
                                                        pg_num=8)
            io = cluster.client.open_ioctx("p")
            await io.write_full("obj", b"x" * 4096)
            await io.read("obj")
            for osd_id, path in paths.items():
                out = await asyncio.to_thread(admin_socket_request, path,
                                              "version")
                assert out == {"version": f"ceph_tpu osd.{osd_id}"}
                perf = await asyncio.to_thread(
                    admin_socket_request, path, {"prefix": "perf dump"})
                assert perf == await asyncio.to_thread(
                    admin_socket_request, path, "perf dump")
                assert isinstance(perf, dict) and perf, perf
                ops = await asyncio.to_thread(
                    admin_socket_request, path,
                    {"prefix": "dump_ops_in_flight"})
                assert ops["num_ops"] == 0, ops
                help_ = await asyncio.to_thread(admin_socket_request,
                                                path, "help")
                assert "dump_historic_ops" in help_
            hist = [await asyncio.to_thread(
                admin_socket_request, p, "dump_historic_ops")
                for p in paths.values()]
            assert any("obj" in o["description"]
                       for h in hist for o in h["ops"]), hist
        finally:
            await cluster.stop()
        for path in paths.values():
            assert not os.path.exists(path)
    asyncio.run(asyncio.wait_for(main(), 120))
