"""The port's cephfs CLI (ceph_tpu_torch.tools.cephfs) against the JAX
package's, on the CPU: tests/test_cli_tools.py's
`test_cephfs_cli_end_to_end` through each package's cephfs CLI as
processes against an MDS and a cluster of the same package, seeded and
clocked alike (torch_cephfs_helpers.CLI_MAIN), with equal answers and
equal stores.
"""

import asyncio
import importlib
import json
import subprocess
import sys

from torch_cephfs_helpers import CLI_MAIN, run_workload
from torch_cluster_helpers import one_torch_thread  # noqa: F401

_ENV = {"PYTHONPATH": ".", "JAX_PLATFORMS": "cpu",
        "PATH": "/usr/bin:/bin:/usr/local/bin"}
_TOOL = {"jax": "ceph_tpu.tools.cephfs", "torch": "ceph_tpu_torch.tools.cephfs"}
_MDS = {"jax": "ceph_tpu.mds", "torch": "ceph_tpu_torch.mds"}


def test_cephfs_cli_end_to_end(tmp_path):
    """tests/test_cli_tools.py's case through each package's cephfs CLI
    as processes, against an MDS and a cluster of the same package:
    mkdir, put, cat, ls, mv, snap create / ls / rm and a read at the
    snap, subvolume create / info / rm."""
    async def work(cluster, kind):
        mds_mod = importlib.import_module(_MDS[kind])
        mon = cluster.mon.addr
        await cluster.client.create_replicated_pool(
            "cephfs.meta", size=2, pg_num=4)
        await cluster.client.create_replicated_pool(
            "cephfs.data", size=2, pg_num=4)
        mds = mds_mod.MDSDaemon(mon, "cephfs.meta", "cephfs.data",
                                lock_interval=0.3)
        await mds.start()
        seeds = iter(range(100))
        outs = []

        async def cli(*args):
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-c", CLI_MAIN, str(next(seeds)),
                _TOOL[kind], "-m", mon, *args,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_ENV)
            out, err = await proc.communicate()
            outs.append([proc.returncode, out.decode()])
            return proc.returncode, out, err

        try:
            rc, _, err = await cli("mkdir", "-p", "/a/b")
            assert rc == 0, err
            src = tmp_path / f"{kind}.in.bin"
            src.write_bytes(b"cli file transfer")
            rc, _, err = await cli("put", str(src), "/a/b/f")
            assert rc == 0, err
            rc, out, err = await cli("cat", "/a/b/f")
            assert rc == 0 and out == b"cli file transfer", err
            rc, out, _ = await cli("ls", "/a/b")
            assert b"f" in out
            rc, _, err = await cli("mv", "/a/b/f", "/a/g")
            assert rc == 0, err
            rc, out, err = await cli("snap", "create", "/a", "s1")
            assert rc == 0, err
            rc, _, err = await cli("rm", "/a/g")
            assert rc == 0, err
            rc, out, _ = await cli("cat", "/a/.snap/s1/g")
            assert out == b"cli file transfer"
            rc, out, _ = await cli("snap", "ls", "/a")
            assert b"s1" in out
            rc, _, err = await cli("snap", "rm", "/a", "s1")
            assert rc == 0, err
            rc, out, err = await cli("subvolume", "create", "pvc",
                                     "--group", "csi", "--size",
                                     "1048576")
            assert rc == 0, err
            assert json.loads(out)["path"] == "/volumes/csi/pvc"
            rc, out, _ = await cli("subvolume", "info", "pvc",
                                   "--group", "csi")
            assert json.loads(out)["bytes_quota"] == 1048576
            rc, _, err = await cli("subvolume", "rm", "pvc",
                                   "--group", "csi")
            assert rc == 0, err
        finally:
            await mds.stop()
        return outs
    run_workload(work, cluster_kw={"num_osds": 2, "osd_config": {
        "osd_hit_set_period": 3600.0}}, timeout=240)
