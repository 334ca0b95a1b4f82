"""The port's CephFS client and MDS (ceph_tpu_torch.cephfs, .mds), crash
reports (ceph_tpu_torch.common.crash) and subvolumes
(ceph_tpu_torch.cephfs.volumes) against the JAX package's, on the CPU.

tests/test_cephfs.py and tests/test_crash_volumes.py case for case
through `torch_cephfs_helpers.run_both`: each JAX test body on JAX
daemons and again with its `ceph_tpu` names bound to the port's, on port
daemons, its own assertions holding the port's answers and file bytes,
and every store equal between the runs.  The one case that starts an OSD
process, `test_osd_boot_crash_posts_report`, starts `python -m
ceph_tpu_torch.osd` against a port cluster.
"""

import asyncio
import subprocess
import sys

import pytest

import test_cephfs as j_cephfs
import test_crash_volumes as j_crash

from torch_cephfs_helpers import run_both
from torch_cluster_helpers import Cluster, one_torch_thread  # noqa: F401

_CASES = [
    (j_cephfs, "test_namespace_round_trip"),
    (j_cephfs, "test_large_file_striping_and_truncate"),
    (j_cephfs, "test_rename_and_symlink"),
    (j_cephfs, "test_metadata_survives_mds_restart"),
    (j_cephfs, "test_standby_mds_takes_over"),
    (j_cephfs, "test_rename_crash_atomicity"),
    (j_cephfs, "test_deposed_active_is_fenced"),
    (j_crash, "test_crash_post_ls_health_archive"),
    (j_crash, "test_crash_report_shape"),
    (j_crash, "test_volumes_lifecycle"),
]


@pytest.mark.parametrize(
    "module, name", _CASES,
    ids=[f"{m.__name__}::{n}" for m, n in _CASES])
def test_jax_cephfs_tests_on_both_packages(module, name):
    run_both(module, name)


_ENV = {"PYTHONPATH": ".", "JAX_PLATFORMS": "cpu",
        "PATH": "/usr/bin:/bin:/usr/local/bin"}


def test_osd_boot_crash_posts_report(tmp_path):
    """tests/test_crash_volumes.py's case on the port: a port OSD process
    whose boot dies (its store path is a file) posts a crash report that
    the port mons list."""
    async def main():
        cluster = Cluster(num_osds=1)
        await cluster.start()
        try:
            bad_store = tmp_path / "notadir"
            bad_store.write_bytes(b"i am a file, not a store dir")
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "ceph_tpu_torch.osd",
                "--id", "9", "--mon", cluster.mon.addr, "--device", "cpu",
                "--store-path", str(bad_store),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_ENV)
            await asyncio.wait_for(proc.communicate(), 60)
            assert proc.returncode != 0
            rc, out = await cluster.client.mon_command(
                {"prefix": "crash ls"})
            assert rc == 0
            assert any(c["entity"] == "osd.9"
                       for c in out["crashes"]), out
        finally:
            await cluster.stop()
    asyncio.run(asyncio.wait_for(main(), 150))
