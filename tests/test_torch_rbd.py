"""The port's RBD (ceph_tpu_torch.rbd: images, striped I/O, the EC data
pool, exclusive lock, snapshots, layering and copy-up, object map, trash;
rbd.journal, rbd.mirror, rbd.migrate, rbd.replay) against the JAX
package's, on the CPU.

tests/test_rbd.py, test_rbd_layering.py, test_rbd_journal.py,
test_rbd_trash_replay.py and test_rbd_migrate.py case for case through
`torch_rbd_helpers.run_both`: each JAX test body on JAX daemons and again
with its `ceph_tpu` names bound to the port's, on port daemons, its own
assertions holding the image bytes at head and at every snap it reads, and
every store equal between the runs (image ids, cookies and client names
from one seeded stream, one fake clock for trash and lock stamps).  The
one case that runs the CLI as processes, `test_bench_trace_then_replay_cli`,
runs here as `python -m ceph_tpu.tools.rbd` against the JAX cluster and
`python -m ceph_tpu_torch.tools.rbd` against the port's, each process's
randomness seeded (torch_rbd_helpers.SEEDED_MAIN), with equal answers and
equal stores.
"""

import asyncio
import json
import subprocess
import sys

import pytest

import test_rbd as j_rbd
import test_rbd_journal as j_journal
import test_rbd_layering as j_layering
import test_rbd_migrate as j_migrate
import test_rbd_trash_replay as j_trash

from torch_cluster_helpers import one_torch_thread  # noqa: F401
from torch_rbd_helpers import SEEDED_MAIN, run_both, run_workload

_CASES = [
    (j_rbd, "test_create_list_stat_remove"),
    (j_rbd, "test_striped_io_round_trip"),
    (j_rbd, "test_discard_and_resize"),
    (j_rbd, "test_snapshots_preserve_and_rollback"),
    (j_rbd, "test_image_on_ec_data_pool"),
    (j_rbd, "test_exclusive_lock_single_writer"),
    (j_layering, "test_clone_requires_protected_snap"),
    (j_layering, "test_clone_cow_and_flatten"),
    (j_layering, "test_clone_shrink_clamps_overlap"),
    (j_layering, "test_random_ops_vs_flat_oracle"),
    (j_layering, "test_interrupted_copyup_retries_converge"),
    (j_layering, "test_object_map_tracks_and_accelerates"),
    (j_journal, "test_event_codec_and_torn_tail"),
    (j_journal, "test_commit_position_is_contiguous"),
    (j_journal, "test_crash_replay_applies_unapplied_events"),
    (j_journal, "test_mirror_bootstrap_and_tail"),
    (j_trash, "test_trash_mv_restore_cycle"),
    (j_trash, "test_trash_rm_deferment_and_purge"),
    (j_trash, "test_trash_rm_snapshotted_image"),
    (j_trash, "test_record_and_replay_workload"),
    (j_migrate, "test_deep_copy_with_snapshot_history"),
    (j_migrate, "test_deep_copy_across_clusters"),
    (j_migrate, "test_migration_lifecycle"),
    (j_migrate, "test_migration_abort"),
    (j_migrate, "test_migration_refuses_snapshotted_source"),
]


@pytest.mark.parametrize(
    "module, name", _CASES,
    ids=[f"{m.__name__}::{n}" for m, n in _CASES])
def test_jax_rbd_tests_on_both_packages(module, name):
    run_both(module, name)


_ENV = {"PYTHONPATH": ".", "JAX_PLATFORMS": "cpu",
        "PATH": "/usr/bin:/bin:/usr/local/bin"}
_TOOL = {"jax": "ceph_tpu.tools.rbd", "torch": "ceph_tpu_torch.tools.rbd"}


def test_bench_trace_then_replay_cli(tmp_path):
    """tests/test_rbd_trash_replay.py's case through each package's rbd
    CLI as processes: an image created, a 4 KiB bench recorded as a
    trace, a second image created and the trace replayed onto it."""
    async def work(cluster, kind):
        await cluster.client.create_replicated_pool("rbd", size=2,
                                                    pg_num=8)
        await cluster.wait_for_clean()
        mon = cluster.mon.addr
        seeds = iter(range(100))

        async def cli(*args):
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-c", SEEDED_MAIN, str(next(seeds)),
                _TOOL[kind], "-m", mon, "-p", "rbd", *args,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_ENV)
            out, err = await proc.communicate()
            assert proc.returncode == 0, err
            return out

        trace = tmp_path / f"{kind}.jsonl"
        await cli("create", "b1", "--size", "256K", "--order", "14")
        bench = json.loads(await cli(
            "bench", "b1", "--io-type", "write", "--io-size", "4K",
            "--io-total", "32K", "--io-threads", "1", "--trace",
            str(trace)))
        lines = trace.read_text().splitlines()
        assert len(lines) == 8
        await cli("create", "b2", "--size", "256K", "--order", "14")
        stats = json.loads(await cli("replay", str(trace), "b2",
                                     "--speed", "0"))
        assert stats["writes"] == 8
        return [bench["ops"], bench["writes"],
                [json.loads(line)["offset"] for line in lines],
                stats["writes"], (await cli("ls")).split()]
    run_workload(work, cluster_kw={"num_osds": 3}, timeout=240)
