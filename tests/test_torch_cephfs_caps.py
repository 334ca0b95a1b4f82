"""The port's CephFS client caps and snapshots (ceph_tpu_torch.cephfs:
cap grants, recalls, buffered sizes and evictions; .snap directories,
self-managed snap contexts on the data pool, the MDS's SnapServer half)
against the JAX package's, on the CPU.

tests/test_cephfs_caps.py and tests/test_cephfs_snaps.py case for case
through `torch_cephfs_helpers.run_both`: each JAX test body on JAX
daemons and again with its `ceph_tpu` names bound to the port's, on port
daemons, its own assertions holding the port's answers (cap hits, MDS
round trips, file bytes at head and at every snapshot) and every store
equal between the runs.
"""

import pytest

import test_cephfs_caps as j_caps
import test_cephfs_snaps as j_snaps

from torch_cephfs_helpers import run_both
from torch_cluster_helpers import one_torch_thread  # noqa: F401

_CASES = [
    (j_caps, "test_cached_stat_loop_is_zero_round_trips"),
    (j_caps, "test_foreign_write_recalls_reader_cache"),
    (j_caps, "test_writer_buffered_size_flushes_on_foreign_stat"),
    (j_caps, "test_unlink_and_rename_invalidate_foreign_caches"),
    (j_caps, "test_concurrent_writers_max_merge_sizes"),
    (j_caps, "test_unresponsive_holder_is_evicted"),
    (j_caps, "test_failover_starts_capless"),
    (j_caps, "test_directory_rename_recalls_descendant_caches"),
    (j_snaps, "test_snapshot_basic_cow"),
    (j_snaps, "test_snapshot_namespace_membership"),
    (j_snaps, "test_nested_dirs_and_multiple_snaps"),
    (j_snaps, "test_rmsnap"),
    (j_snaps, "test_snap_paths_are_read_only"),
    (j_snaps, "test_capped_writer_cows_after_recall"),
    (j_snaps, "test_snapshot_captures_buffered_cap_size"),
    (j_snaps, "test_snapshots_survive_mds_failover"),
    (j_snaps, "test_crashed_mksnap_pending_row_swept_on_takeover"),
    (j_snaps, "test_root_snapshot_covers_tree"),
    (j_snaps, "test_multi_rank_snapshot_refresh"),
]


@pytest.mark.parametrize(
    "module, name", _CASES,
    ids=[f"{m.__name__}::{n}" for m, n in _CASES])
def test_jax_caps_and_snapshot_tests_on_both_packages(module, name):
    run_both(module, name)
