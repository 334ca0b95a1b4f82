"""The port's cephfs-mirror (ceph_tpu_torch.cephfs.mirror.DirMirror over
ceph_tpu_torch.common.periodic) against the JAX package's, on the CPU.

tests/test_cephfs_mirror.py case for case through
`torch_cephfs_helpers.run_both`: each JAX test body on two JAX clusters
and again with its `ceph_tpu` names bound to the port's, on two port
clusters, its own assertions holding the port's mirrored trees and
snapshots (and its copy counters), and every store of both clusters
equal between the runs.
"""

import pytest

import test_cephfs_mirror as j_mirror

from torch_cephfs_helpers import run_both
from torch_cluster_helpers import one_torch_thread  # noqa: F401

_CASES = [
    "test_bootstrap_and_incremental_sync",
    "test_snapshot_deletion_propagates",
    "test_type_change_and_dir_replacement",
    "test_recreated_same_name_snapshot_resyncs",
    "test_continuous_mode_tails_snapshots",
]


@pytest.mark.parametrize("name", _CASES)
def test_jax_mirror_tests_on_both_packages(name):
    run_both(j_mirror, name)
