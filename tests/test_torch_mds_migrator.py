"""The port's subtree migrator (ceph_tpu_torch.mds: `_export_subtree`,
the export intent and its re-drive on takeover, the importer's fencing)
against the JAX package's, on the CPU.

tests/test_mds_migrator.py case for case through
`torch_cephfs_helpers.run_both`: each JAX test body on JAX daemons and
again with its `ceph_tpu` names bound to the port's, on port daemons, its
own assertions holding the port's answers and every store equal between
the runs.
"""

import pytest

import test_mds_migrator as j_migrator

from torch_cephfs_helpers import run_both
from torch_cluster_helpers import one_torch_thread  # noqa: F401

_CASES = [
    "test_rehoming_rename_migrates_subtree",
    "test_rehoming_deep_paths_and_purge",
    "test_snapshotted_subtree_refuses_migration",
    "test_export_intent_redriven_after_coordinator_crash",
    "test_other_subtrees_keep_serving",
]


@pytest.mark.parametrize("name", _CASES)
def test_jax_migrator_tests_on_both_packages(name):
    run_both(j_migrator, name)
