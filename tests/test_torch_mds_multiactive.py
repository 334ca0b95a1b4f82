"""The port's multi-active MDS (ceph_tpu_torch.mds: subtree-partitioned
ranks, the owner-rank rule, cross-rank renames through peer requests,
per-rank standby takeover, the top-level rmdir fence) against the JAX
package's, on the CPU.

tests/test_mds_multiactive.py case for case through
`torch_cephfs_helpers.run_both`: each JAX test body on JAX daemons and
again with its `ceph_tpu` names bound to the port's, on port daemons, its
own assertions holding the port's answers and every store equal between
the runs.  Then the lock order: the edges that the port's MDS daemons
record under the port's lockdep in one cross-rank rename run, each an
edge of the JAX package's static lock graph.
"""

import os
import time

import pytest

import test_mds_multiactive as j_multi

from torch_cephfs_helpers import bind, run_both
from torch_cluster_helpers import one_torch_thread  # noqa: F401

_CASES = [
    "test_owner_rank_rule",
    "test_two_ranks_serve_their_subtrees",
    "test_cross_rank_rename_coherent",
    "test_rank_standby_takeover",
    "test_rehoming_dir_rename_is_exdev",
    "test_cross_rank_rename_crash_recovery",
    "test_toplevel_rmdir_fences_concurrent_create",
]


@pytest.mark.parametrize("name", _CASES)
def test_jax_multiactive_tests_on_both_packages(name):
    run_both(j_multi, name)


def test_mds_lock_edges_in_the_static_graph():
    """tests/test_mds_multiactive.py's `test_cross_rank_rename_coherent`
    on port daemons under the port's lockdep: the MDS takes its
    `mds.caps` lock inside `mds.mutation` (the rename's cap recall), and
    every order edge the port's daemons record is an edge of the JAX
    package's static lock graph (ceph_tpu/analysis/lockgraph.py).  The
    port's checker keeps its own graph, so this run adds nothing to the
    one tests/test_static_analysis.py reads back."""
    import ceph_tpu
    from ceph_tpu.analysis.core import build_project
    from ceph_tpu.analysis.lockgraph import build_lock_graph
    from ceph_tpu_torch.common import lockdep as tlockdep

    was = tlockdep.enabled
    tlockdep.enabled = True
    tlockdep.reset()
    try:
        with pytest.MonkeyPatch.context() as mp:
            bind(mp, "torch", (j_multi,), [], float(int(time.time())))
            j_multi.test_cross_rank_rename_coherent()
        recorded = {(a, b) for a, bs in tlockdep._edges.items()
                    for b in bs}
    finally:
        tlockdep.enabled = was
        tlockdep.reset()
    adj, _ = build_lock_graph(build_project(
        [os.path.dirname(os.path.abspath(ceph_tpu.__file__))]))
    assert ("mds.mutation", "mds.caps") in recorded, recorded
    assert not [e for e in recorded if e[1] not in adj.get(e[0], set())], \
        recorded
