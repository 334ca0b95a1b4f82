"""The port's RadosStriper (ceph_tpu_torch.rados.striper) against the JAX
package's, on the CPU: tests/test_striper.py case for case through
`torch_rbd_helpers.run_both` (the extent walk against its brute-force
oracle; striped objects round-tripped over an EC pool of port OSDs, every
store equal to the JAX cluster's)."""

import pytest

import test_striper as j_striper

from torch_cluster_helpers import one_torch_thread  # noqa: F401
from torch_rbd_helpers import run_both


@pytest.mark.parametrize("name", [
    "test_extent_walk_matches_brute_force",
    "test_striper_round_trip_ec_pool",
])
def test_jax_striper_tests_on_both_packages(name):
    run_both(j_striper, name)
