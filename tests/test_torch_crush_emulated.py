"""The placement kernel's own code (ceph_tpu_torch/csrc/crush.cu) run on
the CPU by ceph_tpu_torch/tools/crush_emulate.py (g++, 32 threads per
warp, barriers for the warp collectives), held bit for bit against the
kernel's plain version: the work counter's refill, the lane steps of both
rule kinds, leaf retries as steps of their own, the tail's regroup and the
group reduction.  The plain version is tied to the JAX package and the
host mapper by tests/test_torch_crush.py; placements are integers, so the
tolerance is exact equality.
"""

import shutil

import numpy as np
import pytest
import torch

from ceph_tpu_torch.crush import kernel as ck
from ceph_tpu_torch.crush.map import build_flat_cluster
from ceph_tpu_torch.tools import crush_emulate
from ceph_tpu_torch.tools import kernel_shapes as ks

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def emulator():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's host emulation")
    return crush_emulate.build()


@pytest.fixture(scope="module")
def map_10k():
    cmap = ks.crush_map_10k()
    return cmap, {name: ck.DenseMap.from_crush_map(cmap, w, CPU)
                  for name, w in ks.crush_weights(cmap).items()}


def _plain(dm, prog, xs):
    return ck.crush_do_rule_batch_plain(
        dm, prog, torch.from_numpy(np.asarray(xs, dtype=np.int32))).numpy()


@pytest.mark.parametrize("warps", [1, 8])
@pytest.mark.parametrize("weights", ["all in", "rebalance"])
@pytest.mark.parametrize("rule", ks.CRUSH_RULES, ids=lambda r: r[0])
def test_emulated_kernel_matches_plain_on_the_10k_map(
        emulator, map_10k, rule, weights, warps):
    """One warp refills its lanes from the counter eight times over; eight
    warps take all 256 inputs at once and spend the launch in the tail's
    regroup."""
    cmap, dms = map_10k
    _, ruleno, rmax = rule
    prog = ck.rule_program(cmap, ruleno, rmax)
    xs = np.arange(256) * 40503
    got = crush_emulate.emulate(dms[weights], prog, xs, warps=warps)
    assert np.array_equal(got, _plain(dms[weights], prog, xs))


@pytest.mark.parametrize("n", [1, 31, 33, 65])
def test_emulated_kernel_matches_plain_on_odd_counts(emulator, map_10k, n):
    """Fewer inputs than lanes, one lane past a warp: the warps regroup
    from their second step on."""
    cmap, dms = map_10k
    xs = np.arange(n) * 7919
    for ruleno, rmax in ((0, 3), (1, 11)):
        prog = ck.rule_program(cmap, ruleno, rmax)
        got = crush_emulate.emulate(dms["rebalance"], prog, xs, warps=3)
        assert np.array_equal(got, _plain(dms["rebalance"], prog, xs))


@pytest.mark.parametrize("seed", range(24))
def test_emulated_kernel_matches_plain_on_random_hierarchies(emulator, seed):
    """chip_smoke.py's random hierarchies: firstn and indep, leaf and not,
    the chooseleaf tunables in turns, numrep other than result_max."""
    k = seed // 4
    rmax = 1 + (5 * seed) % 12
    cmap, weight, _ = ks.random_crush_case(
        ks.SEED + seed, levels=2 + k % 3, firstn=seed % 2 == 0,
        leaf=seed % 4 < 2, result_max=rmax)
    cmap.chooseleaf_stable = k % 2
    cmap.chooseleaf_vary_r = k % 4
    cmap.chooseleaf_descend_once = k // 2 % 2
    prog = ck.rule_program(cmap, 0, rmax)
    dm = ck.DenseMap.from_crush_map(cmap, weight, CPU)
    xs = np.random.default_rng(seed).integers(0, 2**31, 200)
    got = crush_emulate.emulate(dm, prog, xs, warps=1 + seed % 3)
    assert np.array_equal(got, _plain(dm, prog, xs))


def test_emulated_kernel_matches_plain_with_weights_per_item(emulator):
    """A distinct reciprocal for almost every item, weights from 1 up."""
    per_osd = np.random.default_rng(7).integers(1, 0x40000, 96)
    cmap = build_flat_cluster(96, osds_per_host=6, hosts_per_rack=4)
    cmap.add_simple_rule("data", "default", "host", mode="firstn")
    ks.reweight_devices(cmap, lambda dev: int(per_osd[dev]))
    dm = ck.DenseMap.from_crush_map(cmap, None, CPU)
    assert dm.recips.unique().numel() > 100
    prog = ck.rule_program(cmap, 0, 3)
    xs = np.arange(300)
    assert np.array_equal(crush_emulate.emulate(dm, prog, xs, warps=2),
                          _plain(dm, prog, xs))
