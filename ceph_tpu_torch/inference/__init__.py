"""Coded inference serving: Fisher-fused approximate ML scoring over
erasure-coded shards (port of ceph_tpu/inference/__init__.py).

The serving half of coded compute: embedding tables and small model
shards (linear scorer / small MLP) are STORED erasure-coded and
QUERIED through the code, so the one workload the north star names —
serving ML features off the object store — never pays k whole-shard
reads plus a decode per query, and is straggler-flat by construction.

The load-bearing ideas:

* arXiv:2409.01420 "Erasure Coded Neural Network Inference via Fisher
  Averaging": a nonlinear model does NOT commute with a GF parity
  chunk, but parameters fused in a Fisher-weighted space do commute
  APPROXIMATELY in the result domain — a fused shard's forward pass
  approximates the same weighted combination of the per-shard forward
  passes that its parameters are of the per-shard parameters, with a
  Jensen-gap error that Fisher weighting minimizes where it matters.
  The registry (inference/registry.py) derives m such fused parameter
  shards at STORE time, alongside the codec's k+m data/parity shards.

* arXiv:1804.10331 rateless coded matmul: the query completes on ANY
  sufficient shard-result set.  The primary fans the per-shard
  forward passes over the OSDs holding the serving streams (the PR-14
  MOSDSubCompute wire op) through the PR-6 HedgeTracker with need=k,
  and combines the FIRST sufficient arrival set — all k data results
  give the exact answer; fused results substitute for stragglers with
  a Fisher-averaged approximate combine (inference/fisher.py).

Layout: the registry interleaves the k data parameter shards AND the
m fused parameter shards as the k+m data chunk streams of ONE params
object in an EC(k+m, m_pool) pool — the pool codec's GF parity rides
behind them for durability, and every serving stream is exactly one
OSD's locally-held shard chunk stream (the same bytes
`eval_local_shards` reads for the linear compute kernels).

Error discipline: every query carries an error budget
(`osd_inference_error_budget` by default).  The combine path may only
return an approximate result after consulting `fisher.check_budget`
(the reference's `unbudgeted-approx-result` lint rule checks it); a budget
the structural error bound cannot meet — or a caller demanding
exactness — takes the exact full-decode fallback (hedged first-k
read of the whole params object + the host reference forward pass).

Kill switch: CEPH_TPU_INFERENCE=0 restores client-side
read-then-infer with the same host reference forward — bit-identical
to the exact fallback (the parity leg tests/test_inference.py
drives).
"""

from __future__ import annotations

from ceph_tpu_torch.common import flags

#: default per-query relative error budget (osd_inference_error_budget)
DEFAULT_ERROR_BUDGET = 0.05

#: the one client-visible kernel name (IoCtx.infer sends it) and the
#: per-shard kernel the engine fans out with
INFER_KERNEL = "infer"
INFER_SHARD_KERNEL = "infer_shard"


def env_enabled() -> bool:
    """CEPH_TPU_INFERENCE=0 restores client-side read-then-infer."""
    return flags.enabled("CEPH_TPU_INFERENCE")
