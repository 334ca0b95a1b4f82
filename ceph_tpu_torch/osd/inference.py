"""Primary-side coded inference engine (the `infer` kernel's wave; port
of ceph_tpu/osd/inference.py).

The serving path for Fisher-fused models (ceph_tpu_torch/inference/): the
params object's k+m DATA chunk streams are the k data parameter
shards and the m fused shards, so the primary

* fans ONE `infer_shard` sub-compute per serving-stream holder (the
  MOSDSubCompute wire op), each evaluating its locally-held
  stream's forward pass over the query batch — payloads never move,
  only (nq x cols) float32 contribution matrices come back;

* rides the HedgeTracker (osd/hedge.py) with need=k and a STRUCTURAL
  sufficiency predicate: an arrival set completes the query as soon
  as its pattern (which data streams, which fused streams) prices
  under the error budget — all-k-data is exact in the result domain,
  fused rows substitute for stragglers through the Fisher-averaged
  combine (inference/fisher.py);

* falls back to the EXACT path — the compute engine's full-decode
  wave, whose `infer` eval_object is the bit-parity anchor — when
  the caller demands exactness, the pattern cannot meet the budget,
  or the layout does not match the manifest.

Stage spans `infer_dispatch` / `infer_combine` / `infer_fallback`
feed the tracer's per-stage histograms; counters + the est_error
histogram surface as the `inference` perf-dump section
(ceph_osd_inference_* prometheus rows) and the `inference_status`
tell command.

Device placement: each stream holder's forward pass runs in its own
OSD's `InferShardKernel.shard_eval` on the daemon's device (the
`plan.inference_eval` einsum, as the reference leaves it to XLA); the
Fisher combine and the exact forward are host numpy, as in the
reference.
"""

from __future__ import annotations

import bisect
import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

from ceph_tpu_torch import compute as compute_mod
from ceph_tpu_torch.common import tracing
from ceph_tpu_torch.compute import canon_json
from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE
from ceph_tpu_torch.inference import (
    DEFAULT_ERROR_BUDGET, INFER_KERNEL, INFER_SHARD_KERNEL, fisher,
    model,
)
from ceph_tpu_torch.inference import kernels as ikernels

import numpy as np

log = logging.getLogger("osd.inference")

EAGAIN = -11
EINVAL = -22

#: est_error histogram bounds (relative error, log-spaced): the left
#: buckets watch the near-exact linear serving band, the right ones
#: the mlp Jensen-gap band and anything drifting toward the budget
EST_ERROR_BOUNDS = (1e-8, 1e-6, 1e-4, 1e-3, 0.01, 0.05, 0.1,
                    0.5, 1.0)


class ErrorHistogram:
    """Tiny fixed-bounds histogram in the prometheus
    {bounds, buckets, count, sum} shape the mgr flattener renders as
    ceph_osd_inference_est_error_* rows."""

    __slots__ = ("bounds", "buckets", "count", "total", "_lock")

    def __init__(self, bounds=EST_ERROR_BOUNDS):
        self.bounds = tuple(float(b) for b in bounds)
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.buckets[bisect.bisect_left(self.bounds,
                                            float(value))] += 1
            self.count += 1
            self.total += float(value)

    def to_perf_histogram(self) -> Dict[str, Any]:
        with self._lock:
            return {"bounds": list(self.bounds),
                    "buckets": list(self.buckets),
                    "count": self.count,
                    "sum": round(self.total, 9)}


class InferenceEngine:
    """One per daemon (`d.inference`); the compute engine routes
    approx_capable EC waves here."""

    def __init__(self, daemon):
        self.d = daemon
        self.counters: Dict[str, int] = {
            "ops": 0, "queries": 0, "approx_served": 0,
            "shard_exact_served": 0, "exact_fallbacks": 0,
            "budget_exceeded": 0, "substituted_streams": 0,
            "layout_mismatch": 0, "errors": 0,
        }
        self.est_error = ErrorHistogram()

    def default_budget(self) -> float:
        return float(self.d.config.get("osd_inference_error_budget",
                                       DEFAULT_ERROR_BUDGET))

    def perf_dump(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.counters)
        out["est_error"] = self.est_error.to_perf_histogram()
        return out

    # -- the wave ----------------------------------------------------------

    async def wave(self, state, pool, oids: List[str], kern,
                   args_raw: str, args: Dict[str, Any]
                   ) -> Dict[str, Tuple[int, bytes]]:
        d = self.d
        if kern.name != INFER_KERNEL:
            return {oid: (EINVAL, b"") for oid in oids}
        spec, queries, exact, budget = ikernels.parse_infer_args(args)
        if budget is None:
            budget = self.default_budget()
        self.counters["ops"] += 1
        self.counters["queries"] += queries.shape[0] * len(oids)
        if exact:
            return await self._exact(state, pool, oids, kern, args)
        k, m = int(spec["k"]), int(spec["m"])
        codec = d._codec(pool.id)
        if codec.get_data_chunk_count() != k + m or \
                d._sinfo(pool.id).get_chunk_size() != int(
                    spec["chunk"]):
            # the manifest's stream layout does not match this pool's
            # stripe geometry: per-shard results would be garbage, the
            # exact path is always right
            self.counters["layout_mismatch"] += 1
            return await self._exact(state, pool, oids, kern, args)
        gathered = await self._dispatch(state, pool, oids, spec,
                                        args, k, m, budget, queries)
        if gathered is None:
            return {oid: (EAGAIN, b"") for oid in oids}
        out: Dict[str, Tuple[int, bytes]] = {}
        fallback: List[str] = []
        async with tracing.child_span(
                f"infer_combine {spec['kind']} x{len(oids)}"):
            for oid in oids:
                blob = self._combine_one(
                    state, pool, oid, spec, queries, budget,
                    gathered.get(oid, {}), k, m)
                if blob is None:
                    fallback.append(oid)
                else:
                    out[oid] = (0, blob)
        if fallback:
            out.update(await self._exact(state, pool, fallback,
                                         kern, args))
        return out

    # -- dispatch (hedged per-stream fan-out) ------------------------------

    async def _dispatch(self, state, pool, oids: List[str],
                        spec: Dict[str, Any], args: Dict[str, Any],
                        k: int, m: int, budget: float,
                        queries: np.ndarray
                        ) -> Optional[Dict[str, Dict[str,
                                                     Dict[int,
                                                          bytes]]]]:
        """Fan `infer_shard` jobs over the k+m serving-stream holders
        and hedge-gather to the first arrival set whose pattern
        prices under the budget.  Returns oid -> version ->
        {stream: contribution bytes}, or None for a below-k wave
        (EAGAIN)."""
        d = self.d
        sub_kern = compute_mod.get_kernel(INFER_SHARD_KERNEL)
        qscale = fisher.query_scale(queries)
        jobs: List[Tuple[int, Any]] = []
        for idx, osd in enumerate(state.acting[:k + m]):
            if osd == CRUSH_ITEM_NONE or not d.osdmap.is_up(osd):
                continue
            sub_args = dict(args)
            sub_args["stream"] = idx
            sub_raw = canon_json(sub_args).decode()

            def job(shard=idx, osd=osd, raw=sub_raw,
                    sargs=sub_args):
                return d.compute._shard_job(
                    state.pg, shard, osd, oids, sub_kern, raw, sargs)

            jobs.append((osd, job))
        if len(jobs) < k:
            return None

        def collate(raw) -> Dict[str, Dict[str, Dict[int, bytes]]]:
            acc: Dict[str, Dict[str, Dict[int, bytes]]] = {}
            for shard, ok, items in raw:
                if not ok:
                    continue
                for oid, (rc, ver, res) in zip(oids, items):
                    if rc == 0 and res:
                        acc.setdefault(oid, {}).setdefault(
                            ver, {})[shard] = res
            return acc

        def viable(streams: Dict[int, bytes]) -> bool:
            data = [s for s in streams if s < k]
            fused = [s - k for s in streams if k <= s < k + m]
            est = fisher.structural_error(spec, data, fused, qscale)
            return est is not None and fisher.check_budget(est,
                                                           budget)

        def sufficient(raw) -> bool:
            acc = collate(raw)
            return all(
                any(viable(streams)
                    for streams in acc.get(oid, {}).values())
                for oid in oids)

        async with tracing.child_span(
                f"infer_dispatch {spec['kind']} x{len(oids)}"):
            raw, _ran_all = await d.hedge.gather(
                jobs, need=k, sufficient=sufficient,
                failed=lambda res: not res[1], label="subinfer")
        return collate(raw)

    # -- combine (Fisher-averaged, budget-gated) ---------------------------

    def _combine_one(self, state, pool, oid: str,
                     spec: Dict[str, Any], queries: np.ndarray,
                     budget: float,
                     groups: Dict[str, Dict[int, bytes]],
                     k: int, m: int) -> Optional[bytes]:
        """One object's arrival groups -> result blob, or None when
        only the exact fallback can serve it (no viable pattern, a
        stale version, or the budget check refusing)."""
        d = self.d
        cols = model.contribution_cols(spec)
        nq = queries.shape[0]
        want = nq * cols * 4
        versions = sorted(groups, key=d.compute._ver_key,
                          reverse=True)
        for ver in versions:
            streams = {s: r for s, r in groups[ver].items()
                       if len(r) == want}
            if not streams:
                continue
            try:
                # same acked-write guard as the read/pushdown paths:
                # a stale-version arrival set must not serve
                d._require_fresh(state, pool, oid,
                                 d.compute._ver_key(ver))
            except Exception:
                continue
            data_parts = {
                s: np.frombuffer(streams[s], dtype="<f4").reshape(
                    nq, cols)
                for s in streams if s < k}
            fused_parts = {
                s - k: np.frombuffer(streams[s],
                                     dtype="<f4").reshape(nq, cols)
                for s in streams if k <= s < k + m}
            served = fisher.combine(spec, data_parts, fused_parts,
                                    queries, budget)
            if served is None:
                self.counters["budget_exceeded"] += 1
                continue
            scores, est, substituted = served
            self.est_error.observe(est)
            if substituted:
                self.counters["approx_served"] += 1
                self.counters["substituted_streams"] += substituted
                mode = "approx"
            else:
                self.counters["shard_exact_served"] += 1
                mode = "shard_exact"
            return ikernels.result_blob(scores, mode, est,
                                        substituted)
        return None

    # -- the exact full-decode fallback ------------------------------------

    async def _exact(self, state, pool, oids: List[str], kern,
                     args: Dict[str, Any]
                     ) -> Dict[str, Tuple[int, bytes]]:
        """Hedged first-k read of the whole params object + the host
        reference forward (`infer` eval_object) — the bit-parity
        anchor shared with the CEPH_TPU_INFERENCE=0 client path."""
        self.counters["exact_fallbacks"] += len(oids)
        async with tracing.child_span(
                f"infer_fallback x{len(oids)}"):
            out = await self.d.compute._wave_fallback(
                state, pool, oids, kern, args)
        self.counters["errors"] += sum(
            1 for rc, _r in out.values() if rc != 0)
        return out
