"""Model registry: store-time Fisher fusion and the coded layout (port of
ceph_tpu/inference/registry.py).

Storing a model named N in an EC(k+m, m_pool) pool produces two
objects:

- ``N.manifest``  the canonical-JSON spec: shapes, the fusion
  coefficient matrix (Fisher weights already folded in), the
  calibrated per-fused-shard residuals rho, and the output scale —
  everything the engine and the client kill-switch path need.
- ``N.params``    ONE logical object whose k+m DATA chunk streams are
  the k data parameter shards followed by the m Fisher-fused shards,
  interleaved stripe-by-stripe exactly like ECUtil does, so each
  serving stream lands whole as one OSD's locally-held chunk stream
  and the per-shard forward runs on bytes that never move.  The pool
  codec's GF parity shards ride behind for durability.

Calibration happens HERE, once, at store time: a fixed seeded query
batch measures each fused shard's true Jensen-gap residual (zero up
to float rounding for the linear scorer), and rho carries that —
times a safety margin — into every future query's structural error
bound.  No query-time calibration, no drift.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ceph_tpu_torch.inference import fisher, model

#: queries in the store-time calibration batch
CAL_QUERIES = 64
_CAL_SEED = 0x1F15


def manifest_oid(name: str) -> str:
    return f"{name}.manifest"


def params_oid(name: str) -> str:
    return f"{name}.params"


def split_rows(total: int, k: int) -> List[int]:
    """Balanced row partition (first shards take the remainder)."""
    base, extra = divmod(total, k)
    return [base + (1 if i < extra else 0) for i in range(k)]


def make_model(kind: str, dim: int, out: int, *, seed: int = 0,
               hidden: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic random model for tests, loadgen, and the bench
    probe (float32, unit-ish scale)."""
    rng = np.random.default_rng(seed)
    if kind == "linear":
        return {"table": rng.standard_normal(
            (out, dim)).astype(np.float32)}
    if kind != "mlp":
        raise ValueError(f"bad model kind {kind!r}")
    scale = np.float32(1.0 / np.sqrt(dim))
    return {
        "w1": (rng.standard_normal((hidden, dim)) * scale
               ).astype(np.float32),
        "b1": (0.1 * rng.standard_normal(hidden)).astype(np.float32),
        "w2": (rng.standard_normal((out, hidden)) /
               np.sqrt(hidden)).astype(np.float32),
        "b2": (0.1 * rng.standard_normal(out)).astype(np.float32),
    }


def shard_params(kind: str, params: Dict[str, np.ndarray], k: int
                 ) -> Tuple[List[Dict[str, np.ndarray]],
                            Dict[str, Any]]:
    """Whole model -> k SAME-SHAPE parameter blocks + the shape
    metadata the manifest carries.  linear: row partition zero-padded
    to a common row count; mlp: hidden partition (hidden % k == 0 so
    the blocks fuse element-wise)."""
    if kind == "linear":
        table = np.asarray(params["table"], dtype=np.float32)
        out, dim = table.shape
        shard_rows = split_rows(out, k)
        rows = max(shard_rows)
        blocks, start = [], 0
        for r in shard_rows:
            blk = np.zeros((rows, dim), dtype=np.float32)
            blk[:r] = table[start:start + r]
            blocks.append({"table": blk})
            start += r
        return blocks, {"rows": rows, "shard_rows": shard_rows,
                        "dim": dim, "out": out}
    w1 = np.asarray(params["w1"], dtype=np.float32)
    hidden, dim = w1.shape
    if hidden % k:
        raise ValueError(f"mlp hidden {hidden} not divisible by k={k}")
    h = hidden // k
    w2 = np.asarray(params["w2"], dtype=np.float32)
    out = w2.shape[0]
    b1 = np.asarray(params["b1"], dtype=np.float32)
    blocks = [{"w1": w1[i * h:(i + 1) * h],
               "b1": b1[i * h:(i + 1) * h],
               "w2": np.ascontiguousarray(w2[:, i * h:(i + 1) * h])}
              for i in range(k)]
    return blocks, {"rows": h, "hidden": h, "dim": dim, "out": out,
                    "b2": [float(v) for v in params["b2"]]}


def interleave_streams(streams: Sequence[bytes], chunk: int) -> bytes:
    """k+m equal-length chunk streams -> the logical object bytes
    whose ECUtil split hands each stream back whole (the exact
    inverse of compute.data_shard_streams)."""
    total = len(streams)
    stripes = len(streams[0]) // chunk
    cube = np.empty((stripes, total, chunk), dtype=np.uint8)
    for t, s in enumerate(streams):
        cube[:, t, :] = np.frombuffer(s, dtype=np.uint8
                                      ).reshape(stripes, chunk)
    return cube.tobytes()


def _calibrate(spec: Dict[str, Any], streams: Sequence[bytes]
               ) -> Tuple[List[float], float]:
    """Measure each fused shard's combine residual on a fixed seeded
    query batch -> (rho per fused shard, output scale), both per unit
    query RMS.  Conservative by construction: rho is the WORST
    per-query residual (times the safety margin) and yscale the
    SMALLEST per-query output magnitude, so the structural bound
    stays an upper bound for on-distribution queries it never saw."""
    k, m = int(spec["k"]), int(spec["m"])
    rng = np.random.default_rng(_CAL_SEED)
    q = rng.standard_normal(
        (CAL_QUERIES, int(spec["dim"]))).astype(np.float32)
    qrms = np.sqrt(np.mean(np.square(
        q.astype(np.float64)), axis=1)) + 1e-12
    parts = [model.shard_forward(spec, streams[i], q)
             for i in range(k)]
    coeff = np.asarray(spec["coeff"], dtype=np.float64)
    rho: List[float] = []
    for j in range(m):
        got = np.asarray(model.shard_forward(spec, streams[k + j], q),
                         dtype=np.float64)
        want = np.zeros_like(got)
        for i in range(k):
            want += coeff[j, i] * np.asarray(parts[i],
                                             dtype=np.float64)
        per_q = np.sqrt(np.mean(np.square(got - want), axis=1))
        rho.append(fisher.RHO_MARGIN *
                   max(float(np.max(per_q / qrms)), 1e-9))
    exact = np.asarray(model.combine_contributions(spec, parts),
                       dtype=np.float64)
    yscale = float(np.min(
        np.sqrt(np.mean(np.square(exact), axis=1)) / qrms)) + 1e-12
    return rho, yscale


def build(name: str, kind: str, params: Dict[str, np.ndarray],
          k: int, m: int, chunk: int,
          fisher_info: Optional[Sequence[float]] = None
          ) -> Tuple[Dict[str, Any], Dict[str, bytes]]:
    """Whole model -> (spec, {oid: object bytes}) ready to write into
    an EC(k+m, ...) pool whose codec chunk size is `chunk`.  The
    heavy lifting: shard, Fisher-fuse, pack k+m serving streams,
    calibrate rho/yscale against the packed bytes (the exact bytes
    the OSDs will serve), and interleave the params object."""
    blocks, meta = shard_params(kind, params, k)
    omega = fisher.fisher_weights(
        [np.concatenate([np.ravel(b[n]) for n in sorted(b)])
         for b in blocks], fisher_info)
    coeff = fisher.fusion_coeff(k, m, omega)
    fused = fisher.fuse_blocks(blocks, coeff)
    spec: Dict[str, Any] = {
        "name": name, "kind": kind, "k": k, "m": m,
        "chunk": int(chunk), "dtype": "float32",
        "coeff": [[float(v) for v in row] for row in coeff],
        "params_oid": params_oid(name),
    }
    spec.update(meta)
    spec["stream_bytes"] = model.stream_nbytes(spec)
    padded = -spec["stream_bytes"] % chunk
    streams = [model.pack_stream(spec, b) + bytes(padded)
               for b in blocks + fused]
    rho, yscale = _calibrate(spec, streams)
    spec["rho"] = rho
    spec["yscale"] = yscale
    model.validate_spec(spec)
    from ceph_tpu_torch.compute import canon_json

    return spec, {
        manifest_oid(name): canon_json(spec),
        params_oid(name): interleave_streams(streams, chunk),
    }
