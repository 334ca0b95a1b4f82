"""Model shapes, stream packing, and the host reference forwards (port of
ceph_tpu/inference/model.py).

Two architectures, both sharded k ways into SAME-SHAPE parameter
blocks (element-wise fusable, exactly like the codec fuses same-size
chunks):

- ``linear``  an embedding/scoring table row-partitioned: data shard
              i holds rows block P_i (rows x dim, zero-padded to a
              common row count); its contribution to query batch Q is
              y_i = Q @ P_i^T and the full answer is the concat of
              the un-padded row blocks.
- ``mlp``     a 2-layer MLP hidden-partitioned: shard i holds
              (W1_i: h x dim, b1_i: h, W2_i: out x h); its
              contribution is y_i = relu(Q @ W1_i^T + b1_i) @ W2_i^T
              and the full answer is the shard-ordered SUM plus the
              shared output bias b2 (carried in the manifest).

A serving STREAM is one shard's parameters packed as little-endian
float32 bytes — the exact bytes the OSD holding that chunk stream
reads back, so the per-shard forward runs on locally-held bytes with
no payload movement.  ``exact_forward`` (whole-object bytes -> final
scores, pure numpy, fixed op order) is the bit-exactness anchor: the
primary's full-decode fallback, the client-side kill switch, and the
compute-kill-switch reference all call it, so those three paths are
bit-identical by construction.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

ARCHS = ("linear", "mlp")


def _f32(buf) -> np.ndarray:
    return np.frombuffer(buf, dtype="<f4")


def stream_nbytes(spec: Dict[str, Any]) -> int:
    """Packed byte length of ONE serving stream (all streams equal —
    same-shape blocks are what makes them element-wise fusable)."""
    dim = int(spec["dim"])
    if spec["kind"] == "linear":
        return int(spec["rows"]) * dim * 4
    h, out = int(spec["hidden"]), int(spec["out"])
    return (h * dim + h + out * h) * 4


def pack_stream(spec: Dict[str, Any], params: Dict[str, np.ndarray]
                ) -> bytes:
    """One shard's parameter block -> stream bytes (little-endian
    float32, fixed member order)."""
    if spec["kind"] == "linear":
        table = np.ascontiguousarray(params["table"], dtype="<f4")
        assert table.shape == (int(spec["rows"]), int(spec["dim"]))
        return table.tobytes()
    w1 = np.ascontiguousarray(params["w1"], dtype="<f4")
    b1 = np.ascontiguousarray(params["b1"], dtype="<f4")
    w2 = np.ascontiguousarray(params["w2"], dtype="<f4")
    return w1.tobytes() + b1.tobytes() + w2.tobytes()


def unpack_stream(spec: Dict[str, Any], buf) -> Dict[str, np.ndarray]:
    """Stream bytes (possibly zero-padded past the packed length by
    the stripe interleave) -> parameter arrays."""
    need = stream_nbytes(spec)
    view = memoryview(buf)[:need]
    if len(view) < need:
        raise ValueError(
            f"short stream: {len(view)} < {need} bytes")
    dim = int(spec["dim"])
    if spec["kind"] == "linear":
        return {"table": _f32(view).reshape(int(spec["rows"]), dim)}
    h, out = int(spec["hidden"]), int(spec["out"])
    flat = _f32(view)
    w1 = flat[: h * dim].reshape(h, dim)
    b1 = flat[h * dim: h * dim + h]
    w2 = flat[h * dim + h:].reshape(out, h)
    return {"w1": w1, "b1": b1, "w2": w2}


def contribution_cols(spec: Dict[str, Any]) -> int:
    """Column count of one shard's contribution matrix (Q x cols):
    padded rows for linear, the output dim for mlp — IDENTICAL for
    data and fused streams, which is what lets a fused result
    substitute for a missing data result element-wise."""
    return int(spec["rows"] if spec["kind"] == "linear"
               else spec["out"])


def shard_forward(spec: Dict[str, Any], stream, queries: np.ndarray
                  ) -> np.ndarray:
    """Host forward pass of ONE stream's parameters over the query
    batch (Q x dim) -> (Q x cols) float32.  The bit-exact twin of the
    `inference` plan kind's device trace (ec/plan.py inference_eval)
    and the fallback when that dispatch degrades."""
    p = unpack_stream(spec, stream)
    q = np.asarray(queries, dtype=np.float32)
    if spec["kind"] == "linear":
        return q @ p["table"].T
    hid = np.maximum(q @ p["w1"].T + p["b1"][None, :],
                     np.float32(0.0))
    return hid @ p["w2"].T


def combine_contributions(spec: Dict[str, Any],
                          parts: List[np.ndarray]) -> np.ndarray:
    """k data-shard contributions (shard order) -> final scores.
    Fixed op order — every exact path funnels through here so the
    bit-parity contract holds across primary fallback, kill switch,
    and the compute-kill-switch reference."""
    if spec["kind"] == "linear":
        rows = [int(r) for r in spec["shard_rows"]]
        return np.concatenate(
            [np.asarray(p, dtype=np.float32)[:, :r]
             for p, r in zip(parts, rows)], axis=1)
    acc = np.zeros_like(np.asarray(parts[0], dtype=np.float32))
    for p in parts:
        acc = acc + np.asarray(p, dtype=np.float32)
    return acc + np.asarray(spec["b2"], dtype=np.float32)[None, :]


def object_streams(spec: Dict[str, Any], data) -> List[memoryview]:
    """Whole params-object logical bytes -> the k+m serving streams
    (the host twin of what each OSD's chunk stream holds; see
    registry.interleave_streams for the layout)."""
    from ceph_tpu_torch.compute import data_shard_streams

    total = int(spec["k"]) + int(spec["m"])
    return data_shard_streams(data, total, int(spec["chunk"]))


def exact_forward(spec: Dict[str, Any], data,
                  queries: np.ndarray) -> np.ndarray:
    """THE exact oracle: whole-object logical bytes -> final scores,
    pure numpy, per-data-shard forward in shard order then the fixed
    combine.  Bit-identical across every exact execution path."""
    streams = object_streams(spec, data)
    k = int(spec["k"])
    parts = [shard_forward(spec, streams[i], queries)
             for i in range(k)]
    return combine_contributions(spec, parts)


def validate_spec(spec: Dict[str, Any]) -> None:
    """Wire manifest -> structural sanity (args come off the wire;
    malformed specs must surface as EINVAL, never a KeyError in the
    engine)."""
    if not isinstance(spec, dict) or spec.get("kind") not in ARCHS:
        raise ValueError(f"bad model kind {spec.get('kind')!r}")
    for key in ("dim", "k", "m", "rows", "chunk", "out"):
        if int(spec.get(key, 0)) <= 0:
            raise ValueError(f"bad model spec field {key!r}")
    if spec["kind"] == "mlp":
        if int(spec.get("hidden", 0)) <= 0:
            raise ValueError("mlp spec needs hidden")
        if len(spec.get("b2", ())) != int(spec["out"]):
            raise ValueError("mlp spec b2/out mismatch")
    else:
        rows = spec.get("shard_rows", ())
        if len(rows) != int(spec["k"]) or \
                sum(int(r) for r in rows) != int(spec["out"]):
            raise ValueError("linear spec shard_rows/out mismatch")
    coeff = np.asarray(spec.get("coeff", ()), dtype=np.float64)
    if coeff.shape != (int(spec["m"]), int(spec["k"])):
        raise ValueError("fusion coeff shape mismatch")
