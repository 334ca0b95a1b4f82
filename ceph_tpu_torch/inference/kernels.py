"""The inference kernels, registered through the compute seam (port of
ceph_tpu/inference/kernels.py).

Two kernels ride the existing compute wire ops:

- ``infer``        the object-level query kernel (MOSDCompute).  Its
  `eval_object` is the EXACT path: whole params object -> host
  reference forward -> canonical result blob.  Three different
  callers funnel into it — the primary's full-decode fallback, the
  CEPH_TPU_INFERENCE=0 client path, and the CEPH_TPU_COMPUTE=0
  reference — which is the bit-parity contract.  approx_capable=True
  routes its EC-pool waves to the InferenceEngine (osd/inference.py)
  instead of the GF pushdown.
- ``infer_shard``  the per-shard kernel the engine fans out with
  (MOSDSubCompute).  Its `shard_eval` runs the serving streams' forward
  passes over the query batch on the OSD holding them, on the device the
  caller names (ec/plan.inference_eval, CUDA unless told otherwise); the
  numpy forward (model.shard_forward) is the host reference, not a
  fallback.

Both charge the `inference` mClock class, not `compute`.
"""

from __future__ import annotations

import base64
import binascii
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ceph_tpu_torch.compute import (
    ComputeError, ComputeKernel, EINVAL, canon_json,
)
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.inference import (
    INFER_KERNEL, INFER_SHARD_KERNEL, model,
)


def encode_queries(queries: np.ndarray) -> str:
    """(nq, dim) float32 query batch -> wire text (b64 of the raw
    little-endian bytes)."""
    q = np.ascontiguousarray(queries, dtype="<f4")
    return base64.b64encode(q.tobytes()).decode("ascii")


def decode_queries(spec: Dict[str, Any], raw: Any) -> np.ndarray:
    """Wire text -> (nq, dim) float32, or ComputeError(EINVAL)."""
    try:
        buf = base64.b64decode(str(raw), validate=True)
    except (binascii.Error, ValueError):
        raise ComputeError(EINVAL, "bad query encoding")
    dim = int(spec["dim"])
    if len(buf) == 0 or len(buf) % (4 * dim):
        raise ComputeError(EINVAL, "query batch/dim mismatch")
    return np.frombuffer(buf, dtype="<f4").reshape(-1, dim)


def parse_infer_args(args: Dict[str, Any]
                     ) -> Tuple[Dict[str, Any], np.ndarray, bool,
                                Optional[float]]:
    """Wire args -> (spec, queries, exact, budget).  Args come off
    the wire: every malformed shape must surface as EINVAL, never as
    a KeyError inside the engine."""
    spec = args.get("model")
    try:
        model.validate_spec(spec)
    except (ValueError, TypeError) as e:
        raise ComputeError(EINVAL, f"bad model manifest: {e}")
    queries = decode_queries(spec, args.get("q"))
    budget = args.get("budget")
    if budget is not None:
        try:
            budget = float(budget)
        except (TypeError, ValueError):
            raise ComputeError(EINVAL, "bad budget")
        if not 0.0 <= budget < 1e6:
            raise ComputeError(EINVAL, "budget out of range")
    return spec, queries, bool(args.get("exact")), budget


def result_blob(scores: np.ndarray, mode: str, est_error: float,
                substituted: int) -> bytes:
    """Final scores -> the canonical result bytes.  Exact paths all
    build this from the same exact_forward float32 array with
    est_error 0.0, so their blobs are bit-identical."""
    s = np.ascontiguousarray(scores, dtype="<f4")
    return canon_json({
        "mode": mode,
        "est_error": float(est_error),
        "substituted": int(substituted),
        "nq": int(s.shape[0]),
        "out": int(s.shape[1]),
        "scores": base64.b64encode(s.tobytes()).decode("ascii"),
    })


def decode_result(blob: bytes) -> Dict[str, Any]:
    """Result bytes -> dict with `scores` decoded to (nq, out)."""
    import json

    out = json.loads(bytes(blob))
    buf = base64.b64decode(out["scores"])
    out["scores"] = np.frombuffer(buf, dtype="<f4").reshape(
        int(out["nq"]), int(out["out"]))
    return out


def _device_contributions(spec: Dict[str, Any],
                          params: List[Dict[str, np.ndarray]],
                          queries: np.ndarray, device) -> np.ndarray:
    """Stacked streams' forward passes on `device`
    (ec/plan.inference_eval) -> (streams, nq, cols) float32."""
    from ceph_tpu_torch.ec import plan

    if spec["kind"] == "linear":
        ops = (np.stack([p["table"] for p in params]),)
    else:
        ops = (np.stack([p["w1"] for p in params]),
               np.stack([p["b1"] for p in params]),
               np.stack([p["w2"] for p in params]))
    return plan.inference_eval(spec["kind"], ops, queries, device)


class InferKernel(ComputeKernel):
    """Object-level coded inference: EC-pool waves route to the
    InferenceEngine (approx_capable pushdown with the Fisher
    combine); `eval_object` is THE exact path every fallback and
    kill switch shares."""

    name = INFER_KERNEL
    linear = False
    approx_capable = True
    qos_class = "inference"

    def validate_args(self, args: Dict[str, Any]) -> None:
        parse_infer_args(args)

    def eval_object(self, data, args: Dict[str, Any],
                    device=None) -> bytes:
        spec, queries, _exact, _budget = parse_infer_args(args)
        scores = model.exact_forward(spec, data, queries)
        return result_blob(scores, "exact", 0.0, 0)


class InferShardKernel(ComputeKernel):
    """Per-shard forward pass over one serving stream: the fan-out
    body of the engine's dispatch stage.  Results are raw float32
    contribution matrices (nq x cols) — the engine combines them in
    the result domain."""

    name = INFER_SHARD_KERNEL
    linear = False
    approx_capable = True
    qos_class = "inference"

    def validate_args(self, args: Dict[str, Any]) -> None:
        spec, _q, _e, _b = parse_infer_args(args)
        stream = args.get("stream")
        try:
            stream = int(stream)
        except (TypeError, ValueError):
            raise ComputeError(EINVAL, "bad stream index")
        if not 0 <= stream < int(spec["k"]) + int(spec["m"]):
            raise ComputeError(EINVAL, "stream index out of range")

    def eval_object(self, data, args: Dict[str, Any],
                    device=None) -> bytes:
        raise ComputeError(
            EINVAL, "infer_shard is shard-level only (use infer)")

    def shard_eval(self, payloads: Sequence, args: Dict[str, Any],
                   device=None) -> List[bytes]:
        dev = resolve_device(device)
        self.validate_args(args)
        spec, queries, _exact, _budget = parse_infer_args(args)
        params: List[Dict[str, np.ndarray]] = []
        bad: Dict[int, bool] = {}
        for i, payload in enumerate(payloads):
            try:
                params.append(model.unpack_stream(spec, payload))
            except ValueError:
                bad[i] = True
                params.append(None)  # type: ignore[arg-type]
        good = [p for p in params if p is not None]
        contrib = _device_contributions(spec, good, queries, dev) \
            if good else None
        out: List[bytes] = []
        row = 0
        for i in range(len(payloads)):
            if bad.get(i):
                # a short stream is this shard's failure, not the
                # wave's: an empty result the primary's collate drops
                out.append(b"")
                continue
            y = np.ascontiguousarray(contrib[row], dtype="<f4")
            row += 1
            out.append(y.tobytes())
        return out


def register_defaults(register) -> None:
    register(InferKernel())
    register(InferShardKernel())
