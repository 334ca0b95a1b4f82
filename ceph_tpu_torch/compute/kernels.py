"""The in-tree compute kernels (port of ceph_tpu/compute/kernels.py).

Two families (see compute/__init__.py for the theory):

GF-linear (pushdown to the coded shards, first-k result-domain
decode):

- ``gf_fold``        R-lane GF(2^8) fold (XOR of every lane-strided
                     byte): the checksum-pushdown kernel — a content
                     digest of the whole object computed without
                     moving it.
- ``gf_fingerprint`` seeded GF-weighted fold: a position-sensitive
                     content fingerprint (dedup candidate scoring) —
                     unlike the plain fold it detects chunk
                     permutations, because every lane-row carries its
                     own GF weight.

Nonlinear (per-kernel `approx_capable` decides the path: False means
the full-decode fallback at the primary, True means per-shard
pushdown with a result-domain approximate combine — the seam the
inference engine's kernels register through, inference/;
either way results, not payloads, cross the client wire):

- ``count``/``sum``/``min``/``max``  aggregate pushdown over
                     fixed-width records with an optional predicate
                     on a little-endian field.
- ``filter``         predicate scan: matching record indices
                     (bounded) + total match count.
- ``compress_score`` order-0 entropy estimate (bits/byte) over
                     fixed blocks — the compression-candidate scoring
                     of compressor/scoring.py, run where the data
                     lives.
- ``dot_score``      embedding scoring: object bytes as float32
                     vectors, best dot-product match against the
                     query vector in args.

Device work: the linear kernels' waves fold on the `gf_fold` CUDA kernel
(ops/fold_kernels.py) through ``planned_eval`` and ec/plan.compute_eval,
which replace the reference's traced ``make_device_eval``; ``compress_score``
counts its bytes with the `score_blocks` kernel (compressor/scoring.py).
``host_eval`` is the bit-exact numpy oracle.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from ceph_tpu_torch.common.buffer import as_buffer
from ceph_tpu_torch.compute import (
    ComputeError, ComputeKernel, DEFAULT_LANES, EINVAL, canon_json,
)

#: seed of the fingerprint kernel's GF weight stream (a protocol
#: constant: every daemon and every client oracle must derive the
#: same weights)
FINGERPRINT_SEED = 0xCE9


def host_eval(weights: np.ndarray, batch: np.ndarray) -> np.ndarray:
    """Bit-exact numpy twin: (1, rows) GF weights x (B, rows, lanes)
    -> (B, 1, lanes) via the GF table math.  The oracle for every
    device result."""
    w = np.asarray(weights, dtype=np.uint8).reshape(-1)
    b = np.ascontiguousarray(batch)
    if (w == 1).all():
        out = np.bitwise_xor.reduce(b, axis=1)
    else:
        from ceph_tpu_torch.ops import gf

        out = np.bitwise_xor.reduce(
            gf.gf_mul(w[None, :, None], b), axis=1)
    return out[:, None, :]


def planned_eval(name: str, weights: np.ndarray, batch,
                 device) -> np.ndarray:
    """One wave's kernel evaluation on `device`: (B, rows, lanes) shard
    batch -> (B, 1, lanes) results, one `gf_fold` launch
    (ec/plan.compute_eval)."""
    from ceph_tpu_torch.ec import plan as ec_plan

    return ec_plan.compute_eval(name, weights, batch, device)


# ---------------------------------------------------------------------------
# Linear kernels
# ---------------------------------------------------------------------------


class GfFold(ComputeKernel):
    """R-lane GF fold: result[r] = XOR of bytes at positions == r
    (mod lanes).  All-ones weight row — the pure checksum kernel."""

    name = "gf_fold"
    linear = True
    lanes = DEFAULT_LANES

    def row_weights(self, rows: int) -> np.ndarray:
        return np.ones((1, rows), dtype=np.uint8)


class GfFingerprint(ComputeKernel):
    """Seeded GF-weighted fold: row j carries a deterministic nonzero
    GF weight, so permuted content folds differently (the dedup /
    content-addressing fingerprint).  Weight stream is a protocol
    constant derived from FINGERPRINT_SEED."""

    name = "gf_fingerprint"
    linear = True
    lanes = DEFAULT_LANES

    def __init__(self):
        # memoized per row count: the stream is a deterministic
        # protocol constant, and a 10k-object scan would otherwise
        # regenerate it once per length-group per wave per OSD.
        # (Full regeneration per rows value, never prefix-slicing a
        # longer stream: numpy's bounded-integer generation is not
        # prefix-stable across lengths.)
        self._weights_cache: Dict[int, np.ndarray] = {}

    def row_weights(self, rows: int) -> np.ndarray:
        hit = self._weights_cache.get(rows)
        if hit is None:
            rng = np.random.default_rng(FINGERPRINT_SEED)
            # nonzero GF weights: zero rows would blind the
            # fingerprint
            hit = rng.integers(1, 256, (1, rows), dtype=np.uint8) \
                if rows else np.ones((1, 0), dtype=np.uint8)
            hit.setflags(write=False)
            if len(self._weights_cache) > 16:
                self._weights_cache.clear()
            self._weights_cache[rows] = hit
        return hit


# ---------------------------------------------------------------------------
# Nonlinear kernels: record aggregates / predicate scan
# ---------------------------------------------------------------------------

_CMPS = {
    "eq": np.equal, "ne": np.not_equal,
    "lt": np.less, "le": np.less_equal,
    "gt": np.greater, "ge": np.greater_equal,
}


def _int_arg(args: Dict[str, Any], key: str, default: int) -> int:
    """Client-supplied JSON -> int, or ComputeError(EINVAL): args
    come off the wire, so a null/string/huge value must surface as
    the op's rc, never as a TypeError inside the engine."""
    raw = args.get(key, default)
    try:
        val = int(raw)
    except (TypeError, ValueError):
        raise ComputeError(EINVAL, f"bad {key}={raw!r}")
    if not -(1 << 63) <= val < (1 << 64):
        raise ComputeError(EINVAL, f"{key} out of range")
    return val


def _record_fields(data, args: Dict[str, Any]):
    """(field values uint64, match mask) for the record-aggregate
    family: fixed-width records, little-endian unsigned field at
    [off, off+len), optional predicate {"cmp", "value"}."""
    rsize = _int_arg(args, "record", 8)
    off = _int_arg(args, "off", 0)
    flen = _int_arg(args, "len", min(8, max(rsize - off, 1)))
    if rsize <= 0 or off < 0 or flen <= 0 or flen > 8 or \
            off + flen > rsize:
        raise ComputeError(EINVAL, "bad record/field spec")
    buf = as_buffer(data)
    nrec = len(buf) // rsize
    arr = np.frombuffer(buf, dtype=np.uint8,
                        count=nrec * rsize).reshape(nrec, rsize)
    weights = (1 << (8 * np.arange(flen, dtype=np.uint64)))
    fields = arr[:, off:off + flen].astype(np.uint64) @ weights
    cmp = args.get("cmp")
    if cmp is None:
        return fields, np.ones(nrec, dtype=bool)
    fn = _CMPS.get(str(cmp))
    if fn is None:
        raise ComputeError(EINVAL, f"unknown cmp {cmp!r}")
    value = _int_arg(args, "value", 0)
    if value < 0:
        raise ComputeError(EINVAL, "value must be unsigned")
    return fields, fn(fields, np.uint64(value))


class RecordAgg(ComputeKernel):
    """count/sum/min/max over a record field, optionally predicated —
    the filter/aggregate pushdown family (one class, one reducer per
    registered name)."""

    linear = False

    def __init__(self, name: str):
        self.name = name

    def validate_args(self, args: Dict[str, Any]) -> None:
        _record_fields(b"", args)

    def eval_object(self, data, args: Dict[str, Any],
                    device=None) -> bytes:
        fields, mask = _record_fields(data, args)
        hit = fields[mask]
        if self.name == "count":
            return canon_json({"count": int(mask.sum())})
        if self.name == "sum":
            return canon_json({"count": int(mask.sum()),
                               "sum": int(hit.sum(dtype=np.uint64))
                               if hit.size else 0})
        val = None
        if hit.size:
            val = int(hit.min() if self.name == "min" else hit.max())
        return canon_json({"count": int(mask.sum()), self.name: val})


class FilterScan(ComputeKernel):
    """Predicate scan: total matches + the first `limit` matching
    record indices (the pgls-of-records shape)."""

    name = "filter"
    linear = False

    def validate_args(self, args: Dict[str, Any]) -> None:
        _record_fields(b"", args)

    def eval_object(self, data, args: Dict[str, Any],
                    device=None) -> bytes:
        _fields, mask = _record_fields(data, args)
        limit = max(0, min(_int_arg(args, "limit", 1024), 65536))
        idx = np.flatnonzero(mask)
        return canon_json({"count": int(idx.size),
                           "indices": [int(i) for i in idx[:limit]]})


class CompressScore(ComputeKernel):
    """Compression-candidate scoring: order-0 entropy (bits/byte)
    over fixed blocks via compressor/scoring.py's histogram path —
    incompressible objects (entropy near 8) can skip the codec
    entirely, decided where the bytes already are.  The byte counts
    come from the `score_blocks` kernel on `device` (from
    scoring.MIN_DEVICE_BYTES on); the entropy is the reference's
    float64 host arithmetic on them, so the result bytes are the
    reference's."""

    name = "compress_score"
    linear = False

    def eval_object(self, data, args: Dict[str, Any],
                    device=None) -> bytes:
        from ceph_tpu_torch.compressor import scoring

        block = _int_arg(args, "block", 4096)
        if block <= 0:
            raise ComputeError(EINVAL, "bad block")
        buf = as_buffer(data)
        if len(buf) == 0:
            return canon_json({"blocks": 0, "entropy_bpb": 0.0})
        nfull = max(len(buf) // block, 1)
        span = min(len(buf), nfull * block)
        blocks = np.frombuffer(buf, dtype=np.uint8,
                               count=(span // nfull) * nfull)
        blocks = blocks.reshape(nfull, -1)
        ent = scoring.entropy_from_histograms(
            scoring.byte_histograms(blocks, device=device),
            blocks.shape[1])
        return canon_json({
            "blocks": int(nfull),
            "entropy_bpb": round(float(np.mean(ent)), 4)})


class DotScore(ComputeKernel):
    """Embedding scoring: the object is a run of float32 vectors of
    dimension args["dim"]; score each against args["query"] and
    return the best match — inference-adjacent pushdown (the
    arXiv:2409.01420 workload shape)."""

    name = "dot_score"
    linear = False
    # argmax over raw object bytes has no per-shard decomposition:
    # NOT approx-capable, so it keeps the full-decode path.  The
    # coded serving of this workload shape lives in
    # inference/ (Fisher-fused shards, `infer` kernel),
    # whose kernels set approx_capable=True through this same seam.
    approx_capable = False

    def validate_args(self, args: Dict[str, Any]) -> None:
        dim = _int_arg(args, "dim", 0)
        query = args.get("query")
        if dim <= 0 or not isinstance(query, (list, tuple)) or \
                len(query) != dim:
            raise ComputeError(EINVAL, "dot_score needs dim + query")

    def eval_object(self, data, args: Dict[str, Any],
                    device=None) -> bytes:
        self.validate_args(args)
        dim = _int_arg(args, "dim", 0)
        try:
            q = np.asarray(args["query"], dtype=np.float32)
        except (TypeError, ValueError):
            raise ComputeError(EINVAL, "bad query vector")
        buf = as_buffer(data)
        stride = 4 * dim
        n = len(buf) // stride
        if n == 0:
            return canon_json({"n": 0, "best": None, "score": None})
        emb = np.frombuffer(buf, dtype=np.float32,
                            count=n * dim).reshape(n, dim)
        scores = emb @ q
        best = int(np.argmax(scores))
        return canon_json({"n": n, "best": best,
                           "score": round(float(scores[best]), 4)})


def register_defaults(register) -> None:
    """Register the in-tree kernel set (the default_handler role)."""
    register(GfFold())
    register(GfFingerprint())
    for name in ("count", "sum", "min", "max"):
        register(RecordAgg(name))
    register(FilterScan())
    register(CompressScore())
    register(DotScore())


def parse_args(raw: str) -> Dict[str, Any]:
    """Wire args (JSON text) -> dict; '' means {}."""
    if not raw:
        return {}
    try:
        out = json.loads(raw)
    except ValueError:
        raise ComputeError(EINVAL, "args not JSON")
    if not isinstance(out, dict):
        raise ComputeError(EINVAL, "args must be an object")
    return out
