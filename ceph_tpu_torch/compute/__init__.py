"""Coded compute: a straggler-tolerant compute-over-shards subsystem
(port of ceph_tpu/compute/__init__.py).

The compute-in-storage workload class: batched,
vmap-able kernels (filter/aggregate pushdown, checksum and
compression-candidate scoring, embedding dot-product scoring) run ON
the OSDs that hold an object's erasure-coded shards, and the client
receives only tiny result bytes — the payload never crosses the wire.

The load-bearing idea (arXiv:2409.01420 "Erasure Coded Neural Network
Inference via Fisher Averaging", arXiv:1804.10331 rateless coded
matmul): a kernel that is GF(2^8)-LINEAR over byte positions commutes
with the erasure code.  Every coded shard satisfies
``c_j = sum_i G[j,i] * d_i`` position-wise, so for a linear kernel f,
``f(c_j) = sum_i G[j,i] * f(d_i)`` — the SAME code relation, on
R-byte results instead of chunk-size payloads.  The primary therefore
needs only the FIRST k shard-results (any k, hedged exactly like a
first-k read — osd/hedge.py), and decodes in the RESULT DOMAIN: a
tiny GF combine of k R-byte vectors through the very same
``ec_util.decode`` machinery the data path uses, with a synthetic
StripeInfo whose chunk size is the kernel's lane count.  A straggling
or dead OSD never blocks the scan.

Kernels that are NOT GF-linear (record aggregates, predicate scans,
entropy scoring, float dot products) cannot ride the code: they take
the FULL-DECODE FALLBACK — the primary reconstructs the object
through the normal hedged first-k read path and evaluates the kernel
on the logical bytes.  Still a pushdown (result bytes, not payload
bytes, cross the client wire), but the compute itself is only as
straggler-tolerant as the read under it.  The registry records which
family each kernel is in (`linear`), and the OSD engine picks the
path per (kernel, codec).

Registry: the plugin_registry pattern EC/compressor/cls already use —
kernels are named entries in a module-level table; `default_kernels`
registers the in-tree set.

Kill switch: CEPH_TPU_COMPUTE=0 — clients fall back to
read-then-compute with the same kernel reference implementations,
bit-exactly.

In the port, `shard_eval_batch` folds each wave of same-length shard
streams with one launch of the `gf_fold` CUDA kernel
(ops/fold_kernels.py, through ec/plan.compute_eval) on the device the
caller names, CUDA unless told otherwise; on the CPU its plain version
runs.  There is no host fallback and no breaker: a launch runs or
raises.  The host oracles (`reference`, `eval_stream`) stay numpy.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ceph_tpu_torch.common import flags
from ceph_tpu_torch.common.buffer import as_buffer
from ceph_tpu_torch.device import resolve_device

ENOENT = -2
EINVAL = -22
EIO = -5

#: result width (bytes) of the linear kernels: small enough that a
#: 10k-object scan's results fit one frame, wide enough that the
#: fold/fingerprint collision bound is cryptographically irrelevant
#: for scrub-grade integrity scoring
DEFAULT_LANES = 32


def env_enabled() -> bool:
    """CEPH_TPU_COMPUTE=0 restores client-side read-then-compute."""
    return flags.enabled("CEPH_TPU_COMPUTE")


class ComputeError(Exception):
    """Raised by kernels to return an error rc for one object."""

    def __init__(self, rc: int, what: str = ""):
        super().__init__(f"rc={rc} {what}")
        self.rc = rc


def canon_json(obj: Any) -> bytes:
    """Canonical JSON result encoding: byte-identical across the
    pushdown, fallback, and client-side paths (the bit-exactness
    contract is on these bytes)."""
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode()


def pad_to(data, multiple: int):
    """Zero-pad a byte stream up to a multiple (zeros are the GF
    additive identity, so linear kernel results are pad-invariant).
    Unpadded inputs pass through as views; a pad is the one honest
    copy, handed out as a readonly view."""
    buf = as_buffer(data)
    short = -len(buf) % multiple
    if short == 0:
        return buf
    out = bytearray(len(buf) + short)
    out[: len(buf)] = buf
    return memoryview(out).toreadonly()


def data_shard_streams(data, k: int, chunk: int) -> List:
    """Split padded logical bytes into the k data-shard chunk streams
    (the ECUtil interleave: stripe s of shard i is
    data[s*width + i*chunk : s*width + (i+1)*chunk]) — the host-side
    twin of what the OSDs hold, for oracles and fallbacks.  Each
    stream is one strided->contiguous gather handed out as a frozen
    buffer view (no second whole-stream copy)."""
    if k <= 1:
        return [pad_to(data, max(chunk, 1))]
    width = k * chunk
    padded = pad_to(data, width)
    arr = np.frombuffer(padded, dtype=np.uint8)
    # (stripes, k, chunk) -> per-shard concatenated chunk streams
    cube = arr.reshape(-1, k, chunk)
    out = []
    for i in range(k):
        stream = np.ascontiguousarray(cube[:, i, :]).reshape(-1)
        stream.setflags(write=False)
        out.append(stream.data)
    return out


class ComputeKernel:
    """One registered compute kernel.

    linear=True kernels are GF(2^8)-linear maps of the byte stream
    (result[r] = GF-sum over rows j of row_weights[j] * x[j*lanes+r]),
    evaluated per SHARD on the OSDs and combined in the result domain;
    their object-level answer is the GF-sum (XOR) of the k data-shard
    results.  linear=False kernels define `eval_object` on the
    reconstructed logical bytes.

    approx_capable=True marks a NONLINEAR kernel that can still run
    per-shard with an approximate result-domain combine (the Fisher
    fusion seam, ceph_tpu/inference/): the OSD pushdown and
    sub-compute paths admit `linear or approx_capable` kernels and
    call `shard_eval` — which such kernels override — instead of
    assuming the GF batched eval.  qos_class names the mClock class
    the per-shard eval is charged to, so inference work is shaped by
    its own dmClock profile rather than riding the compute class."""

    name = ""
    linear = False
    approx_capable = False
    qos_class = "compute"
    lanes = DEFAULT_LANES

    # -- common ------------------------------------------------------------

    def validate_args(self, args: Dict[str, Any]) -> None:
        """Raise ComputeError(EINVAL) on malformed args."""

    def reference(self, data, args: Dict[str, Any],
                  k: int = 1, chunk: int = 0, device=None) -> bytes:
        """Host oracle on the logical object bytes: the bit-exactness
        anchor every execution path (pushdown, full-decode fallback,
        client-side kill switch) must match.  A nonlinear kernel's
        `eval_object` runs on `device` where it has device work."""
        if not self.linear:
            return self.eval_object(data, args, device=device)
        streams = data_shard_streams(data, k, chunk or self.lanes)
        return self.combine([self.eval_stream(s) for s in streams])

    # -- nonlinear surface -------------------------------------------------

    def eval_object(self, data, args: Dict[str, Any],
                    device=None) -> bytes:
        raise NotImplementedError

    # -- linear surface ----------------------------------------------------

    def row_weights(self, rows: int) -> np.ndarray:
        """(1, rows) uint8 GF weight row: the kernel IS this matrix
        (result = weights @ reshaped stream, a GF matmul — which is
        why it folds on the GF kernel)."""
        raise NotImplementedError

    def eval_stream(self, stream) -> bytes:
        """Host evaluation of one shard chunk stream -> lanes bytes.
        The device path lives in `shard_eval_batch` (one fold launch
        for a whole wave of shards); this is its bit-exact oracle."""
        from ceph_tpu_torch.compute import kernels as _k

        padded = pad_to(stream, self.lanes)
        rows = len(padded) // self.lanes
        if rows == 0:
            return b"\x00" * self.lanes
        arr = np.frombuffer(padded, dtype=np.uint8).reshape(
            1, rows, self.lanes)
        out = _k.host_eval(self.row_weights(rows), arr)
        # lane-width result (32 B), not a payload copy
        return out[0, 0].tobytes()

    def combine(self, parts: Sequence[bytes]) -> bytes:
        """GF-sum (XOR) of per-data-shard results -> the object-level
        answer."""
        acc = np.zeros(self.lanes, dtype=np.uint8)
        for p in parts:
            acc ^= np.frombuffer(p, dtype=np.uint8)
        # lane-width result (32 B), not a payload copy
        return acc.tobytes()

    # -- per-shard surface (linear AND approx_capable) ---------------------

    def shard_eval(self, payloads: Sequence, args: Dict[str, Any],
                   device=None) -> List[bytes]:
        """Evaluate a wave of locally-held shard payloads -> one
        result blob each.  Linear kernels get the batched fold on
        `device`; approx_capable kernels override with their own
        per-shard forward (inference/kernels.py)."""
        if not self.linear:
            raise NotImplementedError(
                f"kernel {self.name} has no per-shard evaluation")
        return shard_eval_batch(self, payloads, args, device=device)


# ---------------------------------------------------------------------------
# Registry (plugin_registry pattern)
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ComputeKernel] = {}


def register(kernel: ComputeKernel) -> ComputeKernel:
    assert kernel.name and kernel.name not in _REGISTRY, kernel.name
    _REGISTRY[kernel.name] = kernel
    return kernel


def get_kernel(name: str) -> Optional[ComputeKernel]:
    _ensure_defaults()
    return _REGISTRY.get(name)


def registered_kernels() -> Dict[str, ComputeKernel]:
    _ensure_defaults()
    return dict(_REGISTRY)


def linear_kernels() -> Dict[str, ComputeKernel]:
    return {n: k for n, k in registered_kernels().items() if k.linear}


_defaults_loaded = False


def _ensure_defaults() -> None:
    global _defaults_loaded
    if _defaults_loaded:
        return
    _defaults_loaded = True
    from ceph_tpu_torch.compute import kernels as _k

    _k.register_defaults(register)
    # the inference subsystem registers its approx_capable kernels
    # through the same seam
    from ceph_tpu_torch.inference import kernels as _ik

    _ik.register_defaults(register)


def shard_eval_batch(kernel: ComputeKernel, payloads: Sequence,
                     args: Dict[str, Any], device=None) -> List[bytes]:
    """Evaluate a linear kernel over a WAVE of shard payloads, one fold
    launch per length group: payloads sharing a padded row count stack
    into ONE (B, rows, lanes) batch, staged straight into one host buffer
    (pinned for a CUDA device) and folded on `device`
    (kernels.planned_eval).  Zero pad rows change no result, so no batch
    is padded to a bucket."""
    from ceph_tpu_torch.compute import kernels as _k

    dev = resolve_device(device)
    lanes = kernel.lanes
    groups: Dict[int, List[int]] = {}
    padded: List[bytes] = []
    for i, p in enumerate(payloads):
        buf = pad_to(p, lanes)
        padded.append(buf)
        groups.setdefault(len(buf), []).append(i)
    out: List[bytes] = [b""] * len(padded)
    for length, idxs in groups.items():
        rows = length // lanes
        if rows == 0:
            for i in idxs:
                out[i] = b"\x00" * lanes
            continue
        stage = torch.empty((len(idxs), rows, lanes), dtype=torch.uint8,
                            pin_memory=dev.type == "cuda")
        host = stage.numpy()
        for row, i in enumerate(idxs):
            host[row] = np.frombuffer(padded[i], dtype=np.uint8).reshape(
                rows, lanes)
        res = _k.planned_eval(kernel.name, kernel.row_weights(rows),
                              stage, dev)
        for row, i in enumerate(idxs):
            # lane-width result (32 B), not a payload copy
            out[i] = res[row, 0].tobytes()
    return out
