"""Device execution of the codec's products (the main-path subset of
ceph_tpu/ec/plan.py).

Each entry stages host stripes onto the device once, runs the kernels
there, and brings the results back with one device-to-host copy.  The
JAX module's shape bucketing, mesh plans, quarantine and retrace
tracking answer XLA's compile-per-shape cost, which PyTorch's eager
kernels do not have; they are not part of this module.

The GF kernels take at most MAX_R rows and MAX_K inputs per launch, so a
larger product is tiled here: rows in blocks of MAX_R, each one launch
into its slice of the output, and inputs in blocks of MAX_K whose partial
products are XORed together.  The tiling runs on every device, so the
CPU (the kernels' plain versions) exercises it too.

The `xor_sched` kind (`repair`, `xor_sched_direct`): a GF(2^8) matrix
whose bit expansion compiles (ec/xsched.py) to an XOR program small
enough and short enough against its naive count (`xsched.prefer_schedule`)
runs as that program on the `xor_sched` kernel's GF entry, one launch;
any other matrix keeps the GF matmul kernels.  The pick is the
reference's (`_sched_for`), including its memo of too-dense matrices.

Two more entries serve the coded-compute and inference libraries:
`compute_eval` folds a wave of shard streams with one `gf_fold` launch
(the reference's `compute` plan kind), and `inference_eval` runs the
linear and 2-layer MLP forwards of a wave of serving streams as float32
einsums (the `inference` kind, which the reference also leaves to the
compiler's matrix products).
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
from collections import OrderedDict
from typing import Tuple

import numpy as np
import torch

from ceph_tpu_torch.device import to_device
from ceph_tpu_torch.ops import (crc_kernels, fold_kernels, gf, gf_kernels,
                                xor_kernels)


def matrix_signature(matrix: np.ndarray, extra: str = "") -> str:
    """Process-stable identity of a generator matrix: sha256 over shape,
    bytes and an optional discriminator."""
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    h = hashlib.sha256()
    h.update(repr(m.shape).encode())
    h.update(m.data)
    if extra:
        h.update(extra.encode())
    return h.hexdigest()[:16]


def codec_signature(technique: str, k: int, m: int, w: int,
                    matrix: np.ndarray) -> str:
    """The ErasureCodeIsaTableCache-style codec signature, hashed so it
    is stable across processes and restarts."""
    return matrix_signature(matrix, extra=f"{technique}/k{k}/m{m}/w{w}")


def _stripes(data: np.ndarray) -> np.ndarray:
    arr = np.asarray(data, dtype=np.uint8)
    if arr.ndim != 3:
        raise ValueError(f"expected (B, K, S) stripes, got {arr.shape}")
    return arr


def tiled_matmul(mat: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """(R,K) GF(2^8) matrix x (B,K,S) uint8 tensor -> (B,R,S) on the
    tensor's device, in kernel launches of at most MAX_R x MAX_K."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    r, k = mat.shape
    if r <= gf_kernels.MAX_R and k <= gf_kernels.MAX_K:
        return gf.gf_matmul_device(mat, data)
    out = torch.empty((data.shape[0], r, data.shape[2]), dtype=torch.uint8,
                      device=data.device)
    for k0 in range(0, k, gf_kernels.MAX_K):
        k1 = min(k, k0 + gf_kernels.MAX_K)
        block = data if (k0, k1) == (0, k) else data[:, k0:k1].contiguous()
        for r0 in range(0, r, gf_kernels.MAX_R):
            r1 = min(r, r0 + gf_kernels.MAX_R)
            part = gf.gf_matmul_device(mat[r0:r1, k0:k1], block)
            if k0 == 0:
                out[:, r0:r1].copy_(part)
            else:
                out[:, r0:r1].bitwise_xor_(part)
    return out


def matmul(mat: np.ndarray, data: np.ndarray,
           device: torch.device) -> np.ndarray:
    """(R,K) GF(2^8) matrix x (B,K,S) uint8 stripes -> (B,R,S) on host,
    computed on `device` (gf_matmul_spec for registered generators,
    gf_matmul_gen otherwise; tiled when R > MAX_R or K > MAX_K)."""
    arr = _stripes(data)
    if arr.size == 0:
        return np.zeros((arr.shape[0], np.shape(mat)[0], arr.shape[2]),
                        dtype=np.uint8)
    return tiled_matmul(mat, to_device(arr, device)).cpu().numpy()


def encode_with_crc(matrix: np.ndarray, data: np.ndarray,
                    device: torch.device
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, K, S) stripes -> (parity (B, M, S), crc (B, K+M) uint32).

    One host-to-device copy of the stripes; on the device the GF kernel
    writes the parity and the crc kernel runs over the B*K data chunks
    and the B*M parity chunks in place; then one device-to-host copy
    brings parity and crcs back together.  The crcs are zero-seeded
    (crc32c(init, chunk) = crc32c_zeros(init, S) ^ crc0): callers fold
    them into cumulative HashInfo ledgers.
    """
    arr = _stripes(data)
    b, k, s = arr.shape
    r = int(np.shape(matrix)[0])
    if s == 0 or b == 0:
        return (np.zeros((b, r, s), dtype=np.uint8),
                np.zeros((b, k + r), dtype=np.uint32))
    d = to_device(arr, device)
    par_bytes = b * r * s
    # one output buffer, so one copy back: parity, then the data chunks'
    # crcs, then the parity chunks' crcs (s % 4 == 0 keeps them aligned)
    buf = torch.empty(par_bytes + 4 * b * (k + r), dtype=torch.uint8,
                      device=d.device)
    parity = buf[:par_bytes].view(b, r, s)
    crcs = buf[par_bytes:].view(torch.int32)
    gf_kernels.gf_matmul(matrix, d, out=parity)
    crc_kernels.crc32c_blocks(d, s, 0, out=crcs[:b * k])
    crc_kernels.crc32c_blocks(parity, s, 0, out=crcs[b * k:])
    host = buf.cpu().numpy()
    c = host[par_bytes:].view(np.uint32)
    crc = np.concatenate([c[:b * k].reshape(b, k), c[b * k:].reshape(b, r)],
                         axis=1)
    return host[:par_bytes].reshape(b, r, s), crc


# ---------------------------------------------------------------------------
# The xor_sched kind
# ---------------------------------------------------------------------------

# pick cache: matrix signature -> XorSchedule | ("dense", naive).  Reached
# from the event loop AND the encode service's to_thread workers, so
# every access takes the lock; compiles happen OUTSIDE it (a racing pair
# builds twice, both results identical)
_sched_lock = threading.Lock()
_sched_pick: OrderedDict = OrderedDict()
_SCHED_PICK_CAP = 64


def _sched_for(matrix: np.ndarray):
    """The compiled XOR schedule of a GF(2^8) matrix's bit expansion,
    memoized by matrix signature, or None when the kill switch is off or
    the matrix is too dense to ever clear the op-count pick.  The density
    pre-bound matters: Paar CSE is quadratic-ish in the ones count, and a
    wide-k expansion whose BEST case still exceeds the op ceiling must
    not pay a multi-second compile on its first call just to be
    rejected.  The cache stores the schedule (or the naive count for
    too-dense matrices) rather than the verdict, so the policy knobs —
    `xsched.prefer_schedule` AND the density bound below — are re-judged
    per call and stay live."""
    from ceph_tpu_torch.ec import xsched

    if not xsched.enabled():
        return None
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    msig = matrix_signature(m)
    with _sched_lock:
        sched = _sched_pick.get(msig)
        if sched is not None:
            _sched_pick.move_to_end(msig)
    if sched is None:
        bits = gf.gf_matrix_to_bits(m)
        naive = int(bits.sum()) - bits.shape[0]
        if naive // 4 > xsched._max_ops():
            # even a 75% CSE cut could not fit the op ceiling: remember
            # the COUNT, not the verdict, and skip the compile
            sched = ("dense", naive)
        else:
            sched = xsched.compile_matrix(bits, sig=f"{msig}/bits")
        with _sched_lock:
            _sched_pick[msig] = sched
            if len(_sched_pick) > _SCHED_PICK_CAP:
                _sched_pick.popitem(last=False)
    if isinstance(sched, tuple):        # ("dense", naive): re-judge
        if sched[1] // 4 > xsched._max_ops():
            return None
        with _sched_lock:               # the ceiling was raised:
            _sched_pick.pop(msig, None)     # compile on the next call
        return _sched_for(m)
    return sched


def _xor_sched_call(prog, data: torch.Tensor) -> torch.Tensor:
    """One XOR program of a GF matrix over (B, K, S) bytes on the
    tensor's device -> (B, R, S): the kernel's GF entry, the chunk size
    zero-padded to a multiple of 4 (padding bytes give padding bytes:
    the product acts column by column)."""
    s = data.shape[-1]
    pad = -s % 4
    if pad:
        padded = torch.zeros((*data.shape[:-1], s + pad), dtype=torch.uint8,
                             device=data.device)
        padded[..., :s] = data
        return xor_kernels.xor_sched_gf(prog, padded)[..., :s]
    return xor_kernels.xor_sched_gf(prog, data.contiguous())


def xor_sched_direct(matrix: np.ndarray):
    """Schedule-vs-matmul pick for direct callers of a GF product: a
    function of a (B, K, S) uint8 tensor that runs the matrix's compiled
    XOR program on the kernel's GF entry when the measured op count
    prefers it, else None (the caller keeps the GF matmul kernels)."""
    from ceph_tpu_torch.ec import xsched

    sched = _sched_for(np.asarray(matrix, dtype=np.uint8))
    if sched is None or not xsched.prefer_schedule(sched):
        return None
    prog = xsched.lower_program(sched)
    return lambda data: _xor_sched_call(prog, data)


def repair(mat: np.ndarray, data, device: torch.device) -> np.ndarray:
    """(B, D, S) or (D, S) uint8 helper fragments x the (R, D) repair
    matrix -> the lost sub-chunk rows on the host, computed on `device`.
    The reference's `repair` plan kind: a sparse bit expansion whose
    compiled XOR program wins by op count runs as that program on the
    `xor_sched` kernel (the `xor_sched` kind); any other matrix goes
    through the GF matmul kernels (`matmul`).  A launch runs or raises:
    there is no host retry."""
    from ceph_tpu_torch.ec import xsched

    arr = np.asarray(data, dtype=np.uint8)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[None]
    if arr.ndim != 3:
        raise ValueError(f"expected (B, D, S) fragments, got {arr.shape}")
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    b, _d, s = arr.shape
    if s == 0 or b == 0:
        out = np.zeros((b, mat.shape[0], s), dtype=np.uint8)
    else:
        sched = _sched_for(mat)
        if sched is not None and xsched.prefer_schedule(sched):
            out = _xor_sched_call(xsched.lower_program(sched),
                                  to_device(arr, device)).cpu().numpy()
        elif s % 4:
            # the GF kernels take whole 32-bit words: zero-pad the chunk
            # (a product acts column by column)
            out = matmul(mat, np.pad(arr, ((0, 0), (0, 0), (0, -s % 4))),
                         device)[..., :s]
        else:
            out = matmul(mat, arr, device)
    return out[0] if squeeze else out


def stats() -> dict:
    """Observability: the schedule compiler's section (the reference's
    plan.stats()["xsched"]); the port has no plan cache to report."""
    from ceph_tpu_torch.ec import xsched

    return {"xsched": xsched.stats()}


# the fold's weight rows on the device, one upload per (kernel, row count,
# device): a kernel's weight row is a function of its name and row count
# (the reference's weights_sig rests on the same), and all-ones rows are
# kept as None, the kernel's plain XOR fold
_fold_weights: dict = {}


def compute_eval(name: str, weights: np.ndarray, data,
                 device: torch.device) -> np.ndarray:
    """(B, rows, lanes) uint8 shard batch (numpy or a host tensor) ->
    (B, 1, lanes) kernel results on the host, from one gf_fold launch on
    `device`."""
    if isinstance(data, torch.Tensor):
        t = data.to(device, non_blocking=True)
    else:
        t = to_device(np.asarray(data, dtype=np.uint8), device)
    if t.dim() != 3:
        raise ValueError(f"expected (B, rows, lanes), got {tuple(t.shape)}")
    b, rows, lanes = t.shape
    key = (name, rows, device)
    if key not in _fold_weights:
        w = np.asarray(weights, dtype=np.uint8).reshape(-1)
        if w.shape != (rows,):
            raise ValueError(f"{name}: {w.size} weights for {rows} rows")
        if len(_fold_weights) >= 64:
            _fold_weights.clear()
        _fold_weights[key] = None if (w == 1).all() else \
            torch.from_numpy(w.copy()).to(device)
    return fold_kernels.gf_fold(_fold_weights[key], t).cpu().numpy()


@contextlib.contextmanager
def _highest_matmul_precision():
    """float32 products in full float32 (no TF32) for the block."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def inference_eval(arch: str, ops: tuple, queries: np.ndarray,
                   device: torch.device) -> np.ndarray:
    """Stacked per-stream parameters + (nq, dim) query batch ->
    (B, nq, cols) float32 contributions, computed on `device`.

    linear: ops = (tables (B, rows, dim),); mlp: ops = (w1 (B, h, dim),
    b1 (B, h), w2 (B, out, h)).  The reference computes these outside
    any Pallas kernel, so they are library calls here (torch.einsum),
    in float32 at the highest matmul precision."""
    def f32(a) -> torch.Tensor:
        a = np.ascontiguousarray(a, dtype=np.float32)
        # a read-only view (queries off the wire) is copied, not aliased
        return torch.from_numpy(a if a.flags.writeable else a.copy()).to(
            device)

    q = f32(queries)
    t = [f32(o) for o in ops]
    with _highest_matmul_precision():
        if arch == "linear":
            # (B, rows, dim) x (nq, dim) -> (B, nq, rows)
            out = torch.einsum("qd,brd->bqr", q, t[0])
        else:
            w1, b1, w2 = t
            hid = torch.relu(torch.einsum("qd,bhd->bqh", q, w1)
                             + b1[:, None, :])
            out = torch.einsum("bqh,boh->bqo", hid, w2)
    return out.cpu().numpy()
