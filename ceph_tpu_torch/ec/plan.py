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
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np
import torch

from ceph_tpu_torch.device import to_device
from ceph_tpu_torch.ops import crc_kernels, gf, gf_kernels


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
