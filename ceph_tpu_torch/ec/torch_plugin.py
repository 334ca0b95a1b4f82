"""`ec_torch`: the GF(2^8) matrix codec on a CUDA card (port of
ceph_tpu/ec/jax_plugin.py).

Techniques reed_sol_van / reed_sol_r6_op / cauchy_orig / cauchy_good of
the jerasure plugin at w=8, with the isa plugin's decode strategy: invert
the surviving k x k generator submatrix and cache the decode rows keyed by
the codec signature and the erasure pattern.

The single-object API matches the reference interface; the batched API
(encode_batch / decode_batch / encode_batch_with_crc /
encode_many_with_crc) is what osd/ec_util.py drives, one device round trip
for all stripes of an object.  The codec keeps the duck-typed names
ec_util reads (`matrix`, `use_tpu`, `tpu_min_bytes`); `use_tpu` is true
when the codec runs on a CUDA device.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec import dispatch, plan
from ceph_tpu_torch.ec.interface import (ErasureCode, ErasureCodeError,
                                         to_bool, to_int)
from ceph_tpu_torch.models import reed_solomon as rs
from ceph_tpu_torch.ops import checksum as cks
from ceph_tpu_torch.ops import gf_kernels

LARGEST_VECTOR_WORDSIZE = 16  # layout-parity constant from the reference


class ErasureCodeTorch(ErasureCode):
    """GF(2^8) matrix codec executed by the port's kernels."""

    TECHNIQUES = ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig", "cauchy_good")

    def __init__(self, technique: str = "reed_sol_van", device=None) -> None:
        super().__init__()
        if technique not in self.TECHNIQUES:
            raise ErasureCodeError(2, f"unknown technique {technique}")
        self.technique = technique
        self.device = resolve_device(device)
        self.w = 8
        self.per_chunk_alignment = False
        self.packetsize = 2048
        self.matrix: np.ndarray | None = None
        self.use_tpu = self.device.type == "cuda"
        self.tpu_min_bytes = 1
        self._plan_sig: str | None = None

    # -- init -------------------------------------------------------------

    def init(self, profile: Dict[str, str]) -> None:
        profile["technique"] = self.technique
        defaults = {"reed_sol_van": ("2", "1"), "reed_sol_r6_op": ("7", "2"),
                    "cauchy_orig": ("7", "3"), "cauchy_good": ("7", "3")}
        dk, dm = defaults[self.technique]
        self.k = to_int("k", profile, dk)
        self.m = to_int("m", profile, dm)
        self.w = to_int("w", profile, "8")
        if self.w != 8:
            raise ErasureCodeError(
                22, f"w={self.w}: this codec runs w=8 only")
        if self.technique == "reed_sol_r6_op" and self.m != 2:
            raise ErasureCodeError(22, "reed_sol_r6_op requires m=2")
        self.per_chunk_alignment = to_bool(
            "jerasure-per-chunk-alignment", profile, "false")
        if self.technique.startswith("cauchy"):
            self.packetsize = to_int("packetsize", profile, "2048")
        self.tpu_min_bytes = to_int("tpu-min-bytes", profile, "1")
        self.sanity_check_k_m(self.k, self.m)
        mapping = profile.get("mapping")
        if mapping and len(mapping) != self.k + self.m:
            raise ErasureCodeError(
                22, f"mapping {mapping} maps {len(mapping)} chunks, expected"
                f" {self.k + self.m}")
        super().init(profile)
        self._prepare()

    def _prepare(self) -> None:
        if self.technique == "reed_sol_van":
            self.matrix = rs.reed_sol_van_matrix(self.k, self.m)
        elif self.technique == "reed_sol_r6_op":
            self.matrix = rs.reed_sol_r6_matrix(self.k)
        elif self.technique == "cauchy_orig":
            self.matrix = rs.cauchy_orig_matrix(self.k, self.m)
        else:
            self.matrix = rs.cauchy_good_matrix(self.k, self.m)
        # the hot generator's schedule is built once: gf_matmul_spec
        gf_kernels.register_matrix(self.matrix)

    # -- geometry (layout-parity with ErasureCodeJerasure) ----------------

    def get_alignment(self) -> int:
        if self.technique.startswith("cauchy"):
            unit = self.w * self.packetsize * 4
            if unit % LARGEST_VECTOR_WORDSIZE:
                return self.k * self.w * self.packetsize * LARGEST_VECTOR_WORDSIZE
            return self.k * unit
        alignment = self.k * self.w * 4
        if (self.w * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * LARGEST_VECTOR_WORDSIZE
        return alignment

    def get_chunk_size(self, object_size: int) -> int:
        if self.per_chunk_alignment:
            alignment = (self.w * LARGEST_VECTOR_WORDSIZE
                         if not self.technique.startswith("cauchy")
                         else self._cauchy_per_chunk_alignment())
            chunk_size = -(-object_size // self.k)
            modulo = chunk_size % alignment
            if modulo:
                chunk_size += alignment - modulo
            return chunk_size
        return super().get_chunk_size(object_size)

    def _cauchy_per_chunk_alignment(self) -> int:
        alignment = self.w * self.packetsize
        modulo = alignment % LARGEST_VECTOR_WORDSIZE
        if modulo:
            alignment += LARGEST_VECTOR_WORDSIZE - modulo
        return alignment

    def supports_result_decode(self) -> bool:
        """True when GF-linear compute kernels commute with this codec
        (the coded-compute pushdown gate, compute/): every plain GF(2^8)
        matrix technique acts position-wise on bytes, so a kernel's
        result vectors satisfy the code relation of the shards and
        decode through the normal decode path at lane width.  Cauchy
        techniques carry a per-chunk packet layout the lane-width
        stripe cannot honor, and remapped layouts (chunk_mapping) are
        excluded with them: those take the full-decode path."""
        return (self.matrix is not None and self.w == 8
                and not self.technique.startswith("cauchy")
                and not self.get_chunk_mapping())

    # -- kernels ----------------------------------------------------------

    def plan_signature(self) -> str:
        """Stable-across-processes identity of this codec's generator
        (the decode-rows cache key prefix)."""
        if self._plan_sig is None:
            self._plan_sig = plan.codec_signature(
                self.technique, self.k, self.m, self.w, self.matrix)
        return self._plan_sig

    def _matmul(self, mat: np.ndarray, data: np.ndarray) -> np.ndarray:
        """(R,K) GF matrix x (K,S) or (B,K,S) uint8 -> (R,S) or (B,R,S)."""
        return dispatch.gf_matmul(mat, data, self.device)

    def encode_chunks(self, want_to_encode: Set[int],
                      encoded: Dict[int, bytearray]) -> None:
        k, m = self.k, self.m
        data = np.stack([
            np.frombuffer(encoded[self.chunk_index(i)], dtype=np.uint8)
            for i in range(k)])
        parity = np.ascontiguousarray(self._matmul(self.matrix, data))
        for j in range(m):
            encoded[self.chunk_index(k + j)][:] = parity[j].data

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Mapping[int, bytes],
                      decoded: Dict[int, bytearray]) -> None:
        k, m = self.k, self.m
        # positions on disk map to logical chunk ids through chunk_mapping;
        # the generator-matrix math lives in logical space
        erasures = [i for i in range(k + m) if self.chunk_index(i) not in chunks]
        if not erasures:
            return
        have = [i for i in range(k + m) if self.chunk_index(i) in chunks][:k]
        if len(have) < k:
            raise ErasureCodeError(5, "not enough chunks to decode")
        dmat = self._decode_matrix(tuple(have), tuple(erasures))
        src = np.stack([
            np.frombuffer(decoded[self.chunk_index(i)], dtype=np.uint8)
            for i in have])
        out = np.ascontiguousarray(self._matmul(dmat, src))
        for row, e in enumerate(erasures):
            decoded[self.chunk_index(e)][:] = out[row].data

    def _decode_matrix(self, have: tuple, erasures: tuple) -> np.ndarray:
        """Decode rows from the process-wide cache, keyed by the codec
        signature so two profiles never share rows."""
        return dispatch.shared_decode_rows(
            (self.plan_signature(), have, erasures),
            lambda: rs.decode_matrix(self.matrix, self.k,
                                     list(erasures), list(have)))

    # -- batched API ------------------------------------------------------

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """(B, k, S) uint8 stripes -> (B, m, S) parity in one device call."""
        if data.ndim != 3 or data.shape[1] != self.k:
            raise ValueError(f"expected (B, {self.k}, S), got {data.shape}")
        return self._matmul(self.matrix, data)

    def decode_batch(self, have: tuple, erasures: tuple,
                     survivors: np.ndarray) -> np.ndarray:
        """(B, k, S) surviving chunks (rows in `have` order) -> erased chunks."""
        dmat = self._decode_matrix(tuple(have), tuple(erasures))
        return self._matmul(dmat, survivors)

    def encode_batch_with_crc(self, data: np.ndarray, init: int = 0
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused encode + per-chunk crc32c in one device round trip:
        (B, k, S) -> (parity (B, m, S), crcs (B, k+m) uint32 seeded
        `init`)."""
        parity, crcs = plan.encode_with_crc(self.matrix, data, self.device)
        if init:
            # crc32c(init, chunk) = crc32c_zeros(init, S) ^ crc32c(0, chunk)
            adv = cks.crc32c_zeros(init & 0xFFFFFFFF, data.shape[-1])
            crcs = crcs ^ np.uint32(adv)
        return parity, crcs

    def encode_many_with_crc(self, arrs: Sequence[np.ndarray],
                             init: int = 0
                             ) -> Optional[List[Tuple[np.ndarray,
                                                      np.ndarray]]]:
        """N pending (B_i, k, S) stripe batches -> [(parity_i, crc_i)] in
        order, folded into one fused call (same-S batches concatenate
        along the stripe axis).  None when the batches do not share one
        (k, S) shape (callers then encode them one by one)."""
        arrs = [np.asarray(a, dtype=np.uint8) for a in arrs]
        if not arrs:
            return []
        s = arrs[0].shape[-1]
        if any(a.ndim != 3 or a.shape[1] != self.k or a.shape[2] != s
               for a in arrs):
            return None
        big = arrs[0] if len(arrs) == 1 else np.concatenate(arrs, axis=0)
        parity, crcs = self.encode_batch_with_crc(big, init=init)
        res: List[Tuple[np.ndarray, np.ndarray]] = []
        off = 0
        for a in arrs:
            b = a.shape[0]
            res.append((parity[off:off + b], crcs[off:off + b]))
            off += b
        return res


def from_numpy_matrix(technique: str, k: int, m: int, matrix: np.ndarray,
                      device=None) -> ErasureCodeTorch:
    """A port codec for the generator another implementation holds (for
    example a JAX codec's `matrix`, as numpy): the codec's state is its
    generator, so this is how it carries across.  Raises when the port's
    own construction of (technique, k, m) differs from `matrix`."""
    codec = ErasureCodeTorch(technique, device=device)
    codec.init({"technique": technique, "k": str(k), "m": str(m)})
    given = np.asarray(matrix, dtype=np.uint8)
    if not np.array_equal(codec.matrix, given):
        raise ValueError(f"{technique} k={k} m={m}: the given generator"
                         f" differs from this codec's construction")
    return codec
