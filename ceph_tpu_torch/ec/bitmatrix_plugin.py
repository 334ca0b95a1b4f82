"""Bit-matrix RAID-6 techniques: liberation / blaum_roth / liber8tion
(port of ceph_tpu/ec/bitmatrix_plugin.py).

Reference parity: the jerasure plugin's bitmatrix technique family
(ErasureCodeJerasure.cc:452 ErasureCodeJerasureLiberation, :476
BlaumRoth, :488-513 Liber8tion in Ceph's tree) with the same profile
surface (k, m=2, w, packetsize) and the same parameter adjudication
(prime/w constraints, k <= w).  Matrix constructions live in
models/bitmatrix.py.

Execution model: a chunk is w packets of `packetsize` bytes repeated
across the chunk (jerasure_bitmatrix_encode's packet walk); coding
packet r of chunk j is the XOR of the data packets selected by
bitmatrix row j*w + r.  The program is the COMPILED XOR schedule
(ec/xsched.py: Paar CSE + scheduling + memoization by codec/submatrix
signature), lowered to a tape over a region arena whose regions are
the chunks' packets:

* on a CUDA card (`device=`, CUDA by default) `_run` packs the source
  chunks into a device arena and runs the tape with ONE launch of the
  `xor_sched` kernel's region entry (ops/xor_kernels.py).  Under
  CEPH_TPU_XSCHED=0, or for a matrix above `host_compile_allowed`, the
  naive rows become the tape (`xsched.naive_program`): the card is never
  left for numpy or for the kernel's plain version;
* with `device="cpu"` it runs exactly as the reference's codec does:
  the native tape (CEPH_TPU_NATIVE_XSCHED=0: the host tier over
  zero-copy packet views), or the naive row-walk under the kill switch
  or above the compile bound.

Decode inverts the surviving k*w x k*w bit submatrix
(models/bitmatrix.decode_bitmatrix) ONCE per (codec, erasure pattern)
PROCESS-wide, in ec/dispatch.py's shared signature-keyed cache.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Set

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec import dispatch, xsched
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError, to_int
from ceph_tpu_torch.models import bitmatrix as bmx
from ceph_tpu_torch.ops import xor_kernels

DEFAULT_PACKETSIZE = 2048


class ErasureCodeTorchBitmatrix(ErasureCode):
    """GF(2) bitmatrix RAID-6 codec (m = 2)."""

    TECHNIQUES = ("liberation", "blaum_roth", "liber8tion")

    def __init__(self, technique: str = "liberation", device=None) -> None:
        super().__init__()
        if technique not in self.TECHNIQUES:
            raise ErasureCodeError(2, f"unknown technique {technique}")
        self.technique = technique
        self.device = resolve_device(device)
        self.w = 7
        self.packetsize = DEFAULT_PACKETSIZE
        self.bitmatrix: np.ndarray | None = None
        self._sig: str | None = None

    def init(self, profile: Dict[str, str]) -> None:
        profile["technique"] = self.technique
        self.k = to_int("k", profile, "2")
        self.m = to_int("m", profile, "2")
        default_w = {"liberation": "7", "blaum_roth": "6",
                     "liber8tion": "8"}[self.technique]
        self.w = to_int("w", profile, default_w)
        self.packetsize = to_int("packetsize", profile,
                                 str(DEFAULT_PACKETSIZE))
        # parameter adjudication mirrors the reference's revert-with-
        # notice behavior (ErasureCodeJerasure.cc:432-513) as hard
        # errors: a silently-adjusted geometry would change placement
        if self.m != 2:
            raise ErasureCodeError(
                22, f"{self.technique}: m={self.m} must be 2")
        if self.technique == "liber8tion" and self.w != 8:
            raise ErasureCodeError(
                22, f"liber8tion: w={self.w} must be 8")
        if self.k > self.w:
            raise ErasureCodeError(
                22, f"{self.technique}: k={self.k} must be <= w={self.w}")
        self.sanity_check_k_m(self.k, self.m)
        mapping = profile.get("mapping")
        if mapping and len(mapping) != self.k + self.m:
            raise ErasureCodeError(
                22, f"mapping {mapping} maps {len(mapping)} chunks,"
                f" expected {self.k + self.m}")
        super().init(profile)
        try:
            if self.technique == "liberation":
                self.bitmatrix = bmx.liberation_bitmatrix(self.k, self.w)
            elif self.technique == "blaum_roth":
                self.bitmatrix = bmx.blaum_roth_bitmatrix(self.k, self.w)
            else:
                self.bitmatrix = bmx.liber8tion_bitmatrix(self.k)
        except ValueError as e:  # prime/bound violations
            raise ErasureCodeError(22, str(e))
        # process-stable codec identity: keys the shared decode-rows
        # cache AND the memoized XOR schedules
        self._sig = xsched.matrix_signature(
            self.bitmatrix,
            extra=f"{self.technique}/k{self.k}/w{self.w}")

    # -- geometry ----------------------------------------------------------

    def get_alignment(self) -> int:
        # every chunk must hold whole w-packet blocks
        return self.k * self.w * self.packetsize

    # -- packet math -------------------------------------------------------

    def _packets(self, arrs: np.ndarray) -> np.ndarray:
        """(n, chunk) -> (blocks, n*w, packetsize) packet stacks (the
        naive kill-switch path's layout)."""
        n, chunk = arrs.shape
        blk = self.w * self.packetsize
        assert chunk % blk == 0, (chunk, blk)
        b = chunk // blk
        return np.ascontiguousarray(
            arrs.reshape(n, b, self.w, self.packetsize)
            .transpose(1, 0, 2, 3)
            .reshape(b, n * self.w, self.packetsize))

    def _unpackets(self, pk: np.ndarray, n: int) -> np.ndarray:
        """(blocks, n*w, ps) -> (n, chunk) chunk bytes."""
        b = pk.shape[0]
        return np.ascontiguousarray(
            pk.reshape(b, n, self.w, self.packetsize)
            .transpose(1, 0, 2, 3)
            .reshape(n, b * self.w * self.packetsize))

    def _column_views(self, bufs: List) -> List[np.ndarray]:
        """Chunk buffers (logical order) -> the bitmatrix's input
        columns: column i*w + c is packet c of chunk i, each a
        zero-copy (blocks, packetsize) view over the caller's
        buffer."""
        cols: List[np.ndarray] = []
        for buf in bufs:
            cols.extend(bmx.packet_views(buf, self.w, self.packetsize))
        return cols

    def _pack_inputs(self, cols: np.ndarray, src_bufs: List) -> None:
        """Fill an arena's ``(n_in, blocks * packetsize)`` input regions
        from the source chunks.  When blocks == 1 a chunk's bytes ARE
        its w input regions back to back, so filling is one flat copy
        per chunk; multi-block chunks take one strided transpose-copy
        per chunk (block-major packets -> packet-major regions)."""
        w, ps = self.w, self.packetsize
        blocks = cols.shape[1] // ps
        if blocks == 1:
            flat = cols.reshape(len(src_bufs), w * ps)
            for i, src in enumerate(src_bufs):
                flat[i] = np.frombuffer(src, np.uint8)
        else:
            grid = cols.reshape(len(src_bufs), w, blocks, ps)
            for i, src in enumerate(src_bufs):
                grid[i] = (np.frombuffer(src, np.uint8)
                           .reshape(blocks, w, ps).transpose(1, 0, 2))

    def _unpack_outputs(self, rows: np.ndarray, dst_bufs: List) -> None:
        """Write an arena's ``(n_out, blocks * packetsize)`` output
        regions back into the destination chunk buffers (the inverse
        layout of `_pack_inputs`)."""
        w, ps = self.w, self.packetsize
        blocks = rows.shape[1] // ps
        if blocks == 1:
            flat = rows.reshape(len(dst_bufs), w * ps)
            for j, dst in enumerate(dst_bufs):
                np.frombuffer(dst, np.uint8)[...] = flat[j]
        else:
            grid = rows.reshape(len(dst_bufs), w, blocks, ps)
            for j, dst in enumerate(dst_bufs):
                (np.frombuffer(dst, np.uint8).reshape(blocks, w, ps)
                 )[...] = grid[j].transpose(1, 0, 2)

    def _run_device(self, prog, src_bufs: List, dst_bufs: List) -> None:
        """The tape over a device arena: the input regions staged from
        pinned memory with one copy, one launch of the region entry,
        the output regions back with one copy."""
        rbytes = len(src_bufs[0]) // self.w
        staged = torch.empty((prog.n_in, rbytes), dtype=torch.uint8,
                             pin_memory=self.device.type == "cuda")
        self._pack_inputs(staged.numpy(), src_bufs)
        arena = torch.empty((prog.n_regions, rbytes), dtype=torch.uint8,
                            device=self.device)
        arena[:prog.n_in].copy_(staged, non_blocking=True)
        xor_kernels.xor_sched_regions(prog, arena)
        self._unpack_outputs(arena[prog.out_base:].cpu().numpy(), dst_bufs)

    def _run(self, rows: np.ndarray, sched_sig: str,
             src_bufs: List, dst_bufs: List) -> None:
        """Execute `rows` over the source chunks into the destination
        chunks.  On the card: the compiled schedule's tape (or, under
        the kill switch or above the compile bound, the naive rows'
        tape) in one kernel launch.  On the CPU: the compiled XOR
        schedule lowered to ONE fused native tape run over a packed
        chunk arena (CEPH_TPU_NATIVE_XSCHED=0 falls back to the per-op
        host tier over zero-copy packet views, bit-identical), and the
        naive row-walk under the kill switch (the bit-exactness oracle)
        or when the matrix is too dense to compile on the serving path
        (host_compile_allowed — cached schedules aside, the pure-Python
        CSE must not stall the event loop on a pathological
        geometry)."""
        compile_ok = xsched.enabled() and xsched.host_compile_allowed(rows)
        if self.device.type == "cuda":
            prog = (xsched.lower_program(
                xsched.compile_matrix(rows, sig=sched_sig)) if compile_ok
                else xsched.naive_program(rows, sched_sig))
            self._run_device(prog, src_bufs, dst_bufs)
            return
        if compile_ok:
            sched = xsched.compile_matrix(rows, sig=sched_sig)
            if xsched.native_available():
                prog = xsched.lower_program(sched)
                rbytes = len(src_bufs[0]) // self.w
                arena = np.empty((prog.n_regions, rbytes), np.uint8)
                self._pack_inputs(arena[:prog.n_in], src_bufs)
                xsched.execute_native(prog, arena)
                self._unpack_outputs(arena[prog.out_base:], dst_bufs)
                return
            outs = self._column_views(dst_bufs)
            xsched.execute_host(sched, self._column_views(src_bufs),
                                outs)
            return
        data = np.stack([np.frombuffer(b, dtype=np.uint8)
                         for b in src_bufs])
        out = self._unpackets(
            xsched.naive_xor_matmul(rows, self._packets(data)),
            len(dst_bufs))
        for j, dst in enumerate(dst_bufs):
            dst[:] = out[j].data

    # -- interface kernels -------------------------------------------------

    def encode_chunks(self, want_to_encode: Set[int],
                      encoded: Dict[int, bytearray]) -> None:
        # buffers are keyed by on-disk POSITION (chunk_index); the
        # bitmatrix math lives in logical chunk space
        self._run(self.bitmatrix, self._sig,
                  [encoded[self.chunk_index(i)] for i in range(self.k)],
                  [encoded[self.chunk_index(self.k + j)]
                   for j in range(self.m)])

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Mapping[int, bytes],
                      decoded: Dict[int, bytearray]) -> None:
        n = self.k + self.m
        erasures = tuple(i for i in range(n)
                         if self.chunk_index(i) not in chunks)
        if not erasures:
            return
        have = tuple(i for i in range(n)
                     if self.chunk_index(i) in chunks)[:self.k]
        if len(have) < self.k:
            raise ErasureCodeError(5, "not enough chunks to decode")
        # the inverted submatrix is shared PROCESS-wide by codec
        # signature (ec/dispatch.py): a remounted pool's fresh codec
        # instance reuses this instance's inversions, and the decode
        # schedule below is memoized under the same key discipline
        key = (self._sig, have, erasures)
        rows = dispatch.shared_decode_rows(
            key,
            lambda: bmx.decode_bitmatrix(self.bitmatrix, self.k,
                                         self.w, have, erasures))
        self._run(rows, f"{self._sig}/d{have}/{erasures}",
                  [decoded[self.chunk_index(i)] for i in have],
                  [decoded[self.chunk_index(e)] for e in erasures])
