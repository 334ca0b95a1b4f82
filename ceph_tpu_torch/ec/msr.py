"""`ec_msr`, the product-matrix MSR regenerating codec (port of
ceph_tpu/ec/msr.py).

Construction: the product-matrix MSR code of Rashmi, Shah & Kumar at the
d = 2k-2 point (arXiv:1005.4178 §V).  Each chunk holds alpha = d-k+1
sub-chunks; single-chunk repair reads only beta = chunk/alpha bytes from
each of d helpers instead of k full chunks.

- message matrix M = [S1; S2] with S1, S2 symmetric alpha x alpha;
- encoding matrix Psi with rows psi_i = (1, x_i, ..., x_i^(2*alpha-1)),
  so Psi = [Phi, Lambda*Phi] with lambda_i = x_i^alpha, the x_i distinct
  and the x_i^alpha distinct too;
- node i stores psi_i @ M (alpha symbols);
- repair of node f: helper i ships (stored_i) @ phi_f^T; d of those
  invert to M @ phi_f^T, and the lost chunk is S1@phi_f^T +
  lambda_f * S2@phi_f^T by symmetry.

d > 2k-2 is reached by shortening: the (n+x, k+x, d+x) auxiliary code
with x = d-2k+2 phantom all-zero systematic nodes.  d < 2k-2 has no
product-matrix construction; such profiles take a plain Reed-Solomon
layout (alpha = 1), where repair is k-read decode and
supports_fractional_repair() is False.  A linear remapping, solved at
init, makes the code systematic.

On the device: encode and decode run through dispatch.gf_matmul, on
gf_matmul_gen, since no matrix here is registered.  The repair
projections and reconstructions run through dispatch.gf_repair_matmul,
as the reference's `_repair_matmul` does: on the `xor_sched` kernel
where the matrix's compiled XOR program wins by op count (plan.repair),
else on gf_matmul_gen.  The parity matrix is (m*alpha, k*alpha), (25,
25) at k=5 m=5 d=9, wider than one launch takes: plan tiles it.
"""


from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec import dispatch, plan
from ceph_tpu_torch.ec.interface import (SIMD_ALIGN, ErasureCode,
                                         ErasureCodeError, to_int)
from ceph_tpu_torch.models import reed_solomon as rs
from ceph_tpu_torch.ops import gf


def _gf_pow_vec(base: np.ndarray, n: int) -> np.ndarray:
    out = np.ones_like(base)
    for _ in range(n):
        out = gf.gf_mul(out, base)
    return out


class ErasureCodeMsr(ErasureCode):
    """Product-matrix MSR codec with fractional single-chunk repair."""

    technique = "product_matrix_msr"

    def __init__(self) -> None:
        super().__init__()
        self.w = 8
        self.d = 0
        self.alpha = 1
        self.sub_chunk_bytes = 0
        self._pm = False           # product-matrix mode (vs RS fallback)
        self._x = 0                # shortening: phantom systematic nodes
        self._psi: Optional[np.ndarray] = None   # (n+x, 2*alpha)
        self._phi: Optional[np.ndarray] = None   # (n+x, alpha)
        self._lam: Optional[np.ndarray] = None   # (n+x,)
        self.gen: Optional[np.ndarray] = None    # (n*alpha, k*alpha)
        self.parity_mat: Optional[np.ndarray] = None  # (m*alpha, k*alpha)
        self.device = None
        self._plan_sig: Optional[str] = None

    # -- init -------------------------------------------------------------

    def init(self, profile: Dict[str, str]) -> None:
        profile["technique"] = self.technique
        self.k = to_int("k", profile, "4")
        self.m = to_int("m", profile, "3")
        self.w = to_int("w", profile, "8")
        if self.w != 8:
            raise ErasureCodeError(22, "ec_msr supports w=8 only")
        self.sanity_check_k_m(self.k, self.m)
        n = self.k + self.m
        # d defaults to all surviving chunks — the most repair-frugal
        # point of the family (beta shrinks as d grows)
        self.d = to_int("d", profile, str(n - 1))
        if not self.k <= self.d <= n - 1:
            raise ErasureCodeError(
                22, f"d={self.d} must satisfy k <= d <= k+m-1")
        self.device = resolve_device(profile.get("device") or None)
        super().init(profile)
        self._prepare()

    def _prepare(self) -> None:
        self._x = self.d - 2 * self.k + 2
        self._pm = self._x >= 0
        if not self._pm:
            # no product-matrix point below d = 2k-2: plain RS layout,
            # repair degenerates to k-read decode (alpha stays 1)
            self.alpha = 1
            parity = rs.reed_sol_van_matrix(self.k, self.m)
            self.gen = np.vstack([
                np.eye(self.k, dtype=np.uint8), parity])
            self.parity_mat = np.ascontiguousarray(parity)
            return
        self.alpha = self.d - self.k + 1
        self._build_product_matrix()

    def _build_product_matrix(self) -> None:
        k, n, alpha, x = self.k, self.k + self.m, self.alpha, self._x
        n_aux = n + x                  # auxiliary code is (n+x, k+x, d+x)
        k_aux = k + x
        d_aux = 2 * alpha              # = d + x = 2*k_aux - 2
        xs: List[int] = []
        lams_seen: Set[int] = set()
        # greedy point selection: x_i distinct nonzero with x_i^alpha
        # distinct too (Psi any-d'-rows and the repair/reconstruction
        # theorems need both); c -> c^alpha has 255/gcd(alpha,255)
        # distinct images, so small alpha never runs dry for sane n
        for c in range(1, 256):
            lam = gf.gf_pow(c, alpha)
            if lam in lams_seen:
                continue
            lams_seen.add(lam)
            xs.append(c)
            if len(xs) == n_aux:
                break
        if len(xs) < n_aux:
            raise ErasureCodeError(
                22, f"k={k} m={self.m} d={self.d}: GF(256) has too few "
                f"product-matrix points for alpha={alpha}")
        pts = np.array(xs, dtype=np.uint8)
        self._psi = np.stack(
            [_gf_pow_vec(pts, j) for j in range(d_aux)], axis=1)
        self._phi = self._psi[:, :alpha]
        self._lam = _gf_pow_vec(pts, alpha)

        # systematic remapping: solve the k_aux*alpha constraints
        # "aux node i stores its own data" for the free symbols of
        # [S1; S2], then drop the phantom (all-zero) data columns
        node_rows = np.vstack(
            [self._aux_node_rows(i) for i in range(n_aux)])
        constraints = node_rows[:k_aux * alpha]
        try:
            inv = gf.gf_invert_matrix(constraints)
        except np.linalg.LinAlgError as e:
            raise ErasureCodeError(
                22, f"ec_msr constraint matrix singular: {e}")
        gen_aux = gf.gf_matmul_ref(node_rows, inv[:, x * alpha:])
        # phantoms must store zeros (their repair contribution is the
        # known-zero stream) and real data nodes must be systematic
        assert not gen_aux[:x * alpha].any(), "phantom rows not zero"
        assert np.array_equal(
            gen_aux[x * alpha:k_aux * alpha],
            np.eye(k * alpha, dtype=np.uint8)), "systematic block broken"
        self.gen = np.ascontiguousarray(gen_aux[x * alpha:])
        self.parity_mat = np.ascontiguousarray(self.gen[k * alpha:])

    def _aux_node_rows(self, i: int) -> np.ndarray:
        """(alpha, alpha*(alpha+1)) coefficients of aux node i's stored
        symbols over the free symbols of [S1; S2] (upper-triangle
        order, S1 block then S2 block): stored_i = phi_i@S1 +
        lambda_i*phi_i@S2 with S1/S2 symmetric."""
        alpha = self.alpha
        phi = self._phi[i]
        lam = int(self._lam[i])
        rows = np.zeros((alpha, alpha * (alpha + 1)), dtype=np.uint8)
        t = 0
        for scale in (1, lam):
            for p in range(alpha):
                for q in range(p, alpha):
                    if p == q:
                        rows[p, t] ^= gf.gf_mul(int(phi[p]), scale)
                    else:
                        rows[q, t] ^= gf.gf_mul(int(phi[p]), scale)
                        rows[p, t] ^= gf.gf_mul(int(phi[q]), scale)
                    t += 1
        return rows

    # -- geometry ---------------------------------------------------------

    def get_alignment(self) -> int:
        # chunk must split into alpha equal sub-chunks, each lane-wide
        return self.k * self.alpha * SIMD_ALIGN

    def get_sub_chunk_count(self) -> int:
        return self.alpha

    # -- capability surface ------------------------------------------------

    def supports_fractional_repair(self) -> bool:
        return self._pm and self.alpha > 1

    def repair_degree(self) -> int:
        return self.d

    def minimum_to_repair(self, lost: int, available: Set[int],
                          prefer: Optional[Sequence[int]] = None
                          ) -> Dict[int, List[tuple]]:
        """The d helpers (and the 1-of-alpha sub-chunk fraction each
        ships) for single-chunk repair — the fractional twin of
        minimum_to_decode.  `prefer` ranks the helper pool (the
        daemon passes its EWMA shard ranking)."""
        if not self.supports_fractional_repair():
            raise ErasureCodeError(95, "codec has no fractional repair")
        pool = [c for c in available if c != lost]
        if len(pool) < self.d:
            raise ErasureCodeError(
                5, f"need {self.d} helpers, have {len(pool)}")
        if prefer is not None:
            order = {c: i for i, c in enumerate(prefer)}
            pool.sort(key=lambda c: (order.get(c, len(order)), c))
        else:
            pool.sort()
        return {h: [(0, 1)] for h in pool[:self.d]}

    # -- kernels ----------------------------------------------------------

    def plan_signature(self) -> str:
        if self._plan_sig is None:
            self._plan_sig = plan.codec_signature(
                f"{self.technique}_d{self.d}", self.k, self.m, self.w,
                self.gen)
        return self._plan_sig

    def _matmul(self, mat: np.ndarray, data: np.ndarray) -> np.ndarray:
        return dispatch.gf_matmul(mat, data, self.device)

    def _repair_matmul(self, mat: np.ndarray,
                       data: np.ndarray) -> np.ndarray:
        return dispatch.gf_repair_matmul(mat, data, self.device)

    def _to_syms(self, data: np.ndarray) -> np.ndarray:
        """(..., R, C) chunks -> (..., R*alpha, C/alpha) sub-chunk
        symbol rows (sub-chunk a of chunk r is row r*alpha+a).

        Sub-chunks are byte-INTERLEAVED (symbol a holds the chunk
        bytes at positions == a mod alpha), not contiguous blocks:
        the interleave is invariant under concatenation and under any
        alpha-aligned slice, so the per-stripe interface path, the
        whole-stream batched path (ec_util feeds shard STREAMS as one
        batch column), and ranged chunk reads all see the same
        layout — chunk sizes are alpha-aligned by get_alignment."""
        c = data.shape[-1]
        if c % self.alpha:
            raise ErasureCodeError(
                22, f"chunk size {c} not divisible by alpha={self.alpha}")
        sc = c // self.alpha
        arr = np.moveaxis(
            data.reshape(data.shape[:-1] + (sc, self.alpha)), -1, -2)
        return np.ascontiguousarray(arr).reshape(
            data.shape[:-2] + (data.shape[-2] * self.alpha, sc))

    def _from_syms(self, syms: np.ndarray, rows: int) -> np.ndarray:
        sc = syms.shape[-1]
        lead = syms.shape[:-2]
        arr = np.moveaxis(
            np.asarray(syms).reshape(lead + (rows, self.alpha, sc)),
            -1, -2)
        return np.ascontiguousarray(arr).reshape(
            lead + (rows, self.alpha * sc))

    # -- encode / decode --------------------------------------------------

    def encode_chunks(self, want_to_encode: Set[int],
                      encoded: Dict[int, bytearray]) -> None:
        k, m = self.k, self.m
        data = np.stack([
            np.frombuffer(encoded[self.chunk_index(i)], dtype=np.uint8)
            for i in range(k)])
        syms = self._to_syms(data)
        parity = self._from_syms(
            np.ascontiguousarray(
                self._matmul(self.parity_mat, syms)), m)
        for j in range(m):
            encoded[self.chunk_index(k + j)][:] = parity[j].data

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Mapping[int, bytes],
                      decoded: Dict[int, bytearray]) -> None:
        k, m = self.k, self.m
        erasures = [i for i in range(k + m)
                    if self.chunk_index(i) not in chunks]
        if not erasures:
            return
        have = [i for i in range(k + m)
                if self.chunk_index(i) in chunks][:k]
        if len(have) < k:
            raise ErasureCodeError(5, "not enough chunks to decode")
        dmat = self._decode_matrix(tuple(have), tuple(erasures))
        src = self._to_syms(np.stack([
            np.frombuffer(decoded[self.chunk_index(i)], dtype=np.uint8)
            for i in have]))
        out = self._from_syms(
            np.ascontiguousarray(self._matmul(dmat, src)),
            len(erasures))
        for row, e in enumerate(erasures):
            decoded[self.chunk_index(e)][:] = out[row].data

    def _decode_matrix(self, have: tuple, erasures: tuple) -> np.ndarray:
        """(len(erasures)*alpha, k*alpha) rows mapping survivor symbols
        straight to erased symbols, shared across codec instances."""
        alpha = self.alpha

        def compute() -> np.ndarray:
            surv = np.vstack([
                self.gen[s * alpha:(s + 1) * alpha] for s in have])
            try:
                inv = gf.gf_invert_matrix(surv)
            except np.linalg.LinAlgError:
                raise ErasureCodeError(5, "survivor matrix singular")
            lost = np.vstack([
                self.gen[e * alpha:(e + 1) * alpha] for e in erasures])
            return np.ascontiguousarray(gf.gf_matmul_ref(lost, inv))

        return dispatch.shared_decode_rows(
            (self.plan_signature(), "dec", tuple(have), tuple(erasures)),
            compute)

    # -- batched API -------------------------------------------------------

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """(B, k, C) uint8 stripes -> (B, m, C) parity, one dispatch."""
        assert data.ndim == 3 and data.shape[1] == self.k
        return self._from_syms(
            self._matmul(self.parity_mat, self._to_syms(data)), self.m)

    def decode_batch(self, have: tuple, erasures: tuple,
                     survivors: np.ndarray) -> np.ndarray:
        """(B, k, C) surviving chunks (rows in `have` order) -> erased."""
        dmat = self._decode_matrix(tuple(have), tuple(erasures))
        return self._from_syms(
            self._matmul(dmat, self._to_syms(survivors)), len(erasures))

    # -- fractional repair -------------------------------------------------

    def repair_vector(self, lost: int) -> np.ndarray:
        """(alpha,) projection vector phi_f every helper applies to its
        own stored sub-chunks — identical across helpers."""
        if not self.supports_fractional_repair():
            raise ErasureCodeError(95, "codec has no fractional repair")
        if not 0 <= lost < self.k + self.m:
            raise ErasureCodeError(22, f"bad chunk id {lost}")
        return np.ascontiguousarray(self._phi[self._x + lost])

    def repair_project(self, lost: int, chunk) -> bytes:
        """Helper-side projection: a stored shard stream -> its beta =
        len/alpha byte repair fragment, one (1 x alpha) GF matmul.
        The byte-interleaved sub-chunk layout makes this independent
        of how many stripes the stream concatenates (fragment byte j
        covers stream bytes j*alpha..j*alpha+alpha-1), so helpers can
        project whole shard streams without knowing the stripe
        geometry."""
        data = np.frombuffer(chunk, dtype=np.uint8)
        syms = self._to_syms(data.reshape(1, 1, -1))  # (1, alpha, sc)
        vec = self.repair_vector(lost)[None, :]
        out = self._repair_matmul(vec, syms)
        # beta-byte wire fragment: the matmul result must materialize
        # once at the array -> bytes boundary (it is 1/alpha of the
        # shard, the bandwidth win, not a redundant copy)
        return np.ascontiguousarray(out).tobytes()

    def repair_matrix(self, lost: int,
                      helpers: Tuple[int, ...]) -> np.ndarray:
        """(alpha, d) reconstruction matrix mapping the d helper
        fragments (rows in `helpers` order) to the lost chunk's
        sub-chunks, cached per (codec, erasure pattern)."""
        if not self.supports_fractional_repair():
            raise ErasureCodeError(95, "codec has no fractional repair")
        helpers = tuple(helpers)
        if len(set(helpers)) != self.d or lost in helpers or \
                not all(0 <= h < self.k + self.m for h in helpers):
            raise ErasureCodeError(
                22, f"repair of {lost} needs {self.d} distinct helpers")

        def compute() -> np.ndarray:
            x, alpha = self._x, self.alpha
            lam_f = int(self._lam[x + lost])
            # phantom contributions are the zero stream, so only their
            # psi rows join the inversion; their columns of the result
            # multiply zeros and are dropped
            rows = list(range(x)) + [x + h for h in helpers]
            psi_sub = self._psi[rows]
            try:
                inv = gf.gf_invert_matrix(psi_sub)
            except np.linalg.LinAlgError:
                raise ErasureCodeError(5, "helper matrix singular")
            # stored_f = S1@phi_f + lambda_f * S2@phi_f; inv's top/bot
            # halves give S1@phi_f and S2@phi_f from the contributions
            combine = np.hstack([
                np.eye(alpha, dtype=np.uint8),
                gf.gf_mul(np.eye(alpha, dtype=np.uint8),
                          np.uint8(lam_f))])
            full = gf.gf_matmul_ref(combine, inv)   # (alpha, d+x)
            return np.ascontiguousarray(full[:, x:])

        return dispatch.shared_decode_rows(
            (self.plan_signature(), "rep", int(lost), helpers), compute)

    def repair_syms(self, lost: int, helpers: Tuple[int, ...],
                    fragments: np.ndarray) -> np.ndarray:
        """(d, S) stacked helper fragments (rows in `helpers` order,
        streams from many objects may be concatenated along S) ->
        (alpha, S) lost sub-chunk rows in one repair product."""
        rmat = self.repair_matrix(lost, helpers)
        return np.ascontiguousarray(self._repair_matmul(
            rmat, np.ascontiguousarray(fragments)))

    def repair_assemble(self, syms: np.ndarray) -> bytes:
        """(alpha, S) repaired sub-chunk rows -> the lost shard stream
        (byte j*alpha + a is row a, column j — the _to_syms byte
        interleave, valid for any stripe count)."""
        # the de-interleave transpose is a gather: contiguous output
        # bytes cannot be a view of the (alpha, S) row layout
        return np.ascontiguousarray(np.asarray(syms).T).tobytes()

    def repair(self, lost: int, fragments: Mapping[int, bytes]) -> bytes:
        """Primary-side reconstruction: {helper chunk id: beta-byte
        fragment} -> the lost shard stream, bit-exact vs full decode."""
        helpers = tuple(sorted(fragments))
        sizes = {len(fragments[h]) for h in helpers}
        if len(sizes) != 1:
            raise ErasureCodeError(22, "ragged helper fragments")
        frag = np.stack([
            np.frombuffer(fragments[h], dtype=np.uint8) for h in helpers])
        out = self.repair_syms(lost, helpers, frag)
        return self.repair_assemble(out)
