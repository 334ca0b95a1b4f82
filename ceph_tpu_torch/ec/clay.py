"""CLAY, the coupled-layer MSR regenerating code (k, m, d) (port of
ceph_tpu/ec/clay.py).

The reference's clay plugin (ErasureCodeClay.{h,cc}), after Vajha et al.,
"Clay Codes" (FAST'18):

- nodes live on a (q, t) grid, q = d-k+1, t = (k+m+nu)/q, with nu zero
  "shortening" nodes so that q | (k+m+nu); each chunk splits into
  sub_chunk_no = q^t sub-chunks, one per plane z in [0, q^t);
- a scalar MDS code (the port's ec_torch codec for jerasure/isa, or
  shec) encodes *uncoupled* planes; coupled chunks C relate to uncoupled
  U through a pairwise (2,2) MDS transform on symmetric node pairs (the
  PFT; cached 2x2 GF solves on the host, as in the JAX codec);
- encode = decode of the parity nodes from the data nodes; full decode
  walks planes in intersection-score order, converting coupled to
  uncoupled, MDS-decoding the planes, and recovering coupled values;
- single-node repair reads only sub_chunk_no/q sub-chunks from each of d
  helpers (is_repair, minimum_to_repair, get_repair_subchunks,
  repair_one_lost_chunk).

Sub-chunked reads surface through minimum_to_decode's (offset, count)
sub-chunk ranges.  The MDS sub-codec is built on the CLAY's device (the
profile's `device` key).  When it is an ErasureCodeTorch, every plane of
one intersection score goes to its decode_batch in one call (one
gf_matmul launch); any other scalar codec decodes plane by plane.
"""


from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Set, Tuple

import numpy as np

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError, to_int
from ceph_tpu_torch.ec.torch_plugin import ErasureCodeTorch
from ceph_tpu_torch.models import reed_solomon as rs
from ceph_tpu_torch.ops import gf


class ErasureCodeClay(ErasureCode):
    DEFAULT_K, DEFAULT_M = 4, 2

    def __init__(self) -> None:
        super().__init__()
        self.d = 0
        self.w = 8
        self.q = 0
        self.t = 0
        self.nu = 0
        self.sub_chunk_no = 0
        self.mds: Optional[ErasureCode] = None
        self.pft_matrix: Optional[np.ndarray] = None  # (2,2) scalar code
        self._pft_inv_cache: Dict[Tuple[int, int], np.ndarray] = {}
        self.device = None

    # -- init -------------------------------------------------------------

    def init(self, profile: Dict[str, str]) -> None:
        self.device = resolve_device(profile.get("device") or None)
        self.k = to_int("k", profile, str(self.DEFAULT_K))
        self.m = to_int("m", profile, str(self.DEFAULT_M))
        self.sanity_check_k_m(self.k, self.m)
        self.d = to_int("d", profile, str(self.k + self.m - 1))
        if not (self.k <= self.d <= self.k + self.m - 1):
            raise ErasureCodeError(
                22, f"value of d {self.d} must be within"
                f" [{self.k},{self.k + self.m - 1}]")

        scalar_mds = profile.get("scalar_mds") or "jerasure"
        if scalar_mds not in ("jerasure", "isa", "shec"):
            raise ErasureCodeError(
                22, f"scalar_mds {scalar_mds} is not currently supported,"
                " use one of 'jerasure', 'isa', 'shec'")
        technique = profile.get("technique") or (
            "reed_sol_van" if scalar_mds in ("jerasure", "isa") else "single")

        self.q = self.d - self.k + 1
        self.nu = (self.q - (self.k + self.m) % self.q) % self.q
        if self.k + self.m + self.nu > 254:
            raise ErasureCodeError(22, "k + m + nu must be <= 254")
        self.t = (self.k + self.m + self.nu) // self.q
        self.sub_chunk_no = self.q ** self.t

        from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

        mds_profile = {"plugin": scalar_mds, "technique": technique,
                       "k": str(self.k + self.nu), "m": str(self.m),
                       "w": "8", "device": str(self.device)}
        if scalar_mds == "shec":
            mds_profile["c"] = "2"
        self.mds = ErasureCodePluginRegistry.instance().factory(
            scalar_mds, mds_profile)
        self.pft_matrix = rs.reed_sol_van_matrix(2, 2)
        self._pft_inv_cache.clear()
        super().init(profile)

    # -- geometry ---------------------------------------------------------

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_alignment(self) -> int:
        # sub_chunk_no * k * (scalar-code alignment unit)
        # (ErasureCodeClay::get_chunk_size :— pft chunk of a 1-byte object)
        return self.sub_chunk_no * self.k * 32

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.get_alignment()
        padded = -(-object_size // alignment) * alignment
        return padded // self.k

    # -- plane helpers ----------------------------------------------------

    def _plane_vector(self, z: int) -> List[int]:
        out = [0] * self.t
        for i in range(self.t):
            out[self.t - 1 - i] = z % self.q
            z //= self.q
        return out

    def _z_sw(self, x: int, y: int, z: int, z_vec: List[int]) -> int:
        return z + (x - z_vec[y]) * self.q ** (self.t - 1 - y)

    # -- pairwise (2,2) transform -----------------------------------------
    #
    # Canonical 4-row generator over the coupled pair (A, B):
    # rows 0,1 = identity (the coupled values), rows 2,3 = the scalar
    # (2,2) parity rows (the uncoupled values).  Slot 0/2 belong to the
    # pair member with the LARGER x coordinate (the i0/i2 swap in the
    # reference).

    def _pft_rows(self) -> np.ndarray:
        ident = np.eye(2, dtype=np.uint8)
        return np.concatenate([ident, self.pft_matrix], axis=0)

    def _pft_solve(self, known: Dict[int, np.ndarray],
                   want: List[int]) -> Dict[int, np.ndarray]:
        rows = self._pft_rows()
        ki = tuple(sorted(known))[:2]
        inv = self._pft_inv_cache.get(ki)
        if inv is None:
            inv = gf.gf_invert_matrix(rows[list(ki)])
            self._pft_inv_cache[ki] = inv
        vals = np.stack([known[i] for i in ki])
        ab = gf.gf_matmul_ref(inv, vals)
        out = gf.gf_matmul_ref(rows[list(want)], ab)
        return {w: out[i] for i, w in enumerate(want)}

    def _pair_slots(self, x: int, y: int, z: int, z_vec: List[int]):
        """-> ((node_xy, z), (node_sw, z_sw), swapped) with slot order."""
        node_xy = y * self.q + x
        node_sw = y * self.q + z_vec[y]
        z_sw = self._z_sw(x, y, z, z_vec)
        swapped = z_vec[y] > x  # node_xy takes slots 1/3 instead of 0/2
        return node_xy, node_sw, z_sw, swapped

    # -- coupled <-> uncoupled conversions (per plane) --------------------

    def _uncoupled_from_coupled(self, C, U, x, y, z, z_vec):
        node_xy, node_sw, z_sw, swapped = self._pair_slots(x, y, z, z_vec)
        i0, i2 = (1, 3) if swapped else (0, 2)
        i1, i3 = 1 - i0, 5 - i2
        out = self._pft_solve(
            {i0: C[node_xy][z], i1: C[node_sw][z_sw]}, [i2, i3])
        U[node_xy][z] = out[i2]
        U[node_sw][z_sw] = out[i3]

    def _coupled_from_uncoupled(self, C, U, x, y, z, z_vec):
        node_xy, node_sw, z_sw, _sw = self._pair_slots(x, y, z, z_vec)
        # only called with z_vec[y] < x: node_xy is slot 0
        out = self._pft_solve(
            {2: U[node_xy][z], 3: U[node_sw][z_sw]}, [0, 1])
        C[node_xy][z] = out[0]
        C[node_sw][z_sw] = out[1]

    def _recover_type1(self, C, U, x, y, z, z_vec):
        node_xy, node_sw, z_sw, swapped = self._pair_slots(x, y, z, z_vec)
        i0, i2 = (1, 3) if swapped else (0, 2)
        i1 = 1 - i0
        out = self._pft_solve(
            {i1: C[node_sw][z_sw], i2: U[node_xy][z]}, [i0])
        C[node_xy][z] = out[i0]

    # -- MDS over uncoupled planes ----------------------------------------

    def _decode_uncoupled(self, erasures: Set[int], z: int, U) -> None:
        """MDS-decode plane z of U for the erased nodes."""
        self._decode_uncoupled_planes(erasures, [z], U)

    def _decode_uncoupled_planes(self, erasures: Set[int],
                                 planes: List[int], U) -> None:
        """Batch-decode several planes sharing one erasure set: one decode
        matrix, one (B, k, S) device dispatch (the reference loops planes
        one decode_chunks call each, ErasureCodeClay.cc:743-761)."""
        n = self.q * self.t
        if isinstance(self.mds, ErasureCodeTorch):
            have = tuple(i for i in range(n) if i not in erasures)[
                :self.mds.k]
            erased = tuple(sorted(erasures))
            survivors = np.stack(
                [[U[i][z] for i in have] for z in planes])
            out = self.mds.decode_batch(have, erased, survivors)
            for b, z in enumerate(planes):
                for row, e in enumerate(erased):
                    U[e][z] = out[b, row]
            return
        # generic scalar codec: per-plane through the bytes interface
        # (plane rows pass as contiguous views; bytearray() owns the
        # one copy the scratch buffers genuinely need)
        for z in planes:
            sc = U[0].shape[1]
            chunks = {i: np.ascontiguousarray(U[i][z]).data
                      for i in range(n) if i not in erasures}
            decoded = {i: bytearray(np.ascontiguousarray(U[i][z]))
                       for i in range(n)}
            self.mds.decode_chunks(set(erasures), chunks, decoded)
            for i in erasures:
                U[i][z] = np.frombuffer(decoded[i],
                                        dtype=np.uint8)[:sc]

    # -- layered decode (the heart; encode routes through it too) ---------

    def _decode_layered(self, erased_chunks: Set[int], C: Dict[int, np.ndarray]):
        q, t = self.q, self.t
        erased = set(erased_chunks)
        for i in range(self.k + self.nu, q * t):
            if len(erased) >= self.m:
                break
            erased.add(i)
        if len(erased) != self.m:
            raise ErasureCodeError(
                5, f"{len(erased_chunks)} erasures exceed m={self.m}")

        sc = C[0].shape[1]
        U = {i: np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
             for i in range(q * t)}

        order = [0] * self.sub_chunk_no
        for z in range(self.sub_chunk_no):
            z_vec = self._plane_vector(z)
            order[z] = sum(1 for i in erased if i % q == z_vec[i // q])
        max_iscore = len({i // q for i in erased})

        for iscore in range(max_iscore + 1):
            planes = [z for z in range(self.sub_chunk_no)
                      if order[z] == iscore]
            if not planes:
                continue
            for z in planes:
                self._fill_uncoupled(erased, z, C, U)
            self._decode_uncoupled_planes(erased, planes, U)
            for z in planes:
                z_vec = self._plane_vector(z)
                for node_xy in erased:
                    x, y = node_xy % q, node_xy // q
                    node_sw = y * q + z_vec[y]
                    if z_vec[y] != x:
                        if node_sw not in erased:
                            self._recover_type1(C, U, x, y, z, z_vec)
                        elif z_vec[y] < x:
                            self._coupled_from_uncoupled(C, U, x, y, z, z_vec)
                    else:  # hole-dot pair: C == U
                        C[node_xy][z] = U[node_xy][z]

    def _fill_uncoupled(self, erased: Set[int], z: int, C, U) -> None:
        """Coupled -> uncoupled for the known nodes of one plane."""
        q, t = self.q, self.t
        z_vec = self._plane_vector(z)
        for x in range(q):
            for y in range(t):
                node_xy = q * y + x
                node_sw = q * y + z_vec[y]
                if node_xy in erased:
                    continue
                if z_vec[y] < x:
                    self._uncoupled_from_coupled(C, U, x, y, z, z_vec)
                elif z_vec[y] == x:
                    U[node_xy][z] = C[node_xy][z]
                else:
                    if node_sw in erased:
                        self._uncoupled_from_coupled(C, U, x, y, z, z_vec)

    def _decode_erasures(self, erased: Set[int], z: int, C, U) -> None:
        self._fill_uncoupled(erased, z, C, U)
        self._decode_uncoupled(erased, z, U)

    # -- interface: encode / decode ---------------------------------------

    def _node_arrays(self, encoded: Mapping[int, bytearray]) -> Dict[int, np.ndarray]:
        """Chunk buffers -> per-node (sub_chunk_no, sc) plane arrays, with
        nu zero shortening nodes spliced in at [k, k+nu)."""
        chunk_size = len(encoded[0])
        if chunk_size % self.sub_chunk_no:
            raise ErasureCodeError(
                22, f"chunk size {chunk_size} not divisible by"
                f" sub_chunk_no {self.sub_chunk_no}")
        sc = chunk_size // self.sub_chunk_no
        C: Dict[int, np.ndarray] = {}
        for i in range(self.k + self.m):
            node = i if i < self.k else i + self.nu
            # ONE copy (the .copy(): C is a mutable working set); the
            # old bytes() wrapper paid a second whole-chunk copy first
            C[node] = np.frombuffer(
                encoded[i], dtype=np.uint8).reshape(
                    self.sub_chunk_no, sc).copy()
        for i in range(self.k, self.k + self.nu):
            C[i] = np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
        return C

    def encode_chunks(self, want_to_encode: Set[int],
                      encoded: Dict[int, bytearray]) -> None:
        C = self._node_arrays(encoded)
        parity_nodes = {i + self.nu for i in
                        range(self.k, self.k + self.m)}
        self._decode_layered(parity_nodes, C)
        for i in range(self.k, self.k + self.m):
            encoded[i][:] = np.ascontiguousarray(
                C[i + self.nu]).reshape(-1).data

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Mapping[int, bytes],
                      decoded: Dict[int, bytearray]) -> None:
        erasures = {(i if i < self.k else i + self.nu)
                    for i in range(self.k + self.m) if i not in chunks}
        C = self._node_arrays(decoded)
        self._decode_layered(erasures, C)
        for i in range(self.k + self.m):
            node = i if i < self.k else i + self.nu
            decoded[i][:] = np.ascontiguousarray(
                C[node]).reshape(-1).data

    # -- repair (the MSR selling point) -----------------------------------

    def is_repair(self, want_to_read: Set[int],
                  available_chunks: Set[int]) -> bool:
        if set(want_to_read) <= set(available_chunks):
            return False
        if len(want_to_read) > 1:
            return False
        i = next(iter(want_to_read))
        lost = i if i < self.k else i + self.nu
        for x in range(self.q):
            node = (lost // self.q) * self.q + x
            node = node if node < self.k else node - self.nu
            if node != i and 0 <= node < self.k + self.m:
                if node not in available_chunks:
                    return False
        return len(available_chunks) >= self.d

    def get_repair_subchunks(self, lost_node: int) -> List[Tuple[int, int]]:
        """(offset, count) sub-chunk runs each helper must read."""
        y, x = lost_node // self.q, lost_node % self.q
        seq = self.q ** (self.t - 1 - y)
        out = []
        index = x * seq
        for _ in range(self.q ** y):
            out.append((index, seq))
            index += self.q * seq
        return out

    def get_repair_sub_chunk_count(self, want_to_read: Set[int]) -> int:
        weight = [0] * self.t
        for i in want_to_read:
            weight[i // self.q] += 1
        untouched = 1
        for y in range(self.t):
            untouched *= self.q - weight[y]
        return self.sub_chunk_no - untouched

    def minimum_to_decode(self, want_to_read: Set[int],
                          available_chunks: Set[int]
                          ) -> Dict[int, List[Tuple[int, int]]]:
        if self.is_repair(set(want_to_read), set(available_chunks)):
            return self._minimum_to_repair(set(want_to_read),
                                           set(available_chunks))
        ids = self._minimum_to_decode(set(want_to_read),
                                      set(available_chunks))
        return {i: [(0, self.sub_chunk_no)] for i in ids}

    def _minimum_to_repair(self, want_to_read: Set[int],
                           available_chunks: Set[int]
                           ) -> Dict[int, List[Tuple[int, int]]]:
        i = next(iter(want_to_read))
        lost = i if i < self.k else i + self.nu
        sub_ind = self.get_repair_subchunks(lost)
        minimum: Dict[int, List[Tuple[int, int]]] = {}
        for j in range(self.q):
            node = (lost // self.q) * self.q + j
            if j == lost % self.q:
                continue
            if node < self.k:
                minimum[node] = list(sub_ind)
            elif node >= self.k + self.nu:
                minimum[node - self.nu] = list(sub_ind)
        for chunk in sorted(available_chunks):
            if len(minimum) >= self.d:
                break
            minimum.setdefault(chunk, list(sub_ind))
        assert len(minimum) == self.d
        return minimum

    def decode(self, want_to_read, chunks: Mapping[int, bytes],
               chunk_size: Optional[int] = None) -> Dict[int, bytes]:
        want = set(want_to_read)
        avail = set(chunks)
        if chunks and chunk_size and self.is_repair(want, avail) and \
                chunk_size > len(next(iter(chunks.values()))):
            return self._repair(want, chunks, chunk_size)
        return super().decode(want, chunks, chunk_size)

    def _repair(self, want_to_read: Set[int],
                chunks: Mapping[int, bytes],
                chunk_size: int) -> Dict[int, bytes]:
        """Bandwidth-optimal single-node repair from d partial helper
        reads (repair_one_lost_chunk)."""
        assert len(want_to_read) == 1 and len(chunks) == self.d
        q, t = self.q, self.t
        lost_i = next(iter(want_to_read))
        lost = lost_i if lost_i < self.k else lost_i + self.nu

        repair_subchunks = self.sub_chunk_no // q
        repair_blocksize = len(next(iter(chunks.values())))
        assert repair_blocksize % repair_subchunks == 0
        sc = repair_blocksize // repair_subchunks
        assert chunk_size == self.sub_chunk_no * sc

        sub_ind = self.get_repair_subchunks(lost)
        repair_planes = [z for (index, count) in sub_ind
                         for z in range(index, index + count)]
        plane_to_ind = {z: i for i, z in enumerate(repair_planes)}

        # helpers hold only the repair planes, (repair_subchunks, sc)
        helper: Dict[int, np.ndarray] = {}
        aloof: Set[int] = set()
        for i in range(self.k + self.m):
            node = i if i < self.k else i + self.nu
            if i in chunks:
                helper[node] = np.frombuffer(
                    chunks[i], dtype=np.uint8).reshape(
                        repair_subchunks, sc)
            elif i != lost_i:
                aloof.add(node)
        for i in range(self.k, self.k + self.nu):
            helper[i] = np.zeros((repair_subchunks, sc), dtype=np.uint8)
        assert len(helper) + len(aloof) + 1 == q * t

        recovered = np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
        U = {i: np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
             for i in range(q * t)}

        erasures = {lost - lost % q + i for i in range(q)} | aloof
        assert len(erasures) <= self.m + q - 1

        # order repair planes by intersection score across lost+aloof
        ordered: Dict[int, List[int]] = {}
        for z in repair_planes:
            z_vec = self._plane_vector(z)
            score = sum(1 for node in ({lost} | aloof)
                        if node % q == z_vec[node // q])
            assert score > 0
            ordered.setdefault(score, []).append(z)

        for score in sorted(ordered):
            for z in ordered[score]:
                z_vec = self._plane_vector(z)
                # fill uncoupled values for all non-erased nodes
                for y in range(t):
                    for x in range(q):
                        node_xy = y * q + x
                        if node_xy in erasures:
                            continue
                        node_sw = y * q + z_vec[y]
                        z_sw = self._z_sw(x, y, z, z_vec)
                        swapped = z_vec[y] > x
                        i0, i2 = (1, 3) if swapped else (0, 2)
                        i1, i3 = 1 - i0, 5 - i2
                        if node_sw in aloof:
                            out = self._pft_solve(
                                {i0: helper[node_xy][plane_to_ind[z]],
                                 i3: U[node_sw][z_sw]}, [i2])
                            U[node_xy][z] = out[i2]
                        elif z_vec[y] != x:
                            out = self._pft_solve(
                                {i0: helper[node_xy][plane_to_ind[z]],
                                 i1: helper[node_sw][plane_to_ind[z_sw]]},
                                [i2])
                            U[node_xy][z] = out[i2]
                        else:
                            U[node_xy][z] = helper[node_xy][plane_to_ind[z]]
                assert len(erasures) <= self.m
                self._decode_uncoupled(erasures, z, U)
                # recover coupled values of erased nodes on this plane
                for node in erasures:
                    x, y = node % q, node // q
                    node_sw = y * q + z_vec[y]
                    z_sw = self._z_sw(x, y, z, z_vec)
                    if node in aloof:
                        continue
                    if x == z_vec[y]:  # hole-dot pair
                        recovered[z] = U[node][z]
                    else:
                        assert y == lost // q and node_sw == lost
                        swapped = z_vec[y] > x
                        i0, i2 = (1, 3) if swapped else (0, 2)
                        i1 = 1 - i0
                        out = self._pft_solve(
                            {i0: helper[node][plane_to_ind[z]],
                             i2: U[node][z]}, [i1])
                        recovered[z_sw] = out[i1]

        recovered = np.ascontiguousarray(recovered)
        recovered.setflags(write=False)
        return {lost_i: recovered.reshape(-1).data}
