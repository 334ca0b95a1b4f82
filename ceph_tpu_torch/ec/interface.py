"""Erasure-code interface (port of ceph_tpu/ec/interface.py).

Mirrors ceph::ErasureCodeInterface and the shared base class
ceph::ErasureCode:

- profiles are string->string maps; unknown keys are preserved and echoed;
- object -> chunk layout: chunk B/C of the padded object at offset B%C;
- padding: the object is zero-padded to a multiple of the technique
  alignment; trailing data chunks may be entirely padding;
- chunk remapping via the profile's `mapping=DD_D...` string;
- minimum_to_decode: want if available, else first k available chunks;
- sanity: k >= 2, m >= 1.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Set

ErasureCodeProfile = Dict[str, str]

SIMD_ALIGN = 32  # the reference's memory alignment, kept for layout math


def _freeze(buf) -> memoryview:
    """Read-only zero-copy view of a locally owned buffer the caller
    will never touch again (the encode/decode scratch buffers below)."""
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    return mv.toreadonly()


class ErasureCodeError(Exception):
    def __init__(self, errno_: int, msg: str):
        super().__init__(msg)
        self.errno = errno_


def to_int(name: str, profile: ErasureCodeProfile, default: str) -> int:
    if not profile.get(name):
        profile[name] = default
    try:
        return int(profile[name])
    except ValueError:
        raise ErasureCodeError(22, f"could not convert {name}={profile[name]} to int")


def to_bool(name: str, profile: ErasureCodeProfile, default: str) -> bool:
    if not profile.get(name):
        profile[name] = default
    return profile[name].lower() in ("true", "1", "yes")


class ErasureCode:
    """Base codec: profile plumbing, chunk layout, padding, decode scaffolding."""

    def __init__(self) -> None:
        self.k = 0
        self.m = 0
        self.chunk_mapping: List[int] = []
        self._profile: ErasureCodeProfile = {}
        self.rule_root = "default"
        self.rule_failure_domain = "host"
        self.rule_device_class = ""

    # -- profile / init ---------------------------------------------------

    def init(self, profile: ErasureCodeProfile) -> None:
        self.rule_root = profile.setdefault("crush-root", "default")
        self.rule_failure_domain = profile.setdefault("crush-failure-domain", "host")
        self.rule_device_class = profile.setdefault("crush-device-class", "")
        self._to_mapping(profile)
        self._profile = profile

    def get_profile(self) -> ErasureCodeProfile:
        return self._profile

    def _to_mapping(self, profile: ErasureCodeProfile) -> None:
        mapping = profile.get("mapping")
        if mapping:
            data, coding = [], []
            for position, ch in enumerate(mapping):
                (data if ch == "D" else coding).append(position)
            self.chunk_mapping = data + coding

    @staticmethod
    def sanity_check_k_m(k: int, m: int) -> None:
        if k < 2:
            raise ErasureCodeError(22, f"k={k} must be >= 2")
        if m < 1:
            raise ErasureCodeError(22, f"m={m} must be >= 1")

    # -- geometry ---------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_coding_chunk_count(self) -> int:
        return self.m

    def get_sub_chunk_count(self) -> int:
        return 1

    def get_alignment(self) -> int:
        raise NotImplementedError

    def get_chunk_size(self, object_size: int) -> int:
        """Padded-object chunk size (ErasureCodeJerasure::get_chunk_size)."""
        alignment = self.get_alignment()
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    def chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if i < len(self.chunk_mapping) else i

    def get_chunk_mapping(self) -> List[int]:
        return self.chunk_mapping

    def supports_fractional_repair(self) -> bool:
        """True when the codec can rebuild one lost chunk from sub-chunk
        fractions of d >= k helpers (minimum_to_repair / repair_project /
        repair) instead of k full chunks."""
        return False

    # -- decode planning --------------------------------------------------

    def _minimum_to_decode(self, want_to_read: Set[int],
                           available_chunks: Set[int]) -> Set[int]:
        if want_to_read <= available_chunks:
            return set(want_to_read)
        k = self.get_data_chunk_count()
        if len(available_chunks) < k:
            raise ErasureCodeError(5, "not enough chunks to decode")
        return set(sorted(available_chunks)[:k])

    def minimum_to_decode(self, want_to_read: Set[int],
                          available_chunks: Set[int]
                          ) -> Dict[int, List[tuple]]:
        ids = self._minimum_to_decode(want_to_read, available_chunks)
        sub = [(0, self.get_sub_chunk_count())]
        return {i: list(sub) for i in ids}

    def minimum_to_decode_with_cost(self, want_to_read: Set[int],
                                    available: Mapping[int, int]) -> Set[int]:
        return self._minimum_to_decode(want_to_read, set(available))

    # -- encode / decode --------------------------------------------------

    def encode_prepare(self, raw: bytes) -> Dict[int, bytearray]:
        """Split + zero-pad into k data chunks, allocate m parity chunks."""
        k, m = self.k, self.m
        blocksize = self.get_chunk_size(len(raw))
        padded_chunks = k - len(raw) // blocksize
        encoded: Dict[int, bytearray] = {}
        for i in range(k - padded_chunks):
            encoded[self.chunk_index(i)] = bytearray(
                raw[i * blocksize : (i + 1) * blocksize])
        if padded_chunks:
            remainder = len(raw) - (k - padded_chunks) * blocksize
            buf = bytearray(blocksize)
            buf[:remainder] = raw[(k - padded_chunks) * blocksize :]
            encoded[self.chunk_index(k - padded_chunks)] = buf
            for i in range(k - padded_chunks + 1, k):
                encoded[self.chunk_index(i)] = bytearray(blocksize)
        for i in range(k, k + m):
            encoded[self.chunk_index(i)] = bytearray(blocksize)
        return encoded

    def encode_chunks(self, want_to_encode: Set[int],
                      encoded: Dict[int, bytearray]) -> None:
        raise NotImplementedError

    def encode(self, want_to_encode: Iterable[int],
               data: bytes) -> Dict[int, bytes]:
        want = set(want_to_encode)
        encoded = self.encode_prepare(data)
        self.encode_chunks(want, encoded)
        return {i: _freeze(b) for i, b in encoded.items()
                if i in want}

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Mapping[int, bytes],
                      decoded: Dict[int, bytearray]) -> None:
        raise NotImplementedError

    def decode(self, want_to_read: Iterable[int],
               chunks: Mapping[int, bytes],
               chunk_size: Optional[int] = None) -> Dict[int, bytes]:
        want = set(want_to_read)
        if want <= set(chunks):
            # nothing to decode: pass the caller's buffers through
            return {i: chunks[i] if isinstance(chunks[i], bytes)
                    else _freeze(chunks[i]) for i in want}
        if not chunks:
            raise ErasureCodeError(5, "no chunks to decode from")
        blocksize = len(next(iter(chunks.values())))
        decoded: Dict[int, bytearray] = {}
        for i in range(self.k + self.m):
            if i in chunks:
                decoded[i] = bytearray(chunks[i])
            else:
                decoded[i] = bytearray(blocksize)
        self.decode_chunks(want, chunks, decoded)
        return {i: _freeze(decoded[i]) for i in want}

    def decode_concat(self, chunks: Mapping[int, bytes]) -> bytes:
        """Reassemble data payload in chunk_mapping order (decode_concat)."""
        want = {self.chunk_index(i) for i in range(self.get_data_chunk_count())}
        decoded = self.decode(want, chunks)
        out = bytearray()
        for i in range(self.get_data_chunk_count()):
            out += decoded[self.chunk_index(i)]
        return _freeze(out)

    # -- CRUSH integration --------------------------------------------------

    def create_rule(self, name: str, crush) -> int:
        """Add the pool's erasure rule to a port CrushMap: TAKE the
        profile's crush-root, CHOOSELEAF INDEP over its failure domain,
        EMIT; -> the rule number (-17 if the name exists)."""
        return crush.add_simple_rule(
            name, self.rule_root, self.rule_failure_domain,
            self.rule_device_class, "indep", pool_type="erasure")
