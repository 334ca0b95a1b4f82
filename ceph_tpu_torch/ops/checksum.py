"""crc32c (Castagnoli): host numpy and batched PyTorch (port of
ceph_tpu/ops/checksum.py).

Reference semantics: `ceph_crc32c(seed, data, len)` with no pre/post
inversion, NULL data meaning a run of zeros, and `ceph_crc32c_zeros`
O(log n) zero-run folding.

Host path: `crc32c` runs the native crc of native/src/crc32c.cc (a copy
of the JAX package's; SSE4.2 three-lane where the CPU has it) for
bytes-like data.  `crc32c_numpy` is its oracle: table-driven numpy,
vectorised across rows.  A buffer is
front-padded with zeros to whole rows (leading zeros leave a zero-seeded
crc unchanged), each row's zero-seeded crc is computed with the
slicing-by-4 tables one word column at a time across all rows, and the
row crcs fold in a log-depth tree with the zero-advance matrices
(crc(A||B) = Z_|B|(crc(A)) ^ crc(B)).  The seed enters last, as
crc32c_zeros(seed, len) XORed in.

Per-block host checksums for stored blobs (`crc32c_blocks`, and `xxh32` /
`xxh64` on the native library of ceph_tpu_torch/native, with pure-Python
twins `_py_xxh32` / `_py_xxh64` as their plain versions) serve
common/checksummer.py.

Batched PyTorch path (`crc32c_batch` and its helpers): the GF(2)
bit-matrix formulation of the JAX module, the plain version of the CUDA
kernel in ops/crc_kernels.py.  Each block splits into 64-byte cells whose
bits multiply a (512 -> 32) matrix, and a tree of 32x32 zero-advance
products folds the cells.

uint32 crcs travel through torch as int32 bit patterns (torch's uint32
support is thin); `.numpy().view(np.uint32)` recovers them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ceph_tpu_torch import native

CASTAGNOLI_POLY_REFLECTED = 0x82F63B78

# ---------------------------------------------------------------------------
# Host path (numpy)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _tables() -> np.ndarray:
    """(4, 256) uint32 slicing-by-4 tables; row 0 is the bytewise table."""
    tab = np.zeros((4, 256), dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (CASTAGNOLI_POLY_REFLECTED ^ (c >> 1)) if (c & 1) else (c >> 1)
        tab[0, i] = c
    for k in range(1, 4):
        tab[k] = (tab[k - 1] >> 8) ^ tab[0][tab[k - 1] & 0xFF]
    return tab


@functools.lru_cache(maxsize=None)
def _zero_mats() -> list:
    # mats[r] advances a crc through 2^r zero bytes; GF(2) column form.
    table = _tables()[0]
    one = [int(table[(1 << b) & 0xFF]) ^ ((1 << b) >> 8) for b in range(32)]
    mats = [one]
    for _ in range(1, 64):
        prev = mats[-1]
        mats.append([_mat_vec(prev, col) for col in prev])
    return mats


def _mat_vec(mat: list, v: int) -> int:
    out = 0
    b = 0
    while v:
        if v & 1:
            out ^= mat[b]
        v >>= 1
        b += 1
    return out


def crc32c_zeros(crc: int, length: int) -> int:
    """Advance crc through `length` zero bytes in O(log length)."""
    mats = _zero_mats()
    r = 0
    crc &= 0xFFFFFFFF
    while length:
        if length & 1:
            crc = _mat_vec(mats[r], crc)
        length >>= 1
        r += 1
    return crc


def crc32c_combine(crc_a: int, crc_b: int, len_b: int) -> int:
    """crc(A||B) from crc(A)=crc_a and the zero-seeded crc(B)=crc_b."""
    return crc32c_zeros(crc_a, len_b) ^ crc_b


@functools.lru_cache(maxsize=256)
def advance_columns(length: int) -> np.ndarray:
    """(32,) uint32: column b is the crc bit b becomes after `length`
    zero bytes (the 32x32 zero-advance matrix in column form)."""
    return np.array([crc32c_zeros(1 << b, length) for b in range(32)],
                    dtype=np.uint32)


def advance(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Apply a zero-advance matrix (columns `cols`) to every crc in v."""
    v = np.asarray(v, dtype=np.uint32)
    out = np.zeros_like(v)
    for b in range(32):
        out ^= ((v >> np.uint32(b)) & np.uint32(1)) * cols[b]
    return out


_ROW = 1024  # bytes per row of the vectorised host crc


def crc32c_rows(rows: np.ndarray) -> np.ndarray:
    """Zero-seeded crc32c of every row of an (N, L) uint8 array, L % 4
    == 0: one slicing-by-4 step per word column, across all rows."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    n, length = rows.shape
    if length % 4:
        raise ValueError(f"row length {length} is not a multiple of 4")
    tab = _tables()
    words = rows.view("<u4")
    crc = np.zeros(n, dtype=np.uint32)
    for w in range(length // 4):
        crc ^= words[:, w]
        crc = (tab[3][crc & 0xFF] ^ tab[2][(crc >> 8) & 0xFF]
               ^ tab[1][(crc >> 16) & 0xFF] ^ tab[0][crc >> 24])
    return crc


def _crc0(arr: np.ndarray) -> int:
    """Zero-seeded crc32c of a 1-D uint8 array."""
    n = arr.size
    if n == 0:
        return 0
    row = min(_ROW, -(-n // 4) * 4)
    n_rows = -(-n // row)
    padded = np.zeros(n_rows * row, dtype=np.uint8)
    padded[padded.size - n:] = arr
    crcs = crc32c_rows(padded.reshape(n_rows, row))
    span = row
    while crcs.size > 1:
        if crcs.size % 2:     # one more leading zero row
            crcs = np.concatenate([np.zeros(1, np.uint32), crcs])
        crcs = advance(advance_columns(span), crcs[0::2]) ^ crcs[1::2]
        span *= 2
    return int(crcs[0])


def _np_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    return np.frombuffer(data, dtype=np.uint8)


def crc32c_numpy(crc: int, data, length: int | None = None) -> int:
    """ceph_crc32c in numpy (`_crc0` row folds): the oracle the native
    `crc32c` is held against."""
    if data is None:
        return crc32c_zeros(crc, length or 0)
    arr = _np_u8(data)
    return crc32c_zeros(crc, arr.size) ^ _crc0(arr)


@functools.lru_cache(maxsize=1)
def _fast_crc():
    """A c_char_p prototype bound to the native symbol: bytes pass
    straight through with no per-call cast."""
    proto = ctypes.CFUNCTYPE(ctypes.c_uint32, ctypes.c_uint32,
                             ctypes.c_char_p, ctypes.c_uint64)
    return proto(("ceph_tpu_crc32c", native.get_lib()))


_fast_crc_fn = None


def crc32c(crc: int, data, length: int | None = None) -> int:
    """ceph_crc32c: data=None means `length` zero bytes.  Bytes-like data
    runs the native crc of native/src/crc32c.cc (SSE4.2 where the CPU has
    it)."""
    global _fast_crc_fn
    if data is None:
        return crc32c_zeros(crc, length or 0)
    if isinstance(data, bytes):
        # module-global binding: the messenger's per-frame hot path
        fast = _fast_crc_fn
        if fast is None:
            fast = _fast_crc_fn = _fast_crc()
        return fast(crc & 0xFFFFFFFF, data, len(data))
    if isinstance(data, (bytearray, memoryview)):
        arr = np.frombuffer(data, dtype=np.uint8)   # zero-copy view
    else:
        arr = _np_u8(data)
    return int(native.get_lib().ceph_tpu_crc32c(crc & 0xFFFFFFFF,
                                                _u8_ptr(arr), arr.size))


@functools.lru_cache(maxsize=64)
def _advance_tables(length: int) -> np.ndarray:
    """(4, 256) uint32 byte tables of the zero-advance through `length`
    bytes: advance(v) = T0[v & 255] ^ T1[v >> 8 & 255] ^ T2[..] ^ T3[..]."""
    cols = advance_columns(length)
    byte = np.arange(256, dtype=np.uint32)
    return np.stack([advance(cols, byte << np.uint32(8 * k))
                     for k in range(4)])


def _advance_fast(length: int, v: np.ndarray) -> np.ndarray:
    tab = _advance_tables(length)
    return (tab[0][v & 0xFF] ^ tab[1][(v >> 8) & 0xFF]
            ^ tab[2][(v >> 16) & 0xFF] ^ tab[3][v >> 24])


_BLOCK_ROW = 64  # bytes per row of crc32c_blocks


def crc32c_blocks(data, block_size: int, init: int = 0xFFFFFFFF
                  ) -> np.ndarray:
    """(N,) uint32: crc32c(init, block) of every `block_size`-byte block of
    `data` (host numpy; the JAX package's host crc32c_blocks).

    Each block is front-padded with zeros to whole rows of _BLOCK_ROW
    bytes (leading zeros leave a zero-seeded crc unchanged); the rows of
    all blocks go through crc32c_rows together and fold per block in a
    log-depth tree, and the seed's advance through the block is XORed in.
    Short rows keep the Python loop over word columns short: a 4 KiB
    block is 16 column steps, not the 256 of 1 KiB rows."""
    arr = _np_u8(data)
    if block_size < 1 or arr.size % block_size:
        raise ValueError(f"{arr.size} bytes do not split into blocks of"
                         f" {block_size}")
    n = arr.size // block_size
    row = min(_BLOCK_ROW, -(-block_size // 4) * 4)
    per = -(-block_size // row)
    padded = np.zeros((n, per * row), dtype=np.uint8)
    padded[:, per * row - block_size:] = arr.reshape(n, block_size)
    crcs = crc32c_rows(padded.reshape(n * per, row)).reshape(n, per)
    span = row
    while crcs.shape[1] > 1:
        if crcs.shape[1] % 2:     # one more leading zero row
            crcs = np.concatenate([np.zeros((n, 1), np.uint32), crcs], 1)
        crcs = _advance_fast(span, crcs[:, 0::2]) ^ crcs[:, 1::2]
        span *= 2
    return crcs[:, 0] ^ np.uint32(crc32c_zeros(init, block_size))


def xxh32(data, seed: int = 0) -> int:
    """xxHash32 of `data` (native/src/xxhash.cc)."""
    arr = _np_u8(data)
    return int(native.get_lib().ceph_tpu_xxh32(
        _u8_ptr(arr), arr.size, seed & _M32))


def xxh64(data, seed: int = 0) -> int:
    """xxHash64 of `data` (native/src/xxhash.cc)."""
    arr = _np_u8(data)
    return int(native.get_lib().ceph_tpu_xxh64(
        _u8_ptr(arr), arr.size, seed & _M64))


def _u8_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# Pure-Python xxhash: the plain versions of xxh32 / xxh64 (independent of
# the C++ in native/src/xxhash.cc, for cross-checking).

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF
_P32 = (2654435761, 2246822519, 3266489917, 668265263, 374761393)
_P64 = (11400714785074694791, 14029467366897019727, 1609587929392839161,
        9650029242287828579, 2870177450012600261)


def _rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def _rotl64(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _py_xxh32(data: bytes, seed: int) -> int:
    p1, p2, p3, p4, p5 = _P32
    n = len(data)
    i = 0
    if n >= 16:
        v = [(seed + p1 + p2) & _M32, (seed + p2) & _M32, seed,
             (seed - p1) & _M32]
        while i + 16 <= n:
            for lane in range(4):
                w = int.from_bytes(data[i:i + 4], "little")
                v[lane] = (_rotl32((v[lane] + w * p2) & _M32, 13) * p1) & _M32
                i += 4
        h = (_rotl32(v[0], 1) + _rotl32(v[1], 7) + _rotl32(v[2], 12)
             + _rotl32(v[3], 18)) & _M32
    else:
        h = (seed + p5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        w = int.from_bytes(data[i:i + 4], "little")
        h = (_rotl32((h + w * p3) & _M32, 17) * p4) & _M32
        i += 4
    while i < n:
        h = (_rotl32((h + data[i] * p5) & _M32, 11) * p1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * p2) & _M32
    h ^= h >> 13
    h = (h * p3) & _M32
    h ^= h >> 16
    return h


def _py_xxh64_round(acc, inp):
    return (_rotl64((acc + inp * _P64[1]) & _M64, 31) * _P64[0]) & _M64


def _py_xxh64(data: bytes, seed: int) -> int:
    p1, p2, p3, p4, p5 = _P64
    n = len(data)
    i = 0
    if n >= 32:
        v = [(seed + p1 + p2) & _M64, (seed + p2) & _M64, seed,
             (seed - p1) & _M64]
        while i + 32 <= n:
            for lane in range(4):
                w = int.from_bytes(data[i:i + 8], "little")
                v[lane] = _py_xxh64_round(v[lane], w)
                i += 8
        h = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12)
             + _rotl64(v[3], 18)) & _M64
        for lane in range(4):
            h = ((h ^ _py_xxh64_round(0, v[lane])) * p1 + p4) & _M64
    else:
        h = (seed + p5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        w = int.from_bytes(data[i:i + 8], "little")
        h = (_rotl64(h ^ _py_xxh64_round(0, w), 27) * p1 + p4) & _M64
        i += 8
    if i + 4 <= n:
        w = int.from_bytes(data[i:i + 4], "little")
        h = (_rotl64(h ^ ((w * p1) & _M64), 23) * p2 + p3) & _M64
        i += 4
    while i < n:
        h = (_rotl64(h ^ ((data[i] * p5) & _M64), 11) * p1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * p2) & _M64
    h ^= h >> 29
    h = (h * p3) & _M64
    h ^= h >> 32
    return h


# ---------------------------------------------------------------------------
# Batched crc32c (PyTorch): the plain version of ops/crc_kernels.py
# ---------------------------------------------------------------------------

_CELL = 64  # bytes per matmul cell


@functools.lru_cache(maxsize=None)
def _zero_advance_matrix(length: int) -> np.ndarray:
    """32x32 GF(2) 0/1 matrix advancing a crc through `length` zero bytes."""
    cols = []
    for b in range(32):
        v = crc32c_zeros(1 << b, length)
        cols.append([(v >> o) & 1 for o in range(32)])
    return np.array(cols, dtype=np.uint8).T  # (out_bit, in_bit)


@functools.lru_cache(maxsize=1)
def _cell_matrix() -> np.ndarray:
    """32x512 GF(2) matrix: zero-seeded crc of one 64-byte cell."""
    cols = []
    buf = np.zeros(_CELL, dtype=np.uint8)
    for i in range(_CELL):
        for b in range(8):
            buf[:] = 0
            buf[i] = 1 << b
            v = crc32c(0, buf)
            cols.append([(v >> o) & 1 for o in range(32)])
    return np.array(cols, dtype=np.uint8).T  # (32, 512)


def _mod2_matmul(bits: torch.Tensor, mat_t: torch.Tensor) -> torch.Tensor:
    """(..., N) 0/1 x (N, 32) -> (..., 32) over GF(2).  float32 is exact:
    the sums are at most N <= 512."""
    prod = torch.matmul(bits.to(torch.float32), mat_t)
    return prod.to(torch.int32) & 1


def make_crc_consts(length: int, device=None) -> dict:
    """Constants for crc32c_partial_bits over `length`-byte rows."""
    ncells = max(1, -(-length // _CELL))
    levels = max(0, (ncells - 1).bit_length())

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return {
        "length": length,
        "levels": levels,
        "cell_mat_t": t(_cell_matrix().T),
        "advances": tuple(t(_zero_advance_matrix(_CELL * (1 << lvl)).T)
                          for lvl in range(levels)),
    }


def crc32c_partial_bits(data: torch.Tensor, consts: dict) -> torch.Tensor:
    """(..., L) uint8 -> (..., 32) int32 zero-seeded crc bits.

    Rows are front-padded with zeros to a power-of-two cell count (a
    no-op for the zero-seeded linear part of the CRC)."""
    length = consts["length"]
    levels = consts["levels"]
    ncells = 1 << levels
    lead = ncells * _CELL - length
    if lead:
        data = torch.cat([data.new_zeros((*data.shape[:-1], lead)), data],
                         dim=-1)
    cells = data.reshape(*data.shape[:-1], ncells, _CELL)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((cells[..., :, None] >> shifts) & 1).reshape(
        *data.shape[:-1], ncells, _CELL * 8)
    part = _mod2_matmul(bits, consts["cell_mat_t"])       # (..., n, 32)
    for lvl in range(levels):
        pairs = part.reshape(*part.shape[:-2], part.shape[-2] // 2, 2, 32)
        left = _mod2_matmul(pairs[..., 0, :], consts["advances"][lvl])
        part = left ^ pairs[..., 1, :]
    return part[..., 0, :]


def as_int32(v: int) -> int:
    """A uint32 value as the int32 with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def crc32c_pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) 0/1 int32 -> (...,) uint32 crcs as int32 bit patterns."""
    weights = 1 << torch.arange(32, dtype=torch.int64, device=bits.device)
    v = torch.sum(bits.to(torch.int64) * weights, dim=-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def crc32c_combine_bits(left_bits: torch.Tensor, right_bits: torch.Tensor,
                        advance_t: torch.Tensor) -> torch.Tensor:
    """GF(2) combine: crc(A||B) bits from zero-seeded partials;
    advance_t is the transposed 32x32 zero-run matrix for len(B)."""
    return _mod2_matmul(left_bits, advance_t) ^ right_bits


# bound on the float32 bit planes one crc32c_batch step materialises
_BATCH_BIT_BYTES = 1 << 31


def crc32c_batch(blocks: torch.Tensor, init: int = 0xFFFFFFFF) -> torch.Tensor:
    """crc32c of each row of an (N, L) uint8 tensor -> (N,) int32 bits.

    Cell matmul plus tree combine for the zero-seeded linear part, then
    the host-folded seed advance XORed in.  Rows go through in groups so
    the bit planes stay under a fixed size."""
    if blocks.dim() != 2 or blocks.dtype != torch.uint8:
        raise ValueError(f"expected (N, L) uint8, got {tuple(blocks.shape)}"
                         f" {blocks.dtype}")
    n, length = blocks.shape
    consts = make_crc_consts(length, blocks.device)
    row_bytes = (1 << consts["levels"]) * _CELL * 8 * 4
    step = max(1, _BATCH_BIT_BYTES // row_bytes)
    parts = [crc32c_pack_bits(crc32c_partial_bits(blocks[i:i + step], consts))
             for i in range(0, n, step)]
    crcs = (torch.cat(parts) if parts else
            torch.zeros(0, dtype=torch.int32, device=blocks.device))
    return crcs ^ as_int32(crc32c_zeros(init, length))
