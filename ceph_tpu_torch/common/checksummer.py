"""Per-block checksums for stored blobs — the Checksummer capability (port
of ceph_tpu/common/checksummer.py).

Reference seam: class Checksummer (the reference's src/common/Checksummer.h)
with types none/xxhash32/xxhash64/crc32c/crc32c_16/crc32c_8 (:16-22), used by
BlueStore to seed blob csums on write (BlueStore.cc:13642-13651) and verify
every read (_verify_csum, BlueStore.cc:9636-9663).

calculate() fills a little-endian value vector, one value per
csum_block_size block; verify() returns the byte offset of the first bad
block or -1.  Both take the device the checksums run on (CUDA unless the
caller names another; no CUDA and no device raises).  On CUDA, crc32c of 8
or more blocks whose size is a multiple of 4 launches the batched crc kernel
(ops/crc_kernels.crc32c_blocks, the port of the TPU's crc_pallas kernel) —
the BlueStore-blob-sweep shape from BASELINE config #3; otherwise, and on
the CPU device, the host crc32c_blocks runs.  xxhash runs on the host.
"""

from __future__ import annotations

import numpy as np

import torch

from ceph_tpu_torch.device import resolve_device, to_device
from ceph_tpu_torch.ops import checksum as cks
from ceph_tpu_torch.ops import crc_kernels

CSUM_NONE = 1
CSUM_XXHASH32 = 2
CSUM_XXHASH64 = 3
CSUM_CRC32C = 4
CSUM_CRC32C_16 = 5
CSUM_CRC32C_8 = 6

_NAMES = {
    CSUM_NONE: "none",
    CSUM_XXHASH32: "xxhash32",
    CSUM_XXHASH64: "xxhash64",
    CSUM_CRC32C: "crc32c",
    CSUM_CRC32C_16: "crc32c_16",
    CSUM_CRC32C_8: "crc32c_8",
}
_TYPES = {v: k for k, v in _NAMES.items()}

_VALUE_SIZE = {
    CSUM_NONE: 0,
    CSUM_XXHASH32: 4,
    CSUM_XXHASH64: 8,
    CSUM_CRC32C: 4,
    CSUM_CRC32C_16: 2,
    CSUM_CRC32C_8: 1,
}

_VALUE_DTYPE = {
    CSUM_XXHASH32: np.dtype("<u4"),
    CSUM_XXHASH64: np.dtype("<u8"),
    CSUM_CRC32C: np.dtype("<u4"),
    CSUM_CRC32C_16: np.dtype("<u2"),
    CSUM_CRC32C_8: np.dtype("<u1"),
}


def get_csum_type_string(t: int) -> str:
    return _NAMES.get(t, "???")


def get_csum_string_type(s: str) -> int:
    if s not in _TYPES:
        raise ValueError(f"unknown csum type {s!r}")
    return _TYPES[s]


def get_csum_value_size(t: int) -> int:
    return _VALUE_SIZE[t]


# fewest blocks for which a crc32c goes to the card
MIN_DEVICE_BLOCKS = 8


def _calc_values(csum_type: int, blocks: np.ndarray, block_size: int,
                 init_value: int, device: torch.device) -> np.ndarray:
    n = blocks.size // block_size
    if csum_type in (CSUM_CRC32C, CSUM_CRC32C_16, CSUM_CRC32C_8):
        if (device.type == "cuda" and n >= MIN_DEVICE_BLOCKS
                and block_size % 4 == 0):
            crcs = crc_kernels.crc32c_blocks(to_device(blocks, device),
                                             block_size, init_value)
            vals = crcs.cpu().numpy().view(np.uint32)
        else:
            vals = cks.crc32c_blocks(blocks, block_size, init=init_value)
        if csum_type == CSUM_CRC32C_16:
            vals = vals & 0xFFFF
        elif csum_type == CSUM_CRC32C_8:
            vals = vals & 0xFF
        return vals
    if csum_type == CSUM_XXHASH32:
        return np.array(
            [cks.xxh32(blocks[i * block_size:(i + 1) * block_size], init_value)
             for i in range(n)], dtype=np.uint64)
    if csum_type == CSUM_XXHASH64:
        return np.array(
            [cks.xxh64(blocks[i * block_size:(i + 1) * block_size], init_value)
             for i in range(n)], dtype=np.uint64)
    raise ValueError(f"bad csum type {csum_type}")


class Checksummer:
    """calculate/verify per-block checksums (Checksummer.h:150-260 shape)."""

    @staticmethod
    def calculate(csum_type: int, csum_block_size: int, offset: int,
                  length: int, data, csum_data: bytearray,
                  init_value: int = 0xFFFFFFFF, device=None) -> None:
        """Checksum blocks [offset, offset+length) of data into csum_data.

        csum_data is indexed by block number (offset // csum_block_size),
        values little-endian — the on-disk layout BlueStore stores in
        bluestore_blob_t::csum_data.
        """
        if csum_type == CSUM_NONE:
            return
        assert offset % csum_block_size == 0
        assert length % csum_block_size == 0
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        assert offset + length <= arr.size or offset == 0
        blocks = arr[offset:offset + length]
        vals = _calc_values(csum_type, blocks, csum_block_size, init_value,
                            resolve_device(device))
        dtype = _VALUE_DTYPE[csum_type]
        vsize = dtype.itemsize
        first = offset // csum_block_size
        need = (first + vals.size) * vsize
        if len(csum_data) < need:
            csum_data.extend(b"\x00" * (need - len(csum_data)))
        csum_data[first * vsize:need] = vals.astype(dtype).tobytes()

    @staticmethod
    def verify(csum_type: int, csum_block_size: int, offset: int, length: int,
               data, csum_data, init_value: int = 0xFFFFFFFF,
               device=None) -> int:
        """Return byte offset of the first bad block, or -1 if all match."""
        if csum_type == CSUM_NONE:
            return -1
        assert offset % csum_block_size == 0
        assert length % csum_block_size == 0
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        blocks = arr[offset:offset + length]
        vals = _calc_values(csum_type, blocks, csum_block_size, init_value,
                            resolve_device(device))
        dtype = _VALUE_DTYPE[csum_type]
        vsize = dtype.itemsize
        first = offset // csum_block_size
        stored = np.frombuffer(
            bytes(csum_data[first * vsize:(first + vals.size) * vsize]),
            dtype=dtype)
        if stored.size < vals.size:
            return offset  # missing csum data counts as a mismatch
        mism = np.nonzero(stored != vals.astype(dtype))[0]
        if mism.size == 0:
            return -1
        return offset + int(mism[0]) * csum_block_size
