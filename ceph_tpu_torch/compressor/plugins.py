"""Built-in compressor plugins (port of ceph_tpu/compressor/plugins.py).

Reference: the reference's src/compressor/{zlib,lz4,snappy,zstd,brotli}/ —
each a thin Compressor subclass plus a CompressionPlugin registration.
Here zlib uses the Python stdlib (the reference links zlib/isa-l),
lz4/snappy use the from-spec native C++ block codecs in
ceph_tpu_torch/native/src/compress.cc (a copy of the JAX package's), and zstd/brotli bind the system
shared libraries directly via ctypes (the reference vendors/links
libzstd and libbrotli the same way — ZstdCompressor.h wraps the
streaming API, BrotliCompressor.cc the one-shot API).  zstd or brotli
whose system library is absent simply doesn't register, like a reference
build without HAVE_ZSTD/HAVE_BROTLI.  lz4 and snappy always register:
their sources are in the package, and a failed build raises (the JAX
package leaves them unregistered instead).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import zlib as _zlib
from typing import Optional, Tuple

import numpy as np

from ceph_tpu_torch import native
from ceph_tpu_torch.compressor import (
    COMP_ALG_BROTLI,
    COMP_ALG_LZ4,
    COMP_ALG_SNAPPY,
    COMP_ALG_ZLIB,
    COMP_ALG_ZSTD,
    CompressionPlugin,
    Compressor,
)

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _u8(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


class ZlibCompressor(Compressor):
    """Deflate via stdlib zlib.

    The reference's compressor_message carries the zlib window bits used at
    compress time (ZlibCompressor.cc); same here.
    """

    WINDOW_BITS = -15  # raw deflate, matching the reference's isal/zlib path

    def __init__(self, level: int = 5):
        super().__init__(COMP_ALG_ZLIB, "zlib")
        self.level = level

    def compress(self, data: bytes) -> Tuple[bytes, Optional[int]]:
        c = _zlib.compressobj(self.level, _zlib.DEFLATED, self.WINDOW_BITS)
        return c.compress(data) + c.flush(), self.WINDOW_BITS

    # deflate expands at most ~1032x; cap output vs input size so a crafted
    # stream can't balloon a small blob into a multi-GiB allocation
    MAX_EXPANSION = 1100

    def decompress(self, data: bytes,
                   compressor_message: Optional[int] = None) -> bytes:
        wbits = (compressor_message if compressor_message is not None
                 else self.WINDOW_BITS)
        d = _zlib.decompressobj(wbits)
        cap = len(data) * self.MAX_EXPANSION + 1024
        out = d.decompress(data, cap)
        if d.unconsumed_tail:
            raise ValueError(
                f"zlib: implausible expansion beyond {cap} bytes")
        return out + d.flush()


class _NativeBlockCompressor(Compressor):
    """Shared base of the native C++ block codecs."""

    _prefix = ""

    def __init__(self, alg: int, type_name: str):
        super().__init__(alg, type_name)
        self._lib = native.get_lib()

    def _fn(self, op: str):
        return getattr(self._lib, f"ceph_tpu_{self._prefix}_{op}")

    def compress(self, data: bytes) -> Tuple[bytes, Optional[int]]:
        src = _u8(data)
        cap = int(self._fn("compress_bound")(len(data)))
        dst = np.empty(cap, dtype=np.uint8)
        n = int(self._fn("compress")(_ptr(src), len(data), _ptr(dst), cap))
        if n < 0:
            raise RuntimeError(f"{self.type_name} compress failed")
        # uncompressed length header for decompress sizing (the reference
        # stores it in the blob metadata; snappy has it in-format)
        return dst[:n].tobytes(), None

    # both block formats expand at most ~255x (length-extension bytes add up
    # to 255 output bytes each); anything claiming more is corrupt — reject
    # before allocating a multi-GiB buffer from a few untrusted header bytes
    MAX_EXPANSION = 256

    def _decompress_raw(self, data: bytes, out_cap: int) -> bytes:
        if out_cap > len(data) * self.MAX_EXPANSION + 1024:
            raise ValueError(
                f"{self.type_name}: implausible uncompressed length"
                f" {out_cap} for {len(data)} compressed bytes")
        src = _u8(data)
        dst = np.empty(out_cap, dtype=np.uint8)
        n = int(self._fn("decompress")(_ptr(src), len(data), _ptr(dst), out_cap))
        if n < 0:
            raise ValueError(f"{self.type_name}: malformed compressed data")
        return dst[:n].tobytes()


class Lz4Compressor(_NativeBlockCompressor):
    """LZ4 block format (native C++ codec).

    The reference prefixes each lz4-compressed blob with the uncompressed
    segment lengths (LZ4Compressor.h compress framing); here a single
    4-byte LE uncompressed length plays that role.
    """

    _prefix = "lz4"

    def __init__(self):
        super().__init__(COMP_ALG_LZ4, "lz4")

    def compress(self, data: bytes) -> Tuple[bytes, Optional[int]]:
        if len(data) >= 1 << 32:  # 4-byte length header limit
            raise RuntimeError("lz4: input too large (>= 4 GiB)")
        payload, msg = super().compress(data)
        return len(data).to_bytes(4, "little") + payload, msg

    def decompress(self, data: bytes,
                   compressor_message: Optional[int] = None) -> bytes:
        if len(data) < 4:
            raise ValueError("lz4: truncated header")
        want = int.from_bytes(data[:4], "little")
        out = self._decompress_raw(data[4:], want)
        if len(out) != want:
            raise ValueError("lz4: length mismatch")
        return out


class SnappyCompressor(_NativeBlockCompressor):
    """Snappy format (native C++ codec); length rides in-format."""

    _prefix = "snappy"

    def __init__(self):
        super().__init__(COMP_ALG_SNAPPY, "snappy")

    def decompress(self, data: bytes,
                   compressor_message: Optional[int] = None) -> bytes:
        src = _u8(data)
        want = int(self._lib.ceph_tpu_snappy_uncompressed_length(
            _ptr(src), len(data)))
        if want < 0:
            raise ValueError("snappy: malformed length header")
        return self._decompress_raw(data, want)


def _load_shared(name: str) -> Optional[ctypes.CDLL]:
    """dlopen a system library by soname candidates; None if absent."""
    for cand in (ctypes.util.find_library(name), f"lib{name}.so.1",
                 f"lib{name}.so"):
        if not cand:
            continue
        try:
            return ctypes.CDLL(cand)
        except OSError:
            continue
    return None


class ZstdCompressor(Compressor):
    """zstd via the system libzstd one-shot API
    (ZSTD_compress/ZSTD_decompress — the simple-API tier of the
    streaming path the reference wraps in ZstdCompressor.h).  The
    uncompressed length rides in the zstd frame header, so decompress
    needs no side-channel."""

    _lib: Optional[ctypes.CDLL] = None

    @classmethod
    def lib(cls) -> Optional[ctypes.CDLL]:
        if cls._lib is None:
            lz = _load_shared("zstd")
            if lz is not None:
                lz.ZSTD_compressBound.restype = ctypes.c_size_t
                lz.ZSTD_compress.restype = ctypes.c_size_t
                lz.ZSTD_decompress.restype = ctypes.c_size_t
                lz.ZSTD_isError.restype = ctypes.c_uint
                lz.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            cls._lib = lz
        return cls._lib

    def __init__(self, level: int = 1):
        super().__init__(COMP_ALG_ZSTD, "zstd")
        # the reference's compressor_zstd_level default is 1
        self.level = level

    def compress(self, data: bytes) -> Tuple[bytes, Optional[int]]:
        lz = self.lib()
        src = _u8(data)
        cap = int(lz.ZSTD_compressBound(ctypes.c_size_t(len(data))))
        dst = np.empty(cap, dtype=np.uint8)
        n = int(lz.ZSTD_compress(_ptr(dst), ctypes.c_size_t(cap),
                                 _ptr(src), ctypes.c_size_t(len(data)),
                                 ctypes.c_int(self.level)))
        if lz.ZSTD_isError(ctypes.c_size_t(n)):
            raise RuntimeError("zstd compress failed")
        return dst[:n].tobytes(), None

    # ruler-constant data compresses ~20000:1 per zstd block; cap what a
    # frame header may claim so corrupt metadata can't force a huge alloc
    MAX_EXPANSION = 1 << 17

    def decompress(self, data: bytes,
                   compressor_message: Optional[int] = None) -> bytes:
        lz = self.lib()
        src = _u8(data)
        want = int(lz.ZSTD_getFrameContentSize(
            _ptr(src), ctypes.c_size_t(len(data))))
        # ZSTD_CONTENTSIZE_UNKNOWN / _ERROR are 2**64-1 / 2**64-2
        # (the restype is unsigned, so they arrive as huge positives)
        if want >= (1 << 64) - 2 or \
                want > len(data) * self.MAX_EXPANSION + 1024:
            raise ValueError("zstd: malformed/implausible frame header")
        dst = np.empty(max(want, 1), dtype=np.uint8)
        n = int(lz.ZSTD_decompress(_ptr(dst), ctypes.c_size_t(want),
                                   _ptr(src),
                                   ctypes.c_size_t(len(data))))
        if lz.ZSTD_isError(ctypes.c_size_t(n)) or n != want:
            raise ValueError("zstd: malformed compressed data")
        return dst[:n].tobytes()


class BrotliCompressor(Compressor):
    """brotli via the system libbrotlienc/dec one-shot API
    (BrotliEncoderCompress/BrotliDecoderDecompress; the reference's
    BrotliCompressor.cc uses the same pair).  Brotli's format carries
    no length, so a 4-byte LE header plays the blob-metadata role."""

    _enc: Optional[ctypes.CDLL] = None
    _dec: Optional[ctypes.CDLL] = None

    @classmethod
    def libs(cls):
        if cls._enc is None:
            cls._enc = _load_shared("brotlienc")
            cls._dec = _load_shared("brotlidec")
            if cls._enc is not None:
                cls._enc.BrotliEncoderCompress.restype = ctypes.c_int
                cls._enc.BrotliEncoderMaxCompressedSize.restype = \
                    ctypes.c_size_t
            if cls._dec is not None:
                cls._dec.BrotliDecoderDecompress.restype = ctypes.c_int
        return cls._enc, cls._dec

    def __init__(self, quality: int = 5):
        super().__init__(COMP_ALG_BROTLI, "brotli")
        self.quality = quality

    def compress(self, data: bytes) -> Tuple[bytes, Optional[int]]:
        if len(data) >= 1 << 32:
            raise RuntimeError("brotli: input too large (>= 4 GiB)")
        enc, _dec = self.libs()
        src = _u8(data)
        cap = int(enc.BrotliEncoderMaxCompressedSize(
            ctypes.c_size_t(len(data)))) or len(data) + 1024
        dst = np.empty(cap, dtype=np.uint8)
        out_len = ctypes.c_size_t(cap)
        ok = enc.BrotliEncoderCompress(
            ctypes.c_int(self.quality), ctypes.c_int(22),  # lgwin default
            ctypes.c_int(0),  # mode: generic
            ctypes.c_size_t(len(data)), _ptr(src),
            ctypes.byref(out_len), _ptr(dst))
        if not ok:
            raise RuntimeError("brotli compress failed")
        return (len(data).to_bytes(4, "little")
                + dst[:out_len.value].tobytes()), None

    MAX_EXPANSION = 1 << 17  # window-sized back-references: huge ratios

    def decompress(self, data: bytes,
                   compressor_message: Optional[int] = None) -> bytes:
        if len(data) < 4:
            raise ValueError("brotli: truncated header")
        _enc, dec = self.libs()
        want = int.from_bytes(data[:4], "little")
        if want > (len(data) - 4) * self.MAX_EXPANSION + 1024:
            raise ValueError("brotli: implausible uncompressed length")
        src = _u8(data[4:])
        dst = np.empty(max(want, 1), dtype=np.uint8)
        out_len = ctypes.c_size_t(want)
        rc = dec.BrotliDecoderDecompress(
            ctypes.c_size_t(len(src)), _ptr(src),
            ctypes.byref(out_len), _ptr(dst))
        if rc != 1 or out_len.value != want:  # BROTLI_DECODER_RESULT_SUCCESS
            raise ValueError("brotli: malformed compressed data")
        return dst[:out_len.value].tobytes()


def register_all(registry) -> None:
    registry.add("compressor", "zlib",
                 CompressionPlugin("zlib", ZlibCompressor))
    native.get_lib()  # builds the lz4 and snappy codecs, or raises
    registry.add("compressor", "lz4",
                 CompressionPlugin("lz4", Lz4Compressor))
    registry.add("compressor", "snappy",
                 CompressionPlugin("snappy", SnappyCompressor))
    # zstd / brotli register only when the system libraries resolve,
    # mirroring a reference build without HAVE_ZSTD/HAVE_BROTLI
    if ZstdCompressor.lib() is not None:
        registry.add("compressor", "zstd",
                     CompressionPlugin("zstd", ZstdCompressor))
    if all(BrotliCompressor.libs()):
        registry.add("compressor", "brotli",
                     CompressionPlugin("brotli", BrotliCompressor))
