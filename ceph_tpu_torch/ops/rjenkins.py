"""Robert Jenkins' 32-bit mix hash — CRUSH's hash family (port of
ceph_tpu/ops/rjenkins.py).

Reference: the reference's src/crush/hash.c (crush_hash32_rjenkins1_{1..5},
seed 1315423911).  The algorithm is Jenkins' public-domain evahash mix.  Two
implementations with identical results:

- numpy (uint32 wraparound), copied, for the exact host mapper;
- torch (`hash32_2_torch` .. `hash32_4_torch`) for the plain PyTorch
  version of the placement kernel.  torch has no full uint32 arithmetic
  on the CPU, so the words ride in int64 and are masked to 32 bits after
  every subtraction and left shift; right shifts of the masked,
  non-negative words are then exact.
"""

from __future__ import annotations

import numpy as np
import torch

CRUSH_HASH_SEED = np.uint32(1315423911)
CRUSH_HASH_RJENKINS1 = 0


def _mix(a, b, c):
    """One Jenkins mix round on numpy uint32 values.

    uint32 wraparound is the defined behavior; the errstate guard silences
    numpy's overflow warnings for 0-d operands.
    """
    u32 = lambda v: v.astype(np.uint32) if hasattr(v, "astype") else np.uint32(v)
    a, b, c = u32(a), u32(b), u32(c)
    with np.errstate(over="ignore"):
        a = a - b; a = a - c; a = a ^ (c >> 13)
        b = b - c; b = b - a; b = b ^ (a << 8)
        c = c - a; c = c - b; c = c ^ (b >> 13)
        a = a - b; a = a - c; a = a ^ (c >> 12)
        b = b - c; b = b - a; b = b ^ (a << 16)
        c = c - a; c = c - b; c = c ^ (b >> 5)
        a = a - b; a = a - c; a = a ^ (c >> 3)
        b = b - c; b = b - a; b = b ^ (a << 10)
        c = c - a; c = c - b; c = c ^ (b >> 15)
    return a, b, c


def _as_u32(*vals):
    return tuple(np.asarray(v).astype(np.uint32) for v in vals)


def hash32(a):
    (a,) = _as_u32(a)
    h = CRUSH_HASH_SEED ^ a
    b, x, y = a, np.uint32(231232), np.uint32(1232)
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h


def hash32_2(a, b):
    a, b = _as_u32(a, b)
    h = CRUSH_HASH_SEED ^ a ^ b
    x, y = np.uint32(231232), np.uint32(1232)
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def hash32_3(a, b, c):
    a, b, c = _as_u32(a, b, c)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    x, y = np.uint32(231232), np.uint32(1232)
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def hash32_4(a, b, c, d):
    a, b, c, d = _as_u32(a, b, c, d)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d
    x, y = np.uint32(231232), np.uint32(1232)
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def hash32_5(a, b, c, d, e):
    a, b, c, d, e = _as_u32(a, b, c, d, e)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d ^ e
    x, y = np.uint32(231232), np.uint32(1232)
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    e, x, h = _mix(e, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    d, x, h = _mix(d, x, h)
    y, e, h = _mix(y, e, h)
    return h


_M32 = 0xFFFFFFFF


def _mix_torch(a, b, c):
    """One Jenkins mix round on int64 tensors holding uint32 words."""
    a = (a - b - c) & _M32; a = a ^ (c >> 13)
    b = (b - c - a) & _M32; b = b ^ ((a << 8) & _M32)
    c = (c - a - b) & _M32; c = c ^ (b >> 13)
    a = (a - b - c) & _M32; a = a ^ (c >> 12)
    b = (b - c - a) & _M32; b = b ^ ((a << 16) & _M32)
    c = (c - a - b) & _M32; c = c ^ (b >> 5)
    a = (a - b - c) & _M32; a = a ^ (c >> 3)
    b = (b - c - a) & _M32; b = b ^ ((a << 10) & _M32)
    c = (c - a - b) & _M32; c = c ^ (b >> 15)
    return a, b, c


def _words_torch(*vals):
    """Broadcast integer tensors (any sign) to int64 uint32 words."""
    return tuple(torch.as_tensor(v).to(torch.int64) & _M32 for v in vals)


def hash32_2_torch(a, b):
    """hash32_2 on tensors: int64 result in [0, 2^32)."""
    a, b = _words_torch(a, b)
    h = int(CRUSH_HASH_SEED) ^ a ^ b
    x, y = torch.full_like(h, 231232), torch.full_like(h, 1232)
    a, b, h = _mix_torch(a, b, h)
    x, a, h = _mix_torch(x, a, h)
    b, y, h = _mix_torch(b, y, h)
    return h


def hash32_3_torch(a, b, c):
    """hash32_3 on tensors: int64 result in [0, 2^32)."""
    a, b, c = _words_torch(a, b, c)
    h = int(CRUSH_HASH_SEED) ^ a ^ b ^ c
    x, y = torch.full_like(h, 231232), torch.full_like(h, 1232)
    a, b, h = _mix_torch(a, b, h)
    c, x, h = _mix_torch(c, x, h)
    y, a, h = _mix_torch(y, a, h)
    b, x, h = _mix_torch(b, x, h)
    y, c, h = _mix_torch(y, c, h)
    return h


def hash32_4_torch(a, b, c, d):
    """hash32_4 on tensors: int64 result in [0, 2^32)."""
    a, b, c, d = _words_torch(a, b, c, d)
    h = int(CRUSH_HASH_SEED) ^ a ^ b ^ c ^ d
    x, y = torch.full_like(h, 231232), torch.full_like(h, 1232)
    a, b, h = _mix_torch(a, b, h)
    c, d, h = _mix_torch(c, d, h)
    a, x, h = _mix_torch(a, x, h)
    y, b, h = _mix_torch(y, b, h)
    c, x, h = _mix_torch(c, x, h)
    y, d, h = _mix_torch(y, d, h)
    return h


def _mix_int(a: int, b: int, c: int):
    """One Jenkins mix round on Python ints holding uint32 words."""
    M = 0xFFFFFFFF
    a = (a - b - c) & M; a ^= c >> 13
    b = (b - c - a) & M; b ^= (a << 8) & M
    c = (c - a - b) & M; c ^= b >> 13
    a = (a - b - c) & M; a ^= c >> 12
    b = (b - c - a) & M; b ^= (a << 16) & M
    c = (c - a - b) & M; c ^= b >> 5
    a = (a - b - c) & M; a ^= c >> 3
    b = (b - c - a) & M; b ^= (a << 10) & M
    c = (c - a - b) & M; c ^= b >> 15
    return a, b, c


def hash32_2_int(a: int, b: int) -> int:
    """hash32_2 of two uint32 Python ints: for one value, a few
    microseconds where numpy's array machinery takes a hundred or more."""
    a &= 0xFFFFFFFF
    b &= 0xFFFFFFFF
    h = int(CRUSH_HASH_SEED) ^ a ^ b
    x, y = 231232, 1232
    a, b, h = _mix_int(a, b, h)
    x, a, h = _mix_int(x, a, h)
    b, y, h = _mix_int(b, y, h)
    return h


def ceph_str_hash_rjenkins(data: bytes) -> int:
    """Jenkins lookup2 string hash (reference src/common/ceph_hash.cc:21-78)
    — hashes object names onto PG seeds (hobject_t::get_hash)."""
    M = 0xFFFFFFFF
    mix = _mix_int

    length = len(data)
    a = b = 0x9E3779B9
    c = 0
    i = 0
    while length - i >= 12:
        a = (a + int.from_bytes(data[i:i + 4], "little")) & M
        b = (b + int.from_bytes(data[i + 4:i + 8], "little")) & M
        c = (c + int.from_bytes(data[i + 8:i + 12], "little")) & M
        a, b, c = mix(a, b, c)
        i += 12
    c = (c + length) & M
    tail = data[i:]
    n = len(tail)
    if n >= 11: c = (c + (tail[10] << 24)) & M
    if n >= 10: c = (c + (tail[9] << 16)) & M
    if n >= 9:  c = (c + (tail[8] << 8)) & M
    if n >= 8:  b = (b + (tail[7] << 24)) & M
    if n >= 7:  b = (b + (tail[6] << 16)) & M
    if n >= 6:  b = (b + (tail[5] << 8)) & M
    if n >= 5:  b = (b + tail[4]) & M
    if n >= 4:  a = (a + (tail[3] << 24)) & M
    if n >= 3:  a = (a + (tail[2] << 16)) & M
    if n >= 2:  a = (a + (tail[1] << 8)) & M
    if n >= 1:  a = (a + tail[0]) & M
    _a, _b, c = mix(a, b, c)
    return c
