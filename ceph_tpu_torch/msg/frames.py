"""Wire frame discipline (port of ceph_tpu/msg/frames.py).

Reference parity: the msgr2 frame format
(the reference's src/msg/async/frames_v2.cc:44-77) — a fixed preamble
carrying tag + segment layout protected by its own crc32c, segments each
followed by a crc32c epilogue.  This framework uses one segment per frame
(payloads are single encoded messages; large data rides inside them), so
the format collapses to:

    preamble (20 bytes):
        magic   u32  = 0xCE9F0205
        tag     u16  (message type)
        flags   u16
        seq     u64  (per-connection frame counter)
        len     u32  (payload length)
    preamble_crc u32  crc32c(-1) over the 20 preamble bytes
    payload      len bytes
    payload_crc  u32  crc32c(-1) over payload

Any crc or magic mismatch is a protocol error: the connection is dropped
(the reference resets the session on a bad frame; lossless peers
reconnect and replay, lossy clients resend at the Objecter layer).

cephx-lite signing (ceph_tpu_torch.common.auth): when a secret is configured,
FLAG_SIGNED is set and an 8-byte truncated HMAC-SHA256 over
preamble+payload follows the payload crc (CephxSessionHandler
sign_message role); a receiver with a secret drops unsigned or
mis-signed frames.
"""

from __future__ import annotations

import struct
from typing import Tuple

from ceph_tpu_torch.ops.checksum import crc32c

MAGIC = 0xCE9F0205
PREAMBLE = struct.Struct("<IHHQI")
CRC = struct.Struct("<I")
FLAG_SIGNED = 0x0001
FLAG_SECURE = 0x0002      # payload AEAD-sealed under the session key
FLAG_COMPRESSED = 0x0004  # payload compressed with the negotiated codec


class FrameError(Exception):
    """Bad magic or crc: the connection must be dropped."""


def encode_frame_parts(tag: int, seq: int, payload: bytes,
                       flags: int = 0, key=None,
                       role: bytes = b"") -> list:
    """Frame as (head, payload, tail): the payload rides as-is —
    zero-copy at this layer; for multi-MiB data frames the join it
    avoids is a full extra pass over the object.

    key: the signing key BYTES for this frame (a cephx session key, or
    the static active key during the hello handshake); None = unsigned.

    role: the sender's direction byte (b"c"/b"s"), BOUND INTO the
    signature so a frame recorded in one direction can never verify in
    the other — without it, symmetric per-direction seq counters let
    an active MITM reflect a captured frame back to its sender (the
    reference binds direction via distinct c->s / s->c nonce halves,
    msg/async/crypto_onwire.cc:34-46)."""
    if key is not None:
        flags |= FLAG_SIGNED
    pre = PREAMBLE.pack(MAGIC, tag, flags, seq, len(payload))
    head = pre + CRC.pack(crc32c(0xFFFFFFFF, pre))
    tail = CRC.pack(crc32c(0xFFFFFFFF, payload))
    if key is not None:
        from ceph_tpu_torch.common import auth

        tail += auth.sign(key, role, pre, payload)
    return [head, payload, tail]


def encode_frame(tag: int, seq: int, payload: bytes,
                 flags: int = 0, key=None, role: bytes = b"") -> bytes:
    """Whole-frame convenience form (tests, sniffers).  The product
    path writes the parts straight to the socket
    (Connection._send_signed) and never pays this join."""
    head, body, tail = encode_frame_parts(tag, seq, payload,
                                          flags=flags, key=key,
                                          role=role)
    out = bytearray(head)
    out += body
    out += tail
    # deliberate copy: this convenience form exists to hand tests one
    # contiguous frame  # lint: disable=hot-path-copy
    return bytes(out)


def check_signature(key, flags: int, pre_buf: bytes,
                    payload: bytes, sig: bytes,
                    role: bytes = b"") -> None:
    """Receiver-side auth adjudication; FrameError drops the conn.
    role: the SENDER's direction byte (the receiver's rx role)."""
    from ceph_tpu_torch.common import auth

    if key is None:
        return
    if not flags & FLAG_SIGNED:
        raise FrameError("unsigned frame from peer (auth required)")
    # memoryview slice: the HMAC walks the view; no preamble copy
    if not auth.verify(key, sig, role,
                       memoryview(pre_buf)[:PREAMBLE.size], payload):
        raise FrameError("frame signature mismatch (wrong key?)")


def decode_preamble(buf: bytes) -> Tuple[int, int, int, int]:
    """24 preamble+crc bytes -> (tag, flags, seq, payload_len)."""
    magic, tag, flags, seq, length = PREAMBLE.unpack_from(buf)
    (crc,) = CRC.unpack_from(buf, PREAMBLE.size)
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic:#x}")
    # memoryview slice: crc32c walks the view; no preamble copy
    if crc32c(0xFFFFFFFF, memoryview(buf)[:PREAMBLE.size]) != crc:
        raise FrameError("preamble crc mismatch")
    return tag, flags, seq, length


def check_payload(payload: bytes, crc_bytes: bytes) -> None:
    (crc,) = CRC.unpack(crc_bytes)
    if crc32c(0xFFFFFFFF, payload) != crc:
        raise FrameError("payload crc mismatch")


PREAMBLE_WIRE_LEN = PREAMBLE.size + CRC.size  # 24
