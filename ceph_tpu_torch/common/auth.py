"""cephx: shared-secret authentication with per-connection session keys,
tickets, and key rotation (port of ceph_tpu/common/auth.py).

Reference parity:
- MESSAGE SIGNING (the reference's src/auth/cephx/CephxSessionHandler.cc
  sign_message): every frame carries a truncated HMAC keyed by the
  connection's SESSION key.
- Session-key negotiation: a mutual nonce handshake per connection
  derives session_key = HMAC(base_key, nonce_a || nonce_b) — the
  CephxSessionHandler session-key role.  A frame recorded on one
  connection can never verify on another (fresh nonces => fresh key),
  and within a connection the receiver enforces strictly increasing
  signed sequence numbers — together these kill replay.
- Mon-as-KDC tickets (the reference's src/auth/cephx/
  CephxServiceHandler.h:23, CephxProtocol.h): a client proves key
  possession against a server challenge; the mon grants a signed,
  expiring ticket whose base key any service holding the cluster key
  derives offline — services never consult the KDC to validate.
- Key rotation (KeyServer rotating-secrets role): the keyring holds
  multiple (kid, key) entries; new handshakes/tickets use the active
  kid, peers accept any listed kid, operators rotate by adding a key,
  flipping active, then dropping the old one.

Deliberate simplifications (documented, not hidden): one cluster-wide
key plays the per-entity key role (named per-entity keys are a keyring
layout away, not a protocol change), and ticket blobs are signed
assertions rather than encrypted grants — the base key is derived, not
carried, so nothing secret rides the wire.

Keyring format (`ceph-authtool` role): a hex string (kid 0), or
comma-separated `kid:hex` entries — the FIRST entry is the active key.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import time
from typing import Dict, Optional, Tuple

SIG_LEN = 8       # truncated HMAC-SHA256, like cephx's 64-bit signatures
NONCE_LEN = 16
TICKET_LIFETIME = 3600.0  # auth_service_ticket_ttl default role


def generate_secret() -> str:
    return os.urandom(32).hex()


class Keyring:
    """Rotating key set: {kid: key}; the active kid signs new work."""

    def __init__(self, keys: Dict[int, bytes], active: int):
        self.keys = keys
        self.active = active

    @property
    def active_key(self) -> bytes:
        return self.keys[self.active]

    def get(self, kid: int) -> Optional[bytes]:
        return self.keys.get(kid)


def parse_secret(raw) -> Optional[Keyring]:
    """Keyring string -> Keyring (None/empty = auth disabled).

    `<hex>` (kid 0) or `kid:hex,kid:hex,...` (first = active)."""
    if not raw:
        return None
    if isinstance(raw, Keyring):
        return raw
    keys: Dict[int, bytes] = {}
    active = None
    for part in str(raw).split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            kid_s, hexkey = part.split(":", 1)
            kid = int(kid_s)
        else:
            kid, hexkey = 0, part
        keys[kid] = bytes.fromhex(hexkey)
        if active is None:
            active = kid
    if active is None:
        return None
    return Keyring(keys, active)


def load_keyring(path: str) -> Optional[Keyring]:
    with open(path) as f:
        return parse_secret(f.read().strip())


def sign(key: bytes, *parts: bytes) -> bytes:
    mac = hmac.new(key, digestmod=hashlib.sha256)
    for part in parts:
        mac.update(part)
    return mac.digest()[:SIG_LEN]


def verify(key: bytes, sig: bytes, *parts: bytes) -> bool:
    return hmac.compare_digest(sign(key, *parts), sig)


def _prf(key: bytes, label: bytes, *parts: bytes) -> bytes:
    mac = hmac.new(key, label, hashlib.sha256)
    for part in parts:
        mac.update(part)
    return mac.digest()


def new_nonce() -> bytes:
    return os.urandom(NONCE_LEN)


def derive_session(base_key: bytes, nonce_a: bytes,
                   nonce_b: bytes) -> bytes:
    """Per-connection session key: fresh nonces on both sides make a
    frame recorded elsewhere unverifiable here."""
    return _prf(base_key, b"cephx-session", nonce_a, nonce_b)


# -- secure mode (crypto_onwire.cc AES-GCM role) ----------------------------
#
# seal/unseal wrap each secure frame's payload in AES-256-GCM: the
# 12-byte nonce is role(1) || seq(8, big-endian) || 0^3 — it never
# repeats under a key because session keys are per-connection, seqs are
# strictly increasing per direction, and the role byte separates the
# two directions' streams (the reference's distinct c->s / s->c nonce
# halves, crypto_onwire.cc:34-46).  Output = mode byte || ciphertext ||
# 16-byte tag; a receiver REJECTS any mode weaker than its best (a
# MITM must not be able to downgrade two AEAD-capable peers to the
# keystream fallback by flipping the mode byte).
#
# The AEAD is the in-repo native C++ implementation (native/src/
# aesgcm.cc, validated bit-exact against `cryptography`'s OpenSSL-
# backed AESGCM); `cryptography` is the second choice, and the old
# SHAKE-256 keystream XOR (integrity from the frame signature) remains
# only as the no-compiler, no-cryptography fallback.

MODE_XOR = 0x00
MODE_AESGCM = 0x01

_aead_impl = None  # resolved lazily: "native" | "cryptography" | None


def _resolve_aead() -> Optional[str]:
    global _aead_impl
    if _aead_impl is not None:
        return _aead_impl or None
    impl = ""
    try:
        from ceph_tpu_torch import native

        lib = native.get_lib()
        if lib is not None and hasattr(lib, "ceph_tpu_aesgcm_seal"):
            impl = "native"
    except Exception:
        pass
    if not impl:
        try:
            from cryptography.hazmat.primitives.ciphers.aead import (  # noqa: F401
                AESGCM,
            )

            impl = "cryptography"
        except Exception:
            impl = ""
    _aead_impl = impl
    return impl or None


def _gcm_nonce(role: bytes, seq: int) -> bytes:
    return (role or b"?")[:1] + seq.to_bytes(8, "big") + b"\x00\x00\x00"


def _gcm_key(session_key: bytes) -> bytes:
    # session keys are HMAC-SHA256 outputs (32 bytes) — AES-256 direct
    return session_key if len(session_key) == 32 else \
        hashlib.sha256(session_key).digest()


def _native_gcm(op: str, key: bytes, nonce: bytes,
                data: bytes) -> Optional[bytes]:
    import ctypes

    from ceph_tpu_torch import native

    lib = native.get_lib()
    u8 = ctypes.c_uint8
    n = len(data)
    if op == "seal":
        out = (u8 * (n + 16))()
        fn, outlen = lib.ceph_tpu_aesgcm_seal, n + 16
    else:
        if n < 16:
            return None
        out = (u8 * max(1, n - 16))()
        fn, outlen = lib.ceph_tpu_aesgcm_open, n - 16
    src = (u8 * max(1, n)).from_buffer_copy(data or b"\x00")
    rc = fn((u8 * 32).from_buffer_copy(key),
            (u8 * 12).from_buffer_copy(nonce),
            (u8 * 1)(), 0, src, n, out)
    if rc != 0:
        return None
    return bytes(out[:outlen])


def _xor_keystream(session_key: bytes, role: bytes, seq: int,
                   data: bytes) -> bytes:
    if not data:
        return data
    ks = hashlib.shake_256(
        session_key + role + seq.to_bytes(8, "big")).digest(len(data))
    import numpy as np

    a = np.frombuffer(data, dtype=np.uint8)
    b = np.frombuffer(ks, dtype=np.uint8)
    return (a ^ b).tobytes()


def aead_available() -> bool:
    """Capability probe for the MHello aead advertisement: peers
    negotiate the sealing mode instead of guessing from their OWN
    toolchain (a no-AEAD peer is a legitimate fallback, not an
    attack — but only when it SAYS so in its signed hello)."""
    return _resolve_aead() is not None


def seal(session_key: bytes, role: bytes, seq: int,
         data: bytes, peer_aead: Optional[bool] = None) -> bytes:
    """peer_aead: the peer's hello-advertised AEAD capability (None =
    unknown).  A peer that advertised False cannot open AES-GCM, so
    the frame legitimately falls back to the keystream mode."""
    impl = _resolve_aead()
    if impl is None or peer_aead is False:
        return bytes([MODE_XOR]) + _xor_keystream(session_key, role,
                                                  seq, data)
    key, nonce = _gcm_key(session_key), _gcm_nonce(role, seq)
    if impl == "native":
        ct = _native_gcm("seal", key, nonce, data)
        if ct is not None:
            return bytes([MODE_AESGCM]) + ct
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    return bytes([MODE_AESGCM]) + AESGCM(key).encrypt(nonce, data,
                                                      None)


class SealError(Exception):
    """Authentication failure or downgrade attempt on a secure frame."""


def unseal(session_key: bytes, role: bytes, seq: int,
           data: bytes, peer_aead: Optional[bool] = None) -> bytes:
    """peer_aead: the peer's hello-advertised AEAD capability (None =
    unknown).  Gates the downgrade check below: a keystream frame is
    legitimate from a peer that ADVERTISED no AEAD (its hello is
    signed, so the advertisement is authentic), and an attack when the
    peer is known or presumed capable."""
    if not data:
        raise SealError("empty secure payload")
    mode, body = data[0], data[1:]
    impl = _resolve_aead()
    if mode == MODE_AESGCM:
        if impl is None:
            raise SealError("peer sent AES-GCM but no AEAD available")
        key, nonce = _gcm_key(session_key), _gcm_nonce(role, seq)
        if impl == "native":
            pt = _native_gcm("open", key, nonce, body)
            if pt is None:
                raise SealError("AES-GCM tag mismatch")
            return pt
        from cryptography.exceptions import InvalidTag
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        try:
            return AESGCM(key).decrypt(nonce, body, None)
        except InvalidTag:
            raise SealError("AES-GCM tag mismatch")
    if mode == MODE_XOR:
        if impl is not None and peer_aead is not False:
            # the peer either advertised AEAD or never said (same-
            # version peers always advertise): a keystream frame here
            # is a downgrade (an attacker flipping the mode byte), not
            # a legitimate fallback
            raise SealError("keystream frame from an AEAD-capable"
                            " peer: downgrade rejected")
        return _xor_keystream(session_key, role, seq, body)
    raise SealError(f"unknown secure mode {mode:#x}")


# -- mon-as-KDC tickets ------------------------------------------------------


def auth_proof(key: bytes, entity: str, client_challenge: bytes,
               server_challenge: bytes) -> bytes:
    """Client's proof of key possession (the CephxServiceHandler
    challenge-hash role)."""
    return _prf(key, b"cephx-proof", entity.encode(),
                client_challenge, server_challenge)[:SIG_LEN]


def check_proof(key: bytes, entity: str, client_challenge: bytes,
                server_challenge: bytes, proof: bytes) -> bool:
    """Constant-time validation of a client's proof (the verify()
    sibling of auth_proof)."""
    return hmac.compare_digest(
        auth_proof(key, entity, client_challenge, server_challenge),
        bytes(proof))


def make_ticket(keyring: Keyring, entity: str,
                lifetime: float = TICKET_LIFETIME) -> bytes:
    """Signed expiring assertion; blob = json || sig."""
    blob = json.dumps({
        "entity": entity,
        "expires": time.time() + lifetime,
        "kid": keyring.active,
        "nonce": os.urandom(8).hex(),
    }, sort_keys=True).encode()
    return blob + sign(keyring.active_key, b"cephx-ticket", blob)


def ticket_base_key(key: bytes, blob: bytes) -> bytes:
    return _prf(key, b"cephx-ticket-base", blob)


def check_ticket(keyring: Keyring, ticket: bytes
                 ) -> Optional[Tuple[str, bytes]]:
    """Validate a ticket offline; returns (entity, base_key) or None."""
    if len(ticket) <= SIG_LEN:
        return None
    blob, sig = ticket[:-SIG_LEN], ticket[-SIG_LEN:]
    try:
        doc = json.loads(blob)
        kid = int(doc["kid"])
    except (ValueError, KeyError, TypeError):
        return None
    key = keyring.get(kid)
    if key is None:
        return None
    if not verify(key, sig, b"cephx-ticket", blob):
        return None
    if doc.get("expires", 0) < time.time():
        return None
    return str(doc.get("entity", "")), ticket_base_key(key, blob)
