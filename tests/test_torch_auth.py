"""cephx-lite in the port (ceph_tpu_torch.common.auth and the messenger's
signed and sealed frames), mirroring the mon- and messenger-only parts of
tests/test_auth.py, each held against the JAX package where the result is
bytes: signatures, session keys, tickets, signed frames and sealed
payloads are equal, and each package accepts the other's.

The JAX file's tests that write and read objects through RadosClient and
OSD daemons (the data-path halves of its keyed-cluster, key-rotation,
ticket and secure-mode tests) wait for the OSD daemon and the client,
the next slice of the port; here the same properties are checked on the
mon path: a keyed mon accepts keyed clients and drops unkeyed and
wrong-keyed ones, a recorded session replayed on a new connection and a
frame replayed within one are dropped, rotation accepts both listed keys,
the mon grants tickets and refuses a forged proof, and secure mode puts
no plaintext on the wire.
"""

import asyncio
import ctypes
import random

import pytest

from ceph_tpu.common import auth as jauth
from ceph_tpu.msg import frames as jframes
from ceph_tpu_torch import native
from ceph_tpu_torch.common import auth
from ceph_tpu_torch.mon import MonDaemon
from ceph_tpu_torch.msg import frames
from ceph_tpu_torch.msg.messages import MAuth

from torch_mon_helpers import MonClient


def run(coro, timeout: float = 60):
    asyncio.run(asyncio.wait_for(coro, timeout))


def _key(seed: int) -> bytes:
    return random.Random(seed).randbytes(32)


@pytest.fixture
def wire_transport():
    """Real sockets for the tests that observe wire bytes."""
    import ceph_tpu_torch.msg as msg_mod

    old = msg_mod.LOCAL_FASTPATH
    msg_mod.LOCAL_FASTPATH = False
    yield
    msg_mod.LOCAL_FASTPATH = old


# -- units, against the JAX package ------------------------------------------


def test_sign_verify_unit():
    key = auth.parse_secret(auth.generate_secret()).active_key
    sig = auth.sign(key, b"pre", b"payload")
    assert len(sig) == auth.SIG_LEN
    assert sig == jauth.sign(key, b"pre", b"payload")
    assert auth.verify(key, sig, b"pre", b"payload")
    assert not auth.verify(key, sig, b"pre", b"tampered")
    other = auth.parse_secret(auth.generate_secret()).active_key
    assert not auth.verify(other, sig, b"pre", b"payload")
    assert auth.parse_secret(None) is None
    assert auth.parse_secret("") is None


def test_keyring_rotation_format():
    a, b = auth.generate_secret(), auth.generate_secret()
    ring = auth.parse_secret(f"2:{a},1:{b}")
    jring = jauth.parse_secret(f"2:{a},1:{b}")
    assert (ring.active, ring.keys) == (jring.active, jring.keys)
    assert ring.active == 2
    assert ring.active_key == bytes.fromhex(a)
    assert ring.get(1) == bytes.fromhex(b)
    assert ring.get(9) is None
    ring0 = auth.parse_secret(a)
    assert ring0.active == 0 and ring0.active_key == bytes.fromhex(a)


def test_session_key_derivation_and_tickets():
    secret = auth.generate_secret()
    ring, jring = auth.parse_secret(secret), jauth.parse_secret(secret)
    na, nb = auth.new_nonce(), auth.new_nonce()
    s1 = auth.derive_session(ring.active_key, na, nb)
    assert s1 == auth.derive_session(ring.active_key, na, nb)
    assert s1 == jauth.derive_session(ring.active_key, na, nb)
    assert auth.derive_session(ring.active_key, auth.new_nonce(),
                               nb) != s1
    assert auth.auth_proof(ring.active_key, "client.a", na, nb) == \
        jauth.auth_proof(ring.active_key, "client.a", na, nb)
    ticket = auth.make_ticket(ring, "client.alice", lifetime=60)
    entity, base = auth.check_ticket(ring, ticket)
    assert entity == "client.alice" and base != ring.active_key
    # each package accepts the other's tickets, with the same base key
    assert jauth.check_ticket(jring, ticket) == (entity, base)
    jticket = jauth.make_ticket(jring, "client.bob", lifetime=60)
    assert auth.check_ticket(ring, jticket) == \
        jauth.check_ticket(jring, jticket)
    assert auth.check_ticket(ring, ticket[:-1] + b"\x00") is None
    assert auth.check_ticket(
        ring, auth.make_ticket(ring, "client.alice", lifetime=-1)) is None
    other = auth.parse_secret(auth.generate_secret())
    assert auth.check_ticket(ring, auth.make_ticket(other, "x")) is None


def test_frame_signing_round_trip():
    key = auth.parse_secret(auth.generate_secret()).active_key
    frame = frames.encode_frame(7, 1, b"hello", key=key, role=b"c")
    assert frame == jframes.encode_frame(7, 1, b"hello", key=key, role=b"c")
    pre = frame[:frames.PREAMBLE_WIRE_LEN]
    tag, flags, _seq, length = frames.decode_preamble(pre)
    assert flags & frames.FLAG_SIGNED
    payload = frame[frames.PREAMBLE_WIRE_LEN:
                    frames.PREAMBLE_WIRE_LEN + length]
    sig = frame[-auth.SIG_LEN:]
    frames.check_signature(key, flags, pre, payload, sig, role=b"c")
    jframes.check_signature(key, flags, pre, payload, sig, role=b"c")
    with pytest.raises(frames.FrameError):
        frames.check_signature(key, flags, pre, b"hellp", sig, role=b"c")
    with pytest.raises(frames.FrameError):  # the other direction's role
        frames.check_signature(key, flags, pre, payload, sig, role=b"s")
    plain = frames.encode_frame(7, 1, b"hello")
    _t, pflags, _s, _l = frames.decode_preamble(
        plain[:frames.PREAMBLE_WIRE_LEN])
    with pytest.raises(frames.FrameError):
        frames.check_signature(key, pflags,
                               plain[:frames.PREAMBLE_WIRE_LEN],
                               b"hello", b"")
    frames.check_signature(None, pflags, plain[:frames.PREAMBLE_WIRE_LEN],
                           b"hello", b"")


def test_seal_unseal_unit():
    key = auth.parse_secret(auth.generate_secret()).active_key
    data = b"x" * 100_000
    ct = auth.seal(key, b"c", 7, data)
    assert auth._resolve_aead() == "native"
    assert ct[0] == auth.MODE_AESGCM and ct != data
    assert ct == jauth.seal(key, b"c", 7, data)
    assert auth.unseal(key, b"c", 7, ct) == data
    assert jauth.unseal(key, b"c", 7, ct) == data
    assert auth.seal(key, b"s", 7, data) != ct
    assert auth.seal(key, b"c", 8, data) != ct
    e = auth.seal(key, b"c", 7, b"")
    assert len(e) == 17 and auth.unseal(key, b"c", 7, e) == b""


def test_aead_negative_paths():
    key = auth.parse_secret(auth.generate_secret()).active_key
    data = b"secret frame payload" * 100
    ct = auth.seal(key, b"c", 7, data)
    bad = bytearray(ct)
    bad[len(bad) // 2] ^= 1
    with pytest.raises(auth.SealError):
        auth.unseal(key, b"c", 7, bytes(bad))
    with pytest.raises(auth.SealError):
        auth.unseal(key, b"s", 7, ct)
    with pytest.raises(auth.SealError):
        auth.unseal(key, b"c", 8, ct)
    with pytest.raises(auth.SealError):
        auth.unseal(key, b"c", 7, ct[:10])
    with pytest.raises(auth.SealError):
        auth.unseal(key, b"c", 7, bytes([auth.MODE_XOR]) + ct[1:])
    c1 = auth.seal(key, b"c", 1, data)
    c2 = auth.seal(key, b"c", 2, data)
    assert c1[1:33] != c2[1:33]


def test_aead_capability_negotiation():
    key = auth.parse_secret(auth.generate_secret()).active_key
    data = b"mixed-capability frame" * 50
    ct = auth.seal(key, b"c", 3, data, peer_aead=False)
    assert ct[0] == auth.MODE_XOR
    assert ct == jauth.seal(key, b"c", 3, data, peer_aead=False)
    assert auth.unseal(key, b"c", 3, ct, peer_aead=False) == data
    with pytest.raises(auth.SealError):
        auth.unseal(key, b"c", 3, ct, peer_aead=True)
    with pytest.raises(auth.SealError):
        auth.unseal(key, b"c", 3, ct)
    assert auth.seal(key, b"c", 3, data,
                     peer_aead=True)[0] == auth.MODE_AESGCM


def test_native_aesgcm_matches_cryptography():
    """The port's copy of the C++ AES-GCM against `cryptography`'s
    OpenSSL-backed AESGCM (the JAX test's independent cross-check)."""
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    lib = native.get_lib()
    u8 = ctypes.c_uint8
    rng = random.Random(7)
    for _ in range(40):
        key = rng.randbytes(32)
        iv = rng.randbytes(12)
        pt = rng.randbytes(rng.choice([0, 1, 15, 16, 17, 4096]))
        out = (u8 * (len(pt) + 16))()
        rc = lib.ceph_tpu_aesgcm_seal(
            (u8 * 32).from_buffer_copy(key), (u8 * 12).from_buffer_copy(iv),
            (u8 * 1)(), 0,
            (u8 * max(1, len(pt))).from_buffer_copy(pt or b"\x00"),
            len(pt), out)
        assert rc == 0
        assert bytes(out) == AESGCM(key).encrypt(iv, pt, None)


# -- the mon path --------------------------------------------------------------


async def _mon(secret, secure: bool = False):
    mon = MonDaemon(2, osds_per_host=1,
                    config={"auth_secret": secret, "auth_secure": secure})
    return mon, await mon.start()


async def _refused(client: MonClient) -> bool:
    try:
        await client.command({"prefix": "status"}, timeout=1.0, attempts=2)
    except AssertionError:
        return True
    return False


def test_keyed_mon_accepts_keyed_rejects_unkeyed():
    secret = auth.generate_secret()

    async def main():
        mon, addr = await _mon(secret)
        clients = [MonClient([addr], secret=secret),
                   MonClient([addr]),
                   MonClient([addr], secret=auth.generate_secret())]
        try:
            rc, out = await clients[0].command({"prefix": "status"})
            assert rc == 0 and out["num_osds"] == 2
            assert await _refused(clients[1]), "unkeyed client served"
            assert await _refused(clients[2]), "wrong-keyed client served"
        finally:
            for c in clients:
                await c.shutdown()
            await mon.shutdown()

    run(main())


def test_replayed_recorded_session_is_rejected(wire_transport):
    """A whole recorded session (hello and signed command frames) replayed
    byte for byte on a new connection is dropped and does not execute."""
    secret = auth.generate_secret()

    async def main():
        import ceph_tpu_torch.msg as msg_mod

        mon, addr = await _mon(secret)
        try:
            recorded = bytearray()
            client = MonClient([addr], secret=secret)
            orig_oc = msg_mod.asyncio.open_connection

            async def tee_oc(*args, **kw):
                r, w = await orig_oc(*args, **kw)
                ow = w.write

                def tee(data, _ow=ow):
                    recorded.extend(data)
                    return _ow(data)

                w.write = tee
                return r, w

            msg_mod.asyncio.open_connection = tee_oc
            try:
                rc, _ = await client.command(
                    {"prefix": "osd pool create", "name": "legit",
                     "pg_num": 4, "pool_type": "replicated", "size": 2})
                assert rc == 0
            finally:
                msg_mod.asyncio.open_connection = orig_oc
            await client.shutdown()
            tag0, _f, _s, _l = frames.decode_preamble(
                bytes(recorded[:frames.PREAMBLE_WIRE_LEN]))
            assert tag0 == 1, "hello not captured"
            pools_before = len(mon.osdmap.pools)
            host, port = addr.rsplit(":", 1)
            reader, writer = await asyncio.open_connection(host, int(port))
            writer.write(bytes(recorded))
            await writer.drain()
            try:
                while await asyncio.wait_for(reader.read(1 << 16), 5.0):
                    pass
            except asyncio.TimeoutError:
                pass
            writer.close()
            await asyncio.sleep(0.2)
            assert len(mon.osdmap.pools) == pools_before, \
                "replayed command executed"
        finally:
            await mon.shutdown()

    run(main())


def test_in_connection_replay_rejected_by_seq(wire_transport):
    secret = auth.generate_secret()

    async def main():
        mon, addr = await _mon(secret)
        client = MonClient([addr], secret=secret)
        try:
            conn = await client.msgr.connect(addr)
            captured = []
            orig_write = conn.writer.write

            def tee(data):
                captured.append(bytes(data))
                return orig_write(data)

            conn.writer.write = tee
            rc, _ = await client.command({"prefix": "status"})
            assert rc == 0
            conn.writer.write = orig_write
            for chunk in captured:
                conn.writer.write(chunk)
            await conn.writer.drain()
            await asyncio.sleep(0.3)
            assert conn.closed or conn.reader.at_eof(), \
                "in-session replay not rejected"
        finally:
            await client.shutdown()
            await mon.shutdown()

    run(main())


def test_key_rotation_overlap():
    old_k, new_k = auth.generate_secret(), auth.generate_secret()

    async def main():
        mon, addr = await _mon(f"2:{new_k},1:{old_k}")
        clients = [MonClient([addr], secret=f"1:{old_k}"),
                   MonClient([addr], secret=f"2:{new_k}"),
                   MonClient([addr], secret=f"9:{auth.generate_secret()}")]
        try:
            for c in clients[:2]:
                rc, _ = await c.command(
                    {"prefix": "osd pool create", "name": f"p{c.msgr.secret.active}",
                     "pg_num": 4, "pool_type": "replicated", "size": 2})
                assert rc == 0
            assert await _refused(clients[2]), "an unlisted key was served"
        finally:
            for c in clients:
                await c.shutdown()
            await mon.shutdown()

    run(main())


def test_ticket_grant_and_refused_forgery():
    """The mon grants a ticket for a valid proof (either package checks it
    offline) and refuses a forged one."""
    secret = auth.generate_secret()

    async def main():
        mon, addr = await _mon(secret)
        client = MonClient([addr], secret=secret)
        try:
            ring = client.msgr.secret
            entity = client.msgr.entity_name
            r1 = await client.request(MAuth(client.next_tid(), entity, 1))
            assert r1.rc == 0 and len(r1.server_challenge) == auth.NONCE_LEN
            cc = auth.new_nonce()
            proof = auth.auth_proof(ring.active_key, entity, cc,
                                    bytes(r1.server_challenge))
            r2 = await client.request(MAuth(
                client.next_tid(), entity, 2, kid=ring.active,
                client_challenge=cc, proof=proof))
            assert r2.rc == 0
            got = auth.check_ticket(ring, bytes(r2.ticket))
            assert got is not None and got[0] == entity
            assert jauth.check_ticket(jauth.parse_secret(secret),
                                      bytes(r2.ticket)) == got
            await client.request(MAuth(client.next_tid(), "client.evil", 1))
            bad = await client.request(MAuth(
                client.next_tid(), "client.evil", 2, kid=0,
                client_challenge=b"x" * 16, proof=b"bogus!!!"))
            assert bad.rc != 0
        finally:
            await client.shutdown()
            await mon.shutdown()

    run(main())


def test_secure_mode_encrypts_the_wire(wire_transport):
    """With auth_secure on, a command's payload never shows on the wire,
    and a keyed but plaintext client is refused."""
    secret = auth.generate_secret()
    marker = "SUPER-SECRET-PAYLOAD-MARKER"

    async def main():
        import ceph_tpu_torch.msg as msg_mod

        mon, addr = await _mon(secret, secure=True)
        client = MonClient([addr], secret=secret, secure=True)
        plain = MonClient([addr], secret=secret, secure=False)
        try:
            sniffed = bytearray()
            orig_oc = msg_mod.asyncio.open_connection

            async def tee_oc(*args, **kw):
                r, w = await orig_oc(*args, **kw)
                ow = w.write

                def tee(data, _ow=ow):
                    sniffed.extend(data)
                    return _ow(data)

                w.write = tee
                return r, w

            msg_mod.asyncio.open_connection = tee_oc
            try:
                rc, _ = await client.command(
                    {"prefix": "config set", "who": "global",
                     "name": "note", "value": marker * 200})
                assert rc == 0
                rc, out = await client.command(
                    {"prefix": "config get", "who": "global"})
                assert out["config"]["note"] == marker * 200
            finally:
                msg_mod.asyncio.open_connection = orig_oc
            assert len(sniffed) > len(marker) * 200
            assert marker.encode() not in bytes(sniffed), \
                "plaintext on the wire in secure mode"
            assert await _refused(plain), "a plaintext client was served"
        finally:
            await client.shutdown()
            await plain.shutdown()
            await mon.shutdown()

    run(main())
