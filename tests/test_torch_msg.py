"""The port's messenger tier (ceph_tpu_torch.msg), mirroring
tests/test_msg.py: frame discipline, message codecs, loopback dispatch and
wire compression.

Each test of the JAX file runs here on the port's modules; where the
result is bytes (frames, encoded messages), it is also held against the
JAX package's for the same input.  Every async test runs under its own
timeout, so a hang fails one test and not the run."""

import asyncio

import pytest

from ceph_tpu.msg import frames as jframes
from ceph_tpu.msg import messages as jmessages
from ceph_tpu_torch.msg import Messenger, frames
from ceph_tpu_torch.msg.messages import (
    MGetMap,
    MHello,
    MMonCommand,
    MMonCommandReply,
    MOSDBoot,
    MOSDFailure,
    MOSDMapMsg,
    MOSDOp,
    MOSDOpReply,
    MOSDSubRead,
    MOSDSubReadReply,
    MOSDSubWrite,
    MOSDSubWriteReply,
    MPGLogMsg,
    MPGQuery,
    MPing,
    OSDOp,
    PING,
    ShardOp,
    decode_message,
)
from ceph_tpu_torch.osd.osdmap import PgId


# -- frames ----------------------------------------------------------------


def test_frame_round_trip():
    payload = b"hello frame" * 100
    buf = frames.encode_frame(9, 7, payload)
    tag, flags, seq, length = frames.decode_preamble(
        buf[:frames.PREAMBLE_WIRE_LEN])
    assert (tag, flags, seq, length) == (9, 0, 7, len(payload))
    body = buf[frames.PREAMBLE_WIRE_LEN:frames.PREAMBLE_WIRE_LEN + length]
    frames.check_payload(body, buf[-4:])
    assert body == payload


def test_frame_bytes_equal_jax():
    payload = b"hello frame" * 100
    assert frames.encode_frame(9, 7, payload) == \
        jframes.encode_frame(9, 7, payload)


def test_frame_bad_magic_rejected():
    buf = bytearray(frames.encode_frame(1, 0, b"x"))
    buf[0] ^= 0xFF
    with pytest.raises(frames.FrameError):
        frames.decode_preamble(bytes(buf[:frames.PREAMBLE_WIRE_LEN]))


def test_frame_preamble_crc_enforced():
    buf = bytearray(frames.encode_frame(1, 0, b"x"))
    buf[8] ^= 0x01  # flip a seq bit; crc must catch it
    with pytest.raises(frames.FrameError):
        frames.decode_preamble(bytes(buf[:frames.PREAMBLE_WIRE_LEN]))


def test_frame_payload_crc_enforced():
    payload = b"payload bytes"
    buf = bytearray(frames.encode_frame(1, 0, payload))
    buf[frames.PREAMBLE_WIRE_LEN] ^= 0x80
    body = bytes(buf[frames.PREAMBLE_WIRE_LEN:
                     frames.PREAMBLE_WIRE_LEN + len(payload)])
    with pytest.raises(frames.FrameError):
        frames.check_payload(body, bytes(buf[-4:]))


# -- message codecs --------------------------------------------------------


MESSAGES = [
    MHello("osd.3", "127.0.0.1:6800"),
    MPing(PING, 123.5, epoch=9, from_osd=2),
    MOSDBoot(5, "127.0.0.1:6805", boot_epoch=3),
    MOSDFailure(7, 2, 21.5, 14),
    MGetMap(since_epoch=4, subscribe=True),
    MOSDMapMsg(9, full_map=b"FULLMAP", incrementals=[b"i1", b"i2"]),
    MMonCommand(11, {"prefix": "osd pool create", "name": "data"}),
    MMonCommandReply(11, 0, {"pool_id": 1}),
    MOSDOp(42, "client.1", PgId(1, 0x1f), "obj-a",
           [OSDOp("write_full", data=b"payload"),
            OSDOp("setxattr", args={"name": "k"}, data=b"v")], 7),
    MOSDOpReply(42, 0, b"result", {"size": 7}, replay_epoch=8),
    MOSDSubWrite(43, PgId(2, 3), 1, "obj-b",
                 [ShardOp("create"), ShardOp("write", 0, b"shard data"),
                  ShardOp("setattr", name="hinfo_key", value=b"{}")],
                 epoch=7,
                 log_entry={"version": [7, 4], "op": "modify"},
                 from_osd=0),
    MOSDSubWriteReply(43, 0, shard=1),
    MOSDSubRead(44, PgId(2, 3), 2, "obj-b", 0, 4096, want_attrs=True),
    MOSDSubReadReply(44, 0, b"shard bytes", {"_": b"oi"}, shard=2),
    MPGQuery(45, PgId(2, 3), 9, from_osd=0),
    MPGLogMsg(45, PgId(2, 3), 1, {"last_update": [9, 12]},
              [{"version": [9, 12], "oid": "x", "op": "modify"}],
              epoch=9, from_osd=1),
]


@pytest.mark.parametrize(
    "msg", MESSAGES, ids=[type(m).__name__ for m in MESSAGES])
def test_message_round_trip(msg):
    back = decode_message(msg.TAG, msg.encode())
    assert type(back) is type(msg)
    for key, val in vars(msg).items():
        if key.startswith("_"):
            continue
        got = getattr(back, key)
        if key == "ops":
            assert [vars(o) for o in got] == [vars(o) for o in val]
        else:
            assert got == val, f"{type(msg).__name__}.{key}"


@pytest.mark.parametrize(
    "msg", MESSAGES, ids=[type(m).__name__ for m in MESSAGES])
def test_message_bytes_equal_jax(msg):
    """The same message built from the JAX package's classes encodes to
    the same bytes, and the JAX package decodes the port's."""
    raw = msg.encode()
    jmsg = jmessages.decode_message(msg.TAG, raw)
    assert type(jmsg).__name__ == type(msg).__name__
    assert jmsg.encode() == raw


def test_unknown_tag_rejected():
    with pytest.raises(ValueError):
        decode_message(250, b"")


# -- live loopback exchange ------------------------------------------------


def test_loopback_request_reply():
    async def main():
        server = Messenger("osd.0")
        client = Messenger("client.1")
        got = asyncio.Queue()

        async def server_dispatch(conn, msg):
            assert conn.peer_name == "client.1"  # MHello applied
            await conn.send(MOSDOpReply(msg.tid, 0, b"pong"))

        async def client_dispatch(conn, msg):
            await got.put(msg)

        server.dispatcher = server_dispatch
        client.dispatcher = client_dispatch
        addr = await server.bind()
        conn = await client.connect(addr)
        await conn.send(MOSDOp(7, "client.1", PgId(1, 0), "o",
                               [OSDOp("read")], 1))
        reply = await asyncio.wait_for(got.get(), 5)
        assert reply.tid == 7 and reply.data == b"pong"
        # connection reuse: same object for the same addr
        assert await client.connect(addr) is conn
        await client.shutdown()
        await server.shutdown()

    asyncio.run(asyncio.wait_for(main(), 60))


def test_loopback_many_messages_ordered_and_intact():
    async def main():
        server = Messenger("osd.0")
        client = Messenger("client.1")
        received = []
        done = asyncio.Event()

        async def server_dispatch(conn, msg):
            received.append(msg)
            if len(received) == 50:
                done.set()

        server.dispatcher = server_dispatch
        addr = await server.bind()
        conn = await client.connect(addr)
        for i in range(50):
            await conn.send(MOSDOp(i, "client.1", PgId(1, i), f"obj{i}",
                                   [OSDOp("write_full",
                                          data=bytes([i]) * 1000)], 1))
        await asyncio.wait_for(done.wait(), 10)
        assert [m.tid for m in received] == list(range(50))
        assert all(m.ops[0].data == bytes([m.tid]) * 1000
                   for m in received)
        await client.shutdown()
        await server.shutdown()

    asyncio.run(asyncio.wait_for(main(), 60))


def test_connection_fault_callback():
    async def main():
        server = Messenger("osd.0")
        client = Messenger("client.1")
        faulted = asyncio.Event()
        client.on_connection_fault = lambda conn: faulted.set()
        addr = await server.bind()
        conn = await client.connect(addr)
        await conn.send(MPing(PING, 1.0))
        await server.shutdown()  # server dies; client read loop faults
        await asyncio.wait_for(faulted.wait(), 5)
        assert conn.closed
        await client.shutdown()

    asyncio.run(asyncio.wait_for(main(), 60))


# -- wire compression negotiation (frames_v2 compression role) --------------


def _comp_pair(server_methods, client_methods, **kw):
    server = Messenger("osd.0")
    client = Messenger("client.1")
    server.compress_methods = server_methods
    client.compress_methods = client_methods
    for k, v in kw.items():
        setattr(server, k, v)
        setattr(client, k, v)
    return server, client


def test_compression_negotiated_and_round_trips():
    """Both ends accept snappy: bulk frames ride compressed (flag on
    the wire, payload smaller) and round-trip byte-exact."""
    async def main():
        server, client = _comp_pair(("snappy", "zlib"), ("snappy",))
        got = asyncio.Queue()
        seen_flags = []

        orig = frames.decode_preamble

        def spy(buf):
            out = orig(buf)
            seen_flags.append(out[1])
            return out

        frames.decode_preamble = spy
        try:
            async def server_dispatch(conn, msg):
                await conn.send(MOSDOpReply(msg.tid, 0, msg.ops[0].data))

            server.dispatcher = server_dispatch
            client.dispatcher = lambda c, m: got.put(m)
            addr = await server.bind()
            conn = await client.connect(addr)
            # compressible payload well over min_size
            data = b"compress me! " * 20_000
            await conn.send(MOSDOp(9, "client.1", PgId(1, 0), "o",
                                   [OSDOp("write", data=data)], 1))
            reply = await asyncio.wait_for(got.get(), 5)
            assert bytes(reply.data) == data
            assert any(f & frames.FLAG_COMPRESSED for f in seen_flags), \
                "no frame carried FLAG_COMPRESSED"
            # the first client frame may race the server's hello
            # (keyless conns negotiate opportunistically); by the
            # second send both directions are settled on snappy
            await conn.send(MOSDOp(10, "client.1", PgId(1, 0), "o",
                                   [OSDOp("write", data=data)], 1))
            reply = await asyncio.wait_for(got.get(), 5)
            assert bytes(reply.data) == data
            assert conn._tx_comp[0] == "snappy"
        finally:
            frames.decode_preamble = orig
            await client.shutdown()
            await server.shutdown()

    asyncio.run(asyncio.wait_for(main(), 60))


def test_compression_no_common_method_stays_plain():
    async def main():
        server, client = _comp_pair(("zlib",), ("snappy",))
        got = asyncio.Queue()

        async def server_dispatch(conn, msg):
            await conn.send(MOSDOpReply(msg.tid, 0, msg.ops[0].data))

        server.dispatcher = server_dispatch
        client.dispatcher = lambda c, m: got.put(m)
        addr = await server.bind()
        conn = await client.connect(addr)
        data = b"plain " * 10_000
        await conn.send(MOSDOp(1, "client.1", PgId(1, 0), "o",
                               [OSDOp("write", data=data)], 1))
        reply = await asyncio.wait_for(got.get(), 5)
        assert bytes(reply.data) == data
        assert conn._negotiated_comp("tx") is None
        await client.shutdown()
        await server.shutdown()

    asyncio.run(asyncio.wait_for(main(), 60))


def test_compressed_frame_truncated_length_prefix_dropped():
    """A frame with FLAG_COMPRESSED but a <4-byte payload (the length
    prefix itself truncated) must take the malformed-frame drop path —
    not escape the read loop as a raw struct.error — and the server
    must keep serving other connections."""
    async def main():
        server, client = _comp_pair(("snappy",), ("snappy",))
        got = asyncio.Queue()

        async def server_dispatch(conn, msg):
            await conn.send(MOSDOpReply(msg.tid, 0, b"ok"))

        server.dispatcher = server_dispatch
        client.dispatcher = lambda c, m: got.put(m)
        addr = await server.bind()
        conn = await client.connect(addr)
        # settle negotiation (hello exchange) with one normal op
        await conn.send(MOSDOp(1, "client.1", PgId(1, 0), "o",
                               [OSDOp("read")], 1))
        await asyncio.wait_for(got.get(), 5)
        # hand-craft the poison frame on the raw socket
        conn.writer.write(frames.encode_frame(
            MOSDOp.TAG, next(conn._seq), b"\x01",
            flags=frames.FLAG_COMPRESSED))
        await conn.writer.drain()
        # server drops that connection...
        for _ in range(100):
            if conn.reader.at_eof():
                break
            await asyncio.sleep(0.05)
        assert conn.reader.at_eof(), "poison frame did not drop conn"
        # ...and still serves a fresh one
        conn2 = await client.connect(addr)
        await conn2.send(MOSDOp(2, "client.1", PgId(1, 0), "o",
                                [OSDOp("read")], 1))
        reply = await asyncio.wait_for(got.get(), 5)
        assert reply.tid == 2
        await client.shutdown()
        await server.shutdown()

    asyncio.run(asyncio.wait_for(main(), 60))


def test_compression_secure_gated():
    """On an AEAD connection compression stays OFF unless
    ms_compress_secure opts in (length side channel)."""
    async def main():
        from ceph_tpu_torch.common import auth as auth_mod

        secret = auth_mod.generate_secret()
        for opt_in in (False, True):
            server, client = _comp_pair(("snappy",), ("snappy",),
                                        compress_secure=opt_in)
            server.secret = auth_mod.parse_secret(secret)
            client.secret = auth_mod.parse_secret(secret)
            server.secure = client.secure = True
            got = asyncio.Queue()

            async def server_dispatch(conn, msg):
                await conn.send(MOSDOpReply(msg.tid, 0, b"ok"))

            server.dispatcher = server_dispatch
            client.dispatcher = lambda c, m: got.put(m)
            addr = await server.bind()
            conn = await client.connect(addr)
            data = b"secret " * 10_000
            await conn.send(MOSDOp(2, "client.1", PgId(1, 0), "o",
                                   [OSDOp("write", data=data)], 1))
            reply = await asyncio.wait_for(got.get(), 5)
            assert reply.data == b"ok"
            # inspect what the sender actually did on the last bulk
            # frame via the negotiated state: with the gate closed the
            # compressor is never even resolved
            if not opt_in:
                assert conn._tx_comp is None, \
                    "secure frame compressed without ms_compress_secure"
            await client.shutdown()
            await server.shutdown()

    asyncio.run(asyncio.wait_for(main(), 60))
