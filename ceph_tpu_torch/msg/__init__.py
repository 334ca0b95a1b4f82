"""Async messenger (L3) (port of ceph_tpu/msg/__init__.py).

Reference parity: AsyncMessenger + Connection + Dispatcher
(the reference's src/msg/Messenger.h:1-824, src/msg/async/) re-designed
on asyncio: each daemon owns one event loop; connections are asyncio
streams carrying crc32c-framed messages (frames.py, the frames_v2
discipline).  Dispatch is fast-dispatch only — a received message is
handed straight to the dispatcher coroutine, no DispatchQueue thread
(DispatchQueue.h:200-203's fast path is the only path here).

Authentication (cephx, common/auth.py): with a keyring configured, the
hello exchange is a mutual nonce handshake — each side's hello is
signed with a listed cluster key and carries a fresh nonce (plus an
optional mon ticket); both sides derive a per-connection SESSION key
and every later frame is signed with it and must arrive with a
strictly increasing sequence number.  A recorded frame therefore
verifies nowhere else (fresh nonces => fresh key), never twice on
the same connection (seq monotonicity), and never in the OPPOSITE
direction (the sender's role byte is bound into every signature, so
reflection by an active MITM fails) — the CephxSessionHandler
sign_message + session-key discipline.

Lossy-client semantics (src/msg/Policy.h): a dead connection is simply
forgotten; recovery is the caller's job (the Objecter-role client resends
ops on map change / reconnect, exactly like the reference's lossy client
policy).

Device note: this layer is pure host control-plane.  Bulk data riding in
messages stays bytes; the compute (EC encode, crc, placement) happens in
the OSD daemon's batched device dispatches before/after the wire.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import random
from typing import Awaitable, Callable, Dict, Optional

from ceph_tpu_torch.common import auth, lockdep
from ceph_tpu_torch.msg import frames
from ceph_tpu_torch.msg.messages import Message, MHello, decode_message

log = logging.getLogger("msgr")

DispatchFn = Callable[["Connection", Message], Awaitable[None]]

HANDSHAKE_TIMEOUT = 10.0

# Process-global kill switch for the in-process fast path (tests that
# must observe wire bytes — sniffers, frame-level auth tests — flip it)
LOCAL_FASTPATH = True

# bound addr -> Messenger, for same-process endpoint discovery
_LOCAL_REGISTRY: Dict[str, "Messenger"] = {}


class Connection:
    """One peer session (Connection role)."""

    def __init__(self, messenger: "Messenger",
                 reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter,
                 peer_name: str = "", peer_addr: str = "",
                 outbound: bool = False):
        self.messenger = messenger
        self.reader = reader
        self.writer = writer
        self.peer_name = peer_name
        self.peer_addr = peer_addr
        self.outbound = outbound
        self._seq = itertools.count()
        self._send_lock = lockdep.Lock("msg.send")
        self.closed = False
        # cephx session state
        self.session_key: Optional[bytes] = None
        self.session_ready = asyncio.Event()
        self.my_nonce: bytes = b""
        self.base_key: Optional[bytes] = None  # connector side choice
        # per-direction compression, negotiated from the two hellos
        # (frames_v2 compression negotiation): tx = first method the
        # PEER accepts that we support; rx = first method WE accept
        # that the peer supports.  None until the peer's hello arrives.
        self.peer_compress: tuple = ()
        # peer's hello-advertised AEAD capability (None until its
        # hello arrives; secure sends wait on session_ready, which is
        # set only after that hello is processed)
        self.peer_aead = None
        self._tx_comp = None   # (name, Compressor) | None
        self._rx_comp = None
        # acceptor replies with the CONNECTOR's kid: during rotation a
        # peer still on the old key must be able to verify our hello
        self.reply_kid: Optional[int] = None
        self.rx_seq = -1

    def _tx_role(self) -> bytes:
        return b"c" if self.outbound else b"s"

    def _rx_role(self) -> bytes:
        return b"s" if self.outbound else b"c"

    # a wedged peer (stopped reading, socket buffer full) must not
    # park drain() — and with it this connection's send lock — forever;
    # on timeout the connection dies and the next send reconnects
    DRAIN_TIMEOUT = 15.0

    async def send(self, msg: Message) -> None:
        key = None
        if self.messenger.secret is not None:
            if self.session_key is None:
                # wait out the handshake: pre-session frames would be
                # unverifiable at a keyed receiver
                try:
                    await asyncio.wait_for(self.session_ready.wait(),
                                           HANDSHAKE_TIMEOUT)
                except asyncio.TimeoutError:
                    self.close()
                    raise ConnectionError(
                        f"cephx handshake with {self.peer_name or self.peer_addr}"
                        " timed out")
            key = self.session_key
        await self._send_signed(msg, key)

    def _negotiated_comp(self, direction: str):
        """Resolve (lazily) the compressor for one direction from the
        two advertised method lists; None = no common method."""
        cached = self._tx_comp if direction == "tx" else self._rx_comp
        if cached is not None:
            return cached[1]
        mine = self.messenger.compress_methods
        theirs = self.peer_compress
        if not mine or not theirs:
            return None
        from ceph_tpu_torch.compressor import Compressor

        # the RECEIVER's preference order rules: tx picks from the
        # peer's list, rx from ours — both sides compute the same
        # method for each direction
        prefer, support = (theirs, mine) if direction == "tx" \
            else (mine, theirs)
        for name in prefer:
            if name in support:
                comp = Compressor.create(name)
                if comp is not None:
                    pair = (name, comp)
                    if direction == "tx":
                        self._tx_comp = pair
                    else:
                        self._rx_comp = pair
                    return comp
        return None

    async def _send_signed(self, msg: Message,
                           key: Optional[bytes]) -> None:
        if self.closed:
            raise ConnectionError(f"connection to {self.peer_name} closed")
        await self.messenger._inject_faults(self)
        payload = msg.encode()
        flags = 0
        m = self.messenger
        if not isinstance(msg, MHello) \
                and len(payload) >= m.compress_min_size \
                and (not m.secure or m.compress_secure):
            # negotiated wire compression (frames_v2 compression role;
            # secure connections compress only when ms_compress_secure
            # says so — compress-then-encrypt leaks payload entropy)
            comp = self._negotiated_comp("tx")
            if comp is not None:
                import struct as _struct

                # payload is the encoder's bytes: the codec walks it
                # directly, no defensive copy
                blob, cmsg = comp.compress(payload)
                if len(blob) + 4 < len(payload):
                    payload = _struct.pack(
                        "<i", -1 if cmsg is None else cmsg) + blob
                    flags |= frames.FLAG_COMPRESSED
        async with self._send_lock:
            # seq is allocated INSIDE the send lock: a hedged sub-read
            # may be CANCELLED while waiting for this lock, and a seq
            # consumed for a frame that never hits the wire would gap
            # the receiver's replay check (seq != rx_seq + 1 kills the
            # connection).  Past this point the only await is drain(),
            # by which time the frame is fully buffered — cancellation
            # can no longer corrupt framing.
            seq = next(self._seq)
            if key is not None and key is self.session_key and \
                    self.messenger.secure:
                # secure mode: the payload rides AEAD-sealed under the
                # session key (hellos stay plaintext — they carry no
                # secrets and exist before the session does)
                payload = auth.seal(key, self._tx_role(), seq, payload,
                                    peer_aead=self.peer_aead)
                flags |= frames.FLAG_SECURE
            parts = frames.encode_frame_parts(msg.TAG, seq,
                                              payload, flags=flags,
                                              key=key,
                                              role=self._tx_role())
            for part in parts:
                self.writer.write(part)
            try:
                await asyncio.wait_for(self.writer.drain(),
                                       self.DRAIN_TIMEOUT)
            except asyncio.TimeoutError:
                self.close()
                raise ConnectionError(
                    f"drain to {self.peer_name} timed out")

    async def send_hello(self, ticket: bytes = b"") -> None:
        """Handshake frame: signed with the ACTIVE static key (the only
        shared context before a session exists), carrying my nonce."""
        m = self.messenger
        if not self.my_nonce:
            self.my_nonce = auth.new_nonce()
        key = None
        kid = 0
        if m.secret is not None:
            kid = m.secret.active if self.reply_kid is None \
                else self.reply_kid
            key = m.secret.get(kid)
        hello = MHello(m.entity_name, m.addr, nonce=self.my_nonce,
                       kid=kid, ticket=ticket,
                       compression=",".join(m.compress_methods),
                       aead=auth.aead_available())
        await self._send_signed(hello, key)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            # wake handshake waiters: closed=True makes their send
            # raise immediately instead of riding out the timeout
            self.session_ready.set()
            try:
                self.writer.close()
            except Exception:
                pass

    def __repr__(self) -> str:
        return f"Connection(peer={self.peer_name}@{self.peer_addr})"


class LocalConnection(Connection):
    """In-process peer session: the loopback fast path.

    Reference parity: AsyncMessenger delivers messages addressed to an
    endpoint in the same process without serializing them onto a socket
    (Messenger::get_loopback_connection / DispatchQueue local_delivery,
    the reference's src/msg/DispatchQueue.h:200-245 local_delivery +
    Messenger.h loopback connection) — same discipline here: a Message
    object is handed to the peer dispatcher as-is, zero-copy, no
    framing, no signing (same-process peers share a trust domain; the
    fast path only engages when both endpoints hold the SAME keyring
    and secure flag, so a mis-keyed peer still takes the socket path
    and fails authentication honestly).

    Contract: a sent Message is TRANSFERRED — the sender must not
    mutate or resend the same instance (matching the reference, where
    a queued local message is owned by the dispatch queue).
    """

    def __init__(self, messenger: "Messenger", peer_name: str,
                 peer_addr: str, outbound: bool):
        self.messenger = messenger
        self.peer_name = peer_name
        self.peer_addr = peer_addr
        self.outbound = outbound
        self.closed = False
        self.session_key = None
        self._peer: Optional["LocalConnection"] = None

    async def send(self, msg: Message) -> None:
        peer = self._peer
        if self.closed or peer is None or peer.closed:
            raise ConnectionError(
                f"local connection to {self.peer_name} closed")
        # the fast path is still "the wire" for fault purposes: both
        # endpoints' injection settings apply, like a socket whose
        # either end can fail it
        await self.messenger._inject_faults(self)
        if peer.closed:
            raise ConnectionError(
                f"local connection to {self.peer_name} closed")
        try:
            await peer.messenger._inject_faults(peer)
        except ConnectionError:
            # receiver-side roll = the lost-ack shape: the message is
            # swallowed and the connection dies, but the SENDER returns
            # success — it cannot know the peer never dispatched
            # (mirrors the socket path, where the drop happens after
            # the sender's write completed)
            return
        m = peer.messenger
        if m.dispatcher is not None:
            if isinstance(msg, MHello):
                return  # identification already happened at connect
            m._spawn(m._dispatch_one(peer, msg))

    async def send_hello(self, ticket: bytes = b"") -> None:
        pass  # no handshake: identities were exchanged at connect

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        peer = self._peer
        m = self.messenger
        if m._conns.get(self.peer_addr) is self:
            del m._conns[self.peer_addr]
        if self in m._accepted:
            m._accepted.remove(self)
        if m.on_connection_fault is not None:
            try:
                m.on_connection_fault(self)
            except Exception:
                log.exception("connection fault handler failed")
        if peer is not None and not peer.closed:
            # propagate asynchronously, mimicking the socket path where
            # the peer's read loop notices the close a tick later
            try:
                asyncio.get_running_loop().call_soon(peer.close)
            except RuntimeError:
                peer.close()

    def __repr__(self) -> str:
        return f"LocalConnection(peer={self.peer_name}@{self.peer_addr})"


class Messenger:
    """Bind/connect endpoint owning all connections of one entity."""

    def __init__(self, entity_name: str, secret=None):
        self.entity_name = entity_name
        # cephx keyring (auth.Keyring): hellos are static-signed, all
        # later frames session-signed; unsigned/mis-signed inbound
        # frames drop the connection
        self.secret = auth.parse_secret(secret) \
            if not isinstance(secret, auth.Keyring) else secret
        # mon-granted ticket attached to outbound hellos (clients set
        # this after an MAuth exchange; services validate offline)
        self.ticket: bytes = b""
        # on-wire encryption (msgr2 secure mode): session-keystream
        # payload encryption; a secure endpoint also REFUSES plaintext
        # post-handshake frames
        self.secure = False
        self.addr: str = ""
        # opt-in per endpoint: daemons and clients enable it
        # (ms_local_fastpath); frame-level tests leave it off so two
        # in-process messengers still exercise the real wire
        self.local_fastpath = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.dispatcher: Optional[DispatchFn] = None
        self.on_connection_fault: Optional[
            Callable[[Connection], None]] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: Dict[str, Connection] = {}      # by peer addr
        self._accepted: list = []                     # inbound conns
        self._tasks: set = set()
        # fault injection (ms_inject_* options,
        # the reference's src/common/options.cc:1087-1108): daemons wire
        # these from config at boot (OSDs also re-wire on every
        # central-config push; mons are boot-time only).  N > 0 fails
        # roughly every Nth frame; delay > 0 sleeps a uniform
        # [0, delay) before each send (the reference's
        # ms_inject_internal_delays discipline).
        self.inject_socket_failures: int = 0
        self.inject_internal_delays: float = 0.0
        self._inject_rng = random.Random()
        # wire compression (ms_compress_* options): methods this
        # endpoint ACCEPTS, advertised in its hello, in preference
        # order; empty = no compression.  min_size gates tiny frames
        # (compression overhead beats the saving); compress_secure
        # must be opted into (compressed-then-encrypted length leaks)
        self.compress_methods: tuple = ()
        self.compress_min_size: int = 4096
        self.compress_secure: bool = False

    def apply_compress_config(self, config: dict) -> None:
        """Wire the ms_compress_* options into this endpoint.  The
        advertised list is filtered to codecs that actually LOAD here:
        negotiation is computed independently on both ends from the
        two advertised lists, so advertising a codec this host cannot
        instantiate would make the two ends settle on different
        methods for one direction — every bulk frame would then die in
        decompression."""
        from ceph_tpu_torch.compressor import Compressor

        methods = []
        for name in str(config.get("ms_compress_methods", "")
                        or "").split(","):
            name = name.strip()
            if not name or name == "random":
                continue  # "random" diverges per instantiation
            if Compressor.create(name) is None:
                log.warning("%s: compression method %r unavailable"
                            " here; not advertising it",
                            self.entity_name, name)
                continue
            methods.append(name)
        self.compress_methods = tuple(methods)
        try:
            self.compress_min_size = int(config.get(
                "ms_compress_min_size", 4096))
        except (TypeError, ValueError):
            pass
        self.compress_secure = bool(config.get("ms_compress_secure",
                                               False))

    # stream buffer: bulk data frames are multi-MiB; the 64 KiB default
    # limit makes readexactly assemble them from ~64 tiny feeds
    STREAM_LIMIT = 8 << 20

    async def _inject_faults(self, conn: Connection) -> None:
        """Honor ms_inject_* on this frame: maybe delay, maybe kill the
        connection (AsyncConnection::inject_delay + the every-Nth
        socket-failure roll).  Killing closes the connection exactly
        like a real socket fault — the peer sees EOF, the fault handler
        fires, and callers get ConnectionError."""
        d = self.inject_internal_delays
        if d > 0:
            await asyncio.sleep(self._inject_rng.random() * d)
        n = self.inject_socket_failures
        if n > 0 and self._inject_rng.randrange(n) == 0:
            log.info("%s: injecting socket failure on %r",
                     self.entity_name, conn)
            conn.close()
            raise ConnectionError(
                f"injected socket failure to {conn.peer_name or conn.peer_addr}")

    # -- lifecycle ---------------------------------------------------------

    @staticmethod
    async def _prewarm_native() -> None:
        """Prewarm the native library's build-once path OFF-loop: the
        first get_lib() may compile the .so (a subprocess), and every
        wire frame's crc32c rides it.  This is the SHARED choke point —
        every server binds and every client connects — so client-only
        processes get the same guarantee the daemons do; steady-state
        calls are a global read."""
        from ceph_tpu_torch import native
        if not native.prewarmed():
            await asyncio.to_thread(native.get_lib)

    async def bind(self, host: str = "127.0.0.1", port: int = 0) -> str:
        if self.secure and self.secret is None:
            # claiming wire encryption with no key would silently send
            # plaintext — refuse to start misconfigured
            raise ValueError(
                f"{self.entity_name}: auth_secure requires a keyring"
                " (auth_secret)")
        await self._prewarm_native()
        self._server = await asyncio.start_server(
            self._handle_accept, host, port, limit=self.STREAM_LIMIT)
        port = self._server.sockets[0].getsockname()[1]
        self.addr = f"{host}:{port}"
        self._loop = asyncio.get_running_loop()
        _LOCAL_REGISTRY[self.addr] = self
        return self.addr

    async def shutdown(self) -> None:
        # close live connections BEFORE wait_closed(): since 3.12 it
        # waits for all connection handlers, which sit in read loops
        # until their connection dies
        if _LOCAL_REGISTRY.get(self.addr) is self:
            del _LOCAL_REGISTRY[self.addr]
        if self._server is not None:
            self._server.close()
        for conn in list(self._conns.values()) + list(self._accepted):
            conn.close()
        self._conns.clear()
        self._accepted.clear()
        for task in list(self._tasks):
            task.cancel()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5)
            except (Exception, asyncio.TimeoutError):
                pass
            self._server = None

    # -- outbound ----------------------------------------------------------

    async def connect(self, addr: str) -> Connection:
        """Get-or-create a connection to addr (cached, like the
        AsyncMessenger connection table)."""
        conn = self._conns.get(addr)
        if conn is not None and not conn.closed:
            return conn
        if LOCAL_FASTPATH and self.local_fastpath:
            target = _LOCAL_REGISTRY.get(addr)
            if (target is not None and target is not self
                    and target.local_fastpath
                    and target._loop is asyncio.get_running_loop()
                    and self._local_compatible(target)):
                return self._connect_local(addr, target)
        await self._prewarm_native()
        host, port_s = addr.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(
            host, int(port_s), limit=self.STREAM_LIMIT)
        conn = Connection(self, reader, writer, peer_addr=addr,
                          outbound=True)
        self._conns[addr] = conn
        ticket = self.ticket
        if ticket and self.secret is not None:
            chk = auth.check_ticket(self.secret, ticket)
            if chk is not None:
                conn.base_key = chk[1]
            else:
                ticket = b""  # expired locally: fall back to static
        if conn.base_key is None and self.secret is not None:
            conn.base_key = self.secret.active_key
        await conn.send_hello(ticket=ticket)
        self._spawn(self._read_loop(conn))
        return conn

    def _local_compatible(self, target: "Messenger") -> bool:
        """The fast path must not launder authentication: it engages
        only where the socket handshake would trivially succeed — both
        endpoints keyless, or both holding the same active key with the
        same secure-mode stance."""
        if (self.secret is None) != (target.secret is None):
            return False
        if self.secret is not None:
            if self.secret.active_key != target.secret.active_key:
                return False
            if bool(self.secure) != bool(target.secure):
                return False
        return True

    def _connect_local(self, addr: str,
                       target: "Messenger") -> "LocalConnection":
        me = LocalConnection(self, target.entity_name, addr,
                             outbound=True)
        back = LocalConnection(
            target, self.entity_name,
            self.addr or f"local:{self.entity_name}", outbound=False)
        me._peer = back
        back._peer = me
        self._conns[addr] = me
        target._accepted.append(back)
        return me

    async def send_to(self, addr: str, msg: Message) -> None:
        conn = await self.connect(addr)
        await conn.send(msg)

    # -- inbound -----------------------------------------------------------

    async def _handle_accept(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        conn = Connection(self, reader, writer)
        self._accepted.append(conn)
        await self._read_loop(conn)

    def _spawn(self, coro) -> asyncio.Task:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    async def _read_frame(self, conn: Connection):
        pre = await conn.reader.readexactly(frames.PREAMBLE_WIRE_LEN)
        tag, flags, seq, length = frames.decode_preamble(pre)
        payload = await conn.reader.readexactly(length)
        frames.check_payload(payload,
                             await conn.reader.readexactly(4))
        sig = b""
        if flags & frames.FLAG_SIGNED:
            sig = await conn.reader.readexactly(auth.SIG_LEN)
        return pre, tag, flags, seq, payload, sig

    async def _handshake_hello(self, conn: Connection, tag, pre, flags,
                               seq, payload, sig) -> None:
        """First frame at a keyed endpoint: a static-signed hello.
        Raises FrameError on any auth failure."""
        if not flags & frames.FLAG_SIGNED:
            raise frames.FrameError("unsigned frame (auth required)")
        msg = decode_message(tag, payload)
        if not isinstance(msg, MHello):
            raise frames.FrameError("expected hello before session")
        key = self.secret.get(msg.kid)
        if key is None or not auth.verify(
                key, sig, conn._rx_role(),
                pre[:frames.PREAMBLE.size], payload):
            raise frames.FrameError("hello signature mismatch"
                                    " (wrong key?)")
        conn.rx_seq = seq
        conn.peer_name = msg.entity_name
        conn.peer_addr = msg.addr or conn.peer_addr
        conn.peer_compress = tuple(
            x for x in getattr(msg, "compression", "").split(",") if x)
        conn.peer_aead = getattr(msg, "aead", None)
        if conn.outbound:
            # acceptor's reply (never ticket-bearing): session =
            # f(base chosen at connect, my_nonce, its_nonce)
            conn.session_key = auth.derive_session(
                conn.base_key, conn.my_nonce, msg.nonce)
            conn.session_ready.set()
        else:
            base = key
            if msg.ticket:
                chk = auth.check_ticket(self.secret, msg.ticket)
                if chk is None:
                    raise frames.FrameError("invalid or expired"
                                            " ticket")
                _entity, base = chk
            conn.base_key = base
            conn.reply_kid = msg.kid
            # reply with MY hello BEFORE arming the session, so the
            # hello is guaranteed to be this side's first frame
            await conn.send_hello()
            conn.session_key = auth.derive_session(
                base, msg.nonce, conn.my_nonce)
            conn.session_ready.set()

    async def _read_loop(self, conn: Connection) -> None:
        try:
            while True:
                pre, tag, flags, seq, payload, sig = \
                    await self._read_frame(conn)
                # receive-side injection: drop the connection AFTER a
                # frame arrived but BEFORE it dispatches — the lost-ack
                # shape (sender thinks it delivered; receiver never saw
                # it) that distinguishes socket faults from clean stops
                await self._inject_faults(conn)
                if self.secret is not None:
                    if conn.session_key is None:
                        await self._handshake_hello(
                            conn, tag, pre, flags, seq, payload, sig)
                        continue
                    if not flags & frames.FLAG_SIGNED:
                        raise frames.FrameError(
                            "unsigned frame (auth required)")
                    if not auth.verify(conn.session_key, sig,
                                       conn._rx_role(),
                                       pre[:frames.PREAMBLE.size],
                                       payload):
                        raise frames.FrameError(
                            "session signature mismatch (replayed or"
                            " forged frame)")
                    if seq != conn.rx_seq + 1:
                        raise frames.FrameError(
                            f"non-monotonic frame seq {seq} (last"
                            f" {conn.rx_seq}): replay rejected")
                    conn.rx_seq = seq
                    if flags & frames.FLAG_SECURE:
                        payload = auth.unseal(conn.session_key,
                                              conn._rx_role(), seq,
                                              payload,
                                              peer_aead=conn.peer_aead)
                    elif self.secure:
                        raise frames.FrameError(
                            "plaintext frame but secure mode required")
                if flags & frames.FLAG_COMPRESSED:
                    comp = conn._negotiated_comp("rx")
                    if comp is None:
                        raise frames.FrameError(
                            "compressed frame but no negotiated codec")
                    import struct as _struct

                    try:
                        (cmsg,) = _struct.unpack_from("<i", payload)
                        # hand the codec a VIEW past the header: the
                        # decompressor walks the frame buffer in
                        # place — zero copies between socket and codec
                        payload = comp.decompress(
                            memoryview(payload)[4:],
                            None if cmsg < 0 else cmsg)
                    except frames.FrameError:
                        raise
                    except Exception as e:
                        # includes a truncated (<4 byte) length prefix —
                        # malformed frames all take the FrameError path
                        raise frames.FrameError(
                            f"decompression failed: {e}")
                msg = decode_message(tag, payload)
                if isinstance(msg, MHello):
                    # keyless endpoint: hellos are identification only
                    # (a keyed connector talking to a keyless acceptor
                    # rejects the unsigned reply and drops — keyed
                    # peers refuse keyless clusters by design)
                    conn.peer_name = msg.entity_name
                    conn.peer_addr = msg.addr or conn.peer_addr
                    conn.peer_compress = tuple(
                        x for x in getattr(msg, "compression",
                                           "").split(",") if x)
                    conn.peer_aead = getattr(msg, "aead", None)
                    if not conn.outbound and \
                            not getattr(conn, "_hello_sent", False):
                        # identify back: the connector needs OUR
                        # advertised compression methods (and name)
                        # to finish the per-direction negotiation
                        conn._hello_sent = True
                        await conn.send_hello()
                    continue
                if self.dispatcher is not None:
                    # fast dispatch: run handlers concurrently so a slow
                    # op never blocks the connection's read loop
                    self._spawn(self._dispatch_one(conn, msg))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass  # peer went away: lossy policy, just forget it
        except (frames.FrameError, auth.SealError) as e:
            log.warning("%s: dropping %s: %s", self.entity_name, conn, e)
        except asyncio.CancelledError:
            raise
        finally:
            conn.close()
            # evict only THIS connection: an accepted conn can share the
            # peer's listen addr with a healthy outbound conn
            if self._conns.get(conn.peer_addr) is conn:
                del self._conns[conn.peer_addr]
            if conn in self._accepted:
                self._accepted.remove(conn)
            if self.on_connection_fault is not None:
                try:
                    self.on_connection_fault(conn)
                except Exception:
                    log.exception("connection fault handler failed")

    async def _dispatch_one(self, conn: Connection, msg: Message) -> None:
        try:
            await self.dispatcher(conn, msg)
        except asyncio.CancelledError:
            raise
        except ConnectionError as e:
            # replying into a just-closed connection is ordinary churn
            # (peer died between request and response): debug, not error
            log.debug("%s: dispatch of %r hit dead conn: %s",
                      self.entity_name, msg, e)
        except Exception:
            log.exception("%s: dispatch of %r failed",
                          self.entity_name, msg)
