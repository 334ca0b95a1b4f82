"""A JAX peer and a port peer on one wire.

Both packages speak the same protocol, so the port's messenger and mons
must be interchangeable with the JAX package's at the byte level:

1. every registered message type, filled from a seed, encodes to the same
   bytes in both packages (the v3 trace context and every optional field
   set), and each package decodes the other's;
2. `encode_frame` gives the same bytes, unsigned and signed;
3. the port's native AES-GCM seal equals the JAX native one, and
   `cryptography`'s where it is installed;
4. a JAX Messenger and a port Messenger exchange messages over TCP both
   ways: plain, signed, secure and compressed;
5. a quorum of two JAX mons and one port mon, and one of one JAX mon and
   two port mons, both elect and commit; after the same commands every
   mon's encoded OSDMap at each epoch is byte-identical, within each
   quorum and across the two (the EC rule that create_rule adds included);
   the JAX mons of those quorums, proposing over TCP, take two lock-order
   edges the JAX package's static lock graph lacks (pinned, then taken out
   of the session's runtime graph again);
6. the port's native crc32c equals its numpy oracle and the JAX crc32c on
   seeded lengths 0-70,000 and on misaligned views.
"""

import asyncio
import inspect
import os
import random

import numpy as np
import pytest

from ceph_tpu.common import auth as jauth
from ceph_tpu.msg import frames as jframes
from ceph_tpu.msg import messages as jmessages
from ceph_tpu.ops import checksum as jcks
from ceph_tpu.osd import osdmap as josdmap
from ceph_tpu_torch.common import auth as tauth
from ceph_tpu_torch.msg import frames as tframes
from ceph_tpu_torch.msg import messages as tmessages
from ceph_tpu_torch.ops import checksum as tcks
from ceph_tpu_torch.osd import osdmap as tosdmap

from torch_mon_helpers import MonClient, MonQuorum, pkg

SEED = 20261017
PKGS = {"jax": (jmessages, josdmap), "torch": (tmessages, tosdmap)}


def run(coro, timeout: float = 60):
    asyncio.run(asyncio.wait_for(coro, timeout))


# -- 1. every message type -----------------------------------------------------


class _Filler:
    """Seeded values for a constructor's parameters, by annotation; the
    same seed gives the same values whichever package's classes take
    them."""

    def __init__(self, seed: int, msgs, om):
        self.rng = random.Random(seed)
        self.msgs, self.om = msgs, om

    def _str(self):
        return "".join(self.rng.choice("abcdefgh.-_0123") for _ in range(
            self.rng.randint(1, 12)))

    def _bytes(self):
        return self.rng.randbytes(self.rng.randint(0, 40))

    def _dict(self):
        return {"k": self.rng.randint(0, 99), "s": self._str(),
                "l": [self.rng.randint(0, 9) for _ in range(3)]}

    def _tuple2(self):
        return (self.rng.randint(0, 1 << 40), self.rng.randint(0, 1 << 40))

    def value(self, name: str, ann: str):
        r = self.rng
        if name in ("trace", "guard"):
            return self._tuple2()
        if name == "repair":
            return (r.randint(0, 11), r.randint(1, 64))
        opt = ann.startswith("Optional[")
        if opt:
            ann = ann[len("Optional["):-1]
        table = {
            "int": lambda: r.randint(0, 200),
            "float": lambda: round(r.uniform(0, 1e3), 3),
            "bool": lambda: r.random() < 0.5,
            "str": self._str,
            "bytes": self._bytes,
            "PgId": lambda: self.om.PgId(r.randint(0, 9), r.randint(0, 999)),
            "Dict[str, Any]": self._dict,
            "List[int]": lambda: [r.randint(0, 99) for _ in range(3)],
            "List[str]": lambda: [self._str() for _ in range(3)],
            "List[bytes]": lambda: [self._bytes() for _ in range(2)],
            "List[Dict[str, Any]]": lambda: [self._dict() for _ in range(2)],
            "Dict[str, bytes]": lambda: {self._str(): self._bytes()
                                         for _ in range(2)},
            "Dict[int, bytes]": lambda: {r.randint(0, 99): self._bytes()
                                         for _ in range(2)},
            "Dict[str, Tuple[int, bytes]]": lambda: {
                self._str(): (r.randint(0, 99), self._bytes())
                for _ in range(2)},
            "List[Tuple[int, int, int, str]]": lambda: [
                (r.randint(0, 9), r.randint(0, 99), r.randint(0, 99),
                 self._str()) for _ in range(2)],
            "List[Tuple[int, str, bytes]]": lambda: [
                (r.randint(0, 9), self._str(), self._bytes())
                for _ in range(2)],
            "tuple": self._tuple2,
            "List[OSDOp]": lambda: [
                self.msgs.OSDOp("write", r.randint(0, 99), r.randint(0, 99),
                                self._bytes(), self._dict()),
                self.msgs.OSDOp("getxattr", args={"name": self._str()})],
            "List[ShardOp]": lambda: [
                self.msgs.ShardOp("write", r.randint(0, 99), self._bytes()),
                self.msgs.ShardOp("setattr", name=self._str(),
                                  value=self._bytes(),
                                  size=r.randint(0, 99))],
        }
        if ann not in table:
            raise KeyError(f"no filler for {name}: {ann}")
        return table[ann]()

    def build(self, cls):
        sig = inspect.signature(cls.__init__)
        kwargs = {name: self.value(name, str(p.annotation)
                                   .replace("typing.", ""))
                  for name, p in list(sig.parameters.items())[1:]}
        msg = cls(**kwargs)
        for name in ("trace", "repair"):      # set after construction
            if hasattr(msg, name) and getattr(msg, name) is None:
                setattr(msg, name, self.value(name, "tuple"))
        return msg


def _tags():
    assert set(jmessages._REGISTRY) == set(tmessages._REGISTRY)
    return sorted(jmessages._REGISTRY)


@pytest.mark.parametrize("tag", _tags(),
                         ids=[jmessages._REGISTRY[t].__name__
                              for t in _tags()])
def test_every_message_type_encodes_to_the_same_bytes(tag):
    jcls, tcls = jmessages._REGISTRY[tag], tmessages._REGISTRY[tag]
    assert jcls.__name__ == tcls.__name__
    assert (jcls.VERSION, jcls.COMPAT) == (tcls.VERSION, tcls.COMPAT)
    for seed in range(3):
        jmsg = _Filler(SEED + tag * 10 + seed, *PKGS["jax"]).build(jcls)
        tmsg = _Filler(SEED + tag * 10 + seed, *PKGS["torch"]).build(tcls)
        raw = tmsg.encode()
        assert raw == jmsg.encode()
        # each decodes the other's, and the fields survive
        back_j = jmessages.decode_message(tag, raw)
        back_t = tmessages.decode_message(tag, jmsg.encode())
        assert back_j.encode() == raw and back_t.encode() == raw
        assert set(vars(back_t)) == set(vars(back_j))


def test_kv_map_and_string_list_helpers_agree():
    """The omap payload helpers (encode_kv_map, encode_str_list) write the
    same bytes, and each package decodes the other's."""
    rng = random.Random(SEED)
    kv = {f"key{i}-{rng.random()}": rng.randbytes(rng.randint(0, 50))
          for i in range(20)}
    items = [f"name-{i}-{rng.random()}" for i in range(20)]
    for enc_kv, enc_sl in ((tmessages.encode_kv_map, tmessages.encode_str_list),
                           (jmessages.encode_kv_map, jmessages.encode_str_list)):
        assert enc_kv(kv) == jmessages.encode_kv_map(kv)
        assert enc_sl(items) == jmessages.encode_str_list(items)
    assert tmessages.decode_kv_map(jmessages.encode_kv_map(kv)) == \
        jmessages.decode_kv_map(tmessages.encode_kv_map(kv))
    assert tmessages.decode_str_list(jmessages.encode_str_list(items)) == \
        items == jmessages.decode_str_list(tmessages.encode_str_list(items))
    assert tmessages.encode_kv_map({}) == jmessages.encode_kv_map({})


# -- 2. frames -----------------------------------------------------------------


@pytest.mark.parametrize("signed", [False, True])
def test_encode_frame_bytes_equal(signed):
    rng = np.random.default_rng(SEED)
    key = rng.bytes(32) if signed else None
    for n in (0, 1, 24, 4095, 65536):
        payload = rng.bytes(n)
        for role in (b"c", b"s"):
            args = (5, n + 3, payload)
            kw = {"flags": tframes.FLAG_COMPRESSED if n % 2 else 0,
                  "key": key, "role": role}
            raw = tframes.encode_frame(*args, **kw)
            assert raw == jframes.encode_frame(*args, **kw)
            assert tframes.decode_preamble(raw[:24]) == \
                jframes.decode_preamble(raw[:24])


# -- 3. AES-GCM ----------------------------------------------------------------


def test_native_aesgcm_seal_equals_jax_and_cryptography():
    assert tauth._resolve_aead() == "native"
    assert jauth._resolve_aead() == "native"
    rng = random.Random(SEED)
    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    except ImportError:
        AESGCM = None
    for n in (0, 1, 15, 16, 17, 255, 4096, 100_003):
        key = rng.randbytes(32)
        data = rng.randbytes(n)
        for role, seq in ((b"c", 1), (b"s", 1 << 40)):
            ct = tauth.seal(key, role, seq, data)
            assert ct == jauth.seal(key, role, seq, data)
            assert jauth.unseal(key, role, seq, ct) == data
            if AESGCM is not None:
                assert ct[1:] == AESGCM(key).encrypt(
                    tauth._gcm_nonce(role, seq), data, None)


# -- 4. messengers of both packages over TCP -----------------------------------


MODES = {
    "plain": {},
    "signed": {"secret": True},
    "secure": {"secret": True, "secure": True},
    "compressed": {"compress": ("snappy", "zlib")},
    "signed_compressed": {"secret": True, "compress": ("zlib",)},
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("server_kind", ["jax", "torch"])
def test_jax_and_port_messengers_exchange_both_ways(server_kind, mode):
    client_kind = "torch" if server_kind == "jax" else "jax"
    opts = MODES[mode]
    secret = tauth.generate_secret() if opts.get("secret") else None

    def endpoint(kind, name):
        m = pkg(kind, "msg").Messenger(name, secret=secret)
        m.secure = bool(opts.get("secure"))
        m.compress_methods = opts.get("compress", ())
        m.compress_min_size = 64
        return m

    async def main():
        server = endpoint(server_kind, "mon.0")
        client = endpoint(client_kind, "client.7")
        smod = pkg(server_kind, "msg.messages")
        cmod = pkg(client_kind, "msg.messages")
        got = asyncio.Queue()

        async def server_dispatch(conn, msg):
            assert type(msg).__module__.startswith(
                pkg(server_kind, "msg").__name__.split(".")[0])
            await conn.send(smod.MMonCommandReply(
                msg.tid, 0, {"echo": msg.cmd, "by": server_kind}))

        async def client_dispatch(conn, msg):
            await got.put(msg)

        server.dispatcher = server_dispatch
        client.dispatcher = client_dispatch
        addr = await server.bind()
        try:
            conn = await client.connect(addr)
            blob = "ceph " * 4000
            for tid in range(1, 6):
                cmd = {"prefix": "status", "n": tid, "blob": blob}
                await conn.send(cmod.MMonCommand(tid, cmd))
                reply = await asyncio.wait_for(got.get(), 10)
                assert type(reply).__name__ == "MMonCommandReply"
                assert reply.tid == tid and reply.out["by"] == server_kind
                assert reply.out["echo"] == cmd
            if opts.get("compress"):
                assert conn._tx_comp is not None and conn._tx_comp[1] \
                    is not None
        finally:
            await client.shutdown()
            await server.shutdown()

    run(main(), 30)


# -- 5. mixed quorums --------------------------------------------------------


EC_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4",
              "m": "2", "crush-failure-domain": "host"}

COMMANDS = [
    {"prefix": "osd erasure-code-profile set", "name": "ec42",
     "profile": EC_PROFILE},
    {"prefix": "osd pool create", "name": "rbd", "pg_num": 32,
     "pool_type": "replicated", "size": 3},
    {"prefix": "osd pool create", "name": "ec", "pg_num": 16,
     "pool_type": "erasure", "erasure_code_profile": "ec42"},
    {"prefix": "osd out", "osd": 3},
    {"prefix": "osd out", "osd": 7},
    {"prefix": "osd pg-upmap-items", "pgid": "1.5", "mappings": None},
    {"prefix": "osd pool set", "name": "rbd", "var": "pg_num", "val": 64},
    {"prefix": "osd in", "osd": 3},
    {"prefix": "osd pool mksnap", "name": "rbd"},
    {"prefix": "config set", "who": "osd", "name": "debug", "value": "5"},
]


async def _drive(kinds) -> dict:
    """Run COMMANDS through a quorum of `kinds`; -> {epoch: [each mon's
    encoded map at that epoch]} as the subscribers of every mon saw it,
    plus the health each mon's leader reported."""
    # one event loop carries every mon here, and the JAX mon's first codec
    # build holds it for a while: a lease longer than the quorum tests'
    # keeps that from reading as a dead leader
    q = MonQuorum(kinds, num_osds=12, osds_per_host=2,
                  config={"mon_lease": 5.0, "mon_election_timeout": 2.5})
    await q.start()
    client = MonClient(q.mon_addrs, kind="torch")
    by_epoch = {}

    def snap():
        for m in q.mons.values():
            by_epoch.setdefault(m.osdmap.epoch, {})[m.rank] = m.osdmap.encode()

    try:
        snap()
        for cmd in COMMANDS:
            if cmd["prefix"] == "osd pg-upmap-items":
                m = q.leader.osdmap
                pg = tosdmap.PgId(1, 5)
                raw, _ = tosdmap.OSDMap.decode(m.encode())._pg_to_raw_osds(
                    m.pools[1], pg)
                free = [o for o in range(12) if o not in raw and m.is_in(o)]
                cmd = dict(cmd, mappings=[[raw[0], free[0]]])
            rc, out = await client.command(cmd)
            assert rc == 0, (cmd, out)
            await q.wait_for_quorum()
            await q.wait_for_epoch(q.leader.osdmap.epoch)
            snap()
        rc, health = await client.command({"prefix": "health"})
        assert rc == 0
    finally:
        await client.shutdown()
        await q.stop()
    return {"maps": by_epoch, "health": health}


#: lock-order edges a JAX mon takes when it proposes to peers over TCP (a
#: port peer never shares the JAX package's in-process fast path): a send
#: while the mutation and propose locks are held.  The JAX package's static
#: lock graph lacks both (ROADMAP C6).
TCP_QUORUM_EDGES = {("mon.mutation", "msg.send"), ("paxos.propose", "msg.send")}


def test_mixed_quorums_commit_byte_identical_maps():
    import ceph_tpu
    from ceph_tpu.analysis.core import build_project
    from ceph_tpu.analysis.lockgraph import build_lock_graph
    from ceph_tpu.common import lockdep as jlockdep

    # the JAX lockdep records every edge of the test session in one
    # module-level graph, which tests/test_static_analysis.py reads back:
    # the edges this test's TCP quorums record are pinned here and taken
    # out again, so what that test reads does not depend on which files
    # a worker ran before it
    saved = {k: set(v) for k, v in jlockdep._edges.items()}
    results = {}
    try:
        for label, kinds in (("2jax+1torch", ("jax", "jax", "torch")),
                             ("1jax+2torch", ("jax", "torch", "torch")),
                             ("torch-led", ("torch", "jax", "torch"))):
            results[label] = asyncio.run(asyncio.wait_for(_drive(kinds),
                                                          90))
        recorded = {(a, b) for a, bs in jlockdep._edges.items() for b in bs}
    finally:
        jlockdep._edges.clear()
        jlockdep._edges.update(saved)
    if jlockdep.enabled:
        adj, _ = build_lock_graph(build_project(
            [os.path.dirname(os.path.abspath(ceph_tpu.__file__))]))
        assert TCP_QUORUM_EDGES <= recorded, recorded
        assert not any(b in adj.get(a, set()) for a, b in TCP_QUORUM_EDGES)
    base = results["2jax+1torch"]
    for label, res in results.items():
        for epoch, maps in res["maps"].items():
            assert len(set(maps.values())) == 1, (label, epoch)
        assert sorted(res["maps"]) == sorted(base["maps"]), label
        for epoch in base["maps"]:
            assert set(res["maps"][epoch].values()) == \
                set(base["maps"][epoch].values()), (label, epoch)
        assert res["health"] == base["health"], label
    final = tosdmap.OSDMap.decode(next(iter(
        base["maps"][max(base["maps"])].values())))
    assert final.pools[1].pg_num == 64 and final.pools[1].snap_seq == 1
    assert final.lookup_pool("ec") == 2 and len(final.crush.rules) == 2
    assert final.pg_upmap_items and not final.is_in(7)


# -- 6. crc32c -----------------------------------------------------------------


def test_native_crc32c_equals_numpy_oracle_and_jax():
    rng = np.random.default_rng(SEED)
    buf = rng.bytes(70_100)
    lengths = sorted({0, 1, 3, 4, 7, 8, 63, 64, 767, 768, 769, 4096,
                      65536, 70_000, *rng.integers(0, 70_000, 24).tolist()})
    for n in lengths:
        data = buf[:n]
        seed = int(rng.integers(0, 1 << 32))
        want = tcks.crc32c_numpy(seed, data)
        assert tcks.crc32c(seed, data) == want, n
        assert jcks.crc32c(seed, data) == want, n
        for off in (1, 3, 5):                  # misaligned views
            view = memoryview(buf)[off:off + n]
            want = tcks.crc32c_numpy(seed, view)
            assert tcks.crc32c(seed, view) == want
            assert tcks.crc32c(seed, bytearray(view)) == want
            assert tcks.crc32c(seed, np.frombuffer(view, np.uint8)) == want
            assert jcks.crc32c(seed, view) == want
    assert tcks.crc32c(7, None, 1000) == jcks.crc32c(7, None, 1000)
