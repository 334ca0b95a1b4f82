"""The port's persistent store (ceph_tpu_torch.os.tpustore over kv,
common/checksummer, compressor and the host crc32c/xxhash) and its offline
tool against the JAX package's, on the CPU.

The same seeded transaction sequences run on a JAX `TPUStore` and on a port
`TPUStore(device="cpu")`, whose csums and compression pre-scores run the
kernels' plain versions.  Reads, block files, the KV contents (onodes, blob
maps, omap, freelist, the deferred-write WAL) and perf counters are bytes or
integers, so the tolerance is exact equality throughout; only the fsid, a
random uuid written at mkfs, differs.  Stores cross-mount in both
directions.  The JAX tests of tests/test_objectstore.py are also replayed
against the port's names.
"""

import ast
import contextlib
import functools
import inspect
import io
import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import test_objectstore as jax_cases
from ceph_tpu.common import checksummer as jcsum
from ceph_tpu.common.config import Config as JConfig
from ceph_tpu.os import ObjectId as JObjectId
from ceph_tpu.os import Transaction as JTransaction
from ceph_tpu.os.tpustore import TPUStore as JTPUStore
from ceph_tpu.tools import objectstore_tool as jtool
from ceph_tpu_torch.common import checksummer as csum
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.kv import MemDB, SQLiteDB
from ceph_tpu_torch.os import ObjectId, Transaction
from ceph_tpu_torch.os.memstore import MemStore
from ceph_tpu_torch.os.tpustore import Allocator, TPUStore
from ceph_tpu_torch.tools import objectstore_tool as tool

SEED = 20261017
CID = "1.0_head"
NAMES = {
    "jax": types.SimpleNamespace(TPUStore=JTPUStore, T=JTransaction,
                                 O=JObjectId, Config=JConfig),
    "port": types.SimpleNamespace(
        TPUStore=functools.partial(TPUStore, device="cpu"), T=Transaction,
        O=ObjectId, Config=Config),
}


def payloads(rng):
    """Objects of every kind and of sizes around the 64 KiB span."""
    pattern = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
    text = b"".join(rng.choice([b"object ", b"placement ", b"group ",
                                b"shard ", b"the "], 40_000))
    return {"zeros": bytes(200_000), "random": rng.bytes(300_000),
            "text": text[:250_000], "pattern": pattern * 700,
            "empty": b"", "one": b"x", "span": rng.bytes(65536),
            "span+1": rng.bytes(65537)}


def _config(ns, **opts):
    if not opts:
        return None
    cfg = ns.Config()
    for name, value in opts.items():
        cfg.set_val(name, value)
    return cfg


def _open(ns, path, opts, fresh=True):
    s = ns.TPUStore(str(path), config=_config(ns, **opts))
    if fresh:
        s.mkfs()
    s.mount()
    return s


def _txn(ns, *ops):
    t = ns.T()
    for name, *args in ops:
        getattr(t, name)(*args)
    return t


def _outcome(fn):
    try:
        return ("ok", fn())
    except (KeyError, IOError, ValueError) as e:
        return (type(e).__name__, str(e))


def _state(s):
    """Everything a store holds: every object's bytes, attrs, omap and
    header, the KV contents but the fsid, the block file, the counters."""
    objs = {}
    for cid in s.list_collections():
        for oid in s.list_objects(cid):
            objs[cid, str(oid)] = (
                _outcome(lambda: s.read(cid, oid)),
                s.getattrs(cid, oid), s.omap_get(cid, oid),
                s.omap_get_header(cid, oid), s.stat(cid, oid))
    kv = {prefix: [(k, v) for k, v in s._kv.get_iterator(prefix)
                   if (prefix, k) != ("S", b"fsid")]
          for prefix in "SOMFD"}
    s._block.flush()
    block = Path(s._block_path).read_bytes()
    return objs, kv, block, s.perf_counters(), s.statfs()


def scenario_io(ns, path, opts):
    """Writes, overwrites (deferred and COW), zero, truncate, clone, move,
    xattrs, omap, remove; state after each step and after a remount."""
    rng = np.random.default_rng(SEED)
    data = payloads(rng)
    s = _open(ns, path, opts)
    s.queue_transaction(_txn(ns, ("create_collection", CID)))
    states = []
    for name, d in data.items():
        s.queue_transaction(_txn(ns, ("write", CID, ns.O(name), 0, len(d),
                                      d)))
    states.append(_state(s))
    o = ns.O
    steps = [
        [("write", CID, o("random"), 1000, 500, b"Y" * 500)],   # deferred
        [("write", CID, o("random"), 70_000, 40_000, rng.bytes(40_000))],
        [("write", CID, o("text"), 249_000, 5000, b"tail" * 1250)],
        [("zero", CID, o("pattern"), 100, 70_000)],
        [("truncate", CID, o("zeros"), 100_000),
         ("truncate", CID, o("span+1"), 0)],
        [("clone", CID, o("text"), o("text-clone"))],
        [("setattr", CID, o("one"), "hinfo_key", b"ledger"),
         ("setattr", CID, o("one"), "_", bytes(range(256))),
         ("omap_setkeys", CID, o("one"), {"a": b"1", "b": b"2"}),
         ("omap_setheader", CID, o("one"), b"hdr")],
        [("create_collection", "2.0_head"),
         ("collection_move_rename", CID, o("one"), "2.0_head", o("moved"))],
        [("omap_rmkeys", "2.0_head", o("moved"), ["a"]),
         ("rmattr", "2.0_head", o("moved"), "_")],
        [("remove", CID, o("span"))],
    ]
    for ops in steps:
        s.queue_transaction(_txn(ns, *ops))
        states.append(_state(s))
    reads = [_outcome(lambda: s.read(CID, o("random"), 999, 502)),
             _outcome(lambda: s.read(CID, o("text"), 240_000, 0)),
             _outcome(lambda: s.read(CID, o("span")))]
    s.umount()
    s = _open(ns, path, opts, fresh=False)
    states.append(_state(s))
    s.umount()
    return states, reads


def scenario_wal(ns, path, opts):
    """Small overwrites through the deferred-write WAL, a batch trim, a
    crash() before the lazy flush, WAL replay at mount, a second mount."""
    s = _open(ns, path, opts)
    s.deferred_batch = 4
    s.queue_transaction(_txn(ns, ("create_collection", CID)))
    s.queue_transaction(_txn(ns, ("write", CID, ns.O("w"), 0, 100_000,
                                  b"x" * 100_000)))
    states = []
    for i in range(7):
        s.queue_transaction(_txn(ns, ("write", CID, ns.O("w"), 3000 * i,
                                      50, bytes([i]) * 50)))
        states.append(_state(s))
    s.crash()
    s = _open(ns, path, opts, fresh=False)
    states.append(_state(s))
    s.umount()
    s = _open(ns, path, opts, fresh=False)
    states.append(_state(s))
    s.umount()
    return states


def scenario_batch(ns, path, opts):
    """submit_batch: a merged group commit, then a batch whose middle txn
    fails (replayed one by one), then a failing queue_transaction."""
    s = _open(ns, path, opts)
    s.queue_transaction(_txn(ns, ("create_collection", CID)))
    o = ns.O
    ok = [_txn(ns, ("write", CID, o(f"b{i}"), 0, 9000, bytes([i]) * 9000))
          for i in range(4)]
    res = [s.submit_batch(ok)]
    bad = [_txn(ns, ("write", CID, o("c0"), 0, 10, b"c" * 10)),
           _txn(ns, ("write", CID, o("b0"), 0, 5, b"zzzzz"),
                ("rmattr", CID, o("missing"), "x")),
           _txn(ns, ("write", CID, o("c1"), 0, 10, b"d" * 10))]
    res.append([type(e).__name__ if e else None
                for e in s.submit_batch(bad)])
    res.append(_outcome(lambda: s.queue_transaction(_txn(
        ns, ("write", CID, o("b1"), 0, 40_000, b"q" * 40_000),
        ("rmattr", CID, o("missing"), "x")))))
    state = _state(s)
    s.umount()
    return res, state


SCENARIOS = {"io": scenario_io, "wal": scenario_wal, "batch": scenario_batch}
CONFIGS = {
    "default": {},
    "csum_none": {"bluestore_csum_type": "none"},
    "xxhash32": {"bluestore_csum_type": "xxhash32"},
    "xxhash64_512": {"bluestore_csum_type": "xxhash64",
                     "bluestore_csum_block_size": 512},
    "crc32c_16": {"bluestore_csum_type": "crc32c_16"},
    "crc32c_8_8k": {"bluestore_csum_type": "crc32c_8",
                    "bluestore_csum_block_size": 8192},
    **{f"{alg}_{mode}": {"bluestore_compression_mode": mode,
                         "bluestore_compression_algorithm": alg}
       for alg in ("snappy", "lz4", "zlib") for mode in ("aggressive",
                                                          "force")},
    "zstd_passive": {"bluestore_compression_mode": "passive",
                     "bluestore_compression_algorithm": "zstd"},
    "brotli_small_blobs": {"bluestore_compression_mode": "aggressive",
                           "bluestore_compression_algorithm": "brotli",
                           "bluestore_compression_max_blob_size": 16384,
                           "bluestore_compression_required_ratio": 0.5},
}


# every config through the io scenario; the WAL and batch scenarios on three
CASES = [("io", config) for config in CONFIGS] + [
    (scenario, config) for scenario in ("wal", "batch")
    for config in ("default", "lz4_aggressive", "xxhash64_512")]


@pytest.mark.parametrize("scenario,config", CASES)
def test_store_equals_jax(tmp_path, scenario, config):
    runs = {pkg: SCENARIOS[scenario](ns, tmp_path / pkg, CONFIGS[config])
            for pkg, ns in NAMES.items()}
    assert runs["port"] == runs["jax"]


def test_compression_took_effect(tmp_path):
    """The compressed configs really compress (and the csum blocks of a
    compressed blob cover its stored bytes)."""
    cfg = CONFIGS["snappy_aggressive"]
    s = _open(NAMES["port"], tmp_path, cfg)
    s.queue_transaction(_txn(NAMES["port"], ("create_collection", CID)))
    data = payloads(np.random.default_rng(SEED))
    for name in ("zeros", "random", "text", "pattern"):
        s.queue_transaction(_txn(NAMES["port"], ("write", CID, ObjectId(name),
                                                 0, len(data[name]),
                                                 data[name])))
    algs = {name: {b.comp_alg for b in s._get_onode(
        CID, ObjectId(name)).blobs.values()}
        for name in ("zeros", "random", "text", "pattern")}
    s.umount()
    assert algs == {"zeros": {1}, "random": {None}, "text": {1},
                    "pattern": {1}}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_cross_mount(tmp_path, writer):
    """A store written by one package mounts, reads and takes writes in the
    other, and back."""
    reader = "port" if writer == "jax" else "jax"
    opts = CONFIGS["lz4_aggressive"]
    scenario_io(NAMES[writer], tmp_path, opts)
    w = _open(NAMES[writer], tmp_path, opts, fresh=False)
    want = _state(w)
    fsid = w.fsid
    w.umount()
    r = _open(NAMES[reader], tmp_path, opts, fresh=False)
    assert r.fsid == fsid
    assert _state(r)[:2] == want[:2]
    r.queue_transaction(_txn(NAMES[reader], ("write", CID,
                                             NAMES[reader].O("random"), 5,
                                             7, b"reader!")))
    after = _state(r)
    r.umount()
    w = _open(NAMES[writer], tmp_path, opts, fresh=False)
    assert _state(w)[:3] == after[:3]
    w.umount()


def test_bitrot_raises_and_counts(tmp_path):
    outcomes = {}
    for pkg, ns in NAMES.items():
        s = _open(ns, tmp_path / pkg, {})
        s.queue_transaction(_txn(ns, ("create_collection", CID)))
        data = np.random.default_rng(SEED).bytes(150_000)
        s.queue_transaction(_txn(ns, ("write", CID, ns.O("o"), 0,
                                      len(data), data)))
        s.umount()
        with open(tmp_path / pkg / "block", "r+b") as f:
            f.seek(70_000)
            b = f.read(1)
            f.seek(70_000)
            f.write(bytes([b[0] ^ 0x10]))
        s = _open(ns, tmp_path / pkg, {}, fresh=False)
        outcomes[pkg] = (_outcome(lambda: s.read(CID, ns.O("o"))),
                         _outcome(lambda: s.read(CID, ns.O("o"), 0, 65536)),
                         s.perf_counters()["csum_read_failures"])
        s.umount()
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0][0] == "OSError"
    assert outcomes["port"][1][0] == "ok"
    assert outcomes["port"][2] == 1


@pytest.mark.parametrize("pkg", NAMES)
def test_second_mkfs_resets_the_freelist(tmp_path, pkg):
    """ROADMAP C4, a fault of the reference that the port copies: mkfs over
    an existing store keeps its onodes but empties its allocator."""
    ns = NAMES[pkg]
    s = _open(ns, tmp_path, {})
    data = bytes(range(250)) * 400
    s.queue_transaction(_txn(ns, ("create_collection", CID),
                             ("write", CID, ns.O("A"), 0, len(data), data)))
    s.umount()
    s = _open(ns, tmp_path, {})
    assert s.read(CID, ns.O("A")) == data
    assert s.statfs() == {"total": 1, "available": 0, "allocated": 0,
                          "stored": 0}
    s.umount()


# -- Checksummer ----------------------------------------------------------


CSUM_TYPES = sorted(csum._NAMES)


@pytest.mark.parametrize("csum_type", CSUM_TYPES)
@pytest.mark.parametrize("block_size", [512, 4096])
@pytest.mark.parametrize("nblocks", [1, 7, 8, 16])
def test_checksummer_equals_jax(csum_type, block_size, nblocks):
    rng = np.random.default_rng(SEED + nblocks)
    data = rng.bytes(block_size * nblocks)
    for init in (0xFFFFFFFF, 0, 0x1234):
        got, want = bytearray(), bytearray()
        csum.Checksummer.calculate(csum_type, block_size, 0, len(data), data,
                                   got, init, device="cpu")
        jcsum.Checksummer.calculate(csum_type, block_size, 0, len(data),
                                    data, want, init)
        assert got == want
        assert len(got) == nblocks * csum.get_csum_value_size(csum_type)
        assert csum.Checksummer.verify(csum_type, block_size, 0, len(data),
                                       data, got, init, device="cpu") == -1
        for bad in sorted({0, nblocks // 2, nblocks - 1}):
            flipped = bytearray(data)
            flipped[bad * block_size + 3] ^= 0x80
            at = csum.Checksummer.verify(csum_type, block_size, 0,
                                         len(data), bytes(flipped), got,
                                         init, device="cpu")
            assert at == jcsum.Checksummer.verify(
                csum_type, block_size, 0, len(data), bytes(flipped), got,
                init)
            assert at == (-1 if csum_type == csum.CSUM_NONE
                          else bad * block_size)
    if nblocks > 1 and csum_type != csum.CSUM_NONE:
        # a range past the first block, and missing csum values
        part = bytearray(got)
        csum.Checksummer.calculate(csum_type, block_size, block_size,
                                   block_size, data, part, init,
                                   device="cpu")
        assert part == got
        assert csum.Checksummer.verify(
            csum_type, block_size, block_size, block_size, data,
            got[:csum.get_csum_value_size(csum_type)], init,
            device="cpu") == block_size


@pytest.mark.parametrize("block_size", [1, 3, 4, 60, 64, 65, 4096, 5000])
def test_host_checksums_equal_jax(block_size):
    """ops/checksum's host crc32c_blocks, xxh32 and xxh64 (and the
    pure-Python xxhash twins) against the JAX package's native ones."""
    from ceph_tpu.ops import checksum as jcks
    from ceph_tpu_torch.ops import checksum as cks

    rng = np.random.default_rng(SEED + block_size)
    for n in (0, 1, 7, 33):
        data = rng.integers(0, 256, n * block_size, dtype=np.uint8)
        for init in (0, 0xFFFFFFFF, 0x1234):
            got = cks.crc32c_blocks(data, block_size, init)
            assert got.dtype == np.uint32
            np.testing.assert_array_equal(
                got, jcks.crc32c_blocks(data, block_size, init))
    data = rng.bytes(block_size * 3)
    for seed in (0, 1, 0xFFFFFFFF):
        assert cks.xxh32(data, seed) == jcks.xxh32(data, seed) == \
            cks._py_xxh32(data, seed)
        assert cks.xxh64(data, seed) == jcks.xxh64(data, seed) == \
            cks._py_xxh64(data, seed)
    with pytest.raises(ValueError):
        cks.crc32c_blocks(bytes(block_size * 2 + 1), block_size + 1)


def test_csum_names_equal_jax():
    for t in CSUM_TYPES:
        name = csum.get_csum_type_string(t)
        assert name == jcsum.get_csum_type_string(t)
        assert csum.get_csum_string_type(name) == t
        assert csum.get_csum_value_size(t) == jcsum.get_csum_value_size(t)


# -- the tool -------------------------------------------------------------


def _run_tool(main, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, **kw)
    return rc, out.getvalue()


def test_objectstore_tool_equals_jax(tmp_path):
    """Each op of the offline tool prints what the JAX tool prints, on
    twin stores, and fsck finds the bitrot in both."""
    for pkg in NAMES:
        scenario_io(NAMES[pkg], tmp_path / pkg, CONFIGS["zlib_aggressive"])
    ops = [["list-pgs"], ["list"], ["list", "--cid", CID],
           ["info", "--cid", CID, "--obj", "text-clone"],
           ["get-attrs", "--cid", "2.0_head", "--obj", "moved"],
           ["dump-omap", "--cid", "2.0_head", "--obj", "moved"], ["fsck"]]
    for op in ops:
        got = _run_tool(tool.main, ["--data-path", str(tmp_path / "port"),
                                    *op], device="cpu")
        want = _run_tool(jtool.main, ["--data-path", str(tmp_path / "jax"),
                                      *op])
        assert got == want, op
    for pkg, main, kw in (("port", tool.main, {"device": "cpu"}),
                          ("jax", jtool.main, {})):
        out = tmp_path / f"{pkg}.bytes"
        assert _run_tool(main, ["--data-path", str(tmp_path / pkg),
                                "get-bytes", "--cid", CID, "--obj", "text",
                                "--file", str(out)], **kw) == (0, "")
        assert _run_tool(main, ["--data-path", str(tmp_path / pkg), "remove",
                                "--cid", CID, "--obj", "zeros"],
                         **kw) == (0, "")
        st = _open(NAMES[pkg], tmp_path / pkg, {}, fresh=False)
        at = st._get_onode(CID, NAMES[pkg].O("random")).blobs[0].offset + 10
        st.umount()
        with open(tmp_path / pkg / "block", "r+b") as f:
            f.seek(at)
            b = f.read(1)
            f.seek(at)
            f.write(bytes([b[0] ^ 1]))
    assert (tmp_path / "port.bytes").read_bytes() == \
        (tmp_path / "jax.bytes").read_bytes()
    got = _run_tool(tool.main, ["--data-path", str(tmp_path / "port"),
                                "--device", "cpu", "fsck"])
    want = _run_tool(jtool.main, ["--data-path", str(tmp_path / "jax"),
                                  "fsck"])
    assert got == want and got[0] == 1


# -- no silent CPU, and no import of the JAX package ------------------------


def test_no_silent_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TPUStore(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        csum.Checksummer.calculate(csum.CSUM_CRC32C, 4096, 0, 4096,
                                   bytes(4096), bytearray())
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(["--data-path", str(tmp_path), "fsck"])


ROOT = Path(__file__).resolve().parent.parent
NEW_MODULES = ("kv/__init__.py", "common/options.py", "common/config.py",
               "common/plugin_registry.py", "common/checksummer.py",
               "common/tracing.py", "compressor/__init__.py",
               "compressor/plugins.py", "compressor/gate.py",
               "compressor/scoring.py", "native/__init__.py",
               "ops/score_kernels.py", "os/tpustore.py",
               "tools/objectstore_tool.py", "tools/score_emulate.py")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_store_modules_import_neither_jax_nor_ceph_tpu(module):
    path = ROOT / "ceph_tpu_torch" / module
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "ceph_tpu"}, roots


# -- the JAX tests of tests/test_objectstore.py, replayed on the port -------

PORT_NAMES = {"Config": Config, "MemDB": MemDB, "SQLiteDB": SQLiteDB,
              "ObjectId": ObjectId, "Transaction": Transaction,
              "MemStore": MemStore, "Allocator": Allocator,
              "TPUStore": functools.partial(TPUStore, device="cpu")}
REPLAYED = sorted(name for name, fn in vars(jax_cases).items()
                  if name.startswith("test_") and callable(fn))


def _rebind(fn):
    return types.FunctionType(fn.__code__, {**fn.__globals__, **PORT_NAMES},
                              fn.__name__, fn.__defaults__, fn.__closure__)


def _replay_params():
    for name in REPLAYED:
        params = inspect.signature(getattr(jax_cases, name)).parameters
        if "store" in params:
            for kind in ("memstore", "tpustore"):
                yield pytest.param(name, kind, id=f"{name}-{kind}")
        elif "make_db" in params:
            for i in range(2):
                yield pytest.param(name, i, id=f"{name}-{i}")
        else:
            yield pytest.param(name, None, id=name)


@pytest.mark.parametrize("name,param", list(_replay_params()))
def test_jax_objectstore_case_on_the_port(name, param, tmp_path):
    fn = _rebind(getattr(jax_cases, name))
    params = inspect.signature(fn).parameters
    kwargs = {}
    if "tmp_path" in params:
        kwargs["tmp_path"] = tmp_path
    if "make_db" in params:
        mark = next(m for m in getattr(jax_cases, name).pytestmark
                    if m.name == "parametrize")
        kwargs["make_db"] = _rebind(mark.args[1][param])
    s = None
    if "store" in params:
        # the `store` fixture of tests/test_objectstore.py, on the port
        if param == "memstore":
            s = MemStore()
        else:
            s = TPUStore(str(tmp_path / "store"), device="cpu")
        s.mkfs()
        s.mount()
        t = Transaction()
        t.create_collection(jax_cases.CID)
        s.queue_transaction(t)
        kwargs["store"] = s
    try:
        fn(**kwargs)
    finally:
        if s is not None:
            s.umount()


def test_replay_covers_the_tpustore_cases():
    assert sum(n.startswith("test_tpustore_") for n in REPLAYED) >= 12
    assert os.path.basename(jax_cases.__file__) == "test_objectstore.py"
