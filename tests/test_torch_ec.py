"""The ceph_tpu_torch erasure-coded data path against the JAX package, on
the CPU: the ec_torch codec against ErasureCodeJax for the four w=8
techniques, and the port's ec_util encode_with_hinfo / decode against
ceph_tpu.osd.ec_util.  Inputs come from numpy with fixed seeds; every
output is bytes or a crc, so the tolerance is exact equality.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu.common.buffer import as_buffer
from ceph_tpu.ec.jax_plugin import ErasureCodeJax
from ceph_tpu.osd import ec_util as jec
from ceph_tpu_torch import device as tdevice
from ceph_tpu_torch.ec import dispatch as tdispatch
from ceph_tpu_torch.ec import registry as tregistry
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.torch_plugin import ErasureCodeTorch, from_numpy_matrix
from ceph_tpu_torch.osd import ec_util as tec

K = 8
CHUNK = 2048
B = 3
TECHNIQUES = [("reed_sol_van", 3), ("reed_sol_r6_op", 2),
              ("cauchy_orig", 3), ("cauchy_good", 3)]
ROOT = Path(__file__).resolve().parent.parent


def _pair(technique: str, m: int):
    jax_codec = ErasureCodeJax(technique)
    jax_codec.init({"k": str(K), "m": str(m)})
    port = ErasureCodeTorch(technique, device="cpu")
    port.init({"k": str(K), "m": str(m)})
    return jax_codec, port


def _stripes(seed: int, m: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (B, K + m, CHUNK), dtype=np.uint8)


@pytest.mark.parametrize("technique,m", TECHNIQUES)
def test_encode_batch_matches_jax(technique, m):
    jax_codec, port = _pair(technique, m)
    assert np.array_equal(port.matrix, jax_codec.matrix)
    data = _stripes(1)
    assert np.array_equal(port.encode_batch(data),
                          np.asarray(jax_codec.encode_batch(data)))


@pytest.mark.parametrize("technique,m", TECHNIQUES)
def test_decode_batch_every_single_erasure(technique, m):
    jax_codec, port = _pair(technique, m)
    data = _stripes(2)
    full = np.concatenate([data, port.encode_batch(data)], axis=1)
    for e in range(K + m):
        have = tuple(i for i in range(K + m) if i != e)[:K]
        survivors = np.ascontiguousarray(full[:, list(have), :])
        got = port.decode_batch(have, (e,), survivors)
        want = np.asarray(jax_codec.decode_batch(have, (e,), survivors))
        assert np.array_equal(got, want), e
        assert np.array_equal(got[:, 0, :], full[:, e, :]), e


@pytest.mark.parametrize("technique,m", TECHNIQUES)
def test_interface_encode_decode_matches_jax(technique, m):
    jax_codec, port = _pair(technique, m)
    rng = np.random.default_rng(3)
    obj = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    want_all = set(range(K + m))
    jenc = jax_codec.encode(want_all, obj)
    tenc = port.encode(want_all, obj)
    assert {i: bytes(v) for i, v in tenc.items()} == \
        {i: bytes(v) for i, v in jenc.items()}
    lost = {1, K} if m >= 2 else {1}
    chunks = {i: bytes(v) for i, v in tenc.items() if i not in lost}
    want = set(range(K))
    jdec = jax_codec.decode(want, chunks)
    tdec = port.decode(want, chunks)
    for i in want:
        assert bytes(tdec[i]) == bytes(jdec[i]) == bytes(tenc[i])
    assert bytes(port.decode_concat(chunks))[:len(obj)] == obj


@pytest.mark.parametrize("technique,m", TECHNIQUES)
def test_fused_crc_entries_match_jax(technique, m):
    jax_codec, port = _pair(technique, m)
    data = _stripes(4)
    for init in (0, 0xFFFFFFFF):
        jp, jc = jax_codec.encode_batch_with_crc(data, init=init)
        tp, tc = port.encode_batch_with_crc(data, init=init)
        assert tc.dtype == np.uint32 and tc.shape == (B, K + m)
        assert np.array_equal(tp, np.asarray(jp))
        assert np.array_equal(tc, np.asarray(jc))
    parts = [data[:1], data[1:]]
    jm = jax_codec.encode_many_with_crc(parts, init=0xFFFFFFFF)
    tm = port.encode_many_with_crc(parts, init=0xFFFFFFFF)
    assert len(tm) == len(jm) == 2
    for (tp, tc), (jp, jc) in zip(tm, jm):
        assert np.array_equal(tp, np.asarray(jp))
        assert np.array_equal(tc, np.asarray(jc))
    assert port.encode_many_with_crc([data, data[:, :, :1024]]) is None


@pytest.mark.parametrize("n_stripes", [1, 3, 5])
def test_ec_util_matches_jax(monkeypatch, n_stripes):
    """encode_with_hinfo and decode of the port (CPU tier and its fused
    tier) against ceph_tpu.osd.ec_util with its fused plan path on."""
    monkeypatch.setenv("CEPH_TPU_FUSE_MIN_BYTES", "0")
    jax_codec, port = _pair("reed_sol_van", 3)
    n = K + 3
    jsinfo = jec.StripeInfo(K, K * CHUNK)
    tsinfo = tec.StripeInfo(K, K * CHUNK)
    rng = np.random.default_rng(10 + n_stripes)
    obj = rng.integers(0, 256, n_stripes * K * CHUNK,
                       dtype=np.uint8).tobytes()
    logical = len(obj) - 7
    js, jh, jcrc = jec.encode_with_hinfo(jsinfo, jax_codec, obj, range(n),
                                         logical_len=logical)
    want_shards = {i: bytes(as_buffer(v)) for i, v in js.items()}
    results = [tec.encode_with_hinfo(tsinfo, port, obj, range(n),
                                     logical_len=logical),
               tec._encode_with_hinfo_device(tsinfo, port, obj, range(n),
                                             logical)]
    for ts, th, tcrc in results:
        assert {i: bytes(v) for i, v in ts.items()} == want_shards
        assert th.cumulative_shard_hashes == jh.cumulative_shard_hashes
        assert th.total_chunk_size == jh.total_chunk_size
        assert tcrc == jcrc
    ts = results[0][0]
    for lost in ({2}, {0, 9}, {1, 4, 6}):
        shards = {i: bytes(ts[i]) for i in range(n) if i not in lost}
        got = bytes(tec.decode(tsinfo, port, shards))
        assert got == bytes(jec.decode(jsinfo, jax_codec, shards)) == obj


def test_from_numpy_matrix_round_trips_jax_generator():
    for technique, m in TECHNIQUES:
        jax_codec = ErasureCodeJax(technique)
        jax_codec.init({"k": str(K), "m": str(m)})
        port = from_numpy_matrix(technique, K, m, jax_codec.matrix,
                                 device="cpu")
        assert np.array_equal(port.matrix, jax_codec.matrix)
        data = _stripes(5)
        assert np.array_equal(port.encode_batch(data),
                              np.asarray(jax_codec.encode_batch(data)))
    wrong = np.array(jax_codec.matrix)
    wrong[0, 0] ^= 1
    with pytest.raises(ValueError):
        from_numpy_matrix(technique, K, m, wrong, device="cpu")


def test_registry_builds_the_torch_codec():
    codec = tregistry.create_erasure_code(
        {"plugin": "ec_torch", "technique": "cauchy_good", "k": "8",
         "m": "3", "device": "cpu"})
    assert isinstance(codec, ErasureCodeTorch)
    assert codec.get_profile()["device"] == "cpu"
    assert not codec.use_tpu and codec.tpu_min_bytes == 1
    with pytest.raises(ErasureCodeError):
        tregistry.create_erasure_code({"plugin": "ec_jax", "device": "cpu"})


def test_wide_words_are_not_ported_yet():
    codec = ErasureCodeTorch("reed_sol_van", device="cpu")
    with pytest.raises(ErasureCodeError) as err:
        codec.init({"k": "4", "m": "2", "w": "16"})
    assert err.value.errno == 22


def test_decode_rows_are_keyed_by_codec_signature(monkeypatch):
    # an empty process-wide cache: other test files in this worker may
    # already have cached these rows (an LRC layer is reed_sol_van 4+2)
    monkeypatch.setattr(tdispatch, "_decode_rows", tdispatch.LruCache(512))
    a = ErasureCodeTorch("reed_sol_van", device="cpu")
    a.init({"k": "4", "m": "2"})
    b = ErasureCodeTorch("cauchy_orig", device="cpu")
    b.init({"k": "4", "m": "2"})
    have, lost = (1, 2, 3, 4), (0,)
    before = tdispatch.decode_rows_stats()["misses"]
    rows_a = a._decode_matrix(have, lost)
    rows_b = b._decode_matrix(have, lost)
    assert not np.array_equal(rows_a, rows_b)
    assert tdispatch.decode_rows_stats()["misses"] == before + 2
    assert a._decode_matrix(have, lost) is rows_a


def test_resolve_device_never_picks_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError):
        tdevice.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        ErasureCodeTorch("reed_sol_van")
    assert tdevice.resolve_device("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_ceph_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ceph_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    ceph_tpu_torch.__path__, 'ceph_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'ceph_tpu')\n"
        "             or n.startswith(('jax.', 'ceph_tpu.')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


def _import_roots(path: Path):
    """(line, root module) of every Import/ImportFrom in a file, at any
    depth: inside functions and branches too, where importing every
    module does not reach."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_port_imports_neither_jax_nor_ceph_tpu_at_any_depth():
    files = sorted((ROOT / "ceph_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = [f"{path.relative_to(ROOT)}:{line} imports {root}"
           for path in files for line, root in _import_roots(path)
           if root in ("jax", "jaxlib", "ceph_tpu")]
    assert not bad, bad
    assert len(files) > 40
