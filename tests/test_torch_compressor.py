"""The port's compressor framework (ceph_tpu_torch.compressor: the registry,
the five codecs, the gate and the scoring) against the JAX package's, on the
CPU.

Codec output, histograms and match fractions are bytes or exact integers and
float32 quotients, held bit for bit.  The entropy is a float32 sum over 256
bins taken in another order than XLA's, held within
score_kernels.ENTROPY_TOL (2e-6 bits per byte); compress_decision verdicts
are held equal wherever |entropy / 8 - (required_ratio + margin)| exceeds
that tolerance, and the rows inside it are counted (none on this data).
The JAX tests of tests/test_compressor.py are also replayed against the
port's names, the scoring functions bound to device="cpu".
"""

import functools
import inspect
import types

import numpy as np
import pytest
import torch

import test_compressor as jax_cases
from ceph_tpu import compressor as jcomp
from ceph_tpu.compressor import gate as jgate
from ceph_tpu.compressor import scoring as jscoring
from ceph_tpu_torch import compressor as comp
from ceph_tpu_torch.compressor import gate, plugins, scoring
from ceph_tpu_torch.ops import score_kernels

SEED = 20261017
TOL = score_kernels.ENTROPY_TOL
# the shapes of chip_smoke's phase 3f kernel check, B cut for the CPU
SHAPES = ((1, 1), (256, 3), (64, 511), (32, 512), (16, 513), (8, 4097),
          (2, 65536))
KINDS = ("zeros", "text", "random", "pattern")


def make_blocks(kind: str, b: int, s: int, rng) -> np.ndarray:
    """(b, s) uint8 of one data kind: zeros, English-like text, random
    bytes, or a 256-byte random pattern repeated."""
    if kind == "zeros":
        return np.zeros((b, s), np.uint8)
    if kind == "random":
        return rng.integers(0, 256, (b, s), dtype=np.uint8)
    if kind == "text":
        words = [b"object", b"placement", b"group", b"the", b"erasure",
                 b"coded", b"shard", b"of", b"and", b"store", b"a"]
        out = bytearray()
        while len(out) < b * s:
            out += words[int(rng.integers(len(words)))] + b" "
        return np.frombuffer(bytes(out[:b * s]), np.uint8).reshape(b, s).copy()
    pattern = rng.integers(0, 256, 256, dtype=np.uint8)
    return np.resize(pattern, (b, s))


def _payloads():
    yield from jax_cases._payloads()
    rng = np.random.default_rng(SEED)
    for kind in KINDS:
        yield make_blocks(kind, 1, 100_000, rng).tobytes()


# -- codecs ---------------------------------------------------------------


def test_same_algorithms_as_jax():
    assert comp.available_algorithms() == jcomp.available_algorithms()
    assert comp.COMPRESSION_ALGORITHMS == jcomp.COMPRESSION_ALGORITHMS
    for mode in range(4):
        assert comp.get_comp_mode_name(mode) == \
            jcomp.get_comp_mode_name(mode)


@pytest.mark.parametrize("name", ["zlib", "lz4", "snappy", "zstd", "brotli"])
def test_compressed_bytes_equal_jax(name):
    ours, theirs = comp.Compressor.create(name), jcomp.Compressor.create(name)
    assert ours.get_type() == theirs.get_type()
    for data in _payloads():
        payload, msg = ours.compress(data)
        assert (payload, msg) == theirs.compress(data), (name, len(data))
        assert ours.decompress(payload, msg) == data
        assert theirs.decompress(payload, msg) == data


@pytest.mark.parametrize("name", ["zlib", "lz4", "snappy"])
@pytest.mark.parametrize("mode", ["none", "passive", "aggressive", "force"])
@pytest.mark.parametrize("hint", [0, comp.ALLOC_HINT_COMPRESSIBLE,
                                  comp.ALLOC_HINT_INCOMPRESSIBLE])
def test_gate_equals_jax(name, mode, hint):
    rng = np.random.default_rng(SEED)
    for kind in KINDS:
        data = make_blocks(kind, 1, 65536, rng).tobytes()
        for ratio in (0.5, 0.875, 1.0):
            got = gate.maybe_compress(data, comp.Compressor.create(name),
                                      comp.get_comp_mode_type(mode), hint,
                                      ratio)
            want = jgate.maybe_compress(data, jcomp.Compressor.create(name),
                                        jcomp.get_comp_mode_type(mode), hint,
                                        ratio)
            assert got[0] == want[0]
            assert (got[1] is None) == (want[1] is None)
            if got[1] is not None:
                assert vars(got[1]) == vars(want[1])
                assert gate.decompress(got[0], got[1]) == data


def test_lz4_and_snappy_do_not_go_unregistered(monkeypatch):
    """The port's lz4 and snappy do not hinge on the library loading: a
    failed build raises where the JAX package leaves them unregistered."""
    def broken():
        raise RuntimeError("g++ exited 1")

    monkeypatch.setattr(plugins.native, "get_lib", broken)

    class Registry:
        def __init__(self):
            self.names = []

        def add(self, _type, name, _plugin):
            self.names.append(name)

    registry = Registry()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        plugins.register_all(registry)
    assert "lz4" not in registry.names and "snappy" not in registry.names


# -- scoring --------------------------------------------------------------


def _batches():
    rng = np.random.default_rng(SEED)
    for b, s in SHAPES:
        for kind in KINDS:
            yield kind, make_blocks(kind, b, s, rng)


@pytest.mark.parametrize("kind", KINDS)
def test_host_scores_equal_jax_host(kind):
    rng = np.random.default_rng(SEED)
    for b, s in SHAPES:
        blocks = make_blocks(kind, b, s, rng)
        np.testing.assert_array_equal(scoring.byte_histograms_host(blocks),
                                      jscoring.byte_histograms_host(blocks))
        e, je = (scoring.entropy_bits_per_byte_host(blocks),
                 jscoring.entropy_bits_per_byte_host(blocks))
        assert e.dtype == je.dtype == np.float32
        assert e.tobytes() == je.tobytes()
        m, jm = (scoring._match_fraction_host(blocks),
                 jscoring._match_fraction_host(blocks))
        assert m.tobytes() == jm.tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_plain_scores_equal_jax_device_code(kind):
    """score_blocks_plain against the XLA functions the kernel replaces
    (_byte_histograms_dev, _entropy_dev, _match_fraction_dev on the CPU)."""
    worst = 0.0
    for k, blocks in _batches():
        if k != kind:
            continue
        hist, entropy, match = score_kernels.score_blocks(
            torch.from_numpy(blocks))
        assert hist.dtype == torch.int32 and tuple(hist.shape) == (
            blocks.shape[0], 256)
        np.testing.assert_array_equal(
            hist.numpy(), np.asarray(jscoring._byte_histograms_dev(blocks)))
        jm = np.asarray(jscoring._match_fraction_dev(blocks))
        assert match.numpy().tobytes() == jm.tobytes(), blocks.shape
        je = np.asarray(jscoring._entropy_dev(blocks))
        worst = max(worst, float(np.abs(entropy.numpy() - je).max()))
    assert worst <= TOL


def test_plain_match_is_the_reciprocal_product():
    """XLA's float32 mean is the count times the rounded reciprocal; the
    one-rounding quotient differs from it on this batch, so the port
    follows XLA's product."""
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, (16, 511), dtype=np.uint8)
    _h, _e, match = score_kernels.score_blocks_plain(torch.from_numpy(blocks))
    quotient = np.zeros(16, np.float32)
    for lag in score_kernels.PROBE_LAGS:
        if lag >= 511:
            break
        count = (blocks[:, lag:] == blocks[:, :-lag]).sum(1)
        quotient = np.maximum(quotient, count.astype(np.float32)
                              / np.float32(511 - lag))
    jm = np.asarray(jscoring._match_fraction_dev(blocks))
    assert match.numpy().tobytes() == jm.tobytes()
    assert quotient.tobytes() != jm.tobytes()


@pytest.mark.parametrize("fn", ["byte_histograms", "entropy_bits_per_byte",
                                "match_fraction"])
def test_public_functions_route_by_size(fn, monkeypatch):
    """Under MIN_DEVICE_BYTES the host function, at or above it the plain
    PyTorch version on the CPU device; both equal the JAX function."""
    calls = []
    real = score_kernels.score_blocks_packed
    monkeypatch.setattr(score_kernels, "score_blocks_packed",
                        lambda t: calls.append(t.shape) or real(t))
    rng = np.random.default_rng(SEED)
    for b, s in ((4, 1000), (1, 65536), (2, 40000)):
        blocks = make_blocks("text", b, s, rng)
        got = getattr(scoring, fn)(blocks, device="cpu")
        want = np.asarray(getattr(jscoring, fn)(blocks))
        if fn == "entropy_bits_per_byte":
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        else:
            np.testing.assert_array_equal(got, want)
        assert isinstance(got, np.ndarray)
    assert calls == [(1, 65536), (2, 40000)]


def test_compress_decision_verdicts_equal_jax():
    margin, ratios = 0.05, (0.5, 0.7, 0.875, 0.95)
    near = compared = 0
    for _kind, blocks in _batches():
        for ratio in ratios:
            got = scoring.compress_decision(blocks, ratio, margin,
                                            device="cpu")
            want = np.asarray(jscoring.compress_decision(blocks, ratio,
                                                         margin))
            entropy = np.asarray(jscoring.entropy_bits_per_byte(blocks))
            far = np.abs(entropy / 8 - (ratio + margin)) > TOL
            near += int((~far).sum())
            compared += int(far.sum())
            assert got.dtype == bool
            np.testing.assert_array_equal(got[far], want[far])
    assert near == 0 and compared > 0


def test_scoring_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blocks = np.zeros((1, 16), np.uint8)
    for fn in (scoring.byte_histograms, scoring.entropy_bits_per_byte,
               scoring.match_fraction, scoring.compress_decision):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(blocks)


@pytest.mark.parametrize("kind", KINDS)
def test_packed_rows_hold_the_three_scores(kind):
    """score_blocks_packed's (B, 258) int32 rows: the histogram, then the
    entropy's and the match fraction's float32 bits; score_blocks and the
    host-side split of _device_scores read them back unchanged."""
    rng = np.random.default_rng(SEED)
    blocks = make_blocks(kind, 3, 70_000, rng)
    packed = score_kernels.score_blocks_packed(torch.from_numpy(blocks))
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (
        3, score_kernels.OUT_COLS)
    hist, entropy, match = score_kernels.score_blocks_plain(
        torch.from_numpy(blocks))
    views = score_kernels.unpack(packed)
    for got, want in zip(views, (hist, entropy, match)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    host = scoring._device_scores(blocks, "cpu")
    for got, want in zip(host, (hist, entropy, match)):
        assert isinstance(got, np.ndarray)
        assert got.tobytes() == np.ascontiguousarray(want.numpy()).tobytes()


def test_score_blocks_checks_its_input():
    with pytest.raises(ValueError):
        score_kernels.score_blocks(torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        score_kernels.score_blocks(torch.zeros((2, 4), dtype=torch.int32))


# -- the JAX tests of tests/test_compressor.py, replayed on the port -------

ON_CPU = types.SimpleNamespace(**{
    name: (functools.partial(getattr(scoring, name), device="cpu")
           if name in ("byte_histograms", "entropy_bits_per_byte",
                       "match_fraction", "compress_decision")
           else getattr(scoring, name))
    for name in dir(scoring) if not name.startswith("__")})
PORT_NAMES = {"comp": comp, "gate": gate, "scoring": ON_CPU,
              **{cls: getattr(plugins, cls) for cls in (
                  "BrotliCompressor", "Lz4Compressor", "SnappyCompressor",
                  "ZlibCompressor", "ZstdCompressor")}}
REPLAYED = sorted(name for name, fn in vars(jax_cases).items()
                  if name.startswith("test_") and callable(fn))


def _replay_params():
    for name in REPLAYED:
        fn = getattr(jax_cases, name)
        params = inspect.signature(fn).parameters
        if "codec" in params:
            for alg in jcomp.available_algorithms():
                yield pytest.param(name, {"codec": alg}, id=f"{name}-{alg}")
        elif "cls" in params:
            for mark in fn.pytestmark:
                if mark.name == "parametrize":
                    for cls in mark.args[1]:
                        yield pytest.param(name, {"cls": cls.__name__},
                                           id=f"{name}-{cls.__name__}")
        else:
            yield pytest.param(name, {}, id=name)


@pytest.mark.parametrize("name,args", list(_replay_params()))
def test_jax_compressor_case_on_the_port(name, args):
    fn = getattr(jax_cases, name)
    fn = types.FunctionType(fn.__code__, {**fn.__globals__, **PORT_NAMES},
                            fn.__name__, fn.__defaults__, fn.__closure__)
    kwargs = {}
    if "codec" in args:
        kwargs["codec"] = comp.Compressor.create(args["codec"])
    if "cls" in args:
        kwargs["cls"] = getattr(plugins, args["cls"])
    fn(**kwargs)
