"""The port's packed bitmatrix tier (ceph_tpu_torch/osd/ec_util.py
`_encode_many_bitmatrix`) and the encode service's hot/cold router
(osd/encode_service.py `_cold_inline`) against the JAX package's, on the
CPU.

The packed tier runs every stripe of every object as one object of a
single region arena: on the native tape for a `device="cpu"` codec, and
on the path a CUDA codec takes (`_packed_on_device`: the staged arena,
the `xor_sched` region entry and the crc32c_blocks spans, here their
plain versions on CPU tensors).  Shards, HashInfo ledgers and data crcs
equal the reference's `_encode_many_bitmatrix` and, for full want sets,
its inline `encode_with_hinfo` (with a partial want set the two tiers'
ledgers differ in both packages: ROADMAP C11, pinned here); parity
leaves immutable.  The router's
inline-versus-packed decisions follow the reference's on one fake clock,
per mClock class; through the service, bursts pack, trickles stay inline,
and plain encode and decode of a bitmatrix codec never batch.  Bytes and
integers: exact equality.
"""

import asyncio
import types

import numpy as np
import pytest
import torch

from ceph_tpu.ec.registry import create_erasure_code as jcreate
from ceph_tpu.osd import ec_util as jec_util
from ceph_tpu.osd import encode_service as jservice
from ceph_tpu.osd import scheduler as jscheduler
from ceph_tpu_torch.common.buffer import is_immutable
from ceph_tpu_torch.ec import xsched
from ceph_tpu_torch.ec.registry import create_erasure_code
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd import encode_service as tservice
from ceph_tpu_torch.osd import scheduler as tscheduler

SEED = 20261018
K, W, PS = 4, 8, 512
CHUNK = W * PS                    # single-block chunks: packable
WIDTH = K * CHUNK
CPU = torch.device("cpu")


def _profile(**extra) -> dict:
    return {"plugin": "jerasure", "technique": "liber8tion", "k": str(K),
            "m": "2", "w": str(W), "packetsize": str(PS), **extra}


def _codecs(**extra):
    return (create_erasure_code({**_profile(**extra), "device": "cpu"}),
            jcreate(_profile(**extra)))


def _payload(rng, stripes: int = 1) -> bytes:
    return rng.bytes(stripes * WIDTH)


def _same(got, want) -> None:
    shards, hinfo, crc = got
    wshards, whinfo, wcrc = want
    assert crc == wcrc
    assert hinfo.total_chunk_size == whinfo.total_chunk_size
    assert hinfo.cumulative_shard_hashes == whinfo.cumulative_shard_hashes
    assert sorted(shards) == sorted(wshards)
    for i in shards:
        assert bytes(shards[i]) == bytes(wshards[i]), i


def _on_device(monkeypatch) -> None:
    """Run the packed tier as a CUDA codec does, on CPU tensors."""
    def packed(prog, datas, stripes_of, k, m, _w, _ps, chunk):
        return ec_util._packed_on_device(CPU, prog, datas, sum(stripes_of),
                                         k, m, chunk)
    monkeypatch.setattr(ec_util, "_packed_native", packed)


@pytest.mark.parametrize("executor", ["native", "device"])
def test_packed_tier_equals_jax(monkeypatch, executor):
    """Mixed stripe counts, logical lengths and want sets in one arena:
    every item's shards, ledger and crc equal the reference's packed
    tier and its inline encode; parity is immutable, data shards are
    the source bytes."""
    if executor == "device":
        _on_device(monkeypatch)
    tc, jc = _codecs()
    rng = np.random.default_rng(SEED)
    items = [(_payload(rng, s), want, length) for s, want, length in (
        (2, range(6), None), (1, (0, 4, 5), 3 * WIDTH // 4),
        (3, range(6), 3 * WIDTH - 3), (1, (1, 2, 3, 5), WIDTH))]
    sinfo, jsinfo = ec_util.StripeInfo(K, WIDTH), jec_util.StripeInfo(K,
                                                                      WIDTH)
    got = ec_util._encode_many_bitmatrix(sinfo, tc, items)
    ref = jec_util._encode_many_bitmatrix(jsinfo, jc, items)
    assert got is not None and ref is not None
    for (d, want, length), g, r in zip(items, got, ref):
        _same(g, r)
        inline = jec_util.encode_with_hinfo(jsinfo, jc, d, want,
                                            logical_len=length)
        if len(set(want)) == 6:
            _same(g, inline)
        else:
            # ROADMAP C11, copied from the reference: with a partial want
            # set the packed tier's ledger still covers every shard,
            # while encode_with_hinfo's covers the wanted ones only
            port_inline = ec_util.encode_with_hinfo(sinfo, tc, d, want,
                                                    logical_len=length)
            _same(port_inline, inline)
            assert g[1].cumulative_shard_hashes != \
                inline[1].cumulative_shard_hashes
            assert r[1].cumulative_shard_hashes != \
                inline[1].cumulative_shard_hashes
        shards = g[0]
        for i in shards:
            assert memoryview(shards[i]).readonly
            if i >= K:
                assert is_immutable(shards[i])


def test_packed_tier_is_one_tape_run_for_the_batch():
    """encode_many_with_hinfo routes a bitmatrix codec's batch through
    the packed tier: one native tape call for every object."""
    tc, jc = _codecs()
    rng = np.random.default_rng(SEED + 1)
    items = [(_payload(rng), range(6), WIDTH) for _ in range(16)]
    xsched.reset_stats()
    got = ec_util.encode_many_with_hinfo(ec_util.StripeInfo(K, WIDTH), tc,
                                         items)
    assert xsched.stats()["exec_native"] == 1
    jsinfo = jec_util.StripeInfo(K, WIDTH)
    for (d, want, length), g in zip(items, got):
        _same(g, jec_util.encode_with_hinfo(jsinfo, jc, d, want,
                                            logical_len=length))


def test_packed_tier_gates_equal_jax(monkeypatch):
    """The gate and the geometry refusals: multi-block chunks, a chunk
    mapping, an RS codec, the kill switches."""
    tc, jc = _codecs()
    assert ec_util.bitmatrix_native_available(tc) == \
        jec_util.bitmatrix_native_available(jc) is True
    rng = np.random.default_rng(SEED + 2)
    wide = ec_util.StripeInfo(K, 2 * WIDTH)      # two blocks a chunk
    item = [(_payload(rng, 2), range(6), None)]
    assert ec_util._encode_many_bitmatrix(wide, tc, item) is None
    assert jec_util._encode_many_bitmatrix(
        jec_util.StripeInfo(K, 2 * WIDTH), jc, item) is None
    ragged = [(_payload(rng)[:-1], range(6), None)]
    assert ec_util._encode_many_bitmatrix(ec_util.StripeInfo(K, WIDTH), tc,
                                          ragged) is None
    mapped, jmapped = _codecs(mapping="DD_DD_")
    assert not ec_util.bitmatrix_native_available(mapped)
    assert not jec_util.bitmatrix_native_available(jmapped)
    rs = create_erasure_code({"plugin": "jerasure", "k": "4", "m": "2",
                              "technique": "reed_sol_van", "device": "cpu"})
    assert not ec_util.bitmatrix_native_available(rs)
    for flag in ("CEPH_TPU_XSCHED", "CEPH_TPU_NATIVE_XSCHED"):
        monkeypatch.setenv(flag, "0")
        assert not ec_util.bitmatrix_native_available(tc)
        assert not jec_util.bitmatrix_native_available(jc)
        monkeypatch.delenv(flag)


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def perf_counter(self) -> float:
        return self.now


# (seconds since the last arrival, mClock class, a batch pooling or in
# flight) for each arrival, on a 4 ms window (the hot bar: 1 ms gaps)
ARRIVALS = [(0.0, "client", False), (0.0005, "client", False),
            (0.0004, "client", False), (0.02, "client", False),
            (0.0002, "background_recovery", False),
            (0.0003, "background_recovery", False),
            (0.0001, "background_recovery", True),
            (0.0002, "client", False), (0.03, "client", True),
            (0.0001, "tenant.a", False), (0.0001, "tenant.b", False),
            (0.0005, "client", False), (0.002, "background_recovery", False),
            (0.0009, "background_recovery", False),
            (0.0009, "background_recovery", False)]


def test_router_decisions_equal_jax_on_one_clock(monkeypatch):
    """The hot/cold router's inline-versus-packed decision for every
    arrival of a mixed trace, per mClock class, equals the reference's
    on the same fake clock (the same gaps, the same pooling state)."""
    clock = FakeClock()
    fake_time = types.SimpleNamespace(perf_counter=clock.perf_counter)
    decisions = {}
    for name, svc_mod, sched_mod, (codec, sinfo) in (
            ("jax", jservice, jscheduler,
             (jcreate(_profile()), jec_util.StripeInfo(K, WIDTH))),
            ("port", tservice, tscheduler,
             (create_erasure_code({**_profile(), "device": "cpu"}),
              ec_util.StripeInfo(K, WIDTH)))):
        monkeypatch.setattr(svc_mod, "time", fake_time)
        svc = svc_mod.EncodeService(window_ms=4)
        q = svc._bucket_for("encode_hinfo", sinfo, codec)
        assert q is not None and q.tier == "bitmatrix"
        out = []
        for gap, cls, pooling in ARRIVALS:
            clock.now += gap
            q.in_flight = 1 if pooling else 0
            token = sched_mod._current_class.set(cls)
            try:
                out.append(svc._cold_inline(q))
            finally:
                sched_mod._current_class.reset(token)
        decisions[name] = (out, dict(q.ewma_gap))
    assert decisions["port"] == decisions["jax"]
    assert True in decisions["port"][0] and False in decisions["port"][0]


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, 120))


@pytest.mark.parametrize("executor", ["native", "device"])
def test_service_packs_a_burst_and_inlines_a_trickle(monkeypatch, executor):
    """A 24-way burst rides the packed tier (few inline leaders, at least
    one batch); a trickle spaced 4x the window stays inline_cold; every
    result equals the reference's inline encode."""
    if executor == "device":
        _on_device(monkeypatch)
    tc, jc = _codecs()
    rng = np.random.default_rng(SEED + 3)
    burst = [_payload(rng) for _ in range(24)]
    cold = _payload(rng)
    sinfo = ec_util.StripeInfo(K, WIDTH)

    async def main():
        svc = tservice.EncodeService(window_ms=5)
        trickle = []
        for _ in range(3):
            trickle.append(await svc.encode_with_hinfo(
                sinfo, tc, cold, range(6), logical_len=WIDTH))
            await asyncio.sleep(0.02)
        before = dict(svc.stats())
        svc.window_s = 0.05     # keep the burst's gaps well inside it
        outs = await asyncio.gather(
            *(svc.encode_with_hinfo(sinfo, tc, b, range(6),
                                    logical_len=len(b)) for b in burst))
        st = svc.stats()
        await svc.stop()
        return trickle, before, outs, st

    trickle, before, outs, st = _run(main())
    assert before["inline_cold"] == 3 and before["batches"] == 0
    assert st["batched"] >= 16 and st["batches"] >= 1
    assert st["batched"] + st["inline_cold"] == 27
    jsinfo = jec_util.StripeInfo(K, WIDTH)
    for got in trickle:
        _same(got, jec_util.encode_with_hinfo(jsinfo, jc, cold, range(6),
                                              logical_len=WIDTH))
    for b, got in zip(burst, outs):
        _same(got, jec_util.encode_with_hinfo(jsinfo, jc, b, range(6),
                                              logical_len=len(b)))


def test_plain_encode_and_decode_stay_inline(monkeypatch):
    """Only the hinfo write path packs: a bitmatrix codec's plain encode
    and decode run inline, and so does everything under
    CEPH_TPU_NATIVE_XSCHED=0 on the CPU."""
    tc, jc = _codecs()
    rng = np.random.default_rng(SEED + 4)
    buf = _payload(rng, 2)
    sinfo = ec_util.StripeInfo(K, WIDTH)

    async def main():
        svc = tservice.EncodeService()
        enc = await svc.encode(sinfo, tc, buf, range(6))
        dec = await svc.decode(sinfo, tc, {i: enc[i] for i in (1, 2, 3, 5)})
        st = svc.stats()
        await svc.stop()
        return enc, dec, st

    enc, dec, st = _run(main())
    assert st["batched"] == 0 and st["inline"] == 2
    ref = jec_util.encode(jec_util.StripeInfo(K, WIDTH), jc, buf, range(6))
    assert all(bytes(enc[i]) == bytes(ref[i]) for i in range(6))
    assert bytes(dec) == buf
    monkeypatch.setenv("CEPH_TPU_NATIVE_XSCHED", "0")

    async def killed():
        svc = tservice.EncodeService()
        out = await svc.encode_with_hinfo(sinfo, tc, buf, range(6),
                                          logical_len=len(buf))
        st = svc.stats()
        await svc.stop()
        return out, st

    out, st = _run(killed())
    assert st["inline"] == 1 and st["batched"] == 0
    _same(out, jec_util.encode_with_hinfo(
        jec_util.StripeInfo(K, WIDTH), jc, buf, range(6),
        logical_len=len(buf)))
