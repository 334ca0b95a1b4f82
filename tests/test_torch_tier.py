"""The port's read-tier agent (ceph_tpu_torch.osd.tier.TierAgent) against the
JAX package's (ceph_tpu.osd.tier.TierAgent), on the CPU.

Both agents get one config and one Zipf read trace (ceph_tpu.tools.rados.
zipf_indices over oids spread across PGs) and the same clock: time.monotonic
is replaced by a fake that advances a millisecond per read, so hit-set
periods and promotion backoff expire at the same read in both.  `_drive`
does what the OSD's read path does per read (record, lookup, and on a miss
the promote decision, begin and end), with byte-pressure eviction, failed
promotions and their backoff, invalidations, drop_pg, an object larger than
the whole budget and sealed-set draining mixed in.  Every decision, the
sealed hit sets, the hit-set dumps and the final counters must be equal.
The port seals a bloom set of DEVICE_MIN_BATCH hashes or more in one
`bloom_seal` (its plain version here) where the reference hashes on the
device and scatter-ORs on the host; rotate_all waves mix empty PGs, PGs
under DEVICE_MIN_BATCH hashes and explicit_hash stacks.
"""

import time

import pytest

from ceph_tpu.osd import tier as jtier
from ceph_tpu.tools.rados import zipf_indices
from ceph_tpu_torch.common import flags
from ceph_tpu_torch.ops import bloom_kernels
from ceph_tpu_torch.osd import hitset, tier

OIDS, PGS = 2000, 32


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


def _size(i: int) -> int:
    return 1024 * (1 + i % 13)


def _drive(agent, trace, clock, *, rotate_every=0, fail_every=0,
           invalidate_every=0, drop_every=0):
    """One agent through the read path; returns the decision log."""
    log = []
    for n, i in enumerate(trace):
        clock.now += 1e-3
        oid, pg = f"obj{i}", int(i) % PGS
        agent.record_read(pg, oid)
        hc = agent.hit_count(pg, oid)
        data = agent.lookup(pg, oid)
        wants = began = False
        if data is None:
            wants = agent.wants_promote(pg, oid, hc)
            if wants:
                began = agent.begin_promote(pg, oid)
                if began:
                    ok = not fail_every or int(i) % fail_every
                    agent.end_promote(pg, oid,
                                      bytes(_size(int(i))) if ok else None)
        log.append((hc, data is not None and len(data), wants, began))
        if rotate_every and (n + 1) % rotate_every == 0:
            agent.rotate_all()
        if invalidate_every and (n + 1) % invalidate_every == 0:
            agent.invalidate(pg, oid)
        if drop_every and (n + 1) % drop_every == 0:
            agent.drop_pg((n // drop_every) % PGS)
        if (n + 1) % 997 == 0:
            log.append([(pg, seq, s.to_dict())
                        for pg, seq, s in agent.pop_sealed()])
    return log


def _both(monkeypatch, config, trace, **kw):
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    port = tier.TierAgent("osd.0", dict(config), device="cpu")
    ref = jtier.TierAgent("osd.0", dict(config))
    clock.now = 1000.0
    got = _drive(port, trace, clock, **kw)
    clock.now = 1000.0
    want = _drive(ref, trace, clock, **kw)
    return port, ref, got, want


def _assert_same(port, ref, got, want):
    assert got == want
    assert port.counters() == ref.counters()
    assert list(port.cache) == list(ref.cache)
    assert port.cache_bytes == ref.cache_bytes
    dump_port, dump_ref = port.hitset_dump(), ref.hitset_dump()
    for d in (*dump_port.values(), *dump_ref.values()):
        d["open"].pop("age")
    assert dump_port == dump_ref
    status_port, status_ref = port.status(), ref.status()
    assert status_port == status_ref


@pytest.mark.parametrize("theta", [1.1, 0.6])
def test_zipf_trace_rotated_by_call(monkeypatch, theta):
    """The reference's defaults but period 0: hit sets rotate every 1,500
    reads by call; a 2 MiB budget under a 14 MiB working set evicts."""
    trace = zipf_indices(theta, OIDS, 12000, seed=7)
    port, ref, got, want = _both(
        monkeypatch, {"osd_hit_set_period": 0.0,
                      "osd_tier_cache_bytes": 2 << 20}, trace,
        rotate_every=1500)
    _assert_same(port, ref, got, want)
    counters = port.counters()
    assert counters["hit"] > 0 and counters["promote"] > 0
    assert counters["evict"] > 0 and counters["hitset_rotations"] > 0


def test_zipf_trace_rotated_by_the_clock(monkeypatch):
    """Period 1.5 s on the fake clock (1,500 reads): the first read past
    the boundary seals each PG's set, in both agents at the same read."""
    trace = zipf_indices(1.1, OIDS, 8000, seed=11)
    port, ref, got, want = _both(
        monkeypatch, {"osd_hit_set_period": 1.5,
                      "osd_hit_set_count": 3,
                      "osd_tier_cache_bytes": 1 << 20}, trace)
    _assert_same(port, ref, got, want)
    assert port.counters()["hitset_rotations"] > PGS


def test_failures_backoff_invalidate_and_drop_pg(monkeypatch):
    """Every 7th object's promotion fails and backs off for the default
    5 s of fake time; reads invalidate and drop whole PGs now and then."""
    trace = zipf_indices(1.1, OIDS, 15000, seed=3)
    port, ref, got, want = _both(
        monkeypatch, {"osd_hit_set_period": 0.0,
                      "osd_tier_cache_bytes": 4 << 20,
                      "osd_hit_set_type": "explicit_hash"}, trace,
        rotate_every=1500, fail_every=7, invalidate_every=37,
        drop_every=2500)
    _assert_same(port, ref, got, want)
    counters = port.counters()
    assert counters["promote_fail"] > 0 and counters["invalidate"] > 0


def test_oversize_object_never_wipes_the_cache(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    cfg = {"osd_tier_cache_bytes": 1000, "osd_tier_promote_min_recency": 1}
    agents = (tier.TierAgent("osd.t", cfg, device="cpu"),
              jtier.TierAgent("osd.t", cfg))
    for t in agents:
        for i in range(4):
            t.install("pg", f"o{i}", bytes(200))
        t.install("pg", "giant", bytes(5000))
        assert len(t.cache) == 4 and t.cache_bytes <= 1000
        assert t.lookup("pg", "giant") is None
        assert not t.wants_promote("pg", "giant", 99)
        t.invalidate("pg", "giant")
        assert t.wants_promote("pg", "giant", 99)
    assert agents[0].counters() == agents[1].counters()


def test_kill_switch_through_the_port_flags(monkeypatch):
    """CEPH_TPU_TIER=0 set through the port's flags registry disables
    both agents (they read one environment variable), and the flip is in
    the audit log."""
    monkeypatch.delenv("CEPH_TPU_TIER", raising=False)
    flags.clear_flips()
    flags.set_flag("CEPH_TPU_TIER", "0")
    try:
        agents = (tier.TierAgent("osd.t", {}, device="cpu"),
                  jtier.TierAgent("osd.t", {}))
        for t in agents:
            assert not t.enabled
            assert t.note_read("pg", "o") == 0
            t.install("pg", "o", b"data")
            assert t.lookup("pg", "o") is None
            assert not t.wants_promote("pg", "o", 99)
        assert agents[0].counters() == agents[1].counters()
        assert agents[0].counters()["records"] == 0
        assert [(f["flag"], f["old"], f["new"]) for f in flags.flips()] == \
            [("CEPH_TPU_TIER", "1", "0")]
    finally:
        flags.clear("CEPH_TPU_TIER")
    assert flags.enabled("CEPH_TPU_TIER")
    assert tier.TierAgent("osd.t", {}, device="cpu").enabled
    assert flags.registry()["CEPH_TPU_TIER"]["default"] == "1"
    with pytest.raises(flags.UnregisteredFlag):
        flags.get("CEPH_TPU_NO_SUCH_FLAG")


@pytest.mark.parametrize("kind,rotate_every", [
    ("bloom", 5), ("bloom", 40), ("bloom", 700), ("explicit_hash", 40)])
def test_rotate_all_equals_the_reference(monkeypatch, kind, rotate_every):
    """rotate_all every 5 reads (most of the 32 PGs empty, the rest under
    DEVICE_MIN_BATCH hashes), 40 (PGs of a few hashes, all under it) and
    700 (some over it): the same
    decisions, sealed dicts, counters and dumps as the reference's per-PG
    loop; every non-empty bloom seal is one seal_bits call, and one from
    DEVICE_MIN_BATCH hashes on reaches the device's seal_host."""
    sizes, staged = [], []
    seal_bits, seal_host = hitset.seal_bits, bloom_kernels.seal_host

    def counted_bits(hashes, *args, **kw):
        sizes.append(len(hashes))
        return seal_bits(hashes, *args, **kw)

    def counted_host(hashes, *args, **kw):
        staged.append(len(hashes))
        return seal_host(hashes, *args, **kw)

    monkeypatch.setattr(hitset, "seal_bits", counted_bits)
    monkeypatch.setattr(bloom_kernels, "seal_host", counted_host)
    trace = zipf_indices(1.1, OIDS, 2800, seed=5)
    port, ref, got, want = _both(
        monkeypatch, {"osd_hit_set_period": 0.0, "osd_hit_set_count": 3,
                      "osd_hit_set_type": kind}, trace,
        rotate_every=rotate_every)
    _assert_same(port, ref, got, want)
    assert [(pg, seq, s.to_dict()) for pg, seq, s in port.pop_sealed()] == \
        [(pg, seq, s.to_dict()) for pg, seq, s in ref.pop_sealed()]
    assert port.counters()["hitset_rotations"] >= len(trace) // rotate_every
    if kind != "bloom":
        assert sizes == staged == []
        return
    assert sizes and all(sizes)
    assert staged == [n for n in sizes if n >= hitset.DEVICE_MIN_BATCH]
    assert bool(staged) == (rotate_every == 700)
