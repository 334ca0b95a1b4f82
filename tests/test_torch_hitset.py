"""The port's hit sets (ceph_tpu_torch.osd.hitset) against the JAX package's
(ceph_tpu.osd.hitset), on the CPU.

Bloom positions are uint32 and held bit for bit: the port's plain torch
version (`positions_for(..., device="cpu")` and `bloom_positions_torch`)
against the JAX function traced with xp=jnp on the CPU and against its
numpy host path, over geometries whose nbits is and is not a power of two,
at batch sizes on both sides of DEVICE_MIN_BATCH.  Sets built by the same
inserts serialize to the same bytes, and cross both ways through
to_dict/from_dict; HitSetStack rotation and decay give the same hit counts,
read frequencies and archived sets.  The seal (`bloom_seal_plain`, the
kernel's plain version, many sets at once or one through `seal_bits`)
gives the bytes the JAX insert_batch sets, on the host or device path.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.osd import hitset as jhs
from ceph_tpu_torch.ops import bloom_kernels
from ceph_tpu_torch.osd import hitset as hs

SEED = 20261020
# (target_size, fpp): nbits 1597 (not a power of two), 9586, 400, 62353
GEOMETRIES = ((256, 0.05), (1024, 0.01), (64, 0.2), (10000, 0.05))
BATCHES = (1, 7, 8, 1000, 65536)


def _hashes(n: int, seed: int = SEED) -> np.ndarray:
    h = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint64)
    h = h.astype(np.uint32)
    h[:3] = (0, 0xFFFFFFFF, 0x80000000)[:n]
    return h


def _oid_hashes(prefix: str, n: int) -> np.ndarray:
    return np.array([hs.hash_oid(f"{prefix}{i}") for i in range(n)],
                    dtype=np.uint32)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("geometry", GEOMETRIES, ids=str)
def test_bloom_positions_equal_jax(geometry, batch):
    nbits, nhash = hs.bloom_geometry(*geometry)
    assert (nbits, nhash) == jhs.bloom_geometry(*geometry)
    h = _hashes(batch)
    want = np.asarray(jhs.bloom_positions(h, nbits, nhash, xp=jnp))
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(
        want, jhs.bloom_positions(h, nbits, nhash, xp=np))
    got = hs.positions_for(h, nbits, nhash, device="cpu")
    assert got.dtype == np.uint32 and got.shape == (batch, nhash)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hs.bloom_positions(h, nbits, nhash), want)
    plain = hs.bloom_positions_torch(torch.from_numpy(h.astype(np.int64)),
                                     nbits, nhash)
    np.testing.assert_array_equal(plain.numpy(), want.astype(np.int64))


def test_positions_for_takes_the_device_from_eight_hashes(monkeypatch):
    """Below DEVICE_MIN_BATCH the host hashes; from it on, the resolved
    device does, and with no device named and no card that raises (never a
    silent host path)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nbits, nhash = hs.bloom_geometry(1024, 0.05)
    small = _hashes(hs.DEVICE_MIN_BATCH - 1)
    np.testing.assert_array_equal(
        hs.positions_for(small, nbits, nhash),
        jhs.bloom_positions(small, nbits, nhash, xp=np))
    with pytest.raises(RuntimeError, match="CUDA"):
        hs.positions_for(_hashes(hs.DEVICE_MIN_BATCH), nbits, nhash)
    assert hs.positions_for([], nbits, nhash).shape == (0, nhash)


@pytest.mark.parametrize("kind", ["bloom", "explicit_hash"])
def test_sets_serialize_to_the_same_bytes(kind):
    members = _oid_hashes("ser_", 700)
    port = hs._KINDS[kind](512, 0.02)
    ref = jhs._KINDS[kind](512, 0.02)
    port.insert_batch(members[:600], device="cpu")
    ref.insert_batch(members[:600], device=False)
    for h in members[600:]:
        port.insert(int(h))
        ref.insert(int(h))
    assert json.dumps(port.to_dict(), sort_keys=True) == \
        json.dumps(ref.to_dict(), sort_keys=True)
    probe = np.concatenate([members, _oid_hashes("other_", 2000)])
    np.testing.assert_array_equal(port.contains_batch(probe, device="cpu"),
                                  ref.contains_batch(probe, device=False))


@pytest.mark.parametrize("kind", ["bloom", "explicit_hash"])
def test_dicts_cross_both_ways(kind):
    members = _oid_hashes("x_", 300)
    ref = jhs._KINDS[kind](256, 0.05)
    ref.insert_batch(members, device=False)
    port = hs.hitset_from_dict(ref.to_dict())
    assert type(port).__name__ == type(ref).__name__
    assert port.to_dict() == ref.to_dict()
    port.insert_batch(_oid_hashes("y_", 50), device="cpu")
    back = jhs.hitset_from_dict(port.to_dict())
    assert back.to_dict() == port.to_dict()
    probe = _oid_hashes("z_", 500)
    np.testing.assert_array_equal(back.contains_batch(probe, device=False),
                                  port.contains_batch(probe, device="cpu"))


def test_single_and_batch_paths_agree():
    port = hs.BloomHitSet(256, 0.05)
    members = _oid_hashes("s_", 32)
    for h in members:
        port.insert(int(h))
    batch = hs.BloomHitSet(256, 0.05, nbits=port.nbits, nhash=port.nhash)
    batch.insert_batch(members, device="cpu")
    np.testing.assert_array_equal(port.bits, batch.bits)
    assert all(port.contains(int(h)) for h in members)


@pytest.mark.parametrize("fpp", [0.05, 0.01])
def test_false_positive_rate_within_budget(fpp):
    port = hs.BloomHitSet(target_size=1024, fpp=fpp)
    members = _oid_hashes("m_", 1024)
    port.insert_batch(members, device="cpu")
    others = _oid_hashes("o_", 20000)
    outside = ~np.isin(others, members)
    got = port.contains_batch(others, device="cpu")
    assert got[outside].mean() <= 2.0 * fpp
    assert port.contains_batch(members, device="cpu").all()
    ref = jhs.BloomHitSet(target_size=1024, fpp=fpp)
    ref.insert_batch(members, device=False)
    np.testing.assert_array_equal(got, ref.contains_batch(others,
                                                          device=False))


@pytest.mark.parametrize("kind", ["bloom", "explicit_hash"])
@pytest.mark.parametrize("count", [1, 3, 4])
def test_stack_rotation_and_decay_sequences_equal(kind, count):
    """The same reads and rotations on both stacks: after every step the
    same hit counts for every oid, the same read frequencies, and the same
    archived sets, byte for byte."""
    rng = np.random.default_rng(SEED + count)
    oids = _oid_hashes("obj_", 400)
    port = hs.HitSetStack(count=count, period=0.0, target_size=64,
                          kind=kind, device="cpu")
    ref = jhs.HitSetStack(count=count, period=0.0, target_size=64,
                          kind=kind)
    for period in range(7):
        for h in oids[rng.integers(0, len(oids), 300)]:
            port.insert(int(h))
            ref.insert(int(h))
        assert sorted(port.read_frequencies()) == \
            sorted(ref.read_frequencies())
        assert [port.hit_count(int(h)) for h in oids] == \
            [ref.hit_count(int(h)) for h in oids]
        sealed_port, sealed_ref = port.rotate(), ref.rotate()
        assert sealed_port.to_dict() == sealed_ref.to_dict()
        assert [s.to_dict() for s in port.archived] == \
            [s.to_dict() for s in ref.archived]
        assert port.seq == ref.seq == period + 1
        assert [port.hit_count(int(h)) for h in oids] == \
            [ref.hit_count(int(h)) for h in oids]
    dump_port, dump_ref = port.dump(), ref.dump()
    dump_port["open"].pop("age")
    dump_ref["open"].pop("age")
    assert dump_port == dump_ref
    assert not port.due() and not ref.due()


def test_cpu_device_stays_on_the_plain_version(monkeypatch):
    """positions_for(device="cpu") hashes with bloom_positions_torch and
    never reaches the kernel's wrapper; the wrapper on a CPU tensor runs
    that plain version and counts no launch."""
    from ceph_tpu_torch.ops import bloom_kernels

    nbits, nhash = hs.bloom_geometry(10000, 0.05)
    h = _hashes(1000)
    want = jhs.bloom_positions(h, nbits, nhash, xp=np)
    before = bloom_kernels.bloom_positions.launches

    def refuse(*args, **kw):
        raise AssertionError("the CPU device reached the kernel's wrapper")

    with monkeypatch.context() as m:
        m.setattr(bloom_kernels, "bloom_positions", refuse)
        np.testing.assert_array_equal(
            hs.positions_for(h, nbits, nhash, device="cpu"), want)
    t = torch.from_numpy(h.view(np.int32))
    got = bloom_kernels.bloom_positions(t, nbits, nhash)
    assert got.dtype == torch.int32 and got.shape == (1000, nhash)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    out = torch.empty((1000, nhash), dtype=torch.int32)
    assert bloom_kernels.bloom_positions(t, nbits, nhash, out=out) is out
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        bloom_kernels.bloom_positions_plain(
            torch.from_numpy(h.astype(np.int64)), nbits, nhash)
        .numpy().view(np.uint32), want)
    assert bloom_kernels.bloom_positions.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "nhash", "nbits"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    """Like the other wrappers, it refuses on any device what the kernel
    does not take: a tensor that is not [B] int32/int64, nhash outside
    [1, 32], nbits outside [1, 2^32 - 1]."""
    from ceph_tpu_torch.ops import bloom_kernels

    t = torch.zeros(16, dtype=torch.int32)
    args = {"shape": (t.view(4, 4), 100, 4),
            "dtype": (t.to(torch.float32), 100, 4),
            "nhash": (t, 100, 33), "nbits": (t, 0, 4)}[bad]
    with pytest.raises(ValueError):
        bloom_kernels.bloom_positions(*args)


def _jax_bits(hashes, nbits: int, nhash: int) -> np.ndarray:
    ref = jhs.BloomHitSet(nbits=nbits, nhash=nhash)
    ref.insert_batch(hashes, device=False)
    return ref.bits


def _wave(seed: int) -> list:
    """Sets as a rotation wave has them: empty, under DEVICE_MIN_BATCH,
    larger, and one of duplicates."""
    sizes = (0, 1, 7, 8, 16, 300, 0, 1000)
    return [_hashes(n, seed + i) for i, n in enumerate(sizes)] + [
        np.repeat(_hashes(4, seed), 9)]


@pytest.mark.parametrize("geometry", GEOMETRIES + ((1024, 0.05),), ids=str)
def test_seal_equals_jax_insert_batch(geometry):
    """bloom_seal_plain (and the wrapper on CPU tensors, which counts no
    launch) and seal_host on the CPU device give each set of a wave the
    bytes the JAX insert_batch sets in an empty set, trailing bits and
    words zero; seal_bits and insert_batch do so set by set."""
    nbits, nhash = hs.bloom_geometry(*geometry)
    sets = _wave(SEED + nbits)
    want = [_jax_bits(h, nbits, nhash) for h in sets]
    offsets = np.cumsum([0] + [h.size for h in sets])
    flat = torch.from_numpy(np.concatenate(sets).astype(np.int64))
    before = bloom_kernels.bloom_seal.launches
    for rows in (bloom_kernels.bloom_seal_plain(
            flat, torch.from_numpy(offsets), nbits, nhash),
            bloom_kernels.bloom_seal(flat.to(torch.int32), torch.from_numpy(
                offsets.astype(np.int32)), nbits, nhash, 1000)):
        assert rows.dtype == torch.int32
        assert tuple(rows.shape) == (len(sets), (nbits + 31) // 32)
        got = rows.numpy().view(np.uint8)
        assert not got[:, len(want[0]):].any()
        for row, w in zip(got, want):
            np.testing.assert_array_equal(row[:len(w)], w)
    assert bloom_kernels.bloom_seal.launches == before
    for row, w in zip(bloom_kernels.seal_host(
            np.concatenate(sets), offsets, nbits, nhash,
            torch.device("cpu")), want):
        np.testing.assert_array_equal(row, w)
    for h, w in zip(sets, want):
        np.testing.assert_array_equal(
            hs.seal_bits(h, nbits, nhash, device="cpu"), w)
    for h in sets:
        p = hs.BloomHitSet(nbits=nbits, nhash=nhash)
        r = jhs.BloomHitSet(nbits=nbits, nhash=nhash)
        for one in (p, r):
            one.insert(7)
        p.insert_batch(h, device="cpu")
        r.insert_batch(h, device=False)
        assert p.to_dict() == r.to_dict()


def test_seal_bits_takes_the_device_from_eight_hashes(monkeypatch):
    """A set of fewer than DEVICE_MIN_BATCH hashes seals on the host; from
    it on, on the resolved device, and with no device named and no card
    that raises (never a silent host path)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nbits, nhash = hs.bloom_geometry(1024, 0.05)
    for h in (_hashes(3, 1), np.zeros(0, np.uint32), _hashes(7, 2)):
        np.testing.assert_array_equal(hs.seal_bits(h, nbits, nhash),
                                      _jax_bits(h, nbits, nhash))
    with pytest.raises(RuntimeError, match="CUDA"):
        hs.seal_bits(_hashes(8, 3), nbits, nhash)
    with pytest.raises(RuntimeError, match="CUDA"):
        hs.BloomHitSet(1024, 0.05).insert_batch(_hashes(8, 4))


@pytest.mark.parametrize("bad", ["offsets shape", "offsets dtype",
                                 "offsets device", "nhash", "nbits"])
def test_seal_wrapper_refuses_what_the_kernel_does_not_take(bad):
    t = torch.zeros(16, dtype=torch.int32)
    offsets = torch.tensor([0, 8, 16], dtype=torch.int32)
    args = {"offsets shape": (t, offsets.view(1, 3), 100, 4, 8),
            "offsets dtype": (t, offsets.to(torch.float32), 100, 4, 8),
            "offsets device": (t, offsets.to("meta"), 100, 4, 8),
            "nhash": (t, offsets, 100, 0, 8),
            "nbits": (t, offsets, 0, 4, 8)}[bad]
    with pytest.raises(ValueError):
        bloom_kernels.bloom_seal(*args)
