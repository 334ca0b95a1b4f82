"""The port's hit sets (ceph_tpu_torch.osd.hitset) against the JAX package's
(ceph_tpu.osd.hitset), on the CPU.

Bloom positions are uint32 and held bit for bit: the port's plain torch
version (`positions_for(..., device="cpu")` and `bloom_positions_torch`)
against the JAX function traced with xp=jnp on the CPU and against its
numpy host path, over geometries whose nbits is and is not a power of two,
at batch sizes on both sides of DEVICE_MIN_BATCH.  Sets built by the same
inserts serialize to the same bytes, and cross both ways through
to_dict/from_dict; HitSetStack rotation and decay give the same hit counts,
read frequencies and archived sets.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.osd import hitset as jhs
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
