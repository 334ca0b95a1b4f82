"""The port's S3 gateway (ceph_tpu_torch.rgw: the put processor, RGWLite)
against the JAX package's, on the CPU.

The JAX gateway tests run on both packages through tests/torch_rgw_helpers
(`run_both`): the test's own assertions hold the port's answers, and every
MemStore (shard objects, xattrs, omap (the gateway's change log, users and
topics), pg logs) must equal the JAX run's.  Mirrored: tests/test_rgw.py (the three
processor units, the atomic PUT and the multipart validation on EC 8+3 over
12 OSDs), the non-slow tests of tests/test_rgw_versioning.py that need no
curl, tests/test_rgw_notifications.py and the first test of
tests/test_rgw_users.py.  In place of tests/test_rgw.py's slow 64 MiB
multipart PUT: four parts of 384 KiB in flight together at a 128 KiB
stripe size on the same EC 8+3 pool (cut for time on the CPU).  Then one
history of PUTs, overwrites, multipart uploads, listings and deletes
through a port gateway on a port cluster and a JAX gateway on a JAX
cluster, with the bucket indexes and the change log read back key for
key.
"""

import asyncio

import numpy as np
import pytest

from torch_cluster_helpers import one_torch_thread  # noqa: F401
from torch_rgw_helpers import run_both, run_workload
from test_torch_osd_units import on_port

import test_rgw as j_rgw
import test_rgw_notifications as j_notifications
import test_rgw_users as j_users
import test_rgw_versioning as j_versioning
import test_s3_http as j_s3_http

EC83 = {"plugin": "ec_jax", "technique": "reed_sol_van", "k": "8",
        "m": "3", "crush-failure-domain": "osd", "tpu": "false"}


# -- tests/test_rgw.py -------------------------------------------------------

@pytest.mark.parametrize("name", [
    "test_processor_stripe_cutting",
    "test_processor_exact_multiple_and_cancel",
    "test_manifest_stitch",
])
def test_processor_units(name):
    on_port(j_rgw, name)()


@pytest.mark.parametrize("name", [
    "test_atomic_put_get_delete_and_errors",
    "test_multipart_validation_and_abort",
])
def test_rgw_cluster(name):
    run_both(j_rgw, name)


def test_small_multipart_put_ec8p3():
    """tests/test_rgw.py's 64 MiB multipart PUT into EC 8+3 at a CPU size:
    four 384 KiB parts in flight together, 128 KiB stripes (three a part,
    each written alone, aio_window 1), a round trip and the listing."""
    payload = np.random.default_rng(42).integers(
        0, 256, 4 * (384 << 10), dtype=np.uint8).tobytes()

    async def workload(cluster, pkg):
        await cluster.client.create_replicated_pool("rgw.meta", size=3,
                                                    pg_num=8)
        await cluster.client.create_ec_pool("rgw.data", EC83, pg_num=8)
        rgw = pkg("gateway").RGWLite(cluster.client, "rgw.data",
                                     "rgw.meta", stripe_size=128 << 10,
                                     aio_window=1)
        await rgw.create_bucket("b")
        upload = await rgw.init_multipart("b", "big")
        psize = 384 << 10
        # the parts in flight together, each its own write id: the
        # gateway mints ids in request order, so start them in order
        tasks = []
        for num in range(1, 5):
            tasks.append(asyncio.ensure_future(rgw.upload_part(
                "b", "big", upload, num,
                payload[(num - 1) * psize:num * psize])))
            await asyncio.sleep(0)
        etags = await asyncio.gather(*tasks)
        combined = await rgw.complete_multipart(
            "b", "big", upload, list(zip(range(1, 5), etags)))
        got = await rgw.get_object("b", "big")
        listing = await rgw.list_objects("b")
        return [etags, combined, got == payload,
                [(e["key"], e["size"], e["etag"]) for e in listing]]

    # the parts' stripes interleave at the OSDs' pace, so each part runs
    # alone here: the stores' versions follow one order in both runs
    out = run_workload(_one_part_at_a_time(workload),
                       dict(num_osds=12, osds_per_host=3))
    assert out["torch"][1].endswith("-4") and out["torch"][2]


def _one_part_at_a_time(workload):
    """The workload with the gateway's part uploads serialized (one lock
    around `upload_part`): every stripe write, and every upload-doc
    update, in part order in both runs."""
    async def run(cluster, pkg):
        gw = pkg("gateway").RGWLite
        lock = asyncio.Lock()
        upload_part = gw.upload_part

        async def serialized(self, *a, **kw):
            async with lock:
                return await upload_part(self, *a, **kw)
        gw.upload_part = serialized
        try:
            return await workload(cluster, pkg)
        finally:
            gw.upload_part = upload_part
    return run


# -- tests/test_rgw_versioning.py, _notifications.py, _users.py ------------

@pytest.mark.parametrize("name", [
    "test_versioned_put_get_delete_cycle",
    "test_suspended_versioning_null_replacement",
    "test_gc_defers_and_drains",
    "test_lifecycle_sweep",
    "test_list_objects_v2_semantics",
    "test_http_versioning_and_v2_listing",
    "test_multipart_complete_respects_versioning",
    "test_version_id_on_unversioned_bucket",
    "test_gc_two_phase_pending_protects_referenced_data",
    "test_list_v2_max_keys_zero",
])
def test_rgw_versioning(name):
    run_both(j_versioning, name, modules=(j_s3_http,))


@pytest.mark.parametrize("name", [
    "test_events_created_removed_and_ack",
    "test_filters_versioning_and_multipart",
])
def test_rgw_notifications(name):
    run_both(j_notifications, name)


def test_durable_user_lifecycle_through_frontend():
    run_both(j_users, "test_durable_user_lifecycle_through_frontend",
             modules=(j_s3_http,))


# -- one history through both gateways --------------------------------------

def test_gateway_history_matches_the_jax_gateway():
    """PUTs (one past a stripe), an overwrite, two multipart uploads (one
    completed, one aborted), a versioned bucket, listings and deletes,
    through a port gateway on port OSDs and a JAX gateway on JAX OSDs
    sharing one fake clock: equal answers, equal stores, and the bucket
    indexes (a JSON doc each in the meta pool) and the change log (the
    meta pool's omap) equal key for key."""
    rng = np.random.default_rng(17)
    blobs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in (1000, 200_000, 70_000, 150_000, 90_000)]

    async def workload(cluster, pkg):
        gw = pkg("gateway")
        await cluster.client.create_replicated_pool("rgw.meta", size=2,
                                                    pg_num=4)
        await cluster.client.create_ec_pool(
            "rgw.data", {**EC83, "k": "2", "m": "1"}, pg_num=4)
        rgw = gw.RGWLite(cluster.client, "rgw.data", "rgw.meta",
                         stripe_size=64 << 10, aio_window=1)
        out = []
        for b in ("b", "v"):
            await rgw.create_bucket(b)
        await rgw.put_bucket_versioning("v", "enabled")
        out.append(await rgw.put_object("b", "small", blobs[0]))
        out.append(await rgw.put_object("b", "big", blobs[1]))
        out.append(await rgw.put_object("b", "big", blobs[2]))
        up = await rgw.init_multipart("b", "mp")
        parts = [(n, await rgw.upload_part("b", "mp", up, n, blobs[2 + n]))
                 for n in (1, 2)]
        out.append(await rgw.complete_multipart("b", "mp", up, parts))
        gone = await rgw.init_multipart("b", "gone")
        await rgw.upload_part("b", "gone", gone, 1, blobs[0])
        await rgw.abort_multipart("b", "gone", gone)
        out.append(await rgw.put_object_ex("v", "k", blobs[0]))
        out.append(await rgw.put_object_ex("v", "k", blobs[2]))
        out.append(await rgw.delete_object("v", "k"))
        out.append([await rgw.get_object("b", k) for k in ("small", "big",
                                                           "mp")])
        await rgw.delete_object("b", "small")
        out.append(await rgw.list_objects("b"))
        out.append(await rgw.list_object_versions("v"))
        out.append(await rgw.gc_process())
        # the bucket indexes (a JSON doc each in the meta pool) and the
        # meta pool's omap: the change log's shards, one key a mutation
        for b in ("b", "v"):
            out.append(await rgw._load(rgw._bucket_oid(b)))
        log = {}
        for shard in range(rgw.LOG_SHARDS):
            try:
                log[shard] = await rgw.meta.omap_get(
                    rgw._synclog_oid(shard))
            except Exception:   # ObjectNotFound: a shard never written
                continue
        out.append(log)
        return out

    out = run_workload(workload)["torch"]
    assert out[7] == [blobs[0], blobs[2], blobs[3] + blobs[4]]
    assert [e["key"] for e in out[8]] == ["big", "mp"]
    assert sorted(out[-3]["objects"]) == ["big", "mp"]
    assert sum(len(v) for v in out[-1].values()) >= 10
