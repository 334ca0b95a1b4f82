"""The units under the port's OSD (pg log, op scheduler, admission gate,
hedged gather, tracing and the critical-path reducer, encode service,
group commit) held to the JAX package's own unit tests.

Each case runs the body of a JAX unit test (tests/test_cluster.py,
test_scheduler.py, test_qos.py, test_hedge.py, test_tracing.py,
test_encode_service.py, test_group_commit.py) with every name it takes
from `ceph_tpu` bound to the port's object of the same name instead, so
the port's classes must pass the reference's assertions.  The tests of
those files that need a cluster, a device codec or TPUStore's merged
commit path are held elsewhere (tests/test_torch_osd.py) or wait for
their slice (ROADMAP A4b, A5).  Then the port's own: the same span trees
give the same critical path in both packages, and the batched encode body
gives every object of a batch (objects of different sizes in one call)
the shards, hinfo and data crc the JAX package's encode_with_hinfo gives.
"""

import asyncio
import contextvars
import importlib
import random
import sys
import types

import numpy as np
import pytest

from ceph_tpu.common import tracing as jtracing
from ceph_tpu.ec.registry import create_erasure_code as jcreate
from ceph_tpu.osd import ec_util as jec_util
from ceph_tpu_torch.common import tracing as ttracing
from ceph_tpu_torch.ec.registry import create_erasure_code as tcreate
from ceph_tpu_torch.osd import ec_util as tec_util
from ceph_tpu_torch.osd.encode_service import EncodeService

from torch_cluster_helpers import one_torch_thread  # noqa: F401

import test_cluster as j_cluster
import test_encode_service as j_encode_service
import test_group_commit as j_group_commit
import test_hedge as j_hedge
import test_qos as j_qos
import test_scheduler as j_scheduler
import test_tracing as j_tracing


def _jax_home(name: str, value):
    """The ceph_tpu module that holds `value` under `name` (for objects
    with no module of their own: NULL_SPAN, a ContextVar), or None."""
    for modname, mod in list(sys.modules.items()):
        if (modname == "ceph_tpu" or modname.startswith("ceph_tpu.")) \
                and getattr(mod, name, None) is value:
            return modname
    return None


def _port_module(mod: str):
    """ceph_tpu.X -> ceph_tpu_torch.X, or None when the port has no X
    (yet): the bodies run here never reach those names."""
    try:
        return importlib.import_module("ceph_tpu_torch"
                                       + mod[len("ceph_tpu"):])
    except ModuleNotFoundError:
        return None


def _port_of(name: str, value):
    """The port's object of the same name as a ceph_tpu module, class,
    function or module-level instance; anything else unchanged."""
    if isinstance(value, types.ModuleType):
        mod = value.__name__
        if mod == "ceph_tpu" or mod.startswith("ceph_tpu."):
            return _port_module(mod) or value
        return value
    if isinstance(value, (type, types.FunctionType)):
        mod, attr = getattr(value, "__module__", "") or "", value.__name__
    elif isinstance(value, (int, float, str, bytes, tuple, dict, list,
                            type(None))):
        return value
    elif isinstance(value, contextvars.ContextVar) or \
            type(value).__module__.startswith("ceph_tpu."):
        # a module-level instance (NULL_SPAN, current_span)
        mod, attr = _jax_home(name, value) or "", name
    else:
        return value
    if mod == "ceph_tpu" or mod.startswith("ceph_tpu."):
        port = _port_module(mod)
        return value if port is None else getattr(port, attr)
    return value


def on_port(module, name: str, **overrides):
    """`module.name` (a JAX unit test) with its module's globals, and the
    module's own helper functions, bound to the port's objects (and to
    `overrides`, for helpers that name a JAX plugin)."""
    g = {k: _port_of(k, v) for k, v in vars(module).items()}
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) and \
                v.__module__ == module.__name__:
            g[k] = types.FunctionType(v.__code__, g, v.__name__,
                                      v.__defaults__, v.__closure__)
    g.update(overrides)
    return g[name]


def call(fn, **fixtures):
    """Call a test body with the fixtures its signature names."""
    code = fn.__code__
    return fn(*[fixtures[a] for a in code.co_varnames[:code.co_argcount]])


# -- tests/test_cluster.py: the pg log ------------------------------------

@pytest.mark.parametrize("name", [
    "test_pg_log_append_trim",
    "test_pg_log_merge_catches_up_missing",
    "test_pg_log_merge_rewinds_divergent",
    "test_pg_log_merge_fully_divergent_peer",
])
def test_pg_log(name):
    on_port(j_cluster, name)()


# -- tests/test_scheduler.py, tests/test_qos.py: the op queue, admission --

@pytest.mark.parametrize("name", [
    "test_factory",
    "test_wpq_respects_weights",
    "test_run_after_stop_fails_fast",
    "test_mclock_reservation_under_flood",
    "test_mclock_limit_caps_class",
])
def test_scheduler(name):
    on_port(j_scheduler, name)()


@pytest.mark.parametrize("name", [
    "test_stats_exposes_depth_and_grants",
    "test_bounded_queue_sheds_with_queue_full",
    "test_bounded_queue_block_policy_backpressures",
    "test_limit_pinned_class_never_starves_reservation",
    "test_cancelled_before_grant_returns_cost",
    "test_idle_tenant_burst_does_not_replay_idle_tags",
    "test_wpq_uncharge_on_cancelled_grant",
    "test_tenant_profile_resolution",
    "test_make_scheduler_filters_mclock_kwargs_for_wpq",
    "test_tenant_limit_paces_grants",
    "test_admission_fast_path_is_sync_with_cached_limit",
    "test_admission_burst_then_shed",
    "test_admission_delay_smooths_small_overruns",
    "test_admission_unlimited_and_disabled_paths",
    "test_tenant_isolation_under_flood",
    "test_mosdop_v4_tenant_round_trip_and_v3_compat",
])
def test_qos(name):
    on_port(j_qos, name)()


# -- tests/test_hedge.py: latency model and the hedged gather -------------

@pytest.mark.parametrize("name", [
    "test_ewma_learns_and_decays_toward_prior",
    "test_failures_trip_breaker_and_rank_last",
    "test_censored_cancel_never_teaches_fast",
    "test_spread_escalates_delta",
    "test_gather_first_k_completes_and_cancels_stragglers",
    "test_gather_failed_result_recruits_spare",
    "test_gather_widens_on_insufficient_non_failed_results",
    "test_gather_runs_all_when_insufficient",
    "test_gather_all_shard_modes",
    "test_gather_propagates_caller_cancellation",
    "test_fastest_survivors_data_first_then_rank",
    "test_fastest_survivors_widens_and_raises",
    "test_cancelled_send_does_not_corrupt_framing",
])
def test_hedge(name):
    on_port(j_hedge, name)()


# -- tests/test_tracing.py: spans, the tracer, the critical path ----------

@pytest.mark.parametrize("name", [
    "test_tracer_unit",
    "test_contextvar_isolation",
    "test_critical_path_hedged_children",
    "test_critical_path_nested_and_sequential",
    "test_critical_path_spans_fast_lane_matches_dicts",
    "test_child_span_helpers_and_null_discipline",
])
def test_tracing(name):
    on_port(j_tracing, name)()


@pytest.mark.parametrize("name", [
    "test_span_clocks_survive_wall_clock_step",
    "test_kill_switch_and_sampling",
])
def test_tracing_patched(name, monkeypatch):
    on_port(j_tracing, name)(monkeypatch)


def _random_tree(rng: random.Random, n: int):
    spans = [{"span_id": "r", "parent_id": "", "name": "osd_op x",
              "t0_us": 0, "duration_us": 10_000, "attrs": {}}]
    for i in range(n):
        parent = rng.choice(spans)
        t0 = parent["t0_us"] + rng.randrange(0, parent["duration_us"] + 1)
        end = rng.randrange(t0, parent["t0_us"] + parent["duration_us"] + 1)
        attrs = {"cancelled": True} if rng.random() < 0.1 else {}
        spans.append({"span_id": f"s{i}", "parent_id": parent["span_id"],
                      "name": rng.choice(["subread osd.1", "encode_wait",
                                          "objlock", "subwrite osd.2"]),
                      "t0_us": t0, "duration_us": end - t0,
                      "attrs": attrs})
    rng.shuffle(spans)
    return spans


@pytest.mark.parametrize("seed", range(8))
def test_same_span_trees_give_the_same_critical_path(seed):
    rng = random.Random(seed)
    for _ in range(20):
        tree = _random_tree(rng, rng.randrange(1, 40))
        want = jtracing.critical_path(tree)
        got = ttracing.critical_path(tree)
        assert got == want
        assert sum(got["stages"].values()) == got["total_us"]


# -- tests/test_encode_service.py -----------------------------------------

def _port_codec(k=4, m=2, **extra):
    """test_encode_service._codec's RS profile on the port's CPU codec."""
    return tcreate({"plugin": "ec_torch", "technique": "reed_sol_van",
                    "k": str(k), "m": str(m), "device": "cpu"})


@pytest.mark.parametrize("name", [
    "test_decode_many_isolates_per_request_failures",
    "test_backpressure_sheds_inline_without_deadlock",
    "test_stop_with_requests_in_flight_resolves_everything",
    "test_kill_switch_restores_inline_behavior",
    "test_no_device_tier_stays_inline",
    "test_encode_many_and_decode_many_host_fallback",
])
def test_encode_service(name, monkeypatch):
    # the file's `fused` fixture: the batched tier off the card
    monkeypatch.setenv("CEPH_TPU_FUSE_MIN_BYTES", "0")
    call(on_port(j_encode_service, name, _codec=_port_codec),
         fused=None, monkeypatch=monkeypatch)


def test_group_commit_memstore_stays_inline():
    """tests/test_group_commit.py's MemStore case (the file's others need
    FaultStore and TPUStore's merged commit, ROADMAP A5)."""
    call(on_port(j_group_commit, "test_committer_memstore_stays_inline"))


# -- the batched encode body against the JAX package ----------------------

def _profiles(k, m):
    base = {"technique": "reed_sol_van", "k": str(k), "m": str(m)}
    return ({**base, "plugin": "ec_jax", "tpu": "false"},
            {**base, "plugin": "ec_torch", "device": "cpu"})


@pytest.mark.parametrize("k, m, unit", [(2, 1, 4096), (4, 2, 4096),
                                        (8, 3, 65536)])
def test_encode_many_with_hinfo_matches_jax_per_item(k, m, unit,
                                                     monkeypatch):
    monkeypatch.setenv("CEPH_TPU_FUSE_MIN_BYTES", "0")
    jprof, tprof = _profiles(k, m)
    jc, tc = jcreate(jprof), tcreate(tprof)
    width = k * unit
    jsinfo = jec_util.StripeInfo(k, width)
    tsinfo = tec_util.StripeInfo(k, width)
    assert tec_util.device_fused_available(tc)
    rng = np.random.default_rng(k * 100 + m)
    # objects of different sizes, one batch
    sizes = [width, 3 * width, width * 2, 5 * width, width]
    datas = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in sizes]
    n = k + m
    items = [(d, range(n), len(d) - (7 * i)) for i, d in enumerate(datas)]
    got = tec_util.encode_many_with_hinfo(tsinfo, tc, items)
    for (d, _w, ll), (shards, hinfo, crc) in zip(items, got):
        jshards, jhinfo, jcrc = jec_util.encode_with_hinfo(
            jsinfo, jc, d, range(n), logical_len=ll)
        assert {i: bytes(v) for i, v in shards.items()} == \
            {i: bytes(v) for i, v in jshards.items()}
        assert hinfo.to_dict() == jhinfo.to_dict()
        assert crc == jcrc
        inline = tec_util.encode_with_hinfo(tsinfo, tc, d, range(n),
                                            logical_len=ll)
        assert inline[1].to_dict() == hinfo.to_dict()


def test_encode_service_batches_a_burst_on_the_cpu_codec(monkeypatch):
    """The skill's router drive on the port: sequential requests each
    dispatch alone (an idle bucket flushes at once), a 24-way burst pools
    into shared batches, every result bit-equal to inline."""
    monkeypatch.setenv("CEPH_TPU_FUSE_MIN_BYTES", "0")
    _jp, tprof = _profiles(4, 2)
    codec = tcreate(tprof)
    sinfo = tec_util.StripeInfo(4, 4 * 4096)
    rng = np.random.default_rng(5)
    datas = [rng.integers(0, 256, 4 * 4096 * (1 + i % 3),
                          dtype=np.uint8).tobytes() for i in range(24)]

    async def main():
        svc = EncodeService(window_ms=5)
        for d in datas[:3]:
            await svc.encode_with_hinfo(sinfo, codec, d, range(6))
            await asyncio.sleep(0.02)
        assert svc.counters["batches"] == 3
        outs = await asyncio.gather(*(
            svc.encode_with_hinfo(sinfo, codec, d, range(6),
                                  logical_len=len(d)) for d in datas))
        assert svc.counters["batched"] == 27
        assert svc.counters["batches"] < 3 + 24
        await svc.stop()
        return outs

    outs = asyncio.run(main())
    for d, (shards, hinfo, crc) in zip(datas, outs):
        ishards, ihinfo, icrc = tec_util.encode_with_hinfo(
            sinfo, codec, d, range(6), logical_len=len(d))
        assert {i: bytes(v) for i, v in shards.items()} == \
            {i: bytes(v) for i, v in ishards.items()}
        assert hinfo.to_dict() == ihinfo.to_dict() and crc == icrc
