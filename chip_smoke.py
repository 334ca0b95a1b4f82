#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ceph_tpu_torch) on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py

Phases; any failure exits nonzero and prints no result line:

1. Build the CUDA kernels from ceph_tpu_torch/csrc (GF, crc and the CRUSH
   placement kernel, one nvcc per source, started together) and print the
   seconds it took and what ptxas reports (registers per source, spills).
2. Hold every kernel against its plain PyTorch version on the card at the
   main path's shapes, bit-exact: the specialised GF kernel on RS 8+3
   (reed_sol_van) over 64 stripes of 8 x 512 KiB, and also on RS 10+4 over
   64 stripes of 10 x 512 KiB (two input groups), RS 8+3 over 16384
   stripes of 2052 bytes (single words), a random 16 x 64 matrix (the
   kernel's limits), RS 8+3 at 4096 and 12304 bytes (the column tail of
   the 16-byte path) and RS 8+3 with a zero row and a zero column; the
   generic GF kernel on every single-erasure decode matrix of that code and one 3-erasure
   matrix; the crc kernel on 704 blocks of 512 KiB (seeds 0 and
   0xFFFFFFFF), 90112 of 4 KiB and 4096 of 2052 bytes (a length that is
   no multiple of 128 or 16).
3. Drive the main path through the entry points a user calls: a codec
   from create_erasure_code, ec_util.encode_with_hinfo over a 256 MiB
   object (64 stripes of 4 MiB, 512 KiB chunks), ec_util.decode with each
   data shard missing in turn, and decode_batch for all 11 single
   erasures.  Parity and recovered chunks are checked against the numpy
   oracle on sampled stripes, recovered objects against the original
   bytes, the hinfo ledgers against the host crc32c on sampled shards and
   the crc plain version on all of them, and the launch counters (zeroed
   just before this phase) show that every kernel ran.
3b. CRUSH placement (BASELINE config 4): the 10,000-OSD map
   build_flat_cluster(10000, 20, 10) with the replicated rule (chooseleaf
   firstn over hosts, 3 replicas) and the EC rule (set_chooseleaf_tries 5,
   chooseleaf indep over hosts, 11 slots), each with all OSDs in and with
   a rebalance weight vector (5% out, 10% at half weight).  The placement
   kernel is held bit for bit against its plain version on all 2^20
   inputs (and timed there, with its straw2 lane utilization, see phase
   4), on odd input counts (1, 31, 33, 2^20 + 17; rebalance vector), on
   the same map with a seeded weight per OSD (many distinct reciprocals;
   2^18 inputs), and also on a 64-OSD map with a CHOOSE_FIRSTN osd rule,
   on a map with an empty host bucket and on 24 seeded random
   hierarchies of 2-4 levels with random rules and weights (firstn and
   indep, leaf and not, stable 0 and 1, vary_r 0-3, descend_once 0 and
   1, numrep other than result_max); and against the host mapper on 256
   sampled inputs per rule and weight vector of the big map, x = 0 and
   2^20 - 1 among them, and on 64 inputs of each other case.  Then the
   entry point a user calls: crushtool.run --test
   --num-rep 3 --show-statistics --show-utilization over x = 0 .. 2^20 - 1
   on the map written to a JSON file, its printed counts checked against
   the placements (3 distinct OSDs per input), the kernel's launch
   counter zeroed just before it.
3c. Live PG placement: the 10,000-OSD map in an OSDMap with a replicated
   size-3 pool of 2^18 PGs (rule 0) and an EC 8+3 pool of 2^14 PGs (rule
   1), all OSDs in and again with a seeded 5% out and 2% down.  On each map
   OSDMapMapping(m) and osdmaptool.run([map file, "--test-map-pgs"]), each
   with the placement kernel's launch counter zeroed just before it; 1024
   seeded PGs per pool against the host path m.pg_to_up_acting_osds, the
   tool's pg count and min/max/avg lines against the mapping's; each
   pool's launch again, held against the plain version and timed beside
   its operations bound; the update's seconds split into flattening the
   map, the pps, the kernel and the per-PG host work.
3d. The embedded cluster (BASELINE config 5's object): LocalCluster(24
   OSDs, 12 hosts) on the card with an EC pool plugin=jerasure
   reed_sol_van k=8 m=3 over hosts; 4 seeded objects of 64 MiB, each
   written (write_full), read healthy, read with one data shard's OSD down
   and with three down (then marked up again), every read exact; deep
   scrub clean, a flipped byte in one shard's MemStore reported, the read
   still exact, repair rewriting that shard, scrub clean again; one
   object's shards and hinfo/object-info xattrs equal to the same write on
   a LocalCluster(device="cpu"); the GF kernels' launch counters (zeroed
   just before the writes) above zero; object GiB/s per operation (host
   clock, median of the 4 objects) and where a write and a degraded read
   spend their time (encode, host crc, shard gather and verify, decode).
4. Time each kernel with CUDA events (median of 20 after warm-up) beside
   its plain version and its bound, the crc kernel also at the two
   launches the main path makes (512 data and 192 parity blocks of
   512 KiB) and at 90112 blocks of 4 KiB, the generic GF kernel also on
   the RS 8+3 generator (the specialised kernel's yardstick), and the
   end-to-end encode, decode and fused encode+crc in GiB/s of object data
   (host clock, median of 3); for CRUSH, the kernel per rule and weight
   vector (timed alone and back to back in phase 3b) beside its
   operations bound, its share of it, its straw2 lane utilization and
   the plain version's time, compile_rule(...)(xs)
   on 2^20 inputs in placements/s (host clock, median of 3) and the
   crushtool.run call; the GF kernels at the cluster path's shapes
   ((1, 8, 8 MiB) encode, (2048, 8, 4096) decode of 1 and 3 rows), each
   against its plain version, and the placement kernel at phase 3c's.
   Every kernels-line row carries its launches per path (codec, crushtool,
   osdmap, cluster) and their sum.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.  The card's name and power limit, as
nvidia-smi reports them, are printed on an earlier line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

K, M = 8, 3
CHUNK = 512 << 10
B = 64                      # stripes of the 256 MiB object
STRIPE = K * CHUNK          # 4 MiB
SEED = 20261016
RANDOM_CRUSH_MAPS = 24      # seeded random hierarchies of phase 3b
ODD_COUNTS = (1, 31, 33, (1 << 20) + 17)   # CRUSH inputs of phase 3b
EC_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
              "k": str(K), "m": str(M), "crush-failure-domain": "host"}
# phase 3c: a replicated size-3 pool and an EC 8+3 pool on the 10,000-OSD
# map, 3 * 2^18 + 11 * 2^14 = 966,656 PG shards, about 97 per OSD (Pacific's
# mon_target_pg_per_osd is 100); a seeded sample of each pool's PGs is held
# against the host path
OSDMAP_REP_PGS = 1 << 18
OSDMAP_EC_PGS = 1 << 14
OSDMAP_SAMPLES = 1024
OUT_SHARE, DOWN_SHARE = 0.05, 0.02
# phase 3d: BASELINE config 5's object, 64 MiB into EC 8+3 over hosts, on
# 24 OSDs in 12 hosts
CLUSTER_OSDS, CLUSTER_OSDS_PER_HOST = 24, 2
CLUSTER_OBJECTS, CLUSTER_OBJECT = 4, 64 << 20

# H100 SXM published peaks: HBM3 at 3.35 TB/s, and 67 TFLOP/s of FP32
# outside the tensor cores, i.e. 33.5 T lane-instructions per second (128
# lanes per SM per clock, 2 flops each).  No integer or logic instruction
# issues faster than that lane rate, so it bounds the kernels' arithmetic.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2
# Instructions per 32-bit word that the kernels' arithmetic needs at
# least, counting a 3-input LOP3 once:
XTIME_OPS = 5               # shr, and, shl, imad (hi * 0x1d), lop3 (and ^)
GEN_OPS_PER_BIT = 1         # lop3: acc ^= power & mask
CRC_OPS_PER_WORD = 7        # xor, 4 byte extracts, 2 lop3 for 3 xors


def spec_ops_per_word(gf_kernels, matrix) -> int:
    """The spec kernel's Horner schedule per column word: xtime steps
    below each (group, row)'s top bit, one XOR per set coefficient bit,
    and one XOR of each (group, row) result into its accumulator."""
    masks, tops = gf_kernels.spec_schedule(matrix)
    set_bits = int(np.unpackbits(masks).sum())
    return (XTIME_OPS * int(np.maximum(tops, 0).sum()) + set_bits
            + int((tops >= 0).sum()))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def host_median_s(torch, fn, reps: int = 3) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bound(n_bytes: float, ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def varied_weight_map(rng):
    """build_flat_cluster(10000, 20, 10) with both rules of the big map and
    a seeded weight per OSD, from 1 (1/65536) to 0x40000, so that hosts and
    racks carry distinct sums."""
    from ceph_tpu_torch.tools import kernel_shapes as ks
    cmap = ks.crush_map_10k()
    small = rng.integers(1, 0x100, cmap.max_devices)
    wide = rng.integers(0x100, 0x40001, cmap.max_devices)
    per_osd = np.where(rng.random(cmap.max_devices) < 0.05, small, wide)
    ks.reweight_devices(cmap, lambda dev: int(per_osd[dev]))
    return cmap


def crush_phase(torch, dev, card: str) -> dict:
    """Phase 3b: the CRUSH placement kernel against its plain version and
    the host mapper, then crushtool.run over 2^20 inputs.  Returns what
    phase 4 needs."""
    import contextlib
    import io
    import os
    import tempfile

    from ceph_tpu_torch.crush import kernel as ck
    from ceph_tpu_torch.crush.map import (CRUSH_ITEM_NONE, build_flat_cluster)
    from ceph_tpu_torch.crush.mapper import crush_do_rule
    from ceph_tpu_torch.crush.serialize import to_json
    from ceph_tpu_torch.ops import crush_kernels
    from ceph_tpu_torch.tools import crushtool
    from ceph_tpu_torch.tools import kernel_shapes as ks

    n = ks.CRUSH_INPUTS
    rng = np.random.default_rng(SEED)
    samples = np.concatenate([[0, n - 1], rng.choice(np.arange(1, n - 1),
                                                     254, replace=False)])

    def vs_host(cmap, ruleno, rmax, weight, got_rows, xs_host) -> int:
        bad = 0
        for x, row in zip(xs_host, got_rows):
            want = crush_do_rule(cmap, ruleno, int(x), rmax, weight)
            want = want + [CRUSH_ITEM_NONE] * (rmax - len(want))
            bad += list(row) != want
        return bad

    # the 10,000-OSD map: kernel_shapes holds every rule and weight vector
    # against the plain version on all 2^20 inputs, and times it (phase 4
    # prints the times); the plain version takes 1-5 s here (H100)
    shapes = ks.crush_shapes(dev)
    cases, worst, max_err = [], 0, 0
    for sh in shapes:
        host_bad = vs_host(sh.cmap, sh.ruleno, sh.row["result_max"],
                           sh.weight,
                           sh.got[torch.from_numpy(samples).to(dev)]
                           .cpu().numpy(), samples)
        worst = max(worst, sh.row["mismatches_vs_plain"], host_bad)
        max_err = max(max_err, sh.row["max_abs_err"])
        cases.append({"rule": sh.row["rule"], "weights": sh.row["weights"],
                      "plain_inputs": n,
                      "mismatches_vs_plain": sh.row["mismatches_vs_plain"],
                      "max_abs_err": sh.row["max_abs_err"],
                      "host_samples": len(samples),
                      "mismatches_vs_host": host_bad,
                      "plain_s": sh.row["plain_ms"] / 1e3,
                      "draws_per_input": sh.row["draws_per_input"],
                      "is_out_hashes_per_input":
                          sh.row["is_out_hashes_per_input"]})
    big = shapes[0].cmap

    # odd input counts (a lane left over in the last warp, a grid smaller
    # than the card) on the big map, and a map whose item weights differ per
    # item, so that many distinct reciprocals run
    odd = {"rebalance": ks.crush_weights(big)["rebalance"]}
    varied = varied_weight_map(np.random.default_rng(SEED + 1))
    for name, cmap, counts, weights in (
            ("10k osds, odd counts", big, ODD_COUNTS, odd),
            ("10k osds, per-item weights", varied, (1 << 18,),
             ks.crush_weights(varied))):
        for rname, ruleno, rmax in ks.CRUSH_RULES:
            prog = ck.rule_program(cmap, ruleno, rmax)
            for wname, weight in weights.items():
                dm = ck.DenseMap.from_crush_map(cmap, weight, dev)
                for count in counts:
                    xs_in = torch.arange(count, dtype=torch.int32, device=dev)
                    got = crush_kernels.crush_do_rule_batch(dm, prog, xs_in)
                    want = ck.crush_do_rule_batch_plain(dm, prog, xs_in)
                    mism = int((got != want).any(1).sum())
                    max_err = max(max_err, int((got.long() - want.long())
                                               .abs().max()))
                    tail = xs_in[-64:]
                    host_bad = vs_host(cmap, ruleno, rmax, weight,
                                       got[-64:].cpu().numpy(),
                                       tail.cpu().numpy())
                    worst = max(worst, mism, host_bad)
                    cases.append({
                        "map": name, "rule": rname, "weights": wname,
                        "distinct_recips": int(dm.recips.unique().numel()),
                        "plain_inputs": count, "mismatches_vs_plain": mism,
                        "host_samples": tail.numel(),
                        "mismatches_vs_host": host_bad})

    # small maps: 64 OSDs with CHOOSE_FIRSTN osd, an empty host bucket, and
    # seeded random hierarchies with random tunables, so that every branch
    # of the kernel runs (stable 0, vary_r 0 and > 1, descend_once 0,
    # indep to devices, numrep other than result_max)
    small = build_flat_cluster(64, osds_per_host=4)
    small.add_simple_rule("flat", "default", "osd", mode="firstn")
    holed = build_flat_cluster(64, osds_per_host=4)
    empty = holed.add_bucket(None, holed.type_id("host"), "empty")
    holed.buckets[-1].add_item(empty.id, 0x40000)
    holed.add_simple_rule("data", "default", "host", mode="firstn")
    small_x = torch.arange(1 << 16, dtype=torch.int32, device=dev)
    maps = [("64 osds, choose firstn osd", small, 3, small_x,
             ks.crush_weights(small)),
            ("empty host bucket", holed, 3, small_x,
             ks.crush_weights(holed))]
    for seed in range(RANDOM_CRUSH_MAPS):
        # firstn and indep, leaf and not, in turns; the chooseleaf tunables
        # in turns too (they act on chooseleaf firstn)
        k = seed // 4
        rmax = 1 + (5 * seed) % 12
        cmap, weight, _ = ks.random_crush_case(
            SEED + seed, levels=2 + k % 3, firstn=seed % 2 == 0,
            leaf=seed % 4 < 2, result_max=rmax)
        cmap.chooseleaf_stable = k % 2
        cmap.chooseleaf_vary_r = k % 4
        cmap.chooseleaf_descend_once = k // 2 % 2
        rand_x = torch.from_numpy(rng.integers(0, 2**31, 1 << 14)
                                  .astype(np.int32)).to(dev)
        maps.append((f"random {seed}", cmap, rmax, rand_x,
                     {"random": weight}))
    for name, cmap, rmax, xs_in, weights in maps:
        prog = ck.rule_program(cmap, 0, rmax)
        for wname, weight in weights.items():
            dm = ck.DenseMap.from_crush_map(cmap, weight, dev)
            got = crush_kernels.crush_do_rule_batch(dm, prog, xs_in)
            want = ck.crush_do_rule_batch_plain(dm, prog, xs_in)
            mism = int((got != want).any(1).sum())
            max_err = max(max_err, int((got.long() - want.long()).abs()
                                       .max()))
            host_bad = vs_host(cmap, 0, rmax, weight, got[:64].cpu().numpy(),
                               xs_in[:64].cpu().numpy())
            worst = max(worst, mism, host_bad)
            cases.append({"map": name, "weights": wname,
                          "program": prog._asdict(),
                          "plain_inputs": xs_in.numel(),
                          "mismatches_vs_plain": mism, "host_samples": 64,
                          "mismatches_vs_host": host_bad})
    print(json.dumps({"phase": "crush_vs_plain_and_host", "cases": cases}))
    check(worst == max_err == 0, "the placement kernel disagrees with its"
          " plain version or the host mapper")

    # the entry point a user calls
    fd, path = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(to_json(big), f)
    try:
        argv = ["-i", path, "--test", "--rule", "0", "--num-rep", "3",
                "--min-x", "0", "--max-x", str(n - 1), "--show-statistics",
                "--show-utilization"]
        out, err_out = io.StringIO(), io.StringIO()
        crush_kernels.crush_do_rule_batch.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err_out):
            rc = crushtool.run(argv)
        tool_s = time.perf_counter() - t0
        launches = crush_kernels.crush_do_rule_batch.launches
    finally:
        os.unlink(path)
    text = out.getvalue()
    stored = {}
    for line in text.splitlines():
        if line.startswith("  device "):
            dev_id = int(line.split()[1].rstrip(":"))
            stored[dev_id] = int(line.split("stored :")[1].split()[0])
    placements = ck.compile_rule(big, 0, 3)(np.arange(n))
    distinct = bool(((placements[:, 0] != placements[:, 1])
                     & (placements[:, 0] != placements[:, 2])
                     & (placements[:, 1] != placements[:, 2])).all()
                    and (placements >= 0).all()
                    and (placements < big.max_devices).all())
    counts = np.bincount(placements.ravel(), minlength=big.max_devices)
    stats_line = f"result size == 3:\t{n}/{n}"
    tool = {"phase": "crushtool", "rc": rc, "seconds": tool_s,
            "launches": launches, "inputs": n,
            "three_distinct_osds_each": distinct,
            "stored_sum": sum(stored.values()),
            "all_inputs_size_3": stats_line in text,
            "stored_matches_placements": [stored.get(d, -1) for d in
                                          range(big.max_devices)]
            == counts.tolist()}
    print(json.dumps(tool))
    check(rc == 0 and distinct and tool["stored_sum"] == 3 * n
          and tool["all_inputs_size_3"] and tool["stored_matches_placements"],
          "crushtool --test output is wrong")
    check(launches > 0, "crushtool never launched the placement kernel")
    return {"big": big, "shapes": shapes, "launches": launches,
            "max_abs_err": max_err, "crushtool_run_s": tool_s}


def crush_times(torch, dev, card: str, state: dict) -> dict:
    """Phase 4's CRUSH part: the kernel per rule and weight vector beside
    its bound and the plain version's time (timed in phase 3b by
    kernel_shapes.crush_shapes), compile_rule on 2^20 inputs and the
    crushtool.run call.  Returns the kernels line's row."""
    from ceph_tpu_torch.crush import kernel as ck
    from ceph_tpu_torch.tools import kernel_shapes as ks

    times = [{k: sh.row[k] for k in ("rule", "weights", "ms",
                                     "back_to_back_ms", "bound_ms",
                                     "bound_share", "lane_utilization",
                                     "plain_ms")}
             for sh in state["shapes"]]
    n = ks.CRUSH_INPUTS
    compile_s = host_median_s(torch, lambda: ck.compile_rule(
        state["big"], 0, 3, device=dev)(np.arange(n)))
    print(json.dumps({"crush_times": times, "compile_rule_run_s": compile_s,
                      "placements_per_s": n / compile_s,
                      "crushtool_run_s": state["crushtool_run_s"],
                      "card": card}))
    return {"launches": state["launches"],
            "max_abs_err": state["max_abs_err"], **times[0]}


def osdmap_of(cmap, rng=None):
    """The 10,000-OSD map in an OSDMap (all OSDs up and in) with the
    replicated pool on rule 0 and the EC 8+3 pool on rule 1; with `rng`, a
    seeded OUT_SHARE of the OSDs out and another DOWN_SHARE down."""
    from ceph_tpu_torch.osd import osdmap as om
    m = om.OSDMap()
    m.epoch, m.fsid = 1, "chip-smoke"
    m.crush = cmap
    m.set_max_osd(cmap.max_devices)
    for o in range(m.max_osd):
        m.osd_state[o] = om.CEPH_OSD_EXISTS | om.CEPH_OSD_UP
        m.osd_weight[o] = om.CEPH_OSD_IN
    m.create_pool("rbd", size=3, pg_num=OSDMAP_REP_PGS, crush_rule=0)
    m.erasure_code_profiles["ec83"] = dict(EC_PROFILE)
    m.create_pool("ec83", type_=om.TYPE_ERASURE, size=K + M,
                  pg_num=OSDMAP_EC_PGS, crush_rule=1,
                  erasure_code_profile="ec83")
    if rng is not None:
        order = [int(o) for o in rng.permutation(m.max_osd)]
        n_out, n_down = int(m.max_osd * OUT_SHARE), int(m.max_osd * DOWN_SHARE)
        for o in order[:n_out]:
            m.osd_weight[o] = om.CEPH_OSD_OUT
        for o in order[n_out:n_out + n_down]:
            m.osd_state[o] &= ~om.CEPH_OSD_UP
    return m


def osdmap_phase(torch, dev, card: str) -> dict:
    """Phase 3c: OSDMapMapping and osdmaptool --test-map-pgs on the
    10,000-OSD map, all in and with OSDs out and down.  Returns the launches
    and the kernel's rows at these shapes."""
    import contextlib
    import io
    import os
    import tempfile

    from ceph_tpu_torch.crush import kernel as ck
    from ceph_tpu_torch.ops import crush_kernels
    from ceph_tpu_torch.osd.osdmap import OSDMapMapping, PgId
    from ceph_tpu_torch.tools import kernel_shapes as ks
    from ceph_tpu_torch.tools import osdmaptool

    phase_t0 = time.perf_counter()
    launch = crush_kernels.crush_do_rule_batch
    rng = np.random.default_rng(SEED + 2)
    cmap = ks.crush_map_10k()
    runs, shapes, launches = [], [], 0
    for wname, m in (("all in", osdmap_of(cmap)),
                     ("out and down", osdmap_of(cmap, rng))):
        launch.launches = 0
        t0 = time.perf_counter()
        mapping = OSDMapMapping(m)
        mapping_s = time.perf_counter() - t0
        mapping_launches = launch.launches

        # the update's parts, again: the map flattened once, each pool's
        # pps and its kernel launch (timed alone, and held against the
        # plain version, which counts the draws for the bound)
        t0 = time.perf_counter()
        dm = ck.DenseMap.from_crush_map(m.crush, m.osd_weight, dev)
        torch.cuda.synchronize()
        flatten_s = time.perf_counter() - t0
        pps_s = kernel_ms = 0.0
        for pool in m.pools.values():
            t0 = time.perf_counter()
            pps = pool.all_pps()
            pps_s += time.perf_counter() - t0
            prog = ck.rule_program(m.crush, m._find_rule(pool), pool.size)
            xs = torch.from_numpy(pps.astype(np.int32)).to(dev)
            out = torch.empty((xs.numel(), pool.size), dtype=torch.int32,
                              device=dev)
            got = launch(dm, prog, xs, out=out).clone()
            stats = {}
            t0 = time.perf_counter()
            want = ck.crush_do_rule_batch_plain(dm, prog, xs, stats)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            ms = ks.alone_ms(lambda: launch(dm, prog, xs, out=out))
            kernel_ms += ms
            shapes.append({
                "weights": wname, "pool": pool.name, "inputs": xs.numel(),
                "result_max": pool.size, "ms": ms,
                "bound_ms": ks.crush_bound_ms(stats, xs.numel(), pool.size),
                "plain_ms": plain_ms,
                "mismatches_vs_plain": int((got != want).any(1).sum()),
                "max_abs_err": int((got.long() - want.long()).abs().max()),
                "draws_per_input": stats["draws"] / xs.numel()})
            del got, want, out

        # a seeded sample of each pool's PGs against the host path
        host_bad, host_pgs = 0, 0
        t0 = time.perf_counter()
        for pool in m.pools.values():
            for ps in rng.choice(pool.pg_num, OSDMAP_SAMPLES, replace=False):
                pg = PgId(pool.id, int(ps))
                host_bad += mapping.get(pg) != m.pg_to_up_acting_osds(pg)
                host_pgs += 1
        host_s = time.perf_counter() - t0

        # the tool on the map written to a file; its counts against the
        # mapping's
        fd, path = tempfile.mkstemp(suffix=".osdmap")
        with os.fdopen(fd, "wb") as f:
            f.write(m.encode())
        try:
            text = io.StringIO()
            launch.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                rc = osdmaptool.run([path, "--test-map-pgs"])
            tool_s = time.perf_counter() - t0
            tool_launches = launch.launches
        finally:
            os.unlink(path)
        per_osd = mapping.pgs_by_osd()
        in_ids = [o for o in range(m.max_osd) if m.is_in(o)]
        counts = np.array([len(per_osd.get(o, [])) for o in in_ids])
        lo, hi = int(counts.argmin()), int(counts.argmax())
        n_pgs = sum(p.pg_num for p in m.pools.values())
        want_lines = [f"pool all pg_num {n_pgs}",
                      f"min osd.{in_ids[lo]} {int(counts[lo])}",
                      f"max osd.{in_ids[hi]} {int(counts[hi])}",
                      f"avg {float(counts.mean()):.2f}"
                      f" stddev {float(counts.std()):.2f}"]
        lines = text.getvalue().splitlines()
        tool_ok = rc == 0 and all(line in lines for line in want_lines)
        runs.append({
            "weights": wname, "pgs": n_pgs, "mapping_s": mapping_s,
            "mapping_launches": mapping_launches, "flatten_s": flatten_s,
            "pps_s": pps_s, "kernel_s": kernel_ms / 1e3,
            "kernel_share": kernel_ms / 1e3 / mapping_s,
            "per_pg_host_s": mapping_s - flatten_s - pps_s - kernel_ms / 1e3,
            "host_path_pgs": host_pgs, "host_path_mismatches": host_bad,
            "host_path_s": host_s, "osdmaptool_s": tool_s,
            "osdmaptool_launches": tool_launches, "osdmaptool_ok": tool_ok,
            "osdmaptool_lines": lines})
        launches += mapping_launches + tool_launches
        check(host_bad == 0, f"OSDMapMapping differs from the host path on"
              f" {host_bad} of {host_pgs} sampled PGs ({wname})")
        check(tool_ok, f"osdmaptool --test-map-pgs printed {lines}")
        check(mapping_launches > 0 and tool_launches > 0,
              "OSDMapMapping or osdmaptool never launched the placement"
              " kernel")
    print(json.dumps({"phase": "osdmap", "runs": runs, "kernel_shapes": shapes,
                      "seconds": time.perf_counter() - phase_t0,
                      "card": card}))
    check(all(sh["mismatches_vs_plain"] == sh["max_abs_err"] == 0
              for sh in shapes),
          "the placement kernel disagrees with its plain version")
    return {"launches": launches, "shapes": shapes}


def cluster_phase(torch, dev, card: str, wrappers: dict) -> dict:
    """Phase 3d: LocalCluster on the card, EC 8+3 over hosts: 64 MiB
    objects written, read healthy and degraded, scrubbed, corrupted and
    repaired; one object's shards and hinfo against the same write on a
    LocalCluster(device="cpu").  Returns the launches."""
    from ceph_tpu_torch.os import ObjectId, Transaction
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.rados.embedded import (HINFO_ATTR, OI_ATTR,
                                               LocalCluster, shard_collection)

    phase_t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 3)
    objs = {f"obj-{i}": rng.bytes(CLUSTER_OBJECT)
            for i in range(CLUSTER_OBJECTS)}
    cluster = LocalCluster(num_osds=CLUSTER_OSDS,
                           osds_per_host=CLUSTER_OSDS_PER_HOST)
    check(cluster.device.type == "cuda", "the cluster is not on the card")
    cluster.create_erasure_pool("ecpool", EC_PROFILE)
    io = cluster.open_ioctx("ecpool")
    times = {"write_full": [], "read": [], "read_1_down": [],
             "read_3_down": []}
    exact = []

    def timed(key, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times[key].append(time.perf_counter() - t0)
        return res

    for fn in wrappers.values():
        fn.launches = 0
    for name, data in objs.items():
        timed("write_full", lambda: io.write_full(name, data))
        exact.append(timed("read", lambda: io.read(name)) == data)
        acting, _primary = io.acting(io.object_pg(name))
        # one data shard lost, then three (the most RS 8+3 decodes)
        for key, lost in (("read_1_down", (0,)), ("read_3_down", (0, 3, 6))):
            for shard in lost:
                cluster.mark_osd_down(acting[shard])
            exact.append(timed(key, lambda: io.read(name)) == data)
            for shard in lost:
                cluster.mark_osd_up(acting[shard])

    # scrub, a flipped byte in one shard's store, read, repair, scrub
    name = "obj-0"
    pg = io.object_pg(name)
    acting, _primary = io.acting(pg)
    oid = ObjectId(name)
    clean_before = io.deep_scrub(name)
    store, cid = cluster.stores[acting[2]], shard_collection(pg, 2)
    buf = bytearray(store.read(cid, oid))
    buf[12345] ^= 0x01
    t = Transaction()
    t.write(cid, oid, 0, len(buf), bytes(buf))
    store.queue_transaction(t)
    found = io.deep_scrub(name)
    read_corrupt_ok = io.read(name) == objs[name]
    repaired = io.repair(name)
    clean_after = io.deep_scrub(name)
    launches = {n: fn.launches for n, fn in wrappers.items()}

    # where a write and a degraded read spend their time: the steps of
    # write_full and read, run again on obj-1
    name, data = "obj-1", objs["obj-1"]
    codec = cluster._codec(io.pool_id)
    sinfo = io._sinfo(codec)
    shards = ec_util.encode(sinfo, codec, data, range(K + M))
    pg = io.object_pg(name)
    acting, _primary = io.acting(pg)
    steps = {
        "encode_s": host_median_s(torch, lambda: ec_util.encode(
            sinfo, codec, data, range(K + M))),
        "hinfo_crc_s": host_median_s(torch, lambda: ec_util.HashInfo(
            K + M).append(0, shards)),
        "gather_and_verify_s": host_median_s(torch, lambda: io._gather_shards(
            name, pg, acting)),
        "decode_1_lost_s": host_median_s(torch, lambda: ec_util.decode(
            sinfo, codec, {i: shards[i] for i in range(1, K + M)})),
    }
    med = {key: statistics.median(v) for key, v in times.items()}
    # placement, the padding copy, the xattrs and the 11 store transactions
    steps["store_and_rest_s"] = (med["write_full"] - steps["encode_s"]
                                 - steps["hinfo_crc_s"])

    # the same write through the plain versions
    cpu = LocalCluster(num_osds=CLUSTER_OSDS,
                       osds_per_host=CLUSTER_OSDS_PER_HOST, device="cpu")
    cpu.create_erasure_pool("ecpool", EC_PROFILE)
    cpu_io = cpu.open_ioctx("ecpool")
    cpu_io.write_full(name, data)
    same = cpu_io.acting(pg) == io.acting(pg)
    for shard, osd in enumerate(acting):
        cid = shard_collection(pg, shard)
        same = same and all(
            cluster.stores[osd].read(cid, ObjectId(name))
            == cpu.stores[osd].read(cid, ObjectId(name))
            and cluster.stores[osd].getattr(cid, ObjectId(name), attr)
            == cpu.stores[osd].getattr(cid, ObjectId(name), attr)
            for attr in (HINFO_ATTR, OI_ATTR))

    gib = CLUSTER_OBJECT / (1 << 30)
    result = {
        "phase": "cluster", "osds": CLUSTER_OSDS,
        "hosts": CLUSTER_OSDS // CLUSTER_OSDS_PER_HOST,
        "objects": CLUSTER_OBJECTS, "object_bytes": CLUSTER_OBJECT,
        "reads_exact": sum(exact), "reads": len(exact),
        "scrub_clean_before": clean_before, "scrub_found": found,
        "read_with_corrupt_shard_ok": read_corrupt_ok,
        "repaired": repaired, "scrub_clean_after": clean_after,
        "same_as_cpu_cluster": same, "launches": launches,
        "seconds": times, "median_s": med,
        "gib_per_s": {key: gib / sec for key, sec in med.items()},
        "steps": steps, "seconds_in_phase": time.perf_counter() - phase_t0,
        "card": card}
    print(json.dumps(result))
    check(all(exact) and read_corrupt_ok, "a cluster read differs from the"
          " written object")
    check(clean_before == [] and clean_after == []
          and [s for s, _why in found] == [2] and repaired == [2],
          f"scrub/repair: {clean_before} {found} {repaired} {clean_after}")
    check(same, "the card's shards or hinfo differ from the CPU cluster's")
    check(launches["gf_matmul_spec"] > 0 and launches["gf_matmul_gen"] > 0,
          f"the cluster path did not launch both GF kernels: {launches}")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a"
             " CUDA card")
    try:
        from ceph_tpu_torch.device import to_device
        from ceph_tpu_torch.ec import plan
        from ceph_tpu_torch.ec.registry import create_erasure_code
        from ceph_tpu_torch.models import reed_solomon as rs
        from ceph_tpu_torch.ops import (_build, crc_kernels, crush_kernels,
                                        gf_kernels)
        from ceph_tpu_torch.ops import checksum as cks
        from ceph_tpu_torch.ops.gf import gf_matmul_ref
        from ceph_tpu_torch.osd import ec_util
        from ceph_tpu_torch.tools.kernel_shapes import alone_ms, card_name
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")

    try:
        card = card_name()
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi failed: {e}")
    print(card)
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}))
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    # -- 1. build ------------------------------------------------------------
    _build.load()
    regs, regs_by_source, spills = [], {}, 0
    for name, log in _build.build_logs().items():
        used = [int(line.split("Used")[1].split()[0])
                for line in log.splitlines()
                if "Used" in line and "registers" in line]
        regs += used
        regs_by_source[name] = max(used) if used else None
        spills += sum(int(line.split("bytes spill stores")[0].split(",")[-1])
                      for line in log.splitlines() if "spill stores" in line)
    print(json.dumps({"phase": "build", "seconds": _build.build_seconds,
                      "max_registers_by_source": regs_by_source,
                      "kernels_compiled": len(regs),
                      "max_registers": max(regs) if regs else None,
                      "spill_store_bytes": spills,
                      "crc32c_dynamic_smem_bytes": crc_kernels.smem_bytes()}))

    # -- 2. kernels against their plain versions ----------------------------
    rs_mat = rs.reed_sol_van_matrix(K, M)
    gf_kernels.register_matrix(rs_mat)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    data = torch.randint(0, 256, (B, K, CHUNK), dtype=torch.uint8,
                         device=dev, generator=gen)
    blocks = torch.randint(0, 256, (B * (K + M), CHUNK), dtype=torch.uint8,
                           device=dev, generator=gen)
    blocks_4k = blocks.view(-1, 4096)
    odd_len = 2052                       # no multiple of 128 or of 16
    blocks_odd = blocks.view(-1)[:4096 * odd_len].view(-1, odd_len)

    def err(a, b) -> int:
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        return int(d.max()) if d.numel() else 0

    def u32(t):
        return t.to(torch.int64) & 0xFFFFFFFF

    zero_mat = rs_mat.copy()
    zero_mat[1] = 0
    zero_mat[:, 5] = 0
    wide_mat = np.random.default_rng(SEED).integers(
        0, 256, (gf_kernels.MAX_R, gf_kernels.MAX_K)).astype(np.uint8)
    n_odd = 16384                        # stripes of odd_len-byte chunks
    spec_cases = {
        "rs8+3": (rs_mat, data),
        "rs10+4": (rs.reed_sol_van_matrix(10, 4),
                   blocks[:B * 10].view(B, 10, CHUNK)),
        "rs8+3 S=2052": (rs_mat, blocks.view(-1)[:n_odd * K * odd_len]
                         .view(n_odd, K, odd_len)),
        "16x64": (wide_mat, blocks.view(-1)[:4 * 64 * (64 << 10)]
                  .view(4, 64, 64 << 10)),
        # chunks that fill no whole block of 512 uint4 columns: at 4096
        # bytes no thread has a second uint4, at 12304 some have one
        "rs8+3 S=4096": (rs_mat, blocks.view(-1)[:2048 * K * 4096]
                         .view(2048, K, 4096)),
        "rs8+3 S=12304": (rs_mat, blocks.view(-1)[:1024 * K * 12304]
                          .view(1024, K, 12304)),
        "zero row and column": (zero_mat, data)}
    spec_errs = {name: err(gf_kernels.gf_matmul_spec(mat, d),
                           gf_kernels.gf_matmul_spec_plain(mat, d))
                 for name, (mat, d) in spec_cases.items()}
    spec_err = max(spec_errs.values())
    singles = [rs.decode_matrix(rs_mat, K, [e],
                                [i for i in range(K + M) if i != e][:K])
               for e in range(K + M)]
    triple = rs.decode_matrix(rs_mat, K, [0, 4, 9],
                              [1, 2, 3, 5, 6, 7, 8, 10])
    gen_err = max(err(gf_kernels.gf_matmul_gen(mat, data),
                      gf_kernels.gf_matmul_gen_plain(mat, data))
                  for mat in singles + [triple])
    crc_err = 0
    for blk, length, init in ((blocks, CHUNK, 0), (blocks, CHUNK, 0xFFFFFFFF),
                              (blocks_4k, 4096, 0),
                              (blocks_odd, odd_len, 0xFFFFFFFF)):
        crc_err = max(crc_err, err(
            u32(crc_kernels.crc32c_blocks(blk, length, init)),
            u32(cks.crc32c_batch(blk, init))))
    sync()
    print(json.dumps({"phase": "kernels_vs_plain", "gf_matmul_spec": spec_err,
                      "gf_matmul_gen": gen_err, "crc32c_blocks": crc_err,
                      "spec_shapes": {name: [list(d.shape), e] for (name, (
                          _, d)), e in zip(spec_cases.items(),
                                           spec_errs.values())},
                      "gen_matrices": len(singles) + 1,
                      "crc_shapes": [[B * (K + M), CHUNK],
                                     [blocks_4k.shape[0], 4096],
                                     [blocks_odd.shape[0], odd_len]]}))
    check(spec_err == gen_err == crc_err == 0,
          "a kernel disagrees with its plain version")

    # -- 3. the main path ---------------------------------------------------
    codec = create_erasure_code({"plugin": "ec_torch",
                                 "technique": "reed_sol_van",
                                 "k": str(K), "m": str(M)})
    check(codec.use_tpu and codec.device.type == "cuda",
          "the codec is not on the card")
    sinfo = ec_util.StripeInfo(K, STRIPE)
    obj = np.random.default_rng(SEED).bytes(B * STRIPE)
    obj_arr = np.frombuffer(obj, dtype=np.uint8)
    n = K + M
    wrappers = {"gf_matmul_spec": gf_kernels.gf_matmul_spec,
                "gf_matmul_gen": gf_kernels.gf_matmul_gen,
                "crc32c_blocks": crc_kernels.crc32c_blocks,
                "crush_do_rule_batch": crush_kernels.crush_do_rule_batch}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    shards, hinfo, data_crc = ec_util.encode_with_hinfo(
        sinfo, codec, obj, range(n), logical_len=len(obj))
    decoded_ok = []
    for e in range(K):
        out = ec_util.decode(sinfo, codec,
                             {i: shards[i] for i in range(n) if i != e})
        decoded_ok.append(np.array_equal(np.frombuffer(out, np.uint8),
                                         obj_arr))
    full = np.stack([np.frombuffer(shards[i], np.uint8).reshape(B, CHUNK)
                     for i in range(n)], axis=1)       # (B, n, CHUNK)
    batch_ok = []
    for e in range(n):
        have = tuple(i for i in range(n) if i != e)[:K]
        got = codec.decode_batch(have, (e,),
                                 np.ascontiguousarray(full[:, have, :]))
        batch_ok.append(np.array_equal(got[:, 0, :], full[:, e, :]))
    sync()
    main_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}

    stripes = obj_arr.reshape(B, K, CHUNK)
    sample = (0, B // 2, B - 1)
    parity_ok = all(np.array_equal(full[s, K:], gf_matmul_ref(rs_mat,
                                                              stripes[s]))
                    and np.array_equal(full[s, :K], stripes[s])
                    for s in sample)
    host_ok = all(hinfo.cumulative_shard_hashes[i]
                  == cks.crc32c(0xFFFFFFFF, shards[i]) for i in (0, K, n - 1))
    dev_full = torch.from_numpy(np.ascontiguousarray(
        full.transpose(1, 0, 2))).to(dev).view(n * B, CHUNK)
    crc0 = cks.crc32c_batch(dev_full, 0).cpu().numpy().view(np.uint32)
    plain_ok = (ec_util.fold_ledger(crc0.reshape(n, B).T, CHUNK)
                == hinfo.cumulative_shard_hashes)
    del dev_full
    result = {"phase": "main_path", "object_bytes": len(obj),
              "stripes": B, "chunk": CHUNK, "seconds": main_s,
              "decodes_ok": sum(decoded_ok), "decode_batch_ok": sum(batch_ok),
              "parity_vs_oracle_ok": parity_ok, "hinfo_vs_host_crc_ok": host_ok,
              "hinfo_vs_plain_crc_ok": plain_ok,
              "hinfo_total_chunk_size": hinfo.total_chunk_size,
              "data_crc": data_crc, "launches": launches}
    print(json.dumps(result))
    check(all(decoded_ok), "a decoded object differs from the original")
    check(all(batch_ok), "a decode_batch chunk differs from the original")
    check(parity_ok, "parity differs from the numpy oracle")
    check(host_ok and plain_ok, "a hinfo ledger differs from the reference")
    check(hinfo.total_chunk_size == B * CHUNK, "wrong hinfo chunk size")
    check(all(launches[name] > 0 for name in ("gf_matmul_spec",
                                              "gf_matmul_gen",
                                              "crc32c_blocks")),
          f"a kernel of the main path never launched: {launches}")

    # -- 3b. CRUSH placement ------------------------------------------------
    crush_state = crush_phase(torch, dev, card)

    # -- 3c. live PG placement: OSDMapMapping and osdmaptool ----------------
    osdmap_state = osdmap_phase(torch, dev, card)

    # -- 3d. the embedded cluster -------------------------------------------
    cluster_launches = cluster_phase(torch, dev, card, wrappers)
    # each path's launches, its counts zeroed just before it
    by_path = {"codec": launches,
               "crushtool": {"crush_do_rule_batch": crush_state["launches"]},
               "osdmap": {"crush_do_rule_batch": osdmap_state["launches"]},
               "cluster": cluster_launches}

    # -- 4. times -----------------------------------------------------------
    parity_out = torch.empty((B, M, CHUNK), dtype=torch.uint8, device=dev)
    one = singles[0]
    one_out = torch.empty((B, 1, CHUNK), dtype=torch.uint8, device=dev)
    crc_out = torch.empty(blocks.shape[0], dtype=torch.int32, device=dev)
    words = B * CHUNK // 4                       # 32-bit words per input row
    rows = []

    def path_launches(name):
        counts = {path: c.get(name, 0) for path, c in by_path.items()}
        return {"launches": sum(counts.values()),
                "launches_by_path": counts}

    def row(name, route, source, replaces, fn, plain, n_bytes, ops):
        ms = alone_ms(fn)
        plain_ms = alone_ms(plain, reps=5, warmup=1)
        b_ms, by = bound(n_bytes, ops)
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, **path_launches(name),
                "max_abs_err": {"gf_matmul_spec": spec_err,
                                "gf_matmul_gen": gen_err,
                                "crc32c_blocks": crc_err}[name],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": by, "library_ms": None}

    rows.append(row(
        "gf_matmul_spec", "cuda", "ceph_tpu_torch/csrc/gf_matmul.cu",
        "ceph_tpu/ops/gf_pallas.py:137",
        lambda: gf_kernels.gf_matmul_spec(rs_mat, data, out=parity_out),
        lambda: gf_kernels.gf_matmul_spec_plain(rs_mat, data),
        B * (K + M) * CHUNK, words * spec_ops_per_word(gf_kernels, rs_mat)))
    rows.append(row(
        "gf_matmul_gen", "cuda", "ceph_tpu_torch/csrc/gf_matmul.cu",
        "ceph_tpu/ops/gf_pallas.py:158",
        lambda: gf_kernels.gf_matmul_gen(one, data, out=one_out),
        lambda: gf_kernels.gf_matmul_gen_plain(one, data),
        B * (K + 1) * CHUNK,
        words * K * (7 * XTIME_OPS + 8 * 1 * GEN_OPS_PER_BIT)))
    n_blk = blocks.shape[0]
    rows.append(row(
        "crc32c_blocks", "cuda", "ceph_tpu_torch/csrc/crc32c.cu",
        "ceph_tpu/ops/crc_pallas.py:111",
        lambda: crc_kernels.crc32c_blocks(blocks, CHUNK, 0, out=crc_out),
        lambda: cks.crc32c_batch(blocks, 0),
        n_blk * CHUNK + 4 * n_blk, n_blk * CHUNK // 4 * CRC_OPS_PER_WORD))

    # other shapes the main path and its users give the kernels
    triple_ms = alone_ms(
        lambda: gf_kernels.gf_matmul_gen(triple, data))
    extra = [{"name": "gf_matmul_gen", "erasures": 3, "ms": triple_ms,
              "bound_ms": bound(B * (K + 3) * CHUNK, words * K * (
                  7 * XTIME_OPS + 8 * 3 * GEN_OPS_PER_BIT))[0]}]
    # the generic kernel on the encode matrix: the yardstick of the
    # specialised one on the same work
    extra.append({
        "name": "gf_matmul_gen", "matrix": "rs8+3 generator",
        "ms": alone_ms(lambda: gf_kernels.gf_matmul_gen(
            rs_mat, data, out=parity_out)),
        "bound_ms": bound(B * (K + M) * CHUNK, words * K * (
            7 * XTIME_OPS + 8 * M * GEN_OPS_PER_BIT))[0]})
    # the crc launches of plan.encode_with_crc (data chunks, then parity
    # chunks) and BlueStore-style 4 KiB block checksums
    for blk, length in ((blocks[:B * K], CHUNK), (blocks[B * K:], CHUNK),
                        (blocks_4k, 4096)):
        nb = blk.shape[0]
        nb_out = torch.empty(nb, dtype=torch.int32, device=dev)
        extra.append({
            "name": "crc32c_blocks", "blocks": nb, "length": length,
            "ms": alone_ms(lambda: crc_kernels.crc32c_blocks(
                blk, length, 0, out=nb_out)),
            "bound_ms": bound(nb * (length + 4),
                              nb * length // 4 * CRC_OPS_PER_WORD)[0]})
    # the cluster path's shapes (phase 3d): ec_util.encode hands a 64 MiB
    # object's shard streams over as one (1, 8, 8 MiB) batch, and a read or
    # repair that lost data shards decodes (2048, 8, 4096) stripes
    stream = CLUSTER_OBJECT // K
    n_stripes = stream // 4096
    cluster_shapes = (
        ("gf_matmul_spec", rs_mat, blocks.view(-1)[:K * stream]
         .view(1, K, stream)),
        ("gf_matmul_gen", singles[0], blocks.view(-1)[:K * stream]
         .view(n_stripes, K, 4096)),
        ("gf_matmul_gen", triple, blocks.view(-1)[:K * stream]
         .view(n_stripes, K, 4096)))
    for name, mat, d in cluster_shapes:
        fn = getattr(gf_kernels, name)
        plain = getattr(gf_kernels, name + "_plain")
        r = mat.shape[0]
        out_t = torch.empty((d.shape[0], r, d.shape[2]), dtype=torch.uint8,
                            device=dev)
        e = err(fn(mat, d, out=out_t), plain(mat, d))
        n_words = d.shape[0] * d.shape[2] // 4
        ops = (n_words * spec_ops_per_word(gf_kernels, mat)
               if name == "gf_matmul_spec" else
               n_words * K * (7 * XTIME_OPS + 8 * r * GEN_OPS_PER_BIT))
        b_ms, by = bound(d.numel() + out_t.numel(), ops)
        extra.append({"name": name, "path": "cluster",
                      "shape": list(d.shape), "rows": r, "max_abs_err": e,
                      "ms": alone_ms(lambda: fn(mat, d, out=out_t)),
                      "plain_ms": alone_ms(lambda: plain(mat, d), reps=5,
                                           warmup=1),
                      "bound_ms": b_ms, "bound_by": by})
        check(e == 0, f"{name} disagrees with its plain version at"
              f" {list(d.shape)}")
    for sh in osdmap_state["shapes"]:
        extra.append({"name": "crush_do_rule_batch", "path": "osdmap",
                      "bound_by": "operations", **sh})
    print(json.dumps({"extra_shapes": extra, "card": card}))

    survivors = np.ascontiguousarray(full[:, 1:K + 1, :])
    gib = len(obj) / (1 << 30)
    e2e = {
        "encode_batch_s": host_median_s(
            torch, lambda: codec.encode_batch(stripes)),
        "decode_batch_s": host_median_s(
            torch, lambda: codec.decode_batch(tuple(range(1, K + 1)), (0,),
                                              survivors)),
        "encode_with_hinfo_s": host_median_s(
            torch, lambda: ec_util.encode_with_hinfo(sinfo, codec, obj,
                                                     range(n))),
    }
    e2e.update({name[:-2] + "_gib_per_s": gib / sec
                for name, sec in list(e2e.items())})
    # where the fused encode's time goes: staging the stripes onto the
    # card, the device part of plan.encode_with_crc (kernels and the copy
    # back), and the rest of encode_with_hinfo (ledger fold, shard views)
    dev_parity = torch.empty(B * M * CHUNK, dtype=torch.uint8, device=dev)
    e2e.update({
        "stage_to_device_s": host_median_s(
            torch, lambda: to_device(stripes, dev)),
        "copy_back_parity_s": host_median_s(torch, dev_parity.cpu),
        "plan_encode_with_crc_s": host_median_s(
            torch, lambda: plan.encode_with_crc(rs_mat, stripes, dev)),
    })
    print(json.dumps({"end_to_end": e2e, "object_gib": gib, "card": card}))

    crush = crush_times(torch, dev, card, crush_state)
    rows.append({
        "name": "crush_do_rule_batch", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush.cu",
        "replaces": "ceph_tpu/crush/kernel.py:374",
        **path_launches("crush_do_rule_batch"),
        "max_abs_err": max(crush["max_abs_err"], max(
            sh["max_abs_err"] for sh in osdmap_state["shapes"])),
        "ms": crush["ms"], "plain_ms": crush["plain_ms"],
        "bound_ms": crush["bound_ms"], "bound_by": "operations",
        "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
