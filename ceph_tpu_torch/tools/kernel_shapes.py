#!/usr/bin/env python3
"""Time the port's kernels at the shapes the main path gives them, on one
CUDA card.

    python3 ceph_tpu_torch/tools/kernel_shapes.py
        {crc,gf,crush,score,xsched,bloom} [--root DIR] [--sass] [--cuts]

`--root` names the checkout whose ceph_tpu_torch is built and timed
(default: the one holding this script), so that two versions of a kernel
can be timed in turns on one card in one call: parent, change, change,
parent.  Every shape is first checked bit for bit against the kernel's
plain version.  Prints one JSON line: the card's name and power limit,
and per shape "ms", the CUDA-event median of REPS launches after 3
warm-up launches, each timed alone (as chip_smoke.py times them);
"back_to_back_ms", the mean of REPS launches enqueued with no host gap;
"bound_ms", the bytes bound at 3.35 TB/s; and "read_ms", a plain read of
the input bytes (torch.sum over them as float32) back to back, as a
yardstick of the read rate the card reaches.

crc: crc32c_blocks at 704, 512 and 192 blocks of 512 KiB (all hinfo
chunks of a 64-stripe RS 8+3 write, and the data and parity launches of
plan.encode_with_crc) and 90112 blocks of 4 KiB.

gf: gf_matmul_spec with the reed_sol_van generators RS 8+3 over 64
stripes of 8 x 512 KiB (the main path's encode launch), RS 10+4 over 64
stripes of 10 x 512 KiB (two input groups) and RS 8+3 over 16384 stripes
of 2052-byte chunks (a length that is no multiple of 16), each beside
gf_matmul_gen on the same matrix and data ("gen_ms",
"gen_back_to_back_ms"); at RS 8+3, also gf_matmul_gen at the main path's
decode launch, one single-erasure row over the same data ("gen_r1");
then gf_matmul_gen at the cluster's degraded reads (GF_DECODE_SHAPES):
2048 stripes of 8 x 4096 bytes with one data shard lost (one row) and
with three lost (three rows); and "gen_host_us", the host microseconds a
gf_matmul_gen call takes before its kernel runs (the wrapper with its
checks, and the ctypes call of the C entry alone, which derives the
schedule and launches), each the mean of HOST_REPS calls on a 16-byte
chunk enqueued without a wait, so the card keeps up.  It also prints
what ptxas reported for the GF kernels at R = 1 and R = 3 (registers,
spills) and, with `--sass`, the instructions of each of those kernels by
opcode and by a few forms (predicated, XOR, mask test, xtime shift),
counted over the whole function in `cuobjdump -sass` of the built
library: every branch's body counts once, taken or not.  The spec
kernel runs RS 8+3 at R = 3; the generic kernel runs the one-row decode
at R = 1 and the three-row one at R = 3 (in a tree where both entries
launch one kernel, that kernel's functions).

crush: crush_do_rule_batch on the 10,000-OSD map of chip_smoke.py
(build_flat_cluster(10000, 20, 10): 50 racks, 500 hosts, straw2) over
x = 0 .. 2^20 - 1, for the replicated rule (chooseleaf firstn over hosts,
3 replicas) and the EC rule (set_chooseleaf_tries 5, chooseleaf indep
over hosts, 11 = 8+3 slots), each with all OSDs in and with a rebalance
weight vector (a seeded 5% of OSDs out, another 10% at weight 0x8000).
Each shape is checked bit for bit against the plain version on all 2^20
inputs, which also counts the straw2 draws and is_out hashes the inputs
need; "bound_ms" there is the largest of those instructions at 33.5 T
lane-instructions/s (one warp-instruction per scheduler per clock) and
the shares that only the integer ALU pipe or only the FMA pipe can issue,
each pipe at half that rate (16 lanes per scheduler per clock), all
counted per draw in the kernel's SASS (DRAW_OPS, DRAW_ALU_OPS,
DRAW_FMA_OPS); the kernel moves a few tens of MB, far under that time at
3.35 TB/s.  "plain_ms" is the plain version's time on the card (host
clock).  "lane_utilization" is the straw2 loop's active lanes summed
over __activemask() per trip, over 32 x trips, from a counting build:
a copy of the checkout's csrc/crush.cu with one counting line at the
head of the straw2 loop, built beside the library and swapped in for one
launch (the wrapper's own library never counts).  With `--sass` it also
counts the instructions of the straw2 draw loop in `cuobjdump -sass` of
the built library (crush_sass), from which DRAW_OPS, DRAW_ALU_OPS and
DRAW_FMA_OPS below are taken.

score: score_blocks at the store's shapes, (1, 65536) (one 64 KiB span a
call) and (256, 65536) (a 16 MiB batch), on English-like text, checked
against the plain version (histograms and match bit for bit, entropy within
ENTROPY_TOL): the wrapper's "ms" and "back_to_back_ms"; "kernel_ms", the
median device duration of the kernel itself over REPS wrapper calls, from
torch.profiler; "host_us", the host microseconds a wrapper call takes
(HOST_REPS calls enqueued without a wait); "decision_host_us",
compress_decision on one span held in host memory, as the store calls it
(staging, the launch and the copy back, ending in a synchronise); and the
bound (score_ops lane operations at 33.5 T/s, bytes at 3.35 TB/s, the
larger) with "share", the bound over kernel_ms.  It also prints ptxas's
lines for csrc/compress_score.cu.  With `--cuts`, it also builds copies of
the checkout's csrc/compress_score.cu with parts cut out (SCORE_CUTS: the
histogram's atomics, the lag counts, both), beside the library, and prints
each copy's kernel_ms at both shapes through the wrapper: what each part
costs.  Their results are wrong by design and are not checked.

xsched: phase 3n (a) of this script's chip_smoke.py (`xsched_kernels`)
run on the root's package: xor_sched's region entry on the trio's encode
and decode arenas of a 1 MiB object, the one-stripe arena (1, 45, 2048)
and the packed batch (512, 45, 2048), its GF entry at the MSR repair
shapes beside gf_matmul_gen, each checked against its plain version and
timed alone, back to back and queued behind a spin kernel ("queued_ms":
the card's own time a call, the host's hidden) beside its bound (the
phase's own JSON line comes first);
then "host_us", the host microseconds a region-entry call takes on the
one-stripe arena (HOST_REPS calls enqueued without a wait).

bloom: the hit-set kernels at the tier's geometry (6,385 bits, nhash 4),
each checked against its plain version and numpy: bloom_positions at
65,536 hashes, a seal of 16 hashes (a PG's median in phase 3g) and a
rotation wave (phase 3g's last period of its Zipf trace, 128 sets of 2,150
hashes in all), first as one bloom_positions launch a set of at least
DEVICE_MIN_BATCH hashes, then, where the package has bloom_seal, as one
seal launch for every set (the kernel's multi-set form; the tier seals PG
by PG).  Per route "queued_ms" (the card's own time a call or a wave,
queued behind a spin kernel), "kernel_ms" (each kernel's own device time,
median, torch.profiler), "host_us" (the host's time a call of the wrappers
on device tensors), "insert_batch_ms" (one BloomHitSet.insert_batch a set
from host hashes, copies and synchronisation included, as the tier's
rotation makes them: the parent's positions and host scatter-OR, or the
change's one seal a set) or "seal_host_ms" (bloom_kernels.seal_host of
every set from host hashes), and the bound; "empty_kernel_queued_ms", an
empty kernel launched through ctypes the same way: the card's floor
between queued kernels.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import List, NamedTuple

import numpy as np
import torch

REPS = 20
HOST_REPS = 500
HBM_BYTES_PER_S = 3.35e12
SEED = 20261016
CRC_SHAPES = ((704, 512 << 10), (512, 512 << 10), (192, 512 << 10),
              (90112, 4096))
GF_SHAPES = (("rs8+3", 8, 3, 64, 512 << 10), ("rs10+4", 10, 4, 64, 512 << 10),
             ("rs8+3 S=2052", 8, 3, 16384, 2052))
# (name, lost data shards, stripes, chunk): the RS 8+3 decode launches of
# a degraded LocalCluster read of a 64 MiB object (4096-byte stripe unit)
GF_DECODE_SHAPES = (("cluster, 1 lost", (0,), 2048, 4096),
                    ("cluster, 3 lost", (0, 4, 9), 2048, 4096))
# the GF kernels' functions that --sass counts and whose ptxas lines are
# kept: R = 1 and R = 3 of each template
_GF_FUNC = re.compile(r"gf_\w+_kernelILi[13]E")
# H100 SXM: 67 TFLOP/s of FP32 outside the tensor cores, i.e. 33.5 T
# lane-instructions per second; no integer instruction issues faster
INT_OPS_PER_S = 67e12 / 2
CRUSH_INPUTS = 1 << 20
CRUSH_RULES = (("replicated", 0, 3), ("ec8+3", 1, 11))
# The integer pipes of an SM sub-partition each take 16 lanes per clock,
# half the issue rate (Nsight Compute's pipe descriptions).  What the ALU
# pipe alone can issue: logic, right and funnel shifts, compares, selects,
# the high word of a shifted sum (LEA.HI).  What the FMA pipe alone can
# issue: multiplies.  An add, a one-word left shift, a move or an address
# sum has a form on each (IADD3, SHF.L, MOV, LEA on the ALU pipe;
# IMAD.IADD, IMAD.SHL, IMAD.MOV, IMAD.WIDE on the FMA pipe), so the two
# pipes can share it; loads, branches and uniform-datapath instructions
# take only their issue slot.
PIPE_OPS_PER_S = INT_OPS_PER_S / 2
ALU_ONLY = frozenset((
    "LOP3", "LOP", "PLOP3", "SHR", "ISETP", "SEL", "FSEL", "PRMT", "IMNMX",
    "VIMNMX", "IABS", "BMSK", "SGXT", "FLO", "POPC", "BREV"))
EITHER_PIPE = frozenset(("IADD3", "IADD", "VIADD", "MOV", "SHL", "LEA"))
FMA_FORMS_OF_EITHER = frozenset(("IMAD.IADD", "IMAD.SHL", "IMAD.MOV"))


def pipe(op: str) -> str:
    """The pipes that can issue a SASS instruction (opcode with its
    modifiers): "alu", "fma", "either" or "issue" (neither)."""
    base = op.split(".")[0]
    if base == "SHF":
        # a left shift of one word is a multiply by a power of two; a right
        # shift, or a funnel shift across two words, is not
        return "either" if op.startswith("SHF.L") and not any(
            m in op.split(".") for m in ("HI", "W")) else "alu"
    if base == "LEA":
        return "alu" if ".HI" in op else "either"
    if base in ALU_ONLY:
        return "alu"
    if base in EITHER_PIPE or op.startswith(tuple(FMA_FORMS_OF_EITHER)):
        return "either"
    if base in ("IMAD", "IMUL"):
        return "fma"
    return "issue"


# Instructions a straw2 draw of the placement kernel executes at least, and
# how many of them only the ALU pipe and only the FMA pipe can issue,
# counted in its SASS by `crush --sass` (draw_paths) on the H100 build of
# csrc/crush.cu (CUDA 12.8): the shortest path from the straw2 loop's head
# through its shared-memory load of the ln tables to the loop's branch,
# over the two inlined copies of straw2, 200 (101 only on the ALU pipe, 13
# only on the FMA pipe, 70 on either) and 206 (103, 14, 70); the least is
# taken.  What only the ALU pipe can issue (the hash's logic and right
# shifts, compares, selects) then takes 1% longer than the issue slots, so
# it sets the bound; the hash's subtracts can go to either pipe.  (The
# kernel's one-thread-per-input design, which called the signed 64-bit
# division routine, took 279-284 per draw, 120-123 only on the ALU pipe.)
# An is_out test that hashes is a hash32_2: an XOR, three mix rounds of 27
# (9 subtract pairs, which either pipe can issue, and 6 right and 3 left
# shifts each folded in by an XOR) and about 4 more, an estimate (under a
# thousandth of the draws' instructions here).
DRAW_OPS = 200
DRAW_ALU_OPS = 101
DRAW_FMA_OPS = 13
IS_OUT_OPS = 2 + 3 * 27 + 4
IS_OUT_ALU_OPS = 1 + 3 * (6 * 2 + 3) + 2


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def alone_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median ms of `reps` calls, each timed alone, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, reps: int = REPS) -> float:
    """Mean ms of `reps` calls enqueued back to back (no host gap)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = REPS, spin_cycles: int = 5_000_000):
    """Mean device ms a call when `reps` calls wait in the queue behind a
    spin kernel (torch.cuda._sleep): the card then runs them back to back
    at its own pace, whatever the host's time a call, so this is the
    kernel's time and the card's gap between kernels.  None when the card
    reached the calls before the host had queued them all."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / reps if queued else None


def times(fn, n_bytes: int) -> dict:
    return {"ms": alone_ms(fn), "back_to_back_ms": back_to_back_ms(fn),
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}


def read_ms(data: torch.Tensor) -> float:
    return back_to_back_ms(lambda: torch.sum(data.view(torch.float32)))


def crc_shapes(dev, gen) -> list:
    from ceph_tpu_torch.ops import checksum as cks
    from ceph_tpu_torch.ops import crc_kernels
    buf = torch.randint(0, 256, (max(n * ln for n, ln in CRC_SHAPES),),
                        dtype=torch.uint8, device=dev, generator=gen)
    shapes = []
    for n, length in CRC_SHAPES:
        blk = buf[:n * length]
        out = torch.empty(n, dtype=torch.int32, device=dev)
        got = crc_kernels.crc32c_blocks(blk, length, 0, out=out).clone()
        shapes.append({
            "blocks": n, "length": length,
            "exact": torch.equal(got, cks.crc32c_batch(blk.view(n, length),
                                                       0)),
            **times(lambda: crc_kernels.crc32c_blocks(blk, length, 0,
                                                      out=out),
                    n * (length + 4)),
            "read_ms": read_ms(blk)})
    return shapes


def gf_shapes(dev, gen) -> list:
    from ceph_tpu_torch.models import reed_solomon as rs
    from ceph_tpu_torch.ops import gf_kernels
    shapes = []
    for name, k, m, b, s in GF_SHAPES:
        mat = rs.reed_sol_van_matrix(k, m)
        gf_kernels.register_matrix(mat)     # as the codec registers it
        data = torch.randint(0, 256, (b, k, s), dtype=torch.uint8,
                             device=dev, generator=gen)
        out = torch.empty((b, m, s), dtype=torch.uint8, device=dev)
        got = gf_kernels.gf_matmul_spec(mat, data, out=out).clone()
        shape = {
            "shape": name, "stripes": b, "k": k, "m": m, "chunk": s,
            "exact": torch.equal(got, gf_kernels.gf_matmul_spec_plain(mat,
                                                                      data)),
            **times(lambda: gf_kernels.gf_matmul_spec(mat, data, out=out),
                    b * (k + m) * s)}
        generic = lambda: gf_kernels.gf_matmul_gen(mat, data, out=out)
        shape.update(gen_ms=alone_ms(generic),
                     gen_back_to_back_ms=back_to_back_ms(generic),
                     read_ms=read_ms(data))
        if name == "rs8+3":
            row = rs.decode_matrix(mat, k, [0], list(range(1, k + 1)))
            one = torch.empty((b, 1, s), dtype=torch.uint8, device=dev)
            got = gf_kernels.gf_matmul_gen(row, data, out=one).clone()
            shape["gen_r1"] = {
                "exact": torch.equal(got, gf_kernels.gf_matmul_gen_plain(
                    row, data)),
                **times(lambda: gf_kernels.gf_matmul_gen(row, data, out=one),
                        b * (k + 1) * s)}
            shape["exact"] = shape["exact"] and shape["gen_r1"]["exact"]
        shapes.append(shape)
        del data, out, got
    mat = rs.reed_sol_van_matrix(8, 3)
    for name, lost, b, s in GF_DECODE_SHAPES:
        rows = rs.decode_matrix(mat, 8, list(lost), [
            i for i in range(11) if i not in lost][:8])
        r = rows.shape[0]
        data = torch.randint(0, 256, (b, 8, s), dtype=torch.uint8,
                             device=dev, generator=gen)
        out = torch.empty((b, r, s), dtype=torch.uint8, device=dev)
        got = gf_kernels.gf_matmul_gen(rows, data, out=out).clone()
        shapes.append({
            "shape": name, "kernel": "gf_matmul_gen", "stripes": b, "k": 8,
            "rows": r, "chunk": s,
            "exact": torch.equal(got, gf_kernels.gf_matmul_gen_plain(
                rows, data)),
            **times(lambda: gf_kernels.gf_matmul_gen(rows, data, out=out),
                    b * (8 + r) * s),
            "read_ms": read_ms(data)})
        del data, out, got
    return shapes


def host_us(fn, reps: int = HOST_REPS) -> float:
    """Host microseconds per call of fn over `reps` calls enqueued without
    a wait (the card keeps up or the queue absorbs them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def kernel_ms(fn, name: str, reps: int = REPS) -> float | None:
    """Median device duration in ms of the kernels whose name holds `name`
    over `reps` calls of fn, from torch.profiler (None if it saw none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durations = [e.time_range.elapsed_us() for e in prof.events()
                 if name in e.name and str(getattr(
                     e, "device_type", "")).endswith("CUDA")]
    return statistics.median(durations) / 1e3 if durations else None


def gen_host_us(dev) -> dict:
    """Host microseconds per gf_matmul_gen call on a one-row decode of one
    16-byte stripe: the wrapper, and its C entry called alone."""
    from ceph_tpu_torch.models import reed_solomon as rs
    from ceph_tpu_torch.ops import _build, gf_kernels
    row = rs.decode_matrix(rs.reed_sol_van_matrix(8, 3), 8, [0],
                           list(range(1, 9)))
    data = torch.zeros((1, 8, 16), dtype=torch.uint8, device=dev)
    out = torch.empty((1, 1, 16), dtype=torch.uint8, device=dev)
    lib = _build.load()["gf_matmul"]
    args = (row.ctypes.data, 1, 8, dev.index or 0, data.data_ptr(),
            out.data_ptr(), 1, 16, torch.cuda.current_stream(dev).cuda_stream)

    return {"wrapper": host_us(lambda: gf_kernels.gf_matmul_gen(
        row, data, out=out)), "c_entry": host_us(
        lambda: lib.gf_matmul_gen(*args))}


SCORE_SHAPES = ((1, 65536), (256, 65536))
SCORE_OPS_PER_TERM = 4      # multiply, log2, multiply-add into the sum
SCORE_WORDS = (b"object ", b"placement ", b"group ", b"the ", b"erasure ",
               b"coded ", b"shard ", b"of ", b"store ", b"a ")


def score_ops(b: int, s: int) -> int:
    """Lane-operations score_blocks needs for a (b, s) batch: one histogram
    increment per byte, one compare-and-count per (position, lag) pair with
    position >= lag, and the entropy's terms over 256 bins."""
    from ceph_tpu_torch.ops import score_kernels

    pairs = sum(s - lag for lag in score_kernels.PROBE_LAGS if lag < s)
    return b * (s + pairs + 256 * SCORE_OPS_PER_TERM)


def score_text(size: int, rng) -> np.ndarray:
    """`size` bytes of English-like text (ten words at random)."""
    words = np.array(SCORE_WORDS)
    return np.frombuffer(b"".join(rng.choice(words, size // 5 + 1))[:size]
                         .ljust(size), np.uint8)


# csrc/compress_score.cu's text with parts cut out: (text, replacement)
_NO_HISTOGRAM = ("if (!kEdge || i < len)\n      atomicAdd",
                 "if (false)\n      atomicAdd")
_NO_LAGS = ("acc = (uint32_t)__dp4a(", "(void)f;\n  if (false) acc = "
            "(uint32_t)__dp4a(")
SCORE_CUTS = {"no histogram": (_NO_HISTOGRAM,), "no lags": (_NO_LAGS,),
              "neither": (_NO_HISTOGRAM, _NO_LAGS)}


def cut_source(src: str, cuts) -> str:
    """csrc/compress_score.cu with each (text, replacement) applied; the
    text must occur exactly once."""
    for text, new in cuts:
        if src.count(text) != 1:
            raise RuntimeError(f"{text!r} is not found once in"
                               " csrc/compress_score.cu")
        src = src.replace(text, new)
    return src


def score_cuts(dev) -> dict:
    """{cut: {shape: kernel ms}} for the SCORE_CUTS copies, each built
    beside the library and swapped into the wrapper for its timings."""
    from ceph_tpu_torch.ops import _build, score_kernels

    rng = np.random.default_rng(SEED)
    data = {(b, s): torch.from_numpy(score_text(b * s, rng).reshape(b, s)
                                     .copy()).to(dev)
            for b, s in SCORE_SHAPES}
    score_kernels.score_blocks_packed(data[SCORE_SHAPES[0]])
    real = score_kernels._launch
    res = {}
    try:
        for name, cuts in SCORE_CUTS.items():
            stem = "cut-" + name.replace(" ", "-")
            src = _build.BUILD_DIR / f"{stem}.cu"
            lib = _build.BUILD_DIR / f"{stem}.so"
            src.write_text(cut_source((_build.SRC_DIR / "compress_score.cu")
                                      .read_text(), cuts))
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                            str(lib), str(src)], check=True,
                           capture_output=True, timeout=600)
            cdll = ctypes.CDLL(str(lib))
            for fn, argtypes in _build._SIGNATURES["compress_score"].items():
                getattr(cdll, fn).argtypes = argtypes
                getattr(cdll, fn).restype = ctypes.c_int
            score_kernels._launch = cdll.score_blocks
            res[name] = {f"{b}x{s}": kernel_ms(
                lambda t=t: score_kernels.score_blocks_packed(t),
                "score_kernel") for (b, s), t in data.items()}
    finally:
        score_kernels._launch = real
    return res


def score_shapes(dev) -> list:
    from ceph_tpu_torch.compressor import scoring
    from ceph_tpu_torch.ops import score_kernels

    rng = np.random.default_rng(SEED)
    shapes = []
    for b, s in SCORE_SHAPES:
        host = score_text(b * s, rng).reshape(b, s)
        blocks = torch.from_numpy(host.copy()).to(dev)
        hist, entropy, match = score_kernels.score_blocks(blocks)
        p_hist, p_entropy, p_match = score_kernels.score_blocks_plain(blocks)
        exact = (torch.equal(hist, p_hist) and torch.equal(
            match.view(torch.int32), p_match.view(torch.int32))
            and float((entropy - p_entropy).abs().max())
            <= score_kernels.ENTROPY_TOL)
        t_bytes = (b * s + b * (256 * 4 + 8)) / HBM_BYTES_PER_S * 1e3
        t_ops = score_ops(b, s) / INT_OPS_PER_S * 1e3
        row = {"shape": [b, s], "exact": exact,
               "ms": alone_ms(lambda: score_kernels.score_blocks(blocks)),
               "back_to_back_ms": back_to_back_ms(
                   lambda: score_kernels.score_blocks(blocks)),
               "kernel_ms": kernel_ms(
                   lambda: score_kernels.score_blocks(blocks),
                   "score_kernel"),
               "host_us": host_us(
                   lambda: score_kernels.score_blocks(blocks)),
               "bound_ms": max(t_bytes, t_ops), "bytes_bound_ms": t_bytes,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        row["share"] = row["bound_ms"] / row["kernel_ms"]
        if b == 1:
            row["decision_host_us"] = host_us(
                lambda: scoring.compress_decision(host, device=dev),
                reps=REPS * 10)
        shapes.append(row)
        del blocks
    return shapes


def crush_map_10k():
    """BASELINE config 4's map with the replicated rule (rule 0) and the
    EC rule of tests/test_crush.py (rule 1)."""
    from ceph_tpu_torch.crush.map import (
        CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_EMIT,
        CRUSH_RULE_SET_CHOOSELEAF_TRIES, CRUSH_RULE_TAKE, Rule, RuleStep,
        build_flat_cluster)
    cmap = build_flat_cluster(10000, osds_per_host=20, hosts_per_rack=10)
    cmap.add_simple_rule("data", "default", "host", mode="firstn")
    cmap.add_rule(Rule("ec", [
        RuleStep(CRUSH_RULE_SET_CHOOSELEAF_TRIES, 5),
        RuleStep(CRUSH_RULE_TAKE, cmap.name_to_item("default")),
        RuleStep(CRUSH_RULE_CHOOSELEAF_INDEP, 0, cmap.type_id("host")),
        RuleStep(CRUSH_RULE_EMIT)], rule_type=3))
    return cmap


def crush_weights(cmap, seed: int = SEED) -> dict:
    """{"all in": ..., "rebalance": ...}: the rebalance vector puts a
    seeded 5% of the devices out (0) and another 10% at 0x8000."""
    n = cmap.max_devices
    order = np.random.default_rng(seed).permutation(n)
    w = np.full(n, 0x10000, dtype=np.int64)
    w[order[: n // 20]] = 0
    w[order[n // 20: n // 20 + n // 10]] = 0x8000
    return {"all in": cmap.full_weight_vector(), "rebalance": w.tolist()}


def random_crush_case(seed: int, levels: int, firstn: bool, leaf: bool,
                      result_max: int, numrep_past: int = 0):
    """A seeded random straw2 hierarchy with one rule (rule 0) and a weight
    vector -> (cmap, weight, numrep).

    root (type `levels`) -> ... -> devices, bucket sizes 1-12 (1 once 120
    devices exist), item weights including 0 and buckets at weight 0;
    random tunables (chooseleaf_vary_r 0-3, chooseleaf_stable,
    chooseleaf_descend_once, choose_total_tries 1-19); the rule takes the
    root, then CHOOSE(LEAF)_FIRSTN or _INDEP to a random type (with `leaf`
    and levels > 1, CHOOSELEAF to a type above the devices) with numrep in
    (-result_max, result_max + numrep_past], at times after a
    SET_CHOOSELEAF_TRIES step; the weight vector puts devices out, partly
    in and in."""
    from ceph_tpu_torch.crush.map import (
        CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP,
        CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
        CRUSH_RULE_SET_CHOOSELEAF_TRIES, CRUSH_RULE_TAKE, CrushMap, Rule,
        RuleStep)
    rng = np.random.default_rng(seed)
    cmap = CrushMap()
    cmap.types = {t: f"t{t}" for t in range(levels + 1)}
    weights = (0, 0x8000, 0x10000, 0x10000, 0x30000)

    def build(level: int):
        if level == 0:
            dev = cmap.max_devices
            cmap.add_device(dev)
            w = int(rng.choice(weights)) if rng.random() < 0.8 else int(
                rng.integers(1, 0x40000))
            return dev, w
        b = cmap.add_bucket(None, level, f"b{len(cmap.buckets)}")
        size = int(rng.integers(1, 13)) if cmap.max_devices < 120 else 1
        for _ in range(size):
            item, w = build(level - 1)
            b.add_item(item, w)
        return b.id, (b.weight if rng.random() < 0.9 else 0)

    root, _ = build(levels)
    cmap.chooseleaf_vary_r = int(rng.integers(0, 4))
    cmap.chooseleaf_stable = int(rng.integers(0, 2))
    cmap.chooseleaf_descend_once = int(rng.integers(0, 2))
    cmap.choose_total_tries = int(rng.integers(1, 20))
    leaf = leaf and levels > 1
    target = int(rng.integers(1 if leaf else 0, levels))
    if leaf:
        op = (CRUSH_RULE_CHOOSELEAF_FIRSTN if firstn
              else CRUSH_RULE_CHOOSELEAF_INDEP)
    else:
        op = CRUSH_RULE_CHOOSE_FIRSTN if firstn else CRUSH_RULE_CHOOSE_INDEP
    numrep = int(rng.integers(-result_max + 1, result_max + numrep_past + 1))
    steps = [RuleStep(CRUSH_RULE_TAKE, root), RuleStep(op, numrep, target),
             RuleStep(CRUSH_RULE_EMIT)]
    if rng.random() < 0.5:
        steps.insert(0, RuleStep(CRUSH_RULE_SET_CHOOSELEAF_TRIES,
                                 int(rng.integers(1, 6))))
    cmap.add_rule(Rule("r", steps))
    weight = [int(rng.choice((0, 0x4000, 0xC000, 0x10000, 0x10000)))
              for _ in range(cmap.max_devices)]
    return cmap, weight, numrep


def reweight_devices(cmap, weight_of) -> None:
    """Give every device item the weight weight_of(device) and every bucket
    above the sum of its items' weights, level by level."""
    for b in cmap.buckets.values():
        b.weights = [weight_of(i) if i >= 0 else w
                     for i, w in zip(b.items, b.weights)]
    depth = {}

    def height(bid: int) -> int:
        if bid not in depth:
            depth[bid] = 1 + max((height(i) for i in cmap.buckets[bid].items
                                  if i < 0), default=0)
        return depth[bid]

    for bid in sorted(cmap.buckets, key=height):
        b = cmap.buckets[bid]
        b.weights = [cmap.buckets[i].weight if i < 0 else w
                     for i, w in zip(b.items, b.weights)]


def crush_ops(stats: dict) -> tuple:
    """(instructions, of which only the ALU pipe can issue, of which only
    the FMA pipe can) that the placement arithmetic of one run needs, from
    the plain version's counts of draws and is_out hashes."""
    draws, hashes = stats["draws"], stats["is_out_hashes"]
    return (draws * DRAW_OPS + hashes * IS_OUT_OPS,
            draws * DRAW_ALU_OPS + hashes * IS_OUT_ALU_OPS,
            draws * DRAW_FMA_OPS)


def crush_bound_ms(stats: dict, n: int, result_max: int) -> float:
    """The operations bound: the largest of the issue time, the ALU pipe's
    time for what only it can issue and the FMA pipe's likewise (what
    either can issue, they share: together they match the issue rate); the
    bytes (inputs, outputs and a 0.8 MB map) take under a hundredth of
    it."""
    ops, alu, fma = crush_ops(stats)
    return max(ops / INT_OPS_PER_S, alu / PIPE_OPS_PER_S,
               fma / PIPE_OPS_PER_S,
               4 * n * (1 + result_max) / HBM_BYTES_PER_S) * 1e3


class CrushShape(NamedTuple):
    """One rule and weight vector of crush_shapes: `row` is what this
    script prints; the rest is what chip_smoke.py checks further."""

    row: dict
    cmap: object
    ruleno: int
    weight: list
    got: torch.Tensor          # the kernel's placements of all inputs


# the counting build: one line at the head of the straw2 loop (of the
# one-thread-per-input design, or of the one whose lanes may share a bucket)
# adds the trip and its active lanes (the leader of __activemask() does)
STRAW2_LOOP_HEADS = ("for (int i = 0; i < size; ++i) {",
                     "for (int i = g.sub; i < size; i += g.size) {")
_COUNT_HEAD = """#include <cuda_runtime.h>
__device__ unsigned long long crush_lane_counts_[2];
#define CRUSH_COUNT_TRIP() do { const unsigned m_ = __activemask(); \\
  if ((threadIdx.x & 31u) == (unsigned)(__ffs(m_) - 1)) { \\
    atomicAdd(&crush_lane_counts_[0], 1ull); \\
    atomicAdd(&crush_lane_counts_[1], (unsigned long long)__popc(m_)); \\
  } } while (0)
"""
_COUNT_TAIL = """
// trips and active lanes counted since the last call, which zeroes them
extern "C" int crush_lane_counts(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, crush_lane_counts_,
                                         sizeof(crush_lane_counts_));
  const unsigned long long zero[2] = {0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(crush_lane_counts_, zero, sizeof(zero));
  return (int)err;
}
"""


def with_trip_count(src: str) -> str:
    """csrc/crush.cu's text with CRUSH_COUNT_TRIP(); at the head of its
    straw2 loop."""
    heads = [h for h in STRAW2_LOOP_HEADS if src.count(h) == 1]
    if len(heads) != 1:
        raise RuntimeError("the straw2 loop's head is not found once in"
                           " csrc/crush.cu")
    return src.replace(heads[0], heads[0] + " CRUSH_COUNT_TRIP();")


def counting_source(src: str) -> str:
    """csrc/crush.cu with the lane count at the head of its straw2 loop."""
    return _COUNT_HEAD + with_trip_count(src) + _COUNT_TAIL


def counting_library(build):
    """Build the counting copy of the checkout's csrc/crush.cu beside its
    libraries and load it, with the argument types of the real one."""
    build.load()
    src = build.BUILD_DIR / "count-crush.cu"
    lib = build.BUILD_DIR / "count-crush.so"
    src.write_text(counting_source((build.SRC_DIR / "crush.cu")
                                   .read_text()))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, timeout=600)
    cdll = ctypes.CDLL(str(lib))
    for fn, argtypes in build._SIGNATURES["crush"].items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = ctypes.c_int
    cdll.crush_lane_counts.argtypes = (ctypes.c_void_p,)
    cdll.crush_lane_counts.restype = ctypes.c_int
    return cdll


def lane_utilization(build, counting, run) -> float:
    """Active lanes over 32 x trips of the straw2 loop in one launch of
    `run` through the counting library."""
    libs = build.load()
    real = libs["crush"]
    counts = (ctypes.c_ulonglong * 2)()
    libs["crush"] = counting
    try:
        build.check(counting.crush_lane_counts(ctypes.addressof(counts)),
                    "crush_lane_counts")
        run()
        torch.cuda.synchronize()
        build.check(counting.crush_lane_counts(ctypes.addressof(counts)),
                    "crush_lane_counts")
    finally:
        libs["crush"] = real
    return counts[1] / (32 * counts[0])


def crush_shapes(dev) -> List[CrushShape]:
    """Each rule and weight vector on the 10,000-OSD map: the kernel over
    all CRUSH_INPUTS inputs held against the plain version (which counts
    the draws and is_out hashes for the bound), then timed, and its straw2
    lane utilization counted."""
    from ceph_tpu_torch.crush import kernel as ck
    from ceph_tpu_torch.ops import _build, crush_kernels
    counting = counting_library(_build)
    cmap = crush_map_10k()
    xs = torch.arange(CRUSH_INPUTS, dtype=torch.int32, device=dev)
    shapes = []
    for wname, weight in crush_weights(cmap).items():
        dm = ck.DenseMap.from_crush_map(cmap, weight, dev)
        for rname, ruleno, rmax in CRUSH_RULES:
            prog = ck.rule_program(cmap, ruleno, rmax)
            out = torch.empty((CRUSH_INPUTS, rmax), dtype=torch.int32,
                              device=dev)
            run = lambda: crush_kernels.crush_do_rule_batch(dm, prog, xs,
                                                            out=out)
            got = run().clone()
            stats = {}
            t0 = time.perf_counter()
            want = ck.crush_do_rule_batch_plain(dm, prog, xs, stats)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            mism = int((got != want).any(1).sum())
            row = {
                "rule": rname, "weights": wname, "inputs": CRUSH_INPUTS,
                "result_max": rmax, "exact": mism == 0,
                "mismatches_vs_plain": mism,
                "max_abs_err": int((got.long() - want.long()).abs().max()),
                "ms": alone_ms(run), "back_to_back_ms": back_to_back_ms(run),
                "bound_ms": crush_bound_ms(stats, CRUSH_INPUTS, rmax),
                "draws_per_input": stats["draws"] / CRUSH_INPUTS,
                "is_out_hashes_per_input": stats["is_out_hashes"]
                / CRUSH_INPUTS,
                "lane_utilization": lane_utilization(_build, counting, run),
                "plain_ms": plain_ms}
            row["bound_share"] = row["bound_ms"] / row["back_to_back_ms"]
            shapes.append(CrushShape(row, cmap, ruleno, weight, got))
            del want, out
    return shapes


def ptxas_lines(build) -> list:
    """ptxas's register and spill lines for the GF kernels at R = 1 and
    R = 3."""
    log = build.build_logs().get("gf_matmul", "").splitlines()
    keep, on = [], False
    for line in log:
        if "Compiling entry function" in line:
            on = bool(_GF_FUNC.search(line))
            if on:
                keep.append(line.split("'")[1])
        elif on and ("registers" in line or "spill" in line):
            keep.append(line.strip())
    return keep


# instruction forms of the spec kernel, by (opcode, operands)
FORMS = {
    "(xor: lop3 0x3c or 0x96)": lambda op, a: op.startswith("LOP3") and (
        a.rstrip().endswith(("0x3c, !PT", "0x96, !PT"))),
    "(mask test: lop3 to a predicate)": lambda op, a: op.startswith(
        "LOP3") and a.startswith("P"),
    "(xtime: shr by 7)": lambda op, a: (op.startswith("SHF.R")
                                        and ", 0x7," in a),
}


def sass_counts(build) -> dict:
    """{GF kernel at R = 1 or 3: {opcode: count}} from cuobjdump -sass."""
    counts = {}
    for name, code in _sass(build, "gf_matmul").items():
        if not _GF_FUNC.search(name):
            continue
        cur = counts[name] = collections.Counter()
        for _, pred, op, args in code:
            cur[op.split(".")[0]] += 1
            if pred:
                cur["(predicated)"] += 1
            for form, hit in FORMS.items():
                if hit(op, args):
                    cur[form] += 1
    return {name: dict(c.most_common()) | {"total": sum(
        v for k, v in c.items() if not k.startswith("("))}
        for name, c in counts.items()}


_SASS_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                        r"([A-Z]\S*)\s*([^;]*)")


def _sass(build, stem: str) -> dict:
    """{function: [(address, predicate, opcode, operands)]} from
    cuobjdump -sass of the newest library built from csrc/<stem>.cu."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    libs = sorted(build.BUILD_DIR.glob(f"{stem}-*.so"),
                  key=lambda p: p.stat().st_mtime)
    return parse_sass(subprocess.run(
        [tool, "-sass", str(libs[-1])], capture_output=True, text=True,
        timeout=300).stdout)


def parse_sass(text: str) -> dict:
    """cuobjdump -sass text -> {function: [(address, predicate, opcode,
    operands)]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _SASS_LINE.match(line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(2),
                        m.group(3).rstrip(";"), m.group(4).strip()))
    return funcs


def draw_paths(code: list) -> list:
    """The straw2 draw loops of crush_kernel's SASS (parse_sass's list for
    the function) and the instructions a draw executes in each, all and by
    the pipes that can issue them (`pipe`).

    A loop is the span from a backward branch's target to the branch; the
    draw loops are the innermost loops that CALL a routine (the signed
    64-bit division of the earlier design) or load from shared memory
    (LDS: the ln tables); each inlined copy of straw2 gives one.  A draw
    executes at least the shortest path from the loop's head to its branch
    through the CALL and the routine's shortest path to its RET, or, in a
    loop with no CALL, through an LDS; the paths skip what a draw need not
    run (a dead item, the division's 32-bit fast path, which the 48-bit
    dividend never takes, and crush_ln's normalisation when the hash is
    large)."""
    at = {a: i for i, (a, _, _, _) in enumerate(code)}

    def target(ops: str):
        m = re.search(r"0x([0-9a-f]+)", ops)
        return at.get(int(m.group(1), 16)) if m else None

    def succ(i: int) -> list:
        _, pred, op, ops = code[i]
        if op.startswith(("EXIT", "RET")):
            return [i + 1] if pred else []
        if op.startswith("BRA"):
            t = target(ops)
            # a predicate, or a second one before the target: conditional
            return [i + 1, t] if pred or "," in ops else [t]
        return [i + 1]

    def path(src: int, dst: int, lo: int, hi: int) -> list | None:
        """The instructions executed from src to dst inclusive (BFS)."""
        prev, frontier = {src: None}, [src]
        while frontier and dst not in prev:
            nxt = []
            for i in frontier:
                for j in succ(i):
                    if j is not None and lo <= j <= hi and j not in prev:
                        prev[j] = i
                        nxt.append(j)
            frontier = nxt
        if dst not in prev:
            return None
        out = [dst]
        while prev[out[-1]] is not None:
            out.append(prev[out[-1]])
        return out[::-1]

    def routine(start: int) -> list | None:
        ret = next(i for i in range(start, len(code))
                   if code[i][2].startswith("RET"))
        return path(start, ret, start, ret)

    def pipes(parts) -> collections.Counter:
        return collections.Counter(pipe(code[i][2])
                                   for part in parts for i in part)

    loops = [(target(ops), i) for i, (_, _, op, ops) in enumerate(code)
             if op.startswith("BRA") and target(ops) is not None
             and target(ops) <= i]
    inner = [(s, e) for s, e in loops
             if not any(s <= s2 and e2 <= e and (s2, e2) != (s, e)
                        for s2, e2 in loops)]
    draws = []
    for s, e in inner:
        calls = [c for c in range(s, e + 1) if code[c][2].startswith("CALL")]
        shared = [c for c in range(s, e + 1) if code[c][2].startswith("LDS")]
        found = []
        for c in calls:
            parts = (path(s, c, s, e), routine(target(code[c][3])),
                     path(c + 1, e, s, e))
            found.append((c, parts))
        if not calls:
            for c in shared:
                head, tail = path(s, c, s, e), path(c, e, s, e)
                found.append((c, (head, [], tail[1:] if tail else None)))
            found = sorted((f for f in found if None not in f[1]),
                           key=lambda f: sum(map(len, f[1])))[:1]
        for c, parts in found:
            ok = None not in parts
            n = [None if part is None else len(part) for part in parts]
            by_pipe = pipes(parts) if ok else {}
            draws.append({"loop": [hex(code[s][0]), hex(code[e][0])],
                          "span": e - s + 1, "via": code[c][2],
                          "to_via": n[0], "routine": n[1], "after_via": n[2],
                          "per_draw": sum(n) if ok else None,
                          **{f"{k}_per_draw": by_pipe.get(k, 0) if ok
                             else None for k in ("alu", "fma", "either")}})
    return draws


def crush_sass(build) -> dict:
    """The per-draw instruction counts of crush_kernel (draw_paths), beside
    the DRAW_OPS, DRAW_ALU_OPS and DRAW_FMA_OPS that the bound takes."""
    funcs = _sass(build, "crush")
    name = next(n for n in funcs if "crush_kernel" in n)
    draws = draw_paths(funcs[name])
    done = [d for d in draws if d["per_draw"] is not None]
    least = min(done, key=lambda d: d["per_draw"], default=None)
    return {"function": name, "instructions": len(funcs[name]),
            "draw_loops": draws,
            "min_per_draw": least and least["per_draw"],
            "alu_per_draw_on_it": least and least["alu_per_draw"],
            "fma_per_draw_on_it": least and least["fma_per_draw"],
            "DRAW_OPS": DRAW_OPS, "DRAW_ALU_OPS": DRAW_ALU_OPS,
            "DRAW_FMA_OPS": DRAW_FMA_OPS}


def xsched_shapes(dev) -> tuple:
    """chip_smoke.py's phase 3n (a) on the package first on sys.path, as
    shape rows, and the host microseconds of a region-entry call."""
    import importlib.util

    from ceph_tpu_torch.ec import xsched
    from ceph_tpu_torch.ec.registry import create_erasure_code
    from ceph_tpu_torch.ops import xor_kernels
    # the phase times with this script's helpers whatever the root's
    # copy of this module holds: chip_smoke imports them by module name
    sys.modules["ceph_tpu_torch.tools.kernel_shapes"] = sys.modules[__name__]
    script = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("xsched_chip_smoke",
                                                  script)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = smoke.xsched_kernels(torch, dev, card_name())
    rows = [{"entry": entry, "name": name, "exact": r["max_abs_err"] == 0,
             **{key: r[key] for key in ("ms", "back_to_back_ms",
                                        "queued_ms", "plain_ms", "bound_ms",
                                        "bound_by")},
             **({"gen_ms": r["gf_matmul_gen_ms"],
                 "gen_back_to_back_ms": r["gf_matmul_gen_back_to_back_ms"],
                 "gen_queued_ms": r["gf_matmul_gen_queued_ms"]}
                if entry == "gf" else {})}
            for entry in ("regions", "gf")
            for name, r in got[entry].items()]
    codec = create_erasure_code({**smoke.XSCHED_PROFILES["liberation"],
                                 "device": str(dev)})
    prog = xsched.lower_program(xsched.compile_matrix(codec.bitmatrix,
                                                      sig=codec._sig))
    arena = torch.zeros((1, prog.n_regions, smoke.XSCHED_PS),
                        dtype=torch.uint8, device=dev)
    return rows, host_us(lambda: xor_kernels.xor_sched_regions(prog, arena))


EMPTY_SOURCE = """#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""
BLOOM_SEAL = 16             # a seal's hashes: the median PG of a 3g period
BLOOM_BIG = 65536
WAVE_SPIN = 200_000_000     # cycles the card waits before a queued wave loop


def empty_library(build):
    """An empty kernel behind a plain C entry, built with the checkout's
    flags beside its libraries and loaded with ctypes, as the port's
    kernels are."""
    build.load()
    src = build.BUILD_DIR / "empty.cu"
    lib = build.BUILD_DIR / "empty.so"
    src.write_text(EMPTY_SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, timeout=600)
    cdll = ctypes.CDLL(str(lib))
    cdll.empty_launch.argtypes = (ctypes.c_void_p,)
    cdll.empty_launch.restype = ctypes.c_int
    return cdll


def bloom_shapes(dev) -> dict:
    """The hit-set kernels of the root's package at the tier's geometry
    (6,385 bits, nhash 4), each checked against its plain version and numpy
    and timed queued, by its own device time and by the host's time a
    call: bloom_positions at 65,536 hashes, a seal of 16 hashes and a
    rotation wave (chip_smoke.py phase 3g's last period of its Zipf trace,
    one set a PG), the wave as the tier seals it (one insert_batch a set)
    and, where the package has it, as one bloom_seal launch
    (bloom_kernels.seal_host); with the queued time of an empty kernel
    launched through ctypes the same way."""
    import importlib.util

    from ceph_tpu_torch.ops import _build, bloom_kernels
    from ceph_tpu_torch.osd import hitset

    script = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("bloom_chip_smoke", script)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    nbits, nhash = hitset.bloom_geometry(1024, 0.05)
    has_seal = hasattr(bloom_kernels, "bloom_seal")
    stream = torch.cuda.current_stream(dev).cuda_stream
    empty = empty_library(_build)
    res = {"nbits": nbits, "nhash": nhash, "has_seal": has_seal,
           "empty_kernel_queued_ms": queued_ms(
               lambda: empty.empty_launch(stream)),
           "empty_kernel_host_us": host_us(
               lambda: empty.empty_launch(stream))}
    rng = np.random.default_rng(SEED)
    trace = smoke.zipf_indices(1.1, smoke.TIER_OIDS, smoke.TIER_READS,
                               seed=smoke.SEED)
    pgs = [hitset.hash_oid(f"obj{i}") % smoke.TIER_PGS
           for i in range(smoke.TIER_OIDS)]
    shapes = {
        f"{BLOOM_BIG}x{nhash}": [rng.integers(0, 1 << 32, BLOOM_BIG,
                                              dtype=np.uint64)
                                 .astype(np.uint32)],
        f"seal of {BLOOM_SEAL}": [rng.integers(0, 1 << 32, BLOOM_SEAL,
                                               dtype=np.uint64)
                                  .astype(np.uint32)],
        "wave": smoke.period_sets(trace, pgs,
                                  smoke.TIER_READS - smoke.TIER_ROTATE)}
    rows = []
    for shape, sets in shapes.items():
        n = sum(h.size for h in sets)
        words, values = smoke.seal_numpy_words(hitset, sets, nbits, nhash)
        dense = np.zeros(len(sets) * ((nbits + 31) // 32), dtype=np.int32)
        dense[words] = values
        numpy_bits = dense.view(np.uint8).reshape(len(sets), -1)[
            :, :(nbits + 7) // 8]
        # the parent's route: one positions launch a set of at least
        # DEVICE_MIN_BATCH hashes, and insert_batch a set on the host clock
        big = [torch.from_numpy(h.view(np.int32)).to(dev) for h in sets
               if h.size >= hitset.DEVICE_MIN_BATCH]
        outs = [torch.empty((t.shape[0], nhash), dtype=torch.int32,
                            device=dev) for t in big]

        def positions():
            for t, o in zip(big, outs):
                bloom_kernels.bloom_positions(t, nbits, nhash, out=o)

        exact = all(torch.equal(bloom_kernels.bloom_positions(t, nbits,
                                                              nhash),
                                bloom_kernels.bloom_positions_plain(
                                    t, nbits, nhash)) for t in big)

        def insert_each():
            for h in sets:
                hitset.BloomHitSet(nbits=nbits, nhash=nhash).insert_batch(
                    h, device=dev)

        got = []
        for h in sets:
            hs = hitset.BloomHitSet(nbits=nbits, nhash=nhash)
            hs.insert_batch(h, device=dev)
            got.append(hs.bits)
        exact = exact and np.array_equal(np.array(got), numpy_bits)
        pos_bytes = 4 * n + 4 * n * nhash
        t_bytes = pos_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n * nhash * smoke.BLOOM_OPS_PER_POSITION / INT_OPS_PER_S * 1e3
        wave = len(sets) > 1
        rows.append({
            "shape": shape, "route": "bloom_positions a set", "sets":
            len(sets), "hashes": n, "launches": len(big), "exact": exact,
            "queued_ms": queued_ms(positions, reps=5 if wave else REPS,
                                   spin_cycles=WAVE_SPIN if wave
                                   else 5_000_000),
            "kernel_ms": kernel_ms(positions, "bloom_positions_kernel"),
            "host_us": host_us(positions, reps=50 if wave else HOST_REPS),
            "insert_batch_ms": statistics.median(
                _host_ms(insert_each) for _ in range(REPS)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        if not has_seal:
            continue
        sizes = [h.size for h in sets]
        offsets = np.zeros(len(sets) + 1, dtype=np.int32)
        np.cumsum(sizes, out=offsets[1:])
        t_h = torch.from_numpy(np.concatenate(sets).view(np.int32)).to(dev)
        t_o = torch.from_numpy(offsets).to(dev)
        out = torch.empty((len(sets), bloom_kernels.seal_words(nbits)),
                          dtype=torch.int32, device=dev)

        def seal():
            bloom_kernels.bloom_seal(t_h, t_o, nbits, nhash, max(sizes),
                                     out=out)

        seal()
        nbytes = (nbits + 7) // 8
        words = out.cpu().numpy().view(np.uint8)
        exact = (torch.equal(out, bloom_kernels.bloom_seal_plain(
            t_h, t_o, nbits, nhash)) and not words[:, nbytes:].any()
            and np.array_equal(words[:, :nbytes], numpy_bits)
            and np.array_equal(bloom_kernels.seal_host(
                np.concatenate(sets), offsets, nbits, nhash, dev),
                numpy_bits))
        seal_bytes = 4 * n + 4 * (len(sets) + 1) + out.numel() * 4
        t_bytes = seal_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n * nhash * smoke.SEAL_OPS_PER_POSITION / INT_OPS_PER_S * 1e3
        rows.append({
            "shape": shape, "route": "bloom_seal", "sets": len(sets),
            "hashes": n, "launches": 1, "exact": exact,
            "queued_ms": queued_ms(seal),
            "kernel_ms": kernel_ms(seal, "bloom_seal_kernel"),
            "host_us": host_us(seal),
            "seal_host_ms": statistics.median(
                _host_ms(lambda: bloom_kernels.seal_host(
                    np.concatenate(sets), offsets, nbits, nhash, dev))
                for _ in range(REPS)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    res["shapes"] = rows
    return res


def _host_ms(fn) -> float:
    """Host ms of one call of fn that ends in a synchronisation."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=("crc", "gf", "crush", "score",
                                       "xsched", "bloom"))
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--cuts", action="store_true",
                    help="score: also time copies of the kernel with the"
                    " histogram, the lag counts or both cut out")
    ap.add_argument("--sass", action="store_true",
                    help="gf: count the GF kernels' SASS instructions;"
                    " crush: count the straw2 draw loop's")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    if not torch.cuda.is_available():
        sys.exit("kernel_shapes: needs a CUDA card")
    from ceph_tpu_torch.ops import _build
    if not Path(_build.__file__).resolve().is_relative_to(root):
        sys.exit(f"kernel_shapes: imported {_build.__file__}, not {root}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    res = {"root": str(root), "card": card_name(), "kernel": args.kernel}
    if args.kernel == "crc":
        res["shapes"] = crc_shapes(dev, gen)
    elif args.kernel == "crush":
        res["shapes"] = [shape.row for shape in crush_shapes(dev)]
        res["build_seconds"] = _build.build_seconds
        res["ptxas"] = [line.strip() for line in _build.build_logs().get(
            "crush", "").splitlines() if "registers" in line
            or "spill" in line]
        if args.sass:
            res["sass"] = crush_sass(_build)
    elif args.kernel == "xsched":
        res["shapes"], res["host_us"] = xsched_shapes(dev)
        res["ptxas"] = [line.strip() for line in _build.build_logs().get(
            "xor_sched", "").splitlines() if "registers" in line
            or "spill" in line or "smem" in line]
    elif args.kernel == "bloom":
        res.update(bloom_shapes(dev))
        res["ptxas"] = [line.strip() for line in _build.build_logs().get(
            "hitset_bloom", "").splitlines() if "registers" in line
            or "spill" in line or "smem" in line]
    elif args.kernel == "score":
        res["shapes"] = score_shapes(dev)
        if args.cuts:
            res["cuts"] = score_cuts(dev)
        res["ptxas"] = [line.strip() for line in _build.build_logs().get(
            "compress_score", "").splitlines() if "registers" in line
            or "spill" in line or "smem" in line]
    else:
        res["shapes"] = gf_shapes(dev, gen)
        res["gen_host_us"] = gen_host_us(dev)
        res["build_seconds"] = _build.build_seconds
        res["ptxas"] = ptxas_lines(_build)
        if args.sass:
            res["sass"] = sass_counts(_build)
    print(json.dumps(res))
    if not all(s["exact"] for s in res["shapes"]):
        sys.exit("kernel_shapes: a kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
