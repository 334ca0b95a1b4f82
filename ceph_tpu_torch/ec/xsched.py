"""Plan-time XOR-schedule compiler for the GF(2) bitmatrix family (port
of ceph_tpu/ec/xsched.py, which has no JAX in it: the port keeps its own
copy, with the same compiler, so the same matrix compiles to the same
program in both packages).

The XOR-EC program-optimization literature (arXiv:2108.02692) treats
an erasure code's bit matrix as a PROGRAM, not an operand: every
output row is an XOR of input columns, shared sub-XORs can be
computed once (common-subexpression elimination), the resulting ops
can be scheduled for temporary locality, and the whole compiled
artifact memoized.  This module is that compiler:

* **CSE pass** — greedy pairwise extraction (Paar's algorithm):
  repeatedly find the column pair shared by the most output rows,
  hoist it into a temporary, and substitute.  Each extraction with
  multiplicity c saves c-1 XOR region ops.
* **Scheduling pass** — temporaries are emitted in dependency-DFS
  order from the outputs (producers land next to their consumers),
  then a linear-scan allocator maps them onto a bounded set of
  reusable buffer slots: `n_slots` — the live-temporary bound — is
  what the executor must allocate, not the temp count.
* **Memoization** — compiled schedules are cached in a bounded LRU
  keyed by the matrix signature of ec/plan.py (`matrix_signature`,
  re-exported here); decode schedules key per erasure-pattern
  submatrix content, so a re-instantiated codec never recompiles a
  known matrix.

The executors of a schedule:

* the NATIVE tier (`lower_program` + `execute_native`) flattens a
  schedule ONCE into an `XorProgram` — a flat int32 op tape of
  ``(dst, srcA, srcB)`` region triples over a uniform region arena
  ``(n_objects, n_regions, region_bytes)`` — memoized next to the
  schedule, and runs the whole tape in a single C++ call
  (native/src/xor_sched.cc).  The `device="cpu"` codecs run it;
* the HOST tier (`execute_host`) runs the program over numpy buffer
  views, chosen only by CEPH_TPU_NATIVE_XSCHED=0;
* on a CUDA card the same tape runs in the `xor_sched` kernel
  (ops/xor_kernels.py): its region entry over a device arena, its GF
  entry over the bit planes of GF(2^8) bytes (the `xor_sched` plan
  kind of ec/plan.py, picked by measured op count: `prefer_schedule`).

Kill switches: CEPH_TPU_XSCHED=0 pins every caller to the naive
row-walk (`naive_xor_matmul` on the host, `naive_program` on the card:
bit-identical output); CEPH_TPU_NATIVE_XSCHED=0 pins the host codecs'
schedule execution to the host tier.  Unlike the reference, the native
library is never silently replaced by the host tier: it builds or
raises (native/__init__.py).  Stats land in `plan.stats()["xsched"]`.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ceph_tpu_torch import native as _native
from ceph_tpu_torch.common import flags
from ceph_tpu_torch.ec.dispatch import LruCache
from ceph_tpu_torch.ec.plan import matrix_signature

__all__ = [
    "XorProgram", "XorSchedule", "compile_matrix", "crc_regions_native",
    "enabled", "execute_host", "execute_native",
    "host_compile_allowed", "lower_program", "matrix_signature",
    "naive_program", "naive_xor_matmul", "native_available",
    "native_enabled",
    "prefer_schedule", "reset_stats", "stats",
]


def enabled() -> bool:
    """Schedule-execution kill switch (CEPH_TPU_XSCHED=0 keeps every
    consumer on the naive row-walk — bit-identical output)."""
    return flags.enabled("CEPH_TPU_XSCHED")


def native_enabled() -> bool:
    """Native-executor kill switch (CEPH_TPU_NATIVE_XSCHED=0 pins
    schedule execution to the host tier — bit-identical output)."""
    return flags.enabled("CEPH_TPU_NATIVE_XSCHED")


def native_available() -> bool:
    """True when the fused tape executor may be used: the kill switch
    is up.  The native library then builds on first use or raises
    (native/__init__.py): a missing toolchain is an error, never a
    silent switch to `execute_host`."""
    if not native_enabled():
        return False
    _native.get_lib()
    return True


def _max_ops() -> int:
    """Op-count ceiling for preferring a schedule on the DEVICE tier:
    past this, the XOR program stops beating one dense GF matmul
    launch (gf_matmul_gen), whose cost does not grow with the ops."""
    try:
        return flags.flag_int("CEPH_TPU_XSCHED_MAX_OPS")
    except ValueError:
        return 256


def _min_reduction() -> float:
    """Minimum fractional XOR-count saving before a schedule is worth
    switching lowering for (the measured-op-count pick)."""
    try:
        return flags.flag_float("CEPH_TPU_XSCHED_MIN_REDUCTION")
    except ValueError:
        return 0.25


def _host_max_ones() -> int:
    """Ones-count ceiling for compiling a matrix on the HOST serving
    path: the greedy CSE is pure-Python and quadratic-ish in the
    ones count, and the bitmatrix codecs compile inline (event loop
    / to_thread worker) on first use of each erasure pattern.  The
    default admits the whole legal RAID-6 trio space (worst case,
    liberation k=13 w=13 decode, is ~1.8k ones / ~0.6 s once) while
    refusing pathological hand-rolled geometries that would stall
    the daemon for minutes."""
    try:
        return flags.flag_int("CEPH_TPU_XSCHED_HOST_MAX_ONES")
    except ValueError:
        return 4096


def host_compile_allowed(matrix: np.ndarray) -> bool:
    """True when `matrix` is small enough to compile on the serving
    path (callers above the bound take the naive row-walk)."""
    return int(np.count_nonzero(matrix)) <= _host_max_ones()


# matrix_signature (imported above) is ec/plan.py's: schedules and the
# codecs' decode-rows cache share that one identity.


# ---------------------------------------------------------------------------
# The compiled artifact
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class XorSchedule:
    """One compiled XOR program.

    References are ints: ``ref < n_in`` names input column ``ref``;
    ``ref >= n_in`` names temporary slot ``ref - n_in``.  ``ops`` are
    executed in order — ``(dst_slot, a, b)`` meaning
    ``tmp[dst_slot] = ref(a) ^ ref(b)`` (slots are REUSED once their
    last reader has run; the order is load-bearing).  ``outputs[r]``
    lists the refs whose XOR is output row r (len 1 = copy, len 0 =
    zero fill)."""

    sig: str
    n_in: int
    n_out: int
    n_slots: int
    ops: Tuple[Tuple[int, int, int], ...]
    outputs: Tuple[Tuple[int, ...], ...]
    xors_naive: int
    xors_scheduled: int

    @property
    def reduction_pct(self) -> float:
        if self.xors_naive <= 0:
            return 0.0
        return 100.0 * (1.0 - self.xors_scheduled / self.xors_naive)


@dataclass(frozen=True)
class XorProgram:
    """A schedule lowered to the native executor's flat op tape.

    The region index space per object: ``[0, n_in)`` input columns,
    ``[n_in, n_in + n_slots)`` reusable temp slots, ``[out_base,
    out_base + n_out)`` output rows — ``n_regions`` uniform regions
    total, so an execution arena is ``(n_objects, n_regions,
    region_bytes)`` contiguous uint8 and the SAME tape replays for
    every packed object.  ``tape`` is C-contiguous int32 ``(n_ops,
    3)`` triples ``(dst, a, b)``: ``b >= 0`` XOR2, ``b == -1`` copy,
    ``b == -2`` accumulate (dst ^= a), ``a == -1`` zero fill —
    exactly native/src/xor_sched.cc's encoding."""

    sig: str
    n_in: int
    n_out: int
    n_slots: int
    n_regions: int
    tape: np.ndarray
    n_ops: int

    @property
    def out_base(self) -> int:
        return self.n_in + self.n_slots


def _lower(sched: XorSchedule) -> XorProgram:
    """Flatten a schedule into the tape.  Schedule refs map to region
    indices IDENTICALLY (ref < n_in is input column ref; ref >= n_in
    is temp slot ref - n_in, which lives at region n_in + slot =
    ref); output row r lands at region out_base + r."""
    n_in, n_slots = sched.n_in, sched.n_slots
    out_base = n_in + n_slots
    ops: List[Tuple[int, int, int]] = []
    for dst, a, b in sched.ops:
        ops.append((n_in + dst, a, b))
    for r, refs in enumerate(sched.outputs):
        dst = out_base + r
        if not refs:
            ops.append((dst, -1, -1))
        elif len(refs) == 1:
            ops.append((dst, refs[0], -1))
        else:
            ops.append((dst, refs[0], refs[1]))
            for extra in refs[2:]:
                ops.append((dst, extra, -2))
    tape = np.ascontiguousarray(np.asarray(ops, dtype=np.int32)
                                .reshape(len(ops), 3))
    tape.setflags(write=False)
    return XorProgram(sig=sched.sig, n_in=n_in, n_out=sched.n_out,
                      n_slots=n_slots,
                      n_regions=out_base + sched.n_out, tape=tape,
                      n_ops=len(ops))


def prefer_schedule(sched: XorSchedule) -> bool:
    """The schedule-vs-matmul pick for device lowerings, by measured
    op count: a schedule wins when it is small enough to unroll AND
    saves at least the configured fraction of the naive XOR count.
    Sparse bitmatrix programs qualify; dense GF(2^8) bit expansions
    (e.g. reed_sol k8m3: hundreds of surviving ops) keep the GF
    matmul kernels."""
    if not enabled() or sched.xors_naive <= 0:
        return False
    if sched.xors_scheduled > _max_ops():
        return False
    return sched.xors_scheduled <= \
        (1.0 - _min_reduction()) * sched.xors_naive


# ---------------------------------------------------------------------------
# Compilation: Paar CSE + scheduling + slot allocation
# ---------------------------------------------------------------------------


def _paar(rows: List[set], n_in: int) -> List[Tuple[int, int]]:
    """Greedy pairwise CSE: extract the (ref, ref) pair shared by the
    most rows into a new temporary until no pair repeats.  Returns
    the temp definitions; ``rows`` is rewritten in place to reference
    them.  Deterministic: ties break to the lexicographically
    smallest pair."""
    temps: List[Tuple[int, int]] = []
    next_ref = n_in
    while True:
        counts: Dict[Tuple[int, int], int] = {}
        for row in rows:
            if len(row) < 2:
                continue
            srow = sorted(row)
            for i in range(len(srow)):
                for j in range(i + 1, len(srow)):
                    p = (srow[i], srow[j])
                    counts[p] = counts.get(p, 0) + 1
        if not counts:
            break
        best = max(counts.values())
        if best < 2:
            break
        a, b = min(p for p, c in counts.items() if c == best)
        temps.append((a, b))
        t = next_ref
        next_ref += 1
        for row in rows:
            if a in row and b in row:
                row.discard(a)
                row.discard(b)
                row.add(t)
    return temps


def _schedule(temps: List[Tuple[int, int]], rows: List[set],
              n_in: int) -> Tuple[int, tuple, tuple]:
    """The scheduling pass: dependency-DFS emission order from the
    outputs (locality — a temp is computed just before its consumers
    need it, dead temps drop out), then linear-scan slot allocation
    so the executor's live-temporary footprint is ``n_slots``, not
    ``len(temps)``.  Returns (n_slots, ops, outputs) in slot-space
    references."""
    order: List[int] = []
    seen: set = set()
    for row in rows:
        for want in sorted(row):
            if want < n_in:
                continue
            stack = [want]
            while stack:
                ref = stack[-1]
                if ref in seen or ref < n_in:
                    stack.pop()
                    continue
                deps = [s for s in temps[ref - n_in]
                        if s >= n_in and s not in seen]
                if deps:
                    stack.extend(deps)
                    continue
                seen.add(ref)
                order.append(ref)
                stack.pop()
    t_count = len(order)
    # last use of each temp on the (temps..., then outputs...) timeline
    last: Dict[int, int] = {}
    for t, ref in enumerate(order):
        for s in temps[ref - n_in]:
            if s >= n_in:
                last[s] = t
    for r, row in enumerate(rows):
        for s in row:
            if s >= n_in:
                last[s] = t_count + r
    by_time: Dict[int, List[int]] = {}
    for ref, t in last.items():
        by_time.setdefault(t, []).append(ref)
    free: List[int] = []
    slot_of: Dict[int, int] = {}
    n_slots = 0
    ops: List[Tuple[int, int, int]] = []

    def resolve(s: int) -> int:
        return s if s < n_in else n_in + slot_of[s]

    for t, ref in enumerate(order):
        a, b = temps[ref - n_in]
        ra, rb = resolve(a), resolve(b)
        # a temp last READ here may donate its slot as this op's dst:
        # XOR with out= aliasing an operand exactly is well-defined
        for dead in sorted(by_time.get(t, ())):
            free.append(slot_of[dead])
        if free:
            dst = free.pop()
        else:
            dst = n_slots
            n_slots += 1
        slot_of[ref] = dst
        ops.append((dst, ra, rb))
    outputs = tuple(tuple(sorted(resolve(s) for s in row))
                    for row in rows)
    return n_slots, tuple(ops), outputs


def _compile(bm: np.ndarray, sig: str) -> XorSchedule:
    n_out, n_in = bm.shape
    rows = [set(np.flatnonzero(bm[r]).tolist()) for r in range(n_out)]
    xors_naive = sum(max(len(row) - 1, 0) for row in rows)
    temps = _paar(rows, n_in)
    n_slots, ops, outputs = _schedule(temps, rows, n_in)
    xors_scheduled = len(ops) + sum(max(len(row) - 1, 0)
                                    for row in outputs)
    return XorSchedule(sig=sig, n_in=n_in, n_out=n_out,
                       n_slots=n_slots, ops=ops, outputs=outputs,
                       xors_naive=xors_naive,
                       xors_scheduled=xors_scheduled)


# ---------------------------------------------------------------------------
# Memoization + stats
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_cache = LruCache(cap=256)
_counters: Dict[str, int] = {"compiled": 0, "cache_hits": 0,
                             "xors_naive": 0, "xors_scheduled": 0,
                             "tape_hits": 0, "tape_misses": 0,
                             "exec_native": 0, "exec_host": 0}


def compile_matrix(bm: np.ndarray,
                   sig: Optional[str] = None) -> XorSchedule:
    """Compile (or fetch) the XOR schedule of a (R, C) GF(2) 0/1
    matrix.  ``sig`` lets callers that already hold the matrix's
    sha256 identity (plan.codec_signature / matrix_signature) skip
    the rehash — it MUST be matrix-unique; omitted, the content
    signature is computed here.  The cache is keyed by matrix
    identity, so a re-instantiated codec never recompiles."""
    bm = np.ascontiguousarray(bm, dtype=np.uint8)
    key = sig or matrix_signature(bm)
    with _lock:
        hit = _cache.peek(key)
        if hit is not None:
            _counters["cache_hits"] += 1
            return hit
    sched = _compile(bm, key)
    with _lock:
        again = _cache.peek(key)
        if again is not None:       # racing compile: first one wins
            _counters["cache_hits"] += 1
            return again
        _cache.put(key, sched)
        _counters["compiled"] += 1
        _counters["xors_naive"] += sched.xors_naive
        _counters["xors_scheduled"] += sched.xors_scheduled
    return sched


def lower_program(sched: XorSchedule) -> XorProgram:
    """The tape of a schedule (the native executor's and the
    `xor_sched` kernel's), memoized ALONGSIDE it in the same
    signature-keyed cache (key ``sig + "/tape"``): lowering happens
    once per matrix identity.  `stats()` counts tape hits/misses
    separately from schedule-cache traffic."""
    key = sched.sig + "/tape"
    with _lock:
        hit = _cache.peek(key)
        if hit is not None:
            _counters["tape_hits"] += 1
            return hit
    prog = _lower(sched)
    with _lock:
        again = _cache.peek(key)
        if again is not None:       # racing lowering: first one wins
            _counters["tape_hits"] += 1
            return again
        _cache.put(key, prog)
        _counters["tape_misses"] += 1
    return prog


def naive_program(rows: np.ndarray, sig: str) -> XorProgram:
    """The naive row-walk of a (R, C) 0/1 matrix as a tape: no
    temporaries, each output row the XOR of its columns in column
    order.  A CUDA codec runs it where the host codecs take
    `naive_xor_matmul` (CEPH_TPU_XSCHED=0, or a matrix above
    `host_compile_allowed`), so the card is never left for numpy.
    ``sig`` must be matrix-unique; the tape is memoized under
    ``sig + "/naive"`` and moves no compile or tape counter."""
    key = sig + "/naive"
    with _lock:
        hit = _cache.peek(key)
    if hit is not None:
        return hit
    bm = np.ascontiguousarray(rows, dtype=np.uint8)
    n_out, n_in = bm.shape
    outputs = tuple(tuple(np.flatnonzero(bm[r]).tolist())
                    for r in range(n_out))
    xors = sum(max(len(row) - 1, 0) for row in outputs)
    prog = _lower(XorSchedule(sig=key, n_in=n_in, n_out=n_out, n_slots=0,
                              ops=(), outputs=outputs, xors_naive=xors,
                              xors_scheduled=xors))
    with _lock:
        _cache.put(key, prog)
    return prog


def stats() -> dict:
    """The `xsched` observability section plan.stats() embeds."""
    with _lock:
        out = dict(_counters)
        out["cached"] = len(_cache)
    out["enabled"] = enabled()
    out["native_enabled"] = native_enabled()
    return out


def reset_stats() -> None:
    with _lock:
        for k in _counters:
            _counters[k] = 0


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------


def execute_host(sched: XorSchedule, sources: Sequence[np.ndarray],
                 outs: Sequence[np.ndarray]) -> None:
    """Run the XOR program over numpy regions, in place.

    ``sources[c]`` is input column c — any same-shape uint8 views
    (the bitmatrix packet views; strided is fine).  ``outs[r]`` is
    the writable destination for output row r.  Outputs must not
    alias sources (the codec layers write parity/recovered chunks,
    never their inputs).  Temporaries are ``n_slots`` scratch
    buffers allocated here per call."""
    with _lock:
        _counters["exec_host"] += 1
    n_in = sched.n_in
    tmp: List[Optional[np.ndarray]] = [None] * sched.n_slots

    def ref(r: int) -> np.ndarray:
        return sources[r] if r < n_in else tmp[r - n_in]

    for dst, a, b in sched.ops:
        if tmp[dst] is None:
            tmp[dst] = np.bitwise_xor(ref(a), ref(b))
        else:
            np.bitwise_xor(ref(a), ref(b), out=tmp[dst])
    for refs, out in zip(sched.outputs, outs):
        if not refs:
            out[...] = 0
        elif len(refs) == 1:
            out[...] = ref(refs[0])
        else:
            np.bitwise_xor(ref(refs[0]), ref(refs[1]), out=out)
            for r in refs[2:]:
                np.bitwise_xor(out, ref(r), out=out)


_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)


def execute_native(prog: XorProgram, arena: np.ndarray) -> None:
    """Run the whole op tape in ONE native call.

    ``arena`` is ``(n_objects, n_regions, region_bytes)`` — or 2-D
    ``(n_regions, region_bytes)`` for a single object — C-contiguous
    uint8, input regions filled by the caller; temps and outputs are
    produced in place.  The same tape replays for every object, so a
    packed batch of thousands of tiny objects is one Python→native
    transition total."""
    if arena.ndim == 2:
        n_objects, (n_regions, rbytes) = 1, arena.shape
    else:
        n_objects, n_regions, rbytes = arena.shape
    if n_regions != prog.n_regions:
        raise ValueError(
            f"arena has {n_regions} regions, program needs "
            f"{prog.n_regions}")
    if not arena.flags.c_contiguous or arena.dtype != np.uint8:
        raise ValueError("arena must be C-contiguous uint8")
    lib = _native.get_lib()
    lib.ceph_tpu_xsched_exec(
        prog.tape.ctypes.data_as(_I32P), prog.n_ops,
        arena.ctypes.data_as(_U8P), n_regions, rbytes, n_objects)
    with _lock:
        _counters["exec_native"] += 1


def crc_regions_native(arena: np.ndarray, spans: np.ndarray,
                       crcs: np.ndarray) -> None:
    """Fold contiguous region spans of a FLAT arena into crc32c
    accumulators natively: ``spans`` is ``(n, 3)`` int32 rows
    ``(region_start, region_count, crc_slot)`` over the flattened
    ``(total_regions, region_bytes)`` view of ``arena``; ``crcs`` is
    the uint32 accumulator vector (callers seed it — HashInfo uses
    0xFFFFFFFF).  Spans fold in order, so a multi-stripe shard
    accumulates stripe by stripe exactly like ``HashInfo.append``."""
    flat = arena.reshape(-1, arena.shape[-1])
    spans = np.ascontiguousarray(spans, dtype=np.int32)
    if not flat.flags.c_contiguous:
        raise ValueError("arena must be C-contiguous")
    if not crcs.flags.c_contiguous or crcs.dtype != np.uint32:
        raise ValueError("crcs must be C-contiguous uint32")
    lib = _native.get_lib()
    lib.ceph_tpu_xsched_crc_spans(
        flat.ctypes.data_as(_U8P), flat.shape[1],
        spans.ctypes.data_as(_I32P), spans.shape[0],
        crcs.ctypes.data_as(_U32P))


def naive_xor_matmul(rows: np.ndarray,
                     packets: np.ndarray) -> np.ndarray:
    """(R, C) 0/1 x (B, C, ps) byte packets -> (B, R, ps) XORs — the
    unscheduled row-walk.  This is the host codecs' kill-switch path
    and the independent bit-exactness oracle for every schedule."""
    b, _c, ps = packets.shape
    out = np.zeros((b, rows.shape[0], ps), dtype=np.uint8)
    for r in range(rows.shape[0]):
        idx = np.flatnonzero(rows[r])
        if idx.size:
            out[:, r] = np.bitwise_xor.reduce(packets[:, idx, :],
                                              axis=1)
    return out
