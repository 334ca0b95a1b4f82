"""Async micro-batching encode service for the OSD write path (port of
ceph_tpu/osd/encode_service.py).

Concurrent write handlers **await** their encodes here; requests pool
while a dispatch is in flight (an idle bucket dispatches immediately —
adaptive group commit, so the small-op band never pays an accumulation
wait it can't amortize; a ~1ms window and a byte budget bound the
pooling), then ONE flush runs the batch through the fused encode+crc
path **off-loop** (asyncio.to_thread: the event loop never blocks on
the card) and resolves each request's future with its own shards and
hinfo crcs.  A batch of N objects is one GF launch and two crc launches
(ec_util.encode_many_with_hinfo -> codec.encode_many_with_crc).

Pipelining is double-buffered: each profile bucket holds two dispatch
slots, so while batch N computes on the card, batch N+1 accumulates and
the sub-write network fan-out of already-completed ops overlaps the
next dispatch.

Knobs (read at construction):

  CEPH_TPU_ENCODE_BATCH_WINDOW_MS  accumulation upper bound (the
                                   common path is the adaptive
                                   idle/completion flush), default 1.0
  CEPH_TPU_ENCODE_BATCH_BYTES      flush early once this many bytes
                                   are pending (default 8 MiB)
  CEPH_TPU_ENCODE_SERVICE=0        kill switch — every call runs the
                                   inline path, results unchanged

Batching engages when a batched tier can: the fused tier
(ec_util.device_fused_available: the codec runs on CUDA, or
CEPH_TPU_FUSE_MIN_BYTES is set, which engages the same batched body on
the CPU) or, for the bitmatrix family on the hinfo write path, the packed
tier (ec_util.bitmatrix_native_available: N objects' stripes pack into
ONE region arena and the whole bucket runs as a single XOR tape — one
`xor_sched` launch on the card, one native call on the CPU).  A packed
bucket is routed by arrival density (`_cold_inline`): sparse arrivals
encode inline on the caller, bursts pool into packed batches.  Plain
encode and decode of a bitmatrix codec stay inline.  Otherwise every
request takes the inline path.
Backpressure is a bounded queue per profile (requests + bytes, counting
in-flight batches); overflow **sheds to the inline path** instead of
queueing unboundedly.

Deviations from the reference: no circuit breaker and no mesh (the port
has no device guard: a launch runs or raises).  A batch that raises is
retried item by item on the SAME codec and device, so one malformed
request cannot fail its neighbours; an error on the retry reaches that
request's future — it is never retried on a host or plain twin.

Threading: all bookkeeping (buckets, counters, histograms) runs on
the owning event loop; only the numeric batch body runs in the
to_thread worker, so no lock is needed.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Iterable, List, Optional

from ceph_tpu_torch.common import flags, tracing
from ceph_tpu_torch.osd import ec_util, scheduler

__all__ = ["EncodeService"]


def _env_float(name: str, default: float) -> float:
    try:
        return flags.flag_float(name, default)
    except ValueError:
        return default


def _pow2_bucket(n: int) -> int:
    """Histogram bucket for batch sizes: next power of two."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def _buf(d):
    """Pass buffers through to ec_util unchanged; materialize only
    non-buffer payloads.  The old `bytes(d)`-unless-bytes guard copied
    every memoryview payload once per inline encode — unnecessary: the
    write path snapshots caller-mutable buffers BEFORE the service
    sees them (`_op_write_full_locked`/`_op_write`), so a view here is
    already stable, and ec_util slices views zero-copy."""
    return d if isinstance(d, (bytes, bytearray, memoryview)) \
        else bytes(d)


_WAIT_EDGES_MS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0)


def _wait_bucket(seconds: float) -> str:
    ms = seconds * 1e3
    for edge in _WAIT_EDGES_MS:
        if ms <= edge:
            return f"<={edge}ms"
    return f">{_WAIT_EDGES_MS[-1]}ms"


class _Req:
    __slots__ = ("fut", "payload", "nbytes", "t_q", "span_ctx")

    def __init__(self, fut: asyncio.Future, payload, nbytes: int):
        self.fut = fut
        self.payload = payload
        self.nbytes = nbytes
        self.t_q = time.perf_counter()
        # the enqueuing op's span context: the batched flush span
        # LINKS to every op it served (N ops -> 1 device dispatch)
        span = tracing.current_span.get()
        self.span_ctx = span.context if span is not None else None


class _Bucket:
    """Accumulation queue for one (kind, codec profile, geometry)."""

    __slots__ = ("kind", "label", "sinfo", "codec", "pending",
                 "nbytes", "outstanding", "outstanding_bytes",
                 "timer", "sem", "stats", "in_flight", "tier",
                 "last_arrival", "ewma_gap")

    def __init__(self, kind: str, label: str, sinfo, codec,
                 tier: str = "device"):
        self.kind = kind
        self.label = label
        self.sinfo = sinfo
        self.codec = codec
        self.tier = tier
        self.pending: List[_Req] = []
        self.nbytes = 0
        self.outstanding = 0          # queued + in-flight requests
        self.outstanding_bytes = 0
        self.in_flight = 0            # dispatched batches not yet done
        # arrival-density tracking (the bitmatrix hot/cold router),
        # keyed by mClock class: a recovery wave's dense arrivals
        # must not mark the bucket hot for sparse client writes (and
        # a client trickle must not mask a forming recovery batch)
        self.last_arrival: Dict[str, float] = {}
        self.ewma_gap: Dict[str, float] = {}
        self.timer: Optional[asyncio.TimerHandle] = None
        # two dispatch slots: the double buffer — batch N on device,
        # batch N+1 accumulating/launching behind it
        self.sem = asyncio.Semaphore(2)
        self.stats: Dict[str, object] = {
            "requests": 0, "batches": 0, "dispatch_seconds": 0.0,
            "batch_size_hist": {}, "fill_pct_hist": {},
            "wait_ms_hist": {},
        }


class EncodeService:
    """Per-codec-profile micro-batching encode/decode front end."""

    def __init__(self, who: str = "osd",
                 window_ms: Optional[float] = None,
                 max_batch_bytes: Optional[int] = None,
                 max_queue_requests: int = 256,
                 max_queue_bytes: Optional[int] = None):
        self.who = who
        self.enabled = flags.enabled("CEPH_TPU_ENCODE_SERVICE")
        if window_ms is None:
            window_ms = _env_float("CEPH_TPU_ENCODE_BATCH_WINDOW_MS",
                                   1.0)
        self.window_s = max(float(window_ms), 0.0) / 1e3
        if max_batch_bytes is None:
            max_batch_bytes = int(_env_float(
                "CEPH_TPU_ENCODE_BATCH_BYTES", float(8 << 20)))
        self.max_batch_bytes = max(int(max_batch_bytes), 1)
        self.max_queue_requests = max(int(max_queue_requests), 1)
        self.max_queue_bytes = int(max_queue_bytes
                                   if max_queue_bytes is not None
                                   else 4 * self.max_batch_bytes)
        self._buckets: Dict[tuple, _Bucket] = {}
        self._tasks: set = set()
        self._closed = False
        # set by the owning daemon: flush dispatch spans (with links
        # to the ops each batch served) land in this tracer's ring
        self.tracer = None
        self._usable_cache: Dict[int, str] = {}
        self.counters = {"requests": 0, "batched": 0, "inline": 0,
                         "inline_cold": 0, "shed": 0, "batches": 0,
                         "dispatch_errors": 0,
                         # sheds by request kind: each runs the inline
                         # path (one fused encode or one decode launch)
                         "shed_encode_hinfo": 0, "shed_encode": 0,
                         "shed_decode": 0}

    # -- public API (the daemon's awaited entry points) -------------------

    async def encode_with_hinfo(self, sinfo, codec, data,
                                want: Iterable[int],
                                logical_len: Optional[int] = None):
        """Awaitable twin of ec_util.encode_with_hinfo — identical
        results, but concurrent callers share device dispatches."""
        want = tuple(want)
        self.counters["requests"] += 1
        q = self._bucket_for("encode_hinfo", sinfo, codec)
        if q is not None and self._cold_inline(q):
            self.counters["inline_cold"] += 1
            q = None
        if q is None or not self._admit(q, len(data)):
            self._count_unbatched(q, "encode_hinfo")
            # intentionally-inline path (kill switch, no batchable
            # tier, a cold bitmatrix bucket, or backpressure shed).
            # The span names the stage —
            # inline codec work must be attributable in the
            # histograms, not folded invisibly into osd_op self-time
            with tracing.child_span_sync("encode_inline"):
                return ec_util.encode_with_hinfo(
                    sinfo, codec, data, want, logical_len=logical_len)
        return await self._enqueue(q, (data, want, logical_len),
                                   len(data))

    async def encode(self, sinfo, codec, data,
                     want: Iterable[int]) -> Dict[int, bytes]:
        """Awaitable twin of ec_util.encode (plain shards, no hinfo:
        the RMW re-encode and recovery re-encode path)."""
        want = tuple(want)
        self.counters["requests"] += 1
        q = self._bucket_for("encode", sinfo, codec)
        if q is None or not self._admit(q, len(data)):
            self._count_unbatched(q, "encode")
            with tracing.child_span_sync("encode_inline"):
                return ec_util.encode(sinfo, codec, _buf(data), want)
        return await self._enqueue(q, (data, want), len(data))

    async def decode(self, sinfo, codec, to_decode) -> bytes:
        """Awaitable twin of ec_util.decode: concurrent reads and
        recovery reconstructions sharing a survivor set batch into one
        device dispatch (the decode_many service path)."""
        self.counters["requests"] += 1
        nbytes = sum(len(v) for v in to_decode.values())
        k = codec.get_data_chunk_count()
        # all data shards present = pure host interleave, no device
        # work to batch — keep it inline (the common read fast path)
        all_data = not codec.get_chunk_mapping() and \
            all(i in to_decode for i in range(k))
        q = None if all_data else self._bucket_for("decode", sinfo,
                                                   codec)
        if q is None or not self._admit(q, nbytes):
            self._count_unbatched(q, "decode")
            with tracing.child_span_sync("decode_inline"):
                return ec_util.decode(sinfo, codec, to_decode)
        return await self._enqueue(q, dict(to_decode), nbytes)

    async def decode_many(self, sinfo, codec, maps) -> list:
        """N decode requests at once (the recovery-wave entry):
        returns one outcome per request — the decoded bytes, or the
        Exception that request raised (callers isolate failures per
        object).  Each request takes `decode`'s path: batchable ones
        group in the flush, whose batch body isolates a failure per
        item; inline ones decode one by one."""
        return await asyncio.gather(
            *(self.decode(sinfo, codec, m) for m in maps),
            return_exceptions=True)

    async def stop(self) -> None:
        """Flush everything pending and await in-flight dispatches —
        every caller blocked on a future resolves (no deadlock);
        requests arriving after stop() run inline."""
        self._closed = True
        for q in list(self._buckets.values()):
            self._flush(q)
        while self._tasks:
            await asyncio.gather(*list(self._tasks),
                                 return_exceptions=True)

    def stats(self) -> dict:
        """Observability snapshot: aggregate counters, live queue
        depth, and per-profile batch-size / fill-ratio / wait-time
        histograms (the admin-socket `encode_service` command and the
        bench contract line surface this)."""
        return {
            "enabled": self.enabled,
            **self.counters,
            "queue_depth": sum(q.outstanding
                               for q in self._buckets.values()),
            "queue_bytes": sum(q.outstanding_bytes
                               for q in self._buckets.values()),
            "window_ms": self.window_s * 1e3,
            "max_batch_bytes": self.max_batch_bytes,
            "profiles": {q.label: {k: (dict(v) if isinstance(v, dict)
                                       else v)
                                   for k, v in q.stats.items()}
                         for q in self._buckets.values()},
        }

    # -- internals --------------------------------------------------------

    def _count_unbatched(self, q: Optional[_Bucket], kind: str) -> None:
        """An inline request: no batchable tier (q None), or shed."""
        if q is None:
            self.counters["inline"] += 1
        else:
            self.counters["shed"] += 1
            self.counters[f"shed_{kind}"] += 1

    def _usable(self, codec) -> str:
        """The batching tier this codec can ride: "device" (the fused
        encode+crc call), "bitmatrix" (the packed XOR tape —
        ec_util._encode_many_bitmatrix), or "" (inline only)."""
        if not self.enabled or self._closed:
            return ""
        key = id(codec)
        hit = self._usable_cache.get(key)
        if hit is None:
            if ec_util.device_fused_available(codec):
                hit = "device"
            elif ec_util.bitmatrix_native_available(codec):
                hit = "bitmatrix"
            else:
                hit = ""
            self._usable_cache[key] = hit
        return hit

    def _bucket_for(self, kind: str, sinfo, codec
                    ) -> Optional[_Bucket]:
        tier = self._usable(codec)
        if not tier:
            return None
        # the packed tape tier only exists for the hinfo write path:
        # plain encode / decode stay inline for bitmatrix
        if tier == "bitmatrix" and kind != "encode_hinfo":
            return None
        if kind == "decode" and not hasattr(codec, "decode_batch"):
            return None
        sig = codec.plan_signature() if hasattr(codec,
                                                "plan_signature") \
            else getattr(codec, "_sig", None) or str(id(codec))
        key = (kind, sig, sinfo.get_stripe_width(),
               sinfo.get_chunk_size())
        q = self._buckets.get(key)
        if q is None:
            label = f"{kind}[{sig[:8]}] w{sinfo.get_stripe_width()}" \
                    f" c{sinfo.get_chunk_size()}"
            q = _Bucket(kind, label, sinfo, codec, tier=tier)
            self._buckets[key] = q
        return q

    def _admit(self, q: _Bucket, nbytes: int) -> bool:
        """Backpressure: bound queued + in-flight work per profile."""
        return (q.outstanding < self.max_queue_requests
                and q.outstanding_bytes + nbytes
                <= self.max_queue_bytes)

    def _cold_inline(self, q: _Bucket) -> bool:
        """Hot/cold router for the packed bitmatrix tier.  A singleton
        batch pays the off-loop hop (task + to_thread round trip, ~ms
        under load) to save little codec work — a pure loss, so a COLD
        bucket (observed inter-arrival EWMA wider than a quarter of the
        batch window) runs the encode inline on the caller, where the
        tape is still one launch (or one C++ call).  Once arrivals pack
        well inside the window — or a batch is already pooling or in
        flight to join — requests take the packed multi-object path.
        The fused tier never routes here: its per-op dispatch cost is
        exactly what batching amortizes."""
        if q.tier != "bitmatrix":
            return False
        # per-mClock-class arrival density: the op's scheduler class
        # rides the contextvar set by scheduler.run() ('' outside any
        # grant); tenant classes fold so the dicts stay bounded
        cls = scheduler.stage_class(scheduler.current_class())
        now = time.perf_counter()
        last = q.last_arrival.get(cls)
        if last is not None:
            gap = now - last
            prev = q.ewma_gap.get(cls)
            q.ewma_gap[cls] = gap if prev is None \
                else 0.5 * prev + 0.5 * gap
        q.last_arrival[cls] = now
        if q.pending or q.in_flight:
            return False        # a batch is forming: join it
        gap = q.ewma_gap.get(cls)
        return gap is None or gap > self.window_s / 4.0

    async def _enqueue(self, q: _Bucket, payload, nbytes: int):
        loop = asyncio.get_running_loop()
        req = _Req(loop.create_future(), payload, nbytes)
        q.pending.append(req)
        q.nbytes += nbytes
        q.outstanding += 1
        q.outstanding_bytes += nbytes
        q.stats["requests"] += 1                # type: ignore[operator]
        self.counters["batched"] += 1
        if (q.nbytes >= self.max_batch_bytes or self.window_s == 0.0
                or q.in_flight == 0):
            # adaptive group commit: an idle bucket dispatches NOW —
            # the small-op band must not pay the accumulation window
            # when there is nothing to accumulate behind.  Batching
            # still emerges under pressure: while a dispatch is in
            # flight, arrivals pool here and the completion hook in
            # _dispatch flushes them as one batch.
            self._flush(q)
        elif q.timer is None:
            # upper bound only — the completion-triggered flush is
            # the common path; the timer catches a wedged dispatch
            q.timer = loop.call_later(self.window_s, self._flush, q)
        # accumulation wait + shared dispatch, as the op saw it: one
        # stage span from enqueue to future resolution
        wait_span = tracing.start_child("encode_wait", kind=q.kind)
        try:
            return await req.fut
        except asyncio.CancelledError:
            wait_span.set_attr("cancelled", True)
            raise
        finally:
            wait_span.finish()

    def _flush(self, q: _Bucket) -> None:
        if q.timer is not None:
            q.timer.cancel()
            q.timer = None
        if not q.pending:
            return
        batch, q.pending = q.pending, []
        nbytes, q.nbytes = q.nbytes, 0
        q.in_flight += 1
        task = asyncio.get_running_loop().create_task(
            self._dispatch(q, batch, nbytes))
        self._tasks.add(task)

        def _done(t, q=q):
            self._tasks.discard(t)
            q.in_flight -= 1
            # completion-triggered flush: everything that pooled
            # while this batch computed goes out as the next batch
            if q.pending and not self._closed:
                self._flush(q)
        task.add_done_callback(_done)

    async def _dispatch(self, q: _Bucket, batch: List[_Req],
                        nbytes: int) -> None:
        async with q.sem:   # double buffer: at most 2 batches in flight
            t0 = time.perf_counter()
            wait_hist = q.stats["wait_ms_hist"]
            for r in batch:
                b = _wait_bucket(t0 - r.t_q)
                wait_hist[b] = wait_hist.get(b, 0) + 1
            # the batched device dispatch is ONE span serving N ops:
            # span LINKS carry the attribution (it parents none of
            # them — their own encode_wait spans cover the wall time)
            flush_span = self.tracer.start(
                f"encode_flush {q.label}") if self.tracer is not None \
                else tracing.NULL_SPAN
            flush_span.set_attr("requests", len(batch))
            flush_span.set_attr("bytes", nbytes)
            for r in batch:
                flush_span.link(r.span_ctx)
            token = tracing.current_span.set(flush_span) \
                if flush_span else None
            try:
                try:
                    outs = await asyncio.to_thread(
                        self._run_batch, q,
                        [r.payload for r in batch])
                except BaseException as e:
                    self.counters["dispatch_errors"] += 1
                    outs = [e] * len(batch)
                dt = time.perf_counter() - t0
                flush_span.set_attr("dispatch_ms", round(dt * 1e3, 3))
            finally:
                if token is not None:
                    tracing.current_span.reset(token)
                if self.tracer is not None:
                    self.tracer.finish(flush_span)
            self.counters["batches"] += 1
            q.stats["batches"] += 1             # type: ignore[operator]
            q.stats["dispatch_seconds"] += dt   # type: ignore[operator]
            sh = q.stats["batch_size_hist"]
            sk = str(_pow2_bucket(len(batch)))
            sh[sk] = sh.get(sk, 0) + 1
            fh = q.stats["fill_pct_hist"]
            fill = min(nbytes * 100 // self.max_batch_bytes, 100)
            fk = str(min((fill // 10) * 10 + 10, 100))
            fh[fk] = fh.get(fk, 0) + 1
            for r, out in zip(batch, outs):
                q.outstanding -= 1
                q.outstanding_bytes -= r.nbytes
                if r.fut.done():
                    continue
                if isinstance(out, BaseException):
                    r.fut.set_exception(out)
                else:
                    r.fut.set_result(out)

    def _run_batch(self, q: _Bucket, payloads: list) -> list:
        """Thread-side batch body: one fused call for the whole batch.
        When the batch raises, each item is retried alone on the same
        codec (the same device path), so one malformed request cannot
        fail its neighbours; an item whose retry raises gets that
        error on its own future."""
        try:
            if q.kind == "encode_hinfo":
                return ec_util.encode_many_with_hinfo(
                    q.sinfo, q.codec, payloads)
            if q.kind == "encode":
                return ec_util.encode_many(
                    q.sinfo, q.codec, [p[0] for p in payloads],
                    [p[1] for p in payloads])
            return ec_util.decode_many(q.sinfo, q.codec, payloads)
        except Exception:
            outs: list = []
            for p in payloads:
                try:
                    outs.append(self._run_one(q, p))
                except Exception as e:
                    outs.append(e)
            return outs

    def _run_one(self, q: _Bucket, payload):
        if q.kind == "encode_hinfo":
            d, w, l = payload
            return ec_util.encode_with_hinfo(q.sinfo, q.codec, d, w,
                                             logical_len=l)
        if q.kind == "encode":
            d, w = payload
            return ec_util.encode(q.sinfo, q.codec, _buf(d), w)
        return ec_util.decode(q.sinfo, q.codec, payload)
