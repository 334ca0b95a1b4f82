"""Async group-commit front end for ObjectStore transactions (port of
ceph_tpu/os/groupcommit.py).

The BlueStore kv_sync_thread amortization, asyncio-shaped: every
durable transaction on the OSD write path used to pay its own
`_block_sync()` + `submit_transaction_sync` barrier inside
`TPUStore.queue_transaction` — N concurrent writers bought N fsyncs
where one would do (and paid them ON the event loop, stalling every
other task for the fsync's duration).  This layer is the journal-side
twin of `osd/encode_service.py`: concurrent transactions accumulate
in a short window (or until a txn/byte budget fills — whichever
first), then ONE flush ships the whole FIFO batch through
`store.submit_batch` on a dedicated single-worker commit thread (the
literal kv_sync_thread), which merges the KV batches into a single
sync commit and the direct writes into a single block fsync.  Each
caller's `await` resolves only after the shared barrier — the
ack=>durable contract is unchanged per txn.  While batch N commits on the worker, batch N+1
accumulates on the loop — the encode service's double-buffer shape.

Ordering: ONE commit lane.  The single worker drains its queue FIFO
(batch N commits before batch N+1 starts), so a later txn staging a
newer PG-log snapshot can never be overwritten by an earlier txn's
older snapshot landing after it.  For the same reason there is NO
shed-to-inline under pressure (the encode service can shed because
encodes are pure; commits are not): a full window flushes
immediately instead.  Sync call sites that must not reorder around
the window (split redistribution, which both reads pgmeta from the
store and stages it) call `flush_sync()` — it pushes the open window
to the worker and JOINS it, putting the whole store at program
order before they read or write.

Knobs (read at construction):

  CEPH_TPU_GROUP_COMMIT_WINDOW_MS  accumulation window, default 0.5
  CEPH_TPU_GROUP_COMMIT_TXNS       flush early at this many pending
                                   txns (default 64)
  CEPH_TPU_GROUP_COMMIT_BYTES     flush early once this many payload
                                   bytes are pending (default 4 MiB)
  CEPH_TPU_GROUP_COMMIT=0          kill switch — every txn takes the
                                   inline (pre-batching) path:
                                   synchronous queue_transaction in
                                   call order, behavior-parity with
                                   the un-batched daemon

Degradation policy: batching only engages when the store actually
amortizes barriers — i.e. it overrides `ObjectStore.submit_batch`
(TPUStore and subclasses).  MemStore-backed daemons take the inline
path unconditionally: their queue_transaction is a dict update, and
a window would add latency for nothing.

Barrier points: `drain()` flushes the window and awaits the worker —
daemon stop()/kill() call it (like the encode service drains) so
shutdown and power-cut harnesses never see a stranded unacked txn
holding an object lock.  `commit_now()` is the async bypass for
scrub/recovery barriers: drain, then commit inline.
"""

from __future__ import annotations

import asyncio
import os

from ceph_tpu_torch.common import flags
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.common import tracing
from ceph_tpu_torch.os import ObjectStore, Transaction

__all__ = ["GroupCommitter"]


def _env_float(name: str, default: float) -> float:
    try:
        return flags.flag_float(name, default)
    except ValueError:
        return default


def _pow2_bucket(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def _txn_bytes(txn: Transaction) -> int:
    """Cheap payload estimate for the byte budget: write-op data
    only (metadata ops are noise next to a data shard)."""
    return sum(len(op[4]) for op in txn.ops if op[0] == "write")


class GroupCommitter:
    """FIFO accumulating committer over one ObjectStore."""

    def __init__(self, store: ObjectStore, who: str = "osd",
                 config=None,
                 window_ms: Optional[float] = None,
                 max_batch_txns: Optional[int] = None,
                 max_batch_bytes: Optional[int] = None):
        self.store = store
        self.who = who
        config = config or {}
        self.enabled = (
            flags.enabled("CEPH_TPU_GROUP_COMMIT")
            and bool(config.get("osd_group_commit_enable", True)))
        # engage only where barriers exist to amortize: a store that
        # kept the base (loop-per-txn) submit_batch gains nothing
        # from batching and would only pay the window
        self.engaged = (self.enabled and
                        type(store).submit_batch
                        is not ObjectStore.submit_batch)
        if window_ms is None:
            window_ms = _env_float("CEPH_TPU_GROUP_COMMIT_WINDOW_MS",
                                   0.5)
        self.window_s = max(float(window_ms), 0.0) / 1e3
        self.max_batch_txns = int(
            max_batch_txns if max_batch_txns is not None
            else _env_float("CEPH_TPU_GROUP_COMMIT_TXNS", 64))
        self.max_batch_bytes = int(
            max_batch_bytes if max_batch_bytes is not None
            else _env_float("CEPH_TPU_GROUP_COMMIT_BYTES",
                            float(4 << 20)))
        self._pending: List[Tuple[Transaction, asyncio.Future]] = []
        self._pending_bytes = 0
        self._timer: Optional[asyncio.TimerHandle] = None
        # the commit lane: ONE worker thread, so executor queue order
        # IS commit order, and sync contexts can join it (.result())
        self._worker: Optional[ThreadPoolExecutor] = None
        self._inflight: list = []  # concurrent.futures.Future, FIFO
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False
        self.counters: Dict[str, int] = {
            "txns": 0, "inline": 0, "batched": 0, "batches": 0,
            "window_flushes": 0, "budget_flushes": 0,
            "drain_flushes": 0, "commit_errors": 0,
        }
        self.txns_per_batch_hist: Dict[str, int] = {}

    # -- public API -------------------------------------------------------

    async def queue_transaction(self, txn: Transaction) -> None:
        """Awaitable twin of store.queue_transaction — identical
        durability contract, but concurrent callers share one commit
        barrier.  Resolves after THIS txn is durable (its on_commit
        callbacks have fired); raises what the apply raised."""
        self.counters["txns"] += 1
        if not self.engaged or self._closed:
            self.counters["inline"] += 1
            self.store.queue_transaction(txn)
            return
        loop = asyncio.get_running_loop()
        self._loop = loop
        fut: asyncio.Future = loop.create_future()
        self._pending.append((txn, fut))
        self._pending_bytes += _txn_bytes(txn)
        self.counters["batched"] += 1
        if (len(self._pending) >= self.max_batch_txns
                or self._pending_bytes >= self.max_batch_bytes):
            self.counters["budget_flushes"] += 1
            self._flush()
        elif self.window_s == 0.0:
            self._flush()
        elif self._timer is None:
            self._timer = loop.call_later(self.window_s,
                                          self._window_fired)
        # accumulation wait + shared barrier, as the op saw it: the
        # store's own kv_commit/fsync spans run on the commit-lane
        # thread (no task context), so THIS span is where the op's
        # journal cost attributes in the stage histograms
        wait_span = tracing.start_child("kv_commit_wait")
        try:
            await fut
        except asyncio.CancelledError:
            wait_span.set_attr("cancelled", True)
            raise
        finally:
            wait_span.finish()

    def flush_sync(self) -> None:
        """Synchronous total-order barrier for sync call sites (split
        redistribution): push the open window to the commit lane and
        JOIN the lane.  On return every txn queued before this call
        is durable and the store reads at program order.  Blocks the
        calling thread for at most the in-flight commits' barriers —
        exactly what the pre-batching code paid inline per txn."""
        if self._pending:
            self.counters["drain_flushes"] += 1
            self._flush()
        for cf in list(self._inflight):
            try:
                cf.result()
            except Exception:
                pass  # the owning future carries the error
        self._inflight = [f for f in self._inflight if not f.done()]

    async def drain(self) -> None:
        """Flush the open window and await the commit lane: after
        this, nothing queued before the call is un-committed.  The
        stop()/kill() barrier (and the scrub/recovery bypass)."""
        if self._pending:
            self.counters["drain_flushes"] += 1
            self._flush()
        for cf in list(self._inflight):
            try:
                await asyncio.wrap_future(cf)
            except Exception:
                pass  # per-txn futures carry their own errors
        self._inflight = [f for f in self._inflight if not f.done()]

    async def commit_now(self, txn: Transaction) -> None:
        """Barrier-point bypass: drain the lane (nothing may reorder
        around this txn), then commit inline."""
        if self.engaged and not self._closed:
            await self.drain()
        self.counters["txns"] += 1
        self.counters["inline"] += 1
        self.store.queue_transaction(txn)

    async def stop(self) -> None:
        """Drain and latch closed; txns arriving after stop() run
        inline (teardown must not strand a caller on a future no
        flush will resolve).  The commit-lane thread is joined and
        released — a restarting daemon builds a fresh committer, so
        a stopped one must not leak its worker."""
        self._closed = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        await self.drain()
        if self._worker is not None:
            await asyncio.to_thread(self._worker.shutdown, True)
            self._worker = None

    def stats(self) -> dict:
        avg = (self.counters["batched"]
               / max(self.counters["batches"], 1))
        return {
            "enabled": self.enabled,
            "engaged": self.engaged,
            **self.counters,
            "txns_per_batch_hist": dict(self.txns_per_batch_hist),
            "txns_per_batch_avg": round(avg, 2),
            "pending": len(self._pending),
            "window_ms": self.window_s * 1e3,
            "max_batch_txns": self.max_batch_txns,
            "max_batch_bytes": self.max_batch_bytes,
        }

    # -- internals --------------------------------------------------------

    def _window_fired(self) -> None:
        self._timer = None
        if self._pending:
            self.counters["window_flushes"] += 1
            self._flush()

    def _flush(self) -> None:
        """Hand the accumulated batch to the commit lane (loop
        thread only)."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        self._pending_bytes = 0
        if self._worker is None:
            self._worker = ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix=f"{self.who}-kv-sync")
        # prune settled lanes loop-side only (the worker never touches
        # this list, so no cross-thread mutation race)
        self._inflight = [f for f in self._inflight if not f.done()]
        cf = self._worker.submit(self._commit_batch, batch, self._loop)
        self._inflight.append(cf)

    def _commit_batch(self, batch, loop) -> None:
        """Worker-thread batch body: one commit unit for the whole
        batch; per-txn outcomes fan back out to the loop."""
        txns = [t for t, _f in batch]
        try:
            results = self.store.submit_batch(txns)
        except BaseException as e:  # store seam itself died
            results = [e] * len(batch)
        self.counters["batches"] += 1
        key = str(_pow2_bucket(len(batch)))
        self.txns_per_batch_hist[key] = \
            self.txns_per_batch_hist.get(key, 0) + 1
        try:
            if loop is not None:
                loop.call_soon_threadsafe(self._resolve, batch,
                                          results)
        except RuntimeError:
            pass  # loop gone (teardown): callers are gone too

    def _resolve(self, batch, results) -> None:
        for (_t, fut), res in zip(batch, results):
            if fut.done():
                continue  # caller cancelled; the txn still committed
            if isinstance(res, BaseException):
                self.counters["commit_errors"] += 1
                fut.set_exception(res)
            else:
                fut.set_result(None)
