"""RGWLite: the S3 op surface (bucket/object/multipart) over RADOS (port
of ceph_tpu/rgw/gateway.py).

Reference parity:
- RGWPutObj::execute (Ceph's src/rgw/rgw_op.cc:3712) — atomic
  object PUT through the processor pipeline, head object carrying the
  manifest (AtomicObjectProcessor, rgw_putobj_processor.h:173).
- Multipart: init (RGWInitMultipart rgw_op.cc:5778), per-part upload
  (MultipartObjectProcessor rgw_putobj_processor.h:211 — parts live in
  `_multipart_<key>.<upload_id>.<num>` objects), complete
  (RGWCompleteMultipart rgw_op.cc:5933 — part manifests stitched in
  part order, multipart ETag = hash-of-hashes "-<nparts>").
- Bucket index: cls_rgw omap entries in the reference; here a JSON
  index object per bucket (the omap op surface is a separate
  milestone), updated read-modify-write.

Data placement: object data goes to the bucket's DATA pool (typically
erasure-coded — BASELINE #5 uses EC 8+3); index/meta JSON docs go to a
replicated META pool, mirroring the reference's pool split
(default.rgw.buckets.data vs .index/.meta).

Versioning (rgw_op.cc:3712 RGWPutObj under versioning): an enabled
bucket keeps every PUT as an immutable version (newest first in a
per-key versions doc); deletes insert delete markers; GET serves the
newest non-marker version or a named versionId.  Suspended buckets
write the "null" version in place.  Lifecycle (rgw_lc.cc) expires
current objects, prunes noncurrent versions, and aborts stale
multipart uploads on a sweep; replaced/deleted stripes are DEFERRED
to a GC queue (rgw_gc.cc role) drained by gc_process(), so a crash
between index update and data delete leaks an entry, not objects.

ETags are S3-compatible: hex MD5 of content for simple PUTs, and the
multipart form md5(concat(part md5 digests))-"<nparts>" for completed
multipart uploads — what stock S3 clients verify against.

etag_hash="crc32c" is the deployment knob for CPU-constrained
gateways: MD5 is a serial ~0.5 GiB/s/core hash with no integrity role
here (shard durability is covered end-to-end by the EC hinfo crc32c
ledger and per-frame wire crcs), and S3 itself does not promise
ETag==MD5 for every object (multipart and SSE-KMS objects already
return non-MD5 ETags).  Default stays "md5" for stock-client interop.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Any, Dict, List, Optional, Tuple

from ceph_tpu_torch.rgw.put_processor import (
    DEFAULT_STRIPE_SIZE,
    Manifest,
    PutObjProcessor,
    StripeWriter,
)

MULTIPART_PREFIX = "_multipart_"

# bucket versioning states (RGWBucketVersioningStatus)
VER_OFF = "off"
VER_ENABLED = "enabled"
VER_SUSPENDED = "suspended"

# canned ACLs (rgw_acl_s3.cc's rgw_canned_acl set, minus the
# aws-exec/log-delivery grants that have no meaning here).  The
# reference also stores full grant lists; canned policies cover the
# practical surface and stay one word in metadata.
CANNED_ACLS = ("private", "public-read", "public-read-write",
               "authenticated-read")


class RGWError(Exception):
    def __init__(self, code: str, what: str = ""):
        super().__init__(f"{code}: {what}")
        self.code = code


def _etag(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


class RGWLite:
    """One gateway instance over a connected RadosClient."""

    def __init__(self, client, data_pool: str, meta_pool: str,
                 stripe_size: int = DEFAULT_STRIPE_SIZE,
                 aio_window: int = 8, etag_hash: str = "md5",
                 zone: str = "default"):
        self.client = client
        self.etag_hash = etag_hash
        self.data = client.open_ioctx(data_pool)
        self.meta = client.open_ioctx(meta_pool)
        self.stripe_size = stripe_size
        self.aio_window = aio_window
        # multisite zone identity (rgw_zone.h role): stamped into
        # every change-log entry so a sync peer can tell local writes
        # from replicated ones (active-active loop prevention)
        self.zone = zone
        self._uploads = 0
        self._writes = 0
        self._log_ns: Optional[int] = None  # change-log key ratchet
        # serializes read-modify-writes of upload/bucket meta docs
        # within this gateway instance (one gateway per cluster in this
        # tier; multi-gateway index updates need the omap op milestone)
        self._meta_locks: Dict[str, "asyncio.Lock"] = {}
        self._gc_task = None  # background sweep (start_gc)

    def _etag_of(self, data: bytes) -> str:
        """Content ETag under the configured hash (class docstring)."""
        if self.etag_hash == "crc32c":
            from ceph_tpu_torch.ops import checksum as cks

            return "%08x" % cks.crc32c(0xFFFFFFFF, data)
        return _etag(data)

    def _etag_from_manifest(self, manifest: Manifest, data) -> str:
        """crc32c-mode ETag without re-reading the object: stitch the
        OSD-computed per-stripe content digests from the write replies
        (StripeWriter._write).  crc32c is affine in the seed, so
        crc(S1||S2, seed) = zeros(crc1, len2) ^ crc2 ^ zeros(seed, len2)
        — the crc32c_combine/zeros folding discipline
        (Ceph's src/common/crc32c.cc:216-239).  Falls back to
        hashing the bytes when any stripe lacks a digest (replicated
        data pools don't return one)."""
        from ceph_tpu_torch.ops import checksum as cks

        if self.etag_hash != "crc32c" or not manifest.stripes \
                or any("crc" not in st for st in manifest.stripes):
            return self._etag_of(bytes(data) if not isinstance(
                data, (bytes, bytearray, memoryview)) else data)
        crc = manifest.stripes[0]["crc"]
        for st in manifest.stripes[1:]:
            # stripe crcs are 0xFFFFFFFF-seeded; linearity folds the
            # seed compensation into one combine:
            #   crc(A||B, s) = combine(crc_A ^ s, crc_B_seeded_s, |B|)
            crc = cks.crc32c_combine(crc ^ 0xFFFFFFFF, st["crc"],
                                     st["size"])
        return "%08x" % crc

    def _meta_lock(self, key: str):
        import asyncio

        lock = self._meta_locks.get(key)
        if lock is None:
            lock = self._meta_locks[key] = asyncio.Lock()
        return lock

    def _write_id(self) -> str:
        """Unique suffix per PUT: an overwrite writes FRESH stripe
        objects, so a failed upload's cleanup can never delete the live
        object's data and readers never see torn old/new stripes
        (the reference's rgw_obj random-oid-prefix discipline)."""
        self._writes += 1
        return f"w{self._writes}-{int(time.time() * 1000):x}"

    # -- meta-doc helpers (JSON docs in the meta pool) ---------------------

    async def _load(self, oid: str) -> Optional[Dict]:
        try:
            raw = await self.meta.read(oid)
        except Exception:
            return None
        return json.loads(raw.decode())

    async def _store(self, oid: str, doc: Dict) -> None:
        await self.meta.write_full(oid, json.dumps(doc).encode())

    # meta-oid components are joined with the unit separator so bucket
    # or key names containing dots/slashes can never collide
    _SEP = "\x1f"

    @classmethod
    def _meta_oid(cls, kind: str, *parts: str) -> str:
        return cls._SEP.join((kind,) + parts)

    @classmethod
    def _bucket_oid(cls, bucket: str) -> str:
        return cls._meta_oid("bucket.index", bucket)

    @classmethod
    def _upload_oid(cls, bucket: str, key: str, upload_id: str) -> str:
        return cls._meta_oid("multipart", bucket, key, upload_id)

    def _head_oid(self, bucket: str, key: str) -> str:
        return self._SEP.join((bucket, key))

    @classmethod
    def _versions_oid(cls, bucket: str, key: str) -> str:
        return cls._meta_oid("versions", bucket, key)

    @classmethod
    def _gc_oid(cls, shard: int = 0) -> str:
        # shard 0 keeps the pre-sharding name so legacy queue docs
        # drain without migration
        return cls._meta_oid("gc") if shard == 0 \
            else cls._meta_oid("gc", str(shard))

    # -- multisite change log (the datalog/bilog role) ---------------------
    #
    # Reference parity: rgw_datalog.h / cls_rgw bilog — every bucket
    # or object mutation appends a marker-ordered entry to a SHARDED
    # log that sync agents tail incrementally.  Entries are dirty-set
    # HINTS, not op payloads: a peer re-fetches the named key's
    # CURRENT state from this zone and reconciles (the
    # fetch_remote_obj discipline), so replay is idempotent and
    # ordering within a key is irrelevant past the newest entry.
    # Entry keys are time-ordered and unique per gateway; like the
    # index RMW above, one gateway instance per cluster is this
    # tier's deployment shape.

    LOG_SHARDS = 8

    @classmethod
    def _synclog_oid(cls, shard: int) -> str:
        return cls._meta_oid("sync.log", str(shard))

    def _log_shard(self, bucket: str) -> int:
        # process-stable hash (builtin hash() is salted per process;
        # shard assignment must survive gateway restarts)
        from ceph_tpu_torch.ops.rjenkins import ceph_str_hash_rjenkins

        return ceph_str_hash_rjenkins(bucket.encode()) \
            % self.LOG_SHARDS

    async def _next_log_key(self) -> str:
        """Monotonic, time-ordered key for log/queue entries: a
        backwards clock step (NTP) must never mint keys below a
        peer's saved marker — those entries would be invisible to
        sync and then trimmed.  Seeded from the persisted log tail on
        first use so the ratchet survives restarts too."""
        self._writes += 1
        if self._log_ns is None:
            self._log_ns = await self._log_tail_ns()
        ns = max(time.time_ns(), self._log_ns + 1)
        self._log_ns = ns
        return f"{ns:020d}.{self._writes}"

    async def _log_change(self, bucket: str,
                          key: Optional[str] = None,
                          origin: Optional[str] = None) -> None:
        entry_key = await self._next_log_key()
        entry = {"bucket": bucket, "key": key,
                 "zone": origin or self.zone,
                 "ts": time.time()}
        await self.meta.omap_set(
            self._synclog_oid(self._log_shard(bucket)),
            {entry_key: json.dumps(entry).encode()})

    async def _log_tail_ns(self) -> int:
        tail = 0
        for shard in range(self.LOG_SHARDS):
            try:
                omap = await self.meta.omap_get(
                    self._synclog_oid(shard))
            except Exception:
                continue
            for k in omap:
                try:
                    tail = max(tail, int(k.split(".", 1)[0]))
                except ValueError:
                    pass
        return tail

    async def sync_log_entries(self, shard: int,
                               after: str = "",
                               limit: int = 1024
                               ) -> List[Tuple[str, Dict]]:
        """Log entries with key > after, oldest first."""
        try:
            omap = await self.meta.omap_get(self._synclog_oid(shard))
        except Exception:
            return []
        out = sorted((k, json.loads(v.decode()))
                     for k, v in omap.items() if k > after)
        return out[:limit]

    async def sync_peer_position(self, peer: str, shard: int,
                                 marker: str) -> None:
        """A peer records how far it has applied this shard — the
        trim floor (the reference's per-peer sync status markers)."""
        await self.meta.omap_set(
            self._meta_oid("sync.peers", peer, str(shard)),
            {"marker": marker.encode()})

    # -- users (rgw_user / radosgw-admin role) -----------------------------
    #
    # Durable user records in the meta pool: one doc per uid plus an
    # access-key index omap for O(1) auth lookups.  The reference
    # stores these through RGWUserCtl/cls_user; same shape, JSON docs.

    USER_KEYS_OID = "user.keys"

    @classmethod
    def _user_oid(cls, uid: str) -> str:
        return cls._meta_oid("user", uid)

    async def user_create(self, uid: str, display_name: str = "",
                          access_key: Optional[str] = None,
                          secret_key: Optional[str] = None) -> Dict:
        """Note: a gateway's STATIC bootstrap keys (S3Frontend users
        dict) take precedence over same-named durable keys — pick
        generated keys (the default) to stay clear of them."""
        if await self._load(self._user_oid(uid)) is not None:
            raise RGWError("UserAlreadyExists", uid)
        import os as _os

        access_key = access_key or \
            "AK" + _os.urandom(9).hex().upper()
        secret_key = secret_key or _os.urandom(20).hex()
        from ceph_tpu_torch.rados.client import ObjectNotFound

        try:
            taken = await self.meta.omap_get(
                self._meta_oid(self.USER_KEYS_OID))
        except ObjectNotFound:
            taken = {}  # no users yet — any OTHER error must raise,
            # or a transient fault would disable the hijack guard
        if access_key in taken:
            # overwriting the index entry would hijack another
            # user's credential
            raise RGWError("KeyExists", access_key)
        doc = {"uid": uid, "display_name": display_name or uid,
               "keys": [{"access_key": access_key,
                         "secret_key": secret_key}],
               "suspended": False, "created": time.time()}
        await self._store(self._user_oid(uid), doc)
        await self.meta.omap_set(
            self._meta_oid(self.USER_KEYS_OID),
            {access_key: json.dumps(
                {"uid": uid, "secret": secret_key}).encode()})
        return doc

    async def user_info(self, uid: str) -> Dict:
        doc = await self._load(self._user_oid(uid))
        if doc is None:
            raise RGWError("NoSuchUser", uid)
        return doc

    async def user_list(self) -> List[str]:
        prefix = self._user_oid("")
        names = await self.meta.list_objects()
        return sorted(n[len(prefix):] for n in names
                      if n.startswith(prefix))

    async def user_set_suspended(self, uid: str,
                                 suspended: bool) -> None:
        doc = await self.user_info(uid)
        doc["suspended"] = bool(suspended)
        await self._store(self._user_oid(uid), doc)

    async def user_rm(self, uid: str) -> None:
        doc = await self.user_info(uid)
        await self.meta.omap_rm_keys(
            self._meta_oid(self.USER_KEYS_OID),
            [k["access_key"] for k in doc.get("keys", [])])
        await self.meta.remove(self._user_oid(uid))

    async def user_key_lookup(self, access_key: str
                              ) -> Optional[str]:
        """access key -> secret, or None (unknown / suspended).
        Transient cluster errors RAISE — "key unknown" and "meta
        pool unhealthy" must never look alike, or the frontend would
        evict valid cached credentials."""
        from ceph_tpu_torch.rados.client import ObjectNotFound

        try:
            omap = await self.meta.omap_get(
                self._meta_oid(self.USER_KEYS_OID))
        except ObjectNotFound:
            return None  # no users ever created
        raw = omap.get(access_key)
        if raw is None:
            return None
        rec = json.loads(raw.decode())
        try:
            if (await self.user_info(rec["uid"])).get("suspended"):
                return None
        except RGWError:
            return None  # index entry orphaned by a partial rm
        return rec["secret"]

    # -- bucket notifications (rgw_notify / pubsub role) -------------------
    #
    # Reference parity: Ceph's src/rgw/rgw_notify.cc +
    # cls_2pc_queue — per-bucket notification configs emit S3-shaped
    # event records on object mutations.  Zero-egress re-design: the
    # PERSISTENT QUEUE mode is the product (the reference has it too);
    # consumers pull and ack instead of receiving pushes.  Queue
    # objects are per-topic omaps with the same monotonic keys as the
    # sync log.

    @classmethod
    def _topic_oid(cls, topic: str) -> str:
        return cls._meta_oid("notify.topic", topic)

    async def put_bucket_notification(self, bucket: str,
                                      rules: List[Dict]) -> None:
        """rules: [{"id", "topic", "events": ["s3:ObjectCreated:*",
        ...], "filter_prefix": ""}] (PutBucketNotificationConfiguration
        role)."""
        for rule in rules:
            if not rule.get("topic"):
                raise RGWError("InvalidArgument", "rule needs a topic")
            if not rule.get("events"):
                # AWS rejects a configuration without Events; a
                # forgotten key must not silently subscribe to all
                raise RGWError("InvalidArgument", "rule needs events")
            for ev in rule["events"]:
                if not ev.startswith("s3:"):
                    raise RGWError("InvalidArgument",
                                   f"bad event {ev!r}")
        async with self._meta_lock(self._bucket_oid(bucket)):
            doc = await self._bucket(bucket)
            doc["notifications"] = list(rules)
            await self._store(self._bucket_oid(bucket), doc)
        await self._log_change(bucket)

    async def get_bucket_notification(self,
                                      bucket: str) -> List[Dict]:
        return (await self._bucket(bucket)).get("notifications", [])

    @staticmethod
    def _event_matches(rule: Dict, event: str, key: str) -> bool:
        if key is not None and \
                not key.startswith(rule.get("filter_prefix", "")):
            return False
        for want in rule.get("events", []):  # no events: match none
            if want.endswith("*"):
                if event.startswith(want[:-1]):
                    return True
            elif want == event:
                return True
        return False

    async def _notify_event(self, doc: Optional[Dict], bucket: str,
                            key: str, event: str,
                            **fields) -> None:
        """Append one event record to every matching topic queue.
        `doc` is the (possibly already-loaded) bucket doc — None
        loads it."""
        if doc is None:
            try:
                doc = await self._bucket(bucket)
            except RGWError:
                return
        rules = [r for r in doc.get("notifications", [])
                 if self._event_matches(r, event, key)]
        if not rules:
            return
        entry_key = await self._next_log_key()
        record = {"eventName": event, "bucket": bucket, "key": key,
                  "eventTime": time.time(), "zone": self.zone}
        record.update({k: v for k, v in fields.items()
                       if v is not None})
        raw = json.dumps(record).encode()
        for rule in rules:
            await self.meta.omap_set(
                self._topic_oid(rule["topic"]), {entry_key: raw})

    async def pull_notifications(self, topic: str, max_events: int = 100
                                 ) -> List[Tuple[str, Dict]]:
        """Oldest-first events with their ack keys (the persistent-
        queue consumer surface)."""
        from ceph_tpu_torch.rados.client import ObjectNotFound

        try:
            omap = await self.meta.omap_get(self._topic_oid(topic))
        except ObjectNotFound:
            return []  # topic never written — real I/O errors raise:
            # "empty queue" and "cluster unhealthy" must not look alike
        out = sorted((k, json.loads(v.decode()))
                     for k, v in omap.items())
        return out[:max_events]

    async def ack_notifications(self, topic: str,
                                keys: List[str]) -> None:
        if keys:
            await self.meta.omap_rm_keys(self._topic_oid(topic),
                                         list(keys))

    async def sync_log_trim(self, shard: int) -> int:
        """Drop entries every registered peer has applied (mdlog/
        datalog trim role).  Returns entries removed."""
        prefix = self._meta_oid("sync.peers", "")
        names = [n for n in await self.meta.list_objects()
                 if n.startswith(prefix)
                 and n.endswith(self._SEP + str(shard))]
        if not names:
            return 0
        floors = []
        for n in names:
            try:
                omap = await self.meta.omap_get(n)
                floors.append(omap.get("marker", b"").decode())
            except Exception:
                floors.append("")
        floor = min(floors)
        if not floor:
            return 0
        try:
            omap = await self.meta.omap_get(self._synclog_oid(shard))
        except Exception:
            return 0
        dead = [k for k in omap if k <= floor]
        if dead:
            await self.meta.omap_rm_keys(self._synclog_oid(shard),
                                         dead)
        return len(dead)

    # -- deferred stripe GC (rgw_gc.cc role) -------------------------------

    # GC queue shards (the rgw_gc_max_objs chain-shard role): mutation
    # churn across buckets spreads over GC_SHARDS independent queue
    # docs/locks instead of serializing on one hot object
    GC_SHARDS = 8

    async def _gc_load_locked(self, shard: int) -> Dict:
        """Load + normalize one GC shard doc (caller holds its lock).
        Legacy entries (pre-two-phase) get ids and count as ready."""
        doc = await self._load(self._gc_oid(shard)) or \
            {"entries": [], "next_id": 1}
        doc.setdefault("next_id", 1)
        for e in doc["entries"]:
            if "id" not in e:
                e["id"] = doc["next_id"]
                doc["next_id"] += 1
            e.setdefault("state", "ready")
        return doc

    async def _gc_defer(self, oids) -> List[Tuple[int, int]]:
        """Queue data objects for deferred deletion, state=PENDING.
        Two-phase against the index mutation (the cls_rgw chain-queue
        role, where the reference makes this atomic OSD-side): the
        entry lands BEFORE the index stops referencing the stripes, and
        only _gc_commit (called AFTER the index mutation persisted)
        makes it drainable.  A crash on either side of the index write
        therefore leaves a PENDING entry — a listable, reclaimable leak
        — never a deletion of still-referenced data and never a silent
        orphan.  Returns (shard, id) pairs for _gc_commit."""
        oids = [o for o in oids]
        if not oids:
            return []
        # one mutation's stripes land on one shard (one lock round
        # trip); successive mutations round-robin across shards
        shard = self._writes % self.GC_SHARDS
        async with self._meta_lock(self._gc_oid(shard)):
            doc = await self._gc_load_locked(shard)
            ids = []
            for o in oids:
                eid = doc["next_id"]
                doc["next_id"] += 1
                doc["entries"].append(
                    {"id": eid, "oid": o, "at": time.time(),
                     "state": "pending"})
                ids.append((shard, eid))
            await self._store(self._gc_oid(shard), doc)
        return ids

    async def _gc_commit(self, ids: List[Tuple[int, int]]) -> None:
        """Flip entries PENDING -> READY once the index mutation that
        dropped their references has persisted."""
        by_shard: Dict[int, set] = {}
        for shard, eid in ids:
            by_shard.setdefault(shard, set()).add(eid)
        for shard, want in by_shard.items():
            async with self._meta_lock(self._gc_oid(shard)):
                doc = await self._gc_load_locked(shard)
                for e in doc["entries"]:
                    if e["id"] in want:
                        e["state"] = "ready"
                await self._store(self._gc_oid(shard), doc)

    async def gc_list(self) -> List[Dict]:
        """Queue contents (rgw gc list): ready entries plus any
        pending leftovers from interrupted mutations."""
        out: List[Dict] = []
        for shard in range(self.GC_SHARDS):
            async with self._meta_lock(self._gc_oid(shard)):
                out.extend(
                    (await self._gc_load_locked(shard))["entries"])
        return out

    async def gc_process(self, max_entries: int = 0,
                         reclaim_pending_after: Optional[float] = None
                         ) -> int:
        """Drain READY queue entries (rgw gc process); returns entries
        removed.  Already-gone objects dequeue; any OTHER removal
        failure (down OSDs, timeouts) keeps its entry queued for the
        next sweep — dropping it would orphan the stripes, the exact
        leak deferred GC exists to prevent.  PENDING entries are
        skipped (their index mutation may never have committed, so the
        data may still be live) unless older than
        reclaim_pending_after — an explicit operator decision.

        Shard locks are held only around queue snapshots/updates, never
        across data-pool removals: a slow drain (down OSDs timing out)
        must not block PUT/DELETE mutations behind the queue docs."""
        from ceph_tpu_torch.rados.client import ObjectNotFound

        now = time.time()
        done = 0
        for shard in range(self.GC_SHARDS):
            async with self._meta_lock(self._gc_oid(shard)):
                doc = await self._gc_load_locked(shard)
                eligible = [
                    e for e in doc["entries"]
                    if e["state"] == "ready"
                    or (reclaim_pending_after is not None
                        and now - e["at"] >= reclaim_pending_after)]
                if max_entries:
                    eligible = eligible[:max_entries - done]
            # lock released: removals run against a snapshot
            removed_ids = set()
            for entry in eligible:
                try:
                    await self.data.remove(entry["oid"])
                except ObjectNotFound:
                    pass
                except Exception:
                    continue  # stays queued for the next sweep
                removed_ids.add(entry["id"])
                done += 1
            if removed_ids:
                async with self._meta_lock(self._gc_oid(shard)):
                    doc = await self._gc_load_locked(shard)
                    doc["entries"] = [e for e in doc["entries"]
                                      if e["id"] not in removed_ids]
                    await self._store(self._gc_oid(shard), doc)
            if max_entries and done >= max_entries:
                break
        return done

    def start_gc(self, interval: float = 30.0) -> None:
        """Spawn the background GC sweep (the rgw_gc worker-thread
        role).  Idempotent; stop with stop_gc()."""
        import asyncio

        if self._gc_task is not None and not self._gc_task.done():
            return

        async def sweep():
            import logging

            while True:
                await asyncio.sleep(interval)
                try:
                    await self.gc_process()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    # next sweep retries; entries never drop — but a
                    # persistently failing sweep must be VISIBLE or
                    # garbage accumulates behind a healthy-looking
                    # gateway
                    logging.getLogger("rgw").exception(
                        "gc sweep failed; will retry in %.0fs",
                        interval)

        self._gc_task = asyncio.get_running_loop().create_task(sweep())

    async def stop_gc(self) -> None:
        import asyncio

        if self._gc_task is not None:
            self._gc_task.cancel()
            try:
                await self._gc_task
            except asyncio.CancelledError:
                pass
            self._gc_task = None

    # -- versioning (RGWSetBucketVersioning / versioned PUT-GET-DEL) -------

    async def put_bucket_versioning(self, bucket: str, status: str,
                                    _origin: Optional[str] = None
                                    ) -> None:
        if status not in (VER_ENABLED, VER_SUSPENDED):
            raise RGWError("InvalidRequest", f"bad status {status!r}")
        async with self._meta_lock(self._bucket_oid(bucket)):
            doc = await self._bucket(bucket)
            doc["versioning"] = status
            await self._store(self._bucket_oid(bucket), doc)
        await self._log_change(bucket, origin=_origin)

    async def get_bucket_versioning(self, bucket: str) -> str:
        return (await self._bucket(bucket)).get("versioning", VER_OFF)

    def _new_version_id(self) -> str:
        self._writes += 1
        return f"v{int(time.time() * 1000):x}.{self._writes}"

    async def _versions(self, bucket: str, key: str) -> Dict:
        return await self._load(self._versions_oid(bucket, key))             or {"versions": []}

    async def list_object_versions(self, bucket: str,
                                   prefix: str = "") -> List[Dict]:
        """GET ?versions: every version and delete marker, newest
        first per key (RGWListBucketVersions)."""
        doc = await self._bucket(bucket)
        out: List[Dict] = []
        keys = sorted(set(doc["objects"])
                      | set(doc.get("versioned_keys", [])))
        for key in keys:
            if not key.startswith(prefix):
                continue
            vdoc = await self._versions(bucket, key)
            if vdoc["versions"]:
                for v in vdoc["versions"]:
                    out.append(dict(v, key=key))
            else:
                # never-versioned key: listed as VersionId "null"
                # (S3 lists unversioned objects this way)
                ent = doc["objects"][key]
                out.append({"key": key, "version_id": "null",
                            "etag": ent.get("etag", ""),
                            "size": ent.get("size", 0),
                            "mtime": ent.get("mtime", 0),
                            "delete_marker": False})
        return out

    # -- buckets -----------------------------------------------------------

    async def create_bucket(self, bucket: str, owner: str = "",
                            acl: str = "private",
                            _origin: Optional[str] = None) -> None:
        if acl not in CANNED_ACLS:
            raise RGWError("InvalidArgument", f"bad acl {acl!r}")
        if await self._load(self._bucket_oid(bucket)) is not None:
            raise RGWError("BucketAlreadyExists", bucket)
        await self._store(self._bucket_oid(bucket),
                          {"name": bucket, "objects": {},
                           "owner": owner, "acl": acl})
        await self._log_change(bucket, origin=_origin)

    # -- ACLs (rgw_acl.cc / RGWAccessControlPolicy role) -------------------

    async def get_bucket_acl_info(self, bucket: str) -> Dict[str, str]:
        doc = await self._bucket(bucket)
        return {"owner": doc.get("owner", ""),
                "acl": doc.get("acl", "private")}

    async def put_bucket_acl(self, bucket: str, acl: str,
                             _origin: Optional[str] = None) -> None:
        if acl not in CANNED_ACLS:
            raise RGWError("InvalidArgument", f"bad acl {acl!r}")
        async with self._meta_lock(self._bucket_oid(bucket)):
            doc = await self._bucket(bucket)
            doc["acl"] = acl
            await self._store(self._bucket_oid(bucket), doc)
        await self._log_change(bucket, origin=_origin)

    async def get_object_acl(self, bucket: str, key: str) -> str:
        doc = await self._bucket(bucket)
        entry = doc["objects"].get(key)
        if entry is None:
            raise RGWError("NoSuchKey", f"{bucket}/{key}")
        return entry.get("acl", "private")

    async def put_object_acl(self, bucket: str, key: str, acl: str,
                             _origin: Optional[str] = None) -> None:
        if acl not in CANNED_ACLS:
            raise RGWError("InvalidArgument", f"bad acl {acl!r}")
        async with self._meta_lock(self._bucket_oid(bucket)):
            doc = await self._bucket(bucket)
            entry = doc["objects"].get(key)
            if entry is None:
                raise RGWError("NoSuchKey", f"{bucket}/{key}")
            entry["acl"] = acl
            await self._store(self._bucket_oid(bucket), doc)
        await self._log_change(bucket, key, origin=_origin)

    async def _bucket(self, bucket: str) -> Dict:
        doc = await self._load(self._bucket_oid(bucket))
        if doc is None:
            raise RGWError("NoSuchBucket", bucket)
        return doc

    async def list_objects(self, bucket: str,
                           prefix: str = "") -> List[Dict[str, Any]]:
        doc = await self._bucket(bucket)
        return [dict(v, key=k)
                for k, v in sorted(doc["objects"].items())
                if k.startswith(prefix)]

    async def list_objects_v2(self, bucket: str, prefix: str = "",
                              delimiter: str = "",
                              continuation_token: str = "",
                              max_keys: int = 1000) -> Dict[str, Any]:
        """ListObjectsV2 (RGWListBucket::execute with v2 semantics):
        prefix filter, delimiter roll-up into CommonPrefixes,
        continuation token (start strictly after), max-keys
        truncation counting contents + prefixes."""
        doc = await self._bucket(bucket)
        if max_keys <= 0:
            # S3 semantics: max-keys=0 is a valid request returning no
            # entries and IsTruncated=false (a truncated=true answer
            # with an empty token would loop naive paginators forever)
            return {"contents": [], "common_prefixes": [],
                    "is_truncated": False, "next_token": ""}
        contents: List[Dict[str, Any]] = []
        prefixes: List[str] = []
        truncated = False
        next_token = ""
        last_seen = ""
        for key in sorted(doc["objects"]):
            if not key.startswith(prefix):
                continue
            if continuation_token and key <= continuation_token:
                continue
            if delimiter:
                rest = key[len(prefix):]
                cut = rest.find(delimiter)
                if cut >= 0:
                    cp = prefix + rest[:cut + len(delimiter)]
                    if prefixes and prefixes[-1] == cp:
                        last_seen = key
                        continue
                    if len(contents) + len(prefixes) >= max_keys:
                        truncated = True
                        break
                    prefixes.append(cp)
                    last_seen = key
                    continue
            if len(contents) + len(prefixes) >= max_keys:
                truncated = True
                break
            contents.append(dict(doc["objects"][key], key=key))
            last_seen = key
        if truncated:
            # the token is the LAST RETURNED key: continuation resumes
            # strictly after it (a first-excluded-key token would skip
            # that key on the next page)
            next_token = last_seen
        return {"contents": contents, "common_prefixes": prefixes,
                "is_truncated": truncated,
                "next_token": next_token if truncated else ""}

    # -- lifecycle (rgw_lc.cc role) ----------------------------------------

    async def put_bucket_lifecycle(self, bucket: str,
                                   rules: List[Dict],
                                   _origin: Optional[str] = None
                                   ) -> None:
        for rule in rules:
            if rule.get("status", "Enabled") not in ("Enabled",
                                                     "Disabled"):
                raise RGWError("InvalidRequest", "bad rule status")
            if not any(k in rule for k in
                       ("expiration_days", "noncurrent_days",
                        "abort_multipart_days")):
                raise RGWError("InvalidRequest",
                               "rule with no action")
        async with self._meta_lock(self._bucket_oid(bucket)):
            doc = await self._bucket(bucket)
            doc["lifecycle"] = list(rules)
            await self._store(self._bucket_oid(bucket), doc)
        await self._log_change(bucket, origin=_origin)

    async def get_bucket_lifecycle(self, bucket: str) -> List[Dict]:
        return (await self._bucket(bucket)).get("lifecycle", [])

    async def lifecycle_process(self,
                                now: Optional[float] = None
                                ) -> Dict[str, int]:
        """One LC sweep over every bucket (RGWLC::process): expire
        current objects, prune noncurrent versions, drop lone delete
        markers, abort stale multipart uploads.  `now` is injectable
        for tests."""
        now = time.time() if now is None else now
        stats = {"expired": 0, "noncurrent_pruned": 0,
                 "markers_removed": 0, "uploads_aborted": 0}
        for bucket in await self.list_buckets():
            doc = await self._bucket(bucket)
            rules = [r for r in doc.get("lifecycle", [])
                     if r.get("status", "Enabled") == "Enabled"]
            if not rules:
                continue
            for rule in rules:
                await self._lc_rule(bucket, rule, now, stats)
        return stats

    async def _lc_rule(self, bucket: str, rule: Dict, now: float,
                       stats: Dict[str, int]) -> None:
        prefix = rule.get("prefix", "")
        day = 86400.0
        exp = rule.get("expiration_days")
        if exp is not None:
            doc = await self._bucket(bucket)
            for key, ent in list(doc["objects"].items()):
                if key.startswith(prefix) and \
                        now - ent.get("mtime", now) > exp * day:
                    await self.delete_object(bucket, key)
                    stats["expired"] += 1
        nc = rule.get("noncurrent_days")
        if nc is not None:
            doc = await self._bucket(bucket)
            for key in list(doc.get("versioned_keys", [])):
                if not key.startswith(prefix):
                    continue
                vdoc = await self._versions(bucket, key)
                for v in vdoc["versions"][1:]:
                    if now - v["mtime"] > nc * day:
                        await self._delete_version(bucket, key,
                                                   v["version_id"])
                        stats["noncurrent_pruned"] += 1
                # a delete marker left as the ONLY version expires
                # with it (expired-object delete marker cleanup)
                vdoc = await self._versions(bucket, key)
                if len(vdoc["versions"]) == 1 and \
                        vdoc["versions"][0]["delete_marker"]:
                    await self._delete_version(
                        bucket, key, vdoc["versions"][0]["version_id"])
                    stats["markers_removed"] += 1
        ab = rule.get("abort_multipart_days")
        if ab is not None:
            uploads = await self.list_multipart_uploads(bucket)
            for up in uploads:
                if up["key"].startswith(prefix) and \
                        now - up.get("created", now) > ab * day:
                    await self.abort_multipart(bucket, up["key"],
                                               up["upload_id"])
                    stats["uploads_aborted"] += 1

    async def list_multipart_uploads(self, bucket: str) -> List[Dict]:
        """In-progress uploads for a bucket (ListMultipartUploads)."""
        prefix = self._meta_oid("multipart", bucket, "")
        names = await self.meta.list_objects()
        out = []
        for n in names:
            if not n.startswith(prefix):
                continue
            doc = await self._load(n)
            if doc is not None:
                _, _, key, upload_id = n.split(self._SEP, 3)
                out.append({"key": key, "upload_id": upload_id,
                            "created": doc.get("created")})
        return out

    async def list_buckets(self) -> List[str]:
        """ListAllMyBuckets role — the bucket.index objects ARE the
        truth (a separate registry doc could desync on a crash between
        two writes); enumerate them from the meta pool."""
        prefix = self._bucket_oid("")
        names = await self.meta.list_objects()
        return sorted(n[len(prefix):] for n in names
                      if n.startswith(prefix))

    async def delete_bucket(self, bucket: str,
                            _origin: Optional[str] = None) -> None:
        # emptiness check + removal under the bucket meta lock: a PUT
        # linking a new object concurrently must not be orphaned by a
        # delete that checked before the link landed
        async with self._meta_lock(self._bucket_oid(bucket)):
            doc = await self._bucket(bucket)
            if doc["objects"] or doc.get("versioned_keys"):
                raise RGWError("BucketNotEmpty", bucket)
            await self.meta.remove(self._bucket_oid(bucket))
        await self._log_change(bucket, origin=_origin)

    async def head_object(self, bucket: str, key: str
                          ) -> Dict[str, Any]:
        doc = await self._bucket(bucket)
        entry = doc["objects"].get(key)
        if entry is None:
            raise RGWError("NoSuchKey", f"{bucket}/{key}")
        return dict(entry, key=key)

    # -- atomic PUT / GET / DELETE ----------------------------------------

    async def put_object(self, bucket: str, key: str,
                         data: bytes) -> str:
        etag, _vid = await self.put_object_ex(bucket, key, data)
        return etag

    async def put_object_ex(self, bucket: str, key: str,
                            data: bytes, acl: Optional[str] = None,
                            _origin: Optional[str] = None
                            ) -> Tuple[str, Optional[str]]:
        """Single-shot PUT (RGWPutObj + AtomicObjectProcessor role);
        under versioning every PUT lands as a new immutable version
        (rgw_op.cc:3712's versioned path).  Returns (etag, version_id)
        — version_id None on unversioned buckets.  _origin: the
        originating zone when applied by a sync agent (rides the
        change log so the write is not echoed back)."""
        await self._bucket(bucket)  # existence check before the write
        writer = StripeWriter(self.data, self.aio_window)
        prefix = f"{self._head_oid(bucket, key)}.{self._write_id()}"
        proc = PutObjProcessor(writer, prefix, self.stripe_size)
        try:
            await proc.process(data)
            manifest = await proc.complete()
        except Exception:
            await writer.cancel()
            raise
        etag = self._etag_from_manifest(manifest, data)
        return await self._link_by_status(bucket, key, manifest, etag,
                                          acl=acl, _origin=_origin)

    async def _link_by_status(self, bucket: str, key: str,
                              manifest: Manifest, etag: str,
                              acl: Optional[str] = None,
                              _origin: Optional[str] = None,
                              event: str = "s3:ObjectCreated:Put"
                              ) -> Tuple[str, Optional[str]]:
        """Link a finished upload under ONE bucket lock, adjudicating
        the versioning status AT LINK TIME — a versioning flip during
        the (long) stripe upload must not split-brain the key into a
        head doc coexisting with a versions doc.  Shared by atomic PUT
        and multipart completion."""
        async with self._meta_lock(self._bucket_oid(bucket)):
            doc = await self._bucket(bucket)
            status = doc.get("versioning", VER_OFF)
            vdoc = await self._versions(bucket, key)
            if status == VER_OFF and not vdoc["versions"]:
                await self._link_locked(doc, bucket, key, manifest,
                                        etag, acl=acl)
                await self._log_change(bucket, key, origin=_origin)
                await self._notify_event(doc, bucket, key, event,
                                         etag=etag,
                                         size=manifest.obj_size)
                return etag, None
            # versioned path — also when the key ALREADY has versions
            # with versioning since switched off: existing versions
            # must never be silently clobbered by a head doc
            vid = await self._link_version_locked(
                doc, vdoc, bucket, key, manifest, etag,
                null_version=(status != VER_ENABLED), acl=acl)
            await self._log_change(bucket, key, origin=_origin)
            await self._notify_event(doc, bucket, key, event,
                                     etag=etag,
                                     size=manifest.obj_size,
                                     version_id=vid)
            return etag, vid

    async def _link_locked(self, doc: Dict, bucket: str, key: str,
                           manifest: Manifest, etag: str,
                           acl: Optional[str] = None) -> None:
        """Unversioned head flip + index entry (the bucket index
        transaction role of AtomicObjectProcessor::complete); caller
        holds the bucket lock.  Replaced stripes go to deferred GC."""
        head_doc = self._meta_oid("head", bucket, key)
        old = await self._load(head_doc)
        gc_ids: List[int] = []
        if old is not None:
            # defer BEFORE the head flip (entry-lands-first invariant):
            # a crash mid-overwrite leaves a pending entry, not an
            # untracked orphan of the replaced stripes
            new_oids = {s["oid"] for s in manifest.stripes}
            gc_ids = await self._gc_defer(
                stripe["oid"] for stripe in old["manifest"]["stripes"]
                if stripe["oid"] not in new_oids)
        await self._store(head_doc, {"manifest": manifest.to_dict(),
                                     "etag": etag})
        entry = {"size": manifest.obj_size,
                 "etag": etag, "mtime": time.time()}
        if acl is None:
            # an overwrite without an explicit canned ACL keeps the
            # previous object ACL (S3: each PUT resets to private
            # unless x-amz-acl given; kept here because the frontend
            # always passes the effective canned value)
            prev = doc["objects"].get(key, {})
            if "acl" in prev:
                entry["acl"] = prev["acl"]
        else:
            entry["acl"] = acl
        doc["objects"][key] = entry
        await self._store(self._bucket_oid(bucket), doc)
        await self._gc_commit(gc_ids)

    async def _migrate_legacy_head(self, bucket: str,
                                   key: str) -> List[Dict]:
        """First versioned write to a pre-versioning key: fold the
        legacy head into a "null" version so it stays addressable."""
        head = await self._load(self._meta_oid("head", bucket, key))
        if head is None:
            return []
        await self.meta.remove(self._meta_oid("head", bucket, key))
        return [{"version_id": "null", "etag": head["etag"],
                 "manifest": head["manifest"],
                 "size": head["manifest"]["obj_size"],
                 "mtime": time.time(), "delete_marker": False}]

    async def _link_version_locked(self, doc: Dict, vdoc: Dict,
                                   bucket: str, key: str,
                                   manifest: Manifest, etag: str,
                                   null_version: bool,
                                   acl: Optional[str] = None) -> str:
        vid = "null" if null_version else self._new_version_id()
        entry = {"version_id": vid, "etag": etag,
                 "manifest": manifest.to_dict(),
                 "size": manifest.obj_size, "mtime": time.time(),
                 "delete_marker": False}
        if not vdoc["versions"]:
            vdoc["versions"] = await self._migrate_legacy_head(
                bucket, key)
        gc_ids: List[int] = []
        if null_version:
            # suspended: the new null version REPLACES a previous
            # null (its stripes go to GC); other versions survive
            for old in vdoc["versions"]:
                if old["version_id"] == "null" and \
                        not old["delete_marker"]:
                    gc_ids.extend(await self._gc_defer(
                        st["oid"]
                        for st in old["manifest"]["stripes"]))
            vdoc["versions"] = [v for v in vdoc["versions"]
                                if v["version_id"] != "null"]
        vdoc["versions"].insert(0, entry)
        await self._store(self._versions_oid(bucket, key), vdoc)
        head_entry = {"size": manifest.obj_size,
                      "etag": etag, "mtime": entry["mtime"]}
        if acl is not None:
            head_entry["acl"] = acl
        elif "acl" in doc["objects"].get(key, {}):
            head_entry["acl"] = doc["objects"][key]["acl"]
        doc["objects"][key] = head_entry
        vk = set(doc.setdefault("versioned_keys", []))
        vk.add(key)
        doc["versioned_keys"] = sorted(vk)
        await self._store(self._bucket_oid(bucket), doc)
        await self._gc_commit(gc_ids)
        return vid

    async def _manifest(self, bucket: str, key: str,
                        version_id: Optional[str] = None
                        ) -> Tuple[Manifest, str]:
        vdoc = await self._load(self._versions_oid(bucket, key))
        if vdoc is not None and vdoc["versions"]:
            if version_id is None:
                newest = vdoc["versions"][0]
                if newest["delete_marker"]:
                    raise RGWError("NoSuchKey",
                                   f"{bucket}/{key} (delete marker)")
                entry = newest
            else:
                entry = next((v for v in vdoc["versions"]
                              if v["version_id"] == version_id), None)
                if entry is None:
                    raise RGWError("NoSuchVersion",
                                   f"{bucket}/{key}@{version_id}")
                if entry["delete_marker"]:
                    raise RGWError("MethodNotAllowed",
                                   "version is a delete marker")
            return Manifest.from_dict(entry["manifest"]), entry["etag"]
        if version_id is not None and version_id != "null":
            raise RGWError("NoSuchVersion",
                           f"{bucket}/{key}@{version_id}")
        head = await self._load(self._meta_oid("head", bucket, key))
        if head is None:
            raise RGWError("NoSuchKey", f"{bucket}/{key}")
        return Manifest.from_dict(head["manifest"]), head["etag"]

    async def get_object(self, bucket: str, key: str) -> bytes:
        data, _etag_ = await self.get_object_ex(bucket, key)
        return data

    async def get_object_ex(self, bucket: str, key: str,
                            version_id: Optional[str] = None,
                            byte_range: Optional[Tuple[int, int]] = None,
                            range_resolver=None
                            ) -> Tuple[bytes, str]:
        """GET: walk the manifest, fetch stripes concurrently;
        returns (bytes, etag) from ONE head load.

        byte_range=(first, last) — absolute inclusive offsets —
        fetches ONLY the overlapping sub-ranges of the touched
        stripes: a ranged S3 GET of a huge object moves O(range), not
        O(object), and each sub-read rides the OSD's ranged EC read
        path (and counts as a tier read).  range_resolver is the
        single-head-load form: called with the authoritative
        manifest.obj_size, it returns (first, last) or None (serve
        the full object) — or raises, which propagates (the
        frontend's 416)."""
        import asyncio

        manifest, etag = await self._manifest(bucket, key, version_id)
        sem = asyncio.Semaphore(self.aio_window)

        if range_resolver is not None:
            byte_range = range_resolver(manifest.obj_size)
        if byte_range is not None:
            first, last = byte_range
            last = min(last, manifest.obj_size - 1)
            reads: List[Tuple[str, int, int]] = []
            off = 0
            for s in manifest.stripes:
                lo, hi = max(first, off), min(last, off + s["size"] - 1)
                if lo <= hi:
                    reads.append((s["oid"], lo - off, hi - lo + 1))
                off += s["size"]
                if off > last:
                    break

            async def fetch_range(oid: str, ofs: int, ln: int) -> bytes:
                async with sem:
                    return await self.data.read(oid, offset=ofs,
                                                length=ln)

            parts = await asyncio.gather(
                *(fetch_range(*r) for r in reads))
            return b"".join(parts), etag

        async def fetch(stripe: Dict) -> bytes:
            async with sem:
                return await self.data.read(stripe["oid"])

        parts = await asyncio.gather(
            *(fetch(s) for s in manifest.stripes))
        out = b"".join(p[:s["size"]]
                       for p, s in zip(parts, manifest.stripes))
        if len(out) != manifest.obj_size:
            raise RGWError("IncompleteBody",
                           f"{len(out)} != {manifest.obj_size}")
        return out, etag

    async def delete_object(self, bucket: str, key: str,
                            version_id: Optional[str] = None,
                            _origin: Optional[str] = None
                            ) -> Optional[str]:
        out = await self._delete_object_impl(bucket, key, version_id)
        await self._log_change(bucket, key, origin=_origin)
        await self._notify_event(
            None, bucket, key,
            "s3:ObjectRemoved:DeleteMarkerCreated" if out is not None
            else "s3:ObjectRemoved:Delete",
            version_id=out or version_id)
        return out

    async def _delete_object_impl(self, bucket: str, key: str,
                                  version_id: Optional[str] = None
                                  ) -> Optional[str]:
        """DELETE, adjudicated under ONE bucket lock.  Unversioned:
        drop the object (stripes deferred to GC).  Versioning enabled
        + no versionId: insert a DELETE MARKER (versions survive).
        versionId given: permanently remove that version — "null"
        addresses a never-versioned object too; anything else on an
        unversioned key is NoSuchVersion (rgw_op.cc RGWDeleteObj
        versioned semantics).  Returns the delete marker's version id
        when one was created."""
        async with self._meta_lock(self._bucket_oid(bucket)):
            doc = await self._bucket(bucket)
            status = doc.get("versioning", VER_OFF)
            vdoc = await self._versions(bucket, key)
            versioned = bool(vdoc["versions"])
            if version_id is not None:
                if versioned:
                    self._drop_version_locked(vdoc, version_id)
                    await self._finish_versions_locked(doc, bucket,
                                                       key, vdoc)
                    return None
                if version_id != "null":
                    raise RGWError("NoSuchVersion",
                                   f"{bucket}/{key}@{version_id}")
                # versionId=null on a never-versioned key: the plain
                # object IS the null version — permanent delete
                await self._delete_unversioned_locked(doc, bucket,
                                                      key)
                return None
            if status == VER_ENABLED:
                if not vdoc["versions"]:
                    vdoc["versions"] = \
                        await self._migrate_legacy_head(bucket, key)
                    if not vdoc["versions"]:
                        raise RGWError("NoSuchKey", f"{bucket}/{key}")
                marker = {"version_id": self._new_version_id(),
                          "etag": "", "manifest": None, "size": 0,
                          "mtime": time.time(), "delete_marker": True}
                vdoc["versions"].insert(0, marker)
                await self._store(self._versions_oid(bucket, key),
                                  vdoc)
                doc["objects"].pop(key, None)
                vk = set(doc.setdefault("versioned_keys", []))
                vk.add(key)
                doc["versioned_keys"] = sorted(vk)
                await self._store(self._bucket_oid(bucket), doc)
                return marker["version_id"]
            if versioned:
                # suspended: remove the null version and leave a null
                # delete marker, in ONE locked mutation (S3 suspended
                # semantics; a two-lock version let a concurrent null
                # PUT interleave and duplicate the null id)
                self._drop_version_locked(vdoc, "null",
                                          missing_ok=True)
                gc_ids = await self._gc_defer(vdoc.pop("_gc", []))
                marker = {"version_id": "null", "etag": "",
                          "manifest": None, "size": 0,
                          "mtime": time.time(), "delete_marker": True}
                vdoc["versions"].insert(0, marker)
                await self._store(self._versions_oid(bucket, key),
                                  vdoc)
                doc["objects"].pop(key, None)
                await self._store(self._bucket_oid(bucket), doc)
                await self._gc_commit(gc_ids)
                return "null"
            await self._delete_unversioned_locked(doc, bucket, key)
            return None

    async def _delete_unversioned_locked(self, doc: Dict, bucket: str,
                                         key: str) -> None:
        head = await self._load(self._meta_oid("head", bucket, key))
        if head is None:
            raise RGWError("NoSuchKey", f"{bucket}/{key}")
        gc_ids = await self._gc_defer(
            st["oid"] for st in head["manifest"]["stripes"])
        await self.meta.remove(self._meta_oid("head", bucket, key))
        doc["objects"].pop(key, None)
        await self._store(self._bucket_oid(bucket), doc)
        await self._gc_commit(gc_ids)

    def _drop_version_locked(self, vdoc: Dict, version_id: str,
                             missing_ok: bool = False) -> None:
        """Remove one version from an in-memory vdoc, deferring its
        stripes; caller persists + refreshes the index."""
        entry = next((v for v in vdoc["versions"]
                      if v["version_id"] == version_id), None)
        if entry is None:
            if missing_ok:
                return
            raise RGWError("NoSuchVersion", version_id)
        vdoc["versions"] = [v for v in vdoc["versions"]
                            if v["version_id"] != version_id]
        if entry["manifest"] is not None:
            vdoc.setdefault("_gc", []).extend(
                st["oid"] for st in entry["manifest"]["stripes"])

    async def _finish_versions_locked(self, doc: Dict, bucket: str,
                                      key: str, vdoc: Dict) -> None:
        """Persist a mutated vdoc + refresh the bucket index; flush
        any stripes _drop_version_locked queued."""
        gc_ids = await self._gc_defer(vdoc.pop("_gc", []))
        if vdoc["versions"]:
            await self._store(self._versions_oid(bucket, key), vdoc)
        else:
            try:
                await self.meta.remove(self._versions_oid(bucket,
                                                          key))
            except Exception:
                pass
            vk = set(doc.get("versioned_keys", []))
            vk.discard(key)
            doc["versioned_keys"] = sorted(vk)
        # refresh the plain listing: newest surviving non-marker
        newest = next((v for v in vdoc["versions"]
                       if not v["delete_marker"]), None)
        newest_is_head = vdoc["versions"] and \
            vdoc["versions"][0] is newest
        if newest is not None and newest_is_head:
            doc["objects"][key] = {"size": newest["size"],
                                   "etag": newest["etag"],
                                   "mtime": newest["mtime"]}
        else:
            doc["objects"].pop(key, None)
        await self._store(self._bucket_oid(bucket), doc)
        await self._gc_commit(gc_ids)

    async def _delete_version(self, bucket: str, key: str,
                              version_id: str,
                              missing_ok: bool = False) -> None:
        """Public per-version delete (lock-acquiring wrapper)."""
        async with self._meta_lock(self._bucket_oid(bucket)):
            doc = await self._bucket(bucket)
            vdoc = await self._versions(bucket, key)
            self._drop_version_locked(vdoc, version_id, missing_ok)
            await self._finish_versions_locked(doc, bucket, key, vdoc)

    # -- multisite apply seam (fetch_remote_obj role) ----------------------

    async def sync_replace_versions(self, bucket: str, key: str,
                                    src_versions: List[Dict],
                                    blobs: Dict[str, bytes],
                                    origin: str) -> None:
        """Make this zone's version set for (bucket, key) EXACTLY
        match a peer's, preserving version ids, mtimes and order (the
        reference replicates version ids across zones —
        rgw_data_sync.cc fetch_remote_obj with preset attrs).
        src_versions: the peer's newest-first version list; blobs:
        data for version ids this zone lacks.  Stripes are written
        before the lock; dropped versions' stripes go to GC."""
        uploaded: Dict[str, Manifest] = {}
        for v in src_versions:
            vid = v["version_id"]
            if v.get("delete_marker") or vid not in blobs:
                continue
            writer = StripeWriter(self.data, self.aio_window)
            prefix = (f"{self._head_oid(bucket, key)}"
                      f".{self._write_id()}")
            proc = PutObjProcessor(writer, prefix, self.stripe_size)
            try:
                await proc.process(blobs[vid])
                uploaded[vid] = await proc.complete()
            except Exception:
                await writer.cancel()
                raise
        async with self._meta_lock(self._bucket_oid(bucket)):
            doc = await self._bucket(bucket)
            vdoc = await self._versions(bucket, key)
            if not vdoc["versions"]:
                # a plain pre-versioning head here must fold into the
                # "null" version (same discipline as the local
                # versioned-write path) or its head doc and stripes
                # would be orphaned under the new version set
                vdoc["versions"] = await self._migrate_legacy_head(
                    bucket, key)
            have = {v["version_id"]: v for v in vdoc["versions"]}
            new_list: List[Dict] = []
            for v in src_versions:
                vid = v["version_id"]
                if vid in uploaded:
                    # freshly fetched peer data WINS over a same-id
                    # local entry (a divergent "null" version): the
                    # loser's stripes are garbage
                    old = have.pop(vid, None)
                    if old is not None and old.get("manifest"):
                        vdoc.setdefault("_gc", []).extend(
                            st["oid"]
                            for st in old["manifest"]["stripes"])
                    m = uploaded[vid]
                    new_list.append(
                        {"version_id": vid,
                         "etag": v.get("etag", ""),
                         "manifest": m.to_dict(),
                         "size": m.obj_size,
                         "mtime": v.get("mtime", time.time()),
                         "delete_marker": False})
                elif vid in have:
                    new_list.append(have.pop(vid))
                elif v.get("delete_marker"):
                    new_list.append(
                        {"version_id": vid, "etag": "",
                         "manifest": None, "size": 0,
                         "mtime": v.get("mtime", time.time()),
                         "delete_marker": True})
                # else: peer listed it but no blob arrived (raced a
                # source-side delete) — next log entry reconciles
            # versions only we had: their stripes are garbage now
            vdoc["versions"] = new_list
            for dead in have.values():
                if dead.get("manifest"):
                    vdoc.setdefault("_gc", []).extend(
                        st["oid"]
                        for st in dead["manifest"]["stripes"])
            if new_list:
                vk = set(doc.setdefault("versioned_keys", []))
                vk.add(key)
                doc["versioned_keys"] = sorted(vk)
            await self._finish_versions_locked(doc, bucket, key,
                                               vdoc)
        await self._log_change(bucket, key, origin=origin)

    # -- multipart ---------------------------------------------------------

    async def init_multipart(self, bucket: str, key: str,
                             acl: Optional[str] = None) -> str:
        """RGWInitMultipart role: mint an upload id, persist state.
        acl: canned ACL from the initiate request, applied when the
        upload completes (S3 binds the ACL at initiate time)."""
        await self._bucket(bucket)
        if acl is not None and acl not in CANNED_ACLS:
            raise RGWError("InvalidArgument", f"bad acl {acl!r}")
        self._uploads += 1
        upload_id = f"u{self._uploads}-{int(time.time() * 1000):x}"
        await self._store(self._upload_oid(bucket, key, upload_id),
                          {"bucket": bucket, "key": key,
                           "created": time.time(), "parts": {},
                           "acl": acl})
        return upload_id

    async def _upload(self, bucket: str, key: str,
                      upload_id: str) -> Dict:
        doc = await self._load(self._upload_oid(bucket, key, upload_id))
        if doc is None:
            raise RGWError("NoSuchUpload", upload_id)
        return doc

    def _part_prefix(self, bucket: str, key: str, upload_id: str,
                     part_num: int, write_id: str) -> str:
        # the reference's part naming (<key>._multipart_.<uploadid>.<num>)
        # plus a unique write id so a part RE-upload writes fresh
        # objects instead of clobbering the live ones
        return self._SEP.join(
            (bucket, f"{MULTIPART_PREFIX}{key}"
                     f".{upload_id}.{part_num}.{write_id}"))

    async def upload_part(self, bucket: str, key: str, upload_id: str,
                          part_num: int, data: bytes) -> str:
        """MultipartObjectProcessor role: a part is its own striped
        object family; re-upload of the same part replaces it.
        Concurrent parts of one upload are the normal S3 pattern, so
        the upload-doc update is serialized per upload."""
        if part_num < 1 or part_num > 10000:
            raise RGWError("InvalidPart", str(part_num))
        await self._upload(bucket, key, upload_id)  # upload must exist
        writer = StripeWriter(self.data, self.aio_window)
        proc = PutObjProcessor(
            writer, self._part_prefix(bucket, key, upload_id, part_num,
                                      self._write_id()),
            self.stripe_size)
        try:
            await proc.process(data)
            manifest = await proc.complete()
        except Exception:
            await writer.cancel()
            raise
        etag = self._etag_from_manifest(manifest, data)
        upload_oid = self._upload_oid(bucket, key, upload_id)
        async with self._meta_lock(upload_oid):
            doc = await self._upload(bucket, key, upload_id)
            old = doc["parts"].get(str(part_num))
            doc["parts"][str(part_num)] = {
                "etag": etag, "size": manifest.obj_size,
                "manifest": manifest.to_dict()}
            await self._store(upload_oid, doc)
        if old is not None:  # GC the replaced part's stripes
            for stripe in old["manifest"]["stripes"]:
                try:
                    await self.data.remove(stripe["oid"])
                except Exception:
                    pass
        return etag

    async def complete_multipart(self, bucket: str, key: str,
                                 upload_id: str,
                                 parts: List[Tuple[int, str]]) -> str:
        """RGWCompleteMultipart::execute role (rgw_op.cc:5933): validate
        the client's part list, stitch part manifests in part order,
        write the head, unlink upload state."""
        doc = await self._upload(bucket, key, upload_id)
        if not parts:
            raise RGWError("InvalidRequest", "empty part list")
        nums = [p[0] for p in parts]
        if nums != sorted(nums) or len(set(nums)) != len(nums):
            raise RGWError("InvalidPartOrder", str(nums))
        stitched = Manifest(stripe_size=self.stripe_size)
        etags = []
        for num, etag in parts:
            part = doc["parts"].get(str(num))
            if part is None or part["etag"] != etag:
                raise RGWError("InvalidPart", f"part {num}")
            stitched.append(Manifest.from_dict(part["manifest"]))
            etags.append(etag)
        # multipart etag (S3 semantics): md5 over the concatenated
        # part md5 DIGESTS (raw bytes, not hex), suffixed "-<nparts>"
        combined = _etag(b"".join(
            bytes.fromhex(e) for e in etags)) + f"-{len(parts)}"
        # versioning adjudicated at link time, same as atomic PUT —
        # a multipart completion on a versioned bucket lands as a
        # version, never as a stray head doc
        _etag_, _vid = await self._link_by_status(
            bucket, key, stitched, combined, acl=doc.get("acl"),
            event="s3:ObjectCreated:CompleteMultipartUpload")
        await self.meta.remove(self._upload_oid(bucket, key, upload_id))
        return combined

    async def abort_multipart(self, bucket: str, key: str,
                              upload_id: str) -> None:
        """RGWAbortMultipart role: delete parts + upload state."""
        doc = await self._upload(bucket, key, upload_id)
        for part in doc["parts"].values():
            for stripe in part["manifest"]["stripes"]:
                try:
                    await self.data.remove(stripe["oid"])
                except Exception:
                    pass
        await self.meta.remove(self._upload_oid(bucket, key, upload_id))
