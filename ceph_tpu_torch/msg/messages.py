"""Typed wire messages (port of ceph_tpu/msg/messages.py).

Reference parity: src/messages/ (MOSDOp.h, MOSDPing.h, MOSDFailure.h,
MOSDMap.h, MMonCommand.h, MOSDECSubOpWrite.h, ...) — each message is a
versioned struct carried in a tagged frame.  The reference dispatches on
the header type id; here every class has a TAG and a registry maps tag ->
class at decode time.  Payloads use the versioned encoder
(ceph_tpu_torch.common.encoding), so messages can grow fields without breaking
older peers (DECODE_FINISH skips unknown tails).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.osd.osdmap import PgId

_REGISTRY: Dict[int, type] = {}


def register(cls):
    assert cls.TAG not in _REGISTRY, f"duplicate tag {cls.TAG}"
    _REGISTRY[cls.TAG] = cls
    return cls


class Message:
    TAG = 0
    VERSION = 1
    COMPAT = 1

    def encode(self) -> bytes:
        enc = Encoder()
        enc.start(self.VERSION, self.COMPAT)
        self.encode_payload(enc)
        enc.finish()
        return enc.to_bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Message":
        dec = Decoder(data)
        dec.start(cls.VERSION)
        msg = cls.decode_payload(dec)
        dec.finish()
        return msg

    def encode_payload(self, enc: Encoder) -> None:
        raise NotImplementedError

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "Message":
        raise NotImplementedError

    def __repr__(self) -> str:
        fields = ", ".join(f"{k}={v!r}" for k, v in vars(self).items()
                           if not k.startswith("_") and k != "data")
        return f"{type(self).__name__}({fields})"


def decode_message(tag: int, payload: bytes) -> Message:
    cls = _REGISTRY.get(tag)
    if cls is None:
        raise ValueError(f"unknown message tag {tag}")
    return cls.decode(payload)


def _enc_pg(enc: Encoder, pg: PgId) -> None:
    enc.s64(pg.pool)
    enc.u32(pg.ps)


def _dec_pg(dec: Decoder) -> PgId:
    return PgId(dec.s64(), dec.u32())


# -- session / control ------------------------------------------------------


@register
class MHello(Message):
    """Connection handshake: who is on the other end (entity_addr_t
    role).  v2 appends the cephx session-negotiation fields: a fresh
    nonce, the key id the hello is signed with, and an optional
    mon-granted ticket (CephxSessionHandler / msgr2 auth frames role).
    v3 appends the sender's accepted compression methods (csv, in
    preference order — the frames_v2 compression negotiation role,
    the reference's src/msg/async/frames_v2.cc).  v4 appends the
    sender's AEAD capability so secure-mode peers can negotiate the
    sealing mode instead of each side guessing from its OWN toolchain
    (the crypto_onwire mode-selection role): absent = unknown
    (pre-v4 peer), True/False = advertised."""

    TAG = 1
    VERSION = 4
    COMPAT = 1

    def __init__(self, entity_name: str, addr: str,
                 nonce: bytes = b"", kid: int = 0,
                 ticket: bytes = b"", compression: str = "",
                 aead: Optional[bool] = None):
        self.entity_name = entity_name
        self.addr = addr
        self.nonce = nonce
        self.kid = kid
        self.ticket = ticket
        # set only when non-empty so dumps of pre-v3 blobs (and the
        # archived corpus) are unchanged
        if compression:
            self.compression = compression
        if aead is not None:
            self.aead = aead

    def encode_payload(self, enc: Encoder) -> None:
        enc.string(self.entity_name)
        enc.string(self.addr)
        enc.bytes(self.nonce)
        enc.s32(self.kid)
        enc.bytes(self.ticket)
        enc.string(getattr(self, "compression", ""))
        enc.bool(getattr(self, "aead", False))

    @classmethod
    def decode(cls, data: bytes) -> "MHello":
        dec = Decoder(data)
        struct_v = dec.start(cls.VERSION)
        msg = cls(dec.string(), dec.string())
        if struct_v >= 2:
            msg.nonce = dec.bytes()
            msg.kid = dec.s32()
            msg.ticket = dec.bytes()
        if struct_v >= 3:
            comp = dec.string()
            if comp:
                msg.compression = comp
        if struct_v >= 4:
            msg.aead = dec.bool()
        dec.finish()
        return msg


PING = 0
PING_REPLY = 1


@register
class MPing(Message):
    """MOSDPing role: OSD<->OSD heartbeat (OSD.cc:5235 handle_osd_ping)."""

    TAG = 2

    def __init__(self, kind: int, stamp: float, epoch: int = 0,
                 from_osd: int = -1):
        self.kind = kind
        self.stamp = stamp
        self.epoch = epoch
        self.from_osd = from_osd

    def encode_payload(self, enc: Encoder) -> None:
        enc.u8(self.kind)
        enc.f64(self.stamp)
        enc.u32(self.epoch)
        enc.s32(self.from_osd)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MPing":
        return cls(dec.u8(), dec.f64(), dec.u32(), dec.s32())


@register
class MOSDBoot(Message):
    """OSD -> mon: I'm up at this address (MOSDBoot role)."""

    TAG = 3

    def __init__(self, osd: int, addr: str, boot_epoch: int = 0):
        self.osd = osd
        self.addr = addr
        self.boot_epoch = boot_epoch

    def encode_payload(self, enc: Encoder) -> None:
        enc.s32(self.osd)
        enc.string(self.addr)
        enc.u32(self.boot_epoch)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MOSDBoot":
        return cls(dec.s32(), dec.string(), dec.u32())


@register
class MOSDFailure(Message):
    """OSD -> mon failure report (MOSDFailure; OSDMonitor::prepare_failure)."""

    TAG = 4

    def __init__(self, target_osd: int, reporter: int, failed_for: float,
                 epoch: int):
        self.target_osd = target_osd
        self.reporter = reporter
        self.failed_for = failed_for
        self.epoch = epoch

    def encode_payload(self, enc: Encoder) -> None:
        enc.s32(self.target_osd)
        enc.s32(self.reporter)
        enc.f64(self.failed_for)
        enc.u32(self.epoch)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MOSDFailure":
        return cls(dec.s32(), dec.s32(), dec.f64(), dec.u32())


@register
class MGetMap(Message):
    """Client/OSD -> mon: send me the OSDMap (subscribe semantics)."""

    TAG = 5

    def __init__(self, since_epoch: int = 0, subscribe: bool = True):
        self.since_epoch = since_epoch
        self.subscribe = subscribe

    def encode_payload(self, enc: Encoder) -> None:
        enc.u32(self.since_epoch)
        enc.bool(self.subscribe)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MGetMap":
        return cls(dec.u32(), dec.bool())


@register
class MOSDMapMsg(Message):
    """Mon -> peer: full map and/or incrementals (MOSDMap role)."""

    TAG = 6

    def __init__(self, epoch: int, full_map: Optional[bytes] = None,
                 incrementals: Optional[List[bytes]] = None,
                 gap_unfillable: bool = False):
        self.epoch = epoch
        self.full_map = full_map
        self.incrementals = incrementals or []
        # mon could not supply the contiguous incremental range (log
        # trimmed): the receiver must adopt the full map despite the
        # epoch gap instead of re-requesting forever
        self.gap_unfillable = gap_unfillable

    def encode_payload(self, enc: Encoder) -> None:
        enc.u32(self.epoch)
        enc.optional(self.full_map, Encoder.bytes)
        enc.list(self.incrementals, Encoder.bytes)
        enc.bool(self.gap_unfillable)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MOSDMapMsg":
        return cls(dec.u32(), dec.optional(Decoder.bytes),
                   dec.list(Decoder.bytes), dec.bool())


@register
class MMonCommand(Message):
    """JSON command to the mon (MMonCommand / `ceph` CLI role)."""

    TAG = 7

    def __init__(self, tid: int, cmd: Dict[str, Any]):
        self.tid = tid
        self.cmd = cmd

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.string(json.dumps(self.cmd))

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MMonCommand":
        return cls(dec.u64(), json.loads(dec.string()))


@register
class MMonCommandReply(Message):
    TAG = 8

    def __init__(self, tid: int, rc: int, out: Dict[str, Any]):
        self.tid = tid
        self.rc = rc
        self.out = out

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.s32(self.rc)
        enc.string(json.dumps(self.out))

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MMonCommandReply":
        return cls(dec.u64(), dec.s32(), json.loads(dec.string()))


# -- client data path -------------------------------------------------------


class OSDOp:
    """One sub-operation of an MOSDOp (OSDOp / ceph_osd_op role)."""

    def __init__(self, op: str, offset: int = 0, length: int = 0,
                 data: bytes = b"", args: Optional[Dict[str, Any]] = None):
        self.op = op
        self.offset = offset
        self.length = length
        self.data = data
        self.args = args or {}

    def encode(self, enc: Encoder) -> None:
        enc.string(self.op)
        enc.u64(self.offset)
        enc.u64(self.length)
        enc.bytes(self.data)
        enc.string(json.dumps(self.args))

    @classmethod
    def decode(cls, dec: Decoder) -> "OSDOp":
        return cls(dec.string(), dec.u64(), dec.u64(),
                   dec.bytes_view(), json.loads(dec.string()))

    def __repr__(self) -> str:
        return (f"OSDOp({self.op!r}, off={self.offset}, "
                f"len={self.length or len(self.data)})")


@register
class MOSDOp(Message):
    """Client -> primary OSD op (MOSDOp.h role)."""

    TAG = 9

    def __init__(self, tid: int, client: str, pg: PgId, oid: str,
                 ops: List[OSDOp], epoch: int,
                 snapc_seq: int = 0,
                 snapc_snaps: Optional[List[int]] = None,
                 snap_id: int = 0,
                 tenant: str = "",
                 qos_delta: int = 1,
                 qos_rho: int = 1):
        self.tid = tid
        self.client = client
        self.pg = pg
        self.oid = oid
        self.ops = ops
        self.epoch = epoch
        # write-time snap context (SnapContext: seq + live snap ids,
        # newest first) and read-time snap id (0 = head)
        self.snapc_seq = snapc_seq
        self.snapc_snaps = snapc_snaps or []
        self.snap_id = snap_id
        # QoS tenant identity ("" = untagged): the OSD schedules the
        # op under the per-tenant mClock class `client.<tenant>` and
        # runs it through the admission gate
        self.tenant = tenant
        # dmClock piggyback (delta/rho): completions this tenant saw
        # at OTHER OSDs since its last op on the target (plus one) —
        # all-phase and reservation-phase respectively.  The target's
        # mClock tags advance by delta x cost, making per-tenant
        # reservation/limit hold cluster-wide.  1/1 = local mClock.
        self.qos_delta = max(int(qos_delta), 1)
        self.qos_rho = max(int(qos_rho), 1)
        # blkin-role trace context: (trace_id, parent span id) or None
        self.trace: Optional[tuple] = None

    # v2 appends the snap context + read snap; v3 the trace context;
    # v4 the QoS tenant; v5 the dmClock delta/rho piggyback.  COMPAT
    # stays 1 so a v1 frame still decodes with defaults
    VERSION = 5
    COMPAT = 1

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.string(self.client)
        _enc_pg(enc, self.pg)
        enc.string(self.oid)
        enc.list(self.ops, lambda e, op: op.encode(e))
        enc.u32(self.epoch)
        enc.u64(self.snapc_seq)
        enc.list(self.snapc_snaps, Encoder.u64)
        enc.u64(self.snap_id)
        enc.optional(self.trace,
                     lambda e, v: (e.u64(v[0]), e.u64(v[1])))
        enc.string(self.tenant)
        enc.u32(self.qos_delta)
        enc.u32(self.qos_rho)

    @classmethod
    def decode(cls, data: bytes) -> "MOSDOp":
        dec = Decoder(data)
        struct_v = dec.start(cls.VERSION)
        msg = cls(dec.u64(), dec.string(), _dec_pg(dec), dec.string(),
                  dec.list(OSDOp.decode), dec.u32())
        if struct_v >= 2:
            msg.snapc_seq = dec.u64()
            msg.snapc_snaps = dec.list(Decoder.u64)
            msg.snap_id = dec.u64()
        if struct_v >= 3:
            msg.trace = dec.optional(lambda d: (d.u64(), d.u64()))
        if struct_v >= 4:
            msg.tenant = dec.string()
        if struct_v >= 5:
            msg.qos_delta = max(dec.u32(), 1)
            msg.qos_rho = max(dec.u32(), 1)
        dec.finish()
        return msg


@register
class MOSDOpReply(Message):
    TAG = 10
    # v2 appends the dmClock grant phase (the rho piggyback).  COMPAT
    # stays 1 so archived/old-peer frames decode with the default
    VERSION = 2
    COMPAT = 1

    def __init__(self, tid: int, rc: int, data: bytes = b"",
                 out: Optional[Dict[str, Any]] = None,
                 replay_epoch: int = 0,
                 qos_phase: str = ""):
        self.tid = tid
        self.rc = rc
        self.data = data
        self.out = out or {}
        # >0: client should wait for this map epoch and resend (the
        # ENOENT-on-wrong-primary / EAGAIN resend discipline)
        self.replay_epoch = replay_epoch
        # dmClock phase the op's scheduler grant won ("reservation" /
        # "priority", "" when unscheduled): the client ServiceTracker
        # counts reservation-phase completions into rho
        self.qos_phase = qos_phase

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.s32(self.rc)
        enc.bytes(self.data)
        enc.string(json.dumps(self.out))
        enc.u32(self.replay_epoch)
        enc.string(self.qos_phase)

    @classmethod
    def decode(cls, data: bytes) -> "MOSDOpReply":
        dec = Decoder(data)
        struct_v = dec.start(cls.VERSION)
        msg = cls(dec.u64(), dec.s32(), dec.bytes(),
                  json.loads(dec.string()), dec.u32())
        if struct_v >= 2:
            msg.qos_phase = dec.string()
        dec.finish()
        return msg


# -- primary -> shard sub-ops ----------------------------------------------


class ShardOp:
    """One ObjectStore-level mutation on a shard (ECSubWrite payload item)."""

    def __init__(self, op: str, offset: int = 0, data: bytes = b"",
                 name: str = "", value: bytes = b"", size: int = 0):
        # write | truncate | remove | setattr | rmattr | create |
        # clone | omap_set | omap_rm  (omap payloads ride in `data`
        # as an encoded map/list)
        self.op = op
        self.offset = offset
        self.data = data
        self.name = name
        self.value = value
        self.size = size

    def encode(self, enc: Encoder) -> None:
        enc.string(self.op)
        enc.u64(self.offset)
        enc.bytes(self.data)
        enc.string(self.name)
        enc.bytes(self.value)
        enc.u64(self.size)

    @classmethod
    def decode(cls, dec: Decoder) -> "ShardOp":
        return cls(dec.string(), dec.u64(), dec.bytes_view(),
                   dec.string(), dec.bytes(), dec.u64())


@register
class MOSDSubWrite(Message):
    """Primary -> shard write (MOSDECSubOpWrite / MOSDRepOp role).

    Carries the shard transaction plus the pg log entry for that write so
    replicas journal the op (PGLog) before applying it.
    """

    TAG = 11
    VERSION = 3  # v2 appends guard (recovery-push causality token);
    #              v3 the blkin-role trace context
    COMPAT = 1   # v1 peers decode head fields; tails default to None

    def __init__(self, tid: int, pg: PgId, shard: int, oid: str,
                 ops: List[ShardOp], epoch: int,
                 log_entry: Optional[Dict[str, Any]] = None,
                 from_osd: int = -1,
                 guard: Optional[tuple] = None):
        self.tid = tid
        self.pg = pg
        self.shard = shard
        self.oid = oid
        self.ops = ops
        self.epoch = epoch
        self.log_entry = log_entry
        self.from_osd = from_osd
        # guard: for recovery/repair sub-writes (log_entry=None), the
        # newest object version the primary's plan OBSERVED when it
        # adjudicated.  The replica refuses a below-floor install whose
        # guard predates its current state — that is exactly a stale
        # (timed-out, still-in-flight) push overtaken by a newer write.
        self.guard = tuple(guard) if guard is not None else None
        # blkin-role trace context: (trace_id, parent span id) or None
        self.trace: Optional[tuple] = None

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        _enc_pg(enc, self.pg)
        enc.s32(self.shard)
        enc.string(self.oid)
        enc.list(self.ops, lambda e, op: op.encode(e))
        enc.u32(self.epoch)
        enc.optional(self.log_entry,
                     lambda e, v: e.string(json.dumps(v)))
        enc.s32(self.from_osd)
        enc.optional(self.guard,
                     lambda e, v: (e.u64(v[0]), e.u64(v[1])))
        enc.optional(self.trace,
                     lambda e, v: (e.u64(v[0]), e.u64(v[1])))

    @classmethod
    def decode(cls, data: bytes) -> "MOSDSubWrite":
        dec = Decoder(data)
        struct_v = dec.start(cls.VERSION)
        msg = cls(dec.u64(), _dec_pg(dec), dec.s32(), dec.string(),
                  dec.list(ShardOp.decode), dec.u32(),
                  dec.optional(lambda d: json.loads(d.string())),
                  dec.s32())
        if struct_v >= 2:
            msg.guard = dec.optional(lambda d: (d.u64(), d.u64()))
        if struct_v >= 3:
            msg.trace = dec.optional(lambda d: (d.u64(), d.u64()))
        dec.finish()
        return msg


@register
class MOSDSubWriteReply(Message):
    TAG = 12

    def __init__(self, tid: int, rc: int, shard: int = -1):
        self.tid = tid
        self.rc = rc
        self.shard = shard

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.s32(self.rc)
        enc.s32(self.shard)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MOSDSubWriteReply":
        return cls(dec.u64(), dec.s32(), dec.s32())


@register
class MOSDSubRead(Message):
    """Primary -> shard read (MOSDECSubOpRead role)."""

    TAG = 13

    VERSION = 5  # v2 appends want_omap; v3 appends record (hit-set);
    #              v4 the blkin-role trace context; v5 the repair
    #              sub-chunk fraction spec (regenerating-code reads)
    COMPAT = 1

    def __init__(self, tid: int, pg: PgId, shard: int, oid: str,
                 offset: int = 0, length: int = 0,
                 want_attrs: bool = True, want_omap: bool = False,
                 record: bool = False):
        self.tid = tid
        self.pg = pg
        self.shard = shard
        self.oid = oid
        self.offset = offset
        self.length = length
        self.want_attrs = want_attrs
        self.want_omap = want_omap
        # client-read provenance: only these sub-reads feed the
        # replica's hot-set tracking (scrub/recovery/stat probes
        # would drown the skew signal)
        self.record = record
        # blkin-role trace context: (trace_id, parent span id) or None
        self.trace: Optional[tuple] = None
        # repair-fragment read: (lost chunk id, expected sub-chunk
        # count alpha) or None.  When set the replica projects its
        # stored chunk against the codec's repair vector and ships the
        # beta = chunk/alpha byte fragment instead of the full chunk;
        # an alpha mismatch (profile drift) answers EOPNOTSUPP so the
        # primary falls back to the classic k-read path
        self.repair: Optional[tuple] = None

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        _enc_pg(enc, self.pg)
        enc.s32(self.shard)
        enc.string(self.oid)
        enc.u64(self.offset)
        enc.u64(self.length)
        enc.bool(self.want_attrs)
        enc.bool(self.want_omap)
        enc.bool(self.record)
        enc.optional(self.trace,
                     lambda e, v: (e.u64(v[0]), e.u64(v[1])))
        enc.optional(self.repair,
                     lambda e, v: (e.s32(v[0]), e.u32(v[1])))

    @classmethod
    def decode(cls, data: bytes) -> "MOSDSubRead":
        dec = Decoder(data)
        struct_v = dec.start(cls.VERSION)
        msg = cls(dec.u64(), _dec_pg(dec), dec.s32(), dec.string(),
                  dec.u64(), dec.u64(), dec.bool())
        if struct_v >= 2:
            msg.want_omap = dec.bool()
        if struct_v >= 3:
            msg.record = dec.bool()
        if struct_v >= 4:
            msg.trace = dec.optional(lambda d: (d.u64(), d.u64()))
        if struct_v >= 5:
            msg.repair = dec.optional(lambda d: (d.s32(), d.u32()))
        dec.finish()
        return msg


@register
class MOSDSubReadReply(Message):
    TAG = 14

    VERSION = 2  # v2 appends the omap payload
    COMPAT = 1

    def __init__(self, tid: int, rc: int, data: bytes = b"",
                 attrs: Optional[Dict[str, bytes]] = None,
                 shard: int = -1,
                 omap: Optional[Dict[str, bytes]] = None):
        self.tid = tid
        self.rc = rc
        self.data = data
        self.attrs = attrs or {}
        self.shard = shard
        self.omap = omap or {}

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.s32(self.rc)
        enc.bytes(self.data)
        enc.map(self.attrs, Encoder.string, Encoder.bytes)
        enc.s32(self.shard)
        enc.map(self.omap, Encoder.string, Encoder.bytes)

    @classmethod
    def decode(cls, data: bytes) -> "MOSDSubReadReply":
        dec = Decoder(data)
        struct_v = dec.start(cls.VERSION)
        # bulk shard payload stays a VIEW of the frame buffer: the
        # primary's gather/decode path slices and CRCs it in place
        # (k shards per EC read — the copy here was per-shard)
        msg = cls(dec.u64(), dec.s32(), dec.bytes_view(),
                  dec.map(Decoder.string, Decoder.bytes), dec.s32())
        if struct_v >= 2:
            msg.omap = dec.map(Decoder.string, Decoder.bytes)
        dec.finish()
        return msg


# -- coded compute (scan/aggregate/score pushdown) --------------------------


@register
class MOSDCompute(Message):
    """Client -> primary: run a registered compute kernel over MANY
    objects' shards where they live (the coded-compute scan op,
    ceph_tpu_torch/compute).  SET-valued by design — one request names a
    kernel + many oids, so a 10k-object scan is a handful of frames,
    not 10k round trips.  cls-exec style, but the primary fans
    sub-compute ops to the OSDs holding each object's shards and
    completes each object from the FIRST k shard-results."""

    TAG = 32
    VERSION = 1
    COMPAT = 1

    def __init__(self, tid: int, client: str, pool: int,
                 oids: List[str], kernel: str, args: str = "",
                 epoch: int = 0, tenant: str = ""):
        self.tid = tid
        self.client = client
        self.pool = pool
        self.oids = oids
        self.kernel = kernel
        self.args = args          # JSON text (kernel-specific)
        self.epoch = epoch
        # QoS tenant identity ("" = untagged): compute ops schedule
        # under the dedicated `compute` mClock class AND pass the
        # tenant admission gate, so scans cannot starve client I/O
        self.tenant = tenant

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.string(self.client)
        enc.s64(self.pool)
        enc.list(self.oids, Encoder.string)
        enc.string(self.kernel)
        enc.string(self.args)
        enc.u32(self.epoch)
        enc.string(self.tenant)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MOSDCompute":
        return cls(dec.u64(), dec.string(), dec.s64(),
                   dec.list(Decoder.string), dec.string(),
                   dec.string(), dec.u32(), dec.string())


@register
class MOSDComputeReply(Message):
    """Primary -> client: per-oid (rc, result bytes) + a summary map
    (pushdown/fallback counts, result bytes moved) for observability.
    Only KERNEL RESULTS ride here — never object payloads."""

    TAG = 33
    VERSION = 1
    COMPAT = 1

    def __init__(self, tid: int, rc: int,
                 results: Optional[Dict[str, Tuple[int, bytes]]] = None,
                 out: Optional[Dict[str, Any]] = None,
                 replay_epoch: int = 0):
        self.tid = tid
        self.rc = rc
        self.results = results or {}
        self.out = out or {}
        self.replay_epoch = replay_epoch

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.s32(self.rc)
        enc.map(self.results, Encoder.string,
                lambda e, v: (e.s32(v[0]), e.bytes(v[1])))
        enc.string(json.dumps(self.out))
        enc.u32(self.replay_epoch)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MOSDComputeReply":
        return cls(dec.u64(), dec.s32(),
                   dec.map(Decoder.string,
                           lambda d: (d.s32(), d.bytes())),
                   json.loads(dec.string()), dec.u32())


@register
class MOSDSubCompute(Message):
    """Primary -> shard OSD: evaluate the kernel over THIS OSD's
    shards of a wave of objects (MOSDECSubOpRead-shaped, but the
    reply carries R-byte kernel results, not chunk payloads — the
    payload bytes never cross the wire).  items are
    (pool, ps, shard, oid) tuples; the receiver batches every local
    shard of the wave into ONE plan-cached device dispatch."""

    TAG = 34
    VERSION = 1
    COMPAT = 1

    def __init__(self, tid: int, kernel: str, args: str,
                 items: List[Tuple[int, int, int, str]],
                 epoch: int = 0):
        self.tid = tid
        self.kernel = kernel
        self.args = args
        self.items = [tuple(it) for it in items]
        self.epoch = epoch
        # blkin-role trace context: (trace_id, parent span id) or None
        self.trace: Optional[tuple] = None

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.string(self.kernel)
        enc.string(self.args)
        enc.list(self.items,
                 lambda e, it: (e.s64(it[0]), e.u32(it[1]),
                                e.s32(it[2]), e.string(it[3])))
        enc.u32(self.epoch)
        enc.optional(self.trace,
                     lambda e, v: (e.u64(v[0]), e.u64(v[1])))

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MOSDSubCompute":
        msg = cls(dec.u64(), dec.string(), dec.string(),
                  dec.list(lambda d: (d.s64(), d.u32(), d.s32(),
                                      d.string())),
                  dec.u32())
        msg.trace = dec.optional(lambda d: (d.u64(), d.u64()))
        return msg


@register
class MOSDSubComputeReply(Message):
    """Shard OSD -> primary: per-item (rc, object-info version,
    result bytes), aligned with the request's item order.  The
    version rides so the primary can complete each object from k
    SAME-VERSION shard-results (the consistency story of the
    hedged first-k read, applied to computation)."""

    TAG = 35
    VERSION = 1
    COMPAT = 1

    def __init__(self, tid: int, rc: int,
                 results: Optional[List[Tuple[int, str, bytes]]] = None):
        self.tid = tid
        self.rc = rc
        self.results = [tuple(r) for r in (results or [])]

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.s32(self.rc)
        enc.list(self.results,
                 lambda e, r: (e.s32(r[0]), e.string(r[1]),
                               e.bytes(r[2])))

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MOSDSubComputeReply":
        return cls(dec.u64(), dec.s32(),
                   dec.list(lambda d: (d.s32(), d.string(),
                                       d.bytes_view())))


# -- peering ----------------------------------------------------------------


@register
class MPGQuery(Message):
    """Primary -> replica: send me your pg info + log (GetLog/GetInfo).

    v2 appends an optional explicit shard: a split child's primary
    sweeps NON-acting OSDs for stray shard state, and a stray cannot
    derive its shard from an acting set it is not part of."""

    TAG = 15
    VERSION = 2
    COMPAT = 1

    def __init__(self, tid: int, pg: PgId, epoch: int, from_osd: int,
                 shard: Optional[int] = None):
        self.tid = tid
        self.pg = pg
        self.epoch = epoch
        self.from_osd = from_osd
        self.shard = shard

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        _enc_pg(enc, self.pg)
        enc.u32(self.epoch)
        enc.s32(self.from_osd)
        enc.optional(self.shard, Encoder.s32)

    @classmethod
    def decode(cls, data: bytes) -> "MPGQuery":
        dec = Decoder(data)
        struct_v = dec.start(cls.VERSION)
        msg = cls(dec.u64(), _dec_pg(dec), dec.u32(), dec.s32())
        if struct_v >= 2:
            msg.shard = dec.optional(Decoder.s32)
        dec.finish()
        return msg


@register
class MPGLogMsg(Message):
    """Replica -> primary: pg info + full log (MOSDPGLog role)."""

    TAG = 16

    def __init__(self, tid: int, pg: PgId, shard: int,
                 info: Dict[str, Any], entries: List[Dict[str, Any]],
                 epoch: int = 0, from_osd: int = -1,
                 is_reply: bool = False):
        self.tid = tid
        self.pg = pg
        self.shard = shard
        self.info = info
        self.entries = entries
        self.epoch = epoch
        self.from_osd = from_osd
        # pushes (primary -> peer, authoritative log) and replies (peer ->
        # primary) share this struct; the flag keeps them apart — tids
        # alone cannot, since each daemon numbers its own requests
        self.is_reply = is_reply

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        _enc_pg(enc, self.pg)
        enc.s32(self.shard)
        enc.string(json.dumps(self.info))
        enc.list(self.entries, lambda e, v: e.string(json.dumps(v)))
        enc.u32(self.epoch)
        enc.s32(self.from_osd)
        enc.bool(self.is_reply)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MPGLogMsg":
        return cls(dec.u64(), _dec_pg(dec), dec.s32(),
                   json.loads(dec.string()),
                   dec.list(lambda d: json.loads(d.string())),
                   dec.u32(), dec.s32(), dec.bool())


@register
class MWatchNotify(Message):
    """Primary -> watcher: a notify fired on an object you watch
    (MWatchNotify role, the reference's src/messages/MWatchNotify.h)."""

    TAG = 17

    def __init__(self, notify_id: int, pool: int, oid: str,
                 payload: bytes = b"", cookie: int = 0):
        self.notify_id = notify_id
        self.pool = pool
        self.oid = oid
        self.payload = payload
        self.cookie = cookie

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.notify_id)
        enc.s64(self.pool)
        enc.string(self.oid)
        enc.bytes(self.payload)
        enc.u64(self.cookie)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MWatchNotify":
        return cls(dec.u64(), dec.s64(), dec.string(), dec.bytes(),
                   dec.u64())


@register
class MWatchNotifyAck(Message):
    """Watcher -> primary: notify delivered to the local callback."""

    TAG = 18

    def __init__(self, notify_id: int, cookie: int = 0):
        self.notify_id = notify_id
        self.cookie = cookie

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.notify_id)
        enc.u64(self.cookie)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MWatchNotifyAck":
        return cls(dec.u64(), dec.u64())


@register
class MOSDCommand(Message):
    """JSON command to an OSD daemon over the wire — the `ceph tell
    osd.N <cmd>` role (reference: MCommand.h carried over the client
    messenger, handled in OSD::do_command, OSD.cc).  Same admin
    surface as the local admin socket (perf dump, dump_ops_in_flight,
    scrub) but reachable by the mgr and remote CLIs."""

    TAG = 19

    def __init__(self, tid: int, cmd: Dict[str, Any]):
        self.tid = tid
        self.cmd = cmd

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.string(json.dumps(self.cmd))

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MOSDCommand":
        return cls(dec.u64(), json.loads(dec.string()))


@register
class MOSDCommandReply(Message):
    TAG = 20

    def __init__(self, tid: int, rc: int, out: Dict[str, Any]):
        self.tid = tid
        self.rc = rc
        self.out = out

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.s32(self.rc)
        enc.string(json.dumps(self.out))

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MOSDCommandReply":
        return cls(dec.u64(), dec.s32(), json.loads(dec.string()))


@register
class MClientRequest(Message):
    """Client -> MDS metadata request (MClientRequest.h role): a named
    op with JSON args.  File DATA never rides this — clients talk to
    the OSDs directly for data, like the reference."""

    TAG = 21

    def __init__(self, tid: int, op: str, args: Dict[str, Any]):
        self.tid = tid
        self.op = op
        self.args = args

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.string(self.op)
        enc.string(json.dumps(self.args))

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MClientRequest":
        return cls(dec.u64(), dec.string(), json.loads(dec.string()))


@register
class MClientReply(Message):
    TAG = 22

    def __init__(self, tid: int, rc: int, out: Dict[str, Any]):
        self.tid = tid
        self.rc = rc
        self.out = out

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.s32(self.rc)
        enc.string(json.dumps(self.out))

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MClientReply":
        return cls(dec.u64(), dec.s32(), json.loads(dec.string()))


@register
class MClientCaps(Message):
    """Capability traffic between MDS and client (MClientCaps.h role).

    MDS -> client: op="revoke" — give up the cap on ino (down to the
    mode in `cap`, "" = none); the client must drop the matching cache
    entries, fold any DIRTY buffered attrs into `attrs`, and answer
    op="ack" with the same tid.  Client -> MDS: op="release" — a
    voluntary cap return (close of a write handle), attrs carrying the
    final flushed size/mtime.  Grants ride metadata REPLIES (the
    `cap` field of MClientReply.out), not this message."""

    TAG = 31

    def __init__(self, op: str, ino: int, cap: str = "",
                 tid: int = 0, attrs: Optional[Dict[str, Any]] = None):
        self.op = op
        self.ino = ino
        self.cap = cap
        self.tid = tid
        self.attrs = attrs or {}

    def encode_payload(self, enc: Encoder) -> None:
        enc.string(self.op)
        enc.u64(self.ino)
        enc.string(self.cap)
        enc.u64(self.tid)
        enc.string(json.dumps(self.attrs))

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MClientCaps":
        return cls(dec.string(), dec.u64(), dec.string(), dec.u64(),
                   json.loads(dec.string()))


# -- mon quorum (Paxos + elections) -----------------------------------------


@register
class MMonElection(Message):
    """Election traffic (MMonElection role, src/messages/MMonElection.h):
    kind PROPOSE/ACK/VICTORY/PING/PONG, epoch-numbered.  v2 adds the
    sender's connectivity score (the reference ships a full
    ConnectionTracker blob in its `sharing_bl`; here one aggregate
    float carries the CONNECTIVITY-strategy signal)."""

    TAG = 23
    VERSION = 2

    def __init__(self, kind: int, epoch: int, rank: int,
                 quorum: Optional[List[int]] = None,
                 score: float = 0.0):
        self.kind = kind
        self.epoch = epoch
        self.rank = rank
        self.quorum = quorum or []
        self.score = score

    def encode_payload(self, enc: Encoder) -> None:
        enc.u8(self.kind)
        enc.u64(self.epoch)
        enc.s32(self.rank)
        enc.list(self.quorum, Encoder.s32)
        enc.f64(self.score)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MMonElection":
        kind, epoch, rank = dec.u8(), dec.u64(), dec.s32()
        quorum = dec.list(Decoder.s32)
        # v1 blobs end here; DECODE_FINISH discipline skips/supplies
        score = dec.f64() if dec.remaining() >= 8 else 0.0
        return cls(kind, epoch, rank, quorum, score)


@register
class MMonPaxos(Message):
    """Paxos traffic (MMonPaxos role, src/messages/MMonPaxos.h): one
    message shape for collect/last/begin/accept/commit/lease (+ the
    pull/full catch-up ops), fields meaningful per op."""

    TAG = 24

    def __init__(self, op: int, pn: int = 0, version: int = 0,
                 value: bytes = b"", last_committed: int = 0,
                 first_committed: int = 0,
                 values: Optional[Dict[int, bytes]] = None,
                 lease: float = 0.0, uncommitted_pn: int = 0,
                 from_rank: int = -1):
        self.op = op
        self.pn = pn
        self.version = version
        self.value = value
        self.last_committed = last_committed
        self.first_committed = first_committed
        self.values = values or {}
        self.lease = lease
        self.uncommitted_pn = uncommitted_pn
        self.from_rank = from_rank

    def encode_payload(self, enc: Encoder) -> None:
        enc.u8(self.op)
        enc.u64(self.pn)
        enc.u64(self.version)
        enc.bytes(self.value)
        enc.u64(self.last_committed)
        enc.u64(self.first_committed)
        enc.map(self.values, Encoder.u64, Encoder.bytes)
        enc.f64(self.lease)
        enc.u64(self.uncommitted_pn)
        enc.s32(self.from_rank)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MMonPaxos":
        return cls(dec.u8(), dec.u64(), dec.u64(), dec.bytes(),
                   dec.u64(), dec.u64(),
                   dec.map(Decoder.u64, Decoder.bytes), dec.f64(),
                   dec.u64(), dec.s32())


@register
class MMonForward(Message):
    """Peon -> leader relay of a client message (MForward role): the
    inner message rides as (tag, payload); fwd_tid routes the reply
    back through the peon; fwd_tid 0 = fire-and-forget."""

    TAG = 25

    def __init__(self, fwd_tid: int, inner_tag: int,
                 inner_payload: bytes):
        self.fwd_tid = fwd_tid
        self.inner_tag = inner_tag
        self.inner_payload = inner_payload

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.fwd_tid)
        enc.u32(self.inner_tag)
        enc.bytes(self.inner_payload)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MMonForward":
        return cls(dec.u64(), dec.u32(), dec.bytes())


@register
class MMonForwardReply(Message):
    """Leader -> peon reply for a forwarded command."""

    TAG = 26

    def __init__(self, fwd_tid: int, rc: int, out: Dict[str, Any]):
        self.fwd_tid = fwd_tid
        self.rc = rc
        self.out = out

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.fwd_tid)
        enc.s32(self.rc)
        enc.string(json.dumps(self.out))

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MMonForwardReply":
        return cls(dec.u64(), dec.s32(), json.loads(dec.string()))


# -- centralized config + cluster log ---------------------------------------


@register
class MConfig(Message):
    """Mon -> daemon: the centralized config snapshot relevant to the
    subscriber (ConfigMonitor's config push role).  Sent on
    subscription and on every config commit."""

    TAG = 29

    def __init__(self, version: int, values: Dict[str, Any]):
        self.version = version
        self.values = values

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.version)
        enc.string(json.dumps(self.values))

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MConfig":
        return cls(dec.u64(), json.loads(dec.string()))


@register
class MLog(Message):
    """Daemon -> mon: structured cluster-log entries (MLog /
    LogMonitor role) — one place to read a multi-daemon incident."""

    TAG = 30

    def __init__(self, entries: List[Dict[str, Any]]):
        self.entries = entries

    def encode_payload(self, enc: Encoder) -> None:
        enc.string(json.dumps(self.entries))

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MLog":
        return cls(json.loads(dec.string()))


# -- cephx KDC (mon ticket service) -----------------------------------------


@register
class MAuth(Message):
    """Client -> mon ticket request (MAuth role, CephxServiceHandler
    two-step: stage 1 fetches a server challenge, stage 2 presents the
    proof)."""

    TAG = 27

    def __init__(self, tid: int, entity: str, stage: int,
                 kid: int = 0, client_challenge: bytes = b"",
                 proof: bytes = b""):
        self.tid = tid
        self.entity = entity
        self.stage = stage
        self.kid = kid
        self.client_challenge = client_challenge
        self.proof = proof

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.string(self.entity)
        enc.u8(self.stage)
        enc.s32(self.kid)
        enc.bytes(self.client_challenge)
        enc.bytes(self.proof)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MAuth":
        return cls(dec.u64(), dec.string(), dec.u8(), dec.s32(),
                   dec.bytes(), dec.bytes())


@register
class MAuthReply(Message):
    """Mon -> client: server challenge (stage 1) or ticket (stage 2)."""

    TAG = 28

    def __init__(self, tid: int, rc: int,
                 server_challenge: bytes = b"", ticket: bytes = b""):
        self.tid = tid
        self.rc = rc
        self.server_challenge = server_challenge
        self.ticket = ticket

    def encode_payload(self, enc: Encoder) -> None:
        enc.u64(self.tid)
        enc.s32(self.rc)
        enc.bytes(self.server_challenge)
        enc.bytes(self.ticket)

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "MAuthReply":
        return cls(dec.u64(), dec.s32(), dec.bytes(), dec.bytes())


# -- small wire codecs shared by ShardOp omap payloads ----------------------


def encode_kv_map(kv) -> bytes:
    enc = Encoder()
    enc.start(1, 1)
    enc.map(dict(kv), Encoder.string, Encoder.bytes)
    enc.finish()
    return enc.to_bytes()


def decode_kv_map(raw: bytes) -> Dict[str, bytes]:
    dec = Decoder(raw)
    dec.start(1)
    out = dec.map(Decoder.string, Decoder.bytes)
    dec.finish()
    return out


def encode_str_list(items) -> bytes:
    enc = Encoder()
    enc.start(1, 1)
    enc.list(list(items), Encoder.string)
    enc.finish()
    return enc.to_bytes()


def decode_str_list(raw: bytes) -> List[str]:
    dec = Decoder(raw)
    dec.start(1)
    out = dec.list(Decoder.string)
    dec.finish()
    return out
