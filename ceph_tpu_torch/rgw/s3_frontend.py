"""S3 HTTP frontend: the gateway's real front door (port of
ceph_tpu/rgw/s3_frontend.py).

Reference parity:
- asio HTTP frontend (Ceph's src/rgw/rgw_asio_frontend.cc:
  1-1059) -> an asyncio HTTP/1.1 server with keep-alive, re-designed
  for the single-event-loop daemon shape.
- AWS Signature Version 4 verification (Ceph's src/rgw/
  rgw_auth_s3.h, rgw_auth_s3.cc): canonical request reconstruction,
  signing-key derivation, constant-time comparison; supports signed
  and UNSIGNED-PAYLOAD content hashes.
- REST op dispatch (Ceph's src/rgw/rgw_rest_s3.cc): bucket
  create/list/delete, object PUT/GET/HEAD/DELETE, multipart initiate/
  upload-part/complete/abort, ListObjects(V1-shaped) — enough surface
  that a stock S3 client works against it.

Users are (access_key -> secret_key) pairs handed to the frontend
(config-level user admin; the reference's user metadata subsystem is a
separate milestone).  ETags are S3-true MD5s (gateway.py).
"""

from __future__ import annotations

import asyncio
import datetime
import hashlib
import hmac
import logging
import os

from ceph_tpu_torch.common import flags
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.rgw.gateway import CANNED_ACLS, RGWError, RGWLite

log = logging.getLogger("rgw.http")

UNSIGNED = "UNSIGNED-PAYLOAD"
MAX_BODY = 5 << 30
# anonymous (ACL-gated) requests may carry a body — public-read-write
# buckets accept unauthenticated PUTs — but the pre-auth buffering
# screen still applies: cap what an unauthenticated peer can make the
# gateway hold in memory before the ACL check rejects it
ANON_MAX_BODY = 16 << 20

_ERR_STATUS = {
    "NoSuchBucket": 404, "NoSuchKey": 404, "NoSuchUpload": 404,
    "BucketAlreadyExists": 409, "BucketNotEmpty": 409,
    "InvalidPart": 400, "InvalidPartOrder": 400,
    "InvalidRequest": 400, "InvalidArgument": 400,
    "MalformedXML": 400, "NoSuchVersion": 404,
    "MethodNotAllowed": 405, "AccessDenied": 403,
    "RequestTimeTooSkewed": 403,
    "SignatureDoesNotMatch": 403, "InternalError": 500,
    "InvalidRange": 416,
}

# parse_byte_range sentinel: the range was syntactically valid but
# lies entirely past the object end (HTTP 416)
RANGE_UNSATISFIABLE = object()


def parse_byte_range(spec: str, size: int):
    """`Range: bytes=a-b` for object GETs (RGWGetObj::parse_range
    role, rgw_op.cc:99).

    Returns (first, last) inclusive byte offsets clamped to the
    object, None when the header should be IGNORED (S3 serves 200 for
    malformed or multi-range specs), or RANGE_UNSATISFIABLE for a
    well-formed range with no overlap (416).  Suffix form `bytes=-n`
    means the final n bytes; `bytes=-0` and a start past EOF are
    unsatisfiable."""
    if not spec or not spec.strip().lower().startswith("bytes="):
        return None
    body = spec.strip()[len("bytes="):]
    if "," in body:          # multi-range: S3 ignores and serves 200
        return None
    first_s, dash, last_s = body.strip().partition("-")
    if not dash:
        return None
    first_s, last_s = first_s.strip(), last_s.strip()
    # digits only: int() would admit signed/spaced forms ("--5",
    # "+3") that are malformed per the grammar and must be IGNORED
    if first_s and not first_s.isdigit():
        return None
    if last_s and not last_s.isdigit():
        return None
    if not first_s:          # suffix: last n bytes
        if not last_s:
            return None      # bare "bytes=-"
        n = int(last_s)
        if n <= 0:
            return RANGE_UNSATISFIABLE
        return (max(size - n, 0), size - 1) if size else \
            RANGE_UNSATISFIABLE
    first = int(first_s)
    last = int(last_s) if last_s else size - 1
    if last_s and last < first:
        return None
    if first >= size:
        return RANGE_UNSATISFIABLE
    return first, min(last, size - 1)


def _int_or_400(text, what: str) -> int:
    """Malformed numeric client input is a 400, not a stack trace."""
    try:
        return int(text)
    except (TypeError, ValueError):
        raise _HttpError("InvalidArgument", f"bad {what}: {text!r}")


class _HttpError(Exception):
    def __init__(self, code: str, what: str = "",
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(what or code)
        self.code = code
        self.headers = dict(headers or {})


def _canonical_query(pairs) -> str:
    """The sigv4 canonical query string (RFC3986-quoted, sorted by
    encoded NAME then encoded VALUE — sorting the joined "k=v"
    strings would mis-order names that prefix each other, e.g.
    key2 before key=) — ONE implementation shared by both verifiers
    and both signers, so a canonicalization fix can never diverge
    them."""
    quoted = sorted(
        (urllib.parse.quote(k, safe="-_.~"),
         urllib.parse.quote(v, safe="-_.~"))
        for k, v in pairs)
    return "&".join(f"{k}={v}" for k, v in quoted)


def _sig_key(secret: str, date: str, region: str, service: str) -> bytes:
    k = hmac.new(("AWS4" + secret).encode(), date.encode(),
                 hashlib.sha256).digest()
    for part in (region, service, "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    return k


class S3Frontend:
    """One HTTP endpoint over an RGWLite gateway."""

    def __init__(self, rgw: RGWLite, users: Dict[str, str],
                 anonymous_ok: bool = True):
        self.rgw = rgw
        self.users = dict(users)  # access_key -> secret_key
        # durable-table keys cached in self.users, with expiry
        # (monotonic); static bootstrap keys are not tracked here
        self._durable_keys: Dict[str, float] = {}
        self._neg_keys: Dict[str, float] = {}  # confirmed-unknown
        # anonymous_ok: admit unauthenticated requests as identity
        # None so canned-ACL checks adjudicate them (public-read
        # buckets); False restores require-sigv4-always
        self.anonymous_ok = anonymous_ok
        self._server: Optional[asyncio.base_events.Server] = None
        self.addr = ""
        # ingress tracing: every request opens a root span installed
        # as the task's current span, so the gateway's rados submits
        # (and through them the OSD op + sub-op spans) parent into ONE
        # tree spanning s3 -> rados -> osd -> device dispatch.  The
        # gateway's head-sampling knob (CEPH_TPU_RGW_TRACE_SAMPLE,
        # default keep-everything) is what gates S3-origin retention:
        # a SAMPLED ingress root forces the whole downstream tree
        # sampled (wire contexts inherit the sender's decision), so an
        # operator turning bulk retention off must turn it off HERE —
        # an unsampled ingress leaves the OSDs to their own
        # osd_trace_sample_rate
        from ceph_tpu_torch.common import tracing

        try:
            rate = flags.flag_float(
                "CEPH_TPU_RGW_TRACE_SAMPLE")
        except ValueError:
            rate = 1.0
        # the gateway has no admin socket: `frontend.tracer.dump()` is
        # the embedded dump surface, so the retention ring stays small
        # — sampled trees are kept for the last-N-requests view only
        self.tracer = tracing.Tracer("rgw", sample_rate=rate,
                                     max_spans=256)

    async def start(self, host: str = "127.0.0.1", port: int = 0,
                    gc_interval: float = 30.0) -> str:
        self._server = await asyncio.start_server(
            self._serve, host, port, limit=8 << 20)
        port = self._server.sockets[0].getsockname()[1]
        self.addr = f"{host}:{port}"
        # a serving gateway owns the GC sweep (rgw_gc worker role):
        # without it, overwrite/delete churn accumulates stripes forever
        if gc_interval > 0:
            self.rgw.start_gc(gc_interval)
        return self.addr

    async def stop(self) -> None:
        await self.rgw.stop_gc()
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5)
            except (Exception, asyncio.TimeoutError):
                pass
            self._server = None

    # -- HTTP plumbing -----------------------------------------------------

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                try:
                    method, target, _ver = \
                        line.decode("latin-1").strip().split(" ", 2)
                except ValueError:
                    return
                headers: Dict[str, str] = {}
                while True:
                    hline = await reader.readline()
                    if hline in (b"\r\n", b"\n", b""):
                        break
                    name, _, value = hline.decode("latin-1").partition(":")
                    headers[name.strip().lower()] = value.strip()
                try:
                    length = int(headers.get("content-length", "0"))
                except ValueError:
                    return  # malformed framing: drop the connection
                if length > MAX_BODY or length < 0:
                    return
                if length and not self._plausible_auth(headers):
                    # a durable-table user may not be cached yet:
                    # hydrate before judging (one omap read, only on
                    # the unknown-key path)
                    _p, _, _q = target.partition("?")
                    await self._ensure_user(headers, _q)
                if length and not self._plausible_auth(headers) \
                        and not self._plausible_presigned(target):
                    # screen BEFORE buffering: an unauthenticated peer
                    # must not make the gateway hold a multi-GiB body
                    # in memory just to 403 it.  A request with NO auth
                    # at all may still be a legitimate anonymous write
                    # to a public-read-write bucket — allowed through
                    # under the smaller anonymous cap
                    if "authorization" in headers or \
                            length > ANON_MAX_BODY:
                        return
                body = await reader.readexactly(length) if length else b""
                keep = headers.get("connection", "").lower() != "close"
                async with self.tracer.span(
                        f"s3.{method.upper()}"
                        f" {target.partition('?')[0]}") as ingress:
                    status, rhdrs, rbody = await self._handle(
                        method.upper(), target, headers, body)
                    ingress.set_attr("status", status)
                reason = {200: "OK", 204: "No Content",
                          206: "Partial Content", 400: "Bad Request",
                          403: "Forbidden", 404: "Not Found",
                          409: "Conflict",
                          416: "Range Not Satisfiable",
                          500: "Internal Server Error",
                          501: "Not Implemented"}.get(status, "OK")
                out = [f"HTTP/1.1 {status} {reason}\r\n".encode()]
                rhdrs.setdefault("Content-Length", str(len(rbody)))
                rhdrs.setdefault("Connection",
                                 "keep-alive" if keep else "close")
                for k, v in rhdrs.items():
                    out.append(f"{k}: {v}\r\n".encode())
                out.append(b"\r\n")
                writer.write(b"".join(out))
                if method.upper() != "HEAD" and rbody:
                    writer.write(rbody)
                await writer.drain()
                if not keep:
                    return
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    def _plausible_auth(self, headers: Dict[str, str]) -> bool:
        """Cheap pre-body screen: sigv4-shaped Authorization with a
        KNOWN access key (full verification still runs on the body).
        One credential parser (_claimed_access) serves the screen and
        both verifiers."""
        if not headers.get("authorization", "").startswith(
                "AWS4-HMAC-SHA256 "):
            return False
        return self._claimed_access(headers, "") in self.users

    @staticmethod
    def _claimed_access(headers: Dict[str, str],
                        query: str) -> Optional[str]:
        """The access key a request CLAIMS (header or query auth) —
        unverified; used only to hydrate the key cache."""
        authz = headers.get("authorization", "")
        if authz.startswith("AWS4-HMAC-SHA256 "):
            for part in authz[len("AWS4-HMAC-SHA256 "):].split(","):
                k, _, v = part.strip().partition("=")
                if k == "Credential":
                    return v.split("/", 1)[0]
        for k, v in urllib.parse.parse_qsl(query):
            if k == "X-Amz-Credential":
                return v.split("/", 1)[0]
        return None

    USER_CACHE_TTL = 5.0
    USER_NEG_TTL = 2.0

    async def _ensure_user(self, headers: Dict[str, str],
                           query: str) -> None:
        """Hydrate self.users from the DURABLE user table (the
        radosgw-admin-created users) before the sync verifiers run.
        The static dict stays the bootstrap (never expires, takes
        precedence over a same-named durable key); durable keys carry
        a short TTL so suspension/removal take effect within seconds.
        Misses are negative-cached briefly — random-credential spam
        must not buy a meta-pool read per request — short enough that
        a just-created user works almost immediately.  A transient
        cluster error keeps whatever is cached (never evicts)."""
        import time as _time

        access = self._claimed_access(headers, query)
        if not access:
            return
        now = _time.monotonic()
        expiry = self._durable_keys.get(access)
        if access in self.users and expiry is None:
            return  # static bootstrap key
        if expiry is not None and now < expiry:
            return
        if now < self._neg_keys.get(access, 0):
            return  # recently confirmed unknown
        try:
            secret = await self.rgw.user_key_lookup(access)
        except Exception:
            return  # cluster hiccup: keep the cached state as-is
        if secret is not None:
            self.users[access] = secret
            self._durable_keys[access] = now + self.USER_CACHE_TTL
            self._neg_keys.pop(access, None)
        else:
            if expiry is not None:
                # durable key revoked/suspended since last refresh
                self.users.pop(access, None)
                self._durable_keys.pop(access, None)
            if len(self._neg_keys) > 4096:
                self._neg_keys.clear()  # bounded
            self._neg_keys[access] = now + self.USER_NEG_TTL

    def _plausible_presigned(self, target: str) -> bool:
        """Same screen for query-string auth: a presigned-shaped URL
        naming a KNOWN access key may carry a large body (the PUT
        case); full verification still runs afterwards."""
        _path, _, query = target.partition("?")
        if "X-Amz-Signature=" not in query:
            return False
        params = dict(urllib.parse.parse_qsl(query))
        cred = params.get("X-Amz-Credential", "")
        return cred.split("/", 1)[0] in self.users

    # -- sigv4 -------------------------------------------------------------

    def _verify_sigv4(self, method: str, path: str, query: str,
                      headers: Dict[str, str], body: bytes) -> str:
        """Returns the authenticated access key; raises on failure.
        (rgw_auth_s3's AWSv4ComplMulti/canonicalization role.)"""
        authz = headers.get("authorization", "")
        if not authz.startswith("AWS4-HMAC-SHA256 "):
            raise _HttpError("AccessDenied", "missing sigv4 auth")
        fields = {}
        for part in authz[len("AWS4-HMAC-SHA256 "):].split(","):
            k, _, v = part.strip().partition("=")
            fields[k] = v
        cred = fields.get("Credential", "").split("/")
        if len(cred) != 5:
            raise _HttpError("AccessDenied", "bad credential scope")
        access, date, region, service, _term = cred
        secret = self.users.get(access)
        if secret is None:
            raise _HttpError("AccessDenied", "unknown access key")
        signed_headers = fields.get("SignedHeaders", "")
        payload_hash = headers.get("x-amz-content-sha256")
        if payload_hash is None:
            # clients (curl --aws-sigv4) may sign the payload hash
            # without sending the header: canonicalize with the actual
            # body hash, which is then integrity-checked by the
            # signature itself
            payload_hash = hashlib.sha256(body).hexdigest()
        elif payload_hash != UNSIGNED and \
                payload_hash != hashlib.sha256(body).hexdigest():
            raise _HttpError("SignatureDoesNotMatch",
                             "payload hash mismatch")
        # canonical request — spec form first; legacy curl (<8.3,
        # --aws-sigv4) signs the RAW query string verbatim (no sort,
        # no k= for bare keys), so a second pass accepts that form:
        # same HMAC strength, alternative canonicalization
        cq_spec = _canonical_query(urllib.parse.parse_qsl(
            query, keep_blank_values=True))
        ch = "".join(f"{h}:{' '.join(headers.get(h, '').split())}\n"
                     for h in signed_headers.split(";"))
        scope = f"{date}/{region}/{service}/aws4_request"
        amz_date = headers.get("x-amz-date", "")
        got_sig = fields.get("Signature", "")

        def matches(cq: str) -> bool:
            creq = "\n".join([method, path, cq, ch, signed_headers,
                              payload_hash])
            to_sign = "\n".join([
                "AWS4-HMAC-SHA256", amz_date, scope,
                hashlib.sha256(creq.encode()).hexdigest()])
            want = hmac.new(_sig_key(secret, date, region, service),
                            to_sign.encode(),
                            hashlib.sha256).hexdigest()
            return hmac.compare_digest(want, got_sig)

        if not matches(cq_spec) and \
                not (query != cq_spec and matches(query)):
            raise _HttpError("SignatureDoesNotMatch", "bad signature")
        # clock-skew window (S3's RequestTimeTooSkewed, ~15 min): a
        # captured signed request must not replay indefinitely
        try:
            then = datetime.datetime.strptime(
                amz_date, "%Y%m%dT%H%M%SZ").replace(
                tzinfo=datetime.timezone.utc)
        except ValueError:
            raise _HttpError("AccessDenied", "bad x-amz-date")
        now = datetime.datetime.now(datetime.timezone.utc)
        if abs((now - then).total_seconds()) > 900:
            raise _HttpError("RequestTimeTooSkewed", amz_date)
        return access

    def _verify_presigned(self, method: str, path: str, query: str,
                          headers: Dict[str, str]) -> str:
        """Query-string sigv4 (presigned URLs — the
        AWSv4ComplSingle/query-auth role): the signature covers every
        X-Amz-* query param except the signature itself, with an
        UNSIGNED-PAYLOAD body hash; validity is bounded by
        X-Amz-Date + X-Amz-Expires rather than the skew window."""
        pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
        params = dict(pairs)  # X-Amz fields occur once per spec
        if params.get("X-Amz-Algorithm") != "AWS4-HMAC-SHA256":
            raise _HttpError("AccessDenied", "bad presign algorithm")
        cred = params.get("X-Amz-Credential", "").split("/")
        if len(cred) != 5:
            raise _HttpError("AccessDenied", "bad credential scope")
        access, date, region, service, _term = cred
        secret = self.users.get(access)
        if secret is None:
            raise _HttpError("AccessDenied", "unknown access key")
        amz_date = params.get("X-Amz-Date", "")
        try:
            then = datetime.datetime.strptime(
                amz_date, "%Y%m%dT%H%M%SZ").replace(
                tzinfo=datetime.timezone.utc)
            expires = int(params.get("X-Amz-Expires", "0"))
        except ValueError:
            raise _HttpError("AccessDenied", "bad presign date")
        if not 0 < expires <= 604800:
            # S3's AuthorizationQueryParametersError: a leaked URL
            # must not be a permanent credential (7-day cap)
            raise _HttpError("AccessDenied",
                             "X-Amz-Expires out of range")
        now = datetime.datetime.now(datetime.timezone.utc)
        age = (now - then).total_seconds()
        if age > expires:
            raise _HttpError("AccessDenied", "Request has expired")
        if age < -900:  # not valid before its own date (minus skew)
            raise _HttpError("AccessDenied", "not yet valid")
        signed_headers = params.get("X-Amz-SignedHeaders", "host")
        # canonicalize from the PAIR list: duplicate parameter names
        # are legal and signed individually
        cq = _canonical_query(
            (k, v) for k, v in pairs if k != "X-Amz-Signature")
        ch = "".join(f"{h}:{' '.join(headers.get(h, '').split())}\n"
                     for h in signed_headers.split(";"))
        creq = "\n".join([method, path, cq, ch, signed_headers,
                          "UNSIGNED-PAYLOAD"])
        scope = f"{date}/{region}/{service}/aws4_request"
        to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(creq.encode()).hexdigest()])
        want = hmac.new(_sig_key(secret, date, region, service),
                        to_sign.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want,
                                   params.get("X-Amz-Signature", "")):
            raise _HttpError("SignatureDoesNotMatch",
                             "bad presigned signature")
        return access

    # -- dispatch ----------------------------------------------------------

    async def _handle(self, method: str, target: str,
                      headers: Dict[str, str], body: bytes
                      ) -> Tuple[int, Dict[str, str], bytes]:
        path, _, query = target.partition("?")
        try:
            await self._ensure_user(headers, query)
            if not headers.get("authorization") and any(
                    k == "X-Amz-Signature"
                    for k, _v in urllib.parse.parse_qsl(
                        query, keep_blank_values=True)):
                # a REAL X-Amz-Signature parameter — not a substring
                # inside some value — selects query auth; anything
                # else stays on the anonymous path
                access = self._verify_presigned(method, path, query,
                                                headers)
            elif headers.get("authorization") or \
                    not self.anonymous_ok:
                access = self._verify_sigv4(method, path, query,
                                            headers, body)
            else:
                # anonymous request: identity None, every op gated by
                # the canned-ACL checks below (RGWHandler_REST's
                # anonymous auth applier role)
                access = None
            # the authenticated identity IS the QoS tenant: every
            # rados op this request fans into carries it (MOSDOp v4),
            # so the OSDs' per-tenant mClock classes and admission
            # gate see s3 traffic per access key, not as one blob
            from ceph_tpu_torch.rados.client import CURRENT_TENANT

            CURRENT_TENANT.set(f"s3:{access}" if access else "s3:anon")
            q = dict(urllib.parse.parse_qsl(query,
                                            keep_blank_values=True))
            parts = urllib.parse.unquote(path).lstrip("/").split("/", 1)
            bucket = parts[0]
            key = parts[1] if len(parts) > 1 else ""
            if not bucket:
                if method == "GET":
                    if access is None:
                        raise _HttpError("AccessDenied",
                                         "anonymous service listing")
                    return await self._list_buckets()
                raise _HttpError("InvalidRequest", "no bucket")
            if not key:
                return await self._bucket_op(method, bucket, q, body,
                                             headers, access)
            return await self._object_op(method, bucket, key, q,
                                         headers, body, access)
        except _HttpError as e:
            status, hdrs, body = self._error(e.code, str(e))
            hdrs.update(e.headers)
            return status, hdrs, body
        except RGWError as e:
            return self._error(e.code, str(e))
        except Exception:
            log.exception("s3: %s %s failed", method, target)
            return self._error("InternalError", "")

    def _error(self, code: str,
               what: str) -> Tuple[int, Dict[str, str], bytes]:
        root = ET.Element("Error")
        ET.SubElement(root, "Code").text = code
        ET.SubElement(root, "Message").text = what
        return (_ERR_STATUS.get(code, 400),
                {"Content-Type": "application/xml"},
                ET.tostring(root, xml_declaration=True))

    def _xml(self, root) -> Tuple[int, Dict[str, str], bytes]:
        return 200, {"Content-Type": "application/xml"}, \
            ET.tostring(root, xml_declaration=True)

    async def _list_buckets(self):
        names = await self.rgw.list_buckets()
        root = ET.Element("ListAllMyBucketsResult")
        buckets = ET.SubElement(root, "Buckets")
        for name in names:
            b = ET.SubElement(buckets, "Bucket")
            ET.SubElement(b, "Name").text = name
        return self._xml(root)

    # -- canned-ACL adjudication (rgw_acl.cc verify_permission role) -------

    @staticmethod
    def _is_owner(access: Optional[str], owner: str) -> bool:
        # pre-ACL buckets recorded no owner; they stay what they were
        # before ACLs existed here — open to every AUTHENTICATED user
        return access is not None and (not owner or access == owner)

    @classmethod
    def _may_read(cls, access: Optional[str], owner: str,
                  acl: str) -> bool:
        if cls._is_owner(access, owner):
            return True
        if acl in ("public-read", "public-read-write"):
            return True
        return acl == "authenticated-read" and access is not None

    @classmethod
    def _may_write(cls, access: Optional[str], owner: str,
                   acl: str) -> bool:
        if cls._is_owner(access, owner):
            return True
        return acl == "public-read-write"

    def _require(self, ok: bool, what: str) -> None:
        if not ok:
            raise _HttpError("AccessDenied", what)

    def _canned_from_headers(self, headers: Dict[str, str]
                             ) -> Optional[str]:
        acl = headers.get("x-amz-acl")
        if acl is not None and acl not in CANNED_ACLS:
            raise _HttpError("InvalidArgument", f"bad x-amz-acl {acl!r}")
        return acl

    def _acl_policy_xml(self, owner: str, acl: str):
        """AccessControlPolicy rendering of a canned ACL (the
        RGWAccessControlPolicy_S3 to_xml role)."""
        root = ET.Element("AccessControlPolicy")
        root.set("xmlns:xsi", "http://www.w3.org/2001/XMLSchema-instance")
        o = ET.SubElement(root, "Owner")
        ET.SubElement(o, "ID").text = owner
        grants = ET.SubElement(root, "AccessControlList")

        def grant(grantee: str, perm: str):
            g = ET.SubElement(grants, "Grant")
            ge = ET.SubElement(g, "Grantee")
            if grantee == "owner":
                ge.set("xsi:type", "CanonicalUser")
                ET.SubElement(ge, "ID").text = owner
            else:
                ge.set("xsi:type", "Group")
                ET.SubElement(ge, "URI").text = (
                    "http://acs.amazonaws.com/groups/global/" + grantee)
            ET.SubElement(g, "Permission").text = perm

        grant("owner", "FULL_CONTROL")
        if acl in ("public-read", "public-read-write"):
            grant("AllUsers", "READ")
        if acl == "public-read-write":
            grant("AllUsers", "WRITE")
        if acl == "authenticated-read":
            grant("AuthenticatedUsers", "READ")
        return self._xml(root)

    async def _bucket_op(self, method: str, bucket: str, q: Dict,
                         body: bytes = b"",
                         headers: Optional[Dict] = None,
                         access: Optional[str] = None):
        headers = headers or {}
        if method == "PUT" and "acl" in q:
            info = await self.rgw.get_bucket_acl_info(bucket)
            self._require(self._is_owner(access, info["owner"]),
                          "bucket acl is owner-only")
            acl = self._canned_from_headers(headers)
            if acl is None:
                raise _HttpError("InvalidArgument",
                                 "x-amz-acl required (canned ACLs)")
            await self.rgw.put_bucket_acl(bucket, acl)
            return 200, {}, b""
        if method == "GET" and "acl" in q:
            info = await self.rgw.get_bucket_acl_info(bucket)
            self._require(self._is_owner(access, info["owner"]),
                          "bucket acl is owner-only")
            return self._acl_policy_xml(info["owner"], info["acl"])
        if method == "PUT" and not ("versioning" in q
                                    or "lifecycle" in q):
            # bucket creation: authenticated only, creator = owner
            self._require(access is not None, "anonymous create")
            await self.rgw.create_bucket(
                bucket, owner=access,
                acl=self._canned_from_headers(headers) or "private")
            return 200, {}, b""
        info = await self.rgw.get_bucket_acl_info(bucket)
        owner, bacl = info["owner"], info["acl"]
        if method in ("GET", "HEAD"):
            # listings (plain, V2, ?versions, ?versioning, ?lifecycle)
            # are bucket READs; config subresources stay owner-only
            if "versioning" in q or "lifecycle" in q:
                self._require(self._is_owner(access, owner),
                              "bucket config is owner-only")
            else:
                self._require(self._may_read(access, owner, bacl),
                              "bucket listing denied by acl")
        elif method in ("PUT", "DELETE"):
            self._require(self._is_owner(access, owner),
                          "bucket mutation is owner-only")
        return await self._bucket_op_authed(method, bucket, q, body)

    async def _bucket_op_authed(self, method: str, bucket: str,
                                q: Dict, body: bytes = b""):
        if method == "PUT" and "versioning" in q:
            try:
                root = ET.fromstring(body)
            except ET.ParseError:
                raise _HttpError("MalformedXML", "bad versioning xml")
            st_el = next((c for c in root
                          if c.tag.endswith("Status")), None)
            if st_el is None:
                # legal S3: a VersioningConfiguration with no Status
                # means "no change" — never silently suspend
                return 200, {}, b""
            if st_el.text == "Enabled":
                status = "enabled"
            elif st_el.text == "Suspended":
                status = "suspended"
            else:
                raise _HttpError("MalformedXML",
                                 f"bad Status {st_el.text!r}")
            await self.rgw.put_bucket_versioning(bucket, status)
            return 200, {}, b""
        if method == "GET" and "versioning" in q:
            status = await self.rgw.get_bucket_versioning(bucket)
            root = ET.Element("VersioningConfiguration")
            if status != "off":
                ET.SubElement(root, "Status").text = \
                    "Enabled" if status == "enabled" else "Suspended"
            return self._xml(root)
        if method == "PUT" and "lifecycle" in q:
            await self.rgw.put_bucket_lifecycle(
                bucket, self._parse_lifecycle(body))
            return 200, {}, b""
        if method == "GET" and "lifecycle" in q:
            rules = await self.rgw.get_bucket_lifecycle(bucket)
            root = ET.Element("LifecycleConfiguration")
            for r in rules:
                rule = ET.SubElement(root, "Rule")
                ET.SubElement(rule, "ID").text = r.get("id", "")
                ET.SubElement(rule, "Prefix").text = \
                    r.get("prefix", "")
                ET.SubElement(rule, "Status").text = \
                    r.get("status", "Enabled")
                if "expiration_days" in r:
                    e = ET.SubElement(rule, "Expiration")
                    ET.SubElement(e, "Days").text = \
                        str(r["expiration_days"])
                if "noncurrent_days" in r:
                    e = ET.SubElement(rule,
                                      "NoncurrentVersionExpiration")
                    ET.SubElement(e, "NoncurrentDays").text = \
                        str(r["noncurrent_days"])
                if "abort_multipart_days" in r:
                    e = ET.SubElement(rule,
                                      "AbortIncompleteMultipartUpload")
                    ET.SubElement(e, "DaysAfterInitiation").text = \
                        str(r["abort_multipart_days"])
            return self._xml(root)
        if method == "GET" and "versions" in q:
            entries = await self.rgw.list_object_versions(
                bucket, prefix=q.get("prefix", ""))
            root = ET.Element("ListVersionsResult")
            ET.SubElement(root, "Name").text = bucket
            for e in entries:
                tag = "DeleteMarker" if e["delete_marker"] \
                    else "Version"
                v = ET.SubElement(root, tag)
                ET.SubElement(v, "Key").text = e["key"]
                ET.SubElement(v, "VersionId").text = e["version_id"]
                if not e["delete_marker"]:
                    ET.SubElement(v, "Size").text = str(e["size"])
                    ET.SubElement(v, "ETag").text = \
                        f"\"{e['etag']}\""
            return self._xml(root)
        if method == "DELETE":
            await self.rgw.delete_bucket(bucket)
            return 204, {}, b""
        if method in ("GET", "HEAD") and q.get("list-type") == "2":
            try:
                max_keys = int(q.get("max-keys", "1000"))
            except ValueError:
                raise _HttpError("InvalidArgument", "bad max-keys")
            res = await self.rgw.list_objects_v2(
                bucket, prefix=q.get("prefix", ""),
                delimiter=q.get("delimiter", ""),
                continuation_token=q.get("continuation-token", ""),
                max_keys=max_keys)
            root = ET.Element("ListBucketResult")
            ET.SubElement(root, "Name").text = bucket
            ET.SubElement(root, "KeyCount").text = \
                str(len(res["contents"]) + len(res["common_prefixes"]))
            ET.SubElement(root, "IsTruncated").text = \
                "true" if res["is_truncated"] else "false"
            if res["next_token"]:
                ET.SubElement(root, "NextContinuationToken").text = \
                    res["next_token"]
            for e in res["contents"]:
                c = ET.SubElement(root, "Contents")
                ET.SubElement(c, "Key").text = e["key"]
                ET.SubElement(c, "Size").text = str(e.get("size", 0))
                ET.SubElement(c, "ETag").text = \
                    f"\"{e.get('etag', '')}\""
            for p in res["common_prefixes"]:
                cp = ET.SubElement(root, "CommonPrefixes")
                ET.SubElement(cp, "Prefix").text = p
            return self._xml(root)
        if method in ("GET", "HEAD"):
            entries = await self.rgw.list_objects(
                bucket, prefix=q.get("prefix", ""))
            root = ET.Element("ListBucketResult")
            ET.SubElement(root, "Name").text = bucket
            ET.SubElement(root, "IsTruncated").text = "false"
            for e in entries:
                c = ET.SubElement(root, "Contents")
                ET.SubElement(c, "Key").text = e["key"]
                ET.SubElement(c, "Size").text = str(e.get("size", 0))
                ET.SubElement(c, "ETag").text = \
                    f"\"{e.get('etag', '')}\""
            return self._xml(root)
        raise _HttpError("InvalidRequest", method)

    @staticmethod
    def _parse_lifecycle(body: bytes):
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise _HttpError("InvalidRequest", "bad lifecycle xml")
        rules = []
        for rel in root:
            if not rel.tag.endswith("Rule"):
                continue
            rule = {}
            for child in rel:
                tag = child.tag.rsplit("}", 1)[-1]
                if tag == "ID":
                    rule["id"] = child.text or ""
                elif tag == "Prefix":
                    rule["prefix"] = child.text or ""
                elif tag == "Status":
                    rule["status"] = child.text or "Enabled"
                elif tag == "Expiration":
                    for d in child:
                        if d.tag.endswith("Days"):
                            rule["expiration_days"] = \
                                _int_or_400(d.text, "Days")
                elif tag == "NoncurrentVersionExpiration":
                    for d in child:
                        if d.tag.endswith("NoncurrentDays"):
                            rule["noncurrent_days"] = \
                                _int_or_400(d.text, "NoncurrentDays")
                elif tag == "AbortIncompleteMultipartUpload":
                    for d in child:
                        if d.tag.endswith("DaysAfterInitiation"):
                            rule["abort_multipart_days"] = \
                                _int_or_400(d.text,
                                            "DaysAfterInitiation")
            rules.append(rule)
        return rules

    @staticmethod
    def _range_response(etag: str, part: bytes, first: int,
                        size: int) -> Tuple[int, Dict[str, str], bytes]:
        """206 Partial Content with Content-Range — one construction
        for the unversioned pushdown and the versioned slice."""
        last = first + len(part) - 1
        return 206, {
            "ETag": f"\"{etag}\"",
            "Content-Type": "application/octet-stream",
            "Content-Length": str(len(part)),
            "Content-Range": f"bytes {first}-{last}/{size}",
            "Accept-Ranges": "bytes"}, part

    async def _object_op(self, method: str, bucket: str, key: str,
                         q: Dict, headers: Dict, body: bytes,
                         access: Optional[str] = None):
        rgw = self.rgw
        info = await rgw.get_bucket_acl_info(bucket)
        owner, bacl = info["owner"], info["acl"]
        if "acl" in q and method in ("GET", "PUT"):
            # object ?acl subresource: owner-only (READ_ACP/WRITE_ACP
            # collapse onto ownership under canned policies)
            self._require(self._is_owner(access, owner),
                          "object acl is owner-only")
            if method == "GET":
                oacl = await rgw.get_object_acl(bucket, key)
                return self._acl_policy_xml(owner, oacl)
            acl = self._canned_from_headers(headers)
            if acl is None:
                raise _HttpError("InvalidArgument",
                                 "x-amz-acl required (canned ACLs)")
            await rgw.put_object_acl(bucket, key, acl)
            return 200, {}, b""
        if method in ("GET", "HEAD"):
            # object reads: the OBJECT acl governs, with the bucket
            # acl honored as a floor (a public-read bucket serves its
            # objects; stricter per-object ACLs need per-object grants
            # the canned model doesn't express)
            try:
                oacl = await rgw.get_object_acl(bucket, key)
            except RGWError:
                oacl = "private"  # versioned-only key: bucket governs
            self._require(
                self._may_read(access, owner, oacl)
                or self._may_read(access, owner, bacl),
                "object read denied by acl")
        else:
            # PUT/DELETE/multipart: bucket WRITE permission
            self._require(self._may_write(access, owner, bacl),
                          "object write denied by acl")
        if method == "POST" and "uploads" in q:
            upload_id = await rgw.init_multipart(
                bucket, key, acl=self._canned_from_headers(headers))
            root = ET.Element("InitiateMultipartUploadResult")
            ET.SubElement(root, "Bucket").text = bucket
            ET.SubElement(root, "Key").text = key
            ET.SubElement(root, "UploadId").text = upload_id
            return self._xml(root)
        if method == "PUT" and "partNumber" in q and "uploadId" in q:
            try:
                num = int(q["partNumber"])
            except ValueError:
                raise _HttpError("InvalidRequest", "bad partNumber")
            etag = await rgw.upload_part(
                bucket, key, q["uploadId"], num, body)
            return 200, {"ETag": f"\"{etag}\""}, b""
        if method == "POST" and "uploadId" in q:
            parts = self._parse_complete(body)
            etag = await rgw.complete_multipart(
                bucket, key, q["uploadId"], parts)
            root = ET.Element("CompleteMultipartUploadResult")
            ET.SubElement(root, "Bucket").text = bucket
            ET.SubElement(root, "Key").text = key
            ET.SubElement(root, "ETag").text = f"\"{etag}\""
            return self._xml(root)
        if method == "DELETE" and "uploadId" in q:
            await rgw.abort_multipart(bucket, key, q["uploadId"])
            return 204, {}, b""
        if method == "PUT":
            etag, vid = await rgw.put_object_ex(
                bucket, key, body,
                acl=self._canned_from_headers(headers))
            hdrs = {"ETag": f"\"{etag}\""}
            if vid is not None:
                hdrs["x-amz-version-id"] = vid
            return 200, hdrs, b""
        if method == "HEAD":
            head = await rgw.head_object(bucket, key)
            return 200, {"ETag": f"\"{head.get('etag', '')}\"",
                         "Content-Type": "application/octet-stream",
                         "Content-Length": str(head.get("size", 0))
                         }, b""
        if method == "GET":
            rng = headers.get("range")
            version = q.get("versionId")
            # syntactic screen against a sentinel size: malformed and
            # multi-range specs fall straight through to a plain 200
            # without paying any extra lookups
            if rng and version is None and \
                    parse_byte_range(rng, 1 << 62) is not None:
                # ranged GET (206/Content-Range; 416 when the range
                # misses the object entirely).  One head load: the
                # gateway resolves the spec against the authoritative
                # manifest size and fetches only the touched stripe
                # sub-ranges — each rides the OSD's ranged EC read
                # path and counts as a tier read.
                resolved: Dict[str, Any] = {}

                def resolve(size: int):
                    span = parse_byte_range(rng, size)
                    if span is RANGE_UNSATISFIABLE:
                        raise _HttpError(
                            "InvalidRange", f"{rng} of {size} bytes",
                            headers={"Content-Range":
                                     f"bytes */{size}"})
                    resolved["size"] = size
                    resolved["span"] = span
                    return span

                part, etag = await rgw.get_object_ex(
                    bucket, key, range_resolver=resolve)
                span, size = resolved["span"], resolved["size"]
                if span is not None and part:
                    return self._range_response(etag, part, span[0],
                                                size)
                # span None cannot happen post-screen; an empty part
                # (pathological manifest) degrades to the plain GET
            data, etag = await rgw.get_object_ex(
                bucket, key, version_id=version)
            if rng and version is not None:
                # versioned ranged GET: versions are immutable, the
                # simple fetch+slice is exact
                span = parse_byte_range(rng, len(data))
                if span is RANGE_UNSATISFIABLE:
                    status, hdrs, xml = self._error(
                        "InvalidRange", f"{rng} of {len(data)} bytes")
                    hdrs["Content-Range"] = f"bytes */{len(data)}"
                    return status, hdrs, xml
                if span is not None:
                    first, last = span
                    return self._range_response(
                        etag, data[first:last + 1], first, len(data))
            return 200, {"ETag": f"\"{etag}\"",
                         "Content-Type": "application/octet-stream",
                         "Content-Length": str(len(data)),
                         "Accept-Ranges": "bytes"}, data
        if method == "DELETE":
            marker = await rgw.delete_object(
                bucket, key, version_id=q.get("versionId"))
            hdrs = {}
            if marker is not None:
                hdrs["x-amz-delete-marker"] = "true"
                hdrs["x-amz-version-id"] = marker
            return 204, hdrs, b""
        raise _HttpError("InvalidRequest", method)

    @staticmethod
    def _parse_complete(body: bytes) -> List[Tuple[int, str]]:
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise _HttpError("InvalidRequest", "bad completion xml")
        out = []
        for part in root:
            if not part.tag.endswith("Part"):
                continue
            num = etag = None
            for child in part:
                if child.tag.endswith("PartNumber"):
                    try:
                        num = int(child.text)
                    except (TypeError, ValueError):
                        raise _HttpError("InvalidRequest",
                                         "bad PartNumber")
                elif child.tag.endswith("ETag"):
                    etag = (child.text or "").strip().strip('"')
            if num is not None and etag is not None:
                out.append((num, etag))
        return sorted(out)


# -- a spec-complete sigv4 signer (client side) ------------------------------
# Used by the CLI/tests to talk to the frontend the way a stock S3
# client does: the signature math below is implemented from the AWS
# SigV4 spec independently of the server's verifier.


def sign_request(method: str, url_path: str, query: Dict[str, str],
                 headers: Dict[str, str], body: bytes,
                 access: str, secret: str,
                 region: str = "us-east-1") -> Dict[str, str]:
    """Returns headers with Authorization/x-amz-date/content-sha256."""
    now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(body).hexdigest()
    out = dict(headers)
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash
    signed = sorted({k.lower() for k in out})
    cq = _canonical_query(query.items())
    lower = {k.lower(): v for k, v in out.items()}
    ch = "".join(f"{h}:{' '.join(lower.get(h, '').split())}\n"
                 for h in signed)
    creq = "\n".join([method, url_path, cq, ch, ";".join(signed),
                      payload_hash])
    scope = f"{date}/{region}/s3/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(creq.encode()).hexdigest()])
    sig = hmac.new(_sig_key(secret, date, region, "s3"),
                   to_sign.encode(), hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return out


def presign_url(method: str, host: str, url_path: str,
                access: str, secret: str, expires: int = 3600,
                query: Optional[Dict[str, str]] = None,
                region: str = "us-east-1") -> str:
    """Mint a presigned URL (query-string sigv4, UNSIGNED-PAYLOAD) —
    what `aws s3 presign` / boto3 generate_presigned_url produce; any
    plain HTTP client can then use it with no credentials."""
    now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = now.strftime("%Y%m%d")
    scope = f"{date}/{region}/s3/aws4_request"
    # canonical-URI rule: path segments percent-encoded, "/" kept —
    # the URL carries the SAME encoded form the signature covers, so
    # keys with spaces/reserved chars verify
    url_path = urllib.parse.quote(url_path, safe="/-_.~")
    params = dict(query or {})
    params.update({
        "X-Amz-Algorithm": "AWS4-HMAC-SHA256",
        "X-Amz-Credential": f"{access}/{scope}",
        "X-Amz-Date": amz_date,
        "X-Amz-Expires": str(expires),
        "X-Amz-SignedHeaders": "host",
    })
    cq = _canonical_query(params.items())
    creq = "\n".join([method, url_path, cq, f"host:{host}\n",
                      "host", "UNSIGNED-PAYLOAD"])
    to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(creq.encode()).hexdigest()])
    sig = hmac.new(_sig_key(secret, date, region, "s3"),
                   to_sign.encode(), hashlib.sha256).hexdigest()
    return (f"http://{host}{url_path}?{cq}"
            f"&X-Amz-Signature={sig}")
