"""The port's S3 HTTP frontend (ceph_tpu_torch.rgw.s3_frontend) against the
JAX package's, on the CPU.

The parsers and signers are held value for value against the JAX
functions: `parse_byte_range` on every case of tests/test_s3_range.py's
three parametrised tests, `sign_request` and `presign_url` on one fixed
clock.  The HTTP tests of tests/test_s3_http.py, tests/test_s3_range.py
(the 206/416 test), tests/test_s3_acl.py and tests/test_s3_presigned.py run
on both packages through tests/torch_rgw_helpers (`run_both`): their own
assertions hold the port's answers, and every store must equal the JAX
run's.  The raw-socket S3 client of those tests signs with the port's
`sign_request` in the port's run.
"""

import datetime

import pytest

from ceph_tpu.rgw import s3_frontend as j_fe
from ceph_tpu_torch.rgw import s3_frontend as t_fe

from torch_cluster_helpers import one_torch_thread  # noqa: F401
from torch_rgw_helpers import run_both

import test_s3_acl as j_acl
import test_s3_http as j_http
import test_s3_presigned as j_presigned
import test_s3_range as j_range


def _cases(fn) -> list:
    """The argument tuples of a JAX test's parametrize mark."""
    (mark,) = [m for m in fn.pytestmark if m.name == "parametrize"]
    return [tuple(c) if isinstance(c, (tuple, list)) else (c,)
            for c in mark.args[1]]


def _parsed(module, spec: str, size: int):
    got = module.parse_byte_range(spec, size)
    return "unsatisfiable" if got is module.RANGE_UNSATISFIABLE else got


RANGE_CASES = [c[:2] for fn in (j_range.test_parse_valid_ranges,
                                j_range.test_parse_unsatisfiable_ranges,
                                j_range.test_parse_ignored_ranges)
               for c in _cases(fn)]


@pytest.mark.parametrize("spec,size", RANGE_CASES)
def test_parse_byte_range_matches_jax(spec, size):
    assert _parsed(t_fe, spec, size) == _parsed(j_fe, spec, size)


class _FixedNow(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2026, 10, 18, 1, 2, 3, tzinfo=tz)


def test_signers_match_jax(monkeypatch):
    """SigV4 headers and presigned URLs, byte for byte, on one clock."""
    for mod in (j_fe, t_fe):
        monkeypatch.setattr(mod.datetime, "datetime", _FixedNow)
    args = ("PUT", "/b/some key", {"partNumber": "2", "uploadId": "u1"},
            {"Host": "127.0.0.1:7480", "Range": "bytes=0-9"},
            b"body bytes", "AKIDEXAMPLE", "secret")
    assert t_fe.sign_request(*args) == j_fe.sign_request(*args)
    args = ("GET", "127.0.0.1:7480", "/b/k y", "AK", "SK")
    assert t_fe.presign_url(*args, expires=60, query={"a": "1"}) == \
        j_fe.presign_url(*args, expires=60, query={"a": "1"})


@pytest.mark.parametrize("name", [
    "test_s3_http_object_lifecycle",
    "test_s3_http_multipart_round_trip",
    "test_s3_http_auth_rejection",
])
def test_s3_http(name):
    run_both(j_http, name)


def test_ranged_get_206_suffix_and_416():
    run_both(j_range, "test_ranged_get_206_suffix_and_416")


def test_s3_canned_acls_end_to_end():
    run_both(j_acl, "test_s3_canned_acls_end_to_end", modules=(j_http,))


def test_presigned_get_put_expiry_and_tamper():
    run_both(j_presigned, "test_presigned_get_put_expiry_and_tamper",
             modules=(j_http,))
