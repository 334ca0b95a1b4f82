"""RGW-lite: the S3-gateway role over networked RADOS (port of
ceph_tpu/rgw/; multisite.py and swift_frontend.py are not ported yet).

Reference parity: the RGW data path — RGWPutObj::execute
(Ceph's src/rgw/rgw_op.cc:3712) feeding the put-object
processor pipeline (rgw_putobj_processor.h:73-211: HeadObjectProcessor
-> ChunkProcessor -> StripeProcessor -> RadosWriter), multipart uploads
(MultipartObjectProcessor rgw_putobj_processor.h:211) and the
CompleteMultipart manifest stitch (rgw_op.cc:5933
RGWCompleteMultipart::execute).

Re-designed for this stack: asyncio end to end, JSON manifests/indexes
(the versioned-encoding discipline of the repo), bounded-concurrency
stripe writes over the Objecter-role client (the Aio throttle role), and
erasure-coded data pools whose OSDs encode each stripe on the card
(gf_matmul_spec and crc32c_blocks through the encode service).  The S3
op surface is the API of RGWLite (gateway.py); s3_frontend.py serves it
over HTTP with SigV4.
"""

from ceph_tpu_torch.rgw.gateway import RGWLite, RGWError  # noqa: F401
from ceph_tpu_torch.rgw.put_processor import (  # noqa: F401
    Manifest,
    PutObjProcessor,
    StripeWriter,
)
