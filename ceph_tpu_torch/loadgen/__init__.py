"""Open-loop multi-tenant load harness (the million-client front
door's measuring instrument; port of ceph_tpu/loadgen).

- workload.py: tenant specs, deterministic Poisson/deterministic
  arrival schedules, zipf object popularity, op blends.
- stats.py: bounded-memory streaming latency histograms + goodput.
- targets.py: embedded-rados / networked-rados / S3 op targets.
- runner.py: the open-loop engine (arrival-rate-driven, latency
  measured from scheduled arrival so queueing delay is counted).

CLI front door: `python -m ceph_tpu_torch.tools.rados ... bench <secs> seq
--tenants N --arrival-rate R --blend read=0.7,write=0.3`.
"""

from ceph_tpu_torch.loadgen.runner import (                # noqa: F401
    run_embedded, run_open_loop,
)
from ceph_tpu_torch.loadgen.stats import (                 # noqa: F401
    GoodputMeter, LatencyHistogram,
)
from ceph_tpu_torch.loadgen.targets import (               # noqa: F401
    EmbeddedTarget, RadosTarget, S3Target, SheddedOp, Target,
)
from ceph_tpu_torch.loadgen.workload import (              # noqa: F401
    DEFAULT_BLEND, OP_KINDS, OpEvent, TenantSpec, make_tenants,
    merged_schedule, parse_blend, schedule_fingerprint,
    tenant_events,
)
