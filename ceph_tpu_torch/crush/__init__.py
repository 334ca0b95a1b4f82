"""CRUSH placement: map model, exact host mapper, batched CUDA placement
kernel (port of ceph_tpu/crush)."""

from ceph_tpu_torch.crush.map import CrushMap, Bucket, Rule  # noqa: F401
from ceph_tpu_torch.crush.mapper import crush_do_rule  # noqa: F401
