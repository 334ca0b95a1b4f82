"""Device selection and host<->device staging for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Never picks the CPU on its own: with no argument and no
    usable CUDA device it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ceph_tpu_torch runs on a CUDA device and none is available;"
                " pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not"
                           " available")
    return dev


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Contiguous uint8 host array -> tensor on `device`.

    The callers' arrays are often frozen views (ec_util marks its
    buffers read-only), and ``torch.from_numpy`` on a read-only array
    warns and would alias memory nobody may write.  So on CUDA the bytes
    are copied into pinned staging memory and sent with one
    asynchronous host-to-device copy; on the CPU a read-only array is
    copied and a writable one is wrapped in place (nothing downstream
    writes to its inputs)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if device.type == "cuda":
        staging = torch.empty(arr.shape, dtype=torch.uint8, pin_memory=True)
        staging.numpy()[...] = arr
        return staging.to(device, non_blocking=True)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)
