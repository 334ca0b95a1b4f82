"""Zero-copy shard buffer views (the bufferlist share-don't-copy role;
the part of ceph_tpu/common/buffer.py that the port's stores and
compute kernels and the OSD's tier promote use: `is_immutable`, `adopt`,
`as_buffer`).

Reference parity: ceph::buffer::list (the reference's src/include/
buffer.h) lets every layer pass refcounted views of the same pages —
an EC data shard handed to the ObjectStore is a view of the client's
message buffer, never a copy.  Python's memoryview covers that here:
the port's ECUtil hands each shard out as a frozen view of a
contiguous array.
"""

from __future__ import annotations

import numpy as np


def is_immutable(data) -> bool:
    """True when no OTHER owner can mutate the buffer's bytes.

    The store-adoption guard (os/memstore.py): adopted buffers must
    never change under the recorded crcs.  Walks the base chain:

    - bytes: immutable by construction.
    - memoryview: must be readonly AND backed by an immutable base —
      `memoryview(ba).toreadonly()` is readonly while its owner still
      mutates `ba`, so readonly alone is not proof.
    - ndarray: every view on the chain must be frozen
      (non-writeable) down to a root that either owns its memory
      (frozen owner — producers in this repo freeze via setflags and
      never thaw; the claim contract covers them) or wraps an
      immutable buffer.
    """
    if isinstance(data, bytes):
        return True
    if isinstance(data, memoryview):
        return data.readonly and is_immutable(data.obj)
    if isinstance(data, np.ndarray):
        if data.flags.writeable:
            return False
        if data.base is None:
            return True  # frozen owner
        return is_immutable(data.base)
    return False


def adopt(data):
    """Immutable form of `data` for long-lived caches and stores: pass
    through when is_immutable() proves no other owner can mutate the
    bytes (frozen decode views, bytes), copy otherwise."""
    return data if is_immutable(data) else bytes(data)


def as_buffer(data):
    """Adapt `data` to something frombuffer and memoryview slicing accept,
    copying only when the layout requires it: bytes, bytearray and
    memoryview pass through; a C-contiguous uint8 ndarray hands out its
    buffer view; anything else materializes through bytes()."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return data
    if isinstance(data, np.ndarray) and data.dtype == np.uint8 \
            and data.flags.c_contiguous:
        return data.reshape(-1).data
    return bytes(data)
