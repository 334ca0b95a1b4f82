"""PyTorch/CUDA port of the ceph_tpu erasure-coded data path.

The package runs the OSD's erasure-code write and read path (Reed-Solomon
GF(2^8) encode, decode of erased chunks, and the per-chunk hinfo crc32c
fused with the encode) on an NVIDIA Hopper card through CUDA kernels
written by hand under ``csrc/``, and above it CRUSH placement, the OSD
map with its live PG mapping, and the embedded storage cluster
(``rados/embedded.py``).  Every module keeps the name of its
``ceph_tpu`` counterpart.  It imports ``torch`` and numpy only, never
``jax`` and nothing of ``ceph_tpu``: the host helpers it needs are its
own copies.

Entry points run on the card unless the caller passes ``device="cpu"``;
on a CPU tensor each kernel wrapper runs the kernel's plain PyTorch
version instead, which is what the CPU tests exercise.
"""

__version__ = "0.1.0"
