#!/usr/bin/env python3
"""Time crc32c_blocks at the shapes the main path gives it, on one CUDA card.

    python3 ceph_tpu_torch/tools/crc_shapes.py [--root DIR]

`--root` names the checkout whose ceph_tpu_torch is built and timed
(default: the one holding this script), so that two versions of the
kernel can be timed in turns on one card in one call: parent, change,
change, parent.  The shapes are 704, 512 and 192 blocks of 512 KiB (all
hinfo chunks of a 64-stripe RS 8+3 write, and the data and parity launches
of plan.encode_with_crc) and 90112 blocks of 4 KiB, each checked bit for
bit against the plain version first.  Prints one JSON line: the card's
name and power limit, and per shape the CUDA-event median of 20 launches
after warm-up (each launch timed alone, as chip_smoke.py times it), the
mean of 20 launches timed back to back (no host gap between them), and
the bytes bound at 3.35 TB/s, beside the back-to-back time of a plain
read of the same bytes (torch.sum over them as float32) as a yardstick
of the read rate the card reaches.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = ((704, 512 << 10), (512, 512 << 10), (192, 512 << 10),
          (90112, 4096))
HBM_BYTES_PER_S = 3.35e12
SEED = 20261016


def back_to_back_ms(torch, fn, reps: int) -> float:
    """Mean ms of `reps` calls enqueued back to back (no host gap)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch
    if not torch.cuda.is_available():
        sys.exit("crc_shapes: needs a CUDA card")
    from ceph_tpu_torch.ops import checksum as cks
    from ceph_tpu_torch.ops import crc_kernels
    if not Path(crc_kernels.__file__).resolve().is_relative_to(root):
        sys.exit(f"crc_shapes: imported {crc_kernels.__file__}, not {root}")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    buf = torch.randint(0, 256, (max(n * ln for n, ln in SHAPES),),
                        dtype=torch.uint8, device=dev, generator=gen)
    shapes = []
    for n, length in SHAPES:
        blk = buf[:n * length]
        out = torch.empty(n, dtype=torch.int32, device=dev)
        got = crc_kernels.crc32c_blocks(blk, length, 0, out=out).clone()
        ok = torch.equal(got, cks.crc32c_batch(blk.view(n, length), 0))
        for _ in range(3):
            crc_kernels.crc32c_blocks(blk, length, 0, out=out)
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            crc_kernels.crc32c_blocks(blk, length, 0, out=out)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        shapes.append({"blocks": n, "length": length, "exact": ok,
                       "ms": statistics.median(times), "min_ms": min(times),
                       "back_to_back_ms": back_to_back_ms(
                           torch, lambda: crc_kernels.crc32c_blocks(
                               blk, length, 0, out=out), args.reps),
                       "read_ms": back_to_back_ms(torch, lambda: torch.sum(
                           blk.view(torch.float32)), args.reps),
                       "bound_ms": n * (length + 4) / HBM_BYTES_PER_S * 1e3})
    print(json.dumps({"root": str(root), "card": card, "shapes": shapes}))
    if not all(s["exact"] for s in shapes):
        sys.exit("crc_shapes: the kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
