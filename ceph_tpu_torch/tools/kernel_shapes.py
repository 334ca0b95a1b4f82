#!/usr/bin/env python3
"""Time the port's kernels at the shapes the main path gives them, on one
CUDA card.

    python3 ceph_tpu_torch/tools/kernel_shapes.py {crc,gf} [--root DIR] [--sass]

`--root` names the checkout whose ceph_tpu_torch is built and timed
(default: the one holding this script), so that two versions of a kernel
can be timed in turns on one card in one call: parent, change, change,
parent.  Every shape is first checked bit for bit against the kernel's
plain version.  Prints one JSON line: the card's name and power limit,
and per shape "ms", the CUDA-event median of REPS launches after 3
warm-up launches, each timed alone (as chip_smoke.py times them);
"back_to_back_ms", the mean of REPS launches enqueued with no host gap;
"bound_ms", the bytes bound at 3.35 TB/s; and "read_ms", a plain read of
the input bytes (torch.sum over them as float32) back to back, as a
yardstick of the read rate the card reaches.

crc: crc32c_blocks at 704, 512 and 192 blocks of 512 KiB (all hinfo
chunks of a 64-stripe RS 8+3 write, and the data and parity launches of
plan.encode_with_crc) and 90112 blocks of 4 KiB.

gf: gf_matmul_spec with the reed_sol_van generators RS 8+3 over 64
stripes of 8 x 512 KiB (the main path's encode launch), RS 10+4 over 64
stripes of 10 x 512 KiB (two input groups) and RS 8+3 over 16384 stripes
of 2052-byte chunks (a length that is no multiple of 16), each beside
gf_matmul_gen on the same matrix and data ("gen_ms",
"gen_back_to_back_ms"); at RS 8+3, also gf_matmul_gen at the main path's
decode launch, one single-erasure row over the same data ("gen_r1").  It
also prints what ptxas reported for the spec kernels (registers, spills)
and, with `--sass`, the instructions of each spec kernel that runs RS 8+3
(R = 3) by opcode and by a few forms (predicated, XOR, mask test, xtime
shift), counted over the whole function in `cuobjdump -sass` of the built
library: every branch's body counts once, taken or not.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPS = 20
HBM_BYTES_PER_S = 3.35e12
SEED = 20261016
CRC_SHAPES = ((704, 512 << 10), (512, 512 << 10), (192, 512 << 10),
              (90112, 4096))
GF_SHAPES = (("rs8+3", 8, 3, 64, 512 << 10), ("rs10+4", 10, 4, 64, 512 << 10),
             ("rs8+3 S=2052", 8, 3, 16384, 2052))


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def alone_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median ms of `reps` calls, each timed alone, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, reps: int = REPS) -> float:
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


def times(fn, n_bytes: int) -> dict:
    return {"ms": alone_ms(fn), "back_to_back_ms": back_to_back_ms(fn),
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}


def read_ms(data: torch.Tensor) -> float:
    return back_to_back_ms(lambda: torch.sum(data.view(torch.float32)))


def crc_shapes(dev, gen) -> list:
    from ceph_tpu_torch.ops import checksum as cks
    from ceph_tpu_torch.ops import crc_kernels
    buf = torch.randint(0, 256, (max(n * ln for n, ln in CRC_SHAPES),),
                        dtype=torch.uint8, device=dev, generator=gen)
    shapes = []
    for n, length in CRC_SHAPES:
        blk = buf[:n * length]
        out = torch.empty(n, dtype=torch.int32, device=dev)
        got = crc_kernels.crc32c_blocks(blk, length, 0, out=out).clone()
        shapes.append({
            "blocks": n, "length": length,
            "exact": torch.equal(got, cks.crc32c_batch(blk.view(n, length),
                                                       0)),
            **times(lambda: crc_kernels.crc32c_blocks(blk, length, 0,
                                                      out=out),
                    n * (length + 4)),
            "read_ms": read_ms(blk)})
    return shapes


def gf_shapes(dev, gen) -> list:
    from ceph_tpu_torch.models import reed_solomon as rs
    from ceph_tpu_torch.ops import gf_kernels
    shapes = []
    for name, k, m, b, s in GF_SHAPES:
        mat = rs.reed_sol_van_matrix(k, m)
        gf_kernels.register_matrix(mat)     # as the codec registers it
        data = torch.randint(0, 256, (b, k, s), dtype=torch.uint8,
                             device=dev, generator=gen)
        out = torch.empty((b, m, s), dtype=torch.uint8, device=dev)
        got = gf_kernels.gf_matmul_spec(mat, data, out=out).clone()
        shape = {
            "shape": name, "stripes": b, "k": k, "m": m, "chunk": s,
            "exact": torch.equal(got, gf_kernels.gf_matmul_spec_plain(mat,
                                                                      data)),
            **times(lambda: gf_kernels.gf_matmul_spec(mat, data, out=out),
                    b * (k + m) * s)}
        generic = lambda: gf_kernels.gf_matmul_gen(mat, data, out=out)
        shape.update(gen_ms=alone_ms(generic),
                     gen_back_to_back_ms=back_to_back_ms(generic),
                     read_ms=read_ms(data))
        if name == "rs8+3":
            row = rs.decode_matrix(mat, k, [0], list(range(1, k + 1)))
            one = torch.empty((b, 1, s), dtype=torch.uint8, device=dev)
            got = gf_kernels.gf_matmul_gen(row, data, out=one).clone()
            shape["gen_r1"] = {
                "exact": torch.equal(got, gf_kernels.gf_matmul_gen_plain(
                    row, data)),
                **times(lambda: gf_kernels.gf_matmul_gen(row, data, out=one),
                        b * (k + 1) * s)}
            shape["exact"] = shape["exact"] and shape["gen_r1"]["exact"]
        shapes.append(shape)
        del data, out, got
    return shapes


def ptxas_lines(build) -> list:
    """ptxas's register and spill lines for the spec kernels."""
    log = build.build_logs().get("gf_matmul", "").splitlines()
    keep, on = [], False
    for line in log:
        if "Compiling entry function" in line:
            on = "gf_spec_kernel" in line
            if on:
                keep.append(line.split("'")[1])
        elif on and ("registers" in line or "spill" in line):
            keep.append(line.strip())
    return keep


# instruction forms of the spec kernel, by (opcode, operands)
FORMS = {
    "(xor: lop3 0x3c or 0x96)": lambda op, a: op.startswith("LOP3") and (
        a.rstrip().endswith(("0x3c, !PT", "0x96, !PT"))),
    "(mask test: lop3 to a predicate)": lambda op, a: op.startswith(
        "LOP3") and a.startswith("P"),
    "(xtime: shr by 7)": lambda op, a: (op.startswith("SHF.R")
                                        and ", 0x7," in a),
}


def sass_counts(build) -> dict:
    """{spec kernel (R = 3): {opcode: count}} from cuobjdump -sass."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    libs = sorted(build.BUILD_DIR.glob("gf_matmul-*.so"),
                  key=lambda p: p.stat().st_mtime)
    text = subprocess.run([tool, "-sass", str(libs[-1])], capture_output=True,
                          text=True, timeout=300).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            cur = (collections.Counter()
                   if "gf_spec_kernelILi3E" in name else None)
            if cur is not None:
                counts[name] = cur
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z]\S*)"
                     r"\s*([^;]*)", line)
        if cur is not None and m:
            op = m.group(2).rstrip(";").split(".")[0]
            cur[op] += 1
            if m.group(1):
                cur["(predicated)"] += 1
            for form, hit in FORMS.items():
                if hit(m.group(2), m.group(3)):
                    cur[form] += 1
    return {name: dict(c.most_common()) | {"total": sum(
        v for k, v in c.items() if not k.startswith("("))}
        for name, c in counts.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=("crc", "gf"))
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--sass", action="store_true",
                    help="gf: count the spec kernels' SASS instructions")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    if not torch.cuda.is_available():
        sys.exit("kernel_shapes: needs a CUDA card")
    from ceph_tpu_torch.ops import _build
    if not Path(_build.__file__).resolve().is_relative_to(root):
        sys.exit(f"kernel_shapes: imported {_build.__file__}, not {root}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    res = {"root": str(root), "card": card_name(), "kernel": args.kernel}
    if args.kernel == "crc":
        res["shapes"] = crc_shapes(dev, gen)
    else:
        res["shapes"] = gf_shapes(dev, gen)
        res["build_seconds"] = _build.build_seconds
        res["ptxas"] = ptxas_lines(_build)
        if args.sass:
            res["sass"] = sass_counts(_build)
    print(json.dumps(res))
    if not all(s["exact"] for s in res["shapes"]):
        sys.exit("kernel_shapes: a kernel disagrees with its plain version")


if __name__ == "__main__":
    main()
