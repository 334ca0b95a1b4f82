"""ceph_erasure_code_benchmark parity CLI (port of
ceph_tpu/tools/erasure_code_benchmark.py).

The reference's src/test/erasure-code/ceph_erasure_code_benchmark.cc:
the same flags (-p/-w/-s/-i/-e/--erased/-E/-P/-v) and the same output
contract, one line `<seconds>\t<KiB processed>` on stdout, so that
qa/workunits/erasure-code/bench.sh can drive this tool unchanged.

The codec runs on the card unless `run` is given a device (or the
profile a `device` parameter, `-P device=cpu`); with no CUDA and no
device it raises.  The JAX tool's --plan-cache/--no-plan-cache and its
stderr `plan-cache:` line have no counterpart, since the port has no
plan cache; instead, after the timing line, stderr carries the run's
kernel launches: `launches: gf_matmul_spec=N gf_matmul_gen=N
crc32c_blocks=N xor_sched_regions=N xor_sched_gf=N`.  Every technique the
registry builds runs here, the bitmatrix ones (`-P technique=liberation`,
`blaum_roth`, `liber8tion`) on the `xor_sched` kernel.
"""


from __future__ import annotations

import argparse
import itertools
import random
import sys
import time
from typing import Dict, List

from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ops import crc_kernels, gf_kernels, xor_kernels

KERNELS = {"gf_matmul_spec": gf_kernels.gf_matmul_spec,
           "gf_matmul_gen": gf_kernels.gf_matmul_gen,
           "crc32c_blocks": crc_kernels.crc32c_blocks,
           "xor_sched_regions": xor_kernels.xor_sched_regions,
           "xor_sched_gf": xor_kernels.xor_sched_gf}


def parse_args(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="ceph_erasure_code_benchmark")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-s", "--size", type=int, default=1024 * 1024,
                   help="size of the buffer to be encoded")
    p.add_argument("-i", "--iterations", type=int, default=1,
                   help="number of encode/decode runs")
    p.add_argument("-p", "--plugin", default="jerasure",
                   help="erasure code plugin name")
    p.add_argument("-w", "--workload", default="encode",
                   choices=("encode", "decode"))
    p.add_argument("-e", "--erasures", type=int, default=1,
                   help="number of erasures when decoding")
    p.add_argument("--erased", type=int, action="append", default=[],
                   help="erased chunk (repeat)")
    p.add_argument("-E", "--erasures-generation", default="random",
                   choices=("random", "exhaustive"), dest="erasures_generation")
    p.add_argument("-P", "--parameter", action="append", default=[],
                   help="add a profile parameter key=value")
    return p.parse_args(argv)


def build_profile(args: argparse.Namespace, device=None) -> Dict[str, str]:
    profile: Dict[str, str] = {"plugin": args.plugin}
    for param in args.parameter:
        if "=" not in param:
            raise SystemExit(f"parameter {param!r} is not in key=value form")
        key, val = param.split("=", 1)
        profile[key] = val
    if device is not None:
        profile.setdefault("device", str(device))
    return profile


def display_chunks(chunks, chunk_count: int) -> None:
    out = "chunks "
    for chunk in range(chunk_count):
        out += f"({chunk})  " if chunk not in chunks else f" {chunk}   "
    print(out + "(X) is an erased chunk")


def _decode_and_check(codec, all_chunks, chunks) -> None:
    want = {c for c in range(codec.get_chunk_count()) if c not in chunks}
    decoded = codec.decode(want, chunks)
    for c in want:
        if decoded[c] != all_chunks[c]:
            raise SystemExit(
                f"chunk {c} content and recovered content are different")


def run(argv: List[str], device=None) -> int:
    args = parse_args(argv)
    before = {name: fn.launches for name, fn in KERNELS.items()}
    try:
        return _run_timed(args, device)
    finally:
        print("launches: " + " ".join(
            f"{name}={fn.launches - before[name]}"
            for name, fn in KERNELS.items()), file=sys.stderr)


def _run_timed(args: argparse.Namespace, device=None) -> int:
    profile = build_profile(args, device)
    codec = ErasureCodePluginRegistry.instance().factory(
        args.plugin, profile)
    n = codec.get_chunk_count()
    data = b"X" * args.size
    want_all = set(range(n))

    if args.workload == "encode":
        begin = time.perf_counter()
        for _ in range(args.iterations):
            codec.encode(want_all, data)
        elapsed = time.perf_counter() - begin
    else:
        encoded = codec.encode(want_all, data)
        full = dict(encoded)
        if args.erased:
            for e in args.erased:
                encoded.pop(e, None)
            display_chunks(encoded, n)
        begin = time.perf_counter()
        for _ in range(args.iterations):
            if args.erasures_generation == "exhaustive":
                for erased in itertools.combinations(
                        sorted(encoded), args.erasures):
                    chunks = {c: b for c, b in encoded.items()
                              if c not in erased}
                    if args.verbose:
                        display_chunks(chunks, n)
                    _decode_and_check(codec, full, chunks)
            elif args.erased:
                _decode_and_check(codec, full, encoded)
            else:
                chunks = dict(encoded)
                for _j in range(args.erasures):
                    erasure = random.choice(sorted(chunks))
                    del chunks[erasure]
                _decode_and_check(codec, encoded, chunks)
        elapsed = time.perf_counter() - begin

    print(f"{elapsed:.6f}\t{args.iterations * (args.size // 1024)}")
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
