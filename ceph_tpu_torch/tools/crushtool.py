"""crushtool parity CLI (port of ceph_tpu/tools/crushtool.py).

Reference: the reference's src/tools/crushtool.cc + CrushTester
(src/crush/CrushTester.cc): compile (-c) / decompile (-d) the text
crushmap format, `--build` simple hierarchies, and `--test` bulk
placement simulation (--num-rep, --min-x/--max-x, --rule,
--show-mappings, --show-utilization, --show-statistics,
--show-bad-mappings, --weight, --compare) with the same output shapes
(`CRUSH rule R x X [..]`, `device D: stored : N expected : E`), byte for
byte what the JAX package's tool prints.

Deviations: the compiled container is JSON (the reference uses its C wire
encoding); `--test` places every input through the CUDA placement kernel
(ceph_tpu_torch.crush.kernel.compile_rule), on the card unless `run` is
given `device="cpu"`, and uses the exact host mapper only for a rule or
map the kernel does not take (compile_rule raises NotImplementedError).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np

from ceph_tpu_torch.crush import compiler as crush_compiler
from ceph_tpu_torch.crush import kernel as crush_kernel
from ceph_tpu_torch.crush import mapper as crush_mapper
from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE, CrushMap
from ceph_tpu_torch.crush.serialize import from_json, to_json


def load_map(path: str) -> CrushMap:
    with open(path) as f:
        content = f.read()
    stripped = content.lstrip()
    if stripped.startswith("{"):
        return from_json(json.loads(content))
    return crush_compiler.compile_text(content)


def run_test(cmap: CrushMap, args: argparse.Namespace, device=None) -> int:
    rules = ([args.rule] if args.rule is not None
             else list(range(len(cmap.rules))))
    weights = cmap.full_weight_vector()
    for dev, w in args.weight or []:
        if dev < len(weights):
            weights[dev] = int(float(w) * 0x10000)

    compare_lines: Optional[List[str]] = None
    if args.compare:
        with open(args.compare) as f:
            compare_lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    mismatches = 0
    compare_idx = 0

    xs = np.arange(args.min_x, args.max_x + 1, dtype=np.int64)
    total_weight = sum(
        weights[d] if d < len(weights) else 0
        for d in range(cmap.max_devices)) or 1

    for ruleno in rules:
        if ruleno >= len(cmap.rules):
            print(f"rule {ruleno} dne", file=sys.stderr)
            return 1
        rule = cmap.rules[ruleno]
        num_rep = args.num_rep
        print(f"rule {ruleno} ({rule.name}), x = {args.min_x}..{args.max_x},"
              f" numrep = {num_rep}..{num_rep}", file=sys.stderr)

        results = _bulk_do_rule(cmap, ruleno, xs, num_rep, weights, device)

        # counts over the whole (N, num_rep) result at once; the lines of
        # single inputs are formatted row by row, as the reference does
        valid = results != CRUSH_ITEM_NONE
        devs = results[valid & (results >= 0)
                       & (results < cmap.max_devices)].astype(np.int64)
        per_device = np.bincount(devs, minlength=cmap.max_devices)
        placed = int(devs.size)
        sizes: Dict[int, int] = {
            int(size): int(count) for size, count in enumerate(
                np.bincount(valid.sum(axis=1), minlength=1)) if count}
        if (args.show_mappings or args.show_bad_mappings
                or compare_lines is not None):
            for row_i, x in enumerate(xs):
                out = [int(v) for v in results[row_i]
                       if int(v) != CRUSH_ITEM_NONE]
                line = f"CRUSH rule {ruleno} x {int(x)} {_fmt_vec(out)}"
                if args.show_mappings:
                    print(line)
                if compare_lines is not None:
                    if (compare_idx >= len(compare_lines)
                            or compare_lines[compare_idx] != line):
                        mismatches += 1
                    compare_idx += 1
                if args.show_bad_mappings and len(out) != num_rep:
                    print(f"bad mapping rule {ruleno} x {int(x)} num_rep"
                          f" {num_rep} result {_fmt_vec(out)}",
                          file=sys.stderr)

        if args.show_utilization:
            for dev in range(cmap.max_devices):
                w = weights[dev] if dev < len(weights) else 0
                expected = placed * w / total_weight
                print(f"  device {dev}:\t\t stored : {per_device[dev]}"
                      f"\t expected : {expected:.6g}")
        if args.show_statistics:
            for size, count in sorted(sizes.items()):
                print(f"rule {ruleno} ({rule.name}) num_rep {num_rep}"
                      f" result size == {size}:\t{count}/{len(xs)}")

    if compare_lines is not None:
        # reference lines never reached are mismatches too
        mismatches += max(0, len(compare_lines) - compare_idx)
        print(f"compared {max(compare_idx, len(compare_lines))} mappings,"
              f" {mismatches} mismatches")
        return 1 if mismatches else 0
    return 0


def _fmt_vec(out: List[int]) -> str:
    return "[" + ",".join(str(v) for v in out) + "]"


def _bulk_do_rule(cmap: CrushMap, ruleno: int, xs: np.ndarray,
                  num_rep: int, weights: List[int], device=None) -> np.ndarray:
    """All xs through one rule: the placement kernel when the rule and map
    compile to it, the exact host mapper otherwise.  No CUDA and no
    device raises; so does a kernel that fails to build or launch."""
    try:
        run = crush_kernel.compile_rule(cmap, ruleno, result_max=num_rep,
                                        weight=weights, device=device)
    except NotImplementedError:
        rows = np.full((len(xs), num_rep), CRUSH_ITEM_NONE, dtype=np.int64)
        for i, x in enumerate(xs):
            out = crush_mapper.crush_do_rule(
                cmap, ruleno, int(x), num_rep, weights)
            for j, v in enumerate(out[:num_rep]):
                rows[i, j] = v
        return rows
    return run(xs)


def run(argv: List[str], device=None) -> int:
    p = argparse.ArgumentParser(prog="crushtool")
    p.add_argument("-c", "--compile", dest="compile_src", metavar="SRC",
                   help="compile text SRC to a map container")
    p.add_argument("-d", "--decompile", dest="decompile_src", metavar="MAP",
                   help="decompile MAP to text")
    p.add_argument("-o", "--outfn", help="output file")
    p.add_argument("-i", "--infn", help="input map for --test")
    p.add_argument("--test", action="store_true")
    p.add_argument("--num-rep", type=int, default=1, dest="num_rep")
    p.add_argument("--min-x", type=int, default=0, dest="min_x")
    p.add_argument("--max-x", type=int, default=1023, dest="max_x")
    p.add_argument("--rule", type=int, default=None)
    p.add_argument("--show-mappings", action="store_true")
    p.add_argument("--show-utilization", action="store_true")
    p.add_argument("--show-statistics", action="store_true")
    p.add_argument("--show-bad-mappings", action="store_true")
    p.add_argument("--weight", nargs=2, action="append", metavar=("DEV", "W"),
                   type=str, default=[])
    p.add_argument("--compare", metavar="FILE",
                   help="compare mappings with FILE (from --show-mappings)")
    args = p.parse_args(argv)
    args.weight = [(int(d), w) for d, w in args.weight]

    if args.compile_src:
        cmap = load_map(args.compile_src)
        out = json.dumps(to_json(cmap), indent=1)
        _write(args.outfn or "crushmap", out)
        return 0
    if args.decompile_src:
        cmap = load_map(args.decompile_src)
        _write(args.outfn, crush_compiler.decompile(cmap))
        return 0
    if args.test:
        if not args.infn:
            print("--test requires -i <map>", file=sys.stderr)
            return 1
        return run_test(load_map(args.infn), args, device)
    p.print_usage(sys.stderr)
    return 1


def _write(path: Optional[str], content: str) -> None:
    if path:
        with open(path, "w") as f:
            f.write(content)
    else:
        sys.stdout.write(content)


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
