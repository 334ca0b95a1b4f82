"""CRUSH map text compiler / decompiler (port of ceph_tpu/crush/compiler.py).

Reference parity: CrushCompiler
(the reference's src/crush/CrushCompiler.cc) — the `crushtool -c/-d` text
format: tunable lines, `device N osd.N [class c]`, `type N name`, bucket
blocks (id/alg/hash/item lines), rule blocks (take/choose/chooseleaf/
emit/set_* steps, `take <root> class <c>` resolved through the per-class
shadow hierarchy).

Deviation: the reference's *binary* crushmap is its C wire encoding; this
framework's compiled container is JSON (ceph_tpu_torch.crush.serialize) — the
text format is the interchange surface.
"""

from __future__ import annotations

import re
import shlex
from typing import Dict, List, Optional

from ceph_tpu_torch.crush.map import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE,
    CrushMap,
    Rule,
    RuleStep,
)

ALG_NAMES = {CRUSH_BUCKET_UNIFORM: "uniform", CRUSH_BUCKET_LIST: "list",
             CRUSH_BUCKET_TREE: "tree", CRUSH_BUCKET_STRAW: "straw",
             CRUSH_BUCKET_STRAW2: "straw2"}
ALG_IDS = {v: k for k, v in ALG_NAMES.items()}

TUNABLES = ("choose_local_tries", "choose_local_fallback_tries",
            "choose_total_tries", "chooseleaf_descend_once",
            "chooseleaf_vary_r", "chooseleaf_stable", "straw_calc_version",
            "allowed_bucket_algs")

_SET_STEPS = {
    "set_choose_tries": CRUSH_RULE_SET_CHOOSE_TRIES,
    "set_chooseleaf_tries": CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    "set_choose_local_tries": CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    "set_choose_local_fallback_tries":
        CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    "set_chooseleaf_vary_r": CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    "set_chooseleaf_stable": CRUSH_RULE_SET_CHOOSELEAF_STABLE,
}
_SET_NAMES = {v: k for k, v in _SET_STEPS.items()}

RULE_TYPE_NAMES = {1: "replicated", 3: "erasure"}


class CompileError(ValueError):
    pass


def compile_text(text: str) -> CrushMap:
    """Parse crushtool text format into a CrushMap."""
    cmap = CrushMap()
    cmap.types = {}
    lines: List[List[str]] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if line:
            lines.append(shlex.split(line))

    i = 0
    pending_rule_ids: Dict[int, Rule] = {}
    while i < len(lines):
        tok = lines[i]
        head = tok[0]
        if head == "tunable":
            if len(tok) != 3 or tok[1] not in TUNABLES:
                raise CompileError(f"bad tunable line: {' '.join(tok)}")
            setattr(cmap, tok[1], int(tok[2]))
            i += 1
        elif head == "device":
            # device N osd.N [class c]
            dev_id = int(tok[1])
            name = tok[2]
            cls = ""
            if len(tok) >= 5 and tok[3] == "class":
                cls = tok[4]
            if not name.startswith("device"):  # "deviceN" = deleted marker
                cmap.add_device(dev_id, name, device_class=cls)
            else:
                cmap.max_devices = max(cmap.max_devices, dev_id + 1)
            i += 1
        elif head == "type":
            cmap.types[int(tok[1])] = tok[2]
            i += 1
        elif head == "rule":
            i = _parse_rule(cmap, lines, i)
        elif head == "choose_args":
            i = _parse_choose_args(cmap, lines, i)
        elif len(tok) >= 2 and tok[-1] == "{":
            i = _parse_bucket(cmap, lines, i)
        else:
            raise CompileError(f"unparsable line: {' '.join(tok)}")
    return cmap


def _parse_bucket(cmap: CrushMap, lines: List[List[str]], i: int) -> int:
    head = lines[i]
    type_name, name = head[0], head[1]
    try:
        type_id = cmap.type_id(type_name)
    except KeyError:
        raise CompileError(f"unknown bucket type {type_name!r}")
    i += 1
    bucket_id: Optional[int] = None
    class_ids: Dict[str, int] = {}
    alg = CRUSH_BUCKET_STRAW2
    hash_ = 0
    items: List[tuple] = []
    while i < len(lines) and lines[i][0] != "}":
        tok = lines[i]
        if tok[0] == "id":
            if len(tok) >= 4 and tok[2] == "class":
                class_ids[tok[3]] = int(tok[1])
            else:
                bucket_id = int(tok[1])
        elif tok[0] == "alg":
            if tok[1] not in ALG_IDS:
                raise CompileError(f"unknown bucket alg {tok[1]!r}")
            alg = ALG_IDS[tok[1]]
        elif tok[0] == "hash":
            hash_ = int(tok[1])
        elif tok[0] == "weight":
            pass  # informational
        elif tok[0] == "item":
            item_name = tok[1]
            weight = 0x10000
            for j in range(2, len(tok) - 1, 2):
                if tok[j] == "weight":
                    weight = int(round(float(tok[j + 1]) * 0x10000))
            items.append((item_name, weight))
        else:
            raise CompileError(
                f"unparsable bucket line: {' '.join(tok)}")
        i += 1
    if i >= len(lines):
        raise CompileError(f"unterminated bucket {name!r}")
    b = cmap.add_bucket(bucket_id, type_id, name, alg=alg)
    b.hash = hash_
    for item_name, weight in items:
        b.add_item(cmap.name_to_item(item_name), weight)
    # class ids pre-declare shadow bucket ids; recorded for decompile parity
    for cls, cid in class_ids.items():
        cmap.class_bucket[(b.id, cls)] = cmap.class_bucket.get(
            (b.id, cls), cid)
    return i + 1


def _parse_choose_args(cmap: CrushMap, lines: List[List[str]], i: int) -> int:
    """`choose_args <name> { { bucket_id -N weight_set [...] ids [...] } }`
    (CrushCompiler::parse_choose_args / decompile_choose_args layout)."""
    from ceph_tpu_torch.crush.map import ChooseArg

    name = lines[i][1]
    i += 1
    args: Dict[int, "ChooseArg"] = {}
    while i < len(lines) and lines[i][0] != "}":
        if lines[i] != ["{"]:
            raise CompileError(
                f"expected '{{' in choose_args, got {' '.join(lines[i])}")
        i += 1
        bucket_id: Optional[int] = None
        weight_set: Optional[List[List[int]]] = None
        ids: Optional[List[int]] = None
        while i < len(lines) and lines[i][0] != "}":
            tok = lines[i]
            if tok[0] == "bucket_id":
                bucket_id = int(tok[1])
            elif tok[0] == "weight_set":
                weight_set = []
                i += 1
                while i < len(lines) and lines[i][0] != "]":
                    row = lines[i]
                    if row[0] != "[" or row[-1] != "]":
                        raise CompileError(
                            f"bad weight_set row: {' '.join(row)}")
                    weight_set.append([
                        int(round(float(w) * 0x10000)) for w in row[1:-1]])
                    i += 1
                if i >= len(lines):
                    raise CompileError("unterminated weight_set")
            elif tok[0] == "ids":
                if tok[1] != "[" or tok[-1] != "]":
                    raise CompileError(f"bad ids line: {' '.join(tok)}")
                ids = [int(v) for v in tok[2:-1]]
            else:
                raise CompileError(
                    f"unparsable choose_args line: {' '.join(tok)}")
            i += 1
        if i >= len(lines):
            raise CompileError("unterminated choose_args entry")
        i += 1  # closing } of the entry
        if bucket_id is None:
            raise CompileError("choose_args entry without bucket_id")
        args[bucket_id] = ChooseArg(weight_set=weight_set, ids=ids)
    if i >= len(lines):
        raise CompileError(f"unterminated choose_args {name!r}")
    cmap.choose_args_maps[name] = args
    if not cmap.choose_args:  # first/only map also drives the mapper
        cmap.choose_args = args
    return i + 1


def _parse_rule(cmap: CrushMap, lines: List[List[str]], i: int) -> int:
    head = lines[i]
    name = head[1] if len(head) > 2 else head[1].rstrip("{")
    i += 1
    rule_type = 1
    min_size, max_size = 1, 10
    steps: List[RuleStep] = []
    while i < len(lines) and lines[i][0] != "}":
        tok = lines[i]
        if tok[0] == "id" or tok[0] == "ruleset":
            pass  # rule position is its id in this model
        elif tok[0] == "type":
            names = {v: k for k, v in RULE_TYPE_NAMES.items()}
            if tok[1] not in names:
                raise CompileError(f"unknown rule type {tok[1]!r}")
            rule_type = names[tok[1]]
        elif tok[0] == "min_size":
            min_size = int(tok[1])
        elif tok[0] == "max_size":
            max_size = int(tok[1])
        elif tok[0] == "step":
            steps.append(_parse_step(cmap, tok[1:]))
        else:
            raise CompileError(f"unparsable rule line: {' '.join(tok)}")
        i += 1
    if i >= len(lines):
        raise CompileError(f"unterminated rule {name!r}")
    cmap.add_rule(Rule(name, steps, rule_type=rule_type,
                       min_size=min_size, max_size=max_size))
    return i + 1


def _parse_step(cmap: CrushMap, tok: List[str]) -> RuleStep:
    op = tok[0]
    if op == "take":
        item = cmap.name_to_item(tok[1])
        if len(tok) >= 4 and tok[2] == "class":
            item = cmap.class_shadow_id(item, tok[3])
        return RuleStep(CRUSH_RULE_TAKE, item)
    if op == "emit":
        return RuleStep(CRUSH_RULE_EMIT)
    if op in _SET_STEPS:
        return RuleStep(_SET_STEPS[op], int(tok[1]))
    if op in ("choose", "chooseleaf"):
        mode = tok[1]  # firstn | indep
        num = int(tok[2])
        if len(tok) < 5 or tok[3] != "type":
            raise CompileError(f"bad step: step {' '.join(tok)}")
        type_id = cmap.type_id(tok[4])
        ops = {("choose", "firstn"): CRUSH_RULE_CHOOSE_FIRSTN,
               ("choose", "indep"): CRUSH_RULE_CHOOSE_INDEP,
               ("chooseleaf", "firstn"): CRUSH_RULE_CHOOSELEAF_FIRSTN,
               ("chooseleaf", "indep"): CRUSH_RULE_CHOOSELEAF_INDEP}
        if (op, mode) not in ops:
            raise CompileError(f"bad choose mode {mode!r}")
        return RuleStep(ops[(op, mode)], num, type_id)
    raise CompileError(f"unknown step op {op!r}")


def decompile(cmap: CrushMap) -> str:
    """Emit crushtool text format (CrushCompiler::decompile layout)."""
    out: List[str] = ["# begin crush map"]
    for tun in TUNABLES:
        default = {"choose_total_tries": 50, "chooseleaf_descend_once": 1,
                   "chooseleaf_vary_r": 1, "chooseleaf_stable": 1,
                   "straw_calc_version": 1}.get(tun)
        val = getattr(cmap, tun)
        if tun == "allowed_bucket_algs":
            continue  # emitted only when non-default in the reference
        if val != default or tun in ("choose_local_tries",
                                     "choose_local_fallback_tries",
                                     "choose_total_tries"):
            out.append(f"tunable {tun} {val}")

    out.append("\n# devices")
    for dev_id in range(cmap.max_devices):
        name = cmap.device_names.get(dev_id, f"device{dev_id}")
        cls = cmap.device_classes.get(dev_id)
        line = f"device {dev_id} {name}"
        if cls:
            line += f" class {cls}"
        out.append(line)

    out.append("\n# types")
    for tid in sorted(cmap.types):
        out.append(f"type {tid} {cmap.types[tid]}")

    out.append("\n# buckets")
    shadow_ids = set(cmap.class_bucket.values())
    # emit children before parents (reference emits leaves-first)
    emitted = set()

    def emit_bucket(bid: int) -> None:
        if bid in emitted or bid in shadow_ids:
            return
        b = cmap.buckets[bid]
        for item in b.items:
            if item < 0:
                emit_bucket(item)
        emitted.add(bid)
        type_name = cmap.types.get(b.type, str(b.type))
        out.append(f"{type_name} {cmap.bucket_names[bid]} {{")
        out.append(f"\tid {bid}\t\t# do not change unnecessarily")
        for (obid, cls), sid in sorted(cmap.class_bucket.items()):
            if obid == bid:
                out.append(f"\tid {sid} class {cls}"
                           "\t\t# do not change unnecessarily")
        out.append(f"\t# weight {b.weight / 0x10000:.5f}")
        out.append(f"\talg {ALG_NAMES[b.alg]}")
        out.append(f"\thash {b.hash}\t# rjenkins1")
        for item, weight in zip(b.items, b.weights):
            iname = (cmap.device_names.get(item, f"osd.{item}")
                     if item >= 0 else cmap.bucket_names[item])
            out.append(f"\titem {iname} weight {weight / 0x10000:.5f}")
        out.append("}")

    for bid in sorted(cmap.buckets, reverse=True):
        emit_bucket(bid)

    out.append("\n# rules")
    shadow_to_class = {sid: (obid, cls)
                       for (obid, cls), sid in cmap.class_bucket.items()}
    for ruleno, rule in enumerate(cmap.rules):
        out.append(f"rule {rule.name} {{")
        out.append(f"\tid {ruleno}")
        out.append(f"\ttype {RULE_TYPE_NAMES.get(rule.rule_type, 'replicated')}")
        out.append(f"\tmin_size {rule.min_size}")
        out.append(f"\tmax_size {rule.max_size}")
        for step in rule.steps:
            if step.op == CRUSH_RULE_TAKE:
                if step.arg1 in shadow_to_class:
                    obid, cls = shadow_to_class[step.arg1]
                    out.append(f"\tstep take {cmap.bucket_names[obid]}"
                               f" class {cls}")
                else:
                    out.append(f"\tstep take {cmap.bucket_names[step.arg1]}")
            elif step.op == CRUSH_RULE_EMIT:
                out.append("\tstep emit")
            elif step.op in _SET_NAMES:
                out.append(f"\tstep {_SET_NAMES[step.op]} {step.arg1}")
            else:
                names = {CRUSH_RULE_CHOOSE_FIRSTN: ("choose", "firstn"),
                         CRUSH_RULE_CHOOSE_INDEP: ("choose", "indep"),
                         CRUSH_RULE_CHOOSELEAF_FIRSTN:
                             ("chooseleaf", "firstn"),
                         CRUSH_RULE_CHOOSELEAF_INDEP:
                             ("chooseleaf", "indep")}
                op, mode = names[step.op]
                type_name = cmap.types.get(step.arg2, str(step.arg2))
                out.append(f"\tstep {op} {mode} {step.arg1}"
                           f" type {type_name}")
        out.append("}")

    if cmap.choose_args_maps or cmap.choose_args:
        out.append("\n# choose_args")
        maps = cmap.choose_args_maps or {"0": cmap.choose_args}
        for name, args in maps.items():
            out.append(f"choose_args {name} {{")
            for bid, ca in sorted(args.items(), reverse=True):
                out.append("  {")
                out.append(f"    bucket_id {bid}")
                if ca.weight_set:
                    out.append("    weight_set [")
                    for row in ca.weight_set:
                        vals = " ".join(f"{w / 0x10000:.5f}" for w in row)
                        out.append(f"      [ {vals} ]")
                    out.append("    ]")
                if ca.ids:
                    out.append("    ids [ " +
                               " ".join(str(v) for v in ca.ids) + " ]")
                out.append("  }")
            out.append("}")

    out.append("\n# end crush map")
    return "\n".join(out) + "\n"
