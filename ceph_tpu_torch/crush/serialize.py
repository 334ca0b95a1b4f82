"""CrushMap <-> JSON container (a copy of ceph_tpu/crush/serialize.py).

The reference's compiled crushmap is its C wire encoding
(crush/CrushWrapper encode/decode); this framework's compiled container
is JSON with the same information content: tunables, devices (+classes),
types, buckets, rules, choose_args, and the class shadow-bucket table.
The text format (ceph_tpu_torch.crush.compiler) is the interchange surface with
reference tooling.
"""

from __future__ import annotations

from typing import Any, Dict

from ceph_tpu_torch.crush.map import Bucket, ChooseArg, CrushMap, Rule, RuleStep

TUNABLE_FIELDS = (
    "choose_local_tries", "choose_local_fallback_tries",
    "choose_total_tries", "chooseleaf_descend_once", "chooseleaf_vary_r",
    "chooseleaf_stable", "straw_calc_version", "allowed_bucket_algs",
)


def to_json(cmap: CrushMap) -> Dict[str, Any]:
    return {
        "tunables": {name: getattr(cmap, name) for name in TUNABLE_FIELDS},
        "devices": [
            {"id": dev_id, "name": cmap.device_names[dev_id],
             **({"class": cmap.device_classes[dev_id]}
                if dev_id in cmap.device_classes else {})}
            for dev_id in sorted(cmap.device_names)],
        "max_devices": cmap.max_devices,
        "types": {str(tid): name for tid, name in cmap.types.items()},
        "buckets": [
            {"id": b.id, "name": cmap.bucket_names[b.id], "type": b.type,
             "alg": b.alg, "hash": b.hash,
             "items": list(b.items), "weights": list(b.weights)}
            for b in cmap.buckets.values()],
        "rules": [
            {"name": r.name, "type": r.rule_type, "min_size": r.min_size,
             "max_size": r.max_size,
             "steps": [[s.op, s.arg1, s.arg2] for s in r.steps]}
            for r in cmap.rules],
        "class_bucket": [
            {"bucket": bid, "class": cls, "shadow": sid}
            for (bid, cls), sid in sorted(cmap.class_bucket.items())],
        "choose_args": {
            str(bid): {"weight_set": ca.weight_set, "ids": ca.ids}
            for bid, ca in cmap.choose_args.items()},
        "choose_args_maps": {
            name: {str(bid): {"weight_set": ca.weight_set, "ids": ca.ids}
                   for bid, ca in args.items()}
            for name, args in cmap.choose_args_maps.items()},
    }


def from_json(data: Dict[str, Any]) -> CrushMap:
    cmap = CrushMap()
    for name, val in data.get("tunables", {}).items():
        if name in TUNABLE_FIELDS:
            setattr(cmap, name, int(val))
    cmap.types = {int(tid): name
                  for tid, name in data.get("types", {}).items()}
    for dev in data.get("devices", []):
        cmap.add_device(int(dev["id"]), dev["name"],
                        device_class=dev.get("class", ""))
    cmap.max_devices = max(cmap.max_devices,
                           int(data.get("max_devices", 0)))
    for bj in data.get("buckets", []):
        b = Bucket(id=int(bj["id"]), type=int(bj["type"]),
                   alg=int(bj["alg"]), hash=int(bj["hash"]),
                   items=[int(i) for i in bj["items"]],
                   weights=[int(w) for w in bj["weights"]])
        cmap.buckets[b.id] = b
        cmap.bucket_names[b.id] = bj["name"]
    for rj in data.get("rules", []):
        cmap.rules.append(Rule(
            rj["name"],
            [RuleStep(*[int(v) for v in s]) for s in rj["steps"]],
            rule_type=int(rj["type"]), min_size=int(rj["min_size"]),
            max_size=int(rj["max_size"])))
    for entry in data.get("class_bucket", []):
        cmap.class_bucket[(int(entry["bucket"]), entry["class"])] = int(
            entry["shadow"])
    for bid, ca in data.get("choose_args", {}).items():
        cmap.choose_args[int(bid)] = ChooseArg(
            weight_set=ca.get("weight_set"), ids=ca.get("ids"))
    for name, args in data.get("choose_args_maps", {}).items():
        cmap.choose_args_maps[name] = {
            int(bid): ChooseArg(weight_set=ca.get("weight_set"),
                                ids=ca.get("ids"))
            for bid, ca in args.items()}
    return cmap
