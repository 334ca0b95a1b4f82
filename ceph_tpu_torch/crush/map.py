"""CRUSH map data model and constructors (a copy of ceph_tpu/crush/map.py).

Reference: the C data model in the reference's src/crush/crush.h (buckets,
rules, tunables), its map construction code and its CrushWrapper façade
(src/crush/CrushWrapper.h).  This is a clean host-side
model — the placement kernels (mapper.py exact host path, kernel.py batched
CUDA path) both consume it.

Conventions preserved from the reference:
- devices have ids >= 0; buckets have ids < 0 (bucket b is buckets[-1-id]);
- weights are 16.16 fixed point (0x10000 == 1.0);
- rule steps are (op, arg1, arg2) triples;
- tunables default to the modern profile (choose_total_tries=50,
  chooseleaf_descend_once/vary_r/stable=1, straw_calc_version=1 — the
  "jewel" defaults in crush.h).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

# bucket algorithms (crush.h crush_algorithm)
CRUSH_BUCKET_UNIFORM = 1
CRUSH_BUCKET_LIST = 2
CRUSH_BUCKET_TREE = 3
CRUSH_BUCKET_STRAW = 4
CRUSH_BUCKET_STRAW2 = 5

CRUSH_HASH_RJENKINS1 = 0

# rule step ops (crush.h crush_opcodes)
CRUSH_RULE_NOOP = 0
CRUSH_RULE_TAKE = 1
CRUSH_RULE_CHOOSE_FIRSTN = 2
CRUSH_RULE_CHOOSE_INDEP = 3
CRUSH_RULE_EMIT = 4
CRUSH_RULE_CHOOSELEAF_FIRSTN = 6
CRUSH_RULE_CHOOSELEAF_INDEP = 7
CRUSH_RULE_SET_CHOOSE_TRIES = 8
CRUSH_RULE_SET_CHOOSELEAF_TRIES = 9
CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES = 10
CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
CRUSH_RULE_SET_CHOOSELEAF_VARY_R = 12
CRUSH_RULE_SET_CHOOSELEAF_STABLE = 13

CRUSH_ITEM_UNDEF = -0x7FFFFFFF
CRUSH_ITEM_NONE = -0x80000000


@dataclass
class Bucket:
    id: int  # < 0
    type: int  # type id (e.g. host=1, rack=3, root=10)
    alg: int = CRUSH_BUCKET_STRAW2
    hash: int = CRUSH_HASH_RJENKINS1
    items: List[int] = field(default_factory=list)
    weights: List[int] = field(default_factory=list)  # 16.16 fixed per item

    @property
    def size(self) -> int:
        return len(self.items)

    @property
    def weight(self) -> int:
        return sum(self.weights)

    def add_item(self, item: int, weight: int) -> None:
        self.items.append(item)
        self.weights.append(weight)


@dataclass
class RuleStep:
    op: int
    arg1: int = 0
    arg2: int = 0


@dataclass
class Rule:
    name: str
    steps: List[RuleStep]
    rule_type: int = 1  # pg_pool_t TYPE_REPLICATED=1 / TYPE_ERASURE=3
    min_size: int = 1
    max_size: int = 10


@dataclass
class ChooseArg:
    """Per-bucket weight_set/ids overrides (balancer; mapper.c:309-326)."""

    weight_set: Optional[List[List[int]]] = None  # positions x items
    ids: Optional[List[int]] = None


class CrushMap:
    def __init__(self) -> None:
        self.buckets: Dict[int, Bucket] = {}  # by id (< 0)
        self.rules: List[Rule] = []
        self.types: Dict[int, str] = {0: "osd", 1: "host", 2: "chassis",
                                      3: "rack", 4: "row", 5: "pdu", 6: "pod",
                                      7: "room", 8: "datacenter", 9: "zone",
                                      10: "region", 11: "root"}
        self.bucket_names: Dict[int, str] = {}
        self.device_names: Dict[int, str] = {}
        self.device_classes: Dict[int, str] = {}
        self.max_devices = 0
        self.choose_args: Dict[int, ChooseArg] = {}
        # named choose_args maps (text format: `choose_args <name> {...}`);
        # the mapper consumes one map (self.choose_args) at a time
        self.choose_args_maps: Dict[str, Dict[int, ChooseArg]] = {}
        # tunables — modern/default profile (crush.h defaults as set by
        # CrushWrapper::set_tunables_default)
        self.choose_local_tries = 0
        self.choose_local_fallback_tries = 0
        self.choose_total_tries = 50
        self.chooseleaf_descend_once = 1
        self.chooseleaf_vary_r = 1
        self.chooseleaf_stable = 1
        self.straw_calc_version = 1
        self.allowed_bucket_algs = ((1 << CRUSH_BUCKET_UNIFORM) |
                                    (1 << CRUSH_BUCKET_LIST) |
                                    (1 << CRUSH_BUCKET_STRAW) |
                                    (1 << CRUSH_BUCKET_STRAW2))
        # per-class shadow hierarchies: (bucket_id, class) -> shadow id
        # (CrushWrapper::populate_classes / class_bucket)
        self.class_bucket: Dict[tuple, int] = {}

    # -- construction -----------------------------------------------------

    def add_bucket(self, bucket_id: Optional[int], type_: int, name: str,
                   alg: int = CRUSH_BUCKET_STRAW2) -> Bucket:
        if bucket_id is None:
            bucket_id = min(self.buckets, default=0) - 1
        assert bucket_id < 0 and bucket_id not in self.buckets
        b = Bucket(id=bucket_id, type=type_, alg=alg)
        self.buckets[bucket_id] = b
        self.bucket_names[bucket_id] = name
        return b

    def add_device(self, dev_id: int, name: Optional[str] = None,
                   device_class: str = "") -> None:
        self.max_devices = max(self.max_devices, dev_id + 1)
        self.device_names[dev_id] = name or f"osd.{dev_id}"
        if device_class:
            self.device_classes[dev_id] = device_class

    def name_to_item(self, name: str) -> int:
        for bid, n in self.bucket_names.items():
            if n == name:
                return bid
        for did, n in self.device_names.items():
            if n == name:
                return did
        raise KeyError(name)

    def type_id(self, name: str) -> int:
        for tid, n in self.types.items():
            if n == name:
                return tid
        raise KeyError(name)

    def bucket(self, item_id: int) -> Bucket:
        return self.buckets[item_id]

    def populate_class_shadow(self, device_class: str) -> None:
        """Build the per-class shadow hierarchy
        (CrushWrapper::populate_classes / device_class_clone): for every
        bucket that transitively contains devices of `device_class`, a
        shadow bucket holding only those devices (and shadow children).
        `step take <root> class <c>` then resolves to the shadow root.

        A text map may pre-declare shadow ids (`id -12 class hdd` lines);
        those ids are honored when the shadow bucket is materialized."""

        def clone(bid: int) -> Optional[int]:
            key = (bid, device_class)
            declared = self.class_bucket.get(key)
            if declared is not None and declared in self.buckets:
                return declared
            orig = self.buckets[bid]
            items: List[int] = []
            weights: List[int] = []
            for item, weight in zip(orig.items, orig.weights):
                if item >= 0:
                    if self.device_classes.get(item) == device_class:
                        items.append(item)
                        weights.append(weight)
                else:
                    shadow = clone(item)
                    if shadow is not None:
                        items.append(shadow)
                        weights.append(self.buckets[shadow].weight)
            if not items:
                return None
            sb = self.add_bucket(
                declared, orig.type,
                f"{self.bucket_names[bid]}~{device_class}", alg=orig.alg)
            sb.hash = orig.hash
            for item, weight in zip(items, weights):
                sb.add_item(item, weight)
            self.class_bucket[key] = sb.id
            return sb.id

        for bid in sorted(self.buckets, reverse=True):
            if "~" not in self.bucket_names[bid]:
                clone(bid)

    def class_shadow_id(self, bucket_id: int, device_class: str) -> int:
        key = (bucket_id, device_class)
        sid = self.class_bucket.get(key)
        if sid is None or sid not in self.buckets:
            # key may hold a pre-declared id from a text map whose shadow
            # bucket hasn't been materialized yet — build the hierarchy
            self.populate_class_shadow(device_class)
            sid = self.class_bucket.get(key)
        if sid is None or sid not in self.buckets:
            raise KeyError(
                f"bucket {self.bucket_names.get(bucket_id)} has no devices"
                f" of class {device_class}")
        return sid

    def add_rule(self, rule: Rule) -> int:
        self.rules.append(rule)
        return len(self.rules) - 1

    def find_rule_by_name(self, name: str) -> int:
        for i, r in enumerate(self.rules):
            if r.name == name:
                return i
        return -1

    def add_simple_rule(self, name: str, root_name: str, failure_domain: str,
                        device_class: str = "", mode: str = "firstn",
                        pool_type: str = "replicated") -> int:
        """CrushWrapper::add_simple_rule — TAKE root / CHOOSELEAF n domain /
        EMIT."""
        if self.find_rule_by_name(name) >= 0:
            return -17
        root = self.name_to_item(root_name)
        domain_type = self.type_id(failure_domain) if failure_domain else 0
        steps = [RuleStep(CRUSH_RULE_TAKE, root)]
        choose_op = (CRUSH_RULE_CHOOSELEAF_FIRSTN if mode == "firstn"
                     else CRUSH_RULE_CHOOSELEAF_INDEP)
        if domain_type == 0:
            choose_op = (CRUSH_RULE_CHOOSE_FIRSTN if mode == "firstn"
                         else CRUSH_RULE_CHOOSE_INDEP)
        steps.append(RuleStep(choose_op, 0, domain_type))
        steps.append(RuleStep(CRUSH_RULE_EMIT))
        rule_type = 3 if pool_type == "erasure" else 1
        return self.add_rule(Rule(name, steps, rule_type=rule_type))

    # -- weights ----------------------------------------------------------

    def full_weight_vector(self) -> List[int]:
        """Per-device 16.16 in/out weights — the OSDMap weight vector fed to
        crush_do_rule (all-in by default)."""
        return [0x10000] * self.max_devices


def build_flat_cluster(num_osds: int, osds_per_host: int = 4,
                       hosts_per_rack: int = 0,
                       osd_weight: float = 1.0) -> CrushMap:
    """Convenience constructor: root -> (racks ->) hosts -> osds, straw2.

    The shape CrushTester/osdmaptool exercise with --num-osds.
    """
    cm = CrushMap()
    w = int(osd_weight * 0x10000)
    num_hosts = -(-num_osds // osds_per_host)
    root = cm.add_bucket(-1, cm.type_id("root"), "default")
    rack = None
    racks = []
    if hosts_per_rack:
        num_racks = -(-num_hosts // hosts_per_rack)
        for r in range(num_racks):
            racks.append(cm.add_bucket(None, cm.type_id("rack"), f"rack{r}"))
            root.add_item(racks[-1].id, 0)
    dev = 0
    for h in range(num_hosts):
        host = cm.add_bucket(None, cm.type_id("host"), f"host{h}")
        for _ in range(osds_per_host):
            if dev >= num_osds:
                break
            cm.add_device(dev)
            host.add_item(dev, w)
            dev += 1
        if hosts_per_rack:
            rack = racks[h // hosts_per_rack]
            rack.add_item(host.id, host.weight)
        else:
            root.add_item(host.id, host.weight)
    if hosts_per_rack:
        for i, r in enumerate(racks):
            root.weights[i] = r.weight
    return cm
