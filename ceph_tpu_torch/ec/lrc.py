"""LRC, the layered locally-repairable erasure code (port of
ceph_tpu/ec/lrc.py).

The reference's lrc plugin (ErasureCodeLrc.{h,cc}):

- the code is a stack of layers, each a sub-erasure-code applied to the
  subset of chunk positions marked in its `chunks_map` string ('D' data,
  'c' coding, '_' not in this layer);
- the `k,m,l` shorthand generates mapping/layers/crush-steps (parse_kml):
  (k+m)/l groups, one global layer plus one local-parity layer per group,
  k+m+(k+m)/l chunks in all;
- encode applies layers top-down starting from the topmost layer that
  covers want_to_encode;
- decode walks layers bottom-up, each layer recovering what it can into
  `decoded` so that other layers can reuse it, to a fixpoint;
- minimum_to_decode picks the cheapest covering layers, then cascaded
  recovery (the 3-case algorithm);
- the crush rule comes from `crush-steps` (one choose step per locality
  level).

Layer codecs come from the registry (plugin=jerasure technique=reed_sol_van
by default, the port's ec_torch codec), each on the LRC's device: the
profile's `device` key is written into every layer's profile.  A layer
encodes through gf_matmul_spec (its registered generator) and recovers
through gf_matmul_gen.
"""


from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Set

from ceph_tpu_torch.crush.map import (CRUSH_RULE_CHOOSE_INDEP,
                                      CRUSH_RULE_CHOOSELEAF_INDEP,
                                      CRUSH_RULE_EMIT, CRUSH_RULE_TAKE, Rule,
                                      RuleStep)
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError

DEFAULT_KML = "-1"


@dataclass
class Layer:
    chunks_map: str
    profile: Dict[str, str] = field(default_factory=dict)
    data: List[int] = field(default_factory=list)
    coding: List[int] = field(default_factory=list)
    chunks: List[int] = field(default_factory=list)
    chunks_as_set: Set[int] = field(default_factory=set)
    erasure_code: Optional[ErasureCode] = None


@dataclass
class Step:
    op: str
    type: str
    n: int


def _parse_layers_json(text: str):
    """json_spirit tolerates trailing commas (the kml generator emits
    them); strip them before handing to the stdlib parser."""
    cleaned = re.sub(r",\s*([\]}])", r"\1", text)
    try:
        return json.loads(cleaned)
    except json.JSONDecodeError as e:
        raise ErasureCodeError(22, f"invalid layers JSON: {e}")


class ErasureCodeLrc(ErasureCode):
    def __init__(self) -> None:
        super().__init__()
        self.layers: List[Layer] = []
        self.chunk_count_ = 0
        self.data_chunk_count_ = 0
        self.rule_steps: List[Step] = [Step("chooseleaf", "host", 0)]
        self.device = None

    # -- profile parsing --------------------------------------------------

    def init(self, profile: Dict[str, str]) -> None:
        self.device = resolve_device(profile.get("device") or None)
        self._parse_kml(profile)
        self._parse_rule(profile)
        if "layers" not in profile:
            raise ErasureCodeError(
                22, "could not find 'layers' in profile")
        if "mapping" not in profile:
            raise ErasureCodeError(
                22, "the 'mapping' profile is required with 'layers'")
        description = _parse_layers_json(profile["layers"])
        if not isinstance(description, list):
            raise ErasureCodeError(22, "layers must be a JSON array")
        self._layers_parse(description)
        self._layers_init()
        self._layers_sanity_checks(profile)

        mapping = profile["mapping"]
        self.chunk_count_ = len(mapping)
        self.data_chunk_count_ = mapping.count("D")
        self.k = self.data_chunk_count_
        self.m = self.chunk_count_ - self.k
        super().init(profile)

    def _parse_kml(self, profile: Dict[str, str]) -> None:
        """k/m/l shorthand -> mapping + layers + crush-steps
        (ErasureCodeLrc.cc:293-397)."""
        vals = {}
        for name in ("k", "m", "l"):
            raw = profile.get(name, DEFAULT_KML) or DEFAULT_KML
            try:
                vals[name] = int(raw)
            except ValueError:
                raise ErasureCodeError(22, f"{name}={raw} is not an int")
        k, m, l = vals["k"], vals["m"], vals["l"]
        if k == -1 and m == -1 and l == -1:
            return
        if -1 in (k, m, l):
            raise ErasureCodeError(
                22, "all of k, m, l must be set or none of them")
        for generated in ("mapping", "layers", "crush-steps"):
            if generated in profile:
                raise ErasureCodeError(
                    22, f"the {generated} parameter cannot be set when"
                    " k, m, l are set")
        if l == 0 or (k + m) % l:
            raise ErasureCodeError(22, "k + m must be a multiple of l")
        groups = (k + m) // l
        if k % groups:
            raise ErasureCodeError(22, "k must be a multiple of (k + m) / l")
        if m % groups:
            raise ErasureCodeError(22, "m must be a multiple of (k + m) / l")

        kg, mg = k // groups, m // groups
        profile["mapping"] = ("D" * kg + "_" * mg + "_") * groups

        layers = [[("D" * kg + "c" * mg + "_") * groups, ""]]
        for i in range(groups):
            row = "".join(
                ("D" * l + "c") if i == j else "_" * (l + 1)
                for j in range(groups))
            layers.append([row, ""])
        profile["layers"] = json.dumps(layers)

        locality = profile.get("crush-locality", "")
        failure_domain = profile.get("crush-failure-domain", "host")
        if locality:
            self.rule_steps = [Step("choose", locality, groups),
                               Step("chooseleaf", failure_domain, l + 1)]
        elif failure_domain:
            self.rule_steps = [Step("chooseleaf", failure_domain, 0)]

    def _parse_rule(self, profile: Dict[str, str]) -> None:
        self.rule_root = profile.setdefault("crush-root", "default")
        self.rule_device_class = profile.setdefault("crush-device-class", "")
        if "crush-steps" in profile:
            steps = _parse_layers_json(profile["crush-steps"])
            if not isinstance(steps, list):
                raise ErasureCodeError(22, "crush-steps must be a JSON array")
            self.rule_steps = []
            for entry in steps:
                if (not isinstance(entry, list) or len(entry) != 3 or
                        not isinstance(entry[0], str) or
                        not isinstance(entry[1], str)):
                    raise ErasureCodeError(
                        22, f"crush-steps entry {entry!r} must be"
                        " [op, type, n]")
                self.rule_steps.append(Step(entry[0], entry[1], int(entry[2])))

    def _layers_parse(self, description) -> None:
        for position, layer_json in enumerate(description):
            if not isinstance(layer_json, list) or not layer_json:
                raise ErasureCodeError(
                    22, f"layers[{position}] must be a non-empty JSON array")
            chunks_map = layer_json[0]
            if not isinstance(chunks_map, str):
                raise ErasureCodeError(
                    22, f"layers[{position}][0] must be a string")
            layer = Layer(chunks_map=chunks_map)
            if len(layer_json) > 1:
                spec = layer_json[1]
                if isinstance(spec, str):
                    # "k=4 technique=..." style word list
                    for word in spec.split():
                        if "=" not in word:
                            raise ErasureCodeError(
                                22, f"expected key=value got {word!r}")
                        key, val = word.split("=", 1)
                        layer.profile[key] = val
                elif isinstance(spec, dict):
                    layer.profile.update(
                        {str(kk): str(vv) for kk, vv in spec.items()})
                else:
                    raise ErasureCodeError(
                        22, f"layers[{position}][1] must be a string or"
                        " object")
            self.layers.append(layer)

    def _layers_init(self) -> None:
        from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

        registry = ErasureCodePluginRegistry.instance()
        for layer in self.layers:
            for position, ch in enumerate(layer.chunks_map):
                if ch == "D":
                    layer.data.append(position)
                elif ch == "c":
                    layer.coding.append(position)
                if ch in ("D", "c"):
                    layer.chunks_as_set.add(position)
            layer.chunks = layer.data + layer.coding
            layer.profile.setdefault("k", str(len(layer.data)))
            layer.profile.setdefault("m", str(len(layer.coding)))
            layer.profile.setdefault("plugin", "jerasure")
            layer.profile.setdefault("technique", "reed_sol_van")
            layer.profile["device"] = str(self.device)
            layer.erasure_code = registry.factory(
                layer.profile["plugin"], dict(layer.profile))

    def _layers_sanity_checks(self, profile: Dict[str, str]) -> None:
        if not self.layers:
            raise ErasureCodeError(
                22, "at least one layer is required")
        mapping = profile["mapping"]
        for i, layer in enumerate(self.layers):
            if len(layer.chunks_map) != len(mapping):
                raise ErasureCodeError(
                    22, f"layer {i} map {layer.chunks_map!r} has length"
                    f" {len(layer.chunks_map)}, expected {len(mapping)}")

    # -- geometry ---------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.chunk_count_

    def get_data_chunk_count(self) -> int:
        return self.data_chunk_count_

    def get_coding_chunk_count(self) -> int:
        return self.chunk_count_ - self.data_chunk_count_

    def get_chunk_size(self, object_size: int) -> int:
        return self.layers[0].erasure_code.get_chunk_size(object_size)

    def get_alignment(self) -> int:
        return self.layers[0].erasure_code.get_alignment()

    # -- encode / decode --------------------------------------------------

    def encode_chunks(self, want_to_encode: Set[int],
                      encoded: Dict[int, bytearray]) -> None:
        # start at the topmost layer that covers everything wanted
        top = len(self.layers)
        for layer in reversed(self.layers):
            top -= 1
            if want_to_encode <= layer.chunks_as_set:
                break
        for layer in self.layers[top:]:
            layer_encoded = {j: encoded[c]
                             for j, c in enumerate(layer.chunks)}
            layer_want = {j for j, c in enumerate(layer.chunks)
                          if c in want_to_encode}
            layer.erasure_code.encode_chunks(layer_want, layer_encoded)
            for j, c in enumerate(layer.chunks):
                encoded[c] = layer_encoded[j]

    def decode_chunks(self, want_to_read: Set[int],
                      chunks: Mapping[int, bytes],
                      decoded: Dict[int, bytearray]) -> None:
        available = set(chunks)
        erasures = {i for i in range(self.get_chunk_count())
                    if i not in available}
        want_erasures = erasures & set(want_to_read)

        # The reference walks the layers once in reverse (locals first,
        # then global), which cannot recover cascades in the opposite
        # direction (e.g. global repairs a chunk that then lets a local
        # layer repair its parity).  Iterating to a fixpoint strictly
        # extends recoverability at no cost in the common single-pass case.
        progress = True
        while want_erasures and progress:
            progress = False
            for layer in reversed(self.layers):
                if self._decode_one_layer(layer, want_to_read, erasures,
                                          decoded):
                    progress = True
                want_erasures = erasures & set(want_to_read)
                if not want_erasures:
                    break

        if want_erasures:
            raise ErasureCodeError(
                5, f"unable to read {sorted(want_erasures)} from available"
                f" {sorted(available)}")

    def _decode_one_layer(self, layer: Layer, want_to_read: Set[int],
                          erasures: Set[int],
                          decoded: Dict[int, bytearray]) -> bool:
        """One layer's recovery attempt; True if it repaired anything."""
        layer_erasures = layer.chunks_as_set & erasures
        if not layer_erasures:
            return False  # nothing to do here
        if len(layer_erasures) > layer.erasure_code.get_coding_chunk_count():
            return False  # too many erasures for this layer
        layer_chunks = {}
        layer_decoded = {}
        layer_want = set()
        for j, c in enumerate(layer.chunks):
            # pick from `decoded` (not `chunks`) so chunks recovered by
            # other layers feed this one
            if c not in erasures:
                # view, not a copy: the inner decode stacks/consumes
                # the buffer before any later layer mutates it
                layer_chunks[j] = memoryview(decoded[c])
            if c in want_to_read or c in layer_erasures:
                layer_want.add(j)
            layer_decoded[j] = decoded[c]
        layer.erasure_code.decode_chunks(
            layer_want, layer_chunks, layer_decoded)
        for j, c in enumerate(layer.chunks):
            decoded[c] = layer_decoded[j]
            erasures.discard(c)
        return True

    # -- decode planning (the 3-case algorithm) ---------------------------

    def _minimum_to_decode(self, want_to_read: Set[int],
                           available_chunks: Set[int]) -> Set[int]:
        all_chunks = set(range(self.get_chunk_count()))
        erasures_total = all_chunks - available_chunks
        erasures_not_recovered = set(erasures_total)
        erasures_want = erasures_total & want_to_read

        # Case 1: nothing wanted is missing.
        if not erasures_want:
            return set(want_to_read)

        # Case 2: recover wanted erasures with as few chunks as possible,
        # trying small (local) layers first — layers are walked in reverse,
        # and kml puts locals after the global layer.
        minimum: Set[int] = set()
        for layer in reversed(self.layers):
            layer_want = want_to_read & layer.chunks_as_set
            if not layer_want:
                continue
            layer_erasures = layer_want & erasures_want
            if not layer_erasures:
                minimum |= layer_want
                continue
            erasures = layer.chunks_as_set & erasures_not_recovered
            if len(erasures) > layer.erasure_code.get_coding_chunk_count():
                continue  # hope an upper layer does better
            minimum |= layer.chunks_as_set - erasures_not_recovered
            erasures_not_recovered -= erasures
            erasures_want -= erasures
        if not erasures_want:
            minimum |= want_to_read
            minimum -= erasures_total
            return minimum

        # Case 3: cascade — recover anything recoverable anywhere, hoping it
        # unlocks the upper layers; if everything is reachable, read all
        # available chunks.
        # (fixpoint, like decode_chunks — strictly more patterns than the
        # reference's single pass)
        remaining = set(erasures_total)
        progress = True
        while remaining and progress:
            progress = False
            for layer in reversed(self.layers):
                layer_erasures = layer.chunks_as_set & remaining
                if not layer_erasures:
                    continue
                if (len(layer_erasures)
                        <= layer.erasure_code.get_coding_chunk_count()):
                    remaining -= layer_erasures
                    progress = True
        if not remaining:
            return set(available_chunks)

        raise ErasureCodeError(
            5, f"not enough chunks in {sorted(available_chunks)} to read"
            f" {sorted(want_to_read)}")

    # -- CRUSH ------------------------------------------------------------

    def create_rule(self, name: str, crush) -> int:
        """Multi-step locality-aware rule (ErasureCodeLrc::create_rule)."""
        if crush.find_rule_by_name(name) >= 0:
            return -17
        root = crush.name_to_item(self.rule_root)
        steps = [RuleStep(CRUSH_RULE_TAKE, root)]
        for step in self.rule_steps:
            domain = crush.type_id(step.type) if step.type else 0
            if step.op == "choose":
                steps.append(RuleStep(CRUSH_RULE_CHOOSE_INDEP, step.n, domain))
            elif step.op == "chooseleaf":
                steps.append(
                    RuleStep(CRUSH_RULE_CHOOSELEAF_INDEP, step.n, domain))
            else:
                raise ErasureCodeError(22, f"unknown crush step op {step.op}")
        steps.append(RuleStep(CRUSH_RULE_EMIT))
        return crush.add_rule(Rule(name, steps, rule_type=3))
