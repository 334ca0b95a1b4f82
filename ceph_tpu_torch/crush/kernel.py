"""Bulk CRUSH placement (port of ceph_tpu/crush/kernel.py).

The JAX module expresses one input's rule evaluation with `lax.while_loop`
nests and vmaps it over millions of inputs in one XLA dispatch.  Here the
rule is resolved on the host into a `ChooseProgram` (its one TAKE /
CHOOSE(LEAF)_FIRSTN or _INDEP / EMIT group, with tries, leaf tries and the
map's tunables), the map into a `DenseMap` of tensors on one device, and
`ceph_tpu_torch.ops.crush_kernels.crush_do_rule_batch` places every input:
on a CUDA tensor with the hand-written kernel of csrc/crush.cu (lanes that
each run one input's tries, refilled from a work counter), on a CPU tensor
with `crush_do_rule_batch_plain` below, where
the vmap is the batch dimension and each while_loop a masked loop over the
lanes still active, within the same trip bounds.

Both compute exactly what the JAX `_choose_firstn_jax` and
`_choose_indep_jax` compute.  Both skip work whose result the JAX version
computes and then masks away (the leaf descent of a candidate that is
already rejected, the weight test of a rejected leaf), so the plain
version's counts of draws and weight tests (`stats`) are the kernel's.

Scope is the JAX module's: straw2 buckets, modern tunables
(choose_local_tries = choose_local_fallback_tries = 0), rules of one TAKE /
CHOOSE / EMIT group with SET_CHOOSE_TRIES / SET_CHOOSELEAF_TRIES steps.
`compile_rule` also raises NotImplementedError where the JAX module
silently computes something else than the host mapper: a map with
`choose_args` (balancer weight sets), a rule with a SET_CHOOSELEAF_VARY_R,
SET_CHOOSELEAF_STABLE or SET_CHOOSE_LOCAL_* step, a rule of more than one
TAKE / CHOOSE / EMIT group, a firstn step that asks for more replicas than
result_max, a bucket that names a missing bucket, and an item weight above
0xFFFFFFFF (Ceph's weights are 32-bit; `straw2_reciprocal` is proven up to
there).
Callers then use the exact host mapper (ceph_tpu_torch.crush.mapper).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, NamedTuple

import numpy as np
import torch

from ceph_tpu_torch.crush import ln_table
from ceph_tpu_torch.crush.map import (
    CRUSH_BUCKET_STRAW2, CRUSH_ITEM_NONE, CRUSH_ITEM_UNDEF,
    CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE, CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES, CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE, CrushMap,
)
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ops.rjenkins import hash32_2_torch, hash32_3_torch

S64_MIN = -(2**63)
MAX_RESULT = 32     # the kernel's per-lane output arrays
MAX_ITEM_WEIGHT = 0xFFFFFFFF
RECIP_SHIFT = 56    # a packed reciprocal is m | s << RECIP_SHIFT
_CHOOSES = (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP,
            CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP)
# rule steps the JAX kernel drops but the host mapper honours
_UNHONOURED = {
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R: "set_chooseleaf_vary_r",
    CRUSH_RULE_SET_CHOOSELEAF_STABLE: "set_chooseleaf_stable",
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES: "set_choose_local_tries",
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
        "set_choose_local_fallback_tries",
}


class ChooseProgram(NamedTuple):
    """One rule resolved for the batched mapper; the kernel takes these
    fields, in this order, as int32 (csrc/crush.cu CrushParams)."""

    result_max: int
    firstn: int        # 1: CHOOSE(LEAF)_FIRSTN, 0: _INDEP
    recurse: int       # 1: CHOOSELEAF (the result is the leaves)
    take: int          # bucket id the descent starts from
    count: int         # replicas to place: min(numrep, result_max) >= 0
    numrep: int        # the step's replica count, for indep's r mixing
    target_type: int
    tries: int
    leaf_tries: int
    vary_r: int
    stable: int


@dataclass
class DenseMap:
    """CrushMap flattened to tensors on one device; bucket row = -1 - id."""

    items: torch.Tensor       # (NB, MS) int32, padded with 0
    weights: torch.Tensor     # (NB, MS) int64 16.16, padded with 0
    recips: torch.Tensor      # (NB, MS) int64 straw2_reciprocal(weights)
    sizes: torch.Tensor       # (NB,) int32
    types: torch.Tensor       # (NB,) int32
    dev_weight: torch.Tensor  # (W,) int64 16.16 in/out vector
    max_devices: int
    max_depth: int

    @classmethod
    def from_crush_map(cls, cmap: CrushMap, weight: List[int] | None,
                       device: torch.device) -> "DenseMap":
        nb = max(-bid for bid in cmap.buckets)
        ms = max((b.size for b in cmap.buckets.values()), default=1) or 1
        items = np.zeros((nb, ms), dtype=np.int32)
        weights = np.zeros((nb, ms), dtype=np.int64)
        recips = np.zeros((nb, ms), dtype=np.int64)
        recip = functools.lru_cache(maxsize=None)(straw2_reciprocal)
        sizes = np.zeros(nb, dtype=np.int32)
        types = np.zeros(nb, dtype=np.int32)
        for bid, b in cmap.buckets.items():
            if b.alg != CRUSH_BUCKET_STRAW2:
                raise NotImplementedError(
                    "the batched mapper takes straw2 buckets; use the host"
                    " mapper")
            if any(i < 0 and i not in cmap.buckets for i in b.items):
                raise NotImplementedError(
                    f"bucket {bid} names a missing bucket; use the host"
                    " mapper")
            if any(w > MAX_ITEM_WEIGHT for w in b.weights):
                raise NotImplementedError(
                    f"bucket {bid} has an item weight above 0xFFFFFFFF; use"
                    " the host mapper")
            row = -1 - bid
            items[row, : b.size] = b.items
            weights[row, : b.size] = b.weights
            recips[row, : b.size] = [recip(w) for w in b.weights]
            sizes[row] = b.size
            types[row] = b.type
        depth = {}

        def bucket_depth(bid: int) -> int:
            if bid in depth:
                return depth[bid]
            b = cmap.buckets[bid]
            d = 1 + max((bucket_depth(i) for i in b.items if i < 0), default=0)
            depth[bid] = d
            return d

        max_depth = max((bucket_depth(b) for b in cmap.buckets), default=1)
        w = weight if weight is not None else cmap.full_weight_vector()

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(device)

        return cls(items=put(items), weights=put(weights),
                   recips=put(recips), sizes=put(sizes), types=put(types),
                   dev_weight=put(np.asarray(w, dtype=np.int64).reshape(-1)),
                   max_devices=cmap.max_devices, max_depth=max_depth)


def straw2_reciprocal(w: int) -> int:
    """The kernel's exact reciprocal of a straw2 item weight w in
    [1, MAX_ITEM_WEIGHT], packed as m | s << RECIP_SHIFT; 0 for w <= 0
    (the kernel skips such an item, as the division skipped it).

    straw2 divides n = 2^48 - crush_ln(u), which lies in [0, 2^48], by w.
    With s = ceil(log2 w), k = 49 + s and m = ceil(2^k / w):

        n // w == (n * m) >> k   for every n in [0, 2^48],

    which the kernel computes as umulhi(n << 15, m) >> s (n << 15 < 2^64,
    and flooring by 2^64 then by 2^s is flooring by 2^(64+s)).  Proof
    (Granlund and Montgomery, PLDI 1994, section 4): m * w = 2^k + e with
    0 <= e < w.  Write n = q * w + r, 0 <= r < w.  Then
    n * m / 2^k = n / w + n * e / (w * 2^k) = q + (r + n * e / 2^k) / w.
    Since n <= 2^48 < 2^49 and e < w <= 2^s, n * e < 2^(49+s) = 2^k, so
    0 <= r + n * e / 2^k < r + 1 <= w and the floor is q.  m < 2^51
    (m <= 2^k / w + 1 and w > 2^(s-1)) and s <= 32 pack into 63 bits."""
    if w <= 0:
        return 0
    if w > MAX_ITEM_WEIGHT:
        raise NotImplementedError(
            f"item weight {w:#x} above 0xFFFFFFFF: use the host mapper")
    s = (w - 1).bit_length()
    k = 49 + s
    m = -(-(1 << k) // w)
    return m | s << RECIP_SHIFT


@functools.lru_cache(maxsize=None)
def ln_tables(device: torch.device) -> torch.Tensor:
    """(514,) int64: RH_LH_TBL (258 entries) then LL_TBL (256), on
    `device`, as the kernel takes them."""
    return torch.from_numpy(np.concatenate(
        [ln_table.RH_LH_TBL, ln_table.LL_TBL]).astype(np.int64)).to(device)


def crush_ln(u: torch.Tensor) -> torch.Tensor:
    """crush_ln on tensors (int64 in/out); u in [0, 0xffff]."""
    tabs = ln_tables(u.device)
    rh_lh, ll = tabs[:258], tabs[258:]
    x = u.to(torch.int64) + 1
    # bit length of x: exact through float64 for x < 2^53
    bl = torch.frexp(x.to(torch.float64))[1].to(torch.int64)
    shift = torch.where((x & 0x18000) != 0, 0, 16 - bl)
    x = x << shift
    iexpon = 15 - shift
    index1 = (x >> 8) << 1
    rh = rh_lh[index1 - 256]
    lh = rh_lh[index1 + 1 - 256]
    # (x * rh) >> 48 as C computes it in uint64: x * rh can pass 2^63
    # (x up to 0x80ff at rh = 2^48), so rh is split in 16-bit parts and no
    # product leaves int64
    xl64 = (x * (rh >> 16) + ((x * (rh & 0xFFFF)) >> 16)) >> 32
    lh = lh + ll[xl64 & 0xFF]
    return (iexpon << 44) + (lh >> 4)


# -- the plain version ------------------------------------------------------


def _count(stats, key: str, n) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(n)


def _rows(dm: DenseMap, item: torch.Tensor) -> torch.Tensor:
    return (-1 - item).clamp(0, dm.sizes.shape[0] - 1)


def _straw2(dm: DenseMap, rows, x, r, stats):
    """Each lane's straw2 pick from its bucket row (first max wins)."""
    ids = dm.items[rows].to(torch.int64)                  # (n, MS)
    ws = dm.weights[rows]
    live = ((torch.arange(ids.shape[1], device=ids.device)
             < dm.sizes[rows, None]) & (ws > 0))
    _count(stats, "draws", live.sum())
    u = hash32_3_torch(x[:, None], ids, r[:, None]) & 0xFFFF
    ln = crush_ln(u) - 0x1000000000000
    # -ln >= 0 and the divisor > 0, so floor division truncates as C does
    draws = torch.where(live, -((-ln) // ws.clamp(min=1)), S64_MIN)
    return ids.gather(1, draws.argmax(1, keepdim=True)).squeeze(1)


def _descend(dm: DenseMap, item, x, r, target_type: int, stats):
    """Walk each lane from `item` down to an item of target_type ->
    (item, empty_bad, type_bad), as the JAX `_descend`."""
    item = item.clone()
    empty = torch.zeros_like(item, dtype=torch.bool)
    depth = torch.zeros_like(item)
    while True:
        row = _rows(dm, item)
        act = (~empty & (item < 0) & (dm.types[row] != target_type)
               & (depth < dm.max_depth + 1))
        idx = act.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        rw = row[idx]
        is_empty = dm.sizes[rw] == 0
        go = (~is_empty).nonzero().squeeze(1)
        nxt = item[idx]
        nxt[go] = _straw2(dm, rw[go], x[idx[go]], r[idx[go]], stats)
        item[idx] = nxt
        empty[idx] = is_empty
        depth[idx] += 1
    ok_type = torch.where(item < 0, dm.types[_rows(dm, item)] == target_type,
                          target_type == 0)
    type_bad = ~empty & (~ok_type | (item >= dm.max_devices))
    return item, empty, type_bad


def _is_out(dm: DenseMap, item, x, stats):
    """Weight-vector rejection (mapper.c is_out); hashes only the lanes
    whose weight is strictly between 0 and 0x10000."""
    nw = dm.dev_weight.shape[0]
    if nw == 0:
        return torch.ones_like(item, dtype=torch.bool)
    w = dm.dev_weight[item.clamp(0, nw - 1)]
    out = (item >= nw) | (w == 0)
    test = (~out & (w < 0x10000)).nonzero().squeeze(1)
    _count(stats, "is_out_hashes", test.numel())
    u = hash32_2_torch(x[test], item[test]) & 0xFFFF
    out[test] = u >= w[test]
    return out


def _leaf_choose(dm: DenseMap, domain, x, rep_base, parent_r, stride: int,
                 leaf_tries: int, out2, limit, stats):
    """The chooseleaf recursion: one device under each lane's `domain`
    -> (leaf, failed), as the JAX `_leaf_choose`."""
    ftotal = torch.zeros_like(domain)
    leaf = torch.full_like(domain, CRUSH_ITEM_NONE)
    done = torch.zeros_like(domain, dtype=torch.bool)
    cols = torch.arange(out2.shape[1], device=domain.device)
    while True:
        idx = (~done & (ftotal < leaf_tries)).nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        xi = x[idx]
        r = rep_base[idx] + parent_r[idx] + stride * ftotal[idx]
        cand, empty_bad, type_bad = _descend(dm, domain[idx], xi, r, 0, stats)
        collide = ((cols < limit[idx, None])
                   & (out2[idx] == cand[:, None])).any(1)
        rejected = empty_bad | type_bad | collide
        test = (~rejected).nonzero().squeeze(1)
        rejected[test] = _is_out(dm, cand[test], xi[test], stats)
        leaf[idx] = torch.where(rejected, leaf[idx], cand)
        done[idx] = ~rejected
        ftotal[idx] += 1
    return leaf, ~done


def _choose_firstn(dm: DenseMap, p: ChooseProgram, x, stats):
    n = x.shape[0]
    out = torch.full((n, p.result_max), CRUSH_ITEM_NONE, dtype=torch.int64,
                     device=x.device)
    out2 = out.clone()
    outpos = torch.zeros(n, dtype=torch.int64, device=x.device)
    cols = torch.arange(p.result_max, device=x.device)
    root = torch.full_like(x, p.take)
    for rep in range(p.count):
        ftotal = torch.zeros_like(x)
        item = torch.full_like(x, CRUSH_ITEM_NONE)
        leaf = item.clone()
        status = torch.zeros_like(x)    # 0 trying, 1 placed, 2 skip_rep
        while True:
            idx = ((status == 0) & (ftotal < p.tries)).nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            xi, pos = x[idx], outpos[idx]
            r = rep + ftotal[idx]
            cand, empty_bad, type_bad = _descend(dm, root[idx], xi, r,
                                                 p.target_type, stats)
            collide = ((cols < pos[:, None])
                       & (out[idx] == cand[:, None])).any(1)
            reject = empty_bad | collide
            lf = torch.full_like(cand, CRUSH_ITEM_NONE)
            if p.recurse:
                go = (~type_bad & ~reject).nonzero().squeeze(1)
                sub_r = (r[go] >> min(p.vary_r - 1, 63) if p.vary_r > 0
                         else torch.zeros_like(go))
                base = (torch.zeros_like(go) if p.stable else pos[go])
                lf[go], lfail = _leaf_choose(dm, cand[go], xi[go], base,
                                             sub_r, 1, p.leaf_tries,
                                             out2[idx[go]], pos[go], stats)
                reject[go] = lfail
            if p.target_type == 0:
                go = (~type_bad & ~reject).nonzero().squeeze(1)
                reject[go] = _is_out(dm, cand[go], xi[go], stats)
            placed = ~type_bad & ~reject
            status[idx] = torch.where(type_bad, 2, placed.to(torch.int64))
            item[idx] = torch.where(placed, cand, item[idx])
            leaf[idx] = torch.where(placed, lf, leaf[idx])
            ftotal[idx] += 1
        got = (status == 1).nonzero().squeeze(1)
        out[got, outpos[got]] = item[got]
        out2[got, outpos[got]] = leaf[got]
        outpos[got] += 1
    return out2 if p.recurse else out


def _choose_indep(dm: DenseMap, p: ChooseProgram, x, stats):
    n, left0 = x.shape[0], p.count
    out = torch.full((n, p.result_max), CRUSH_ITEM_NONE, dtype=torch.int64,
                     device=x.device)
    out[:, :left0] = CRUSH_ITEM_UNDEF
    out2 = out.clone()
    left = torch.full_like(x, left0)
    root = torch.full_like(x, p.take)
    no_limit = torch.zeros_like(x)
    for ftotal in range(p.tries):
        active = left > 0
        if not bool(active.any()):
            break
        for rep in range(left0):
            idx = (active & (out[:, rep] == CRUSH_ITEM_UNDEF)).nonzero() \
                .squeeze(1)
            if idx.numel() == 0:
                continue
            xi = x[idx]
            r = torch.full_like(xi, rep + p.numrep * ftotal)
            cand, empty_bad, type_bad = _descend(dm, root[idx], xi, r,
                                                 p.target_type, stats)
            collide = (out[idx, :left0] == cand[:, None]).any(1)
            reject = empty_bad | collide
            lf = torch.full_like(cand, CRUSH_ITEM_NONE)
            if p.recurse:
                go = (~type_bad & ~reject).nonzero().squeeze(1)
                lf[go], lfail = _leaf_choose(
                    dm, cand[go], xi[go], torch.full_like(go, rep), r[go],
                    p.numrep, p.leaf_tries, out2[idx[go]], no_limit[go],
                    stats)
                reject[go] = lfail
            if p.target_type == 0:
                go = (~type_bad & ~reject).nonzero().squeeze(1)
                reject[go] = _is_out(dm, cand[go], xi[go], stats)
            place = ~type_bad & ~reject
            none = torch.full_like(cand, CRUSH_ITEM_NONE)
            out[idx, rep] = torch.where(
                place, cand, torch.where(type_bad, none, out[idx, rep]))
            if p.recurse:
                out2[idx, rep] = torch.where(
                    place, lf, torch.where(type_bad, none, out2[idx, rep]))
            left[idx] -= (place | type_bad).to(torch.int64)
    res = out2 if p.recurse else out
    return torch.where(res == CRUSH_ITEM_UNDEF, CRUSH_ITEM_NONE, res)


def crush_do_rule_batch_plain(dm: DenseMap, program: ChooseProgram,
                              xs: torch.Tensor,
                              stats: dict | None = None) -> torch.Tensor:
    """The plain PyTorch version of the placement kernel: (N,) int32
    inputs -> (N, result_max) int32.  Unplaced firstn slots hold
    CRUSH_ITEM_NONE at the tail, indep NONE in place.  With `stats`, adds
    the straw2 draws ("draws") and the is_out hashes ("is_out_hashes")
    that these inputs needed."""
    x = xs.to(torch.int64)
    choose = _choose_firstn if program.firstn else _choose_indep
    return choose(dm, program, x, stats).to(torch.int32)


# -- compile ---------------------------------------------------------------


def rule_program(cmap: CrushMap, ruleno: int,
                 result_max: int) -> ChooseProgram:
    """Resolve one rule for the batched mapper; NotImplementedError for a
    shape it does not take (the caller then uses the host mapper)."""
    if not 1 <= result_max <= MAX_RESULT:
        raise NotImplementedError(
            f"result_max {result_max} outside 1..{MAX_RESULT}: use the host"
            " mapper")
    if cmap.choose_local_tries or cmap.choose_local_fallback_tries:
        raise NotImplementedError("legacy local tries: use the host mapper")
    if cmap.choose_args:
        raise NotImplementedError(
            "choose_args weight sets: use the host mapper")
    choose_tries = cmap.choose_total_tries + 1
    choose_leaf_tries = 0
    take = program = None
    emitted = False
    for step in cmap.rules[ruleno].steps:
        if step.op in _UNHONOURED:
            raise NotImplementedError(
                f"rule step {_UNHONOURED[step.op]}: use the host mapper")
        if step.op == CRUSH_RULE_TAKE:
            if take is not None:
                raise NotImplementedError(
                    "more than one TAKE: use the host mapper")
            if step.arg1 not in cmap.buckets:
                raise NotImplementedError(
                    f"TAKE {step.arg1} is no bucket: use the host mapper")
            take = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif step.op in _CHOOSES:
            if take is None or program is not None:
                raise NotImplementedError(
                    "chained choose steps: use the host mapper")
            firstn = step.op in (CRUSH_RULE_CHOOSE_FIRSTN,
                                 CRUSH_RULE_CHOOSELEAF_FIRSTN)
            numrep = step.arg1 if step.arg1 > 0 else step.arg1 + result_max
            if firstn and numrep > result_max:
                # crush_do_rule tries replica after replica until result_max
                # are placed or numrep tried; the JAX kernel stops after
                # result_max tries, so a skipped replica leaves NONE there
                raise NotImplementedError(
                    f"firstn {numrep} replicas past result_max {result_max}:"
                    " use the host mapper")
            if choose_leaf_tries:
                leaf_tries = choose_leaf_tries
            elif firstn and not cmap.chooseleaf_descend_once:
                leaf_tries = choose_tries
            else:
                leaf_tries = 1
            program = ChooseProgram(
                result_max=result_max, firstn=int(firstn),
                recurse=int(step.op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                                        CRUSH_RULE_CHOOSELEAF_INDEP)),
                take=take, count=max(0, min(numrep, result_max)),
                numrep=numrep, target_type=step.arg2, tries=choose_tries,
                leaf_tries=leaf_tries, vary_r=cmap.chooseleaf_vary_r,
                stable=cmap.chooseleaf_stable)
        elif step.op == CRUSH_RULE_EMIT:
            if program is None or emitted:
                raise NotImplementedError(
                    "EMIT without one CHOOSE before it: use the host mapper")
            emitted = True
    if not emitted:
        raise NotImplementedError(
            "no TAKE / CHOOSE / EMIT group: use the host mapper")
    return program


def compile_rule(cmap: CrushMap, ruleno: int, result_max: int,
                 weight: List[int] | None = None, device=None):
    """Build a bulk evaluator for one rule: xs (N,) -> np.ndarray
    (N, result_max) int32, on `device` (CUDA unless the caller names
    another; no CUDA and no device raises).

    Unplaced firstn slots hold CRUSH_ITEM_NONE at the tail; indep holds
    NONE in place, mirroring crush_do_rule's output contract.
    """
    # the wrapper module imports this one for the plain version
    from ceph_tpu_torch.ops.crush_kernels import crush_do_rule_batch

    dev = resolve_device(device)
    program = rule_program(cmap, ruleno, result_max)
    dm = DenseMap.from_crush_map(cmap, weight, dev)

    def run(xs) -> np.ndarray:
        x = np.asarray(xs, dtype=np.int64).astype(np.int32)
        return crush_do_rule_batch(
            dm, program, torch.from_numpy(x).to(dev)).cpu().numpy()

    run.dense_map = dm
    run.program = program
    return run
