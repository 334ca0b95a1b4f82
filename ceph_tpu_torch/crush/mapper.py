"""Exact host implementation of the CRUSH placement kernel.

Behavioral twin of the reference's src/crush/mapper.c (crush_do_rule,
crush_choose_firstn :460, crush_choose_indep :655, bucket_straw2_choose :361,
bucket_perm_choose :73, is_out :424) written in Python/numpy.  Per-bucket
draws are vectorized over items (the hash and fixed-point log are numpy int
ops), so even 10k-device buckets evaluate in a few array passes; the
fully-batched path over millions of inputs is ceph_tpu_torch.crush.kernel
(a CUDA kernel).  A copy of ceph_tpu/crush/mapper.py.

This module is the correctness oracle: kernel.py must agree with it exactly,
and it must agree with the reference's crushtool (same hash, same ln tables,
same retry semantics).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ceph_tpu_torch.crush import ln_table
from ceph_tpu_torch.crush.map import (
    CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM, CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF, CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE, CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R, CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES, CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE, Bucket, ChooseArg, CrushMap,
)
from ceph_tpu_torch.ops import rjenkins


def crush_ln_vec(u: np.ndarray) -> np.ndarray:
    """Vectorized crush_ln over uint16 inputs (mapper.c:248-290)."""
    x = u.astype(np.int64) + 1
    _, exp = np.frexp(x.astype(np.float64))  # exact bit_length for x < 2^53
    bl = exp.astype(np.int64)
    shift = np.where(x & 0x18000, 0, 16 - bl)
    x = x << shift
    iexpon = 15 - shift
    index1 = (x >> 8) << 1
    rh = ln_table.RH_LH_TBL[index1 - 256]
    lh = ln_table.RH_LH_TBL[index1 + 1 - 256]
    xl64 = ((x.astype(np.uint64) * rh.astype(np.uint64)) >> np.uint64(48)).astype(np.int64)
    index2 = xl64 & 0xFF
    lh = lh + ln_table.LL_TBL[index2]
    return (iexpon << 44) + (lh >> 4)


def _straw2_choose(bucket: Bucket, x: int, r: int,
                   arg: Optional[ChooseArg], position: int) -> int:
    """bucket_straw2_choose: argmax over ln(hash16)/weight draws."""
    weights = np.asarray(bucket.weights, dtype=np.int64)
    ids = np.asarray(bucket.items, dtype=np.int64)
    if arg is not None:
        if arg.weight_set is not None:
            pos = min(position, len(arg.weight_set) - 1)
            weights = np.asarray(arg.weight_set[pos], dtype=np.int64)
        if arg.ids is not None:
            ids = np.asarray(arg.ids, dtype=np.int64)
    u = rjenkins.hash32_3(np.uint32(x), ids.astype(np.uint32), np.uint32(r))
    u = u.astype(np.int64) & 0xFFFF
    ln = crush_ln_vec(u) - 0x1000000000000
    # div64_s64 truncates toward zero; ln <= 0 and weights > 0 so
    # -((-ln) // w) is exact truncation.
    draws = np.where(weights > 0, -((-ln) // np.maximum(weights, 1)),
                     np.int64(-(2**63)))
    high = int(np.argmax(draws))  # first max wins, like the C loop
    return bucket.items[high]


def _straw_choose(bucket: Bucket, x: int, r: int) -> int:
    """Legacy straw (bucket_straw_choose): straws precomputed as weights here
    are 16.16 — the reference precomputes scaling factors; we use the same
    draw = hash16 * straw with straws supplied in bucket.weights."""
    ids = np.asarray(bucket.items, dtype=np.uint32)
    u = rjenkins.hash32_3(np.uint32(x), ids,
                          np.uint32(r)).astype(np.uint64) & np.uint64(0xFFFF)
    draws = u * np.asarray(bucket.weights, dtype=np.uint64)
    return bucket.items[int(np.argmax(draws))]


def _list_choose(bucket: Bucket, x: int, r: int) -> int:
    sums = np.cumsum(bucket.weights).tolist()
    for i in range(bucket.size - 1, -1, -1):
        w = int(rjenkins.hash32_4(np.uint32(x), np.uint32(bucket.items[i]),
                                  np.uint32(r), np.uint32(bucket.id & 0xFFFFFFFF)))
        w &= 0xFFFF
        w = (w * sums[i]) >> 16
        if w < bucket.weights[i]:
            return bucket.items[i]
    return bucket.items[0]


class _PermState:
    __slots__ = ("perm_x", "perm_n", "perm")

    def __init__(self, size: int):
        self.perm_x = 0
        self.perm_n = 0
        self.perm = list(range(size))


def _perm_choose(bucket: Bucket, work: _PermState, x: int, r: int) -> int:
    """bucket_perm_choose — uniform buckets' cached pseudorandom permutation."""
    pr = r % bucket.size
    if work.perm_x != (x & 0xFFFFFFFF) or work.perm_n == 0:
        work.perm_x = x & 0xFFFFFFFF
        if pr == 0:
            s = int(rjenkins.hash32_3(np.uint32(x), np.uint32(bucket.id & 0xFFFFFFFF),
                                      np.uint32(0))) % bucket.size
            work.perm[0] = s
            work.perm_n = 0xFFFF
            return bucket.items[s]
        work.perm = list(range(bucket.size))
        work.perm_n = 0
    elif work.perm_n == 0xFFFF:
        for i in range(1, bucket.size):
            work.perm[i] = i
        work.perm[work.perm[0]] = 0
        work.perm_n = 1
    while work.perm_n <= pr:
        p = work.perm_n
        if p < bucket.size - 1:
            i = int(rjenkins.hash32_3(np.uint32(x), np.uint32(bucket.id & 0xFFFFFFFF),
                                      np.uint32(p))) % (bucket.size - p)
            if i:
                work.perm[p + i], work.perm[p] = work.perm[p], work.perm[p + i]
        work.perm_n += 1
    return bucket.items[work.perm[pr]]


class _Work:
    def __init__(self) -> None:
        self.perm: Dict[int, _PermState] = {}

    def for_bucket(self, b: Bucket) -> _PermState:
        st = self.perm.get(b.id)
        if st is None:
            st = _PermState(b.size)
            self.perm[b.id] = st
        return st


def _bucket_choose(cmap: CrushMap, bucket: Bucket, work: _Work, x: int,
                   r: int, arg: Optional[ChooseArg], position: int) -> int:
    if bucket.alg == CRUSH_BUCKET_UNIFORM:
        return _perm_choose(bucket, work.for_bucket(bucket), x, r)
    if bucket.alg == CRUSH_BUCKET_LIST:
        return _list_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW:
        return _straw_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW2:
        return _straw2_choose(bucket, x, r, arg, position)
    if bucket.alg == CRUSH_BUCKET_TREE:
        raise NotImplementedError("tree buckets are legacy; use straw2")
    return bucket.items[0]


def _is_out(cmap: CrushMap, weight: List[int], item: int, x: int) -> bool:
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    u = int(rjenkins.hash32_2(np.uint32(x), np.uint32(item))) & 0xFFFF
    return u >= w


def _choose_firstn(cmap: CrushMap, work: _Work, bucket: Bucket,
                   weight: List[int], x: int, numrep: int, type_: int,
                   out: List[int], outpos: int, out_size: int,
                   tries: int, recurse_tries: int, local_retries: int,
                   local_fallback_retries: int, recurse_to_leaf: bool,
                   vary_r: int, stable: int, out2: Optional[List[int]],
                   parent_r: int, choose_args: Dict[int, ChooseArg]) -> int:
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        retry_descent = True
        while retry_descent:
            retry_descent = False
            in_b = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                collide = False
                r = rep + parent_r + ftotal
                if in_b.size == 0:
                    reject = True
                else:
                    if (local_fallback_retries > 0
                            and flocal >= (in_b.size >> 1)
                            and flocal > local_fallback_retries):
                        item = _perm_choose(in_b, work.for_bucket(in_b), x, r)
                    else:
                        item = _bucket_choose(cmap, in_b, work, x, r,
                                              choose_args.get(in_b.id), outpos)
                    if item >= cmap.max_devices:
                        skip_rep = True
                        break
                    if item >= 0:
                        itemtype = 0
                    elif item in cmap.buckets:
                        itemtype = cmap.buckets[item].type
                    else:
                        skip_rep = True
                        break
                    if itemtype != type_:
                        if item >= 0 or item not in cmap.buckets:
                            skip_rep = True
                            break
                        in_b = cmap.buckets[item]
                        retry_bucket = True
                        continue
                    for i in range(outpos):
                        if out[i] == item:
                            collide = True
                            break
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            got = _choose_firstn(
                                cmap, work, cmap.buckets[item], weight, x,
                                1 if stable else outpos + 1, 0,
                                out2, outpos, count,
                                recurse_tries, 0, local_retries,
                                local_fallback_retries, False,
                                vary_r, stable, None, sub_r, choose_args)
                            if got <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and not collide and itemtype == 0:
                        reject = _is_out(cmap, weight, item, x)
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0
                          and flocal <= in_b.size + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
        if not skip_rep:
            out[outpos] = item
            outpos += 1
            count -= 1
        rep += 1
    return outpos


def _choose_indep(cmap: CrushMap, work: _Work, bucket: Bucket,
                  weight: List[int], x: int, left: int, numrep: int,
                  type_: int, out: List[int], outpos: int, tries: int,
                  recurse_tries: int, recurse_to_leaf: bool,
                  out2: Optional[List[int]], parent_r: int,
                  choose_args: Dict[int, ChooseArg]) -> None:
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = CRUSH_ITEM_UNDEF
        if out2 is not None:
            out2[rep] = CRUSH_ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != CRUSH_ITEM_UNDEF:
                continue
            in_b = bucket
            while True:
                r = rep + parent_r
                if (in_b.alg == CRUSH_BUCKET_UNIFORM
                        and in_b.size % numrep == 0):
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_b.size == 0:
                    break
                item = _bucket_choose(cmap, in_b, work, x, r,
                                      choose_args.get(in_b.id), outpos)
                if item >= cmap.max_devices:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                if item >= 0:
                    itemtype = 0
                elif item in cmap.buckets:
                    itemtype = cmap.buckets[item].type
                else:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                if itemtype != type_:
                    if item >= 0 or item not in cmap.buckets:
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_b = cmap.buckets[item]
                    continue
                collide = False
                for i in range(outpos, endpos):
                    if out[i] == item:
                        collide = True
                        break
                if collide:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        _choose_indep(cmap, work, cmap.buckets[item], weight,
                                      x, 1, numrep, 0, out2, rep,
                                      recurse_tries, 0, False, None, r,
                                      choose_args)
                        if out2[rep] == CRUSH_ITEM_NONE:
                            break
                    elif out2 is not None:
                        out2[rep] = item
                if itemtype == 0 and _is_out(cmap, weight, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == CRUSH_ITEM_UNDEF:
            out[rep] = CRUSH_ITEM_NONE
        if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
            out2[rep] = CRUSH_ITEM_NONE


def crush_do_rule(cmap: CrushMap, ruleno: int, x: int, result_max: int,
                  weight: Optional[List[int]] = None,
                  choose_args: Optional[Dict[int, ChooseArg]] = None,
                  ) -> List[int]:
    """Interpret a rule's steps for input x (mapper.c:900-1100)."""
    if ruleno >= len(cmap.rules):
        return []
    if weight is None:
        weight = cmap.full_weight_vector()
    if choose_args is None:
        choose_args = cmap.choose_args
    rule = cmap.rules[ruleno]
    work = _Work()

    choose_tries = cmap.choose_total_tries + 1
    choose_leaf_tries = 0
    choose_local_retries = cmap.choose_local_tries
    choose_local_fallback_retries = cmap.choose_local_fallback_tries
    vary_r = cmap.chooseleaf_vary_r
    stable = cmap.chooseleaf_stable

    result: List[int] = []
    w: List[int] = []
    for step in rule.steps:
        if step.op == CRUSH_RULE_TAKE:
            ok = (0 <= step.arg1 < cmap.max_devices) or step.arg1 in cmap.buckets
            if ok:
                w = [step.arg1]
        elif step.op == CRUSH_RULE_SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES:
            if step.arg1 >= 0:
                choose_local_retries = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if step.arg1 >= 0:
                choose_local_fallback_retries = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
            if step.arg1 >= 0:
                vary_r = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
            if step.arg1 >= 0:
                stable = step.arg1
        elif step.op in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP,
                         CRUSH_RULE_CHOOSELEAF_FIRSTN,
                         CRUSH_RULE_CHOOSELEAF_INDEP):
            if not w:
                continue
            firstn = step.op in (CRUSH_RULE_CHOOSE_FIRSTN,
                                 CRUSH_RULE_CHOOSELEAF_FIRSTN)
            recurse_to_leaf = step.op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                                          CRUSH_RULE_CHOOSELEAF_INDEP)
            o = [0] * result_max
            c = [0] * result_max
            osize = 0
            for wi in w:
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                if wi >= 0 or wi not in cmap.buckets:
                    continue  # probably CRUSH_ITEM_NONE
                bucket = cmap.buckets[wi]
                # The reference passes o+osize / c+osize with outpos 0, so
                # collision scans are per-TAKE-item; emulate the pointer
                # offset with scratch slices.
                avail = result_max - osize
                o_off = [0] * avail
                c_off = [0] * avail
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif cmap.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    placed = _choose_firstn(
                        cmap, work, bucket, weight, x, numrep, step.arg2,
                        o_off, 0, avail, choose_tries,
                        recurse_tries, choose_local_retries,
                        choose_local_fallback_retries, recurse_to_leaf,
                        vary_r, stable, c_off, 0, choose_args)
                else:
                    placed = min(numrep, avail)
                    _choose_indep(
                        cmap, work, bucket, weight, x, placed, numrep,
                        step.arg2, o_off, 0, choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, c_off, 0, choose_args)
                o[osize : osize + placed] = o_off[:placed]
                c[osize : osize + placed] = c_off[:placed]
                osize += placed
            if recurse_to_leaf:
                o[:osize] = c[:osize]
            w = o[:osize]
        elif step.op == CRUSH_RULE_EMIT:
            for item in w:
                if len(result) < result_max:
                    result.append(item)
            w = []
    return result
