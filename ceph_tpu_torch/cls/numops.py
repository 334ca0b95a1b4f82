"""cls_numops: atomic arithmetic on omap-stored values.

Reference: Ceph's src/cls/numops/cls_numops.cc — add/sub/
mul/div on a decimal value stored under an omap key, atomically under
the object lock (the class exists to prove read-modify-write classes
compose with replication).
"""

from __future__ import annotations

import json

from ceph_tpu_torch.cls import ClsError, EINVAL, ENOENT, MethodContext, RD, WR, as_text


async def _rmw(ctx: MethodContext, data: bytes, op) -> bytes:
    req = json.loads(as_text(data))
    key = req["key"]
    try:
        operand = float(req["value"])
    except (KeyError, ValueError, TypeError):
        raise ClsError(EINVAL, "bad operand")
    try:
        omap = await ctx.omap_get()
    except ClsError as e:
        if e.rc != ENOENT:  # first call: object does not exist yet
            raise
        omap = {}
    try:
        current = float(omap.get(key, b"0").decode())
    except ValueError:
        raise ClsError(EINVAL, "stored value not numeric")
    result = op(current, operand)
    raw = repr(result).encode()
    await ctx.omap_set({key: raw})
    return raw


async def add(ctx: MethodContext, data: bytes) -> bytes:
    return await _rmw(ctx, data, lambda a, b: a + b)


async def sub(ctx: MethodContext, data: bytes) -> bytes:
    return await _rmw(ctx, data, lambda a, b: a - b)


async def mul(ctx: MethodContext, data: bytes) -> bytes:
    return await _rmw(ctx, data, lambda a, b: a * b)


async def div(ctx: MethodContext, data: bytes) -> bytes:
    def _div(a: float, b: float) -> float:
        if b == 0:
            raise ClsError(EINVAL, "division by zero")
        return a / b
    return await _rmw(ctx, data, _div)


def register(handler) -> None:
    handler.register("numops", "add", RD | WR, add)
    handler.register("numops", "sub", RD | WR, sub)
    handler.register("numops", "mul", RD | WR, mul)
    handler.register("numops", "div", RD | WR, div)
