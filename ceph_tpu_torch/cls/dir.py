"""cls_dir: atomic name -> value directory entries in omap.

Reference: the dir_add_image/dir_remove_image methods of cls_rbd
(Ceph's src/cls/rbd/cls_rbd.cc:dir_add_image) — check-and-set
of a directory key must run server-side under the object lock or two
concurrent creators both 'win' and clobber each other's metadata.
"""

from __future__ import annotations

import json

from ceph_tpu_torch.cls import ClsError, EINVAL, ENOENT, MethodContext, RD, WR, as_text

EEXIST = -17


async def _omap(ctx: MethodContext) -> dict:
    try:
        return await ctx.omap_get()
    except ClsError as e:
        if e.rc != ENOENT:
            raise
        return {}


async def add(ctx: MethodContext, data: bytes) -> bytes:
    req = json.loads(as_text(data))
    key, value = req.get("key"), req.get("value", "")
    if not key:
        raise ClsError(EINVAL, "missing key")
    omap = await _omap(ctx)
    if key in omap:
        raise ClsError(EEXIST, f"{key!r} exists")
    await ctx.omap_set({key: value.encode()})
    return b""


async def remove(ctx: MethodContext, data: bytes) -> bytes:
    """{key, value?}: remove an entry; with `value`, only if the
    stored value still matches (compare-and-swap — a racing writer who
    replaced the entry must not have it deleted under them)."""
    req = json.loads(as_text(data))
    key = req.get("key")
    omap = await _omap(ctx)
    if key not in omap:
        raise ClsError(ENOENT, f"no entry {key!r}")
    expect = req.get("value")
    if expect is not None and omap[key].decode() != expect:
        raise ClsError(EEXIST, f"{key!r} value changed")
    await ctx.omap_rm_keys([key])
    return b""


async def get(ctx: MethodContext, data: bytes) -> bytes:
    req = json.loads(as_text(data))
    omap = await _omap(ctx)
    value = omap.get(req.get("key", ""))
    if value is None:
        raise ClsError(ENOENT, "no entry")
    return value


async def list_keys(ctx: MethodContext, data: bytes) -> bytes:
    omap = await _omap(ctx)
    return json.dumps(sorted(omap)).encode()


def register(handler) -> None:
    handler.register("dir", "add", RD | WR, add)
    handler.register("dir", "remove", RD | WR, remove)
    handler.register("dir", "get", RD, get)
    handler.register("dir", "list", RD, list_keys)
