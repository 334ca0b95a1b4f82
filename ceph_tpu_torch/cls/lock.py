"""cls_lock: advisory object locks.

Reference: Ceph's src/cls/lock/cls_lock.cc — lock(name, type,
cookie, tag), unlock, break_lock, get_info.  Lock state lives in an
object xattr keyed by lock name; EXCLUSIVE admits one owner, SHARED
many; re-locking with the same (owner, cookie) renews; unlocking
someone else's lock is EPERM (break_lock is the admin override).
RBD/RGW use this for image and bucket-index ownership.
"""

from __future__ import annotations

import json
import time

from ceph_tpu_torch.cls import (
    ClsError,
    EBUSY,
    EINVAL,
    ENOATTR,
    ENOENT,
    MethodContext,
    RD,
    WR,
    as_text,
)

EXCLUSIVE = "exclusive"
SHARED = "shared"


def _attr(name: str) -> str:
    return f"lock.{name}"


async def _load(ctx: MethodContext, name: str) -> dict:
    try:
        st = json.loads(await ctx.getxattr(_attr(name)))
    except ClsError as e:
        if e.rc in (ENOENT, ENOATTR):
            return {"type": None, "tag": "", "lockers": {}}
        # EIO/EAGAIN etc: the lock state is UNKNOWN, not absent —
        # treating it as unlocked would grant a second exclusive owner
        raise
    # expiry (the reference lock_info_t expiration,
    # src/cls/lock/cls_lock.cc:147 remove expired): a locker taken
    # with duration>0 that outlived it is dropped on load, so a
    # crashed client can never brick the object forever
    now = time.time()
    expired = [k for k, v in st["lockers"].items()
               if v.get("expires", 0) and v["expires"] < now]
    for k in expired:
        del st["lockers"][k]
    if not st["lockers"]:
        st["type"] = None
    return st


def _key(owner: str, cookie: str) -> str:
    return f"{owner}\x00{cookie}"


async def _store(ctx: MethodContext, name: str, st: dict) -> None:
    """Persist lock state, creating the object if needed (a WR exec
    on a nonexistent object creates it, like the reference)."""
    raw = json.dumps(st).encode()
    try:
        await ctx.setxattr(_attr(name), raw)
    except ClsError as e:
        if e.rc != ENOENT:
            raise
        await ctx.write_full(b"")
        await ctx.setxattr(_attr(name), raw)


async def lock(ctx: MethodContext, data: bytes) -> bytes:
    req = json.loads(as_text(data))
    name = req["name"]
    ltype = req.get("type", EXCLUSIVE)
    if ltype not in (EXCLUSIVE, SHARED):
        raise ClsError(EINVAL, f"bad lock type {ltype!r}")
    owner, cookie = req["owner"], req.get("cookie", "")
    tag = req.get("tag", "")
    st = await _load(ctx, name)
    me = _key(owner, cookie)
    if st["lockers"]:
        if st["tag"] != tag:
            raise ClsError(EBUSY, "held with a different tag")
        if me in st["lockers"]:
            # renewal; a type change is only legal for a SOLE locker —
            # upgrading shared->exclusive over other holders would hand
            # out exclusivity that isn't exclusive
            others = set(st["lockers"]) - {me}
            if ltype != st["type"] and others:
                raise ClsError(EBUSY,
                               "type change with other lockers held")
            st["type"] = ltype
        elif st["type"] == EXCLUSIVE or ltype == EXCLUSIVE:
            raise ClsError(EBUSY, "conflicting lock held")
    else:
        st["type"] = ltype
    st["tag"] = tag
    duration = float(req.get("duration", 0) or 0)
    st["lockers"][me] = {"owner": owner, "cookie": cookie,
                         "expires": time.time() + duration
                         if duration else 0}
    await _store(ctx, name, st)
    return b""


async def unlock(ctx: MethodContext, data: bytes) -> bytes:
    req = json.loads(as_text(data))
    st = await _load(ctx, req["name"])
    me = _key(req["owner"], req.get("cookie", ""))
    if me not in st["lockers"]:
        raise ClsError(ENOENT, "not held by this owner/cookie")
    del st["lockers"][me]
    if not st["lockers"]:
        st["type"] = None
    await _store(ctx, req["name"], st)
    return b""


async def break_lock(ctx: MethodContext, data: bytes) -> bytes:
    """Admin override: evict a named locker (cls_lock break_lock)."""
    req = json.loads(as_text(data))
    st = await _load(ctx, req["name"])
    victim = _key(req["locker"], req.get("cookie", ""))
    if victim not in st["lockers"]:
        raise ClsError(ENOENT, "no such locker")
    del st["lockers"][victim]
    if not st["lockers"]:
        st["type"] = None
    await _store(ctx, req["name"], st)
    return b""


async def get_info(ctx: MethodContext, data: bytes) -> bytes:
    req = json.loads(as_text(data))
    st = await _load(ctx, req["name"])
    return json.dumps(st).encode()


def register(handler) -> None:
    handler.register("lock", "lock", RD | WR, lock)
    handler.register("lock", "unlock", RD | WR, unlock)
    handler.register("lock", "break_lock", RD | WR, break_lock)
    handler.register("lock", "get_info", RD, get_info)
