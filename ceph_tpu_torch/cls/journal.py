"""cls_journal: epoch-fenced append log on one object.

The MDS journal's server-side half (the roles of
Ceph's src/cls/journal/cls_journal.cc — client registration
and fencing for journal objects — collapsed onto the omap surface this
framework's journals use).

Fencing model: the object carries an "epoch" xattr.  `take_over` bumps
it and returns the new value; `append`/`set_applied`/`trim` REQUIRE the
caller's epoch to equal the stored one.  RADOS serializes ops per
object, so after a take_over commits, every in-flight or later call
from the deposed epoch fails with EPERM — the mutation never lands,
which is what makes a deposed MDS harmless without trusting any clock
(the ADVICE finding: wall-clock staleness comparison cannot fence).

omap layout:
  e<seq:020d>  one journal entry (opaque payload)
  (xattr) epoch    fencing epoch, decimal
  (xattr) applied  highest seq known applied to the backing objects
"""

from __future__ import annotations

import json

from ceph_tpu_torch.cls import ClsError, EINVAL, EPERM, MethodContext, RD, WR, as_text

ENTRY_PREFIX = "e"


def entry_key(seq: int) -> str:
    return f"{ENTRY_PREFIX}{seq:020d}"


async def _stored_epoch(ctx: MethodContext) -> int:
    try:
        return int((await ctx.getxattr("epoch")).decode())
    except ClsError:
        return 0


def _check_epoch(stored: int, claimed) -> int:
    try:
        claimed = int(claimed)
    except (TypeError, ValueError):
        raise ClsError(EINVAL, "bad epoch")
    if claimed != stored:
        raise ClsError(EPERM,
                       f"fenced: epoch {claimed} != {stored}")
    return claimed


async def take_over(ctx: MethodContext, data: bytes) -> bytes:
    """Bump the fencing epoch; returns the new epoch.  Everything the
    previous epoch tries afterwards fails EPERM."""
    epoch = await _stored_epoch(ctx) + 1
    # first takeover ever: materialize the journal object (omap_set
    # carries a create op; setxattr alone would ENOENT)
    await ctx.omap_set({})
    await ctx.setxattr("epoch", str(epoch).encode())
    return str(epoch).encode()


async def get_state(ctx: MethodContext, data: bytes) -> bytes:
    try:
        applied = int((await ctx.getxattr("applied")).decode())
    except ClsError:
        applied = 0
    return json.dumps({"epoch": await _stored_epoch(ctx),
                       "applied": applied}).encode()


async def append(ctx: MethodContext, data: bytes) -> bytes:
    """{epoch, seq, entry}: fenced, durable journal append."""
    req = json.loads(as_text(data))
    _check_epoch(await _stored_epoch(ctx), req.get("epoch"))
    try:
        seq = int(req["seq"])
        entry = req["entry"]
    except (KeyError, ValueError, TypeError):
        raise ClsError(EINVAL, "bad append")
    await ctx.omap_set({entry_key(seq): json.dumps(entry).encode()})
    return b""


async def set_applied(ctx: MethodContext, data: bytes) -> bytes:
    """{epoch, applied, from}: advance the applied watermark and trim
    entries in (from, applied] (fenced — a deposed trim could
    otherwise erase entries the new active has not replayed).  The
    caller supplies its previous watermark so trimming is O(trimmed),
    never a full-journal read."""
    req = json.loads(as_text(data))
    _check_epoch(await _stored_epoch(ctx), req.get("epoch"))
    try:
        applied = int(req["applied"])
        low = int(req.get("from", 0))
    except (KeyError, ValueError, TypeError):
        raise ClsError(EINVAL, "bad applied")
    await ctx.setxattr("applied", str(applied).encode())
    dead = [entry_key(s) for s in range(low + 1, applied + 1)]
    if dead:
        await ctx.omap_rm_keys(dead)
    return b""


async def guarded_update(ctx: MethodContext, data: bytes) -> bytes:
    """{epoch, set: {key: json|null}}: omap update on THIS object,
    refused if a NEWER epoch already stamped it (monotonic "fence"
    xattr).  The apply-phase fence: a deposed active can re-apply only
    state the new active already replayed (idempotent) — any object
    the new epoch has touched refuses the old epoch outright."""
    req = json.loads(as_text(data))
    try:
        epoch = int(req["epoch"])
        updates = req["set"]
    except (KeyError, ValueError, TypeError):
        raise ClsError(EINVAL, "bad guarded_update")
    try:
        stored = int((await ctx.getxattr("fence")).decode())
    except ClsError:
        stored = 0
    if epoch < stored:
        raise ClsError(EPERM, f"fenced: epoch {epoch} < {stored}")
    if epoch > stored:
        # materialize the object first: an xattr on a missing object
        # is ENOENT (the same first-touch shape as take_over)
        await ctx.omap_set({})
        await ctx.setxattr("fence", str(epoch).encode())
    sets = {k: v.encode() if isinstance(v, str) else v
            for k, v in updates.items() if v is not None}
    dels = [k for k, v in updates.items() if v is None]
    if sets:
        await ctx.omap_set(sets)
    elif not dels:
        await ctx.omap_set({})  # pure create
    if dels:
        await ctx.omap_rm_keys(dels)
    return b""


async def guarded_remove(ctx: MethodContext, data: bytes) -> bytes:
    """{epoch}: remove THIS object unless fenced by a newer epoch."""
    req = json.loads(as_text(data))
    try:
        epoch = int(req["epoch"])
    except (KeyError, ValueError, TypeError):
        raise ClsError(EINVAL, "bad epoch")
    try:
        stored = int((await ctx.getxattr("fence")).decode())
    except ClsError:
        stored = 0
    if epoch < stored:
        raise ClsError(EPERM, f"fenced: epoch {epoch} < {stored}")
    await ctx.remove()
    return b""


def register(handler) -> None:
    handler.register("journal", "take_over", RD | WR, take_over)
    handler.register("journal", "get_state", RD, get_state)
    handler.register("journal", "append", RD | WR, append)
    handler.register("journal", "set_applied", RD | WR, set_applied)
    handler.register("journal", "guarded_update", RD | WR,
                     guarded_update)
    handler.register("journal", "guarded_remove", RD | WR,
                     guarded_remove)
