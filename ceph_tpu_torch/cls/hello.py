"""cls_hello: the object-class SDK demo.

Reference: Ceph's src/cls/hello/cls_hello.cc — say_hello
(pure RD compute), record_hello (WR: persists a greeting and refuses a
rewrite with EEXIST), replay (reads it back).
"""

from __future__ import annotations

from ceph_tpu_torch.cls import ClsError, ENOATTR, ENOENT, MethodContext, RD, WR, as_text

EEXIST = -17
GREETING_ATTR = "hello.greeting"


async def say_hello(ctx: MethodContext, data: bytes) -> bytes:
    name = as_text(data) or "world"
    if len(name) > 100:
        raise ClsError(-22, "name too long")
    return f"Hello, {name}!".encode()


async def record_hello(ctx: MethodContext, data: bytes) -> bytes:
    recorded = True
    try:
        await ctx.getxattr(GREETING_ATTR)
    except ClsError as e:
        if e.rc not in (ENOENT, ENOATTR):
            raise  # EIO etc: state UNKNOWN — never clobber
        recorded = False
    if recorded:
        raise ClsError(EEXIST, "already said hello")
    greeting = await say_hello(ctx, data)
    await ctx.write_full(greeting)
    await ctx.setxattr(GREETING_ATTR, greeting)
    return b""


async def replay(ctx: MethodContext, data: bytes) -> bytes:
    return await ctx.getxattr(GREETING_ATTR)


def register(handler) -> None:
    handler.register("hello", "say_hello", RD, say_hello)
    handler.register("hello", "record_hello", RD | WR, record_hello)
    handler.register("hello", "replay", RD, replay)
