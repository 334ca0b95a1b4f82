"""ceph_erasure_code_non_regression parity CLI (port of
ceph_tpu/tools/non_regression.py).

The reference's src/test/erasure-code/ceph_erasure_code_non_regression.cc:
archives encoded chunks per (plugin, profile) under a directory named
from the profile, then `--check` re-encodes the stored content and
compares byte for byte, and checks that every 1- and 2-erasure decode
round-trips (layout `<base>/<profile-dir>/{content,<chunk>}`).  The
directory is named after the plugin, so an archive is shared with the
JAX package's tool under the plugin names both registries know
(jerasure, isa, lrc, shec, clay, ec_msr): one tool's archive checks
clean under the other.  `ec_jax` and `ec_torch` archives are not mapped
onto each other.  Codecs run on the card unless `run` is given a device;
the device never enters the archive's name.
"""


from __future__ import annotations

import argparse
import itertools
import os
import random
import sys
from typing import Dict, List

from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry


def parse_args(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="ceph_erasure_code_non_regression")
    p.add_argument("-s", "--stripe-width", type=int, default=4 * 1024,
                   dest="stripe_width")
    p.add_argument("-p", "--plugin", default="jerasure")
    p.add_argument("--base", default=".")
    p.add_argument("-P", "--parameter", action="append", default=[])
    p.add_argument("--create", action="store_true")
    p.add_argument("--check", action="store_true")
    return p.parse_args(argv)


class NonRegression:
    def __init__(self, args: argparse.Namespace, device=None):
        self.device = device
        self.stripe_width = args.stripe_width
        self.plugin = args.plugin
        self.base = args.base
        self.profile: Dict[str, str] = {"plugin": args.plugin}
        directory = os.path.join(
            self.base,
            f"plugin={args.plugin} stripe-width={args.stripe_width}")
        for param in args.parameter:
            if param.count("=") != 1:
                print(f"--parameter {param} ignored because it does not"
                      " contain exactly one =", file=sys.stderr)
            else:
                key, val = param.split("=")
                self.profile[key] = val
            directory += " " + param
        self.directory = directory

    def codec(self):
        profile = dict(self.profile)
        if self.device is not None:
            profile.setdefault("device", str(self.device))
        return ErasureCodePluginRegistry.instance().factory(
            self.plugin, profile)

    def content_path(self) -> str:
        return os.path.join(self.directory, "content")

    def chunk_path(self, chunk: int) -> str:
        return os.path.join(self.directory, str(chunk))

    def run_create(self) -> int:
        codec = self.codec()
        os.makedirs(self.directory, exist_ok=False)
        payload = bytes(
            ord("a") + random.randrange(26) for _ in range(37))
        reps = -(-self.stripe_width // len(payload))
        content = (payload * reps)[:self.stripe_width]
        with open(self.content_path(), "wb") as f:
            f.write(content)
        want = set(range(codec.get_chunk_count()))
        encoded = codec.encode(want, content)
        for chunk, buf in encoded.items():
            with open(self.chunk_path(chunk), "wb") as f:
                f.write(buf)
        return 0

    def _decode_erasures(self, codec, erasures, chunks) -> int:
        available = {c: b for c, b in chunks.items() if c not in erasures}
        decoded = codec.decode(
            set(erasures), available,
            chunk_size=len(next(iter(available.values()))))
        for erasure in erasures:
            if decoded[erasure] != chunks[erasure]:
                print(f"chunk {erasure} incorrectly recovered",
                      file=sys.stderr)
                return 1
        return 0

    def run_check(self) -> int:
        codec = self.codec()
        with open(self.content_path(), "rb") as f:
            content = f.read()
        want = set(range(codec.get_chunk_count()))
        encoded = codec.encode(want, content)
        for chunk, buf in encoded.items():
            with open(self.chunk_path(chunk), "rb") as f:
                existing = f.read()
            if existing != buf:
                print(f"chunk {chunk} encodes differently than archive",
                      file=sys.stderr)
                return 1
        # decode alone, then two at a time
        for c1 in encoded:
            if self._decode_erasures(codec, {c1}, encoded):
                return 1
        for c1, c2 in itertools.combinations(sorted(encoded), 2):
            if self._decode_erasures(codec, {c1, c2}, encoded):
                return 1
        return 0


def run(argv: List[str], device=None) -> int:
    args = parse_args(argv)
    if not args.create and not args.check:
        print("must specify either --check, or --create", file=sys.stderr)
        return 1
    nr = NonRegression(args, device)
    if args.create:
        ret = nr.run_create()
        if ret:
            return ret
    if args.check:
        return nr.run_check()
    return 0


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
