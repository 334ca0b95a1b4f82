"""ceph-erasure-code-tool parity CLI (port of
ceph_tpu/tools/erasure_code_tool.py).

The reference's src/tools/erasure-code/ceph-erasure-code-tool.cc, with
the same subcommands and file conventions:

    test-plugin-exists <plugin>
    validate-profile <profile> [<display-param> ...]
    calc-chunk-size <profile> <object_size>
    encode <profile> <stripe_unit> <want_to_encode> <fname>
    decode <profile> <stripe_unit> <want_to_decode> <fname>

profile is a comma-separated key=value list; encode reads {fname} and
writes {fname}.{shard}; decode reads {fname}.{shard} and writes {fname}.
The files are byte for byte those of the JAX package's tool.  Codecs run
on the card unless `run` is given a device (or the profile names one,
`device=cpu`); with no CUDA and no device they raise.
"""


from __future__ import annotations

import sys
from typing import Dict, List

from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.osd import ec_util

USAGE = """\
usage: ceph-erasure-code-tool test-plugin-exists <plugin>
       ceph-erasure-code-tool validate-profile <profile> [<display-param> ...]
       ceph-erasure-code-tool calc-chunk-size <profile> <object_size>
       ceph-erasure-code-tool encode <profile> <stripe_unit> <want_to_encode> <fname>
       ceph-erasure-code-tool decode <profile> <stripe_unit> <want_to_decode> <fname>
"""

DISPLAY_PARAMS = ("chunk_count", "data_chunk_count", "coding_chunk_count")


def usage(message: str = "") -> int:
    if message:
        print(message, file=sys.stderr)
    print(USAGE, file=sys.stderr)
    return 1


def parse_profile(profile_str: str) -> Dict[str, str]:
    profile: Dict[str, str] = {}
    for opt in profile_str.replace(" ", ",").split(","):
        if not opt:
            continue
        if "=" not in opt:
            raise ValueError(f"invalid profile entry {opt!r}")
        key, val = opt.split("=", 1)
        profile[key] = val
    if "plugin" not in profile:
        raise ValueError("invalid profile: plugin not specified")
    return profile


def make_codec(profile_str: str, device=None):
    profile = parse_profile(profile_str)
    if device is not None:
        profile.setdefault("device", str(device))
    return ErasureCodePluginRegistry.instance().factory(
        profile["plugin"], profile)


def make_sinfo(codec, stripe_unit_str: str) -> ec_util.StripeInfo:
    stripe_unit = int(stripe_unit_str)
    if stripe_unit <= 0:
        raise ValueError("invalid stripe unit")
    k = codec.get_data_chunk_count()
    return ec_util.StripeInfo(k, k * stripe_unit)


def do_test_plugin_exists(args: List[str], device=None) -> int:
    if len(args) < 1:
        return usage("not enough arguments")
    if ErasureCodePluginRegistry.instance().get(args[0]) is None:
        # the plugins are built in: no module to load, ENOENT as the
        # JAX registry's load gives for a missing one
        print(f"no erasure-code plugin {args[0]}", file=sys.stderr)
        return 2
    return 0


def do_validate_profile(args: List[str], device=None) -> int:
    if len(args) < 1:
        return usage("not enough arguments")
    try:
        codec = make_codec(args[0], device)
    except (ValueError, ErasureCodeError) as e:
        return usage(f"invalid profile: {e}")
    values = {
        "chunk_count": codec.get_chunk_count(),
        "data_chunk_count": codec.get_data_chunk_count(),
        "coding_chunk_count": codec.get_coding_chunk_count(),
    }
    if len(args) == 1:
        for name in DISPLAY_PARAMS:
            print(f"{name}={values[name]}")
    else:
        for name in args[1:]:
            if name not in values:
                return usage(f"unknown display-param {name}")
            print(values[name])
    return 0


def do_calc_chunk_size(args: List[str], device=None) -> int:
    if len(args) < 2:
        return usage("not enough arguments")
    codec = make_codec(args[0], device)
    print(codec.get_chunk_size(int(args[1])))
    return 0


def do_encode(args: List[str], device=None) -> int:
    if len(args) < 4:
        return usage("not enough arguments")
    codec = make_codec(args[0], device)
    sinfo = make_sinfo(codec, args[1])
    want = {int(s) for s in args[2].split(",")}
    fname = args[3]
    try:
        with open(fname, "rb") as f:
            data = f.read()
    except OSError as e:
        print(f"failed to read {fname}: {e}", file=sys.stderr)
        return 1
    width = sinfo.get_stripe_width()
    if len(data) % width:
        data += bytes(width - len(data) % width)
    encoded = ec_util.encode(sinfo, codec, data, want)
    for shard, buf in encoded.items():
        name = f"{fname}.{shard}"
        try:
            with open(name, "wb") as f:
                f.write(buf)
        except OSError as e:
            print(f"failed to write {name}: {e}", file=sys.stderr)
            return 1
    return 0


def do_decode(args: List[str], device=None) -> int:
    if len(args) < 4:
        return usage("not enough arguments")
    codec = make_codec(args[0], device)
    sinfo = make_sinfo(codec, args[1])
    shards = [int(s) for s in args[2].split(",")]
    fname = args[3]
    encoded: Dict[int, bytes] = {}
    for shard in shards:
        name = f"{fname}.{shard}"
        try:
            with open(name, "rb") as f:
                encoded[shard] = f.read()
        except OSError as e:
            print(f"failed to read {name}: {e}", file=sys.stderr)
            return 1
    try:
        decoded = ec_util.decode(sinfo, codec, encoded)
    except ErasureCodeError as e:
        print(f"failed to decode: {e}", file=sys.stderr)
        return 1
    try:
        with open(fname, "wb") as f:
            f.write(decoded)
    except OSError as e:
        print(f"failed to write {fname}: {e}", file=sys.stderr)
        return 1
    return 0


def run(argv: List[str], device=None) -> int:
    if not argv:
        return usage()
    cmd, args = argv[0], argv[1:]
    handlers = {
        "test-plugin-exists": do_test_plugin_exists,
        "validate-profile": do_validate_profile,
        "calc-chunk-size": do_calc_chunk_size,
        "encode": do_encode,
        "decode": do_decode,
    }
    handler = handlers.get(cmd)
    if handler is None:
        return usage(f"unknown command {cmd!r}")
    try:
        return handler(args, device)
    except (ValueError, ErasureCodeError) as e:
        return usage(str(e))


def main() -> None:
    sys.exit(run(sys.argv[1:]))


if __name__ == "__main__":
    main()
