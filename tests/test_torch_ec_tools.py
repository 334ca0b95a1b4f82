"""The port's codec CLIs (ceph_tpu_torch.tools.erasure_code_benchmark,
erasure_code_tool and non_regression) against the JAX package's, on the
CPU.

Each tool is driven through its run(argv) entry with `device="cpu"` (the
GF kernels' plain versions).  A non-regression archive written by one
package's tool must check clean under the other's, for every plugin name
both registries know; the erasure-code tool's files must be byte for
byte the JAX tool's.  The tolerance is exact equality.
"""

import contextlib
import io
import os
import random
from pathlib import Path

import numpy as np
import pytest
from test_torch_codecs import restore_registered_generators  # noqa: F401

from ceph_tpu.tools import erasure_code_tool as ject
from ceph_tpu.tools import non_regression as jnr
from ceph_tpu_torch.tools import erasure_code_benchmark as tecb
from ceph_tpu_torch.tools import erasure_code_tool as tect
from ceph_tpu_torch.tools import non_regression as tnr

CPU = "cpu"
# the plugin names both registries know, each with a profile
SHARED = {
    "jerasure": ["k=2", "m=2", "technique=reed_sol_van"],
    "isa": ["k=4", "m=2"],
    "lrc": ["k=4", "m=2", "l=3"],
    "shec": ["k=4", "m=3", "c=2"],
    "clay": ["k=4", "m=2", "d=5"],
    "ec_msr": ["k=4", "m=3", "d=6"],
}
TOOLS = {"jax": lambda argv: jnr.run(argv),
         "port": lambda argv: tnr.run(argv, device=CPU)}


def _nr_args(plugin: str, base) -> list:
    args = ["--plugin", plugin, "--base", str(base)]
    for param in SHARED[plugin]:
        args += ["-P", param]
    return args


@pytest.mark.parametrize("plugin", SHARED)
@pytest.mark.parametrize("maker,checker", [("jax", "port"), ("port", "jax")])
def test_non_regression_archive_crosses_packages(tmp_path, plugin, maker,
                                                 checker):
    random.seed(plugin)  # the tools draw the archive's content from random
    args = _nr_args(plugin, tmp_path)
    assert TOOLS[maker](args + ["--create"]) == 0
    (archive,) = os.listdir(tmp_path)
    assert archive.startswith(f"plugin={plugin} stripe-width=4096")
    assert "device" not in archive
    assert TOOLS[checker](args + ["--check"]) == 0


@pytest.mark.parametrize("plugin", ["jerasure", "lrc", "clay"])
def test_non_regression_detects_corruption(tmp_path, plugin):
    """A flipped byte in one archived chunk fails the port's --check, on
    an archive the port wrote and on one the JAX tool wrote."""
    for maker in ("port", "jax"):
        base = tmp_path / maker
        args = _nr_args(plugin, base)
        assert TOOLS[maker](args + ["--create"]) == 0
        archive = base / os.listdir(base)[0]
        with open(archive / "1", "r+b") as f:
            f.seek(10)
            byte = f.read(1)
            f.seek(10)
            f.write(bytes([byte[0] ^ 0xFF]))
        assert tnr.run(args + ["--check"], device=CPU) == 1
        assert jnr.run(args + ["--check"]) == 1


def test_non_regression_needs_a_mode(capsys):
    assert tnr.run(["--plugin", "jerasure"], device=CPU) == 1
    assert "--check" in capsys.readouterr().err


EC_TOOL_PROFILES = {
    "rs": "plugin=jerasure,technique=reed_sol_van,k=4,m=2",
    "lrc": "plugin=lrc,k=4,m=2,l=3",
    "clay": "plugin=clay,k=4,m=2,d=5",
}


@pytest.mark.parametrize("name", EC_TOOL_PROFILES)
def test_ec_tool_files_match_jax(tmp_path, name):
    profile = EC_TOOL_PROFILES[name]
    data = np.random.default_rng(7).integers(0, 256, 100_000,
                                             dtype=np.uint8).tobytes()
    runs = {"jax": lambda argv: ject.run(argv),
            "port": lambda argv: tect.run(argv, device=CPU)}
    files = {}
    for pkg, run in runs.items():
        fname = str(tmp_path / f"{pkg}.obj")
        with open(fname, "wb") as f:
            f.write(data)
        n = int(_validated(run, profile))
        shards = ",".join(str(i) for i in range(n))
        assert run(["encode", profile, "4096", shards, fname]) == 0
        files[pkg] = {i: Path(f"{fname}.{i}").read_bytes()
                      for i in range(n)}
        # decode from all but two shards
        os.unlink(fname)
        keep = ",".join(str(i) for i in range(2, n))
        assert run(["decode", profile, "4096", keep, fname]) == 0
        files[pkg]["decoded"] = Path(fname).read_bytes()
    assert files["port"] == files["jax"]
    assert files["port"]["decoded"][:len(data)] == data


def _validated(run, profile):
    """The profile's chunk count, through validate-profile."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run(["validate-profile", profile, "chunk_count"]) == 0
    return buf.getvalue().strip()


@pytest.mark.parametrize("argv", [
    ["test-plugin-exists", "lrc"], ["test-plugin-exists", "nope"],
    ["validate-profile", "plugin=shec,k=4,m=3,c=2"],
    ["validate-profile", "plugin=clay,k=8,m=4,d=11", "chunk_count",
     "data_chunk_count"],
    ["validate-profile", "plugin=lrc,k=4,m=2,l=4"],
    ["calc-chunk-size", "plugin=ec_msr,k=4,m=3,d=6", "100000"],
    ["calc-chunk-size", "plugin=clay,k=4,m=2,d=5", "1"],
    [], ["bogus-command"]])
def test_ec_tool_answers_match_jax(capsys, argv):
    want_rc = ject.run(list(argv))
    want = capsys.readouterr().out
    assert tect.run(list(argv), device=CPU) == want_rc
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("argv", [
    ["-p", "jerasure", "-P", "k=4", "-P", "m=2", "-s", "65536", "-i", "2"],
    ["-w", "decode", "-p", "jerasure", "-P", "k=4", "-P", "m=2",
     "-s", "16384", "-i", "3", "-e", "2"],
    ["-w", "decode", "-p", "lrc", "-P", "k=4", "-P", "m=2", "-P", "l=3",
     "-s", "16384", "-E", "exhaustive", "-e", "2"],
    ["-w", "decode", "-p", "clay", "-P", "k=4", "-P", "m=2", "-P", "d=5",
     "-s", "32768", "--erased", "1"],
    ["-p", "shec", "-s", "32768"],
    ["-w", "decode", "-p", "ec_msr", "-P", "k=4", "-P", "m=3", "-P", "d=6",
     "-s", "32768", "-e", "3"]],
    ids=["rs encode", "rs decode", "lrc exhaustive", "clay erased",
         "shec encode", "msr decode"])
def test_benchmark_lines(capsys, argv):
    """The reference's stdout contract, `<seconds>\\t<KiB>` as the last
    line, and the kernel launches on stderr (all zero here: on the CPU
    the wrappers run their plain versions, which are no launches)."""
    assert tecb.run(argv, device=CPU) == 0
    out, err = capsys.readouterr()
    seconds, kib = out.strip().splitlines()[-1].split("\t")
    assert float(seconds) > 0 and len(seconds.split(".")[1]) == 6
    args = tecb.parse_args(argv)
    assert int(kib) == args.iterations * (args.size // 1024)
    assert err.strip().splitlines()[-1] == (
        "launches: gf_matmul_spec=0 gf_matmul_gen=0 crc32c_blocks=0"
        " xor_sched_regions=0 xor_sched_gf=0")
