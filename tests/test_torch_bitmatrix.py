"""The port's bitmatrix codecs (ceph_tpu_torch/ec/bitmatrix_plugin.py:
liberation, blaum_roth, liber8tion) against the JAX package's
`ErasureCodeJaxBitmatrix`, on the CPU.

Each profile is built through both registries, under every plugin name
that routes it (`ec_torch` / `ec_jax`, `jerasure`, `isa`).  Chunks, every
one- and two-erasure decode, the profile echo, the parameter errors and
the chunk-mapping layout are held to the JAX codec's, on each of the
port's executors: the native tape of a `device="cpu"` codec, its host
tier (CEPH_TPU_NATIVE_XSCHED=0), the naive row-walk (CEPH_TPU_XSCHED=0),
and the device path a CUDA codec takes (`_run_device`: the staged arena
and the `xor_sched` region entry, here its plain version on a CPU
tensor), for single- and multi-block chunks.  The codec tools accept the
techniques as the JAX tools do, and a liberation pool through live
daemons ends in the JAX cluster's stores, alone and in a cluster whose
OSDs and clients are of both packages.  Bytes and errnos: exact equality.
"""

import asyncio
import itertools

import numpy as np
import pytest

from ceph_tpu.ec.interface import ErasureCodeError as JErasureCodeError
from ceph_tpu.ec.registry import create_erasure_code as jcreate
from ceph_tpu.tools import erasure_code_tool as ject
from ceph_tpu_torch.ec import dispatch, xsched
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import create_erasure_code
from ceph_tpu_torch.tools import erasure_code_benchmark as tbench
from ceph_tpu_torch.tools import erasure_code_tool as tect

import test_torch_osd
from torch_cluster_helpers import Cluster
from torch_cluster_helpers import one_torch_thread  # noqa: F401

SEED = 20261018
TRIO_W = {"liberation": 7, "blaum_roth": 6, "liber8tion": 8}
# (technique, k, packetsize, blocks a chunk holds in the test payload)
GEOMETRIES = [("liberation", 2, 32, 1), ("liberation", 4, 64, 3),
              ("liberation", 7, 16, 2), ("blaum_roth", 3, 48, 1),
              ("blaum_roth", 6, 32, 2), ("liber8tion", 4, 32, 2),
              ("liber8tion", 8, 16, 1)]
EXECUTORS = ("native", "host", "naive", "device")


def _profile(technique: str, k: int, ps: int, plugin: str = "jerasure",
             **extra) -> dict:
    return {"plugin": plugin, "technique": technique, "k": str(k),
            "m": "2", "packetsize": str(ps), **extra}


def _pair(profile: dict):
    return create_erasure_code({**profile, "device": "cpu"}), \
        jcreate(dict(profile))


def _device_run(codec):
    """The codec's `_run` as a CUDA codec takes it (the compiled tape,
    or the naive rows' tape under the kill switch, over a staged arena
    and the region entry), on CPU tensors."""
    def run(rows, sig, src, dst):
        prog = (xsched.lower_program(xsched.compile_matrix(rows, sig=sig))
                if xsched.enabled() else xsched.naive_program(rows, sig))
        codec._run_device(prog, src, dst)
    return run


def _use(executor: str, codec, monkeypatch) -> None:
    if executor == "host":
        monkeypatch.setenv("CEPH_TPU_NATIVE_XSCHED", "0")
    elif executor == "naive":
        monkeypatch.setenv("CEPH_TPU_XSCHED", "0")
    elif executor == "device":
        monkeypatch.setattr(codec, "_run", _device_run(codec))


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("technique,k,ps,blocks", GEOMETRIES)
def test_encode_and_every_decode_equal_jax(monkeypatch, executor, technique,
                                           k, ps, blocks):
    tc, jc = _pair(_profile(technique, k, ps))
    _use(executor, tc, monkeypatch)
    assert np.array_equal(tc.bitmatrix, jc.bitmatrix)
    n = k + 2
    data = np.random.default_rng(SEED + k).bytes(
        blocks * tc.get_alignment() - 7)
    tchunks = tc.encode(range(n), data)
    jchunks = jc.encode(range(n), data)
    assert [bytes(tchunks[i]) for i in range(n)] == \
        [bytes(jchunks[i]) for i in range(n)]
    size = len(jchunks[0])
    assert size == blocks * TRIO_W[technique] * ps
    for lost in itertools.chain.from_iterable(
            itertools.combinations(range(n), r) for r in (1, 2)):
        have = {i: bytes(jchunks[i]) for i in range(n) if i not in lost}
        got = tc.decode(set(range(n)), have, size)
        assert {i: bytes(got[i]) for i in range(n)} == \
            {i: bytes(jchunks[i]) for i in range(n)}, lost
        assert tc.decode_concat(have) == jc.decode_concat(have)


@pytest.mark.parametrize("plugin,jplugin", [("ec_torch", "ec_jax"),
                                            ("jerasure", "jerasure"),
                                            ("isa", "isa")])
@pytest.mark.parametrize("technique", sorted(TRIO_W))
def test_every_alias_builds_the_bitmatrix_codec(plugin, jplugin, technique):
    tc = create_erasure_code({"plugin": plugin, "technique": technique,
                              "k": "4", "m": "2", "device": "cpu"})
    jc = jcreate({"plugin": jplugin, "technique": technique, "k": "4",
                  "m": "2"})
    assert type(tc).__name__ == "ErasureCodeTorchBitmatrix"
    assert type(jc).__name__ == "ErasureCodeJaxBitmatrix"
    assert {k: v for k, v in tc.get_profile().items()
            if k not in ("device", "plugin")} == \
        {k: v for k, v in jc.get_profile().items() if k != "plugin"}
    assert (tc.w, tc.packetsize, tc.get_alignment(), tc.get_chunk_count(),
            tc.get_chunk_size(1 << 20)) == \
        (jc.w, jc.packetsize, jc.get_alignment(), jc.get_chunk_count(),
         jc.get_chunk_size(1 << 20))
    assert tc._sig == jc._sig
    assert tc.device.type == "cpu"


BAD_PROFILES = [
    {"technique": "liberation", "k": "4", "m": "2", "w": "6"},
    {"technique": "liberation", "k": "8", "m": "2", "w": "7"},
    {"technique": "blaum_roth", "k": "4", "m": "2", "w": "7"},
    {"technique": "liber8tion", "k": "4", "m": "2", "w": "7"},
    {"technique": "liberation", "k": "4", "m": "3"},
    {"technique": "liberation", "k": "1", "m": "2"},
    {"technique": "liberation", "k": "4", "m": "2", "mapping": "DD_"},
    {"technique": "liberation", "k": "x", "m": "2"},
]


@pytest.mark.parametrize("bad", BAD_PROFILES)
def test_parameter_errors_equal_jax(bad):
    profile = {"plugin": "jerasure", **bad}
    with pytest.raises(ErasureCodeError) as mine:
        create_erasure_code({**profile, "device": "cpu"})
    with pytest.raises(JErasureCodeError) as ref:
        jcreate(dict(profile))
    assert mine.value.errno == ref.value.errno


@pytest.mark.parametrize("executor", EXECUTORS)
def test_chunk_mapping_layout_equals_jax(monkeypatch, executor):
    tc, jc = _pair(_profile("liberation", 4, 32, mapping="D_DDD_"))
    _use(executor, tc, monkeypatch)
    n = 6
    data = np.random.default_rng(9).bytes(tc.get_alignment() * 2 - 5)
    tchunks, jchunks = tc.encode(range(n), data), jc.encode(range(n), data)
    assert {i: bytes(b) for i, b in tchunks.items()} == \
        {i: bytes(b) for i, b in jchunks.items()}
    avail = {i: bytes(jchunks[i]) for i in list(jchunks)[:4]}
    assert tc.decode_concat(avail) == jc.decode_concat(avail)


def test_kill_switch_compiles_nothing_and_decode_rows_are_shared(
        monkeypatch):
    """CEPH_TPU_XSCHED=0 on a CPU codec compiles no schedule (the naive
    row-walk); a fresh codec instance reuses another's inverted decode
    rows (ec/dispatch.py's process-wide cache)."""
    monkeypatch.setenv("CEPH_TPU_XSCHED", "0")
    xsched.reset_stats()
    c1, _ = _pair(_profile("liberation", 3, 16, w="5"))
    data = np.random.default_rng(3).bytes(c1.get_alignment())
    enc = c1.encode(range(5), data)
    avail = {i: bytes(enc[i]) for i in range(2, 5)}
    c1.decode(set(range(5)), avail, len(enc[0]))
    assert xsched.stats()["compiled"] == 0
    hits = dispatch.decode_rows_stats()["hits"]
    c2, _ = _pair(_profile("liberation", 3, 16, w="5"))
    out = c2.decode(set(range(5)), avail, len(enc[0]))
    assert dispatch.decode_rows_stats()["hits"] > hits
    assert all(bytes(out[i]) == bytes(enc[i]) for i in range(5))


def test_device_path_lowers_naive_rows_above_the_compile_bound(
        monkeypatch):
    """A CUDA codec never leaves the kernel: above host_compile_allowed
    (and under CEPH_TPU_XSCHED=0) its rows run as the naive program's
    tape, with the JAX codec's bytes."""
    tc, jc = _pair(_profile("liber8tion", 8, 16))
    monkeypatch.setenv("CEPH_TPU_XSCHED_HOST_MAX_ONES", "10")
    assert not xsched.host_compile_allowed(tc.bitmatrix)
    _use("device", tc, monkeypatch)
    xsched.reset_stats()
    data = np.random.default_rng(4).bytes(2 * tc.get_alignment())
    want = jc.encode(range(10), data)
    got = tc.encode(range(10), data)
    assert [bytes(got[i]) for i in range(10)] == \
        [bytes(want[i]) for i in range(10)]
    prog = xsched.naive_program(tc.bitmatrix, tc._sig)
    # no temporaries: one op per output row, one more per extra column
    assert prog.n_slots == 0 and prog.n_ops == sum(
        max(int(row.sum()) - 1, 1) for row in tc.bitmatrix)


@pytest.mark.parametrize("technique", sorted(TRIO_W))
def test_codec_tools_accept_the_techniques(capsys, technique):
    """erasure_code_tool answers as the JAX tool does; the benchmark
    encodes and decodes exhaustively (its own check of every decode)."""
    prof = f"plugin=jerasure,technique={technique},k=4,m=2,packetsize=64"
    for argv in (["validate-profile", prof],
                 ["calc-chunk-size", prof, "100000"]):
        rc = tect.run(list(argv), device="cpu")
        mine = capsys.readouterr().out
        assert rc == ject.run(list(argv)) == 0
        assert mine == capsys.readouterr().out
    for work in (["-w", "encode"], ["-w", "decode", "-e", "2", "-E",
                                    "exhaustive"]):
        assert tbench.run(["-p", "jerasure", "-P", f"technique={technique}",
                           "-P", "k=4", "-P", "m=2", "-s", "65536",
                           *work], device="cpu") == 0
    assert "xor_sched_regions=0" in capsys.readouterr().err


# -- through live daemons ----------------------------------------------------

def _lib_profile(kind: str) -> dict:
    return {"plugin": "ec_jax" if kind == "jax" else "ec_torch",
            "technique": "liberation", "k": "4", "m": "2", "w": "7",
            "packetsize": "64", "crush-failure-domain": "osd"}


def test_liberation_pool_through_daemons_equals_jax():
    """One workload on a JAX cluster and on a port cluster: writes,
    reads, an overwrite, a degraded read and a recovery after a kill;
    replies and every store equal."""
    async def workload(cluster, kind):
        await cluster.client.create_ec_pool("lib", _lib_profile(kind),
                                            pg_num=8)
        await cluster.wait_for_clean()
        io = cluster.client.open_ioctx("lib")
        payloads = {f"o{i}": test_torch_osd.rand(70 + i, 5000 + 9999 * i)
                    for i in range(5)}
        replies = []
        for name, data in payloads.items():
            await io.write_full(name, data)
        for name in payloads:
            replies.append(await io.read(name))
        await io.write("o2", b"q" * 3000, 2500)
        replies.append(await io.read("o2"))
        await cluster.kill_osd(1)
        await cluster.mark_down(1)
        for name in payloads:
            replies.append(await io.read(name))
        return replies

    test_torch_osd.both(workload, num_osds=6, osds_per_host=1)


def test_liberation_pool_in_a_mixed_cluster():
    """OSDs and clients of both packages in one liberation pool: each
    reads the other's bytes, healthy and with one OSD of each kind
    killed and marked down."""
    kinds = ["torch", "jax"] * 3

    async def main():
        cluster = Cluster(num_osds=6, osds_per_host=1, kinds=kinds,
                          mon_kind="torch", client_kind="torch")
        await cluster.start()
        other = cluster.new_client("jax")
        await other.connect()
        try:
            await cluster.client.create_ec_pool(
                "lib", {**_lib_profile("torch"), "plugin": "jerasure"},
                pg_num=8)
            await cluster.wait_for_clean()
            ios = (cluster.client.open_ioctx("lib"), other.open_ioctx("lib"))
            payloads = {f"o{i}": test_torch_osd.rand(90 + i,
                                                     30_000 + 777 * i)
                        for i in range(6)}
            for i, (name, data) in enumerate(payloads.items()):
                await ios[i % 2].write_full(name, data)
            for io in ios:
                for name, data in payloads.items():
                    assert await io.read(name) == data
            for victim in (0, 1):
                await cluster.kill_osd(victim)
                await cluster.mark_down(victim)
            await cluster.wait_for_clean()
            for io in ios:
                for name, data in payloads.items():
                    assert await io.read(name) == data
        finally:
            await other.shutdown()
            await cluster.stop()

    asyncio.run(asyncio.wait_for(main(), 180))
