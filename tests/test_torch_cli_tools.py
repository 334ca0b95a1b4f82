"""The port's cluster tools as processes (ceph_tpu_torch.tools.rados,
ceph_tpu_torch.tools.rbd and ceph_tpu_torch.tools.vstart), on the CPU.

tests/test_cli_tools.py's `test_rados_cli_end_to_end` through `python -m
ceph_tpu_torch.tools.rados --device cpu` against a port cluster; the same
commands against a JAX cluster through the JAX CLI and the port's CLI side
by side (each on its own pool), whose outputs must be equal;
tests/test_cli_tools.py's `test_rbd_cli_end_to_end` through each
package's rbd CLI as seeded processes, on a JAX and on a port cluster,
whose outputs and stores must be equal; and a cluster
of real processes from `python -m ceph_tpu_torch.tools.vstart --device
cpu` (TPUStore OSDs): a put and a get through the port CLI, one OSD
process SIGKILLed (the OS keeps every write it was handed: a process kill,
not a power cut) and marked down, an exact degraded get, the OSD restarted
on its store directory, an exact get again, then `--stop`.  With `--mds`
vstart also starts an active and standby pair of port MDS processes, and
the port's cephfs CLI puts and gets a file through them.
"""

import asyncio
import json
import os
import re
import signal
import subprocess
import sys
import time

import ceph_tpu.rbd as jrbd
import ceph_tpu_torch.rbd as trbd
from torch_cluster_helpers import Cluster
from torch_cluster_helpers import one_torch_thread  # noqa: F401
from torch_rbd_helpers import SEEDED_MAIN, run_workload

_ENV = {"PYTHONPATH": ".", "JAX_PLATFORMS": "cpu",
        "PATH": "/usr/bin:/bin:/usr/local/bin"}
PORT_CLI = ("ceph_tpu_torch.tools.rados", "--device", "cpu")
JAX_CLI = ("ceph_tpu.tools.rados",)


def run(coro, timeout: float = 150):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def cli(tool, mon, *args):
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", *tool, "-m", mon, *args,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_ENV)
    out, err = await proc.communicate()
    return proc.returncode, out, err


def test_rados_cli_end_to_end(tmp_path):
    """put/get/ls/stat/xattr/omap/tell/status through the port's CLI
    binary against a live port cluster."""
    async def main():
        cluster = Cluster(num_osds=3)
        await cluster.start()
        try:
            payload = b"cli payload " * 500
            src = tmp_path / "in.bin"
            src.write_bytes(payload)
            dst = tmp_path / "out.bin"
            mon = cluster.mon.addr

            async def rados(*args):
                return await cli(PORT_CLI, mon, *args)

            rc, out, err = await rados("mkpool", "data", "--size", "2",
                                       "--pg-num", "8")
            assert rc == 0, err
            rc, out, _ = await rados("lspools")
            assert b"data" in out
            rc, _, err = await rados("-p", "data", "put", "obj", str(src))
            assert rc == 0, err
            rc, _, err = await rados("-p", "data", "get", "obj", str(dst))
            assert rc == 0 and dst.read_bytes() == payload
            rc, out, _ = await rados("-p", "data", "ls")
            assert out.decode().split() == ["obj"]
            rc, out, _ = await rados("-p", "data", "stat", "obj")
            assert json.loads(out)["size"] == len(payload)
            rc, _, _ = await rados("-p", "data", "setxattr", "obj", "k", "v")
            rc, out, _ = await rados("-p", "data", "getxattr", "obj", "k")
            assert out == b"v"
            rc, _, _ = await rados("-p", "data", "setomapval", "obj",
                                   "ok", "ov")
            rc, out, _ = await rados("-p", "data", "listomapvals", "obj")
            assert b"ok: ov" in out
            rc, out, _ = await rados("status")
            assert json.loads(out)["num_up_osds"] == 3
            rc, out, _ = await rados("tell", "0", "perf", "dump")
            assert rc == 0 and "subread_bytes" in json.loads(out)
            rc, _, _ = await rados("-p", "data", "rm", "obj")
            rc, out, _ = await rados("-p", "data", "ls")
            assert out.strip() == b""
        finally:
            await cluster.stop()

    run(main())


def _commands(pool: str, src: str, dst: str) -> list:
    return [
        ("mkpool", pool, "--size", "2", "--pg-num", "8"),
        ("-p", pool, "put", "obj", src),
        ("-p", pool, "append", "obj", src),
        ("-p", pool, "get", "obj", dst),
        ("-p", pool, "ls"),
        ("-p", pool, "stat", "obj"),
        ("-p", pool, "setxattr", "obj", "k", "v"),
        ("-p", pool, "getxattr", "obj", "k"),
        ("-p", pool, "listxattr", "obj"),
        ("-p", pool, "setomapval", "obj", "ok", "ov"),
        ("-p", pool, "listomapvals", "obj"),
        ("tell", "0", "perf", "dump"),
        ("-p", pool, "scan", "gf_fold", "obj"),
        ("-p", pool, "rm", "obj"),
        ("-p", pool, "ls"),
        ("lspools",),
        ("health",),
    ]


def _normal(cmd: tuple, out: bytes, pool: str):
    """A command's output with what differs between two runs taken out:
    the pool's name (lspools lists both pools), stat's mtime, and perf
    dump's values (its keys are compared)."""
    text = out.decode("latin-1")
    if cmd[0] != "lspools":
        text = text.replace(pool, "POOL")
    if cmd[0] == "tell":
        return sorted(json.loads(text))
    if "stat" in cmd:
        doc = json.loads(text)
        doc.pop("mtime", None)
        return doc
    return text


def test_port_cli_prints_what_the_jax_cli_prints(tmp_path):
    """The same commands through the JAX CLI and the port's CLI against one
    JAX cluster, side by side on pools of their own: equal return codes
    and equal outputs."""
    payload = bytes(range(256)) * 40

    async def main():
        cluster = Cluster(num_osds=3, kinds=["jax"] * 3, mon_kind="jax",
                          client_kind="jax")
        await cluster.start()
        try:
            runs = {}
            for name, tool in (("jax", JAX_CLI), ("torch", PORT_CLI)):
                (tmp_path / f"{name}.in").write_bytes(payload)
                runs[name] = (tool, f"pool_{name}",
                              _commands(f"pool_{name}",
                                        str(tmp_path / f"{name}.in"),
                                        str(tmp_path / f"{name}.out")))
            got = {"jax": [], "torch": []}
            for step in range(len(runs["jax"][2])):
                outs = await asyncio.gather(*(
                    cli(tool, cluster.mon.addr, *cmds[step])
                    for tool, _pool, cmds in runs.values()))
                for name, (rc, out, err) in zip(runs, outs):
                    cmd = runs[name][2][step]
                    got[name].append((cmd[2] if cmd[0] == "-p" else cmd[0],
                                      rc, _normal(cmd, out, runs[name][1])))
            return got
        finally:
            await cluster.stop()

    got = run(main())
    assert got["torch"] == got["jax"]
    assert all(rc == 0 for _cmd, rc, _out in got["torch"])
    for name in ("jax", "torch"):
        assert (tmp_path / f"{name}.out").read_bytes() == payload * 2


RBD_TOOL = {"jax": ("ceph_tpu.tools.rbd",),
            "torch": ("ceph_tpu_torch.tools.rbd",)}
RADOS_TOOL = {"jax": JAX_CLI, "torch": PORT_CLI}
# what `rbd bench` measures on the wall clock
_BENCH_CLOCK = ("elapsed_s", "ops_per_sec", "mb_per_sec")


def test_rbd_cli_end_to_end(tmp_path):
    """tests/test_cli_tools.py's `test_rbd_cli_end_to_end` through each
    package's rbd CLI as seeded processes, on a JAX and on a port cluster
    (the port's CLI as `python -m ceph_tpu_torch.tools.rbd`): the pools
    made with each package's rados CLI, then create, ls, info, export, snap
    create and protect, clone, flatten, import, mirror to a second pool,
    deep-cp with the snapshot history, migration prepare, execute and
    commit, bench (one op in flight, where the JAX test has 16); the image
    written and read back through each package's RBD API.  Every
    command's exit code and output (bench's wall-clock figures aside),
    every read and every store (but for the order of concurrent ops) equal
    between the runs."""
    rbd_api = {"jax": jrbd.RBD, "torch": trbd.RBD}
    out_path = tmp_path / "disk.bin"

    async def work(cluster, kind):
        mon = cluster.mon.addr
        seeds = iter(range(100))
        replies = []

        async def tool(module, *args):
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-c", SEEDED_MAIN, str(next(seeds)),
                *module, "-m", mon, *args,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_ENV)
            out, err = await proc.communicate()
            return proc.returncode, out, err

        async def rbd_cli(*args, ok=True):
            rc, out, err = await tool(RBD_TOOL[kind], "-p", "rbd", *args)
            assert (rc == 0) == ok, (args, rc, err)
            text = out.decode()
            if args[0] == "bench":
                doc = json.loads(text)
                assert doc["ops_per_sec"] > 0
                text = {k: v for k, v in doc.items()
                        if k not in _BENCH_CLOCK}
            replies.append([list(args), rc, text])
            return text

        await rbd_cli("ls", ok=False)
        # no pool yet: the rados CLI makes both
        for pool in ("rbd", "backup"):
            rc, _, err = await tool(RADOS_TOOL[kind], "mkpool", pool,
                                    "--size", "2", "--pg-num", "4")
            assert rc == 0, err
        await rbd_cli("create", "disk", "--size", "256K", "--order", "14",
                      "--journaling")
        assert "disk" in (await rbd_cli("ls")).split()
        doc = json.loads(await rbd_cli("info", "disk"))
        assert doc["size"] == 256 << 10
        assert "journaling" in doc["features"]

        # write through the API, export through the CLI
        rbd = rbd_api[kind]()
        ioctx = cluster.client.open_ioctx("rbd")
        img = await rbd.open(ioctx, "disk")
        await img.write(0, b"cli export me")
        await img.close()
        await rbd_cli("export", "disk", str(out_path))
        blob = out_path.read_bytes()
        assert blob[:13] == b"cli export me"
        assert len(blob) == 256 << 10

        # snapshot + protect + clone + flatten
        for args in (("snap", "create", "disk@s1"),
                     ("snap", "protect", "disk@s1"),
                     ("clone", "disk@s1", "child")):
            await rbd_cli(*args)
        assert "@s1" in json.loads(await rbd_cli("info", "child"))\
            .get("parent", "")
        await rbd_cli("flatten", "child")
        assert "parent" not in json.loads(await rbd_cli("info", "child"))

        # import round-trips
        await rbd_cli("import", str(out_path), "disk2", "--order", "14")
        assert json.loads(await rbd_cli("info", "disk2"))["size"] \
            == 256 << 10

        # mirror bootstrap+replay to a second pool
        doc = json.loads(await rbd_cli("mirror", "disk", "--dst-pool",
                                       "backup"))
        assert doc["bootstrapped"] is True
        bio = cluster.client.open_ioctx("backup")
        reads = []
        mirrored = await rbd.open(bio, "disk")
        reads.append(await mirrored.read(0, 13))
        await mirrored.close()

        # deep-cp with snapshot history to the backup pool
        await rbd_cli("deep-cp", "disk", "deep", "--dest-pool", "backup")
        deep = await rbd.open(bio, "deep")
        reads.append(await deep.read(0, 13))
        assert [s["name"] for s in await deep.snap_list()] == ["s1"]
        await deep.close()

        # migration prepare/execute/commit through the CLI
        for args in (("migration", "prepare", "disk2", "mig",
                      "--dest-pool", "backup"),
                     ("migration", "execute", "mig", "--dest-pool",
                      "backup"),
                     ("migration", "commit", "mig", "--dest-pool",
                      "backup")):
            await rbd_cli(*args)
        assert "disk2" not in (await rbd_cli("ls")).split()
        mig = await rbd.open(bio, "mig")
        reads.append(await mig.read(0, 13))
        await mig.close()
        assert reads == [b"cli export me"] * 3

        # rbd bench, one op in flight: the journal's entries and its
        # lazily persisted commit position follow the order the ops end in
        doc = await rbd_cli("bench", "disk", "--io-type", "readwrite",
                            "--io-size", "4K", "--io-total", "64K",
                            "--io-threads", "1")
        assert doc["ops"] == 16
        assert doc["reads"] + doc["writes"] == 16
        return replies, [r.hex() for r in reads], blob.hex()

    # deep-cp and migration execute copy objects concurrently: the stores
    # are compared but for the order those writes landed in; no hit set is
    # sealed on the wall clock in either run
    run_workload(work, cluster_kw={"num_osds": 2, "osd_config": {
        "osd_hit_set_period": 3600.0}}, timeout=240, any_order=True)


def test_vstart_cluster_kill_and_restart_an_osd_process(tmp_path):
    """vstart --device cpu --mds: 1 mon, 3 TPUStore OSD processes and an
    active and standby MDS process; the port cephfs CLI puts and gets a
    file; the port CLI puts and gets an object on an EC 2+1 pool; one
    OSD process is SIGKILLed and marked down, the get is exact; the OSD
    is restarted on its store directory, comes up, and the get is exact
    again."""
    from ceph_tpu_torch.rados.client import RadosClient

    data_dir = tmp_path / "vstart"
    up = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.vstart",
         "--data-dir", str(data_dir), "--mons", "1", "--osds", "3",
         "--device", "cpu", "--mds"],
        capture_output=True, env=_ENV, timeout=120)
    assert up.returncode == 0, up.stderr[-2000:]
    mon = re.search(rb"export CEPH_TPU_MON=(\S+)", up.stdout)[1].decode()
    pids_file = data_dir / "vstart.pids"
    pids = [int(p) for p in pids_file.read_text().split()]
    assert len(pids) == 6            # the mon, osd.0-2, then mds.a, mds.b
    restarted = None
    try:
        for i in range(3):
            assert os.path.exists(data_dir / f"osd.{i}" / "block")
        payload = os.urandom(300_000)
        src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
        src.write_bytes(payload)

        async def main():
            nonlocal restarted
            fs_cli = ("ceph_tpu_torch.tools.cephfs",)
            rc, _, err = await cli(fs_cli, mon, "mkdir", "/d")
            assert rc == 0, err
            rc, _, err = await cli(fs_cli, mon, "put", str(src), "/d/f")
            assert rc == 0, err
            rc, out, err = await cli(fs_cli, mon, "cat", "/d/f")
            assert rc == 0 and out == payload, err
            profile = json.dumps({"plugin": "ec_torch",
                                  "technique": "reed_sol_van", "k": "2",
                                  "m": "1", "crush-failure-domain": "osd"})
            rc, _, err = await cli(PORT_CLI, mon, "mkpool", "ec",
                                   "--pg-num", "4", "--ec-profile", profile)
            assert rc == 0, err
            rc, _, err = await cli(PORT_CLI, mon, "-p", "ec", "put", "obj",
                                   str(src))
            assert rc == 0, err
            client = RadosClient(mon, device="cpu")
            await client.connect()
            try:
                io = client.open_ioctx("ec")
                acting, primary = client.osdmap.pg_to_acting_osds(
                    io.object_pg("obj"))
                victim = next(o for o in acting if o != primary)
                os.kill(pids[1 + victim], signal.SIGKILL)
                rc, out = await client.mon_command(
                    {"prefix": "osd down", "osd": victim})
                assert rc == 0, out
                rc, _, err = await cli(PORT_CLI, mon, "-p", "ec", "get",
                                       "obj", str(dst))
                assert rc == 0 and dst.read_bytes() == payload, err
                restarted = subprocess.Popen(
                    [sys.executable, "-m", "ceph_tpu_torch.osd", "--id",
                     str(victim), "--mon", mon, "--device", "cpu",
                     "--store-path", str(data_dir / f"osd.{victim}")],
                    stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                    env=_ENV)
                line = await asyncio.to_thread(restarted.stdout.readline)
                assert line.startswith(b"OSD_ADDR"), line
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    rc, st = await client.mon_command({"prefix": "status"})
                    if st.get("num_up_osds") == 3:
                        break
                    await asyncio.sleep(0.2)
                assert st["num_up_osds"] == 3, st
                dst.unlink()
                rc, _, err = await cli(PORT_CLI, mon, "-p", "ec", "get",
                                       "obj", str(dst))
                assert rc == 0 and dst.read_bytes() == payload, err
                rc, out, err = await cli(PORT_CLI, mon, "tell",
                                         str(victim), "store_status")
                assert rc == 0, err
                assert json.loads(out)["type"] == "TPUStore"
            finally:
                await client.shutdown()

        run(main())
    finally:
        if restarted is not None:
            with open(pids_file, "a") as f:
                f.write(f" {restarted.pid}")
        down = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.vstart",
             "--data-dir", str(data_dir), "--stop"],
            capture_output=True, env=_ENV, timeout=60)
        for pid in pids + ([restarted.pid] if restarted else []):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        if restarted is not None:
            restarted.wait(10)
    assert down.returncode == 0, down.stdout
    assert not pids_file.exists()
