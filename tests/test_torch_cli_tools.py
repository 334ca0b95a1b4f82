"""The port's cluster tools as processes (ceph_tpu_torch.tools.rados and
ceph_tpu_torch.tools.vstart), on the CPU.

tests/test_cli_tools.py's `test_rados_cli_end_to_end` through `python -m
ceph_tpu_torch.tools.rados --device cpu` against a port cluster; the same
commands against a JAX cluster through the JAX CLI and the port's CLI side
by side (each on its own pool), whose outputs must be equal; and a cluster
of real processes from `python -m ceph_tpu_torch.tools.vstart --device
cpu` (TPUStore OSDs): a put and a get through the port CLI, one OSD
process SIGKILLed (the OS keeps every write it was handed: a process kill,
not a power cut) and marked down, an exact degraded get, the OSD restarted
on its store directory, an exact get again, then `--stop`.  `vstart --mds`
exits nonzero: the MDS is not ported.
"""

import asyncio
import json
import os
import re
import signal
import subprocess
import sys
import time

from torch_cluster_helpers import Cluster
from torch_cluster_helpers import one_torch_thread  # noqa: F401

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


def test_vstart_cluster_kill_and_restart_an_osd_process(tmp_path):
    """vstart --device cpu: 1 mon and 3 TPUStore OSD processes; the port
    CLI puts and gets an object on an EC 2+1 pool; one OSD process is
    SIGKILLed and marked down, the get is exact; the OSD is restarted on
    its store directory, comes up, and the get is exact again."""
    from ceph_tpu_torch.rados.client import RadosClient

    data_dir = tmp_path / "vstart"
    rc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.vstart",
         "--data-dir", str(data_dir), "--mds"],
        capture_output=True, env=_ENV, timeout=60)
    assert rc.returncode != 0 and b"not ported" in rc.stderr
    assert not (data_dir / "vstart.pids").exists()

    up = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.vstart",
         "--data-dir", str(data_dir), "--mons", "1", "--osds", "3",
         "--device", "cpu"],
        capture_output=True, env=_ENV, timeout=120)
    assert up.returncode == 0, up.stderr[-2000:]
    mon = re.search(rb"export CEPH_TPU_MON=(\S+)", up.stdout)[1].decode()
    pids_file = data_dir / "vstart.pids"
    pids = [int(p) for p in pids_file.read_text().split()]
    assert len(pids) == 4                     # the mon, then osd.0-2
    restarted = None
    try:
        for i in range(3):
            assert os.path.exists(data_dir / f"osd.{i}" / "block")
        payload = os.urandom(300_000)
        src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
        src.write_bytes(payload)

        async def main():
            nonlocal restarted
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
