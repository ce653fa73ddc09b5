"""The fleet's entry points in the port:
``python -m parallel_convolution_tpu_torch.serving.route`` (the JAX
package's ``scripts/router.py``) and ``...serving.loadgen`` (its
``scripts/loadgen.py``), held against the JAX scripts on the CPU.

* the port's loadgen row has the JAX loadgen row's keys, in process and
  through a router, and every answer is the oracle's (``--check``);
* ``route --replicas N --device cpu`` boots in-process replicas behind
  the router's HTTP server; the port's loadgen on both wires and the JAX
  loadgen on JSON drive it to exit 0, with the router's stamps counted
  (``replicas_seen``, ``failovers_observed``);
* the in-process entry points run on the card unless asked for the CPU;
* the flags of the sharded control plane and the autoscaler do what the
  JAX script's do: the same argument errors, boot lines and shard maps,
  a dead peer's shard taken over; loadgen's ``--shardmap`` refuses what
  JAX's refuses and, through three ``route --shards 3`` processes, answers
  the oracle's bytes across the death of a shard's owner.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

from parallel_convolution_tpu.utils.platform import child_env_cpu
from parallel_convolution_tpu_torch.serving import loadgen, route

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--rows", "48", "--cols", "64", "--iters", "2"]


def _port_loadgen(argv) -> tuple[int, dict]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = loadgen.main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


def _jax_loadgen(argv) -> tuple[int, dict]:
    p = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "loadgen.py"), *argv],
        capture_output=True, text=True, timeout=300, env=child_env_cpu(8))
    assert p.stdout.strip(), p.stderr[-2000:]
    return p.returncode, json.loads(p.stdout.strip().splitlines()[-1])


def test_in_process_row_has_the_jax_keys():
    argv = ["--in-process", "--n", "6", "--concurrency", "3", "--mesh",
            "1x2", "--check", *SMALL]
    rc, row = _port_loadgen([*argv, "--device", "cpu"])
    jrc, jrow = _jax_loadgen(argv)
    assert rc == jrc == 0
    assert set(row) == set(jrow)
    for k in ("workload", "completed", "non_rejected_failures",
              "oracle_mismatches", "effective_backend", "effective_grid",
              "mesh", "rejected", "failovers_observed"):
        assert row[k] == jrow[k], k
    assert row["completed"] == 6 and row["platform"] == "cpu"


@pytest.fixture(scope="module")
def route_url():
    """``serving.route`` in a process of its own: two in-process replicas
    on the CPU behind the router's HTTP server on port 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "parallel_convolution_tpu_torch.serving.route",
         "--port", "0", "--replicas", "2", "--mesh", "1x2", "--device",
         "cpu", "--tenant-rate", "1000"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    try:
        boot = json.loads(proc.stdout.readline())
        yield boot, proc
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)


def test_route_boots_replicas_on_the_asked_device(route_url):
    boot, proc = route_url
    assert boot["replicas"] == ["r0", "r1"] and boot["tenant_quota"]
    assert boot["mesh"] == "1x2" and boot["device"] == "cpu"
    assert boot["routing"].startswith("http://127.0.0.1:")


@pytest.mark.parametrize("wire", ["json", "frames"])
def test_loadgen_through_the_router_row_has_the_jax_keys(route_url, wire):
    boot, _ = route_url
    argv = ["--target", boot["routing"], "--n", "8", "--concurrency", "4",
            "--wire", wire, "--check", "--tenant", "web", *SMALL]
    rc, row = _port_loadgen(argv)
    jrc, jrow = _jax_loadgen(argv)
    assert rc == jrc == 0
    assert set(row) == set(jrow)
    for r in (row, jrow):
        assert r["completed"] == 8 and r["oracle_mismatches"] == 0
        assert r["failovers_observed"] == 0 and len(r["replicas_seen"]) == 1
        assert r["wires_seen"] == [wire] and r["p50_ms"] <= r["p99_ms"]
    assert row["replicas_seen"] == jrow["replicas_seen"]


def test_route_stops_cleanly_on_sigterm(route_url):
    boot, proc = route_url
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(60) == 0
    lines = [json.loads(ln) for ln in proc.stdout.read().splitlines()
             if ln.strip()]
    final = lines[-1]["final"]
    assert lines[-1]["stopping"] == signal.SIGTERM
    assert set(final["replicas"]) == {"r0", "r1"}
    assert final["router"]["completed"] == final["router"]["routed"]


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loadgen.main(["--in-process", "--n", "1", *SMALL])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        route.replica_grid("2x2", None)
    grid = route.replica_grid("2x2", "cpu")
    assert grid.shape == (2, 2) and grid.device.type == "cpu"


# Each flag of the sharded control plane and the autoscaler, held against
# the JAX script's behaviour for it: its argument errors, its boot line,
# its shard map and its takeover of a peer that never answers.
DEAD = "http://127.0.0.1:9"
SHARDED = ["--target", DEAD, "--shards", "2", "--name", "rA"]
FLEET_FLAGS = {
    "--shards": (["--target", DEAD, "--shards", "2"], "error", None),
    "--state-dir": ([*SHARDED, "--state-dir", "{d}", "--assign", "1=rB"],
                    "boot", None),
    "--peer": ([*SHARDED, "--state-dir", "{d}", "--peer", "rB"], "error",
               None),
    "--assign": ([*SHARDED, "--state-dir", "{d}", "--assign", "1"],
                 "error", None),
    "--advertise": ([*SHARDED, "--state-dir", "{d}", "--advertise",
                     "http://a.example:8090"], "shardmap", 0.0),
    # A peer that never answers: after --suspect-after misses at
    # --sync-interval-s its shard is taken over, or not yet.
    "--sync-interval-s": ([*SHARDED, "--state-dir", "{d}", "--assign",
                           "1=rB", "--peer", f"rB={DEAD}",
                           "--sync-interval-s", "0.05"], "shardmap", 1.5),
    "--suspect-after": ([*SHARDED, "--state-dir", "{d}", "--assign",
                         "1=rB", "--peer", f"rB={DEAD}",
                         "--sync-interval-s", "0.05", "--suspect-after",
                         "100000"], "shardmap", 1.5),
    "--autoscale-max": (["--target", DEAD, "--autoscale-max", "3"],
                        "error", None),
    "--autoscale-interval-s": (["--replicas", "1", "--mesh", "1x1",
                                "--autoscale-max", "2",
                                "--autoscale-interval-s", "0.2",
                                "--autoscale-cooldown-s", "1"], "boot", None),
    "--autoscale-cooldown-s": ([*SHARDED, "--state-dir", "{d}",
                                "--autoscale-max", "2",
                                "--autoscale-cooldown-s", "1"], "error",
                               None),
}


def _route_error(argv) -> tuple[int, str]:
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
        route.main(argv)
    return e.value.code, err.getvalue().strip().splitlines()[-1]


def _jax_route_error(argv) -> tuple[int, str]:
    p = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "router.py"), *argv],
        capture_output=True, text=True, timeout=300, env=child_env_cpu(8))
    return p.returncode, p.stderr.strip().splitlines()[-1]


def _boot(cmd, wait_s):
    """Boot one router process on port 0: its boot line and, after
    ``wait_s`` (None: not fetched), its ``/v1/shardmap``."""
    import time
    import urllib.request

    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=child_env_cpu(8, dict(
                                os.environ, PYTHONPATH=str(REPO))))
    try:
        boot = json.loads(proc.stdout.readline())
        smap = None
        if wait_s is not None:
            time.sleep(wait_s)
            with urllib.request.urlopen(boot["routing"] + "/v1/shardmap",
                                        timeout=30) as r:
                smap = json.loads(r.read())
        return boot, smap
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)


@pytest.mark.parametrize("flag", list(FLEET_FLAGS))
def test_route_item_8b_ii_flags_exit_2(flag, tmp_path):
    """Named for what these flags did before the sharded control plane and
    the autoscaler were ported (exit 2): each now does what the JAX
    script's flag does."""
    argv, kind, wait_s = FLEET_FLAGS[flag]
    if kind == "error":
        argv = [a.replace("{d}", str(tmp_path / "e")) for a in argv]
        got = _route_error(argv)
        want = _jax_route_error(argv)
        assert got[0] == want[0] == 2
        assert got[1].split("error: ", 1)[1] == want[1].split("error: ", 1)[1]
        return
    out = {}
    for side, cmd in (
            ("port", [sys.executable, "-m",
                      "parallel_convolution_tpu_torch.serving.route",
                      "--device", "cpu"]),
            ("jax", [sys.executable, str(REPO / "scripts" / "router.py"),
                     "--platform", "cpu"])):
        d = tmp_path / side
        out[side] = _boot([*cmd, "--port", "0",
                           *[a.replace("{d}", str(d)) for a in argv]],
                          wait_s)
    (boot, smap), (jboot, jsmap) = out["port"], out["jax"]
    for b in (boot, jboot):
        b.pop("routing")
        b.pop("state_dir", None)
    assert {k: v for k, v in boot.items() if k not in ("mesh", "device")} \
        == jboot
    if kind == "boot" and "--shards" in argv:
        assert boot["owned"] == ["0"] and boot["peers"] == []
        assert boot["name"] == "rA" and boot["map_version"] == 1
    elif kind == "boot":
        assert boot["autoscale_max"] == 2 and boot["device"] == "cpu"
    if smap is not None:
        for m in (smap, jsmap):
            assert m.pop("from") == "rA"
        assert smap == jsmap
        owners = {s: e["owner"] for s, e in smap["shards"].items()}
        if flag == "--advertise":
            assert smap["shards"]["0"]["addr"] == "http://a.example:8090"
        elif flag == "--sync-interval-s":
            assert owners == {"0": "rA", "1": "rA"}   # taken over
            assert smap["shards"]["1"]["epoch"] == 1
        elif flag == "--suspect-after":
            assert owners == {"0": "rA", "1": "rB"}   # not yet


def test_loadgen_shardmap_exits_2(capsys):
    """Named for what ``--shardmap`` did before it was ported (exit 2):
    it now refuses what the JAX script refuses, in its words."""
    for argv in (["--in-process", "--shardmap"],
                 ["--target", DEAD, "--shardmap", "--wire", "frames"]):
        with pytest.raises(SystemExit) as e:
            loadgen.main(argv)
        err = capsys.readouterr().err.strip().splitlines()[-1]
        p = subprocess.run(
            [sys.executable, str(REPO / "scripts" / "loadgen.py"), *argv],
            capture_output=True, text=True, timeout=300,
            env=child_env_cpu(8))
        assert e.value.code == p.returncode == 2
        assert (err.split("error: ", 1)[1]
                == p.stderr.strip().splitlines()[-1].split("error: ", 1)[1])


def test_loadgen_shardmap_through_a_sharded_route_fleet(tmp_path):
    """Three ``route --shards 3`` processes on the CPU, each owning one
    shard of one state dir; the port's loadgen ``--shardmap`` and the JAX
    one drive the same fleet, every answer the oracle's, and after the
    owner of the requests' shard is killed the port's loadgen refreshes
    its map and completes every request at the successor."""
    import socket
    import threading
    import time

    names = ["sA", "sB", "sC"]
    socks = [socket.socket() for _ in names]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    procs = []
    try:
        for i, nm in enumerate(names):
            cmd = [sys.executable, "-m",
                   "parallel_convolution_tpu_torch.serving.route",
                   "--port", str(ports[i]), "--replicas", "1", "--mesh",
                   "1x2", "--device", "cpu", "--shards", "3", "--name", nm,
                   "--state-dir", str(tmp_path), "--advertise", urls[i],
                   "--sync-interval-s", "0.1",
                   *[a for j, o in enumerate(names)
                     for a in ("--assign", f"{j}={o}")],
                   *[a for j, o in enumerate(names) if j != i
                     for a in ("--peer", f"{o}={urls[j]}")]]
            procs.append(subprocess.Popen(
                cmd, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env=dict(os.environ, PYTHONPATH=str(REPO))))
        boots = [json.loads(p.stdout.readline()) for p in procs]
        assert [b["owned"] for b in boots] == [["0"], ["1"], ["2"]]
        argv = ["--shardmap", *[a for u in urls for a in ("--target", u)],
                "--n", "8", "--concurrency", "4", "--check", *SMALL]
        rc, row = _port_loadgen(argv)
        jrc, jrow = _jax_loadgen(argv)
        assert rc == jrc == 0
        assert set(row) == set(jrow)
        for r in (row, jrow):
            assert r["completed"] == 8 and r["oracle_mismatches"] == 0
            assert r["non_rejected_failures"] == 0
            assert r["shardmap_refreshes"] == 1
        assert row["shards_seen"] == jrow["shards_seen"]
        # The owner of the requests' shard dies mid-run (open loop, 20
        # a second): requests dialled at it refresh the map until the
        # survivors' takeover, then complete at the successor.
        owner = int(row["shards_seen"][0])
        got = {}
        run = threading.Thread(target=lambda: got.update(zip(
            ("rc", "row"), _port_loadgen([*argv, "--rate", "20", "--n",
                                          "40"]))))
        run.start()
        time.sleep(0.5)
        procs[owner].kill()
        procs[owner].wait(30)
        run.join(300)
        row = got["row"]
        assert got["rc"] == 0 and row["completed"] == 40
        assert row["oracle_mismatches"] == row["non_rejected_failures"] == 0
        assert row["shardmap_refreshes"] >= 2   # the dead owner's redirect
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(30)


def test_help_exits_0():
    for mod in ("route", "loadgen"):
        p = subprocess.run(
            [sys.executable, "-m",
             f"parallel_convolution_tpu_torch.serving.{mod}", "--help"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert p.returncode == 0 and "usage" in p.stdout
