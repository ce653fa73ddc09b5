"""The fleet's entry points in the port (ROADMAP item 8b-i):
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
* the flags of ROADMAP item 8b-ii (the sharded control plane, the
  autoscaler, loadgen's ``--shardmap``) exit 2 naming the item.
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
from parallel_convolution_tpu_torch.utils.config import FLEET_ITEM

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


UNPORTED = [["--shards", "2"], ["--state-dir", "x"], ["--peer", "rB=http://b"],
            ["--assign", "0=rA"], ["--advertise", "http://a"],
            ["--sync-interval-s", "1"], ["--suspect-after", "2"],
            ["--autoscale-max", "3"], ["--autoscale-interval-s", "1"],
            ["--autoscale-cooldown-s", "1"]]


@pytest.mark.parametrize("flag", UNPORTED, ids=[f[0] for f in UNPORTED])
def test_route_item_8b_ii_flags_exit_2(flag, capsys):
    assert route.main(["--replicas", "1", "--device", "cpu", *flag]) == 2
    err = capsys.readouterr().err
    assert flag[0] in err and FLEET_ITEM in err and "item 8b-ii" in err


def test_loadgen_shardmap_exits_2(capsys):
    assert loadgen.main(["--target", "http://127.0.0.1:9", "--shardmap"]) == 2
    assert "--shardmap" in capsys.readouterr().err


def test_help_exits_0():
    for mod in ("route", "loadgen"):
        p = subprocess.run(
            [sys.executable, "-m",
             f"parallel_convolution_tpu_torch.serving.{mod}", "--help"],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert p.returncode == 0 and "usage" in p.stdout
