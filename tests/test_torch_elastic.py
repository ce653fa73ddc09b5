"""Elastic grids, the supervisor and the breaker (ROADMAP item 13) in the
port, held against the JAX package on the CPU.

* ``resilience/elastic.py``'s pure functions equal JAX's on every grid up
  to 8x8; ``detect_change`` under ``PCTPU_SIM_DEVICES`` equals JAX's for
  grids whose blocks each have a device, and a one-card grid never
  shrinks while one card lives (the distinct devices a grid needs);
* ``utils.platform.probe_device_count``: the override, the child process,
  a hang and a failure;
* ``step.reshard_prepared`` equals ``_prepare`` on the target grid and the
  JAX ``reshard_prepared`` (2x4 -> 1x2, slots and one device);
* ``ConvolutionModel.set_grid`` / ``JacobiSolver.set_grid`` runs equal the
  runs before the swap and the JAX ``set_mesh`` runs (u8 bytes; floats
  within ``ops/stencil.float_tolerance``);
* ``PCTPU_MESH`` through the port's CLI;
* the same fake legs through both supervisors give equal statuses (times
  aside), and the same event sequence through both breakers on an injected
  clock equal states and snapshots.
"""

import dataclasses
import json
import os
import random
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
from _torch_jax_state import reset_jax_state

from parallel_convolution_tpu import cli as jcli
from parallel_convolution_tpu.models import ConvolutionModel as JModel
from parallel_convolution_tpu.models import JacobiSolver as JSolver
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.parallel import step as jstep
from parallel_convolution_tpu.resilience import breaker as jbreaker
from parallel_convolution_tpu.resilience import elastic as jelastic
from parallel_convolution_tpu.resilience import retry as jretry
from parallel_convolution_tpu.resilience import supervisor as jsupervisor
from parallel_convolution_tpu.utils import platform as jplatform
from parallel_convolution_tpu_torch.cli import main as cli_main
from parallel_convolution_tpu_torch.models import ConvolutionModel, JacobiSolver
from parallel_convolution_tpu_torch.ops import oracle, stencil
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh, step
from parallel_convolution_tpu_torch.resilience import (
    breaker, elastic, faults, retry, supervisor,
)
from parallel_convolution_tpu_torch.utils import imageio, platform
from parallel_convolution_tpu_torch.utils.config import BACKEND_FROM_REFERENCE

JAX_NAME = {v: k for k, v in BACKEND_FROM_REFERENCE.items()}


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """No simulated device count, grid env or fault plan leaks in or out."""
    monkeypatch.delenv(platform.SIM_DEVICES_ENV, raising=False)
    monkeypatch.delenv(elastic.MESH_ENV, raising=False)
    faults.uninstall_plan()
    yield
    faults.uninstall_plan()
    reset_jax_state()


def _jax_mesh(shape):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _slots(shape):
    return mesh.make_grid(shape, devices=["cpu"] * (shape[0] * shape[1]))


def _cards(shape):
    """A grid with a card per block, as a description (no CUDA needed):
    what ``detect_change`` counts."""
    n = shape[0] * shape[1]
    return mesh.Grid(*shape, devices=tuple(torch.device("cuda", k)
                                           for k in range(n)))


# ------------------------------------------------------ the pure functions
@pytest.mark.parametrize("rows", range(1, 9))
def test_ladder_and_next_fit_equal_jax(rows):
    """Every grid up to 8x8: the ladder, and ``next_fit`` from every start
    at every live count (and unknown health)."""
    for cols in range(1, 9):
        ladder = elastic.grid_ladder((rows, cols))
        assert ladder == jelastic.grid_ladder((rows, cols))
        assert elastic.format_spec((rows, cols)) == jelastic.format_spec(
            (rows, cols))
        for spec in ladder:
            assert elastic.parse_spec(spec) == jelastic.parse_spec(spec)
        for start in range(-1, len(ladder) + 2):
            for live in [None, *range(0, rows * cols + 2)]:
                assert (elastic.next_fit(ladder, start, live)
                        == jelastic.next_fit(ladder, start, live))
    assert elastic.next_fit([], 0, 3) == jelastic.next_fit([], 0, 3) == 0


@pytest.mark.parametrize("spec", ["2x", "x2", "0x2", "2x-1", "abc", "2x2x2",
                                  ""])
def test_parse_spec_errors_equal_jax(spec):
    with pytest.raises(ValueError) as got:
        elastic.parse_spec(spec)
    with pytest.raises(ValueError) as want:
        jelastic.parse_spec(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 2), (1, 8), (8, 1),
                                   (1, 2), (1, 1)])
def test_detect_change_equal_jax_for_a_device_per_block(shape, monkeypatch):
    """A grid with a device per block shrinks exactly as the JAX mesh of
    the same shape does, at every simulated live count."""
    for live in range(0, 10):
        monkeypatch.setenv(platform.SIM_DEVICES_ENV, str(live))
        got = elastic.detect_change(_cards(shape))
        want = jelastic.detect_change(_jax_mesh(shape))
        assert (got is None) == (want is None), (shape, live)
        if got is not None:
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            assert got.lost == want.lost


def test_one_card_grid_never_shrinks_while_its_card_lives(monkeypatch):
    """The distinct devices a grid needs, not its blocks: a 4x4 grid on one
    card, or 16 slots repeating it, needs one card."""
    one = mesh.Grid(4, 4, torch.device("cuda", 0))
    repeated = mesh.Grid(4, 4, devices=(torch.device("cuda", 0),) * 16)
    two = mesh.Grid(2, 2, devices=tuple(torch.device("cuda", k % 2)
                                        for k in range(4)))
    assert [elastic.devices_needed(g) for g in (one, repeated, two)] == [
        1, 1, 2]
    monkeypatch.setenv(platform.SIM_DEVICES_ENV, "1")
    assert elastic.detect_change(one) is None
    assert elastic.detect_change(repeated) is None
    ch = elastic.detect_change(two)
    assert ch.old_grid == (2, 2) and ch.new_spec == "1x1"
    monkeypatch.setenv(platform.SIM_DEVICES_ENV, "0")
    gone = elastic.detect_change(one)
    assert gone.live == 0 and gone.new_spec is None


def test_cpu_grids_count_one_device_and_never_shrink():
    """The CPU is one device: the probe says 1 without a child, and no CPU
    grid, one-device or slots, looks shrunk."""
    assert platform.probe_device_count(device_type="cpu") == 1
    for g in (mesh.make_grid((4, 4), "cpu"), _slots((2, 4))):
        assert elastic.devices_needed(g) == 1
        assert elastic.detect_change(g) is None


# ------------------------------------------------------ the device probe
def test_probe_device_count_sim_override_equal_jax(monkeypatch):
    for v in ("3", "0", "-2", "11"):
        monkeypatch.setenv(platform.SIM_DEVICES_ENV, v)
        assert (platform.probe_device_count()
                == jplatform.probe_device_count() == max(0, int(v)))


def test_probe_device_count_child_counts_the_cards(monkeypatch):
    """The child process counts the cards (none here), honours
    CUDA_VISIBLE_DEVICES, and with no device type falls to the CPU's one
    device where CUDA is absent; a bad override is ignored."""
    want = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert platform.probe_device_count(device_type="cuda") == want
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert platform.probe_device_count(device_type="cuda") == 0
    monkeypatch.setenv(platform.SIM_DEVICES_ENV, "lots")
    assert platform.probe_device_count() == (
        1 if not torch.cuda.is_available() else 0)
    with pytest.raises(ValueError, match="device_type"):
        platform.probe_device_count(device_type="tpu")


def test_probe_device_count_hang_or_failure_is_unknown(monkeypatch):
    monkeypatch.setattr(platform, "_COUNT_SRC", "import time\ntime.sleep(30)")
    assert platform.probe_device_count(timeout=0.5,
                                       device_type="cuda") is None
    monkeypatch.setattr(platform, "_COUNT_SRC", "raise SystemExit(3)")
    assert platform.probe_device_count(device_type="cuda") is None
    monkeypatch.setattr(platform, "_COUNT_SRC", "print('many')")
    assert platform.probe_device_count(device_type="cuda") is None


def test_probe_device_count_consults_its_fault_site():
    with faults.injected("device_probe:1") as plan:
        with pytest.raises(faults.InjectedFault):
            platform.probe_device_count(device_type="cpu")
        assert plan.fired
    assert platform.probe_device_count(device_type="cpu") == 1


def test_reshape_grid_builds_and_validates():
    g = elastic.reshape_grid("1x2", devices=["cpu"] * 8)
    assert g.shape == (1, 2) and g.slotted
    assert elastic.reshape_grid((2, 2), device="cpu").slots == (
        torch.device("cpu"),) * 4
    with pytest.raises(ValueError) as got:
        elastic.reshape_grid((99, 99), devices=["cpu"] * 8)
    with pytest.raises(ValueError) as want:
        jelastic.reshape_mesh((99, 99))
    assert str(got.value) == str(want.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            elastic.reshape_grid("1x1")


# ------------------------------------------------------ reshard_prepared
@pytest.mark.parametrize("src_form", ["one", "slots"])
@pytest.mark.parametrize("dst_form", ["one", "slots"])
@pytest.mark.parametrize("target", [(1, 2), (2, 2), (1, 1)])
def test_reshard_prepared_equals_prepare_and_jax(grey_odd, src_form,
                                                 dst_form, target):
    def grid(shape, form):
        return mesh.make_grid(shape, "cpu") if form == "one" else _slots(shape)

    x = imageio.interleaved_to_planar(grey_odd).astype(np.float32)
    blocks, valid_hw, _ = step._prepare(x, grid((2, 4), src_form))
    dst = grid(target, dst_form)
    moved = step.reshard_prepared(blocks, valid_hw, dst)
    fresh, _, block_hw = step._prepare(x, dst)
    for (i, j), b in mesh.local_blocks(moved):
        assert b.device == dst.slot_device(i, j)
        assert b.is_contiguous() and tuple(b.shape[1:]) == block_hw
        assert torch.equal(b, fresh[i][j])
    jxs, jvalid, _ = jstep._prepare(x, _jax_mesh((2, 4)), 1)
    want = np.asarray(jstep.reshard_prepared(jxs, jvalid,
                                             _jax_mesh(target)))
    np.testing.assert_array_equal(mesh.join_blocks(moved).numpy(), want)


def test_reshard_prepared_keeps_the_storage_dtype(grey_odd):
    x = imageio.interleaved_to_planar(grey_odd)
    blocks, valid_hw, _ = step._prepare(x, _slots((2, 4)), "u8")
    moved = step.reshard_prepared(blocks, valid_hw, _slots((1, 2)))
    fresh, _, _ = step._prepare(x, _slots((1, 2)), "u8")
    assert moved[0][0].dtype == torch.uint8
    assert all(torch.equal(a, b) for ra, rb in zip(moved, fresh)
               for a, b in zip(ra, rb))


# ------------------------------------------------------ set_grid
@pytest.mark.parametrize("backend", ["shifted", "cuda", "cuda_rdma"])
def test_model_set_grid_bytes_equal_jax_set_mesh(grey_small, backend):
    """2x4 slots -> "1x2" (slots) -> one device: every run the bytes of the
    first, of the JAX model after ``set_mesh("1x2")`` and of the oracle;
    only the per-grid verdicts reset."""
    filt = get_filter("blur3")
    model = ConvolutionModel("blur3", grid=_slots((2, 4)), backend=backend,
                             fuse=2)
    a = model.run_image(grey_small, 3)
    assert model.effective_backend == backend
    model.set_grid("1x2")
    assert model.grid.shape == (1, 2) and model.grid.slotted
    assert model.effective_backend is None
    assert model.plan_source == "explicit"
    assert model.effective_overlap is None
    assert model.effective_col_mode is None
    assert model.fuse == 2 and model.backend == backend
    b = model.run_image(grey_small, 3)
    model.set_grid(mesh.make_grid((1, 1), "cpu"))
    c = model.run_image(grey_small, 3)
    jmodel = JModel(filt="blur3", mesh=_jax_mesh((2, 4)),
                    backend=JAX_NAME[backend], fuse=2)
    ja = jmodel.run_image(grey_small, 3)
    jmodel.set_mesh("1x2")
    jb = jmodel.run_image(grey_small, 3)
    for got in (b, c, ja, jb):
        np.testing.assert_array_equal(got, a)
    np.testing.assert_array_equal(a, oracle.run_serial_u8(grey_small, filt,
                                                          3))


def test_model_set_grid_by_spec_keeps_the_one_device_form(grey_small):
    model = ConvolutionModel("blur3", grid=mesh.make_grid((2, 2), "cpu"))
    a = model.run_image(grey_small, 2)
    model.set_grid("4x1")
    assert model.grid == mesh.Grid(4, 1, torch.device("cpu"))
    np.testing.assert_array_equal(model.run_image(grey_small, 2), a)
    with pytest.raises(ValueError, match="RxC"):
        model.set_grid("four")


@pytest.mark.parametrize("solver", ["jacobi", "multigrid"])
def test_jacobi_set_grid_equal_jax_set_mesh(solver):
    """A float solve on 2x2 slots, then after ``set_grid("1x2")``: the same
    bits and work count (the grid never changes a result), and the JAX
    solver's after ``set_mesh`` within the float tolerance."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 24, 36)).astype(np.float32)
    kw = dict(tol=1e-3, max_iters=60, check_every=10, solver=solver)
    s = JacobiSolver("jacobi3", grid=_slots((2, 2)), backend="cuda", **kw)
    a, na = s.solve(x)
    assert s.set_grid("1x2") is s and s.grid.shape == (1, 2)
    b, nb = s.solve(x)
    assert na == nb
    np.testing.assert_array_equal(a, b)
    js = JSolver("jacobi3", mesh=_jax_mesh((2, 2)), backend="pallas", **kw)
    js.set_mesh("1x2")
    jb, jn = js.solve(x)
    assert jn == nb
    scale = float(np.abs(x).max())
    if solver == "multigrid":
        from parallel_convolution_tpu_torch.solvers import multigrid

        rtol, atol = multigrid.float_tolerance(get_filter("jacobi3"), nb,
                                               scale)
    else:
        rtol, atol = stencil.float_tolerance(get_filter("jacobi3"), nb,
                                             torch.float32)
        atol *= scale
    np.testing.assert_allclose(b, np.asarray(jb), rtol=rtol, atol=atol)


# ------------------------------------------------------ PCTPU_MESH
def test_pctpu_mesh_env_regrids_the_cli(tmp_path, grey_small, monkeypatch,
                                        capsys):
    """An unset --mesh reads PCTPU_MESH (the supervisor's rung), as the JAX
    CLI does; --mesh wins over it; the bytes are the oracle's."""
    rows, cols = grey_small.shape
    src, out = tmp_path / "in.raw", tmp_path / "out.raw"
    imageio.write_raw(src, grey_small)
    want = oracle.run_serial_u8(grey_small, get_filter("blur3"), 3)
    base = ["run", str(src), str(rows), str(cols), "3", "grey", "-o",
            str(out), "--backend", "cuda_rdma", "--fuse", "2"]
    monkeypatch.setenv(elastic.MESH_ENV, "2x2")
    assert cli_main(base + ["--device", "cpu,cpu,cpu,cpu"]) == 0
    assert "2x2" in capsys.readouterr().out
    np.testing.assert_array_equal(imageio.read_raw(out, rows, cols, "grey"),
                                  want)
    assert cli_main(base + ["--device", "cpu"]) == 0
    assert "2x2" in capsys.readouterr().out
    assert cli_main(base + ["--device", "cpu", "--mesh", "1x2"]) == 0
    assert "1x2" in capsys.readouterr().out
    jout = tmp_path / "jout.raw"
    assert jcli.main(["run", str(src), str(rows), str(cols), "3", "grey",
                      "-o", str(jout)]) == 0
    assert "2x2" in capsys.readouterr().out
    assert jout.read_bytes() == out.read_bytes()
    monkeypatch.setenv(elastic.MESH_ENV, "2by2")
    assert cli_main(base + ["--device", "cpu"]) == 2
    assert "RxC" in capsys.readouterr().err


def test_grid_from_spec_reads_the_env(monkeypatch):
    assert mesh.grid_from_spec(None, "cpu").shape == (1, 1)
    monkeypatch.setenv(elastic.MESH_ENV, "2x4")
    assert mesh.grid_from_spec(None, "cpu").shape == (2, 4)
    assert mesh.grid_from_spec("", "cpu,cpu,cpu,cpu,cpu,cpu,cpu,cpu").shape \
        == (2, 4)
    assert mesh.grid_from_spec("1x2", "cpu").shape == (1, 2)


# ------------------------------------------------------ the supervisor
_TIMES = ("updated", "completed_at", "heartbeat", "heartbeat_unix")


def _status(sup) -> dict:
    """A supervisor's ledger without its clock readings."""
    st = json.loads(json.dumps(sup._status))
    for k in _TIMES:
        st.pop(k, None)
    for leg in st["legs"].values():
        for k in _TIMES:
            leg.pop(k, None)
    return st


def _both(tmp_path, legs_for, **kw):
    """The same legs through both supervisors: (rc, status) each, and the
    captured output files' names."""
    out = []
    for name, mod, pol in (("torch", supervisor, retry.RetryPolicy),
                           ("jax", jsupervisor, jretry.RetryPolicy)):
        state = tmp_path / name
        legs = [mod.Leg.from_dict(d) for d in legs_for(state)]
        sup = mod.Supervisor(legs, state,
                             policy=pol(max_attempts=kw.get("attempts", 3),
                                        base_delay=0.01, max_delay=0.01),
                             sleep=lambda d: None, log=lambda m: None)
        out.append((sup.run(), _status(sup),
                    sorted(p.name for p in state.iterdir())))
    return out


def test_supervisor_reshape_ladder_equal_jax(tmp_path, monkeypatch):
    """JAX's ladder test through both: live=2 skips 2x2 straight to 1x2."""
    monkeypatch.setenv(platform.SIM_DEVICES_ENV, "2")

    def legs(state):
        done = state / "out.json"
        script = (
            "import os, sys, pathlib\n"
            "m = os.environ.get('PCTPU_MESH', '')\n"
            "if m != '1x2':\n"
            "    print('DEVICE LOST on mesh ' + m, file=sys.stderr)\n"
            "    sys.exit(1)\n"
            f"pathlib.Path({str(done)!r}).write_text('served on ' + m)\n")
        return [{"name": "reshapey", "cmd": [sys.executable, "-c", script],
                 "done_file": str(done), "meshes": ["2x4", "2x2", "1x2"],
                 "reshape_pattern": "DEVICE LOST"}]

    (rc, st, files), (jrc, jst, jfiles) = _both(tmp_path, legs)
    assert rc == jrc == 0 and st == jst and files == jfiles
    leg = st["legs"]["reshapey"]
    assert leg["mesh"] == "1x2" and leg["reshapes"] == 1
    assert leg["attempts"] == 2 and st["schema_version"] == 2
    assert (tmp_path / "torch" / "out.json").read_text() == "served on 1x2"


def test_supervisor_terminal_exhausted_and_done_equal_jax(tmp_path):
    """A leg already complete, one that exhausts its retries, then one
    whose output matches the terminal pattern: the HALT sentinel, rc 2, and
    a second run that refuses."""
    def legs(state):
        state.mkdir(parents=True, exist_ok=True)
        landed = state / "landed.txt"
        landed.write_text('{"summary": 1}')
        return [
            {"name": "landed", "cmd": ["false"], "done_file": str(landed),
             "done_pattern": '"summary"'},
            {"name": "flaky", "cmd": [sys.executable, "-c",
                                      "import sys; sys.exit(3)"]},
            {"name": "bad", "cmd": [sys.executable, "-c",
                                    "print('MISMATCH here')"],
             "terminal_pattern": "MISMATCH"},
            {"name": "never", "cmd": ["true"]},
        ]

    (rc, st, files), (jrc, jst, jfiles) = _both(tmp_path, legs, attempts=2)
    assert rc == jrc == 2 and st == jst and files == jfiles
    assert st["legs"]["landed"]["state"] == "done"
    assert st["legs"]["flaky"] == {"state": "exhausted", "attempts": 2,
                                   "last_rc": 3,
                                   "last_error": "rc=3, incomplete"}
    assert st["halt"]["leg"] == "bad" and "never" not in st["legs"]
    again = supervisor.Supervisor([], tmp_path / "torch",
                                  log=lambda m: None)
    assert again.run() == 2


def test_supervisor_timeout_counts_as_a_failed_attempt(tmp_path):
    def legs(state):
        return [{"name": "slow", "timeout": 0.3,
                 "cmd": [sys.executable, "-c", "import time; time.sleep(30)"]}]

    (rc, st, _), (jrc, jst, _) = _both(tmp_path, legs, attempts=1)
    assert rc == jrc == 1 and st == jst
    assert st["legs"]["slow"]["last_error"] == "timeout"


@pytest.mark.parametrize("leg", [
    {"name": "x", "cmd": ["true"], "reshape_pattern": "boom"},
    {"name": "x", "cmd": ["true"], "meshes": ["2x4", "nope"]},
    {"name": "x", "cmd": ["true"], "colour": "red"},
    {"name": "", "cmd": ["true"]},
    {"name": "x", "cmd": []},
])
def test_leg_validation_equal_jax(leg):
    with pytest.raises(ValueError) as got:
        supervisor.Leg.from_dict(leg)
    with pytest.raises(ValueError) as want:
        jsupervisor.Leg.from_dict(leg)
    assert str(got.value) == str(want.value)


def test_legs_file_and_ledger_readers_equal_jax(tmp_path):
    with pytest.raises(ValueError, match="JSON list"):
        supervisor.legs_from_json('{"name": "x"}')
    with pytest.raises(ValueError, match="duplicate"):
        supervisor.Supervisor([supervisor.Leg("a", ["true"])] * 2, tmp_path)
    old = tmp_path / "v1.json"
    old.write_text(json.dumps({"legs": {"a": {"state": "done"}},
                               "updated": "2026-01-01T00:00:00Z"}))
    assert supervisor.read_ledger(old) == jsupervisor.read_ledger(old)


def test_supervisor_module_cli_runs_a_legs_file(tmp_path):
    """``python -m parallel_convolution_tpu_torch.resilience.supervisor``:
    the legs file through the ladder, the ledger, --status, a HALT and
    --clear-halt."""
    done = tmp_path / "done.txt"
    script = ("import os, pathlib\n"
              f"pathlib.Path({str(done)!r}).write_text("
              "os.environ['PCTPU_MESH'])\n"
              "raise SystemExit(0 if os.environ['PCTPU_MESH'] == '1x1' "
              "else 1)\n")
    legs = tmp_path / "legs.json"
    legs.write_text(json.dumps([
        {"name": "regrid", "cmd": [sys.executable, "-c", script],
         "done_file": str(done), "done_pattern": "1x1",
         "meshes": ["2x2", "1x1"], "reshape_pattern": "never printed"}]))
    state = tmp_path / "state"
    mod = [sys.executable, "-m",
           "parallel_convolution_tpu_torch.resilience.supervisor"]
    env = dict(os.environ, PCTPU_SIM_DEVICES="1")
    run = subprocess.run(mod + ["--legs", str(legs), "--state-dir",
                                str(state), "--base-delay", "0.01",
                                "--max-delay", "0.01", "--max-attempts",
                                "2"], capture_output=True, text=True,
                         env=env, timeout=120)
    # No reshape pattern in the output: the ladder stays on 2x2, the leg
    # exhausts its two attempts.
    assert run.returncode == 1, run.stderr
    ledger = supervisor.read_ledger(state / supervisor.LEDGER_NAME)
    assert ledger["legs"]["regrid"]["mesh"] == "2x2"
    assert ledger["legs"]["regrid"]["state"] == "exhausted"
    status = subprocess.run(mod + ["--status", "--state-dir", str(state)],
                            capture_output=True, text=True, timeout=60)
    assert json.loads(status.stdout)["legs"]["regrid"]["attempts"] == 2
    (state / supervisor.HALT_NAME).write_text("stop\n")
    halted = subprocess.run(mod + ["--legs", str(legs), "--state-dir",
                                   str(state)], capture_output=True,
                            text=True, timeout=60)
    assert halted.returncode == 2
    cleared = subprocess.run(mod + ["--clear-halt", "--state-dir",
                                    str(state)], capture_output=True,
                             text=True, timeout=60)
    assert cleared.returncode == 0
    assert not (state / supervisor.HALT_NAME).exists()
    assert (state / "HALT.cleared").exists()


# ------------------------------------------------------ the breaker
class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("seed", range(6))
def test_breaker_walk_equal_jax(seed):
    """One seeded sequence of gates, outcomes (transport and contract
    errors) and clock steps through both breakers: equal answers, states
    and snapshots at every step."""
    rnd = random.Random(seed)
    ck, jck = _Clock(), _Clock()
    threshold, cooldown = rnd.choice([1, 2, 3]), rnd.choice([0.0, 0.5, 2.0])
    b = breaker.CircuitBreaker(threshold, cooldown, clock=ck)
    jb = jbreaker.CircuitBreaker(threshold, cooldown, clock=jck)
    for _ in range(300):
        op = rnd.choice(["allow", "ok", "fail", "fail_exc", "fail_terminal",
                         "tick", "tick"])
        if op == "allow":
            assert b.allow() == jb.allow()
        elif op == "ok":
            b.record_success()
            jb.record_success()
        elif op == "fail":
            b.record_failure()
            jb.record_failure()
        elif op == "fail_exc":
            b.record_failure(ConnectionError("replica down"))
            jb.record_failure(ConnectionError("replica down"))
        elif op == "fail_terminal":
            b.record_failure(ValueError("bad request"))
            jb.record_failure(ValueError("bad request"))
        else:
            step_s = rnd.choice([0.1, 0.4, 1.0, 2.5])
            ck.now += step_s
            jck.now += step_s
        assert b.state() == jb.state()
        assert b.snapshot() == jb.snapshot()


def test_breaker_rejects_bad_settings_like_jax():
    for args in ((0, 1.0), (1, -1.0)):
        with pytest.raises(ValueError) as got:
            breaker.CircuitBreaker(*args)
        with pytest.raises(ValueError) as want:
            jbreaker.CircuitBreaker(*args)
        assert str(got.value) == str(want.value)


def test_no_item_13_left_pending():
    """Item 13 is ported: nothing in the port raises naming it."""
    import pathlib

    root = pathlib.Path(step.__file__).resolve().parents[1]
    hits = [str(p) for p in root.rglob("*.py")
            if "item 13" in p.read_text()]
    assert hits == []
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        JacobiSolver("jacobi3", device="cpu").set_grid("2x2")
