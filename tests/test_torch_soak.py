"""The randomized soak in the port (``python -m
parallel_convolution_tpu_torch.soak``) held against the JAX package's
``scripts/soak.py`` on the CPU.

* ``sample`` and ``sample_converge`` draw the JAX script's configurations
  for seeds 0-31, its Pallas backends under the port's names (the JAX
  script is loaded by path here, never by the port);
* ``main`` runs ``--n 8`` and ``--converge --n 4`` on ``--device cpu``,
  every row byte-identical to the oracle (float mode: bit-identical to
  ``shifted`` on 1x1 — on the card only where every tap is a power of
  two, else within the kernels' FMA tolerance — and within 1e-3 of the
  oracle);
* one ``--fault-trial`` child crashes a checkpointed run at an injected
  shard tear and resumes to the oracle's bytes, as the JAX trial does;
* the ``--shard-kill 1`` and ``--autoscale 1`` drills pass on the CPU;
* the entry point runs on the card unless asked for the CPU.

Tolerance: u8 bytes equal (float mode as stated).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from parallel_convolution_tpu_torch import soak
from parallel_convolution_tpu_torch.utils.config import BACKEND_FROM_REFERENCE

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jsoak():
    """The JAX script as a module (it imports its sibling ``_path``)."""
    scripts = str(REPO / "scripts")
    sys.path.insert(0, scripts)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_soak_script", REPO / "scripts" / "soak.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(scripts)
    return mod


def _named(cfg: dict) -> dict:
    return dict(cfg, backend=BACKEND_FROM_REFERENCE.get(cfg["backend"],
                                                        cfg["backend"]))


@pytest.mark.parametrize("seed", range(32))
def test_samplers_draw_the_jax_configs(jsoak, seed):
    assert soak.MESH_SHAPES == jsoak.MESH_SHAPES
    assert soak.FILTERS == jsoak.FILTERS
    assert soak.BACKENDS == [BACKEND_FROM_REFERENCE.get(b, b)
                             for b in jsoak.BACKENDS]
    for sampler in ("sample", "sample_converge"):
        mine, theirs = random.Random(seed), random.Random(seed)
        for _ in range(8):
            assert (getattr(soak, sampler)(mine)
                    == _named(getattr(jsoak, sampler)(theirs)))


def test_fault_samplers_draw_the_jax_specs(jsoak):
    for name in ("_sample_fault_spec", "_sample_reshape_fault_spec"):
        mine, theirs = random.Random(5), random.Random(5)
        got = [getattr(soak, name)(mine, 8) for _ in range(64)]
        assert got == [getattr(jsoak, name)(theirs, 8) for _ in range(64)]
    mine, theirs = random.Random(5), random.Random(5)
    assert ([soak._sample_serve_fault_spec(mine) for _ in range(64)]
            == [jsoak._sample_serve_fault_spec(theirs) for _ in range(64)])


def test_fma_exact_names_the_filters_whose_products_are_exact():
    """The converge soak holds a kernel backend bitwise to ``shifted``
    only where a tap's FMA and its multiply-then-add round alike: every
    tap 0 or a power of two."""
    from parallel_convolution_tpu_torch.ops.filters import get_filter

    got = {name: soak.fma_exact(get_filter(name)) for name in soak.FILTERS}
    assert got == {"blur3": True, "box3": False, "gaussian5": False,
                   "edge5": False, "sharpen3": False, "jacobi3": True}


def _main(argv) -> tuple[int, list[dict]]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = soak.main(argv)
    return rc, [json.loads(ln) for ln in out.getvalue().splitlines()
                if ln.startswith("{")]


@pytest.mark.parametrize("argv", [["--n", "8"], ["--converge", "--n", "4"]],
                         ids=["iterate", "converge"])
def test_soak_rows_all_ok_on_the_cpu(argv):
    rc, rows = _main([*argv, "--seed", "0", "--device", "cpu"])
    summary = rows.pop()
    assert rc == 0 and summary["failures"] == 0 and summary["device"] == "cpu"
    assert len(rows) == int(argv[-1]) and all(r["ok"] for r in rows)
    backends = {r["backend"] for r in rows}
    assert backends <= set(soak.BACKENDS) and len(backends) >= 2


def test_fault_trial_child_end_to_end(tmp_path):
    """One ``--fault-trial`` child: inject a checkpoint tear, crash,
    resume, byte-compare — the unit the supervised fault soak fans
    out."""
    out = tmp_path / "trial.json"
    p = subprocess.run(
        [sys.executable, "-m", "parallel_convolution_tpu_torch.soak",
         "--fault-trial", "checkpoint_write_shard:2", "--trial-seed", "3",
         "--trial-out", str(out), "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=300, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    row = json.loads(out.read_text())
    assert row["ok"] is True and row["device"] == "cpu"
    assert row["crashed"] is not None  # the injected kill really fired
    assert row["fired"] == [["checkpoint_write_shard", 2]]


@pytest.mark.parametrize("drill", [["--shard-kill", "1"],
                                   ["--autoscale", "1"]],
                         ids=["shard-kill", "autoscale"])
def test_fleet_drills_pass_on_the_cpu(drill, tmp_path):
    rc, rows = _main([*drill, "--seed", "0", "--device", "cpu",
                      "--state-dir", str(tmp_path)])
    summary = rows[-1]
    assert rc == 0 and summary["failures"] == 0, summary
    if drill[0] == "--shard-kill":
        assert summary["takeovers"] == 1
        assert summary["finals_per_request"] == {"sk-job0": 1}
    else:
        assert summary["cycles"] == [{"cycle": 0, "grew": True,
                                      "shrank": True}]
        assert summary["prewarmed_configs"] >= 1


def test_soak_runs_on_the_card_unless_asked(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        soak.main(["--n", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        soak.slot_grid((2, 2))
    grid = soak.slot_grid((2, 2), "cpu")
    assert grid.shape == (2, 2) and grid.slots == (grid.device,) * 4
