"""The storage-chaos matrix in the port (``python -m
parallel_convolution_tpu_torch.serving.chaos_matrix``) held against the
JAX package's ``scripts/chaos_matrix.py`` on the CPU.

* ``MODES`` and ``WORKLOADS`` are JAX's;
* ``run_matrix(workloads=("shard",), modes=("enospc", "kill"))`` passes
  on the CPU, and its cells (names, outcome, the disk faults each
  injected) equal the JAX script's for the same arguments;
* the whole matrix, its site drills and the ENOSPC degrade drill pass on
  the CPU, every cell's fault fired;
* the module's main writes the summary row to ``--out`` and exits 0; the
  soak's ``--chaos-matrix 1`` runs it.

Tolerance: cell rows and JSON equal.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import pytest

from parallel_convolution_tpu_torch import soak
from parallel_convolution_tpu_torch.serving import chaos_matrix

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jmatrix():
    """The JAX script as a module (it imports its siblings ``_path`` and
    ``_chaos_common``)."""
    scripts = str(REPO / "scripts")
    sys.path.insert(0, scripts)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_chaos_matrix_script", REPO / "scripts" / "chaos_matrix.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        yield mod
    finally:
        sys.path.remove(scripts)


def _cells(row):
    return [(c["cell"], c["workload"], c["mode"], c["ok"], c["injected"])
            for c in row["cells"]]


def test_modes_and_workloads_are_jax(jmatrix):
    assert chaos_matrix.MODES == jmatrix.MODES
    assert chaos_matrix.WORKLOADS == jmatrix.WORKLOADS


def test_shard_row_cells_equal_jax(jmatrix):
    kw = dict(seed=0, workloads=("shard",), modes=("enospc", "kill"),
              log=lambda m: None)
    row = chaos_matrix.run_matrix(device="cpu", **kw)
    jrow = jmatrix.run_matrix(**kw)
    assert row["failures"] == 0, row["failure_detail"]
    assert jrow["failures"] == 0, jrow["failure_detail"]
    assert _cells(row) == _cells(jrow)
    assert [c[0] for c in _cells(row)] == ["shardxenospc", "shardxkill"]
    assert row["site_drills"] == jrow["site_drills"]
    assert row["enospc_drill"]["degraded_window"]
    assert row["enospc_drill"]["rearmed"]
    assert row["enospc_drill"]["finalized_carried"]


def test_whole_matrix_passes_on_the_cpu():
    row = chaos_matrix.run_matrix(seed=1, device="cpu", log=lambda m: None)
    assert row["failures"] == 0, row["failure_detail"]
    assert row["cells_total"] == len(chaos_matrix.MODES) * len(
        chaos_matrix.WORKLOADS) and row["cells_failed"] == 0
    for c in row["cells"]:
        if c["mode"] != "kill":
            site = "cache_spill" if c["workload"] == "cache" else "wal_write"
            assert c["injected"].get(f"{site}={c['mode']}", 0) >= 1, c


def test_main_writes_the_row_and_the_soak_runs_it(tmp_path):
    out = tmp_path / "storage.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = chaos_matrix.main(["--device", "cpu", "--seed", "2",
                                "--out", str(out)])
    assert rc == 0
    row = json.loads(out.read_text())
    assert row["failures"] == 0 and row["cells_total"] == 30
    printed = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert "cells" not in printed and printed["seed"] == 2
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = soak.main(["--chaos-matrix", "1", "--seed", "3",
                        "--device", "cpu"])
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and summary["summary"] == "chaos-matrix"
    assert summary["failures"] == 0 and summary["per_cycle"][0]["seed"] == 3
