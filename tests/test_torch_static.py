"""The port's static gate: the six rules of ``scripts/static_check.py``
held over the PyTorch package on every tier-1 run.

The script's own leg (``scripts/run_t1.sh --static``) reads only the JAX
package, ``scripts/`` and ``tests/``.  Here the same rule functions read

* every ``.py`` under ``parallel_convolution_tpu_torch/``,
* ``tests/test_torch_*.py`` and ``tests/_torch_jax_state.py``,
* ``chip_smoke.py``,

and each must return no problem.  ``check_dispatch_ladders`` takes the
first ``parallel/step.py`` it is given, so it is given the port's files
only and holds the port's dispatcher to the JAX freeze (at most one
``backend ==`` and no ``rank ==``).  Two guards keep the gate honest: the
file set is the port's (not empty, not a wrong root), and each rule
flags a fault written into a tree of the port's layout.

The script is loaded by path (it imports only the standard library).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "parallel_convolution_tpu_torch"

# The package's module count when this gate was written: a scan that
# finds fewer has lost part of the tree.
MIN_MODULES = 88

RULES = ("check_compiles", "check_bare_except", "check_stats_locking",
         "check_shared_curve_writes", "check_dispatch_ladders",
         "check_guarded_disk_writes")


@pytest.fixture(scope="module")
def sc():
    spec = importlib.util.spec_from_file_location(
        "static_check", REPO / "scripts" / "static_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _package_files(root: Path) -> list[Path]:
    return [p for p in sorted(root.rglob("*.py"))
            if "__pycache__" not in p.parts]


def port_files() -> list[Path]:
    """The files the gate reads: the package, its tests, the smoke."""
    tests = sorted((REPO / "tests").glob("test_torch_*.py"))
    return (_package_files(PKG) + tests
            + [REPO / "tests" / "_torch_jax_state.py", REPO / "chip_smoke.py"])


def test_port_file_set_is_the_port():
    files = port_files()
    assert all(p.is_file() for p in files)
    modules = [p.relative_to(PKG) for p in files if PKG in p.parents]
    assert len(modules) >= MIN_MODULES, (
        f"{len(modules)} modules under {PKG.name}/, expected at least "
        f"{MIN_MODULES}")
    assert Path("parallel", "step.py") in modules
    for tree in ("serving", "obs", "utils"):
        assert any(m.parts[0] == tree and len(m.parts) > 1
                   for m in modules), f"no module under {tree}/"
    step = next(f for f in files if f.parts[-2:] == ("parallel", "step.py"))
    assert step == PKG / "parallel" / "step.py"
    assert Path(__file__).resolve() in files


@pytest.mark.parametrize("rule", RULES)
def test_port_passes_static_rule(sc, rule):
    problems = getattr(sc, rule)(port_files())
    assert problems == [], f"{rule}: {len(problems)} problem(s):\n" + "\n".join(
        problems)


# Fault fixtures: (module path under the package, source, rule).  The
# bare-except source keeps ``except:`` off the start of this file's lines,
# which the JAX leg's bare-except rule reads.
_FAULTS = {
    "unguarded_write": (
        ("serving", "new_report.py"),
        "with open('row.json', 'w') as f:\n"
        "    f.write('{}')\n",
        "check_guarded_disk_writes"),
    "bare_except": (
        ("serving", "new_handler.py"),
        "try:\n"
        "    pass\n"
        "except:\n"
        "    pass\n",
        "check_bare_except"),
    "second_backend_arm": (
        ("parallel", "step.py"),
        "def step(backend):\n"
        "    sep = backend == 'cuda_sep'\n"
        "    if backend == 'cuda_rdma':\n"
        "        return sep\n",
        "check_dispatch_ladders"),
}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_rules_flag_faults_in_the_port_layout(sc, tmp_path, fault):
    parts, source, rule = _FAULTS[fault]
    bad = tmp_path.joinpath(PKG.name, *parts)
    bad.parent.mkdir(parents=True)
    bad.write_text(source)
    problems = getattr(sc, rule)(_package_files(tmp_path / PKG.name))
    assert len(problems) == 1, problems
    assert problems[0].startswith(str(bad))
