"""Nothing the harness runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from cardbench import run, spec

HARNESS = sorted(p for p in spec.HERE.rglob("*.py")
                 if "tests" not in p.relative_to(spec.HERE).parts)


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True)
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["parallel_convolution_tpu_torch.ops",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["parallel_convolution_tpu.ops", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "parallel_convolution_tpu"]


def test_the_harness_imports_no_jax():
    kinds = sorted({spec.cell(w["name"]).traffic["kind"]
                    for w in spec.load_benchmark()["workloads"]})
    metrics = [m["name"] for m in spec.load_benchmark()["per_layer"]]
    code = ("import cardbench.run, cardbench.sets, cardbench.control\n"
            "from cardbench import spec\n"
            + "".join(f"spec.kind({k!r})\n" for k in kinds)
            + "".join(f"spec.metric_reader({m!r})\n" for m in metrics)
            + "from parallel_convolution_tpu_torch.models import "
              "ConvolutionModel\n"
              "from parallel_convolution_tpu_torch.solvers import multigrid\n"
              "from parallel_convolution_tpu_torch.parallel import step, "
              "multihost\n")
    assert not _loaded(code) & set(run.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    loaded = _loaded("import cardbench.reference, cardbench.inputs, "
                     "cardbench.roofline")
    assert not loaded & {"parallel_convolution_tpu_torch", *run.FORBIDDEN}


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: p.name)
def test_no_source_names_jax(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in run.FORBIDDEN, (path, n)


def test_a_run_refuses_without_the_port_or_a_card(tmp_path):
    """A directory of only the benchmark's files (no port) fails, and so
    does the checkout on a machine without a card."""
    import shutil

    import torch

    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    dirs = [tmp_path] + ([] if torch.cuda.is_available() else [spec.ROOT])
    for cwd in dirs:
        out = subprocess.run(
            [sys.executable, "-m", "cardbench.run", "--workload",
             "c4_rgb65536_resident", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout
