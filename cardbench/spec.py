"""Find a cell's parts by the names ``BENCHMARK.json`` gives them.

A configuration is the JSON file its entry names; a traffic mix is
``traffic/<name>.json``, whose ``kind`` names the module of ``kinds/``
that reads it; a per-layer metric is ``metrics/<name>.py``, whose
``read(ctx)`` returns the value or None, or else its family's reader,
``metrics/<name before its first dot>.py``.  A cell or a metric is added by
adding files and entries: nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    """One workload of the benchmark, its parts loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, bench: dict | None = None, config_over: dict | None = None,
         traffic_over: dict | None = None, home: Path = HERE) -> Cell:
    """The workload ``name`` with its configuration and traffic read from
    their files (``*_over`` replace keys of them: the tests' small sizes;
    ``home`` is the directory of ``traffic/``)."""
    bench = load_benchmark() if bench is None else bench
    works = {w["name"]: w for w in bench["workloads"]}
    if name not in works:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(works)}")
    w = works[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / cfg["file"]) as f:
        config = json.load(f)
    with open(home / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    config.update(config_over or {})
    traffic.update(traffic_over or {})
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def kind(name: str):
    """The module that runs a traffic kind."""
    return importlib.import_module(f"cardbench.kinds.{name}")


def metric_reader(name: str, home: Path = HERE):
    """``read(ctx)`` of the per-layer metric ``name``: ``metrics/<name>.py``,
    else its family's, ``metrics/<name before its first dot>.py``
    (``idle_share.solve`` is read by ``idle_share.py``)."""
    for stem in dict.fromkeys((name, name.split(".")[0])):
        path = home / "metrics" / f"{stem}.py"
        if path.is_file():
            break
    else:
        raise FileNotFoundError(f"no reader for metric {name!r} under "
                                f"{home / 'metrics'}")
    spec = importlib.util.spec_from_file_location(
        f"cardbench_metric_{stem.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
