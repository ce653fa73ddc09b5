"""The benchmark's description: every part found by name, a cell or a
metric added by files alone, and BENCHMARK.json within the limits its
format sets."""

import json
import re
import shutil

import pytest

from cardbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(workload):
    cell = spec.cell(workload)
    assert cell.chips in (1, 4)
    spec.kind(cell.traffic["kind"])
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_reader_returns_nothing_from_nothing(metric):
    assert spec.metric_reader(metric)({}) is None


def test_a_cell_and_a_metric_added_by_files_alone(tmp_path):
    home = tmp_path / "cardbench"
    for part in ("configs", "traffic", "metrics"):
        shutil.copytree(spec.HERE / part, home / part)
    (home / "traffic" / "rgb4096_resident.json").write_text(json.dumps({
        "kind": "resident_jobs", "channels": 3, "height": 4096,
        "width": 4096, "window": 64, "windows_drawn": 4}))
    (home / "metrics" / "jobs_seen.iterate.py").write_text(
        "def read(ctx):\n    return ctx.get('jobs')\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "c4_rgb4096_resident", "config": "rgb_blur3_u8",
        "traffic": "rgb4096_resident", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "jobs_seen.iterate", "unit": "jobs", "better": "higher",
        "source": "program_counter", "layer": "chunk loop",
        "moves": "gpx_per_s", "workloads": ["c4_rgb4096_resident"]})
    for m in bench["end_to_end"]:
        if m["name"] == "gpx_per_s":
            m["workloads"].append("c4_rgb4096_resident")
    cell = spec.cell("c4_rgb4096_resident", bench, home=home)
    assert cell.traffic["height"] == 4096
    assert cell.config["filter"] == "blur3"
    assert [m["name"] for m in cell.per_layer] == ["jobs_seen.iterate"]
    assert spec.metric_reader("jobs_seen.iterate", home)({"jobs": 3}) == 3


def test_benchmark_json_keeps_to_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cardbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    configs = {c["name"]: c for c in BENCH["configs"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("cardbench/")
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        data = json.loads((spec.ROOT / c["file"]).read_text())
        for k in c["reduced"]:
            assert k in data and NAME.match(k)
            assert not k.endswith(("_dim", "_rank", "_size"))
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in cells
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]


def test_a_family_reader_serves_its_dotted_names(tmp_path):
    """``idle_share.<cells>`` is read by ``idle_share.py`` until a file of
    the whole name is added, which then reads it; a name with neither is
    refused."""
    home = tmp_path / "cardbench"
    shutil.copytree(spec.HERE / "metrics", home / "metrics")
    ctx = {"jobs": 4, "launches": {"k": 28}}
    assert spec.metric_reader("launches_per_job.new", home)(ctx) == 7
    (home / "metrics" / "launches_per_job.new.py").write_text(
        "def read(ctx):\n    return -1\n")
    assert spec.metric_reader("launches_per_job.new", home)(ctx) == -1
    assert spec.metric_reader("launches_per_job.other", home)(ctx) == 7
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_family.new", home)
