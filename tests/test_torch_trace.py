"""The port's spans (``obs/trace.py``), its span-tree report
(``obs/trace_report.py``) and ``utils.tracing.device_trace`` against the
JAX package's, on the CPU.

* ``traceparent`` strings: the same parse of good and malformed headers,
  round trips;
* span records, nesting, error status, ``attach`` / ``emit_span``; one
  set of records through both packages' ``build_trees`` gives the same
  trees;
* ``sharded_converge`` runs under one ``device`` span whose ``iters`` is
  the count it returned, its model-attributed ``exchange`` / ``compute``
  children hanging from it in the report's tree;
* ``obs.trace_report`` printing what ``scripts/trace_report.py`` prints on
  one log, the Chrome ``trace_event`` file included;
* ``device_trace`` on the CPU writing a Chrome trace (the card's test,
  with the kernels' launch counts, is in ``test_torch_kernels_cuda.py``).
"""

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from parallel_convolution_tpu.obs import (
    events as jevents, metrics as jmetrics, trace as jtrace,
)
from parallel_convolution_tpu_torch.obs import (
    events, metrics, trace, trace_report,
)
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh, step
from parallel_convolution_tpu_torch.utils import tracing

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


@pytest.fixture(autouse=True)
def _fresh_obs():
    was = metrics.enabled(), jmetrics.enabled()
    for m in (metrics, jmetrics):
        m.set_enabled(True)
        m.reset()
    for e in (events, jevents):
        e.deconfigure()
    yield
    for e in (events, jevents):
        e.deconfigure()
    for m, on in zip((metrics, jmetrics), was):
        m.reset()
        m.set_enabled(on)


def _slots(shape):
    n = shape[0] * shape[1]
    return mesh.make_grid(shape, devices=",".join(["cpu"] * n))


HEADERS = [
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    " 00-" + "A1" * 16 + "-" + "0f" * 8 + "-01 ",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16,
    "", None, 42,
]


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parses_as_jax(header):
    got, want = trace.parse_traceparent(header), jtrace.parse_traceparent(
        header)
    assert (got is None) == (want is None)
    if got is not None:
        assert tuple(got) == tuple(want)
        assert trace.parse_traceparent(trace.format_traceparent(got)) == got
        assert trace.format_traceparent(got) == jtrace.format_traceparent(
            want)


def test_span_records_nesting_attach_and_errors(tmp_path):
    events.configure(tmp_path / "ev.jsonl")
    with trace.span("outer", k=1) as outer:
        with trace.span("inner") as inner:
            inner.set(n=2)
            inner.link(outer.context, kind="self")
        with pytest.raises(KeyError):
            with trace.span("bad"):
                raise KeyError("x")
    assert trace.current() is None
    with trace.attach(outer.context):
        sid = trace.emit_span("late", trace_id=outer.context.trace_id,
                              parent_id=outer.context.span_id, dur_s=0.5)
    spans = trace.span_records(events.read_events(tmp_path / "ev.jsonl"))
    by = {s["name"]: s for s in spans}
    assert [s["name"] for s in spans] == ["inner", "bad", "outer", "late"]
    assert by["inner"]["parent_id"] == by["outer"]["span_id"]
    assert by["inner"]["attrs"] == {"n": 2}
    assert by["inner"]["links"] == [{**outer.context.ref, "kind": "self"}]
    assert by["bad"]["status"] == "error" and "KeyError" in by["bad"][
        "attrs"]["error"]
    assert by["late"]["span_id"] == sid and by["late"]["dur_s"] == 0.5
    assert {s["trace_id"] for s in spans} == {outer.context.trace_id}
    metrics.set_enabled(False)
    assert trace.span("off") is trace.NULL_SPAN
    assert trace.emit_span("off", trace_id="t") is None


def test_build_trees_equal_jax_on_the_same_records(tmp_path):
    events.configure(tmp_path / "ev.jsonl")
    rng = np.random.default_rng(5)
    for _ in range(3):
        with trace.span("root"):
            for i in range(int(rng.integers(1, 4))):
                with trace.span(f"child{i}"):
                    with trace.span("leaf"):
                        pass
    trace.emit_span("orphan", trace_id="f" * 32, parent_id="e" * 16)
    trace.emit_span("remote", trace_id="d" * 32, parent_id="c" * 16,
                    remote_parent=True)
    recs = events.read_events(tmp_path / "ev.jsonl")
    spans = trace.span_records(recs)
    assert spans == jtrace.span_records(recs)
    trees = trace.build_trees(spans)
    assert trees == jtrace.build_trees(spans)
    assert trees["f" * 32]["orphans"] and trees["d" * 32]["roots"]
    assert sum(len(t["roots"]) for t in trees.values()) == 4


def test_converge_runs_under_one_device_span(tmp_path):
    events.configure(tmp_path / "ev.jsonl")
    x = np.random.default_rng(1).standard_normal((1, 24, 20)).astype(
        np.float32)
    out, done = step.sharded_converge(x, get_filter("jacobi3"), 0.05, 400,
                                      check_every=10, grid=_slots((2, 2)),
                                      backend="cuda_rdma", fuse=4)
    recs = events.read_events(tmp_path / "ev.jsonl")
    spans = trace.span_records(recs)
    dev = [s for s in spans if s["name"] == "device"]
    assert len(dev) == 1 and dev[0]["attrs"]["iters"] == done
    assert dev[0]["attrs"]["source"] == "sharded_converge"
    tree = trace.build_trees(spans)[dev[0]["trace_id"]]
    assert tree["roots"] == [dev[0]["span_id"]] and not tree["orphans"]
    kids = [tree["spans"][k]["name"]
            for k in tree["children"][dev[0]["span_id"]]]
    assert sorted(kids) == ["compute", "exchange"]
    ex = [r for r in recs if r["kind"] == "exchange"]
    assert len(ex) == 1 and ex[0]["iters"] == done and ex[0]["wall_s"] > 0
    assert metrics.histogram("pctpu_step_seconds", "", ("backend",)).quantile(
        0.5, backend="cuda_rdma") is not None
    rep, rc = trace_report.analyze(recs)
    assert rc == 0 and rep["roots_per_trace_ok"] and rep["orphan_spans"] == 0
    path = rep["critical_paths"][dev[0]["trace_id"]]
    assert path[0]["name"] == "device"
    # The stream: no device span (the JAX stream has none), one readback a
    # chunk.
    before = len(spans)
    list(step.sharded_converge_stream(x, get_filter("jacobi3"), 0.05, 40,
                                      check_every=10, grid=_slots((2, 2))))
    assert len(trace.span_records(events.read_events(
        tmp_path / "ev.jsonl"))) == before


def test_trace_report_prints_what_the_jax_script_prints(tmp_path, capsys,
                                                        monkeypatch):
    events.configure(tmp_path / "ev.jsonl")
    x = np.random.default_rng(2).standard_normal((1, 16, 16)).astype(
        np.float32)
    for backend in ("cuda", "shifted"):
        with trace.span("request", backend=backend):
            step.sharded_converge(x, get_filter("jacobi3"), 0.1, 60,
                                  check_every=5, grid=_slots((2, 2)),
                                  backend=backend)
    events.deconfigure()
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    jreport = importlib.import_module("trace_report")
    chrome = tmp_path / "chrome.json"
    argv = ["--events", str(tmp_path / "ev.jsonl"), "--chrome", str(chrome)]
    monkeypatch.setattr(sys, "argv", ["trace_report.py", *argv])
    jrc = jreport.main()
    jout = capsys.readouterr().out
    jchrome = chrome.read_text()
    rc = trace_report.main(argv)
    out = capsys.readouterr().out
    assert rc == jrc == 0 and out == jout
    assert chrome.read_text() == jchrome
    got = json.loads(out.splitlines()[-1])
    assert got["traces"] == 2 and got["orphan_spans"] == 0
    assert got["by_name"]["device"]["count"] == 2
    evs = json.loads(jchrome)["traceEvents"]
    assert {e["name"] for e in evs if e["ph"] == "X"} == {
        "request", "device", "exchange", "compute"}
    # A log with no span fails, in both.
    (tmp_path / "empty.jsonl").write_text("")
    assert trace_report.main(["--events", str(tmp_path / "empty.jsonl"),
                              "--quiet"]) == 1


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.ones(64, 64)
    with tracing.device_trace(tmp_path / "tr", device="cpu") as tr:
        (x @ x).sum()
    assert tr.path.parent == tmp_path / "tr" and tr.path.is_file()
    names = {e.get("name", "") for e in tr.events()}
    assert any("mm" in n for n in names)
    assert tracing.kernel_counts(tr, ("stencil_step_kernel",)) == {
        "stencil_step_kernel": 0}


def test_device_trace_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with tracing.device_trace(tmp_path):
            pass
