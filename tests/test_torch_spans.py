"""The port's spans on the profiler's clock (``utils.tracing.span``) and
their reduction (``cardbench/spans.py``), on the CPU.

* ``tracing.span`` opens a ``pctpu.<name>`` range only while a profiler
  records and obs is on; otherwise it never calls ``record_function``;
* an ``obs.trace`` span shows in the profiler's trace under the same name,
  its event-log record unchanged;
* ``run_images`` traced through the harness's window: one copy in and one
  copy out a call, one ``step.chunk`` a chunk;
* ``mg_converge``: one ``mg.readback`` a cycle and a span for each level;
* ``spans.reduce`` and ``spans.merge`` on synthetic events: nesting, a gap
  split across two spans, a kernel matched to its launch by correlation,
  the idle seconds summing to ``window_s - busy_s``, the mean over cards.

The spans between cards (``rdma.open`` / ``rdma.close``) need the card:
``test_torch_kernels_cuda.py -k spans``.
"""

import numpy as np
import pytest
import torch

from cardbench import spans, trace as bench_trace
from parallel_convolution_tpu_torch.models import ConvolutionModel
from parallel_convolution_tpu_torch.obs import events, metrics, trace
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh
from parallel_convolution_tpu_torch.solvers import multigrid as mg
from parallel_convolution_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def _obs_on():
    was = metrics.enabled()
    metrics.set_enabled(True)
    events.deconfigure()
    yield
    events.deconfigure()
    metrics.set_enabled(was)


def _profiled(fn):
    """The Chrome trace events of ``fn()`` under a CPU profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    return _events(prof)


def _events(prof):
    import json
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _annotations(evs):
    return [e["name"] for e in evs if e.get("cat") == "user_annotation"]


@pytest.fixture
def counted(monkeypatch):
    """``torch.profiler.record_function``, counting its calls."""
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return calls


def test_span_is_a_range_only_while_a_profiler_records(counted):
    def work():
        with tracing.span("entry.copy_in"):
            torch.ones(4).sum()

    work()
    assert counted == []
    assert tracing.span("x") is tracing.NULL_RANGE
    evs = _profiled(work)
    assert counted == ["pctpu.entry.copy_in"]
    assert _annotations(evs) == ["pctpu.entry.copy_in"]
    metrics.set_enabled(False)
    counted.clear()
    evs = _profiled(work)
    assert counted == [] and _annotations(evs) == []


def test_a_range_entered_is_exited_after_the_profiler_stops():
    acts = [torch.profiler.ProfilerActivity.CPU]
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    rng = tracing.span("late")
    rng.__enter__()
    prof.__exit__(None, None, None)
    assert tracing.span("late") is tracing.NULL_RANGE
    rng.__exit__(None, None, None)


def test_obs_trace_span_shows_in_the_profiler_with_its_record_unchanged(
        tmp_path, counted):
    def request(log):
        events.configure(tmp_path / log)
        with trace.span("copy_in", batch=2):
            torch.ones(4).sum()
        events.deconfigure()

    request("plain.jsonl")
    assert counted == []
    evs = _profiled(lambda: request("traced.jsonl"))
    assert _annotations(evs) == ["pctpu.copy_in"]
    recs = [trace.span_records(events.read_events(tmp_path / log))
            for log in ("plain.jsonl", "traced.jsonl")]
    assert [len(r) for r in recs] == [1, 1]
    plain, traced = recs[0][0], recs[1][0]
    assert sorted(plain) == sorted(traced)
    for k in ("name", "parent_id", "status", "attrs", "kind"):
        assert plain.get(k) == traced.get(k)


def _window(fn):
    """``fn()`` in the harness's traced window, its summary with the
    program's spans."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_trace, "summarize", spans.summarize)
        with bench_trace.Window(True) as win:
            fn()
    return win.summary


def test_run_images_spans_a_call():
    model = ConvolutionModel("blur3", grid=mesh.make_grid((2, 2),
                                                          device="cpu"),
                             backend="shifted", fuse=2)
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (18, 22, 3), dtype=np.uint8)
            for _ in range(2)]
    calls, iters = 3, 5   # two chunks of 2 and a tail of 1, a call

    def run():
        for _ in range(calls):
            with bench_trace.span("cardbench.call"):
                model.run_images(imgs, iters)

    summary = _window(run)
    s = summary["spans"]
    assert s["entry.copy_in"]["count"] == calls
    assert s["entry.copy_out"]["count"] == calls
    assert s["step.chunk"]["count"] == 3 * calls
    for name in ("step.prepare", "step.join", "step.build", "step.carry_in",
                 "step.carry_out", "step.obs"):
        assert s[name]["count"] == calls, name
    assert s["entry.copy_in"]["host_s"] > 0
    # The CPU has no device trace: every second of the window is idle.
    assert summary["busy_s"] == 0
    assert sum(r["idle_s"] for r in s.values()) == pytest.approx(
        summary["window_s"])


def test_mg_converge_spans_each_cycle_and_level():
    x = np.random.default_rng(4).standard_normal((1, 48, 40)).astype(
        np.float32)

    out = {}

    def run():
        out["res"] = mg.mg_converge(x, get_filter("jacobi3"), 1e-3, 200,
                                    device="cpu")[1]

    summary = _window(run)
    s, res = summary["spans"], out["res"]
    assert res.levels > 1
    assert s["mg.readback"]["count"] == res.cycles
    assert s["mg.cycle"]["count"] == res.cycles
    assert s["mg.obs"]["count"] == res.cycles
    assert s["mg.build"]["count"] == 1
    for i in range(res.levels):
        # Down and up for each level above the coarsest, once for it.
        want = 1 if i == res.levels - 1 else 2
        assert s[f"mg.L{i}"]["count"] == want * res.cycles, i
    assert not any(n.startswith("mg.L") and n[4:].isdigit()
                   and int(n[4:]) >= res.levels for n in s)
    # The CPU has no device trace: no layer's idle is read there.
    assert summary["busy_s"] == 0
    assert spans.layer_idle_ms(summary, spans.LAYERS["solver_idle_ms"],
                               res.cycles) is None


def _x(name, ts, dur, cat="user_annotation", tid=1, **args):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
         "pid": 7, "tid": tid}
    if args:
        e["args"] = args
    return e


SYNTHETIC = [
    _x("cardbench.window", 0, 100),
    _x("cardbench.job", 0, 100),
    _x("pctpu.step.carry_in", 0, 30),
    _x("pctpu.rdma.open", 5, 20),            # inside carry_in
    _x("pctpu.step.chunk", 30, 40),
    _x("pctpu.rdma.close", 70, 22),
    _x("aten::copy_", 72, 5, cat="cpu_op"),  # a torch op: never innermost
    _x("cudaLaunchKernel", 10, 1, cat="cuda_runtime", correlation=1),
    _x("cudaLaunchKernel", 40, 1, cat="cuda_runtime", correlation=2),
    _x("cudaMemcpyAsync", 95, 1, cat="cuda_runtime", correlation=3),
    # Another thread's span, open beside close and after it.
    _x("pctpu.step.obs", 90, 5, tid=2),
    _x("k1", 12, 8, cat="kernel", correlation=1),
    _x("k2", 45, 40, cat="kernel", correlation=2),   # runs into close
    _x("Memcpy DtoH", 96, 2, cat="gpu_memcpy", correlation=3),
]


def test_reduce_puts_idle_and_device_time_down_to_spans():
    s = spans.reduce(SYNTHETIC, 0, 100)
    # Idle gaps: [0, 12) [20, 45) [85, 96) [98, 100).
    us = 1e-6
    # [0, 12): carry_in to 5, open nested in it from 5; [20, 45): open
    # to 25, carry_in to 30, chunk.
    assert s["step.carry_in"]["idle_s"] == pytest.approx(5 * us + 5 * us)
    assert s["rdma.open"]["idle_s"] == pytest.approx(7 * us + 5 * us)
    assert s["step.chunk"]["idle_s"] == pytest.approx(15 * us)
    # [85, 96): close alone to 90; from 90 to 92 close and obs (another
    # thread's) are open together, and obs, the later, is the innermost;
    # obs alone to 95, then no span.
    assert s["rdma.close"]["idle_s"] == pytest.approx(5 * us)
    assert s["step.obs"]["idle_s"] == pytest.approx(5 * us)
    assert s[""]["idle_s"] == pytest.approx(1 * us + 2 * us)
    summary = bench_trace.summarize(SYNTHETIC)
    assert sum(r["idle_s"] for r in s.values()) == pytest.approx(
        summary["window_s"] - summary["busy_s"])
    assert s["rdma.open"]["device_s"] == pytest.approx(8 * us)
    assert s["step.chunk"]["device_s"] == pytest.approx(40 * us)
    # The copy is launched at 95, when its thread has no span open.
    assert s[""]["device_s"] == pytest.approx(2 * us)
    assert s["rdma.open"]["count"] == 1 and s["step.chunk"]["count"] == 1
    assert s["step.carry_in"]["host_s"] == pytest.approx(30 * us)
    assert "aten::copy_" not in s and "cardbench.job" not in s


def test_merge_takes_the_mean_over_the_cards():
    a = spans.reduce(SYNTHETIC, 0, 100)
    b = spans.reduce([e for e in SYNTHETIC if e["name"] != "pctpu.step.obs"],
                     0, 100)
    m = spans.merge([a, b])
    assert m["step.obs"]["count"] == pytest.approx(0.5)
    assert m["rdma.close"]["idle_s"] == pytest.approx(
        (a["rdma.close"]["idle_s"] + b["rdma.close"]["idle_s"]) / 2)
    merged = spans.merge_summaries([spans.summarize(SYNTHETIC)] * 2)
    assert merged["spans"]["rdma.open"]["idle_s"] == pytest.approx(
        a["rdma.open"]["idle_s"])
    assert merged["window_s"] == pytest.approx(100e-6)
    assert spans.layer_idle_ms(merged, spans.LAYERS["exchange_idle_ms"],
                               2) == \
        pytest.approx(1e3 * (a["rdma.open"]["idle_s"]
                             + a["rdma.close"]["idle_s"]) / 2)
    # A program that opens no such span gives no value.
    assert spans.layer_idle_ms(merged, spans.LAYERS["entry_idle_ms"],
                               2) is None
    assert spans.layer_idle_ms(None, spans.LAYERS["exchange_idle_ms"],
                               2) is None
