"""The port's obs layer (``parallel_convolution_tpu_torch/obs/``,
``utils/tracing.py``, ``utils/evidence_io.py``) against the JAX package's,
on the CPU.

* metrics: the same sequence of operations gives the same snapshot and
  the same Prometheus text in both registries; disabled mode records
  nothing;
* the event log: schema, rotation, ``seq`` continuity, the ``events_emit``
  fault site (a dropped line, no recursion);
* halo-byte accounting equal to JAX over grids, radii, fuses, storages and
  boundaries;
* a port ``sharded_iterate`` on CPU slots beside JAX ``sharded_iterate``
  on the 8-device CPU mesh, obs on: the exchange events' bytes, rounds and
  iterations and the ``pctpu_halo_bytes_total`` series are equal.  The
  exchange fractions are the cost models' (the H100's here, the TPU
  roofline there), so they are only held to [0, 1];
* one fault plan through both packages: the same ``fault_trigger`` /
  ``retry`` / ``degrade`` kinds and sites;
* one snapshot through both packages' checkpoints: equal byte counts;
* ``obs.report`` printing what ``scripts/obs_report.py`` prints on one log
  and snapshot; ``scripts/perf_gate.py`` taking the port's bench row and
  metrics snapshot;
* ``PhaseTimer`` (thread safety, row flattening, fences) and
  ``rewrite_shared_jsonl``.
"""

import importlib
import json
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_jax_state import reset_jax_state

from parallel_convolution_tpu.obs import (
    attribution as jattribution, events as jevents, metrics as jmetrics,
)
from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.parallel import step as jstep
from parallel_convolution_tpu.resilience import faults as jfaults
from parallel_convolution_tpu.resilience import retry as jretry
from parallel_convolution_tpu.utils import checkpoint as jcheckpoint
from parallel_convolution_tpu_torch.obs import (
    attribution, events, metrics, report,
)
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh, step
from parallel_convolution_tpu_torch.resilience import diskio, faults, retry
from parallel_convolution_tpu_torch.utils import (
    bench, checkpoint, evidence_io, imageio, tracing,
)
from parallel_convolution_tpu_torch.utils.config import BACKEND_FROM_REFERENCE

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
DIRS = attribution.DIRECTIONS


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Both packages' registries enabled and empty, no event log; the
    prior state restored afterwards, and the JAX package's build caches,
    probe verdicts and fault plan cleared (a JAX walk this file drives
    with ``fallback=True`` must not leave a cached runner that hides a
    later test's injected compile fault)."""
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
    reset_jax_state()


def _script(name: str):
    """A JAX script of ``scripts/`` as a module (its ``_path`` import
    needs the directory on sys.path)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    return importlib.import_module(name)


def _jax_mesh(shape):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _slots(shape):
    n = shape[0] * shape[1]
    return mesh.make_grid(shape, devices=",".join(["cpu"] * n))


# ---------------------------------------------------------------- metrics
def _metric_ops(mod, seed: int):
    """One seeded sequence of operations on a fresh registry of ``mod``."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    c = reg.counter("ops_total", "ops done", ("kind", "site"))
    g = reg.gauge("level", "a level", ("key",))
    h = reg.histogram("lat_seconds", "latency", ("b",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    plain = reg.histogram("plain_seconds")
    for _ in range(200):
        op = int(rng.integers(0, 5))
        if op == 0:
            c.inc(float(rng.integers(1, 4)), kind=f"k{rng.integers(0, 3)}",
                  site='we"ird\nsite' if rng.random() < 0.2 else "a")
        elif op == 1:
            g.set(float(rng.normal()), key=f"g{rng.integers(0, 2)}")
        elif op == 2:
            g.max(float(rng.normal()), key="hw")
        elif op == 3:
            h.observe(float(rng.exponential(0.05)),
                      b=f"b{rng.integers(0, 2)}")
        else:
            plain.observe(float(rng.exponential(2.0)))
    stats = mod.MirroredStats(reg.gauge("stats", "", ("key", "lane")),
                              {"hits": 0}, lane="x")
    stats["hits"] += 3
    stats["gone"] = 1
    del stats["gone"]
    g.remove(key="g0")
    quant = [h.quantile(q, b="b0") for q in (0.5, 0.95, 0.99)]
    return reg, dict(stats), quant


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_text_equals_jax_for_the_same_operations(seed):
    reg, stats, quant = _metric_ops(metrics, seed)
    jreg, jstats, jquant = _metric_ops(jmetrics, seed)
    assert reg.render_text() == jreg.render_text()
    assert reg.snapshot() == jreg.snapshot()
    assert (stats, quant) == (jstats, jquant) and stats == {"hits": 3}
    text = reg.render_text()
    parsed = metrics.parse_text(text)
    assert parsed == jmetrics.parse_text(text)
    assert parsed["stats"] == [({"key": "hits", "lane": "x"}, 3.0)]


def test_metric_semantics_and_shape_guard():
    c = metrics.counter("t_total", "", ("a",))
    assert metrics.counter("t_total", "", ("a",)) is c
    with pytest.raises(ValueError):
        metrics.gauge("t_total")
    with pytest.raises(ValueError):
        c.inc(-1, a="x")
    with pytest.raises(ValueError):
        c.inc(b="x")
    with pytest.raises(ValueError):
        metrics.histogram("bad_seconds", buckets=(1.0, float("inf")))
    with pytest.raises(ValueError):
        metrics.parse_text("malformed{ 3")


def test_disabled_mode_records_nothing():
    metrics.set_enabled(False)
    c = metrics.counter("off_total", "", ("a",))
    c.inc(a="x")
    metrics.gauge("off_g").set(3.0)
    metrics.histogram("off_seconds").observe(1.0)
    assert c.value(a="x") == 0
    snap = metrics.snapshot()
    assert snap["enabled"] is False
    assert all(not m["series"] for m in snap["metrics"])
    # The iterate path and the recorder do nothing either.
    assert attribution.record_step(
        backend="shifted", grid=(2, 2), block_hw=(4, 4), radius=1, fuse=1,
        iters=2, channels=1, storage="f32", boundary="zero", wall_s=None,
        shape=(1, 8, 8)) is None
    step.sharded_iterate(np.ones((1, 8, 8), np.float32) * 9,
                         get_filter("blur3"), 2, grid=_slots((2, 2)))
    assert all(not m["series"] for m in metrics.snapshot()["metrics"])


# ---------------------------------------------------------------- events
def test_event_schema_rotation_and_seq_continuity(tmp_path):
    log = events.EventLog(tmp_path / "ev.jsonl", max_bytes=4096, keep=3)
    for i in range(120):
        log.emit("heartbeat", i=i, pad="x" * 40)
    log.close()
    gens = log.generations()
    assert len(gens) == 4 and gens[-1] == tmp_path / "ev.jsonl"
    assert all(g.stat().st_size <= 4096 for g in gens)
    recs = events.read_events(tmp_path / "ev.jsonl")
    seqs = [r["seq"] for r in recs]
    assert seqs == list(range(seqs[0], 121)) and seqs[0] > 1  # oldest gone
    assert [r["i"] for r in recs] == [s - 1 for s in seqs]
    for r in recs:
        assert events.validate_event(r) == jevents.validate_event(r) == []
    with pytest.raises(ValueError):
        log.emit("no_such_kind")
    with pytest.raises(ValueError):
        log.emit("heartbeat", seq=3)
    assert events.KINDS == jevents.KINDS


@pytest.mark.parametrize("rec", [
    {"seq": 1, "ts": 1.0, "perf": 2.0, "kind": "exchange"},
    {"seq": 0, "ts": 1.0, "perf": 2.0, "kind": "exchange"},
    {"seq": True, "ts": 1.0, "perf": 2.0, "kind": "exchange"},
    {"seq": 2, "ts": "x", "perf": 2.0, "kind": "retry"},
    {"seq": 2, "perf": 2.0, "kind": "bogus"},
    ["not", "a", "dict"],
])
def test_validate_event_agrees_with_jax(rec):
    assert events.validate_event(rec) == jevents.validate_event(rec)


def test_events_emit_fault_drops_a_line_without_recursion(tmp_path):
    log = events.configure(tmp_path / "ev.jsonl")
    events.emit("heartbeat", n=1)
    with faults.injected("events_emit:2"):
        events.emit("heartbeat", n=2)      # hit 1: written
        events.emit("heartbeat", n=3)      # hit 2: fires, the line drops
        events.emit("heartbeat", n=4)
    recs = events.read_events(tmp_path / "ev.jsonl")
    kinds = [(r["kind"], r.get("n"), r["seq"]) for r in recs]
    # The fault_trigger went out through the same log (its inner emit is
    # not consulted again), then the faulted line's seq is the gap.
    assert kinds == [("heartbeat", 1, 1), ("heartbeat", 2, 2),
                     ("fault_trigger", None, 3), ("heartbeat", 4, 5)]
    assert log.dropped == 1
    assert metrics.counter("pctpu_events_dropped_total").value() == 1
    # A disk mode on the site translates and counts the injection.
    diskio.install_modes("events_emit=eio")
    try:
        with faults.injected("events_emit:1"):
            events.emit("heartbeat", n=6)
        assert diskio.injected_counts()["events_emit=eio"] >= 1
    finally:
        diskio.uninstall_modes()
    assert log.dropped == 2


def test_emit_without_a_log_or_with_obs_off_is_a_no_op(tmp_path):
    events.emit("heartbeat")
    log = events.configure(tmp_path / "ev.jsonl")
    metrics.set_enabled(False)
    events.emit("heartbeat")
    log.close()
    assert not (tmp_path / "ev.jsonl").exists()   # opened at the first line


# ------------------------------------------------------- halo accounting
@pytest.mark.parametrize("grid", [(1, 1), (1, 4), (2, 2), (4, 1), (3, 5)])
@pytest.mark.parametrize("storage", ["f32", "bf16", "u8"])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_halo_bytes_equal_jax(grid, storage, boundary):
    block = (24, 40)
    for radius in (1, 2):
        for fuse in (1, 3):
            for ch in (1, 3):
                assert attribution.halo_bytes_per_round(
                    grid, block, radius, fuse, ch, storage, boundary) == \
                    jattribution.halo_bytes_per_round(
                        grid, block, radius, fuse, ch, storage, boundary)
            for iters in (0, 1, 7, 10):
                assert attribution.halo_bytes_total(
                    grid, block, radius, fuse, iters, 3, storage,
                    boundary) == jattribution.halo_bytes_total(
                    grid, block, radius, fuse, iters, 3, storage, boundary)
            assert attribution.volume_face_bytes_per_round(
                grid, block, 16, radius, fuse, 2, storage, boundary) == \
                jattribution.volume_face_bytes_per_round(
                    grid, block, 16, radius, fuse, 2, storage, boundary)
    assert attribution.exchange_rounds(10, 4) == jattribution.exchange_rounds(
        10, 4) == (2, 2)


def test_split_contract():
    kw = dict(backend="cuda", storage="f32", shape=(3, 64, 64),
              platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    one = attribution.predicted_exchange_split((1, 1), (64, 64), 1, 1, **kw)
    assert one == {"exchange_fraction": 0.0, "exchange_hidden_fraction": 0.0,
                   "exchange_hidden_of_total": 0.0, "overlap": False}
    four = attribution.predicted_exchange_split((2, 2), (32, 32), 1, 1, **kw)
    assert 0.0 < four["exchange_fraction"] < 1.0
    assert four["exchange_hidden_fraction"] == 0.0
    # overlap is echoed verbatim; where it is illegal nothing is hidden.
    asked = attribution.predicted_exchange_split((2, 2), (32, 32), 1, 1,
                                                 overlap=True, **kw)
    assert asked["overlap"] is True and asked["exchange_hidden_fraction"] == 0
    assert asked["exchange_fraction"] == four["exchange_fraction"]
    # cuda_rdma on a grid of slots: the column transport can hide.
    rd = dict(kw, backend="cuda_rdma", storage="bf16")
    ser = attribution.predicted_exchange_split(
        (2, 2), (960, 1260), 1, 32, slotted=True, col_mode="packed", **rd)
    ov = attribution.predicted_exchange_split(
        (2, 2), (960, 1260), 1, 32, slotted=True, col_mode="packed",
        overlap=True, **rd)
    assert ser["exchange_fraction"] > 0 and ser["exchange_hidden_fraction"] == 0
    assert ov["exchange_hidden_fraction"] == 1.0
    assert ov["exchange_fraction"] == 0.0 < ov["exchange_hidden_of_total"]
    # One card: cuda_rdma reads its ghosts inside the launch.
    assert attribution.predicted_exchange_split(
        (2, 2), (960, 1260), 1, 32, **rd)["exchange_fraction"] == 0.0


# ------------------------------------- the iterate path against JAX's
CASES = [("shifted", (2, 2), 1, "zero"), ("pallas", (2, 4), 2, "zero"),
         ("pallas_sep", (2, 2), 3, "periodic"),
         ("pallas_rdma", (4, 2), 2, "zero"), ("separable", (1, 4), 3, "zero")]


@pytest.mark.parametrize("jbackend,shape,fuse,boundary", CASES)
def test_iterate_exchange_events_equal_jax(tmp_path, jbackend, shape, fuse,
                                           boundary):
    img = imageio.generate_test_image(16, 24, "rgb", seed=4)
    x = imageio.interleaved_to_planar(img).astype(np.float32)
    name, iters = "blur3", 7
    jf = jfilters.get_filter(name)
    jevents.configure(tmp_path / "j.jsonl")
    jstep.sharded_iterate(x, jf, iters, mesh=_jax_mesh(shape),
                          backend=jbackend, fuse=fuse, boundary=boundary)
    events.configure(tmp_path / "t.jsonl")
    step.sharded_iterate(x, get_filter(name), iters, grid=_slots(shape),
                         backend=BACKEND_FROM_REFERENCE[jbackend], fuse=fuse,
                         boundary=boundary)
    jex = [r for r in jevents.read_events(tmp_path / "j.jsonl")
           if r["kind"] == "exchange"]
    tex = [r for r in events.read_events(tmp_path / "t.jsonl")
           if r["kind"] == "exchange"]
    assert len(jex) == len(tex) == 1
    keys = ("source", "grid", "block", "radius", "fuse", "iters", "storage",
            "boundary", "rounds", "halo_bytes", "overlap")
    assert {k: tex[0][k] for k in keys} == {k: jex[0][k] for k in keys}
    assert tex[0]["backend"] == BACKEND_FROM_REFERENCE[jex[0]["backend"]]
    assert tex[0]["halo_bytes"]["north"] > 0 or shape[0] == 1
    # Model-derived: the H100 model here, the TPU roofline there.
    for rec in (tex[0], jex[0]):
        assert 0.0 <= rec["exchange_fraction"] <= 1.0
        assert 0.0 <= rec["exchange_hidden_fraction"] <= 1.0
        assert "wall_s" not in rec   # no fence on the iterate path
    tb, jb = BACKEND_FROM_REFERENCE[jbackend], jbackend
    series = ("backend", "direction")
    for d in DIRS:
        assert metrics.counter("pctpu_halo_bytes_total", "", series).value(
            backend=tb, direction=d) == jmetrics.counter(
            "pctpu_halo_bytes_total", "", series).value(
            backend=jb, direction=d)
    for name_ in ("pctpu_halo_rounds_total", "pctpu_iterations_total"):
        assert metrics.counter(name_, "", ("backend",)).value(backend=tb) \
            == jmetrics.counter(name_, "", ("backend",)).value(backend=jb)
    assert metrics.histogram("pctpu_step_seconds", "", ("backend",)) \
        .quantile(0.5, backend=tb) is None


def test_bench_row_carries_the_attribution_and_the_drift():
    grid = _slots((2, 2))
    row = bench.bench_iterate((20, 28), get_filter("blur3"), 3, grid=grid,
                              backend="cuda", fuse=2, reps=1)
    want = attribution.halo_bytes_total((2, 2), (10, 14), 1, 2, 3, 1, "f32")
    assert row["halo_bytes"] == want
    assert 0.0 <= row["exchange_fraction"] <= 1.0
    assert row["exchange_hidden_fraction"] == 0.0
    ratio = metrics.gauge("pctpu_plan_drift_ratio", "", ("key", "backend"))
    assert ratio.value(key=row["plan_key"], backend="cuda") > 0
    # With obs off the row keeps its fields (computed directly).
    metrics.set_enabled(False)
    off = bench.bench_iterate((20, 28), get_filter("blur3"), 3, grid=grid,
                              backend="cuda", fuse=2, reps=1)
    assert off["halo_bytes"] == want
    assert off["exchange_fraction"] == row["exchange_fraction"]


# ----------------------------------------------------- resilience events
def _resilience_kinds(pkg_faults, pkg_retry, path, iterate):
    """The fault / retry / degrade events of one plan through a package."""
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TimeoutError("blip")
        return "ok"

    with pkg_faults.injected("backend_compile:1,io_read:1"):
        iterate()
        with pytest.raises(pkg_faults.InjectedFault):
            pkg_faults.fault_point("io_read")
    assert pkg_retry.with_retry(
        flaky, pkg_retry.RetryPolicy(max_attempts=5, base_delay=0.0),
        sleep=lambda s: None) == "ok"
    out = []
    for r in path():
        if r["kind"] == "fault_trigger":
            out.append((r["kind"], r["site"], r["hit"], r["transient"]))
        elif r["kind"] == "retry":
            out.append((r["kind"], r["attempt"], r["error"]))
        elif r["kind"] == "degrade":
            out.append((r["kind"], BACKEND_FROM_REFERENCE.get(
                r["requested"], r["requested"]), BACKEND_FROM_REFERENCE.get(
                r["effective"], r["effective"])))
    return out


def test_fault_retry_degrade_events_equal_jax(tmp_path):
    x = np.full((1, 16, 16), 7.0, np.float32)
    jevents.configure(tmp_path / "j.jsonl")
    jkinds = _resilience_kinds(
        jfaults, jretry, lambda: jevents.read_events(tmp_path / "j.jsonl"),
        lambda: jstep.sharded_iterate(
            x, jfilters.get_filter("blur3"), 2, mesh=_jax_mesh((2, 2)),
            backend="pallas_rdma", fallback=True))
    events.configure(tmp_path / "t.jsonl")
    tkinds = _resilience_kinds(
        faults, retry, lambda: events.read_events(tmp_path / "t.jsonl"),
        lambda: step.sharded_iterate(
            x, get_filter("blur3"), 2, grid=_slots((2, 2)),
            backend="cuda_rdma", fallback=True))
    assert tkinds == jkinds
    assert [k[0] for k in tkinds] == ["fault_trigger", "degrade",
                                      "fault_trigger", "retry", "retry"]
    for m, name in ((metrics, "pctpu_faults_fired_total"),
                    (jmetrics, "pctpu_faults_fired_total")):
        assert m.counter(name, "", ("site",)).value(site="io_read") == 1
    assert metrics.counter("pctpu_retries_total", "", ("error",)).value(
        error="TimeoutError") == 2
    assert metrics.counter("pctpu_degrades_total", "",
                           ("requested", "effective")).value(
        requested="cuda_rdma", effective="cuda") == 1


# ------------------------------------------------------------ checkpoints
def test_checkpoint_events_carry_the_bytes_jax_counts(tmp_path):
    img = imageio.generate_test_image(20, 30, "grey", seed=6)
    x = imageio.interleaved_to_planar(img).astype(np.float32)
    meta = {"grid": [2, 2], "iters_done": 4, "valid_hw": [20, 30]}
    jm = _jax_mesh((2, 2))
    xs, jvalid, _ = jstep._prepare(x, jm, 1)
    jevents.configure(tmp_path / "j.jsonl")
    jcheckpoint.save_state(tmp_path / "jck", xs,
                           dict(meta, shape=list(xs.shape)))
    jcheckpoint.load_state(tmp_path / "jck", jm)
    jcheckpoint.load_state(tmp_path / "jck", _jax_mesh((1, 4)))
    grid = _slots((2, 2))
    blocks, valid, _ = step._prepare(x, grid)
    events.configure(tmp_path / "t.jsonl")
    checkpoint.save_state(tmp_path / "tck", blocks,
                          dict(meta, shape=list(xs.shape)), grid)
    checkpoint.load_state(tmp_path / "tck", grid)
    checkpoint.load_state(tmp_path / "tck", _slots((1, 4)))

    def ops(recs):
        keys = ("bytes", "snap", "iters_done", "shards", "grid",
                "resharded_from")
        return [(r["kind"], {k: r[k] for k in keys if k in r})
                for r in recs if r["kind"].startswith("checkpoint_")]

    got = ops(events.read_events(tmp_path / "t.jsonl"))
    assert got == ops(jevents.read_events(tmp_path / "j.jsonl"))
    on_disk = sum(p.stat().st_size
                  for p in (tmp_path / "tck" / "it_00000004").glob("*.npy"))
    assert [k for k, _ in got] == ["checkpoint_save", "checkpoint_load",
                                   "checkpoint_reshard"]
    assert all(f["bytes"] == on_disk for _, f in got)
    assert metrics.counter("pctpu_checkpoint_bytes_total", "",
                           ("op",)).value(op="save") == on_disk
    # A torn snapshot: the quarantine event names the cause per shard.
    (tmp_path / "tck" / "it_00000004" / "shard_0_1.npy").unlink()
    with pytest.raises(checkpoint.CheckpointCorrupt):
        checkpoint.load_state(tmp_path / "tck", grid)
    q = [r for r in events.read_events(tmp_path / "t.jsonl")
         if r["kind"] == "quarantine"]
    assert q[0]["problems"] == [["missing", "shard_0_1.npy"]]
    assert metrics.counter("pctpu_quarantines_total", "",
                           ("cause",)).value(cause="missing") == 1


# ----------------------------------------------------------------- report
def _port_timeline(tmp_path):
    """A log and a snapshot from the port's main paths, obs on."""
    events.configure(tmp_path / "ev.jsonl")
    grid = _slots((2, 2))
    x = np.random.default_rng(3).integers(0, 256, (1, 20, 24)).astype(
        np.float32)
    step.sharded_iterate(x, get_filter("blur3"), 5, grid=grid,
                         backend="cuda", fuse=2)
    step.sharded_converge(x / 255, get_filter("jacobi3"), 1e-2, 30,
                          check_every=5, grid=grid, backend="cuda_rdma")
    bench.bench_iterate((20, 28), get_filter("blur3"), 3, grid=grid,
                        backend="cuda_sep", fuse=2, reps=1)
    with faults.injected("io_read:1"):
        with pytest.raises(faults.InjectedFault):
            faults.fault_point("io_read")
    blocks, _, _ = step._prepare(x, grid)
    checkpoint.save_state(tmp_path / "ck", blocks, {
        "grid": [2, 2], "iters_done": 1, "shape": [1, 20, 24]}, grid)
    metrics.dump(tmp_path / "snap.json")
    events.deconfigure()
    return tmp_path / "ev.jsonl", tmp_path / "snap.json"


def test_report_prints_what_the_jax_script_prints(tmp_path, capsys,
                                                   monkeypatch):
    ev, snap = _port_timeline(tmp_path)
    jreport = _script("obs_report")
    argv = ["--events", str(ev), "--metrics", str(snap)]
    monkeypatch.setattr(sys, "argv", ["obs_report.py", *argv])
    jrc = jreport.main()
    jout = capsys.readouterr().out
    rc = report.main(argv)
    out = capsys.readouterr().out
    assert rc == jrc == 0 and out == jout
    got = json.loads(out.splitlines()[-1])
    assert got["events"]["seq_gaps"] == 0 and got["events"]["invalid"] == 0
    assert got["events"]["kinds"]["exchange"] >= 3
    assert set(got["exchange"]) == {"cuda", "cuda_rdma", "cuda_sep"}
    assert got["totals"]["faults_fired"] == {"io_read": 1}
    assert any(k.endswith("|cuda_sep") for k in got["drift"])
    # The JSON file and --quiet too.
    monkeypatch.setattr(sys, "argv", ["obs_report.py", *argv, "--quiet",
                                      "--out", str(tmp_path / "j.json")])
    jreport.main()
    report.main([*argv, "--quiet", "--out", str(tmp_path / "t.json")])
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


def test_report_fails_on_a_seq_gap(tmp_path, capsys):
    lines = [json.dumps({"seq": s, "ts": 1.0, "perf": 1.0, "pid": 7,
                         "kind": "heartbeat"}) for s in (1, 2, 4)]
    (tmp_path / "ev.jsonl").write_text("\n".join(lines) + "\n")
    assert report.main(["--events", str(tmp_path / "ev.jsonl")]) == 1
    assert "1 seq gaps" in capsys.readouterr().err
    assert report.main([]) == 2


def test_perf_gate_takes_the_ports_row_and_snapshot(tmp_path, capsys,
                                                    monkeypatch):
    gate = _script("perf_gate")
    row = bench.bench_iterate((20, 28), get_filter("blur3"), 3,
                              grid=_slots((2, 2)), backend="cuda", fuse=2,
                              reps=1)
    (tmp_path / "row.json").write_text(json.dumps(row))
    metrics.dump(tmp_path / "snap.json")
    hist = tmp_path / "hist.jsonl"
    base = ["perf_gate.py", "--history", str(hist), "--row",
            str(tmp_path / "row.json"), "--drift-metrics",
            str(tmp_path / "snap.json"), "--drift-bound", "1e12"]
    key = f"{row['plan_key']}|cuda|2x2"
    for status in ("seeded", "ok"):
        monkeypatch.setattr(sys, "argv", [*base, "--update"])
        assert gate.main() == 0
        out = capsys.readouterr().out
        verdict = json.loads(out.splitlines()[-1])["verdicts"][0]
        assert verdict["key"] == key and verdict["status"] == status
    # The drift gauge is the port's: a tight bound flags its plan key.
    monkeypatch.setattr(sys, "argv", ["perf_gate.py", "--drift-metrics",
                                      str(tmp_path / "snap.json"),
                                      "--drift-bound", "1.0000001"])
    assert gate.main() == 1
    flags = json.loads(capsys.readouterr().out.splitlines()[-1])[
        "drift_flags"]
    assert [(f["key"], f["backend"]) for f in flags] == [
        (row["plan_key"], "cuda")]


# ---------------------------------------------------------- PhaseTimer
def test_phase_timer_thread_safety():
    """A timer shared across threads keeps per-thread nesting and exact
    counts (the JAX package's test)."""
    t = tracing.PhaseTimer()
    n_threads, n_iter = 8, 200
    barrier = threading.Barrier(n_threads)

    def worker():
        barrier.wait()
        for _ in range(n_iter):
            with t.phase("outer"):
                with t.phase("inner"):
                    pass

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert set(t.walls) == {"outer", "outer/inner"}
    assert t.counts["outer"] == n_threads * n_iter
    assert t.counts["outer/inner"] == n_threads * n_iter


def test_phase_timer_rows_nesting_and_fences(tmp_path):
    t = tracing.PhaseTimer()
    with t.phase("a"):
        with t.phase("b"):
            time.sleep(0.001)
    with t.phase("a_b"):   # flattens to the same row key as a/b
        time.sleep(0.001)
    row = t.to_row()
    assert set(row) == {"phase_a_s", "phase_a_b_s"}
    assert row["phase_a_b_s"] == pytest.approx(
        t.wall("a/b") + t.wall("a_b"), abs=1e-5)
    with t.phase("x"):
        with t.phase("x"):
            pass
    assert t.counts["x"] == 1 and t.counts["x/x"] == 1
    fenced = []
    with t.phase("fenced", fence=lambda: fenced.append(1)):
        pass
    with t.phase("tensor", fence=torch.ones(2)):   # a CPU tensor: no wait
        pass
    assert fenced == [1]

    def boom():
        raise RuntimeError("fence failed")

    with pytest.raises(RuntimeError):
        with t.phase("outer"):
            with t.phase("inner", fence=boom):
                pass
    assert t.counts["outer"] == 1 and t.counts["outer/inner"] == 1
    with t.phase("after"):
        pass
    assert "after" in t.walls and "outer/after" not in t.walls
    t.dump(tmp_path / "r.json")
    rep = json.loads((tmp_path / "r.json").read_text())
    assert rep["phases"]["a/b"]["calls"] == 1


def test_rewrite_shared_jsonl_keeps_foreign_lanes(tmp_path):
    from parallel_convolution_tpu.utils import evidence_io as jevidence_io

    seed_lines = ['{"a": 1}', '{"lane": "other", "b": 2}', "torn{",
                  '{"lane": "mine", "c": 3}']
    for mod, name in ((evidence_io, "t.jsonl"), (jevidence_io, "j.jsonl")):
        p = tmp_path / name
        p.write_text("\n".join(seed_lines) + "\n")
        assert mod.rewrite_shared_jsonl(p, [{"d": 4}], lane="mine") == 2
        mod.rewrite_shared_jsonl(p, [{"e": 5}])
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    with faults.injected("evidence_write:1"):
        with pytest.raises(faults.InjectedFault):
            evidence_io.rewrite_shared_jsonl(tmp_path / "t.jsonl", [])


def test_multigrid_level_events_equal_jax(tmp_path):
    x = np.random.default_rng(8).standard_normal((1, 40, 36)).astype(
        np.float32)
    from parallel_convolution_tpu.solvers import multigrid as jmultigrid
    from parallel_convolution_tpu_torch.solvers import multigrid

    jevents.configure(tmp_path / "j.jsonl")
    _, jres = jmultigrid.mg_converge(x, jfilters.get_filter("jacobi3"), 1e-3,
                                     60, mesh=_jax_mesh((2, 2)))
    events.configure(tmp_path / "t.jsonl")
    _, res = multigrid.mg_converge(x, get_filter("jacobi3"), 1e-3, 60,
                                   grid=_slots((2, 2)))
    assert res.cycles == jres.cycles > 1

    def levels(path):
        keys = ("source", "mg_level", "grid", "block", "iters", "rounds",
                "halo_bytes", "fuse", "storage")
        return [{k: r[k] for k in keys} for r in path
                if r["kind"] == "exchange"]

    tex = events.read_events(tmp_path / "t.jsonl")
    assert levels(tex) == levels(jevents.read_events(tmp_path / "j.jsonl"))
    assert {r["mg_level"] for r in levels(tex)} == set(range(res.levels))
    # Each level program once a solve (the port's compile events).
    built = sorted({r["builder"] for r in tex if r["kind"] == "compile"})
    assert built == ["mg_fine", "mg_prolong", "mg_restrict", "mg_smooth"]
    assert metrics.histogram("pctpu_mg_cycle_seconds", "", (
        "backend",)).value(backend="shifted").count == res.cycles
    sweeps = metrics.counter("pctpu_mg_sweeps_total", "",
                             ("backend", "pctpu_mg_level"))
    assert sweeps.value(backend="shifted", pctpu_mg_level="0") == \
        jmetrics.counter("pctpu_mg_sweeps_total", "",
                         ("backend", "pctpu_mg_level")).value(
            backend="shifted", pctpu_mg_level="0")
