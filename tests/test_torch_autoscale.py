"""The autoscaler in the port (``serving/autoscaler.py``) held against the
JAX package's on the CPU.

* the decision walk (streaks, the dead band, cooldown, the min / max
  clamps, the p99 trigger) on a stub router with an injected clock gives
  JAX's decisions case by case and on 400 seeded signal ticks;
* the windowed p99 reads only the tick's new samples of
  ``pctpu_request_phase_seconds``, as JAX's does;
* ``tick`` over a live router (port replicas on a 1x2 CPU grid): a scale-up
  pre-warms the joining replica's ring shard before its vnodes join, the
  shard's per-key runner builds stay flat through the remapped traffic
  (every answer the oracle's), and a scale-down drains it back out LIFO;
* ``remove_replica`` refuses an unknown name and the last replica, and
  ``add_replica`` a duplicate name.

Tolerance: decisions, reasons and u8 bytes equal.
"""

from __future__ import annotations

import base64
import random

import numpy as np
import pytest

from parallel_convolution_tpu.obs import metrics as jmetrics
from parallel_convolution_tpu.serving import autoscaler as jautoscaler
from parallel_convolution_tpu_torch.obs import metrics
from parallel_convolution_tpu_torch.ops import oracle
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh
from parallel_convolution_tpu_torch.serving import autoscaler
from parallel_convolution_tpu_torch.serving.router import (
    InProcessReplica, ReplicaRouter, route_key,
)
from parallel_convolution_tpu_torch.serving.service import ConvolutionService
from parallel_convolution_tpu_torch.utils import imageio

MODULES = [autoscaler, jautoscaler]


class _StubRouter:
    """decide()-only scaffolding: the decision never touches the pool."""


def _scaler(mod, clock, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("up_ticks", 2)
    kw.setdefault("down_ticks", 3)
    kw.setdefault("cooldown_s", 10.0)
    return mod.AutoScaler(_StubRouter(), None, clock=clock, **kw)


def _sig(pressure, replicas=2, p99_ms=None):
    return {"replicas": replicas, "live": replicas, "in_flight": 0,
            "queue_depth": 0, "queue_bound": 64, "pressure": pressure,
            "degraded": 0, "p99_ms": p99_ms}


def _walk(kw, steps, last_change=None):
    """The decisions both packages' scalers make on one sequence of
    ``(clock, signal)`` steps."""
    out = []
    for mod in MODULES:
        clock = [0.0]
        sc = _scaler(mod, lambda: clock[0], **kw)
        sc._last_change = last_change
        seq = []
        for t, sig in steps:
            clock[0] = t
            d = sc.decide(sig)
            seq.append((d.action, d.reason))
        out.append(seq)
    assert out[0] == out[1]
    return [a for a, _ in out[0]]


# ------------------------------------------------- hysteresis (injected clock)
CASES = {
    "up needs consecutive over-pressure ticks": (
        {"up_pressure": 0.5}, [(0, _sig(0.9)), (0, _sig(0.9))], None,
        ["hold", "up"]),
    "a dead-band tick resets the streak": (
        {"up_pressure": 0.5},
        [(0, _sig(0.9)), (0, _sig(0.3)), (0, _sig(0.9)), (0, _sig(0.9))],
        None, ["hold", "hold", "hold", "up"]),
    "down needs the longer streak": (
        {"down_pressure": 0.1, "down_ticks": 3},
        [(0, _sig(0.0))] * 3, None, ["hold", "hold", "down"]),
    "the min-replica floor holds": (
        {"down_pressure": 0.1, "down_ticks": 1},
        [(0, _sig(0.0, replicas=1))], None, ["hold"]),
    "cooldown blocks until it elapses": (
        {"up_pressure": 0.5, "cooldown_s": 10.0},
        [(5.0, _sig(0.9)), (5.0, _sig(0.9)), (11.0, _sig(0.9))], 0.0,
        ["hold", "hold", "up"]),
    "max replicas clamps scale-up": (
        {"up_pressure": 0.5, "max_replicas": 2},
        [(0, _sig(0.9, replicas=2))] * 2, None, ["hold", "hold"]),
    "the p99 trigger scales up without queue pressure": (
        {"up_pressure": 0.9, "p99_up_ms": 100.0, "up_ticks": 1},
        [(0, _sig(0.0, p99_ms=250.0))], None, ["up"]),
    "a p99 under the trigger does not": (
        {"up_pressure": 0.9, "p99_up_ms": 100.0, "up_ticks": 1},
        [(0, _sig(0.0, p99_ms=50.0))], None, ["hold"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decision_cases_equal_jax(case):
    kw, steps, last_change, want = CASES[case]
    assert _walk(kw, steps, last_change) == want


@pytest.mark.parametrize("seed", range(3))
def test_seeded_signal_sequence_equal_jax(seed):
    rng = random.Random(seed)
    steps, t = [], 0.0
    for _ in range(40):
        # A regime of ten ticks: mostly idle, mostly loaded, or mixed.
        levels, p99s = rng.choice([
            ([0.0, 0.0, 0.02, 0.3], [None, 20.0]),
            ([0.6, 0.95, 0.3], [None, 20.0, 300.0]),
            ([0.0, 0.3, 0.6, 0.95], [None, 300.0])])
        for _ in range(10):
            t += rng.choice([0.1, 0.5, 2.0])
            steps.append((t, _sig(rng.choice(levels),
                                  replicas=rng.randrange(1, 5),
                                  p99_ms=rng.choice(p99s))))
    kw = {"up_pressure": 0.5, "down_pressure": 0.05, "p99_up_ms": 200.0,
          "up_ticks": 2, "down_ticks": 4, "cooldown_s": 3.0}
    actions = _walk(kw, steps, last_change=None)
    assert {"hold", "up", "down"} <= set(actions)


def test_constructor_guards_equal_jax():
    for bad in ({"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2},
                {"up_ticks": 0}, {"down_ticks": 0}):
        msgs = []
        for mod in MODULES:
            with pytest.raises(ValueError) as e:
                mod.AutoScaler(_StubRouter(), None, **bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_windowed_p99_is_the_tick_delta_as_jax():
    """A pile of ancient fast samples must not numb the signal, nor a
    pile of ancient slow ones pin it after latencies recover."""
    got = []
    for mod, reg in ((autoscaler, metrics), (jautoscaler, jmetrics)):
        hist = reg.histogram(
            "pctpu_request_phase_seconds",
            "per-request serving latency by phase", ("phase", "backend"))
        sc = _scaler(mod, lambda: 0.0)
        seq = []
        for _ in range(1000):
            hist.observe(0.001, phase="total", backend="shifted")
        seq.append(sc._windowed_p99_ms())
        for value in (2.0, 0.001):
            for _ in range(10):
                hist.observe(value, phase="total", backend="shifted")
            seq.append(sc._windowed_p99_ms())
        got.append(seq)
    assert got[0] == got[1]
    first, slow, fast = got[0]
    assert first is None and slow > 1000.0 and fast < 100.0


# ------------------------------------------------ the loop over replicas
def _img(rows=32, cols=48, seed=5):
    return imageio.generate_test_image(rows, cols, "grey", seed=seed)


def _body(img, **kw):
    body = {"image_b64": base64.b64encode(
        np.ascontiguousarray(img).tobytes()).decode("ascii"),
        "rows": img.shape[0], "cols": img.shape[1], "mode": "grey"}
    body.update(kw)
    return body


def _factory():
    grid = mesh.make_grid((1, 2), devices=["cpu", "cpu"])

    def make():
        return ConvolutionService(grid, max_batch=1, max_delay_s=0.002)
    return make


def test_prewarm_keeps_the_joining_shard_flat():
    img = _img()
    router = ReplicaRouter([InProcessReplica(_factory(), name="r0")],
                           start_health=False)
    try:
        for it in (1, 2, 3):
            _, wire = router.request(_body(img, iters=it,
                                           request_id=f"w{it}"))
            assert wire["ok"], wire
        sc = autoscaler.AutoScaler(
            router, lambda name: InProcessReplica(_factory(), name=name),
            min_replicas=1, max_replicas=2, up_pressure=0.5, up_ticks=1,
            down_ticks=1, cooldown_s=0.0)
        # One tick under pressure (the stub signal), through the real
        # actions: the decision's "up" registers, pre-warms and joins.
        sc.signals = lambda: _sig(0.9, replicas=len(router.ring.members()))
        assert sc.tick().action == "up"
        name = sc.snapshot()["added"][0]
        router.poll_once()
        eng = router.replica(name).service.engine
        shard = [it for it in (1, 2, 3)
                 if router.ring.candidates(route_key(
                     _body(img, iters=it)))[0] == name]
        assert shard and set(shard) <= {k.iters for k in eng._entries}
        assert sc.stats["prewarmed_configs"] >= len(shard)
        before = {k.iters: e.compiles for k, e in eng._entries.items()}
        assert all(v == 1 for v in before.values())
        for rep in range(3):
            for it in shard:
                _, wire = router.request(_body(img, iters=it,
                                               request_id=f"p{rep}x{it}"))
                assert wire["ok"] and wire["router"]["replica"] == name
                got = np.frombuffer(base64.b64decode(wire["image_b64"]),
                                    np.uint8).reshape(img.shape)
                np.testing.assert_array_equal(
                    got, oracle.run_serial_u8(img, get_filter("blur3"), it))
        after = {k.iters: e.compiles for k, e in eng._entries.items()}
        assert all(after[it] == before[it] for it in shard)
        assert eng.stats["compiles"] == len(before)
        # Idle: the scale-down drains the newcomer (LIFO) and stops at
        # the boot pool.
        sc.signals = lambda: _sig(0.0, replicas=len(router.ring.members()))
        assert sc.tick().action == "down"
        assert router.ring.members() == ["r0"]
        d = sc.tick()
        assert d.action == "hold" and d.reason == "within band"
        assert sc.stats["scale_ups"] == sc.stats["scale_downs"] == 1
        _, wire = router.request(_body(img, iters=1, request_id="post"))
        assert wire["ok"]
    finally:
        router.close()


def test_remove_and_add_replica_guards():
    img = _img()
    reps = [InProcessReplica(_factory(), name=f"r{i}") for i in range(2)]
    router = ReplicaRouter(reps, start_health=False)
    try:
        with pytest.raises(KeyError):
            router.remove_replica("nope")
        info = router.remove_replica("r1", drain_s=1.0)
        assert info["drained"] and router.ring.members() == ["r0"]
        with pytest.raises(ValueError):
            router.remove_replica("r0")
        with pytest.raises(ValueError):
            router.add_replica(InProcessReplica(_factory(), name="r0"))
        _, wire = router.request(_body(img, iters=1))
        assert wire["ok"]
        # A scaler never removes the boot pool: no scaler-added victim.
        sc = autoscaler.AutoScaler(router, None, min_replicas=1,
                                   max_replicas=2)
        assert sc.scale_down() is None
    finally:
        router.close()
