"""Fleet autoscaling: the serving control loop over the replica router.

The router makes N replicas survive failure; without this loop N is a
boot-time constant — sustained throughput capped by whatever the
operator guessed, idle replicas burning capacity overnight.  This module
closes the loop: scale the replica count from signals the stack already
exports, with warm-cache-aware placement so growing the pool never turns
into a compile storm.

**Signals** (gathered per tick from surfaces that already exist):

* queue pressure — per-replica ``queue_depth / queue_bound`` from the
  ``/readyz`` payload (the service's probe), plus router-side ``in_flight``
  and progressive-stream occupancy;
* latency — the p99 of the ``pctpu_request_phase_seconds`` total-phase
  histogram (obs.metrics), when obs is on;
* health — ``ready`` flags and degrade tiers from the same probe (an
  unready replica contributes load but no capacity).

**Decision** (deterministic, clock-injectable — the breaker's pattern,
so the whole loop unit-tests without sleeping): pressure above
``up_pressure`` (or p99 above ``p99_up_ms``) for ``up_ticks``
CONSECUTIVE ticks scales up one replica; pressure below
``down_pressure`` for ``down_ticks`` consecutive ticks scales down one.
``down_ticks > up_ticks`` is the hysteresis asymmetry (grow fast, shrink
reluctantly), a mixed signal resets both streaks, and ``cooldown_s``
separates consecutive actions so the loop can never flap faster than
replicas warm.

**Warm placement** (the process-to-node-mapping analogue: put work next
to the state it needs): on scale-up the new replica is REGISTERED but
kept out of the ring while the router's key-config observatory replays
its future shard — exactly the configs whose consistent-hash home the
newcomer is about to become — through ``/v1/warm`` (→
``service.warmup`` → the plan cache + ``WarmEngine.warmup``).  Only
then do its vnodes join.  Post-join traffic for the remapped keys hits
warm runners; the per-key compile ledger stays flat (``chip_smoke.py``
phase 4o holds it on the card).

**Drain** (scale-down): ring removal first — the consistent-hash
property remaps ONLY the leaver's keys — then bounded in-flight drain,
then close; racing requests surface as the router's existing typed
retryable outcomes, never drops.  Victims are chosen LIFO among
scaler-added replicas: the boot pool is the operator's floor, and the
newest replica holds the least warm state worth keeping.

stdlib-only; torch stays inside the replicas.
"""

from __future__ import annotations

import itertools
import threading
import time

from parallel_convolution_tpu_torch.obs import (
    events as obs_events, metrics as obs_metrics,
)

__all__ = ["AutoScaler", "ScaleDecision"]


class ScaleDecision:
    """One tick's verdict: ``action`` ∈ {up, down, hold} + why."""

    __slots__ = ("action", "reason", "signals")

    def __init__(self, action: str, reason: str, signals: dict):
        self.action = action
        self.reason = reason
        self.signals = signals

    def __repr__(self) -> str:
        return f"ScaleDecision({self.action!r}, {self.reason!r})"


class AutoScaler:
    """The control loop (see module docstring).

    ``factory(name) -> transport`` builds one new replica (an
    ``InProcessReplica`` on a grid of this process, an ``HTTPReplica`` over a
    provisioner for deployment).  ``router`` is the live
    :class:`~parallel_convolution_tpu_torch.serving.router.ReplicaRouter`.
    ``clock`` is injectable (cooldown/hysteresis are wall-free in
    tests); :meth:`tick` is the whole loop body — drive it from
    :meth:`start`'s thread in production or directly in tests.
    """

    def __init__(self, router, factory, *, min_replicas: int = 1,
                 max_replicas: int = 4, up_pressure: float = 0.5,
                 down_pressure: float = 0.05, up_ticks: int = 2,
                 down_ticks: int = 8, p99_up_ms: float | None = None,
                 cooldown_s: float = 5.0, interval_s: float = 0.5,
                 drain_s: float = 10.0, prewarm: bool = True,
                 clock=time.monotonic):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if up_ticks < 1 or down_ticks < 1:
            raise ValueError("up_ticks and down_ticks must be >= 1")
        self.router = router
        self.factory = factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_pressure = float(up_pressure)
        self.down_pressure = float(down_pressure)
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.p99_up_ms = p99_up_ms
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        self.drain_s = float(drain_s)
        self.prewarm = bool(prewarm)
        self._clock = clock
        self._ids = itertools.count(1)
        self._up_streak = 0
        self._down_streak = 0
        self._last_change: float | None = None
        self._added: list[str] = []   # scaler-grown replicas, LIFO victims
        self._lock = threading.Lock()
        self.stats = obs_metrics.MirroredStats(obs_metrics.gauge(
            "pctpu_autoscaler_stats", "control-loop tick/action counters",
            ("key",)), initial={
            "ticks": 0, "scale_ups": 0, "scale_downs": 0, "holds": 0,
            "prewarmed_configs": 0, "replicas": 0,
        })
        self._closed = threading.Event()
        self._thread: threading.Thread | None = None
        # Last-tick cumulative bucket counts of the total-phase latency
        # histogram, per label set: the p99 signal is computed over the
        # DELTA (this tick's new samples only) — a process-lifetime
        # quantile goes numb as uptime grows (an overload must outweigh
        # every sample ever taken before it moves the lifetime p99).
        self._hist_last: dict[tuple, list[int]] = {}

    # -- signals --------------------------------------------------------------
    def _windowed_p99_ms(self) -> float | None:
        """p99 (ms) of the request-latency samples observed SINCE the
        last tick, pooled across backends (bucket-interpolated, the
        Prometheus estimate).  None until a tick-over-tick delta with
        samples exists."""
        snap = obs_metrics.snapshot()
        deltas: list[int] | None = None
        buckets: list[float] | None = None
        for m in snap.get("metrics", []):
            if m.get("name") != "pctpu_request_phase_seconds":
                continue
            for s in m.get("series", []):
                if s.get("labels", {}).get("phase") != "total":
                    continue
                key = tuple(sorted(s.get("labels", {}).items()))
                counts = list(s.get("counts", ()))
                prev = self._hist_last.get(key)
                self._hist_last[key] = counts
                if prev is None or len(prev) != len(counts):
                    continue   # first sight of this series: no window
                d = [max(0, a - b) for a, b in zip(counts, prev)]
                if buckets is None:
                    buckets = list(s.get("buckets", ()))
                    deltas = [0] * len(d)
                if len(d) == len(deltas):
                    deltas = [x + y for x, y in zip(deltas, d)]
        if not deltas or not buckets or sum(deltas) == 0:
            return None
        total = sum(deltas)
        rank = 0.99 * total
        cum = 0.0
        for i, c in enumerate(deltas):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                if i >= len(buckets):
                    return buckets[-1] * 1e3   # +Inf bucket: floor
                lo = buckets[i - 1] if i > 0 else 0.0
                hi = buckets[i]
                return (lo + (hi - lo) * (rank - prev_cum) / c) * 1e3
        return buckets[-1] * 1e3

    def signals(self) -> dict:
        """One tick's inputs, from surfaces the stack already exports."""
        snap = self.router.snapshot()
        reps = snap.get("replicas", {})
        n = len(reps)
        live = 0
        in_flight = 0
        queue_depth = 0
        queue_bound = 0
        degraded = 0
        for rep in reps.values():
            in_flight += int(rep.get("in_flight") or 0)
            if rep.get("ready"):
                live += 1
                queue_depth += int(rep.get("queue_depth") or 0)
                queue_bound += int(rep.get("queue_bound") or 0)
                if rep.get("degraded"):
                    degraded += 1
        # Pressure: outstanding work over the LIVE pool's admission
        # capacity.  queue_bound can be unknown (a replica not yet
        # polled) — fall back to counting in-flight against a nominal
        # per-replica depth so a cold loop still sees overload.
        capacity = queue_bound if queue_bound > 0 else 64 * max(1, live)
        pressure = (queue_depth + in_flight) / max(1, capacity)
        p99_ms = None
        if obs_metrics.enabled():
            p99_ms = self._windowed_p99_ms()
        return {
            "replicas": n, "live": live, "in_flight": in_flight,
            "queue_depth": queue_depth, "queue_bound": queue_bound,
            "pressure": round(pressure, 4), "degraded": degraded,
            "p99_ms": round(p99_ms, 3) if p99_ms is not None else None,
        }

    # -- the decision ---------------------------------------------------------
    def decide(self, sig: dict) -> ScaleDecision:
        """Pure hysteresis walk over one tick's signals (mutates only
        the streak counters — callers drive it with synthetic signals
        in tests)."""
        over = sig["pressure"] >= self.up_pressure
        reason = f"pressure {sig['pressure']} >= {self.up_pressure}"
        if (not over and self.p99_up_ms is not None
                and sig.get("p99_ms") is not None
                and sig["p99_ms"] >= self.p99_up_ms):
            over = True
            reason = f"p99 {sig['p99_ms']}ms >= {self.p99_up_ms}ms"
        under = not over and sig["pressure"] <= self.down_pressure
        if over:
            self._up_streak += 1
            self._down_streak = 0
        elif under:
            self._down_streak += 1
            self._up_streak = 0
        else:
            # The dead band between the thresholds: a mixed signal
            # resets BOTH streaks — hysteresis means N consecutive
            # agreeing ticks, not N eventually.
            self._up_streak = self._down_streak = 0
        now = self._clock()
        if (self._last_change is not None
                and now - self._last_change < self.cooldown_s):
            return ScaleDecision("hold", "cooldown", sig)
        if (over and self._up_streak >= self.up_ticks
                and sig["replicas"] < self.max_replicas):
            return ScaleDecision("up", reason, sig)
        if (under and self._down_streak >= self.down_ticks
                and sig["replicas"] > self.min_replicas):
            return ScaleDecision(
                "down",
                f"pressure {sig['pressure']} <= {self.down_pressure} "
                f"for {self._down_streak} ticks", sig)
        return ScaleDecision("hold", "within band", sig)

    # -- actions --------------------------------------------------------------
    def scale_up(self) -> str:
        """Grow the pool by one WARM replica; returns its name."""
        name = f"as{next(self._ids)}"
        transport = self.factory(name)
        prewarmed = 0
        registered = False
        try:
            self.router.add_replica(transport, join_ring=False)
            registered = True
            if self.prewarm:
                configs = self.router.shard_configs(name)
                if configs:
                    status, body = transport.warm(configs)
                    if status == 200:
                        prewarmed = len(configs)
                    # A failed pre-warm is a WARNING, not a veto: a cold
                    # join serves correctly (it just compiles on demand)
                    # while refusing to join under load makes overload
                    # worse.
            self.router.join_ring(name)
        except Exception:
            # A half-added replica must not linger registered-but-dead —
            # but roll back ONLY what this call registered: a duplicate-
            # name failure means someone ELSE's healthy replica holds
            # the name, and removing it would tear down live capacity.
            if registered:
                try:
                    self.router.remove_replica(name, drain_s=0.0)
                except Exception:  # noqa: BLE001 — best-effort rollback
                    pass
            else:
                try:
                    transport.close()
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass
            raise
        with self._lock:
            self._added.append(name)
            self.stats["scale_ups"] += 1
            self.stats["prewarmed_configs"] += prewarmed
        self._last_change = self._clock()
        if obs_metrics.enabled():
            obs_events.emit("autoscale", action="up", replica=name,
                            prewarmed=prewarmed,
                            replicas=len(self.router.ring.members()))
        return name

    def scale_down(self) -> str | None:
        """Shrink the pool by one replica (LIFO among scaler-added;
        never below the boot pool); returns the drained name."""
        with self._lock:
            victim = self._added.pop() if self._added else None
        if victim is None:
            # The scaler never shrinks the operator's boot pool: min
            # replicas is a floor the decision already enforces, and the
            # boot replicas may be the only ones with special placement.
            return None
        info = self.router.remove_replica(victim, drain_s=self.drain_s)
        with self._lock:
            self.stats["scale_downs"] += 1
        self._last_change = self._clock()
        if obs_metrics.enabled():
            obs_events.emit("autoscale", action="down", replica=victim,
                            drained=bool(info.get("drained")),
                            replicas=len(self.router.ring.members()))
        return victim

    # -- the loop -------------------------------------------------------------
    def tick(self) -> ScaleDecision:
        """One control-loop iteration: gather → decide → act."""
        sig = self.signals()
        decision = self.decide(sig)
        with self._lock:
            self.stats["ticks"] += 1
            self.stats["replicas"] = sig["replicas"]
        if decision.action == "up":
            self.scale_up()
            self._up_streak = 0
        elif decision.action == "down":
            if self.scale_down() is None:
                decision = ScaleDecision("hold", "no scaler-added victim",
                                         sig)
            self._down_streak = 0
        else:
            with self._lock:
                self.stats["holds"] += 1
        if obs_metrics.enabled() and decision.action != "hold":
            obs_events.emit("autoscale", action="decision",
                            verdict=decision.action, reason=decision.reason,
                            **{k: v for k, v in sig.items()
                               if v is not None})
        return decision

    def start(self) -> None:
        """Drive :meth:`tick` on ``interval_s`` from a daemon thread."""
        if self._thread is None or not self._thread.is_alive():
            self._closed.clear()
            self._thread = threading.Thread(
                target=self._loop, name="pctpu-autoscaler", daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._closed.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                if obs_metrics.enabled():
                    obs_events.emit("autoscale", action="error",
                                    error=repr(e)[:200])

    def close(self) -> None:
        self._closed.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(5.0)

    def snapshot(self) -> dict:
        with self._lock:
            return {"stats": dict(self.stats),
                    "added": list(self._added),
                    "streaks": {"up": self._up_streak,
                                "down": self._down_streak},
                    "bounds": {"min": self.min_replicas,
                               "max": self.max_replicas}}
