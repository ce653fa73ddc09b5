"""Process-global metrics registry of the port: typed counters, gauges and
histograms (its own copy of the JAX package's ``obs/metrics.py``, the same
names, semantics and text).

* :class:`Counter` — monotonic, labeled series (``inc``);
* :class:`Gauge` — last-write-wins, labeled series (``set``);
* :class:`Histogram` — fixed-bucket latency/size distributions
  (``observe``), with bucket-interpolated quantiles for reports;
* :class:`Registry` — get-or-create by name, one lock, ``snapshot()``
  (the in-process client surface), :func:`render_text` (Prometheus text
  exposition v0.0.4) and :func:`parse_text`, its validator half.

Disabled mode (``PCTPU_OBS=0``, read once at import, flipped by
:func:`set_enabled`): every mutator returns after ONE module attribute
load and a truthiness test, the ``fault_point`` contract
(``resilience.faults``): nothing is counted, allocated or locked, so the
hooks can sit in build paths, per-shard I/O loops and the chunk loop.

Stdlib only: ``resilience.faults`` and ``utils.tracing`` import it, and
they must stay cheap to import.
"""

from __future__ import annotations

import json
import math
import os
import threading
from collections.abc import MutableMapping

__all__ = [
    "Counter", "Gauge", "Histogram", "MirroredStats", "Registry",
    "counter", "enabled", "gauge", "histogram", "parse_text", "render_text",
    "reset", "set_enabled", "snapshot",
]

OBS_ENV = "PCTPU_OBS"

# Read once at import; set_enabled() flips it (tests, tools).  Mutators
# check this FIRST — the disabled hot path is one load + one branch.
_ENABLED = os.environ.get(OBS_ENV, "1").strip().lower() not in (
    "0", "false", "off")


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Flip the global obs switch (tests / entry points).  Metric handles
    stay valid across flips: they consult the switch per operation."""
    global _ENABLED
    _ENABLED = bool(on)


# Default latency buckets (seconds): sub-ms to tens of seconds, from one
# halo round to a cold kernel build.
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _label_key(labelnames: tuple[str, ...], labels: dict) -> tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared "
            f"labelnames {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    """Shared plumbing: name, help, labelnames, per-series storage."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._series: dict[tuple[str, ...], object] = {}

    def _series_snapshot(self) -> list[dict]:
        with self._lock:
            items = list(self._series.items())
        return [{"labels": dict(zip(self.labelnames, k)), "value": v}
                for k, v in items]

    def value(self, **labels) -> object:
        """One series' current value (0/None when never touched)."""
        k = _label_key(self.labelnames, labels)
        with self._lock:
            return self._series.get(k, 0)

    def remove(self, **labels) -> None:
        """Drop one labeled series from the exposition (no-op when it
        never existed).  The retirement surface for label values with a
        bounded lifetime — a shape-bucketed batcher lane that drained,
        a replica that left the ring — so ``/metrics`` cardinality
        tracks LIVE objects, not every label value ever seen."""
        k = _label_key(self.labelnames, labels)
        with self._lock:
            self._series.pop(k, None)


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if not _ENABLED:
            return
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        k = _label_key(self.labelnames, labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not _ENABLED:
            return
        k = _label_key(self.labelnames, labels)
        with self._lock:
            self._series[k] = float(value)

    def max(self, value: float, **labels) -> None:
        """Keep the running maximum (the high-water-mark idiom)."""
        if not _ENABLED:
            return
        k = _label_key(self.labelnames, labels)
        with self._lock:
            cur = self._series.get(k)
            if cur is None or value > cur:
                self._series[k] = float(value)


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets   # cumulative rendered at exposition
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: tuple[float, ...] = LATENCY_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        bs = tuple(sorted({float(b) for b in buckets}))
        if not bs or any(not math.isfinite(b) for b in bs):
            # +Inf is the IMPLICIT last bucket: an explicit one would
            # render a duplicate le="+Inf" sample a scraper rejects.
            raise ValueError(
                f"histogram buckets must be finite and non-empty, "
                f"got {buckets}")
        self.buckets = bs  # upper bounds; +Inf is implicit

    def observe(self, value: float, **labels) -> None:
        if not _ENABLED:
            return
        k = _label_key(self.labelnames, labels)
        v = float(value)
        with self._lock:
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = _HistSeries(len(self.buckets) + 1)
            i = 0
            for i, ub in enumerate(self.buckets):  # noqa: B007
                if v <= ub:
                    break
            else:
                i = len(self.buckets)
            s.counts[i] += 1
            s.sum += v
            s.count += 1

    def quantile(self, q: float, **labels) -> float | None:
        """Bucket-interpolated quantile of one series (None when empty).

        Linear interpolation inside the containing bucket — the standard
        Prometheus ``histogram_quantile`` estimate; values in the +Inf
        bucket report the last finite bound (a floor, flagged by being
        exactly that bound)."""
        k = _label_key(self.labelnames, labels)
        with self._lock:
            s = self._series.get(k)
            if s is None or s.count == 0:
                return None
            counts = list(s.counts)
            total = s.count
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                if i >= len(self.buckets):
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                return lo + (hi - lo) * (rank - prev_cum) / c
        return self.buckets[-1]

    def _series_snapshot(self) -> list[dict]:
        with self._lock:
            items = [(k, (list(s.counts), s.sum, s.count))
                     for k, s in self._series.items()]
        out = []
        for k, (counts, ssum, count) in items:
            out.append({
                "labels": dict(zip(self.labelnames, k)),
                "buckets": list(self.buckets),
                "counts": counts,
                "sum": ssum,
                "count": count,
            })
        return out


class Registry:
    """Named metrics, get-or-create; one lock shared by every series.

    Re-registration with the same (kind, labelnames) returns the existing
    metric — module-level handles and late callers converge on one series
    set.  A name re-registered with a DIFFERENT shape raises: two callers
    silently feeding differently-shaped series under one name is exactly
    the ad-hoc-dict drift this registry exists to end.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, labelnames,
                       **kw) -> _Metric:
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}{m.labelnames}, not "
                        f"{cls.kind}{labelnames}")
                return m
            m = cls(name, help, labelnames, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets: tuple[float, ...] = LATENCY_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def reset(self) -> None:
        """Drop every metric (tests).  Handles created before a reset are
        orphaned — re-create them through the registry."""
        with self._lock:
            self._metrics.clear()

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """Structured dump for the in-process client / evidence files."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {
            "enabled": _ENABLED,
            "metrics": [
                {"name": m.name, "kind": m.kind, "help": m.help,
                 "series": m._series_snapshot()}
                for m in sorted(metrics, key=lambda m: m.name)
            ],
        }

    def render_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        for m in sorted(self.snapshot()["metrics"], key=lambda d: d["name"]):
            name, kind = m["name"], m["kind"]
            if m["help"]:
                lines.append(f"# HELP {name} {m['help']}")
            lines.append(f"# TYPE {name} {kind}")
            for s in m["series"]:
                lbl = _fmt_labels(s["labels"])
                if kind == "histogram":
                    cum = 0
                    for ub, c in zip(s["buckets"] + [math.inf],
                                     s["counts"]):
                        cum += c
                        le = "+Inf" if ub == math.inf else _fmt_num(ub)
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels({**s['labels'], 'le': le})}"
                            f" {cum}")
                    lines.append(f"{name}_sum{lbl} {_fmt_num(s['sum'])}")
                    lines.append(f"{name}_count{lbl} {s['count']}")
                else:
                    lines.append(f"{name}{lbl} {_fmt_num(s['value'])}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items()))
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _unescape(v: str) -> str:
    """Single-pass inverse of :func:`_escape`.  Sequential .replace()
    passes would corrupt values like ``\\\\n`` (a literal backslash
    followed by 'n' — any repr'd exception message with a newline): the
    second pass re-interprets bytes the first pass already produced."""
    out: list[str] = []
    i, n = 0, len(v)
    while i < n:
        c = v[i]
        if c == "\\" and i + 1 < n:
            nxt = v[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt,
                                                            "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_text(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Parse Prometheus text exposition into ``{name: [(labels, value)]}``.

    The validator half of :meth:`Registry.render_text`: the round-trip
    test and ``chip_smoke.py`` parse what was rendered rather than
    trusting the renderer.  Raises ValueError on any malformed sample
    line.
    """
    out: dict[str, list[tuple[dict, float]]] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        # name{label="v",...} value    |    name value
        if "{" in line:
            name, rest = line.split("{", 1)
            lbl_body, sep, val = rest.rpartition("}")
            if not sep:
                raise ValueError(f"unterminated label set in {line!r}")
            labels = {}
            for part in _split_labels(lbl_body):
                if not part:
                    continue
                k, _, v = part.partition("=")
                if not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(f"malformed label in {line!r}")
                labels[k.strip()] = _unescape(v[1:-1])
        else:
            name, _, val = line.partition(" ")
            labels = {}
        name, val = name.strip(), val.strip()
        if not name or not val:
            raise ValueError(f"malformed sample line {line!r}")
        out.setdefault(name, []).append(
            (labels, math.inf if val == "+Inf" else float(val)))
    return out


def _split_labels(body: str) -> list[str]:
    """Split a label body on commas outside quotes."""
    parts, cur, in_q, esc = [], [], False, False
    for ch in body:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            cur.append(ch)
            esc = True
        elif ch == '"':
            cur.append(ch)
            in_q = not in_q
        elif ch == "," and not in_q:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur).strip())
    return parts


class MirroredStats(MutableMapping):
    """A ``stats`` dict whose every write also lands in a Gauge.

    Keeps exact dict semantics (``stats["hits"] += 1``, ``dict(stats)``,
    key iteration) while the same values flow through the registry as
    ``<gauge>{key="hits"}`` series.  The local dict is authoritative (what
    a caller reads must not depend on whether obs is enabled) and the
    gauge mirror no-ops when obs is off.  The serving layer's stats
    (ROADMAP item 8) are its users, as in the JAX package.

    Thread-safety matches a plain dict: callers mutate under their own
    lock; the gauge write takes the registry lock internally.
    """

    def __init__(self, gauge_metric: Gauge, initial: dict | None = None,
                 **fixed_labels):
        if "key" not in gauge_metric.labelnames:
            raise ValueError("MirroredStats gauge needs a 'key' label")
        self._gauge = gauge_metric
        self._fixed = fixed_labels
        self._data: dict[str, float] = {}
        for k, v in (initial or {}).items():
            self[k] = v

    def __setitem__(self, key: str, value) -> None:
        self._data[key] = value
        self._gauge.set(value, key=key, **self._fixed)

    def __getitem__(self, key: str):
        return self._data[key]

    def __delitem__(self, key: str) -> None:
        del self._data[key]
        # Retire the mirrored series too: a deleted stats key (a drained
        # batcher lane) must leave the exposition, not linger at its
        # last value forever.
        self._gauge.remove(key=key, **self._fixed)

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __repr__(self) -> str:
        return f"MirroredStats({self._data!r})"


# ---------------------------------------------------------------------------
# The process-global registry + module-level conveniences.  Library code
# creates handles through these so every subsystem lands in ONE exposition.

REGISTRY = Registry()


def counter(name: str, help: str = "", labelnames=()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames=(),
              buckets: tuple[float, ...] = LATENCY_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def render_text() -> str:
    return REGISTRY.render_text()


def reset() -> None:
    REGISTRY.reset()


def dump(path) -> None:
    """Write the snapshot JSON (the input of ``obs.report --metrics``)."""
    with open(path, "w") as f:  # diskio: exempt — exit-time snapshot
        json.dump(snapshot(), f, indent=2)
