"""The program's spans in a traced window, reduced: each ``pctpu.*`` range
the port opens (``utils.tracing.span``: an entry's copies, the chunk loop,
the set-up between cards, a V-cycle level), with the card's idle and
device seconds put down to it.

:func:`reduce` reads a Chrome trace's events (times in microseconds)
between ``lo`` and ``hi`` and returns, for each span name, ``count``,
``host_s`` (the sum of its durations), ``idle_s`` (the seconds in which
the card ran nothing while it was the innermost program span open on any
thread of the process; idle with none open goes under ``""``, so the idle
seconds sum to ``window_s - busy_s``) and ``device_s`` (the kernel, copy
and fill seconds launched while it was the innermost program span on the
launching thread, matched to their launches by ``correlation``).
:func:`merge` takes the mean over the cards, as ``trace.merge`` does for
``window_s`` and ``busy_s``.

The harness's summary does not carry this reduction yet: a ``spans`` key
in ``trace.summarize`` and ``trace.merge`` is what reads it.  Until then
the same run with the key added is

    python3 -m cardbench.spans --workload <name> --seed <n> --seconds <s> --trace 1

which prints the cell's result line as ``cardbench.run`` does, and on
standard error a table of the spans, the idle of each layer a unit, and
each rank's counts of a run over several processes.
"""

from __future__ import annotations

import json
import sys

from cardbench import trace

PREFIX = "pctpu."
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_FIELDS = ("count", "host_s", "idle_s", "device_s")

# The idle a unit of each layer's spans (a name ending in "." names every
# span under it), in milliseconds: what the per-layer metrics of the
# layers "between cards", "entry" and "solver" read.
LAYERS = {
    "exchange_idle_ms": ("rdma.open", "rdma.close"),
    "entry_idle_ms": ("entry.copy_in", "step.prepare", "step.join",
                      "entry.copy_out"),
    "solver_idle_ms": ("mg.",),
}


def _innermost(active: dict) -> str:
    """The name of the innermost of the open spans ``{key: (start, end,
    name)}``: the latest to start (the shortest of those that started
    together); ``""`` where none is open."""
    if not active:
        return ""
    return max(active.values(), key=lambda v: (v[0], -v[1]))[2]


def _idle_by_span(spans: list, gaps: list) -> dict:
    """Each idle gap's seconds put down to the innermost span open then,
    on any thread."""
    marks = sorted([(s, 1, k) for k, (s, _, _, _) in enumerate(spans)]
                   + [(t, 0, k) for k, (_, t, _, _) in enumerate(spans)])
    out: dict = {}
    active: dict = {}
    m = 0
    for g0, g1 in gaps:
        at = g0
        while at < g1:
            while m < len(marks) and marks[m][0] <= at:
                _, starts, k = marks[m]
                if starts:
                    active[k] = spans[k][:3]
                else:
                    active.pop(k, None)
                m += 1
            end = min(g1, marks[m][0]) if m < len(marks) else g1
            name = _innermost(active)
            out[name] = out.get(name, 0.0) + (end - at)
            at = end
    return out


def _device_by_span(spans: list, launches: dict, ops: list) -> dict:
    """Each device operation's seconds put down to the innermost span
    open on the thread that launched it, at the launch."""
    at_launch: dict = {}
    by_thread: dict = {}
    for k, (s, t, _, tid) in enumerate(spans):
        by_thread.setdefault(tid, []).extend([(s, 0, k), (t, 2, k)])
    for corr, (ts, tid) in launches.items():
        by_thread.setdefault(tid, []).append((ts, 1, corr))
    for marks in by_thread.values():
        active: dict = {}
        for _, what, k in sorted(marks, key=lambda x: (x[0], x[1])):
            if what == 0:
                active[k] = spans[k][:3]
            elif what == 2:
                active.pop(k, None)
            else:
                at_launch[k] = _innermost(active)
    out: dict = {}
    for s, t, corr in ops:
        name = at_launch.get(corr, "")
        out[name] = out.get(name, 0.0) + (t - s)
    return out


def _correlation(e: dict):
    return (e.get("args") or {}).get("correlation")


def reduce(events: list, lo: float, hi: float) -> dict:
    """``{name: {count, host_s, idle_s, device_s}}`` of the program's spans
    in the window ``[lo, hi]`` (microseconds, as the trace's ``ts``)."""
    spans, ops, launches = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        cat = e.get("cat", "")
        if cat == "user_annotation" and str(e.get("name", "")).startswith(
                PREFIX):
            s, t = max(s, lo), min(t, hi)
            if t >= s:
                spans.append((s, t, e["name"][len(PREFIX):],
                              (e.get("pid"), e.get("tid"))))
        elif cat in _DEVICE_CATS:
            s, t = max(s, lo), min(t, hi)
            if t > s:
                ops.append((s, t, _correlation(e)))
        elif cat in _LAUNCH_CATS and _correlation(e) is not None:
            launches[_correlation(e)] = (s, (e.get("pid"), e.get("tid")))
    out: dict = {}

    def row(name):
        return out.setdefault(name, dict.fromkeys(_FIELDS, 0.0))

    for s, t, name, _ in spans:
        r = row(name)
        r["count"] += 1
        r["host_s"] += (t - s) * 1e-6
    gaps = trace._gaps([(s, t) for s, t, _ in ops], lo, hi)
    for name, v in _idle_by_span(spans, gaps).items():
        row(name)["idle_s"] += v * 1e-6
    for name, v in _device_by_span(spans, launches, ops).items():
        row(name)["device_s"] += v * 1e-6
    for r in out.values():
        r["count"] = int(r["count"])
    return out


def merge(per_card: list) -> dict:
    """One reduction for several cards: each name's fields the mean over
    the cards (a card that never opened it counts 0)."""
    n = len(per_card)
    out: dict = {}
    for spans in per_card:
        for name, r in spans.items():
            m = out.setdefault(name, dict.fromkeys(_FIELDS, 0.0))
            for f in _FIELDS:
                m[f] += r[f] / n
    return out


def window(events: list) -> tuple[float, float]:
    """The traced window's ``(lo, hi)``: its ``cardbench.window`` span."""
    win = [e for e in events if e.get("name") == trace.WINDOW_SPAN
           and e.get("ph") == "X"]
    if not win:
        raise RuntimeError(f"the trace has no {trace.WINDOW_SPAN} span")
    lo = float(win[0]["ts"])
    return lo, lo + float(win[0]["dur"])


_SUMMARIZE, _MERGE = trace.summarize, trace.merge


def summarize(events: list, top: int = 10) -> dict:
    """``trace.summarize`` with the ``spans`` key added."""
    out = _SUMMARIZE(events, top)
    out["spans"] = reduce(events, *window(events))
    return out


def merge_summaries(summaries: list) -> dict:
    """``trace.merge`` with the ``spans`` key added, and each card's
    under ``spans_by_card``."""
    out = _MERGE(summaries)
    out["spans_by_card"] = [s["spans"] for s in summaries]
    out["spans"] = merge(out["spans_by_card"])
    return out


def layer_idle_ms(summary: dict | None, names, units: int) -> float | None:
    """The card's idle milliseconds a unit (a job, call or solve) in the
    spans ``names`` (a name ending in "." names every span under it) of
    a traced summary; None untraced, where the trace saw no device
    activity (as on the CPU), or where none of the spans was opened."""
    if not summary or summary["busy_s"] <= 0 or not units:
        return None

    def chosen(n):
        return any(n.startswith(p) if p.endswith(".") else n == p
                   for p in names)

    picked = [r for n, r in summary["spans"].items()
              if chosen(n) and r["count"]]
    if not picked:
        return None
    return 1e3 * sum(r["idle_s"] for r in picked) / units


def wire() -> None:
    """Add the ``spans`` key to this process's traced summaries."""
    trace.summarize, trace.merge = summarize, merge_summaries


def _child(*args) -> None:
    """A spawned rank's entry (``resident_jobs._child``), wired first."""
    from cardbench.kinds import resident_jobs

    wire()
    resident_jobs._child(*args)


def report(summary: dict, units: int, out=sys.stderr) -> None:
    """The spans of a traced run's summary on ``out``: a table by idle
    seconds, the idle share put down to a program span, each layer's
    idle a unit, and each card's counts where there are several."""
    spans = summary["spans"]
    idle = summary["window_s"] - summary["busy_s"]
    print(f"spans: window_s {summary['window_s']!r} busy_s "
          f"{summary['busy_s']!r} units {units}", file=out)
    print("spans: name count host_s idle_s device_s idle_ms_a_unit",
          file=out)
    for name, r in sorted(spans.items(), key=lambda kv: -kv[1]["idle_s"]):
        print(f"spans: {name or '(none)'} {r['count']!r} {r['host_s']!r} "
              f"{r['idle_s']!r} {r['device_s']!r} "
              f"{1e3 * r['idle_s'] / max(units, 1)!r}", file=out)
    named = idle - spans.get("", {}).get("idle_s", 0.0)
    print(f"spans: idle put down to a program span {named!r} of {idle!r} s",
          file=out)
    for metric, names in LAYERS.items():
        print(f"spans: {metric} {layer_idle_ms(summary, names, units)!r}",
              file=out)
    for rank, card in enumerate(summary.get("spans_by_card", [])):
        counts = {n: r["count"] for n, r in sorted(card.items()) if n}
        print(f"spans: rank {rank} counts {json.dumps(counts)}", file=out)
    print(f"spans: json {json.dumps(spans)}", file=out)


def main(argv=None) -> int:
    from cardbench import run

    run._cache_dirs()
    seen: list = []

    def kept(reduction):
        def keep(*args):
            seen.append(reduction(*args))
            return seen[-1]
        return keep

    trace.summarize, trace.merge = kept(summarize), kept(merge_summaries)
    line = run.run(argv, child=_child)
    if seen:
        report(seen[-1], int(line["attempted"]))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
