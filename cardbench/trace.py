"""The traced window: ``torch.profiler`` (CUPTI) over the measured loop,
reduced to what the per-layer metrics read.

:class:`Window` wraps the loop.  With tracing off it only marks spans.
With tracing on it records the CPU and CUDA activity, writes the Chrome
trace to a temporary file of ``TMPDIR``, reads it back and deletes it,
and keeps a summary: the window's length, the seconds in which a kernel,
copy or fill ran on the card (their union), each kernel's seconds, the
copies' seconds by direction, and the longest idle gaps of the card,
named by the innermost host span or operation that was running then.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

WINDOW_SPAN = "cardbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def span(name: str):
    """A named host span: a ``record_function`` range, which the traced
    window records and an untraced one ignores at little cost."""
    import torch

    return torch.profiler.record_function(name)


class Window:
    """The measured window, traced when ``enabled``; :attr:`summary`
    holds the reduction after it closes (None untraced)."""

    def __init__(self, enabled: bool):
        self.enabled = bool(enabled)
        self.summary: dict | None = None
        self._prof = None
        self._span = None

    def __enter__(self) -> "Window":
        import torch

        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        self._span = span(WINDOW_SPAN)
        self._span.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._span.__exit__(*exc)
        if self._prof is None:
            return
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        fd, path = tempfile.mkstemp(suffix=".json", prefix="cardbench_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)
        self._prof = None
        self.summary = summarize(events)


def _union(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(intervals, lo: float, hi: float):
    """The idle (start, end) gaps of [lo, hi] between ``intervals``."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [g for g in out if g[1] > g[0]]


def summarize(events: list, top: int = 10) -> dict:
    """The reduction of a Chrome trace's events (times in microseconds)
    to seconds: ``window_s``, ``busy_s``, ``kernels`` {name: s},
    ``copies`` {direction: s}, ``idle_gaps`` [[host
    name, s], ...] (the ``top`` longest)."""
    win = [e for e in events if e.get("name") == WINDOW_SPAN
           and e.get("ph") == "X"]
    if not win:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    dev, host = [], []
    kernels: dict = {}
    copies: dict = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        cat = e.get("cat", "")
        if cat in _DEVICE_CATS:
            s, t = max(s, lo), min(t, hi)
            if t <= s:
                continue
            dev.append((s, t))
            if cat == "kernel":
                kernels[e["name"]] = kernels.get(e["name"], 0.0) + (t - s)
            else:
                kind = e.get("name", cat)
                copies[kind] = copies.get(kind, 0.0) + (t - s)
        elif cat in _HOST_CATS and e.get("name") != WINDOW_SPAN:
            host.append((s, t, e["name"]))
    gaps = sorted(_gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:top]
    named = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                else "no host span")
        named.append([name, (g1 - g0) * 1e-6])
    return {"window_s": (hi - lo) * 1e-6, "busy_s": _union(dev) * 1e-6,
            "kernels": {k: v * 1e-6 for k, v in kernels.items()},
            "copies": {k: v * 1e-6 for k, v in copies.items()},
            "idle_gaps": named}


def merge(summaries: list) -> dict:
    """One summary for several cards: ``window_s`` and ``busy_s`` the
    means over the cards, kernel and copy seconds summed, the gaps of
    every card, longest first."""
    n = len(summaries)
    out = {"window_s": sum(s["window_s"] for s in summaries) / n,
           "busy_s": sum(s["busy_s"] for s in summaries) / n,
           "kernels": {}, "copies": {},
           "idle_gaps": sorted((g for s in summaries for g in s["idle_gaps"]),
                               key=lambda g: -g[1])[:10]}
    for s in summaries:
        for part in ("kernels", "copies"):
            for k, v in s[part].items():
                out[part][k] = out[part].get(k, 0.0) + v
    return out


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    the most seconds (kernels and copies) and the longest idle gaps."""
    ops = list(summary["kernels"].items()) + list(summary["copies"].items())
    ops.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops[:top]],
            "idle_gaps": [list(g) for g in summary["idle_gaps"][:top]]}


def idle_share(summary: dict | None) -> float | None:
    """Percent of the traced window in which the card ran nothing (the
    mean over the cards); None untraced."""
    if not summary or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
