"""Phase timing and the device trace (the JAX package's ``utils/tracing.py``).

* :class:`PhaseTimer` — named wall-clock phases with a structured report.
  Phases NEST (thread-locally); nested walls are recorded under
  slash-joined paths and :meth:`PhaseTimer.to_row` flattens them into
  bench-row keys.  A phase's ``fence`` makes it mean what it says under
  asynchronous launches: a callable is called, a tensor's device is
  synchronised, before the clock stops.
* :func:`device_trace` — ``torch.profiler`` with CPU and CUDA activities
  around a block, written as Chrome ``trace_event`` JSON into a directory
  (the per-kernel timeline the reference never had; the JAX package's
  ``jax.profiler.trace``).  On a card it raises rather than return a
  trace without CUDA activity (a profiler that CUPTI refused).
* :func:`span` — a ``pctpu.<name>`` range on the profiler's clock around
  a phase of the program (an entry's copies, the chunk loop, the set-up
  between cards, a V-cycle level), entered only while a profiler
  records and obs is on: otherwise one shared no-op, so the hooks can
  sit on the hot path.  Nothing is written to the event log.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from pathlib import Path

from parallel_convolution_tpu_torch.obs import metrics as obs_metrics

__all__ = ["DeviceTrace", "PhaseTimer", "SPAN_PREFIX", "device_trace",
           "kernel_counts", "span"]

# Every range the program opens is named ``pctpu.<name>``: a trace's
# reader tells the program's spans from torch's ops and its caller's.
SPAN_PREFIX = "pctpu."


class _NullRange:
    """The shared no-op :func:`span` returns while nothing records
    (stateless, so one instance serves any nesting and any thread)."""

    __slots__ = ()

    def __enter__(self) -> "_NullRange":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_RANGE = _NullRange()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``pctpu.<name>``
    where obs is on (``PCTPU_OBS``) and a profiler records
    (``torch.profiler.profile``, :func:`device_trace`); else
    :data:`NULL_RANGE`.  The choice is made here, when the span is
    opened: a range once entered is exited even if the profiler stopped
    in between.  A range costs about 13 µs of host time (torch 2.13 on a
    Xeon), the check about 0.2 µs.  ``torch`` is looked up, never
    imported: without it no profiler can be recording."""
    if not obs_metrics.enabled():
        return NULL_RANGE
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return NULL_RANGE
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _fence(fence) -> None:
    """Wait for ``fence``: call a callable, synchronise a tensor's card."""
    if callable(fence):
        fence()
        return
    import torch

    if torch.is_tensor(fence) and fence.device.type == "cuda":
        torch.cuda.synchronize(fence.device)


class PhaseTimer:
    """Accumulate named wall-clock phases.

    >>> t = PhaseTimer()
    >>> with t.phase("iterate", fence=out):   # doctest: +SKIP
    ...     out = run()
    >>> t.report()                            # doctest: +SKIP

    Phases nest: entering ``phase("device")`` inside ``phase("serve")``
    accumulates under the path ``"serve/device"`` while ``"serve"`` keeps
    the enclosing wall — so a report's top-level walls stay additive and
    nested ones attribute where the time inside them went.

    Thread-safe: the nesting stack is **thread-local** (each thread nests
    against its own enclosing phases, never another thread's) and the
    accumulated walls and counts are lock-protected.
    """

    def __init__(self) -> None:
        self.walls: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()

    def _stack(self) -> list[str]:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        """Time a phase; ``fence`` (a callable, or a tensor whose card is
        synchronised) is waited on before the clock stops, so that
        asynchronous device work is charged here."""
        stack = self._stack()
        stack.append(name)
        path = "/".join(stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            try:
                if fence is not None:
                    _fence(fence)
            finally:
                # Record + pop even when the body OR the fence raised: a
                # failing phase must not corrupt the nesting stack.
                dt = time.perf_counter() - t0
                stack.pop()
                with self._lock:
                    self.walls[path] = self.walls.get(path, 0.0) + dt
                    self.counts[path] = self.counts.get(path, 0) + 1

    def report(self) -> dict:
        with self._lock:
            walls = dict(self.walls)
            counts = dict(self.counts)
        # Total sums only TOP-LEVEL phases: a nested wall is already inside
        # its parent's, so summing every path would double-count it.
        total = sum(v for k, v in walls.items() if "/" not in k)
        return {
            "total_s": round(total, 4),
            "phases": {
                k: {"wall_s": round(v, 4), "calls": counts[k],
                    "share": round(v / total, 3) if total else 0.0}
                for k, v in sorted(walls.items(), key=lambda kv: -kv[1])
            },
        }

    def to_row(self, prefix: str = "phase_", scale: float = 1.0,
               digits: int = 6) -> dict:
        """Flat ``{prefix<path>_s: wall}`` dict for merging into bench rows.

        Nested paths flatten with underscores (``serve/device`` →
        ``phase_serve_device_s``); ``scale`` converts units.  Flattening
        can collide (the path ``a/b`` and a phase named ``a_b``): colliding
        walls are SUMMED, so attribution may blur but no wall is dropped.
        """
        with self._lock:
            walls = dict(self.walls)
        out: dict[str, float] = {}
        for k, v in walls.items():
            key = f"{prefix}{k.replace('/', '_')}_s"
            out[key] = out.get(key, 0.0) + v * scale
        return {k: round(v, digits) for k, v in out.items()}

    def wall(self, name: str) -> float:
        """Accumulated seconds for one phase path (0.0 if never entered)."""
        with self._lock:
            return self.walls.get(name, 0.0)

    def dump(self, path) -> None:
        with open(path, "w") as f:  # diskio: exempt — exit-time report
            json.dump(self.report(), f, indent=2)


class DeviceTrace:
    """What :func:`device_trace` yields: ``path`` (the Chrome JSON file,
    set when the block ends) and ``device`` (the traced device)."""

    def __init__(self, device) -> None:
        self.device = device
        self.path: Path | None = None

    def events(self) -> list[dict]:
        """The trace's ``traceEvents``."""
        return json.loads(self.path.read_text()).get("traceEvents", [])


_TRACE_SEQ = itertools.count()


@contextlib.contextmanager
def device_trace(logdir, device=None):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity on a card) and write Chrome ``trace_event`` JSON into
    ``logdir`` (``trace_<pid>_<n>.json``, open it in chrome://tracing or
    ui.perfetto.dev).

    ``device`` defaults to the card (it raises without CUDA); pass
    ``"cpu"`` to trace the CPU alone.  On a card the device is
    synchronised before the trace stops, and a trace that recorded no
    kernel raises ``RuntimeError``: CUPTI refused the profiler (or the
    block launched nothing), and an empty device trace would pass for a
    quiet card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from parallel_convolution_tpu_torch.utils.platform import resolve_device

    dev = torch.device(resolve_device(device))
    on_card = dev.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    out = DeviceTrace(dev)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield out
        if on_card:
            torch.cuda.synchronize(dev)
    out.path = logdir / f"trace_{os.getpid()}_{next(_TRACE_SEQ)}.json"
    prof.export_chrome_trace(str(out.path))
    if on_card and not any(e.get("cat") == "kernel" for e in out.events()):
        raise RuntimeError(
            f"device_trace: no CUDA kernel in {out.path}: the profiler "
            "recorded no CUDA activity (CUPTI refused, or nothing ran on "
            "the card)")


def kernel_counts(trace: DeviceTrace, names) -> dict[str, int]:
    """Kernel events of ``trace`` whose (demangled or mangled) name
    contains each of ``names``: ``{name: count}``."""
    kernels = [e.get("name", "") for e in trace.events()
               if e.get("cat") == "kernel"]
    return {n: sum(n in k for k in kernels) for n in names}
