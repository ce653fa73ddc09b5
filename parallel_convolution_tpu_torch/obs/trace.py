"""Causal tracing: trace_id / span_id / parent_id spans (the port's own
copy of the JAX package's ``obs/trace.py``).

A span is a named, timed interval with

* ``trace_id``  — 32-hex id of the whole causal tree;
* ``span_id``   — 16-hex id of this interval;
* ``parent_id`` — the enclosing span's id ("" for the root);
* ``links``     — EXTRA causal edges that are not parent/child (a batch
  linking every co-batched request, a waiter linking the build it waited
  on);
* ``attrs``     — free-form JSON-safe labels.

Spans are emitted on END as one ``span`` event into the event log
(:mod:`obs.events`), so a trace is a filtered view of the same timeline;
``python -m parallel_convolution_tpu_torch.obs.trace_report``
reconstructs the trees, the critical paths and Chrome ``trace_event``
JSON.

Context propagation is ``contextvars``-based (thread- and task-correct):
:func:`span` makes its context current for the enclosed code; a worker
that picks work up later re-enters its context with :func:`attach`.
Across transports the context rides a W3C ``traceparent``-style string
(``00-<trace>-<span>-01``).

The reference C code's per-phase ``MPI_Wtime`` breakdown (compute against
the exchange) is what the span tree makes first-class:
``sharded_converge`` runs under a ``device`` span, and
:func:`obs.attribution.record_step` hangs model-attributed ``exchange`` /
``compute`` children off it.

Each live span is also a ``pctpu.<name>`` range on the profiler's clock
(``utils.tracing.span``: entered only while a profiler records), so a
device trace shows the request's phases beside the card's work; the
span's record is the same with or without it.

Disabled mode (``PCTPU_OBS=0``, the metrics switch): :func:`span`
returns a shared no-op context manager after one load + one branch.
With obs ON but no event log installed, contexts and ids still
propagate and only the span *records* are dropped (``events.emit``
no-ops).

Stdlib only.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
import uuid
from typing import NamedTuple

from parallel_convolution_tpu_torch.obs import events as _events, metrics as _metrics
from parallel_convolution_tpu_torch.utils import tracing as _tracing

__all__ = [
    "SpanContext", "add_link", "attach", "build_trees", "current",
    "emit_span", "format_traceparent", "new_span_id", "new_trace_id",
    "parse_traceparent", "span", "span_records",
]

TRACEPARENT_VERSION = "00"


class SpanContext(NamedTuple):
    """The propagatable identity of one span: (trace_id, span_id)."""

    trace_id: str
    span_id: str

    @property
    def ref(self) -> dict:
        """The JSON shape links/events carry."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}


# Current context (what new spans parent to) and current live Span object
# (what add_link attaches to).  Two vars: attach() restores only the
# context — a worker re-entering a request's context must not be able to
# mutate a span that already ended on another thread.
_CTX: contextvars.ContextVar[SpanContext | None] = contextvars.ContextVar(
    "pctpu_trace_ctx", default=None)
_SPAN: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "pctpu_trace_span", default=None)


def new_trace_id() -> str:
    return uuid.uuid4().hex                  # 32 hex chars


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]             # 16 hex chars


def current() -> SpanContext | None:
    """The context new spans would parent to (None = no active trace)."""
    return _CTX.get()


# -- traceparent codec ------------------------------------------------------

def format_traceparent(ctx: SpanContext) -> str:
    """``00-<trace_id>-<span_id>-01`` (the W3C shape; flags always 01)."""
    return f"{TRACEPARENT_VERSION}-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(header) -> SpanContext | None:
    """Parse a ``traceparent`` string; None on anything malformed.

    Tolerant by design (a bad header must degrade to 'start a fresh
    trace', never to a 400): wrong field count, wrong hex widths,
    non-hex bytes, and the all-zero ids the spec forbids all yield None.
    """
    if not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    ver, tid, sid, flags = parts
    if len(ver) != 2 or len(tid) != 32 or len(sid) != 16 or len(flags) != 2:
        return None
    try:
        int(ver, 16), int(tid, 16), int(sid, 16), int(flags, 16)
    except ValueError:
        return None
    if tid == "0" * 32 or sid == "0" * 16:
        return None
    return SpanContext(tid, sid)


# -- the span context manager ----------------------------------------------

def _norm_link(link) -> dict | None:
    if link is None:
        return None
    if isinstance(link, SpanContext):
        return link.ref
    if isinstance(link, dict) and link.get("trace_id") and link.get(
            "span_id"):
        return {"trace_id": str(link["trace_id"]),
                "span_id": str(link["span_id"])}
    return None


class Span:
    """One live span; also its own context manager.

    Mutators (:meth:`set`, :meth:`link`) are called from the owning
    thread between ``__enter__`` and ``__exit__`` — the record is built
    and emitted once, at exit.
    """

    __slots__ = ("name", "context", "parent_id", "links", "attrs",
                 "status", "start_ts", "_start_perf", "_ctx_token",
                 "_span_token", "_range")

    def __init__(self, name: str, context: SpanContext, parent_id: str,
                 links: list[dict], attrs: dict):
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.links = links
        self.attrs = attrs
        self.status = "ok"
        self.start_ts = 0.0
        self._start_perf = 0.0
        self._ctx_token = None
        self._span_token = None
        self._range = _tracing.NULL_RANGE

    @property
    def ref(self) -> dict:
        return self.context.ref

    def set(self, **attrs) -> None:
        """Attach/overwrite attributes on the eventual record."""
        self.attrs.update(attrs)

    def link(self, ref, **attrs) -> None:
        """Add a causal link (a SpanContext or a ``{trace_id, span_id}``
        dict); extra kwargs annotate the edge (e.g. ``kind=...``)."""
        r = _norm_link(ref)
        if r is not None:
            if attrs:
                r = {**r, **attrs}
            self.links.append(r)

    def __enter__(self) -> "Span":
        self._range = _tracing.span(self.name)
        self._range.__enter__()
        self.start_ts = time.time()
        self._start_perf = time.perf_counter()
        self._ctx_token = _CTX.set(self.context)
        self._span_token = _SPAN.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._start_perf
        self._range.__exit__(exc_type, exc, tb)
        _SPAN.reset(self._span_token)
        _CTX.reset(self._ctx_token)
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", repr(exc)[:200])
        _emit_record(self.name, self.context, self.parent_id,
                     self.start_ts, dur, self.status, self.links,
                     self.attrs)
        return False


class _NullSpan:
    """The disabled-mode singleton: a reentrant no-op Span look-alike
    (stateless, so one shared instance is safe under any nesting)."""

    __slots__ = ()
    name = ""
    context = None
    parent_id = ""
    status = "ok"
    ref = None

    def set(self, **attrs) -> None:
        pass

    def link(self, ref, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()

_INHERIT = object()   # sentinel: span() parents to the current context


def span(name: str, *, parent=_INHERIT, links=(), **attrs):
    """Open a span: ``with trace.span("device", backend=b) as sp: ...``

    ``parent`` defaults to the current context (nesting); pass an
    explicit :class:`SpanContext` to parent across threads, or ``None``
    to force a new root trace.  ``links`` are extra causal edges
    (contexts or ref dicts).  With obs disabled this is one load + one
    branch returning the shared no-op span.
    """
    if not _metrics.enabled():
        return NULL_SPAN
    pctx = _CTX.get() if parent is _INHERIT else parent
    tid = pctx.trace_id if pctx is not None else new_trace_id()
    ctx = SpanContext(tid, new_span_id())
    lk = [r for r in (_norm_link(l) for l in links) if r is not None]
    return Span(name, ctx, pctx.span_id if pctx is not None else "",
                lk, dict(attrs))


@contextlib.contextmanager
def attach(ctx: SpanContext | None):
    """Make ``ctx`` current WITHOUT opening a span — a worker thread
    resuming another thread's causal context, or telemetry emitted after
    a span already closed (``sharded_converge`` attaches its device
    span's context to parent the exchange / compute attribution spans)."""
    if ctx is None or not _metrics.enabled():
        yield
        return
    token = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(token)


def add_link(ref, **attrs) -> None:
    """Link ``ref`` onto the innermost live span of THIS thread (no-op
    without one) — deep code annotating its caller's span, e.g. a
    single-flight waiter linking the leader's compile span."""
    sp = _SPAN.get()
    if sp is not None:
        sp.link(ref, **attrs)


def emit_span(name: str, *, trace_id: str, parent_id: str = "",
              start_ts: float | None = None, dur_s: float = 0.0,
              links=(), status: str = "ok", **attrs) -> str | None:
    """Emit a SYNTHETIC span whose timing was measured externally (the
    model-attributed exchange / compute split of a measured wall).
    Returns the new span_id (None when obs is disabled)."""
    if not _metrics.enabled():
        return None
    sid = new_span_id()
    _emit_record(name, SpanContext(trace_id, sid), parent_id,
                 time.time() if start_ts is None else start_ts,
                 dur_s, status,
                 [r for r in (_norm_link(l) for l in links)
                  if r is not None],
                 attrs)
    return sid


def _emit_record(name, ctx, parent_id, start_ts, dur_s, status, links,
                 attrs) -> None:
    extra = {}
    if links:
        extra["links"] = links
    if attrs:
        extra["attrs"] = attrs
    _events.emit(
        "span", name=name, trace_id=ctx.trace_id, span_id=ctx.span_id,
        parent_id=parent_id, start_ts=round(float(start_ts), 6),
        dur_s=round(float(dur_s), 6), status=status, **extra)


# -- reconstruction (shared by obs.trace_report and the tests) --------------

def span_records(recs: list[dict]) -> list[dict]:
    """The span events of a parsed timeline (obs.events.read_events)."""
    return [r for r in recs if r.get("kind") == "span"]


def build_trees(spans: list[dict]) -> dict[str, dict]:
    """Group span records per trace and wire up the trees.

    Returns ``{trace_id: {"spans": {span_id: rec}, "roots": [span_id],
    "children": {span_id: [span_id]}, "orphans": [span_id]}}``.

    * a **root** has ``parent_id == ""`` — or a parent marked
      ``attrs.remote_parent`` that is absent from the log: a request
      admitted under an upstream ``traceparent`` parents to a span in
      the CALLER's process, which is a local root here, not a loss;
    * an **orphan** names a (local) parent that does not exist in its
      own trace — a lost span line (or a bug in the propagation),
      exactly what ``obs.trace_report`` fails on;
    * children are sorted by ``start_ts`` so reports read in time order.

    Spans are emitted at END, so children precede parents in the log —
    reconstruction is order-independent by design.
    """
    out: dict[str, dict] = {}
    for r in spans:
        tid, sid = r.get("trace_id"), r.get("span_id")
        if not tid or not sid:
            continue
        t = out.setdefault(tid, {"spans": {}, "roots": [], "children": {},
                                 "orphans": []})
        t["spans"][sid] = r
    for tid, t in out.items():
        for sid, r in t["spans"].items():
            pid = r.get("parent_id", "")
            if not pid:
                t["roots"].append(sid)
            elif pid in t["spans"]:
                t["children"].setdefault(pid, []).append(sid)
            elif r.get("attrs", {}).get("remote_parent"):
                t["roots"].append(sid)
            else:
                t["orphans"].append(sid)
        for kids in t["children"].values():
            kids.sort(key=lambda s: t["spans"][s].get("start_ts", 0.0))
        t["roots"].sort(key=lambda s: t["spans"][s].get("start_ts", 0.0))
    return out
