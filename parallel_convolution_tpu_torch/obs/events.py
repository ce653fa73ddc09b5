"""Append-only JSONL structured event log with atomic rotation (the port's
own copy of the JAX package's ``obs/events.py``: the same line schema,
kinds, rotation and reentrancy guard, so one log reads the same through
either package's reports).

One JSONL line per event, every line carrying

* ``seq``  — per-WRITER monotonic sequence number (each process is its
  own stream, identified by the ``pid`` field — a gap within one pid's
  stream = lost line; interleaved pids are expected when the ranks of a
  job share one ``PCTPU_OBS_EVENTS`` path);
* ``ts``   — wall clock (``time.time()``, for humans and cross-process
  merging);
* ``perf`` — ``time.perf_counter()`` (monotonic, for intra-process
  deltas that wall-clock steps can't corrupt);
* ``kind`` — one of :data:`KINDS`, the typed vocabulary below;
* free-form event fields (JSON-safe scalars/lists/dicts).

Rotation is atomic: when the live file would exceed ``max_bytes`` the
writer renames it to ``<path>.1`` (shifting older generations up, oldest
dropped) via ``os.replace`` and starts fresh — a reader never observes a
half-rotated file, and ``seq`` continues across generations so the
stitched timeline stays gap-checkable.

Module-level :func:`emit` consults the process-global log exactly like
``resilience.faults.fault_point`` consults its plan: with no log
installed (or obs disabled, ``PCTPU_OBS=0``) it is one global load and a
test.  The CLI installs a log from the ``PCTPU_OBS_EVENTS`` env (a path)
via :func:`install_from_env`.

Each line's write first consults the ``events_emit`` disk fault site
(``resilience.diskio``); a failed write counts a dropped line and never
raises.  ``resilience.faults`` emits ``fault_trigger`` through this module
and this module imports it: the fault side imports this one inside its
firing branch, so neither import needs the other first.

Stdlib only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path

from parallel_convolution_tpu_torch.obs import metrics as _metrics
from parallel_convolution_tpu_torch.resilience import diskio as _diskio
from parallel_convolution_tpu_torch.resilience.faults import InjectedFault

# Reentrancy guard for the ``events_emit`` fault site: the fault plan
# itself emits a ``fault_trigger`` event when a site fires, so the
# inner emit must NOT consult again — under ``events_emit:*`` that
# would recurse without bound.  Thread-local because two threads'
# emits are independent consults.
_EMIT_GUARD = threading.local()

__all__ = [
    "EVENTS_ENV", "EventLog", "KINDS", "configure", "emit", "get_log",
    "install_from_env", "note_compile", "read_events", "validate_event",
]

EVENTS_ENV = "PCTPU_OBS_EVENTS"

# The typed event vocabulary — one name per thing that happens to the
# stack, mapping 1:1 onto the subsystems that emit it: the JAX package's
# set, so that a log validates the same in both packages (the serving,
# fleet and supervisor kinds are emitted once ROADMAP items 8 and 13 are
# ported).  Emitting an unknown kind raises: a typo'd kind would otherwise
# silently fork the schema every report consumer depends on.
KINDS = frozenset({
    "compile",             # something built once: a kernel library's
    #                        nvcc build, a new launch plan, a multigrid
    #                        level program
    "exchange",            # halo traffic attribution for one iterate call
    "degrade",             # backend degradation walk resolved a lower tier
    "retry",               # with_retry observed a transient + backoff
    "checkpoint_save",     # snapshot written (duration + bytes)
    "checkpoint_load",     # snapshot loaded (duration + bytes)
    "checkpoint_reshard",  # load crossed a grid change
    "quarantine",          # a torn snapshot was quarantined (cause per shard)
    "reshape",             # serving engine swapped its grid mid-process
    "admission",           # a request was shed with a typed reason
    "fault_trigger",       # an injected fault fired at a named site
    "heartbeat",           # supervisor liveness tick
    "leg",                 # supervisor leg state change (start/done/...)
    "serve",               # service lifecycle (boot, close)
    "router",              # replica-set router: failover, spill, replica
    #                        ready-state flip, tenant-quota shed,
    #                        kill/revive, replica add/remove/ring-join
    "autoscale",           # fleet control loop: scale decision + signals,
    #                        pre-warm report, drain report
    "resume",              # durable converge job resumed on a surviving
    #                        replica from its ledger token
    "chaos",               # chaos transport injected a network-shaped
    #                        failure (site, mode, replica)
    "wal",                 # router write-ahead journal lifecycle
    #                        (recovered / torn_tail / quarantined /
    #                        append_failed / takeover)
    "span",                # one closed trace span (obs.trace): trace_id/
    #                        span_id/parent_id + start_ts/dur_s/links
    "shard",               # sharded control plane: fenced takeover,
    #                        shard-map version bump, peer sync, peer-death
    #                        suspicion
})

_REQUIRED = ("seq", "ts", "perf", "kind")


class EventLog:
    """One append-only JSONL event file with size-bounded rotation."""

    def __init__(self, path, *, max_bytes: int = 8 << 20, keep: int = 2):
        if max_bytes < 4096:
            raise ValueError("max_bytes must be >= 4096")
        if keep < 0:
            raise ValueError("keep must be >= 0")
        self.path = Path(path)
        self.max_bytes = int(max_bytes)
        self.keep = int(keep)
        self._lock = threading.Lock()
        self._seq = 0
        self._size = 0
        self._fh = None
        # Lines lost to disk failure: the event log is telemetry, and
        # telemetry IO must never raise into the run — a failed write
        # COUNTS here instead (the seq it consumed becomes the documented
        # in-stream gap).
        self.dropped = 0
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def _open(self) -> None:
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = self._fh.tell()

    def _ensure_live(self) -> None:
        """Re-open if another PROCESS rotated (or removed) the live file
        out from under our fd — writes must land in the current
        generation, never keep streaming into a renamed ``.1``."""
        if self._fh is None:
            self._open()
            return
        try:
            st = os.stat(self.path)
        except OSError:
            st = None
        if st is None or st.st_ino != os.fstat(self._fh.fileno()).st_ino:
            self._fh.close()
            self._open()

    def _rotate_locked(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self.keep == 0:
            try:
                self.path.unlink()
            except OSError:
                pass
        else:
            # Shift generations up, oldest first, each step atomic.  Every
            # rename is guarded against exactly ONE failure: a SIBLING
            # process (or any external actor) rotating the same path can
            # win the race between our ``exists()`` check and the
            # ``os.replace`` — a vanished source must degrade to "that
            # generation already moved", not to a FileNotFoundError that
            # kills the writer thread and LOSES the line being emitted
            # (the multi-thread rotation stress in the tests pins this).  Persistent failures (EACCES, a no-rename mount) are
            # NOT swallowed — silently disabling rotation would let the
            # live file grow past max_bytes forever.
            for i in range(self.keep - 1, 0, -1):
                src = self.path.with_name(f"{self.path.name}.{i}")
                if src.exists():
                    try:
                        os.replace(src, self.path.with_name(
                            f"{self.path.name}.{i + 1}"))
                    except FileNotFoundError:
                        pass
            try:
                os.replace(self.path,
                           self.path.with_name(f"{self.path.name}.1"))
            except FileNotFoundError:
                pass  # live vanished: a sibling already rotated it away
            # Drop anything beyond keep (the shift above may have created
            # .keep+1 transiently — remove it).
            extra = self.path.with_name(f"{self.path.name}.{self.keep + 1}")
            try:
                extra.unlink()
            except OSError:
                pass
        self._open()

    def emit(self, kind: str, **fields) -> dict:
        """Append one event; returns the record built (tests assert on
        it).  Raises ValueError on an unknown kind or a reserved field.
        DISK failure (real or via the ``events_emit`` fault site) never
        raises: the line is counted dropped — its consumed seq is the
        in-stream gap readers already know how to interpret."""
        if kind not in KINDS:
            raise ValueError(
                f"unknown event kind {kind!r}; known: {sorted(KINDS)}")
        bad = set(fields) & set(_REQUIRED)
        if bad:
            raise ValueError(f"fields {sorted(bad)} are reserved")
        # Consult OUTSIDE self._lock: a firing site emits its own
        # fault_trigger event through this very log, and that inner
        # emit must be able to take the (non-reentrant) lock.  The
        # guard keeps the inner emit from consulting again.
        failed = False
        if not getattr(_EMIT_GUARD, "active", False):
            _EMIT_GUARD.active = True
            try:
                _diskio.consult("events_emit")
            except (OSError, InjectedFault):
                # The site's contract: "counts a dropped line instead of
                # raising into the run" — both for translated disk modes
                # and for the raw injected fault.
                failed = True
            finally:
                _EMIT_GUARD.active = False
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "ts": round(time.time(), 6),
                   "perf": round(time.perf_counter(), 6),
                   "pid": os.getpid(), "kind": kind, **fields}
            line = json.dumps(rec, default=str) + "\n"
            # Size accounting in BYTES (the unit tell()/max_bytes use):
            # len(line) counts characters, which under-counts any
            # non-ASCII field and lets the file overshoot max_bytes.
            nbytes = len(line.encode("utf-8"))
            try:
                if failed:
                    raise OSError("injected events_emit failure")
                self._ensure_live()
                if (self._size + nbytes > self.max_bytes
                        and self._size > 0):
                    self._rotate_locked()
                self._fh.write(line)
                self._fh.flush()
                self._size += nbytes
            except OSError:
                self.dropped += 1
                if _metrics.enabled():
                    _metrics.counter(
                        "pctpu_events_dropped_total",
                        "event lines lost to disk failure (the log "
                        "keeps its seq gap; serving unaffected)").inc()
        return rec

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def generations(self) -> list[Path]:
        """Existing files, oldest first (``.N`` ... ``.1``, then live)."""
        out = []
        for i in range(self.keep + 1, 0, -1):
            p = self.path.with_name(f"{self.path.name}.{i}")
            if p.exists():
                out.append(p)
        if self.path.exists():
            out.append(self.path)
        return out


def validate_event(rec: dict) -> list[str]:
    """Schema problems of one parsed event line ([] = valid).

    The contract every consumer (``obs.report``, ``chip_smoke.py``, the
    tests) checks instead of re-inventing: required keys present and
    typed, kind known, seq positive."""
    problems = []
    if not isinstance(rec, dict):
        return [f"not an object: {type(rec).__name__}"]
    for k in _REQUIRED:
        if k not in rec:
            problems.append(f"missing {k!r}")
    if isinstance(rec.get("seq"), bool) or not isinstance(
            rec.get("seq"), int) or (isinstance(rec.get("seq"), int)
                                     and rec["seq"] < 1):
        problems.append(f"bad seq {rec.get('seq')!r}")
    for k in ("ts", "perf"):
        if k in rec and not isinstance(rec[k], (int, float)):
            problems.append(f"bad {k} {rec.get(k)!r}")
    if rec.get("kind") not in KINDS:
        problems.append(f"unknown kind {rec.get('kind')!r}")
    return problems


def read_events(path, include_rotated: bool = True) -> list[dict]:
    """Parse a JSONL event log (plus rotated generations, oldest first).

    Unparseable lines raise — a torn tail is a real finding, and the
    writer flushes per line, so one should never exist outside a crash.
    """
    p = Path(path)
    paths: list[Path] = []
    if include_rotated:
        i = 1
        gens = []
        while True:
            g = p.with_name(f"{p.name}.{i}")
            if not g.exists():
                break
            gens.append(g)
            i += 1
        paths.extend(reversed(gens))
    if p.exists():
        paths.append(p)
    out: list[dict] = []
    for fp in paths:
        for n, line in enumerate(fp.read_text().splitlines(), 1):
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except ValueError as e:
                raise ValueError(f"{fp}:{n}: unparseable event line: {e}")
    return out


# ---------------------------------------------------------------------------
# Process-global log.  Same torn-read argument as faults._PLAN: installed
# before the workload starts; a reader sees None or a whole EventLog.

_LOG: EventLog | None = None


def configure(path, *, max_bytes: int = 8 << 20,
              keep: int = 2) -> EventLog:
    """Install the process-global event log (returns it)."""
    global _LOG
    if _LOG is not None:
        _LOG.close()
    _LOG = EventLog(path, max_bytes=max_bytes, keep=keep)
    return _LOG


def install_from_env(env: dict | None = None) -> EventLog | None:
    """Honor ``PCTPU_OBS_EVENTS=<path>`` if set (else no-op).  Entry
    points (the CLI, the multi-process job) call this once at start, so
    child processes inherit the timeline through the env."""
    env = os.environ if env is None else env
    path = env.get(EVENTS_ENV, "").strip()
    if not path:
        return None
    return configure(path)


def deconfigure() -> None:
    global _LOG
    if _LOG is not None:
        _LOG.close()
    _LOG = None


def get_log() -> EventLog | None:
    return _LOG


def emit(kind: str, **fields) -> None:
    """Emit to the process-global log — free when none is installed or
    obs is disabled (one load + one test, the fault_point contract)."""
    log = _LOG
    if log is None or not _metrics.enabled():
        return
    log.emit(kind, **fields)


def note_compile(builder: str, backend: str, **fields) -> None:
    """One build of something the port builds once (the JAX package's
    ``step._note_compile``): the ``compile`` event and the
    ``pctpu_compiles_total{builder, backend}`` counter.  What counts: a
    kernel library's nvcc build (``ops/_build.py``), a new K1 launch plan
    (``ops/stencil.py``), a multigrid level program (built once a solve,
    run every cycle).  Under an active span the event carries its ids.
    One branch when obs is off."""
    if not _metrics.enabled():
        return
    from parallel_convolution_tpu_torch.obs import trace

    _metrics.counter(
        "pctpu_compiles_total", "fresh traces/compiles of iteration runners",
        ("builder", "backend")).inc(builder=builder, backend=backend)
    ctx = trace.current()
    emit("compile", builder=builder, backend=backend, **fields,
         **({"trace_id": ctx.trace_id, "span_id": ctx.span_id}
            if ctx is not None else {}))
