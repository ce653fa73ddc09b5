"""Guarded disk IO: storage-shaped failure injection at the port's durable
surfaces (its own copy of the JAX package's ``resilience/diskio.py``: the
checkpoints' :func:`consult`, the result cache's :func:`deferred_consult`
and the write wrappers, the modes and their installation from
``PCTPU_DISK_MODES``, and the injection counts).

The seeded ``PCTPU_FAULTS`` plan (:mod:`.faults`) decides WHEN a disk
surface fails; a per-site **disk mode** map decides WHAT the failure looks
like:

* ``enospc``     — ``OSError(ENOSPC)`` before any byte lands (full disk);
* ``eio``        — ``OSError(EIO)`` (dying device / dead file handle);
* ``torn_write`` — on a surface the caller shapes itself (:func:`consult`)
  an ``EIO``, since a bare consult cannot half-succeed;
* ``slow_write`` — the operation succeeds after a seeded stall.

With no mode installed for a triggered site the raw
:class:`~.faults.InjectedFault` re-raises untranslated.  With no fault
plan installed at all, a consult is one global load and an ``is None``
test.  The router's write-ahead log (``serving/wal.py``), the checkpoints,
the result cache (``serving/cache.py``), the event log (``obs.events``)
and ``utils.evidence_io`` consult their sites here.

Stdlib only.
"""

from __future__ import annotations

import errno
import os
import threading
import time

from parallel_convolution_tpu_torch.resilience.faults import (
    InjectedFault, fault_point,
)

__all__ = ["DISK_SITES", "consult", "deferred_consult", "guarded_fsync",
           "guarded_open", "guarded_replace", "guarded_write",
           "injected_counts", "install_from_env", "install_modes",
           "installed_modes", "modes_from_env", "modes_from_spec",
           "uninstall_modes"]

# site -> the disk failure shapes it can take: the JAX package's table, so
# that every PCTPU_DISK_MODES spec it takes parses here too.
DISK_SITES = {
    "wal_write": ("enospc", "eio", "torn_write", "slow_write"),
    "wal_fsync": ("enospc", "eio", "slow_write"),
    "checkpoint_write_shard": ("enospc", "eio", "torn_write",
                               "slow_write"),
    "checkpoint_write_meta": ("enospc", "eio", "torn_write",
                              "slow_write"),
    "cache_spill": ("enospc", "eio", "torn_write", "slow_write"),
    "cache_promote": ("eio", "slow_write"),
    "events_emit": ("enospc", "eio", "slow_write"),
    "evidence_write": ("enospc", "eio", "torn_write", "slow_write"),
}

# Literal consults of the sites the port reaches: the write-ahead log's
# appends and fsyncs, its checkpoints, the result cache's spill and
# promote, the event log and the shared-evidence writer.
_CONSULTS = {
    "wal_write": lambda: fault_point("wal_write"),
    "wal_fsync": lambda: fault_point("wal_fsync"),
    "checkpoint_write_shard":
        lambda: fault_point("checkpoint_write_shard"),
    "checkpoint_write_meta":
        lambda: fault_point("checkpoint_write_meta"),
    "cache_spill": lambda: fault_point("cache_spill"),
    "cache_promote": lambda: fault_point("cache_promote"),
    "events_emit": lambda: fault_point("events_emit"),
    "evidence_write": lambda: fault_point("evidence_write"),
}

# Mean injected stall for slow_write.
SLOW_WRITE_S = 0.05

# The process-global mode map, installed next to the fault plan and read
# without a lock (the faults._PLAN rule).
_MODES: dict[str, str] = {}
_COUNTS: dict[tuple[str, str], int] = {}   # (site, mode) -> injections
_COUNTS_LOCK = threading.Lock()


def modes_from_spec(spec: str) -> dict[str, str]:
    """Parse ``site=mode,site=mode``; raises ValueError on unknown
    sites/modes so a typo can't silently noop."""
    out: dict[str, str] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise ValueError(
                f"bad disk mode {part!r}: expected site=mode")
        site, mode = (s.strip() for s in part.split("=", 1))
        if site not in DISK_SITES:
            raise ValueError(
                f"unknown disk site {site!r}; known: "
                f"{sorted(DISK_SITES)}")
        if mode not in DISK_SITES[site]:
            raise ValueError(
                f"unknown disk mode {mode!r} for {site}; known: "
                f"{DISK_SITES[site]}")
        out[site] = mode
    return out


def install_modes(modes: dict[str, str] | str | None) -> None:
    """Install the process-global disk-mode map (validated); None or an
    empty spec clears it."""
    global _MODES
    if isinstance(modes, str):
        modes = modes_from_spec(modes)
    if modes:
        bad = [(s, m) for s, m in modes.items()
               if s not in DISK_SITES or m not in DISK_SITES.get(s, ())]
        if bad:
            raise ValueError(f"unknown disk site/mode pair(s) {bad}")
    _MODES = dict(modes or {})


def uninstall_modes() -> None:
    global _MODES
    _MODES = {}


def installed_modes() -> dict[str, str]:
    return dict(_MODES)


def modes_from_env(env: dict | None = None) -> dict[str, str]:
    """``PCTPU_DISK_MODES`` → a validated mode map (empty when unset)."""
    env = os.environ if env is None else env
    spec = (env.get("PCTPU_DISK_MODES") or "").strip()
    return modes_from_spec(spec) if spec else {}


def install_from_env(env: dict | None = None) -> dict[str, str]:
    """Install ``PCTPU_DISK_MODES`` (the CLI calls this at start);
    returns what was installed."""
    modes = modes_from_env(env)
    install_modes(modes)
    return modes


def injected_counts() -> dict[str, int]:
    """``"site=mode" -> count`` of injections actually translated here
    (the raw trigger counts live on the fault plan)."""
    with _COUNTS_LOCK:
        return {f"{s}={m}": n for (s, m), n in sorted(_COUNTS.items())}


def _note(site: str, mode: str) -> None:
    with _COUNTS_LOCK:
        _COUNTS[(site, mode)] = _COUNTS.get((site, mode), 0) + 1
    # Metrics only, no event: the fault plan already emitted the
    # fault_trigger event, and the events_emit site consulting back into
    # the event log is the recursion this avoids.
    from parallel_convolution_tpu_torch.obs import metrics

    if metrics.enabled():
        metrics.counter(
            "pctpu_disk_faults_total",
            "storage-shaped failures injected by resilience.diskio",
            ("site", "mode")).inc(site=site, mode=mode)


def _trigger(site: str) -> str | None:
    """Consult the site; returns the installed disk mode when the plan
    fires (counted), None when it doesn't.  A triggered site with NO
    installed mode re-raises the raw InjectedFault."""
    try:
        _CONSULTS[site]()
        return None
    except InjectedFault:
        mode = _MODES.get(site)
        if mode is None:
            raise
        _note(site, mode)
        return mode


def _raise_mode(site: str, mode: str) -> None:
    if mode == "enospc":
        raise OSError(errno.ENOSPC,
                      f"injected ENOSPC at {site} (disk full)")
    raise OSError(errno.EIO, f"injected EIO at {site} ({mode})")


def consult(site: str) -> None:
    """Bare guard for IO the caller shapes itself: ENOSPC/EIO/torn all
    raise their ``OSError`` here (a torn consult can't half-succeed),
    slow_write stalls then returns."""
    mode = _trigger(site)
    if mode is None:
        return
    if mode == "slow_write":
        time.sleep(SLOW_WRITE_S)
        return
    _raise_mode(site, "eio" if mode == "torn_write" else mode)


def deferred_consult(site: str) -> str | None:
    """Like :func:`consult`, but returns ``"torn_write"`` instead of
    raising it, so the caller lands the torn prefix at its real write site
    (where the reader's CRC check is the thing under test).  Every other
    mode behaves as in :func:`consult`; returns None when nothing fired."""
    mode = _trigger(site)
    if mode is None:
        return None
    if mode == "slow_write":
        time.sleep(SLOW_WRITE_S)
        return None
    if mode == "torn_write":
        return "torn_write"
    _raise_mode(site, mode)


def guarded_write(site: str, fh, data):
    """``fh.write(data)`` under the site's guard.  torn_write lands a
    prefix of the payload and flushes it before raising: the bytes a power
    loss leaves behind, which the reader's CRC / length checks must
    catch."""
    mode = _trigger(site)
    if mode is not None:
        if mode == "slow_write":
            time.sleep(SLOW_WRITE_S)
        elif mode == "torn_write":
            fh.write(data[:max(1, len(data) // 2)])
            fh.flush()
            raise OSError(errno.EIO, f"injected torn write at {site}")
        else:
            _raise_mode(site, mode)
    return fh.write(data)


def guarded_fsync(site: str, fh) -> None:
    """``os.fsync(fh)`` under the site's guard (the record may be written
    but not durable when this fires)."""
    mode = _trigger(site)
    if mode is not None:
        if mode == "slow_write":
            time.sleep(SLOW_WRITE_S)
        else:
            _raise_mode(site, mode)
    os.fsync(fh.fileno() if hasattr(fh, "fileno") else fh)


def guarded_open(site: str, path, mode: str = "r", **kw):
    """``open(path, mode)`` under the site's guard (a failed open is how a
    dead directory or quota surfaces before any byte is written)."""
    m = _trigger(site)
    if m is not None:
        if m == "slow_write":
            time.sleep(SLOW_WRITE_S)
        else:
            _raise_mode(site, "eio" if m == "torn_write" else m)
    return open(path, mode, **kw)


def guarded_replace(site: str, src, dst) -> None:
    """``os.replace(src, dst)`` under the site's guard.  torn_write on a
    rename means the metadata operation died (EIO): a rename is atomic, so
    no half-state is modelled; ``src`` stays."""
    mode = _trigger(site)
    if mode is not None:
        if mode == "slow_write":
            time.sleep(SLOW_WRITE_S)
        else:
            _raise_mode(site, "eio" if mode == "torn_write" else mode)
    os.replace(src, dst)
