"""Write-ahead journal for the router control plane (the port's copy of
the JAX package's ``serving/wal.py``: the same records, byte for byte).

Durable converge jobs survive *replica* loss, but every piece
of control-plane state that makes that work — the ``JobLedger``'s resume
tokens, the exactly-once finalized set, ring membership, tenant debt —
lived in router process memory.  A router crash mid-stream therefore
lost every in-flight job even though the replicas held perfectly good
resume tokens.  This module is the durability substrate that fixes it:
an append-only, CRC-per-record, segment-rotated journal the router
writes BEFORE acting (write-ahead), and replays at startup.

Design points, in the ``obs/events.py`` atomic-rotation discipline:

* **One record per line**: ``<crc32-hex> <compact-json>``.  The CRC is
  over the JSON payload bytes, so a torn write, a flipped bit, or a
  truncated tail is detected per record — never silently replayed.
* **Segment rotation with compaction.**  When the live file would
  exceed ``max_bytes`` it is renamed to ``.1`` (older generations shift
  up, oldest dropped) via ``os.replace``, and the fresh live file BEGINS
  with a ``snapshot`` record holding the full folded state — so dropped
  generations lose nothing.  ``seq`` continues across generations; a
  mid-stream gap is corruption, not rotation.
* **Torn-tail tolerance vs loud quarantine.**  A crash can tear exactly
  one record: the last line of the NEWEST file (the writer flushes per
  record; rotated generations were complete when rotated).  Replay
  tolerates that one torn tail (reported, state = everything before
  it).  Damage anywhere else is :class:`WALCorrupt` with a typed cause
  (``crc`` / ``json`` / ``format`` / ``seq_gap`` / ``unknown_kind``);
  :class:`RouterWAL` then QUARANTINES the damaged files (renamed
  ``*.quarantined``, warned loudly, obs event) and starts empty — the
  epoch fence is re-derived from the replicas' own fences during router
  reconciliation, so even a quarantined WAL cannot mint a zombie.
* **The state machine is shared.**  :meth:`WALState.apply` folds one
  record into the recovered image; the SAME method runs on the live
  append path, so "what replay reconstructs" and "what the writer
  thought it had" cannot drift — the rotation snapshot is just the live
  state serialized.
* **Fault sites** ``wal_write`` / ``wal_fsync``
  (``resilience.faults.SITE_TABLE``): consulted before each append and
  each fsync THROUGH ``resilience.diskio``, so the chaos drills can
  fail durability without failing serving — and the disk
  modes can shape the failure (ENOSPC / EIO / a torn write that lands
  garbage bytes / a slow write that stalls).  A failed append HEALS
  its own tail: partial bytes from the failed record are amputated so
  the next successful append lands on a clean record boundary instead
  of turning a survivable torn tail into mid-log corruption.
* **Degraded-window re-arm** (:meth:`RouterWAL.compact`): appends that
  failed never folded into ``self.state``, so after a degraded window
  the folded image is STALE.  The router re-arms by handing a fresh
  state image built from its LIVE structures; ``compact`` rotates
  immediately so the new generation's head snapshot carries that live
  image and replay can never resurrect the pre-window world.

Record vocabulary (see DESIGN.md "Durable control plane"):

``epoch``        the router's monotonic fencing epoch (takeover bump)
``admit``        one durable converge admission (lid + route key)
``token``        the newest resume token a job's stream row carried
``final``        a job's exactly-once final row went out
``resume``       one mid-stream/client-retry resume (stamp provenance)
``ring_add`` / ``ring_remove``   consistent-hash ring membership
``debt``         a tenant bucket's post-charge/refund level (+ delta)
``cache``        a result-cache eviction/invalidation (op + entry key)
``snapshot``     full folded state (rotation compaction head)

The journal keeps one epoch per SHARD: a :class:`RouterWAL` opened with ``shard="02"`` stamps
``shard`` onto every record it appends, and replay refuses a record
stamped for a different shard (crossed lineage files are loud
corruption, not silent splice).  One router process may own several
lineages — one file per shard, each with its own flock sidecar,
generations, epoch, and quarantine namespace.

stdlib-only, torch-free: the router must be able to recover on a host
with no accelerator attached.
"""

from __future__ import annotations

import contextlib
import errno
import json
import os
import threading
import warnings
import zlib
from pathlib import Path

try:
    import fcntl
except ImportError:  # non-unix: lineage fencing stays inode-only
    fcntl = None

from parallel_convolution_tpu_torch.resilience import diskio

__all__ = ["RECORD_KINDS", "RouterWAL", "WALCorrupt", "WALFenced",
           "WALState", "encode_record", "parse_line", "read_wal"]

RECORD_KINDS = frozenset({
    "epoch", "admit", "token", "final", "resume", "job_settled",
    "ring_add", "ring_remove", "debt", "cache", "snapshot",
})

# Bounds on the folded state so a long-lived WAL cannot grow its
# recovery image without bound (mirrors JobLedger's count-bounded rule;
# the ledger re-bounds to its own capacity on restore anyway).
_JOBS_CAP = 256
_FINALIZED_CAP = 1024
_CACHE_DEAD_CAP = 4096


class WALFenced(RuntimeError):
    """This writer lost the WAL lineage: a takeover rotated the live
    file out from under its fd.  Appending anyway would interleave a
    zombie's records into a journal another router now owns — the
    append REFUSES instead (the router counts it as a durability
    error; replica-side epoch fencing already rejects the zombie's
    actual writes)."""


class WALCorrupt(RuntimeError):
    """Mid-log WAL damage — NOT a torn tail.  Carries a typed ``cause``
    (``crc`` | ``json`` | ``format`` | ``seq_gap`` | ``unknown_kind``)
    so recovery can quarantine with a reason instead of guessing."""

    def __init__(self, cause: str, path, line_no: int, detail: str = ""):
        super().__init__(
            f"WAL corrupt ({cause}) at {path}:{line_no}: {detail}")
        self.cause = cause
        self.path = str(path)
        self.line_no = int(line_no)


def encode_record(rec: dict) -> str:
    """One WAL line: 8-hex-digit CRC32 of the payload bytes, a space,
    the compact sorted-key JSON payload, a newline."""
    payload = json.dumps(rec, separators=(",", ":"), sort_keys=True)
    crc = zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF
    return f"{crc:08x} {payload}\n"


def parse_line(line: str) -> dict:
    """Decode one WAL line; raises :class:`ValueError` whose first
    word is the typed cause (``format`` / ``crc`` / ``json``)."""
    if len(line) < 10 or line[8] != " ":
        raise ValueError("format: not '<crc8> <json>'")
    crc_hex, payload = line[:8], line[9:]
    try:
        want = int(crc_hex, 16)
    except ValueError:
        raise ValueError(f"format: bad crc field {crc_hex!r}") from None
    # surrogateescape: a flipped byte can make the payload invalid
    # UTF-8 — that must surface as a typed CRC mismatch, not as a
    # UnicodeEncodeError escaping the corruption classifier.
    got = zlib.crc32(payload.encode("utf-8", "surrogateescape")) \
        & 0xFFFFFFFF
    if got != want:
        raise ValueError(f"crc: payload crc {got:08x} != recorded "
                         f"{want:08x}")
    try:
        rec = json.loads(payload)
    except ValueError as e:
        # CRC passed but JSON didn't: either a hand-edited file or a
        # collision-grade fluke — either way typed, never silent.
        raise ValueError(f"json: {e}") from None
    if not isinstance(rec, dict):
        raise ValueError("json: record is not an object")
    return rec


class WALState:
    """The folded control-plane image one WAL replay reconstructs."""

    def __init__(self):
        self.epoch = 0
        # lid -> {"key", "token", "resume_count", "resumed_from"}
        self.jobs: dict[str, dict] = {}
        # lids whose final row went out (dict-as-ordered-set, bounded)
        self.finalized: dict[str, bool] = {}
        self.ring: set[str] = set()
        self.ring_ever: set[str] = set()
        self.debts: dict[str, float] = {}
        # Result-cache entry keys journaled dead (evicted/invalidated);
        # dict-as-ordered-set, bounded like ``finalized``.  A cache
        # rebuilt over this state refuses to serve these entries even
        # if their disk-tier bytes survived the crash.
        self.cache_dead: dict[str, bool] = {}

    # -- record folding -------------------------------------------------------
    def _job(self, lid: str, key: str) -> dict:
        job = self.jobs.pop(lid, None)
        if job is None or job["key"] != key:
            job = {"key": key, "token": None, "resume_count": 0,
                   "resumed_from": [], "cost": None, "budget": 0.0,
                   "wu_start": 0.0}
        # Re-insert at the end: every touch (admit/token/resume) is a
        # recency signal, so the cap evicts the STALEST job — an
        # active long-runner whose token records keep arriving can
        # never be evicted ahead of abandoned entries (the JobLedger's
        # own LRU rule, mirrored).
        self.jobs[lid] = job
        while len(self.jobs) > _JOBS_CAP:
            self.jobs.pop(next(iter(self.jobs)))
        return job

    def apply(self, rec: dict) -> None:
        """Fold one record in.  Raises ValueError on an unknown kind or
        a missing field (the read path reports that as corruption)."""
        kind = rec.get("kind")
        if kind == "snapshot":
            self.load_wire(rec["state"])
        elif kind == "epoch":
            self.epoch = max(self.epoch, int(rec["epoch"]))
        elif kind == "admit":
            # A fresh admission re-opens the id (mirrors
            # JobLedger.begin clearing the exactly-once mark) and
            # carries its charge identity (cost / budget / wu_start)
            # so a crash-interrupted job's UNEXECUTED fraction can be
            # refunded at recovery — the incremental-charge rule
            # extended across a router restart.
            self.finalized.pop(rec["lid"], None)
            job = self._job(rec["lid"], rec["key"])
            job["cost"] = rec.get("cost")
            job["budget"] = float(rec.get("budget", 0.0) or 0.0)
            job["wu_start"] = float(rec.get("wu_start", 0.0) or 0.0)
        elif kind == "token":
            self._job(rec["lid"], rec["key"])["token"] = rec["token"]
        elif kind == "final":
            self.jobs.pop(rec["lid"], None)
            self.finalized[rec["lid"]] = True
            while len(self.finalized) > _FINALIZED_CAP:
                self.finalized.pop(next(iter(self.finalized)))
        elif kind == "resume":
            job = self._job(rec["lid"], rec["key"])
            job["resume_count"] += 1
            job["resumed_from"].append(str(rec["from_replica"]))
        elif kind == "job_settled":
            # The job's charge identity is SETTLED — refunded (an
            # exhausted walk or a previous recovery) or deliberately
            # kept (the request's own terminal fault, which stays
            # charged).  Either way a LATER recovery must not
            # reconcile it again; the token stays (the job may still
            # be client-retried).
            job = self.jobs.get(rec["lid"])
            if job is not None:
                job["cost"] = None
        elif kind == "ring_add":
            self.ring.add(rec["name"])
            self.ring_ever.add(rec["name"])
        elif kind == "ring_remove":
            self.ring.discard(rec["name"])
            self.ring_ever.add(rec["name"])
        elif kind == "debt":
            self.debts[str(rec["tenant"])] = float(rec["level"])
        elif kind == "cache":
            # ``op`` is "dead" (evict/invalidate: the entry key must
            # never be served after recovery) or "live" (a re-store of
            # the same key after a later miss re-executed it — lifts
            # the tombstone so the fresh bytes are servable again).
            # "tier_demoted"/"tier_restored" journal the
            # disk tier's degrade-ladder transitions: durable TRACE
            # records, not tombstones — the rebuilt cache re-probes
            # its own disk at startup anyway.  Any other op tombstones
            # conservatively (an unknown future op must not serve).
            op = rec.get("op", "dead")
            ckey = str(rec["ckey"])
            if op in ("tier_demoted", "tier_restored"):
                pass
            elif op == "live":
                self.cache_dead.pop(ckey, None)
            else:
                # Re-insert at the end: recency-ordered so the cap
                # evicts the stalest tombstone first.
                self.cache_dead.pop(ckey, None)
                self.cache_dead[ckey] = True
                while len(self.cache_dead) > _CACHE_DEAD_CAP:
                    self.cache_dead.pop(next(iter(self.cache_dead)))
        else:
            raise ValueError(f"unknown_kind: {kind!r}")

    # -- wire (the snapshot record's body) ------------------------------------
    def to_wire(self) -> dict:
        return {
            "epoch": self.epoch,
            "jobs": {lid: dict(j) for lid, j in self.jobs.items()},
            "finalized": list(self.finalized),
            "ring": sorted(self.ring),
            "ring_ever": sorted(self.ring_ever),
            "debts": dict(self.debts),
            "cache_dead": list(self.cache_dead),
        }

    def load_wire(self, wire: dict) -> None:
        self.epoch = int(wire.get("epoch", 0))
        self.jobs = {str(lid): {
            "key": str(j.get("key", "")),
            "token": j.get("token"),
            "resume_count": int(j.get("resume_count", 0)),
            "resumed_from": [str(x) for x in j.get("resumed_from", [])],
            "cost": j.get("cost"),
            "budget": float(j.get("budget", 0.0) or 0.0),
            "wu_start": float(j.get("wu_start", 0.0) or 0.0),
        } for lid, j in dict(wire.get("jobs") or {}).items()}
        self.finalized = {str(r): True
                          for r in wire.get("finalized") or ()}
        self.ring = {str(n) for n in wire.get("ring") or ()}
        self.ring_ever = {str(n) for n in wire.get("ring_ever") or ()}
        self.debts = {str(t): float(v)
                      for t, v in dict(wire.get("debts") or {}).items()}
        self.cache_dead = {str(k): True
                           for k in wire.get("cache_dead") or ()}


def _generations(path: Path) -> list[Path]:
    """Existing WAL files, oldest first (``.N`` ... ``.1``, then live)."""
    gens = []
    i = 1
    while True:
        g = path.with_name(f"{path.name}.{i}")
        if not g.exists():
            break
        gens.append(g)
        i += 1
    out = list(reversed(gens))
    if path.exists():
        out.append(path)
    return out


def read_wal(path) -> tuple[list[dict], str | None]:
    """Read + validate every record (rotated generations oldest first).

    Returns ``(records, torn_tail)`` where ``torn_tail`` describes the
    one tolerated damaged record — the LAST line of the NEWEST file —
    or None.  Damage anywhere else raises :class:`WALCorrupt` with a
    typed cause: recovery must never silently replay a partial log.
    """
    records, torn, _ = _read_wal_detail(path)
    return records, torn


def _read_wal_detail(path) -> tuple[list[dict], str | None, int]:
    """``read_wal`` plus the LIVE file's valid-prefix byte length —
    :class:`RouterWAL` truncates a torn tail to exactly that length
    before the takeover rotation (otherwise the torn bytes would ride
    into the rotated ``.1`` generation, where the next restart's
    replay would rightly call them MID-log corruption and quarantine
    state the compaction snapshot had perfectly preserved)."""
    p = Path(path)
    files = _generations(p)
    records: list[dict] = []
    prev_seq: int | None = None
    torn: str | None = None
    live_valid_bytes = 0
    for fi, fp in enumerate(files):
        text = fp.read_text(encoding="utf-8", errors="surrogateescape")
        lines = text.split("\n")
        if lines and lines[-1] == "":
            lines.pop()   # the trailing newline of a complete file
        newest = fi == len(files) - 1
        for li, line in enumerate(lines):
            last = newest and li == len(lines) - 1
            try:
                rec = parse_line(line)
                seq = rec.get("seq")
                if not isinstance(seq, int) or seq < 1:
                    raise ValueError(f"format: bad seq {seq!r}")
                if prev_seq is not None and seq != prev_seq + 1:
                    raise ValueError(
                        f"seq_gap: seq {seq} after {prev_seq}")
                if rec.get("kind") not in RECORD_KINDS:
                    raise ValueError(
                        f"unknown_kind: {rec.get('kind')!r}")
            except ValueError as e:
                cause = str(e).split(":", 1)[0]
                if last and cause != "seq_gap":
                    # The one legitimate crash artifact: a torn final
                    # record in the live file.  (A seq GAP on the last
                    # line means earlier records vanished — that is
                    # mid-log damage wearing a tail costume.)
                    torn = f"{fp.name}:{li + 1}: {e}"
                    break
                raise WALCorrupt(cause, fp, li + 1, str(e)) from None
            records.append(rec)
            prev_seq = seq
            if newest:
                live_valid_bytes += len(line.encode(
                    "utf-8", "surrogateescape")) + 1
    return records, torn, live_valid_bytes


class RouterWAL:
    """The router's write-ahead journal (see module docstring).

    Constructing one REPLAYS any existing files at ``path``:
    ``self.state`` is the recovered :class:`WALState` and
    ``self.recovery_report`` says what happened (record count, torn
    tail, quarantine cause).  Appends then continue the sequence.

    ``fsync=True`` (the default) fsyncs after every append — the
    crash-safety contract; drills that only need ordering can turn it
    off.  Append failures raise (``InjectedFault`` from the fault
    sites, or a real ``OSError``); the ROUTER is the layer that decides
    a durability failure must not become a serving outage.
    """

    def __init__(self, path, *, max_bytes: int = 4 << 20, keep: int = 2,
                 fsync: bool = True, shard: str | None = None):
        if max_bytes < 4096:
            raise ValueError("max_bytes must be >= 4096")
        if keep < 1:
            raise ValueError("keep must be >= 1 (rotation relies on the "
                             "snapshot landing in a surviving file)")
        self.path = Path(path)
        # Multi-lineage guard: rotation names generations by appending
        # ``.1``, ``.2``, ... to the LIVE file's name, and
        # ``_generations`` probes the same pattern.  A lineage whose own
        # name ends in ``.<digits>`` (say ``ctl.wal.2`` living next to
        # ``ctl.wal``) would be read as a rotated generation of its
        # SIBLING — silently splicing one shard's records into
        # another's replay.  Refuse the name up front.
        stem, dot, suffix = self.path.name.rpartition(".")
        if dot and stem and suffix.isdigit():
            raise ValueError(
                f"WAL lineage name {self.path.name!r} ends in "
                f"'.{suffix}', which collides with rotated-generation "
                "naming when sibling lineages share the directory; "
                "pick a non-numeric suffix (e.g. 'shard-02.wal')")
        self.shard = None if shard is None else str(shard)
        self.max_bytes = int(max_bytes)
        self.keep = int(keep)
        self.fsync = bool(fsync)
        self._lock = threading.RLock()
        # Sidecar flock serializing append vs takeover ACROSS writers
        # (the inode check alone is a TOCTOU: a zombie's append racing
        # the successor's os.replace could land a stale-seq record in
        # the freshly rotated ``.1``, which the next replay would
        # rightly quarantine as mid-log corruption).  flock is per
        # open-file-description, so two RouterWALs in one process
        # exclude each other too — exactly the in-process drill shape.
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._flock_fh = open(
            self.path.with_name(self.path.name + ".lock"), "a+b")
        self._fh = None
        # The inode of the live file THIS writer owns — the fencing
        # identity.  Survives close(): a closed writer re-acquiring
        # the path after a successor's takeover rotation must fence,
        # not adopt the successor's journal.
        self._owned_ino: int | None = None
        self._size = 0
        self._seq = 0
        self.records_written = 0
        self.tail_heals = 0
        self.state = WALState()
        self.recovery_report: dict = {}
        with self._file_lock():
            self._load()

    @contextlib.contextmanager
    def _file_lock(self):
        """Cross-writer mutual exclusion for the read+truncate+rotate
        takeover sequence and every append's check+write (blocking:
        takeovers and appends are both short)."""
        if self._flock_fh.closed:
            raise WALFenced(
                f"WAL writer for {self.path} is closed; it cannot "
                "append (re-open the lineage to take it over)")
        if fcntl is None:
            yield
            return
        fcntl.flock(self._flock_fh.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(self._flock_fh.fileno(), fcntl.LOCK_UN)

    # -- startup replay -------------------------------------------------------
    def _load(self) -> None:
        try:
            records, torn, live_valid_bytes = _read_wal_detail(
                self.path)
            for rec in records:
                # Per-shard lineage identity: every record this writer
                # appends is stamped with its shard label, and replay
                # refuses a record stamped for a DIFFERENT shard — the
                # on-disk symptom of two lineages' files getting
                # crossed (a mis-rotated generation, a copy/paste
                # restore into the wrong directory).  Legacy records
                # with no stamp are adoptable by any lineage.
                rec_shard = rec.get("shard")
                if (self.shard is not None and rec_shard is not None
                        and str(rec_shard) != self.shard):
                    raise WALCorrupt(
                        "format", self.path, rec.get("seq", 0),
                        f"record stamped for shard {rec_shard!r} in "
                        f"lineage owned by shard {self.shard!r}")
                try:
                    self.state.apply(rec)
                except (KeyError, TypeError, ValueError) as e:
                    # Parsed but un-foldable (a field missing/mistyped):
                    # same verdict as damaged bytes — typed quarantine.
                    raise WALCorrupt("format", self.path, rec.get(
                        "seq", 0), f"unfoldable record: {e}") from None
        except WALCorrupt as e:
            self.state = WALState()
            quarantined = self._quarantine()
            warnings.warn(
                f"router WAL quarantined ({e.cause}): {e} — moved "
                f"{len(quarantined)} file(s) aside as *.quarantined; "
                "recovery starts EMPTY (the epoch fence is re-derived "
                "from the replicas during reconciliation)",
                RuntimeWarning, stacklevel=3)
            self._emit("quarantined", cause=e.cause, detail=str(e)[:300],
                       files=[str(q) for q in quarantined])
            self.recovery_report = {"records": 0, "torn_tail": None,
                                    "quarantined": e.cause,
                                    "detail": str(e)[:300]}
            return
        self._seq = records[-1]["seq"] if records else 0
        self.recovery_report = {"records": len(records),
                                "torn_tail": torn, "quarantined": None}
        if torn is not None:
            warnings.warn(
                f"router WAL torn tail tolerated: {torn} (one record "
                "lost to the crash; replaying the rest)",
                RuntimeWarning, stacklevel=3)
            self._emit("torn_tail", detail=torn[:300])
            # Amputate the torn bytes from the live file before the
            # takeover rotation: tolerance is a property of the LIVE
            # tail, and these bytes are about to stop being one —
            # rotated into ``.1`` they would read as mid-log
            # corruption on the next restart, quarantining state the
            # compaction snapshot had preserved.  Truncating to the
            # valid-prefix length exactly keeps seq contiguity with
            # the snapshot the rotation writes next.
            if self.path.exists():
                with open(self.path, "r+b") as fh:
                    fh.truncate(live_valid_bytes)
        if self.path.exists():
            # TAKEOVER ROTATION: opening an existing lineage rotates it
            # immediately (fresh live file headed by a compaction
            # snapshot).  This is the WAL half of zombie fencing: the
            # previous writer's fd now points at the renamed ``.1``, so
            # its next append fails the per-append inode check
            # (:class:`WALFenced`) instead of interleaving stale
            # records — and it caps startup replay at one generation.
            # Gated on the file EXISTING, not on records surviving: a
            # live file that was nothing but a torn line must still
            # leave the lineage, or the next append would land in a
            # file whose name a future writer will rotate out from
            # under a zombie that was never fenced.
            with self._lock:
                self._ensure_open()
                self._rotate_locked()

    def _quarantine(self) -> list[Path]:
        """Move every generation aside as ``*.quarantined`` (atomic
        renames; a vanished source means a sibling got there first).

        Destinations are made UNIQUE (``.quarantined``,
        ``.quarantined.2``, ...) instead of ``os.replace`` clobbering:
        a second quarantine of the same lineage — or two shard
        lineages sharing a directory after a botched rename — must
        never destroy the forensic evidence of the first."""
        moved = []
        for fp in _generations(self.path):
            dst = fp.with_name(fp.name + ".quarantined")
            n = 1
            while dst.exists():
                n += 1
                dst = fp.with_name(f"{fp.name}.quarantined.{n}")
            try:
                os.replace(fp, dst)
                moved.append(dst)
            except FileNotFoundError:
                pass
        return moved

    @staticmethod
    def _emit(event: str, **fields) -> None:
        from parallel_convolution_tpu_torch.obs import events, metrics

        if metrics.enabled():
            events.emit("wal", event=event, **fields)

    # -- appends --------------------------------------------------------------
    def _ensure_open(self) -> None:
        if self._fh is None:
            if self._owned_ino is not None:
                # REACQUISITION (the fh was closed, or never survived
                # a write): only legal if the live file is still the
                # one WE own — a closed writer must not silently
                # re-acquire a successor's journal (the inode check
                # against a live fd is vacuous when there is no fd).
                try:
                    cur = os.stat(self.path).st_ino
                except OSError:
                    cur = None
                if cur != self._owned_ino:
                    raise WALFenced(
                        f"WAL lineage at {self.path} was taken over by "
                        "another router while this writer was closed; "
                        "it is fenced")
            self._fh = open(self.path, "a", encoding="utf-8")
            self._size = self._fh.tell()
            if self._owned_ino is None:
                self._owned_ino = os.fstat(self._fh.fileno()).st_ino

    def _check_lineage_locked(self) -> None:
        """Refuse to append if a takeover rotated the live file away
        from the inode this writer owns (we would be a zombie writing
        into a journal a newer router now owns)."""
        try:
            same = os.stat(self.path).st_ino == self._owned_ino
        except OSError:
            same = False
        if not same:
            raise WALFenced(
                f"WAL lineage at {self.path} was taken over by another "
                "router (live inode changed); this writer is fenced")

    def _write_locked(self, kind: str, fields: dict,
                      prebuilt: tuple[dict, str] | None = None,
                      torn: bool = False) -> dict:
        """``prebuilt`` is ``(rec, line)`` already encoded for the
        CURRENT seq+1 (the append fast path — one json.dumps per
        record, not two); it is invalid after a rotation bumped the
        seq, so the rotation path passes None and re-encodes.
        ``torn=True`` is the injected torn-write shape: a prefix of the
        record's bytes lands, then EIO — after which the tail heal
        amputates them like any other failed write."""
        if prebuilt is not None and prebuilt[0]["seq"] == self._seq + 1:
            rec, line = prebuilt
        else:
            rec = {"seq": self._seq + 1, "kind": kind, **fields}
            line = encode_record(rec)
        nbytes = len(line.encode("utf-8"))
        start = self._size
        try:
            if torn:
                self._fh.write(line[:max(1, len(line) // 2)])
                self._fh.flush()
                raise OSError(
                    errno.EIO, "injected torn write at wal_write")
            self._fh.write(line)
            self._fh.flush()
        except OSError:
            # A failed write may have landed PARTIAL bytes.  Heal the
            # tail back to the last good record boundary now, while we
            # still know where it is: without this, the next successful
            # append would land after garbage, turning a survivable
            # torn TAIL into mid-log corruption that replay must
            # quarantine.  seq/size/state are untouched — the record
            # was never appended.
            self._heal_tail_locked(start)
            raise
        self._seq += 1
        self._size += nbytes
        self.state.apply(rec)
        self.records_written += 1
        if self.fsync:
            # After flush, before fsync: an fsync failure leaves the
            # record written-but-not-durable — the caller counts it;
            # the sequence stays consistent either way.
            diskio.guarded_fsync("wal_fsync", self._fh)
        return rec

    def _heal_tail_locked(self, valid_bytes: int) -> None:
        """Best-effort amputation of a failed append's partial bytes.
        The fh is dropped first — its buffer may still hold the failed
        record, and a later flush would resurrect those bytes AFTER
        the truncate — then the file is cut back to the last good
        boundary.  If the heal itself fails (the device is truly
        gone), the partial bytes remain: a crash now reads as the one
        tolerated torn tail; a later successful append reads as loud
        quarantine — never a silent replay of garbage."""
        with contextlib.suppress(OSError, ValueError):
            self._fh.close()
        self._fh = None
        try:
            os.truncate(self.path, valid_bytes)
            self.tail_heals += 1
        except OSError:
            pass

    def _rotate_locked(self) -> None:
        self._fh.close()
        self._fh = None
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
            pass
        extra = self.path.with_name(f"{self.path.name}.{self.keep + 1}")
        try:
            extra.unlink()
        except OSError:
            pass
        # Our OWN rotation is a legitimate ownership transfer: the
        # fresh live file's inode becomes the one this writer owns.
        self._owned_ino = None
        self._ensure_open()
        # Compaction head: the fresh live file opens with the FULL
        # folded state, so generations dropped off the end lose nothing.
        snap: dict = {"state": self.state.to_wire()}
        if self.shard is not None:
            snap["shard"] = self.shard
        self._write_locked("snapshot", snap)

    def append(self, kind: str, **fields) -> dict:
        """Append one record (write-ahead: call BEFORE acting on it).
        Returns the record written.  Raises on an unknown kind, an
        injected ``wal_write``/``wal_fsync`` fault (``OSError``-shaped
        when a ``resilience.diskio`` mode is installed, the raw
        ``InjectedFault`` otherwise), or a real I/O error — callers
        decide whether durability failure is fatal."""
        if kind not in RECORD_KINDS:
            raise ValueError(
                f"unknown WAL record kind {kind!r}; known: "
                f"{sorted(RECORD_KINDS)}")
        if self.shard is not None:
            fields.setdefault("shard", self.shard)
        with self._lock, self._file_lock():
            # One consult per append attempt (ENOSPC/EIO raise here,
            # before any byte lands; slow stalls; torn defers to the
            # actual record write below so the garbage hits the tail).
            torn = diskio.deferred_consult("wal_write") == "torn_write"
            self._ensure_open()
            self._check_lineage_locked()
            rec = {"seq": self._seq + 1, "kind": kind, **fields}
            line = encode_record(rec)
            if (self._size + len(line.encode("utf-8")) > self.max_bytes
                    and self._size > 0):
                self._rotate_locked()   # bumps seq: prebuilt invalid
            return self._write_locked(kind, fields,
                                      prebuilt=(rec, line), torn=torn)

    def compact(self, state: WALState | None = None) -> dict:
        """Rotate NOW, heading the fresh live file with a compaction
        snapshot — of ``state`` when given, else the WAL's own folded
        state.  Returns the wire image the snapshot carried.

        This is the degraded-durability RE-ARM entry point: records
        that failed to append during a degraded window never folded
        into ``self.state``, so the folded image is the PRE-window
        world — stale tokens, jobs whose finals already went out.  The
        router passes an image built from its LIVE structures the
        moment a write succeeds again; the degraded-window history
        stays in ``.1``, and replay of the new head can resurrect
        nothing stale."""
        with self._lock, self._file_lock():
            self._ensure_open()
            self._check_lineage_locked()
            if state is not None:
                self.state = state
            self._rotate_locked()
            return self.state.to_wire()

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            self._flock_fh.close()

    def snapshot(self) -> dict:
        """Operator surface (rides the router's ``/stats``)."""
        with self._lock:
            return {
                "path": str(self.path),
                "shard": self.shard,
                "seq": self._seq,
                "records_written": self.records_written,
                "tail_heals": self.tail_heals,
                "size_bytes": self._size,
                "epoch": self.state.epoch,
                "jobs": len(self.state.jobs),
                "recovery": dict(self.recovery_report),
            }
