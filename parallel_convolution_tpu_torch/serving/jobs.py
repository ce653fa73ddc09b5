"""Durable convergence jobs: the resume-token ledger (the port's own copy
of the JAX package's ``serving/jobs.py``; tokens are the same wire).

Convergence jobs are the longest-running work the service streams.  A
stream that dies mid-run would otherwise restart from iteration 0 and lose
every device-second already spent.

This module is the durability half of the fix.  A :class:`JobLedger`,
keyed on the SAME ``request_id`` identity the replica-side idempotency
dedup uses, records per streamed snapshot row a bounded **resume
token** — the wire-shaped triple the converge stream can be re-seeded
from on any surviving replica:

* ``iters`` / ``work_units`` — how far the job got (chunk/cycle index,
  always a ``check_every`` boundary for jacobi and a V-cycle boundary
  for multigrid, so a resumed run's remaining chunk math is EXACTLY the
  uninterrupted run's — the byte-identity contract);
* ``diff`` — the residual at that point (the stopping rule re-reads it);
* ``state_b64``/``state_shape`` — the float32 field at the valid extent
  (the r5 checkpoint rule applied in memory: crop + zero-re-pad is
  bit-exact on ANY grid, so resume works even onto a replica holding a
  different mesh — ``step.reshard_prepared``'s masking invariant).

Tokens stay WIRE-SHAPED in the ledger (the b64 string a replica row
carried), so the router never decodes image bytes; decoding happens once,
replica-side, in ``frontend.decode_converge``.  The ledger also owns the
**exactly-once final row** rule: :meth:`finalize` returns True for the
first final row of a ``request_id`` and False for every later one (a
resumed stream racing a half-delivered original can never hand the
client two finals), and drops the entry so the token's field bytes are
freed the moment the job completes.

stdlib + numpy only; jax stays inside the replicas.
"""

from __future__ import annotations

import base64
import threading
from collections import OrderedDict

import numpy as np

__all__ = ["JobLedger", "state_from_wire", "state_to_wire",
           "token_from_row", "token_progress"]

# The wire fields one resume token carries (a dict, not a dataclass: it
# rides request bodies and NDJSON rows verbatim).
TOKEN_FIELDS = ("iters", "diff", "work_units", "solver", "state_b64",
                "state_shape")


def state_to_wire(state: np.ndarray) -> tuple[str, list[int]]:
    """(state_b64, state_shape) for a (C, H, W) float32 field — or a
    (F, D, H, W) rank-3 volume; the shape list's length carries rank."""
    arr = np.ascontiguousarray(state, dtype=np.float32)
    return (base64.b64encode(arr.tobytes()).decode("ascii"),
            [int(s) for s in arr.shape])


def state_from_wire(state_b64: str, state_shape) -> np.ndarray:
    """Decode a token's field state; raises ValueError on a malformed
    token (the caller maps it to the typed ``invalid`` rejection)."""
    try:
        shape = tuple(int(s) for s in state_shape)
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad resume state_shape {state_shape!r}") from e
    if len(shape) not in (3, 4) or min(shape) < 1:
        raise ValueError(
            f"resume state must be (C, H, W) or rank-3 (F, D, H, W), "
            f"got {shape}")
    try:
        raw = base64.b64decode(state_b64)
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad resume state_b64: {e}") from e
    want = int(np.prod(shape)) * 4
    if len(raw) != want:
        raise ValueError(
            f"resume state carries {len(raw)} bytes, expected {want} "
            f"for f32 {shape}")
    return np.frombuffer(raw, np.float32).reshape(shape).copy()


def token_from_row(row: dict) -> dict | None:
    """Extract the resume token a wire snapshot row carries (None when
    the row has no state — the replica wasn't asked to carry it, or the
    row is a rejection)."""
    if not row.get("ok") or not row.get("state_b64"):
        return None
    return {
        "iters": int(row.get("iters", 0)),
        "diff": float(row.get("diff", 0.0)),
        "work_units": float(row.get("work_units", 0.0)),
        "solver": str(row.get("solver") or "jacobi"),
        "state_b64": row["state_b64"],
        "state_shape": row.get("state_shape"),
    }


def token_progress(token: dict | None) -> float:
    """Work units a token has already banked (0.0 for no token) — the
    incremental-charge rule's input."""
    if not token:
        return 0.0
    try:
        return max(0.0, float(token.get("work_units", 0.0)))
    except (TypeError, ValueError):
        return 0.0


class _Job:
    __slots__ = ("route_key", "token", "resume_count", "resumed_from")

    def __init__(self, route_key: str):
        self.route_key = route_key
        self.token: dict | None = None
        self.resume_count = 0
        self.resumed_from: list[str] = []


class JobLedger:
    """FIFO-bounded ledger of in-flight convergence jobs, keyed
    ``request_id`` (the same identity the replica dedup uses).

    NOTE the bound is by COUNT: each live token pins one f32 field
    (C×H×W×4 bytes) until the job finalizes or is evicted — size
    ``capacity`` down for large-frame deployments, exactly the
    ``dedup_capacity`` rule on the service side.
    """

    def __init__(self, capacity: int = 64, shard: str | None = None):
        self.capacity = max(1, int(capacity))
        # The shard lineage this ledger serves (None when the
        # router is unsharded) — snapshot attribution only; the ledger
        # itself is per-sub-router and therefore per-shard already.
        self.shard = None if shard is None else str(shard)
        self._jobs: "OrderedDict[str, _Job]" = OrderedDict()
        # rids whose final row already went out (FIFO-bounded, cheap
        # strings): the exactly-once gate outlives the job entry, which
        # finalize drops to free the token's field bytes.
        self._finalized: "OrderedDict[str, bool]" = OrderedDict()
        # rids with a LIVE attached stream (the router pins a job while
        # its rows are flowing): capacity eviction must never take one
        # of these — evicting a mid-stream job silently loses its
        # resume token, turning the next mid-stream death into a
        # restart-from-iteration-0 the client can't explain.  Idle
        # entries (dead stream, awaiting a client retry) stay FIFO
        # evictable; `evicted` counts them (exposed in /stats).
        self._pinned: set[str] = set()
        self.evicted = 0
        self._lock = threading.Lock()

    def _get(self, rid: str, route_key: str | None = None) -> _Job:
        job = self._jobs.get(rid)
        if job is None or (route_key is not None
                           and job.route_key != route_key):
            # A reused request_id naming a DIFFERENT config must start
            # fresh: resuming another job's field into this one would be
            # silent corruption, not durability.
            job = _Job(route_key or "")
            self._jobs[rid] = job
        self._jobs.move_to_end(rid)
        self._evict_locked(keep=rid)
        return job

    def _evict_locked(self, keep: str | None = None) -> None:
        while len(self._jobs) > self.capacity:
            victim = next(
                (k for k in self._jobs
                 if k != keep and k not in self._pinned), None)
            if victim is None:
                # Every entry is mid-stream: the bound goes SOFT rather
                # than a live job going quietly un-resumable (live
                # streams are already bounded by max_progressive).
                break
            self._jobs.pop(victim)
            self.evicted += 1

    def pin(self, rid: str) -> None:
        """Mark ``rid`` as having a live attached stream (eviction-
        immune until :meth:`unpin`)."""
        with self._lock:
            self._pinned.add(rid)

    def unpin(self, rid: str) -> None:
        with self._lock:
            self._pinned.discard(rid)
            self._evict_locked()

    def observe(self, rid: str, route_key: str, row: dict) -> dict | None:
        """Record the newest resume token a snapshot row carries;
        returns it (the router's WAL appends exactly what was kept)."""
        token = token_from_row(row)
        if token is None:
            return None
        with self._lock:
            self._get(rid, route_key).token = token
        return token

    def token(self, rid: str, route_key: str) -> dict | None:
        """The newest token for ``rid`` — None when unknown, or when the
        id was last seen naming a different config."""
        with self._lock:
            job = self._jobs.get(rid)
            if job is None or job.route_key != route_key:
                return None
            return job.token

    def begin(self, rid: str, route_key: str) -> dict | None:
        """Open one converge call for ``rid``: clears any stale
        exactly-once mark (a FRESH submission's final row is legitimate
        even if a previous life of this id finalized — the client only
        retries when it never saw that final) and returns the newest
        token so a client retry after a mid-stream typed retryable row
        RESUMES from where the dead stream got to instead of iteration
        0.  Returns None when the id is unknown or names a different
        config (then the job starts fresh)."""
        with self._lock:
            self._finalized.pop(rid, None)
            job = self._jobs.get(rid)
            if job is None or job.route_key != route_key:
                return None
            return job.token

    def note_resume(self, rid: str, route_key: str,
                    from_replica: str) -> tuple[int, list[str]]:
        """Count one mid-stream resume; returns (resume_count,
        resumed_from) for the router stamp."""
        with self._lock:
            job = self._get(rid, route_key)
            job.resume_count += 1
            job.resumed_from.append(str(from_replica))
            return job.resume_count, list(job.resumed_from)

    def resume_info(self, rid: str) -> tuple[int, list[str]]:
        with self._lock:
            job = self._jobs.get(rid)
            if job is None:
                return 0, []
            return job.resume_count, list(job.resumed_from)

    def finalize(self, rid: str) -> bool:
        """Exactly-once final-row gate: True for the FIRST final row of
        this ``request_id``, False for every later one (a resumed stream
        racing a half-delivered original can never hand the client two
        finals).  The job entry — and its token's field bytes — is
        dropped on the first final; the finalized mark is kept in a
        bounded side set so the gate survives the drop."""
        with self._lock:
            if rid in self._finalized:
                self._finalized.move_to_end(rid)
                return False
            self._finalized[rid] = True
            while len(self._finalized) > 4 * self.capacity:
                self._finalized.popitem(last=False)
            self._jobs.pop(rid, None)
            return True

    def drop(self, rid: str) -> None:
        with self._lock:
            self._jobs.pop(rid, None)
            self._finalized.pop(rid, None)

    def restore(self, jobs: dict, finalized=()) -> int:
        """Seed the ledger from a recovered WAL image:
        ``jobs`` maps lid → ``{key, token, resume_count, resumed_from}``
        (the :class:`~.wal.WALState` shape), ``finalized`` re-arms the
        exactly-once gate across the restart.  Entries beyond capacity
        evict FIFO (counted).  Returns how many jobs were restored."""
        with self._lock:
            for lid, j in jobs.items():
                job = _Job(str(j.get("key", "")))
                job.token = j.get("token")
                job.resume_count = int(j.get("resume_count", 0))
                job.resumed_from = [str(x)
                                    for x in j.get("resumed_from", [])]
                self._jobs[str(lid)] = job
            self._evict_locked()
            for rid in finalized:
                self._finalized[str(rid)] = True
            while len(self._finalized) > 4 * self.capacity:
                self._finalized.popitem(last=False)
            return len(self._jobs)

    def export(self) -> tuple[dict, list[str]]:
        """The ledger's LIVE image in :meth:`restore`'s shape:
        (``jobs`` mapping lid → {key, token, resume_count,
        resumed_from}, ``finalized`` lid list).  The degraded-
        durability re-arm reads this: WAL appends that
        failed during a degraded window never reached the folded
        state, so the re-arm compaction snapshot must be built from
        the structures that kept serving — this ledger — not from the
        journal's stale image."""
        with self._lock:
            jobs = {lid: {"key": j.route_key, "token": j.token,
                          "resume_count": j.resume_count,
                          "resumed_from": list(j.resumed_from)}
                    for lid, j in self._jobs.items()}
            return jobs, list(self._finalized)

    def __len__(self) -> int:
        with self._lock:
            return len(self._jobs)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "jobs": len(self._jobs),
                "capacity": self.capacity,
                **({"shard": self.shard}
                   if self.shard is not None else {}),
                "pinned": len(self._pinned),
                # Live (un-finalized) jobs evicted at capacity — should
                # stay 0 under healthy load; a rising count means the
                # ledger is sized below the idle-retry window.
                "ledger_evicted": self.evicted,
                "resumes": sum(j.resume_count
                               for j in self._jobs.values()),
            }
