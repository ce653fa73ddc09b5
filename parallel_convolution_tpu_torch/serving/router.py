"""Replica-set serving: health-routed failover router with tenant QoS.

One :class:`~parallel_convolution_tpu_torch.serving.service.ConvolutionService`
is one engine on one mesh — a single transient fault, reshape, or queue
spike is a full outage.  This module is the front tier that owns N
INDEPENDENT replicas (in-process services for tier-1 and drills, HTTP
services for deployment — one transport protocol, two adapters) and
keeps serving through any single replica's failure, drain, or reshape.

Design points:

* **Consistent-hash routing by compile key.**  Requests hash by their
  compile-identity fields (:func:`route_key` — the ``EngineKey`` string
  proxy a router can compute without a mesh) onto a virtual-node hash
  ring, so each replica's warm-executable cache holds ITS shard of the
  key space instead of every replica compiling everything.  Adding or
  removing one replica remaps only that replica's keys (the classic
  consistent-hashing property, asserted in ``tests/test_torch_router.py``).
* **Bounded-load spill.**  The home replica is skipped — and the next
  ring replica tried — when it is unready (``/readyz`` poll), its
  circuit is open, or it already carries more than ``load_factor×`` its
  fair share of in-flight requests (consistent hashing with bounded
  loads: one hot key cannot melt one replica while others idle).
* **Active + passive health.**  A poll thread hits every replica's
  ``readyz`` (reshape/queue-bound state) on an
  interval; between polls, per-dispatch outcomes feed a per-replica
  :class:`~parallel_convolution_tpu_torch.resilience.breaker.CircuitBreaker`
  (consecutive classified failures open it; half-open probes re-admit).
* **Failover re-submits only idempotent work.**  Convolution/Jacobi
  requests are pure; the router stamps a ``request_id`` so a hedged or
  re-submitted request is DEDUPLICATED at the replica (one device
  execution per id — ``service.submit``'s idempotency ledger) and never
  double-charged against tenant quota (the router charges once, at
  admission).
* **Tenant QoS.**  Per-tenant token buckets (wall-clock refill) admit
  requests before any routing; an exhausted bucket sheds a typed,
  retryable ``Rejected("tenant_quota")`` carrying the exact refill time
  — distinct from the replicas' global ``queue_full`` shedding, so one
  greedy tenant cannot starve another (asserted in tier-1).  Tokens are
  refunded when NO replica did work (shed/unavailable outcomes): quota
  meters work, not misfortune.
* **Progressive results.**  ``converge`` routes a convergence job the
  same way and streams the replica's snapshot rows through (chunked
  HTTP / iterator in-process); a job that dies mid-stream has already
  delivered its best-so-far image + diff trajectory, and the router
  fails over BEFORE the first row but never mid-stream (re-running a
  half-delivered job would duplicate device work the client already
  has).
* **Crash-safe control plane.**  With ``wal=`` armed, every
  admission / newest resume token / finalization / ring change / tenant
  debt level is journaled write-ahead (``serving/wal.py``); constructing
  a router over an existing WAL replays it — jobs resume from their
  newest durable token ACROSS a router restart, the exactly-once final
  gate survives, and a monotonic fencing ``epoch`` (bumped past the WAL's
  and every replica's own fence on each takeover, stamped on every
  router→replica request, ratcheted replica-side) guarantees a zombie
  predecessor is rejected typed ``stale_epoch`` instead of
  double-delivering a final.

stdlib + numpy only; torch stays inside the replicas.
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import json
import threading
import time

from parallel_convolution_tpu_torch.obs import (
    events as obs_events, metrics as obs_metrics, trace as obs_trace,
)
from parallel_convolution_tpu_torch.resilience.breaker import (
    OPEN, CircuitBreaker,
)
from parallel_convolution_tpu_torch.serving import frames as frames_mod
from parallel_convolution_tpu_torch.serving.frontend import (
    InProcessClient, drain_body, send_frames, send_frames_stream,
    send_json, send_ndjson_stream,
)
from parallel_convolution_tpu_torch.serving.jobs import JobLedger, token_progress
from parallel_convolution_tpu_torch.serving.service import ReleasingStream

__all__ = [
    "CorruptReplicaBody", "HTTPReplica", "HashRing", "InProcessReplica",
    "ReplicaRouter", "TenantQuotas", "TokenBucket",
    "make_router_http_server", "route_key",
]


class CorruptReplicaBody(ConnectionError):
    """A replica answered with bytes that do not parse as the protocol
    (corrupt/truncated JSON).  A ``ConnectionError`` subclass ON
    PURPOSE: ``resilience.retry.classify`` already calls that transient,
    so the breaker/failover machinery treats a corrupting replica
    exactly like a dead one — it must never escape the router as an
    uncaught ``JSONDecodeError``.  The distinct type feeds the
    per-replica ``corrupt_responses`` counter (``/stats``)."""


# -- compile-key routing ------------------------------------------------------

# Every wire field that lands in the replica's EngineKey (the compile
# identity).  Image CONTENT is deliberately absent: equal configs share
# one warm runner, so they must share one home replica.  col_mode,
# solver and mg_levels land in the EngineKey too, and the warm-placement observatory replays exactly these fields, so a
# field missing here would make a joining replica pre-warm the WRONG
# program for requests that set it.
ROUTE_KEY_FIELDS = ("rows", "cols", "mode", "filter", "iters", "backend",
                    "storage", "fuse", "boundary", "quantize", "overlap",
                    "tile", "check_every", "col_mode", "solver",
                    "mg_levels")


def route_key(body: dict) -> str:
    """The consistent-hash key of one wire request: a canonical string
    of its compile-identity fields (the ``EngineKey`` proxy)."""
    return "|".join(f"{k}={body.get(k)!r}" for k in ROUTE_KEY_FIELDS)


class HashRing:
    """Consistent-hash ring with virtual nodes.

    ``candidates(key)`` returns every member exactly once, in ring order
    from the key's point — index 0 is the HOME replica, the rest the
    spill/failover order.  Membership changes remap only the touched
    member's keys.
    """

    def __init__(self, names=(), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes >= 1 required")
        self.vnodes = int(vnodes)
        self._names: set[str] = set()
        # (points, owners, distinct-member count) swapped as ONE tuple
        # so a concurrent reader (the dispatch path, while the
        # autoscaler joins/leaves a member) can never see a half-rebuilt
        # table; the count rides along so the hot path stays O(1) on it.
        self._table: tuple[tuple[int, ...], tuple[str, ...], int] = (
            (), (), 0)
        self._mutate = threading.Lock()
        for n in names:
            self.add(n)

    @staticmethod
    def _hash(s: str) -> int:
        return int(hashlib.sha1(s.encode()).hexdigest()[:16], 16)

    def _rebuild(self) -> None:
        pairs = sorted(
            (self._hash(f"{name}#{i}"), name)
            for name in self._names for i in range(self.vnodes))
        self._table = (tuple(p for p, _ in pairs),
                       tuple(n for _, n in pairs),
                       len(self._names))

    def add(self, name: str) -> None:
        with self._mutate:
            self._names.add(str(name))
            self._rebuild()

    def remove(self, name: str) -> None:
        with self._mutate:
            self._names.discard(str(name))
            self._rebuild()

    def members(self) -> list[str]:
        with self._mutate:
            return sorted(self._names)

    def candidates(self, key: str) -> list[str]:
        """All members in ring order from ``key``'s point (home first)."""
        points, owners, distinct = self._table
        if not points:
            return []
        out: list[str] = []
        seen: set[str] = set()
        start = bisect.bisect_left(points, self._hash(key))
        n = len(owners)
        for i in range(n):
            owner = owners[(start + i) % n]
            if owner not in seen:
                seen.add(owner)
                out.append(owner)
                if len(seen) == distinct:
                    break
        return out


# -- tenant QoS ---------------------------------------------------------------

class TokenBucket:
    """Wall-clock-refilled token bucket (``rate`` tokens/s, ``burst``
    capacity).  ``rate <= 0`` means unlimited."""

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        self.rate = float(rate)
        # Burst must only be POSITIVE, not >= 1: under cost-priced
        # admission a bucket's unit is predicted device-seconds, and a
        # tenant's whole budget can legitimately be a fraction of one —
        # the old 1.0 floor silently re-minted such buckets 30x larger
        # (caught live by the greedy-tenant drill).
        self.burst = max(1e-9, float(burst))
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        if self.rate > 0:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, n: float = 1.0, journal=None) -> tuple[bool, float]:
        """(granted, retry_after_s).  On refusal, ``retry_after_s`` is the
        exact wall time until the bucket can grant ``n`` again.

        A charge larger than the burst is granted once the bucket is
        FULL and drives the balance NEGATIVE (debt): with cost-priced
        admission one legitimate big job can cost more than the burst,
        and refusing it forever would make ``burst`` a silent per-job
        size cap instead of a smoothing window.  The debt refills at
        ``rate`` like any other deficit, so long-run fairness is
        untouched — the tenant just waits out its own big job.

        ``journal`` (the WAL hook) is called with the POST-charge
        balance UNDER this bucket's lock on a successful take: the
        journaled level is atomic with the balance change and
        same-tenant journal order equals charge order — a level read
        outside the lock could race a concurrent take and journal a
        stale balance that recovery would faithfully re-mint."""
        if self.rate <= 0:
            return True, 0.0
        need = min(float(n), self.burst)
        with self._lock:
            now = self._clock()
            self._refill(now)
            if self._tokens >= need:
                self._tokens -= float(n)
                if journal is not None:
                    journal(self._tokens)
                return True, 0.0
            return False, (need - self._tokens) / self.rate

    def refund(self, n: float = 1.0, journal=None) -> None:
        if self.rate <= 0:
            return
        with self._lock:
            self._tokens = min(self.burst, self._tokens + n)
            if journal is not None:
                journal(self._tokens)

    def absorb(self, delta: float) -> None:
        """Apply a PEER's replicated charge (+) or refund (−) to this
        bucket (fleet-wide quotas): the local balance moves by
        ``delta`` with the usual burst ceiling, but no journal hook runs
        — a replicated delta must never be re-journaled or re-replicated
        (echo), and debt below zero is legal exactly as in
        :meth:`try_take`."""
        if self.rate <= 0:
            return
        with self._lock:
            self._refill(self._clock())
            self._tokens = min(self.burst, self._tokens - float(delta))

    def level(self) -> float:
        with self._lock:
            self._refill(self._clock())
            return self._tokens

    def set_level(self, level: float) -> None:
        """Restore the balance to an absolute level (WAL recovery:
        the journal records post-charge levels, and a restarted router
        must not re-mint a drained tenant a full bucket).  Refill
        resumes from NOW — downtime refill is deliberately forfeited
        (conservative: a recovering control plane under-grants)."""
        if self.rate <= 0:
            return
        with self._lock:
            self._tokens = min(self.burst, float(level))
            self._last = self._clock()


class TenantQuotas:
    """Per-tenant admission buckets: one :class:`TokenBucket` per tenant
    (created on first sight, FIFO-bounded), all sharing a default
    (rate, burst) unless ``overrides[tenant] = (rate, burst)`` says
    otherwise.  Isolation is the point: tenant A's bucket emptying can
    never affect tenant B's — only the replicas' GLOBAL queue bound can,
    and that sheds a differently-typed reason."""

    def __init__(self, rate: float, burst: float, overrides=None,
                 max_tenants: int = 1024, clock=time.monotonic):
        from collections import OrderedDict

        self.rate, self.burst = float(rate), float(burst)
        self.overrides = dict(overrides or {})
        self.max_tenants = int(max_tenants)
        self._clock = clock
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self._lock = threading.Lock()

    def bucket(self, tenant: str) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(tenant)
            if b is not None:
                self._buckets.move_to_end(tenant)   # LRU touch
                return b
            rate, burst = self.overrides.get(
                tenant, (self.rate, self.burst))
            b = TokenBucket(rate, burst, clock=self._clock)
            self._buckets[tenant] = b
            while len(self._buckets) > self.max_tenants:
                # Evict a FULL (idle, refilled) bucket when one exists:
                # evicting by age alone would let a drained tenant reset
                # its own quota by churning throwaway names until its
                # empty bucket ages out.  Churned fresh buckets are full,
                # so churn evicts churn, never a draining tenant.
                victim = next(
                    (t for t, bk in self._buckets.items()
                     if t != tenant and bk.level() >= bk.burst), None)
                if victim is None:
                    victim = next(t for t in self._buckets if t != tenant)
                self._buckets.pop(victim)
            return b

    def take(self, tenant: str, n: float = 1.0,
             journal=None) -> tuple[bool, float]:
        """Charge ``n`` work units (cost-priced admission passes the
        request's predicted device-seconds; the legacy request-count
        scheme is the degenerate ``n=1``).  ``journal`` rides through
        to the bucket (called with the post-charge balance under its
        lock)."""
        return self.bucket(tenant).try_take(n, journal=journal)

    def refund(self, tenant: str, n: float = 1.0, journal=None) -> None:
        self.bucket(tenant).refund(n, journal=journal)

    def absorb(self, tenant: str, delta: float) -> None:
        """Apply a peer's replicated debt delta (no journal, no echo —
        see :meth:`TokenBucket.absorb`)."""
        self.bucket(tenant).absorb(delta)

    def restore_level(self, tenant: str, level: float) -> None:
        """WAL-recovery seeding: set a tenant's balance to the level
        the journal last recorded for it."""
        self.bucket(tenant).set_level(level)

    def snapshot(self) -> dict:
        with self._lock:
            return {t: round(b.level(), 3) for t, b in self._buckets.items()}


# -- replica transports -------------------------------------------------------

class InProcessReplica:
    """One in-process service replica with kill/revive for drills.

    ``factory`` builds a fresh ``ConvolutionService`` (its own mesh, its
    own engine) — called at construction and on every :meth:`revive`.
    :meth:`kill` drains and closes the live service; requests against a
    killed replica raise ``ConnectionError`` exactly like a dead host,
    which is what the router's breaker/failover machinery keys on.
    """

    def __init__(self, factory, name: str = "r0"):
        self._factory = factory
        self.name = str(name)
        self._lock = threading.Lock()
        self.service = None
        self.client = None
        self.revive()

    def _live(self) -> InProcessClient:
        client = self.client
        if client is None:
            raise ConnectionError(f"replica {self.name} is down")
        return client

    def request(self, body: dict, timeout: float | None = None,
                traceparent: str | None = None):
        raw = body.get("_frames_raw")
        if raw is not None:
            # The router forwarded the client's frame bytes OPAQUELY;
            # the in-process boundary is where "the replica decodes"
            # happens (the one CRC walk).  The response comes back
            # framed and is split so the router can stamp its header
            # without touching the tensor bytes.
            header = {k: v for k, v in body.items() if k != "_frames_raw"}
            status, data = self._live().request_frames(
                frames_mod.join_envelope(header, raw), timeout=timeout,
                traceparent=traceparent)
            wire, out_raw = frames_mod.split_envelope(data)
            wire["_frames_raw"] = bytes(out_raw)
            return status, wire
        return self._live().request(body, timeout=timeout,
                                    traceparent=traceparent)

    def converge(self, body: dict, timeout: float | None = None,
                 traceparent: str | None = None):
        status, rows = self._live().converge(body, timeout=timeout,
                                             traceparent=traceparent)
        if status != 200:
            return status, rows

        def guarded():
            # A killed process's chunked stream BREAKS — emulate that
            # faithfully (without this, an in-process drill's kill would
            # leave the already-attached generator silently computing on
            # the closed service, and mid-stream failover would never be
            # exercised the way a real host death exercises it).
            for row in rows:
                if self.client is None:
                    raise ConnectionError(
                        f"replica {self.name} died mid-stream")
                yield row

        return status, guarded()

    def readyz(self):
        return self._live().readyz()

    def warm(self, configs) -> tuple[int, dict]:
        """Pre-compile declared configs on the live service (the
        warm-placement surface the autoscaler drives BEFORE ring join)."""
        return self._live().warm(configs)

    def fence(self, epoch: int, shard=None) -> tuple[int, dict]:
        """Ratchet the replica's router-epoch fence (takeover
        propagation; ``shard`` scopes the sweep to one lineage's
        ratchet)."""
        return self._live().fence(epoch, shard=shard)

    def snapshot(self) -> dict:
        return self._live().stats()[1]

    def kill(self) -> None:
        """Take the replica down (drains in-flight work first — admitted
        requests are idempotent and complete; NEW requests raise)."""
        with self._lock:
            svc, self.service, self.client = self.service, None, None
        if svc is not None:
            svc.close()

    def revive(self) -> None:
        from parallel_convolution_tpu_torch.serving.frontend import (
            InProcessClient as _Client,
        )

        with self._lock:
            if self.service is None:
                self.service = self._factory()
                self.client = _Client(self.service)

    def close(self) -> None:
        self.kill()


class HTTPReplica:
    """One HTTP service replica (``python -m parallel_convolution_tpu_torch.serving.serve``).  Transport
    failures surface as ``ConnectionError`` so the breaker classifies
    them transient; typed HTTP rejections pass through as (status, body).
    """

    def __init__(self, url: str, name: str | None = None,
                 timeout: float = 60.0, probe_timeout: float = 2.0):
        self.base = url.rstrip("/")
        self.name = name or self.base
        self.timeout = timeout
        # Health probes get their OWN short budget: the poll loop sweeps
        # replicas serially, so one black-holing host must cost it ~2 s,
        # not the request timeout.
        self.probe_timeout = min(probe_timeout, timeout)

    def _post(self, path: str, body: dict, timeout, traceparent):
        import urllib.error
        import urllib.request

        raw = body.get("_frames_raw")
        if raw is not None:
            # Opaque binary forwarding: re-wrap the router-stamped
            # header around the client's UNTOUCHED frame bytes (no
            # decode, no CRC walk — integrity is the replica's check).
            header = {k: v for k, v in body.items() if k != "_frames_raw"}
            data = frames_mod.join_envelope(header, raw)
            ctype = frames_mod.FRAMES_CONTENT_TYPE
        else:
            data = json.dumps(body).encode()
            ctype = "application/json"
        headers = {"Content-Type": ctype}
        if traceparent:
            headers["traceparent"] = traceparent
        req = urllib.request.Request(
            f"{self.base}{path}", data=data, headers=headers)
        try:
            return urllib.request.urlopen(
                req, timeout=timeout or self.timeout)
        except urllib.error.HTTPError as e:
            return e   # carries .status/.code + readable body
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise ConnectionError(
                f"replica {self.name} unreachable: {e}") from e

    def request(self, body: dict, timeout: float | None = None,
                traceparent: str | None = None):
        resp = self._post("/v1/convolve", body, timeout, traceparent)
        with resp if hasattr(resp, "__enter__") else _closing(resp) as r:
            status = getattr(r, "status", None) or r.code
            ctype = (r.headers.get("Content-Type") or "").split(
                ";")[0].strip().lower()
            payload = r.read()
            if ctype == frames_mod.FRAMES_CONTENT_TYPE:
                try:
                    wire, out_raw = frames_mod.split_envelope(payload)
                except frames_mod.BadFrame as e:
                    raise CorruptReplicaBody(
                        f"replica {self.name} sent unparseable envelope "
                        f"(http {status}): {e}") from e
                wire["_frames_raw"] = bytes(out_raw)
                return status, wire
            try:
                return status, json.loads(payload)
            except ValueError as e:
                raise CorruptReplicaBody(
                    f"replica {self.name} sent unparseable body "
                    f"(http {status}): {e}") from e

    def converge(self, body: dict, timeout: float | None = None,
                 traceparent: str | None = None):
        resp = self._post("/v1/converge", body, timeout, traceparent)
        status = getattr(resp, "status", None) or resp.code
        if status != 200:
            with resp if hasattr(resp, "__enter__") else _closing(resp) as r:
                try:
                    return status, iter([json.loads(r.read())])
                except ValueError:
                    return status, iter([{"ok": False, "kind": "rejected",
                                          "rejected": "error",
                                          "detail": f"http {status}"}])

        def rows():
            try:
                with resp:
                    for line in resp:   # http.client de-chunks for us
                        line = line.strip()
                        if line:
                            try:
                                yield json.loads(line)
                            except ValueError as e:
                                # Corrupt NDJSON line: typed transport
                                # failure, flagged so the router's
                                # corrupt_responses counter sees it.
                                yield {"ok": False, "kind": "rejected",
                                       "rejected": "replica_unavailable",
                                       "retryable": True, "corrupt": True,
                                       "detail": "stream corrupt: "
                                                 f"{e}"[:300]}
                                return
            except OSError as e:
                # TRANSPORT death, not a typed execution failure: the
                # job itself may be fine elsewhere, so the row is
                # retryable — unlike a replica-typed `error` row, which
                # passes through retryable:false (RETRYABLE_REJECTS).
                yield {"ok": False, "kind": "rejected",
                       "rejected": "replica_unavailable",
                       "retryable": True,
                       "detail": f"stream broke: {e}"[:300]}

        return 200, rows()

    def _get(self, path: str, timeout: float | None = None):
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(f"{self.base}{path}",
                                        timeout=timeout or self.timeout) as r:
                try:
                    return r.status, json.loads(r.read())
                except ValueError as ve:
                    raise CorruptReplicaBody(
                        f"replica {self.name} sent unparseable body "
                        f"({path}): {ve}") from ve
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read())
            except Exception:  # noqa: BLE001
                return e.code, {"ok": False}
        except CorruptReplicaBody:
            # Already typed — it must not be re-wrapped by the generic
            # OSError handler below (CorruptReplicaBody IS an OSError).
            raise
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise ConnectionError(
                f"replica {self.name} unreachable: {e}") from e

    def readyz(self):
        return self._get("/readyz", timeout=self.probe_timeout)

    def _post_json(self, path: str, body: dict, timeout):
        """POST + parse-or-typed-fallback (shared by the non-routing
        control surfaces: warm, fence)."""
        resp = self._post(path, body, timeout, None)
        with resp if hasattr(resp, "__enter__") else _closing(resp) as r:
            status = getattr(r, "status", None) or r.code
            try:
                return status, json.loads(r.read())
            except ValueError:
                return status, {"ok": False, "detail": f"http {status}"}

    def warm(self, configs) -> tuple[int, dict]:
        """POST /v1/warm — pre-compile declared configs (warm placement
        over the wire; compiles can take a while, so no probe budget)."""
        return self._post_json("/v1/warm",
                               {"configs": list(configs or ())}, None)

    def fence(self, epoch: int, shard=None) -> tuple[int, dict]:
        """POST /v1/fence — ratchet the replica's router-epoch fence
        (short probe budget: fencing is a takeover-path sweep and one
        black-holing host must not stall it).  ``shard`` scopes the
        sweep to one lineage's ratchet."""
        body: dict = {"epoch": int(epoch)}
        if shard is not None:
            body["shard"] = str(shard)
        return self._post_json("/v1/fence", body, self.probe_timeout)

    def snapshot(self) -> dict:
        return self._get("/stats")[1]

    def close(self) -> None:
        pass


class _closing:
    """Context manager over urllib HTTPError responses (no __enter__)."""

    def __init__(self, obj):
        self.obj = obj

    def __enter__(self):
        return self.obj

    def __exit__(self, *exc):
        close = getattr(self.obj, "close", None)
        if close is not None:
            close()
        return False


# -- the router ---------------------------------------------------------------

class _ReplicaState:
    """Router-side record of one replica: transport + health + load."""

    __slots__ = ("name", "transport", "breaker", "ready", "ready_payload",
                 "in_flight", "stats")

    def __init__(self, transport, breaker: CircuitBreaker):
        self.name = transport.name
        self.transport = transport
        self.breaker = breaker
        self.ready = True          # optimistic until the first poll
        self.ready_payload: dict = {}
        self.in_flight = 0
        # resumes counts durable converge jobs that resumed ONTO this
        # replica; mid_stream_failovers counts streams that died ON it
        # after rows flowed; corrupt_responses counts unparseable bodies
        # it sent (CorruptReplicaBody / corrupt stream rows) — the
        # operator-debuggable chaos-drill surface, exposed in /stats
        # next to the autoscaler inputs.
        self.stats = {"routed": 0, "completed": 0, "sheds": 0,
                      "failures": 0, "resumes": 0,
                      "mid_stream_failovers": 0, "corrupt_responses": 0}


# Rejections that mean "no device work happened anywhere" — the tenant's
# token is refunded for these (quota meters work, not misfortune).
_REFUND_REJECTS = frozenset(
    {"queue_full", "resharding", "replica_unavailable"})
# Replica sheds the router SPILLS past (the replica is healthy but
# transiently unable) vs failures it FAILS OVER from (breaker food).
_SPILL_REJECTS = frozenset({"queue_full", "resharding"})


class ReplicaRouter:
    """The replica-set front tier (see module docstring).

    ``replicas`` are transports (:class:`InProcessReplica` /
    :class:`HTTPReplica`) with unique ``.name``s.  ``quotas`` is an
    optional :class:`TenantQuotas`.  ``hedge_s`` (off by default) fires
    ONE extra attempt at the next ring candidate when the home replica
    hasn't answered within the budget — first result wins, the loser's
    work is absorbed by the replica-side request_id dedup when both
    landed on the same replica (cross-replica hedges genuinely duplicate
    work; that is the standard tail-latency trade).
    """

    def __init__(self, replicas, *, quotas: TenantQuotas | None = None,
                 pricer=None,
                 vnodes: int = 64, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 poll_interval_s: float = 0.25, load_factor: float = 2.0,
                 hedge_s: float | None = None, start_health: bool = True,
                 durable: bool = True, job_capacity: int = 64,
                 wal=None, clock=time.monotonic,
                 shard: str | None = None, on_debt=None):
        if not replicas:
            raise ValueError("at least one replica required")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        self._clock = clock
        self.breaker_threshold = int(breaker_threshold)
        self._replicas = {
            r.name: _ReplicaState(
                r, CircuitBreaker(breaker_threshold, breaker_cooldown_s,
                                  clock=clock))
            for r in replicas}
        self.ring = HashRing(names, vnodes=vnodes)
        self.quotas = quotas
        # Cost-priced admission (serving.pricing.WorkPricer): when armed,
        # tenant buckets are charged the request's predicted
        # device-seconds instead of 1 — an 8192² multigrid job pays its
        # real price and a thumbnail blur stays almost free.
        self.pricer = pricer
        self.load_factor = float(load_factor)
        self.hedge_s = hedge_s
        self.poll_interval_s = float(poll_interval_s)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        # The key-config observatory: route_key -> the wire CONFIG fields
        # last seen for it (never image content).  This is the warm-
        # placement input — a JOINING replica pre-warms exactly the
        # configs whose consistent-hash home it is about to become
        # (shard_configs), before its vnodes enter the ring.  Bounded
        # FIFO; batch-path configs only (a converge job's warm state is
        # its chunk/level programs, which the first job re-warms).
        from collections import OrderedDict

        self._key_configs: "OrderedDict[str, dict]" = OrderedDict()
        self._key_configs_cap = 512
        # Durable convergence jobs: the resume-token ledger.
        # With durable=True (the default) every converge body is asked
        # to carry per-row token state, mid-stream deaths fail over to
        # the surviving ring candidates seeded from the newest token,
        # and the final row is exactly-once per request_id.
        self.durable = bool(durable)
        self.jobs = JobLedger(capacity=job_capacity,
                              shard=None if shard is None
                              else str(shard))
        self.stats = obs_metrics.MirroredStats(obs_metrics.gauge(
            "pctpu_router_stats", "replica-router admission/outcome counters",
            ("key",)), initial={
            "routed": 0, "completed": 0, "failovers": 0, "spills": 0,
            "hedges": 0, "rejected_tenant_quota": 0,
            "rejected_unavailable": 0, "progressive": 0, "resumes": 0,
            "mid_stream_failovers": 0, "wal_records": 0,
            "wal_write_errors": 0, "wal_degraded_windows": 0,
            "wal_rearms": 0,
        })
        # Crash-safe control plane: a write-ahead journal of
        # admissions / newest resume tokens / finals / ring membership /
        # tenant debt, replayed at construction — constructing a router
        # over an existing WAL IS the takeover.  ``self.epoch`` is the
        # fencing epoch: monotonic per WAL lineage, stamped on every
        # router→replica request, ratcheted replica-side, so a zombie
        # predecessor is rejected (``stale_epoch``) everywhere.  With
        # no WAL the epoch stays 0 and nothing is stamped (fencing is a
        # property of the durable deployment).
        self.wal = None
        self.epoch = 0
        # Durability degrade ladder: ``wal_degrade_threshold``
        # CONSECUTIVE append failures flip the router into a
        # ``durability: degraded`` window — it keeps serving (the
        # rule: durability failure is never an outage), stamps the
        # window on every ``router:`` block, and the first append that
        # succeeds again triggers a RE-ARM: a compaction snapshot built
        # from the LIVE structures (job ledger, ring, quotas), because
        # the WAL's own folded state missed everything that happened
        # during the window — replaying it would resurrect stale bytes.
        self.wal_degrade_threshold = 3
        self._wal_fail_streak = 0
        self._durability_degraded = False
        self._rearming = False
        self._wal_need_rearm = False
        # Sharded control plane: when this router owns one
        # shard of a partitioned ring, ``shard`` is its label — stamped
        # on every outbound body (``router_shard``) so replica-side
        # fencing is per-shard, and on every ``router:`` block so
        # traces attribute a request to the shard that served it.
        # ``map_version`` is the owning ShardRouter's shard-map version
        # (bumped on ownership change; 0 when unsharded).  ``on_debt``
        # is the peer-replication hook: called (tenant, delta) after
        # every quota charge/refund so a peer layer can replicate
        # tenant debt fleet-wide.
        self.shard = None if shard is None else str(shard)
        self.map_version = 0
        self.on_debt = on_debt
        if wal is not None:
            from parallel_convolution_tpu_torch.serving.wal import RouterWAL

            self.wal = (wal if isinstance(wal, RouterWAL)
                        else RouterWAL(wal, shard=self.shard))
            self._recover()
        self._closed = threading.Event()
        self._poll_thread: threading.Thread | None = None
        if start_health:
            self.start_health()

    # -- crash recovery -------------------------------------------------------
    def _wal_append(self, kind: str, **fields) -> None:
        """One WAL record, never fatal: a durability failure (disk
        full, injected ``wal_write``/``wal_fsync`` fault) is a LOUD
        counter + event, not a serving outage — the stream keeps
        flowing and recovery falls back to the newest record that DID
        land (an older boundary: more recompute, same bytes).

        The degrade LADDER sits on top: a failure streak of
        ``wal_degrade_threshold`` flips the ``durability: degraded``
        window (stamped, evented, gauged); the first success after a
        window re-arms with a live-state compaction snapshot."""
        if self.wal is None:
            return
        try:
            self.wal.append(kind, **fields)
        except Exception as e:  # noqa: BLE001 — durability degrades loudly
            self._bump("wal_write_errors")
            with self._lock:
                self._wal_fail_streak += 1
                degraded_now = (
                    not self._durability_degraded
                    and self._wal_fail_streak
                    >= self.wal_degrade_threshold)
                if degraded_now:
                    self._durability_degraded = True
                    self.stats["wal_degraded_windows"] += 1
            if obs_metrics.enabled():
                obs_metrics.counter(
                    "pctpu_wal_append_errors_total",
                    "router WAL appends that failed (durability "
                    "degraded; serving unaffected)", ("kind",)).inc(
                    kind=kind)
                obs_events.emit("wal", event="append_failed",
                                record_kind=kind, error=repr(e)[:200])
                if degraded_now:
                    obs_metrics.gauge(
                        "pctpu_wal_durability_degraded",
                        "1 while the router serves inside a degraded-"
                        "durability window (sustained WAL append "
                        "failure), 0 when armed").set(1)
                    obs_events.emit(
                        "wal", event="durability_degraded",
                        streak=self._wal_fail_streak,
                        record_kind=kind)
        else:
            self._bump("wal_records")
            with self._lock:
                self._wal_fail_streak = 0
                # The heal signal only SETS a flag: this append may be
                # running under a quota-bucket or ledger lock (the debt
                # journal hook), and the re-arm's compaction snapshot
                # re-reads those very structures — re-arming inline
                # here deadlocks.  The serving paths drain the flag at
                # their next lock-free point (_maybe_rearm).
                if self._durability_degraded and not self._rearming:
                    self._wal_need_rearm = True

    def _maybe_rearm(self) -> None:
        """Drain a pending re-arm at a point where the caller holds no
        quota/ledger locks (request admission, the converge row loop).
        A failed re-arm keeps the window open; the next healthy append
        re-raises the flag."""
        if not self._wal_need_rearm:
            return
        with self._lock:
            if not self._wal_need_rearm:
                return
            self._wal_need_rearm = False
        self._rearm_wal()

    def _live_state_image(self):
        """A :class:`~.wal.WALState` built from the structures that
        KEPT SERVING through a degraded window — the job ledger, the
        live ring, the quota buckets, the current epoch — merged with
        the folded state's charge identities and cache tombstones.
        This is what the re-arm compaction snapshot carries: the
        journal's own folded image is the pre-window world and
        replaying it would resurrect stale tokens and un-finalized
        jobs whose finals already went out."""
        from parallel_convolution_tpu_torch.serving.wal import WALState

        state = WALState()
        state.epoch = self.epoch
        jobs, finalized = self.jobs.export()
        old = self.wal.state
        for lid, job in jobs.items():
            prior = old.jobs.get(lid)
            # Charge identity (cost/budget/wu_start) rides only the
            # WAL admit record, so the folded copy is its one source;
            # a job admitted DURING the window never journaled one and
            # stays refund-less across a later crash (documented
            # trade-off — the window was loud).
            if prior is not None and prior.get("key") == job["key"]:
                for k in ("cost", "budget", "wu_start"):
                    job[k] = prior.get(k)
        state.jobs = jobs
        state.finalized = {lid: True for lid in finalized}
        state.ring = set(self.ring.members())
        state.ring_ever = set(old.ring_ever) | state.ring
        # Cache tombstones: keep the folded set — deaths journaled
        # during the window were lost, but the cache's own CRC + the
        # journaled-transition rule mean a stale ENTRY can still never
        # serve stale BYTES (DESIGN.md "Storage fault domains").
        state.cache_dead = dict(old.cache_dead)
        if self.quotas is not None:
            state.debts = {t: float(lvl)
                           for t, lvl in self.quotas.snapshot().items()}
        else:
            state.debts = dict(old.debts)
        return state

    def _rearm_wal(self) -> None:
        """Leave the degraded window: rotate the WAL behind a
        compaction snapshot of the LIVE state.  Failure keeps the
        window open (the heal was premature); success flips the stamp
        back to ``ok`` and counts a re-arm."""
        with self._lock:
            if not self._durability_degraded or self._rearming:
                return
            self._rearming = True
        try:
            image = self._live_state_image()
            self.wal.compact(image)
        except Exception as e:  # noqa: BLE001 — still degraded
            if obs_metrics.enabled():
                obs_events.emit("wal", event="rearm_failed",
                                error=repr(e)[:200])
            return
        finally:
            with self._lock:
                self._rearming = False
        with self._lock:
            self._durability_degraded = False
            self.stats["wal_rearms"] += 1
        if obs_metrics.enabled():
            obs_metrics.gauge(
                "pctpu_wal_durability_degraded",
                "1 while the router serves inside a degraded-"
                "durability window (sustained WAL append failure), "
                "0 when armed").set(0)
            obs_events.emit("wal", event="durability_rearmed",
                            jobs=len(self.jobs), epoch=self.epoch)

    def _refund(self, tenant: str, amount: float) -> None:
        """Quota refund + its WAL debt record (one path; the journal
        hook runs UNDER the bucket's lock so the recorded level is
        atomic with the balance change and same-tenant record order
        equals operation order — recovery's last-level-wins replay
        depends on both)."""
        if self.quotas is None or amount <= 0:
            return
        self.quotas.refund(
            tenant, amount,
            journal=(None if self.wal is None else (
                lambda lvl: self._wal_append(
                    "debt", tenant=tenant, delta=round(-amount, 9),
                    level=round(lvl, 9)))))
        self._debt_hook(tenant, -amount)

    def _recover(self) -> None:
        """Startup recovery: fold the WAL into live state, reconcile
        against the replicas (``/readyz`` + ``/stats``), bump the
        fencing epoch past everything ever seen, and propagate it.

        Invariants (DESIGN.md "Durable control plane"):

        1. the new epoch is strictly greater than the WAL's AND every
           reachable replica's fence — so even when the WAL was
           quarantined (or lost) a zombie predecessor cannot win;
        2. jobs resume from their newest DURABLE token (the ledger is
           seeded; the client's retry of the typed mid-stream row picks
           the token up via ``begin`` exactly like an in-process
           failover) and the exactly-once final gate survives the
           restart;
        3. ring membership replays: a member the WAL saw removed stays
           out; a provided transport the WAL never met joins normally;
           a recovered member with NO transport in this pool is dropped
           loudly (it cannot be dispatched to);
        4. tenant buckets restore to their journaled post-charge levels
           (refill resumes from now — recovery under-grants, never
           re-mints a drained tenant).
        """
        state = self.wal.state
        wal_epoch = state.epoch   # pre-bump (the epoch append below
        #                           folds into the same state object)
        report = dict(self.wal.recovery_report)
        # (2) durable jobs + the exactly-once gate.
        restored = self.jobs.restore(state.jobs, state.finalized)
        # (3) ring reconciliation.
        provided = set(self._replicas)
        dropped_members = sorted(state.ring - provided)
        removed = []
        for name in sorted(provided):
            if name in state.ring_ever and name not in state.ring:
                self.ring.remove(name)
                removed.append(name)
        if not self.ring.members():
            # Replay would leave an EMPTY ring (e.g. the only provided
            # transports are ones the WAL saw scale-removed): a router
            # that can route nothing is a silent total outage wearing
            # a clean boot line.  Re-seat every provided replica,
            # loudly — the operator pointed this pool at this WAL on
            # purpose.
            import warnings

            warnings.warn(
                "WAL recovery: ring replay removed every provided "
                f"replica ({removed}); re-seating all of "
                f"{sorted(provided)} rather than booting an "
                "unroutable router", RuntimeWarning, stacklevel=3)
            removed = []
            for name in sorted(provided):
                self.ring.add(name)
                self._wal_append("ring_add", name=name)
        # (4) tenant debt: restore journaled levels, then refund the
        # UNEXECUTED fraction of every crash-interrupted priced job
        # (its charge identity rides the admit record) — the
        # incremental-charge rule across a restart: the client's retry
        # re-charges only the remaining work, so die-takeover-resume-
        # complete still costs one uninterrupted job.
        refunded = {}
        if self.quotas is not None:
            for tenant, level in state.debts.items():
                self.quotas.restore_level(tenant, level)
            for lid, job in list(state.jobs.items()):
                cost = job.get("cost")
                if not cost:
                    continue
                budget = float(job.get("budget") or 0.0)
                wu_start = float(job.get("wu_start") or 0.0)
                wu_done = max(wu_start, token_progress(job.get("token")))
                denom = max(budget - wu_start, 1e-9)
                frac = max(0.0, min(1.0, (budget - wu_done) / denom))
                amount = float(cost) * frac
                if amount <= 0:
                    continue
                tenant = lid.split("\x1f", 1)[0]
                self._refund(tenant, amount)
                self._wal_append("job_settled", lid=lid)
                refunded[lid] = round(amount, 6)
        # (1) the fencing epoch: reconcile against every replica's own
        # fence (its /stats carries fence_epoch), then go one past.
        max_fence = 0
        reachable = []
        for name, rep in self._replicas.items():
            try:
                status, _ = rep.transport.readyz()
                snap = rep.transport.snapshot()
                if self.shard is not None:
                    # Per-shard fences: read THIS shard's
                    # ratchet; the scalar fence_epoch is the unsharded
                    # lineage's and would under- or over-fence here.
                    fences = snap.get("fence_epochs") or {}
                    rep_fence = int(fences.get(self.shard, 0) or 0)
                else:
                    rep_fence = int(snap.get("fence_epoch", 0) or 0)
                max_fence = max(max_fence, rep_fence)
                reachable.append(name)
            except Exception:  # noqa: BLE001 — a dead replica
                continue
        self.epoch = max(wal_epoch, max_fence) + 1
        self._wal_append("epoch", epoch=self.epoch)
        if not state.ring_ever:
            # A fresh WAL: journal the boot membership so the first
            # restart replays it instead of inferring it.
            for name in self.ring.members():
                self._wal_append("ring_add", name=name)
        fenced = []
        for name in reachable:
            fence = getattr(self._replicas[name].transport, "fence",
                            None)
            if fence is None:
                continue
            try:
                if self.shard is not None:
                    fence(self.epoch, shard=self.shard)
                else:
                    fence(self.epoch)
                fenced.append(name)
            except Exception:  # noqa: BLE001 — ratchets on first request
                continue
        self.recovery = {
            **({"shard": self.shard} if self.shard is not None else {}),
            "epoch": self.epoch, "wal_epoch": wal_epoch,
            "max_replica_fence": max_fence, "jobs_restored": restored,
            "finalized_restored": len(state.finalized),
            "ring_removed": removed, "dropped_members": dropped_members,
            "tenants_restored": sorted(state.debts),
            "refunded_jobs": refunded,
            "fenced": fenced, **report,
        }
        if dropped_members:
            import warnings

            warnings.warn(
                f"WAL recovery: ring members {dropped_members} have no "
                "transport in this pool — dropped from the recovered "
                "ring (their keys remap to the surviving members)",
                RuntimeWarning, stacklevel=3)
        if obs_metrics.enabled():
            obs_metrics.counter(
                "pctpu_wal_recoveries_total",
                "router WAL recoveries performed at startup").inc()
            obs_events.emit("wal", event="recovered", **{
                k: v for k, v in self.recovery.items()
                if k != "detail"})

    # -- health ---------------------------------------------------------------
    def start_health(self) -> None:
        if self._poll_thread is None or not self._poll_thread.is_alive():
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="pctpu-router-health",
                daemon=True)
            self._poll_thread.start()

    def _poll_loop(self) -> None:
        while not self._closed.wait(self.poll_interval_s):
            self.poll_once()

    def poll_once(self) -> None:
        """One active-health sweep: every replica's ``readyz``."""
        for rep in self._replicas.values():
            try:
                status, payload = rep.transport.readyz()
                ready, payload = status == 200, payload
            except Exception as e:  # noqa: BLE001 — a dead replica
                ready, payload = False, {"error": repr(e)[:200]}
            if ready != rep.ready and obs_metrics.enabled():
                obs_events.emit("router", event="replica_ready",
                                replica=rep.name, ready=ready)
                obs_metrics.counter(
                    "pctpu_router_ready_flips_total",
                    "replica ready-state transitions observed by the "
                    "health poll", ("replica",)).inc(replica=rep.name)
            rep.ready, rep.ready_payload = ready, payload

    # -- admission ------------------------------------------------------------
    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.stats[key] += n

    def _stamp(self, **fields) -> dict:
        """One ``router:`` response block: the given fields plus the
        fencing epoch and (when sharded) the shard label + shard-map
        version — the trace/attribution identity of the router life
        that served the request."""
        fields["epoch"] = self.epoch
        if self.wal is not None:
            # Degraded-durability honesty: every response
            # and NDJSON row served inside a degraded window says so —
            # a client that cares about crash-safety can tell these
            # results were produced while the journal was dark.
            fields["durability"] = ("degraded" if self._durability_degraded
                                    else "ok")
        if self.shard is not None:
            fields["shard"] = self.shard
            fields["map_version"] = self.map_version
        return fields

    def _debt_hook(self, tenant: str, delta: float) -> None:
        """Peer-replication fan-out for one quota charge/refund (the
        ``on_debt`` callback; errors are the peer layer's problem and
        must never fail admission)."""
        if self.on_debt is None:
            return
        try:
            self.on_debt(tenant, float(delta))
        except Exception:  # noqa: BLE001 — replication is best-effort
            pass

    def _tenant_admit(self, tenant: str, rid: str, trace_id: str,
                      cost: float = 1.0):
        """None when admitted; the (status, wire) shed otherwise.
        ``cost`` is the work-unit charge (predicted device-seconds with
        a pricer armed; 1.0 in the legacy request-count scheme)."""
        if self.quotas is None:
            return None
        # The journal hook records the post-charge level UNDER the
        # bucket's lock (a restarted router must not re-mint a drained
        # tenant a full bucket, and a level read outside the lock
        # could journal a stale balance under concurrency).
        ok, retry_after = self.quotas.take(
            tenant, cost,
            journal=(None if self.wal is None else (
                lambda lvl: self._wal_append(
                    "debt", tenant=tenant, delta=round(cost, 9),
                    level=round(lvl, 9)))))
        if ok:
            self._debt_hook(tenant, cost)
            if self.pricer is not None and obs_metrics.enabled():
                obs_metrics.counter(
                    "pctpu_router_work_units_total",
                    "work units (predicted device-seconds) charged at "
                    "admission", ("tenant",)).inc(cost, tenant=tenant)
            return None
        self._bump("rejected_tenant_quota")
        if obs_metrics.enabled():
            obs_metrics.counter(
                "pctpu_router_tenant_quota_total",
                "tenant-bucket admission sheds", ("tenant",)).inc(
                tenant=tenant)
            obs_events.emit("router", event="tenant_quota", tenant=tenant,
                            request_id=rid, cost_units=round(cost, 6),
                            retry_after_s=round(retry_after, 4))
        return 429, {
            "ok": False, "rejected": "tenant_quota", "retryable": True,
            "retry_after_s": round(retry_after, 4), "tenant": tenant,
            "cost_units": round(cost, 6),
            "request_id": rid, "trace_id": trace_id,
            "detail": f"tenant {tenant!r} bucket empty; refills at "
                      f"{self.quotas.bucket(tenant).rate}/s "
                      f"(this request costs {cost:.4g} units)",
        }

    def _observe_config(self, key: str, body: dict) -> None:
        """Record a route_key's wire CONFIG (warm-placement input)."""
        cfg = {k: body[k] for k in ROUTE_KEY_FIELDS if k in body}
        with self._lock:
            self._key_configs[key] = cfg
            self._key_configs.move_to_end(key)
            while len(self._key_configs) > self._key_configs_cap:
                self._key_configs.popitem(last=False)

    # -- dispatch -------------------------------------------------------------
    def _load_bound(self) -> int:
        """Bounded-load cap: ``load_factor ×`` the fair in-flight share,
        floored at ``load_factor`` — at near-zero total in-flight the
        fair share rounds to 1, and spilling the SECOND concurrent
        request for a key off its home would trade a duplicate compile
        on another replica for no protection at all (the cap exists for
        sustained overload, not a cold-start burst)."""
        live = [r for r in self._replicas.values()
                if r.ready and r.breaker.state() != OPEN]
        n_live = max(1, len(live))
        total = sum(r.in_flight for r in self._replicas.values())
        fair = self.load_factor * (total + 1) / n_live
        return max(1, int(self.load_factor + 0.999), int(fair + 0.999))

    def _record_counter(self, replica: str, outcome: str) -> None:
        if obs_metrics.enabled():
            obs_metrics.counter(
                "pctpu_router_requests_total",
                "routed dispatch outcomes per replica",
                ("replica", "outcome")).inc(replica=replica, outcome=outcome)

    def _try_one(self, rep: _ReplicaState, body: dict, timeout,
                 traceparent):
        """One dispatch to one replica.

        Returns ``("ok", status, wire)``, ``("shed", status, wire)``
        (typed retryable — spill past it), or ``("fail", status, wire)``
        / ``("fail", None, None)`` (breaker food — fail over).
        """
        with self._lock:
            rep.in_flight += 1
            rep.stats["routed"] += 1
        try:
            status, wire = rep.transport.request(
                body, timeout=timeout, traceparent=traceparent)
        except Exception as e:  # noqa: BLE001 — transport death
            rep.breaker.record_failure(e)
            with self._lock:
                rep.stats["failures"] += 1
                if isinstance(e, CorruptReplicaBody):
                    rep.stats["corrupt_responses"] += 1
            self._record_counter(rep.name, "transport_error")
            if obs_metrics.enabled():
                obs_events.emit("router", event="failover",
                                replica=rep.name, error=repr(e)[:200],
                                request_id=body.get("request_id", ""))
            return "fail", None, {"detail": repr(e)[:200]}
        finally:
            with self._lock:
                rep.in_flight -= 1
        reason = wire.get("rejected")
        if status == 200 and wire.get("ok"):
            rep.breaker.record_success()
            with self._lock:
                rep.stats["completed"] += 1
            self._record_counter(rep.name, "completed")
            return "ok", status, wire
        if reason in _SPILL_REJECTS:
            # The replica is healthy, just transiently unable: not
            # breaker food, but do try the next ring candidate.
            rep.breaker.record_success()
            with self._lock:
                rep.stats["sheds"] += 1
            self._record_counter(rep.name, f"shed_{reason}")
            return "shed", status, wire
        if reason == "error" or status >= 500:
            # A typed terminal execution failure (or an untyped 5xx) IS
            # a replica-health signal — and the work is idempotent, so
            # failing over is always safe.
            rep.breaker.record_failure()
            with self._lock:
                rep.stats["failures"] += 1
            self._record_counter(rep.name, "error")
            return "fail", status, wire
        # invalid / deadline / tenant-level outcomes: the request's own
        # story; pass through verbatim.
        rep.breaker.record_success()
        self._record_counter(rep.name, reason or "other")
        return "ok", status, wire

    def _dispatch(self, key: str, body: dict, timeout, sp,
                  offset: int = 0):
        """The candidate walk: home replica, then ring order.

        Pass 1 honors readiness + bounded load; pass 2 (only if pass 1
        dispatched nothing) ignores them — when EVERY replica looks
        unready, trying one beats returning unavailable unexamined.
        ``offset`` rotates the walk's starting point (a hedge starts at
        the NEXT ring candidate — re-walking from the home would just
        dedup into the slow attempt it is meant to race).
        """
        order = self.ring.candidates(key)
        home = order[0] if order else ""
        if offset and order:
            off = offset % len(order)
            order = order[off:] + order[:off]
        meta = self._stamp(home=home, replica="", attempts=0,
                           failovers=0, spills=0)
        last_shed = last_fail = None
        tp = (obs_trace.format_traceparent(sp.context)
              if sp.context is not None else None)
        dispatched_any = False
        for relaxed in (False, True):
            if relaxed and dispatched_any:
                break
            bound = self._load_bound()
            for name in order:
                rep = self._replicas.get(name)
                if rep is None:   # removed while this walk was underway
                    continue
                if not relaxed:
                    if not rep.ready or rep.in_flight >= bound:
                        meta["spills"] += 1
                        self._bump("spills")
                        continue
                if not rep.breaker.allow():
                    meta["spills"] += 1
                    self._bump("spills")
                    continue
                dispatched_any = True
                meta["attempts"] += 1
                verdict, status, wire = self._try_one(rep, body, timeout, tp)
                if verdict == "ok":
                    meta["replica"] = name
                    if name != home:
                        sp.set(spilled=True)
                    return status, wire, meta
                if verdict == "shed":
                    last_shed = (status, wire, name)
                    meta["spills"] += 1
                    self._bump("spills")
                else:
                    last_fail = (status, wire, name)
                    meta["failovers"] += 1
                    self._bump("failovers")
        if last_shed is not None:
            status, wire, name = last_shed
            meta["replica"] = name
            return status, wire, meta
        if last_fail is not None and last_fail[0] is not None:
            status, wire, name = last_fail
            meta["replica"] = name
            return status, wire, meta
        self._bump("rejected_unavailable")
        return 503, {
            "ok": False, "rejected": "replica_unavailable",
            "retryable": True,
            "retry_after_s": round(self.breaker_cooldown_s, 4),
            "request_id": body.get("request_id", ""),
            "detail": f"no live replica among {len(order)} "
                      f"({meta['failovers']} failed, {meta['spills']} "
                      "skipped)",
        }, meta

    # -- the public request path ---------------------------------------------
    def request(self, body: dict, timeout: float | None = None,
                tenant: str | None = None):
        """Route one wire-format request; returns ``(status, wire)``.

        The response carries a ``router`` stamp: the serving replica,
        the home replica, and the attempt/failover/spill counts — which
        is how ``loadgen`` observes failovers without server logs.
        """
        body = dict(body)
        rid = body.get("request_id") or f"rt{next(self._ids)}"
        body["request_id"] = rid
        tenant = str(tenant or body.get("tenant") or "default")
        body["tenant"] = tenant
        if self.epoch:
            # The fencing stamp: replicas ratchet on it and
            # reject anything older — a zombie router cannot write.
            body["router_epoch"] = self.epoch
        if self.shard is not None:
            # Scope the replica-side fence to THIS shard's
            # ratchet — fencing shard A's zombie must not reject the
            # same process's live ownership of shard B.
            body["router_shard"] = self.shard
        self._bump("routed")
        cost = (self.pricer.price(body)
                if self.pricer is not None else 1.0)
        # Which wire arm this request rides — stamped on the route span
        # and the response, so a trace/loadgen run can segment its
        # latency curves by codec.
        wire_arm = "frames" if "_frames_raw" in body else "json"
        with obs_trace.span("route", request_id=rid, tenant=tenant,
                            wire=wire_arm,
                            **({"shard": self.shard,
                                "map_version": self.map_version}
                               if self.shard is not None else {})) as sp:
            tid = sp.context.trace_id if sp.context is not None else ""
            shed = self._tenant_admit(tenant, rid, tid, cost)
            if shed is not None:
                sp.set(outcome="tenant_quota")
                status, wire = shed
                wire["wire"] = wire_arm
                wire["router"] = self._stamp(
                    home="", replica="", attempts=0, failovers=0,
                    spills=0)
                return status, wire
            # Admission's debt record may just have healed a degraded
            # window; the bucket lock is released now, so the re-arm
            # can run — this very response then stamps ``ok``.
            self._maybe_rearm()
            key = route_key(body)
            self._observe_config(key, body)
            sp.set(key=key)
            if self.hedge_s is not None:
                status, wire, meta = self._dispatch_hedged(
                    key, body, timeout, sp)
            else:
                status, wire, meta = self._dispatch(key, body, timeout, sp)
            sp.set(outcome=wire.get("rejected", "completed"),
                   replica=meta.get("replica", ""),
                   failovers=meta.get("failovers", 0))
            if status == 200 and wire.get("ok"):
                self._bump("completed")
                if (self.quotas is not None and self.pricer is not None
                        and wire.get("cache") == "hit"):
                    # The replica served this from its content-addressed
                    # result cache: no device ran.  Settle the admission
                    # charge down to the hit floor (pricing.hit_units) —
                    # the router cannot know at admission time, so it
                    # refunds the difference once the response says so.
                    over = cost - self.pricer.hit_units()
                    if over > 0:
                        self._refund(tenant, over)
            elif (self.quotas is not None
                  and wire.get("rejected") in _REFUND_REJECTS):
                # Refund the SAME charge admission took: with a pricer
                # armed that is the request's work units, not 1.
                self._refund(tenant, cost)
            wire.setdefault("wire", wire_arm)
            wire.setdefault("router", meta)
            if self.pricer is not None:
                wire["router"].setdefault("cost_units", round(cost, 6))
            return status, wire

    def _dispatch_hedged(self, key: str, body: dict, timeout, sp):
        """Tail-latency hedging: fire the normal dispatch, and if it has
        not resolved within ``hedge_s``, fire ONE more full dispatch
        concurrently (same request_id → the replica-side idempotency
        ledger absorbs a same-replica duplicate).  First result wins."""
        results: list = []
        done = threading.Condition()

        def attempt(offset: int = 0):
            r = self._dispatch(key, body, timeout, sp, offset=offset)
            with done:
                results.append(r)
                done.notify_all()

        t1 = threading.Thread(target=attempt, daemon=True)
        t1.start()
        with done:
            done.wait(self.hedge_s)
            if not results:
                self._bump("hedges")
                if obs_metrics.enabled():
                    obs_events.emit(
                        "router", event="hedge",
                        request_id=body.get("request_id", ""))
                # The hedge starts one ring position past the home: the
                # whole point is a DIFFERENT replica than the slow
                # attempt (same-replica hedges just dedup into it).
                threading.Thread(target=attempt, args=(1,),
                                 daemon=True).start()
            while not results:
                done.wait(1.0)
            # Prefer a 200 if both landed; else the first verdict.
            for r in results:
                if r[0] == 200 and r[1].get("ok"):
                    return r
            return results[0]

    # -- progressive ----------------------------------------------------------
    def _converge_cost(self, body: dict) -> float:
        """The admission charge for one converge job: with a pricer
        armed, the predicted device-seconds of the REMAINING work — a
        resumed job (body carries a token) is charged only for the
        budget the token hasn't spent (the refund rule, extended:
        work already done was charged in the job's previous life)."""
        if self.pricer is None:
            return 1.0
        done = token_progress(body.get("resume"))
        if done > 0:
            total = float(body.get("max_iters", 500) or 500)
            remaining = max(1, int(total - done))
            return self.pricer.price(dict(body, max_iters=remaining),
                                     converge=True)
        return self.pricer.price(body, converge=True)

    def _converge_walk(self, key: str, body: dict, timeout, tp,
                       tried: set):
        """Walk ring candidates not yet ``tried`` with this job.

        Returns ``("stream", rep, rows)`` on an attached 200 stream
        (the replica's in-flight count already bumped), ``("pass",
        status, wire)`` for a request's-own-fault typed outcome
        (invalid/deadline/tenant — pass through verbatim), or
        ``("reject", status, wire)`` when the walk exhausted (typed
        retryable).  Pass 1 honors readiness + bounded load; pass 2
        relaxes them only if pass 1 dispatched nothing — replicas
        already in ``tried`` (they failed or shed THIS job) are never
        re-submitted.
        """
        rid = body.get("request_id", "")
        order = [n for n in self.ring.candidates(key) if n not in tried]
        last = None
        dispatched_any = False
        for relaxed in (False, True):
            if relaxed and dispatched_any:
                break
            bound = self._load_bound()
            for name in order:
                if name in tried:
                    continue
                rep = self._replicas.get(name)
                if rep is None:   # removed mid-walk
                    continue
                if not relaxed and (not rep.ready
                                    or rep.in_flight >= bound):
                    self._bump("spills")
                    continue
                if not rep.breaker.allow():
                    self._bump("spills")
                    continue
                dispatched_any = True
                try:
                    status, rows = rep.transport.converge(
                        body, timeout=timeout, traceparent=tp)
                except Exception as e:  # noqa: BLE001
                    rep.breaker.record_failure(e)
                    tried.add(name)
                    self._bump("failovers")
                    self._record_counter(rep.name, "transport_error")
                    with self._lock:
                        rep.stats["failures"] += 1
                        if isinstance(e, CorruptReplicaBody):
                            rep.stats["corrupt_responses"] += 1
                    last = (503, {
                        "kind": "rejected", "ok": False,
                        "rejected": "replica_unavailable",
                        "retryable": True, "request_id": rid,
                        "retry_after_s": round(self.breaker_cooldown_s, 4),
                        "detail": repr(e)[:200]})
                    continue
                if status != 200:
                    first = list(rows)[:1]
                    wire = first[0] if first else {"ok": False}
                    reason = wire.get("rejected")
                    if reason in _SPILL_REJECTS:
                        rep.breaker.record_success()
                        self._bump("spills")
                        last = (status, wire)
                        continue
                    if reason == "error" or status >= 500:
                        rep.breaker.record_failure()
                        tried.add(name)
                        self._bump("failovers")
                        with self._lock:
                            rep.stats["failures"] += 1
                        last = (status, wire)
                        continue
                    # invalid / deadline / tenant-level outcomes: the
                    # request's own fault — no ring walk helps, and it
                    # is NOT replica-health evidence (same taxonomy as
                    # `_try_one`).
                    rep.breaker.record_success()
                    return "pass", status, wire
                rep.breaker.record_success()
                self._record_counter(rep.name, "progressive")
                # The stream counts against the replica's in-flight
                # load for its WHOLE lifetime (progressive jobs are the
                # longest-running work in the system — invisible to
                # bounded-load spill, they'd pile onto one replica).
                with self._lock:
                    rep.in_flight += 1
                    rep.stats["routed"] += 1
                return "stream", rep, rows
        if last is not None:
            return "reject", last[0], last[1]
        self._bump("rejected_unavailable")
        return "reject", 503, {
            "kind": "rejected", "ok": False,
            "rejected": "replica_unavailable", "retryable": True,
            "retry_after_s": round(self.breaker_cooldown_s, 4),
            "request_id": rid,
            "detail": f"no live replica among "
                      f"{len(order)} candidates"}

    def converge(self, body: dict, timeout: float | None = None,
                 tenant: str | None = None):
        """Route one progressive convergence job; ``(status, rows)``.

        Durable jobs: with ``durable=True`` every snapshot
        row the replica streams carries a bounded resume token (state
        recorded in the router's :class:`~..serving.jobs.JobLedger`,
        STRIPPED from the rows the client sees), and a mid-stream death
        — transport break, typed ``error`` row, untyped 5xx — after
        rows have flowed FAILS OVER to the remaining ring candidates
        seeded from the newest token: the job continues on a surviving
        replica from its last ``check_every``/V-cycle boundary instead
        of ending the stream.  Rows after a resume stamp ``router:
        {resumed_from, resume_count}``; the final row is exactly-once
        per ``request_id`` (ledger-gated).  Only when NO candidate
        remains does the stream end with the typed retryable row, and
        the tenant is refunded the UNEXECUTED fraction of the admission
        charge (quota meters work).  A client retry of that typed row
        (same ``request_id``) resumes from the ledger's token — and is
        admission-charged only for the remaining work.
        """
        body = dict(body)
        rid = body.get("request_id") or f"rt{next(self._ids)}"
        body["request_id"] = rid
        tenant = str(tenant or body.get("tenant") or "default")
        body["tenant"] = tenant
        if self.epoch:
            body["router_epoch"] = self.epoch
        if self.shard is not None:
            body["router_shard"] = self.shard
        self._bump("routed")
        self._bump("progressive")
        key = route_key(body)
        # The ledger identity is TENANT-SCOPED: request_id is
        # client-stamped, and route_key carries neither tenant nor image
        # content — without the scope, tenant B reusing tenant A's id on
        # a same-config job would be seeded from A's private field state.
        lid = f"{tenant}\x1f{rid}"
        ledger_seeded = False
        if self.durable:
            # Ask replicas for per-row token state; seed a client retry
            # from the ledger's newest token (explicit body tokens win).
            body["resume_state"] = True
            if "resume" not in body:
                token = self.jobs.begin(lid, key)
                if token is not None and not self._token_fits(token,
                                                              body):
                    # The retry changed the budget/cadence such that the
                    # token's boundary is no longer legal (e.g. raising
                    # max_iters past the old budget's short final
                    # chunk): start fresh rather than fail the job
                    # terminally 'invalid' on a token the CLIENT never
                    # supplied.
                    token = None
                if token is not None:
                    body["resume"] = token
                    ledger_seeded = True
        cost = self._converge_cost(body)
        with obs_trace.span("route", request_id=rid, tenant=tenant,
                            progressive=True,
                            **({"shard": self.shard,
                                "map_version": self.map_version}
                               if self.shard is not None else {})) as sp:
            tid = sp.context.trace_id if sp.context is not None else ""
            shed = self._tenant_admit(tenant, rid, tid, cost)
            if shed is not None:
                sp.set(outcome="tenant_quota")
                status, wire = shed
                wire["kind"] = "rejected"
                wire.setdefault("router", self._stamp(replica=""))
                return status, iter([wire])
            if self.durable:
                # Write-ahead admission — AFTER the quota gate (a shed
                # job took no charge, so it must leave no charge
                # identity for a recovery to "refund"): the job and,
                # with a pricer armed, its charge identity are durable
                # before any replica sees it; recovery refunds the
                # UNEXECUTED fraction of crash-interrupted jobs from
                # exactly these fields.
                self._wal_append(
                    "admit", lid=lid, key=key,
                    **({"cost": round(cost, 9),
                        "budget": float(body.get("max_iters", 500)
                                        or 500),
                        "wu_start": token_progress(body.get("resume"))}
                       if (self.pricer is not None
                           and self.quotas is not None) else {}))
            # NOT observed into the warm-placement observatory: a
            # converge job's warm state is its chunk/level programs,
            # which warmup() cannot reproduce from these fields (the
            # observatory is batch-path configs only, by design).
            tp = (obs_trace.format_traceparent(sp.context)
                  if sp.context is not None else None)
            tried: set[str] = set()
            verdict, a, b = self._converge_walk(key, body, timeout, tp,
                                                tried)
            if verdict == "pass":
                sp.set(outcome=b.get("rejected") or "rejected")
                # The request's own terminal fault: the charge stays,
                # but the WAL must record it SETTLED — a recovery has
                # nothing to reconcile for this job.
                self._wal_append("job_settled", lid=lid)
                b.setdefault("router", self._stamp(replica=""))
                return a, iter([b])
            if verdict == "reject":
                sp.set(outcome=b.get("rejected") or "rejected")
                # Same refund rule as `request`: the token comes back
                # only when NO replica did work — a terminal `error`
                # outcome executed on a device and stays charged.
                # Either way the charge identity settles NOW, so a
                # later recovery can't refund it (or refund it twice).
                if (self.quotas is not None
                        and b.get("rejected") in _REFUND_REJECTS):
                    self._refund(tenant, cost)
                self._wal_append("job_settled", lid=lid)
                b.setdefault("router", self._stamp(replica=""))
                return a, iter([b])
            rep, rows = a, b
            sp.set(outcome="streaming", replica=rep.name)
            if self.durable:
                # Pin the job while its stream is live: capacity
                # eviction must never take a MID-STREAM job's token
                # (the ledger_evicted fix — unpinned in release()).
                self.jobs.pin(lid)
            if ledger_seeded:
                # A client retry resuming from the ledger is a resume
                # too — counted and stamped like a mid-stream one ("the
                # job left a dead stream"; the ledger doesn't know which
                # replica died, the retry gap hides it).
                self._record_resume(lid, key, rid, "client-retry", rep,
                                    body["resume"])
            # `hold` shares the live attempt between the durable driver
            # and the release closure: released exactly once, for
            # whichever replica currently carries the stream — even
            # when the caller drops the stream un-started.
            hold = {"rep": rep, "released": False}

            def release():
                with self._lock:
                    if not hold["released"]:
                        hold["released"] = True
                        hold["rep"].in_flight -= 1
                if self.durable:
                    self.jobs.unpin(lid)

            return 200, ReleasingStream(
                self._stream_durable(key, body, timeout, tp, rid, lid,
                                     tenant, cost, tried, hold, rows),
                release)

    @staticmethod
    def _token_fits(token: dict, body: dict) -> bool:
        """Is this ledger token a legal seed for THIS body's budget?
        Jacobi tokens sit on check_every boundaries — or the minting
        budget's own final short chunk, which a changed max_iters may
        invalidate.  Multigrid tokens count V-CYCLES (every cycle is a
        legal boundary; max_iters is a fine-grid WORK-UNIT budget), so
        only the banked work must still fit the budget.
        """
        try:
            solver = str(token.get("solver")
                         or body.get("solver") or "jacobi")
            mi = float(body.get("max_iters", 500) or 500)
            if solver == "multigrid":
                return token_progress(token) <= mi
            it = int(token.get("iters", 0))
            ce = max(1, int(body.get("check_every", 10) or 10))
        except (TypeError, ValueError):
            return False
        return it <= mi and (it % ce == 0 or it == int(mi))

    def _record_resume(self, lid: str, key: str, rid: str,
                       from_name: str, to_rep, token: dict) -> None:
        """One resume's bookkeeping — ledger note, counters, obs event —
        shared by the mid-stream failover and client-retry paths so the
        stamp/metric vocabulary cannot drift between them."""
        n_res, _ = self.jobs.note_resume(lid, key, from_name)
        self._wal_append("resume", lid=lid, key=key,
                         from_replica=from_name)
        self._bump("resumes")
        with self._lock:
            to_rep.stats["resumes"] += 1
        if obs_metrics.enabled():
            obs_metrics.counter(
                "pctpu_converge_resumes_total",
                "durable converge jobs resumed mid-stream on a "
                "surviving replica", ("replica",)).inc(
                replica=to_rep.name)
            obs_events.emit(
                "resume", request_id=rid, from_replica=from_name,
                to_replica=to_rep.name,
                at_iters=int(token.get("iters", 0)),
                work_units=float(token.get("work_units", 0.0)),
                resume_count=n_res)

    def _switch_stream(self, hold, rep) -> None:
        """Move the in-flight accounting from the dying replica to the
        resumed one (the walk already bumped the newcomer)."""
        with self._lock:
            if not hold["released"]:
                hold["rep"].in_flight -= 1
            hold["rep"], hold["released"] = rep, False

    def _note_mid_stream_death(self, rep: _ReplicaState, kind: str,
                               detail: str, corrupt: bool) -> None:
        """Breaker + counter bookkeeping for one mid-stream death."""
        if kind == "resharding":
            # Healthy-but-unable (a reshape window): spill semantics,
            # not breaker food — but still a mid-stream failover.
            rep.breaker.record_success()
            self._bump("spills")
        else:
            rep.breaker.record_failure()
            self._bump("failovers")
        self._bump("mid_stream_failovers")
        with self._lock:
            rep.stats["mid_stream_failovers"] += 1
            if kind != "resharding":
                rep.stats["failures"] += 1
            if corrupt:
                rep.stats["corrupt_responses"] += 1
        self._record_counter(rep.name, "mid_stream_death")
        if obs_metrics.enabled():
            obs_events.emit("router", event="mid_stream_death",
                            replica=rep.name, reason=kind,
                            detail=detail[:200])

    def _stream_durable(self, key: str, body: dict, timeout, tp,
                        rid: str, lid: str, tenant: str, cost: float,
                        tried: set, hold: dict, rows):
        """The durable stream driver: pass rows through (token recorded,
        state stripped, router stamped), and on a mid-stream death walk
        the remaining ring candidates with the newest resume token until
        the job finishes or no candidate remains."""
        wu_start = token_progress(body.get("resume"))
        budget = float(body.get("max_iters", 500) or 500)
        wu_last = wu_start
        rows_flowed = 0
        try:
            while True:
                rep = hold["rep"]
                death = None   # (reason, detail, corrupt, row|None)
                try:
                    for row in rows:
                        row = dict(row)
                        if row.get("kind") == "rejected":
                            reason = row.get("rejected")
                            if reason in ("error", "replica_unavailable",
                                          "resharding"):
                                death = (reason,
                                         str(row.get("detail", ""))[:300],
                                         bool(row.get("corrupt")), row)
                                break
                            # invalid / tenant-level mid-stream rows: the
                            # request's own story — pass through and
                            # stop (charge stays; settle it so recovery
                            # has nothing to reconcile).
                            self._wal_append("job_settled", lid=lid)
                            row.setdefault(
                                "router", self._stamp(replica=rep.name))
                            yield row
                            return
                        if self.durable:
                            tok = self.jobs.observe(lid, key, row)
                            if tok is not None:
                                # Write-ahead: the token is durable
                                # BEFORE the row reaches the client, so
                                # a router crash right after this yield
                                # still resumes from this boundary.
                                self._wal_append("token", lid=lid,
                                                 key=key, token=tok)
                            row.pop("state_b64", None)
                            row.pop("state_shape", None)
                        wu_last = max(wu_last, float(
                            row.get("work_units", 0.0) or 0.0))
                        rows_flowed += 1
                        self._maybe_rearm()
                        stamp = self._stamp(replica=rep.name)
                        n_res, res_from = self.jobs.resume_info(lid)
                        if n_res:
                            stamp["resume_count"] = n_res
                            stamp["resumed_from"] = res_from
                        row["router"] = stamp
                        if row.get("kind") == "final":
                            if (self.durable
                                    and not self.jobs.finalize(lid)):
                                # Exactly-once: a concurrent stream for
                                # the same id already delivered the
                                # final.  End THIS stream with a typed
                                # terminal row — every stream must end
                                # in a final or a typed rejection (a
                                # silent EOF would let a client take
                                # its last snapshot for the result) —
                                # and never via the death classifier,
                                # which would charge a healthy replica
                                # a breaker failure for a completed job.
                                yield {
                                    "kind": "rejected", "ok": False,
                                    "rejected": "error",
                                    "retryable": False,
                                    "request_id": rid,
                                    "detail": "request_id collision: "
                                              "the final row was "
                                              "already delivered to a "
                                              "concurrent stream for "
                                              "this id",
                                    "router": self._stamp(
                                        replica=rep.name)}
                                return
                            self._wal_append("final", lid=lid)
                            self._bump("completed")
                            with self._lock:
                                rep.stats["completed"] += 1
                            yield row
                            return
                        yield row
                    else:
                        # Loop EXHAUSTED (no typed-death break): the
                        # stream ended without a final row — treat as a
                        # transport death (a half-closed HTTP stream can
                        # end cleanly mid-job).  Must be the for's else:
                        # after a typed-death break this line would
                        # clobber the captured death row.
                        death = ("replica_unavailable",
                                 "stream ended early", False, None)
                except Exception as e:  # noqa: BLE001 — mid-stream death
                    death = ("replica_unavailable", repr(e)[:300],
                             isinstance(e, CorruptReplicaBody), None)
                reason, detail, corrupt, death_row = death
                self._note_mid_stream_death(rep, reason, detail, corrupt)
                # This replica failed THIS job mid-stream: the resume
                # walk must not hand the job straight back to it.
                tried.add(rep.name)
                token = (self.jobs.token(lid, key)
                         if self.durable else None)
                if self.durable and (token is not None
                                     or rows_flowed == 0):
                    resume_body = dict(body)
                    if token is not None:
                        resume_body["resume"] = token
                    verdict, a, b = self._converge_walk(
                        key, resume_body, timeout, tp, tried)
                    if verdict == "stream":
                        self._switch_stream(hold, a)
                        rows = b
                        if token is not None:
                            # resumed_from names the DYING replica (the
                            # one the job left), per stamp contract.
                            self._record_resume(lid, key, rid, rep.name,
                                                a, token)
                        continue
                    if verdict == "pass":
                        self._wal_append("job_settled", lid=lid)
                        b.setdefault("router",
                                     self._stamp(replica=""))
                        yield b
                        return
                    # Walk exhausted.  A NON-retryable typed death (a
                    # replica-typed `error` row — possibly reproduced on
                    # every candidate the walk just tried) must pass
                    # through verbatim, retryable:false: reporting it as
                    # a retryable `replica_unavailable` would send the
                    # client into an infinite retry loop re-executing a
                    # deterministic failure (the retry taxonomy's split).
                    if (death_row is not None
                            and not death_row.get("retryable", False)):
                        end_row = death_row
                    else:
                        end_row = b
                elif death_row is not None:
                    # Non-resumable typed death: the replica's own row
                    # passes through (trace_id and detail intact), with
                    # a Retry-After hint where the reason is retryable.
                    end_row = death_row
                    if end_row.get("retryable"):
                        end_row.setdefault(
                            "retry_after_s",
                            round(self.breaker_cooldown_s, 4))
                else:
                    end_row = {
                        "kind": "rejected", "ok": False,
                        "rejected": reason,
                        "retryable": reason != "error",
                        "retry_after_s": round(
                            self.breaker_cooldown_s, 4),
                        "request_id": rid, "detail": detail}
                # No candidate left: refund the UNEXECUTED fraction of
                # the admission charge (with a pricer armed, cost covers
                # [wu_start, budget]; without one, keep the flat rule —
                # refund only when NO replica did work).
                if self.quotas is not None:
                    if self.pricer is not None:
                        denom = max(budget - wu_start, 1e-9)
                        frac = max(0.0, min(1.0,
                                            (budget - wu_last) / denom))
                        if frac > 0:
                            self._refund(tenant, cost * frac)
                    elif (rows_flowed == 0
                          and end_row.get("rejected") in _REFUND_REJECTS):
                        self._refund(tenant, cost)
                # This stream END settles the charge identity — the
                # refund (if any) just happened, so a later recovery
                # must not reconcile this job again.  The token itself
                # survives: a client retry still resumes.
                self._wal_append("job_settled", lid=lid)
                n_res, res_from = self.jobs.resume_info(lid)
                stamp = self._stamp(replica="")
                if n_res:
                    stamp["resume_count"] = n_res
                    stamp["resumed_from"] = res_from
                end_row["router"] = {**stamp,
                                     **end_row.get("router", {})}
                yield end_row
                return
        finally:
            # Generator-exhaustion release twin of the wrapper closure:
            # whichever runs first wins (hold["released"] gates both).
            with self._lock:
                if not hold["released"]:
                    hold["released"] = True
                    hold["rep"].in_flight -= 1
            if self.durable:
                self.jobs.unpin(lid)

    # -- pool mutation (autoscaling) ------------------------------------------
    def add_replica(self, transport, join_ring: bool = True) -> None:
        """Register a NEW replica (unique ``transport.name``).

        With ``join_ring=False`` the replica is registered (health-
        polled, dispatchable as a relaxed-pass fallback via nothing —
        it owns no ring span) but receives no routed traffic until
        :meth:`join_ring`: the autoscaler's warm-placement window sits
        between the two calls — pre-warm the joining replica's key
        shard FIRST, then add its vnodes, so the remapped keys land on
        warm executables instead of a compile storm.
        """
        name = str(transport.name)
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already registered")
            rep = _ReplicaState(transport, CircuitBreaker(
                self.breaker_threshold, self.breaker_cooldown_s,
                clock=self._clock))
            # Copy-on-write: concurrent dispatch threads iterate the OLD
            # dict object; in-place insertion could blow their iterators.
            self._replicas = {**self._replicas, name: rep}
        # One immediate active probe: the first routed request must not
        # ride the optimistic default into a replica that isn't up yet.
        try:
            status, payload = rep.transport.readyz()
            rep.ready, rep.ready_payload = status == 200, payload
        except Exception as e:  # noqa: BLE001 — a dead newborn
            rep.ready, rep.ready_payload = False, {"error": repr(e)[:200]}
        if obs_metrics.enabled():
            obs_events.emit("router", event="replica_added", replica=name,
                            in_ring=bool(join_ring))
        if join_ring:
            self.join_ring(name)

    def join_ring(self, name: str) -> None:
        """Add a registered replica's vnodes to the ring (it starts
        receiving its key shard NOW — pre-warm first)."""
        if name not in self._replicas:
            raise KeyError(f"unknown replica {name!r}")
        self.ring.add(name)
        self._wal_append("ring_add", name=name)
        if obs_metrics.enabled():
            obs_events.emit("router", event="ring_join", replica=name)

    def remove_replica(self, name: str, drain_s: float = 10.0,
                       close: bool = True) -> dict:
        """Drain one replica out of the pool (the scale-down path).

        Ring removal happens FIRST — new requests route to the
        remaining members (the same remap-only-the-touched-member
        property as a kill, but voluntary) — then in-flight work gets
        ``drain_s`` wall seconds to land (progressive streams count:
        they hold ``in_flight`` for their whole life).  A request that
        races the final close surfaces as the usual transport-death
        failover, i.e. a typed retryable outcome, never a dropped
        request.  Returns ``{"replica", "drained", "in_flight"}``.
        """
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                raise KeyError(f"unknown replica {name!r}")
            if len(self._replicas) <= 1:
                raise ValueError("cannot remove the last replica")
        self.ring.remove(name)
        self._wal_append("ring_remove", name=name)
        deadline = time.monotonic() + max(0.0, float(drain_s))
        while rep.in_flight > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        with self._lock:
            remaining = dict(self._replicas)
            remaining.pop(name, None)
            self._replicas = remaining
        if close:
            try:
                rep.transport.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        info = {"replica": name, "drained": rep.in_flight == 0,
                "in_flight": rep.in_flight}
        if obs_metrics.enabled():
            obs_events.emit("router", event="replica_removed", **info)
        return info

    def shard_configs(self, name: str) -> list[dict]:
        """The wire configs a replica named ``name`` would become HOME
        for if it joined the ring now — the pre-warm worklist (from the
        key-config observatory; config fields only, no image content).
        """
        with self._lock:
            items = list(self._key_configs.items())
        members = self.ring.members()
        if name not in members:
            members = [*members, name]
        probe = HashRing(members, vnodes=self.ring.vnodes)
        out = []
        for key, cfg in items:
            cands = probe.candidates(key)
            if cands and cands[0] == name:
                out.append(dict(cfg))
        return out

    # -- lifecycle / introspection -------------------------------------------
    def readyz(self):
        """(status, payload): 200 iff at least one replica is ready."""
        reps = {
            name: {"ready": rep.ready,
                   "breaker": rep.breaker.state(),
                   "in_flight": rep.in_flight}
            for name, rep in self._replicas.items()}
        ready = any(v["ready"] and v["breaker"] != OPEN
                    for v in reps.values())
        return (200 if ready else 503), {
            "ok": ready, "ready": ready, "replicas": reps}

    def snapshot(self) -> dict:
        members = set(self.ring.members())
        with self._lock:
            stats = dict(self.stats)
            per = {}
            for name, rep in self._replicas.items():
                payload = rep.ready_payload or {}
                per[name] = {
                    "ready": rep.ready,
                    "breaker": rep.breaker.snapshot(),
                    "in_flight": rep.in_flight,
                    # The autoscaler's own inputs, exposed for operators
                    # and tests alike (from the last /readyz poll):
                    "queue_depth": payload.get("queue_depth"),
                    "queue_bound": payload.get("queue_bound"),
                    "warm_keys": payload.get("warm_keys"),
                    "degraded": payload.get("degraded") or [],
                    "in_ring": name in members,
                    **rep.stats,
                }
        return {
            "router": stats,
            "replicas": per,
            "ring": sorted(members),
            "observed_keys": len(self._key_configs),
            # Durable-job ledger: live tokens + total resumes
            # — the chaos-drill operator surface.  It adds the
            # ledger_evicted counter inside.
            "jobs": self.jobs.snapshot(),
            # Crash-safe control plane: the fencing epoch
            # and the WAL's own health.  And the shard this
            # router owns (None when unsharded) + its map version.
            "epoch": self.epoch,
            **({"shard": self.shard, "map_version": self.map_version}
               if self.shard is not None else {}),
            **({"wal": self.wal.snapshot(),
                "durability": ("degraded" if self._durability_degraded
                               else "ok")}
               if self.wal is not None else {}),
            **({"tenants": self.quotas.snapshot()}
               if self.quotas is not None else {}),
        }

    def replica(self, name: str):
        """The named replica's TRANSPORT (drills kill/revive through it)."""
        return self._replicas[name].transport

    def close(self, close_replicas: bool = True) -> None:
        self._closed.set()
        t = self._poll_thread
        if t is not None and t.is_alive():
            t.join(5.0)
        if self.wal is not None:
            self.wal.close()
        if close_replicas:
            for rep in self._replicas.values():
                try:
                    rep.transport.close()
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass


# -- HTTP frontend ------------------------------------------------------------

def make_router_http_server(router: ReplicaRouter, host: str = "127.0.0.1",
                            port: int = 8080):
    """The router's own stdlib HTTP frontend: same wire format as the
    replica frontend (a client cannot tell a router from a replica,
    except for the extra ``router`` stamp), plus router-level
    ``/readyz``/``/stats``.  Tenant identity rides the ``x-tenant``
    header or the ``tenant`` body field.  It listens with a backlog of
    128, as the replica frontend does."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send(self, status: int, payload: dict) -> None:
            send_json(self, status, payload)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path == "/healthz":
                self._send(200, {"ok": True, **router.snapshot()})
            elif self.path == "/readyz":
                self._send(*router.readyz())
            elif self.path == "/stats":
                self._send(200, router.snapshot())
            elif self.path == "/v1/shardmap":
                # Sharded control plane: any router serves
                # the version-stamped shard map — clients fetch it from
                # whichever peer answers and route directly to owners.
                smw = getattr(router, "shardmap_wire", None)
                if smw is None:
                    self._send(404, {"ok": False,
                                     "detail": "not a sharded router"})
                else:
                    self._send(200, smw())
            elif self.path == "/metrics":
                from parallel_convolution_tpu_torch.serving.frontend import (
                    metrics_text,
                )

                data = metrics_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._send(404, {"ok": False, "detail": "unknown path"})

        def _do_post_frames(self):
            """The negotiated binary wire at the ROUTER tier.

            ``/v1/convolve`` forwards the tensor bytes OPAQUELY: only
            the envelope header is parsed (everything routing, pricing,
            and QoS read lives there); the frames pass to the replica
            and back byte-untouched, CRC-verified once at the replica.
            ``/v1/converge`` is the exception — mid-stream failover
            needs the router to READ rows (resume tokens), so the job
            runs JSON router↔replica and rows re-frame at this edge;
            a converge stream amortizes that cost over its whole run.
            """
            n = int(self.headers.get("Content-Length", "0") or 0)
            raw = self.rfile.read(n)
            try:
                body, frames_raw = frames_mod.split_envelope(raw)
            except frames_mod.BadFrame as e:
                send_frames(self, 400, frames_mod.encode_envelope(
                    {"ok": False, "rejected": "bad_frame",
                     "retryable": False, "wire": "frames",
                     "detail": str(e)[:300]}, {}))
                return
            tenant = self.headers.get("x-tenant")
            if self.path == "/v1/convolve":
                body["_frames_raw"] = bytes(frames_raw)
                status, wire = router.request(body, tenant=tenant)
                out_raw = wire.pop("_frames_raw", b"")
                send_frames(self, status,
                            frames_mod.join_envelope(wire, out_raw))
                return
            # converge: decode fully, run the JSON machinery, re-frame.
            try:
                _, arrays = frames_mod.decode_envelope(raw)
            except frames_mod.BadFrame as e:
                send_frames(self, 400, frames_mod.encode_envelope(
                    {"ok": False, "rejected": "bad_frame", "kind":
                     "rejected", "retryable": False, "wire": "frames",
                     "detail": str(e)[:300]}, {}))
                return
            body.pop("_frame_fields", None)
            jbody = _frames_converge_to_json(body, arrays)
            status, rows = router.converge(jbody, tenant=tenant)
            if status != 200:
                row = next(iter(rows))
                send_frames(self, status, _reframe_row(row))
                return
            send_frames_stream(self, (_reframe_row(r) for r in rows))

        def do_POST(self):  # noqa: N802 — http.server API
            if self.path not in ("/v1/convolve", "/v1/converge",
                                 "/v1/peersync"):
                # Drain the body first: under HTTP/1.1 keep-alive an
                # unread body would be parsed as the NEXT request line.
                drain_body(self)
                self._send(404, {"ok": False, "detail": "unknown path"})
                return
            if self.path == "/v1/peersync":
                # Peer anti-entropy pull: the caller posts
                # its sync cursor, the reply carries map + membership +
                # debt deltas since then.
                sync = getattr(router, "handle_peersync", None)
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                except (ValueError, json.JSONDecodeError) as e:
                    self._send(400, {"ok": False, "rejected": "invalid",
                                     "detail": f"bad JSON body: {e}"})
                    return
                if sync is None:
                    self._send(404, {"ok": False,
                                     "detail": "not a sharded router"})
                else:
                    self._send(200, sync(body))
                return
            ctype = (self.headers.get("Content-Type") or "").split(
                ";")[0].strip().lower()
            if ctype == frames_mod.FRAMES_CONTENT_TYPE:
                self._do_post_frames()
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"ok": False, "rejected": "invalid",
                                 "detail": f"bad JSON body: {e}"})
                return
            tenant = self.headers.get("x-tenant")
            if self.path == "/v1/converge":
                status, rows = router.converge(body, tenant=tenant)
                if status != 200:
                    self._send(status, next(iter(rows)))
                    return
                send_ndjson_stream(self, rows)
                return
            self._send(*router.request(body, tenant=tenant))

    class Server(ThreadingHTTPServer):
        # socketserver's default listen backlog is 5: a burst of max_batch
        # (8) concurrent connects overflows it, the kernel drops the SYNs
        # and each such client waits a second to retransmit (the
        # replica frontend's rule).  Admission is the router's quotas and
        # the replicas' queue bounds, not the kernel's backlog.
        request_queue_size = 128

    return Server((host, port), Handler)


def _frames_converge_to_json(header: dict, arrays: dict) -> dict:
    """A framed converge request → its JSON-wire twin (the router's
    converge machinery — failover walk, resume tokens — reads row and
    body DICTS, so framed converge transcodes at the router edge)."""
    import base64

    import numpy as np

    body = dict(header)
    img = arrays.get("image")
    if img is not None:
        body["image_b64"] = base64.b64encode(
            np.ascontiguousarray(img).tobytes()).decode("ascii")
    state = arrays.get("resume_state")
    if state is not None:
        token = dict(body.get("resume") or {})
        token["state_b64"] = base64.b64encode(
            np.ascontiguousarray(state).tobytes()).decode("ascii")
        token["state_shape"] = list(state.shape)
        body["resume"] = token
    return body


def _reframe_row(row: dict) -> bytes:
    """One JSON stream row → its framed twin (``image_b64`` and the
    resume-token ``state_b64`` become tensor frames; geometry comes
    from the row's own wire fields)."""
    import base64

    import numpy as np

    out = dict(row)
    out["wire"] = "frames"
    arrays = {}
    b64 = out.pop("image_b64", None)
    shape = out.pop("image_shape", None)
    if b64 is not None:
        flat = np.frombuffer(base64.b64decode(b64), np.uint8)
        arrays["image"] = (flat.reshape([int(v) for v in shape])
                           if shape else flat)
    s64 = out.pop("state_b64", None)
    sshape = out.pop("state_shape", None)
    if s64 is not None:
        sflat = np.frombuffer(base64.b64decode(s64), np.float32)
        arrays["state"] = (sflat.reshape([int(v) for v in sshape])
                           if sshape else sflat)
    return frames_mod.encode_envelope(out, arrays)
