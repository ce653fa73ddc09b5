"""Admission-controlled convolution service over the warm engine (the
port's ``serving/service.py``: the JAX package's service on the port's
engine, batcher, cache and pricer).

The request/response surface of the serving layer: validation, admission
control (bounded queue depth + per-request deadlines + typed
load-shedding), micro-batched execution, and the resilience wiring —
transient failures retry via ``resilience.retry.with_retry`` and compile
faults walk the ``resilience.degrade`` backend ladder per key (inside
the engine).  Every successful response is stamped with the
``effective_backend`` that actually produced its bytes, continuing the
round-7 rule that a degraded tier can never masquerade as the requested
one in any artifact.

Results are TYPED, never exceptions across the service boundary:

* :class:`Response`  — the filtered image + per-request latency phases
  (queue / compile / device / copy, from ``utils.tracing.PhaseTimer``).
* :class:`Rejected`  — load shedding (``queue_full``), missed deadlines
  (``deadline``), contract errors (``invalid``), and exhausted/terminal
  execution failures (``error``).  A queue overflow yields a
  ``Rejected``, not an exception and not a hang.

On the card the degrade walk stops at ``cuda`` (a kernel key is never
served by a plain version there): a refused ``cuda`` becomes
``Rejected("error")``.  CUDA's current device is per thread, so the
engine runs every device step under the grid's card, on the batcher's
executor and on the thread that consumes a progressive stream alike.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time

import numpy as np

from parallel_convolution_tpu_torch.obs import (
    events as obs_events, metrics as obs_metrics, trace as obs_trace,
)
from parallel_convolution_tpu_torch.serving import cache as cache_mod
from parallel_convolution_tpu_torch.serving import engine as engine_mod
from parallel_convolution_tpu_torch.serving.batcher import MicroBatcher
from parallel_convolution_tpu_torch.serving.engine import EngineKey, WarmEngine
from parallel_convolution_tpu_torch.serving.pricing import WorkPricer
from parallel_convolution_tpu_torch.utils.platform import device_kind, topology
from parallel_convolution_tpu_torch.utils.tracing import PhaseTimer

__all__ = ["ConvolutionService", "RETRYABLE_REJECTS", "Rejected",
           "ReleasingStream", "Request", "Response", "Snapshot"]

# The rejection reasons a client should BACK OFF AND RETRY (the condition
# is transient server state: a full queue, a mesh reshape window, an
# exhausted tenant bucket, a router with no live replica).  Everything
# else — invalid, error, deadline, timeout — means the same request will
# not fare better on a retry.  The frontend maps these to 429/503 with a
# Retry-After header.
RETRYABLE_REJECTS = frozenset(
    {"queue_full", "resharding", "tenant_quota", "replica_unavailable"})

# Default client back-off hints per retryable reason (seconds) — used
# when the shed site doesn't compute a better one (the tenant bucket
# computes its exact refill time).
_RETRY_AFTER_DEFAULT = {"queue_full": 0.1, "resharding": 0.5,
                        "tenant_quota": 1.0, "replica_unavailable": 0.5}


@dataclasses.dataclass
class Request:
    """One filtering request: an interleaved u8 image + run knobs.

    ``image`` is (H, W) grey or (H, W, 3) RGB uint8 — the reference CLI's
    image contract.  ``deadline_s`` is a relative latency budget; a
    request still queued past it is shed with ``Rejected("deadline")``
    rather than served late.

    A RANK-3 request sets ``volume`` instead of ``image``: a
    (2, D, H, W) float32 two-field volume (``utils.config.VOLUME_FIELDS``
    interleaved fields — (u, f) for the FD smoothers, (u, u_prev) for
    wave, (U, V) for Gray–Scott), with ``filter_name`` naming a
    registered rank-3 form.  Volume responses carry the float32 fields
    (never u8) and ride the same admission, batching, caching and
    progressive machinery.
    """

    image: np.ndarray | None = None
    filter_name: str = "blur3"
    iters: int = 1
    backend: str = "shifted"         # or "auto": plan-cache/cost-model
    #                                  resolved (engine.key_for)
    storage: str = "f32"
    fuse: int | None = 1             # None = tune it (backend="auto")
    boundary: str = "zero"
    quantize: bool = True
    overlap: bool | None = None      # interior-first overlapped halo
    #                                  pipeline: None = off for explicit
    #                                  backends / tuned for "auto"; the
    #                                  RESOLVED value rides the key and
    #                                  every response stamps it
    col_mode: str | None = None      # RDMA column-slab transport
    #                                  (packed | strided | auto; None =
    #                                  auto) — resolved and stamped
    #                                  under the same rule as overlap
    deadline_s: float | None = None
    request_id: str | None = None    # client-stamped idempotency id: a
    #                                  hedged/retried submission with the
    #                                  same id rides the FIRST one's slot
    #                                  (one device execution per id)
    tenant: str = ""                 # QoS identity (router token buckets;
    #                                  "" = the default tenant)
    solver: str = "jacobi"           # convergence strategy (converge jobs
    #                                  only: the batch path sheds
    #                                  "multigrid" as invalid — there is
    #                                  no fixed-count V-cycle workload)
    mg_levels: int | None = None     # multigrid level-count cap
    volume: np.ndarray | None = None  # rank-3 payload: (2, D, H, W)
    #                                  float32 fields (mutually exclusive
    #                                  with ``image``)


@dataclasses.dataclass
class Response:
    """A served result; ``phases`` is the per-request latency breakdown
    in seconds (queue, compile, device, copy_in, copy_out, total)."""

    image: np.ndarray                # uint8, same layout as the request
    effective_backend: str
    backend: str                     # as requested
    request_id: str
    batch_size: int                  # how many requests shared the program
    phases: dict
    plan_source: str = "explicit"    # explicit|measured|interpolated|
    #                                  predicted (auto-resolution origin)
    predicted_gpx_per_chip: float | None = None  # cost-model figure for
    #                                  the served config (vs measured)
    effective_grid: str = ""         # "RxC" mesh grid that produced the
    #                                  bytes (changes after an elastic
    #                                  reshape mid-process)
    overlap: bool = False            # the compiled program's RESOLVED
    #                                  overlap knob (False when clamped
    #                                  or degraded off the RDMA tier)
    col_mode: str = "packed"         # the compiled program's RESOLVED
    #                                  column-slab transport ('packed'
    #                                  is the canonical label off the
    #                                  RDMA tier)
    exchange_fraction: float = 0.0   # model-attributed EXPOSED exchange
    #                                  share of one iteration's wall
    exchange_hidden_fraction: float = 0.0  # share of exchange time the
    #                                  overlapped pipeline hides under
    #                                  compute (0.0 when serialized)
    trace_id: str = ""               # the request's causal trace id
    #                                  (obs.trace; "" with PCTPU_OBS=0)
    plan_key: str = ""               # tuning canonical key of the served
    #                                  config — the perf_gate.py history
    #                                  key and the drift-series label
    cache: str = "miss"              # content-addressed result cache
    #                                  verdict: "hit" bytes came from the
    #                                  cache (no lane, no device); "miss"
    #                                  they were executed (and stored);
    #                                  "off" the service runs uncached
    digest: str = ""                 # the request's input digest (SHA-256
    #                                  over the planar bytes; "" uncached)

    ok = True


@dataclasses.dataclass
class Rejected:
    """A typed non-result: load shed, deadline miss, or failed execution."""

    reason: str   # queue_full | deadline | invalid | error | resharding |
    #               tenant_quota | replica_unavailable | timeout
    request_id: str
    detail: str = ""
    trace_id: str = ""   # the request's causal trace id (when admitted
    #                      under an active trace; "" otherwise)
    retry_after_s: float | None = None  # back-off hint for retryable
    #                      sheds (the frontend's Retry-After header)

    ok = False

    def __post_init__(self) -> None:
        if self.retry_after_s is None:
            # Every retryable rejection carries a back-off hint, however
            # it was constructed (sites with better information — the
            # tenant bucket's exact refill time — pass their own).
            self.retry_after_s = _RETRY_AFTER_DEFAULT.get(self.reason)

    @property
    def retryable(self) -> bool:
        """True iff a client should back off and retry this reason."""
        return self.reason in RETRYABLE_REJECTS


@dataclasses.dataclass
class Snapshot:
    """One progressive-convergence stream row: the best-so-far field.

    A convergence job streams one of these per ``check_every``-iteration
    chunk; the row with ``final=True`` carries the exact bytes a
    non-progressive run of the same job would have returned.  ``diff``
    is the max-abs single-iteration change the convergence decision
    reads — the stream IS the diff trajectory, so a job that dies mid-run
    has still delivered its best-so-far image plus the curve that says
    how converged it was.
    """

    image: np.ndarray                # uint8, same layout as the request
    iters: int                       # jacobi iterations — or V-CYCLES
    #                                  for solver="multigrid" (one row
    #                                  per cycle; diff is then the
    #                                  fine-grid residual norm)
    diff: float
    final: bool = False
    converged: bool = False          # final=True only: diff < tol
    request_id: str = ""
    effective_backend: str = ""
    effective_grid: str = ""
    plan_key: str = ""
    trace_id: str = ""
    solver: str = "jacobi"           # which convergence strategy produced
    #                                  this row (utils.config.SOLVERS)
    work_units: float = 0.0          # fine-grid work spent so far — the
    #                                  solver-comparable budget unit
    #                                  (= iters for jacobi; the
    #                                  pixel-weighted per-level sum for
    #                                  multigrid)
    mg_levels: int | None = None     # multigrid only: the level count the
    #                                  planner actually scheduled
    #                                  (post-resolution, never the cap)
    col_mode: str = "packed"         # the compiled program's RESOLVED
    #                                  column-slab transport (same
    #                                  stamping rule as batch responses)
    state: np.ndarray | None = None  # the FLOAT32 field at the valid
    #                                  extent — the resume-token payload
    #                                  carried only when the
    #                                  job asked for it (resume_state on
    #                                  the wire): the u8 ``image`` is
    #                                  lossy, so durability needs the
    #                                  exact carries.  Final rows never
    #                                  carry it (nothing left to resume).
    cache: str = "miss"              # final rows only: "hit" when the
    #                                  converged fixed point came from the
    #                                  result cache (the stream is then
    #                                  one row, no device work)
    digest: str = ""                 # the job's rhs input digest

    ok = True


class ReleasingStream:
    """Iterator over a stream of rows that calls ``release`` exactly
    once when the stream ends, is closed, or is garbage-collected —
    including when it was never started.  A plain generator can't do
    that: its ``finally`` only runs once the body has been entered, so
    an un-started, abandoned stream would pin its resource forever
    (here: a ``max_progressive`` slot; in the router: a replica's
    in-flight load count)."""

    def __init__(self, gen, release):
        self._gen = gen
        self._release = release

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self) -> None:
        try:
            self._gen.close()
        finally:
            self._release()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class ConvolutionService:
    """Micro-batched, admission-controlled serving of the stencil stack.

    ``retry_policy`` governs ``with_retry`` around batch execution:
    classified-transient failures (injected faults, transient launch or
    build errors) are retried with deterministic backoff; terminal
    failures and exhausted retries become ``Rejected("error")`` for every
    request in the batch.  ``fallback`` (default True) lets the engine
    walk the degradation ladder per key on transient compile faults.
    """

    def __init__(self, grid=None, *, capacity: int = 16,
                 max_batch: int = 8, max_delay_s: float = 0.005,
                 max_queue: int = 64, fallback: bool = True,
                 retry_policy=None, start: bool = True, plans=None,
                 dedup_capacity: int = 256, max_progressive: int = 2,
                 cache=None, device=None):
        from collections import OrderedDict

        from parallel_convolution_tpu_torch.resilience.retry import RetryPolicy

        # ``grid`` (a mesh.Grid) defaults to 1x1 on ``device``: the card
        # unless the caller asks for "cpu" (WarmEngine's rule).
        self.engine = WarmEngine(grid, capacity=capacity, fallback=fallback,
                                 plans=plans, device=device)
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=2.0)
        # Replica-side admission pricer: the same cost model the router
        # uses, here feeding the batcher's lane priority so an expensive
        # job never head-of-line-blocks a thumbnail (serving.pricing).
        self.pricer = self._make_pricer()
        self.batcher = self._make_batcher(max_batch, max_delay_s,
                                          max_queue, start=start)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._reshape_lock = threading.Lock()
        self._reshaping = False
        # request_id -> Slot: the idempotency ledger.  A hedged or
        # router-retried submission with an already-seen CLIENT-stamped id
        # joins the first submission's slot instead of executing again
        # (one device execution per request_id — and at the router tier,
        # one tenant-quota charge).  FIFO-bounded; a completed REJECTED
        # entry is evicted on the next arrival so a genuine client retry
        # after a shed re-executes.  NOTE the bound is by COUNT, not
        # bytes: completed slots pin their Response images until evicted,
        # so size dedup_capacity down for large-frame deployments
        # (256 × a 3-channel 2048² response ≈ 3 GB worst case).
        self.dedup_capacity = max(0, int(dedup_capacity))
        self._dedup: OrderedDict[str, object] = OrderedDict()
        self._dedup_lock = threading.Lock()
        # Progressive convergence jobs bypass the micro-batcher (they are
        # long, chunked, and fence per chunk) but are still bounded:
        # at most this many run concurrently, beyond which submissions
        # shed typed-retryable queue_full.
        self.max_progressive = max(1, int(max_progressive))
        self._progressive_active = 0
        # Content-addressed result cache (serving.cache), consulted in
        # _admit AHEAD of the batcher so a hit never touches a lane, a
        # compile, or the device.  ``cache`` is a ResultCache, True (a
        # default in-memory tier), or None/False (off — the default:
        # duplicate-sensitive drills construct services bare, and the
        # serving entrypoints opt in explicitly).
        if cache is True:
            cache = cache_mod.ResultCache()
        # NOT ``cache or None``: an EMPTY ResultCache is falsy (__len__).
        self.cache = cache if cache is not None else None
        # The legacy stats dict, now a view over the obs registry: every
        # write mirrors into pctpu_service_stats{key=...} (obs.metrics),
        # so the admission-control ledger is one /metrics scrape away.
        self.stats = obs_metrics.MirroredStats(obs_metrics.gauge(
            "pctpu_service_stats", "service admission/completion counters",
            ("key",)), initial={
            "submitted": 0, "completed": 0, "retries": 0,
            "rejected_queue_full": 0, "rejected_deadline": 0,
            "rejected_invalid": 0, "rejected_error": 0,
            "rejected_resharding": 0, "client_timeouts": 0,
            "reshapes": 0, "deduped": 0, "progressive": 0,
            "rejected_stale_epoch": 0, "cache_hits": 0, "cache_misses": 0,
        })
        # Router-epoch fence: the highest epoch any router
        # has ever stamped on a request to THIS replica.  A request
        # carrying a LOWER epoch comes from a zombie — a router that
        # lost a fenced takeover — and is rejected before any work, so
        # a stale active can never double-deliver after the standby
        # took over.  Process memory on purpose: a replica restart
        # clears its dedup ledger too, and the fence re-ratchets on the
        # first request from the live router.
        # Router-epoch fences, keyed by shard label.  The
        # empty key "" is the unsharded/legacy lineage; a replica serving
        # N shards holds N independent ratchets, so fencing shard A's
        # zombie owner never rejects the same process's LIVE ownership
        # of shard B.
        self._fences: dict[str, int] = {}

    def _make_pricer(self) -> WorkPricer:
        """The pricer on the engine grid's model: the H100's under the
        card's name on a CUDA grid, the host model on the CPU."""
        dev = self.engine.grid.device
        return WorkPricer(self.engine.grid_shape(),
                          "gpu" if dev.type == "cuda" else "cpu",
                          device_kind(dev))

    def _make_batcher(self, max_batch: int, max_delay_s: float,
                      max_queue: int, start: bool = True) -> MicroBatcher:
        """The one construction site for this service's batcher (used by
        ``__init__`` AND ``reshape``, so the continuous-batching wiring
        — shape-bucketed lanes via ``engine.bucket_key``, the collector's
        host-side ``_prepare_batch`` — survives a mesh swap)."""
        return MicroBatcher(
            self._execute_batch, max_batch=max_batch,
            max_delay_s=max_delay_s, max_queue=max_queue, start=start,
            lane_of=engine_mod.bucket_key, prepare=self._prepare_batch)

    # -- admission -----------------------------------------------------------
    def _bump(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self.stats[counter] += n

    def _shed(self, reason: str, rid: str, detail: str = "",
              counter: str | None = None, n: int = 1,
              trace=None, retry_after_s: float | None = None) -> Rejected:
        """One path for every typed rejection: the legacy counter bump,
        the admission event, and the Rejected value.  ``trace`` is the
        request's :class:`obs.trace.SpanContext` when it was admitted
        under an active trace — the rejection then joins the tree.
        Retryable reasons carry a back-off hint (``retry_after_s``,
        defaulted per reason) that the frontend turns into Retry-After."""
        if counter is not None:
            self._bump(counter, n)
        if obs_metrics.enabled():
            obs_metrics.counter(
                "pctpu_admission_total",
                "typed request outcomes at the admission boundary",
                ("outcome",)).inc(n, outcome=reason)
            obs_events.emit(
                "admission", outcome=reason, request_id=rid,
                detail=detail[:200],
                **({"trace_id": trace.trace_id} if trace is not None
                   else {}))
        # retry_after_s=None defers to Rejected.__post_init__'s
        # per-reason default — one site owns the defaulting rule.
        return Rejected(reason, rid, detail=detail,
                        trace_id=trace.trace_id if trace is not None else "",
                        retry_after_s=retry_after_s)

    def _validate(self, req: Request,
                  progressive: bool = False) -> tuple[EngineKey, str,
                                                      np.ndarray]:
        """Terminal ValueError on any contract violation (→ ``invalid``).

        Returns ``(key, plan_source, planar)`` — provenance is
        per-REQUEST (an auto and an explicit request can share a key)."""
        from parallel_convolution_tpu_torch.ops.filters import get_filter
        from parallel_convolution_tpu_torch.utils import imageio

        if req.solver != "jacobi" and not progressive:
            # Only convergence jobs have a solver choice: a fixed-count
            # V-cycle workload does not exist, so the batch path sheds it
            # here instead of compiling a meaningless key.
            raise ValueError(
                f"solver={req.solver!r} is only valid for convergence "
                "jobs (/v1/converge); the batch path is solver-less")
        if req.volume is not None:
            return self._validate_volume(req)
        if req.image is None:
            raise ValueError("request carries neither image nor volume")
        img = np.asarray(req.image)
        if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
                img.ndim == 3 and img.shape[-1] != 3):
            raise ValueError(
                f"image must be uint8 (H, W) or (H, W, 3), got "
                f"{img.dtype} {img.shape}")
        planar = imageio.interleaved_to_planar(img).astype(np.float32)
        key, plan_source = self.engine.resolve_key(
            planar.shape, filter_name=req.filter_name, storage=req.storage,
            iters=int(req.iters),
            fuse=None if req.fuse is None else int(req.fuse),
            boundary=req.boundary,
            quantize=bool(req.quantize), backend=req.backend,
            overlap=req.overlap, col_mode=req.col_mode, solver=req.solver,
            mg_levels=(None if req.mg_levels is None
                       else int(req.mg_levels)))
        key.validate()
        filt = get_filter(key.filter_name)
        R, C = key.grid
        if (min(-(-planar.shape[1] // R), -(-planar.shape[2] // C))
                < filt.radius * key.fuse):
            raise ValueError(
                f"per-device block smaller than radius*fuse "
                f"({filt.radius}*{key.fuse}) for image "
                f"{planar.shape[1:]} on grid {key.grid}")
        if key.boundary == "periodic" and (
                planar.shape[1] % R or planar.shape[2] % C):
            raise ValueError(
                "periodic boundary requires grid-divisible dimensions")
        return key, plan_source, planar

    def _validate_volume(self, req: Request) -> tuple[EngineKey, str,
                                                      np.ndarray]:
        """The rank-3 arm of :meth:`_validate`: ``planar`` is the
        (2, D, H, W) float32 volume itself.  Quantize/storage are
        CLAMPED (volumes are float fields — the u8 knobs have no rank-3
        meaning, so every spelling of a volume request shares one key
        rather than shedding on an inapplicable default)."""
        from parallel_convolution_tpu_torch.utils.config import (
            VOLUME_FIELDS, VOLUME_RADII,
        )

        if req.image is not None:
            raise ValueError("request carries both image and volume")
        vol = np.asarray(req.volume)
        if vol.ndim != 4 or vol.shape[0] != VOLUME_FIELDS:
            raise ValueError(
                f"volume must be ({VOLUME_FIELDS}, D, H, W) float32, "
                f"got shape {vol.shape}")
        if vol.dtype != np.float32:
            raise ValueError(
                f"volume must be float32, got {vol.dtype}")
        if req.solver != "jacobi":
            raise ValueError(
                "rank-3 convergence is the chunked-jacobi driver; "
                f"solver={req.solver!r} is rank-2 only")
        planar = np.ascontiguousarray(vol, dtype=np.float32)
        D, H, W = planar.shape[1:]
        key, plan_source = self.engine.resolve_key(
            (D, H, W), rank=3, filter_name=req.filter_name,
            storage="f32", iters=int(req.iters),
            fuse=1 if req.fuse is None else int(req.fuse),
            boundary=req.boundary, quantize=False, backend=req.backend,
            overlap=req.overlap, col_mode=req.col_mode,
            solver=req.solver)
        key.validate()
        r = VOLUME_RADII[key.filter_name]
        R, C = key.grid
        if min(-(-H // R), -(-W // C)) < r * key.fuse:
            raise ValueError(
                f"per-device block smaller than radius*fuse "
                f"({r}*{key.fuse}) for volume plane ({H}, {W}) on grid "
                f"{key.grid}")
        if key.boundary == "periodic":
            if H % R or W % C:
                raise ValueError(
                    "periodic boundary requires grid-divisible "
                    "dimensions")
            if D < r * key.fuse:
                raise ValueError(
                    f"periodic depth wrap needs D >= radius*fuse "
                    f"({r}*{key.fuse}), got D={D}")
        return key, plan_source, planar

    def submit(self, req: Request, wait: bool = True,
               timeout: float | None = None):
        """Admit + (optionally) await one request.

        ``wait=True`` returns a :class:`Response` or :class:`Rejected`;
        ``wait=False`` returns the queue :class:`Slot` (or the immediate
        ``Rejected``) so callers can multiplex.

        A CLIENT-stamped ``request_id`` is an idempotency key: a second
        submission with the same id while the first is in flight (a
        hedge) or completed (a router retry after a lost response) joins
        the first one's slot — one device execution, one result, counted
        in ``stats["deduped"]``.  A completed REJECTED outcome does NOT
        stick: the retry after a shed re-executes.
        """
        rid = req.request_id or f"r{next(self._ids)}"
        self._bump("submitted")
        placeholder = None
        if req.request_id is not None and self.dedup_capacity:
            from parallel_convolution_tpu_torch.serving.batcher import Slot

            with self._dedup_lock:
                cached = self._dedup.get(rid)
                if (cached is not None and cached.done()
                        and isinstance(cached.result(0), Rejected)):
                    # A shed/failed attempt: the retry is a fresh request.
                    self._dedup.pop(rid, None)
                    cached = None
                if cached is None:
                    placeholder = Slot()
                    self._dedup[rid] = placeholder
                    while len(self._dedup) > self.dedup_capacity:
                        self._dedup.popitem(last=False)
            if placeholder is None:
                self._bump("deduped")
                if not wait:
                    return cached
                result = cached.result(timeout)
                if result is None:
                    return self._shed("timeout", rid,
                                      detail="client wait timed out",
                                      counter="client_timeouts")
                return result
        outcome, root = self._admit(req, rid, placeholder)
        if isinstance(outcome, Rejected):
            if placeholder is not None:
                with self._dedup_lock:
                    self._dedup.pop(rid, None)
                placeholder.set(outcome)
            return outcome
        if not wait:
            return outcome
        result = outcome.result(timeout)
        if result is None:
            # NOT a server-side shed: the caller gave up waiting while the
            # request may still be executing (and will later count as
            # completed).  Distinct reason + counter so an unresponsive
            # service can never reconcile as healthy load shedding.
            return self._shed("timeout", rid,
                              detail="client wait timed out",
                              counter="client_timeouts", trace=root)
        return result

    def _admit(self, req: Request, rid: str, slot=None):
        """Validate + enqueue one request; returns ``(outcome, root)``
        where outcome is the queue Slot or a typed Rejected and root the
        request's trace context (so later sheds — the client-timeout
        path — keep their trace linkage).  ``slot`` (the dedup
        placeholder) becomes the item's slot so hedges that reserved it
        rendezvous correctly."""
        # The request's causal root: the transport's `request` span when
        # one is active (frontend.InProcessClient / the HTTP handler),
        # else the admission span below becomes the root — either way a
        # traced request has exactly ONE root (obs.trace).
        parent = obs_trace.current()
        root = parent
        with obs_trace.span("admission", request_id=rid,
                            backend=req.backend) as asp:
            if root is None:
                root = asp.context
            asp.set(outcome="admitted")
            if self._reshaping:
                # The mesh is being swapped under us: shed with a typed,
                # retryable reason (the window is one drain + re-warm
                # long).
                asp.set(outcome="resharding")
                return self._shed("resharding", rid,
                                  detail="mesh reshape in progress; retry",
                                  counter="rejected_resharding",
                                  trace=root), root
            try:
                key, plan_source, planar = self._validate(req)
            except Exception as e:  # noqa: BLE001 — typed contract errors
                asp.set(outcome="invalid")
                return self._shed("invalid", rid, detail=str(e),
                                  counter="rejected_invalid",
                                  trace=root), root
            digest, ckey = "", ""
            if self.cache is not None:
                # Content-addressed lookup AHEAD of the batcher: a hit is
                # served right here — no lane, no queue, no device.  The
                # key folds the input digest with the FULL compile
                # identity, so equal keys are byte-identical answers by
                # construction.
                t_lookup = time.monotonic()
                digest = cache_mod.input_digest(planar)
                ckey = cache_mod.result_key(digest, key)
                got = self.cache.get(ckey)
                if got is not None:
                    hit = self._hit_response(
                        req, rid, got, digest=digest, root=root,
                        plan_source=plan_source,
                        lookup_s=time.monotonic() - t_lookup)
                    asp.set(outcome="cache_hit", cache="hit",
                            digest=digest)
                    out_slot = slot
                    if out_slot is None:
                        from parallel_convolution_tpu_torch.serving.batcher \
                            import Slot

                        out_slot = Slot()
                    out_slot.set(hit)
                    return out_slot, root
                asp.set(cache="miss", digest=digest)
                self._bump("cache_misses")
            deadline_at = (time.monotonic() + req.deadline_s
                           if req.deadline_s is not None else None)
            if key.rank == 3:
                price_body = {
                    "rows": planar.shape[2], "cols": planar.shape[3],
                    "depth": planar.shape[1], "mode": "volume",
                    "filter": key.filter_name, "iters": key.iters,
                    "fuse": key.fuse, "boundary": key.boundary}
            else:
                price_body = {
                    "rows": planar.shape[1], "cols": planar.shape[2],
                    "mode": "rgb" if req.image.ndim == 3 else "grey",
                    "filter": key.filter_name, "iters": key.iters,
                    "backend": key.backend, "storage": key.storage,
                    "fuse": key.fuse, "boundary": key.boundary,
                    "quantize": key.quantize}
            payload = {"planar": planar, "rid": rid,
                       "rgb": (key.rank == 2 and req.image.ndim == 3),
                       "rank": key.rank,
                       "digest": digest, "ckey": ckey,
                       "backend": req.backend, "plan_source": plan_source,
                       # Predicted device-seconds: the batcher's lane-
                       # priority input (cheap lanes flush first when
                       # several are due — anti head-of-line-blocking).
                       "cost_units": self.pricer.price(price_body),
                       # The context the worker thread re-enters: queue
                       # span parent, batch-span link, response trace_id.
                       "trace": root}
            out_slot = self.batcher.try_submit(key, payload, deadline_at,
                                               slot=slot)
            if out_slot is None:
                asp.set(outcome="queue_full")
                return self._shed(
                    "queue_full", rid,
                    detail=f"queue depth >= {self.batcher.max_queue}",
                    counter="rejected_queue_full", trace=root), root
        return out_slot, root

    def _hit_response(self, req: Request, rid: str, got, *, digest: str,
                      root, plan_source: str, lookup_s: float) -> Response:
        """Rebuild a served Response from one cache entry.  The stored
        image layout always matches the request's (grey vs RGB changes
        the planar shape, which changes the digest), and the stamped
        provenance is the EXECUTING request's — the one that paid."""
        arrays, meta = got
        per = {"queue": 0.0, "cache": round(lookup_s, 6),
               "total": round(lookup_s, 6)}
        self._bump("cache_hits")
        self._bump("completed")
        if obs_metrics.enabled():
            obs_metrics.counter(
                "pctpu_admission_total",
                "typed request outcomes at the admission boundary",
                ("outcome",)).inc(outcome="cache_hit")
            obs_events.emit(
                "admission", outcome="cache_hit", request_id=rid,
                digest=digest[:16],
                **({"trace_id": root.trace_id} if root is not None
                   else {}))
        return Response(
            # Copy: the memory tier's array is shared; an in-process
            # caller mutating its response must not poison the cache.
            image=np.array(arrays["image"]),
            effective_backend=str(meta.get("effective_backend", "")),
            backend=req.backend, request_id=rid,
            batch_size=1, phases=per,
            plan_source=plan_source,
            predicted_gpx_per_chip=meta.get("predicted_gpx_per_chip"),
            effective_grid=str(meta.get("effective_grid", "")),
            overlap=bool(meta.get("overlap", False)),
            col_mode=str(meta.get("col_mode", "packed")),
            exchange_fraction=float(meta.get("exchange_fraction", 0.0)),
            exchange_hidden_fraction=float(
                meta.get("exchange_hidden_fraction", 0.0)),
            trace_id=root.trace_id if root is not None else "",
            plan_key=str(meta.get("plan_key", "")),
            cache="hit", digest=digest)

    # -- execution (batcher collector + executor threads) ---------------------
    def _prepare_batch(self, lane: EngineKey, items) -> dict:
        """Host-side flush assembly, run on the batcher's COLLECTOR
        thread while the executor still runs the previous flush — the
        overlap that keeps the device full (continuous batching).

        Deadline-expired items shed here (before any stacking work is
        spent on them).  A UNIFORM flush (every item shares one original
        key) executes at that exact key with a plain ``np.stack`` — zero
        padding, byte-for-byte the pre-lane behavior.  A MIXED flush
        executes at the lane's bucket key: each planar lands in the
        top-left corner of a zeroed (C, bH, bW) slab, which
        ``engine.bucket_key`` already proved results-invariant for the
        keys it co-batches (iters==1, zero boundary, jacobi)."""
        start = time.monotonic()
        live = []
        for it in items:
            if it.deadline_at is not None and start > it.deadline_at:
                it.slot.set(self._shed(
                    "deadline", it.payload["rid"],
                    detail=f"queued {start - it.enqueued_at:.3f}s past "
                           "deadline",
                    counter="rejected_deadline",
                    trace=it.payload.get("trace")))
            else:
                live.append(it)
        if not live:
            return {"live": live, "stacked": None, "exec_key": lane,
                    "start": start}
        if all(it.key == live[0].key for it in live):
            exec_key = live[0].key
            stacked = np.stack([it.payload["planar"] for it in live])
        else:
            exec_key = lane
            c, bh, bw = exec_key.shape
            stacked = np.zeros((len(live), c, bh, bw), np.float32)
            for i, it in enumerate(live):
                p = it.payload["planar"]
                stacked[i, :, :p.shape[1], :p.shape[2]] = p
        return {"live": live, "stacked": stacked, "exec_key": exec_key,
                "start": start}

    def _execute_batch(self, lane: EngineKey, items,
                       prepared: dict | None = None) -> None:
        from parallel_convolution_tpu_torch.resilience.retry import with_retry
        from parallel_convolution_tpu_torch.utils import imageio

        if prepared is None:  # direct callers (no collector stage)
            prepared = self._prepare_batch(lane, items)
        live = prepared["live"]
        start = prepared["start"]
        key = prepared["exec_key"]
        if not live:
            return
        if key.grid != self.engine.grid_shape():
            # The submit-vs-reshape race: a request that passed the
            # _reshaping check keyed against the old grid, then landed on
            # the post-swap batcher.  Shed it typed-and-retryable — the
            # stale-grid ValueError in run_batch must stay a caller-bug
            # backstop, never a client-visible "error".
            for it in live:
                it.slot.set(self._shed(
                    "resharding", it.payload["rid"],
                    detail="mesh resharded while queued; retry",
                    counter="rejected_resharding",
                    trace=it.payload.get("trace")))
            return
        stacked = prepared["stacked"]
        timer = PhaseTimer()

        def attempt():
            return self.engine.run_batch(key, stacked, timer=timer)

        def on_retry(attempt_no, exc, delay):
            self._bump("retries")

        # The batch-join span (obs.trace): ONE span per flush, parented
        # to the first traced request (whose trace natively owns the
        # shared compile/device work — "who paid") and LINKING every
        # co-batched request's root, so each of the N traces can find
        # the batch it rode.  The engine phases below run on this worker
        # thread inside this span, becoming its children.
        traces = [it.payload.get("trace") for it in live]
        primary = next((c for c in traces if c is not None), None)
        with obs_trace.span(
                "batch", parent=primary,
                links=[c for c in traces if c is not None],
                n_requests=len(live)) as bsp:
            now_ts = time.time()
            for it in live:
                c = it.payload.get("trace")
                if c is not None:
                    q = start - it.enqueued_at
                    # Synthetic queue span: enqueue → batch collect, from
                    # the batcher's own clocks, child of the request root.
                    obs_trace.emit_span(
                        "queue", trace_id=c.trace_id,
                        parent_id=c.span_id, start_ts=now_ts - q,
                        dur_s=q, request_id=it.payload["rid"])
            try:
                out, info = with_retry(attempt, self.retry_policy,
                                       on_retry=on_retry)
            except Exception as e:  # noqa: BLE001 — typed, never a hang
                bsp.set(outcome="error")
                for it in live:
                    it.slot.set(self._shed("error", it.payload["rid"],
                                           detail=repr(e)[:500],
                                           counter="rejected_error",
                                           trace=it.payload.get("trace")))
                return
            bsp.set(batch_size=info["batch_size"],
                    effective_backend=info["effective_backend"],
                    plan_key=info.get("plan_key", ""))
            phases = dict(info["phases"])
            if key.rank == 3:
                # Volumes are float fields: no u8 quantization, no
                # interleave — the (2, D, H, W) f32 block IS the
                # response body.  Rank-3 lanes are exact-key (bucket_key
                # identity), so the engine already cropped.
                u8 = None
            else:
                u8 = np.clip(np.rint(out), 0.0, 255.0).astype(np.uint8)
            for i, it in enumerate(live):
                if key.rank == 3:
                    image = np.ascontiguousarray(out[i], dtype=np.float32)
                else:
                    # Crop back to the item's own geometry: a mixed-lane
                    # flush executed at the bucket extent; the pad margin
                    # is throwaway by the bucket_key invariant.
                    h0, w0 = it.payload["planar"].shape[1:]
                    plane = u8[i][:, :h0, :w0]
                    image = (imageio.planar_to_interleaved(plane)
                             if it.payload["rgb"] else plane[0])
                queue_s = start - it.enqueued_at
                per = {"queue": round(queue_s, 6),
                       **{k: round(v, 6) for k, v in phases.items()},
                       }
                per["total"] = round(queue_s + sum(phases.values()), 6)
                c = it.payload.get("trace")
                if self.cache is not None and it.payload.get("ckey"):
                    # Store the FINAL response bytes (post-crop, post-
                    # interleave) so a later hit is byte-identical to
                    # this miss by construction; meta carries the stamps
                    # a hit Response needs to rebuild provenance.
                    self.cache.put(it.payload["ckey"], {"image": image}, {
                        "effective_backend": info["effective_backend"],
                        "effective_grid": info.get("effective_grid", ""),
                        "plan_key": info.get("plan_key", ""),
                        "overlap": bool(info.get("overlap", False)),
                        "col_mode": str(info.get("col_mode", "packed")),
                        "exchange_fraction": info.get(
                            "exchange_fraction", 0.0),
                        "exchange_hidden_fraction": info.get(
                            "exchange_hidden_fraction", 0.0),
                        "predicted_gpx_per_chip": info.get(
                            "predicted_gpx_per_chip"),
                    })
                it.slot.set(Response(
                    image=image,
                    effective_backend=info["effective_backend"],
                    backend=it.payload["backend"],
                    request_id=it.payload["rid"],
                    batch_size=info["batch_size"],
                    phases=per,
                    # Per-REQUEST provenance from admission time: an auto
                    # and an explicit request can share this entry, so
                    # the entry's build-time note cannot label them both.
                    plan_source=it.payload.get(
                        "plan_source", info.get("plan_source", "explicit")),
                    predicted_gpx_per_chip=info.get(
                        "predicted_gpx_per_chip"),
                    effective_grid=info.get("effective_grid", ""),
                    overlap=bool(info.get("overlap", False)),
                    col_mode=str(info.get("col_mode", "packed")),
                    exchange_fraction=info.get("exchange_fraction", 0.0),
                    exchange_hidden_fraction=info.get(
                        "exchange_hidden_fraction", 0.0),
                    trace_id=c.trace_id if c is not None else "",
                    plan_key=info.get("plan_key", ""),
                    cache="miss" if self.cache is not None else "off",
                    digest=it.payload.get("digest", ""),
                ))
                self._bump("completed")
                if obs_metrics.enabled():
                    ph = obs_metrics.histogram(
                        "pctpu_request_phase_seconds",
                        "per-request serving latency by phase",
                        ("phase", "backend"))
                    eff = info["effective_backend"]
                    for name, v in per.items():
                        ph.observe(v, phase=name, backend=eff)
                    obs_metrics.counter(
                        "pctpu_admission_total",
                        "typed request outcomes at the admission boundary",
                        ("outcome",)).inc(outcome="completed")
        if obs_metrics.enabled():
            obs_metrics.histogram(
                "pctpu_batch_size", "co-batched requests per flush", (),
                buckets=(1, 2, 4, 8, 16, 32, 64)).observe(len(live))

    # -- progressive convergence ---------------------------------------------
    def submit_progressive(self, req: Request, *, tol: float,
                           max_iters: int, check_every: int = 10,
                           resume: dict | None = None,
                           carry_state: bool = False):
        """Admit one progressive convergence job.

        Returns an immediate :class:`Rejected` (invalid / resharding /
        queue_full — the progressive-slot bound) or an ITERATOR of
        :class:`Snapshot` rows, one per ``check_every``-iteration chunk,
        ending with a ``final=True`` row whose image is byte-identical to
        the non-progressive run.  A job that fails mid-stream ends with a
        typed :class:`Rejected` row instead — AFTER the best-so-far
        snapshots already streamed, which is the point: a long Jacobi job
        interrupted by a fault or a mesh reshape has delivered its
        best-so-far image plus the diff trajectory, not a timeout.

        ``resume`` seeds the stream from a resume token
        instead of iteration 0: a dict with ``iters``/``work_units``
        (how far the dead stream got — a ``check_every``/V-cycle
        boundary), ``diff`` (the residual there), and ``state`` (the
        DECODED (C, H, W) float32 field; ``frontend.decode_converge``
        decodes the wire form).  ``max_iters`` keeps meaning the job's
        TOTAL budget.  The token's field reshards onto THIS service's
        grid in ``_prepare`` (crop + zero-re-pad is bit-exact — the
        checkpoint-reshard invariant), so resume works across replicas
        holding different meshes; because chunk math re-aligns on the
        same boundaries, the resumed final row is byte-identical to the
        uninterrupted run's.  ``carry_state=True`` makes every snapshot
        row carry its own token state (what a durability-aware router
        asks for via the wire's ``resume_state``).

        Progressive jobs bypass the micro-batcher (chunk fences make them
        incompatible with co-batching) and are bounded by
        ``max_progressive`` concurrent jobs; the convergence-chunk
        executables are warm-cached on the engine entry like any other
        key, so a stream of jobs for one config compiles once.
        """
        rid = req.request_id or f"r{next(self._ids)}"
        self._bump("submitted")
        parent = obs_trace.current()
        root = parent
        with obs_trace.span("admission", request_id=rid,
                            backend=req.backend, progressive=True) as asp:
            if root is None:
                root = asp.context
            asp.set(outcome="admitted")
            if self._reshaping:
                asp.set(outcome="resharding")
                return self._shed("resharding", rid,
                                  detail="mesh reshape in progress; retry",
                                  counter="rejected_resharding", trace=root)
            try:
                tol, max_iters = float(tol), int(max_iters)
                check_every = int(check_every)
                if tol < 0 or max_iters < 1 or check_every < 1:
                    raise ValueError(
                        "tol >= 0, max_iters >= 1, check_every >= 1 "
                        "required")
                # The chunk program's compile identity is check_every
                # iterations — that is what keys the warm entry.  A
                # multigrid job's cadence is the V-cycle itself, so its
                # key pins iters=1: two jobs differing only in
                # check_every must share the compiled level programs.
                key, _, planar = self._validate(
                    dataclasses.replace(
                        req, iters=(1 if req.solver == "multigrid"
                                    else check_every)),
                    progressive=True)
                resume = self._validate_resume(resume, key, planar,
                                               check_every, max_iters)
            except Exception as e:  # noqa: BLE001 — typed contract errors
                asp.set(outcome="invalid")
                return self._shed("invalid", rid, detail=str(e),
                                  counter="rejected_invalid", trace=root)
            digest, fkey = "", ""
            if self.cache is not None:
                # Convergence finals are keyed on the FIXED POINT's
                # identity — (rhs digest, tol, solver, mg_levels) plus
                # the stencil key — never on check_every/max_iters.  A
                # job whose final is cached short-circuits to the one
                # final row, even a mid-stream RESUME of it (the token
                # only says where the dead stream got to; the fixed
                # point it was walking toward is already in hand).
                digest = cache_mod.input_digest(planar)
                fkey = cache_mod.converge_key(
                    digest, tol=tol, solver=key.solver,
                    mg_levels=key.mg_levels, engine_key=key)
                got = self.cache.get(fkey)
                if got is not None:
                    asp.set(outcome="cache_hit", cache="hit",
                            digest=digest)
                    return self._hit_final_stream(got, rid, digest, root)
                asp.set(cache="miss", digest=digest)
                self._bump("cache_misses")
            with self._lock:
                # Decide under the lock, shed OUTSIDE it: _shed bumps
                # counters through _bump, which takes this same
                # (non-reentrant) lock.
                slot_free = self._progressive_active < self.max_progressive
                if slot_free:
                    self._progressive_active += 1
                    self.stats["progressive"] += 1
            if not slot_free:
                asp.set(outcome="queue_full")
                return self._shed(
                    "queue_full", rid,
                    detail=f"progressive jobs >= {self.max_progressive}",
                    counter="rejected_queue_full", trace=root)
        release = self._progressive_release()
        return ReleasingStream(
            self._progressive_stream(req, rid, key, planar, tol,
                                     max_iters, check_every, root, release,
                                     resume=resume,
                                     carry_state=carry_state,
                                     digest=digest, fkey=fkey),
            release)

    def _hit_final_stream(self, got, rid: str, digest: str, root):
        """A cached convergence final as a one-row stream (no device
        work, no progressive slot — the job never starts)."""
        arrays, meta = got
        self._bump("cache_hits")
        self._bump("completed")
        if obs_metrics.enabled():
            obs_metrics.counter(
                "pctpu_admission_total",
                "typed request outcomes at the admission boundary",
                ("outcome",)).inc(outcome="cache_hit")
            obs_events.emit(
                "admission", outcome="cache_hit", request_id=rid,
                digest=digest[:16], progressive=True,
                **({"trace_id": root.trace_id} if root is not None
                   else {}))
        row = Snapshot(
            image=np.array(arrays["image"]),
            iters=int(meta.get("iters", 0)),
            diff=float(meta.get("diff", 0.0)), final=True,
            converged=True, request_id=rid,
            effective_backend=str(meta.get("effective_backend", "")),
            effective_grid=str(meta.get("effective_grid", "")),
            plan_key=str(meta.get("plan_key", "")),
            trace_id=root.trace_id if root is not None else "",
            solver=str(meta.get("solver", "jacobi")),
            work_units=float(meta.get("work_units", 0.0)),
            mg_levels=meta.get("mg_levels"),
            col_mode=str(meta.get("col_mode", "packed")),
            cache="hit", digest=digest)

        def gen():
            yield row

        return ReleasingStream(gen(), lambda: None)

    @staticmethod
    def _validate_resume(resume, key, planar, check_every, max_iters):
        """Normalize/validate one resume token against the admitted key
        (terminal ValueError → the typed ``invalid`` rejection).
        Returns ``None`` or ``{"iters", "diff", "work_units", "state"}``
        with ``state`` a (C, H, W) float32 array."""
        if resume is None:
            return None
        state = np.asarray(resume.get("state"), dtype=np.float32)
        if state.shape != tuple(planar.shape):
            raise ValueError(
                f"resume state shape {state.shape} does not match the "
                f"request's planar shape {tuple(planar.shape)}")
        iters = int(resume.get("iters", 0))
        wu = float(resume.get("work_units", iters))
        diff = float(resume.get("diff", float("inf")))
        if iters < 0 or wu < 0:
            raise ValueError(
                f"resume iters/work_units must be >= 0, got "
                f"{iters}/{wu}")
        if (key.solver == "jacobi" and iters % max(1, check_every)
                and iters != int(max_iters)):
            # Tokens are minted on chunk boundaries; an off-boundary
            # token would silently change the remaining chunk math and
            # break the byte-identity contract — reject it typed.  The
            # one legitimate off-multiple boundary is max_iters itself:
            # the final chunk is short when the budget is not a
            # check_every multiple, and its token (a stream that died
            # between the last snapshot and the final row) must resume.
            raise ValueError(
                f"resume iters={iters} is not a check_every="
                f"{check_every} boundary")
        return {"iters": iters, "diff": diff, "work_units": wu,
                "state": state}

    def _progressive_release(self):
        """One idempotent slot-release closure per admitted job: called
        by the stream generator's ``finally`` AND by the wrapper's
        close/finalizer, whichever comes first."""
        released: list = []

        def release() -> None:
            with self._lock:
                if not released:
                    released.append(True)
                    self._progressive_active -= 1

        return release

    def _progressive_stream(self, req, rid, key, planar, tol, max_iters,
                            check_every, root, release, resume=None,
                            carry_state=False, digest="", fkey=""):
        """The admitted job's generator (runs on the CONSUMER's thread)."""
        from parallel_convolution_tpu_torch.utils import imageio

        rgb = (key.rank == 2
               and np.asarray(req.image).ndim == 3)
        grid = f"{key.grid[0]}x{key.grid[1]}"
        tid = root.trace_id if root is not None else ""

        def to_u8(plane):
            if key.rank == 3:
                # Volumes stream as float fields: the (2, D, H, W) f32
                # block passes through untouched (no u8, no interleave).
                return np.ascontiguousarray(plane, dtype=np.float32)
            u8 = np.clip(np.rint(plane), 0.0, 255.0).astype(np.uint8)
            return imageio.planar_to_interleaved(u8) if rgb else u8[0]

        try:
            try:
                entry = self.engine.entry(key)
            except Exception as e:  # noqa: BLE001 — typed, never a leak
                yield self._shed("error", rid, detail=repr(e)[:300],
                                 counter="rejected_error", trace=root)
                return
            # A resumed job seeds from the token's field and counters
            # instead of iteration 0; `last*` start at the token so a
            # token that already met the budget/tolerance still emits
            # its (byte-identical) final row below.
            start_field, start_done, start_wu = planar, 0, 0.0
            last_out, last = None, None
            if resume is not None:
                start_field = resume["state"]
                start_done = resume["iters"]
                start_wu = resume["work_units"]
                last_out = start_field
                last = (start_done, resume["diff"], start_wu)
            with obs_trace.attach(root), obs_trace.span(
                    "progressive", request_id=rid, backend=req.backend,
                    check_every=check_every,
                    resumed_at=start_done) as psp:
                try:
                    # The consumer's thread (an HTTP handler) drives the
                    # stream: _stepwise makes the grid's card current
                    # around every step of it.
                    for out, done, diff, wu in self.engine._stepwise(
                            self.engine.run_converge(
                                key, start_field, tol=tol,
                                max_iters=max_iters,
                                check_every=check_every,
                                start_done=start_done, start_wu=start_wu,
                                start_diff=(last[1] if last is not None
                                            else float("inf")))):
                        last_out, last = out, (done, diff, wu)
                        yield Snapshot(
                            image=to_u8(out), iters=done, diff=diff,
                            request_id=rid,
                            effective_backend=entry.effective_backend,
                            effective_grid=grid, plan_key=entry.plan_key,
                            trace_id=tid, solver=key.solver,
                            work_units=round(float(wu), 3),
                            mg_levels=entry.mg_levels,
                            col_mode=entry.effective_col_mode,
                            state=(out if carry_state else None))
                except Exception as e:  # noqa: BLE001 — typed stream end
                    reason = ("resharding"
                              if ("resharded" in str(e) or self._reshaping)
                              else "error")
                    psp.set(outcome=reason)
                    yield self._shed(
                        reason, rid, detail=repr(e)[:300],
                        counter=f"rejected_{reason}", trace=root)
                    return
                converged = last is not None and last[1] < tol
                psp.set(outcome="completed",
                        iters=last[0] if last else 0, converged=converged)
                final_u8 = to_u8(last_out)
                if self.cache is not None and fkey and converged:
                    # Only CONVERGED finals are cacheable: an exhausted-
                    # budget final depends on max_iters, which is not
                    # part of the fixed point's key.
                    self.cache.put(fkey, {"image": final_u8}, {
                        "iters": last[0] if last else 0,
                        "diff": last[1] if last else 0.0,
                        "effective_backend": entry.effective_backend,
                        "effective_grid": grid,
                        "plan_key": entry.plan_key,
                        "solver": key.solver,
                        "work_units": (round(float(last[2]), 3)
                                       if last else 0.0),
                        "mg_levels": entry.mg_levels,
                        "col_mode": entry.effective_col_mode,
                    })
                yield Snapshot(
                    image=final_u8, iters=last[0] if last else 0,
                    diff=last[1] if last else 0.0, final=True,
                    converged=converged, request_id=rid,
                    effective_backend=entry.effective_backend,
                    effective_grid=grid, plan_key=entry.plan_key,
                    trace_id=tid, solver=key.solver,
                    work_units=round(float(last[2]), 3) if last else 0.0,
                    mg_levels=entry.mg_levels,
                    col_mode=entry.effective_col_mode,
                    cache="miss" if self.cache is not None else "off",
                    digest=digest)
                self._bump("completed")
        finally:
            release()

    # -- elastic recovery ----------------------------------------------------
    def reshape(self, grid) -> dict:
        """Shrink (or otherwise re-grid) the serving grid WITHOUT a
        process restart — the serve-through-shrink leg of elastic
        recovery.  ``grid`` is a ``mesh.Grid`` or an ``"RxC"`` spec
        string, which becomes a grid in the current one's form
        (``mesh.grid_like``: one device, or a slot per block over the
        same devices).

        Sequence, in order (each step's invariant):

        1. flag ``resharding`` — new submissions shed with a typed,
           retryable ``Rejected("resharding")`` (never an error, never a
           hang);
        2. drain the batcher — every in-flight/queued request completes
           on the OLD grid (its response stamps the old
           ``effective_grid``), and the single worker thread exits, so
           no execution can straddle the swap;
        3. ``engine.reshape`` — warm entries drop, the mesh swaps, the
           previously-resident keys re-warm on the new grid;
        4. a fresh batcher starts and admission reopens.

        Requests admitted afterwards re-key against the new mesh in
        ``_validate`` (``engine.resolve_key`` reads the live grid), so
        their responses stamp the new ``effective_grid``.
        """
        from parallel_convolution_tpu_torch.parallel.mesh import (
            Grid, grid_like,
        )
        from parallel_convolution_tpu_torch.resilience.elastic import (
            parse_spec,
        )

        # A malformed spec or grid dies HERE, before any teardown.
        if isinstance(grid, str):
            grid = grid_like(self.engine.grid, parse_spec(grid))
        if not isinstance(grid, Grid):
            raise TypeError(f"reshape takes a Grid or an 'RxC' spec, got "
                            f"{type(grid).__name__}")
        with self._reshape_lock:
            self._reshaping = True
            try:
                old = self.batcher
                old.close(drain=True)
                try:
                    info = self.engine.reshape(grid)
                finally:
                    # Admission must reopen even if the engine swap blew
                    # up (per-key re-warm failures are absorbed inside
                    # reshape; anything else must not wedge the service
                    # behind a closed batcher forever).
                    self.batcher = self._make_batcher(
                        old.max_batch, old.max_delay_s, old.max_queue,
                        start=True)
                    self.pricer = self._make_pricer()
                self._bump("reshapes")
                if self.cache is not None:
                    # Cached metadata stamps the OLD grid's provenance
                    # (effective_grid, plan_key); serving it after the
                    # swap would lie.  Every drop is journaled dead
                    # (write-ahead), so a restart cannot resurrect them.
                    self.cache.invalidate_all()
            finally:
                self._reshaping = False
        return info

    # -- lifecycle / introspection -------------------------------------------
    def warmup(self, configs, plan_file: str | None = None) -> list[str]:
        """Pre-compile declared configs before taking traffic.

        ``configs`` are dicts with ``rows``/``cols``/``mode`` plus any
        :class:`Request` knobs (filter, iters, backend, storage, fuse,
        boundary, quantize — plus ``tile``); returns each config's
        effective backend.  ``backend="auto"`` configs (and later auto
        requests) resolve through ``plan_file`` when given (the tuner's
        emitted plans — the service boots already tuned), else the
        ambient/engine plan cache, else the cost model.
        """
        if plan_file is not None:
            from parallel_convolution_tpu_torch.tuning import PlanCache

            self.engine.plans = PlanCache.load(plan_file)
        keys = []
        for c in configs:
            channels = 3 if c.get("mode", "grey") == "rgb" else 1
            fuse = c.get("fuse", 1)
            tile = c.get("tile")
            overlap = c.get("overlap")
            keys.append(self.engine.key_for(
                (channels, int(c["rows"]), int(c["cols"])),
                filter_name=c.get("filter", c.get("filter_name", "blur3")),
                storage=c.get("storage", "f32"),
                iters=int(c.get("iters", 1)),
                fuse=None if fuse is None else int(fuse),
                tile=None if tile is None else tuple(int(v) for v in tile),
                boundary=c.get("boundary", "zero"),
                quantize=bool(c.get("quantize", True)),
                backend=c.get("backend", "shifted"),
                # Knob parity with the request path (resolve_key settles
                # both pre-keying): a pre-warmed key must be EXACTLY the
                # key the live request will hit, or warm placement
                # compiles the wrong program and the join pays a compile
                # storm anyway.
                overlap=None if overlap is None else bool(overlap),
                col_mode=(None if c.get("col_mode") is None
                          else str(c.get("col_mode")))))
        return self.engine.warmup(keys)

    def fence(self, epoch: int, shard=None) -> int:
        """Ratchet the router-epoch fence for ``shard`` (the empty /
        ``None`` label is the unsharded lineage) to at least ``epoch``
        (the takeover propagation call — ``POST /v1/fence``); returns
        the fence after ratcheting.  Never lowers it.  Fences are
        PER-SHARD: sweeping shard A leaves shard B's ratchet alone."""
        e = int(epoch)
        s = "" if shard is None else str(shard)
        with self._lock:
            if e > self._fences.get(s, 0):
                self._fences[s] = e
            return self._fences.get(s, 0)

    def fence_epoch(self, shard=None) -> int:
        s = "" if shard is None else str(shard)
        with self._lock:
            return self._fences.get(s, 0)

    def fence_epochs(self) -> dict:
        """Every shard's fence (the recovery read for a multi-lineage
        takeover; key "" is the unsharded legacy ratchet)."""
        with self._lock:
            return dict(self._fences)

    def epoch_gate(self, epoch, shard=None) -> tuple[bool, int]:
        """Admission-time fencing: ``(admit, current_fence)``, scoped
        to ``shard``'s ratchet (``None``/"" = the unsharded lineage).

        ``None`` epoch (a direct client, no router in the path) always
        admits.  A NEWER epoch ratchets the fence and admits — the
        first request from a freshly taken-over router is itself the
        fence propagation.  A STALE epoch is refused (counted,
        evented): the caller sheds it typed non-retryable
        ``stale_epoch`` before any queueing or device work.
        """
        s = "" if shard is None else str(shard)
        if epoch is None:
            with self._lock:
                return True, self._fences.get(s, 0)
        try:
            e = int(epoch)
        except (TypeError, ValueError):
            with self._lock:
                return True, self._fences.get(s, 0)
        with self._lock:
            if e > self._fences.get(s, 0):
                self._fences[s] = e
            ok = e >= self._fences.get(s, 0)
            if not ok:
                self.stats["rejected_stale_epoch"] += 1
            cur = self._fences.get(s, 0)
        if not ok and obs_metrics.enabled():
            obs_metrics.counter(
                "pctpu_stale_epoch_rejects_total",
                "requests refused for carrying a fenced-out router "
                "epoch (zombie active after a takeover)").inc()
            obs_events.emit("router", event="stale_epoch",
                            epoch=e, fence=cur, shard=s)
        return ok, cur

    def readiness(self) -> tuple[bool, dict]:
        """The ``/readyz`` verdict: can this service usefully take a NEW
        request right now?

        Not ready while a mesh reshape is in progress (submissions shed
        ``resharding``) or while the queue is at its admission bound
        (submissions shed ``queue_full``) — exactly the two states where
        a replica router (ROADMAP item 8b) should steer traffic
        elsewhere.  A DEGRADED backend tier keeps readiness true (the
        service is serving, on a lower tier) but is reported in the
        payload so the router can prefer healthy replicas.
        """
        depth = self.batcher.depth()
        bound = self.batcher.max_queue
        degraded = self.engine.degraded()
        ready = not self._reshaping and depth < bound
        warm_keys = self.engine.warm_key_count()
        return ready, {
            "ready": ready,
            "reshaping": bool(self._reshaping),
            "queue_depth": depth,
            "queue_bound": bound,
            "queue_full": depth >= bound,
            # In-flight work the batcher can't see: progressive streams
            # run on consumer threads — the autoscaler's pressure signal
            # must count them or converge load never scales the pool.
            "progressive_active": self._progressive_active,
            "progressive_bound": self.max_progressive,
            "warm_keys": warm_keys,
            "degraded": degraded,
            # The router-epoch fence: a recovering router
            # reads this off every replica to place its own epoch ABOVE
            # anything any previous active ever stamped; fence_epochs is
            # the full per-shard map, the scalar stays the unsharded
            # lineage's ratchet for wire compatibility.
            "fence_epoch": self.fence_epoch(),
            "fence_epochs": self.fence_epochs(),
            "grid": "x".join(str(v) for v in self.engine.grid_shape()),
        }

    def snapshot(self) -> dict:
        with self._lock:
            stats = dict(self.stats)
        snap = self.engine.snapshot()
        dev = self.engine.grid.device
        return {
            "service": stats,
            "batcher": dict(self.batcher.stats),
            "engine": snap["stats"],
            "cache": (self.cache.snapshot()
                      if self.cache is not None else None),
            "resident": snap["resident"],
            "queue_depth": self.batcher.depth(),
            "mesh": "x".join(str(v) for v in self.engine.grid_shape()),
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "device_kind": device_kind(dev),
            "fence_epoch": self.fence_epoch(),
            "fence_epochs": self.fence_epochs(),
            # Topology identity (utils.platform.topology): a row of a
            # grid over processes never shares a baseline with a
            # one-process row.
            **topology(self.engine.grid),
        }

    def close(self) -> None:
        self.batcher.close()
