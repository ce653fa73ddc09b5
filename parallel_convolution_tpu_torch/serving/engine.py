"""Warm engine: build once per key, serve many times (the JAX package's
``serving/engine.py`` on the port's step builders).

A one-shot entry point (the CLI's ``run``) resolves its knobs, probes its
backend and builds its step closures on every call; a service pays that
once per *configuration* and amortizes it across the request stream (the
persistent-channel idea of "Persistent and Partitioned MPI for Stencil
Communication", PAPERS.md: set the schedule up once, reuse it).

What "warm" means here.  The JAX engine compiles one jit a (key, batch
size) and runs it once.  The port compiles nothing a call: its warm entry
holds what the port builds once, and runs one batch at build time so that
every one of those exists before the first request:

* the runner of each batch size (``parallel.step._build_iterate``: the
  resolved steps of the backend) and of each converge chunk length
  (``_build_converge_chunk``); the multigrid level programs
  (``solvers.multigrid``, built at the first stream of a key and kept on
  its entry);
* the process caches they fill on that first run: the kernels' nvcc
  libraries (``ops/_build.py``), K1's launch plan for the batch's shape
  (``ops/stencil.py``), the channel plans, and the degrade probe's verdict
  (``resilience.degrade``).

A warm request therefore shows no ``compile`` event
(``obs.events.note_compile``), and ``stats`` counts as JAX's does:
``compiles`` is one a runner built.

Design points, as in the JAX package:

* **Key = full build identity.**  :class:`EngineKey` carries everything
  that changes what is built: one request's image shape, filter, storage,
  iteration count, fuse, boundary, quantize, the backend (the port's
  names, ``utils/config.py``), tile, overlap and column transport (both
  resolved before keying), solver, and the engine grid's shape.
* **LRU eviction** at ``capacity`` keys; **per-key single flight**: a cold
  key builds once however many threads ask for it.
* **Degradation per key**: with ``fallback=True`` the backend is resolved
  through the degrade walk (``cuda_rdma → cuda``; on the card a refused
  ``cuda`` raises), and every response stamps ``effective_backend``.
* **Batches fold** B same-key images onto the plane axis, ``(B, C, H, W)
  → (B·C, H, W)``: planes are independent in the stencil, so a batch gives
  each image's bytes, and the kernels launch as for one image of B·C
  planes.

Threads.  The batcher runs the engine on its executor thread; CUDA's
current device is per thread, so every piece of device work here runs
under ``torch.cuda.device(grid.device)`` (the per-slot streams of
``cuda_rdma`` are made on each slot's own device).  A key of another
grid than the engine's (after :meth:`WarmEngine.reshape`) raises: it
never runs on the wrong decomposition.

Entry points run on the card by default and raise without CUDA
(``WarmEngine(device="cpu")`` runs the plain versions on the CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import OrderedDict

import numpy as np
import torch

from parallel_convolution_tpu_torch.obs import (
    events as obs_events, metrics as obs_metrics, trace as obs_trace,
)
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.utils.config import (
    AUTO, BOUNDARIES, COL_MODES, RANKS, SOLVERS, STORAGES, VOLUME_FIELDS,
    VOLUME_RADII, check_backend,
)
from parallel_convolution_tpu_torch.utils.tracing import PhaseTimer

__all__ = ["EngineKey", "WarmEngine", "bucket_extent", "bucket_key"]


@dataclasses.dataclass(frozen=True)
class EngineKey:
    """The build identity of one servable configuration.

    ``shape`` is ONE request's planar image shape (C, H, W); the batch
    size is not part of the key (the runners a batch size live inside the
    key's entry).  ``grid`` pins the engine grid's shape the entry was
    built for, so a key from before a reshape can never run on the new
    grid.  ``backend`` takes the port's names (``cuda`` / ``cuda_sep`` /
    ``cuda_rdma`` for the JAX package's ``pallas`` / ``pallas_sep`` /
    ``pallas_rdma``; ``auto`` is resolved before keying).
    """

    shape: tuple[int, int, int]      # (C, H, W) of one request
    filter_name: str = "blur3"
    storage: str = "f32"
    iters: int = 1
    fuse: int = 1
    boundary: str = "zero"
    quantize: bool = True
    backend: str = "shifted"         # requested; the entry records effective
    grid: tuple[int, int] = (1, 1)   # the engine grid's (rows, cols)
    tile: tuple[int, int] | None = None  # the CUDA kernels' output tile
    overlap: bool = False            # RESOLVED overlapped pipeline knob
    col_mode: str = "packed"         # RESOLVED column-slab transport
    solver: str = "jacobi"           # convergence strategy (SOLVERS)
    mg_levels: int | None = None     # multigrid level-count cap
    rank: int = 2                    # 3 keys a VOLUME: shape (D, H, W) of
    #                                  one two-field volume, filter_name a
    #                                  rank-3 form (volumes.driver)

    def validate(self) -> None:
        """Terminal (ValueError) on any out-of-registry field, with the JAX
        key's checks."""
        if self.rank not in RANKS:
            raise ValueError(f"rank must be one of {RANKS}, "
                             f"got {self.rank}")
        if self.rank == 3:
            self._validate_volume()
            return
        get_filter(self.filter_name)  # raises on unknown names
        check_backend(self.backend)  # names the port's name for JAX's
        if self.storage not in STORAGES:
            raise ValueError(f"unknown storage {self.storage!r}")
        if self.boundary not in BOUNDARIES:
            raise ValueError(f"unknown boundary {self.boundary!r}")
        if self.storage == "u8" and not self.quantize:
            raise ValueError("storage='u8' requires quantize=True")
        if len(self.shape) != 3 or min(self.shape) < 1:
            raise ValueError(f"bad planar shape {self.shape}")
        if self.iters < 1 or self.fuse < 1:
            raise ValueError("iters and fuse must be >= 1")
        if self.tile is not None and (
                len(self.tile) != 2 or min(self.tile) < 1):
            raise ValueError(f"tile must be two positive ints, "
                             f"got {self.tile}")
        if self.col_mode not in COL_MODES:
            raise ValueError(
                f"unknown col_mode {self.col_mode!r} (auto is resolved "
                "in key_for, never stored in a key)")
        if self.solver not in SOLVERS:
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.mg_levels is not None and int(self.mg_levels) < 1:
            raise ValueError(f"mg_levels must be >= 1, got {self.mg_levels}")
        if self.solver == "multigrid":
            if self.quantize:
                raise ValueError("solver='multigrid' requires "
                                 "quantize=False")
            if self.storage != "f32":
                raise ValueError("solver='multigrid' requires "
                                 "storage='f32'")

    def _validate_volume(self) -> None:
        """Rank-3 key constraints: ``shape`` (D, H, W) of one two-field
        volume, ``filter_name`` a registered rank-3 form, float fields,
        the chunked-Jacobi driver, no tile, overlap or column A/B."""
        from parallel_convolution_tpu_torch.parallel import (
            kernels as kernel_forms,
        )

        if self.boundary not in BOUNDARIES:
            raise ValueError(f"unknown boundary {self.boundary!r}")
        kernel_forms.resolve(3, self.filter_name, self.boundary)
        check_backend(self.backend)
        if len(self.shape) != 3 or min(self.shape) < 1:
            raise ValueError(f"bad volume shape {self.shape} "
                             "(want (D, H, W))")
        if self.iters < 1 or self.fuse < 1:
            raise ValueError("iters and fuse must be >= 1")
        if self.quantize or self.storage != "f32":
            raise ValueError("rank-3 volumes are float fields: "
                             "storage='f32' and quantize=False required")
        if self.solver != "jacobi":
            raise ValueError("rank-3 convergence is the chunked-jacobi "
                             f"driver; solver={self.solver!r} is rank-2 "
                             "only")
        if self.tile is not None or self.overlap:
            raise ValueError("rank-3 keys have no kernel tile or "
                             "overlapped-halo form")
        if self.col_mode != "packed":
            raise ValueError("rank-3 keys use the canonical 'packed' "
                             "column transport label")


# Shape-bucket extent ladder for lane co-batching (the JAX package's):
# dense at thumbnail sizes, sparse above, capped pad waste (~1.33x worst
# case per dim between rungs).
_BUCKET_LADDER = (8, 16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768,
                  1024, 1280, 1536, 1920, 2048, 2560, 3072, 4096)


def bucket_extent(v: int) -> int:
    """Round one spatial extent UP to its lane bucket rung (above the
    ladder: the next multiple of 1024)."""
    v = int(v)
    for rung in _BUCKET_LADDER:
        if v <= rung:
            return rung
    step = 1024
    return ((v + step - 1) // step) * step


def bucket_key(key):
    """The LANE a key batches under: ``key`` itself unless pad-to-bucket
    co-batching is byte-identical, which holds only for one Jacobi
    iteration under a zero boundary (the zero margin is read as the zero
    it is, and the crop discards it); rank-3 keys get exact-key lanes."""
    if not isinstance(key, EngineKey):
        return key
    if key.rank != 2:
        return key
    if key.iters != 1 or key.boundary != "zero" or key.solver != "jacobi":
        return key
    c, h, w = key.shape
    bh, bw = bucket_extent(h), bucket_extent(w)
    if (bh, bw) == (h, w):
        return key
    return dataclasses.replace(key, shape=(c, bh, bw))


class _Entry:
    """One warm key: the resolved backend and its runners per batch size
    and per converge chunk length."""

    __slots__ = ("key", "effective_backend", "fns", "lock", "plan_source",
                 "predicted_gpx", "plan_key", "effective_overlap",
                 "effective_col_mode", "splits", "compile_ref",
                 "converge_fns", "mg_levels", "mg_programs", "compiles")

    def __init__(self, key: EngineKey, effective_backend: str,
                 plan_source: str = "explicit",
                 predicted_gpx: float | None = None,
                 plan_key: str = ""):
        from parallel_convolution_tpu_torch.parallel import (
            kernels as kernel_forms, step as step_lib,
        )

        self.key = key
        self.effective_backend = effective_backend
        # The knobs the runners are built with: the key's resolved values,
        # re-clamped to the tier the degrade walk landed on (only
        # cuda_rdma has the overlapped form and a column transport).
        self.effective_overlap = kernel_forms.clamp_overlap(
            bool(key.overlap), effective_backend)
        self.effective_col_mode = step_lib.clamp_col_mode(
            key.col_mode, effective_backend)
        self.plan_source = plan_source
        self.predicted_gpx = predicted_gpx
        self.plan_key = plan_key
        self.compile_ref: dict | None = None  # the leader's build span
        self.mg_levels: int | None = None  # levels the planner scheduled
        self.mg_programs: dict = {}   # multigrid level programs, kept
        #                               across this key's streams
        self.compiles = 0   # runners built for this key
        self.fns: dict[int, object] = {}   # batch size -> runner
        self.converge_fns: dict[int, object] = {}  # chunk length -> chunk
        self.splits: dict[int, dict] = {}  # batch size -> exchange split
        self.lock = threading.Lock()       # per-entry build flight


class _InFlight:
    """A cold key's build in progress: leader fills, waiters wait."""

    __slots__ = ("event", "entry", "error", "span_ref")

    def __init__(self):
        self.event = threading.Event()
        self.entry: _Entry | None = None
        self.error: BaseException | None = None
        self.span_ref: dict | None = None


def _drop(entry: _Entry) -> None:
    """An entry's multigrid level runs end when it is evicted or the
    engine reshapes (``multigrid.close_programs``: over several processes
    a collective, which every rank reaches at the same call of the same
    sequence)."""
    if entry.mg_programs:
        from parallel_convolution_tpu_torch.solvers import multigrid

        multigrid.close_programs(entry.mg_programs)


def _stale(key: EngineKey, shape) -> ValueError:
    return ValueError(f"stale key grid {key.grid}: engine mesh is now "
                      f"{tuple(shape)} (resharded mid-process)")


class WarmEngine:
    """Warm-runner cache over ``parallel.step`` for one grid.

    ``grid`` defaults to 1×1 on ``device`` (default: the card; it raises
    without CUDA, ``device="cpu"`` runs the plain versions); a grid of
    slots (``mesh.make_grid(devices=...)``) runs each block on its slot's
    device.  On a grid over several processes the JAX package's
    multi-controller contract holds: every rank builds the same engine and
    calls ``run_batch`` / ``run_converge`` / ``reshape`` with the same keys
    and payloads in the same order, and every rank gets the result (rank
    0's is the answer; the HTTP service stays one process).  ``plans``: a
    ``tuning.PlanCache`` or a plan file's path for ``backend="auto"`` keys
    (None: ``PCTPU_PLAN_FILE``, else the cost model).
    """

    def __init__(self, grid=None, capacity: int = 16, fallback: bool = True,
                 plans=None, device=None):
        from parallel_convolution_tpu_torch.parallel.mesh import make_grid

        if grid is None:
            grid = make_grid(device=device)
        elif device is not None and grid.device != torch.device(device):
            raise ValueError(f"grid is on {grid.device}, device={device!r}")
        self.grid = grid
        self.capacity = max(1, int(capacity))
        self.fallback = fallback
        if isinstance(plans, str):
            from parallel_convolution_tpu_torch.tuning import PlanCache

            plans = PlanCache.load(plans)
        self.plans = plans
        self._lock = threading.Lock()
        self._entries: OrderedDict[EngineKey, _Entry] = OrderedDict()
        self._inflight: dict[EngineKey, _InFlight] = {}
        self._plan_sources: dict[EngineKey, str] = {}
        # The JAX engine's stats dict, a view over the obs registry
        # (pctpu_engine_stats{key=...}).
        self.stats = obs_metrics.MirroredStats(obs_metrics.gauge(
            "pctpu_engine_stats", "warm-engine cache/execution counters",
            ("key",)), initial={
            "hits": 0, "misses": 0, "compiles": 0, "evictions": 0,
            "single_flight_waits": 0, "batches": 0, "images": 0,
            "reshapes": 0,
        })

    def grid_shape(self) -> tuple[int, int]:
        """The engine grid's (rows, cols) (the JAX engine's ``grid()``)."""
        return tuple(self.grid.shape)

    # -- the card --------------------------------------------------------
    def _on_device(self):
        """The grid's card as this thread's current device (CUDA's current
        device is per thread; the batcher calls from its own)."""
        if self.grid.device.type == "cuda":
            return torch.cuda.device(self.grid.device)
        return contextlib.nullcontext()

    def _sync(self) -> None:
        """Wait for every card of the grid (the run's fence)."""
        for dev in self.grid.local_devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _stepwise(self, gen):
        """Drive ``gen`` with the grid's card current around each step
        (a generator may be resumed on another thread)."""
        while True:
            with self._on_device():
                try:
                    item = next(gen)
                except StopIteration:
                    return
            yield item

    # -- elastic recovery -------------------------------------------------
    def reshape(self, grid) -> dict:
        """Re-bind the engine onto another grid MID-PROCESS (a
        :class:`~parallel_convolution_tpu_torch.parallel.mesh.Grid`, or an
        ``"RxC"`` spec in the current grid's form, ``mesh.grid_like``).

        Drops every warm entry (built for the old grid), swaps the grid,
        and re-warms the previously resident keys on the new one, so the
        first request after a shrink is warm.  A key whose image has no
        home on the new grid (block < radius·fuse) is SKIPPED with a
        warning, never fatal.  The caller quiesces execution first; a
        stale-grid key reaching :meth:`run_batch` afterwards raises
        (terminal).  Returns ``{"old_grid", "grid", "rewarmed",
        "skipped"}``."""
        import warnings

        from parallel_convolution_tpu_torch.parallel.mesh import grid_like

        if isinstance(grid, str):
            from parallel_convolution_tpu_torch.resilience.elastic import (
                parse_spec,
            )

            grid = grid_like(self.grid, parse_spec(grid))
        new_grid = tuple(grid.shape)
        with self._lock:
            old_grid = self.grid_shape()
            old_keys = list(self._entries)
            for e in self._entries.values():
                _drop(e)
            self._entries.clear()
            self._plan_sources.clear()
            self._inflight.clear()
            self.grid = grid
            self.stats["reshapes"] += 1
        rewarmed, skipped = [], []
        for k in old_keys:
            nk = dataclasses.replace(k, grid=new_grid)
            try:
                self.entry(nk)
                rewarmed.append(nk)
            except Exception as e:  # noqa: BLE001 — per-key, never fatal
                skipped.append((nk, repr(e)[:200]))
                warnings.warn(
                    f"reshape: key {k.filter_name}/{k.shape} has no home "
                    f"on grid {new_grid}: {e}", stacklevel=2)
        info = {
            "old_grid": old_grid, "grid": new_grid,
            "rewarmed": len(rewarmed), "skipped": len(skipped),
        }
        if obs_metrics.enabled():
            obs_events.emit(
                "reshape", old_grid=f"{old_grid[0]}x{old_grid[1]}",
                grid=f"{new_grid[0]}x{new_grid[1]}",
                rewarmed=info["rewarmed"], skipped=info["skipped"])
        return info

    # -- key construction -------------------------------------------------
    def resolve_key(self, shape, **kw) -> tuple[EngineKey, str]:
        """``(EngineKey, plan_source)`` on this engine's grid.

        ``backend="auto"`` (with ``fuse=None`` / ``tile=None`` meaning
        'tune it') resolves through ``tuning.resolve`` here, so an auto
        request and an explicit request for the tuned configuration share
        one key.  ``overlap`` and ``col_mode`` are settled before keying
        (``step.resolve_overlap`` / ``step.resolve_col_mode``), and fuse is
        clamped to the iteration count, so equal runners get equal keys.
        """
        from parallel_convolution_tpu_torch.parallel import step as step_lib
        from parallel_convolution_tpu_torch.parallel.mesh import (
            padded_extent,
        )

        kw = dict(kw)
        plan_source = "explicit"
        grid_shape = self.grid_shape()
        if int(kw.get("rank", 2)) == 3:
            # No tuning space: "auto" normalizes to the canonical label and
            # the knobs to their clamped values.
            if kw.get("backend") in (None, AUTO):
                kw["backend"] = "shifted"
            kw["overlap"] = bool(kw.get("overlap") or False)
            kw["col_mode"] = ("packed" if kw.get("col_mode") in
                              (None, "auto") else kw["col_mode"])
            kw["fuse"] = max(1, int(kw.get("fuse") or 1))
            key = EngineKey(shape=tuple(int(s) for s in shape),
                            grid=grid_shape, **kw)
            if key.fuse > max(1, key.iters):
                key = dataclasses.replace(key, fuse=max(1, key.iters))
            return key, "explicit"
        if kw.get("backend") == AUTO:
            from parallel_convolution_tpu_torch import tuning

            res = tuning.resolve(
                self.grid, get_filter(kw.get("filter_name", "blur3")),
                tuple(int(s) for s in shape),
                storage=kw.get("storage", "f32"),
                quantize=bool(kw.get("quantize", True)),
                boundary=kw.get("boundary", "zero"),
                fuse=kw.get("fuse"), tile=kw.get("tile"),
                overlap=kw.get("overlap"), plans=self.plans)
            kw["backend"] = res.backend
            kw["fuse"], kw["tile"] = res.fuse, res.tile
            kw["overlap"] = res.overlap
            if kw.get("col_mode") in (None, "auto"):
                kw["col_mode"] = res.col_mode
            plan_source = res.source
        backend = kw.get("backend", "shifted")
        kw["overlap"] = step_lib.resolve_overlap(kw.get("overlap"), backend,
                                                 self.grid)
        (_, H, W) = tuple(int(s) for s in shape)
        R, C = grid_shape
        filt = get_filter(kw.get("filter_name", "blur3"))
        kw["col_mode"] = step_lib.resolve_col_mode(
            kw.get("col_mode"), backend, self.grid,
            (padded_extent(H, R) // R, padded_extent(W, C) // C),
            filt.radius, max(1, int(kw.get("fuse") or 1)),
            kw.get("storage", "f32"))
        if kw.get("fuse") is None and "fuse" in kw:
            raise ValueError(
                "fuse=None means 'tune it' and needs backend='auto'")
        if kw.get("tile") is not None:
            kw["tile"] = tuple(int(v) for v in kw["tile"])
        key = EngineKey(shape=tuple(int(s) for s in shape),
                        grid=grid_shape, **kw)
        if key.fuse > max(1, key.iters):
            key = dataclasses.replace(key, fuse=max(1, key.iters))
        if plan_source != "explicit":
            with self._lock:
                self._plan_sources[key] = plan_source
                limit = max(64, 4 * self.capacity)
                while len(self._plan_sources) > limit:
                    self._plan_sources.pop(next(iter(self._plan_sources)))
        return key, plan_source

    def key_for(self, shape, **kw) -> EngineKey:
        """:meth:`resolve_key` without the provenance."""
        return self.resolve_key(shape, **kw)[0]

    # -- entry acquisition (LRU + single flight) ---------------------------
    def entry(self, key: EngineKey) -> _Entry:
        """The warm entry for ``key``; built (single flight) when cold."""
        while True:
            with self._lock:
                e = self._entries.get(key)
                if e is not None:
                    self._entries.move_to_end(key)
                    self.stats["hits"] += 1
                    return e
                fl = self._inflight.get(key)
                if fl is None:
                    fl = _InFlight()
                    self._inflight[key] = fl
                    self.stats["misses"] += 1
                    leader = True
                else:
                    self.stats["single_flight_waits"] += 1
                    leader = False
            if not leader:
                fl.event.wait()
                if fl.error is not None:
                    raise fl.error
                if fl.span_ref is not None:
                    obs_trace.add_link(fl.span_ref, kind="single_flight")
                with self._lock:
                    e = self._entries.get(key)
                    if e is not None:
                        self._entries.move_to_end(key)
                        return e
                continue
            try:
                with obs_trace.span(
                        "compile_build", backend=key.backend,
                        filter=key.filter_name, fuse=key.fuse,
                        shape=list(key.shape)) as bsp:
                    entry = self._build_entry(key)
                    entry.compile_ref = fl.span_ref = bsp.ref
            except BaseException as err:
                fl.error = err
                with self._lock:
                    self._inflight.pop(key, None)
                fl.event.set()
                raise
            with self._lock:
                self._entries[key] = entry
                self._entries.move_to_end(key)
                while len(self._entries) > self.capacity:
                    old_key, old = self._entries.popitem(last=False)
                    self._plan_sources.pop(old_key, None)
                    self.stats["evictions"] += 1
                    _drop(old)
                self._inflight.pop(key, None)
            fl.event.set()
            return entry

    def _build_entry(self, key: EngineKey) -> _Entry:
        """Resolve the backend (the degrade walk) and build batch size 1,
        outside the engine lock."""
        from parallel_convolution_tpu_torch.tuning import costmodel

        key.validate()
        if key.grid != self.grid_shape():
            raise _stale(key, self.grid_shape())
        hw = costmodel.hardware_for_grid(self.grid)
        if key.rank == 3:
            # One registry program a (form, boundary): no degrade walk.
            D = key.shape[0]
            predicted = costmodel.predict_gpx_per_chip(
                costmodel.predict_volume_seconds_per_cell_iter(
                    key.grid, self._block_hw(key), D,
                    VOLUME_RADII[key.filter_name], key.fuse,
                    key.filter_name, hw, fields=VOLUME_FIELDS))
            plan_key = (f"vol|{key.filter_name}|{key.shape[0]}x"
                        f"{key.shape[1]}x{key.shape[2]}|{key.boundary}"
                        f"|grid={key.grid[0]}x{key.grid[1]}")
            entry = _Entry(key, key.backend, plan_source="explicit",
                           predicted_gpx=round(predicted, 3),
                           plan_key=plan_key)
            self._compile_batch(entry, 1)
            return entry
        filt = get_filter(key.filter_name)
        effective = key.backend
        if self.fallback:
            from parallel_convolution_tpu_torch.resilience import degrade

            with self._on_device():
                effective = degrade.resolve_backend(
                    self.grid, filt, key.backend, quantize=key.quantize,
                    fuse=key.fuse, boundary=key.boundary, tile=key.tile,
                    storage=key.storage, block_hw=self._block_hw(key),
                    overlap=key.overlap, col_mode=key.col_mode)
        from parallel_convolution_tpu_torch.tuning import search
        from parallel_convolution_tpu_torch.tuning.plans import Workload

        w = Workload.from_grid(self.grid, filt, key.shape,
                               storage=key.storage, quantize=key.quantize,
                               boundary=key.boundary)
        predicted = costmodel.predict_gpx_per_chip(search.predict(
            w, search.Candidate(
                effective, key.fuse, key.tile,
                bool(key.overlap) and effective == "cuda_rdma",
                key.col_mode), hw))
        with self._lock:
            source = self._plan_sources.get(key, "explicit")
        entry = _Entry(key, effective, plan_source=source,
                       predicted_gpx=round(predicted, 3), plan_key=w.key())
        self._compile_batch(entry, 1)
        return entry

    def _block_hw(self, key: EngineKey) -> tuple[int, int]:
        from parallel_convolution_tpu_torch.parallel.mesh import padded_extent

        (_, H, W), (R, C) = key.shape, key.grid
        return (padded_extent(H, R) // R, padded_extent(W, C) // C)

    def _count_build(self, entry: _Entry) -> None:
        entry.compiles += 1
        with self._lock:
            self.stats["compiles"] += 1

    def _compile_batch(self, entry: _Entry, batch: int):
        """The runner for ``batch`` stacked requests of this key, built and
        run once on zeros now: the first run fills the process caches (the
        kernels' libraries, K1's plan for this shape, the channel plans),
        so a request never builds anything."""
        with entry.lock:
            fn = entry.fns.get(batch)
            if fn is not None:
                return fn
            if entry.key.rank == 3:
                return self._compile_volume_batch(entry, batch)
            from parallel_convolution_tpu_torch.parallel import (
                step as step_lib,
            )

            key = entry.key
            C, H, W = key.shape
            filt = get_filter(key.filter_name)
            with self._on_device():
                # Folded leading axis: batch × channels independent planes.
                probe = torch.zeros((batch * C, H, W), dtype=torch.float32,
                                    device=self.grid.device)
                blocks, valid_hw, block_hw = step_lib._prepare(
                    probe, self.grid, key.storage)
                fn = step_lib._build_iterate(
                    self.grid, filt, key.iters, key.quantize, valid_hw,
                    block_hw, entry.effective_backend, key.fuse,
                    key.boundary, key.tile, False, entry.effective_col_mode,
                    entry.effective_overlap)
                fn(blocks)
                self._sync()
            entry.fns[batch] = fn
            self._count_build(entry)
            return fn

    def _compile_volume_batch(self, entry: _Entry, batch: int):
        """The rank-3 twin: ``batch`` volumes fold their field pairs onto
        the leading axis, (B, F, D, H, W) → (B·F, D, H, W), and the runner
        comes from ``volumes.driver``.  Caller holds ``entry.lock``."""
        from parallel_convolution_tpu_torch.volumes import driver

        key = entry.key
        D, H, W = key.shape
        F = batch * VOLUME_FIELDS
        with self._on_device():
            probe = torch.zeros((F, D, H, W), dtype=torch.float32,
                                device=self.grid.device)
            xs, valid_hw = driver.prepare_volume(probe, self.grid,
                                                 key.boundary)
            _, block_hw, _ = driver._geometry((F, D, H, W), self.grid.shape,
                                              key.boundary)
            fn = driver._build_volume_iterate(
                tuple(self.grid.shape), key.filter_name, key.iters, D,
                tuple(valid_hw), tuple(block_hw), key.fuse, key.boundary,
                self.grid.slotted, self.grid)
            fn(xs)
            self._sync()
        entry.fns[batch] = fn
        self._count_build(entry)
        return fn

    # -- warmup -----------------------------------------------------------
    def warmup(self, keys, batch_sizes=(1,)) -> list[str]:
        """Build the declared keys (and each of ``batch_sizes``' runners,
        the JAX engine building batch size 1 only); returns the effective
        backend per key, in order.  ``keys`` are resolved
        :class:`EngineKey` values: arm ``plans`` before building them."""
        out = []
        for k in keys:
            e = self.entry(k)
            for b in batch_sizes:
                if b not in e.fns:
                    self._compile_batch(e, int(b))
            out.append(e.effective_backend)
        return out

    # -- execution --------------------------------------------------------
    def run_batch(self, key: EngineKey, images, timer: PhaseTimer | None = None):
        """Run ``images`` (B, C, H, W) through the warm runner.

        Returns ``(out, info)``: ``out`` is (B, C, H, W) float32 numpy at
        the valid extent, ``info`` carries ``effective_backend``,
        ``effective_grid``, the plan stamps, the model's exchange split
        and the compile / copy_in / device / copy_out phase walls
        (seconds) from ``timer`` (a fresh :class:`PhaseTimer` when not
        supplied).  ``device`` ends with the card's synchronize: its wall
        is the run's.
        """
        from parallel_convolution_tpu_torch.parallel import step as step_lib

        t = timer or PhaseTimer()
        if key.rank == 3:
            return self._run_volume_batch(key, np.asarray(images), t)
        images = np.asarray(images)
        B, C, H, W = images.shape
        if (C, H, W) != key.shape:
            raise ValueError(
                f"batch shape {(C, H, W)} does not match key {key.shape}")
        if key.grid != self.grid_shape():
            raise _stale(key, self.grid_shape())
        with self._on_device():
            with t.phase("compile"):
                with obs_trace.span("compile", backend=key.backend,
                                    batch=B) as csp:
                    entry = self.entry(key)
                    fn = entry.fns.get(B) or self._compile_batch(entry, B)
                    csp.set(effective_backend=entry.effective_backend)
            filt = get_filter(key.filter_name)
            with t.phase("copy_in"):
                with obs_trace.span("copy_in", batch=B):
                    folded = np.ascontiguousarray(
                        images.reshape(B * C, H, W), dtype=np.float32)
                    blocks, valid_hw, block_hw = step_lib._prepare(
                        folded, self.grid, key.storage)
                    self._sync()
            # A timer shared across retry attempts: charge only this
            # call's device delta.
            dev_before = t.wall("device")
            with t.phase("device"):
                with obs_trace.span("device", batch=B,
                                    backend=entry.effective_backend) as dsp:
                    out = fn(blocks)
                    self._sync()
            dev_s = t.wall("device") - dev_before
            with t.phase("copy_out"):
                with obs_trace.span("copy_out", batch=B):
                    out = step_lib._global_f32(out, self.grid, valid_hw)
                    out = out.cpu().numpy().reshape(B, C, H, W)
        with self._lock:
            self.stats["batches"] += 1
            self.stats["images"] += B
        if obs_metrics.enabled():
            with obs_trace.attach(dsp.context):
                self._record_batch_obs(entry, B, filt, dev_s, valid_hw,
                                       block_hw)
        split = entry.splits.get(B)
        if split is None:
            split = entry.splits[B] = self._split(entry, B, filt, valid_hw,
                                                  block_hw)
        info = {
            "effective_backend": entry.effective_backend,
            "effective_grid": f"{key.grid[0]}x{key.grid[1]}",
            "plan_source": entry.plan_source,
            "plan_key": entry.plan_key,
            "predicted_gpx_per_chip": entry.predicted_gpx,
            "batch_size": B,
            "overlap": entry.effective_overlap,
            "col_mode": entry.effective_col_mode,
            "exchange_fraction": round(split["exchange_fraction"], 4),
            "exchange_hidden_fraction": round(
                split["exchange_hidden_fraction"], 4),
            "phases": {name: t.wall(name)
                       for name in ("compile", "copy_in", "device",
                                    "copy_out")},
        }
        return out, info

    def _split(self, entry: _Entry, B: int, filt, valid_hw, block_hw) -> dict:
        """The model's overlap-adjusted exchange split of one batch (pure
        model arithmetic, cached a batch size)."""
        from parallel_convolution_tpu_torch.obs import attribution
        from parallel_convolution_tpu_torch.parallel import step as step_lib

        key = entry.key
        C = key.shape[0]
        return attribution.predicted_exchange_split(
            key.grid, tuple(block_hw), filt.radius,
            max(1, min(key.fuse, key.iters)),
            backend=entry.effective_backend, storage=key.storage,
            tile=key.tile, quantize=key.quantize,
            separable=entry.effective_backend in ("separable", "cuda_sep"),
            overlap=entry.effective_overlap,
            col_mode=entry.effective_col_mode,
            **step_lib._obs_model(self.grid, filt, block_hw, B * C,
                                  valid_hw))

    def _run_volume_batch(self, key: EngineKey, volumes: np.ndarray,
                          t: PhaseTimer):
        """The rank-3 arm of :meth:`run_batch`: ``volumes`` is
        (B, 2, D, H, W), ``key.shape`` its (D, H, W); ``out`` the same
        shape float32."""
        from parallel_convolution_tpu_torch.obs import attribution
        from parallel_convolution_tpu_torch.tuning import costmodel
        from parallel_convolution_tpu_torch.volumes import driver

        if volumes.ndim != 5 or volumes.shape[1] != VOLUME_FIELDS:
            raise ValueError(
                f"volume batch must be (B, {VOLUME_FIELDS}, D, H, W), "
                f"got {volumes.shape}")
        B = volumes.shape[0]
        if tuple(volumes.shape[2:]) != key.shape:
            raise ValueError(
                f"batch volume shape {tuple(volumes.shape[2:])} does "
                f"not match key {key.shape}")
        if key.grid != self.grid_shape():
            raise _stale(key, self.grid_shape())
        D, H, W = key.shape
        with self._on_device():
            with t.phase("compile"):
                with obs_trace.span("compile", backend=key.backend,
                                    batch=B, rank=3):
                    entry = self.entry(key)
                    fn = entry.fns.get(B) or self._compile_batch(entry, B)
            with t.phase("copy_in"):
                with obs_trace.span("copy_in", batch=B):
                    folded = np.ascontiguousarray(
                        volumes.reshape(B * VOLUME_FIELDS, D, H, W),
                        dtype=np.float32)
                    xs, valid_hw = driver.prepare_volume(
                        folded, self.grid, key.boundary)
                    self._sync()
            with t.phase("device"):
                with obs_trace.span("device", batch=B,
                                    backend=entry.effective_backend):
                    out = fn(xs)
                    self._sync()
            with t.phase("copy_out"):
                with obs_trace.span("copy_out", batch=B):
                    out = driver.unstack_volume(
                        out, self.grid.shape, valid_hw, self.grid.device,
                        self.grid)
                    out = out.cpu().numpy().reshape(
                        B, VOLUME_FIELDS, D, H, W)
        with self._lock:
            self.stats["batches"] += 1
            self.stats["images"] += B
        split = entry.splits.get(B)
        if split is None:
            # The rank-3 roofline with and without its exchange term (a
            # 1x1 grid has none).
            hw = costmodel.hardware_for_grid(self.grid)
            r = VOLUME_RADII[key.filter_name]
            args = (self._block_hw(key), D, r, key.fuse, key.filter_name,
                    hw)
            total = costmodel.predict_volume_seconds_per_cell_iter(
                key.grid, *args, fields=B * VOLUME_FIELDS)
            local = costmodel.predict_volume_seconds_per_cell_iter(
                (1, 1), *args, fields=B * VOLUME_FIELDS)
            face = attribution.volume_face_bytes_per_round(
                key.grid, self._block_hw(key), D, r, key.fuse,
                fields=B * VOLUME_FIELDS, storage=key.storage,
                boundary=key.boundary)
            split = entry.splits[B] = {
                "exchange_fraction": max(0.0, 1.0 - local / total),
                "exchange_hidden_fraction": 0.0,  # no overlapped form
                "face_bytes": face["total"],
            }
        info = {
            "effective_backend": entry.effective_backend,
            "effective_grid": f"{key.grid[0]}x{key.grid[1]}",
            "plan_source": entry.plan_source,
            "plan_key": entry.plan_key,
            "predicted_gpx_per_chip": entry.predicted_gpx,
            "batch_size": B,
            "overlap": False,
            "col_mode": "packed",
            "exchange_fraction": round(split["exchange_fraction"], 4),
            "exchange_hidden_fraction": 0.0,
            "phases": {name: t.wall(name)
                       for name in ("compile", "copy_in", "device",
                                    "copy_out")},
        }
        return out, info

    def _record_batch_obs(self, entry: _Entry, B: int, filt, dev_s: float,
                          valid_hw, block_hw) -> None:
        """One batch's telemetry: the halo / exchange attribution of this
        call's device wall and the predicted-vs-measured drift series per
        plan key."""
        from parallel_convolution_tpu_torch.obs import attribution
        from parallel_convolution_tpu_torch.parallel import step as step_lib
        from parallel_convolution_tpu_torch.resilience.elastic import (
            devices_needed,
        )

        key = entry.key
        C, H, W = key.shape
        step_lib._record_step_obs(
            entry.effective_backend, self.grid, filt, block_hw,
            max(1, min(key.fuse, key.iters)), key.iters, B * C, key.storage,
            key.boundary, dev_s, valid_hw, key.quantize, key.tile,
            source="serving", overlap=entry.effective_overlap,
            col_mode=entry.effective_col_mode)
        if dev_s > 0:
            attribution.record_drift(
                entry.plan_key, entry.effective_backend, entry.predicted_gpx,
                B * C * H * W * key.iters / dev_s
                / devices_needed(self.grid) / 1e9)

    # -- progressive convergence -------------------------------------------
    def _converge_fn(self, entry: _Entry, n: int):
        """The warm convergence chunk of ``n`` iterations of this entry's
        configuration, built under the entry lock and run once on zeros."""
        fn = entry.converge_fns.get(n)
        if fn is not None:
            return fn
        from parallel_convolution_tpu_torch.parallel import step as step_lib
        from parallel_convolution_tpu_torch.resilience.faults import (
            fault_point,
        )

        with entry.lock, self._on_device():
            fn = entry.converge_fns.get(n)
            if fn is not None:
                return fn
            key = entry.key
            if key.rank == 3:
                from parallel_convolution_tpu_torch.volumes import driver

                D, H, W = key.shape
                probe = torch.zeros((VOLUME_FIELDS, D, H, W),
                                    dtype=torch.float32,
                                    device=self.grid.device)
                xs, valid_hw = driver.prepare_volume(probe, self.grid,
                                                     key.boundary)
                _, block_hw, _ = driver._geometry(
                    (VOLUME_FIELDS, D, H, W), self.grid.shape, key.boundary)
                fn = driver.converge_chunk_fn(
                    self.grid, key.filter_name, n, D, valid_hw, block_hw,
                    key.fuse, key.boundary)
                fn(xs)
            else:
                fault_point("backend_compile")  # a chunk length's build
                filt = get_filter(key.filter_name)
                probe = torch.zeros(key.shape, dtype=torch.float32,
                                    device=self.grid.device)
                blocks, valid_hw, block_hw = step_lib._prepare(
                    probe, self.grid, key.storage)
                backend = entry.effective_backend
                fn = step_lib._build_converge_chunk(
                    self.grid, filt, n, key.quantize, tuple(valid_hw),
                    block_hw, backend, key.boundary, key.fuse, key.tile,
                    False, entry.effective_col_mode, entry.effective_overlap)
                from parallel_convolution_tpu_torch.ops import rdma

                carry = self._carry(entry, blocks, n)
                fn(carry)
                rdma.close_carry(carry)
            self._sync()
            entry.converge_fns[n] = fn
            self._count_build(entry)
            return fn

    def _carry(self, entry: _Entry, blocks, check_every: int):
        """The converge chunks' carry of prepared ``blocks``
        (``step._carry_in``), its ghost depth the deepest a chunk of
        ``check_every`` fuses."""
        from parallel_convolution_tpu_torch.parallel import step as step_lib

        key = entry.key
        depth = get_filter(key.filter_name).radius * max(
            1, min(key.fuse, int(check_every) - 1))
        return step_lib._carry_in(blocks, self.grid, entry.effective_backend,
                                  key.boundary, depth,
                                  entry.effective_col_mode)

    def run_converge(self, key: EngineKey, image, *, tol: float,
                     max_iters: int, check_every: int, start_done: int = 0,
                     start_wu: float = 0.0,
                     start_diff: float = float("inf")):
        """Progressive run-to-convergence through the warm cache: a
        generator of ``(image_f32, done, diff, work_units)`` a chunk, the
        rows of ``step.sharded_converge_stream`` (Jacobi: ``work_units``
        the iterations) or, for ``key.solver == "multigrid"``, one a
        V-cycle (``done`` the cycles, ``diff`` the fine residual, the
        pixel-weighted work units; the level programs kept on the entry).

        ``image`` is ONE (C, H, W) field (rank 3: one (2, D, H, W)
        volume); ``key.iters`` should equal ``check_every``.
        ``start_done`` / ``start_wu`` / ``start_diff`` seed a RESUMED job
        from a token minted on a chunk boundary: ``max_iters`` stays the
        job's TOTAL budget, so the remaining chunks are the uninterrupted
        run's and its last row the same bytes.  A reshape mid-stream
        raises the stale-grid ``ValueError``.
        """
        from parallel_convolution_tpu_torch.parallel import step as step_lib

        entry = self.entry(key)
        if key.rank == 3:
            yield from self._run_volume_converge(
                entry, key, image, tol=tol, max_iters=max_iters,
                check_every=check_every, start_done=start_done,
                start_diff=start_diff)
            return
        filt = get_filter(key.filter_name)
        if tuple(image.shape) != key.shape:
            raise ValueError(
                f"image shape {tuple(image.shape)} does not match key "
                f"{key.shape}")
        start_done, start_wu = int(start_done), float(start_wu)
        if float(start_diff) < tol:
            return
        if key.solver == "multigrid":
            from parallel_convolution_tpu_torch.solvers import multigrid

            entry.mg_levels = len(multigrid.plan_levels(
                self.grid, tuple(image.shape[1:]), filt.radius,
                key.boundary, key.mg_levels))
            budget = float(max_iters) - start_wu
            if budget <= 0:
                return
            stream = multigrid.mg_converge_stream(
                np.ascontiguousarray(image, dtype=np.float32), filt,
                tol=tol, max_iters=budget, grid=self.grid,
                quantize=key.quantize, backend=entry.effective_backend,
                storage=key.storage, boundary=key.boundary, tile=key.tile,
                overlap=entry.effective_overlap, mg_levels=key.mg_levels,
                col_mode=entry.effective_col_mode,
                programs=entry.mg_programs)
            for out, cycles, residual, wu in self._stepwise(stream):
                if key.grid != self.grid_shape():
                    raise _stale(key, self.grid_shape())
                yield (out, cycles + start_done, residual,
                       round(wu + start_wu, 3))
            return
        check_every, max_iters = int(check_every), int(max_iters)
        backend = entry.effective_backend
        with self._on_device():
            blocks, valid_hw, _ = step_lib._prepare(
                np.ascontiguousarray(image, dtype=np.float32), self.grid,
                key.storage)
            state = self._carry(entry, blocks, check_every)
        del blocks
        from parallel_convolution_tpu_torch.ops import rdma

        done, diff = start_done, float("inf")
        try:
            while done < max_iters and diff >= tol:
                if key.grid != self.grid_shape():
                    raise _stale(key, self.grid_shape())
                n = min(check_every, max_iters - done)
                fn = self._converge_fn(entry, n)
                with self._on_device():
                    state, d = fn(state)
                    diff = d.item()   # the readback fences the chunk
                    done += n
                    out = step_lib._global_f32(
                        step_lib._carry_out(state, self.grid, backend),
                        self.grid, valid_hw).cpu().numpy()
                yield out, done, diff, float(done)
        finally:
            rdma.close_carry(state)

    def _run_volume_converge(self, entry: _Entry, key: EngineKey, volume, *,
                             tol: float, max_iters: int, check_every: int,
                             start_done: int = 0,
                             start_diff: float = float("inf")):
        """The rank-3 arm of :meth:`run_converge`: ``(volume_f32, done,
        diff, work_units)`` a chunk, volumes at the valid extent."""
        from parallel_convolution_tpu_torch.volumes import driver

        expect = (VOLUME_FIELDS,) + key.shape
        if tuple(volume.shape) != expect:
            raise ValueError(
                f"volume shape {tuple(volume.shape)} does not match "
                f"key (want {expect})")
        if float(start_diff) < tol:
            return
        with self._on_device():
            xs, valid_hw = driver.prepare_volume(
                np.ascontiguousarray(volume, dtype=np.float32), self.grid,
                key.boundary)
        check_every, max_iters = int(check_every), int(max_iters)
        done, diff = int(start_done), float("inf")
        while done < max_iters and diff >= tol:
            if key.grid != self.grid_shape():
                raise _stale(key, self.grid_shape())
            n = min(check_every, max_iters - done)
            fn = self._converge_fn(entry, n)
            with self._on_device():
                xs, d = fn(xs)
                diff = float(d)   # the readback fences the chunk
                done += n
                out = driver.unstack_volume(xs, self.grid.shape, valid_hw,
                                            self.grid.device, self.grid)
                out = out.cpu().numpy()
            yield out, done, diff, float(done)

    # -- introspection ----------------------------------------------------
    def warm_key_count(self) -> int:
        """Resident warm keys."""
        with self._lock:
            return len(self._entries)

    def degraded(self) -> list[dict]:
        """Distinct requested → effective backend downgrades among the
        resident entries."""
        with self._lock:
            pairs = sorted({(k.backend, e.effective_backend)
                            for k, e in self._entries.items()
                            if e.effective_backend != k.backend})
        return [{"requested": req, "effective": eff} for req, eff in pairs]

    def snapshot(self) -> dict:
        """Stats, the channel plans' counters and the resident keys."""
        from parallel_convolution_tpu_torch.parallel import channels

        with self._lock:
            return {
                "stats": dict(self.stats),
                "channels": channels.stats(),
                "capacity": self.capacity,
                "grid": "x".join(str(v) for v in self.grid_shape()),
                "resident": [
                    {"filter": k.filter_name, "shape": list(k.shape),
                     "backend": k.backend,
                     "effective_backend": e.effective_backend,
                     "fuse": k.fuse,
                     "tile": list(k.tile) if k.tile else None,
                     "overlap": e.effective_overlap,
                     "col_mode": e.effective_col_mode,
                     "plan_source": e.plan_source,
                     "predicted_gpx_per_chip": e.predicted_gpx,
                     "batch_sizes": sorted(e.fns),
                     "compiles": e.compiles,
                     "iters": k.iters}
                    for k, e in self._entries.items()
                ],
            }
