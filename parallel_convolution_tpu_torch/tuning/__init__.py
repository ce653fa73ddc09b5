"""Autotuning of the port: cost model, measured search, persistent plans
(the JAX package's ``tuning/``).

* :mod:`.costmodel` — the roofline as ranking functions, with the card's
  measured rates and the kernels' own legality;
* :mod:`.search` — legal candidate enumeration + model-pruned measured
  refinement over ``utils.bench``;
* :mod:`.plans` — the schema-versioned plan cache with the exact ->
  nearest-bucket -> cost-model fallback ladder (the JAX package's file
  format).

This package root owns :func:`resolve`, the ``backend="auto"`` entry point
that ``parallel/step.py``, ``ConvolutionModel``, ``utils.bench`` and the
CLI call.  Resolution order:

  1. plan cache (exact key, else nearest same-card size bucket),
  2. cost model over the legal candidate space,

and the winner's provenance — ``measured | interpolated | predicted`` —
travels with it (``Resolution.source``).
"""

from __future__ import annotations

import dataclasses

from parallel_convolution_tpu_torch.tuning import costmodel, search
from parallel_convolution_tpu_torch.tuning.plans import (
    PLAN_FILE_ENV, PLAN_SCHEMA, Plan, PlanCache, Workload, canonical_key,
    default_cache, default_plan_path,
)
from parallel_convolution_tpu_torch.utils.config import AUTO

__all__ = [
    "AUTO", "PLAN_FILE_ENV", "PLAN_SCHEMA", "Plan", "PlanCache",
    "Resolution", "Workload", "canonical_key", "costmodel",
    "default_cache", "default_plan_path", "last_resolution", "resolve",
    "search",
]


@dataclasses.dataclass(frozen=True)
class Resolution:
    """What ``backend="auto"`` resolved to, with provenance.

    ``source`` is ``measured`` (a measured plan), ``interpolated`` (nearest
    same-card size bucket or grid) or ``predicted`` (cost model only, or a
    plan a dry-run tune wrote).  ``overlap`` and ``col_mode`` are the JAX
    package's fields: ``overlap`` the plan's or the model's verdict on the
    overlapped pipeline, clamped to ``costmodel.overlap_legal`` at the
    knobs resolved, ``col_mode`` the plan's or the model's column
    transport (a grid of slots; elsewhere the canonical "packed").
    """

    backend: str
    fuse: int
    tile: tuple[int, int] | None
    source: str
    predicted_gpx: float | None
    key: str
    overlap: bool = False
    col_mode: str = "packed"


# The most recent resolutions of this process, for entry points that label
# their output after the fact.
_LAST: list[Resolution] = []


def last_resolution() -> Resolution | None:
    return _LAST[-1] if _LAST else None


def _legal_plan_knobs(w: Workload, plan: Plan,
                      hw: costmodel.HardwareModel) -> tuple[int, object]:
    """Clamp a (possibly other-bucket) plan's knobs to THIS workload's
    legality: fuse to the block depth, tile to the planners — an
    interpolated plan from a larger bucket must never hand an impossible
    launch to the kernels."""
    fuse = plan.fuse
    if fuse not in search._legal_fuses(w, plan.backend, (fuse,)):
        allf = search._legal_fuses(w, plan.backend, search.FUSE_MENU)
        fuse = max((f for f in allf if f <= fuse), default=min(allf))
    tile = plan.tile
    if tile is not None and tile not in search._legal_tiles(
            w, plan.backend, (tile,), fuse=fuse, hw=hw):
        tile = None
    return fuse, tile


def resolve(grid, filt, shape, *, storage: str = "f32",
            quantize: bool = True, boundary: str = "zero",
            fuse: int | None = None, tile: tuple[int, int] | None = None,
            plans: PlanCache | None = None,
            check_every: int | None = None,
            overlap: bool | None = None) -> Resolution:
    """Resolve ``backend="auto"`` (and an unset fuse / tile) for one
    workload on ``grid``.

    ``fuse`` / ``tile`` passed non-None are pins: the plan or the model
    fills only the unset knobs, and a pin that is illegal for every
    backend raises ``ValueError`` (never silently run as fuse=1 or the
    default tile).  ``plans=None`` consults the ambient cache
    (``PCTPU_PLAN_FILE``).  ``check_every`` keys a convergence workload
    and caps the fuse at ``check_every - 1``.  ``overlap`` True / False
    overrides the plan's or the model's verdict; either way the result is
    clamped to legality at the knobs resolved.  Deterministic: two
    processes on the same device resolve identically.  On a grid over
    several processes rank 0 resolves (and measures, where a plan says
    so) and every rank takes its ``Resolution`` (``multihost.agreed``), so
    the ranks never run different plans: the JAX ``resolve`` has one mesh
    and one program.
    """
    if getattr(grid, "spans_processes", False):
        from parallel_convolution_tpu_torch.parallel import multihost

        res = multihost.agreed(lambda: _resolve(
            grid, filt, shape, storage, quantize, boundary, fuse, tile,
            plans, check_every, overlap))
    else:
        res = _resolve(grid, filt, shape, storage, quantize, boundary, fuse,
                       tile, plans, check_every, overlap)
    _LAST.append(res)
    del _LAST[:-4]  # bounded history; only the last is ever read
    return res


def _resolve(grid, filt, shape, storage, quantize, boundary, fuse, tile,
             plans, check_every, overlap) -> Resolution:
    """:func:`resolve` in one process."""
    if check_every is not None and fuse is not None:
        fuse = max(1, min(int(fuse), max(1, int(check_every) - 1)))
    hw = costmodel.hardware_for_grid(grid)
    w = Workload.from_grid(grid, filt, shape, storage=storage,
                           quantize=quantize, boundary=boundary,
                           check_every=check_every)
    cache = plans if plans is not None else default_cache()
    plan = cache.best_plan(w) if len(cache) else None
    if plan is not None and fuse is not None and not search._legal_fuses(
            w, plan.backend, (int(fuse),), strict=True):
        raise ValueError(
            f"no legal candidates: pinned fuse={fuse} fails legality for "
            f"{w.filter_name} {w.shape} on grid {w.grid}")
    if plan is not None and tile is not None and not search._legal_tiles(
            w, plan.backend, (tuple(tile),), strict=True,
            fuse=int(fuse) if fuse is not None else plan.fuse, hw=hw):
        raise ValueError(
            f"no legal candidates: pinned tile={tuple(tile)} fails "
            f"legality for {w.filter_name} {w.shape} on grid {w.grid}")
    if plan is not None:
        p_fuse, p_tile = _legal_plan_knobs(w, plan, hw)
        r_fuse = int(fuse) if fuse is not None else p_fuse
        want = plan.overlap if overlap is None else overlap
        res = Resolution(
            backend=plan.backend,
            fuse=r_fuse,
            tile=tuple(tile) if tile is not None else p_tile,
            source=plan.source, predicted_gpx=plan.predicted_gpx,
            key=w.key(),
            overlap=search._legal_overlaps(w, plan.backend, r_fuse,
                                           bool(want), hw)[0],
            col_mode=(plan.col_mode if plan.col_mode in
                      search._legal_col_modes(w, plan.backend)
                      else "packed"))
    else:
        p = search.tune(
            w, dry_run=True, fuses=[int(fuse)] if fuse is not None else None,
            tiles=[tuple(tile)] if tile is not None else None, hw=hw,
            overlap=overlap).plan
        res = Resolution(
            backend=p.backend,
            fuse=int(fuse) if fuse is not None else p.fuse,
            tile=tuple(tile) if tile is not None else p.tile,
            source="predicted", predicted_gpx=p.predicted_gpx, key=w.key(),
            overlap=p.overlap, col_mode=p.col_mode)
    return res
