"""Candidate enumeration and measured search over the port's knobs (the
JAX package's ``tuning/search.py``): backend, fusion depth and the CUDA
kernels' output tile.

A deterministic *legal* candidate space, the cost model
(:mod:`.costmodel`) to rank it, and measured refinement
(``utils.bench.bench_iterate``) over only the model's shortlist.

Legality is the kernels' own, enumerated rather than discovered as launch
errors, and decided by the kernels' planners against the card's opt-in
shared memory:

* fuse: ``block >= r*T`` on every backend (the ghost depth), capped at
  ``check_every - 1`` for a convergence workload;
* tiles (CUDA backends only; the plain backends have none): no larger
  than the block (a larger one clamps to a duplicate of the default), and
  accepted by the planner of the launch the chunk makes — K1's shared
  memory at fuse 1 (``stencil.step_smem_bytes`` at one input stage, the
  largest row pitches), ``stencil.fused_plan``
  for K2, ``rdma.rdma_plan`` for K3 / K4 (K3 takes the whole block and has
  no tile);
* the separable backends only where they are byte-safe: an exactly rank-1
  filter, in quantize mode, with dyadic taps — ``auto`` never picks a
  backend that changes bytes.

``tune(..., dry_run=True)`` never touches a device: it returns the
model-ranked best with ``source="predicted"``.
"""

from __future__ import annotations

import dataclasses

from parallel_convolution_tpu_torch.ops import rdma, stencil
from parallel_convolution_tpu_torch.tuning import costmodel
from parallel_convolution_tpu_torch.tuning.plans import Plan, Workload

__all__ = ["Candidate", "enumerate_candidates", "rank", "tune",
           "TuneResult"]

# The kernels' own tiles (K1's STEP_TILE 16x512, K2's FUSED_TILE 64x128)
# and a few around them, each one fused_plan accepts for one level at
# every radius up to the kernels' (stencil.MAX_K).  None = the kernel's
# default, always legal.
TILE_MENU = (None, (32, 128), (64, 64), (32, 64), (64, 128), (128, 64),
             (128, 128), (16, 512))

FUSE_MENU = (1, 2, 4, 8, 16, 32)

# Model-tie preference: earlier wins.  The normative plain path first among
# equals, so a flat model (the CPU) resolves to 'shifted'.
_PREFERENCE = ("shifted", "xla_conv", "separable", "cuda_sep", "cuda",
               "cuda_rdma")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the knob space: (backend, fuse, tile, overlap,
    col_mode).  ``overlap`` and ``col_mode`` keep the JAX package's fields;
    on one card they are always False and "packed"."""

    backend: str
    fuse: int = 1
    tile: tuple[int, int] | None = None
    overlap: bool = False
    col_mode: str = "packed"


def _sep_byte_safe(w: Workload) -> bool:
    """Separable backends are candidates only where their rank-1 rounding
    order is provably byte-identical."""
    return w.separable and w.quantize and w.dyadic


def _legal_backends(w: Workload) -> list[str]:
    out = ["shifted", "xla_conv", "cuda", "cuda_rdma"]
    if _sep_byte_safe(w):
        out += ["separable", "cuda_sep"]
    return out


def _hw(w: Workload, hw: costmodel.HardwareModel | None):
    return hw or costmodel.hardware_for(w.platform, w.device_kind)


def _legal_fuses(w: Workload, backend: str, menu,
                 strict: bool = False) -> list[int]:
    """``strict=True`` (explicitly pinned menus) returns [] when nothing
    survives — the pin must die loudly upstream, never be silently
    remeasured as fuse=1; the default menu falls back to the always-legal
    unfused depth."""
    bh, bw = w.block_hw
    ce = getattr(w, "check_every", None)
    fuse_cap = None if ce is None else max(1, int(ce) - 1)
    out = []
    for T in menu:
        T = int(T)
        if T < 1 or w.radius * T > min(bh, bw):
            continue
        if fuse_cap is not None and T > fuse_cap:
            continue
        out.append(T)
    return out or ([] if strict else [1])


def _planner_accepts(w: Workload, backend: str, tile, fuse: int,
                     smem_limit: int) -> bool:
    """Whether the launch a chunk of ``fuse`` levels makes takes ``tile``:
    the kernels' own planners and shared-memory checks."""
    r, k = w.radius, w.taps_k
    size = costmodel.STORAGE_BYTES[w.storage]
    try:
        if backend == "cuda_rdma":
            rdma.rdma_plan(r, fuse, w.block_hw, tile, smem_limit)
        elif fuse == 1:
            th, tw = tile if tile is not None else stencil.STEP_TILE
            th, tw = min(th, w.block_hw[0]), min(tw, w.block_hw[1])
            if stencil.step_smem_bytes(k, (th, tw), size, size) > smem_limit:
                return False
        else:
            stencil.fused_plan(r, fuse, w.block_hw, tile, smem_limit)
    except ValueError:
        return False
    return True


def _legal_tiles(w: Workload, backend: str, menu, strict: bool = False,
                 fuse: int = 1,
                 hw: costmodel.HardwareModel | None = None) -> list:
    """``strict`` as in :func:`_legal_fuses` — a pinned tile that fails
    legality yields [] (loud upstream error), never a silent None.  The
    plain backends have no tile, and K3 takes the whole block, so any menu
    degenerates to [None] there."""
    if backend not in costmodel.CUDA_BACKENDS:
        return [None]
    smem = _hw(w, hw).smem_optin
    if (backend == "cuda_rdma"
            and not costmodel.rdma_is_tiled(w.block_hw, w.radius, fuse, smem)):
        return [None]
    bh, bw = w.block_hw
    out = []
    for t in menu:
        if t is None:
            if _planner_accepts(w, backend, None, fuse, smem):
                out.append(None)
            continue
        th, tw = (int(v) for v in t)
        if th > bh or tw > bw:
            continue  # larger than the block: a duplicate of a smaller tile
        if _planner_accepts(w, backend, (th, tw), fuse, smem):
            out.append((th, tw))
    return out or ([] if strict else [None])


def enumerate_candidates(w: Workload, backends=None, fuses=None,
                         tiles=None,
                         hw: costmodel.HardwareModel | None = None,
                         ) -> list[Candidate]:
    """The deterministic legal candidate list for one workload.

    ``backends`` / ``fuses`` / ``tiles`` pin a sub-space (an explicit knob
    is honoured verbatim; legality still filters it, so an impossible pin
    dies here with an empty-space error rather than inside a launch).
    """
    out = []
    for b in (backends if backends is not None else _legal_backends(w)):
        for T in _legal_fuses(w, b, fuses if fuses is not None
                              else FUSE_MENU, strict=fuses is not None):
            for t in _legal_tiles(w, b, tiles if tiles is not None
                                  else TILE_MENU, strict=tiles is not None,
                                  fuse=T, hw=hw):
                out.append(Candidate(b, T, t))
    if not out:
        raise ValueError(
            f"no legal candidates for {w.filter_name} {w.shape} on grid "
            f"{w.grid} (backends={backends}, fuses={fuses}, tiles={tiles})")
    return out


def predict(w: Workload, c: Candidate,
            hw: costmodel.HardwareModel | None = None) -> float:
    """Model seconds/px/iter for one candidate (ranking unit)."""
    return costmodel.predict_seconds_per_px_iter(
        c.backend, w.storage, c.fuse, c.tile, w.shape, w.block_hw, w.grid,
        w.taps_k, w.separable, w.quantize, _hw(w, hw), ragged=w.ragged,
        magic_round=w.magic_round)


def _pref(backend: str) -> int:
    return (_PREFERENCE.index(backend) if backend in _PREFERENCE
            else len(_PREFERENCE))


def rank(w: Workload, candidates,
         hw: costmodel.HardwareModel | None = None,
         ) -> list[tuple[float, Candidate]]:
    """Candidates sorted best-first by predicted time, deterministically
    (ties break on the backend preference order, then the knob tuple)."""
    hw = _hw(w, hw)

    def sort_key(pc):
        t, c = pc
        return (t, _pref(c.backend), c.fuse, c.tile or (0, 0), c.overlap,
                c.col_mode)

    return sorted(((predict(w, c, hw), c) for c in candidates),
                  key=sort_key)


@dataclasses.dataclass
class TuneResult:
    """A tune's verdict plus its evidence rows (one per measured point)."""

    plan: Plan
    workload: Workload
    rows: list[dict]


def measure(w: Workload, c: Candidate, grid, *, iters: int = 8,
            reps: int = 2,
            hw: costmodel.HardwareModel | None = None) -> dict:
    """One measured point: a ``bench_iterate`` row for this candidate, at
    least one full chunk long (a fuse=32 candidate timed over 8 iterations
    would price fuse=8), plus the model's prediction beside it."""
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.utils import bench

    row = bench.bench_iterate(
        w.shape[1:], get_filter(w.filter_name), max(iters, c.fuse),
        grid=grid, channels=w.shape[0], backend=c.backend,
        quantize=w.quantize, storage=w.storage, fuse=c.fuse,
        boundary=w.boundary, reps=reps, tile=c.tile)
    row["predicted_gpx_per_chip"] = costmodel.predict_gpx_per_chip(
        predict(w, c, hw))
    return row


def tune(w: Workload, grid=None, *, dry_run: bool = False, backends=None,
         fuses=None, tiles=None, iters: int = 8, reps: int = 2,
         max_measure: int = 8, prune_factor: float = 4.0,
         hw: costmodel.HardwareModel | None = None) -> TuneResult:
    """Tune one workload: rank the legal space, optionally measure.

    ``dry_run=True`` (or ``grid=None``) returns the model's pick with
    ``source="predicted"`` and no device work.  Otherwise the top
    ``max_measure`` candidates within ``prune_factor`` of the model-best
    predicted time are benched and the best measured Gpx/s wins,
    ``source="measured"``.  A candidate a planner refuses (``ValueError``)
    becomes an error row and is skipped — never dropped silently: the rows
    carry it.  Any other failure (a CUDA launch error, a failed build, a
    lost context) is a fault of the kernels, not an illegal point, and
    propagates: a lost context would poison every later measurement.
    """
    hw = _hw(w, hw)
    ranked = rank(w, enumerate_candidates(w, backends, fuses, tiles, hw=hw),
                  hw)
    best_t, best_c = ranked[0]
    predicted_gpx = costmodel.predict_gpx_per_chip(best_t)
    if dry_run or grid is None:
        return TuneResult(
            Plan(best_c.backend, best_c.fuse, best_c.tile,
                 source="predicted", predicted_gpx=round(predicted_gpx, 3),
                 overlap=best_c.overlap, col_mode=best_c.col_mode),
            w, rows=[])
    rows: list[dict] = []
    measured: list[tuple[float, Candidate, float]] = []
    shortlist = [(t, c) for t, c in ranked
                 if t <= best_t * prune_factor][:max(1, int(max_measure))]
    for _, c in shortlist:
        try:
            row = measure(w, c, grid, iters=iters, reps=reps, hw=hw)
        except ValueError as e:  # an illegal point is data
            rows.append({"backend": c.backend, "fuse": c.fuse,
                         "tile": (f"{c.tile[0]}x{c.tile[1]}" if c.tile
                                  else None),
                         "overlap": c.overlap, "col_mode": c.col_mode,
                         "error": repr(e)[:200]})
            continue
        rows.append(row)
        measured.append((row["gpixels_per_s_per_chip"], c,
                         row["predicted_gpx_per_chip"]))
    if not measured:
        raise RuntimeError(
            f"every shortlisted candidate failed to measure "
            f"({len(shortlist)} tried); see rows for errors")
    measured.sort(key=lambda m: (-m[0], _pref(m[1].backend)))
    gpx, c, pred = measured[0]
    return TuneResult(
        Plan(c.backend, c.fuse, c.tile, source="measured",
             predicted_gpx=round(pred, 3), measured_gpx=round(gpx, 3),
             overlap=c.overlap, col_mode=c.col_mode),
        w, rows=rows)
