"""Geometric multigrid V-cycle on the port's block grid (the JAX package's
``solvers/multigrid.py``).

Plain Jacobi smoothing kills high-frequency error fast and low-frequency
error at ``1 - O(1/N²)`` per sweep: the reference's run-to-convergence
config needs O(N²) sweeps.  A V-cycle makes every frequency band
high-frequency on some grid: pre-smooth → restrict the residual to a
half-resolution grid → recursively solve the error equation there →
prolong the correction back → post-smooth.  Work per cycle is a geometric
series (each level is 4× cheaper), so the cycle costs a few fine-grid
sweeps while contracting the error at a rate independent of N.

It runs on the machinery the rest of the port has:

* **Smoothing is the smoother step** of ``parallel/step.py``
  (``_make_block_step``, fuse 1, float carry): on the card K1 per block for
  ``cuda`` / ``cuda_sep``, one K3 or K4 launch for the grid for
  ``cuda_rdma``; the plain versions on the CPU.  The damped update
  ``(1−ω)·v + ω·s``, the residual and its ×4 are plain PyTorch, as they are
  ``jnp`` outside any Pallas kernel in the JAX package.
* **Transfer operators are registered stencil forms**: ``restrict_fw`` /
  ``prolong_bilinear`` (``solvers/transfer.py``) resolve through
  ``parallel.kernels`` and run over depth-1 halo exchanges.
* **Coarse levels collapse onto smaller grids.**  When a level's block
  falls below :data:`MG_BLOCK_FLOOR`, the planner walks the shrink ladder
  (halve the larger grid axis); a level's state moves by the reshard rule
  (crop to the valid extent, re-pad, re-block), here on the device: the
  JAX package makes a host round trip, the values are the same.
* **On a grid of slots** (``mesh.Grid.devices``) a coarse level's
  sub-grid is the first ``g0·g1`` slots, as the JAX package's sub-mesh is
  its first devices; each block is smoothed and transferred on its slot's
  device over the per-block exchange (``halo.exchange_per_block``), K1
  per slot for ``cuda`` / ``cuda_sep`` and one K3 / K4 launch per slot
  for ``cuda_rdma`` (``rdma.fused_rdma_slots``, its column transport
  ``col_mode``, the fine level's sweeps overlapped with ``overlap``); a
  level's state moves between sub-grids block by block
  (``mesh.reblock``: each target block gathered from the source blocks
  it overlaps, on its own device).
* **On a grid over several processes** a sub-grid keeps its first slots'
  owners (a rank may hold none of a coarse level's blocks), restriction
  and prolongation between levels with different owners move their
  pieces between ranks point to point (``mesh.reblock``), and the
  residual reduces over the ranks (``multihost.all_max``).

The level state is the backend's carry: the R×C list of ``(C, h, w)``
blocks, or for ``cuda_rdma`` on one device the stacked ``(R·C, C, h, w)``
grid.

The equation solved is the one the Jacobi path iterates: ``u = mask(S u)``
(S the filter stencil, mask the zero ghost-ring / pad-rim invariant), i.e.
``A u = 0`` with ``A = I − mask·S``.  The convergence measure is the one
``sharded_converge`` stops on: the max-abs change of one undamped
fine-grid sweep, read back once a cycle (that ``.item()`` is the cycle's
fence; ``mg_converge.readbacks`` / ``mg_converge_stream.readbacks`` count
them).

Work accounting: a fine-grid work unit is one fine-level sweep's worth of
pixel updates.  Each level-ℓ sweep costs ``pxℓ/px0`` units; the residual
application is one sweep, restriction + prolongation together one more.
``max_iters`` bounds work units, so a multigrid run and a Jacobi run are
comparable under one cap.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from parallel_convolution_tpu_torch.obs import metrics as obs_metrics
from parallel_convolution_tpu_torch.ops import rdma
from parallel_convolution_tpu_torch.ops.filters import Filter
from parallel_convolution_tpu_torch.parallel import kernels as kernel_forms
from parallel_convolution_tpu_torch.parallel import step as step_lib
from parallel_convolution_tpu_torch.parallel.mesh import (
    Grid, join_blocks, make_grid, padded_extent, reblock, split_blocks,
)
from parallel_convolution_tpu_torch.resilience.faults import fault_point
from parallel_convolution_tpu_torch.solvers.transfer import coarse_extent
from parallel_convolution_tpu_torch.utils import tracing
from parallel_convolution_tpu_torch.utils.config import (
    COL_MODE_CHOICES, check_backend, check_run_config,
)

__all__ = ["MG_BLOCK_FLOOR", "MGResult", "Level", "cycle_launches",
           "cycle_work_units", "float_tolerance", "level_channel_keys",
           "close_programs", "mg_converge", "mg_converge_stream",
           "plan_levels",
           "warm_level_channels"]

# The tile floor: a level whose block would dip below this on the
# inherited grid collapses onto a smaller grid instead (sub-tile blocks are
# all rim: exchange and launch latency, no compute to amortize it).
MG_BLOCK_FLOOR = 8
# Stop coarsening once the global extent is this small: the coarsest
# level is solved by smoothing alone, which is exact enough at 8x8.
MG_MIN_EXTENT = 8
MG_MAX_LEVELS = 12

# Default smoothing schedule: a V(2,2) cycle with a 16-sweep coarsest
# solve.
NU_PRE = 2
NU_POST = 2
NU_COARSE = 16
# Damped-Jacobi relaxation weight, the standard 2-D smoothing optimum.  Not
# optional: the undamped sweep leaves the checkerboard mode (eigenvalue −1)
# at full amplitude where full-weighting restriction cannot see it, while
# ω = 4/5 contracts every high-frequency mode by ≥ 3/5 per sweep.
OMEGA = 0.8
# The coarse-grid operator factor: ``A = I − S`` is the undivided
# second-order operator (``(h²/4)·Δ`` for jacobi3), so halving the
# resolution quadruples the coarse ``A_2h`` on smooth modes; the restricted
# residual carries the same factor, or every coarse correction lands 4×
# too weak.
COARSE_FACTOR = 4.0


@dataclasses.dataclass(frozen=True)
class Level:
    """One grid level: its grid of blocks, valid extent and block.

    ``block_hw * grid.shape`` is the level's padded extent.  Every
    non-coarsest level has even blocks (the planner pads to ``2*grid``
    multiples) so restriction and prolongation stay block-local.
    """

    grid: Grid
    valid_hw: tuple[int, int]
    block_hw: tuple[int, int]

    @property
    def padded_hw(self) -> tuple[int, int]:
        R, C = self.grid.shape
        return (self.block_hw[0] * R, self.block_hw[1] * C)


@dataclasses.dataclass
class MGResult:
    """The non-stream summary of one multigrid solve: the JAX package's
    fields (``predicted_s_per_cycle`` from the port's H100 cost model),
    and ``residuals``, the residual read back after each cycle."""

    cycles: int
    work_units: float
    residual: float
    converged: bool
    levels: int
    level_grids: list[str]
    level_shapes: list[str]
    backend: str
    overlap: bool
    wall_s: float
    predicted_s_per_cycle: float | None = None
    # The column transport the run used (``step.resolve_col_mode``: the
    # canonical "packed" wherever it is inert).
    col_mode: str | None = None
    residuals: list[float] = dataclasses.field(default_factory=list)


def _level_block(valid_hw, grid_shape, mult: int) -> tuple[int, int]:
    """Block for ``valid_hw`` on a ``grid_shape`` grid padded to
    ``mult*grid`` multiples (mult=2 = the even-block rule)."""
    R, C = grid_shape
    return (padded_extent(valid_hw[0], mult * R) // R,
            padded_extent(valid_hw[1], mult * C) // C)


def _fits(valid_hw, grid_shape, mult: int, periodic: bool, floor: int) -> bool:
    bh, bw = _level_block(valid_hw, grid_shape, mult)
    if periodic and (valid_hw[0] % (mult * grid_shape[0])
                     or valid_hw[1] % (mult * grid_shape[1])):
        # A torus level must keep valid == padded (halo wrap alignment).
        return False
    return min(bh, bw) >= floor


def _collapse(valid_hw, grid_shape, mult: int, periodic: bool,
              floor: int) -> tuple[int, int] | None:
    """First rung of the shrink ladder (halve the larger axis) whose block
    clears the tile floor; None when even 1x1 cannot host the level
    (periodic misalignment)."""
    g = tuple(grid_shape)
    while True:
        if _fits(valid_hw, g, mult, periodic, floor):
            return g
        if g == (1, 1):
            return None
        r, c = g
        g = (r, c // 2) if c >= r and c > 1 else (r // 2, c)


def plan_levels(grid: Grid, valid_hw, radius: int, boundary: str = "zero",
                mg_levels: int | None = None,
                floor: int = MG_BLOCK_FLOOR) -> list[Level]:
    """The level schedule: finest (the caller's grid, as is) down to the
    coarsest grid this problem and boundary support.

    Rules, in order:

    * level 0 keeps the caller's grid (the fine field lives there);
    * coarsening continues while ``mg_levels`` (when given) allows it, the
      global extent stays above ``MG_MIN_EXTENT``, and, for periodic
      boundaries, halving keeps torus alignment (even, grid-divisible
      extents);
    * every non-coarsest level pads its blocks even (transfer locality);
    * a coarse level lands on the first shrink-ladder rung whose block
      clears ``floor``; a sub-grid is a smaller grid on the same device,
      or on a grid of slots the first ``g0·g1`` slots (the JAX package's
      ``devices[:g0*g1]``) with their owners (over several processes,
      this rank's among them or not), and a level whose grid repeats the previous
      level's reuses its ``Grid`` object, so builds key on one grid a
      shape.
    """
    valid_hw = (int(valid_hw[0]), int(valid_hw[1]))
    periodic = boundary == "periodic"
    cap = min(MG_MAX_LEVELS,
              mg_levels if mg_levels is not None else MG_MAX_LEVELS)
    if cap < 1:
        raise ValueError(f"mg_levels must be >= 1, got {mg_levels}")
    levels: list[Level] = []
    cur_valid, cur_grid = valid_hw, grid.shape
    for idx in range(cap):
        more = (idx + 1 < cap and min(cur_valid) > MG_MIN_EXTENT
                and min(cur_valid) >= 2 * max(1, radius))
        if idx == 0:
            g = cur_grid  # the caller's grid, never collapsed
            if more and periodic:
                # Only a periodic misalignment (torus levels must keep
                # valid == padded) can veto coarsening the fine grid.
                more = (cur_valid[0] % (2 * g[0]) == 0
                        and cur_valid[1] % (2 * g[1]) == 0)
        else:
            g = _collapse(cur_valid, cur_grid, 2 if more else 1,
                          periodic, floor)
            if more and g is None:
                more, g = False, _collapse(cur_valid, cur_grid, 1,
                                           periodic, floor)
            if g is None:
                break  # periodic level with no host at any rung: stop
        block = _level_block(cur_valid, g, 2 if more else 1)
        if levels and levels[-1].grid.shape == g:
            sub = levels[-1].grid
        elif g == grid.shape:
            sub = grid
        elif grid.slotted:
            n = g[0] * g[1]
            sub = Grid(g[0], g[1], devices=grid.slots[:n],
                       owners=None if grid.owners is None
                       else grid.owners[:n], rank=grid.rank)
        else:
            sub = Grid(g[0], g[1], grid.device)
        levels.append(Level(sub, cur_valid, block))
        if not more:
            break
        cur_valid = (coarse_extent(cur_valid[0], boundary),
                     coarse_extent(cur_valid[1], boundary))
        cur_grid = g
    return levels


def level_weights(levels) -> list[float]:
    """Fine-grid work units of ONE sweep at each level (pixel ratio)."""
    H0, W0 = levels[0].valid_hw
    return [(lv.valid_hw[0] * lv.valid_hw[1]) / float(H0 * W0)
            for lv in levels]


def cycle_work_units(levels, nu_pre: int = NU_PRE, nu_post: int = NU_POST,
                     nu_coarse: int = NU_COARSE) -> float:
    """Fine-grid work units of one V-cycle under the documented charge:
    every level-ℓ sweep costs its pixel ratio, the residual application
    is one sweep, restriction+prolongation together one more."""
    w = level_weights(levels)
    if len(levels) == 1:
        return (nu_pre + nu_post) * w[0]
    total = 0.0
    for i, wi in enumerate(w):
        if i == len(levels) - 1:
            total += nu_coarse * wi
        else:
            total += (nu_pre + nu_post + 1 + 1) * wi
    return total


def _level_sweeps(levels, nu_pre, nu_post, nu_coarse) -> list[int]:
    """Smoother-step applications per level per cycle (each is one K1
    launch per block, or one K3 / K4 launch for the grid or per slot, on
    the card)."""
    if len(levels) == 1:
        return [nu_pre + nu_post]
    return [(nu_coarse if i == len(levels) - 1 else nu_pre + nu_post + 1)
            for i in range(len(levels))]


def cycle_launches(levels, backend: str, radius: int, nu_pre: int = NU_PRE,
                   nu_post: int = NU_POST, nu_coarse: int = NU_COARSE,
                   col_mode: str = "packed", overlap: bool = False) -> dict:
    """Kernel launches of one V-cycle on the card, by wrapper: every
    smoother step is one K1 launch per block or slot (``cuda`` /
    ``cuda_sep``), or for ``cuda_rdma`` one K3 or K4 launch for the
    level's grid (whichever ``rdma.rdma_plan`` picks for the level's block
    at T = 1) or, on a grid of slots, one per slot (``rdma_*_slot``; a
    pack per slot first with ``col_mode="packed"`` on more than one
    column), the fine level's pre- and post-smoothing sweeps region by
    region with ``overlap`` (``rdma_*_region``, the resolved knob: the
    residual's sweep is not overlapped, as in the JAX package).  The plain
    backends launch nothing; keyed as ``stencil.launch_counts``."""
    from parallel_convolution_tpu_torch.tuning import costmodel

    counts = {"stencil_step": 0, "fused_iterate": 0, "rdma_block": 0,
              "rdma_tiled": 0, "rdma_block_slot": 0, "rdma_tiled_slot": 0,
              "rdma_block_region": 0, "rdma_tiled_region": 0,
              "rdma_pack": 0}
    sweeps = _level_sweeps(levels, nu_pre, nu_post, nu_coarse)
    for i, (lv, n) in enumerate(zip(levels, sweeps)):
        nb = lv.grid.rows * lv.grid.cols
        if backend in ("cuda", "cuda_sep"):
            counts["stencil_step"] += n * nb
            continue
        if backend != "cuda_rdma":
            continue
        plan = rdma.rdma_plan(radius, 1, lv.block_hw)
        if not lv.grid.slotted:
            counts["rdma_" + plan.kernel] += n
            continue
        lapped = (nu_pre + nu_post) if overlap and i == 0 else 0
        counts[f"rdma_{plan.kernel}_slot"] += (n - lapped) * nb
        counts[f"rdma_{plan.kernel}_region"] += lapped * nb * (
            costmodel.overlap_launches(lv.block_hw, radius, 1, plan.groups))
        if col_mode == "packed" and lv.grid.cols > 1:
            counts["rdma_pack"] += n * nb
    return counts


def float_tolerance(filt: Filter, cycles: int, scale: float,
                    nu_pre: int = NU_PRE,
                    nu_post: int = NU_POST) -> tuple[float, float]:
    """(rtol, atol) between two runs of one problem whose stencil steps
    round differently (XLA's fused loops may contract a multiply and an
    add, the port's plain path rounds twice): ``ops/stencil.float_tolerance``
    over the fine-level stencil applications of ``cycles`` V-cycles,
    ``nu_pre + nu_post + 1`` a cycle, with ``scale`` — max |field| of the
    reference at that cycle — in place of the u8 range's 255.  The V-cycle
    is linear: a rounding difference made at an earlier cycle shrinks with
    the field, so the current field's scale bounds it.  A residual (the
    max-abs change of one sweep, ``S u − u``) differs by at most
    ``1 + L1(taps)`` times the field's difference."""
    from parallel_convolution_tpu_torch.ops import stencil

    rtol, atol = stencil.float_tolerance(
        filt, max(1, int(cycles)) * (nu_pre + nu_post + 1), torch.float32)
    return rtol, atol * float(scale) / 255.0


def level_channel_keys(levels, radius: int, boundary: str, col_mode: str,
                       channels: int = 1, storage: str = "f32"):
    """The per-level channel identities of one V-cycle schedule (the JAX
    package's ``level_channel_keys``): each level's exchange identity at
    fuse 1, the one its per-slot K3 / K4 launches bind
    (``rdma.slot_channel_key``), computed once on the schedule, so that
    after :func:`warm_level_channels` ``channels.stats()["builds"]`` is the
    number of distinct level identities however many cycles run.
    ``channels`` is the JAX signature's (the identity does not depend on
    it)."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
             "u8": torch.uint8}[storage]
    return tuple(rdma.slot_channel_key(lv.grid.shape, lv.block_hw,
                                       int(radius), 1, dtype, boundary,
                                       col_mode)
                 for lv in levels)


def warm_level_channels(levels, radius: int, boundary: str, col_mode: str,
                        channels: int = 1, storage: str = "f32"):
    """Bind every level's channel plan up front (idempotent: repeat calls
    hit the cache); returns the identity tuple."""
    from parallel_convolution_tpu_torch.parallel import channels as chan

    keys = level_channel_keys(levels, radius, boundary, col_mode, channels,
                              storage)
    for k in keys:
        chan.plan_for(k)
    return keys

# ---------------------------------------------------------------------------
# Level states: the backend's carry
# ---------------------------------------------------------------------------


def _blocks(state, grid: Grid):
    """The R×C blocks of a level state (views of a stacked grid)."""
    return rdma.unstack_blocks(state, grid.shape) if torch.is_tensor(state) \
        else state


def _map(fn, *states):
    """``fn`` over level states of one form: the stacked grid at once, or
    block by block (a block another rank holds stays ``None``)."""
    if torch.is_tensor(states[0]):
        return fn(*states)
    return [[None if bs[0] is None else fn(*bs) for bs in zip(*rows)]
            for rows in zip(*states)]


def _place(full: torch.Tensor, valid_hw, grid: Grid, block_hw,
           stacked: bool):
    """A global (C, ≥H, ≥W) field cropped to ``valid_hw``, zero-padded to
    ``block_hw`` blocks over ``grid`` and cut into them: the carry, stacked
    for ``cuda_rdma`` on one device.  On a grid of slots each block is cut
    from ``full`` where it lies and copied onto its slot's device (over
    several processes every rank holds ``full`` and cuts its own)."""
    H, W = (int(v) for v in valid_hw)
    if grid.slotted:
        return reblock([[full]], (H, W), grid, block_hw)
    R, Cg = grid.shape
    th, tw = block_hw[0] * R, block_hw[1] * Cg
    x = full[:, :H, :W]
    if (th, tw) != (H, W):
        x = F.pad(x, (0, tw - W, 0, th - H))
    blocks = split_blocks(x, grid)
    return rdma.stack_blocks(blocks, grid.shape) if stacked else blocks


def _fit_to(state, valid_hw, src: Grid, src_hw, grid: Grid, block_hw,
            stacked: bool, channels: int):
    """Move a level state of ``src_hw`` blocks on ``src`` onto ``(grid,
    block_hw)``: the reshard rule (crop to the valid extent, re-pad,
    re-block), on the device; on a grid of slots block by block
    (``mesh.reblock``), no block ever gathered beyond what its target
    needs, a piece between ranks point to point.  The state itself when
    it is already there."""
    if src == grid and tuple(src_hw) == tuple(block_hw):
        return state
    blocks = _blocks(state, src)
    if grid.slotted:
        return reblock(blocks, valid_hw, grid, block_hw, src_grid=src,
                       src_hw=src_hw, like=(channels, torch.float32))
    return _place(join_blocks(blocks), valid_hw, grid, block_hw, stacked)


def _global(state, grid: Grid, valid_hw, device=None) -> torch.Tensor:
    """The (C, H, W) field of a level state at its valid extent, on
    ``device`` (default: the grid's)."""
    blocks = _blocks(state, grid)
    device = grid.device if device is None else torch.device(device)
    if grid.spans_processes:
        from parallel_convolution_tpu_torch.parallel import multihost

        blocks = multihost.fill_blocks(blocks, grid.owners)
    full = (blocks[0][0] if grid.shape == (1, 1)
            else join_blocks(blocks, device))
    return full[:, :valid_hw[0], :valid_hw[1]].to(device)


# ---------------------------------------------------------------------------
# Level programs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Solve:
    """One solve's resolved configuration, its fine-level state, and on a
    card's grid of slots the ``cuda_rdma`` run of each level (made at the
    level's first sweep and reused by every later one)."""

    levels: list
    backend: str
    boundary: str
    tile: tuple[int, int] | None
    channels: int
    valid_hw: tuple[int, int]
    u: object
    col_mode: str = "packed"
    overlap: bool = False
    runs: dict = dataclasses.field(default_factory=dict)

    def close(self) -> None:
        """End the levels' runs (``rdma.close_carry``: over several
        processes a collective that unmaps the neighbours' buffers, waits
        for every rank, then frees; a no-op in one process)."""
        for run in self.runs.values():
            run.close()
        self.runs.clear()


def _slot_carry(s: _Solve, lv: Level, filt: Filter, blocks):
    """The ``cuda_rdma`` carry of a level on a grid of slots: on the card
    the level's one run (its streams, buffers and pointer tables made
    once a solve), the blocks copied into its input buffers; on the CPU
    the blocks."""
    if lv.grid.device.type == "cpu":
        return blocks
    run = s.runs.get(lv)
    if run is None:
        carry = rdma.slot_carry(blocks, lv.grid, s.boundary, filt.radius,
                                s.col_mode)
        s.runs[lv] = carry.run
        return carry
    return rdma.load_carry(run, blocks)


def _smoother(lv: Level, filt: Filter, s: _Solve, overlap: bool = False):
    """The level's smoother step: the iterate path's fuse-1 step of the
    solve's backend on the level's grid and blocks, float carry, its
    column transport the solve's and ``overlap`` as given.  On a grid of
    slots ``cuda_rdma`` maps blocks to blocks through the level's run
    (:func:`_slot_carry`): the result is views of the run's output
    buffers, valid until the level's next sweep, which every program here
    consumes first."""
    fault_point("backend_compile")  # a level program's build
    step_lib._check_block_size(filt, lv.block_hw)
    step = step_lib._make_block_step(filt, lv.grid, lv.valid_hw, lv.block_hw,
                                     False, s.backend, 1, s.boundary, s.tile,
                                     False, s.col_mode, overlap)
    if s.backend != "cuda_rdma" or not lv.grid.slotted:
        return step

    def slot_step(blocks):
        return rdma.slot_blocks(step(_slot_carry(s, lv, filt, blocks)),
                                lv.grid.shape)

    return slot_step


def _damped(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``(1−ω)·v + ω·s``, the JAX package's expression (the sum is
    commutative, so adding the terms in this order gives its bits) with
    one temporary field fewer."""
    out = OMEGA * s
    out += (1.0 - OMEGA) * v
    return out.to(v.dtype)


def _build_smooth_rhs(lv: Level, filt: Filter, n: int, s: _Solve):
    """``n`` damped error-equation sweeps:
    ``e ← (1−ω)·e + ω·(mask(S e) + r)``; the restricted residual ``r`` is
    masked, so the convex combination keeps the masking invariant."""
    step = _smoother(lv, filt, s)
    step_lib._note_compile("mg_smooth", s.backend, lv.grid.shape, n, 1,
                           s.boundary, lv.block_hw)

    def sweep(v, sv, r):
        return _damped(v, sv + r)

    def run(e, r):
        for _ in range(n):
            e = _map(sweep, e, step(e), r)
        return e

    return run


def _build_fine_smooth(lv: Level, filt: Filter, n: int, s: _Solve,
                       with_diff: bool):
    """``n`` damped fine-grid sweeps of the homogeneous equation:
    ``u ← (1−ω)·u + ω·mask(S u)``, overlapped where the solve resolved
    ``overlap`` (the JAX package overlaps the fine sweeps only).

    ``with_diff=True`` also returns the max-abs undamped change
    ``max|S u − u|`` of the last sweep, as a 0-d tensor on the device:
    the measure ``sharded_converge`` stops on, from the last sweep's own
    stencil application (it costs no extra step)."""
    step = _smoother(lv, filt, s, s.overlap)
    step_lib._note_compile("mg_fine", s.backend, lv.grid.shape, n, 1,
                           s.boundary, lv.block_hw)

    def run(u):
        for _ in range(max(0, n - 1) if with_diff else n):
            u = _map(_damped, u, step(u))
        if not with_diff:
            return u
        su = step(u)
        return (_map(_damped, u, su),
                step_lib._carry_diff(su, u, lv.grid))

    return run


def _transfer(name: str, lv: Level, boundary: str):
    """A registered transfer operator on the level's grid: all blocks at
    once on one device, per block on a grid of slots."""
    build = kernel_forms.resolve(2, name, boundary).build
    args = (lv.grid.shape, lv.valid_hw, lv.block_hw, boundary)
    if not lv.grid.slotted:
        return build(*args)
    return build(*args, per_block=True, grid=lv.grid)


def _build_residual_restrict(lv: Level, filt: Filter, s: _Solve, fine: bool):
    """Residual, full-weighting restriction and the ×4 in one program, on
    the level's grid (the result at half blocks, in the carry's form).

    ``fine=True``  : ``u → 4·restrict(S u − u)`` (the homogeneous fine
    equation ``A u = 0``).
    ``fine=False`` : ``(e, r) → 4·restrict(S e + r − e)`` (a coarse level's
    error equation ``A e = r``).
    """
    step = _smoother(lv, filt, s)
    step_lib._note_compile("mg_restrict", s.backend, lv.grid.shape, 1, 1,
                           s.boundary, lv.block_hw)
    restrict = _transfer("restrict_fw", lv, s.boundary)

    def coarse(res):
        return _map(lambda c: COARSE_FACTOR * c, restrict(res))

    if fine:
        def run(u):
            return coarse(_map(lambda su, v: (su - v).to(torch.float32),
                               step(u), u))
    else:
        def run(e, r):
            return coarse(_map(lambda se, v, r_: (se + r_ - v).to(
                torch.float32), step(e), e, r))
    return run


def _build_prolong_correct(lv: Level, boundary: str):
    """``(u, e_c) → u + prolong(e_c)``: bilinear prolongation (the
    registry's ``prolong_bilinear``) and the correction add, on the fine
    level's grid; ``e_c`` arrives there at half blocks."""
    fault_point("backend_compile")
    step_lib._note_compile("mg_prolong", "prolong_bilinear", lv.grid.shape,
                           1, 1, boundary, lv.block_hw)
    prolong = _transfer("prolong_bilinear", lv, boundary)

    def run(u, ec):
        return _map(lambda a, b: (a + b.to(a.dtype)).to(a.dtype), u,
                    prolong(ec))

    return run


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------


def _mg_obs(s: _Solve, sweeps, filt: Filter, cycle_wall: float) -> None:
    """One cycle's telemetry (the JAX package's ``_mg_obs``): an exchange
    attribution per LEVEL (the ``pctpu_mg_level``-labeled sweep counter,
    the exchange event with the level stamped; no wall: the levels share
    the cycle's one readback) and the cycle-wall histogram."""
    if not obs_metrics.enabled():
        return
    for i, (lv, n) in enumerate(zip(s.levels, sweeps)):
        step_lib._record_step_obs(
            s.backend, lv.grid, filt, lv.block_hw, 1, n, s.channels, "f32",
            s.boundary, None, lv.valid_hw, False, None, source="multigrid",
            overlap=s.overlap and i == 0, mg_level=i)
    obs_metrics.histogram(
        "pctpu_mg_cycle_seconds", "wall of one multigrid V-cycle",
        ("backend",)).observe(cycle_wall, backend=s.backend)


def _predict_cycle_seconds(levels, sweeps, filt: Filter, backend: str,
                           channels: int, tile) -> float:
    """The cost model's price of one V-cycle: the sum of its per-level
    sweep costs (``costmodel.predict_vcycle_seconds``), each level on its
    own grid and blocks.  The transfer operators and the damped update are
    not priced (the JAX model's charge)."""
    from parallel_convolution_tpu_torch.tuning import costmodel

    terms = []
    for lv, n in zip(levels, sweeps):
        hw = costmodel.hardware_for_grid(lv.grid)
        spp = costmodel.predict_seconds_per_px_iter(
            backend, "f32", 1, tile, (channels, *lv.valid_hw), lv.block_hw,
            lv.grid.shape, filt.size, backend in costmodel.SEPARABLE_BACKENDS,
            False, hw)
        terms.append((spp, channels * lv.valid_hw[0] * lv.valid_hw[1], n))
    return costmodel.predict_vcycle_seconds(terms)


def _setup(x, filt: Filter, grid, quantize, backend, storage, boundary, fuse,
           tile, fallback, overlap, col_mode, mg_levels, device) -> _Solve:
    """The checks, the default grid, the resolved backend, overlap and
    column transport (the JAX package's order), the level schedule and
    its warmed channel plans of one solve, and the input placed on the
    fine level."""
    if quantize:
        raise ValueError(
            "solver='multigrid' requires quantize=False: corrections are "
            "signed float fields (u8 store-back would clamp the error "
            "equation)")
    if storage != "f32":
        raise ValueError(
            f"solver='multigrid' requires storage='f32', got {storage!r} "
            "(residual/correction fields need full float carries)")
    check_backend(backend, allow_auto=True)
    if col_mode is not None and col_mode not in COL_MODE_CHOICES:
        raise ValueError(f"col_mode must be one of {COL_MODE_CHOICES}, got "
                         f"{col_mode!r}")
    check_run_config(storage, boundary, quantize)
    if grid is None:
        grid = make_grid(device=device)
    elif device is not None and grid.device != torch.device(device):
        raise ValueError(f"grid is on {grid.device}, device={device!r}")
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    # On a grid of slots the field stays where it is given: each block is
    # cut from it and copied onto its slot's device.
    x = x.to(device=x.device if grid.slotted else grid.device,
             dtype=torch.float32)
    if x.dim() != 3:
        raise ValueError(f"expected a (C, H, W) field, got {tuple(x.shape)}")
    channels, H, W = x.shape
    valid_hw = (int(H), int(W))
    # fuse is resolved and ignored: smoothing sweeps are fuse 1 (the
    # V-cycle itself is the exchange-amortization lever here).
    backend, _, tile, source = step_lib._resolve_auto(
        grid, filt, backend, fuse, tile, storage, quantize, boundary,
        valid_hw, channels)
    overlap = step_lib._auto_overlap(overlap, source)
    check_backend(backend)
    overlap = step_lib.resolve_overlap(overlap, backend, grid)
    tile = None if tile is None else tuple(int(v) for v in tile)
    levels = plan_levels(grid, valid_hw, filt.radius, boundary, mg_levels)
    fine = levels[0]
    col_mode = step_lib.resolve_col_mode(col_mode, backend, grid,
                                         fine.block_hw, filt.radius, 1,
                                         storage)
    if fallback:
        # Probed on the REAL fine block (plan_levels pads even only when a
        # coarser level follows): the kernel's launch shape keys on it.
        backend = step_lib._resolve_fallback(
            grid, filt, backend, quantize, 1, boundary, tile, storage,
            fine.block_hw, False, col_mode, overlap)
        overlap = kernel_forms.clamp_overlap(overlap, backend)
        col_mode = step_lib.clamp_col_mode(col_mode, backend)
    if kernel_forms.persistent_capable(backend):
        # Each level's exchange identity bound once, up front: every
        # cycle's per-slot launches bind these same plans.
        warm_level_channels(levels, filt.radius, boundary, col_mode,
                            channels, storage)
    u = _place(x, valid_hw, fine.grid, fine.block_hw,
               backend == "cuda_rdma" and not fine.grid.slotted)
    return _Solve(levels, backend, boundary, tile, channels, valid_hw, u,
                  col_mode, bool(overlap))


@dataclasses.dataclass
class _Programs:
    """The level programs of one V-cycle schedule (built once a solve, or
    once for many solves of one configuration through ``programs=``)."""

    smooth: object = None
    pre: object = None
    post: object = None
    resid: list = dataclasses.field(default_factory=list)
    prolong: list = dataclasses.field(default_factory=list)
    pre_c: list = dataclasses.field(default_factory=list)
    post_c: list = dataclasses.field(default_factory=list)
    coarsest: object = None
    solve: _Solve | None = None   # whose level runs the programs step


def _build_programs(s: _Solve, filt: Filter, nu_pre: int, nu_post: int,
                    nu_coarse: int) -> _Programs:
    """Every level program of ``s``'s schedule."""
    levels = s.levels
    fine = levels[0]
    if len(levels) == 1:
        # Degenerate single-level schedule: the cycle is pure damped
        # smoothing (plan_levels refused to coarsen — tiny image or
        # periodic misalignment).
        return _Programs(smooth=_build_fine_smooth(
            fine, filt, nu_pre + nu_post, s, True), solve=s)
    return _Programs(
        pre=_build_fine_smooth(fine, filt, nu_pre, s, False),
        post=_build_fine_smooth(fine, filt, nu_post, s, True),
        resid=[_build_residual_restrict(lv, filt, s, i == 0)
               for i, lv in enumerate(levels[:-1])],
        prolong=[_build_prolong_correct(lv, s.boundary)
                 for lv in levels[:-1]],
        pre_c=[None] + [_build_smooth_rhs(lv, filt, nu_pre, s)
                        for lv in levels[1:-1]],
        post_c=[None] + [_build_smooth_rhs(lv, filt, nu_post, s)
                         for lv in levels[1:-1]],
        coarsest=_build_smooth_rhs(levels[-1], filt, nu_coarse, s),
        solve=s)


def _programs_for(s: _Solve, filt: Filter, nu_pre: int, nu_post: int,
                  nu_coarse: int, cache: dict | None) -> _Programs:
    """The level programs of ``s``: built for this solve, or taken from
    ``cache`` (a dict its caller keeps for one configuration, keyed here
    on the schedule and the sweep counts) where an earlier solve built
    them.  Programs built for another solve keep that solve's ``cuda_rdma``
    runs (its ``_Solve``), which the same configuration shares."""
    if cache is None:
        return _build_programs(s, filt, nu_pre, nu_post, nu_coarse)
    key = (tuple(s.levels), s.backend, s.boundary, s.tile, s.col_mode,
           s.overlap, filt.name, nu_pre, nu_post, nu_coarse)
    progs = cache.get(key)
    if progs is None:
        progs = cache[key] = _build_programs(s, filt, nu_pre, nu_post,
                                             nu_coarse)
    return progs


def close_programs(cache: dict) -> None:
    """Drop a ``programs=`` cache (:func:`mg_converge_stream`), ending the
    level runs its programs keep (:meth:`_Solve.close`; over several
    processes a collective, so every rank drops the same cache at the
    same point)."""
    for progs in cache.values():
        progs.solve.close()
    cache.clear()


def _cycles(s: _Solve, filt: Filter, tol: float, max_iters: int, nu_pre: int,
            nu_post: int, nu_coarse: int, counter, programs=None):
    """The V-cycle loop: ``(cycles, residual, work_units)`` after every
    cycle, the fine state in ``s.u`` (the loop alone holds it during a
    cycle, so no stale state stays alive beside the working fields), until
    ``residual < tol`` or the work-unit budget ``max_iters`` is spent (a
    NaN residual stops it too).  The residual's ``.item()`` is the cycle's
    one readback and fence; it counts on ``counter.readbacks``.
    ``programs``: a cache of level programs across solves
    (:func:`_programs_for`)."""
    levels = s.levels
    stacked = s.backend == "cuda_rdma" and not levels[0].grid.slotted
    last = len(levels) - 1
    wu_cycle = cycle_work_units(levels, nu_pre, nu_post, nu_coarse)
    # Every level program is built once a solve, or once for every solve
    # of a configuration (the JAX package caches its compiled programs
    # per process).
    with tracing.span("mg.build"):
        p = _programs_for(s, filt, nu_pre, nu_post, nu_coarse, programs)
    smooth, pre, post, resid, prolong = (p.smooth, p.pre, p.post, p.resid,
                                         p.prolong)
    pre_c, post_c, coarsest = p.pre_c, p.post_c, p.coarsest

    def down(i: int, rc):
        """Level ``i``'s restricted residual onto level ``i + 1``."""
        lv, nxt = levels[i], levels[i + 1]
        half = (lv.block_hw[0] // 2, lv.block_hw[1] // 2)
        return _fit_to(rc, nxt.valid_hw, lv.grid, half, nxt.grid,
                       nxt.block_hw, stacked, s.channels)

    def up(i: int, ec):
        """Level ``i + 1``'s correction onto level ``i``'s grid at half
        blocks."""
        lv, nxt = levels[i], levels[i + 1]
        half = (lv.block_hw[0] // 2, lv.block_hw[1] // 2)
        return _fit_to(ec, nxt.valid_hw, nxt.grid, nxt.block_hw, lv.grid,
                       half, stacked, s.channels)

    # Each level's work in a leg is one span (``mg.L<i>``), named here
    # once: tracing off, a span is one branch.
    at = [f"mg.L{i}" for i in range(last + 1)]

    def coarse_cycle(r):
        """Solve ``A e = r`` on levels 1 and below: the V's legs down and
        up, each level's error and residual kept for its way up.  (A loop,
        not a recursive closure: a closure that refers to itself is a
        reference cycle, which would hold every level program, and the
        masks they cache, until the garbage collector runs.)"""
        es, rs = {}, {1: r}
        for i in range(1, last):
            with tracing.span(at[i]):
                es[i] = pre_c[i](_map(torch.zeros_like, rs[i]), rs[i])
                rs[i + 1] = down(i, resid[i](es[i], rs[i]))
        with tracing.span(at[last]):
            e = coarsest(_map(torch.zeros_like, rs[last]), rs[last])
        for i in range(last - 1, 0, -1):
            with tracing.span(at[i]):
                e = post_c[i](prolong[i](es.pop(i), up(i, e)), rs.pop(i))
        return e

    sweeps = _level_sweeps(levels, nu_pre, nu_post, nu_coarse)
    u, s.u = s.u, None
    cycles, wu, diff = 0, 0.0, float("inf")
    max_wu = float(max_iters)
    while wu < max_wu and diff >= tol:
        t0 = time.perf_counter()
        with tracing.span("mg.cycle"):
            if last == 0:
                with tracing.span(at[0]):
                    u, d = smooth(u)
            else:
                with tracing.span(at[0]):
                    u = pre(u)
                    rc = down(0, resid[0](u))
                ec = coarse_cycle(rc)
                del rc
                with tracing.span(at[0]):
                    ec = up(0, ec)
                    u = prolong[0](u, ec)
                    del ec
                    # Post-smooth and the residual readout in one program:
                    # the last sweep's undamped change max|S u − u| is what
                    # the stream reports and the stopping rule reads.
                    u, d = post(u)
            with tracing.span("mg.readback"):
                diff = d.item()   # the readback fences the cycle
            counter.readbacks += 1
            cycles += 1
            wu += wu_cycle
            with tracing.span("mg.obs"):
                _mg_obs(s, sweeps, filt, time.perf_counter() - t0)
        s.u = u
        yield cycles, diff, round(wu, 3)
        u, s.u = s.u, None
    s.u = u


def mg_converge_stream(x, filt: Filter, tol: float, max_iters: int,
                       grid: Grid | None = None, quantize: bool = False,
                       backend: str = "shifted", storage: str = "f32",
                       boundary: str = "zero", fuse: int | None = 1,
                       tile=None, fallback: bool = False,
                       overlap: bool | None = None,
                       mg_levels: int | None = None,
                       col_mode: str | None = None,
                       nu_pre: int = NU_PRE, nu_post: int = NU_POST,
                       nu_coarse: int = NU_COARSE, device=None,
                       programs: dict | None = None):
    """Progressive multigrid solve: a generator over V-cycle snapshots.

    Yields ``(image_f32, cycles_done, residual, work_units)`` after every
    V-cycle: ``image_f32`` is the (C, H, W) field as a host numpy copy,
    ``residual`` the max-abs change of one fine-grid sweep (the measure
    ``sharded_converge`` stops on), read back once a cycle.  The stream
    ends when ``residual < tol`` or the fine-grid work-unit budget
    ``max_iters`` is spent.

    ``quantize`` must be False and ``storage`` f32: corrections are signed
    float fields (``ValueError`` otherwise).  ``fuse`` is resolved and
    ignored (smoothing sweeps are fuse 1).  ``backend`` names the smoother
    (``auto`` resolves through ``tuning``); the transfer operators always
    run their registered stencils.  ``grid`` defaults to 1×1 on ``device``
    (default: the card; it raises without CUDA); on a grid of slots every
    level runs per slot (coarse levels on the first slots), ``col_mode``
    is ``cuda_rdma``'s column transport there (``step.resolve_col_mode``)
    and ``overlap`` overlaps the fine level's sweeps
    (``step.resolve_overlap``: clamped, with a warning, off a grid of
    slots).  On a grid over several processes every rank calls it with
    the same field and gets the same snapshots.
    ``mg_converge_stream.readbacks`` counts the readbacks.  ``programs``:
    a dict the caller keeps for one configuration, in which the level
    programs are built at the first solve and found by the later ones
    (the serving engine's warm entry: no ``compile`` event after its
    first stream; :func:`close_programs` ends them).  Without it the
    level runs end with the stream.
    """
    s = _setup(x, filt, grid, quantize, backend, storage, boundary, fuse,
               tile, fallback, overlap, col_mode, mg_levels, device)
    fine = s.levels[0]
    try:
        for cycles, diff, wu in _cycles(s, filt, tol, max_iters, nu_pre,
                                        nu_post, nu_coarse,
                                        mg_converge_stream, programs):
            yield (_global(s.u, fine.grid, s.valid_hw, "cpu").numpy(),
                   cycles, diff, wu)
    finally:
        s.u = None  # cached programs keep ``s``: not its field
        if programs is None:
            s.close()


mg_converge_stream.readbacks = 0


def mg_converge(x, filt: Filter, tol: float, max_iters: int,
                grid: Grid | None = None, quantize: bool = False,
                backend: str = "shifted", storage: str = "f32",
                boundary: str = "zero", fuse: int | None = 1, tile=None,
                fallback: bool = False, overlap: bool | None = None,
                mg_levels: int | None = None, col_mode: str | None = None,
                nu_pre: int = NU_PRE, nu_post: int = NU_POST,
                nu_coarse: int = NU_COARSE,
                device=None) -> tuple[torch.Tensor, MGResult]:
    """Run the V-cycle to convergence; returns ``(field, MGResult)``: the
    (C, H, W) f32 field on the grid's device (the JAX package returns a
    host array) and the summary.

    ``max_iters`` bounds fine-grid work units (the budget a plain Jacobi
    run would spend as iterations), so the two solvers are comparable
    under one cap.  The arguments are :func:`mg_converge_stream`'s;
    ``mg_converge.readbacks`` counts the readbacks (one a cycle).  The
    result stamps the backend, ``overlap`` and ``col_mode`` the solve
    resolved and ran with (the JAX package re-derives the same).
    """
    t0 = time.perf_counter()
    s = _setup(x, filt, grid, quantize, backend, storage, boundary, fuse,
               tile, fallback, overlap, col_mode, mg_levels, device)
    levels = s.levels
    cycles, diff, wu = 0, float("inf"), 0.0
    residuals = []
    try:
        for cycles, diff, wu in _cycles(s, filt, tol, max_iters, nu_pre,
                                        nu_post, nu_coarse, mg_converge):
            residuals.append(diff)
        out = _global(s.u, levels[0].grid, s.valid_hw)
    finally:
        s.u = None
        s.close()
    res = MGResult(
        cycles=cycles, work_units=round(wu, 3), residual=diff,
        converged=diff < tol, levels=len(levels),
        level_grids=[f"{lv.grid.rows}x{lv.grid.cols}" for lv in levels],
        level_shapes=[f"{lv.valid_hw[0]}x{lv.valid_hw[1]}" for lv in levels],
        backend=s.backend, overlap=s.overlap, col_mode=s.col_mode,
        wall_s=round(time.perf_counter() - t0, 4),
        predicted_s_per_cycle=_predict_cycle_seconds(
            levels, _level_sweeps(levels, nu_pre, nu_post, nu_coarse), filt,
            s.backend, s.channels, s.tile),
        residuals=residuals)
    return out, res


mg_converge.readbacks = 0
