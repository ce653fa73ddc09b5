"""Rank-3 entry points: prepare, iterate and converge volumes on the block
grid (the JAX package's ``volumes/driver.py``).

Every step comes out of the kernel-form registry (``kernels.resolve(3,
name, boundary)``); the schedule mirrors rank 2's (``parallel/step.py``):

* state is (F, D, H, W) float32, F interleaved fields (2 a volume, ``2B``
  for a batch); on the grid's device it is the stacked grid of blocks
  (R·C, F, D, bh, bw): (H, W) padded to block multiples and split, D
  whole in every block and never padded;
* a fixed-count run is ``iters // fuse`` fused chunks and one tail chunk
  of the rest;
* a converge chunk is n−1 iterations (fused where legal) and ONE single
  step forming the (prev, cur) pair, its max-abs diff left on the device;
  the host reads it back once a chunk (``.item()``), as rank 2's
  ``sharded_converge`` does, and the chunks land on the fixed count's
  bytes.

On a grid of slots (``mesh.Grid.devices``) the state is the R×C list of
(F, D, bh, bw) blocks, each on its slot's device, each step a per-block
6-face exchange (``halo3.volume_exchange_per_block``) and the form on
every block where it lives; the converge diff is reduced on each slot and
gathered once a chunk, still one readback.  On a grid over several
processes each rank steps its own blocks, the faces between ranks cross
by ``multihost.swap`` (as rank 2's slabs do: through the host over gloo,
card to card over NCCL), the diff is reduced
over the ranks (``multihost.all_max``) and every rank gathers the result
(``multihost.fill_blocks``).

The entry points run on the card unless the grid (or ``device``) says the
CPU.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from parallel_convolution_tpu_torch.parallel import kernels as kernel_forms
from parallel_convolution_tpu_torch.parallel.mesh import (
    Grid, join_blocks, make_grid, padded_extent, split_blocks,
)
from parallel_convolution_tpu_torch.parallel.step import _slots_max_diff
from parallel_convolution_tpu_torch.utils.config import VOLUME_RADII

__all__ = ["converge_chunk_fn", "prepare_volume", "unstack_volume",
           "volume_converge", "volume_converge_stream", "volume_iterate"]


def _geometry(state_shape, grid_shape, boundary: str):
    """(valid_hw, block_hw, padded_hw) of a (F, D, H, W) volume on the
    grid: the one geometry rule (periodic must divide, zero pads and
    masks), with the JAX package's errors."""
    F, D, H, W = (int(s) for s in state_shape)
    if F < 2 or F % 2:
        raise ValueError(
            f"rank-3 state carries interleaved field pairs: leading "
            f"extent must be even >= 2, got {F}")
    R, C = grid_shape
    if boundary == "periodic" and (H % R or W % C):
        raise ValueError(
            f"periodic volumes need grid-divisible extents: "
            f"{H}x{W} on {R}x{C}")
    Hp, Wp = padded_extent(H, R), padded_extent(W, C)
    return (H, W), (Hp // R, Wp // C), (Hp, Wp)


def prepare_volume(state, grid: Grid, boundary: str = "zero"):
    """A (F, D, H, W) volume (numpy or tensor) as float32 on the grid's
    device, (H, W) padded to block multiples and cut into the stacked
    grid (R·C, F, D, bh, bw); returns ``(stacked, valid_hw)``.  On a grid
    of slots the state is instead the R×C list of (F, D, bh, bw) blocks,
    each copied onto its slot's device."""
    x = torch.as_tensor(np.asarray(state) if not torch.is_tensor(state)
                        else state)
    if x.dim() != 4:
        raise ValueError(
            f"volume state must be (F, D, H, W), got {tuple(x.shape)}")
    valid_hw, (bh, bw), (Hp, Wp) = _geometry(x.shape, grid.shape, boundary)
    x = x.to(device=x.device if grid.slotted else grid.device,
             dtype=torch.float32)
    H, W = valid_hw
    if (Hp, Wp) != (H, W):
        x = torch.nn.functional.pad(x, (0, Wp - W, 0, Hp - H))
    F, D = x.shape[:2]
    R, C = grid.shape
    if grid.slotted:
        blocks = split_blocks(x.reshape(F * D, Hp, Wp), grid)
        return [[None if b is None else b.view(F, D, bh, bw) for b in row]
                for row in blocks], \
            valid_hw
    x = x.reshape(F, D, R, bh, C, bw).permute(2, 4, 0, 1, 3, 5)
    return x.reshape(R * C, F, D, bh, bw).contiguous(), valid_hw


def unstack_volume(xs, grid_shape, valid_hw, device=None,
                   grid: Grid | None = None) -> torch.Tensor:
    """The stacked grid (R·C, F, D, bh, bw), or a grid of slots' R×C list
    of blocks (gathered on ``device``, default the first block's), as the
    global (F, D, H, W) volume at its valid extent.  A ``grid`` over
    several processes gathers every rank's blocks on every rank."""
    if not torch.is_tensor(xs):
        from parallel_convolution_tpu_torch.parallel.mesh import first_block

        F, D, bh, bw = first_block(xs).shape
        xs = [[None if b is None else b.reshape(F * D, bh, bw) for b in row]
              for row in xs]
        if grid is not None and grid.spans_processes:
            from parallel_convolution_tpu_torch.parallel import multihost

            xs = multihost.fill_blocks(xs, grid.owners)
        full = join_blocks(xs, device)
        full = full.view(F, D, *full.shape[1:])
        return full[:, :, :valid_hw[0], :valid_hw[1]].contiguous()
    R, C = grid_shape
    N, F, D, bh, bw = xs.shape
    full = xs.reshape(R, C, F, D, bh, bw).permute(2, 3, 0, 4, 1, 5)
    full = full.reshape(F, D, R * bh, C * bw)
    return full[:, :, :valid_hw[0], :valid_hw[1]].contiguous()


def _resolve_step(name: str, boundary: str, grid_shape, depth, valid_hw,
                  block_hw, fuse: int, per_block: bool = False,
                  grid: Grid | None = None):
    """One chunk step through the registry: the ONLY dispatch
    (``per_block``: a grid of slots' list of blocks, ``grid`` that grid)."""
    form = kernel_forms.resolve(3, name, boundary)
    if per_block:
        return form.build(grid_shape, depth, valid_hw, block_hw, fuse,
                          boundary, per_block=True, grid=grid)
    return form.build(grid_shape, depth, valid_hw, block_hw, fuse, boundary)


def _check_fuse(name: str, block_hw, fuse: int) -> None:
    # An unknown name falls through (radius 1): resolution then raises the
    # registry's error naming the registered forms.
    d = VOLUME_RADII.get(name, 1) * max(1, int(fuse))
    if min(block_hw) < d:
        raise ValueError(
            f"fuse={fuse} needs blocks >= {d} for form {name!r}, got "
            f"{tuple(block_hw)}")


@lru_cache(maxsize=64)
def _build_volume_iterate(grid_shape, name: str, iters: int, depth: int,
                          valid_hw, block_hw, fuse: int, boundary: str,
                          per_block: bool = False, grid: Grid | None = None):
    """The fixed-count runner of one configuration: stacked → stacked (or
    blocks → blocks with ``per_block``)."""
    fuse = max(1, min(int(fuse), iters or 1))
    _check_fuse(name, block_hw, fuse)
    chunk = _resolve_step(name, boundary, grid_shape, depth, valid_hw,
                          block_hw, fuse, per_block, grid)
    n_chunks, rem = divmod(int(iters), fuse)
    tail = (_resolve_step(name, boundary, grid_shape, depth, valid_hw,
                          block_hw, rem, per_block, grid) if rem else None)

    def run(xs):
        for _ in range(n_chunks):
            xs = chunk(xs)
        if tail is not None:
            xs = tail(xs)
        return xs

    return run


@lru_cache(maxsize=64)
def _build_volume_converge_chunk(grid_shape, name: str, n: int, depth: int,
                                 valid_hw, block_hw, fuse: int,
                                 boundary: str, per_block: bool = False,
                                 grid: Grid | None = None):
    """ONE convergence chunk: ``n`` iterations and the (prev, cur) max-abs
    diff as a 0-d f32 tensor on the device (rank 2's chunk math)."""
    fuse = max(1, min(int(fuse), max(1, n - 1)))
    _check_fuse(name, block_hw, fuse)
    step = _resolve_step(name, boundary, grid_shape, depth, valid_hw,
                         block_hw, 1, per_block, grid)
    fused = (_resolve_step(name, boundary, grid_shape, depth, valid_hw,
                           block_hw, fuse, per_block, grid)
             if fuse > 1 and n > 1 else None)

    def chunk(xs):
        prev = xs
        if fused is None:
            for _ in range(n - 1):
                prev = step(prev)
        else:
            for _ in range((n - 1) // fuse):
                prev = fused(prev)
            for _ in range((n - 1) % fuse):
                prev = step(prev)
        cur = step(prev)
        d = _slots_max_diff(cur, prev)
        if grid is not None and grid.spans_processes:
            from parallel_convolution_tpu_torch.parallel import multihost

            d = multihost.all_max(d)
        return cur, d

    return chunk


def converge_chunk_fn(grid: Grid, name: str, n: int, depth: int, valid_hw,
                      block_hw, fuse: int, boundary: str):
    """The chunk of a chunk driver (the JAX package's cached surface):
    ``fn(stacked) -> (stacked, diff)``, ``diff`` left on the device (on a
    grid of slots the state is its list of blocks)."""
    return _build_volume_converge_chunk(
        tuple(grid.shape), str(name), int(n), int(depth), tuple(valid_hw),
        tuple(block_hw), int(fuse), str(boundary), grid.slotted, grid)


def volume_iterate(state, name: str, iters: int, *, grid: Grid | None = None,
                   boundary: str = "zero", fuse: int = 1,
                   device=None) -> torch.Tensor:
    """``iters`` applications of rank-3 form ``name`` to a (F, D, H, W)
    volume; returns the float32 (F, D, H, W) result at the valid extent on
    the grid's device (default grid: 1×1 on ``device``, the card unless
    told otherwise).  ``iters < 1`` returns the input as float32, as in
    the JAX package."""
    grid = grid if grid is not None else make_grid(device=device)
    if int(iters) < 1:
        return torch.as_tensor(np.asarray(state, np.float32)).to(grid.device)
    xs, valid_hw = prepare_volume(state, grid, boundary)
    shape = _block_shape(xs)
    run = _build_volume_iterate(
        tuple(grid.shape), str(name), int(iters), shape[1], valid_hw,
        shape[2:], int(fuse), str(boundary), grid.slotted, grid)
    return unstack_volume(run(xs), grid.shape, valid_hw, grid.device, grid)


def _block_shape(xs) -> tuple[int, ...]:
    """(F, D, bh, bw) of a state's blocks."""
    from parallel_convolution_tpu_torch.parallel.mesh import first_block

    b = xs[0] if torch.is_tensor(xs) else first_block(xs)
    return tuple(int(v) for v in b.shape)


def _converge_chunks(state, name, tol, max_iters, check_every, grid,
                     boundary, fuse, counter):
    """The host loop: ``(stacked, iters_done, diff, valid_hw)`` after every
    chunk, until ``diff < tol`` or ``max_iters`` (a NaN diff does not stop
    it, as in the JAX package).  The diff's ``.item()`` is the chunk's one
    readback; it counts on ``counter.readbacks``."""
    xs, valid_hw = prepare_volume(state, grid, boundary)
    shape = _block_shape(xs)
    depth, block_hw = shape[1], shape[2:]
    done = 0
    check_every = max(1, int(check_every))
    max_iters = max(1, int(max_iters))
    while done < max_iters:
        n = min(check_every, max_iters - done)
        fn = converge_chunk_fn(grid, name, n, depth, valid_hw, block_hw,
                               fuse, boundary)
        xs, d = fn(xs)
        done += n
        diff = d.item()
        counter.readbacks += 1
        yield xs, done, diff, valid_hw
        if diff < tol:
            return


def volume_converge_stream(state, name: str, *, tol: float, max_iters: int,
                           check_every: int = 10, grid: Grid | None = None,
                           boundary: str = "zero", fuse: int = 1,
                           device=None):
    """Host-driven chunked convergence: yields ``(state, iters, diff)``
    after every chunk, ``state`` a host numpy copy of the float32 volume
    at its valid extent; the last yield is the converged (or budget-spent)
    field.  ``volume_converge_stream.readbacks`` counts the readbacks, one
    a chunk."""
    grid = grid if grid is not None else make_grid(device=device)
    for xs, done, diff, valid_hw in _converge_chunks(
            state, name, tol, max_iters, check_every, grid, boundary, fuse,
            volume_converge_stream):
        yield (unstack_volume(xs, grid.shape, valid_hw, "cpu",
                              grid).cpu().numpy(), done, diff)


volume_converge_stream.readbacks = 0


def volume_converge(state, name: str, *, tol: float, max_iters: int,
                    check_every: int = 10, grid: Grid | None = None,
                    boundary: str = "zero", fuse: int = 1, device=None):
    """The last row of :func:`volume_converge_stream` — ``(state, iters,
    diff)`` — with ``state`` the float32 volume on the grid's device (no
    host copy a chunk).  ``volume_converge.readbacks`` counts the
    readbacks."""
    grid = grid if grid is not None else make_grid(device=device)
    row = None
    for row in _converge_chunks(state, name, tol, max_iters, check_every,
                                grid, boundary, fuse, volume_converge):
        pass
    xs, done, diff, valid_hw = row
    return (unstack_volume(xs, grid.shape, valid_hw, grid.device, grid),
            done, diff)


volume_converge.readbacks = 0
