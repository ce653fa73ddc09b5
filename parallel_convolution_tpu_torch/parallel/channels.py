"""The neighbour table of the ``cuda_rdma`` kernels (the JAX package's
``parallel/channels.py``: ``ChannelKey`` / ``plan_for``).

On the TPU each device pushed its edge slabs to its neighbours through
bound remote-copy channels: slab rectangles, partners and semaphore pairs,
built once per exchange identity (grid, block, radius, fuse, dtype,
boundary, kernel).  On one card every block of the grid is in the same
device memory, so what is left of a channel is which block feeds each
ghost region.  That depends on the grid shape and the boundary alone, so
:func:`plan_for` and :func:`device_table` are cached on those (and the
device), not on the JAX key's other fields; slab descriptors and
semaphores have no one-card counterpart.

The table holds, for every block ``b = i * cols + j`` of the R×C grid, nine
entries in row-major order over ``(di, dj)`` in ``{-1, 0, 1}²``: the index
of the block at ``(i + di, j + dj)`` that feeds that ghost region (the
centre entry is ``b`` itself, the corners the diagonal block), ``-1`` where
there is none (zero boundary past the image edge), and under a periodic
boundary the wrapped block (the block itself on an axis of extent 1, the
TPU kernels' self-wrap).  The halo exchange's two-hop corners (rows first,
then full-height columns) land the same bytes as a direct read of the
diagonal block.
"""

from __future__ import annotations

import functools

import torch

from parallel_convolution_tpu_torch.utils.config import BOUNDARIES

OFFSETS = tuple((di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1))


def _wrap(i: int, n: int, periodic: bool) -> int | None:
    if 0 <= i < n:
        return i
    return i % n if periodic else None


@functools.lru_cache(maxsize=64)
def plan_for(grid: tuple[int, int], boundary: str) -> tuple[tuple[int, ...], ...]:
    """The (cached) neighbour table of an R×C grid: per block, 9 source
    blocks or -1."""
    if boundary not in BOUNDARIES:
        raise ValueError(f"boundary must be one of {BOUNDARIES}, got "
                         f"{boundary!r}")
    R, C = grid
    periodic = boundary == "periodic"
    rows = []
    for i in range(R):
        for j in range(C):
            row = []
            for di, dj in OFFSETS:
                ni, nj = _wrap(i + di, R, periodic), _wrap(j + dj, C, periodic)
                row.append(-1 if ni is None or nj is None else ni * C + nj)
            rows.append(tuple(row))
    return tuple(rows)


@functools.lru_cache(maxsize=64)
def device_table(grid: tuple[int, int], boundary: str,
                 device: torch.device) -> torch.Tensor:
    """:func:`plan_for`'s table as the kernels read it: one contiguous
    (blocks × 9) int32 tensor on ``device``, uploaded once."""
    return torch.tensor(plan_for(tuple(grid), boundary), dtype=torch.int32,
                        device=device).reshape(-1)
