"""Ghost-cell (halo) exchange between the blocks of a grid (the JAX
package's ``parallel/halo.py``).

Two phases, as in the JAX package's ``halo_exchange``:

1. every block's top and bottom ``d`` ghost rows come from the last / first
   ``d`` rows of its upper / lower neighbour;
2. every block's left and right ``d`` ghost columns come from its left /
   right neighbour's *row-padded* block, full padded height — so corner
   ghosts arrive in two hops, with no diagonal copies.

A block on the image edge gets zeros (boundary ``zero``, the reference's
ghost ring) or its wrap-around neighbour (``periodic``, a torus).  In this
slice all blocks live on one device, so an exchange is slicing and copying
between the block tensors.  ``halo_exchange.calls`` counts the calls, so a
run can show that a path (the ``cuda_rdma`` backend on the card) never
made one.
"""

from __future__ import annotations

import torch

from parallel_convolution_tpu_torch.utils.config import BOUNDARIES


def _neighbor(i: int, n: int, periodic: bool) -> int | None:
    if 0 <= i < n:
        return i
    return i % n if periodic else None


def halo_exchange(blocks: list[list[torch.Tensor]], depth: int,
                  grid_shape: tuple[int, int],
                  boundary: str = "zero") -> list[list[torch.Tensor]]:
    """Pad every (C, h, w) block to (C, h+2d, w+2d) with its neighbours'
    edges.  Returns new tensors; the input blocks are not modified."""
    halo_exchange.calls += 1
    if boundary not in BOUNDARIES:
        raise ValueError(
            f"boundary must be one of {BOUNDARIES}, got {boundary!r}")
    periodic = boundary == "periodic"
    R, Cg = grid_shape
    d = int(depth)
    if d == 0:
        return [list(row) for row in blocks]
    h, w = blocks[0][0].shape[1:]
    if d > h or d > w:
        raise ValueError(f"halo depth {d} deeper than the block {(h, w)}")
    padded = [[None] * Cg for _ in range(R)]
    for i in range(R):
        up, down = _neighbor(i - 1, R, periodic), _neighbor(i + 1, R, periodic)
        for j in range(Cg):
            b = blocks[i][j]
            p = b.new_empty((b.shape[0], h + 2 * d, w + 2 * d))
            p[:, d:d + h, d:d + w] = b
            if up is None:
                p[:, :d, d:d + w] = 0
            else:
                p[:, :d, d:d + w] = blocks[up][j][:, h - d:, :]
            if down is None:
                p[:, d + h:, d:d + w] = 0
            else:
                p[:, d + h:, d:d + w] = blocks[down][j][:, :d, :]
            padded[i][j] = p
    # Phase 2 reads only neighbours' interior columns, which phase 2 never
    # writes, so the order of the blocks does not matter.
    for i in range(R):
        for j in range(Cg):
            left = _neighbor(j - 1, Cg, periodic)
            right = _neighbor(j + 1, Cg, periodic)
            p = padded[i][j]
            if left is None:
                p[:, :, :d] = 0
            else:
                p[:, :, :d] = padded[i][left][:, :, w:w + d]
            if right is None:
                p[:, :, d + w:] = 0
            else:
                p[:, :, d + w:] = padded[i][right][:, :, d:2 * d]
    return padded


halo_exchange.calls = 0
