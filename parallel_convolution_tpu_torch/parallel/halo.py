"""Ghost-cell (halo) exchange between the blocks of a grid (the JAX
package's ``parallel/halo.py``).

Two phases, as in the JAX package's ``halo_exchange``:

1. every block's top and bottom ``d`` ghost rows come from the last / first
   ``d`` rows of its upper / lower neighbour;
2. every block's left and right ``d`` ghost columns come from its left /
   right neighbour's *row-padded* block, full padded height — so corner
   ghosts arrive in two hops, with no diagonal copies.

A block on the image edge gets zeros (boundary ``zero``, the reference's
ghost ring) or its wrap-around neighbour (``periodic``, a torus).  Where
all blocks live on one device, an exchange copies the blocks into one
padded grid (R, C_grid, C, h+2d, w+2d) and fills every ghost ring with a
few whole-grid copies (:func:`_fill_ghosts`), for a list of blocks
(:func:`halo_exchange`) and for the stacked grid
(:func:`halo_exchange_stacked`) alike; on a grid of slots each block pads
in a buffer of its own (:func:`exchange_per_block`), its slabs copied
between devices, or between processes (through host memory over gloo,
card to card over NCCL).  ``halo_exchange.calls`` counts the
calls on a list of blocks, so a run can show that a path (the
``cuda_rdma`` backend on the card) never made one.
"""

from __future__ import annotations

import torch

from parallel_convolution_tpu_torch.parallel.mesh import first_block
from parallel_convolution_tpu_torch.utils.config import BOUNDARIES


def _check(boundary: str, depth: int, hw) -> int:
    if boundary not in BOUNDARIES:
        raise ValueError(
            f"boundary must be one of {BOUNDARIES}, got {boundary!r}")
    d = int(depth)
    if d > hw[0] or d > hw[1]:
        raise ValueError(f"halo depth {d} deeper than the block "
                         f"{tuple(hw)}")
    return d


def _fill_ghosts(p: torch.Tensor, d: int, periodic: bool) -> None:
    """The two phases on the padded grid ``p`` (R, C_grid, C, h+2d, w+2d)
    whose interiors are filled: each a few whole-grid copies, however many
    blocks the grid has, one indexed assignment each (the fuse-1 path
    pays them on the host once a level).  Every source is an interior row
    or column, which neither phase writes."""
    R, Cg = p.shape[:2]
    h, w = p.shape[-2] - 2 * d, p.shape[-1] - 2 * d
    cols = slice(d, d + w)
    # Phase 1: rows.  The grid's edge rows of blocks get zeros (every
    # block's, the inner ones overwritten below) or their wrap-around
    # neighbour's; the inner ones their upper / lower neighbour's last /
    # first d interior rows.
    if periodic:
        p[0, ..., :d, cols] = p[-1, ..., h:h + d, cols]
        p[-1, ..., d + h:, cols] = p[0, ..., d:2 * d, cols]
    else:
        p[..., :d, cols] = 0
        p[..., d + h:, cols] = 0
    if R > 1:
        p[1:, ..., :d, cols] = p[:-1, ..., h:h + d, cols]
        p[:-1, ..., d + h:, cols] = p[1:, ..., d:2 * d, cols]
    # Phase 2: columns at full padded height, from the row-padded left /
    # right neighbour, the same way.
    if periodic:
        p[:, 0, ..., :d] = p[:, -1, ..., w:w + d]
        p[:, -1, ..., d + w:] = p[:, 0, ..., d:2 * d]
    else:
        p[..., :d] = 0
        p[..., d + w:] = 0
    if Cg > 1:
        p[:, 1:, ..., :d] = p[:, :-1, ..., w:w + d]
        p[:, :-1, ..., d + w:] = p[:, 1:, ..., d:2 * d]


def halo_exchange(blocks: list[list[torch.Tensor]], depth: int,
                  grid_shape: tuple[int, int],
                  boundary: str = "zero") -> list[list[torch.Tensor]]:
    """Pad every (C, h, w) block to (C, h+2d, w+2d) with its neighbours'
    edges.  Returns new tensors (views of one padded grid); the input
    blocks are not modified.  A grid of slots pads with
    :func:`exchange_per_block`."""
    halo_exchange.calls += 1
    R, Cg = grid_shape
    b0 = blocks[0][0]
    d = _check(boundary, depth, b0.shape[1:])
    if d == 0:
        return [list(row) for row in blocks]
    C, h, w = b0.shape
    flat = b0.new_empty((R * Cg, C, h + 2 * d, w + 2 * d))
    for k, b in enumerate(b for row in blocks for b in row):
        flat[k, :, d:d + h, d:d + w] = b
    _fill_ghosts(flat.view(R, Cg, C, h + 2 * d, w + 2 * d), d,
                 boundary == "periodic")
    padded = flat.unbind(0)
    return [list(padded[i * Cg:(i + 1) * Cg]) for i in range(R)]


halo_exchange.calls = 0


def halo_exchange_stacked(x: torch.Tensor, depth: int,
                          grid_shape: tuple[int, int],
                          boundary: str = "zero") -> torch.Tensor:
    """:func:`halo_exchange` on the stacked grid (R·C, C, h, w) (block
    ``i * C + j`` at grid position (i, j), ``ops/rdma.stack_blocks``'s
    layout): every block padded to (C, h+2d, w+2d), the same values block
    for block, the interiors placed by one copy."""
    R, Cg = grid_shape
    nb, C, h, w = x.shape
    if nb != R * Cg:
        raise ValueError(f"expected {R * Cg} stacked blocks for grid "
                         f"{tuple(grid_shape)}, got {nb}")
    d = _check(boundary, depth, (h, w))
    p = x.new_empty((R, Cg, C, h + 2 * d, w + 2 * d))
    p[..., d:d + h, d:d + w] = x.reshape(R, Cg, C, h, w)
    if d:
        _fill_ghosts(p, d, boundary == "periodic")
    return p.reshape(nb, C, h + 2 * d, w + 2 * d)


def exchange_per_block(blocks: list[list[torch.Tensor]], depth: int,
                       grid_shape: tuple[int, int], boundary: str = "zero",
                       *, dtype=None, fill=None, packed: bool = False,
                       grid=None) -> list[list[torch.Tensor]]:
    """The exchange on a grid of slots: each block padded in a buffer of
    its own, on its own device, in ``dtype`` (default the block's), every
    ghost filled by the two phases, each a copy of one edge slab from the
    neighbour's device.

    1. rows: the top / bottom ``d`` ghost rows (interior columns) from the
       upper / lower neighbour's last / first ``d`` rows;
    2. columns at full padded height from the left / right neighbour's
       row-padded buffer, so the corners arrive in two hops.  With
       ``packed`` each block first stages its two edge column slabs in a
       contiguous buffer (the ``packed`` transport), which its neighbours
       read instead.

    ``fill`` (e.g. NaN) is written into every buffer first, so a ghost
    that no slab reaches shows; a missing neighbour (zero boundary) writes
    zeros.  The inputs are not modified.

    On a ``grid`` over several processes (its ``owners`` name each
    block's rank, row-major, and its ``rank`` this process's) ``blocks``
    holds ``None`` where another rank holds the block: a ghost whose
    neighbour lives on another rank arrives by a
    ``torch.distributed`` send / receive of that edge slab
    (``multihost.swap``), each phase ending before the next begins, and
    the result holds ``None`` there too.  Each slab's tag names the ghost
    it fills (block and side), so under the device transport (NCCL, which
    matches by order alone) the sender's and the receiver's lists of a
    pair sort alike (``multihost.wire_order``); the slabs are sent from
    the padded buffers and blocks on the card, and received into the
    ghosts there.  A rank holding none of the blocks (a sub-grid of
    another's first slots) has nothing to exchange.
    """
    R, Cg = grid_shape
    mine = first_block(blocks, None)
    if mine is None:
        return [list(row) for row in blocks]
    d = _check(boundary, depth, mine.shape[1:])
    periodic = boundary == "periodic"
    C, h, w = mine.shape
    dtype = mine.dtype if dtype is None else dtype
    owners = grid.owners if grid is not None else None
    rank = grid.rank if owners is not None else 0

    def nbr(i, j):
        ii = i % R if periodic else i
        jj = j % Cg if periodic else j
        return (ii, jj) if 0 <= ii < R and 0 <= jj < Cg else None

    def owner(n):
        return rank if owners is None else owners[n[0] * Cg + n[1]]

    def tag(n, side):  # the receiving ghost: block n's side 0..3
        return (n[0] * Cg + n[1]) * 4 + side

    pads = []
    for row in blocks:
        prow = []
        for b in row:
            if b is None:
                prow.append(None)
                continue
            p = (b.new_empty((C, h + 2 * d, w + 2 * d), dtype=dtype)
                 if fill is None else
                 b.new_full((C, h + 2 * d, w + 2 * d), fill, dtype=dtype))
            p[:, d:d + h, d:d + w] = b
            prow.append(p)
        pads.append(prow)
    cols = slice(d, d + w)
    # Phase 1: rows.  Side 0 / 1 is the top / bottom ghost.
    sends, recvs = [], []
    for i in range(R):
        for j in range(Cg):
            p = pads[i][j]
            if p is None:
                continue
            for side, dst, src_rows, n in (
                    (0, slice(0, d), slice(h - d, h), nbr(i - 1, j)),
                    (1, slice(d + h, h + 2 * d), slice(0, d),
                     nbr(i + 1, j))):
                if n is None:
                    p[:, dst, cols] = 0
                elif owner(n) != rank:
                    recvs.append((owner(n), tag((i, j), side),
                                  p[:, dst, cols]))
                else:
                    p[:, dst, cols] = blocks[n[0]][n[1]][:, src_rows, :]
            # My last rows are my lower neighbour's top ghost, my first
            # rows my upper neighbour's bottom ghost.
            for side, src_rows, n in ((0, slice(h - d, h), nbr(i + 1, j)),
                                      (1, slice(0, d), nbr(i - 1, j))):
                if n is not None and owner(n) != rank:
                    sends.append((owner(n), tag(n, side),
                                  blocks[i][j][:, src_rows, :].to(dtype)))
    _swap(sends, recvs)
    # Phase 2: columns (side 2 / 3: the left / right ghost).  The sources
    # are interior columns, which this phase does not write.
    src_left, src_right = slice(d, 2 * d), slice(w, w + d)
    if packed:
        stage = [[None if p is None else (p[:, :, src_left].contiguous(),
                                          p[:, :, src_right].contiguous())
                  for p in prow] for prow in pads]
    sends, recvs = [], []
    for i in range(R):
        for j in range(Cg):
            p = pads[i][j]
            if p is None:
                continue
            # My left ghost is the left neighbour's right edge; my right
            # ghost the right neighbour's left edge.
            for side, dst, src, n in ((2, slice(0, d), 1, nbr(i, j - 1)),
                                      (3, slice(d + w, w + 2 * d), 0,
                                       nbr(i, j + 1))):
                if n is None:
                    p[:, :, dst] = 0
                elif owner(n) != rank:
                    recvs.append((owner(n), tag((i, j), side),
                                  p[:, :, dst]))
                elif packed:
                    p[:, :, dst] = stage[n[0]][n[1]][src]
                else:
                    p[:, :, dst] = pads[n[0]][n[1]][
                        :, :, (src_left, src_right)[src]]
            for side, src, n in ((2, src_right, nbr(i, j + 1)),
                                 (3, src_left, nbr(i, j - 1))):
                if n is not None and owner(n) != rank:
                    sends.append((owner(n), tag(n, side), p[:, :, src]))
    _swap(sends, recvs)
    return pads


def _swap(sends, recvs) -> None:
    """``multihost.swap`` of one phase's slabs between ranks (none in one
    process)."""
    if sends or recvs:
        from parallel_convolution_tpu_torch.parallel import multihost

        multihost.swap(sends, recvs)
