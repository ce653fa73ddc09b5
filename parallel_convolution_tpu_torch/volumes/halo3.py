"""6-face ghost exchange for (F, D, h, w) volume blocks (the JAX package's
``volumes/halo3.py``).

The grid splits the (H, W) plane into blocks; the depth axis D lies whole
in every block.  So the six ghost faces are of two kinds:

* the ±D faces belong to no neighbour: a local pad, zeros for the
  ``zero`` boundary, a wrap for ``periodic``;
* the ±H and ±W faces are rank 2's row and column slabs with the
  depth-padded fields as channels: ``parallel/halo.py``'s ghost fill on
  the padded grid with (F, D+2r) folded into its channel axis.

Phase order (D, then rows, then columns at full padded height) brings the
twelve edge and eight corner regions without diagonal copies, as in the
JAX package: the row slabs carry the fresh D ghosts, the column slabs
both.  Where every block lives on one device, the exchange writes one
padded grid: the interiors in one copy, the D faces, then the row and
column phases as a few whole-grid copies (:func:`volume_halo_exchange`).
On a grid of slots each block is padded on its own device
(:func:`volume_exchange_per_block`): D locally, then rank 2's per-block
exchange (``halo.exchange_per_block``) with the depth-padded fields as
channels, one slab between devices a ghost face.
"""

from __future__ import annotations

import torch

from parallel_convolution_tpu_torch.parallel import halo
from parallel_convolution_tpu_torch.utils.config import BOUNDARIES

__all__ = ["volume_exchange_per_block", "volume_halo_exchange"]


def volume_halo_exchange(blocks: torch.Tensor, r: int, grid_shape,
                         boundary: str = "zero") -> torch.Tensor:
    """Pad all six faces of every (F, D, h, w) block with r-deep ghosts.

    ``blocks`` is the stacked grid (R·C, F, D, h, w), block ``i * C + j``
    at grid position (i, j); returns the stacked (R·C, F, D+2r, h+2r,
    w+2r).  Raises the JAX package's errors: an unknown boundary, a block
    that is not (F, D, h, w), a periodic wrap deeper than D.
    """
    if boundary not in BOUNDARIES:
        raise ValueError(
            f"boundary must be one of {BOUNDARIES}, got {boundary!r}")
    if blocks.dim() != 5:
        raise ValueError(f"volume block must be (F, D, h, w), got shape "
                         f"{tuple(blocks.shape[1:])}")
    x = blocks
    periodic = boundary == "periodic"
    r = int(r)
    R, Cg = grid_shape
    N, F, D, h, w = x.shape
    if N != R * Cg:
        raise ValueError(f"expected {R * Cg} blocks for grid "
                         f"{tuple(grid_shape)}, got {N}")
    if periodic and D < r:
        raise ValueError(
            f"periodic depth wrap needs D >= ghost depth, got D={D} < r={r}")
    d = halo._check(boundary, r, (h, w))
    p = x.new_empty((R, Cg, F, D + 2 * d, h + 2 * d, w + 2 * d))
    xv = x.reshape(R, Cg, F, D, h, w)
    rows, cols = slice(d, d + h), slice(d, d + w)
    p[..., d:d + D, rows, cols] = xv
    # Phase 0: the resident depth axis, a local pad.
    if periodic:
        p[..., :d, rows, cols] = xv[..., D - d:, :, :]
        p[..., d + D:, rows, cols] = xv[..., :d, :, :]
    else:
        p[..., :d, rows, cols] = 0
        p[..., d + D:, rows, cols] = 0
    # Phases 1 and 2: the (H, W) plane, rank 2's ghost fill with the
    # depth-padded fields as channels.
    if d:
        halo._fill_ghosts(
            p.view(R, Cg, F * (D + 2 * d), h + 2 * d, w + 2 * d), d,
            periodic)
    return p.view(N, F, D + 2 * d, h + 2 * d, w + 2 * d)


def _check_volume(boundary: str, D: int, r: int) -> None:
    if boundary not in BOUNDARIES:
        raise ValueError(
            f"boundary must be one of {BOUNDARIES}, got {boundary!r}")
    if boundary == "periodic" and D < r:
        raise ValueError(
            f"periodic depth wrap needs D >= ghost depth, got D={D} < r={r}")


def _pad_depth(b: torch.Tensor, d: int, periodic: bool) -> torch.Tensor:
    """Phase 0 on one (F, D, h, w) block: its D faces, a local pad (zeros,
    or the wrap)."""
    F, D, h, w = b.shape
    p = b.new_empty((F, D + 2 * d, h, w))
    p[:, d:d + D] = b
    if periodic:
        p[:, :d] = b[:, D - d:]
        p[:, d + D:] = b[:, :d]
    else:
        p[:, :d] = 0
        p[:, d + D:] = 0
    return p


def volume_exchange_per_block(blocks, r: int, grid_shape,
                              boundary: str = "zero", grid=None):
    """:func:`volume_halo_exchange` on a grid of slots: ``blocks`` is the
    R×C list of (F, D, h, w) blocks, each on its slot's device; returns the
    R×C list of (F, D+2r, h+2r, w+2r) padded blocks on the same devices,
    the same values block for block.  D stays resident: each block pads
    its D faces locally, then (H, W) is exchanged in the two phases of
    ``halo.exchange_per_block`` with (F, D+2r) folded into the channel
    axis, so the row slabs carry the fresh D ghosts and the corners
    arrive in two hops.  On a ``grid`` over several processes ``blocks``
    is this rank's share (``None`` elsewhere) and a face whose neighbour
    lives on another rank crosses by ``multihost.swap``, as the planar
    exchange's slabs do: from the padded buffer on the card itself under
    the device transport (NCCL), in ``multihost.wire_order``."""
    from parallel_convolution_tpu_torch.parallel.mesh import first_block

    b0 = first_block(blocks, None)
    if b0 is None:
        return [list(row) for row in blocks]
    if b0.dim() != 4:
        raise ValueError(f"volume block must be (F, D, h, w), got shape "
                         f"{tuple(b0.shape)}")
    F, D, h, w = b0.shape
    r = int(r)
    _check_volume(boundary, D, r)
    d = halo._check(boundary, r, (h, w))
    periodic = boundary == "periodic"
    folded = [[None if b is None else
               _pad_depth(b, d, periodic).view(F * (D + 2 * d), h, w)
               for b in row] for row in blocks]
    padded = halo.exchange_per_block(folded, d, tuple(grid_shape), boundary,
                                     grid=grid)
    return [[None if p is None else
             p.view(F, D + 2 * d, h + 2 * d, w + 2 * d) for p in row]
            for row in padded]
