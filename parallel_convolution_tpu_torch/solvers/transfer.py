"""Multigrid transfer operators as stencil forms (the rank-2 half of the JAX
package's ``solvers/transfer.py``).

Restriction (full weighting) and prolongation (bilinear) are the
inter-grid couplings of the V-cycle, and they are stencils: full weighting
is the 3×3 ``[[1,2,1],[2,4,2],[1,2,1]]/16`` tap array (the registry's
``blur3``) applied at every coarse-aligned fine point, bilinear
prolongation its adjoint up to scaling.  Both register in the kernel-form
registry (``parallel.kernels``) under their own stencil forms
(``restrict`` / ``prolong``), keyed ``(rank=2, name, boundary)``, and build
functions over the fine level's grid of blocks, given as the R×C list of
``(C, h, w)`` blocks or as the stacked ``(R·C, C, h, w)`` grid (returned in
the form given):

* ghost cells come from the same two-phase halo exchange
  (``halo.halo_exchange_stacked``, depth 1: both operators touch at most
  one neighbour point), and every step runs on all blocks at once, a few
  ops however many blocks the grid has; built with ``per_block=True`` (a
  grid of slots) each block is exchanged in a buffer of its own
  (``halo.exchange_per_block``) and transferred on its own device, the
  same values;
* out-of-image positions are re-masked through ``step._valid_mask``, so
  the pad-to-multiple rim behaves like the serial zero-pad formula.

The operators are plain PyTorch (the JAX package's are ``jnp``, outside
any Pallas kernel), so they run the same on the card and the CPU.

Grid alignment (the JAX package's contract, unchanged):

* ``zero`` — odd-centered: coarse ``k`` sits at fine ``2k+1``, so the
  coarse ghost ring coincides with the fine ghost ring at every level.
  Coarse extent ``(n−1)//2``.
* ``periodic`` — even-centered: coarse ``k`` at fine ``2k``.  Coarse
  extent ``n//2``; the level planner refuses to coarsen a torus level
  whose extents cannot keep grid-divisible alignment.

With even fine blocks (the level planner's padding rule) both centerings
keep every coarse point's stencil within its block plus a depth-1 halo.

The rank-3 forms (:func:`build_restrict_fw3`,
:func:`build_prolong_trilinear`) are the same operators with one more
axis, over the stacked grid of (F, D, bh, bw) volume blocks: the
separable [1/4, 1/2, 1/4] tensor product and its trilinear adjoint, the
centering and extent rule unchanged per axis, the depth axis (whole in
every block) coarsened in place with the planes beyond
``coarse_extent(D)`` masked to zero.  They register under rank 3; no CLI
path drives them (the JAX CLI refuses ``--rank 3 --solver multigrid``).
"""

from __future__ import annotations

import torch

from parallel_convolution_tpu_torch.ops import rdma
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import halo, kernels as kernel_forms

__all__ = ["FW_FILTER", "build_prolong_bilinear", "build_prolong_trilinear",
           "build_restrict_fw", "build_restrict_fw3", "coarse_extent"]

# Full weighting IS the /16 pyramid stencil — the registry's blur3 taps.
FW_FILTER = get_filter("blur3")


def coarse_extent(n: int, boundary: str = "zero") -> int:
    """Coarse-grid extent of a fine extent ``n`` under the centering the
    boundary requires: ``(n−1)//2`` for zero (odd-centered — coarse k at
    fine 2k+1, last point strictly inside), ``n//2`` for periodic
    (even-centered wrap; the planner enforces even ``n``)."""
    n = int(n)
    return n // 2 if boundary == "periodic" else (n - 1) // 2


def _check_even_block(block_hw, op: str) -> None:
    bh, bw = block_hw
    if bh % 2 or bw % 2:
        raise ValueError(
            f"{op} needs even per-device blocks (coarse-aligned fine "
            f"points stay device-local), got {tuple(block_hw)}; the level "
            "planner pads extents to 2*grid multiples")


def _stacked(state) -> torch.Tensor:
    """The stacked (R·C, C, h, w) grid of a level state (one block: a view,
    no copy)."""
    if torch.is_tensor(state):
        return state
    flat = [b for row in state for b in row]
    return flat[0].unsqueeze(0) if len(flat) == 1 else torch.stack(flat)


def _like(x: torch.Tensor, state, grid_shape):
    """``x`` (stacked) in the form of ``state``: stacked, or R×C views."""
    return x if torch.is_tensor(state) else rdma.unstack_blocks(x, grid_shape)


def _masker(valid_hw, block_hw, grid_shape):
    """The stacked (R·C, 1, h, w) validity mask of every block on
    ``valid_hw`` at ``block_hw`` blocks, cached per device and dtype."""
    from parallel_convolution_tpu_torch.parallel.step import _valid_mask

    R, Cg = grid_shape
    masks: dict = {}

    def mask(like: torch.Tensor) -> torch.Tensor:
        key = (like.device, like.dtype)
        if key not in masks:
            masks[key] = torch.stack([
                _valid_mask(valid_hw, block_hw, (i, j), device=like.device)
                for i in range(R) for j in range(Cg)]).to(like.dtype)
        return masks[key]

    return mask


def _correlate_subsampled(padded: torch.Tensor, off: int,
                          out_hw) -> torch.Tensor:
    """``conv.correlate_padded(padded, FW_FILTER)[:, off::2, off::2]``,
    computed at the kept points only: the same taps in the same order,
    one multiply and one add each, so the same values at a quarter of
    the work."""
    ch, cw = out_hw
    x = padded.to(torch.float32)
    acc = torch.zeros((*x.shape[:-2], ch, cw), dtype=torch.float32,
                      device=x.device)
    taps = [float(t) for t in FW_FILTER.taps.reshape(-1)]
    i = 0
    for dy in range(FW_FILTER.size):
        for dx in range(FW_FILTER.size):
            acc = acc + taps[i] * x[..., off + dy:off + dy + 2 * ch:2,
                                    off + dx:off + dx + 2 * cw:2]
            i += 1
    return acc


def _block_mask(valid_hw, block_hw):
    """The (1, h, w) validity mask of block (i, j), per device and dtype,
    cached (the per-block twin of :func:`_masker`)."""
    from parallel_convolution_tpu_torch.parallel.step import _valid_mask

    masks: dict = {}

    def mask(index, like: torch.Tensor) -> torch.Tensor:
        key = (index, like.device, like.dtype)
        if key not in masks:
            masks[key] = _valid_mask(valid_hw, block_hw, index,
                                     device=like.device).to(like.dtype)
        return masks[key]

    return mask


def _per_block(op, grid_shape, boundary: str, needs_mask: bool, mask,
               grid=None):
    """``op`` (a padded block → its result) over an R×C list of blocks on
    their own devices: one depth-1 per-block exchange, then each block's
    result on its device, masked where ``needs_mask``.  ``grid``: the
    grid, whose blocks this rank holds its share of where it spans
    several processes."""
    def run(blocks):
        padded = halo.exchange_per_block(blocks, 1, tuple(grid_shape),
                                         boundary, grid=grid)
        out = []
        for i, row in enumerate(padded):
            orow = []
            for j, p in enumerate(row):
                if p is None:
                    orow.append(None)
                    continue
                c = op(p)
                if needs_mask:
                    c = c * mask((i, j), c)
                orow.append(c.to(blocks[i][j].dtype))
            out.append(orow)
        return out

    return run


def build_restrict_fw(grid_shape, valid_hw, block_hw, boundary: str = "zero",
                      per_block: bool = False, grid=None):
    """Full-weighting restriction over the fine level's blocks:
    ``(C, bh, bw) → (C, bh/2, bw/2)`` for every block of the
    ``grid_shape`` grid.

    One depth-1 halo exchange, one ``blur3``-tap correlation (the full
    weighting stencil) at the centering subsample (odd fine indices for
    zero, even for periodic), and the coarse validity mask: positions
    beyond ``coarse_extent(valid)`` are zero.  ``per_block`` (a grid of
    slots): the blocks list in, each block on its own device; ``grid``
    (with ``per_block``) the grid, whose rims between ranks cross by
    ``multihost.swap`` where it spans processes.
    """
    _check_even_block(block_hw, "restrict_fw")
    periodic = boundary == "periodic"
    R, Cg = grid_shape
    cvalid = (coarse_extent(valid_hw[0], boundary),
              coarse_extent(valid_hw[1], boundary))
    cblock = (block_hw[0] // 2, block_hw[1] // 2)
    needs_mask = not periodic and (
        cvalid[0] != cblock[0] * R or cvalid[1] != cblock[1] * Cg)
    # Local index of coarse point 0's fine image: 1 (odd-centered, zero)
    # or 0 (even-centered, periodic); with even blocks, fine 2k+off lies
    # inside the block and the taps reach one cell beyond at most.
    off = 0 if periodic else 1
    if per_block:
        return _per_block(lambda p: _correlate_subsampled(p, off, cblock),
                          (R, Cg), boundary, needs_mask,
                          _block_mask(cvalid, cblock), grid)
    mask = _masker(cvalid, cblock, (R, Cg))

    def restrict(state):
        x = _stacked(state)
        p = halo.halo_exchange_stacked(x, 1, (R, Cg), boundary)
        c = _correlate_subsampled(p, off, cblock)
        if needs_mask:
            c = c * mask(c)
        return _like(c.to(x.dtype), state, (R, Cg))

    return restrict


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """Alternate a/b along ``axis`` (negative: from the end): out[2i] =
    a[i], out[2i+1] = b[i]."""
    shape = list(a.shape)
    shape[axis] *= 2
    return torch.stack([a, b], dim=axis % a.dim() + 1).reshape(shape)


def build_prolong_bilinear(grid_shape, valid_hw, block_hw,
                           boundary: str = "zero", per_block: bool = False,
                           grid=None):
    """Bilinear prolongation over the fine level's grid: every block's
    ``(C, bh/2, bw/2)`` coarse correction (already moved onto the fine
    grid at half blocks) → ``(C, bh, bw)``.

    Coarse-aligned fine points copy their coarse point; the points between
    average the two (four, at the diagonal) bracketing coarse points: the
    tensor product of the 1-D ``[1/2, 1, 1/2]`` stencil, as two interleave
    passes over the depth-1 halo-padded coarse block.  Beyond-extent
    coarse reads are the boundary's ghost convention: 0 for zero, wrap for
    periodic.  ``per_block`` and ``grid`` as in :func:`build_restrict_fw`.
    """
    _check_even_block(block_hw, "prolong_bilinear")
    periodic = boundary == "periodic"
    R, Cg = grid_shape
    m, n = block_hw[0] // 2, block_hw[1] // 2
    needs_mask = not periodic and (
        valid_hw[0] != block_hw[0] * R or valid_hw[1] != block_hw[1] * Cg)
    mask = _masker(valid_hw, block_hw, (R, Cg))

    def interpolate(p: torch.Tensor) -> torch.Tensor:
        """The padded coarse blocks (..., m+2, n+2) → (..., 2m, 2n)."""
        if periodic:
            # Even-centered: fine 2k = coarse k; fine 2k+1 = mean(k, k+1).
            a = p[..., 1:m + 1, :]
            b = p[..., 2:m + 2, :]
            rows = _interleave(a, (a + b) * 0.5, axis=-2)  # (..., 2m, n+2)
            al = rows[..., 1:n + 1]
            bl = rows[..., 2:n + 2]
            return _interleave(al, (al + bl) * 0.5, axis=-1)
        # Odd-centered: fine 2k+1 = coarse k; fine 2k = mean(k-1, k)
        # (coarse ghost −1 reads 0 — the fine boundary line itself).
        a = p[..., 0:m, :]
        b = p[..., 1:m + 1, :]
        rows = _interleave((a + b) * 0.5, b, axis=-2)      # (..., 2m, n+2)
        al = rows[..., 0:n]
        bl = rows[..., 1:n + 1]
        return _interleave((al + bl) * 0.5, bl, axis=-1)   # (..., 2m, 2n)

    if per_block:
        return _per_block(interpolate, (R, Cg), boundary, needs_mask,
                          _block_mask(valid_hw, block_hw), grid)

    def prolong(state):
        c = _stacked(state)
        f = interpolate(halo.halo_exchange_stacked(c, 1, (R, Cg), boundary))
        if needs_mask:
            f = f * mask(f)
        return _like(f.to(c.dtype), state, (R, Cg))

    return prolong


# -- rank 3: the same operators, one more axis ------------------------------

_FW_TAPS = (0.25, 0.5, 0.25)


def _check_even_block3(depth: int, block_hw, op: str) -> None:
    _check_even_block(block_hw, op)
    if int(depth) % 2:
        raise ValueError(
            f"{op} needs an even depth (coarse-aligned planes), got "
            f"D={depth}")


def _fw_axis(p: torch.Tensor, axis: int) -> torch.Tensor:
    """One [1/4, 1/2, 1/4] pass along ``axis`` of a padded array: it
    consumes that axis's depth-1 ghost."""
    n = p.shape[axis]
    lo = [slice(None)] * p.dim()
    cc = [slice(None)] * p.dim()
    hi = [slice(None)] * p.dim()
    lo[axis], cc[axis], hi[axis] = (
        slice(0, n - 2), slice(1, n - 1), slice(2, n))
    return (_FW_TAPS[0] * p[tuple(lo)] + _FW_TAPS[1] * p[tuple(cc)]
            + _FW_TAPS[2] * p[tuple(hi)])


def build_restrict_fw3(grid_shape, depth: int, valid_hw, block_hw,
                       boundary: str = "zero"):
    """Rank-3 full weighting over the fine level's stacked volume blocks:
    ``(F, D, bh, bw) → (F, D/2, bh/2, bw/2)`` for every block of the
    grid.

    One depth-1 6-face exchange (``volumes.halo3``), three separable FW
    passes (the 3×3×3 tensor-product stencil), the centering subsample
    per axis, then the masks: the coarse (H, W) validity mask of rank 2,
    and a depth mask zeroing the coarse planes beyond ``coarse_extent(D)``
    (the odd-centered zero coarsening drops the last plane of an even
    depth).
    """
    from parallel_convolution_tpu_torch.volumes import forms, halo3

    _check_even_block3(depth, block_hw, "restrict_fw(rank 3)")
    periodic = boundary == "periodic"
    R, Cg = grid_shape
    cvalid = (coarse_extent(valid_hw[0], boundary),
              coarse_extent(valid_hw[1], boundary))
    cblock = (block_hw[0] // 2, block_hw[1] // 2)
    cdepth, cvalid_d = int(depth) // 2, coarse_extent(depth, boundary)
    needs_mask = not periodic and (
        cvalid[0] != cblock[0] * R or cvalid[1] != cblock[1] * Cg)
    off = 0 if periodic else 1

    def restrict(v):
        p = halo3.volume_halo_exchange(v, 1, (R, Cg), boundary)
        for axis in (-3, -2, -1):
            p = _fw_axis(p, axis)
        c = p[..., off::2, off::2, off::2]
        if needs_mask:
            c = c * forms._valid_mask3(cvalid, cblock, (R, Cg), 0,
                                       c.device).to(c.dtype)
        if cvalid_d < cdepth:
            dmask = (torch.arange(cdepth, device=c.device)
                     < cvalid_d).to(c.dtype)
            c = c * dmask[:, None, None]
        return c.to(v.dtype).contiguous()

    return restrict


def build_prolong_trilinear(grid_shape, depth: int, valid_hw, block_hw,
                            boundary: str = "zero"):
    """Rank-3 trilinear prolongation on the fine level's stacked grid:
    ``(F, D/2, bh/2, bw/2) → (F, D, bh, bw)`` for every block, three interleave
    passes over the depth-1 6-face-padded coarse blocks, one per axis,
    each rank 2's centering rule (odd-centered zero reads the coarse
    ghost as 0; even-centered periodic wraps)."""
    from parallel_convolution_tpu_torch.volumes import forms, halo3

    _check_even_block3(depth, block_hw, "prolong_trilinear")
    periodic = boundary == "periodic"
    R, Cg = grid_shape
    m = (int(depth) // 2, block_hw[0] // 2, block_hw[1] // 2)
    needs_mask = not periodic and (
        valid_hw[0] != block_hw[0] * R or valid_hw[1] != block_hw[1] * Cg)

    def prolong(c):
        p = halo3.volume_halo_exchange(c, 1, (R, Cg), boundary)
        for axis, n in zip((-3, -2, -1), m):
            sl_a = [slice(None)] * p.dim()
            sl_b = [slice(None)] * p.dim()
            if periodic:
                # Even-centered: fine 2k = coarse k; 2k+1 = mean(k, k+1).
                sl_a[axis], sl_b[axis] = slice(1, n + 1), slice(2, n + 2)
                a, b = p[tuple(sl_a)], p[tuple(sl_b)]
                p = _interleave(a, (a + b) * 0.5, axis)
            else:
                # Odd-centered: fine 2k+1 = coarse k; 2k = mean(k-1, k).
                sl_a[axis], sl_b[axis] = slice(0, n), slice(1, n + 1)
                a, b = p[tuple(sl_a)], p[tuple(sl_b)]
                p = _interleave((a + b) * 0.5, b, axis)
        if needs_mask:
            p = p * forms._valid_mask3(valid_hw, block_hw, (R, Cg), 0,
                                       p.device).to(p.dtype)
        return p.to(c.dtype)

    return prolong


def _register_transfer_forms() -> None:
    from parallel_convolution_tpu_torch.utils.config import BOUNDARIES

    kernel_forms.register(kernel_forms.KernelForm(
        name="restrict_fw", rank=2, stencil_form="restrict",
        boundaries=tuple(BOUNDARIES), build=build_restrict_fw))
    kernel_forms.register(kernel_forms.KernelForm(
        name="prolong_bilinear", rank=2, stencil_form="prolong",
        boundaries=tuple(BOUNDARIES), build=build_prolong_bilinear))
    kernel_forms.register(kernel_forms.KernelForm(
        name="restrict_fw", rank=3, stencil_form="restrict",
        boundaries=tuple(BOUNDARIES), build=build_restrict_fw3))
    kernel_forms.register(kernel_forms.KernelForm(
        name="prolong_trilinear", rank=3, stencil_form="prolong",
        boundaries=tuple(BOUNDARIES), build=build_prolong_trilinear))


_register_transfer_forms()
