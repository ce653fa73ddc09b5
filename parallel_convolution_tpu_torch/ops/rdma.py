"""The ``cuda_rdma`` backend's kernels, their plain PyTorch version and their
launch counters (the port of the JAX package's ``ops/pallas_rdma.py``).

* :func:`rdma_block` (K3, ``csrc/rdma.cu:rdma_block_kernel``) replaces
  ``ops/pallas_rdma.py:_rdma_kernel`` (``fused_rdma_step(tiled=False)``):
  one CUDA block per (grid block, channel) holds the whole block and its
  ghosts in shared memory.
* :func:`rdma_tiled` (K4, ``csrc/rdma.cu:rdma_tiled_kernel``) replaces
  ``ops/pallas_rdma.py:_rdma_tiled_kernel`` (``fused_rdma_step(tiled=True)``)
  for blocks too large for that: K2's output tiles over every block.

Both read every ghost straight from the neighbouring block's buffer (all
blocks of the grid are on the one card) and run T levels in one launch for
the whole grid: no halo exchange and no padded copy in device memory.
:func:`fused_rdma_step` is the entry point; :func:`rdma_plan` picks the
kernel and splits deep chunks into level groups.  The kernels take the
grid as one stacked (R·C, C, h, w) tensor (:func:`stack_blocks`), and the
``cuda_rdma`` chunk loop carries it in that form
(:func:`fused_rdma_stacked`), so a launch costs the host one pointer table
built on the card and no work per block.

The wrapper takes the plain version (:func:`fused_rdma_step_plain`: the
halo exchange, then K2's plain version on every block) only because the
blocks it was given lie on the CPU.  On CUDA tensors it launches K3 or K4
or raises; there is no fallback.

**On a grid of slots** (``mesh.Grid.devices``; :func:`fused_rdma_slots`)
the same kernels run in their per-device form, the port of the TPU
kernels' one program per device: one launch per slot
(:func:`rdma_block_slot`, :func:`rdma_tiled_slot`), on the slot's own
device and stream, computing that slot's block from a pointer table that
holds every block's address on its own device.  The carry is one stacked
tensor per device (:class:`SlotCarry`), double-buffered.  The barrier
between slots, the counterpart of ``_neighbor_barrier``, is events: a
slot's launch waits on its neighbours' previous launches and nothing else,
with no host synchronisation.  It closes both hazards:

* **read after write**: launch N+1 of a slot reads its neighbours'
  outputs of launch N;
* **write after read**: launch N+1 writes the buffer that launch N read
  (the TPU's cross-invocation race), which the neighbours' launches N
  read too.  The buffers are held for the whole run, never freed to
  PyTorch's caching allocator between launches, because the allocator
  would hand memory that another stream (or card) still reads to the next
  allocation on the owner's stream at once, and ``record_stream`` does not
  cover a stream of another device.

With ``col_mode="packed"`` each slot first gathers its two edge column
slabs into its staging (:func:`rdma_pack`), and its left and right
neighbours wait on that before they read it: the TPU's two phases.  Peer
access between distinct cards is enabled up front and a refusal raises:
there is no host-staged fallback.  On the CPU a grid of slots runs
:func:`fused_rdma_slots_plain`, the JAX semantics literally.

**The overlapped pipeline** (``overlap=True``, ``partitioned``: the TPU
kernels' interior-first schedules, ``_rdma_kernel`` and
``_rdma_tiled_kernel`` with ``overlap=True``).  On the TPU the exchange is
DMA traffic in flight while the interior computes; here every ghost is
read in place, and the exchange is the barrier.  So each slot launches its
K3 / K4 region by region (:func:`rdma_block_region`,
:func:`rdma_tiled_region`: the same kernels on an output rectangle): the
interior of :func:`overlap_regions` first, with no wait, then each band
after exactly the events of the neighbours its read window covers
(:func:`region_neighbours`; :func:`overlap_schedule`).  A slot that runs
late holds back only the bands next to it, not its neighbours' interiors.
The corners are read from the diagonal block, so a column band waits on
the diagonals too, where the TPU's wait set names the row and column slabs
that carried them.  On the CPU :func:`fused_rdma_slots_plain` runs the
same schedule from buffers whose unwaited ghosts are NaN, and raises if a
NaN reaches a region: a missed wait.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from parallel_convolution_tpu_torch.ops import stencil
from parallel_convolution_tpu_torch.ops.filters import Filter
from parallel_convolution_tpu_torch.parallel import channels, halo
from parallel_convolution_tpu_torch.utils.config import BOUNDARIES


class RdmaPlan(NamedTuple):
    """How one chunk of T levels runs on the card."""

    kernel: str                 # "block" (K3) or "tiled" (K4)
    tile: tuple[int, int]       # K4's output tile; K3's is the whole block
    groups: list[int]           # levels per launch: K3/K4 runs the first
                                # group (and the exchange), K2 the others


def _check_depth(r: int, T: int, block_hw) -> None:
    h, w = block_hw
    d = r * T
    if min(h, w) < d:
        raise ValueError(
            f"block {(h, w)} smaller than the ghost depth r*fuse = {d} "
            f"(radius {r} x fuse {T}); use a smaller fuse or coarser mesh")


def rdma_plan(r: int, T: int, block_hw, tile=None,
              smem_limit: int = stencil.H100_SMEM_OPTIN) -> RdmaPlan:
    """K3 or K4 for T levels of radius ``r`` on ``block_hw`` blocks.

    K3 when one (block, channel) fits whole in one CUDA block's shared
    memory with its f32 level buffer, (h+2rT)(w+2rT)·4 bytes
    ≤ ``smem_limit`` (the card's opt-in limit); K4 otherwise, with K2's
    tile and level groups (:func:`stencil.fused_plan`).  Raises the JAX
    package's ``ValueError`` for a block smaller than r·T.
    """
    h, w = block_hw
    _check_depth(r, T, (h, w))
    if stencil.fused_smem_bytes(r, T, (h, w)) <= smem_limit:
        return RdmaPlan("block", (h, w), [T])
    th, tw, groups = stencil.fused_plan(r, T, (h, w), tile, smem_limit)
    return RdmaPlan("tiled", (th, tw), groups)


def stack_blocks(blocks, grid_shape) -> torch.Tensor:
    """The grid's R×C list of (C, h, w) blocks as one (R·C, C, h, w) tensor,
    block ``i * C + j`` at grid position (i, j): the form the kernels and
    the ``cuda_rdma`` chunk loop carry."""
    R, Cg = grid_shape
    if len(blocks) != R or any(len(row) != Cg for row in blocks):
        raise ValueError(f"expected {R}x{Cg} blocks for grid {grid_shape}")
    x = blocks[0][0]
    for row in blocks:
        for b in row:
            if (b.shape, b.dtype, b.device) != (x.shape, x.dtype, x.device):
                raise ValueError("every block of the grid must have one "
                                 "shape, dtype and device")
    return torch.stack([b for row in blocks for b in row])


def unstack_blocks(x: torch.Tensor, grid_shape) -> list[list[torch.Tensor]]:
    """Inverse of :func:`stack_blocks`: R×C views of ``x``."""
    R, Cg = grid_shape
    return [[x[i * Cg + j] for j in range(Cg)] for i in range(R)]


def _check_stacked(x: torch.Tensor, grid_shape) -> None:
    R, Cg = grid_shape
    if x.dim() != 4 or x.shape[0] != R * Cg:
        raise ValueError(f"expected a stacked ({R * Cg}, C, h, w) grid for "
                         f"grid {tuple(grid_shape)}, got {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# The overlapped pipeline's geometry (the JAX package's pallas_rdma.py:202-281)
# ---------------------------------------------------------------------------


def overlap_regions(h: int, w: int, d: int):
    """The interior-first output partition of one (h, w) block at ghost
    depth ``d``, as ``(interior, row_bands, col_bands)``, each a list of
    half-open ``(r0, r1, c0, c1)`` rectangles (empties dropped): the
    interior ``d`` clear of every edge, the top and bottom bands on the
    interior columns, the full-height left and right bands.  The three
    tile the block exactly for any geometry; the interior is empty where
    ``min(h, w) <= 2d``.  (The JAX package's ``overlap_regions``.)"""
    t, b = min(d, h), max(h - d, min(d, h))
    l, rt = min(d, w), max(w - d, min(d, w))
    interior = [(t, b, l, rt)]
    row_bands = [(0, t, l, rt), (b, h, l, rt)]
    col_bands = [(0, h, 0, l), (0, h, rt, w)]
    keep = lambda rs: [x for x in rs if x[0] < x[1] and x[2] < x[3]]
    return keep(interior), keep(row_bands), keep(col_bands)


def overlap_region_slabs(h: int, w: int, d: int):
    """The labelled partition with each region's slab wait set, as the JAX
    package's TPU kernels wait: ``[(label, (r0, r1, c0, c1),
    frozenset(directions))]`` in compute order (interior, top, bottom,
    left, right; empties dropped), a direction in the set where the
    region's (rows + 2d, cols + 2d) read window overlaps that slab's
    inbound write (row slabs on the interior columns, column slabs at the
    full padded height: the corners' second hop).  (The JAX package's
    ``overlap_region_slabs``.)"""
    interior, row_bands, col_bands = overlap_regions(h, w, d)
    writes = {
        "up": ((0, d), (d, d + w)),
        "down": ((h + d, h + 2 * d), (d, d + w)),
        "left": ((0, h + 2 * d), (0, d)),
        "right": ((0, h + 2 * d), (w + d, w + 2 * d)),
    }

    def waits(rect):
        r0, r1, c0, c1 = rect
        rr, cc = (r0, r1 + 2 * d), (c0, c1 + 2 * d)
        return frozenset(
            name for name, (gr, gc) in writes.items()
            if rr[0] < gr[1] and gr[0] < rr[1]
            and cc[0] < gc[1] and gc[0] < cc[1])

    out = [("interior", rect, waits(rect)) for rect in interior]
    for rect in row_bands:
        out.append(("top" if rect[0] == 0 else "bottom", rect, waits(rect)))
    for rect in col_bands:
        out.append(("left" if rect[2] == 0 else "right", rect, waits(rect)))
    return out


def tiled_window_hazards(wi, wj, *, th, tw, h, w, sub_v, lane=128):
    """Whether the JAX tiled kernel's ``(wi, wj)`` window, whose read
    region is ``(th + 2*sub_v, tw + 2*lane)``, overlaps each direction's
    transferred band.  (The JAX package's ``tiled_window_hazards``; the
    port's K4 reads its window's neighbours in place and needs no window
    ledger: a region launch waits before it starts.)"""
    ext_h, ext_w = th + 2 * sub_v, tw + 2 * lane
    return {"up": wi == 0, "down": wi * th + ext_h > h + sub_v,
            "left": wj == 0, "right": wj * tw + ext_w > w + lane}


# The eight neighbours of a block, as (row, column) offsets; the
# neighbour table's entry of offset (di, dj) is (di + 1) * 3 + dj + 1.
NEIGHBOURS = tuple(o for o in channels.OFFSETS if o != (0, 0))


def covered_neighbours(rect, h: int, w: int, depth: int) -> frozenset:
    """The neighbours whose cells the window ``rect`` ± ``depth`` covers,
    ``rect`` a half-open (r0, r1, c0, c1) in the (h, w) block's own
    coordinates (it may reach beyond the block by the output's rim)."""
    r0, r1, c0, c1 = rect

    def axis(lo, hi, n):
        return {k for k, (a, b) in ((-1, (lo, min(hi, 0))),
                                    (0, (max(lo, 0), min(hi, n))),
                                    (1, (max(lo, n), hi))) if a < b}

    rows = axis(r0 - depth, r1 + depth, h)
    cols = axis(c0 - depth, c1 + depth, w)
    return frozenset((di, dj) for di in rows for dj in cols) - {(0, 0)}


def region_neighbours(oh: int, ow: int, d: int, ext: int):
    """The overlapped pipeline's regions of one launch and, for each, the
    neighbours it waits for: ``[(label, (r0, r1, c0, c1), frozenset of
    (di, dj))]`` in the JAX package's compute order (interior, top,
    bottom, left, right), the regions those of :func:`overlap_regions` on
    the launch's (oh, ow) = (h + 2·ext, w + 2·ext) output at the chunk's
    ghost depth ``d`` = r·T.  A region's set is every neighbour whose
    cells its level-0 read window covers: the output rectangle shifted
    by ``-ext`` into the block's frame, widened by the launch's reach
    ``d - ext``.  Read after write: it reads their edges.  At ``ext`` = 0
    the same set is the neighbours whose last reads its writes must
    follow, since a neighbour read this block ``d`` deep toward itself.
    The interior, where there is one, waits for none.  The set is the JAX
    wait set (:func:`overlap_region_slabs`, at ``ext`` = 0) plus each
    diagonal whose row and column directions are both in it: the port
    reads the corners from the diagonal block, where the TPU carried them
    in a second hop."""
    h, w = oh - 2 * ext, ow - 2 * ext
    reach = d - ext
    return [(label, rect, covered_neighbours(
        (rect[0] - ext, rect[1] - ext, rect[2] - ext, rect[3] - ext),
        h, w, reach))
        for label, rect, _ in overlap_region_slabs(oh, ow, d)]


def overlap_schedule(oh: int, ow: int, d: int, ext: int,
                     partitioned: bool = True):
    """The region launches of one overlapped chunk, in order, each with
    the neighbours waited for before it: ``[(label, rect, waits)]``.
    ``partitioned`` (the JAX default): each region after its own
    :func:`region_neighbours`.  ``partitioned=False`` is the JAX phase
    order, kept to compare against: the interior first, then both row
    bands after the upper and lower neighbours, then both column bands
    after all eight."""
    regions = region_neighbours(oh, ow, d, ext)
    if partitioned:
        return regions
    rows = frozenset({(-1, 0), (1, 0)})
    out = []
    for label, rect, waits in regions:
        if not waits:
            out.append((label, rect, waits))
    for label, rect, waits in regions:
        if waits and all(dj == 0 for _, dj in waits):
            out.append((label, rect, rows))
    for label, rect, waits in regions:
        if any(dj for _, dj in waits):
            out.append((label, rect, frozenset(NEIGHBOURS)))
    return out


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def fused_rdma_step_plain(blocks, filt: Filter, grid_shape,
                          boundary: str = "zero", quantize: bool = True,
                          out_dtype=None, fuse: int = 1,
                          valid_hw=None) -> list[list[torch.Tensor]]:
    """Plain PyTorch version of K3/K4: the halo exchange at depth r·T, then
    T levels of K2's plain version (2-D tap order) on every block at its
    global offsets.  ``valid_hw`` masks every level against the global
    image (zero boundary); periodic runs unmasked."""
    T = int(fuse)
    h, w = blocks[0][0].shape[1:]
    padded = halo.halo_exchange(blocks, filt.radius * T, grid_shape, boundary)
    vhw = None if boundary == "periodic" else valid_hw
    return [[stencil.fused_iterate_plain(
                p, (i * h, j * w), filt, T, vhw, quantize,
                out_dtype if out_dtype is not None else p.dtype)
             for j, p in enumerate(row)] for i, row in enumerate(padded)]


# ---------------------------------------------------------------------------
# K3 / K4: one launch for the whole grid
# ---------------------------------------------------------------------------


def _bind(tiled: bool, x: torch.Tensor, filt: Filter, grid_shape,
          boundary: str, levels: int, valid_hw, quantize: bool, out_dtype,
          ext: int, tile):
    """Check one K3 / K4 launch on the stacked grid ``x`` and bind its
    arguments.  Returns ``(fire, out)``: ``fire()`` issues the launch on the
    current stream (the bound tensors stay alive with it) and returns 0;
    ``fire(occupancy=True)`` launches nothing and returns the number of
    such blocks one SM holds (the CUDA occupancy calculator on the same
    instance).  ``out`` is the stacked (R·C, C, h+2·ext, w+2·ext) output
    the launch writes."""
    what = "rdma_tiled (K4)" if tiled else "rdma_block (K3)"
    _check_stacked(x, grid_shape)
    if out_dtype is None:
        out_dtype = x.dtype
    stencil._check_common(x[0], filt, quantize, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {x.device}; "
                         "fused_rdma_step takes the plain version on the CPU")
    stencil._check_cuda(x, filt)
    if boundary not in BOUNDARIES:
        raise ValueError(f"boundary must be one of {BOUNDARIES}, got "
                         f"{boundary!r}")
    R, Cg = grid_shape
    nb, C, h, w = x.shape
    r = filt.radius
    if levels < 1 or ext < 0 or r * levels + ext > min(h, w):
        raise ValueError(f"{what}: {levels} levels of radius {r} plus {ext} "
                         f"ghost rows need blocks >= {r * levels + ext}, got "
                         f"{(h, w)}")
    oh, ow = h + 2 * ext, w + 2 * ext
    th, tw = tile if tiled else (oh, ow)
    th, tw = max(1, min(int(th), oh)), max(1, min(int(tw), ow))
    limit = stencil._smem_limit(x.device)
    if stencil.fused_smem_bytes(r, levels, (th, tw)) > limit:
        raise ValueError(
            f"{what}: a {(th, tw)} tile at {levels} levels of radius {r} "
            f"needs {stencil.fused_smem_bytes(r, levels, (th, tw))} B of "
            f"shared memory, above the card's {limit} B")
    if tiled and nb * C > 65535:
        raise ValueError(f"{what}: {nb} blocks x {C} channels above the "
                         "launch grid's 65535")
    dev = x.device
    nbr = channels.device_table((R, Cg), boundary, dev)
    # The pointer table: block b of the stacked grid starts b strides past
    # its base; no block stages columns (the second half, 0).  Built on
    # the card, so no host copy waits on it.
    stride = C * h * w * x.element_size()
    ptrs = torch.zeros(2 * nb, dtype=torch.int64, device=dev)
    ptrs[:nb] = torch.arange(nb, dtype=torch.int64, device=dev).mul_(
        stride).add_(x.data_ptr())
    out = torch.empty((nb, C, oh, ow), dtype=out_dtype, device=dev)
    mask = boundary == "zero" and valid_hw is not None
    vh, vw = (int(valid_hw[0]), int(valid_hw[1])) if mask else (0, 0)
    taps = np.ascontiguousarray(filt.taps.reshape(-1), dtype=np.float32)
    from parallel_convolution_tpu_torch.ops import _build

    epi = stencil.epilogue_code(filt, quantize)
    lib = _build.load_library("rdma")

    def fire(occupancy: bool = False) -> int:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.pc_rdma_step(
                int(tiled), ptrs.data_ptr(), nbr.data_ptr(),
                stencil.DTYPE_CODES[x.dtype], out.data_ptr(),
                stencil.DTYPE_CODES[out_dtype], nb, Cg, 0, nb, C, h, w, ext,
                levels, stencil._fptr(taps), filt.size, epi, int(mask), vh,
                vw, th, tw, 0, 0, oh, ow, stencil.FUSED_THREADS,
                ctypes.byref(blocks) if occupancy else None, stream)
        stencil._raise_on(err, what)
        return blocks.value

    return fire, out


def rdma_block(x: torch.Tensor, filt: Filter, grid_shape, boundary: str,
               levels: int, valid_hw, *, quantize: bool = True, out_dtype=None,
               ext: int = 0) -> torch.Tensor:
    """K3: ``levels`` levels of every block of the stacked grid ``x``
    (:func:`stack_blocks`), one CUDA block per (grid block, channel), in
    one launch.  CUDA tensors only.  Returns a new stacked grid, each block
    extended by ``ext`` ghost rows and columns on every side (in
    ``out_dtype``, :func:`stencil.group_dtype`'s, for the K2 launches of
    later level groups)."""
    fire, out = _bind(False, x, filt, grid_shape, boundary, levels, valid_hw,
                      quantize, out_dtype, ext, None)
    fire()
    rdma_block.launches += 1
    return out


rdma_block.launches = 0


def rdma_tiled(x: torch.Tensor, filt: Filter, grid_shape, boundary: str,
               levels: int, valid_hw, *, quantize: bool = True, out_dtype=None,
               ext: int = 0, tile=None) -> torch.Tensor:
    """K4: as :func:`rdma_block`, one CUDA block per (``tile`` of an output
    block, grid block, channel); ``tile`` defaults to K2's."""
    fire, out = _bind(True, x, filt, grid_shape, boundary, levels, valid_hw,
                      quantize, out_dtype, ext,
                      tile if tile is not None else stencil.FUSED_TILE)
    fire()
    rdma_tiled.launches += 1
    return out


rdma_tiled.launches = 0


def fused_rdma_stacked(x: torch.Tensor, filt: Filter, grid_shape,
                       boundary: str = "zero", quantize: bool = True,
                       out_dtype=None, fuse: int = 1, valid_hw=None,
                       tile=None) -> torch.Tensor:
    """:func:`fused_rdma_step` on the stacked grid (:func:`stack_blocks`),
    returning a new stacked grid; the form the ``cuda_rdma`` chunk loop
    carries from chunk to chunk."""
    _check_stacked(x, grid_shape)
    if out_dtype is None:
        out_dtype = x.dtype
    stencil._check_common(x[0], filt, quantize, out_dtype)
    if boundary not in BOUNDARIES:
        raise ValueError(f"boundary must be one of {BOUNDARIES}, got "
                         f"{boundary!r}")
    T = int(fuse)
    if T < 1:
        raise ValueError(f"fuse must be >= 1, got {fuse}")
    r = filt.radius
    h, w = x.shape[2:]
    _check_depth(r, T, (h, w))
    periodic = boundary == "periodic"
    if T > 1 and not periodic and valid_hw is None:
        raise ValueError(
            "fuse > 1 with a zero boundary needs valid_hw — the global "
            "(H, W) image extent — so every intermediate level can re-zero "
            "its out-of-image positions (the oracle's ghost ring)")
    if x.device.type == "cpu":
        return stack_blocks(fused_rdma_step_plain(
            unstack_blocks(x, grid_shape), filt, grid_shape, boundary,
            quantize, out_dtype, T, valid_hw), grid_shape)
    plan = rdma_plan(r, T, (h, w), tile, stencil._smem_limit(x.device))
    rest = T - plan.groups[0]
    kw = dict(quantize=quantize,
              out_dtype=(out_dtype if rest == 0
                         else stencil.group_dtype(quantize, out_dtype)),
              ext=r * rest)
    if plan.kernel == "block":
        out = rdma_block(x, filt, grid_shape, boundary, plan.groups[0],
                         valid_hw, **kw)
    else:
        out = rdma_tiled(x, filt, grid_shape, boundary, plan.groups[0],
                         valid_hw, tile=plan.tile, **kw)
    if rest:
        Cg = grid_shape[1]
        vhw = None if periodic else valid_hw
        ext, out = out, torch.empty(x.shape, dtype=out_dtype, device=x.device)
        # Block by block into the stacked result: one block's K2 output at
        # a time beside it, not a second grid (BASELINE config 4's grid is
        # 12.9 GB in u8).
        for b, e in enumerate(ext):
            out[b] = stencil.fused_iterate(
                e, ((b // Cg) * h, (b % Cg) * w), filt, rest, vhw,
                quantize=quantize, out_dtype=out_dtype, tile=tile)
    return out


def fused_rdma_step(blocks, filt: Filter, grid_shape, boundary: str = "zero",
                    quantize: bool = True, out_dtype=None, fuse: int = 1,
                    valid_hw=None, tile=None) -> list[list[torch.Tensor]]:
    """``fuse`` iterations of every block of the grid, the halo exchange
    inside the kernel (the port of ``pallas_rdma.fused_rdma_step``).

    ``blocks`` is the grid's R×C list of (C, h, w) blocks, ``valid_hw`` the
    global image extent (needed for fuse > 1 with a zero boundary).
    Returns new blocks; the inputs are not modified.  On the card each
    chunk is one K3 or K4 launch for every block (:func:`rdma_plan`), plus
    one K2 launch per block for each later level group where T levels do
    not fit in shared memory; the groups chain through f32 in float mode
    and through the output dtype in quantize mode
    (:func:`stencil.group_dtype`), so the result does not depend on the
    grouping.
    """
    return unstack_blocks(fused_rdma_stacked(
        stack_blocks(blocks, grid_shape), filt, grid_shape, boundary,
        quantize, out_dtype, fuse, valid_hw, tile), grid_shape)


# ---------------------------------------------------------------------------
# A grid of slots: K3 / K4 per device, behind the barrier between slots
# ---------------------------------------------------------------------------


def fused_rdma_slots_plain(blocks, filt: Filter, grid_shape,
                           boundary: str = "zero", quantize: bool = True,
                           out_dtype=None, fuse: int = 1, valid_hw=None,
                           col_mode: str = "strided", overlap: bool = False,
                           partitioned: bool = True
                           ) -> list[list[torch.Tensor]]:
    """Plain PyTorch version of K3 / K4 per device, the JAX semantics
    literally: each block in a padded f32 buffer of its own whose ghosts
    are NaN until their slab lands, rows pushed first, then columns at the
    full padded height (``packed``: through each block's staging), then
    K2's plain levels on every block at its global offsets.

    ``overlap=True`` runs the card's overlapped schedule instead
    (:func:`overlap_schedule`, ``partitioned`` as there): the launch
    :func:`rdma_plan` makes at the card's shared memory, region by region
    in schedule order, each from the padded buffer in which only the
    neighbours waited for so far have been filled (the rest NaN), then
    K2's plain levels for the later level groups.  A NaN in any region's
    output raises: a missed wait shows in every dtype."""
    if overlap:
        return _overlap_plain(blocks, filt, grid_shape, boundary, quantize,
                              out_dtype, int(fuse), valid_hw, col_mode,
                              partitioned)
    T = int(fuse)
    h, w = blocks[0][0].shape[1:]
    padded = halo.exchange_per_block(
        blocks, filt.radius * T, grid_shape, boundary, dtype=torch.float32,
        fill=float("nan"), packed=col_mode == "packed")
    vhw = None if boundary == "periodic" else valid_hw
    dtype = out_dtype if out_dtype is not None else blocks[0][0].dtype
    return [[stencil.fused_iterate_plain(p, (i * h, j * w), filt, T, vhw,
                                         quantize, dtype)
             for j, p in enumerate(row)] for i, row in enumerate(padded)]


def _overlap_plain(blocks, filt: Filter, grid_shape, boundary: str,
                   quantize: bool, out_dtype, T: int, valid_hw,
                   col_mode: str, partitioned: bool):
    R, Cg = grid_shape
    C, h, w = blocks[0][0].shape
    r = filt.radius
    d = r * T
    plan = rdma_plan(r, T, (h, w))
    g0 = plan.groups[0]
    ext, reach = r * (T - g0), r * g0
    dtype = out_dtype if out_dtype is not None else blocks[0][0].dtype
    mid = stencil.group_dtype(quantize, dtype) if ext else dtype
    vhw = None if boundary == "periodic" else valid_hw
    periodic = boundary == "periodic"
    stage = (rdma_pack_plain(blocks, grid_shape, boundary, d)
             if col_mode == "packed" and Cg > 1 else None)
    sched = overlap_schedule(h + 2 * ext, w + 2 * ext, d, ext, partitioned)

    def nbr(i, j):
        ii, jj = (i % R, j % Cg) if periodic else (i, j)
        return (ii, jj) if 0 <= ii < R and 0 <= jj < Cg else None

    def spans(k, n):  # (buffer slice, source slice) of offset k on an axis
        return ((slice(0, d), slice(n - d, n)), (slice(d, d + n), slice(0, n)),
                (slice(d + n, n + 2 * d), slice(0, d)))[k + 1]

    out = []
    for i in range(R):
        row = []
        for j in range(Cg):
            p = torch.full((C, h + 2 * d, w + 2 * d), float("nan"),
                           device=blocks[i][j].device)
            p[:, d:d + h, d:d + w] = blocks[i][j]

            def fill(di, dj):
                (pr, sr), (pc, sc) = spans(di, h), spans(dj, w)
                n = nbr(i + di, j + dj)
                if n is None:
                    p[:, pr, pc] = 0
                elif stage is not None and dj:
                    # Packed: the column ghosts, corners included, from
                    # the column neighbour's staging (side 1 its right
                    # edge, side 0 its left), at the row-padded height.
                    k = nbr(i, j + dj)
                    st = stage[k[0] * Cg + k[1]][1 if dj < 0 else 0]
                    p[:, pr, pc] = st[:, pr].to(p.dtype)
                else:
                    p[:, pr, pc] = blocks[n[0]][n[1]][:, sr, sc].to(p.dtype)

            pending = set()
            for di, dj in NEIGHBOURS:
                if nbr(i + di, j + dj) in (None, (i, j)):
                    fill(di, dj)  # no neighbour, or this block itself
                else:
                    pending.add((di, dj))
            res = torch.empty((C, h + 2 * ext, w + 2 * ext),
                              dtype=torch.float32, device=p.device)
            for label, (r0, r1, c0, c1), waits in sched:
                for off in sorted(pending & waits):
                    fill(*off)
                pending -= waits
                part = stencil.fused_iterate_plain(
                    p[:, r0:r1 + 2 * reach, c0:c1 + 2 * reach],
                    (i * h + r0 - ext, j * w + c0 - ext), filt, g0, vhw,
                    quantize, torch.float32)
                if torch.isnan(part).any():
                    raise RuntimeError(
                        f"missed wait: block {(i, j)}'s {label} region "
                        f"{(r0, r1, c0, c1)} read a ghost its waits "
                        f"{sorted(waits)} did not cover")
                res[:, r0:r1, c0:c1] = part
            res = res.to(mid)
            if ext:
                res = stencil.fused_iterate_plain(
                    res, (i * h, j * w), filt, T - g0, vhw, quantize, dtype)
            row.append(res)
        out.append(row)
    return out


def rdma_pack_plain(blocks, grid_shape, boundary: str,
                    depth: int) -> list[torch.Tensor]:
    """Plain version of :func:`rdma_pack`: every block's staging, (2, C,
    h + 2d, d) in its dtype (side 0 its first d columns, side 1 its last
    d, at the row-padded height), by slice copies of the per-block
    exchange's row phase."""
    d = int(depth)
    w = blocks[0][0].shape[2]
    padded = halo.exchange_per_block(blocks, d, grid_shape, boundary)
    return [torch.stack([p[:, :, d:2 * d], p[:, :, w:w + d]])
            for row in padded for p in row]


# The pack's launch (csrc/rdma.cu:rdma_pack_kernel): bytes a thread moves,
# widest first, and threads a CUDA block.
PACK_VECTORS = (16, 8, 4, 2, 1)
PACK_THREADS = 256
_GRID_MAX = 65535


class _PackArgs(ctypes.Structure):
    """One pack launch's arguments, ``csrc/rdma.cu:PackArgs`` field for
    field."""

    _fields_ = ([(n, ctypes.c_longlong) for n in ("ptrs", "nbr", "stream")]
                + [(n, ctypes.c_int) for n in (
                    "in_dtype", "nb", "gcols", "b0", "count", "C", "h", "w",
                    "D", "vec", "tx", "ty", "gy", "gz")])


class PackPlan(NamedTuple):
    """One pack launch: ``vec`` bytes a thread; ``threads`` = (tx, ty),
    tx threads along a staged row's vectors and ty rows; ``grid`` = (1,
    gy, gz), gy row tiles of the h + 2D staged rows and gz (block, side,
    channel) triples, both grid-strided."""

    vec: int
    threads: tuple[int, int]
    grid: tuple[int, int, int]


def pack_plan(C: int, h: int, w: int, D: int, elt: int, addrs,
              count: int = 1) -> PackPlan:
    """The pack's launch for ``count`` blocks of (C, h, w) elements of
    ``elt`` bytes at ring depth ``D``: the widest vector that divides
    every byte address in ``addrs`` (the blocks the launch reads and the
    stagings it writes), the row pitch ``w·elt``, the right slab's column
    offset ``(w − D)·elt`` and a staged row's ``D·elt`` bytes (every
    vector a thread moves then lies aligned, on both sides), and a
    256-thread block of tx × ty with tx the power of two that covers a
    row's vectors (at most 256)."""
    if not 1 <= D <= min(h, w) or min(C, count, elt) < 1:
        raise ValueError(f"no pack of depth {D} for {count} blocks of "
                         f"{(C, h, w)} x {elt} B")
    offsets = (w * elt, (w - D) * elt, D * elt, *(int(a) for a in addrs))
    vec = next(v for v in PACK_VECTORS if all(o % v == 0 for o in offsets))
    nv = D * elt // vec
    tx = min(1 << (nv - 1).bit_length(), PACK_THREADS)
    ty = PACK_THREADS // tx
    return PackPlan(vec, (tx, ty),
                    (1, min(-(-(h + 2 * D) // ty), _GRID_MAX),
                     min(count * 2 * C, _GRID_MAX)))


_STREAMS: dict[tuple[str, ...], list] = {}
_PEERS: set[tuple[int, int]] = set()


def _slot_streams(slots) -> list:
    """One CUDA stream per slot, made once a process for a slot map."""
    key = tuple(str(d) for d in slots)
    if key not in _STREAMS:
        _STREAMS[key] = [torch.cuda.Stream(device=d) for d in slots]
    return _STREAMS[key]


def enable_peers(devices) -> None:
    """Peer access between every pair of distinct cards in ``devices``;
    raises with the runtime's cause where a pair is refused (a grid of
    slots over those cards reads its neighbours' buffers in place and has
    no host-staged fallback)."""
    from parallel_convolution_tpu_torch.ops import _build

    idx = sorted({torch.device(d).index for d in devices})
    if len(idx) < 2:
        return
    lib = _build.load_library("rdma")
    for a in idx:
        for b in idx:
            if a != b and (a, b) not in _PEERS:
                err = lib.pc_enable_peer(a, b)
                if err:
                    raise RuntimeError(
                        f"peer access from cuda:{a} to cuda:{b} refused "
                        f"({_build.error_text(err)}): a grid of slots over "
                        "these cards reads its neighbours' buffers in place")
                _PEERS.add((a, b))


class _SlotRun:
    """The per-run state of ``cuda_rdma`` on a grid of slots on the card:
    streams, events, the double-buffered carry, the staging, and the
    pointer tables (one per buffer set and device, built once)."""

    def __init__(self, grid, blocks, boundary: str, depth: int,
                 col_mode: str):
        R, Cg = self.grid_shape = tuple(grid.shape)
        self.boundary = boundary
        self.slots = grid.slots
        self.devices = list(dict.fromkeys(self.slots))
        enable_peers(self.devices)
        self.where, seen = [], {}
        for d in self.slots:
            self.where.append((self.devices.index(d), seen.get(d, 0)))
            seen[d] = seen.get(d, 0) + 1
        flat = [b for row in blocks for b in row]
        C, h, w = flat[0].shape
        self.block_shape, self.dtype = (C, h, w), flat[0].dtype
        self.depth = int(depth)
        # The two buffers the launches alternate between: the input stacked
        # per device (a private copy) and one more.  Allocated on each
        # device's current stream, which the slot streams wait on before
        # their first launch.
        x = [torch.stack([b for b, d in zip(flat, self.slots) if d == dev])
             for dev in self.devices]
        self.bufs = [x, [torch.empty_like(p) for p in x]]
        self.packed = col_mode == "packed" and Cg > 1
        stage_addr = [0] * len(flat)
        if self.packed:
            n = 2 * C * (h + 2 * self.depth) * self.depth
            self.stage = [torch.empty((len(p), n), dtype=self.dtype,
                                      device=p.device) for p in x]
            stage_addr = [self.stage[di][k].data_ptr()
                          for di, k in self.where]
        table = channels.neighbour_table(self.grid_shape, boundary)
        self.tables = [[torch.tensor(
            [bufs[di][k].data_ptr() for di, k in self.where] + stage_addr,
            dtype=torch.int64, device=dev) for dev in self.devices]
            for bufs in self.bufs]
        self.nbr = [channels.device_table(self.grid_shape, boundary, dev)
                    for dev in self.devices]
        # The barrier's partners: every block a slot's launch reads (its
        # eight neighbours), and the column neighbours whose staging it
        # reads.
        self.neighbours = [sorted({n for n in row if n >= 0} - {s})
                           for s, row in enumerate(table)]
        self.col_neighbours = [sorted({row[3], row[5]} - {-1, s})
                               for s, row in enumerate(table)]
        self.table = table
        # The ghost depth the last step read (the overlapped pipeline's
        # write-after-read waits look at it).
        self.last_depth = 0
        self.streams = _slot_streams(self.slots)
        self.launched = [torch.cuda.Event() for _ in self.slots]
        self.staged = [torch.cuda.Event() for _ in self.slots]
        self.joined = True
        # The pack's ctypes arguments and plan by (buffer set, first slot,
        # depth, count), every slot's at the run's depth made here.
        self.index = [torch.device(d).index for d in self.slots]
        self.packs, self.pack_plans = {}, {}
        if self.packed:
            from parallel_convolution_tpu_torch.ops import _build

            self.pack_fn = _build.load_library("rdma").pc_rdma_pack
            for src in range(len(self.bufs)):
                for s in range(len(self.slots)):
                    self.pack_args(src, s, self.depth)

    def pack_args(self, src: int, s: int, depth: int,
                  count: int = 1) -> tuple:
        """``(args, address)``: the :class:`_PackArgs` of the pack of
        slots ``[s, s + count)`` (one device) of the buffer set ``src`` at
        ``depth``, planned (:func:`pack_plan`) from the addresses that
        launch reads and writes, and its address; made once."""
        key = (src, s, depth, count)
        if key in self.packs:
            return self.packs[key]
        span = range(s, s + count)
        if (not self.packed or not 1 <= depth <= self.depth or count < 1
                or s < 0 or s + count > len(self.slots)
                or len({self.slots[b] for b in span}) != 1):
            raise ValueError(f"slots {s}..{s + count - 1} have no staging "
                             f"for depth {depth} on one device")
        C, h, w = self.block_shape
        bufs = self.bufs[src]
        elt = bufs[0].element_size()
        addrs = [self.stage[self.where[b][0]][self.where[b][1]].data_ptr()
                 for b in span]
        for b in span:
            for n in (self.table[b][1], b, self.table[b][7]):
                if n >= 0:
                    di, k = self.where[n]
                    addrs.append(bufs[di][k].data_ptr())
        plan = pack_plan(C, h, w, depth, elt, addrs, count)
        di = self.where[s][0]
        args = _PackArgs(
            self.tables[src][di].data_ptr(), self.nbr[di].data_ptr(),
            self.streams[s].cuda_stream, stencil.DTYPE_CODES[self.dtype],
            len(self.slots), self.grid_shape[1], s, count, C, h, w, depth,
            plan.vec, *plan.threads, *plan.grid[1:])
        self.packs[key] = (args, ctypes.addressof(args))
        self.pack_plans[key] = plan
        return self.packs[key]

    def buffer_set(self, parts) -> int:
        ptr = parts[0].data_ptr()
        for i, bufs in enumerate(self.bufs):
            if bufs[0].data_ptr() == ptr:
                return i
        raise ValueError("not a carry of this run")

    def fork(self) -> None:
        """Every slot stream after what the current stream of every device
        of the run has enqueued (the inputs, the buffers' allocation, a
        diff read): a slot reads its neighbours' blocks, which may live on
        other devices, and its first launch has no neighbour's event to
        wait on."""
        for st in self.streams:
            for dev in self.devices:
                st.wait_stream(torch.cuda.current_stream(dev))
        self.joined = False

    def join(self) -> None:
        """Every device's current stream after every slot's launches: the
        carry may then be read there, and freed."""
        for dev in self.devices:
            cur = torch.cuda.current_stream(dev)
            for ev in self.launched:
                cur.wait_event(ev)
        self.joined = True


class SlotCarry(NamedTuple):
    """The ``cuda_rdma`` carry on a grid of slots on the card: ``parts[i]``
    stacks the blocks of ``run.devices[i]``'s slots, in slot order."""

    run: _SlotRun
    parts: list


def slot_carry(blocks, grid, boundary: str, depth: int,
               col_mode: str = "strided"):
    """The carry a grid of slots starts from: on the card a
    :class:`SlotCarry` whose buffers and staging fit ``depth`` = r·fuse
    ghosts; on the CPU the blocks themselves."""
    if blocks[0][0].device.type == "cpu":
        return blocks
    run = _SlotRun(grid, blocks, boundary, depth, col_mode)
    return SlotCarry(run, run.bufs[0])


def slot_blocks(carry, grid_shape) -> list[list[torch.Tensor]]:
    """The R×C blocks of a carry (views of its buffers on the card, after
    joining the slot streams)."""
    if not isinstance(carry, SlotCarry):
        return carry
    run = carry.run
    run.join()
    flat = [carry.parts[di][k] for di, k in run.where]
    Cg = grid_shape[1]
    return [flat[i * Cg:(i + 1) * Cg] for i in range(grid_shape[0])]


def _slot_binder(run: _SlotRun, tiled: bool, filt: Filter, levels: int,
                 ext: int, quantize: bool, valid_hw, tile):
    """Check one per-slot K3 / K4 launch shape and bind what every slot's
    launch shares; returns ``fire(src, s, out, rect=None)``, which launches
    slot ``s``'s block of the buffer set ``src`` into ``out`` on its device
    and stream and counts it on its wrapper: the whole output, or only the
    half-open output rectangle ``rect`` = (r0, r1, c0, c1) (a region of the
    overlapped pipeline, counted on the region wrapper)."""
    from parallel_convolution_tpu_torch.ops import _build

    C, h, w = run.block_shape
    oh, ow = h + 2 * ext, w + 2 * ext
    th, tw = tile if tiled else (oh, ow)
    th, tw = max(1, min(int(th), oh)), max(1, min(int(tw), ow))
    if filt.radius * levels + ext > min(h, w):
        raise ValueError(f"{levels} levels of radius {filt.radius} plus "
                         f"{ext} ghost rows need blocks >= "
                         f"{filt.radius * levels + ext}, got {(h, w)}")
    need = stencil.fused_smem_bytes(filt.radius, levels, (th, tw))
    for dev in run.devices:
        if need > stencil._smem_limit(dev):
            raise ValueError(
                f"a {(th, tw)} tile at {levels} levels of radius "
                f"{filt.radius} needs {need} B of shared memory, above "
                f"{dev}'s {stencil._smem_limit(dev)} B")
    mask = run.boundary == "zero" and valid_hw is not None
    vh, vw = (int(valid_hw[0]), int(valid_hw[1])) if mask else (0, 0)
    taps = np.ascontiguousarray(filt.taps.reshape(-1), dtype=np.float32)
    args = (len(run.slots), run.grid_shape[1])
    epi = stencil.epilogue_code(filt, quantize)
    lib = _build.load_library("rdma")
    whole = (0, oh, 0, ow)
    in_code = stencil.DTYPE_CODES[run.dtype]

    def fire(src: int, s: int, out, rect=None) -> None:
        di, _ = run.where[s]
        dev = run.slots[s]
        r0, r1, c0, c1 = whole if rect is None else rect
        if rect is None:
            wrapper = rdma_tiled_slot if tiled else rdma_block_slot
        else:
            wrapper = rdma_tiled_region if tiled else rdma_block_region
        with torch.cuda.device(dev):
            err = lib.pc_rdma_step(
                int(tiled), run.tables[src][di].data_ptr(),
                run.nbr[di].data_ptr(), in_code, out.data_ptr(),
                stencil.DTYPE_CODES[out.dtype], *args, s, 1, C, h, w, ext,
                levels, stencil._fptr(taps), filt.size, epi, int(mask), vh,
                vw, th, tw, r0, c0, r1 - r0, c1 - c0, stencil.FUSED_THREADS,
                None, run.streams[s].cuda_stream)
        where = "" if rect is None else f" region {tuple(rect)}"
        stencil._raise_on(err, f"{wrapper.__name__} (slot {s} on {dev}"
                               f"{where})")
        wrapper.launches += 1

    return fire


def rdma_block_slot(run: _SlotRun, src: int, s: int, out, filt: Filter,
                    levels: int, valid_hw, *, quantize: bool = True,
                    ext: int = 0) -> None:
    """K3 for slot ``s`` alone: its block of the buffer set ``src`` into
    ``out`` (its (C, h+2·ext, w+2·ext) output), on its device and
    stream."""
    _slot_binder(run, False, filt, levels, ext, quantize, valid_hw,
                 None)(src, s, out)


rdma_block_slot.launches = 0


def rdma_tiled_slot(run: _SlotRun, src: int, s: int, out, filt: Filter,
                    levels: int, valid_hw, *, quantize: bool = True,
                    ext: int = 0, tile=None) -> None:
    """K4 for slot ``s`` alone, as :func:`rdma_block_slot`."""
    _slot_binder(run, True, filt, levels, ext, quantize, valid_hw,
                 tile if tile is not None else stencil.FUSED_TILE)(
        src, s, out)


rdma_tiled_slot.launches = 0


def rdma_block_region(run: _SlotRun, src: int, s: int, out, filt: Filter,
                      levels: int, valid_hw, rect, *, quantize: bool = True,
                      ext: int = 0) -> None:
    """K3 for slot ``s`` on one region of its output, the half-open
    ``rect`` = (r0, r1, c0, c1) of the (h+2·ext, w+2·ext) frame (the
    overlapped pipeline's launch, :func:`overlap_schedule`), as
    :func:`rdma_block_slot` otherwise; ``out`` outside ``rect`` is not
    written."""
    _slot_binder(run, False, filt, levels, ext, quantize, valid_hw,
                 None)(src, s, out, rect)


rdma_block_region.launches = 0


def rdma_tiled_region(run: _SlotRun, src: int, s: int, out, filt: Filter,
                      levels: int, valid_hw, rect, *, quantize: bool = True,
                      ext: int = 0, tile=None) -> None:
    """K4 for slot ``s`` on one region of its output, as
    :func:`rdma_block_region`, its tiles clipped at the region's edge."""
    _slot_binder(run, True, filt, levels, ext, quantize, valid_hw,
                 tile if tile is not None else stencil.FUSED_TILE)(
        src, s, out, rect)


rdma_tiled_region.launches = 0


def rdma_pack(run: _SlotRun, src: int, s: int, depth: int,
              count: int = 1) -> None:
    """The packed transport's gather for slot ``s`` (with ``count`` > 1,
    slots ``[s, s + count)`` of one device in one launch): its block's two
    edge column slabs of the buffer set ``src``, ``depth`` deep at the
    row-padded height, into its staging, on its device and stream.  One
    ctypes call with the address of the arguments the run made once
    (:meth:`_SlotRun.pack_args`), in the slot's device only where it is
    not the current one."""
    addr = run.pack_args(src, s, depth, count)[1]
    if run.index[s] == torch.cuda.current_device():
        err = run.pack_fn(addr)
    else:
        with torch.cuda.device(run.index[s]):
            err = run.pack_fn(addr)
    if err:
        stencil._raise_on(err, f"rdma_pack (slot {s} on {run.slots[s]})")
    rdma_pack.launches += 1


rdma_pack.launches = 0


def staged_slabs(run: _SlotRun, s: int, depth: int) -> torch.Tensor:
    """Slot ``s``'s staging as (2, C, h + 2·depth, depth), as the last
    pack at ``depth`` wrote it (after :meth:`_SlotRun.join`)."""
    di, k = run.where[s]
    C, h, _ = run.block_shape
    n = 2 * C * (h + 2 * depth) * depth
    return run.stage[di][k][:n].view(2, C, h + 2 * depth, depth)


def _slots_step(carry: SlotCarry, filt: Filter, quantize: bool, out_dtype,
                T: int, valid_hw, tile, col_mode: str, overlap: bool = False,
                partitioned: bool = True) -> SlotCarry:
    run = carry.run
    C, h, w = run.block_shape
    r = filt.radius
    if out_dtype != run.dtype:
        raise ValueError(f"the carry stays {run.dtype} on a grid of slots, "
                         f"got out_dtype {out_dtype}")
    if r * T > run.depth:
        raise ValueError(f"a {T}-level step needs {r * T} ghosts, the run "
                         f"was entered for {run.depth}")
    for dev in run.devices:
        stencil._check_cuda(run.bufs[0][run.devices.index(dev)][0], filt)
    plan = rdma_plan(r, T, (h, w), tile, stencil._smem_limit(run.devices[0]))
    rest = T - plan.groups[0]
    ext = r * rest
    if plan.kernel == "tiled" and C > 65535:
        raise ValueError(f"rdma_tiled_slot: {C} channels above the launch "
                         "grid's 65535")
    cplan = channels.plan_for(channels.ChannelKey(
        run.grid_shape, (h, w), r, T, str(run.dtype), run.boundary,
        "monolithic", col_mode))
    src = run.buffer_set(carry.parts)
    dst = 1 - src
    if run.joined:
        run.fork()
    streams = run.streams
    staged = cplan.packed_cols and run.packed
    depth = (cplan.col_slabs[0].src_cols[1] - cplan.col_slabs[0].src_cols[0]
             if staged else 0)
    vhw = None if run.boundary == "periodic" else valid_hw
    mid = stencil.group_dtype(quantize, out_dtype)
    fire = _slot_binder(run, plan.kernel == "tiled", filt, plan.groups[0],
                        ext, quantize, valid_hw,
                        plan.tile if plan.kernel == "tiled" else None)
    outs = []
    for s, st in enumerate(streams):
        di, k = run.where[s]
        out = run.bufs[dst][di][k]
        if rest:
            # Allocated on the slot's stream, which alone uses it.
            with torch.cuda.device(run.slots[s]), torch.cuda.stream(st):
                out = torch.empty((C, h + 2 * ext, w + 2 * ext), dtype=mid,
                                  device=run.slots[s])
        outs.append(out)
    if overlap:
        _overlap_launches(run, fire, src, outs, r * T, ext, partitioned,
                          staged, depth)
    else:
        # The barrier: a slot's launch reads its neighbours' outputs of
        # their last launch (read after write) and overwrites the buffer
        # their last launch read (write after read), so it waits on their
        # last launch and on nothing else.  Every wait is enqueued before
        # any of this step's records, so each names the previous launch.
        for s, st in enumerate(streams):
            for n in run.neighbours[s]:
                st.wait_event(run.launched[n])
        if staged:
            for s, st in enumerate(streams):
                rdma_pack(run, src, s, depth)
                run.staged[s].record(st)
            for s, st in enumerate(streams):
                for n in run.col_neighbours[s]:
                    st.wait_event(run.staged[n])
        for s in range(len(streams)):
            fire(src, s, outs[s])
    for s, st in enumerate(streams):
        if rest:
            di, k = run.where[s]
            i, j = divmod(s, run.grid_shape[1])
            with torch.cuda.device(run.slots[s]), torch.cuda.stream(st):
                run.bufs[dst][di][k].copy_(stencil.fused_iterate(
                    outs[s], (i * h, j * w), filt, rest, vhw,
                    quantize=quantize, out_dtype=out_dtype, tile=tile))
        run.launched[s].record(st)
    run.last_depth = r * T
    return SlotCarry(run, run.bufs[dst])


def _overlap_launches(run: _SlotRun, fire, src: int, outs, d: int, ext: int,
                      partitioned: bool, staged: bool, depth: int) -> None:
    """The overlapped pipeline's launches of one step (:func:`overlap_schedule`
    on every slot), before any of the step's ``launched`` records:

    1. every slot's interior, with no wait: its level-0 window lies in its
       own block, and its writes miss the ``d``-deep edges its neighbours
       read (at ``ext`` > 0 it writes a buffer of its own);
    2. with the packed transport, every slot's pack, after its upper and
       lower neighbours (it reads their rows) and its left and right ones
       (their last launch read its staging), then its ``staged`` record;
    3. every slot's bands in order, each after the events of the
       neighbours its read window covers that the slot has not waited for
       yet (and, packed, the ``staged`` event of each column neighbour it
       reads), then the waits on every neighbour left, so the step's later
       work (K2's level groups and the copy into the carry, which writes
       the whole block) and the next step come after all eight.

    Where the previous step read deeper than ``d`` (a single step after a
    fused chunk) and a region writes the carry itself (``ext`` = 0), the
    region also waits for the neighbours whose earlier reads its rows
    reach at that depth: the write-after-read half of the barrier."""
    _, h, w = run.block_shape
    sched = overlap_schedule(h + 2 * ext, w + 2 * ext, d, ext, partitioned)
    prev = run.last_depth if ext == 0 else 0
    waited = [set() for _ in run.slots]
    seen = [set() for _ in run.slots]

    def wait(s, offsets):
        row = run.table[s]
        for di, dj in sorted(offsets):
            n = row[(di + 1) * 3 + dj + 1]
            if n < 0 or n == s or n in waited[s]:
                continue
            run.streams[s].wait_event(run.launched[n])
            waited[s].add(n)

    def waits_of(rect, offsets):
        if prev > d:
            offsets = offsets | covered_neighbours(rect, h, w, prev)
        return offsets

    for s in range(len(run.slots)):
        for label, rect, offsets in sched:
            if label == "interior":
                wait(s, waits_of(rect, offsets))
                fire(src, s, outs[s], rect)
    if staged:
        for s, st in enumerate(run.streams):
            wait(s, {(-1, 0), (1, 0), (0, -1), (0, 1)})
            rdma_pack(run, src, s, depth)
            run.staged[s].record(st)
    for s, st in enumerate(run.streams):
        for label, rect, offsets in sched:
            if label == "interior":
                continue
            offsets = waits_of(rect, offsets)
            wait(s, offsets)
            if staged:
                for dj in sorted({dj for _, dj in offsets if dj}):
                    n = run.table[s][4 + dj]
                    if n >= 0 and n != s and n not in seen[s]:
                        st.wait_event(run.staged[n])
                        seen[s].add(n)
            fire(src, s, outs[s], rect)
        wait(s, NEIGHBOURS)


def fused_rdma_slots(carry, filt: Filter, grid_shape, boundary: str = "zero",
                     quantize: bool = True, out_dtype=None, fuse: int = 1,
                     valid_hw=None, tile=None, col_mode: str = "strided",
                     overlap: bool = False, partitioned: bool = True):
    """``fuse`` iterations of every block of a grid of slots, the exchange
    inside the kernels: one K3 / K4 launch per slot on its own device and
    stream (plus, with ``col_mode="packed"``, one pack per slot first, and
    K2 per slot for later level groups), behind the barrier between slots.
    ``overlap=True`` launches each slot's K3 / K4 region by region instead
    (:func:`overlap_schedule`; ``partitioned`` as there, the JAX
    ``fused_rdma_step`` defaults): the interior first with no wait, each
    band after its own neighbours' events.  ``carry`` is
    :func:`slot_carry`'s; returns the next carry.  On the CPU the carry is
    the blocks and :func:`fused_rdma_slots_plain` runs (its overlapped
    schedule with ``overlap``)."""
    T = int(fuse)
    if T < 1:
        raise ValueError(f"fuse must be >= 1, got {fuse}")
    if col_mode not in channels.COL_MODES:
        raise ValueError(f"col_mode must be one of {channels.COL_MODES} at "
                         f"the kernel layer, got {col_mode!r}")
    if boundary not in BOUNDARIES:
        raise ValueError(f"boundary must be one of {BOUNDARIES}, got "
                         f"{boundary!r}")
    if not isinstance(carry, SlotCarry):
        b0 = carry[0][0]
        if b0.device.type != "cpu":
            raise ValueError("on the card a grid of slots carries a "
                             "SlotCarry (rdma.slot_carry)")
        _check_depth(filt.radius, T, b0.shape[1:])
        return fused_rdma_slots_plain(carry, filt, grid_shape, boundary,
                                      quantize, out_dtype, T, valid_hw,
                                      col_mode, overlap, partitioned)
    run = carry.run
    _check_depth(filt.radius, T, run.block_shape[1:])
    if out_dtype is None:
        out_dtype = run.dtype
    stencil._check_common(run.bufs[0][0][0], filt, quantize, out_dtype)
    if T > 1 and boundary != "periodic" and valid_hw is None:
        raise ValueError("fuse > 1 with a zero boundary needs valid_hw")
    if boundary != run.boundary:
        raise ValueError(f"the run was entered for boundary {run.boundary!r}")
    return _slots_step(carry, filt, quantize, out_dtype, T, valid_hw, tile,
                       col_mode, bool(overlap), bool(partitioned))
