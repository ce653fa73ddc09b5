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

**On a grid over processes** (``mesh.Grid.owners``; ROADMAP items 10d-i,
10d-ii-a and 10d-ii-b) each rank launches its own slots.  A neighbour on
another rank of the same host is read in place through CUDA IPC, on the
same card (ranks sharing it over gloo) or another (one card a process
over NCCL, the map enabling peer access), as the TPU kernels write a
neighbour's buffer on another host: each rank exports its buffers,
staging and counters once a run (:func:`ipc_handle`: the allocation's
handle and the buffer's offset in it) and maps its neighbours'
(``multihost.peer_records``), so the pointer tables hold the remote
slots' addresses as this process sees them.  Where the neighbour lives in
another process of the host the barrier is a counter instead of an
event: each slot's stream writes its monotonic step counter after its
launch (and its staged counter after its pack), and a neighbour's stream
waits until it reaches the step before (``csrc/rdma.cu``:
``cuStreamWriteValue64`` / ``cuStreamWaitValue64``), the one wait
covering read after write and write after read as the event does; on
another card the wait reads the counter through the peer map.  Events
stay for neighbours in this process.  A neighbour on **another
host** (the ranks' host records say so, and nothing else) is read from a
mirror of its block on this rank's card, which the pointer tables name in
its place: once a chunk each rank copies out exactly the slabs its far
readers' launches read (:func:`mirror_plan`), after its own launch of the
step before, into a staging buffer held for the run (pinned host memory
over gloo, card memory over NCCL), swaps them (``multihost.swap``) and
copies what it receives into its mirrors (:class:`_FarExchange`), each
copy after the local launches that last read that mirror; a launch waits
for its mirrors' copies.  Over NCCL the round is ordered by events alone:
the host waits for nothing.  With ``col_mode="packed"`` a far column
neighbour's staging is mirrored too, in a second round after the packs.
With ``overlap=True`` the interiors launch before the exchange, which
they hide.  A run is closed collectively (:func:`close_carry`: unmap,
then a barrier, then the buffers and mirrors go).  A failed map or a
refused counter raises with the runtime's cause; it never falls back to a
mirror or to the host.  On a CPU grid over processes the plain version
runs each rank's blocks after an exchange of the ``r·fuse``-deep rims,
corners included (``halo.exchange_per_block``), whatever the hosts, its
overlapped schedule filling a region's ghosts from them as its waits
allow.
"""

from __future__ import annotations

import collections
import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

from parallel_convolution_tpu_torch.ops import stencil
from parallel_convolution_tpu_torch.ops.filters import Filter
from parallel_convolution_tpu_torch.parallel import channels, halo
from parallel_convolution_tpu_torch.parallel.mesh import first_block
from parallel_convolution_tpu_torch.utils import tracing
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
# The mirror of a neighbour on another host: what a launch reads of it
# ---------------------------------------------------------------------------


class MirrorPlan(NamedTuple):
    """What a launch reads of one far neighbour: half-open ``(r0, r1, c0,
    c1)`` rectangles of its (C, h, w) block (every channel), none inside
    another, and the sides of its (2, C, h + 2d, d) staging (0 its first
    d columns, 1 its last d)."""

    rects: tuple
    sides: tuple


def _outermost(rects) -> tuple:
    """``rects`` without those another of them contains, sorted."""
    def inside(a, b):
        return b[0] <= a[0] and a[1] <= b[1] and b[2] <= a[2] and a[3] <= b[3]

    rects = set(rects)
    return tuple(sorted(a for a in rects
                        if not any(b != a and inside(a, b) for b in rects)))


def mirror_plan(table, s: int, n: int, block_shape, depth: int,
                packed: bool = False) -> MirrorPlan:
    """The slices of slot ``n``'s block that slot ``s``'s launch at ghost
    depth ``depth`` (r·T) reads, ``table`` the grid's neighbour table
    (``channels.neighbour_table``): for each side on which ``n`` borders
    ``s`` (several under a periodic boundary), ``n``'s last ``depth`` rows
    for a north neighbour, its first for a south one, its last or first
    ``depth`` columns for a west or east one, the ``depth``×``depth``
    corner for a diagonal.  ``packed`` (the packed column transport): a
    west or east neighbour's ghost columns, corners included, are read
    from its staging (side 1 or 0) instead, and no diagonal is read; the
    north and south rows also cover what ``s``'s own pack reads."""
    _, h, w = block_shape
    d = int(depth)
    span = {-1: (h - d, h), 0: (0, h), 1: (0, d)}
    cspan = {-1: (w - d, w), 0: (0, w), 1: (0, d)}
    rects, sides = set(), set()
    for di, dj in NEIGHBOURS:
        if table[s][(di + 1) * 3 + dj + 1] != n:
            continue
        if packed and dj:
            if not di:
                sides.add(1 if dj < 0 else 0)
            continue
        rects.add((*span[di], *cspan[dj]))
    return MirrorPlan(_outermost(rects), tuple(sorted(sides)))


def far_slabs(table, owners, reader: int, owner: int, block_shape,
              depth: int, packed: bool = False) -> list:
    """``[(n, MirrorPlan)]``: for each slot ``n`` of rank ``owner`` that a
    slot of rank ``reader`` reads, in slot order, the union of
    :func:`mirror_plan` over ``reader``'s slots: what ``owner`` copies
    out for ``reader`` and ``reader`` copies into its mirror of ``n``.
    Both ranks compute the same list from the same table."""
    mine = [s for s, o in enumerate(owners) if o == reader]
    out = []
    for n, o in enumerate(owners):
        if o != owner or o == reader:
            continue
        rects, sides = set(), set()
        for s in mine:
            plan = mirror_plan(table, s, n, block_shape, depth, packed)
            rects.update(plan.rects)
            sides.update(plan.sides)
        if rects or sides:
            out.append((n, MirrorPlan(_outermost(rects),
                                      tuple(sorted(sides)))))
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
                           partitioned: bool = True, grid=None
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
    output raises: a missed wait shows in every dtype.

    On a ``grid`` over several processes ``blocks`` is this rank's share
    (``None`` elsewhere): the slabs between ranks travel by
    ``multihost.swap`` (``halo.exchange_per_block``) and only this rank's
    blocks are computed."""
    if overlap:
        return _overlap_plain(blocks, filt, grid_shape, boundary, quantize,
                              out_dtype, int(fuse), valid_hw, col_mode,
                              partitioned, grid)
    T = int(fuse)
    mine = first_block(blocks, None)
    if mine is None:
        return [list(row) for row in blocks]
    h, w = mine.shape[1:]
    padded = halo.exchange_per_block(
        blocks, filt.radius * T, grid_shape, boundary, dtype=torch.float32,
        fill=float("nan"), packed=col_mode == "packed", grid=grid)
    vhw = None if boundary == "periodic" else valid_hw
    dtype = out_dtype if out_dtype is not None else mine.dtype
    return [[None if p is None else stencil.fused_iterate_plain(
                p, (i * h, j * w), filt, T, vhw, quantize, dtype)
             for j, p in enumerate(row)] for i, row in enumerate(padded)]


def _overlap_plain(blocks, filt: Filter, grid_shape, boundary: str,
                   quantize: bool, out_dtype, T: int, valid_hw,
                   col_mode: str, partitioned: bool, grid=None):
    R, Cg = grid_shape
    mine = first_block(blocks, None)
    if mine is None:
        return [list(row) for row in blocks]
    C, h, w = mine.shape
    r = filt.radius
    d = r * T
    plan = rdma_plan(r, T, (h, w))
    g0 = plan.groups[0]
    ext, reach = r * (T - g0), r * g0
    dtype = out_dtype if out_dtype is not None else mine.dtype
    mid = stencil.group_dtype(quantize, dtype) if ext else dtype
    vhw = None if boundary == "periodic" else valid_hw
    periodic = boundary == "periodic"
    # Over several processes every ghost first arrives by a swap (the rims,
    # corners included: the two-hop exchange gives the diagonal's bytes),
    # and the schedule fills a region's ghosts from them.
    rims = (halo.exchange_per_block(blocks, d, grid_shape, boundary,
                                    dtype=torch.float32, grid=grid)
            if grid is not None and grid.spans_processes else None)
    stage = (rdma_pack_plain(blocks, grid_shape, boundary, d)
             if col_mode == "packed" and Cg > 1 and rims is None else None)
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
            if blocks[i][j] is None:
                row.append(None)
                continue
            p = torch.full((C, h + 2 * d, w + 2 * d), float("nan"),
                           device=blocks[i][j].device)
            p[:, d:d + h, d:d + w] = blocks[i][j]

            def fill(di, dj):
                (pr, sr), (pc, sc) = spans(di, h), spans(dj, w)
                n = nbr(i + di, j + dj)
                if n is None:
                    p[:, pr, pc] = 0
                elif rims is not None:
                    p[:, pr, pc] = rims[i][j][:, pr, pc]
                elif stage is not None and dj:
                    # Packed: the column ghosts, corners included, from
                    # the column neighbour's staging (side 1 its right
                    # edge, side 0 its left), at the row-padded height.
                    k = nbr(i, j + dj)
                    st = stage[k[0] * Cg + k[1]][1 if dj < 0 else 0]
                    p[:, pr, pc] = st[:, pr].to(p.dtype)
                else:
                    p[:, pr, pc] = blocks[n[0]][n[1]][:, sr, sc].to(p.dtype)

            pending_ = set()
            for di, dj in NEIGHBOURS:
                if nbr(i + di, j + dj) in (None, (i, j)):
                    fill(di, dj)  # no neighbour, or this block itself
                else:
                    pending_.add((di, dj))
            res = torch.empty((C, h + 2 * ext, w + 2 * ext),
                              dtype=torch.float32, device=p.device)
            for label, (r0, r1, c0, c1), waits in sched:
                for off in sorted(pending_ & waits):
                    fill(*off)
                pending_ -= waits
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


# The CUDA IPC maps of this process: a handle's bytes -> [its base here,
# the runs holding it].  A process opens a handle once (the runtime refuses
# a second open in one context) and closes it when its last run closes.
_IPC_MAPS: dict[bytes, list] = {}


def _cu_check(err: int, what: str) -> None:
    """Raise on a nonzero ``CUresult`` from the IPC and counter entry
    points of ``csrc/rdma.cu``."""
    if err:
        from parallel_convolution_tpu_torch.ops import _build

        name = _build.load_library("rdma").pc_cu_error_name(int(err))
        raise RuntimeError(f"{what} failed: {name.decode()} ({int(err)}); "
                           "a grid over processes reads its neighbours "
                           "through CUDA IPC and has no host-staged "
                           "fallback")


def ipc_handle(t: torch.Tensor) -> tuple[bytes, int]:
    """``(handle, offset)``: the legacy CUDA IPC handle of the allocation
    holding card tensor ``t`` and ``t``'s byte offset in it (PyTorch's
    caching allocator sub-allocates, so the offset is rarely 0).  Raises
    on memory with no such handle: PyTorch's expandable segments
    (``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``) allocate it
    through the VMM API, which legacy IPC refuses."""
    from parallel_convolution_tpu_torch.ops import _build

    lib = _build.load_library("rdma")
    handle = ctypes.create_string_buffer(64)
    offset, legacy = ctypes.c_longlong(0), ctypes.c_int(0)
    with torch.cuda.device(t.device):
        err = lib.pc_ipc_handle(t.data_ptr(), handle, ctypes.byref(offset),
                                ctypes.byref(legacy))
    _cu_check(err, f"the IPC handle of {t.device} memory")
    if not legacy.value:
        raise RuntimeError(
            f"{t.device} memory at {t.data_ptr():#x} has no legacy CUDA IPC "
            "handle: PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True "
            "allocates it through the VMM API; cuda_rdma across processes "
            "needs the caching allocator's plain segments (unset that "
            "setting)")
    return handle.raw, offset.value


def _ipc_map(handle: bytes, device) -> int:
    """The base address in this process of another process's allocation
    (mapped once, counted a holder)."""
    entry = _IPC_MAPS.get(handle)
    if entry is None:
        from parallel_convolution_tpu_torch.ops import _build

        base = ctypes.c_void_p(0)
        with torch.cuda.device(device):
            err = _build.load_library("rdma").pc_ipc_open(
                handle, ctypes.byref(base))
        _cu_check(err, f"mapping a neighbour's memory on {device}")
        entry = _IPC_MAPS[handle] = [int(base.value), 0]
    entry[1] += 1
    return entry[0]


def _ipc_unmap(handle: bytes, device) -> None:
    entry = _IPC_MAPS[handle]
    entry[1] -= 1
    if entry[1] == 0:
        from parallel_convolution_tpu_torch.ops import _build

        del _IPC_MAPS[handle]
        with torch.cuda.device(device):
            err = _build.load_library("rdma").pc_ipc_close(entry[0])
        _cu_check(err, f"unmapping a neighbour's memory on {device}")


class _FarExchange:
    """The mirrors of a run's far slots (those of ranks on another host
    that this rank's slots read) and their exchange, a round a chunk:

    * :meth:`send` enqueues, on each local slot's stream (so after its own
      launch of the step before), the copy of the slabs a far rank reads
      of it (:func:`far_slabs`) into a staging buffer held for the run,
      one a far rank: pinned host memory over gloo
      (``multihost.HostStaging``), this rank's card over NCCL
      (``multihost.DeviceStaging``);
    * :meth:`receive` swaps the buffers (``multihost.swap``) and, on the
      run's exchange stream, after the last launch of every local slot
      that reads a mirror (write after read), copies what arrived into
      the mirrors, recording each mirror's ``landed`` event, which the
      slots' launches wait on (read after write).  Over gloo the host
      first waits for the copies out and the swap blocks it; over NCCL
      the exchange stream waits for the copies out, the NCCL round is
      ordered after it and it after the round, and the host waits for
      nothing.  A round's copies out wait for the previous round's NCCL
      round (it read the same staging).

    Round 0 carries the blocks' slabs into a mirror pair matching the
    run's two buffer sets; round 1 (the packed transport, where a far
    slot is a column neighbour: ``stages``) the stagings' sides, after
    the packs.  ``rounds`` counts them, and ``times`` keeps the last
    rounds' split: the copy out and in (CUDA events), the host's wait
    for the copy out (seconds), and the swap: gloo's seconds on the host,
    or NCCL's on the exchange stream (CUDA events)."""

    def __init__(self, run, owners, hosts, rank: int):
        from parallel_convolution_tpu_torch.parallel import multihost

        self.run, self.owners, self.rank = run, tuple(owners), int(rank)
        far = {s for s, o in enumerate(owners) if hosts[o] != hosts[rank]}
        self.ranks = sorted({owners[s] for s in far})
        self.slots = sorted({n for s in run.local for n in run.neighbours[s]
                             if n in far})
        cols = ({n for s in run.local for n in run.col_neighbours[s]}
                if run.packed else set())
        dev = self.device = run.devices[0]
        C, h, w = run.block_shape
        D = run.depth
        self.mirrors = {n: [torch.empty((C, h, w), dtype=run.dtype,
                                        device=dev) for _ in (0, 1)]
                        for n in self.slots}
        self.stages = {n: torch.empty(2 * C * (h + 2 * D) * D,
                                      dtype=run.dtype, device=dev)
                       for n in self.slots if n in cols}
        self.readers = [
            {n: [s for s in run.local if n in run.neighbours[s]]
             for n in self.mirrors},
            {n: [s for s in run.local if n in run.col_neighbours[s]]
             for n in self.stages}]
        self.landed = [{n: torch.cuda.Event() for n in self.mirrors},
                       {n: torch.cuda.Event() for n in self.stages}]
        self.stream = torch.cuda.Stream(device=dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        # A round's copies into the mirrors: the landing buffers are free
        # for the next round once it is done.  Over NCCL, a round's swap:
        # the staging it sent is free for the next round's copies out.
        self.copied = [torch.cuda.Event(), torch.cuda.Event()]
        self.swapped = [torch.cuda.Event(), torch.cuda.Event()]
        self.on_card = multihost.transport() == "device"
        self.host = (multihost.DeviceStaging(dev) if self.on_card
                     else multihost.HostStaging())
        self.elt = torch.empty((), dtype=run.dtype).element_size()
        self.plans, self.pending, self.rounds = {}, None, 0
        self.times = collections.deque(maxlen=256)

    def plan(self, depth: int, staged: bool):
        """``(sends, recvs)``, far rank -> :func:`far_slabs`' list: what
        this rank copies out for it and what it copies in from it, in the
        order the bytes lie in the staging (rank ``q``'s receive list from
        this rank is this rank's send list to ``q``)."""
        key = (int(depth), bool(staged))
        if key not in self.plans:
            run = self.run

            def slabs(reader, owner):
                return far_slabs(run.table, self.owners, reader, owner,
                                 run.block_shape, depth, staged)

            self.plans[key] = ({q: slabs(q, self.rank) for q in self.ranks},
                               {q: slabs(self.rank, q) for q in self.ranks})
        return self.plans[key]

    def _views(self, block, stage, plan: MirrorPlan, rnd: int,
               depth: int) -> list:
        """One slot's slabs of round ``rnd``: its block's rectangles, or
        its staging's sides at ``depth``."""
        if rnd == 0:
            return [block[:, r0:r1, c0:c1] for r0, r1, c0, c1 in plan.rects]
        C, h, _ = self.run.block_shape
        n = 2 * C * (h + 2 * depth) * depth
        st = stage[:n].view(2, C, h + 2 * depth, depth)
        return [st[side] for side in plan.sides]

    def _copy(self, buf, views, into_views: bool) -> None:
        off = 0
        for v in views:
            nb = v.numel() * self.elt
            flat = buf[off:off + nb].view(self.run.dtype).view(v.shape)
            if into_views:
                v.copy_(flat, non_blocking=True)
            else:
                flat.copy_(v, non_blocking=True)
            off += nb

    def send(self, src: int, depth: int, staged: bool, rnd: int = 0) -> None:
        """Enqueue round ``rnd``'s copy out of the buffer set ``src`` (or
        the stagings) on the local slots' streams."""
        run = self.run
        sends, _ = self.plan(depth, staged)
        out, marks = [], []
        for q, items in sends.items():
            per_slot = []
            for m, plan in items:
                di, k = run.where[m]
                per_slot.append((m, self._views(
                    run.bufs[src][di][k], run.stage[di][k] if run.stage
                    else None, plan, rnd, depth)))
            nbytes = sum(v.numel() for _, vs in per_slot for v in vs)
            if not nbytes:
                continue
            buf = self.host.buffer(("out", rnd, q), nbytes * self.elt)
            off = 0
            for m, vs in per_slot:
                if not vs:
                    continue
                st = run.streams[m]
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                nb = sum(v.numel() for v in vs) * self.elt
                with torch.cuda.device(run.slots[m]), torch.cuda.stream(st):
                    if self.on_card:
                        st.wait_event(self.swapped[rnd])
                    ev[0].record(st)
                    self._copy(buf[off:off + nb], vs, False)
                    ev[1].record(st)
                off += nb
                marks.append(ev)
            out.append((q, rnd, buf))
        self.pending = (out, marks)

    def receive(self, src: int, depth: int, staged: bool,
                rnd: int = 0) -> None:
        """Finish round ``rnd``: the swap after the copies out, then the
        copies into the mirrors of the buffer set ``src`` (or the
        stagings) on the exchange stream, each mirror's ``landed`` event
        recorded behind its own copies."""
        from parallel_convolution_tpu_torch.parallel import multihost

        run = self.run
        _, recvs = self.plan(depth, staged)
        out, marks = self.pending
        self.pending = None
        x = self.stream
        t0 = time.perf_counter()
        if not self.on_card:
            for _, end in marks:
                end.synchronize()
            self.copied[rnd].synchronize()
        t1 = time.perf_counter()
        lands = []
        for q, items in recvs.items():
            views = [(n, vs) for n, vs in (
                (n, self._views(self.mirrors[n][src], self.stages.get(n),
                                plan, rnd, depth)) for n, plan in items) if vs]
            nbytes = sum(v.numel() for _, vs in views for v in vs)
            if nbytes:
                lands.append((q, self.host.buffer(("in", rnd, q),
                                                  nbytes * self.elt), views))
        swap = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        with torch.cuda.device(self.device), torch.cuda.stream(x):
            if self.on_card:
                # NCCL's stream waits for x as the call finds it, and x
                # for NCCL's round once the call returns.
                for _, end in marks:
                    x.wait_event(end)
                swap[0].record(x)
            multihost.swap(out, [(q, rnd, buf) for q, buf, _ in lands])
            if self.on_card:
                swap[1].record(x)
                self.swapped[rnd].record(x)
        t2 = time.perf_counter()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        with torch.cuda.device(self.device), torch.cuda.stream(x):
            after = {s for _, _, views in lands for n, _ in views
                     for s in self.readers[rnd][n]}
            for s in sorted(after):
                x.wait_event(run.launched[s])
            ev[0].record(x)
            for _, buf, views in lands:
                off = 0
                for n, vs in views:
                    nb = sum(v.numel() for v in vs) * self.elt
                    self._copy(buf[off:off + nb], vs, True)
                    off += nb
                    self.landed[rnd][n].record(x)
            ev[1].record(x)
            self.copied[rnd].record(x)
        self.rounds += 1
        self.times.append({"round": rnd, "out": marks, "in": ev,
                           "swap": swap if self.on_card else None,
                           "wait_s": t1 - t0, "swap_host_s": t2 - t1,
                           "bytes_out": sum(b.numel() for _, _, b in out),
                           "bytes_in": sum(b.numel() for _, b, _ in lands)})

    def split(self) -> list[dict]:
        """``times`` in milliseconds, a round each (after the run's
        streams are joined): the copy out (the slowest slot's), the
        host's wait for it, the swap (``gloo_ms``: the host's seconds in
        the gloo swap; ``nccl_ms``: the NCCL round on the exchange stream,
        with ``swap_host_ms`` the host's seconds enqueueing it), the copy
        in."""
        self.stream.synchronize()
        rows = []
        for t in self.times:
            row = {"round": t["round"],
                   "out_ms": max((a.elapsed_time(b) for a, b in t["out"]),
                                 default=0.0),
                   "wait_ms": 1e3 * t["wait_s"],
                   "in_ms": t["in"][0].elapsed_time(t["in"][1]),
                   "bytes_out": t["bytes_out"], "bytes_in": t["bytes_in"]}
            if t["swap"] is None:
                row["gloo_ms"] = 1e3 * t["swap_host_s"]
            else:
                row["nccl_ms"] = t["swap"][0].elapsed_time(t["swap"][1])
                row["swap_host_ms"] = 1e3 * t["swap_host_s"]
            rows.append(row)
        return rows

    def close(self) -> None:
        self.stream.synchronize()
        self.mirrors, self.stages = {}, {}


class _SlotRun:
    """The per-run state of ``cuda_rdma`` on a grid of slots on the card:
    streams, events, the double-buffered carry, the staging, and the
    pointer tables (one per buffer set and device, built once).  On a grid
    over several processes it holds this rank's slots only, maps its
    neighbours' buffers (:meth:`_span`) and keeps the step counters of the
    barrier between ranks."""

    # One process, no step yet, open, no far slot (the per-run values set
    # these).
    spans, step, closed, far, far_slots = False, 0, False, None, frozenset()

    def __init__(self, grid, blocks, boundary: str, depth: int,
                 col_mode: str):
        R, Cg = self.grid_shape = tuple(grid.shape)
        self.boundary = boundary
        self.slots = grid.slots
        n = len(self.slots)
        self.local = [s for s in range(n) if grid.owners is None
                      or grid.owners[s] == grid.rank]
        self.spans = grid.spans_processes
        self.devices = list(dict.fromkeys(
            self.slots[s] for s in self.local)) or [grid.device]
        enable_peers(self.devices)
        self.where, seen = [None] * n, {}
        for s in self.local:
            d = self.slots[s]
            self.where[s] = (self.devices.index(d), seen.get(d, 0))
            seen[d] = seen.get(d, 0) + 1
        flat = [b for row in blocks for b in row]
        mine = [flat[s] for s in self.local]
        self.depth = int(depth)
        # The two buffers the launches alternate between: the input stacked
        # per device (a private copy) and one more.  Allocated on each
        # device's current stream, which the slot streams wait on before
        # their first launch.
        x = [torch.stack([b for b, s in zip(mine, self.local)
                          if self.slots[s] == dev]) for dev in self.devices
             if mine]
        self.bufs = [x, [torch.empty_like(p) for p in x]]
        self.packed = col_mode == "packed" and Cg > 1
        if mine:
            self.block_shape, self.dtype = tuple(mine[0].shape), mine[0].dtype
        self.stage = []
        if self.packed and mine:
            C, h, _ = self.block_shape
            ns = 2 * C * (h + 2 * self.depth) * self.depth
            self.stage = [torch.empty((len(p), ns), dtype=self.dtype,
                                      device=p.device) for p in x]
        # Every slot's address in each buffer set, and its staging's: this
        # process's own, then (over processes) its neighbours' as mapped.
        self.addr = [[0] * n, [0] * n]
        stage_addr = [0] * n
        for s in self.local:
            di, k = self.where[s]
            for b in (0, 1):
                self.addr[b][s] = self.bufs[b][di][k].data_ptr()
            if self.stage:
                stage_addr[s] = self.stage[di][k].data_ptr()
        table = channels.neighbour_table(self.grid_shape, boundary)
        self.table = table
        # The barrier's partners: every block a slot's launch reads (its
        # eight neighbours), and the column neighbours whose staging it
        # reads.
        self.neighbours = [sorted({n_ for n_ in row if n_ >= 0} - {s})
                           for s, row in enumerate(table)]
        self.col_neighbours = [sorted({row[3], row[5]} - {-1, s})
                               for s, row in enumerate(table)]
        # Over processes: the mapped handles, and each remote slot's
        # counters as this process sees them (launched, staged).
        self.mapped, self.remote = [], [{}, {}]
        self.step, self.closed = 0, False
        if self.spans:
            self._span(grid, stage_addr)
        self.tables = [[torch.tensor(self.addr[b] + stage_addr,
                                     dtype=torch.int64, device=dev)
                        for dev in self.devices] for b in (0, 1)]
        self.nbr = [channels.device_table(self.grid_shape, boundary, dev)
                    for dev in self.devices]
        # The ghost depth the last step read (the overlapped pipeline's
        # write-after-read waits look at it).
        self.last_depth = 0
        self.streams = [None] * n
        for s, st in zip(self.local, _slot_streams(
                [self.slots[s] for s in self.local])):
            self.streams[s] = st
        self.launched = [torch.cuda.Event() if w is not None else None
                         for w in self.where]
        self.staged = [torch.cuda.Event() if w is not None else None
                       for w in self.where]
        self.joined = True
        # The pack's ctypes arguments and plan by (buffer set, first slot,
        # depth, count), every slot's at the run's depth made here.
        self.index = [torch.device(d).index for d in self.slots]
        self.packs, self.pack_plans = {}, {}
        if self.packed and mine:
            from parallel_convolution_tpu_torch.ops import _build

            self.pack_fn = _build.load_library("rdma").pc_rdma_pack
            for src in range(len(self.bufs)):
                for s in self.local:
                    self.pack_args(src, s, self.depth)

    def _span(self, grid, stage_addr) -> None:
        """Over several processes: export this rank's buffers, staging and
        counters, gather every rank's (``multihost.peer_records``, a
        collective), map the slots of this host's other ranks, on this
        card or another, into ``addr`` / ``stage_addr`` and their counters
        into ``remote``, and put the mirrors of the slots of other hosts
        (:class:`_FarExchange`) there in their place.  A stream waits on
        a counter on another card through the peer map as it does on
        this one."""
        from parallel_convolution_tpu_torch.parallel import multihost

        n = len(self.slots)
        dev = self.devices[0]
        # The launched counters, then the staged ones, a slot each: zero
        # and in place before any rank can map them (and the stacked
        # inputs before any neighbour reads them).
        self.counters = torch.zeros(2 * n, dtype=torch.int64, device=dev)
        for d in self.devices:
            torch.cuda.synchronize(d)
        record = {
            "where": {s: self.where[s] for s in self.local},
            "bufs": [[ipc_handle(p) for p in bufs] for bufs in self.bufs],
            "stage": [ipc_handle(p) for p in self.stage],
            "counters": ipc_handle(self.counters),
            "block": (getattr(self, "block_shape", None),
                      str(getattr(self, "dtype", ""))),
        }
        records = multihost.peer_records(record)
        hosts = multihost.hosts_of(records)
        near = [r for r, h in enumerate(hosts) if h == hosts[grid.rank]]
        if not self.local:  # a sub-grid of another's first slots
            shape, dt = next(r["block"] for r in records if r["where"])
            self.block_shape = tuple(shape)
            self.dtype = getattr(torch, dt.split(".")[-1])
        C, h, w = self.block_shape
        elt = torch.empty((), dtype=self.dtype).element_size()
        block_bytes = C * h * w * elt
        stage_bytes = 2 * C * (h + 2 * self.depth) * self.depth * elt
        for r in near:
            if r == grid.rank:
                continue
            rec = records[r]
            handle, off = rec["counters"]
            counters = self._map(handle, dev) + off
            for s, (di, k) in rec["where"].items():
                for b in (0, 1):
                    handle, off = rec["bufs"][b][di]
                    self.addr[b][s] = (self._map(handle, dev) + off
                                       + k * block_bytes)
                if rec["stage"]:
                    handle, off = rec["stage"][di]
                    stage_addr[s] = (self._map(handle, dev) + off
                                     + k * stage_bytes)
                self.remote[0][s] = counters + 8 * s
                self.remote[1][s] = counters + 8 * (n + s)
        far = {s for s, o in enumerate(grid.owners)
               if hosts[o] != hosts[grid.rank]}
        if any(m in far for s in self.local for m in self.neighbours[s]):
            self.far = _FarExchange(self, grid.owners, hosts, grid.rank)
            self.far_slots = frozenset(self.far.slots)
            for s, pair in self.far.mirrors.items():
                for b in (0, 1):
                    self.addr[b][s] = pair[b].data_ptr()
            for s, st in self.far.stages.items():
                stage_addr[s] = st.data_ptr()

    def _map(self, handle: bytes, device) -> int:
        self.mapped.append((handle, device))
        return _ipc_map(handle, device)

    def _counter(self, s: int, staged: bool) -> int:
        return self.counters.data_ptr() + 8 * (s + staged * len(self.slots))

    def mark(self, s: int, value: int, staged: bool = False) -> None:
        """Over processes: slot ``s``'s stream sets its launched (or staged)
        counter to ``value`` once the work enqueued on it is done."""
        if not self.spans:
            return
        from parallel_convolution_tpu_torch.ops import _build

        err = _build.load_library("rdma").pc_counter_write(
            self._counter(s, staged), value, self.streams[s].cuda_stream)
        _cu_check(err, f"slot {s}'s counter write")

    def after(self, s: int, n: int, step: int, staged: bool = False,
              stream=None) -> None:
        """``stream`` (default slot ``s``'s) after slot ``n``'s launch (or
        pack) of ``step``: its event where ``n`` is this process's, its
        mirror's ``landed`` event where it is on another host (the copy of
        the last round), else its counter reaching ``step`` (in its
        owner's memory, on this card or another)."""
        st = self.streams[s] if stream is None else stream
        if self.where[n] is not None:
            st.wait_event((self.staged if staged else self.launched)[n])
            return
        if n in self.far_slots:  # its mirror's copy of this step
            st.wait_event(self.far.landed[int(staged)][n])
            return
        from parallel_convolution_tpu_torch.ops import _build

        err = _build.load_library("rdma").pc_counter_wait(
            self.remote[staged][n], step, st.cuda_stream)
        _cu_check(err, f"a wait on slot {n}'s counter")

    def remote_neighbours(self) -> list:
        """The slots of this host's other processes that this process's
        slots read in place (a far slot's reads are of its mirror)."""
        return sorted({n for s in self.local for n in self.neighbours[s]
                       if self.where[n] is None
                       and n not in self.far_slots})

    def close(self) -> None:
        """End the run over processes, collectively: every slot joined and
        its card idle, this process's maps of its neighbours closed and
        its mirrors freed, a barrier (no rank still maps a buffer), then
        the buffers go.  A no-op in one process."""
        if not self.spans or self.closed:
            return
        from parallel_convolution_tpu_torch.parallel import multihost

        with tracing.span("rdma.close"):
            self.join()
            for d in self.devices:
                torch.cuda.synchronize(d)
            for handle, dev in self.mapped:
                _ipc_unmap(handle, dev)
            self.mapped = []
            if self.far is not None:
                self.far.close()
            multihost.barrier("cuda_rdma run closed")
            self.bufs, self.stage, self.tables = [[], []], [], []
            self.closed = True

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
        elt = self.bufs[src][0].element_size()
        addrs = [self.stage[self.where[b][0]][self.where[b][1]].data_ptr()
                 for b in span]
        # The rows it reads, a neighbour's as this process maps it.
        for b in span:
            for n in (self.table[b][1], b, self.table[b][7]):
                if n >= 0:
                    addrs.append(self.addr[src][n])
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
        wait on.  Over processes the fork counts as a step: each slot's
        counter then says its input is in place, which a neighbour's next
        launch waits for."""
        if self.closed:
            raise ValueError("this cuda_rdma run over processes is closed")
        mine = [s for s, st in enumerate(self.streams) if st is not None]
        for s in mine:
            for dev in self.devices:
                self.streams[s].wait_stream(torch.cuda.current_stream(dev))
        self.step += 1
        for s in mine:
            self.mark(s, self.step)
        self.joined = False

    def join(self) -> None:
        """Every device's current stream after every slot's launches, and
        over processes after the last launch of every remote neighbour
        (which read this process's buffers): the carry may then be read
        there, rewritten, and freed."""
        remote = self.remote_neighbours() if self.spans else ()
        for dev in self.devices:
            cur = torch.cuda.current_stream(dev)
            for ev in self.launched:
                if ev is not None:
                    cur.wait_event(ev)
            for n in remote:
                self.after(None, n, self.step, stream=cur)
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
    ghosts; on the CPU the blocks themselves.  Over several processes a
    card's run is made by every rank at once (it gathers the ranks' IPC
    handles)."""
    if grid.device.type == "cpu":
        return blocks
    with tracing.span("rdma.open"):
        run = _SlotRun(grid, blocks, boundary, depth, col_mode)
    return SlotCarry(run, run.bufs[0])


def close_carry(carry) -> None:
    """End a card's run over several processes (:meth:`_SlotRun.close`, a
    collective; the blocks :func:`slot_blocks` gave stay valid); a no-op
    for any other carry."""
    if isinstance(carry, SlotCarry):
        carry.run.close()


def load_carry(run: _SlotRun, blocks) -> SlotCarry:
    """A run's carry holding other blocks: the R×C blocks copied into its
    first buffer set, after its slot streams are joined (the multigrid
    smoother's way to reuse one run, its streams, buffers and pointer
    tables, for every sweep of a level).  Views of the run's buffers from
    an earlier step stay valid until the next step writes them."""
    if not run.joined:
        run.join()
    flat = [b for row in blocks for b in row]
    for s in run.local:
        di, k = run.where[s]
        run.bufs[0][di][k].copy_(flat[s])
    return SlotCarry(run, run.bufs[0])


def slot_channel_key(grid_shape, block_hw, radius: int, fuse: int, dtype,
                     boundary: str, col_mode: str) -> channels.ChannelKey:
    """The exchange identity a per-slot K3 / K4 step binds
    (``channels.plan_for``): the monolithic plan, whose column slabs give
    the staging's depth, for K3 and K4 alike."""
    return channels.ChannelKey(tuple(grid_shape), tuple(block_hw),
                               int(radius), int(fuse), str(dtype), boundary,
                               "monolithic", col_mode)


def slot_blocks(carry, grid_shape) -> list[list[torch.Tensor]]:
    """The R×C blocks of a carry (views of its buffers on the card, after
    joining the slot streams)."""
    if not isinstance(carry, SlotCarry):
        return carry
    run = carry.run
    run.join()
    flat = [None if w is None else carry.parts[w[0]][w[1]]
            for w in run.where]
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
    cplan = channels.plan_for(slot_channel_key(
        run.grid_shape, (h, w), r, T, run.dtype, run.boundary, col_mode))
    src = run.buffer_set(carry.parts)
    dst = 1 - src
    if run.joined:
        run.fork()
    streams = run.streams
    k_step = run.step + 1  # this step; the neighbours' last is run.step
    staged = cplan.packed_cols and run.packed
    depth = (cplan.col_slabs[0].src_cols[1] - cplan.col_slabs[0].src_cols[0]
             if staged else 0)
    vhw = None if run.boundary == "periodic" else valid_hw
    mid = stencil.group_dtype(quantize, out_dtype)
    fire = _slot_binder(run, plan.kernel == "tiled", filt, plan.groups[0],
                        ext, quantize, valid_hw,
                        plan.tile if plan.kernel == "tiled" else None)
    outs = {}
    for s in run.local:
        st = streams[s]
        di, k = run.where[s]
        out = run.bufs[dst][di][k]
        if rest:
            # Allocated on the slot's stream, which alone uses it.
            with torch.cuda.device(run.slots[s]), torch.cuda.stream(st):
                out = torch.empty((C, h + 2 * ext, w + 2 * ext), dtype=mid,
                                  device=run.slots[s])
        outs[s] = out
    far = run.far
    if far is not None:  # the copies out go ahead of any launch
        far.send(src, r * T, staged)
    if overlap:
        _overlap_launches(run, fire, src, outs, r * T, ext, partitioned,
                          staged, depth)
    else:
        # The barrier: a slot's launch reads its neighbours' outputs of
        # their last launch (read after write) and overwrites the buffer
        # their last launch read (write after read), so it waits on their
        # last launch and on nothing else.  Every wait is enqueued before
        # any of this step's records, so each names the previous launch
        # (over processes: the neighbour's counter at the previous step;
        # between hosts: the copy into its mirror, this round's).
        if far is not None:
            far.receive(src, r * T, staged)
        for s in run.local:
            for n in run.neighbours[s]:
                run.after(s, n, run.step)
        if staged:
            for s in run.local:
                rdma_pack(run, src, s, depth)
                run.staged[s].record(streams[s])
                run.mark(s, k_step, staged=True)
            if far is not None and far.stages:
                far.send(src, depth, staged, 1)
                far.receive(src, depth, staged, 1)
            for s in run.local:
                for n in run.col_neighbours[s]:
                    run.after(s, n, k_step, staged=True)
        for s in run.local:
            fire(src, s, outs[s])
    for s in run.local:
        st = streams[s]
        if rest:
            di, k = run.where[s]
            i, j = divmod(s, run.grid_shape[1])
            with torch.cuda.device(run.slots[s]), torch.cuda.stream(st):
                run.bufs[dst][di][k].copy_(stencil.fused_iterate(
                    outs[s], (i * h, j * w), filt, rest, vhw,
                    quantize=quantize, out_dtype=out_dtype, tile=tile))
        run.launched[s].record(st)
        run.mark(s, k_step)
    run.step = k_step
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
    reach at that depth: the write-after-read half of the barrier.

    Between hosts the exchange's round (:class:`_FarExchange`) ends after
    step 1, so the interiors hide it, and a far neighbour's wait is its
    mirror's copy; the interiors wait for no far neighbour (those read
    mirrors of this rank's blocks, not its buffers).  The packed
    transport's second round follows step 2."""
    _, h, w = run.block_shape
    sched = overlap_schedule(h + 2 * ext, w + 2 * ext, d, ext, partitioned)
    prev = run.last_depth if ext == 0 else 0
    waited = [set() for _ in run.slots]
    seen = [set() for _ in run.slots]
    k_step = run.step + 1

    def wait(s, offsets, far=True):
        row = run.table[s]
        for di, dj in sorted(offsets):
            n = row[(di + 1) * 3 + dj + 1]
            if (n < 0 or n == s or n in waited[s]
                    or (not far and n in run.far_slots)):
                continue
            run.after(s, n, run.step)
            waited[s].add(n)

    def waits_of(rect, offsets):
        if prev > d:
            offsets = offsets | covered_neighbours(rect, h, w, prev)
        return offsets

    for s in run.local:
        for label, rect, offsets in sched:
            if label == "interior":
                wait(s, waits_of(rect, offsets), far=False)
                fire(src, s, outs[s], rect)
    if run.far is not None:
        run.far.receive(src, d, staged)
    if staged:
        for s in run.local:
            wait(s, {(-1, 0), (1, 0), (0, -1), (0, 1)})
            rdma_pack(run, src, s, depth)
            run.staged[s].record(run.streams[s])
            run.mark(s, k_step, staged=True)
        if run.far is not None and run.far.stages:
            run.far.send(src, depth, staged, 1)
            run.far.receive(src, depth, staged, 1)
    for s in run.local:
        for label, rect, offsets in sched:
            if label == "interior":
                continue
            offsets = waits_of(rect, offsets)
            wait(s, offsets)
            if staged:
                for dj in sorted({dj for _, dj in offsets if dj}):
                    n = run.table[s][4 + dj]
                    if n >= 0 and n != s and n not in seen[s]:
                        run.after(s, n, k_step, staged=True)
                        seen[s].add(n)
            fire(src, s, outs[s], rect)
        wait(s, NEIGHBOURS)


def fused_rdma_slots(carry, filt: Filter, grid_shape, boundary: str = "zero",
                     quantize: bool = True, out_dtype=None, fuse: int = 1,
                     valid_hw=None, tile=None, col_mode: str = "strided",
                     overlap: bool = False, partitioned: bool = True,
                     grid=None):
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
    schedule with ``overlap``; ``grid``: a grid over several processes,
    whose blocks this rank holds its share of)."""
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
        b0 = first_block(carry, None)
        if b0 is None:  # this rank holds none of the grid's blocks
            return carry
        if b0.device.type != "cpu":
            raise ValueError("on the card a grid of slots carries a "
                             "SlotCarry (rdma.slot_carry)")
        _check_depth(filt.radius, T, b0.shape[1:])
        return fused_rdma_slots_plain(carry, filt, grid_shape, boundary,
                                      quantize, out_dtype, T, valid_hw,
                                      col_mode, overlap, partitioned, grid)
    run = carry.run
    if not run.local:  # this rank holds none of the grid's slots
        return carry
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
