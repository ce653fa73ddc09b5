"""The port's cost model: the JAX package's roofline ranking functions
(``tuning/costmodel.py:1-410``) rewritten for one NVIDIA card.

The model ranks the legal candidates of a workload for ``backend="auto"``
and prunes the measured search; it does not promise times.  What carried
over from the JAX model, formula for formula: the rim-recompute tax of a
fused tile (:func:`rim_overhead`), the FMA-slot count
(:func:`flops_per_px_iter`), ``max(bytes, operations)`` per pixel and
iteration, the per-chip Gpx/s unit, and the interpret penalty that keeps a
CPU grid off the kernels.  What was re-derived, because the JAX model
assumes one block per TPU chip:

* **Hardware.**  :data:`H100`'s constants are rates measured on the card by
  ``chip_smoke.py`` (each names its row), not TPU v5e figures.
* **Legality from shared memory.**  The kernels' own planners decide:
  :func:`effective_tile` and :func:`chunk_groups` call
  ``stencil.fused_plan`` and ``rdma.rdma_plan``, and :func:`rdma_is_tiled`
  is ``rdma_plan``'s choice, against the card's opt-in shared memory
  (``HardwareModel.smem_optin``), so the model and the kernels cannot
  disagree.  The TPU's (sublane, 128) alignment and ``r·T <= sublane``
  do not carry over.
* **The plain backends are eager.**  ``shifted`` / ``separable`` /
  ``xla_conv`` are PyTorch ops, one pass over the block each
  (``ops/conv.py``): :func:`hbm_bytes_per_px_iter` charges those passes
  where the JAX model charged XLA's fused 4 B per iteration.
* **The exchange on one card** is ``halo.halo_exchange`` (``cuda`` /
  ``cuda_sep``): a padded copy in device memory, charged in bytes, and six
  PyTorch copies per block, charged per op on the host.  ``cuda_rdma``
  exchanges inside its launch and pays neither.
* **Launches** are a term of their own (:func:`host_seconds_per_chunk`):
  K1 one per level and block, K2 one per level group and block, K3 / K4 one
  per chunk for the whole grid plus K2 per block for later level groups.
* **The quantize** is priced from probe 5a: the two-add magic round where
  the filter admits it (``stencil.round_mode``, the JAX package's L1
  rule), ``rintf`` above the bound.
* **A grid of slots** (a device per block, ``mesh.Grid.devices``) pays a
  launch per slot and chunk, the barrier's event waits, and, over several
  cards, the ghost bytes at the peer link's rate
  (:func:`slot_seconds_per_chunk`).  Its column transport is
  :func:`col_transport_seconds_per_round`: ``strided`` reads the
  neighbour's edge columns in place, ``packed`` stages them first, each
  priced from constants measured on the card (``col_row_s``,
  ``pack_s``), and :func:`pick_col_mode` takes the cheaper.
* **Overlap** (:func:`overlap_legal`) is the JAX term: the exchange rides
  under the compute, ``max(compute, exchange)`` in place of the sum, the
  exchange being a grid of slots' device-side part
  (:func:`slot_exchange_seconds_per_chunk`: the column transport and the
  ghost bytes between cards).  It is not free on the host: each slot
  launches its first level group region by region (five launches where
  one did), which :func:`slot_seconds_per_chunk` charges at
  ``launch_s``.

Pure arithmetic on Python numbers plus the planners' arithmetic: no device
access, so it runs the same on the CPU and beside the card.
"""

from __future__ import annotations

import dataclasses

from parallel_convolution_tpu_torch.ops.rdma import overlap_regions, rdma_plan
from parallel_convolution_tpu_torch.ops.stencil import (
    H100_SMEM_OPTIN, STEP_TILE, fused_plan,
)
from parallel_convolution_tpu_torch.utils.config import COL_MODES

STORAGE_BYTES = {"f32": 4, "bf16": 2, "u8": 1}

CUDA_BACKENDS = ("cuda", "cuda_sep", "cuda_rdma")
PLAIN_BACKENDS = ("shifted", "xla_conv", "separable")
SEPARABLE_BACKENDS = ("separable", "cuda_sep")

# On a CPU grid the CUDA backends run their plain versions, far slower
# than the card; the factor only has to dominate every real difference so
# that backend="auto" on the CPU picks a plain backend, as the JAX
# package's CPU mesh does.
INTERPRET_PENALTY = 1e4

# Bytes per pixel of one level of the eager plain backends (f32 working
# values): every tap of ops/conv.py is a multiply (read 4, write 4) and an
# add (read 8, write 4), after a zero accumulator (write 4); F.conv2d reads
# its input once and writes once; the u8 store-back is a round and a clamp
# (read 4, write 4 each); a mask is one multiply (read 4, write 4).
_TAP_BYTES = 20
_QUANTIZE_BYTES = 16
_MASK_BYTES = 8
# PyTorch ops per block of one halo exchange (halo.halo_exchange: the
# padded block, its interior and four ghost bands).
HALO_OPS_PER_BLOCK = 6


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Rates of one device kind.

    ``hbm_gbps`` is the device-memory rate the port's kernels achieve;
    ``flop_gops`` the card's issue ceiling in FMA-slot operations (2 per
    FMA), which prices the plain backends' arithmetic; ``tap_gops`` and
    ``sep_tap_gops`` the rates the fused kernels (K2 / K3 / K4) achieve in
    the same unit in the 2-D and the separable tap order, where every tap
    reads shared memory; ``quantize_slots`` the u8 store-back per pixel
    and level in slots with the magic round, ``rint_quantize_slots`` with
    ``rintf`` (filters above the magic round's L1 bound); ``launch_s`` the
    host's seconds per kernel wrapper
    call and ``op_s`` per eager PyTorch op; ``smem_optin`` the opt-in
    shared memory per block that legality is decided against.
    ``plain_kernels`` marks a host where the CUDA backends run their plain
    versions (the interpret penalty applies).  On a grid of slots:
    ``col_row_s`` the seconds one padded row of one channel of a column
    slab costs K3 / K4 read in place (``strided``) over a dense read,
    ``pack_s`` the fixed seconds of one slot's pack launch (``packed``),
    ``event_s`` the host's seconds per barrier wait, and ``link_gbps``
    the rate ghost bytes cross between two cards.
    """

    name: str
    hbm_gbps: float
    flop_gops: float
    tap_gops: float
    sep_tap_gops: float
    quantize_slots: float
    rint_quantize_slots: float
    launch_s: float
    op_s: float
    smem_optin: int = H100_SMEM_OPTIN
    plain_kernels: bool = False
    col_row_s: float = 0.0
    pack_s: float = 0.0
    event_s: float = 0.0
    link_gbps: float = 450.0


# NVIDIA H100 80GB HBM3 at a 700 W power limit, every rate from a run of
# chip_smoke.py on the card (its "hardware model" line; the rows named).
# tap_gops, sep_tap_gops and both quantize prices were measured on the
# register-strip level loop, hbm_gbps on the redesigned K1, the rest on
# the kernels before them (PERF.md §6):
#   hbm_gbps     "time stencil_step rgb blur3 f32": K1's bytes / its device
#                time (launches queued ahead of the card)
#   flop_gops    "probe op_price fma f32": 2 x its gops_per_s
#   tap_gops     "time rdma_tiled rgb 2x2 blur3 bf16 T=32": K4's executed
#                slots (flops_per_px_iter x px x T) / its time
#   sep_tap_gops "time fused_iterate rgb blur3 bf16 T=32": K2 (separable)
#                the same way
#   quantize_slots       2 x (per_step_vs_f32_fma of "magicround+add" - of
#                        "add"); rint_quantize_slots the same of "rint+add"
#   launch_s, op_s  "time host calls": a K1 wrapper call and a slice copy
#                on a tiny block, host clock over many calls
#   col_row_s, pack_s, event_s  "probe col_mode": the per-slot K4
#                launches at BASELINE config 2's blocks (2x2 slots, bf16,
#                T = 32) reading the columns in place against from the
#                staging, a slot's pack launch (its time less its bytes),
#                and the host's seconds a stream's wait on an event;
#                pack_s re-read on the redesigned pack (rdma_pack_kernel's
#                vector copy, one ctypes argument a launch): the least of
#                the three shapes, config 2's
#   link_gbps    NVLink 4 (the data sheet's 450 GB/s a direction): no run
#                here had two cards
H100 = HardwareModel("NVIDIA H100 80GB HBM3", hbm_gbps=2330.3,
                     flop_gops=46588.8, tap_gops=15984.7,
                     sep_tap_gops=13763.8, quantize_slots=1.806,
                     rint_quantize_slots=5.559, launch_s=51.15e-6,
                     op_s=9.74e-6, col_row_s=1.234e-10, pack_s=1.479e-5,
                     event_s=2.097e-6)

# Generic host: rough figures; on the CPU the model only has to crush the
# kernels (their plain versions run there) and rank the plain backends
# deterministically.  It prices the plain backends as the JAX package's
# host model prices its XLA tiers (4 B per pixel and iteration, no host
# term), so a CPU grid resolves as the JAX package's one-device CPU mesh.
CPU_HOST = HardwareModel("cpu", hbm_gbps=20.0, flop_gops=50.0, tap_gops=50.0,
                         sep_tap_gops=50.0, quantize_slots=2.0,
                         rint_quantize_slots=2.0, launch_s=20e-6, op_s=20e-6,
                         plain_kernels=True)


def hardware_for(platform: str, device_kind: str = "") -> HardwareModel:
    """The model for a platform / device name: every card gets the H100's
    rates under its own name (right order of magnitude; ranking is what
    matters), anything else the host model."""
    if platform == "gpu":
        return dataclasses.replace(H100, name=device_kind.strip() or "gpu")
    return dataclasses.replace(CPU_HOST, name=platform or "cpu")


def hardware_for_grid(grid) -> HardwareModel:
    """:func:`hardware_for` the grid's device, with the card's own opt-in
    shared memory."""
    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.utils.platform import device_kind

    if grid.device.type != "cuda":
        return hardware_for("cpu")
    return dataclasses.replace(hardware_for("gpu", device_kind(grid.device)),
                               smem_optin=stencil._smem_limit(grid.device))


def effective_tile(backend: str, tile, block_hw, radius: int, fuse: int,
                   smem_limit: int = H100_SMEM_OPTIN):
    """The output tile a chunk's first launch uses: K1's at fuse 1, else
    K2's or K4's from the kernels' own planners, clamped to the block.
    None for the plain backends and for K3 (the whole block is its tile)."""
    if backend not in CUDA_BACKENDS:
        return None
    T = max(1, int(fuse))
    h, w = block_hw
    if backend == "cuda_rdma":
        plan = rdma_plan(radius, T, block_hw, tile, smem_limit)
        return None if plan.kernel == "block" else tuple(plan.tile)
    if T == 1:
        th, tw = tile if tile is not None else STEP_TILE
        return (max(1, min(int(th), h)), max(1, min(int(tw), w)))
    th, tw, _ = fused_plan(radius, T, block_hw, tile, smem_limit)
    return (th, tw)


def chunk_groups(backend: str, fuse: int, tile, block_hw, radius: int,
                 smem_limit: int = H100_SMEM_OPTIN) -> list[int]:
    """Levels per launch of one chunk: the planners' level groups for the
    fused kernels, one group otherwise."""
    T = max(1, int(fuse))
    if backend == "cuda_rdma":
        return list(rdma_plan(radius, T, block_hw, tile, smem_limit).groups)
    if backend in ("cuda", "cuda_sep") and T > 1:
        return list(fused_plan(radius, T, block_hw, tile, smem_limit)[2])
    return [T]


def rdma_is_tiled(block_hw, radius: int, fuse: int,
                  smem_limit: int = H100_SMEM_OPTIN,
                  col_mode: str = "strided", grid=None) -> bool:
    """Whether ``cuda_rdma`` runs K4 (tiled) rather than K3 (whole block):
    ``rdma.rdma_plan``'s choice.  ``col_mode`` / ``grid`` are the JAX
    signature's: there the packed staging took VMEM beside the block; on
    the card it lives in device memory, so the choice does not depend on
    them."""
    return rdma_plan(radius, max(1, int(fuse)), block_hw, None,
                     smem_limit).kernel == "tiled"


def overlap_legal(backend: str, grid, block_hw, radius: int, fuse: int,
                  slotted: bool) -> bool:
    """Whether the interior-first overlapped pipeline applies (the JAX
    package's ``overlap_legal`` on the port's terms): ``cuda_rdma``, a grid
    of slots (on a one-device grid every block is in one launch and none
    waits on another) of more than one block, and a non-empty interior,
    ``min(block) > 2·r·fuse`` (else the whole block is rim and the
    pipeline degenerates to the serialized order).  Mirrors the kernels'
    own region partition (``rdma.overlap_regions``)."""
    if backend != "cuda_rdma" or not slotted:
        return False
    if grid[0] * grid[1] == 1:
        return False
    d = radius * max(1, int(fuse))
    return min(block_hw) > 2 * d


def overlap_launches(block_hw, radius: int, fuse: int, groups) -> int:
    """The region launches of one slot's first level group under the
    overlapped pipeline: the non-empty regions of ``rdma.overlap_regions``
    on the launch's rim-extended output."""
    T = max(1, int(fuse))
    ext = radius * (T - groups[0])
    h, w = block_hw[0] + 2 * ext, block_hw[1] + 2 * ext
    return sum(len(g) for g in overlap_regions(h, w, radius * T))


def rim_overhead(fuse: int, tile_hw, radius: int) -> float:
    """Extra-compute fraction from recomputing the shrinking overlap rim.

    A fused kernel computes level ``s`` (1-based) of a (th, tw) output
    tile on the extended extent (th + 2r(T-s))(tw + 2r(T-s)); the sum
    over levels, normalized by T*th*tw, minus 1, is the recompute tax.
    (The JAX package's formula, unchanged.)
    """
    T = max(1, int(fuse))
    th, tw = tile_hw
    total = sum((th + 2 * radius * (T - s)) * (tw + 2 * radius * (T - s))
                for s in range(1, T + 1))
    return total / (T * th * tw) - 1.0


def quantize_price(hw: HardwareModel, magic_round: bool) -> float:
    """Slots of the u8 store-back per pixel and level on ``hw``: the magic
    round's, or ``rintf``'s above the L1 bound."""
    return hw.quantize_slots if magic_round else hw.rint_quantize_slots


def flops_per_px_iter(k: int, separable: bool, quantize: bool,
                      fuse: int, rim_tile, radius: int,
                      quantize_slots: float = 2.0) -> float:
    """FMA-slot work per pixel per iteration: 2 slots per MAC (2k MACs
    separable, k² in the 2-D order), plus the u8 store-back, times the
    rim tax on ``rim_tile``.  The JAX formula, with the store-back's price
    a parameter: the TPU's magic round cost 2 slots; on the card probe 5a
    prices it (:func:`quantize_price`)."""
    macs = 2 * k if separable else k * k
    slots = 2.0 * macs + (quantize_slots if quantize else 0.0)
    return slots * (1.0 + rim_overhead(fuse, rim_tile, radius))


def _window(tile, depth: int) -> float:
    """A depth-deep window's area over its tile's area."""
    th, tw = tile
    return (th + 2 * depth) * (tw + 2 * depth) / (th * tw)


def _eager_level_bytes(backend: str, k: int, quantize: bool) -> float:
    if backend == "xla_conv":
        taps = 8.0
    elif backend == "separable":
        taps = 2 * (4.0 + _TAP_BYTES * k)
    else:
        taps = 4.0 + _TAP_BYTES * k * k
    return taps + (_QUANTIZE_BYTES if quantize else 0.0)


def hbm_bytes_per_px_iter(backend: str, storage: str, fuse: int, tile,
                          block_hw, radius: int, k: int = 3,
                          quantize: bool = True, ragged: bool = False,
                          smem_limit: int = H100_SMEM_OPTIN,
                          host: bool = False) -> float:
    """Device-memory bytes per pixel per iteration, B the storage width.

    * ``cuda`` / ``cuda_sep``: the halo exchange's padded copy (read B,
      write B over the r·T-padded block) once per chunk, then each launch
      reads its tiles' windows (B for the first level group, f32 after)
      and writes once (B for the last group, f32 before);
    * ``cuda_rdma``: no padded copy; K3 reads its block once, K4 its
      tiles' windows straight from the neighbours; later groups as K2;
    * the plain backends: the padded copy, the conversion to f32, every
      eager pass of each level (:func:`_eager_level_bytes`) on the
      shrinking extended block, the masks of the inner levels (and of
      every level on a ragged grid), and the conversion back.  On the
      ``host`` model, the JAX package's 4 B per iteration instead.
    """
    B = STORAGE_BYTES[storage]
    T = max(1, int(fuse))
    r = radius
    pad = B * (1.0 + _window(block_hw, r * T))
    if backend in PLAIN_BACKENDS:
        if host:
            return 4.0 * B
        convert = 0.0 if B == 4 else 2 * (B + 4.0)
        masks = (T - 1) + (1 if ragged else 0)
        level = _eager_level_bytes(backend, k, quantize)
        levels = (T * level * (1.0 + rim_overhead(T, block_hw, r))
                  + masks * _MASK_BYTES)
        return (pad + convert + levels) / T
    tile_eff = effective_tile(backend, tile, block_hw, r, T, smem_limit)
    groups = chunk_groups(backend, T, tile, block_hw, r, smem_limit)
    total = 0.0 if backend == "cuda_rdma" else pad
    left = T
    for i, g in enumerate(groups):
        left -= g
        in_b = B if i == 0 else 4
        out_b = B if left == 0 else 4
        if i == 0 and tile_eff is None:  # K3: the whole block, read once
            total += in_b + out_b
        else:
            total += in_b * _window(tile_eff or block_hw, r * g) + out_b
    return total / T


def ops_per_px_iter(backend: str, fuse: int, tile, block_hw, k: int,
                    separable: bool, quantize: bool, radius: int,
                    hw: HardwareModel, magic_round: bool = True) -> float:
    """:func:`flops_per_px_iter` over the chunk's level groups, each on the
    tile it runs (the block for the plain backends and for K3)."""
    T = max(1, int(fuse))
    groups = chunk_groups(backend, T, tile, block_hw, radius, hw.smem_optin)
    rim_tile = (effective_tile(backend, tile, block_hw, radius, T,
                               hw.smem_optin) or block_hw)
    q = quantize_price(hw, magic_round)
    return sum(g * flops_per_px_iter(k, separable, quantize, g, rim_tile,
                                     radius, q)
               for g in groups) / T


def host_seconds_per_chunk(backend: str, grid, fuse: int, groups, k: int,
                           quantize: bool, storage: str, ragged: bool,
                           hw: HardwareModel) -> float:
    """The host's seconds to issue one chunk over the whole grid: kernel
    wrapper calls at ``launch_s``, eager PyTorch ops at ``op_s``.

    ``cuda`` / ``cuda_sep`` pay the halo exchange (six copies per block)
    and one launch per block and level (K1) or level group (K2);
    ``cuda_rdma`` one launch for the grid and its pointer table, plus K2
    per block for each later level group; the plain backends every eager
    op of every level on every block (none on the host model, as in the
    JAX package's).
    """
    nb = grid[0] * grid[1]
    T = max(1, int(fuse))
    if backend in PLAIN_BACKENDS:
        if hw.plain_kernels:
            return 0.0
        per_level = {"shifted": 1 + 2 * k * k, "separable": 2 + 4 * k,
                     "xla_conv": 3}[backend] + (2 if quantize else 0) + 1
        convert = 0 if storage == "f32" else 2
        return nb * (HALO_OPS_PER_BLOCK + convert + T * per_level) * hw.op_s
    if backend == "cuda_rdma":
        later = len(groups) - 1
        return ((1 + nb * later) * hw.launch_s
                + (4 + (1 if later else 0)) * hw.op_s)
    launches = nb * (T if T == 1 else len(groups))
    ops = nb * (HALO_OPS_PER_BLOCK + (1 if T == 1 and ragged else 0))
    return launches * hw.launch_s + ops * hw.op_s


def col_transport_seconds_per_round(block_hw, radius: int, fuse: int,
                                    storage: str, hw: HardwareModel,
                                    col_mode: str = "packed",
                                    channels: int = 1) -> float:
    """Extra seconds one slot pays a round to take its two column slabs,
    cut at the row-padded height (``bh + 2d``: the corners ride the column
    phase), from its neighbours.

    ``strided`` reads them in place: ``col_row_s`` a padded row and
    channel, both sides.  ``packed`` pays the pack launch (``pack_s``)
    and the staging written and read back densely at ``hbm_gbps``.  The
    JAX formula's structure (a descriptor a row against the staging
    copies) with the card's measured prices."""
    if col_mode not in COL_MODES:
        raise ValueError(f"col_mode must be one of {COL_MODES}, "
                         f"got {col_mode!r}")
    d = radius * max(1, int(fuse))
    rows = block_hw[0] + 2 * d
    if col_mode == "strided":
        return 2.0 * rows * channels * hw.col_row_s
    slab_bytes = rows * d * STORAGE_BYTES[storage] * channels
    return hw.pack_s + 2.0 * 2.0 * slab_bytes / (hw.hbm_gbps * 1e9)


def pick_col_mode(grid, block_hw, radius: int, fuse: int, storage: str,
                  hw: HardwareModel, channels: int = 1) -> str:
    """The cheaper column transport for this decomposition (``auto``'s
    verdict); a grid of one column has no column partner, and its
    canonical label is ``"packed"`` (both transports are the same
    program there)."""
    if grid[1] <= 1:
        return "packed"
    packed = col_transport_seconds_per_round(block_hw, radius, fuse,
                                             storage, hw, "packed", channels)
    strided = col_transport_seconds_per_round(block_hw, radius, fuse,
                                              storage, hw, "strided",
                                              channels)
    return "packed" if packed <= strided else "strided"


def slot_exchange_seconds_per_chunk(backend: str, grid, fuse: int, block_hw,
                                    radius: int, storage: str, channels: int,
                                    hw: HardwareModel,
                                    col_mode: str = "packed",
                                    cards: int = 1) -> float:
    """The device-side exchange of one chunk on a grid of slots, the part
    the overlapped pipeline can hide under the compute: over several
    cards the ghost bytes of every block (two phases, depth r·T) at
    ``link_gbps``, the cards in parallel (every backend); for
    ``cuda_rdma`` the column transport of every slot, which share the
    card(s)."""
    R, C = grid
    nb = R * C
    T = max(1, int(fuse))
    d = radius * T
    t = 0.0
    if cards > 1:
        ghost = (2.0 * (block_hw[0] + block_hw[1] + 2 * d) * d * channels
                 * STORAGE_BYTES[storage])
        t += nb * ghost / (hw.link_gbps * 1e9) / cards
    if backend == "cuda_rdma" and C > 1:
        t += nb * col_transport_seconds_per_round(
            block_hw, radius, T, storage, hw, col_mode,
            channels) / max(1, cards)
    return t


def slot_seconds_per_chunk(backend: str, grid, fuse: int, groups, block_hw,
                           radius: int, storage: str, channels: int,
                           hw: HardwareModel, col_mode: str = "packed",
                           cards: int = 1, overlap: bool = False) -> float:
    """What a grid of slots adds to one chunk over the one-device grid:
    :func:`slot_exchange_seconds_per_chunk`, and for ``cuda_rdma`` the
    host's launches and waits: a launch per slot and level group (the
    one-device form launches once for the grid), with ``overlap`` the
    first group's region launches (:func:`overlap_launches`) in place of
    one, the pack launches with ``packed``, and up to eight barrier waits
    a slot."""
    R, C = grid
    nb = R * C
    t = slot_exchange_seconds_per_chunk(backend, grid, fuse, block_hw,
                                        radius, storage, channels, hw,
                                        col_mode, cards)
    if backend != "cuda_rdma":
        return t
    packed = col_mode == "packed" and C > 1
    first = (overlap_launches(block_hw, radius, fuse, groups) if overlap
             else 1)
    launches = nb * (len(groups) - 1 + first + (1 if packed else 0)) - 1
    waits = nb * (min(8, nb - 1) + (2 if packed else 0))
    return t + launches * hw.launch_s + waits * hw.event_s


def predict_seconds_per_px_iter(backend: str, storage: str, fuse: int, tile,
                                shape, block_hw, grid, k: int,
                                separable: bool, quantize: bool,
                                hw: HardwareModel,
                                ragged: bool = False,
                                magic_round: bool = True,
                                col_mode: str = "packed",
                                slotted: bool = False,
                                cards: int = 1,
                                overlap: bool = False) -> float:
    """Seconds per pixel (of the C·H·W grid) per iteration:
    ``max(bytes, operations)`` on the card plus the exchange plus the
    host's issue time.

    Bytes go at ``hbm_gbps``; the fused kernels' slots at ``tap_gops``
    (``sep_tap_gops`` in the separable order), the plain backends' at
    ``flop_gops``.  On a grid of slots (``slotted``, over ``cards``
    cards) :func:`slot_seconds_per_chunk` adds the per-slot launches, the
    barrier and the exchange (``col_mode``'s column transport, the ghost
    bytes between cards).  ``overlap=True`` (legal only per
    :func:`overlap_legal`; an illegal request prices the serialized form,
    as the dispatch layer clamps it) is the JAX term: the exchange rides
    under the compute, ``max(compute, exchange)`` in place of the sum,
    and the host pays the region launches.
    """
    radius = k // 2
    T = max(1, int(fuse))
    sep = separable and backend in SEPARABLE_BACKENDS
    nbytes = hbm_bytes_per_px_iter(backend, storage, T, tile, block_hw,
                                   radius, k, quantize, ragged,
                                   hw.smem_optin, hw.plain_kernels)
    ops = ops_per_px_iter(backend, T, tile, block_hw, k, sep, quantize,
                          radius, hw, magic_round)
    if backend not in CUDA_BACKENDS:
        rate = hw.flop_gops
    else:
        rate = hw.sep_tap_gops if sep else hw.tap_gops
    groups = chunk_groups(backend, T, tile, block_hw, radius, hw.smem_optin)
    pixels = shape[0] * grid[0] * grid[1] * block_hw[0] * block_hw[1]
    t_host = host_seconds_per_chunk(backend, grid, T, groups, k, quantize,
                                    storage, ragged, hw)
    ov = overlap and overlap_legal(backend, grid, block_hw, radius, T,
                                   slotted)
    t_ex = 0.0
    if slotted:
        t_ex = slot_exchange_seconds_per_chunk(
            backend, grid, T, block_hw, radius, storage, shape[0], hw,
            col_mode, cards)
        t_host += slot_seconds_per_chunk(
            backend, grid, T, groups, block_hw, radius, storage, shape[0],
            hw, col_mode, cards, ov) - t_ex
    compute = max(nbytes / (hw.hbm_gbps * 1e9), ops / (rate * 1e9))
    ex = t_ex / (T * pixels)
    t = ((max(compute, ex) if ov else compute + ex)
         + t_host / (T * pixels))
    if backend in CUDA_BACKENDS and hw.plain_kernels:
        t *= INTERPRET_PENALTY
    return t


def predict_gpx_per_chip(seconds_per_px_iter: float) -> float:
    """Gpixels/sec/chip implied by a per-px-iter time (the bench unit)."""
    return 1.0 / (seconds_per_px_iter * 1e9)


# -- rank-3 volumes (the JAX package's costmodel.py:413-470) ---------------
# Taps of one application of each rank-3 form: the FD smoothers touch 6r
# neighbours plus the rhs and the diagonal scale; the physics forms are
# 7-point-Laplacian updates with a few pointwise reaction terms (the JAX
# package's table, held against the registry in the tests).
VOLUME_FORM_TAPS = {
    "fd7": 8, "fd7_stack": 8, "fd25": 26, "fd25_stack": 26,
    "wave": 10, "grayscott": 24,
}
# Whole-grid copies of one volume exchange on one card
# (volumes/halo3.py): the interiors, the two D faces and parallel/halo.py's
# eight row and column copies.
VOLUME_HALO_OPS = 11


def volume_bytes_per_cell_iter(storage: str = "f32",
                               fields: int = 2) -> float:
    """Device-memory bytes per CELL (one grid point of every field) per
    iteration of a rank-3 form, the JAX package's accounting: the 6-face
    ghost pad written and read, the output written, 4 B per field in all
    (fusion saves exchanges, not bytes)."""
    return 4.0 * STORAGE_BYTES[storage] * max(1, int(fields))


def predict_volume_seconds_per_cell_iter(
        grid: tuple[int, int], block_hw: tuple[int, int], depth: int,
        radius: int, fuse: int, name: str, hw: HardwareModel,
        fields: int = 2, storage: str = "f32") -> float:
    """Roofline time per cell and iteration of one rank-3 form.

    ``max(bytes, operations)`` as in the JAX package: bytes from
    :func:`volume_bytes_per_cell_iter` over ``hw.hbm_gbps``, two FMA slots
    a tap and field from :data:`VOLUME_FORM_TAPS` over ``hw.flop_gops``.
    On a grid of more than one block the exchange on one card is added:
    the ±H / ±W face slabs of every block (the whole depth-padded column,
    ``fields·(depth + 2d)`` channels; the ±D faces are a local pad), read
    and written once in device memory, and :data:`VOLUME_HALO_OPS` eager
    copies on the host, a round every ``fuse`` iterations.  The forms
    themselves are eager PyTorch ops, each a pass over the block: the
    model does not price those passes, so it is a floor, not a forecast.
    """
    T = max(1, int(fuse))
    d = radius * T
    depth = max(1, int(depth))
    bh, bw = block_hw
    cells = max(1, depth * bh * bw)
    t_hbm = volume_bytes_per_cell_iter(storage, fields) / (hw.hbm_gbps * 1e9)
    taps = VOLUME_FORM_TAPS.get(name, 8)
    t_flop = 2.0 * taps * max(1, int(fields)) / (hw.flop_gops * 1e9)
    t_roof = max(t_hbm, t_flop)
    nb = grid[0] * grid[1]
    if nb == 1:
        return t_roof
    B = STORAGE_BYTES[storage]
    ch = max(1, int(fields)) * (depth + 2 * d)
    slab_bytes = ch * d * (2.0 * bw + 2.0 * (bh + 2 * d)) * B
    per_round = (2.0 * slab_bytes / (hw.hbm_gbps * 1e9)
                 + VOLUME_HALO_OPS * hw.op_s / nb)
    return t_roof + per_round / (T * cells)


# -- multigrid (the JAX package's costmodel.py:472-564) --------------------


def predict_vcycle_seconds(terms: list[tuple[float, int, int]]) -> float:
    """Price of one multigrid V-cycle: the SUM of its per-level sweeps.

    ``terms`` is one ``(seconds_per_px_iter, pixels, sweeps)`` triple per
    grid level (from :func:`predict_seconds_per_px_iter` on that level's
    own block and grid).  Coarse levels are cheaper (fewer pixels, often a
    smaller grid) but never free: on the card each sweep still pays its
    launches.
    """
    return sum(spp * px * n for spp, px, n in terms)


# Sweep counts of the V-cycle schedule, a mirror of solvers.multigrid's
# NU_PRE / NU_POST / NU_COARSE plus its work-unit charge (residual = one
# sweep, restriction + prolongation together one more), so that a job can
# be priced without the solver; tests/test_torch_multigrid.py holds the
# two equal.
MG_PRE_SWEEPS = 2
MG_POST_SWEEPS = 2
MG_COARSE_SWEEPS = 16
MG_TRANSFER_SWEEP_EQUIV = 2
# Mirrors multigrid.MG_MIN_EXTENT / MG_MAX_LEVELS.
MG_MIN_EXTENT = 8
MG_MAX_LEVELS = 12


def mg_default_levels(extent_hw: tuple[int, int],
                      mg_levels: int | None = None,
                      floor: int = MG_MIN_EXTENT) -> int:
    """Level count a V-cycle schedule would plan for this global fine
    extent: halve per level until a side would drop under ``floor``
    (capped by ``mg_levels`` and :data:`MG_MAX_LEVELS`).  A pricing mirror
    of ``multigrid.plan_levels``, ranking-grade: the real planner also
    vetoes torus misalignment, enforces the block floor and moves coarse
    levels onto smaller grids."""
    h, w = max(1, int(extent_hw[0])), max(1, int(extent_hw[1]))
    levels = 1
    while (min(h, w) >> levels) >= floor and levels < MG_MAX_LEVELS:
        levels += 1
    if mg_levels is not None:
        levels = max(1, min(levels, int(mg_levels)))
    return levels


def predict_mg_cycle_seconds(shape: tuple[int, int, int],
                             grid: tuple[int, int], k: int,
                             storage: str, quantize: bool,
                             hw: HardwareModel, *,
                             levels: int | None = None,
                             backend: str = "shifted",
                             ) -> tuple[float, float]:
    """``(cycle_seconds, fine_work_units_per_cycle)`` for one V-cycle.

    Per-level terms from :func:`predict_seconds_per_px_iter` on that
    level's own (halved) geometry, summed by
    :func:`predict_vcycle_seconds`; the second element is the
    pixel-weighted fine-grid work units one cycle spends, the unit
    ``mg_converge_stream`` bounds with ``max_iters``.  The grid is held
    fixed across levels (the real schedule moves coarse levels onto
    smaller grids, which only cheapens them).
    """
    C, H, W = (max(1, int(v)) for v in shape)
    R, Q = (max(1, int(v)) for v in grid)
    if levels is None:
        levels = mg_default_levels((H, W))
    levels = max(1, int(levels))
    terms: list[tuple[float, int, int]] = []
    wu = 0.0
    fine_px = C * H * W
    for lvl in range(levels):
        h = max(1, H >> lvl)
        w = max(1, W >> lvl)
        block = (max(1, -(-h // R)), max(1, -(-w // Q)))
        px = C * h * w
        if levels == 1:
            sweeps = MG_PRE_SWEEPS + MG_POST_SWEEPS
        elif lvl < levels - 1:
            sweeps = (MG_PRE_SWEEPS + MG_POST_SWEEPS
                      + MG_TRANSFER_SWEEP_EQUIV)
        else:
            sweeps = MG_COARSE_SWEEPS
        spp = predict_seconds_per_px_iter(
            backend, storage, 1, None, (C, h, w), block, (R, Q), k,
            False, quantize, hw)
        terms.append((spp, px, sweeps))
        wu += sweeps * px / fine_px
    return predict_vcycle_seconds(terms), wu
