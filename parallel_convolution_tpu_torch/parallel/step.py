"""The iteration driver of the PyTorch port (the JAX package's
``parallel/step.py``): the reference's main loop,

    for t in loops:
        exchange halos
        convolute(block)
        swap(src, dst)

over the grid's blocks.  ``fuse=T`` is temporal fusion: one T·r-deep halo
exchange, then T levels on the block, each re-zeroing out-of-image
positions so the result is bit-identical to T single steps.  Backends
``cuda`` / ``cuda_sep`` run the levels through the CUDA kernels of
``ops/stencil.py`` (K1 per level at fuse = 1, K2 for T levels at once);
``cuda_rdma`` runs the exchange and the levels of every block in one
launch (K3 / K4, ``ops/rdma.py``); ``shifted`` / ``separable`` /
``xla_conv`` are plain PyTorch.  ``backend="auto"`` (with ``fuse=None`` /
``tile=None`` to tune those too) resolves through ``tuning.resolve`` before
anything is built; ``fallback=True`` then probes the backend once per
(grid, config) per process and walks ``cuda_rdma → cuda`` on a transient
failure (``resilience.degrade``; on the card a refused ``cuda`` raises, on
the CPU it steps down to ``shifted``).

Non-divisible images are padded to the next block multiple and re-masked to
zero every iteration, so outputs stay bit-identical to the serial oracle
for any grid shape.

Run-to-convergence (BASELINE config 5, the reference's every-N
``MPI_Allreduce``): :func:`sharded_converge` and
:func:`sharded_converge_stream` run ``check_every``-iteration chunks on the
same steps, each ending in one single step that forms the (prev, cur) pair
and the max-abs diff over every block.  The JAX package loops on the device
(``lax.while_loop``); here the host loops, and the one readback of each
chunk's diff is the run's fence.

On a grid of slots (``mesh.Grid.devices``: a device per block) every
backend runs per slot: each block's work on its own device, the halo
exchange a copy of each edge slab between devices, ``cuda_rdma`` one
K3 / K4 launch per slot behind the barrier between slots
(``ops/rdma.py``), its column transport ``col_mode``, and with
``overlap=True`` each slot's launch region by region, the interior first
with no wait (:func:`resolve_overlap`); the convergence diff is the max
over the slots, gathered once per chunk with one readback.

A grid of slots may span processes (``mesh.make_grid(devices="all")`` in
a job of several, ``parallel/multihost.py``): each rank steps only its
blocks, the exchange sends a slab between ranks where a neighbour lives on
another, and the diff is reduced across ranks (``multihost.all_max``, a
NaN on any rank stopping every rank after the same chunk).  ``cuda_rdma``
reads a neighbour on another rank of the host in place (CUDA IPC behind
the counters of ``ops/rdma.py``, on the same card or another) and one on
another host from a mirror that an exchange fills once a chunk (on the
CPU its plain version after an exchange of the rims, whatever the hosts),
``auto`` takes rank 0's resolution and ``fallback`` the furthest rung any
rank's own probe reached.  The slabs cross ranks through host memory over
gloo and stay on the cards over NCCL (one card a process;
``multihost.transport``).
"""

from __future__ import annotations

import os
import time
import warnings
from functools import partial

import numpy as np
import torch

from parallel_convolution_tpu_torch.obs import (
    events as obs_events, metrics as obs_metrics, trace as obs_trace,
)
from parallel_convolution_tpu_torch.ops import conv, rdma, stencil
from parallel_convolution_tpu_torch.ops.filters import Filter
from parallel_convolution_tpu_torch.parallel import halo, kernels as kernel_forms
from parallel_convolution_tpu_torch.parallel.mesh import (
    Grid, first_block, join_blocks, local_blocks,
    make_grid, padded_extent, reblock, spans, split_blocks,
)
from parallel_convolution_tpu_torch.resilience.faults import fault_point
from parallel_convolution_tpu_torch.utils.config import (
    AUTO, BACKENDS, BOUNDARIES, COL_MODE_CHOICES, OVERLAP_INTERPRET_ENV,
    STORAGES, check_backend, check_run_config, check_solver, check_storage,
)

__all__ = ["STORAGE_DTYPES", "clamp_col_mode", "iterate_prepared",
           "overlap_clamp", "reshard_prepared", "resolve_col_mode",
           "resolve_overlap",
           "sharded_converge", "sharded_converge_stream", "sharded_iterate"]

# Iteration-carry dtypes.  Quantized states are exact small integers, so
# bf16 (exact for 0..255) and u8 carries lose nothing; accumulation is
# always f32 inside the correlate implementations.
STORAGE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                  "u8": torch.uint8}
if tuple(STORAGE_DTYPES) != STORAGES:  # not assert: must survive python -O
    raise RuntimeError(
        f"storage registries drifted: {tuple(STORAGE_DTYPES)} != {STORAGES}")

# The plain-PyTorch correlate implementations, keyed by backend name.
_PLAIN_CORRELATES = {
    "shifted": conv.correlate_padded,
    "xla_conv": conv.correlate_padded_conv2d,
    "separable": conv.correlate_padded_separable,
}


def _note_compile(builder: str, backend: str, grid, iters: int, fuse: int,
                  boundary: str, block_hw) -> None:
    """The JAX package's build telemetry with its fields: the ``compile``
    event and ``pctpu_compiles_total`` (``obs.events.note_compile``, which
    says what the port counts).  One branch when obs is off."""
    if not obs_metrics.enabled():
        return
    obs_events.note_compile(
        builder, backend, grid=f"{grid[0]}x{grid[1]}", iters=int(iters),
        fuse=int(fuse), boundary=boundary, block=[int(b) for b in block_hw])


def _obs_model(grid: Grid, filt: Filter, block_hw, channels: int,
               valid_hw) -> dict:
    """The run's padded (C, H, W) ``shape``, its device's identity and the
    cost model's view of the grid (slots, cards, the ragged rim, the
    round, the hardware), as keywords of ``obs.attribution``'s
    ``record_step`` and ``predicted_exchange_split``."""
    from parallel_convolution_tpu_torch.tuning import costmodel
    from parallel_convolution_tpu_torch.utils.platform import device_kind

    shape = (int(channels), grid.rows * block_hw[0], grid.cols * block_hw[1])
    return dict(shape=shape,
                platform="gpu" if grid.device.type == "cuda" else "cpu",
                device_kind=device_kind(grid.device), slotted=grid.slotted,
                cards=len(set(grid.slots)),
                ragged=tuple(valid_hw) != shape[1:],
                magic_round=stencil.round_mode(filt.taps) == "magic",
                hw=costmodel.hardware_for_grid(grid))


def _record_step_obs(backend: str, grid: Grid, filt: Filter, block_hw,
                     fuse: int, iters: int, channels: int, storage: str,
                     boundary: str, wall_s: float | None, valid_hw,
                     quantize: bool, tile, source: str,
                     overlap: bool = False, col_mode: str = "packed",
                     mg_level: int | None = None) -> dict | None:
    """``obs.attribution.record_step`` for one run on ``grid``
    (:func:`_obs_model`); its attribution dict, None when obs is off."""
    from parallel_convolution_tpu_torch.obs import attribution

    return attribution.record_step(
        backend=backend, grid=grid.shape, block_hw=tuple(block_hw),
        radius=filt.radius, fuse=fuse, iters=iters, channels=channels,
        storage=storage, boundary=boundary, wall_s=wall_s,
        quantize=quantize, tile=tile, source=source, overlap=overlap,
        col_mode=col_mode, mg_level=mg_level,
        **_obs_model(grid, filt, block_hw, channels, valid_hw))


def _valid_mask(valid_hw, block_hw, index, margin: int = 0,
                device=None) -> torch.Tensor:
    """Validity mask of block ``index`` = (i, j), extended by ``margin`` on
    every side, as (1, h+2m, w+2m) f32: 1 inside the global image, 0 beyond
    its edge or in the pad-to-multiple rim."""
    H, W = valid_hw
    bh, bw = block_hw
    i, j = index
    m = margin
    rows = i * bh - m + torch.arange(bh + 2 * m, device=device)
    cols = j * bw - m + torch.arange(bw + 2 * m, device=device)
    ok = (((rows >= 0) & (rows < H))[:, None]
          & ((cols >= 0) & (cols < W))[None, :])
    return ok[None].to(torch.float32)


def _boundary_geometry(grid_hw, valid_hw, block_hw, boundary: str):
    """Periodic divisibility, and whether the pad rim needs re-masking."""
    periodic = boundary == "periodic"
    divisible = (valid_hw[0] == block_hw[0] * grid_hw[0]
                 and valid_hw[1] == block_hw[1] * grid_hw[1])
    if periodic and not divisible:
        raise ValueError(
            "periodic boundary requires dimensions divisible by the grid: "
            f"image {tuple(valid_hw)} on grid {tuple(grid_hw)}")
    return periodic, not periodic and not divisible


def _build_halo_step(backend: str, filt: Filter, grid: Grid, valid_hw,
                     block_hw, quantize: bool, fuse: int = 1,
                     boundary: str = "zero", tile=None,
                     interior_split: bool = False, col_mode: str = "packed",
                     overlap: bool = False):
    """``fuse`` iterations on every block per halo exchange.

    fuse = 1: exchange r-deep halos, one level, re-mask the pad rim.
    fuse = T > 1: exchange T·r-deep halos once; ``cuda`` / ``cuda_sep`` run
    the T levels in K2 (which masks per level), the plain backends run T
    levels here, each re-masked on the shrinking extended block.
    ``interior_split`` (K2 on a ``zero`` boundary only, as in the JAX
    package) launches each block's levels as the 9-patch plan of its
    offset class (``stencil.axis_offset_classes``): the host knows every
    block's exact offset, but plans by class, so that the launches are
    the JAX package's.  On a grid of slots each block runs on its slot's
    device and the exchange copies slabs between them (between ranks on a
    grid over processes, where each rank steps its own blocks);
    ``col_mode`` is taken and not used (no column transport of its own).
    """
    periodic, needs_mask = _boundary_geometry(grid.shape, valid_hw, block_hw,
                                              boundary)
    # Once a build, as the JAX package consults it once a trace: the
    # exchange failing to build.
    fault_point("halo_exchange")
    r = filt.radius
    on_kernels = backend in ("cuda", "cuda_sep")
    sep = backend == "cuda_sep"
    masks: dict = {}
    split = interior_split and on_kernels and fuse > 1 and not periodic
    if split:
        classes = (stencil.axis_offset_classes(grid.rows, block_hw[0]),
                   stencil.axis_offset_classes(grid.cols, block_hw[1]))

    def block_off(i, j):
        if not split:
            return None
        return (classes[0][stencil.axis_class_index(i, grid.rows)],
                classes[1][stencil.axis_class_index(j, grid.cols)])

    def mask(index, margin, dtype):
        key = (index, margin, dtype)
        if key not in masks:
            masks[key] = _valid_mask(valid_hw, block_hw, index, margin,
                                     grid.slot_device(*index)).to(dtype)
        return masks[key]

    def correlate_level(p, out_dtype):
        if on_kernels:
            return stencil.stencil_step(p, filt, quantize=quantize,
                                        out_dtype=out_dtype, separable=sep,
                                        tile=tile)
        out = _PLAIN_CORRELATES[backend](p, filt)
        return conv.quantize_f32(out) if quantize else out

    def step(blocks):
        depth = r * fuse
        padded = (halo.exchange_per_block(blocks, depth, grid.shape, boundary,
                                          grid=grid)
                  if grid.slotted else
                  halo.halo_exchange(blocks, depth, grid.shape, boundary))
        out = [[None] * grid.cols for _ in range(grid.rows)]
        for (i, j), p in local_blocks(padded):
            dtype = blocks[i][j].dtype
            if on_kernels and fuse > 1:
                # All T levels in K2: one device-memory round trip.
                out[i][j] = stencil.fused_iterate(
                    p, (i * block_hw[0], j * block_hw[1]), filt, fuse,
                    None if periodic else tuple(valid_hw),
                    quantize=quantize, out_dtype=dtype, separable=sep,
                    tile=tile, interior_split=split,
                    block_off=block_off(i, j))
                continue
            for t in range(fuse):
                margin = depth - r * (t + 1)
                p = correlate_level(p, dtype)
                if not periodic and (needs_mask or margin > 0):
                    p = p * mask((i, j), margin, p.dtype)
            out[i][j] = p.to(dtype)
        return out

    return step


def _build_rdma_step(filt: Filter, grid: Grid, valid_hw, block_hw,
                     quantize: bool, fuse: int = 1, boundary: str = "zero",
                     tile=None, interior_split: bool = False,
                     col_mode: str = "packed", overlap: bool = False):
    """The ``cuda_rdma`` form (the JAX package's ``_build_rdma_step``): each
    chunk is one K3 / K4 launch that reads every block's ghosts from its
    neighbours' buffers and runs ``fuse`` levels, masked against the
    global image at every level (so no outer mask at fuse = 1).  Its step
    maps the stacked grid to the stacked grid (see :func:`_build_iterate`).
    On a grid of slots it is one launch per slot, the carry a
    ``rdma.SlotCarry`` (the blocks on the CPU), the column slabs moved by
    ``col_mode``, and with ``overlap`` (resolved: :func:`resolve_overlap`
    keeps it only on a grid of slots) each slot's launch region by region.
    ``interior_split`` is taken and not used, as in the JAX package.  On
    a grid over processes each rank launches its own slots, reading a
    neighbour on another rank of its host through CUDA IPC and one on
    another host from a mirror (``rdma._SlotRun``)."""
    periodic, _ = _boundary_geometry(grid.shape, valid_hw, block_hw, boundary)
    # The in-kernel exchange failing to build (pallas_rdma's site).
    fault_point("halo_exchange")
    vhw = None if periodic else tuple(valid_hw)

    if grid.slotted:
        def slot_step(carry):
            return rdma.fused_rdma_slots(
                carry, filt, grid.shape, boundary, quantize=quantize,
                fuse=fuse, valid_hw=vhw, tile=tile, col_mode=col_mode,
                overlap=overlap, grid=grid)

        return slot_step

    def step(x):
        # x is the stacked grid (rdma.stack_blocks).  The kernel writes a
        # new grid and never the one it reads: on the TPU,
        # _neighbor_barrier keeps a fast device from writing ghosts into a
        # neighbour still reading them; on one card the same hazard is a
        # CUDA block writing its output while another reads that buffer's
        # edge.  Stream order between chunk launches stands in for the
        # barrier.
        return rdma.fused_rdma_stacked(
            x, filt, grid.shape, boundary, quantize=quantize,
            out_dtype=x.dtype, fuse=fuse, valid_hw=vhw, tile=tile)

    return step


def _register_smoother_forms() -> None:
    for name in BACKENDS:
        build = (_build_rdma_step if name == "cuda_rdma"
                 else partial(_build_halo_step, name))
        kernel_forms.register(kernel_forms.KernelForm(
            name=name, rank=2, stencil_form="smooth",
            boundaries=tuple(BOUNDARIES),
            overlap_capable=name == "cuda_rdma",
            persistent_capable=name == "cuda_rdma", build=build))


_register_smoother_forms()


def _make_block_step(filt, grid, valid_hw, block_hw, quantize, backend,
                     fuse=1, boundary="zero", tile=None,
                     interior_split=False, col_mode="packed", overlap=False):
    """The smoother step of ``backend``, through the kernel-form registry;
    a transfer operator's name fails here (it is not a smoother)."""
    form = kernel_forms.resolve(2, backend, boundary)
    if form.stencil_form != "smooth":
        raise ValueError(
            f"kernel form {backend!r} is a {form.stencil_form} operator, "
            "not a smoother; transfer operators are driven by "
            "solvers.multigrid, not the iterate path")
    return form.build(filt, grid, valid_hw, block_hw, quantize, fuse,
                      boundary, tile, interior_split, col_mode,
                      overlap=overlap)


def _check_block_size(filt: Filter, block_hw) -> None:
    if min(block_hw) < filt.radius:
        raise ValueError(
            f"block {tuple(block_hw)} smaller than filter radius "
            f"{filt.radius}; use a smaller grid for this image")


def _check_fuse_fits(filt: Filter, block_hw, fuse: int,
                     note: str = "") -> None:
    """A ``fuse``-deep halo must fit in one neighbouring block."""
    if min(block_hw) < filt.radius * fuse:
        raise ValueError(
            f"fuse={fuse} needs blocks >= {filt.radius * fuse}, got "
            f"{tuple(block_hw)}{note}")


def _carry_in(blocks, grid: Grid, backend: str, boundary: str, depth: int,
              col_mode: str):
    """The chunk loops' carry: the blocks, or for ``cuda_rdma`` the stacked
    grid (one device: no per-block work on the host per launch) or
    ``rdma.slot_carry``'s (a grid of slots, ``depth`` ghosts at most)."""
    if backend != "cuda_rdma":
        return blocks
    if grid.slotted:
        return rdma.slot_carry(blocks, grid, boundary, depth, col_mode)
    return rdma.stack_blocks(blocks, grid.shape)


def _carry_out(state, grid: Grid, backend: str, close: bool = False):
    """Inverse of :func:`_carry_in`: the R×C blocks.  ``close`` ends a
    card's run over several processes there (``rdma.close_carry``, a
    collective): the carry is not stepped again."""
    if backend != "cuda_rdma":
        return state
    if grid.slotted:
        blocks = rdma.slot_blocks(state, grid.shape)
        if close:
            rdma.close_carry(state)
        return blocks
    return rdma.unstack_blocks(state, grid.shape)


def _build_iterate(grid: Grid, filt: Filter, iters: int, quantize: bool,
                   valid_hw, block_hw, backend: str, fuse: int = 1,
                   boundary: str = "zero", tile=None,
                   interior_split: bool = False, col_mode: str = "packed",
                   overlap: bool = False):
    """The fixed-count runner for one configuration: ``iters // fuse``
    fused chunks, then one tail chunk of the remaining ``iters % fuse``
    levels."""
    # A build: the JAX package consults this site on each compile (a miss
    # of its runner cache); the port keeps no such cache, so every build
    # consults it.
    fault_point("backend_compile")
    _check_block_size(filt, block_hw)
    fuse = max(1, min(fuse, iters or 1))
    _check_fuse_fits(filt, block_hw, fuse)
    chunk = _make_block_step(filt, grid, valid_hw, block_hw, quantize,
                             backend, fuse, boundary, tile, interior_split,
                             col_mode, overlap)
    n_chunks, rem = divmod(iters, fuse)
    tail = (_make_block_step(filt, grid, valid_hw, block_hw, quantize,
                             backend, rem, boundary, tile, interior_split,
                             col_mode, overlap)
            if rem else None)

    def run(blocks):
        state = _carry_in(blocks, grid, backend, boundary,
                          filt.radius * fuse, col_mode)
        for _ in range(n_chunks):
            state = chunk(state)
        if tail is not None:
            state = tail(state)
        return _carry_out(state, grid, backend, close=True)

    return run


def _check_quantize_contract(blocks, filt: Filter, quantize: bool,
                             grid: Grid | None = None) -> None:
    """Fail loudly on out-of-contract quantize-mode inputs: convex filters
    skip the store-back clip, so float values outside [0, 255] would
    propagate unclipped instead of being clipped on the first store-back.
    On a grid over several processes the range is every rank's."""
    if not (quantize and filt.convex):
        return
    if first_block(blocks).dtype == torch.uint8:
        return
    held = [b for _, b in local_blocks(blocks) if b.numel()]
    lo = min((float(b.min()) for b in held), default=0.0)
    hi = max((float(b.max()) for b in held), default=0.0)
    if spans(grid, blocks):
        from parallel_convolution_tpu_torch.parallel import multihost

        ranges = multihost.gather_object((lo, hi))
        lo, hi = min(r[0] for r in ranges), max(r[1] for r in ranges)
    if lo < 0.0 or hi > 255.0:
        raise ValueError(
            f"quantize=True input has values in [{lo}, {hi}], outside the "
            "u8 contract [0, 255]: convex filters elide the store-back "
            "clamp, so out-of-range values would propagate unclamped. "
            "Clamp the input (or use quantize=False for float planes).")


def _prepare(x, grid: Grid, storage: str = "f32"):
    """Move a global (C, H, W) image (numpy or tensor) to the grid's device
    in the storage dtype, pad it to block multiples and cut the blocks.
    Returns (blocks, valid_hw, block_hw)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    x = x.to(device=grid.device, dtype=STORAGE_DTYPES[storage])
    if x.dim() != 3:
        raise ValueError(f"expected a (C, H, W) image, got {tuple(x.shape)}")
    _, H, W = x.shape
    R, Cg = grid.shape
    Hp, Wp = padded_extent(H, R), padded_extent(W, Cg)
    if (Hp, Wp) != (H, W):
        x = torch.nn.functional.pad(x, (0, Wp - W, 0, Hp - H))
    return split_blocks(x, grid), (H, W), (Hp // R, Wp // Cg)


def reshard_prepared(blocks, valid_hw, grid: Grid,
                     src_grid: Grid | None = None):
    """Move prepared blocks (from :func:`_prepare`, any grid) onto ANOTHER
    grid: crop to the valid extent, zero re-pad to the new grid's block
    multiples and re-block (the JAX package's ``reshard_prepared``;
    elastic recovery's in-memory counterpart of the checkpoint reshard,
    e.g. a serving engine shrinking mid-process without a disk round
    trip).

    Bit-exact by the masking invariant: positions outside ``valid_hw`` are
    zero on every grid, so crop and zero re-pad give exactly the blocks
    :func:`_prepare` builds on ``grid`` from the valid pixels.  Each target
    block is assembled on its slot's device from the source blocks it
    overlaps (``mesh.reblock``); no device holds the global image.  Blocks
    of a grid over several processes (``src_grid``, whose ``None`` entries
    another rank holds) move to ``grid``'s ranks piece by piece, point to
    point: no rank ever holds the global image."""
    spans(src_grid, blocks)  # another process's blocks need their grid
    H, W = (int(v) for v in valid_hw)
    R, Cg = grid.shape
    return reblock(blocks, (H, W), grid, (padded_extent(H, R) // R,
                                          padded_extent(W, Cg) // Cg),
                   src_grid=src_grid)


def _global_f32(blocks, grid: Grid, valid_hw) -> torch.Tensor:
    """The grid's blocks as the global (C, H, W) f32 field at the valid
    extent, on the grid's device (on every rank of a grid over several
    processes: each block broadcast from its rank)."""
    if grid.spans_processes:
        from parallel_convolution_tpu_torch.parallel import multihost

        blocks = multihost.fill_blocks(blocks, grid.owners)
    full = join_blocks(blocks, grid.device)
    return full[:, :valid_hw[0], :valid_hw[1]].to(torch.float32)


def _storage_name(dtype) -> str:
    for name, dt in STORAGE_DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"no storage holds dtype {dtype}")


def resolve_overlap(overlap: bool | None, backend: str, grid: Grid) -> bool:
    """The overlap knob a run ACTUALLY uses (the JAX package's
    ``resolve_overlap``).  ``None`` / False is the serialized order.
    ``True`` is a request, clamped with a one-time warning, after which
    every row stamps False:

    * a backend with no overlapped pipeline (``cuda_rdma`` only) runs
      serialized;
    * a grid on the CPU runs serialized: its plain version has nothing in
      flight to hide, unless ``PCTPU_OVERLAP_INTERPRET`` is set (to 1),
      the JAX package's escape hatch for byte proofs, which runs the
      plain overlapped schedule (``rdma.fused_rdma_slots_plain``);
    * a ``cuda_rdma`` grid that is not slotted runs serialized: all of
      its blocks share one launch, so no block waits on another (the
      counterpart of ``overlap_legal``'s "no collective to hide").

    On a grid of slots ``cuda_rdma`` keeps it: each slot's K3 / K4 runs
    region by region, the interior first with no wait
    (``rdma.overlap_schedule``)."""
    if not overlap:
        return False
    clamp = overlap_clamp(backend, grid)
    if clamp is not None:
        cause, msg = clamp
        if cause not in _OVERLAP_WARNED:
            _OVERLAP_WARNED.add(cause)
            warnings.warn(f"{msg} -- rows stamp overlap=False", UserWarning,
                          stacklevel=2)
        return False
    return True


_OVERLAP_WARNED: set[str] = set()


def overlap_clamp(backend: str, grid: Grid) -> tuple[str, str] | None:
    """``(cause, message)`` of the clamp :func:`resolve_overlap` applies
    to an overlap request for ``backend`` on ``grid``, or None where the
    request stands."""
    if not kernel_forms.overlap_capable(backend):
        return (f"backend:{backend}",
                f"overlap=True requested but backend {backend!r} has no "
                "overlapped halo pipeline (cuda_rdma only); running "
                "serialized")
    if grid.device.type == "cpu" and not os.environ.get(
            OVERLAP_INTERPRET_ENV):
        return ("cpu",
                "overlap=True force-serialized on a CPU grid (its plain "
                "version has nothing in flight to hide; set "
                f"{OVERLAP_INTERPRET_ENV}=1 to run the overlapped schedule "
                "anyway for byte proofs)")
    if not grid.slotted:
        return ("unslotted",
                f"overlap=True force-serialized: {backend!r} on a grid that "
                "is not slotted runs every block in one launch, with no "
                "wait between blocks to hide (give each block a slot: "
                "--device)")
    return None


def resolve_col_mode(col_mode, backend: str, grid: Grid, block_hw,
                     radius: int, fuse: int, storage: str) -> str:
    """The column-slab transport a run uses (the JAX package's
    ``resolve_col_mode``).  Only ``cuda_rdma`` on a grid of slots with more
    than one column moves column slabs between slots; everywhere else the
    knob is inert and normalises to the canonical ``"packed"`` (one label a
    program).  There ``None`` / ``"auto"`` ask the cost model
    (``costmodel.pick_col_mode``, on the card's measured prices) and an
    explicit transport is kept: the two give the same bytes."""
    if col_mode is not None and col_mode not in COL_MODE_CHOICES:
        raise ValueError(f"col_mode must be one of {COL_MODE_CHOICES}, got "
                         f"{col_mode!r}")
    if (not kernel_forms.persistent_capable(backend) or not grid.slotted
            or grid.cols <= 1):
        return "packed"
    if col_mode in (None, "auto"):
        from parallel_convolution_tpu_torch.tuning import costmodel

        return costmodel.pick_col_mode(
            grid.shape, tuple(int(b) for b in block_hw), int(radius),
            max(1, int(fuse)), storage, costmodel.hardware_for_grid(grid))
    return col_mode


def clamp_col_mode(col_mode: str, backend: str) -> str:
    """Re-clamp a resolved ``col_mode`` after a degrade walk: a backend
    with no column transport normalises to the canonical ``"packed"``."""
    return col_mode if kernel_forms.persistent_capable(backend) else "packed"


def _resolve_auto(grid: Grid, filt: Filter, backend: str, fuse, tile,
                  storage: str, quantize: bool, boundary: str, valid_hw,
                  channels: int, check_every: int | None = None):
    """``backend='auto'`` -> the concrete ``(backend, fuse, tile, source)``
    through ``tuning.resolve`` (plan cache if ``PCTPU_PLAN_FILE`` names
    one, else the cost model).  An explicit backend passes through, with
    ``fuse=None`` meaning 1 and ``source`` None.  ``check_every`` (the
    convergence path only) caps the fuse at ``check_every - 1`` and keys
    the plan, so a convergence run resolves its own plan."""
    if backend != AUTO:
        return backend, (1 if fuse is None else int(fuse)), tile, None
    from parallel_convolution_tpu_torch import tuning

    res = tuning.resolve(
        grid, filt, (channels, int(valid_hw[0]), int(valid_hw[1])),
        storage=storage, quantize=quantize, boundary=boundary, fuse=fuse,
        tile=None if tile is None else tuple(int(v) for v in tile),
        check_every=check_every)
    return res.backend, res.fuse, res.tile, res.source


def _auto_overlap(overlap, source):
    """The overlap request after :func:`_resolve_auto`: an unset one
    (None) takes the tuner's verdict when ``auto`` resolved (``source``
    set), else it stays as asked."""
    if overlap is None and source is not None:
        from parallel_convolution_tpu_torch import tuning

        return tuning.last_resolution().overlap
    return overlap


def _resolve_fallback(grid: Grid, filt: Filter, backend: str,
                      quantize: bool, fuse: int, boundary: str, tile,
                      storage: str, block_hw,
                      interior_split: bool = False,
                      col_mode: str = "packed", overlap: bool = False) -> str:
    """Walk the degradation chain (``resilience.degrade``) for this
    configuration.  ``block_hw`` and ``storage`` describe the REAL run:
    the kernel and its launch shape depend on both, so a probe of another
    geometry could pass where the real launch fails; ``col_mode`` and
    ``overlap`` are re-clamped for each tier."""
    from parallel_convolution_tpu_torch.resilience import degrade

    return degrade.resolve_backend(
        grid, filt, backend, quantize=quantize, fuse=int(fuse),
        boundary=boundary, tile=None if tile is None else tuple(tile),
        storage=storage, block_hw=tuple(block_hw),
        interior_split=interior_split, col_mode=col_mode, overlap=overlap)


def _run_knobs(grid: Grid, filt: Filter, backend: str, fuse: int, tile,
               storage: str, quantize: bool, boundary: str, block_hw,
               interior_split: bool, fallback: bool, overlap, col_mode):
    """The knobs after ``auto``: overlap's clamps, the column transport
    resolved, the fallback walk (``col_mode`` and ``overlap`` re-clamped
    to the tier it lands on).  Returns ``(backend, col_mode, overlap)``."""
    overlap = resolve_overlap(overlap, backend, grid)
    col_mode = resolve_col_mode(col_mode, backend, grid, block_hw,
                                filt.radius, fuse, storage)
    if fallback:
        backend = _resolve_fallback(grid, filt, backend, quantize, fuse,
                                    boundary, tile, storage, block_hw,
                                    interior_split, col_mode, overlap)
        col_mode = clamp_col_mode(col_mode, backend)
        overlap = kernel_forms.clamp_overlap(overlap, backend)
    return backend, col_mode, overlap


def iterate_prepared(blocks, filt: Filter, iters: int, grid: Grid, valid_hw,
                     quantize: bool = True, backend: str = "shifted",
                     fuse: int | None = 1, boundary: str = "zero",
                     tile=None, check_contract: bool = True,
                     interior_split: bool = False, fallback: bool = False,
                     overlap: bool | None = None, col_mode: str | None = None):
    """Iterate the grid's prepared blocks (from :func:`_prepare`, or
    ``utils.sharded_io.load_sharded``); returns the blocks ``iters``
    iterations later, still padded.  ``auto`` resolves for the blocks'
    storage and the global ``valid_hw`` image first; ``fallback=True``
    then probes the resolved backend once per (grid, config) per process
    and walks the degradation chain on a transient failure
    (``resilience.degrade``, with a ``BackendDegradedWarning``).
    ``interior_split`` launches K2 by the 9-patch plan (``cuda`` /
    ``cuda_sep`` at fuse > 1 on a ``zero`` boundary; elsewhere taken and
    not used, as in the JAX package).  ``col_mode`` (``packed`` /
    ``strided`` / ``auto``) is ``cuda_rdma``'s column transport on a grid
    of slots (:func:`resolve_col_mode`); ``overlap`` see
    :func:`resolve_overlap`."""
    b0 = first_block(blocks)
    if b0.dtype == torch.uint8:
        check_storage("u8", quantize)
    if check_contract:
        _check_quantize_contract(blocks, filt, quantize, grid)
    storage = _storage_name(b0.dtype)
    backend, fuse, tile, source = _resolve_auto(
        grid, filt, backend, fuse, tile, storage, quantize, boundary,
        valid_hw, b0.shape[0])
    overlap = _auto_overlap(overlap, source)
    check_backend(backend)
    block_hw = tuple(b0.shape[1:])
    fuse = int(fuse)
    if fuse < 1:
        raise ValueError(f"fuse must be >= 1, got {fuse}")
    backend, col_mode, overlap = _run_knobs(
        grid, filt, backend, max(1, min(fuse, iters or 1)), tile, storage,
        quantize, boundary, block_hw, interior_split, fallback, overlap,
        col_mode)
    tile = None if tile is None else tuple(tile)
    run = _build_iterate(grid, filt, iters, quantize, tuple(valid_hw),
                         block_hw, backend, fuse, boundary, tile,
                         interior_split, col_mode, overlap)
    out = run(blocks)
    if obs_metrics.enabled():
        # Halo bytes, rounds and the exchange event, with NO wall and NO
        # synchronize: this entry returns before the card finishes, and a
        # fence here would serialize the caller's next work behind it.
        # The wall series come from callers that fence (bench, converge).
        _record_step_obs(backend, grid, filt, block_hw,
                         max(1, min(fuse, iters or 1)), iters, b0.shape[0],
                         storage, boundary, None, valid_hw, quantize, tile,
                         source="iterate_prepared", overlap=overlap,
                         col_mode=col_mode)
    return out


def _setup_run(x, grid, device, backend: str, storage: str, boundary: str,
               quantize: bool):
    """The prologue of every entry point on a global image: the backend
    check, the default grid (1×1 on ``device``, the card unless told
    otherwise), the run configuration, and the prepared blocks.
    Returns ``(grid, blocks, valid_hw, block_hw)``."""
    check_backend(backend, allow_auto=True)
    if grid is None:
        grid = make_grid(device=device)
    elif device is not None and grid.device != torch.device(device):
        raise ValueError(f"grid is on {grid.device}, device={device!r}")
    check_run_config(storage, boundary, quantize)
    return (grid, *_prepare(x, grid, storage))


def sharded_iterate(x, filt: Filter, iters: int, grid: Grid | None = None,
                    quantize: bool = True, backend: str = "shifted",
                    storage: str = "f32", fuse: int | None = 1,
                    boundary: str = "zero", tile=None,
                    interior_split: bool = False, fallback: bool = False,
                    overlap: bool | None = None, col_mode: str | None = None,
                    device=None) -> torch.Tensor:
    """Run ``iters`` stencil iterations of a global (C, H, W) image over the
    grid.  Returns the global (C, H, W) float32 result on the grid's
    device (bit-identical to the serial oracle in quantize mode for any
    grid shape, whichever backend ``auto`` picks).

    ``grid`` defaults to 1×1 on ``device`` (default: the card — it raises
    without CUDA; tests pass ``device='cpu'``); a grid of slots
    (``mesh.make_grid(devices=...)``) runs each block on its slot's device.
    ``storage`` is the carry dtype; ``tile`` = (rows, cols) overrides the
    CUDA kernels' output tile.  ``backend='auto'`` picks the backend, and
    ``fuse`` / ``tile`` where they are None, through ``tuning.resolve``.
    ``quantize=True`` assumes u8-range input and raises on values outside
    [0, 255] for convex filters.  ``fallback=True``: see
    :func:`iterate_prepared`, as ``interior_split``, ``overlap`` and
    ``col_mode``.
    """
    grid, blocks, valid_hw, _ = _setup_run(
        x, grid, device, backend, storage, boundary, quantize)
    out = iterate_prepared(blocks, filt, iters, grid, valid_hw,
                           quantize=quantize, backend=backend, fuse=fuse,
                           boundary=boundary, tile=tile,
                           interior_split=interior_split, fallback=fallback,
                           overlap=overlap, col_mode=col_mode)
    return _global_f32(out, grid, valid_hw)


# ---------------------------------------------------------------------------
# Run to convergence
# ---------------------------------------------------------------------------


def _max_abs_diff(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """max |cur - prev| in f32 over one tensor (a block, or the stacked
    grid) as a 0-d tensor on its device, through one f32 temporary of its
    size: the difference, whose min and max one pass reads (max |d| =
    max(max d, -min d); a NaN stays NaN).  An empty tensor gives 0, as the
    oracle's ``cur.size == 0``."""
    if cur.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=cur.device)
    d = (torch.sub(cur, prev) if cur.dtype == torch.float32
         else cur.to(torch.float32).sub_(prev))
    lo, hi = torch.aminmax(d)
    return torch.maximum(hi, -lo)


def _slots_max_diff(cur, prev, device=None) -> torch.Tensor:
    """max |cur − prev| over a state as a 0-d f32 tensor: the stacked grid
    at once, or each block this process holds reduced where it lives and
    the shares gathered once on ``device`` (default: the first block's; a
    NaN on any slot stays NaN)."""
    if torch.is_tensor(cur):
        return _max_abs_diff(cur, prev)
    diffs = [_max_abs_diff(c, prev[i][j]) for (i, j), c in local_blocks(cur)]
    dev = diffs[0].device if device is None else device
    return torch.stack([d.to(dev) for d in diffs]).amax()


def _carry_diff(cur, prev, grid: Grid) -> torch.Tensor:
    """The MPI_Allreduce (``lax.pmax`` in the JAX package): the max-abs
    change of one iteration over every block and channel, the pad rim
    included (zero in both), as a 0-d tensor on the grid's device.  Each
    device's share is reduced where it lives and the shares are gathered
    once (a NaN on any slot stays NaN).  On a grid over several processes
    each rank reduces its blocks and the ranks their shares
    (``multihost.all_max``: the 0-d result on the host, or on the card
    under NCCL, NaN if any rank's is)."""
    if isinstance(cur, rdma.SlotCarry):
        cur.run.join()
        d = _slots_max_diff([cur.parts], [prev.parts], grid.device)
    else:
        d = _slots_max_diff(cur, prev, grid.device)
    if grid.spans_processes:
        from parallel_convolution_tpu_torch.parallel import multihost

        d = multihost.all_max(d)
    return d


def _build_converge_chunk(grid: Grid, filt: Filter, n: int, quantize: bool,
                          valid_hw, block_hw, backend: str,
                          boundary: str = "zero", fuse: int = 1, tile=None,
                          interior_split: bool = False,
                          col_mode: str = "packed", overlap: bool = False):
    """ONE convergence chunk: ``n`` iterations and the (prev, cur) max-abs
    diff, as a 0-d f32 tensor left on the device.

    ``n - 1`` iterations run as ``(n-1)//fuse`` fused steps and
    ``(n-1)%fuse`` single ones, then ONE single step forms the pair, so
    any fuse gives the bytes of fuse 1.  The chunk maps the carry to the
    carry (:func:`_carry_in`).  ``tol`` is not part of it: the host
    compares.
    """
    # Fuse at most the n-1 pre-pair iterations; a 1-iteration chunk has
    # no pre-pair work at all.  The check below is the stream's, as in
    # JAX; sharded_converge has made a stricter one for the whole run.
    fuse = max(1, min(fuse, max(1, n - 1)))
    _check_fuse_fits(filt, block_hw, fuse)
    step = _make_block_step(filt, grid, valid_hw, block_hw, quantize,
                            backend, 1, boundary, tile, False, col_mode,
                            overlap)
    fused = (_make_block_step(filt, grid, valid_hw, block_hw, quantize,
                              backend, fuse, boundary, tile, interior_split,
                              col_mode, overlap)
             if fuse > 1 and n > 1 else None)

    def chunk(state):
        prev = state
        if fused is None:
            for _ in range(n - 1):
                prev = step(prev)
        else:
            for _ in range((n - 1) // fuse):
                prev = fused(prev)
            for _ in range((n - 1) % fuse):
                prev = step(prev)
        cur = step(prev)
        return cur, _carry_diff(cur, prev, grid)

    return chunk


def _multigrid(x, filt: Filter, tol, max_iters, grid, quantize, backend,
               storage, boundary, fuse, tile, interior_split, fallback,
               overlap, mg_levels, col_mode, device, stream: bool):
    """``solver='multigrid'``: the V-cycle (``solvers.multigrid``, imported
    here because the solver package imports this module)."""
    from parallel_convolution_tpu_torch.solvers import multigrid

    # interior_split is taken and not used, as the JAX package's V-cycle
    # does (its sweeps are single steps).
    kw = dict(grid=grid, quantize=quantize, backend=backend, storage=storage,
              boundary=boundary, fuse=fuse, tile=tile, fallback=fallback,
              overlap=overlap, mg_levels=mg_levels, col_mode=col_mode,
              device=device)
    if stream:
        return multigrid.mg_converge_stream(x, filt, tol, max_iters, **kw)
    return multigrid.mg_converge(x, filt, tol, max_iters, **kw)


def _converge_setup(x, filt: Filter, check_every, grid, quantize, backend,
                    storage, boundary, fuse, tile, interior_split, fallback,
                    overlap, solver, col_mode, device):
    """The checks, the default grid, the prepared blocks and the resolved
    knobs of one Jacobi convergence run (both entry points)."""
    check_solver(solver)
    if int(check_every) < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    grid, blocks, valid_hw, block_hw = _setup_run(
        x, grid, device, backend, storage, boundary, quantize)
    backend, fuse, tile, source = _resolve_auto(
        grid, filt, backend, fuse, tile, storage, quantize, boundary,
        valid_hw, first_block(blocks).shape[0], check_every=int(check_every))
    overlap = _auto_overlap(overlap, source)
    check_backend(backend)
    backend, col_mode, overlap = _run_knobs(
        grid, filt, backend, int(fuse), tile, storage, quantize, boundary,
        block_hw, interior_split, fallback, overlap, col_mode)
    _check_quantize_contract(blocks, filt, quantize, grid)
    _check_block_size(filt, block_hw)
    tile = None if tile is None else tuple(int(v) for v in tile)
    return (grid, blocks, valid_hw, block_hw, backend, int(fuse), tile,
            col_mode, overlap)


def _converge_chunks(grid: Grid, filt: Filter, state, tol: float,
                     max_iters: int, check_every: int, quantize: bool,
                     valid_hw, block_hw, backend: str, boundary: str,
                     fuse: int, tile, counter, interior_split: bool = False,
                     col_mode: str = "packed", overlap: bool = False):
    """The host loop: ``(carry, iters_done, diff)`` after every chunk,
    until ``diff < tol`` or ``max_iters`` (a NaN diff stops it too).  The
    diff's ``.item()`` is the chunk's one readback and fence; it counts on
    ``counter.readbacks``."""
    chunks = {}
    done, diff = 0, float("inf")
    while done < max_iters and diff >= tol:
        n = min(check_every, max_iters - done)
        if n not in chunks:
            fault_point("backend_compile")  # a chunk size's first build
            chunks[n] = _build_converge_chunk(
                grid, filt, n, quantize, tuple(valid_hw), block_hw, backend,
                boundary, fuse, tile, interior_split, col_mode, overlap)
        state, d = chunks[n](state)
        diff = d.item()
        counter.readbacks += 1
        done += n
        yield state, done, diff


def sharded_converge(x, filt: Filter, tol: float, max_iters: int,
                     check_every: int = 1, grid: Grid | None = None,
                     quantize: bool = False, backend: str = "shifted",
                     storage: str = "f32", boundary: str = "zero",
                     fuse: int | None = 1, tile=None,
                     interior_split: bool = False, fallback: bool = False,
                     overlap: bool | None = None, solver: str = "jacobi",
                     mg_levels: int | None = None,
                     col_mode: str | None = None,
                     device=None) -> tuple[torch.Tensor, int]:
    """Run-to-convergence (BASELINE config 5).  Returns ``(result,
    iters_run)``: the global (C, H, W) f32 field on the grid's device.

    Every ``check_every`` iterations the max-abs change of one iteration
    is read back, and the run stops when it falls below ``tol`` or
    ``max_iters`` iterations have run.  ``fuse`` / ``tile`` are the
    iteration knobs of :func:`sharded_iterate`: a chunk fuses at most its
    ``check_every - 1`` pre-pair iterations, so the whole run clamps the
    fuse to that.  ``grid`` defaults to 1×1 on ``device`` (default: the
    card; it raises without CUDA); on a grid of slots the diff is the max
    over the slots, still one readback a chunk.  ``fallback=True`` probes
    the backend first, as :func:`iterate_prepared` does; ``overlap`` and
    ``col_mode`` as there.

    ``solver='multigrid'`` runs the geometric V-cycle instead
    (``solvers.multigrid.mg_converge``, its level count capped by
    ``mg_levels``): the returned count is then V-cycles, ``max_iters``
    bounds fine-grid work units and ``check_every`` is ignored (the cycle
    is the check cadence); the stopping measure is the same, the max-abs
    change of one fine-grid sweep, and its readbacks count on
    ``multigrid.mg_converge.readbacks``.  ``mg_levels`` is ignored by
    Jacobi, as in the JAX package.
    ``sharded_converge.readbacks`` counts the readbacks (one per chunk);
    :func:`sharded_converge_stream` yields each chunk's diff.
    """
    if solver == "multigrid":
        out, res = _multigrid(x, filt, tol, max_iters, grid, quantize,
                              backend, storage, boundary, fuse, tile,
                              interior_split, fallback, overlap, mg_levels,
                              col_mode, device, stream=False)
        return out, res.cycles
    (grid, blocks, valid_hw, block_hw, backend, fuse, tile, col_mode,
     overlap) = _converge_setup(
        x, filt, check_every, grid, quantize, backend, storage, boundary,
        fuse, tile, interior_split, fallback, overlap, solver, col_mode,
        device)
    check_every, max_iters = int(check_every), int(max_iters)
    # A chunk fuses at most the n-1 pre-pair iterations (the final one is
    # always a single step so the (prev, cur) diff exists), so clamp to
    # check_every - 1: fuse == check_every would otherwise run every
    # iteration unfused.  The run-level check gives the JAX package's text.
    requested_fuse = fuse
    fuse = max(1, min(fuse, check_every - 1))
    _check_fuse_fits(filt, block_hw, fuse,
                     f" (fuse={requested_fuse} clamped to {fuse}: a "
                     f"check_every={check_every} chunk fuses at most its "
                     "n-1 pre-pair iterations)"
                     if fuse != requested_fuse else "")
    # The carry is made once for the run; the input blocks are not kept
    # past the first chunk.
    channels = first_block(blocks).shape[0]
    state = _carry_in(blocks, grid, backend, boundary, filt.radius * fuse,
                      col_mode)
    del blocks
    done = 0
    t0 = time.perf_counter()
    # The run ends in a readback (each chunk's diff), so it gets a real
    # device span: the root of a fresh trace for a bare call, a child of
    # the caller's span when one is active.  record_step then hangs the
    # model-attributed exchange / compute children off it.
    with obs_trace.span("device", source="sharded_converge",
                        backend=backend) as dsp:
        for state, done, _ in _converge_chunks(
                grid, filt, state, tol, max_iters, check_every, quantize,
                valid_hw, block_hw, backend, boundary, fuse, tile,
                sharded_converge, interior_split, col_mode, overlap):
            pass
        dsp.set(iters=done)
    if obs_metrics.enabled():
        with obs_trace.attach(dsp.context):
            _record_step_obs(backend, grid, filt, block_hw, fuse, done,
                             channels, storage, boundary,
                             time.perf_counter() - t0, valid_hw, quantize,
                             tile, source="sharded_converge",
                             overlap=overlap, col_mode=col_mode)
    return _global_f32(_carry_out(state, grid, backend, close=True), grid,
                       valid_hw), done


sharded_converge.readbacks = 0


def sharded_converge_stream(x, filt: Filter, tol: float, max_iters: int,
                            check_every: int = 1, grid: Grid | None = None,
                            quantize: bool = False, backend: str = "shifted",
                            storage: str = "f32", boundary: str = "zero",
                            fuse: int | None = 1, tile=None,
                            interior_split: bool = False,
                            fallback: bool = False,
                            overlap: bool | None = None,
                            solver: str = "jacobi",
                            mg_levels: int | None = None,
                            col_mode: str | None = None, device=None):
    """Progressive run-to-convergence: a generator over the chunks.

    Yields ``(image, iters_done, diff)`` after every ``check_every``-sized
    chunk: ``image`` is the (C, H, W) float32 field at the valid extent (a
    host numpy copy, safe to keep), ``diff`` the max-abs single-iteration
    change the stop is decided on.  The stream ends when ``diff < tol`` or
    ``iters_done >= max_iters``; its LAST image is byte-equal to
    :func:`sharded_converge` with the same arguments (the same chunks).
    ``sharded_converge_stream.readbacks`` counts the diff readbacks, one
    per chunk.

    ``solver='multigrid'`` yields one snapshot per V-cycle instead
    (``iters_done`` counts cycles, ``max_iters`` bounds fine-grid work
    units); ``solvers.multigrid.mg_converge_stream``, which this delegates
    to, also yields the work units.
    """
    if solver == "multigrid":
        for out, cycles, residual, _ in _multigrid(
                x, filt, tol, max_iters, grid, quantize, backend, storage,
                boundary, fuse, tile, interior_split, fallback, overlap,
                mg_levels, col_mode, device, stream=True):
            yield out, cycles, residual
        return
    (grid, blocks, valid_hw, block_hw, backend, fuse, tile, col_mode,
     overlap) = _converge_setup(
        x, filt, check_every, grid, quantize, backend, storage, boundary,
        fuse, tile, interior_split, fallback, overlap, solver, col_mode,
        device)
    state = _carry_in(blocks, grid, backend, boundary,
                      filt.radius * max(1, min(fuse, int(check_every) - 1)),
                      col_mode)
    del blocks
    try:
        for state, done, diff in _converge_chunks(
                grid, filt, state, tol, int(max_iters), int(check_every),
                quantize, valid_hw, block_hw, backend, boundary, fuse, tile,
                sharded_converge_stream, interior_split, col_mode, overlap):
            yield (_global_f32(_carry_out(state, grid, backend), grid,
                               valid_hw).cpu().numpy(), done, diff)
    finally:
        rdma.close_carry(state)


sharded_converge_stream.readbacks = 0
