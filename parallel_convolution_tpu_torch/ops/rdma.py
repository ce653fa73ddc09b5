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
    # its base.  Built on the card, so no host copy waits on it.
    stride = C * h * w * x.element_size()
    ptrs = torch.arange(nb, dtype=torch.int64, device=dev).mul_(stride).add_(
        x.data_ptr())
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
                stencil.DTYPE_CODES[out_dtype], nb, Cg, C, h, w, ext,
                levels, stencil._fptr(taps), filt.size, epi, int(mask), vh,
                vw, th, tw, stencil.FUSED_THREADS,
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
    extended by ``ext`` ghost rows and columns on every side (f32, for the
    K2 launches of later level groups)."""
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
              out_dtype=out_dtype if rest == 0 else torch.float32,
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
        out = torch.stack([
            stencil.fused_iterate(e, ((b // Cg) * h, (b % Cg) * w), filt,
                                  rest, vhw, quantize=quantize,
                                  out_dtype=out_dtype, tile=tile)
            for b, e in enumerate(out)])
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
    not fit in shared memory; the groups chain through f32, so the result
    does not depend on the grouping.
    """
    return unstack_blocks(fused_rdma_stacked(
        stack_blocks(blocks, grid_shape), filt, grid_shape, boundary,
        quantize, out_dtype, fuse, valid_hw, tile), grid_shape)
