"""5c, the construct ladder: ``rdma_ladder``
(``csrc/probes.cu:rdma_ladder_kernel``) replaces the TPU probe
``scripts/tiled_repro_probe.py:101-218`` (seven Pallas rungs, each adding
one construct of the tiled RDMA kernel, to find the one that killed the
compile helper).

On the card every rung builds (the question that ladder asked has no
counterpart), so the ladder asks the question PERF.md leaves open: where
K4's time goes.  One kernel, templated on the rung, adds one construct of
K4 (``csrc/rdma.cu``) per rung, over K4's own 64×64 output tiles of the
stacked grid:

* ``r0_tile_copy`` — a tile of the block into shared memory and back,
  addressed from the stacked grid's base pointer (the TPU's a0: operands
  through fast memory and back);
* ``r1_pointer_table`` — + the block's address from the pointer table,
  base + b·stride (a–c: blocks addressed in device memory);
* ``r2_ghost_gather`` — + the r·T-deep ghost window gathered from the
  neighbours through the neighbour table of ``parallel/channels.py`` (−1
  reads zeros), written whole: a halo exchange, whose plain version is
  ``halo.halo_exchange`` at depth r·T (d–e: windows out of the padded
  grid);
* ``r3_levels`` — + the T levels on that window: K4 itself, whose plain
  version is ``rdma.fused_rdma_step_plain`` (f: the full kernel).

What bounds it: r0–r2 are copies, bound by bytes; r3 by operations, as
K4.  Each row: built, the registers, spills and static shared memory that
ptxas reported for the rung's symbol, correct against the rung's plain
version (r3 also byte-equal to K4), and its time at the main path's RGB
2×2 bf16 T = 32 shape.

    python -m parallel_convolution_tpu_torch.probes.rdma_ladder
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from parallel_convolution_tpu_torch.ops import rdma, stencil
from parallel_convolution_tpu_torch.ops.filters import Filter
from parallel_convolution_tpu_torch.parallel import channels, halo

RUNGS = ("r0_tile_copy", "r1_pointer_table", "r2_ghost_gather", "r3_levels")
# The TPU ladder's rungs each card rung takes the place of, in order.
TPU_RUNGS = {
    "r0_tile_copy": ("a0_any_operands_only",),
    "r1_pointer_table": ("a_unused_hbm_scratch", "b_hbm_roundtrip",
                         "c_hbm_internal_copy"),
    "r2_ghost_gather": ("d_windowed_from_hbm", "e_when_step0"),
    "r3_levels": ("f_collective_params",),
}
# The main path's shape the rungs are timed at: RGB 1920x2520 blur3, bf16
# carries, a 2x2 grid, one 32-level chunk (K4's row in PERF.md).
SHAPE_HW, GRID, FILTER, STORAGE, T_LEVELS = (1920, 2520), (2, 2), "blur3", \
    "bf16", 32


def _rung_index(rung) -> int:
    i = RUNGS.index(rung) if isinstance(rung, str) else int(rung)
    if not 0 <= i < len(RUNGS):
        raise ValueError(f"rung must be one of {RUNGS}, got {rung!r}")
    return i


def rdma_ladder_plain(x: torch.Tensor, filt: Filter, grid_shape,
                      boundary: str, T: int, rung, valid_hw=None, *,
                      quantize: bool = True, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of a rung on the stacked grid ``x``: r0 / r1
    the grid itself, r2 the halo exchange at depth r·T, r3 T levels
    (``rdma.fused_rdma_step_plain``)."""
    i = _rung_index(rung)
    if i < 2:
        return x.clone()
    blocks = rdma.unstack_blocks(x, grid_shape)
    if i == 2:
        return rdma.stack_blocks(halo.halo_exchange(
            blocks, filt.radius * T, grid_shape, boundary), grid_shape)
    return rdma.stack_blocks(rdma.fused_rdma_step_plain(
        blocks, filt, grid_shape, boundary, quantize, out_dtype, T,
        valid_hw), grid_shape)


def rdma_ladder(x: torch.Tensor, filt: Filter, grid_shape, boundary: str,
                T: int, rung, valid_hw=None, *, quantize: bool = True,
                out_dtype=None, tile=None) -> torch.Tensor:
    """One launch of ``rung`` over the stacked grid ``x``
    (``rdma.stack_blocks``) in ``tile`` (default K4's) output tiles; the
    plain version on a CPU tensor.  r2 gathers without masks, as the halo
    exchange; r3 masks against ``valid_hw`` under a zero boundary, as
    K4."""
    i = _rung_index(rung)
    rdma._check_stacked(x, grid_shape)
    if out_dtype is None or i < 3:
        out_dtype = x.dtype
    stencil._check_common(x[0], filt, quantize, out_dtype)
    if x.device.type == "cpu":
        return rdma_ladder_plain(x, filt, grid_shape, boundary, T, i,
                                 valid_hw, quantize=quantize,
                                 out_dtype=out_dtype)
    stencil._check_cuda(x, filt)
    R, Cg = grid_shape
    nb, C, h, w = x.shape
    r = filt.radius
    rdma._check_depth(r, T, (h, w))
    th, tw = tile if tile is not None else stencil.FUSED_TILE
    th, tw = max(1, min(int(th), h)), max(1, min(int(tw), w))
    d = r * T
    window = (th + 2 * d) * (tw + 2 * d) * 4
    smem = (4 * th * tw, 4 * th * tw, window, 2 * window)[i]
    limit = stencil._smem_limit(x.device)
    if smem > limit:
        raise ValueError(f"rdma_ladder {RUNGS[i]}: a {(th, tw)} tile at "
                         f"depth {d} needs {smem} B of shared memory, above "
                         f"the card's {limit} B")
    if nb * C > 65535:
        raise ValueError(f"rdma_ladder: {nb} blocks x {C} channels above the "
                         "launch grid's 65535")
    dev = x.device
    nbr = channels.device_table((R, Cg), boundary, dev)
    stride = C * h * w * x.element_size()
    ptrs = torch.arange(nb, dtype=torch.int64, device=dev).mul_(stride).add_(
        x.data_ptr())
    oh, ow = (h + 2 * d, w + 2 * d) if i == 2 else (h, w)
    out = torch.empty((nb, C, oh, ow), dtype=out_dtype, device=dev)
    mask = i == 3 and boundary == "zero" and valid_hw is not None
    vh, vw = (int(valid_hw[0]), int(valid_hw[1])) if mask else (0, 0)
    taps = np.ascontiguousarray(filt.taps.reshape(-1), dtype=np.float32)
    from parallel_convolution_tpu_torch.ops import _build

    lib = _build.load_library("probes")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pc_rdma_ladder(
            i, x.data_ptr(), ptrs.data_ptr(), nbr.data_ptr(),
            stencil.DTYPE_CODES[x.dtype], out.data_ptr(),
            stencil.DTYPE_CODES[out_dtype], nb, Cg, C, h, w, T,
            stencil._fptr(taps), filt.size, int(quantize), int(filt.convex),
            int(mask), vh, vw, th, tw, stream)
    stencil._raise_on(err, f"rdma_ladder {RUNGS[i]} (5c)")
    rdma_ladder.launches += 1
    return out


rdma_ladder.launches = 0


def ptxas_row(rung, k: int) -> dict:
    """ptxas's registers, spills and static shared memory for the rung's
    kernel symbol (r3 instantiated for the filter size ``k``), from the
    probes library's build report."""
    from parallel_convolution_tpu_torch.ops import _build

    i = _rung_index(rung)
    kt = (k if k in (3, 5) else 0) if i == 3 else 0
    tag = f"rdma_ladder_kernelILi{i}ELi{kt}E"
    for symbol, usage in _build.ptxas_usage("probes").items():
        if tag in symbol:
            return {"built": True, "symbol": symbol, **usage}
    return {"built": False}


def measure(device, reps: int = 10) -> list[dict]:
    """One row per rung at the main path's RGB 2x2 bf16 T = 32 shape."""
    from parallel_convolution_tpu_torch import convert
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.utils import imageio
    from parallel_convolution_tpu_torch.utils.bench import cuda_ms
    from parallel_convolution_tpu_torch.utils.platform import device_kind

    filt = get_filter(FILTER)
    img = imageio.generate_test_image(*SHAPE_HW, "rgb", seed=1)
    planar = imageio.interleaved_to_planar(img)
    blocks = convert.blocks_from_numpy(planar, mesh.make_grid(GRID, device),
                                       STORAGE)
    x = rdma.stack_blocks(blocks, GRID)
    valid = planar.shape[1:]
    args = (x, filt, GRID, "zero", T_LEVELS)
    k4 = rdma.rdma_tiled(x, filt, GRID, "zero", T_LEVELS, valid)
    rows = []
    for i, name in enumerate(RUNGS):
        got = rdma_ladder(*args, i, valid)
        want = rdma_ladder_plain(*args, i, valid)
        row = {"rung": name, **ptxas_row(i, filt.size),
               "correct": bool(torch.equal(got, want)),
               "max_abs_err": float((got.double() - want.double())
                                    .abs().max()),
               "ms": cuda_ms(lambda: rdma_ladder(*args, i, valid), reps),
               "plain_ms": cuda_ms(lambda: rdma_ladder_plain(*args, i, valid),
                                   1, warmup=0),
               "shape": [int(v) for v in x.shape], "T": T_LEVELS,
               "dtype": str(x.dtype), "device": device_kind(device)}
        if i == 3:
            row["equal_k4"] = bool(torch.equal(got, k4))
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print(json.dumps({"probe": "rdma_ladder", "error": "needs CUDA"}))
        return 1
    rows = measure(torch.device("cuda", 0))
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0 if all(r["correct"] for r in rows) and rows[-1]["equal_k4"] else 1


if __name__ == "__main__":
    sys.exit(main())
