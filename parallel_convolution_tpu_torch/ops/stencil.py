"""The port's two stencil kernels, their plain PyTorch versions and their
launch counters.

* :func:`stencil_step` (K1, ``csrc/stencil.cu:stencil_step_kernel``) replaces
  the JAX package's Pallas kernel ``ops/pallas_stencil.py:_stencil_kernel``
  (``correlate_padded_pallas``): one step on an already-padded block.
* :func:`fused_iterate` (K2, ``csrc/stencil.cu:fused_iterate_kernel``)
  replaces ``ops/pallas_stencil.py:_fused_kernel`` (``fused_iterate_pallas``):
  T levels on a deep-padded block in one launch.

Each wrapper takes its plain version (:func:`stencil_step_plain`,
:func:`fused_iterate_plain`) only because the tensor it was given lies on
the CPU.  On a CUDA tensor it launches the kernel or raises; there is no
fallback.  Each launch adds one to the wrapper's ``launches`` counter.

Precision: the kernels contract every tap into one FMA (``__fmaf_rn``); the
plain versions round the product and the sum separately, as NumPy does.
In quantize mode with the registry's filters every product and partial sum
is an exact float32, so the two agree byte for byte; in float mode they
differ by float32 rounding (:func:`float_tolerance`).  K2's level loop
rounds with the two-add magic number where :func:`round_mode` admits it,
``rintf`` elsewhere: the same values.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from parallel_convolution_tpu_torch.ops import conv
from parallel_convolution_tpu_torch.ops.filters import Filter

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
MAX_K = 9                      # csrc/stencil_common.cuh kMaxK
STEP_TILE = (32, 128)          # K1 output tile (rows, cols)
FUSED_TILE = (64, 128)         # K2 / K4 output tile (rows, cols)
FUSED_THREADS = 512            # K2 / K3 / K4 threads per block (16 warps)
# The deepest ghost ring r·g one K2 / K4 launch computes (max_group_levels).
MAX_GROUP_DEPTH = 16
# Shared memory one block may opt into on the H100 (227 KB): the planners'
# default; a launch plans with the card's own figure (_smem_limit).
H100_SMEM_OPTIN = 232448


def _sep_taps(filt: Filter, separable: bool):
    """(col_taps, row_taps) float32 arrays, or None when not requested or
    the filter has no exact rank-1 factorization (then the 2D order runs)."""
    if not separable:
        return None
    return filt.separable()


def step_smem_bytes(k: int, tile, sep: bool) -> int:
    """K1's dynamic shared memory: the haloed window, plus the row-pass
    buffer when separable."""
    th, tw = tile
    r = k // 2
    return 4 * (th + 2 * r) * ((tw + 2 * r) + (tw if sep else 0))


def fused_smem_bytes(r: int, levels: int, tile) -> int:
    """K2's (and K3's / K4's) dynamic shared memory: one f32 buffer of the
    level-0 window, the levels computed in place
    (``csrc/stencil_common.cuh:window_bytes``)."""
    th, tw = tile
    return 4 * (th + 2 * r * levels) * (tw + 2 * r * levels)


# The two-add magic round (acc + 1.5·2^23) − 1.5·2^23 is exact for
# |acc| < 2^22; a quantize-mode accumulator is bounded by 255·L1(taps), and
# the JAX package (ops/pallas_stencil.py:_round_mode_for) keeps a 2× margin.
MAGIC_ROUND_BOUND = 2.0 ** 21


def round_mode(taps) -> str:
    """``"magic"`` where the level loop may round with the two-add magic
    number, else ``"rint"``: the JAX package's rule, magic iff
    255·L1(taps) < 2^21, summed in the same order.  A static choice by the
    filter that selects a template instance of the kernels."""
    l1 = sum(abs(float(t)) for t in np.asarray(taps, np.float32).ravel())
    return "magic" if 255.0 * l1 < MAGIC_ROUND_BOUND else "rint"


def rim_tax(r: int, levels: int, tile) -> float:
    """Rim recompute factor of one K2 launch: level-0 window area over the
    output tile area, (th+2rT)(tw+2rT)/(th·tw)."""
    th, tw = tile
    return (th + 2 * r * levels) * (tw + 2 * r * levels) / (th * tw)


def fused_plan(r: int, T: int, hw, tile=None,
               smem_limit: int = H100_SMEM_OPTIN):
    """Tile and level groups for T fused levels of radius ``r`` on an
    ``hw = (h, w)`` output block.

    Returns ``(th, tw, groups)``: the output tile (the requested one, or
    :data:`FUSED_TILE`, clamped to the block) and the level counts of the
    launches, which sum to T.  A launch runs g levels when its level-0
    window fits in ``smem_limit`` and its ghost depth r·g is within
    :func:`max_group_levels`; the levels are split
    into the fewest near-equal groups that satisfy both, each group's
    result passing to the next through device memory (exact: every level
    masks against the global image).  Raises ``ValueError`` when not even
    one level fits.
    """
    h, w = hw
    th, tw = tile if tile is not None else FUSED_TILE
    th, tw = max(1, min(int(th), h)), max(1, min(int(tw), w))
    if fused_smem_bytes(r, 1, (th, tw)) > smem_limit:
        raise ValueError(
            f"fused tile {(th, tw)} at radius {r} needs "
            f"{fused_smem_bytes(r, 1, (th, tw))} B of shared memory for one "
            f"level, above the card's {smem_limit} B: pass a smaller --tile")
    g_max = min(T, max_group_levels(r, (th, tw)))
    while fused_smem_bytes(r, g_max, (th, tw)) > smem_limit:
        g_max -= 1
    n = math.ceil(T / g_max)
    base, extra = divmod(T, n)
    groups = [base + (1 if i < extra else 0) for i in range(n)]
    return th, tw, groups


def epilogue_code(filt: Filter, quantize: bool) -> int:
    """The level loop's store-back instance (``csrc/stencil_common.cuh``
    ``Epi``), the ``epi`` argument of K2, K3, K4 and 5c's r3: 0 float mode;
    1 / 2 the magic round without / with the clip; 3 / 4 ``rintf`` without
    / with it (the clip only for non-convex filters)."""
    if not quantize:
        return 0
    return ((1 if round_mode(filt.taps) == "magic" else 3)
            + (0 if filt.convex else 1))


def max_group_levels(r: int, tile) -> int:
    """The most levels one K2 / K4 launch takes on a ``tile``: a ghost
    depth r·g of at most :data:`MAX_GROUP_DEPTH` and at most a quarter of
    the tile's shorter side.  Deeper, the rim recompute (:func:`rim_tax`)
    costs more than the f32 round trip through device memory that one more
    launch pays: on the H100 at 64×64, 64×128 and 96×96 tiles, blur3's 32
    levels ran fastest in groups of 16 and edge5's in groups of 8
    (``probes/loop_sweep.py``; PERF.md)."""
    if r == 0:
        return 1 << 30
    return max(1, min(MAX_GROUP_DEPTH, min(tile) // 4) // r)


def float_tolerance(filt: Filter, levels: int, out_dtype) -> tuple[float, float]:
    """(rtol, atol) between a kernel and its plain version in float mode.

    FMA against multiply-then-add changes one rounding per tap: at most
    half an ulp of a product, |product| <= 255·|tap| for u8-range data, so
    about 2^-24·255·L1(taps) per level, compounding through ``levels``
    levels (bounded for convex filters, L1 <= 1), and the partial sums
    round in both forms.  Stated as
    atol = 2 · levels · k² · 2^-23 · 255 · max(1, L1)^levels.  A bf16 output
    adds one bf16 rounding step (rtol 2^-8) when the two f32 results fall
    on either side of a bf16 rounding boundary.
    """
    l1 = float(np.abs(filt.taps).sum())
    atol = (2 * levels * filt.size ** 2 * 2.0 ** -23 * 255.0
            * max(1.0, l1) ** levels)
    rtol = 2.0 ** -8 if out_dtype == torch.bfloat16 else 0.0
    return rtol, atol


def _quantize(acc: torch.Tensor, convex: bool) -> torch.Tensor:
    """The kernels' u8 store-back in f32: round half to even, then clip
    unless the filter is convex (the clip is the identity there)."""
    acc = torch.round(acc)
    return acc if convex else torch.clamp(acc, 0.0, 255.0)


def _correlate(padded: torch.Tensor, filt: Filter, separable: bool):
    if _sep_taps(filt, separable) is not None:
        return conv.correlate_padded_separable(padded, filt)
    return conv.correlate_padded(padded, filt)


def _check_common(x: torch.Tensor, filt: Filter, quantize: bool, out_dtype):
    if x.dim() != 3:
        raise ValueError(f"expected a (C, H, W) block, got shape {tuple(x.shape)}")
    for dt in (x.dtype, out_dtype):
        if dt not in DTYPE_CODES:
            raise ValueError(f"dtype {dt} not supported; use one of "
                             f"{list(DTYPE_CODES)}")
    if out_dtype == torch.uint8 and not quantize:
        raise ValueError("a uint8 output needs quantize=True")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensor on {x.device}: expected cpu or cuda")


def _host_taps(filt: Filter, sep):
    taps = np.ascontiguousarray(filt.taps.reshape(-1), dtype=np.float32)
    col, row = (np.ascontiguousarray(a, dtype=np.float32) for a in
                (sep if sep is not None else (taps[:1], taps[:1])))
    return taps, col, row


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _check_cuda(x: torch.Tensor, filt: Filter) -> None:
    if not x.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous tensors")
    if filt.size > MAX_K:
        raise ValueError(
            f"filter size {filt.size} above the kernels' limit {MAX_K}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def _smem_limit(device: torch.device) -> int:
    """The card's opt-in shared memory per block: torch's
    ``shared_memory_per_block_optin``, else the CUDA runtime's
    ``cudaDevAttrMaxSharedMemoryPerBlockOptin`` (read through
    ``csrc/probes.cu``).  Raises when neither answers: a guessed limit
    could plan a launch the card refuses."""
    props = torch.cuda.get_device_properties(device)
    value = getattr(props, "shared_memory_per_block_optin", None)
    if value:
        return int(value)
    from parallel_convolution_tpu_torch.ops import _build

    out = ctypes.c_int(0)
    err = _build.load_library("probes").pc_smem_optin(
        torch.device(device).index or 0, ctypes.byref(out))
    if err != 0 or out.value <= 0:
        raise RuntimeError(
            f"cannot read the opt-in shared memory per block of {device}: "
            "torch has no shared_memory_per_block_optin and "
            f"cudaDeviceGetAttribute returned error {err}")
    return int(out.value)


# ---------------------------------------------------------------------------
# K1: one step
# ---------------------------------------------------------------------------


def stencil_step_plain(padded: torch.Tensor, filt: Filter,
                       quantize: bool = False, out_dtype=None,
                       separable: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1: (C, H+2r, W+2r) → (C, H, W)."""
    if out_dtype is None:
        out_dtype = padded.dtype if quantize else torch.float32
    acc = _correlate(padded, filt, separable)
    if quantize:
        acc = _quantize(acc, filt.convex)
    return acc.to(out_dtype)


def stencil_step(padded: torch.Tensor, filt: Filter, *, quantize: bool = False,
                 out_dtype=None, separable: bool = False,
                 tile=None) -> torch.Tensor:
    """One stencil step of an already-padded (C, H+2r, W+2r) block.

    The port of ``correlate_padded_pallas``: f32/bf16/u8 in, f32/bf16/u8
    out (default: the input dtype when quantizing, else f32), the
    optional fused u8 store-back (``quantize``), the rank-1 tap order when
    ``separable`` and the filter factors exactly.  ``tile`` = (rows, cols)
    of K1's output tile (default :data:`STEP_TILE`); any tile gives the
    same bytes.
    """
    if out_dtype is None:
        out_dtype = padded.dtype if quantize else torch.float32
    _check_common(padded, filt, quantize, out_dtype)
    if padded.device.type == "cpu":
        return stencil_step_plain(padded, filt, quantize, out_dtype, separable)
    _check_cuda(padded, filt)
    r = filt.radius
    C, Hp, Wp = padded.shape
    H, W = Hp - 2 * r, Wp - 2 * r
    out = torch.empty((C, H, W), dtype=out_dtype, device=padded.device)
    if out.numel() == 0:
        return out
    sep = _sep_taps(filt, separable)
    th, tw = tile if tile is not None else STEP_TILE
    th, tw = max(1, min(int(th), H)), max(1, min(int(tw), W))
    limit = _smem_limit(padded.device)
    if step_smem_bytes(filt.size, (th, tw), sep is not None) > limit:
        raise ValueError(f"K1 tile {(th, tw)} needs more than {limit} B of "
                         "shared memory; pass a smaller tile")
    taps, col, row = _host_taps(filt, sep)
    from parallel_convolution_tpu_torch.ops import _build

    lib = _build.load_library("stencil")
    with torch.cuda.device(padded.device):
        stream = torch.cuda.current_stream(padded.device).cuda_stream
        err = lib.pc_stencil_step(
            padded.data_ptr(), DTYPE_CODES[padded.dtype], out.data_ptr(),
            DTYPE_CODES[out_dtype], C, Hp, Wp, H, W, _fptr(taps), _fptr(col),
            _fptr(row), filt.size, int(sep is not None), int(quantize),
            int(filt.convex), th, tw, stream)
    _raise_on(err, "stencil_step (K1)")
    stencil_step.launches += 1
    return out


stencil_step.launches = 0


# ---------------------------------------------------------------------------
# K2: T fused levels
# ---------------------------------------------------------------------------


def fused_iterate_plain(padded: torch.Tensor, offsets, filt: Filter, T: int,
                        valid_hw, quantize: bool = True, out_dtype=None,
                        separable: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K2 (the JAX package's ``_fused_kernel`` +
    ``_iterate_levels``): T levels of a deep-padded (C, h+2rT, w+2rT)
    block → (C, h, w).

    ``offsets`` = the block's global (row0, col0); ``valid_hw`` = the
    global image extent whose outside is the zero ghost ring, or None
    (periodic: no masking).  Level 0 is selected to exactly 0 outside the
    image; every level is then multiplied by a 0/1 row mask and a 0/1
    column mask, in that order.
    """
    if out_dtype is None:
        out_dtype = padded.dtype
    r = filt.radius
    C, Hp, Wp = padded.shape
    h, w = Hp - 2 * r * T, Wp - 2 * r * T
    dev = padded.device
    cur = padded.to(torch.float32)
    rows0 = cols0 = None
    if valid_hw is not None:
        H, W = valid_hw
        rows0 = int(offsets[0]) - r * T + torch.arange(Hp, device=dev)
        cols0 = int(offsets[1]) - r * T + torch.arange(Wp, device=dev)
        ok0 = (((rows0 >= 0) & (rows0 < H))[:, None]
               & ((cols0 >= 0) & (cols0 < W))[None, :])
        cur = torch.where(ok0, cur, torch.zeros((), device=dev))
    for s in range(1, T + 1):
        ch, cw = h + 2 * r * (T - s), w + 2 * r * (T - s)
        acc = _correlate(cur, filt, separable)
        if quantize:
            acc = _quantize(acc, filt.convex)
        if rows0 is not None:
            rows = rows0[r * s:r * s + ch]
            cols = cols0[r * s:r * s + cw]
            acc = acc * ((rows >= 0) & (rows < H)).to(torch.float32)[:, None]
            acc = acc * ((cols >= 0) & (cols < W)).to(torch.float32)[None, :]
        cur = acc
    return cur.to(out_dtype)


def fused_iterate(padded: torch.Tensor, offsets, filt: Filter, T: int,
                  valid_hw, *, quantize: bool = True, out_dtype=None,
                  separable: bool = False, tile=None) -> torch.Tensor:
    """T stencil iterations of a deep-padded (C, h+2rT, w+2rT) block.

    The port of ``fused_iterate_pallas``: ``offsets`` is the block's
    global (row0, col0), ``valid_hw`` the global image extent for the
    per-level ghost-ring masks (None = periodic, no masks).  On the card
    the levels run in as few K2 launches as shared memory allows
    (:func:`fused_plan`); intermediates between launches stay float32, so
    the result does not depend on the grouping.
    """
    if out_dtype is None:
        out_dtype = padded.dtype
    _check_common(padded, filt, quantize, out_dtype)
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if padded.device.type == "cpu":
        return fused_iterate_plain(padded, offsets, filt, T, valid_hw,
                                   quantize, out_dtype, separable)
    _check_cuda(padded, filt)
    r = filt.radius
    C, Hp, Wp = padded.shape
    h, w = Hp - 2 * r * T, Wp - 2 * r * T
    if h <= 0 or w <= 0:
        raise ValueError(f"block {(Hp, Wp)} too small for {T} levels of "
                         f"radius {r}")
    th, tw, groups = fused_plan(r, T, (h, w), tile,
                                _smem_limit(padded.device))
    cur, left = padded, T
    off_r, off_c = int(offsets[0]), int(offsets[1])
    for g in groups:
        left -= g
        # This launch's output: the block extended by the r*left ghost
        # levels still to run; float32 until the last launch.
        oh, ow = h + 2 * r * left, w + 2 * r * left
        out = torch.empty((C, oh, ow), device=padded.device,
                          dtype=out_dtype if left == 0 else torch.float32)
        _fused_call(cur, out, (off_r - r * left, off_c - r * left), filt, g,
                    valid_hw, quantize, separable, (min(th, oh), min(tw, ow)))
        fused_iterate.launches += 1
        cur = out
    return cur


def _fused_call(x, out, offsets, filt: Filter, T: int, valid_hw,
                quantize: bool, separable: bool, tile,
                occupancy: bool = False) -> int:
    """One K2 launch of T levels from ``x`` into ``out`` (both on the card),
    or with ``occupancy`` no launch: the number of such blocks one SM
    holds (the CUDA occupancy calculator on the same instance)."""
    sep = _sep_taps(filt, separable)
    taps, col, row = _host_taps(filt, sep)
    mask = valid_hw is not None
    vh, vw = (int(valid_hw[0]), int(valid_hw[1])) if mask else (0, 0)
    C, Hp, Wp = x.shape
    blocks = ctypes.c_int(0)
    from parallel_convolution_tpu_torch.ops import _build

    lib = _build.load_library("stencil")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pc_fused_iterate(
            x.data_ptr(), DTYPE_CODES[x.dtype], out.data_ptr(),
            DTYPE_CODES[out.dtype], C, Hp, Wp, out.shape[1], out.shape[2], T,
            _fptr(taps), _fptr(col), _fptr(row), filt.size,
            int(sep is not None), epilogue_code(filt, quantize),
            int(offsets[0]), int(offsets[1]), int(mask), vh, vw, tile[0],
            tile[1], FUSED_THREADS,
            ctypes.byref(blocks) if occupancy else None, stream)
    _raise_on(err, "fused_iterate (K2)")
    return blocks.value


def fused_blocks_per_sm(x: torch.Tensor, filt: Filter, T: int, valid_hw,
                        *, quantize: bool = True, separable: bool = False,
                        tile=None) -> int:
    """Blocks of the first K2 launch :func:`fused_iterate` would make on
    the deep-padded ``x`` that one SM of the card holds, from the CUDA
    occupancy calculator: shared memory, registers and threads together."""
    r = filt.radius
    C, Hp, Wp = x.shape
    h, w = Hp - 2 * r * T, Wp - 2 * r * T
    th, tw, groups = fused_plan(r, T, (h, w), tile, _smem_limit(x.device))
    left = T - groups[0]
    oh, ow = h + 2 * r * left, w + 2 * r * left
    return _fused_call(x, x, (0, 0), filt, groups[0], valid_hw, quantize,
                       separable, (min(th, oh), min(tw, ow)), occupancy=True)


fused_iterate.launches = 0


def reset_launch_counts() -> None:
    """Zero the launch counters of every kernel of the port (K1, K2 here;
    K3, K4 in ops/rdma.py)."""
    from parallel_convolution_tpu_torch.ops import rdma

    stencil_step.launches = 0
    fused_iterate.launches = 0
    rdma.rdma_block.launches = 0
    rdma.rdma_tiled.launches = 0


def launch_counts() -> dict:
    """Launches of every kernel of the port since the last reset."""
    from parallel_convolution_tpu_torch.ops import rdma

    return {"stencil_step": stencil_step.launches,
            "fused_iterate": fused_iterate.launches,
            "rdma_block": rdma.rdma_block.launches,
            "rdma_tiled": rdma.rdma_tiled.launches}
