"""The port's two stencil kernels, their plain PyTorch versions and their
launch counters.

* :func:`stencil_step` (K1, ``csrc/step.cu:stencil_step_kernel``) replaces
  the JAX package's Pallas kernel ``ops/pallas_stencil.py:_stencil_kernel``
  (``correlate_padded_pallas``): one step on an already-padded block, its
  launch geometry planned here (:func:`step_plan`).
* :func:`fused_iterate` (K2, ``csrc/stencil.cu:fused_iterate_kernel``)
  replaces ``ops/pallas_stencil.py:_fused_kernel`` (``fused_iterate_pallas``):
  T levels on a deep-padded block in one launch, or with
  ``interior_split`` the JAX package's 9-patch plan (:func:`split_patches`)
  of launches over the tile grid.

Each wrapper takes its plain version (:func:`stencil_step_plain`,
:func:`fused_iterate_plain`) only because the tensor it was given lies on
the CPU.  On a CUDA tensor it launches the kernel or raises; there is no
fallback.  Each launch adds one to the wrapper's ``launches`` counter.

Precision: the kernels contract every tap into one FMA (``__fmaf_rn``); the
plain versions round the product and the sum separately, as NumPy does.
In quantize mode with the registry's filters every product and partial sum
is an exact float32, so the two agree byte for byte; in float mode they
differ by float32 rounding (:func:`float_tolerance`).  Every kernel rounds
with the two-add magic number where :func:`round_mode` admits it, ``rintf``
elsewhere (:func:`epilogue_code`): the same values.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from parallel_convolution_tpu_torch.obs import events as obs_events
from parallel_convolution_tpu_torch.ops import conv
from parallel_convolution_tpu_torch.ops.filters import Filter

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
MAX_K = 9                      # csrc/stencil_common.cuh kMaxK
STEP_TILE = (16, 512)          # K1 output tile (rows, cols)
STEP_THREADS = 256             # K1 threads per block (8 warps)
STEP_STAGES = 2                # K1 input stages per block, at most (kMaxStages)
STRIP_V = 16                   # csrc/stencil_common.cuh kStripV (k <= 5)
FUSED_TILE = (64, 128)         # K2 / K4 output tile (rows, cols)
FUSED_THREADS = 512            # K2 / K3 / K4 threads per block (16 warps)
# The deepest ghost ring r·g one K2 / K4 launch computes (max_group_levels).
MAX_GROUP_DEPTH = 16
# Shared memory one block may opt into on the H100 (227 KB): the planners'
# default; a launch plans with the card's own figure (_smem_limit).
H100_SMEM_OPTIN = 232448
# Shared memory of one H100 SM (228 KB), of which each resident block
# takes 1 KB besides its own: K1 plans its stages to keep two blocks.
H100_SMEM_PER_SM = 233472
SMEM_BLOCK_RESERVE = 1024


def _sep_taps(filt: Filter, separable: bool):
    """(col_taps, row_taps) float32 arrays, or None when not requested or
    the filter has no exact rank-1 factorization (then the 2D order runs)."""
    if not separable:
        return None
    return filt.separable()


def strip_height(k: int, v: int = STRIP_V) -> int:
    """Outputs per register strip of a k-tap filter: ``v`` (the build's
    kStripV), or 8 for k = 7, 9 (``csrc/stencil_common.cuh:strip_v``)."""
    return v if k <= 5 else 8


def _row_pitch(width: int, row_bytes=None) -> int:
    """A shared-memory row pitch of K1: at least ``width`` + 30 bytes (so
    that the 16-byte-aligned supersets of two rows never overlap),
    congruent with the source's row pitch ``row_bytes`` mod 16; the
    largest residue, 15, when ``row_bytes`` is None."""
    base = -(-(width + 30) // 16) * 16
    return base + (15 if row_bytes is None else row_bytes % 16)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def step_smem_bytes(k: int, tile, in_size: int = 4, out_size: int = 4,
                    stages: int = 1) -> int:
    """K1's dynamic shared memory for a ``tile`` = (rows, cols) output tile:
    ``stages`` input stages, each the window of the tile's computed extent
    (rows rounded up to the strip height, cols to 32) at one row pitch,
    and the output tile at another (``csrc/step.cu``'s ``stage_bytes`` and
    ``out_bytes``).  The pitches depend on the input's and output's row
    pitches in bytes mod 16; this takes the largest residue, so that the
    result bounds every shape's :func:`step_plan` (what the tuner's
    legality checks)."""
    th, tw = tile
    rows = -(-th // strip_height(k)) * strip_height(k)
    cols = -(-tw // 32) * 32
    pitch = _row_pitch((cols + k - 1) * in_size)
    out_pitch = _row_pitch(cols * out_size)
    return (stages * _round16((rows + k - 1) * pitch + 16)
            + _round16(rows * out_pitch + 16))


class StepPlan(NamedTuple):
    """K1's launch geometry on one (C, Hp, Wp) input (:func:`step_plan`)."""

    shape: tuple          # (C, Hp, Wp) of the padded input
    k: int
    in_size: int          # bytes per input element
    out_size: int         # bytes per output element
    tile: tuple           # (th, tw) output tile; the last row / column ragged
    extent: tuple         # (rows, cols) computed: th up to the strip height,
                          # tw up to 32 (the extra outputs are not stored)
    pitch: int            # input row pitch in shared memory, bytes
    out_pitch: int        # output row pitch in shared memory, bytes
    stage_bytes: int      # one input stage
    out_bytes: int        # the output tile
    stages: int           # input stages in flight
    threads: int

    @property
    def out_hw(self) -> tuple:
        r = self.k // 2
        return self.shape[1] - 2 * r, self.shape[2] - 2 * r

    @property
    def tiles(self) -> tuple:
        """(C, tiles down, tiles across)."""
        (H, W), (th, tw) = self.out_hw, self.tile
        return self.shape[0], -(-H // th), -(-W // tw)

    @property
    def ntiles(self) -> int:
        C, ty, tx = self.tiles
        return C * ty * tx

    @property
    def smem(self) -> int:
        return self.stages * self.stage_bytes + self.out_bytes


def step_plan(k: int, shape, in_size: int, out_size: int, tile=None,
              smem_limit: int = H100_SMEM_OPTIN, stages: int = STEP_STAGES,
              threads: int = STEP_THREADS, strip: int = STRIP_V,
              sm_smem: int = H100_SMEM_PER_SM) -> StepPlan:
    """K1's geometry for a k-tap step on a padded (C, Hp, Wp) input.

    The output tile is the requested one, or :data:`STEP_TILE`, clamped to
    the output.  Each input row is copied into shared memory at its own
    byte shift mod 16 (the input pitch is congruent with the source's row
    pitch), each output row leaves from one congruent with its destination
    row.  The block keeps up to ``stages`` input stages: as many as leave
    two blocks room on an SM of ``sm_smem`` bytes (one block's copies in
    flight while the other computes; on the H100, blur3 and edge5 at
    16×512 ran fastest so, ``probes/loop_sweep.py step``), at least one;
    raises ``ValueError`` when one stage does not fit in ``smem_limit``.
    """
    C, Hp, Wp = (int(v) for v in shape)
    H, W = Hp - (k - 1), Wp - (k - 1)
    th, tw = tile if tile is not None else STEP_TILE
    th, tw = max(1, min(int(th), H)), max(1, min(int(tw), W))
    v = strip_height(k, strip)
    rows, cols = -(-th // v) * v, -(-tw // 32) * 32
    pitch = _row_pitch((cols + k - 1) * in_size, Wp * in_size)
    out_pitch = _row_pitch(cols * out_size, W * out_size)
    stage_bytes = _round16((rows + k - 1) * pitch + 16)
    out_bytes = _round16(rows * out_pitch + 16)
    n = stages
    while n > 1 and 2 * (n * stage_bytes + out_bytes
                         + SMEM_BLOCK_RESERVE) > sm_smem:
        n -= 1
    if n * stage_bytes + out_bytes > smem_limit:
        raise ValueError(
            f"K1 tile {(th, tw)} at k = {k} needs "
            f"{stage_bytes + out_bytes} B of shared memory, above the card's "
            f"{smem_limit} B: pass a smaller tile")
    return StepPlan((C, Hp, Wp), k, in_size, out_size, (th, tw),
                    (rows, cols), pitch, out_pitch, stage_bytes, out_bytes,
                    n, threads)


def step_grid(plan: StepPlan, blocks_per_sm: int, sms: int) -> int:
    """The persistent grid: as many blocks as the card holds at once
    (``blocks_per_sm`` from the occupancy calculator, times the SMs), never
    more than there are tiles."""
    return max(1, min(plan.ntiles, max(1, int(blocks_per_sm)) * int(sms)))


def step_tiles(plan: StepPlan, grid: int):
    """K1's walk: ``(block, c, y0, x0, oh, ow)`` for every tile, block b
    taking tiles b, b + grid, ... in row-major (channel, row, column)
    order, each storing its oh x ow outputs at (c, y0, x0)."""
    _, ty, tx = plan.tiles
    (H, W), (th, tw) = plan.out_hw, plan.tile
    for t in range(plan.ntiles):
        c, rem = divmod(t, ty * tx)
        y, x = divmod(rem, tx)
        y0, x0 = y * th, x * tw
        yield t % grid, c, y0, x0, min(th, H - y0), min(tw, W - x0)


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
    """Raise on a non-zero cudaError_t, naming it (``cudaErrorName
    (code)``), so that ``resilience.retry.classify`` can tell a refused
    launch from a lost context."""
    if err != 0:
        from parallel_convolution_tpu_torch.ops import _build

        raise RuntimeError(f"{what} launch failed: {_build.error_text(err)}")


def _sm_smem(device: torch.device) -> int:
    """The card's shared memory per SM (torch's figure, else the H100's)."""
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_multiprocessor", 0)
               or H100_SMEM_PER_SM)


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
    out = torch.empty((C, Hp - 2 * r, Wp - 2 * r), dtype=out_dtype,
                      device=padded.device)
    if out.numel() == 0:
        return out
    _step_call(padded, out, filt, quantize, separable, tile)
    stencil_step.launches += 1
    return out


def _step_call(padded: torch.Tensor, out: torch.Tensor, filt: Filter,
               quantize: bool, separable: bool, tile,
               launch: bool = True, library: str = "stencil") -> dict:
    """One K1 launch from ``padded`` into ``out`` (both on the card), or
    with ``launch`` False none.  Returns the launch shape: the plan, the
    blocks one SM holds (the occupancy calculator) and the persistent
    grid.  ``library`` names a measurement build of K1 with the same
    interface (``_build.MEASUREMENT_LIBRARIES``); :func:`stencil_step`
    never passes one."""
    b = _step_launch(library, padded.device, tuple(padded.shape),
                     padded.dtype, out.dtype, filt, bool(quantize),
                     bool(separable), None if tile is None else tuple(tile),
                     STEP_STAGES, STEP_THREADS)
    if launch:
        with torch.cuda.device(padded.device):
            stream = torch.cuda.current_stream(padded.device).cuda_stream
            _raise_on(b.fn(padded.data_ptr(), b.in_code, out.data_ptr(),
                           *b.args, b.grid, None, stream),
                      "stencil_step (K1)")
    return {"plan": b.plan, "blocks_per_sm": b.blocks_per_sm,
            "grid": b.grid}


def step_launch_shape(padded: torch.Tensor, filt: Filter, *,
                      quantize: bool = False, out_dtype=None,
                      separable: bool = False, tile=None) -> dict:
    """The K1 launch :func:`stencil_step` would make on the card's
    ``padded`` (no launch): its :class:`StepPlan`, the blocks one SM holds
    and the persistent grid."""
    if out_dtype is None:
        out_dtype = padded.dtype if quantize else torch.float32
    _check_common(padded, filt, quantize, out_dtype)
    _check_cuda(padded, filt)
    r = filt.radius
    out = torch.empty((1, 1, 1), dtype=out_dtype, device=padded.device)
    out = out.expand(padded.shape[0], padded.shape[1] - 2 * r,
                     padded.shape[2] - 2 * r)
    return _step_call(padded, out, filt, quantize, separable, tile,
                      launch=False)


class _StepLaunch(NamedTuple):
    """Everything of a K1 launch but the tensors and the stream."""

    fn: object            # the C entry point, pc_stencil_step
    in_code: int          # the input dtype's code
    args: tuple           # pc_stencil_step's arguments from out_dtype to threads
    plan: StepPlan
    blocks_per_sm: int
    grid: int


@functools.lru_cache(maxsize=256)
def _step_launch(library: str, device: torch.device, shape: tuple, in_dtype,
                 out_dtype, filt: Filter, quantize: bool, separable: bool,
                 tile, stages: int, threads: int) -> _StepLaunch:
    """K1's launch on one input shape, once per library, device, shape,
    dtypes, filter, mode, tile and launch shape: the plan, the C arguments
    and the persistent grid from the occupancy calculator.  A wrapper call
    then adds its two pointers and the stream: the host work per call is
    the launch."""
    from parallel_convolution_tpu_torch.ops import _build

    lib = _build.load_library(library)
    in_size = torch.empty((), dtype=in_dtype).element_size()
    out_size = torch.empty((), dtype=out_dtype).element_size()
    plan = step_plan(filt.size, shape, in_size, out_size, tile,
                     _smem_limit(device), stages, threads, _lib_strip(lib),
                     _sm_smem(device))
    args = _step_args(filt, quantize, separable, plan, in_dtype, out_dtype)
    in_code = args.pop("in_dtype")
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _raise_on(lib.pc_stencil_step(None, in_code, None, *args.values(), 1,
                                      ctypes.byref(blocks), stream),
                  "stencil_step (K1) occupancy")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    launch = _StepLaunch(lib.pc_stencil_step, in_code, tuple(args.values()),
                         plan, blocks.value, step_grid(plan, blocks.value, sms))
    # A new plan is built once (this cache's miss): the port's "compile".
    obs_events.note_compile(
        "step_plan", "cuda_sep" if separable else "cuda",
        shape=list(shape), k=filt.size, tile=list(plan.tile),
        blocks_per_sm=launch.blocks_per_sm, grid=launch.grid)
    return launch


@functools.lru_cache(maxsize=None)
def _lib_strip(lib) -> int:
    """The strip height the library was built with (k <= 5)."""
    return lib.pc_step_strip(3)


@functools.lru_cache(maxsize=64)
def _step_filter_args(filt: Filter, quantize: bool, separable: bool):
    """The filter's part of K1's arguments, once per filter and mode (the
    factorization and the round-mode rule are host work of tens of
    microseconds): the tap pointers (each keeps its array alive), the
    order and the store-back."""
    sep = _sep_taps(filt, separable)
    taps, col, row = _host_taps(filt, sep)
    return (_fptr(taps), _fptr(col), _fptr(row), int(sep is not None),
            epilogue_code(filt, quantize))


def _step_args(filt: Filter, quantize: bool, separable: bool,
               plan: StepPlan, in_dtype, out_dtype) -> dict:
    """``pc_stencil_step``'s arguments but the two pointers, the grid, the
    occupancy query and the stream, by name, in order: the typed instance
    (dtypes, k, order, store-back ``epi`` from :func:`epilogue_code`) and
    the plan's geometry."""
    taps, col, row, sep, epi = _step_filter_args(filt, bool(quantize),
                                                 bool(separable))
    C, Hp, Wp = plan.shape
    H, W = plan.out_hw
    return {
        "in_dtype": DTYPE_CODES[in_dtype], "out_dtype": DTYPE_CODES[out_dtype],
        "C": C, "Hp": Hp, "Wp": Wp, "H": H, "W": W,
        "taps": taps, "col": col, "row": row, "k": filt.size, "sep": sep,
        "epi": epi, "th": plan.tile[0], "tw": plan.tile[1],
        "rows": plan.extent[0], "cols": plan.extent[1],
        "pitch": plan.pitch, "out_pitch": plan.out_pitch,
        "stages": plan.stages, "threads": plan.threads}


stencil_step.launches = 0


# ---------------------------------------------------------------------------
# K2: T fused levels
# ---------------------------------------------------------------------------


def _levels_plain(padded: torch.Tensor, offsets, filt: Filter, T: int,
                  valid_hw, separable: bool, quantize: bool,
                  mask_rows: bool = True, mask_cols: bool = True):
    """T levels of a deep-padded (C, h+2rT, w+2rT) window in float32, with
    the ghost-ring masks of the axes asked for (the JAX package's
    ``_fused_kernel`` with ``mask_rows`` / ``mask_cols``): level 0 selected
    to exactly 0 outside the image, then every level multiplied by a 0/1
    row mask and a 0/1 column mask, in that order."""
    r = filt.radius
    C, Hp, Wp = padded.shape
    h, w = Hp - 2 * r * T, Wp - 2 * r * T
    dev = padded.device
    cur = padded.to(torch.float32)
    mask_rows = mask_rows and valid_hw is not None
    mask_cols = mask_cols and valid_hw is not None
    rows0 = cols0 = None
    if mask_rows or mask_cols:
        H, W = valid_hw
        ok0 = torch.ones((Hp, Wp), dtype=torch.bool, device=dev)
        if mask_rows:
            rows0 = int(offsets[0]) - r * T + torch.arange(Hp, device=dev)
            ok0 = ok0 & ((rows0 >= 0) & (rows0 < H))[:, None]
        if mask_cols:
            cols0 = int(offsets[1]) - r * T + torch.arange(Wp, device=dev)
            ok0 = ok0 & ((cols0 >= 0) & (cols0 < W))[None, :]
        cur = torch.where(ok0, cur, torch.zeros((), device=dev))
    for s in range(1, T + 1):
        ch, cw = h + 2 * r * (T - s), w + 2 * r * (T - s)
        acc = _correlate(cur, filt, separable)
        if quantize:
            acc = _quantize(acc, filt.convex)
        if rows0 is not None:
            rows = rows0[r * s:r * s + ch]
            acc = acc * ((rows >= 0) & (rows < H)).to(torch.float32)[:, None]
        if cols0 is not None:
            cols = cols0[r * s:r * s + cw]
            acc = acc * ((cols >= 0) & (cols < W)).to(torch.float32)[None, :]
        cur = acc
    return cur


def fused_iterate_plain(padded: torch.Tensor, offsets, filt: Filter, T: int,
                        valid_hw, quantize: bool = True, out_dtype=None,
                        separable: bool = False, interior_split: bool = False,
                        block_off=None, tile=None) -> torch.Tensor:
    """Plain PyTorch version of K2 (the JAX package's ``_fused_kernel`` +
    ``_iterate_levels``): T levels of a deep-padded (C, h+2rT, w+2rT)
    block → (C, h, w).

    ``offsets`` = the block's global (row0, col0); ``valid_hw`` = the
    global image extent whose outside is the zero ghost ring, or None
    (periodic: no masking).  Level 0 is selected to exactly 0 outside the
    image; every level is then multiplied by a 0/1 row mask and a 0/1
    column mask, in that order.

    ``interior_split`` runs the card's launch plan: the level groups of
    :func:`fused_plan` (at the H100's shared memory, or the ``tile``
    given), each group's tile grid cut into the patches of
    :func:`split_patches`, and every patch computed from its slice of the
    group's input with its own mask axes only.  So the CPU shows that
    every mask the plan drops is the identity.
    """
    if out_dtype is None:
        out_dtype = padded.dtype
    block_off = _split_block_off(interior_split, valid_hw, block_off)
    if block_off is None:
        return _levels_plain(padded, offsets, filt, T, valid_hw, separable,
                             quantize).to(out_dtype)
    r = filt.radius
    C, Hp, Wp = padded.shape
    h, w = Hp - 2 * r * T, Wp - 2 * r * T
    th, tw, groups = fused_plan(r, T, (h, w), tile)
    cur, left = padded, T
    between = group_dtype(quantize, out_dtype)
    for g in groups:
        left -= g
        oh, ow = h + 2 * r * left, w + 2 * r * left
        out = torch.empty((C, oh, ow), device=padded.device,
                          dtype=out_dtype if left == 0 else between)
        t = (min(th, oh), min(tw, ow))
        shift = r * left
        origin = (int(offsets[0]) - shift, int(offsets[1]) - shift)
        for (i0, i1), (j0, j1), (mr, mc) in launch_patches(
                valid_hw, t, r * g, (oh, ow), block_off, shift):
            y0, y1 = i0 * t[0], min(i1 * t[0], oh)
            x0, x1 = j0 * t[1], min(j1 * t[1], ow)
            window = cur[:, y0:y1 + 2 * r * g, x0:x1 + 2 * r * g]
            out[:, y0:y1, x0:x1] = _levels_plain(
                window, (origin[0] + y0, origin[1] + x0), filt, g, valid_hw,
                separable, quantize, mr, mc).to(out.dtype)
        cur = out
    return cur


def fused_iterate(padded: torch.Tensor, offsets, filt: Filter, T: int,
                  valid_hw, *, quantize: bool = True, out_dtype=None,
                  separable: bool = False, tile=None,
                  interior_split: bool = False,
                  block_off=None) -> torch.Tensor:
    """T stencil iterations of a deep-padded (C, h+2rT, w+2rT) block.

    The port of ``fused_iterate_pallas``: ``offsets`` is the block's
    global (row0, col0), ``valid_hw`` the global image extent for the
    per-level ghost-ring masks (None = periodic, no masks).  On the card
    the levels run in as few K2 launches as shared memory allows
    (:func:`fused_plan`).  The result does not depend on the grouping:
    between launches the levels pass through device memory in float32 in
    float mode, and in quantize mode in the output dtype, which holds
    every level's values (integers in [0, 255]) exactly, at a quarter of
    float32's bytes for u8 (at BASELINE config 4 a float32 intermediate of
    a 65536² RGB block would take 51.6 GB of the card's 80).

    ``interior_split=True`` (with ``valid_hw``) is the JAX package's
    9-patch launch: each level group's launch becomes one K2 launch per
    patch of :func:`split_patches` over that group's tile grid, the
    middle patch with no mask, a pure-edge patch with the one mask axis
    its tiles can cross, a corner both; each writes its tiles into the
    one output.  It needs ``block_off``, the block's global (row0, col0)
    exact or as per-axis (lo, hi) ranges (:func:`axis_offset_classes`),
    and raises the JAX ``ValueError`` without one.  The bytes are the
    single launch's: a dropped mask is a multiply by 1.0.
    """
    if out_dtype is None:
        out_dtype = padded.dtype
    _check_common(padded, filt, quantize, out_dtype)
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T}")
    if padded.device.type == "cpu":
        return fused_iterate_plain(padded, offsets, filt, T, valid_hw,
                                   quantize, out_dtype, separable,
                                   interior_split, block_off, tile)
    block_off = _split_block_off(interior_split, valid_hw, block_off)
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
    between = group_dtype(quantize, out_dtype)
    for g in groups:
        left -= g
        # This launch's output: the block extended by the r*left ghost
        # levels still to run.
        oh, ow = h + 2 * r * left, w + 2 * r * left
        out = torch.empty((C, oh, ow), device=padded.device,
                          dtype=out_dtype if left == 0 else between)
        t = (min(th, oh), min(tw, ow))
        patches = (None,) if block_off is None else launch_patches(
            valid_hw, t, r * g, (oh, ow), block_off, r * left)
        for patch in patches:
            _fused_call(cur, out, (off_r - r * left, off_c - r * left), filt,
                        g, valid_hw, quantize, separable, t, patch=patch)
            fused_iterate.launches += 1
        cur = out
    return cur


def _fused_call(x, out, offsets, filt: Filter, T: int, valid_hw,
                quantize: bool, separable: bool, tile,
                occupancy: bool = False, patch=None) -> int:
    """One K2 launch of T levels from ``x`` into ``out`` (both on the card),
    or with ``occupancy`` no launch: the number of such blocks one SM
    holds (the CUDA occupancy calculator on the same instance).
    ``patch`` = ((i0, i1), (j0, j1), (mask_rows, mask_cols)) runs the
    tiles [i0, i1) x [j0, j1) of the output's tile grid with those mask
    axes (:func:`split_patches`); None runs every tile, masked on both
    axes when ``valid_hw`` is given."""
    sep = _sep_taps(filt, separable)
    taps, col, row = _host_taps(filt, sep)
    mask = valid_hw is not None
    vh, vw = (int(valid_hw[0]), int(valid_hw[1])) if mask else (0, 0)
    C, Hp, Wp = x.shape
    gh, gw = -(-out.shape[1] // tile[0]), -(-out.shape[2] // tile[1])
    if patch is None:
        patch = ((0, gh), (0, gw), (True, True))
    (i0, i1), (j0, j1), (mr, mc) = patch
    if not (0 <= i0 < i1 <= gh and 0 <= j0 < j1 <= gw):
        raise ValueError(f"patch {patch} outside the {gh}x{gw} tile grid")
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
            int(offsets[0]), int(offsets[1]), int(mask and mr),
            int(mask and mc), vh, vw, tile[0], tile[1], i0, j0, i1 - i0,
            j1 - j0, FUSED_THREADS,
            ctypes.byref(blocks) if occupancy else None, stream)
    _raise_on(err, "fused_iterate (K2)")
    return blocks.value


# ---------------------------------------------------------------------------
# K2's interior split: the JAX package's 9-patch launch plan
# (ops/pallas_stencil.py: _interior_range, split_patches,
# axis_offset_classes; parallel/step.py: _axis_class_index).  Pure integer
# functions of the static geometry.
# ---------------------------------------------------------------------------


def _norm_block_off(block_off):
    """A block offset as ((r0_lo, r0_hi), (c0_lo, c0_hi)): each component
    exact (an int) or a (lo, hi) range, which one launch plan serves for a
    whole class of block positions."""
    r, c = block_off
    r = (int(r), int(r)) if not hasattr(r, "__len__") else (int(r[0]), int(r[1]))
    c = (int(c), int(c)) if not hasattr(c, "__len__") else (int(c[0]), int(c[1]))
    return r, c


def _interior_range(valid_hw, tile_hw, depth, grid_hw, block_off=(0, 0)):
    """Inclusive (i, j) tile ranges whose level-0 windows lie inside the
    image, for a launch whose output starts at global ``block_off``.

    Tile (i, j) covers image rows [r0 + i·th − depth, r0 + i·th + th +
    depth); it is interior iff that range lies in [0, H) (columns alike).
    With (lo, hi) offset ranges the bounds hold for every offset in them
    (lo decides the low edge, hi the high one).  None when no tile
    qualifies.
    """
    H, W = valid_hw
    th, tw = tile_hw
    gh, gw = grid_hw
    (r0l, r0h), (c0l, c0h) = _norm_block_off(block_off)
    i_lo = max(0, -(-(depth - r0l) // th))   # smallest i: r0 + i*th >= depth
    i_hi = (H - r0h - th - depth) // th      # largest i: end <= H
    j_lo = max(0, -(-(depth - c0l) // tw))
    j_hi = (W - c0h - tw - depth) // tw
    i_hi, j_hi = min(i_hi, gh - 1), min(j_hi, gw - 1)
    if i_lo > i_hi or j_lo > j_hi:
        return None
    return (i_lo, i_hi), (j_lo, j_hi)


def split_patches(split, grid_hw):
    """The 9-patch plan of an interior box ``split``: a list of ``((i0,
    i1), (j0, j1), (mask_rows, mask_cols))`` patches partitioning the
    ``grid_hw`` tile grid (half-open bounds), row band by row band: the
    middle patch unmasked, a pure-edge patch keeping only the axis its
    tiles can cross, a corner both."""
    (i_lo, i_hi), (j_lo, j_hi) = split
    gh, gw = grid_hw
    row_bands = [(0, i_lo, True), (i_lo, i_hi + 1, False),
                 (i_hi + 1, gh, True)]
    col_bands = [(0, j_lo, True), (j_lo, j_hi + 1, False),
                 (j_hi + 1, gw, True)]
    return [((r0, r1), (c0, c1), (mr, mc))
            for r0, r1, mr in row_bands if r1 > r0
            for c0, c1, mc in col_bands if c1 > c0]


def axis_offset_classes(n_blocks: int, block: int):
    """The block-offset classes along one grid axis, as (lo, hi) ranges:
    a block's interior geometry depends only on which image edges it can
    touch, so the blocks of an axis fall into at most three classes --
    the first (offset 0), the last ((n−1)·block) and the middle band
    ([block, (n−2)·block]), in that order."""
    if n_blocks == 1:
        return [(0, 0)]
    if n_blocks == 2:
        return [(0, 0), (block, block)]
    last = (n_blocks - 1) * block
    return [(0, 0), (block, last - block), (last, last)]


def axis_class_index(a: int, n: int) -> int:
    """The index into :func:`axis_offset_classes` of block ``a`` of an
    ``n``-block axis (the JAX package's ``step._axis_class_index``)."""
    if n <= 2:
        return 0 if n == 1 else int(a)
    return 0 if a == 0 else (2 if a == n - 1 else 1)


def _split_block_off(interior_split: bool, valid_hw, block_off):
    """The static offset the split plans with, or None for no split
    (periodic, or not asked).  Raises the JAX package's ``ValueError``
    when a split is asked without ``block_off``."""
    if not interior_split or valid_hw is None:
        return None
    if block_off is None:
        raise ValueError(
            "interior_split requires a static block_off — the global "
            "(row0, col0) of this block, exact or as (lo, hi) ranges; "
            "without it the unmasked-interior classification cannot be "
            "sound for arbitrary runtime offsets")
    return _norm_block_off(block_off)


def launch_patches(valid_hw, tile, depth: int, out_hw, block_off,
                   shift: int = 0):
    """The patches of one K2 launch under the interior split: the tiles of
    an ``out_hw`` output at ``tile``, whose level-0 windows reach
    ``depth`` beyond the tile, for a block at ``block_off`` whose launch
    output starts ``shift`` ghost levels' rows before it (a level group
    before the last: ``r·left``).  One patch with both masks when no tile
    is interior."""
    gh, gw = -(-out_hw[0] // tile[0]), -(-out_hw[1] // tile[1])
    (rl, rh), (cl, ch) = _norm_block_off(block_off)
    split = _interior_range(valid_hw, tile, depth, (gh, gw),
                            ((rl - shift, rh - shift),
                             (cl - shift, ch - shift)))
    if split is None:
        return [((0, gh), (0, gw), (True, True))]
    return split_patches(split, (gh, gw))


def group_dtype(quantize: bool, out_dtype):
    """The dtype levels pass between two level-group launches in (K2, and
    K3 / K4 to K2): float32 in float mode; in quantize mode the output
    dtype, exact for the quantized levels."""
    return out_dtype if quantize else torch.float32


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
    K3, K4, their per-slot and per-region launches and the pack in
    ops/rdma.py)."""
    from parallel_convolution_tpu_torch.ops import rdma

    stencil_step.launches = 0
    fused_iterate.launches = 0
    for fn in (rdma.rdma_block, rdma.rdma_tiled, rdma.rdma_block_slot,
               rdma.rdma_tiled_slot, rdma.rdma_block_region,
               rdma.rdma_tiled_region, rdma.rdma_pack):
        fn.launches = 0


def launch_counts() -> dict:
    """Launches of every kernel of the port since the last reset."""
    from parallel_convolution_tpu_torch.ops import rdma

    return {"stencil_step": stencil_step.launches,
            "fused_iterate": fused_iterate.launches,
            "rdma_block": rdma.rdma_block.launches,
            "rdma_tiled": rdma.rdma_tiled.launches,
            "rdma_block_slot": rdma.rdma_block_slot.launches,
            "rdma_tiled_slot": rdma.rdma_tiled_slot.launches,
            "rdma_block_region": rdma.rdma_block_region.launches,
            "rdma_tiled_region": rdma.rdma_tiled_region.launches,
            "rdma_pack": rdma.rdma_pack.launches}
