"""Halo channels (the JAX package's ``parallel/channels.py``): which block
feeds each ghost region, and the slab plan of one exchange identity.

**The neighbour table** (:func:`neighbour_table`, :func:`device_table`),
which K3 / K4 read.  For every block ``b = i * cols + j`` of the R×C grid,
nine entries in row-major order over ``(di, dj)`` in ``{-1, 0, 1}²``: the
index of the block at ``(i + di, j + dj)`` that feeds that ghost region
(the centre entry is ``b`` itself, the corners the diagonal block), ``-1``
where there is none (zero boundary past the image edge), and under a
periodic boundary the wrapped block (the block itself on an axis of extent
1, the TPU kernels' self-wrap).  It depends on the grid shape and the
boundary alone, so it is cached on those (and the device).  The halo
exchange's two-hop corners (rows first, then full-height columns) land the
same bytes as a direct read of the diagonal block.

**The channel plan** (:class:`ChannelKey`, :class:`ChannelPlan`,
:func:`plan_for`): the slab rectangles each direction moves, built once per
exchange identity and cached process-globally, with build / hit counters
(:func:`stats`, :func:`reset`) that show reuse, mirrored into the obs
counters ``pctpu_channel_builds_total`` / ``pctpu_channel_reuse_total``.
Row slabs run at interior
columns, column slabs at the row-padded height (the corners ride the
column phase).  On a grid of slots the ``packed`` column transport
(``col_mode``) stages each block's two column slabs, at the monolithic
plan's geometry, in a contiguous buffer its neighbours read
(``ops/rdma.py``: ``rdma_pack``); the port's K3 and K4 both move that
geometry.  ``_tiled_slabs`` keeps the JAX tiled kernel's aligned-band
geometry (its TPU sublane and lane widths), so a plan of either kernel
form equals the JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import torch

from parallel_convolution_tpu_torch.obs import metrics as obs_metrics
from parallel_convolution_tpu_torch.utils.config import (
    BOUNDARIES, COL_MODE_CHOICES, COL_MODES,
)

__all__ = [
    "COL_MODES", "COL_MODE_CHOICES", "ChannelKey", "ChannelPlan",
    "DIRECTIONS", "OFFSETS", "OPPOSITE", "Slab", "device_table",
    "neighbour_table", "plan_for", "reset", "stats",
]

OFFSETS = tuple((di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1))


def _wrap(i: int, n: int, periodic: bool) -> int | None:
    if 0 <= i < n:
        return i
    return i % n if periodic else None


@functools.lru_cache(maxsize=64)
def neighbour_table(grid: tuple[int, int],
                    boundary: str) -> tuple[tuple[int, ...], ...]:
    """The (cached) neighbour table of an R×C grid: per block, 9 source
    blocks or -1."""
    if boundary not in BOUNDARIES:
        raise ValueError(f"boundary must be one of {BOUNDARIES}, got "
                         f"{boundary!r}")
    R, C = grid
    periodic = boundary == "periodic"
    rows = []
    for i in range(R):
        for j in range(C):
            row = []
            for di, dj in OFFSETS:
                ni, nj = _wrap(i + di, R, periodic), _wrap(j + dj, C, periodic)
                row.append(-1 if ni is None or nj is None else ni * C + nj)
            rows.append(tuple(row))
    return tuple(rows)


@functools.lru_cache(maxsize=64)
def device_table(grid: tuple[int, int], boundary: str,
                 device: torch.device) -> torch.Tensor:
    """:func:`neighbour_table` as the kernels read it: one contiguous
    (blocks × 9) int32 tensor on ``device``, uploaded once."""
    return torch.tensor(neighbour_table(tuple(grid), boundary),
                        dtype=torch.int32, device=device).reshape(-1)


# -- the channel plan (the JAX package's channels.py:69-271) ---------------

# The JAX tiled kernel's band alignment: TPU (sublane, lane) tiling.  Only
# _tiled_slabs reads them, so that its plans equal the JAX package's.
_TPU_SUBLANE = {"f32": 8, "bf16": 16, "u8": 32}
_TPU_LANE = 128

# Semaphore slots of the JAX kernels (one (send, recv) pair a direction);
# on the card the slot is the direction's index in the plan.
SEM_UP, SEM_DOWN, SEM_LEFT, SEM_RIGHT = 0, 1, 2, 3

DIRECTIONS = ("up", "down", "left", "right")

# The direction whose inbound copy writes MY ghost on the given side: my
# top ghost is written by my upper neighbour's "down" send.
OPPOSITE = {"up": "down", "down": "up", "left": "right", "right": "left"}


@dataclasses.dataclass(frozen=True)
class ChannelKey:
    """One exchange identity."""

    grid: tuple[int, int]
    block_hw: tuple[int, int]
    radius: int
    fuse: int
    dtype: str                 # storage dtype name (the wire dtype)
    boundary: str
    kernel: str = "monolithic"  # "monolithic" | "tiled"
    col_mode: str = "strided"   # resolved transport: "packed" | "strided"

    def __post_init__(self) -> None:
        if self.kernel not in ("monolithic", "tiled"):
            raise ValueError(f"unknown kernel form {self.kernel!r}")
        if self.col_mode not in COL_MODES:
            raise ValueError(
                f"col_mode must be one of {COL_MODES} (resolved, never "
                f"'auto') at the plan layer, got {self.col_mode!r}")


@dataclasses.dataclass(frozen=True)
class Slab:
    """One direction's ghost slab: where it reads, where it lands on the
    partner, which partner, which semaphore pair.  Rectangles are
    half-open ``(lo, hi)`` in pad coordinates; ``rows=None`` is the full
    padded height of a launch's band."""

    direction: str
    src_rows: tuple[int, int] | None
    src_cols: tuple[int, int]
    dst_rows: tuple[int, int] | None
    dst_cols: tuple[int, int]
    nbr: tuple[int, int]
    sem: int


@dataclasses.dataclass(frozen=True)
class ChannelPlan:
    """The slab structure of one exchange identity.  ``row_slabs`` /
    ``col_slabs`` are empty on an axis of extent 1 (no partner);
    ``row_wrap`` / ``col_wrap`` mark periodic self-wrap axes."""

    key: ChannelKey
    row_slabs: tuple[Slab, ...]
    col_slabs: tuple[Slab, ...]
    row_wrap: bool
    col_wrap: bool

    @property
    def packed_cols(self) -> bool:
        """Whether this plan stages its column slabs (packed transport
        with a column partner to stage for)."""
        return self.key.col_mode == "packed" and bool(self.col_slabs)

    def slabs(self) -> tuple[Slab, ...]:
        return self.row_slabs + self.col_slabs

    def slab(self, direction: str) -> Slab | None:
        for s in self.slabs():
            if s.direction == direction:
                return s
        return None


def _monolithic_slabs(key: ChannelKey):
    """Ghost depth d = radius·fuse; row slabs at interior columns, column
    slabs at the full padded height (the two-hop corners)."""
    (R, C), (h, w) = key.grid, key.block_hw
    d = key.radius * max(1, key.fuse)
    periodic = key.boundary == "periodic"
    row_slabs: tuple[Slab, ...] = ()
    col_slabs: tuple[Slab, ...] = ()
    if R > 1:
        row_slabs = (
            Slab("up", (d, 2 * d), (d, d + w),
                 (h + d, h + 2 * d), (d, d + w), (-1, 0), SEM_UP),
            Slab("down", (h, h + d), (d, d + w),
                 (0, d), (d, d + w), (+1, 0), SEM_DOWN),
        )
    if C > 1:
        full = (0, h + 2 * d)
        col_slabs = (
            Slab("left", full, (d, 2 * d),
                 full, (w + d, w + 2 * d), (0, -1), SEM_LEFT),
            Slab("right", full, (w, w + d),
                 full, (0, d), (0, +1), SEM_RIGHT),
        )
    return row_slabs, col_slabs, periodic and R == 1, periodic and C == 1


def _tiled_slabs(key: ChannelKey):
    """The JAX tiled kernel's aligned bands: a (sublane, 128)-aligned band
    whose trailing / leading r·fuse rows / columns land on the receiver's
    ghosts; column bands run the full padded height (``rows=None``)."""
    (R, C), (h, w) = key.grid, key.block_hw
    sub_v = _TPU_SUBLANE[_storage_of(key.dtype)]
    lane = _TPU_LANE
    periodic = key.boundary == "periodic"
    row_slabs: tuple[Slab, ...] = ()
    col_slabs: tuple[Slab, ...] = ()
    if R > 1:
        row_slabs = (
            Slab("up", (sub_v, 2 * sub_v), (lane, lane + w),
                 (h + sub_v, h + 2 * sub_v), (lane, lane + w),
                 (-1, 0), SEM_UP),
            Slab("down", (h, h + sub_v), (lane, lane + w),
                 (0, sub_v), (lane, lane + w), (+1, 0), SEM_DOWN),
        )
    if C > 1:
        col_slabs = (
            Slab("left", None, (lane, 2 * lane),
                 None, (w + lane, w + 2 * lane), (0, -1), SEM_LEFT),
            Slab("right", None, (w, w + lane),
                 None, (0, lane), (0, +1), SEM_RIGHT),
        )
    return row_slabs, col_slabs, periodic and R == 1, periodic and C == 1


def _storage_of(dtype_name: str) -> str:
    """A dtype name (numpy's or torch's) as the storage registry's key;
    unknown dtypes tile like f32."""
    return {"float32": "f32", "bfloat16": "bf16", "uint8": "u8"}.get(
        dtype_name.removeprefix("torch."), "f32")


_PLANS: dict[ChannelKey, ChannelPlan] = {}
_STATS = {"builds": 0, "hits": 0}
_LOCK = threading.Lock()


def plan_for(key: ChannelKey) -> ChannelPlan:
    """The (cached) channel plan of one exchange identity.  Builds are
    counted apart from hits: after a warm run, ``builds`` is the number of
    distinct identities, however many iterations ran."""
    with _LOCK:
        plan = _PLANS.get(key)
        if plan is not None:
            _STATS["hits"] += 1
            _note("hits")
            return plan
        rows, cols, rw, cw = (_tiled_slabs(key) if key.kernel == "tiled"
                              else _monolithic_slabs(key))
        plan = ChannelPlan(key, rows, cols, rw, cw)
        _PLANS[key] = plan
        _STATS["builds"] += 1
        _note("builds")
        return plan


def _note(which: str) -> None:
    """Mirror one build / hit into the obs registry (one branch when obs
    is off; the counters here stay authoritative either way)."""
    if not obs_metrics.enabled():
        return
    name = ("pctpu_channel_builds_total" if which == "builds"
            else "pctpu_channel_reuse_total")
    obs_metrics.counter(
        name, "halo channel-plan descriptor builds vs cache reuses",
        ()).inc()


def stats() -> dict:
    """``{"builds": n, "hits": n}``: the reuse evidence."""
    with _LOCK:
        return dict(_STATS)


def reset() -> None:
    """Drop the cache and zero the counters."""
    with _LOCK:
        _PLANS.clear()
        _STATS["builds"] = 0
        _STATS["hits"] = 0
