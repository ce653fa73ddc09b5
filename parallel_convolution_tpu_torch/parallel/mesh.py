"""The block grid of the PyTorch port (the JAX package's ``parallel/mesh.py``).

The JAX package maps an R×C grid of blocks onto an R×C mesh of devices.
In this slice every block lives on one device (one card, or the CPU): a
:class:`Grid` is the grid shape plus that device, and the image state is an
R×C list of lists of ``(C, h, w)`` block tensors.  Axis convention as in
the JAX package: grid rows split H, grid columns split W.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from parallel_convolution_tpu_torch.utils.platform import resolve_device


def dims_create(n: int) -> tuple[int, int]:
    """Near-square factorization of ``n`` — the MPI_Dims_create contract.

    Returns (R, C) with R*C == n and R <= C, R as close to sqrt(n) as the
    factorization allows (the JAX package's default mesh over its devices;
    here the default grid over the cards, which blocks on separate cards,
    item 10, will use).
    """
    if n < 1:
        raise ValueError("need at least one device")
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def padded_extent(total: int, parts: int) -> int:
    """Smallest multiple of ``parts`` ≥ ``total`` (blocks are equal-sized;
    the rim beyond the image is padded and re-masked to zero)."""
    return -(-total // parts) * parts


@dataclasses.dataclass(frozen=True)
class Grid:
    """An R×C grid of blocks, all on ``device``."""

    rows: int = 1
    cols: int = 1
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))

    def __post_init__(self) -> None:
        if self.rows < 1 or self.cols < 1:
            raise ValueError(f"grid shape must be positive, got "
                             f"{(self.rows, self.cols)}")
        object.__setattr__(self, "device", torch.device(self.device))

    @property
    def shape(self) -> tuple[int, int]:
        return self.rows, self.cols


def make_grid(shape: tuple[int, int] | None = None, device=None) -> Grid:
    """A grid of ``shape`` (default 1×1) on ``device`` (default: the card;
    raises without CUDA unless ``device='cpu'``)."""
    r, c = shape if shape is not None else (1, 1)
    return Grid(int(r), int(c), resolve_device(device))


def grid_from_spec(spec: str | None, device=None) -> Grid:
    """The grid a CLI ``--mesh RxC`` flag names (None/empty → 1×1)."""
    if not spec:
        return make_grid(device=device)
    try:
        r, c = (int(v) for v in spec.lower().split("x"))
    except ValueError as e:
        raise ValueError(f"grid spec must be RxC, got {spec!r}") from e
    return make_grid((r, c), device)


def split_blocks(x: torch.Tensor, grid: Grid) -> list[list[torch.Tensor]]:
    """Cut a (C, R*h, C*w) tensor into the grid's R×C contiguous blocks."""
    R, Cc = grid.shape
    _, Hp, Wp = x.shape
    if Hp % R or Wp % Cc:
        raise ValueError(f"extent {(Hp, Wp)} not divisible by grid {(R, Cc)}")
    bh, bw = Hp // R, Wp // Cc
    return [[x[:, i * bh:(i + 1) * bh, j * bw:(j + 1) * bw].contiguous()
             for j in range(Cc)] for i in range(R)]


def join_blocks(blocks: list[list[torch.Tensor]]) -> torch.Tensor:
    """Inverse of :func:`split_blocks`."""
    return torch.cat([torch.cat(row, dim=2) for row in blocks], dim=1)
