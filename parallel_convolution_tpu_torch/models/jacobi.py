"""Run-to-convergence Jacobi smoothing of the PyTorch port (BASELINE config
5; the JAX package's ``models/jacobi.py``).

The reference's optional early stop (every N iterations each rank computes
a local diff and the grid agrees through ``MPI_Allreduce``) as an iterative
solver: float32 carry, max-abs convergence norm, one readback of the
global diff per ``check_every`` chunk (``parallel.step.sharded_converge``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parallel_convolution_tpu_torch.ops.filters import Filter, get_filter
from parallel_convolution_tpu_torch.parallel import step as step_lib
from parallel_convolution_tpu_torch.parallel.mesh import (
    Grid, grid_like, make_grid,
)
from parallel_convolution_tpu_torch.utils.config import check_solver


@dataclasses.dataclass
class JacobiSolver:
    """Iterate a smoothing stencil until the field stops changing.

    ``tol`` is the max-abs single-iteration change below which the run
    stops; ``check_every`` matches the reference's every-N reduction cadence
    (larger = fewer readbacks, up to N-1 extra iterations).  ``grid``
    defaults to 1×1 on ``device`` (default: the card; it raises without
    CUDA, ``device="cpu"`` runs the plain versions).  ``backend`` takes the
    port's names (``cuda`` / ``cuda_sep`` / ``cuda_rdma`` for the JAX
    package's ``pallas`` / ``pallas_sep`` / ``pallas_rdma``, or ``auto``
    with ``fuse=None`` to tune the depth too).  ``solver="multigrid"``
    runs the geometric V-cycle (``solvers.multigrid``; ``mg_levels`` caps
    its level count, Jacobi ignores it): the same stopping measure, and
    ``last_mg`` holds the :class:`~parallel_convolution_tpu_torch.solvers.
    multigrid.MGResult` of the latest solve.  ``interior_split`` launches
    K2 by the 9-patch plan in Jacobi's fused chunks (the V-cycle takes it
    and does not use it, as the JAX solver).  ``col_mode`` is
    ``cuda_rdma``'s column transport on a grid of slots (``grid=
    mesh.make_grid(devices=...)``), and ``overlap=True`` its overlapped
    pipeline there (clamped elsewhere: ``step.resolve_overlap``).
    """

    filt: Filter | str = "jacobi3"
    tol: float = 1e-3
    max_iters: int = 10_000
    check_every: int = 10
    grid: Grid | None = None
    backend: str = "shifted"
    quantize: bool = False
    boundary: str = "zero"
    storage: str = "f32"  # iteration-carry dtype (see sharded_converge)
    fuse: int | None = 1  # fused iterations between convergence checks
    tile: tuple[int, int] | None = None  # CUDA kernels' output tile
    interior_split: bool = False
    overlap: bool | None = None
    col_mode: str | None = None
    solver: str = "jacobi"
    mg_levels: int | None = None
    device: object = None
    last_mg: object = dataclasses.field(default=None, repr=False,
                                        compare=False)

    def __post_init__(self) -> None:
        check_solver(self.solver)
        if isinstance(self.filt, str):
            self.filt = get_filter(self.filt)
        if self.grid is None:
            self.grid = make_grid(device=self.device)
        elif (self.device is not None
              and self.grid.device != torch.device(self.device)):
            raise ValueError(f"grid is on {self.grid.device}, "
                             f"device={self.device!r}")

    def set_grid(self, grid: Grid | str) -> "JacobiSolver":
        """Swap the block grid (elastic recovery; the JAX package's
        ``set_mesh``): a :class:`Grid` or an ``"RxC"`` spec in the current
        grid's form (``mesh.grid_like``), as
        ``ConvolutionModel.set_grid``.  The solver's configuration stays;
        results do not depend on the grid."""
        if isinstance(grid, str):
            from parallel_convolution_tpu_torch.resilience.elastic import (
                parse_spec,
            )

            grid = grid_like(self.grid, parse_spec(grid))
        self.grid = grid
        if self.device is not None:
            self.device = grid.device
        return self

    def solve(self, x) -> tuple[np.ndarray, int]:
        """(C, H, W) f32 field -> (solved field as numpy, work count): the
        Jacobi iterations run, or the V-cycles for ``solver="multigrid"``
        (whose fine-grid work units and level schedule land in
        ``self.last_mg``)."""
        if self.solver == "multigrid":
            from parallel_convolution_tpu_torch.solvers import multigrid

            out, res = multigrid.mg_converge(
                x, self.filt, tol=self.tol, max_iters=self.max_iters,
                grid=self.grid, quantize=self.quantize, backend=self.backend,
                storage=self.storage, boundary=self.boundary, fuse=self.fuse,
                tile=self.tile, overlap=self.overlap,
                mg_levels=self.mg_levels, col_mode=self.col_mode)
            self.last_mg = res
            return out.cpu().numpy(), res.cycles
        out, iters = step_lib.sharded_converge(
            x, self.filt, tol=self.tol, max_iters=self.max_iters,
            check_every=self.check_every, grid=self.grid,
            quantize=self.quantize, backend=self.backend,
            boundary=self.boundary, storage=self.storage, fuse=self.fuse,
            tile=self.tile, interior_split=self.interior_split,
            overlap=self.overlap, col_mode=self.col_mode)
        return out.cpu().numpy(), iters
