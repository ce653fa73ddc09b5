"""Canonical name registries of the PyTorch port.

The port keeps the JAX package's backend names where the implementation is
plain tensor code and renames the three that were Pallas TPU kernels to the
hand-written CUDA kernels that replace them, one to one:

    JAX package      port
    -----------      ----
    shifted          shifted     (fixed-order tap loop, PyTorch ops)
    separable        separable   (rank-1 two-pass tap loop, PyTorch ops)
    xla_conv         xla_conv    (F.conv2d, TF32 off)
    pallas           cuda        (K1 stencil_step / K2 fused_iterate)
    pallas_sep       cuda_sep    (the same kernels, separable tap order)
    pallas_rdma      cuda_rdma   (K3 rdma_block / K4 rdma_tiled: the halo
                                  exchange inside the launch)

``auto`` resolves to one of those names through the port's own tuning
package (plan cache, then the cost model) before anything is built.
Everything the JAX package offers beyond the port so far raises
``NotImplementedError`` naming its item in ROADMAP.md ("Open items"),
never silently ignored.
"""

from __future__ import annotations

import dataclasses
import json

BACKENDS = ("shifted", "xla_conv", "cuda", "separable", "cuda_sep",
            "cuda_rdma")
# "auto": resolve the backend (and an unset fuse / tile) through tuning/.
AUTO = "auto"
BACKEND_CHOICES = BACKENDS + (AUTO,)
STORAGES = ("f32", "bf16", "u8")
BOUNDARIES = ("zero", "periodic")
# Run-to-convergence strategies, with the JAX package's names.
SOLVERS = ("jacobi", "multigrid")

# Rank-3 volumes (``volumes/``), the JAX package's registries: the kernel
# forms register under ``(3, name, boundary)``.  ``smooth`` forms are
# Jacobi relaxations a converge loop may drive, ``physics`` forms
# time-dependent integrators.  Every rank-3 form carries TWO stacked
# fields: (u, f) for the FD forms, (u, u_prev) for wave, (U, V) for
# Gray-Scott.
RANKS = (2, 3)
VOLUME_SMOOTH_FORMS = ("fd7", "fd7_stack", "fd25", "fd25_stack")
VOLUME_PHYSICS_FORMS = ("wave", "grayscott")
VOLUME_FORMS = VOLUME_SMOOTH_FORMS + VOLUME_PHYSICS_FORMS
VOLUME_FIELDS = 2
# Ghost radius of one application of each rank-3 form (fd25 is the
# 8th-order star).
VOLUME_RADII = {"fd7": 1, "fd7_stack": 1, "fd25": 4, "fd25_stack": 4,
                "wave": 1, "grayscott": 1}

# The JAX package's backend name -> the port's.
BACKEND_FROM_REFERENCE = {
    "shifted": "shifted",
    "xla_conv": "xla_conv",
    "separable": "separable",
    "pallas": "cuda",
    "pallas_sep": "cuda_sep",
    "pallas_rdma": "cuda_rdma",
}

# Column-slab transports between the blocks of a grid of slots (the JAX
# package's registry): "packed" gathers each block's edge column slabs
# into a contiguous staging buffer that the neighbours read densely,
# "strided" reads the neighbour's edge columns in place; "auto" lets the
# cost model pick (user surfaces only).
COL_MODES = ("packed", "strided")
COL_MODE_CHOICES = COL_MODES + ("auto",)

# The escape hatch that runs the overlapped pipeline's plain schedule on a
# CPU grid of slots anyway, for byte proofs (the JAX package's constant of
# the same name and value): without it ``overlap=True`` is clamped there.
OVERLAP_INTERPRET_ENV = "PCTPU_OVERLAP_INTERPRET"

# Knobs of the JAX entry points and CLI that later slices port:
# name -> ROADMAP item.  None is left: every knob is ported.
PENDING_KNOBS: dict[str, str] = {}


def pending(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: see ROADMAP.md 'Open items', {item}")


def check_backend(backend: str, allow_auto: bool = False) -> None:
    """Raise on a backend this slice does not have (``auto`` only where the
    caller resolves it)."""
    if backend not in (BACKEND_CHOICES if allow_auto else BACKENDS):
        hint = BACKEND_FROM_REFERENCE.get(backend)
        raise ValueError(
            f"unknown backend {backend!r}; available: "
            f"{BACKEND_CHOICES if allow_auto else BACKENDS}"
            + (f" (the JAX package's {backend!r} is {hint!r} here)"
               if hint else ""))


def check_fuse(backend: str, fuse) -> None:
    """``fuse=None`` asks the tuner for the depth, which only ``auto`` does."""
    if fuse is None and backend != AUTO:
        raise ValueError("fuse=None means 'tune it' and needs backend='auto'")


def check_solver(solver: str) -> None:
    """One of :data:`SOLVERS`, else the JAX package's error."""
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")


def check_storage(storage: str, quantize: bool) -> None:
    if storage == "u8" and not quantize:
        raise ValueError(
            "storage='u8' requires quantize=True: u8 carries can only hold "
            "the quantized integer states; a float iterate would be "
            "silently truncated every iteration")


def check_run_config(storage: str, boundary: str, quantize: bool) -> None:
    if storage not in STORAGES:
        raise ValueError(
            f"storage must be one of {STORAGES}, got {storage!r}")
    if boundary not in BOUNDARIES:
        raise ValueError(
            f"boundary must be one of {BOUNDARIES}, got {boundary!r}")
    check_storage(storage, quantize)


@dataclasses.dataclass
class RunConfig:
    """Everything needed to reproduce one filtering run: the JAX package's
    ``RunConfig`` (the same fields, defaults and validation errors) on the
    port's registries.  ``backend`` takes the port's names (a JAX name is
    refused with the port's counterpart in the message;
    ``convert.run_config_from_reference`` maps a JAX config's JSON);
    ``tile`` is K2's output tile (TH, TW)."""

    rows: int
    cols: int
    rank: int = 2                  # 2 = planar (C, H, W); 3 = volume
    #                                (F, D, H, W) through volumes/
    depth: int | None = None       # D extent (rank 3 only)
    mode: str = "grey"            # grey | rgb
    filter_name: str = "blur3"
    iters: int = 100
    mesh_shape: tuple[int, int] | None = None   # None = 1x1
    backend: str = "shifted"       # any of BACKENDS, or "auto"
    storage: str = "f32"           # f32 | bf16 | u8
    fuse: int | None = 1           # None = tune it (backend="auto" only)
    tile: tuple[int, int] | None = None   # K2's output tile (TH, TW)
    overlap: bool | None = None    # interior-first overlapped halo
    #                                pipeline (cuda_rdma on slots): None =
    #                                off for explicit backends, tuned for
    #                                "auto"; True/False = clamped request
    col_mode: str | None = None    # cuda_rdma's column-slab transport:
    #                                None or "auto" = cost-model pick
    boundary: str = "zero"
    quantize: bool = True
    converge_tol: float | None = None
    solver: str = "jacobi"         # SOLVERS, for converge_tol runs;
    #                                "multigrid" requires quantize=False
    #                                and f32
    mg_levels: int | None = None   # multigrid level-count cap
    check_every: int = 10
    sharded_io: bool = False
    checkpoint_dir: str | None = None
    checkpoint_every: int = 100
    fallback: bool = False  # the degrade walk on a transient build or
    #                         launch failure (resilience.degrade)

    def __post_init__(self) -> None:
        if self.rank not in RANKS:
            raise ValueError(f"rank must be one of {RANKS}, got {self.rank}")
        if self.rank == 3:
            if self.depth is None or int(self.depth) < 1:
                raise ValueError(
                    f"rank=3 needs a positive depth, got {self.depth}")
            if self.filter_name not in VOLUME_FORMS:
                raise ValueError(
                    f"rank-3 form must be one of {VOLUME_FORMS}, got "
                    f"{self.filter_name!r}")
            if self.quantize or self.storage != "f32":
                raise ValueError(
                    "rank=3 runs float carries: quantize=False, "
                    "storage='f32'")
        elif self.depth is not None:
            raise ValueError("depth is a rank-3 knob (set rank=3)")
        if self.mode not in ("grey", "rgb"):
            raise ValueError(f"mode must be grey|rgb, got {self.mode!r}")
        if self.storage not in STORAGES:
            raise ValueError(
                f"storage must be one of {STORAGES}, got {self.storage!r}")
        check_backend(self.backend, allow_auto=True)
        if self.boundary not in BOUNDARIES:
            raise ValueError(
                f"boundary must be one of {BOUNDARIES}, got {self.boundary!r}")
        if self.storage == "u8" and not self.quantize:
            # u8 carries can only hold the quantized integer states.
            raise ValueError("storage='u8' requires quantize=True")
        check_solver(self.solver)
        if self.mg_levels is not None and int(self.mg_levels) < 1:
            raise ValueError(f"mg_levels must be >= 1, got {self.mg_levels}")
        if self.solver == "multigrid" and self.converge_tol is not None:
            # The V-cycle's residual and correction fields are signed
            # floats: fail the config here, not inside a level program.
            if self.quantize:
                raise ValueError(
                    "solver='multigrid' requires quantize=False")
            if self.storage != "f32":
                raise ValueError(
                    "solver='multigrid' requires storage='f32'")
        if (self.rows <= 0 or self.cols <= 0 or self.iters < 0
                or (self.fuse is not None and self.fuse < 1)):
            raise ValueError("rows/cols must be positive, iters >= 0, fuse >= 1")
        check_fuse(self.backend, self.fuse)
        if self.overlap is not None:
            self.overlap = bool(self.overlap)
        if (self.col_mode is not None
                and self.col_mode not in COL_MODE_CHOICES):
            raise ValueError(
                f"col_mode must be one of {COL_MODE_CHOICES}, got "
                f"{self.col_mode!r}")
        if self.mesh_shape is not None:
            self.mesh_shape = tuple(self.mesh_shape)
        if self.tile is not None:
            self.tile = tuple(int(v) for v in self.tile)
            if len(self.tile) != 2 or min(self.tile) <= 0:
                raise ValueError(
                    f"tile must be two positive ints (TH, TW), got {self.tile}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        return cls(**json.loads(text))

    def build_model(self, device=None):
        """The ``ConvolutionModel`` this config describes, on
        ``make_grid(mesh_shape, device)`` (default: the card; raises
        without CUDA, ``device="cpu"`` runs the plain versions)."""
        from parallel_convolution_tpu_torch.models import ConvolutionModel
        from parallel_convolution_tpu_torch.parallel.mesh import make_grid

        return ConvolutionModel(
            filt=self.filter_name, grid=make_grid(self.mesh_shape, device),
            backend=self.backend, quantize=self.quantize,
            storage=self.storage, fuse=self.fuse, boundary=self.boundary,
            tile=self.tile, overlap=self.overlap, col_mode=self.col_mode,
            fallback=self.fallback)
