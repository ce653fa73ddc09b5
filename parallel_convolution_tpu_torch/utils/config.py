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

# What a grid of slots over several processes does not run yet.
PROCESSES_ITEM = ("item 10d (cuda_rdma, multigrid and volumes across "
                  "processes; the NCCL transport, one card a process)")

# The serving modules not ported yet (``serving/__init__.py`` raises on
# their names): one replica's service, its HTTP frontend and the fleet.
SERVICE_ITEM = ("item 8a-ii (serving: service.py, frontend.py, frames.py, "
                "jobs.py, cache.py, pricing.py)")
FLEET_ITEM = ("item 8b (serving: the fleet — router.py, wal.py, peers.py, "
              "autoscaler.py, chaos.py)")

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
