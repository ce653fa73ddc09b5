"""Kernel-form registry: dispatch is a table keyed ``(rank, name,
boundary)``, as in the JAX package's ``parallel/kernels.py``.

``parallel/step.py`` registers one smoother form per backend at import,
``solvers/transfer.py`` the multigrid transfer operators (``restrict_fw``,
``prolong_bilinear``; rank 3: ``restrict_fw``, ``prolong_trilinear``)
under their own stencil forms, so a transfer operator can never be taken
for a smoother, and ``volumes/forms.py`` the rank-3 forms (``smooth``
relaxations and time-dependent ``physics``).  Two capability bits, as
in the JAX package: ``persistent_capable`` (the form moves column slabs
between the blocks of a grid of slots, so ``col_mode`` selects its
transport; ``cuda_rdma``) and ``overlap_capable`` (the form has an
interior-first overlapped pipeline: ``cuda_rdma`` on a grid of slots
launches its kernels region by region, ``parallel.step.resolve_overlap``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

STENCIL_FORMS = ("smooth", "restrict", "prolong", "physics")


@dataclasses.dataclass(frozen=True)
class KernelForm:
    """One registered stencil program family.

    ``build`` is owned by the registering module.  For a smoother it is
    ``build(filt, grid, valid_hw, block_hw, quantize, fuse, boundary,
    tile, interior_split, col_mode) -> step``: the per-chunk step that maps the
    grid's blocks to the blocks ``fuse`` iterations later; for a transfer
    operator ``build(grid_shape, valid_hw, block_hw, boundary) -> op``
    over the fine level's blocks (rank 3: ``build(grid_shape, depth,
    valid_hw, block_hw, boundary)``, ``solvers/transfer.py``); for a
    rank-3 form ``build(grid_shape, depth, valid_hw, block_hw, fuse,
    boundary) -> step`` over the stacked grid (``volumes/forms.py``).
    """

    name: str
    rank: int = 2
    stencil_form: str = "smooth"
    boundaries: tuple[str, ...] = ("zero", "periodic")
    overlap_capable: bool = False
    persistent_capable: bool = False
    build: Callable | None = None

    def __post_init__(self) -> None:
        if self.stencil_form not in STENCIL_FORMS:
            raise ValueError(
                f"stencil_form must be one of {STENCIL_FORMS}, got "
                f"{self.stencil_form!r}")
        if not self.boundaries:
            raise ValueError(f"form {self.name!r} supports no boundary")


_FORMS: dict[tuple[int, str, str], KernelForm] = {}


def register(form: KernelForm) -> KernelForm:
    """Install ``form`` under one key per supported boundary.  A second
    registration of a key with a different form raises."""
    for bd in form.boundaries:
        key = (form.rank, form.name, bd)
        old = _FORMS.get(key)
        if old is not None and old != form:
            raise ValueError(f"kernel form {key} already registered")
        _FORMS[key] = form
    return form


def _ensure_default_forms() -> None:
    """Import the modules that register the default forms (idempotent), so
    resolution works in any import order."""
    from parallel_convolution_tpu_torch.parallel import step  # noqa: F401
    from parallel_convolution_tpu_torch.solvers import transfer  # noqa: F401
    from parallel_convolution_tpu_torch.volumes import forms  # noqa: F401


def resolve(rank: int, name: str, boundary: str) -> KernelForm:
    """The form for ``(rank, name, boundary)``; raises ``ValueError``
    naming the registered forms when there is none."""
    key = (int(rank), str(name), str(boundary))
    if key not in _FORMS:
        _ensure_default_forms()
    form = _FORMS.get(key)
    if form is None:
        names = sorted({k[1] for k in _FORMS if k[0] == key[0]})
        raise ValueError(
            f"no kernel form registered for rank={key[0]} name={key[1]!r} "
            f"boundary={key[2]!r}; registered rank-{key[0]} forms: {names}")
    return form


def registered_keys(stencil_form: str | None = None) -> frozenset:
    """The registered ``(rank, name, boundary)`` keys, of one stencil form
    when given."""
    _ensure_default_forms()
    return frozenset(k for k, f in _FORMS.items()
                     if stencil_form is None or f.stencil_form == stencil_form)


def _capable(name: str, rank: int, bit: str) -> bool:
    _ensure_default_forms()
    for bd in ("zero", "periodic"):
        form = _FORMS.get((int(rank), str(name), bd))
        if form is not None:
            return getattr(form, bit)
    return False


def overlap_capable(name: str, rank: int = 2) -> bool:
    """Whether ``name``'s form has an interior-first overlapped halo
    pipeline.  Unknown names are not capable."""
    return _capable(name, rank, "overlap_capable")


def persistent_capable(name: str, rank: int = 2) -> bool:
    """Whether ``name`` moves column slabs between slots (``col_mode``
    selects how).  Unknown names are not capable."""
    return _capable(name, rank, "persistent_capable")


def clamp_overlap(overlap, name: str, rank: int = 2) -> bool:
    """The one overlap-legality clamp: a resolved or degraded backend keeps
    ``overlap=True`` only if its form is overlap-capable."""
    return bool(overlap) and overlap_capable(name, rank)
