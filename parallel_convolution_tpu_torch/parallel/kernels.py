"""Kernel-form registry: dispatch is a table keyed ``(rank, name,
boundary)``, as in the JAX package's ``parallel/kernels.py``.

This slice registers the smoother forms only (``parallel/step.py``
registers one per backend at import).  Transfer operators, volumes and the
overlap / persistent-channel capability bits come with their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

STENCIL_FORMS = ("smooth",)


@dataclasses.dataclass(frozen=True)
class KernelForm:
    """One registered stencil program family.

    ``build(filt, grid, valid_hw, block_hw, quantize, fuse, boundary,
    tile) -> step`` returns the per-chunk step that maps the grid's blocks
    to the blocks ``fuse`` iterations later.
    """

    name: str
    rank: int = 2
    stencil_form: str = "smooth"
    boundaries: tuple[str, ...] = ("zero", "periodic")
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


def resolve(rank: int, name: str, boundary: str) -> KernelForm:
    """The form for ``(rank, name, boundary)``; raises ``ValueError``
    naming the registered forms when there is none."""
    key = (int(rank), str(name), str(boundary))
    if key not in _FORMS:
        from parallel_convolution_tpu_torch.parallel import step  # noqa: F401
    form = _FORMS.get(key)
    if form is None:
        names = sorted({k[1] for k in _FORMS if k[0] == key[0]})
        raise ValueError(
            f"no kernel form registered for rank={key[0]} name={key[1]!r} "
            f"boundary={key[2]!r}; registered rank-{key[0]} forms: {names}")
    return form
