"""How parameters and state cross between the JAX package and the port.

Both sides speak numpy at the boundary: a filter is its name, its (k, k)
float32 taps and its dyadic flag; an image state is a global planar
(C, H, W) array.  These helpers turn those into the port's objects and back,
so a test (or a user moving a run) can feed the same data to both.
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_convolution_tpu_torch.ops.filters import Filter
from parallel_convolution_tpu_torch.parallel.mesh import Grid, join_blocks
from parallel_convolution_tpu_torch.parallel.step import _prepare


def filter_from_numpy(name: str, taps, dyadic: bool = False) -> Filter:
    """A port :class:`Filter` from numpy taps (e.g. a JAX ``Filter``'s
    ``name``, ``taps`` and ``dyadic``)."""
    return Filter(name=name, taps=np.asarray(taps, dtype=np.float32),
                  dyadic=bool(dyadic))


def blocks_from_numpy(global_chw: np.ndarray, grid: Grid,
                      storage: str = "f32") -> list[list[torch.Tensor]]:
    """Cut a global (C, H, W) array into the grid's blocks on its device, in
    the storage dtype, padded with zeros to block multiples (the layout
    ``parallel.step.iterate_prepared`` takes)."""
    return _prepare(np.asarray(global_chw), grid, storage)[0]


def to_numpy(blocks: list[list[torch.Tensor]], valid_hw=None) -> np.ndarray:
    """The global (C, H, W) array of a grid's blocks, cropped to
    ``valid_hw`` when given.  f32 and u8 states keep their dtype; bf16
    widens exactly to float32 (numpy has no bfloat16)."""
    full = join_blocks(blocks)
    if valid_hw is not None:
        full = full[:, :valid_hw[0], :valid_hw[1]]
    if full.dtype == torch.bfloat16:
        full = full.to(torch.float32)
    return full.cpu().numpy()


def jacobi_solver_from_reference(fields: dict, device=None):
    """The port's :class:`~parallel_convolution_tpu_torch.models.JacobiSolver`
    from the JAX ``JacobiSolver``'s fields given as plain values.

    ``fields`` holds the JAX dataclass's field names: ``filt`` as a
    registry name or a ``(name, taps, dyadic)`` triple with numpy taps,
    ``mesh`` as an ``(R, C)`` grid shape (or None for 1×1), ``backend`` by
    its JAX name (``pallas`` -> ``cuda``, ...); every other field as its
    value, ``solver`` and ``mg_levels`` included (a multigrid solver comes
    across as one).  The grid lives on ``device`` (default: the card).
    """
    from parallel_convolution_tpu_torch.models import JacobiSolver
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils.config import (
        BACKEND_FROM_REFERENCE,
    )

    kw = dict(fields)
    filt = kw.pop("filt", "jacobi3")
    if not isinstance(filt, str):
        filt = filter_from_numpy(*filt)
    mesh = kw.pop("mesh", None)
    backend = kw.pop("backend", "shifted")
    return JacobiSolver(
        filt=filt, grid=make_grid(None if mesh is None else tuple(mesh),
                                  device),
        backend=BACKEND_FROM_REFERENCE.get(backend, backend), **kw)


def run_config_from_reference(text_or_dict):
    """The port's ``utils.config.RunConfig`` from a JAX ``RunConfig``: its
    ``to_json()`` text or the parsed dict, field for field, the backend
    mapped to the port's name (``pallas`` -> ``cuda``, ...)."""
    import json

    from parallel_convolution_tpu_torch.utils.config import (
        BACKEND_FROM_REFERENCE, RunConfig,
    )

    fields = (json.loads(text_or_dict) if isinstance(text_or_dict, str)
              else dict(text_or_dict))
    backend = fields.get("backend", "shifted")
    fields["backend"] = BACKEND_FROM_REFERENCE.get(backend, backend)
    return RunConfig(**fields)
