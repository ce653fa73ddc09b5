"""Numeric-safety tooling (the JAX package's ``utils/debug.py``).

The sanitizer tier guards one failure class: numeric corruption — NaN/Inf
escaping a kernel, or u8-mode values leaving [0, 255].

* :func:`checked_correlate` — one stencil step whose output is checked
  for NaN/Inf (``torch.isfinite``), raising instead of letting a
  non-finite value propagate.  The JAX package compiles the check in with
  ``checkify``; here it is an explicit check on the step's output, which
  raises the same class of error: ``ValueError`` (``checkify``'s
  ``JaxRuntimeError`` is one).
* :func:`assert_u8_range` / :func:`find_nonfinite` — host-side validators
  used by tests and when debugging.
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_convolution_tpu_torch.ops import conv
from parallel_convolution_tpu_torch.ops.filters import Filter


class NonFiniteError(ValueError):
    """A stencil step produced NaN or Inf."""


def checked_correlate(x, filt: Filter) -> torch.Tensor:
    """One zero-padded stencil step of a (C, H, W) tensor (or array) with
    a NaN/Inf check on the output.

    Returns the output; raises :class:`NonFiniteError` naming the first
    non-finite value if the input (or filter) produced one.
    """
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    out = conv.correlate_shifted(x, filt)
    bad = ~torch.isfinite(out)
    if bool(bad.any()):
        idx = tuple(int(i) for i in torch.nonzero(bad)[0])
        raise NonFiniteError(
            f"non-finite value in stencil output: {float(out[idx])!r} at "
            f"{idx}")
    return out


def assert_u8_range(arr) -> None:
    """Validate the u8-mode invariant: exact integers in [0, 255]."""
    a = _numpy(arr)
    if a.size == 0:
        return
    bad = ~((a >= 0) & (a <= 255) & (a == np.rint(a)))
    if bad.any():
        idx = tuple(int(i) for i in np.argwhere(bad)[0])
        raise AssertionError(
            f"u8-mode invariant violated at {idx}: value {a[bad][0]!r}"
        )


def find_nonfinite(arr) -> list[tuple]:
    """Indices (up to 10) of NaN/Inf values, for post-mortem debugging."""
    a = _numpy(arr)
    return [tuple(int(i) for i in ix) for ix in np.argwhere(~np.isfinite(a))[:10]]


def _numpy(arr) -> np.ndarray:
    """A host array of a tensor (bf16 widened exactly to f32) or array."""
    if torch.is_tensor(arr):
        t = arr.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return np.asarray(arr)
