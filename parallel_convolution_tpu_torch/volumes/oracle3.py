"""Independent numpy oracle of the rank-3 forms (the port's own copy of the
JAX package's ``volumes/oracle3.py``).

Not a port of ``volumes/forms.py``: ghosts come from ``np.pad`` on the
GLOBAL volume (no blocks, no exchange), neighbour taps from slices of the
padded cube, and the FD sums run in float64 before rounding back, so
agreement with the blocked float32 path within a tolerance is evidence,
not tautology.  Byte identity is claimed only between the port's forms.
"""

from __future__ import annotations

import numpy as np

from parallel_convolution_tpu_torch.utils.config import VOLUME_RADII

__all__ = ["oracle_step", "pad_global", "run_oracle"]

_FD_COEFFS = {
    "fd7": (1.0,),
    "fd25": (8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0),
}
_FD_DIAG = {"fd7": 6.0, "fd25": 205.0 / 24.0}
# The _stack twins are the same operator.
_FD_COEFFS["fd7_stack"] = _FD_COEFFS["fd7"]
_FD_COEFFS["fd25_stack"] = _FD_COEFFS["fd25"]
_FD_DIAG["fd7_stack"] = _FD_DIAG["fd7"]
_FD_DIAG["fd25_stack"] = _FD_DIAG["fd25"]
# The wide star needs damped Jacobi (forms.FD25_OMEGA); fd7 is plain.
_FD_OMEGA = {"fd25": 0.8, "fd25_stack": 0.8}


def pad_global(vol: np.ndarray, r: int, boundary: str) -> np.ndarray:
    """Ghost-pad a GLOBAL (F, D, H, W) volume by r on all six faces."""
    mode = "wrap" if boundary == "periodic" else "constant"
    return np.pad(vol, ((0, 0), (r, r), (r, r), (r, r)), mode=mode)


def _nbr(p: np.ndarray, r: int, axis: int, k: int) -> np.ndarray:
    """Interior view of padded field ``p`` shifted by k (signed) along
    ``axis`` (1 = D, 2 = H, 3 = W of the (B, D+2r, H+2r, W+2r) cube)."""
    sl = [slice(None)] + [slice(r, s - r) for s in p.shape[1:]]
    sl[axis] = slice(r + k, p.shape[axis] - r + k)
    return p[tuple(sl)]


def _lap7(p: np.ndarray, r: int) -> np.ndarray:
    cc = tuple([slice(None)] + [slice(r, s - r) for s in p.shape[1:]])
    s = np.zeros_like(p[cc], dtype=np.float64)
    for ax in (1, 2, 3):
        for k in (-1, 1):
            s += _nbr(p, r, ax, k)
    return s - 6.0 * p[cc]


def oracle_step(state: np.ndarray, name: str,
                boundary: str = "zero") -> np.ndarray:
    """One global application of rank-3 form ``name`` on a (2, D, H, W),
    or batched (2B, D, H, W) with the fields interleaved, float array."""
    from parallel_convolution_tpu_torch.volumes.forms import (
        GS_PARAMS, WAVE_C2DT2,
    )

    r = VOLUME_RADII[name]
    a = np.asarray(state, np.float64)
    u, f = a[0::2], a[1::2]
    pu = pad_global(u, r, boundary)
    if name in _FD_COEFFS:
        coeffs, diag = _FD_COEFFS[name], _FD_DIAG[name]
        acc = f.astype(np.float64).copy()
        for k in range(1, r + 1):
            for ax in (1, 2, 3):
                acc += coeffs[k - 1] * (_nbr(pu, r, ax, -k)
                                        + _nbr(pu, r, ax, k))
        u_jac = acc / diag
        om = _FD_OMEGA.get(name)
        out = np.stack(
            [u_jac if om is None else u + om * (u_jac - u), f], axis=1)
    elif name == "wave":
        u_next = 2.0 * u - f + WAVE_C2DT2 * _lap7(pu, r)
        out = np.stack([u_next, u], axis=1)
    elif name == "grayscott":
        du, dv, feed, kill, dt = GS_PARAMS
        pv = pad_global(f, r, boundary)
        uvv = u * f * f
        u_new = u + (du * _lap7(pu, r) - uvv + feed * (1.0 - u)) * dt
        v_new = f + (dv * _lap7(pv, r) + uvv - (feed + kill) * f) * dt
        out = np.stack([u_new, v_new], axis=1)
    else:
        raise ValueError(f"unknown rank-3 form {name!r}")
    return out.reshape(a.shape).astype(np.float32)


def run_oracle(state: np.ndarray, name: str, iters: int,
               boundary: str = "zero") -> np.ndarray:
    """``iters`` sequential global applications (no fusion)."""
    s = np.asarray(state, np.float32)
    for _ in range(int(iters)):
        s = oracle_step(s, name, boundary)
    return s
