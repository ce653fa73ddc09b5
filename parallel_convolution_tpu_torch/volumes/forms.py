"""Rank-3 kernel forms: FD Laplacian smoothers and time-dependent physics
(the JAX package's ``volumes/forms.py``, in plain PyTorch).

Every rank-3 form works on TWO stacked fields:

* ``fd7`` / ``fd25`` — ``(u, f)``: a Jacobi sweep of ``-∇²u = f`` (``f``
  scaled by h² by the caller).  ``fd7`` is the 7-point star, ``fd25`` the
  8th-order 25-point star (per-axis taps at distance k: 8/5, -1/5, 8/315,
  -1/560; diagonal 205/24), damped by ω = 0.8;
* ``wave`` — ``(u, u_prev)``: the leapfrog ``u_next = 2u − u_prev +
  c²dt²·∇²₇u``;
* ``grayscott`` — ``(U, V)``: Gray–Scott reaction–diffusion through the
  7-point Laplacian.

``fd7_stack`` / ``fd25_stack`` are byte-identity twins: the same weighted
terms added in the same order, routed through one ``torch.stack`` and
re-sliced (every term materialised at once), where the plain forms form
each term as the sum needs it.

Fields are INTERLEAVED on the field axis, field k of volume b at ``2b +
k``.  The forms act on the stacked grid of blocks (R·C, F, D, h, w) at
once, every op elementwise, so the grid shape never changes a bit.  The
float order is the JAX package's: each product by an f32 constant (the
coefficients, ``inv_diag`` = f32(1/diag), ω) rounded, the terms summed
left to right; Gray–Scott's ``feed + kill`` summed in double before it
meets f32.  A multiply by exactly 1.0 (fd7's coefficient) is skipped: it
changes no bit.

The build contract (resolved through ``parallel.kernels``):
``build(grid_shape, depth, valid_hw, block_hw, fuse, boundary) -> step``,
``step`` mapping the stacked (R·C, F, depth, bh, bw) grid to the next:
one 6-face exchange at ghost depth ``radius·fuse``, then ``fuse``
applications, each re-masked as the JAX package's schedule does: the H/W
mask in global coordinates (the image edge and the pad-to-multiple rim),
then the D ghost ring re-zeroed while the ring is non-empty.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from parallel_convolution_tpu_torch.parallel import kernels as kernel_forms
from parallel_convolution_tpu_torch.utils.config import (
    BOUNDARIES, VOLUME_PHYSICS_FORMS, VOLUME_RADII, VOLUME_SMOOTH_FORMS,
)
from parallel_convolution_tpu_torch.volumes import halo3

__all__ = ["FD25_COEFFS", "FD25_DIAG", "FD25_OMEGA", "FD7_COEFFS",
           "FD7_DIAG", "GS_PARAMS", "WAVE_C2DT2", "build_volume_step",
           "form_radius"]

# Per-axis off-centre taps at distance k = 1..r (u_new = (f + Σ c_k ·
# neighbours) / diag) and the star's diagonal.
FD7_COEFFS = (1.0,)
FD7_DIAG = 6.0
FD25_COEFFS = (8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0)
FD25_DIAG = 205.0 / 24.0
# The 25-point star diverges undamped (its mixed-sign taps pass the
# diagonal at high frequency); ω = 0.8 bounds every mode below 1.
FD25_OMEGA = 0.8
# Wave leapfrog Courant factor c²dt²/h², inside the 3D CFL bound (1/3).
WAVE_C2DT2 = 0.2
# Gray–Scott (Du, Dv, F, k, dt): the classic "solitons" spot.
GS_PARAMS = (0.16, 0.08, 0.060, 0.062, 1.0)


def _f32(v: float) -> float:
    """A Python float holding the float32 value of ``v`` (the JAX
    package's ``jnp.float32`` constants): exact when it meets f32."""
    return float(np.float32(v))


def form_radius(name: str) -> int:
    """Ghost radius of one application of a registered rank-3 form."""
    return VOLUME_RADII[name]


def _split(p):
    """Interleaved fields of (N, 2B, ...) → two (N, B, ...) views."""
    return p[:, 0::2], p[:, 1::2]


def _merge(a, b):
    """Re-interleave two (N, B, ...) fields → (N, 2B, ...)."""
    out = a.new_empty((a.shape[0], 2 * a.shape[1], *a.shape[2:]))
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _center(u, r: int):
    """The interior crop of a padded (N, B, d, h, w) field at radius r."""
    return (Ellipsis,) + tuple(slice(r, s - r) for s in u.shape[-3:])


def _star_views(u, r: int):
    """Cropped shifted views of padded ``u`` in the fixed order: for k =
    1..r, for axis D, H, W, the −k then the +k view.  Every form sums in
    exactly this order."""
    views = []
    for k in range(1, r + 1):
        for ax in (-3, -2, -1):
            lo = list(_center(u, r))
            hi = list(_center(u, r))
            n = u.shape[ax]
            lo[ax] = slice(r - k, n - r - k)
            hi[ax] = slice(r + k, n - r + k)
            views.append(u[tuple(lo)])
            views.append(u[tuple(hi)])
    return views


def _weighted_sum(first, weighted, stacked: bool):
    """``first + c1·v1 + c2·v2 + ...`` left to right, each product rounded
    to f32 before its add.  The plain arm forms each product as the sum
    needs it (one scratch field); the ``stacked`` arm materialises every
    term, stacks them and re-slices: a different program, the same adds
    in the same association."""
    if stacked:
        st = torch.stack([first] + [c * v for c, v in weighted])
        s = st[0]
        for i in range(1, st.shape[0]):
            s = s + st[i]
        return s
    s = tmp = None
    for c, v in weighted:
        if c == 1.0:
            t = v
        else:
            tmp = torch.mul(v, c, out=tmp if tmp is not None
                            else torch.empty_like(first))
            t = tmp
        s = first + t if s is None else s.add_(t)
    return s


def _jacobi_apply(p, r: int, coeffs, inv_diag: float, stacked: bool,
                  omega: float | None = None):
    """One (damped) Jacobi sweep of an FD star: (u, f) interleaved, padded
    by r on (D, H, W) → the interleaved interior: ``s·inv_diag``, or
    ``u + ω(s·inv_diag − u)`` with ``s = f + Σ c_k·neighbours``."""
    u, f = _split(p)
    cc = _center(u, r)
    views = _star_views(u, r)
    weighted = [(coeffs[k - 1], views[(k - 1) * 6 + i])
                for k in range(1, r + 1) for i in range(6)]
    s = _weighted_sum(f[cc], weighted, stacked)
    if omega is None:
        return _merge(s * inv_diag, f[cc])
    jac = s * inv_diag
    return _merge(u[cc] + omega * (jac - u[cc]), f[cc])


def _lap7(u, cc):
    """7-point Laplacian of a padded (N, B, d, h, w) field at its
    interior: the fixed-order neighbour sum minus 6·centre."""
    views = _star_views(u, 1)
    s = views[0] + views[1]
    for v in views[2:]:
        s.add_(v)
    return s - 6.0 * u[cc]


def _wave_apply(p):
    """Leapfrog: (u, u_prev) → (2u − u_prev + c²dt²·∇²u, u)."""
    u, v = _split(p)
    cc = _center(u, 1)
    u_next = (2.0 * u[cc] - v[cc]) + WAVE_C2DT2 * _lap7(u, cc)
    return _merge(u_next, u[cc])


def _gs_apply(p):
    """Gray–Scott: (U, V) coupled through the 7-point Laplacian."""
    du, dv, feed, kill, dt = GS_PARAMS
    ua, va = _split(p)
    cc = _center(ua, 1)
    uc, vc = ua[cc], va[cc]
    uvv = uc * vc * vc
    u_new = uc + (du * _lap7(ua, cc) - uvv + feed * (1.0 - uc)) * dt
    v_new = vc + (dv * _lap7(va, cc) + uvv - (feed + kill) * vc) * dt
    return _merge(u_new, v_new)


_APPLY = {
    "fd7": functools.partial(_jacobi_apply, r=1, coeffs=FD7_COEFFS,
                             inv_diag=_f32(1.0 / FD7_DIAG), stacked=False),
    "fd7_stack": functools.partial(_jacobi_apply, r=1, coeffs=FD7_COEFFS,
                                   inv_diag=_f32(1.0 / FD7_DIAG),
                                   stacked=True),
    "fd25": functools.partial(_jacobi_apply, r=4, coeffs=FD25_COEFFS,
                              inv_diag=_f32(1.0 / FD25_DIAG), stacked=False,
                              omega=_f32(FD25_OMEGA)),
    "fd25_stack": functools.partial(_jacobi_apply, r=4, coeffs=FD25_COEFFS,
                                    inv_diag=_f32(1.0 / FD25_DIAG),
                                    stacked=True, omega=_f32(FD25_OMEGA)),
    "wave": _wave_apply,
    "grayscott": _gs_apply,
}


def _valid_mask3(valid_hw, block_hw, grid_shape, margin: int, device):
    """Globally-in-volume cells of every block's (H, W) plane, extended by
    ``margin``, as the stacked (R·C, 1, 1, h+2m, w+2m) f32 mask (the JAX
    package's ``_valid_mask3``).  D never pads to a multiple, so depth
    needs no global mask: the ghost-ring re-zero takes its boundary."""
    from parallel_convolution_tpu_torch.parallel.step import _valid_mask

    R, Cg = grid_shape
    return torch.stack([
        _valid_mask(valid_hw, block_hw, (i, j), margin, device)
        for i in range(R) for j in range(Cg)])[:, None]


def build_volume_step(name: str, grid_shape, depth: int, valid_hw, block_hw,
                      fuse: int, boundary: str, per_block: bool = False,
                      grid=None):
    """The registered build: one chunk step of form ``name``.

    ``step`` maps the stacked (R·C, F, depth, bh, bw) grid to the same
    shape: one 6-face exchange at ghost depth ``radius·fuse``, then
    ``fuse`` applications, after each of which (zero boundary) the H/W
    mask in global coordinates re-zeroes the image edge and the
    pad-to-multiple rim, and the D ghost ring, while non-empty, is
    re-zeroed (the JAX package's crop and re-pad); periodic wraps exactly
    and never masks.  Raises the JAX ``ValueError`` when the ghost depth
    exceeds the block.  ``per_block`` (a grid of slots): ``step`` maps the
    R×C list of (F, depth, bh, bw) blocks to the next, each stepped on its
    slot's device after the per-block exchange
    (``halo3.volume_exchange_per_block``), the same ops on each, so the
    same values; ``grid`` (with ``per_block``) is the grid, whose faces
    between ranks cross by ``multihost.swap`` where it spans several
    processes (each rank holding its share of the blocks).
    """
    r = form_radius(name)
    fuse = max(1, int(fuse))
    d = r * fuse
    bh, bw = (int(b) for b in block_hw)
    depth = int(depth)
    if bh < d or bw < d:
        raise ValueError(
            f"form {name!r} at fuse={fuse} needs ghost depth {d} <= "
            f"block ({bh}, {bw}); shrink fuse or the mesh")
    R, Cg = (int(g) for g in grid_shape)
    periodic = boundary == "periodic"
    apply_fn = _APPLY[name]
    needs_mask = (not periodic) and (
        valid_hw[0] < bh * R or valid_hw[1] < bw * Cg)
    masks: dict = {}

    def mask(margin, device):
        key = (margin, device)
        if key not in masks:
            masks[key] = _valid_mask3(valid_hw, (bh, bw), (R, Cg), margin,
                                      device)
        return masks[key]

    def levels(p, mask_of):
        for t in range(fuse):
            margin = d - r * (t + 1)
            p = apply_fn(p)
            if not periodic and (needs_mask or margin > 0):
                p.mul_(mask_of(margin, p.device))
                if margin > 0:
                    # The zero D faces of the shrinking ghost ring.
                    p[:, :, :margin] = 0
                    p[:, :, margin + depth:] = 0
        return p

    def step(x):
        return levels(halo3.volume_halo_exchange(x, d, (R, Cg), boundary),
                      mask)

    if not per_block:
        return step
    from parallel_convolution_tpu_torch.parallel.step import _valid_mask

    def block_mask(index):
        def mask_of(margin, device):
            key = (index, margin, device)
            if key not in masks:
                masks[key] = _valid_mask(valid_hw, (bh, bw), index, margin,
                                         device)[None, None]
            return masks[key]
        return mask_of

    def step_blocks(blocks):
        padded = halo3.volume_exchange_per_block(blocks, d, (R, Cg),
                                                 boundary, grid=grid)
        # Each block as a stack of one: the forms act on (N, F, ...).
        return [[None if p is None else levels(p[None], block_mask((i, j)))[0]
                 for j, p in enumerate(row)] for i, row in enumerate(padded)]

    return step_blocks


def _register_volume_forms() -> None:
    for names, kind in ((VOLUME_SMOOTH_FORMS, "smooth"),
                        (VOLUME_PHYSICS_FORMS, "physics")):
        for name in names:
            kernel_forms.register(kernel_forms.KernelForm(
                name=name, rank=3, stencil_form=kind,
                boundaries=tuple(BOUNDARIES),
                build=functools.partial(build_volume_step, name)))


_register_volume_forms()
