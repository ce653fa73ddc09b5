"""The plain reference of the benchmark: plain PyTorch, written from the
semantics the configurations state, importing nothing but torch.

* :func:`iterate_u8`: ``iters`` iterations of a k×k filter with the u8
  store-back (``clip(rint(acc), 0, 255)``, half to even) over windows of
  an image, every position outside the image zero at every level (the
  reference program's zero ghost ring).  A window carries an apron of
  ``radius * iters`` positions on each side, so its centre is exact.
  Every product and partial sum of a dyadic filter (blur3's taps are
  1/16, 2/16 and 4/16) on u8 values is exact in float32, so the order of
  the sums does not change a byte.
* :func:`vcycle_solve`: the geometric V-cycle of BASELINE config 5 on one
  block with a zero boundary, written from its definition: damped Jacobi
  (ω = 0.8) with V(2, 2) sweeps and 16 on the coarsest level, full
  weighting restriction of the residual times 4, bilinear prolongation,
  odd-centred coarse grids of extent ``(n - 1) // 2``, every level padded
  to even blocks while a coarser one follows, down to an extent of 8, a
  block of 8 or 12 levels; the stopping rule is the max-abs change of
  one undamped fine sweep, read after every cycle, against the
  tolerance, within a budget of fine-grid work units.

``dtype`` is the precision of the arithmetic: float32 as the
configurations state, or a lower one for the control.  TF32 plays no
part: nothing here multiplies matrices.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


def taps(spec: dict) -> torch.Tensor:
    """A configuration's filter as a (k, k) float64 tensor: ``taps`` over
    ``divisor``."""
    t = torch.tensor(spec["taps"], dtype=torch.float64)
    return t / float(spec.get("divisor", 1))


def correlate_same(u: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Cross-correlation of the last two axes of ``u`` with the (k, k)
    taps ``t``, positions beyond ``u`` read as 0; same shape as ``u``, in
    ``u``'s dtype (each tap's product rounded, then added)."""
    k = t.shape[0]
    r = (k - 1) // 2
    out = torch.zeros_like(u)
    H, W = u.shape[-2:]
    for dy in range(k):
        for dx in range(k):
            tap = float(t[dy, dx])
            if tap == 0.0:
                continue
            sy, sx = dy - r, dx - r
            dst = out[..., max(0, -sy):H - max(0, sy),
                      max(0, -sx):W - max(0, sx)]
            src = u[..., max(0, sy):H - max(0, -sy),
                    max(0, sx):W - max(0, -sx)]
            dst += src * tap
    return out


def iterate_u8(windows: torch.Tensor, inside: torch.Tensor,
               t: torch.Tensor, iters: int, apron: int,
               dtype=torch.float32) -> torch.Tensor:
    """``iters`` u8 iterations of windows (N, C, h + 2a, w + 2a) u8 whose
    positions outside the image are 0, ``inside`` (N, 1, h + 2a, w + 2a)
    saying which lie in the image; returns the (N, C, h, w) u8 centres.
    ``apron`` a = 0 takes each window as a whole image."""
    mask = inside.to(dtype)
    cur = windows.to(dtype)
    for _ in range(int(iters)):
        acc = correlate_same(cur, t)
        cur = torch.clamp(torch.round(acc), 0.0, 255.0) * mask
    a = int(apron)
    if a:
        cur = cur[..., a:-a, a:-a]
    return cur.to(torch.uint8)


# -- the V-cycle --------------------------------------------------------------

NU_PRE, NU_POST, NU_COARSE = 2, 2, 16
OMEGA = 0.8
COARSE_FACTOR = 4.0
MIN_EXTENT = 8
MAX_LEVELS = 12
# A coarse level whose block would be under this is not made: the level
# before it is the coarsest.
BLOCK_FLOOR = 8
FULL_WEIGHTING = torch.tensor([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0],
                               [1.0, 2.0, 1.0]], dtype=torch.float64) / 16.0


def plan_levels(valid_hw, radius: int) -> list[tuple[tuple, tuple]]:
    """(valid extent, block) of every level, finest first."""
    levels = []
    valid = (int(valid_hw[0]), int(valid_hw[1]))
    for idx in range(MAX_LEVELS):
        more = (idx + 1 < MAX_LEVELS and min(valid) > MIN_EXTENT
                and min(valid) >= 2 * max(1, radius))
        m = 2 if more else 1
        block = tuple(-(-v // m) * m for v in valid)
        if idx and min(block) < BLOCK_FLOOR:
            more, block = False, valid
            if min(block) < BLOCK_FLOOR:
                break
        levels.append((valid, block))
        if not more:
            break
        valid = ((valid[0] - 1) // 2, (valid[1] - 1) // 2)
    return levels


def _fit(x: torch.Tensor, valid, block) -> torch.Tensor:
    """``x`` cropped to ``valid`` and zero-padded to ``block``."""
    x = x[..., :valid[0], :valid[1]]
    return F.pad(x, (0, block[1] - valid[1], 0, block[0] - valid[0]))


def _masked(x: torch.Tensor, valid) -> torch.Tensor:
    """``x`` with every position beyond ``valid`` set to 0, in place."""
    x[..., valid[0]:, :] = 0
    x[..., :, valid[1]:] = 0
    return x


def _restrict(x: torch.Tensor, cvalid) -> torch.Tensor:
    """Full weighting of an even block onto half of it, coarse k centred
    on fine 2k + 1; beyond ``cvalid`` 0."""
    p = F.pad(x, (1, 1, 1, 1))
    ch, cw = x.shape[-2] // 2, x.shape[-1] // 2
    acc = torch.zeros((*x.shape[:-2], ch, cw), dtype=x.dtype,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += p[..., 1 + dy:1 + dy + 2 * ch:2,
                     1 + dx:1 + dx + 2 * cw:2] * float(FULL_WEIGHTING[dy, dx])
    return _masked(acc, cvalid)


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    shape = list(a.shape)
    shape[axis] *= 2
    return torch.stack([a, b], dim=axis % a.dim() + 1).reshape(shape)


def _prolong(c: torch.Tensor, valid) -> torch.Tensor:
    """Bilinear prolongation of a (m, n) coarse block to (2m, 2n): fine
    2k + 1 takes coarse k, fine 2k the mean of coarse k - 1 and k (coarse
    -1 reads 0); beyond ``valid`` 0."""
    m, n = c.shape[-2:]
    p = F.pad(c, (1, 1, 1, 1))
    a, b = p[..., 0:m, :], p[..., 1:m + 1, :]
    rows = _interleave((a + b) * 0.5, b, -2)
    al, bl = rows[..., 0:n], rows[..., 1:n + 1]
    return _masked(_interleave((al + bl) * 0.5, bl, -1).contiguous(), valid)


@dataclasses.dataclass
class Solve:
    """What a solve gives: the field at its valid extent, the cycles, the
    residual after each cycle, and whether it reached the tolerance."""

    field: torch.Tensor
    cycles: int
    residuals: list
    converged: bool


def vcycle_solve(x: torch.Tensor, t: torch.Tensor, tol: float,
                 max_work_units: float, dtype=torch.float32) -> Solve:
    """The V-cycle from the (C, H, W) field ``x`` until the residual is
    under ``tol`` or the work-unit budget is spent."""
    k = t.shape[0]
    radius = (k - 1) // 2
    levels = plan_levels(x.shape[-2:], radius)
    last = len(levels) - 1
    area0 = levels[0][0][0] * levels[0][0][1]
    w = [v[0] * v[1] / area0 for v, _ in levels]
    wu_cycle = ((NU_PRE + NU_POST) * w[0] if last == 0 else
                sum((NU_COARSE if i == last else NU_PRE + NU_POST + 2) * wi
                    for i, wi in enumerate(w)))

    def S(u, i):
        return _masked(correlate_same(u, t), levels[i][0])

    def damp(v, s):
        out = OMEGA * s
        out += (1.0 - OMEGA) * v
        return out

    def half(i):
        return (levels[i][1][0] // 2, levels[i][1][1] // 2)

    def smooth_rhs(e, r, i, n):
        for _ in range(n):
            e = damp(e, S(e, i) + r)
        return e

    def down(i, rc):
        return _fit(rc, levels[i + 1][0], levels[i + 1][1])

    def cvalid(i):
        return levels[i + 1][0]

    u = _fit(x.to(dtype), levels[0][0], levels[0][1])
    cycles, wu, diff, residuals = 0, 0.0, float("inf"), []
    while wu < float(max_work_units) and diff >= tol:
        if last == 0:
            for _ in range(NU_PRE + NU_POST - 1):
                u = damp(u, S(u, 0))
        else:
            for _ in range(NU_PRE):
                u = damp(u, S(u, 0))
            rs = {1: down(0, COARSE_FACTOR * _restrict(S(u, 0) - u,
                                                      cvalid(0)))}
            es = {}
            for i in range(1, last):
                es[i] = smooth_rhs(torch.zeros_like(rs[i]), rs[i], i, NU_PRE)
                rs[i + 1] = down(i, COARSE_FACTOR * _restrict(
                    S(es[i], i) + rs[i] - es[i], cvalid(i)))
            e = smooth_rhs(torch.zeros_like(rs[last]), rs[last], last,
                           NU_COARSE)
            for i in range(last - 1, 0, -1):
                e = es.pop(i) + _prolong(_fit(e, levels[i + 1][0], half(i)),
                                         levels[i][0])
                e = smooth_rhs(e, rs.pop(i), i, NU_POST)
            u = u + _prolong(_fit(e, levels[1][0], half(0)), levels[0][0])
            del e
            for _ in range(NU_POST - 1):
                u = damp(u, S(u, 0))
        su = S(u, 0)
        diff = float((su - u).abs().max())
        u = damp(u, su)
        del su
        residuals.append(diff)
        cycles += 1
        wu += wu_cycle
    vh, vw = levels[0][0]
    return Solve(u[..., :vh, :vw], cycles, residuals, diff < tol)
