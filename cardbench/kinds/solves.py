"""Solves: V-cycle solves of seeded normal fields to the configuration's
tolerance, back to back through ``solvers.multigrid.mg_converge``, one
caller, on fields already on the card.  A pool of ``pool`` fields
(``channels`` × ``height`` × ``width`` f32) is made in set-up and solved
in turn.  A solve that stops at the work-unit budget without reaching the
tolerance has failed.

What is checked: one solve of the window drawn from the seed, its field,
its cycles and the residual after each cycle, against
:func:`cardbench.reference.vcycle_solve` of the same field remade from
the seed: ``field_gap`` is the largest difference of the two fields over
the largest magnitude of the reference's, ``residual_gap`` the largest
relative difference of the residuals of a cycle, ``cycles_gap`` the
difference of the cycle counts (:func:`judge`).
"""

from __future__ import annotations

from cardbench import inputs, reference, trace
from cardbench.kinds import (
    Outcome, Reservoir, build_kernels, clock, device_of, memory_peak,
    synchronize,
)


def judge(field, cycles: int, residuals, ref: reference.Solve) -> dict:
    """The compared numbers of a solve against the reference's.  A point
    of the field that is not a finite number differs by the reference's
    whole scale, and a residual that is not one by 100%, so that every
    number stays finite."""
    import math

    import torch

    scale = float(ref.field.abs().max()) or 1.0
    diff = (field.to(torch.float32) - ref.field.to(torch.float32)).abs()
    diff = torch.nan_to_num(diff, nan=scale, posinf=scale, neginf=scale)
    n = min(len(residuals), len(ref.residuals))
    res_gap = max((abs(a - b) / abs(b) if math.isfinite(a) else 1.0
                   for a, b in zip(residuals[:n], ref.residuals[:n]) if b),
                  default=0.0)
    return {"field_gap": float(diff.max()) / scale,
            "residual_gap": res_gap,
            "cycles_gap": abs(int(cycles) - int(ref.cycles))}


def _field(cell, seed: int, index: int, device):
    tr = cell.traffic
    return inputs.normal_field(seed, index, int(tr["channels"]),
                               (int(tr["height"]), int(tr["width"])), device)


def run(cell, seed: int, seconds: float, traced: bool, device=None,
        child=None) -> Outcome:
    import torch

    from parallel_convolution_tpu_torch.ops import stencil
    from parallel_convolution_tpu_torch.ops.filters import get_filter
    from parallel_convolution_tpu_torch.parallel import mesh
    from parallel_convolution_tpu_torch.solvers import multigrid as mg

    cfg, tr = cell.config, cell.traffic
    dev = device_of(device)
    build_kernels(dev)
    grid = mesh.make_grid(tuple(cfg["grid"]), device=dev)
    filt = get_filter(cfg["filter"])
    tol, budget = float(cfg["tol"]), float(cfg["max_work_units"])
    P = int(tr["pool"])
    pool = [_field(cell, seed, p, dev) for p in range(P)]

    def solve(p):
        with trace.span("cardbench.solve"):
            out, res = mg.mg_converge(
                pool[p], filt, tol, budget, grid=grid, quantize=False,
                backend=cfg["backend"], storage=cfg["storage"],
                boundary=cfg["boundary"])
            synchronize(dev)
        return out, res

    solve(0)  # warm-up: the first solve loads the kernels
    kept = Reservoir(1, inputs.key(seed, 0x501E))
    cycles, failed = [], 0
    stencil.reset_launch_counts()
    with trace.Window(traced) as win:
        start = clock()
        while True:
            p = len(cycles) % P
            out, res = solve(p)
            cycles.append(res.cycles)
            failed += not res.converged
            kept.offer((p, out, res))
            del out
            if clock() - start >= seconds:
                break
        elapsed = clock() - start
    launches = stencil.launch_counts()
    peak = memory_peak(dev)
    del pool
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    (p, field, res), = kept.items
    ref = reference.vcycle_solve(_field(cell, seed, p, dev),
                                 reference.taps(cfg), tol, budget)
    got = judge(field, res.cycles, res.residuals, ref)
    limits = cfg["limits"]
    solves = len(cycles)
    ctx = {"trace": win.summary, "launches": launches, "jobs": solves,
           "cycles": cycles}
    return Outcome(
        attempted=solves, failed=failed,
        end_to_end={"solve_s": elapsed / solves},
        checks={k: (v, limits[k]) for k, v in got.items()},
        ctx=ctx, memory_peak_bytes=peak, cards=1, window_start=start,
        notes=[f"solves {solves} in {elapsed:.6f} s; cycles {cycles}; "
               f"checked solve of field {p}: cycles {res.cycles} "
               f"(reference {ref.cycles}), residual {res.residual!r}"])


def control(cell, seed: int, device) -> dict:
    """The control's readings: the reference's V-cycle in bfloat16 in the
    program's place, on pool field 0."""
    import torch

    cfg = cell.config
    x = _field(cell, seed, 0, device)
    args = (reference.taps(cfg), float(cfg["tol"]),
            float(cfg["max_work_units"]))
    ref = reference.vcycle_solve(x, *args)
    low = reference.vcycle_solve(x, *args, dtype=torch.bfloat16)
    return judge(low.field, low.cycles, low.residuals, ref)
