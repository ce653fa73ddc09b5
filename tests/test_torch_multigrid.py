"""The port's multigrid (``solvers/transfer.py``, ``solvers/multigrid.py``,
the solver knob of ``parallel/step.py``, ``models/jacobi.py``,
``utils/bench.py`` and the CLI) against the JAX package, on the CPU.

The same numpy-seeded inputs go through both: the JAX package on its
forced 8-device CPU mesh with the ``shifted`` backend, the port on
``make_grid(shape, "cpu")``.  The transfer operators are also held against
independent NumPy loop formulas.  Float tolerance: the port's plain path
rounds every tap twice, XLA's fused loops may contract a multiply and an
add into one rounding, so fields agree within ``multigrid.float_tolerance``
(``ops/stencil.float_tolerance`` over the fine-level stencil applications,
scaled to max |field| of the reference at that cycle, not to 255) and
residuals within ``1 + L1(taps)`` times that; the cycle counts are
equal.  Within one backend the port is bitwise grid-invariant.  The
V-cycle on the card's kernels is held bit for bit against the card's
``shifted`` run (jacobi3's taps and the transfers' weights are dyadic) in
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import json

import jax
import numpy as np
import pytest
import torch

from parallel_convolution_tpu import cli as jcli
from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.parallel import kernels as jkernels
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.solvers import multigrid as jmg
from parallel_convolution_tpu.tuning import costmodel as jcost
from parallel_convolution_tpu.utils import bench as jbench
from parallel_convolution_tpu.utils.jax_compat import shard_map
from parallel_convolution_tpu_torch.cli import main as cli_main
from parallel_convolution_tpu_torch.models import JacobiSolver
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import kernels, mesh, step
from parallel_convolution_tpu_torch.solvers import multigrid as mg
from parallel_convolution_tpu_torch.solvers import transfer
from parallel_convolution_tpu_torch.tuning import costmodel
from parallel_convolution_tpu_torch.utils import bench, imageio
from parallel_convolution_tpu_torch.utils.config import (
    BACKENDS, BOUNDARIES, SOLVERS,
)

JACOBI = get_filter("jacobi3")
JJACOBI = jfilters.get_filter("jacobi3")


def _jmesh(shape):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _grid(shape):
    return mesh.make_grid(shape, "cpu")


def _field(hw, seed):
    return np.random.default_rng(seed).standard_normal((1, *hw)).astype(
        np.float32)


# ---------------------------------------------------------------- registry


def test_registry_transfer_forms_under_their_own_classes():
    # The volumes (item 6) add the "physics" class and the rank-3 forms.
    assert kernels.STENCIL_FORMS == ("smooth", "restrict", "prolong",
                                     "physics")
    assert {k for k in kernels.registered_keys("smooth")
            if k[0] == 2} == frozenset(
        (2, b, bd) for b in BACKENDS for bd in BOUNDARIES)
    assert kernels.registered_keys("restrict") == frozenset(
        (rank, "restrict_fw", bd) for rank in (2, 3) for bd in BOUNDARIES)
    assert kernels.registered_keys("prolong") == frozenset(
        (2, "prolong_bilinear", bd) for bd in BOUNDARIES) | frozenset(
        (3, "prolong_trilinear", bd) for bd in BOUNDARIES)
    # The JAX registry's transfer keys, no more and no less.
    for form in ("restrict", "prolong"):
        assert kernels.registered_keys(form) == jkernels.registered_keys(form)


@pytest.mark.parametrize("name", ["restrict_fw", "prolong_bilinear"])
def test_make_block_step_rejects_transfer_form_as_smoother(name):
    op = "restrict" if name == "restrict_fw" else "prolong"
    with pytest.raises(ValueError, match=f"{op} operator"):
        step._make_block_step(JACOBI, _grid((1, 1)), (8, 8), (8, 8), False,
                              name)


def test_unknown_form_fails_at_resolution():
    with pytest.raises(ValueError, match="no kernel form registered"):
        kernels.resolve(2, "restrict_nope", "zero")


# ------------------------------------------------------- transfer operators


def _np_correlate3(x, taps, boundary):
    """Independent 3x3 correlation: explicit loops, ghost by boundary."""
    H, W = x.shape
    p = np.pad(x, 1, mode="wrap") if boundary == "periodic" else np.pad(x, 1)
    out = np.zeros_like(x, np.float64)
    for di in range(3):
        for dj in range(3):
            out += taps[di, dj] * p[di:di + H, dj:dj + W]
    return out


FW_TAPS = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float64) / 16.0


def _np_restrict(x, boundary):
    fw = _np_correlate3(x.astype(np.float64), FW_TAPS, boundary)
    off = 0 if boundary == "periodic" else 1
    ch = transfer.coarse_extent(x.shape[0], boundary)
    cw = transfer.coarse_extent(x.shape[1], boundary)
    return fw[off::2, off::2][:ch, :cw]


def _np_prolong(c, nh, nw, boundary):
    m, n = c.shape
    out = np.zeros((nh, nw))

    def cv(i, j):
        if boundary == "periodic":
            return c[i % m, j % n]
        return c[i, j] if 0 <= i < m and 0 <= j < n else 0.0

    for fi in range(nh):
        for fj in range(nw):
            shift = 0 if boundary == "periodic" else 1
            i2, r_i = divmod(fi - shift, 2)
            j2, r_j = divmod(fj - shift, 2)
            rows = [i2] if r_i == 0 else [i2, i2 + 1]
            cols = [j2] if r_j == 0 else [j2, j2 + 1]
            out[fi, fj] = np.mean(
                [np.mean([cv(i, j) for j in cols]) for i in rows])
    return out


def _port_op(name, x, fine_hw, grid_shape, boundary):
    """Drive a registered transfer form of the port over the grid's blocks
    (prolongation: ``x`` is the coarse field, placed at half blocks), as
    the R×C list and as the stacked grid: the same values either way."""
    grid = _grid(grid_shape)
    block = mg._level_block(fine_hw, grid_shape, 2)
    place = block if name == "restrict_fw" else (block[0] // 2,
                                                 block[1] // 2)
    op = kernels.resolve(2, name, boundary).build(grid_shape, fine_hw, block,
                                                  boundary)
    got = []
    for stacked in (False, True):
        state = mg._place(torch.from_numpy(x), x.shape[1:], grid, place,
                          stacked)
        out = op(state)
        assert torch.is_tensor(out) == stacked
        got.append(mesh.join_blocks(mg._blocks(out, grid)).numpy())
    np.testing.assert_array_equal(got[0], got[1])
    return got[0]


@pytest.mark.parametrize("grid_shape", [(1, 1), (2, 1), (1, 3), (3, 4)])
@pytest.mark.parametrize("depth", [0, 1, 3])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_halo_exchange_stacked_equals_block_exchange(grid_shape, depth,
                                                     boundary):
    from parallel_convolution_tpu_torch.ops import rdma
    from parallel_convolution_tpu_torch.parallel import halo

    g = torch.Generator().manual_seed(depth)
    x = torch.randn((grid_shape[0] * grid_shape[1], 2, 5, 6), generator=g)
    want = halo.halo_exchange(rdma.unstack_blocks(x, grid_shape), depth,
                              grid_shape, boundary)
    got = halo.halo_exchange_stacked(x, depth, grid_shape, boundary)
    assert torch.equal(got, rdma.stack_blocks(want, grid_shape))
    with pytest.raises(ValueError, match="deeper than the block"):
        halo.halo_exchange_stacked(x, 6, grid_shape, boundary)


def _jax_op(name, x, fine_hw, grid_shape, boundary):
    """The JAX package's form of the same operator, in shard_map."""
    m = _jmesh(grid_shape)
    block = jmg._level_block(fine_hw, grid_shape, 2)
    place = block if name == "restrict_fw" else (block[0] // 2,
                                                 block[1] // 2)
    xs = jmg._fit_to(x, x.shape[1:], m, place, src_mesh=None)
    build = jkernels.resolve(2, name, boundary).build
    fn = jax.jit(shard_map(build(grid_shape, fine_hw, block, boundary),
                           mesh=m, in_specs=jmg._SPEC, out_specs=jmg._SPEC,
                           check_vma=False))
    return np.asarray(fn(xs))


RESTRICT_CASES = ([("zero", hw, g) for hw in [(12, 12), (13, 11), (16, 10),
                                               (15, 17)]
                   for g in [(1, 1), (2, 2)]]
                  + [("periodic", hw, (2, 2)) for hw in [(12, 16), (8, 12)]])


@pytest.mark.parametrize("boundary,hw,grid_shape", RESTRICT_CASES)
def test_restrict_fw_matches_jax_and_numpy(boundary, hw, grid_shape):
    x = np.random.default_rng(7).standard_normal((1, *hw)).astype(np.float32)
    got = _port_op("restrict_fw", x, hw, grid_shape, boundary)
    want = _jax_op("restrict_fw", x, hw, grid_shape, boundary)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ch = transfer.coarse_extent(hw[0], boundary)
    cw = transfer.coarse_extent(hw[1], boundary)
    np.testing.assert_allclose(got[0, :ch, :cw], _np_restrict(x[0], boundary),
                               atol=1e-5)
    # The masking invariant: everything beyond the coarse extent is 0.
    assert np.all(got[:, ch:, :] == 0) and np.all(got[:, :, cw:] == 0)


PROLONG_CASES = ([("zero", hw, g) for hw in [(12, 12), (13, 11), (16, 10)]
                  for g in [(1, 1), (2, 2)]]
                 + [("periodic", hw, (2, 2)) for hw in [(12, 16), (8, 12)]])


@pytest.mark.parametrize("boundary,hw,grid_shape", PROLONG_CASES)
def test_prolong_bilinear_matches_jax_and_numpy(boundary, hw, grid_shape):
    ch = transfer.coarse_extent(hw[0], boundary)
    cw = transfer.coarse_extent(hw[1], boundary)
    c = np.random.default_rng(9).standard_normal((1, ch, cw)).astype(
        np.float32)
    got = _port_op("prolong_bilinear", c, hw, grid_shape, boundary)
    want = _jax_op("prolong_bilinear", c, hw, grid_shape, boundary)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0, :hw[0], :hw[1]],
                               _np_prolong(c[0], *hw, boundary), atol=1e-5)


def test_transfer_needs_even_blocks_and_centering_rules():
    with pytest.raises(ValueError, match="even per-device blocks"):
        transfer.build_restrict_fw((1, 1), (7, 8), (7, 8))
    with pytest.raises(ValueError, match="even per-device blocks"):
        transfer.build_prolong_bilinear((1, 1), (8, 7), (8, 7))
    assert [transfer.coarse_extent(n, "zero") for n in (8, 9, 12, 13)] == [
        3, 4, 5, 6]
    assert [transfer.coarse_extent(n, "periodic") for n in (8, 12)] == [4, 6]


# ------------------------------------------------------------ the planner


PLAN_CASES = (
    [("zero", hw, g, None) for hw in [(96, 64), (64, 48), (1030, 770),
                                       (33, 17), (8, 8), (130, 66)]
     for g in [(1, 1), (2, 2), (2, 4), (4, 2), (1, 8)]]
    + [("periodic", hw, g, None) for hw in [(32, 32), (48, 40), (96, 64)]
       for g in [(1, 1), (2, 2), (2, 4)]]
    + [("zero", (96, 64), (2, 4), 2), ("zero", (1030, 770), (4, 2), 3),
       ("zero", (96, 64), (1, 1), 1)])


@pytest.mark.parametrize("boundary,hw,grid_shape,cap", PLAN_CASES)
def test_plan_levels_equals_jax(boundary, hw, grid_shape, cap):
    got = mg.plan_levels(_grid(grid_shape), hw, 1, boundary, cap)
    want = jmg.plan_levels(_jmesh(grid_shape), hw, 1, boundary, cap)
    assert ([(lv.grid.shape, lv.valid_hw, lv.block_hw) for lv in got]
            == [(lv.grid, lv.valid_hw, lv.block_hw) for lv in want])
    for lv in got:
        assert lv.grid.device == torch.device("cpu")
    for lv in got[:-1]:
        assert lv.block_hw[0] % 2 == 0 and lv.block_hw[1] % 2 == 0
    assert mg.cycle_work_units(got) == pytest.approx(
        jmg.cycle_work_units(want))


def test_plan_levels_floor_and_cap():
    levels = mg.plan_levels(_grid((2, 4)), (96, 64), 1, "zero")
    assert levels[0].grid.shape == (2, 4) and levels[0].valid_hw == (96, 64)
    assert all(min(lv.block_hw) >= mg.MG_BLOCK_FLOOR for lv in levels)
    assert len(mg.plan_levels(_grid((2, 4)), (96, 64), 1, "zero",
                              mg_levels=2)) == 2
    with pytest.raises(ValueError, match="mg_levels"):
        mg.plan_levels(_grid((2, 4)), (96, 64), 1, "zero", mg_levels=0)
    # 1030x770 on 16x16 collapses its coarse levels onto smaller grids.
    grids = [lv.grid.shape for lv in mg.plan_levels(_grid((16, 16)),
                                                    (1030, 770), 1)]
    assert grids[0] == (16, 16) and grids[-1] != (16, 16)
    assert len(set(grids)) >= 3


def test_costmodel_mirrors_solver_and_jax():
    assert (costmodel.MG_PRE_SWEEPS, costmodel.MG_POST_SWEEPS,
            costmodel.MG_COARSE_SWEEPS, costmodel.MG_MIN_EXTENT,
            costmodel.MG_MAX_LEVELS) == (mg.NU_PRE, mg.NU_POST, mg.NU_COARSE,
                                         mg.MG_MIN_EXTENT, mg.MG_MAX_LEVELS)
    assert (mg.NU_PRE, mg.NU_POST, mg.NU_COARSE, mg.OMEGA, mg.MG_BLOCK_FLOOR,
            mg.MG_MIN_EXTENT, mg.MG_MAX_LEVELS) == (
        jmg.NU_PRE, jmg.NU_POST, jmg.NU_COARSE, jmg.OMEGA, jmg.MG_BLOCK_FLOOR,
        jmg.MG_MIN_EXTENT, jmg.MG_MAX_LEVELS)
    for hw in [(96, 64), (32768, 32768), (1920, 2520), (9, 9)]:
        for cap in (None, 2):
            assert costmodel.mg_default_levels(hw, cap) == \
                jcost.mg_default_levels(hw, cap)
    hwm = costmodel.hardware_for("gpu", "NVIDIA H100 80GB HBM3")
    secs, wu = costmodel.predict_mg_cycle_seconds(
        (1, 32768, 32768), (1, 1), 3, "f32", False, hwm, backend="cuda")
    levels = mg.plan_levels(_grid((1, 1)), (32768, 32768), 1)
    assert len(levels) == costmodel.mg_default_levels((32768, 32768))
    assert wu == pytest.approx(mg.cycle_work_units(levels), rel=1e-3)
    assert secs > 0
    assert costmodel.predict_vcycle_seconds([(1e-9, 100, 2), (2e-9, 25, 16)]) \
        == pytest.approx(1e-9 * 200 + 2e-9 * 400)


# ----------------------------------------------------------- the V-cycle


@pytest.mark.parametrize("grid_shape", [(1, 1), (2, 4)])
def test_mg_converge_matches_jax(grid_shape):
    x = _field((96, 64), 0)
    want = list(jmg.mg_converge_stream(x, JJACOBI, 1e-4, 20000,
                                       mesh=_jmesh(grid_shape)))
    got = list(mg.mg_converge_stream(x, JACOBI, 1e-4, 20000,
                                     grid=_grid(grid_shape)))
    assert len(got) == len(want) >= 5
    l1 = float(np.abs(JACOBI.taps).sum())
    for (g, gc, gd, gwu), (w, wc, wd, wwu) in zip(got, want):
        assert gc == wc and gwu == pytest.approx(wwu)
        # Scaled to this cycle's field: the field and its residual shrink
        # toward 0 cycle by cycle.
        rtol, atol = mg.float_tolerance(JACOBI, gc, np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
        assert abs(gd - wd) <= (1 + l1) * atol
    assert got[-1][2] < 1e-4 <= got[-2][2]
    out, res = mg.mg_converge(x, JACOBI, 1e-4, 20000, grid=_grid(grid_shape))
    assert res.cycles == len(want) and res.converged
    assert res.level_grids == [f"{lv.grid[0]}x{lv.grid[1]}" for lv in
                               jmg.plan_levels(_jmesh(grid_shape), (96, 64),
                                               1)]
    assert out.numpy().tobytes() == got[-1][0].tobytes()


@pytest.mark.parametrize("backend", ["shifted", "cuda", "cuda_rdma"])
def test_multigrid_bitwise_grid_invariant(backend):
    x = _field((64, 48), 1)
    runs = [mg.mg_converge(x, JACOBI, 1e-4, 20000, grid=_grid(g),
                           backend=backend) for g in [(1, 1), (2, 2), (1, 2)]]
    assert len({r.cycles for _, r in runs}) == 1
    for out, _ in runs[1:]:
        assert torch.equal(out, runs[0][0])


def test_multigrid_periodic_and_backends_agree():
    # A periodic torus keeps a constant field exactly: one cycle, exact.
    c = np.full((1, 32, 32), 7.25, np.float32)
    out, res = mg.mg_converge(c, JACOBI, 1e-5, 500, grid=_grid((2, 2)),
                              boundary="periodic")
    assert res.converged and res.cycles == 1
    np.testing.assert_array_equal(out.numpy(), c)
    # Every backend's plain path gives the same run on a periodic field.
    x = _field((32, 48), 4)
    ref, rres = mg.mg_converge(x, JACOBI, 1e-4, 5000, grid=_grid((2, 2)),
                               boundary="periodic")
    jout, jres = jmg.mg_converge(x, JJACOBI, 1e-4, 5000, mesh=_jmesh((2, 2)),
                                 boundary="periodic")
    assert rres.cycles == jres.cycles
    rtol, atol = mg.float_tolerance(JACOBI, rres.cycles, np.abs(jout).max())
    np.testing.assert_allclose(ref.numpy(), jout, rtol=rtol, atol=atol)
    for backend in ("xla_conv", "separable", "cuda_sep"):
        out, res = mg.mg_converge(x, JACOBI, 1e-4, 5000, grid=_grid((2, 2)),
                                  boundary="periodic", backend=backend)
        assert res.cycles == rres.cycles
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=rtol,
                                   atol=atol)


def test_multigrid_beats_jacobi_10x():
    tol = 1e-4
    x = _field((64, 48), 0)
    out_mg, res = mg.mg_converge(x, JACOBI, tol, 20000, grid=_grid((2, 2)))
    out_j, iters = step.sharded_converge(x, JACOBI, tol, 20000,
                                         check_every=50, grid=_grid((2, 2)))
    assert res.converged and iters < 20000
    assert iters / res.work_units >= 10.0
    assert float((out_j - out_mg).abs().max()) <= 5e-3
    assert res.levels >= 2 and res.work_units == pytest.approx(
        res.cycles * mg.cycle_work_units(
            mg.plan_levels(_grid((2, 2)), (64, 48), 1)), abs=2e-3)


def test_multigrid_float_contract_and_pending_knobs():
    x = np.zeros((1, 32, 32), np.float32)
    with pytest.raises(ValueError, match="quantize=False"):
        list(mg.mg_converge_stream(x, JACOBI, 1e-3, 10, grid=_grid((1, 1)),
                                   quantize=True))
    with pytest.raises(ValueError, match="storage='f32'"):
        list(mg.mg_converge_stream(x, JACOBI, 1e-3, 10, grid=_grid((1, 1)),
                                   storage="u8"))
    # overlap (item 10b) is ported for cuda_rdma on a grid of slots; a
    # one-device V-cycle clamps it with a warning and stamps False.
    step._OVERLAP_WARNED.discard("backend:shifted")
    with pytest.warns(UserWarning, match="running serialized"):
        _, res = mg.mg_converge(x, JACOBI, 1e-3, 10, grid=_grid((1, 1)),
                                overlap=True)
    assert res.overlap is False
    with pytest.raises(ValueError, match="unknown backend"):
        mg.mg_converge(x, JACOBI, 1e-3, 10, grid=_grid((1, 1)),
                       backend="pallas")


def test_multigrid_auto_fallback_readbacks_and_single_level():
    x = _field((48, 48), 3)
    ref, rres = mg.mg_converge(x, JACOBI, 1e-3, 5000, grid=_grid((2, 2)))
    before = mg.mg_converge.readbacks
    out, res = mg.mg_converge(x, JACOBI, 1e-3, 5000, grid=_grid((2, 2)),
                              backend="auto", fallback=True)
    assert mg.mg_converge.readbacks - before == res.cycles == rres.cycles
    assert res.backend in BACKENDS and torch.equal(out, ref)
    # --fallback probes the fine block: a transient fault degrades
    # cuda_rdma to cuda (warned), the same field.
    from parallel_convolution_tpu_torch.resilience import degrade, faults

    degrade.clear_probe_cache()
    with faults.injected("backend_compile:1"):
        with pytest.warns(degrade.BackendDegradedWarning,
                          match="'cuda_rdma' degraded to 'cuda'"):
            out, res = mg.mg_converge(x, JACOBI, 1e-3, 5000,
                                      grid=_grid((2, 2)),
                                      backend="cuda_rdma", fallback=True)
    degrade.clear_probe_cache()
    assert res.backend == "cuda" and torch.equal(out, ref)
    # mg_levels=1: the cycle is damped smoothing alone, 4 units a cycle.
    _, one = mg.mg_converge(x, JACOBI, 1e-3, 40, grid=_grid((1, 1)),
                            mg_levels=1)
    assert one.levels == 1 and one.work_units == 4.0 * one.cycles
    jone = jmg.mg_converge(x, JJACOBI, 1e-3, 40, mesh=_jmesh((1, 1)),
                           mg_levels=1)[1]
    assert (one.cycles, one.converged) == (jone.cycles, jone.converged)


# -------------------------------------------------------- knob threading


def test_solver_knob_threads_models_step_and_stream():
    x = _field((48, 48), 3)
    grid = _grid((2, 2))
    s = JacobiSolver(filt="jacobi3", tol=1e-3, max_iters=5000, grid=grid,
                     solver="multigrid")
    out, cycles = s.solve(x)
    assert s.last_mg is not None and s.last_mg.cycles == cycles
    assert s.last_mg.converged
    out2, cycles2 = step.sharded_converge(x, JACOBI, 1e-3, 5000, grid=grid,
                                          solver="multigrid")
    assert cycles2 == cycles and np.array_equal(out, out2.numpy())
    before = mg.mg_converge_stream.readbacks
    rows = list(step.sharded_converge_stream(x, JACOBI, 1e-3, 5000,
                                             grid=grid, solver="multigrid"))
    assert len(rows) == cycles == mg.mg_converge_stream.readbacks - before
    assert np.array_equal(rows[-1][0], out)
    with pytest.raises(ValueError, match="solver"):
        step.sharded_converge(x, JACOBI, 1e-3, 10, grid=grid, solver="sor")
    with pytest.raises(ValueError, match="solver"):
        JacobiSolver(solver="sor", device="cpu")
    assert set(SOLVERS) == {"jacobi", "multigrid"}
    # The JAX solver's fields come across with their solver.
    from parallel_convolution_tpu_torch import convert

    port = convert.jacobi_solver_from_reference(
        {"filt": "jacobi3", "tol": 1e-3, "max_iters": 5000, "mesh": (2, 2),
         "backend": "pallas", "solver": "multigrid", "mg_levels": 2},
        device="cpu")
    got, c = port.solve(x)
    assert port.backend == "cuda" and port.last_mg.levels == 2 and c >= 1


def test_bench_converge_multigrid_row_matches_jax():
    hw = (48, 64)
    jrow = jbench.bench_converge(hw, JJACOBI, 1e-3, 5000,
                                 mesh=_jmesh((2, 2)), solver="multigrid")
    row = bench.bench_converge(hw, JACOBI, 1e-3, 5000, grid=_grid((2, 2)),
                               solver="multigrid")
    assert set(row) == set(jrow) | {"readbacks"}
    for k in ("cycles", "mg_levels", "mg_level_shapes", "work_units_to_tol",
              "converged", "solver"):
        assert row[k] == jrow[k], k
    assert row["plan_key"].endswith("|solver=multigrid")
    assert row["readbacks"] == row["cycles"]
    assert row["residual"] == pytest.approx(jrow["residual"], rel=1e-4)
    jacobi = bench.bench_converge(hw, JACOBI, 1e-3, 5000, grid=_grid((2, 2)))
    assert jacobi["work_units_to_tol"] >= 10 * row["work_units_to_tol"]


def _cli_pair(tmp_path, capsys, extra, jextra=None):
    src = tmp_path / "in.raw"
    imageio.write_raw(src, imageio.generate_test_image(64, 80, "grey", seed=7))
    out, jout = tmp_path / "out.raw", tmp_path / "jout.raw"
    head = ["run", str(src), "64", "80", "500", "grey"]
    rc = cli_main(head + ["-o", str(out), "--device", "cpu"] + extra)
    line = capsys.readouterr()
    if jextra is None:
        return rc, line, None, None
    assert jcli.main(head + ["-o", str(jout)] + jextra) == 0
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    return rc, line, (out, jout), jline


# The cuda_rdma case is held against the JAX CLI's shifted run: on the CPU
# the port runs K3 / K4's plain version, and the JAX package's pallas_rdma
# in interpret mode takes over a minute here; jacobi3's taps are dyadic, so
# every backend gives shifted's bytes.
@pytest.mark.parametrize("extra,jextra", [
    (["--solver", "multigrid"], ["--solver", "multigrid"]),
    (["--solver", "multigrid", "--mesh", "2x2", "--backend", "cuda_rdma",
      "--mg-levels", "2"],
     ["--solver", "multigrid", "--mesh", "2x2", "--backend", "shifted",
      "--mg-levels", "2"]),
])
def test_cli_multigrid_matches_jax_cli(tmp_path, capsys, extra, jextra):
    conv = ["--converge", "0.5"]
    rc, said, files, jline = _cli_pair(tmp_path, capsys, conv + extra,
                                       conv + jextra)
    line = said.out.strip().splitlines()[-1]
    assert rc == 0 and line.startswith("converged after ")
    assert "V-cycles" in line
    out, jout = files
    assert line.replace(str(out), "") == jline.replace(str(jout), "")
    assert out.read_bytes() == jout.read_bytes()


@pytest.mark.parametrize("extra,message", [
    (["--solver", "multigrid"], "requires --converge"),
    (["--converge", "0.5", "--solver", "multigrid", "--storage", "bf16"],
     "requires --storage f32"),
])
def test_cli_multigrid_exit_2(tmp_path, capsys, extra, message):
    rc, said, _, _ = _cli_pair(tmp_path, capsys, extra)
    assert rc == 2 and message in said.err
    assert not (tmp_path / "out.raw").exists()


def test_cli_multigrid_says_converged_at_the_cap(tmp_path, capsys):
    # The JAX CLI's line, mirrored: "converged after" also when the
    # work-unit cap stopped the run short of tol (ROADMAP Queue 3).
    src = tmp_path / "in.raw"
    imageio.write_raw(src, imageio.generate_test_image(64, 80, "grey", seed=7))
    assert cli_main(["run", str(src), "64", "80", "10", "grey", "-o",
                     str(tmp_path / "o.raw"), "--device", "cpu",
                     "--converge", "1e-6", "--solver", "multigrid"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("converged after 2 V-cycles")
    res = float(line.split("residual ")[1].split(",")[0])
    assert res >= 1e-6
    assert json.dumps(line)  # one printable line


@pytest.mark.parametrize("backend", ["shifted", "cuda_rdma"])
def test_multigrid_solve_leaves_no_reference_cycle(backend):
    # A solve's level programs (and the masks they cache: a quarter of a
    # field at the fine level) are freed when it returns, not held by a
    # reference cycle until the garbage collector runs.
    import gc

    x = _field((96, 64), 5)
    mg.mg_converge(x, JACOBI, 1e-3, 200, grid=_grid((2, 2)), backend=backend)
    gc.collect()
    gc.disable()
    try:
        mg.mg_converge(x, JACOBI, 1e-3, 200, grid=_grid((2, 2)),
                       backend=backend)
        list(mg.mg_converge_stream(x, JACOBI, 1e-3, 200, grid=_grid((2, 2)),
                                   backend=backend))
        assert gc.collect() == 0
    finally:
        gc.enable()


# ------------------------------------------------- on a grid of slots (10c)


def _slots(shape):
    return mesh.make_grid(shape, devices=["cpu"] * (shape[0] * shape[1]))


@pytest.mark.parametrize("grid_shape", [(2, 2), (2, 4)])
def test_mg_converge_on_slots_matches_jax(grid_shape):
    x = _field((64, 48), 2)
    jrows = list(jmg.mg_converge_stream(x, JJACOBI, 1e-4, 20000,
                                        mesh=_jmesh(grid_shape)))
    _, jres = jmg.mg_converge(x, JJACOBI, 1e-4, 20000,
                              mesh=_jmesh(grid_shape))
    l1 = float(np.abs(JACOBI.taps).sum())
    for backend in ("shifted", "cuda", "cuda_rdma"):
        slots = _slots(grid_shape)
        rows = list(mg.mg_converge_stream(x, JACOBI, 1e-4, 20000, grid=slots,
                                          backend=backend))
        out, res = mg.mg_converge(x, JACOBI, 1e-4, 20000, grid=slots,
                                  backend=backend)
        assert len(rows) == len(jrows) == res.cycles == jres.cycles
        assert res.work_units == pytest.approx(jres.work_units)
        assert res.level_grids == jres.level_grids
        assert res.level_shapes == jres.level_shapes
        for (g, gc, gd, _), (w, _, wd, _) in zip(rows, jrows):
            rtol, atol = mg.float_tolerance(JACOBI, gc, np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
            assert abs(gd - wd) <= (1 + l1) * atol
        # The resolved knobs: the JAX stamps where the backend has no
        # column transport, the cost model's pick where it has.
        want_cm = step.resolve_col_mode(
            None, backend, slots, mg.plan_levels(slots, (64, 48),
                                                 1)[0].block_hw, 1, 1, "f32")
        assert (res.col_mode, res.overlap) == (want_cm, False)
        if backend == "shifted":
            assert (res.col_mode, res.overlap) == (jres.col_mode,
                                                   jres.overlap)
        # Bit for bit the port's one-device run of the same backend.
        one, ores = mg.mg_converge(x, JACOBI, 1e-4, 20000,
                                   grid=_grid(grid_shape), backend=backend)
        assert torch.equal(out, one) and res.residuals == ores.residuals


def test_coarse_levels_take_the_first_slots():
    slots = mesh.make_grid((2, 4), devices=",".join(["cpu"] * 8))
    levels = mg.plan_levels(slots, (96, 48), 1)
    jlevels = jmg.plan_levels(_jmesh((2, 4)), (96, 48), 1)
    assert [lv.grid.shape for lv in levels] == [lv.grid for lv in jlevels]
    assert levels[0].grid is slots
    for prev, lv in zip(levels, levels[1:]):
        g0, g1 = lv.grid.shape
        assert lv.grid.slotted and lv.grid.slots == slots.slots[:g0 * g1]
        if lv.grid.shape == prev.grid.shape:
            assert lv.grid is prev.grid  # one Grid object a shape
    assert len({id(lv.grid) for lv in levels}) == len(
        {lv.grid.shape for lv in levels})


def test_level_channel_builds_are_the_distinct_level_identities():
    from parallel_convolution_tpu_torch.parallel import channels

    x = _field((64, 48), 3)
    slots = _slots((2, 4))
    levels = mg.plan_levels(slots, (64, 48), 1)
    wu = mg.cycle_work_units(levels)
    channels.reset()
    _, res = mg.mg_converge(x, JACOBI, 0.0, 3 * wu - 1e-6, grid=slots,
                            backend="cuda_rdma", col_mode="strided")
    assert res.cycles == 3
    keys = mg.level_channel_keys(levels, 1, "zero", "strided")
    jkeys = jmg.level_channel_keys(jmg.plan_levels(_jmesh((2, 4)), (64, 48),
                                                   1), 1, "zero", "strided")
    assert channels.stats()["builds"] == len(set(keys)) == len(set(jkeys))
    assert mg.warm_level_channels(levels, 1, "zero", "strided") == keys
    assert channels.stats()["builds"] == len(set(keys))


def test_slots_overlap_and_launch_counts():
    # overlap on CPU slots runs the plain overlapped schedule with the
    # byte-proof hatch, stamped True, the same field; the launch counts
    # are per slot.
    import os

    x = _field((64, 48), 4)
    slots = _slots((2, 2))
    ref, rres = mg.mg_converge(x, JACOBI, 1e-3, 5000, grid=slots,
                               backend="cuda_rdma")
    os.environ["PCTPU_OVERLAP_INTERPRET"] = "1"
    try:
        out, res = mg.mg_converge(x, JACOBI, 1e-3, 5000, grid=slots,
                                  backend="cuda_rdma", overlap=True,
                                  col_mode="packed")
    finally:
        del os.environ["PCTPU_OVERLAP_INTERPRET"]
    assert res.overlap is True and res.col_mode == "packed"
    assert torch.equal(out, ref) and res.cycles == rres.cycles
    levels = mg.plan_levels(slots, (64, 48), 1)
    sweeps = [mg.NU_PRE + mg.NU_POST + 1] * (len(levels) - 1) + [
        mg.NU_COARSE]
    k1 = mg.cycle_launches(levels, "cuda", 1)
    assert k1["stencil_step"] == sum(
        n * lv.grid.rows * lv.grid.cols for lv, n in zip(levels, sweeps))
    lapped = mg.cycle_launches(levels, "cuda_rdma", 1, col_mode="packed",
                               overlap=True)
    plain = mg.cycle_launches(levels, "cuda_rdma", 1, col_mode="strided")
    assert plain["rdma_pack"] == 0 and lapped["rdma_pack"] == sum(
        n * lv.grid.rows * lv.grid.cols
        for lv, n in zip(levels, sweeps) if lv.grid.cols > 1)
    slot_total = plain["rdma_block_slot"] + plain["rdma_tiled_slot"]
    assert slot_total == sum(n * lv.grid.rows * lv.grid.cols
                             for lv, n in zip(levels, sweeps))
    assert lapped["rdma_block_region"] + lapped["rdma_tiled_region"] > 0
    assert plain["rdma_block"] == plain["rdma_tiled"] == 0


def test_cli_multigrid_on_slots_matches_jax_cli(tmp_path, capsys):
    img = imageio.generate_test_image(40, 36, "grey", seed=6)
    src = tmp_path / "in.raw"
    imageio.write_raw(src, img)
    argv = [str(src), "40", "36", "2000", "grey", "--converge", "0.5",
            "--solver", "multigrid", "--mesh", "2x2"]
    assert jcli.main(["run"] + argv + ["-o", str(tmp_path / "j.raw")]) == 0
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    for backend in ("cuda", "cuda_rdma"):
        dst = tmp_path / f"{backend}.raw"
        assert cli_main(["run"] + argv + [
            "-o", str(dst), "--backend", backend,
            "--device", "cpu,cpu,cpu,cpu"]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert line.split(" ->")[0].split(" (")[0] == \
            jline.split(" ->")[0].split(" (")[0]
        got = imageio.read_raw(dst, 40, 36, "grey")
        want = imageio.read_raw(tmp_path / "j.raw", 40, 36, "grey")
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_bench_converge_multigrid_row_on_slots():
    hw = (48, 64)
    one = bench.bench_converge(hw, JACOBI, 1e-3, 5000, grid=_grid((2, 2)),
                               solver="multigrid", backend="cuda_rdma")
    row = bench.bench_converge(hw, JACOBI, 1e-3, 5000, grid=_slots((2, 2)),
                               solver="multigrid", backend="cuda_rdma")
    for k in ("cycles", "mg_levels", "mg_level_shapes", "work_units_to_tol",
              "converged", "residual", "checksum", "readbacks", "hosts"):
        assert row[k] == one[k], k
    assert row["slice_topology"] == "1x1:cpu" and row["overlap"] is False
    assert row["col_mode"] == step.resolve_col_mode(
        None, "cuda_rdma", _slots((2, 2)), (24, 32), 1, 1, "f32")
