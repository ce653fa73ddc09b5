"""K2's interior split (the JAX package's 9-patch launch) in the port,
against the JAX package on the same seeded inputs.

* The plan functions (``_interior_range``, ``split_patches``,
  ``axis_offset_classes``, the class index) are pure integer functions:
  equal to the JAX ones over seeded sweeps, exact and (lo, hi) offsets,
  tile grids of 1, 2 and >= 3 tiles an axis.
* ``fused_iterate_plain`` with the split runs the card's plan on the CPU
  (level groups, each group's patches with only their mask axes): equal
  to JAX ``fused_iterate_pallas(..., interpret=True, interior_split=True,
  block_off=...)``, byte for byte in u8 and within
  ``stencil.float_tolerance`` in float mode, and to the unsplit plain
  version, across several level groups.
* ``sharded_iterate(interior_split=True)`` against JAX ``sharded_iterate``
  on 1x1, 2x2, 2x4 and 4x2 grids, and the oracle.
* The knob is taken and not used where the JAX package ignores it, the
  ``ValueError`` without ``block_off``, and the CLI flag on ``run``,
  ``bench`` and ``tune``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.ops import pallas_stencil as jps
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.parallel import step as jstep
from parallel_convolution_tpu_torch import convert
from parallel_convolution_tpu_torch.cli import main as cli_main
from parallel_convolution_tpu_torch.ops import oracle, stencil
from parallel_convolution_tpu_torch.parallel import mesh, step
from parallel_convolution_tpu_torch.utils import imageio


def _filters(name):
    jf = jfilters.get_filter(name)
    return jf, convert.filter_from_numpy(jf.name, jf.taps, jf.dyadic)


def _jax_mesh(shape):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


# ------------------------------------------------------------- the plan


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7])
def test_axis_offset_classes_and_index_match_jax(n):
    for block in (7, 64, 960):
        assert (stencil.axis_offset_classes(n, block)
                == jps.axis_offset_classes(n, block))
    for a in range(n):
        assert stencil.axis_class_index(a, n) == int(
            jstep._axis_class_index(jnp.int32(a), n))


def _geometry(rng):
    """One seeded plan geometry: image, tile, depth, tile grid, offsets
    (exact or (lo, hi) ranges), with tile grids of 1, 2 and more tiles."""
    th, tw = int(rng.integers(1, 40)), int(rng.integers(1, 140))
    gh, gw = int(rng.choice([1, 2, 3, 6])), int(rng.choice([1, 2, 3, 5]))
    depth = int(rng.integers(0, 20))
    H = int(rng.integers(1, 4 * gh * th + 2))
    W = int(rng.integers(1, 4 * gw * tw + 2))

    def off(n):
        lo = int(rng.integers(0, n + 1))
        if rng.random() < 0.5:
            return lo
        return (lo, lo + int(rng.integers(0, n + 1)))

    return (H, W), (th, tw), depth, (gh, gw), (off(H), off(W))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_interior_range_and_patches_match_jax(seed):
    rng = np.random.default_rng(seed)
    some = 0
    for _ in range(300):
        valid, tile, depth, grid_hw, off = _geometry(rng)
        got = stencil._interior_range(valid, tile, depth, grid_hw, off)
        assert got == jps._interior_range(valid, tile, depth, grid_hw, off)
        if got is None:
            continue
        some += 1
        patches = stencil.split_patches(got, grid_hw)
        assert patches == jps.split_patches(got, grid_hw)
        # A partition of the tile grid into at most 9 patches, the middle
        # one (and only it) unmasked.
        cover = np.zeros(grid_hw, int)
        for (i0, i1), (j0, j1), _ in patches:
            cover[i0:i1, j0:j1] += 1
        assert (cover == 1).all() and len(patches) <= 9
        assert sum(1 for *_, m in patches if m == (False, False)) == 1
    assert some > 20


def test_launch_patches_shift_the_offsets_by_the_group():
    # A level group before the last writes a block extended by r*left
    # ghost levels: its plan is the interior box of the shifted origin.
    valid, tile = (90, 300), (8, 128)
    for shift in (0, 1, 3):
        for off in ((0, 0), ((45, 45), (0, 150)), (45, 150)):
            (rl, rh), (cl, ch) = stencil._norm_block_off(off)
            out_hw = (45 + 2 * shift, 150 + 2 * shift)
            gh, gw = -(-out_hw[0] // 8), -(-out_hw[1] // 128)
            split = jps._interior_range(
                valid, tile, 2, (gh, gw),
                ((rl - shift, rh - shift), (cl - shift, ch - shift)))
            want = ([((0, gh), (0, gw), (True, True))] if split is None
                    else jps.split_patches(split, (gh, gw)))
            assert stencil.launch_patches(valid, tile, 2, out_hw, off,
                                          shift) == want


# ------------------------------------------- K2's plain version, patched


# (filter, T, channels, valid, block offset, block_off, dtype, tile)
PATCH_CASES = [
    ("blur3", 3, 1, (90, 300), (0, 0), (0, 0), "u8", (8, 128)),
    ("blur3", 4, 1, (90, 300), (45, 150), ((45, 45), (150, 150)), "u8",
     (8, 32)),
    ("gaussian5", 2, 3, (45, 300), (0, 0), (0, 0), "u8", (8, 128)),
    ("edge5", 3, 1, (120, 260), (40, 0), ((40, 40), (0, 0)), "f32",
     (16, 64)),
    ("blur3", 5, 1, (96, 160), (32, 0), ((32, 64), (0, 0)), "f32",
     (8, 32)),
    # Several level groups (tile 16x32: at most 4 levels a group), RGB.
    ("blur3", 32, 3, (40, 150), (0, 0), (0, 0), "bf16", (16, 32)),
]


@pytest.mark.parametrize("case", PATCH_CASES)
def test_plain_patches_match_jax_interior_split(case):
    name, T, C, valid, offsets, block_off, dt, tile = case
    jf, tf = _filters(name)
    r = tf.radius
    rng = np.random.default_rng(T)
    h, w = valid[0] - offsets[0], valid[1] - offsets[1]
    h, w = min(h, 60), min(w, 160)
    x = rng.integers(0, 256, (C, h + 2 * r * T, w + 2 * r * T)).astype(
        np.float32)
    quantize = dt != "f32"
    tdt = {"u8": torch.uint8, "bf16": torch.bfloat16,
           "f32": torch.float32}[dt]
    jdt = {"u8": jnp.uint8, "bf16": jnp.bfloat16, "f32": jnp.float32}[dt]
    tx = torch.from_numpy(x).to(tdt)
    kw = dict(quantize=quantize, separable=dt == "bf16")
    got = stencil.fused_iterate_plain(tx, offsets, tf, T, valid, **kw,
                                      interior_split=True,
                                      block_off=block_off, tile=tile)
    groups = stencil.fused_plan(r, T, (h, w), tile)[2]
    assert len(groups) > 1 or T < 4
    want = np.asarray(jps.fused_iterate_pallas(
        jnp.asarray(x, jdt), jnp.asarray(offsets, jnp.int32), jf, T, valid,
        tile=(8, 128), interpret=True, interior_split=True,
        block_off=block_off, **kw).astype(jnp.float32))
    unsplit = stencil.fused_iterate_plain(tx, offsets, tf, T, valid, **kw)
    assert torch.equal(got, unsplit)
    got = got.to(torch.float32).numpy()
    if quantize:
        np.testing.assert_array_equal(got, want)
    else:
        rtol, atol = stencil.float_tolerance(tf, T, torch.float32)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_interior_split_needs_block_off():
    _, tf = _filters("blur3")
    x = torch.zeros((1, 20, 20))
    for fn in (stencil.fused_iterate, stencil.fused_iterate_plain):
        with pytest.raises(ValueError, match="requires a static block_off"):
            fn(x, (0, 0), tf, 2, (16, 16), interior_split=True)
        # Periodic (no valid_hw): no split, so no block_off needed.
        fn(x, (0, 0), tf, 2, None, interior_split=True)
    jf, _ = _filters("blur3")
    with pytest.raises(ValueError, match="requires a static block_off"):
        jps.fused_iterate_pallas(jnp.zeros((1, 20, 20)),
                                 jnp.zeros(2, jnp.int32), jf, 2, (16, 16),
                                 interpret=True, interior_split=True)


# --------------------------------------------------------- the entry points


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (2, 4), (4, 2)])
def test_sharded_iterate_split_matches_jax(grid):
    # 90x300 divides no grid here: pad-rim blocks, every offset class.
    img = imageio.generate_test_image(90, 300, "grey", seed=23)
    jf, tf = _filters("blur3")
    x = imageio.interleaved_to_planar(img).astype(np.float32)
    kw = dict(quantize=True, fuse=3, tile=(8, 128))
    got = step.sharded_iterate(x, tf, 7, grid=mesh.make_grid(grid, "cpu"),
                               backend="cuda_sep", interior_split=True,
                               **kw).numpy()
    want = np.asarray(jstep.sharded_iterate(
        x, jf, 7, mesh=_jax_mesh(grid), backend="pallas_sep",
        interior_split=True, **kw))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        imageio.planar_to_interleaved(got.astype(np.uint8)),
        oracle.run_serial_u8(img, tf, 7))


def test_sharded_iterate_split_rgb_bf16_radius2():
    img = imageio.generate_test_image(60, 270, "rgb", seed=21)
    jf, tf = _filters("gaussian5")
    x = imageio.interleaved_to_planar(img).astype(np.float32)
    g = mesh.make_grid((2, 2), "cpu")
    kw = dict(quantize=True, backend="cuda", storage="bf16", fuse=2,
              tile=(8, 32))
    split = step.sharded_iterate(x, tf, 5, grid=g, interior_split=True, **kw)
    assert torch.equal(split, step.sharded_iterate(x, tf, 5, grid=g, **kw))
    np.testing.assert_array_equal(
        imageio.planar_to_interleaved(split.numpy().astype(np.uint8)),
        oracle.run_serial_u8(img, tf, 5))


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_converge_split_matches_jax(grid):
    img = imageio.generate_test_image(45, 300, "grey", seed=23)
    x = imageio.interleaved_to_planar(img).astype(np.float32)
    jf, tf = _filters("jacobi3")
    kw = dict(tol=0.05, max_iters=40, check_every=5, fuse=3, tile=(8, 128))
    got, it = step.sharded_converge(x, tf, grid=mesh.make_grid(grid, "cpu"),
                                    backend="cuda_sep", interior_split=True,
                                    **kw)
    want, jit = jstep.sharded_converge(x, jf, mesh=_jax_mesh(grid),
                                       backend="pallas_sep",
                                       interior_split=True, **kw)
    assert it == int(jit)
    rtol, atol = stencil.float_tolerance(tf, it, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)
    plain, pit = step.sharded_converge(x, tf, grid=mesh.make_grid(grid, "cpu"),
                                       backend="cuda_sep", **kw)
    assert pit == it and torch.equal(plain, got)


@pytest.mark.parametrize("kw", [
    dict(backend="cuda", fuse=3, boundary="periodic"),
    dict(backend="cuda_sep", fuse=1),
    dict(backend="shifted", fuse=3),
    dict(backend="separable", fuse=2),
    dict(backend="xla_conv", fuse=2),
    dict(backend="cuda_rdma", fuse=3),
])
def test_split_taken_and_unused_where_jax_ignores_it(kw):
    img = imageio.generate_test_image(48, 72, "grey", seed=5)
    _, tf = _filters("blur3")
    x = imageio.interleaved_to_planar(img).astype(np.float32)
    g = mesh.make_grid((2, 2), "cpu")
    a = step.sharded_iterate(x, tf, 5, grid=g, interior_split=True, **kw)
    assert torch.equal(a, step.sharded_iterate(x, tf, 5, grid=g, **kw))


def test_model_and_solver_take_the_split():
    from parallel_convolution_tpu_torch.models import (
        ConvolutionModel, JacobiSolver,
    )

    img = imageio.generate_test_image(40, 90, "rgb", seed=8)
    kw = dict(grid=mesh.make_grid((2, 2), "cpu"), backend="cuda_sep",
              storage="bf16", fuse=4, tile=(8, 32))
    got = ConvolutionModel("blur3", interior_split=True, **kw).run_image(
        img, 9)
    np.testing.assert_array_equal(
        got, oracle.run_serial_u8(img, _filters("blur3")[1], 9))
    x = imageio.interleaved_to_planar(img).astype(np.float32)
    s = dict(tol=0.5, max_iters=30, check_every=6, backend="cuda",
             fuse=4, grid=mesh.make_grid((2, 2), "cpu"))
    a, ia = JacobiSolver(interior_split=True, **s).solve(x)
    b, ib = JacobiSolver(**s).solve(x)
    assert ia == ib and np.array_equal(a, b)
    # The V-cycle takes it and does not use it, as the JAX solver.
    m, _ = JacobiSolver(solver="multigrid", interior_split=True, tol=0.5,
                        max_iters=20, device="cpu").solve(x[:1])
    n, _ = JacobiSolver(solver="multigrid", tol=0.5, max_iters=20,
                        device="cpu").solve(x[:1])
    assert np.array_equal(m, n)


def test_cli_interior_split_run_bench_tune(tmp_path, capsys):
    src = tmp_path / "in.raw"
    img = imageio.generate_test_image(45, 150, "grey", seed=3)
    imageio.write_raw(src, img)
    head = ["run", str(src), "45", "150", "7", "grey", "--device", "cpu",
            "--backend", "cuda_sep", "--fuse", "3", "--tile", "8,32",
            "--mesh", "2x2"]
    assert cli_main(head + ["-o", str(tmp_path / "s.raw"),
                            "--interior-split"]) == 0
    assert cli_main(head + ["-o", str(tmp_path / "u.raw")]) == 0
    assert (tmp_path / "s.raw").read_bytes() == (tmp_path / "u.raw").read_bytes()
    np.testing.assert_array_equal(
        imageio.read_raw(tmp_path / "s.raw", 45, 150, "grey"),
        oracle.run_serial_u8(img, _filters("blur3")[1], 7))
    capsys.readouterr()
    assert cli_main(["bench", "32", "48", "4", "grey", "--device", "cpu",
                     "--backend", "cuda", "--fuse", "2", "--reps", "1",
                     "--interior-split"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["interior_split"] is True and row["fuse"] == 2
    assert cli_main(["tune", "--rows", "32", "--cols", "48", "--device",
                     "cpu", "--mesh", "2x2", "--max-measure", "1",
                     "--iters", "2", "--interior-split"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["measured_points"] == 1 and summary["errors"] == 0
