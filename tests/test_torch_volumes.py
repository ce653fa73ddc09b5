"""The port's rank-3 volumes (``volumes/``, the rank-3 transfer forms, the
volume cost model and ``run --rank 3``) against the JAX package's
``volumes.driver`` on the same seeded inputs, on the CPU.

* The 6-face halo against ``np.pad`` of the global volume, block by
  block, and against JAX ``halo3`` inside ``shard_map``.
* Every form against JAX and the port's ``oracle3``, both boundaries, at
  ``atol=2e-5`` (the JAX oracle test's tolerance: XLA on the CPU may
  contract a multiply-add that eager PyTorch rounds twice).
* The port's own bitwise claims: the ``_stack`` twins, 1x1 / 2x4 / 4x2,
  fuse 1 against fuse 2 and 4, the converge chunks against the fixed
  count (the JAX package holds fusion to 1 ulp, its fused and unfused XLA
  programs contracting differently; the port's eager ops do not).
* The geometry errors, the rank-3 transfers against JAX, the cost-model
  mirror, and the CLI ``--rank 3`` round trip and its exit-2 refusals
  against the JAX CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from parallel_convolution_tpu import cli as jcli
from parallel_convolution_tpu.parallel import kernels as jkernels
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.tuning import costmodel as jcost
from parallel_convolution_tpu.utils.jax_compat import shard_map
from parallel_convolution_tpu.volumes import driver as jdriver
from parallel_convolution_tpu.volumes import halo3 as jhalo3
from parallel_convolution_tpu.volumes import oracle3 as joracle3
from parallel_convolution_tpu_torch.cli import main as cli_main
from parallel_convolution_tpu_torch.parallel import kernels, mesh
from parallel_convolution_tpu_torch.solvers import transfer
from parallel_convolution_tpu_torch.tuning import costmodel
from parallel_convolution_tpu_torch.utils import config
from parallel_convolution_tpu_torch.utils.config import (
    BOUNDARIES, VOLUME_FIELDS, VOLUME_FORMS, VOLUME_RADII,
)
from parallel_convolution_tpu_torch.volumes import driver, halo3, oracle3

SPEC = P(None, None, "x", "y")
ATOL = 2e-5


def _grid(shape):
    return mesh.make_grid(shape, "cpu")


def _jax_mesh(shape):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _vol(rng, d, h, w, fields=VOLUME_FIELDS):
    # Bounded [0, 1): safe for the Gray–Scott cubic term.
    return rng.random((fields, d, h, w), dtype=np.float32)


def test_registries_are_the_jax_packages():
    from parallel_convolution_tpu.utils import config as jconfig

    for name in ("RANKS", "VOLUME_SMOOTH_FORMS", "VOLUME_PHYSICS_FORMS",
                 "VOLUME_FORMS", "VOLUME_FIELDS", "VOLUME_RADII"):
        assert getattr(config, name) == getattr(jconfig, name), name
    assert "interior_split" not in config.PENDING_KNOBS
    assert "rank" not in config.PENDING_KNOBS
    for key in ("smooth", "physics"):
        assert {k for k in kernels.registered_keys(key) if k[0] == 3} == {
            k for k in jkernels.registered_keys(key) if k[0] == 3}


# ------------------------------------------------------------ 6-face halo


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("grid,dhw,r", [
    ((2, 4), (3, 8, 8), 1),   # a generic grid
    ((1, 4), (2, 6, 8), 2),   # H unsplit (self-wrap)
    ((4, 1), (2, 8, 6), 2),   # W unsplit
    ((2, 4), (1, 4, 8), 1),   # every cell within r of a face
])
def test_halo_exchange_matches_global_pad_and_jax(grid, dhw, r, boundary):
    R, C = grid
    D, H, W = dhw
    vol = _vol(np.random.default_rng(3), D, H, W)
    bh, bw = H // R, W // C
    xs, _ = driver.prepare_volume(vol, _grid(grid), boundary)
    out = halo3.volume_halo_exchange(xs, r, grid, boundary)
    pg = oracle3.pad_global(vol, r, boundary)
    fn = jax.jit(shard_map(
        lambda b: jhalo3.volume_halo_exchange(b, r, grid, boundary),
        mesh=_jax_mesh(grid), in_specs=SPEC, out_specs=SPEC,
        check_vma=False))
    jout = np.asarray(fn(jax.device_put(
        jnp.asarray(vol), jdriver.volume_sharding(_jax_mesh(grid)))))
    ph, pw = bh + 2 * r, bw + 2 * r
    for i in range(R):
        for j in range(C):
            got = out[i * C + j].numpy()
            want = pg[:, :, i * bh:i * bh + ph, j * bw:j * bw + pw]
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, jout[:, :, i * ph:(i + 1) * ph, j * pw:(j + 1) * pw])


def test_halo_exchange_error_surfaces():
    blk = torch.zeros((1, 2, 4, 4, 4))
    with pytest.raises(ValueError, match="boundary"):
        halo3.volume_halo_exchange(blk, 1, (1, 1), "moebius")
    with pytest.raises(ValueError, match="F, D, h, w"):
        halo3.volume_halo_exchange(blk[:, 0], 1, (1, 1), "zero")
    with pytest.raises(ValueError, match="periodic depth wrap"):
        halo3.volume_halo_exchange(torch.zeros((1, 2, 2, 8, 8)), 3, (1, 1),
                                   "periodic")


# ------------------------------------------------- forms vs JAX and oracle


@pytest.mark.parametrize("name", VOLUME_FORMS)
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_forms_match_jax_and_oracle(name, boundary):
    rng = np.random.default_rng(11)
    if boundary == "periodic":
        d, h, w = 6, 24, 40       # divisible on 2x4
    else:
        d, h, w = 6, 22, 36       # pads to 24x40: the rim mask matters
    vol = _vol(rng, d, h, w)
    got = driver.volume_iterate(vol, name, 3, grid=_grid((2, 4)),
                                boundary=boundary)
    assert got.dtype == torch.float32 and tuple(got.shape) == vol.shape
    got = got.numpy()
    want = jdriver.volume_iterate(vol, name, 3, mesh=_jax_mesh((2, 4)),
                                  boundary=boundary)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, oracle3.run_oracle(vol, name, 3, boundary),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["fd7", "wave", "grayscott"])
def test_oracle3_is_the_jax_packages(name):
    vol = _vol(np.random.default_rng(2), 4, 10, 12)
    for boundary in BOUNDARIES:
        np.testing.assert_array_equal(
            oracle3.run_oracle(vol, name, 2, boundary),
            joracle3.run_oracle(vol, name, 2, boundary))


@pytest.mark.parametrize("base", ["fd7", "fd25"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_stack_twins_byte_identical(base, boundary):
    vol = _vol(np.random.default_rng(5), 6, 24, 40)
    g = _grid((2, 4))
    a = driver.volume_iterate(vol, base, 4, grid=g, boundary=boundary)
    b = driver.volume_iterate(vol, base + "_stack", 4, grid=g,
                              boundary=boundary)
    assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("name", ["fd7", "fd25", "wave", "grayscott"])
def test_forms_bitwise_grid_invariant(name):
    vol = _vol(np.random.default_rng(7), 6, 22, 38)
    outs = [driver.volume_iterate(vol, name, 3, grid=_grid(g)).numpy()
            for g in ((1, 1), (2, 4), (4, 2))]
    for other in outs[1:]:
        assert outs[0].tobytes() == other.tobytes()


@pytest.mark.parametrize("name", ["fd7", "fd25", "wave", "grayscott"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_temporal_fusion_is_bitwise(name, boundary):
    # The same per-cell ops on deeper ghosts, re-masked each level: eager
    # PyTorch rounds every op alike, so fusion changes no bit (the JAX
    # package holds it to 1 ulp: XLA contracts its programs differently).
    vol = _vol(np.random.default_rng(9), 8, 24, 40)   # D >= r*fuse
    g = _grid((2, 4))
    a = driver.volume_iterate(vol, name, 4, grid=g, boundary=boundary,
                              fuse=1).numpy()
    for fuse in (2, 4) if VOLUME_RADII[name] == 1 else (2,):
        b = driver.volume_iterate(vol, name, 4, grid=g, boundary=boundary,
                                  fuse=fuse).numpy()
        assert a.tobytes() == b.tobytes(), fuse
    want = jdriver.volume_iterate(vol, name, 4, mesh=_jax_mesh((2, 4)),
                                  boundary=boundary, fuse=2)
    np.testing.assert_allclose(a, want, rtol=0, atol=ATOL)


def test_converge_chunks_match_fixed_count_bytes():
    vol = _vol(np.random.default_rng(13), 4, 16, 16)
    g = _grid((2, 4))
    want = driver.volume_iterate(vol, "fd7", 8, grid=g).numpy()
    jwant = jdriver.volume_iterate(vol, "fd7", 8, mesh=_jax_mesh((2, 4)))
    for check_every in (3, 4, 8):
        driver.volume_converge.readbacks = 0
        state, done, diff = driver.volume_converge(
            vol, "fd7", tol=0.0, max_iters=8, check_every=check_every,
            grid=g, fuse=2)
        assert done == 8 and diff >= 0.0
        assert driver.volume_converge.readbacks == -(-8 // check_every)
        assert state.numpy().tobytes() == want.tobytes()
        jstate, jdone, jdiff = jdriver.volume_converge(
            vol, "fd7", tol=0.0, max_iters=8, check_every=check_every,
            mesh=_jax_mesh((2, 4)))
        assert jdone == done and abs(jdiff - diff) <= ATOL
    np.testing.assert_allclose(want, jwant, rtol=0, atol=ATOL)


def test_converge_stream_matches_jax():
    vol = _vol(np.random.default_rng(17), 4, 16, 16)
    driver.volume_converge_stream.readbacks = 0
    rows = list(driver.volume_converge_stream(
        vol, "fd7", tol=0.0, max_iters=9, check_every=4, grid=_grid((2, 4))))
    jrows = list(jdriver.volume_converge_stream(
        vol, "fd7", tol=0.0, max_iters=9, check_every=4,
        mesh=_jax_mesh((2, 4))))
    assert [r[1] for r in rows] == [r[1] for r in jrows] == [4, 8, 9]
    assert driver.volume_converge_stream.readbacks == 3
    diffs = [r[2] for r in rows]
    assert diffs == sorted(diffs, reverse=True)
    for (s, _, d), (js, _, jd) in zip(rows, jrows):
        assert isinstance(s, np.ndarray)
        np.testing.assert_allclose(s, js, rtol=0, atol=ATOL)
        assert abs(d - jd) <= ATOL
    # Stopped by tol: the first chunk whose diff is below it ends the run.
    stop = list(driver.volume_converge_stream(
        vol, "fd7", tol=diffs[1] * 1.0001, max_iters=40, check_every=4,
        grid=_grid((1, 1))))
    assert [r[1] for r in stop] == [4, 8]


def test_iterate_zero_iters_and_defaults_to_the_card():
    vol = _vol(np.random.default_rng(1), 2, 4, 4)
    out = driver.volume_iterate(vol, "fd7", 0, grid=_grid((1, 1)))
    np.testing.assert_array_equal(out.numpy(), vol)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            driver.volume_iterate(vol, "fd7", 1)


# ----------------------------------------------------- geometry + errors


def test_geometry_error_surfaces():
    g = _grid((2, 4))
    rng = np.random.default_rng(1)
    with pytest.raises(ValueError, match="interleaved field pairs"):
        driver.volume_iterate(rng.random((3, 4, 8, 8)), "fd7", 1, grid=g)
    with pytest.raises(ValueError, match="grid-divisible"):
        driver.volume_iterate(_vol(rng, 4, 9, 8), "fd7", 1, grid=g,
                              boundary="periodic")
    with pytest.raises(ValueError, match="fuse"):
        driver.volume_iterate(_vol(rng, 4, 8, 8), "fd7", 8, grid=g, fuse=8)
    with pytest.raises(ValueError, match="no kernel form registered"):
        driver.volume_iterate(_vol(rng, 4, 8, 8), "fd9", 1, grid=g)
    with pytest.raises(ValueError, match=r"\(F, D, H, W\)"):
        driver.volume_iterate(rng.random((2, 8, 8)), "fd7", 1, grid=g)


# ------------------------------------------------------ rank-3 transfer


def _jax_transfer3(form_name, x, grid, depth, valid_hw, block_hw, boundary):
    build = jkernels.resolve(3, form_name, boundary).build
    fn = jax.jit(shard_map(
        build(grid, depth, valid_hw, block_hw, boundary),
        mesh=_jax_mesh(grid), in_specs=SPEC, out_specs=SPEC,
        check_vma=False))
    return np.asarray(fn(jax.device_put(
        jnp.asarray(x, jnp.float32),
        jdriver.volume_sharding(_jax_mesh(grid)))))


def _port_transfer3(form_name, x, grid, depth, valid_hw, block_hw, boundary):
    op = kernels.resolve(3, form_name, boundary).build(
        grid, depth, valid_hw, block_hw, boundary)
    xs, _ = driver.prepare_volume(x, _grid(grid), boundary)
    out = op(xs)
    return driver.unstack_volume(out, grid, (out.shape[-2] * grid[0],
                                             out.shape[-1] * grid[1]))


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_restrict_fw3_matches_jax(boundary, grid):
    D, H, W = 8, 16, 8
    vol = _vol(np.random.default_rng(19), D, H, W)
    R, C = grid
    args = (vol, grid, D, (H, W), (H // R, W // C), boundary)
    got = _port_transfer3("restrict_fw", *args).numpy()
    want = _jax_transfer3("restrict_fw", *args)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    cd = transfer.coarse_extent(D, boundary)
    assert not got[:, cd:].any()


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_prolong_trilinear_matches_jax(boundary, grid):
    D, H, W = 8, 16, 8
    R, C = grid
    coarse = np.random.default_rng(23).random(
        (VOLUME_FIELDS, D // 2, H // 2, W // 2), dtype=np.float32)
    if boundary == "zero":
        coarse[:, transfer.coarse_extent(D, boundary):] = 0.0
        coarse[:, :, transfer.coarse_extent(H, boundary):] = 0.0
        coarse[:, :, :, transfer.coarse_extent(W, boundary):] = 0.0
    args = (coarse, grid, D, (H, W), (H // R, W // C), boundary)
    got = _port_transfer3("prolong_trilinear", *args).numpy()
    assert got.shape == (VOLUME_FIELDS, D, H, W)
    np.testing.assert_allclose(got, _jax_transfer3("prolong_trilinear",
                                                   *args), rtol=0, atol=1e-6)


def test_transfer3_rejects_odd_geometry():
    with pytest.raises(ValueError, match="even depth"):
        transfer.build_restrict_fw3((1, 1), 7, (8, 8), (8, 8))
    with pytest.raises(ValueError, match="even per-device blocks"):
        transfer.build_prolong_trilinear((1, 1), 8, (9, 8), (9, 8))


# ------------------------------------------------- cost model arithmetic


def test_volume_cost_model_mirrors_jax():
    assert costmodel.VOLUME_FORM_TAPS == jcost.VOLUME_FORM_TAPS
    assert set(costmodel.VOLUME_FORM_TAPS) == set(VOLUME_FORMS)
    for storage in ("f32", "bf16"):
        assert (costmodel.volume_bytes_per_cell_iter(storage, fields=2)
                == jcost.volume_bytes_per_cell_iter(storage, fields=2))
    hw = costmodel.H100
    kw = dict(grid=(2, 4), block_hw=(12, 10), depth=6, fuse=1, hw=hw)
    s7 = costmodel.predict_volume_seconds_per_cell_iter(
        radius=VOLUME_RADII["fd7"], name="fd7", **kw)
    s25 = costmodel.predict_volume_seconds_per_cell_iter(
        radius=VOLUME_RADII["fd25"], name="fd25", **kw)
    assert s25 > s7 > 0
    solo = costmodel.predict_volume_seconds_per_cell_iter(
        grid=(1, 1), block_hw=(24, 40), depth=6, radius=1, fuse=1,
        name="fd7", hw=hw)
    assert solo < s7
    # At 1x1 the roof is the JAX package's formula on the card's rates.
    jhw = jcost.HardwareModel("h100", hbm_gbps=hw.hbm_gbps,
                              flop_gops=hw.flop_gops, ici_gbps=1.0,
                              exchange_lat_s=0.0)
    for name in VOLUME_FORMS:
        args = ((1, 1), (64, 64), 64, VOLUME_RADII[name], 2, name)
        assert costmodel.predict_volume_seconds_per_cell_iter(
            *args, hw=hw) == pytest.approx(
            jcost.predict_volume_seconds_per_cell_iter(*args, hw=jhw))


# --------------------------------------------------------------- CLI arm


def _cli_pair(tmp_path, capsys, vol, tail, name="vol.raw"):
    """The port's and the JAX CLI's ``run --rank 3`` on the same file:
    (rc, out line, output array) each."""
    src = tmp_path / name
    vol.tofile(src)
    F, D, H, W = vol.shape
    res = []
    for main, out, extra in ((cli_main, tmp_path / "p.raw",
                              ["--device", "cpu"]),
                             (jcli.main, tmp_path / "j.raw", [])):
        rc = main(["run", str(src), str(H), str(W), *tail[:1], "grey", "-o",
                   str(out), "--rank", "3", "--depth", str(D), *tail[1:],
                   *extra])
        said = capsys.readouterr()
        got = (np.fromfile(out, np.float32).reshape(vol.shape)
               if rc == 0 else None)
        line = said.out.strip().splitlines()[-1] if rc == 0 else said.err
        res.append((rc, line.replace(str(out), "OUT"), got))
    return res


@pytest.mark.parametrize("name,tail", [
    ("wave", ["5", "--filter", "wave", "--boundary", "periodic", "--mesh",
              "2x2"]),
    ("fd25", ["3", "--filter", "fd25", "--mesh", "2x2", "--fuse", "2"]),
    ("grayscott", ["8", "--filter", "grayscott", "--boundary", "periodic",
                   "--mesh", "2x2", "--converge", "0.0", "--check-every",
                   "4"]),
    ("fd7", ["200", "--filter", "fd7", "--converge", "1e-3",
             "--check-every", "7"]),
])
def test_cli_rank3_matches_jax_cli(tmp_path, capsys, name, tail):
    rng = np.random.default_rng(11)
    vol = rng.random((2, 8, 16, 16), dtype=np.float32)
    if name == "grayscott":
        # The classic bounded start (U = 1, V = 0, a perturbed blob).
        vol = np.zeros_like(vol)
        vol[0] = 1.0
        vol[0, :, 6:10, 6:10] = 0.5
        vol[1, :, 6:10, 6:10] = 0.25
        vol += 0.01 * rng.random(vol.shape, dtype=np.float32)
    (rc, line, got), (jrc, jline, jgot) = _cli_pair(tmp_path, capsys, vol,
                                                    tail)
    assert rc == jrc == 0
    np.testing.assert_allclose(got, jgot, rtol=0, atol=2e-4)
    if "--converge" in tail:
        assert line.startswith("volume converged after ")
        # The same iteration count (the diff's last digits may differ).
        assert line.split(" iters")[0] == jline.split(" iters")[0]
    else:
        assert line == jline
        iters = int(tail[0])
        boundary = "periodic" if "periodic" in tail else "zero"
        np.testing.assert_allclose(
            got, oracle3.run_oracle(vol, name, iters, boundary), rtol=0,
            atol=2e-4)


@pytest.mark.parametrize("tail,message", [
    (["2", "--depth", "0"], "--depth"),
    (["2", "--filter", "blur3"], "rank-3 form"),
    (["2", "--filter", "fd7", "--solver", "multigrid"], "jacobi only"),
    (["2", "--filter", "fd7", "--depth", "8"], "expected"),
])
def test_cli_rank3_rejections_are_the_jax_clis(tmp_path, capsys, tail,
                                                message):
    vol = np.random.default_rng(0).random((2, 4, 8, 8), dtype=np.float32)
    (rc, err, _), (jrc, jerr, _) = _cli_pair(tmp_path, capsys, vol, tail)
    assert rc == jrc == 2
    assert message in err and message in jerr
    assert not (tmp_path / "p.raw").exists()


def test_cli_rank3_needs_depth(tmp_path, capsys):
    src = tmp_path / "vol.raw"
    np.zeros((2, 4, 8, 8), np.float32).tofile(src)
    assert cli_main(["run", str(src), "8", "8", "2", "grey", "-o",
                     str(tmp_path / "o.raw"), "--rank", "3", "--device",
                     "cpu"]) == 2
    assert "--depth" in capsys.readouterr().err


# ------------------------------------------------- on a grid of slots (10c)


def _slots(shape):
    return mesh.make_grid(shape, devices=["cpu"] * (shape[0] * shape[1]))


@pytest.mark.parametrize("grid_shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_volumes_on_slots_match_jax_and_one_device(grid_shape, boundary):
    vol = _vol(np.random.default_rng(21), 8, 16, 24)
    slots, one = _slots(grid_shape), _grid(grid_shape)
    for name, fuse in (("fd7", 2), ("fd25", 1), ("wave", 2),
                       ("grayscott", 1)):
        got = driver.volume_iterate(vol, name, 3, grid=slots,
                                    boundary=boundary, fuse=fuse)
        assert got.numpy().tobytes() == driver.volume_iterate(
            vol, name, 3, grid=one, boundary=boundary,
            fuse=fuse).numpy().tobytes()
        want = jdriver.volume_iterate(vol, name, 3,
                                      mesh=_jax_mesh(grid_shape),
                                      boundary=boundary, fuse=fuse)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    driver.volume_converge.readbacks = 0
    state, done, diff = driver.volume_converge(
        vol, "fd7", tol=0.0, max_iters=9, check_every=4, grid=slots,
        boundary=boundary, fuse=2)
    assert driver.volume_converge.readbacks == 3 and done == 9
    ostate, odone, odiff = driver.volume_converge(
        vol, "fd7", tol=0.0, max_iters=9, check_every=4, grid=one,
        boundary=boundary, fuse=2)
    assert torch.equal(state, ostate) and (done, diff) == (odone, odiff)
    jstate, jdone, jdiff = jdriver.volume_converge(
        vol, "fd7", tol=0.0, max_iters=9, check_every=4,
        mesh=_jax_mesh(grid_shape), boundary=boundary)
    assert jdone == done and abs(jdiff - diff) <= ATOL
    np.testing.assert_allclose(state.numpy(), jstate, rtol=0, atol=ATOL)
    rows = list(driver.volume_converge_stream(
        vol, "fd7", tol=0.0, max_iters=9, check_every=4, grid=slots,
        boundary=boundary))
    assert [r[1] for r in rows] == [4, 8, 9]
    assert rows[-1][0].tobytes() == ostate.numpy().tobytes()


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("r", [1, 2])
def test_volume_exchange_per_block_is_the_stacked_exchange(boundary, r):
    vol = torch.from_numpy(_vol(np.random.default_rng(23), 6, 16, 24))
    slots = _slots((2, 4))
    blocks, _ = driver.prepare_volume(vol, slots, boundary)
    stacked, _ = driver.prepare_volume(vol, _grid((2, 4)), boundary)
    got = halo3.volume_exchange_per_block(blocks, r, (2, 4), boundary)
    want = halo3.volume_halo_exchange(stacked, r, (2, 4), boundary)
    for k, b in enumerate(p for row in got for p in row):
        assert torch.equal(b, want[k])
    assert blocks[0][0].data_ptr() != blocks[0][1].data_ptr()
