"""Run-to-convergence in the port (``parallel/step.py`` ``sharded_converge``
and ``sharded_converge_stream``, ``models/jacobi.py``, ``run --converge``,
``utils/bench.bench_converge``) against the JAX package, on the forced
8-device CPU mesh of the same grid shape.

The same seeded inputs go through both.  u8 (quantize) mode must give the
same iteration count and the same bytes for every backend pair (the port's
``cuda`` / ``cuda_sep`` / ``cuda_rdma`` against ``pallas`` / ``pallas_sep``
/ ``pallas_rdma``), grid, boundary, storage and fuse; float mode the same
count and fields within ``stencil.float_tolerance`` (FMA contraction in the
JAX tiers).  The port's plain path equals the serial oracle
``run_to_convergence_f32`` exactly.  Also here: the CLI's unported flags and
subcommands (each exits 2 naming its ROADMAP item), and the flags of items
ported since (each runs, to the plain run's bytes or the JAX CLI's).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from parallel_convolution_tpu import cli as jcli
from parallel_convolution_tpu.models import JacobiSolver as JJacobiSolver
from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.parallel import step as jstep
from parallel_convolution_tpu.utils import bench as jbench
from parallel_convolution_tpu_torch import convert
from parallel_convolution_tpu_torch.cli import main as cli_main
from parallel_convolution_tpu_torch.models import JacobiSolver
from parallel_convolution_tpu_torch.ops import oracle, stencil
from parallel_convolution_tpu_torch.parallel import mesh, step
from parallel_convolution_tpu_torch.utils import bench, imageio
from parallel_convolution_tpu_torch.utils.config import BACKEND_FROM_REFERENCE

HW = (32, 48)
# Keys of the JAX bench row that the port's row lacks: none since the
# exchange attribution (obs, item 9) was ported.
JAX_ONLY_BENCH_KEYS: set[str] = set()


def _jax_mesh(shape):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _filters(name):
    jf = jfilters.get_filter(name)
    return jf, convert.filter_from_numpy(jf.name, jf.taps, jf.dyadic)


def _image_field(mode, seed):
    img = imageio.generate_test_image(*HW, mode, seed=seed)
    return imageio.interleaved_to_planar(img).astype(np.float32)


def _float_field(seed):
    return bench.converge_input(HW, 1, seed)


# u8 (quantize) mode, blur3: (port backend, JAX backend, grid, storage,
# boundary, fuse, check_every, max_iters, tol, mode).  tol 2.5 stops the
# 60-iteration runs early (after 20-40 iterations); check_every 3 with
# max_iters 7 is the 3 + 3 + 1 schedule; fuse 10 with check_every 10 is
# clamped to 9.
U8_CASES = [
    ("shifted", "shifted", (1, 1), "f32", "zero", 1, 10, 60, 2.5, "grey"),
    ("shifted", "shifted", (2, 4), "u8", "periodic", 3, 3, 7, 0.5, "grey"),
    ("cuda", "pallas", (1, 1), "u8", "zero", 10, 10, 60, 2.5, "grey"),
    ("cuda", "pallas", (2, 2), "bf16", "periodic", 3, 10, 60, 2.5, "rgb"),
    ("cuda", "pallas", (2, 4), "f32", "zero", 1, 3, 7, 0.5, "grey"),
    ("cuda_sep", "pallas_sep", (1, 1), "bf16", "zero", 3, 10, 60, 2.5, "rgb"),
    ("cuda_sep", "pallas_sep", (2, 2), "u8", "zero", 10, 10, 60, 2.5, "grey"),
    ("cuda_sep", "pallas_sep", (2, 4), "f32", "periodic", 3, 3, 7, 0.5,
     "grey"),
    ("cuda_rdma", "pallas_rdma", (2, 2), "u8", "zero", 3, 10, 20, 2.5, "grey"),
    ("cuda_rdma", "pallas_rdma", (1, 1), "bf16", "periodic", 10, 3, 7, 0.5,
     "grey"),
]


@pytest.mark.parametrize(
    "backend,jbackend,grid_shape,storage,boundary,fuse,check_every,"
    "max_iters,tol,mode", U8_CASES)
def test_converge_u8_matches_jax(backend, jbackend, grid_shape, storage,
                                 boundary, fuse, check_every, max_iters, tol,
                                 mode):
    jf, tf = _filters("blur3")
    x = _image_field(mode, seed=3)
    kw = dict(check_every=check_every, quantize=True, storage=storage,
              boundary=boundary, fuse=fuse)
    want, jiters = jstep.sharded_converge(
        x, jf, tol, max_iters, mesh=_jax_mesh(grid_shape), backend=jbackend,
        **kw)
    before = step.sharded_converge.readbacks
    got, iters = step.sharded_converge(
        x, tf, tol, max_iters, grid=mesh.make_grid(grid_shape, "cpu"),
        backend=backend, **kw)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert iters == int(jiters)
    # One readback a chunk.
    assert step.sharded_converge.readbacks - before == -(-iters // check_every)
    np.testing.assert_array_equal(got.numpy().astype(np.uint8),
                                  np.asarray(want).astype(np.uint8))


# Float mode, jacobi3 on a normal field: tol 0.26 stops the 60-iteration
# runs after 40 iterations.
FLOAT_CASES = [
    ("shifted", "shifted", (2, 2), "zero", 1, 10, 60),
    ("cuda", "pallas", (2, 4), "periodic", 10, 10, 60),
    ("cuda_sep", "pallas_sep", (1, 1), "zero", 3, 3, 7),
    ("cuda_rdma", "pallas_rdma", (2, 2), "zero", 3, 10, 60),
]


@pytest.mark.parametrize(
    "backend,jbackend,grid_shape,boundary,fuse,check_every,max_iters",
    FLOAT_CASES)
def test_converge_float_matches_jax(backend, jbackend, grid_shape, boundary,
                                    fuse, check_every, max_iters):
    jf, tf = _filters("jacobi3")
    x = _float_field(seed=5)
    kw = dict(check_every=check_every, boundary=boundary, fuse=fuse)
    want, jiters = jstep.sharded_converge(
        x, jf, 0.26, max_iters, mesh=_jax_mesh(grid_shape), backend=jbackend,
        **kw)
    got, iters = step.sharded_converge(
        x, tf, 0.26, max_iters, grid=mesh.make_grid(grid_shape, "cpu"),
        backend=backend, **kw)
    assert iters == int(jiters)
    rtol, atol = stencil.float_tolerance(tf, iters, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("grid_shape,check_every,boundary", [
    ((1, 1), 1, "zero"), ((2, 2), 3, "zero"), ((2, 4), 4, "periodic")])
def test_plain_path_matches_oracle_exactly(grid_shape, check_every,
                                           boundary):
    _, tf = _filters("jacobi3")
    x = _float_field(seed=6)
    want, witers = oracle.run_to_convergence_f32(x[0], tf, 0.3, 50,
                                                 check_every, boundary)
    got, iters = step.sharded_converge(
        x, tf, 0.3, 50, check_every=check_every,
        grid=mesh.make_grid(grid_shape, "cpu"), boundary=boundary)
    assert iters == witers
    np.testing.assert_array_equal(got.numpy()[0], want)


def test_identity_stops_after_the_first_chunk():
    jf, tf = _filters("identity3")
    x = _image_field("grey", seed=8)
    want, jiters = jstep.sharded_converge(x, jf, 1e-6, 100, check_every=4,
                                          mesh=_jax_mesh((2, 2)),
                                          quantize=True, backend="pallas")
    got, iters = step.sharded_converge(x, tf, 1e-6, 100, check_every=4,
                                       grid=mesh.make_grid((2, 2), "cpu"),
                                       quantize=True, backend="cuda")
    assert iters == int(jiters) == 4
    np.testing.assert_array_equal(got.numpy(), x)
    np.testing.assert_array_equal(np.asarray(want), x)


def test_max_iters_zero_returns_the_input():
    jf, tf = _filters("blur3")
    x = _image_field("rgb", seed=9)
    want, jiters = jstep.sharded_converge(x, jf, 0.5, 0, check_every=5,
                                          mesh=_jax_mesh((2, 2)),
                                          quantize=True)
    before = step.sharded_converge.readbacks
    got, iters = step.sharded_converge(x, tf, 0.5, 0, check_every=5,
                                       grid=mesh.make_grid((2, 2), "cpu"),
                                       quantize=True)
    assert iters == int(jiters) == 0
    assert step.sharded_converge.readbacks == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), x)
    assert list(step.sharded_converge_stream(x, tf, 0.5, 0,
                                             device="cpu")) == []


@pytest.mark.parametrize("backend,jbackend", [("shifted", "shifted"),
                                              ("cuda", "pallas")])
def test_nan_diff_stops_the_run(backend, jbackend):
    jf, tf = _filters("jacobi3")
    x = _float_field(seed=10)
    x[0, 5, 7] = np.nan
    # One block: the JAX diff is NaN and its while_loop stops.  (On a
    # grid the JAX package's lax.pmax on the CPU drops one device's NaN,
    # so it runs on until every block holds one; the port's reduction
    # over the blocks keeps the NaN, as the serial diff over the field.)
    _, jiters = jstep.sharded_converge(x, jf, 1e-3, 50, check_every=5,
                                       mesh=_jax_mesh((1, 1)),
                                       backend=jbackend)
    for grid_shape in ((1, 1), (2, 2)):
        got, iters = step.sharded_converge(
            x, tf, 1e-3, 50, check_every=5,
            grid=mesh.make_grid(grid_shape, "cpu"), backend=backend)
        assert iters == int(jiters) == 5
    diffs = [d for _, _, d in step.sharded_converge_stream(
        x, tf, 1e-3, 50, check_every=5, device="cpu", backend=backend)]
    assert len(diffs) == 1 and np.isnan(diffs[0])


@pytest.mark.parametrize("fuse,check_every", [(12, 10), (9, 10)])
def test_fuse_clamp_error_text_matches_jax(fuse, check_every):
    # 16x16 on a 2x2 grid: 8x8 blocks, too small for 9 levels of radius 1.
    jf, tf = _filters("blur3")
    x = np.zeros((1, 16, 16), np.float32)
    kw = dict(check_every=check_every, fuse=fuse, quantize=True)
    with pytest.raises(ValueError) as jerr:
        jstep.sharded_converge(x, jf, 0.5, 20, mesh=_jax_mesh((2, 2)),
                               backend="pallas", **kw)
    with pytest.raises(ValueError) as err:
        step.sharded_converge(x, tf, 0.5, 20,
                              grid=mesh.make_grid((2, 2), "cpu"),
                              backend="cuda", **kw)
    assert str(err.value) == str(jerr.value)
    assert ("clamped to 9" in str(err.value)) == (fuse != 9)
    # The stream clamps per chunk, with the chunk's text.
    with pytest.raises(ValueError) as jerr:
        next(jstep.sharded_converge_stream(x, jf, 0.5, 20,
                                           mesh=_jax_mesh((2, 2)),
                                           backend="pallas", **kw))
    with pytest.raises(ValueError) as err:
        next(step.sharded_converge_stream(x, tf, 0.5, 20, device="cpu",
                                          grid=mesh.make_grid((2, 2), "cpu"),
                                          backend="cuda", **kw))
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("backend,jbackend,grid_shape,storage,fuse", [
    ("cuda", "pallas", (2, 2), "u8", 4),
    ("cuda_rdma", "pallas_rdma", (2, 4), "bf16", 3),
])
def test_stream_matches_whole_run_and_jax_stream(backend, jbackend,
                                                 grid_shape, storage, fuse):
    jf, tf = _filters("blur3")
    x = _image_field("grey", seed=3)
    kw = dict(check_every=10, quantize=True, storage=storage, fuse=fuse)
    jrows = list(jstep.sharded_converge_stream(
        x, jf, 2.5, 30, mesh=_jax_mesh(grid_shape), backend=jbackend, **kw))
    grid = mesh.make_grid(grid_shape, "cpu")
    before = step.sharded_converge_stream.readbacks
    rows = list(step.sharded_converge_stream(x, tf, 2.5, 30, grid=grid,
                                             backend=backend, **kw))
    assert step.sharded_converge_stream.readbacks - before == len(rows)
    assert [(d, v) for _, d, v in rows] == [(d, v) for _, d, v in jrows]
    for (img, _, _), (jimg, _, _) in zip(rows, jrows):
        assert isinstance(img, np.ndarray) and img.dtype == np.float32
        np.testing.assert_array_equal(img, np.asarray(jimg))
    whole, iters = step.sharded_converge(x, tf, 2.5, 30, grid=grid,
                                         backend=backend, **kw)
    assert iters == rows[-1][1]
    assert rows[-1][0].tobytes() == whole.numpy().tobytes()


def _reference_fields(grid_shape, backend, **kw):
    jf = jfilters.get_filter(kw.pop("filt", "jacobi3"))
    return dict(filt=(jf.name, np.asarray(jf.taps), jf.dyadic),
                mesh=grid_shape, backend=backend, **kw)


def _jax_solver(fields):
    kw = dict(fields)
    name, taps, dyadic = kw.pop("filt")
    return JJacobiSolver(filt=jfilters.Filter(name, taps, dyadic),
                         mesh=_jax_mesh(kw.pop("mesh")), **kw)


@pytest.mark.parametrize("grid_shape,backend,kw", [
    ((2, 2), "pallas", dict(tol=0.26, max_iters=60, check_every=10, fuse=4)),
    ((1, 1), "pallas_sep", dict(tol=2.5, max_iters=60, check_every=10,
                                quantize=True, storage="bf16", fuse=10,
                                filt="blur3")),
    ((2, 2), "pallas_rdma", dict(tol=2.5, max_iters=20, check_every=10,
                                 quantize=True, storage="u8", fuse=3,
                                 filt="blur3")),
])
def test_jacobi_solver_matches_jax(grid_shape, backend, kw):
    fields = _reference_fields(grid_shape, backend, **kw)
    port = convert.jacobi_solver_from_reference(fields, device="cpu")
    ref = _jax_solver(fields)
    assert port.backend == {"pallas": "cuda", "pallas_sep": "cuda_sep",
                            "pallas_rdma": "cuda_rdma"}[backend]
    assert port.grid.shape == grid_shape and port.last_mg is None
    x = (_image_field("grey", seed=3) if kw.get("quantize")
         else _float_field(seed=5))
    want, jiters = ref.solve(x)
    got, iters = port.solve(x)
    assert isinstance(got, np.ndarray) and iters == jiters
    if kw.get("quantize"):
        np.testing.assert_array_equal(got.astype(np.uint8),
                                      want.astype(np.uint8))
    else:
        rtol, atol = stencil.float_tolerance(port.filt, iters, torch.float32)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_jacobi_solver_pending_knobs():
    # Multigrid (item 5) is ported: the solver runs it, and Jacobi ignores
    # mg_levels as the JAX solver does (tests/test_torch_multigrid.py
    # holds the V-cycle against JAX).
    x = np.zeros((1, 8, 8), np.float32)
    s = JacobiSolver(solver="multigrid", tol=0.1, max_iters=10, device="cpu")
    out, cycles = s.solve(x)
    assert cycles == 1 and s.last_mg.converged and not out.any()
    assert JacobiSolver(mg_levels=3, tol=0.1, max_iters=5,
                        device="cpu").solve(x)[1] == 5
    # interior_split (item 2) is ported: Jacobi and the V-cycle take it
    # (tests/test_torch_interior_split.py holds the split against JAX).
    assert JacobiSolver(solver="multigrid", interior_split=True, tol=0.1,
                        max_iters=10, device="cpu").solve(x)[1] == 1
    # overlap (item 10b) is ported: on one CPU device it is clamped and
    # the solve is the serialized one.
    assert JacobiSolver(overlap=True, tol=0.1, max_iters=5,
                        device="cpu").solve(x)[1] == 5
    assert JacobiSolver(interior_split=True, tol=0.1, max_iters=5,
                        device="cpu").solve(x)[1] == 5
    with pytest.raises(ValueError, match="solver must be one of"):
        JacobiSolver(solver="newton", device="cpu")
    # set_grid (item 13) is ported: the solver swaps its grid and keeps
    # its configuration (tests/test_torch_elastic.py holds the runs).
    s = JacobiSolver(device="cpu", tol=0.1, max_iters=5)
    assert s.set_grid(mesh.make_grid((2, 2), "cpu")) is s
    assert s.grid.shape == (2, 2) and s.solve(x)[1] == 5
    assert step.sharded_converge(np.zeros((1, 8, 8), np.float32),
                                 _filters("jacobi3")[1], 0.1, 5,
                                 solver="multigrid", overlap=True,
                                 device="cpu")[1] == 1
    # Dataclass fields: the JAX solver's, with grid/device for mesh.
    jnames = {f.name for f in dataclasses.fields(JJacobiSolver)}
    names = {f.name for f in dataclasses.fields(JacobiSolver)}
    assert names == (jnames - {"mesh"}) | {"grid", "device"}


def test_converge_without_cuda_raises(monkeypatch):
    """With no grid and no device the run is on the card, never the CPU
    by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((1, 8, 8), np.float32)
    f = _filters("jacobi3")[1]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        step.sharded_converge(x, f, 0.1, 5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(step.sharded_converge_stream(x, f, 0.1, 5))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        JacobiSolver()


def test_auto_converge_caps_fuse_and_matches_shifted():
    _, tf = _filters("blur3")
    x = _image_field("grey", seed=3)
    grid = mesh.make_grid((2, 2), "cpu")
    want, witers = step.sharded_converge(x, tf, 2.5, 60, check_every=4,
                                         grid=grid, quantize=True)
    got, iters = step.sharded_converge(x, tf, 2.5, 60, check_every=4,
                                       grid=grid, quantize=True,
                                       backend="auto", fuse=None)
    assert iters == witers
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    _, fuse, _, _ = step._resolve_auto(grid, tf, "auto", 32, None, "f32",
                                       True, "zero", HW, 1, check_every=4)
    assert fuse == 3


def test_bench_converge_row_keys_match_jax():
    jf, tf = _filters("jacobi3")
    jrow = jbench.bench_converge(HW, jf, 0.26, 30, mesh=_jax_mesh((2, 2)),
                                 backend="pallas", fuse=3)
    row = bench.bench_converge(HW, tf, 0.26, 30,
                               grid=mesh.make_grid((2, 2), "cpu"),
                               backend="cuda", fuse=3)
    assert set(row) == set(jrow) | {"readbacks"}
    assert row["hosts"] == jrow["hosts"] == 1
    assert row["iters"] == jrow["iters"] == 30
    assert row["readbacks"] == 3 and row["converged"] is False
    assert row["residual"] == pytest.approx(jrow["residual"], rel=1e-5)
    assert row["checksum"] == pytest.approx(jrow["checksum"], rel=1e-5)
    assert (row["platform"], row["device_kind"]) == ("cpu", "cpu")


def test_bench_rows_stamp_topology_on_slots():
    # One process; the CPU slots are one distinct device, as the JAX
    # string counts devices: "1x<devices>:<kind>".
    _, tf = _filters("jacobi3")
    slots = mesh.make_grid((2, 2), devices="cpu,cpu,cpu,cpu")
    rows = [bench.bench_iterate((16, 16), tf, 2, grid=slots, reps=1),
            bench.bench_converge((16, 16), tf, 0.1, 4, grid=slots)]
    for row in rows:
        assert (row["hosts"], row["slice_topology"]) == (1, "1x1:cpu")
    one = bench.bench_iterate((16, 16), tf, 2, device="cpu", reps=1)
    assert (one["hosts"], one["slice_topology"]) == (1, "1x1:cpu")


# (loops, port flags, JAX flags): the plain run converges after 290
# iterations, the periodic one after 100; the cuda_rdma one stops at its cap.
@pytest.mark.parametrize("loops,extra,jextra", [
    (400, [], []),
    (40, ["--backend", "cuda_rdma", "--mesh", "2x2", "--storage", "u8",
          "--fuse", "8"],
     ["--backend", "pallas_rdma", "--mesh", "2x2", "--storage", "u8",
      "--fuse", "8"]),
    (200, ["--backend", "cuda_sep", "--mesh", "2x4", "--storage", "bf16",
           "--fuse", "32", "--boundary", "periodic"],
     ["--backend", "pallas_sep", "--mesh", "2x4", "--storage", "bf16",
      "--fuse", "32", "--boundary", "periodic"]),
])
def test_cli_converge_matches_jax_cli(tmp_path, capsys, loops, extra,
                                      jextra):
    src = tmp_path / "in.raw"
    imageio.write_raw(src, imageio.generate_test_image(*HW, "grey", seed=3))
    out, jout = tmp_path / "out.raw", tmp_path / "jout.raw"
    head = ["run", str(src), str(HW[0]), str(HW[1]), str(loops), "grey"]
    conv = ["--converge", "0.5", "--check-every", "10"]
    assert jcli.main(head + ["-o", str(jout)] + conv + jextra) == 0
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    assert cli_main(head + ["-o", str(out), "--device", "cpu"] + conv
                    + extra) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("converged after ")
    assert line.replace(str(out), "") == jline.replace(str(jout), "")
    assert out.read_bytes() == jout.read_bytes()


ITEM12 = "item 12"
PENDING_ARGV = [
    (["--overlap", "on"], "item 10b"),
    (["--col-mode", "packed"], "item 10"),
    (["--col-mode", "strided"], "item 10"),
    (["--interior-split"], "item 2"),
    (["--fallback"], "item 3b"),
    (["--converge", "0.5", "--solver", "multigrid"], "item 5"),
    (["--converge", "0.5", "--mg-levels", "3"], "item 5"),
    (["--rank", "3"], "item 6"),
    (["--depth", "4"], "item 6"),
    (["--sharded-io"], "item 4"),
    (["--checkpoint", "{tmp}/ckpt", "--checkpoint-every", "2"], "item 4"),
    (["--checkpoint-every", "5"], "item 4"),
]
# Items ported since the cases above were written: their flags now run.
PORTED = ("item 3b", "item 4", "item 10", "item 10b")
# Ported items whose runs are held against the JAX CLI's on the same argv
# (the port's --device cpu and backend names mapped back): the same exit
# code (``--rank 3`` without ``--depth`` exits 2 in both) and, on 0, the
# same output.
PORTED_VS_JAX = ("item 2", "item 5", "item 6", ITEM12)


def _jax_argv(argv):
    names = {v: k for k, v in BACKEND_FROM_REFERENCE.items()}
    out = []
    for a in argv:
        if out and out[-1] == "--device":
            out.pop()
            continue
        out.append(names.get(a, a) if out and out[-1] == "--backend" else a)
    return out


@pytest.mark.parametrize("argv,item", PENDING_ARGV + [
    (["convert", "{src}", "8", "8", "grey", "-o", "{dst}"], ITEM12),
    (["info", "--device", "cpu"], ITEM12),
    (["bench", "8", "8", "3", "grey", "--backend", "cuda", "--device",
      "cpu"], ITEM12),
    (["serial", "{src}", "8", "8", "3", "grey", "-o", "{dst}", "--impl",
      "native"], ITEM12),
])
def test_cli_pending_flags_exit_2_naming_their_item(tmp_path, capsys, argv,
                                                    item):
    src, dst = tmp_path / "in.raw", tmp_path / "out.raw"
    imageio.write_raw(src, imageio.generate_test_image(8, 8, "grey", seed=1))
    if argv[0].startswith("--"):
        argv = ["run", str(src), "8", "8", "3", "grey", "-o", str(dst),
                "--device", "cpu"] + argv
    argv = [a.format(src=src, dst=dst, tmp=tmp_path) for a in argv]
    if item in PORTED_VS_JAX:
        # Ported since: the port exits 0 as the JAX CLI does on the same
        # argv, with its output file's bytes, or its JSON row's keys.
        jdst = tmp_path / "jout.raw"
        jargv = [str(jdst) if a == str(dst) else a for a in _jax_argv(argv)]
        rc = cli_main(argv)
        out = capsys.readouterr().out
        jrc = jcli.main(jargv)
        jout = capsys.readouterr().out
        assert rc == jrc == (2 if argv[-2:] == ["--rank", "3"] else 0)
        if rc:
            assert not dst.exists() and not jdst.exists()
            return
        if argv[0] == "bench":
            row = json.loads(out.strip().splitlines()[-1])
            jrow = json.loads(jout.strip().splitlines()[-1])
            assert set(jrow) - set(row) <= JAX_ONLY_BENCH_KEYS
        elif argv[0] == "info":
            assert "blur3" in out and "backends:" in out
        else:
            assert dst.read_bytes() == jdst.read_bytes()
        return
    if item in PORTED:
        # The flag works now: the run exits 0 with the plain run's bytes.
        plain = tmp_path / "plain.raw"
        assert cli_main(argv) == 0
        assert cli_main(["run", str(src), "8", "8", "3", "grey", "-o",
                         str(plain), "--device", "cpu"]) == 0
        assert dst.read_bytes() == plain.read_bytes()
        return
    assert cli_main(argv) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"{item} (" in err
    assert "unrecognized arguments" not in err and "invalid choice" not in err
    assert not dst.exists()


def test_cli_maps_jax_backend_names(tmp_path, capsys):
    src = tmp_path / "in.raw"
    imageio.write_raw(src, imageio.generate_test_image(8, 8, "grey", seed=1))
    for jname, name in (("pallas", "cuda"), ("pallas_sep", "cuda_sep"),
                        ("pallas_rdma", "cuda_rdma")):
        assert cli_main(["run", str(src), "8", "8", "3", "grey", "-o",
                         str(tmp_path / "o.raw"), "--device", "cpu",
                         "--backend", jname]) == 2
        err = capsys.readouterr().err
        assert f"the JAX package's {jname!r} is {name!r} here" in err
    # --overlap off and --serial --impl oracle are what the port runs.
    assert cli_main(["run", str(src), "8", "8", "3", "grey", "-o",
                     str(tmp_path / "o.raw"), "--device", "cpu",
                     "--overlap", "off"]) == 0
    assert cli_main(["serial", str(src), "8", "8", "3", "grey", "-o",
                     str(tmp_path / "s.raw"), "--impl", "oracle"]) == 0
    assert (tmp_path / "o.raw").read_bytes() == (tmp_path
                                                 / "s.raw").read_bytes()
