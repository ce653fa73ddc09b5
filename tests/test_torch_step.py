"""The port's iteration driver (parallel/step.py) and halo exchange against
the JAX package's, on the forced 8-device CPU mesh of the same grid shape.

Same seeded images through both: u8 (quantize) mode must give the same
bytes as the JAX ``sharded_iterate`` and the NumPy oracle for every backend
pair (the port's ``cuda`` / ``cuda_sep`` against ``pallas`` /
``pallas_sep``), grid shape and boundary, with fuse 1, fuse 2 and a tail.
Float mode agrees with the oracle exactly on the plain path and with the
JAX package within ``stencil.float_tolerance`` (FMA contraction there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from parallel_convolution_tpu.ops import conv as jconv
from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.parallel import halo as jhalo
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.parallel import step as jstep
from parallel_convolution_tpu.utils.jax_compat import shard_map
from parallel_convolution_tpu_torch import convert
from parallel_convolution_tpu_torch.ops import conv, oracle, stencil
from parallel_convolution_tpu_torch.parallel import halo, mesh, step
from parallel_convolution_tpu_torch.utils import imageio


def _jax_mesh(shape):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _filters(name):
    jf = jfilters.get_filter(name)
    return jf, convert.filter_from_numpy(jf.name, jf.taps, jf.dyadic)


def _image(boundary, mode, seed):
    # zero: an odd shape no grid divides (pad + re-mask); periodic needs
    # dimensions every grid under test divides.
    rows, cols = (37, 53) if boundary == "zero" else (24, 36)
    return imageio.generate_test_image(rows, cols, mode, seed=seed)


# (port backend, JAX backend, grid, storage, boundary, fuse, filter, mode)
CASES = [
    ("shifted", "shifted", (1, 1), "f32", "zero", 1, "blur3", "grey"),
    ("shifted", "shifted", (2, 4), "u8", "periodic", 2, "gaussian5", "grey"),
    ("separable", "separable", (2, 2), "bf16", "zero", 2, "gaussian5", "rgb"),
    ("separable", "separable", (4, 1), "f32", "periodic", 1, "blur3", "grey"),
    ("xla_conv", "xla_conv", (2, 4), "f32", "zero", 1, "edge5", "grey"),
    ("xla_conv", "xla_conv", (1, 1), "bf16", "periodic", 2, "blur3", "rgb"),
    ("cuda", "pallas", (1, 1), "u8", "zero", 2, "sharpen3", "grey"),
    ("cuda", "pallas", (2, 2), "bf16", "periodic", 2, "blur3", "rgb"),
    ("cuda", "pallas", (2, 4), "f32", "zero", 3, "blur3", "grey"),
    ("cuda", "pallas", (4, 1), "u8", "zero", 1, "edge5", "grey"),
    ("cuda_sep", "pallas_sep", (1, 1), "bf16", "zero", 2, "gaussian5", "rgb"),
    ("cuda_sep", "pallas_sep", (2, 4), "u8", "periodic", 2, "blur3", "grey"),
    ("cuda_sep", "pallas_sep", (4, 1), "bf16", "zero", 3, "blur3", "grey"),
    ("cuda_sep", "pallas_sep", (2, 2), "f32", "zero", 1, "gaussian5", "grey"),
]


@pytest.mark.parametrize(
    "backend,jbackend,grid_shape,storage,boundary,fuse,name,mode", CASES)
def test_sharded_iterate_matches_jax_and_oracle(backend, jbackend, grid_shape,
                                                storage, boundary, fuse, name,
                                                mode):
    # 5 iterations: fuse 2 -> two chunks + a tail of 1 (K1 on the card),
    # fuse 3 -> one chunk + a tail of 2 (K2 with T = 2).
    iters = 5
    jf, tf = _filters(name)
    img = _image(boundary, mode, seed=CASES.index(
        (backend, jbackend, grid_shape, storage, boundary, fuse, name, mode)))
    x = imageio.interleaved_to_planar(img).astype(np.float32)
    want = np.asarray(jstep.sharded_iterate(
        x, jf, iters, mesh=_jax_mesh(grid_shape), backend=jbackend,
        storage=storage, fuse=fuse, boundary=boundary)).astype(np.uint8)
    got = step.sharded_iterate(
        x, tf, iters, grid=mesh.make_grid(grid_shape, "cpu"), backend=backend,
        storage=storage, fuse=fuse, boundary=boundary)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy().astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    ref = oracle.run_serial_u8(img, tf, iters, boundary)
    np.testing.assert_array_equal(imageio.planar_to_interleaved(got), ref)


@pytest.mark.parametrize("backend,jbackend,fuse", [("shifted", "shifted", 1),
                                                   ("cuda", "pallas", 3)])
def test_float_mode_matches_oracle_and_jax(backend, jbackend, fuse):
    jf, tf = _filters("blur3")
    img = _image("zero", "grey", seed=7)
    x = img[None].astype(np.float32)
    iters = 4
    got = step.sharded_iterate(x, tf, iters, grid=mesh.make_grid((2, 2), "cpu"),
                               quantize=False, backend=backend, fuse=fuse)
    want = np.asarray(jstep.sharded_iterate(
        x, jf, iters, mesh=_jax_mesh((2, 2)), quantize=False,
        backend=jbackend, fuse=fuse))
    rtol, atol = stencil.float_tolerance(tf, iters, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    # The plain path rounds like NumPy: bit-identical to the float oracle.
    ref = oracle.run_serial_f32(img.astype(np.float32), tf, iters)
    np.testing.assert_array_equal(got.numpy()[0], ref)


@pytest.mark.parametrize("use_xla_conv", [False, True])
@pytest.mark.parametrize("name", ["blur3", "edge5"])
def test_conv_iterate_matches_jax(name, use_xla_conv):
    # The single-block plain iterates (ops/conv.py), u8 and float mode.
    jf, tf = _filters(name)
    img = _image("zero", "rgb", seed=11)
    x = imageio.interleaved_to_planar(img).astype(np.float32)
    iters = 3
    got = conv.iterate_u8(torch.from_numpy(x), tf, iters, use_xla_conv)
    want = np.asarray(jconv.iterate_u8(jnp.asarray(x), jf, iters,
                                       use_xla_conv))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        imageio.planar_to_interleaved(got.numpy().astype(np.uint8)),
        oracle.run_serial_u8(img, tf, iters))
    got = conv.iterate_f32(torch.from_numpy(x), tf, iters, use_xla_conv)
    want = np.asarray(jconv.iterate_f32(jnp.asarray(x), jf, iters,
                                        use_xla_conv))
    rtol, atol = stencil.float_tolerance(tf, iters, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def _jax_halo(x, shape, depth, boundary):
    m = _jax_mesh(shape)
    fn = shard_map(lambda b: jhalo.halo_exchange(b, depth, shape, boundary),
                   mesh=m, in_specs=P(None, "x", "y"),
                   out_specs=P(None, "x", "y"), check_vma=False)
    return np.asarray(jax.jit(fn)(x))


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("grid_shape,depth", [((2, 4), 2), ((2, 2), 4),
                                              ((1, 8), 1), ((4, 1), 3)])
def test_halo_exchange_matches_jax(grid_shape, depth, boundary):
    # Depths r*T for (r, T) in (1, 2), (2, 2), (1, 1), (1, 3); blocks of
    # 6 x 5 so every ghost slab comes from a real neighbour.
    R, C = grid_shape
    x = np.random.default_rng(depth).integers(
        0, 256, size=(2, 6 * R, 5 * C)).astype(np.float32)
    want = _jax_halo(x, grid_shape, depth, boundary)
    blocks = mesh.split_blocks(torch.from_numpy(x),
                               mesh.make_grid(grid_shape, "cpu"))
    got = mesh.join_blocks(halo.halo_exchange(blocks, depth, grid_shape,
                                              boundary))
    np.testing.assert_array_equal(got.numpy(), want)


def test_iterate_prepared_keeps_padded_blocks():
    _, tf = _filters("blur3")
    img = _image("zero", "grey", seed=9)
    g = mesh.make_grid((2, 4), "cpu")
    blocks = convert.blocks_from_numpy(img[None].astype(np.float32), g, "u8")
    out = step.iterate_prepared(blocks, tf, 3, g, img.shape, backend="cuda",
                                fuse=2)
    assert tuple(out[0][0].shape) == (1, 19, 14) and out[0][0].dtype == torch.uint8
    got = convert.to_numpy(out, img.shape)
    np.testing.assert_array_equal(got[0], oracle.run_serial_u8(img, tf, 3))


def test_step_errors(monkeypatch):
    _, tf = _filters("blur3")
    x = np.zeros((1, 24, 36), np.float32)
    g = mesh.make_grid((2, 2), "cpu")
    with pytest.raises(ValueError, match="divisible"):
        step.sharded_iterate(np.zeros((1, 25, 36), np.float32), tf, 1, grid=g,
                             boundary="periodic")
    with pytest.raises(ValueError, match="fuse=8 needs blocks"):
        step.sharded_iterate(x, tf, 8, grid=mesh.make_grid((4, 4), "cpu"),
                             fuse=8)
    with pytest.raises(ValueError, match="'pallas' is 'cuda' here"):
        step.sharded_iterate(x, tf, 1, grid=g, backend="pallas")
    with pytest.raises(ValueError, match="'pallas_rdma' is 'cuda_rdma' here"):
        step.sharded_iterate(x, tf, 1, grid=g, backend="pallas_rdma")
    # overlap=True on a backend without the overlapped pipeline runs
    # serialized with a warning (the JAX package's clamp); on cuda_rdma
    # (item 10b, ported) a grid that is not a grid of slots clamps too.
    step._OVERLAP_WARNED.discard("backend:cuda")  # once a process
    with pytest.warns(UserWarning, match="running serialized"):
        assert step.resolve_overlap(True, "cuda", g) is False
    np.testing.assert_array_equal(
        step.sharded_iterate(x, tf, 1, grid=g, overlap=True).numpy(),
        step.sharded_iterate(x, tf, 1, grid=g).numpy())
    np.testing.assert_array_equal(
        step.sharded_iterate(x, tf, 1, grid=g, backend="cuda_rdma",
                             overlap=True).numpy(),
        step.sharded_iterate(x, tf, 1, grid=g, backend="cuda_rdma").numpy())
    # interior_split is ported (item 2): the plain backend takes it.
    np.testing.assert_array_equal(
        step.sharded_iterate(x, tf, 1, grid=g, interior_split=True).numpy(),
        step.sharded_iterate(x, tf, 1, grid=g).numpy())
    # fallback is ported: the probe passes, the run is the plain one.
    np.testing.assert_array_equal(
        step.sharded_iterate(x, tf, 1, grid=g, fallback=True).numpy(),
        step.sharded_iterate(x, tf, 1, grid=g).numpy())
    # overlap is ported (item 10b): on cuda_rdma a grid that is not a
    # grid of slots clamps it, even with the CPU's byte-proof hatch set.
    monkeypatch.setenv("PCTPU_OVERLAP_INTERPRET", "1")
    step._OVERLAP_WARNED.discard("unslotted")
    with pytest.warns(UserWarning, match="not slotted"):
        assert step.resolve_overlap(True, "cuda_rdma", g) is False
    # col_mode is ported (item 10): both transports give the plain bytes.
    for cm in ("packed", "strided", "auto"):
        np.testing.assert_array_equal(
            step.sharded_iterate(x, tf, 1, grid=g, backend="cuda_rdma",
                                 col_mode=cm).numpy(),
            step.sharded_iterate(x, tf, 1, grid=g).numpy())
    with pytest.raises(ValueError, match="col_mode must be one of"):
        step.sharded_iterate(x, tf, 1, grid=g, backend="cuda_rdma",
                             col_mode="dense")
