"""The port's huge-image path (``utils/imageio.py`` block helpers,
``utils/sharded_io.py``, ``ConvolutionModel.run_raw_file_sharded``, ``run
--sharded-io``) against the JAX package, on the same seeded files, u8 byte
for byte.

The blocks ``load_sharded`` makes are the ones ``step._prepare`` cuts
(padded to block multiples, the rim zero), on any grid, in any storage;
``save_sharded`` writes the valid parts back; both move a block through
the host in row bands of at most ``sharded_io.BAND_BYTES``, which the tests
shrink below a block so that a block takes many bands.
"""

import jax
import numpy as np
import pytest
import torch

from parallel_convolution_tpu import cli as jcli
from parallel_convolution_tpu.models import ConvolutionModel as JModel
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.utils import imageio as jimageio
from parallel_convolution_tpu.utils import sharded_io as jsharded_io
from parallel_convolution_tpu_torch.cli import main as cli_main
from parallel_convolution_tpu_torch.models import ConvolutionModel
from parallel_convolution_tpu_torch.ops import oracle
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh, step
from parallel_convolution_tpu_torch.resilience import faults
from parallel_convolution_tpu_torch.utils import imageio, sharded_io

TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "u8": torch.uint8}


def _jax_mesh(shape):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _raw(tmp_path, rows, cols, mode, seed, name="in.raw"):
    img = imageio.generate_test_image(rows, cols, mode, seed=seed)
    p = tmp_path / name
    imageio.write_raw(p, img)
    return img, str(p)


@pytest.fixture
def small_bands(monkeypatch):
    """Bands of 100 bytes of file: a few rows each, many per block."""
    monkeypatch.setattr(sharded_io, "BAND_BYTES", 100)


def test_block_helpers_match_jax(tmp_path):
    img, p = _raw(tmp_path, 23, 31, "rgb", seed=5)
    for win in ((0, 23, 0, 31), (3, 17, 5, 29), (22, 23, 30, 31),
                (9, 9, 0, 31), (20, 40, 0, 4)):  # empty; past the end
        np.testing.assert_array_equal(imageio.read_block(p, 23, 31, "rgb",
                                                         *win),
                                      jimageio.read_block(p, 23, 31, "rgb",
                                                          *win))
    assert imageio.open_raw_mmap(p, 23, 31, "rgb").shape == (23, 31, 3)
    a, b = tmp_path / "a.raw", tmp_path / "b.raw"
    imageio.allocate_raw(a, 23, 31, "rgb")
    jimageio.allocate_raw(b, 23, 31, "rgb")
    patch = img[4:9, 7:20]
    imageio.write_block(a, 23, 31, "rgb", 4, 7, patch)
    jimageio.write_block(b, 23, 31, "rgb", 4, 7, patch)
    assert a.read_bytes() == b.read_bytes()
    assert a.stat().st_size == 23 * 31 * 3
    for total, parts in ((10, 3), (7, 7), (65536, 4)):
        assert ([imageio.block_bounds(total, parts, i) for i in range(parts)]
                == [jimageio.block_bounds(total, parts, i)
                    for i in range(parts)])
    with pytest.raises(IndexError):
        imageio.block_bounds(10, 3, 3)


@pytest.mark.parametrize("grid_shape", [(1, 1), (2, 2), (2, 3), (4, 1)])
@pytest.mark.parametrize("mode", ["grey", "rgb"])
@pytest.mark.parametrize("storage", ["f32", "bf16", "u8"])
def test_load_sharded_is_prepare_and_jax(tmp_path, small_bands, grid_shape,
                                         mode, storage):
    img, p = _raw(tmp_path, 37, 53, mode, seed=31)
    g = mesh.make_grid(grid_shape, "cpu")
    blocks = sharded_io.load_sharded(p, 37, 53, mode, g,
                                     dtype=TORCH[storage])
    want, valid_hw, block_hw = step._prepare(
        imageio.interleaved_to_planar(img), g, storage)
    assert valid_hw == (37, 53)
    for row, wrow in zip(blocks, want):
        for b, w in zip(row, wrow):
            assert b.dtype == w.dtype and tuple(b.shape[1:]) == block_hw
            assert torch.equal(b, w)
    jarr = np.asarray(jsharded_io.load_sharded(p, 37, 53, mode,
                                               _jax_mesh(grid_shape)))
    np.testing.assert_array_equal(
        mesh.join_blocks(blocks).to(torch.float32).numpy(), jarr)


def test_load_sharded_takes_numpy_dtypes(tmp_path):
    _, p = _raw(tmp_path, 9, 11, "grey", seed=2)
    g = mesh.make_grid((2, 2), "cpu")
    assert sharded_io.load_sharded(p, 9, 11, "grey", g)[0][0].dtype == \
        torch.float32
    assert sharded_io.load_sharded(p, 9, 11, "grey", g,
                                   dtype=np.uint8)[1][1].dtype == torch.uint8
    with pytest.raises(ValueError, match="no block dtype"):
        sharded_io.load_sharded(p, 9, 11, "grey", g, dtype=np.float16)


@pytest.mark.parametrize("grid_shape", [(1, 1), (4, 2), (2, 3)])
@pytest.mark.parametrize("mode", ["grey", "rgb"])
def test_save_sharded_round_trip(tmp_path, small_bands, grid_shape, mode):
    img, src = _raw(tmp_path, 29, 43, mode, seed=32)
    g = mesh.make_grid(grid_shape, "cpu")
    for storage in TORCH:
        dst = tmp_path / f"out_{storage}.raw"
        blocks = sharded_io.load_sharded(src, 29, 43, mode, g,
                                         dtype=TORCH[storage])
        sharded_io.save_sharded(dst, blocks, 29, 43, mode)
        np.testing.assert_array_equal(imageio.read_raw(dst, 29, 43, mode),
                                      img)
    # The stacked cuda_rdma carry, with its grid shape.
    from parallel_convolution_tpu_torch.ops import rdma

    stacked = rdma.stack_blocks(blocks, grid_shape)
    dst = tmp_path / "stacked.raw"
    sharded_io.save_sharded(dst, stacked, 29, 43, mode,
                            grid_shape=grid_shape)
    np.testing.assert_array_equal(imageio.read_raw(dst, 29, 43, mode), img)
    with pytest.raises(ValueError, match="grid_shape"):
        sharded_io.save_sharded(dst, stacked, 29, 43, mode)


def test_save_sharded_clamps_and_truncates_as_jax(tmp_path):
    x = np.array([[[-3.0, 0.4, 254.9, 255.0, 300.0, 17.6]]], np.float32)
    g = mesh.make_grid((1, 1), "cpu")
    a, b = tmp_path / "a.raw", tmp_path / "b.raw"
    sharded_io.save_sharded(a, [[torch.from_numpy(x)]], 1, 6, "grey")
    jsharded_io.save_sharded(
        str(b), jax.device_put(x), 1, 6, "grey")
    assert a.read_bytes() == b.read_bytes() == bytes([0, 0, 254, 255, 255,
                                                      17])


def test_io_read_is_consulted_once_per_block(tmp_path, small_bands):
    _, p = _raw(tmp_path, 24, 40, "grey", seed=11)
    g = mesh.make_grid((2, 2), "cpu")
    with faults.injected("io_read:1"):
        with pytest.raises(faults.InjectedFault, match="'io_read'"):
            sharded_io.load_sharded(p, 24, 40, "grey", g)
    with faults.injected("io_read:99") as plan:
        sharded_io.load_sharded(p, 24, 40, "grey", g)
    assert plan.hits("io_read") == 4
    # A block wholly in the pad rim reads nothing: 3 rows on a 4x1 grid
    # are one row a block, the fourth block all rim.
    _, p = _raw(tmp_path, 3, 5, "grey", seed=12, name="tiny.raw")
    with faults.injected("io_read:99") as plan:
        blocks = sharded_io.load_sharded(p, 3, 5, "grey",
                                         mesh.make_grid((4, 1), "cpu"))
    assert plan.hits("io_read") == 3
    assert not blocks[3][0].any()


# (grid, mode, storage, backend, fuse, rows, cols)
RUN_CASES = [
    ((1, 1), "rgb", "u8", "cuda_sep", 3, 45, 61),
    ((2, 2), "grey", "bf16", "cuda", 2, 37, 53),
    ((2, 3), "rgb", "f32", "shifted", 1, 31, 47),
    ((2, 3), "grey", "u8", "cuda_rdma", 4, 45, 61),
    ((2, 2), "rgb", "bf16", "cuda_rdma", 2, 29, 43),
    ((1, 1), "grey", "f32", "cuda", 1, 23, 31),
]
JAX_NAME = {"cuda": "pallas", "cuda_sep": "pallas_sep",
            "cuda_rdma": "pallas_rdma", "shifted": "shifted"}


@pytest.mark.parametrize("grid_shape,mode,storage,backend,fuse,rows,cols",
                         RUN_CASES)
def test_run_raw_file_sharded_matches_jax(tmp_path, small_bands, grid_shape,
                                          mode, storage, backend, fuse, rows,
                                          cols):
    img, src = _raw(tmp_path, rows, cols, mode, seed=33)
    dst, jdst = tmp_path / "out.raw", tmp_path / "jout.raw"
    model = ConvolutionModel("blur3", grid=mesh.make_grid(grid_shape, "cpu"),
                             backend=backend, storage=storage, fuse=fuse)
    model.run_raw_file_sharded(src, str(dst), rows, cols, mode, 5)
    jmodel = JModel(filt="blur3", mesh=_jax_mesh(grid_shape),
                    backend=JAX_NAME[backend], storage=storage, fuse=fuse)
    jmodel.run_raw_file_sharded(src, str(jdst), rows, cols, mode, 5)
    assert dst.read_bytes() == jdst.read_bytes()
    np.testing.assert_array_equal(
        imageio.read_raw(dst, rows, cols, mode),
        oracle.run_serial_u8(img, get_filter("blur3"), 5))
    assert model.effective_backend == backend


def test_run_raw_file_sharded_never_forms_the_global_image(tmp_path,
                                                           monkeypatch):
    """Neither the whole-image readers nor the global f32 field run."""
    _, src = _raw(tmp_path, 33, 41, "rgb", seed=8)

    def refuse(*a, **k):
        raise AssertionError("the global image was formed")

    monkeypatch.setattr(imageio, "read_raw", refuse)
    monkeypatch.setattr(step, "_global_f32", refuse)
    monkeypatch.setattr(step, "_prepare", refuse)
    model = ConvolutionModel("blur3", grid=mesh.make_grid((2, 2), "cpu"),
                             backend="cuda_rdma", storage="u8", fuse=2)
    model.run_raw_file_sharded(src, str(tmp_path / "o.raw"), 33, 41, "rgb",
                               3)


@pytest.mark.parametrize("extra", [
    ["--mesh", "2x3", "--backend", "pallas_sep", "--storage", "u8",
     "--fuse", "3"],
    ["--mesh", "2x2", "--backend", "pallas_rdma", "--storage", "bf16",
     "--fuse", "2"],
])
def test_cli_sharded_io_matches_jax_cli(tmp_path, capsys, extra):
    _, src = _raw(tmp_path, 39, 57, "rgb", seed=6)
    out, jout = tmp_path / "out.raw", tmp_path / "jout.raw"
    head = ["run", src, "39", "57", "6", "rgb", "--sharded-io"]
    assert jcli.main(head + ["-o", str(jout)] + extra) == 0
    port_extra = [{"pallas_sep": "cuda_sep",
                   "pallas_rdma": "cuda_rdma"}.get(a, a) for a in extra]
    assert cli_main(head + ["-o", str(out), "--device", "cpu"]
                    + port_extra) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("ran 6 x blur3 on ")
    assert out.read_bytes() == jout.read_bytes()


# ------------------------------------------------- on a grid of slots (10c)


def _slots(shape):
    return mesh.make_grid(shape, devices=["cpu"] * (shape[0] * shape[1]))


@pytest.mark.parametrize("grid_shape", [(2, 2), (2, 3)])
@pytest.mark.parametrize("storage", ["f32", "u8"])
def test_load_save_on_slots_round_trip(tmp_path, small_bands, grid_shape,
                                       storage):
    img, src = _raw(tmp_path, 23, 37, "rgb", seed=41)
    slots = _slots(grid_shape)
    blocks = sharded_io.load_sharded(src, 23, 37, "rgb", slots,
                                     dtype=TORCH[storage])
    one = sharded_io.load_sharded(src, 23, 37, "rgb",
                                  mesh.make_grid(grid_shape, "cpu"),
                                  dtype=TORCH[storage])
    ptrs = {b.data_ptr() for row in blocks for b in row}
    assert len(ptrs) == grid_shape[0] * grid_shape[1]  # a block a slot
    for row, orow in zip(blocks, one):
        for b, o in zip(row, orow):
            assert torch.equal(b, o)
    dst = tmp_path / "round.raw"
    sharded_io.save_sharded(dst, blocks, 23, 37, "rgb")
    assert dst.read_bytes() == open(src, "rb").read()


@pytest.mark.parametrize("backend,storage,fuse", [
    ("cuda_rdma", "u8", 3), ("cuda_sep", "bf16", 2), ("cuda", "f32", 1)])
def test_run_raw_file_sharded_on_slots_is_jax_bytes(tmp_path, small_bands,
                                                    backend, storage, fuse):
    img, src = _raw(tmp_path, 29, 35, "grey", seed=43)
    dst, jdst = tmp_path / "out.raw", tmp_path / "jout.raw"
    model = ConvolutionModel("blur3", grid=_slots((2, 2)), backend=backend,
                             storage=storage, fuse=fuse)
    model.run_raw_file_sharded(src, str(dst), 29, 35, "grey", 5)
    JModel(filt="blur3", mesh=_jax_mesh((2, 2)), backend=JAX_NAME[backend],
           storage=storage, fuse=fuse).run_raw_file_sharded(
        src, str(jdst), 29, 35, "grey", 5)
    assert dst.read_bytes() == jdst.read_bytes()
    np.testing.assert_array_equal(
        imageio.read_raw(dst, 29, 35, "grey"),
        oracle.run_serial_u8(img, get_filter("blur3"), 5))
