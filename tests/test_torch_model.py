"""The port's model, CLI and parameter crossing against the JAX package.

``ConvolutionModel.run_image`` and the ``run`` CLI must give the bytes the
JAX model and ``pconv-tpu serial`` give on the same seeded images.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from parallel_convolution_tpu.cli import main as jax_cli
from parallel_convolution_tpu.models import ConvolutionModel as JaxModel
from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu_torch import convert
from parallel_convolution_tpu_torch.models import ConvolutionModel
from parallel_convolution_tpu_torch.ops import oracle
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh, step
from parallel_convolution_tpu_torch.utils import imageio, platform

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("mode,backend,jbackend,storage,fuse,grid_shape", [
    ("grey", "cuda_sep", "pallas_sep", "bf16", 3, (1, 1)),
    ("rgb", "cuda_sep", "pallas_sep", "bf16", 2, (2, 2)),
    ("rgb", "cuda", "pallas", "f32", 1, (1, 1)),
    ("grey", "shifted", "shifted", "u8", 2, (2, 4)),
])
def test_run_image_matches_jax_model(mode, backend, jbackend, storage, fuse,
                                     grid_shape):
    img = imageio.generate_test_image(30, 41, mode, seed=5)
    jm = JaxModel(filt="blur3", backend=jbackend, storage=storage, fuse=fuse,
                  mesh=jmesh.make_grid_mesh(
                      jax.devices()[:grid_shape[0] * grid_shape[1]],
                      grid_shape))
    model = ConvolutionModel(filt="blur3", backend=backend, storage=storage,
                             fuse=fuse, grid=mesh.make_grid(grid_shape, "cpu"))
    got = model.run_image(img, 7)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, jm.run_image(img, 7))
    np.testing.assert_array_equal(
        got, oracle.run_serial_u8(img, model.filt, 7))


def test_model_holds_taps_as_buffer_and_batches():
    model = ConvolutionModel("gaussian5", device="cpu", backend="cuda", fuse=2)
    assert "taps" in dict(model.named_buffers())
    np.testing.assert_array_equal(model.taps.numpy(),
                                  jfilters.get_filter("gaussian5").taps)
    imgs = [imageio.generate_test_image(20, 26, m, seed=i)
            for i, m in enumerate(["grey", "rgb", "grey"])]
    outs = model.run_images(imgs, 3)
    for im, out in zip(imgs, outs):
        np.testing.assert_array_equal(out, model.run_image(im, 3))
    x = torch.from_numpy(imageio.interleaved_to_planar(imgs[1])).float()
    np.testing.assert_array_equal(model(x, 3).numpy(),
                                  model.run_planar(x, 3).numpy())


def test_cli_run_matches_jax_serial(tmp_path):
    src, ref, out = (tmp_path / n for n in ("in.raw", "ref.raw", "out.raw"))
    imageio.write_raw(src, imageio.generate_test_image(33, 47, "rgb", seed=8))
    assert jax_cli(["serial", str(src), "33", "47", "6", "rgb", "-o",
                    str(ref), "--filter", "gaussian5", "--impl",
                    "oracle"]) == 0
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "parallel_convolution_tpu_torch", "run",
         str(src), "33", "47", "6", "rgb", "-o", str(out), "--filter",
         "gaussian5", "--backend", "cuda_sep", "--storage", "bf16", "--fuse",
         "4", "--mesh", "2x2", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "2x2 grid (cuda_sep, bf16, fuse 4, cpu)" in res.stdout
    assert out.read_bytes() == ref.read_bytes()


def test_cli_serial_generate_compare(tmp_path, capsys):
    from parallel_convolution_tpu_torch.cli import main

    src, a, b = (str(tmp_path / n) for n in ("i.raw", "a.raw", "b.raw"))
    assert main(["generate", src, "20", "30", "grey", "--seed", "3"]) == 0
    np.testing.assert_array_equal(
        imageio.read_raw(src, 20, 30, "grey"),
        imageio.generate_test_image(20, 30, "grey", seed=3))
    assert main(["serial", src, "20", "30", "2", "grey", "-o", a]) == 0
    assert main(["run", src, "20", "30", "2", "grey", "-o", b, "--device",
                 "cpu", "--fast"]) == 0
    assert main(["compare", a, b]) == 0
    imageio.write_raw(b, np.zeros((20, 30), np.uint8))
    assert main(["compare", a, b]) == 1
    assert "differ" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["blur3", "gaussian5", "edge5", "box3"])
def test_convert_filter_round_trip(name):
    jf = jfilters.get_filter(name)
    tf = convert.filter_from_numpy(jf.name, jf.taps, jf.dyadic)
    assert (tf.name, tf.dyadic, tf.convex) == (jf.name, jf.dyadic, jf.convex)
    np.testing.assert_array_equal(tf.taps, jf.taps)
    jsep, tsep = jf.separable(), tf.separable()
    assert (jsep is None) == (tsep is None)
    if jsep is not None:
        for a, b in zip(jsep, tsep):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("storage,dtype", [("f32", np.float32),
                                           ("bf16", np.float32),
                                           ("u8", np.uint8)])
@pytest.mark.parametrize("grid_shape", [(1, 1), (2, 4), (4, 1)])
def test_convert_state_round_trip(grid_shape, storage, dtype):
    x = np.random.default_rng(1).integers(0, 256, size=(3, 13, 22))
    x = x.astype(np.float32)
    g = mesh.make_grid(grid_shape, "cpu")
    blocks = convert.blocks_from_numpy(x, g, storage)
    assert len(blocks) == grid_shape[0] and len(blocks[0]) == grid_shape[1]
    back = convert.to_numpy(blocks, (13, 22))
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, x.astype(dtype))
    # The pad-to-multiple rim is zero.
    full = convert.to_numpy(blocks)
    assert full[:, 13:, :].sum() == 0 and full[:, :, 22:].sum() == 0


def test_torch_round_is_half_to_even():
    x = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 254.5, 255.5])
    want = np.rint(x.numpy())
    np.testing.assert_array_equal(torch.round(x).numpy(), want)
    np.testing.assert_array_equal(
        want, [-2.0, -2.0, -0.0, 0.0, 2.0, 2.0, 4.0, 254.0, 256.0])


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: platform.resolve_device(None),
                 lambda: platform.resolve_device("cuda"),
                 lambda: mesh.make_grid(),
                 lambda: ConvolutionModel("blur3"),
                 lambda: step.sharded_iterate(np.zeros((1, 8, 8), np.float32),
                                              get_filter("blur3"), 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert platform.resolve_device("cpu") == torch.device("cpu")


def test_quantize_contract_and_storage_errors():
    f = convert.filter_from_numpy("blur3", jfilters.BLUR3.taps, True)
    g = mesh.make_grid(device="cpu")
    bad = np.full((1, 8, 8), 300.0, np.float32)
    with pytest.raises(ValueError, match="outside the u8 contract"):
        step.sharded_iterate(bad, f, 1, grid=g)
    # Non-convex filters keep the clip, so they take any input; float mode
    # has no contract.
    sharp = convert.filter_from_numpy("sharpen3", jfilters.SHARPEN3.taps, True)
    step.sharded_iterate(bad, sharp, 1, grid=g)
    step.sharded_iterate(bad, f, 1, grid=g, quantize=False)
    with pytest.raises(ValueError, match="storage='u8' requires quantize"):
        step.sharded_iterate(bad, f, 1, grid=g, storage="u8", quantize=False)
    with pytest.raises(ValueError, match="storage='u8' requires quantize"):
        ConvolutionModel(f, device="cpu", storage="u8", quantize=False)
    # interior_split is ported (item 2): the model takes it.
    assert ConvolutionModel(f, device="cpu", interior_split=True).interior_split
    # overlap is ported (item 10b): the model takes it; on one CPU device
    # every run clamps it to the serialized order.
    model = ConvolutionModel(f, device="cpu", overlap=True)
    assert model.overlap is True
    model.run_planar(np.zeros((1, 8, 8), np.float32), 1)
    assert model.effective_overlap is False
