"""The plain reference agrees with the port's plain path (``shifted``)
at small sizes on the CPU.  The test imports both; the reference imports
nothing of the port."""

import numpy as np
import pytest
import torch

from cardbench import inputs, reference
from parallel_convolution_tpu_torch.models import ConvolutionModel
from parallel_convolution_tpu_torch.ops import oracle
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.solvers import multigrid as mg

BLUR3 = {"taps": [[1, 2, 1], [2, 4, 2], [1, 2, 1]], "divisor": 16}
JACOBI3 = {"taps": [[0, 1, 0], [1, 0, 1], [0, 1, 0]], "divisor": 4}


@pytest.mark.parametrize("shape,iters", [((40, 52), 7), ((17, 9), 12)])
def test_u8_images_match_the_ports_plain_path(shape, iters):
    img = inputs.image(123456789012, 0, 3, shape, "cpu")
    inside = torch.ones((1, 1, *shape), dtype=torch.bool)
    got = reference.iterate_u8(img[None], inside, reference.taps(BLUR3),
                               iters, 0)[0].permute(1, 2, 0).numpy()
    host = img.permute(1, 2, 0).contiguous().numpy()
    assert np.array_equal(got, oracle.run_serial_u8(host, get_filter("blur3"),
                                                    iters))
    model = ConvolutionModel("blur3", backend="shifted", storage="u8",
                             fuse=4, device="cpu")
    assert np.array_equal(got, model.run_image(host, iters))


@pytest.mark.parametrize("y0,x0", [(0, 0), (30, 40), (12, 20), (31, 0)])
def test_a_window_with_its_apron_is_the_images(y0, x0):
    H, W, s, iters = 40, 52, 9, 7
    img = inputs.image(5, 0, 3, (H, W), "cpu").permute(1, 2, 0).numpy()
    want = oracle.run_serial_u8(img, get_filter("blur3"), iters)
    a = iters
    win = inputs.image_window(5, 0, 3, (H, W), y0 - a, x0 - a, s + 2 * a,
                              s + 2 * a, "cpu")
    rows, cols = torch.arange(y0 - a, y0 + s + a), torch.arange(
        x0 - a, x0 + s + a)
    inside = (((rows >= 0) & (rows < H))[:, None]
              & ((cols >= 0) & (cols < W))[None, :])[None, None]
    got = reference.iterate_u8(win[None], inside, reference.taps(BLUR3),
                               iters, a)[0].permute(1, 2, 0).numpy()
    h, w = min(s, H - y0), min(s, W - x0)
    assert np.array_equal(got[:h, :w], want[y0:y0 + h, x0:x0 + w])


def test_bfloat16_changes_the_bytes():
    img = inputs.image(9, 0, 3, (40, 52), "cpu")
    inside = torch.ones((1, 1, 40, 52), dtype=torch.bool)
    t = reference.taps(BLUR3)
    f32 = reference.iterate_u8(img[None], inside, t, 10, 0)
    bf16 = reference.iterate_u8(img[None], inside, t, 10, 0,
                                dtype=torch.bfloat16)
    assert int((f32 != bf16).sum()) > 100


@pytest.mark.parametrize("shape", [(64, 80), (70, 94), (33, 47), (128, 128),
                                   (9, 12)])
def test_the_vcycle_matches_the_ports_plain_solver(shape):
    x = inputs.normal_field(77, 0, 1, shape, "cpu")
    out, res = mg.mg_converge(x, get_filter("jacobi3"), 1e-3, 200,
                              backend="shifted", device="cpu")
    ref = reference.vcycle_solve(x, reference.taps(JACOBI3), 1e-3, 200)
    assert len(reference.plan_levels(shape, 1)) == res.levels
    assert (ref.cycles, ref.converged) == (res.cycles, res.converged)
    assert torch.allclose(out, ref.field, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.residuals, ref.residuals, rtol=1e-4)


def test_the_vcycle_stops_at_its_budget():
    x = inputs.normal_field(3, 0, 1, (64, 64), "cpu")
    ref = reference.vcycle_solve(x, reference.taps(JACOBI3), 1e-12, 20)
    out, res = mg.mg_converge(x, get_filter("jacobi3"), 1e-12, 20,
                              backend="shifted", device="cpu")
    assert not ref.converged and ref.cycles == res.cycles
