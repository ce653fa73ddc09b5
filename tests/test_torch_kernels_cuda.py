"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one: a CUDA kernel has no CPU mode.  The file imports neither JAX nor the
JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest.py sets up JAX).  Quantize mode must
be byte-equal; float mode agrees within ``stencil.float_tolerance`` (the
kernels round once per tap as an FMA, the plain versions twice).
"""

import pytest
import torch

from parallel_convolution_tpu_torch.models import ConvolutionModel
from parallel_convolution_tpu_torch.ops import oracle, stencil
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.utils import imageio

FILTERS = ["blur3", "gaussian5", "edge5", "sharpen3"]
MODES = [("f32", True), ("bf16", True), ("u8", True), ("f32", False),
         ("bf16", False)]
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "u8": torch.uint8}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _data(seed, shape, storage, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, shape, generator=g).to(torch.float32)
    return x.to(device=device, dtype=TORCH[storage])


def _assert_agree(got, want, filt, levels, quantize):
    assert got.shape == want.shape and got.dtype == want.dtype
    if quantize:
        assert torch.equal(got, want)
    else:
        rtol, atol = stencil.float_tolerance(filt, levels, got.dtype)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("storage,quantize", MODES)
@pytest.mark.parametrize("name", FILTERS)
def test_step_kernel_matches_plain(cuda_device, name, storage, quantize,
                                   separable):
    f = get_filter(name)
    r = f.radius
    x = _data(40, (3, 67 + 2 * r, 301 + 2 * r), storage, cuda_device)
    kw = dict(quantize=quantize, out_dtype=TORCH[storage], separable=separable)
    before = stencil.stencil_step.launches
    got = stencil.stencil_step(x, f, tile=(16, 64), **kw)
    torch.cuda.synchronize()
    assert stencil.stencil_step.launches == before + 1
    _assert_agree(got, stencil.stencil_step_plain(x, f, **kw), f, 1, quantize)


# Float mode of a non-convex filter grows by L1(taps) per level, so it is
# held only over T <= 2 levels.
FUSED_CASES = [
    (name, storage, quantize, T, boundary)
    for name in FILTERS for storage, quantize in MODES
    for T, boundary in [(1, "zero"), (2, "periodic"), (8, "zero"),
                        (32, "zero")]
    if quantize or T <= 2 or name in ("blur3", "gaussian5")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,storage,quantize,T,boundary", FUSED_CASES)
def test_fused_kernel_matches_plain(cuda_device, name, storage, quantize, T,
                                    boundary):
    f = get_filter(name)
    d = f.radius * T
    x = _data(50 + T, (2, 77 + 2 * d, 139 + 2 * d), storage, cuda_device)
    valid = None if boundary == "periodic" else (90, 150)
    kw = dict(quantize=quantize, out_dtype=TORCH[storage], separable=True)
    got = stencil.fused_iterate(x, (3, 5), f, T, valid, **kw)
    torch.cuda.synchronize()
    want = stencil.fused_iterate_plain(x, (3, 5), f, T, valid, **kw)
    _assert_agree(got, want, f, T, quantize)


@pytest.mark.cuda
def test_fused_level_groups_match_one_launch(cuda_device):
    # A tile too large for 8 levels in one launch splits them into groups
    # through float32 device memory: the same bytes as the plain version.
    f = get_filter("gaussian5")
    x = _data(7, (1, 200 + 32, 180 + 32), "bf16", cuda_device)
    th, tw, groups = stencil.fused_plan(2, 8, (200, 180), tile=(160, 160))
    assert len(groups) > 1
    before = stencil.fused_iterate.launches
    got = stencil.fused_iterate(x, (0, 0), f, 8, (200, 180), tile=(160, 160))
    assert stencil.fused_iterate.launches == before + len(groups)
    want = stencil.fused_iterate_plain(x, (0, 0), f, 8, (200, 180))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,storage,fuse", [("cuda", "u8", 1),
                                                  ("cuda_sep", "bf16", 4),
                                                  ("cuda", "f32", 3)])
def test_model_on_card_matches_oracle(cuda_device, backend, storage, fuse):
    img = imageio.generate_test_image(97, 131, "rgb", seed=3)
    model = ConvolutionModel("blur3", backend=backend, storage=storage,
                             fuse=fuse, device=cuda_device)
    stencil.reset_launch_counts()
    got = model.run_image(img, 9)
    counts = stencil.launch_counts()
    assert counts["fused_iterate" if fuse > 1 else "stencil_step"] > 0
    assert (got == oracle.run_serial_u8(img, get_filter("blur3"), 9)).all()


@pytest.mark.cuda
def test_cuda_wrapper_rejects_non_contiguous(cuda_device):
    x = torch.zeros((1, 20, 20), device=cuda_device)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        stencil.stencil_step(x, get_filter("blur3"))
