"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one: a CUDA kernel has no CPU mode.  The file imports neither JAX nor the
JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest.py sets up JAX).  Quantize mode must
be byte-equal; float mode agrees within ``stencil.float_tolerance`` (the
kernels round once per tap as an FMA, the plain versions twice).
"""

import numpy as np
import pytest
import torch

from parallel_convolution_tpu_torch import probes, tuning
from parallel_convolution_tpu_torch.models import ConvolutionModel
from parallel_convolution_tpu_torch.ops import oracle, rdma, stencil
from parallel_convolution_tpu_torch.ops.filters import (
    gaussian, get_filter, make_filter,
)
from parallel_convolution_tpu_torch.parallel import halo, mesh
from parallel_convolution_tpu_torch.probes import (
    op_price, rdma_ladder, smem_budget,
)
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


# K1's typed instances: k = 1, 3, 5, 7, 9, every input dtype against every
# output dtype, quantize on and off, both orders.
K1_FILTERS = ["identity1", "blur3", "edge5", "gaussian5", "binomial7",
              "binomial9"]
K1_PAIRS = [(src, dst, q) for src in TORCH for dst in TORCH
            for q in (True, False) if q or dst != "u8"]


def _k1_filter(name):
    return {"binomial7": BINOMIAL7, "binomial9": BINOMIAL9,
            "identity1": IDENTITY1}.get(name) or get_filter(name)


@pytest.mark.cuda
@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("src,dst,quantize", K1_PAIRS)
@pytest.mark.parametrize("name", K1_FILTERS)
def test_step_kernel_dtype_pairs(cuda_device, name, src, dst, quantize,
                                 separable):
    f = _k1_filter(name)
    k = f.size
    x = _data(41, (2, 41 + k - 1, 75 + k - 1), src, cuda_device)
    kw = dict(quantize=quantize, out_dtype=TORCH[dst], separable=separable)
    before = stencil.stencil_step.launches
    got = stencil.stencil_step(x, f, **kw)
    torch.cuda.synchronize()
    assert stencil.stencil_step.launches == before + 1
    _assert_agree(got, stencil.stencil_step_plain(x, f, **kw), f, 1, quantize)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(1, 1), (3, 7), (13, 40), (37, 33),
                                  (32, 128), (64, 256), (96, 192)])
@pytest.mark.parametrize("storage", ["f32", "u8"])
@pytest.mark.parametrize("name", ["blur3", "edge5"])
def test_step_kernel_tiles(cuda_device, name, storage, tile):
    # Every tile gives the same bytes: ragged last tiles, tiles below the
    # strip height and the warp width, and tiles that fit one stage only.
    f = get_filter(name)
    x = _data(42, (3, 67 + f.size - 1, 301 + f.size - 1), storage,
              cuda_device)
    kw = dict(quantize=True, out_dtype=TORCH[storage])
    got = stencil.stencil_step(x, f, tile=tile, **kw)
    assert torch.equal(got, stencil.stencil_step_plain(x, f, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("storage", list(TORCH))
def test_step_kernel_rows_at_every_residue(cuda_device, storage, separable):
    # A view whose data_ptr() sits at every residue mod 16 its dtype allows,
    # with an odd row length: the rows start at every residue, the first
    # row's 16-byte floor falls before the tensor and its last row's ceiling
    # past its end (the chunks there are copied byte by byte).
    f = get_filter("blur3")
    shape = (2, 37 + 2, 53 + 2)
    n = shape[0] * shape[1] * shape[2]
    size = torch.empty((), dtype=TORCH[storage]).element_size()
    kw = dict(quantize=True, out_dtype=TORCH[storage], separable=separable)
    for off in range(16 // size):
        flat = _data(43 + off, (off + n,), storage, cuda_device)
        x = flat[off:].view(shape)
        assert x.data_ptr() % 16 == off * size and x.is_contiguous()
        got = stencil.stencil_step(x, f, **kw)
        assert torch.equal(got, stencil.stencil_step_plain(x, f, **kw)), off


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (3, 5)])
@pytest.mark.parametrize("storage", list(TORCH))
@pytest.mark.parametrize("name", ["blur3", "edge5"])
def test_step_kernel_tiny_blocks(cuda_device, name, storage, hw):
    # Rows of 3 to 9 input elements: a u8 row shorter than 4 bytes still
    # arrives through one 16-byte chunk (or bytes, at the tensor's ends).
    f = get_filter(name)
    x = _data(44, (3, hw[0] + f.size - 1, hw[1] + f.size - 1), storage,
              cuda_device)
    kw = dict(quantize=True, out_dtype=TORCH[storage])
    got = stencil.stencil_step(x, f, **kw)
    assert torch.equal(got, stencil.stencil_step_plain(x, f, **kw))


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
    # A tile too large for 16 levels in one launch (one f32 window of
    # 264 x 244 is 258 KB) splits them into groups through float32 device
    # memory: the same bytes as the plain version.
    f = get_filter("gaussian5")
    x = _data(7, (1, 200 + 64, 180 + 64), "bf16", cuda_device)
    th, tw, groups = stencil.fused_plan(2, 16, (200, 180), tile=(200, 200))
    assert len(groups) > 1
    before = stencil.fused_iterate.launches
    got = stencil.fused_iterate(x, (0, 0), f, 16, (200, 180), tile=(200, 200))
    assert stencil.fused_iterate.launches == before + len(groups)
    want = stencil.fused_iterate_plain(x, (0, 0), f, 16, (200, 180))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The level loop of K2 / K3 / K4 (csrc/stencil_common.cuh:run_levels)
# ---------------------------------------------------------------------------

BINOMIAL9 = make_filter("binomial9",
                        np.outer(*[[1, 8, 28, 56, 70, 56, 28, 8, 1]] * 2),
                        divisor=65536)
# Above the magic round's L1 bound (255 * 8308 >= 2^21): the rintf instance.
# Integer taps, so every product and partial sum stays exact in float32.
BIG3 = make_filter("big3", [[0, -1, 0], [-1, 8304, -1], [0, -1, 0]])
IDENTITY1 = make_filter("identity1", [[1.0]])


def _strip_height() -> int:
    from parallel_convolution_tpu_torch.ops import _build

    return _build.load_library("stencil").pc_strip_height()


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(13, 40), (37, 33), (8, 96)])
@pytest.mark.parametrize("name,T", [("blur3", 5), ("edge5", 3),
                                    ("binomial7", 2)])
def test_level_windows_off_the_strip_height(cuda_device, tile, name, T):
    # Tiles whose level windows (th + 2r(T-s) rows) are not multiples of the
    # strip height: the last strip of a window is partial and must read no
    # row past the live window.
    f = BINOMIAL7 if name == "binomial7" else get_filter(name)
    r, v = f.radius, _strip_height() if f.size <= 5 else 8
    assert any((tile[0] + 2 * r * (T - s)) % v for s in range(1, T + 1))
    x = _data(80, (2, 61 + 2 * r * T, 97 + 2 * r * T), "bf16", cuda_device)
    for sep in (False, True):
        kw = dict(quantize=True, out_dtype=torch.bfloat16, separable=sep)
        got = stencil.fused_iterate(x, (2, 3), f, T, (70, 105), tile=tile,
                                    **kw)
        want = stencil.fused_iterate_plain(x, (2, 3), f, T, (70, 105), **kw)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("storage,quantize", MODES)
@pytest.mark.parametrize("name", ["blur3", "edge5"])
def test_interior_and_edge_tiles(cuda_device, name, storage, quantize):
    # A 200 x 260 block inside a larger image has interior tiles (window
    # wholly inside: no masks) and tiles on its edges; a tile-sized image
    # has only edge tiles.  Both equal the plain version, which masks every
    # level everywhere.
    f = get_filter(name)
    T = 4 if quantize or f.convex else 2
    d = f.radius * T
    kw = dict(quantize=quantize, out_dtype=TORCH[storage], separable=True)
    for offsets, hw, valid in (((0, 0), (200, 260), (200, 260)),
                               ((100, 40), (200, 260), (250, 400)),
                               ((0, 0), (32, 32), (32, 32))):
        x = _data(81, (2, hw[0] + 2 * d, hw[1] + 2 * d), storage,
                  cuda_device)
        got = stencil.fused_iterate(x, offsets, f, T, valid, tile=(32, 32),
                                    **kw)
        want = stencil.fused_iterate_plain(x, offsets, f, T, valid, **kw)
        _assert_agree(got, want, f, T, quantize)
    blocks = _grid_blocks(82, (2, 2), (100, 130), storage, cuda_device)
    x = rdma.stack_blocks(blocks, (2, 2))
    for valid in ((200, 260), (150, 255)):
        want = mesh.join_blocks(rdma.fused_rdma_step_plain(
            blocks, f, (2, 2), "zero", fuse=T, valid_hw=valid,
            quantize=quantize, out_dtype=TORCH[storage]))
        got = mesh.join_blocks(rdma.unstack_blocks(rdma.rdma_tiled(
            x, f, (2, 2), "zero", T, valid, quantize=quantize,
            out_dtype=TORCH[storage], tile=(32, 32)), (2, 2)))
        _assert_agree(got, want, f, T, quantize)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "u8"])
def test_rint_instance_above_the_l1_bound(cuda_device, storage):
    f = BIG3
    assert stencil.round_mode(f.taps) == "rint" and not f.convex
    assert stencil.epilogue_code(f, True) == 4
    x = _data(83, (1, 45 + 8, 70 + 8), storage, cuda_device)
    kw = dict(quantize=True, out_dtype=TORCH[storage])
    got = stencil.fused_iterate(x, (0, 0), f, 4, (45, 70), tile=(16, 32),
                                **kw)
    assert torch.equal(got, stencil.fused_iterate_plain(x, (0, 0), f, 4,
                                                        (45, 70), **kw))
    blocks = _grid_blocks(84, (2, 2), (23, 37), storage, cuda_device)
    want = mesh.join_blocks(rdma.fused_rdma_step_plain(
        blocks, f, (2, 2), "zero", fuse=3, valid_hw=(44, 70), **kw))
    for launch, extra in ((rdma.rdma_block, {}),
                          (rdma.rdma_tiled, {"tile": (8, 16)})):
        got = mesh.join_blocks(rdma.unstack_blocks(launch(
            rdma.stack_blocks(blocks, (2, 2)), f, (2, 2), "zero", 3,
            (44, 70), **kw, **extra), (2, 2)))
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("storage,quantize", [("u8", True), ("f32", True),
                                              ("f32", False)])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("name", ["binomial7", "binomial9", "identity1"])
def test_wide_filters_both_orders(cuda_device, name, boundary, storage,
                                  quantize):
    # k = 7 and 9 (and k = 1): the strip's register rows and the separable
    # row pass at their widest, sep on and off, both boundaries.
    f = {"binomial7": BINOMIAL7, "binomial9": BINOMIAL9,
         "identity1": IDENTITY1}[name]
    assert f.separable() is not None
    T = 3
    d = f.radius * T
    x = _data(85, (2, 41 + 2 * d, 75 + 2 * d), storage, cuda_device)
    valid = None if boundary == "periodic" else (50, 80)
    for sep in (False, True):
        kw = dict(quantize=quantize, out_dtype=TORCH[storage], separable=sep)
        got = stencil.fused_iterate(x, (4, 1), f, T, valid, tile=(24, 40),
                                    **kw)
        want = stencil.fused_iterate_plain(x, (4, 1), f, T, valid, **kw)
        _assert_agree(got, want, f, T, quantize)
    if f.radius:
        blocks = _grid_blocks(86, (2, 2), (31, 43), storage, cuda_device)
        valid = None if boundary == "periodic" else (60, 80)
        kw = dict(quantize=quantize, out_dtype=TORCH[storage])
        want = mesh.join_blocks(rdma.fused_rdma_step_plain(
            blocks, f, (2, 2), boundary, fuse=T, valid_hw=valid, **kw))
        got = mesh.join_blocks(rdma.unstack_blocks(rdma.rdma_tiled(
            rdma.stack_blocks(blocks, (2, 2)), f, (2, 2), boundary, T, valid,
            tile=(16, 24), **kw), (2, 2)))
        _assert_agree(got, want, f, T, quantize)


@pytest.mark.cuda
def test_occupancy_query_launches_nothing(cuda_device):
    f = get_filter("blur3")
    x = _data(87, (1, 64 + 64, 64 + 64), "bf16", cuda_device)
    before = stencil.fused_iterate.launches
    n = stencil.fused_blocks_per_sm(x, f, 32, (64, 64), separable=True)
    assert n >= 1 and stencil.fused_iterate.launches == before
    blocks = _grid_blocks(88, (2, 2), (96, 96), "bf16", cuda_device)
    fire, _ = rdma._bind(True, rdma.stack_blocks(blocks, (2, 2)), f, (2, 2),
                         "zero", 16, (192, 192), True, None, 0, (64, 64))
    assert fire(occupancy=True) >= 1


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


# K3 / K4: every grid form of the CPU tests, on the card.  Blocks of 23 x 37
# give every (grid block, channel) to K3 whole and ragged 8 x 16 tiles to K4.
GRIDS = [((1, 1), "zero"), ((2, 2), "zero"), ((1, 4), "periodic"),
         ((4, 1), "zero"), ((2, 2), "periodic")]
RDMA_MODES = [("f32", True), ("bf16", True), ("u8", True), ("f32", False)]
BINOMIAL7 = make_filter("binomial7", np.outer(*[[1, 6, 15, 20, 15, 6, 1]] * 2),
                        divisor=4096)


def _grid_blocks(seed, grid_shape, bhw, storage, device, channels=2):
    R, Cg = grid_shape
    x = _data(seed, (channels, R * bhw[0], Cg * bhw[1]), storage, device)
    return mesh.split_blocks(x, mesh.Grid(R, Cg, device))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rdma_block", "rdma_tiled"])
@pytest.mark.parametrize("storage,quantize", RDMA_MODES)
@pytest.mark.parametrize("name", ["blur3", "edge5", "binomial7"])
@pytest.mark.parametrize("grid_shape,boundary", GRIDS)
def test_rdma_kernel_matches_plain(cuda_device, grid_shape, boundary, name,
                                   storage, quantize, kernel):
    # binomial7 takes the kernels' generic tap loop (k not 3 or 5); its
    # taps are dyadic, so quantize mode stays byte-exact under FMA.
    f = BINOMIAL7 if name == "binomial7" else get_filter(name)
    bhw = (23, 37)
    blocks = _grid_blocks(60, grid_shape, bhw, storage, cuda_device)
    # Zero boundary: an image a little smaller than the padded grid, so the
    # pad-to-multiple rim is masked too.
    valid = (None if boundary == "periodic" else
             (grid_shape[0] * bhw[0] - 2, grid_shape[1] * bhw[1] - 3))
    kw = dict(quantize=quantize, out_dtype=TORCH[storage])
    launch = getattr(rdma, kernel)
    extra = {"tile": (8, 16)} if kernel == "rdma_tiled" else {}
    for T in (1, 3):
        if not quantize and not f.convex and T > 2:
            continue  # float mode grows by L1(taps) per level
        before = launch.launches
        got = mesh.join_blocks(rdma.unstack_blocks(launch(
            rdma.stack_blocks(blocks, grid_shape), f, grid_shape, boundary, T,
            valid, **kw, **extra), grid_shape))
        torch.cuda.synchronize()
        assert launch.launches == before + 1
        want = mesh.join_blocks(rdma.fused_rdma_step_plain(
            blocks, f, grid_shape, boundary, fuse=T, valid_hw=valid, **kw))
        _assert_agree(got, want, f, T, quantize)


# A non-dyadic 7x7 filter: its products are not exact in float32, so the
# kernels' one rounding per tap (FMA) and the plain version's two part at
# the last bit.  Float mode holds it within float_tolerance; quantize mode
# may differ only where that last bit moves the sum across a rint boundary.
GAUSSIAN7 = gaussian(7, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rdma_block", "rdma_tiled"])
@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("grid_shape,boundary", GRIDS)
def test_rdma_non_dyadic_float_mode(cuda_device, grid_shape, boundary,
                                    storage, kernel):
    f = GAUSSIAN7
    assert not f.dyadic and f.convex
    blocks = _grid_blocks(62, grid_shape, (23, 37), storage, cuda_device)
    valid = (None if boundary == "periodic" else
             (grid_shape[0] * 23 - 2, grid_shape[1] * 37 - 3))
    kw = dict(quantize=False, out_dtype=TORCH[storage])
    extra = {"tile": (8, 16)} if kernel == "rdma_tiled" else {}
    x = rdma.stack_blocks(blocks, grid_shape)
    for T in (1, 3):
        got = rdma.unstack_blocks(getattr(rdma, kernel)(
            x, f, grid_shape, boundary, T, valid, **kw, **extra), grid_shape)
        want = rdma.fused_rdma_step_plain(blocks, f, grid_shape, boundary,
                                          fuse=T, valid_hw=valid, **kw)
        _assert_agree(mesh.join_blocks(got), mesh.join_blocks(want), f, T,
                      False)


def _fma_chain(padded, filt):
    """One level in the kernels' order, one rounding per tap: acc starts at
    0.0 and takes fma(tap, x, acc) over the taps in row-major order.  In
    float64, tap * x (24 by 8 significant bits) is exact and so is the sum
    with a float32 acc below 2^9 while taps stay above 2^-21, so rounding
    that sum once to float32 is the FMA's single rounding."""
    k = filt.size
    C, Hp, Wp = padded.shape
    h, w = Hp - k + 1, Wp - k + 1
    src = padded.to(torch.float64)
    acc = torch.zeros((C, h, w), dtype=torch.float32, device=padded.device)
    for dy in range(k):
        for dx in range(k):
            t = float(filt.taps[dy, dx])
            acc = (acc.double() + t * src[:, dy:dy + h, dx:dx + w]).float()
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rdma_block", "rdma_tiled"])
def test_rdma_non_dyadic_quantize_differs_only_at_rint_ties(cuda_device,
                                                           kernel):
    # Where K3 / K4 and the plain version disagree in quantize mode for a
    # non-dyadic filter, it is the documented FMA rint straddle: the
    # kernel's accumulator is exactly the FMA chain, its byte is rint of
    # that, and each differing byte sits where the FMA and the two-rounding
    # sums (a few ulps apart) fall on either side of a half-integer.
    f, grid_shape, bhw = GAUSSIAN7, (2, 2), (96, 128)
    assert min(abs(float(t)) for t in f.taps.ravel()) > 2.0 ** -21
    blocks = _grid_blocks(63, grid_shape, bhw, "f32", cuda_device, channels=3)
    valid = (2 * bhw[0] - 2, 2 * bhw[1] - 3)
    x = rdma.stack_blocks(blocks, grid_shape)
    launch = getattr(rdma, kernel)
    extra = {"tile": (32, 64)} if kernel == "rdma_tiled" else {}

    def run(quantize):
        out = launch(x, f, grid_shape, "zero", 1, valid, quantize=quantize,
                     out_dtype=torch.float32, **extra)
        return mesh.join_blocks(rdma.unstack_blocks(out, grid_shape))

    q, acc = run(True), run(False)
    torch.cuda.synchronize()
    assert torch.equal(q, torch.round(acc))
    # The FMA chain over the joined image, zero outside it, masked to it.
    full = mesh.join_blocks(blocks)
    ok = torch.zeros_like(full[:1])
    ok[:, :valid[0], :valid[1]] = 1
    fma = _fma_chain(torch.nn.functional.pad(full * ok, (f.radius,) * 4), f)
    assert torch.equal(acc, fma * ok)
    plain = {qz: mesh.join_blocks(rdma.fused_rdma_step_plain(
        blocks, f, grid_shape, "zero", quantize=qz, fuse=1, valid_hw=valid))
        for qz in (True, False)}
    assert torch.equal(plain[True], torch.round(plain[False]))
    _, atol = stencil.float_tolerance(f, 1, torch.float32)
    assert (acc - plain[False]).abs().max().item() <= atol
    differ = q != plain[True]
    # Each differing byte is one apart, and the half-integer between the
    # two bytes lies between (or on) the FMA and the two-rounding sums.
    assert torch.equal((q - plain[True])[differ].abs(),
                       torch.ones_like(q[differ]))
    mid = (q + plain[True])[differ] / 2
    assert ((acc[differ] - mid) * (plain[False][differ] - mid) <= 0).all()
    print(f"{kernel} gaussian7 T=1: {int(differ.sum())} of {q.numel()} "
          f"bytes differ from the plain version, all at rint ties")


@pytest.mark.cuda
@pytest.mark.parametrize("name,bhw,kernel,groups", [
    ("blur3", (100, 100), "block", 1),     # r = 1: K3 holds all 32 levels
    ("edge5", (130, 136), "tiled", 4),     # r = 2: K4 for 8, then K2 3 x 8
    ("gaussian5", (130, 136), "tiled", 4)])
@pytest.mark.parametrize("storage", ["bf16", "u8"])
def test_rdma_deep_chunk_in_level_groups(cuda_device, name, bhw, kernel,
                                         groups, storage):
    f = get_filter(name)
    blocks = _grid_blocks(61, (2, 2), bhw, storage, cuda_device, channels=1)
    valid = (2 * bhw[0] - 1, 2 * bhw[1] - 5)
    plan = rdma.rdma_plan(f.radius, 32, bhw)
    assert (plan.kernel, len(plan.groups)) == (kernel, groups)
    stencil.reset_launch_counts()
    halo.halo_exchange.calls = 0
    got = mesh.join_blocks(rdma.fused_rdma_step(blocks, f, (2, 2), "zero",
                                                fuse=32, valid_hw=valid))
    torch.cuda.synchronize()
    assert stencil.launch_counts() == {
        "stencil_step": 0, "fused_iterate": 4 * (groups - 1),
        "rdma_block": int(kernel == "block"),
        "rdma_tiled": int(kernel == "tiled")}
    assert halo.halo_exchange.calls == 0
    want = mesh.join_blocks(rdma.fused_rdma_step_plain(
        blocks, f, (2, 2), "zero", fuse=32, valid_hw=valid))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_rdma_cuda_tensors_never_reach_the_plain_version(cuda_device,
                                                         monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(rdma, "fused_rdma_step_plain", refuse)
    monkeypatch.setattr(halo, "halo_exchange", refuse)
    f = get_filter("blur3")
    img = imageio.generate_test_image(61, 83, "grey", seed=9)
    model = ConvolutionModel("blur3", backend="cuda_rdma", storage="u8",
                             fuse=4, grid=mesh.make_grid((2, 2), cuda_device))
    stencil.reset_launch_counts()
    got = model.run_image(img, 9)
    assert stencil.launch_counts()["rdma_block"] == 3   # 2 chunks + a tail
    assert (got == oracle.run_serial_u8(img, f, 9)).all()
    # A block on the card beside one on the CPU is refused, not mixed.
    blocks = [[torch.zeros((1, 8, 8), device=cuda_device),
               torch.zeros((1, 8, 8))]]
    with pytest.raises(ValueError, match="one shape, dtype and device"):
        rdma.fused_rdma_step(blocks, f, (1, 2), "periodic")


# ---------------------------------------------------------------------------
# TPU kernel 5: the probes (csrc/probes.cu)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("op,dtype,ops", op_price.CANDIDATES)
def test_op_chain_kernel_matches_plain(cuda_device, op, dtype, ops):
    x = op_price.make_input(dtype, rows=64, cols=512, seed=3).to(cuda_device)
    before = op_price.op_chain.launches
    got = op_price.op_chain(x, op, dtype)
    torch.cuda.synchronize()
    assert op_price.op_chain.launches == before + 1
    assert got.shape == (op_price.CHAINS, 64, 512)
    assert torch.equal(got, op_price.op_chain_plain(x, op, dtype))


@pytest.mark.cuda
def test_smem_probe_steps_classify(cuda_device):
    rows = smem_budget.measure(cuda_device)
    assert [r["error_class"] for r in rows] == [
        "ok" if r["fits"] else "clean_refusal" for r in rows]
    assert [r["fits"] for r in rows] == [True, False, True, True, False,
                                         False]
    assert rows[0]["optin_runtime"] == stencil._smem_limit(cuda_device)
    x = torch.ones(100, device=cuda_device)
    out, attr, err = smem_budget.smem_probe(x, 0, False)
    torch.cuda.synchronize()
    assert (attr, err) == (0, 0) and torch.equal(out, x + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("grid_shape,boundary", [((2, 2), "zero"),
                                                 ((1, 3), "periodic")])
@pytest.mark.parametrize("rung", rdma_ladder.RUNGS)
def test_rdma_ladder_matches_plain(cuda_device, rung, grid_shape, boundary):
    f = get_filter("blur3")
    blocks = _grid_blocks(71, grid_shape, (40, 52), "bf16", cuda_device)
    x = rdma.stack_blocks(blocks, grid_shape)
    valid = (None if boundary == "periodic"
             else (40 * grid_shape[0] - 3, 52 * grid_shape[1] - 1))
    args = (x, f, grid_shape, boundary, 3, rung, valid)
    got = rdma_ladder.rdma_ladder(*args, tile=(16, 32))
    torch.cuda.synchronize()
    assert torch.equal(got, rdma_ladder.rdma_ladder_plain(*args))
    if rung == "r3_levels":
        k4 = rdma.rdma_tiled(x, f, grid_shape, boundary, 3, valid,
                             tile=(16, 32))
        assert torch.equal(got, k4)


@pytest.mark.cuda
def test_probe_counts_are_their_own(cuda_device):
    probes.reset_launch_counts()
    stencil.reset_launch_counts()
    x = op_price.make_input("f32", rows=8, cols=64).to(cuda_device)
    op_price.op_chain(x, "add", "f32")
    assert probes.launch_counts()["op_chain"] == 1
    assert not any(stencil.launch_counts().values())


# ---------------------------------------------------------------------------
# backend="auto" on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_resolve_on_card_picks_a_cuda_backend(cuda_device):
    """The BASELINE RGB workload (1920x2520 blur3) on one card."""
    res = tuning.resolve(mesh.make_grid(device=cuda_device),
                         get_filter("blur3"), (3, 1920, 2520),
                         storage="bf16", plans=tuning.PlanCache())
    assert res.backend in ("cuda", "cuda_sep", "cuda_rdma")
    assert res.source == "predicted" and res.fuse >= 1
    assert res.key == tuning.Workload.from_grid(
        mesh.make_grid(device=cuda_device), get_filter("blur3"),
        (3, 1920, 2520), storage="bf16").key()


@pytest.mark.cuda
@pytest.mark.parametrize("grid_shape,storage", [((1, 1), "bf16"),
                                                ((2, 2), "u8")])
def test_auto_end_to_end_matches_shifted(cuda_device, grid_shape, storage,
                                         monkeypatch):
    monkeypatch.delenv(tuning.PLAN_FILE_ENV, raising=False)
    f = get_filter("blur3")
    img = imageio.generate_test_image(97, 131, "rgb", seed=12)
    grid = mesh.make_grid(grid_shape, cuda_device)
    model = ConvolutionModel("blur3", grid=grid, backend="auto",
                             storage=storage, fuse=None)
    stencil.reset_launch_counts()
    got = model.run_image(img, 7)
    assert any(stencil.launch_counts().values())
    assert model.effective_backend in ("cuda", "cuda_sep", "cuda_rdma")
    want = ConvolutionModel("blur3", grid=grid, backend="shifted").run_image(
        img, 7)
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle.run_serial_u8(img, f, 7))
