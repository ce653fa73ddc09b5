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


# K2's interior split (the 9-patch launch): (filter, storage, quantize, T,
# offsets, valid, block_off, tile).  The tiles make several level groups
# (at most r·g = tile/4 a group), so each group plans its own patches.
SPLIT_CASES = [
    ("blur3", "u8", True, 32, (0, 0), (300, 900), (0, 0), (16, 64)),
    ("blur3", "bf16", True, 32, (0, 0), (300, 900), (0, 0), None),
    ("gaussian5", "u8", True, 9, (200, 0), (437, 613),
     ((200, 200), (0, 0)), (32, 64)),
    ("edge5", "f32", False, 8, (128, 256), (1000, 1000),
     ((128, 512), (256, 256)), (32, 32)),
    ("blur3", "f32", False, 12, (333, 0), (666, 500), (333, 0), (16, 128)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_fused_interior_split_matches_one_launch(cuda_device, case):
    name, storage, quantize, T, off, valid, block_off, tile = case
    f = get_filter(name)
    r = f.radius
    h, w = min(300, valid[0] - off[0]), min(900, valid[1] - off[1])
    x = _data(61 + T, (2 if storage == "bf16" else 1, h + 2 * r * T,
                       w + 2 * r * T), storage, cuda_device)
    kw = dict(quantize=quantize, out_dtype=TORCH[storage],
              separable=storage == "bf16", tile=tile)
    th, tw, groups = stencil.fused_plan(r, T, (h, w), tile)
    assert len(groups) > 1
    patches, left = 0, T
    for g in groups:
        left -= g
        oh, ow = h + 2 * r * left, w + 2 * r * left
        patches += len(stencil.launch_patches(
            valid, (min(th, oh), min(tw, ow)), r * g, (oh, ow), block_off,
            r * left))
    assert len(groups) < patches <= 9 * len(groups)
    before = stencil.fused_iterate.launches
    got = stencil.fused_iterate(x, off, f, T, valid, interior_split=True,
                                block_off=block_off, **kw)
    torch.cuda.synchronize()
    assert stencil.fused_iterate.launches == before + patches
    one = stencil.fused_iterate(x, off, f, T, valid, **kw)
    # A dropped mask is a multiply by 1.0: the single launch's bits.
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    assert got.dtype == one.dtype and torch.equal(
        got.view(bits[got.element_size()]), one.view(bits[one.element_size()]))
    want = stencil.fused_iterate_plain(x, off, f, T, valid,
                                       interior_split=True,
                                       block_off=block_off, **kw)
    _assert_agree(got, want, f, T, quantize)


@pytest.mark.cuda
@pytest.mark.parametrize("grid_shape,storage", [((1, 1), "bf16"),
                                                ((2, 2), "u8"),
                                                ((4, 4), "f32")])
def test_sharded_interior_split_bitwise(cuda_device, grid_shape, storage):
    # Every offset class (a 4-block axis has the first, middle and last)
    # on an odd extent, where the pad-to-multiple rim is masked.
    img = imageio.generate_test_image(517, 1003, "rgb", seed=4)
    kw = dict(grid=mesh.make_grid(grid_shape, cuda_device),
              backend="cuda_sep", storage=storage, fuse=16)
    split = ConvolutionModel("blur3", interior_split=True, **kw)
    stencil.reset_launch_counts()
    got = split.run_image(img, 40)
    n_split = stencil.launch_counts()["fused_iterate"]
    stencil.reset_launch_counts()
    want = ConvolutionModel("blur3", **kw).run_image(img, 40)
    assert n_split > stencil.launch_counts()["fused_iterate"] > 0
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle.run_serial_u8(img, get_filter("blur3"),
                                                    40))


@pytest.mark.cuda
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_volume_forms_on_the_card(cuda_device, boundary):
    # The rank-3 forms are plain PyTorch: on the card against the numpy
    # oracle, and bitwise across grids, fusion and the _stack twins.
    from parallel_convolution_tpu_torch.utils.config import VOLUME_FORMS
    from parallel_convolution_tpu_torch.volumes import driver, oracle3

    rng = np.random.default_rng(11)
    vol = rng.random((2, 10, 24, 40) if boundary == "periodic"
                     else (2, 10, 22, 37), dtype=np.float32)
    g1, g2 = (mesh.make_grid(s, cuda_device) for s in ((1, 1), (2, 2)))
    for name in VOLUME_FORMS:
        a = driver.volume_iterate(vol, name, 3, grid=g2, boundary=boundary)
        assert a.is_cuda
        np.testing.assert_allclose(
            a.cpu().numpy(), oracle3.run_oracle(vol, name, 3, boundary),
            rtol=0, atol=2e-5)
        assert torch.equal(a, driver.volume_iterate(
            vol, name, 3, grid=g1, boundary=boundary))
        fuse = 2 if name.startswith("fd25") else 3
        assert torch.equal(a, driver.volume_iterate(
            vol, name, 3, grid=g2, boundary=boundary, fuse=fuse))
    for base in ("fd7", "fd25"):
        assert torch.equal(
            driver.volume_iterate(vol, base, 4, grid=g2, boundary=boundary),
            driver.volume_iterate(vol, base + "_stack", 4, grid=g2,
                                  boundary=boundary))
    state, done, _ = driver.volume_converge(vol, "fd7", tol=0.0,
                                            max_iters=8, check_every=3,
                                            grid=g2, fuse=2)
    assert done == 8 and torch.equal(
        state, driver.volume_iterate(vol, "fd7", 8, grid=g2))


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
        "rdma_tiled": int(kernel == "tiled"), "rdma_block_slot": 0,
        "rdma_tiled_slot": 0, "rdma_block_region": 0,
        "rdma_tiled_region": 0, "rdma_pack": 0}
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
def test_smem_probe_refusals_survive_the_attribute_cache(cuda_device):
    # Sizes alternate across the limits: the attribute is raised only when
    # the size it last accepted changes, and a refused size is asked again
    # every time, so each step is right or refused as smem_budget.fits says.
    limit = stencil._smem_limit(cuda_device)
    x = (torch.arange(131072, dtype=torch.float32, device=cuda_device)
         .reshape(smem_budget.SHAPE) % 251.0)
    steps = [(100 * 1024, True), (limit + 1, True), (limit + 1, True),
             (100 * 1024, True), (48 * 1024, False), (limit, True),
             (48 * 1024 + 1, False), (100 * 1024, True), (0, False)]
    for nbytes, opt in steps:
        out, attr, err = smem_budget.smem_probe(x, nbytes, opt)
        torch.cuda.synchronize()
        if smem_budget.fits(nbytes, opt, limit):
            assert (attr, err) == (0, 0), (nbytes, opt)
            assert torch.equal(out, x + 1), (nbytes, opt)
        else:
            assert attr or err, (nbytes, opt)
            # Refused cleanly: the next launch runs.
            c_out, *codes = smem_budget.smem_probe(x[:1], 0, False)
            torch.cuda.synchronize()
            assert codes == [0, 0] and torch.equal(c_out, x[:1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(131072, 0), (131071, 0), (131072, 1),
                                      (131069, 3), (5, 0), (3, 0)])
@pytest.mark.parametrize("nbytes,opt", [(100 * 1024, True), (0, False)])
def test_smem_probe_float4_body_and_tail(cuda_device, n, offset, nbytes,
                                         opt):
    # float4s where both pointers are 16-byte aligned (a scalar tail of
    # n % 4), floats where the input is a view 4·offset bytes in.
    base = torch.rand(n + offset, device=cuda_device) * 100
    x = base[offset:]
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    before = smem_budget.smem_probe.launches
    out, attr, err = smem_budget.smem_probe(x, nbytes, opt)
    torch.cuda.synchronize()
    assert (attr, err) == (0, 0)
    assert smem_budget.smem_probe.launches == before + 1
    assert torch.equal(out, smem_budget.smem_probe_plain(x))


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


# ---------------------------------------------------------------------------
# Run to convergence on the card
# ---------------------------------------------------------------------------

# (backend, grid, storage, quantize, fuse, the kernels that must run): u8
# mode is blur3 on a grey image, float mode jacobi3 on a normal field, each
# tol stopping the run after 30 or 40 of its 60 iterations.
# cuda_rdma at 16x16 has 30x40 blocks (K3); at 2x2, 240x320 (K4, T = 1
# included).
CONVERGE_CASES = [
    ("cuda", (1, 1), "u8", True, 4, ("stencil_step", "fused_iterate")),
    ("cuda", (2, 2), "f32", False, 3, ("stencil_step", "fused_iterate")),
    ("cuda", (2, 2), "bf16", True, 1, ("stencil_step",)),
    ("cuda_sep", (1, 1), "bf16", True, 9, ("stencil_step", "fused_iterate")),
    ("cuda_sep", (2, 2), "f32", False, 10, ("stencil_step",
                                            "fused_iterate")),
    ("cuda_rdma", (16, 16), "u8", True, 8, ("rdma_block",)),
    ("cuda_rdma", (2, 2), "bf16", True, 8, ("rdma_tiled",)),
    ("cuda_rdma", (2, 2), "f32", False, 3, ("rdma_tiled",)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("backend,grid_shape,storage,quantize,fuse,kernels",
                         CONVERGE_CASES)
def test_converge_on_card_matches_shifted(cuda_device, backend, grid_shape,
                                          storage, quantize, fuse, kernels):
    from parallel_convolution_tpu_torch.parallel import step
    from parallel_convolution_tpu_torch.utils.bench import converge_input

    hw = (480, 640)
    if quantize:
        f, tol = get_filter("blur3"), 2.5
        x = imageio.generate_test_image(*hw, "grey", seed=13)[None]
        x = x.astype(np.float32)
    else:
        f, tol = get_filter("jacobi3"), 0.56
        x = converge_input(hw, 1, seed=13)
    kw = dict(check_every=10, quantize=quantize, storage=storage)
    grid = mesh.make_grid(grid_shape, cuda_device)
    stencil.reset_launch_counts()
    halo.halo_exchange.calls = 0
    before = step.sharded_converge.readbacks
    got, iters = step.sharded_converge(x, f, tol, 60, grid=grid,
                                       backend=backend, fuse=fuse, **kw)
    counts = stencil.launch_counts()
    assert step.sharded_converge.readbacks - before == -(-iters // 10)
    assert all(counts[k] > 0 for k in kernels), counts
    assert backend != "cuda_rdma" or halo.halo_exchange.calls == 0
    want, witers = step.sharded_converge(x, f, tol, 60, grid=grid,
                                         backend="shifted", **kw)
    assert got.device.type == "cuda" and iters == witers
    _assert_agree(got, want, f, iters, quantize)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,grid_shape", [("cuda", (2, 2)),
                                                ("cuda_rdma", (2, 2))])
def test_converge_on_card_stops_on_a_nan_diff(cuda_device, backend,
                                              grid_shape):
    from parallel_convolution_tpu_torch.parallel import step
    from parallel_convolution_tpu_torch.utils.bench import converge_input

    x = converge_input((64, 96), 1, seed=14)
    x[0, 5, 7] = np.nan
    args = (x, get_filter("jacobi3"), 1e-3, 50)
    kw = dict(check_every=5, grid=mesh.make_grid(grid_shape, cuda_device),
              backend=backend, fuse=3)
    got, iters = step.sharded_converge(*args, **kw)
    rows = list(step.sharded_converge_stream(*args, **kw))
    assert iters == 5 and [done for _, done, _ in rows] == [5]
    assert np.isnan(rows[-1][2])


# ---------------------------------------------------------------------------
# The huge-image workflow: planes past 2^31 elements, sharded IO and the
# fallback probe on the card
# ---------------------------------------------------------------------------

BIG = 46400  # 46400^2 = 2,152,960,000 > 2^31 elements in one plane


def _oracle_windows(x, got, filt, levels, size=96):
    """Hold ``got`` (1, H, W) u8 on the card against the NumPy oracle run on
    input crops of ``x`` (1, H, W) u8 that reach levels * r beyond each
    window (clamped to the image, whose edge is the true zero boundary):
    the corners, the centre, and windows past 2^31 elements."""
    _, H, W = x.shape
    m = levels * filt.radius
    wins = [(0, 0), (0, W - size), (H - size, 0), (H - size, W - size),
            (H // 2, W // 2), (H - size - 1000, W // 3), (H - 3 * size, 77)]
    for y, x0 in wins:
        cy0, cx0 = max(0, y - m), max(0, x0 - m)
        cy1, cx1 = min(H, y + size + m), min(W, x0 + size + m)
        crop = x[0, cy0:cy1, cx0:cx1].cpu().numpy()
        want = oracle.run_serial_u8(crop, filt, levels)[
            y - cy0:y - cy0 + size, x0 - cx0:x0 - cx0 + size]
        assert np.array_equal(
            got[0, y:y + size, x0:x0 + size].cpu().numpy(), want), (y, x0)


@pytest.fixture
def big_plane(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(46400)
    return torch.randint(0, 256, (1, BIG, BIG), generator=g,
                         device=cuda_device, dtype=torch.uint8)


@pytest.mark.cuda
def test_step_kernel_past_2_31_elements(big_plane):
    f = get_filter("blur3")
    p = torch.zeros((1, BIG + 2, BIG + 2), dtype=torch.uint8,
                    device=big_plane.device)
    p[:, 1:-1, 1:-1] = big_plane
    stencil.reset_launch_counts()
    got = stencil.stencil_step(p, f, quantize=True)
    torch.cuda.synchronize()
    assert stencil.launch_counts()["stencil_step"] == 1
    del p
    _oracle_windows(big_plane, got, f, 1)


@pytest.mark.cuda
def test_fused_kernel_past_2_31_elements_in_level_groups(big_plane):
    f, T = get_filter("blur3"), 20
    assert len(stencil.fused_plan(1, T, (BIG, BIG))[2]) == 2
    p = halo.halo_exchange([[big_plane]], T, (1, 1), "zero")[0][0]
    stencil.reset_launch_counts()
    got = stencil.fused_iterate(p, (0, 0), f, T, (BIG, BIG), quantize=True)
    torch.cuda.synchronize()
    assert stencil.launch_counts()["fused_iterate"] == 2
    assert got.dtype == torch.uint8
    del p
    _oracle_windows(big_plane, got, f, T)


@pytest.mark.cuda
def test_rdma_tiled_past_2_31_elements_in_level_groups(big_plane):
    f, T = get_filter("blur3"), 20
    x = big_plane[None]  # the stacked 1x1 grid
    assert rdma.rdma_plan(1, T, (BIG, BIG)).kernel == "tiled"
    stencil.reset_launch_counts()
    got = rdma.fused_rdma_stacked(x, f, (1, 1), "zero", fuse=T,
                                  valid_hw=(BIG, BIG))
    torch.cuda.synchronize()
    counts = stencil.launch_counts()
    assert (counts["rdma_tiled"], counts["fused_iterate"]) == (1, 1)
    _oracle_windows(big_plane, got[0], f, T)


@pytest.mark.cuda
@pytest.mark.parametrize("grid_shape,backend,storage,fuse", [
    ((1, 1), "cuda_sep", "u8", 32), ((2, 3), "cuda_rdma", "u8", 8),
    ((2, 2), "cuda", "bf16", 4)])
def test_sharded_io_on_the_card_in_bands(cuda_device, tmp_path, monkeypatch,
                                         grid_shape, backend, storage, fuse):
    from parallel_convolution_tpu_torch.parallel import step
    from parallel_convolution_tpu_torch.utils import sharded_io

    monkeypatch.setattr(sharded_io, "BAND_BYTES", 4096)  # ~7 rows a band
    rows, cols = 301, 197
    img = imageio.generate_test_image(rows, cols, "rgb", seed=17)
    src, dst = tmp_path / "in.raw", tmp_path / "out.raw"
    imageio.write_raw(src, img)
    grid = mesh.make_grid(grid_shape, cuda_device)
    blocks = sharded_io.load_sharded(src, rows, cols, "rgb", grid,
                                     dtype=TORCH[storage])
    want = step._prepare(imageio.interleaved_to_planar(img), grid,
                         storage)[0]
    assert all(b.device.type == "cuda" and torch.equal(b, w)
               for row, wrow in zip(blocks, want) for b, w in zip(row, wrow))
    sharded_io.save_sharded(dst, blocks, rows, cols, "rgb")
    assert np.array_equal(imageio.read_raw(dst, rows, cols, "rgb"), img)
    model = ConvolutionModel("blur3", grid=grid, backend=backend,
                             storage=storage, fuse=fuse)
    stencil.reset_launch_counts()
    model.run_raw_file_sharded(str(src), str(dst), rows, cols, "rgb", 40)
    assert any(stencil.launch_counts().values())
    assert np.array_equal(imageio.read_raw(dst, rows, cols, "rgb"),
                          oracle.run_serial_u8(img, get_filter("blur3"), 40))


@pytest.mark.cuda
def test_fallback_probe_at_a_real_block_size(cuda_device):
    from parallel_convolution_tpu_torch.resilience import (
        degrade, faults, retry,
    )

    f = get_filter("blur3")
    img = imageio.generate_test_image(4096, 3072, "rgb", seed=18)
    want = ConvolutionModel("blur3", backend="shifted",
                            device=cuda_device).run_image(img, 20)
    degrade.clear_probe_cache()
    # No fault: the probe runs the real kernel at the real block size
    # (one 16-level chunk, one K4 launch on the 2048x1536 blocks), and the
    # run keeps the backend asked for.
    model = ConvolutionModel("blur3", grid=mesh.make_grid((2, 2),
                                                          cuda_device),
                             backend="cuda_rdma", storage="u8", fuse=16,
                             fallback=True)
    stencil.reset_launch_counts()
    got = model.run_image(img, 20)
    counts = stencil.launch_counts()
    assert model.effective_backend == "cuda_rdma"
    assert counts["rdma_tiled"] == 1 + 2  # the probe's chunk, the run's two
    assert np.array_equal(got, want)
    # An injected compile fault degrades to cuda, with the same bytes.
    degrade.clear_probe_cache()
    with faults.injected("backend_compile:1"):
        with pytest.warns(degrade.BackendDegradedWarning,
                          match="'cuda_rdma' degraded to 'cuda'"):
            got = model.run_image(img, 20)
    assert model.effective_backend == "cuda"
    assert np.array_equal(got, want)
    # Every tier refused on the card: the walk stops at cuda and raises;
    # nothing runs the plain version in a kernel's place.
    degrade.clear_probe_cache()
    stencil.reset_launch_counts()
    with faults.injected("backend_compile:*"):
        with pytest.raises(retry.RetryExhausted):
            model.run_image(img, 20)
    assert sum(stencil.launch_counts().values()) == 0
    degrade.clear_probe_cache()
    # A real refused launch (5b over the opt-in limit) is transient, and
    # the context survives it.
    limit = stencil._smem_limit(cuda_device)
    x = torch.ones(256, device=cuda_device)
    _, attr, err = smem_budget.smem_probe(x, limit + 1, True)
    assert (attr or err) != 0
    with pytest.raises(RuntimeError, match="launch failed: cudaError") as e:
        stencil._raise_on(attr or err, "smem_probe (5b)")
    print(e.value)
    assert retry.classify(e.value) == retry.TRANSIENT
    out, attr, err = smem_budget.smem_probe(x, 0, False)
    torch.cuda.synchronize()
    assert (attr, err) == (0, 0) and torch.equal(out, x + 1)


@pytest.mark.cuda
def test_error_names_come_from_the_runtime(cuda_device):
    from parallel_convolution_tpu_torch.ops import _build

    lib = _build.load_library("probes")
    # The stand-in names (used before a library loads) are the runtime's.
    for code, name in _build.FALLBACK_ERROR_NAMES.items():
        assert lib.pc_error_name(code).decode() == name
    # A code outside them is named too, once a library is loaded.
    assert _build.error_text(800) == "cudaErrorNotPermitted (800)"


# ---------------------------------------------------------------------------
# Multigrid on the card: K1 (cuda) and K3 / K4 at T = 1 (cuda_rdma) as the
# V-cycle's smoother, down to 8x8 blocks on collapsed sub-grids.
# ---------------------------------------------------------------------------


def _mg_field(hw, seed):
    return np.random.default_rng(seed).standard_normal((1, *hw)).astype(
        np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,backend,grid_shape", [
    ((96, 64), "cuda", (1, 1)), ((96, 64), "cuda_rdma", (2, 2)),
    ((1030, 770), "cuda", (2, 2)), ((1030, 770), "cuda_rdma", (16, 16)),
])
def test_multigrid_on_card_matches_shifted(cuda_device, hw, backend,
                                           grid_shape):
    from parallel_convolution_tpu_torch.solvers import multigrid as mg

    jacobi3 = get_filter("jacobi3")
    x = _mg_field(hw, 0)
    grid = mesh.make_grid(grid_shape, cuda_device)
    # shifted is bitwise grid-invariant (tests/test_torch_multigrid.py):
    # its reference runs on one block.
    want, wres = mg.mg_converge(x, jacobi3, 1e-3, 2000,
                                grid=mesh.make_grid((1, 1), cuda_device))
    stencil.reset_launch_counts()
    got, res = mg.mg_converge(x, jacobi3, 1e-3, 2000, grid=grid,
                              backend=backend)
    counts = stencil.launch_counts()
    levels = mg.plan_levels(grid, hw, 1)
    per = mg.cycle_launches(levels, backend, 1)
    assert counts == {k: v * res.cycles for k, v in per.items()}
    assert sum(counts.values()) > 0 and res.backend == backend
    if hw == (1030, 770):
        # The coarse levels collapse onto smaller grids (2x2 → 2x1;
        # 16x16 → 8x8, 4x4, 2x2, 1x1).
        assert levels[-1].grid.shape != grid_shape
    # jacobi3's taps and the transfers' weights are dyadic: a product is
    # exact, so the kernels' FMA gives the plain bits, cycle for cycle.
    assert res.cycles == wres.cycles and res.converged
    assert res.residuals == wres.residuals
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,grids", [
    ("cuda", [(1, 1), (2, 2)]), ("cuda_rdma", [(1, 1), (2, 2), (4, 4)]),
])
def test_multigrid_on_card_bitwise_grid_invariant(cuda_device, backend,
                                                  grids):
    from parallel_convolution_tpu_torch.solvers import multigrid as mg

    x = _mg_field((1030, 770), 1)
    runs = [mg.mg_converge(x, get_filter("jacobi3"), 1e-3, 2000,
                           grid=mesh.make_grid(g, cuda_device),
                           backend=backend) for g in grids]
    assert len({r.cycles for _, r in runs}) == 1
    for out, _ in runs[1:]:
        assert torch.equal(out, runs[0][0])


@pytest.mark.cuda
@pytest.mark.parametrize("grid_shape", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("kind", ["block", "tiled"])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_rdma_t1_on_8x8_blocks_matches_plain(cuda_device, grid_shape, kind,
                                             boundary):
    # The coarse levels' launches: T = 1 on 8x8 blocks of a small grid,
    # float carry, the valid extent one short of the grid's (zero).
    jacobi3 = get_filter("jacobi3")
    R, C = grid_shape
    x = torch.from_numpy(_mg_field((8 * R, 8 * C), 2)).to(cuda_device)
    blocks = mesh.split_blocks(x, mesh.make_grid(grid_shape, cuda_device))
    stacked = rdma.stack_blocks(blocks, grid_shape)
    valid = None if boundary == "periodic" else (8 * R - 1, 8 * C - 1)
    if kind == "block":
        got = rdma.rdma_block(stacked, jacobi3, grid_shape, boundary, 1,
                              valid, quantize=False)
    else:
        got = rdma.rdma_tiled(stacked, jacobi3, grid_shape, boundary, 1,
                              valid, quantize=False, tile=(4, 8))
    cpu = [[b.cpu() for b in row] for row in blocks]
    want = rdma.stack_blocks(rdma.fused_rdma_step_plain(
        cpu, jacobi3, grid_shape, boundary, False, torch.float32, 1, valid),
        grid_shape)
    _assert_agree(got.cpu(), want, jacobi3, 1, False)


# K3 / K4 per device on a grid of slots (every slot on this card): one
# launch per slot behind the barrier between slots, both column transports,
# against their plain version (the JAX semantics literally) and against the
# one-launch form, bit for bit.
SLOT_GRIDS = [((2, 2), "zero"), ((1, 4), "periodic"), ((2, 3), "zero"),
              ((4, 1), "periodic"), ((3, 3), "periodic")]


def _slot_grid(grid_shape, device):
    return mesh.make_grid(grid_shape,
                          devices=[device] * (grid_shape[0] * grid_shape[1]))


def _slot_chunk(blocks, grid_shape, f, boundary, T, valid, col_mode,
                quantize, device, chunks=1, **kw):
    carry = rdma.slot_carry(blocks, _slot_grid(grid_shape, device), boundary,
                            f.radius * T, col_mode)
    for _ in range(chunks):
        carry = rdma.fused_rdma_slots(carry, f, grid_shape, boundary,
                                      quantize=quantize, fuse=T,
                                      valid_hw=valid, col_mode=col_mode,
                                      **kw)
    return mesh.join_blocks(rdma.slot_blocks(carry, grid_shape)), carry


def _valid(grid_shape, bhw, boundary):
    return (None if boundary == "periodic" else
            (grid_shape[0] * bhw[0] - 2, grid_shape[1] * bhw[1] - 3))


@pytest.mark.cuda
@pytest.mark.parametrize("col_mode", ["packed", "strided"])
@pytest.mark.parametrize("storage,quantize", RDMA_MODES)
@pytest.mark.parametrize("grid_shape,boundary", SLOT_GRIDS)
def test_rdma_slots_match_plain_and_one_launch(cuda_device, grid_shape,
                                               boundary, storage, quantize,
                                               col_mode):
    f = get_filter("edge5" if quantize else "blur3")
    bhw = (23, 37)
    R, C = grid_shape
    blocks = _grid_blocks(61, grid_shape, bhw, storage, cuda_device)
    valid = _valid(grid_shape, bhw, boundary)
    kw = dict(quantize=quantize, out_dtype=TORCH[storage])
    for T in (1, 3):
        before = (rdma.rdma_block_slot.launches, rdma.rdma_pack.launches,
                  rdma.rdma_block.launches)
        got, _ = _slot_chunk(blocks, grid_shape, f, boundary, T, valid,
                             col_mode, quantize, cuda_device)
        torch.cuda.synchronize()
        packed = col_mode == "packed" and C > 1
        assert (rdma.rdma_block_slot.launches, rdma.rdma_pack.launches,
                rdma.rdma_block.launches) == (
            before[0] + R * C, before[1] + (R * C if packed else 0),
            before[2])
        want = mesh.join_blocks(rdma.fused_rdma_slots_plain(
            blocks, f, grid_shape, boundary, fuse=T, valid_hw=valid,
            col_mode=col_mode, **kw))
        _assert_agree(got, want, f, T, quantize)
        one = mesh.join_blocks(rdma.unstack_blocks(rdma.rdma_block(
            rdma.stack_blocks(blocks, grid_shape), f, grid_shape, boundary,
            T, valid, **kw), grid_shape))
        assert torch.equal(got, one)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["u8", "bf16", "f32"])
@pytest.mark.parametrize("grid_shape,boundary", SLOT_GRIDS)
def test_rdma_tiled_slots_packed_equal_strided(cuda_device, monkeypatch,
                                               grid_shape, boundary, storage):
    # A shared-memory limit of 32 KB sends (70, 90) blocks at T = 3 to K4.
    monkeypatch.setattr(stencil, "_smem_limit", lambda dev: 32 * 1024)
    f = get_filter("gaussian5")
    bhw = (70, 90)
    assert rdma.rdma_plan(2, 3, bhw, None, 32 * 1024).kernel == "tiled"
    blocks = _grid_blocks(62, grid_shape, bhw, storage, cuda_device,
                          channels=1)
    valid = _valid(grid_shape, bhw, boundary)
    before = rdma.rdma_tiled_slot.launches
    got = {cm: _slot_chunk(blocks, grid_shape, f, boundary, 3, valid, cm,
                           True, cuda_device, chunks=2)[0]
           for cm in ("packed", "strided")}
    torch.cuda.synchronize()
    n = grid_shape[0] * grid_shape[1]
    assert rdma.rdma_tiled_slot.launches == before + 4 * n
    assert torch.equal(got["packed"], got["strided"])
    want = blocks
    for _ in range(2):
        want = rdma.fused_rdma_slots_plain(want, f, grid_shape, boundary,
                                           fuse=3, valid_hw=valid)
    assert torch.equal(got["packed"], mesh.join_blocks(want))


@pytest.mark.cuda
@pytest.mark.parametrize("col_mode", ["packed", "strided"])
@pytest.mark.parametrize("storage", ["bf16", "u8"])
def test_rdma_slots_deep_chunk_in_level_groups(cuda_device, col_mode,
                                               storage):
    # 32 levels of edge5 on (130, 136) blocks: K4 for 8 levels, then K2
    # per slot for 3 x 8, each on the slot's stream.
    f = get_filter("edge5")
    bhw = (130, 136)
    plan = rdma.rdma_plan(2, 32, bhw)
    assert plan.kernel == "tiled" and len(plan.groups) == 4
    blocks = _grid_blocks(63, (2, 2), bhw, storage, cuda_device, channels=1)
    valid = (2 * bhw[0] - 1, 2 * bhw[1] - 5)
    before = stencil.launch_counts()
    got, _ = _slot_chunk(blocks, (2, 2), f, "zero", 32, valid, col_mode,
                         True, cuda_device)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in stencil.launch_counts().items()}
    assert delta["rdma_tiled_slot"] == 4 and delta["fused_iterate"] == 12
    assert delta["rdma_tiled"] == delta["rdma_block"] == 0
    want = mesh.join_blocks(rdma.fused_rdma_step(blocks, f, (2, 2), "zero",
                                                 fuse=32, valid_hw=valid))
    assert torch.equal(got, want)


# (block, depth, storage, the vector the plan picks): every instance of the
# pack (16, 8, 4, 2 and 1 bytes a thread) in every dtype it reaches, D up
# to the block's width.
PACK_CASES = [((8, 64), 8, "bf16", 16), ((8, 36), 4, "bf16", 8),
              ((20, 64), 16, "u8", 16), ((9, 12), 4, "u8", 4),
              ((8, 30), 6, "u8", 2), ((11, 7), 7, "u8", 1),
              ((8, 16), 4, "f32", 16), ((6, 6), 6, "f32", 8),
              ((5, 7), 3, "f32", 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("bhw,depth,storage,vec", PACK_CASES)
@pytest.mark.parametrize("grid_shape,boundary", [((2, 2), "zero"),
                                                 ((1, 4), "zero"),
                                                 ((2, 3), "zero"),
                                                 ((3, 3), "periodic")])
def test_rdma_pack_matches_plain(cuda_device, grid_shape, boundary, bhw,
                                 depth, storage, vec):
    # One launch a slot, as the slot paths make them, then the whole grid
    # and a range of it in one launch each (count > 1) into cleared
    # stagings; (1, 4) and (2, 3) under zero have blocks with no upper or
    # lower neighbour.  Byte-equal to the plain version.
    blocks = _grid_blocks(64, grid_shape, bhw, storage, cuda_device)
    n = grid_shape[0] * grid_shape[1]
    run = rdma.slot_carry(blocks, _slot_grid(grid_shape, cuda_device),
                          boundary, depth, "packed").run
    want = rdma.rdma_pack_plain(blocks, grid_shape, boundary, depth)
    before = rdma.rdma_pack.launches
    run.fork()
    for s in range(n):
        rdma.rdma_pack(run, 0, s, depth)
    run.join()
    torch.cuda.synchronize()
    assert rdma.rdma_pack.launches == before + n
    assert {run.pack_plans[(0, s, depth, 1)].vec for s in range(n)} == {vec}
    for s, w in enumerate(want):
        assert torch.equal(rdma.staged_slabs(run, s, depth), w), s
    for b0, count in ((0, n), (1, n - 2)):
        for st in run.stage:
            st.fill_(7)
        torch.cuda.synchronize()
        rdma.rdma_pack(run, 0, b0, depth, count=count)
        torch.cuda.synchronize()
        assert run.pack_plans[(0, b0, depth, count)].vec == vec
        for s in range(b0, b0 + count):
            assert torch.equal(rdma.staged_slabs(run, s, depth), want[s]), s
    assert rdma.rdma_pack.launches == before + n + 2


@pytest.mark.cuda
@pytest.mark.parametrize("col_mode", ["packed", "strided"])
def test_rdma_slots_barrier_holds_under_skew(cuda_device, col_mode):
    # About 1 ms of spin on one slot's stream before each of 12 chunks: the
    # other slots run ahead as far as the barrier lets them, and the bytes
    # do not move.  Without the barrier's waits their next launch would
    # read that slot's block before it is written.
    f = get_filter("blur3")
    R, C = 4, 4
    blocks = _grid_blocks(65, (R, C), (64, 64), "u8", cuda_device,
                          channels=1)
    valid = (R * 64 - 2, C * 64 - 3)

    def run(skew):
        carry = rdma.slot_carry(blocks, _slot_grid((R, C), cuda_device),
                                "zero", 1, col_mode)
        for _ in range(12):
            if skew:
                with torch.cuda.stream(carry.run.streams[5]):
                    torch.cuda._sleep(2_000_000)
            carry = rdma.fused_rdma_slots(carry, f, (R, C), "zero",
                                          fuse=1, valid_hw=valid,
                                          col_mode=col_mode)
        return mesh.join_blocks(rdma.slot_blocks(carry, (R, C)))

    steady = run(False)
    assert torch.equal(run(True), steady)
    want = rdma.stack_blocks(blocks, (R, C))
    for _ in range(12):
        want = rdma.rdma_block(want, f, (R, C), "zero", 1, valid)
    assert torch.equal(steady, mesh.join_blocks(rdma.unstack_blocks(
        want, (R, C))))


@pytest.mark.cuda
@pytest.mark.parametrize("col_mode", ["packed", "strided"])
def test_rdma_slots_across_cards_match_one_card(cuda_device, col_mode):
    # Slots round-robin over two cards, peer access on: each slot's first
    # launch reads blocks stacked on the other card, and a spin on one
    # slot's stream before every chunk leaves the bytes where one card
    # puts them.
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: slots on one card cannot show a "
                    "cross-card order")
    f = get_filter("blur3")
    R, C = 2, 4
    blocks = _grid_blocks(67, (R, C), (64, 64), "u8", cuda_device,
                          channels=1)
    valid = (R * 64 - 2, C * 64 - 3)
    grid = mesh.make_grid((R, C), devices=[f"cuda:{s % 2}"
                                           for s in range(R * C)])
    carry = rdma.slot_carry(mesh.split_blocks(mesh.join_blocks(blocks),
                                              grid),
                            grid, "zero", 1, col_mode)
    for _ in range(12):
        with torch.cuda.stream(carry.run.streams[1]):
            torch.cuda._sleep(2_000_000)
        carry = rdma.fused_rdma_slots(carry, f, (R, C), "zero", fuse=1,
                                      valid_hw=valid, col_mode=col_mode)
    got = mesh.join_blocks(rdma.slot_blocks(carry, (R, C)), cuda_device)
    want = rdma.stack_blocks(blocks, (R, C))
    for _ in range(12):
        want = rdma.rdma_block(want, f, (R, C), "zero", 1, valid)
    assert torch.equal(got, mesh.join_blocks(rdma.unstack_blocks(
        want, (R, C))))


# The overlapped pipeline (item 10b): K3 / K4 per slot launched region by
# region, the interior first with no wait, each band behind its own
# neighbours' events; byte-equal to the serialized per-slot form.


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["block", "tiled"])
@pytest.mark.parametrize("ext", [0, 3])
def test_rdma_region_launches_tile_the_whole_launch(cuda_device, monkeypatch,
                                                    kernel, ext):
    if kernel == "tiled":
        monkeypatch.setattr(stencil, "_smem_limit", lambda dev: 32 * 1024)
    f = get_filter("gaussian5")
    bhw, levels = (70, 90), 2
    T = levels + ext // f.radius if ext else levels
    ext = f.radius * (T - levels)
    blocks = _grid_blocks(68, (2, 2), bhw, "u8", cuda_device)
    valid = (2 * bhw[0] - 3, 2 * bhw[1] - 1)
    run = rdma.slot_carry(blocks, _slot_grid((2, 2), cuda_device), "zero",
                          f.radius * T, "strided").run
    whole = rdma.rdma_tiled_slot if kernel == "tiled" else \
        rdma.rdma_block_slot
    region = rdma.rdma_tiled_region if kernel == "tiled" else \
        rdma.rdma_block_region
    kw = dict(ext=ext, **({"tile": (32, 64)} if kernel == "tiled" else {}))
    oh, ow = bhw[0] + 2 * ext, bhw[1] + 2 * ext
    run.fork()
    for s in range(4):
        want = torch.full((2, oh, ow), 7, dtype=torch.uint8,
                          device=cuda_device)
        whole(run, 0, s, want, f, levels, valid, **kw)
        # The whole output as one region: today's launch, byte for byte.
        got = torch.full_like(want, 9)
        region(run, 0, s, got, f, levels, valid, (0, oh, 0, ow), **kw)
        # The five regions together: the whole, no gap and no overlap.
        parts = torch.full_like(want, 9)
        before = region.launches
        for _, rect, _ in rdma.overlap_schedule(oh, ow, f.radius * T, ext):
            region(run, 0, s, parts, f, levels, valid, rect, **kw)
        run.join()
        torch.cuda.synchronize()
        assert region.launches == before + 5
        assert torch.equal(got, want) and torch.equal(parts, want), s
    with pytest.raises(RuntimeError, match="slot 0 on .* region"):
        region(run, 0, 0, parts, f, levels, valid, (0, oh + 1, 0, ow), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("partitioned", [True, False])
@pytest.mark.parametrize("col_mode", ["packed", "strided"])
@pytest.mark.parametrize("grid_shape,boundary", SLOT_GRIDS)
def test_rdma_slots_overlap_equals_serialized(cuda_device, grid_shape,
                                              boundary, col_mode,
                                              partitioned):
    f = get_filter("edge5")
    bhw = (23, 37)
    R, C = grid_shape
    blocks = _grid_blocks(69, grid_shape, bhw, "u8", cuda_device)
    valid = _valid(grid_shape, bhw, boundary)
    for T in (1, 3, 5):
        want, _ = _slot_chunk(blocks, grid_shape, f, boundary, T, valid,
                              col_mode, True, cuda_device, chunks=2)
        before = rdma.rdma_block_region.launches
        got, _ = _slot_chunk(blocks, grid_shape, f, boundary, T, valid,
                             col_mode, True, cuda_device, chunks=2,
                             overlap=True, partitioned=partitioned)
        torch.cuda.synchronize()
        n = sum(len(g) for g in rdma.overlap_regions(*bhw, f.radius * T))
        assert rdma.rdma_block_region.launches == before + 2 * n * R * C
        assert torch.equal(got, want), T
    plain = rdma.fused_rdma_slots_plain(blocks, f, grid_shape, boundary,
                                        fuse=5, valid_hw=valid,
                                        col_mode=col_mode, overlap=True,
                                        partitioned=partitioned)
    one, _ = _slot_chunk(blocks, grid_shape, f, boundary, 5, valid,
                         col_mode, True, cuda_device, overlap=True,
                         partitioned=partitioned)
    assert torch.equal(one, mesh.join_blocks(plain))


@pytest.mark.cuda
@pytest.mark.parametrize("col_mode", ["packed", "strided"])
@pytest.mark.parametrize("storage", ["bf16", "u8"])
def test_rdma_slots_overlap_deep_chunk_and_tails(cuda_device, col_mode,
                                                 storage):
    # 32 levels of edge5 on (130, 136) blocks: K4's regions write a
    # 48-pixel rim, then K2 per slot for the later groups (rest > 0, the
    # copy into the carry after all eight waits); then single steps after
    # the fused chunk (the previous step read deeper than this one writes
    # clear of) and a fused chunk again.
    f = get_filter("edge5")
    bhw = (130, 136)
    blocks = _grid_blocks(70, (2, 2), bhw, storage, cuda_device, channels=1)
    valid = (2 * bhw[0] - 1, 2 * bhw[1] - 5)
    grid = _slot_grid((2, 2), cuda_device)

    def run(**kw):
        carry = rdma.slot_carry(blocks, grid, "zero", 64, col_mode)
        for T in (32, 1, 1, 8, 32):
            carry = rdma.fused_rdma_slots(carry, f, (2, 2), "zero", fuse=T,
                                          valid_hw=valid, col_mode=col_mode,
                                          **kw)
        return mesh.join_blocks(rdma.slot_blocks(carry, (2, 2)))

    before = stencil.launch_counts()
    got = run(overlap=True)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in stencil.launch_counts().items()}
    assert delta["rdma_tiled_region"] == 2 * 4 * 5
    assert delta["rdma_tiled_slot"] == delta["rdma_block_slot"] == 0
    assert torch.equal(got, run())


@pytest.mark.cuda
@pytest.mark.parametrize("grid_shape,late", [((2, 2), 0), ((4, 4), 5)])
@pytest.mark.parametrize("partitioned", [True, False])
@pytest.mark.parametrize("col_mode", ["packed", "strided"])
def test_rdma_slots_overlap_holds_under_skew(cuda_device, col_mode,
                                             partitioned, grid_shape, late):
    # The barrier test with the overlapped pipeline: a spin on slot
    # ``late`` before every chunk; its neighbours' interiors run ahead,
    # their bands wait for it, and the bytes do not move.  ~10 ms, not the
    # serialized test's 1 ms: the host may take longer than 1 ms to
    # enqueue a step of region launches, and a shorter spin would leave no
    # skew on the card.  On 2x2 every stream has a hardware queue of its
    # own (there are 8 by default), so no queue the streams share orders
    # the late slot before its diagonal, slot 3, and hides a missed wait.
    f = get_filter("blur3")
    R, C = grid_shape
    blocks = _grid_blocks(71, (R, C), (64, 64), "u8", cuda_device,
                          channels=1)
    valid = (R * 64 - 2, C * 64 - 3)

    def run(skew, **kw):
        carry = rdma.slot_carry(blocks, _slot_grid((R, C), cuda_device),
                                "zero", 4, col_mode)
        for T in (4, 1, 4, 4, 1, 1, 4, 4, 1, 4, 4, 4):
            if skew:
                with torch.cuda.stream(carry.run.streams[late]):
                    torch.cuda._sleep(20_000_000)
            carry = rdma.fused_rdma_slots(carry, f, (R, C), "zero", fuse=T,
                                          valid_hw=valid, col_mode=col_mode,
                                          **kw)
        return mesh.join_blocks(rdma.slot_blocks(carry, (R, C)))

    steady = run(False)
    assert torch.equal(run(True, overlap=True, partitioned=partitioned),
                       steady)


@pytest.mark.cuda
@pytest.mark.parametrize("col_mode", ["packed", "strided"])
def test_rdma_slots_overlap_across_cards(cuda_device, col_mode):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: slots on one card cannot show a "
                    "cross-card order")
    f = get_filter("blur3")
    R, C = 2, 4
    blocks = _grid_blocks(72, (R, C), (64, 64), "u8", cuda_device,
                          channels=1)
    valid = (R * 64 - 2, C * 64 - 3)
    grid = mesh.make_grid((R, C), devices=[f"cuda:{s % 2}"
                                           for s in range(R * C)])
    carry = rdma.slot_carry(mesh.split_blocks(mesh.join_blocks(blocks),
                                              grid),
                            grid, "zero", 2, col_mode)
    for _ in range(12):
        with torch.cuda.stream(carry.run.streams[1]):
            torch.cuda._sleep(2_000_000)
        carry = rdma.fused_rdma_slots(carry, f, (R, C), "zero", fuse=2,
                                      valid_hw=valid, col_mode=col_mode,
                                      overlap=True)
    got = mesh.join_blocks(rdma.slot_blocks(carry, (R, C)), cuda_device)
    want = rdma.stack_blocks(blocks, (R, C))
    for _ in range(12):
        want = rdma.rdma_block(want, f, (R, C), "zero", 2, valid)
    assert torch.equal(got, mesh.join_blocks(rdma.unstack_blocks(
        want, (R, C))))


@pytest.mark.cuda
def test_slot_naming_a_missing_card_raises(cuda_device):
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="does not have"):
        mesh.make_grid((1, 2), devices=["cuda:0", f"cuda:{n}"])
    grid = mesh.make_grid(devices="all")
    assert grid.slots == tuple(torch.device("cuda", k) for k in range(n))


@pytest.mark.cuda
@pytest.mark.parametrize("backend,storage,fuse", [
    ("cuda_rdma", "u8", 4), ("cuda_rdma", "bf16", 1), ("cuda", "f32", 1),
    ("cuda_sep", "bf16", 4), ("shifted", "f32", 2)])
def test_model_on_slots_matches_one_card(cuda_device, backend, storage,
                                         fuse):
    img = imageio.generate_test_image(157, 203, "rgb", seed=66)
    want = oracle.run_serial_u8(img, get_filter("blur3"), 9)
    for cm in ("packed", "strided"):
        model = ConvolutionModel("blur3", grid=_slot_grid((2, 3),
                                                          cuda_device),
                                 backend=backend, storage=storage,
                                 fuse=fuse, col_mode=cm)
        assert np.array_equal(model.run_image(img, 9), want)
        assert model.effective_col_mode == (
            cm if backend == "cuda_rdma" else "packed")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda_rdma", "cuda"])
def test_converge_on_slots_matches_one_card(cuda_device, backend):
    from parallel_convolution_tpu_torch.parallel import step

    x = torch.from_numpy(_mg_field((130, 170), 3))
    jacobi3 = get_filter("jacobi3")
    kw = dict(check_every=10, backend=backend, fuse=4)
    one, n1 = step.sharded_converge(
        x, jacobi3, 1e-3, 500, grid=mesh.make_grid((2, 2), cuda_device),
        **kw)
    for cm in ("packed", "strided"):
        got, n = step.sharded_converge(
            x, jacobi3, 1e-3, 500, grid=_slot_grid((2, 2), cuda_device),
            col_mode=cm, **kw)
        assert n == n1 and torch.equal(got, one)


# ------------------------------------------- item 10c: the rest on slots


@pytest.mark.cuda
@pytest.mark.parametrize("backend,col_mode,overlap", [
    ("cuda", None, False), ("cuda_rdma", "strided", False),
    ("cuda_rdma", "packed", False), ("cuda_rdma", "strided", True)])
def test_multigrid_on_slots_matches_one_card(cuda_device, backend, col_mode,
                                             overlap):
    from parallel_convolution_tpu_torch.solvers import multigrid as mg

    jacobi3 = get_filter("jacobi3")
    x = _mg_field((256, 256), 5)
    one, ores = mg.mg_converge(x, jacobi3, 1e-3, 2000,
                               grid=mesh.make_grid((2, 2), cuda_device),
                               backend=backend)
    slots = _slot_grid((2, 2), cuda_device)
    stencil.reset_launch_counts()
    got, res = mg.mg_converge(x, jacobi3, 1e-3, 2000, grid=slots,
                              backend=backend, col_mode=col_mode,
                              overlap=overlap)
    counts = stencil.launch_counts()
    levels = mg.plan_levels(slots, (256, 256), 1)
    assert [lv.grid.slots for lv in levels[1:]] == [
        slots.slots[:lv.grid.rows * lv.grid.cols] for lv in levels[1:]]
    per = mg.cycle_launches(levels, backend, 1, col_mode=res.col_mode,
                            overlap=res.overlap)
    assert counts == {k: v * res.cycles for k, v in per.items()}
    assert res.overlap is overlap and (
        backend != "cuda_rdma" or res.col_mode == col_mode)
    assert (res.cycles, res.residuals, res.level_grids) == (
        ores.cycles, ores.residuals, ores.level_grids)
    assert torch.equal(got, one)


@pytest.mark.cuda
def test_volumes_io_and_checkpoints_on_slots_match_one_card(cuda_device,
                                                            tmp_path):
    from parallel_convolution_tpu_torch.utils import checkpoint, sharded_io
    from parallel_convolution_tpu_torch.volumes import driver

    slots, one = _slot_grid((2, 2), cuda_device), mesh.make_grid(
        (2, 2), cuda_device)
    vol = np.random.default_rng(8).random((2, 16, 40, 36), dtype=np.float32)
    a = driver.volume_iterate(vol, "fd25", 4, grid=slots, fuse=2)
    assert torch.equal(a, driver.volume_iterate(vol, "fd25", 4, grid=one,
                                                fuse=2))
    img = imageio.generate_test_image(45, 61, "rgb", seed=9)
    src = tmp_path / "in.raw"
    imageio.write_raw(src, img)
    blur3 = get_filter("blur3")
    blocks = sharded_io.load_sharded(src, 45, 61, "rgb", slots)
    assert all(b.device == cuda_device or b.device.index == 0
               for row in blocks for b in row)
    out = checkpoint.run_checkpointed(blocks, blur3, 6, slots, (45, 61),
                                      tmp_path / "ck", 2, backend="cuda_rdma",
                                      col_mode="strided")
    dst = tmp_path / "out.raw"
    sharded_io.save_sharded(dst, out, 45, 61, "rgb")
    want = oracle.run_serial_u8(img, blur3, 6)
    np.testing.assert_array_equal(imageio.read_raw(dst, 45, 61, "rgb"), want)
    # Resumed from iteration 4 on another grid: the same bytes.
    again = checkpoint.run_checkpointed(None, blur3, 6, one, (45, 61),
                                        tmp_path / "ck", 2,
                                        backend="cuda_rdma")
    sharded_io.save_sharded(dst, again, 45, 61, "rgb")
    np.testing.assert_array_equal(imageio.read_raw(dst, 45, 61, "rgb"), want)


def _first_card() -> str:
    """The first visible card as ``CUDA_VISIBLE_DEVICES`` names it."""
    import os

    seen = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0].strip()
    return seen or "0"


@pytest.mark.cuda
@pytest.mark.parametrize("backend,storage,fuse", [("cuda", "f32", 1),
                                                  ("cuda_sep", "bf16", 4)])
def test_two_processes_share_the_card(cuda_device, tmp_path, backend,
                                      storage, fuse, monkeypatch):
    # Two spawned ranks, 2 slots of cuda:0 each, gloo between them: the
    # oracle's bytes, the resume bit-identical, both ranks launching.  The
    # ranks see the first card alone, so that they share it on a machine
    # with several.
    from parallel_convolution_tpu_torch.ops import _build
    from parallel_convolution_tpu_torch.utils import multihost_job

    _build.build_all()  # never two processes building at once
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", _first_card())
    rows = multihost_job.spawn(2, tmp_path, timeout=600, device="cuda",
                               rows=61, cols=75, mode="rgb", iters=9,
                               every=4, backend=backend, storage=storage,
                               fuse=fuse, group="gloo")
    want = oracle.run_serial_u8(
        imageio.generate_test_image(61, 75, "rgb", seed=3),
        get_filter("blur3"), 9)
    np.testing.assert_array_equal(
        imageio.read_raw(tmp_path / "out.raw", 61, 75, "rgb"), want)
    for rank, row in enumerate(rows):
        assert row["slots"] == "cuda:0,cuda:0,cuda:0,cuda:0"
        assert row["owners"] == [0, 0, 1, 1] and row["broadcast"] == 7.0
        assert row["resume_bitexact"] in ((True,) if storage != "bf16"
                                          else (None,))
        assert sum(row["launches"].values()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("backend,storage,fuse", [("cuda", "f32", 1),
                                                  ("cuda_sep", "bf16", 8)])
def test_device_trace_sees_the_kernels_at_their_launch_counts(
        cuda_device, tmp_path, backend, storage, fuse):
    from parallel_convolution_tpu_torch.utils import tracing

    img = imageio.generate_test_image(96, 130, "rgb", seed=3)
    model = ConvolutionModel("blur3", backend=backend, storage=storage,
                             fuse=fuse, device=cuda_device)
    model.run_image(img, 2)   # warm: the build and the launch plans
    stencil.reset_launch_counts()
    with tracing.device_trace(tmp_path) as tr:
        out = model.run_image(img, 20)
    counts = stencil.launch_counts()
    seen = tracing.kernel_counts(tr, ("stencil_step_kernel",
                                      "fused_iterate_kernel"))
    assert seen == {"stencil_step_kernel": counts["stencil_step"],
                    "fused_iterate_kernel": counts["fused_iterate"]}
    assert sum(seen.values()) > 0
    np.testing.assert_array_equal(
        out, oracle.run_serial_u8(img, get_filter("blur3"), 20))


@pytest.mark.cuda
def test_spans_on_the_card_open_a_slot_run_a_job(cuda_device, tmp_path):
    """The program's spans in a device trace of ``cuda_rdma`` jobs on 2x2
    slots of one card: ``rdma.open`` once a job (the run's set-up between
    slots), ``step.chunk`` once a chunk; ``rdma.close`` only over several
    processes (one process's run has nothing to unmap)."""
    from parallel_convolution_tpu_torch.parallel import step
    from parallel_convolution_tpu_torch.utils import tracing

    img = imageio.generate_test_image(96, 130, "rgb", seed=5)
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))
    grid = mesh.make_grid((2, 2), devices=["cuda:0"] * 4)
    blocks, valid_hw, _ = step._prepare(x, grid, "u8")
    kw = dict(quantize=True, backend="cuda_rdma", fuse=4)
    filt = get_filter("blur3")
    step.iterate_prepared(blocks, filt, 8, grid, valid_hw, **kw)  # warm
    with tracing.device_trace(tmp_path) as tr:
        for _ in range(2):
            step.iterate_prepared(blocks, filt, 8, grid, valid_hw, **kw)
    names = [e.get("name") for e in tr.events()
             if e.get("cat") == "user_annotation"]
    assert names.count("pctpu.rdma.open") == 2
    assert names.count("pctpu.step.chunk") == 2 * 2
    assert names.count("pctpu.step.carry_out") == 2
    assert "pctpu.rdma.close" not in names


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [["--n", "8"], ["--converge", "--n", "8"]],
                         ids=["iterate", "converge"])
def test_soak_rows_all_ok_on_the_card(cuda_device, capsys, argv):
    """The randomized soak on the card: eight sampled configurations
    (backends, storages, boundaries, grids of slots, fuses, tiles) at
    awkward sizes, every one the oracle's bytes (float mode: ``shifted``'s
    bits where every tap is a power of two, its FMA tolerance elsewhere),
    with kernels launched."""
    import json

    from parallel_convolution_tpu_torch import soak

    stencil.reset_launch_counts()
    assert soak.main([*argv, "--seed", "0"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    summary = rows.pop()
    assert summary["failures"] == 0 and summary["device"].startswith("cuda")
    assert len(rows) == 8 and all(r["ok"] for r in rows)
    assert sum(stencil.launch_counts().values()) > 0


# ------------------- a grid over processes (items 10d-i and 10d-ii-a)

# K3 (grey u8 fuse 4: 32x40 blocks fit one CUDA block's shared memory) and
# K4 (RGB bf16 fuse 8: 300x320 blocks do not), each transport, overlap off
# and on, on 2x2 slots over two ranks sharing cuda:0.
CROSS_CASES = [("k3", 64, 80, "grey", "u8", 4), ("k4", 600, 640, "rgb",
                                                 "bf16", 8)]
CROSS_ITERS = 9


class _Raw:
    """A card address as a tensor's memory (``torch.as_tensor`` of it), to
    read a neighbour's mapped buffer."""

    def __init__(self, ptr: int, n: int, typestr: str):
        self.__cuda_array_interface__ = {"shape": (n,), "typestr": typestr,
                                         "data": (int(ptr), False),
                                         "version": 3}


def _cross_checks(rank: int, port: int) -> dict:
    import time

    from parallel_convolution_tpu_torch.parallel import multihost, step

    # Two ranks sharing cuda:0 mean gloo: NCCL refuses that.
    multihost.initialize(f"localhost:{port}", num_processes=2,
                         process_id=rank, backend="gloo")
    dev = torch.device("cuda", 0)
    row = {}
    # An IPC map of a sub-allocated tensor: the slice starts 12345
    # elements into its allocation.
    big = torch.arange(1 << 20, dtype=torch.int32, device=dev) + rank * 7
    part = big[12345:]
    handle, offset = rdma.ipc_handle(part)
    theirs = multihost.gather_object((handle, offset))[1 - rank]
    base = rdma._ipc_map(theirs[0], dev)
    seen = torch.as_tensor(_Raw(base + theirs[1], part.numel(), "<i4"),
                           device=dev)
    want = torch.arange(12345, 1 << 20, dtype=torch.int32) + (1 - rank) * 7
    row["ipc"] = (offset, theirs[1], torch.equal(seen.cpu(), want))
    del seen
    torch.cuda.synchronize(dev)
    multihost.barrier("read")
    rdma._ipc_unmap(theirs[0], dev)
    multihost.barrier("unmapped")
    grid = mesh.make_grid((2, 2), devices="all")
    row["owners"] = grid.owners
    for name, h, w, mode, storage, fuse in CROSS_CASES:
        x = imageio.interleaved_to_planar(imageio.generate_test_image(
            h, w, mode, seed=11)).astype(np.float32)
        for cm in ("strided", "packed"):
            for ov in (False, True):
                stencil.reset_launch_counts()
                out = step.sharded_iterate(
                    x, get_filter("blur3"), CROSS_ITERS, grid=grid,
                    backend="cuda_rdma", storage=storage, fuse=fuse,
                    col_mode=cm, overlap=ov)
                row[name, cm, ov] = (out.cpu().numpy(),
                                     stencil.launch_counts())
    row["maps_after_iterate"] = len(rdma._IPC_MAPS)
    # The V-cycle's level runs end with the solve; a programs cache keeps
    # them (and their maps) until close_programs.
    from parallel_convolution_tpu_torch.solvers import multigrid

    jacobi3 = get_filter("jacobi3")
    out, res = multigrid.mg_converge(_mg_field((96, 80), 2), jacobi3, 1e-3,
                                     30, grid=grid, backend="cuda_rdma")
    row["mg"] = (out.cpu().numpy(), res.cycles)
    row["maps_after_mg"] = len(rdma._IPC_MAPS)
    programs = {}
    for _ in range(2):
        last = list(multigrid.mg_converge_stream(
            _mg_field((96, 80), 2), jacobi3, 1e-3, 30, grid=grid,
            backend="cuda_rdma", programs=programs))[-1]
    row["mg_stream"] = last[0]
    row["maps_kept"] = len(rdma._IPC_MAPS)
    multigrid.close_programs(programs)
    row["maps_after_close"] = len(rdma._IPC_MAPS)
    # The skew check: rank 1's host sleeps 50 ms before each of its first
    # chunks, so rank 0's launches run ahead and wait on the counters.
    real = rdma._slots_step
    calls = [0]

    def late(*a, **kw):
        calls[0] += 1
        if rank == 1 and calls[0] <= 4:
            time.sleep(0.05)
        return real(*a, **kw)

    rdma._slots_step = late
    x = imageio.interleaved_to_planar(imageio.generate_test_image(
        64, 80, "grey", seed=11)).astype(np.float32)
    out = step.sharded_iterate(x, get_filter("blur3"), CROSS_ITERS,
                               grid=grid, backend="cuda_rdma", storage="u8",
                               fuse=2, col_mode="packed")
    rdma._slots_step = real
    row["skew"] = out.cpu().numpy()
    row.update(_far_checks(rank, grid))
    multihost.barrier("done")
    return row


class _Exchanges:
    """Every ``rdma._FarExchange`` made while installed, and the IPC maps
    opened (the mirror path and the in-place path, told apart)."""

    def __init__(self):
        self.made, self.maps = [], 0
        self._init, self._map = rdma._FarExchange.__init__, rdma._ipc_map

    def __enter__(self):
        made, init, ipc_map = self.made, self._init, self._map

        def init_(ex, *a, **k):
            init(ex, *a, **k)
            made.append(ex)

        def map_(*a, **k):
            self.maps += 1
            return ipc_map(*a, **k)

        rdma._FarExchange.__init__, rdma._ipc_map = init_, map_
        return self

    def __exit__(self, *exc):
        rdma._FarExchange.__init__, rdma._ipc_map = self._init, self._map

    def rounds(self, rnd: int) -> int:
        return sum(t["round"] == rnd for ex in self.made for t in ex.times)


def _far_checks(rank: int, grid) -> dict:
    """Item 10d-ii-a on the two ranks: each reports a host of its own, so
    it reads the other's slots from mirrors gloo fills once a chunk; then
    a failed IPC map between ranks of one host, which raises."""
    from parallel_convolution_tpu_torch.parallel import multihost, step
    from parallel_convolution_tpu_torch.solvers import multigrid

    row = {}
    real = multihost.hostname
    multihost.hostname = lambda: f"host{rank}"
    try:
        for name, h, w, mode, storage, fuse in CROSS_CASES:
            x = imageio.interleaved_to_planar(imageio.generate_test_image(
                h, w, mode, seed=11)).astype(np.float32)
            for cm in ("strided", "packed"):
                for ov in (False, True):
                    stencil.reset_launch_counts()
                    with _Exchanges() as ex:
                        out = step.sharded_iterate(
                            x, get_filter("blur3"), CROSS_ITERS, grid=grid,
                            backend="cuda_rdma", storage=storage, fuse=fuse,
                            col_mode=cm, overlap=ov)
                    row["far", name, cm, ov] = (
                        out.cpu().numpy(), stencil.launch_counts(),
                        ex.rounds(0), ex.rounds(1), ex.maps)
        with _Exchanges() as ex:
            out, res = multigrid.mg_converge(
                _mg_field((96, 80), 2), get_filter("jacobi3"), 1e-3, 30,
                grid=grid, backend="cuda_rdma")
        row["far_mg"] = (out.cpu().numpy(), res.cycles, len(ex.made),
                         all(not e.mirrors and not e.stages
                             for e in ex.made), len(rdma._IPC_MAPS))
    finally:
        multihost.hostname = real
    # One host again, and its IPC map fails: the run raises on both ranks
    # and no mirror is made in its place.
    real_map = rdma._ipc_map

    def refused(handle, device):
        rdma._cu_check(1, f"mapping a neighbour's memory on {device}")

    rdma._ipc_map = refused
    try:
        with _Exchanges() as ex:
            step.sharded_iterate(
                np.zeros((1, 64, 80), np.float32), get_filter("blur3"), 2,
                grid=grid, backend="cuda_rdma", storage="u8", fuse=2)
        row["map_refused"] = ("", len(ex.made))
    except RuntimeError as e:
        row["map_refused"] = (str(e), len(ex.made))
    finally:
        rdma._ipc_map = real_map
    return row


def _cross_worker(rank: int, port: int, results) -> None:
    import torch.distributed as dist

    try:
        results[rank] = _cross_checks(rank, port)
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        results[rank] = {"error": f"{type(e).__name__}: {e}"}
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def cross_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    import torch.multiprocessing as mp

    from parallel_convolution_tpu_torch.ops import _build
    from parallel_convolution_tpu_torch.utils import multihost_job

    _build.build_all()  # never two processes building at once
    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager, pytest.MonkeyPatch.context() as mp_env:
        results = manager.dict()
        port = multihost_job.free_port()
        procs = [ctx.Process(target=_cross_worker,
                             args=(r, port, results)) for r in range(2)]
        # The ranks share one card, whatever the machine has.
        mp_env.setenv("CUDA_VISIBLE_DEVICES", _first_card())
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        for p in procs:
            if p.is_alive():
                p.kill()
        got = {r: dict(results.get(r, {"error": "no result"}))
               for r in range(2)}
        assert [p.exitcode for p in procs] == [0, 0], got
    return got


@pytest.mark.cuda
def test_ipc_map_of_a_sub_allocated_tensor(cross_ranks):
    for r in (0, 1):
        mine, theirs, equal = cross_ranks[r]["ipc"]
        # The caching allocator sub-allocates: the offset is not 0.
        assert mine == theirs == 12345 * 4 or (mine % 4 == 0 and mine > 0)
        assert equal


@pytest.mark.cuda
@pytest.mark.parametrize("case", CROSS_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("col_mode", ["strided", "packed"])
@pytest.mark.parametrize("overlap", [False, True])
def test_rdma_slots_across_two_ranks_are_the_plain_version(
        cross_ranks, case, col_mode, overlap, monkeypatch):
    from parallel_convolution_tpu_torch.parallel import step

    name, h, w, mode, storage, fuse = case
    x = imageio.interleaved_to_planar(imageio.generate_test_image(
        h, w, mode, seed=11)).astype(np.float32)
    monkeypatch.setenv(step.OVERLAP_INTERPRET_ENV, "1")
    plain = step.sharded_iterate(
        x, get_filter("blur3"), CROSS_ITERS,
        grid=mesh.make_grid((2, 2), devices="cpu,cpu,cpu,cpu"),
        backend="cuda_rdma", storage=storage, fuse=fuse, col_mode=col_mode,
        overlap=overlap).numpy()
    kernel = ("rdma_block" if name == "k3" else "rdma_tiled") + (
        "_region" if overlap else "_slot")
    chunks = -(-CROSS_ITERS // fuse)
    regions = 5 if overlap else 1
    for r in (0, 1):
        out, counts = cross_ranks[r][name, col_mode, overlap]
        np.testing.assert_array_equal(out, plain)  # quantize: bit for bit
        # Each rank launches its own two slots, every chunk.
        assert counts[kernel] == 2 * chunks * regions
        assert (counts["rdma_pack"] > 0) == (col_mode == "packed")


@pytest.mark.cuda
def test_counter_barrier_under_skew(cross_ranks):
    from parallel_convolution_tpu_torch.parallel import step

    x = imageio.interleaved_to_planar(imageio.generate_test_image(
        64, 80, "grey", seed=11)).astype(np.float32)
    want = imageio.interleaved_to_planar(oracle.run_serial_u8(
        imageio.generate_test_image(64, 80, "grey", seed=11),
        get_filter("blur3"), CROSS_ITERS)).astype(np.float32)
    for r in (0, 1):
        np.testing.assert_array_equal(cross_ranks[r]["skew"], want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CROSS_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("col_mode", ["strided", "packed"])
@pytest.mark.parametrize("overlap", [False, True])
def test_rdma_slots_between_two_hosts_are_the_plain_version(
        cross_ranks, case, col_mode, overlap, monkeypatch):
    # The ranks report two hosts: the other rank's slots are read from
    # mirrors, one exchange round a chunk (no IPC map), and the bytes are
    # the plain version's.
    from parallel_convolution_tpu_torch.parallel import step

    name, h, w, mode, storage, fuse = case
    x = imageio.interleaved_to_planar(imageio.generate_test_image(
        h, w, mode, seed=11)).astype(np.float32)
    monkeypatch.setenv(step.OVERLAP_INTERPRET_ENV, "1")
    plain = step.sharded_iterate(
        x, get_filter("blur3"), CROSS_ITERS,
        grid=mesh.make_grid((2, 2), devices="cpu,cpu,cpu,cpu"),
        backend="cuda_rdma", storage=storage, fuse=fuse, col_mode=col_mode,
        overlap=overlap).numpy()
    kernel = ("rdma_block" if name == "k3" else "rdma_tiled") + (
        "_region" if overlap else "_slot")
    chunks = -(-CROSS_ITERS // fuse)
    for r in (0, 1):
        out, counts, rounds, stage_rounds, maps = cross_ranks[r][
            "far", name, col_mode, overlap]
        np.testing.assert_array_equal(out, plain)
        assert counts[kernel] == 2 * chunks * (5 if overlap else 1)
        # The ranks split the grid's rows: no far column neighbour, so no
        # staging round; the probe's run adds none (no fallback).
        assert (rounds, stage_rounds, maps) == (chunks, 0, 0)


@pytest.mark.cuda
def test_failed_ipc_map_raises_and_no_mirror_serves_it(cross_ranks):
    for r in (0, 1):
        msg, mirrors = cross_ranks[r]["map_refused"]
        assert "CUDA IPC" in msg and "no host-staged" in msg
        assert mirrors == 0


@pytest.mark.cuda
def test_multigrid_between_two_hosts_frees_its_mirrors(cross_ranks):
    want, res = multigrid_one_card()
    for r in (0, 1):
        out, cycles, runs, freed, maps = cross_ranks[r]["far_mg"]
        assert cycles == res.cycles
        np.testing.assert_array_equal(out, want)
        assert runs > 0 and freed and maps == 0


def multigrid_one_card():
    from parallel_convolution_tpu_torch.solvers import multigrid

    want, res = multigrid.mg_converge(
        _mg_field((96, 80), 2), get_filter("jacobi3"), 1e-3, 30,
        grid=mesh.make_grid((2, 2), devices=["cuda:0"] * 4),
        backend="cuda_rdma")
    return want.cpu().numpy(), res


# Four ranks, one slot each at 2x2, on two reported hosts: rows (hosts
# {0, 0, 1, 1}: the column neighbours through CUDA IPC, the rows and
# corners from mirrors) and columns ({0, 1, 0, 1}: the other way round,
# packed with a staging round), zero and periodic.
FOUR_HOSTS = {"rows": (0, 0, 1, 1), "cols": (0, 1, 0, 1)}
FOUR_CASES = [(cm, ov, b) for cm in ("strided", "packed")
              for ov in (False, True) for b in ("zero", "periodic")]
FOUR_FUSE = 4


def _four_img():
    return imageio.interleaved_to_planar(imageio.generate_test_image(
        64, 80, "grey", seed=13)).astype(np.float32)


def _four_checks(rank: int, port: int) -> dict:
    from parallel_convolution_tpu_torch.parallel import multihost, step

    multihost.initialize(f"localhost:{port}", num_processes=4,
                         process_id=rank, backend="gloo")
    grid = mesh.make_grid((2, 2), devices="all")
    row = {"owners": grid.owners}
    real = multihost.hostname
    try:
        for label, hosts in FOUR_HOSTS.items():
            multihost.hostname = lambda: f"host{hosts[rank]}"
            for cm, ov, b in FOUR_CASES:
                with _Exchanges() as ex:
                    out = step.sharded_iterate(
                        _four_img(), get_filter("blur3"), CROSS_ITERS,
                        grid=grid, backend="cuda_rdma", storage="u8",
                        fuse=FOUR_FUSE, col_mode=cm, overlap=ov, boundary=b)
                row[label, cm, ov, b] = (out.cpu().numpy(), ex.rounds(0),
                                         ex.rounds(1), ex.maps)
    finally:
        multihost.hostname = real
    multihost.barrier("done")
    return row


def _four_worker(rank: int, port: int, results) -> None:
    import torch.distributed as dist

    try:
        results[rank] = _four_checks(rank, port)
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        results[rank] = {"error": f"{type(e).__name__}: {e}"}
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    import torch.multiprocessing as mp

    from parallel_convolution_tpu_torch.ops import _build
    from parallel_convolution_tpu_torch.utils import multihost_job

    _build.build_all()
    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager, pytest.MonkeyPatch.context() as mp_env:
        results = manager.dict()
        port = multihost_job.free_port()
        procs = [ctx.Process(target=_four_worker,
                             args=(r, port, results)) for r in range(4)]
        # The ranks share one card, whatever the machine has.
        mp_env.setenv("CUDA_VISIBLE_DEVICES", _first_card())
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        for p in procs:
            if p.is_alive():
                p.kill()
        got = {r: dict(results.get(r, {"error": "no result"}))
               for r in range(4)}
        assert [p.exitcode for p in procs] == [0] * 4, got
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("hosts", sorted(FOUR_HOSTS))
@pytest.mark.parametrize("col_mode,overlap,boundary", FOUR_CASES)
def test_four_ranks_on_two_hosts_mix_ipc_and_mirrors(
        four_ranks, hosts, col_mode, overlap, boundary, monkeypatch):
    from parallel_convolution_tpu_torch.parallel import step

    monkeypatch.setenv(step.OVERLAP_INTERPRET_ENV, "1")
    plain = step.sharded_iterate(
        _four_img(), get_filter("blur3"), CROSS_ITERS,
        grid=mesh.make_grid((2, 2), devices="cpu,cpu,cpu,cpu"),
        backend="cuda_rdma", storage="u8", fuse=FOUR_FUSE,
        col_mode=col_mode, overlap=overlap, boundary=boundary).numpy()
    chunks = -(-CROSS_ITERS // FOUR_FUSE)
    for r in range(4):
        assert four_ranks[r]["owners"] == (0, 1, 2, 3)
        out, rounds, stage_rounds, maps = four_ranks[r][
            hosts, col_mode, overlap, boundary]
        np.testing.assert_array_equal(out, plain)
        # Each rank maps its neighbour on its own host and mirrors the two
        # on the other: one round a chunk, a staging round too where the
        # far neighbours are its column neighbours (packed).
        assert maps > 0 and rounds == chunks
        assert stage_rounds == (chunks if hosts == "cols"
                                and col_mode == "packed" else 0)


@pytest.mark.cuda
def test_multigrid_across_two_ranks_closes_its_runs(cross_ranks):
    from parallel_convolution_tpu_torch.solvers import multigrid

    # jacobi3's taps and the transfers' weights are dyadic: bit for bit.
    want, res = multigrid.mg_converge(
        _mg_field((96, 80), 2), get_filter("jacobi3"), 1e-3, 30,
        grid=mesh.make_grid((2, 2), devices=["cuda:0"] * 4),
        backend="cuda_rdma")
    want = want.cpu().numpy()
    for r in (0, 1):
        row = cross_ranks[r]
        out, cycles = row["mg"]
        assert cycles == res.cycles
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(row["mg_stream"], want)
        # No neighbour's buffer stays mapped once a run is closed.
        assert row["maps_after_iterate"] == row["maps_after_mg"] == 0
        assert row["maps_kept"] > 0 and row["maps_after_close"] == 0


# ------------------- one card a process (item 10d-ii-b): NCCL between cards

def _need_cards(n: int) -> None:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        pytest.skip(f"needs {n} cards ({have} visible): NCCL refuses two "
                    "ranks on one card")


def _spawn_ranks(target, n: int, timeout: float = 600.0) -> dict:
    """``target(rank, port, results)`` in ``n`` spawned ranks (the kernels
    built first); every rank's row."""
    import torch.multiprocessing as mp

    from parallel_convolution_tpu_torch.ops import _build
    from parallel_convolution_tpu_torch.utils import multihost_job

    _build.build_all()  # never two processes building at once
    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager:
        results = manager.dict()
        port = multihost_job.free_port()
        procs = [ctx.Process(target=target, args=(r, port, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
        got = {r: dict(results.get(r, {"error": "no result"}))
               for r in range(n)}
        assert [p.exitcode for p in procs] == [0] * n, got
    return got


def _run_rank(checks, rank: int, port: int, results) -> None:
    import torch.distributed as dist

    try:
        results[rank] = checks(rank, port)
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        results[rank] = {"error": f"{type(e).__name__}: {e}"}
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _no_host_staging(multihost) -> None:
    """Make any host staging of a slab raise in this rank."""
    def refuse(*a, **k):
        raise AssertionError("a slab staged through host memory under NCCL")

    multihost._to_host = multihost._host_buffer = refuse
    multihost.HostStaging._alloc = refuse


def _nccl_swap_checks(rank: int, port: int) -> dict:
    from parallel_convolution_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", num_processes=2,
                         process_id=rank)
    _no_host_staging(multihost)
    dev = multihost.card()
    row = {"backend": multihost.backend(),
           "transport": multihost.transport(), "card": str(dev)}
    peer = 1 - rank
    # Three slabs each way, posted in different orders on the two sides;
    # one lands in a view that is not contiguous.
    slabs = [torch.full((3, 5 + k, 7), 10 * rank + k, dtype=torch.bfloat16,
                        device=dev) for k in range(3)]
    frame = torch.zeros((3, 10, 20), dtype=torch.bfloat16, device=dev)
    outs = [torch.empty((3, 5, 7), dtype=torch.bfloat16, device=dev),
            frame[:, 2:8, 3:10],
            torch.empty((3, 7, 7), dtype=torch.bfloat16, device=dev)]
    multihost.swap([(peer, k, slabs[k]) for k in (2, 0, 1)],
                   [(peer, k, outs[k]) for k in (1, 2, 0)])
    torch.cuda.synchronize(dev)
    row["swap"] = [o.float().unique().tolist() for o in outs]
    row["frame_rest"] = float(frame.float().sum() - frame[:, 2:8, 3:10]
                              .float().sum())
    nan = torch.tensor(float("nan") if rank else 1.0, device=dev)
    got = multihost.all_max(nan)
    row["all_max_nan"] = (str(got.device), bool(torch.isnan(got)))
    got = multihost.all_max(torch.tensor(float(rank + 1), device=dev))
    row["all_max"] = (str(got.device), float(got))
    blocks = [[torch.full((1, 2, 3), float(k), device=dev) if k == rank
               else None for k in range(2)]]
    full = multihost.fill_blocks(blocks, (0, 1))
    row["fill"] = [(str(b.device), b.unique().tolist()) for b in full[0]]
    multihost.barrier("done")
    return row


def _nccl_swap_worker(rank, port, results):
    _run_rank(_nccl_swap_checks, rank, port, results)


@pytest.mark.cuda
def test_nccl_swap_keeps_the_slabs_on_the_cards():
    # One card a process: the group is NCCL (the default), each rank on
    # its own card, and the swap, the diff's reduction and fill_blocks
    # move card tensors, never staged through the host; the slabs land
    # in their own outputs, a view that is not contiguous included.
    _need_cards(2)
    got = _spawn_ranks(_nccl_swap_worker, 2)
    for r in (0, 1):
        row = got[r]
        assert (row["backend"], row["transport"], row["card"]) == (
            "nccl", "device", f"cuda:{r}")
        assert row["swap"] == [[10.0 * (1 - r) + k] for k in range(3)]
        assert row["frame_rest"] == 0.0
        assert row["all_max_nan"] == (f"cuda:{r}", True)
        assert row["all_max"] == (f"cuda:{r}", 2.0)
        assert row["fill"] == [(f"cuda:{r}", [0.0]), (f"cuda:{r}", [1.0])]


def _counter_checks(rank: int, port: int) -> dict:
    """A card's buffer and step counter mapped by a rank on another card,
    and that rank's stream waiting on the counter through the peer map, as
    ``cuda_rdma``'s barrier between cards does: rank 1 writes its buffer
    0.3 s late, then its counter; rank 0's stream waits, then copies the
    mapped buffer."""
    import ctypes
    import time

    from parallel_convolution_tpu_torch.ops import _build
    from parallel_convolution_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", num_processes=2,
                         process_id=rank)
    dev = multihost.card()
    lib = _build.load_library("rdma")
    cuda = ctypes.CDLL("libcuda.so.1")
    n = 1 << 16
    buf = torch.zeros(n, dtype=torch.int32, device=dev)
    counters = torch.zeros(2, dtype=torch.int64, device=dev)
    torch.cuda.synchronize(dev)
    mine = (rdma.ipc_handle(buf), rdma.ipc_handle(counters),
            multihost.card_uuid(dev))
    theirs = multihost.gather_object(mine)[1 - rank]
    row = {"cards_differ": theirs[2] != mine[2]}
    pbuf = rdma._ipc_map(theirs[0][0], dev) + theirs[0][1]
    pctr = rdma._ipc_map(theirs[1][0], dev) + theirs[1][1]
    st = torch.cuda.Stream(dev)
    for step in (1, 2):
        multihost.barrier(f"step {step}")
        if rank == 1:
            time.sleep(0.3)
            with torch.cuda.stream(st):
                buf.fill_(100 * step)
            row[step] = lib.pc_counter_write(counters.data_ptr(), step,
                                             st.cuda_stream)
            st.synchronize()
        else:
            got = torch.empty(n, dtype=torch.int32, device=dev)
            t0 = time.perf_counter()
            err = lib.pc_counter_wait(pctr, step, st.cuda_stream)
            copied = cuda.cuMemcpyDtoDAsync_v2(
                ctypes.c_uint64(got.data_ptr()), ctypes.c_uint64(pbuf),
                ctypes.c_size_t(4 * n), ctypes.c_void_p(st.cuda_stream))
            st.synchronize()
            row[step] = (err, copied, int(got.min()), int(got.max()),
                         time.perf_counter() - t0)
        multihost.barrier(f"step {step} done")
    torch.cuda.synchronize(dev)
    rdma._ipc_unmap(theirs[0][0], dev)
    rdma._ipc_unmap(theirs[1][0], dev)
    multihost.barrier("unmapped")
    return row


def _counter_worker(rank, port, results):
    _run_rank(_counter_checks, rank, port, results)


@pytest.mark.cuda
def test_counter_wait_across_cards():
    # A rank on another card maps this card's memory (CUDA IPC with peer
    # access) and its stream waits on the step counter there before
    # reading it: each copy sees the value written 0.3 s late, so the wait
    # held, step after step.
    _need_cards(2)
    got = _spawn_ranks(_counter_worker, 2, timeout=300)
    assert got[0]["cards_differ"] and got[1]["cards_differ"]
    for step in (1, 2):
        assert got[1][step] == 0
        err, copied, lo, hi, waited = got[0][step]
        assert (err, copied, lo, hi) == (0, 0, 100 * step, 100 * step)
        assert waited > 0.1


# Four ranks on four cards, one slot each at 2x2 and four at 4x4: the
# in-place reads between cards (on one host) and the mirrors NCCL fills
# (the ranks reporting two hosts, FOUR_HOSTS' layouts).
CARD_CASES = [(cm, ov) for cm in ("strided", "packed") for ov in (False, True)]


def _card_checks(rank: int, port: int) -> dict:
    from parallel_convolution_tpu_torch.parallel import multihost, step

    multihost.initialize(f"localhost:{port}", num_processes=4,
                         process_id=rank)
    _no_host_staging(multihost)
    grid = mesh.make_grid((2, 2), devices="all")
    grid16 = mesh.make_grid((4, 4), devices="all")
    row = {"backend": multihost.backend(), "owners": grid.owners,
           "slots": grid.slot_map(), "slots16": grid16.slot_map()}
    real = multihost.hostname
    try:
        for hosts in (None, *sorted(FOUR_HOSTS)):
            if hosts is not None:
                layout = FOUR_HOSTS[hosts]
                multihost.hostname = lambda: f"host{layout[rank]}"
            for cm, ov in CARD_CASES:
                with _Exchanges() as ex:
                    out = step.sharded_iterate(
                        _four_img(), get_filter("blur3"), CROSS_ITERS,
                        grid=grid, backend="cuda_rdma", storage="u8",
                        fuse=FOUR_FUSE, col_mode=cm, overlap=ov)
                split = [t for e in ex.made for t in e.split()]
                row[hosts, cm, ov] = (
                    out.cpu().numpy(), ex.rounds(0), ex.rounds(1), ex.maps,
                    sorted({k for t in split for k in t}))
            multihost.hostname = real
        out = step.sharded_iterate(
            _four_img(), get_filter("blur3"), CROSS_ITERS, grid=grid16,
            backend="cuda_rdma", storage="u8", fuse=FOUR_FUSE,
            col_mode="packed")
        row["4x4"] = out.cpu().numpy()
        # A converge: the diff reduced on the cards (NaN-flagged MAX).
        out, iters = step.sharded_converge(
            _four_img(), get_filter("blur3"), 0.5, 60, check_every=4,
            grid=grid, backend="cuda_rdma", quantize=True, storage="u8",
            fuse=FOUR_FUSE)
        row["converge"] = (out.cpu().numpy(), iters)
    finally:
        multihost.hostname = real
    multihost.barrier("done")
    return row


def _card_worker(rank, port, results):
    _run_rank(_card_checks, rank, port, results)


@pytest.fixture(scope="module")
def card_ranks():
    _need_cards(4)
    return _spawn_ranks(_card_worker, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("hosts", [None, *sorted(FOUR_HOSTS)])
@pytest.mark.parametrize("col_mode,overlap", CARD_CASES)
def test_cuda_rdma_four_ranks_on_four_cards_is_one_process(
        card_ranks, hosts, col_mode, overlap):
    # Each rank on its own card reads its neighbours on the other cards in
    # place (one host) or from mirrors that NCCL fills card to card (two
    # reported hosts): one process's bytes, with no slab staged through
    # the host; the far rounds are timed on the card (nccl_ms).
    from parallel_convolution_tpu_torch.parallel import step

    want = step.sharded_iterate(
        _four_img(), get_filter("blur3"), CROSS_ITERS,
        grid=mesh.make_grid((2, 2), devices=["cuda:0"] * 4),
        backend="cuda_rdma", storage="u8", fuse=FOUR_FUSE, col_mode=col_mode,
        overlap=overlap).cpu().numpy()
    chunks = -(-CROSS_ITERS // FOUR_FUSE)
    for r in range(4):
        row = card_ranks[r]
        assert row["backend"] == "nccl" and row["owners"] == (0, 1, 2, 3)
        assert row["slots"] == "cuda:0,cuda:1,cuda:2,cuda:3"
        out, rounds, stage_rounds, maps, keys = row[hosts, col_mode,
                                                    overlap]
        np.testing.assert_array_equal(out, want)
        assert maps > 0
        if hosts is None:
            assert rounds == stage_rounds == 0
        else:
            assert rounds == chunks and "nccl_ms" in keys
            assert stage_rounds == (chunks if hosts == "cols"
                                    and col_mode == "packed" else 0)


@pytest.mark.cuda
def test_cuda_rdma_four_by_four_and_converge_on_four_cards(card_ranks):
    from parallel_convolution_tpu_torch.parallel import step

    want = step.sharded_iterate(
        _four_img(), get_filter("blur3"), CROSS_ITERS,
        grid=mesh.make_grid((4, 4), devices=["cuda:0"] * 16),
        backend="cuda_rdma", storage="u8", fuse=FOUR_FUSE,
        col_mode="packed").cpu().numpy()
    conv, iters = step.sharded_converge(
        _four_img(), get_filter("blur3"), 0.5, 60, check_every=4,
        grid=mesh.make_grid((2, 2), devices=["cuda:0"] * 4),
        backend="cuda_rdma", quantize=True, storage="u8", fuse=FOUR_FUSE)
    for r in range(4):
        assert card_ranks[r]["slots16"] == ",".join(
            f"cuda:{s // 4}" for s in range(16))
        np.testing.assert_array_equal(card_ranks[r]["4x4"], want)
        out, done = card_ranks[r]["converge"]
        assert done == iters
        np.testing.assert_array_equal(out, conv.cpu().numpy())
