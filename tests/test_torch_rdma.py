"""The port's ``cuda_rdma`` backend (ops/rdma.py, parallel/channels.py)
against the JAX package's ``pallas_rdma``, on the CPU.

Same seeded images through both: the JAX package runs its RDMA kernels in
TPU interpret mode on the forced 8-device CPU mesh; the port runs the plain
version (halo exchange + K2's plain levels) on ``make_grid(shape, "cpu")``.
u8 (quantize) mode must give the same bytes as JAX and the NumPy oracle;
float mode agrees with the float oracle exactly on the plain path and with
JAX within ``stencil.float_tolerance`` (FMA contraction there).  K3 and K4
themselves run on the card (tests/test_torch_kernels_cuda.py).
"""

import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.ops import pallas_rdma as jrdma
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.parallel import step as jstep
from parallel_convolution_tpu.utils.jax_compat import shard_map
from parallel_convolution_tpu_torch import convert
from parallel_convolution_tpu_torch.cli import main as cli_main
from parallel_convolution_tpu_torch.models import ConvolutionModel
from parallel_convolution_tpu_torch.ops import oracle, rdma, stencil
from parallel_convolution_tpu_torch.parallel import channels, halo, mesh, step
from parallel_convolution_tpu_torch.utils import imageio


def _jax_mesh(shape):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _filters(name):
    jf = jfilters.get_filter(name)
    return jf, convert.filter_from_numpy(jf.name, jf.taps, jf.dyadic)


def _image(boundary, mode, seed):
    # zero: a shape no grid divides (pad + re-mask); periodic needs
    # dimensions every grid under test divides.
    rows, cols = (37, 53) if boundary == "zero" else (24, 36)
    return imageio.generate_test_image(rows, cols, mode, seed=seed)


# (grid, storage, boundary, fuse, filter, mode); 5 iterations, so fuse 2
# runs two chunks and a tail of 1, fuse 3 one chunk and a tail of 2.
CASES = [
    ((1, 1), "f32", "zero", 1, "blur3", "grey"),
    ((2, 2), "u8", "zero", 2, "gaussian5", "rgb"),
    ((1, 4), "bf16", "periodic", 3, "blur3", "grey"),
    ((4, 1), "u8", "periodic", 2, "edge5", "grey"),
    ((2, 2), "bf16", "zero", 3, "edge5", "grey"),
    ((4, 1), "f32", "zero", 1, "blur3", "rgb"),
    ((1, 4), "u8", "zero", 2, "blur3", "grey"),
    ((2, 2), "f32", "periodic", 1, "gaussian5", "grey"),
]


@pytest.mark.parametrize("grid_shape,storage,boundary,fuse,name,mode", CASES)
def test_cuda_rdma_matches_pallas_rdma_and_oracle(grid_shape, storage,
                                                  boundary, fuse, name, mode):
    iters = 5
    jf, tf = _filters(name)
    img = _image(boundary, mode, seed=CASES.index(
        (grid_shape, storage, boundary, fuse, name, mode)))
    x = imageio.interleaved_to_planar(img).astype(np.float32)
    want = np.asarray(jstep.sharded_iterate(
        x, jf, iters, mesh=_jax_mesh(grid_shape), backend="pallas_rdma",
        storage=storage, fuse=fuse, boundary=boundary)).astype(np.uint8)
    got = step.sharded_iterate(
        x, tf, iters, grid=mesh.make_grid(grid_shape, "cpu"),
        backend="cuda_rdma", storage=storage, fuse=fuse, boundary=boundary)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy().astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imageio.planar_to_interleaved(got),
                                  oracle.run_serial_u8(img, tf, iters,
                                                       boundary))


def test_float_mode_matches_oracle_and_pallas_rdma():
    jf, tf = _filters("blur3")
    img = _image("zero", "grey", seed=7)
    x = img[None].astype(np.float32)
    iters = 4
    got = step.sharded_iterate(x, tf, iters, grid=mesh.make_grid((2, 2), "cpu"),
                               quantize=False, backend="cuda_rdma", fuse=2)
    want = np.asarray(jstep.sharded_iterate(
        x, jf, iters, mesh=_jax_mesh((2, 2)), quantize=False,
        backend="pallas_rdma", fuse=2))
    rtol, atol = stencil.float_tolerance(tf, iters, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    # The plain path rounds like NumPy: bit-identical to the float oracle.
    ref = oracle.run_serial_f32(img.astype(np.float32), tf, iters)
    np.testing.assert_array_equal(got.numpy()[0], ref)


@pytest.mark.parametrize("tiled,boundary", [(False, "zero"),
                                            (True, "periodic")])
def test_plain_step_matches_jax_fused_rdma_step(tiled, boundary):
    # The smallest f32 block the tiled kernel takes is (8, 128); one chunk
    # of 2 levels on a 2x2 grid, every ghost from a real neighbour.
    jf, tf = _filters("blur3")
    grid_shape, fuse = (2, 2), 2
    x = np.random.default_rng(3).integers(0, 256, size=(2, 16, 256)).astype(
        np.float32)
    valid = x.shape[1:]

    def body(v):
        return jrdma.fused_rdma_step(v, jf, grid_shape, boundary,
                                     quantize=True, tiled=tiled, fuse=fuse,
                                     valid_hw=valid)

    want = np.asarray(jax.jit(shard_map(
        body, mesh=_jax_mesh(grid_shape), in_specs=P(None, "x", "y"),
        out_specs=P(None, "x", "y"), check_vma=False))(x))
    blocks = mesh.split_blocks(torch.from_numpy(x),
                               mesh.make_grid(grid_shape, "cpu"))
    got = rdma.fused_rdma_step_plain(blocks, tf, grid_shape, boundary,
                                     fuse=fuse, valid_hw=valid)
    np.testing.assert_array_equal(mesh.join_blocks(got).numpy(), want)


def test_model_and_cli_run_cuda_rdma(tmp_path):
    img = imageio.generate_test_image(30, 41, "rgb", seed=5)
    model = ConvolutionModel("gaussian5", backend="cuda_rdma", storage="bf16",
                             fuse=3, grid=mesh.make_grid((2, 2), "cpu"))
    np.testing.assert_array_equal(model.run_image(img, 7),
                                  oracle.run_serial_u8(img, model.filt, 7))
    src, out = tmp_path / "in.raw", tmp_path / "out.raw"
    imageio.write_raw(src, img)
    assert cli_main(["run", str(src), "30", "41", "7", "rgb", "-o", str(out),
                     "--filter", "gaussian5", "--backend", "cuda_rdma",
                     "--mesh", "2x2", "--fuse", "3", "--storage", "u8",
                     "--device", "cpu", "--fast"]) == 0
    np.testing.assert_array_equal(imageio.read_raw(out, 30, 41, "rgb"),
                                  oracle.run_serial_u8(img, model.filt, 7))


def test_rdma_plan_picks_kernel_from_shared_memory():
    # 120 x 158 blocks (1920 x 2520 on 16 x 16) fit whole at T = 8.
    need = stencil.fused_smem_bytes(1, 8, (120, 158))
    assert rdma.rdma_plan(1, 8, (120, 158), smem_limit=need) == (
        "block", (120, 158), [8])
    plan = rdma.rdma_plan(1, 8, (120, 158), smem_limit=need - 1)
    assert plan.kernel == "tiled"
    # The card's limit: K3 for the 16 x 16 grid, K4 for 2 x 2 and 4 x 4.
    assert rdma.rdma_plan(1, 8, (120, 158)).kernel == "block"
    assert rdma.rdma_plan(1, 32, (960, 1260)).kernel == "tiled"
    assert rdma.rdma_plan(2, 32, (2048, 2048)).kernel == "tiled"


@pytest.mark.parametrize("r,T,hw", [(1, 8, (120, 158)), (1, 8, (200, 200)),
                                    (1, 32, (100, 100)), (2, 16, (150, 170)),
                                    (4, 4, (180, 180)), (1, 8, (230, 230))])
def test_rdma_plan_block_fit_is_one_buffer(r, T, hw):
    # K3 takes a block whole when ONE f32 buffer of its level-0 window fits
    # (the levels run in place), 4 (h+2rT)(w+2rT) bytes: the kernels' own
    # window_bytes, so blocks up to twice the area of the two-buffer loop.
    need = 4 * (hw[0] + 2 * r * T) * (hw[1] + 2 * r * T)
    assert stencil.fused_smem_bytes(r, T, hw) == need
    plan = rdma.rdma_plan(r, T, hw)
    assert plan.kernel == ("block" if need <= stencil.H100_SMEM_OPTIN
                           else "tiled")
    if plan.kernel == "block":
        assert plan == ("block", hw, [T])
    else:
        assert plan.groups == stencil.fused_plan(r, T, hw)[2]


@pytest.mark.parametrize("r,T,hw,tile", [(1, 32, (960, 1260), None),
                                         (2, 32, (2048, 2048), None),
                                         (2, 4, (2048, 2048), None),
                                         (1, 8, (500, 700), (160, 160)),
                                         (2, 17, (300, 300), (100, 90))])
def test_rdma_plan_groups_match_fused_plan(r, T, hw, tile):
    plan = rdma.rdma_plan(r, T, hw, tile)
    th, tw, groups = stencil.fused_plan(r, T, hw, tile)
    assert plan == ("tiled", (th, tw), groups) and sum(plan.groups) == T


def test_rdma_keeps_jax_errors():
    jf, tf = _filters("blur3")
    small = np.zeros((1, 5, 7), np.float32)
    with pytest.raises(ValueError) as jerr:
        jrdma.fused_rdma_step(small, jf, (1, 1), fuse=8, valid_hw=(5, 7))
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        rdma.rdma_plan(1, 8, (5, 7))
    blocks = [[torch.zeros((1, 5, 7))]]
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        rdma.fused_rdma_step(blocks, tf, (1, 1), fuse=8, valid_hw=(5, 7))
    with pytest.raises(ValueError) as jerr:
        jrdma.fused_rdma_step(small, jf, (1, 1), "zero", fuse=2)
    with pytest.raises(ValueError, match=re.escape(str(jerr.value))):
        rdma.fused_rdma_step(blocks, tf, (1, 1), "zero", fuse=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rdma.rdma_block(rdma.stack_blocks(blocks, (1, 1)), tf, (1, 1), "zero",
                        1, (5, 7))
    with pytest.raises(ValueError, match="stacked"):
        rdma.fused_rdma_stacked(blocks[0][0], tf, (1, 1), "periodic")


def _gather(blocks, table, depth):
    """Pad every block from the neighbour table alone: each of the nine
    regions from the block the table names (zeros for -1)."""
    h, w = blocks[0][0].shape[1:]
    d = depth
    cols = len(blocks[0])
    flat = [b for row in blocks for b in row]
    spans = {-1: (slice(h - d, h), slice(w - d, w)), 0: (slice(0, h),
                                                          slice(0, w)),
             1: (slice(0, d), slice(0, d))}
    out = []
    for b, x in enumerate(flat):
        p = x.new_zeros((x.shape[0], h + 2 * d, w + 2 * d))
        for (di, dj), src in zip(channels.OFFSETS, table[b]):
            dst_r = {-1: slice(0, d), 0: slice(d, d + h),
                     1: slice(d + h, h + 2 * d)}[di]
            dst_c = {-1: slice(0, d), 0: slice(d, d + w),
                     1: slice(d + w, w + 2 * d)}[dj]
            if src >= 0:
                p[:, dst_r, dst_c] = flat[src][:, spans[di][0], spans[dj][1]]
        out.append(p)
    return [out[i * cols:(i + 1) * cols] for i in range(len(blocks))]


@pytest.mark.parametrize("grid_shape,boundary", [((1, 1), "zero"),
                                                 ((2, 2), "zero"),
                                                 ((1, 4), "periodic"),
                                                 ((4, 1), "zero"),
                                                 ((2, 3), "periodic")])
def test_neighbor_table_matches_halo_exchange(grid_shape, boundary):
    # The table's direct diagonal reads give the two-hop exchange's bytes.
    R, C = grid_shape
    x = torch.from_numpy(np.random.default_rng(R * 10 + C).integers(
        0, 256, size=(2, 6 * R, 5 * C)).astype(np.float32))
    blocks = mesh.split_blocks(x, mesh.make_grid(grid_shape, "cpu"))
    table = channels.neighbour_table(grid_shape, boundary)
    assert channels.neighbour_table(grid_shape, boundary) is table
    # The stacked grid the kernels take, and back: the same blocks.
    stacked = rdma.stack_blocks(blocks, grid_shape)
    assert stacked.shape == (R * C, 2, 6, 5)
    for grow, brow in zip(rdma.unstack_blocks(stacked, grid_shape), blocks):
        assert all(torch.equal(g, b) for g, b in zip(grow, brow))
    before = halo.halo_exchange.calls
    want = halo.halo_exchange(blocks, 3, grid_shape, boundary)
    assert halo.halo_exchange.calls == before + 1
    got = _gather(blocks, table, 3)
    for grow, wrow in zip(got, want):
        for g, w in zip(grow, wrow):
            assert torch.equal(g, w)
    if boundary == "periodic" and R == 1:
        # Self-wrap: the block itself feeds its top and bottom ghosts.
        assert all(table[b][channels.OFFSETS.index((di, 0))] == b
                   for b in range(C) for di in (-1, 1))
    with pytest.raises(ValueError, match="boundary"):
        channels.neighbour_table(grid_shape, "reflect")
