"""Blocks on separate devices (ROADMAP item 10): the port's grid of slots
against its one-device grid, the NumPy oracle and the JAX package on its
8-device CPU mesh.

A grid of slots gives every block a device of its own (here every slot is
``cpu``, as the JAX tests give every block one of the 8 forced CPU
devices): per-block padded buffers, the exchange a copy of each edge slab
between devices, ``cuda_rdma`` in its per-device form (on the CPU its plain
version: ghosts NaN until their slab lands, rows, then columns at the full
padded height, ``packed`` through each block's staging), the convergence
diff gathered over the slots.  Quantize mode must give the one-device
grid's and the oracle's bytes; float mode agrees with JAX within
``ops/stencil.float_tolerance``.  The per-device kernels themselves run on
the card (tests/test_torch_kernels_cuda.py).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.ops import pallas_rdma as jrdma
from parallel_convolution_tpu.parallel import channels as jchannels
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.parallel import step as jstep
from parallel_convolution_tpu.tuning import costmodel as jcostmodel
from parallel_convolution_tpu.utils.jax_compat import shard_map
from parallel_convolution_tpu_torch import convert
from parallel_convolution_tpu_torch.cli import main as cli_main
from parallel_convolution_tpu_torch.models import ConvolutionModel, JacobiSolver
from parallel_convolution_tpu_torch.ops import oracle, rdma, stencil
from parallel_convolution_tpu_torch.parallel import (
    channels, halo, kernels, mesh, multihost, step,
)
from parallel_convolution_tpu_torch.tuning import costmodel, search
from parallel_convolution_tpu_torch.tuning.plans import (
    Plan, PlanCache, Workload,
)
from parallel_convolution_tpu_torch.utils import bench, config, imageio

GRIDS = [(1, 2), (2, 1), (2, 2), (2, 4)]
BACKENDS = ["shifted", "xla_conv", "separable", "cuda", "cuda_sep",
            "cuda_rdma"]
JAX_NAME = {v: k for k, v in config.BACKEND_FROM_REFERENCE.items()}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "u8": torch.uint8}


def _slots(shape):
    return mesh.make_grid(shape, devices=["cpu"] * (shape[0] * shape[1]))


def _jax_mesh(shape):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _filters(name):
    jf = jfilters.get_filter(name)
    return jf, convert.filter_from_numpy(jf.name, jf.taps, jf.dyadic)


# ---------------------------------------------------------------- the grid


def test_make_grid_of_slots():
    g = mesh.make_grid((2, 2), devices="cpu,cpu,cpu,cpu")
    assert g.slotted and g.shape == (2, 2) and g.device == torch.device("cpu")
    assert g.slots == (torch.device("cpu"),) * 4
    assert g.slot_map() == "cpu,cpu,cpu,cpu"
    # The default shape is dims_create of the slots, as the JAX mesh's.
    assert mesh.make_grid(devices=["cpu"] * 8).shape == jmesh.dims_create(8)
    assert mesh.make_grid(devices="all", device="cpu").slots == (
        torch.device("cpu"),)
    one = mesh.make_grid((2, 2), "cpu")
    assert not one.slotted and one.slots == (torch.device("cpu"),) * 4
    assert mesh.grid_from_spec("2x4", "cpu,cpu,cpu,cpu,cpu,cpu,cpu,cpu") == (
        mesh.make_grid((2, 4), devices=["cpu"] * 8))
    with pytest.raises(ValueError, match="needs 4 slots"):
        mesh.make_grid((2, 2), devices=["cpu"] * 3)
    # A slot naming a card the machine does not have raises; it is never
    # mapped elsewhere.
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError):
        mesh.make_grid((1, 2), devices=["cpu", f"cuda:{n}"])
    with pytest.raises(RuntimeError, match="does not have"):
        mesh.make_grid((1, 1), devices=[f"cuda:{n}"])
    x = torch.arange(2 * 6 * 8, dtype=torch.float32).reshape(2, 6, 8)
    blocks = mesh.split_blocks(x, g)
    assert all(b.is_contiguous() and b.shape == (2, 3, 4)
               for row in blocks for b in row)
    assert torch.equal(mesh.join_blocks(blocks), x)


@pytest.mark.parametrize("grid_shape", [(1, 2), (2, 2), (2, 4), (3, 3),
                                        (1, 1)])
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("dtype", ["u8", "bf16", "f32"])
def test_exchange_per_block_matches_the_one_device_exchange(grid_shape,
                                                            boundary, dtype):
    R, C = grid_shape
    x = torch.from_numpy(np.random.default_rng(R * 7 + C).integers(
        0, 256, size=(2, 6 * R, 7 * C)).astype(np.float32)).to(TORCH[dtype])
    blocks = mesh.split_blocks(x, _slots(grid_shape))
    for d in (1, 3):
        want = halo.halo_exchange(blocks, d, grid_shape, boundary)
        for packed in (False, True):
            got = halo.exchange_per_block(blocks, d, grid_shape, boundary,
                                          dtype=torch.float32,
                                          fill=float("nan"), packed=packed)
            for grow, wrow in zip(got, want):
                for g, w in zip(grow, wrow):
                    assert not g.isnan().any()
                    assert torch.equal(g, w.to(torch.float32))
        got = halo.exchange_per_block(blocks, d, grid_shape, boundary)
        assert all(torch.equal(g, w) for grow, wrow in zip(got, want)
                   for g, w in zip(grow, wrow))


def test_nan_ghosts_show_a_wrong_phase_order():
    # Columns first, rows second (the wrong order): the corners of the
    # column slabs are taken before the row phase has filled them, and stay
    # NaN; the port's order leaves none.
    R, C, d = 2, 2, 2
    x = torch.rand(1, 8 * R, 8 * C)
    blocks = mesh.split_blocks(x, _slots((R, C)))
    pads = [[torch.full((1, 8 + 2 * d, 8 + 2 * d), float("nan")) for _ in
             range(C)] for _ in range(R)]
    for i in range(R):
        for j in range(C):
            pads[i][j][:, d:d + 8, d:d + 8] = blocks[i][j]
    for i in range(R):
        for j in range(C):
            pads[i][j][:, :, :d] = pads[i][(j - 1) % C][:, :, 8:8 + d]
    for i in range(R):
        for j in range(C):
            pads[i][j][:, :d, d:d + 8] = blocks[(i - 1) % R][j][:, 8 - d:, :]
    assert any(p.isnan().any() for row in pads for p in row)
    good = halo.exchange_per_block(blocks, d, (R, C), "periodic",
                                   fill=float("nan"))
    assert not any(p.isnan().any() for row in good for p in row)


# -------------------------------------------- every backend on every grid


def _image(boundary, rgb_small, grey_odd):
    return rgb_small if boundary == "periodic" else grey_odd


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("grid_shape", GRIDS)
def test_slots_match_one_device_and_oracle(grid_shape, backend, rgb_small,
                                           grey_odd):
    _, tf = _filters("blur3")
    iters = 5
    for boundary in ("zero", "periodic"):
        img = _image(boundary, rgb_small, grey_odd)
        x = imageio.interleaved_to_planar(img).astype(np.float32)
        want = oracle.run_serial_u8(img, tf, iters, boundary)
        # Fuse 1-4, each storage at least once per boundary.
        for fuse, storage in ((1, "u8"), (2, "bf16"), (3, "f32"),
                              (4, "u8" if boundary == "zero" else "bf16")):
            modes = (("packed", "strided") if backend == "cuda_rdma"
                     else ("packed",))
            kw = dict(backend=backend, storage=storage, fuse=fuse,
                      boundary=boundary)
            one = step.sharded_iterate(
                x, tf, iters, grid=mesh.make_grid(grid_shape, "cpu"),
                **kw)
            for cm in modes:
                got = step.sharded_iterate(x, tf, iters,
                                           grid=_slots(grid_shape),
                                           col_mode=cm, **kw)
                assert torch.equal(got, one), (boundary, storage, fuse,
                                               cm)
            np.testing.assert_array_equal(
                imageio.planar_to_interleaved(
                    one.numpy().astype(np.uint8)), want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_slots_match_jax_on_the_8_device_mesh(backend, grey_odd):
    # u8 mode: the JAX package's bytes (its Pallas tiers in interpret mode).
    jf, tf = _filters("blur3")
    x = grey_odd[None].astype(np.float32)
    jkw = dict(backend=JAX_NAME[backend], storage="bf16", fuse=2)
    want = np.asarray(jstep.sharded_iterate(x, jf, 5, mesh=_jax_mesh((2, 4)),
                                            **jkw))
    for cm in ("packed", "strided"):
        got = step.sharded_iterate(x, tf, 5, grid=_slots((2, 4)),
                                   backend=backend, storage="bf16", fuse=2,
                                   col_mode=cm)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("backend", ["cuda_rdma", "cuda", "shifted"])
@pytest.mark.parametrize("grid_shape", [(2, 2), (1, 2)])
def test_float_mode_on_slots_matches_jax(backend, grid_shape, grey_odd):
    jf, tf = _filters("gaussian5")
    x = grey_odd[None].astype(np.float32) / 7.0
    iters = 4
    want = np.asarray(jstep.sharded_iterate(
        x, jf, iters, mesh=_jax_mesh(grid_shape), quantize=False,
        backend=JAX_NAME[backend], fuse=2))
    rtol, atol = stencil.float_tolerance(tf, iters, torch.float32)
    for cm in ("packed", "strided"):
        got = step.sharded_iterate(x, tf, iters, grid=_slots(grid_shape),
                                   quantize=False, backend=backend, fuse=2,
                                   col_mode=cm)
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("backend", ["cuda_rdma", "cuda", "shifted"])
def test_converge_on_slots_matches_one_device_and_jax(backend):
    jf, tf = _filters("jacobi3")
    x = np.random.default_rng(11).standard_normal((1, 24, 36)).astype(
        np.float32)
    kw = dict(check_every=6, fuse=3)
    one, n1 = step.sharded_converge(x, tf, 1e-2, 300,
                                    grid=mesh.make_grid((2, 4), "cpu"),
                                    backend=backend, **kw)
    # The JAX run to hold it to: its plain tier (its Pallas tiers are the
    # same values, in interpret mode here, and slow over hundreds of
    # iterations; test_slots_match_jax_on_the_8_device_mesh holds them).
    jwant, jn = jstep.sharded_converge(x, jf, 1e-2, 300,
                                       mesh=_jax_mesh((2, 4)),
                                       backend="shifted", **kw)
    assert n1 == jn
    rtol, atol = stencil.float_tolerance(tf, n1, torch.float32)
    for cm in ("packed", "strided"):
        before = step.sharded_converge.readbacks
        got, n = step.sharded_converge(x, tf, 1e-2, 300, grid=_slots((2, 4)),
                                       backend=backend, col_mode=cm, **kw)
        assert n == n1 and torch.equal(got, one)
        assert step.sharded_converge.readbacks - before == -(-n // 6)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                                   rtol=rtol, atol=atol)
    streamed = list(step.sharded_converge_stream(
        x, tf, 1e-2, 300, grid=_slots((2, 4)), backend=backend, **kw))
    assert streamed[-1][1] == n1
    np.testing.assert_array_equal(streamed[-1][0], one.numpy())


def test_a_nan_on_any_slot_stops_the_run():
    _, tf = _filters("jacobi3")
    x = np.random.default_rng(12).standard_normal((1, 24, 36)).astype(
        np.float32)
    x[0, 20, 30] = np.nan  # block (1, 3) of the 2x4 grid
    for backend in ("cuda_rdma", "shifted"):
        stream = list(step.sharded_converge_stream(
            x, tf, 1e-3, 100, check_every=5, grid=_slots((2, 4)),
            backend=backend))
        assert len(stream) == 1 and np.isnan(stream[0][2])


# --------------------------------------- K3 / K4 per device, kernel level


@pytest.mark.parametrize("grid_shape", [(2, 2), (1, 4), (2, 4)])
@pytest.mark.parametrize("col_mode", ["packed", "strided"])
def test_plain_slots_match_jax_fused_rdma_step(grid_shape, col_mode):
    # JAX fused_rdma_step(col_mode=...) on the DMA-faithful interpreter, as
    # tests/test_channels.py drives it; periodic only (zero mode's protocol
    # is the reference's known failure, ROADMAP Queue 3).
    jf, tf = _filters("blur3")
    R, C = grid_shape
    x = np.random.default_rng(R * 5 + C).integers(
        0, 256, size=(1, 16 * R, 16 * C)).astype(np.float32)
    for fuse in (1, 2):
        def body(v):
            return jrdma.fused_rdma_step(v, jf, grid_shape, "periodic",
                                         quantize=True, fuse=fuse,
                                         col_mode=col_mode)

        want = np.asarray(jax.jit(shard_map(
            body, mesh=_jax_mesh(grid_shape), in_specs=P(None, "x", "y"),
            out_specs=P(None, "x", "y"), check_vma=False))(x))
        blocks = mesh.split_blocks(torch.from_numpy(x), _slots(grid_shape))
        got = rdma.fused_rdma_slots(blocks, tf, grid_shape, "periodic",
                                    fuse=fuse, col_mode=col_mode)
        np.testing.assert_array_equal(mesh.join_blocks(got).numpy(), want)


@pytest.mark.parametrize("grid_shape,boundary", [((2, 2), "zero"),
                                                 ((1, 4), "periodic"),
                                                 ((3, 3), "periodic")])
def test_pack_plain_is_the_column_slabs(grid_shape, boundary):
    R, C = grid_shape
    x = torch.rand(2, 9 * R, 8 * C)
    blocks = mesh.split_blocks(x, _slots(grid_shape))
    d = 3
    padded = halo.halo_exchange(blocks, d, grid_shape, boundary)
    for s, st in enumerate(rdma.rdma_pack_plain(blocks, grid_shape,
                                                boundary, d)):
        p = padded[s // C][s % C]
        assert st.shape == (2, 2, 9 + 2 * d, d)
        assert torch.equal(st[0], p[:, :, d:2 * d])
        assert torch.equal(st[1], p[:, :, 8:8 + d])


def test_slot_wrappers_take_the_plain_version_only_on_the_cpu():
    _, tf = _filters("blur3")
    blocks = mesh.split_blocks(torch.rand(1, 16, 16), _slots((2, 2)))
    # On the CPU the carry is the blocks themselves.
    assert rdma.slot_carry(blocks, _slots((2, 2)), "zero", 1) is blocks
    assert rdma.slot_blocks(blocks, (2, 2)) is blocks
    with pytest.raises(ValueError, match="col_mode must be one of"):
        rdma.fused_rdma_slots(blocks, tf, (2, 2), col_mode="auto")
    with pytest.raises(ValueError, match="smaller than the ghost depth"):
        rdma.fused_rdma_slots(blocks, tf, (2, 2), fuse=9, valid_hw=(16, 16))


def test_slot_streams_fork_from_and_join_every_device(monkeypatch):
    # Slots on two cards: a slot's first launch reads its neighbours'
    # blocks, stacked on the other card's current stream, so every slot
    # stream waits on every device's current stream; and every device's
    # current stream waits on every slot's last launch.  Fakes stand in
    # for the streams and events, so this runs without a card.
    class Fake:
        def __init__(self, name):
            self.name, self.waited = name, []

        def wait_stream(self, other):
            self.waited.append(other.name)

        def wait_event(self, ev):
            self.waited.append(ev.name)

    devs = [torch.device("cuda", k) for k in (0, 1)]
    current = {d: Fake(f"current {d}") for d in devs}
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: current[torch.device(d)])
    run = rdma._SlotRun.__new__(rdma._SlotRun)
    run.slots = [devs[0], devs[1], devs[0], devs[1]]
    run.devices = devs
    run.streams = [Fake(f"slot {s}") for s in range(4)]
    run.launched = [Fake(f"launch {s}") for s in range(4)]
    run.fork()
    assert not run.joined
    for st in run.streams:
        assert sorted(st.waited) == sorted(f"current {d}" for d in devs)
    run.join()
    assert run.joined
    for d in devs:
        assert current[d].waited == [f"launch {s}" for s in range(4)]


# ------------------------------------------------------- the channel plan


def _keys():
    for grid in ((2, 4), (1, 1), (4, 1), (1, 8), (2, 2)):
        for kernel in ("monolithic", "tiled"):
            for cm in ("packed", "strided"):
                for dtype in ("float32", "bfloat16", "uint8"):
                    yield dict(grid=grid, block_hw=(16, 32), radius=1,
                               fuse=2, dtype=dtype, boundary="periodic",
                               kernel=kernel, col_mode=cm)


def test_channel_plans_are_the_jax_packages():
    channels.reset()
    n = 0
    for kw in _keys():
        mine = channels.plan_for(channels.ChannelKey(**kw))
        theirs = jchannels.plan_for(jchannels.ChannelKey(**kw))
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), kw
        assert mine.packed_cols == theirs.packed_cols
        assert mine.slab("left") == (theirs.slab("left") and
                                     channels.Slab(**dataclasses.asdict(
                                         theirs.slab("left"))))
        n += 1
    assert channels.stats() == {"builds": n, "hits": 0}
    again = channels.plan_for(channels.ChannelKey(**next(_keys())))
    assert again is channels.plan_for(channels.ChannelKey(**next(_keys())))
    assert channels.stats() == {"builds": n, "hits": 2}
    assert channels.DIRECTIONS == jchannels.DIRECTIONS
    assert channels.OPPOSITE == jchannels.OPPOSITE
    assert (channels.COL_MODES, channels.COL_MODE_CHOICES) == (
        jchannels.COL_MODES, jchannels.COL_MODE_CHOICES)
    with pytest.raises(ValueError, match="resolved, never 'auto'"):
        channels.ChannelKey((2, 2), (8, 8), 1, 1, "float32", "zero",
                            col_mode="auto")
    channels.reset()
    assert channels.stats() == {"builds": 0, "hits": 0}


def test_slot_runs_fetch_one_plan_per_identity():
    _, tf = _filters("blur3")
    channels.reset()
    x = np.random.default_rng(3).integers(0, 256, size=(1, 24, 36)).astype(
        np.float32)
    step.sharded_iterate(x, tf, 12, grid=_slots((2, 2)), backend="cuda_rdma",
                         fuse=4, col_mode="packed")
    # The CPU's plain version builds no plan; the card's per-slot step
    # fetches one per step (tests/test_torch_kernels_cuda.py).
    assert channels.stats()["builds"] == 0


# ------------------------------------------------ col_mode and the model


def test_pick_col_mode_on_the_ports_constants():
    hw = costmodel.H100
    for grid in ((2, 2), (4, 4), (2, 4)):
        for block, r, T, storage in (((960, 1260), 1, 32, "bf16"),
                                     ((2048, 2048), 2, 32, "u8"),
                                     ((120, 158), 1, 8, "u8"),
                                     ((64, 64), 1, 1, "f32")):
            packed = costmodel.col_transport_seconds_per_round(
                block, r, T, storage, hw, "packed")
            strided = costmodel.col_transport_seconds_per_round(
                block, r, T, storage, hw, "strided")
            pick = costmodel.pick_col_mode(grid, block, r, T, storage, hw)
            assert pick == ("packed" if packed <= strided else "strided")
            assert pick == costmodel.pick_col_mode(grid, block, r, T,
                                                   storage, hw)
    # No column partner: the canonical label.
    assert costmodel.pick_col_mode((4, 1), (256, 128), 1, 1, "f32",
                                   hw) == "packed"
    # A costly in-place read tips thin slabs to packed, the pack's fixed
    # price keeps tiny ones strided.
    dear = dataclasses.replace(hw, col_row_s=50e-9, pack_s=4e-6)
    assert costmodel.pick_col_mode((2, 2), (2048, 2048), 1, 1, "u8",
                                   dear) == "packed"
    assert costmodel.pick_col_mode((2, 2), (16, 16), 1, 1, "u8",
                                   dear) == "strided"
    with pytest.raises(ValueError, match="col_mode"):
        costmodel.col_transport_seconds_per_round((8, 8), 1, 1, "f32", hw,
                                                  "dense")
    # The JAX formula's structure: strided pays per padded row.
    rows = 960 + 2 * 32
    assert costmodel.col_transport_seconds_per_round(
        (960, 1260), 1, 32, "bf16", dear, "strided") == pytest.approx(
        2 * rows * dear.col_row_s)
    assert jcostmodel.pick_col_mode((4, 1), (256, 128), 1, 1, "f32",
                                    jcostmodel.hardware_for("cpu")) == "packed"


def test_resolve_col_mode_clamps():
    slots, one = _slots((2, 2)), mesh.make_grid((2, 2), "cpu")
    col = _slots((2, 1))
    assert step.resolve_col_mode("strided", "shifted", slots, (8, 8), 1, 1,
                                 "f32") == "packed"
    assert step.resolve_col_mode("strided", "cuda_rdma", one, (8, 8), 1, 1,
                                 "f32") == "packed"
    assert step.resolve_col_mode("strided", "cuda_rdma", col, (8, 8), 1, 1,
                                 "f32") == "packed"
    assert step.resolve_col_mode("strided", "cuda_rdma", slots, (8, 8), 1,
                                 1, "f32") == "strided"
    auto = step.resolve_col_mode("auto", "cuda_rdma", slots, (8, 8), 1, 1,
                                 "f32")
    assert auto == step.resolve_col_mode(None, "cuda_rdma", slots, (8, 8),
                                         1, 1, "f32")
    assert auto == costmodel.pick_col_mode(
        (2, 2), (8, 8), 1, 1, "f32", costmodel.hardware_for("cpu"))
    with pytest.raises(ValueError, match="col_mode"):
        step.resolve_col_mode("dense", "cuda_rdma", slots, (8, 8), 1, 1,
                              "f32")
    assert step.clamp_col_mode("strided", "cuda") == "packed"
    assert step.clamp_col_mode("strided", "cuda_rdma") == "strided"
    assert kernels.persistent_capable("cuda_rdma")
    assert not kernels.persistent_capable("cuda")
    assert kernels.overlap_capable("cuda_rdma")
    assert not kernels.clamp_overlap(True, "shifted")
    assert not kernels.persistent_capable("no_such_form")


def test_candidate_space_has_col_modes_on_slots():
    _, tf = _filters("blur3")
    for grid, want in ((_slots((2, 2)), {"packed", "strided"}),
                       (mesh.make_grid((2, 2), "cpu"), {"packed"}),
                       (_slots((2, 1)), {"packed"})):
        w = Workload.from_grid(grid, tf, (1, 64, 64))
        cands = search.enumerate_candidates(w)
        assert {c.col_mode for c in cands if c.backend == "cuda_rdma"} == want
        assert {c.col_mode for c in cands if c.backend != "cuda_rdma"} == {
            "packed"}
        assert not any(c.overlap for c in cands)
        # A grid of slots has a key of its own; a one-device grid keeps
        # the JAX package's.
        one = Workload.from_grid(mesh.make_grid(grid.shape, "cpu"), tf,
                                 (1, 64, 64))
        assert (w.key() == one.key()) == (not grid.slotted)
        assert "slotted" not in one.key_fields()
    gpu = dataclasses.replace(
        Workload.from_grid(_slots((4, 4)), tf, (1, 8192, 8192)),
        platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    ranked = search.rank(gpu, search.enumerate_candidates(
        gpu, backends=["cuda_rdma"], fuses=[32], hw=costmodel.H100),
        costmodel.H100)
    assert {c.col_mode for _, c in ranked} == {"packed", "strided"}
    assert ranked[0][1].col_mode == costmodel.pick_col_mode(
        (4, 4), (2048, 2048), 1, 32, "f32", costmodel.H100)


def test_a_plan_answers_only_its_own_layout():
    _, tf = _filters("blur3")
    one = Workload.from_grid(mesh.make_grid((2, 2), "cpu"), tf, (1, 64, 64))
    slots = Workload.from_grid(_slots((2, 2)), tf, (1, 64, 64))
    cards = dataclasses.replace(slots, cards=2)
    assert slots.key_fields() == dict(one.key_fields(), slotted=True)
    assert cards.key_fields() == dict(slots.key_fields(), cards=2)
    for tuned, other in ((one, slots), (slots, one), (slots, cards)):
        cache = PlanCache()
        cache.put(tuned, Plan("cuda_rdma", fuse=4, col_mode="strided",
                              source="measured"))
        assert cache.best_plan(tuned).source == "measured"
        assert cache.best_plan(other) is None
    # Slots of another grid shape still interpolate, as one device does.
    cache = PlanCache()
    cache.put(slots, Plan("cuda_rdma", fuse=4, source="measured"))
    wide = Workload.from_grid(_slots((2, 4)), tf, (1, 64, 64))
    assert cache.best_plan(wide).source == "interpolated"


def test_model_bench_and_degrade_on_slots(rgb_small):
    _, tf = _filters("blur3")
    want = oracle.run_serial_u8(rgb_small, tf, 6)
    for cm in ("packed", "strided", None):
        model = ConvolutionModel(tf, grid=_slots((2, 2)), backend="cuda_rdma",
                                 storage="u8", fuse=3, col_mode=cm,
                                 fallback=True)
        np.testing.assert_array_equal(model.run_image(rgb_small, 6), want)
        assert model.effective_backend == "cuda_rdma"
        assert model.effective_col_mode == (cm or step.resolve_col_mode(
            None, "cuda_rdma", model.grid, (12, 18), 1, 3, "u8"))
    model = ConvolutionModel(tf, grid=_slots((2, 2)), backend="cuda",
                             col_mode="strided")
    np.testing.assert_array_equal(model.run_image(rgb_small, 6), want)
    assert model.effective_col_mode == "packed"
    row = bench.bench_iterate((24, 36), tf, 4, grid=_slots((2, 2)),
                              backend="cuda_rdma", storage="bf16", fuse=2,
                              reps=1, col_mode="strided")
    assert (row["col_mode"], row["slots"], row["chips"]) == (
        "strided", "cpu,cpu,cpu,cpu", 1)
    row = bench.bench_iterate((24, 36), tf, 4, grid=mesh.make_grid((2, 2),
                                                                   "cpu"),
                              backend="cuda_rdma", reps=1)
    assert (row["col_mode"], row["slots"]) == ("packed", None)
    with pytest.raises(ValueError, match="col_mode must be one of"):
        ConvolutionModel(tf, device="cpu", col_mode="dense")


# ------------------------------------------------ ported: 10b and 10c


def test_overlap_names_10b_and_slots_name_10c(tmp_path, monkeypatch):
    # Item 10b is ported: overlap on cuda_rdma over slots runs (its plain
    # schedule on the CPU, with the byte-proof hatch set), byte-equal to
    # the serialized run, through every entry point that takes it.
    _, tf = _filters("blur3")
    jacobi3 = _filters("jacobi3")[1]
    x = np.random.default_rng(3).integers(0, 256, (1, 16, 16)).astype(
        np.float32)
    assert config.PENDING_KNOBS == {}
    monkeypatch.setenv(config.OVERLAP_INTERPRET_ENV, "1")
    slots = _slots((2, 2))
    kw = dict(grid=slots, backend="cuda_rdma", fuse=2)
    want = step.sharded_iterate(x, tf, 4, **kw)
    assert torch.equal(step.sharded_iterate(x, tf, 4, overlap=True, **kw),
                       want)
    model = ConvolutionModel(tf, overlap=True, **kw)
    assert torch.equal(model.run_planar(x, 4), want)
    assert model.effective_overlap is True
    solver = JacobiSolver(overlap=True, tol=0.1, max_iters=6, grid=slots,
                          backend="cuda_rdma")
    np.testing.assert_array_equal(
        solver.solve(x)[0], JacobiSolver(tol=0.1, max_iters=6, grid=slots,
                                         backend="cuda_rdma").solve(x)[0])
    assert bench.bench_iterate((16, 16), tf, 1, overlap=True, reps=1,
                               **kw)["overlap"] is True
    assert not step.resolve_overlap(None, "cuda_rdma", _slots((2, 2)))
    # Item 10c is ported: multigrid, volumes, sharded IO and checkpoints
    # run on the slots, each equal to the one-device grid's run.
    from parallel_convolution_tpu_torch.solvers import multigrid
    from parallel_convolution_tpu_torch.utils import checkpoint, sharded_io
    from parallel_convolution_tpu_torch.volumes import driver

    one = mesh.make_grid((2, 2), "cpu")
    vol = np.random.default_rng(4).random((2, 4, 8, 8), dtype=np.float32)
    imageio.write_raw(tmp_path / "x.raw", x[0].astype(np.uint8))
    for call in (
            lambda g: multigrid.mg_converge(x, jacobi3, 1e-3, 10, grid=g)[0],
            lambda g: step.sharded_converge(x, jacobi3, 1e-3, 10, grid=g,
                                            solver="multigrid")[0],
            lambda g: driver.volume_iterate(vol, "fd7", 1, grid=g),
            lambda g: mesh.join_blocks(sharded_io.load_sharded(
                tmp_path / "x.raw", 16, 16, "grey", g)),
            lambda g: mesh.join_blocks(checkpoint.run_checkpointed(
                sharded_io.load_sharded(tmp_path / "x.raw", 16, 16, "grey",
                                        g), tf, 4, g, (16, 16),
                tmp_path / f"ck{g.slotted}", 2))):
        assert torch.equal(call(slots), call(one))


def _cli_run(tmp_path, img, extra):
    src, dst = tmp_path / "in.raw", tmp_path / "out.raw"
    imageio.write_raw(src, img)
    rows, cols = img.shape[:2]
    mode = "rgb" if img.ndim == 3 else "grey"
    return cli_main(["run", str(src), str(rows), str(cols), "6", mode,
                     "-o", str(dst)] + extra), dst


def test_cli_runs_a_grid_of_slots(tmp_path, capsys, rgb_small):
    want = oracle.run_serial_u8(rgb_small, _filters("blur3")[1], 6)
    for cm in ("packed", "strided", "auto"):
        rc, dst = _cli_run(tmp_path, rgb_small, [
            "--device", "cpu,cpu,cpu,cpu", "--mesh", "2x2", "--backend",
            "cuda_rdma", "--fuse", "3", "--storage", "u8", "--col-mode", cm])
        assert rc == 0
        np.testing.assert_array_equal(imageio.read_raw(dst, 24, 36, "rgb"),
                                      want)
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert "slots cpu,cpu,cpu,cpu, col_mode " in line
    # --mesh left out: dims_create of the slots.
    rc, _ = _cli_run(tmp_path, rgb_small, ["--device", "cpu,cpu"])
    assert rc == 0 and "on 1x2 grid" in capsys.readouterr().out
    # --overlap on (item 10b, ported): on CPU slots it warns and runs
    # serialized unless the byte-proof hatch is set (test_torch_overlap.py).
    rc, dst = _cli_run(tmp_path, rgb_small, [
        "--device", "cpu,cpu,cpu,cpu", "--mesh", "2x2", "--overlap", "on"])
    assert rc == 0 and "overlapped" not in capsys.readouterr().out
    np.testing.assert_array_equal(imageio.read_raw(dst, 24, 36, "rgb"), want)
    # Item 10c: multigrid, --sharded-io and --checkpoint run on slots.
    rc, mg_dst = _cli_run(tmp_path, rgb_small, [
        "--device", "cpu,cpu,cpu,cpu", "--mesh", "2x2", "--converge", "0.5",
        "--solver", "multigrid"])
    assert rc == 0 and "V-cycles" in capsys.readouterr().out
    mg_slots = imageio.read_raw(mg_dst, 24, 36, "rgb")
    rc, mg_dst = _cli_run(tmp_path, rgb_small, [
        "--device", "cpu", "--mesh", "2x2", "--converge", "0.5",
        "--solver", "multigrid"])
    assert rc == 0
    np.testing.assert_array_equal(imageio.read_raw(mg_dst, 24, 36, "rgb"),
                                  mg_slots)
    for extra in (["--sharded-io"],
                  ["--checkpoint", str(tmp_path / "ck"),
                   "--checkpoint-every", "4"]):
        rc, dst = _cli_run(tmp_path, rgb_small, [
            "--device", "cpu,cpu,cpu,cpu", "--mesh", "2x2"] + extra)
        assert rc == 0 and "slots cpu,cpu,cpu,cpu" in capsys.readouterr().out
        np.testing.assert_array_equal(imageio.read_raw(dst, 24, 36, "rgb"),
                                      want)
    rc, _ = _cli_run(tmp_path, rgb_small, [
        "--device", "cpu,cpu,cpu", "--mesh", "2x2"])
    assert rc == 2 and "needs 4 slots" in capsys.readouterr().err
    assert cli_main(["info", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "default grid: (1, 1) over 1 device(s)" in out
    assert "--device all would use the slots cpu" in out
    row_rc = cli_main(["bench", "24", "36", "2", "grey", "--device",
                       "cpu,cpu", "--mesh", "1x2", "--backend", "cuda_rdma",
                       "--col-mode", "strided", "--reps", "1"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row_rc == 0 and (row["col_mode"], row["slots"]) == ("strided",
                                                               "cpu,cpu")


def test_single_process_multihost_is_a_no_op():
    multihost.initialize(num_processes=1)
    info = multihost.process_info()
    assert (info["process_index"], info["process_count"]) == (0, 1)
    assert info["global_devices"] == info["local_devices"] >= 1
    multihost.barrier()
    assert multihost.broadcast_scalar(2.5) == 2.5
