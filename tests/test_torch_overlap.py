"""The overlapped pipeline (ROADMAP item 10b) on the CPU: ``overlap=True``
and ``partitioned`` for ``cuda_rdma`` on a grid of slots.

On the card each slot launches K3 / K4 region by region: the interior with
no wait, each band after the events of exactly the neighbours its read
window covers (``rdma.region_neighbours``).  Here the plain schedule
(``rdma.fused_rdma_slots_plain(overlap=True)``) runs the same regions in
the same order, from buffers whose unwaited ghosts are NaN, and raises if a
NaN reaches a region: the missed-wait detector.  It is held against the
JAX package's region geometry, its serialized per-slot form, the NumPy
oracle, and the JAX overlapped kernels on the DMA-faithful interpreter
(the tiled one in both boundaries; the monolithic one periodic only, since
its zero mode is the reference's known failure, ROADMAP Queue 3).  The
region launches themselves run on the card
(tests/test_torch_kernels_cuda.py).
"""

import dataclasses
import itertools
import json
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.ops import pallas_rdma as jrdma
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.tuning import costmodel as jcostmodel
from parallel_convolution_tpu.utils.jax_compat import shard_map
from parallel_convolution_tpu_torch import convert
from parallel_convolution_tpu_torch.cli import main as cli_main
from parallel_convolution_tpu_torch.ops import oracle, rdma, stencil
from parallel_convolution_tpu_torch.parallel import mesh, step
from parallel_convolution_tpu_torch.tuning import costmodel, search
from parallel_convolution_tpu_torch.tuning.plans import Workload
from parallel_convolution_tpu_torch.utils import bench, config, imageio

ENV = config.OVERLAP_INTERPRET_ENV
GRIDS = [(1, 2), (2, 1), (2, 2), (2, 4)]
STEP = {"up": (-1, 0), "down": (1, 0), "left": (0, -1), "right": (0, 1)}


def _filters(name):
    jf = jfilters.get_filter(name)
    return jf, convert.filter_from_numpy(jf.name, jf.taps, jf.dyadic)


def _slots(shape):
    return mesh.make_grid(shape, devices=["cpu"] * (shape[0] * shape[1]))


def _jax_mesh(shape):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _image(shape, boundary, seed, channels=1):
    R, C = shape
    rows, cols = ((8 * R, 8 * C) if boundary == "periodic"
                  else (8 * R + 5, 8 * C + 3))
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(channels, rows, cols)).astype(
        np.float32)


def _run_slots(x, tf, shape, boundary, fuse, chunks, storage="u8",
               quantize=True, **kw):
    """``chunks`` chunks of ``fuse`` levels of the port's per-slot form
    straight at the kernel layer (the plain schedule on the CPU)."""
    grid = _slots(shape)
    blocks = convert.blocks_from_numpy(x, grid, storage)
    vhw = None if boundary == "periodic" else x.shape[1:]
    for _ in range(chunks):
        blocks = rdma.fused_rdma_slots(blocks, tf, shape, boundary,
                                       quantize=quantize, fuse=fuse,
                                       valid_hw=vhw, **kw)
    return mesh.join_blocks(blocks)[:, :x.shape[1], :x.shape[2]]


# ----------------------------------------------------------------- geometry


GEOMETRY = [(32, 48, 2), (8, 8, 4), (5, 40, 2), (3, 3, 2), (16, 4, 1),
            (1, 1, 1), (64, 64, 8), (4, 4, 2), (9, 9, 4), (7, 64, 3),
            (64, 7, 3)]


@pytest.mark.parametrize("h,w,d", GEOMETRY)
def test_region_geometry_is_the_jax_packages(h, w, d):
    assert rdma.overlap_regions(h, w, d) == jrdma.overlap_regions(h, w, d)
    assert rdma.overlap_region_slabs(h, w, d) == \
        jrdma.overlap_region_slabs(h, w, d)
    for wi, wj, th, tw, sub_v in itertools.product(
            range(3), range(3), (8, 16), (128, 256), (8, 16)):
        kw = dict(th=th, tw=tw, h=h * 16, w=w * 128, sub_v=sub_v)
        assert rdma.tiled_window_hazards(wi, wj, **kw) == \
            jrdma.tiled_window_hazards(wi, wj, **kw)


def _brute_neighbours(rect, h, w, reach, ext):
    """Every level-0 cell each output pixel of ``rect`` reads, one by one,
    classified by the block it lies in."""
    r0, r1, c0, c1 = rect
    found = set()
    side = lambda v, n: -1 if v < 0 else (0 if v < n else 1)  # noqa: E731
    for y in range(r0, r1):
        for x in range(c0, c1):
            for yy in range(y - ext - reach, y - ext + reach + 1):
                for xx in range(x - ext - reach, x - ext + reach + 1):
                    found.add((side(yy, h), side(xx, w)))
    return frozenset(found - {(0, 0)})


@pytest.mark.parametrize("h,w,r,T,g0", [
    (12, 16, 1, 2, 2), (8, 8, 1, 4, 4), (5, 9, 1, 2, 2), (4, 4, 1, 2, 2),
    (16, 12, 2, 3, 1), (10, 14, 1, 4, 2), (6, 7, 1, 3, 3), (20, 9, 2, 2, 1)])
def test_region_neighbours_are_the_cells_each_region_reads(h, w, r, T, g0):
    d, ext = r * T, r * (T - g0)
    regions = rdma.region_neighbours(h + 2 * ext, w + 2 * ext, d, ext)
    assert [(lab, rect) for lab, rect, _ in regions] == [
        (lab, rect) for lab, rect, _ in
        jrdma.overlap_region_slabs(h + 2 * ext, w + 2 * ext, d)]
    for label, rect, waits in regions:
        assert waits == _brute_neighbours(rect, h, w, r * g0, ext), label
        if label == "interior":
            assert waits == frozenset()
    if ext == 0:
        # The JAX wait set, closed under the diagonals: the port reads a
        # corner from the diagonal block the TPU reached in two hops.
        for (label, _, waits), (_, _, jwaits) in zip(
                regions, jrdma.overlap_region_slabs(h, w, d)):
            axes = {STEP[s] for s in jwaits}
            closed = axes | {(di, dj) for di, _ in axes for _, dj in axes
                             if di and dj}
            assert waits == frozenset(closed), label


def test_phase_order_schedule_is_the_jax_phases():
    sched = rdma.overlap_schedule(40, 40, 4, 0, partitioned=False)
    assert [lab for lab, _, _ in sched] == ["interior", "top", "bottom",
                                            "left", "right"]
    assert [len(w) for _, _, w in sched] == [0, 2, 2, 8, 8]
    part = rdma.overlap_schedule(40, 40, 4, 0)
    assert part == rdma.region_neighbours(40, 40, 4, 0)
    assert part[1][2] == {(-1, 0)} and part[3][2] == {
        (-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0)}


# ------------------------------------------------- the plain schedule, bytes


@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("boundary", ["zero", "periodic"])
@pytest.mark.parametrize("col_mode", ["strided", "packed"])
def test_plain_overlap_is_the_serialized_bytes_and_the_oracle(
        shape, boundary, col_mode):
    _, tf = _filters("blur3")
    x = _image(shape, boundary, seed=shape[0] * 7 + shape[1])
    for fuse in (1, 2, 4):
        want = oracle.run_serial_u8(x[0].astype(np.uint8), tf, 2 * fuse,
                                    boundary=boundary)
        ser = _run_slots(x, tf, shape, boundary, fuse, 2, col_mode=col_mode)
        np.testing.assert_array_equal(ser[0].numpy(), want)
        for partitioned in (True, False):
            got = _run_slots(x, tf, shape, boundary, fuse, 2,
                             col_mode=col_mode, overlap=True,
                             partitioned=partitioned)
            assert torch.equal(got, ser), (fuse, partitioned)


@pytest.mark.parametrize("shape,boundary", [((2, 2), "zero"),
                                            ((2, 4), "periodic")])
def test_plain_overlap_float_mode_within_tolerance(shape, boundary):
    _, tf = _filters("gaussian5")
    x = _image(shape, boundary, seed=5, channels=2)
    want = np.stack([oracle.run_serial_f32(c, tf, 4, boundary=boundary)
                     for c in x])
    for partitioned in (True, False):
        got = _run_slots(x, tf, shape, boundary, 2, 2, storage="f32",
                         quantize=False, overlap=True,
                         partitioned=partitioned)
        rtol, atol = stencil.float_tolerance(tf, 4, torch.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
        assert torch.equal(got, _run_slots(x, tf, shape, boundary, 2, 2,
                                           storage="f32", quantize=False))


def test_plain_overlap_block_with_empty_interior():
    # 5x6 blocks at depth 3: every pixel is rim, no interior region.
    _, tf = _filters("blur3")
    assert rdma.overlap_regions(5, 6, 3)[0] == []
    x = np.random.default_rng(9).integers(0, 256, (1, 10, 12)).astype(
        np.float32)
    want = oracle.run_serial_u8(x[0].astype(np.uint8), tf, 6)
    for partitioned in (True, False):
        got = _run_slots(x, tf, (2, 2), "zero", 3, 2, overlap=True,
                         partitioned=partitioned)
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_plain_overlap_deep_chunk_in_level_groups():
    # A 32-level edge5 chunk on 120x120 blocks: K4 with four level groups
    # on the card, so the region launches write a 48-pixel rim for K2.
    _, tf = _filters("edge5")
    plan = rdma.rdma_plan(2, 32, (120, 120))
    assert plan.kernel == "tiled" and len(plan.groups) > 1
    x = np.random.default_rng(11).integers(0, 256, (1, 238, 240)).astype(
        np.float32)
    ser = _run_slots(x, tf, (2, 2), "zero", 32, 1, storage="bf16")
    for cm in ("strided", "packed"):
        got = _run_slots(x, tf, (2, 2), "zero", 32, 1, storage="bf16",
                         overlap=True, col_mode=cm)
        assert torch.equal(got, ser), cm


def test_a_missed_wait_raises(monkeypatch):
    """Drop the up-left neighbour from the left band's waits: the band
    reads a corner ghost that was never filled, and the plain schedule
    raises instead of computing from it."""
    _, tf = _filters("blur3")
    x = _image((2, 2), "periodic", seed=4)
    full = rdma.overlap_schedule

    def missing_one(*a, **k):
        return [(lab, rect, w - {(-1, -1)} if lab == "left" else w)
                for lab, rect, w in full(*a, **k)]

    monkeypatch.setattr(rdma, "overlap_schedule", missing_one)
    with pytest.raises(RuntimeError, match="missed wait.*left region"):
        _run_slots(x, tf, (2, 2), "periodic", 2, 1, overlap=True)
    # The phase order waits on all eight before either column band.
    monkeypatch.setattr(rdma, "overlap_schedule", full)
    _run_slots(x, tf, (2, 2), "periodic", 2, 1, overlap=True)


# --------------------------------------------- against the JAX TPU kernels


def _jax_run(x, jf, shape, boundary, fuse, chunks, **kw):
    vhw = None if boundary == "periodic" else x.shape[1:]

    def body(v):
        def one(_, cur):
            return jrdma.fused_rdma_step(cur, jf, shape, boundary,
                                         quantize=True, fuse=fuse,
                                         valid_hw=vhw, overlap=True, **kw)
        return jax.lax.fori_loop(0, chunks, one, v)

    return np.asarray(jax.jit(shard_map(
        body, mesh=_jax_mesh(shape), in_specs=P(None, "x", "y"),
        out_specs=P(None, "x", "y"), check_vma=False))(x))


@pytest.mark.parametrize("boundary", ["zero", "periodic"])
def test_plain_overlap_matches_jax_tiled_overlapped_kernel(boundary):
    # JAX's test_overlap_tiled_protocol shape: 64x256 on 2x2, tile 16x128.
    jf, tf = _filters("blur3")
    x = np.random.default_rng(46).integers(0, 256, (1, 64, 256)).astype(
        np.float32)
    for fuse in (1, 2):
        want = _jax_run(x, jf, (2, 2), boundary, fuse, 2, tiled=True,
                        tile=(16, 128))
        got = _run_slots(x, tf, (2, 2), boundary, fuse, 2, storage="f32",
                         overlap=True)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 4)])
@pytest.mark.parametrize("partitioned", [True, False])
def test_plain_overlap_matches_jax_monolithic_overlapped_kernel(
        shape, partitioned):
    # Periodic only: the JAX monolithic overlapped kernel's zero mode is
    # the reference's known failure; zero mode is held against the port's
    # serialized form and the oracle above.
    jf, tf = _filters("blur3")
    x = _image(shape, "periodic", seed=13)
    for fuse in (1, 2):
        want = _jax_run(x, jf, shape, "periodic", fuse, 2, tiled=False,
                        partitioned=partitioned)
        got = _run_slots(x, tf, shape, "periodic", fuse, 2, storage="f32",
                         overlap=True, partitioned=partitioned)
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------ resolution, tuning


def test_resolve_overlap_clamps(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    slots, one = _slots((2, 2)), mesh.make_grid((2, 2), "cpu")
    assert step.resolve_overlap(None, "cuda_rdma", slots) is False
    assert step.resolve_overlap(False, "cuda_rdma", slots) is False
    step._OVERLAP_WARNED.clear()
    with pytest.warns(UserWarning, match="no overlapped halo pipeline"):
        assert step.resolve_overlap(True, "cuda", slots) is False
    with pytest.warns(UserWarning, match="CPU grid"):
        assert step.resolve_overlap(True, "cuda_rdma", slots) is False
    with warnings.catch_warnings():  # once a cause per process
        warnings.simplefilter("error")
        assert step.resolve_overlap(True, "cuda_rdma", slots) is False
    monkeypatch.setenv(ENV, "1")
    assert step.resolve_overlap(True, "cuda_rdma", slots) is True
    with pytest.warns(UserWarning, match="not slotted"):
        assert step.resolve_overlap(True, "cuda_rdma", one) is False
    assert step.overlap_clamp("cuda_rdma", slots) is None


def _gpu(w):
    return dataclasses.replace(w, platform="gpu",
                               device_kind="NVIDIA H100 80GB HBM3")


def test_overlap_legal_mirrors_the_regions_and_jax():
    for block in ((32, 32), (8, 8), (4, 64), (2, 2)):
        for r, T in ((1, 1), (1, 4), (2, 2)):
            want = bool(rdma.overlap_regions(*block, r * T)[0])
            assert costmodel.overlap_legal("cuda_rdma", (2, 2), block, r, T,
                                           True) == want
            assert want == jcostmodel.overlap_legal("pallas_rdma", (2, 2),
                                                    block, r, T)
            assert not costmodel.overlap_legal("cuda_rdma", (2, 2), block,
                                               r, T, False)
    assert not costmodel.overlap_legal("cuda", (2, 2), (64, 64), 1, 1, True)
    assert not costmodel.overlap_legal("cuda_rdma", (1, 1), (64, 64), 1, 1,
                                       True)


def test_predict_overlap_is_max_not_sum_plus_region_launches():
    hw = costmodel.H100
    shape, block, grid, k, T = (3, 1920, 2520), (960, 1260), (2, 2), 3, 32
    args = ("cuda_rdma", "bf16", T, None, shape, block, grid, k, False,
            True, hw)
    groups = costmodel.chunk_groups("cuda_rdma", T, None, block, 1)
    assert costmodel.overlap_launches(block, 1, T, groups) == 5
    assert costmodel.overlap_launches((32, 32), 1, 16, [16]) == 2  # no interior, no row band
    nbytes = costmodel.hbm_bytes_per_px_iter("cuda_rdma", "bf16", T, None,
                                             block, 1, k)
    ops = costmodel.ops_per_px_iter("cuda_rdma", T, None, block, k, False,
                                    True, 1, hw)
    compute = max(nbytes / (hw.hbm_gbps * 1e9), ops / (hw.tap_gops * 1e9))
    pixels = 3 * 4 * block[0] * block[1]
    for cm in ("strided", "packed"):
        ex = costmodel.slot_exchange_seconds_per_chunk(
            "cuda_rdma", grid, T, block, 1, "bf16", 3, hw, cm)
        host = costmodel.host_seconds_per_chunk(
            "cuda_rdma", grid, T, groups, k, True, "bf16", False, hw)
        slots = costmodel.slot_seconds_per_chunk(
            "cuda_rdma", grid, T, groups, block, 1, "bf16", 3, hw, cm)
        slots_ov = costmodel.slot_seconds_per_chunk(
            "cuda_rdma", grid, T, groups, block, 1, "bf16", 3, hw, cm,
            overlap=True)
        assert slots_ov - slots == pytest.approx(4 * 4 * hw.launch_s)
        serial = costmodel.predict_seconds_per_px_iter(
            *args, col_mode=cm, slotted=True)
        over = costmodel.predict_seconds_per_px_iter(
            *args, col_mode=cm, slotted=True, overlap=True)
        per = T * pixels
        assert serial == pytest.approx(
            compute + ex / per + (host + slots - ex) / per, rel=1e-12)
        assert over == pytest.approx(
            max(compute, ex / per) + (host + slots_ov - ex) / per,
            rel=1e-12)
    # Illegal requests price the serialized form: one device, or no
    # interior.
    assert costmodel.predict_seconds_per_px_iter(
        *args, overlap=True) == costmodel.predict_seconds_per_px_iter(*args)


def test_candidates_carry_overlap_only_where_legal(monkeypatch):
    _, tf = _filters("blur3")
    monkeypatch.delenv(ENV, raising=False)
    slots = _gpu(Workload.from_grid(_slots((2, 2)), tf, (1, 128, 128)))
    cands = search.enumerate_candidates(slots, hw=costmodel.H100)
    on = [c for c in cands if c.overlap]
    assert on and {c.backend for c in on} == {"cuda_rdma"}
    assert all(costmodel.overlap_legal("cuda_rdma", (2, 2), (64, 64), 1,
                                       c.fuse, True) for c in on)
    assert {c.fuse for c in on} == {1, 2, 4, 8, 16}  # 2·32 = the block
    one = _gpu(Workload.from_grid(mesh.make_grid((2, 2), "cpu"), tf,
                                  (1, 128, 128)))
    assert not any(c.overlap for c in search.enumerate_candidates(
        one, hw=costmodel.H100))
    cpu = Workload.from_grid(_slots((2, 2)), tf, (1, 128, 128))
    assert not any(c.overlap for c in search.enumerate_candidates(cpu))
    monkeypatch.setenv(ENV, "1")
    assert any(c.overlap for c in search.enumerate_candidates(cpu))
    monkeypatch.delenv(ENV)
    # Requests clamp to legality; ties rank the serialized form first.
    assert search._legal_overlaps(slots, "cuda_rdma", 32, True,
                                  costmodel.H100) == [False]
    assert search._legal_overlaps(slots, "cuda", 1, None,
                                  costmodel.H100) == [False]
    # 256 slots on one card: the region launches cost more than the
    # exchange they hide, so auto ranks overlap below the serialized run.
    many = _gpu(Workload.from_grid(_slots((16, 16)), tf, (1, 1920, 2520)))
    ranked = search.rank(many, search.enumerate_candidates(
        many, backends=["cuda_rdma"], fuses=[8], hw=costmodel.H100),
        costmodel.H100)
    assert not ranked[0][1].overlap and any(c.overlap for _, c in ranked)


# --------------------------------------------------------- entry points


def test_bench_row_stamps_the_resolved_overlap(monkeypatch):
    _, tf = _filters("blur3")
    kw = dict(grid=_slots((2, 2)), backend="cuda_rdma", fuse=2, reps=1)
    monkeypatch.delenv(ENV, raising=False)
    step._OVERLAP_WARNED.discard("cpu")
    with pytest.warns(UserWarning, match="CPU grid"):
        assert bench.bench_iterate((16, 16), tf, 2, overlap=True,
                                   **kw)["overlap"] is False
    monkeypatch.setenv(ENV, "1")
    assert bench.bench_iterate((16, 16), tf, 2, overlap=True,
                               **kw)["overlap"] is True
    assert bench.bench_iterate((16, 16), tf, 2, **kw)["overlap"] is False
    assert bench.bench_iterate((16, 16), tf, 2, device="cpu", reps=1,
                               backend="shifted")["overlap"] is False


@pytest.mark.parametrize("hatch", [True, False])
def test_cli_overlap_on_over_cpu_slots(tmp_path, capsys, monkeypatch, hatch):
    _, tf = _filters("blur3")
    img = imageio.generate_test_image(24, 36, "grey", seed=17)
    src, dst = tmp_path / "in.raw", tmp_path / "out.raw"
    imageio.write_raw(src, img)
    if hatch:
        monkeypatch.setenv(ENV, "1")
    else:
        monkeypatch.delenv(ENV, raising=False)
        step._OVERLAP_WARNED.discard("cpu")
    argv = ["run", str(src), "24", "36", "6", "grey", "-o", str(dst),
            "--device", "cpu,cpu,cpu,cpu", "--mesh", "2x2", "--backend",
            "cuda_rdma", "--fuse", "3", "--overlap", "on"]
    if hatch:
        assert cli_main(argv) == 0
    else:
        with pytest.warns(UserWarning, match="force-serialized"):
            assert cli_main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert ("overlapped halo pipeline" in line) == hatch
    np.testing.assert_array_equal(imageio.read_raw(dst, 24, 36, "grey"),
                                  oracle.run_serial_u8(img, tf, 6))
    assert cli_main(["bench", "24", "36", "3", "grey", "--device",
                     "cpu,cpu,cpu,cpu", "--mesh", "2x2", "--backend",
                     "cuda_rdma", "--overlap", "on", "--reps", "1"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["overlap"] is hatch
