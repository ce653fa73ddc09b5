"""The port's tuning package (``parallel_convolution_tpu_torch/tuning``) and
``backend="auto"`` against the JAX package's ``tuning`` on the CPU.

Same workloads through both: plan keys, buckets, the plan cache and its
fallback ladder, the cost model's arithmetic where the formula carried
over (with a pin and its reason for each term that was re-derived for the
card), ``resolve`` on a one-device CPU grid, and ``sharded_iterate`` /
the CLI with ``backend="auto"``.  Backend names map through
``BACKEND_FROM_REFERENCE``.  The kernels' legality is held against their
own planners (``stencil.fused_plan``, ``rdma.rdma_plan``) at the H100's
opt-in shared memory, 232,448 bytes.
"""

import dataclasses
import json
import math
import warnings

import jax
import numpy as np
import pytest

from parallel_convolution_tpu import tuning as jtuning
from parallel_convolution_tpu.ops import filters as jfilters
from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.parallel import step as jstep
from parallel_convolution_tpu.tuning import costmodel as jcost
from parallel_convolution_tpu.tuning import plans as jplans
from parallel_convolution_tpu_torch import convert, tuning
from parallel_convolution_tpu_torch.cli import main as cli_main
from parallel_convolution_tpu_torch.models import ConvolutionModel
from parallel_convolution_tpu_torch.ops import oracle, rdma, stencil
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh, step
from parallel_convolution_tpu_torch.tuning import (
    Plan, PlanCache, Workload, costmodel, plans, search,
)
from parallel_convolution_tpu_torch.utils import imageio
from parallel_convolution_tpu_torch.utils.config import BACKEND_FROM_REFERENCE

H100_OPTIN = 232448


def _jax_mesh(shape=(1, 1)):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _grid(shape=(1, 1)):
    return mesh.make_grid(shape, "cpu")


def _pair(shape=(1, 48, 64), grid=(2, 4), name="blur3", **kw):
    jf = jfilters.get_filter(name)
    tf = convert.filter_from_numpy(jf.name, jf.taps, jf.dyadic)
    return (jplans.Workload.from_mesh(_jax_mesh(grid), jf, shape, **kw),
            Workload.from_grid(_grid(grid), tf, shape, **kw))


def _gpu_workload(grid, shape, name, storage="bf16", quantize=True):
    f = get_filter(name)
    return Workload("gpu", "NVIDIA H100 80GB HBM3", grid, shape, name,
                    f.radius, f.size, f.separable() is not None, f.dyadic,
                    storage, quantize)


# ------------------------------------------------------------ plan keys
@pytest.mark.parametrize("kw", [{}, {"storage": "bf16"}, {"quantize": False},
                                {"boundary": "periodic"},
                                {"check_every": 5}])
@pytest.mark.parametrize("shape,grid", [((1, 48, 64), (2, 4)),
                                        ((3, 200, 300), (1, 1)),
                                        ((1, 8000, 8192), (2, 2))])
def test_plan_keys_match_jax(shape, grid, kw):
    jw, tw = _pair(shape, grid, **kw)
    assert tw.key_fields() == jw.key_fields()
    assert tw.key() == jw.key()
    assert tw.block_hw == jw.block_hw
    shuffled = dict(reversed(list(tw.key_fields().items())))
    assert plans.canonical_key(shuffled) == tw.key()


def test_bucket_matches_jax():
    for n in list(range(0, 70)) + [100, 127, 128, 129, 1920, 2520, 8000,
                                   8192, 8193]:
        assert plans._bucket(n) == jplans._bucket(n)


def test_plan_key_carries_full_identity():
    _, base = _pair()
    for field, val in [("storage", "bf16"), ("quantize", False),
                       ("boundary", "periodic"), ("platform", "gpu")]:
        assert dataclasses.replace(base, **{field: val}).key() != base.key()
    assert dataclasses.replace(base, shape=(1, 33, 64)).key() == base.key()
    assert dataclasses.replace(base, shape=(1, 100, 64)).key() != base.key()


# ------------------------------------------------- plan cache persistence
def test_plan_cache_atomic_roundtrip(tmp_path):
    _, w = _pair()
    cache = PlanCache()
    cache.put(w, Plan("cuda_rdma", fuse=4, tile=(64, 64), source="measured",
                      measured_gpx=1.25))
    path = str(tmp_path / "nested" / "plans.json")
    cache.save(path)
    assert [f.name for f in (tmp_path / "nested").iterdir()] == ["plans.json"]
    hit = PlanCache.load(path).best_plan(w)
    assert (hit.backend, hit.fuse, hit.tile, hit.source) == (
        "cuda_rdma", 4, (64, 64), "measured")


def test_plan_cache_corrupt_file_falls_back_empty(tmp_path):
    path = str(tmp_path / "plans.json")
    with open(path, "w") as f:
        f.write('{"schema": 1, "plans": {TRUNCATED')
    with pytest.warns(UserWarning, match="unusable plan file"):
        cache = PlanCache.load(path)
    assert len(cache) == 0 and cache.best_plan(_pair()[1]) is None


def test_plan_cache_wrong_schema_ignored(tmp_path):
    path = str(tmp_path / "plans.json")
    with open(path, "w") as f:
        json.dump({"schema": plans.PLAN_SCHEMA + 1, "plans": {"k": {}}}, f)
    with pytest.warns(UserWarning, match="schema"):
        assert len(PlanCache.load(path)) == 0


def test_plan_cache_malformed_record_skipped_not_fatal(tmp_path):
    _, w = _pair()
    path = str(tmp_path / "plans.json")
    with open(path, "w") as f:
        json.dump({"schema": plans.PLAN_SCHEMA,
                   "plans": {w.key(): {"fuse": 2}}}, f)  # no 'backend'
    cache = PlanCache.load(path)
    with pytest.warns(UserWarning, match="malformed plan record"):
        assert cache.best_plan(w) is None
    res = tuning.resolve(_grid((2, 4)), get_filter("blur3"), (1, 48, 64),
                         plans=cache)
    assert res.source == "predicted"


def test_fallback_ladder_matches_jax():
    """The same records give the same plan through both caches: exact,
    then nearest same-card bucket, then nearest grid, else None."""
    records = {}
    for shape, grid, backend, fuse in [((1, 200, 200), (2, 4), "xla_conv", 2),
                                       ((1, 2000, 2000), (2, 4), "shifted", 1),
                                       ((1, 48, 64), (1, 2), "separable", 4),
                                       ((3, 48, 64), (2, 4), "shifted", 8)]:
        jw, _ = _pair(shape, grid)
        records[jw.key()] = jplans.Plan(backend, fuse,
                                        source="measured").to_record(jw)
    jcache, tcache = jplans.PlanCache(), PlanCache()
    jcache.records, tcache.records = dict(records), dict(records)
    for shape, grid in [((1, 48, 64), (2, 4)), ((1, 200, 200), (2, 4)),
                        ((1, 48, 64), (4, 2)), ((3, 100, 100), (2, 4)),
                        ((1, 48, 64), (1, 1))]:
        jw, tw = _pair(shape, grid)
        jp, tp = jcache.best_plan(jw), tcache.best_plan(tw)
        if jp is None:
            assert tp is None
            continue
        assert (BACKEND_FROM_REFERENCE[jp.backend], jp.fuse, jp.tile,
                jp.source) == (tp.backend, tp.fuse, tp.tile, tp.source)


def test_jax_plan_file_loads_and_never_drives_the_card(tmp_path):
    """A plans file the JAX package wrote loads in the port without error;
    its records never resolve a 'gpu' workload (the platform is in the
    key), and a backend the port does not have is skipped as malformed."""
    path = str(tmp_path / "plans.json")
    jcache = jplans.PlanCache()
    jw, tw = _pair((1, 48, 64), (1, 1))
    jcache.put(jw, jplans.Plan("pallas", fuse=8, tile=(256, 512),
                               source="measured"))
    tpu = dataclasses.replace(jw, platform="tpu", device_kind="TPU v5e")
    jcache.put(tpu, jplans.Plan("pallas_sep", fuse=32, source="measured"))
    jcache.save(path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cache = PlanCache.load(path)  # no warning: the file is valid
    assert len(cache) == 2
    for gpu in (_gpu_workload((1, 1), (1, 48, 64), "blur3", "f32"),
                dataclasses.replace(tw, platform="gpu",
                                    device_kind="TPU v5e")):
        assert cache.best_plan(gpu) is None
    with pytest.warns(UserWarning, match="malformed plan record"):
        assert cache.best_plan(tw) is None  # 'pallas' is not the port's
    # ... and resolve() falls back to the model instead of dying.
    with pytest.warns(UserWarning, match="malformed plan record"):
        res = tuning.resolve(_grid(), get_filter("blur3"), (1, 48, 64),
                             plans=cache)
    assert res.source == "predicted" and res.backend == "shifted"


def test_plan_cache_merge_preserves_other_keys(tmp_path):
    path = str(tmp_path / "plans.json")
    (_, w1), (_, w2) = _pair(), _pair(shape=(1, 300, 300))
    a = PlanCache()
    a.put(w1, Plan("shifted", source="measured"))
    a.save(path)
    b = PlanCache()
    b.put(w2, Plan("cuda", fuse=8, source="measured"))
    b.merge_save(path)
    merged = PlanCache.load(path)
    assert len(merged) == 2 and merged.exact(w2).backend == "cuda"


# ------------------------------------------------------------ cost model
def test_carried_formulas_equal_jax():
    """rim_overhead and flops_per_px_iter carried over unchanged: equal to
    JAX's on the same arguments (the quantize at JAX's 2 slots)."""
    for T in (1, 2, 4, 8, 16, 32):
        for tile in [(64, 64), (32, 128), (256, 512), (120, 158)]:
            for r in (1, 2, 3):
                assert costmodel.rim_overhead(T, tile, r) == \
                    jcost.rim_overhead(T, tile, r)
                for k, sep in [(3, False), (3, True), (5, False), (7, True)]:
                    assert costmodel.flops_per_px_iter(
                        k, sep, False, T, tile, r) == jcost.flops_per_px_iter(
                        k, sep, False, T, tile, r)
                    assert costmodel.flops_per_px_iter(
                        k, sep, True, T, tile, r) == jcost.flops_per_px_iter(
                        k, sep, True, T, tile, r)
    assert costmodel.predict_gpx_per_chip(2e-10) == \
        jcost.predict_gpx_per_chip(2e-10)
    assert costmodel.INTERPRET_PENALTY == jcost.INTERPRET_PENALTY


def test_quantize_price_is_a_parameter():
    """Re-derived: the card rounds with rintf, priced by probe 5a, where
    the TPU's magic round cost JAX's fixed 2 slots."""
    base = costmodel.flops_per_px_iter(3, False, True, 8, (64, 64), 1)
    priced = costmodel.flops_per_px_iter(3, False, True, 8, (64, 64), 1,
                                         quantize_slots=5.0)
    assert priced - base == pytest.approx(
        3.0 * (1 + costmodel.rim_overhead(8, (64, 64), 1)))


def test_plain_backends_are_charged_their_eager_passes():
    """Re-derived: shifted / separable / xla_conv are eager PyTorch ops on
    the card, each tap a multiply and an add over the block, where the JAX
    model charged XLA's fused 4 B per iteration."""
    blk = (64, 64)
    pad = 4 * (1 + (66 * 66) / (64 * 64))
    got = costmodel.hbm_bytes_per_px_iter("shifted", "f32", 1, None, blk, 1,
                                          k=3, quantize=True)
    assert got == pytest.approx(pad + 4 + 20 * 9 + 16)
    conv = costmodel.hbm_bytes_per_px_iter("xla_conv", "f32", 1, None, blk,
                                           1, k=3, quantize=True)
    assert conv == pytest.approx(pad + 8 + 16)
    assert jcost.hbm_bytes_per_px_iter("shifted", "f32", 1, None, blk, 1) \
        == 16.0
    # The host model keeps JAX's charge, so a CPU grid ranks as JAX's.
    assert costmodel.hbm_bytes_per_px_iter(
        "shifted", "f32", 4, None, blk, 1, host=True) == 16.0


def test_exchange_on_one_card():
    """Re-derived: cuda / cuda_sep pay halo_exchange's padded copy per
    chunk (bytes) and six copies per block (host); cuda_rdma pays neither;
    one launch per chunk for the whole grid."""
    hw = costmodel.hardware_for("gpu", "NVIDIA H100 80GB HBM3")
    blk = (120, 158)
    k3 = costmodel.hbm_bytes_per_px_iter("cuda_rdma", "u8", 8, None, blk, 1,
                                         smem_limit=H100_OPTIN)
    assert k3 == pytest.approx(2.0 / 8)  # block in once, out once
    k2 = costmodel.hbm_bytes_per_px_iter("cuda", "u8", 8, None, blk, 1,
                                         smem_limit=H100_OPTIN)
    assert k2 > k3 + (1 + (136 * 174) / (120 * 158)) / 8 - 1e-12
    cuda16 = costmodel.host_seconds_per_chunk("cuda", (16, 16), 8, [8], 3,
                                              True, "u8", False, hw)
    cuda1 = costmodel.host_seconds_per_chunk("cuda", (1, 1), 8, [8], 3,
                                             True, "u8", False, hw)
    rdma16 = costmodel.host_seconds_per_chunk("cuda_rdma", (16, 16), 8, [8],
                                              3, True, "u8", False, hw)
    rdma1 = costmodel.host_seconds_per_chunk("cuda_rdma", (1, 1), 8, [8], 3,
                                             True, "u8", False, hw)
    assert cuda16 == pytest.approx(256 * cuda1)
    assert rdma16 == rdma1 == pytest.approx(hw.launch_s + 4 * hw.op_s)
    # Overlap and column mode are inert on one card: every candidate and
    # every resolution carries False and "packed".
    w = _gpu_workload((4, 4), (1, 2048, 2048), "blur3")
    cands = search.enumerate_candidates(w, hw=hw)
    assert {(c.overlap, c.col_mode) for c in cands} == {(False, "packed")}
    plan = search.tune(w, dry_run=True, hw=hw).plan
    assert (plan.overlap, plan.col_mode) == (False, "packed")


def test_legality_and_plans_come_from_the_planners():
    """Re-derived: the tile and depth the model prices are the kernels'
    own (fused_plan / rdma_plan against shared memory), not VMEM."""
    for blk, r, T in [((960, 1260), 1, 32), ((2048, 2048), 2, 32),
                      ((120, 158), 1, 8), ((100, 100), 1, 32)]:
        plan = rdma.rdma_plan(r, T, blk, None, H100_OPTIN)
        assert costmodel.rdma_is_tiled(blk, r, T, H100_OPTIN) == (
            plan.kernel == "tiled")
        assert costmodel.chunk_groups("cuda_rdma", T, None, blk, r,
                                      H100_OPTIN) == plan.groups
        assert costmodel.chunk_groups("cuda", T, None, blk, r, H100_OPTIN) \
            == stencil.fused_plan(r, T, blk, None, H100_OPTIN)[2]
    assert costmodel.effective_tile("cuda", None, (960, 1260), 1, 1) == \
        stencil.STEP_TILE
    assert costmodel.effective_tile("shifted", (64, 64), (960, 1260), 1,
                                    8) is None


def test_legality_follows_the_one_buffer_layout():
    """A pinned tile is legal for K2 exactly when ONE f32 buffer of its
    level-0 window fits (the levels run in place): 200x200 at r = 1 (163 KB)
    is legal, where two buffers (326 KB) were not; 240x240 (236 KB) is
    not."""
    hw = dataclasses.replace(costmodel.hardware_for("gpu", "card"),
                             smem_optin=H100_OPTIN)
    w = _gpu_workload((1, 1), (1, 2048, 2048), "blur3")
    for tile, legal in (((200, 200), True), ((240, 240), False)):
        assert (stencil.fused_smem_bytes(1, 1, tile) <= H100_OPTIN) == legal
        got = search._legal_tiles(w, "cuda", [tile], strict=True, fuse=2,
                                  hw=hw)
        assert got == ([tile] if legal else [])


def test_quantize_price_follows_the_round_mode():
    """Filters under the magic round's L1 bound pay quantize_slots, those
    above it rint_quantize_slots (probe 5a's two rows)."""
    from parallel_convolution_tpu_torch.ops.filters import make_filter

    hw = costmodel.H100
    assert hw.rint_quantize_slots > hw.quantize_slots > 0
    assert costmodel.quantize_price(hw, True) == hw.quantize_slots
    assert costmodel.quantize_price(hw, False) == hw.rint_quantize_slots
    big = make_filter("big3", np.full((3, 3), 1000.0))
    grid = mesh.make_grid(device="cpu")
    assert Workload.from_grid(grid, get_filter("blur3"),
                              (1, 64, 64)).magic_round
    w = Workload.from_grid(grid, big, (1, 64, 64))
    assert not w.magic_round
    wm = dataclasses.replace(w, magic_round=True)
    c = search.Candidate("cuda", 8, (64, 64))
    gpu = costmodel.hardware_for("gpu", "card")
    assert search.predict(w, c, gpu) > search.predict(wm, c, gpu)


def test_tile_menu_is_accepted_by_the_planners():
    for tile in search.TILE_MENU:
        for r in range(1, stencil.MAX_K // 2 + 1):
            stencil.fused_plan(r, 1, (4096, 4096), tile, H100_OPTIN)
    assert stencil.STEP_TILE in search.TILE_MENU
    assert stencil.FUSED_TILE in search.TILE_MENU


def test_card_model_prefers_the_kernels():
    """On the card model a CUDA backend wins at each grid chip_smoke.py
    drives auto on, and cuda_rdma wins the 256-block grid (its one launch
    per chunk against 256 halo exchanges and launches)."""
    hw = costmodel.hardware_for("gpu", "NVIDIA H100 80GB HBM3")
    for grid, shape, name, st in [((1, 1), (3, 1920, 2520), "blur3", "bf16"),
                                  ((2, 2), (3, 1920, 2520), "blur3", "bf16"),
                                  ((16, 16), (1, 1920, 2520), "blur3", "u8")]:
        w = _gpu_workload(grid, shape, name, st)
        best = search.tune(w, dry_run=True, hw=hw).plan
        assert best.backend in costmodel.CUDA_BACKENDS, (grid, best)
        if grid == (16, 16):
            assert best.backend == "cuda_rdma"


# ------------------------------------------------------- legality sweep
def _planner_accepts(w, backend, T, tile):
    r, k = w.radius, w.taps_k
    try:
        if backend == "cuda_rdma":
            rdma.rdma_plan(r, T, w.block_hw, tile, H100_OPTIN)
        elif T == 1:
            th, tw = tile if tile is not None else stencil.STEP_TILE
            th, tw = min(th, w.block_hw[0]), min(tw, w.block_hw[1])
            size = costmodel.STORAGE_BYTES[w.storage]
            return stencil.step_smem_bytes(k, (th, tw), size,
                                           size) <= H100_OPTIN
        else:
            stencil.fused_plan(r, T, w.block_hw, tile, H100_OPTIN)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("name", ["blur3", "gaussian5", "edge5", "dyadic7"])
@pytest.mark.parametrize("storage", ["f32", "bf16", "u8"])
def test_no_drift_between_enumeration_and_planners(name, storage):
    """Every candidate the search admits passes the planner of the launch
    it makes, and every one it rejects fails it — except tiles larger
    than the block (clamped duplicates) and tiles for K3 (which takes the
    whole block), which the search drops as duplicates of None."""
    hw = dataclasses.replace(costmodel.hardware_for("gpu", "card"),
                             smem_optin=H100_OPTIN)
    tiles = list(search.TILE_MENU) + [(256, 256), (16, 512), (180, 180),
                                      (8, 8)]
    checked = 0
    for grid, shape in [((1, 1), (3, 1920, 2520)), ((4, 4), (1, 8192, 8192)),
                        ((16, 16), (1, 1920, 2520)), ((2, 2), (1, 200, 260))]:
        w = _gpu_workload(grid, shape, name if name != "dyadic7" else "blur3",
                          storage)
        if name == "dyadic7":
            w = dataclasses.replace(w, filter_name="dyadic7", radius=3,
                                    taps_k=7, separable=False)
        for backend in costmodel.CUDA_BACKENDS:
            for T in search._legal_fuses(w, backend, search.FUSE_MENU):
                k3 = (backend == "cuda_rdma" and not costmodel.rdma_is_tiled(
                    w.block_hw, w.radius, T, H100_OPTIN))
                for tile in tiles:
                    admitted = tile in search._legal_tiles(
                        w, backend, [tile], strict=True, fuse=T, hw=hw)
                    big = tile is not None and (tile[0] > w.block_hw[0]
                                                or tile[1] > w.block_hw[1])
                    if k3 or big:
                        assert admitted == (tile is None)
                        continue
                    assert admitted == _planner_accepts(w, backend, T, tile), (
                        backend, T, tile, w.block_hw)
                    checked += 1
    assert checked > 100


# ------------------------------------------------------- resolve on CPU
RESOLVE_CASES = [((1, 48, 64), "f32", "blur3"), ((3, 40, 56), "bf16", "edge5"),
                 ((1, 37, 53), "u8", "gaussian5"), ((3, 24, 36), "u8", "blur3"),
                 ((1, 64, 64), "f32", "sharpen3")]


@pytest.mark.parametrize("shape,storage,name", RESOLVE_CASES)
def test_resolve_on_cpu_matches_jax(shape, storage, name):
    jf = jfilters.get_filter(name)
    tf = convert.filter_from_numpy(jf.name, jf.taps, jf.dyadic)
    a = tuning.resolve(_grid(), tf, shape, storage=storage,
                       plans=PlanCache())
    b = tuning.resolve(_grid(), tf, shape, storage=storage,
                       plans=PlanCache())
    j = jtuning.resolve(_jax_mesh(), jf, shape, storage=storage,
                        plans=jtuning.PlanCache())
    assert a == b  # deterministic
    assert (a.backend, a.fuse, a.tile, a.source, a.predicted_gpx, a.key,
            a.overlap, a.col_mode) == (
        BACKEND_FROM_REFERENCE[j.backend], j.fuse, j.tile, j.source,
        j.predicted_gpx, j.key, j.overlap, j.col_mode)
    assert tuning.last_resolution() == a


def test_resolve_pins_and_illegal_pins():
    tf, jf = get_filter("blur3"), jfilters.get_filter("blur3")
    a = tuning.resolve(_grid(), tf, (1, 48, 64), fuse=4, tile=(32, 64),
                       plans=PlanCache())
    j = jtuning.resolve(_jax_mesh(), jf, (1, 48, 64), fuse=4, tile=(32, 64),
                        plans=jtuning.PlanCache())
    assert (a.backend, a.fuse, a.tile) == (j.backend, j.fuse, j.tile) == (
        "shifted", 4, (32, 64))
    with pytest.raises(ValueError, match="no legal candidates"):
        tuning.resolve(_grid(), tf, (1, 48, 64), fuse=64, plans=PlanCache())
    with pytest.raises(ValueError, match="no legal candidates"):
        jtuning.resolve(_jax_mesh(), jf, (1, 48, 64), fuse=64,
                        plans=jtuning.PlanCache())
    cache = PlanCache()
    cache.put(Workload.from_grid(_grid(), tf, (1, 48, 64)),
              Plan("shifted", fuse=2, source="measured"))
    with pytest.raises(ValueError, match="no legal candidates"):
        tuning.resolve(_grid(), tf, (1, 48, 64), fuse=64, plans=cache)
    with pytest.raises(ValueError, match="no legal candidates"):
        search.enumerate_candidates(_gpu_workload((1, 1), (1, 48, 64),
                                                  "blur3"),
                                    backends=["cuda"], tiles=[(1000, 100)])
    res = tuning.resolve(_grid(), tf, (1, 48, 64), plans=cache)
    assert (res.backend, res.fuse, res.source) == ("shifted", 2, "measured")


def test_interpolated_plan_clamps_illegal_fuse():
    tf = get_filter("blur3")
    cache = PlanCache()
    cache.put(Workload.from_grid(_grid((2, 4)), tf, (1, 2000, 2000)),
              Plan("cuda", fuse=32, tile=(128, 128), source="measured"))
    res = tuning.resolve(_grid((2, 4)), tf, (1, 48, 64), plans=cache)
    assert res.source == "interpolated" and res.backend == "cuda"
    assert res.fuse * tf.radius <= 16 and res.tile is None


# ------------------------------------------------ backend="auto" end to end
@pytest.mark.parametrize("grid_shape,storage", [((1, 1), "f32"),
                                                ((2, 2), "u8"),
                                                ((1, 4), "bf16")])
def test_sharded_iterate_auto_matches_oracle_and_jax(grid_shape, storage):
    jf = jfilters.get_filter("blur3")
    tf = convert.filter_from_numpy(jf.name, jf.taps, jf.dyadic)
    img = imageio.generate_test_image(37, 53, "grey", seed=4)
    x = img[None].astype(np.float32)
    got = step.sharded_iterate(x, tf, 5, grid=_grid(grid_shape),
                               backend="auto", fuse=None, storage=storage,
                               device="cpu")
    want = np.asarray(jstep.sharded_iterate(
        x, jf, 5, _jax_mesh(grid_shape), backend="auto", fuse=None,
        storage=storage))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[0].astype(np.uint8),
                                  oracle.run_serial_u8(img, tf, 5))


def test_model_auto_records_resolution(tmp_path, monkeypatch):
    img = imageio.generate_test_image(24, 36, "rgb", seed=5)
    model = ConvolutionModel("blur3", backend="auto", fuse=None,
                             device="cpu")
    out = model.run_image(img, 3)
    np.testing.assert_array_equal(out, oracle.run_serial_u8(
        img, get_filter("blur3"), 3))
    assert model.plan_source == "predicted"
    assert model.effective_backend == model.resolution.backend == "shifted"
    # A measured plan in PCTPU_PLAN_FILE drives the next run.
    path = tmp_path / "plans.json"
    cache = PlanCache()
    cache.put(Workload.from_grid(_grid(), get_filter("blur3"), (3, 24, 36)),
              Plan("xla_conv", fuse=2, source="measured"))
    cache.save(str(path))
    monkeypatch.setenv(plans.PLAN_FILE_ENV, str(path))
    out2 = model.run_image(img, 3)
    np.testing.assert_array_equal(out2, out)
    assert (model.effective_backend, model.effective_fuse,
            model.plan_source) == ("xla_conv", 2, "measured")
    with pytest.raises(ValueError, match="fuse=None means 'tune it'"):
        ConvolutionModel("blur3", backend="cuda", fuse=None, device="cpu")


def test_cli_run_auto(tmp_path, capsys):
    img = imageio.generate_test_image(30, 41, "grey", seed=6)
    src, dst = tmp_path / "in.raw", tmp_path / "out.raw"
    imageio.write_raw(src, img)
    rc = cli_main(["run", str(src), "30", "41", "4", "grey", "-o", str(dst),
                   "--backend", "auto", "--device", "cpu"])
    assert rc == 0
    assert "auto resolved to shifted [predicted]" in capsys.readouterr().out
    np.testing.assert_array_equal(imageio.read_raw(dst, 30, 41, "grey"),
                                  oracle.run_serial_u8(
                                      img, get_filter("blur3"), 4))


def test_cli_tune_dry_run_emits_and_verifies(tmp_path, capsys, monkeypatch):
    out = tmp_path / "plans.json"
    rc = cli_main(["tune", "--rows", "48", "--cols", "64", "--mesh", "2x2",
                   "--device", "cpu", "--dry-run", "--emit-plans", "--out",
                   str(out), "--verify-auto"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["auto_ok"] is True and summary["errors"] == 0
    assert summary["plan"]["source"] == "predicted"
    assert summary["workload"]["platform"] == "cpu"
    assert summary["plans_in_file"] == 1
    # The file is one the JAX package's cache reads too.
    assert len(jplans.PlanCache.load(str(out))) == 1
    monkeypatch.setenv(plans.PLAN_FILE_ENV, str(out))
    res = tuning.resolve(_grid((2, 2)), get_filter("blur3"), (1, 48, 64))
    assert res.backend == summary["plan"]["backend"]
    with pytest.raises(SystemExit):  # --verify-auto needs --emit-plans
        cli_main(["tune", "--rows", "8", "--cols", "8", "--device", "cpu",
                  "--verify-auto"])


@pytest.mark.parametrize("fault", [ValueError, RuntimeError])
def test_tune_fault_writes_no_plan(tmp_path, monkeypatch, capsys, fault):
    """A planner's refusal (ValueError) is an error row, and the tune then
    writes no plan and exits 1; any other failure (a launch error, a lost
    context) propagates out of the tune, and the CLI exits 2."""
    real, calls = search.measure, []

    def first_fails(w, c, grid, **kw):
        calls.append(c)
        if len(calls) == 1:
            raise fault("refused")
        return real(w, c, grid, **kw)

    monkeypatch.setattr(search, "measure", first_fails)
    out = tmp_path / "plans.json"
    argv = ["tune", "--rows", "24", "--cols", "36", "--device", "cpu",
            "--iters", "1", "--max-measure", "2", "--emit-plans", "--out",
            str(out)]
    if fault is RuntimeError:
        w = Workload.from_grid(_grid(), get_filter("blur3"), (1, 24, 36))
        with pytest.raises(RuntimeError, match="refused"):
            search.tune(w, _grid(), iters=1, max_measure=2)
        calls.clear()
        assert cli_main(argv) == 2
        assert "error: refused" in capsys.readouterr().err
    else:
        assert cli_main(argv) == 1
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert (summary["errors"], summary["measured_points"]) == (1, 1)
        assert "plan_file" not in summary
    assert len(calls) >= 1 and not out.exists()


def test_bench_iterate_row_on_cpu():
    from parallel_convolution_tpu_torch.utils import bench

    row = bench.bench_iterate((24, 36), get_filter("blur3"), 2,
                              grid=_grid((2, 2)), backend="auto", fuse=None,
                              reps=1)
    assert row["device"] == "cpu" and row["platform"] == "cpu"
    assert row["backend"] == "auto" and row["effective_backend"] == "shifted"
    assert row["plan_source"] == "predicted" and row["seconds"] > 0
    assert math.isfinite(row["predicted_gpx_per_chip"])
    explicit = bench.bench_iterate((24, 36), get_filter("blur3"), 2,
                                   grid=_grid(), backend="cuda", fuse=2,
                                   reps=1)
    assert explicit["plan_source"] == "explicit"
    assert explicit["tile"] == [24, 36]  # FUSED_TILE clamped to the block
