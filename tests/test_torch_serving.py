"""The warm engine and the micro-batcher (ROADMAP item 8a's in-process
core) in the port, held against the JAX package's on the CPU.

The same seeded inputs go through the port's ``WarmEngine`` on a CPU grid
and the JAX package's on its 8-device CPU mesh, the backends mapped
(``utils.config.BACKEND_FROM_REFERENCE``; JAX's Pallas kernels in
interpret mode):

* ``run_batch`` outputs: u8 mode byte-equal (and the oracle's bytes),
  float mode within ``ops/stencil.float_tolerance``; volumes within 2e-5;
* ``stats`` after the same request sequence (hit, miss, a batch size's
  build, LRU eviction at ``capacity=1``, single flight across threads);
* key validation errors of the same type; ``reshape`` info (re-warmed,
  skipped) and the stale-key guard; the degrade walk under
  ``backend_compile:1``; ``bucket_extent`` / ``bucket_key``;
* converge stream rows (Jacobi and multigrid, and a resumed stream);
* the batcher's coalescing, lanes, deadline flush, queue-full and close
  behaviour through both batchers.

The engine's kernels themselves run on the card (``chip_smoke.py`` phase
4l); here a kernel backend runs its plain version because the grid is on
the CPU.
"""

import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch
from _torch_jax_state import reset_jax_state

from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.resilience import faults as jfaults
from parallel_convolution_tpu.serving import batcher as jbatcher
from parallel_convolution_tpu.serving import engine as jengine
from parallel_convolution_tpu_torch.obs import events, metrics
from parallel_convolution_tpu_torch.ops import oracle, stencil
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh, step
from parallel_convolution_tpu_torch.resilience import degrade, faults
from parallel_convolution_tpu_torch.serving import (
    EngineKey, MicroBatcher, WarmEngine, batcher, bucket_extent, bucket_key,
)
from parallel_convolution_tpu_torch.solvers import multigrid
from parallel_convolution_tpu_torch.utils import imageio
from parallel_convolution_tpu_torch.utils.config import BACKEND_FROM_REFERENCE

JAX_NAME = {v: k for k, v in BACKEND_FROM_REFERENCE.items()}
BACKENDS = ["shifted", "xla_conv", "separable", "cuda", "cuda_sep",
            "cuda_rdma"]


@pytest.fixture(autouse=True)
def _clean_state():
    faults.uninstall_plan()
    degrade.clear_probe_cache()
    yield
    faults.uninstall_plan()
    degrade.clear_probe_cache()
    reset_jax_state()


def _jax_mesh(shape=(2, 2)):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


def _slots(shape=(2, 2)):
    return mesh.make_grid(shape, devices=["cpu"] * (shape[0] * shape[1]))


def _grid(backend, shape=(2, 2)):
    """``cuda_rdma`` on CPU slots (its per-slot form), the rest on the
    one-device grid."""
    return (_slots(shape) if backend == "cuda_rdma"
            else mesh.make_grid(shape, "cpu"))


def _img(h=24, w=36, mode="grey", seed=1):
    return imageio.generate_test_image(h, w, mode, seed=seed)


def _planar(img):
    return imageio.interleaved_to_planar(img).astype(np.float32)


def _pair(backend="shifted", shape=(2, 2), **kw):
    """A port engine and a JAX engine on grids of ``shape``."""
    return (WarmEngine(_grid(backend, shape), **kw),
            jengine.WarmEngine(_jax_mesh(shape), **kw))


# ---------------------------------------------------------------- batching
@pytest.mark.parametrize("backend", BACKENDS)
def test_run_batch_bytes_equal_jax_and_oracle(backend):
    """A batch of three distinct images (B·C planes folded): each image
    the JAX engine's bytes at the mapped backend, the oracle's, and one
    request's alone."""
    filt = get_filter("blur3")
    imgs = [_img(32, 48, seed=s) for s in (1, 2, 3)]
    x = np.stack([_planar(im) for im in imgs])
    eng, jeng = _pair(backend, fallback=False)
    key = eng.key_for((1, 32, 48), iters=2, backend=backend, fuse=2)
    jkey = jeng.key_for((1, 32, 48), iters=2, backend=JAX_NAME[backend],
                        fuse=2)
    out, info = eng.run_batch(key, x)
    jout, jinfo = jeng.run_batch(jkey, x)
    np.testing.assert_array_equal(out, jout)
    for b, im in enumerate(imgs):
        np.testing.assert_array_equal(
            out[b, 0], oracle.run_serial_u8(im, filt, 2))
    one, _ = eng.run_batch(key, x[1:2])
    np.testing.assert_array_equal(one[0], out[1])
    assert info["effective_backend"] == backend
    assert info["effective_grid"] == jinfo["effective_grid"] == "2x2"
    assert info["batch_size"] == 3
    assert set(info) == set(jinfo)
    assert set(info["phases"]) == {"compile", "copy_in", "device",
                                   "copy_out"}


@pytest.mark.parametrize("backend", ["cuda", "cuda_sep", "cuda_rdma"])
def test_run_batch_float_mode_within_tolerance_of_jax(backend):
    rng = np.random.default_rng(3)
    x = rng.random((2, 3, 20, 28), dtype=np.float32)
    eng, jeng = _pair(backend, fallback=False)
    kw = dict(filter_name="gaussian5", iters=3, quantize=False, fuse=3)
    out, _ = eng.run_batch(eng.key_for((3, 20, 28), backend=backend, **kw),
                           x)
    jout, _ = jeng.run_batch(jeng.key_for((3, 20, 28),
                                          backend=JAX_NAME[backend], **kw), x)
    rtol, atol = stencil.float_tolerance(get_filter("gaussian5"), 3,
                                         torch.float32)
    np.testing.assert_allclose(out, jout, rtol=rtol, atol=atol)


def test_run_batch_rgb_bf16_storage_matches_oracle():
    img = _img(24, 30, mode="rgb", seed=7)
    eng = WarmEngine(device="cpu", fallback=False)
    key = eng.key_for((3, 24, 30), iters=3, backend="cuda_sep",
                      storage="bf16", fuse=3)
    out, _ = eng.run_batch(key, _planar(img)[None])
    want = oracle.run_serial_u8(img, get_filter("blur3"), 3)
    np.testing.assert_array_equal(
        out[0].transpose(1, 2, 0).astype(np.uint8), want)


# ---------------------------------------------------------------- the cache
def test_stats_equal_jax_after_the_same_sequence():
    """Miss, hit, a second batch size's build, LRU eviction at capacity 1
    and the rebuild: the same stats dict in both engines."""
    eng, jeng = _pair(capacity=1, fallback=False)
    x = _planar(_img())[None]
    for e in (eng, jeng):
        k1 = e.key_for((1, 24, 36), filter_name="blur3", iters=1)
        k2 = e.key_for((1, 24, 36), filter_name="box3", iters=1)
        e.run_batch(k1, x)
        e.run_batch(k1, x)                       # warm
        e.run_batch(k1, np.concatenate([x, x]))  # batch size 2 builds
        e.entry(k2)                              # evicts k1
        e.entry(k1)                              # cold again
        e.warmup([k1])
    assert dict(eng.stats) == dict(jeng.stats)
    assert eng.stats["evictions"] == 2 and eng.stats["compiles"] == 4
    assert ([r["filter"] for r in eng.snapshot()["resident"]]
            == [r["filter"] for r in jeng.snapshot()["resident"]]
            == ["blur3"])


def test_single_flight_cold_key_builds_once_like_jax():
    for e in _pair(fallback=False):
        key = e.key_for((1, 26, 34), filter_name="gaussian5", iters=1)
        barrier = threading.Barrier(4)
        errors = []

        def worker():
            try:
                barrier.wait(timeout=10)
                e.entry(key)
            except Exception as err:  # noqa: BLE001
                errors.append(err)

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors
        assert e.stats["compiles"] == 1 and e.stats["misses"] == 1
        assert e.stats["hits"] + e.stats["single_flight_waits"] == 3


@pytest.mark.parametrize("bad", [
    dict(backend="nope"), dict(storage="u8", quantize=False),
    dict(storage="f64"), dict(boundary="reflect"), dict(filter_name="nah"),
    dict(solver="multigrid"), dict(solver="sor", quantize=False),
    dict(mg_levels=0), dict(tile=(0, 8)), dict(iters=0),
])
def test_key_validation_raises_like_jax(bad):
    eng, jeng = _pair(fallback=False)
    jbad = dict(bad, backend=JAX_NAME.get(bad.get("backend"),
                                          bad.get("backend", "shifted")))
    errors = []
    for e, kw in ((eng, bad), (jeng, jbad)):
        try:
            e.key_for((1, 24, 36), **kw).validate()
        except Exception as err:  # noqa: BLE001
            errors.append(type(err))
        else:
            errors.append(None)
    assert errors[0] is not None and errors[0] is errors[1]


def test_key_validation_names_the_port_backend_for_jax_names():
    for jname, name in BACKEND_FROM_REFERENCE.items():
        if jname != name:
            with pytest.raises(ValueError, match=f"is '{name}' here"):
                EngineKey((1, 8, 8), backend=jname).validate()
            EngineKey((1, 8, 8), backend=name).validate()


def test_run_batch_shape_checks_like_jax():
    for e in _pair(fallback=False):
        key = e.key_for((1, 24, 36))
        with pytest.raises(ValueError, match="does not match"):
            e.run_batch(key, np.zeros((1, 1, 8, 8), np.float32))
        with pytest.raises(ValueError, match="fuse=None"):
            e.key_for((1, 24, 36), fuse=None)


def test_engine_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default grid is on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WarmEngine()
    with pytest.raises(ValueError, match="grid is on"):
        WarmEngine(mesh.make_grid((1, 1), "cpu"), device="cuda")
    assert WarmEngine(device="cpu").grid.device.type == "cpu"


# ---------------------------------------------------------------- reshape
def test_reshape_info_and_stale_guard_equal_jax(grey_small):
    """JAX's serve-through-shrink test through both engines: the key that
    has no home on 4x2 is skipped with a warning, the others re-warmed, and
    an old-grid key raises."""
    results = []
    for e, grid in ((WarmEngine(_slots((1, 2)), fallback=False), _slots((4, 2))),
                    (jengine.WarmEngine(_jax_mesh((1, 2)), fallback=False),
                     _jax_mesh((4, 2)))):
        key_small = e.key_for((1, 3, 40), filter_name="gaussian5", iters=2)
        key_ok = e.key_for((1, 24, 36), filter_name="blur3", iters=2)
        imgs = _planar(grey_small)[None]
        before, _ = e.run_batch(key_ok, imgs)
        e.entry(key_small)
        with pytest.warns(UserWarning, match="no home"):
            info = e.reshape(grid)
        with pytest.raises(ValueError, match="stale"):
            e.run_batch(key_ok, imgs)
        after, ainfo = e.run_batch(e.key_for((1, 24, 36), iters=2), imgs)
        np.testing.assert_array_equal(after, before)
        assert ainfo["effective_grid"] == "4x2"
        results.append((info, dict(e.stats)))
    assert results[0] == results[1]
    assert results[0][0] == {"old_grid": (1, 2), "grid": (4, 2),
                             "rewarmed": 1, "skipped": 1}


def test_reshape_by_spec_keeps_the_grid_form_and_emits(tmp_path, grey_small):
    metrics.set_enabled(True)
    events.configure(tmp_path / "ev.jsonl")
    try:
        eng = WarmEngine(_slots((2, 2)), fallback=False)
        key = eng.key_for((1, 24, 36), iters=2, backend="cuda_rdma")
        eng.run_batch(key, _planar(grey_small)[None])
        info = eng.reshape("1x1")
        assert info["rewarmed"] == 1 and eng.grid.slotted
        assert eng.grid.shape == (1, 1)
        rec = [r for r in events.read_events(tmp_path / "ev.jsonl")
               if r["kind"] == "reshape"]
        assert rec and rec[0]["old_grid"] == "2x2" and rec[0]["grid"] == "1x1"
    finally:
        events.deconfigure()


# ---------------------------------------------------------------- degrade
@pytest.mark.parametrize("backend", ["cuda", "cuda_rdma"])
def test_compile_fault_walks_the_mapped_ladder(backend):
    """``backend_compile:1`` eats the requested tier's probe in both
    engines: the effective backends are each other's names."""
    img = _img(26, 38, seed=5)
    want = oracle.run_serial_u8(img, get_filter("blur3"), 3)
    got = []
    for e, b, inj in ((WarmEngine(_grid(backend), fallback=True), backend,
                       faults.injected),
                      (jengine.WarmEngine(_jax_mesh(), fallback=True),
                       JAX_NAME[backend], jfaults.injected)):
        with inj("backend_compile:1"):
            with pytest.warns(Warning, match="degraded"):
                out, info = e.run_batch(e.key_for((1, 26, 38), iters=3,
                                                  backend=b),
                                        _planar(img)[None])
        np.testing.assert_array_equal(out[0, 0], want)
        got.append((info["effective_backend"], e.degraded()))
    (eff, deg), (jeff, jdeg) = got
    assert eff == BACKEND_FROM_REFERENCE[jeff]
    assert eff == {"cuda": "shifted", "cuda_rdma": "cuda"}[backend]
    assert deg == [{"requested": backend, "effective": eff}]
    assert jdeg == [{"requested": JAX_NAME[backend], "effective": jeff}]


# ---------------------------------------------------------------- converge
@pytest.mark.parametrize("backend", ["cuda", "cuda_rdma"])
def test_converge_rows_equal_jax_and_resume(backend):
    """Jacobi to tol through both engines (quantize mode: the bytes, the
    counts and the diffs equal; the JAX side at ``pallas`` / its normative
    ``shifted``), then a stream resumed from the fourth row's token: the
    uninterrupted stream's tail."""
    x = _planar(_img(30, 44, seed=9))
    eng, jeng = _pair(backend, fallback=False)
    jb = "pallas" if backend == "cuda" else "shifted"
    kw = dict(filter_name="blur3", iters=10, fuse=4)
    key = eng.key_for(x.shape, backend=backend, **kw)
    jkey = jeng.key_for(x.shape, backend=jb, **kw)
    run = dict(tol=0.5, max_iters=120, check_every=10)
    rows = list(eng.run_converge(key, x, **run))
    jrows = list(jeng.run_converge(jkey, x, **run))
    assert [r[1:] for r in rows] == [r[1:] for r in jrows]
    for r, jr in zip(rows, jrows):
        np.testing.assert_array_equal(r[0], np.asarray(jr[0]))
    ref = list(step.sharded_converge_stream(
        x, get_filter("blur3"), 0.5, 120, 10, grid=eng.grid, quantize=True,
        backend=backend, fuse=4))
    assert [r[1:3] for r in rows] == [r[1:] for r in ref]
    img, done, diff, _ = rows[3]
    tail = list(eng.run_converge(key, img, start_done=done,
                                 start_diff=diff, **run))
    assert [r[1:] for r in tail] == [r[1:] for r in rows[4:]]
    np.testing.assert_array_equal(tail[-1][0], rows[-1][0])
    assert list(eng.run_converge(key, img, start_done=done,
                                 start_diff=0.1, **run)) == []
    assert eng.stats["compiles"] == jeng.stats["compiles"]


def test_multigrid_rows_equal_jax_resume_and_stay_warm(tmp_path):
    """The V-cycle through both engines: cycles and work units equal,
    fields and residuals within the multigrid tolerance; a resumed stream
    continues the counts; a second stream of the key builds no level
    program (no ``compile`` event)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 30, 44)).astype(np.float32)
    eng, jeng = _pair("cuda", fallback=False)
    kw = dict(filter_name="jacobi3", iters=10, quantize=False,
              solver="multigrid")
    key = eng.key_for(x.shape, backend="cuda", **kw)
    jkey = jeng.key_for(x.shape, backend="pallas", **kw)
    run = dict(tol=1e-3, max_iters=60, check_every=10)
    metrics.set_enabled(True)
    events.configure(tmp_path / "ev.jsonl")
    try:
        rows = list(eng.run_converge(key, x, **run))
        n_first = sum(r["kind"] == "compile" for r in
                      events.read_events(tmp_path / "ev.jsonl"))
        again = list(eng.run_converge(key, x, **run))
        n_second = sum(r["kind"] == "compile" for r in
                       events.read_events(tmp_path / "ev.jsonl"))
    finally:
        events.deconfigure()
    assert n_first > 0 and n_second == n_first
    jrows = list(jeng.run_converge(jkey, x, **run))
    assert [(r[1], r[3]) for r in rows] == [(r[1], r[3]) for r in jrows]
    rtol, atol = multigrid.float_tolerance(get_filter("jacobi3"),
                                           rows[-1][1], float(np.abs(x).max()))
    for r, jr in zip(rows, jrows):
        np.testing.assert_allclose(r[0], np.asarray(jr[0]), rtol=rtol,
                                   atol=atol)
        assert abs(r[2] - jr[2]) <= atol + rtol * abs(jr[2])
    for r, a in zip(rows, again):
        np.testing.assert_array_equal(r[0], a[0])
    img, cycles, res, wu = rows[1]
    tail = list(eng.run_converge(key, img, start_done=cycles, start_wu=wu,
                                 start_diff=res, **run))
    assert tail[0][1] == cycles + 1
    assert tail[-1][3] <= run["max_iters"] + rows[0][3]
    assert eng.snapshot()["resident"][0]["iters"] == 10


# ---------------------------------------------------------------- volumes
def test_volume_batch_and_converge_within_tolerance_of_jax():
    rng = np.random.default_rng(5)
    v = rng.random((2, 2, 8, 16, 20), dtype=np.float32)
    eng, jeng = _pair("shifted", fallback=False)
    kw = dict(filter_name="fd7", iters=3, rank=3, quantize=False)
    out, info = eng.run_batch(eng.key_for((8, 16, 20), **kw), v)
    jout, jinfo = jeng.run_batch(jeng.key_for((8, 16, 20), **kw), v)
    assert out.shape == v.shape and info["effective_grid"] == "2x2"
    np.testing.assert_allclose(out, jout, rtol=0, atol=2e-5)
    assert set(info) == set(jinfo)
    ckw = dict(kw, iters=5)
    run = dict(tol=1e-4, max_iters=20, check_every=5)
    rows = list(eng.run_converge(eng.key_for((8, 16, 20), **ckw), v[0],
                                 **run))
    jrows = list(jeng.run_converge(jeng.key_for((8, 16, 20), **ckw), v[0],
                                   **run))
    assert [r[1] for r in rows] == [r[1] for r in jrows]
    for r, jr in zip(rows, jrows):
        np.testing.assert_allclose(r[0], np.asarray(jr[0]), atol=2e-5)
        assert abs(r[2] - jr[2]) <= 2e-5


# ---------------------------------------------------------------- lanes
@pytest.mark.parametrize("v", [1, 7, 8, 9, 100, 129, 1919, 1920, 4096, 4097,
                               9000])
def test_bucket_extent_equal_jax(v):
    assert bucket_extent(v) == jengine.bucket_extent(v)


def test_bucket_key_equal_jax():
    fields = [f.name for f in dataclasses.fields(EngineKey)]
    for kw in (dict(), dict(iters=2), dict(boundary="periodic"),
               dict(shape=(1, 32, 64)), dict(solver="multigrid")):
        kw = dict(dict(shape=(1, 100, 120)), **kw)
        got = bucket_key(EngineKey(**kw))
        want = jengine.bucket_key(jengine.EngineKey(**kw))
        assert ([getattr(got, f) for f in fields]
                == [getattr(want, f) for f in fields])
    assert bucket_key("k") == jengine.bucket_key("k") == "k"


# ---------------------------------------------------------------- batcher
class _StubExec:
    """Records flushed batches; completes every slot with its payload."""

    def __init__(self, delay=0.0):
        self.batches = []
        self.delay = delay

    def __call__(self, key, items):
        if self.delay:
            time.sleep(self.delay)
        self.batches.append((key, [it.payload for it in items]))
        for it in items:
            it.slot.set(("done", key, it.payload))


BATCHERS = [MicroBatcher, jbatcher.MicroBatcher]


def test_batcher_defaults_equal_jax():
    for cls in BATCHERS:
        b = cls(_StubExec(), start=False)
        assert (b.max_batch, b.max_delay_s, b.max_queue,
                b.pipeline_depth) == (8, 0.005, 64, 1)
    with pytest.raises(ValueError):
        MicroBatcher(_StubExec(), max_batch=0)


def test_batcher_deadline_flush_single_request():
    for cls in BATCHERS:
        ex = _StubExec()
        b = cls(ex, max_batch=8, max_delay_s=0.03, max_queue=4)
        t0 = time.monotonic()
        slot = b.try_submit("k", 1)
        assert slot.result(5.0) == ("done", "k", 1)
        assert time.monotonic() - t0 < 2.0
        assert ex.batches == [("k", [1])]
        b.close()


def test_batcher_coalesces_same_key_up_to_max_batch():
    seen = []
    for cls in BATCHERS:
        ex = _StubExec()
        b = cls(ex, max_batch=3, max_delay_s=0.05, max_queue=16,
                start=False)
        slots = [b.try_submit("k", i) for i in range(5)]
        b.start()
        for s in slots:
            assert s.result(5.0) is not None
        b.close()
        seen.append((ex.batches, b.stats["flushes"],
                     b.stats["flushed_items"]))
    assert seen[0] == seen[1]
    assert seen[0][0] == [("k", [0, 1, 2]), ("k", [3, 4])]


def test_batcher_mixed_lanes_never_cobatched():
    seen = []
    for cls in BATCHERS:
        ex = _StubExec()
        b = cls(ex, max_batch=8, max_delay_s=0.02, max_queue=16,
                start=False, lane_of=lambda k: k[0])
        for key, payload in [("a1", 1), ("b1", 2), ("a2", 3), ("b2", 4)]:
            assert b.try_submit(key, payload) is not None
        b.start()
        deadline = time.monotonic() + 5.0
        while len(ex.batches) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        b.close()
        seen.append(sorted((k, tuple(p)) for k, p in ex.batches))
    assert seen[0] == seen[1] == [("a", (1, 3)), ("b", (2, 4))]


def test_batcher_queue_full_and_close_equal_jax():
    seen = []
    for cls in BATCHERS:
        ex = _StubExec()
        b = cls(ex, max_batch=2, max_delay_s=0.01, max_queue=2, start=False)
        admitted = [b.try_submit("k", i) is not None for i in range(3)]
        depth = b.depth()
        b.start()
        b.close(drain=True)
        late = b.try_submit("k", 9)
        seen.append((admitted, depth, late, b.stats["refused"],
                     b.stats["flushed_items"], b.stats["max_observed_depth"]))
    assert seen[0] == seen[1]
    assert seen[0][:3] == ([True, True, False], 2, None)
    assert seen[0][3] == 2 and seen[0][4] == 2


def test_batcher_executor_failure_reaches_every_slot():
    for cls in BATCHERS:
        def boom(key, items):
            raise RuntimeError("executor bug")

        b = cls(boom, max_batch=4, max_delay_s=0.01, start=False)
        slots = [b.try_submit("k", i) for i in range(3)]
        b.start()
        for s in slots:
            assert isinstance(s.result(5.0), RuntimeError)
        b.close()


def test_engine_through_the_batcher_serves_each_request_its_bytes():
    """Eight concurrent requests, distinct images, one key, through the
    port's batcher at its defaults onto the engine on its executor thread:
    each request gets its own image's oracle bytes, batches coalesce, and
    every batch size was warmed first, so no batch builds anything."""
    filt = get_filter("blur3")
    eng = WarmEngine(_slots((2, 2)), fallback=False)
    key = eng.key_for((1, 24, 36), iters=2, backend="cuda_rdma", fuse=2)
    eng.warmup([key], batch_sizes=range(1, 9))
    compiles = eng.stats["compiles"]
    imgs = [_img(seed=s) for s in range(8)]
    sizes = []

    def execute(k, items):
        x = np.stack([it.payload for it in items])
        out, info = eng.run_batch(k, x)
        sizes.append(info["batch_size"])
        for it, o in zip(items, out):
            it.slot.set(o)

    b = MicroBatcher(execute)
    slots = [None] * 8
    go = threading.Barrier(8)

    def submit(i):
        go.wait(10)
        slots[i] = b.try_submit(key, _planar(imgs[i]))

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    for i, s in enumerate(slots):
        np.testing.assert_array_equal(s.result(60)[0],
                                      oracle.run_serial_u8(imgs[i], filt, 2))
    b.close()
    assert sum(sizes) == 8 and eng.stats["compiles"] == compiles
    assert eng.stats["images"] == 8


def test_lane_labels_equal_jax():
    key = EngineKey(shape=(3, 64, 96), filter_name="blur3")
    jkey = jengine.EngineKey(shape=(3, 64, 96), filter_name="blur3")
    assert batcher._lane_label(key) == jbatcher._lane_label(jkey)
    assert batcher._area(key) == jbatcher._area(jkey) == 3 * 64 * 96
    assert batcher._lane_label("plain") == jbatcher._lane_label("plain")
