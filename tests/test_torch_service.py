"""One replica's service (ROADMAP item 8a-ii) in the port, held against the
JAX package's on the CPU.

The same seeded requests go through the port's ``ConvolutionService`` on a
CPU grid (2x2; ``cuda_rdma`` also on four CPU slots) and the JAX
package's on its 8-device CPU mesh, the backends mapped
(``utils.config.BACKEND_FROM_REFERENCE``; JAX's Pallas kernels in
interpret mode):

* u8 responses byte-equal to each other and to the oracle, batched or
  alone, grey and RGB, for every backend;
* the same typed rejections from the same situations: invalid, queue_full,
  deadline, timeout, resharding, stale_epoch, error after exhausted
  retries, and the degrade walk under ``backend_compile:1``;
* dedup by ``request_id``, warm keys, ``reshape``, the epoch fences,
  readiness and snapshots;
* converge streams: u8 rows byte-equal, float rows within
  ``ops/stencil.float_tolerance``, a JAX-minted resume token finishing on
  the port with the JAX final bytes, multigrid, the cached final;
* volumes within 2e-5, their streams, tokens and typed invalids.

The kernel backends run their plain versions here because the grid is on
the CPU; ``chip_smoke.py`` phase 4m runs the service on the card.
"""

import base64
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch
from _torch_jax_state import reset_jax_state

from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.resilience import degrade as jdegrade
from parallel_convolution_tpu.resilience import faults as jfaults
from parallel_convolution_tpu.resilience import retry as jretry
from parallel_convolution_tpu.serving import frontend as jfrontend
from parallel_convolution_tpu.serving import jobs as jjobs
from parallel_convolution_tpu.serving import service as jservice
from parallel_convolution_tpu_torch.ops import oracle, stencil
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh
from parallel_convolution_tpu_torch.resilience import degrade, faults, retry
from parallel_convolution_tpu_torch.serving import frontend, service
from parallel_convolution_tpu_torch.utils import imageio
from parallel_convolution_tpu_torch.utils.config import BACKEND_FROM_REFERENCE
from parallel_convolution_tpu_torch.volumes import oracle3

JAX_NAME = {v: k for k, v in BACKEND_FROM_REFERENCE.items()}
BACKENDS = ["shifted", "xla_conv", "separable", "cuda", "cuda_sep",
            "cuda_rdma"]


def _port_grid(shape=(2, 2), slots=False):
    if slots:
        return mesh.make_grid(shape, devices=["cpu"] * (shape[0] * shape[1]))
    return mesh.make_grid(shape, "cpu")


def _jax_mesh(shape=(2, 2)):
    return jmesh.make_grid_mesh(jax.devices()[:shape[0] * shape[1]], shape)


PORT = types.SimpleNamespace(
    name="port", service=service, frontend=frontend, faults=faults,
    retry=retry, grid=_port_grid, backend=lambda b: b)
JAX = types.SimpleNamespace(
    name="jax", service=jservice, frontend=jfrontend, faults=jfaults,
    retry=jretry, grid=lambda shape=(2, 2), slots=False: _jax_mesh(shape),
    backend=lambda b: JAX_NAME.get(b, b))
SIDES = [PORT, JAX]


@pytest.fixture(autouse=True)
def _clean_state():
    faults.uninstall_plan()
    degrade.clear_probe_cache()
    yield
    faults.uninstall_plan()
    degrade.clear_probe_cache()
    jdegrade.clear_probe_cache()
    reset_jax_state()


def _svc(side, shape=(2, 2), slots=False, **kw):
    kw.setdefault("max_delay_s", 0.02)
    kw.setdefault("retry_policy", side.retry.RetryPolicy(
        max_attempts=3, base_delay=0.01, max_delay=0.05))
    return side.service.ConvolutionService(side.grid(shape, slots=slots),
                                           **kw)


def _img(h=24, w=36, mode="grey", seed=1):
    return imageio.generate_test_image(h, w, mode, seed=seed)


def _body(img, **kw):
    body = {"image_b64": base64.b64encode(
        np.ascontiguousarray(img).tobytes()).decode("ascii"),
        "rows": img.shape[0], "cols": img.shape[1],
        "mode": "rgb" if img.ndim == 3 else "grey"}
    body.update(kw)
    return body


def _image(resp, shape, dtype=np.uint8):
    return np.frombuffer(base64.b64decode(resp["image_b64"]),
                         dtype).reshape(shape)


# ------------------------------------------------------------- responses
@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_bytes_equal_jax_and_the_oracle(backend):
    """Three requests of one key in one flush (and one alone): every
    image the JAX service's bytes at the mapped backend and the oracle's,
    each response stamped as JAX's is."""
    imgs = [_img(seed=s) for s in (1, 2, 3)]
    filt = get_filter("blur3")
    got = {}
    for side in SIDES:
        svc = _svc(side, slots=backend == "cuda_rdma", max_delay_s=0.2,
                   fallback=False)
        try:
            slots = [svc.submit(side.service.Request(
                image=im, iters=2, fuse=2, backend=side.backend(backend)),
                wait=False) for im in imgs]
            rs = [s.result(300) for s in slots]
            rs.append(svc.submit(side.service.Request(
                image=imgs[0], iters=2, fuse=2,
                backend=side.backend(backend)), timeout=300))
        finally:
            svc.close()
        assert all(isinstance(r, side.service.Response) for r in rs), rs
        got[side.name] = rs
    for r, jr, im in zip(got["port"], got["jax"], imgs + imgs[:1]):
        np.testing.assert_array_equal(r.image, jr.image)
        np.testing.assert_array_equal(r.image,
                                      oracle.run_serial_u8(im, filt, 2))
        assert r.effective_backend == backend
        assert r.backend == backend and jr.backend == JAX_NAME[backend]
        assert r.effective_grid == jr.effective_grid == "2x2"
        assert set(r.phases) == set(jr.phases)
        assert r.cache == jr.cache == "off"
    assert got["port"][0].batch_size == 3


@pytest.mark.parametrize("backend,storage", [("shifted", "f32"),
                                             ("cuda_sep", "bf16"),
                                             ("cuda_rdma", "u8")])
def test_rgb_responses_equal_jax_and_the_oracle(backend, storage):
    img = _img(32, 40, "rgb", seed=5)
    want = oracle.run_serial_u8(img, get_filter("gaussian5"), 3)
    for side in SIDES:
        svc = _svc(side, slots=backend == "cuda_rdma")
        try:
            r = svc.submit(side.service.Request(
                image=img, filter_name="gaussian5", iters=3, fuse=3,
                storage=storage, backend=side.backend(backend)), timeout=300)
        finally:
            svc.close()
        assert r.image.shape == img.shape
        np.testing.assert_array_equal(r.image, want)


def test_warm_key_serves_with_no_new_build():
    for side in SIDES:
        svc = _svc(side)
        try:
            eff = svc.warmup([{"rows": 24, "cols": 36, "iters": 2,
                               "backend": side.backend("cuda_sep"),
                               "storage": "bf16", "fuse": 2}])
            assert eff == [side.backend("cuda_sep")]
            compiles = svc.engine.stats["compiles"]
            r = svc.submit(side.service.Request(
                image=_img(), iters=2, fuse=2, storage="bf16",
                backend=side.backend("cuda_sep")), timeout=300)
            assert isinstance(r, side.service.Response)
            assert svc.engine.stats["compiles"] == compiles
            assert svc.engine.stats["hits"] >= 1
        finally:
            svc.close()


# ------------------------------------------------------- typed rejections
def _reject(side, case: str):
    """One situation that ends in a typed rejection (or a degraded
    response); returns what a client would see and the counters."""
    S = side.service
    img = _img(26, 38, seed=5)
    if case in ("bad_filter", "bad_dtype", "big_fuse", "batch_multigrid",
                "periodic_ragged", "bad_storage", "both_payloads"):
        svc = _svc(side, start=False)
        req = {"bad_filter": S.Request(image=img, filter_name="nope"),
               "bad_dtype": S.Request(image=np.zeros((8, 8), np.float32)),
               "big_fuse": S.Request(image=_img(8, 8), iters=64, fuse=64),
               "batch_multigrid": S.Request(image=img, solver="multigrid"),
               "periodic_ragged": S.Request(image=_img(25, 37),
                                            boundary="periodic"),
               "bad_storage": S.Request(image=img, storage="u8",
                                        quantize=False),
               "both_payloads": S.Request(
                   image=img, volume=np.zeros((2, 4, 8, 8), np.float32)),
               }[case]
        r = svc.submit(req)
        svc.batcher.close(drain=False)
    elif case == "queue_full":
        svc = _svc(side, max_queue=2, start=False)
        held = [svc.submit(S.Request(image=img), wait=False)
                for _ in range(2)]
        r = svc.submit(S.Request(image=img), timeout=5)
        svc.batcher.start()
        assert all(isinstance(h.result(300), S.Response) for h in held)
        svc.close()
    elif case == "deadline":
        svc = _svc(side, start=False)
        slot = svc.submit(S.Request(image=img, deadline_s=0.01), wait=False)
        time.sleep(0.05)
        svc.batcher.start()
        r = slot.result(120)
        svc.close()
    elif case == "timeout":
        svc = _svc(side, start=False)
        r = svc.submit(S.Request(image=img), timeout=0.05)
        svc.batcher.close(drain=False)
    elif case == "resharding":
        svc = _svc(side, start=False)
        svc._reshaping = True
        r = svc.submit(S.Request(image=img))
        svc._reshaping = False
        svc.batcher.close(drain=False)
    elif case == "stale_epoch":
        svc = _svc(side, start=False)
        client = side.frontend.InProcessClient(svc)
        svc.fence(5)
        status, wire = client.request(_body(img, router_epoch=3))
        svc.batcher.close(drain=False)
        return (status, wire["rejected"], wire["retryable"],
                wire["fence_epoch"], svc.stats["rejected_stale_epoch"])
    elif case == "error_exhausted":
        with side.faults.injected("backend_compile:*"):
            svc = _svc(side, fallback=False, retry_policy=(
                side.retry.RetryPolicy(max_attempts=2, base_delay=0.01,
                                       max_delay=0.02)))
            r = svc.submit(S.Request(image=img), timeout=300)
            svc.close()
    elif case == "degrade_walk":
        with side.faults.injected("backend_compile:1"):
            svc = _svc(side, fallback=True)
            r = svc.submit(S.Request(image=img, iters=3,
                                     backend=side.backend("cuda")),
                           timeout=300)
            svc.close()
        assert isinstance(r, S.Response), r
        np.testing.assert_array_equal(
            r.image, oracle.run_serial_u8(img, get_filter("blur3"), 3))
        return ("served", r.effective_backend, svc.engine.degraded())
    else:
        raise AssertionError(case)
    assert isinstance(r, S.Rejected), (case, r)
    counters = {k: v for k, v in svc.stats.items()
                if k.startswith("rejected") or k == "client_timeouts"}
    return (r.reason, r.retryable, r.retry_after_s, counters,
            side.frontend.encode_response(r)[0])


@pytest.mark.parametrize("case", [
    "bad_filter", "bad_dtype", "big_fuse", "batch_multigrid",
    "periodic_ragged", "bad_storage", "both_payloads", "queue_full",
    "deadline", "timeout", "resharding", "stale_epoch", "error_exhausted",
    "degrade_walk"])
def test_typed_rejections_equal_jax(case):
    got, want = _reject(PORT, case), _reject(JAX, case)
    if case == "degrade_walk":
        assert got == ("served", "shifted",
                       [{"requested": "cuda", "effective": "shifted"}])
        assert want == ("served", "shifted",
                        [{"requested": "pallas", "effective": "shifted"}])
        return
    assert got == want


def test_a_refused_kernel_is_an_error_never_a_plain_run_on_the_card(
        monkeypatch):
    """On a CUDA grid the degrade walk stops at ``cuda``: a key whose
    every tier is refused becomes ``Rejected("error")``."""
    assert degrade.degradation_chain("cuda_rdma", on_card=True) == (
        "cuda_rdma", "cuda")
    svc = service.ConvolutionService(device="cpu", start=False)
    assert svc.engine.grid.device.type == "cpu"
    assert svc.snapshot()["mesh"] == "1x1"
    svc.batcher.close(drain=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        service.ConvolutionService()


def test_dedup_by_request_id_equals_jax():
    for side in SIDES:
        svc = _svc(side, max_delay_s=0.1)
        try:
            req = side.service.Request(image=_img(), iters=2,
                                       request_id="same")
            a = svc.submit(req, wait=False)
            b = svc.submit(req, wait=False)
            ra, rb = a.result(300), b.result(300)
            assert ra is rb and isinstance(ra, side.service.Response)
            assert svc.stats["deduped"] == 1
            assert svc.engine.stats["images"] == 1
        finally:
            svc.close()


def test_fences_equal_jax():
    seqs = []
    for side in SIDES:
        svc = _svc(side, start=False)
        seq = [svc.fence(3), svc.fence(2), svc.fence(7, shard="a"),
               svc.epoch_gate(None), svc.epoch_gate(2), svc.epoch_gate(4),
               svc.epoch_gate("x"), svc.epoch_gate(1, shard="a"),
               svc.fence_epochs(), svc.stats["rejected_stale_epoch"]]
        client = side.frontend.InProcessClient(svc)
        seq += [client.fence("nope")[0], client.fence(9, shard="b")]
        svc.batcher.close(drain=False)
        seqs.append(seq)
    assert seqs[0] == seqs[1]


def test_reshape_readiness_and_snapshot_like_jax():
    """``reshape`` onto 1x2 (a spec), the stamps after it, a malformed spec
    refused before any teardown; readiness and snapshot carry JAX's
    keys."""
    out = {}
    for side in SIDES:
        svc = _svc(side, cache=True)
        try:
            S = side.service
            r1 = svc.submit(S.Request(image=_img(), iters=2), timeout=300)
            with pytest.raises(ValueError):
                svc.reshape("2by2")
            assert svc.submit(S.Request(image=_img(), iters=2),
                              timeout=300).cache == "hit"
            info = svc.reshape("1x2")
            r2 = svc.submit(S.Request(image=_img(), iters=2), timeout=300)
            ready, verdict = svc.readiness()
            snap = svc.snapshot()
            out[side.name] = (info["grid"], info["rewarmed"],
                              r1.effective_grid, r2.effective_grid, r2.cache,
                              svc.stats["reshapes"], ready, verdict["grid"],
                              snap["mesh"], set(verdict), set(snap),
                              snap["platform"], snap["cache"]["invalidations"])
            np.testing.assert_array_equal(r1.image, r2.image)
        finally:
            svc.close()
    assert out["port"] == out["jax"]


# ----------------------------------------------------------------- cache
def test_duplicate_is_a_hit_with_no_engine_batch():
    for side in SIDES:
        svc = _svc(side, cache=True)
        try:
            client = side.frontend.InProcessClient(svc)
            body = _body(_img(seed=3), iters=2,
                         backend=side.backend("cuda_sep"), fuse=2)
            s1, r1 = client.request(dict(body))
            batches = svc.engine.stats["batches"]
            s2, r2 = client.request(dict(body))
            assert (s1, s2) == (200, 200)
            assert (r1["cache"], r2["cache"]) == ("miss", "hit")
            assert r1["image_b64"] == r2["image_b64"]
            assert r1["digest"] == r2["digest"]
            assert svc.engine.stats["batches"] == batches
            assert svc.stats["cache_hits"] == 1
        finally:
            svc.close()


# -------------------------------------------------------------- converge
def _rows(side, body, wire="json", svc_kw=None):
    svc = _svc(side, **(svc_kw or {}))
    try:
        client = side.frontend.InProcessClient(svc)
        status, rows = client.converge(dict(body), wire=wire)
        return status, list(rows)
    finally:
        svc.close()


@pytest.mark.parametrize("backend,storage", [("shifted", "u8"),
                                             ("cuda_rdma", "u8"),
                                             ("cuda", "f32")])
def test_u8_converge_rows_equal_jax(backend, storage):
    """quantize=True: every row's bytes, iterations and diff equal JAX's
    shifted rows (u8 mode is exact on any backend)."""
    img = _img(40, 48, seed=2)
    body = _body(img, tol=0.5, check_every=10, max_iters=400,
                 quantize=True, storage=storage)
    s, rows = _rows(PORT, dict(body, backend=backend))
    js, jrows = _rows(JAX, dict(body, backend="shifted"))
    assert s == js == 200
    assert [r["kind"] for r in rows] == [r["kind"] for r in jrows]
    for r, jr in zip(rows, jrows):
        assert (r["iters"], r["diff"], r["converged"]) == (
            jr["iters"], jr["diff"], jr["converged"])
        assert r["image_b64"] == jr["image_b64"]
    assert rows[-1]["converged"] and rows[-1]["effective_backend"] == backend


def test_a_jax_resume_token_finishes_on_the_port():
    img = _img(40, 48, seed=2)
    body = _body(img, tol=0.5, check_every=10, max_iters=400, quantize=True,
                 storage="u8", resume_state=True)
    _, jrows = _rows(JAX, dict(body, backend="shifted"))
    tok = jjobs.token_from_row(jrows[len(jrows) // 2])
    assert tok is not None and tok["iters"] % 10 == 0
    for backend in ("cuda_rdma", "shifted"):
        s, rows = _rows(PORT, dict(body, backend=backend, resume=tok))
        assert s == 200 and rows[-1]["kind"] == "final"
        assert rows[0]["iters"] == tok["iters"] + 10
        assert rows[-1]["image_b64"] == jrows[-1]["image_b64"]
        assert rows[-1]["iters"] == jrows[-1]["iters"]


@pytest.mark.parametrize("backend", ["shifted", "cuda"])
def test_float_converge_rows_within_tolerance_of_jax(backend):
    rng = np.random.default_rng(4)
    img = (rng.random((24, 32)) * 255).astype(np.uint8)
    body = _body(img, tol=0.0, check_every=10, max_iters=30,
                 resume_state=True, filter="gaussian5")
    _, rows = _rows(PORT, dict(body, backend=backend))
    _, jrows = _rows(JAX, dict(body, backend=JAX_NAME.get(backend,
                                                          backend)))
    assert [r["iters"] for r in rows] == [r["iters"] for r in jrows] == [
        10, 20, 30, 30]
    for r, jr in zip(rows[:-1], jrows[:-1]):
        rtol, atol = stencil.float_tolerance(get_filter("gaussian5"),
                                             r["iters"], torch.float32)
        np.testing.assert_allclose(
            jjobs.state_from_wire(r["state_b64"], r["state_shape"]),
            jjobs.state_from_wire(jr["state_b64"], jr["state_shape"]),
            rtol=rtol, atol=atol)
        assert abs(r["diff"] - jr["diff"]) <= atol + rtol * abs(jr["diff"])


def test_multigrid_converge_within_tolerance_of_jax():
    img = _img(32, 32, seed=6)
    body = _body(img, tol=0.5, check_every=1, max_iters=60,
                 solver="multigrid", mg_levels=2, filter="jacobi3")
    _, rows = _rows(PORT, body)
    _, jrows = _rows(JAX, body)
    assert [r["iters"] for r in rows] == [r["iters"] for r in jrows]
    assert rows[-1]["mg_levels"] == jrows[-1]["mg_levels"] == 2
    a, b = _image(rows[-1], img.shape), _image(jrows[-1], img.shape)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_converge_final_is_cached_as_a_one_row_stream():
    img = _img(40, 48, seed=2)
    body = _body(img, tol=0.5, check_every=10, max_iters=400, quantize=True)
    for side in SIDES:
        svc = _svc(side, cache=True)
        try:
            client = side.frontend.InProcessClient(svc)
            _, first = client.converge(dict(body))
            first = list(first)
            _, again = client.converge(dict(body, check_every=5))
            again = list(again)
            assert len(again) == 1 and again[0]["cache"] == "hit"
            assert again[0]["image_b64"] == first[-1]["image_b64"]
        finally:
            svc.close()


def test_converge_invalids_equal_jax():
    img = _img()
    for bad in ({"tol": -1}, {"max_iters": 0}, {"check_every": "x"},
                {"resume": "tok"}, {"resume": {"iters": 5, "state_b64": "",
                                               "state_shape": [1, 24, 36]}}):
        got = _rows(PORT, _body(img, **bad), svc_kw={"start": False})
        want = _rows(JAX, _body(img, **bad), svc_kw={"start": False})
        assert got[0] == want[0] and len(got[1]) == len(want[1]) == 1
        assert got[1][0]["rejected"] == want[1][0]["rejected"]


# --------------------------------------------------------------- volumes
def _vol(seed=7, d=4, h=16, w=16):
    return np.random.default_rng(seed).random((2, d, h, w), dtype=np.float32)


def _vbody(vol, **kw):
    b = {"rows": vol.shape[2], "cols": vol.shape[3], "depth": vol.shape[1],
         "mode": "volume",
         "volume_b64": base64.b64encode(vol.tobytes()).decode()}
    b.update(kw)
    return b


@pytest.mark.parametrize("name,iters", [("fd7", 5), ("fd25", 2),
                                        ("grayscott", 3)])
def test_volume_batch_within_2e5_of_jax_and_oracle3(name, iters):
    vol = _vol(1)
    boundary = "periodic" if name == "grayscott" else "zero"
    outs = []
    for side in SIDES:
        svc = _svc(side, cache=True)
        try:
            s, r = side.frontend.InProcessClient(svc).request(
                _vbody(vol, filter=name, iters=iters, boundary=boundary))
        finally:
            svc.close()
        assert s == 200, r
        outs.append((_image(r, vol.shape, np.float32), r["plan_key"]))
    want = oracle3.run_oracle(vol, name, iters, boundary)
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(outs[0][0], want, rtol=0, atol=2e-5)
    assert outs[0][1] == outs[1][1]


def test_volume_stream_and_resume_token_like_jax():
    vol = _vol(4)
    body = _vbody(vol, filter="wave", boundary="periodic", tol=0.0,
                  max_iters=12, check_every=4, resume_state=True)
    _, rows = _rows(PORT, body)
    _, jrows = _rows(JAX, body)
    assert [r["iters"] for r in rows] == [r["iters"] for r in jrows]
    np.testing.assert_allclose(_image(rows[-1], vol.shape, np.float32),
                               _image(jrows[-1], vol.shape, np.float32),
                               rtol=0, atol=2e-5)
    # The port's own token: the uninterrupted run's bytes; JAX's: within
    # the float tolerance of JAX's final (its field carries JAX's rounding).
    for src, want, exact in ((rows, rows, True), (jrows, jrows, False)):
        _, resumed = _rows(PORT, dict(body, resume=jjobs.token_from_row(
            src[0])))
        assert resumed[0]["iters"] == 8 and resumed[-1]["iters"] == 12
        if exact:
            assert resumed[-1]["image_b64"] == want[-1]["image_b64"]
        else:
            np.testing.assert_allclose(
                _image(resumed[-1], vol.shape, np.float32),
                _image(want[-1], vol.shape, np.float32), rtol=0, atol=2e-5)


def test_volume_invalids_equal_jax():
    vol = _vol(6)
    for side in SIDES:
        S = side.service
        svc = _svc(side, start=False)
        try:
            for req in (S.Request(volume=vol, filter_name="blur3"),
                        S.Request(volume=vol.astype(np.float64)),
                        S.Request(volume=vol[0]),
                        S.Request(volume=vol[:1]),
                        S.Request(volume=vol, solver="multigrid"),
                        S.Request(volume=_vol(6, h=15), boundary="periodic")):
                r = svc.submit(req)
                assert isinstance(r, S.Rejected) and r.reason == "invalid"
            status, wire = side.frontend.InProcessClient(svc).request(
                {k: v for k, v in _vbody(vol).items() if k != "depth"})
            assert status == 400 and wire["rejected"] == "invalid"
        finally:
            svc.batcher.close(drain=False)


def test_concurrent_requests_all_served_exactly_once():
    """Sixteen threads, two keys, through one service: every answer the
    oracle's and counted once (the admission counters under contention)."""
    svc = _svc(PORT, max_delay_s=0.01)
    imgs = [_img(seed=s) for s in range(8)]
    out = [None] * 16

    def one(i):
        out[i] = svc.submit(service.Request(
            image=imgs[i % 8], iters=1 + i % 2, request_id=f"id{i}"),
            timeout=300)

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
        for i, r in enumerate(out):
            np.testing.assert_array_equal(r.image, oracle.run_serial_u8(
                imgs[i % 8], get_filter("blur3"), 1 + i % 2))
        assert svc.stats["completed"] == svc.stats["submitted"] == 16
    finally:
        svc.close()


# ------------------------------------------------------- names and boot
def test_serving_exports_the_service_and_the_fleet_still_raises():
    import parallel_convolution_tpu_torch.serving as serving
    from parallel_convolution_tpu_torch.utils import config

    for name in ("ConvolutionService", "Request", "Response", "Rejected",
                 "Snapshot", "WorkPricer", "JobLedger", "InProcessClient",
                 "make_http_server"):
        assert name in serving.__all__ and getattr(serving, name)
    for name in ("ChaosTransport", "CorruptReplicaBody", "HTTPReplica",
                 "InProcessReplica", "ReplicaRouter", "TenantQuotas"):
        assert name in serving.__all__ and getattr(serving, name)
    # The fleet's names resolve as the JAX package's serving names do
    # (the test's name is from when they still raised).
    import parallel_convolution_tpu.serving as jserving
    from parallel_convolution_tpu_torch.serving import autoscaler, peers

    assert "AutoScaler" in serving.__all__ and "AutoScaler" in jserving.__all__
    assert serving.AutoScaler is autoscaler.AutoScaler
    assert serving.autoscaler is autoscaler and serving.peers is peers
    assert serving.peers.ShardRouter.__name__ == "ShardRouter"
    assert not hasattr(config, "SERVICE_ITEM")
    assert not hasattr(config, "FLEET_ITEM")


@pytest.fixture(scope="module")
def http_service():
    from parallel_convolution_tpu_torch.obs import metrics

    metrics.set_enabled(True)
    svc = service.ConvolutionService(_port_grid(slots=True),
                                     max_delay_s=0.01, cache=True)
    srv = frontend.make_http_server(svc, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield svc, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    svc.close()
    t.join(30)


def _http(url, data=None, ctype="application/json"):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_service_on_slots_like_jax(http_service):
    """The loopback server over four CPU slots: a ``cuda_rdma`` request,
    a converge stream, a framed volume, the probes; each answer the JAX
    client's."""
    import json

    from parallel_convolution_tpu.serving import frames as jframes
    from parallel_convolution_tpu_torch.obs import metrics
    from parallel_convolution_tpu_torch.serving import frames

    _, url = http_service
    jsvc = _svc(JAX, max_delay_s=0.01)
    jc = jfrontend.InProcessClient(jsvc)
    try:
        img = _img(40, 48, "rgb", seed=8)
        body = _body(img, iters=4, fuse=4, storage="bf16",
                     backend="cuda_rdma", col_mode="strided")
        s, raw = _http(f"{url}/v1/convolve", json.dumps(body).encode())
        r = json.loads(raw)
        js, jr = jc.request(dict(body, backend="pallas_rdma"))
        assert s == js == 200 and r["col_mode"] == jr["col_mode"]
        assert r["image_b64"] == jr["image_b64"]
        cbody = _body(_img(40, 48, seed=2), tol=0.5, check_every=10,
                      max_iters=400, quantize=True, storage="u8")
        s, raw = _http(f"{url}/v1/converge",
                       json.dumps(dict(cbody, backend="cuda_rdma",
                                       fuse=8)).encode())
        rows = [json.loads(x) for x in raw.splitlines() if x.strip()]
        _, jrows = jc.converge(dict(cbody, backend="shifted"))
        jrows = list(jrows)
        assert [(x["iters"], x["image_b64"]) for x in rows] == [
            (x["iters"], x["image_b64"]) for x in jrows]
        vol = _vol(2)
        head = {k: v for k, v in _vbody(vol, filter="fd7", iters=3).items()
                if k != "volume_b64"}
        s, raw = _http(f"{url}/v1/convolve",
                       frames.encode_envelope(head, {"volume": vol}),
                       frames.FRAMES_CONTENT_TYPE)
        h, arrays = frames.decode_envelope(raw)
        _, jraw = jc.request_frames(jframes.encode_envelope(
            head, {"volume": vol}))
        _, jarrays = jframes.decode_envelope(jraw)
        assert s == 200 and h["ok"] and arrays["image"].dtype == np.float32
        np.testing.assert_allclose(arrays["image"], jarrays["image"],
                                   rtol=0, atol=2e-5)
        s, raw = _http(f"{url}/readyz")
        assert s == 200 and json.loads(raw)["grid"] == "2x2"
        s, raw = _http(f"{url}/metrics")
        assert "pctpu_request_phase_seconds_count" in metrics.parse_text(
            raw.decode())
    finally:
        jsvc.close()


def test_serve_module_boots_on_port_0_and_stops_on_sigterm(tmp_path):
    """``python -m parallel_convolution_tpu_torch.serving.serve --port 0
    --device cpu``: the bound port on its first line, a warm config,
    a request through it, the final snapshot on SIGTERM."""
    import json
    import os
    import signal
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "parallel_convolution_tpu_torch.serving.serve",
         "--port", "0", "--device", "cpu", "--mesh", "2x2", "--cache",
         "--warm", json.dumps({"rows": 24, "cols": 36, "iters": 2,
                               "backend": "cuda_sep", "storage": "u8",
                               "fuse": 2})],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        warmed = json.loads(proc.stdout.readline())
        boot = json.loads(proc.stdout.readline())
        assert warmed["effective_backend"] == "cuda_sep"
        assert boot["mesh"] == "2x2" and boot["platform"] == "cpu"
        img = _img()
        s, raw = _http(f"{boot['serving']}/v1/convolve", json.dumps(_body(
            img, iters=2, fuse=2, backend="cuda_sep",
            storage="u8")).encode())
        r = json.loads(raw)
        assert s == 200 and r["effective_backend"] == "cuda_sep"
        np.testing.assert_array_equal(_image(r, img.shape),
                                      oracle.run_serial_u8(
                                          img, get_filter("blur3"), 2))
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
        final = json.loads(out.splitlines()[-1])
        assert proc.returncode == 0, err
        assert final["final"]["service"]["completed"] == 1
        assert final["final"]["engine"]["compiles"] == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


def test_serve_module_runs_on_the_card_unless_asked():
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.cuda.is_available = lambda: False\n"
         "from parallel_convolution_tpu_torch.serving import serve\n"
         "serve.main(['--port', '0'])"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
