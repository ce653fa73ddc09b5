"""The chaos transport in the port (``serving/chaos.py``, ROADMAP item
8b-i) held against the JAX package's on the CPU.

* the site and mode tables and the ``site=mode`` spec parser (typos
  refused alike);
* ``corrupt_frame_bytes`` / ``truncate_frame_bytes`` give the same bytes
  on every seed, and the frames decoder refuses each;
* ``router_kill_due`` follows the same seeded plan;
* ``ChaosTransport`` on the same ``PCTPU_FAULTS`` plan and seed fails the
  same hits in the same modes, site by site and mode by mode, over a stub
  replica that records what reached it;
* a router over chaos-wrapped port replicas: a ``transport_recv`` drop
  executed once and deduplicated on the retry, a mid-stream disconnect
  and truncation resumed with the oracle's final bytes, a corrupt body
  counted and failed over — the same outcomes and stamps as the JAX
  router over JAX replicas.

Tolerance: u8 bytes and JSON records equal.
"""

from __future__ import annotations

import base64
import types

import jax
import numpy as np
import pytest

from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.resilience import degrade as jdegrade
from parallel_convolution_tpu.resilience import faults as jfaults
from parallel_convolution_tpu.serving import chaos as jchaos
from parallel_convolution_tpu.serving import frames as jframes
from parallel_convolution_tpu.serving import router as jrouter
from parallel_convolution_tpu.serving import service as jservice
from parallel_convolution_tpu_torch.ops import oracle
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh
from parallel_convolution_tpu_torch.resilience import degrade, faults
from parallel_convolution_tpu_torch.serving import (
    chaos, frames, router, service,
)
from parallel_convolution_tpu_torch.utils import imageio

PORT = types.SimpleNamespace(
    name="port", chaos=chaos, router=router, service=service, faults=faults,
    grid=lambda: mesh.make_grid((1, 2), "cpu"))
JAX = types.SimpleNamespace(
    name="jax", chaos=jchaos, router=jrouter, service=jservice,
    faults=jfaults,
    grid=lambda: jmesh.make_grid_mesh(jax.devices()[:2], (1, 2)))
SIDES = [PORT, JAX]


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    for side in SIDES:
        side.faults.uninstall_plan()
    degrade.clear_probe_cache()
    jdegrade.clear_probe_cache()


# --------------------------------------------------------------- tables
def test_site_and_mode_tables_equal_jax():
    assert chaos.SITE_MODES == jchaos.SITE_MODES
    assert chaos.DEFAULT_MODES == jchaos.DEFAULT_MODES
    assert set(chaos._CONSULTS) == set(jchaos._CONSULTS)
    assert {s: faults.SITE_TABLE[s] for s in chaos.SITE_MODES} == {
        s: jfaults.SITE_TABLE[s] for s in jchaos.SITE_MODES}


@pytest.mark.parametrize("spec", [
    "transport_send=latency,transport_recv=corrupt",
    "transport_stream=truncate, readyz_probe=flap",
    "transport_send=blackhole", "", "transport_sned=drop",
    "transport_send=corrupt", "transport_recv", "readyz_probe=drop"])
def test_modes_from_spec_equal_jax(spec):
    got = []
    for side in SIDES:
        try:
            got.append(side.chaos.modes_from_spec(spec))
        except ValueError as e:
            got.append(("ValueError", str(e).split(";")[0]))
    assert got[0] == got[1]


@pytest.mark.parametrize("seed", range(0, 200, 13))
def test_corrupt_and_truncate_bytes_equal_jax(seed):
    img = np.random.default_rng(seed).integers(0, 256, (24, 36),
                                               dtype=np.uint8)
    head = {"ok": True, "kind": "snapshot", "iters": 10}
    env = frames.encode_envelope(dict(head), {"image": img})
    assert env == jframes.encode_envelope(dict(head), {"image": img})
    for fn, jfn in ((chaos.corrupt_frame_bytes, jchaos.corrupt_frame_bytes),
                    (chaos.truncate_frame_bytes,
                     jchaos.truncate_frame_bytes)):
        bad = fn(env, seed=seed)
        assert bad == jfn(env, seed=seed) and bad != env
        with pytest.raises(frames.BadFrame):
            frames.decode_envelope(bad)


def test_router_kill_due_follows_the_seeded_plan():
    got = []
    for side in SIDES:
        side.faults.install_plan("router_kill:p0.3", seed=5)
        got.append([side.chaos.router_kill_due() for _ in range(60)])
        side.faults.uninstall_plan()
    assert got[0] == got[1] and 5 < sum(got[0]) < 35


# ------------------------------------------------- the transport alone
class _Stub:
    """A replica transport that answers at once and records what reached
    it (the chaos wrapper's seam, without a service behind it)."""

    def __init__(self, name="s0"):
        self.name = name
        self.seen = []

    def request(self, body, timeout=None, traceparent=None):
        self.seen.append(("request", body["request_id"]))
        return 200, {"ok": True, "request_id": body["request_id"]}

    def converge(self, body, timeout=None, traceparent=None):
        self.seen.append(("converge", body["request_id"]))
        return 200, iter([{"kind": "snapshot", "iters": i, "ok": True}
                          for i in (10, 20, 30)]
                         + [{"kind": "final", "iters": 40, "ok": True}])

    def readyz(self):
        self.seen.append(("readyz", ""))
        return 200, {"ready": True}


PLANS = [("transport_send", m, "transport_send:2") for m in
         jchaos.SITE_MODES["transport_send"]] + [
    ("transport_recv", m, "transport_recv:p0.4") for m in
    jchaos.SITE_MODES["transport_recv"]] + [
    ("transport_stream", m, "transport_stream:3+") for m in
    jchaos.SITE_MODES["transport_stream"]] + [
    ("readyz_probe", "flap", "readyz_probe:p0.5")]


@pytest.mark.parametrize("site,mode,plan", PLANS,
                         ids=[f"{s}-{m}" for s, m, _ in PLANS])
def test_chaos_transport_fails_the_same_hits(site, mode, plan):
    got = []
    for side in SIDES:
        side.faults.install_plan(plan, seed=11)
        stub = _Stub()
        ct = side.chaos.ChaosTransport(stub, {site: mode}, seed=3,
                                       latency_s=0.001, blackhole_s=0.001)
        out = []
        for i in range(12):
            try:
                if site == "readyz_probe":
                    out.append(ct.readyz()[0])
                    continue
                if site == "transport_stream":
                    _, rows = ct.converge({"request_id": f"c{i}"})
                    out.append([r["iters"] for r in rows])
                else:
                    out.append(ct.request({"request_id": f"q{i}"})[0])
            except ConnectionError as e:
                out.append((type(e).__name__, str(e).split(":")[1][:24]))
        got.append((out, stub.seen, ct.injected, ct.name))
        side.faults.uninstall_plan()
    assert got[0] == got[1]
    assert got[0][2].get(site, 0) > 0


# ------------------------------------------- a router over chaos replicas
def _factory(side):
    def make():
        return side.service.ConvolutionService(side.grid(),
                                               max_delay_s=0.002)
    return make


@pytest.fixture(scope="module")
def replicas():
    reps = {side.name: [side.router.InProcessReplica(_factory(side),
                                                     name=f"c{i}")
                        for i in range(2)] for side in SIDES}
    yield reps
    for rs in reps.values():
        for r in rs:
            r.close()


def _body(img, **kw):
    body = {"image_b64": base64.b64encode(
        np.ascontiguousarray(img).tobytes()).decode("ascii"),
        "rows": img.shape[0], "cols": img.shape[1], "mode": "grey",
        "filter": "blur3"}
    body.update(kw)
    return body


def _img(seed=5):
    return imageio.generate_test_image(48, 64, "grey", seed=seed)


def test_recv_drop_runs_the_request_once_as_jax(replicas):
    """A dropped response after the work ran: the one replica's answer is
    a typed retryable ``replica_unavailable``, and the retry with the same
    ``request_id`` is served from the replica's dedup ledger (its engine
    ran one batch)."""
    img = _img()
    got = {}
    for side in SIDES:
        rep = replicas[side.name][0]
        ct = side.chaos.ChaosTransport(rep, seed=0)
        rt = side.router.ReplicaRouter([ct], start_health=False)
        svc = rep.service
        b0, c0, d0 = (svc.engine.stats["batches"], svc.stats["completed"],
                      svc.stats["deduped"])
        side.faults.install_plan("transport_recv:1")
        s1, w1 = rt.request(_body(img, iters=2, request_id="rv1"))
        s2, w2 = rt.request(_body(img, iters=2, request_id="rv1"))
        side.faults.uninstall_plan()
        rt.close(close_replicas=False)
        got[side.name] = ((s1, w1["rejected"], w1["retryable"]),
                          (s2, w2["ok"], w2["image_b64"]),
                          (svc.engine.stats["batches"] - b0,
                           svc.stats["completed"] - c0,
                           svc.stats["deduped"] - d0), ct.injected)
    assert got["port"] == got["jax"]
    assert got["port"][0] == (503, "replica_unavailable", True)
    assert got["port"][2] == (1, 1, 1)
    assert base64.b64decode(got["port"][1][2]) == oracle.run_serial_u8(
        img, get_filter("blur3"), 2).tobytes()


@pytest.mark.parametrize("mode", ["disconnect", "truncate", "corrupt"])
def test_mid_stream_failure_resumes_as_jax(replicas, mode):
    """A durable converge whose stream breaks at its third row on the
    chaos-wrapped replica resumes on the other from the newest token:
    the same rows, stamps and counters as the JAX router, and the
    oracle's final bytes, once."""
    img = _img(seed=7)
    body = _body(img, quantize=True, tol=0.0, max_iters=40,
                 check_every=10, request_id=f"ms-{mode}")
    got = {}
    for side in SIDES:
        reps = replicas[side.name]
        rt = side.router.ReplicaRouter(reps, start_health=False)
        home = rt.ring.candidates(side.router.route_key(body))[0]
        wrapped = [side.chaos.ChaosTransport(r, {"transport_stream": mode},
                                             seed=2) if r.name == home else r
                   for r in reps]
        rt.close(close_replicas=False)
        rt = side.router.ReplicaRouter(wrapped, start_health=False)
        side.faults.install_plan("transport_stream:3")
        status, rows = rt.converge(dict(body))
        rows = list(rows)
        side.faults.uninstall_plan()
        snap = rt.snapshot()
        rt.close(close_replicas=False)
        got[side.name] = (
            status, [(r["kind"], r["iters"], r["router"]["replica"],
                      r["router"].get("resume_count")) for r in rows],
            rows[-1]["image_b64"],
            {n: {k: v for k, v in r.items() if k in (
                "resumes", "mid_stream_failovers", "corrupt_responses")}
             for n, r in snap["replicas"].items()})
    assert got["port"] == got["jax"]
    kinds = [r[0] for r in got["port"][1]]
    assert kinds.count("final") == 1 and kinds[-1] == "final"
    assert got["port"][1][-1][3] == 1
    assert base64.b64decode(got["port"][2]) == oracle.run_serial_u8(
        img, get_filter("blur3"), 40).tobytes()
