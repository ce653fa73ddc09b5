"""The fleet's front tier in the port (``serving/router.py``, ROADMAP item
8b-i) held against the JAX package's on the CPU.

* ``route_key`` and ``HashRing.candidates`` agree on 1000 seeded keys for
  one to five members, and after a member is added and one removed;
* ``TokenBucket`` / ``TenantQuotas`` under an injected clock give the same
  (granted, retry_after) sequence, levels and snapshots;
* the port's router over three port replicas (``ConvolutionService`` on a
  1x2 CPU grid) and the JAX router over three JAX replicas (a 1x2 CPU
  mesh) give the same answer bytes (the oracle's) and the same ``router``
  stamps (replica, home, attempts, failovers, spills) for the same
  request sequence, a killed home and its revival included; the same
  typed ``tenant_quota`` shed; the same converge stream;
* the crash drill on both: a durable converge stream abandoned after two
  rows, a new router over the same WAL resumes it from the newest token
  with the uninterrupted job's final bytes, exactly once, and the zombie
  is refused ``stale_epoch``; and a port router finishes, on port
  replicas, a job that the JAX router wrote into its WAL before its crash;
* the router's HTTP server takes a burst of connects beyond socketserver's
  default backlog of 5.

The replicas' kernel backends are not involved (``shifted``, whose name
and route key the two packages share); ``chip_smoke.py`` phase 4n drives
the router over replicas on the card.  Tolerance: u8 bytes and JSON
records equal.
"""

from __future__ import annotations

import base64
import json
import random
import socket
import threading
import time
import types

import jax
import numpy as np
import pytest

from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.resilience import degrade as jdegrade
from parallel_convolution_tpu.resilience import faults as jfaults
from parallel_convolution_tpu.serving import router as jrouter
from parallel_convolution_tpu.serving import service as jservice
from parallel_convolution_tpu_torch.ops import oracle
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh
from parallel_convolution_tpu_torch.resilience import degrade, faults
from parallel_convolution_tpu_torch.serving import router, service
from parallel_convolution_tpu_torch.utils import imageio

PORT = types.SimpleNamespace(
    name="port", router=router, service=service, faults=faults,
    grid=lambda: mesh.make_grid((1, 2), "cpu"))
JAX = types.SimpleNamespace(
    name="jax", router=jrouter, service=jservice, faults=jfaults,
    grid=lambda: jmesh.make_grid_mesh(jax.devices()[:2], (1, 2)))
SIDES = [PORT, JAX]
NAMES = ("r0", "r1", "r2")


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    for side in SIDES:
        side.faults.uninstall_plan()
    degrade.clear_probe_cache()
    jdegrade.clear_probe_cache()


def _factory(side):
    def make():
        return side.service.ConvolutionService(side.grid(),
                                               max_delay_s=0.002)
    return make


@pytest.fixture(scope="module")
def replicas():
    """One set of three in-process replicas a package, shared by the
    module's routers (each test revives what it kills)."""
    reps = {side.name: [side.router.InProcessReplica(_factory(side), name=n)
                        for n in NAMES] for side in SIDES}
    yield reps
    for rs in reps.values():
        for r in rs:
            r.close()


def _router(side, reps, **kw):
    kw.setdefault("start_health", False)
    kw.setdefault("breaker_cooldown_s", 0.2)
    return side.router.ReplicaRouter(reps, **kw)


def _img(rows=48, cols=64, seed=5):
    return imageio.generate_test_image(rows, cols, "grey", seed=seed)


def _body(img, **kw):
    body = {"image_b64": base64.b64encode(
        np.ascontiguousarray(img).tobytes()).decode("ascii"),
        "rows": img.shape[0], "cols": img.shape[1], "mode": "grey",
        "filter": "blur3"}
    body.update(kw)
    return body


def _image(wire, shape):
    return np.frombuffer(base64.b64decode(wire["image_b64"]),
                         np.uint8).reshape(shape)


# ------------------------------------------------------- keys and ring
def _seeded_bodies(n: int, seed: int = 0) -> list[dict]:
    rng = random.Random(seed)
    choice = {
        "rows": [48, 64, 1920], "cols": [64, 300, 2520],
        "mode": ["grey", "rgb"], "filter": ["blur3", "edge5", "jacobi3"],
        "iters": [1, 2, 10, 100], "backend": ["shifted", "separable"],
        "storage": ["f32", "bf16", "u8"], "fuse": [1, 4, 32],
        "boundary": ["zero", "periodic"], "quantize": [True, False],
        "overlap": [None, True], "tile": [None, 128],
        "check_every": [10, 5], "col_mode": ["packed", "strided"],
        "solver": ["jacobi", "multigrid"], "mg_levels": [None, 3]}
    out = []
    for _ in range(n):
        out.append({k: rng.choice(v) for k, v in choice.items()
                    if rng.random() < 0.8})
        out[-1]["request_id"] = f"q{rng.random()}"   # not part of the key
    return out


def test_route_key_equal_jax_on_seeded_bodies():
    assert router.ROUTE_KEY_FIELDS == jrouter.ROUTE_KEY_FIELDS
    bodies = _seeded_bodies(1000)
    keys = [router.route_key(b) for b in bodies]
    assert keys == [jrouter.route_key(b) for b in bodies]
    assert len(set(keys)) > 900


@pytest.mark.parametrize("members", [1, 2, 3, 4, 5])
def test_ring_candidates_equal_jax(members):
    names = [f"r{i}" for i in range(members)]
    keys = [router.route_key(b) for b in _seeded_bodies(1000, members)]
    rings = (router.HashRing(names), jrouter.HashRing(names))
    for _ in range(2):
        for k in keys:
            got = rings[0].candidates(k)
            assert got == rings[1].candidates(k)
            assert sorted(got) == sorted(rings[0].members())
        for ring in rings:   # add one member, then remove the first
            ring.add("x")
            ring.remove(names[0])


# -------------------------------------------------------------- quotas
def test_token_bucket_sequence_equal_jax():
    rng = random.Random(7)
    ops = [(rng.choice(["take", "take", "take", "refund", "absorb"]),
            rng.choice([0.5, 1.0, 2.5]), rng.random() * 0.7)
           for _ in range(300)]
    got = []
    for mod in (router, jrouter):
        clock = [0.0]
        b = mod.TokenBucket(rate=2.0, burst=3.0, clock=lambda: clock[0])
        seq, journal = [], []
        for op, n, dt in ops:
            clock[0] += dt
            if op == "take":
                seq.append(b.try_take(n, journal=journal.append))
            elif op == "refund":
                b.refund(n, journal=journal.append)
            else:
                b.absorb(n)
            seq.append(round(b.level(), 12))
        b.set_level(-1.5)
        seq.append(b.level())
        got.append((seq, journal))
    assert got[0] == got[1]


def test_tenant_quotas_equal_jax():
    rng = random.Random(3)
    calls = [(rng.choice(["greedy", "victim", "free", "t3"]),
              rng.choice([1.0, 0.25]), rng.random() * 0.3)
             for _ in range(200)]
    got = []
    for mod in (router, jrouter):
        clock = [0.0]
        q = mod.TenantQuotas(rate=1.0, burst=2.0,
                             overrides={"victim": (5.0, 4.0),
                                        "free": (0.0, 1.0)},
                             clock=lambda: clock[0])
        seq = []
        for tenant, n, dt in calls:
            clock[0] += dt
            seq.append(q.take(tenant, n))
        q.refund("greedy", 1.0)
        q.absorb("victim", 0.5)
        q.restore_level("t3", -0.5)
        got.append((seq, q.snapshot()))
    assert got[0] == got[1]


# ------------------------------------------------ routing and failover
def test_router_bytes_and_stamps_equal_jax_through_a_killed_home(replicas):
    """Two keys, each twice; the first key's home killed (failover) and
    revived (home again): the same bytes and the same stamps from both
    routers, every answer the oracle's, each key resident only on the
    replicas that served it."""
    img = _img()
    want = {it: oracle.run_serial_u8(img, get_filter("blur3"), it)
            for it in (1, 2)}
    seq = [1, 2, 1, 2, "kill", 1, 1, 2, "revive", 1]
    got = {}
    for side in SIDES:
        rt = _router(side, replicas[side.name])
        out, home = [], None
        try:
            for k, step in enumerate(seq):
                if step == "kill":
                    rt.replica(home).kill()
                    continue
                if step == "revive":
                    rt.replica(home).revive()
                    continue
                status, wire = rt.request(_body(img, iters=step,
                                                request_id=f"q{k}"))
                assert status == 200 and wire["ok"], wire
                np.testing.assert_array_equal(_image(wire, img.shape),
                                              want[step])
                home = home or wire["router"]["home"]
                out.append(dict(wire["router"], wire=wire["wire"],
                                cache=wire["cache"],
                                batch_size=wire["batch_size"]))
            served = {n: sorted(k.iters for k in rt.replica(
                n).service.engine._entries) for n in NAMES}
            got[side.name] = (out, served, rt.snapshot()["router"])
        finally:
            rt.close(close_replicas=False)
    assert got["port"] == got["jax"]
    stamps = got["port"][0]
    assert stamps[4]["replica"] != stamps[4]["home"]
    assert stamps[4]["failovers"] == 1 and stamps[4]["attempts"] == 2
    assert stamps[-1]["replica"] == stamps[-1]["home"]


def test_tenant_quota_shed_equal_jax(replicas):
    got = {}
    for side in SIDES:
        clock = [0.0]
        rt = _router(side, replicas[side.name],
                     quotas=side.router.TenantQuotas(
                         rate=1.0, burst=2.0, overrides={"polite": (0.0, 1.0)},
                         clock=lambda: clock[0]))
        try:
            out = []
            for k in range(5):
                for tenant in ("greedy", "polite"):
                    status, wire = rt.request(_body(
                        _img(), iters=1, request_id=f"t{tenant}{k}"),
                        tenant=tenant)
                    wire.pop("trace_id", None)
                    out.append((tenant, status, wire.get("rejected"),
                                wire.get("retryable"),
                                wire.get("retry_after_s"),
                                wire["router"]["replica"]))
            got[side.name] = (out, rt.stats["rejected_tenant_quota"])
        finally:
            rt.close(close_replicas=False)
    assert got["port"] == got["jax"]
    out = got["port"][0]
    assert any(r[0] == "greedy" and r[1:4] == (429, "tenant_quota", True)
               for r in out)
    assert all(r[1] == 200 for r in out if r[0] == "polite")


def _converge_body(img, **kw):
    return _body(img, quantize=True, tol=0.0, max_iters=40, check_every=10,
                 **kw)


def test_converge_stream_equal_jax(replicas):
    img = _img(seed=9)
    got = {}
    for side in SIDES:
        rt = _router(side, replicas[side.name])
        try:
            status, rows = rt.converge(_converge_body(img, request_id="c1"))
            rows = list(rows)
        finally:
            rt.close(close_replicas=False)
        assert status == 200
        got[side.name] = [(r["kind"], r["iters"], r.get("image_b64"),
                           r["router"]) for r in rows]
    assert got["port"] == got["jax"]
    assert [r[0] for r in got["port"]] == ["snapshot"] * 4 + ["final"]
    np.testing.assert_array_equal(
        _image({"image_b64": got["port"][-1][2]}, img.shape),
        oracle.run_serial_u8(img, get_filter("blur3"), 40))


# --------------------------------------------------- the crash drill
def _crash_drill(side, reps, wal_path, img):
    """The JAX package's router-crash drill on one side: returns what the
    comparison reads."""
    r1 = _router(side, reps, wal=str(wal_path))
    consumed = []
    st, rows = r1.converge(_converge_body(img, request_id="j1"),
                           tenant="t")
    for row in rows:
        consumed.append(row)
        if len(consumed) == 2:
            break            # the crash: the stream abandoned unclosed
    r2 = _router(side, reps, wal=str(wal_path))
    zs, zw = r1.request(_body(img, iters=1, request_id="z"), tenant="t")
    r1.close(close_replicas=False)
    st2, rows2 = r2.converge(_converge_body(img, request_id="j1"),
                             tenant="t")
    got = list(rows2)
    out = {"epochs": (r1.epoch, r2.epoch),
           "recovery": {k: v for k, v in r2.recovery.items()
                        if k != "detail"},
           "consumed": [(r["iters"], r["router"]["epoch"])
                        for r in consumed],
           "zombie": (zs, zw["rejected"], zw["retryable"]),
           "retry": [(r["kind"], r["iters"], r["router"].get(
               "resume_count")) for r in got],
           "final": got[-1]["image_b64"],
           "finals": sum(r["kind"] == "final" for r in consumed + got)}
    r2.close(close_replicas=False)
    return out


def test_crash_takeover_resume_exactly_once_equal_jax(replicas, tmp_path):
    img = _img(seed=11)
    got = {side.name: _crash_drill(side, replicas[side.name],
                                   tmp_path / f"{side.name}.wal", img)
           for side in SIDES}
    assert got["port"] == got["jax"]
    out = got["port"]
    assert out["epochs"] == (1, 2) and out["finals"] == 1
    assert out["zombie"] == (409, "stale_epoch", False)
    assert out["retry"][0][1] > out["consumed"][-1][0]
    assert out["retry"][-1][0] == "final" and out["retry"][-1][2] >= 1
    np.testing.assert_array_equal(
        _image({"image_b64": out["final"]}, img.shape),
        oracle.run_serial_u8(img, get_filter("blur3"), 40))


def test_port_router_finishes_a_job_from_a_jax_wal(replicas, tmp_path):
    """The JAX router journals a durable converge job and crashes after
    two rows; a port router over the same WAL and port replicas of the
    same names resumes it from the JAX token (its f32 carry) and ends
    with the JAX job's final bytes, delivered once."""
    img = _img(seed=13)
    wal_path = tmp_path / "r.wal"
    clean = _router(JAX, replicas["jax"][:1])
    _, rows = clean.converge(_converge_body(img, request_id="clean"))
    want = list(rows)[-1]
    clean.close(close_replicas=False)
    r1 = _router(JAX, replicas["jax"], wal=str(wal_path))
    _, rows = r1.converge(_converge_body(img, request_id="j2"), tenant="t")
    consumed = [next(rows), next(rows)]   # then the crash
    r2 = _router(PORT, replicas["port"], wal=str(wal_path))
    try:
        # The new epoch passes the WAL's and every port replica's fence.
        assert r2.epoch > r1.epoch and r2.recovery["jobs_restored"] == 1
        _, rows2 = r2.converge(_converge_body(img, request_id="j2"),
                               tenant="t")
        got = list(rows2)
    finally:
        r2.close(close_replicas=False)
        r1.close(close_replicas=False)
    assert got[0]["iters"] == consumed[-1]["iters"] + 10
    assert [r["kind"] for r in got].count("final") == 1
    assert got[-1]["kind"] == "final" and got[-1]["iters"] == want["iters"]
    assert got[-1]["image_b64"] == want["image_b64"]
    assert got[-1]["router"]["resume_count"] == 1


# -------------------------------------------------------- HTTP server
def test_router_http_server_takes_a_burst_of_connects(replicas):
    """Sixteen clients connecting at once all get through without a SYN
    retransmit (the router listens with a backlog of 128, as the replica
    frontend does), and a convolve through it answers the oracle's bytes
    with the router's stamp."""
    rt = _router(PORT, replicas["port"])
    srv = router.make_router_http_server(rt, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        assert srv.request_queue_size >= 16
        host, port = srv.server_address[:2]
        t0 = time.perf_counter()
        socks = [socket.create_connection((host, port), timeout=10)
                 for _ in range(16)]
        assert time.perf_counter() - t0 < 0.9
        try:
            for s in socks:
                s.sendall(b"GET /readyz HTTP/1.1\r\nHost: x\r\n"
                          b"Connection: close\r\n\r\n")
            for s in socks:
                assert s.recv(64).startswith(b"HTTP/1.1 200")
        finally:
            for s in socks:
                s.close()
        import urllib.request

        img = _img(seed=4)
        req = urllib.request.Request(
            f"http://{host}:{port}/v1/convolve",
            data=json.dumps(_body(img, iters=2)).encode(),
            headers={"Content-Type": "application/json",
                     "x-tenant": "web"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            wire = json.loads(resp.read())
        np.testing.assert_array_equal(
            _image(wire, img.shape),
            oracle.run_serial_u8(img, get_filter("blur3"), 2))
        assert wire["router"]["replica"] in NAMES
    finally:
        srv.shutdown()
        srv.server_close()
        rt.close(close_replicas=False)
        th.join(30)
