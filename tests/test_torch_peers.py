"""The sharded control plane in the port (``serving/peers.py``) held
against the JAX package's on the CPU.

* ``shard_of`` and ``wal_path`` agree on 1000 seeded route keys for one
  to five shards (so either package can take over the other's lineage);
* ``ShardMap`` (seeds, ``set_owner``, ``merge``, the derived version) and
  ``DebtLog`` (cursors, and the cumulative reset for a cursor that fell
  off the bounded log) give the same answers on the same seeded
  operations;
* a three-router in-process fleet on each side (port routers over port
  replicas on a 1x2 CPU grid, JAX routers over JAX replicas on a 1x2
  mesh): the same typed ``wrong_shard`` 421, the same deterministic
  successor and epochs through a ``hard_stop``, the zombie refused
  ``stale_epoch``, and the client's resumed final with the same bytes
  (the oracle's), once; the debt log carries a tenant's charge to a peer;
* a shard lineage that the JAX ``ShardRouter`` wrote and ``hard_stop``ped
  is taken over by the port's, which finishes the converge with JAX's
  bytes;
* the ``/v1/shardmap`` and ``/v1/peersync`` bodies of the two routers'
  HTTP servers are equal for the same state, and ``HTTPPeer`` reads them.

The replicas' kernel backends are not involved (``shifted``);
``chip_smoke.py`` phase 4o drives the fleet over replicas on the card.
Tolerance: u8 bytes and JSON bodies equal.
"""

from __future__ import annotations

import base64
import json
import random
import threading
import types
import urllib.request

import jax
import numpy as np
import pytest

from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.serving import peers as jpeers
from parallel_convolution_tpu.serving import router as jrouter
from parallel_convolution_tpu.serving import service as jservice
from parallel_convolution_tpu_torch.ops import oracle
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh
from parallel_convolution_tpu_torch.serving import peers, router, service
from parallel_convolution_tpu_torch.utils import imageio

PORT = types.SimpleNamespace(
    name="port", peers=peers, router=router, service=service,
    grid=lambda: mesh.make_grid((1, 2), devices=["cpu", "cpu"]))
JAX = types.SimpleNamespace(
    name="jax", peers=jpeers, router=jrouter, service=jservice,
    grid=lambda: jmesh.make_grid_mesh(jax.devices()[:2], (1, 2)))
SIDES = [PORT, JAX]
NAMES = ["rA", "rB", "rC"]
ASSIGN = {"0": "rA", "1": "rB", "2": "rC"}


def _factory(side):
    def make():
        return side.service.ConvolutionService(side.grid(),
                                               max_delay_s=0.002)
    return make


@pytest.fixture(scope="module")
def replicas():
    """Two in-process replicas a package, shared by the module's
    fleets."""
    reps = {side.name: [side.router.InProcessReplica(_factory(side),
                                                     name=f"w{i}")
                        for i in range(2)] for side in SIDES}
    yield reps
    for rs in reps.values():
        for r in rs:
            r.close()


def _img(rows=32, cols=48, seed=5):
    return imageio.generate_test_image(rows, cols, "grey", seed=seed)


def _body(img, **kw):
    body = {"image_b64": base64.b64encode(
        np.ascontiguousarray(img).tobytes()).decode("ascii"),
        "rows": img.shape[0], "cols": img.shape[1], "mode": "grey",
        "filter": "blur3"}
    body.update(kw)
    return body


def _converge_body(img, **kw):
    return _body(img, quantize=True, tol=0.0, max_iters=40, check_every=10,
                 **kw)


def _fleet(side, reps, state_dir, quotas=None, **kw):
    """Three single-shard routers of ``side`` over ``reps``, their
    in-process peer links wired, no background threads."""
    routers = {}
    for nm in NAMES:
        routers[nm] = side.peers.ShardRouter(
            nm, reps, n_shards=3,
            owned=[s for s, o in ASSIGN.items() if o == nm],
            state_dir=state_dir, assignments=ASSIGN,
            quotas=None if quotas is None else quotas[nm],
            start_sync=False, start_health=False, breaker_cooldown_s=0.2,
            wal_fsync=False, **kw)
    for nm in NAMES:
        routers[nm].peers = [side.peers.InProcessPeer(routers[o])
                             for o in NAMES if o != nm]
    return routers


def _close(routers):
    for r in routers.values():
        try:
            r.close(close_replicas=False)
        except Exception:  # noqa: BLE001 — a hard-stopped router
            pass


# ------------------------------------------------ partition and map
def _keys(n: int, seed: int) -> list[str]:
    rng = random.Random(seed)
    return [router.route_key({"rows": rng.randrange(8, 4096),
                              "cols": rng.randrange(8, 4096),
                              "iters": rng.randrange(1, 200),
                              "filter": rng.choice(["blur3", "edge5"]),
                              "backend": "shifted"})
            for _ in range(n)]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5])
def test_shard_of_and_wal_path_equal_jax(n_shards, tmp_path):
    keys = _keys(1000, n_shards)
    got = [peers.shard_of(k, n_shards) for k in keys]
    assert got == [jpeers.shard_of(k, n_shards) for k in keys]
    assert set(got) == {str(s) for s in range(n_shards)}
    for s in set(got):
        assert peers.wal_path(tmp_path, s) == jpeers.wal_path(tmp_path, s)


@pytest.mark.parametrize("seed", range(4))
def test_shard_map_merges_and_versions_equal_jax(seed):
    rng = random.Random(seed)
    ops = []
    for _ in range(120):
        op = rng.choice(["seed", "set", "set", "merge"])
        shard = str(rng.randrange(4))
        owner = rng.choice(NAMES)
        epoch = rng.randrange(0, 6)
        addr = rng.choice([None, f"http://{owner}:1"])
        if op == "merge":
            wire = {"shards": {str(rng.randrange(4)): {
                "owner": rng.choice(NAMES), "epoch": rng.randrange(0, 6),
                "addr": addr} for _ in range(rng.randrange(0, 3))}}
            if rng.random() < 0.2:
                wire["shards"]["9"] = {"owner": "x", "epoch": "bad"}
            ops.append(("merge", wire))
        else:
            ops.append((op, (shard, owner, epoch, addr)))
    out = []
    for mod in (peers, jpeers):
        m = mod.ShardMap(4)
        seq = []
        for op, arg in ops:
            if op == "seed":
                s, o, e, a = arg
                m.seed(s, o, addr=a, epoch=e)
            elif op == "set":
                s, o, e, a = arg
                seq.append(m.set_owner(s, o, e, addr=a))
            else:
                seq.append(m.merge(arg))
            seq.append((m.version(), m.owner("0"), m.owner("3")))
        out.append((seq, m.to_wire()))
    assert out[0] == out[1]
    assert out[0][1]["version"] == sum(
        e["epoch"] for e in out[0][1]["shards"].values())


@pytest.mark.parametrize("cap", [3, 8, 4096])
def test_debt_log_cursors_and_resets_equal_jax(cap):
    rng = random.Random(cap)
    ops = [(rng.choice(["record", "record", "since"]),
            rng.choice(["t1", "t2", "t3"]), rng.choice([1.0, -0.5, 2.25]),
            rng.randrange(0, 40)) for _ in range(200)]
    out = []
    for mod in (peers, jpeers):
        log = mod.DebtLog(cap=cap)
        seq = []
        for op, tenant, delta, cursor in ops:
            if op == "record":
                seq.append(log.record(tenant, delta))
            else:
                seq.append(log.since(cursor))
        seq.append(log.snapshot())
        out.append(seq)
    assert out[0] == out[1]
    resets = [r for r in out[0] if isinstance(r, dict) and r.get("reset")]
    assert bool(resets) == (cap < 100)


# ------------------------------------------------- the fleet, end to end
def _drill(side, reps, state_dir, img):
    """The JAX test_wal fleet drill on one side: the converge's owner is
    hard-stopped after two rows; returns what the comparison reads."""
    quotas = {nm: side.router.TenantQuotas(rate=1.0, burst=4.0,
                                           clock=lambda: 0.0)
              for nm in NAMES}
    routers = _fleet(side, reps, state_dir, quotas, clock=lambda: 0.0)
    try:
        client = side.peers.ShardClient(list(routers.values()))
        body = _converge_body(img, request_id="job-1", tenant="t1")
        shard = side.peers.shard_of(side.router.route_key(dict(body)), 3)
        victim = routers[ASSIGN[shard]]
        other = next(r for r in routers.values() if r is not victim)
        ws, wrong = other.request(dict(body, request_id="w"))
        status, rows = client.converge(dict(body))
        consumed = [next(rows), next(rows)]
        victim.hard_stop()
        survivors = [r for r in routers.values() if r is not victim]
        for r in survivors:
            for _ in range(r.suspect_after + 1):
                r.sync_now()
        owners = [r.name for r in survivors if shard in r._sub]
        successor = routers[owners[0]]
        _, zrows = victim.sub(shard).converge(dict(body, request_id="z"))
        zombie = next(iter(zrows))
        client.refresh()
        status2, rows2 = client.converge(dict(body))
        got = list(rows2)
        # Fleet-wide quota: a charge on one router reaches its peers.
        lvl = quotas[owners[0]].bucket("t2").level()
        other_live = next(r for r in survivors if r is not successor)
        quotas[other_live.name].take("t2", 3.0)
        other_live.debts.record("t2", 3.0)
        successor.sync_now()
        return {
            "shard": shard, "victim": victim.name, "owners": owners,
            "wrong": (ws, {k: v for k, v in wrong.items()}),
            "status": (status, status2),
            "consumed": [(r["kind"], r["iters"], r["router"]["shard"],
                          r["router"]["epoch"]) for r in consumed],
            "epochs": (victim.sub(shard).epoch,
                       successor.sub(shard).epoch),
            "takeovers": successor.stats["takeovers"],
            "zombie": (zombie["rejected"], zombie.get("retryable")),
            "retry": [(r["kind"], r["iters"], r["router"].get(
                "resume_count"), r["router"]["shard"]) for r in got],
            "final": got[-1]["image_b64"],
            "debt_absorbed": round(
                lvl - quotas[owners[0]].bucket("t2").level(), 9),
            "map": successor.shardmap_wire(),
        }
    finally:
        _close(routers)


def test_fleet_takeover_resume_and_quota_equal_jax(replicas, tmp_path):
    img = _img(seed=21)
    got = {side.name: _drill(side, replicas[side.name],
                             tmp_path / side.name, img) for side in SIDES}
    for out in got.values():
        # The map's addr-less entries and "from" name the same routers.
        out["map"].pop("from")
    assert got["port"] == got["jax"]
    out = got["port"]
    ws, wrong = out["wrong"]
    assert ws == 421 and wrong["rejected"] == "wrong_shard"
    assert wrong["retryable"] and wrong["owner"] == out["victim"]
    assert out["status"] == (200, 200) and out["takeovers"] == 1
    assert len(out["owners"]) == 1
    assert out["epochs"][1] == out["epochs"][0] + 1
    assert out["zombie"][0] == "stale_epoch"
    assert out["retry"][0][1] > out["consumed"][-1][1]
    assert [r[0] for r in out["retry"]].count("final") == 1
    assert out["retry"][-1][0] == "final" and out["retry"][-1][2] >= 1
    assert out["debt_absorbed"] == 3.0
    assert out["map"]["shards"][out["shard"]]["owner"] == out["owners"][0]
    np.testing.assert_array_equal(
        np.frombuffer(base64.b64decode(out["final"]),
                      np.uint8).reshape(img.shape),
        oracle.run_serial_u8(img, get_filter("blur3"), 40))


def test_port_takes_over_a_jax_shard_lineage(replicas, tmp_path):
    """A JAX fleet journals a converge in its shard lineage and its owner
    is hard-stopped after two rows; a port ShardRouter over the same
    state dir (port replicas of the same names) takes the shard over —
    an epoch past the JAX owner's — and finishes the job with the JAX
    job's final bytes, once."""
    img = _img(seed=23)
    body = _converge_body(img, request_id="job-x", tenant="t1")
    shard = jpeers.shard_of(jrouter.route_key(dict(body)), 3)
    clean = jrouter.ReplicaRouter(replicas["jax"][:1], start_health=False)
    _, rows = clean.converge(dict(body, request_id="clean"))
    want = list(rows)[-1]
    clean.close(close_replicas=False)
    jfleet = _fleet(JAX, replicas["jax"], tmp_path)
    victim = jfleet[ASSIGN[shard]]
    _, rows = victim.converge(dict(body))
    consumed = [next(rows), next(rows)]
    victim.hard_stop()
    survivor = peers.ShardRouter(
        "pX", replicas["port"], n_shards=3, owned=[], state_dir=tmp_path,
        assignments=ASSIGN, start_sync=False, start_health=False,
        wal_fsync=False)
    try:
        survivor.takeover(shard, from_owner=victim.name)
        sub = survivor.sub(shard)
        assert sub.epoch == victim.sub(shard).epoch + 1
        assert sub.recovery["jobs_restored"] == 1
        assert survivor.stats["takeovers"] == 1
        _, rows2 = survivor.converge(dict(body))
        got = list(rows2)
    finally:
        survivor.close(close_replicas=False)
        _close(jfleet)
    assert got[0]["iters"] == consumed[-1]["iters"] + 10
    assert [r["kind"] for r in got].count("final") == 1
    assert got[-1]["kind"] == "final" and got[-1]["iters"] == want["iters"]
    assert got[-1]["image_b64"] == want["image_b64"]
    assert got[-1]["router"]["resume_count"] == 1
    assert got[-1]["router"]["shard"] == shard


# ---------------------------------------------------------- HTTP plane
def _serve(side, rt):
    srv = side.router.make_router_http_server(rt, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return srv, th, f"http://127.0.0.1:{srv.server_address[1]}"


def test_shardmap_and_peersync_bodies_equal_jax(tmp_path):
    """Fresh replicas: every epoch starts past their empty fences."""
    bodies = {}
    for side in SIDES:
        reps = [side.router.InProcessReplica(_factory(side), name="h0")]
        routers = _fleet(side, reps, tmp_path / side.name)
        rt = routers["rB"]
        rt.debts.record("t1", 2.5)
        rt.debts.record("t2", -1.0)
        srv, th, url = _serve(side, rt)
        try:
            with urllib.request.urlopen(url + "/v1/shardmap",
                                        timeout=30) as r:
                smap = json.loads(r.read())
            req = urllib.request.Request(
                url + "/v1/peersync",
                data=json.dumps({"from": "rA",
                                 "cursors": {"rB": 1}}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                sync = json.loads(r.read())
            link = side.peers.HTTPPeer("rB", url)
            assert link.shardmap() == smap
            assert link.sync({"cursors": {"rB": 0}})["debts"]["rB"][
                "deltas"] == [[1, "t1", 2.5], [2, "t2", -1.0]]
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(30)
            _close(routers)
            reps[0].close()
        bodies[side.name] = (smap, sync)
    assert bodies["port"] == bodies["jax"]
    smap, sync = bodies["port"]
    assert smap["version"] == 1 and smap["from"] == "rB"
    assert {s: e["owner"] for s, e in smap["shards"].items()} == ASSIGN
    assert sync["debts"] == {"rB": {"reset": False, "seq": 2,
                                    "deltas": [[2, "t2", -1.0]]}}


def test_wrong_shard_over_http_is_a_421(replicas, tmp_path):
    routers = _fleet(PORT, replicas["port"], tmp_path)
    img = _img(seed=3)
    body = _body(img, iters=2)
    shard = peers.shard_of(router.route_key(dict(body)), 3)
    other = next(r for r in routers.values() if shard not in r._sub)
    srv, th, url = _serve(PORT, other)
    try:
        req = urllib.request.Request(
            url + "/v1/convolve", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        wire = json.loads(e.value.read())
        assert e.value.code == 421
        assert wire["rejected"] == "wrong_shard" and wire["retryable"]
        assert wire["owner"] == ASSIGN[shard] and wire["shard"] == shard
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(30)
        _close(routers)
