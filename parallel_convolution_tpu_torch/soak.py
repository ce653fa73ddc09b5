#!/usr/bin/env python
"""Randomized cross-backend byte-compare soak, and the fleet's drills.

``python -m parallel_convolution_tpu_torch.soak`` (the JAX package's
``scripts/soak.py``): samples random (backend, storage, boundary, grid,
filter, fuse, tile, interior_split, geometry) configurations and requires
every one to be byte-identical to the NumPy oracle through the full
distributed path (``step.sharded_iterate``, one block on each of the
grid's R·C slots of the card, or of the CPU with ``--device cpu``).  This
is the tests' bit-exactness property run at campaign scale, at awkward
sizes (24-180 px) that no fixed path reaches.  A seed draws the JAX
script's configurations, its Pallas backends named as the port names
them (``pallas`` / ``pallas_sep`` / ``pallas_rdma`` are ``cuda`` /
``cuda_sep`` / ``cuda_rdma``):

  python -m parallel_convolution_tpu_torch.soak --n 64 --seed 0
  python -m parallel_convolution_tpu_torch.soak --n 8 --device cpu

One JSON row per config (failures carry the config verbatim), one
summary row at the end; exit 0 iff every config matched.

``--faults N`` is the resilience soak: N random fault plans
(``resilience.faults`` specs — checkpoint tears, compile/exchange
crashes) are sampled and each trial runs as a leg of the supervised
runner (``resilience.supervisor``) in a child process on the same device:
inject → crash mid-checkpointed-run → resume clean → byte-compare against
the oracle:

  python -m parallel_convolution_tpu_torch.soak --faults 16 --seed 0

``--serve --faults N`` runs the same drill through the SERVING engine:
each trial installs a random compile/exchange fault plan, pushes a burst
of requests through an in-process ConvolutionService — whose
with_retry/degradation wiring must heal the injected faults into
byte-identical responses — then simulates the restart (plan
uninstalled, probe cache cleared, fresh service) and requires clean
service:

  python -m parallel_convolution_tpu_torch.soak --serve --faults 8 --seed 0

``--reshape N`` is the ELASTIC-RECOVERY drill: each trial crashes a
checkpointed run on a 2x4 grid at a random injected fault site, then
resumes the crash's snapshot dir on each of the 1x2, 2x2, and 1x1 grids
— the checkpoint resharding path — and requires every resumed output
byte-identical to the single-device oracle:

  python -m parallel_convolution_tpu_torch.soak --reshape 8 --seed 0

``--router-kill N`` is the REPLICA-ROUTER drill: boot three in-process
replicas behind ``serving.router.ReplicaRouter``, push continuous traffic
while killing and reviving one replica per cycle (N cycles), and require
ZERO non-rejected failures with every completed response byte-identical
to the oracle, plus at least one client-observed failover:

  python -m parallel_convolution_tpu_torch.soak --router-kill 3 --seed 0

``--chaos N`` is the CHAOS-TRANSPORT drill: three in-process replicas
behind the durable router, every transport wrapped in
``serving.chaos.ChaosTransport``; each of the N cycles samples a seeded
transport-fault schedule and drives mixed batch + converge traffic
through it, killing the serving replica mid-stream on even cycles.
Gates: zero non-rejected failures, every completed batch response AND
converge final row byte-identical to the uninterrupted oracle, >= 1
mid-stream resume observed, exactly one final row per request_id:

  python -m parallel_convolution_tpu_torch.soak --chaos 4 --seed 0

``--router-restart N`` is the CRASH-SAFE CONTROL-PLANE drill: one WAL
lineage, N router lives.  Each cycle constructs a fresh ``ReplicaRouter``
over the SAME WAL (a fenced takeover: the epoch must strictly increase),
finishes the PREVIOUS life's crash-interrupted converge job via a client
retry — which must RESUME from the recovered ledger token and end
byte-identical to the uninterrupted oracle with exactly one final row per
request_id — then starts a new converge job, crashes the router
mid-stream at a seeded ``router_kill`` row, and verifies the dead life's
object is rejected typed ``stale_epoch`` as a zombie:

  python -m parallel_convolution_tpu_torch.soak --router-restart 3 --seed 0

``--shard-kill N`` (three ``serving.peers.ShardRouter`` s, a fenced
takeover a cycle), ``--autoscale N`` (``serving.autoscaler``'s grow and
shrink) and ``--chaos-matrix N`` (``serving.chaos_matrix``) are the
sharded control plane's, the autoscaler's and the storage drills.

Every mode runs on the card unless ``--device cpu`` asks for the CPU:
each drill's replicas and grids are slots of that device.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

MESH_SHAPES = [(1, 1), (1, 2), (2, 2), (4, 2), (2, 4), (8, 1), (1, 8)]
FILTERS = ["blur3", "box3", "gaussian5", "edge5", "sharpen3", "jacobi3"]
# The JAX script's list in its order, each Pallas backend under the port's
# name for it (utils.config.BACKEND_FROM_REFERENCE), so a seed draws the
# same configurations.
BACKENDS = ["shifted", "cuda", "cuda_sep", "cuda_rdma"]


def slot_grid(shape, device=None):
    """An R x C grid with one block on each of R·C slots of ``device``
    (the card by default, ``cpu`` on request): the port's stand-in for the
    JAX script's R·C devices of a CPU mesh."""
    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    r, c = (int(v) for v in shape)
    return make_grid((r, c), devices=[dev] * (r * c))


def sample(rng: random.Random) -> dict:
    backend = rng.choice(BACKENDS)
    cfg = {
        "backend": backend,
        "filter": rng.choice(FILTERS),
        "mesh": rng.choice(MESH_SHAPES),
        "channels": rng.choice([1, 1, 3]),
        "H": rng.randrange(24, 180),
        "W": rng.randrange(24, 180),
        "iters": rng.randrange(1, 6),
        "boundary": rng.choice(["zero", "zero", "periodic"]),
        "storage": rng.choice(["f32", "bf16", "u8"]),
        "fuse": 1,
        "interior_split": False,
        "tile": None,
        "img_seed": rng.randrange(10_000),
    }
    if backend == "cuda_rdma":
        # rdma carries the exchange in-kernel; the JAX script samples it
        # at fuse 1, and its kernel wants blocks >= a couple of rows: keep
        # the random geometry but a divisible-ish floor on size.
        cfg["H"] = max(cfg["H"], 32)
        cfg["W"] = max(cfg["W"], 32)
        cfg["storage"] = rng.choice(["f32", "bf16"])
    else:
        # step.py clamps fuse to min(fuse, iters); record the EFFECTIVE
        # value so the evidence rows state what actually ran.
        cfg["fuse"] = min(rng.choice([1, 2, 3, 4, 8]), cfg["iters"])
    if backend in ("cuda", "cuda_sep"):
        if rng.random() < 0.3:
            cfg["tile"] = (8 * rng.randrange(1, 4), 128)
        # step.py takes the non-split path under periodic; only record
        # the flag where it is actually exercised.
        if (backend == "cuda_sep" and cfg["fuse"] > 1
                and cfg["boundary"] == "zero" and rng.random() < 0.5):
            cfg["interior_split"] = True
    return cfg


def sample_converge(rng: random.Random) -> dict:
    backend = rng.choice(BACKENDS)
    # The convergence soak compares FLOAT mode (the oracle's
    # run_to_convergence_f32 semantics), and cuda_sep's rank-1 form is
    # bit-identical in quantize mode, a rounding-order change in float
    # mode — so cuda_sep draws keep to the non-separable smoother, where
    # it runs the 2D order.
    choices = (["jacobi3"] if backend == "cuda_sep"
               else ["jacobi3", "blur3", "gaussian5"])
    cfg = {
        "mode": "converge",
        "backend": backend,
        # Smoothers, so runs actually converge inside max_iters often;
        # non-convergent draws simply exercise the max_iters exit.
        "filter": rng.choice(choices),
        "mesh": rng.choice(MESH_SHAPES),
        "H": rng.randrange(24, 120),
        "W": rng.randrange(24, 120),
        "tol": rng.choice([0.01, 0.05, 0.2, 0.5]),
        "max_iters": rng.randrange(20, 120),
        "check_every": rng.randrange(1, 11),
        "boundary": rng.choice(["zero", "zero", "periodic"]),
        "fuse": 1 if backend == "cuda_rdma" else rng.choice([1, 2, 4, 8]),
        "img_seed": rng.randrange(10_000),
    }
    # The convergence runner clamps fuse to check_every; record the
    # effective value, as in sample().
    cfg["fuse"] = min(cfg["fuse"], cfg["check_every"])
    if backend == "cuda_rdma":
        cfg["H"] = max(cfg["H"], 32)
        cfg["W"] = max(cfg["W"], 32)
    return cfg


def fma_exact(filt) -> bool:
    """Whether a kernel's FMA and the plain multiply-then-add round alike
    on any float32 data: every tap 0 or a power of two, so every product
    is exact.  (jacobi3 and blur3 are; gaussian5's 6/256 and 36/256 are
    not.)"""
    t = np.abs(np.asarray(filt.taps, dtype=np.float64))
    nz = t[t > 0]
    return bool(np.all(nz == 2.0 ** np.round(np.log2(nz))))


def run_converge(cfg, grid, device) -> dict:
    """The convergence soak under the float-mode contract: the sampled
    backend must agree with the port's own ``shifted`` reference on a 1x1
    grid of the same device — the same iteration count, and BIT-identical
    bytes where the filter's taps are powers of two (the kernels' one FMA
    a tap and the plain multiply-then-add then round alike); with other
    taps a kernel backend (``cuda*``) rounds each tap once where the plain
    version rounds twice, the port's stated float contract, and agrees
    within ``stencil.float_tolerance`` over the run's iterations — and
    ulp-level ``allclose`` to the two-rounding oracle.  Iteration counts
    vs the oracle may differ by at most one check chunk (an ulp at the tol
    threshold flips one check)."""
    import torch

    from parallel_convolution_tpu_torch.ops import filters, oracle, stencil
    from parallel_convolution_tpu_torch.parallel import step
    from parallel_convolution_tpu_torch.utils import imageio

    filt = filters.get_filter(cfg["filter"])
    img = imageio.generate_test_image(cfg["H"], cfg["W"], "grey",
                                      seed=cfg["img_seed"]).astype(np.float32)
    want, want_iters = oracle.run_to_convergence_f32(
        img, filt, tol=cfg["tol"], max_iters=cfg["max_iters"],
        check_every=cfg["check_every"], boundary=cfg["boundary"])
    got, got_iters = step.sharded_converge(
        img[None], filt, tol=cfg["tol"], max_iters=cfg["max_iters"],
        check_every=cfg["check_every"], grid=grid, quantize=False,
        backend=cfg["backend"], boundary=cfg["boundary"], fuse=cfg["fuse"])
    got = got.cpu().numpy()[0]
    ref, ref_iters = step.sharded_converge(
        img[None], filt, tol=cfg["tol"], max_iters=cfg["max_iters"],
        check_every=cfg["check_every"], grid=slot_grid((1, 1), device),
        quantize=False, backend="shifted", boundary=cfg["boundary"])
    ref = ref.cpu().numpy()[0]
    row = {}
    if cfg["backend"] == "shifted" or fma_exact(filt):
        ref_ok = row["bit_vs_shifted_1x1"] = bool(
            got_iters == ref_iters and np.array_equal(got, ref))
    else:
        rtol, atol = stencil.float_tolerance(filt, max(1, got_iters),
                                             torch.float32)
        ref_ok = row["fma_vs_shifted_1x1"] = bool(
            got_iters == ref_iters
            and np.allclose(got, ref, rtol=rtol, atol=atol))
        row["max_abs_vs_shifted"] = float(np.abs(got - ref).max())
    if got_iters != want_iters:
        # An ulp at the tol threshold legitimately flips one check; the
        # two snapshots are then a chunk apart and differ by up to
        # ~check_every*tol.  Compare value agreement at the SAME
        # iteration count instead.
        want = oracle.run_serial_f32(img, filt, got_iters,
                                     boundary=cfg["boundary"])
    oracle_ok = bool(
        abs(got_iters - want_iters) <= cfg["check_every"]
        and np.allclose(got, want, rtol=0, atol=1e-3))
    row.update(ok=ref_ok and oracle_ok, allclose_vs_oracle=oracle_ok)
    if not row["ok"]:
        row.update(want_iters=want_iters, got_iters=got_iters,
                   ref_iters=ref_iters)
    return row


def _write_trial(out_path: str, row: dict) -> None:
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(row))
    print(json.dumps(row), flush=True)


def run_fault_trial(spec: str, seed: int, out_path: str,
                    device=None) -> int:
    """One injected-fault drill: crash a checkpointed run, resume, compare.

    Runs in its own process (the supervised runner spawns it on the same
    device as the soak) so an injected build-time fault can't poison the
    caches of sibling trials.  Exit 0 iff the resumed output is
    byte-identical to the oracle.
    """
    from parallel_convolution_tpu_torch.ops import filters, oracle
    from parallel_convolution_tpu_torch.parallel import step
    from parallel_convolution_tpu_torch.resilience import faults
    from parallel_convolution_tpu_torch.utils import checkpoint, imageio

    rng = random.Random(seed)
    filt = filters.get_filter(rng.choice(["blur3", "gaussian5", "sharpen3"]))
    H, W = rng.randrange(33, 70), rng.randrange(33, 70)
    total, every = rng.randrange(5, 11), rng.randrange(2, 4)
    # Slots may repeat a device: every shape of the JAX script's list fits.
    shape = rng.choice([(1, 2), (2, 2), (2, 4)])
    grid = slot_grid(shape, device)
    img = imageio.generate_test_image(H, W, "grey", seed=seed)
    x = imageio.interleaved_to_planar(img).astype(np.float32)
    ck = tempfile.mkdtemp(prefix="pctpu_fault_trial_")

    crashed = None
    with faults.injected(spec, seed=seed) as plan:
        try:
            xs, valid_hw, _ = step._prepare(x, grid)
            checkpoint.run_checkpointed(xs, filt, total, grid, valid_hw,
                                        ckpt_dir=ck, every=every)
        except Exception as e:  # noqa: BLE001 — the injected crash
            crashed = repr(e)
        fired = plan.fired
    # The restarted process: fresh input, no plan — must auto-resume from
    # whatever (possibly torn) checkpoint state the crash left behind.
    xs2, valid_hw, _ = step._prepare(x, grid)
    out = checkpoint.run_checkpointed(xs2, filt, total, grid, valid_hw,
                                      ckpt_dir=ck, every=every)
    got = step._global_f32(out, grid, valid_hw).cpu().numpy()
    want = oracle.run_serial_u8(img, filt, total)
    ok = bool(np.array_equal(got[0].astype(np.uint8), want))
    row = {
        "ok": ok, "spec": spec, "seed": seed, "crashed": crashed,
        "fired": [list(f) for f in fired], "filter": filt.name,
        "H": H, "W": W, "total": total, "every": every,
        "mesh": "x".join(map(str, shape)), "device": str(grid.device),
    }
    _write_trial(out_path, row)
    return 0 if ok else 1


def run_serve_trial(spec: str, seed: int, out_path: str,
                    device=None) -> int:
    """One injected-fault drill through the serving engine.

    Phase 1 (faulted): with ``spec`` installed, a burst of same-key
    requests flows through an in-process ConvolutionService; the engine's
    retry + per-key degradation must turn every injected transient
    compile/exchange fault into a byte-identical response (possibly on a
    degraded effective backend — recorded in the row).
    Phase 2 ("resume"): plan uninstalled and probe cache cleared — the
    fresh-process state after a restart — then a fresh service must serve
    the same key cleanly on the REQUESTED tier.  Exit 0 iff every
    response in both phases is byte-identical to the oracle.
    """
    from parallel_convolution_tpu_torch.ops import filters, oracle
    from parallel_convolution_tpu_torch.resilience import degrade, faults
    from parallel_convolution_tpu_torch.resilience.retry import RetryPolicy
    from parallel_convolution_tpu_torch.serving.service import (
        ConvolutionService, Request, Response,
    )
    from parallel_convolution_tpu_torch.utils import imageio

    rng = random.Random(seed)
    filt = filters.get_filter(rng.choice(["blur3", "gaussian5", "sharpen3"]))
    H, W = rng.randrange(28, 64), rng.randrange(28, 64)
    iters = rng.randrange(1, 5)
    backend = rng.choice(["shifted", "cuda", "cuda_sep"])
    shape = rng.choice([(1, 2), (2, 2), (2, 4)])
    grid = slot_grid(shape, device)
    img = imageio.generate_test_image(H, W, "grey", seed=seed)
    want = oracle.run_serial_u8(img, filt, iters)
    policy = RetryPolicy(max_attempts=4, base_delay=0.01, max_delay=0.1)

    def burst(svc, n):
        reqs = [svc.submit(Request(image=img, filter_name=filt.name,
                                   iters=iters, backend=backend),
                           wait=False) for _ in range(n)]
        return [s.result(300) if hasattr(s, "result") else s for s in reqs]

    with faults.injected(spec, seed=seed) as plan:
        svc = ConvolutionService(grid, max_delay_s=0.02, retry_policy=policy)
        faulted = burst(svc, 6)
        svc.close()
        fired = plan.fired
        retries = svc.stats["retries"]
    # The restart: no plan, no cached probe verdicts — a fresh process's
    # serving state, which must come up clean on the requested tier.
    degrade.clear_probe_cache()
    svc2 = ConvolutionService(grid, max_delay_s=0.02, retry_policy=policy)
    resumed = burst(svc2, 2)
    svc2.close()

    def verdicts(results):
        out = []
        for r in results:
            ok = (isinstance(r, Response)
                  and np.array_equal(np.asarray(r.image), want))
            out.append({
                "ok": bool(ok),
                "effective_backend": getattr(r, "effective_backend", None),
                **({} if ok else {"got": type(r).__name__,
                                  "detail": getattr(r, "detail", "")[:200]}),
            })
        return out

    vf, vr = verdicts(faulted), verdicts(resumed)
    ok = all(v["ok"] for v in vf + vr) and all(
        v["effective_backend"] == backend for v in vr)
    row = {
        "ok": ok, "mode": "serve", "spec": spec, "seed": seed,
        "filter": filt.name, "H": H, "W": W, "iters": iters,
        "backend": backend, "mesh": "x".join(map(str, shape)),
        "device": str(grid.device),
        "fired": [list(f) for f in fired], "retries": retries,
        "faulted_effective": sorted({v["effective_backend"] for v in vf
                                     if v["effective_backend"]}),
        "failures": [v for v in vf + vr if not v["ok"]][:4],
    }
    _write_trial(out_path, row)
    return 0 if ok else 1


def run_router_kill(args) -> int:
    """Kill/revive drill: 3 in-process replicas behind the router.

    Traffic threads push oracle-checked requests (a few distinct compile
    keys, so routing exercises multiple ring points) while the killer
    thread cycles through replicas: kill → keep serving → revive.  The
    gates, in order of importance:

    1. zero non-rejected failures (retryable sheds are re-driven with
       capped backoff, mirroring loadgen's client contract);
    2. every completed response byte-identical to the NumPy oracle;
    3. with ``N >= 1`` kill cycles, at least one observed failover
       (a request served off its consistent-hash home after a failure).
    """
    import threading

    from parallel_convolution_tpu_torch.ops import filters, oracle
    from parallel_convolution_tpu_torch.serving.router import (
        InProcessReplica, ReplicaRouter,
    )
    from parallel_convolution_tpu_torch.serving.service import (
        ConvolutionService,
    )
    from parallel_convolution_tpu_torch.utils import imageio
    import base64

    n_cycles = args.router_kill
    rng = random.Random(args.seed)
    img = imageio.generate_test_image(40, 56, "grey", seed=args.seed)
    b64 = base64.b64encode(np.ascontiguousarray(img).tobytes()).decode()
    # Distinct iteration counts = distinct compile keys = distinct ring
    # points: the kill must be able to hit a key's home replica.
    iters_pool = [1, 2, 3]
    oracles = {it: oracle.run_serial_u8(img, filters.get_filter("blur3"), it)
               for it in iters_pool}

    grid = slot_grid((2, 2), args.device)

    def factory():
        return ConvolutionService(grid, max_delay_s=0.002, max_queue=256)

    replicas = [InProcessReplica(factory, name=f"r{i}") for i in range(3)]
    router = ReplicaRouter(replicas, breaker_threshold=2,
                           breaker_cooldown_s=0.2, poll_interval_s=0.05)
    n_requests = 40 + 20 * n_cycles
    results, lock = [], threading.Lock()
    stop = threading.Event()

    def body_for(i: int) -> dict:
        return {"image_b64": b64, "rows": 40, "cols": 56, "mode": "grey",
                "filter": "blur3", "iters": iters_pool[i % len(iters_pool)],
                "request_id": f"rk{i}"}

    def one(i: int) -> None:
        it = iters_pool[i % len(iters_pool)]
        body = body_for(i)
        for attempt in range(6):
            status, wire = router.request(dict(body), tenant="drill")
            if wire.get("ok") or not wire.get("retryable"):
                break
            time.sleep(min(float(wire.get("retry_after_s") or 0.05), 0.5))
        ok = bool(wire.get("ok"))
        byte_ok = None
        if ok:
            got = np.frombuffer(base64.b64decode(wire["image_b64"]),
                                np.uint8).reshape(40, 56)
            byte_ok = bool(np.array_equal(got, oracles[it]))
        with lock:
            results.append({
                "i": i, "ok": ok, "byte_ok": byte_ok,
                "rejected": wire.get("rejected"),
                "retryable": wire.get("retryable"),
                "router": wire.get("router", {}),
            })

    # The kill must be able to CAUSE a failover: victims are the
    # consistent-hash HOME replicas of the live keys, not random picks.
    from parallel_convolution_tpu_torch.serving.router import route_key

    homes = []
    for it in iters_pool:
        cands = router.ring.candidates(route_key(body_for(it)))
        if cands and cands[0] not in homes:
            homes.append(cands[0])

    def traffic() -> None:
        while not stop.is_set():
            with lock:
                i = counter[0]
                if i >= n_requests:
                    return
                counter[0] += 1
            one(i)
            time.sleep(0.01)   # pace: traffic must span the kill cycles

    counter = [0]
    workers = [threading.Thread(target=traffic, daemon=True)
               for _ in range(4)]
    for w in workers:
        w.start()

    kills = []
    for cycle in range(n_cycles):
        time.sleep(0.4)
        victim = homes[cycle % len(homes)]
        router.replica(victim).kill()
        kills.append(victim)
        time.sleep(0.4)
        router.replica(victim).revive()
    for w in workers:
        w.join(300)
    stop.set()
    router.close()

    completed = [r for r in results if r["ok"]]
    byte_fails = [r for r in completed if not r["byte_ok"]]
    non_rejected = [r for r in results
                    if not r["ok"] and not r.get("retryable")]
    # A failover, client-observed: the request completed OFF its
    # consistent-hash home (the dead replica's keys re-homed) or the
    # router reported a failed dispatch before success.
    failovers = sum(
        1 for r in completed
        if r["router"].get("failovers", 0) > 0
        or (r["router"].get("replica") and r["router"].get("home")
            and r["router"]["replica"] != r["router"]["home"]))
    failures = len(byte_fails) + len(non_rejected)
    if n_cycles >= 1 and failovers < 1:
        # the drill exists to prove serve-through-failure: a run where
        # no kill was ever observed proves nothing — fail it loudly.
        failures += 1
    summary = {
        "summary": "router-kill", "n": n_requests, "cycles": n_cycles,
        "seed": args.seed, "kills": kills,
        "completed": len(completed),
        "final_retryable_sheds": sum(1 for r in results
                                     if not r["ok"] and r.get("retryable")),
        "failovers_observed": failovers,
        "byte_mismatches": len(byte_fails),
        "non_rejected_failures": len(non_rejected),
        "failures": failures,
    }
    if args.summary_out:
        p = Path(args.summary_out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(summary) + "\n")
    print(json.dumps(summary), flush=True)
    return 1 if failures else 0


def run_chaos_drill(args) -> int:
    """Chaos-transport drill: mixed traffic under sampled,
    seeded transport-fault schedules + mid-stream kills; see module
    docstring for the gates."""
    import base64

    from parallel_convolution_tpu_torch.serving._chaos_common import (
        chaos_pool, converge_body, oracle_converge_final,
        request_with_backoff,
    )
    from parallel_convolution_tpu_torch.ops import filters, oracle
    from parallel_convolution_tpu_torch.resilience import faults
    from parallel_convolution_tpu_torch.serving.router import ReplicaRouter
    from parallel_convolution_tpu_torch.serving.service import (
        ConvolutionService,
    )
    from parallel_convolution_tpu_torch.utils import imageio

    rng = random.Random(args.seed)
    img = imageio.generate_test_image(40, 56, "grey", seed=args.seed)
    b64 = base64.b64encode(np.ascontiguousarray(img).tobytes()).decode()
    iters_pool = [1, 2, 3]
    oracles = {it: oracle.run_serial_u8(
        img, filters.get_filter("blur3"), it) for it in iters_pool}

    grid = slot_grid((1, 2), args.device)

    def factory():
        return ConvolutionService(grid, max_delay_s=0.002, max_queue=256)

    def cbody(rid: str) -> dict:
        return converge_body(b64, 40, 56, rid)

    def vbody(rid: str) -> dict:
        # The rank-3 drill body (--volume): a (D,H,W) wave relaxation,
        # small enough that every cycle can afford the stream.
        vol = np.random.default_rng(args.seed).random(
            (2, 4, 16, 16), dtype=np.float32)
        return {"rows": 16, "cols": 16, "depth": 4, "mode": "volume",
                "volume_b64": base64.b64encode(vol.tobytes()).decode(),
                "filter": "wave", "boundary": "periodic", "tol": 0.0,
                "max_iters": 12, "check_every": 4, "request_id": rid}

    try:
        oracle_final = oracle_converge_final(factory, cbody("oracle"))
        vol_oracle = (oracle_converge_final(factory, vbody("oracle-v"))
                      if args.volume else None)
    except RuntimeError as e:
        print(json.dumps({"summary": "chaos", "failures": 1,
                          "detail": str(e)}))
        return 1

    # One replica per failure shape: drops, corrupt bodies, latency.
    reps = chaos_pool(factory, args.seed)
    router = ReplicaRouter(reps, breaker_threshold=3,
                           breaker_cooldown_s=0.2, poll_interval_s=0.05)

    failures: list[str] = []
    resumes = 0
    finals_per_rid: dict[str, int] = {}
    t0 = time.time()
    specs = []
    for cycle in range(args.chaos):
        # A sampled, seeded schedule per cycle — every run replayable.
        parts = [f"transport_stream:{rng.randint(2, 4)}"]
        if rng.random() < 0.7:
            parts.append(f"transport_send:{rng.randint(1, 5)}")
        if rng.random() < 0.7:
            parts.append(f"transport_recv:{rng.randint(2, 6)}")
        if rng.random() < 0.5:
            parts.append("readyz_probe:p0.2")
        spec = ",".join(parts)
        specs.append(spec)
        with faults.injected(spec, seed=args.seed + cycle):
            for i in range(8):
                body = {"image_b64": b64, "rows": 40, "cols": 56,
                        "mode": "grey", "filter": "blur3",
                        "iters": iters_pool[i % 3],
                        "request_id": f"ch{cycle}-{i}"}
                wire = request_with_backoff(router, body)
                if wire.get("ok"):
                    got = np.frombuffer(
                        base64.b64decode(wire["image_b64"]),
                        np.uint8).reshape(40, 56)
                    if not np.array_equal(got, oracles[iters_pool[i % 3]]):
                        failures.append(
                            f"cycle {cycle} req {i}: byte mismatch")
                elif not wire.get("retryable"):
                    failures.append(
                        f"cycle {cycle} req {i}: non-rejected failure "
                        f"{wire.get('rejected')}: "
                        f"{str(wire.get('detail'))[:120]}")
            rid = f"cv{cycle}"
            status, rows = router.converge(cbody(rid))
            it = iter(rows)
            drained = []
            victim = ""
            try:
                first = next(it)
                drained.append(first)
                if cycle % 2 == 0:
                    victim = first.get("router", {}).get("replica", "")
                    if victim:
                        router.replica(victim).kill()
                drained.extend(it)
            except StopIteration:
                pass
            if cycle % 2 == 0 and victim:
                router.replica(victim).revive()
            final = drained[-1] if drained else {}
            for r in drained:
                if r.get("kind") == "final":
                    finals_per_rid[rid] = finals_per_rid.get(rid, 0) + 1
            if final.get("kind") == "final":
                if final.get("image_b64") != oracle_final["image_b64"]:
                    failures.append(
                        f"cycle {cycle}: converge final not "
                        "byte-identical to oracle")
                if final.get("router", {}).get("resume_count", 0) > 0:
                    resumes += 1
            elif not final.get("retryable"):
                failures.append(
                    f"cycle {cycle}: converge ended non-rejected: "
                    f"{ {k: v for k, v in final.items() if k != 'image_b64'} }")
            if args.volume:
                # Rank-3 drill: the volume stream rides the
                # SAME cycle schedule; odd cycles kill its replica
                # mid-flight (even cycles killed the 2-D stream's), so
                # the run covers both volume-kill-resume and
                # volume-under-transport-faults.
                vrid = f"vol{cycle}"
                status, vrows = router.converge(vbody(vrid))
                vit = iter(vrows)
                vdrained = []
                vvictim = ""
                try:
                    vfirst = next(vit)
                    vdrained.append(vfirst)
                    if cycle % 2 == 1:
                        vvictim = vfirst.get("router", {}).get(
                            "replica", "")
                        if vvictim:
                            router.replica(vvictim).kill()
                    vdrained.extend(vit)
                except StopIteration:
                    pass
                if vvictim:
                    router.replica(vvictim).revive()
                vfinal = vdrained[-1] if vdrained else {}
                for r in vdrained:
                    if r.get("kind") == "final":
                        finals_per_rid[vrid] = (
                            finals_per_rid.get(vrid, 0) + 1)
                if vfinal.get("kind") == "final":
                    if (vfinal.get("image_b64")
                            != vol_oracle["image_b64"]):
                        failures.append(
                            f"cycle {cycle}: volume final not "
                            "byte-identical to the volume oracle")
                    if vfinal.get("router", {}).get(
                            "resume_count", 0) > 0:
                        resumes += 1
                elif not vfinal.get("retryable"):
                    failures.append(
                        f"cycle {cycle}: volume converge ended "
                        f"non-rejected: {vfinal.get('rejected')!r}")
    dup = {r: n for r, n in finals_per_rid.items() if n != 1}
    if dup:
        failures.append(f"exactly-once final rows violated: {dup}")
    if args.chaos >= 1 and resumes < 1:
        failures.append("no mid-stream resume observed across the run")
    snap = router.snapshot()
    router.close()
    summary = {
        "summary": "chaos", "cycles": args.chaos, "seed": args.seed,
        "volume": bool(args.volume),
        "specs": specs,
        "resumes_observed": resumes,
        "router_resumes": snap["router"]["resumes"],
        "mid_stream_failovers": snap["router"]["mid_stream_failovers"],
        "corrupt_responses": sum(p["corrupt_responses"]
                                 for p in snap["replicas"].values()),
        "chaos_injected": {site: sum(r.injected.get(site, 0)
                                     for r in reps)
                           for site in ("transport_send",
                                        "transport_recv",
                                        "transport_stream",
                                        "readyz_probe")},
        "wall_s": round(time.time() - t0, 1),
        "failures": len(failures),
        "failure_detail": failures[:8],
    }
    if args.summary_out:
        p = Path(args.summary_out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(summary) + "\n")
    print(json.dumps(summary), flush=True)
    return 1 if failures else 0


def run_chaos_matrix(args) -> int:
    """Storage-chaos soak: N cycles of the full ``serving.chaos_matrix``
    matrix — every disk fault mode crossed with every workload shape —
    each cycle under a DIFFERENT seed, so the hit-indexed schedules land
    the faults at different appends, spills, and stream rows every time.
    Gates are the matrix's own standing invariants; any cycle reporting
    failures fails the soak."""
    from parallel_convolution_tpu_torch.serving import chaos_matrix

    failures: list[str] = []
    cycles = []
    t0 = time.time()
    for cycle in range(args.chaos_matrix):
        row = chaos_matrix.run_matrix(
            seed=args.seed + cycle, device=args.device,
            log=lambda m: None)   # per-cell chatter off; summary below
        cycles.append({"seed": row["seed"],
                       "cells_failed": row["cells_failed"],
                       "failures": row["failures"],
                       "wall_s": row["wall_s"]})
        if row["failures"]:
            failures.append(
                f"cycle {cycle} (seed {row['seed']}): "
                f"{row['failures']} failures, e.g. "
                f"{row['failure_detail'][:2]}")
        print(json.dumps({"cycle": cycle, "seed": row["seed"],
                          "cells": row["cells_total"],
                          "failures": row["failures"]}), flush=True)
    summary = {
        "summary": "chaos-matrix", "cycles": args.chaos_matrix,
        "seed": args.seed, "device": str(args.device or "cuda"),
        "per_cycle": cycles,
        "wall_s": round(time.time() - t0, 1),
        "failures": len(failures),
        "failure_detail": failures[:8],
    }
    if args.summary_out:
        p = Path(args.summary_out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(summary) + "\n")
    print(json.dumps(summary), flush=True)
    return 1 if failures else 0


def run_router_restart(args) -> int:
    """Crash-safe control-plane drill: N router lives over
    one WAL lineage; see module docstring for the gates."""
    import base64

    from parallel_convolution_tpu_torch.serving._chaos_common import (
        converge_body, oracle_converge_final, request_with_backoff,
    )
    from parallel_convolution_tpu_torch.ops import filters, oracle
    from parallel_convolution_tpu_torch.resilience import faults
    from parallel_convolution_tpu_torch.serving.chaos import router_kill_due
    from parallel_convolution_tpu_torch.serving.pricing import WorkPricer
    from parallel_convolution_tpu_torch.serving.router import (
        InProcessReplica, ReplicaRouter, TenantQuotas,
    )
    from parallel_convolution_tpu_torch.serving.service import (
        ConvolutionService,
    )
    from parallel_convolution_tpu_torch.utils import imageio

    rng = random.Random(args.seed)
    img = imageio.generate_test_image(40, 56, "grey", seed=args.seed)
    b64 = base64.b64encode(np.ascontiguousarray(img).tobytes()).decode()
    want1 = oracle.run_serial_u8(img, filters.get_filter("blur3"), 1)

    grid = slot_grid((1, 2), args.device)

    def factory():
        return ConvolutionService(grid, max_delay_s=0.002, max_queue=256)

    def cbody(rid: str) -> dict:
        return converge_body(b64, 40, 56, rid, tenant="drill")

    try:
        oracle_final = oracle_converge_final(factory, cbody("oracle"))
    except RuntimeError as e:
        print(json.dumps({"summary": "router-restart", "failures": 1,
                          "detail": str(e)}))
        return 1

    reps = [InProcessReplica(factory, name=f"rr{i}") for i in range(3)]
    state_dir = Path(args.state_dir or tempfile.mkdtemp(
        prefix="pctpu-router-restart-"))
    wal_path = state_dir / "router.wal"

    def mk_router():
        return ReplicaRouter(
            reps, wal=str(wal_path),
            quotas=TenantQuotas(rate=1.0, burst=1e6),
            pricer=WorkPricer(min_units=1e-9),
            breaker_threshold=3, breaker_cooldown_s=0.2,
            poll_interval_s=0.05, start_health=False)

    failures: list[str] = []
    finals_per_rid: dict[str, int] = {}
    resumes = 0
    epochs: list[int] = []
    t0 = time.time()
    prev_router = None
    pending: str | None = None
    lives = args.router_restart + 1   # the extra life drains the tail
    for life in range(lives):
        router = mk_router()
        epochs.append(router.epoch)
        if len(epochs) >= 2 and epochs[-1] <= epochs[-2]:
            failures.append(
                f"life {life}: epoch {epochs[-1]} did not bump past "
                f"{epochs[-2]}")
        if prev_router is not None:
            # The dead life's object is now a zombie: fenced everywhere.
            _, wz = prev_router.request({
                "image_b64": b64, "rows": 40, "cols": 56,
                "mode": "grey", "filter": "blur3", "iters": 1,
                "request_id": f"z{life}", "tenant": "drill"})
            if wz.get("rejected") != "stale_epoch" or wz.get(
                    "retryable"):
                failures.append(
                    f"life {life}: zombie not fenced "
                    f"({wz.get('rejected')!r})")
            prev_router.close(close_replicas=False)
        if pending is not None:
            # Client retry of the crash-interrupted job: must RESUME
            # from the WAL-recovered token and finish byte-identical.
            st, rows = router.converge(cbody(pending))
            drained = list(rows) if st == 200 else []
            for r in drained:
                if r.get("kind") == "final":
                    finals_per_rid[pending] = finals_per_rid.get(
                        pending, 0) + 1
            final = drained[-1] if drained else {}
            if final.get("kind") != "final":
                failures.append(
                    f"life {life}: retry of {pending!r} did not finish")
            else:
                if final.get("router", {}).get("resume_count", 0) >= 1:
                    resumes += 1
                else:
                    failures.append(
                        f"life {life}: {pending!r} restarted instead "
                        f"of resuming ({final.get('router')})")
                if final.get("image_b64") != oracle_final["image_b64"]:
                    failures.append(
                        f"life {life}: resumed final not "
                        "byte-identical to oracle")
            pending = None
        # Batch sanity through this life (epoch stamps observed).
        wire = request_with_backoff(router, {
            "image_b64": b64, "rows": 40, "cols": 56, "mode": "grey",
            "filter": "blur3", "iters": 1,
            "request_id": f"b{life}", "tenant": "drill"})
        if wire.get("ok"):
            got = np.frombuffer(base64.b64decode(wire["image_b64"]),
                                np.uint8).reshape(40, 56)
            if not np.array_equal(got, want1):
                failures.append(f"life {life}: batch byte mismatch")
            if wire.get("router", {}).get("epoch") != router.epoch:
                failures.append(f"life {life}: missing epoch stamp")
        elif not wire.get("retryable"):
            failures.append(
                f"life {life}: non-rejected batch failure "
                f"{wire.get('rejected')}")
        if life == lives - 1:
            router.close(close_replicas=False)
            break
        # Start a job and CRASH this router mid-stream at a seeded row.
        rid = f"rr-job{life}"
        kill_at = rng.randint(1, 3)
        with faults.injected(f"router_kill:{kill_at}",
                             seed=args.seed + life):
            st, rows = router.converge(cbody(rid))
            if st != 200:
                failures.append(
                    f"life {life}: job admission failed ({st})")
            else:
                killed = False
                for row in rows:
                    if row.get("kind") == "final":
                        finals_per_rid[rid] = finals_per_rid.get(
                            rid, 0) + 1
                    if router_kill_due():
                        killed = True
                        break   # abandon un-closed: the crash
                if killed:
                    pending = rid
                else:
                    failures.append(
                        f"life {life}: router_kill never fired")
        prev_router = router

    dup = {r: n for r, n in finals_per_rid.items() if n != 1}
    if dup:
        failures.append(f"exactly-once final rows violated: {dup}")
    if args.router_restart >= 1 and resumes < 1:
        failures.append("no cross-restart resume observed")
    summary = {
        "summary": "router-restart", "lives": lives, "seed": args.seed,
        "epochs": epochs,
        "resumes_observed": resumes,
        "finals_per_request": finals_per_rid,
        "wal": str(wal_path),
        "wall_s": round(time.time() - t0, 1),
        "failures": len(failures),
        "failure_detail": failures[:8],
    }
    if args.summary_out:
        p = Path(args.summary_out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(summary) + "\n")
    print(json.dumps(summary), flush=True)
    return 1 if failures else 0


def run_shard_kill(args) -> int:
    """Sharded control-plane drill: N kill-one-of-three
    cycles over PERSISTENT per-shard WAL lineages.

    Each cycle boots a fresh 3-router fleet over the SAME three shard
    lineages (a boot over an existing lineage is itself the fenced
    takeover, so epochs ratchet monotonically across cycles), rotates
    which router owns which shard, then:

    1. closed-loop traffic hammers the two NON-victim shards
       throughout, with per-phase latency capture;
    2. a converge stream on the victim's shard is cut mid-flight by
       ``hard_stop`` (the in-process SIGKILL: flocks released, nothing
       fenced gracefully);
    3. surviving peers detect the death via anti-entropy misses and
       the deterministic successor performs the cross-shard fenced
       takeover of the orphaned lineage;
    4. the shard client refreshes the map and retries: the job RESUMES
       byte-identical to the uninterrupted oracle, exactly one final
       per request_id; the zombie owner is rejected typed
       ``stale_epoch``.

    Gates: zero non-rejected failures on surviving shards in EVERY
    phase, every cycle's resumed final byte-identical, exactly-once
    finals, one takeover per cycle, and the surviving shards' p99
    during the takeover window flat against the pre-kill baseline
    (<= 5x + 25 ms slack — in-process noise, not a perf claim).
    """
    import base64
    import threading

    from parallel_convolution_tpu_torch.serving._chaos_common import (
        oracle_converge_final,
    )
    from parallel_convolution_tpu_torch.ops import filters, oracle
    from parallel_convolution_tpu_torch.serving.peers import (
        InProcessPeer, ShardClient, ShardRouter, shard_of,
    )
    from parallel_convolution_tpu_torch.serving.router import (
        InProcessReplica, route_key,
    )
    from parallel_convolution_tpu_torch.serving.service import (
        ConvolutionService,
    )
    from parallel_convolution_tpu_torch.utils import imageio

    img = imageio.generate_test_image(32, 48, "grey", seed=args.seed)
    b64 = base64.b64encode(np.ascontiguousarray(img).tobytes()).decode()

    grid = slot_grid((1, 2), args.device)

    def factory():
        return ConvolutionService(grid, max_delay_s=0.002, max_queue=256)

    def batch_body(iters: int, rid: str) -> dict:
        return {"image_b64": b64, "rows": 32, "cols": 48,
                "mode": "grey", "filter": "blur3", "iters": iters,
                "request_id": rid}

    def cv_body(rid: str) -> dict:
        return {"image_b64": b64, "rows": 32, "cols": 48,
                "mode": "grey", "filter": "jacobi3",
                "backend": "shifted", "quantize": False, "tol": 0.0,
                "max_iters": 40, "check_every": 10, "request_id": rid}

    # iters is a route-key field: scan it until every shard has a
    # batch config (the traffic spreader) — plus the converge shard.
    by_shard: dict[str, int] = {}
    for it in range(1, 120):
        s = shard_of(route_key(batch_body(it, "probe")), 3)
        by_shard.setdefault(s, it)
        if len(by_shard) == 3:
            break
    oracles = {it: oracle.run_serial_u8(
        img, filters.get_filter("blur3"), it)
        for it in by_shard.values()}
    kill_shard = shard_of(route_key(cv_body("probe")), 3)
    other_shards = [s for s in ("0", "1", "2") if s != kill_shard]
    oracle_final = oracle_converge_final(factory, cv_body("oracle"))

    names = ["sA", "sB", "sC"]
    reps = [InProcessReplica(factory, name=f"sk{i}") for i in range(3)]
    state_dir = Path(args.state_dir or tempfile.mkdtemp(
        prefix="pctpu-shard-kill-"))

    failures: list[str] = []
    finals_per_rid: dict[str, int] = {}
    takeovers = 0
    p99s: list[dict] = []
    t0 = time.time()

    for cycle in range(args.shard_kill):
        # Rotate ownership so the victim differs per cycle (the victim
        # is whoever owns the converge body's shard this cycle).
        rot = names[cycle % 3:] + names[:cycle % 3]
        assign = {str(i): rot[i] for i in range(3)}
        routers = {}
        for nm in names:
            routers[nm] = ShardRouter(
                nm, reps, n_shards=3,
                owned=[s for s, o in assign.items() if o == nm],
                state_dir=state_dir, assignments=assign,
                start_sync=False, start_health=False,
                breaker_cooldown_s=0.2, wal_fsync=False)
        for nm in names:
            routers[nm].peers = [InProcessPeer(routers[o])
                                 for o in names if o != nm]
        victim = routers[assign[kill_shard]]
        survivors = [routers[nm] for nm in names
                     if nm != assign[kill_shard]]

        phase = {"now": "before"}
        lat: dict[str, list[float]] = {"before": [], "during": [],
                                       "after": []}
        lat_lock = threading.Lock()
        stop = threading.Event()

        def pound(shard: str, widx: int, routers=routers, phase=phase,
                  lat=lat, lat_lock=lat_lock, stop=stop, cycle=cycle):
            cl = ShardClient(list(routers.values()))
            it = by_shard[shard]
            j = 0
            while not stop.is_set():
                j += 1
                t1 = time.perf_counter()
                _, w = cl.request(
                    batch_body(it, f"c{cycle}t{widx}-{j}"))
                dt = (time.perf_counter() - t1) * 1000.0
                if w.get("ok"):
                    got = np.frombuffer(
                        base64.b64decode(w["image_b64"]),
                        np.uint8).reshape(32, 48)
                    with lat_lock:
                        lat[phase["now"]].append(dt)
                        if not np.array_equal(got, oracles[it]):
                            failures.append(
                                f"cycle {cycle}: surviving-shard "
                                f"byte mismatch on shard {shard}")
                elif not w.get("retryable"):
                    with lat_lock:
                        failures.append(
                            f"cycle {cycle}: non-rejected failure on "
                            f"surviving shard {shard}: "
                            f"{w.get('rejected')!r}")
                else:
                    time.sleep(0.01)

        threads = [threading.Thread(target=pound, args=(s, i))
                   for i, s in enumerate(other_shards)]
        for th in threads:
            th.start()
        time.sleep(0.5)   # pre-kill baseline window (warm + measured)

        client = ShardClient(list(routers.values()))
        rid = f"sk-job{cycle}"
        st, rows = client.converge(cv_body(rid))
        pre = []
        if st != 200:
            failures.append(f"cycle {cycle}: admission failed ({st})")
        else:
            for row in rows:
                pre.append(row)
                if row.get("kind") == "final":
                    finals_per_rid[rid] = finals_per_rid.get(rid, 0) + 1
                if len(pre) >= 2:
                    break   # abandon un-closed: the crash
        phase["now"] = "during"
        victim.hard_stop()
        # Survivors detect the death and take over deterministically.
        deadline = time.time() + 30.0
        owner = None
        while time.time() < deadline and owner is None:
            for r in survivors:
                r.sync_now()
            owner = next((r for r in survivors
                          if kill_shard in r._sub), None)
        if owner is None:
            failures.append(f"cycle {cycle}: no takeover within 30s")
        else:
            takeovers += 1
        # In-process takeover completes in single-digit ms — hold the
        # measurement window open so the p99 gate has samples that
        # actually bracket it.
        time.sleep(0.4)
        phase["now"] = "after"
        # Client retry: refresh the map, resume, finish byte-identical.
        client.refresh()
        st, rows = client.converge(cv_body(rid))
        drained = list(rows) if st == 200 else []
        for r in drained:
            if r.get("kind") == "final":
                finals_per_rid[rid] = finals_per_rid.get(rid, 0) + 1
        final = drained[-1] if drained else {}
        if final.get("kind") != "final":
            failures.append(f"cycle {cycle}: retry did not finish")
        else:
            if final.get("router", {}).get("resume_count", 0) < 1:
                failures.append(
                    f"cycle {cycle}: restarted instead of resuming "
                    f"({final.get('router')})")
            if pre and final.get("iters", 0) <= pre[-1].get("iters", 0):
                failures.append(
                    f"cycle {cycle}: final iters {final.get('iters')} "
                    f"not past pre-kill {pre[-1].get('iters')}")
            if final.get("image_b64") != oracle_final["image_b64"]:
                failures.append(
                    f"cycle {cycle}: resumed final not byte-identical")
        # Zombie: the dead owner's sub-router is fenced typed.
        _, zrows = victim.sub(kill_shard).converge(
            cv_body(f"z{cycle}"))
        zfirst = next(iter(zrows), {})
        if zfirst.get("rejected") != "stale_epoch":
            failures.append(
                f"cycle {cycle}: zombie not fenced "
                f"({zfirst.get('rejected')!r})")
        time.sleep(0.3)   # post-takeover window
        stop.set()
        for th in threads:
            th.join(10.0)
        p_before = _pct_ms(lat["before"])
        p_during = _pct_ms(lat["during"])
        p99s.append({"cycle": cycle, "victim": victim.name,
                     "p99_before_ms": p_before,
                     "p99_during_ms": p_during,
                     "n_before": len(lat["before"]),
                     "n_during": len(lat["during"])})
        if not lat["during"]:
            failures.append(
                f"cycle {cycle}: surviving shards served NOTHING "
                "during the takeover window")
        elif (p_before is not None and p_during is not None
                and p_during > 5.0 * p_before + 25.0):
            failures.append(
                f"cycle {cycle}: surviving-shard p99 spiked during "
                f"takeover: {p_during:.1f}ms vs baseline "
                f"{p_before:.1f}ms")
        for r in routers.values():
            try:
                r.close(close_replicas=False)
            except Exception:  # noqa: BLE001 — victim already dead
                pass

    for rep in reps:
        rep.close()
    dup = {r: n for r, n in finals_per_rid.items() if n != 1}
    if dup:
        failures.append(f"exactly-once final rows violated: {dup}")
    summary = {
        "summary": "shard-kill", "cycles": args.shard_kill,
        "seed": args.seed,
        "kill_shard": kill_shard,
        "takeovers": takeovers,
        "finals_per_request": finals_per_rid,
        "p99_by_cycle": p99s,
        "state_dir": str(state_dir),
        "wall_s": round(time.time() - t0, 1),
        "failures": len(failures),
        "failure_detail": failures[:8],
    }
    if args.summary_out:
        p = Path(args.summary_out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(summary) + "\n")
    print(json.dumps(summary), flush=True)
    return 1 if failures else 0


def _pct_ms(vals, q: float = 0.99):
    if not vals:
        return None
    vs = sorted(vals)
    return vs[min(len(vs) - 1, int(round(q * (len(vs) - 1))))]


def run_autoscale_drill(args) -> int:
    """Sustained-load autoscale drill: N grow/shrink cycles.

    One in-process replica behind the router with the control loop
    armed; each cycle saturates the pool with a closed-loop worker pack
    until the autoscaler GROWS it, then idles until it SHRINKS back —
    the serving analogue of the reshape ladder drill, run repeatedly so
    flapping, leaked replicas, and drain races surface.  Gates:

    1. zero non-rejected failures across every cycle (typed retryable
       sheds re-driven with capped backoff, the loadgen contract);
    2. every completed response byte-identical to the NumPy oracle;
    3. every cycle both grew (>= 1 added replica) and shrank (back to
       the 1-replica floor);
    4. at least one scale-up pre-warmed its ring shard (warm placement
       exercised, not just pool arithmetic).
    """
    import base64
    import threading

    from parallel_convolution_tpu_torch.ops import filters, oracle
    from parallel_convolution_tpu_torch.serving.autoscaler import AutoScaler
    from parallel_convolution_tpu_torch.serving.router import (
        InProcessReplica, ReplicaRouter,
    )
    from parallel_convolution_tpu_torch.serving.service import (
        ConvolutionService,
    )
    from parallel_convolution_tpu_torch.utils import imageio

    n_cycles = args.autoscale
    img = imageio.generate_test_image(40, 56, "grey", seed=args.seed)
    b64 = base64.b64encode(np.ascontiguousarray(img).tobytes()).decode()
    iters_pool = [1, 2, 3]
    oracles = {it: oracle.run_serial_u8(img, filters.get_filter("blur3"),
                                        it) for it in iters_pool}

    grid = slot_grid((1, 2), args.device)

    def factory():
        return ConvolutionService(grid, max_batch=1, max_delay_s=0.001,
                                  max_queue=16)

    def transport_factory(name):
        return InProcessReplica(factory, name=name)

    router = ReplicaRouter([InProcessReplica(factory, name="r0")],
                           poll_interval_s=0.05, breaker_cooldown_s=0.2)
    scaler = AutoScaler(router, transport_factory, min_replicas=1,
                        max_replicas=2, up_pressure=0.3,
                        down_pressure=0.02, up_ticks=2, down_ticks=10,
                        cooldown_s=1.0, interval_s=0.2, drain_s=5.0)
    results, lock = [], threading.Lock()
    counter = [0]

    def one(i: int) -> None:
        it = iters_pool[i % len(iters_pool)]
        body = {"image_b64": b64, "rows": 40, "cols": 56, "mode": "grey",
                "filter": "blur3", "iters": it, "request_id": f"as{i}"}
        for attempt in range(6):
            status, wire = router.request(dict(body), tenant="drill")
            if wire.get("ok") or not wire.get("retryable"):
                break
            time.sleep(min(float(wire.get("retry_after_s") or 0.05), 0.5))
        ok = bool(wire.get("ok"))
        byte_ok = None
        if ok:
            got = np.frombuffer(base64.b64decode(wire["image_b64"]),
                                np.uint8).reshape(40, 56)
            byte_ok = bool(np.array_equal(got, oracles[it]))
        with lock:
            results.append({"i": i, "ok": ok, "byte_ok": byte_ok,
                            "rejected": wire.get("rejected"),
                            "retryable": wire.get("retryable")})

    # Observatory warm-up: the pre-warm worklist needs observed configs.
    for i in range(len(iters_pool)):
        one(i)
    scaler.start()
    cycles = []
    for cycle in range(n_cycles):
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                with lock:
                    i = counter[0] + 100
                    counter[0] += 1
                one(i)

        pack = [threading.Thread(target=worker, daemon=True)
                for _ in range(24)]
        for th in pack:
            th.start()
        grew = False
        t_sat = time.time()
        while time.time() - t_sat < 30.0:
            if len(router.ring.members()) >= 2:
                grew = True
                break
            time.sleep(0.1)
        stop.set()
        for th in pack:
            th.join(60)
        shrank = False
        t_idle = time.time()
        while time.time() - t_idle < 30.0:
            if len(router.ring.members()) == 1:
                shrank = True
                break
            time.sleep(0.1)
        cycles.append({"cycle": cycle, "grew": grew, "shrank": shrank})
    scaler.close()
    router.close()

    completed = [r for r in results if r["ok"]]
    byte_fails = [r for r in completed if not r["byte_ok"]]
    non_rejected = [r for r in results
                    if not r["ok"] and not r.get("retryable")]
    bad_cycles = [c for c in cycles if not (c["grew"] and c["shrank"])]
    prewarmed = scaler.stats["prewarmed_configs"]
    failures = (len(byte_fails) + len(non_rejected) + len(bad_cycles)
                + (1 if prewarmed < 1 else 0))
    summary = {
        "summary": "autoscale-drill", "cycles": cycles,
        "n": len(results), "completed": len(completed),
        "scaler": dict(scaler.stats),
        "prewarmed_configs": prewarmed,
        "byte_mismatches": len(byte_fails),
        "non_rejected_failures": len(non_rejected),
        "failures": failures,
    }
    if args.summary_out:
        p = Path(args.summary_out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(summary) + "\n")
    print(json.dumps(summary), flush=True)
    return 1 if failures else 0


RESHAPE_TARGETS = [(1, 2), (2, 2), (1, 1)]


def run_reshape_trial(spec: str, seed: int, out_path: str,
                      device=None) -> int:
    """One elastic-recovery drill: crash on 2x4, resume on every shrink.

    Phase 1 installs ``spec`` (a random checkpoint/compile/exchange
    fault) and runs a checkpointed job on a 2x4 grid until the injected
    crash.  Phase 2 copies the post-crash checkpoint dir once per target
    grid (1x2 / 2x2 / 1x1) and resumes each INDEPENDENTLY from whatever —
    possibly torn — state the crash left: the grid-agnostic reshard +
    quarantine walk must land every one byte-identical to the
    single-device oracle.  Exit 0 iff all do.
    """
    import shutil
    import warnings

    from parallel_convolution_tpu_torch.ops import filters, oracle
    from parallel_convolution_tpu_torch.parallel import step
    from parallel_convolution_tpu_torch.resilience import faults
    from parallel_convolution_tpu_torch.utils import checkpoint, imageio

    rng = random.Random(seed)
    filt = filters.get_filter(rng.choice(["blur3", "gaussian5", "sharpen3"]))
    H, W = rng.randrange(33, 70), rng.randrange(33, 70)
    total, every = rng.randrange(6, 11), rng.randrange(2, 4)
    fuse = rng.choice([1, 2, 2])  # biased fused: mid-fuse resumes matter
    grid8 = slot_grid((2, 4), device)
    img = imageio.generate_test_image(H, W, "grey", seed=seed)
    x = imageio.interleaved_to_planar(img).astype(np.float32)
    ck = tempfile.mkdtemp(prefix="pctpu_reshape_trial_")

    crashed = None
    with faults.injected(spec, seed=seed) as plan:
        try:
            xs, valid_hw, _ = step._prepare(x, grid8)
            checkpoint.run_checkpointed(xs, filt, total, grid8, valid_hw,
                                        ckpt_dir=ck, every=every, fuse=fuse)
        except Exception as e:  # noqa: BLE001 — the injected crash
            crashed = repr(e)
        fired = plan.fired
    want = oracle.run_serial_u8(img, filt, total)
    targets, ok = {}, True
    for shape in RESHAPE_TARGETS:
        name = "x".join(map(str, shape))
        tdir = f"{ck}_resume_{name}"
        shutil.copytree(ck, tdir, dirs_exist_ok=True)
        tgrid = slot_grid(shape, device)
        xs2, valid_hw, _ = step._prepare(x, tgrid)
        try:
            meta = checkpoint.load_meta(tdir)
            resumed_from = None if meta is None else int(meta["iters_done"])
        except checkpoint.CheckpointCorrupt:
            resumed_from = "torn"
        with warnings.catch_warnings():
            # Reshard notes + quarantine warnings are this drill's
            # expected operation, not anomalies to surface per trial.
            warnings.simplefilter("ignore", checkpoint.CheckpointWarning)
            out = checkpoint.run_checkpointed(
                xs2, filt, total, tgrid, valid_hw, ckpt_dir=tdir,
                every=every, fuse=fuse)
        got = step._global_f32(out, tgrid, valid_hw).cpu().numpy()
        t_ok = bool(np.array_equal(got[0].astype(np.uint8), want))
        targets[name] = {"ok": t_ok, "resumed_from": resumed_from}
        ok &= t_ok
    row = {
        "ok": ok, "mode": "reshape", "spec": spec, "seed": seed,
        "crashed": crashed, "fired": [list(f) for f in fired],
        "filter": filt.name, "H": H, "W": W, "total": total,
        "every": every, "fuse": fuse, "source_mesh": "2x4",
        "device": str(grid8.device), "targets": targets,
    }
    _write_trial(out_path, row)
    return 0 if ok else 1


def _sample_serve_fault_spec(rng: random.Random) -> str:
    """A random transient compile/exchange plan for the serving drill.

    Hit-indexed only (no open ranges, no probabilities): bounded retry
    must heal every sampled plan DETERMINISTICALLY — a plan that fails
    all compiles forever would test retry exhaustion, which has its own
    unit test, not the soak's heal-and-serve property.
    """
    site = rng.choice(["backend_compile", "backend_compile",
                       "halo_exchange"])
    return f"{site}:{rng.randrange(1, 4)}"


def _sample_reshape_fault_spec(rng: random.Random, n_shards: int) -> str:
    """A crash that lands AFTER the first save completes.

    The reshape drill's point is resuming a REAL snapshot on a different
    grid, so every sampled (site, hit) leaves snapshot 1 intact: shard
    hits span the second save (tearing it additionally exercises the
    quarantine walk mid-reshard), meta hits 3/4 are the second save's
    meta/LATEST writes, and exchange hit 2 is a later chunk's compile.
    With short runs some hits never fire — the run then completes clean
    and the resume still reshards from its snapshots.
    """
    site = rng.choice(["checkpoint_write_shard"] * 3
                      + ["checkpoint_write_meta"] * 2 + ["halo_exchange"])
    if site == "checkpoint_write_shard":
        hit = rng.randrange(n_shards + 1, 2 * n_shards + 1)
    elif site == "checkpoint_write_meta":
        hit = rng.randrange(3, 5)
    else:
        hit = 2
    return f"{site}:{hit}"


def _sample_fault_spec(rng: random.Random, n_shards: int) -> str:
    """A random single-site plan biased toward checkpoint tears."""
    site = rng.choice(
        ["checkpoint_write_shard"] * 3 + ["checkpoint_write_meta"] * 2
        + ["backend_compile", "halo_exchange"])
    if site == "checkpoint_write_shard":
        hit = rng.randrange(1, 2 * n_shards + 1)  # spans two save rounds
    elif site == "checkpoint_write_meta":
        hit = rng.randrange(1, 5)  # meta + LATEST consults, two saves
    else:
        hit = 1
    return f"{site}:{hit}"


def run_fault_soak(args) -> int:
    """Sample ``--faults`` random plans; run each drill as a supervised
    leg, a child process on the soak's device."""
    from parallel_convolution_tpu_torch.resilience.retry import RetryPolicy
    from parallel_convolution_tpu_torch.resilience.supervisor import (
        Leg, Supervisor,
    )

    rng = random.Random(args.seed)
    state = Path(args.state_dir or tempfile.mkdtemp(prefix="pctpu_fault_soak_"))
    n_trials = args.reshape or args.faults
    # The child imports this package from the checkout the soak runs from.
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    device_args = ["--device", args.device] if args.device else []
    legs = []
    for i in range(n_trials):
        if args.reshape:
            # Post-first-save crash sites, resumed across grids.
            spec = _sample_reshape_fault_spec(rng, n_shards=8)
            trial_flag = "--reshape-trial"
        elif args.serve:
            spec = _sample_serve_fault_spec(rng)
            trial_flag = "--serve-trial"
        else:
            spec = _sample_fault_spec(rng, n_shards=8)
            trial_flag = "--fault-trial"
        out = state / f"trial_{i:03d}.json"
        legs.append(Leg(
            name=f"trial_{i:03d}",
            cmd=[sys.executable, "-m", "parallel_convolution_tpu_torch.soak",
                 trial_flag, spec,
                 "--trial-seed", str(rng.randrange(10_000)),
                 "--trial-out", str(out), *device_args],
            done_file=str(out), done_pattern='"ok": true',
            timeout=600.0, env=env,
        ))
    t0 = time.time()
    sup = Supervisor(legs, state,
                     policy=RetryPolicy(max_attempts=2, base_delay=0.2,
                                        max_delay=1.0, seed=args.seed))
    rc = sup.run()
    fails = 0
    for leg in legs:
        p = Path(leg.done_file)
        if p.exists():
            print(p.read_text().strip(), flush=True)
        if not leg.is_complete():
            fails += 1
    summary = {
        "summary": "reshape-soak" if args.reshape else "fault-soak",
        "mode": ("reshape" if args.reshape
                 else "serve" if args.serve else "batch"),
        "n": n_trials, "seed": args.seed,
        "failures": fails, "state_dir": str(state), "supervisor_rc": rc,
        "wall_s": round(time.time() - t0, 1),
    }
    if args.reshape:
        summary["targets"] = ["x".join(map(str, s))
                              for s in RESHAPE_TARGETS]
    if args.summary_out:
        p = Path(args.summary_out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(summary) + "\n")
    print(json.dumps(summary), flush=True)
    return 1 if (fails or rc) else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m parallel_convolution_tpu_torch.soak",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda[:N] (default: the card): every "
                         "grid's slots, replica and trial child run there")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--converge", action="store_true",
                    help="soak the run-to-convergence path (C6) instead "
                         "of fixed-count iteration")
    ap.add_argument("--faults", type=int, default=0, metavar="N",
                    help="resilience mode: run N random injected-fault "
                         "crash/resume drills through the supervised "
                         "runner instead of the byte-compare soak")
    ap.add_argument("--serve", action="store_true",
                    help="with --faults: run the drills through the "
                         "serving engine (retry/degradation must heal "
                         "injected compile/exchange faults into "
                         "byte-identical responses; then a clean restart "
                         "must serve the requested tier)")
    ap.add_argument("--reshape", type=int, default=0, metavar="N",
                    help="elastic-recovery mode: run N crash-on-2x4 / "
                         "resume-on-1x2,2x2,1x1 reshard drills through "
                         "the supervised runner; every resumed output "
                         "must byte-match the single-device oracle")
    ap.add_argument("--router-kill", type=int, default=0, metavar="N",
                    help="replica-router drill: 3 in-process replicas "
                         "behind the router, N kill/revive cycles under "
                         "continuous traffic; gates on zero non-rejected "
                         "failures, byte-identical results, and >= 1 "
                         "observed failover")
    ap.add_argument("--autoscale", type=int, default=0, metavar="N",
                    help="fleet-autoscale drill: 1 replica + the control "
                         "loop, N saturate/idle cycles; gates on zero "
                         "non-rejected failures, byte-identical results, "
                         "every cycle growing AND shrinking the pool, "
                         "and >= 1 pre-warmed ring shard")
    ap.add_argument("--chaos", type=int, default=0, metavar="N",
                    help="chaos-transport drill: 3 chaos-wrapped "
                         "replicas behind the durable router, N cycles "
                         "of sampled seeded transport-fault schedules "
                         "over mixed batch/converge traffic with "
                         "mid-stream kills; gates on zero non-rejected "
                         "failures, byte-identical completions incl. "
                         "resumed converge finals, >= 1 mid-stream "
                         "resume, exactly one final row per request_id")
    ap.add_argument("--volume", action="store_true",
                    help="with --chaos: every cycle also streams a "
                         "rank-3 (D,H,W) volume converge job, killed "
                         "mid-flight on odd cycles — resumed finals "
                         "must stay byte-identical to the volume "
                         "oracle")
    ap.add_argument("--chaos-matrix", type=int, default=0, metavar="N",
                    help="storage-chaos soak: N cycles of the full "
                         "serving.chaos_matrix fault-mode x "
                         "workload matrix, each under a different "
                         "seed; gates on every cycle reporting zero "
                         "failures (standing invariants: typed-only "
                         "failures, byte-identical completions, "
                         "exactly-once finals, no stale-byte serves)")
    ap.add_argument("--router-restart", type=int, default=0, metavar="N",
                    help="crash-safe control-plane drill: N router "
                         "lives over one WAL lineage; each life "
                         "resumes the previous life's crash-"
                         "interrupted converge job from the recovered "
                         "token (byte-identical, exactly-once finals), "
                         "crashes mid-stream at a seeded router_kill "
                         "row, and proves the dead life is fenced "
                         "typed stale_epoch")
    ap.add_argument("--shard-kill", type=int, default=0, metavar="N",
                    help="sharded control-plane drill: 3 active "
                         "routers over 3 per-shard WAL lineages, N "
                         "kill-one cycles under continuous traffic on "
                         "the surviving shards; gates on zero non-"
                         "rejected failures, byte-identical resumed "
                         "finals, exactly-once finals, one fenced "
                         "takeover per cycle, and the surviving "
                         "shards' p99 flat through the takeover")
    ap.add_argument("--summary-out", default=None, metavar="FILE",
                    help="also write the final summary row to FILE")
    ap.add_argument("--state-dir", default=None,
                    help="--faults: supervisor state dir (default: mkdtemp)")
    # Hidden: one drill in a child process (the supervisor's leg cmd).
    ap.add_argument("--fault-trial", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--serve-trial", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--reshape-trial", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--trial-seed", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--trial-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from parallel_convolution_tpu_torch.obs import events as obs_events

    obs_events.install_from_env()  # PCTPU_OBS_EVENTS: drill timeline

    if args.fault_trial:
        return run_fault_trial(args.fault_trial, args.trial_seed,
                               args.trial_out, args.device)
    if args.serve_trial:
        return run_serve_trial(args.serve_trial, args.trial_seed,
                               args.trial_out, args.device)
    if args.reshape_trial:
        return run_reshape_trial(args.reshape_trial, args.trial_seed,
                                 args.trial_out, args.device)
    if args.serve and not args.faults:
        ap.error("--serve requires --faults N")
    if args.reshape and args.faults:
        ap.error("--reshape and --faults are separate modes")
    if args.router_kill:
        return run_router_kill(args)
    if args.router_restart:
        return run_router_restart(args)
    if args.shard_kill:
        return run_shard_kill(args)
    if args.autoscale:
        return run_autoscale_drill(args)
    if args.chaos:
        return run_chaos_drill(args)
    if args.chaos_matrix:
        return run_chaos_matrix(args)
    if args.faults or args.reshape:
        return run_fault_soak(args)

    from parallel_convolution_tpu_torch.ops import filters, oracle
    from parallel_convolution_tpu_torch.parallel import step
    from parallel_convolution_tpu_torch.utils import imageio
    from parallel_convolution_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(args.device)   # the card unless asked; raises
    rng = random.Random(args.seed)
    fails = 0
    t0 = time.time()
    for i in range(args.n):
        cfg = sample_converge(rng) if args.converge else sample(rng)
        # Every sampled shape fits: the grid's slots may repeat a device
        # (the JAX script redraws shapes above its device count, and its
        # 8-device mesh holds them all, so the draws stay in step).
        if cfg["boundary"] == "periodic":
            # Documented contract: the torus needs grid-divisible dims.
            gr, gc = cfg["mesh"]
            cfg["H"] -= cfg["H"] % gr
            cfg["W"] -= cfg["W"] % gc
        # Documented contract: the fused slab needs blocks >= r * fuse
        # (step.py's up-front ValueError); shrink fuse to fit the
        # sampled geometry instead of sampling a rejected config.
        r = filters.get_filter(cfg["filter"]).radius
        gr, gc = cfg["mesh"]
        while cfg["fuse"] > 1 and (
                -(-cfg["H"] // gr) < r * cfg["fuse"]
                or -(-cfg["W"] // gc) < r * cfg["fuse"]):
            cfg["fuse"] //= 2
        if cfg["fuse"] == 1 and "interior_split" in cfg:
            cfg["interior_split"] = False
        row = dict(cfg, i=i, mesh="x".join(map(str, cfg["mesh"])))
        try:
            grid = slot_grid(cfg["mesh"], dev)
            if args.converge:
                row.update(run_converge(cfg, grid, dev))
            else:
                filt = filters.get_filter(cfg["filter"])
                mode = "grey" if cfg["channels"] == 1 else "rgb"
                img = imageio.generate_test_image(cfg["H"], cfg["W"], mode,
                                                  seed=cfg["img_seed"])
                want = oracle.run_serial_u8(img, filt, cfg["iters"],
                                            boundary=cfg["boundary"])
                x = imageio.interleaved_to_planar(img).astype(np.float32)
                out = step.sharded_iterate(
                    x, filt, cfg["iters"], grid=grid, quantize=True,
                    backend=cfg["backend"], storage=cfg["storage"],
                    fuse=cfg["fuse"], boundary=cfg["boundary"],
                    tile=cfg["tile"], interior_split=cfg["interior_split"])
                got = imageio.planar_to_interleaved(
                    out.cpu().numpy().astype(np.uint8))
                ok = bool(np.array_equal(got, want))
                row["ok"] = ok
                if not ok:
                    diff = got.astype(int) - want.astype(int)
                    row["max_abs_diff"] = int(np.abs(diff).max())
                    row["n_diff"] = int((diff != 0).sum())
        except Exception as e:
            msg = repr(e)
            row["ok"] = False
            row["error"] = msg[:500]
        if not row["ok"]:
            fails += 1
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "summary": "soak", "n": args.n, "seed": args.seed,
        "failures": fails, "device": str(dev),
        "wall_s": round(time.time() - t0, 1),
    }), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
