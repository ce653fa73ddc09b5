"""Boot the replica-set router (``serving/router.py``) behind HTTP.

The JAX package's ``scripts/router.py`` as a module (it cannot share
``router.py``'s name), with ``--device`` in place of ``--platform``: the
in-process replicas run on the card unless asked for the CPU, and raise
without CUDA.  Two deployment shapes, one wire format:

  # N in-process replicas on the card, each a ConvolutionService on its
  # own grid of four slots of cuda:0
  python -m parallel_convolution_tpu_torch.serving.route --port 0 \\
      --replicas 2 --mesh 2x2 --tenant-rate 50 --tenant-burst 16
  # the CPU (the plain versions)
  python -m parallel_convolution_tpu_torch.serving.route --port 8090 \\
      --replicas 3 --mesh 2x2 --device cpu

  # routing over already-running replicas
  # (python -m parallel_convolution_tpu_torch.serving.serve ...)
  python -m parallel_convolution_tpu_torch.serving.route --port 8090 \\
      --target http://host-a:8080 --target http://host-b:8080

  # ONE member of a sharded control plane: three of these, each owning
  # one shard's WAL lineage under a shared --state-dir, peer-synced and
  # ready to take over a dead peer's shards
  python -m parallel_convolution_tpu_torch.serving.route --port 8090 \\
      --replicas 1 --mesh 1x1 --shards 3 --name rA \\
      --state-dir /var/pctpu/ctl --advertise http://host-a:8090 \\
      --assign 0=rA --assign 1=rB --assign 2=rC \\
      --peer rB=http://host-b:8091 --peer rC=http://host-c:8092
  python -m parallel_convolution_tpu_torch.serving.loadgen --shardmap \\
      --target http://host-a:8090 --target http://host-b:8091 ...

  # the autoscaler: grow the in-process pool up to 3 under load
  python -m parallel_convolution_tpu_torch.serving.route --port 0 \\
      --replicas 1 --autoscale-max 3 --autoscale-interval-s 0.25

  curl -s localhost:8090/readyz    # 200 iff any replica is ready
  python -m parallel_convolution_tpu_torch.serving.loadgen \\
      --target http://127.0.0.1:8090 --n 200 ...

Clients cannot tell the router from a replica (same ``/v1/convolve`` /
``/v1/converge`` bodies) except for the extra ``router`` stamp in each
response: the serving replica, the consistent-hash home, and the
attempt/failover/spill counts.  Tenant identity rides the ``x-tenant``
header or a ``tenant`` body field; ``--tenant-rate 0`` disables quota.

``--mesh RxC`` gives each in-process replica an R x C grid: on a card a
grid of slots of it (``mesh.grid_like``), so every replica runs the
per-slot kernels; ``--device`` names the device (``cpu``, ``cuda[:N]``),
``all`` or a comma list of R·C slots, as ``serving.serve`` takes it.
``--shards N`` makes this process one router of a sharded control plane
(``serving/peers.py``: a sub-router per owned shard, each on its own WAL
lineage under ``--state-dir``); ``--autoscale-max N`` arms the autoscaler
(``serving/autoscaler.py``) over the in-process pool.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def replica_grid(mesh: str | None, device: str | None):
    """One in-process replica's grid: ``--mesh`` / ``--device`` as
    ``serving.serve`` reads them, except that an R x C grid on one card is
    a grid of R·C slots of that card (``mesh.grid_like`` of its 1x1
    slot), so each replica runs the per-slot kernels."""
    from parallel_convolution_tpu_torch.parallel.mesh import (
        Grid, grid_from_spec, grid_like,
    )

    grid = grid_from_spec(mesh, device)
    if grid.slotted or grid.device.type != "cuda" or grid.shape == (1, 1):
        return grid
    return grid_like(Grid(1, 1, devices=(grid.device,)), grid.shape)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m parallel_convolution_tpu_torch.serving.route",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8090,
                    help="0 = pick a free port (printed on boot)")
    ap.add_argument("--target", action="append", default=[], metavar="URL",
                    help="HTTP replica base URL (repeatable; "
                         "serving.serve instances)")
    ap.add_argument("--replicas", type=int, default=0, metavar="N",
                    help="boot N in-process replicas instead of --target")
    ap.add_argument("--mesh", default=None,
                    help="RxC grid per in-process replica")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda[:N] (default: the card), all or a "
                         "comma list of RxC slots, per in-process replica")
    ap.add_argument("--plans", default=None, metavar="PLANS_JSON",
                    help="tuner plan file for in-process replicas")
    # Replica service knobs (in-process only):
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--max-queue", type=int, default=64)
    # Router knobs:
    ap.add_argument("--tenant-rate", type=float, default=0.0,
                    help="per-tenant token refill rate (req/s); 0 = no "
                         "tenant quota")
    ap.add_argument("--tenant-burst", type=float, default=16.0,
                    help="per-tenant bucket capacity")
    ap.add_argument("--vnodes", type=int, default=64,
                    help="virtual nodes per replica on the hash ring")
    ap.add_argument("--breaker-threshold", type=int, default=3,
                    help="consecutive failures that open a replica's "
                         "circuit")
    ap.add_argument("--breaker-cooldown-s", type=float, default=1.0)
    ap.add_argument("--poll-interval-s", type=float, default=0.25,
                    help="active /readyz health-poll period")
    ap.add_argument("--load-factor", type=float, default=2.0,
                    help="bounded-load spill: a replica carries at most "
                         "this multiple of the fair in-flight share")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="fire one extra attempt when the home replica "
                         "hasn't answered within this budget (off by "
                         "default)")
    ap.add_argument("--autoscale-max", type=int, default=0, metavar="N",
                    help="enable the autoscaler: grow the in-process "
                         "pool up to N replicas under load and shrink "
                         "back on idle (0 = fixed pool; in-process "
                         "replicas only)")
    ap.add_argument("--autoscale-interval-s", type=float, default=0.5,
                    help="control-loop tick period")
    ap.add_argument("--autoscale-cooldown-s", type=float, default=5.0,
                    help="minimum wall time between scale actions")
    ap.add_argument("--price-admission", action="store_true",
                    help="charge tenant buckets the cost model's "
                         "predicted device-seconds per request instead "
                         "of 1 token (--tenant-rate then means "
                         "device-seconds per second)")
    ap.add_argument("--wal", default=None, metavar="PATH",
                    help="arm the crash-safe control plane: journal "
                         "admissions/tokens/finals/ring/debt to PATH and "
                         "RECOVER from it at boot — restarting on the "
                         "same PATH is a fenced takeover (the epoch "
                         "bumps; a zombie predecessor gets typed "
                         "stale_epoch rejects)")
    # The sharded control plane (N active routers):
    ap.add_argument("--shards", type=int, default=0, metavar="N",
                    help="partition the control plane into N shards: "
                         "this process becomes ONE active router of a "
                         "fleet, owning the shards --assign maps to "
                         "--name (each on its own WAL lineage under "
                         "--state-dir) and redirecting the rest with "
                         "typed wrong_shard rejects; requires "
                         "--state-dir")
    ap.add_argument("--name", default="r0",
                    help="this router's fleet-unique name (sharded mode)")
    ap.add_argument("--state-dir", default=None, metavar="DIR",
                    help="directory holding the per-shard WAL lineages "
                         "(shard-N.wal); booting any fleet member over "
                         "the same DIR re-adopts its shards via the "
                         "fenced takeover")
    ap.add_argument("--peer", action="append", default=[],
                    metavar="NAME=URL",
                    help="peer router (repeatable): anti-entropy sync "
                         "target, debt-replication source, and takeover "
                         "candidate for this router's shards")
    ap.add_argument("--assign", action="append", default=[],
                    metavar="SHARD=NAME",
                    help="boot ownership of SHARD (repeatable; shards "
                         "left unassigned default to --name)")
    ap.add_argument("--advertise", default=None, metavar="URL",
                    help="own base URL published in the shard map (what "
                         "redirected clients should dial)")
    ap.add_argument("--sync-interval-s", type=float, default=0.25,
                    help="peer anti-entropy period (sharded mode)")
    ap.add_argument("--suspect-after", type=int, default=3,
                    help="consecutive failed syncs before a dead peer's "
                         "shards are taken over")
    args = ap.parse_args(argv)

    if bool(args.target) == bool(args.replicas):
        ap.error("exactly one of --target ... or --replicas N required")
    # The refusals of the JAX script, in its words, before anything is
    # built.
    peer_urls, assignments = {}, {}
    if args.shards:
        if not args.state_dir:
            ap.error("--shards requires --state-dir (the per-shard "
                     "WAL lineages live there)")
        if args.wal:
            ap.error("--shards replaces --wal: every shard gets its "
                     "own lineage under --state-dir")
        if args.autoscale_max:
            ap.error("--autoscale-max is not supported in sharded "
                     "mode")
        for spec in args.peer:
            nm, _, url = spec.partition("=")
            if not url:
                ap.error(f"--peer wants NAME=URL, got {spec!r}")
            peer_urls[nm] = url
        for spec in args.assign:
            sh, _, nm = spec.partition("=")
            if not nm:
                ap.error(f"--assign wants SHARD=NAME, got {spec!r}")
            assignments[sh] = nm
        for s in range(args.shards):
            assignments.setdefault(str(s), args.name)
    if args.autoscale_max and args.target:
        ap.error("--autoscale-max needs in-process --replicas (HTTP "
                 "targets have no provisioner to grow through)")

    from parallel_convolution_tpu_torch.obs import events as obs_events
    from parallel_convolution_tpu_torch.resilience import diskio, faults
    from parallel_convolution_tpu_torch.serving.router import (
        HTTPReplica, InProcessReplica, ReplicaRouter, TenantQuotas,
        make_router_http_server,
    )

    faults.install_from_env()
    diskio.install_from_env()   # PCTPU_DISK_MODES: storage fault shapes
    obs_events.install_from_env()

    grid = None
    if args.target:
        replicas = [HTTPReplica(url, name=f"r{i}")
                    for i, url in enumerate(args.target)]
    else:
        from parallel_convolution_tpu_torch.serving.service import (
            ConvolutionService,
        )

        grid = replica_grid(args.mesh, args.device)

        def factory():
            return ConvolutionService(
                grid, max_batch=args.max_batch,
                max_delay_s=args.max_delay_ms / 1e3,
                max_queue=args.max_queue, plans=args.plans)

        replicas = [InProcessReplica(factory, name=f"r{i}")
                    for i in range(args.replicas)]

    quotas = (TenantQuotas(args.tenant_rate, args.tenant_burst)
              if args.tenant_rate > 0 else None)
    pricer = None
    if args.price_admission:
        from parallel_convolution_tpu_torch.serving.pricing import WorkPricer
        from parallel_convolution_tpu_torch.utils import platform

        shape = (1, 1)
        if args.mesh:
            r, c = args.mesh.lower().split("x")
            shape = (int(r), int(c))
        if grid is None:
            pricer = WorkPricer(grid=shape)
        else:
            pricer = WorkPricer(grid=shape, platform=(
                "gpu" if grid.device.type == "cuda" else "cpu"),
                device_kind=platform.device_kind(grid.device))
    knobs = dict(
        vnodes=args.vnodes, breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
        poll_interval_s=args.poll_interval_s, load_factor=args.load_factor,
        hedge_s=args.hedge_ms / 1e3 if args.hedge_ms else None)
    if args.shards:
        from parallel_convolution_tpu_torch.serving.peers import (
            HTTPPeer, ShardRouter,
        )

        peers = [HTTPPeer(nm, url) for nm, url in peer_urls.items()]
        addrs = dict(peer_urls)
        if args.advertise:
            addrs[args.name] = args.advertise
        owned = [s for s, o in assignments.items() if o == args.name]
        router = ShardRouter(
            args.name, replicas, n_shards=args.shards, owned=owned,
            state_dir=args.state_dir, assignments=assignments,
            addrs=addrs, quotas=quotas, pricer=pricer, peers=peers,
            sync_interval_s=args.sync_interval_s,
            suspect_after=args.suspect_after, **knobs)
    else:
        router = ReplicaRouter(replicas, quotas=quotas, pricer=pricer,
                               wal=args.wal, **knobs)

    scaler = None
    if args.autoscale_max:
        from parallel_convolution_tpu_torch.serving.autoscaler import (
            AutoScaler,
        )

        def transport_factory(name):
            return InProcessReplica(factory, name=name)

        scaler = AutoScaler(
            router, transport_factory, min_replicas=len(replicas),
            max_replicas=max(args.autoscale_max, len(replicas)),
            interval_s=args.autoscale_interval_s,
            cooldown_s=args.autoscale_cooldown_s)
        scaler.start()

    server = make_router_http_server(router, args.host, args.port)
    host, port = server.server_address[:2]
    obs_events.emit("router", event="boot", url=f"http://{host}:{port}",
                    replicas=[r.name for r in replicas])
    boot = {"routing": f"http://{host}:{port}",
            "replicas": [r.name for r in replicas],
            "tenant_quota": bool(quotas),
            "priced_admission": bool(pricer),
            "autoscale_max": args.autoscale_max or None}
    if grid is not None:
        boot["mesh"] = "x".join(map(str, grid.shape))
        boot["device"] = str(grid.device)
    if args.shards:
        boot.update(name=args.name, shards=args.shards,
                    owned=sorted(router.snapshot()["owned_shards"]),
                    map_version=router.shardmap_wire()["version"],
                    state_dir=args.state_dir,
                    peers=[p.name for p in router.peers])
    elif args.wal:
        boot.update(wal=args.wal, epoch=router.epoch,
                    recovery=router.recovery)
    print(json.dumps(boot), flush=True)

    stopping = []

    def _stop(signum, frame):
        if stopping:
            return
        stopping.append(signum)
        print(json.dumps({"stopping": signum,
                          "final": router.snapshot()}), flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if scaler is not None:
            scaler.close()
        router.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
