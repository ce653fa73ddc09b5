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
``all`` or a comma list of R·C slots, as ``serving.serve`` takes it.  The
sharded control plane (``--shards``, ``--peer``, ``--assign``,
``--advertise``, ``--state-dir``, ``--sync-interval-s``,
``--suspect-after``) and the autoscaler (``--autoscale-*``) parse and
exit 2 naming ROADMAP item 8b-ii.
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
                    help="enable the autoscaler (not ported yet: ROADMAP "
                         "item 8b-ii)")
    ap.add_argument("--autoscale-interval-s", type=float, default=None,
                    help="control-loop tick period (item 8b-ii)")
    ap.add_argument("--autoscale-cooldown-s", type=float, default=None,
                    help="minimum wall time between scale actions (item "
                         "8b-ii)")
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
    # The sharded control plane (ROADMAP item 8b-ii):
    ap.add_argument("--shards", type=int, default=0, metavar="N",
                    help="partition the control plane into N shards "
                         "(item 8b-ii)")
    ap.add_argument("--name", default="r0",
                    help="this router's fleet-unique name (sharded mode)")
    ap.add_argument("--state-dir", default=None, metavar="DIR",
                    help="the per-shard WAL lineages (item 8b-ii)")
    ap.add_argument("--peer", action="append", default=[],
                    metavar="NAME=URL", help="peer router (item 8b-ii)")
    ap.add_argument("--assign", action="append", default=[],
                    metavar="SHARD=NAME",
                    help="boot ownership of SHARD (item 8b-ii)")
    ap.add_argument("--advertise", default=None, metavar="URL",
                    help="own base URL in the shard map (item 8b-ii)")
    ap.add_argument("--sync-interval-s", type=float, default=None,
                    help="peer anti-entropy period (item 8b-ii)")
    ap.add_argument("--suspect-after", type=int, default=None,
                    help="failed syncs before a peer's shards are taken "
                         "over (item 8b-ii)")
    args = ap.parse_args(argv)

    from parallel_convolution_tpu_torch.utils.config import (
        FLEET_ITEM, pending,
    )

    unported = [flag for flag, given in (
        ("--shards", args.shards), ("--state-dir", args.state_dir),
        ("--peer", args.peer), ("--assign", args.assign),
        ("--advertise", args.advertise),
        ("--sync-interval-s", args.sync_interval_s is not None),
        ("--suspect-after", args.suspect_after is not None),
        ("--autoscale-max", args.autoscale_max),
        ("--autoscale-interval-s", args.autoscale_interval_s is not None),
        ("--autoscale-cooldown-s", args.autoscale_cooldown_s is not None),
    ) if given]
    if unported:
        print(f"error: {pending(' / '.join(unported), FLEET_ITEM)}",
              file=sys.stderr)
        return 2
    if bool(args.target) == bool(args.replicas):
        ap.error("exactly one of --target ... or --replicas N required")

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
    router = ReplicaRouter(
        replicas, quotas=quotas, pricer=pricer, vnodes=args.vnodes,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
        poll_interval_s=args.poll_interval_s,
        load_factor=args.load_factor,
        hedge_s=args.hedge_ms / 1e3 if args.hedge_ms else None,
        wal=args.wal)

    server = make_router_http_server(router, args.host, args.port)
    host, port = server.server_address[:2]
    obs_events.emit("router", event="boot", url=f"http://{host}:{port}",
                    replicas=[r.name for r in replicas])
    boot = {"routing": f"http://{host}:{port}",
            "replicas": [r.name for r in replicas],
            "tenant_quota": bool(quotas),
            "priced_admission": bool(pricer),
            "autoscale_max": None}
    if grid is not None:
        boot["mesh"] = "x".join(map(str, grid.shape))
        boot["device"] = str(grid.device)
    if args.wal:
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
        router.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
