"""Boot the convolution service behind the stdlib HTTP frontend.

The long-lived counterpart of the one-shot CLI: warm runners,
micro-batching, admission control, the result cache and per-request
latency phases (``serving/``).  The JAX package's ``scripts/serve.py``
as a module, with ``--device`` in place of ``--platform``; it runs on the
card unless asked for the CPU, and raises without CUDA.

  # the card, a grid of four slots on cuda:0, one config warmed
  python -m parallel_convolution_tpu_torch.serving.serve --port 0 \\
      --mesh 2x2 --device cuda:0,cuda:0,cuda:0,cuda:0 --cache \\
      --warm '{"rows": 1920, "cols": 2520, "mode": "rgb", "iters": 100,
               "backend": "cuda_rdma", "storage": "bf16", "fuse": 32}'
  # the CPU (the plain versions)
  python -m parallel_convolution_tpu_torch.serving.serve --port 8080 \\
      --mesh 2x2 --device cpu \\
      --warm '{"rows": 48, "cols": 64, "filter": "blur3", "iters": 2}'

  curl -s localhost:8080/healthz    # liveness + the service snapshot
  curl -s localhost:8080/readyz     # 503 during a reshape or a full queue

It prints one JSON line ``{"serving": "http://host:port", ...}`` once the
socket is bound (``--port 0`` picks a free port), and a final snapshot on
SIGINT / SIGTERM.  ``PCTPU_FAULTS`` and ``PCTPU_DISK_MODES`` are honoured
(``resilience.faults`` / ``resilience.diskio``), ``PCTPU_OBS_EVENTS``
appends the event log.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m parallel_convolution_tpu_torch.serving.serve",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="0 = pick a free port (printed on boot)")
    ap.add_argument("--mesh", default=None,
                    help="RxC grid (default: PCTPU_MESH, else 1x1, or "
                         "dims_create of the slots)")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda[:N] (default: the card), all (a slot "
                         "per block over the cards) or a comma list of "
                         "RxC slots")
    ap.add_argument("--capacity", type=int, default=16,
                    help="warm-runner cache size (LRU-evicted keys)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="micro-batch flush deadline")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission bound: deeper queues shed load")
    ap.add_argument("--no-fallback", action="store_true",
                    help="disable the per-key backend degradation ladder")
    ap.add_argument("--plans", default=None, metavar="PLANS_JSON",
                    help="tuner-emitted plan file (tune --emit-plans): "
                         "backend='auto' warm configs and requests "
                         "resolve through it")
    ap.add_argument("--warm", action="append", default=[],
                    metavar="JSON", help="config to build at startup "
                    '(repeatable), e.g. \'{"rows": 512, "cols": 512, '
                    '"mode": "rgb", "filter": "blur3", "iters": 10, '
                    '"backend": "cuda_sep"}\'')
    ap.add_argument("--cache", action="store_true",
                    help="enable the content-addressed result cache "
                         "(serving/cache.py): byte-identical duplicates "
                         "are served without touching the device")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="disk spill tier for the result cache "
                         "(implies --cache)")
    args = ap.parse_args(argv)

    from parallel_convolution_tpu_torch.obs import events as obs_events
    from parallel_convolution_tpu_torch.parallel.mesh import grid_from_spec
    from parallel_convolution_tpu_torch.resilience import diskio, faults
    from parallel_convolution_tpu_torch.serving.cache import ResultCache
    from parallel_convolution_tpu_torch.serving.frontend import (
        make_http_server,
    )
    from parallel_convolution_tpu_torch.serving.service import (
        ConvolutionService,
    )

    faults.install_from_env()
    diskio.install_from_env()   # PCTPU_DISK_MODES: storage fault shapes
    obs_events.install_from_env()  # PCTPU_OBS_EVENTS: the event timeline

    cache = None
    if args.cache or args.cache_dir:
        cache = ResultCache(disk_dir=args.cache_dir)
    service = ConvolutionService(
        grid_from_spec(args.mesh, args.device), capacity=args.capacity,
        max_batch=args.max_batch, max_delay_s=args.max_delay_ms / 1e3,
        max_queue=args.max_queue, fallback=not args.no_fallback,
        plans=args.plans, cache=cache)
    warm_cfgs = [json.loads(w) for w in args.warm]
    if warm_cfgs:
        # The engine's plan cache is already armed (plans=args.plans).
        effective = service.warmup(warm_cfgs)
        for cfg, eff in zip(warm_cfgs, effective):
            print(json.dumps({"warmed": cfg, "effective_backend": eff}),
                  flush=True)

    server = make_http_server(service, args.host, args.port)
    host, port = server.server_address[:2]
    snap = service.snapshot()
    obs_events.emit("serve", state="boot", url=f"http://{host}:{port}",
                    mesh=snap.get("mesh", ""))
    print(json.dumps({"serving": f"http://{host}:{port}",
                      **{k: v for k, v in snap.items()
                         if k in ("mesh", "platform", "device_kind")}}),
          flush=True)

    stopping = []

    def _stop(signum, frame):
        if stopping:   # timeout(1) and shell job control can double-signal
            return
        stopping.append(signum)
        print(json.dumps({"stopping": signum,
                          "final": service.snapshot()}), flush=True)
        # shutdown() must not run on the thread inside serve_forever (it
        # would wait for the suspended loop to acknowledge).
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
