"""Closed/open-loop load generator for the convolution service.

The JAX package's ``scripts/loadgen.py`` as a module.  It pushes a stream
of identical-config requests at either transport — ``--url`` /
``--target`` (a replica's HTTP frontend, or a router) or ``--in-process``
(no sockets; builds the service in this process, on the card unless
``--device cpu``) — and emits ONE summary row in the bench-row schema:
p50/p95/p99 latency, Gpixels/s, a queue/compile/device/copy phase
breakdown (means across completed requests), the effective backend(s)
that actually produced the bytes, and typed rejection counts.

  # closed loop: --concurrency workers, each issuing back-to-back
  python -m parallel_convolution_tpu_torch.serving.loadgen --in-process \
      --device cpu --n 50 --concurrency 4 --rows 48 --cols 64 --iters 2

  # open loop: fixed arrival rate (req/s), concurrency unbounded-ish
  python -m parallel_convolution_tpu_torch.serving.loadgen \
      --url http://127.0.0.1:8080 --n 200 --rate 50

  # one router (python -m parallel_convolution_tpu_torch.serving.route)
  python -m parallel_convolution_tpu_torch.serving.loadgen \
      --target http://127.0.0.1:8090 --wire frames --n 16 --concurrency 4

Exit status is 0 iff every request either completed or was shed with a
TYPED rejection — a transport error, HTTP 5xx terminal failure, or
byte-size mismatch is a non-rejected failure and exits 1.  ``--check``
additionally byte-compares every completed response against the NumPy
oracle (``ops/oracle.py``).

RETRYABLE rejections (``retryable: true`` in the body — queue_full /
resharding / tenant_quota / replica_unavailable) are honored with capped
backoff (the body's ``retry_after_s``, else exponential) up to
``--shed-retries`` attempts instead of counting as final outcomes; the
summary row reports ``rejected_retried``.  Multiple ``--target`` URLs
round-robin the request stream across a raw replica set, or point one
``--target`` at a router — responses carrying a ``router`` stamp feed
the row's ``failovers_observed``, and their fencing-epoch stamps feed
``router_restarts_observed`` (the router restarts / takeovers this client
watched happen while its run kept completing).  The durability stamp
feeds ``degraded_served``: completions answered while the router's WAL
was in a degraded-durability window.

``--shardmap`` makes multiple ``--target`` URLs a SHARDED router fleet
(``serving.route --shards N``): the client fetches the version-stamped
map from ``GET /v1/shardmap``, routes every request to its key shard's
owner, and treats a typed ``wrong_shard`` / ``stale_epoch`` reject as a
stale map — refresh and retry at the new owner — counted in the row's
``shardmap_refreshes``, never as a failure.

  python -m parallel_convolution_tpu_torch.serving.loadgen --shardmap \
      --target http://127.0.0.1:8090 --target http://127.0.0.1:8091 \
      --target http://127.0.0.1:8092 --n 16 --concurrency 4
"""

from __future__ import annotations

import argparse
import base64
import json
import statistics
import sys
import threading
import time


def _percentile(sorted_vals: list[float], q: float) -> float | None:
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def poisson_arrivals(rps: float, fire, *, duration_s: float | None = None,
                     n: int | None = None, seed: int = 0):
    """Open-loop POISSON arrival process (the sustained-load harness's
    one arrival loop).

    Spawns ``fire(i)`` on a daemon thread at exponential inter-arrival
    gaps with mean rate ``rps`` (seeded — a rerun offers the same
    process), until ``duration_s`` wall seconds elapse (when given) else
    ``n`` arrivals.  Arrivals ignore completions, so a saturated server
    shows up as latency growth and typed sheds, never a silently
    reduced offered rate.  Returns ``(issued, threads)`` — the caller
    joins the threads on its own timeout.
    """
    import random

    rng = random.Random(seed)
    threads: list[threading.Thread] = []
    t0 = time.perf_counter()
    deadline = t0 + duration_s if duration_s is not None else None
    target = t0
    i = 0
    while True:
        if deadline is None and i >= (n or 0):
            break
        target += rng.expovariate(rps)
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        if deadline is not None and time.perf_counter() >= deadline:
            break
        th = threading.Thread(target=fire, args=(i,), daemon=True)
        th.start()
        threads.append(th)
        i += 1
    return i, threads


def _frames_profile(body: dict, img) -> tuple[dict, bytes]:
    """Split a JSON request body into ``(header, raw_frame_bytes)`` for
    the binary wire: the tensor (u8 image, or f32 volume on a
    ``mode: "volume"`` body) crosses as a typed frame, everything else
    stays in the envelope's JSON header.  The split is done ONCE per
    profile — per request the (tiny) header is restamped with its
    request_id and re-joined around the same frame bytes
    (``join_envelope``), which is exactly the zero-copy path the wire
    exists for."""
    from parallel_convolution_tpu_torch.serving import frames as frames_mod

    tensor_key = "volume" if "volume_b64" in body else "image"
    header = {k: v for k, v in body.items()
              if k not in ("image_b64", "volume_b64")}
    env = frames_mod.encode_envelope(dict(header), {tensor_key: img})
    fheader, raw = frames_mod.split_envelope(env)
    return fheader, bytes(raw)


def _frames_resp_dict(data: bytes) -> dict:
    """Decode a framed response/row envelope into the JSON-shaped dict
    the summary accounting already understands (the image frame folds
    back into ``image_b64`` so byte checks stay codec-agnostic)."""
    from parallel_convolution_tpu_torch.serving import frames as frames_mod

    header, arrays = frames_mod.decode_envelope(data)
    img = arrays.get("image")
    if img is not None:
        import numpy as np

        header["image_b64"] = base64.b64encode(
            np.ascontiguousarray(img).tobytes()).decode("ascii")
    return header


def _drain_rows(rows) -> dict:
    """Drain a converge NDJSON stream to its FINAL row (or the typed
    rejection), folding the row count in as ``rows_streamed`` — the one
    place the transports' final-row contract lives."""
    last, n = {"ok": False, "detail": "empty stream"}, 0
    for r in rows:
        last, n = r, n + 1
    last["rows_streamed"] = n
    return last


class _HTTPTransport:
    def __init__(self, url: str, timeout: float):
        self.base = url.rstrip("/")
        self.timeout = timeout

    def request(self, body: dict) -> tuple[int, dict]:
        import urllib.error
        import urllib.request

        data = json.dumps(body).encode()
        req = urllib.request.Request(
            f"{self.base}/v1/convolve", data=data,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read())
            except Exception:  # noqa: BLE001
                return e.code, {"ok": False, "detail": f"http {e.code}"}

    def converge(self, body: dict) -> tuple[int, dict]:
        """One progressive convergence job: POST /v1/converge, drain the
        NDJSON stream, return the FINAL row (or the typed rejection)
        with the snapshot count folded in as ``rows_streamed``."""
        import urllib.error
        import urllib.request

        data = json.dumps(body).encode()
        req = urllib.request.Request(
            f"{self.base}/v1/converge", data=data,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, _drain_rows(
                    json.loads(line) for line in resp if line.strip())
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read())
            except Exception:  # noqa: BLE001
                return e.code, {"ok": False, "detail": f"http {e.code}"}
        except (OSError, ValueError) as e:
            # The stream broke (or corrupted) mid-drain: a typed
            # RETRYABLE outcome, not a client crash — the retry loop
            # re-submits the job and a durable router resumes it from
            # its ledger token instead of iteration 0.
            return 200, {"ok": False, "kind": "rejected",
                         "rejected": "replica_unavailable",
                         "retryable": True,
                         "detail": f"stream broke: {e}"[:300]}

    def request_frames(self, raw: bytes) -> tuple[int, dict]:
        """Binary-wire convolve: envelope bytes up, framed response
        decoded back into the JSON-shaped summary dict."""
        import urllib.error
        import urllib.request

        from parallel_convolution_tpu_torch.serving import frames as frames_mod

        req = urllib.request.Request(
            f"{self.base}/v1/convolve", data=raw,
            headers={"Content-Type": frames_mod.FRAMES_CONTENT_TYPE})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, _frames_resp_dict(resp.read())
        except urllib.error.HTTPError as e:
            try:
                return e.code, _frames_resp_dict(e.read())
            except Exception:  # noqa: BLE001
                return e.code, {"ok": False, "detail": f"http {e.code}"}

    def converge_frames(self, raw: bytes) -> tuple[int, dict]:
        """Binary-wire converge: drain the length-prefixed framed row
        stream to its final row (the frames twin of :meth:`converge`)."""
        import urllib.error
        import urllib.request

        from parallel_convolution_tpu_torch.serving import frames as frames_mod
        from parallel_convolution_tpu_torch.serving.frontend import (
            iter_framed_rows,
        )

        req = urllib.request.Request(
            f"{self.base}/v1/converge", data=raw,
            headers={"Content-Type": frames_mod.FRAMES_CONTENT_TYPE})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, _drain_rows(
                    _frames_resp_dict(r) for r in iter_framed_rows(resp))
        except urllib.error.HTTPError as e:
            try:
                return e.code, _frames_resp_dict(e.read())
            except Exception:  # noqa: BLE001
                return e.code, {"ok": False, "detail": f"http {e.code}"}
        except (OSError, ValueError) as e:
            # Same retryable shape as the JSON stream-break path.
            return 200, {"ok": False, "kind": "rejected",
                         "rejected": "replica_unavailable",
                         "retryable": True,
                         "detail": f"stream broke: {e}"[:300]}

    def snapshot(self) -> dict:
        import urllib.request

        with urllib.request.urlopen(f"{self.base}/stats",
                                    timeout=self.timeout) as resp:
            return json.loads(resp.read())


class _ShardedTransport:
    """The shard-aware client half over HTTP (the in-process twin is
    ``serving.peers.ShardClient``): fetch the version-stamped ownership
    map from any fleet member, compute each request's shard from its
    route key, dial the owner directly, and treat a typed
    ``wrong_shard``/``stale_epoch`` reject as "my map is stale" —
    refresh and retry at the new owner, bounded."""

    _REROUTE = ("wrong_shard", "stale_epoch")

    def __init__(self, urls: list[str], timeout: float,
                 max_redirects: int = 4):
        self._by_addr = {u.rstrip("/"): _HTTPTransport(u, timeout)
                         for u in urls}
        self.timeout = timeout
        self.max_redirects = max_redirects
        self._lock = threading.Lock()
        self._map: dict = {"version": -1, "n_shards": 1, "shards": {}}
        self.refreshes = 0
        self.refresh()

    def refresh(self) -> dict:
        import urllib.request

        last: Exception | None = None
        for base in list(self._by_addr):
            try:
                with urllib.request.urlopen(
                        base + "/v1/shardmap",
                        timeout=self.timeout) as r:
                    smw = json.loads(r.read())
            except Exception as e:  # noqa: BLE001 — try the next member
                last = e
                continue
            with self._lock:
                if smw.get("version", -1) >= self._map.get("version",
                                                           -1):
                    self._map = smw
                self.refreshes += 1
                return dict(self._map)
        raise ConnectionError(
            f"no fleet member answered /v1/shardmap: {last!r}")

    def _transport_for(self, body: dict):
        from parallel_convolution_tpu_torch.serving.peers import shard_of
        from parallel_convolution_tpu_torch.serving.router import route_key

        with self._lock:
            smw = self._map
        shard = shard_of(route_key(dict(body)),
                         smw.get("n_shards", 1) or 1)
        ent = (smw.get("shards") or {}).get(shard) or {}
        addr = (ent.get("addr") or "").rstrip("/")
        with self._lock:
            tr = self._by_addr.get(addr)
            if tr is None and addr:
                # A takeover can publish an owner addr we were never
                # given on the command line — dial it anyway.
                tr = self._by_addr.setdefault(
                    addr, _HTTPTransport(addr, self.timeout))
        if tr is None:
            tr = next(iter(self._by_addr.values()))
        return tr

    def _call(self, method: str, body: dict):
        status, wire = -1, {"ok": False, "detail": "no attempt"}
        for _ in range(self.max_redirects):
            tr = self._transport_for(body)
            try:
                status, wire = getattr(tr, method)(body)
            except Exception as e:  # noqa: BLE001 — owner unreachable
                # A dead owner is indistinguishable from a stale map:
                # re-fetch from the survivors and retry at whoever the
                # takeover elected.  If it never converges, hand the
                # outer loop a typed RETRYABLE outcome (the same shape
                # the broken-stream path uses) so its capped backoff
                # spans the takeover window.
                status = -1
                wire = {"ok": False, "kind": "rejected",
                        "rejected": "replica_unavailable",
                        "retryable": True,
                        "detail": f"owner unreachable: {e!r}"[:300]}
                try:
                    self.refresh()
                except ConnectionError:
                    pass
                time.sleep(0.05)
                continue
            if (isinstance(wire, dict)
                    and wire.get("rejected") in self._REROUTE):
                # Ownership moved underneath us (redirect or fenced
                # takeover): stale map, not a failed request.
                try:
                    self.refresh()
                except ConnectionError:
                    pass
                continue
            return status, wire
        return status, wire

    def request(self, body: dict):
        return self._call("request", body)

    def converge(self, body: dict):
        return self._call("converge", body)

    def snapshot(self) -> dict:
        return next(iter(self._by_addr.values())).snapshot()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m parallel_convolution_tpu_torch.serving.loadgen",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    tgt = ap.add_mutually_exclusive_group(required=True)
    tgt.add_argument("--url", default=None,
                     help="HTTP frontend base URL (serving.serve); "
                          "alias for a single --target")
    tgt.add_argument("--target", action="append", default=None,
                     metavar="URL",
                     help="HTTP target base URL (repeatable: requests "
                          "round-robin across a raw replica set, or give "
                          "one router URL)")
    tgt.add_argument("--in-process", action="store_true",
                     help="build the service in this process (no sockets)")
    ap.add_argument("--shardmap", action="store_true",
                    help="treat the --target URLs as a SHARDED router "
                         "fleet (serving.route --shards N): fetch GET "
                         "/v1/shardmap, route each request to its key "
                         "shard's owner, and refresh-and-retry on typed "
                         "wrong_shard / stale_epoch rejects")
    ap.add_argument("--n", type=int, default=50, help="total requests")
    ap.add_argument("--concurrency", type=int, default=4,
                    help="closed-loop worker count (ignored with --rate)")
    ap.add_argument("--rate", type=float, default=None, metavar="RPS",
                    help="open loop: fixed arrival rate in requests/sec")
    ap.add_argument("--rps", type=float, default=None, metavar="RPS",
                    help="open loop with POISSON arrivals at this mean "
                         "rate (exponential inter-arrival gaps — the "
                         "sustained-load harness; pair with "
                         "--duration-s, which then overrides --n)")
    ap.add_argument("--duration-s", type=float, default=None,
                    metavar="SEC",
                    help="run for this long instead of a fixed --n "
                         "(--rps only); the summary row stamps offered "
                         "vs achieved RPS")
    ap.add_argument("--rows", type=int, default=48)
    ap.add_argument("--cols", type=int, default=64)
    ap.add_argument("--mode", default="grey", choices=["grey", "rgb"])
    ap.add_argument("--volume", default=None, metavar="DxHxW",
                    help="rank-3 volume body mode: each request carries "
                         "one seeded (2, D, H, W) float32 volume "
                         "(mode: \"volume\" on the wire) instead of a "
                         "u8 image — pair with a rank-3 --filter "
                         "(fd7/fd25/wave/grayscott); overrides "
                         "--rows/--cols/--mode and excludes "
                         "--mixed-sizes/--zipf/--check")
    ap.add_argument("--filter", default="blur3", dest="filter_name")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--backend", default="shifted")
    ap.add_argument("--storage", default="f32")
    ap.add_argument("--fuse", type=int, default=1)
    ap.add_argument("--boundary", default="zero")
    ap.add_argument("--converge", type=float, default=None, metavar="TOL",
                    help="drive /v1/converge instead of /v1/convolve: "
                         "each request is one progressive convergence "
                         "job streamed to its final row (--iters is "
                         "ignored; see --max-iters/--solver)")
    ap.add_argument("--max-iters", type=int, default=2000,
                    help="convergence work budget per job (fine-grid "
                         "work units; --converge only)")
    ap.add_argument("--check-every", type=int, default=10,
                    help="snapshot cadence in iterations (--converge "
                         "with the jacobi solver; multigrid streams one "
                         "row per V-cycle)")
    ap.add_argument("--solver", default="jacobi",
                    choices=["jacobi", "multigrid"],
                    help="convergence strategy (--converge only)")
    ap.add_argument("--mg-levels", type=int, default=None,
                    help="multigrid level-count cap (--converge only)")
    ap.add_argument("--wire", default="json",
                    choices=["json", "frames", "mixed"],
                    help="wire codec: 'json' (base64-in-JSON, the "
                         "control arm), 'frames' (the binary tensor-"
                         "frame envelope), or 'mixed' (alternate arms "
                         "per request — the A/B shape)")
    ap.add_argument("--mixed-sizes", action="store_true",
                    help="interleave the --rows/--cols thumbnail with "
                         "full 1920x2520 frames — the mixed-size "
                         "workload the shape-bucketed batcher lanes "
                         "exist for")
    ap.add_argument("--zipf", type=float, default=None, metavar="S",
                    help="duplicate-heavy traffic: draw each request's "
                         "image from a --pool of distinct seeded images "
                         "with Zipf(S)-ranked probabilities (S=0 is "
                         "uniform-unique-ish, S>=1.1 is the classic "
                         "duplicate-heavy head) — deterministic per "
                         "(seed, index), so a rerun offers the same "
                         "stream; the summary row reports the served "
                         "cache hit rate")
    ap.add_argument("--pool", type=int, default=16,
                    help="distinct images in the --zipf pool")
    ap.add_argument("--cache", action="store_true",
                    help="enable the content-addressed result cache on "
                         "the in-process service (no-op with --url: the "
                         "server's own --cache flag decides)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request latency budget (missed -> typed shed)")
    ap.add_argument("--tenant", default=None,
                    help="tenant identity stamped into every request "
                         "(the router's QoS key)")
    ap.add_argument("--shed-retries", type=int, default=4,
                    help="max capped-backoff retries of a RETRYABLE "
                         "rejection before accepting it as the outcome")
    ap.add_argument("--backoff-cap-s", type=float, default=1.0,
                    help="ceiling on one shed-retry backoff sleep")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="client-side wait per request")
    ap.add_argument("--seed", type=int, default=0, help="image seed")
    ap.add_argument("--check", action="store_true",
                    help="byte-compare completed responses vs the oracle")
    ap.add_argument("--check-against", default=None, metavar="NPY",
                    help="--check against the u8 array in this .npy file "
                         "(the one image's answer computed elsewhere, "
                         "say by the card's shifted path) instead of "
                         "running the NumPy oracle here")
    ap.add_argument("--out", default=None,
                    help="also write the summary row JSON to this path")
    ap.add_argument("--trace-out", default=None, metavar="JSONL",
                    help="per-request JSONL trace (request_id, server "
                         "trace_id, latency, phases, outcome) — tail-"
                         "latency spikes become attributable to a specific "
                         "request/phase, and the trace_id joins each row "
                         "to the server-side span tree "
                         "(obs.report --client-trace)")
    # In-process service knobs (no-ops with --url):
    ap.add_argument("--mesh", default=None, help="RxC (in-process only)")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda[:N] (default: the card), all or a "
                         "comma list of RxC slots (in-process only)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--warm", action="store_true",
                    help="pre-compile the config before the timed run "
                         "(in-process; separates compile from steady-state)")
    args = ap.parse_args(argv)
    if args.check_against:
        if args.zipf is not None:
            ap.error("--check-against holds one answer; --zipf draws a pool")
        args.check = True

    import numpy as np

    from parallel_convolution_tpu_torch.utils import imageio

    vol_shape = None
    if args.volume is not None:
        try:
            vol_shape = tuple(int(v) for v in args.volume.split("x"))
            if len(vol_shape) != 3 or min(vol_shape) < 1:
                raise ValueError
        except ValueError:
            ap.error(f"--volume must be DxHxW positive ints, got "
                     f"{args.volume!r}")
        for flag, name in ((args.mixed_sizes, "--mixed-sizes"),
                           (args.zipf is not None, "--zipf"),
                           (args.check, "--check"),
                           (args.warm, "--warm")):
            if flag:
                ap.error(f"--volume and {name} are exclusive (volumes "
                         "are single-profile f32 bodies)")
    if vol_shape is not None:
        # Bounded [0, 1] fields: safe for every rank-3 form including
        # Gray-Scott's cubic uvv term (unbounded data diverges).
        D, H, W = vol_shape
        rng = np.random.default_rng(args.seed)
        img = np.ascontiguousarray(
            rng.random((2, D, H, W), dtype=np.float32))
        args.rows, args.cols = H, W
        body = {
            "volume_b64": base64.b64encode(img.tobytes()).decode("ascii"),
            "rows": H, "cols": W, "depth": D, "mode": "volume",
            "filter": args.filter_name, "iters": args.iters,
            "backend": args.backend,
            "fuse": args.fuse, "boundary": args.boundary,
        }
    else:
        img = imageio.generate_test_image(args.rows, args.cols, args.mode,
                                          seed=args.seed)
        body = {
            "image_b64": base64.b64encode(
                np.ascontiguousarray(img).tobytes()).decode("ascii"),
            "rows": args.rows, "cols": args.cols, "mode": args.mode,
            "filter": args.filter_name, "iters": args.iters,
            "backend": args.backend, "storage": args.storage,
            "fuse": args.fuse, "boundary": args.boundary,
        }
    if args.deadline_ms is not None:
        body["deadline_ms"] = args.deadline_ms
    if args.tenant:
        body["tenant"] = args.tenant
    if args.converge is not None:
        # Convergence-job wire shape: tol/max_iters/check_every replace
        # iters/deadline; float carries (quantize=False) are the
        # converge default and multigrid's requirement.
        body.pop("iters", None)
        body.pop("deadline_ms", None)
        body.update(tol=args.converge, max_iters=args.max_iters,
                    check_every=args.check_every, quantize=False,
                    solver=args.solver)
        if args.mg_levels is not None:
            body["mg_levels"] = args.mg_levels

    # Request profiles: one fixed config, or (--mixed-sizes) the
    # thumbnail interleaved with a full 1920x2520 frame — near-miss
    # shapes that land in DIFFERENT batcher lanes, the continuous-
    # batching stress shape.  Requests round-robin profiles by index.
    profiles = [(body, img)]
    if args.mixed_sizes:
        big_img = imageio.generate_test_image(1920, 2520, args.mode,
                                              seed=args.seed + 1)
        profiles.append((dict(body, rows=1920, cols=2520,
                              image_b64=base64.b64encode(
                                  np.ascontiguousarray(big_img).tobytes()
                              ).decode("ascii")), big_img))
    if args.zipf is not None and args.mixed_sizes:
        ap.error("--zipf and --mixed-sizes are exclusive (the zipf pool "
                 "is same-shape by design: it isolates content "
                 "duplication from lane mixing)")
    if args.zipf is not None:
        # The duplicate-heavy head: a pool of DISTINCT same-config
        # images, request i drawing pool rank r with probability
        # ∝ 1/r^S — real traffic's shape, and the result cache's
        # reason to exist.  Selection is deterministic per (seed, i):
        # a rerun offers byte-identical traffic.
        import random

        for k in range(1, max(1, args.pool)):
            pimg = imageio.generate_test_image(
                args.rows, args.cols, args.mode, seed=args.seed + k)
            profiles.append((dict(body, image_b64=base64.b64encode(
                np.ascontiguousarray(pimg).tobytes()).decode("ascii")),
                pimg))
        _zw = [1.0 / (r ** args.zipf)
               for r in range(1, len(profiles) + 1)]
        _zcum = []
        _acc = 0.0
        for w in _zw:
            _acc += w
            _zcum.append(_acc)

        def pick(i: int) -> int:
            rng = random.Random((args.seed << 24) ^ (1000003 * (i + 1)))
            return rng.choices(range(len(profiles)),
                               cum_weights=_zcum)[0]
    else:
        def pick(i: int) -> int:
            return i % len(profiles)
    # Binary-wire profiles: header/frames split once, request_id
    # restamped per request around the SAME frame bytes.
    fprofiles = ([_frames_profile(b, im) for b, im in profiles]
                 if args.wire != "json" else [])

    targets = args.target or ([args.url] if args.url else None)
    if args.shardmap and not targets:
        ap.error("--shardmap needs HTTP --target fleet members")
    service = None
    if args.in_process:
        from parallel_convolution_tpu_torch.obs import events as obs_events
        from parallel_convolution_tpu_torch.resilience import diskio, faults
        from parallel_convolution_tpu_torch.serving.frontend import InProcessClient
        from parallel_convolution_tpu_torch.serving.service import (
            ConvolutionService,
        )

        faults.install_from_env()
        diskio.install_from_env()   # PCTPU_DISK_MODES: disk fault shapes
        obs_events.install_from_env()  # PCTPU_OBS_EVENTS: leave a timeline
        from parallel_convolution_tpu_torch.parallel.mesh import (
            grid_from_spec,
        )

        grid = grid_from_spec(args.mesh, args.device)
        cache = None
        if args.cache:
            from parallel_convolution_tpu_torch.serving.cache import ResultCache

            cache = ResultCache()
        service = ConvolutionService(
            grid, max_batch=args.max_batch,
            max_delay_s=args.max_delay_ms / 1e3, max_queue=args.max_queue,
            cache=cache)
        client = InProcessClient(service)
        if args.converge is not None:
            def _converge_inproc(b):
                status, rows = client.converge(b, timeout=args.timeout)
                return status, _drain_rows(rows)

            def _converge_frames_inproc(raw):
                status, rows = client.converge_frames(
                    raw, timeout=args.timeout)
                return status, _drain_rows(
                    _frames_resp_dict(r) for r in rows)

            transports = [_converge_inproc]
            ftransports = [_converge_frames_inproc]
        else:
            def _request_frames_inproc(raw):
                status, data = client.request_frames(
                    raw, timeout=args.timeout)
                return status, _frames_resp_dict(data)

            transports = [lambda b: client.request(b, timeout=args.timeout)]
            ftransports = [_request_frames_inproc]
        transport_snapshot = service.snapshot
    elif args.shardmap:
        if args.wire != "json":
            ap.error("--shardmap routes on the JSON route key; use "
                     "--wire json")
        sharded = _ShardedTransport(targets, args.timeout)
        transports = [sharded.converge if args.converge is not None
                      else sharded.request]
        ftransports = []
        transport_snapshot = sharded.snapshot
    else:
        https = [_HTTPTransport(url, args.timeout) for url in targets]
        transports = [(h.converge if args.converge is not None
                       else h.request) for h in https]
        ftransports = [(h.converge_frames if args.converge is not None
                        else h.request_frames) for h in https]
        transport_snapshot = https[0].snapshot

    if args.warm and service is not None:
        service.warmup([{"rows": b["rows"], "cols": b["cols"],
                         "mode": args.mode, "filter": args.filter_name,
                         "iters": args.iters, "backend": args.backend,
                         "storage": args.storage, "fuse": args.fuse,
                         "boundary": args.boundary}
                        for b, _ in profiles])

    wants = None
    if args.check and args.converge is not None:
        ap.error("--check byte-compares the fixed-count oracle; it does "
                 "not apply to --converge jobs")
    if args.check and args.mixed_sizes:
        ap.error("--check byte-compares the single fixed-size oracle; "
                 "check each size in a run of its own")
    if args.check:
        from parallel_convolution_tpu_torch.ops import oracle
        from parallel_convolution_tpu_torch.ops.filters import get_filter

        # One oracle per profile image: a --zipf run byte-checks every
        # pool member, so a cache HIT serving stale/wrong bytes can
        # never pass (the hit-vs-miss byte-identity gate).
        filt = get_filter(args.filter_name)
        wants = ([np.load(args.check_against).tobytes()]
                 if args.check_against else
                 [oracle.run_serial_u8(im, filt, args.iters,
                                       boundary=args.boundary).tobytes()
                  for _, im in profiles])

    results = []                      # (index, latency_s, status, resp)
    results_lock = threading.Lock()
    retried = [0]                     # capped-backoff shed retries issued

    def one_request(i: int) -> None:
        # Round-robin across targets AND profiles; request_id is stable
        # across shed retries ON PURPOSE (it is the idempotency key — a
        # retry that races a late completion dedups at the replica).
        # --wire mixed alternates codec arms on a stride DECOUPLED from
        # the profile stride, so each size sees both codecs.
        pbody, _ = profiles[pick(i)]
        framed = (args.wire == "frames"
                  or (args.wire == "mixed"
                      and (i // len(profiles)) % 2 == 1))
        if framed:
            from parallel_convolution_tpu_torch.serving import (
                frames as frames_mod,
            )

            fheader, fraw = fprofiles[pick(i)]
            request = ftransports[i % len(ftransports)]
            b = frames_mod.join_envelope(
                {**fheader, "request_id": f"lg{i}"}, fraw)
        else:
            request = transports[i % len(transports)]
            b = dict(pbody, request_id=f"lg{i}")
        t0 = time.perf_counter()
        ts = time.time()
        attempt = 0
        while True:
            try:
                status, resp = request(b)
            except Exception as e:  # noqa: BLE001 — a transport failure row
                status, resp = -1, {"ok": False, "detail": repr(e)[:300]}
            retryable = (not resp.get("ok") and resp.get("retryable")
                         and resp.get("rejected") != "timeout")
            if not retryable or attempt >= args.shed_retries:
                break
            # Honor the server's back-off hint, capped; else exponential.
            attempt += 1
            with results_lock:
                retried[0] += 1
            hint = resp.get("retry_after_s")
            delay = (float(hint) if hint is not None
                     else 0.05 * 2 ** (attempt - 1))
            time.sleep(min(delay, args.backoff_cap_s))
        lat = time.perf_counter() - t0
        with results_lock:
            results.append((i, ts, lat, status, resp))

    if args.rps and args.rate:
        ap.error("--rps (Poisson) and --rate (fixed clock) are exclusive")
    if args.duration_s and not args.rps:
        ap.error("--duration-s needs --rps")

    n_issued = args.n
    t_start = time.perf_counter()
    if args.rps:
        # Open loop, POISSON arrivals (see poisson_arrivals):
        # --duration-s bounds the run by wall time (the sustained-load
        # harness shape), else --n bounds it by count.
        n_issued, threads = poisson_arrivals(
            args.rps, one_request, duration_s=args.duration_s,
            n=None if args.duration_s else args.n, seed=args.seed)
        for th in threads:
            th.join(args.timeout)
    elif args.rate:
        # Open loop: arrivals on a fixed clock regardless of completions —
        # each request gets its own thread so a slow server shows up as
        # latency (and eventually typed queue_full sheds), not as a
        # silently reduced offered rate.
        threads = []
        interval = 1.0 / args.rate
        for i in range(args.n):
            target = t_start + i * interval
            delay = target - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(target=one_request, args=(i,), daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(args.timeout)
    else:
        # Closed loop: --concurrency workers, each back-to-back.
        counter = iter(range(args.n))
        counter_lock = threading.Lock()

        def worker():
            while True:
                with counter_lock:
                    i = next(counter, None)
                if i is None:
                    return
                one_request(i)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(max(1, args.concurrency))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    wall = time.perf_counter() - t_start

    if args.trace_out:
        # The per-request timeline: one JSONL line per issued request, in
        # issue order — a p99 spike is now a grep, not a guess.
        from pathlib import Path

        tp = Path(args.trace_out)
        tp.parent.mkdir(parents=True, exist_ok=True)
        with open(tp, "w") as f:  # diskio: exempt — own trace, not drilled
            for i, ts, lat, s, r in sorted(results):
                line = {
                    "request_id": r.get("request_id") or f"lg{i}",
                    # The SERVER-assigned trace id: joins this
                    # client-side record to the server-side span tree in
                    # the event log — obs.report --client-trace does
                    # the merge offline.
                    "trace_id": r.get("trace_id", ""),
                    "ts": round(ts, 6),
                    "latency_ms": round(1e3 * lat, 3),
                    "status": s,
                    "ok": bool(r.get("ok")),
                }
                if r.get("ok"):
                    line.update(
                        effective_backend=r.get("effective_backend", ""),
                        effective_grid=r.get("effective_grid", ""),
                        batch_size=r.get("batch_size"),
                        plan_source=r.get("plan_source", ""),
                        phases=r.get("phases", {}),
                        # The result-cache stamp every served body
                        # carries (hit|miss|off + input digest).
                        cache=r.get("cache", ""),
                        digest=(r.get("digest") or "")[:16],
                    )
                else:
                    line.update(rejected=r.get("rejected"),
                                detail=(r.get("detail") or "")[:200])
                f.write(json.dumps(line) + "\n")

    completed = [(lat, r) for _, _, lat, s, r in results
                 if s == 200 and r.get("ok")]
    rejected: dict[str, int] = {}
    failures = []
    for _, _, lat, s, r in results:
        if s == 200 and r.get("ok"):
            continue
        reason = r.get("rejected")
        if reason and reason != "timeout":
            rejected[reason] = rejected.get(reason, 0) + 1
        else:
            # No typed reason — or "timeout", the client giving up on an
            # unresponsive service, which is a failure, not load shedding.
            failures.append({"status": s,
                             "detail": r.get("detail", "") or reason or ""})
    channels = 3 if args.mode == "rgb" else 1
    # Per-profile pixel areas: mixed-size runs account each completion
    # at ITS profile's size (selection is deterministic by index).
    # Volume bodies account CELLS (2 fields x D x H x W) and their
    # responses carry f32 (4 bytes/cell), not u8.
    if vol_shape is not None:
        channels = 2 * vol_shape[0]
        elem_bytes = 4
    else:
        elem_bytes = 1
    area_of = [b["rows"] * b["cols"] for b, _ in profiles]
    ok_rows = [(i, r) for i, _, _, s, r in results
               if s == 200 and r.get("ok")]
    mismatches = 0
    if wants is not None:
        for i, r in ok_rows:
            if base64.b64decode(r["image_b64"]) != wants[pick(i)]:
                mismatches += 1
    bad_bytes = sum(
        1 for i, r in ok_rows
        if len(base64.b64decode(r["image_b64"]))
        != area_of[pick(i)] * channels * elem_bytes)
    non_rejected_failures = len(failures) + mismatches + bad_bytes

    lats = sorted(lat for lat, _ in completed)
    if args.converge is not None:
        # Convergence jobs: pixels iterated = the solver-comparable
        # fine-grid work units each final row stamps (iterations for
        # jacobi, the pixel-weighted per-level sum for multigrid).
        px = int(channels * sum(
            area_of[pick(i)] * r.get("work_units", 0.0)
            for i, r in ok_rows))
    else:
        px = channels * args.iters * sum(
            area_of[pick(i)] for i, _ in ok_rows)
    phase_names = ("queue", "compile", "device", "copy_in", "copy_out")
    phases_ms = {
        p: round(1e3 * statistics.mean(
            [r.get("phases", {}).get(p, 0.0) for _, r in completed]), 3)
        for p in phase_names
    } if completed and args.converge is None else {}
    effective = sorted({r.get("effective_backend", "") for _, r in completed})
    grids = sorted({r.get("effective_grid", "") for _, r in completed})
    batch_sizes = [r.get("batch_size", 1) for _, r in completed]
    plan_keys = sorted({r.get("plan_key", "") for _, r in completed} - {""})
    # Router-stamped responses make failovers CLIENT-observable: count
    # requests that completed OFF their consistent-hash home (spilled
    # past a dead/unready replica) or after a failed dispatch.
    failovers_observed = sum(
        1 for _, r in completed
        if r.get("router", {}).get("failovers", 0) > 0
        or (r.get("router", {}).get("replica")
            and r.get("router", {}).get("home")
            and r["router"]["replica"] != r["router"]["home"]))
    replicas_seen = sorted({r.get("router", {}).get("replica", "")
                            for _, r in completed} - {""})
    # The router stamps its durability mode on every
    # response.  Completions served while the WAL was in its degraded
    # window are still correct answers — but the client can now COUNT
    # how many of its requests rode on reduced durability, so a smoke
    # can assert both "kept serving" and "window actually closed".
    degraded_served = sum(
        1 for _, r in completed
        if r.get("router", {}).get("durability") == "degraded")
    # Which control-plane shards served this client's keys.
    shards_seen = sorted({r.get("router", {}).get("shard", "")
                          for _, r in completed} - {""})
    # The router stamps its fencing epoch on every response;
    # an epoch CHANGE mid-run means the control plane restarted (or a
    # standby took over) underneath this client — and the run kept
    # completing anyway.  distinct-epochs-minus-one is the restart
    # count this client can prove.
    epochs_seen = sorted({r.get("router", {}).get("epoch")
                          for _, r in completed} - {None, 0})

    # Which codec arm(s) the SERVER says actually answered — the
    # client-observable proof the negotiated wire was honored.
    wires_seen = sorted({r.get("wire", "") for _, r in completed} - {""})
    row = {
        "workload": (f"serve {args.filter_name} "
                     + (f"volume {args.volume}" if vol_shape is not None
                        else f"{args.rows}x{args.cols}"
                        + ("+1920x2520" if args.mixed_sizes else "")
                        + f"x{channels}")
                     + " "
                     + (f"converge tol={args.converge}"
                        if args.converge is not None
                        else f"{args.iters} iters")
                     + (f" zipf={args.zipf}" if args.zipf is not None
                        else "")),
        **({"rank": 3} if vol_shape is not None else {}),
        "wire": args.wire,
        **({"wires_seen": wires_seen} if wires_seen else {}),
        "loop": ("open-poisson" if args.rps
                 else ("open" if args.rate else "closed")),
        "n": n_issued,
        **({"offered_rps": args.rps,
            # The arrival process actually realized (scheduling jitter
            # can under-deliver on a loaded host) vs the completion
            # throughput the service sustained — the load-curve row
            # states all three, so "the server kept up" is checkable.
            "issued_rps": (round(n_issued / wall, 3) if wall else None),
            "achieved_rps": (round(len(completed) / wall, 3)
                             if wall else None),
            **({"duration_s": args.duration_s}
               if args.duration_s else {})}
           if args.rps
           else ({"rate_rps": args.rate} if args.rate
                 else {"concurrency": args.concurrency})),
        "backend": args.backend,
        "effective_backend": (effective[0] if len(effective) == 1
                              else effective),
        "effective_grid": grids[0] if len(grids) == 1 else grids,
        # The tuning identity of the served config (perf_gate.py's
        # history key; a list only if mixed keys were somehow served).
        "plan_key": (plan_keys[0] if len(plan_keys) == 1
                     else (plan_keys or "")),
        "completed": len(completed),
        "rejected": rejected,
        "rejected_retried": retried[0],
        "failovers_observed": failovers_observed,
        **({"degraded_served": degraded_served}
           if degraded_served else {}),
        **({"replicas_seen": replicas_seen} if replicas_seen else {}),
        **({"shards_seen": shards_seen} if shards_seen else {}),
        **({"shardmap_refreshes": sharded.refreshes}
           if args.shardmap else {}),
        **({"router_restarts_observed": len(epochs_seen) - 1,
            "router_epochs_seen": epochs_seen} if epochs_seen else {}),
        "non_rejected_failures": non_rejected_failures,
        "wall_s": round(wall, 4),
        "p50_ms": round(1e3 * _percentile(lats, 0.50), 3) if lats else None,
        "p95_ms": round(1e3 * _percentile(lats, 0.95), 3) if lats else None,
        "p99_ms": round(1e3 * _percentile(lats, 0.99), 3) if lats else None,
        "gpixels_per_s": round(px / wall / 1e9, 6) if wall else None,
        "phases_ms": phases_ms,
        "batch_mean": (round(statistics.mean(batch_sizes), 2)
                       if batch_sizes else None),
        "batch_max": max(batch_sizes, default=None),
    }
    # Result-cache accounting (every served body stamps cache: hit|miss
    # when the server runs cached; the hit-rate-vs-skew curve and the
    # perf_gate cache lane read these).
    cache_stamps = {r.get("cache", "") for _, r in completed} - {"", "off"}
    if cache_stamps or args.zipf is not None:
        hits = sum(1 for _, r in completed if r.get("cache") == "hit")
        row["cache_hits"] = hits
        row["cache_misses"] = sum(1 for _, r in completed
                                  if r.get("cache") == "miss")
        row["cache_hit_rate"] = (round(hits / len(completed), 4)
                                 if completed else None)
    if args.zipf is not None:
        row["zipf_s"] = args.zipf
        row["pool"] = len(profiles)
    if args.converge is not None:
        # Solver-shaped convergence accounting, stamped from the
        # final rows the SERVER streamed (post-resolution — mg_levels is
        # the planner's actual schedule, work_units the solver's own
        # bill), never from the request knobs.
        solvers = sorted({r.get("solver", "") for _, r in completed} - {""})
        levels = sorted({r.get("mg_levels") for _, r in completed}
                        - {None})
        wus = sorted(r.get("work_units", 0.0) for _, r in completed)
        # Always a scalar string: perf_gate.row_key interpolates this
        # into the history identity, and a list repr would mint a key no
        # future run ever matches.  A genuinely mixed run gets a stable
        # "a+b" key distinct from either solver's own history.
        row["solver"] = (solvers[0] if len(solvers) == 1
                         else ("+".join(solvers) if solvers
                               else args.solver))
        row["mg_levels"] = (levels[0] if len(levels) == 1
                            else (levels or None))
        row["work_units_to_tol"] = _percentile(wus, 0.50)
        row["tol"] = args.converge
        row["converged"] = sum(1 for _, r in completed
                               if r.get("converged"))
        row["rows_streamed_mean"] = (round(statistics.mean(
            [r.get("rows_streamed", 0) for _, r in completed]), 1)
            if completed else None)
        # Durable-job visibility: final rows whose router
        # stamp says the job resumed on a surviving replica mid-stream
        # — the client-observable proof that device-seconds already
        # spent were NOT re-run from iteration 0.
        row["resumes_observed"] = sum(
            1 for _, r in completed
            if r.get("router", {}).get("resume_count", 0) > 0)
    if wants is not None:
        row["oracle_mismatches"] = mismatches
    try:
        snap = transport_snapshot()
        row["platform"] = snap.get("platform", "")
        row["mesh"] = snap.get("mesh", "")
        row["engine"] = snap.get("engine", {})
        row["service"] = snap.get("service", {})
        # Topology identity: the SERVER's hosts/slice layout when it
        # reports one, else this process's own.
        row["hosts"] = snap.get("hosts")
        row["slice_topology"] = snap.get("slice_topology")
    except Exception as e:  # noqa: BLE001 — the row survives a dead /stats
        row["snapshot_error"] = repr(e)[:200]
    if not row.get("hosts"):
        from parallel_convolution_tpu_torch.utils.platform import topology

        row.update(topology(service.engine.grid if service is not None
                            else None))
    if failures:
        row["failure_sample"] = failures[:3]

    print(json.dumps(row), flush=True)
    if args.out:
        from pathlib import Path

        p = Path(args.out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(  # diskio: exempt — own result row, not drilled
            json.dumps(row, indent=2))
    if service is not None:
        service.close()
    return 1 if non_rejected_failures else 0


if __name__ == "__main__":
    sys.exit(main())
