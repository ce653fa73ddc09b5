"""Transports for the convolution service: in-process and HTTP (the
port's ``serving/frontend.py``: the JAX package's two wires, routes,
status codes and headers over the port's service).

One wire format, two transports:

* :class:`InProcessClient` — dict-in/dict-out against a local
  :class:`ConvolutionService`: the full request/response codec with no
  sockets.
* :func:`make_http_server` — a stdlib-only ``ThreadingHTTPServer``
  speaking the same bodies (``python -m
  parallel_convolution_tpu_torch.serving.serve`` boots one).

Wire format (POST ``/v1/convolve``)::

    {"image_b64": <base64 raw u8 bytes>, "rows": H, "cols": W,
     "mode": "grey"|"rgb", "filter": "blur3", "iters": 1,
     "backend": "shifted", "storage": "f32", "fuse": 1,
     "boundary": "zero", "quantize": true, "deadline_ms": 500}

    200 -> {"ok": true, "image_b64": ..., "effective_backend": ...,
            "effective_grid": "RxC", "backend": ..., "request_id": ...,
            "batch_size": ...,
            "phases": {"queue": s, "compile": s, "device": s,
                       "copy_in": s, "copy_out": s, "total": s}}
    400 -> {"ok": false, "rejected": "invalid",    "detail": ...}
    429 -> {"ok": false,
            "rejected": "queue_full"|"deadline"|"error"|"resharding", ...}

``GET /healthz`` returns ``{"ok": true}`` plus the service snapshot
(liveness: the process is up and can report state); ``GET /readyz``
returns the READINESS verdict — 200 only when the service can usefully
take a new request (503 while a mesh reshape is in progress or the
admission queue is at its bound; the current degrade tier rides in the
payload) — the probe surface a replica router keys on.
``GET /stats`` returns the snapshot alone; ``POST /v1/warm``
(``{"configs": [...]}``) pre-compiles declared configs — the
warm-placement surface a joining replica is driven through before its
ring vnodes take traffic; ``GET /metrics`` serves the
process-global obs registry in Prometheus text exposition format 0.0.4
(``obs.metrics.render_text``; with ``PCTPU_OBS=0``
it serves a comment noting obs is disabled, still a valid exposition).
Rejections map to HTTP 429 (load shed — retryable by the client) except
contract errors (400).

Tracing: each request runs under a ``request`` root span
(obs.trace) and every response body carries its ``trace_id``.  Context
propagates IN via the W3C-style ``traceparent`` — an HTTP header on the
POST, or an explicit ``"traceparent"`` body field on the in-process
client — so an upstream caller's trace adopts the serving spans instead
of starting a fresh tree.
"""

from __future__ import annotations

import base64
import json
import struct
import time

import numpy as np

from parallel_convolution_tpu_torch.obs import (
    metrics as obs_metrics, trace as obs_trace,
)
from parallel_convolution_tpu_torch.serving import frames as frames_mod
from parallel_convolution_tpu_torch.serving.service import (
    RETRYABLE_REJECTS, ConvolutionService, Rejected, Request, Response,
    Snapshot,
)

__all__ = ["InProcessClient", "decode_converge", "decode_request",
           "drain_body", "encode_response", "encode_response_frames",
           "encode_stream_row", "encode_stream_row_frames",
           "iter_framed_rows", "make_http_server", "metrics_text",
           "retry_after_header", "send_frames", "send_frames_stream",
           "send_json", "send_ndjson_stream"]

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
NDJSON_CONTENT_TYPE = "application/x-ndjson"

# Framed streaming (the binary twin of NDJSON): each row is one
# length-prefixed envelope — u32 LE byte count, then the envelope —
# flushed per row, so progressive delivery latency matches the NDJSON
# arm (a row is actionable the moment its bytes land).
_ROW_PREFIX = struct.Struct("<I")


def _codec_obs(codec: str, op: str, dt: float, nbytes: int) -> None:
    """Per-wire codec accounting: how much wall time and how many bytes
    each wire arm's encode/decode costs.  The JSON arm's decode (the
    body's parse and its base64) is counted as well as the frames arm's,
    so a request's server-side codec time splits per wire."""
    if not obs_metrics.enabled():
        return
    obs_metrics.counter(
        "pctpu_codec_seconds_total",
        "wall seconds spent encoding/decoding wire payloads",
        ("codec", "op")).inc(dt, codec=codec, op=op)
    obs_metrics.counter(
        "pctpu_codec_bytes_total",
        "payload bytes through each wire codec",
        ("codec", "op")).inc(nbytes, codec=codec, op=op)


def metrics_text() -> str:
    """The /metrics body: one renderer for both transports."""
    if not obs_metrics.enabled():
        return "# PCTPU_OBS disabled\n"
    return obs_metrics.render_text()

# Typed rejection -> HTTP status.  The split encodes "back off" vs "give
# up": retryable sheds (RETRYABLE_REJECTS) are 429 (too many requests:
# queue_full, tenant_quota) or 503 (service transiently unable:
# resharding, replica_unavailable) and carry a Retry-After header;
# contract errors are 400 and terminal execution failures 500 — retrying
# those verbatim cannot succeed.  ``deadline`` stays 429 (the queue was
# too deep for the request's own budget) but is NOT flagged retryable:
# the body's ``retryable`` field, not the status code, is the contract.
_REJECT_STATUS = {"invalid": 400, "queue_full": 429, "deadline": 429,
                  "error": 500, "resharding": 503, "timeout": 504,
                  "tenant_quota": 429, "replica_unavailable": 503,
                  # Epoch fencing: the request came from a
                  # ZOMBIE router (an epoch older than the fence a
                  # takeover ratcheted).  409 Conflict, retryable:false
                  # — the zombie must stand down, not back off.
                  "stale_epoch": 409,
                  # Sharded control plane: the request's route
                  # key hashes to a shard this router does not own.  421
                  # Misdirected Request, retryable:true — the client
                  # refreshes its shard map and retries at the owner.
                  "wrong_shard": 421,
                  # A malformed binary envelope/frame (truncation, CRC
                  # mismatch, unknown dtype code): a contract error, the
                  # binary twin of bad-JSON 400.
                  "bad_frame": 400}


def _stale_epoch_wire(body: dict, fence: int, trace_id: str) -> dict:
    """The typed non-retryable rejection a fenced-out request gets."""
    shard = body.get("router_shard")
    where = (f"shard {shard!r}" if shard
             else "this replica set")
    wire = {
        "ok": False, "rejected": "stale_epoch", "retryable": False,
        "request_id": body.get("request_id") or "",
        "fence_epoch": fence, "trace_id": trace_id,
        "detail": f"router epoch {body.get('router_epoch')!r} is stale "
                  f"(fence at {fence}): a newer router has taken over "
                  f"{where}",
    }
    if shard is not None:
        wire["shard"] = str(shard)
    return wire


def retry_after_header(wire: dict) -> str | None:
    """The Retry-After header value for a rejection body (None = no
    header).  HTTP wants integer seconds, so sub-second hints round UP —
    the precise float rides the body's ``retry_after_s`` for clients
    that can do better."""
    if not wire.get("retryable") or wire.get("retry_after_s") is None:
        return None
    import math

    return str(max(1, math.ceil(float(wire["retry_after_s"]))))


def decode_request(body: dict) -> Request:
    """Wire dict → :class:`Request` (raises ValueError on malformed).

    EVERY coercion sits inside the try: a null/listy ``iters`` or
    ``deadline_ms`` raises TypeError, which must surface as the typed
    400, not as an unhandled handler-thread exception (DESIGN.md
    invariant 3: contract violations are typed, decided before enqueue).
    """
    try:
        rows, cols = int(body["rows"]), int(body["cols"])
        mode = body.get("mode", "grey")
        if rows < 1 or cols < 1:
            raise ValueError(f"bad image extent {rows}x{cols}")
        if mode == "volume":
            return _decode_volume_request(body, rows, cols)
        want = (rows, cols, 3) if mode == "rgb" else (rows, cols)
        framed = body.get("_frames") or {}
        if "image" in framed:
            # Binary wire arm: the image arrived as a tensor frame — a
            # zero-copy view over the request buffer (no base64, no
            # bytes copy in the codec).  Geometry/dtype checks mirror
            # the JSON arm exactly so the two wires reject identically.
            img = framed["image"]
            if img.dtype != np.uint8:
                raise ValueError(
                    f"image frame must be uint8, got {img.dtype}")
            if img.shape != want:
                raise ValueError(
                    f"image frame is {img.shape}, expected {want} for "
                    f"{rows}x{cols} {mode}")
        else:
            raw = base64.b64decode(body["image_b64"])
            channels = 3 if mode == "rgb" else 1
            if len(raw) != rows * cols * channels:
                raise ValueError(
                    f"image_b64 carries {len(raw)} bytes, expected "
                    f"{rows * cols * channels} for {rows}x{cols} {mode}")
            img = np.frombuffer(raw, np.uint8).reshape(want)
        deadline_ms = body.get("deadline_ms")
        return Request(
            image=img,
            filter_name=body.get("filter", "blur3"),
            iters=int(body.get("iters", 1)),
            backend=body.get("backend", "shifted"),
            storage=body.get("storage", "f32"),
            # fuse: null means 'tune it' (backend="auto"); absent means 1.
            fuse=(None if body.get("fuse", 1) is None
                  else int(body.get("fuse", 1))),
            boundary=body.get("boundary", "zero"),
            quantize=bool(body.get("quantize", True)),
            # overlap: null/absent = off for explicit backends, tuned
            # for backend="auto"; true/false = clamped request.
            overlap=(None if body.get("overlap") is None
                     else bool(body.get("overlap"))),
            # col_mode: null/absent = auto (cost-model pick on the RDMA
            # tier, canonical 'packed' elsewhere); packed/strided =
            # honored where the transport exists.
            col_mode=(None if body.get("col_mode") is None
                      else str(body.get("col_mode"))),
            deadline_s=(float(deadline_ms) / 1e3
                        if deadline_ms is not None else None),
            request_id=body.get("request_id"),
            tenant=str(body.get("tenant") or ""),
            # solver: convergence strategy (converge jobs; the batch path
            # sheds non-jacobi as invalid server-side).
            solver=str(body.get("solver") or "jacobi"),
            mg_levels=(None if body.get("mg_levels") is None
                       else int(body["mg_levels"])),
        )
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed request body: {e}") from e


def _decode_volume_request(body: dict, rows: int, cols: int) -> Request:
    """The rank-3 arm of :func:`decode_request` (``mode: "volume"``):
    the body carries ``depth`` plus a (2, D, H, W) float32 volume — as
    a ``volume`` tensor frame on the binary wire (the envelope's
    4-dim f32 frames carry it untouched) or ``volume_b64`` raw f32
    bytes on JSON.  Raises the same typed ValueError family as the
    rank-2 arm; the caller's except wraps it."""
    from parallel_convolution_tpu_torch.utils.config import VOLUME_FIELDS

    depth = int(body["depth"])
    if depth < 1:
        raise ValueError(f"bad volume depth {depth}")
    want = (VOLUME_FIELDS, depth, rows, cols)
    framed = body.get("_frames") or {}
    if "volume" in framed:
        vol = framed["volume"]
        if vol.dtype != np.float32:
            raise ValueError(
                f"volume frame must be float32, got {vol.dtype}")
        if vol.shape != want:
            raise ValueError(
                f"volume frame is {vol.shape}, expected {want} for "
                f"depth={depth} {rows}x{cols}")
    else:
        raw = base64.b64decode(body["volume_b64"])
        n = int(np.prod(want)) * 4
        if len(raw) != n:
            raise ValueError(
                f"volume_b64 carries {len(raw)} bytes, expected {n} "
                f"for f32 {want}")
        vol = np.frombuffer(raw, np.float32).reshape(want)
    deadline_ms = body.get("deadline_ms")
    return Request(
        volume=vol,
        filter_name=body.get("filter", "fd7"),
        iters=int(body.get("iters", 1)),
        backend=body.get("backend", "shifted"),
        storage="f32",
        fuse=(None if body.get("fuse", 1) is None
              else int(body.get("fuse", 1))),
        boundary=body.get("boundary", "zero"),
        quantize=False,
        overlap=(None if body.get("overlap") is None
                 else bool(body.get("overlap"))),
        col_mode=(None if body.get("col_mode") is None
                  else str(body.get("col_mode"))),
        deadline_s=(float(deadline_ms) / 1e3
                    if deadline_ms is not None else None),
        request_id=body.get("request_id"),
        tenant=str(body.get("tenant") or ""),
        solver=str(body.get("solver") or "jacobi"),
    )


def _response_parts(result) -> tuple[int, dict, dict]:
    """:class:`Response`/:class:`Rejected` → (status, control header,
    tensor fields) — the wire-agnostic split both encoders share, so the
    JSON and frames arms cannot drift on anything but tensor carriage."""
    if isinstance(result, Rejected):
        wire = {
            "ok": False, "rejected": result.reason,
            "retryable": result.reason in RETRYABLE_REJECTS,
            "request_id": result.request_id, "detail": result.detail,
            "trace_id": result.trace_id,
        }
        if wire["retryable"] and result.retry_after_s is not None:
            wire["retry_after_s"] = round(float(result.retry_after_s), 4)
        return _REJECT_STATUS.get(result.reason, 429), wire, {}
    assert isinstance(result, Response)
    return 200, {
        "ok": True,
        "effective_backend": result.effective_backend,
        "effective_grid": result.effective_grid,
        "backend": result.backend,
        "plan_source": result.plan_source,
        "plan_key": result.plan_key,
        "predicted_gpx_per_chip": result.predicted_gpx_per_chip,
        "overlap": result.overlap,
        "col_mode": result.col_mode,
        "exchange_fraction": result.exchange_fraction,
        "exchange_hidden_fraction": result.exchange_hidden_fraction,
        "request_id": result.request_id,
        "batch_size": result.batch_size,
        "phases": result.phases,
        "trace_id": result.trace_id,
        # Content-addressed result cache verdict (hit|miss|off) + the
        # input digest — every wire body carries them, so client rows,
        # the router's hit-refund settlement, and the smoke's gates
        # all read the same stamp.
        "cache": result.cache,
        "digest": result.digest,
    }, {"image": result.image}


def encode_response(result) -> tuple[int, dict]:
    """:class:`Response`/:class:`Rejected` → (http_status, wire dict)."""
    status, wire, tensors = _response_parts(result)
    wire["wire"] = "json"
    if "image" in tensors:
        t0 = time.perf_counter()
        wire["image_b64"] = base64.b64encode(
            np.ascontiguousarray(tensors["image"]).tobytes()).decode("ascii")
        _codec_obs("json", "encode", time.perf_counter() - t0,
                   tensors["image"].nbytes)
    return status, wire


def encode_response_frames(result) -> tuple[int, bytes]:
    """The binary twin of :func:`encode_response`: (http_status,
    envelope bytes).  Control fields ride the envelope's JSON header
    (``wire: "frames"`` stamped; retry hints included — framed clients
    read the header, not HTTP headers); the image rides as a tensor
    frame.  Rejections are header-only envelopes."""
    status, wire, tensors = _response_parts(result)
    wire["wire"] = "frames"
    t0 = time.perf_counter()
    data = frames_mod.encode_envelope(wire, tensors)
    _codec_obs("frames", "encode", time.perf_counter() - t0,
               sum(a.nbytes for a in tensors.values()))
    return status, data


def decode_converge(body: dict) -> tuple[Request, dict]:
    """Wire dict → (:class:`Request`, converge params) for
    ``POST /v1/converge`` (raises ValueError on malformed).

    Same body as ``/v1/convolve`` minus ``iters``/``deadline_ms`` plus
    ``tol`` / ``max_iters`` / ``check_every``; ``quantize`` defaults to
    FALSE here (convergence runs float carries — the u8 store-back
    semantics would clamp the diff trajectory).

    Durable jobs: ``resume_state: true`` asks every snapshot
    row to carry its own resume token (``state_b64``/``state_shape`` —
    the exact f32 carries, since the u8 image is lossy), and ``resume``
    (a token dict: iters / diff / work_units / state_b64 / state_shape)
    seeds the stream from that token instead of iteration 0 — the
    mid-stream failover surface ``router.converge`` drives."""
    try:
        params = {"tol": float(body.get("tol", 1e-3)),
                  "max_iters": int(body.get("max_iters", 500)),
                  "check_every": int(body.get("check_every", 10)),
                  "carry_state": bool(body.get("resume_state", False))}
        token = body.get("resume")
        if token is not None:
            from parallel_convolution_tpu_torch.serving import jobs

            if not isinstance(token, dict):
                raise ValueError("resume must be a token object")
            framed_state = (body.get("_frames") or {}).get("resume_state")
            if framed_state is not None:
                # state_b64's framed twin: the f32 carries arrive as a
                # tensor frame; same shape/dtype contract, no base64.
                state = np.asarray(framed_state)
                if state.ndim not in (3, 4) or state.dtype != np.float32:
                    raise ValueError(
                        f"resume_state frame must be float32 (C, H, W) "
                        f"or rank-3 (F, D, H, W), got {state.dtype} "
                        f"{state.shape}")
                state = np.ascontiguousarray(state)
            else:
                state = jobs.state_from_wire(
                    token.get("state_b64") or "",
                    token.get("state_shape") or ())
            params["resume"] = {
                "iters": int(token.get("iters", 0)),
                "diff": float(token.get("diff", float("inf"))),
                "work_units": float(token.get("work_units", 0.0)),
                "state": state,
            }
    except (TypeError, ValueError) as e:
        raise ValueError(f"malformed request body: {e}") from e
    b = dict(body)
    b.setdefault("quantize", False)
    b.pop("deadline_ms", None)   # chunk streaming IS the deadline story
    b["iters"] = 1               # keying uses check_every (service-side)
    return decode_request(b), params


def _stream_row_parts(row) -> tuple[dict, dict]:
    """Stream row → (control header, tensor fields): the shared split
    behind the NDJSON and framed stream encoders."""
    if isinstance(row, Rejected):
        _, wire, _ = _response_parts(row)
        wire["kind"] = "rejected"
        return wire, {}
    assert isinstance(row, Snapshot)
    out = {
        "kind": "final" if row.final else "snapshot",
        "ok": True,
        "iters": row.iters,
        "diff": round(float(row.diff), 8),
        "converged": row.converged,
        # Solver-shaped accounting: which convergence
        # strategy produced the row (iters counts V-cycles for
        # multigrid, diff is then the fine-grid residual norm) and the
        # solver-comparable fine-grid work spent so far.
        "solver": row.solver,
        "work_units": round(float(row.work_units), 3),
        "mg_levels": row.mg_levels,
        "col_mode": row.col_mode,
        "request_id": row.request_id,
        "effective_backend": row.effective_backend,
        "effective_grid": row.effective_grid,
        "plan_key": row.plan_key,
        "trace_id": row.trace_id,
        "cache": row.cache,
        "digest": row.digest,
    }
    tensors = {"image": row.image}
    if row.state is not None:
        # The resume-token payload: exact f32 carries, only
        # when the job asked for durability (resume_state on the wire).
        tensors["state"] = row.state
    return out, tensors


def encode_stream_row(row) -> dict:
    """:class:`Snapshot`/:class:`Rejected` → one NDJSON stream line."""
    out, tensors = _stream_row_parts(row)
    out["wire"] = "json"
    if "image" in tensors:
        t0 = time.perf_counter()
        # Geometry rides the row so an edge re-framing the stream into
        # tensor frames (the router's framed converge) needs no
        # request-side context.
        out["image_shape"] = list(tensors["image"].shape)
        out["image_b64"] = base64.b64encode(
            np.ascontiguousarray(tensors["image"]).tobytes()).decode("ascii")
        if "state" in tensors:
            from parallel_convolution_tpu_torch.serving import jobs

            out["state_b64"], out["state_shape"] = jobs.state_to_wire(
                tensors["state"])
        _codec_obs("json", "encode", time.perf_counter() - t0,
                   sum(a.nbytes for a in tensors.values()))
    return out


def encode_stream_row_frames(row) -> bytes:
    """The binary twin of :func:`encode_stream_row`: one envelope per
    stream row.  The image rides as a u8 frame; when the job asked for
    durability, ``state_b64``'s framed twin ``state`` rides as an f32
    frame (``state_shape`` is the frame's own shape header)."""
    out, tensors = _stream_row_parts(row)
    out["wire"] = "frames"
    t0 = time.perf_counter()
    data = frames_mod.encode_envelope(out, tensors)
    _codec_obs("frames", "encode", time.perf_counter() - t0,
               sum(a.nbytes for a in tensors.values()))
    return data


def drain_body(handler) -> None:
    """Consume an unread POST body on a ``BaseHTTPRequestHandler``.

    Under HTTP/1.1 keep-alive (which /v1/converge's chunked streaming
    requires) a response sent with the request body still unread leaves
    those bytes in the socket — the server would parse them as the next
    request line.  Shared by the replica and router frontends."""
    try:
        n = int(handler.headers.get("Content-Length", "0") or 0)
    except ValueError:
        n = 0
    while n > 0:
        chunk = handler.rfile.read(min(n, 65536))
        if not chunk:
            break
        n -= len(chunk)


def send_json(handler, status: int, payload: dict) -> None:
    """One JSON response on a ``BaseHTTPRequestHandler``: Content-Length
    framing plus the Retry-After header for retryable rejection bodies.
    Shared by the replica frontend and the router frontend so the two
    cannot drift ("a client cannot tell a router from a replica")."""
    data = json.dumps(payload).encode()
    handler.send_response(status)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(data)))
    ra = retry_after_header(payload)
    if ra is not None:
        handler.send_header("Retry-After", ra)
    handler.end_headers()
    handler.wfile.write(data)


def send_ndjson_stream(handler, rows) -> None:
    """Chunked NDJSON on a ``BaseHTTPRequestHandler``: one line per
    stream row, flushed as produced — the progressive-results
    transport.  The terminal chunk is best-effort: a client that
    disconnected mid-stream must not raise again out of the finally."""
    handler.send_response(200)
    handler.send_header("Content-Type", NDJSON_CONTENT_TYPE)
    handler.send_header("Transfer-Encoding", "chunked")
    handler.end_headers()
    try:
        for row in rows:
            data = (json.dumps(row) + "\n").encode()
            handler.wfile.write(b"%x\r\n" % len(data))
            handler.wfile.write(data + b"\r\n")
            handler.wfile.flush()
    finally:
        try:
            handler.wfile.write(b"0\r\n\r\n")
        except OSError:
            pass


def send_frames(handler, status: int, data: bytes) -> None:
    """One framed response body (Content-Length framing).  No
    Retry-After header: framed clients read retry hints from the
    envelope header JSON, which always carries them."""
    handler.send_response(status)
    handler.send_header("Content-Type", frames_mod.FRAMES_CONTENT_TYPE)
    handler.send_header("Content-Length", str(len(data)))
    handler.end_headers()
    handler.wfile.write(data)


def send_frames_stream(handler, rows) -> None:
    """Chunked framed streaming: one length-prefixed envelope per row,
    FLUSHED per row exactly like the NDJSON arm — progressive delivery
    latency is a property of the stream, not of the negotiated wire
    (a buffered framed stream would un-ship the progressive story for
    binary clients).  ``rows`` yields envelope ``bytes``."""
    handler.send_response(200)
    handler.send_header("Content-Type", frames_mod.FRAMES_CONTENT_TYPE)
    handler.send_header("Transfer-Encoding", "chunked")
    handler.end_headers()
    try:
        for data in rows:
            line = _ROW_PREFIX.pack(len(data)) + data
            handler.wfile.write(b"%x\r\n" % len(line))
            handler.wfile.write(line + b"\r\n")
            handler.wfile.flush()
    finally:
        try:
            handler.wfile.write(b"0\r\n\r\n")
        except OSError:
            pass


def iter_framed_rows(stream) -> "object":
    """Parse a framed row stream (client side): yields envelope bytes
    per length-prefixed row from a file-like ``stream``.  Raises
    :class:`frames.BadFrame` on a truncated prefix/row."""
    while True:
        prefix = stream.read(_ROW_PREFIX.size)
        if not prefix:
            return
        if len(prefix) < _ROW_PREFIX.size:
            raise frames_mod.BadFrame("truncated stream row prefix")
        (n,) = _ROW_PREFIX.unpack(prefix)
        data = b""
        while len(data) < n:
            chunk = stream.read(n - len(data))
            if not chunk:
                raise frames_mod.BadFrame(
                    f"truncated stream row: {len(data)}/{n} bytes")
            data += chunk
        yield data


class InProcessClient:
    """The socket-free transport: same codec, direct service calls."""

    def __init__(self, service: ConvolutionService):
        self.service = service

    def request(self, body: dict, timeout: float | None = None,
                traceparent: str | None = None,
                transport: str = "in_process",
                wire: str = "json") -> tuple[int, dict]:
        """One wire-format request → (status, wire-format response).

        The request runs under a ``request`` root span; ``traceparent``
        (the explicit argument, or a ``"traceparent"`` body field) makes
        it a CHILD of the caller's span instead — the in-process twin of
        the HTTP header.  Every response dict carries ``trace_id``
        ("" with obs disabled).  ``transport`` labels the root span —
        the HTTP handler delegates here and passes ``"http"``.

        ``wire`` is the NEGOTIATED response encoding: ``"json"``
        returns a dict; ``"frames"`` returns envelope ``bytes``
        (:func:`request_frames` is the full binary round trip).  A body
        carrying decoded tensor frames (``_frames``) is accepted either
        way — request and response wires negotiate independently in
        principle, though the transports pair them.
        """
        tp = traceparent if traceparent is not None else body.get(
            "traceparent")
        pctx = obs_trace.parse_traceparent(tp)
        with obs_trace.span(
                "request", parent=pctx, transport=transport, wire=wire,
                request_id=str(body.get("request_id") or ""),
                # The parent span (if any) lives in the CALLER's process:
                # reconstruction must treat this span as a local root, not
                # an orphan, when the parent is absent from the log.
                **({"remote_parent": True} if pctx is not None
                   else {})) as sp:
            tid = sp.context.trace_id if sp.context is not None else ""
            admit, fence = self.service.epoch_gate(
                body.get("router_epoch"), shard=body.get("router_shard"))
            if not admit:
                sp.set(outcome="stale_epoch")
                stale = _stale_epoch_wire(body, fence, tid)
                if wire == "frames":
                    return 409, frames_mod.encode_envelope(stale, {})
                return 409, stale
            try:
                t0 = time.perf_counter()
                req = decode_request(body)
                if "_frames" not in body:
                    # The JSON arm's base64 decode (the frames arm's is
                    # counted in request_frames).
                    _codec_obs("json", "decode", time.perf_counter() - t0,
                               (req.image if req.image is not None
                                else req.volume).nbytes)
            except ValueError as e:
                sp.set(outcome="invalid")
                bad = {"ok": False, "rejected": "invalid",
                       "request_id": body.get("request_id") or "",
                       "detail": str(e), "trace_id": tid}
                if wire == "frames":
                    return 400, frames_mod.encode_envelope(bad, {})
                return 400, bad
            result = self.service.submit(req, timeout=timeout)
            if wire == "frames":
                status, data = encode_response_frames(result)
                sp.set(status=status)
                return status, data
            status, wired = encode_response(result)
            if not wired.get("trace_id"):
                wired["trace_id"] = tid
            sp.set(status=status)
            return status, wired

    def request_frames(self, raw, timeout: float | None = None,
                       traceparent: str | None = None,
                       transport: str = "in_process",
                       tenant: str | None = None) -> tuple[int, bytes]:
        """The full binary round trip: envelope bytes in, envelope bytes
        out.  A malformed envelope is the typed ``bad_frame`` 400 —
        returned as a header-only envelope, so a frames client never has
        to switch codecs to read its own rejection."""
        t0 = time.perf_counter()
        try:
            header, arrays = frames_mod.decode_envelope(raw)
        except frames_mod.BadFrame as e:
            status, data = encode_response_frames(
                Rejected("bad_frame", "", detail=str(e)))
            return status, data
        _codec_obs("frames", "decode", time.perf_counter() - t0,
                   sum(a.nbytes for a in arrays.values()))
        header["_frames"] = arrays
        if tenant:
            header["tenant"] = tenant
        return self.request(header, timeout=timeout,
                            traceparent=traceparent, transport=transport,
                            wire="frames")

    def converge(self, body: dict, timeout: float | None = None,
                 traceparent: str | None = None,
                 transport: str = "in_process", wire: str = "json"):
        """One progressive convergence request → (status, row iterator).

        An immediate rejection returns its status with a one-row
        iterator; an admitted job returns ``(200, rows)`` where ``rows``
        yields NDJSON-shaped dicts (``kind: snapshot`` per chunk, then
        ``kind: final`` — or ``kind: rejected`` if the job died
        mid-stream, after the best-so-far rows).  The HTTP transport
        streams exactly these lines chunked.  With ``wire="frames"``
        every row (rejections included) is envelope ``bytes`` instead.
        """
        tp = traceparent if traceparent is not None else body.get(
            "traceparent")
        pctx = obs_trace.parse_traceparent(tp)

        def row_out(d: dict):
            d["wire"] = wire
            return (frames_mod.encode_envelope(d, {})
                    if wire == "frames" else d)

        with obs_trace.span(
                "request", parent=pctx, transport=transport, wire=wire,
                progressive=True,
                request_id=str(body.get("request_id") or ""),
                **({"remote_parent": True} if pctx is not None
                   else {})) as sp:
            tid = sp.context.trace_id if sp.context is not None else ""
            admit, fence = self.service.epoch_gate(
                body.get("router_epoch"), shard=body.get("router_shard"))
            if not admit:
                sp.set(outcome="stale_epoch")
                stale = _stale_epoch_wire(body, fence, tid)
                stale["kind"] = "rejected"
                return 409, iter([row_out(stale)])
            try:
                req, params = decode_converge(body)
            except ValueError as e:
                sp.set(outcome="invalid")
                return 400, iter([row_out({
                    "kind": "rejected", "ok": False, "rejected": "invalid",
                    "retryable": False,
                    "request_id": body.get("request_id") or "",
                    "detail": str(e), "trace_id": tid})])
            result = self.service.submit_progressive(req, **params)
            if isinstance(result, Rejected):
                status, wired = encode_response(result)
                wired.pop("wire", None)
                wired["kind"] = "rejected"
                if not wired.get("trace_id"):
                    wired["trace_id"] = tid
                sp.set(outcome=result.reason)
                return status, iter([row_out(wired)])
            sp.set(status=200)
        if wire == "frames":
            return 200, (encode_stream_row_frames(row) for row in result)
        return 200, (encode_stream_row(row) for row in result)

    def converge_frames(self, raw, timeout: float | None = None,
                        traceparent: str | None = None,
                        transport: str = "in_process",
                        tenant: str | None = None):
        """Binary converge: envelope bytes in → (status, iterator of
        envelope-bytes rows).  The framed twin of :meth:`converge`."""
        t0 = time.perf_counter()
        try:
            header, arrays = frames_mod.decode_envelope(raw)
        except frames_mod.BadFrame as e:
            status, data = encode_response_frames(
                Rejected("bad_frame", "", detail=str(e)))
            return status, iter([data])
        _codec_obs("frames", "decode", time.perf_counter() - t0,
                   sum(a.nbytes for a in arrays.values()))
        header["_frames"] = arrays
        if tenant:
            header["tenant"] = tenant
        return self.converge(header, timeout=timeout,
                             traceparent=traceparent, transport=transport,
                             wire="frames")

    def warm(self, configs) -> tuple[int, dict]:
        """Pre-compile declared configs (the warm-placement surface: a
        JOINING replica inherits its ring shard's executables BEFORE
        taking traffic).  ``configs`` are the ``service.warmup`` dicts;
        a bad config is a typed 400, never a half-warmed crash."""
        try:
            effective = self.service.warmup(list(configs or ()))
        except Exception as e:  # noqa: BLE001 — typed contract errors
            return 400, {"ok": False, "rejected": "invalid",
                         "detail": f"warmup failed: {e}"[:300]}
        return 200, {"ok": True, "warmed": len(effective),
                     "effective_backends": effective}

    def fence(self, epoch, shard=None) -> tuple[int, dict]:
        """Ratchet the router-epoch fence (``POST /v1/fence`` twin) —
        the explicit propagation call a taking-over router makes so a
        zombie is rejected EVERYWHERE at once, not just on replicas the
        new router happened to talk to first.  ``shard`` scopes the
        sweep to one lineage's ratchet: fencing shard A's
        zombie must not reject the same process's live shard-B owner."""
        try:
            e = int(epoch)
        except (TypeError, ValueError):
            return 400, {"ok": False, "rejected": "invalid",
                         "detail": f"bad fence epoch {epoch!r}"}
        s = None if shard is None else str(shard)
        out = {"ok": True,
               "fence_epoch": self.service.fence(e, shard=s)}
        if s is not None:
            out["shard"] = s
        return 200, out

    def healthz(self) -> tuple[int, dict]:
        return 200, {"ok": True, **self.service.snapshot()}

    def readyz(self) -> tuple[int, dict]:
        """Socket-free readiness twin: (200|503, verdict payload)."""
        ready, payload = self.service.readiness()
        return (200 if ready else 503), {"ok": ready, **payload}

    def stats(self) -> tuple[int, dict]:
        return 200, self.service.snapshot()

    def metrics(self) -> tuple[int, str]:
        """The Prometheus text exposition (socket-free surface)."""
        return 200, metrics_text()


def make_http_server(service: ConvolutionService, host: str = "127.0.0.1",
                     port: int = 8080):
    """A ``ThreadingHTTPServer`` bound to (host, port); ``port=0`` picks a
    free one (``server.server_address[1]`` reports it).  The caller runs
    ``serve_forever()`` / ``shutdown()``; handler threads block inside
    ``service.submit`` while the single batcher worker drives the mesh.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    client = InProcessClient(service)

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 so /v1/converge can stream with chunked
        # transfer-encoding; every non-stream response still carries
        # Content-Length (keep-alive stays correct).
        protocol_version = "HTTP/1.1"

        # Quiet by default: per-request lines go through log_message,
        # which a server script may re-point at its own logger.
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send(self, status: int, payload: dict) -> None:
            send_json(self, status, payload)

        def _send_stream(self, rows) -> None:
            send_ndjson_stream(self, rows)

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path == "/healthz":
                self._send(*client.healthz())
            elif self.path == "/readyz":
                self._send(*client.readyz())
            elif self.path == "/stats":
                self._send(*client.stats())
            elif self.path == "/metrics":
                data = metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", PROM_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._send(404, {"ok": False, "detail": "unknown path"})

        def do_POST(self):  # noqa: N802 — http.server API
            if self.path not in ("/v1/convolve", "/v1/converge",
                                 "/v1/warm", "/v1/fence"):
                # Drain the body first: under HTTP/1.1 keep-alive an
                # unread body would be parsed as the NEXT request line.
                drain_body(self)
                self._send(404, {"ok": False, "detail": "unknown path"})
                return
            ctype = (self.headers.get("Content-Type") or "").split(
                ";")[0].strip().lower()
            if (ctype == frames_mod.FRAMES_CONTENT_TYPE
                    and self.path in ("/v1/convolve", "/v1/converge")):
                # Negotiated binary wire: the raw body IS the envelope;
                # the response comes back framed too.  Decode (and the
                # one CRC walk) happens in the client surface — a
                # malformed envelope is its typed bad_frame 400.
                n = int(self.headers.get("Content-Length", "0") or 0)
                raw = self.rfile.read(n)
                tp = self.headers.get("traceparent")
                ten = self.headers.get("x-tenant")
                if self.path == "/v1/convolve":
                    status, data = client.request_frames(
                        raw, traceparent=tp, transport="http", tenant=ten)
                    send_frames(self, status, data)
                else:
                    status, rows = client.converge_frames(
                        raw, traceparent=tp, transport="http", tenant=ten)
                    if status != 200:
                        send_frames(self, status, next(iter(rows)))
                    else:
                        send_frames_stream(self, rows)
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(n) or b"{}"
                t0 = time.perf_counter()
                body = json.loads(raw)
                _codec_obs("json", "decode", time.perf_counter() - t0,
                           len(raw))
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"ok": False, "rejected": "invalid",
                                 "detail": f"bad JSON body: {e}"})
                return
            if self.path == "/v1/warm":
                self._send(*client.warm(body.get("configs") or []))
                return
            if self.path == "/v1/fence":
                self._send(*client.fence(body.get("epoch"),
                                         shard=body.get("shard")))
                return
            # Tenant identity: the transport header wins over the body
            # field (the router's QoS key rides either).
            tenant = self.headers.get("x-tenant")
            if tenant:
                body["tenant"] = tenant
            if self.path == "/v1/converge":
                status, rows = client.converge(
                    body, traceparent=self.headers.get("traceparent"),
                    transport="http")
                if status != 200:
                    self._send(status, next(iter(rows)))
                else:
                    self._send_stream(rows)
                return
            # W3C-style trace propagation: the transport header wins
            # over any body field (the HTTP twin of the in-process
            # client's explicit argument).
            self._send(*client.request(
                body, traceparent=self.headers.get("traceparent"),
                transport="http"))

    class Server(ThreadingHTTPServer):
        # socketserver's default listen backlog is 5: a burst of max_batch
        # (8) concurrent connects overflows it, the kernel drops the SYNs
        # and each such client waits a second to retransmit.  Admission is
        # the service's queue bound, not the kernel's backlog.
        request_queue_size = 128

    return Server((host, port), Handler)
