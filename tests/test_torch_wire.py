"""The port's binary frames, wire codec and HTTP frontend held against the
JAX package's on the CPU.

* every frame and envelope the port encodes is the JAX codec's bytes, for
  every dtype in ``DTYPE_CODES``; each side decodes the other's; every
  malformation is the same typed ``BadFrame`` with the same text;
* ``InProcessClient``: the JSON and frames responses are byte-equal, and
  equal to the JAX client's on the same bodies (backends mapped); a bad
  frame is the typed ``bad_frame`` 400 on both;
* one loopback HTTP server for the module (port 0) drives
  ``/v1/convolve`` (both wires), ``/v1/converge`` (NDJSON and framed),
  ``/v1/warm``, ``/v1/fence``, ``/healthz``, ``/readyz``, ``/stats`` and
  ``/metrics`` (parsed with ``obs.metrics.parse_text``), the status codes,
  ``Retry-After`` and ``traceparent``.
"""

import base64
import http.client
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
from _torch_jax_state import reset_jax_state

from parallel_convolution_tpu.parallel import mesh as jmesh
from parallel_convolution_tpu.serving import frames as jframes
from parallel_convolution_tpu.serving import frontend as jfrontend
from parallel_convolution_tpu.serving import service as jservice
from parallel_convolution_tpu_torch.obs import metrics
from parallel_convolution_tpu_torch.ops import oracle
from parallel_convolution_tpu_torch.ops.filters import get_filter
from parallel_convolution_tpu_torch.parallel import mesh
from parallel_convolution_tpu_torch.serving import frames, frontend, service
from parallel_convolution_tpu_torch.utils import imageio
from parallel_convolution_tpu_torch.utils.config import BACKEND_FROM_REFERENCE

JAX_NAME = {v: k for k, v in BACKEND_FROM_REFERENCE.items()}


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    reset_jax_state()


def _img(h=24, w=36, mode="grey", seed=1):
    return imageio.generate_test_image(h, w, mode, seed=seed)


def _b64(a) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def _head(img, **kw):
    body = {"rows": img.shape[0], "cols": img.shape[1],
            "mode": "rgb" if img.ndim == 3 else "grey", "filter": "blur3",
            "iters": 1, "backend": "shifted", "storage": "f32", "fuse": 1,
            "boundary": "zero"}
    body.update(kw)
    return body


# ----------------------------------------------------------- frame codec
def _arr(dt, shape, seed=0):
    return (np.random.default_rng(seed).random(shape) * 100).astype(dt)


@pytest.mark.parametrize("code", sorted(jframes.DTYPE_CODES))
@pytest.mark.parametrize("shape", [(3, 5), (2, 3, 4, 5), (0,), ()])
def test_frame_bytes_equal_jax(code, shape):
    dt = jframes.DTYPE_CODES[code]
    assert frames.DTYPE_CODES[code] == dt
    arr = _arr(dt, shape, code)
    buf = frames.encode_frame(arr)
    assert buf == jframes.encode_frame(arr)
    got, end = frames.decode_frame(jframes.encode_frame(arr))
    assert end == len(buf) and got.dtype == dt and got.shape == arr.shape
    assert got.tobytes() == arr.tobytes() and not got.flags["WRITEABLE"]
    big = arr.astype(dt.newbyteorder(">")) if dt.itemsize > 1 else arr
    assert frames.encode_frame(big) == jframes.encode_frame(big) == buf


def test_frame_refusals_equal_jax():
    for bad in (np.zeros((2, 2), np.complex64), np.zeros((1,) * 5, np.uint8)):
        with pytest.raises(frames.BadFrame) as got:
            frames.encode_frame(bad)
        with pytest.raises(jframes.BadFrame) as want:
            jframes.encode_frame(bad)
        assert str(got.value) == str(want.value)
    assert issubclass(frames.BadFrame, ValueError)


def test_envelope_bytes_equal_jax_and_opaque_forward():
    img = _img(17, 23)
    state = np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4)
    head = {"request_id": "r1", "iters": 2, "_frame_x": 1, "tenant": "t0"}
    arrays = {"image": img, "state": state}
    env = frames.encode_envelope(head, arrays)
    assert env == jframes.encode_envelope(head, arrays)
    assert frames.encode_envelope({"a": 1}) == jframes.encode_envelope(
        {"a": 1})
    back, got = frames.decode_envelope(jframes.encode_envelope(head, arrays))
    jback, jgot = jframes.decode_envelope(env)
    assert back == jback and "_frame_fields" not in back
    assert {k: v.tobytes() for k, v in got.items()} == {
        k: v.tobytes() for k, v in jgot.items()}
    h, raw = frames.split_envelope(env)
    jh, jraw = jframes.split_envelope(env)
    assert h == jh and bytes(raw) == bytes(jraw)
    h["router"] = {"replica": "r0"}
    assert frames.join_envelope(h, raw) == jframes.join_envelope(h, jraw)


def _flip(buf: bytes, seed: int) -> bytes:
    """One payload bit flipped near the end (inside the last frame's
    payload): only the CRC can catch it."""
    b = bytearray(buf)
    i = len(b) - 1 - (seed * 7) % 64
    b[i] ^= 1 << (seed % 8)
    return bytes(b)


MALFORMED = {
    "garbage": b"not an envelope at all",
    "empty": b"",
    "bad_magic": b"XXXX" + jframes.encode_envelope({"a": 1})[4:],
    "bad_version": b"PCTE\x02" + jframes.encode_envelope({"a": 1})[5:],
    "header_cut": jframes.encode_envelope({"a": 1})[:14],
    "header_not_json": b"PCTE\x01\x00\x00\x00\x03\x00\x00\x00{x}",
    "header_a_list": b"PCTE\x01\x00\x00\x00\x02\x00\x00\x00[]",
    "trailing": jframes.encode_envelope({"a": 1}, {"i": _img(8, 8)}) + b"zz",
    "half": jframes.encode_envelope({"a": 1}, {"i": _img(8, 8)})[:120],
    "fields_not_names": jframes.join_envelope({"_frame_fields": [1]}, b""),
    "frame_flags": jframes.join_envelope(
        {"_frame_fields": ["x"]},
        jframes.encode_frame(np.zeros(2, np.uint8))[:7] + b"\x01"
        + jframes.encode_frame(np.zeros(2, np.uint8))[8:]),
    "unknown_dtype": jframes.join_envelope(
        {"_frame_fields": ["x"]},
        jframes.encode_frame(np.zeros(2, np.uint8))[:5] + b"\x63"
        + jframes.encode_frame(np.zeros(2, np.uint8))[6:]),
    "length_mismatch": jframes.join_envelope(
        {"_frame_fields": ["x"]},
        jframes.encode_frame(np.zeros(2, np.uint8))[:12] + b"\x03"
        + jframes.encode_frame(np.zeros(2, np.uint8))[13:]),
    **{f"crc_{s}": _flip(jframes.encode_envelope(
        {"a": 1}, {"image": _img(32, 32)}), s) for s in range(8)},
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_envelopes_are_the_same_bad_frame(name):
    raw = MALFORMED[name]
    with pytest.raises(frames.BadFrame) as got:
        frames.decode_envelope(raw)
    with pytest.raises(jframes.BadFrame) as want:
        jframes.decode_envelope(raw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cut", [1, 4, 7, 10, 17, 30, 63])
def test_truncated_frames_are_the_same_bad_frame(cut):
    buf = jframes.encode_frame(np.arange(64, dtype=np.uint8))
    with pytest.raises(frames.BadFrame) as got:
        frames.decode_frame(buf[:cut])
    with pytest.raises(jframes.BadFrame) as want:
        jframes.decode_frame(buf[:cut])
    assert str(got.value) == str(want.value)


# ------------------------------------------------- in-process, both wires
def _clients():
    port = service.ConvolutionService(mesh.make_grid((2, 2), "cpu"),
                                      max_delay_s=0.01)
    jax_svc = jservice.ConvolutionService(
        jmesh.make_grid_mesh(jax.devices()[:4], (2, 2)), max_delay_s=0.01)
    return (frontend.InProcessClient(port), jfrontend.InProcessClient(jax_svc))


@pytest.fixture(scope="module")
def clients():
    c, jc = _clients()
    yield c, jc
    c.service.close()
    jc.service.close()


@pytest.mark.parametrize("backend,storage,mode", [
    ("shifted", "f32", "grey"), ("cuda_sep", "bf16", "rgb"),
    ("cuda_rdma", "u8", "grey"), ("cuda", "u8", "rgb")])
def test_convolve_both_wires_byte_equal_and_jax(clients, backend, storage,
                                                mode):
    c, jc = clients
    img = _img(32, 40, mode, seed=3)
    head = _head(img, iters=2, fuse=2, storage=storage, backend=backend)
    s, r = c.request(dict(head, image_b64=_b64(img)))
    fs, raw = c.request_frames(frames.encode_envelope(head, {"image": img}))
    fh, fa = frames.decode_envelope(raw)
    js, jr = jc.request(dict(head, backend=JAX_NAME[backend],
                             image_b64=_b64(img)))
    assert s == fs == js == 200
    assert r["wire"] == "json" and fh["wire"] == "frames"
    assert base64.b64decode(r["image_b64"]) == fa["image"].tobytes() == \
        base64.b64decode(jr["image_b64"])
    want = oracle.run_serial_u8(img, get_filter("blur3"), 2)
    assert fa["image"].tobytes() == want.tobytes()
    assert set(r) == set(jr)
    assert {k for k in fh if k != "image_b64"} == set(r) - {"image_b64"}


def test_bad_frame_is_a_typed_400_like_jax(clients):
    c, jc = clients
    img = _img()
    env = frames.encode_envelope(_head(img, request_id="bf1"),
                                 {"image": img})
    for raw in (b"garbage", _flip(env, 3)):
        s, data = c.request_frames(raw)
        js, jdata = jc.request_frames(raw)
        assert s == js == 400
        h, arrays = frames.decode_envelope(data)
        jh, _ = jframes.decode_envelope(jdata)
        assert h == dict(jh, trace_id=h["trace_id"]) and not arrays
        assert h["rejected"] == "bad_frame" and h["retryable"] is False
    assert c.request_frames(env)[0] == 200


def test_converge_stream_both_wires_identical(clients):
    c, _ = clients
    img = _img(32, 40, seed=5)
    base = _head(img, tol=5e-3, max_iters=40, check_every=10,
                 quantize=False, resume_state=True)
    s, jrows = c.converge(dict(base, image_b64=_b64(img)))
    fs, frows = c.converge_frames(frames.encode_envelope(base,
                                                         {"image": img}))
    jrows = list(jrows)
    frows = [frames.decode_envelope(r) for r in frows]
    assert s == fs == 200 and len(jrows) == len(frows) == 5
    for jr, (fh, fa) in zip(jrows, frows):
        assert jr["kind"] == fh["kind"] and jr["iters"] == fh["iters"]
        assert base64.b64decode(jr["image_b64"]) == fa["image"].tobytes()
        if jr["kind"] == "snapshot":
            assert base64.b64decode(jr["state_b64"]) == fa["state"].tobytes()
    assert jrows[-1]["kind"] == "final"


def test_stream_row_encoders_equal_jax():
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    state = np.linspace(0, 1, 12, dtype=np.float32).reshape(1, 3, 4)
    for mod, S in ((frontend, service), (jfrontend, jservice)):
        row = S.Snapshot(image=img, iters=10, diff=0.25, state=state,
                         request_id="x", solver="jacobi", work_units=10.0)
        rej = S.Rejected("queue_full", "y", detail="full")
        out = (mod.encode_stream_row(row), mod.encode_stream_row(rej),
               mod.encode_stream_row_frames(row),
               mod.encode_response(rej), mod.encode_response_frames(rej),
               mod.retry_after_header(mod.encode_response(rej)[1]))
        if mod is frontend:
            got = out
        else:
            want = out
    assert got == want


# ---------------------------------------------------------- loopback HTTP
@pytest.fixture(scope="module")
def server():
    metrics.set_enabled(True)
    svc = service.ConvolutionService(mesh.make_grid((2, 2), "cpu"),
                                     max_delay_s=0.01, cache=True)
    srv = frontend.make_http_server(svc, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield svc, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    svc.close()
    t.join(30)


def _post(url, data: bytes, ctype="application/json", headers=None):
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": ctype, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_convolve_both_wires_and_the_cache(server, clients):
    _, url = server
    _, jc = clients
    img = _img(36, 44, "rgb", seed=7)
    head = _head(img, iters=3, fuse=3, backend="cuda_sep", storage="bf16")
    tp = "00-0123456789abcdef0123456789abcdef-0123456789abcdef-01"
    s, h, body = _post(f"{url}/v1/convolve",
                       json.dumps(dict(head, image_b64=_b64(img))).encode(),
                       headers={"traceparent": tp})
    j = json.loads(body)
    fs, fhdr, fbody = _post(f"{url}/v1/convolve", frames.encode_envelope(
        head, {"image": img}), frames.FRAMES_CONTENT_TYPE)
    fh, fa = frames.decode_envelope(fbody)
    assert s == fs == 200
    assert fhdr["Content-Type"] == frames.FRAMES_CONTENT_TYPE
    assert j["trace_id"] == "0123456789abcdef0123456789abcdef"
    assert (j["cache"], fh["cache"]) == ("miss", "hit")
    assert base64.b64decode(j["image_b64"]) == fa["image"].tobytes()
    js, jr = jc.request(dict(head, backend="pallas_sep",
                             image_b64=_b64(img)))
    assert base64.b64decode(jr["image_b64"]) == fa["image"].tobytes()


def test_http_converge_ndjson_and_framed(server):
    _, url = server
    img = _img(36, 44, seed=2)
    base = _head(img, tol=0.5, max_iters=400, check_every=10,
                 quantize=True, storage="u8", backend="cuda_rdma", fuse=8)
    s, h, body = _post(f"{url}/v1/converge",
                       json.dumps(dict(base, image_b64=_b64(img))).encode())
    rows = [json.loads(line) for line in body.splitlines() if line.strip()]
    assert s == 200 and h["Content-Type"] == frontend.NDJSON_CONTENT_TYPE

    def framed(head):
        req = urllib.request.Request(
            f"{url}/v1/converge", data=frames.encode_envelope(
                head, {"image": img}),
            headers={"Content-Type": frames.FRAMES_CONTENT_TYPE})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return [frames.decode_envelope(r)
                    for r in frontend.iter_framed_rows(resp)]

    # Another fuse is another key: the whole stream, row for row.
    frows = framed(dict(base, fuse=5))
    assert rows[-1]["kind"] == "final" and rows[-1]["converged"]
    assert [(h["kind"], h["iters"], a["image"].tobytes()) for h, a in frows
            ] == [(r["kind"], r["iters"], base64.b64decode(r["image_b64"]))
                  for r in rows]
    # The same key's converged final is cached: a one-row stream.
    frows = framed(base)
    assert len(frows) == 1 and frows[0][0]["cache"] == "hit"
    assert frows[0][1]["image"].tobytes() == base64.b64decode(
        rows[-1]["image_b64"])
    x = img[None].astype(np.float32)
    for _ in range(rows[-1]["iters"]):
        from parallel_convolution_tpu_torch.ops import conv

        x = conv.quantize_f32(conv.correlate_shifted(
            __import__("torch").from_numpy(x), get_filter("blur3"))).numpy()
    assert frows[0][1]["image"].tobytes() == x[0].astype(np.uint8).tobytes()


def test_http_typed_statuses_retry_after_and_drain(server):
    svc, url = server
    img = _img()
    s, h, body = _post(f"{url}/v1/convolve", json.dumps(
        dict(_head(img, backend="pallas"), image_b64=_b64(img))).encode())
    r = json.loads(body)
    assert s == 400 and r["rejected"] == "invalid"
    assert "'pallas' is 'cuda' here" in r["detail"]
    s, _, body = _post(f"{url}/v1/convolve", b"[1, 2]")
    assert s == 400 and json.loads(body)["rejected"] == "invalid"
    s, _, body = _post(f"{url}/v1/convolve", b"garbage",
                       frames.FRAMES_CONTENT_TYPE)
    assert s == 400
    assert frames.decode_envelope(body)[0]["rejected"] == "bad_frame"
    s, _, body = _post(f"{url}/v1/fence", json.dumps({"epoch": 4}).encode())
    assert (s, json.loads(body)["fence_epoch"]) == (200, 4)
    s, _, body = _post(f"{url}/v1/convolve", json.dumps(
        dict(_head(img), image_b64=_b64(img), router_epoch=2)).encode())
    assert s == 409 and json.loads(body)["rejected"] == "stale_epoch"
    svc._reshaping = True
    try:
        s, h, body = _post(f"{url}/v1/convolve", json.dumps(
            dict(_head(img), image_b64=_b64(img))).encode())
        assert s == 503 and h["Retry-After"] == "1"
        assert json.loads(body)["retryable"] is True
        assert _get(f"{url}/readyz")[0] == 503
    finally:
        svc._reshaping = False
    # keep-alive: a 404'd POST drains its body before the next request.
    host, port = url.rsplit("/", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    try:
        payload = json.dumps(dict(_head(img), image_b64=_b64(img))).encode()
        conn.request("POST", "/nope", body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 404
        resp.read()
        conn.request("POST", "/v1/convolve", body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["ok"]
    finally:
        conn.close()


def test_http_warm_probes_stats_and_metrics(server):
    svc, url = server
    s, _, body = _post(f"{url}/v1/warm", json.dumps({"configs": [
        {"rows": 40, "cols": 48, "iters": 4, "backend": "cuda_sep",
         "storage": "bf16", "fuse": 4}]}).encode())
    assert (s, json.loads(body)["effective_backends"]) == (200, ["cuda_sep"])
    s, _, body = _post(f"{url}/v1/warm", json.dumps({"configs": [
        {"rows": 40, "cols": 48, "backend": "pallas_sep"}]}).encode())
    assert s == 400 and json.loads(body)["rejected"] == "invalid"
    s, body = _get(f"{url}/readyz")
    ready = json.loads(body)
    assert s == 200 and ready["ready"] and ready["grid"] == "2x2"
    s, body = _get(f"{url}/healthz")
    assert s == 200 and json.loads(body)["platform"] == "cpu"
    s, body = _get(f"{url}/stats")
    assert s == 200 and json.loads(body)["mesh"] == "2x2"
    assert _get(f"{url}/nope")[0] == 404
    s, body = _get(f"{url}/metrics")
    parsed = metrics.parse_text(body.decode())
    assert s == 200 and "pctpu_request_phase_seconds_count" in parsed
    assert "pctpu_service_stats" in parsed
    assert any(lab.get("outcome") == "completed"
               for lab, _ in parsed["pctpu_admission_total"])


def test_http_backlog_takes_a_burst_of_a_full_batch(server):
    """Eight clients connecting at once (max_batch) all get through
    without a SYN retransmit: the listen backlog is above the burst
    (socketserver's default of 5 would drop three of eight)."""
    import socket

    svc, url = server
    host, port = url.rsplit("/", 1)[1].split(":")
    import time

    t0 = time.perf_counter()
    socks = [socket.create_connection((host, int(port)), timeout=10)
             for _ in range(16)]
    # A dropped SYN is retransmitted after a second.
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
