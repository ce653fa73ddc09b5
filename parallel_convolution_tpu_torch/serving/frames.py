"""Binary tensor-frame wire codec (the port's own copy of the JAX
package's ``serving/frames.py``, byte for byte the same wire).

The JSON wire carries every tensor as base64 inside JSON (``image_b64`` /
``state_b64``): encode pays a bytes copy plus a 4/3 inflation, decode the
inverse, and the JSON parser walks the whole payload as text.  This module
is the binary alternative, negotiated per request via
``Content-Type: application/x-pctpu-frames``; its responses are
byte-identical to the JSON arm's.

Wire layout — one **frame** per tensor (all integers little-endian)::

    offset  size       field
    0       4          magic  b"PCTF"
    4       1          version (currently 1)
    5       1          dtype code (DTYPE_CODES)
    6       1          ndim (0..MAX_NDIM)
    7       1          flags (reserved, must be 0)
    8       4*ndim     shape, uint32 per dim
    .       8          payload length, uint64
    .       4          CRC32 (zlib) of the payload, uint32
    .       len        payload: C-contiguous little-endian array bytes

A request/response/stream-row is an **envelope**: the existing JSON
control dict (minus its tensor fields) followed by the frames it names::

    offset  size       field
    0       4          magic  b"PCTE"
    4       1          version (currently 1)
    5       3          reserved (0)
    8       4          header length, uint32
    12      hl         header JSON (utf-8); its ``_frame_fields`` list
                       names each successive frame's body field
    .       ...        frames, concatenated in ``_frame_fields`` order

Contracts:

* **Zero-copy decode** — :func:`decode_frame` returns a read-only
  ``np.frombuffer`` view over the request buffer (buffer protocol /
  ``memoryview`` handoff); the first copy happens where compute needs
  one (the f32 conversion into the device put), never in the codec.
* **Typed failure** — every malformed input raises :class:`BadFrame`
  (a ``ValueError``), which the frontends map to the typed
  ``bad_frame`` 400 rejection; a truncated buffer, an unknown dtype
  code, a length mismatch, and a CRC mismatch are all ``BadFrame``,
  never an unhandled handler-thread exception.
* **Opaque forwarding** — :func:`split_envelope` parses ONLY the
  header (what routing/pricing/QoS need) and returns the frame bytes
  unparsed; :func:`join_envelope` re-wraps a restamped header around
  them, so the router forwards tensor payloads without ever decoding
  them (CRC verification happens once, at the replica).
* **JSON fallback** — nothing here replaces the JSON wire; it rides
  beside it as the negotiated fast path and the A/B control arm.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

__all__ = ["BadFrame", "FRAMES_CONTENT_TYPE", "VERSION", "decode_envelope",
           "decode_frame", "encode_envelope", "encode_frame",
           "join_envelope", "split_envelope"]

FRAMES_CONTENT_TYPE = "application/x-pctpu-frames"

FRAME_MAGIC = b"PCTF"
ENVELOPE_MAGIC = b"PCTE"
VERSION = 1
MAX_NDIM = 4
# Per-frame payload bound (512 MB): a length field is attacker-supplied
# input until proven otherwise — reject absurd claims before any
# allocation or CRC walk.
MAX_PAYLOAD = 512 << 20
MAX_HEADER = 16 << 20

# dtype code <-> numpy dtype.  Little-endian on the wire; covers the
# serving tensors (u8 images, f32 carries) plus the round-trip set the
# codec test pins so future fields have codes waiting.
DTYPE_CODES = {
    1: np.dtype("uint8"),
    2: np.dtype("<f4"),
    3: np.dtype("<f8"),
    4: np.dtype("<i4"),
    5: np.dtype("<u2"),
    6: np.dtype("<i8"),
    7: np.dtype("<f2"),
}
_CODE_FOR = {dt: code for code, dt in DTYPE_CODES.items()}

_FIXED = struct.Struct("<4sBBBB")         # magic, version, dtype, ndim, flags
_ENV_FIXED = struct.Struct("<4sB3sI")     # magic, version, reserved, hlen
_LEN_CRC = struct.Struct("<QI")


class BadFrame(ValueError):
    """Typed malformed-frame error → the ``bad_frame`` 400 rejection."""


def encode_frame(arr) -> bytes:
    """One array → one self-delimiting frame (bytes)."""
    a = np.asarray(arr)
    if not a.flags["C_CONTIGUOUS"]:
        # ascontiguousarray only when needed: it promotes 0-d to 1-d.
        a = np.ascontiguousarray(a)
    if a.dtype.byteorder == ">":          # wire is little-endian
        a = a.astype(a.dtype.newbyteorder("<"))
    # dtype equality (and hashing) ignores the "=" native marker, so a
    # plain float32 array finds its "<f4" code on LE hosts directly.
    code = _CODE_FOR.get(a.dtype)
    if code is None:
        raise BadFrame(f"dtype {a.dtype} has no frame code")
    if a.ndim > MAX_NDIM:
        raise BadFrame(f"ndim {a.ndim} exceeds frame limit {MAX_NDIM}")
    payload = a.tobytes()                 # C order
    head = _FIXED.pack(FRAME_MAGIC, VERSION, code, a.ndim, 0)
    dims = struct.pack(f"<{a.ndim}I", *a.shape) if a.ndim else b""
    return (head + dims
            + _LEN_CRC.pack(len(payload), zlib.crc32(payload)) + payload)


def decode_frame(buf, offset: int = 0):
    """``(array_view, next_offset)`` — zero-copy over ``buf``.

    ``buf`` is anything the buffer protocol accepts; the returned array
    is a read-only view into it (``np.frombuffer``), so the caller must
    keep the buffer alive as long as the array.  Raises
    :class:`BadFrame` on any malformation, including CRC mismatch.
    """
    view = memoryview(buf).cast("B")
    n = len(view)
    if offset + _FIXED.size > n:
        raise BadFrame(
            f"truncated frame: {n - offset} bytes at offset {offset}, "
            f"need {_FIXED.size} for the fixed header")
    magic, version, code, ndim, flags = _FIXED.unpack_from(view, offset)
    if magic != FRAME_MAGIC:
        raise BadFrame(f"bad frame magic {magic!r} at offset {offset}")
    if version != VERSION:
        raise BadFrame(f"unsupported frame version {version}")
    if flags != 0:
        raise BadFrame(f"reserved frame flags set ({flags:#x})")
    if ndim > MAX_NDIM:
        raise BadFrame(f"frame ndim {ndim} exceeds limit {MAX_NDIM}")
    dtype = DTYPE_CODES.get(code)
    if dtype is None:
        raise BadFrame(f"unknown dtype code {code}")
    off = offset + _FIXED.size
    if off + 4 * ndim + _LEN_CRC.size > n:
        raise BadFrame("truncated frame: shape/length fields cut off")
    shape = struct.unpack_from(f"<{ndim}I", view, off) if ndim else ()
    off += 4 * ndim
    plen, crc = _LEN_CRC.unpack_from(view, off)
    off += _LEN_CRC.size
    if plen > MAX_PAYLOAD:
        raise BadFrame(f"frame payload {plen} exceeds {MAX_PAYLOAD} bytes")
    want = (int(np.prod(shape, dtype=np.int64)) if ndim else 1) \
        * dtype.itemsize
    if plen != want:
        raise BadFrame(
            f"frame payload {plen} bytes does not match shape {shape} "
            f"({want} bytes for {dtype})")
    if off + plen > n:
        raise BadFrame(
            f"truncated frame payload: {n - off} bytes present, "
            f"{plen} declared")
    payload = view[off:off + plen]
    if zlib.crc32(payload) != crc:
        raise BadFrame("frame CRC mismatch: payload corrupt in transit")
    arr = np.frombuffer(payload, dtype=dtype).reshape(shape)
    return arr, off + plen


def encode_envelope(header: dict, arrays: dict | None = None) -> bytes:
    """JSON control header + named tensor frames → envelope bytes.

    ``arrays`` maps body-field names to arrays; their names land in the
    header's ``_frame_fields`` so decode can bind each frame back to
    its field.  The header must not itself carry ``_frame*`` keys.
    """
    arrays = arrays or {}
    head = {k: v for k, v in header.items()
            if not str(k).startswith("_frame")}
    head["_frame_fields"] = list(arrays.keys())
    hjson = json.dumps(head, separators=(",", ":")).encode()
    out = [_ENV_FIXED.pack(ENVELOPE_MAGIC, VERSION, b"\0\0\0",
                           len(hjson)), hjson]
    out.extend(encode_frame(arrays[name]) for name in arrays)
    return b"".join(out)


def split_envelope(raw):
    """``(header_dict, frames_raw)`` — header parsed, frames OPAQUE.

    The router's surface: everything routing, pricing, and QoS read
    lives in the header; ``frames_raw`` is a ``memoryview`` over the
    unparsed frame bytes, forwarded verbatim (no decode, no CRC walk —
    integrity is verified once, at the replica).  Raises
    :class:`BadFrame` on a malformed envelope prefix.
    """
    view = memoryview(raw).cast("B")
    if len(view) < _ENV_FIXED.size:
        raise BadFrame(
            f"truncated envelope: {len(view)} bytes, need "
            f"{_ENV_FIXED.size}")
    magic, version, _resv, hlen = _ENV_FIXED.unpack_from(view, 0)
    if magic != ENVELOPE_MAGIC:
        raise BadFrame(f"bad envelope magic {magic!r}")
    if version != VERSION:
        raise BadFrame(f"unsupported envelope version {version}")
    if hlen > MAX_HEADER:
        raise BadFrame(f"envelope header {hlen} exceeds {MAX_HEADER}")
    if _ENV_FIXED.size + hlen > len(view):
        raise BadFrame("truncated envelope: header cut off")
    try:
        header = json.loads(bytes(view[_ENV_FIXED.size:
                                       _ENV_FIXED.size + hlen]))
    except ValueError as e:
        raise BadFrame(f"envelope header is not valid JSON: {e}") from e
    if not isinstance(header, dict):
        raise BadFrame("envelope header must be a JSON object")
    return header, view[_ENV_FIXED.size + hlen:]


def join_envelope(header: dict, frames_raw) -> bytes:
    """Re-wrap a (restamped) header around already-encoded frame bytes
    — the router's opaque-forward encoder.  ``header`` keeps whatever
    ``_frame_fields`` it already carries (the frames are not re-read)."""
    head = {k: v for k, v in header.items()
            if k == "_frame_fields" or not str(k).startswith("_frame")}
    hjson = json.dumps(head, separators=(",", ":")).encode()
    return (_ENV_FIXED.pack(ENVELOPE_MAGIC, VERSION, b"\0\0\0",
                            len(hjson)) + hjson + bytes(frames_raw))


def decode_envelope(raw):
    """``(header_dict, {field: array_view})`` — the full decode.

    Frame order and count come from the header's ``_frame_fields``;
    trailing garbage after the last declared frame is a
    :class:`BadFrame` (a length-confused client must hear about it).
    Array views are zero-copy into ``raw``.
    """
    header, frames_raw = split_envelope(raw)
    fields = header.pop("_frame_fields", [])
    if not isinstance(fields, list) or not all(
            isinstance(f, str) for f in fields):
        raise BadFrame("_frame_fields must be a list of field names")
    arrays: dict[str, np.ndarray] = {}
    off = 0
    for name in fields:
        arr, off = decode_frame(frames_raw, off)
        arrays[name] = arr
    if off != len(frames_raw):
        raise BadFrame(
            f"{len(frames_raw) - off} trailing bytes after the last "
            "declared frame")
    return header, arrays
