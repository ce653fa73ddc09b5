"""Chaos transport: seeded network-shaped failure injection (the port's
copy of the JAX package's ``serving/chaos.py``).

The compute and IO fault sites of ``resilience.faults`` never reach the
transport layer (router, hedging, breakers).  :class:`ChaosTransport`
does: it wraps a replica transport (:class:`~.router.InProcessReplica`
or :class:`~.router.HTTPReplica`) and injects failures at the FOUR
transport sites of the ``PCTPU_FAULTS`` grammar
(``faults.SITE_TABLE``):

* ``transport_send``   — the request never reaches the replica
  (``drop`` connection error, seeded ``latency``, or a ``blackhole``
  that burns the timeout first);
* ``transport_recv``   — the replica DID the work but the response is
  lost (``drop`` — the idempotency-ledger case) or arrives as garbage
  (``corrupt`` → :class:`~.router.CorruptReplicaBody`, breaker food);
* ``transport_stream`` — one progressive NDJSON row dies in flight
  (``disconnect``/``corrupt`` AFTER best-so-far rows landed — the
  mid-stream resume case);
* ``readyz_probe``     — the active-health poll lies (``flap``).

WHICH hits fail rides the proven, seeded ``PCTPU_FAULTS`` machinery
(hit-indexed / range / probability triggers — every injected failure is
replayable bit-for-bit); WHAT the failure looks like is this module's
per-site ``modes`` map.  Injected failures surface as the same exception
types real networks produce (``ConnectionError`` and subclasses), so the
router's breaker/failover/resume machinery is exercised exactly as it
would be by a dying host — nothing in the serving plane knows chaos
exists.

stdlib-only; torch stays inside the replicas.
"""

from __future__ import annotations

import random
import time

from parallel_convolution_tpu_torch.obs import (
    events as obs_events, metrics as obs_metrics,
)
from parallel_convolution_tpu_torch.resilience.faults import (
    InjectedFault, fault_point,
)

__all__ = ["ChaosTransport", "DEFAULT_MODES", "corrupt_frame_bytes",
           "modes_from_spec", "router_kill_due", "truncate_frame_bytes"]


def corrupt_frame_bytes(raw, *, seed: int = 0) -> bytes:
    """Deterministically flip one bit inside the LAST byte region of a
    framed payload — the corrupt-body mode for the binary wire.

    Flipping near the END of the buffer lands inside the final frame's
    PAYLOAD (headers and CRC fields sit ahead of it), so the decoder's
    structural checks all pass and the CRC is what must catch it — the
    exact in-transit corruption the checksum exists for.  ``seed``
    varies which bit, so a sweep can prove detection isn't positional
    luck."""
    data = bytearray(raw)
    if not data:
        return bytes(data)
    # Offset from the end, staying inside the last 64 bytes (or the
    # whole buffer when shorter); never the terminal byte alone — vary
    # by seed so repeated injections corrupt different payload bits.
    span = min(64, len(data))
    pos = len(data) - 1 - (seed % span)
    data[pos] ^= 1 << ((seed // span) % 8 or 1)
    return bytes(data)


def truncate_frame_bytes(raw, *, seed: int = 0) -> bytes:
    """Deterministically cut a framed payload SHORT — the mid-stream
    truncation sibling of :func:`corrupt_frame_bytes`.

    Drops between 1 and 64 trailing bytes (seeded), never the whole
    buffer, so the decoder sees a structurally plausible PREFIX whose
    declared lengths overrun the bytes present — the torn-socket shape
    ``frames.BadFrame``'s truncation checks exist for.  ``seed`` varies
    the cut depth so a sweep can prove detection isn't positional
    luck."""
    data = bytes(raw)
    if len(data) <= 1:
        return b""
    cut = 1 + (seed % min(64, len(data) - 1))
    return data[:-cut]


def router_kill_due() -> bool:
    """Consult the ``router_kill`` fault site: True when the seeded
    plan says the router process dies NOW.  Crash drills
    (``chip_smoke.py``'s router crash, the CPU tests) poll this
    per streamed row and convert a True into what a real router death
    looks like — the stream abandoned un-closed, then a standby
    takeover replaying the WAL — instead of an in-band exception the
    serving plane would politely handle."""
    try:
        fault_point("router_kill")
    except InjectedFault:
        if obs_metrics.enabled():
            obs_events.emit("chaos", site="router_kill", mode="kill",
                            replica="router")
        return True
    return False

# site -> the failure shapes it can take (the first is the default).
SITE_MODES = {
    "transport_send": ("drop", "latency", "blackhole"),
    "transport_recv": ("drop", "corrupt"),
    "transport_stream": ("disconnect", "corrupt", "truncate"),
    "readyz_probe": ("flap",),
}

# Literal consults per site, as in the JAX package (whose fault-site
# drift guard greps for literal site-name consults).
_CONSULTS = {
    "transport_send": lambda: fault_point("transport_send"),
    "transport_recv": lambda: fault_point("transport_recv"),
    "transport_stream": lambda: fault_point("transport_stream"),
    "readyz_probe": lambda: fault_point("readyz_probe"),
}
DEFAULT_MODES = {site: modes[0] for site, modes in SITE_MODES.items()}


def modes_from_spec(spec: str) -> dict[str, str]:
    """Parse ``site=mode,site=mode`` (e.g. from a CLI flag); raises
    ValueError on unknown sites/modes so a typo can't silently noop."""
    out: dict[str, str] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise ValueError(
                f"bad chaos mode {part!r}: expected site=mode")
        site, mode = (s.strip() for s in part.split("=", 1))
        if site not in SITE_MODES:
            raise ValueError(
                f"unknown chaos site {site!r}; known: "
                f"{sorted(SITE_MODES)}")
        if mode not in SITE_MODES[site]:
            raise ValueError(
                f"unknown mode {mode!r} for {site}; known: "
                f"{SITE_MODES[site]}")
        out[site] = mode
    return out


class ChaosTransport:
    """A replica transport wrapper injecting seeded transport failure.

    ``modes`` overrides :data:`DEFAULT_MODES` per site.  ``latency_s``
    is the mean injected latency (the actual sleep draws uniformly from
    [0.5, 1.5]× it, seeded); ``blackhole_s`` bounds a black-hole stall
    (clamped to the caller's timeout when one is given).  All other
    attributes (``kill``/``revive``/``service``...) delegate to the
    wrapped transport, so drills drive the replica through the wrapper.
    """

    def __init__(self, inner, modes: dict | str | None = None, *,
                 seed: int = 0, latency_s: float = 0.05,
                 blackhole_s: float = 2.0):
        if isinstance(modes, str):
            modes = modes_from_spec(modes)
        bad = set(modes or {}) - set(SITE_MODES)
        if bad:
            raise ValueError(f"unknown chaos site(s) {sorted(bad)}")
        self.inner = inner
        self.modes = {**DEFAULT_MODES, **(modes or {})}
        for site, mode in self.modes.items():
            if mode not in SITE_MODES[site]:
                raise ValueError(
                    f"unknown mode {mode!r} for {site}; known: "
                    f"{SITE_MODES[site]}")
        self._rng = random.Random(seed)
        self.latency_s = float(latency_s)
        self.blackhole_s = float(blackhole_s)
        self.injected: dict[str, int] = {}   # site -> count (asserts)

    @property
    def name(self) -> str:
        return self.inner.name

    def __getattr__(self, attr):
        # kill/revive/service/... delegate to the wrapped transport
        # (only called when normal lookup missed).  "inner" itself must
        # fail plainly — delegating it would recurse forever on a
        # half-constructed wrapper.
        if attr == "inner":
            raise AttributeError(attr)
        return getattr(self.inner, attr)

    # -- injection ------------------------------------------------------------
    def _consult(self, site: str) -> str | None:
        """The site's mode when the installed fault plan fires, else
        None.  The plan's hit counters/seed decide WHEN; the mode map
        decides WHAT."""
        try:
            _CONSULTS[site]()
            return None
        except InjectedFault:
            mode = self.modes[site]
            self.injected[site] = self.injected.get(site, 0) + 1
            if obs_metrics.enabled():
                obs_metrics.counter(
                    "pctpu_chaos_injections_total",
                    "network-shaped failures injected by the chaos "
                    "transport", ("site", "mode", "replica")).inc(
                    site=site, mode=mode, replica=self.name)
                obs_events.emit("chaos", site=site, mode=mode,
                                replica=self.name)
            return mode

    def _send(self, timeout) -> None:
        mode = self._consult("transport_send")
        if mode is None:
            return
        if mode == "latency":
            time.sleep(self.latency_s * (0.5 + self._rng.random()))
            return
        if mode == "blackhole":
            # A black hole costs the caller its timeout budget FIRST —
            # the failure shape breakers/hedges exist for.
            time.sleep(min(self.blackhole_s,
                           timeout if timeout else self.blackhole_s))
            raise ConnectionError(
                f"chaos: black-holed send to {self.name} timed out")
        raise ConnectionError(f"chaos: dropped send to {self.name}")

    def _recv(self) -> None:
        mode = self._consult("transport_recv")
        if mode is None:
            return
        if mode == "corrupt":
            from parallel_convolution_tpu_torch.serving.router import (
                CorruptReplicaBody,
            )

            raise CorruptReplicaBody(
                f"chaos: corrupt body from {self.name}")
        raise ConnectionError(
            f"chaos: dropped response from {self.name} "
            "(the work executed)")

    # -- the transport protocol ------------------------------------------------
    def request(self, body: dict, timeout: float | None = None,
                traceparent: str | None = None):
        self._send(timeout)
        status, wire = self.inner.request(body, timeout=timeout,
                                          traceparent=traceparent)
        self._recv()
        return status, wire

    def converge(self, body: dict, timeout: float | None = None,
                 traceparent: str | None = None):
        self._send(timeout)
        status, rows = self.inner.converge(body, timeout=timeout,
                                           traceparent=traceparent)
        self._recv()
        if status != 200:
            return status, rows
        return 200, self._chaos_rows(rows)

    def _chaos_rows(self, rows):
        """Per-row stream injection: consult ``transport_stream`` before
        each row crosses — a triggered hit breaks the stream AFTER the
        earlier rows already landed (the resume case)."""
        from parallel_convolution_tpu_torch.serving.router import (
            CorruptReplicaBody,
        )

        for row in rows:
            mode = self._consult("transport_stream")
            if mode == "corrupt":
                raise CorruptReplicaBody(
                    f"chaos: corrupt stream row from {self.name}")
            if mode == "truncate":
                # Run the REAL codec path — encode this row
                # as a PCTE envelope, tear its tail, and let the
                # decoder's own truncation check produce the typed
                # error the router resumes from.  If the torn prefix
                # somehow decoded, that would be a codec hole — still
                # surfaced typed, never silently served.
                from parallel_convolution_tpu_torch.serving import frames

                raw = truncate_frame_bytes(
                    frames.encode_envelope(dict(row)),
                    seed=self._rng.randrange(1 << 16))
                try:
                    frames.decode_envelope(raw)
                except frames.BadFrame as e:
                    raise CorruptReplicaBody(
                        f"chaos: truncated stream envelope from "
                        f"{self.name}: {e}") from None
                raise CorruptReplicaBody(
                    f"chaos: truncated stream envelope from "
                    f"{self.name} decoded clean (codec hole)")
            if mode is not None:
                raise ConnectionError(
                    f"chaos: mid-stream disconnect from {self.name}")
            yield row

    def readyz(self):
        if self._consult("readyz_probe") is not None:
            raise ConnectionError(
                f"chaos: readyz probe to {self.name} flapped")
        return self.inner.readyz()

    def warm(self, configs):
        return self.inner.warm(configs)

    def snapshot(self) -> dict:
        return self.inner.snapshot()

    def close(self) -> None:
        self.inner.close()
