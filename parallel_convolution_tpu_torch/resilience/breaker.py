"""Per-replica circuit breaker: passive health from typed failures.

The replica router's ACTIVE health signal is the ``/readyz`` poll; this
is the PASSIVE one — the router observes every dispatch outcome anyway,
so consecutive failures against one replica should stop traffic to it
*between* polls (a poll interval is an eternity at request rate).

State walk (the classic three states, deterministic and clock-injectable
so tests drive it without sleeping):

* **closed** — healthy; every request allowed.  ``threshold``
  consecutive failures (successes reset the count) trip it to open.
* **open** — no requests for ``cooldown_s``; the router spills this
  replica's keys to the next ring replica.  After the cooldown the next
  ``allow()`` transitions to half-open and admits exactly ONE probe.
* **half_open** — one in-flight probe decides: success closes the
  breaker, failure re-opens it for another cooldown.  A probe that never
  reports (a wedged transport) stops blocking after ``cooldown_s`` —
  the breaker must degrade to polling, never deadlock the replica out
  of the ring forever.

Failure *classification* reuses :func:`resilience.retry.classify`: a
TERMINAL exception (ValueError-class contract bugs) is the *request's*
fault, not the replica's, and does not count against the breaker —
exactly the taxonomy split the retry layer already encodes.  Transport
errors (ConnectionError, timeouts, RPC loss) classify transient and do
count: those are the replica-down signals.

stdlib-only; the port's own copy of the JAX package's ``resilience/breaker.py``.
"""

from __future__ import annotations

import threading
import time

from parallel_convolution_tpu_torch.resilience.retry import TERMINAL, classify

__all__ = ["CLOSED", "HALF_OPEN", "OPEN", "CircuitBreaker"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing.

    ``allow()`` is the gate the router consults immediately before a
    dispatch it is otherwise committed to (calling it consumes the
    half-open probe slot, so don't use it as a passive peek — that's
    :meth:`state`); ``record_success``/``record_failure`` report the
    dispatch outcome.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 2.0,
                 clock=time.monotonic):
        if threshold < 1 or cooldown_s < 0:
            raise ValueError("threshold >= 1 and cooldown_s >= 0 required")
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0           # consecutive, reset on success
        self._opened_at = 0.0
        self._probe_at: float | None = None  # half-open probe launch time
        self.stats = {"opened": 0, "closed": 0, "probes": 0}

    # -- the gate ------------------------------------------------------------
    def allow(self) -> bool:
        """May the router dispatch to this replica right now?

        In OPEN past the cooldown this transitions to HALF_OPEN and
        grants the single probe slot; in HALF_OPEN the slot re-arms only
        after ``cooldown_s`` without a verdict (wedged-probe guard).
        """
        with self._lock:
            if self._state == CLOSED:
                return True
            now = self._clock()
            if self._state == OPEN:
                if now - self._opened_at < self.cooldown_s:
                    return False
                self._state = HALF_OPEN
                self._probe_at = now
                self.stats["probes"] += 1
                return True
            # HALF_OPEN: one probe at a time, re-armed if it went silent.
            if (self._probe_at is not None
                    and now - self._probe_at < self.cooldown_s):
                return False
            self._probe_at = now
            self.stats["probes"] += 1
            return True

    # -- outcome reports -----------------------------------------------------
    def record_success(self) -> None:
        with self._lock:
            if self._state != CLOSED:
                self.stats["closed"] += 1
            self._state = CLOSED
            self._failures = 0
            self._probe_at = None

    def record_failure(self, exc: BaseException | None = None) -> None:
        """Count one dispatch failure.  A TERMINAL-classified exception
        (the request's own contract bug) never counts — the breaker
        watches replica health, not request validity."""
        if exc is not None and classify(exc) == TERMINAL:
            return
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN or self._failures >= self.threshold:
                if self._state != OPEN:
                    # Straggler failures reported while already OPEN
                    # (in-flight requests draining after the kill) must
                    # NOT restart the cooldown — the half-open probe is
                    # due cooldown_s after the TRANSITION, not after the
                    # last straggler.
                    self.stats["opened"] += 1
                    self._opened_at = self._clock()
                self._state = OPEN
                self._probe_at = None

    # -- introspection -------------------------------------------------------
    def state(self) -> str:
        """The current state WITHOUT consuming a probe slot (open
        breakers past their cooldown still report ``open`` here — the
        transition happens in :meth:`allow`)."""
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state, "failures": self._failures,
                    **self.stats}
