"""Bounded request queue with shape-bucketed lanes + continuous batching
(the port's own copy of the JAX package's ``serving/batcher.py``).

The throughput regime of an iterated stencil is bandwidth-bound and its
executables are batch-shaped, so the way to serve many small requests
fast is to coalesce them: requests whose :class:`EngineKey` maps to the
same LANE stack on a leading dim and ride one device program.  The
batcher is the queueing half of that bargain; the engine is the compute
half.

Two structural changes over the original drain-between-flushes design:

* **Shape-bucketed lanes.**  ``lane_of(key)`` (the service passes
  ``engine.bucket_key``) maps near-miss keys — same compile identity,
  H×W within one bucket — onto a shared lane, so a 96×120 and a
  100×128 thumbnail co-batch (padded to the bucket, cropped on the way
  out) instead of serializing as two one-item flushes.  Without
  ``lane_of`` every key is its own lane: exact-key batching, the old
  behavior, and what non-EngineKey tests exercise.
* **Mid-flight refill (continuous batching).**  Collection and
  execution are a two-stage pipeline on separate threads: the COLLECTOR
  assembles the next flush (including the host-side ``prepare`` work —
  deadline shedding, pad-to-bucket stacking) while the EXECUTOR still
  runs the previous one on the device.  The old design drained between
  flushes — host stacking and device execution strictly alternated on
  one worker; now the device refills without a flush barrier
  (``pipeline_depth=0`` restores the drain behavior, kept as the A/B
  control arm).

Invariants (held against the JAX package's batcher by
``tests/test_torch_serving.py``):

* **Bounded queue.**  ``try_submit`` refuses (returns None) once
  ``max_queue`` items are pending — admission control happens at the
  door, atomically with the queue, so overflow can never wedge the
  workers or grow memory.  ``depth()`` counts QUEUED items (the
  admission bound); ``max_observed_depth`` additionally counts items
  held in staged/executing flushes, so the high-water mark reflects
  everything the batcher owns, not just the queue.
* **Same-lane only.**  A flush drains only items from one lane (up to
  ``max_batch``); different lanes mean different compiled programs.
  Arrival order within a lane is preserved.
* **Deadline flush.**  A lane's head waits at most ``max_delay_s`` for
  batch-mates (or less, if its own deadline is sooner); a single
  request on an idle service completes in ~``max_delay_s``.
* **Cost-priced lane priority.**  When several lanes are due at once,
  the cheapest head (``payload["cost_units"]``, stamped by the
  service's admission pricer) flushes first, so a large job never
  head-of-line-blocks a thumbnail — with an age backstop: a lane
  overdue by more than ``STARVATION_MULT`` delay windows preempts the
  price order outright.
* **One executor.**  All device execution happens on the single
  executor thread, serializing access to the mesh; handler threads only
  enqueue and wait on their slot, the collector only does host work.

Tracing (round 13): the batcher itself opens no spans — it is the
thread hop.  A request's :class:`obs.trace.SpanContext` rides its
payload (``payload["trace"]``), and the executor derives the
per-request ``queue`` span from this queue's own clocks
(``_Item.enqueued_at`` → flush collect) plus the per-flush ``batch``
span that links every co-batched request (``service.py``).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from parallel_convolution_tpu_torch.obs import metrics as obs_metrics

__all__ = ["MicroBatcher", "Slot"]

# A lane overdue by this many delay windows outranks any price: the
# cost-priced order must never become starvation of expensive work.
STARVATION_MULT = 8.0

# Bound on distinct per-lane gauge labels: adversarially varied shapes
# must not grow /metrics cardinality forever; the overflow bucket
# aggregates the tail.
_LANE_LABEL_CAP = 32


def _lane_label(lane) -> str:
    """A compact, stable exposition label for one lane key."""
    shape = getattr(lane, "shape", None)
    if shape is not None:
        label = "x".join(str(v) for v in shape)
        filt = getattr(lane, "filter_name", "")
        return f"{label}:{filt}" if filt else label
    return str(lane)[:48]


def _area(key) -> int:
    """Pixels one item of ``key`` contributes to a flush (0 = unknown)."""
    shape = getattr(key, "shape", None)
    if not shape:
        return 0
    n = 1
    for v in shape:
        n *= int(v)
    return n


class Slot:
    """One request's result rendezvous (a minimal, stdlib-only future)."""

    __slots__ = ("_event", "_result")

    def __init__(self):
        self._event = threading.Event()
        self._result = None

    def set(self, result) -> None:
        self._result = result
        self._event.set()

    def result(self, timeout: float | None = None):
        """The Response/Rejected once available; None on wait timeout."""
        if not self._event.wait(timeout):
            return None
        return self._result

    def done(self) -> bool:
        return self._event.is_set()


class _Item:
    __slots__ = ("key", "payload", "slot", "enqueued_at", "deadline_at",
                 "units")

    def __init__(self, key, payload, deadline_at, slot=None):
        self.key = key
        self.payload = payload
        # An externally-supplied slot lets the service's request_id dedup
        # ledger hand hedged submissions the SAME rendezvous object.
        self.slot = slot if slot is not None else Slot()
        self.enqueued_at = time.monotonic()
        self.deadline_at = deadline_at  # absolute monotonic, or None
        # Cost-priced priority input (service admission stamps it);
        # non-dict payloads (unit tests) price flat.
        units = 1.0
        if isinstance(payload, dict):
            try:
                units = max(0.0, float(payload.get("cost_units", 1.0)))
            except (TypeError, ValueError):
                units = 1.0
        self.units = units


class MicroBatcher:
    """Coalesce same-lane requests; flush on size or deadline; refill
    the device mid-flight.

    ``execute(lane, items)`` — or ``execute(lane, items, prepared)``
    when ``prepare`` is armed — runs on the executor thread with
    1..max_batch same-lane items and MUST set every item's slot: the
    batcher guarantees delivery attempts, the executor guarantees typed
    results.  ``prepare(lane, items)`` runs on the COLLECTOR thread
    (the host half of the pipeline: deadline shedding, pad-to-bucket
    stacking) and its return value is handed to ``execute`` — that
    overlap of host assembly with device execution IS the continuous
    batching win.
    """

    def __init__(self, execute, *, max_batch: int = 8,
                 max_delay_s: float = 0.005, max_queue: int = 64,
                 start: bool = True, lane_of=None, prepare=None,
                 pipeline_depth: int = 1):
        if max_batch < 1 or max_queue < 1 or max_delay_s < 0:
            raise ValueError("max_batch/max_queue >= 1, max_delay_s >= 0")
        self._execute = execute
        self._prepare = prepare
        self.lane_of = lane_of
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.max_queue = max_queue
        # 0 = drain-between-flushes (the pre-continuous behavior, kept
        # as the A/B control arm); N >= 1 = up to N assembled flushes
        # may wait behind the executing one.
        self.pipeline_depth = max(0, int(pipeline_depth))
        self._cv = threading.Condition()
        self._lanes: OrderedDict[object, deque[_Item]] = OrderedDict()
        self._queued = 0
        self._staged: deque = deque()     # (lane, batch, prepared)
        self._exec_busy = False
        self._executing = 0               # items inside execute right now
        self._closed = False
        self._collector_done = False
        self._collector: threading.Thread | None = None
        self._executor: threading.Thread | None = None
        self._pad_px = 0                  # padded-but-unused pixels
        self._total_px = 0                # pixels across all flushes
        self._lane_labels: set[str] = set()
        # Legacy stats dict as a view over the obs registry
        # (pctpu_batcher_stats{key=...}); dict semantics unchanged.
        self.stats = obs_metrics.MirroredStats(obs_metrics.gauge(
            "pctpu_batcher_stats", "micro-batcher queue/flush counters",
            ("key",)), initial={
            "enqueued": 0, "refused": 0, "flushes": 0,
            "flushed_items": 0, "max_observed_depth": 0,
            "refills": 0, "lanes": 0, "pad_waste_ratio": 0.0})
        self._depth_gauge = obs_metrics.gauge(
            "pctpu_queue_depth", "pending requests in the batcher queue")
        self._lane_gauge = obs_metrics.gauge(
            "pctpu_lane_depth",
            "queued requests per shape-bucketed batcher lane", ("lane",))
        if start:
            self.start()

    # -- producer side -------------------------------------------------------
    def try_submit(self, key, payload, deadline_at=None,
                   slot: Slot | None = None) -> Slot | None:
        """Enqueue; returns the item's :class:`Slot`, or None when the
        queue is full or the batcher closed (the caller sheds load).
        ``slot`` substitutes a caller-owned rendezvous (dedup ledger)."""
        item = _Item(key, payload, deadline_at, slot=slot)
        lane = self.lane_of(key) if self.lane_of is not None else key
        with self._cv:
            if self._closed or self._queued >= self.max_queue:
                self.stats["refused"] += 1
                return None
            q = self._lanes.get(lane)
            if q is None:
                q = self._lanes[lane] = deque()
            q.append(item)
            self._queued += 1
            # The high-water mark counts EVERYTHING the batcher owns:
            # queued + staged + executing.  The old queue-only reading
            # undercounted under continuous batching, where a full
            # flush can be in the pipeline while the queue looks short.
            self.stats["max_observed_depth"] = max(
                self.stats["max_observed_depth"],
                self._queued + self._inflight_locked())
            self.stats["enqueued"] += 1
            self.stats["lanes"] = len(self._lanes)
            self._depth_gauge.set(self._queued)
            self._set_lane_depth(lane, len(q))
            self._cv.notify_all()
        return item.slot

    def depth(self) -> int:
        """QUEUED items — the admission-bound reading (in-flight items
        already left the queue; ``max_observed_depth`` counts them)."""
        with self._cv:
            return self._queued

    def _inflight_locked(self) -> int:
        return self._executing + sum(len(b) for _, b, _ in self._staged)

    def _set_lane_depth(self, lane, n: int) -> None:
        label = _lane_label(lane)
        if label not in self._lane_labels:
            if len(self._lane_labels) >= _LANE_LABEL_CAP:
                label = "overflow"
            self._lane_labels.add(label)
        if n > 0:
            self._lane_gauge.set(n, lane=label)
            self.stats[f"lane_depth:{label}"] = n  # stats-lock: held by callers (_cv)
        else:
            self._lane_gauge.remove(lane=label)
            self.stats.pop(f"lane_depth:{label}", None)
            self._lane_labels.discard(label)

    # -- worker side ---------------------------------------------------------
    def start(self) -> None:
        if self._collector is None or not self._collector.is_alive():
            self._collector_done = False
            self._collector = threading.Thread(
                target=self._collector_loop, name="pctpu-batcher-collect",
                daemon=True)
            self._collector.start()
        if self._executor is None or not self._executor.is_alive():
            self._executor = threading.Thread(
                target=self._executor_loop, name="pctpu-batcher-exec",
                daemon=True)
            self._executor.start()

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting; optionally wait for queue + pipeline to
        drain (both stages exit after flushing everything pending)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if not drain:
            return
        deadline = time.monotonic() + timeout
        for t in (self._collector, self._executor):
            if t is not None and t.is_alive():
                t.join(max(0.0, deadline - time.monotonic()))

    # -- collector stage ------------------------------------------------------
    def _room_locked(self) -> bool:
        """May the collector assemble another flush right now?  Drain
        mode (depth 0) waits for an IDLE pipeline — the old barrier;
        pipelined mode keeps up to ``pipeline_depth`` flushes staged."""
        if self.pipeline_depth == 0:
            return not self._staged and not self._exec_busy
        return len(self._staged) < self.pipeline_depth

    def _pick_lane_locked(self, now: float):
        """``(due_lane_or_None, earliest_due_at)`` under the lock.

        A lane is due when its head aged past ``max_delay_s``, its head
        cannot afford the batching window (deadline sooner than the
        flush — flush NOW rather than gamble its remaining budget on
        hypothetical batch-mates), it holds a full batch, or the
        batcher is closed (final drain).  Among several due lanes the
        cheapest head wins (cost-priced priority), except a badly
        overdue head (STARVATION_MULT windows) which wins on age.
        """
        best = None
        best_score = None
        earliest = None
        for lane, q in self._lanes.items():
            head = q[0]
            flush_at = head.enqueued_at + self.max_delay_s
            if head.deadline_at is not None and head.deadline_at < flush_at:
                flush_at = head.enqueued_at
            if len(q) >= self.max_batch or self._closed:
                flush_at = now
            if flush_at <= now:
                overdue = (now - head.enqueued_at
                           > STARVATION_MULT * self.max_delay_s)
                score = ((0, head.enqueued_at, 0.0) if overdue
                         else (1, head.units, head.enqueued_at))
                if best_score is None or score < best_score:
                    best, best_score = lane, score
            elif earliest is None or flush_at < earliest:
                earliest = flush_at
        return best, earliest

    def _pop_batch_locked(self, lane) -> list[_Item]:
        q = self._lanes[lane]
        batch = [q.popleft() for _ in range(min(self.max_batch, len(q)))]
        if not q:
            del self._lanes[lane]
        self._queued -= len(batch)
        self.stats["flushes"] += 1  # stats-lock: held by caller (_cv)
        self.stats["flushed_items"] += len(batch)  # stats-lock: held by caller (_cv)
        self.stats["lanes"] = len(self._lanes)  # stats-lock: held by caller (_cv)
        self._depth_gauge.set(self._queued)
        self._set_lane_depth(lane, len(q) if q else 0)
        # Pad-waste accounting: a mixed-shape flush executes at the
        # lane's bucket extent; the difference is padded throwaway.
        lane_px = _area(lane)
        if lane_px:
            useful = sum(_area(it.key) or lane_px for it in batch)
            total = lane_px * len(batch)
            uniform = all(it.key == batch[0].key for it in batch)
            self._total_px += (useful if uniform else total)
            if not uniform:
                self._pad_px += total - useful
            self.stats["pad_waste_ratio"] = round(  # stats-lock: held by caller (_cv)
                self._pad_px / self._total_px, 4) if self._total_px else 0.0
        return batch

    def _collect(self):
        """Block until a flush is due AND the pipeline has room;
        returns (lane, items) or None when closed and drained."""
        with self._cv:
            while True:
                if not self._room_locked():
                    self._cv.wait(timeout=0.05)
                    continue
                if not self._queued:
                    if self._closed:
                        return None
                    self._cv.wait(timeout=0.1)
                    continue
                now = time.monotonic()
                lane, earliest = self._pick_lane_locked(now)
                if lane is not None:
                    batch = self._pop_batch_locked(lane)
                    self._cv.notify_all()
                    return lane, batch
                wait = 0.1 if earliest is None else min(
                    0.1, max(0.0, earliest - now))
                self._cv.wait(timeout=wait or 0.001)

    def _collector_loop(self) -> None:
        try:
            while True:
                got = self._collect()
                if got is None:
                    return
                lane, batch = got
                prepared = None
                if self._prepare is not None:
                    try:
                        # Host-side assembly OUTSIDE the lock: this is
                        # the work that overlaps the executing flush.
                        prepared = self._prepare(lane, batch)
                    except BaseException as e:  # noqa: BLE001
                        for it in batch:
                            if not it.slot.done():
                                it.slot.set(e)
                        continue
                with self._cv:
                    self._staged.append((lane, batch, prepared))
                    if self._exec_busy or len(self._staged) > 1:
                        # The device (executor) was already occupied
                        # when this flush became ready: a mid-flight
                        # refill, the no-barrier proof counter.
                        self.stats["refills"] += 1
                    self._cv.notify_all()
        finally:
            with self._cv:
                self._collector_done = True
                self._cv.notify_all()

    # -- executor stage --------------------------------------------------------
    def _executor_loop(self) -> None:
        while True:
            with self._cv:
                while not self._staged:
                    if self._closed and self._collector_done:
                        return
                    self._cv.wait(timeout=0.1)
                lane, batch, prepared = self._staged.popleft()
                self._exec_busy = True
                self._executing = len(batch)
                self._cv.notify_all()
            try:
                if self._prepare is not None:
                    self._execute(lane, batch, prepared)
                else:
                    self._execute(lane, batch)
            except BaseException as e:  # noqa: BLE001 — never kill the worker
                # The executor's contract is typed results; if it leaked
                # an exception anyway, fail its items rather than hanging
                # their waiters (and keep serving subsequent batches).
                for it in batch:
                    if not it.slot.done():
                        it.slot.set(e)
            finally:
                with self._cv:
                    self._exec_busy = False
                    self._executing = 0
                    self._cv.notify_all()
