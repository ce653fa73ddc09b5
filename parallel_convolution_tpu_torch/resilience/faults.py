"""Seeded, process-global fault plan with named injection sites.

Library code consults :func:`fault_point` at the places our operational
history shows failures actually occur (the site registry below maps 1:1
onto observed outage modes).  With no plan installed the hook is a single
global load + ``is None`` test — zero overhead on every hot path, safe to
leave in production code.  With a plan installed, each consult increments
the site's hit counter and raises :class:`InjectedFault` when the plan's
rule for that site triggers — deterministically (hit-indexed rules) or
pseudo-randomly from the plan seed (probability rules), so every failure
a test injects is replayable bit-for-bit.

Spec grammar (env ``PCTPU_FAULTS``, seed ``PCTPU_FAULT_SEED``)::

    site:TRIGGER[!][,site:TRIGGER[!]...]

    TRIGGER :=  N      fail exactly the N-th hit (1-based)
             |  N+     fail every hit from the N-th on
             |  *      fail every hit
             |  pX     fail each hit with probability X (plan-seeded)
    !        := classify the fault terminal instead of transient

Examples::

    checkpoint_write_shard:2        # tear the snapshot at the 2nd shard
    backend_compile:1               # first compile dies (tunnel blip)
    halo_exchange:p0.1,io_read:3+   # flaky fabric + dead file handle
    backend_compile:1!              # a compile failure retry can't heal

The PyTorch port's own copy of the JAX package's
``resilience/faults.py``: the same grammar, sites and seeded draws, so a
spec and seed fire the same hits in both packages.  Stdlib only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading

# One name per observed outage mode; specs naming anything else are
# rejected up front so a typo'd site can't silently never fire.  The JAX
# package's registry, whole, so that every spec it takes parses here too
# (tests/test_torch_resilience.py holds the two tables equal and every
# consult in the port to a registered site).  The port consults the
# compute and IO sites; the transport, WAL, cache, events and evidence
# sites come with serving (ROADMAP items 8, 9).
SITE_TABLE = {
    "backend_compile":        "tracing/compiling an iteration runner",
    "halo_exchange":          "building the exchange (ppermute or RDMA)",
    "checkpoint_write_shard": "before each per-shard .npy write",
    "checkpoint_write_meta":  "before meta.json, and before the LATEST flip",
    "device_probe":           "backend liveness probe (the tunnel check)",
    "io_read":                "sharded block read from disk",
    "transport_send":         "router→replica request leaving the client "
                              "(drop / latency / black-hole: the work "
                              "never reaches the replica)",
    "transport_recv":         "replica→router response on the way back "
                              "(drop / corrupt: the work EXECUTED but the "
                              "response is lost or unparseable — the "
                              "idempotency-ledger case)",
    "transport_stream":       "one progressive NDJSON row in flight "
                              "(mid-stream disconnect after best-so-far "
                              "rows already landed — the resume case)",
    "readyz_probe":           "active-health /readyz poll (flapping "
                              "readiness: the router's routing input lies)",
    "wal_write":              "before appending one record to the router "
                              "WAL (serving/wal.py — a failed append "
                              "degrades durability loudly, never serving)",
    "wal_fsync":              "before fsyncing the WAL after an append "
                              "(the record is written but not yet durable "
                              "when this fires)",
    "router_kill":            "drill poll: the moment the router process "
                              "dies (drills consult it per streamed row "
                              "via serving.chaos.router_kill_due and "
                              "convert the verdict into an abandoned "
                              "stream + a WAL takeover)",
    "cache_spill":            "before spilling one result-cache entry to "
                              "its disk tier (serving/cache.py — a failed "
                              "spill demotes the disk tier, never serves "
                              "bad bytes)",
    "cache_promote":          "before reading one disk-tier cache entry "
                              "back on a hit (a failed promote is a loud "
                              "journaled miss, never a stale serve)",
    "events_emit":            "before writing one obs event line "
                              "(obs/events.py — a failed write counts a "
                              "dropped line instead of raising into the "
                              "serving path)",
    "evidence_write":         "before writing/replacing an evidence file "
                              "(utils/evidence_io.py — smoke legs surface "
                              "the failure typed instead of tearing a "
                              "shared curve)",
}
KNOWN_SITES = frozenset(SITE_TABLE)


class InjectedFault(RuntimeError):
    """A deliberately injected failure; carries its retry classification."""

    def __init__(self, site: str, hit: int, transient: bool = True):
        super().__init__(
            f"injected fault at {site!r} (hit {hit}, "
            f"{'transient' if transient else 'terminal'})"
        )
        self.site = site
        self.hit = hit
        self.transient = transient


@dataclasses.dataclass(frozen=True)
class _Rule:
    """One site's trigger: hit index / open range / every / probability."""

    at: int | None = None      # fail exactly this 1-based hit
    from_: int | None = None   # fail this hit and every later one
    every: bool = False        # fail all hits
    prob: float | None = None  # fail each hit with this probability
    terminal: bool = False

    def fires(self, hit: int, rng: random.Random) -> bool:
        if self.every:
            return True
        if self.at is not None:
            return hit == self.at
        if self.from_ is not None:
            return hit >= self.from_
        return rng.random() < (self.prob or 0.0)


class FaultPlan:
    """Immutable rules + mutable per-site hit counters (thread-safe)."""

    def __init__(self, rules: dict[str, _Rule], seed: int = 0):
        unknown = set(rules) - KNOWN_SITES
        if unknown:
            raise ValueError(
                f"unknown fault site(s) {sorted(unknown)}; "
                f"known: {sorted(KNOWN_SITES)}"
            )
        self.rules = dict(rules)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._hits: dict[str, int] = {}
        self._fired: list[tuple[str, int]] = []
        self._lock = threading.Lock()

    def check(self, site: str) -> None:
        rule = self.rules.get(site)
        if rule is None:
            return  # un-spec'd sites are not even counted: keeps plans O(spec)
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            fire = rule.fires(hit, self._rng)
            if fire:
                self._fired.append((site, hit))
        if fire:
            # Telemetry before the raise: the timeline shows the trigger
            # even when the fault kills the run.  Imported here: obs.events
            # imports this module (its events_emit site).
            from parallel_convolution_tpu_torch.obs import events, metrics

            if metrics.enabled():
                metrics.counter(
                    "pctpu_faults_fired_total",
                    "injected faults that actually raised, per site",
                    ("site",)).inc(site=site)
                events.emit("fault_trigger", site=site, hit=hit,
                            transient=not rule.terminal)
            raise InjectedFault(site, hit, transient=not rule.terminal)

    @property
    def fired(self) -> list[tuple[str, int]]:
        """(site, hit) pairs that actually raised, in order — for asserts."""
        with self._lock:
            return list(self._fired)

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)


def _parse_rule(text: str) -> _Rule:
    terminal = text.endswith("!")
    body = text[:-1] if terminal else text
    if body == "*":
        return _Rule(every=True, terminal=terminal)
    if body.startswith("p"):
        p = float(body[1:])
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"fault probability must be in [0,1], got {p}")
        return _Rule(prob=p, terminal=terminal)
    if body.endswith("+"):
        n = int(body[:-1])
        if n < 1:
            raise ValueError(f"hit index must be >= 1, got {n}")
        return _Rule(from_=n, terminal=terminal)
    n = int(body)
    if n < 1:
        raise ValueError(f"hit index must be >= 1, got {n}")
    return _Rule(at=n, terminal=terminal)


def plan_from_spec(spec: str, seed: int = 0) -> FaultPlan:
    """Parse the ``site:TRIGGER,...`` grammar (see module docstring)."""
    rules: dict[str, _Rule] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if ":" not in part:
            raise ValueError(
                f"bad fault spec {part!r}: expected site:TRIGGER"
            )
        site, trig = part.split(":", 1)
        try:
            rules[site.strip()] = _parse_rule(trig.strip())
        except ValueError as e:
            raise ValueError(f"bad fault spec {part!r}: {e}") from e
    if not rules:
        raise ValueError(f"empty fault spec {spec!r}")
    return FaultPlan(rules, seed=seed)


def plan_from_env(env: dict | None = None) -> FaultPlan | None:
    """Build a plan from ``PCTPU_FAULTS`` / ``PCTPU_FAULT_SEED`` (or None)."""
    env = os.environ if env is None else env
    spec = env.get("PCTPU_FAULTS", "").strip()
    if not spec:
        return None
    return plan_from_spec(spec, seed=int(env.get("PCTPU_FAULT_SEED", "0")))


# The process-global plan. fault_point() reads it without a lock: plans
# are installed before the workload starts, and a torn read can only see
# None or a fully constructed plan (CPython attribute store is atomic).
_PLAN: FaultPlan | None = None


def install_plan(plan: FaultPlan | str | None, seed: int = 0) -> FaultPlan | None:
    """Install ``plan`` (a FaultPlan or a spec string) globally; returns it."""
    global _PLAN
    if isinstance(plan, str):
        plan = plan_from_spec(plan, seed=seed)
    _PLAN = plan
    return plan


def uninstall_plan() -> None:
    global _PLAN
    _PLAN = None


def install_from_env(env: dict | None = None) -> FaultPlan | None:
    """Entry-point hook: honor ``PCTPU_FAULTS`` if set (else no-op)."""
    plan = plan_from_env(env)
    if plan is not None:
        install_plan(plan)
    return plan


@contextlib.contextmanager
def injected(plan: FaultPlan | str | None, seed: int = 0):
    """Scoped installation for tests; always restores the previous plan."""
    global _PLAN
    prev = _PLAN
    installed = install_plan(plan, seed=seed)
    try:
        yield installed
    finally:
        _PLAN = prev


def fault_point(site: str) -> None:
    """Consult the active fault plan at a named site.

    THE hot-path contract: with no plan installed this is one global load
    and an ``is None`` test — nothing is counted, allocated, or locked, so
    the hook is free to sit in compile paths and per-shard I/O loops.
    """
    plan = _PLAN
    if plan is not None:
        plan.check(site)
