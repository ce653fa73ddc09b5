"""Sharded control plane — N active routers over one partitioned ring.

The WAL made the single router crash-safe (fenced takeover); this
module removes it as the single point of failure AND the
throughput ceiling, the same way the stencil papers decompose the
domain: the consistent-hash key space is partitioned into ``n_shards``
contiguous ownership units, each owned by one ACTIVE router with its
own WAL lineage and epoch (``serving/wal.py`` with ``shard=``), so
recovery of one shard never blocks — or quarantines — the others.

Pieces:

* :func:`shard_of` — the stable key→shard partition (SHA-1, like
  :class:`HashRing`'s placement, so every router and client computes
  the same answer with no coordination).
* :class:`ShardMap` — who owns which shard, at which epoch.  The map
  VERSION is the sum of the per-shard epochs: monotonic under
  takeovers (a takeover bumps that shard's epoch), identical on every
  converged peer, and needs no counter coordination.  Merging is
  per-shard higher-epoch-wins — the WAL lineage's fencing epoch is
  the single source of ownership truth.
* :class:`DebtLog` — seq-numbered tenant-debt deltas for fleet-wide
  quota enforcement: every local charge/refund appends ``(seq,
  tenant, delta)``; peers pull deltas since their cursor and ABSORB
  them into their own buckets (no journal echo, no re-replication).
  A cursor that fell off the bounded log gets a cumulative-totals
  reset instead of silent loss.
* :class:`InProcessPeer` / :class:`HTTPPeer` — the peer links (the
  drills' in-process twin and the deployment's ``POST /v1/peersync``).
* :class:`ShardRouter` — one active router process: a
  :class:`~parallel_convolution_tpu_torch.serving.router.ReplicaRouter` per
  OWNED shard (each over its own WAL lineage, all sharing one
  :class:`TenantQuotas`), typed ``wrong_shard`` (421, retryable)
  redirects for keys it does not own, versioned anti-entropy pulls
  from its peers, and — the headline — cross-shard fenced TAKEOVER:
  when a peer stops answering, the deterministic successor re-opens
  each orphaned WAL lineage (the WAL takeover: epoch bump, per-shard
  ``/v1/fence`` sweep, zombie writes rejected typed ``stale_epoch``,
  interrupted converge jobs resumed byte-identically from their
  newest durable token) while every other shard keeps serving.
* :class:`ShardClient` — the client half of the contract: fetch the
  version-stamped shard map from any router, route straight to the
  owner, and on a ``wrong_shard``/``stale_epoch`` typed reject refresh
  the map and retry — a takeover is client-observable, never a client
  failure.

stdlib-only, torch-free, like the rest of the control plane.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import deque
from pathlib import Path

from parallel_convolution_tpu_torch.obs import events as obs_events
from parallel_convolution_tpu_torch.obs import metrics as obs_metrics
from parallel_convolution_tpu_torch.serving.router import (
    ReplicaRouter,
    TenantQuotas,
    route_key,
)

__all__ = ["DebtLog", "HTTPPeer", "InProcessPeer", "ShardClient",
           "ShardMap", "ShardRouter", "shard_of", "wal_path"]

# Typed rejects that tell a shard-aware client its routing state is
# stale (refresh the map and retry) rather than "the job failed".
_REROUTE_REJECTS = frozenset({"wrong_shard", "stale_epoch"})


def shard_of(key: str, n_shards: int) -> str:
    """The stable key→shard assignment.  SHA-1 over the route key (the
    same digest family as HashRing placement): every router and client
    computes the identical partition with no coordination."""
    h = hashlib.sha1(str(key).encode("utf-8")).digest()
    return str(int.from_bytes(h[:8], "big") % max(1, int(n_shards)))


def wal_path(state_dir, shard: str) -> Path:
    """One shard's WAL lineage file.  The name ends ``.wal`` on
    purpose: RouterWAL refuses lineage names with a trailing numeric
    suffix (they collide with rotated-generation naming when sibling
    lineages share the directory)."""
    return Path(state_dir) / f"shard-{shard}.wal"


class ShardMap:
    """Who owns which shard, at which fencing epoch.

    ``version`` is DERIVED: the sum of per-shard epochs.  Takeovers
    bump the orphaned shard's epoch (the WAL takeover), so the
    version is monotonic, convergent, and coordination-free; two peers
    with the same version hold the same ownership map (per-shard
    higher-epoch-wins merging makes epoch the single authority)."""

    def __init__(self, n_shards: int):
        self.n_shards = int(n_shards)
        # shard -> {"owner": router name, "addr": url|None, "epoch": int}
        self.shards: dict[str, dict] = {}
        self._lock = threading.Lock()

    def seed(self, shard: str, owner: str, addr=None, epoch: int = 0):
        with self._lock:
            self.shards[str(shard)] = {
                "owner": str(owner),
                "addr": None if addr is None else str(addr),
                "epoch": int(epoch)}

    def version(self) -> int:
        with self._lock:
            return sum(int(e.get("epoch", 0)) for e in
                       self.shards.values())

    def owner(self, shard: str) -> dict | None:
        with self._lock:
            e = self.shards.get(str(shard))
            return None if e is None else dict(e)

    def set_owner(self, shard: str, owner: str, epoch: int,
                  addr=None) -> bool:
        """Record ``owner`` at ``epoch`` for ``shard`` iff ``epoch``
        is NEWER than what we hold (epoch is the authority — a stale
        gossip echo can never roll ownership back).  Returns True if
        the map changed."""
        s = str(shard)
        with self._lock:
            cur = self.shards.get(s)
            if cur is not None and int(epoch) <= int(cur["epoch"]):
                return False
            self.shards[s] = {"owner": str(owner),
                              "addr": (None if addr is None
                                       else str(addr)),
                              "epoch": int(epoch)}
            return True

    def merge(self, wire: dict) -> bool:
        """Fold a peer's map in (per-shard higher-epoch-wins).
        Returns True if anything changed."""
        changed = False
        for shard, entry in dict(wire.get("shards") or {}).items():
            try:
                changed |= self.set_owner(
                    shard, str(entry.get("owner", "")),
                    int(entry.get("epoch", 0)),
                    addr=entry.get("addr"))
            except (TypeError, ValueError):
                continue
        return changed

    def to_wire(self) -> dict:
        with self._lock:
            return {
                "version": sum(int(e.get("epoch", 0))
                               for e in self.shards.values()),
                "n_shards": self.n_shards,
                "shards": {s: dict(e) for s, e in self.shards.items()},
            }


class DebtLog:
    """Seq-numbered tenant-debt deltas, one log per ORIGIN router.

    Every local quota charge (+) / refund (−) appends ``(seq, tenant,
    delta)``.  Peers pull ``since(cursor)`` and absorb the deltas into
    their own buckets — fleet-wide quota enforcement without a shared
    store.  The log is count-bounded; a cursor older than the retained
    window gets a RESET reply carrying the cumulative per-tenant
    totals, from which the puller reconstructs the missed difference
    (it tracks what it already applied per origin)."""

    def __init__(self, cap: int = 4096):
        self.cap = int(cap)
        self._deltas: deque = deque()   # (seq, tenant, delta)
        self._seq = 0
        self._totals: dict[str, float] = {}
        self._lock = threading.Lock()

    def record(self, tenant: str, delta: float) -> int:
        with self._lock:
            self._seq += 1
            self._deltas.append((self._seq, str(tenant), float(delta)))
            t = str(tenant)
            self._totals[t] = self._totals.get(t, 0.0) + float(delta)
            while len(self._deltas) > self.cap:
                self._deltas.popleft()
            return self._seq

    def since(self, cursor: int) -> dict:
        """The anti-entropy reply body for one origin: either the
        deltas after ``cursor``, or a totals RESET when the cursor
        fell off the bounded window."""
        c = int(cursor)
        with self._lock:
            floor = self._deltas[0][0] - 1 if self._deltas else self._seq
            if c < floor:
                return {"reset": True, "seq": self._seq,
                        "totals": {t: round(v, 9)
                                   for t, v in self._totals.items()}}
            return {"reset": False, "seq": self._seq,
                    "deltas": [[s, t, round(d, 9)]
                               for (s, t, d) in self._deltas if s > c]}

    def snapshot(self) -> dict:
        with self._lock:
            return {"seq": self._seq, "retained": len(self._deltas),
                    "tenants": len(self._totals)}


class InProcessPeer:
    """A peer link to another :class:`ShardRouter` in the same process
    (the drills' transport).  ``kill()`` makes every sync raise —
    the in-process stand-in for SIGKILL."""

    def __init__(self, target):
        self._target = target
        self.name = target.name
        self._dead = False

    def kill(self) -> None:
        self._dead = True

    def sync(self, payload: dict) -> dict:
        if self._dead or getattr(self._target, "_dead", False):
            raise ConnectionError(f"peer {self.name} is dead")
        return self._target.handle_peersync(dict(payload))

    def shardmap(self) -> dict:
        if self._dead or getattr(self._target, "_dead", False):
            raise ConnectionError(f"peer {self.name} is dead")
        return self._target.shardmap_wire()


class HTTPPeer:
    """A peer link over the existing HTTP plane (``POST /v1/peersync``
    + ``GET /v1/shardmap`` on the peer's router frontend)."""

    def __init__(self, name: str, url: str, timeout: float = 2.0):
        self.name = str(name)
        self.base = url.rstrip("/")
        self.timeout = float(timeout)

    def sync(self, payload: dict) -> dict:
        import urllib.request

        req = urllib.request.Request(
            self.base + "/v1/peersync",
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def shardmap(self) -> dict:
        import urllib.request

        with urllib.request.urlopen(self.base + "/v1/shardmap",
                                    timeout=self.timeout) as r:
            return json.loads(r.read())


class ShardRouter:
    """One active router in an N-router fleet (see module docstring).

    ``transports`` is the replica pool (shared by every owned shard's
    sub-router — the DATA plane is common; only control-plane
    ownership is partitioned).  ``owned`` is the iterable of shard
    labels this router boots owning; ``assignments`` maps EVERY shard
    label to its boot owner name so redirects can name the owner
    before the first peer sync.  ``peers`` are the links
    (:class:`InProcessPeer` / :class:`HTTPPeer`).  Each owned shard
    gets its own WAL lineage at ``wal_path(state_dir, shard)`` —
    constructing the sub-router over an existing lineage IS the
    fenced takeover.
    """

    def __init__(self, name: str, transports, *, n_shards: int,
                 owned, state_dir, assignments=None, addrs=None,
                 quotas: TenantQuotas | None = None, pricer=None,
                 peers=(), sync_interval_s: float = 0.25,
                 suspect_after: int = 3, start_sync: bool = True,
                 wal_fsync: bool = True, clock=time.monotonic,
                 **router_kwargs):
        self.name = str(name)
        self.n_shards = int(n_shards)
        self.state_dir = Path(state_dir)
        self.quotas = quotas
        self.clock = clock
        self.peers = list(peers)
        self.sync_interval_s = float(sync_interval_s)
        self.suspect_after = int(suspect_after)
        self._addrs = dict(addrs or {})
        self._dead = False
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self.debts = DebtLog()
        # Per-origin pull cursors + per-origin/tenant applied sums (the
        # reset-reply reconstruction input).
        self._cursors: dict[str, int] = {}
        self._applied: dict[str, dict[str, float]] = {}
        self._misses: dict[str, int] = {}
        self._taken_over: set[str] = set()
        self.map = ShardMap(self.n_shards)
        for shard, owner in dict(assignments or {}).items():
            self.map.seed(shard, owner, addr=self._addrs.get(owner))
        self.stats = {"peer_syncs": 0, "peer_sync_errors": 0,
                      "wrong_shard": 0, "takeovers": 0,
                      "debt_deltas_absorbed": 0, "map_merges": 0}
        self._transports = list(transports)
        self._router_kwargs = dict(router_kwargs)
        self._pricer = pricer
        self._wal_fsync = bool(wal_fsync)
        self._sub: dict[str, ReplicaRouter] = {}
        for shard in owned:
            self._open_shard(str(shard))
        self._publish_map()
        self._sync_thread: threading.Thread | None = None
        if start_sync and self.peers:
            self.start_sync()

    # -- shard lifecycle ------------------------------------------------------
    def _open_shard(self, shard: str) -> ReplicaRouter:
        """Construct the sub-router that owns ``shard`` — over a fresh
        lineage at boot, over an ORPHANED one during takeover (the
        fenced recovery runs inside ReplicaRouter._recover: epoch
        bump past the WAL's and every replica's fence, per-shard fence
        sweep, durable jobs re-seeded)."""
        from parallel_convolution_tpu_torch.serving.wal import RouterWAL

        wal = RouterWAL(wal_path(self.state_dir, shard), shard=shard,
                        fsync=self._wal_fsync)
        sub = ReplicaRouter(
            self._transports, quotas=self.quotas, pricer=self._pricer,
            shard=shard, wal=wal, on_debt=self._on_debt,
            clock=self.clock, **self._router_kwargs)
        self._sub[shard] = sub
        self.map.set_owner(shard, self.name, sub.epoch,
                           addr=self._addrs.get(self.name))
        return sub

    def _publish_map(self) -> None:
        """Push the current map version onto every owned sub-router so
        response ``router:`` stamps carry it."""
        v = self.map.version()
        for sub in self._sub.values():
            sub.map_version = v

    def _on_debt(self, tenant: str, delta: float) -> None:
        """Every local quota charge/refund lands in the origin debt
        log for the peers to pull (fleet-wide quota enforcement)."""
        self.debts.record(tenant, delta)

    # -- the serving surface --------------------------------------------------
    def _route_shard(self, body: dict) -> str:
        return shard_of(route_key(dict(body)), self.n_shards)

    def _wrong_shard_wire(self, body: dict, shard: str) -> dict:
        ent = self.map.owner(shard) or {}
        with self._lock:
            self.stats["wrong_shard"] += 1
        return {
            "ok": False, "rejected": "wrong_shard", "retryable": True,
            "request_id": str(body.get("request_id") or ""),
            "shard": shard, "owner": ent.get("owner", ""),
            "owner_addr": ent.get("addr"),
            "map_version": self.map.version(),
            "detail": f"key shard {shard} is owned by "
                      f"{ent.get('owner', '?')!r}, not {self.name!r}; "
                      "refresh /v1/shardmap and retry at the owner",
        }

    def request(self, body: dict, timeout: float | None = None,
                tenant: str | None = None):
        if self._dead:
            raise ConnectionError(f"router {self.name} is dead")
        shard = self._route_shard(body)
        sub = self._sub.get(shard)
        if sub is None:
            return 421, self._wrong_shard_wire(body, shard)
        return sub.request(body, timeout=timeout, tenant=tenant)

    def converge(self, body: dict, timeout: float | None = None,
                 tenant: str | None = None):
        if self._dead:
            raise ConnectionError(f"router {self.name} is dead")
        shard = self._route_shard(body)
        sub = self._sub.get(shard)
        if sub is None:
            wire = self._wrong_shard_wire(body, shard)
            wire["kind"] = "rejected"
            return 421, iter([wire])
        return sub.converge(body, timeout=timeout, tenant=tenant)

    # -- peer anti-entropy ----------------------------------------------------
    def shardmap_wire(self) -> dict:
        """``GET /v1/shardmap``: the version-stamped ownership map any
        client can fetch from any router."""
        # Refresh our own shards' epochs first (cheap; epochs only
        # move on takeover but the map might have been seeded at 0).
        for shard, sub in self._sub.items():
            self.map.set_owner(shard, self.name, sub.epoch,
                               addr=self._addrs.get(self.name))
        wire = self.map.to_wire()
        wire["ok"] = True
        wire["from"] = self.name
        return wire

    def handle_peersync(self, payload: dict) -> dict:
        """``POST /v1/peersync``: a peer's versioned anti-entropy pull.
        The reply carries our map and, for every origin the caller
        sent a cursor for (plus ourselves), the debt deltas since it."""
        cursors = dict(payload.get("cursors") or {})
        out_debts = {self.name:
                     self.debts.since(int(cursors.get(self.name, 0)))}
        return {"ok": True, "from": self.name,
                "map": self.shardmap_wire(), "debts": out_debts}

    def sync_now(self) -> None:
        """One synchronous anti-entropy pass over every peer (the
        drills call this; the background thread just loops it)."""
        for peer in list(self.peers):
            try:
                reply = peer.sync({
                    "from": self.name,
                    "cursors": {peer.name:
                                self._cursors.get(peer.name, 0)}})
            except Exception as e:  # noqa: BLE001 — a dead/slow peer
                self._note_miss(peer, repr(e)[:200])
                continue
            with self._lock:
                self._misses[peer.name] = 0
                self.stats["peer_syncs"] += 1
            self._absorb(reply)

    def _note_miss(self, peer, detail: str) -> None:
        with self._lock:
            self.stats["peer_sync_errors"] += 1
            n = self._misses.get(peer.name, 0) + 1
            self._misses[peer.name] = n
        if n == self.suspect_after and obs_metrics.enabled():
            obs_events.emit("shard", event="peer_suspect",
                            peer=peer.name, misses=n,
                            detail=detail)
        if n >= self.suspect_after:
            self._takeover_dead_peer(peer.name)

    def _absorb(self, reply: dict) -> None:
        """Fold one peer's sync reply in: map merge (per-shard
        higher-epoch-wins) + debt-delta absorption into the SHARED
        quota buckets (never echoing our own origin)."""
        before = self.map.version()
        if self.map.merge(dict(reply.get("map") or {})):
            with self._lock:
                self.stats["map_merges"] += 1
            after = self.map.version()
            self._publish_map()
            if after != before and obs_metrics.enabled():
                obs_events.emit("shard", event="map_version",
                                version=after, router=self.name)
        for origin, body in dict(reply.get("debts") or {}).items():
            if origin == self.name:
                continue
            self._absorb_debts(str(origin), dict(body or {}))

    def _absorb_debts(self, origin: str, body: dict) -> None:
        applied = self._applied.setdefault(origin, {})
        n_absorbed = 0
        if body.get("reset"):
            # The bounded log no longer holds our cursor's suffix:
            # reconstruct the missed difference from cumulative totals
            # (what the origin charged overall minus what we already
            # applied for it).
            for tenant, total in dict(body.get("totals") or {}).items():
                diff = float(total) - applied.get(str(tenant), 0.0)
                if abs(diff) < 1e-12:
                    continue
                if self.quotas is not None:
                    self.quotas.absorb(str(tenant), diff)
                applied[str(tenant)] = float(total)
                n_absorbed += 1
            self._cursors[origin] = int(body.get("seq", 0))
        else:
            cur = self._cursors.get(origin, 0)
            for seq, tenant, delta in list(body.get("deltas") or ()):
                if int(seq) <= cur:
                    continue
                if self.quotas is not None:
                    self.quotas.absorb(str(tenant), float(delta))
                applied[str(tenant)] = (applied.get(str(tenant), 0.0)
                                        + float(delta))
                cur = int(seq)
                n_absorbed += 1
            self._cursors[origin] = max(cur,
                                        int(body.get("seq", cur)))
        if n_absorbed:
            with self._lock:
                self.stats["debt_deltas_absorbed"] += n_absorbed
            if obs_metrics.enabled():
                obs_events.emit("shard", event="peer_sync",
                                origin=origin, absorbed=n_absorbed,
                                router=self.name)

    # -- cross-shard fenced takeover ------------------------------------------
    def _takeover_dead_peer(self, peer_name: str) -> None:
        """A peer stopped answering: the deterministic successor of
        each of its shards re-opens the orphaned WAL lineage (the
        fenced takeover).  Determinism (shard index mod survivor
        count over the sorted survivor names) keeps two survivors
        from racing for the same lineage in the common case; the WAL
        sidecar flock makes the race SAFE regardless — the loser's
        construction simply observes the winner's rotation."""
        wire = self.map.to_wire()
        orphaned = sorted(
            s for s, e in wire["shards"].items()
            if e.get("owner") == peer_name and s not in self._sub)
        if not orphaned:
            return
        with self._lock:
            suspected = {p for p, n in self._misses.items()
                         if n >= self.suspect_after}
        survivors = sorted({self.name}
                           | {p.name for p in self.peers
                              if p.name not in suspected})
        for shard in orphaned:
            successor = survivors[int(shard) % len(survivors)]
            if successor != self.name:
                continue
            if shard in self._taken_over or shard in self._sub:
                continue
            self.takeover(shard, from_owner=peer_name)

    def takeover(self, shard: str, from_owner: str = "") -> None:
        """Fenced takeover of one orphaned shard lineage: re-open its
        WAL (epoch bump past the dead owner's), sweep the per-shard
        fence across the replicas, re-seed its durable jobs — the
        exact single-lineage drill, scoped so every OTHER shard
        keeps serving uninterrupted."""
        shard = str(shard)
        with self._lock:
            if shard in self._sub or shard in self._taken_over:
                return
            self._taken_over.add(shard)
        t0 = time.perf_counter()
        sub = self._open_shard(shard)
        self._publish_map()
        with self._lock:
            self.stats["takeovers"] += 1
        if obs_metrics.enabled():
            obs_metrics.counter(
                "pctpu_shard_takeovers_total",
                "orphaned shard lineages taken over by a surviving "
                "peer", ("shard",)).inc(shard=shard)
            obs_events.emit(
                "shard", event="takeover", shard=shard,
                router=self.name, from_owner=from_owner,
                epoch=sub.epoch, map_version=self.map.version(),
                jobs_restored=sub.recovery.get("jobs_restored", 0),
                dur_s=round(time.perf_counter() - t0, 4))

    # -- background sync ------------------------------------------------------
    def start_sync(self) -> None:
        if (self._sync_thread is None
                or not self._sync_thread.is_alive()):
            self._sync_thread = threading.Thread(
                target=self._sync_loop,
                name=f"pctpu-peer-sync-{self.name}", daemon=True)
            self._sync_thread.start()

    def _sync_loop(self) -> None:
        while not self._closed.wait(self.sync_interval_s):
            if self._dead:
                return
            self.sync_now()

    # -- operator surface / lifecycle -----------------------------------------
    def readyz(self):
        subs = {s: r.readyz() for s, r in self._sub.items()}
        ready = any(status == 200 for status, _ in subs.values())
        return (200 if ready else 503), {
            "ready": ready, "router": self.name,
            "owned_shards": sorted(self._sub),
            "map_version": self.map.version(),
            "shards": {s: payload for s, (_, payload) in subs.items()},
        }

    def snapshot(self) -> dict:
        with self._lock:
            stats = dict(self.stats)
            misses = dict(self._misses)
        return {
            "name": self.name,
            "owned_shards": sorted(self._sub),
            "map": self.map.to_wire(),
            "peers": {p.name: {"misses": misses.get(p.name, 0)}
                      for p in self.peers},
            "debt_log": self.debts.snapshot(),
            "shard_router": stats,
            "shards": {s: r.snapshot() for s, r in self._sub.items()},
        }

    def sub(self, shard: str) -> ReplicaRouter:
        """The owned shard's sub-router (drills reach through it)."""
        return self._sub[str(shard)]

    def hard_stop(self) -> None:
        """The in-process stand-in for SIGKILL: stop serving and
        RELEASE the WAL flocks (a dead process's locks vanish) without
        any graceful fencing — the successor must win ownership via
        the WAL takeover, not via a polite handoff."""
        self._dead = True
        self._closed.set()
        for sub in self._sub.values():
            try:
                sub.close(close_replicas=False)
            except Exception:  # noqa: BLE001 — already-dying state
                pass

    def close(self, close_replicas: bool = True) -> None:
        self._closed.set()
        t = self._sync_thread
        if t is not None and t.is_alive():
            t.join(5.0)
        for sub in self._sub.values():
            sub.close(close_replicas=False)
        if close_replicas:
            for tr in self._transports:
                try:
                    tr.close()
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass


class ShardClient:
    """The shard-aware client: fetch the version-stamped map from any
    router, route to the owner, and on a ``wrong_shard`` /
    ``stale_epoch`` typed reject refresh the map and retry (bounded).
    ``routers`` are the in-process :class:`ShardRouter`s (the drills'
    transport; the HTTP twin is loadgen's multi-URL mode)."""

    def __init__(self, routers, max_redirects: int = 4):
        self._routers = {r.name: r for r in routers}
        self.max_redirects = int(max_redirects)
        self.map_version = -1
        self._map: dict = {}
        self.refreshes = 0
        self.refresh()

    def refresh(self) -> None:
        for r in self._routers.values():
            if getattr(r, "_dead", False):
                continue
            try:
                wire = r.shardmap_wire()
            except Exception:  # noqa: BLE001 — a dead router
                continue
            if int(wire.get("version", -1)) >= self.map_version:
                self.map_version = int(wire.get("version", -1))
                self._map = dict(wire.get("shards") or {})
            self.refreshes += 1
            return
        raise ConnectionError("no live router to fetch the shard "
                              "map from")

    def _target(self, body: dict):
        n = max(1, len(self._map) or max(
            (r.n_shards for r in self._routers.values()), default=1))
        shard = shard_of(route_key(dict(body)), n)
        owner = (self._map.get(shard) or {}).get("owner", "")
        r = self._routers.get(owner)
        if r is None or getattr(r, "_dead", False):
            live = [x for x in self._routers.values()
                    if not getattr(x, "_dead", False)]
            if not live:
                raise ConnectionError("no live router")
            r = live[0]
        return r

    def request(self, body: dict, timeout: float | None = None,
                tenant: str | None = None):
        status = 503
        wire: dict = {}
        for _ in range(self.max_redirects):
            try:
                status, wire = self._target(body).request(
                    dict(body), timeout=timeout, tenant=tenant)
            except ConnectionError:
                self.refresh()
                continue
            if wire.get("rejected") in _REROUTE_REJECTS:
                self.refresh()
                continue
            return status, wire
        return status, wire

    def converge(self, body: dict, timeout: float | None = None,
                 tenant: str | None = None):
        status = 503
        rows = iter(())
        for _ in range(self.max_redirects):
            try:
                status, rows = self._target(body).converge(
                    dict(body), timeout=timeout, tenant=tenant)
            except ConnectionError:
                self.refresh()
                continue
            if status != 200:
                first = next(iter(rows), None)
                if (first is not None and first.get("rejected")
                        in _REROUTE_REJECTS):
                    self.refresh()
                    continue
                return status, iter(() if first is None else (first,))
            return status, rows
        return status, rows
