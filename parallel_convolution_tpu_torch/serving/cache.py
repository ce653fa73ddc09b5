"""Content-addressed result cache: serve duplicate traffic from bytes (the
port's own copy of the JAX package's ``serving/cache.py``: the same keys,
digests and spill format).

Two byte-identical requests with different ``request_id``s would both run
on the card.  This module keys *results* by content so the duplicate head
of the traffic is served without touching a lane, a build or the card:

* **Key = input digest + compile identity.**  :func:`input_digest` is a
  SHA-256 over the planar image's dtype/shape/bytes;
  :func:`result_key` folds in the full :class:`~.engine.EngineKey`
  (which already carries iters/fuse/boundary/solver/mg_levels/backend/
  grid — everything that changes the output bytes).  Two requests with
  equal result keys are guaranteed byte-identical answers, so a hit can
  be stamped into a Response without re-execution.  Convergence jobs
  use :func:`converge_key` — ``(rhs digest, tol, solver, mg_levels)`` —
  because their output identity is the *fixed point*, not the iteration
  count.
* **Two tiers.**  A bounded in-memory OrderedDict LRU (entries + bytes)
  spills evicted entries to a disk tier of content-addressed files
  (filename derived from the key), written atomically (temp +
  ``os.replace``) with a CRC32 over header and body — the
  ``utils.checkpoint`` shard discipline.  A corrupt disk entry is a
  loud miss (dropped + journaled dead), never bad bytes.
* **Evictions/invalidations are journaled.**  The constructor takes a
  ``journal(op, ckey)`` hook (the fleet's write-ahead log, ROADMAP item
  8b, wires it to its ``cache`` record kind; ``op`` = ``dead`` |
  ``live``).  The journal is
  write-ahead: an entry is marked dead BEFORE its bytes are dropped, so
  a crash between the two can only over-invalidate, never resurrect.
  A recovered log hands its dead set back in via the ``dead`` argument
  and the cache refuses to serve those
  keys even if their disk bytes survived the restart; a later re-store
  of the same key (a miss re-executed it) journals ``live`` first,
  lifting the tombstone for the *fresh* bytes.
* **Shard-local.**  A cache belongs to one shard's lineage: the journal
  hook appends to that shard's WAL, so a cross-shard takeover that
  adopts the dead shard's journal adopts its tombstones too.

stdlib + numpy only: entries hold host arrays, never a CUDA tensor, so a
hit is served without the card.
"""

from __future__ import annotations

import dataclasses
import errno
import hashlib
import json
import os
import tempfile
import threading
import time
import zlib
from collections import OrderedDict
from pathlib import Path

import numpy as np

from parallel_convolution_tpu_torch.resilience import diskio

__all__ = ["ResultCache", "converge_key", "input_digest", "result_key"]

# Tombstone bound (mirrors the WAL's _CACHE_DEAD_CAP; the WAL re-bounds
# to its own cap on replay anyway).
_DEAD_CAP = 4096


def input_digest(planar) -> str:
    """SHA-256 hex over one planar image's dtype + shape + bytes.

    The dtype/shape prefix keeps a (1, 8, 8) u8 image from colliding
    with a (8, 8, 1) or f32 view of the same byte stream.
    """
    arr = np.ascontiguousarray(planar)
    h = hashlib.sha256()
    h.update(f"{arr.dtype.str}|{arr.shape}|".encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def _key_fingerprint(fields: dict) -> str:
    payload = json.dumps(fields, sort_keys=True, separators=(",", ":"),
                         default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def result_key(digest: str, engine_key) -> str:
    """Cache key for the batch path: input digest + the full compile
    identity (EngineKey already includes iters/solver params)."""
    return f"{digest}-{_key_fingerprint(dataclasses.asdict(engine_key))}"


def converge_key(digest: str, *, tol, solver: str,
                 mg_levels, engine_key=None) -> str:
    """Cache key for a convergence job's FINAL row: the fixed point is
    determined by ``(rhs digest, tol, solver, mg_levels)`` plus the
    stencil identity (filter/boundary/storage ride in via
    ``engine_key`` when given) — NOT by check_every/max_iters, which
    only change how often the stream reports progress."""
    fields = {"tol": repr(tol), "solver": solver, "mg_levels": mg_levels}
    if engine_key is not None:
        kf = dataclasses.asdict(engine_key)
        # iters is the snapshot cadence on the converge path, not part
        # of the fixed point's identity.
        kf.pop("iters", None)
        fields["key"] = kf
    return f"{digest}-cv{_key_fingerprint(fields)}"


class ResultCache:
    """Bounded two-tier content-addressed result store.

    Entries are ``(arrays, meta)``: a dict of named numpy arrays (the
    result bytes) plus a JSON-safe metadata dict (effective_backend,
    plan provenance, ... — whatever the service needs to rebuild a
    Response).  ``get``/``put``/``invalidate`` are thread-safe; the
    journal hook is called under the cache lock so the WAL's ordering
    matches the cache's.
    """

    def __init__(self, *, capacity_entries: int = 256,
                 capacity_bytes: int = 256 << 20,
                 disk_dir=None, disk_capacity_entries: int = 1024,
                 journal=None, dead=None, shard: str | None = None,
                 demote_after: int = 2, reprobe_s: float = 5.0,
                 clock=time.monotonic):
        if capacity_entries < 1:
            raise ValueError("capacity_entries must be >= 1")
        self.capacity_entries = int(capacity_entries)
        self.capacity_bytes = int(capacity_bytes)
        self.disk_dir = None if disk_dir is None else Path(disk_dir)
        self.disk_capacity_entries = int(disk_capacity_entries)
        self.shard = None if shard is None else str(shard)
        self._journal = journal
        self._lock = threading.Lock()
        # Disk-tier degrade ladder: ``demote_after``
        # consecutive spill failures demote the tier to memory-only
        # (a journaled ``tier_demoted`` transition — the WAL shows WHEN
        # the cross-restart spill surface went dark); while demoted,
        # one spill attempt per ``reprobe_s`` re-probes the disk, and
        # the first success journals ``tier_restored`` and re-arms.
        self.demote_after = max(1, int(demote_after))
        self.reprobe_s = float(reprobe_s)
        self._clock = clock
        self._spill_fail_streak = 0
        self._disk_demoted = False
        self._reprobe_at = 0.0
        # ckey -> (arrays, meta, nbytes)
        self._mem: OrderedDict[str, tuple] = OrderedDict()
        self._mem_bytes = 0
        # ckey -> disk path (LRU order; oldest evicted+journaled dead)
        self._disk: OrderedDict[str, Path] = OrderedDict()
        # Tombstones: journaled-dead keys this cache must never serve
        # (seeded from a recovered WALState.cache_dead on restart).
        self._dead: OrderedDict[str, bool] = OrderedDict()
        for k in dead or ():
            self._mark_dead_local(str(k))
        self.stats = {
            "hits_mem": 0, "hits_disk": 0, "misses": 0, "stores": 0,
            "spills": 0, "evictions": 0, "invalidations": 0,
            "corrupt_drops": 0, "dead_refusals": 0, "journal_errors": 0,
            "spill_failures": 0, "tier_demotions": 0,
            "tier_restores": 0, "reprobes": 0,
        }
        if self.disk_dir is not None:
            self.disk_dir.mkdir(parents=True, exist_ok=True)
            self._adopt_disk_locked()

    # -- tombstones -----------------------------------------------------------
    def _mark_dead_local(self, ckey: str) -> None:
        self._dead.pop(ckey, None)
        self._dead[ckey] = True
        while len(self._dead) > _DEAD_CAP:
            self._dead.pop(next(iter(self._dead)))

    def _journal_locked(self, op: str, ckey: str) -> None:
        if self._journal is None:
            return
        try:
            self._journal(op, ckey)
        except Exception:
            # Durability failure must not become a serving outage (the
            # WAL's own rule) — but an unjournaled DEATH would let a
            # restart resurrect the bytes, so the local tombstone above
            # still stands; only the cross-restart guarantee degrades,
            # and loudly.
            self.stats["journal_errors"] += 1  # stats-lock: held by caller (_locked suffix)

    def _kill_locked(self, ckey: str, *, reason: str) -> None:
        """Write-ahead death: journal + local tombstone BEFORE the
        bytes are dropped, so a crash mid-removal over-invalidates
        instead of resurrecting."""
        self._journal_locked("dead", ckey)
        self._mark_dead_local(ckey)
        ent = self._mem.pop(ckey, None)
        if ent is not None:
            self._mem_bytes -= ent[2]
        path = self._disk.pop(ckey, None)
        if path is not None:
            try:
                os.unlink(path)
            except OSError:
                pass
        self.stats[reason] += 1  # stats-lock: held by caller (_locked suffix)

    # -- disk tier ------------------------------------------------------------
    def _disk_path(self, ckey: str) -> Path:
        return self.disk_dir / f"{ckey}.rc"

    def _adopt_disk_locked(self) -> None:
        """Adopt surviving ``*.rc`` files at startup — EXCEPT the ones
        the recovered journal marked dead (the never-resurrect rule)."""
        for p in sorted(self.disk_dir.glob("*.rc")):
            ckey = p.name[:-3]
            if ckey in self._dead:
                try:
                    os.unlink(p)
                except OSError:
                    pass
                continue
            self._disk[ckey] = p
        while len(self._disk) > self.disk_capacity_entries:
            self._kill_locked(next(iter(self._disk)),
                              reason="evictions")

    def _spill_locked(self, ckey: str, arrays: dict, meta: dict) -> None:
        """Memory -> disk: content-addressed file, atomic write, CRC32
        over header and body (the checkpoint-shard discipline).  The
        ``cache_spill`` fault site guards the write (ENOSPC / EIO /
        torn / slow via ``resilience.diskio``); failures feed the
        demote ladder — the entry leaves the cache (journaled dead,
        never servable-stale) and a failure streak takes the whole
        tier memory-only until a re-probe heals it."""
        if self._disk_demoted:
            if self._clock() < self._reprobe_at:
                # Tier is dark and the probe window hasn't opened:
                # leaving memory IS leaving the cache.
                self._kill_locked(ckey, reason="evictions")
                return
            self._reprobe_at = self._clock() + self.reprobe_s
            self.stats["reprobes"] += 1  # stats-lock: held by caller (_locked suffix)
        names = sorted(arrays)
        body = b"".join(np.ascontiguousarray(arrays[n]).tobytes()
                        for n in names)
        header = {
            "ckey": ckey,
            "arrays": [{"name": n, "dtype": arrays[n].dtype.str,
                        "shape": list(arrays[n].shape)} for n in names],
            "body_crc": zlib.crc32(body) & 0xFFFFFFFF,
            "meta": meta,
        }
        hjson = json.dumps(header, separators=(",", ":"), sort_keys=True)
        hcrc = zlib.crc32(hjson.encode()) & 0xFFFFFFFF
        blob = f"{hcrc:08x} {hjson}\n".encode() + body
        path = self._disk_path(ckey)
        tmp = None
        try:
            # torn_write is deferred so the torn bytes actually get
            # PUBLISHED (tmp + replace, then the error): the shape an
            # unsynced page loss leaves behind, which the read path's
            # CRC must refuse.
            torn = diskio.deferred_consult("cache_spill") == "torn_write"
            fd, tmp = tempfile.mkstemp(dir=str(self.disk_dir),
                                       prefix=".rc-", suffix=".tmp")
            with os.fdopen(fd, "wb") as fh:
                fh.write(blob[:max(1, len(blob) // 2)] if torn else blob)
            os.replace(tmp, path)
            tmp = None
            if torn:
                raise OSError(errno.EIO,
                              "injected torn write at cache_spill")
        except OSError:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            # Spill failure: the entry leaves the cache entirely —
            # including any bytes the failure left at its final path
            # (a torn publish must not await adoption).
            try:
                os.unlink(path)
            except OSError:
                pass
            self._kill_locked(ckey, reason="evictions")
            self.stats["spill_failures"] += 1  # stats-lock: held by caller (_locked suffix)
            self._spill_fail_streak += 1
            if (not self._disk_demoted
                    and self._spill_fail_streak >= self.demote_after):
                self._demote_tier_locked()
            return
        self._spill_fail_streak = 0
        if self._disk_demoted:
            self._restore_tier_locked()
        self._disk.pop(ckey, None)
        self._disk[ckey] = path
        self.stats["spills"] += 1  # stats-lock: held by caller (_locked suffix)
        while len(self._disk) > self.disk_capacity_entries:
            self._kill_locked(next(iter(self._disk)),
                              reason="evictions")

    def _demote_tier_locked(self) -> None:
        """Disk tier -> memory-only (journaled, so the WAL's record
        stream shows when the cross-restart spill surface went dark).
        Resident disk entries stay servable — their bytes landed
        before the device degraded, and every read re-verifies CRC."""
        self._disk_demoted = True
        self._reprobe_at = self._clock() + self.reprobe_s
        self.stats["tier_demotions"] += 1  # stats-lock: held by caller (_locked suffix)
        self._journal_locked("tier_demoted", "disk")

    def _restore_tier_locked(self) -> None:
        self._disk_demoted = False
        self._spill_fail_streak = 0
        self.stats["tier_restores"] += 1  # stats-lock: held by caller (_locked suffix)
        self._journal_locked("tier_restored", "disk")

    def _read_disk_locked(self, ckey: str):
        path = self._disk.get(ckey)
        if path is None:
            return None
        try:
            # cache_promote guard: a failed disk read on a hit is a
            # loud journaled miss (killed below), never a stale serve.
            diskio.consult("cache_promote")
            blob = path.read_bytes()
            nl = blob.index(b"\n")
            line = blob[:nl].decode("utf-8")
            if len(line) < 10 or line[8] != " ":
                raise ValueError("header format")
            hcrc, hjson = int(line[:8], 16), line[9:]
            if zlib.crc32(hjson.encode()) & 0xFFFFFFFF != hcrc:
                raise ValueError("header crc")
            header = json.loads(hjson)
            if header.get("ckey") != ckey:
                raise ValueError("key mismatch")
            body = blob[nl + 1:]
            if zlib.crc32(body) & 0xFFFFFFFF != header["body_crc"]:
                raise ValueError("body crc")
            arrays: dict[str, np.ndarray] = {}
            off = 0
            for spec in header["arrays"]:
                dt = np.dtype(spec["dtype"])
                shape = tuple(int(x) for x in spec["shape"])
                n = dt.itemsize * int(np.prod(shape, dtype=np.int64))
                arrays[spec["name"]] = np.frombuffer(
                    body[off:off + n], dtype=dt).reshape(shape)
                off += n
            if off != len(body):
                raise ValueError("body length")
            return arrays, dict(header.get("meta") or {})
        except (OSError, ValueError, KeyError, TypeError):
            # Damaged shard: loud miss, journaled dead — a torn write
            # or flipped bit must never become served bytes.
            self._kill_locked(ckey, reason="corrupt_drops")
            return None

    # -- memory tier ----------------------------------------------------------
    def _insert_mem_locked(self, ckey: str, arrays: dict,
                           meta: dict) -> None:
        nbytes = sum(int(a.nbytes) for a in arrays.values())
        old = self._mem.pop(ckey, None)
        if old is not None:
            self._mem_bytes -= old[2]
        self._mem[ckey] = (arrays, meta, nbytes)
        self._mem_bytes += nbytes
        while (len(self._mem) > self.capacity_entries
               or self._mem_bytes > self.capacity_bytes):
            if len(self._mem) == 1:
                break   # a single over-budget entry still serves
            victim, ent = self._mem.popitem(last=False)
            self._mem_bytes -= ent[2]
            if self.disk_dir is not None:
                self._spill_locked(victim, ent[0], ent[1])
            else:
                # No disk tier: leaving memory IS leaving the cache.
                self._kill_locked(victim, reason="evictions")

    # -- public API -----------------------------------------------------------
    def get(self, ckey: str):
        """``(arrays, meta)`` or None.  A journaled-dead key is refused
        even if bytes for it still exist (the never-resurrect rule); a
        disk hit is promoted back into the memory tier."""
        with self._lock:
            if ckey in self._dead:
                self.stats["dead_refusals"] += 1
                self.stats["misses"] += 1
                return None
            ent = self._mem.get(ckey)
            if ent is not None:
                self._mem.move_to_end(ckey)
                self.stats["hits_mem"] += 1
                return ent[0], ent[1]
            got = self._read_disk_locked(ckey)
            if got is not None:
                self.stats["hits_disk"] += 1
                self._insert_mem_locked(ckey, got[0], got[1])
                return got
            self.stats["misses"] += 1
            return None

    def put(self, ckey: str, arrays: dict, meta: dict) -> None:
        """Store one result.  Arrays are copied (the caller's buffers
        may be reused); a tombstoned key is journaled ``live`` first —
        fresh bytes from a re-execution lift the tombstone."""
        arrays = {str(n): np.ascontiguousarray(a).copy()
                  for n, a in arrays.items()}
        with self._lock:
            if ckey in self._dead:
                self._journal_locked("live", ckey)
                self._dead.pop(ckey, None)
            self._insert_mem_locked(ckey, arrays, dict(meta))
            self.stats["stores"] += 1

    def invalidate(self, ckey: str) -> None:
        """Journal + drop one entry (write-ahead: dead before drop)."""
        with self._lock:
            if ckey in self._mem or ckey in self._disk:
                self._kill_locked(ckey, reason="invalidations")
            else:
                self._journal_locked("dead", ckey)
                self._mark_dead_local(ckey)
                self.stats["invalidations"] += 1

    def invalidate_all(self) -> None:
        """Drop every resident entry (engine swap / reshape: the plan
        provenance stamped in cached metadata is stale)."""
        with self._lock:
            for ckey in list(self._mem) + list(self._disk):
                self._kill_locked(ckey, reason="invalidations")

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem) + len(self._disk)

    def keys(self) -> list[str]:
        """Resident entry keys, memory tier first (LRU order within
        each tier) — the drill/test surface for naming an entry."""
        with self._lock:
            return list(self._mem) + [k for k in self._disk
                                      if k not in self._mem]

    def snapshot(self) -> dict:
        with self._lock:
            s = dict(self.stats)
            s.update(mem_entries=len(self._mem),
                     mem_bytes=self._mem_bytes,
                     disk_entries=len(self._disk),
                     dead=len(self._dead), shard=self.shard)
            return s
