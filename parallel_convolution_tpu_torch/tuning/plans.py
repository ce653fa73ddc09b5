"""Persistent tuning-plan cache of the port: the JAX package's
``tuning/plans.py`` with the same schema, keys and fallback ladder.

A *plan* is the tuner's verdict for one workload identity — which
backend, fusion depth, and kernel tile to run — plus provenance (was it
measured on this card, interpolated from a neighboring size bucket, or
predicted by the cost model alone?).  Plans persist as one
schema-versioned JSON file: tune once (``python -m
parallel_convolution_tpu_torch tune --emit-plans``), and every later
``backend="auto"`` resolves through the file named by
``PCTPU_PLAN_FILE``.

The file format is the JAX package's, so one file can hold both
packages' plans.  The platform is part of the key (``"gpu"`` for the
card, ``"cpu"``), so a TPU plan never drives the card, and a record whose
backend the port does not have (``pallas``, ...) is skipped as malformed.

Key schema (``PLAN_SCHEMA``): the full tuning identity —

  platform / device kind (a plan for one card must never drive another),
  mesh grid (block geometry changes the whole candidate space),
  channels + (H, W) size *bucket* (next power of two: 8000x8000 and
  8192x8192 tune identically; distinct buckets do not),
  filter name + radius, storage dtype, quantize, boundary.

Canonical keys are ``json.dumps(..., sort_keys=True)`` of the field
dict, so key equality is insensitive to construction order (pinned by
``tests/test_tuning.py``).

Fallback ladder of :meth:`PlanCache.best_plan`::

  exact key hit          -> the plan, its own provenance ("measured"
                            or "predicted", as stored)
  same chip+config,      -> nearest bucket by |log2 area| distance,
  different size bucket     provenance rewritten to "interpolated"
  nothing                -> None (caller falls back to the cost model,
                            provenance "predicted")

Writes are atomic (tmp + ``os.replace``); a corrupt or
wrong-schema file loads as empty with a warning — a torn write can
cost a re-tune, never a crash or a silently-wrong plan.

The platform and device kind come from the grid's device
(:meth:`Workload.from_grid`).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
import warnings

from parallel_convolution_tpu_torch.utils.config import BACKENDS

PLAN_SCHEMA = 1

# Environment override for the default plan file consulted by
# ``backend="auto"`` when the caller supplies no cache.
PLAN_FILE_ENV = "PCTPU_PLAN_FILE"

PROVENANCES = ("measured", "interpolated", "predicted")


def _bucket(n: int) -> int:
    """Size bucket: next power of two (>= 8) — 8000 and 8192 share one."""
    b = 8
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class Workload:
    """One tunable workload identity (everything the plan key carries).

    ``shape`` is the logical (C, H, W); ``block_hw`` the block after
    pad-to-multiple (derived, not part of the key — it is a function of
    shape bucket + grid).
    """

    platform: str
    device_kind: str
    grid: tuple[int, int]
    shape: tuple[int, int, int]
    filter_name: str
    radius: int
    taps_k: int
    separable: bool
    dyadic: bool
    storage: str = "f32"
    quantize: bool = True
    boundary: str = "zero"
    # Convergence-path identity (None = the fixed-count path).  Part of
    # the key because check_every bounds the legal fusion depth (a chunk
    # fuses at most its n-1 pre-pair iterations) — a plan tuned for the
    # fixed-count program must not silently drive the convergence one.
    check_every: int | None = None
    # Whether the kernels round with the magic number (ops/stencil.py
    # round_mode): a function of the filter, so not part of the key.
    magic_round: bool = True

    @property
    def block_hw(self) -> tuple[int, int]:
        _, H, W = self.shape
        R, C = self.grid
        return (-(-H // R), -(-W // C))  # ceil-div == padded_extent // n

    @property
    def ragged(self) -> bool:
        """Whether the grid pads the image (a rim re-masked every level)."""
        _, H, W = self.shape
        return bool(H % self.grid[0] or W % self.grid[1])

    @classmethod
    def from_grid(cls, grid, filt, shape, *, storage: str = "f32",
                  quantize: bool = True, boundary: str = "zero",
                  check_every: int | None = None) -> "Workload":
        """Build the identity for ``shape`` (C, H, W) on ``grid``: platform
        ``"gpu"`` and the card's name, or ``"cpu"``."""
        from parallel_convolution_tpu_torch.ops.stencil import round_mode
        from parallel_convolution_tpu_torch.utils.platform import device_kind

        on_card = grid.device.type == "cuda"
        return cls(
            platform="gpu" if on_card else "cpu",
            device_kind=device_kind(grid.device),
            grid=tuple(grid.shape),
            shape=tuple(int(s) for s in shape),
            filter_name=filt.name,
            radius=filt.radius,
            taps_k=filt.size,
            separable=filt.separable() is not None,
            dyadic=bool(filt.dyadic),
            storage=storage,
            quantize=bool(quantize),
            boundary=boundary,
            check_every=None if check_every is None else int(check_every),
            magic_round=round_mode(filt.taps) == "magic",
        )

    def key_fields(self) -> dict:
        """The plan-key field dict (bucketed sizes, no derived values).

        ``check_every`` appears only when set: fixed-count keys are
        byte-identical to the pre-round-10 schema, so existing plan
        files stay valid without a schema bump.
        """
        C, H, W = self.shape
        fields = {
            "schema": PLAN_SCHEMA,
            "platform": self.platform,
            "device_kind": self.device_kind,
            "grid": f"{self.grid[0]}x{self.grid[1]}",
            "channels": C,
            "bucket_hw": f"{_bucket(H)}x{_bucket(W)}",
            "filter": self.filter_name,
            "radius": self.radius,
            "storage": self.storage,
            "quantize": self.quantize,
            "boundary": self.boundary,
        }
        if self.check_every is not None:
            fields["check_every"] = int(self.check_every)
        return fields

    def key(self) -> str:
        return canonical_key(self.key_fields())


def canonical_key(fields: dict) -> str:
    """Order-insensitive canonical key string for a field dict."""
    return json.dumps(fields, sort_keys=True, separators=(",", ":"))


@dataclasses.dataclass
class Plan:
    """One tuning verdict.  ``source`` is the provenance the resolving
    caller stamps into its rows (``plan_source``)."""

    backend: str
    fuse: int = 1
    tile: tuple[int, int] | None = None
    source: str = "predicted"
    predicted_gpx: float | None = None
    measured_gpx: float | None = None
    # Interior-first overlapped halo pipeline (RDMA tier).  Serialized
    # records from pre-overlap plan files lack the key and default to
    # False — the exact pre-overlap behavior, so no schema bump.
    overlap: bool = False
    # Column-slab transport (round 16, the packed-vs-strided A/B).
    # Legacy records lack the key and default to the canonical "packed"
    # — byte-identical to every other mode, so no schema bump.
    col_mode: str = "packed"

    def to_record(self, workload: Workload | None = None) -> dict:
        rec = {
            "backend": self.backend,
            "fuse": int(self.fuse),
            "tile": list(self.tile) if self.tile else None,
            "source": self.source,
            "predicted_gpx": self.predicted_gpx,
            "measured_gpx": self.measured_gpx,
            "overlap": bool(self.overlap),
            "col_mode": str(self.col_mode),
        }
        if workload is not None:
            rec["key_fields"] = workload.key_fields()
        return rec

    @classmethod
    def from_record(cls, rec: dict) -> "Plan":
        """Parse a record; ``ValueError`` for a backend the port does not
        have (a JAX package's ``pallas`` plan, say)."""
        if rec["backend"] not in BACKENDS:
            raise ValueError(f"backend {rec['backend']!r} is not one of the "
                             f"port's {BACKENDS}")
        tile = rec.get("tile")
        return cls(
            backend=rec["backend"],
            fuse=int(rec.get("fuse", 1)),
            tile=tuple(int(v) for v in tile) if tile else None,
            source=rec.get("source", "measured"),
            predicted_gpx=rec.get("predicted_gpx"),
            measured_gpx=rec.get("measured_gpx"),
            overlap=bool(rec.get("overlap", False)),
            col_mode=str(rec.get("col_mode", "packed")),
        )


def _area_of_bucket(bucket_hw: str) -> float:
    h, w = (int(v) for v in bucket_hw.split("x"))
    return float(h) * float(w)


def _ndev_of_grid(grid: str) -> float:
    r, c = (int(v) for v in grid.split("x"))
    return float(r) * float(c)


class PlanCache:
    """In-memory view of one plan file (key string -> plan record)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: dict[str, dict] = {}

    # -- persistence --------------------------------------------------------
    @classmethod
    def load(cls, path: str | None) -> "PlanCache":
        """Load ``path``; missing, corrupt, or wrong-schema files yield an
        EMPTY cache (warned) — a torn write costs a re-tune, never a
        crash and never a silently-wrong plan."""
        cache = cls(path)
        if not path or not os.path.exists(path):
            return cache
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
            if data.get("schema") != PLAN_SCHEMA:
                raise ValueError(
                    f"plan schema {data.get('schema')!r} != {PLAN_SCHEMA}")
            records = data["plans"]
            if not isinstance(records, dict):
                raise ValueError("'plans' must be an object")
        except Exception as e:  # noqa: BLE001 — fallback IS the contract
            warnings.warn(
                f"ignoring unusable plan file {path!r}: {e!r} (tuning "
                "falls back to the cost model)",
                stacklevel=2)
            return cache
        cache.records = records
        return cache

    def save(self, path: str | None = None) -> str:
        """Atomic write (tmp + rename) of the whole cache; returns path."""
        path = path or self.path
        if not path:
            raise ValueError("PlanCache.save needs a path")
        payload = {"schema": PLAN_SCHEMA, "plans": self.records}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".plans.", dir=d)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.path = path
        return path

    def merge_save(self, path: str) -> str:
        """Merge this cache's records over whatever ``path`` holds now
        and write the union atomically (the ``--emit-plans`` verb)."""
        disk = PlanCache.load(path)
        disk.records.update(self.records)
        disk.save(path)
        self.records = disk.records
        self.path = path
        return path

    # -- access -------------------------------------------------------------
    def put(self, workload: Workload, plan: Plan) -> None:
        self.records[workload.key()] = plan.to_record(workload)

    @staticmethod
    def _plan_of(rec) -> Plan | None:
        """Parse one record; malformed records are WARNED AND SKIPPED —
        the file-level 'never a crash' contract applies per record too
        (a hand-edited or buggy-merge entry must cost a re-tune, not
        kill every backend='auto' resolution in the process)."""
        try:
            return Plan.from_record(rec)
        except (KeyError, TypeError, ValueError) as e:
            warnings.warn(f"ignoring malformed plan record {rec!r}: {e!r}",
                          stacklevel=3)
            return None

    def exact(self, workload: Workload) -> Plan | None:
        rec = self.records.get(workload.key())
        return self._plan_of(rec) if rec else None

    def best_plan(self, workload: Workload) -> Plan | None:
        """The fallback ladder: exact -> nearest same-chip size bucket ->
        nearest same-chip GRID (elastic recovery: a resharded resume on
        a shrunken mesh still resolves the run's tuned plan instead of
        silently falling back to the cost model) -> None.  Every
        non-exact hit's provenance is rewritten to 'interpolated', and
        the resolver re-clamps interpolated knobs to the target grid's
        legality (``tuning._legal_plan_knobs``).
        """
        hit = self.exact(workload)
        if hit is not None:
            return hit
        want = workload.key_fields()
        want_area = _area_of_bucket(want["bucket_hw"])
        want_ndev = _ndev_of_grid(want["grid"])
        # rank: same-grid tier before cross-grid, then grid distance
        # (|log2 device-count ratio|), bucket distance, key string —
        # fully deterministic.
        best: tuple[tuple, dict] | None = None
        for key, rec in self.records.items():
            have = rec.get("key_fields")
            # Field-set parity: a record carrying fields the workload
            # lacks (e.g. a convergence plan's check_every against a
            # fixed-count resolve) is a different identity, not a
            # neighbor.
            if not have or set(have) != set(want):
                continue
            diff = {f for f in want if have.get(f) != want[f]}
            if not diff <= {"bucket_hw", "grid"}:
                continue
            try:
                bucket_dist = abs(
                    math.log2(_area_of_bucket(have["bucket_hw"]))
                    - math.log2(want_area))
                grid_dist = abs(math.log2(_ndev_of_grid(have["grid"]))
                                - math.log2(want_ndev))
            except (KeyError, ValueError):
                continue
            rank = ("grid" in diff, grid_dist, bucket_dist, key)
            if best is None or rank < best[0]:
                best = (rank, rec)
        if best is None:
            return None
        plan = self._plan_of(best[1])
        if plan is None:
            return None
        plan.source = "interpolated"
        return plan

    def __len__(self) -> int:
        return len(self.records)


def default_plan_path() -> str | None:
    """The plan file named by ``PCTPU_PLAN_FILE`` (None when unset)."""
    return os.environ.get(PLAN_FILE_ENV) or None


def default_cache() -> PlanCache:
    """The ambient plan cache: ``PCTPU_PLAN_FILE`` if set, else empty.

    Loaded fresh per call — plan files are small, and re-reading keeps
    long-lived processes (the serving tier) coherent with a tuner that
    just emitted new plans.
    """
    return PlanCache.load(default_plan_path())
