"""Cost-priced admission: what one wire request costs, before it runs
(the port's own copy of the JAX package's ``serving/pricing.py``, on the
port's cost model).

Charging every request one token lets a big converge job and a thumbnail
blur draw the same quota.  This module prices admission in the cost
model's own currency: **predicted device-seconds**
(``tuning.costmodel``, the same model that ranks backends; on a card the
H100 model, on the CPU the host model), so a bucket's refill rate is a
share of machine time, not a request count.  The service feeds the price
to the batcher's lane priority.

* Batch requests price as ``predict_seconds_per_px_iter × pixels ×
  iters / devices`` — linear in the work the device will actually do.
* Convergence jobs price their ``max_iters`` WORK BUDGET (the bound the
  stream enforces): jacobi as ``max_iters`` fine-grid sweeps; multigrid
  through :func:`costmodel.predict_mg_cycle_seconds` — the budget in
  fine-grid work units divided by one cycle's work units, times one
  cycle's seconds — so a converge job pays for the V-cycle schedule it
  will drive, not a flat fee.
* Accuracy contract is the cost model's own: it RANKS (a big job costs
  proportionally more than a small one); absolute error is absorbed by
  the bucket rate knob.  Every price is floored (``min_units``) so
  free-looking requests still meter, and clamped (``max_units``) so one
  absurd request cannot poison a bucket beyond recovery.

Prices are pure arithmetic on wire fields, cached by the fields that
decide them (bounded LRU: the price of a config is as stable as its build
identity).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from parallel_convolution_tpu_torch.tuning import costmodel

__all__ = ["WorkPricer"]


class WorkPricer:
    """Predicted device-seconds for one wire-format request.

    ``grid``/``platform``/``device_kind`` describe the replica (its grid
    shape; ``platform`` ``"gpu"`` prices on the H100 model under the
    card's name, anything else on the host model); they shape the
    exchange/roofline terms only — pricing is RELATIVE, so one model
    pricing every request meters fairly.
    """

    def __init__(self, grid: tuple[int, int] = (1, 1),
                 platform: str = "cpu", device_kind: str = "", *,
                 min_units: float = 1e-4, max_units: float = 600.0,
                 cache_size: int = 512):
        self.grid = (max(1, int(grid[0])), max(1, int(grid[1])))
        self.hw = costmodel.hardware_for(platform, device_kind)
        self.min_units = float(min_units)
        self.max_units = float(max_units)
        self._cache: OrderedDict[tuple, float] = OrderedDict()
        self._cache_size = max(16, int(cache_size))
        self._lock = threading.Lock()

    # -- the public surface ---------------------------------------------------
    def hit_units(self) -> float:
        """What a content-addressed CACHE HIT costs: the floor.

        A hit consumes no device time — it is a digest, a dict probe,
        and a memcpy — so it meters at ``min_units``, the same floor a
        malformed body prices at.  Charging hits near-zero is the
        incentive side of the result cache (serving/cache.py): a tenant
        whose traffic is duplicate-heavy spends almost none of its
        device-seconds budget on the duplicate head.  The router settles
        the difference AFTER the response comes back stamped
        ``cache: hit`` (it cannot know at admission), refunding
        ``charged - hit_units()`` through the journaled refund path.
        """
        return self.min_units

    def price(self, body: dict, converge: bool = False,
              cache_hit: bool = False) -> float:
        """Work units (predicted device-seconds) one request will cost.

        Never raises: a malformed body prices at the floor — admission
        pricing must not pre-empt the typed ``invalid`` rejection the
        replica owns (charging garbage the minimum keeps the quota path
        orthogonal to validation).  ``cache_hit=True`` prices the
        request as a served-from-cache duplicate: :meth:`hit_units`.
        """
        if cache_hit:
            return self.hit_units()
        try:
            ck = self._cache_key(body, converge)
            with self._lock:
                units = self._cache.get(ck)
                if units is not None:
                    self._cache.move_to_end(ck)
                    return units
            units = self._clamp(self._price_uncached(body, converge))
            with self._lock:
                self._cache[ck] = units
                while len(self._cache) > self._cache_size:
                    self._cache.popitem(last=False)
            return units
        except Exception:  # noqa: BLE001 — never pre-empt typed invalid
            return self.min_units

    # -- internals ------------------------------------------------------------
    def _clamp(self, units: float) -> float:
        return max(self.min_units, min(self.max_units, float(units)))

    @staticmethod
    def _cache_key(body: dict, converge: bool) -> tuple:
        fields = ("rows", "cols", "mode", "filter", "iters", "backend",
                  "storage", "fuse", "boundary", "quantize", "solver",
                  "max_iters", "mg_levels", "depth")
        return (converge,) + tuple(repr(body.get(k)) for k in fields)

    def _price_uncached(self, body: dict, converge: bool) -> float:
        from parallel_convolution_tpu_torch.ops.filters import get_filter

        if str(body.get("mode") or "") == "volume":
            return self._price_volume(body, converge)
        rows = max(1, int(body.get("rows", 1)))
        cols = max(1, int(body.get("cols", 1)))
        channels = 3 if body.get("mode") == "rgb" else 1
        filt = get_filter(str(body.get("filter") or "blur3"))
        storage = str(body.get("storage") or "f32")
        if storage not in costmodel.STORAGE_BYTES:
            storage = "f32"
        quantize = bool(body.get("quantize", not converge))
        backend = str(body.get("backend") or "shifted")
        if backend == "auto":
            # Pricing needs no plan resolution: the normative compiled
            # tier is a fair stand-in, and relative cost is what meters.
            backend = "shifted"
        try:
            fuse = max(1, int(body.get("fuse") or 1))
        except (TypeError, ValueError):
            fuse = 1
        R, Q = self.grid
        shape = (channels, rows, cols)
        block_hw = (max(1, -(-rows // R)), max(1, -(-cols // Q)))
        n_dev = R * Q
        px = channels * rows * cols

        if converge and str(body.get("solver") or "jacobi") == "multigrid":
            max_iters = max(1, int(body.get("max_iters", 500)))
            levels = body.get("mg_levels")
            cycle_s, wu_per_cycle = costmodel.predict_mg_cycle_seconds(
                shape, self.grid, filt.size, "f32", False, self.hw,
                levels=(None if levels is None else int(levels)),
                backend=backend)
            # max_iters bounds FINE-GRID WORK UNITS (the stream's own
            # budget semantics) — the job runs at most this many cycles.
            cycles = max(1.0, max_iters / max(wu_per_cycle, 1e-9))
            return cycles * cycle_s / n_dev
        iters = (max(1, int(body.get("max_iters", 500))) if converge
                 else max(1, int(body.get("iters", 1))))
        spp = costmodel.predict_seconds_per_px_iter(
            backend, storage, fuse, None, shape, block_hw, self.grid,
            filt.size, filt.separable() is not None, quantize, self.hw)
        return spp * px * iters / n_dev

    def _price_volume(self, body: dict, converge: bool) -> float:
        """Rank-3 bodies (``mode="volume"``): predicted device-seconds
        through the rank-3 roofline — ``rows``/``cols`` are the (H, W)
        plane, ``depth`` the resident D axis, cells counted over the
        two live fields."""
        from parallel_convolution_tpu_torch.utils.config import (
            VOLUME_FIELDS, VOLUME_RADII,
        )

        rows = max(1, int(body.get("rows", 1)))
        cols = max(1, int(body.get("cols", 1)))
        depth = max(1, int(body.get("depth", 1)))
        name = str(body.get("filter") or "fd7")
        radius = VOLUME_RADII.get(name, 1)
        try:
            fuse = max(1, int(body.get("fuse") or 1))
        except (TypeError, ValueError):
            fuse = 1
        R, Q = self.grid
        block_hw = (max(1, -(-rows // R)), max(1, -(-cols // Q)))
        n_dev = R * Q
        cells = VOLUME_FIELDS * depth * rows * cols
        iters = (max(1, int(body.get("max_iters", 500))) if converge
                 else max(1, int(body.get("iters", 1))))
        spc = costmodel.predict_volume_seconds_per_cell_iter(
            self.grid, block_hw, depth, radius, fuse, name, self.hw,
            fields=VOLUME_FIELDS)
        return spc * cells * iters / n_dev
