"""Exchange attribution: halo bytes and the exchange-vs-compute split (the
port's counterpart of the JAX package's ``obs/attribution.py``).

Two parts, ported differently:

* **The bytes**, as in JAX, formula for formula: :func:`halo_bytes_per_round`
  prices the decomposition (grid, block, radius, fuse, storage, boundary),
  not the transport, so it is the same on a TPU mesh, on one card's grid
  of blocks and on a grid of slots.  It mirrors ``parallel/halo.py``'s
  two-phase exchange: the row phase moves a ``channels × d × bw`` slab per
  direction (``d = radius·fuse``), zero boundaries send from ``R-1`` of
  the ``R`` rows, periodic ones from all ``R``, a 1-long axis sends
  nothing; the column phase cuts its slabs from the row-padded block, so
  their height is ``bh + 2d`` and the corners ride it.  ``cuda_rdma``
  reads the same ghost bands inside its launch.
* **The split** (:func:`predicted_exchange_split`) is rewritten on the
  port's H100 cost model (``tuning.costmodel.predict_terms``, the terms
  ``predict_seconds_per_px_iter`` sums), in place of the TPU roofline.

Every metric series, label and event field is the JAX package's, so one
report reads either package's runs.
"""

from __future__ import annotations

import time

from parallel_convolution_tpu_torch.obs import events, metrics, trace
from parallel_convolution_tpu_torch.tuning import costmodel

__all__ = [
    "exchange_rounds", "halo_bytes_per_round", "halo_bytes_total",
    "predicted_exchange_fraction", "predicted_exchange_split",
    "record_drift", "record_step", "volume_face_bytes_per_round",
]

DIRECTIONS = ("north", "south", "east", "west")


def halo_bytes_per_round(grid: tuple[int, int], block_hw: tuple[int, int],
                         radius: int, fuse: int, channels: int,
                         storage: str, boundary: str = "zero") -> dict:
    """Per-direction bytes crossing between blocks in ONE exchange round,
    summed over the whole grid.

    A "round" is one exchange at ghost depth ``d = radius*fuse`` (the
    fused-chunk exchange).  Directions name where the data travels:
    ``south`` = toward higher row index, ``east`` = toward higher column
    index.  Zero-boundary edges send nothing outward (there is no
    neighbour); periodic boundaries close the ring — except on a 1-long
    axis, where the wrap is the identity and nothing moves.
    """
    R, C = (int(g) for g in grid)
    bh, bw = (int(b) for b in block_hw)
    d = int(radius) * max(1, int(fuse))
    B = costmodel.STORAGE_BYTES[storage]
    periodic = boundary == "periodic"
    row_senders = (R if periodic else R - 1) if R > 1 else 0
    col_senders = (C if periodic else C - 1) if C > 1 else 0
    row_slab = channels * d * bw * B          # phase 1: (C, d, bw)
    col_slab = channels * d * (bh + 2 * d) * B  # phase 2: row-padded height
    out = {
        "south": row_senders * C * row_slab,
        "north": row_senders * C * row_slab,
        "east": col_senders * R * col_slab,
        "west": col_senders * R * col_slab,
    }
    out["total"] = sum(out.values())
    return out


def volume_face_bytes_per_round(grid: tuple[int, int],
                                block_hw: tuple[int, int], depth: int,
                                radius: int, fuse: int, fields: int = 2,
                                storage: str = "f32",
                                boundary: str = "zero") -> dict:
    """Per-direction bytes of ONE rank-3 6-face ghost exchange.

    The ±D faces are a local pad (the depth axis is resident,
    ``volumes.halo3``), so only the ±H/±W face slabs move, and each slab
    carries the whole depth-padded field column: the rank-2 slab
    arithmetic at an effective channel count of
    ``fields * (depth + 2d)``."""
    d = int(radius) * max(1, int(fuse))
    ch = max(1, int(fields)) * (max(1, int(depth)) + 2 * d)
    return halo_bytes_per_round(grid, block_hw, radius, fuse, ch,
                                storage, boundary)


def exchange_rounds(iters: int, fuse: int) -> tuple[int, int]:
    """``(full_rounds, tail_iters)`` of the fused iteration schedule: one
    exchange per ``fuse``-iteration chunk plus one for the remainder chunk
    (at its own shallower depth)."""
    fuse = max(1, min(int(fuse), max(1, int(iters))))
    return int(iters) // fuse, int(iters) % fuse


def halo_bytes_total(grid, block_hw, radius: int, fuse: int, iters: int,
                     channels: int, storage: str,
                     boundary: str = "zero") -> dict:
    """Per-direction bytes for a whole ``iters``-iteration run: full fused
    rounds at depth ``radius*fuse`` plus the tail round at its own depth
    (``radius * (iters % fuse)``), the schedule ``step._build_iterate``
    runs."""
    full, rem = exchange_rounds(iters, fuse)
    total = {d: 0 for d in (*DIRECTIONS, "total")}
    per = halo_bytes_per_round(grid, block_hw, radius, fuse, channels,
                               storage, boundary)
    for k in total:
        total[k] += full * per[k]
    if rem:
        tail = halo_bytes_per_round(grid, block_hw, radius, rem, channels,
                                    storage, boundary)
        for k in total:
            total[k] += tail[k]
    total["rounds"] = full + (1 if rem else 0)
    return total


def predicted_exchange_split(
        grid, block_hw, radius: int, fuse: int, *, backend: str,
        storage: str, shape: tuple[int, int, int],
        tile: tuple[int, int] | None = None, quantize: bool = True,
        separable: bool = False, platform: str = "cpu",
        device_kind: str = "", overlap: bool = False,
        col_mode: str = "packed", slotted: bool = False, cards: int = 1,
        ragged: bool = False, magic_round: bool = True,
        hw: costmodel.HardwareModel | None = None) -> dict:
    """Exchange-vs-compute attribution of one iteration of the H100 cost
    model, overlap-adjusted.

    Returns the JAX package's keys::

      {"exchange_fraction":        exposed exchange / total,
       "exchange_hidden_fraction": hidden exchange / total exchange,
       "exchange_hidden_of_total": hidden exchange / total,
       "overlap":                  the caller's knob, echoed verbatim}

    The terms are ``costmodel.predict_terms``'s, the ones
    ``predict_seconds_per_px_iter`` sums, so the split and the tuner read
    one model.  **Exchange** is what moves ghosts between blocks:

    * on one card (a one-device grid), the host's halo ops
      (``halo.halo_exchange``: ``HALO_OPS_PER_BLOCK`` PyTorch ops a block
      and a chunk, ``costmodel.halo_host_seconds_per_chunk``); the padded
      copy's bytes count as compute, as the model folds them into the
      kernels' byte term, and ``cuda_rdma`` reads its ghosts inside its
      launch, so its exchange there is 0;
    * on a grid of slots, also the device-side exchange
      (``slot_exchange_seconds_per_chunk``): ``cuda_rdma``'s column
      transport and, across cards, the ghost bytes over the link.

    **Total** is the model's time (``PredictTerms.seconds`` without the
    interpret penalty, which scales every term alike).  Serialized,
    nothing is hidden.  With ``overlap`` where ``costmodel.overlap_legal``
    holds, the device-side exchange rides under the compute: ``hidden =
    min(exchange, compute)``; the host's ops are never hidden.  A 1×1
    grid has no neighbour: 0 / 0.  ``hw`` defaults to
    ``costmodel.hardware_for(platform, device_kind)``.
    """
    out = {"exchange_fraction": 0.0, "exchange_hidden_fraction": 0.0,
           "exchange_hidden_of_total": 0.0, "overlap": bool(overlap)}
    if int(grid[0]) * int(grid[1]) == 1:
        return out
    if hw is None:
        hw = costmodel.hardware_for(platform, device_kind)
    terms = costmodel.predict_terms(
        backend, storage, max(1, int(fuse)), tile, tuple(shape),
        tuple(block_hw), tuple(grid), 2 * int(radius) + 1, separable,
        quantize, hw, ragged, magic_round, col_mode, slotted, cards,
        overlap)
    ex = terms.exchange + terms.halo_host
    if ex == 0.0:
        return out
    hidden = min(terms.exchange, terms.compute) if terms.overlap else 0.0
    total = terms.seconds / terms.penalty
    if total > 0:
        out["exchange_fraction"] = min(1.0, (ex - hidden) / total)
        out["exchange_hidden_of_total"] = min(1.0, hidden / total)
    out["exchange_hidden_fraction"] = min(1.0, hidden / ex)
    return out


def predicted_exchange_fraction(
        grid, block_hw, radius: int, fuse: int, *, backend: str,
        storage: str, shape: tuple[int, int, int],
        tile: tuple[int, int] | None = None, quantize: bool = True,
        separable: bool = False, platform: str = "cpu",
        device_kind: str = "", overlap: bool = False, **model) -> float:
    """The (exposed) exchange share of one iteration, in [0, 1]: the
    ``exchange_fraction`` member of :func:`predicted_exchange_split`
    (``model`` its port-only keywords)."""
    return predicted_exchange_split(
        grid, block_hw, radius, fuse, backend=backend, storage=storage,
        shape=shape, tile=tile, quantize=quantize, separable=separable,
        platform=platform, device_kind=device_kind,
        overlap=overlap, **model)["exchange_fraction"]


# -- the step-level recorder (metrics + event, one helper, several callers)
# parallel/step.py (iterate_prepared, sharded_converge), solvers/multigrid.py
# and utils/bench.py all call record_step, so the attribution lands in the
# same series whatever the entry point.

def _m():
    """Metric handles, created lazily through the global registry (so a
    registry reset in tests re-creates them on next use)."""
    return (
        metrics.histogram(
            "pctpu_step_seconds",
            "wall of one compiled iterate call (all fused blocks)",
            ("backend",)),
        metrics.counter(
            "pctpu_exchange_seconds_total",
            "model-attributed EXPOSED exchange share of step walls",
            ("backend",)),
        metrics.counter(
            "pctpu_compute_seconds_total",
            "model-attributed compute share of step walls", ("backend",)),
        metrics.counter(
            "pctpu_exchange_hidden_seconds_total",
            "model-attributed exchange time hidden under compute by the "
            "overlapped pipeline", ("backend",)),
        metrics.counter(
            "pctpu_halo_bytes_total",
            "analytic ghost-band bytes moved, per direction",
            ("backend", "direction")),
        metrics.counter(
            "pctpu_halo_rounds_total", "halo exchange rounds executed",
            ("backend",)),
        metrics.counter(
            "pctpu_iterations_total", "stencil iterations executed",
            ("backend",)),
    )


def record_step(*, backend: str, grid, block_hw, radius: int, fuse: int,
                iters: int, channels: int, storage: str, boundary: str,
                wall_s: float | None, shape, quantize: bool = True,
                tile=None, platform: str = "cpu", device_kind: str = "",
                source: str = "step", overlap: bool = False,
                col_mode: str = "packed",
                mg_level: int | None = None, **model) -> dict | None:
    """Record one iterate call: wall, halo bytes, exchange split (the JAX
    package's ``record_step``; ``model`` the port-only keywords of
    :func:`predicted_exchange_split`).

    ``col_mode`` stamps the column transport into the exchange event; the
    per-slab wait series ``pctpu_halo_slab_wait_seconds{direction,
    which}`` spreads the exchange wall over the four slab directions by
    their byte share, exposed against hidden.  ``mg_level`` attributes the
    call to one multigrid level (level 0 = the fine grid): the event
    carries it and ``pctpu_mg_sweeps_total`` gains the
    ``pctpu_mg_level`` label.

    ``wall_s=None`` means the caller has no honest device wall
    (``iterate_prepared`` returns before the card finishes, and a
    synchronize there would serialize the caller's work): the byte,
    round and iteration counters and the event still land, the wall
    histogram and the exchange / compute seconds do not.  Callers that
    fence (bench, the convergence readback) pass the real wall.

    Returns the attribution dict (halo bytes + fractions) for callers that
    stamp rows, or None when obs is disabled (nothing computed).
    """
    if not metrics.enabled():
        return None
    sep = backend in costmodel.SEPARABLE_BACKENDS
    by = halo_bytes_total(grid, block_hw, radius, fuse, iters, channels,
                          storage, boundary)
    split = predicted_exchange_split(
        grid, block_hw, radius, fuse, backend=backend, storage=storage,
        shape=shape, tile=tile, quantize=quantize, separable=sep,
        platform=platform, device_kind=device_kind, overlap=overlap,
        col_mode=col_mode, **model)
    frac = split["exchange_fraction"]
    hidden_of_ex = split["exchange_hidden_fraction"]
    wall, ex_s, comp_s, hid_s, hbytes, rounds, iters_m = _m()
    if wall_s is not None:
        wall.observe(wall_s, backend=backend)
        ex_s.inc(wall_s * frac, backend=backend)
        comp_s.inc(wall_s * (1.0 - frac), backend=backend)
        if split["exchange_hidden_of_total"] > 0.0:
            # Exchange time the pipeline rode under the compute share —
            # informational (it overlaps compute seconds, not additive).
            hid_s.inc(wall_s * split["exchange_hidden_of_total"],
                      backend=backend)
        if by["total"] > 0:
            # The exposed and hidden exchange walls spread across the
            # four slab directions by byte share: WHICH ghost direction a
            # decomposition waits on.
            slab = metrics.counter(
                "pctpu_halo_slab_wait_seconds",
                "model-attributed exchange wall per halo slab channel, "
                "exposed vs hidden-under-compute",
                ("backend", "direction", "which"))
            exposed_s = wall_s * frac
            hidden_s = wall_s * split["exchange_hidden_of_total"]
            for d in DIRECTIONS:
                share = by[d] / by["total"]
                if share <= 0.0:
                    continue
                slab.inc(exposed_s * share, backend=backend, direction=d,
                         which="exposed")
                if hidden_s > 0.0:
                    slab.inc(hidden_s * share, backend=backend,
                             direction=d, which="hidden")
    for d in DIRECTIONS:
        hbytes.inc(by[d], backend=backend, direction=d)
    rounds.inc(by["rounds"], backend=backend)
    iters_m.inc(iters, backend=backend)
    if mg_level is not None:
        metrics.counter(
            "pctpu_mg_sweeps_total",
            "multigrid smoothing sweeps executed per grid level",
            ("backend", "pctpu_mg_level")).inc(
            iters, backend=backend, pctpu_mg_level=str(int(mg_level)))
    events.emit(
        "exchange", source=source, backend=backend,
        grid=f"{grid[0]}x{grid[1]}", block=list(block_hw),
        radius=int(radius), fuse=int(fuse), iters=int(iters),
        storage=storage, boundary=boundary, rounds=by["rounds"],
        halo_bytes={d: by[d] for d in DIRECTIONS},
        exchange_fraction=round(frac, 4),
        overlap=bool(split["overlap"]),
        col_mode=str(col_mode),
        exchange_hidden_fraction=round(hidden_of_ex, 4),
        **({"mg_level": int(mg_level)} if mg_level is not None else {}),
        **({"wall_s": round(wall_s, 6)} if wall_s is not None else {}))
    # Under an active span (a traced converge), the measured wall splits
    # into model-attributed exchange / compute CHILD spans: the
    # reference's per-phase MPI_Wtime breakdown.  The exchange span's dur
    # is the EXPOSED share; the hidden share rides as an attribute, since
    # it overlaps the compute span's interval.
    ctx = trace.current()
    if ctx is not None and wall_s is not None and wall_s > 0:
        ex_s = wall_s * frac
        comp_s = wall_s - ex_s
        t0 = time.time() - wall_s
        trace.emit_span(
            "exchange", trace_id=ctx.trace_id, parent_id=ctx.span_id,
            start_ts=t0, dur_s=ex_s, backend=backend, source=source,
            overlap=bool(split["overlap"]),
            hidden_s=round(wall_s * split["exchange_hidden_of_total"], 6),
            halo_bytes=by["total"], rounds=by["rounds"])
        trace.emit_span(
            "compute", trace_id=ctx.trace_id, parent_id=ctx.span_id,
            start_ts=t0 + ex_s, dur_s=comp_s, backend=backend,
            source=source, iters=int(iters))
    return {"halo_bytes": by, "exchange_fraction": frac,
            "exchange_hidden_fraction": hidden_of_ex,
            "overlap": bool(split["overlap"])}


def record_drift(plan_key: str, backend: str, predicted_gpx: float | None,
                 measured_gpx: float | None) -> None:
    """The predicted-vs-measured Gpx/s/chip drift series per plan key (the
    cost model's recalibration input), fed by ``bench_iterate``."""
    if (not metrics.enabled() or not predicted_gpx
            or measured_gpx is None or measured_gpx <= 0):
        return
    g = metrics.gauge(
        "pctpu_plan_gpx_per_chip",
        "per-plan-key Gpx/s/chip, predicted vs measured",
        ("key", "backend", "which"))
    g.set(round(predicted_gpx, 6), key=plan_key, backend=backend,
          which="predicted")
    g.set(round(measured_gpx, 6), key=plan_key, backend=backend,
          which="measured")
    metrics.gauge(
        "pctpu_plan_drift_ratio",
        "measured/predicted Gpx/s per plan key (1.0 = calibrated)",
        ("key", "backend")).set(
        round(measured_gpx / predicted_gpx, 6), key=plan_key,
        backend=backend)
