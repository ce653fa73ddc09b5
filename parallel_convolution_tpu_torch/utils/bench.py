"""The benchmark module of the port (the JAX package's ``utils/bench.py``):
``wall``, ``slope_wall``, ``bench_iterate`` (Gpixels/s/chip, BASELINE.json's
headline metric), ``bench_converge`` (Jacobi or multigrid to a tolerance),
``bench_halo_p50`` (halo-exchange p50 latency, its second metric) and
``bench_oracle_proxy`` (the serial CPU baseline, BASELINE config 1).

On the card every time is taken with CUDA events after a warm-up: PyTorch
returns before the card finishes, so a host clock without a synchronise
would measure the enqueue.  ``bench_converge`` takes the host clock around
a run whose every chunk (or V-cycle) ends in a readback, which fences it.
A grid the caller put on the CPU times the plain versions with the host
clock and stamps ``"device": "cpu"``; nothing here chooses the CPU by
itself.  The JAX package's readback fence and fence-constant slopes for
proxy platforms have no counterpart: a CUDA event is a true fence.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from parallel_convolution_tpu_torch.ops.filters import Filter
from parallel_convolution_tpu_torch.parallel import step as step_lib
from parallel_convolution_tpu_torch.parallel.mesh import Grid, make_grid
from parallel_convolution_tpu_torch.utils.platform import device_kind, topology


def cuda_ms(fn, reps: int, warmup: int = 2,
            queue_ahead: bool = False) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events over
    ``reps`` back-to-back calls after ``warmup`` calls.

    Where one call's host time exceeds its kernel's, the card idles between
    the launches and the events time the host.  ``queue_ahead`` holds the
    card in a spin kernel (``torch.cuda._sleep``) long enough for the host
    to enqueue every call first, so that the events time the launches back
    to back: the device's own time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if queue_ahead:
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        # Twice the enqueue time at 2 GHz, the H100's clock at most.
        torch.cuda._sleep(int(2e9 * (2 * host * reps + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def wall(fn, device, warmup: int = 1, reps: int = 3) -> float:
    """Seconds of one ``fn()`` on ``device``: CUDA events on the card (mean
    of ``reps``), the median host-clock time of ``reps`` on the CPU."""
    if torch.device(device).type == "cuda":
        return cuda_ms(fn, reps, warmup) / 1e3
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _device_of(x) -> torch.device:
    """The device of a tensor, or of the first block of a grid's blocks."""
    while not torch.is_tensor(x):
        x = x[0]
    return x.device


def _span_seconds(fn, n: int, device) -> float:
    """Seconds of ``n`` chained ``fn`` calls: CUDA events on the card (the
    card synchronised first), the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn(n)
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    fn(n)
    return time.perf_counter() - t0


def slope_wall(fn, x, reps: int = 3, chain: int = 4) -> float:
    """Seconds of one ``fn`` call with the constant of a timed span
    cancelled: ``fn`` maps a state to a state of the same form (a tensor
    or a grid's blocks), and each rep times a ``chain``-call span and a
    1-call span; the slope ``(median chain − median single) / (chain −
    1)`` is the answer.  A slope at or under zero (noise swamped the
    chain) gives the chained span's mean, an upper bound."""
    device = _device_of(x)
    state = fn(x)  # warm
    chain = max(2, int(chain))

    def run(n):
        nonlocal state
        for _ in range(n):
            state = fn(state)

    singles, chains = [], []
    for _ in range(max(1, reps)):
        singles.append(_span_seconds(run, 1, device))
        chains.append(_span_seconds(run, chain, device))
    secs = (statistics.median(chains) - statistics.median(singles)) / (
        chain - 1)
    if secs <= 0:
        secs = max(statistics.median(chains) / chain, 1e-9)
    return secs


def bench_iterate(shape, filt: Filter, iters: int, grid: Grid | None = None,
                  channels: int = 1, backend: str = "shifted",
                  quantize: bool = True, storage: str = "f32",
                  fuse: int | None = 1, boundary: str = "zero",
                  reps: int = 3, tile=None, fallback: bool = False,
                  device=None, interior_split: bool = False,
                  overlap: bool | None = None,
                  col_mode: str | None = None) -> dict:
    """Gpixels/s of the fixed-iteration workload on one device.

    The image (seeded, u8-range) is moved and cut once; each rep runs
    ``iterate_prepared`` from the previous rep's blocks, so only the
    iteration is timed.  The row carries the JAX row's keys (``workload``,
    ``mesh``, ``devices`` = blocks, ``plan_key``, ``wall_s``,
    ``gpixels_per_s``, ``timing``, ``hosts``, ``slice_topology``, ...)
    beside the port's own, the exchange attribution among them
    (``exchange_fraction``, ``exchange_hidden_fraction``, ``halo_bytes``:
    ``obs.attribution``; the run also feeds the drift series per
    ``plan_key``).  ``backend="auto"`` (with ``fuse=None`` /
    ``tile=None``) resolves through ``tuning`` first; the row records the
    backend, fuse and tile the run ACTUALLY used and ``plan_source``
    (``explicit`` for a named backend), beside the cost model's prediction
    for the same point.  ``fallback=True`` walks the degradation chain
    (``resilience.degrade``) on a transient failure first, probed at the
    real block and storage: the row's ``effective_backend`` is the backend
    that produced the number, ``backend`` the one asked for.
    ``interior_split`` benches K2's 9-patch launch (``cuda`` /
    ``cuda_sep`` at fuse > 1 on a ``zero`` boundary).  On a grid of slots
    the row stamps the slots and the resolved ``col_mode``
    (``cuda_rdma``'s column transport); ``overlap`` is a request, and the
    row stamps the value the run used (``step.resolve_overlap``'s clamps,
    the tuner's verdict under ``auto``).
    """
    from parallel_convolution_tpu_torch.tuning import costmodel, search
    from parallel_convolution_tpu_torch.tuning.plans import Workload

    if grid is None:
        grid = make_grid(device=device)
    H, W = shape
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, size=(channels, H, W)).astype(np.float32)
    blocks, valid_hw, block_hw = step_lib._prepare(x, grid, storage)
    eff, fuse, tile, source = step_lib._resolve_auto(
        grid, filt, backend, fuse, tile, storage, quantize, boundary,
        valid_hw, channels)
    fuse = max(1, min(int(fuse), iters or 1))  # as _build_iterate clamps
    overlap = step_lib._auto_overlap(overlap, source)
    eff, col_mode, overlap = step_lib._run_knobs(
        grid, filt, eff, fuse, tile, storage, quantize, boundary, block_hw,
        interior_split, fallback, overlap, col_mode)

    state = blocks

    def run():
        nonlocal state
        state = step_lib.iterate_prepared(
            state, filt, iters, grid, valid_hw, quantize=quantize,
            backend=eff, fuse=fuse, boundary=boundary, tile=tile,
            interior_split=interior_split, check_contract=False,
            overlap=overlap, col_mode=col_mode)

    secs = wall(run, grid.device, warmup=1, reps=max(1, reps))
    w = Workload.from_grid(grid, filt, (channels, H, W), storage=storage,
                           quantize=quantize, boundary=boundary)
    hw = costmodel.hardware_for_grid(grid)
    compiled_tile = costmodel.effective_tile(eff, tile, block_hw,
                                             filt.radius, fuse, hw.smem_optin)
    predicted = costmodel.predict_gpx_per_chip(search.predict(
        w, search.Candidate(eff, fuse, tile, overlap, col_mode), hw))
    on_card = grid.device.type == "cuda"
    gpx = H * W * channels * iters / secs / 1e9
    chips = len(set(grid.slots))
    # The exchange attribution (obs.attribution): the analytic
    # per-direction ghost bytes of this decomposition and the cost model's
    # exchange share.  record_step feeds the metric series AND returns
    # what the row stamps; with obs off the row's fields are computed
    # directly (arithmetic, always on).
    from parallel_convolution_tpu_torch.obs import attribution

    att = step_lib._record_step_obs(
        eff, grid, filt, block_hw, fuse, iters, channels, storage, boundary,
        secs, valid_hw, quantize, tile, source="bench", overlap=overlap,
        col_mode=col_mode)
    if att is None:
        split = attribution.predicted_exchange_split(
            grid.shape, block_hw, filt.radius, fuse, backend=eff,
            storage=storage, tile=tile, quantize=quantize,
            separable=eff in costmodel.SEPARABLE_BACKENDS, overlap=overlap,
            col_mode=col_mode,
            **step_lib._obs_model(grid, filt, block_hw, channels, valid_hw))
        att = {"halo_bytes": attribution.halo_bytes_total(
                   grid.shape, block_hw, filt.radius, fuse, iters, channels,
                   storage, boundary),
               "exchange_fraction": split["exchange_fraction"],
               "exchange_hidden_fraction": split["exchange_hidden_fraction"]}
    # The drift series (the cost model's recalibration input): this
    # measurement against the model's figure, per plan key.
    attribution.record_drift(w.key(), eff, predicted, gpx / chips)
    return {
        "workload": f"{filt.name} {H}x{W}x{channels} {iters} iters",
        "shape": [channels, H, W], "filter": filt.name, "iters": iters,
        "grid": f"{grid.rows}x{grid.cols}", "backend": backend,
        "effective_backend": eff, "fuse": fuse,
        "tile": list(compiled_tile) if compiled_tile else None,
        "storage": storage, "quantize": quantize, "boundary": boundary,
        "interior_split": bool(interior_split),
        # The resolved knobs: the overlap the run used, the column
        # transport.
        "overlap": overlap, "col_mode": col_mode,
        "slots": grid.slot_map() if grid.slotted else None,
        "seconds": secs, "wall_s": secs,
        "gpixels_per_s": gpx, "gpixels_per_s_per_chip": gpx / chips,
        "predicted_gpx_per_chip": predicted,
        "plan_source": source or "explicit", "plan_key": w.key(),
        "platform": "gpu" if on_card else "cpu",
        "device": device_kind(grid.device),
        "device_kind": device_kind(grid.device),
        "mesh": f"{grid.rows}x{grid.cols}",
        # Blocks (the JAX row's mesh.size), and the distinct devices.
        "devices": grid.rows * grid.cols, "chips": chips,
        **topology(grid),
        "timing": "cuda-events" if on_card else "host-clock",
        # The model's exposed exchange share of one iteration, the share
        # the overlapped pipeline hides (0.0 serialized), and the ghost
        # bytes this run moved (whole grid, all rounds, per direction).
        "exchange_fraction": round(att["exchange_fraction"], 4),
        "exchange_hidden_fraction": round(att["exchange_hidden_fraction"],
                                          4),
        "halo_bytes": att["halo_bytes"],
    }


def converge_input(shape, channels: int = 1, seed: int = 0) -> np.ndarray:
    """The seeded float field a convergence benchmark smooths: standard
    normal values, (channels, H, W) f32 (the JAX ``bench_converge``'s)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((channels, *shape)).astype(np.float32)


def bench_converge(shape, filt: Filter, tol: float, max_iters: int,
                   grid: Grid | None = None, channels: int = 1,
                   backend: str = "shifted", storage: str = "f32",
                   boundary: str = "zero", check_every: int = 10,
                   fuse: int | None = 1, tile=None, solver: str = "jacobi",
                   mg_levels: int | None = None, seed: int = 0,
                   device=None) -> dict:
    """One run-to-convergence row (float mode) of the JAX package's
    ``bench_converge``, comparable across solvers: ``work_units_to_tol``
    is the fine-grid work spent (iterations for Jacobi, the pixel-weighted
    per-level sum for multigrid), so a multigrid row and a Jacobi row on
    the same problem divide into the convergence speedup.  The run goes to
    ``tol`` on a seeded normal field and the row records whether it got
    there (``diff < tol`` itself, not ``iters < max_iters``), the wall
    seconds, the fine-grid Gpx/s, and ``readbacks``: the readbacks the run
    made (one per Jacobi chunk or V-cycle).  ``backend="auto"`` resolves
    first, so the row names the backend that ran.  Multigrid rows stamp
    the levels the planner scheduled (``mg_levels``, not the requested
    cap), and their ``plan_key`` ends in ``|solver=multigrid``."""
    from parallel_convolution_tpu_torch.tuning.plans import Workload
    from parallel_convolution_tpu_torch.utils.config import check_solver

    check_solver(solver)
    if grid is None:
        grid = make_grid(device=device)
    H, W = shape
    x = converge_input((H, W), channels, seed)
    eff, fuse, tile, _ = step_lib._resolve_auto(
        grid, filt, backend, fuse, tile, storage, False, boundary, (H, W),
        channels, check_every=int(check_every))
    w = Workload.from_grid(grid, filt, (channels, H, W), storage=storage,
                           quantize=False, boundary=boundary)
    row = {
        "workload": f"converge {filt.name} {H}x{W}x{channels} tol={tol}",
        "backend": eff,
        "solver": solver,
        "storage": storage,
        "boundary": boundary,
        "platform": "gpu" if grid.device.type == "cuda" else "cpu",
        "device_kind": device_kind(grid.device),
        "mesh": f"{grid.rows}x{grid.cols}",
        # Blocks, all on the one device (the JAX row's mesh.size).
        "devices": grid.rows * grid.cols,
        "tol": float(tol),
        **topology(grid),
    }
    t0 = time.perf_counter()
    if solver == "multigrid":
        from parallel_convolution_tpu_torch.solvers import multigrid

        before = multigrid.mg_converge.readbacks
        out, res = multigrid.mg_converge(
            x, filt, tol=tol, max_iters=max_iters, grid=grid,
            quantize=False, backend=eff, storage=storage, boundary=boundary,
            fuse=fuse, tile=tile, mg_levels=mg_levels)
        row.update({
            "effective_backend": res.backend,
            "overlap": res.overlap,
            "col_mode": res.col_mode,
            "converged": res.converged,
            "residual": float(res.residual),
            "cycles": res.cycles,
            "mg_levels": res.levels,
            "mg_level_shapes": res.level_shapes,
            "work_units_to_tol": res.work_units,
            "predicted_s_per_cycle": res.predicted_s_per_cycle,
            "plan_key": f"{w.key()}|solver=multigrid",
            "readbacks": multigrid.mg_converge.readbacks - before,
        })
    else:
        before = step_lib.sharded_converge_stream.readbacks
        out, iters, diff = x, 0, None
        for out, iters, diff in step_lib.sharded_converge_stream(
                x, filt, tol=tol, max_iters=max_iters,
                check_every=check_every, grid=grid, quantize=False,
                backend=eff, storage=storage, boundary=boundary, fuse=fuse,
                tile=tile):
            pass
        row.update({
            "effective_backend": eff,
            # The column transport the run resolved (auto, as the
            # stream's own resolution).
            "col_mode": step_lib.resolve_col_mode(
                None, eff, grid, w.block_hw, filt.radius, int(fuse or 1),
                storage),
            "converged": diff is not None and diff < tol,
            "residual": diff,
            "iters": iters,
            "mg_levels": None,
            "work_units_to_tol": float(iters),
            "plan_key": w.key(),
            "readbacks": step_lib.sharded_converge_stream.readbacks - before,
        })
    secs = max(time.perf_counter() - t0, 1e-9)
    row["wall_s"] = secs
    row["gpixels_per_s"] = (row["work_units_to_tol"] * H * W * channels
                            / secs / 1e9)
    row["checksum"] = (float(out.abs().max()) if torch.is_tensor(out)
                       else float(np.abs(np.asarray(out)).max()))
    return row


# ---------------------------------------------------------------------------
# Halo-exchange latency
# ---------------------------------------------------------------------------


def halo_bench_rounds(grid: Grid, r: int, exchange: bool):
    """The halo benchmark's round runner: ``run(blocks, n)`` chains ``n``
    rounds over the grid's blocks and returns the blocks.

    The live round (``exchange=True``) pads every block with
    ``parallel/halo.py:halo_exchange`` and carries forward the (bh, bw)
    window that STARTS at the ghost corner: it consumes the ghosts, so the
    data moves across blocks and no round is a no-op.  The control round
    moves the same window with a local ``torch.roll`` by the same shift
    (the consumer's bytes, no exchange)."""
    from parallel_convolution_tpu_torch.parallel import halo

    def run(blocks, n: int):
        for _ in range(n):
            if exchange:
                padded = halo.halo_exchange(blocks, r, grid.shape)
                blocks = [[p[:, :b.shape[1], :b.shape[2]]
                           for p, b in zip(prow, brow)]
                          for prow, brow in zip(padded, blocks)]
            else:
                blocks = [[torch.roll(b, (r, r), dims=(1, 2)) for b in row]
                          for row in blocks]
        return blocks

    return run


def bench_halo_p50(block_shape, r: int = 1, grid: Grid | None = None,
                   trials: int = 20, chain_rounds: int | None = None,
                   channels: int = 1, device=None) -> dict:
    """p50 amortized latency of one halo exchange over the grid's blocks.

    ``block_shape`` is the block (the reference's per-rank tile).  The
    JAX package's procedure: each trial times one span of
    ``chain_rounds`` chained LIVE exchange rounds and one span of as many
    local-control rounds (:func:`halo_bench_rounds`), and reports their
    difference divided by the count; p50/p90 are over trials.  On one card
    the exchange is ``parallel/halo.py:halo_exchange`` between the blocks
    in device memory: the per-level host term of the fuse-1 path (its
    allocation and copy launches), which is what this number times
    (CUDA events around each span; the host clock on the CPU).
    ``cuda_rdma`` exchanges inside its kernel and has no separate exchange
    to time.  ``channels`` is the image's (the JAX package times one
    plane; an RGB block moves three).  A 1×1 grid has no neighbour to exchange with: the row is an
    explicit sentinel, never a vacuous 0.
    """
    if grid is None:
        grid = make_grid(device=device)
    bh, bw = block_shape
    base = {"block": f"{bh}x{bw}", "radius": r, "channels": int(channels),
            "mesh": f"{grid.rows}x{grid.cols}",
            "exchange": "parallel/halo.py",
            "device_kind": device_kind(grid.device)}
    if grid.shape == (1, 1):
        return {**base, "p50_us": None, "p90_us": None,
                "unmeasurable": "1x1 grid has no neighbour exchange to time"}
    H, W = bh * grid.rows, bw * grid.cols
    x = torch.from_numpy(np.random.default_rng(0).random(
        (int(channels), H, W)).astype(np.float32)).to(grid.device)
    from parallel_convolution_tpu_torch.parallel.mesh import split_blocks

    blocks = split_blocks(x, grid)
    del x
    k = max(1, int(chain_rounds or 256))
    live, ctl = halo_bench_rounds(grid, r, True), halo_bench_rounds(grid, r,
                                                                   False)
    state = {"live": live(blocks, 2), "ctl": ctl(blocks, 2)}  # warm

    def leg(name, fn):
        def run(n):
            state[name] = fn(state[name], n)
        return _span_seconds(run, k, grid.device)

    times, clamped = [], 0
    for _ in range(max(1, trials)):
        d = (leg("live", live) - leg("ctl", ctl)) / k
        if d <= 0:
            clamped += 1  # noise swamped the exchange; never emit < 0
            d = 0.0
        times.append(d)
    times.sort()
    p50 = 1e6 * times[len(times) // 2]
    p90 = 1e6 * times[int(len(times) * 0.9)]
    row = {**base, "p50_us": p50, "p90_us": p90, "trials": len(times),
           "rounds_per_trial": k, "timing": f"amortized-diff-{k}"}
    if clamped:
        row["clamped_trials"] = clamped
    if p50 <= 0.0 and clamped:
        # The median sits on the clamp: no measurement, a flagged null.
        row["p50_us"] = None
        row["noise_floor"] = True
        if p90 <= 0.0:
            row["p90_us"] = None
    return row


def bench_oracle_proxy(shape=(1920, 2520), iters: int = 2,
                       reps: int = 5) -> dict:
    """Serial CPU baseline (BASELINE config 1): the native C++ serial run
    on one thread when its library builds (the stand-in for the
    reference's C), else the NumPy oracle.  The median of ``reps`` trials,
    with the min→max spread."""
    from parallel_convolution_tpu_torch.ops import oracle
    from parallel_convolution_tpu_torch.ops.filters import get_filter

    H, W = shape
    img = np.random.default_rng(0).integers(0, 256, size=(H, W)).astype(
        np.uint8)
    filt = get_filter("blur3")
    run = oracle.run_serial_u8
    impl = "numpy-oracle"
    try:
        from parallel_convolution_tpu_torch.native import serial_native

        # Outside the timed span: a first-use g++ build, or page-in.
        serial_native.run_serial_u8(img[:8, :8], filt, 1)
    except RuntimeError:
        pass  # no g++ here: the NumPy oracle is the baseline
    else:
        # threads=1: the strict serial baseline, not the OpenMP tier.
        def run(*a):
            return serial_native.run_serial_u8(*a, threads=1)
        impl = "cpp-serial"
    walls = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        run(img, filt, iters)
        walls.append(max(time.perf_counter() - t0, 1e-9))
    secs = statistics.median(walls)
    return {
        "workload": f"serial blur3 {H}x{W} {iters} iters",
        "impl": impl,
        "wall_s": secs,
        "gpixels_per_s": H * W * iters / secs / 1e9,
        "reps": len(walls),
        "spread_pct": 100.0 * (max(walls) - min(walls)) / secs,
    }
