"""Timing for the tuner and ``chip_smoke.py`` (the part of the JAX
package's ``utils/bench.py`` they need: ``wall``, ``bench_iterate``).

On the card every time is taken with CUDA events after a warm-up: PyTorch
returns before the card finishes, so a host clock without a synchronise
would measure the enqueue.  A grid the caller put on the CPU times the
plain versions with the host clock and stamps ``"device": "cpu"``; nothing
here chooses the CPU by itself.  ``bench_converge``, the halo bench and the
oracle proxy wait for their items (ROADMAP.md, "Port: still to port").
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from parallel_convolution_tpu_torch.ops.filters import Filter
from parallel_convolution_tpu_torch.parallel import step as step_lib
from parallel_convolution_tpu_torch.parallel.mesh import Grid, make_grid
from parallel_convolution_tpu_torch.utils.platform import device_kind


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


def bench_iterate(shape, filt: Filter, iters: int, grid: Grid | None = None,
                  channels: int = 1, backend: str = "shifted",
                  quantize: bool = True, storage: str = "f32",
                  fuse: int | None = 1, boundary: str = "zero",
                  reps: int = 3, tile=None, device=None) -> dict:
    """Gpixels/s of the fixed-iteration workload on one device.

    The image (seeded, u8-range) is moved and cut once; each rep runs
    ``iterate_prepared`` from the previous rep's blocks, so only the
    iteration is timed.  ``backend="auto"`` (with ``fuse=None`` /
    ``tile=None``) resolves through ``tuning`` first; the row records the
    backend, fuse and tile the run ACTUALLY used and ``plan_source``
    (``explicit`` for a named backend), beside the cost model's prediction
    for the same point.
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

    state = blocks

    def run():
        nonlocal state
        state = step_lib.iterate_prepared(
            state, filt, iters, grid, valid_hw, quantize=quantize,
            backend=eff, fuse=fuse, boundary=boundary, tile=tile,
            check_contract=False)

    secs = wall(run, grid.device, warmup=1, reps=max(1, reps))
    w = Workload.from_grid(grid, filt, (channels, H, W), storage=storage,
                           quantize=quantize, boundary=boundary)
    hw = costmodel.hardware_for_grid(grid)
    compiled_tile = costmodel.effective_tile(eff, tile, block_hw,
                                             filt.radius, fuse, hw.smem_optin)
    predicted = costmodel.predict_gpx_per_chip(search.predict(
        w, search.Candidate(eff, fuse, tile), hw))
    on_card = grid.device.type == "cuda"
    return {
        "shape": [channels, H, W], "filter": filt.name, "iters": iters,
        "grid": f"{grid.rows}x{grid.cols}", "backend": backend,
        "effective_backend": eff, "fuse": fuse,
        "tile": list(compiled_tile) if compiled_tile else None,
        "storage": storage, "quantize": quantize, "boundary": boundary,
        "seconds": secs,
        "gpixels_per_s_per_chip": H * W * channels * iters / secs / 1e9,
        "predicted_gpx_per_chip": predicted,
        "plan_source": source or "explicit",
        "platform": "gpu" if on_card else "cpu",
        "device": device_kind(grid.device),
    }
