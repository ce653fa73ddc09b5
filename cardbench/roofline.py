"""The least time a piece of work can take on the card, at its published
peaks (NVIDIA H100 SXM data sheet, dense, at the full 700 W).

The work of an iterated filter is what the image needs: every output
pixel of every level once, at the filter's fewest FP32 operations, and
every input byte read once and every output byte written once.  What an
implementation adds (the apron levels that a fused kernel recomputes,
intermediates between launches, copies) is not work: a share of this
bound reads the same work whatever implements it, and cannot pass 1.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM5: FP32 outside the tensor cores, HBM3 bandwidth.
PEAKS = {"fp32_ops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
DTYPE_BYTES = {"u8": 1, "bf16": 2, "f32": 4}


def _rank1(t: np.ndarray):
    """(column, row) with ``t == outer(column, row)``, or None."""
    u, s, vt = np.linalg.svd(t)
    if s.size > 1 and s[1] > 1e-12 * max(s[0], 1.0):
        return None
    col, row = u[:, 0] * s[0], vt[0]
    return col, row


def ops_per_pixel_level(taps, quantize: bool) -> int:
    """The fewest FP32 operations one output pixel of one level needs: a
    dot product of n nonzero taps is 1 multiply and n - 1 fused
    multiply-adds (an FMA counts 2), so 2n - 1; a separable filter as two
    1-D passes; the store-back's round, and a clamp's min and max where
    the taps can leave [0, 255] (not all nonnegative summing to <= 1)."""
    t = np.asarray(taps, dtype=np.float64)
    sep = _rank1(t)
    if sep is not None:
        ops = sum(2 * int(np.count_nonzero(np.abs(v) > 1e-12)) - 1
                  for v in sep)
    else:
        ops = 2 * int(np.count_nonzero(t)) - 1
    if quantize:
        convex = bool((t >= 0).all() and t.sum() <= 1.0 + 1e-12)
        ops += 1 if convex else 3
    return ops


def iterate_work(taps, quantize: bool, pixels: int, iters: int,
                 storage: str) -> tuple[float, float]:
    """(operations, bytes) of ``iters`` levels over ``pixels`` pixel
    planes (channels counted): each level's pixels at the fewest
    operations, the input read and the output written once."""
    ops = float(ops_per_pixel_level(taps, quantize)) * pixels * iters
    nbytes = 2.0 * pixels * DTYPE_BYTES[storage]
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time of (ops, bytes) at the peaks, and which bounds it."""
    t_ops = ops / PEAKS["fp32_ops_per_s"]
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_share(ctx: dict) -> float | None:
    """Percent: the least time of a window's jobs (``ctx``'s ``job_ops``,
    ``job_bytes`` and ``jobs``) over the device time of every kernel the
    traced window ran; None without a trace or kernels."""
    s = ctx.get("trace")
    kernel_s = sum(s["kernels"].values()) if s else 0.0
    if kernel_s <= 0 or "job_ops" not in ctx:
        return None
    least, _ = least_seconds(ctx["job_ops"], ctx["job_bytes"])
    return 100.0 * least * ctx["jobs"] / kernel_s
