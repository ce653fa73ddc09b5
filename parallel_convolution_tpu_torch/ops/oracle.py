"""NumPy serial oracle of the PyTorch port (its own copy of the JAX
package's ``ops/oracle.py``: the port imports nothing of that package).

The reference repo validates its MPI / MPI+OpenMP variants by byte-comparing
their output ``.raw`` images against the serial binary's output.  This module
*is* that serial binary for the new framework: a single-threaded NumPy
implementation whose behavior is the specification every PyTorch / CUDA /
sharded path must match **bit-exactly**.

Semantics specification (normative — the reference mount was empty during the
survey, so per SURVEY.md §7 the oracle defines the spec):

1. The image is zero-padded by the filter radius on all four sides each
   iteration (the reference's ``(rows+2)×(cols+2)`` ghost ring of zeros,
   SURVEY.md §3.1).
2. One iteration computes, per pixel (per channel for RGB), the
   cross-correlation with the filter taps accumulated in **float32** as a
   fixed row-major sequence of shifted multiply-adds:
   ``acc = ((t00*x00 + t01*x01) + t02*x02) + ...`` — the same op/order every
   backend uses.  Float32 results agree bit for bit with every backend that
   rounds each product and each sum (NumPy, PyTorch's eager ops); the CUDA
   kernels round once per tap (FMA), see ``correlate_once``.
3. uint8 mode (image filtering): ``out = uint8(clip(rint(acc), 0, 255))``
   after every iteration — the u8 store-back of the reference's
   ``unsigned char`` buffers.
4. float mode (Jacobi smoothing, BASELINE config 5): no quantization; the
   carry stays float32.
5. Double buffering (C8) is the functional ``src → dst`` of each iteration.

Grayscale images are ``(H, W)`` arrays; RGB are ``(H, W, 3)`` (the channel
axis vectorizes transparently — each channel is convolved independently, as
the reference's stride-3 interleaved loop does).
"""

from __future__ import annotations

import numpy as np

from parallel_convolution_tpu_torch.ops.filters import Filter


def _shifted_windows(padded: np.ndarray, k: int, H: int, W: int):
    """Yield the k*k shifted (H, W[, C]) views of a padded array, row-major."""
    for dy in range(k):
        for dx in range(k):
            yield padded[dy : dy + H, dx : dx + W]


def correlate_once(img_f32: np.ndarray, filt: Filter,
                   boundary: str = "zero") -> np.ndarray:
    """One padded cross-correlation step in float32 (no quantization).

    ``img_f32``: (H, W) or (H, W, C) float32.  Returns same shape float32.
    The accumulation is the normative fixed-order shifted multiply-add,
    where "multiply-add" means numpy's TWO-rounding form: ``tap * win``
    rounds to f32, then ``+=`` rounds again (the C++ serial tier pins the
    same form with ``-ffp-contract=off``, and PyTorch's eager ``acc + t * x``
    follows it).  The port's CUDA kernels contract each tap into a
    single-rounding FMA (``__fmaf_rn``), as the JAX package's XLA and Pallas
    tiers do.  The two
    forms are bit-identical wherever every product and partial sum is
    exactly representable — which the u8 quantize-mode semantics guarantee
    at every level, so the byte-compare contract is unaffected — but f32
    float-mode runs diverge by ulps once intermediate mantissas fill
    (observed at iteration >= 3 of gaussian5 on u8-valued inputs).
    ``boundary``: 'zero' (the reference's ghost ring) or 'periodic' (torus
    wrap, the simulation-style ring topology).
    """
    img_f32 = np.ascontiguousarray(img_f32, dtype=np.float32)
    H, W = img_f32.shape[:2]
    k = filt.size
    r = filt.radius
    pad = [(r, r), (r, r)] + [(0, 0)] * (img_f32.ndim - 2)
    mode = {"zero": "constant", "periodic": "wrap"}[boundary]
    padded = np.pad(img_f32, pad, mode=mode)
    taps = filt.taps.reshape(k * k)
    acc = np.zeros_like(img_f32)
    for tap, win in zip(taps, _shifted_windows(padded, k, H, W)):
        # In-place += of tap*win: one multiply-add per tap, fixed order.
        acc += np.float32(tap) * win
    return acc


def quantize_u8(acc_f32: np.ndarray) -> np.ndarray:
    """The normative float32 → uint8 store-back: rint (half-to-even), clip."""
    return np.clip(np.rint(acc_f32), 0.0, 255.0).astype(np.uint8)


def convolve_once_u8(img_u8: np.ndarray, filt: Filter,
                     boundary: str = "zero") -> np.ndarray:
    """One full uint8 iteration: u8 → f32 → correlate → quantize → u8."""
    return quantize_u8(
        correlate_once(img_u8.astype(np.float32), filt, boundary)
    )


def run_serial_u8(img_u8: np.ndarray, filt: Filter, iters: int,
                  boundary: str = "zero") -> np.ndarray:
    """The serial reference run (C1): ``iters`` iterations with u8 store-back.

    Mirrors the reference's hot loop (SURVEY.md §3.1): convolute + buffer
    swap, ``iters`` times.  This is the golden output for every test.
    """
    out = np.asarray(img_u8, dtype=np.uint8)
    for _ in range(iters):
        out = convolve_once_u8(out, filt, boundary)
    return out


def run_serial_f32(img_f32: np.ndarray, filt: Filter, iters: int,
                   boundary: str = "zero") -> np.ndarray:
    """Float-mode serial run (Jacobi smoothing; no per-iteration quantization)."""
    out = np.asarray(img_f32, dtype=np.float32)
    for _ in range(iters):
        out = correlate_once(out, filt, boundary)
    return out


def run_to_convergence_f32(
    img_f32: np.ndarray,
    filt: Filter,
    tol: float,
    max_iters: int,
    check_every: int = 1,
    boundary: str = "zero",
) -> tuple[np.ndarray, int]:
    """Serial run-to-convergence oracle (C6 semantics, BASELINE config 5).

    Convergence means one iteration changes the array by less than ``tol``
    in max-abs norm; the check runs on the last iteration of every
    ``check_every``-sized chunk (mirroring the reference's every-N
    ``MPI_Allreduce``), or until ``max_iters``.  Returns
    ``(result, iterations_run)``.
    """
    cur = np.asarray(img_f32, dtype=np.float32)
    done = 0
    while done < max_iters:
        step = min(check_every, max_iters - done)
        prev = cur
        for _ in range(step):
            prev = cur
            cur = correlate_once(cur, filt, boundary)
        done += step
        diff = float(np.max(np.abs(cur - prev))) if cur.size else 0.0
        if diff < tol:
            break
    return cur, done
