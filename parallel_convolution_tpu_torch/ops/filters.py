"""Filter registry of the PyTorch port (its own copy of the JAX package's
``ops/filters.py``: the port imports nothing of that package).

The reference hard-codes one normalized blur kernel (a float ``h[3][3]``,
expected ``{{1,2,1},{2,4,2},{1,2,1}}/16``) at the top of its kernel file; the
BASELINE configs additionally demand a 5×5 edge-detect.  Here filters are
first-class, named values: any odd ``k×k`` float32 tap array is a valid
filter, and the registry carries the standard image-processing set.

Semantics note: filters are applied as **cross-correlation** (no tap flip),
the convention of essentially all image-processing code.  Every bundled
filter is either symmetric (flip-invariant) or documented.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class Filter:
    """An odd-sized square stencil filter.

    Attributes:
      name: registry name (used by the CLI ``--filter`` flag).
      taps: ``(k, k)`` float32 array, already normalized (taps are applied
        as-is; no implicit divisor).
      dyadic: True when every tap is an exact binary fraction with a few
        significand bits, so float32 accumulation over uint8 inputs is exact
        and the oracle⇔kernel comparison is bit-exact by construction (see
        ops/oracle.py for the quantization spec).
    """

    name: str
    taps: np.ndarray
    dyadic: bool = False

    def __post_init__(self) -> None:
        t = np.asarray(self.taps, dtype=np.float32)
        if t.ndim != 2 or t.shape[0] != t.shape[1] or t.shape[0] % 2 == 0:
            raise ValueError(f"filter taps must be odd square, got {t.shape}")
        object.__setattr__(self, "taps", t)

    # Hashable/comparable by value (a Filter keys caches and dict lookups).
    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Filter)
            and self.name == other.name
            and self.taps.shape == other.taps.shape
            and bool(np.all(self.taps == other.taps))
        )

    def __hash__(self) -> int:
        return hash((self.name, self.taps.shape, self.taps.tobytes()))

    @property
    def size(self) -> int:
        return int(self.taps.shape[0])

    @property
    def radius(self) -> int:
        """Halo width this filter needs on each side (k // 2)."""
        return self.size // 2

    @property
    def convex(self) -> bool:
        """True when the filter provably cannot leave [0, 255] on u8 data.

        All taps non-negative and summing to ≤ 1 (convex combination): an
        accumulate over integer inputs in [0, 255] stays in [0, 255], so
        the quantize-mode ``clip`` after ``rint`` is the identity and the
        kernels may elide it.  The f32 sum of non-negative products is ≥ 0 and
        ≤ 255·(1+nε), and ``rint`` of anything < 255.5 is ≤ 255 — so the
        1e-6 slack on the tap sum cannot produce an out-of-range byte.
        """
        t = self.taps
        return bool(np.all(t >= 0.0) and float(t.sum()) <= 1.0 + 1e-6)

    def separable(self) -> tuple[np.ndarray, np.ndarray] | None:
        """(col_taps, row_taps) 1D factors with ``outer(col, row) == taps``
        EXACTLY in float32, or None.

        Blur/Gaussian kernels are rank-1: ``taps = c ⊗ r`` lets the stencil
        run as two 1D passes (2k MACs/px instead of k²).  Exactness of the
        factorization (checked bit-for-bit) is what keeps the separable
        path inside the bit-exact regime for dyadic filters.
        """
        t = self.taps
        i0, j0 = np.unravel_index(np.argmax(np.abs(t)), t.shape)
        piv = float(t[i0, j0])
        if piv == 0.0:
            return None
        cands = []
        if piv > 0:
            # Symmetric sqrt normalization first: for kernels like
            # gaussian5 it yields dyadic factors ([1,4,6,4,1]/16) where the
            # pivot normalization would give inexact 1/6-style taps.
            s = np.float32(np.sqrt(piv))
            cands.append(((t[:, j0] / s).astype(np.float32),
                          (t[i0, :] / s).astype(np.float32)))
        cands.append((t[:, j0].astype(np.float32),
                      (t[i0, :] / np.float32(piv)).astype(np.float32)))

        def dyadic_1d(a):
            scaled = a * 256.0
            return bool(np.all(scaled == np.rint(scaled)))

        exact = [
            (col, row) for col, row in cands
            if np.array_equal(np.outer(col, row).astype(np.float32), t)
        ]
        if not exact:
            return None
        exact.sort(key=lambda cr: not (dyadic_1d(cr[0]) and dyadic_1d(cr[1])))
        return exact[0]


def _f(name: str, taps, divisor: float | None = None, dyadic: bool = False) -> Filter:
    t = np.asarray(taps, dtype=np.float32)
    if divisor is not None:
        t = t / np.float32(divisor)
    return Filter(name=name, taps=t, dyadic=dyadic)


# The reference's own blur kernel: Gaussian-like 3×3 over /16 — all taps are
# exact binary fractions (1/16, 2/16=1/8, 4/16=1/4), hence dyadic.
BLUR3 = _f("blur3", [[1, 2, 1], [2, 4, 2], [1, 2, 1]], divisor=16, dyadic=True)

# Box blur, /8 would not preserve brightness; true box is /9 (non-dyadic).
BOX3 = _f("box3", np.ones((3, 3)), divisor=9)

# 5×5 Gaussian (the classic /256 pyramid kernel) — dyadic: every tap is
# n/256 with n a small integer, exactly representable and exactly
# accumulable in float32 against uint8 inputs.
GAUSSIAN5 = _f(
    "gaussian5",
    [
        [1, 4, 6, 4, 1],
        [4, 16, 24, 16, 4],
        [6, 24, 36, 24, 6],
        [4, 16, 24, 16, 4],
        [1, 4, 6, 4, 1],
    ],
    divisor=256,
    dyadic=True,
)

# Laplacian-style edge detectors (integer taps — dyadic trivially).
EDGE3 = _f("edge3", [[-1, -1, -1], [-1, 8, -1], [-1, -1, -1]], dyadic=True)
EDGE5 = _f(
    "edge5",
    [
        [-1, -1, -1, -1, -1],
        [-1, -1, -1, -1, -1],
        [-1, -1, 24, -1, -1],
        [-1, -1, -1, -1, -1],
        [-1, -1, -1, -1, -1],
    ],
    dyadic=True,
)

SHARPEN3 = _f("sharpen3", [[0, -1, 0], [-1, 5, -1], [0, -1, 0]], dyadic=True)
IDENTITY3 = _f("identity3", [[0, 0, 0], [0, 1, 0], [0, 0, 0]], dyadic=True)

# Jacobi 4-point average: the smoothing stencil of BASELINE config 5
# (iterated to convergence in float space).  1/4 taps — dyadic.
JACOBI3 = _f("jacobi3", [[0, 1, 0], [1, 0, 1], [0, 1, 0]], divisor=4, dyadic=True)

FILTERS: dict[str, Filter] = {
    f.name: f
    for f in [BLUR3, BOX3, GAUSSIAN5, EDGE3, EDGE5, SHARPEN3, IDENTITY3, JACOBI3]
}


def get_filter(name: str) -> Filter:
    try:
        return FILTERS[name]
    except KeyError:
        raise KeyError(
            f"unknown filter {name!r}; available: {sorted(FILTERS)}"
        ) from None


def make_filter(name: str, taps: np.ndarray, divisor: float | None = None) -> Filter:
    """Build a custom odd k×k filter (arbitrary sizes are supported end-to-end)."""
    return _f(name, taps, divisor=divisor)


def gaussian(size: int, sigma: float) -> Filter:
    """Sampled normalized Gaussian of odd ``size`` (non-dyadic in general).

    Byte-parity caveat: taps with no integer divisor (these, or any
    ``make_filter`` taps without one) lose the rint-margin theorem, so
    quantize-mode outputs can differ from the two-rounding NumPy/C++
    oracle at isolated pixels (the FMA rint-straddle — DESIGN.md
    "bit-exactness" precision classes; measured ±1 at sigma=0.7).
    Compiled backends remain bit-identical to each other; every
    registry filter carries an integer divisor and keeps full byte
    equality.
    """
    if size % 2 == 0:
        raise ValueError("size must be odd")
    r = size // 2
    y, x = np.mgrid[-r : r + 1, -r : r + 1].astype(np.float64)
    g = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    g /= g.sum()
    return Filter(name=f"gaussian{size}_s{sigma:g}", taps=g.astype(np.float32))
