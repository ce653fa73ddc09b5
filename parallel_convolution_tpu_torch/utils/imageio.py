"""Headerless raw image I/O of the PyTorch port (its own copy of the JAX
package's ``utils/imageio.py`` functions this slice needs).

The reference's image format is a headerless ``.raw`` byte stream, row-major:

* grayscale — 1 byte per pixel, shape ``(rows, cols)``;
* RGB       — 3 bytes per pixel, interleaved ``R,G,B``, shape
  ``(rows, cols, 3)``.

Dimensions are not stored in the file — the caller supplies ``rows``/``cols``
exactly as the reference's CLI does (``image path, rows, cols, loops,
grey|rgb``).
"""

from __future__ import annotations

import os

import numpy as np

Mode = str  # "grey" | "rgb"


def _channels(mode: Mode) -> int:
    if mode == "grey":
        return 1
    if mode == "rgb":
        return 3
    raise ValueError(f"mode must be 'grey' or 'rgb', got {mode!r}")


def image_shape(rows: int, cols: int, mode: Mode) -> tuple[int, ...]:
    c = _channels(mode)
    return (rows, cols) if c == 1 else (rows, cols, c)


def read_raw(path: str | os.PathLike, rows: int, cols: int, mode: Mode) -> np.ndarray:
    """Read a whole raw image into a uint8 array of :func:`image_shape`."""
    c = _channels(mode)
    expected = rows * cols * c
    data = np.fromfile(path, dtype=np.uint8)
    if data.size != expected:
        raise ValueError(
            f"{os.fspath(path)}: file has {data.size} bytes, expected "
            f"{expected} for {rows}x{cols} {mode}"
        )
    return data.reshape(image_shape(rows, cols, mode))


def write_raw(path: str | os.PathLike, img: np.ndarray) -> None:
    """Write a uint8 image back to a headerless raw file."""
    np.ascontiguousarray(img, dtype=np.uint8).tofile(path)


def generate_test_image(
    rows: int, cols: int, mode: Mode, seed: int = 0
) -> np.ndarray:
    """Deterministic pseudo-image fixture: smooth gradients plus seeded
    noise, so blur/edge filters have visible structure to act on.  The same
    seed gives the same bytes as the JAX package's generator."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 4.0 * np.pi, rows, dtype=np.float64)[:, None]
    x = np.linspace(0.0, 4.0 * np.pi, cols, dtype=np.float64)[None, :]
    base = 127.5 + 80.0 * np.sin(y) * np.cos(x) + 40.0 * np.sin(0.5 * (x + y))
    c = _channels(mode)
    if c == 1:
        img = base + rng.normal(0.0, 12.0, size=(rows, cols))
    else:
        phases = np.array([0.0, 2.0, 4.0])[None, None, :]
        img = (
            base[:, :, None]
            + 30.0 * np.sin(0.25 * (x[:, :, None] + phases))
            + rng.normal(0.0, 12.0, size=(rows, cols, c))
        )
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def interleaved_to_planar(img: np.ndarray) -> np.ndarray:
    """(H, W, C) interleaved → (C, H, W) planar (kernel-friendly layout)."""
    if img.ndim == 2:
        return img[None]
    return np.ascontiguousarray(np.moveaxis(img, -1, 0))


def planar_to_interleaved(img: np.ndarray) -> np.ndarray:
    """(C, H, W) planar → (H, W, C) interleaved (or (H, W) when C == 1)."""
    if img.shape[0] == 1:
        return np.ascontiguousarray(img[0])
    return np.ascontiguousarray(np.moveaxis(img, 0, -1))
