"""Headerless raw image I/O of the PyTorch port (its own copy of the JAX
package's ``utils/imageio.py`` functions the port needs, the block
helpers of the huge-image workflow among them).

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


def open_raw_mmap(
    path: str | os.PathLike, rows: int, cols: int, mode: Mode
) -> np.memmap:
    """Memory-map a raw image read-only (no bytes touched until sliced)."""
    return np.memmap(
        path, dtype=np.uint8, mode="r", shape=image_shape(rows, cols, mode)
    )


def _row_window(path, rows: int, cols: int, mode: Mode, row_start: int,
                row_stop: int, access: str) -> np.ndarray:
    """Rows [row_start, row_stop) of a raw image, clamped to the image,
    memory-mapped alone: a band of a 12.9 GB file maps its own bytes, not
    the file (a mapping of the whole file shows as the process's resident
    set on some kernels, however little of it is touched)."""
    shape = image_shape(rows, cols, mode)
    row_start, row_stop = max(0, row_start), min(rows, row_stop)
    if row_stop <= row_start:
        return np.zeros((0,) + shape[1:], np.uint8)
    return np.memmap(path, dtype=np.uint8, mode=access,
                     offset=row_start * cols * _channels(mode),
                     shape=(row_stop - row_start,) + shape[1:])


def read_block(
    path: str | os.PathLike,
    rows: int,
    cols: int,
    mode: Mode,
    row_start: int,
    row_stop: int,
    col_start: int,
    col_stop: int,
) -> np.ndarray:
    """Read one rectangular block of a raw image without loading the rest
    (the ``MPI_File_read_at`` analog): the block's rows are mapped alone,
    a contiguous file range; the column slice copies only the block."""
    mm = _row_window(path, rows, cols, mode, row_start, row_stop, "r")
    block = np.array(mm[:, col_start:col_stop])
    del mm
    return block


def write_block(
    path: str | os.PathLike,
    rows: int,
    cols: int,
    mode: Mode,
    row_start: int,
    col_start: int,
    block: np.ndarray,
) -> None:
    """Write one rectangular block into a (pre-sized) raw file in place
    (the ``MPI_File_write_at`` analog), through a mapping of the block's
    rows alone, flushed before it returns.  The file must already exist
    with the full image size (see :func:`allocate_raw`)."""
    mm = _row_window(path, rows, cols, mode, row_start,
                     row_start + block.shape[0], "r+")
    if mm.size:
        mm[:, col_start : col_start + block.shape[1]] = block
        mm.flush()
    del mm


def allocate_raw(path: str | os.PathLike, rows: int, cols: int, mode: Mode) -> None:
    """Create (or truncate) a raw file of the full image size, zero-filled."""
    with open(path, "wb") as f:  # diskio: exempt — image scaffolding
        f.truncate(rows * cols * _channels(mode))


def block_bounds(total: int, parts: int, index: int) -> tuple[int, int]:
    """Start/stop of ``index``'th of ``parts`` near-equal contiguous blocks:
    remainders spread over the leading blocks (sizes differ by <= 1)."""
    if not 0 <= index < parts:
        raise IndexError(f"block {index} of {parts}")
    base, rem = divmod(total, parts)
    start = index * base + min(index, rem)
    stop = start + base + (1 if index < rem else 0)
    return start, stop


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
