"""NumPy-facing wrappers over the native C++ library (the JAX package's
``native/serial_native.py``)."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from parallel_convolution_tpu_torch.native import load
from parallel_convolution_tpu_torch.ops.filters import Filter

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def run_serial_u8(img: np.ndarray, filt: Filter, iters: int,
                  threads: int = 0) -> np.ndarray:
    """Native serial/OpenMP run with oracle-identical u8 semantics.

    ``threads=0`` uses all cores (the reference's hybrid C9 tier);
    ``threads=1`` is the strict serial baseline (C1).
    """
    lib = load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    H, W = img.shape[:2]
    C = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty_like(img)
    taps = np.ascontiguousarray(filt.taps, dtype=np.float32)
    lib.pctpu_run_serial_u8(
        _u8p(img), _u8p(out), H, W, C,
        taps.ctypes.data_as(_F32P), filt.size, int(iters), int(threads),
    )
    return out


def num_threads() -> int:
    """OpenMP's thread count for ``threads=0``."""
    return int(load().pctpu_num_threads())


def read_block(path, rows, cols, mode, r0, r1, c0, c1) -> np.ndarray:
    """Rows [r0, r1) × cols [c0, c1) of a raw (rows, cols[, 3]) u8 file;
    raises ``OSError`` on a bad range or a short read."""
    lib = load()
    ch = 3 if mode == "rgb" else 1
    shape = (r1 - r0, c1 - c0) if ch == 1 else (r1 - r0, c1 - c0, ch)
    out = np.empty(shape, np.uint8)
    rc = lib.pctpu_read_block(os.fspath(path).encode(), rows, cols, ch,
                              r0, r1, c0, c1, _u8p(out))
    if rc != 0:
        raise OSError(f"pctpu_read_block failed with code {rc} for {path}")
    return out


def write_block(path, rows, cols, mode, r0, c0, block: np.ndarray) -> None:
    """Write ``block`` into a pre-sized raw file at (r0, c0); raises
    ``OSError`` on a bad range or a short write."""
    lib = load()
    ch = 3 if mode == "rgb" else 1
    block = np.ascontiguousarray(block, np.uint8)
    r1, c1 = r0 + block.shape[0], c0 + block.shape[1]
    rc = lib.pctpu_write_block(os.fspath(path).encode(), rows, cols, ch,
                               r0, r1, c0, c1, _u8p(block))
    if rc != 0:
        raise OSError(f"pctpu_write_block failed with code {rc} for {path}")


def interleaved_to_planar(img: np.ndarray) -> np.ndarray:
    lib = load()
    if img.ndim == 2:
        return img[None].copy()
    img = np.ascontiguousarray(img, np.uint8)
    H, W, C = img.shape
    out = np.empty((C, H, W), np.uint8)
    lib.pctpu_interleaved_to_planar(_u8p(img), _u8p(out), H, W, C)
    return out


def planar_to_interleaved(img: np.ndarray) -> np.ndarray:
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    C, H, W = img.shape
    if C == 1:
        return img[0].copy()
    out = np.empty((H, W, C), np.uint8)
    lib.pctpu_planar_to_interleaved(_u8p(img), _u8p(out), H, W, C)
    return out
