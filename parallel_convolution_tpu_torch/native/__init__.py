"""Native host runtime (C++): serial baseline, block I/O, layout conversion.

The port's own copy of the JAX package's ``native/`` (``src/pctpu.cpp``),
built with g++ on first use (``native.build``; the library lives under
``build/native/``).  It is the reference's serial baseline and I/O in
native code: ``cli serial --impl native``, ``utils.bench.bench_oracle_proxy``
and the block reader of ``utils.sharded_io`` use it; everything it does
has a NumPy counterpart (``ops/oracle.py``, ``utils/imageio.py``) that
gives the same bytes.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

from parallel_convolution_tpu_torch.native import build as _build

_lib = None


def lib_path() -> Path:
    return _build.LIB


def is_built() -> bool:
    """The library is built and fresh for this source and CPU."""
    return _build.is_fresh()


def load():
    """Load the native library, building it first if needed; raises
    ``RuntimeError`` (g++'s stderr) when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    if not is_built():
        _build.build()
    lib = ctypes.CDLL(os.fspath(lib_path()))
    c = ctypes
    i64, u8p, fp = c.c_int64, c.POINTER(c.c_uint8), c.POINTER(c.c_float)
    lib.pctpu_run_serial_u8.argtypes = [
        u8p, u8p, i64, i64, i64, fp, c.c_int, c.c_int, c.c_int
    ]
    lib.pctpu_run_serial_u8.restype = None
    lib.pctpu_num_threads.restype = c.c_int
    for fn in (lib.pctpu_read_block, lib.pctpu_write_block):
        fn.argtypes = [c.c_char_p, i64, i64, i64, i64, i64, i64, i64, u8p]
        fn.restype = c.c_int
    for fn in (lib.pctpu_interleaved_to_planar, lib.pctpu_planar_to_interleaved):
        fn.argtypes = [u8p, u8p, i64, i64, i64]
        fn.restype = None
    _lib = lib
    return lib
