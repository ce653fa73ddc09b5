"""Sharded raw-image load/save of the PyTorch port (the JAX package's
``utils/sharded_io.py``): no host buffer holds a whole block, let alone the
image.

BASELINE config 4 is a 65536×65536 RGB image, a 12.9 GB u8 file, and on a
1×1 grid its one block is the whole of it.  The reference reads each
rank's block with MPI-IO offsets; here :func:`load_sharded` fills each
block of the grid on its device from the file in row bands of at most
:data:`BAND_BYTES`: a band is read on the host and copied to the
device, and the interleaved → planar change and the cast to the storage
dtype run there.  The blocks come out as ``parallel.step._prepare`` cuts
them: padded to block multiples, the pad rim zero.

:func:`save_sharded` runs the other way: each block's valid part, a band
at a time, clamped to [0, 255] and cast to u8 and made interleaved on the
device, copied to the host and written at its file offset
(``MPI_File_write_at``).

A band is read through the native C++ reader
(``native.serial_native.read_block``) or through NumPy; the bytes are the
same.  ``reader="auto"`` takes the native one when its library is built,
as the JAX package does, but decides once per process
(:func:`default_reader`), so one run never mixes the two.  The JAX
package falls back from a failed native read to NumPy without a word;
here a failed native read raises (ROADMAP Queue 3).

On a grid of slots each block is allocated on its slot's device; on a
grid over several processes each rank reads and writes only the blocks
it holds (the JAX package's addressable shards), the others ``None``,
and a save that allocates the file has rank 0 do it before a barrier.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from parallel_convolution_tpu_torch.parallel.mesh import (
    Grid, first_block, local_blocks, padded_extent, spans,
)
from parallel_convolution_tpu_torch.resilience.faults import fault_point
from parallel_convolution_tpu_torch.utils import imageio

__all__ = ["BAND_BYTES", "READERS", "default_reader", "load_sharded",
           "save_sharded"]

# The most file bytes one band of a block moves through the host.
BAND_BYTES = 64 << 20

READERS = ("auto", "native", "numpy")

_NUMPY_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.uint8): torch.uint8}


def _torch_dtype(dtype) -> torch.dtype:
    """A storage dtype given as a torch dtype or a NumPy one (the JAX
    signature's ``np.float32``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _NUMPY_DTYPES[np.dtype(dtype)]
    except (KeyError, TypeError) as e:
        raise ValueError(f"no block dtype for {dtype!r}: pass a torch dtype "
                         "(torch.bfloat16 has no NumPy counterpart) or "
                         "np.float32 / np.uint8") from e


@functools.cache
def default_reader() -> str:
    """``reader="auto"``'s choice, made at its first use in the process:
    ``native`` when the native library is built and fresh, else
    ``numpy``."""
    from parallel_convolution_tpu_torch import native

    return "native" if native.is_built() else "numpy"


def _block_reader(reader: str):
    """The band reader ``read(path, rows, cols, mode, r0, r1, c0, c1)`` ->
    a (r1-r0, c1-c0[, 3]) u8 array, for ``reader`` in :data:`READERS`."""
    if reader not in READERS:
        raise ValueError(f"reader must be one of {READERS}, got {reader!r}")
    if reader == "auto":
        reader = default_reader()
    if reader == "numpy":
        return imageio.read_block
    from parallel_convolution_tpu_torch import native
    from parallel_convolution_tpu_torch.native import serial_native

    native.load()  # builds it if needed; a failed build raises
    return serial_native.read_block


def _bands(r0: int, r1: int, row_bytes: int):
    """Row ranges [a, b) covering [r0, r1), each at most BAND_BYTES of
    file (at least one row)."""
    step = max(1, BAND_BYTES // max(1, row_bytes))
    for a in range(r0, r1, step):
        yield a, min(a + step, r1)


def load_sharded(path, rows: int, cols: int, mode: str, grid: Grid,
                 dtype=np.float32,
                 reader: str = "auto") -> list[list[torch.Tensor]]:
    """Load a raw image straight into the grid's R×C padded (C, h, w)
    blocks, each on its slot's device, in ``dtype``.

    h and w are the padded-to-block-multiple extents over the grid; the
    pad rim is zero, the layout ``parallel.step.iterate_prepared`` takes.
    The file is consulted once per block that holds image pixels
    (``fault_point("io_read")``), a band at a time through ``reader``
    (``auto``: :func:`default_reader`).  On a grid over several processes
    only this rank's blocks are read; the others are ``None``."""
    C = imageio._channels(mode)
    R, Cg = grid.shape
    bh, bw = padded_extent(rows, R) // R, padded_extent(cols, Cg) // Cg
    dt = _torch_dtype(dtype)
    read = _block_reader(reader)
    blocks = []
    for i in range(R):
        row = []
        for j in range(Cg):
            if not grid.is_local(i, j):
                row.append(None)
                continue
            dev = grid.slot_device(i, j)
            r0, c0 = i * bh, j * bw
            r1, c1 = min(r0 + bh, rows), min(c0 + bw, cols)
            out = torch.zeros((C, bh, bw), dtype=dt, device=dev)
            if r1 > r0 and c1 > c0:
                fault_point("io_read")  # one consult per block read
                for a, b in _bands(r0, r1, (c1 - c0) * C):
                    band = torch.from_numpy(read(
                        path, rows, cols, mode, a, b, c0, c1)).to(dev)
                    out[:, a - r0:b - r0, :c1 - c0] = (
                        band[None] if C == 1 else band.permute(2, 0, 1))
            row.append(out)
        blocks.append(row)
    return blocks


def save_sharded(path, blocks, rows: int, cols: int, mode: str,
                 allocate: bool = True, grid_shape=None,
                 grid: Grid | None = None) -> None:
    """Write the grid's padded blocks back to a raw file.

    ``blocks`` is the R×C list of (C, h, w) blocks, or the stacked
    ``cuda_rdma`` carry (R·C, C, h, w) with its ``grid_shape``.  Each
    block writes only its valid (non-pad) part at its file offset, a band
    at a time; ``allocate`` first creates the file at the image's size.
    On a ``grid`` over several processes the blocks another process holds
    are ``None`` and are written by it: with ``allocate`` rank 0 alone
    creates the file, and every rank waits for it at a barrier before
    writing."""
    if torch.is_tensor(blocks):
        from parallel_convolution_tpu_torch.ops import rdma

        if grid_shape is None:
            raise ValueError("a stacked (R*C, C, h, w) grid needs its "
                             "grid_shape")
        blocks = rdma.unstack_blocks(blocks, tuple(grid_shape))
    shared = spans(grid, blocks)
    if allocate:
        if not shared or grid.rank == 0:
            imageio.allocate_raw(path, rows, cols, mode)
        if shared:
            from parallel_convolution_tpu_torch.parallel import multihost

            multihost.barrier("output-allocated")
    C, bh, bw = first_block(blocks).shape
    for (i, j), blk in local_blocks(blocks):
        r0, c0 = i * bh, j * bw
        r1, c1 = min(r0 + bh, rows), min(c0 + bw, cols)
        if r1 <= r0 or c1 <= c0:
            continue  # the block lies entirely in the pad rim
        for a, b in _bands(r0, r1, (c1 - c0) * C):
            band = blk[:, a - r0:b - r0, :c1 - c0]
            if band.dtype != torch.uint8:
                band = band.clamp(0, 255).to(torch.uint8)
            band = band[0] if C == 1 else band.permute(1, 2, 0)
            imageio.write_block(path, rows, cols, mode, a, c0,
                                band.contiguous().cpu().numpy())
