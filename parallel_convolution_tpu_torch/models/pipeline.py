"""The flagship model of the PyTorch port: iterative image convolution end
to end (the JAX package's ``models/pipeline.py``) — read a raw image,
decompose it over the block grid, iterate the stencil with halo exchange,
write the raw output; or, for an image too large for one host buffer,
stream it block by block between the file and the card
(:meth:`ConvolutionModel.run_raw_file_sharded`)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from parallel_convolution_tpu_torch.ops.filters import Filter, get_filter
from parallel_convolution_tpu_torch.parallel import kernels as kernel_forms
from parallel_convolution_tpu_torch.parallel import step as step_lib
from parallel_convolution_tpu_torch.parallel.mesh import (
    Grid, first_block, grid_like, make_grid, padded_extent,
)
from parallel_convolution_tpu_torch.utils import imageio, tracing
from parallel_convolution_tpu_torch.utils.config import (
    AUTO, COL_MODE_CHOICES, check_backend, check_fuse, check_run_config,
)


class ConvolutionModel(nn.Module):
    """Iterative stencil filtering of grey/RGB images over a block grid.

    Args:
      filt: a :class:`Filter` or registry name (default: the reference's
        blur kernel).  Its taps are the module's ``taps`` buffer.
      grid: the block grid; default 1×1 on ``device``; a grid of slots
        (``mesh.make_grid(devices=...)``) runs each block on its slot's
        device.
      backend: ``shifted`` | ``separable`` | ``xla_conv`` (plain PyTorch),
        ``cuda`` | ``cuda_sep`` | ``cuda_rdma`` (the CUDA kernels; the JAX
        package's ``pallas`` | ``pallas_sep`` | ``pallas_rdma``), or
        ``auto``: resolve the backend, and ``fuse`` / ``tile`` where None,
        through the tuning package (plan cache, else the cost model) for
        each run's image.
      quantize: u8 store-back each iteration (image semantics); False =
        float mode.
      storage: carry dtype ``f32`` | ``bf16`` | ``u8``.
      fuse: iterations per halo exchange (temporal fusion); None = let
        ``backend="auto"`` tune it.
      boundary: ``zero`` | ``periodic``.
      tile: (rows, cols) output tile of the CUDA kernels; any tile gives
        the same bytes.
      device: ``None`` = the card (raises without CUDA); ``"cpu"`` runs the
        plain versions on the CPU.
      fallback: probe the (resolved) backend once per grid and config per
        process before a run, and on a transient failure walk
        ``cuda_rdma → cuda`` (``resilience.degrade``; on the card a
        refused ``cuda`` raises, on the CPU it steps down to ``shifted``)
        with a ``BackendDegradedWarning``.
    After each run, ``effective_backend`` (the backend that ran, after
    ``auto`` and any degradation), ``effective_fuse`` and ``plan_source``
    (``measured`` | ``interpolated`` | ``predicted``, or ``explicit``)
    record what ran, and ``resolution`` the ``tuning.Resolution`` of an
    ``auto`` run.
      interior_split: launch K2 as the 9-patch plan of each block's offset
        class (``cuda`` / ``cuda_sep`` at fuse > 1 on a ``zero`` boundary;
        elsewhere taken and not used, as in the JAX package); the same
        bytes.
      col_mode: ``cuda_rdma``'s column-slab transport on a grid of slots
        (``packed`` | ``strided`` | ``auto``; None = auto); the resolved
        value lands in ``effective_col_mode`` after each run.
      overlap: the interior-first overlapped pipeline, a request clamped
        by ``step.resolve_overlap`` (``cuda_rdma`` on a grid of slots
        only); None = off, or the tuner's verdict under ``auto``.  The
        value the last run used lands in ``effective_overlap``.
    """

    def __init__(self, filt: Filter | str = "blur3", grid: Grid | None = None,
                 backend: str = "shifted", quantize: bool = True,
                 storage: str = "f32", fuse: int | None = 1,
                 boundary: str = "zero", tile=None, device=None,
                 interior_split: bool = False, overlap: bool | None = None,
                 col_mode: str | None = None, fallback: bool = False):
        super().__init__()
        check_backend(backend, allow_auto=True)
        if col_mode is not None and col_mode not in COL_MODE_CHOICES:
            raise ValueError(f"col_mode must be one of {COL_MODE_CHOICES}, "
                             f"got {col_mode!r}")
        check_run_config(storage, boundary, quantize)
        check_fuse(backend, fuse)
        if fuse is not None and int(fuse) < 1:
            raise ValueError(f"fuse must be >= 1, got {fuse}")
        filt = get_filter(filt) if isinstance(filt, str) else filt
        if grid is None:
            grid = make_grid(device=device)
        elif device is not None and grid.device != torch.device(device):
            raise ValueError(f"grid is on {grid.device}, device={device!r}")
        self.grid = grid
        self.backend, self.quantize, self.storage = backend, quantize, storage
        self.fuse = None if fuse is None else int(fuse)
        self.boundary = boundary
        self.tile = None if tile is None else tuple(int(v) for v in tile)
        self.fallback = bool(fallback)
        self.interior_split = bool(interior_split)
        self.col_mode = col_mode
        self.overlap = overlap
        self.filter_name, self.dyadic = filt.name, filt.dyadic
        self.register_buffer("taps", torch.as_tensor(filt.taps.copy(),
                                                     device=grid.device))
        # What the last run used (None until a run).
        self.effective_backend: str | None = None
        self.effective_fuse: int | None = None
        self.effective_col_mode: str | None = None
        self.effective_overlap: bool | None = None
        self.plan_source = "explicit"
        self.resolution = None

    def set_grid(self, grid: Grid | str) -> "ConvolutionModel":
        """Swap the block grid mid-object (elastic recovery; the JAX
        package's ``set_mesh``).

        ``grid`` is a :class:`Grid` or an ``"RxC"`` spec, which keeps the
        current grid's form (``mesh.grid_like``: the one-device form on its
        device, or a slot per block round-robin over its devices).  Only
        the per-grid verdicts reset (``effective_backend``,
        ``plan_source``, ``effective_overlap``, ``effective_col_mode``);
        the knobs stay, and the degrade probe's verdicts, keyed on the
        grid, are kept for a swap back.  Output bytes do not depend on the
        grid, so a swap changes the topology, never the result."""
        if isinstance(grid, str):
            from parallel_convolution_tpu_torch.resilience.elastic import (
                parse_spec,
            )

            grid = grid_like(self.grid, parse_spec(grid))
        self.grid = grid
        self.taps = self.taps.to(grid.device)
        self.effective_backend = None
        self.plan_source = "explicit"
        self.effective_overlap = None
        self.effective_col_mode = None
        return self

    @property
    def filt(self) -> Filter:
        """The filter the taps buffer holds."""
        return Filter(self.filter_name, self.taps.detach().cpu().numpy(),
                      self.dyadic)

    def _resolved_knobs(self, shape) -> tuple[str, int, object, str, bool]:
        """(backend, fuse, tile, col_mode, overlap) for a (C, H, W) image,
        resolved through the tuning package when ``backend="auto"``, the
        column transport and the overlap through ``step``, then, with
        ``fallback``, through the degradation walk, probed at the image's
        real block size and storage (``col_mode`` and ``overlap``
        re-clamped to the tier); recorded on the model."""
        backend, fuse, tile = self.backend, self.fuse, self.tile
        overlap = self.overlap
        self.resolution, self.plan_source = None, "explicit"
        if backend == AUTO:
            from parallel_convolution_tpu_torch import tuning

            res = tuning.resolve(
                self.grid, self.filt, tuple(int(v) for v in shape),
                storage=self.storage, quantize=self.quantize,
                boundary=self.boundary, fuse=fuse, tile=tile)
            backend, fuse, tile = res.backend, res.fuse, res.tile
            if overlap is None:
                overlap = res.overlap
            self.resolution, self.plan_source = res, res.source
        R, C = self.grid.shape
        block_hw = (padded_extent(int(shape[1]), R) // R,
                    padded_extent(int(shape[2]), C) // C)
        col_mode = step_lib.resolve_col_mode(
            self.col_mode, backend, self.grid, block_hw, self.filt.radius,
            fuse, self.storage)
        overlap = step_lib.resolve_overlap(overlap, backend, self.grid)
        if self.fallback:
            backend = step_lib._resolve_fallback(
                self.grid, self.filt, backend, self.quantize, fuse,
                self.boundary, tile, self.storage, block_hw,
                self.interior_split, col_mode, overlap)
            col_mode = step_lib.clamp_col_mode(col_mode, backend)
            overlap = kernel_forms.clamp_overlap(overlap, backend)
        self.effective_backend, self.effective_fuse = backend, fuse
        self.effective_col_mode, self.effective_overlap = col_mode, overlap
        return backend, fuse, tile, col_mode, overlap

    # -- array-level API ----------------------------------------------------
    def run_planar(self, x, iters: int) -> torch.Tensor:
        """(C, H, W) in (numpy or tensor) → (C, H, W) f32 tensor on the
        grid's device after ``iters`` iterations."""
        backend, fuse, tile, col_mode, overlap = self._resolved_knobs(
            x.shape)
        return step_lib.sharded_iterate(
            x, self.filt, iters, grid=self.grid, quantize=self.quantize,
            backend=backend, storage=self.storage, fuse=fuse,
            boundary=self.boundary, tile=tile,
            interior_split=self.interior_split, overlap=overlap,
            col_mode=col_mode)

    forward = run_planar

    # Images cross to and from the device as u8 (1 byte a value, not 4);
    # the interleaved <-> planar layout change runs on the device.
    def _planar(self, img: np.ndarray) -> torch.Tensor:
        """uint8 (H, W[, C]) → planar (C, H, W) uint8 on the grid's device."""
        x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.uint8))
        x = x.to(self.grid.device)
        return x[None] if x.dim() == 2 else x.permute(2, 0, 1).contiguous()

    @staticmethod
    def _interleaved(planar: torch.Tensor) -> np.ndarray:
        """(C, H, W) result → uint8 (H, W[, C]) numpy, as the JAX model's
        ``astype(uint8)`` (the quantized states are exact integers)."""
        q = planar.to(torch.uint8)
        q = q[0] if q.shape[0] == 1 else q.permute(1, 2, 0)
        return q.contiguous().cpu().numpy()

    def run_image(self, img: np.ndarray, iters: int) -> np.ndarray:
        """uint8 (H, W[, 3]) in → uint8 out; the one-call user entry point."""
        with tracing.span("entry.copy_in"):
            x = self._planar(img)
        out = self.run_planar(x, iters)
        with tracing.span("entry.copy_out"):
            return self._interleaved(out)

    def run_images(self, imgs, iters: int) -> list[np.ndarray]:
        """A batch of same-sized images in one run: channels are
        independent, so the batch is more planes on the leading axis."""
        with tracing.span("entry.copy_in"):
            planar = [self._planar(im) for im in imgs]
            x = torch.cat(planar, dim=0)
        out = self.run_planar(x, iters)
        with tracing.span("entry.copy_out"):
            return [self._interleaved(p)
                    for p in torch.split(out, [p.shape[0] for p in planar])]

    # -- file-level API (the reference CLI contract) ------------------------
    def run_raw_file(self, src: str, dst: str, rows: int, cols: int,
                     mode: str, iters: int) -> None:
        """raw file → raw file, the reference's ``main()`` end to end."""
        img = imageio.read_raw(src, rows, cols, mode)
        out = self.run_image(img, iters)
        if not self.grid.spans_processes:
            imageio.write_raw(dst, out)
            return
        # Every rank of a grid over several processes holds the result:
        # rank 0 writes it, the others wait for the file.
        from parallel_convolution_tpu_torch.parallel import multihost

        if self.grid.rank == 0:
            imageio.write_raw(dst, out)
        multihost.barrier("output-written")

    def run_raw_file_sharded(self, src: str, dst: str, rows: int, cols: int,
                             mode: str, iters: int) -> None:
        """The huge-image path: the file's blocks are read in row bands
        straight into the grid's blocks on the card, in the storage dtype,
        iterated, and written back the same way (``utils.sharded_io``).  No
        host buffer holds a block, and the global image is never formed,
        in f32 or otherwise (the MPI-IO workflow)."""
        from parallel_convolution_tpu_torch.utils import sharded_io

        blocks = sharded_io.load_sharded(
            src, rows, cols, mode, self.grid,
            dtype=step_lib.STORAGE_DTYPES[self.storage])
        backend, fuse, tile, col_mode, overlap = self._resolved_knobs(
            (first_block(blocks).shape[0], rows, cols))
        out = step_lib.iterate_prepared(
            blocks, self.filt, iters, self.grid, (rows, cols),
            quantize=self.quantize, backend=backend, fuse=fuse,
            boundary=self.boundary, tile=tile,
            interior_split=self.interior_split, overlap=overlap,
            col_mode=col_mode)
        del blocks
        sharded_io.save_sharded(dst, out, rows, cols, mode, grid=self.grid)
