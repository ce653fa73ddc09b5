"""Graceful backend degradation: probe once, walk the fallback chain (the
PyTorch port of the JAX package's ``resilience/degrade.py``).

* Each (grid, backend, config) is probed ONCE per process — one
  ``fuse``-level chunk of the real runner (``step._build_iterate``) on a
  zeros grid at the real block size and storage, ended by
  ``torch.cuda.synchronize`` so that a launch error surfaces inside the
  probe — and the verdict (or the exception) is cached.
* On a classified-**transient** probe failure (:mod:`.retry`: a refused
  launch the CUDA context survives, an injected transient fault) the chain
  walks ``cuda_rdma → cuda`` (``cuda_sep`` rejoins at ``cuda``; ``xla_conv``
  and ``separable`` step down to ``shifted``), emitting a
  :class:`BackendDegradedWarning`.  On the card the kernel tiers stop at
  ``cuda``: a refused ``cuda`` raises :class:`RetryExhausted`, since the
  step below it would run the plain version in a kernel's place.  On the
  CPU every ``cuda*`` tier already runs its plain version, and ``cuda``
  steps down to ``shifted`` as the JAX package's ``pallas`` does.
* **Terminal** failures (a lost context, a failed build, contract errors)
  raise at once: degradation never papers over them.
* The resolved name is returned, and ``ConvolutionModel``,
  ``utils.bench`` and the CLI's summary line record it as the effective
  backend.
"""

from __future__ import annotations

import warnings

import torch

from parallel_convolution_tpu_torch.obs import (
    events as obs_events, metrics as obs_metrics,
)
from parallel_convolution_tpu_torch.ops.filters import Filter
from parallel_convolution_tpu_torch.resilience.retry import (
    TERMINAL, RetryExhausted, classify,
)

__all__ = [
    "BackendDegradedWarning", "clear_probe_cache", "degradation_chain",
    "effective_for", "probe_backend", "resolve_backend",
]


class BackendDegradedWarning(UserWarning):
    """A requested backend failed transiently and a lower tier was used."""


# Next tier down for each backend, the JAX package's _FALLBACK_NEXT in the
# port's names.  The separable kernel tier rejoins at the 2-D kernel tier:
# cuda_sep's rank-1 rounding order is byte-identical only for dyadic
# filters in quantize mode, so degrading INTO it could change bytes, and
# degrading out of any kernel tier to 'shifted' never can.
_FALLBACK_NEXT = {
    "cuda_rdma": "cuda",
    "cuda_sep": "cuda",
    "cuda": "shifted",
    "xla_conv": "shifted",
    "separable": "shifted",
}


def degradation_chain(backend: str,
                      on_card: bool = False) -> tuple[str, ...]:
    """The orderly walk from ``backend`` down the tiers.  ``on_card``
    (a grid on a CUDA device) stops the kernel tiers at ``cuda``: the step
    to ``shifted`` leaves the kernels for the plain version, which only
    the CPU, where the kernel tiers run their plain versions, may take."""
    chain = [backend]
    while chain[-1] in _FALLBACK_NEXT and not (on_card
                                               and chain[-1] == "cuda"):
        chain.append(_FALLBACK_NEXT[chain[-1]])
    return tuple(chain)


# (grid, filter, backend, config) -> None on success, or the exception the
# probe raised.  The failure is cached too, so the walk is deterministic
# within a process.
_PROBE_CACHE: dict[tuple, BaseException | None] = {}


def clear_probe_cache() -> None:
    _PROBE_CACHE.clear()
    _LAST_RESOLVED.clear()


def _probe_key(grid, filt: Filter, backend: str, quantize, fuse, boundary,
               tile, storage, block_hw, interior_split=False,
               col_mode="packed", overlap=False) -> tuple:
    return (grid, filt.name, filt.radius, backend, bool(quantize), int(fuse),
            boundary, None if tile is None else tuple(tile), storage,
            None if block_hw is None else tuple(block_hw),
            bool(interior_split), col_mode, bool(overlap))


def probe_backend(grid, filt: Filter, backend: str, *, quantize: bool = True,
                  fuse: int = 1, boundary: str = "zero", tile=None,
                  storage: str = "f32", block_hw=None,
                  interior_split: bool = False,
                  col_mode: str = "packed", overlap: bool = False) -> None:
    """Build and run one ``fuse``-iteration chunk of ``backend`` on a
    zeros grid (on a grid of slots: every slot's launch at its own block
    on its own device, region by region with ``overlap``), with
    ``col_mode`` and ``overlap`` clamped to ``backend``.

    Raises whatever the build or the launch raised (replayed from the
    cache on repeat calls); returns None on (possibly cached) success.
    ``block_hw`` is the REAL run's block: the kernel and its launch shape
    depend on it (``cuda_rdma`` takes K3 or K4 by the block's size, K2 its
    level groups), so the probe runs the same kernels at the same size as
    the real run.  ``None`` takes the fused slab floor (``max(8,
    radius*fuse)`` a side) for standalone use.  ``interior_split`` probes
    the real run's K2 launch plan too (the JAX package's key).  Cost: one chunk of
    ``fuse`` iterations on one channel, once per (grid, backend, config)
    per process; its tensors are freed before it returns.
    """
    from parallel_convolution_tpu_torch.parallel.kernels import clamp_overlap
    from parallel_convolution_tpu_torch.parallel.step import clamp_col_mode

    col_mode = clamp_col_mode(col_mode, backend)
    overlap = clamp_overlap(overlap, backend)
    key = _probe_key(grid, filt, backend, quantize, fuse, boundary, tile,
                     storage, block_hw, interior_split, col_mode, overlap)
    if key in _PROBE_CACHE:
        err = _PROBE_CACHE[key]
        if err is not None:
            raise err
        return
    try:
        _run_probe(grid, filt, backend, quantize, fuse, boundary, tile,
                   storage, block_hw, interior_split, col_mode, overlap)
    except Exception as e:  # noqa: BLE001 — the verdict IS the product
        _PROBE_CACHE[key] = e
        raise
    _PROBE_CACHE[key] = None


def _run_probe(grid, filt, backend, quantize, fuse, boundary, tile, storage,
               block_hw, interior_split=False, col_mode="packed",
               overlap=False) -> None:
    from parallel_convolution_tpu_torch.parallel import step as step_lib
    from parallel_convolution_tpu_torch.parallel.mesh import split_blocks

    fuse = max(1, int(fuse))
    if block_hw is None:
        b = max(8, filt.radius * fuse)
        block_hw = (b, b)
    R, Cg = grid.shape
    valid_hw = (R * block_hw[0], Cg * block_hw[1])
    # Made on the grid's device: at BASELINE config 4 the block is the
    # image, too large for a host buffer.
    x = torch.zeros((1, *valid_hw), dtype=step_lib.STORAGE_DTYPES[storage],
                    device=grid.device)
    run = step_lib._build_iterate(grid, filt, fuse, quantize, valid_hw,
                                  tuple(block_hw), backend, fuse, boundary,
                                  tile, interior_split, col_mode, overlap)
    run(split_blocks(x, grid))
    for dev in grid.local_devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


# requested backend -> effective backend of the most recent resolution in
# this process: the JAX package's API.  No entry point of the port reads it:
# each records the backend its own resolution returned.
_LAST_RESOLVED: dict[str, str] = {}


def effective_for(requested: str) -> str | None:
    """The effective backend of this process's last resolution of
    ``requested`` (None if it was never resolved)."""
    return _LAST_RESOLVED.get(requested)


def resolve_backend(grid, filt: Filter, backend: str, *,
                    quantize: bool = True, fuse: int = 1,
                    boundary: str = "zero", tile=None, storage: str = "f32",
                    block_hw=None, interior_split: bool = False,
                    col_mode: str = "packed", overlap: bool = False) -> str:
    """Return the first backend in the grid's ``degradation_chain``
    whose probe passes (``col_mode`` and ``overlap`` re-clamped for each
    tier, ``kernels.clamp_overlap``: only ``cuda_rdma`` moves column slabs
    and has the overlapped pipeline); raise at once on a terminal probe failure, and
    :class:`RetryExhausted` when every tier failed transiently (on the
    card, a refused ``cuda`` is the last tier).

    Emits :class:`BackendDegradedWarning` when the result differs from the
    request; callers also record the returned name.

    On a grid over several processes each rank probes its own blocks (a
    grid of its own slots, ``mesh.local_grid``: no probe waits on another
    rank) and the ranks agree on the furthest rung any rank reached before
    anything runs; a rank's terminal failure raises on every rank.
    """
    chain = degradation_chain(backend, on_card=grid.device.type == "cuda")
    kw = dict(quantize=quantize, fuse=fuse, boundary=boundary, tile=tile,
              storage=storage, block_hw=block_hw,
              interior_split=interior_split, col_mode=col_mode,
              overlap=overlap)
    if getattr(grid, "spans_processes", False):
        from parallel_convolution_tpu_torch.parallel import multihost
        from parallel_convolution_tpu_torch.parallel.mesh import local_grid

        err = None
        try:
            rung, last = _walk(local_grid(grid), filt, chain, kw)
            mine = (rung, None, repr(last))
        except Exception as e:  # noqa: BLE001 -- raised on every rank
            err, mine = e, (None, multihost.portable(e), None)
        got = multihost.gather_object(mine)
        failed = [e for _, e, _ in got if e is not None]
        if failed:
            raise err if err is not None else failed[0]
        # The cause stamped is the rank's that walked furthest.
        rung, _, last = max(got, key=lambda g: g[0])
        b = chain[rung]
    else:
        rung, last = _walk(grid, filt, chain, kw)
        b = chain[rung]
    if b != backend:
        cause = last if isinstance(last, str) else repr(last)
        warnings.warn(
            f"backend {backend!r} degraded to {b!r} after transient "
            f"failure: {cause}",
            BackendDegradedWarning, stacklevel=2,
        )
        if obs_metrics.enabled():
            obs_metrics.counter(
                "pctpu_degrades_total",
                "backend degradation walks that resolved a lower tier",
                ("requested", "effective")).inc(
                requested=backend, effective=b)
            obs_events.emit("degrade", requested=backend, effective=b,
                            cause=cause[:200])
    _LAST_RESOLVED[backend] = b
    return b


def _walk(grid, filt: Filter, chain, kw) -> tuple[int, BaseException | None]:
    """``(index, last transient failure)`` of the first rung of ``chain``
    whose probe passes on ``grid``; raises at once on a terminal failure,
    and :class:`RetryExhausted` when every rung failed transiently."""
    last: BaseException | None = None
    for i, b in enumerate(chain):
        try:
            probe_backend(grid, filt, b, **kw)
        except Exception as e:  # noqa: BLE001
            if classify(e) == TERMINAL:
                raise
            last = e
            continue
        return i, last
    raise RetryExhausted(
        f"every backend in {chain} failed transiently; last: {last!r}"
    ) from last
