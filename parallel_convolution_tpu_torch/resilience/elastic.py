"""Elastic grid recovery: survive a change in the device set (the JAX
package's ``resilience/elastic.py``).

Detect that the set of live devices changed, propose a grid spec that
fits what is alive, and let every layer re-bind onto it:

* checkpoints reshard onto the new grid (``utils.checkpoint.load_state``);
* the supervisor walks a leg's grid ladder on a device-loss signature
  (``resilience.supervisor``: ``meshes`` / ``mesh_env`` /
  ``reshape_pattern``), each rung exported through :data:`MESH_ENV`, which
  ``parallel.mesh.grid_from_spec`` reads when ``--mesh`` is not given;
* the serving engine drains, drops and re-warms its entries mid-process
  (``serving.engine.WarmEngine.reshape``); a model swaps its grid with
  ``ConvolutionModel.set_grid`` / ``JacobiSolver.set_grid``.

**What a grid needs.**  A JAX mesh of R×C always holds R·C distinct
devices.  A port grid may put every block on one device (the one-device
form) or repeat devices among its slots (``Grid.devices``), so
:func:`detect_change` counts the *distinct* devices a grid needs
(:func:`devices_needed`) against the live count: a one-card grid never
shrinks while one card lives, and a grid of slots with a device per block
shrinks exactly as the JAX mesh does.  The ladder's rungs are grids with a
device per block (the form ``--device all`` takes where there are R·C
cards), so :func:`next_fit` keeps the JAX rule ``R·C <= live``.

Torch-free at import: the device count comes from a child process
(``utils.platform.probe_device_count``), so the supervisor consults health
without touching a device in its own process.
"""

from __future__ import annotations

import dataclasses

# The env var reshape-aware legs read their grid spec from (the supervisor
# writes it each attempt; ``mesh.grid_from_spec`` reads it).  One name, the
# JAX package's, so drills and legs cannot drift.
MESH_ENV = "PCTPU_MESH"


def parse_spec(spec: str) -> tuple[int, int]:
    """``"RxC"`` -> (R, C); the grammar of ``mesh.mesh_from_spec``."""
    try:
        r, c = (int(v) for v in spec.lower().split("x"))
    except ValueError as e:
        raise ValueError(f"mesh spec must be RxC, got {spec!r}") from e
    if r < 1 or c < 1:
        raise ValueError(f"mesh spec must be positive, got {spec!r}")
    return r, c


def format_spec(grid: tuple[int, int]) -> str:
    return f"{grid[0]}x{grid[1]}"


def grid_ladder(start: tuple[int, int]) -> list[str]:
    """The shrink ladder from ``start`` down to 1x1, halving the larger
    axis each step — e.g. (2, 4) -> ["2x4", "2x2", "2x1", "1x1"].

    Each rung needs at most half the previous rung's devices, so ANY
    shrink of the device set lands on some rung; the ladder is what
    reshape-aware supervisor legs and the soak drill walk.
    """
    out = [format_spec(start)]
    r, c = start
    while (r, c) != (1, 1):
        if c >= r:
            c = max(1, c // 2)
        else:
            r = max(1, r // 2)
        out.append(format_spec((r, c)))
    return out


def next_fit(specs: list[str], start: int, live: int | None) -> int:
    """The index of the next spec in ``specs[start:]`` that fits ``live``
    devices (first one when ``live`` is None — health unknown, just step
    down one rung).  Falls back to the last (smallest) spec when nothing
    fits; clamps into range so callers can pass ``idx + 1`` blindly.
    """
    if not specs:
        return 0
    start = min(max(0, start), len(specs) - 1)
    if live is None:
        return start
    for i in range(start, len(specs)):
        r, c = parse_spec(specs[i])
        if r * c <= max(1, live):
            return i
    return len(specs) - 1


@dataclasses.dataclass(frozen=True)
class MeshChange:
    """A detected change in the usable device set."""

    old_grid: tuple[int, int]
    live: int                      # devices the probe can see now
    new_spec: str | None           # proposed RxC that fits, None = none fits

    @property
    def lost(self) -> int:
        return self.old_grid[0] * self.old_grid[1] - self.live


def devices_needed(grid) -> int:
    """The distinct devices ``grid`` runs on: 1 for the one-device form,
    the distinct slots of a grid of slots (R·C where each block has a
    device of its own)."""
    return len(set(grid.slots))


def detect_change(grid, timeout: float = 60.0) -> MeshChange | None:
    """Probe the health of ``grid``'s device type; None while every device
    the grid needs (:func:`devices_needed`) still lives.

    A shrink proposes the first rung of :func:`grid_ladder` below the
    grid's shape that fits the live count (near-square is NOT forced:
    keeping the aspect keeps block shapes, and any tuned plans for them,
    closer to the original run's).  A probe failure (None count) also
    returns None: "health unknown" must not trigger a reshape.  The CPU
    counts as one device, so a CPU grid never shrinks.
    """
    from parallel_convolution_tpu_torch.utils.platform import (
        probe_device_count,
    )

    shape = tuple(grid.shape)
    live = probe_device_count(timeout=timeout,
                              device_type=grid.device.type)
    if live is None or live >= devices_needed(grid):
        return None
    ladder = grid_ladder(shape)
    spec = ladder[next_fit(ladder, 1, live)]
    r, c = parse_spec(spec)
    return MeshChange(old_grid=shape, live=live,
                      new_spec=spec if r * c <= live else None)


def reshape_grid(spec_or_grid, devices=None, device=None):
    """The post-change grid: ``"RxC"`` (or an (R, C) tuple) with a slot per
    block over the first R·C of ``devices`` (e.g. the survivors after a
    dead card is filtered out; repeats allowed), by default every card
    (``torch.cuda.device_count()``; it raises without CUDA), or every
    slot ``cpu`` with ``device="cpu"``.  The elastic counterpart of
    ``mesh.grid_from_spec(spec, "all")`` (the JAX package's
    ``reshape_mesh``); fewer devices than blocks raise."""
    import torch

    from parallel_convolution_tpu_torch.parallel.mesh import make_grid
    from parallel_convolution_tpu_torch.utils.platform import resolve_device

    grid = (parse_spec(spec_or_grid) if isinstance(spec_or_grid, str)
            else (int(spec_or_grid[0]), int(spec_or_grid[1])))
    n = grid[0] * grid[1]
    if devices is None:
        if device is not None and torch.device(device).type == "cpu":
            devices = ["cpu"] * n
        else:
            resolve_device(device)  # raises without CUDA
            devices = [torch.device("cuda", k)
                       for k in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < n:
        raise ValueError(
            f"mesh {format_spec(grid)} needs {n} devices, "
            f"only {len(devices)} available")
    return make_grid(grid, devices=devices[:n])
