"""The traffic kinds: each drives the program through one of its entries
under the parameters of a traffic file, checks what the timed path
produced against :mod:`cardbench.reference`, and returns an
:class:`Outcome`.  A traffic file names its kind; nothing lists them."""

from __future__ import annotations

import dataclasses
import math
import random
import time


@dataclasses.dataclass
class Outcome:
    """What one run gives the harness: the counts, every end-to-end value
    the kind measures (under each name a cell may give it; the cell's
    entries pick), the compared numbers as ``name: (value, limit)``,
    the context the per-layer readers read, and the device's figures."""

    attempted: int
    failed: int
    end_to_end: dict
    checks: dict
    ctx: dict
    memory_peak_bytes: int
    cards: int
    window_start: float
    notes: list = dataclasses.field(default_factory=list)


def clock() -> float:
    """The harness's clock: monotonic, one clock for every process of the
    machine (``CLOCK_MONOTONIC``)."""
    return time.monotonic()


def device_of(device):
    """The device a one-process run uses: the card (``cuda:0``) unless
    told otherwise."""
    import torch

    return torch.device(device if device is not None else "cuda:0")


def synchronize(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_kernels(dev) -> None:
    """Build the port's CUDA libraries where stale (the first run in a
    checkout compiles; later runs find them in ``build/torch_kernels``)."""
    if dev.type != "cuda":
        return
    from parallel_convolution_tpu_torch.ops import _build

    _build.build_all(("stencil", "rdma"))


def memory_peak(dev) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


class Reservoir:
    """A uniform sample of at most ``k`` items of a stream of unknown
    length, drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = int(k), 0, []
        self._rng = random.Random(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self._rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` percentile (the smallest value with at
    least ``q`` percent of the values at or below it)."""
    v = sorted(values)
    return float(v[max(1, math.ceil(len(v) * q / 100.0)) - 1])
