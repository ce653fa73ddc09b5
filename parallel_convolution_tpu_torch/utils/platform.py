"""Device resolution: the port runs on the card unless the caller asks for
the CPU, and never falls back quietly."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device; ``"cpu"`` / ``"cuda[:N]"`` /
    a ``torch.device`` as given.  Raises when CUDA is asked for (or
    defaulted to) and is not available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by "
                "default. Pass device='cpu' (CLI: --device cpu) to run the "
                "plain PyTorch versions on the CPU.")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} asked for but CUDA is not available; "
                "pass device='cpu' to run on the CPU.")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be cpu or cuda, got {str(dev)!r}")
    return dev


def device_kind(device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def topology(grid=None) -> dict:
    """``{"hosts": N, "slice_topology": "1xD:kind"}`` of a run, the JAX
    package's row-keying identity (``utils/platform.py:topology``): ``hosts``
    the processes of the job (``multihost.process_count``), ``D`` the
    distinct devices of ``grid`` (its slots; one for a one-device grid) and
    ``kind`` :func:`device_kind` of its first, spaces as underscores.  Never
    raises: a row is stamped ``1x0:unknown`` rather than lost."""
    try:
        from parallel_convolution_tpu_torch.parallel import multihost

        hosts = max(1, int(multihost.process_count()))
        devs = (list(dict.fromkeys(grid.slots)) if grid is not None
                else [resolve_device(None)])
        kind = device_kind(devs[0]).replace(" ", "_") or "unknown"
    except Exception:  # noqa: BLE001 -- stamping a row must never fail
        return {"hosts": 1, "slice_topology": "1x0:unknown"}
    return {"hosts": hosts, "slice_topology": f"1x{len(devs)}:{kind}"}


def power_limit_w(device) -> float | None:
    """The card's power limit in watts, as ``nvidia-smi`` reports it (a
    card set below its maximum runs slower under load, so a time is
    recorded beside it); None on the CPU or where ``nvidia-smi`` cannot
    say."""
    import subprocess

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=60)
        return float(res.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


# The simulation override of the device-health probe (the JAX package's
# name): a drill on a host that cannot really lose a device sets
# PCTPU_SIM_DEVICES=N and the probe reports N live devices without a child.
SIM_DEVICES_ENV = "PCTPU_SIM_DEVICES"

# The child's source: the card count (it reads CUDA_VISIBLE_DEVICES,
# inherited with the environment; 0 without CUDA), or with "auto" the
# CPU's one device where CUDA is not available.  The count is the last
# line of its output.
_COUNT_SRC = """
import sys, torch
if not torch.cuda.is_available():
    print(1 if sys.argv[1] == "auto" else 0)
else:
    print(torch.cuda.device_count())
"""


def probe_device_count(timeout: float = 60.0,
                       device_type: str | None = None) -> int | None:
    """How many devices of ``device_type`` (``"cuda"`` / ``"cpu"``; None:
    the card where CUDA is available, else the CPU) are alive right now:
    the elastic-recovery health probe of the JAX package
    (``utils/platform.py:probe_device_count``).

    The count runs in a CHILD process, which inherits the environment
    (``CUDA_VISIBLE_DEVICES`` included): a card in trouble can hang the
    first CUDA call of a process, and the caller (the supervisor, a
    serving loop) must not be that process.  A hang past ``timeout`` or a
    failed child returns None ("health unknown": callers keep their
    grid).  ``PCTPU_SIM_DEVICES=N`` short-circuits to N, as in the JAX
    package; the ``device_probe`` fault site is consulted first.

    **The CPU counts as one device.**  Every CPU slot of a grid is the
    same ``cpu`` device (a CPU grid needs one distinct device, whatever
    its shape), and it lives as long as the probing process does; so the
    probe of the CPU reports 1, never 0, and no CPU grid ever looks
    shrunk (``resilience.elastic.detect_change``).
    """
    import os
    import subprocess
    import sys

    sim = os.environ.get(SIM_DEVICES_ENV)
    if sim:
        try:
            return max(0, int(sim))
        except ValueError:
            print(f"pconv-torch: ignoring non-integer {SIM_DEVICES_ENV}="
                  f"{sim!r}", file=sys.stderr)
    from parallel_convolution_tpu_torch.resilience.faults import fault_point

    fault_point("device_probe")
    kind = device_type or "auto"
    if kind not in ("auto", "cuda", "cpu"):
        raise ValueError(f"device_type must be cuda or cpu, got {kind!r}")
    if kind == "cpu":
        return 1
    try:
        p = subprocess.run([sys.executable, "-c", _COUNT_SRC, kind],
                           timeout=timeout, capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        return None
    if p.returncode != 0:
        return None
    try:
        return int(p.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return None
