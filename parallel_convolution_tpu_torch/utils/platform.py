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
