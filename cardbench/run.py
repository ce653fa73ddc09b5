"""One run of one benchmark cell:

    python3 -m cardbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

It reads the cell from ``BENCHMARK.json``, refuses to run without the
cards the cell asks for, makes its inputs from the seed, warms up, runs
the cell's traffic for ``--seconds`` seconds (traced with ``--trace 1``),
checks what the timed path produced against the plain reference, and
prints the result as the last line of standard output: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``), with the compared numbers and their limits last.  The
card's name, count and power limit are printed beside the window.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402 -- the set-up clock starts first
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Top-level modules a run must not hold once its window has closed: JAX
# and the JAX package (compared whole: the port's name begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "parallel_convolution_tpu")

CHECKOUT = Path(__file__).resolve().parent.parent


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read: {e}"


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = CHECKOUT / "build" / "cardbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def per_layer(cell, ctx: dict) -> dict:
    """The cell's per-layer metrics that their readers find."""
    from cardbench import spec

    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(cell, outcome, traced: bool, setup_s: float, kind: str) -> dict:
    """The result line of a run."""
    from cardbench import trace as trace_mod

    checks = {k: {"value": v, "limit": lim}
              for k, (v, lim) in outcome.checks.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if traced:
        metrics = per_layer(cell, outcome.ctx)
    else:
        e2e = dict(outcome.end_to_end, setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu" if kind == "cuda" else kind,
              "kind": _device_name(kind), "count": outcome.cards,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    summary = outcome.ctx.get("trace")
    if traced and summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        line["breakdown"] = trace_mod.breakdown(summary)
    line["checks"] = checks
    return line


def _device_name(kind: str) -> str:
    import torch

    return torch.cuda.get_device_name(0) if kind == "cuda" else kind


def run(argv=None, device=None, config_over=None, traffic_over=None,
        child=None) -> dict:
    """Parse the arguments and run the cell; returns the result line.
    ``device`` and the overrides are the CPU tests' (small sizes, the
    plain backend); ``child`` is handed to the kind (its fault tests)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from cardbench import spec

    cell = spec.cell(args.workload, config_over=config_over,
                     traffic_over=traffic_over)
    kind = "cpu" if device is not None else "cuda"
    if kind == "cuda":
        import torch

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            raise SystemExit(f"cardbench: {args.workload} needs {cell.chips} "
                             f"card(s), this machine has {have}")
    kind_runner = spec.kind(cell.traffic["kind"])
    outcome = kind_runner.run(cell, args.seed, args.seconds,
                              bool(args.trace), device=device, child=child)
    setup_s = outcome.window_start - T0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"cardbench: the run loaded {found}, which the "
                         "port must not use")
    line = result(cell, outcome, bool(args.trace), setup_s, kind)
    err = sys.stderr
    print(f"card: {card_line() if kind == 'cuda' else 'cpu'}; cards used "
          f"{outcome.cards}", file=err)
    for note in outcome.notes:
        print(f"run: {note}", file=err)
    print(f"run: setup_s {setup_s!r}", file=err)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=err)
    err.flush()
    return line


def main(argv=None) -> int:
    _cache_dirs()
    line = run(argv)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
