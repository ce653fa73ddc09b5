"""The control of a cell's comparison: the plain reference in bfloat16
put in the program's place, judged as a run judges the program, at the
cell's own sizes, on one card:

    python3 -m cardbench.control --workload <name> --seeds 11,12,13

It prints, for each seed, the numbers a run compares with the limits the
configuration holds; a limit has to lie below the least of these.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(workload: str, seed: int, device=None, config_over=None,
             traffic_over=None) -> dict:
    """The control's compared numbers of ``workload`` for ``seed``."""
    import torch

    from cardbench import spec

    cell = spec.cell(workload, config_over=config_over,
                     traffic_over=traffic_over)
    dev = torch.device(device if device is not None else "cuda:0")
    return spec.kind(cell.traffic["kind"]).control(cell, seed, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cardbench.control: no card")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        got = readings(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": got,
                          "seconds": round(time.monotonic() - t0, 3)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
