"""Runs of one cell in a row, each a process of its own as the check makes
them, and the spread of each metric:

    python3 -m cardbench.sets --workload <name> --seeds 11,12,13 --seconds 30 \
        [--trace 0|1] [--out <dir>/<file>.jsonl]

Each run's result line (or its failure, with the end of its standard
error) is appended to ``--out``; a summary follows on standard output:
per metric the median and the spread, the distance between the first
and third quartiles (``statistics.quantiles(values, n=4)``) as a share of
the median, and each compared number's largest reading.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "cardbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=CHECKOUT, capture_output=True, text=True)
    row = {"workload": workload, "seed": seed, "trace": trace,
           "rc": proc.returncode, "wall_s": time.monotonic() - t0,
           "stderr_tail": proc.stderr[-3000:]}
    lines = proc.stdout.strip().splitlines()
    if proc.returncode == 0 and lines:
        row["result"] = json.loads(lines[-1])
    return row


def spread(values) -> float | None:
    """Interquartile distance over the median."""
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def summary(rows: list[dict]) -> dict:
    ok = [r["result"] for r in rows if "result" in r]
    out = {"runs": len(rows), "results": len(ok),
           "correct": sum(bool(r["correct"]) for r in ok),
           "metrics": {}, "checks": {}}
    names = sorted({k for r in ok for k in r["metrics"]})
    for k in names:
        v = [r["metrics"][k]["value"] for r in ok if k in r["metrics"]]
        out["metrics"][k] = {"median": statistics.median(v),
                             "spread": spread(v), "values": v}
    for k in sorted({k for r in ok for k in r["checks"]}):
        v = [r["checks"][k]["value"] for r in ok]
        out["checks"][k] = {"max": max(v), "min": min(v), "values": v}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = one(args.workload, seed, args.seconds, args.trace)
        rows.append(row)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        res = row.get("result")
        print(json.dumps({"seed": seed, "rc": row["rc"],
                          "wall_s": round(row["wall_s"], 3),
                          "result": res} if res else
                         {"seed": seed, "rc": row["rc"],
                          "stderr_tail": row["stderr_tail"][-1500:]}),
              flush=True)
    print(json.dumps({"workload": args.workload, "seconds": args.seconds,
                      "trace": args.trace, **summary(rows)}), flush=True)
    return 0 if all("result" in r for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
