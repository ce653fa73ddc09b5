"""Reconstruct span trees from the event log; critical paths; Chrome JSON
(the JAX package's ``scripts/trace_report.py``; on the same log it prints
the same text, JSON and Chrome ``trace_event`` file).

Given the JSONL event log (``PCTPU_OBS_EVENTS``) holding ``span`` events
(``obs.trace``), it reports

* per-trace tree integrity (exactly one root, zero orphan spans);
* per-batch attribution where the log has ``batch`` spans (who paid for
  the build, who rode along, the exposed exchange share of the device
  wall; the serving layer, ROADMAP item 8, emits them);
* per-span-name duration stats (count / total / p50 / p95);
* the longest-child critical path of the slowest traces;
* optionally ``--chrome out.json``: Chrome ``trace_event`` JSON, for
  chrome://tracing or ui.perfetto.dev.

  python -m parallel_convolution_tpu_torch.obs.trace_report \\
      --events ev.jsonl --out report.json --chrome chrome.json

Exit status: 0 on a clean reconstruction; 1 when the log has no spans,
any trace has orphan spans or more than one root, or an input is
unreadable.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from parallel_convolution_tpu_torch.obs import events as events_lib
from parallel_convolution_tpu_torch.obs import trace as trace_lib


def _percentile(vals: list[float], q: float) -> float | None:
    if not vals:
        return None
    s = sorted(vals)
    i = min(len(s) - 1, int(round(q * (len(s) - 1))))
    return s[i]


def name_stats(spans: list[dict]) -> dict:
    """count / total / p50 / p95 duration (ms) per span name."""
    by: dict[str, list[float]] = {}
    for r in spans:
        by.setdefault(r.get("name", ""), []).append(
            float(r.get("dur_s", 0.0)))
    return {
        name: {
            "count": len(ds),
            "total_ms": round(1e3 * sum(ds), 3),
            "p50_ms": round(1e3 * _percentile(ds, 0.50), 3),
            "p95_ms": round(1e3 * _percentile(ds, 0.95), 3),
        }
        for name, ds in sorted(by.items())
    }


def critical_path(tree: dict, root_id: str) -> list[dict]:
    """Root-to-leaf path choosing the longest-duration child at every
    level — where a request's wall actually went."""
    path = []
    sid = root_id
    while sid is not None:
        r = tree["spans"][sid]
        path.append({"name": r.get("name", ""),
                     "dur_ms": round(1e3 * float(r.get("dur_s", 0.0)), 3)})
        kids = tree["children"].get(sid, [])
        sid = (max(kids, key=lambda k: tree["spans"][k].get("dur_s", 0.0))
               if kids else None)
    return path


def analyze_batches(trees: dict) -> list[dict]:
    """Per-batch attribution: payer, riders, exchange share of device."""
    out = []
    for tid, tree in trees.items():
        for sid, r in tree["spans"].items():
            if r.get("name") != "batch":
                continue
            kids = {tree["spans"][k]["name"]: tree["spans"][k]
                    for k in tree["children"].get(sid, [])}
            compile_s = float(kids.get("compile", {}).get("dur_s", 0.0))
            device = kids.get("device")
            dev_s = float(device.get("dur_s", 0.0)) if device else 0.0
            ex_s = hid_s = comp_s = 0.0
            if device:
                for k in tree["children"].get(device["span_id"], []):
                    kr = tree["spans"][k]
                    if kr["name"] == "exchange":
                        ex_s += float(kr.get("dur_s", 0.0))
                        hid_s += float(kr.get("attrs", {}).get(
                            "hidden_s", 0.0))
                    elif kr["name"] == "compute":
                        comp_s += float(kr.get("dur_s", 0.0))
            attrs = r.get("attrs", {})
            out.append({
                "trace_id": tid,              # the PAYER: whose trace owns
                #                               the shared compile/device
                "span_id": sid,
                "batch_size": attrs.get("batch_size",
                                        attrs.get("n_requests")),
                "effective_backend": attrs.get("effective_backend", ""),
                "plan_key": attrs.get("plan_key", ""),
                "linked_traces": sorted({l["trace_id"]
                                         for l in r.get("links", [])}),
                "compile_ms": round(1e3 * compile_s, 3),
                "device_ms": round(1e3 * dev_s, 3),
                # The per-phase breakdown the span tree makes first-class:
                # exposed exchange share of the device wall (+ the r12
                # hidden-under-compute share as its own number).
                "exposed_exchange_ms": round(1e3 * ex_s, 3),
                "hidden_exchange_ms": round(1e3 * hid_s, 3),
                "compute_ms": round(1e3 * comp_s, 3),
                "exposed_exchange_fraction_of_device": (
                    round(ex_s / dev_s, 4) if dev_s > 0 else None),
            })
    return out


def chrome_trace(spans: list[dict]) -> dict:
    """Chrome ``trace_event`` JSON: one complete ('X') event per span.

    pid = the emitting process; tid = a stable small index per trace, so
    each request's tree reads as one row in the chrome://tracing UI.
    """
    t0 = min((float(r.get("start_ts", 0.0)) for r in spans),
             default=0.0)
    tids: dict[str, int] = {}
    rows: set[tuple[int, int]] = set()   # (pid, tid) pairs actually used
    evs = []
    for r in sorted(spans, key=lambda r: r.get("start_ts", 0.0)):
        trace_id = r.get("trace_id", "")
        tid = tids.setdefault(trace_id, len(tids) + 1)
        rows.add((r.get("pid", 0), tid))
        evs.append({
            "name": r.get("name", ""),
            "cat": "pctpu",
            "ph": "X",
            "ts": round(1e6 * (float(r.get("start_ts", 0.0)) - t0), 1),
            "dur": max(0.1, round(1e6 * float(r.get("dur_s", 0.0)), 1)),
            "pid": r.get("pid", 0),
            "tid": tid,
            "args": {
                "trace_id": trace_id,
                "span_id": r.get("span_id", ""),
                "parent_id": r.get("parent_id", ""),
                "status": r.get("status", ""),
                **r.get("attrs", {}),
            },
        })
    # Name the per-trace rows so the UI shows the trace id, not "tid 3".
    # Viewers key thread_name by (pid, tid), so emit one per REAL pair —
    # a hardcoded pid would label a phantom process instead.
    by_tid = {i: t for t, i in tids.items()}
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": f"trace {by_tid[tid][:8]}"}}
            for pid, tid in sorted(rows)]
    return {"traceEvents": meta + evs, "displayTimeUnit": "ms"}


def analyze(recs: list[dict], max_paths: int = 10) -> tuple[dict, int]:
    """The report dict + exit code."""
    spans = trace_lib.span_records(recs)
    trees = trace_lib.build_trees(spans)
    problems = []
    multi_root, orphaned = [], []
    for tid, t in trees.items():
        if len(t["roots"]) != 1:
            multi_root.append(tid)
        if t["orphans"]:
            orphaned.append(tid)
    if not spans:
        problems.append("no span events in the log")
    if multi_root:
        problems.append(f"{len(multi_root)} traces with != 1 root")
    if orphaned:
        problems.append(f"{len(orphaned)} traces with orphan spans")
    # Critical paths of the slowest traces (by root duration).
    rooted = [(tid, t) for tid, t in trees.items() if len(t["roots"]) == 1]
    rooted.sort(key=lambda kv: -float(
        kv[1]["spans"][kv[1]["roots"][0]].get("dur_s", 0.0)))
    paths = {
        tid: critical_path(t, t["roots"][0])
        for tid, t in rooted[:max_paths]
    }
    report = {
        "spans": len(spans),
        "traces": len(trees),
        "roots_per_trace_ok": not multi_root,
        "orphan_spans": sum(len(t["orphans"]) for t in trees.values()),
        "multi_root_traces": multi_root[:10],
        "orphaned_traces": orphaned[:10],
        "by_name": name_stats(spans),
        "batches": analyze_batches(trees),
        "critical_paths": paths,
        "problems": problems,
    }
    return report, (1 if problems else 0)


def _print_human(report: dict) -> None:
    print(f"spans: {report['spans']} across {report['traces']} traces, "
          f"{report['orphan_spans']} orphans")
    for name, st in report["by_name"].items():
        print(f"  {name:14s} n={st['count']:<5d} p50={st['p50_ms']}ms "
              f"p95={st['p95_ms']}ms total={st['total_ms']}ms")
    for b in report["batches"]:
        print(f"batch {b['span_id'][:8]} (payer {b['trace_id'][:8]}, "
              f"{len(b['linked_traces'])} riders): "
              f"compile={b['compile_ms']}ms device={b['device_ms']}ms "
              f"exposed_exchange={b['exposed_exchange_ms']}ms "
              f"(hidden {b['hidden_exchange_ms']}ms) "
              f"share={b['exposed_exchange_fraction_of_device']}")
    for p in report["problems"]:
        print(f"PROBLEM: {p}", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--events", required=True,
                    help="JSONL event log (rotated generations included)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this path")
    ap.add_argument("--chrome", default=None, metavar="JSON",
                    help="write Chrome trace_event JSON for "
                         "chrome://tracing / ui.perfetto.dev")
    ap.add_argument("--max-paths", type=int, default=10,
                    help="critical paths for the N slowest traces")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the human summary (JSON only)")
    args = ap.parse_args(argv)

    try:
        recs = events_lib.read_events(args.events)
    except (OSError, ValueError) as e:
        print(f"trace_report: unreadable event log: {e}", file=sys.stderr)
        return 1
    report, rc = analyze(recs, max_paths=args.max_paths)

    if args.chrome:
        p = Path(args.chrome)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(  # diskio: exempt — a finished run's trace
            chrome_trace(trace_lib.span_records(recs))))
        report["chrome"] = str(p)
    if not args.quiet:
        _print_human(report)
    if args.out:
        p = Path(args.out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(  # diskio: exempt — report of a finished run
            json.dumps(report, indent=2))
    else:
        print(json.dumps({k: v for k, v in report.items()
                          if k != "critical_paths"}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
