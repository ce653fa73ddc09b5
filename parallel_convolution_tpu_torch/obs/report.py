"""Fold an event log + metrics snapshot into one human/JSON summary (the
JAX package's ``scripts/obs_report.py``; on the same log and snapshot it
prints the same text and JSON).

Given the JSONL event log (``PCTPU_OBS_EVENTS``) and/or a metrics
snapshot JSON (``obs.metrics.dump``), it reports:

* per-phase latency quantiles (p50/p95/p99) from the phase histograms;
* exchange-vs-compute fraction and per-direction halo bytes per backend;
* retry / degrade / quarantine / fault / compile totals;
* predicted-vs-measured Gpx/s drift per plan key (the cost model's
  recalibration input);
* event-timeline integrity (counts per kind, seq gaps, invalid lines).

  python -m parallel_convolution_tpu_torch.obs.report --events ev.jsonl \\
      --metrics snapshot.json --out report.json

Exit status: 0 on a clean fold; 1 when an input is unreadable or the
event log fails schema validation (invalid lines / seq gaps); 2 on a
usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from parallel_convolution_tpu_torch.obs import events as events_lib


def _quantiles(buckets: list[float], counts: list[int],
               qs=(0.5, 0.95, 0.99)) -> dict[float, float | None]:
    """Bucket-interpolated quantiles from a snapshot histogram series
    (same estimate as obs.metrics.Histogram.quantile)."""
    total = sum(counts)
    out: dict[float, float | None] = {}
    for q in qs:
        if total == 0:
            out[q] = None
            continue
        rank = q * total
        cum = 0.0
        val = buckets[-1] if buckets else None
        for i, c in enumerate(counts):
            prev = cum
            cum += c
            if cum >= rank and c > 0:
                if i >= len(buckets):
                    val = buckets[-1]
                else:
                    lo = buckets[i - 1] if i > 0 else 0.0
                    val = lo + (buckets[i] - lo) * (rank - prev) / c
                break
        out[q] = val
    return out


def _metric(snap: dict, name: str) -> list[dict]:
    for m in snap.get("metrics", []):
        if m["name"] == name:
            return m["series"]
    return []


def _counter_by(snap: dict, name: str, label: str) -> dict[str, float]:
    out: dict[str, float] = {}
    for s in _metric(snap, name):
        k = s["labels"].get(label, "")
        out[k] = out.get(k, 0) + s["value"]
    return out


def summarize_metrics(snap: dict) -> dict:
    out: dict = {}
    # Serving latency: p50/p95/p99 per phase (ms), across backends.
    phases: dict[str, dict] = {}
    for s in _metric(snap, "pctpu_request_phase_seconds"):
        ph = s["labels"].get("phase", "")
        agg = phases.setdefault(ph, {"counts": None, "buckets": None,
                                     "count": 0, "sum": 0.0})
        if agg["counts"] is None:
            agg["counts"] = list(s["counts"])
            agg["buckets"] = list(s["buckets"])
        else:
            agg["counts"] = [a + b for a, b in zip(agg["counts"],
                                                   s["counts"])]
        agg["count"] += s["count"]
        agg["sum"] += s["sum"]
    out["phases_ms"] = {
        ph: {
            "count": a["count"],
            "mean": (round(1e3 * a["sum"] / a["count"], 3)
                     if a["count"] else None),
            **{f"p{int(q * 100)}": (round(1e3 * v, 3)
                                    if v is not None else None)
               for q, v in _quantiles(a["buckets"], a["counts"]).items()},
        }
        for ph, a in sorted(phases.items())
    }
    # Exchange vs compute per backend + per-direction halo bytes.
    ex = _counter_by(snap, "pctpu_exchange_seconds_total", "backend")
    comp = _counter_by(snap, "pctpu_compute_seconds_total", "backend")
    rounds = _counter_by(snap, "pctpu_halo_rounds_total", "backend")
    iters = _counter_by(snap, "pctpu_iterations_total", "backend")
    halo: dict[str, dict] = {}
    for s in _metric(snap, "pctpu_halo_bytes_total"):
        b = s["labels"].get("backend", "")
        d = s["labels"].get("direction", "")
        halo.setdefault(b, {})[d] = s["value"]
    out["exchange"] = {
        b: {
            "exchange_s": round(ex.get(b, 0.0), 6),
            "compute_s": round(comp.get(b, 0.0), 6),
            "exchange_fraction": (
                round(ex[b] / (ex[b] + comp.get(b, 0.0)), 4)
                if ex.get(b, 0.0) + comp.get(b, 0.0) > 0 else None),
            "halo_bytes": halo.get(b, {}),
            "rounds": rounds.get(b, 0),
            "iterations": iters.get(b, 0),
        }
        for b in sorted(set(ex) | set(comp) | set(halo))
    }
    # Resilience totals.
    out["totals"] = {
        "retries": sum(_counter_by(
            snap, "pctpu_retries_total", "error").values()),
        "degrades": sum(_counter_by(
            snap, "pctpu_degrades_total", "requested").values()),
        "quarantines": _counter_by(
            snap, "pctpu_quarantines_total", "cause"),
        "faults_fired": _counter_by(
            snap, "pctpu_faults_fired_total", "site"),
        "compiles": sum(_counter_by(
            snap, "pctpu_compiles_total", "builder").values()),
        "admission": _counter_by(snap, "pctpu_admission_total", "outcome"),
    }
    # Predicted-vs-measured drift per plan key (ROADMAP 5a input).
    gpx: dict[tuple[str, str], dict] = {}
    for s in _metric(snap, "pctpu_plan_gpx_per_chip"):
        key = (s["labels"].get("key", ""), s["labels"].get("backend", ""))
        gpx.setdefault(key, {})[s["labels"].get("which", "")] = s["value"]
    drift = {}
    for (key, backend), vals in sorted(gpx.items()):
        pred, meas = vals.get("predicted"), vals.get("measured")
        # Compound report key: the same plan key can carry series for
        # several backends (a degraded fallback, an A/B sweep) — one
        # must never overwrite another in the recalibration input.
        drift[f"{key}|{backend}"] = {
            "backend": backend,
            "predicted_gpx_per_chip": pred,
            "measured_gpx_per_chip": meas,
            "drift_ratio": (round(meas / pred, 4)
                            if pred and meas is not None else None),
        }
    out["drift"] = drift
    return out


def merge_client_trace(rows: list[dict], recs: list[dict]) -> dict:
    """Join a load generator's client rows (``--trace-out``, ROADMAP item
    8) to server-side span trees by the server-assigned ``trace_id``.

    The client knows wall latency as the user saw it; the server's
    ``request`` root span knows where that time went.  The join reports
    coverage (every client row should find its server trace) and the
    mean client-minus-server delta — the transport/codec overhead
    neither side can see alone.
    """
    from parallel_convolution_tpu_torch.obs import trace as trace_lib

    spans = trace_lib.span_records(recs)
    root_dur: dict[str, float] = {}
    traces: set[str] = set()
    for s in spans:
        tid = s.get("trace_id", "")
        if tid:
            traces.add(tid)
            if s.get("name") == "request" and not s.get("parent_id"):
                root_dur[tid] = float(s.get("dur_s", 0.0))
    with_id = [r for r in rows if r.get("trace_id")]
    joined = [r for r in with_id if r["trace_id"] in traces]
    deltas = [r["latency_ms"] - 1e3 * root_dur[r["trace_id"]]
              for r in joined
              if r["trace_id"] in root_dur
              and isinstance(r.get("latency_ms"), (int, float))]
    return {
        "client_rows": len(rows),
        "with_trace_id": len(with_id),
        "joined": len(joined),
        "unjoined": len(with_id) - len(joined),
        "server_only_traces": len(traces - {r["trace_id"]
                                            for r in with_id}),
        "mean_client_minus_server_ms": (
            round(sum(deltas) / len(deltas), 3) if deltas else None),
    }


def summarize_events(recs: list[dict]) -> dict:
    kinds: dict[str, int] = {}
    invalid = 0
    gaps = 0
    # seq is per-WRITER: supervisor + leg children interleave streams in
    # one file, so continuity is checked within each pid, not globally.
    prev_by_stream: dict[object, int] = {}
    for r in recs:
        if events_lib.validate_event(r):
            invalid += 1
            continue
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
        stream = r.get("pid", 0)
        prev = prev_by_stream.get(stream)
        if prev is not None and r["seq"] != prev + 1:
            gaps += 1
        prev_by_stream[stream] = r["seq"]
    ts = [r.get("ts") for r in recs
          if isinstance(r.get("ts"), (int, float))]
    return {
        "count": len(recs),
        "kinds": dict(sorted(kinds.items())),
        "invalid": invalid,
        "seq_gaps": gaps,
        "first_ts": min(ts) if ts else None,
        "last_ts": max(ts) if ts else None,
        "span_s": round(max(ts) - min(ts), 3) if ts else None,
    }


def _print_human(report: dict) -> None:
    ev = report.get("events")
    if ev:
        print(f"events: {ev['count']} lines, {ev['invalid']} invalid, "
              f"{ev['seq_gaps']} seq gaps, span {ev['span_s']}s")
        for k, n in ev["kinds"].items():
            print(f"  {k:20s} {n}")
    for ph, st in report.get("phases_ms", {}).items():
        print(f"phase {ph:10s} n={st['count']:<6d} "
              f"p50={st['p50']}ms p95={st['p95']}ms p99={st['p99']}ms")
    for b, st in report.get("exchange", {}).items():
        frac = st["exchange_fraction"]
        hb = st["halo_bytes"]
        print(f"backend {b}: exchange_fraction="
              f"{frac if frac is not None else 'n/a'} "
              f"({st['exchange_s']}s vs {st['compute_s']}s) "
              f"halo N/S/E/W="
              f"{[hb.get(d, 0) for d in ('north', 'south', 'east', 'west')]}"
              f" over {st['rounds']} rounds / {st['iterations']} iters")
    tot = report.get("totals")
    if tot:
        print(f"totals: retries={tot['retries']} degrades={tot['degrades']} "
              f"quarantines={tot['quarantines']} "
              f"faults={tot['faults_fired']} compiles={tot['compiles']} "
              f"admission={tot['admission']}")
    cj = report.get("client_join")
    if cj:
        print(f"client join: {cj['joined']}/{cj['with_trace_id']} rows "
              f"matched server traces ({cj['unjoined']} unjoined, "
              f"{cj['server_only_traces']} server-only), "
              f"client-server delta "
              f"{cj['mean_client_minus_server_ms']}ms")
    for key, d in report.get("drift", {}).items():
        print(f"drift {key}: predicted={d['predicted_gpx_per_chip']} "
              f"measured={d['measured_gpx_per_chip']} "
              f"ratio={d['drift_ratio']}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--events", default=None,
                    help="JSONL event log (rotated generations included)")
    ap.add_argument("--metrics", default=None,
                    help="metrics snapshot JSON (obs.metrics.dump)")
    ap.add_argument("--client-trace", default=None, metavar="JSONL",
                    help="loadgen --trace-out rows; joined to the server "
                         "span trees by trace_id (needs --events)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this path")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the human summary (JSON only)")
    args = ap.parse_args(argv)
    if not args.events and not args.metrics:
        print("need --events and/or --metrics", file=sys.stderr)
        return 2

    report: dict = {}
    rc = 0
    if args.events:
        try:
            recs = events_lib.read_events(args.events)
        except (OSError, ValueError) as e:
            print(f"obs_report: unreadable event log: {e}", file=sys.stderr)
            return 1
        report["events"] = summarize_events(recs)
        if report["events"]["invalid"]:
            print(f"obs_report: {report['events']['invalid']} invalid "
                  "event lines", file=sys.stderr)
            rc = 1
        if report["events"]["seq_gaps"]:
            # Lost lines ARE the integrity failure the seq field exists
            # to detect — a torn timeline fails the report.
            print(f"obs_report: {report['events']['seq_gaps']} seq gaps "
                  "(lost event lines)", file=sys.stderr)
            rc = 1
        if args.client_trace:
            try:
                rows = [json.loads(line) for line in Path(
                    args.client_trace).read_text().splitlines()
                    if line.strip()]
            except (OSError, ValueError) as e:
                print(f"obs_report: unreadable client trace: {e}",
                      file=sys.stderr)
                return 1
            report["client_join"] = merge_client_trace(rows, recs)
    elif args.client_trace:
        print("obs_report: --client-trace needs --events", file=sys.stderr)
        return 2
    if args.metrics:
        try:
            snap = json.loads(Path(args.metrics).read_text())
        except (OSError, ValueError) as e:
            print(f"obs_report: unreadable metrics snapshot: {e}",
                  file=sys.stderr)
            return 1
        report.update(summarize_metrics(snap))

    if not args.quiet:
        _print_human(report)
    if args.out:
        p = Path(args.out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(  # diskio: exempt — report of a finished run
            json.dumps(report, indent=2))
    else:
        print(json.dumps(report))
    return rc


if __name__ == "__main__":
    sys.exit(main())
