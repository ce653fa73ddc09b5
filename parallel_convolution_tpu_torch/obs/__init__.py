"""Observability of the port (the JAX package's ``obs/``): a metrics
registry, an event log, causal spans and halo-exchange attribution.

* :mod:`obs.metrics` — process-global typed counters / gauges /
  fixed-bucket histograms with labeled series; ``snapshot()``, Prometheus
  text via ``render_text()`` and its parser.  ``PCTPU_OBS=0`` turns every
  mutator into a one-branch no-op.
* :mod:`obs.events` — append-only JSONL event log (per-process monotonic
  ``seq``, wall and perf clocks, typed kinds) with atomic rotation,
  installed from ``PCTPU_OBS_EVENTS`` by the CLI.
* :mod:`obs.trace` — spans (trace_id / span_id / parent_id) emitted as
  ``span`` events into the same log, ``traceparent`` strings.
* :mod:`obs.attribution` — analytic per-direction halo bytes and the
  exchange-vs-compute split of the port's H100 cost model.

``python -m parallel_convolution_tpu_torch.obs.report`` folds a log and a
metrics snapshot into the summary the JAX package's
``scripts/obs_report.py`` prints; ``...obs.trace_report`` rebuilds the
span trees and writes Chrome ``trace_event`` JSON, as its
``scripts/trace_report.py``.

``obs.metrics``, ``obs.events`` and ``obs.trace`` are stdlib-only (plus
the port's ``resilience``); ``obs.attribution`` pulls the cost model and
loads on first touch.
"""

from parallel_convolution_tpu_torch.obs import events, metrics, trace

__all__ = ["attribution", "events", "metrics", "trace"]


def __getattr__(name):
    # attribution imports tuning (heavier); load it on first touch so
    # `from parallel_convolution_tpu_torch.obs import metrics` stays light.
    if name == "attribution":
        import importlib

        return importlib.import_module(
            "parallel_convolution_tpu_torch.obs.attribution")
    raise AttributeError(name)
