"""Observability for the port's parameter-server tier (PyTorch port of the
parts of ``distkeras_tpu.obs`` the PS books use; pure Python copies, so
both packages' registries, digests and bundles agree sample for sample).

- ``metrics``: Prometheus-style :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` in a :class:`MetricsRegistry`
  (:class:`CounterGroup` keeps ``counters["key"] += 1`` call sites),
  renderable as the Prometheus text format (``render_prometheus`` /
  ``parse_prometheus``).
- ``recorder``: the always-on :class:`FlightRecorder` ring of component
  events (PS commit positions, replication attach/detach, promotion,
  armed fault-seam firings) plus :func:`dump_postmortem`, the bundle
  writer a promoting standby dumps through.
- ``slo``: declarative :class:`SloSpec` objectives evaluated from the
  registries (:func:`evaluate_slos` / :class:`SloEvaluator`).
- ``timeseries``: :class:`MetricsHistory`, a bounded ring of periodic
  registry snapshots answering windowed queries (counter rates,
  windowed quantiles, trends, burn-rate verdicts); the PS serves its
  digest over the socket tier's ``t`` action.

- ``tracing``: :class:`TraceContext` propagated in the optional
  ``trace`` field of the DKT1 header, :class:`Span` records in a
  :class:`TraceCollector`, and :func:`request_spans`, the server-side
  timeline of one request (the serving front's traces).

The serving tier's compile ledger and overlap ledger are not ported yet.
"""

from distkeras_tpu_torch.obs.metrics import (
    Counter,
    CounterGroup,
    Gauge,
    Histogram,
    MetricsRegistry,
    label_samples,
    parse_prometheus,
    render_prometheus,
)
from distkeras_tpu_torch.obs.recorder import (
    POSTMORTEM_SCHEMA,
    FlightRecorder,
    build_postmortem,
    dump_postmortem,
    latest_postmortem,
)
from distkeras_tpu_torch.obs.slo import (
    SloEvaluator,
    SloSpec,
    default_serving_slos,
    default_training_slos,
    evaluate_slos,
)
from distkeras_tpu_torch.obs.timeseries import (
    FAST_WINDOW,
    SLOW_WINDOW,
    MetricsHistory,
    worst_burn,
)
from distkeras_tpu_torch.obs.tracing import (
    COLLECTOR,
    Span,
    TraceCollector,
    TraceContext,
    new_id,
    request_spans,
    span_record,
    stamp_error_trace,
    start_span,
    timeline_complete,
)

__all__ = [
    "COLLECTOR",
    "FAST_WINDOW",
    "POSTMORTEM_SCHEMA",
    "SLOW_WINDOW",
    "Counter",
    "CounterGroup",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsHistory",
    "MetricsRegistry",
    "SloEvaluator",
    "SloSpec",
    "Span",
    "TraceCollector",
    "TraceContext",
    "build_postmortem",
    "default_serving_slos",
    "default_training_slos",
    "dump_postmortem",
    "evaluate_slos",
    "label_samples",
    "latest_postmortem",
    "new_id",
    "parse_prometheus",
    "render_prometheus",
    "request_spans",
    "span_record",
    "stamp_error_trace",
    "start_span",
    "timeline_complete",
    "worst_burn",
]
