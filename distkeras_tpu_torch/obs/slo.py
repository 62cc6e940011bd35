"""Declarative SLOs evaluated from the typed-metrics registries (PyTorch
port: a copy of ``distkeras_tpu.obs.slo``).

The registries make every subsystem scrapeable; this is the judgment
layer: the soak bar ("0 hung / 0 untyped") is asserted by
harnesses, but in production the metrics are numbers a human must
eyeball. An :class:`SloSpec` turns one registry series into an
automatic verdict — p99 latency under a bound, error rate under a
ceiling, speculative acceptance over a floor, PS straggler ratio
under a cap — and :func:`evaluate_slos` grades a whole spec list
against a ``metrics_snapshot()`` sample list (pure function: the
tests drive it without an engine).

Verdicts are three-valued, per the usual burn-rate discipline:

- ``ok``      — every spec within its target
- ``warn``    — some spec past its ``warn`` threshold but not its
  breach threshold (the page-later tier)
- ``breach``  — some spec past its ``threshold`` (the page-now tier)

:class:`SloEvaluator` is the component-side wrapper: cadence-guarded
evaluation (``maybe_evaluate`` at most once per ``interval``, so a
health poll costs a dict read between evaluations), a breach counter
in the owning registry (``<prefix>_slo_breaches``), and a
``slo.breach`` / ``slo.warn`` event in the component's flight
recorder — so an SLO violation is part of the post-mortem timeline,
not a separate dashboard's memory. The engine rides verdicts on the
``health`` verb (``slo``/``slo_violations``), and the fleet health
sweep can optionally EJECT a replica on sustained breach
(``FleetRouter(eject_on_slo_breach=N)``).

Spec semantics: ``agg`` picks how the named series reduces to one
number — ``"value"`` (counter/gauge sample value), ``"p50"``/
``"p99"`` (histogram bucket-resolution quantile), ``"mean"``
(histogram sum/count), ``"rate"`` (this series' value divided by
``per``'s value — error rates, acceptance rates). ``bound`` is the
direction: ``"max"`` means values ABOVE the threshold violate,
``"min"`` means values below do. ``min_count`` refuses to judge a
histogram/rate with fewer observations (a single slow request must
not page anyone).
"""

from __future__ import annotations

import time

OK, WARN, BREACH = "ok", "warn", "breach"


class SloSpec:
    """One service-level objective over one registry series.

    ``labels``: optional label constraints — the spec then grades the
    first sample of ``series`` whose labels CONTAIN them (e.g.
    ``{"tenant": "interactive"}`` picks that tenant's labeled latency
    histogram). Empty/None keeps the historical behavior: the first
    sample under the name (a component's own book)."""

    __slots__ = ("name", "series", "threshold", "warn", "agg", "bound",
                 "per", "min_count", "labels")

    def __init__(self, name: str, series: str, threshold: float,
                 warn: float | None = None, agg: str = "value",
                 bound: str = "max", per: str | None = None,
                 min_count: int = 1, labels: dict | None = None):
        if agg not in ("value", "p50", "p99", "mean", "rate"):
            raise ValueError(f"unknown agg {agg!r}")
        if bound not in ("max", "min"):
            raise ValueError(f"bound must be 'max' or 'min'; got {bound!r}")
        if agg == "rate" and per is None:
            raise ValueError("agg='rate' needs per= (the denominator series)")
        self.name = name
        self.series = series
        self.threshold = float(threshold)
        self.warn = None if warn is None else float(warn)
        self.agg = agg
        self.bound = bound
        self.per = per
        self.min_count = int(min_count)
        self.labels = dict(labels or {})

    def describe(self) -> dict:
        return {
            "name": self.name, "series": self.series,
            "threshold": self.threshold, "warn": self.warn,
            "agg": self.agg, "bound": self.bound, "per": self.per,
            "labels": dict(self.labels),
        }


def _hist_quantile(sample: dict, q: float):
    """Bucket-resolution quantile out of a histogram SAMPLE (the same
    estimate ``Histogram.quantile`` computes live)."""
    count = sample.get("count", 0)
    if not count:
        return None
    target = max(1, int(q * count))
    last = None
    for le, cum in sample["buckets"]:
        if le != "+Inf":
            last = float(le)
        if cum >= target:
            return last  # the +Inf bucket reports the top finite bound
    return last


def _pick_sample(by_name: dict, series: str, labels: dict):
    """The sample a spec grades: first sample under the name whose
    labels contain ``labels`` (empty labels = the first sample, the
    historical component-own-book behavior)."""
    for s in by_name.get(series, ()):
        have = s.get("labels") or {}
        if all(have.get(k) == v for k, v in labels.items()):
            return s
    return None


def _reduce(spec: SloSpec, by_name: dict):
    """Reduce ``spec``'s series to ``(value, count)`` from the sample
    index; value None = not judgeable (missing series, empty
    histogram, zero denominator)."""
    s = _pick_sample(by_name, spec.series, spec.labels)
    if s is None:
        return None, 0
    if spec.agg == "value":
        v = s.get("value")
        return (None if v is None else float(v)), 1
    if spec.agg in ("p50", "p99"):
        q = 0.5 if spec.agg == "p50" else 0.99
        return _hist_quantile(s, q), int(s.get("count", 0))
    if spec.agg == "mean":
        count = int(s.get("count", 0))
        if not count:
            return None, 0
        return float(s["sum"]) / count, count
    # rate: numerator value / denominator value
    den = _pick_sample(by_name, spec.per, spec.labels)
    num_v = s.get("value")
    den_v = None if den is None else den.get("value")
    if num_v is None or not den_v:
        return None, 0
    return float(num_v) / float(den_v), int(den_v)


def evaluate_slos(samples, specs) -> dict:
    """Grade ``specs`` against a ``metrics_snapshot()`` sample list.
    Returns ``{"slo": ok|warn|breach, "violations": [...], "specs":
    [...]}`` — ``violations`` names the violating series with the
    measured value and the crossed threshold (what the ``health``
    verb ships), ``specs`` is the full per-spec detail."""
    by_name: dict = {}
    for s in samples:
        # every sample under the name, in arrival order: unlabeled
        # specs read the first (own book — the historical behavior),
        # labeled specs find their (e.g. per-tenant) twin
        by_name.setdefault(s["name"], []).append(s)
    detail = []
    worst = OK
    violations = []
    for spec in specs:
        value, count = _reduce(spec, by_name)
        verdict = OK
        if value is None or count < spec.min_count:
            verdict = OK  # not judgeable ≠ violated
        else:
            over = (
                value > spec.threshold
                if spec.bound == "max"
                else value < spec.threshold
            )
            warned = spec.warn is not None and (
                value > spec.warn
                if spec.bound == "max"
                else value < spec.warn
            )
            verdict = BREACH if over else (WARN if warned else OK)
        row = {
            "name": spec.name,
            "series": spec.series,
            "agg": spec.agg,
            "value": value,
            "threshold": spec.threshold,
            "warn": spec.warn,
            "bound": spec.bound,
            "verdict": verdict,
        }
        if spec.labels:
            row["labels"] = dict(spec.labels)  # names WHOSE series
        detail.append(row)
        if verdict != OK:
            violations.append(
                {k: row[k] for k in
                 ("name", "series", "value", "threshold", "verdict")}
            )
        if verdict == BREACH or (verdict == WARN and worst == OK):
            worst = verdict
    return {"slo": worst, "violations": violations, "specs": detail}


class SloEvaluator:
    """Component-side SLO watchdog: cadence-guarded evaluation over a
    snapshot callable, verdicts cached between evaluations, breaches
    counted in the registry and recorded in the flight recorder."""

    def __init__(self, specs, snapshot_fn, interval: float = 5.0,
                 registry=None, recorder=None, prefix: str = "serving"):
        self.specs = list(specs)
        self._snapshot_fn = snapshot_fn
        self.interval = float(interval)
        self._recorder = recorder
        self._last_eval = 0.0
        self._verdict = {"slo": OK, "violations": [], "specs": []}
        self._breach_counter = None
        if registry is not None:
            self._breach_counter = registry.counter(
                f"{prefix}_slo_breaches"
            )
            registry.gauge(
                f"{prefix}_slo_status",
                fn=lambda: {OK: 0, WARN: 1, BREACH: 2}[
                    self._verdict["slo"]
                ],
            )

    @property
    def verdict(self) -> dict:
        return self._verdict

    def evaluate(self) -> dict:
        """Forced evaluation (post-mortem dumps call this so the
        bundle carries a verdict as of the failure, not a stale one)."""
        prev = self._verdict["slo"]
        v = evaluate_slos(self._snapshot_fn(), self.specs)
        self._verdict = v
        self._last_eval = time.monotonic()
        if v["slo"] == BREACH:
            if self._breach_counter is not None:
                self._breach_counter.inc()
            if self._recorder is not None and prev != BREACH:
                # record the TRANSITION into breach (a sustained breach
                # is one incident, not one ring entry per health poll)
                self._recorder.record(
                    "slo.breach", violations=v["violations"]
                )
        elif v["slo"] == WARN and prev == OK and self._recorder is not None:
            self._recorder.record("slo.warn", violations=v["violations"])
        return v

    def maybe_evaluate(self) -> dict:
        """Evaluate at most once per ``interval``; between evaluations
        the cached verdict is returned (a router polling health every
        250 ms costs a float compare, not a registry walk)."""
        if time.monotonic() - self._last_eval >= self.interval:
            return self.evaluate()
        return self._verdict


def default_serving_slos(latency_p99_s=None, ttft_p99_s=None,
                         error_rate=None, acceptance_rate=None,
                         min_count=20,
                         tenant_latency_p99_s=None,
                         overlap_efficiency_min=None) -> list[SloSpec]:
    """The serving-tier spec set, opt-in per knob (None = not
    enforced): end-to-end p99 latency, TTFT p99, typed-internal error
    rate (internal errors / submitted — the denominator includes
    rejected and in-flight requests, so set the ceiling against total
    offered load), the speculative acceptance floor (mean tokens per
    verify window), and the overlap-efficiency floor (device-wall /
    iteration-wall from the zero-bubble decode ledger).

    ``tenant_latency_p99_s``: tenant name -> p99 bound (seconds) —
    one spec per tenant over that tenant's LABELED latency histogram
    (``serving_request_total_seconds{tenant=...}``), so a QoS
    violation is attributable to the tenant whose SLO it broke, not
    smeared into the fleet-wide tail."""
    specs = []
    for t, bound in (tenant_latency_p99_s or {}).items():
        specs.append(SloSpec(
            f"latency_p99[{t}]", "serving_request_total_seconds",
            bound, agg="p99", min_count=min_count,
            labels={"tenant": str(t)},
        ))
    if latency_p99_s is not None:
        specs.append(SloSpec(
            "latency_p99", "serving_request_total_seconds",
            latency_p99_s, agg="p99", min_count=min_count,
        ))
    if ttft_p99_s is not None:
        specs.append(SloSpec(
            "ttft_p99", "serving_request_ttft_seconds", ttft_p99_s,
            agg="p99", min_count=min_count,
        ))
    if error_rate is not None:
        specs.append(SloSpec(
            "error_rate", "serving_scheduler_internal_errors",
            error_rate, agg="rate", per="serving_scheduler_submitted",
            min_count=min_count,
        ))
    if acceptance_rate is not None:
        specs.append(SloSpec(
            "acceptance_rate", "serving_scheduler_spec_tokens",
            acceptance_rate, agg="rate",
            per="serving_scheduler_spec_windows", bound="min",
            min_count=min_count,
        ))
    if overlap_efficiency_min is not None:
        # the zero-bubble floor: cumulative device-wall / iteration-
        # wall from the overlap ledger (gauge is None before the
        # first completed iteration — not judgeable, not a breach)
        specs.append(SloSpec(
            "overlap_efficiency", "serving_overlap_efficiency",
            overlap_efficiency_min, agg="value", bound="min",
        ))
    return specs


def default_training_slos(straggler_ratio=None, commit_interval_p99_s=None,
                          gate_refusal_rate=None, min_count=8) -> list[SloSpec]:
    """The training-tier (PS) spec set: the straggler ratio
    (max/median per-worker commit interval), the fleet-wide commit
    interval p99, and the durability-gate refusal rate (refused /
    commits) — the commit-lag bounds of the DOWNPOUR/AEASGD paths."""
    specs = []
    if straggler_ratio is not None:
        specs.append(SloSpec(
            "straggler", "training_ps_straggler", straggler_ratio,
            agg="value",
        ))
    if commit_interval_p99_s is not None:
        specs.append(SloSpec(
            "commit_interval_p99", "training_ps_commit_interval_seconds",
            commit_interval_p99_s, agg="p99", min_count=min_count,
        ))
    if gate_refusal_rate is not None:
        specs.append(SloSpec(
            "gate_refusals", "training_ps_commits_refused_no_replica",
            gate_refusal_rate, agg="rate", per="training_ps_commits",
            min_count=min_count,
        ))
    return specs
