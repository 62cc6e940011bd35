"""Windowed performance time-series over the typed-metrics registries
(PyTorch port: a copy of ``distkeras_tpu.obs.timeseries``).

Every registry signal is instantaneous: the ``metrics`` verb ships
point-in-time scrape values, and an SLO verdict grades one evaluation
window. A control loop (an autoscaler) or an operator
asking "is this replica getting WORSE" needs the dimension the scrape
throws away — time. :class:`MetricsHistory` is the sensor layer: a
bounded ring of periodic registry snapshots answering windowed
queries, all pure host arithmetic over samples that were already
being collected.

- :meth:`MetricsHistory.rate` — per-second counter rate over a
  window, RESET-AWARE: a counter that went backwards mid-window (a
  supervisor-restarted scheduler's ``fresh=True`` group starts at
  zero) contributes its post-reset total instead of a negative delta
  (the Prometheus ``increase()`` convention), so a restart can never
  produce a negative rate.
- :meth:`MetricsHistory.quantile_over` — a histogram quantile over
  ONLY the window's observations (bucket-wise increase between the
  window's edge snapshots), vs the lifetime quantile a raw sample
  gives. A latency regression five minutes old stops haunting the
  p99 an autoscaler acts on.
- :meth:`MetricsHistory.ewma` / :meth:`MetricsHistory.trend` —
  exponentially-weighted smoothing and a least-squares slope over the
  window's series: the "rising or falling, and how fast" primitives.
- :meth:`MetricsHistory.burn` — multi-window BURN-RATE evaluation of
  the existing ``SloSpec`` list (fast 1m / slow 10m, the SRE
  discipline): each spec reduces over both windows, burn = measured /
  threshold (threshold / measured for ``bound="min"`` floors), and
  the verdict distinguishes *spiking now* (fast window only — may be
  a transient), *slowly burning* (slow window only — budget eroding
  though the last minute recovered), and *breach* (both — sustained
  AND current, the page-now condition).
- :meth:`MetricsHistory.digest` — the ``timeseries`` DKT1 verb's
  payload: one row per registered series with windowed rate/value/
  quantiles, trend, and a fixed-length resampled ``points`` list
  (sparkline-ready; ``tools/dkt_top.py`` renders it).

Snapshot cadence: ``maybe_snap()`` is cadence-guarded exactly like
``SloEvaluator.maybe_evaluate`` — the engine calls it from the
supervisor thread's poll loop, the fleet router from its health
sweep, so no new thread exists anywhere. Between snaps it costs one
float compare. Defaults (1 s interval x 600 snapshots) hold ten
minutes of history — precisely the slow burn window.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque

from distkeras_tpu_torch.obs.slo import OK, SloSpec  # noqa: F401 (re-export)

#: burn-rate verdicts, in increasing severity. ``spiking`` outranks
#: ``burning``: the fast window measures what users feel RIGHT NOW.
BURN_OK, BURN_BURNING, BURN_SPIKING, BURN_BREACH = (
    "ok", "burning", "spiking", "breach"
)
_BURN_SEVERITY = {BURN_OK: 0, BURN_BURNING: 1, BURN_SPIKING: 2,
                  BURN_BREACH: 3}


def worst_burn(verdicts) -> str:
    """The most severe verdict in ``verdicts`` — the fleet-level
    reduction an autoscale policy runs over its replicas' burn
    states. ``None`` entries (a replica with no SLOs or no history
    configured) are neutral, as is anything unrecognized: absence of
    evidence never scales a fleet."""
    worst = BURN_OK
    for v in verdicts:
        if v is not None and _BURN_SEVERITY.get(v, 0) > _BURN_SEVERITY[worst]:
            worst = v
    return worst

#: the SRE-practice default windows (seconds): fast = 1 minute
#: ("spiking now"), slow = 10 minutes ("slowly burning").
FAST_WINDOW, SLOW_WINDOW = 60.0, 600.0


def _label_key(labels) -> tuple:
    return tuple(sorted(
        (str(k), str(v)) for k, v in (labels or {}).items()
    ))


class MetricsHistory:
    """Bounded ring of periodic ``MetricsRegistry`` snapshots plus the
    windowed queries over them. ``snapshot_fn`` is any callable
    returning a ``snapshot()``-shaped sample list (the engine passes
    ``metrics_snapshot``, the router ``registry.snapshot``).

    ``clock`` is injectable (``time.monotonic`` by default) so the
    edge-case tests drive resets, stale windows, and burn verdicts
    under a frozen fake clock instead of sleeping."""

    def __init__(self, snapshot_fn, interval: float = 1.0,
                 capacity: int = 600, clock=time.monotonic):
        self._snapshot_fn = snapshot_fn
        self.interval = float(interval)
        if self.interval <= 0:
            raise ValueError(f"interval must be > 0; got {interval}")
        self.capacity = int(capacity)
        if self.capacity < 2:
            raise ValueError(
                f"capacity must be >= 2 (a window needs two edges); "
                f"got {capacity}"
            )
        self._clock = clock
        # ring entries: (t, {name: [sample, ...]}) — samples grouped
        # by name in arrival order, the same index evaluate_slos builds
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._last_snap = -math.inf
        self.snaps_total = 0

    # -- collection ---------------------------------------------------------

    def snap(self) -> None:
        """Take one snapshot now (forced). A failing snapshot callable
        must never crash its host thread (the supervisor loop is also
        the watchdog) — the tick is skipped and retried next cadence."""
        now = self._clock()
        try:
            samples = self._snapshot_fn()
        except Exception:  # noqa: BLE001 — observability boundary
            return
        by_name: dict = {}
        for s in samples:
            by_name.setdefault(s["name"], []).append(s)
        with self._lock:
            self._ring.append((now, by_name))
            self._last_snap = now
            self.snaps_total += 1

    def maybe_snap(self) -> bool:
        """Snapshot at most once per ``interval`` (one float compare
        between ticks — safe to call from any poll loop)."""
        if self._clock() - self._last_snap >= self.interval:
            self.snap()
            return True
        return False

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- window selection ---------------------------------------------------

    def _window(self, window: float) -> list:
        """Ring entries inside the last ``window`` seconds, oldest
        first. A window wider than the ring's span simply returns the
        whole ring (the honest answer: everything we still know); an
        empty ring or a ring whose NEWEST entry is already older than
        the window returns [] — the queries answer None rather than
        report stale data as current."""
        now = self._clock()
        lo = now - float(window)
        with self._lock:
            entries = list(self._ring)
        if not entries or entries[-1][0] < lo:
            return []
        return [e for e in entries if e[0] >= lo]

    @staticmethod
    def _pick(by_name: dict, name: str, labels: dict | None):
        """The sample a query reads from one snapshot: first sample
        under ``name`` whose labels CONTAIN ``labels`` (None/empty =
        the first sample, mirroring the SLO evaluator)."""
        want = labels or {}
        for s in by_name.get(name, ()):
            have = s.get("labels") or {}
            if all(have.get(k) == v for k, v in want.items()):
                return s
        return None

    def series(self, name: str, window: float,
               labels: dict | None = None) -> list:
        """``[(t, value), ...]`` of the sample's scalar value over the
        window (counters and gauges; histogram samples yield their
        observation ``count``). Points where the series is missing or
        the value is None are skipped."""
        out = []
        for t, by_name in self._window(window):
            s = self._pick(by_name, name, labels)
            if s is None:
                continue
            v = s.get("value") if "value" in s else s.get("count")
            if v is None:
                continue
            out.append((t, float(v)))
        return out

    # -- windowed reductions ------------------------------------------------

    @staticmethod
    def _increase(points) -> float | None:
        """Reset-aware monotonic increase over ``[(t, v), ...]``: sum
        of consecutive deltas, where a NEGATIVE delta (counter reset —
        a rebuilt scheduler generation starts its ``fresh`` counters
        at zero) contributes the post-reset value instead (the counter
        counted at least that much since the reset). Never negative."""
        if len(points) < 2:
            return None
        inc = 0.0
        for (_, a), (_, b) in zip(points, points[1:]):
            inc += (b - a) if b >= a else b
        return max(0.0, inc)

    def increase(self, name: str, window: float,
                 labels: dict | None = None) -> float | None:
        return self._increase(self.series(name, window, labels))

    def rate(self, name: str, window: float,
             labels: dict | None = None) -> float | None:
        """Per-second counter rate over the window (increase /
        elapsed). None when the window holds fewer than two
        snapshots — an empty or stale window is "unknown", never 0."""
        points = self.series(name, window, labels)
        inc = self._increase(points)
        if inc is None:
            return None
        dt = points[-1][0] - points[0][0]
        if dt <= 0:
            return None
        return inc / dt

    def mean_over(self, name: str, window: float,
                  labels: dict | None = None) -> float | None:
        """Windowed mean of a gauge's sampled values."""
        points = self.series(name, window, labels)
        if not points:
            return None
        return sum(v for _, v in points) / len(points)

    def _hist_window(self, name, window, labels):
        """Bucket-wise increase of a histogram over the window:
        ``(delta_buckets, delta_count, delta_sum)`` where buckets are
        ``[le, cumulative_delta]`` rows. Reset-aware: any bucket
        running backwards means the histogram was rebuilt mid-window,
        and the LAST snapshot alone (everything since the reset) is
        the window's honest content. A window holding a SINGLE
        snapshot answers None, like ``rate``: one edge cannot bound an
        increase, and returning the lifetime distribution would report
        an hours-old spike as the window's content (the staleness a
        query-cadenced ring — a standby PS, a predict-only engine —
        would otherwise serve)."""
        entries = self._window(window)
        first = last = None
        for _, by_name in entries:
            s = self._pick(by_name, name, labels)
            if s is None or "buckets" not in s:
                continue
            if first is None:
                first = s
            last = s
        return self._hist_delta(first, last)

    @staticmethod
    def _hist_delta(first, last):
        """The bucket-wise increase between a window's edge histogram
        samples (the reduction behind ``_hist_window``, factored so
        ``digest``'s one-pass collection shares it). None when the
        window holds fewer than two samples."""
        if last is None or first is last or first is None:
            return None
        old = {
            str(le): float(c) for le, c in first.get("buckets", ())
        }
        delta, reset = [], False
        for le, c in last["buckets"]:
            d = float(c) - old.get(str(le), 0.0)
            if d < 0:
                reset = True
                break
            delta.append([le, d])
        if reset:
            delta = [[le, float(c)] for le, c in last["buckets"]]
            return delta, int(last.get("count", 0)), float(
                last.get("sum", 0.0)
            )
        count = int(last.get("count", 0)) - int(first.get("count", 0))
        total = float(last.get("sum", 0.0)) - float(
            first.get("sum", 0.0)
        )
        if count < 0:
            count, total = int(last.get("count", 0)), float(
                last.get("sum", 0.0)
            )
        return delta, count, total

    def quantile_over(self, name: str, window: float, q: float,
                      labels: dict | None = None) -> float | None:
        """Bucket-resolution quantile over ONLY the window's
        observations (the windowed sibling of ``Histogram.quantile``).
        None when the window saw no observations."""
        return self._quantile_from_delta(
            self._hist_window(name, window, labels), q
        )

    @staticmethod
    def _quantile_from_delta(hw, q: float) -> float | None:
        """Quantile out of a ``_hist_delta`` result (shared by
        ``quantile_over`` and ``digest``'s one-pass rows)."""
        if hw is None:
            return None
        delta, count, _ = hw
        if count < 1:
            return None
        target = max(1, int(q * count))
        last_finite = None
        for le, cum in delta:
            if le != "+Inf":
                last_finite = float(le)
            if cum >= target:
                return last_finite
        return last_finite

    def hist_stats(self, name: str, window: float,
                   labels: dict | None = None) -> dict | None:
        """Windowed histogram digest: observation count, per-second
        observation rate, mean, p50, p99."""
        hw = self._hist_window(name, window, labels)
        if hw is None:
            return None
        delta, count, total = hw
        points = self.series(name, window, labels)
        dt = points[-1][0] - points[0][0] if len(points) >= 2 else 0.0
        return {
            "count": count,
            "rate": round(count / dt, 4) if dt > 0 else None,
            "mean": round(total / count, 6) if count else None,
            "p50": self.quantile_over(name, window, 0.5, labels),
            "p99": self.quantile_over(name, window, 0.99, labels),
        }

    # -- smoothing / trend --------------------------------------------------

    @staticmethod
    def _ewma(points, halflife: float) -> float | None:
        """EWMA of ``[(t, v), ...]`` with a time-aware decay (irregular
        snapshot spacing decays by real elapsed time, not sample
        count)."""
        if not points:
            return None
        ew = points[0][1]
        for (t0, _), (t1, v) in zip(points, points[1:]):
            a = 1.0 - 0.5 ** (max(0.0, t1 - t0) / max(halflife, 1e-9))
            ew = ew + a * (v - ew)
        return ew

    def ewma(self, name: str, window: float,
             halflife: float | None = None,
             labels: dict | None = None) -> float | None:
        """EWMA-smoothed latest value of a gauge series (halflife
        defaults to window/10 — recent-minute-weighted)."""
        hl = halflife if halflife is not None else float(window) / 10.0
        return self._ewma(self.series(name, window, labels), hl)

    @staticmethod
    def _slope(points) -> float | None:
        """Least-squares slope (units/second) over ``[(t, v), ...]`` —
        the trend direction dkt_top renders as an arrow and a control
        loop compares against zero."""
        if len(points) < 2:
            return None
        t0 = points[0][0]
        xs = [t - t0 for t, _ in points]
        ys = [v for _, v in points]
        n = len(points)
        mx, my = sum(xs) / n, sum(ys) / n
        den = sum((x - mx) ** 2 for x in xs)
        if den <= 0:
            return None
        return sum(
            (x - mx) * (y - my) for x, y in zip(xs, ys)
        ) / den

    def trend(self, name: str, window: float,
              labels: dict | None = None) -> float | None:
        """Slope of the series over the window (per second). For
        counters, call on the rate points via ``digest`` instead —
        a lifetime counter's raw slope IS its rate."""
        return self._slope(self.series(name, window, labels))

    # -- burn-rate SLO evaluation -------------------------------------------

    def _reduce_windowed(self, spec: SloSpec, window: float):
        """Reduce one spec's series over ``window``: ``(value, count)``
        with value None = not judgeable, mirroring
        ``slo._reduce`` but windowed — ``rate`` aggs become the ratio
        of windowed INCREASES (errors this window / submissions this
        window), quantile/mean aggs read only the window's
        observations, and ``value`` aggs take the windowed mean."""
        if spec.agg == "value":
            v = self.mean_over(spec.series, window, spec.labels)
            return v, (1 if v is not None else 0)
        if spec.agg in ("p50", "p99"):
            q = 0.5 if spec.agg == "p50" else 0.99
            hw = self._hist_window(spec.series, window, spec.labels)
            if hw is None:
                return None, 0
            _, count, _ = hw
            return (
                self.quantile_over(spec.series, window, q, spec.labels),
                count,
            )
        if spec.agg == "mean":
            hw = self._hist_window(spec.series, window, spec.labels)
            if hw is None:
                return None, 0
            _, count, total = hw
            if not count:
                return None, 0
            return total / count, count
        # rate: windowed numerator increase / windowed denominator
        # increase — both sides reset-aware
        num = self.increase(spec.series, window, spec.labels)
        den = self.increase(spec.per, window, spec.labels)
        if num is None or not den:
            return None, 0
        return num / den, int(den)

    @staticmethod
    def _burn_of(spec: SloSpec, value) -> float | None:
        """Burn rate = how fast the spec's budget is being consumed:
        1.0 means exactly at threshold. ``bound="max"``: measured /
        threshold; ``bound="min"`` (floors): threshold / measured —
        a measured value at half the floor burns at 2x either way."""
        if value is None:
            return None
        if spec.bound == "max":
            if spec.threshold <= 0:
                return math.inf if value > 0 else 0.0
            return value / spec.threshold
        if value <= 0:
            return math.inf if spec.threshold > 0 else 0.0
        return spec.threshold / value

    def burn(self, specs, fast: float = FAST_WINDOW,
             slow: float = SLOW_WINDOW) -> dict:
        """Multi-window burn-rate verdict over ``specs`` (the SAME
        ``SloSpec`` list the point-in-time evaluator grades). Per
        spec: ``breach`` when BOTH windows burn >= 1 (sustained and
        current — page now), ``spiking`` when only the fast window
        does (happening right now; may be a transient), ``burning``
        when only the slow window does (the budget is eroding though
        the last minute looks fine), ``ok`` otherwise. Windows with
        too little data (under ``min_count``, or no snapshots) never
        judge — unknown is not violated."""
        rows, violations = [], []
        worst = BURN_OK
        for spec in specs:
            fv, fc = self._reduce_windowed(spec, fast)
            sv, sc = self._reduce_windowed(spec, slow)
            fb = (
                self._burn_of(spec, fv)
                if fc >= spec.min_count else None
            )
            sb = (
                self._burn_of(spec, sv)
                if sc >= spec.min_count else None
            )
            f_hot = fb is not None and fb >= 1.0
            s_hot = sb is not None and sb >= 1.0
            if f_hot and s_hot:
                verdict = BURN_BREACH
            elif f_hot:
                verdict = BURN_SPIKING
            elif s_hot:
                verdict = BURN_BURNING
            else:
                verdict = BURN_OK

            def _r(x):
                if x is None:
                    return None
                return round(x, 4) if math.isfinite(x) else "inf"

            row = {
                "name": spec.name,
                "series": spec.series,
                "agg": spec.agg,
                "threshold": spec.threshold,
                "fast_value": _r(fv),
                "slow_value": _r(sv),
                "fast_burn": _r(fb),
                "slow_burn": _r(sb),
                "verdict": verdict,
            }
            if spec.labels:
                row["labels"] = dict(spec.labels)
            rows.append(row)
            if verdict != BURN_OK:
                violations.append({
                    k: row[k] for k in
                    ("name", "series", "fast_burn", "slow_burn",
                     "verdict")
                })
            if _BURN_SEVERITY[verdict] > _BURN_SEVERITY[worst]:
                worst = verdict
        return {
            "burn": worst,
            "windows": {"fast": float(fast), "slow": float(slow)},
            "violations": violations,
            "specs": rows,
        }

    # -- the timeseries-verb digest -----------------------------------------

    def _resample(self, points, window: float, nbuckets: int,
                  counter: bool) -> list:
        """Fixed-length resample of a series for sparklines: the
        window splits into ``nbuckets`` equal time buckets; counters
        yield each bucket's per-second increase (reset-aware), gauges
        the bucket mean (empty buckets carry None)."""
        if not points or nbuckets < 1:
            return []
        now = self._clock()
        lo = now - float(window)
        width = float(window) / nbuckets
        buckets: list[list] = [[] for _ in range(nbuckets)]
        for t, v in points:
            i = min(nbuckets - 1, max(0, int((t - lo) / width)))
            buckets[i].append((t, v))
        out = []
        prev_last = None
        for b in buckets:
            if not b:
                out.append(None)
                continue
            if counter:
                pts = ([prev_last] if prev_last is not None else []) + b
                inc = self._increase(pts)
                dt = pts[-1][0] - pts[0][0]
                out.append(
                    round(inc / dt, 4)
                    if inc is not None and dt > 0 else None
                )
            else:
                out.append(round(sum(v for _, v in b) / len(b), 4))
            prev_last = b[-1]
        return out

    def digest(self, window: float = FAST_WINDOW, names=None,
               points: int = 30) -> dict:
        """The ``timeseries`` verb's payload: one row per registered
        series with its windowed reduction, trend, and sparkline
        points. ``names``: optional iterable restricting which series
        are reported (a dashboard polling one panel must not pay for
        the whole registry). ONE pass over the window builds every
        series' point list (and histograms' edge samples) — the
        per-row query methods would each re-copy the ring, turning a
        72-row digest into hundreds of ring walks on the conn
        thread."""
        entries = self._window(window)
        want = None if names is None else set(names)
        # (name, label_key) -> collected state, insertion-ordered
        col: dict = {}
        for t, by_name in entries:
            for name, samples in by_name.items():
                if want is not None and name not in want:
                    continue
                for s in samples:
                    key = (name, _label_key(s.get("labels")))
                    st = col.get(key)
                    if st is None:
                        st = col[key] = {
                            "sample": s, "pts": [],
                            "hfirst": None, "hlast": None,
                        }
                    v = s.get("value") if "value" in s else s.get(
                        "count"
                    )
                    if v is not None:
                        st["pts"].append((t, float(v)))
                    if "buckets" in s:
                        if st["hfirst"] is None:
                            st["hfirst"] = s
                        st["hlast"] = s
        rows = [
            self._digest_row(st, window, points)
            for st in col.values()
        ]
        return {
            "window": float(window),
            "interval": self.interval,
            "snapshots": len(entries),
            "points": int(points),
            "series": rows,
        }

    def _digest_row(self, st, window, npoints) -> dict:
        sample = st["sample"]
        name = sample["name"]
        labels = dict(sample.get("labels") or {})
        kind = sample["kind"]
        row = {"name": name, "labels": labels, "kind": kind}
        pts = st["pts"]
        if kind == "counter":
            inc = self._increase(pts)
            dt = pts[-1][0] - pts[0][0] if len(pts) >= 2 else 0.0
            row["rate"] = (
                inc / dt if inc is not None and dt > 0 else None
            )
            row["increase"] = inc
            rp = self._resample(pts, window, npoints, counter=True)
            row["points"] = rp
            row["trend"] = self._slope([
                (i, v) for i, v in enumerate(rp) if v is not None
            ])
        elif kind == "gauge":
            row["value"] = pts[-1][1] if pts else None
            row["mean"] = (
                sum(v for _, v in pts) / len(pts) if pts else None
            )
            row["ewma"] = self._ewma(pts, float(window) / 10.0)
            row["trend"] = self._slope(pts)
            row["points"] = self._resample(
                pts, window, npoints, counter=False
            )
        else:  # histogram
            hw = self._hist_delta(st["hfirst"], st["hlast"])
            if hw is not None:
                _, count, total = hw
                dt = (
                    pts[-1][0] - pts[0][0] if len(pts) >= 2 else 0.0
                )
                row.update({
                    "count": count,
                    "rate": round(count / dt, 4) if dt > 0 else None,
                    "mean": (
                        round(total / count, 6) if count else None
                    ),
                    "p50": self._quantile_from_delta(hw, 0.5),
                    "p99": self._quantile_from_delta(hw, 0.99),
                })
            rp = self._resample(pts, window, npoints, counter=True)
            row["points"] = rp  # per-second observation rate
            row["trend"] = self._slope([
                (i, v) for i, v in enumerate(rp) if v is not None
            ])
        if row.get("trend") is not None:
            row["trend"] = round(row["trend"], 6)
        for k in ("rate", "increase", "value", "mean", "ewma"):
            if row.get(k) is not None:
                row[k] = round(float(row[k]), 6)
        return row
