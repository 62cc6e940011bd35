"""SLO-driven fleet autoscaling + continuous deployment (PyTorch port of
``distkeras_tpu.serving.autoscale``; the policy's decisions equal the JAX
package's on the same signals): the control loop that closes the
sensors → decision → actuators circuit.

Every input and output of this module already exists in-tree; this
file only CONNECTS them:

- **sensors** — each replica's ``health`` reply carries its queue
  occupancy (``batcher.load()``), paged-KV pool pressure
  (``kv_page_util``), the windowed admission-failure rate
  (``pool_exhausted_rate``) and queue-depth slope
  (``queue_depth_trend``) from its own metrics-history ring, and the
  multi-window burn-rate verdict (``burn``: ok / burning / spiking /
  breach). The ``FleetRouter`` polls health anyway; its per-replica
  books (``router.replicas()``) republish these fields, so the
  autoscaler reads everything from one in-process snapshot — no extra
  scrape traffic.
- **decision** — :class:`AutoscalePolicy`, a PURE object: signals in,
  ``scale_up`` / ``scale_down`` / ``hold`` out, with hysteresis
  (separate up/down utilization thresholds plus consecutive-tick
  streaks), per-direction cooldowns, and min/max replica clamps. The
  clock is injectable, so the unit tests drive hysteresis and cooldown
  semantics under a fake clock with zero sleeps.
- **actuators** — ``FleetController.scale_up`` (boot → pre-warm →
  health-gated join: the new replica compiles every decode/prefill
  bucket BEFORE entering rotation, so a scale-up under live traffic
  never compile-storms) and ``FleetController.scale_down`` (drain at
  the router, wait for in-flight work, then remove + graceful stop:
  shrinking never drops a request). Dead replicas are reaped AND
  replaced inside the same decision tick (``reap_dead`` precedes the
  policy, and a fleet below ``min_replicas`` scales up immediately,
  cooldowns notwithstanding).

The same loop closes training → serving: :class:`BundlePublisher`
rides the parameter server's checkpoint-cadence snapshot hook
(``add_snapshot_listener``) and publishes a serving bundle every N
commits (atomic rename, monotonic versions); a
:class:`ContinuousDeployer` watches the publisher and rolls the fleet
to each new bundle with the controller's ``rollover`` state machine.
Deploys run from the autoscaler's own tick — on HOLD ticks only — so
a rollover can never race a scale event: one thread, one actuator at
a time.

Scale events land on the router's flight recorder
(``autoscale.scale_up`` / ``autoscale.scale_down`` / ``autoscale.reap``
/ ``autoscale.deploy``) and in the ``fleet_autoscale_*`` counters; the
``fleet_replicas`` gauge rides the router registry, so the replica
count is a first-class time-series (the ``timeseries`` verb).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field

from distkeras_tpu_torch.obs.timeseries import (
    BURN_BREACH,
    BURN_OK,
    worst_burn,
)

logger = logging.getLogger(__name__)

#: decision actions
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"
HOLD = "hold"


@dataclass
class ReplicaSignals:
    """One replica's autoscale-relevant signal set — the subset of its
    router book (``router.replicas()`` row) the policy consumes.
    Missing signals default to neutral: a replica that reports no
    queue/pool data contributes no pressure."""

    endpoint: tuple
    state: str = "active"
    in_flight: int = 0
    capacity: int | None = None
    queue_depth: int = 0
    queue_capacity: int | None = None
    kv_page_util: float | None = None
    pool_exhausted_rate: float | None = None
    queue_depth_trend: float | None = None
    burn: str | None = None

    def utilization(self) -> float:
        """The replica's scalar load: the WORST of its slot occupancy,
        queue fill, and paged-KV pool fill — whichever resource runs
        out first is the one a scale decision must respect."""
        parts = [0.0]
        if self.capacity:
            parts.append(self.in_flight / self.capacity)
        if self.queue_capacity:
            parts.append(self.queue_depth / self.queue_capacity)
        if self.kv_page_util is not None:
            parts.append(float(self.kv_page_util))
        return max(parts)


def signals_from_router(router) -> list[ReplicaSignals]:
    """Build the policy's input from the router's per-replica books
    (one in-process snapshot; the health fields were populated by the
    router's own poll loop)."""
    out = []
    for row in router.replicas():
        out.append(ReplicaSignals(
            endpoint=tuple(row["endpoint"]),
            state=row["state"],
            in_flight=row.get("in_flight") or 0,
            capacity=row.get("capacity"),
            queue_depth=row.get("queue_depth") or 0,
            queue_capacity=row.get("queue_capacity"),
            kv_page_util=row.get("kv_page_util"),
            pool_exhausted_rate=row.get("pool_exhausted_rate"),
            queue_depth_trend=row.get("queue_depth_trend"),
            burn=row.get("burn"),
        ))
    return out


@dataclass
class AutoscaleDecision:
    """One tick's verdict. ``target`` names the drain victim for
    ``scale_down`` (the least-loaded active replica); ``replicas`` is
    the count the decision was made AT (pre-actuation)."""

    action: str
    reason: str
    replicas: int
    utilization: float = 0.0
    burn: str = BURN_OK
    target: tuple | None = None
    signals: list = field(default_factory=list, repr=False)


class AutoscalePolicy:
    """Pure scale-decision state machine. ``decide(signals)`` maps the
    fleet's per-replica signals to scale_up / scale_down / hold.

    The decision table (first matching row wins):

    1. ``replicas < min_replicas`` → **scale_up** (``below_min``) —
       bypasses hysteresis AND cooldowns: replacing dead capacity is
       not growth, and must not wait out a cooldown armed by it.
    2. ``replicas > max_replicas`` → **scale_down** (``above_max``) —
       a clamp, applied one replica per tick.
    3. any replica's burn verdict is ``breach`` → **scale_up**
       (``slo_breach``) on THIS tick (no streak required — breach is
       the page-now condition), still subject to ``up_cooldown`` and
       the max clamp.
    4. sustained pressure — fleet-mean utilization >=
       ``up_threshold``, or any replica's ``pool_exhausted_rate`` >
       ``exhaustion_rate``, or a non-ok burn verdict — for
       ``up_ticks`` consecutive decisions → **scale_up**
       (``pressure``), subject to ``up_cooldown`` / max.
    5. sustained idleness — fleet-mean utilization <=
       ``down_threshold`` AND every burn verdict ok AND no exhaustion
       AND no rising queue trend (> ``trend_slope`` req/s of growth)
       — for ``down_ticks`` consecutive decisions → **scale_down**
       (``idle``) of the least-loaded active replica, subject to
       ``down_cooldown`` (measured from the last scale event in
       EITHER direction: never shrink right after growing) / min.
    6. otherwise **hold**.

    Hysteresis is the ``up_threshold`` > ``down_threshold`` gap plus
    the consecutive-tick streaks: a load oscillating across one
    boundary can arm at most one direction, so the policy cannot flap.
    ``clock`` is injectable (``time.monotonic`` signature) — the unit
    tests drive cooldowns with a fake clock."""

    def __init__(self, *, min_replicas=1, max_replicas=4,
                 up_threshold=0.75, down_threshold=0.25,
                 up_ticks=2, down_ticks=5,
                 up_cooldown=10.0, down_cooldown=60.0,
                 exhaustion_rate=0.0, trend_slope=0.0,
                 clock=time.monotonic):
        if not 1 <= int(min_replicas) <= int(max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas; got "
                f"{min_replicas}..{max_replicas}"
            )
        if not 0.0 <= down_threshold < up_threshold:
            raise ValueError(
                "need 0 <= down_threshold < up_threshold (the "
                f"hysteresis gap); got {down_threshold}/{up_threshold}"
            )
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_threshold = float(up_threshold)
        self.down_threshold = float(down_threshold)
        self.up_ticks = max(1, int(up_ticks))
        self.down_ticks = max(1, int(down_ticks))
        self.up_cooldown = float(up_cooldown)
        self.down_cooldown = float(down_cooldown)
        self.exhaustion_rate = float(exhaustion_rate)
        self.trend_slope = float(trend_slope)
        self._clock = clock
        self._up_streak = 0
        self._down_streak = 0
        self._last_up = -float("inf")
        self._last_down = -float("inf")

    # -- internals ----------------------------------------------------------

    def _counted(self, signals):
        """Replicas that count toward fleet size: everything not
        DRAINING (a draining replica is already on its way out)."""
        return [s for s in signals if s.state != "draining"]

    @staticmethod
    def _serving(signals):
        """Replicas whose load data is meaningful (in rotation or
        joining; an ejected replica serves nothing)."""
        return [s for s in signals if s.state in ("active", "joining")]

    def _least_loaded(self, signals):
        serving = self._serving(signals) or signals
        return min(
            serving, key=lambda s: (s.utilization(), s.endpoint)
        ).endpoint

    # -- the decision -------------------------------------------------------

    def decide(self, signals: list[ReplicaSignals]) -> AutoscaleDecision:
        now = self._clock()
        counted = self._counted(signals)
        n = len(counted)
        serving = self._serving(counted)
        util = (
            sum(s.utilization() for s in serving) / len(serving)
            if serving else 0.0
        )
        burn = worst_burn(s.burn for s in counted)
        exhausted = any(
            (s.pool_exhausted_rate or 0.0) > self.exhaustion_rate
            for s in serving
        )
        rising = any(
            (s.queue_depth_trend or 0.0) > self.trend_slope
            for s in serving
        )

        def verdict(action, reason, target=None):
            return AutoscaleDecision(
                action=action, reason=reason, replicas=n,
                utilization=round(util, 4), burn=burn, target=target,
                signals=signals,
            )

        # 1/2: the clamps — replacement of dead capacity and the
        # max bound apply before any hysteresis or cooldown
        if n < self.min_replicas:
            self._up_streak = self._down_streak = 0
            return verdict(SCALE_UP, "below_min")
        if n > self.max_replicas:
            self._up_streak = self._down_streak = 0
            return verdict(
                SCALE_DOWN, "above_max",
                target=self._least_loaded(counted),
            )

        pressure = (
            util >= self.up_threshold
            or exhausted
            or burn != BURN_OK
        )
        idle = (
            util <= self.down_threshold
            and burn == BURN_OK
            and not exhausted
            and not rising
        )
        self._up_streak = self._up_streak + 1 if pressure else 0
        self._down_streak = self._down_streak + 1 if idle else 0

        up_ready = now - self._last_up >= self.up_cooldown
        down_ready = (
            now - self._last_up >= self.down_cooldown
            and now - self._last_down >= self.down_cooldown
        )

        # 3: breach pages NOW — no streak, but cooldown + max still
        # bound it (one breach must not instantly max the fleet while
        # the capacity it already bought is still warming)
        if burn == BURN_BREACH:
            if n >= self.max_replicas:
                return verdict(HOLD, "at_max")
            if not up_ready:
                return verdict(HOLD, "up_cooldown")
            self._last_up = now
            self._up_streak = 0
            return verdict(SCALE_UP, "slo_breach")

        # 4: sustained pressure
        if pressure and self._up_streak >= self.up_ticks:
            if n >= self.max_replicas:
                return verdict(HOLD, "at_max")
            if not up_ready:
                return verdict(HOLD, "up_cooldown")
            self._last_up = now
            self._up_streak = 0
            detail = (
                "pool_exhausted" if exhausted
                else f"burn_{burn}" if burn != BURN_OK
                else "utilization"
            )
            return verdict(SCALE_UP, f"pressure:{detail}")

        # 5: sustained idleness
        if idle and self._down_streak >= self.down_ticks:
            if n <= self.min_replicas:
                return verdict(HOLD, "at_min")
            if not down_ready:
                return verdict(HOLD, "down_cooldown")
            self._last_down = now
            self._down_streak = 0
            return verdict(
                SCALE_DOWN, "idle", target=self._least_loaded(counted)
            )

        return verdict(HOLD, "steady")


class Autoscaler:
    """Cadence-guarded decision loop binding an :class:`AutoscalePolicy`
    to a ``FleetController``. Each tick, in order:

    1. ``controller.reap_dead()`` — a kill -9'd replica leaves the
       books HERE, so the policy's ``below_min`` row replaces it in
       the SAME tick (the reap/scale-up race the regression test
       pins);
    2. ``policy.decide`` over the router's per-replica signal books;
    3. actuate: ``scale_up`` (boot → pre-warm → health-gated join) or
       ``scale_down`` (drain → remove → graceful stop), recording the
       event on the router's flight recorder and the
       ``fleet_autoscale_*`` counters;
    4. on HOLD ticks only: ``deployer.maybe_deploy()`` — continuous
       deployment shares the thread, so a rollover never races a
       scale event.

    Drive it either way: ``start()`` runs the loop on its own thread
    (the router's ``_health_loop`` pattern: ``interval`` between
    ticks, prompt shutdown), or call ``maybe_tick()`` from any
    existing cadence (it no-ops until ``interval`` has elapsed — the
    ``maybe_snap`` idiom) or ``tick()`` directly for deterministic
    tests and benches. Actuation failures are counted and recorded,
    never raised out of the loop."""

    def __init__(self, controller, policy=None, interval=1.0, *,
                 deployer=None, clock=time.monotonic):
        self.controller = controller
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.interval = float(interval)
        self.deployer = deployer
        self._clock = clock
        self._last_tick = -float("inf")
        self._counters = None
        self._stopping = threading.Event()
        self._thread = None
        self.ticks = 0
        self.last_decision: AutoscaleDecision | None = None
        self.last_deploy: dict | None = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._loop, name="dkt-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def shutdown(self):
        self._stopping.set()
        th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout=30.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    def _loop(self):
        while not self._stopping.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("autoscaler tick failed")
            self._stopping.wait(self.interval)

    # -- the tick -----------------------------------------------------------

    def _bind(self, router):
        if self._counters is None:
            self._counters = router.registry.group(
                "fleet_autoscale",
                ("ticks", "scale_ups", "scale_downs", "holds",
                 "reaps", "deploys", "errors"),
            )

    def maybe_tick(self):
        """Tick if ``interval`` has elapsed since the last one (the
        cadence guard — callable from any existing loop at any rate);
        returns the decision, or None when it was not yet time."""
        now = self._clock()
        if now - self._last_tick < self.interval:
            return None
        self._last_tick = now
        return self.tick()

    def tick(self) -> AutoscaleDecision:
        """One full decision cycle: reap, decide, actuate, deploy."""
        ctl = self.controller
        router = ctl.router
        if router is None:
            raise RuntimeError("controller not started")
        self._bind(router)
        self._counters.inc("ticks")
        for dead in ctl.reap_dead():
            self._counters.inc("reaps")
            router.recorder.record(
                "autoscale.reap", endpoint=list(dead.endpoint),
                replicas=len(ctl.replicas),
            )
        decision = self.policy.decide(signals_from_router(router))
        if decision.action == SCALE_UP:
            try:
                added = ctl.scale_up()
                self._counters.inc("scale_ups")
                router.recorder.record(
                    "autoscale.scale_up", reason=decision.reason,
                    endpoint=list(added[0].endpoint),
                    replicas=len(ctl.replicas),
                )
            except Exception as e:  # noqa: BLE001 — counted, not fatal
                self._counters.inc("errors")
                router.recorder.record(
                    "autoscale.error", op=SCALE_UP, error=repr(e)
                )
                logger.exception("autoscale scale-up failed")
        elif decision.action == SCALE_DOWN:
            try:
                ctl.scale_down(endpoint=decision.target)
                self._counters.inc("scale_downs")
                router.recorder.record(
                    "autoscale.scale_down", reason=decision.reason,
                    endpoint=list(decision.target),
                    replicas=len(ctl.replicas),
                )
            except Exception as e:  # noqa: BLE001 — counted, not fatal
                self._counters.inc("errors")
                router.recorder.record(
                    "autoscale.error", op=SCALE_DOWN, error=repr(e)
                )
                logger.exception("autoscale scale-down failed")
        else:
            self._counters.inc("holds")
            if self.deployer is not None:
                try:
                    out = self.deployer.maybe_deploy()
                    if out is not None:
                        self._counters.inc("deploys")
                        router.recorder.record(
                            "autoscale.deploy",
                            version=out["version"],
                            replaced=len(out["ledger"]["replaced"]),
                        )
                        self.last_deploy = out
                except Exception as e:  # noqa: BLE001 — counted
                    self._counters.inc("errors")
                    router.recorder.record(
                        "autoscale.error", op="deploy", error=repr(e)
                    )
                    logger.exception("continuous deploy failed")
        self.ticks += 1
        self.last_decision = decision
        return decision


# ------------------------------------------------- continuous deployment


class BundlePublisher:
    """Checkpoint-cadence bundle publication off the parameter server:
    every ``every`` commits (the PS's ``add_snapshot_listener``
    cadence — the snapshot copy is taken INSIDE the commit's locked
    section, so the bundle labelled version N really is the N-update
    center), ``build(params, meta, path)`` writes a serving bundle to
    a temp path which is atomically renamed into
    ``<out_dir>/bundle_v<N>.dkt`` — a reader never sees a half-written
    bundle, and versions are monotonic because ``num_updates`` is.

    ``build`` owns the model-shape knowledge the PS deliberately lacks
    (typically: set the pulled center into a model skeleton, quantize,
    ``save_serving_bundle``). A failing build is logged and counted
    (``publish_errors``) but never surfaces into the committing
    worker — the publisher is an observability-tier consumer of the
    training path, not a participant in it."""

    def __init__(self, ps, build, out_dir, every=1):
        self._ps = ps
        self._build = build
        self.out_dir = out_dir
        self.every = max(1, int(every))
        self._lock = threading.Lock()
        self._latest = None  # {"version": n, "path": str}
        self.published = 0
        self.publish_errors = 0
        os.makedirs(out_dir, exist_ok=True)
        ps.add_snapshot_listener(self._on_snapshot, every=self.every)

    def _on_snapshot(self, n, center, meta, worker_snaps):
        path = os.path.join(self.out_dir, f"bundle_v{n:08d}.dkt")
        tmp = path + ".tmp"
        try:
            self._build(center, meta, tmp)
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001 — observability boundary
            self.publish_errors += 1
            logger.exception("bundle publish at update %d failed", n)
            try:
                os.remove(tmp)
            except OSError:
                pass
            return
        with self._lock:
            self._latest = {"version": int(n), "path": path}
            self.published += 1

    def latest(self) -> dict | None:
        """The newest published bundle as ``{"version", "path"}``
        (None before the first publish)."""
        with self._lock:
            return None if self._latest is None else dict(self._latest)

    def close(self):
        self._ps.remove_snapshot_listener(self._on_snapshot)


class ContinuousDeployer:
    """Rolls the fleet to each NEW bundle the publisher emits, via the
    controller's ``rollover`` state machine (one replica at a time,
    no request dropped or duplicated). ``maybe_deploy`` is the only
    entry point and is cheap when there is nothing new — the
    :class:`Autoscaler` calls it on hold ticks, which also serializes
    deploys against scale events.

    The baseline is the newest version already published when the
    deployer attaches (the fleet presumably booted from it); only
    bundles published AFTER that roll."""

    def __init__(self, controller, publisher, timeout=120.0):
        self.controller = controller
        self.publisher = publisher
        self.timeout = float(timeout)
        latest = publisher.latest()
        self._deployed = None if latest is None else latest["version"]
        self.deploys = 0

    def maybe_deploy(self) -> dict | None:
        """Roll to the newest bundle if it is newer than what the
        fleet runs; returns ``{"version", "path", "ledger"}`` for a
        deploy, None when already current."""
        latest = self.publisher.latest()
        if latest is None or latest["version"] == self._deployed:
            return None
        ledger = self.controller.rollover(
            bundle=latest["path"], timeout=self.timeout
        )
        self._deployed = latest["version"]
        self.deploys += 1
        return {**latest, "ledger": ledger}
