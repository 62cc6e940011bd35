#!/usr/bin/env python
"""Chaos soak for the PyTorch port's serving FLEET (the port's twin of
``tools/soak_fleet.py``: the same topology, seams, pacing and bars, on
the port's router, controller, autoscaler, publisher and engines).

Replicas are subprocesses of this script. They serve on the card unless
``--cpu`` is given (``device="cpu"`` in the Python API), with the fused
LayerNorm hook (the B7 kernel) on their engines; the parent builds every
kernel into the checkout's build cache before the first boot, and a
replica only loads them (it refuses to start if a library is missing).
Without a card and without ``--cpu`` it exits non-zero. With
``DKT_LAUNCH_COUNTS_DIR`` set, every replica that exits normally writes
its kernel launch counts there.

What follows is the JAX tool's description, which holds unchanged.

Chaos soak for the serving FLEET: N clients against a router over
real replica SUBPROCESSES, one of which is kill -9'd mid-stream, with
the ELASTIC control loop cleaning up after it — the ``Autoscaler``
reaps the corpse and boots a replacement in the same decision tick —
and a CHECKPOINT-TRIGGERED rollover completing under the same
traffic: a real parameter server's snapshot cadence publishes a
serving bundle (``BundlePublisher``) that the ``ContinuousDeployer``
rolls across the whole fleet from the autoscaler's own hold ticks.
The trainer commits ZERO deltas, so the published bundle is
byte-identical to the boot bundle (asserted) and every post-deploy
output stays checkable against the same solo references.

The acceptance bar it asserts (and prints as JSON):

- ZERO hung clients — every client thread exits within its join
  budget, through a replica hard-kill, probabilistic router/wire
  faults, and a full rollover;
- ZERO non-typed errors — every failure a caller sees is a
  ``ServingError`` subclass (the router's ``unavailable``/
  ``overloaded`` replies, blamed poison steps surfacing as
  ``internal``); connection resets and overload bursts are absorbed
  by the ``RetryPolicy``;
- ZERO corrupt outputs — every successful generate is token-identical
  to its solo reference decode of the SAME quantized bundle the
  replicas booted from, failovers and upgrades notwithstanding;
- EXACT accounting — every attempt resolves exactly once (completed
  or typed), so a rollover can neither drop nor duplicate a request;
- ZERO incomplete traces — every attempt runs ``trace=True`` and must
  assemble a timeline with EXACTLY ONE terminal span, through the
  kill -9, failover resends, and the rollover: a mid-request replica
  death still yields one complete trace ending in the client's
  terminal span (the router's span records the failover hop).
- A POST-MORTEM BUNDLE PER EJECTION — every replica the router ejects
  (the kill -9 victim above all) dumps one router bundle to the
  soak's ``postmortem_dir``; bundle count must equal the router's
  ejection count, every bundle's recorder timeline must carry the
  ``router.eject`` event naming the ejected endpoint, and at least
  one must name the kill victim — the injected terminal failure is
  explainable from the bundle alone, asserted, not eyeballed.
- REAP-AND-REPLACE BY THE CONTROL LOOP — no manual ``reap_dead``:
  once the router has ejected the victim, the autoscaler's tick must
  both reap it AND (``below_min``) boot a pre-warmed replacement, the
  fleet returning to full strength under live chaotic traffic.
- A CHECKPOINT-TRIGGERED FULL-FLEET ROLLOVER — the PS snapshot
  cadence → publish → deploy chain replaces EVERY replica (the
  replacement included), no request dropped, outputs still identical.
- OVERLOAD-DEFENSE LEDGERS BALANCED THROUGH IT ALL — one replica is
  GRAY (a probabilistic ``net.delay`` stall on its data verbs; health
  polls stay green) and the router runs the full defense tier:
  per-replica circuit breakers, a fleet retry budget, and hedged
  generates. At shutdown every launched hedge must have resolved as
  exactly one win or one loss (hedged winners are identity-checked
  like everything else), no open-breaker replica may have received a
  non-probe forward, and budget refusals must be typed and tallied —
  asserted on the final counters, not eyeballed.

Topology: replicas are REAL subprocesses (``--replica`` runs one)
booted from a shared quantized serving bundle, each arming its OWN
``stepper.step`` seam (fault plans are per-process); the parent runs
the router, the clients, and the parent-side plan (``router.dispatch``
/ ``router.health`` / ``net.send``). The kill is a genuine SIGKILL —
no drain, no FIN handshakes beyond what the kernel sends for a dead
process. The fault mix is seeded, so a failing soak replays::

    python tools/soak_fleet_torch.py --replicas 3 --clients 4 --seed 0

``--fabric`` runs the KV-FABRIC tier instead (``run_fabric_soak``):
kill -9 the peer on the far end of a LIVE point-to-point KV transfer,
in both fabric directions — the digest holder mid-``kv.fetch`` under a
spilling shared-prefix load, and the reserved decode worker mid-push
on the disagg direct path — asserting 0 hung / 0 untyped / 0 divergent
outputs with the router's pairing ledger exactly balanced
(``peer_sends == peer_ok + peer_typed + peer_degraded``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the sibling twins, also when this file runs through runpy
sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))

from loadgen_torch import check_device  # noqa: E402

_HERE = os.path.abspath(__file__)


def _hooked(model):
    """``model`` with the fused LayerNorm hook: the B7 kernel on the
    card, its plain version on the CPU (the replicas' engines and the
    parent's references run the same LayerNorm)."""
    from distkeras_tpu_torch.ops.fused_layernorm import (
        attach_fused_layernorm,
    )

    attach_fused_layernorm(model)
    return model


def _build_kernels(device):
    """On the card, compile every kernel into the shared build cache
    once, in the parent, before any replica boots."""
    if device is None or str(device) != "cpu":
        from distkeras_tpu_torch.kernels import build

        build.build()


def _device_arg(device):
    return ["--cpu"] if device is not None and str(device) == "cpu" else []


# ---------------------------------------------------------------- replica


def replica_main(args) -> int:
    """One fleet replica: boot from the shared bundle, arm the local
    ``stepper.step`` seam, print ``READY <port>``, serve until a
    ``stop`` verb (rollover) or a signal (the kill) ends us."""
    device = check_device(args.cpu)
    from distkeras_tpu_torch.faults import FaultPlan
    from distkeras_tpu_torch.serving import ServingEngine, ServingServer

    if device is None:
        from distkeras_tpu_torch.kernels import build

        missing = [n for n in build.KERNELS
                   if not build._library_path(n).is_file()]
        if missing:
            print(f"replica: kernels {missing} are not in the build cache "
                  f"{build.BUILD_DIR}; the parent builds them",
                  file=sys.stderr, flush=True)
            return 2

    kw = dict(
        num_slots=args.slots, queue_capacity=args.queue_cap,
        prefix_cache=not args.role,
        watchdog_interval=1.0, watchdog_grace=60.0,
        max_restarts=10_000, restart_backoff=0.01, quarantine_steps=8,
    )
    if args.role:
        # a disagg worker for the fabric tier's push phase; role
        # engines keep the test_disagg idiom (no prefix store)
        kw["role"] = args.role
        if args.role == "prefill":
            kw["prefill_chunk"] = 4
    engine = ServingEngine.from_bundle(args.bundle, device=device, **kw)
    _hooked(engine.model)
    server = ServingServer(engine, retry_after_ms=20.0).start()
    if not args.role:
        # the full warm recipe (decode step, every prefill/admit chunk
        # bucket, every prefix-restore bucket), then arm storm
        # detection: from here any serving-path mint of a NEW program
        # is a storm, and the parent asserts zero across the fleet.
        # Same recipe a controller scale-up applies before rotation —
        # the soak's boots (initial, autoscale replacement, rollover
        # replacements) all pay it BEFORE printing READY, so no routed
        # request ever compiles.
        engine._stepper.warmup()
        engine._stepper.warm_prefill_buckets()
        engine._stepper.warm_restore_buckets()
        engine.compile_ledger.mark_warmed()
    plan = FaultPlan(seed=args.seed).arm(
        "stepper.step", times=None, probability=1.0 / args.fault_every
    )
    if args.net_delay > 0:
        # the GRAY replica: health polls answer instantly (the delay
        # seam fires on data verbs only), but generates stall — the
        # slow-but-health-green failure mode binary ejection can't
        # see, which the router's breakers and hedges must absorb
        plan.arm("net.delay", action="delay", delay=args.net_delay,
                 times=None, probability=0.6)
    plan.activate()
    print(f"READY {server.port}", flush=True)
    try:
        server._shutdown_done.wait()
    finally:
        plan.deactivate()
    return 0


class SubprocessReplica:
    """``FleetController`` replica handle backed by a real process —
    the backend that makes kill -9 mean kill -9."""

    def __init__(self, bundle, seed, fault_every, net_delay=0.0,
                 role=None, slots=4, queue_cap=8, device=None):
        env = dict(os.environ)
        cmd = [sys.executable, _HERE, "--replica", "--bundle", bundle,
               "--seed", str(seed), "--fault-every", str(fault_every),
               "--net-delay", str(net_delay),
               "--slots", str(slots), "--queue-cap", str(queue_cap),
               *_device_arg(device)]
        if role:
            cmd += ["--role", role]
        self.proc = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, env=env,
        )
        deadline = time.monotonic() + 240
        port = None
        while time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            if not line:
                break
            if line.startswith("READY "):
                port = int(line.split()[1])
                break
        if port is None:
            self.proc.kill()
            raise RuntimeError("replica subprocess never became ready")
        self.endpoint = ("127.0.0.1", port)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self, drain=True):
        """Graceful: the ``stop`` verb drains the replica's in-flight
        work, its server shutdown completes, the process exits."""
        try:
            from distkeras_tpu_torch.serving import ServingClient

            with ServingClient(
                self.endpoint[0], self.endpoint[1], timeout=30,
                retry=False,
            ) as c:
                c.stop()
        except Exception:  # noqa: BLE001 — it may already be dead
            pass
        try:
            self.proc.wait(timeout=90)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()

    def kill9(self):
        """SIGKILL — the real thing, mid-whatever-it-was-doing."""
        os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait()


# ------------------------------------------------------------------ soak


def run_soak(replicas=3, clients=4, duration=8.0, seed=0,
             fault_every=9, max_new=6, smoke=False, device=None) -> dict:
    """Drive the soak; returns the summary dict ``main`` prints.
    ``smoke=True`` shrinks the fleet and the pacing for tier-1 (all
    control-thread sleeps <= 0.5 s; the wall-clock is dominated by
    replica subprocess boots, not by waiting)."""
    import numpy as np

    from distkeras_tpu_torch.faults import FaultPlan
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.networking import RetryPolicy
    from distkeras_tpu_torch.ops.quantization import quantize_model
    from distkeras_tpu_torch.parameter_servers import DeltaParameterServer
    from distkeras_tpu_torch.predictors import CachedSequenceGenerator
    from distkeras_tpu_torch.serving import (
        AutoscalePolicy,
        Autoscaler,
        BundlePublisher,
        ContinuousDeployer,
        FleetController,
        ServingClient,
        ServingError,
    )
    from distkeras_tpu_torch.utils.serialization import (
        load_serving_bundle,
        save_serving_bundle,
    )

    if smoke:
        replicas, clients, duration = 2, 3, min(duration, 3.0)
    pace = min(0.5, duration / 6.0)

    _build_kernels(device)
    workdir = tempfile.mkdtemp(prefix="soak_fleet_")
    bundle = os.path.join(workdir, "lm_int8.dkt")
    model = zoo.transformer_lm(
        vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2,
        seed=0, device="cpu",
    )
    # quantize a COPY: `model` stays the float training master the
    # parameter server below is seeded from (quantize_model mutates)
    save_serving_bundle(bundle, quantize_model(model.copy()))
    # solo references decode the SAME bundle the replicas serve — the
    # quantized weights, reloaded off disk, are the identity baseline
    ref_model = _hooked(load_serving_bundle(bundle, device=device))
    ref_gen = CachedSequenceGenerator(ref_model, device=device)

    rng = np.random.default_rng(seed)
    header = rng.integers(0, 61, 12).astype(np.int32)
    prompts = [
        np.concatenate([header, rng.integers(0, 61, k).astype(np.int32)])
        for k in (1, 2, 3)
    ] + [rng.integers(0, 61, n).astype(np.int32) for n in (3, 5, 9)]
    refs = [ref_gen.generate(p[None], steps=max_new)[0] for p in prompts]

    spawned = []

    def factory(bundle_path):
        # the SECOND boot is the gray replica: a probabilistic
        # net.delay stall on its data verbs, health polls untouched.
        # The first boot is the kill -9 victim, and autoscale/rollover
        # replacements boot clean — so the gray member survives the
        # kill window and the breakers/hedges see it all soak long
        # (until the rollover replaces the whole fleet).
        rep = SubprocessReplica(
            bundle_path, seed=seed + 100 + len(spawned),
            fault_every=fault_every,
            net_delay=0.1 if len(spawned) == 1 else 0.0,
            device=device,
        )
        spawned.append(rep)
        return rep

    pm_dir = os.path.join(workdir, "postmortems")
    ctl = FleetController(
        bundle, replicas=replicas, factory=factory,
        router_kw=dict(
            health_interval=0.2, eject_after=2, connect_timeout=2.0,
            request_timeout=60.0, retry_after_ms=25.0,
            postmortem_dir=pm_dir,
            # the overload-defense tier rides the same soak: breakers
            # (error-rate threshold above the injected ~1/fault_every
            # internal rate so only real pathologies trip), a fleet
            # retry budget wide enough for the chaos mix's legitimate
            # retries, and hedged generates cutting the gray replica's
            # tail. The gates below are the LEDGERS — every launched
            # hedge resolves win XOR loss, no open-breaker replica
            # ever receives a non-probe forward, and budget refusals
            # are typed — not "a breaker opened", which is timing.
            breaker=dict(window=10.0, min_requests=10,
                         failure_threshold=0.7, open_secs=1.0,
                         outlier_trips=3, outlier_factor=3.0,
                         min_latency=0.05),
            retry_budget=dict(ratio=0.5, burst=50.0),
            hedge_after=0.1,
        ),
    ).start()

    # training → serving: a REAL parameter server seeded with the same
    # float params the boot bundle was quantized from. The soak's
    # trainer commits ZERO deltas, so the checkpoint-cadence publish
    # reproduces the boot bundle byte for byte (asserted below) — the
    # whole publish → deploy chain is exercised under chaos while the
    # solo references stay valid across the rollover.
    publish_every = 3
    names = model._leaf_order()
    ps = DeltaParameterServer(dict(zip(names, model.get_weights())))
    zero_delta = {n: np.zeros_like(w)
                  for n, w in zip(names, model.get_weights())}

    def build_bundle(center, meta, path):
        m = model.copy()
        # the float master at update N, republished
        m.set_weights([np.asarray(center[n]) for n in names])
        save_serving_bundle(path, quantize_model(m))

    publisher = BundlePublisher(
        ps, build_bundle, os.path.join(workdir, "bundles"),
        every=publish_every,
    )
    deployer = ContinuousDeployer(ctl, publisher, timeout=300.0)
    # min == max == fleet size: the loop's only growth row is
    # below_min — replacing the kill -9 victim — and every quiet tick
    # is a hold tick, where the deployer runs
    scaler = Autoscaler(
        ctl,
        AutoscalePolicy(
            min_replicas=replicas, max_replicas=replicas,
            up_cooldown=0.0, down_cooldown=3600.0,
        ),
        interval=min(0.2, pace),
        deployer=deployer,
    )

    plan = (
        FaultPlan(seed=seed)
        .arm("router.dispatch", times=None, probability=0.02)
        .arm("router.health", times=None, probability=0.05)
        .arm("net.send", action="reset", times=None, probability=0.004)
        .arm("net.send", action="truncate", times=None, probability=0.004)
    )

    from distkeras_tpu_torch.obs import timeline_complete

    lock = threading.Lock()
    summary = {
        "replicas": replicas,
        "clients": clients,
        "attempts": 0,
        "completed": 0,
        "typed_errors": {},
        "untyped_errors": 0,
        "untyped_samples": [],
        "corrupt_outputs": 0,
        "trace_attempts": 0,
        "trace_incomplete": 0,
        "trace_incomplete_samples": [],
        "traced_failover_hops": 0,  # traces whose router span moved on
    }
    stop_evt = threading.Event()
    control_err = []

    def check_trace(c):
        """Every attempt — completed, typed-error, or failed-over —
        must have assembled a timeline with exactly one terminal span;
        router spans that record failover hops are counted as direct
        evidence the kill was traced through."""
        tl = c.last_trace
        with lock:
            summary["trace_attempts"] += 1
            if tl is None or not timeline_complete(tl["spans"]):
                summary["trace_incomplete"] += 1
                if len(summary["trace_incomplete_samples"]) < 5:
                    summary["trace_incomplete_samples"].append(
                        None if tl is None
                        else [s["name"] for s in tl["spans"]]
                    )
                return
            for s in tl["spans"]:
                if (s["name"] == "router.route"
                        and (s.get("attrs") or {}).get("failovers")):
                    summary["traced_failover_hops"] += 1

    def client_loop(ci):
        policy = RetryPolicy(
            max_attempts=30, base_delay=0.01, max_delay=0.2,
            budget=300.0, seed=seed * 1000 + ci,
        )
        crng = np.random.default_rng(seed * 100 + ci)
        with ServingClient(
            ctl.router.host, ctl.router.port, retry=policy
        ) as c:
            while not stop_evt.is_set():
                pi = int(crng.integers(0, len(prompts)))
                with lock:
                    summary["attempts"] += 1
                c.last_trace = None  # fresh per attempt
                try:
                    out = c.generate(prompts[pi], max_new, trace=True)
                except ServingError as e:
                    code = getattr(e, "code", type(e).__name__)
                    with lock:
                        summary["typed_errors"][code] = (
                            summary["typed_errors"].get(code, 0) + 1
                        )
                    check_trace(c)
                    continue
                except Exception as e:  # noqa: BLE001 — the finding
                    with lock:
                        summary["untyped_errors"] += 1
                        if len(summary["untyped_samples"]) < 5:
                            summary["untyped_samples"].append(repr(e))
                    check_trace(c)
                    continue
                with lock:
                    if np.array_equal(out, refs[pi]):
                        summary["completed"] += 1
                    else:
                        summary["corrupt_outputs"] += 1
                check_trace(c)

    def control_loop():
        """warm traffic → kill -9 a loaded replica → router ejects it
        → START the autoscaler (its tick reaps the corpse and boots a
        pre-warmed replacement in the same decision cycle) → quiesce
        traffic → trainer commits hit the checkpoint cadence → publish
        → the deployer rolls the WHOLE fleet on a hold tick → stop.
        The kill/replace race runs under live load (the chaos claim);
        the rollover runs quiesced — on one core a replica boot under
        client load takes ~6x longer, and the rollover's own
        drain/join state machine is identical either way."""
        try:
            time.sleep(pace)
            victim = ctl.replicas[0]
            vep = victim.endpoint
            deadline = time.monotonic() + 20
            loaded = False
            while time.monotonic() < deadline:
                for r in ctl.router.replicas():
                    if tuple(r["endpoint"]) == vep and r["in_flight"] > 0:
                        loaded = True
                        break
                if loaded:
                    break
                time.sleep(0.002)
            victim.kill9()  # mid-stream: its in-flight forward dies
            summary["kill"] = {
                "endpoint": list(vep),
                "in_flight_at_kill": loaded,
            }
            # let the ROUTER notice the death (mid-forward failover or
            # failed polls -> ejection + post-mortem dump) before any
            # reap deregisters the endpoint — reaping first would
            # remove the book entry the ejection path records against.
            # The autoscaler starts only after this, for the same
            # reason: its every tick reaps.
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                states = {
                    tuple(r["endpoint"]): r["state"]
                    for r in ctl.router.replicas()
                }
                if states.get(vep) == "ejected":
                    break
                time.sleep(0.01)
            summary["kill"]["ejected_before_reap"] = (
                states.get(vep) == "ejected"
            )
            # from here the CONTROL LOOP owns repair: no manual
            # reap_dead, no manual rollover
            scaler.start()
            deadline = time.monotonic() + 240
            while time.monotonic() < deadline:
                if len(ctl.replicas) == replicas and all(
                    r.alive() for r in ctl.replicas
                ):
                    break
                time.sleep(0.05)
            g = scaler._counters
            summary["autoscale"] = {
                "fleet_size_after_replace": len(ctl.replicas),
                "reaps": g.get("reaps", 0) if g is not None else 0,
                "scale_ups": (
                    g.get("scale_ups", 0) if g is not None else 0
                ),
                "errors": g.get("errors", 0) if g is not None else 0,
            }
            time.sleep(pace)  # tail traffic over the replaced fleet
            # quiesce before the rollover: clients stop issuing, the
            # autoscaler keeps ticking (min == max → every tick holds,
            # so the deployer still runs). In-flight requests drain
            # through the rollover's own per-replica drain.
            stop_evt.set()
            # the trainer: zero-delta commits up to the checkpoint
            # cadence — commit publish_every fires the snapshot
            # listener, the publisher writes bundle_v3, and the next
            # hold tick deploys it
            for _ in range(publish_every):
                ps.commit(zero_delta)
            deadline = time.monotonic() + 300
            while (time.monotonic() < deadline
                   and scaler.last_deploy is None):
                time.sleep(0.05)
            dep = scaler.last_deploy
            if dep is None:
                raise RuntimeError(
                    "checkpoint-triggered deploy never landed: "
                    f"published={publisher.published} "
                    f"publish_errors={publisher.publish_errors} "
                    f"last_decision={scaler.last_decision}"
                )
            summary["rollover"] = dep["ledger"]
            with open(dep["path"], "rb") as f_new:
                new_bytes = f_new.read()
            with open(bundle, "rb") as f_old:
                identical = new_bytes == f_old.read()
            summary["deploy"] = {
                "version": dep["version"],
                "published": publisher.published,
                "publish_errors": publisher.publish_errors,
                "bundle_identical_to_boot": identical,
            }
        except Exception as e:  # noqa: BLE001 — surfaced in summary
            control_err.append(repr(e))
        finally:
            stop_evt.set()

    threads = [
        threading.Thread(target=client_loop, args=(i,), daemon=True)
        for i in range(int(clients))
    ]
    controller = threading.Thread(target=control_loop, daemon=True)
    try:
        with plan:
            for t in threads:
                t.start()
            controller.start()
            controller.join(timeout=600)
            stop_evt.set()
            for t in threads:
                # generous budget past the stop signal: a thread still
                # alive after this is DEFINITIONALLY hung
                t.join(timeout=120.0)
        hung = sum(t.is_alive() for t in threads)
        summary["hung"] = hung + int(controller.is_alive())
        summary["control_errors"] = control_err
        summary["router"] = {
            k: v
            for k, v in ctl.router.stats().items()
            if k != "replicas"
        }
        summary["faults_fired_parent"] = plan.fired()
        summary["fired_by_site"] = {
            s: plan.fired(s)
            for s in ("router.dispatch", "router.health", "net.send")
        }
        # the overload-defense ledgers, read while the router lives:
        # every launched hedge resolved win XOR loss (clients all
        # joined, so no hedged request is still in flight), no
        # open-breaker replica received a non-probe forward, and the
        # budget's own tally agrees with the refusal counter
        rc = summary["router"]
        summary["resilience"] = {
            "slow_replica": (
                list(spawned[1].endpoint) if len(spawned) > 1 else None
            ),
            "retry_budget": ctl.router.retry_budget.snapshot(),
            "retry_budget_exhausted": (
                ctl.router.retry_budget_exhausted.value
            ),
            "hedges": {
                "launched": rc["hedges_launched"],
                "wins": rc["hedge_wins"],
                "losers": rc["hedge_losers"],
            },
            "breakers": {
                "opens": rc["breaker_opens"],
                "half_opens": rc["breaker_half_opens"],
                "closes": rc["breaker_closes"],
                "probes": rc["breaker_probes"],
                "bypass_forwards": rc["breaker_bypass_forwards"],
            },
        }
        # the fleet-wide compile ledger: every LIVE replica's mint
        # summary (survivors + rollover replacements; the kill -9
        # victim's book died with it), asserted storm-free below —
        # replicas warm + mark_warmed before READY, so a storm means
        # a program family the warm missed minted on the serving path
        from distkeras_tpu_torch.serving import ServingClient

        summary["compiles"] = {}
        for rep in spawned:
            if not rep.alive():
                continue
            ep = f"{rep.endpoint[0]}:{rep.endpoint[1]}"
            try:
                with ServingClient(
                    rep.endpoint[0], rep.endpoint[1], timeout=15,
                    retry=False,
                ) as c:
                    summary["compiles"][ep] = c.stats()["compiles"]
            except Exception as e:  # noqa: BLE001 — post-run scrape
                summary["compiles"][ep] = {"error": repr(e)}
        summary["compile_storms"] = sum(
            c.get("storms", 0)
            for c in summary["compiles"].values()
        )
        summary["compiles_scraped"] = sum(
            "storms" in c for c in summary["compiles"].values()
        )
    finally:
        stop_evt.set()
        scaler.shutdown()
        publisher.close()
        ejections_final = (
            0 if ctl.router is None else ctl.router.stats()["ejections"]
        )
        ctl.stop()
        for rep in spawned:
            if rep.alive():
                rep.kill9()
        # the post-mortem bar, read AFTER shutdown (every dump landed):
        # one router bundle per ejection, each carrying the eject event
        # naming its endpoint; the kill victim must be among them
        bundles = []
        try:
            for n in sorted(os.listdir(pm_dir)):
                if n.startswith("postmortem_") and n.endswith(".json"):
                    with open(os.path.join(pm_dir, n)) as f:
                        bundles.append(json.load(f))
        except OSError:
            pass
        victim_ep = "{}:{}".format(*summary.get("kill", {}).get(
            "endpoint", ["?", "?"]
        ))
        well_formed = sum(
            b["reason"] == "replica_ejected"
            and any(
                e["kind"] == "router.eject" and e.get("endpoint")
                for e in b["events"]
            )
            for b in bundles
        )
        victim_named = any(
            e["kind"] == "router.eject" and e.get("endpoint") == victim_ep
            for b in bundles
            for e in b["events"]
        )
        summary["ejections"] = ejections_final
        summary["postmortems"] = len(bundles)
        summary["postmortems_well_formed"] = well_formed
        summary["postmortem_names_victim"] = victim_named
        shutil.rmtree(workdir, ignore_errors=True)

    typed_total = sum(summary["typed_errors"].values())
    summary["accounting_exact"] = (
        summary["attempts"]
        == summary["completed"] + typed_total
        + summary["untyped_errors"] + summary["corrupt_outputs"]
    )
    summary["ok"] = (
        summary["hung"] == 0
        and summary["untyped_errors"] == 0
        and summary["corrupt_outputs"] == 0
        and summary["accounting_exact"]
        and summary["trace_incomplete"] == 0
        and summary["trace_attempts"] > 0
        and not control_err
        # the autoscaler repaired the kill: reaped the corpse AND
        # booted a replacement, fleet back to full strength
        and summary.get("autoscale", {}).get("reaps", 0) >= 1
        and summary.get("autoscale", {}).get("scale_ups", 0) >= 1
        and summary.get("autoscale", {}).get(
            "fleet_size_after_replace"
        ) == replicas
        # the checkpoint-triggered deploy rolled the WHOLE fleet (the
        # replacement included) to a bundle byte-identical to boot
        and len(summary.get("rollover", {}).get("replaced", ())) == (
            replicas
        )
        and summary.get("deploy", {}).get(
            "bundle_identical_to_boot"
        ) is True
        and summary["completed"] > 0
        and summary["ejections"] >= 1
        and summary["postmortems"] == summary["ejections"]
        and summary["postmortems_well_formed"] == summary["postmortems"]
        and summary["postmortem_names_victim"]
        # zero post-warmup serving-path mints anywhere in the fleet
        # (replicas warm + arm before READY; restarts/rollovers
        # re-warm, so they must not trip it)
        and summary.get("compiles_scraped", 0) >= 1
        and summary.get("compile_storms", 0) == 0
        # the overload-defense ledgers: hedge accounting balanced and
        # nonzero (the gray replica's stalls and the kill window both
        # exceed the hedge delay, so hedges MUST have launched), no
        # forward ever bypassed an open breaker, and every budget
        # refusal the counter saw is in the budget's own tally
        and summary["resilience"]["hedges"]["launched"] >= 1
        and summary["resilience"]["hedges"]["launched"] == (
            summary["resilience"]["hedges"]["wins"]
            + summary["resilience"]["hedges"]["losers"]
        )
        and summary["resilience"]["breakers"]["bypass_forwards"] == 0
        and summary["resilience"]["retry_budget"]["exhausted"] >= (
            summary["resilience"]["retry_budget_exhausted"]
        )
    )
    return summary


# ---------------------------------------------------------- fabric tier


def run_fabric_soak(seed=0, smoke=False, max_new=6, device=None) -> dict:
    """The KV-fabric chaos tier: kill -9 the peer on the far end of a
    LIVE point-to-point transfer, in BOTH fabric directions, and hold
    the fail-soft bar. Two phases over real replica subprocesses:

    - FETCH: a small-capacity unified fleet (1 slot + 1 queue entry
      each) under shared-header load. The affinity home fills its
      prefix store (two-touch), its digest reaches the router via
      health, and saturation spills siblings that ``kv.fetch`` the
      pages point-to-point — then the digest holder is kill -9'd with
      fetches in flight. Every requester must degrade to local
      recompute SILENTLY: the client sees retries/typed refusals at
      worst, never a hang, never an untyped error, and every
      completed output stays token-identical to its solo reference.
    - PUSH: a disagg fleet (1 prefill + 2 decode) riding the direct
      push path; the reserved decode worker is kill -9'd while
      pairings are live. The prefill worker's push fails, the router
      books ``peer_degraded`` and falls back to the relay, and the
      pairing ledger must balance EXACTLY:
      ``peer_sends == peer_ok + peer_typed + peer_degraded``.

    Returns the summary dict ``main`` prints; ``summary["ok"]`` is
    the acceptance bar (0 hung / 0 untyped / 0 divergent in both
    phases, a HEALTHY transfer proven before each kill, a DEGRADED
    one after it, the pairing ledger balanced)."""
    import numpy as np

    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.networking import RetryPolicy
    from distkeras_tpu_torch.ops.quantization import quantize_model
    from distkeras_tpu_torch.predictors import CachedSequenceGenerator
    from distkeras_tpu_torch.serving import (
        FleetRouter,
        ServingClient,
        ServingError,
    )
    from distkeras_tpu_torch.serving.prefix_cache import key_hash
    from distkeras_tpu_torch.utils.serialization import (
        load_serving_bundle,
        save_serving_bundle,
    )

    _build_kernels(device)
    workdir = tempfile.mkdtemp(prefix="soak_fabric_")
    bundle = os.path.join(workdir, "lm_int8.dkt")
    model = zoo.transformer_lm(
        vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2,
        seed=0, device="cpu",
    )
    save_serving_bundle(bundle, quantize_model(model.copy()))
    ref_gen = CachedSequenceGenerator(
        _hooked(load_serving_bundle(bundle, device=device)), device=device)

    rng = np.random.default_rng(seed)
    # TWO tenant families, each with its own 16-token shared header:
    # family 0 carries the healthy-fetch half of the phase, family 1
    # is held back until the instant after the kill — its pages exist
    # ONLY on the victim, so every post-kill fetch attempt must dial
    # the corpse and degrade to recompute
    headers = [rng.integers(0, 61, 16).astype(np.int32) for _ in range(3)]
    fam = [
        [
            np.concatenate(
                [h, rng.integers(0, 61, k).astype(np.int32)]
            )
            for k in (1, 2, 3)
        ]
        for h in headers[:2]
    ]
    prompts = fam[0] + fam[1]
    fam2_from = len(fam[0])
    # rung-16 digest hash of family 1's header: identifies which
    # replica's advertised digest holds its pages (the kill victim)
    fam2_hash = key_hash(headers[1])
    refs = [ref_gen.generate(p[None], steps=max_new)[0] for p in prompts]
    # family 2 exists ONLY for the deterministic post-kill probe: no
    # client ever sends it, so no survivor can have cached its header
    # — a probe hint naming the corpse MUST be dialed (coverage 0),
    # must fail typed, and must degrade to recompute
    probe_prompt = np.concatenate(
        [headers[2], rng.integers(0, 61, 1).astype(np.int32)]
    )
    probe_ref = ref_gen.generate(probe_prompt[None], steps=max_new)[0]

    lock = threading.Lock()

    def new_rec():
        return {
            "attempts": 0, "completed": 0, "typed_errors": {},
            "untyped": 0, "untyped_samples": [], "divergent": 0,
        }

    def start_clients(router, rec, stop_evt, n, fam2_evt=None):
        def loop(ci):
            policy = RetryPolicy(
                max_attempts=30, base_delay=0.01, max_delay=0.2,
                budget=300.0, seed=seed * 1000 + ci,
            )
            crng = np.random.default_rng(seed * 100 + ci)
            with ServingClient(
                router.host, router.port, retry=policy
            ) as c:
                while not stop_evt.is_set():
                    if fam2_evt is not None and fam2_evt.is_set():
                        pi = fam2_from + int(
                            crng.integers(0, len(prompts) - fam2_from)
                        )
                    else:
                        pi = int(crng.integers(0, fam2_from))
                    with lock:
                        rec["attempts"] += 1
                    try:
                        out = c.generate(prompts[pi], max_new)
                    except ServingError as e:
                        code = getattr(e, "code", type(e).__name__)
                        with lock:
                            rec["typed_errors"][code] = (
                                rec["typed_errors"].get(code, 0) + 1
                            )
                        continue
                    except Exception as e:  # noqa: BLE001 — the finding
                        with lock:
                            rec["untyped"] += 1
                            if len(rec["untyped_samples"]) < 5:
                                rec["untyped_samples"].append(repr(e))
                        continue
                    with lock:
                        if np.array_equal(out, refs[pi]):
                            rec["completed"] += 1
                        else:
                            rec["divergent"] += 1

        threads = [
            threading.Thread(target=loop, args=(i,), daemon=True)
            for i in range(n)
        ]
        for t in threads:
            t.start()
        return threads

    def finish(threads, stop_evt):
        stop_evt.set()
        for t in threads:
            t.join(timeout=120.0)
        return sum(t.is_alive() for t in threads)

    clean = 10 ** 9  # no injected step faults: the kill IS the chaos
    traffic = 0.8 if smoke else 1.5

    def scrape_peer(reps, rec):
        """Sum the LIVE replicas' requester/server fabric counters
        (the victim's book died with it)."""
        peer = {}
        for rep in reps:
            if not rep.alive():
                continue
            try:
                with ServingClient(rep.endpoint[0], rep.endpoint[1],
                                   timeout=15, retry=False) as c:
                    kf = c.health().get("kv_fabric") or {}
                    for k, v in (kf.get("peer") or {}).items():
                        peer[k] = peer.get(k, 0) + int(v)
            except Exception as e:  # noqa: BLE001 — post-run scrape
                rec["control_errors"].append(repr(e))
        return peer

    # ---- phase 1: kill the digest holder mid-kv.fetch -------------
    fetch = new_rec()
    fetch["control_errors"] = []
    reps = []
    router = None
    stop_evt = threading.Event()
    threads = []
    try:
        # 1-slot / 1-queue replicas: concurrent clients saturate the
        # affinity home immediately, so spillover (and with it the
        # peer-fetch path) is constant, not incidental
        reps = [
            SubprocessReplica(bundle, seed=seed + 10 + i,
                              fault_every=clean, slots=1, queue_cap=1,
                              device=device)
            for i in range(2 if smoke else 3)
        ]
        router = FleetRouter(
            endpoints=[r.endpoint for r in reps],
            health_interval=0.1, eject_after=4,
            connect_timeout=2.0, request_timeout=60.0,
            retry_after_ms=10.0,
        ).start()
        for r in reps:
            if not router.wait_in_rotation(r.endpoint):
                raise RuntimeError(f"replica {r.endpoint} never joined")
        # warm SEQUENTIALLY through the router: no concurrency means
        # no spill, so each family's pages land ONLY on its affinity
        # home (two passes — two-touch admission inserts on the
        # second sighting). Retry-wrapped: 1-slot replicas can refuse
        # a back-to-back request typed overloaded for a beat.
        warm_policy = RetryPolicy(
            max_attempts=30, base_delay=0.01, max_delay=0.2,
            budget=300.0, seed=seed,
        )
        with ServingClient(router.host, router.port,
                           retry=warm_policy) as c:
            for _ in range(2):
                for p in prompts:
                    c.generate(p, max_new)
            for pi, p in enumerate(prompts):
                if not np.array_equal(
                    c.generate(p, max_new), refs[pi]
                ):
                    raise RuntimeError("warm output diverged from solo")
        # the kill victim: the replica whose OWN advertised digest
        # holds family 1's header rung — after the kill, family 1's
        # pages exist nowhere else, so every hinted fetch for them
        # must dial the corpse and degrade
        deadline = time.monotonic() + 60
        victim = None
        while victim is None and time.monotonic() < deadline:
            for rep in reps:
                with ServingClient(rep.endpoint[0], rep.endpoint[1],
                                   timeout=15, retry=False) as c:
                    dg = (
                        (c.health().get("kv_fabric") or {})
                        .get("digest") or {}
                    )
                if fam2_hash in (dg.get("h") or ()):
                    victim = rep
                    break
            else:
                time.sleep(0.05)
        if victim is None:
            raise RuntimeError(
                "no replica's digest ever held family 1's pages"
            )
        # the router must have polled the holders' digests before the
        # clients start, or early spills route blind (no hints)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if any(
                (r.get("kv_fabric") or {}).get("digest_n")
                for r in router.replicas()
            ):
                break
            time.sleep(0.05)
        fam2_evt = threading.Event()
        threads = start_clients(router, fetch, stop_evt,
                                3 if smoke else 4, fam2_evt=fam2_evt)
        # hold until a HEALTHY peer fetch has landed (a spilled
        # sibling pulled family 0's pages and validated the frame)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if scrape_peer(reps, fetch).get("fetch_ok", 0) >= 1:
                break
            time.sleep(0.05)
        time.sleep(traffic / 2)  # fetch traffic in flight
        # bank the victim's requester-side book before it dies: a
        # spilled request can land ON the digest holder and pull the
        # OTHER family's pages, so the phase's healthy fetch_ok may
        # live in the victim's counters — merged into the final
        # aggregate below, where the survivors-only scrape would
        # otherwise undercount it
        victim_peer = {}
        try:
            with ServingClient(victim.endpoint[0], victim.endpoint[1],
                               timeout=15, retry=False) as c:
                kf = c.health().get("kv_fabric") or {}
                victim_peer = {
                    k: int(v) for k, v in (kf.get("peer") or {}).items()
                }
        except Exception as e:  # noqa: BLE001 — best-effort bank: a
            # failed scrape only matters if the healthy fetch lived
            # on the victim, and then the fetch_ok gate fails anyway
            fetch["victim_bank_error"] = repr(e)
        victim.kill9()  # mid-fetch: the digest holder dies
        fetch["victim"] = list(victim.endpoint)
        # flip the load to family 1: its pages lived only on the
        # corpse, and the router's hints keep naming it until the
        # ejection clears the digest — attempts in that window fetch
        # against the dead peer and must degrade silently
        fam2_evt.set()
        time.sleep(traffic)  # survivors degrade to recompute
        fetch["hung"] = finish(threads, stop_evt)
        # the DETERMINISTIC mid-fetch-kill probe, on the now-quiet
        # fleet and independent of routing races: hand a survivor a
        # hint naming the corpse (exactly what the router's books
        # said moments ago) — the survivor must dial it, fail typed,
        # degrade to recompute, and still answer token-identically
        from distkeras_tpu_torch.utils.serialization import (
            deserialize_params,
            serialize_params,
        )

        survivor = next(r for r in reps if r.alive())
        with ServingClient(survivor.endpoint[0], survivor.endpoint[1],
                           timeout=60, retry=False) as c:
            deadline = time.monotonic() + 60
            while True:
                reply, body = c._roundtrip(
                    {"verb": "generate",
                     "max_new_tokens": int(max_new),
                     "kv_peers": [{
                         "endpoint": list(victim.endpoint),
                         "epoch": 1, "len": 16,
                     }]},
                    serialize_params(probe_prompt),
                    raise_on_error=False,
                )
                if reply.get("ok") or reply.get("error") not in (
                    "overloaded", "unavailable"
                ) or time.monotonic() > deadline:
                    break
                time.sleep(0.05)  # the last in-flight work drains
        fetch["probe_identical"] = bool(reply.get("ok")) and (
            np.array_equal(
                np.asarray(deserialize_params(body)), probe_ref
            )
        )
        rc = router.stats()
        fetch["router"] = {
            k: rc[k]
            for k in ("affinity_routed", "spilled", "digest_routed",
                      "failovers", "ejections")
        }
        fetch["peer"] = scrape_peer(reps, fetch)
        for k, v in victim_peer.items():
            fetch["peer"][k] = fetch["peer"].get(k, 0) + v
    except Exception as e:  # noqa: BLE001 — surfaced in summary
        fetch["control_errors"].append(repr(e))
        fetch["hung"] = finish(threads, stop_evt)
        fetch.setdefault("peer", {})
    finally:
        if router is not None:
            router.shutdown()
        for rep in reps:
            if rep.alive():
                rep.kill9()

    # ---- phase 2: kill the reserved decode worker mid-push --------
    push = new_rec()
    push["control_errors"] = []
    reps = []
    router = None
    stop_evt = threading.Event()
    threads = []
    try:
        reps = [
            SubprocessReplica(bundle, seed=seed + 20,
                              fault_every=clean, role="prefill",
                              device=device),
            SubprocessReplica(bundle, seed=seed + 21,
                              fault_every=clean, role="decode",
                              device=device),
            SubprocessReplica(bundle, seed=seed + 22,
                              fault_every=clean, role="decode",
                              device=device),
        ]
        router = FleetRouter(
            endpoints=[r.endpoint for r in reps],
            health_interval=0.05, eject_after=2,
            connect_timeout=2.0, request_timeout=60.0,
            retry_after_ms=10.0,
        ).start()
        for r in reps:
            if not router.wait_in_rotation(r.endpoint):
                raise RuntimeError(f"replica {r.endpoint} never joined")
        # warm sequentially until a HEALTHY direct push has landed
        # (role replicas compile on first touch — a kill during the
        # compile window would prove nothing about the push path)
        with ServingClient(router.host, router.port) as c:
            deadline = time.monotonic() + 240
            while router.stats()["peer_ok"] < 1:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        "no healthy direct push ever landed"
                    )
                if not np.array_equal(
                    c.generate(prompts[0], max_new), refs[0]
                ):
                    raise RuntimeError("warm output diverged from solo")
        threads = start_clients(router, push, stop_evt,
                                3 if smoke else 4)
        # wait for a LIVE pairing: the router reserves the decode
        # worker for the pairing's duration, so a decode with
        # in_flight > 0 is (or is about to be) a push target
        deadline = time.monotonic() + 120
        victim_ep = None
        while time.monotonic() < deadline:
            for r in router.replicas():
                if r.get("role") == "decode" and r["in_flight"] > 0:
                    victim_ep = tuple(r["endpoint"])
                    break
            if victim_ep is not None:
                break
            time.sleep(0.002)
        if victim_ep is None:
            raise RuntimeError("no decode pairing ever went live")
        victim = next(r for r in reps if r.endpoint == victim_ep)
        victim.kill9()  # mid-push: the prefill worker's peer dies
        push["victim"] = list(victim_ep)
        time.sleep(traffic)  # degraded pairings relay via the sibling
        push["hung"] = finish(threads, stop_evt)
        rc = router.stats()
        push["router"] = {
            k: rc[k]
            for k in ("disagg_routed", "peer_sends", "peer_ok",
                      "peer_typed", "peer_degraded", "transfer_sends",
                      "transfer_ok", "transfer_typed", "failovers",
                      "ejections")
        }
        push["pairing_balanced"] = (
            rc["peer_sends"]
            == rc["peer_ok"] + rc["peer_typed"] + rc["peer_degraded"]
        )
    except Exception as e:  # noqa: BLE001 — surfaced in summary
        push["control_errors"].append(repr(e))
        push["hung"] = finish(threads, stop_evt)
        push.setdefault("pairing_balanced", False)
        push.setdefault("router", {})
    finally:
        if router is not None:
            router.shutdown()
        for rep in reps:
            if rep.alive():
                rep.kill9()
        shutil.rmtree(workdir, ignore_errors=True)

    summary = {"fetch": fetch, "push": push}
    summary["ok"] = (
        fetch["hung"] == 0
        and push["hung"] == 0
        and fetch["untyped"] == 0
        and push["untyped"] == 0
        and fetch["divergent"] == 0
        and push["divergent"] == 0
        and fetch["completed"] > 0
        and push["completed"] > 0
        and not fetch["control_errors"]
        and not push["control_errors"]
        # a HEALTHY validated peer fetch landed before the kill...
        and fetch["peer"].get("fetch_ok", 0) >= 1
        # ...and after it, a hint naming the corpse degraded to
        # recompute with the output still token-identical
        and fetch["peer"].get("fetch_degraded", 0) >= 1
        and fetch.get("probe_identical") is True
        # a healthy direct push landed before the kill, at least one
        # pairing degraded to the relay after it, and every pairing
        # resolved exactly once (the fabric's invariant)
        and push["router"].get("peer_sends", 0) >= 1
        and push["router"].get("peer_ok", 0) >= 1
        and push["router"].get("peer_degraded", 0) >= 1
        and push["pairing_balanced"]
    )
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--duration", type=float, default=8.0,
                    help="pacing scale for the soak phases")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-every", type=int, default=9,
                    help="mean scheduler steps between injected "
                         "replica-side step faults")
    ap.add_argument("--smoke", action="store_true",
                    help="tier-1 scale: 2 replicas, 3 clients, short "
                         "pacing")
    ap.add_argument("--fabric", action="store_true",
                    help="run the KV-fabric tier instead: kill -9 the "
                         "digest holder mid-kv.fetch and the reserved "
                         "decode worker mid-push")
    # internal: run as one replica subprocess
    ap.add_argument("--replica", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--bundle", help=argparse.SUPPRESS)
    ap.add_argument("--net-delay", type=float, default=0.0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--role", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--slots", type=int, default=4,
                    help=argparse.SUPPRESS)
    ap.add_argument("--queue-cap", type=int, default=8,
                    help=argparse.SUPPRESS)
    ap.add_argument("--cpu", action="store_true",
                    help="run the replicas and the references on the CPU "
                         "(the default is the GPU)")
    args = ap.parse_args(argv)

    if args.replica:
        return replica_main(args)

    device = check_device(args.cpu)
    if args.fabric:
        summary = run_fabric_soak(seed=args.seed, smoke=args.smoke,
                                  device=device)
        json.dump(summary, sys.stdout, indent=2, default=str)
        print()
        if not summary["ok"]:
            print("FABRIC SOAK FAILED: hung clients, untyped errors, "
                  "divergent outputs, or an unbalanced pairing ledger "
                  "(see summary above)", file=sys.stderr)
            return 1
        return 0
    summary = run_soak(
        replicas=args.replicas, clients=args.clients,
        duration=args.duration, seed=args.seed,
        fault_every=args.fault_every, smoke=args.smoke, device=device,
    )
    json.dump(summary, sys.stdout, indent=2, default=str)
    print()
    if not summary["ok"]:
        print("SOAK FAILED: hung clients, untyped errors, corrupt "
              "outputs, or an incomplete rollover (see summary above)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
