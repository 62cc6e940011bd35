#!/usr/bin/env python
"""Chaos soak for the PyTorch port's serving tier: N concurrent clients
against a fault-armed server for a fixed wall-clock (the port's twin of
``tools/soak_serving.py``: the same seams, mix, phases and bars, on the
port's engine, server, client and router).

It runs on the card unless ``--cpu`` is given (``device="cpu"`` in the
Python API); without a card it exits non-zero. The default model gets
the fused LayerNorm hook, so on the card every decode step, verify
window and prefill chunk launches the B7 kernel. ``--mesh tp:N --cpu``
puts every shard on the CPU device.

The acceptance bar it asserts (and prints as JSON):

- ZERO hung requests — every client thread exits within its join
  budget; nothing blocks forever on a dead scheduler or a dropped
  reply;
- ZERO non-typed errors — every failure a caller sees is a
  ``ServingError`` subclass (``overloaded`` bursts and connection
  resets are absorbed by the default ``RetryPolicy``; blamed poison
  steps and supervisor restarts surface as ``internal``);
- ZERO corrupt outputs — every successful GREEDY generate is token-
  identical to its solo ``CachedSequenceGenerator`` reference,
  restarts and quarantines notwithstanding;
- ZERO divergent replays — the client mix is greedy / SAMPLED /
  grammar-CONSTRAINED / n=2-parallel; every sampled-family request
  carries a fixed seed and its canonical output is captured once,
  fault-free, before chaos arms. Under chaos, every successful serve
  of the same (prompt, params) — through blame probes, quarantine
  re-admissions, and watchdog restarts — must reproduce the canonical
  sample token-identically (the position-keyed RNG claim, asserted
  under fire), and constrained outputs must stay inside their
  grammar;
- ZERO incomplete traces — every client request runs ``trace=True``,
  and every attempt (completed or typed-error alike) must assemble a
  timeline with EXACTLY ONE terminal span. "0 hung / 0 untyped" stops
  being a client-side claim: the instrumentation itself must account
  for where every request ended.
- A POST-MORTEM BUNDLE PER TERMINAL FAILURE — the armed
  ``scheduler.loop`` seam kills the scheduler thread repeatedly; every
  resulting watchdog trip must dump exactly one bundle to the soak's
  ``postmortem_dir``, and every bundle's flight-recorder timeline must
  NAME the injected seam (a ``fault.fired`` event at
  ``scheduler.loop``) — failure triage without a seed replay is the
  acceptance bar, asserted here, not eyeballed.
- QOS PREEMPTION PAIRING under chaos — the client set is MULTI-TENANT
  and MIXED-PRIORITY (three tenants at priorities 2/1/0 against a
  deliberately tight page pool), the engine schedules with a
  ``QosPolicy(preempt=True)``, and the ``kv.swap`` seam is in the
  armed set: every preemption (KV swap-out) must pair with a resume
  or a TYPED failure — ``preemptions == resumes + swap_in_failures +
  swapped_failed`` on the final counters — and the pool ledger must
  balance at shutdown (zero slot-held pages; the device prefix index
  cleared leaves zero pages in use). Preempted/resumed GREEDY streams
  still match solo decode and preempted SAMPLED streams still replay
  canonically — the identity bars above already cover the swap path
  because preemption hits the same client traffic.

The fault mix is seeded (``FaultPlan`` draws probabilistic seams from
its own RNG), so a failing soak replays exactly with the same seed::

    python tools/soak_serving_torch.py --clients 4 --duration 10 --seed 0
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the sibling twins, also when this file runs through runpy
sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))

from loadgen_torch import check_device  # noqa: E402


def default_model(device=None):
    """The soaks' standard tiny LM, with the fused LayerNorm hook (the
    B7 kernel on the card, its plain version on the CPU)."""
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.fused_layernorm import (
        attach_fused_layernorm,
    )

    model = zoo.transformer_lm(
        vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2,
        seed=0, device=device,
    )
    attach_fused_layernorm(model)
    return model


def resolve_mesh(mesh, device=None):
    """``mesh`` as the engine takes it: a ``"tp:N"`` spec draws on the
    CUDA cards, and on the CPU it puts all N shards on the CPU device."""
    if mesh is None or device is None or str(device) != "cpu":
        return mesh
    import torch

    from distkeras_tpu_torch.parallel.mesh import serving_mesh

    if isinstance(mesh, str) and mesh.startswith("tp:"):
        n = int(mesh.split(":", 1)[1])
        return serving_mesh(mesh, devices=[torch.device("cpu")] * n)
    return mesh


def run_soak(model=None, clients=4, duration=5.0, seed=0,
             fault_every=7, max_new=6, speculative=True,
             paged=True, mesh=None, storm=True, device=None) -> dict:
    """Drive the soak; returns the summary dict (also what ``main``
    prints). ``fault_every``: mean steps between injected device-step
    faults (the blame-path pressure); wire faults ride fixed seeded
    probabilities. ``model=None`` builds the standard tiny LM.
    ``speculative``: serve draft-and-verify (a self-draft — every
    window fully accepted, so the ``stepper.verify`` seam fires every
    iteration); outputs must STILL match solo decode under chaos.
    ``paged``: serve the block-paged KV cache (the default — the soak
    covers the capacity path production runs) with the ``kv.alloc``
    seam in the armed set: injected allocator failures must surface
    typed (``internal`` for a generic crash, retriable ``overloaded``
    for exhaustion), never hang a slot or corrupt a stream.
    ``mesh``: serve tensor-parallel over a serving mesh (e.g.
    ``"tp:2"`` — needs N cards, or ``device="cpu"``, which puts every
    shard on the CPU device): every identity/pairing/ledger bar
    above holds UNCHANGED on a sharded engine, and a watchdog restart
    must rebuild the sharded stepper and re-warm the sharded buckets
    (the stepper config carries the mesh through ``_restart``).
    ``storm`` (the default): the engine runs the adaptive overload
    gate (``shed=``) and a mid-soak STORM PHASE hammers it — a burst
    of extra no-retry priority-0 clients, several times the steady
    set. The shed ledger must balance: every gate refusal is a typed
    ``overloaded`` reply carrying an honest ``retry_after_ms`` (the
    burst clients assert the hint on every shed they see), burst
    accounting is exact (every burst attempt resolves ok or typed,
    none hung/untyped), the gate actually shed under the burst, and
    the identity/trace bars above hold right through the brownout —
    retrying steady clients ride out the storm, and every output
    that DOES complete mid-storm still matches its reference."""
    import numpy as np

    from distkeras_tpu_torch.faults import FaultPlan
    from distkeras_tpu_torch.networking import RetryPolicy
    from distkeras_tpu_torch.predictors import CachedSequenceGenerator
    from distkeras_tpu_torch.serving import (
        PoolExhaustedError,
        QosPolicy,
        ServingClient,
        ServingEngine,
        ServingError,
        ServingServer,
    )

    if model is None:
        model = default_model(device)
    mesh = resolve_mesh(mesh, device)

    from distkeras_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(0, 61, n).astype(np.int32) for n in (3, 5, 7, 9)
    ]
    ref_gen = CachedSequenceGenerator(model, device=device)
    refs = [ref_gen.generate(p[None], steps=max_new)[0] for p in prompts]
    # the sampled-family request mix: per-prompt params with FIXED
    # seeds (replay is the acceptance bar), a grammar-constrained
    # shape, and an n=2 completion group (paged engines fork it);
    # n>1 needs fork_slot, so the dense opt-out drops the group shape
    grammar = {"kind": "allow", "tokens": list(range(0, 61, 2))}
    sampled_params = [
        SamplingParams(temperature=0.8, seed=100 + i)
        for i in range(len(prompts))
    ] + [
        SamplingParams(temperature=0.9, top_p=0.9, seed=200,
                       grammar=grammar),
    ] + ([SamplingParams(temperature=0.8, seed=300, n=2)] if paged
         else [])
    # sampled request i pairs params i with prompt i % len(prompts)
    sampled_reqs = [
        (prompts[i % len(prompts)], sp)
        for i, sp in enumerate(sampled_params)
    ]

    postmortem_dir = tempfile.mkdtemp(prefix="soak_serving_pm_")
    engine = ServingEngine(
        model, num_slots=4, queue_capacity=4, prefix_cache=False,
        # generous grace: the warmup compiles ~5 programs on a possibly
        # contended core, and a compile mistaken for a wedge would turn
        # the soak into a restart storm before traffic even starts
        watchdog_interval=1.0, watchdog_grace=60.0,
        max_restarts=10_000,  # the soak outlives scheduler crashes
        restart_backoff=0.01, quarantine_steps=8,
        postmortem_dir=postmortem_dir,
        # paged KV (the production capacity path): small pages so the
        # soak's short prompts still span multiple pages; the pool is
        # deliberately TIGHT (≈3 concurrent requests across 4 slots)
        # so the mixed-priority client set's high-priority arrivals
        # actually block and PREEMPT — organic pool pressure plus the
        # armed kv.alloc/kv.swap seams is the point of this soak
        **(dict(paged=True, page_size=4, num_pages=16) if paged
           else {}),
        # multi-tenant QoS: the client set is mixed-priority, so the
        # scheduler runs priorities + WFQ + preemption-by-swap under
        # the same chaos as everything else
        qos=QosPolicy(preempt=True, max_preemptions=2),
        # the overload-defense door: CoDel-style sojourn gate with a
        # TIGHT target — the armed step seam makes requests fail fast,
        # so the queue never builds tens-of-ms sojourns; when the
        # burst's genuine extra queueing crosses the target it latches
        # rung 1 organically, and the storm phase ALSO declares an
        # operator brownout through ``burn_fn`` (below) so rung 1 is
        # guaranteed for the burst window at any scale. Rung 1 sheds
        # priority 0 typed; the steady mixed-priority clients at 1/2
        # ride through, and rung 1 never clamps, so replay identity
        # is untouched. burn_interval is short so the declared
        # brownout engages and releases within the storm window.
        **(dict(shed=dict(target_ms=1.5, interval_ms=100.0,
                          burn_interval=0.2))
           if storm else {}),
        # tensor-parallel arm: the same chaos over a sharded stepper
        **(dict(mesh=mesh) if mesh else {}),
        # self-draft: k proposals that always agree, so every scheduler
        # iteration runs the VERIFY program and the armed stepper.verify
        # seam sees real traffic
        **(
            dict(speculative="draft", draft_bundle=model, draft_k=3)
            if speculative
            else {}
        ),
        device=device,
    )
    server = ServingServer(engine, retry_after_ms=20.0).start()
    for p in prompts:  # fault-free warmup: compile every bucket + the step
        engine.generate(p, max_new)
    # canonical sampled outputs, captured FAULT-FREE: under chaos,
    # every successful serve of the same (prompt, params) must
    # reproduce these token-identically — the replay-determinism bar
    # (this also warms the sampled/masked program variants)
    canon = [
        engine.generate(p, max_new, sampling=sp)
        for p, sp in sampled_reqs
    ]
    # the compile-warmup boundary: every program family live traffic
    # can key on is compiled by here — the prefill/chunk buckets
    # (which depend on how the scheduler's budget SPLITS across
    # concurrent admissions, so the fault-free drives above cannot
    # cover them) and QoS preemption's timing-dependent swap-restore
    # buckets (the r16 stall class). From this line a serving-path
    # mint of a NEW program is a compile STORM (the xla.compile.storm
    # event + gauge) and fails the soak. Chaos restarts re-warm
    # through the supervisor (trigger=warmup) and re-mint known
    # programs (rewarm) — neither trips it.
    engine._stepper.warmup()  # unmasked step buckets + verify
    engine._stepper.warm_prefill_buckets()
    engine._stepper.warm_restore_buckets()
    # the soak serves grammar-constrained AND speculative traffic
    # under churning occupancy, so the masked step/verify variants
    # must cover every pow2 table bucket too (which variant an
    # iteration needs tracks the longest occupied table)
    engine._stepper.warm_constrained_buckets()
    engine.compile_ledger.mark_warmed()

    def matches_canon(si, out):
        want = canon[si]
        if isinstance(want, list):
            return isinstance(out, list) and len(out) == len(want) and all(
                np.array_equal(a, b) for a, b in zip(out, want)
            )
        return np.array_equal(out, want)

    allowed_toks = set(grammar["tokens"])

    plan = (
        FaultPlan(seed=seed)
        .arm("stepper.step", times=None, probability=1.0 / fault_every)
        .arm("stepper.verify", times=None, probability=1.0 / fault_every)
        .arm("server.reply", action="drop", times=None, probability=0.03)
        .arm("net.send", action="reset", times=None, probability=0.01)
        .arm("net.send", action="truncate", times=None, probability=0.01)
        # gray-failure flavor: probabilistic server-side stalls on the
        # data verbs (the net.delay seam) — slow replies must still be
        # CORRECT replies, and the shed gate's sojourn signal must not
        # confuse a stalled wire with a congested queue
        .arm("net.delay", action="delay", delay=0.05, times=None,
             probability=0.02)
        # paged-KV allocator chaos: a generic allocator crash (typed
        # internal via the prefill-failure path) and injected pool
        # exhaustion (typed retriable overloaded, absorbed by the
        # clients' RetryPolicy like any backpressure)
        .arm("kv.alloc", times=None, probability=0.03)
        .arm("kv.alloc", times=None, probability=0.03,
             exc=PoolExhaustedError("injected pool exhaustion"))
        # QoS swap chaos, BOTH directions: a failed swap-out aborts
        # the preemption (victim untouched), a failed swap-in fails
        # only the preempted request typed — the pairing invariant
        # below must hold regardless
        .arm("kv.swap", times=None, probability=0.05)
        # the TERMINAL seam: kill the scheduler thread outright — once
        # deterministically (the guaranteed trip even at smoke scale)
        # and then probabilistically — so every watchdog trip's
        # post-mortem bundle can be asserted below
        .arm("scheduler.loop", times=1, after=60)
        .arm("scheduler.loop", times=None, after=200, probability=0.002)
    )

    from distkeras_tpu_torch.obs import timeline_complete

    lock = threading.Lock()
    summary = {
        "completed": 0,
        "sampled_completed": 0,
        "typed_errors": {},
        "untyped_errors": 0,
        "untyped_samples": [],
        "corrupt_outputs": 0,
        "divergent_replays": 0,
        "grammar_violations": 0,
        "trace_attempts": 0,
        "trace_incomplete": 0,
        "trace_incomplete_samples": [],
    }
    stop_at = time.monotonic() + float(duration)

    def check_trace(c):
        """Every attempt — completed OR typed-error — must have
        assembled a timeline with exactly one terminal span."""
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

    def client_loop(ci):
        # the wall-clock budget bounds the retries: a priority-0 steady
        # client is shed on every attempt while the storm's brownout
        # lasts (0.45 of the soak), and at the gate's honest hints on a
        # full-width model 30 attempts (the JAX tool's cap) ran out inside
        # it, surfacing whatever the last attempt met, an injected wire
        # reset included; steady clients are meant to ride the storm out
        policy = RetryPolicy(
            max_attempts=10_000, base_delay=0.01, max_delay=0.2,
            budget=duration + 30.0, seed=seed * 1000 + ci,
        )
        crng = np.random.default_rng(seed * 100 + ci)
        # multi-tenant mixed-priority identity: client ci speaks for
        # tenant{ci%3} at priority 2/1/0 — high-priority arrivals into
        # the tight pool drive real preemptions of the lower classes
        tenant = f"tenant{ci % 3}"
        prio = (2, 1, 0)[ci % 3]
        with ServingClient("127.0.0.1", server.port, retry=policy) as c:
            while time.monotonic() < stop_at:
                # mixed traffic: greedy shapes AND the sampled family
                # (sampled / constrained / n=2) share the bank, an
                # even split so a short smoke still completes both
                # kinds under load
                si = None
                if crng.random() < 0.5:
                    pi = int(crng.integers(0, len(prompts)))
                    prompt, sp = prompts[pi], None
                else:
                    si = int(crng.integers(0, len(sampled_reqs)))
                    prompt, sp = sampled_reqs[si]
                c.last_trace = None  # fresh per attempt
                try:
                    out = c.generate(
                        prompt, max_new, trace=True, sampling=sp,
                        tenant=tenant, priority=prio,
                    )
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
                    if si is None:
                        if np.array_equal(out, refs[pi]):
                            summary["completed"] += 1
                        else:
                            summary["corrupt_outputs"] += 1
                    else:
                        if matches_canon(si, out):
                            summary["sampled_completed"] += 1
                        else:
                            summary["divergent_replays"] += 1
                            if len(summary.setdefault(
                                "divergent_samples", []
                            )) < 5:
                                want = canon[si]
                                summary["divergent_samples"].append({
                                    "si": si,
                                    "got": np.asarray(out).tolist()
                                    if not isinstance(out, list)
                                    else [np.asarray(o).tolist()
                                          for o in out],
                                    "want": np.asarray(want).tolist()
                                    if not isinstance(want, list)
                                    else [np.asarray(w).tolist()
                                          for w in want],
                                })
                        if sampled_reqs[si][1].grammar is not None:
                            gen = np.asarray(out)[prompt.size:]
                            if not set(gen.tolist()) <= allowed_toks:
                                summary["grammar_violations"] += 1
                check_trace(c)

    storm_stats = {
        "burst_clients": 0, "attempts": 0, "ok": 0, "corrupt": 0,
        "typed": {}, "untyped": 0, "hung": 0, "hint_missing": 0,
    }

    def storm_loop():
        """The storm phase: mid-soak, 5x the steady client count of
        NO-RETRY priority-0 one-shot clients slam the gate. No retry
        wrapper means every shed SURFACES (typed ``overloaded``), so
        the burst ledger is exact: attempts == ok + typed + untyped,
        every overloaded reply must carry a retry hint, and every
        burst completion is identity-checked like steady traffic."""
        start = stop_at - 0.65 * float(duration)
        delay = start - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        burst_end = min(stop_at - 0.1, time.monotonic()
                        + 0.45 * float(duration))
        n = 5 * int(clients)
        storm_stats["burst_clients"] = n
        # the operator-declared brownout: for the burst window the
        # gate's burn signal reads "burning" (the burn-rate
        # vocabulary, rung 1 — shed priority 0, never clamp). This is
        # the brownout ladder's real input path, not a test shim: the
        # ladder is DESIGNED to be driven by SLO/operator verdicts,
        # and the soak acts as the operator for the storm's duration —
        # so rung 1 engages deterministically at any scale, with
        # organic CoDel latching riding on top when queueing builds.
        gate = engine.shed_gate
        steady_burn = gate.burn_fn
        gate.burn_fn = lambda: "burning"

        def burst(bi):
            brng = np.random.default_rng(seed * 77 + 7 * bi + 1)
            with ServingClient(
                "127.0.0.1", server.port, retry=False,
            ) as c:
                while time.monotonic() < burst_end:
                    pi = int(brng.integers(0, len(prompts)))
                    with lock:
                        storm_stats["attempts"] += 1
                    try:
                        out = c.generate(
                            prompts[pi], max_new, tenant="storm",
                            priority=0,
                        )
                    except ServingError as e:
                        code = getattr(e, "code", type(e).__name__)
                        hint = getattr(e, "retry_after_ms", None) or (
                            getattr(e, "retry_after", None)
                        )
                        with lock:
                            storm_stats["typed"][code] = (
                                storm_stats["typed"].get(code, 0) + 1
                            )
                            if code == "overloaded" and not hint:
                                storm_stats["hint_missing"] += 1
                        continue
                    except (ConnectionError, OSError):
                        # wire chaos (reset/truncate/drop) with no
                        # retry wrapper: typed-equivalent, counted,
                        # not a finding
                        with lock:
                            storm_stats["typed"]["connection"] = (
                                storm_stats["typed"].get("connection", 0)
                                + 1
                            )
                        continue
                    except Exception as e:  # noqa: BLE001 — the finding
                        with lock:
                            storm_stats["untyped"] += 1
                            if len(summary["untyped_samples"]) < 5:
                                summary["untyped_samples"].append(
                                    "storm: " + repr(e)
                                )
                        continue
                    with lock:
                        if np.array_equal(out, refs[pi]):
                            storm_stats["ok"] += 1
                        else:
                            storm_stats["corrupt"] += 1

        bts = [
            threading.Thread(target=burst, args=(i,), daemon=True)
            for i in range(n)
        ]
        for t in bts:
            t.start()
        for t in bts:
            t.join(timeout=duration + 60.0)
        gate.burn_fn = steady_burn  # the brownout declaration lifts
        with lock:
            storm_stats["hung"] = sum(t.is_alive() for t in bts)

    threads = [
        threading.Thread(target=client_loop, args=(i,), daemon=True)
        for i in range(int(clients))
    ]
    storm_thread = (
        threading.Thread(target=storm_loop, daemon=True)
        if storm else None
    )
    with plan:
        for t in threads:
            t.start()
        if storm_thread is not None:
            storm_thread.start()
        for t in threads:
            # generous per-thread budget past the wall-clock: a thread
            # still alive after this is DEFINITIONALLY hung
            t.join(timeout=duration + 60.0)
        if storm_thread is not None:
            storm_thread.join(timeout=2 * duration + 90.0)
    hung = sum(t.is_alive() for t in threads)
    if storm_thread is not None:
        hung += int(storm_thread.is_alive())

    summary["hung"] = hung
    summary["mesh"] = engine._stepper.mesh_spec if engine._stepper else None
    summary["faults_fired"] = plan.fired()
    summary["fired_by_site"] = {
        s: plan.fired(s)
        for s in ("stepper.step", "stepper.verify", "server.reply",
                  "net.send", "net.delay", "scheduler.loop",
                  "kv.alloc", "kv.swap")
    }
    engine_stats = engine.stats()
    summary["engine"] = {
        k: engine_stats[k]
        for k in (
            "step_failures", "blame_probes", "internal_errors",
            "quarantines", "restarts", "watchdog_trips", "status",
            "completed", "rejected_overloaded", "pool_exhausted",
            "sampled_requests", "forked_slots",
        )
    }
    # QoS preemption ledger (counters are per scheduler GENERATION —
    # a supervisor restart rebuilds them at zero after the old
    # generation's stop() finalized its own ledger — so the pairing
    # invariant holds within the reported generation)
    summary["qos"] = {
        k: engine_stats[k]
        for k in ("preemptions", "resumes", "preempt_aborted",
                  "swap_in_failures", "swapped_failed",
                  "swapped_tokens")
    }
    summary["qos"]["paired"] = (
        engine_stats["preemptions"]
        == engine_stats["resumes"] + engine_stats["swap_in_failures"]
        + engine_stats["swapped_failed"]
    )
    if storm:
        storm_stats["accounting_exact"] = (
            storm_stats["attempts"]
            == storm_stats["ok"] + storm_stats["corrupt"]
            + sum(storm_stats["typed"].values())
            + storm_stats["untyped"]
        )
        summary["storm"] = storm_stats
        # the restart-proof shed ledger lives on the GATE (it rides
        # the batcher config through watchdog restarts); the batcher
        # counters below are the last scheduler generation's view
        summary["shed"] = {
            "gate": engine.shed_gate.state(),
            "shed_overloaded_last_gen": engine_stats.get(
                "shed_overloaded", 0
            ),
            "shed_clamped_last_gen": engine_stats.get(
                "shed_clamped", 0
            ),
        }
    if paged:
        pg = engine_stats["paged"]
        summary["paged"] = {
            k: pg[k]
            for k in ("enabled", "total_pages", "pages_in_use",
                      "shared_pages", "cow_copies", "exhaustions")
        }
    if speculative:
        summary["speculative"] = {
            k: engine_stats["speculative"][k]
            for k in ("windows", "mean_tokens_per_window",
                      "fallback_steps", "drafted_tokens",
                      "accepted_draft_tokens", "rejected_draft_tokens")
        }
    server.shutdown()  # joins the supervisor: every dump has landed
    if paged:
        # the pool ledger balances at shutdown: no slot holds a page,
        # and clearing the device prefix index (the one legitimate
        # remaining holder) returns the pool to empty — a preemption/
        # swap/restart path that leaked a page or a host-ladder entry
        # fails here
        st = engine._stepper
        slot_held = sorted(
            {p for t in st._tables for p in t}
        ) if st is not None else []
        if st is not None and st.prefix_index is not None:
            st.prefix_index.clear()
        in_use_after = (
            st._kv_alloc.pages_in_use if st is not None else 0
        )
        summary["paged"]["slot_held_pages_at_shutdown"] = slot_held
        summary["paged"]["pages_in_use_after_index_clear"] = in_use_after
        summary["paged"]["pool_balanced"] = (
            not slot_held and in_use_after == 0
        )
    # the post-mortem bar: one bundle PER watchdog trip, and every
    # bundle's recorder timeline names the injected seam that killed
    # the scheduler (fault.fired at scheduler.loop)
    trips = engine.stats()["watchdog_trips"]
    bundles = sorted(
        os.path.join(postmortem_dir, n)
        for n in os.listdir(postmortem_dir)
        if n.startswith("postmortem_") and n.endswith(".json")
    )
    named_seam = 0
    for path in bundles:
        with open(path) as f:
            bundle = json.load(f)
        sites = {
            e.get("site")
            for e in bundle["events"]
            if e["kind"] == "fault.fired"
        }
        if bundle["reason"] == "watchdog_trip" and (
            "scheduler.loop" in sites
        ):
            named_seam += 1
    summary["engine"]["watchdog_trips"] = trips
    summary["postmortems"] = len(bundles)
    summary["postmortems_naming_seam"] = named_seam
    shutil.rmtree(postmortem_dir, ignore_errors=True)
    # the compile ledger: warmup covered every program family, chaos
    # restarts re-warmed through the supervisor, so ZERO storms — a
    # mint of a new program on the serving path mid-soak means warmup
    # has a hole or a compile key regressed to traffic-dependent
    summary["compiles"] = engine.compile_ledger.snapshot()
    # the soak runs the OVERLAPPED loop (engine default): record the
    # bubble ledger so a zero-bubble regression shows up in the same
    # artifact as the chaos bars it must hold under
    summary["overlap"] = {
        "enabled": engine.batcher.overlap if engine.batcher else None,
        **(
            engine.batcher.overlap_ledger.snapshot()
            if engine.batcher else {}
        ),
    }
    summary["ok"] = (
        hung == 0
        and summary["compiles"]["storms"] == 0
        and summary["untyped_errors"] == 0
        and summary["corrupt_outputs"] == 0
        and summary["divergent_replays"] == 0
        and summary["grammar_violations"] == 0
        and summary["sampled_completed"] > 0
        and summary["trace_incomplete"] == 0
        and summary["trace_attempts"] > 0
        and trips >= 1
        and len(bundles) == trips
        and named_seam == len(bundles)
        # the QoS bars: every swap-out paired with a resume or a
        # typed failure, and (paged) the pool ledger balanced
        and summary["qos"]["paired"]
        and (not paged or summary["paged"]["pool_balanced"])
        # the storm bars: the burst's no-retry ledger is exact (every
        # attempt resolved ok or typed, none hung/untyped/corrupt),
        # every overloaded reply carried a retry hint, and the gate
        # actually shed under the burst (the brownout engaged — the
        # steady clients riding it out is what the identity and trace
        # bars above then prove)
        and (not storm or (
            storm_stats["hung"] == 0
            and storm_stats["untyped"] == 0
            and storm_stats["corrupt"] == 0
            and storm_stats["hint_missing"] == 0
            and storm_stats["accounting_exact"]
            and storm_stats["attempts"] > 0
            and summary["shed"]["gate"]["sheds"] >= 1
        ))
    )
    return summary


def run_disagg_soak(clients=4, duration=6.0, seed=0, model=None,
                    max_new=6, device=None) -> dict:
    """Chaos soak of the DISAGGREGATED serving path: a prefill worker
    and a decode worker behind a role-aware router, mixed streaming /
    non-streaming / sampled clients, the ``kv.transfer`` seam in the
    armed set, and BOTH workers hard-killed mid-soak (the prefill
    worker mid-transfer, the decode worker mid-resume) with
    replacements health-gated into rotation.

    Acceptance bar (the ``ok`` flag):

    - 0 hung clients / 0 untyped errors / 0 corrupt greedy outputs /
      0 divergent sampled replays (streamed or not — a resend-and-skip
      recovered stream must still assemble the canonical tokens);
    - the TRANSFER PAIRING invariant balanced at shutdown on the
      router's ledger: every dispatched ``kv.transfer`` hop ended in
      a relayed reply or a typed failure
      (``transfer_sends == transfer_ok + transfer_typed``);
    - completions on BOTH delivery modes, and at least one request
      completed AFTER each kill (the replacements actually served).
    """
    import numpy as np

    from distkeras_tpu_torch.faults import FaultPlan
    from distkeras_tpu_torch.networking import RetryPolicy
    from distkeras_tpu_torch.predictors import CachedSequenceGenerator
    from distkeras_tpu_torch.serving import (
        FleetRouter,
        SamplingParams,
        ServingClient,
        ServingEngine,
        ServingError,
        ServingServer,
    )

    if model is None:
        model = default_model(device)

    import numpy as _np

    warm_prompt = _np.arange(1, 5, dtype=_np.int32)

    def boot(role, warm=False):
        eng = ServingEngine(
            model, num_slots=4, queue_capacity=8, prefix_cache=False,
            prefill_chunk=8, watchdog_interval=1.0, watchdog_grace=60.0,
            max_restarts=10_000, restart_backoff=0.01, role=role,
            device=device,
        )
        srv = ServingServer(eng, retry_after_ms=20.0).start()
        if warm:
            # compile the replacement's programs OFF the serving path:
            # a replacement whose first live request pays multi-second
            # XLA compiles (on a contended soak machine) would spend
            # the whole post-kill window compiling instead of serving.
            # warmup() is SEAM-FREE (the supervisor's restart path);
            # the live warm drives the remaining admission/transfer
            # programs BEST-EFFORT — the chaos plan is armed, so an
            # injected failure here is expected and just retried
            from distkeras_tpu_torch.serving import ServingError, kv_transfer

            eng._stepper.warmup()
            for _ in range(4):
                try:
                    if role == "prefill":
                        eng.prefill(warm_prompt, 2)
                    else:
                        eng.generate(warm_prompt, 2)
                        st = eng._stepper
                        st.admit(0, warm_prompt, max_new=2)
                        state = st.swap_out(0)
                        st.release(0)
                        eng.wait(eng.resume(kv_transfer.encode_state(
                            state, prompt_len=int(warm_prompt.size)
                        ), 2))
                    break
                except ServingError:
                    continue  # an armed seam fired mid-warm; retry
        return eng, srv

    pre_eng, pre_srv = boot("prefill")
    dec_eng, dec_srv = boot("decode")
    router = FleetRouter(
        endpoints=[(pre_srv.host, pre_srv.port),
                   (dec_srv.host, dec_srv.port)],
        health_interval=0.1, eject_after=2, connect_timeout=2.0,
        retry_after_ms=20.0,
    ).start()
    for srv in (pre_srv, dec_srv):
        assert router.wait_in_rotation((srv.host, srv.port))

    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(0, 61, n).astype(np.int32) for n in (3, 5, 7, 9)
    ]
    ref_gen = CachedSequenceGenerator(model, device=device)
    refs = [ref_gen.generate(p[None], steps=max_new)[0] for p in prompts]
    sampled_reqs = [
        (prompts[i % len(prompts)],
         SamplingParams(temperature=0.8, seed=100 + i))
        for i in range(3)
    ]
    # canonical sampled outputs, captured FAULT-FREE through the
    # DISAGG path itself (prefill worker -> transfer -> decode worker)
    with ServingClient("127.0.0.1", router.port) as warm:
        for p in prompts:
            warm.generate(p, max_new)
        canon = [
            warm.generate(p, max_new, sampling=sp.to_wire())
            for p, sp in sampled_reqs
        ]

    plan = (
        FaultPlan(seed=seed)
        # the transfer seam, BOTH directions (no ``when`` filter)
        .arm("kv.transfer", times=None, probability=0.05)
        .arm("stepper.step", times=None, probability=1.0 / 12)
        .arm("stepper.prefill", times=None, probability=0.02)
        .arm("server.reply", action="drop", times=None, probability=0.02)
        .arm("net.send", action="reset", times=None, probability=0.01)
    )

    lock = threading.Lock()
    summary = {
        "completed": 0,
        "streamed_completed": 0,
        "sampled_completed": 0,
        "completed_after_kill": {"prefill": 0, "decode": 0},
        "typed_errors": {},
        "untyped_errors": 0,
        "untyped_samples": [],
        "corrupt_outputs": 0,
        "divergent_replays": 0,
    }
    t0 = time.monotonic()
    # the clients run until the coordinator says stop: both kills done
    # PLUS a grace window for the replacements to actually serve (a
    # fixed wall-clock under a contended machine can end before the
    # second replacement ever sees a request); the hard backstop below
    # bounds a wedged killer
    stop_evt = threading.Event()
    hard_stop = t0 + 4.0 * float(duration)
    kills_done = {"prefill": False, "decode": False}

    def client_loop(ci):
        policy = RetryPolicy(
            max_attempts=30, base_delay=0.01, max_delay=0.2,
            budget=3 * duration + 30.0, seed=seed * 1000 + ci,
        )
        crng = np.random.default_rng(seed * 100 + ci)
        with ServingClient("127.0.0.1", router.port,
                           retry=policy) as c:
            while not stop_evt.is_set() and (
                time.monotonic() < hard_stop
            ):
                si = None
                if crng.random() < 0.6:
                    pi = int(crng.integers(0, len(prompts)))
                    prompt, sp = prompts[pi], None
                    want = refs[pi]
                else:
                    si = int(crng.integers(0, len(sampled_reqs)))
                    prompt, sp = sampled_reqs[si]
                    sp = sp.to_wire()
                    want = canon[si]
                streamed = bool(crng.random() < 0.5)
                try:
                    if streamed:
                        st = c.generate_stream(
                            prompt, max_new, sampling=sp
                        )
                        for _ in st:
                            pass
                        out = st.sequence
                    else:
                        out = c.generate(prompt, max_new, sampling=sp)
                except ServingError as e:
                    code = getattr(e, "code", type(e).__name__)
                    with lock:
                        summary["typed_errors"][code] = (
                            summary["typed_errors"].get(code, 0) + 1
                        )
                    continue
                except (ConnectionError, OSError) as e:
                    # a retry-budget-exhausted wire death during the
                    # kill windows is a typed-equivalent outcome (the
                    # soak_fleet precedent): counted, not a finding
                    with lock:
                        summary["typed_errors"]["connection"] = (
                            summary["typed_errors"].get("connection", 0)
                            + 1
                        )
                    continue
                except Exception as e:  # noqa: BLE001 — the finding
                    with lock:
                        summary["untyped_errors"] += 1
                        if len(summary["untyped_samples"]) < 5:
                            summary["untyped_samples"].append(repr(e))
                    continue
                with lock:
                    if np.array_equal(out, want):
                        summary["completed"] += 1
                        if streamed:
                            summary["streamed_completed"] += 1
                        if si is not None:
                            summary["sampled_completed"] += 1
                        for k, done in kills_done.items():
                            if done:
                                summary["completed_after_kill"][k] += 1
                    elif si is None:
                        summary["corrupt_outputs"] += 1
                    else:
                        summary["divergent_replays"] += 1

    def killer():
        """Hard-kill each worker mid-traffic, boot a WARMED
        replacement, and health-gate it into rotation — the prefill
        worker first (mid-transfer deaths), then the decode worker
        (mid-resume). Then grant the grace window and stop the
        clients."""
        nonlocal pre_srv, dec_srv
        try:
            plans = [
                ("prefill", t0 + duration * 0.25),
                ("decode", t0 + duration * 0.5),
            ]
            for role, at in plans:
                delay = at - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                old = pre_srv if role == "prefill" else dec_srv
                old.shutdown(drain=False)  # RST everything in flight
                router.remove_replica((old.host, old.port))
                _eng, srv = boot(role, warm=True)
                router.add_replica((srv.host, srv.port))
                router.wait_in_rotation(
                    (srv.host, srv.port), timeout=30.0
                )
                if role == "prefill":
                    pre_srv = srv
                else:
                    dec_srv = srv
                with lock:
                    kills_done[role] = True
            # grace: the replacements must get real traffic before
            # the clients stand down
            time.sleep(max(2.0, 0.5 * duration))
        except Exception as e:  # noqa: BLE001 — a dead killer is a finding
            with lock:
                summary.setdefault("kill_errors", []).append(repr(e))
        finally:
            stop_evt.set()

    threads = [
        threading.Thread(target=client_loop, args=(i,), daemon=True)
        for i in range(int(clients))
    ]
    kill_thread = threading.Thread(target=killer, daemon=True)
    with plan:
        for t in threads:
            t.start()
        kill_thread.start()
        kill_thread.join(timeout=4.0 * duration + 90.0)
        stop_evt.set()  # backstop: clients stand down regardless
        for t in threads:
            t.join(timeout=duration + 60.0)
    hung = sum(t.is_alive() for t in threads) + int(
        kill_thread.is_alive()
    )
    summary["hung"] = hung
    summary["faults_fired"] = plan.fired()
    summary["fired_by_site"] = {
        s: plan.fired(s)
        for s in ("kv.transfer", "stepper.step", "stepper.prefill",
                  "server.reply", "net.send")
    }
    rstats = router.stats()
    summary["router"] = {
        k: rstats[k]
        for k in ("disagg_routed", "transfer_sends", "transfer_ok",
                  "transfer_typed", "transfer_retries", "failovers",
                  "ejections")
    }
    # the transfer pairing invariant, balanced at shutdown
    summary["router"]["transfer_paired"] = (
        rstats["transfer_sends"]
        == rstats["transfer_ok"] + rstats["transfer_typed"]
    )
    # the compile ledgers of the FINAL workers (post-kill
    # replacements), on the summary for triage. Reported, not gated:
    # replacements warm BEST-EFFORT under the armed chaos plan (an
    # injected failure can cut the live warm short by design), so a
    # post-warmup mint here is expected churn, not the storm class
    # the main soak's fault-free-warmed engine asserts on.
    summary["compiles"] = {
        role: eng.compile_ledger.snapshot()
        for role, eng in (
            ("prefill", pre_srv.engine), ("decode", dec_srv.engine),
        )
    }
    router.shutdown()
    for srv in (pre_srv, dec_srv):
        try:
            srv.shutdown()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
    summary["ok"] = (
        hung == 0
        and summary["untyped_errors"] == 0
        and summary["corrupt_outputs"] == 0
        and summary["divergent_replays"] == 0
        and not summary.get("kill_errors")
        and summary["completed"] > 0
        and summary["streamed_completed"] > 0
        and summary["sampled_completed"] > 0
        and summary["completed_after_kill"]["prefill"] > 0
        and summary["completed_after_kill"]["decode"] > 0
        and summary["router"]["transfer_paired"]
        and summary["router"]["disagg_routed"] > 0
    )
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--duration", type=float, default=5.0,
                    help="soak wall-clock seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-every", type=int, default=7,
                    help="mean scheduler steps between injected step faults")
    ap.add_argument("--no-speculative", action="store_true",
                    help="serve plain decode instead of self-draft "
                         "speculative (disarms the stepper.verify seam's "
                         "traffic)")
    ap.add_argument("--no-storm", action="store_true",
                    help="skip the overload-storm phase and run "
                         "without the adaptive shed gate (the "
                         "pre-overload-defense engine door)")
    ap.add_argument("--dense", action="store_true",
                    help="serve the dense slot bank instead of the "
                         "paged KV cache (disarms the kv.alloc seam's "
                         "traffic)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the GPU)")
    ap.add_argument("--mesh", default=None,
                    help="serve tensor-parallel over a serving mesh "
                         "(e.g. tp:2): N cards, or with --cpu N shards "
                         "on the CPU device")
    ap.add_argument("--disagg", action="store_true",
                    help="soak the DISAGGREGATED path instead: prefill "
                         "+ decode workers behind a role-aware router, "
                         "kv.transfer in the armed set, both workers "
                         "hard-killed mid-soak with replacements")
    args = ap.parse_args(argv)
    device = check_device(args.cpu)

    if args.disagg:
        summary = run_disagg_soak(
            clients=args.clients, duration=args.duration,
            seed=args.seed, device=device,
        )
        json.dump(summary, sys.stdout, indent=2, default=str)
        print()
        if not summary["ok"]:
            print("DISAGG SOAK FAILED (see summary above)",
                  file=sys.stderr)
            return 1
        return 0

    summary = run_soak(
        clients=args.clients, duration=args.duration, seed=args.seed,
        fault_every=args.fault_every,
        speculative=not args.no_speculative,
        paged=not args.dense, mesh=args.mesh,
        storm=not args.no_storm, device=device,
    )
    json.dump(summary, sys.stdout, indent=2, default=str)
    print()
    if not summary["ok"]:
        print("SOAK FAILED: hung requests, untyped errors, or corrupt "
              "outputs (see summary above)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
