"""Multi-tenant QoS in the port against the JAX package: the policy, the
scheduler's preemption paths, and the preempt/resume identity on the LM.

Three tiers, the JAX package's ``tests/test_qos.py`` layering:

- the policy (pure host logic): the port's ``_QosQueues``, ``QosPolicy``,
  ``TokenBucket`` (with an injected clock), ``as_bucket`` and
  ``fold_tenant`` driven through the same scripted operations as JAX's —
  the pop order, virtual times and refusal waits must be identical;
- the scheduler on a fake swap-capable stepper (one scripted drive run on
  the JAX batcher and on the port's, under both loop shapes): admission
  order, victim selection, the preemption budget, swap-out and swap-in
  failures, stop racing a swap, the in-flight snapshot and the per-tenant
  counters — every request's tokens, the iteration each finished in, the
  swaps and the books must be JAX's;
- on the LM (JAX's small LM, its weights bridged): a request preempted
  mid-decode and resumed replies what JAX's engine replies, token for
  token, greedy and sampled, dense and paged, in both loop shapes;
  ``swap_out``'s state against JAX's; the ``kv.swap`` chaos drill; the
  recorder events; tenant and priority over the wire; priority winning
  under saturation through the engine.

The ``gpu``-marked case swaps a slot out and in on the card against its
CPU run (``python -m pytest --noconftest tests/test_torch_qos.py -m gpu``).
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.serving import (
    ContinuousBatcher,
    InternalError,
    QosPolicy,
    ServeRequest,
    ServingEngine,
)
from distkeras_tpu_torch.serving.engine import DecodeStepper
from distkeras_tpu_torch.serving.sampling import SamplingParams
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)
#: K/V of the same admission, port against JAX: the two packages' matmuls
#: differ in the last ulps (the paged tests' bridge tolerance)
KV_ATOL = 1e-5

PKG = {"torch": "distkeras_tpu_torch", "jax": "distkeras_tpu"}


def _mod(side, name):
    return importlib.import_module(f"{PKG[side]}.serving.{name}")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    leaked = faults._ACTIVE
    if leaked is not None:
        leaked.deactivate()
        pytest.fail("test leaked an active FaultPlan")


# ------------------------------------------------------------- the policy


class _Req:
    """What ``_QosQueues`` reads of a request."""

    def __init__(self, rid, tenant, priority):
        self.id, self.tenant, self.priority = rid, tenant, priority


#: scripted operation sequences; each op's result lands in the record
QUEUE_SCRIPTS = {
    "priority_classes": [
        ("append", "a", 0), ("append", "b", 2), ("append", "a", 1),
        ("pop",), ("pop",), ("pop",), ("len",),
    ],
    "wfq_follows_charges": [
        ("policy", {"heavy": 3.0, "light": 1.0}),
        *[("append", "light", 0)] * 3, *[("append", "heavy", 0)] * 3,
        ("pop",), ("charge", "heavy", 9), ("pop",), ("charge", "light", 9),
        ("pop",), ("snap",), ("iter",),
    ],
    "appendleft_keeps_class_head": [
        ("append", "t", 0), ("append", "t", 0), ("pop",), ("pushback",),
        ("pop",), ("iter",),
    ],
    "idle_tenant_lags_to_floor": [
        ("append", "busy", 0), ("append", "busy", 0), ("pop",),
        ("charge", "busy", 100), ("append", "late", 0), ("snap",),
        ("pop",), ("pop",),
    ],
    "idle_reset_clears_debt": [
        ("append", "old", 0), ("pop",), ("charge", "old", 10_000),
        ("len",), ("append", "new", 0), ("append", "old", 0), ("snap",),
        ("pop",), ("pop",),
    ],
    "mixed_classes_and_weights": [
        ("policy", {"x": 2.0}),
        ("append", "x", 1), ("append", "y", 1), ("append", "z", 0),
        ("append", "y", 1), ("pop",), ("charge", "x", 7), ("pop",),
        ("charge", "y", 3), ("append", "x", 1), ("pop",), ("pushback",),
        ("iter",), ("pop",), ("pop",), ("pop",), ("snap",), ("len",),
    ],
    "empty_pop_raises": [("pop",), ("append", "a", 0), ("pop",), ("pop",)],
}

BUCKET_SCRIPTS = {
    "grant_refuse_refill": [
        ("new", 2.0, 2.0), ("take", 1), ("take", 1), ("take", 1),
        ("advance", 0.5), ("take", 1), ("take", 1), ("tokens",),
    ],
    "sub_unit_rate": [("new", 0.5, None), ("burst",), ("take", 1),
                      ("take", 1), ("advance", 1.0), ("tokens",)],
    "big_take_and_cap": [
        ("new", 3.0, 5.0), ("take", 4.5), ("take", 2.0), ("advance", 10.0),
        ("tokens",), ("take", 5.0), ("take", 0.25),
    ],
    "bad_specs": [("new", 0.0, None), ("new", 1.0, 0.5)],
}


def _run_queue(side, script):
    qos = _mod(side, "qos")
    q = qos._QosQueues(qos.QosPolicy())
    out, last = [], None
    rid = 0
    for op in script:
        kind = op[0]
        if kind == "policy":
            q = qos._QosQueues(qos.QosPolicy(weights=op[1]))
        elif kind == "append":
            rid += 1
            q.append(_Req(rid, op[1], op[2]))
        elif kind == "pop":
            try:
                last = q.popleft()
                out.append(("pop", last.id, last.tenant, last.priority))
            except IndexError as e:
                out.append(("pop", "IndexError", str(e)))
        elif kind == "pushback":
            q.appendleft(last)
        elif kind == "charge":
            q.charge(op[1], op[2])
        elif kind == "snap":
            out.append(("snap", q.service_snapshot()))
        elif kind == "len":
            out.append(("len", len(q), bool(q)))
        elif kind == "iter":
            out.append(("iter", [r.id for r in q]))
    return out


def _run_bucket(side, script):
    qos = _mod(side, "qos")
    clock = [0.0]
    out, b = [], None
    for op in script:
        kind = op[0]
        if kind == "new":
            try:
                b = qos.TokenBucket(op[1], op[2], clock=lambda: clock[0])
                out.append(("new", b.rate, b.burst))
            except ValueError as e:
                out.append(("new", "ValueError", str(e)))
        elif kind == "take":
            out.append(("take", b.take(op[1])))
        elif kind == "advance":
            clock[0] += op[1]
        elif kind == "tokens":
            out.append(("tokens", b.tokens))
        elif kind == "burst":
            out.append(("burst", b.burst))
    return out


def _run_policy(side):
    qos = _mod(side, "qos")
    out = []
    for kw in ({}, {"weights": {"a": 2}, "preempt": False,
                    "max_preemptions": 0}, {"weights": {"a": 0}},
               {"default_weight": -1}, {"max_preemptions": -1}):
        try:
            p = qos.QosPolicy(**kw)
            out.append((p.describe(), p.weight("a"), p.weight("zz")))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    seen: set = set()
    out.append([qos.fold_tenant(seen, f"t{i % 70}") for i in range(140)])
    out.append(sorted(seen))
    out.append((qos.MAX_TENANT_LABELS, qos.OTHER_TENANTS))
    for spec in (None, 5.0, {"rate": 2, "burst": 7}, (3, 9), [4, 1]):
        b = qos.as_bucket(spec)
        out.append(None if b is None else (b.rate, b.burst))
    b = qos.TokenBucket(1.0)
    out.append(qos.as_bucket(b) is b)
    return out


@pytest.mark.parametrize(
    "script",
    [f"queue:{k}" for k in QUEUE_SCRIPTS]
    + [f"bucket:{k}" for k in BUCKET_SCRIPTS] + ["policy"],
)
def test_policy_matches_jax(script):
    """The same scripted operations through the port's and JAX's policy
    objects: identical pop order, virtual times, grants and refusal
    waits, folds and coercions (exact float equality: the arithmetic is
    the same Python)."""
    kind, _, name = script.partition(":")
    if kind == "queue":
        run = lambda side: _run_queue(side, QUEUE_SCRIPTS[name])  # noqa: E731
    elif kind == "bucket":
        run = lambda side: _run_bucket(side, BUCKET_SCRIPTS[name])  # noqa: E731
    else:
        run = _run_policy
    got = run("torch")
    assert got == run("jax")
    # the JAX test suite's own bars on the port's record
    if name == "priority_classes":
        assert [r[3] for r in got if r[0] == "pop"] == [2, 1, 0]
    elif name == "wfq_follows_charges":
        assert [r[2] for r in got if r[0] == "pop"] == ["heavy", "light",
                                                        "heavy"]
        assert ("snap", {"heavy": 3.0, "light": 9.0}) in got
    elif name == "idle_tenant_lags_to_floor":
        assert got[1][1]["late"] == 100.0
    elif name == "idle_reset_clears_debt":
        assert got[2] == ("snap", {"new": 0.0, "old": 0.0})
    elif name == "grant_refuse_refill":
        assert got[1:6] == [("take", 0.0), ("take", 0.0), ("take", 0.5),
                            ("take", 0.0), ("take", 0.5)]
    elif name == "sub_unit_rate":
        assert got[1] == ("burst", 1.0) and got[3] == ("take", 2.0)


# ------------------------------------- the scheduler on a fake swap stepper


class FakeSwapStepper:
    """Swap-capable fake of the device face (JAX's ``FakeSwapStepper``):
    a request's n-th token is ``1000 + n`` wherever it runs, the counter
    rides the swap state, so a resumed stream continues where it left off
    and every swap is observable. ``step_async`` hands the tokens out at
    ``collect`` (the overlapped loop's face)."""

    def __init__(self, num_slots=2, max_len=32):
        self.num_slots, self.max_len = num_slots, max_len
        self._n = np.zeros(num_slots, int)
        self._left = np.zeros(num_slots, int)
        self.swapped_out, self.swapped_in = [], []
        self.fail_swap_out = self.fail_swap_in = False

    def begin_admit(self, slot, prompt, **kw):
        self._n[slot] = 0
        self._left[slot] = max(0, len(np.asarray(prompt)) - 1)
        return int(self._left[slot])

    def prefill_chunk(self, slot, budget):
        n = min(int(budget), int(self._left[slot]))
        self._left[slot] -= n
        return int(self._left[slot])

    def release(self, slot):
        pass

    def step(self, active):
        toks = np.full(self.num_slots, -1)
        for i in np.flatnonzero(active):
            self._n[i] += 1
            toks[i] = 1000 + self._n[i]
        return toks

    def step_async(self, active):
        toks = self.step(active)

        class Handle:
            def ready(self):
                return True

            def collect(self):
                return toks

        return Handle()

    def swap_out(self, slot):
        if self.fail_swap_out:
            raise RuntimeError("injected swap-out failure")
        self.swapped_out.append(slot)
        return {"len": int(self._n[slot]) + 1, "n": int(self._n[slot])}

    def swap_in(self, slot, state, max_new=None):
        if self.fail_swap_in:
            raise RuntimeError("injected swap-in failure")
        self.swapped_in.append(slot)
        self._n[slot] = state["n"]
        self._left[slot] = 0


BOOKS = ("preemptions", "resumes", "preempt_aborted", "swap_in_failures",
         "swapped_failed", "swapped_tokens", "completed", "internal_errors",
         "tokens_generated")


class _Drive:
    """One scheduler scenario on one package's batcher: ``req`` makes its
    requests, ``step`` advances and stamps the iteration each request
    finished in, ``record`` is what is compared across the packages."""

    def __init__(self, side, num_slots, overlap, **qos_kw):
        sched = _mod(side, "scheduler")
        qos = _mod(side, "qos")
        self.sched = sched
        self.st = FakeSwapStepper(num_slots=num_slots)
        self.bat = sched.ContinuousBatcher(
            self.st, qos=qos.QosPolicy(**qos_kw), queue_capacity=16,
            overlap=overlap,
        )
        self.reqs, self.done_at, self.iters = {}, {}, 0

    def req(self, name, plen=2, max_new=4, tenant="default", priority=0,
            submit=True):
        r = self.sched.ServeRequest(np.arange(1, plen + 1), max_new,
                                    tenant=tenant, priority=priority)
        self.reqs[name] = r
        if submit:
            self.bat.submit(r)
        return r

    def step(self, n=1, until=None):
        for _ in range(n):
            self.bat.step()
            self.iters += 1
            for k, r in self.reqs.items():
                if r.done and k not in self.done_at:
                    self.done_at[k] = self.iters
            if until is not None and until():
                return

    def drain(self, limit=300):
        self.step(limit, until=lambda: all(r.done for r in
                                           self.reqs.values()))
        assert all(r.done for r in self.reqs.values()), "did not drain"

    def record(self):
        s = self.bat.stats()
        return {
            "tokens": {k: list(r.tokens) for k, r in self.reqs.items()},
            "errors": {k: None if r.error is None else
                       (type(r.error).__name__, str(r.error))
                       for k, r in self.reqs.items()},
            "done_at": dict(self.done_at),
            "preemptions": {k: r.preemptions for k, r in self.reqs.items()},
            "swapped_out": list(self.st.swapped_out),
            "swapped_in": list(self.st.swapped_in),
            "books": {k: s[k] for k in BOOKS},
            "qos": s["qos"],
        }


def _scenario(name, side, overlap):
    if name == "priority_admission_order":
        d = _Drive(side, 1, overlap, preempt=False)
        d.req("running", max_new=6, tenant="a", priority=1)
        d.step()
        d.req("lo", max_new=2, tenant="a", priority=0)
        d.req("hi", max_new=2, tenant="b", priority=2)
        d.drain()
    elif name == "victim_lowest_priority_fewest_tokens":
        d = _Drive(side, 2, overlap, preempt=True, max_preemptions=2)
        d.req("a", max_new=8, tenant="a", priority=1)
        d.step()
        d.req("b", max_new=8, tenant="b", priority=0)
        d.step(2)
        d.req("hi", max_new=2, tenant="c", priority=2)
        d.step(4, until=lambda: d.st.swapped_out)
        d.drain()
    elif name == "budget_bounds_displacement":
        d = _Drive(side, 1, overlap, preempt=True, max_preemptions=1)
        lo = d.req("lo", max_new=10, tenant="a", priority=0)
        d.step()
        d.req("hi1", max_new=2, tenant="b", priority=2)
        d.step(3, until=lambda: lo.preemptions)
        d.step(30, until=lambda: d.reqs["hi1"].done)
        d.step(30, until=lambda: lo._swap is None and not lo.done and any(
            r is lo for r in d.bat._slots))
        d.req("hi2", max_new=2, tenant="b", priority=2)
        d.drain()
    elif name == "failed_swap_out_aborts":
        d = _Drive(side, 1, overlap, preempt=True)
        d.st.fail_swap_out = True
        d.req("lo", max_new=4, tenant="a", priority=0)
        d.step()
        d.req("hi", max_new=2, tenant="b", priority=2)
        d.drain()
    elif name == "failed_swap_in_fails_only_victim":
        d = _Drive(side, 1, overlap, preempt=True)
        d.req("lo", max_new=6, tenant="a", priority=0)
        d.step()
        d.st.fail_swap_in = True
        d.req("hi", max_new=2, tenant="b", priority=2)
        d.drain()
        d.req("next", max_new=2)
        d.drain()
    elif name == "stop_racing_swap":
        d = _Drive(side, 1, overlap, preempt=True)
        lo = d.req("lo", max_new=8, tenant="a", priority=0)
        d.step()
        d.req("hi", max_new=8, tenant="b", priority=2)
        d.step(4, until=lambda: lo._swap is not None)
        d.snapshot = [(r["state"], r["tenant"], r["priority"],
                       r["preemptions"], r["slot"])
                      for r in d.bat.inflight_snapshot()]
        d.bat.stop(error=d.sched.InternalError("restart"))
        d.swap_dropped = lo._swap is None
    elif name == "tenant_counters":
        d = _Drive(side, 1, overlap, preempt=True)
        d.req("lo", max_new=6, tenant="acme", priority=0)
        d.step()
        d.req("hi", max_new=2, tenant="live", priority=2)
        d.drain()
        d.labeled = sorted(
            (s["name"], s["labels"]["tenant"], s["value"])
            for s in d.bat.registry.snapshot()
            if s["name"] in ("serving_preemptions", "serving_swapped_tokens")
        )
    elif name == "wfq_shares":
        d = _Drive(side, 1, overlap, weights={"a": 1.0, "b": 3.0},
                   preempt=False)
        for i in range(8):
            for t in ("a", "b"):
                d.req(f"{t}{i}", max_new=4, tenant=t)
        d.drain()
    return d


SCENARIOS = ("priority_admission_order", "victim_lowest_priority_fewest_tokens",
             "budget_bounds_displacement", "failed_swap_out_aborts",
             "failed_swap_in_fails_only_victim", "stop_racing_swap",
             "tenant_counters", "wfq_shares")


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sequential", "overlapped"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_scheduler_scenario_matches_jax(name, overlap):
    """The scenario on the port's batcher records what it records on
    JAX's, in the same loop shape, and the JAX suite's bars hold."""
    d = _scenario(name, "torch", overlap)
    j = _scenario(name, "jax", overlap)
    rec = d.record()
    assert rec == j.record()
    books = rec["books"]
    # pairing at quiescence: every swap-out ends in a resume or typed
    assert books["preemptions"] == (books["resumes"]
                                    + books["swap_in_failures"]
                                    + books["swapped_failed"])
    assert rec["qos"]["enabled"] is True
    if name == "priority_admission_order":
        assert rec["done_at"]["hi"] < rec["done_at"]["lo"]
        assert rec["swapped_out"] == []
    elif name == "victim_lowest_priority_fewest_tokens":
        assert rec["preemptions"] == {"a": 0, "b": 1, "hi": 0}
        assert rec["tokens"]["b"] == list(range(1001, 1009))
        assert books["preemptions"] == books["resumes"] == 1
    elif name == "budget_bounds_displacement":
        assert rec["preemptions"]["lo"] == 1 and books["preemptions"] == 1
        assert rec["tokens"]["lo"] == list(range(1001, 1011))
    elif name == "failed_swap_out_aborts":
        assert rec["errors"] == {"lo": None, "hi": None}
        assert books["preemptions"] == 0 and books["preempt_aborted"] >= 1
    elif name == "failed_swap_in_fails_only_victim":
        assert rec["errors"]["hi"] is None and rec["errors"]["next"] is None
        assert rec["errors"]["lo"][0] == "InternalError"
        assert "swap-in failed" in rec["errors"]["lo"][1]
        assert books["swap_in_failures"] == 1
    elif name == "stop_racing_swap":
        assert d.swap_dropped and books["swapped_failed"] == 1
        assert d.snapshot == j.snapshot
        assert ("swapped", "a", 0, 1, None) in d.snapshot
        assert any(r[1] == "b" and r[2] == 2 for r in d.snapshot)
        with pytest.raises(InternalError):
            d.reqs["lo"].result(0)
    elif name == "tenant_counters":
        assert d.labeled == j.labeled
        assert ("serving_preemptions", "acme", 1) in d.labeled
    elif name == "wfq_shares":
        order = sorted(d.done_at, key=lambda k: (d.done_at[k], k))
        first = [k[0] for k in order[: len(order) // 2]]
        assert first.count("b") >= 2 * first.count("a")


# ----------------------------------------------------------- on the LM


@pytest.fixture(scope="module")
def lms():
    import jax

    from distkeras_tpu.models import zoo as jzoo

    jlm = jzoo.transformer_lm(**LM, seed=0)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    return jlm, lm


def _stepper(side, lm, **kw):
    if side == "jax":
        from distkeras_tpu.serving.engine import DecodeStepper as JStepper

        return JStepper(lm, **kw)
    return DecodeStepper(lm, device="cpu", **kw)


def _preempted_run(side, lm, paged, overlap, sampling=None, lo_new=10,
                   hi_new=4, seed=7):
    """JAX's drive: a 1-slot bank where the low-priority request is
    preempted mid-decode by a high-priority arrival, then both finish."""
    sched = _mod(side, "scheduler")
    qos = _mod(side, "qos")
    rng = np.random.default_rng(seed)
    p_lo = rng.integers(0, 61, 7).astype(np.int32)
    p_hi = rng.integers(0, 61, 5).astype(np.int32)
    st = _stepper(side, lm, num_slots=1, paged=paged, page_size=4)
    bat = sched.ContinuousBatcher(
        st, qos=qos.QosPolicy(preempt=True, max_preemptions=3),
        queue_capacity=8, overlap=overlap,
    )
    if sampling is not None:
        sampling = _mod(side, "sampling").SamplingParams(**sampling)
    lo = sched.ServeRequest(p_lo, lo_new, tenant="batch", priority=0,
                            sampling=sampling)
    hi = sched.ServeRequest(p_hi, hi_new, tenant="live", priority=2)
    bat.submit(lo)
    for _ in range(30):
        bat.step()
        if len(lo.tokens) >= 3:
            break
    assert len(lo.tokens) >= 3
    bat.submit(hi)
    for _ in range(120):
        bat.step()
        if lo.done and hi.done:
            break
    assert lo.done and hi.done
    return lo, hi, st, bat.stats()


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sequential", "overlapped"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_preempt_resume_matches_jax_engine(lms, paged, overlap, sampled):
    """ACCEPTANCE: a stream preempted mid-decode (KV to the host, slot and
    pages freed, restored later) replies what JAX's stepper and batcher
    reply for the same drive, token for token — and what an uninterrupted
    decode of the same request replies (the position-keyed RNG resumes at
    the saved counter, so sampled streams hold too)."""
    jlm, lm = lms
    sp = {"temperature": 0.8, "seed": 42} if sampled else None
    lo, hi, st, stats = _preempted_run("torch", lm, paged, overlap, sp)
    jlo, jhi, _, jstats = _preempted_run("jax", jlm, paged, overlap, sp)
    np.testing.assert_array_equal(lo.result(1), jlo.result(1))
    np.testing.assert_array_equal(hi.result(1), jhi.result(1))
    assert stats["preemptions"] == stats["resumes"] >= 1
    assert stats["preemptions"] == jstats["preemptions"]
    # the uninterrupted reference, on the port alone
    solo_st = DecodeStepper(lm, num_slots=1, paged=paged, page_size=4,
                            device="cpu")
    bat = ContinuousBatcher(solo_st, queue_capacity=8)
    solo = bat.submit(ServeRequest(
        lo.prompt, 10, sampling=None if sp is None else SamplingParams(**sp)))
    while not solo.done:
        bat.step()
    np.testing.assert_array_equal(lo.result(1), solo.result(1))
    if paged:
        assert not {p for t in st._tables for p in t}  # all released


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_swap_out_state_matches_jax(lms, paged):
    """``swap_out`` of the same admitted slot after the same three steps:
    JAX's keys, lengths, context row (int32), sampler state and shapes
    exactly; the K/V rows within ``KV_ATOL`` (independent matmuls). The
    format pin is bit for bit: JAX's state swapped into the port and
    swapped out again is JAX's arrays bit for bit, and the port then
    decodes JAX's continuation of it."""
    jlm, lm = lms
    p = np.random.default_rng(5).integers(0, 61, 9).astype(np.int32)
    kw = dict(num_slots=2, paged=paged, page_size=4)
    sj, spt = _stepper("jax", jlm, **kw), _stepper("torch", lm, **kw)
    sampling = {"temperature": 0.7, "seed": 3}
    for side, st in (("jax", sj), ("torch", spt)):
        params = _mod(side, "sampling").SamplingParams(**sampling)
        st.admit(1, p, max_new=10, sampling=params)
        for _ in range(3):
            st.step(np.array([False, True]))
    want, got = sj.swap_out(1), spt.swap_out(1)
    assert set(got) == set(want)
    for k in ("len", "spos", "seed", "grammar", "spec_prompt"):
        assert got[k] == want[k], k
    assert got["ctx"].dtype == want["ctx"].dtype == np.int32
    np.testing.assert_array_equal(got["ctx"], want["ctx"])
    assert got["params"].temperature == want["params"].temperature
    assert got["params"].seed == want["params"].seed
    for (jk, jv), (pk, pv) in zip(want["kv"], got["kv"]):
        for a, b in ((jk, pk), (jv, pv)):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(b, a, atol=KV_ATOL, rtol=0)
    # the bit-for-bit pin through the port's restore
    spt.release(1)
    spt.swap_in(0, want, max_new=7)
    again = spt.swap_out(0)
    np.testing.assert_array_equal(again["ctx"], want["ctx"])
    for (jk, jv), (pk, pv) in zip(want["kv"], again["kv"]):
        assert np.array_equal(pk, jk) and np.array_equal(pv, jv)
    # and JAX's continuation: JAX resumes the same state in its own slot 0
    sj.release(1)
    sj.swap_in(0, want, max_new=7)
    one = np.array([True, False])
    cont = [int(spt.step(one)[0]) for _ in range(6)]
    jcont = [int(sj.step(one)[0]) for _ in range(6)]
    assert cont == jcont


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_warmups_leave_no_autograd_history(lms, paged):
    """The warm-ups run without autograd: afterwards no cache carries a
    graph, a finished prefill publishes its rungs to the store (no prefix
    fetch failure) and ``swap_out`` fetches the slot's rows."""
    from distkeras_tpu_torch.serving import PrefixStore

    _, lm = lms
    st = DecodeStepper(lm, num_slots=2, paged=paged, page_size=4,
                       prefix_cache=PrefixStore(), device="cpu")
    st.warmup()
    st.warm_prefill_buckets()
    st.warm_restore_buckets()
    arrs = st._pools if paged else st._caches
    assert not any(k.requires_grad or v.requires_grad for k, v in arrs)
    for _ in range(2):  # two touches: the second publishes the rungs
        st.release(0)
        st.admit(0, np.arange(1, 12), max_new=4)
    st.step(np.array([True, False]))
    state = st.swap_out(0)
    assert st.prefix_fetch_failures == 0
    assert st.prefix_cache.stats()["entries"] >= 1
    assert state["kv"][0][0].shape == (11, 2, 16)


def _chaos_run(lm, direction, times):
    from distkeras_tpu_torch.faults import FaultPlan

    rng = np.random.default_rng(3)
    p_lo = rng.integers(0, 61, 7).astype(np.int32)
    p_hi = rng.integers(0, 61, 5).astype(np.int32)
    st = DecodeStepper(lm, num_slots=1, paged=True, page_size=4,
                       device="cpu")
    from distkeras_tpu_torch.obs import FlightRecorder

    rec = FlightRecorder(capacity=256)
    bat = ContinuousBatcher(st, qos=QosPolicy(preempt=True),
                            queue_capacity=8, recorder=rec)
    lo = ServeRequest(p_lo, 8, tenant="b", priority=0)
    hi = ServeRequest(p_hi, 4, tenant="i", priority=2)
    plan = FaultPlan(seed=0).arm(
        "kv.swap", times=times,
        when=lambda ctx: ctx.get("direction") == direction,
    )
    bat.submit(lo)
    for _ in range(30):
        bat.step()
        if len(lo.tokens) >= 2:
            break
    bat.submit(hi)
    with plan:
        for _ in range(120):
            bat.step()
            if lo.done and hi.done:
                break
    assert lo.done and hi.done
    return st, bat, lo, hi, plan, rec


@pytest.mark.chaos
def test_kv_swap_chaos_out_and_in(lms, solo_ref):
    """ACCEPTANCE (kv.swap): a failed swap-out aborts the preemption (the
    victim completes pinned), a failed swap-in fails only the preempted
    request typed with the page ledger balanced, and the scheduler serves
    on — each reply equal to the port's and JAX's solo decode."""
    _, lm = lms
    st, bat, lo, hi, plan, _ = _chaos_run(lm, "out", None)
    assert lo.result(1).tolist() == solo_ref(lo.prompt, 8)
    assert hi.result(1).tolist() == solo_ref(hi.prompt, 4)
    s = bat.stats()
    assert s["preemptions"] == 0 and s["preempt_aborted"] >= 1
    assert plan.fired("kv.swap") >= 1

    st, bat, lo, hi, plan, _ = _chaos_run(lm, "in", 1)
    assert hi.result(1).tolist() == solo_ref(hi.prompt, 4)
    with pytest.raises(InternalError, match="swap-in failed"):
        lo.result(0)
    s = bat.stats()
    assert s["preemptions"] == 1 and s["swap_in_failures"] == 1
    assert s["preemptions"] == (s["resumes"] + s["swap_in_failures"]
                                + s["swapped_failed"])
    assert not {p for t in st._tables for p in t}  # ledger balanced
    nxt = bat.submit(ServeRequest(hi.prompt, 3))
    while not nxt.done:
        bat.step()
    assert nxt.result(1).tolist() == solo_ref(hi.prompt, 3)


@pytest.fixture(scope="module")
def solo_ref(lms):
    """``solo_ref(prompt, steps)``: the full sequence of the port's solo
    greedy decode, held equal to JAX's."""
    from distkeras_tpu.predictors import CachedSequenceGenerator as JCached

    from distkeras_tpu_torch.predictors import CachedSequenceGenerator

    jlm, lm = lms
    jref, pref = JCached(jlm), CachedSequenceGenerator(lm, device="cpu")

    def run(p, s):
        got = pref.generate(np.asarray(p)[None], s)[0]
        want = jref.generate(np.asarray(p, np.int32)[None], steps=s)[0]
        np.testing.assert_array_equal(got, want)
        return got.tolist()

    return run


@pytest.mark.parametrize("kind", ["swap_error", "preempt_resume"])
def test_qos_recorder_events(lms, kind):
    """``qos.swap_error`` names the exception class and the op;
    ``qos.preempt`` and ``qos.resume`` pair, with JAX's fields."""
    _, lm = lms
    if kind == "swap_error":
        _, _, lo, _, _, rec = _chaos_run(lm, "out", 1)
        ev = [e for e in rec.snapshot() if e["kind"] == "qos.swap_error"]
        assert ev and ev[0]["error"] == "InjectedFault"
        assert ev[0]["op"] == "swap_out"
        assert {"slot", "request_id", "tenant", "detail"} <= set(ev[0])
        assert ev[0]["request_id"] == lo.id and ev[0]["tenant"] == "b"
    else:
        _, _, lo, _, _, rec = _chaos_run(lm, "never", None)
        evs = rec.snapshot()
        kinds = [e["kind"] for e in evs]
        assert kinds.count("qos.preempt") == kinds.count("qos.resume") >= 1
        pre = next(e for e in evs if e["kind"] == "qos.preempt")
        res = next(e for e in evs if e["kind"] == "qos.resume")
        assert pre["tenant"] == "b" and pre["request_id"] == lo.id
        assert pre["priority"] == 0 and pre["preemptions"] == 1
        assert pre["tokens"] > lo.prompt.size  # the context swapped out
        assert "slot" in pre
        assert res["request_id"] == lo.id and {"slot", "tokens",
                                               "priority"} <= set(res)


def test_tenant_priority_ride_the_wire_to_the_scheduler(lms):
    """Client -> server -> scheduler: the header fields land on the
    request (the snapshot shows them while it is in flight) and the
    tenant labels the latency histograms after."""
    from distkeras_tpu_torch.serving import ServingClient, ServingServer

    _, lm = lms
    eng = ServingEngine(lm, num_slots=2, prefix_cache=False,
                        watchdog_interval=30.0, device="cpu")
    seen = []
    orig = eng.batcher.submit

    def spy(req):
        out = orig(req)
        seen.append([(r["tenant"], r["priority"])
                     for r in eng.batcher.inflight_snapshot()])
        return out

    eng.batcher.submit = spy
    srv = ServingServer(eng).start()
    # the admission's prefill waits 0.2 s, so the request is still in
    # flight when the spy reads the snapshot
    plan = faults.FaultPlan().arm("stepper.prefill", action="delay",
                                  delay=0.2, times=1)
    try:
        prompt = np.arange(1, 6, dtype=np.int32)
        with plan, ServingClient("127.0.0.1", srv.port) as c:
            c.generate(prompt, 3, tenant="acme", priority=2)
        names = {(s["name"], s["labels"].get("tenant"))
                 for s in eng.metrics_snapshot()}
        assert ("serving_request_total_seconds", "acme") in names
        assert ("acme", 2) in seen[0]
    finally:
        srv.shutdown()
        eng.stop()


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sequential", "overlapped"])
def test_engine_priority_wins_under_saturation(lms, solo_ref, overlap):
    """Through the engine's scheduler thread: with a 1-slot bank saturated
    by low-priority work, a high-priority request finishes no later than
    the last of them, every reply is the solo decode, and the preemption
    books pair."""
    _, lm = lms
    eng = ServingEngine(
        lm, num_slots=1, prefix_cache=False, paged=True, page_size=4,
        qos=QosPolicy(preempt=True, max_preemptions=2),
        watchdog_interval=30.0, overlap=overlap, device="cpu",
    ).start()
    try:
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, 61, 6).astype(np.int32)
                   for _ in range(3)]
        eng.generate(prompts[0], 2)  # warm the programs
        los = [eng.submit(p, 16, tenant="batch", priority=0)
               for p in prompts]
        deadline = time.monotonic() + 30
        while not los[0].tokens:  # the first admission is decoding
            assert time.monotonic() < deadline
            time.sleep(0.0005)
        hi = eng.submit(prompts[0], 3, tenant="live", priority=2)
        out_hi = eng.wait(hi, timeout=60)
        outs = [eng.wait(h, timeout=60) for h in los]
        assert out_hi.tolist() == solo_ref(prompts[0], 3)
        for p, o in zip(prompts, outs):
            assert o.tolist() == solo_ref(p, 16)
        s = eng.stats()
        # hi jumps the two queued requests at least (FIFO would finish it
        # last)
        assert hi.finished < max(r.finished for r in los)
        assert s["preemptions"] == (s["resumes"] + s["swap_in_failures"]
                                    + s["swapped_failed"])
        assert s["qos"]["enabled"] and s["qos"]["preempt"]
        assert eng.batcher.qos is eng.qos
    finally:
        eng.stop()


def test_engine_restart_keeps_the_policy(lms):
    """A supervisor restart rebuilds the scheduler with the same policy."""
    from distkeras_tpu_torch.faults import FaultPlan

    _, lm = lms
    pol = QosPolicy(weights={"gold": 3.0}, preempt=True)
    eng = ServingEngine(lm, num_slots=2, qos=pol, watchdog_interval=30.0,
                        restart_backoff=0.0, device="cpu").start()
    try:
        with FaultPlan().arm("scheduler.loop", times=1):
            deadline = time.monotonic() + 30
            while eng.health()["restarts"] < 1:
                assert time.monotonic() < deadline, "no restart"
                time.sleep(0.01)
        assert eng.batcher.qos is pol
        assert eng.stats()["qos"]["enabled"] is True
        out = eng.generate(np.arange(1, 6), 3, tenant="gold", priority=1)
        assert out.size == 8
    finally:
        eng.stop()


def test_stop_fails_a_swapped_out_request_typed(lms):
    """``stop()`` while a request is swapped out fails it typed
    (``EngineStoppedError``) and the pairing balances."""
    from distkeras_tpu_torch.serving import EngineStoppedError

    _, lm = lms
    st = DecodeStepper(lm, num_slots=1, paged=True, page_size=4,
                       device="cpu")
    bat = ContinuousBatcher(st, qos=QosPolicy(preempt=True),
                            queue_capacity=8)
    lo = bat.submit(ServeRequest(np.arange(1, 8), 10, priority=0))
    for _ in range(6):
        bat.step()
    hi = bat.submit(ServeRequest(np.arange(2, 7), 10, priority=2))
    for _ in range(6):
        bat.step()
        if lo._swap is not None:
            break
    assert lo._swap is not None
    bat.stop()
    with pytest.raises(EngineStoppedError):
        lo.result(0)
    with pytest.raises(EngineStoppedError):
        hi.result(0)
    s = bat.stats()
    assert s["swapped_failed"] == 1
    assert s["preemptions"] == (s["resumes"] + s["swap_in_failures"]
                                + s["swapped_failed"])
    assert not {p for t in st._tables for p in t}


@pytest.mark.gpu
def test_swap_on_card_equals_cpu_run():
    """A paged slot swapped out and back in on the card: the state equals
    the same weights' CPU state (ctx exactly, K/V within 1e-5), and the
    resumed decode equals the uninterrupted CPU decode; the swap-in runs
    with a step in flight without synchronizing the stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    cpu = zoo.transformer_lm(**LM, device="cpu")
    lm = cpu.copy().to("cuda")
    p = np.random.default_rng(5).integers(0, 61, 9)
    outs, states = {}, {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", lm, None)):
        st = DecodeStepper(model, num_slots=2, paged=True, page_size=4,
                           device=dev)
        st.warmup()
        st.warm_restore_buckets()
        st.admit(1, p, max_new=12)
        one = np.array([False, True])
        toks = [int(st.step(one)[1]) for _ in range(3)]
        states[name] = st.swap_out(1)
        st.release(1)
        st.admit(1, p[:4], max_new=4)  # a neighbour in flight
        if dev is None:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            h = st.step_async(one)
            st.swap_in(0, states[name], max_new=9)
        finally:
            if dev is None:
                torch.cuda.set_sync_debug_mode(0)
        h.collect()
        zero = np.array([True, False])
        outs[name] = toks + [int(st.step(zero)[0]) for _ in range(6)]
    np.testing.assert_array_equal(states["cuda"]["ctx"], states["cpu"]["ctx"])
    for (ck, cv), (gk, gv) in zip(states["cpu"]["kv"], states["cuda"]["kv"]):
        np.testing.assert_allclose(gk, ck, atol=1e-5, rtol=0)
        np.testing.assert_allclose(gv, cv, atol=1e-5, rtol=0)
    assert outs["cuda"] == outs["cpu"]
