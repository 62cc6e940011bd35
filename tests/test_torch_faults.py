"""The port's ``faults`` (a copy of the JAX package's) against the JAX
package on the CPU: the same arming, driven by the same sequence of
``fire`` calls, fires the same actions in the same order — counted gates,
context filters and the plan's seeded ``probability`` draws included.
The two packages' plans are separate process globals, so both can be
active at once and see the identical event stream."""

import threading

import pytest

from distkeras_tpu import faults as jfaults
from distkeras_tpu_torch import faults


def _arm(mod, seed):
    plan = mod.FaultPlan(seed=seed)
    plan.arm("net.send", action="corrupt", times=None, probability=0.3)
    plan.arm("net.recv", action="delay", delay=0.0, after=2, times=3)
    plan.arm("ps.commit", times=2, when=lambda ctx: ctx.get("tag") == 1)
    plan.arm("ps.pull", action="raise", times=None, probability=0.5,
             exc=ValueError("injected pull"))
    plan.arm("ps.replicate", after=4)
    return plan


def _events(seed, n=200):
    """A seeded stream of (site, ctx) seam events over every armed site
    and one never armed."""
    import random

    rng = random.Random(seed)
    sites = ["net.send", "net.recv", "ps.commit", "ps.pull",
             "ps.replicate", "stepper.step"]
    return [(rng.choice(sites), {"tag": rng.randrange(3)}) for _ in range(n)]


def _outcomes(mod, plan, events):
    out = []
    with plan:
        for site, ctx in events:
            try:
                out.append(mod.fire(site, **ctx))
            except (mod.InjectedFault, ValueError) as e:
                out.append(f"raised {type(e).__name__}: {e}")
    return out


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_seeded_plan_fires_the_jax_sequence(seed):
    events = _events(seed)
    port_plan, jax_plan = _arm(faults, seed), _arm(jfaults, seed)
    got = _outcomes(faults, port_plan, events)
    want = _outcomes(jfaults, jax_plan, events)
    assert got == want
    assert any(o is not None for o in got)
    assert port_plan.describe() == jax_plan.describe()
    for site in ("net.send", "net.recv", "ps.commit", "ps.pull",
                 "ps.replicate", None):
        assert port_plan.fired(site) == jax_plan.fired(site)
    assert port_plan.fired("ps.commit") == 2
    assert port_plan.fired("net.recv") == 3
    assert port_plan.fired("ps.replicate") == 1


def test_disarmed_seams_are_inert_and_plans_do_not_nest():
    assert faults.fire("ps.pull", worker_id=0) is None
    assert faults.describe_active() is None
    a, b = faults.FaultPlan(), faults.FaultPlan()
    with a:
        with pytest.raises(RuntimeError, match="already active"):
            b.activate()
        assert faults.describe_active() == []
    assert faults.fire("ps.pull") is None
    with pytest.raises(ValueError, match="unknown fault site"):
        a.arm("nope")
    with pytest.raises(ValueError, match="unknown fault action"):
        a.arm("ps.pull", action="explode")
    with pytest.raises(ValueError, match="times"):
        a.arm("ps.pull", times=0)
    assert faults.SITES == jfaults.SITES
    assert faults.ACTIONS == jfaults.ACTIONS


def test_observers_see_firings_before_the_raise():
    seen = []

    def observer(site, action, ctx):
        seen.append((site, action, dict(ctx)))

    def broken(site, action, ctx):
        raise RuntimeError("observers must not change the fault")

    faults.add_observer(observer)
    faults.add_observer(broken)
    try:
        plan = faults.FaultPlan(seed=0).arm("ps.commit", times=1)
        with plan:
            with pytest.raises(faults.InjectedFault, match="ps.commit"):
                faults.fire("ps.commit", commit_id=(0, 1), tag=None)
            assert faults.fire("ps.commit") is None  # exhausted
    finally:
        faults.remove_observer(observer)
        faults.remove_observer(broken)
    assert seen == [("ps.commit", "raise",
                     {"commit_id": (0, 1), "tag": None})]
    faults.remove_observer(observer)  # idempotent


def test_concurrent_firing_counts_every_event_once():
    """8 threads x 500 fires on a `times=None` seam: the plan's lock
    counts each firing exactly once."""
    plan = faults.FaultPlan(seed=0).arm("net.recv", action="delay",
                                        times=None)
    with plan:
        threads = [threading.Thread(
            target=lambda: [faults.fire("net.recv") for _ in range(500)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert plan.fired("net.recv") == 4000
