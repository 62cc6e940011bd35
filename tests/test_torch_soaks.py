"""The port's chaos soaks (``tools/soak_*_torch.py``) on the CPU.

Each case makes the call of a JAX soak smoke and asserts everything that
smoke asserts: ``tests/test_faults.py::test_soak_serving_smoke``,
``tests/test_disagg.py::test_disagg_soak_smoke`` and
``tests/test_bench_harness.py``'s ``test_soak_training_smoke``,
``test_soak_fleet_smoke`` and ``test_soak_fabric_smoke``. Two more: the
serving soak over a ``tp:2`` serving mesh (both shards on the CPU
device), and the serving soak on the JAX LM's own weights (carried over
with ``params_from_jax``), whose greedy references are held equal to the
JAX package's ``CachedSequenceGenerator`` decode, so every greedy reply
the soak counts as correct is JAX's. Bars are properties, never walls.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

import soak_fleet_torch  # noqa: E402
import soak_serving_torch  # noqa: E402
import soak_training_torch  # noqa: E402

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)


@pytest.fixture(scope="module")
def jlm():
    from distkeras_tpu.models import zoo as jzoo

    return jzoo.transformer_lm(**LM, seed=0)


@pytest.fixture(scope="module")
def lm(jlm):
    """The port's tiny LM carrying the JAX LM's weights."""
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.utils.convert import params_from_jax

    m = zoo.transformer_lm(**LM, seed=0, device="cpu")
    params_from_jax(m, jax.tree.map(np.asarray, jlm.params))
    return m


def _assert_serving_soak(summary):
    """Every assert of ``tests/test_faults.py::test_soak_serving_smoke``."""
    assert summary["hung"] == 0
    assert summary["untyped_errors"] == 0, summary["untyped_samples"]
    assert summary["corrupt_outputs"] == 0
    assert summary["completed"] > 0
    assert summary["sampled_completed"] > 0
    assert summary["divergent_replays"] == 0
    assert summary["grammar_violations"] == 0
    assert summary["faults_fired"] > 0
    assert summary["fired_by_site"]["stepper.verify"] > 0
    assert summary["speculative"]["windows"] > 0
    assert summary["qos"]["paired"], summary["qos"]
    assert summary["paged"]["pool_balanced"], summary["paged"]
    assert summary["paged"]["enabled"]
    assert summary["engine"]["pool_exhausted"] >= 0
    assert summary["trace_attempts"] > 0
    assert summary["trace_incomplete"] == 0, (
        summary["trace_incomplete_samples"])
    st = summary["storm"]
    assert st["hung"] == 0 and st["untyped"] == 0
    assert st["corrupt"] == 0 and st["accounting_exact"]
    assert st["hint_missing"] == 0
    assert st["typed"].get("overloaded", 0) >= 1
    assert summary["shed"]["gate"]["sheds"] >= 1


@pytest.mark.chaos
def test_soak_serving_smoke(lm):
    summary = soak_serving_torch.run_soak(
        model=lm, clients=3, duration=3.0, seed=0, fault_every=5,
        device="cpu",
    )
    _assert_serving_soak(summary)
    # the tool's own bar, which main() turns into the exit code
    assert summary["ok"], summary


@pytest.mark.chaos
def test_soak_serving_smoke_on_a_tp2_mesh(lm):
    """The same chaos over a sharded stepper (two shards on the CPU
    device): every bar holds unchanged, and restarts rebuild the mesh."""
    summary = soak_serving_torch.run_soak(
        model=lm, clients=3, duration=3.0, seed=0, fault_every=5,
        mesh="tp:2", device="cpu",
    )
    assert summary["mesh"] == "tp:2"
    _assert_serving_soak(summary)
    assert summary["engine"]["restarts"] >= 1
    assert summary["ok"], summary


@pytest.mark.chaos
def test_soak_serving_greedy_replies_are_jax_decode(jlm, lm, monkeypatch):
    """The soak's greedy references, made by the port's
    ``CachedSequenceGenerator``, equal the JAX package's solo decode of
    the same weights; the soak holds every served greedy reply equal to
    them (0 corrupt of > 0 completed)."""
    from distkeras_tpu.predictors import CachedSequenceGenerator as JGen
    from distkeras_tpu_torch import predictors

    made = []

    class Recording(predictors.CachedSequenceGenerator):
        def generate(self, prompts, steps, **kw):
            out = super().generate(prompts, steps, **kw)
            made.append((np.array(prompts), int(steps), np.array(out)))
            return out

    monkeypatch.setattr(predictors, "CachedSequenceGenerator", Recording)
    summary = soak_serving_torch.run_soak(
        model=lm, clients=2, duration=2.0, seed=0, fault_every=5,
        device="cpu",
    )
    assert len(made) == 4  # one reference per greedy prompt
    jgen = JGen(jlm)
    for prompts, steps, out in made:
        want = np.asarray(jgen.generate(prompts, steps=steps))
        np.testing.assert_array_equal(out, want)
    assert summary["completed"] > 0
    assert summary["corrupt_outputs"] == 0
    assert summary["hung"] == 0 and summary["untyped_errors"] == 0


@pytest.mark.chaos
def test_disagg_soak_smoke(lm):
    summary = soak_serving_torch.run_disagg_soak(
        clients=3, duration=6.0, seed=0, model=lm, device="cpu",
    )
    assert summary["hung"] == 0
    assert summary["untyped_errors"] == 0, summary["untyped_samples"]
    assert summary["corrupt_outputs"] == 0
    assert summary["divergent_replays"] == 0
    assert summary["router"]["transfer_paired"], summary["router"]
    assert summary["completed"] > 0
    assert summary["streamed_completed"] > 0
    assert summary["ok"], summary


@pytest.mark.chaos
def test_soak_training_smoke():
    summary = soak_training_torch.run_soak(seed=0, smoke=True, device="cpu")
    ledger = summary["phases"]["ledger"]
    assert ledger["hung"] == 0
    assert ledger["errors"] == []
    assert ledger["promoted"] and ledger["promote_reason"] == "primary-lost"
    assert ledger["exactly_once"]
    assert ledger["applied_updates"] == ledger["expected_updates"]
    # the post-mortem bar the tool's ``ok`` folds in
    assert ledger["postmortems"] == 1 and ledger["postmortem_names_seam"]
    training = summary["phases"]["training"]
    assert training["faulted"]["hung"] is False
    assert training["faulted"]["error"] is None
    assert len(training["faulted"]["promotions"]) == 1
    assert training["faulted"]["failovers"] >= 1
    assert training["ledger_match"]
    assert summary["ok"]


@pytest.mark.chaos
@pytest.mark.e2e
def test_soak_fleet_smoke():
    summary = soak_fleet_torch.run_soak(seed=0, smoke=True, device="cpu")
    assert summary["hung"] == 0
    assert summary["untyped_errors"] == 0, summary["untyped_samples"]
    assert summary["corrupt_outputs"] == 0
    assert summary["accounting_exact"]
    assert summary["trace_attempts"] > 0
    assert summary["trace_incomplete"] == 0, (
        summary["trace_incomplete_samples"])
    assert summary["control_errors"] == []
    assert summary["kill"]["in_flight_at_kill"]
    assert summary["autoscale"]["reaps"] >= 1
    assert summary["autoscale"]["scale_ups"] >= 1
    assert summary["autoscale"]["errors"] == 0
    assert summary["autoscale"]["fleet_size_after_replace"] == 2
    assert summary["deploy"]["published"] == 1
    assert summary["deploy"]["publish_errors"] == 0
    assert summary["deploy"]["bundle_identical_to_boot"] is True
    assert len(summary["rollover"]["replaced"]) == 2
    assert summary["compile_storms"] == 0
    assert summary["completed"] > 0
    res = summary["resilience"]
    assert res["hedges"]["launched"] >= 1
    assert res["hedges"]["launched"] == (
        res["hedges"]["wins"] + res["hedges"]["losers"])
    assert res["breakers"]["bypass_forwards"] == 0
    assert res["retry_budget"]["exhausted"] >= res["retry_budget_exhausted"]
    assert summary["ok"]


@pytest.mark.chaos
@pytest.mark.e2e
def test_soak_fabric_smoke():
    summary = soak_fleet_torch.run_fabric_soak(seed=0, smoke=True,
                                               device="cpu")
    for phase in ("fetch", "push"):
        ph = summary[phase]
        assert ph["hung"] == 0, phase
        assert ph["untyped"] == 0, (phase, ph["untyped_samples"])
        assert ph["divergent"] == 0, phase
        assert ph["completed"] > 0, phase
        assert ph["control_errors"] == [], phase
    assert summary["fetch"]["peer"]["fetch_ok"] >= 1
    assert summary["fetch"]["peer"]["fetch_degraded"] >= 1
    assert summary["fetch"]["probe_identical"] is True
    assert summary["push"]["router"]["peer_ok"] >= 1
    assert summary["push"]["router"]["peer_degraded"] >= 1
    assert summary["push"]["pairing_balanced"]
    assert summary["ok"]
