"""PyTorch port serving vs the JAX package on the CPU: the engine's greedy
and sampled output against JAX solo decode, predict against JAX's
ModelPredictor, the predict-only demotion of a flash-hooked model, the
scheduler's host contract, the device contract, and import isolation."""

import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.predictors import CachedSequenceGenerator as JCached
from distkeras_tpu.predictors import ModelPredictor as JPredictor
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
from distkeras_tpu_torch.parallel.ring_attention import detach_ring_attention
from distkeras_tpu_torch.predictors import CachedSequenceGenerator, ModelPredictor
from distkeras_tpu_torch.serving.engine import DecodeStepper, ServingEngine
from distkeras_tpu_torch.serving.scheduler import (
    ContinuousBatcher,
    DeadlineExceededError,
    EngineStoppedError,
    OverloadedError,
    ServeRequest,
)
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=64, d_model=128, num_heads=2, depth=2)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lms():
    jlm = jzoo.transformer_lm(**LM, seed=0)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    attach_fused_layernorm(lm)  # the generate path's hook (plain on CPU)
    return jlm, lm


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 61, n).astype(np.int32) for n in lens]


def test_engine_greedy_matches_jax_solo_decode(lms):
    """4 concurrent requests on 2 slots with an 8-token prefill budget: one
    prompt needs several chunks, admissions interleave with decode."""
    jlm, lm = lms
    prompts = _prompts((5, 30, 17, 3))
    eng = ServingEngine(lm, num_slots=2, prefill_chunk=8, device="cpu").start()
    try:
        reqs = [eng.submit(p, 10) for p in prompts]
        outs = [eng.wait(r, timeout=120) for r in reqs]
        stats = eng.stats()
    finally:
        eng.stop()
    for p, o in zip(prompts, outs):
        want = np.asarray(JCached(jlm).generate(p[None], 10))[0]
        np.testing.assert_array_equal(o, want)
    assert stats["completed"] == 4 and stats["prefill_chunks"] >= 5


def test_engine_sampled_matches_jax_and_replays(lms):
    jlm, lm = lms
    prompts = _prompts((6, 13), seed=2)
    sampling = {"temperature": 0.8, "seed": 9}
    eng = ServingEngine(lm, num_slots=2, device="cpu").start()
    try:
        first = [eng.generate(p, 8, sampling=sampling, timeout=120)
                 for p in prompts]
        again = [eng.generate(p, 8, sampling=sampling, timeout=120)
                 for p in prompts]
    finally:
        eng.stop()
    for p, a, b in zip(prompts, first, again):
        want = np.asarray(
            JCached(jlm, temperature=0.8, seed=9).generate(p[None], 8))[0]
        np.testing.assert_array_equal(a, want)
        np.testing.assert_array_equal(a, b)


def test_engine_predict_matches_jax_model_predictor(lms):
    jlm, lm = lms
    x = np.random.default_rng(3).integers(0, 61, (5, 64)).astype(np.int32)
    want = JPredictor(jlm, batch_size=4).predict(
        JDataset({"features": x}))["prediction"]
    eng = ServingEngine(lm, device="cpu").start()
    try:
        got = eng.predict(x, timeout=60)
    finally:
        eng.stop()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)
    ds = ModelPredictor(lm, batch_size=2, device="cpu").predict(
        JDataset({"features": x}))
    np.testing.assert_allclose(ds["prediction"], np.asarray(want), atol=1e-4)


def test_flash_hooked_model_is_predict_only(lms):
    jlm, lm = lms
    assert attach_flash_attention(lm) == 2
    try:
        eng = ServingEngine(lm, device="cpu").start()
        try:
            assert not eng.health()["generate_enabled"]
            with pytest.raises(EngineStoppedError, match="attention_fn"):
                eng.submit(np.arange(4), 2)
            x = np.random.default_rng(4).integers(0, 61, (2, 64)).astype(np.int32)
            np.testing.assert_allclose(eng.predict(x, timeout=60),
                                       np.asarray(jlm(x)), atol=1e-4, rtol=0)
        finally:
            eng.stop()
    finally:
        detach_ring_attention(lm)


def test_chunked_prefill_fills_the_same_cache_as_full_prefill(lms):
    _, lm = lms
    prompt = _prompts((29,), seed=6)[0]
    full = DecodeStepper(lm, num_slots=2, device="cpu")
    full.admit(1, prompt)
    chunked = DecodeStepper(lm, num_slots=2, device="cpu")
    left = chunked.begin_admit(1, prompt)
    while left:
        left = chunked.prefill_chunk(1, 5)
    for (fk, fv), (ck, cv) in zip(full._caches, chunked._caches):
        torch.testing.assert_close(ck[1, :28], fk[1, :28], atol=1e-5, rtol=0)
        torch.testing.assert_close(cv[1, :28], fv[1, :28], atol=1e-5, rtol=0)
    active = np.array([False, True])
    assert full.step(active)[1] == chunked.step(active)[1]


class _FakeStepper:
    """Host-only stepper: every slot emits its slot index + 1."""

    num_slots, max_len = 2, 32

    def begin_admit(self, slot, prompt, **kw):
        return 0

    def prefill_chunk(self, slot, budget):
        return 0

    def release(self, slot):
        pass

    def step(self, active):
        return np.arange(self.num_slots) + 1


def test_scheduler_backpressure_deadlines_and_stop():
    b = ContinuousBatcher(_FakeStepper(), queue_capacity=2)
    late = b.submit(ServeRequest([1], 3, deadline=time.monotonic() - 1))
    ok = b.submit(ServeRequest([1, 2], 3, eos_id=1))
    with pytest.raises(OverloadedError):
        b.submit(ServeRequest([1], 3))
    with pytest.raises(ValueError, match="capacity"):
        b.submit(ServeRequest(np.zeros(30), 5))
    while not ok.done:
        b.step()
    with pytest.raises(DeadlineExceededError):
        late.result(0)
    np.testing.assert_array_equal(ok.result(0), [1, 2, 1])  # eos-trimmed
    pending = b.submit(ServeRequest([3], 4))
    b.stop()
    with pytest.raises(EngineStoppedError):
        pending.result(0)
    with pytest.raises(EngineStoppedError):
        b.submit(ServeRequest([3], 4))


def test_scheduler_concurrent_submits_all_complete():
    """More submitting threads than cores against one stepping loop: every
    accepted request finishes with its own tokens and the counters add
    up (a lost update under the batcher lock would break them)."""
    b = ContinuousBatcher(_FakeStepper(), queue_capacity=10_000,
                          prefill_chunk=4)
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            if not b.step():
                b.wait_for_work(0.001)

    reqs, lock = [], threading.Lock()

    def client(k):
        for j in range(50):
            r = b.submit(ServeRequest(np.full(3 + (j % 5), k), 2))
            with lock:
                reqs.append(r)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    stepper = threading.Thread(target=loop)
    clients = [threading.Thread(target=client, args=(k,)) for k in range(16)]
    try:
        stepper.start()
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=60)
        for r in reqs:
            r.result(timeout=60)
    finally:
        stop.set()
        stepper.join(timeout=10)
        sys.setswitchinterval(old)
    assert not stepper.is_alive() and len(reqs) == 800
    stats = b.stats()
    assert stats["submitted"] == stats["completed"] == 800
    assert stats["tokens_generated"] == 1600
    assert all(len(r.tokens) == 2 for r in reqs)


def test_engine_drain_completes_in_flight_work(lms):
    _, lm = lms
    eng = ServingEngine(lm, num_slots=1, device="cpu").start()
    reqs = [eng.submit(p, 4) for p in _prompts((3, 4, 5), seed=7)]
    eng.stop(drain=True)
    assert all(r.done and r.error is None for r in reqs)
    assert eng.health()["status"] == "draining"


@pytest.mark.parametrize(
    "entry",
    ["zoo", "engine", "generator", "predictor"],
)
def test_entry_points_default_to_cuda_and_raise_without_it(lms, entry):
    """device=None means CUDA: with no GPU every entry point raises rather
    than dropping quietly to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, lm = lms
    make = {
        "zoo": lambda: zoo.transformer_lm(**LM),
        "engine": lambda: ServingEngine(lm),
        "generator": lambda: CachedSequenceGenerator(lm),
        "predictor": lambda: ModelPredictor(lm),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib, distkeras_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'distkeras_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'distkeras_tpu' or m.startswith('distkeras_tpu.')]\n"
        "assert not bad, bad\n"
        "front = ['distkeras_tpu_torch.serving.' + n for n in ('server',"
        " 'client', 'resilience')] + ['distkeras_tpu_torch.obs.' + n"
        " for n in ('tracing', 'compile_ledger', 'overlap')]\n"
        "assert all(m in sys.modules for m in front), front\n"
        "print('clean', len([m for m in sys.modules"
        " if m.startswith('distkeras_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")
