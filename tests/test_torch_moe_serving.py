"""The port's MoE decode and serving against the JAX package.

A switch-MoE LM decodes through no-drop routing (``_moe_nodrop``: every
token's top-1 expert, no capacity) in every cached generator and every
``DecodeStepper`` program. The bars: ``_moe_nodrop`` equals JAX's to 1e-6
absolute; greedy cached (ragged, eos-trimmed), beam and speculative
decode are token-identical to JAX's generators (JAX ``tests/test_lm.py``'s
MoE cases); the engine's greedy replies, dense and paged, through chunked
prefill, a prefix hit, a copy-on-write fork and n-gram verify windows,
equal JAX's engine's replies token for token; ``predict`` (the
capacity-dropped forward over the padded window) equals JAX's engine's
to 1e-5 absolute.

All on the CPU, on a small MoE LM (vocab 64, seq 64, d32, 4 heads, depth
2, 4 experts) with JAX's weights carried into the port. JAX is imported
inside the fixtures and tests, so the ``gpu``-marked case also runs on a
machine without it (``python -m pytest --noconftest
tests/test_torch_moe_serving.py -m gpu``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
from distkeras_tpu_torch.predictors import (
    BeamSearchGenerator,
    CachedSequenceGenerator,
    SpeculativeGenerator,
)
from distkeras_tpu_torch.serving import ServingEngine
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

MOE = dict(vocab_size=64, seq_len=64, d_model=32, num_heads=4, depth=2,
           num_experts=4)
VOCAB = MOE["vocab_size"]
NEW = 10


def _bridge(jm, tm):
    import jax

    params_from_jax(tm, jax.tree.map(np.asarray, jm.params))
    return jm, tm


@pytest.fixture(scope="module")
def lms():
    from distkeras_tpu.models import zoo as jzoo

    jlm, lm = _bridge(jzoo.moe_transformer_lm(**MOE, seed=0),
                      zoo.moe_transformer_lm(**MOE, device="cpu"))
    attach_fused_layernorm(lm)  # the serving path's hook (plain on CPU)
    return jlm, lm


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, n).astype(np.int32) for n in lens]


PROMPTS = _prompts((5, 30, 17, 3))


@pytest.fixture(scope="module")
def jax_served(lms):
    """JAX's engine over the prompts (2 slots, 8-position prefill chunks),
    and its predict over a 5-row batch (padded to its 8-row window)."""
    from distkeras_tpu.serving import ServingEngine as JEngine

    x = np.random.default_rng(3).integers(0, VOCAB, (5, 64)).astype(np.int32)
    eng = JEngine(lms[0], num_slots=2, prefill_chunk=8, predict_batch=8)
    eng.start()
    try:
        reqs = [eng.submit(p, NEW) for p in PROMPTS]
        outs = [np.asarray(eng.wait(r, timeout=300)) for r in reqs]
        pred = np.asarray(eng.predict(x, timeout=300))
    finally:
        eng.stop()
    return outs, x, pred


@pytest.mark.parametrize("shape", [(2, 5, 32), (7, 32)])
def test_moe_nodrop_matches_jax(lms, shape):
    import jax.numpy as jnp

    from distkeras_tpu.predictors import CachedSequenceGenerator as JCached

    jlm, lm = lms
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want = JCached._moe_nodrop(jlm.params["2"], jnp.asarray(x))
    got = CachedSequenceGenerator._moe_nodrop(lm.layers[2].expert_params(),
                                              torch.tensor(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)


def test_stages_parse_block_moe_pairs(lms):
    _, lm = lms
    gen = CachedSequenceGenerator(lm, device="cpu")
    assert [(type(b).__name__, type(m).__name__) for b, m in gen._stages] \
        == [("TransformerBlock", "MoE")] * 2
    assert len(gen._blocks) == 2 and len(gen.new_caches(1, 8)) == 2


def test_cached_greedy_ragged_and_eos_match_jax(lms):
    from distkeras_tpu.predictors import CachedSequenceGenerator as JCached

    jlm, lm = lms
    rect = np.random.default_rng(4).integers(0, VOCAB, (3, 7))
    np.testing.assert_array_equal(
        CachedSequenceGenerator(lm, device="cpu").generate(rect, 12),
        np.asarray(JCached(jlm).generate(rect, 12)))
    ragged = _prompts((4, 11, 7), seed=5)
    gen = CachedSequenceGenerator(lm, device="cpu")
    eos = int(gen.generate(ragged, 9)[1][13])  # emitted mid-row in row 1
    got = gen.generate(ragged, 9, eos_id=eos)
    want = JCached(jlm).generate(ragged, 9, eos_id=eos)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_beam_search_matches_jax(lms):
    from distkeras_tpu.predictors import BeamSearchGenerator as JBeam

    jlm, lm = lms
    p = np.random.default_rng(6).integers(0, VOCAB, (2, 6))
    got = BeamSearchGenerator(lm, beam_width=3, device="cpu")
    want = JBeam(jlm, beam_width=3)
    np.testing.assert_array_equal(got.generate(p, 8),
                                  np.asarray(want.generate(p, 8)))
    np.testing.assert_allclose(got.last_scores, np.asarray(want.last_scores),
                               atol=1e-4, rtol=0)


def test_speculative_moe_target_matches_jax(lms):
    """An MoE target with a dense draft (JAX ``tests/test_lm.py``'s MoE
    speculative case): the target's greedy decode, token for token."""
    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.predictors import SpeculativeGenerator as JSpec

    jlm, lm = lms
    jd, td = _bridge(
        jzoo.transformer_lm(VOCAB, 64, 16, 2, 1, seed=3),
        zoo.transformer_lm(VOCAB, 64, 16, 2, 1, seed=3, device="cpu"))
    p = np.random.default_rng(7).integers(0, VOCAB, (2, 5))
    got = SpeculativeGenerator(lm, td, k=3, device="cpu").generate(p, 10)
    np.testing.assert_array_equal(
        got, np.asarray(JSpec(jlm, jd, k=3).generate(p, 10)))
    np.testing.assert_array_equal(
        got, CachedSequenceGenerator(lm, device="cpu").generate(p, 10))


def _serve(lm, **kw):
    eng = ServingEngine(lm, num_slots=2, prefill_chunk=8, device="cpu",
                        **kw).start()
    try:
        reqs = [eng.submit(p, NEW) for p in PROMPTS]
        outs = [eng.wait(r, timeout=120) for r in reqs]
        return outs, eng.stats(), eng
    finally:
        eng.stop()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_greedy_replies_equal_jax_engine(lms, jax_served, paged):
    """Chunked prefill (the 30- and 17-token prompts take several
    8-position chunks) interleaved with decode, on the dense bank and on
    the page pool."""
    outs, stats, _ = _serve(lms[1], paged=paged)
    for got, want in zip(outs, jax_served[0]):
        np.testing.assert_array_equal(got, want)
    assert stats["completed"] == len(PROMPTS)
    assert stats["prefill_chunks"] >= 6


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_prefix_hit_and_fork_equal_jax_engine(lms, jax_served,
                                                     paged):
    """The third serving of a prompt restores its prefix from the store
    (the host ladder, dense; the device index, paged); a paged engine's
    n = 2 greedy group forks the slot copy-on-write. Every reply equals
    JAX's engine's."""
    _, lm = lms
    p, want = PROMPTS[1], jax_served[0][1]
    eng = ServingEngine(lm, num_slots=2, prefill_chunk=8, paged=paged,
                        device="cpu").start()
    try:
        for _ in range(3):
            np.testing.assert_array_equal(eng.generate(p, NEW, timeout=120),
                                          want)
        if paged:
            group = eng.generate(p, NEW, sampling={"n": 2}, timeout=120)
            assert len(group) == 2
            for g in group:
                np.testing.assert_array_equal(g, want)
        stats = eng.stats()
        hits = (eng._stepper.prefix_index.stats()["hits"] if paged
                else stats["prefix_cache"]["hits"])
    finally:
        eng.stop()
    assert hits >= 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_ngram_verify_equals_jax_engine(lms, jax_served, paged):
    """n-gram speculation: MoE stages in the verify windows (k = 3)."""
    outs, stats, _ = _serve(lms[1], paged=paged, speculative="ngram",
                            draft_k=3)
    for got, want in zip(outs, jax_served[0]):
        np.testing.assert_array_equal(got, want)
    assert stats["speculative"]["verify_steps"] >= 1


def test_engine_predict_equals_jax_engine(lms, jax_served):
    """``predict`` runs the model's own capacity-dropped forward over the
    window padded to ``predict_batch`` rows, as JAX's engine does."""
    _, x, want = jax_served
    eng = ServingEngine(lms[1], predict_batch=8, device="cpu").start()
    try:
        got = eng.predict(x, timeout=60)
    finally:
        eng.stop()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_moe_engine_on_the_card_matches_solo_decode():
    """On the card: the MoE LM's engine (LN hook, paged and dense) gives
    its own solo cached decode's greedy replies, and B7 served it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    from distkeras_tpu_torch import kernels

    lm = zoo.moe_transformer_lm(**MOE)
    attach_fused_layernorm(lm)
    solo = CachedSequenceGenerator(lm)
    want = [solo.generate(p[None], NEW)[0] for p in PROMPTS]
    for paged in (False, True):
        kernels.reset_launch_counts()
        eng = ServingEngine(lm, num_slots=2, prefill_chunk=8,
                            paged=paged).start()
        try:
            outs = [eng.generate(p, NEW, timeout=120) for p in PROMPTS]
        finally:
            eng.stop()
        for got, w in zip(outs, want):
            np.testing.assert_array_equal(got, w)
        assert kernels.launch_counts()["layernorm_fwd"] > 0
