"""The port's ``BeamSearchGenerator`` against the JAX package's.

The JAX counterparts are ``tests/test_lm.py``'s beam tests: width 1 is
greedy cached decode, the search's sequences and scores, eos freezing, the
length penalty at the final selection and the validation. Here each holds
the port against JAX's generator on the same weights (bridged with
``params_from_jax``), on the CPU: sequences equal token for token, scores
within rtol 1e-5 (the two log-softmaxes may differ in the last ulp).

The ``gpu``-marked case runs one search on the card against its CPU run
(``python -m pytest --noconftest tests/test_torch_beam.py -m gpu``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.predictors import (
    BeamSearchGenerator,
    CachedSequenceGenerator,
)
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

#: JAX's ``_ragged_lm`` shape (tests/test_lm.py)
LM = dict(vocab_size=32, seq_len=24, d_model=32, num_heads=4, depth=2)
SCORE_RTOL = 1e-5


def _pair(seed):
    import jax

    from distkeras_tpu.models import zoo as jzoo

    jlm = jzoo.transformer_lm(**LM, seed=seed)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    return jlm, lm


@pytest.fixture(scope="module")
def lms():
    return _pair(0)


@pytest.fixture(scope="module")
def lms3():
    return _pair(3)  # random weights with flat logits: a real search


def _jbeam(jlm, **kw):
    from distkeras_tpu.predictors import BeamSearchGenerator as JBeam

    return JBeam(jlm, **kw)


def test_beam_width_1_equals_greedy_cached(lms):
    jlm, lm = lms
    prompts = np.random.default_rng(10).integers(0, 32, (3, 6))
    greedy = CachedSequenceGenerator(lm, device="cpu").generate(prompts, 9)
    beam = BeamSearchGenerator(lm, beam_width=1, device="cpu")
    np.testing.assert_array_equal(beam.generate(prompts, 9), greedy)
    jb = _jbeam(jlm, beam_width=1)
    np.testing.assert_array_equal(
        greedy, jb.generate(prompts.astype(np.int32), steps=9))
    np.testing.assert_allclose(beam.last_scores, jb.last_scores,
                               rtol=SCORE_RTOL)


@pytest.mark.parametrize("width,alpha", [(2, 0.0), (4, 0.0), (4, 0.8),
                                         (6, 1.5)])
def test_beam_sequences_and_scores_match_jax(lms3, width, alpha):
    """Width 2-6, with and without the length penalty: JAX's sequences
    token for token, its raw scores within ``SCORE_RTOL``."""
    jlm, lm = lms3
    prompts = np.random.default_rng(11).integers(0, 32, (4, 5))
    gen = BeamSearchGenerator(lm, beam_width=width, length_penalty=alpha,
                              device="cpu")
    jb = _jbeam(jlm, beam_width=width, length_penalty=alpha)
    got = gen.generate(prompts, 8)
    want = jb.generate(prompts.astype(np.int32), steps=8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(gen.last_scores, jb.last_scores,
                               rtol=SCORE_RTOL)


def test_beam_scores_are_the_sequences_log_probs(lms3):
    """The returned score is the teacher-forced summed log-prob of the
    returned sequence (the port's own forward), within 1e-4."""
    _, lm = lms3
    prompts = np.random.default_rng(11).integers(0, 32, (4, 5))
    gen = BeamSearchGenerator(lm, beam_width=4, device="cpu")
    out = gen.generate(prompts, 8)
    with torch.no_grad():
        logp = torch.log_softmax(lm(torch.as_tensor(out)), -1).numpy()
    want = [sum(logp[b, t - 1, out[b, t]] for t in range(5, out.shape[1]))
            for b in range(out.shape[0])]
    np.testing.assert_allclose(gen.last_scores, want, atol=1e-4)


@pytest.mark.parametrize("width", [1, 3])
def test_beam_eos_freezes_and_trims_like_jax(lms, width):
    """With ``eos_id`` (row 0's first generated token), a finished beam's
    score freezes: the trimmed rows equal JAX's, each ending AT its first
    generated eos or running the full 8 steps."""
    jlm, lm = lms
    prompts = np.random.default_rng(12).integers(0, 32, (2, 4))
    gen = BeamSearchGenerator(lm, beam_width=width, device="cpu")
    eos = int(gen.generate(prompts, 8)[0, 4])
    got = gen.generate(prompts, 8, eos_id=eos)
    jb = _jbeam(jlm, beam_width=width)
    want = jb.generate(prompts.astype(np.int32), steps=8, eos_id=eos)
    assert isinstance(got, list) and len(got) == 2
    for g, w, p in zip(got, want, prompts):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g[:4], p)
        hits = np.flatnonzero(g[4:] == eos)
        assert (hits.size and hits[0] == g.size - 5) or g.size == 12
    np.testing.assert_allclose(gen.last_scores, jb.last_scores,
                               rtol=SCORE_RTOL)


def test_beam_validation(lms):
    _, lm = lms
    with pytest.raises(ValueError, match="beam_width"):
        BeamSearchGenerator(lm, beam_width=0, device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        BeamSearchGenerator(lm, beam_width=64, device="cpu")  # vocab 32
    with pytest.raises(ValueError, match="length_penalty"):
        BeamSearchGenerator(lm, length_penalty=-1, device="cpu")
    with pytest.raises(ValueError, match="rectangular"):
        BeamSearchGenerator(lm, device="cpu").generate(
            [np.arange(2), np.arange(5)], 4)
    with pytest.raises(ValueError, match="kv_dtype"):
        BeamSearchGenerator(lm, kv_dtype=torch.int8, device="cpu")
    assert BeamSearchGenerator(lm, kv_dtype="bfloat16",
                               device="cpu").kv_dtype == torch.bfloat16


def test_beam_config_revalidated_at_every_generate(lms):
    _, lm = lms
    gen = BeamSearchGenerator(lm, beam_width=2, device="cpu")
    gen.generate(np.array([[1, 2]]), 3)
    gen.beam_width = 0
    with pytest.raises(ValueError, match="beam_width"):
        gen.generate(np.array([[1, 2]]), 3)
    gen.beam_width = 2
    gen.length_penalty = -0.5
    with pytest.raises(ValueError, match="length_penalty"):
        gen.generate(np.array([[1, 2]]), 3)


@pytest.mark.gpu
def test_beam_step_on_card_equals_cpu_run():
    """One width-4 search with the LayerNorm hook on the card equals the
    same weights' CPU search (sequences exactly, scores within 1e-4
    relative) and launches B7 2L + 1 = 5 times a step (2 per block and the
    final norm) plus 2L = 4 for the prefill on this 2-block model."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    cpu = zoo.transformer_lm(**LM, device="cpu")
    lm = cpu.copy().to("cuda")
    prompts = np.random.default_rng(11).integers(0, 32, (4, 5))
    want = BeamSearchGenerator(cpu, beam_width=4, device="cpu")
    want_out = want.generate(prompts, 8)
    assert attach_fused_layernorm(lm) == 5
    gen = BeamSearchGenerator(lm, beam_width=4)
    kernels.reset_launch_counts()
    got = gen.generate(prompts, 8)
    counts = kernels.launch_counts()
    np.testing.assert_array_equal(got, want_out)
    np.testing.assert_allclose(gen.last_scores, want.last_scores, rtol=1e-4)
    assert counts["layernorm_fwd"] == 8 * 5 + 4
    assert counts["flash_fwd"] == 0
