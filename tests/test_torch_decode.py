"""PyTorch port decode vs the JAX package on the CPU: the counter RNG bit
for bit, sampling filters and draws, and the generators' greedy and
sampled output token for token (same weights through the bridge)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.predictors import CachedSequenceGenerator as JCached
from distkeras_tpu.predictors import SequenceGenerator as JSeq
from distkeras_tpu.serving import sampling as jsp
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.predictors import CachedSequenceGenerator, SequenceGenerator
from distkeras_tpu_torch.serving import sampling as sp
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=64, d_model=128, num_heads=2, depth=2)


@pytest.fixture(scope="module")
def lms():
    jlm = jzoo.transformer_lm(**LM, seed=0)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    return jlm, lm


def _prompts(lens=(5, 9, 17, 3), seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 61, n).astype(np.int32) for n in lens]


def _same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b)
    )


@pytest.mark.parametrize("seed", [0, 1, 9, 2**31 - 1])
def test_threefry_bits_match_jax(seed):
    """fold_in(fold_in(PRNGKey(0), seed), pos) and the random bits drawn
    from it, bit for bit, over a grid of positions and two widths."""
    pos = np.array([0, 1, 7, 63, 511, 4095])
    k1, k2 = sp.row_keys(torch.full((pos.size,), seed), torch.from_numpy(pos))
    for i, p in enumerate(pos):
        jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), seed),
                                int(p))
        assert [int(k1[i]), int(k2[i])] == np.asarray(jk).tolist()
        for n in (61, 8192):
            want = np.asarray(jax.random.bits(jk, (n,), jnp.uint32))
            got = sp.random_bits((k1[i : i + 1], k2[i : i + 1]), n)[0]
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_categorical_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((16, 61)).astype(np.float32) * 3
    seeds, spos = np.arange(16) * 7 + 1, np.arange(16) * 3
    keys = jsp._row_keys(jnp.asarray(seeds), jnp.asarray(spos))
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    got = sp.categorical(
        sp.row_keys(torch.from_numpy(seeds), torch.from_numpy(spos)),
        torch.from_numpy(logits),
    )
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "top_k, top_p",
    [([0, 0], [1.0, 1.0]), ([5, 1], [1.0, 1.0]), ([0, 0], [0.9, 0.3]),
     ([5, 0], [0.8, 0.95])],
    ids=["off", "top_k", "top_p", "mixed"],
)
def test_filter_logits_matches_jax(top_k, top_p):
    scaled = np.random.default_rng(3).standard_normal((2, 61)).astype(
        np.float32) * 2
    want = np.asarray(jsp.filter_logits(
        jnp.asarray(scaled), jnp.asarray(top_k), jnp.asarray(top_p, jnp.float32)
    ))
    got = sp.filter_logits(
        torch.from_numpy(scaled), torch.tensor(top_k),
        torch.tensor(top_p, dtype=torch.float32),
    ).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)])


def test_sample_tokens_matches_jax():
    """Mixed rows: greedy, plain temperature, top-k, nucleus."""
    logit = np.random.default_rng(4).standard_normal((4, 61)).astype(
        np.float32) * 2
    temps = np.array([0.0, 0.8, 1.2, 0.7], np.float32)
    topk, topp = np.array([0, 0, 5, 0]), np.array([1, 1, 1, 0.9], np.float32)
    seeds, spos = np.array([0, 9, 3, 12]), np.array([0, 4, 2, 7])
    want = np.asarray(jsp.sample_tokens(
        jnp.asarray(logit), jnp.asarray(temps), jnp.asarray(topk),
        jnp.asarray(topp), jnp.asarray(seeds), jnp.asarray(spos),
    ))
    got = sp.sample_tokens(*(torch.from_numpy(a) for a in (
        logit, temps, topk, topp, seeds, spos)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_params_validate_and_wire():
    p = sp.SamplingParams(temperature=0.8, top_k=5, seed=2**31 + 9)
    assert p.seed == 9 and sp.SamplingParams.from_wire(p.to_wire()).top_k == 5
    assert sp.seed_for_completion(9, 2) == jsp.seed_for_completion(9, 2)
    with pytest.raises(ValueError, match="temperature"):
        sp.SamplingParams(top_k=3)
    with pytest.raises(ValueError, match="unknown"):
        sp.SamplingParams.from_wire({"grammar": {"kind": "allow"}})


def test_cached_greedy_ragged_matches_jax(lms):
    jlm, lm = lms
    prompts = _prompts()
    assert _same(CachedSequenceGenerator(lm, device="cpu").generate(prompts, 12),
                 JCached(jlm).generate(prompts, 12))


def test_cached_greedy_rectangular_with_eos_matches_jax(lms):
    jlm, lm = lms
    prompts = np.stack(_prompts(lens=(7, 7, 7), seed=5))
    got = CachedSequenceGenerator(lm, device="cpu").generate(prompts, 10)
    want = JCached(jlm).generate(prompts, 10)
    np.testing.assert_array_equal(got, np.asarray(want))
    eos = int(want[0, 9])  # a token the first row emits
    assert _same(
        CachedSequenceGenerator(lm, device="cpu").generate(prompts, 10, eos),
        JCached(jlm).generate(prompts, 10, eos_id=eos),
    )


def test_uncached_greedy_ragged_matches_jax(lms):
    jlm, lm = lms
    prompts = _prompts(lens=(4, 11, 6))
    assert _same(SequenceGenerator(lm, device="cpu").generate(prompts, 6),
                 JSeq(jlm).generate(prompts, 6))


@pytest.mark.parametrize(
    "kw", [dict(temperature=0.8, seed=9),
           dict(temperature=1.1, seed=3, top_k=5, top_p=0.8)],
    ids=["temperature", "top_k_top_p"],
)
def test_cached_sampled_matches_jax(lms, kw):
    jlm, lm = lms
    prompts = _prompts()
    assert _same(CachedSequenceGenerator(lm, device="cpu", **kw).generate(prompts, 12),
                 JCached(jlm, **kw).generate(prompts, 12))


def test_cached_generator_refuses_attention_hooks(lms):
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.parallel.ring_attention import detach_ring_attention

    _, lm = lms
    assert attach_flash_attention(lm) == 2
    try:
        with pytest.raises(ValueError, match="attention_fn"):
            CachedSequenceGenerator(lm, device="cpu")
    finally:
        assert detach_ring_attention(lm) == 2
