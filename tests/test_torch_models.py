"""PyTorch port models vs the JAX package on the CPU: layers, the
transformer LM through the weight bridge (with and without the kernel
hooks), configs, and the gelu approximation pin. Tolerance 1e-4 absolute
on logits: f32 throughout, only the summation order differs."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import layers as jlayers
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.models.sequential import Sequential as JSequential
from distkeras_tpu.ops.flash_attention import attach_flash_attention as jflash
from distkeras_tpu.ops.fused_layernorm import attach_fused_layernorm as jln
from distkeras_tpu_torch.models import layers, zoo
from distkeras_tpu_torch.models.sequential import Sequential
from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=64, d_model=128, num_heads=2, depth=2)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def lms():
    jlm = jzoo.transformer_lm(**LM, seed=0)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, _np_tree(jlm.params))
    return jlm, lm


def _tokens(b=3, t=64, seed=0):
    return np.random.default_rng(seed).integers(0, 61, (b, t)).astype(np.int32)


def test_lm_logits_match_jax(lms):
    jlm, lm = lms
    x = _tokens()
    with torch.no_grad():
        got = lm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlm(x)), atol=1e-4, rtol=0)


def test_lm_logits_with_both_hooks_match_jax(lms):
    """JAX with its Pallas LayerNorm and flash kernels (interpret mode) vs
    the port with both hooks attached (their plain versions on CPU)."""
    _, lm0 = lms
    jlm = jzoo.transformer_lm(**LM, seed=0)
    assert jln(jlm) == 5 and jflash(jlm, block_q=32, block_k=32) == 2
    lm = zoo.transformer_lm(**LM, device="cpu")
    lm.load_state_dict(lm0.state_dict())
    assert attach_fused_layernorm(lm) == 5 and attach_flash_attention(lm) == 2
    x = _tokens(b=2, seed=1)
    with torch.no_grad():
        got = lm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlm(x)), atol=1e-4, rtol=0)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to approximate=True; the port must match it,
    not torch's exact-erf default."""
    x = np.linspace(-5, 5, 1001).astype(np.float32)
    got = layers.get_activation("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - exact).max() > 1e-4


def test_get_config_is_json_identical(lms):
    jlm, lm = lms
    assert json.dumps(lm.get_config()) == json.dumps(jlm.get_config())
    rebuilt = Sequential.from_config(json.loads(json.dumps(jlm.get_config())))
    assert json.dumps(rebuilt.get_config()) == json.dumps(jlm.get_config())


def test_param_names_and_shapes_follow_the_jax_tree(lms):
    jlm, lm = lms
    flat = {
        ".".join(str(k.key) for k in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(jlm.params)[0]
    }
    assert {k: tuple(p.shape) for k, p in lm.named_parameters()} == flat
    assert lm.num_params() == jlm.num_params()


def test_bridge_rejects_mismatched_trees(lms):
    jlm, lm = lms
    tree = _np_tree(jlm.params)
    del tree["1"]["mhsa"]["bo"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(zoo.transformer_lm(**LM, device="cpu"), tree)
    tree = _np_tree(jlm.params)
    tree["0"]["tokens"] = tree["0"]["tokens"][:10]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(zoo.transformer_lm(**LM, device="cpu"), tree)


@pytest.mark.parametrize(
    "make, in_shape",
    [
        (lambda m: m.Dense(48, activation="gelu"), (10, 32)),
        (lambda m: m.LayerNorm(), (10, 32)),
        (lambda m: m.MultiHeadSelfAttention(2, causal=True), (12, 32)),
        (lambda m: m.TransformerBlock(2, causal=False), (12, 32)),
        (lambda m: m.Embedding(17, 32), (12,)),
    ],
    ids=["dense_gelu", "layernorm", "mhsa_causal", "block", "embedding"],
)
def test_layer_matches_jax(make, in_shape):
    jmodel = JSequential([make(jlayers)]).build(in_shape, seed=3)
    model = Sequential([make(layers)]).build(in_shape, device="cpu")
    params_from_jax(model, _np_tree(jmodel.params))
    rng = np.random.default_rng(4)
    if len(in_shape) == 1:
        x = rng.integers(0, 17, (2, *in_shape)).astype(np.int32)
    else:
        x = rng.standard_normal((2, *in_shape)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel(jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)
