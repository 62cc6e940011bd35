"""PyTorch port ops vs the JAX package on the CPU: fused LayerNorm, the
FlashAttention forward, dense attention, weight-only quantized matmul.

The JAX side runs as its own tests run it here (Pallas kernels in
interpret mode); the port runs its kernels' plain PyTorch versions, which
is what a CPU tensor gets. The CUDA kernels themselves are held against
the same plain versions on the card by ``test_torch_kernels.py`` (marker
``gpu``) and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops import flash_attention as jfa
from distkeras_tpu.ops import fused_layernorm as jln
from distkeras_tpu.ops import quantization as jq
from distkeras_tpu.parallel.ring_attention import dense_attention as jdense
from distkeras_tpu_torch.ops import flash_attention as tfa
from distkeras_tpu_torch.ops import fused_layernorm as tln
from distkeras_tpu_torch.ops import quantization as tq
from distkeras_tpu_torch.parallel.ring_attention import dense_attention

torch.set_num_threads(2)


def _ln_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, g, b


# d = 128 with >= 8 rows takes the JAX package's Pallas kernel (interpret
# mode); d = 32 its plain path. Tolerance 1e-5: f32, reduction order only.
@pytest.mark.parametrize("shape", [(16, 128), (2, 8, 128), (3, 32), (5, 7, 32)])
def test_fused_layer_norm_matches_jax(shape):
    x, g, b = _ln_inputs(shape)
    ref = np.asarray(jln.fused_layer_norm(jnp.asarray(x), g, b, 1e-5))
    got = tln.fused_layer_norm(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), 1e-5
    )
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


def test_fused_layer_norm_bf16_matches_jax():
    """bf16 in, bf16 out, f32 inside: equal to one bf16 rounding step."""
    x, g, b = _ln_inputs((16, 128), seed=1)
    ref = np.asarray(
        jln.fused_layer_norm(jnp.asarray(x, jnp.bfloat16), g, b)
    ).astype(np.float32)
    got = tln.fused_layer_norm(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(g),
        torch.from_numpy(b),
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("shape", [(16, 128), (2, 8, 512), (5, 7, 510)])
def test_fused_layer_norm_shortcut_without_grad(shape, monkeypatch):
    """Where no gradient can flow (``torch.no_grad``, or nothing requiring
    grad) ``fused_layer_norm`` skips the autograd function: the same bits
    as the autograd path, JAX's ``fused_layer_norm`` to 1e-5, and no
    launch counted on CPU tensors."""
    from distkeras_tpu_torch import kernels

    x, g, b = _ln_inputs(shape, seed=2)
    ref = np.asarray(jln.fused_layer_norm(jnp.asarray(x), g, b, 1e-5))
    tx, tg, tb = (torch.from_numpy(a) for a in (x, g, b))
    pg, pb = tg.clone().requires_grad_(), tb.clone().requires_grad_()
    graded = tln.fused_layer_norm(tx, pg, pb, 1e-5)
    assert graded.grad_fn is not None
    kernels.reset_launch_counts()

    def refuse(*args):
        raise AssertionError("the autograd function ran")

    monkeypatch.setattr(tln._FusedLayerNorm, "apply", refuse)
    with torch.no_grad():
        quiet = tln.fused_layer_norm(tx, pg, pb, 1e-5)
    plain = tln.fused_layer_norm(tx, tg, tb, 1e-5)
    assert quiet.grad_fn is None and plain.grad_fn is None
    assert torch.equal(quiet, graded.detach()) and torch.equal(plain, quiet)
    np.testing.assert_allclose(plain.numpy(), ref, atol=1e-5, rtol=0)
    assert not any(kernels.launch_counts().values())


def _qkv(b=2, t=64, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _infinite_q_row():
    """(1, 16, 1, 64) f32 from ``default_rng(3)``: every key's first
    component negative, q row 5 = (+inf, 0, ..., 0), so each score of that
    row is -inf and the row attends nothing."""
    q, k, v = _qkv(b=1, t=16, h=1, seed=3)
    k[..., 0] = -np.abs(k[..., 0]) - 0.5
    q[0, 5, 0] = 0.0
    q[0, 5, 0, 0] = np.inf
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_plain_matches_jax_kernel(causal):
    """O and lse of the kernel's plain version vs the Pallas forward
    (``_fwd`` in interpret mode, 32x32 blocks; 16x16 for the second
    input). O to 2e-5, lse to 1e-5. The second input has a row whose
    scores are all -inf (an infinite q element): JAX's guards give it O = 0
    and lse = -inf, and so must the plain version."""
    for (q, k, v), blk in ((_qkv(), 32), (_infinite_q_row(), 16)):
        jq_, jk, jv = (jnp.swapaxes(jnp.asarray(a), 1, 2) for a in (q, k, v))
        out, lse = jfa._fwd(jq_, jk, jv, causal, blk, blk, True)
        o, tlse = tfa._reference_flash_fwd(
            *(torch.from_numpy(a) for a in (q, k, v)), causal
        )
        out, lse = np.swapaxes(np.asarray(out), 1, 2), np.asarray(lse)
        assert not np.isnan(out).any() and not np.isnan(lse).any()
        np.testing.assert_allclose(o.numpy(), out, atol=2e-5, rtol=0)
        np.testing.assert_allclose(tlse.numpy(), lse, atol=1e-5, rtol=0)
    assert (o.numpy()[0, 5, 0] == 0).all() and (out[0, 5, 0] == 0).all()
    assert tlse[0, 0, 5, 0] == lse[0, 0, 5, 0] == -np.inf


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(causal):
    q, k, v = _qkv(t=64, seed=3)
    ref = jfa.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
        block_q=32, block_k=32,
    )
    got = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_matches_jax(causal):
    q, k, v = _qkv(t=40, seed=4)
    ref = jdense(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    got = dense_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_qmatmul_f32_int8_int4_match_jax():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((33, 24)).astype(np.float32)  # odd rows: int4 pad
    x = rng.standard_normal((4, 33)).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(
        tq.qmatmul(tx, tw).numpy(), np.asarray(jq.qmatmul(x, w)), atol=1e-5
    )
    j8 = jq.quantize_int8(w)
    t8 = {"q": torch.from_numpy(np.array(j8["q"])),
          "s": torch.from_numpy(np.array(j8["s"]))}
    np.testing.assert_array_equal(tq.quantize_int8(tw)["q"].numpy(),
                                  np.asarray(j8["q"]))
    np.testing.assert_allclose(
        tq.qmatmul(tx, t8).numpy(), np.asarray(jq.qmatmul(x, j8)), atol=1e-4
    )
    j4 = jq.quantize_int4(w)
    t4 = tq.Int4Weight(torch.from_numpy(np.array(j4.q4)),
                       torch.from_numpy(np.array(j4.s)), j4.rows)
    np.testing.assert_array_equal(tq.quantize_int4(tw).q4.numpy(),
                                  np.asarray(j4.q4))
    assert tq.qshape(t4) == jq.qshape(j4) == (33, 24)
    np.testing.assert_allclose(tq.dequantize(t4).numpy(),
                               np.asarray(jq.dequantize(j4)), atol=1e-6)
    np.testing.assert_allclose(
        tq.qmatmul(tx, t4).numpy(), np.asarray(jq.qmatmul(x, j4)), atol=1e-4
    )
