"""The port's ``blockwise_attention`` against the JAX package.

The cases of JAX ``tests/test_ring_attention.py``'s blockwise tests and
``tests/test_long_context.py``'s T = 2048 ones: outputs (causal and not)
equal JAX's ``blockwise_attention`` to 2e-5 absolute at T = 64 with
16-key blocks and 3e-5 at T = 2048 with 512-key blocks, gradients of
sum(out^2) to 3e-4 and 5e-4 (fully masked causal blocks included, every
gradient finite); the same refusals (a T the block does not divide, and
cross-attention), the dense case at T <= block_size, and the hook face
(``attach_blockwise_attention`` on a model's forward and one training
step against the unhooked model). All on the CPU, inputs from
``numpy.random.default_rng``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.parallel.ring_attention import (
    blockwise_attention as jblockwise,
    dense_attention as jdense,
)
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.parallel import (
    attach_blockwise_attention,
    blockwise_attention,
    dense_attention,
    detach_ring_attention,
)

torch.set_num_threads(2)

SHORT = ((2, 64, 4, 16), 16, 2e-5, 3e-4)   # shape, block, out tol, grad tol
LONG = ((1, 2048, 2, 8), 512, 3e-5, 5e-4)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("case", [SHORT, LONG], ids=["t64", "t2048"])
@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_matches_jax(case, causal):
    shape, block, tol, _ = case
    q, k, v = _qkv(shape, seed=2)
    want = jblockwise(*map(jnp.asarray, (q, k, v)), causal=causal,
                      block_size=block)
    got = blockwise_attention(*map(torch.tensor, (q, k, v)), causal=causal,
                              block_size=block)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=tol, rtol=0)
    ref = dense_attention(*map(torch.tensor, (q, k, v)), causal=causal)
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=0)


@pytest.mark.parametrize("case", [SHORT, LONG], ids=["t64", "t2048"])
def test_blockwise_gradients_match_jax(case):
    """Causal: the later K/V blocks are fully masked for the early query
    rows, whose running max stays -inf through them."""
    shape, block, _, tol = case
    q, k, v = _qkv(shape, seed=3)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jblockwise(
            q, k, v, causal=True, block_size=block) ** 2),
        argnums=(0, 1, 2),
    )(*map(jnp.asarray, (q, k, v)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    (blockwise_attention(*ts, causal=True, block_size=block) ** 2) \
        .sum().backward()
    for t, w in zip(ts, want):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), atol=tol,
                                   rtol=0)


def test_blockwise_refusals_match_jax():
    q, k, v = map(torch.tensor, _qkv(SHORT[0]))
    jq, jk, jv = map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy()))
    for fn, a in ((blockwise_attention, (q, k, v)),
                  (jblockwise, (jq, jk, jv))):
        with pytest.raises(ValueError, match="not divisible"):
            fn(*a, block_size=48)
        with pytest.raises(ValueError, match="self-attention only"):
            fn(a[0], a[1][:, :32], a[2], block_size=16)


def test_blockwise_short_seq_is_the_dense_case():
    q, k, v = _qkv(SHORT[0], seed=4)
    got = blockwise_attention(*map(torch.tensor, (q, k, v)), causal=True)
    want = jdense(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5, rtol=0)


def test_attach_blockwise_forward_and_training_step():
    """The hook face: every attention of the model goes blockwise; its
    forward and its next-token loss's gradients equal the unhooked
    model's within f32 accumulation order."""
    lm = zoo.transformer_lm(32, 64, 32, 2, 2, device="cpu")
    ref = lm.copy()
    assert attach_blockwise_attention(lm, block_size=16) == 2
    x = torch.tensor(np.random.default_rng(5).integers(0, 32, (2, 64)))
    with torch.no_grad():
        torch.testing.assert_close(lm(x), ref(x), atol=2e-5, rtol=0)
    for m in (lm, ref):
        m.train()
        torch.nn.functional.cross_entropy(
            m(x)[:, :-1].reshape(-1, 32), x[:, 1:].reshape(-1)).backward()
    for (n, a), (_, b) in zip(lm.named_parameters(), ref.named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, atol=2e-5, rtol=1e-4,
                                   msg=n)
    assert detach_ring_attention(lm) == 2
