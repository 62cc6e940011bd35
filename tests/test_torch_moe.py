"""The port's switch mixture-of-experts against the JAX package.

``switch_route``'s dispatch equals JAX's exactly and its combine and
load-balance loss to 1e-6 absolute, through a capacity overflow and an
argmax tie; ``moe_ffn``'s output and its gradients with respect to x,
router, wi and wo to 1e-5 absolute (with drops and without); the ``MoE``
layer's config, parameter and state names and a bundle cross both
implementations; the MoE builders' parameter trees equal JAX's in keys and
shapes; the MoE LM is causal (JAX ``tests/test_lm.py``'s case); and
three ``SingleTrainer`` steps of the MoE LM and of the MoE classifier,
with the load-balance loss in the training loss, give JAX's per-step
losses to 1e-4 relative. All on the CPU at d32, 4 experts, inputs and
weights from ``numpy.random.default_rng`` (weights bridged from JAX's).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.parallel import expert_parallel as jep
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.models.sequential import Sequential
from distkeras_tpu_torch.parallel import MoE, moe_ffn, switch_route
from distkeras_tpu_torch.trainers import SingleTrainer
from distkeras_tpu_torch.utils import serialization as ts
from distkeras_tpu_torch.utils.convert import params_from_jax, state_from_jax

torch.set_num_threads(2)

ROUTE_TOL = 1e-6
FFN_TOL = 1e-5
LOSS_RTOL = 1e-4
LM = dict(vocab_size=32, seq_len=16, d_model=32, num_heads=2, depth=1,
          num_experts=4)
CLS = dict(vocab_size=32, seq_len=16, d_model=32, num_heads=2, depth=2,
           num_experts=4, num_classes=3)


def _np(t):
    return t.detach().cpu().numpy()


def _bridge(jm, tm):
    params_from_jax(tm, jax.tree.map(np.asarray, jm.params))
    state_from_jax(tm, jax.tree.map(np.asarray, jm.state))
    return tm


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(np.shape(v))
    return out


# --------------------------------------------------------------- routing


def _logits(s=37, e=4, seed=0):
    logits = np.random.default_rng(seed).normal(size=(s, e)).astype(
        np.float32)
    logits[5] = logits[5, 0]  # a four-way tie: the first expert wins
    logits[6, 1] = logits[6, 3] = logits[6].max() + 1.0  # a two-way tie
    return logits


@pytest.mark.parametrize("capacity", [3, 9, 40], ids=["drops", "some",
                                                      "none"])
def test_switch_route_matches_jax(capacity):
    logits = _logits()
    jd, jc, ja = jep.switch_route(jnp.asarray(logits), capacity)
    d, c, a = switch_route(torch.tensor(logits), capacity)
    assert d.shape == (37, 4, capacity)
    np.testing.assert_array_equal(_np(d), np.asarray(jd))
    np.testing.assert_allclose(_np(c), np.asarray(jc), atol=ROUTE_TOL,
                               rtol=0)
    assert abs(float(a) - float(ja)) <= ROUTE_TOL
    kept = _np(d).sum(axis=(1, 2))
    if capacity == 3:  # overflow: dropped tokens have all-zero rows
        assert (kept == 0).any() and (_np(d).sum(axis=0) <= 1).all()
    assert _np(d)[5, 0].sum() == kept[5] and _np(d)[6, 1].sum() == kept[6]


def _ffn_case(seed, d=16, e=4, h=64, lead=(3, 11)):
    rng = np.random.default_rng(seed)
    p = {
        "router": rng.normal(size=(d, e)).astype(np.float32),
        "wi": (0.1 * rng.normal(size=(e, d, h))).astype(np.float32),
        "wo": (0.1 * rng.normal(size=(e, h, d))).astype(np.float32),
    }
    x = rng.normal(size=(*lead, d)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    return p, x, w


@pytest.mark.parametrize("cf", [1.25, 4.0], ids=["drops", "no_drops"])
def test_moe_ffn_and_gradients_match_jax(cf):
    p, x, w = _ffn_case(1)

    def jloss(p, x):
        o, a = jep.moe_ffn(p, x, capacity_factor=cf)
        return jnp.sum(o * w) + a, (o, a)

    (jl, (jo, ja)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    o, a = moe_ffn(tp, tx, capacity_factor=cf)
    ((o * torch.tensor(w)).sum() + a).backward()
    np.testing.assert_allclose(_np(o), np.asarray(jo), atol=FFN_TOL, rtol=0)
    assert abs(float(_np(a)) - float(ja)) <= ROUTE_TOL
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jgx), atol=FFN_TOL,
                               rtol=0)
    for k in p:
        np.testing.assert_allclose(_np(tp[k].grad), np.asarray(jgp[k]),
                                   atol=FFN_TOL, rtol=0)


def test_expert_mesh_is_absent_from_the_signatures():
    """``moe_ffn`` takes a ``parallel.mesh`` group or grid as its mesh
    and fails loudly on anything else instead of computing unsharded; the
    layer takes its groups from the attach helpers, not its constructor
    (``tests/test_torch_expert_parallel.py`` runs the mesh)."""
    p, x, _ = _ffn_case(3)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    with pytest.raises(TypeError):
        moe_ffn(tp, torch.tensor(x), mesh=object())
    with pytest.raises(TypeError):
        MoE(4, mesh=object())


def test_moe_ffn_bf16_keeps_f32_router_and_x_dtype():
    p, x, _ = _ffn_case(2)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    o, a = moe_ffn(tp, torch.tensor(x).bfloat16())
    assert o.dtype == torch.bfloat16 and a.dtype == torch.float32
    jo, ja = jep.moe_ffn(jax.tree.map(jnp.asarray, p),
                         jnp.asarray(x).astype(jnp.bfloat16))
    # the routing (f32 logits) and so the aux loss are x's f32 image's
    assert abs(float(a) - float(ja)) <= ROUTE_TOL
    np.testing.assert_allclose(_np(o.float()), np.asarray(jo, np.float32),
                               atol=2e-2, rtol=0)


# ----------------------------------------------------------------- layer


def test_moe_layer_in_sequential_config_state_and_bundles():
    from distkeras_tpu.models.layers import Dense as JDense
    from distkeras_tpu.models.sequential import Sequential as JSequential
    from distkeras_tpu.utils import serialization as js

    jm = JSequential([JDense(24), jep.MoE(4, hidden_ratio=2,
                                          capacity_factor=2.0),
                      JDense(5)])
    jm.build((7, 12), seed=3)
    tm = Sequential.from_config(jm.get_config()).build((7, 12), device="cpu")
    assert tm.get_config() == jm.get_config()
    assert isinstance(tm.layers[1], MoE)
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} \
        == _leaves(jm.params)
    assert {n: tuple(b.shape) for n, b in tm.named_buffers()} \
        == _leaves(jm.state) == {"1.aux_loss": ()}
    _bridge(jm, tm)
    x = np.random.default_rng(4).normal(size=(3, 7, 12)).astype(np.float32)
    y, st = jm.apply(jm.params, jm.state, x)
    np.testing.assert_allclose(_np(tm(torch.tensor(x))), np.asarray(y),
                               atol=FFN_TOL, rtol=0)
    # the eval forward wrote its load-balance loss, detached
    assert not tm.layers[1].aux_loss.requires_grad
    assert abs(float(tm.layers[1].aux_loss) - float(st["1"]["aux_loss"])) \
        <= ROUTE_TOL
    # bundles cross both ways
    back = ts.deserialize_model(js.serialize_model(jm), device="cpu")
    np.testing.assert_allclose(_np(back(torch.tensor(x))), np.asarray(y),
                               atol=FFN_TOL, rtol=0)
    jback = js.deserialize_model(ts.serialize_model(tm))
    np.testing.assert_allclose(np.asarray(jback(x)), np.asarray(y),
                               atol=FFN_TOL, rtol=0)


def test_aux_loss_hand_over_and_copies_carry_no_graph():
    m = Sequential([MoE(4)]).build((5, 8), device="cpu")
    x = torch.randn(2, 5, 8)
    m(x).sum().backward()
    layer = m.layers[0]
    live = layer.take_aux_loss()
    assert live is not None and live.requires_grad
    assert layer.take_aux_loss() is None  # handed over once
    assert float(layer.aux_loss) == pytest.approx(float(live.detach()))
    m(x)  # a grad-enabled forward left un-taken: copies drop it
    assert m.copy().layers[0].take_aux_loss() is None
    with torch.no_grad():
        m(x)
    assert layer.take_aux_loss() is None


# -------------------------------------------------------------- builders


@pytest.mark.parametrize("name,kw", [
    ("moe_transformer_lm", LM),
    ("moe_transformer_classifier", CLS),
])
def test_builders_match_jax_trees(name, kw):
    jm = getattr(jzoo, name)(**kw)
    tm = getattr(zoo, name)(**kw, device="cpu")
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} \
        == _leaves(jm.params)
    assert {n: tuple(b.shape) for n, b in tm.named_buffers()} \
        == _leaves(jm.state)
    assert tm.get_config() == jm.get_config()
    assert tm.num_params() == sum(v.size for v in jax.tree.leaves(jm.params))
    assert (name in zoo.ZOO) == (name in jzoo.ZOO)


def test_moe_lm_is_causal():
    lm = zoo.moe_transformer_lm(**LM, device="cpu")
    x = np.random.default_rng(9).integers(0, 32, (1, 16))
    x2 = x.copy()
    x2[0, 9] = (x2[0, 9] + 1) % 32
    with torch.no_grad():
        base, out2 = lm(torch.tensor(x)), lm(torch.tensor(x2))
    np.testing.assert_allclose(_np(base[0, :9]), _np(out2[0, :9]), atol=1e-5,
                               rtol=0)
    assert not np.allclose(_np(base[0, 9:]), _np(out2[0, 9:]))


# -------------------------------------------------------------- training


def _train_pair(jm, tm, loss, x, y):
    from distkeras_tpu import SingleTrainer as JSingleTrainer
    from distkeras_tpu.data.dataset import Dataset as JDataset

    kw = dict(batch_size=8, window=3, learning_rate=1e-2, seed=0,
              aux_loss_weight=0.01)
    jt = JSingleTrainer(jm, "adam", loss, **kw)
    jt.train(JDataset({"features": x, "label": y}))
    tt = SingleTrainer(tm, "adam", loss, device="cpu", **kw)
    res = tt.train(Dataset({"features": x, "label": y}))
    return jt.get_history(), tt.get_history(), res


def test_single_trainer_moe_lm_matches_jax():
    x = np.random.default_rng(11).integers(0, 32, (24, 16)).astype(np.int32)
    jm = jzoo.moe_transformer_lm(**LM, seed=0)
    tm = _bridge(jm, zoo.moe_transformer_lm(**LM, device="cpu"))
    jh, th, res = _train_pair(jm, tm, "next_token_crossentropy", x, x)
    assert len(th) == len(jh) == 3
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_RTOL)
    # the trained copy's buffer holds a detached load-balance loss
    aux = res.layers[2].aux_loss
    assert not aux.requires_grad and 0.0 < float(aux) < 4.0


def test_single_trainer_moe_classifier_matches_jax():
    rng = np.random.default_rng(12)
    x = rng.integers(0, 32, (24, 16)).astype(np.int32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 24)]
    jm = jzoo.moe_transformer_classifier(**CLS, seed=0)
    tm = _bridge(jm, zoo.moe_transformer_classifier(**CLS, device="cpu"))
    jh, th, _ = _train_pair(jm, tm, "categorical_crossentropy", x, y)
    assert len(th) == len(jh) == 3
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_RTOL)
