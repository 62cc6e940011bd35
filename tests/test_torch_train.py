"""The PyTorch port's training slice vs the JAX package on the CPU.

Same inputs (numpy, seeded) and bridged weights go through the JAX
function and its port. The JAX side runs its Pallas kernels as its own
tests run them here (interpret mode); the port runs its kernels' plain
versions, which is what CPU tensors get. The CUDA kernels are held against
the same plain versions on the card (``test_torch_kernels.py``, marker
``gpu``, and ``chip_smoke.py``). Tolerances: f32 throughout, so only the
summation order differs — 1e-6 for the optimizer updates, 2e-5 / 1e-5 for
the attention / LayerNorm gradients, 1e-4 (relative) for losses after a
few training steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.data import loaders as jloaders
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.ops import flash_attention as jfa
from distkeras_tpu.ops import fused_layernorm as jln
from distkeras_tpu.ops import losses as jlosses
from distkeras_tpu.ops import metrics as jmetrics
from distkeras_tpu.ops.pallas_kernels import FusedAdam as JFusedAdam
from distkeras_tpu.trainers import SingleTrainer as JSingleTrainer
from distkeras_tpu_torch import kernels, loaders, zoo
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.prefetch import Prefetcher
from distkeras_tpu_torch.models.layers import Dropout, TransformerBlock
from distkeras_tpu_torch.models.sequential import Sequential
from distkeras_tpu_torch.ops import flash_attention as tfa
from distkeras_tpu_torch.ops import fused_layernorm as tln
from distkeras_tpu_torch.ops import losses as tlosses
from distkeras_tpu_torch.ops import metrics as tmetrics
from distkeras_tpu_torch.ops import optimizers as topt
from distkeras_tpu_torch.ops.pallas_kernels import FusedAdam, FusedSGD
from distkeras_tpu_torch.ops.quantization import quantize_int8
from distkeras_tpu_torch.trainers import SingleTrainer
from distkeras_tpu_torch.utils import tree
from distkeras_tpu_torch.utils.convert import params_from_jax
from distkeras_tpu_torch.utils.rng import RngSeq, split_seed

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)
TRAIN = dict(metrics=["next_token_accuracy"], batch_size=8, window=2,
             learning_rate=1e-3, seed=0)


def _np(t):
    return t.detach().cpu().numpy()


def _flat_jax(params):
    return {
        ".".join(str(k.key) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]
    }


def _tokens(n=32, seed=0):
    return np.random.default_rng(seed).integers(0, 61, (n, 32)).astype(np.int32)


def _port_lm(jlm, hooks=True, **kw):
    lm = zoo.transformer_lm(**LM, device="cpu", **kw)
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    if hooks:
        tln.attach_fused_layernorm(lm)
        tfa.attach_flash_attention(lm)
    return lm


@pytest.fixture(scope="module")
def jlm():
    return jzoo.transformer_lm(**LM, seed=0)


# ------------------------------------------------------------------- B3


#: |p| bound between the port's plain Adam and JAX's Pallas path (below)
ADAM_P_TOL = 1e-6


def test_adam_plain_matches_jax_fused_adam():
    """B3's plain version (the port's FusedAdam on CPU tensors, i.e.
    ``_adam_math``) vs the JAX FusedAdam with its Pallas kernel in
    interpret mode, over a leaf under 1024 elements (JAX's jnp path) and
    one above (its kernel), checked after each of 3 steps.

    What may differ, and the tolerance from it: JAX's jnp path dispatches
    each operation on its own (eager), so it rounds exactly where the port
    does: bit-equal. The interpreted kernel is one XLA:CPU program, which
    contracts multiply-adds into FMAs (one rounding fewer each): 1.2e-7 on
    p here, at most 2.4e-7 under ``--xla_cpu_max_isa`` SSE4_2 or AVX2
    and XLA's fast-math flags; ADAM_P_TOL = 1e-6 keeps a 4x margin. m, v: 1e-6;
    the count exact. The bias corrections' f32 pows (XLA's, ATen's) agree
    bit for bit for b1, b2 at t = 1..5; a 3-ulp error in either at any
    step would move p by at most 1.1e-6 on one element. One suite run
    failed p by 3.0e-6 on 550 of the 2,560 kernel-path elements, which no
    such arithmetic difference reaches (even the port in f64 moves p by
    3.6e-7); the inputs are checked to leave the step untouched, and each
    step is checked, so a recurrence names its step and leaf."""
    rng = np.random.default_rng(0)
    shapes = {"small": (7, 9), "big": (40, 64)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    gs = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
          for _ in range(3)]
    inputs = [{k: v.copy() for k, v in d.items()} for d in [p0, *gs]]
    jopt = JFusedAdam(1e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init(jp)
    topt_ = FusedAdam(1e-2)
    names = sorted(shapes)
    tp = [torch.from_numpy(p0[k].copy()) for k in names]
    tstate = topt_.init(tp)
    for t, g in enumerate(gs, 1):
        jp, jstate = jopt.fused_apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                      jstate)
        topt_.fused_apply(tp, [torch.from_numpy(g[k]) for k in names], tstate)
        for i, k in enumerate(names):
            mine = [_np(tp[i]), _np(tstate[0][i]), _np(tstate[1][i])]
            ref = [np.asarray(x) for x in (jp[k], jstate[0][k], jstate[1][k])]
            for what, a, b, tol in zip("pmv", mine, ref, (ADAM_P_TOL, 1e-6, 1e-6)):
                msg = f"step {t}, leaf {k}, {what}"
                if k == "small":
                    np.testing.assert_array_equal(a, b, err_msg=msg)
                else:
                    np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=msg)
        assert int(tstate[2][0]) == int(jstate[2]) == t
        assert int(tstate[2][1]) == 0
    for before, after in zip(inputs, [p0, *gs]):
        for k in before:
            np.testing.assert_array_equal(before[k], after[k])


# --------------------------------------------------------------- B5, B6


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_jax_vjp(causal):
    """``_reference_flash_bwd`` vs ``jax.vjp`` of the JAX flash_attention
    (its dq/dkv Pallas kernels in interpret mode, 16x16 blocks), at
    (2, 32, 2, 16). 2e-5."""
    rng = np.random.default_rng(1)
    q, k, v, do = (rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
                   for _ in range(4))
    out, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal,
                                            block_q=16, block_k=16),
        *(jnp.asarray(a) for a in (q, k, v)),
    )
    ref = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tfa._reference_flash_fwd(tq, tk, tv, causal)
    got = tfa._reference_flash_bwd(tq, tk, tv, o, lse, tdo, causal)
    np.testing.assert_allclose(_np(o), np.asarray(out), atol=2e-5, rtol=0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), np.asarray(r), atol=2e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_autograd_matches_jax(causal):
    """The port's differentiable ``flash_attention`` (the autograd function
    that launches B4-B6 on CUDA, their plain versions here) vs JAX's."""
    rng = np.random.default_rng(2)
    q, k, v, do = (rng.standard_normal((2, 48, 2, 16)).astype(np.float32)
                   for _ in range(4))
    _, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal,
                                            block_q=16, block_k=16),
        *(jnp.asarray(a) for a in (q, k, v)),
    )
    ref = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (tfa.flash_attention(tq, tk, tv, causal=causal) * torch.from_numpy(do)).sum().backward()
    for t, r in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(_np(t.grad), np.asarray(r), atol=2e-5, rtol=0)


def test_flash_bwd_guards_rows_that_attend_nothing():
    """lse = -inf (a row with every key masked) shifts by 0, as the JAX
    kernels guard it: p = 0, no NaN."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 4, 1, 8))
                                    .astype(np.float32)) for _ in range(4))
    o, lse = tfa._reference_flash_fwd(q, k, v, False)
    lse[0, 0, 1, 0] = float("-inf")
    got = tfa._reference_flash_bwd(q, k, v, o, lse, do, False)
    assert all(torch.isfinite(g).all() for g in got)


# ------------------------------------------------------------------- B8


def test_layer_norm_bwd_plain_matches_jax_vjp():
    """``_reference_layer_norm_bwd`` vs ``jax.vjp`` of the JAX
    fused_layer_norm (its backward Pallas kernel in interpret mode), at
    (16, 128). 1e-5."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((16, 128)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    b = (0.1 * rng.standard_normal(128)).astype(np.float32)
    dy = rng.standard_normal((16, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, c, e: jln.fused_layer_norm(a, c, e, 1e-5),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    rdx, rdg, rdb = vjp(jnp.asarray(dy))
    dx, dg, db = tln._reference_layer_norm_bwd(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(dy), 1e-5)
    np.testing.assert_allclose(_np(dx), np.asarray(rdx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(dg), np.asarray(rdg), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(db), np.asarray(rdb), atol=1e-5, rtol=1e-5)
    # through the autograd function: the grads reach gamma and beta
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    (tln.fused_layer_norm(tx, tg, tb) * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(rdx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tg.grad), np.asarray(rdg), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tb.grad), np.asarray(rdb), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------- losses and metrics


def _loss_inputs(name, rng):
    if name == "next_token_crossentropy":
        return rng.standard_normal((3, 6, 11)).astype(np.float32), \
            rng.integers(0, 11, (3, 6)).astype(np.int32)
    if name == "categorical_crossentropy_from_logits":
        return rng.standard_normal((5, 7)).astype(np.float32), \
            np.eye(7, dtype=np.float32)[rng.integers(0, 7, 5)]
    if name == "categorical_crossentropy":
        p = rng.random((5, 7)).astype(np.float32)
        return p / p.sum(-1, keepdims=True), \
            np.eye(7, dtype=np.float32)[rng.integers(0, 7, 5)]
    if name == "sparse_categorical_crossentropy":
        p = rng.random((5, 7)).astype(np.float32)
        return p / p.sum(-1, keepdims=True), rng.integers(0, 7, 5)
    if name == "binary_crossentropy":
        return rng.random((9, 1)).astype(np.float32), \
            rng.integers(0, 2, (9, 1)).astype(np.float32)
    return rng.standard_normal((6, 1)).astype(np.float32), \
        rng.standard_normal((6, 1)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(jlosses._LOSSES))
def test_loss_matches_jax(name):
    assert set(tlosses._LOSSES) == set(jlosses._LOSSES)
    y_pred, y_true = _loss_inputs(name, np.random.default_rng(5))
    ref = float(jlosses.get_loss(name)(jnp.asarray(y_pred), jnp.asarray(y_true)))
    got = float(tlosses.get_loss(name)(torch.from_numpy(y_pred),
                                       torch.from_numpy(y_true)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_loss_refusals_match_jax():
    with pytest.raises(ValueError, match="seq_len >= 2"):
        tlosses.next_token_crossentropy(torch.zeros(2, 1, 5),
                                        torch.zeros(2, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="matching shapes"):
        tlosses.mse(torch.zeros(4, 1), torch.zeros(4))
    with pytest.raises(ValueError, match="unknown loss"):
        tlosses.get_loss("nope")


@pytest.mark.parametrize("name", ["accuracy", "next_token_accuracy"])
def test_metric_matches_jax(name):
    rng = np.random.default_rng(6)
    if name == "accuracy":
        y_pred = rng.standard_normal((20, 4)).astype(np.float32)
        for y_true in (rng.integers(0, 4, 20),
                       np.eye(4, dtype=np.float32)[rng.integers(0, 4, 20)]):
            ref = float(jmetrics.get_metric(name)(y_pred, y_true))
            got = float(tmetrics.get_metric("acc")(torch.from_numpy(y_pred),
                                                   torch.from_numpy(y_true)))
            assert got == pytest.approx(ref, abs=1e-6)  # mean's sum order
        return
    y_pred = rng.standard_normal((3, 9, 5)).astype(np.float32)
    y_true = rng.integers(0, 5, (3, 9)).astype(np.int32)
    ref = float(jmetrics.get_metric(name)(y_pred, y_true))
    got = float(tmetrics.get_metric(name)(torch.from_numpy(y_pred),
                                          torch.from_numpy(y_true)))
    assert got == pytest.approx(ref, abs=1e-6)


# ------------------------------------------------------------ optimizers


@pytest.mark.parametrize("name,kw,optax_fn", [
    ("sgd", {}, lambda: optax.sgd(0.05)),
    ("sgd", {"momentum": 0.9}, lambda: optax.sgd(0.05, momentum=0.9)),
    ("sgd", {"momentum": 0.9, "nesterov": True},
     lambda: optax.sgd(0.05, momentum=0.9, nesterov=True)),
    ("adam", {}, lambda: optax.adam(0.05)),
], ids=["sgd", "momentum", "nesterov", "adam"])
def test_optimizer_matches_optax(name, kw, optax_fn):
    rng = np.random.default_rng(7)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (4,))]
    gs = [[rng.standard_normal(a.shape).astype(np.float32) for a in p0]
          for _ in range(3)]
    ref_opt = optax_fn()
    jp = [jnp.asarray(a) for a in p0]
    jstate = ref_opt.init(jp)
    opt = topt.get_optimizer(name, 0.05, **kw)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    state = opt.init(tp)
    for g in gs:
        upd, jstate = ref_opt.update([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        upd_t, state = opt.update([torch.from_numpy(a) for a in g], state, tp)
        topt.apply_updates(tp, upd_t)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6, rtol=0)


def test_optimizer_table_and_refusals():
    assert set(topt._OPTIMIZERS) == {
        "sgd", "pallas_sgd", "pallas_adam", "adam", "adamw", "adagrad",
        "adadelta", "rmsprop", "nadam", "lamb"}
    assert isinstance(topt.get_optimizer("pallas_adam"), FusedAdam)
    assert topt.get_optimizer("adam").learning_rate == 1e-3
    assert topt.get_optimizer("sgd").learning_rate == 0.01
    assert topt.effective_learning_rate("adagrad") == 1e-2
    assert topt.effective_learning_rate("x", lambda step: 0.5) == 0.5
    assert isinstance(topt.get_optimizer("pallas_sgd"), FusedSGD)
    assert topt.get_optimizer("pallas_sgd", momentum=0.9).momentum == 0.9
    with pytest.raises(NotImplementedError, match="not ported"):
        topt.get_optimizer("rmsprop")
    with pytest.raises(NotImplementedError, match="not ported"):
        topt.get_schedule("warmup_cosine")
    with pytest.raises(TypeError, match="schedules"):
        FusedAdam(lambda step: 1e-3)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get_optimizer("nope")


# ------------------------------------------------------- the whole slice


def test_single_trainer_matches_jax(jlm):
    """The slice as a whole: SingleTrainer with both kernel hooks and
    pallas_adam, one shuffled epoch (4 steps in 2 windows) plus per-epoch
    validation, from the same weights as the JAX SingleTrainer with the
    same hooks (its Pallas kernels in interpret mode)."""
    x = _tokens()
    xv = _tokens(n=12, seed=9)
    jflm = jzoo.transformer_lm(**LM, seed=0)
    jln.attach_fused_layernorm(jflm)
    jfa.attach_flash_attention(jflm)
    jt = JSingleTrainer(jflm, "pallas_adam", "next_token_crossentropy",
                        validation_data=JDataset({"features": xv, "label": xv}),
                        **TRAIN)
    jres = jt.train(JDataset({"features": x, "label": x}), shuffle=True)
    lm = _port_lm(jlm)
    before = {k: v.clone() for k, v in lm.state_dict().items()}
    kernels.reset_launch_counts()
    tt = SingleTrainer(lm, "pallas_adam", "next_token_crossentropy",
                       validation_data=Dataset({"features": xv, "label": xv}),
                       device="cpu", **TRAIN)
    res = tt.train(Dataset({"features": x, "label": x}), shuffle=True)
    assert set(kernels.launch_counts().values()) == {0}  # plain on CPU
    jh, th = jt.get_history(), tt.get_history()
    assert len(th) == len(jh) == 4
    for a, b in zip(jh, th):
        assert set(b) == {"loss", "next_token_accuracy"}
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
        assert abs(b["next_token_accuracy"] - a["next_token_accuracy"]) <= 1 / (8 * 31)
    flat = _flat_jax(jres.params)
    for name, p in res.named_parameters():
        np.testing.assert_allclose(_np(p), flat[name], atol=1e-4, rtol=0)
    (jv,), (tv,) = jt.get_validation_history(), tt.get_validation_history()
    assert tv["epoch"] == jv["epoch"] == 1
    np.testing.assert_allclose(tv["val_loss"], jv["val_loss"], rtol=1e-4)
    # a new model: the caller's keeps its weights, hooks and eval mode
    assert res is not lm and not lm.training and not res.training
    assert all(torch.equal(before[k], v) for k, v in lm.state_dict().items())
    assert res.layers[1].mhsa.attention_fn is tfa.flash_attention
    assert tt.history.total_samples() == 32
    assert tt.get_averaged_metrics()["loss"] == pytest.approx(
        np.mean([r["loss"] for r in th]))


def _train(lm, **kw):
    cfg = {**TRAIN, **kw}
    t = SingleTrainer(lm, cfg.pop("opt", "adam"), "next_token_crossentropy",
                      device="cpu", **cfg)
    res = t.train(Dataset({"features": _tokens(), "label": _tokens()}),
                  shuffle=True)
    return t.get_history(), res


def test_streamed_and_resident_paths_are_bit_identical(jlm):
    """Same shuffle seed: the device-resident gather and the streamed
    (prefetched) windows give the same batches, so the same trajectory to
    the bit."""
    h1, r1 = _train(_port_lm(jlm), opt="pallas_adam", prefetch=2)
    h2, r2 = _train(_port_lm(jlm), opt="pallas_adam", device_resident=True)
    assert h1 == h2
    for a, b in zip(r1.parameters(), r2.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [{"accum_steps": 2}, {"remat": True}],
                         ids=["accum_steps", "remat"])
def test_accum_and_remat_match_the_plain_step(jlm, kw):
    """accum_steps=2 averages two half-batch gradients (equal up to
    summation order); remat recomputes the forward in the backward
    (equal)."""
    h0, r0 = _train(_port_lm(jlm, hooks=False))
    h1, r1 = _train(_port_lm(jlm, hooks=False), **kw)
    for a, b in zip(h0, h1):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    for a, b in zip(r0.parameters(), r1.parameters()):
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-5, rtol=0)


def test_block_remat_and_dropout():
    """TransformerBlock(remat=True) recomputes its forward under
    torch.utils.checkpoint with the same dropout masks, so its gradients
    equal the block without remat; masks come from the seed alone."""
    def block(remat):
        m = Sequential([TransformerBlock(2, causal=True, remat=remat,
                                         dropout=0.3)])
        return m.build((12, 16), seed=3, device="cpu").train()

    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 12, 16))
                         .astype(np.float32))
    grads = []
    for remat in (False, True):
        m = block(remat)
        m(x, rng=11).square().sum().backward()
        grads.append([p.grad for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    m = block(False)
    with pytest.raises(ValueError, match="rng"):
        m(x)
    assert torch.equal(m(x, rng=5), m(x, rng=5))
    assert not torch.equal(m(x, rng=5), m(x, rng=6))
    assert torch.equal(m.eval()(x), m(x, rng=5))  # eval: identity dropout


def test_dropout_layer_keeps_the_expected_fraction():
    """Inverted dropout: the kept share ~ 1 - rate, kept values scaled by
    1/(1 - rate) (the bits differ from jax.random's; the law does not)."""
    d = Dropout(0.25).train()
    x = torch.ones(200, 200)
    y = d(x, rng=1)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.75))
    assert torch.equal(d.eval()(x), x)
    assert d.get_config() == {"layer": "Dropout", "rate": 0.25}


def test_weights_follow_the_jax_leaf_order(jlm):
    lm = _port_lm(jlm, hooks=False)
    jw = jlm.get_weights()
    tw = lm.get_weights()
    assert len(tw) == len(jw)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a, b)
    other = zoo.transformer_lm(**LM, seed=5, device="cpu")
    other.set_weights(jw)
    for a, b in zip(other.parameters(), lm.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="weight arrays"):
        other.set_weights(jw[:-1])
    twin = lm.copy()
    assert twin.layers[0].tokens.data_ptr() != lm.layers[0].tokens.data_ptr()
    assert torch.equal(twin.layers[0].tokens, lm.layers[0].tokens)


def test_trainer_refusals(jlm):
    lm = _port_lm(jlm, hooks=False)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        SingleTrainer(lm, "adam", "mse", checkpoint_dir="/nonexistent", device="cpu")
    with pytest.raises(NotImplementedError, match="profil"):
        SingleTrainer(lm, "adam", "mse", profile_dir="/nonexistent", device="cpu")
    with pytest.raises(NotImplementedError, match="MetricsLogger"):
        SingleTrainer(lm, "adam", "mse", metrics_path="/nonexistent", device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        SingleTrainer(lm, "adam", "mse", batch_size=6, accum_steps=4, device="cpu")
    with pytest.raises(ValueError, match="built"):
        SingleTrainer(Sequential([Dropout(0.1)]), "adam", "mse", device="cpu")
    q = _port_lm(jlm, hooks=False)
    dense = q.layers[-1]
    w = dense.kernel.detach()
    del dense.kernel
    dense.kernel = quantize_int8(w)
    with pytest.raises(ValueError, match="quantized"):
        SingleTrainer(q, "adam", "mse", device="cpu")


def test_trainer_device_contract(jlm):
    """device=None means CUDA: without a GPU the worker raises rather than
    train on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    t = SingleTrainer(_port_lm(jlm, hooks=False), "adam",
                      "next_token_crossentropy", **TRAIN)
    with pytest.raises(RuntimeError, match="CUDA"):
        t.train(Dataset({"features": _tokens(), "label": _tokens()}))


# ---------------------------------------------------- data and utilities


def test_loaders_and_prefetch_match_jax():
    a = loaders.text_corpus(seq_len=512, vocab_size=8192)
    b = jloaders.text_corpus(seq_len=512, vocab_size=8192)
    assert len(a) == 136
    np.testing.assert_array_equal(a["features"], b["features"])
    assert loaders.default_corpus_path() != jloaders.default_corpus_path()
    for fn in ("digits", "breast_cancer", "diabetes"):
        x, y = getattr(loaders, fn)(), getattr(jloaders, fn)()
        np.testing.assert_array_equal(x["features"], y["features"])
        np.testing.assert_array_equal(x["label"], y["label"])
    with Prefetcher(iter(range(20)), lambda i: i * i, depth=3) as p:
        assert list(p) == [i * i for i in range(20)]


def test_rng_and_tree_helpers():
    a, b = RngSeq(3), RngSeq(3)
    assert [a.next() for _ in range(3)] == b.next_n(3)
    assert a.fork(1).next() == b.fork(1).next() != a.fork(2).next()
    assert split_seed(7, 2) == split_seed(7, 2) != split_seed(8, 2)
    x = {"a": torch.ones(2), "b": torch.zeros(3)}
    y = tree.host_copy(x)
    y["a"] += 1
    assert torch.equal(x["a"], torch.ones(2))
    assert tree.tree_allclose(tree.tree_mean([x, tree.tree_scale(x, 3.0)]),
                              tree.tree_scale(x, 2.0))
    assert tree.tree_allclose(tree.tree_sub(tree.tree_add(x, x), x), x)
