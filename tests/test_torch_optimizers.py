"""The port's optimizer table and learning-rate schedules vs optax on the
CPU.

Each update rule runs 5 steps on seeded leaves beside the optax transform
the JAX package resolves the same name to (``distkeras_tpu.ops.
optimizers.get_optimizer``), with a float learning rate and with a
schedule. Both sides compute in f32 with the same operations in the same
order; ATen and XLA may round ``rsqrt`` and a reduction's sum differently
(1 ulp), so parameters are held to 1e-6 absolute (values of order 1) and
schedules to 1e-6 relative. The schedule repair is pinned end to end:
``SingleTrainer`` with a schedule against the JAX ``SingleTrainer``, at
the bars of ``test_torch_train.py`` (losses 1e-4 relative, params 1e-4
absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.data import loaders as jloaders
from distkeras_tpu.data import transformers as jtf
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.ops import optimizers as jopt
from distkeras_tpu.trainers import SingleTrainer as JSingleTrainer
from distkeras_tpu_torch import loaders, zoo
from distkeras_tpu_torch.data import transformers as ttf
from distkeras_tpu_torch.ops import optimizers as topt
from distkeras_tpu_torch.ops.pallas_kernels import FusedAdam, FusedSGD
from distkeras_tpu_torch.trainers import SingleTrainer
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

PARAM_TOL = 1e-6
SCHEDULE_RTOL = 1e-6
SCHEDULE = dict(init_value=0.0, peak_value=0.05, warmup_steps=2,
                decay_steps=6)


@pytest.fixture(autouse=True)
def _uncached_jax_cores(monkeypatch):
    """Uncached JAX ``WorkerCore``s (``DKT_DISABLE_CORE_CACHE``): a later
    JAX test of the same model and optimizer must not be handed these
    runs' cores."""
    monkeypatch.setenv("DKT_DISABLE_CORE_CACHE", "1")


def _warmup(step):
    """A plain schedule both packages evaluate alike (int32 steps, f32
    values): no named schedule involved."""
    return 0.05 * (step + 1) / (step + 4)


def _run_both(name, kw, scheduled, steps=5):
    """Max |p_port - p_optax| over ``steps`` updates from the same leaves
    and gradients. ``scheduled``: False (lr 0.05), "named" (each
    package's ``warmup_cosine``) or "plain" (``_warmup``)."""
    rng = np.random.default_rng(7)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (4,))]
    gs = [[rng.standard_normal(a.shape).astype(np.float32) for a in p0]
          for _ in range(steps)]
    jlr = tlr = 0.05
    if scheduled == "named":
        jlr = jopt.get_schedule("warmup_cosine", **SCHEDULE)
        tlr = topt.get_schedule("warmup_cosine", **SCHEDULE)
    elif scheduled == "plain":
        jlr = tlr = _warmup
    ref = jopt.get_optimizer(name, jlr, **kw)
    jp = [jnp.asarray(a) for a in p0]
    jstate = ref.init(jp)
    opt = topt.get_optimizer(name, tlr, **kw)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    state = opt.init(tp)
    err = 0.0
    for g in gs:
        upd, jstate = ref.update([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        upd_t, state = opt.update([torch.from_numpy(a) for a in g], state, tp)
        topt.apply_updates(tp, upd_t)
        err = max(err, max(float(np.abs(a.numpy() - np.asarray(b)).max())
                           for a, b in zip(tp, jp)))
    return err


A2 = [
    ("adamw", {}), ("adamw", {"weight_decay": 0.1}),
    ("adagrad", {}), ("adagrad", {"initial_accumulator_value": 0.0}),
    ("adadelta", {}), ("adadelta", {"weight_decay": 0.1}),
    ("rmsprop", {}), ("rmsprop", {"eps_in_sqrt": False}),
    ("rmsprop", {"momentum": 0.9, "nesterov": True}),
    ("nadam", {}),
    ("lamb", {}), ("lamb", {"weight_decay": 0.01}),
]


@pytest.mark.parametrize("scheduled", [False, "named"],
                         ids=["float", "schedule"])
@pytest.mark.parametrize("name,kw", A2,
                         ids=[f"{n}-{'-'.join(k) or 'default'}" for n, k in A2])
def test_a2_optimizer_matches_optax(name, kw, scheduled):
    assert _run_both(name, kw, scheduled) <= PARAM_TOL


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True}), ("adam", {}),
], ids=["sgd", "momentum", "nesterov", "adam"])
def test_sgd_and_adam_take_a_schedule(name, kw):
    """The repair: optax's "sgd"/"adam" take a schedule (evaluated at the
    count before it is incremented); the port's did ``float(schedule)``
    and raised ``TypeError``."""
    assert _run_both(name, kw, scheduled="plain") <= PARAM_TOL
    assert _run_both(name, kw, scheduled="named") <= PARAM_TOL
    opt = topt.get_optimizer(name, lambda step: 1e-3, **kw)
    state = opt.init([torch.zeros(3)])
    count = state[-1]
    assert count.dtype == torch.int32 and int(count) == 0
    # the float path keeps its layout: no count where none was
    assert topt.get_optimizer("sgd", 0.1).init([torch.zeros(3)]) == ()


SCHEDULES = [
    ("constant", dict(value=0.1)),
    ("exponential_decay", dict(init_value=0.1, transition_steps=7,
                               decay_rate=0.5)),
    ("exponential_decay", dict(init_value=0.1, transition_steps=7,
                               decay_rate=0.5, transition_begin=3,
                               staircase=True, end_value=0.02)),
    ("cosine_decay", dict(init_value=0.1, decay_steps=30, alpha=0.1)),
    ("linear", dict(init_value=0.1, end_value=0.0, transition_steps=20,
                    transition_begin=5)),
    ("warmup_cosine", dict(init_value=0.0, peak_value=0.1, warmup_steps=10,
                           decay_steps=40, end_value=0.01)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_schedule_matches_optax(name, kw):
    """Steps 0-50 as an int32 tensor (what the optimizers pass) and as a
    Python int (``effective_learning_rate``'s step 0) against optax."""
    ref, port = jopt.get_schedule(name, **kw), topt.get_schedule(name, **kw)
    want = np.array([np.asarray(ref(jnp.int32(s))) for s in range(51)],
                    np.float32)
    got = np.array([float(port(torch.tensor(s, dtype=torch.int32)))
                    for s in range(51)], np.float32)
    np.testing.assert_allclose(got, want, rtol=SCHEDULE_RTOL, atol=0)
    np.testing.assert_array_equal(
        np.array([float(port(s)) for s in range(51)], np.float32), got)


#: bars of the plain B1/B2 against JAX's Pallas kernels in interpret mode:
#: XLA may contract the kernel's ``mu * m + g`` (and ``p - lr * g``) into
#: an FMA, one f32 rounding fewer, so f32 results are held to 2 ulp of the
#: leaf's largest magnitude (absolute: p - lr * g cancels) and 16-bit
#: parameters, rounded from those, to one ulp of their type
F32_ULPS = 2.0 ** -22
SGD_RTOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _near(got, want, rtol=0.0):
    atol = 0.0 if rtol else F32_ULPS * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("mu,nesterov", [(0.0, False), (0.9, False),
                                         (0.9, True)])
def test_sgd_plain_versions_match_the_pallas_kernels(dtype, mu, nesterov):
    """``sgd_step_plain`` / ``sgd_momentum_step_plain`` (what B1/B2 are
    held bit-equal to on the card) against JAX's ``_leaf_sgd`` /
    ``_leaf_sgd_momentum`` run through ``pl.pallas_call`` in interpret
    mode, over leaves above the JAX package's small-leaf cutoff, 3 steps."""
    from distkeras_tpu.ops import pallas_kernels as jpk
    from distkeras_tpu_torch.ops import pallas_kernels as tpk

    rng = np.random.default_rng(3)
    shapes = [(513, 7), (4096, 3)]
    assert all(np.prod(s) >= jpk._MIN_KERNEL_SIZE for s in shapes)
    p0 = [(0.05 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    gs = [(1e-2 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tp = [torch.from_numpy(p.copy()).to(tdt) for p in p0]
    tg = [torch.from_numpy(g).to(tdt) for g in gs]
    tm = [torch.zeros(s) for s in shapes]
    jp = [jnp.asarray(p).astype(jdt) for p in p0]
    jg = [jnp.asarray(g).astype(jdt) for g in gs]
    jm = [jnp.zeros(s, jnp.float32) for s in shapes]
    for _ in range(3):
        if mu:
            tpk.sgd_momentum_step_plain(tp, tg, tm, 0.05, mu, nesterov)
            out = [jpk._leaf_sgd_momentum(p, g, m, 0.05, mu, nesterov, True)
                   for p, g, m in zip(jp, jg, jm)]
            jp, jm = [o[0] for o in out], [o[1] for o in out]
        else:
            tpk.sgd_step_plain(tp, tg, 0.05)
            jp = [jpk._leaf_sgd(p, g, 0.05, True) for p, g in zip(jp, jg)]
    for t, j in zip(tp, jp):
        assert t.dtype == tdt and j.dtype == jdt
        _near(t.float().numpy(), np.asarray(j.astype(jnp.float32)),
              SGD_RTOL.get(dtype, 0.0))
    for t, j in zip(tm, jm):
        _near(t.numpy(), np.asarray(j))


def test_optimizer_and_schedule_tables():
    assert set(topt._OPTIMIZERS) == set(jopt._OPTIMIZERS)
    assert set(topt._SCHEDULES) == set(jopt._SCHEDULES)
    assert topt._DEFAULT_LR == jopt._DEFAULT_LR
    for name in topt._OPTIMIZERS:
        opt = topt.get_optimizer(name)
        assert opt.learning_rate == topt._DEFAULT_LR[name]
    assert isinstance(topt.get_optimizer("pallas_adam"), FusedAdam)
    assert isinstance(topt.get_optimizer("pallas_sgd"), FusedSGD)
    with pytest.raises(ValueError, match="unknown schedule"):
        topt.get_schedule("nope")
    with pytest.raises(ValueError, match="decay_steps"):
        topt.get_schedule("cosine_decay", init_value=0.1, decay_steps=0)
    fn = lambda step: 0.5  # noqa: E731
    assert topt.get_schedule(fn) is fn


def _mnist(mod, n=256):
    ds = mod.synthetic_mnist(n=n, seed=0)
    tf = jtf if mod is jloaders else ttf
    ds = tf.MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    return tf.OneHotTransformer(10, output_col="label_onehot").transform(ds)


@pytest.mark.parametrize("name,peak", [("sgd", 0.1), ("adam", 3e-3)])
def test_single_trainer_with_schedule_matches_jax(name, peak):
    """``SingleTrainer(m, "sgd"|"adam", learning_rate=schedule)`` trains
    (it raised ``TypeError`` before the repair) and follows the JAX
    ``SingleTrainer`` with optax's schedule from the same weights."""
    kw = dict(loss="categorical_crossentropy", batch_size=32, num_epoch=2,
              label_col="label_onehot", seed=3)

    def schedule(step):  # a warmup to ``peak``
        return peak * (step + 1) / (step + 4)

    jm = jzoo.mnist_mlp(hidden=16, seed=7)
    jt = JSingleTrainer(jm, name, learning_rate=schedule, **kw)
    jres = jt.train(_mnist(jloaders), shuffle=True)
    tm = zoo.mnist_mlp(hidden=16, device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, jm.params))
    tt = SingleTrainer(tm, name, learning_rate=schedule, device="cpu", **kw)
    res = tt.train(_mnist(loaders), shuffle=True)
    jh, th = jt.get_history(), tt.get_history()
    assert len(th) == len(jh) == 16
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
    for a, b in zip(jres.get_weights(), res.get_weights()):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)
