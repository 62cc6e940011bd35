"""The PyTorch port's CNN and tabular layers and zoo models vs the JAX
package on the CPU.

Inputs come from ``np.random.default_rng``; weights (and the BatchNorm
moving statistics) are bridged from the JAX model with
``params_from_jax``/``state_from_jax``. Tolerances: 1e-4 absolute on f32
forwards (the same arithmetic, only the summation order of the
convolutions and reductions differs); gradients and bf16 as stated at
their tests.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import layers as jl
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.models.sequential import Residual as JResidual
from distkeras_tpu.models.sequential import Sequential as JSequential
from distkeras_tpu.ops.losses import get_loss as jget_loss
from distkeras_tpu.trainers import SingleTrainer as JSingleTrainer
from distkeras_tpu_torch import SingleTrainer, loaders
from distkeras_tpu_torch.data import transformers as ttf
from distkeras_tpu_torch.models import layers as tl
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.models.sequential import Residual, Sequential
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.utils.convert import params_from_jax, state_from_jax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _random_state(state, seed):
    """A JAX state tree with non-trivial moving statistics: means around
    0, variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, _np_tree(state))


def _random_params(params, seed):
    """BatchNorm's gamma/beta and the biases start at 1/0; draw them so a
    wrong bridge of any of them shows."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if path[-1].key in ("gamma", "beta", "bias"):
            base = 1.0 if path[-1].key == "gamma" else 0.0
            return (base + rng.normal(0.0, 0.2, x.shape)).astype(np.float32)
        return np.asarray(x)

    return jax.tree_util.tree_map_with_path(leaf, _np_tree(params))


def _bridge(jm, tm, seed=0):
    """Random biases/BN affine and moving statistics, loaded into both."""
    jm.params = _random_params(jm.params, seed)
    jm.state = _random_state(jm.state, seed + 1)
    params_from_jax(tm, jm.params)
    state_from_jax(tm, jm.state)
    return jm, tm


def _pair(layers_fn, in_shape, seed=0):
    jm = JSequential(layers_fn(jl, JResidual)).build(in_shape)
    tm = Sequential(layers_fn(tl, Residual)).build(in_shape, device="cpu")
    assert tm.output_shape == tuple(jm.output_shape)
    return _bridge(jm, tm, seed)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _fwd(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(x)).numpy()


def _leaf_paths(tree):
    return [".".join(str(p.key) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


# -------------------------------------------------------------- the layers


def test_same_padding_is_xla_split():
    """XLA pads SAME windows with lo = total // 2: the 7x7/s2 stem on 64
    rows pads (2, 3), a 3x3/s2 on 32 rows (0, 1), a 3x3/s1 (1, 1)."""
    assert tl._same_pads(64, 7, 2) == (2, 3)
    assert tl._same_pads(32, 3, 2) == (0, 1)
    assert tl._same_pads(31, 3, 2) == (1, 1)
    assert tl._same_pads(28, 3, 1) == (1, 1)
    assert tl._same_pads(8, 1, 2) == (0, 0)


CONVS = [
    # (H, W, kernel, stride, padding)
    (8, 8, 3, 1, "SAME"), (7, 7, 3, 1, "SAME"), (8, 8, 3, 2, "SAME"),
    (7, 9, 3, 2, "SAME"), (8, 8, 3, 2, "VALID"), (9, 9, 3, 1, "VALID"),
    (32, 32, 7, 2, "SAME"), (13, 13, 7, 2, "SAME"), (8, 8, 1, 2, "SAME"),
    (9, 9, 1, 2, "SAME"),
]


@pytest.mark.parametrize(
    "h,w,k,s,padding", CONVS,
    ids=[f"{h}x{w}-k{k}s{s}-{p}" for h, w, k, s, p in CONVS])
def test_conv2d_matches_jax(h, w, k, s, padding):
    jm, tm = _pair(lambda L, R: [L.Conv2D(5, k, strides=s, padding=padding,
                                          activation="relu")], (h, w, 3))
    x = _x((2, h, w, 3))
    np.testing.assert_allclose(_fwd(tm, x), np.asarray(jm(x)), atol=TOL,
                               rtol=0)


POOLS = [
    ("MaxPool2D", 3, 2, "SAME", 8), ("MaxPool2D", 3, 2, "SAME", 7),
    ("MaxPool2D", 2, None, "VALID", 9), ("AvgPool2D", 3, 2, "SAME", 8),
    ("AvgPool2D", 3, 2, "SAME", 7), ("AvgPool2D", 3, 1, "SAME", 6),
    ("AvgPool2D", 2, None, "VALID", 8),
]


@pytest.mark.parametrize(
    "cls,k,s,padding,size", POOLS,
    ids=[f"{c}-{k}-{s}-{p}-{n}" for c, k, s, p, n in POOLS])
def test_pool2d_matches_jax(cls, k, s, padding, size):
    """MaxPool2D pads SAME with -inf on XLA's split; AvgPool2D sums over
    the zero padding and divides by the full window."""
    jm, tm = _pair(lambda L, R: [getattr(L, cls)(k, strides=s,
                                                 padding=padding)],
                   (size, size, 4))
    x = _x((2, size, size, 4), seed=1)
    np.testing.assert_allclose(_fwd(tm, x), np.asarray(jm(x)), atol=TOL,
                               rtol=0)


def test_flatten_activation_and_global_pools_match_jax():
    """Flatten is (H, W, C)-ordered: a Dense after it reads the JAX
    kernel's rows in that order."""
    jm, tm = _pair(lambda L, R: [L.Activation("tanh"), L.Flatten(),
                                 L.Dense(7)], (3, 4, 5))
    x = _x((2, 3, 4, 5))
    np.testing.assert_allclose(_fwd(tm, x), np.asarray(jm(x)), atol=TOL,
                               rtol=0)
    jg, tg = _pair(lambda L, R: [L.GlobalAvgPool2D()], (3, 4, 5))
    np.testing.assert_allclose(_fwd(tg, x), np.asarray(jg(x)), atol=TOL,
                               rtol=0)
    j1, t1 = _pair(lambda L, R: [L.GlobalAvgPool1D()], (6, 5))
    x1 = _x((2, 6, 5))
    np.testing.assert_allclose(_fwd(t1, x1), np.asarray(j1(x1)), atol=TOL,
                               rtol=0)
    assert tg.output_shape == (5,) and t1.output_shape == (5,)


@pytest.mark.parametrize("momentum", [0.99, 0.9])
def test_batchnorm_train_step_and_eval_match_jax(momentum):
    """One train-mode step: the output (batch statistics, biased variance)
    and the new moving mean/var; then eval mode on the buffers."""
    jm, tm = _pair(lambda L, R: [L.BatchNorm(momentum=momentum)], (4, 4, 6))
    x = _x((3, 4, 4, 6), seed=2) * 2.0 + 0.5
    jy, jstate = jm.apply(jm.params, jm.state, x, train=True)
    tm.train()
    ty = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(ty, np.asarray(jy), atol=TOL, rtol=0)
    for name in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(tm.layers[0], name).numpy(),
            np.asarray(jstate["0"][name]), atol=1e-6, rtol=0)
    tm.eval()
    jm.state = _np_tree(jstate)
    np.testing.assert_allclose(_fwd(tm, x), np.asarray(jm(x)), atol=TOL,
                               rtol=0)


def _block(L, R, shortcut):
    main = [L.Conv2D(8, 3, strides=2 if shortcut else 1, padding="SAME",
                     use_bias=False),
            L.BatchNorm(momentum=0.9), L.Activation("relu"),
            L.Conv2D(8, 3, padding="SAME", use_bias=False),
            L.BatchNorm(momentum=0.9)]
    short = ([L.Conv2D(8, 1, strides=2, padding="SAME", use_bias=False),
              L.BatchNorm(momentum=0.9)] if shortcut else None)
    return [R(main, shortcut=short, activation="relu")]


@pytest.mark.parametrize("shortcut", [False, True],
                         ids=["identity", "projection"])
def test_residual_matches_jax(shortcut):
    """act(main(x) + shortcut(x)) in eval and train mode (the BatchNorm
    state of both branches threads through), with the branches' names
    ``main_{i}``/``short_{i}``."""
    cin = 4 if shortcut else 8
    jm, tm = _pair(lambda L, R: _block(L, R, shortcut), (8, 8, cin))
    x = _x((2, 8, 8, cin), seed=3)
    np.testing.assert_allclose(_fwd(tm, x), np.asarray(jm(x)), atol=TOL,
                               rtol=0)
    jy, jstate = jm.apply(jm.params, jm.state, x, train=True)
    tm.train()
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jy), atol=TOL, rtol=0)
    flat = dict(zip(_leaf_paths(jstate), jax.tree.leaves(jstate)))
    own = dict(tm.named_buffers())
    assert sorted(own) == sorted(flat)
    assert ("0.short_0.kernel" in dict(tm.named_parameters())) == shortcut
    for name, v in flat.items():
        np.testing.assert_allclose(own[name].numpy(), np.asarray(v),
                                   atol=1e-6, rtol=0)
    assert len(tm.layers[0].sublayers()) == (7 if shortcut else 5)


def test_residual_shape_mismatch_raises_like_jax():
    for pkg, R, kw in ((jl, JResidual, {}), (tl, Residual, {"device": "cpu"})):
        seq = (JSequential if pkg is jl else Sequential)(
            [R([pkg.Conv2D(8, 3)])])
        with pytest.raises(ValueError, match="Residual branch shapes differ"):
            seq.build((6, 6, 4), **kw)


# ---------------------------------------------------------- the zoo models

ZOO_CASES = {
    "mnist_cnn": (dict(width=0.125), (28, 28, 1)),
    "cifar10_cnn": (dict(width=0.125, bn_momentum=0.9), (32, 32, 3)),
    "resnet18": (dict(width=0.125, num_classes=10, input_shape=(32, 32, 3)),
                 (32, 32, 3)),
    "resnet18_small_stem": (dict(width=0.125, num_classes=10,
                                 input_shape=(16, 16, 3), small_stem=True),
                            (16, 16, 3)),
    "higgs_mlp": (dict(hidden=32), (30,)),
    "digits_mlp": (dict(hidden=16), (64,)),
    "tabular_regressor": (dict(hidden=16), (10,)),
    "mnist_mlp": (dict(hidden=16), (784,)),
    "transformer_classifier": (dict(vocab_size=31, seq_len=16, d_model=32,
                                    num_heads=2, depth=1), (16,)),
}


@pytest.fixture(scope="module")
def built():
    """Each zoo function's JAX and port models, bridged (built once: the JAX
    ResNet build alone takes ~20 s on a CPU)."""
    out = {}
    for name, (kw, in_shape) in ZOO_CASES.items():
        fn = name.replace("_small_stem", "")
        jm = getattr(jzoo, fn)(**kw)
        tm = getattr(zoo, fn)(**kw, device="cpu")
        out[name] = (*_bridge(jm, tm), in_shape)
    return out


def _input(name, in_shape, seed=4, b=3):
    if name == "transformer_classifier":
        return np.random.default_rng(seed).integers(0, 31, (b, *in_shape)) \
            .astype(np.int32)
    return np.random.default_rng(seed).uniform(0, 1, (b, *in_shape)) \
        .astype(np.float32)


@pytest.mark.parametrize("name", list(ZOO_CASES))
def test_zoo_eval_forward_matches_jax(built, name):
    jm, tm, in_shape = built[name]
    x = _input(name, in_shape)
    np.testing.assert_allclose(_fwd(tm, x), np.asarray(jm(x)), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("name", list(ZOO_CASES))
def test_zoo_config_leaf_order_and_state_round_trip(built, name):
    """``get_config`` JSON-identical, ``from_config`` rebuilds the same
    parameter and buffer names and shapes, ``_leaf_order`` is
    ``jax.tree.leaves``'s order, ``get_weights`` the JAX leaves, and the
    state tree's names are the buffers'."""
    jm, tm, in_shape = built[name]
    cfg = json.dumps(tm.get_config(), sort_keys=True)
    assert cfg == json.dumps(jm.get_config(), sort_keys=True)
    again = Sequential.from_config(json.loads(cfg)).build(in_shape,
                                                          device="cpu")
    assert json.dumps(again.get_config(), sort_keys=True) == cfg
    for a, b in ((again.named_parameters(), tm.named_parameters()),
                 (again.named_buffers(), tm.named_buffers())):
        assert [(n, t.shape) for n, t in a] == [(n, t.shape) for n, t in b]
    assert tm._leaf_order() == _leaf_paths(jm.params)
    for a, b in zip(tm.get_weights(), jm.get_weights(), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert sorted(n for n, _ in tm.named_buffers()) == sorted(
        _leaf_paths(jm.state))


def test_state_bridge_refuses_mismatches(built):
    jm, tm, _ = built["cifar10_cnn"]
    state = _np_tree(jm.state)
    with pytest.raises(ValueError, match="state do not match the model"):
        state_from_jax(tm, {**state, "99": {"mean": np.zeros(3)}})
    short = dict(state)
    short.pop("1")
    with pytest.raises(ValueError, match=r"missing \['1.mean', '1.var'\]"):
        state_from_jax(tm, short)
    bad = jax.tree.map(lambda a: a, state)
    bad["1"]["mean"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="1.mean: shape"):
        state_from_jax(tm, bad)


@pytest.mark.parametrize("name", ["cifar10_cnn_nodrop", "resnet18"])
def test_train_step_gradients_match_jax_grad(built, name):
    """One train-mode step of a dropout-free model: the loss, every gradient
    and the new BatchNorm state against ``jax.grad``. Gradients agree
    within 1e-4 times max(1, the leaf's largest magnitude): the ResNet
    stem's entries reach ~13, where each package's f32 gradient lies
    ~5e-4 from the f64 one (the backward of batch statistics over few
    samples). The gradients arrive contiguous — the conv kernels'
    included, which the convolution reads through a permuted view — as
    the fused optimizers require."""
    if name == "resnet18":
        jm, tm, in_shape = built["resnet18"]
    else:
        def stack(L, R):
            return [L.Conv2D(8, 3, padding="SAME", use_bias=False),
                    L.BatchNorm(momentum=0.9), L.Activation("relu"),
                    L.MaxPool2D(2), L.Conv2D(8, 3, strides=2, padding="SAME"),
                    L.BatchNorm(momentum=0.9), L.Activation("relu"),
                    L.Flatten(), L.Dense(10, activation="softmax")]
        in_shape = (16, 16, 3)
        jm, tm = _pair(stack, in_shape)
    x = _input(name, in_shape, seed=5, b=4)
    y = np.eye(10, dtype=np.float32)[np.arange(4) % 10]
    jloss = jget_loss("categorical_crossentropy")

    def f(p):
        out, st = jm.apply(p, jm.state, jnp.asarray(x), train=True)
        return jloss(out, y), st

    (jl_val, jstate), jg = jax.value_and_grad(f, has_aux=True)(jm.params)
    model = tm.copy().train()
    params = list(model.parameters())
    loss = get_loss("categorical_crossentropy")(
        model(torch.from_numpy(x)), torch.from_numpy(y))
    grads = dict(zip([n for n, _ in model.named_parameters()],
                     torch.autograd.grad(loss, params)))
    assert float(loss.detach()) == pytest.approx(float(jl_val), abs=TOL)
    jflat = dict(zip(_leaf_paths(jg), jax.tree.leaves(jg)))
    assert sorted(jflat) == sorted(grads)
    for n, g in grads.items():
        assert g.is_contiguous(), n
        ref = np.asarray(jflat[n])
        np.testing.assert_allclose(
            g.numpy(), ref, atol=TOL * max(1.0, np.abs(ref).max()), rtol=0,
            err_msg=n)
    own = dict(model.named_buffers())
    for n, v in zip(_leaf_paths(jstate), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(own[n].numpy(), np.asarray(v), atol=1e-6,
                                   rtol=0, err_msg=n)


def test_cifar10_cnn_bf16_forward_matches_jax(built):
    """``compute_dtype="bfloat16"``: the input is cast and every layer
    casts its weights to it, so the whole forward runs in bf16 in both
    packages. The two round differently (summation order inside the
    convolutions, then bf16's 8-bit significand at every layer), so the
    tolerance is bf16 rounding carried through the net: the softmax
    outputs agree within 2e-2 absolute, and each within 2e-2 of the f32
    forward."""
    jm, tm, in_shape = built["cifar10_cnn"]
    x = _input("cifar10_cnn", in_shape, seed=6, b=4)
    ref = np.asarray(jm(x))
    jy = np.asarray(jm(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        ty = tm(torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    ty = ty.float().numpy()
    np.testing.assert_allclose(ty, jy, atol=2e-2, rtol=0)
    np.testing.assert_allclose(ty, ref, atol=2e-2, rtol=0)
    assert np.abs(ty - ref).max() > 0  # it really ran in bf16


# ------------------------------------------------- the training glue


def _cifar(port, n=32):
    from distkeras_tpu.data import loaders as jloaders
    from distkeras_tpu.data import transformers as jtf

    L, T = (loaders, ttf) if port else (jloaders, jtf)
    ds = L.synthetic_cifar10(n=n, seed=2)
    ds = T.MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    return T.OneHotTransformer(10, output_col="label_onehot").transform(ds)


@pytest.mark.parametrize("remat,accum", [(False, 1), (True, 1), (True, 2)],
                         ids=["plain", "remat", "remat-accum2"])
def test_single_trainer_batchnorm_state_matches_jax(remat, accum):
    """SingleTrainer on a conv/BN stack, 4 steps: the losses and the final
    moving statistics match JAX's, which threads the state once per
    microbatch — so under ``remat`` the replayed forward must not update
    the buffers a second time, and under ``accum_steps=2`` they update
    twice per step."""
    def stack(L, R):
        return [L.Conv2D(8, 3, strides=2, padding="SAME", use_bias=False),
                L.BatchNorm(momentum=0.9), L.Activation("relu"),
                L.GlobalAvgPool2D(), L.Dense(10, activation="softmax")]

    jm, tm = _pair(stack, (32, 32, 3))
    kw = dict(loss="categorical_crossentropy", learning_rate=0.05,
              batch_size=8, label_col="label_onehot", remat=remat,
              accum_steps=accum, seed=0)
    jt = JSingleTrainer(jm, "sgd", **kw)
    jres = jt.train(_cifar(False))
    tt = SingleTrainer(tm, "sgd", device="cpu", **kw)
    tres = tt.train(_cifar(True))
    jh, th = jt.get_history(), tt.get_history()
    assert len(th) == len(jh) == 4
    for a, b in zip(jh, th):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-5)
    own = dict(tres.named_buffers())
    for n, v in zip(_leaf_paths(jres.state), jax.tree.leaves(jres.state)):
        np.testing.assert_allclose(own[n].numpy(), np.asarray(v), atol=1e-6,
                                   rtol=0, err_msg=n)
    for a, b in zip(tres.get_weights(), jres.get_weights()):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


def test_worker_warmup_and_retry_restore_the_moving_statistics():
    """A worker's replica keeps moving statistics of its own (its buffers,
    as the JAX worker's ``_state``); the threads-mode warm-up window and
    a retry must leave them where the caller's model has them, as the
    JAX worker starts from ``model.state``."""
    from distkeras_tpu_torch.ops.optimizers import Sgd
    from distkeras_tpu_torch.parameter_servers import DeltaParameterServer
    from distkeras_tpu_torch.workers import DOWNPOURWorker, WorkerCore

    model = zoo.cifar10_cnn(width=0.125, bn_momentum=0.5, device="cpu")
    core = WorkerCore(model, Sgd(0.05), "categorical_crossentropy")
    ps = DeltaParameterServer(dict(zip(model._leaf_order(),
                                       model.get_weights())))
    worker = DOWNPOURWorker(core, ps, 0, "features", "label_onehot", 2,
                            device="cpu")
    data = _cifar(True, n=32)
    start = {n: b.clone() for n, b in model.named_buffers()}
    worker.warmup(data, 8)
    for n, b in worker._model.named_buffers():
        assert torch.equal(b, start[n]), n
    worker.begin_window(list(data.batches(
        8, columns=["features", "label_onehot"]))[:2])
    worker.finish_window()
    moved = dict(worker._model.named_buffers())
    assert any(not torch.equal(moved[n], start[n]) for n in start)
    worker.reset_for_retry()
    for n, b in worker._model.named_buffers():
        assert torch.equal(b, start[n]), n
    assert all(torch.equal(b, start[n]) for n, b in model.named_buffers())


def test_compute_dtype_by_name():
    from distkeras_tpu_torch.workers import _resolve_dtype

    assert _resolve_dtype("bfloat16") is torch.bfloat16
    assert _resolve_dtype(torch.float16) is torch.float16
    assert _resolve_dtype(None) is None
    with pytest.raises(ValueError, match="unknown compute dtype"):
        _resolve_dtype("Module")


def test_cnn_zoo_runs_with_jax_blocked():
    """The new layers and zoo models import, build, and train under DOWNPOUR
    in a process where importing ``jax`` or ``distkeras_tpu`` raises."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                  'distkeras_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import distkeras_tpu_torch as p\n"
        "from distkeras_tpu_torch.data import transformers as T\n"
        "for name, kw in [('cifar10_cnn', {'width': 0.125}),\n"
        "                 ('resnet18', {'width': 0.125, 'num_classes': 10,\n"
        "                               'input_shape': (32, 32, 3)}),\n"
        "                 ('higgs_mlp', {'hidden': 8}),\n"
        "                 ('digits_mlp', {}), ('tabular_regressor', {}),\n"
        "                 ('transformer_classifier', {'depth': 1})]:\n"
        "    getattr(p.zoo, name)(device='cpu', **kw)\n"
        "m = p.zoo.mnist_cnn(width=0.125, device='cpu')\n"
        "ds = T.OneHotTransformer(10, output_col='y').transform(\n"
        "    p.loaders.synthetic_mnist(n=64, flat=False))\n"
        "t = p.DOWNPOUR(m, 'pallas_adam', num_workers=2, batch_size=16,\n"
        "               communication_window=2, label_col='y',\n"
        "               mode='simulated', compute_dtype='bfloat16',\n"
        "               device='cpu')\n"
        "t.train(ds)\n"
        "assert t.parameter_server.num_updates == 2, t.failures\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'distkeras_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
