"""The port's import surface vs the JAX package's, on the CPU.

Every name a JAX package ``__init__`` exports (its ``__all__``, or the
names it imports where it has none) is importable from the port's module
of the same path, unless it is in ``NO_COUNTERPART`` with the reason.
The functions the surface brought in agree with JAX's on seeded inputs:
``tree_dot``/``tree_norm`` within 1e-6 (absolute plus relative: a dot
near zero cancels), ``Sequential.summary``
text equal for a model bridged from JAX, ``Sequential.predict`` within
1e-5 absolute (f32, another summation order), ``Trainer.serialize``
bytes that JAX's ``deserialize_model`` reads back to the same weights.
``parallel.backend.setup_backend`` takes JAX's keywords and raises
without a card instead of falling back.
"""

import ast
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.parallel.backend import setup_backend
from distkeras_tpu_torch.utils import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("", "data", "models", "obs", "ops", "parallel", "serving",
            "utils")

#: JAX names with no port counterpart, and why
NO_COUNTERPART = {
    "Model": "JAX's built (apply_fn, params, state) handle; the port's "
             "Sequential.build returns the nn.Module itself",
    "force_cpu_mesh": "a JAX virtual-device knob; the port's CPU ranks are "
                      "processes (Job.run_local)",
    "batch_sharding": "a JAX NamedSharding over the data axis; the port's "
                      "ranks are processes, each holding its rows",
    "replicated_sharding": "a JAX NamedSharding; the port replicates by "
                           "broadcast (parallel.mesh.replicate)",
    "enable_compile_cache": "XLA's persistent compile cache; the port's "
                            "counterpart is the kernel build cache "
                            "(kernels/_build)",
}


def _jax_exports(sub):
    """The names ``distkeras_tpu/<sub>/__init__.py`` exports, read from
    its source (no JAX import): ``__all__``, else every public name its
    ``from ... import`` lines bind."""
    path = os.path.join(REPO, "distkeras_tpu", sub, "__init__.py")
    tree = ast.parse(open(path).read())
    imported = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return [e.value for e in node.value.elts]
        if isinstance(node, ast.ImportFrom):
            imported += [a.asname or a.name for a in node.names]
    return [n for n in imported if not n.startswith("_")]


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_jax_exports_have_port_counterparts(sub):
    mod = importlib.import_module(
        "distkeras_tpu_torch" + (f".{sub}" if sub else ""))
    names = _jax_exports(sub)
    assert names
    missing = [n for n in names
               if n not in NO_COUNTERPART and not hasattr(mod, n)]
    assert not missing, missing
    listed = getattr(mod, "__all__", None)
    if listed is not None:
        unlisted = [n for n in names
                    if n not in NO_COUNTERPART and n not in listed]
        assert not unlisted, unlisted
    # the exceptions stay honest: none of them exists in the port
    for n in names:
        if n in NO_COUNTERPART:
            assert not hasattr(mod, n), n


def test_import_builds_and_loads_nothing():
    """Importing every package of the port builds no kernel, loads no
    library and imports neither JAX nor the JAX package."""
    code = (
        "import sys\n"
        "import distkeras_tpu_torch\n"
        + "".join(f"import distkeras_tpu_torch.{s}\n" for s in PACKAGES if s)
        + "from distkeras_tpu_torch.kernels import build\n"
        "assert not build._fns, build._fns\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'distkeras_tpu')]\n"
        "assert not bad, bad\n"
        "print('IMPORT_OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "IMPORT_OK" in out.stdout


def _trees(kind):
    rng = np.random.default_rng(5)
    shapes = {"0.kernel": (7, 3), "0.bias": (3,), "2.gamma": (4, 2, 2)}
    a = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    b = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    if kind == "tensor":
        return ({k: torch.from_numpy(v) for k, v in a.items()},
                {k: torch.from_numpy(v) for k, v in b.items()}, a, b)
    return a, b, a, b


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_tree_dot_norm_zeros_match_jax(kind):
    from distkeras_tpu.utils import tree as jtree
    from distkeras_tpu_torch.utils import tree_dot, tree_norm, tree_zeros_like

    a, b, ja, jb = _trees(kind)
    np.testing.assert_allclose(float(tree_dot(a, b)),
                               float(jtree.tree_dot(ja, jb)), rtol=1e-6,
                               atol=1e-6)
    # JAX's tree_norm maps a one-argument lambda over two trees and
    # raises TypeError; its intent, sqrt(tree_dot(a, a)), is the reference
    np.testing.assert_allclose(float(tree_norm(a)),
                               np.sqrt(float(jtree.tree_dot(ja, ja))),
                               rtol=1e-6, atol=1e-6)
    zeros = tree_zeros_like(a)
    want = jtree.tree_zeros_like(ja)
    assert zeros.keys() == a.keys()
    for k, z in zeros.items():
        assert type(z) is type(a[k]) and z.shape == a[k].shape
        np.testing.assert_array_equal(np.asarray(z), np.asarray(want[k]))


#: (zoo function, keyword arguments) of the models summary/predict bridge
MODELS = {
    "digits_mlp": ("digits_mlp", {}),
    "mnist_cnn": ("mnist_cnn", {"width": 0.25}),
    "cifar10_cnn": ("cifar10_cnn", {"width": 0.25}),
    "transformer_lm": ("transformer_lm", dict(
        vocab_size=29, seq_len=12, d_model=16, num_heads=2, depth=2)),
    "moe_transformer_lm": ("moe_transformer_lm", dict(
        vocab_size=29, seq_len=12, d_model=16, num_heads=2, depth=2,
        num_experts=4)),
}


def _bridged(name):
    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu_torch.models import zoo as tzoo

    fn, kw = MODELS[name]
    jm = getattr(jzoo, fn)(seed=0, **kw)
    tm = getattr(tzoo, fn)(seed=0, device="cpu", **kw)
    convert.params_from_jax(tm, jm.params)
    convert.state_from_jax(tm, jm.state)
    return jm, tm


def _inputs(jm, n=9):
    rng = np.random.default_rng(11)
    if len(jm.input_shape) == 1 and jm.input_shape[0] == 12:  # token LMs
        return rng.integers(0, 29, (n, 12)).astype(np.int32)
    return rng.standard_normal((n, *jm.input_shape)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_summary_text_equals_jax(name):
    jm, tm = _bridged(name)
    assert tm.summary() == jm.summary()


@pytest.mark.parametrize("name", ["digits_mlp", "cifar10_cnn",
                                  "transformer_lm"])
def test_predict_matches_jax(name):
    """Eval mode (BatchNorm's moving statistics, no dropout) whole and in
    ragged batches of 4; the model's mode comes back as it was."""
    jm, tm = _bridged(name)
    x = _inputs(jm)
    want = jm.predict(x)
    tm.train()
    for bs in (None, 4):
        got = tm.predict(x, batch_size=bs)
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert tm.training


def test_trainer_serialize_reads_back_in_both_packages():
    from distkeras_tpu.utils.serialization import deserialize_model as jload
    from distkeras_tpu_torch import SingleTrainer, zoo
    from distkeras_tpu_torch.utils import deserialize_model

    model = zoo.digits_mlp(seed=3, device="cpu")
    blob = SingleTrainer(model, "adam", "categorical_crossentropy",
                         device="cpu").serialize()
    assert isinstance(blob, bytes)
    want = model.get_weights()
    for got in (deserialize_model(blob, device="cpu").get_weights(),
                jload(blob).get_weights()):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), w)


def test_setup_backend_takes_jax_keywords_and_never_falls_back(monkeypatch):
    assert setup_backend(cpu=True, cpu_devices=8,
                         fallback_cpu_devices=8) == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        setup_backend(cpu=False, cpu_devices=8, fallback_cpu_devices=8)
