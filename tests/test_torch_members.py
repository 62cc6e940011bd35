"""The PyTorch port's member trainers (``EnsembleTrainer``,
``AveragingTrainer``; threaded and ``vmapped=True``) vs the JAX package's
on the CPU.

Each member's init is the JAX member's (built with ``seed + i``), carried
into the port through the port's member-build helper (the port's ``build``
draws from a torch generator, not a JAX key); data comes from the same
numpy seeds through each package's loaders and transformers. The JAX
vmapped path runs its Pallas kernels as its own tests run them here
(interpret mode); the port runs the kernels' plain versions. Each test
states its tolerance and why.
"""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu import AveragingTrainer as JAveraging
from distkeras_tpu import EnsembleTrainer as JEnsemble
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models import layers as jl
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.models.sequential import Sequential as JSequential
from distkeras_tpu.ops import flash_attention as jfa
from distkeras_tpu.ops import fused_layernorm as jln
from distkeras_tpu_torch import (
    AveragingTrainer,
    EnsembleTrainer,
    kernels,
    zoo,
)
from distkeras_tpu_torch import trainers as ttrainers
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models import layers as tl
from distkeras_tpu_torch.models.sequential import Sequential
from distkeras_tpu_torch.ops import flash_attention as tfa
from distkeras_tpu_torch.ops import fused_layernorm as tln
from distkeras_tpu_torch.utils.convert import params_from_jax, state_from_jax
from distkeras_tpu_torch.workers import WorkerCore

torch.set_num_threads(2)

KW = dict(loss="categorical_crossentropy", learning_rate=0.05,
          batch_size=32, num_epoch=2, window=4, label_col="label_onehot",
          seed=0)


@pytest.fixture(autouse=True)
def _uncached_jax_cores(monkeypatch):
    """Uncached JAX cores (``DKT_DISABLE_CORE_CACHE``), so no later JAX
    test in this process is handed one of these runs' cores."""
    monkeypatch.setenv("DKT_DISABLE_CORE_CACHE", "1")


def _data(n):
    """``synthetic_mnist`` scaled and one-hot, as (JAX, port) datasets; the
    two packages' loaders give the same arrays (``test_torch_async.py``)."""
    from distkeras_tpu.data import loaders as jloaders
    from distkeras_tpu.data import transformers as jtf

    ds = jloaders.synthetic_mnist(n=n, seed=0)
    ds = jtf.MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    ds = jtf.OneHotTransformer(10, output_col="label_onehot").transform(ds)
    cols = {k: ds[k] for k in ds.columns}
    return ds, Dataset(cols)


def _bridge(tm, jm):
    params_from_jax(tm, jax.tree.map(np.asarray, jm.params))
    state_from_jax(tm, jax.tree.map(np.asarray, jm.state))
    return tm


@pytest.fixture
def carry_members(monkeypatch):
    """Make the port's member ``i`` start from the JAX member's init: the
    JAX model's copy built with ``seed + i``, as the JAX trainers build
    it."""
    built = {}

    def carry(jmodel):
        orig = ttrainers._build_member

        def build(model, seed):
            member = orig(model, seed)
            jm = jmodel.copy()
            jm.build(jmodel.input_shape, seed=seed)
            built[seed] = jm
            return _bridge(member, jm)

        monkeypatch.setattr(ttrainers, "_build_member", build)
        return built

    return carry


def _weights_close(a, b, atol):
    for x, y in zip(a.get_weights(), b.get_weights(), strict=True):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol,
                                   rtol=0)


def _losses_close(jh, th, rtol):
    assert len(th) == len(jh) > 0
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=rtol)


@pytest.mark.parametrize("vmapped", [False, True], ids=["threaded",
                                                        "vmapped"])
def test_ensemble_matches_jax(vmapped, carry_members):
    """4 ``mnist_mlp(hidden=16)`` members, 1024 rows (4 x 256 rows tile
    into full windows), 2 epochs, window 4, sgd 0.05 — the port with
    ``pallas_sgd`` (B1's plain version here), JAX with ``sgd``: every
    member's per-step losses within 1e-5 relative and weights within 1e-6
    (only the matmul summation order differs), the members distinct."""
    built = carry_members(jzoo.mnist_mlp(hidden=16))
    jds, tds = _data(1024)
    jt = JEnsemble(jzoo.mnist_mlp(hidden=16), "sgd", num_models=4,
                   vmapped=vmapped, **KW)
    jres = jt.train(jds)
    kernels.reset_launch_counts()
    tt = EnsembleTrainer(zoo.mnist_mlp(hidden=16, device="cpu"),
                         "pallas_sgd", num_models=4, vmapped=vmapped,
                         device="cpu", **KW)
    tres = tt.train(tds)
    assert set(kernels.launch_counts().values()) == {0}  # plain on CPU
    assert sorted(built) == [0, 1, 2, 3]
    assert len(tres) == 4 and not any(m.training for m in tres)
    for i in range(4):
        assert len(tt.get_history(i)) == 16
        _losses_close(jt.get_history(i), tt.get_history(i), 1e-5)
        _weights_close(tres[i], jres[i], 1e-6)
    assert len(tt.history.get_timings(3)) == 4
    assert not np.allclose(tres[0].get_weights()[0],
                           tres[1].get_weights()[0])


def _bn_stack(L):
    return [L.Dense(16), L.BatchNorm(momentum=0.9), L.Activation("relu"),
            L.Dense(10, activation="softmax")]


@pytest.mark.parametrize("vmapped", [False, True], ids=["threaded",
                                                        "vmapped"])
def test_averaging_matches_jax(vmapped):
    """``AveragingTrainer`` on a Dense/BatchNorm stack, 4 replicas, 2
    epochs: per-epoch restart from the center with a fresh optimizer, the
    replicas' mean as the new center (the host mean threaded, the device
    mean vmapped, as in JAX) and replica 0's moving statistics as its
    state. Losses within 1e-5 relative, the center and the statistics
    within 1e-6 of JAX's."""
    jm = JSequential(_bn_stack(jl)).build((784,))
    tm = _bridge(Sequential(_bn_stack(tl)).build((784,), device="cpu"), jm)
    jds, tds = _data(1024)
    jt = JAveraging(jm, "sgd", num_workers=4, vmapped=vmapped, **KW)
    jres = jt.train(jds)
    tt = AveragingTrainer(tm, "pallas_sgd", num_workers=4, vmapped=vmapped,
                          device="cpu", **KW)
    tres = tt.train(tds)
    for i in range(4):
        assert len(tt.get_history(i)) == 16
        _losses_close(jt.get_history(i), tt.get_history(i), 1e-5)
    _weights_close(tres, jres, 1e-6)
    own = dict(tres.named_buffers())
    flat = jax.tree_util.tree_flatten_with_path(jres.state)[0]
    assert len(own) == len(flat) == 2
    for path, v in flat:
        name = ".".join(str(p.key) for p in path)
        np.testing.assert_allclose(own[name].numpy(), np.asarray(v),
                                   atol=1e-6, rtol=0, err_msg=name)
        assert not torch.equal(own[name], dict(tm.named_buffers())[name])
    assert not tres.training


@pytest.mark.parametrize("cls,opt", [
    (EnsembleTrainer, "pallas_adam"), (EnsembleTrainer, "adam"),
    (AveragingTrainer, "pallas_adam"), (AveragingTrainer, "sgd"),
], ids=["ensemble-pallas_adam", "ensemble-adam", "averaging-pallas_adam",
        "averaging-sgd"])
def test_vmapped_matches_threaded(cls, opt):
    """Within the port, the vmapped path (one optimizer apply over every
    member's leaves per step, one state for all) against the threaded
    path (a state per member), as JAX's ``test_trainers_sync.py`` holds
    its two paths: every rule updates leaf by leaf, so the members step
    exactly alike — Ensemble losses and weights equal bit for bit;
    Averaging's means differ in summation order (host adds in sequence,
    the device stacks), so 1e-6."""
    _, tds = _data(1024)
    n = dict(num_models=4) if cls is EnsembleTrainer else dict(num_workers=4)
    kw = {**KW, "learning_rate": 1e-3 if "adam" in opt else 0.05}
    runs = [cls(zoo.mnist_mlp(hidden=16, device="cpu"), opt, vmapped=vm,
                device="cpu", **n, **kw) for vm in (False, True)]
    out = [t.train(tds) for t in runs]
    tol = 0 if cls is EnsembleTrainer else 1e-6
    for i in range(4):
        _losses_close(runs[0].get_history(i), runs[1].get_history(i), tol)
    pairs = zip(*out) if cls is EnsembleTrainer else [out]
    for a, b in pairs:
        _weights_close(a, b, tol)


def test_vmapped_truncates_to_the_shortest_window(carry_members):
    """1022 rows over 4 members: partitions of 256, 256, 255, 255 rows,
    so 8, 8, 7, 7 batches. The joint steps cut to the shortest member's
    window (4, then 3), as JAX's: 7 steps per member, JAX's losses and
    weights; the threaded path trains every member's own tail."""
    carry_members(jzoo.mnist_mlp(hidden=16))
    jds, tds = _data(1022)
    kw = {**KW, "num_epoch": 1}
    jt = JEnsemble(jzoo.mnist_mlp(hidden=16), "sgd", num_models=4,
                   vmapped=True, **kw)
    jres = jt.train(jds)
    tt = EnsembleTrainer(zoo.mnist_mlp(hidden=16, device="cpu"), "sgd",
                         num_models=4, vmapped=True, device="cpu", **kw)
    tres = tt.train(tds)
    for i in range(4):
        assert len(tt.get_history(i)) == len(jt.get_history(i)) == 7
        _losses_close(jt.get_history(i), tt.get_history(i), 1e-5)
        _weights_close(tres[i], jres[i], 1e-6)
    threaded = EnsembleTrainer(zoo.mnist_mlp(hidden=16, device="cpu"), "sgd",
                               num_models=4, device="cpu", **kw)
    threaded.train(tds)
    assert [len(threaded.get_history(i)) for i in range(4)] == [8, 8, 7, 7]


def test_hooked_lm_vmapped_ensemble_matches_jax(carry_members):
    """The slice as a whole: ``transformer_lm(61, 32, 32, 2, 2)`` with the
    flash and LayerNorm hooks under ``EnsembleTrainer(vmapped=True)`` and
    ``pallas_adam``, 2 members, batch 8, window 2, 64 sequences (2 joint
    windows): JAX runs its Pallas kernels in interpret mode under
    ``vmap``, the port the kernels' plain versions member by member.
    Per-step losses within 1e-5 relative, weights within 1e-5."""
    jlm = jzoo.transformer_lm(61, 32, 32, 2, 2)
    jfa.attach_flash_attention(jlm)
    jln.attach_fused_layernorm(jlm)
    carry_members(jlm)
    tlm = zoo.transformer_lm(61, 32, 32, 2, 2, device="cpu")
    tfa.attach_flash_attention(tlm)
    tln.attach_fused_layernorm(tlm)
    x = np.random.default_rng(0).integers(0, 61, (64, 32))
    kw = dict(loss="next_token_crossentropy",
              metrics=["next_token_accuracy"], batch_size=8, window=2,
              num_models=2, vmapped=True, learning_rate=1e-3, seed=0)
    jt = JEnsemble(jlm, "pallas_adam", **kw)
    jres = jt.train(JDataset({"features": x, "label": x}))
    kernels.reset_launch_counts()
    tt = EnsembleTrainer(tlm, "pallas_adam", device="cpu", **kw)
    tres = tt.train(Dataset({"features": x, "label": x}))
    assert set(kernels.launch_counts().values()) == {0}
    for i in range(2):
        assert len(tt.get_history(i)) == 4
        _losses_close(jt.get_history(i), tt.get_history(i), 1e-5)
        _weights_close(tres[i], jres[i], 1e-5)
    assert all(b.norm_fn is not None for b in tres[1].layers
               if isinstance(b, tl.LayerNorm))


def test_member_trainer_contract(monkeypatch):
    """``resume=True`` and ``validation_data`` are refused as in JAX; the
    vmapped path trains through ``WorkerCore.member_window`` (never the
    threaded path); member ``i`` starts from the caller's model built with
    ``seed + i``; ``device=None`` means CUDA."""
    _, tds = _data(256)
    tm = zoo.mnist_mlp(hidden=16, device="cpu")
    for cls, n in ((EnsembleTrainer, "num_models"),
                   (AveragingTrainer, "num_workers")):
        with pytest.raises(ValueError, match="does not support resume"):
            cls(tm, "sgd", device="cpu", **{n: 2}).train(tds, resume=True)
        with pytest.raises(TypeError, match="validation_data"):
            cls(tm, "sgd", device="cpu", validation_data=tds)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                cls(tm, "sgd", label_col="label_onehot").train(tds)
    calls = []
    real = WorkerCore.member_window
    monkeypatch.setattr(WorkerCore, "member_window",
                        lambda self, *a: calls.append(1) or real(self, *a))
    monkeypatch.setattr(ttrainers, "SingleTrainerWorker", None)
    inits = EnsembleTrainer(tm, "sgd", num_models=3, num_epoch=0,
                            vmapped=True, device="cpu", seed=5).train(tds)
    for i, member in enumerate(inits):
        _weights_close(member, zoo.mnist_mlp(hidden=16, seed=5 + i,
                                             device="cpu"), 0)
    EnsembleTrainer(tm, "sgd", num_models=2, vmapped=True, device="cpu",
                    label_col="label_onehot", **{"batch_size": 32}).train(tds)
    AveragingTrainer(tm, "sgd", num_workers=2, vmapped=True, device="cpu",
                     label_col="label_onehot", batch_size=32).train(tds)
    assert len(calls) == 2
