"""Checkpoint/resume in the port vs the JAX package on the CPU.

Mirrors ``tests/test_checkpoint.py``: the atomic store, the epoch-granular
``SingleTrainer`` resume — bit-identical (atol 0) to an uninterrupted run
for every optimizer of the table — and the commit-granular async resume
(center, PS meta, each worker's local state). Across the packages: a
checkpoint the JAX ``SingleTrainer`` wrote resumes in the port, held to
the JAX package's uninterrupted run at the bars of
``test_single_trainer_matches_jax`` (losses 1e-4 relative, params 1e-4
absolute); and a resumed simulated async run commits exactly as often as
the JAX trainer's and lands on its center at the bar of
``test_trainer_matches_jax_simulated`` (1e-5 absolute).
"""

import os

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu import AEASGD as JAEASGD
from distkeras_tpu.data import loaders as jloaders
from distkeras_tpu.data import transformers as jtf
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.trainers import SingleTrainer as JSingleTrainer
from distkeras_tpu_torch import (
    AEASGD,
    DOWNPOUR,
    DynSGD,
    SingleTrainer,
    loaders,
    zoo,
)
from distkeras_tpu_torch.data import transformers as ttf
from distkeras_tpu_torch.ops.optimizers import get_optimizer
from distkeras_tpu_torch.parameter_servers import (
    DeltaParameterServer,
    DynSGDParameterServer,
)
from distkeras_tpu_torch.utils.checkpoint import Checkpointer
from distkeras_tpu_torch.utils.convert import (
    opt_state_from_jax,
    params_from_jax,
)
from distkeras_tpu_torch.utils.serialization import (
    deserialize_params,
    serialize_params,
)
from distkeras_tpu_torch.workers import AEASGDWorker, WorkerCore

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _uncached_jax_cores(monkeypatch):
    """Uncached JAX ``WorkerCore``s (``DKT_DISABLE_CORE_CACHE``): a later
    JAX test of the same model and optimizer must not be handed these
    runs' cores."""
    monkeypatch.setenv("DKT_DISABLE_CORE_CACHE", "1")


def make_data(n=512, port=True):
    mod, tf = (loaders, ttf) if port else (jloaders, jtf)
    ds = mod.synthetic_mnist(n=n, seed=0)
    ds = tf.MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    return tf.OneHotTransformer(10, output_col="label_onehot").transform(ds)


def mlp(seed=0):
    return zoo.mnist_mlp(hidden=16, seed=seed, device="cpu")


# ------------------------------------------------------------- Checkpointer


def test_checkpointer_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    assert ck.latest_step() is None
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": np.ones(3)}
    assert ck.save(1, {"params": tree}, {"epoch": 1})
    assert ck.save(5, {"params": tree}, {"epoch": 5})
    step, trees, meta = ck.restore()
    assert step == 5 and meta == {"epoch": 5}
    np.testing.assert_array_equal(trees["params"]["w"], tree["w"].numpy())
    step, _, meta = ck.restore(1)
    assert step == 1 and meta["epoch"] == 1
    # duplicate step: the first writer wins
    assert not ck.save(5, {"params": tree}, {"epoch": 99})
    assert ck.restore(5)[2]["epoch"] == 5


def test_checkpointer_overwrite_supersedes_same_step(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.save(8, {"t": {"x": np.zeros(2, np.float32)}}, {"v": 1})
    assert not ck.save(8, {"t": {"x": np.ones(2, np.float32)}}, {"v": 2})
    assert ck.restore()[2]["v"] == 1
    assert ck.save(8, {"t": {"x": np.ones(2, np.float32)}}, {"v": 2},
                   overwrite=True)
    _, trees, meta = ck.restore()
    assert meta["v"] == 2
    np.testing.assert_array_equal(trees["t"]["x"], 1.0)


def test_checkpointer_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"t": {"x": np.zeros(1)}}, {})
    assert ck.all_steps() == [3, 4]
    assert all(n.startswith("ckpt_") for n in os.listdir(tmp_path))


def test_checkpointer_missing_restore(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore()
    with pytest.raises(FileNotFoundError):
        ck.restore(3)


def test_checkpointer_reads_the_jax_store(tmp_path):
    """The two packages' stores share the layout and the frames."""
    from distkeras_tpu.utils.checkpoint import Checkpointer as JCheckpointer

    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    JCheckpointer(str(tmp_path)).save(3, {"params": tree}, {"epoch": 3})
    step, trees, meta = Checkpointer(str(tmp_path)).restore()
    assert step == 3 and meta == {"epoch": 3}
    np.testing.assert_array_equal(trees["params"]["w"], tree["w"])
    Checkpointer(str(tmp_path)).save(4, {"params": tree}, {"epoch": 4})
    assert JCheckpointer(str(tmp_path)).restore()[0] == 4


# ------------------------------------------------------- SingleTrainer


OPTIMIZERS = [
    ("sgd", {}), ("sgd", {"momentum": 0.9}), ("adam", {}),
    ("pallas_adam", {}), ("pallas_sgd", {}), ("adamw", {}), ("adagrad", {}),
    ("adadelta", {}), ("rmsprop", {}), ("nadam", {}), ("lamb", {}),
]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[n + ("-momentum" if k else "")
                              for n, k in OPTIMIZERS])
def test_single_trainer_resume_bit_identical(tmp_path, name, kw):
    """Interrupt after 2 of 3 epochs, resume: bit-identical to the
    uninterrupted run (params, optimizer state and rng come back exactly;
    ``pallas_*`` run their plain versions on CPU tensors)."""
    ds = make_data()
    opt = get_optimizer(name, 0.01, **kw)
    args = dict(loss="categorical_crossentropy", batch_size=64,
                label_col="label_onehot", seed=3, device="cpu")
    ref = SingleTrainer(mlp(7), opt, num_epoch=3, **args).train(
        ds, shuffle=True)
    ck_dir = str(tmp_path / "single")
    SingleTrainer(mlp(7), get_optimizer(name, 0.01, **kw), num_epoch=2,
                  checkpoint_dir=ck_dir, **args).train(ds, shuffle=True)
    assert Checkpointer(ck_dir).latest_step() == 2
    b = SingleTrainer(mlp(7), get_optimizer(name, 0.01, **kw), num_epoch=3,
                      checkpoint_dir=ck_dir, **args)
    out = b.train(ds, shuffle=True, resume=True)
    for x, y in zip(ref.get_weights(), out.get_weights()):
        np.testing.assert_array_equal(x, y)
    assert len(b.get_history()) == len(ds) // 64  # only the third epoch
    assert Checkpointer(ck_dir).all_steps() == [1, 2, 3]


def test_single_trainer_resume_restores_buffers_and_rng(tmp_path):
    """A BatchNorm + Dropout model: the moving statistics and the dropout
    seed stream come back too, so the resume is bit-identical."""
    ds = loaders.synthetic_cifar10(n=64, seed=2)
    ds = ttf.OneHotTransformer(10, output_col="label_onehot").transform(ds)
    args = dict(loss="categorical_crossentropy", batch_size=16,
                label_col="label_onehot", seed=3, device="cpu")

    def model():
        return zoo.cifar10_cnn(seed=1, bn_momentum=0.9, device="cpu")

    ref = SingleTrainer(model(), "adam", num_epoch=2, **args).train(
        ds, shuffle=True)
    ck_dir = str(tmp_path / "bn")
    SingleTrainer(model(), "adam", num_epoch=1, checkpoint_dir=ck_dir,
                  **args).train(ds, shuffle=True)
    out = SingleTrainer(model(), "adam", num_epoch=2, checkpoint_dir=ck_dir,
                        **args).train(ds, shuffle=True, resume=True)
    for (n, x), (_, y) in zip(ref.state_dict().items(),
                              out.state_dict().items()):
        assert torch.equal(x, y), n


def test_single_trainer_checkpoint_every_zero_means_final_only(tmp_path):
    ck_dir = str(tmp_path / "final_only")
    SingleTrainer(mlp(), "sgd", "categorical_crossentropy",
                  learning_rate=0.05, batch_size=64, num_epoch=2,
                  label_col="label_onehot", checkpoint_dir=ck_dir,
                  checkpoint_every=0, device="cpu").train(make_data(256))
    assert Checkpointer(ck_dir).all_steps() == [2]


def test_single_trainer_foreign_opt_state_reinitializes(tmp_path):
    """An optimizer state of another layout (an adam checkpoint resumed
    with momentum sgd) is not loaded: the moments restart, the weights
    and the epoch still come from the checkpoint."""
    ds = make_data(256)
    args = dict(loss="categorical_crossentropy", batch_size=64,
                label_col="label_onehot", checkpoint_dir=str(tmp_path),
                device="cpu")
    SingleTrainer(mlp(), "adam", num_epoch=1, **args).train(ds)
    t = SingleTrainer(mlp(), get_optimizer("sgd", 0.01, momentum=0.9),
                      num_epoch=2, **args)
    t.train(ds, resume=True)
    assert len(t.get_history()) == 4


@pytest.mark.parametrize("name", ["adam", "pallas_adam"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, name):
    """A checkpoint the JAX ``SingleTrainer`` wrote after epoch 1 is
    decoded by the port's store, its optimizer state converted with
    ``opt_state_from_jax``, and resumed for epoch 2: the run follows the
    JAX package's uninterrupted 2-epoch run. The JAX rng key has no
    counterpart in the port's seed stream (``mnist_mlp`` draws none)."""
    kw = dict(loss="categorical_crossentropy", learning_rate=1e-3,
              batch_size=64, label_col="label_onehot", seed=3)
    jds = make_data(port=False)
    jdir = str(tmp_path / "jax")
    JSingleTrainer(jzoo.mnist_mlp(hidden=16, seed=7), name, num_epoch=1,
                   checkpoint_dir=jdir, **kw).train(jds, shuffle=True)
    jfull = JSingleTrainer(jzoo.mnist_mlp(hidden=16, seed=7), name,
                           num_epoch=2, **kw)
    jref = jfull.train(jds, shuffle=True)

    step, trees, meta = Checkpointer(jdir).restore()
    assert step == 1 and meta == {"epoch": 1}
    model = mlp()
    opt = get_optimizer(name, 1e-3)
    trees["opt_state"] = opt_state_from_jax(model, opt, trees["opt_state"])
    del trees["rng"]
    pdir = str(tmp_path / "port")
    Checkpointer(pdir).save(step, trees, meta)
    t = SingleTrainer(model, opt, num_epoch=2, checkpoint_dir=pdir,
                      device="cpu", **kw)
    out = t.train(make_data(), shuffle=True, resume=True)
    want = jfull.get_history()[len(jds) // 64:]
    got = t.get_history()
    assert len(got) == len(want) == 8
    for a, b in zip(want, got):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
    for a, b in zip(jref.get_weights(), out.get_weights()):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=0)


def test_opt_state_from_jax_covers_the_table():
    """Every optax chain of the name table, and a schedule's count, lands
    in the layout the port's optimizer exports, leaf order included."""
    from distkeras_tpu.ops import optimizers as jopt
    from distkeras_tpu_torch.ops.optimizers import export_state
    from distkeras_tpu_torch.utils.tree import tree_signature

    jm = jzoo.mnist_mlp(hidden=16)
    model = mlp()
    params_from_jax(model, jax.tree.map(np.asarray, jm.params))
    cases = [("sgd", {}), ("sgd", {"momentum": 0.9}), ("adam", {}),
             ("adamw", {}), ("adagrad", {}), ("adadelta", {}),
             ("rmsprop", {}), ("rmsprop", {"momentum": 0.9}), ("nadam", {}),
             ("lamb", {}), ("pallas_adam", {}), ("pallas_sgd", {}),
             ("pallas_sgd", {"momentum": 0.9})]
    for name, kw in cases:
        for lr in (0.01, lambda s: 0.01):
            if callable(lr) and name.startswith("pallas"):
                continue
            jstate = jopt.get_optimizer(name, lr, **kw).init(jm.params)
            jstate = deserialize_params(serialize_params(
                jax.tree.map(np.asarray, jstate)))
            opt = get_optimizer(name, lr, **kw)
            got = opt_state_from_jax(model, opt, jstate)
            want = export_state(opt, opt.init(list(model.parameters())))
            assert tree_signature(got) == tree_signature(want), (name, kw)
            live = opt.init(list(model.parameters()))
            opt.load_state(live, got)
            for a, b in zip(jax.tree.leaves(export_state(opt, live)),
                            jax.tree.leaves(want)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------- PS-granular (async)


ASYNC = dict(worker_optimizer="sgd", loss="categorical_crossentropy",
             learning_rate=0.05, batch_size=32, num_workers=2,
             communication_window=2, mode="simulated",
             label_col="label_onehot")


def test_downpour_checkpoints_every_n_commits(tmp_path):
    ck_dir = str(tmp_path / "dp")
    t = DOWNPOUR(mlp(), num_epoch=1, checkpoint_dir=ck_dir,
                 checkpoint_every=2, max_to_keep=100, device="cpu", **ASYNC)
    t.train(make_data(640))
    ck = Checkpointer(ck_dir)
    final = t.parameter_server.num_updates
    assert ck.all_steps() == list(range(2, final + 1, 2))
    _, trees, meta = ck.restore()
    center = t.parameter_server.get_params()
    assert trees["center"].keys() == center.keys()
    for k in center:
        np.testing.assert_array_equal(trees["center"][k], center[k])
    assert meta["ps_meta"]["num_updates"] == final
    assert meta["stream"]["rows"] == 640
    # a periodic snapshot holds each worker's state at its last commit
    _, trees, _ = ck.restore(2)
    assert {int(s["seq"]) for s in trees["workers"].values()} <= {1, 2}


def test_dynsgd_resume_restores_version_counter(tmp_path):
    ds = make_data(256)
    ck_dir = str(tmp_path / "dyn")
    t = DynSGD(mlp(), num_epoch=1, checkpoint_dir=ck_dir, device="cpu",
               **ASYNC)
    t.train(ds)
    version = t.parameter_server._meta["version"]
    assert version > 0
    _, trees, meta = Checkpointer(ck_dir).restore()
    ps2 = DynSGDParameterServer(trees["center"])
    ps2.restore_snapshot(trees["center"], meta["ps_meta"])
    assert ps2._meta["version"] == version and ps2.pull()[1] == version
    t2 = DynSGD(mlp(), num_epoch=2, checkpoint_dir=ck_dir, device="cpu",
                **ASYNC)
    t2.train(ds, resume=True)
    assert t2.parameter_server._meta["version"] == 2 * version
    assert t2.parameter_server.num_updates == 2 * version


def test_aeasgd_resume_restores_worker_replicas_and_matches_jax(tmp_path):
    """Checkpoints carry each worker's local state — the persistent
    elastic replica, buffers, optimizer state, rng and commit seq — and
    the dedup table. The resumed run restores the replicas (no re-adoption
    of the center), skips the absorbed windows, commits exactly twice the
    first run's count, and matches the JAX trainer's resumed run."""
    kw = dict(ASYNC, rho=5.0, learning_rate=0.05)
    ck_dir = str(tmp_path / "ae")
    jm = jzoo.mnist_mlp(hidden=16)

    def port_model():
        m = mlp()
        params_from_jax(m, jax.tree.map(np.asarray, jm.params))
        return m

    t1 = AEASGD(port_model(), num_epoch=1, checkpoint_dir=ck_dir,
                device="cpu", **kw)
    t1.train(make_data())
    n1 = t1.parameter_server.num_updates
    _, trees, meta = Checkpointer(ck_dir).restore()
    assert set(trees["workers"]) == {"0", "1"}
    snap0 = trees["workers"]["0"]
    assert set(snap0) == {"params", "state", "opt_state", "rng", "seq"}
    assert int(snap0["seq"]) > 0 and meta["ps_meta"]["seen_seq"]
    assert any(not np.allclose(trees["center"][n], snap0["params"][n])
               for n in trees["center"]), "the replica is not the center"

    t2 = AEASGD(port_model(), num_epoch=2, checkpoint_dir=ck_dir,
                device="cpu", **kw)
    t2.train(make_data(), resume=True)
    for w in t2.workers:
        assert w._restore_point is not None and w._start_seq > 0
        assert len(w.timings) == w._seq - w._start_seq
    assert t2.parameter_server.num_updates == 2 * n1

    jdir = str(tmp_path / "jax")
    jkw = {k: v for k, v in kw.items()}
    JAEASGD(jzoo.mnist_mlp(hidden=16), num_epoch=1, checkpoint_dir=jdir,
            **jkw).train(make_data(port=False))
    j2 = JAEASGD(jzoo.mnist_mlp(hidden=16), num_epoch=2, checkpoint_dir=jdir,
                 **jkw)
    j2.train(make_data(port=False), resume=True)
    assert j2.parameter_server.num_updates == t2.parameter_server.num_updates
    jc = {".".join(str(k.key) for k in path): np.asarray(leaf)
          for path, leaf in jax.tree_util.tree_flatten_with_path(
              j2.parameter_server.get_params())[0]}
    for name, value in t2.parameter_server.get_params().items():
        np.testing.assert_allclose(value, jc[name], atol=1e-5, rtol=0)


def test_async_worker_snapshot_roundtrip_bit_identical():
    """Worker level: ``restore_snapshot`` reproduces the replica, the
    optimizer state, the rng and the seq bit for bit through the codec,
    and a retry after the resume goes back to the restore point."""
    ds = make_data(128)
    model = mlp()
    core = WorkerCore(model, get_optimizer("sgd", 0.05, momentum=0.9),
                      "categorical_crossentropy")
    ps = DeltaParameterServer(dict(zip(model._leaf_order(),
                                       model.get_weights())))
    w = AEASGDWorker(core, ps, 0, "features", "label_onehot", 2, rho=5.0,
                     learning_rate=0.05, device="cpu")
    w.keep_snapshot = True
    w.train(ds, batch_size=32, num_epoch=1)
    assert w._snap is not None and int(w._snap["seq"]) == w._seq == 2
    snap = deserialize_params(serialize_params(w._snap))
    w2 = AEASGDWorker(core, ps, 0, "features", "label_onehot", 2, rho=5.0,
                      learning_rate=0.05, device="cpu")
    w2.restore_snapshot(snap)
    assert w2._seq == w2._start_seq == w._seq

    def check():
        for name, p in zip(w2._names, w2._params):
            np.testing.assert_array_equal(p.detach().numpy(),
                                          w._snap["params"][name])
        for a, b in zip(w2._opt_state, w._snap["opt_state"]):
            np.testing.assert_array_equal(a.numpy(), b)
        assert torch.equal(w2.rng.get_state(),
                           torch.from_numpy(w._snap["rng"]))

    check()
    w2.rng.next()
    w2._seq = 12345
    with torch.no_grad():
        w2._params[0].add_(1.0)
    w2.reset_for_retry()
    assert w2._seq == w._seq
    check()


def test_resume_refuses_another_window_stream(tmp_path):
    ds = make_data(256)
    ck_dir = str(tmp_path / "fp")
    DOWNPOUR(mlp(), num_epoch=1, checkpoint_dir=ck_dir, device="cpu",
             **ASYNC).train(ds)
    t = DOWNPOUR(mlp(), num_epoch=2, checkpoint_dir=ck_dir, device="cpu",
                 **{**ASYNC, "batch_size": 16})
    with pytest.raises(ValueError, match="window stream"):
        t.train(ds, resume=True)


def test_threads_mode_resume_is_exactly_once(tmp_path):
    """Thread mode: the warm-up window runs on the restored replicas and
    gives them back their restored state; the resumed run commits exactly
    the windows the checkpoint had not absorbed."""
    ds = make_data(256)
    ck_dir = str(tmp_path / "thr")
    kw = dict(ASYNC, mode="threads", checkpoint_dir=ck_dir, device="cpu")
    t1 = AEASGD(mlp(), num_epoch=1, **kw)
    t1.train(ds)
    n1 = t1.parameter_server.num_updates
    assert t1.failures == [] and n1 == 4
    t2 = AEASGD(mlp(), num_epoch=2, **kw)
    t2.train(ds, resume=True)
    assert t2.failures == []
    assert t2.parameter_server.num_updates == 2 * n1
    assert t2.parameter_server.num_duplicates == 0
    assert [w._start_seq for w in t2.workers] == [2, 2]


def test_mid_run_snapshot_resume_is_exactly_once(tmp_path):
    """A crash after the periodic checkpoint at commit 4 (every 2 commits,
    worker states handed over every 2nd commit): the resume restores the
    4-update center with worker states at or behind it, the replayed
    windows the center already holds are dropped by the restored dedup
    table (a worker with no state in the checkpoint replays from
    scratch), and the run ends with exactly the uninterrupted run's
    number of commits."""
    import shutil

    ds = make_data(512)
    kw = dict(ASYNC, num_epoch=1, device="cpu", worker_snapshot_stride=2)
    full = DOWNPOUR(mlp(), **kw)
    full.train(ds)
    ck_dir = str(tmp_path / "mid")
    t1 = DOWNPOUR(mlp(), checkpoint_dir=ck_dir, checkpoint_every=2,
                  max_to_keep=100, **kw)
    t1.train(ds)
    ck = Checkpointer(ck_dir)
    for step in ck.all_steps():
        if step > 4:  # the crash: nothing after commit 4 reached the disk
            shutil.rmtree(ck._step_dir(step))
    _, trees, meta = ck.restore()
    seen = meta["ps_meta"]["seen_seq"]
    seqs = {k: int(v["seq"]) for k, v in trees.get("workers", {}).items()}
    assert meta["ps_meta"]["num_updates"] == 4 == sum(v + 1 for v in seen.values())
    assert all(seqs[k] <= seen[k] + 1 for k in seqs)  # never ahead
    t2 = DOWNPOUR(mlp(), checkpoint_dir=ck_dir, **kw)
    t2.train(ds, resume=True)
    ps = t2.parameter_server
    assert ps.num_updates == full.parameter_server.num_updates
    assert ps.num_duplicates == sum(v + 1 - seqs.get(k, 0)
                                    for k, v in seen.items())
    assert [w._start_seq for w in t2.workers] == [
        seqs.get(str(i), 0) for i in range(2)]
