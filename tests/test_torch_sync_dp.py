"""The port's synchronous data parallelism vs the JAX package on the CPU.

``SynchronousDistributedTrainer`` runs one process per rank over
``torch.distributed``. Here the ranks are gloo processes on the CPU,
launched through the port's ``Job.run_local`` (so the ``DKT_*`` launcher
plumbing is under test too); each rank writes its results to an ``.npz``
that this process holds against the JAX trainer at the same number of
workers on the conftest's 8-device CPU mesh. Same data (numpy, seeded)
and bridged weights on both sides. Tolerances: f32 throughout, so only
the summation order differs — 1e-4 relative on losses and 1e-4 absolute
on weights after a few steps (``test_torch_train.py``'s), BatchNorm's
moving statistics at rtol 1e-4 / atol 1e-5 (``test_trainers_sync.py``'s).
ZeRO-1 against the replicated optimizer, the resident against the
streamed feed, a resumed run against a straight one and rank against
rank are bit-for-bit.

The JAX package is imported inside the tests that use it, so the
``gpu``-marked cases run on a machine without JAX
(``python -m pytest --noconftest tests/test_torch_sync_dp.py -m gpu``).
"""

import socket
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import SingleTrainer, SynchronousDistributedTrainer
from distkeras_tpu_torch import zoo
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.job_deployment import Job
from distkeras_tpu_torch.models.layers import _dropout
from distkeras_tpu_torch.parallel import mesh as tmesh
from distkeras_tpu_torch.parallel import multihost

torch.set_num_threads(2)

#: every launch joins within this many seconds or fails
LAUNCH_TIMEOUT = 110
SGD = dict(loss="categorical_crossentropy", learning_rate=0.05,
           batch_size=16, num_epoch=1, label_col="label_onehot", seed=0)
ADAM = {**SGD, "learning_rate": 1e-3}
BN = {**SGD, "batch_size": 8}
TAB = dict(loss="categorical_crossentropy", learning_rate=1e-2, batch_size=4,
           num_epoch=2, label_col="label_onehot", seed=0)
LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)
LM_TRAIN = dict(metrics=["next_token_accuracy"], batch_size=8, window=2,
                learning_rate=1e-3, seed=0)

# --------------------------------------------------------------- rank script

_RANK_SCRIPT = textwrap.dedent(
    """
    import sys

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from distkeras_tpu_torch.parallel import multihost

    assert multihost.initialize(device="cpu", timeout=60)
    from distkeras_tpu_torch import SynchronousDistributedTrainer
    from distkeras_tpu_torch import zoo
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.models.layers import (
        Activation, BatchNorm, Dense, Dropout)
    from distkeras_tpu_torch.models.sequential import Sequential
    from distkeras_tpu_torch.parallel.mesh import make_mesh, zero_leaf_sharding

    inputs = np.load(sys.argv[1])
    kind, out_dir = sys.argv[2], sys.argv[3]
    rank = multihost.process_id()
    results = {}

    def load(model, prefix):
        model.load_state_dict({
            k[len(prefix):]: torch.from_numpy(inputs[k])
            for k in inputs.files if k.startswith(prefix)})
        return model

    def dataset(x, y):
        return Dataset({"features": inputs[x], "label_onehot": inputs[y]})

    def run(tag, model, optimizer, data, resume=False, **kw):
        trainer = SynchronousDistributedTrainer(
            model, optimizer, device="cpu", **kw)
        res = trainer.train(data, shuffle=True, resume=resume)
        assert all(getattr(l, "data_group", None) is None
                   for l in res.layers)
        results[tag + "/loss"] = np.array(
            [h["loss"] for h in trainer.get_history()])
        for name, t in res.state_dict().items():
            results[tag + "/" + name] = t.numpy()

    def mlp():
        return load(zoo.mnist_mlp(hidden=16, device="cpu"), "mlp/")

    if kind == "two":
        mnist = dataset("x", "y")
        run("sgd", mlp(), "sgd", mnist, **SGD)
        run("sgd_resident", mlp(), "sgd", mnist, device_resident=True, **SGD)
        run("accum", mlp(), "sgd", mnist, accum_steps=2, **SGD)
        for opt in ("adam", "pallas_adam"):
            run(opt, mlp(), opt, mnist, **ADAM)
            run(opt + "_zero", mlp(), opt, mnist, shard_opt_state=True,
                **ADAM)
        bn = Sequential([Dense(32), BatchNorm(), Activation("relu"),
                         Dense(10, activation="softmax")])
        bn.build((784,), device="cpu")
        run("bn", load(bn, "bn/"), "sgd", mnist, **BN)
        for feed in ("", "_resident"):
            bn = Sequential([Dense(32), BatchNorm(), Activation("relu"),
                             Dense(10, activation="softmax")])
            bn.build((784,), device="cpu")
            run("bn_accum" + feed, load(bn, "bn/"), "sgd", mnist,
                accum_steps=2, device_resident=bool(feed), **BN)
        drop = Sequential([Dense(32, activation="relu"), Dropout(0.5),
                           Dense(10, activation="softmax")])
        drop.build((784,), seed=3, device="cpu")
        run("dropout", drop, "sgd", mnist, **BN)
        two = {**ADAM, "num_epoch": 2}
        run("zero_straight", mlp(), "adam", mnist, shard_opt_state=True,
            **two)
        ckpt = dict(checkpoint_dir=sys.argv[4], shard_opt_state=True)
        run("zero_first", mlp(), "adam", mnist, **ckpt, **ADAM)
        run("zero_resumed", mlp(), "adam", mnist, resume=True, **ckpt,
            **two)
    else:
        tab = dataset("tx", "ty")
        model = load(Sequential([Dense(8, activation="relu"),
                                 Dense(3, activation="softmax")])
                     .build((30,), device="cpu"), "tab/")
        results["dims"] = np.array([
            -1 if d is None else d for d in
            (zero_leaf_sharding(make_mesh(device="cpu"), p)
             for p in model.parameters())])
        run("tab", model, "adam", tab, **TAB)
        run("tab_zero", model, "adam", tab, shard_opt_state=True, **TAB)
    np.savez(f"{out_dir}/rank{rank}.npz", **results)
    multihost.shutdown()
    print("RANK_OK", rank, flush=True)
    """
)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, n, kind, inputs, extra=()):
    """Run the rank script on ``n`` gloo ranks through ``Job.run_local``;
    returns each rank's results."""
    script = tmp_path / "ranks.py"
    consts = (f"SGD = {SGD!r}\nADAM = {ADAM!r}\nBN = {BN!r}\n"
              f"TAB = {TAB!r}\n")
    script.write_text(consts + _RANK_SCRIPT)
    np.savez(tmp_path / "inputs.npz", **inputs)
    out = tmp_path / "out"
    out.mkdir()
    job = Job(str(script), num_hosts=n,
              coordinator_address=f"127.0.0.1:{_free_port()}",
              script_args=[str(tmp_path / "inputs.npz"), kind, str(out),
                           *extra],
              backend="gloo")
    with ThreadPoolExecutor(n) as ex:
        futs = [ex.submit(job.run_local, workdir=str(tmp_path / f"rank{i}"),
                          process_id=i, timeout=LAUNCH_TIMEOUT)
                for i in range(n)]
        procs = [f.result(timeout=LAUNCH_TIMEOUT + 10) for f in futs]
    for i, proc in enumerate(procs):
        assert proc.returncode == 0, f"rank {i}:\n{proc.stdout}\n{proc.stderr}"
        assert f"RANK_OK {i}" in proc.stdout
    return [dict(np.load(out / f"rank{i}.npz")) for i in range(n)]


def _state_dict_np(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _port_from_jax(jmodel, model):
    from distkeras_tpu_torch.utils.convert import params_from_jax, state_from_jax
    import jax

    params_from_jax(model, jax.tree.map(np.asarray, jmodel.params))
    if jmodel.state:
        state_from_jax(model, jax.tree.map(np.asarray, jmodel.state))
    return model


def _flat_jax(tree):
    import jax

    return {
        ".".join(str(k.key) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _mnist(n=256):
    from distkeras_tpu.data import loaders as jloaders
    from distkeras_tpu.data.transformers import (
        MinMaxTransformer, OneHotTransformer)

    ds = jloaders.synthetic_mnist(n=n, seed=0)
    ds = MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    ds = OneHotTransformer(10, output_col="label_onehot").transform(ds)
    return (np.asarray(ds["features"], np.float32),
            np.asarray(ds["label_onehot"], np.float32))


def _jax_bn_model():
    from distkeras_tpu.models.layers import Activation, BatchNorm, Dense
    from distkeras_tpu.models.sequential import Sequential

    return Sequential([Dense(32), BatchNorm(), Activation("relu"),
                       Dense(10, activation="softmax")]).build((784,), seed=0)


def _jax_sync(jmodel, opt, x, y, workers, **kw):
    from distkeras_tpu.data.dataset import Dataset as JDataset
    from distkeras_tpu.trainers import SynchronousDistributedTrainer as JSync

    t = JSync(jmodel, opt, num_workers=workers, **kw)
    res = t.train(JDataset({"features": x, "label_onehot": y}), shuffle=True)
    return [h["loss"] for h in t.get_history()], res


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One 2-rank gloo launch of every 2-rank case, the JAX references at
    2 workers, and the port's one-rank dropout reference."""
    from distkeras_tpu.models import zoo as jzoo

    tmp = tmp_path_factory.mktemp("sync2")
    x, y = _mnist()
    jmlp, jbn = jzoo.mnist_mlp(hidden=16, seed=0), _jax_bn_model()
    mlp = _port_from_jax(jmlp, zoo.mnist_mlp(hidden=16, device="cpu"))
    from distkeras_tpu_torch.models.layers import (
        Activation, BatchNorm, Dense, Dropout)
    from distkeras_tpu_torch.models.sequential import Sequential

    bn = Sequential([Dense(32), BatchNorm(), Activation("relu"),
                     Dense(10, activation="softmax")]).build((784,),
                                                             device="cpu")
    _port_from_jax(jbn, bn)
    inputs = {"x": x, "y": y}
    inputs.update({f"mlp/{k}": v for k, v in _state_dict_np(mlp).items()})
    inputs.update({f"bn/{k}": v for k, v in _state_dict_np(bn).items()})
    ranks = _launch(tmp, 2, "two", inputs, extra=[str(tmp / "ckpt")])
    jax_runs = {
        "sgd": _jax_sync(jzoo.mnist_mlp(hidden=16, seed=0), "sgd", x, y, 2,
                         **SGD),
        "accum": _jax_sync(jzoo.mnist_mlp(hidden=16, seed=0), "sgd", x, y, 2,
                           accum_steps=2, **SGD),
        "bn": _jax_sync(_jax_bn_model(), "sgd", x, y, 2, **BN),
        "bn_accum": _jax_sync(_jax_bn_model(), "sgd", x, y, 2,
                              accum_steps=2, **BN),
    }
    drop = Sequential([Dense(32, activation="relu"), Dropout(0.5),
                       Dense(10, activation="softmax")])
    drop.build((784,), seed=3, device="cpu")
    one = SynchronousDistributedTrainer(drop, "sgd", device="cpu",
                                        **{**BN, "batch_size": 16})
    one_res = one.train(Dataset({"features": x, "label_onehot": y}),
                        shuffle=True)
    dropout_one = {"loss": np.array([h["loss"] for h in one.get_history()]),
                   **_state_dict_np(one_res)}
    return ranks, jax_runs, dropout_one


def _case(results, tag):
    return {k[len(tag) + 1:]: v for k, v in results.items()
            if k.startswith(tag + "/")}


def _assert_matches_jax(port, jax_run, stats=False):
    jlosses, jres = jax_run
    np.testing.assert_allclose(port["loss"], jlosses, rtol=1e-4)
    for name, v in _flat_jax(jres.params).items():
        np.testing.assert_allclose(port[name], v, atol=1e-4, rtol=0)
    if stats:
        for name, v in _flat_jax(jres.state).items():
            np.testing.assert_allclose(port[name], v, rtol=1e-4, atol=1e-5)


def test_two_ranks_sgd_matches_jax(two_ranks):
    ranks, jax_runs, _ = two_ranks
    port = _case(ranks[0], "sgd")
    assert len(port["loss"]) == 256 // 32
    _assert_matches_jax(port, jax_runs["sgd"])


def test_two_ranks_accumulation_matches_jax(two_ranks):
    """accum_steps=2: each rank accumulates over its own rows, then one
    all-reduce — JAX's 2-worker step up to summation order."""
    ranks, jax_runs, _ = two_ranks
    _assert_matches_jax(_case(ranks[0], "accum"), jax_runs["accum"])


def test_two_ranks_batchnorm_takes_global_batch_stats(two_ranks):
    """BatchNorm under a group of 2: moving statistics and weights equal
    JAX's 2-worker trainer, whose GSPMD step takes the statistics over the
    global batch (per-rank statistics miss by ~1e-2)."""
    ranks, jax_runs, _ = two_ranks
    port = _case(ranks[0], "bn")
    assert {"1.mean", "1.var"} <= set(port)
    _assert_matches_jax(port, jax_runs["bn"], stats=True)


@pytest.mark.parametrize("feed", ["streamed", "resident"])
def test_two_ranks_accumulation_normalizes_jax_microbatches(two_ranks, feed):
    """BatchNorm at ``accum_steps=2`` under a group of 2: each rank's part
    of each accumulation microbatch is its rows of JAX's global
    microbatch, so every microbatch normalizes JAX's rows. Losses within
    1e-5 relative, moving statistics and weights as above, on both feeds
    (splitting each rank's own rows normalizes other row sets)."""
    ranks, jax_runs, _ = two_ranks
    tag = "bn_accum" + ("_resident" if feed == "resident" else "")
    for res in ranks:
        port = _case(res, tag)
        np.testing.assert_allclose(port["loss"], jax_runs["bn_accum"][0],
                                   rtol=1e-5)
        _assert_matches_jax(port, jax_runs["bn_accum"], stats=True)


@pytest.mark.parametrize("optimizer", ["adam", "pallas_adam"])
def test_two_ranks_zero_is_bit_identical_to_replicated(two_ranks, optimizer):
    """ZeRO-1 updates each rank's slices and all-gathers them: the same
    elementwise arithmetic, so the trajectory is the replicated one's bit
    for bit (far inside JAX's own bound, rtol 2e-4 / atol 2e-5)."""
    ranks, _, _ = two_ranks
    rep, zero = _case(ranks[0], optimizer), _case(ranks[0], optimizer + "_zero")
    assert rep.keys() == zero.keys()
    for k in rep:
        np.testing.assert_array_equal(zero[k], rep[k], err_msg=k)


def test_two_ranks_resident_equals_streamed(two_ranks):
    ranks, _, _ = two_ranks
    a, b = _case(ranks[0], "sgd"), _case(ranks[0], "sgd_resident")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_ranks_dropout_equals_one_rank_at_global_batch(two_ranks):
    """Under a group each rank keeps its rows of the global batch's mask:
    two ranks at batch 8 train as one rank at batch 16, up to the
    summation order of the mean gradient."""
    ranks, _, one = two_ranks
    port = _case(ranks[0], "dropout")
    np.testing.assert_allclose(port["loss"], one["loss"], rtol=1e-5)
    for k in one:
        np.testing.assert_allclose(port[k], one[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def test_two_ranks_zero_checkpoint_resumes_straight_trajectory(two_ranks):
    """One ZeRO-1 epoch, its checkpoint (moments gathered whole by rank
    0), then a resumed second epoch: bit for bit two epochs straight."""
    ranks, _, _ = two_ranks
    straight = _case(ranks[0], "zero_straight")
    first, resumed = _case(ranks[0], "zero_first"), _case(ranks[0],
                                                         "zero_resumed")
    half = len(straight["loss"]) // 2
    np.testing.assert_array_equal(first["loss"], straight["loss"][:half])
    np.testing.assert_array_equal(resumed["loss"], straight["loss"][half:])
    for k in straight:
        if k != "loss":
            np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)


def test_two_ranks_end_bit_equal(two_ranks):
    ranks, _, _ = two_ranks
    assert ranks[0].keys() == ranks[1].keys()
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


# ------------------------------------------------------------ four ranks


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """A 4-rank launch on a tabular MLP whose first kernel (30, 8) shards
    on its second dimension (30 does not divide by 4), against JAX at 4
    workers."""
    from distkeras_tpu.models.layers import Dense as JDense
    from distkeras_tpu.models.sequential import Sequential as JSequential
    from distkeras_tpu_torch.models.layers import Dense
    from distkeras_tpu_torch.models.sequential import Sequential

    tmp = tmp_path_factory.mktemp("sync4")
    x = np.random.default_rng(4).normal(size=(96, 30)).astype(np.float32)
    yo = np.eye(3, dtype=np.float32)[x[:, :3].argmax(axis=1)]
    jmodel = JSequential([JDense(8, activation="relu"),
                          JDense(3, activation="softmax")]).build((30,), seed=0)
    model = _port_from_jax(jmodel, Sequential(
        [Dense(8, activation="relu"), Dense(3, activation="softmax")]
    ).build((30,), device="cpu"))
    inputs = {"tx": x, "ty": yo}
    inputs.update({f"tab/{k}": v for k, v in _state_dict_np(model).items()})
    ranks = _launch(tmp, 4, "four", inputs)
    return ranks, _jax_sync(jmodel, "adam", x, yo, 4, **TAB)


def test_four_ranks_zero_shards_second_dim(four_ranks):
    """The kernel (30, 8) shards on dim 1 (a non-contiguous slice staged
    through a contiguous buffer), its bias and the (8, 3) kernel on dim
    0, the (3,) bias stays whole; ZeRO-1 is bit for bit the replicated
    run, every rank ends equal, and both match JAX at 4 workers."""
    ranks, jax_run = four_ranks
    assert list(ranks[0]["dims"]) == [1, 0, 0, -1]
    rep, zero = _case(ranks[0], "tab"), _case(ranks[0], "tab_zero")
    for k in rep:
        np.testing.assert_array_equal(zero[k], rep[k], err_msg=k)
    for other in ranks[1:]:
        for k in ranks[0]:
            np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=k)
    _assert_matches_jax(rep, jax_run)


# ------------------------------------------------------- one rank in process


def test_one_rank_equals_single_trainer_and_jax():
    """World 1 (no group): bit for bit the port's SingleTrainer on the LM
    with both kernel hooks and pallas_adam (streamed, ZeRO-1, resident),
    and JAX's 1-worker SynchronousDistributedTrainer within
    test_torch_train's tolerances (the LM without hooks and with adam:
    the hooked pallas_adam run against JAX is test_torch_train's, and the
    Pallas interpret mode is slow)."""
    import jax
    from distkeras_tpu.data.dataset import Dataset as JDataset
    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.trainers import SynchronousDistributedTrainer as JSync
    from distkeras_tpu_torch.ops import flash_attention as tfa
    from distkeras_tpu_torch.ops import fused_layernorm as tln
    from distkeras_tpu_torch.utils.convert import params_from_jax

    x = np.random.default_rng(0).integers(0, 61, (32, 32)).astype(np.int32)
    jt = JSync(jzoo.transformer_lm(**LM, seed=0), "adam",
               "next_token_crossentropy", num_workers=1, **LM_TRAIN)
    jres = jt.train(JDataset({"features": x, "label": x}), shuffle=True)
    weights = jax.tree.map(np.asarray, jzoo.transformer_lm(**LM, seed=0).params)

    def port(cls, hooks=True, opt="pallas_adam", **kw):
        lm = params_from_jax(zoo.transformer_lm(**LM, device="cpu"), weights)
        if hooks:
            tln.attach_fused_layernorm(lm)
            tfa.attach_flash_attention(lm)
        t = cls(lm, opt, "next_token_crossentropy", device="cpu",
                **LM_TRAIN, **kw)
        return t, t.train(Dataset({"features": x, "label": x}), shuffle=True)

    st, sres = port(SingleTrainer)
    for kw in ({}, {"shard_opt_state": True}, {"device_resident": True}):
        t, res = port(SynchronousDistributedTrainer, **kw)
        assert t.num_workers == 1 and t.mesh.group is None
        assert t.get_history() == st.get_history(), kw
        for (n, a), (_, b) in zip(res.named_parameters(),
                                  sres.named_parameters()):
            assert torch.equal(a, b), (kw, n)
    assert res.layers[1].mhsa.attention_fn is tfa.flash_attention
    assert not res.training
    t, res = port(SynchronousDistributedTrainer, hooks=False, opt="adam")
    np.testing.assert_allclose([h["loss"] for h in t.get_history()],
                               [h["loss"] for h in jt.get_history()],
                               rtol=1e-4)
    flat = _flat_jax(jres.params)
    for name, p in res.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat[name], atol=1e-4,
                                   rtol=0)


# ---------------------------------------------------- the group's helpers


SHAPES = [(), (1,), (2,), (3,), (4,), (6,), (3, 4), (784, 16), (16,),
          (30, 8), (3, 3, 4, 8), (3, 3, 3, 6), (5, 7), (8, 1), (1, 8),
          (2, 3, 5)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_zero_leaf_sharding_matches_jax(n):
    from distkeras_tpu.parallel.mesh import make_mesh as jmake_mesh
    from distkeras_tpu.parallel.mesh import zero_leaf_sharding as jrule

    jmesh = jmake_mesh(n)
    mesh = tmesh.DataMesh(n, 0, None, torch.device("cpu"))
    for shape in SHAPES:
        spec = tuple(jrule(jmesh, np.zeros(shape, np.float32)).spec)
        want = spec.index("data") if "data" in spec else None
        assert tmesh.zero_leaf_sharding(mesh, shape) == want, (n, shape)
        assert tmesh.zero_leaf_sharding(mesh, torch.zeros(shape)) == want


def test_rank_rows_and_zero_slices_tile_the_whole():
    """Rank r takes rows [r*B, (r+1)*B) (GSPMD's P("data") shards), and the
    ranks' ZeRO slices of an optimizer state put back together are the
    state."""
    x = np.arange(24).reshape(8, 3)
    parts = [tmesh.rank_rows(x, tmesh.DataMesh(4, r, None, None))
             for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), x)
    cpu = tmesh.DataMesh(4, 2, None, torch.device("cpu"))
    batch = tmesh.shard_batch({"x": x, "y": x[:, 0]}, cpu)
    np.testing.assert_array_equal(batch["x"].numpy(), x[4:6])
    np.testing.assert_array_equal(batch["y"].numpy(), x[4:6, 0])
    w = np.arange(3 * 3 * 4 * 8, dtype=np.float32).reshape(3, 3, 4, 8)
    state = ([w, np.ones(5)], np.int32(7))
    slices = [tmesh.shard_opt_state_zero(state, tmesh.DataMesh(4, r, None,
                                                               None))
              for r in range(4)]
    assert slices[1][0][0].shape == (3, 3, 1, 8)
    np.testing.assert_array_equal(
        np.concatenate([s[0][0] for s in slices], axis=2), w)
    assert all(s[0][1].shape == (5,) and s[1] == 7 for s in slices)
    with pytest.raises(ValueError, match="does not split"):
        tmesh.rank_rows(np.zeros((6, 2)), tmesh.DataMesh(4, 0, None, None))


@pytest.mark.parametrize("accum", [2, 4])
def test_rank_rows_take_each_microbatch_rows(accum):
    """With ``accum=k`` rank r takes its rows of each of the k global
    microbatches, microbatch after microbatch (JAX's reshape(k, B // k),
    each microbatch sharded over the ranks); its k consecutive parts tile
    the global microbatches, on either axis."""
    x = np.arange(16 * 3).reshape(16, 3)
    ranks = 2
    parts = [tmesh.rank_rows(x, tmesh.DataMesh(ranks, r, None, None),
                             accum=accum) for r in range(ranks)]
    per = 16 // accum // ranks
    for j, mb in enumerate(np.split(x, accum)):
        for r in range(ranks):
            np.testing.assert_array_equal(
                parts[r][j * per:(j + 1) * per], mb[r * per:(r + 1) * per])
    np.testing.assert_array_equal(
        tmesh.rank_rows(x.T, tmesh.DataMesh(ranks, 1, None, None), axis=1,
                        accum=accum), parts[1].T)
    with pytest.raises(ValueError, match="microbatches"):
        tmesh.rank_rows(x[:12], tmesh.DataMesh(4, 0, None, None), accum=2)


def test_dropout_under_a_group_keeps_the_global_mask_rows():
    """Each rank draws the global batch's mask from the step seed and
    keeps its rows: the ranks' outputs stacked are one device's at the
    global batch (the residual dropout of TransformerBlock shares it)."""
    x = torch.randn(8, 5, 6)
    whole = _dropout(x, 0.3, 1234)
    parts = [_dropout(x[2 * r:2 * r + 2], 0.3, 1234,
                      tmesh.DataMesh(4, r, None, torch.device("cpu")))
             for r in range(4)]
    assert torch.equal(torch.cat(parts), whole)


def test_zero_shards_group_of_one_is_the_whole_leaf():
    mesh = tmesh.DataMesh(1, 0, None, torch.device("cpu"))
    params = [torch.randn(4, 3), torch.randn(5)]
    z = tmesh.ZeroShards(params, mesh)
    assert z.dims == [0, 0]
    assert all(torch.equal(a, b) for a, b in zip(z.local, params))
    z.local[0].add_(1.0)
    z.gather()
    assert torch.equal(params[0], z.local[0])


def test_all_reduce_mean_group_of_one_is_the_identity():
    mesh = tmesh.DataMesh(1, 0, None, torch.device("cpu"))
    ts = [torch.randn(3), torch.randn(2, 2)]
    assert all(a is b for a, b in zip(tmesh.all_reduce_mean(ts, mesh), ts))


# ------------------------------------------------------------- refusals


def test_more_workers_than_processes_names_initialize():
    m = zoo.mnist_mlp(hidden=8, device="cpu")
    with pytest.raises(ValueError, match="multihost.initialize"):
        SynchronousDistributedTrainer(m, "sgd", num_workers=2, device="cpu")
    with pytest.raises(ValueError, match="multihost.initialize"):
        tmesh.make_mesh(2, device="cpu")


@pytest.mark.parametrize("knob", ["expert_parallel"])
def test_tensor_and_expert_parallel_wait_for_a13(knob):
    """``expert_parallel`` builds its (data, expert) grid over the job's
    processes: one process has too few for an expert group of two (the
    expert mesh itself: ``tests/test_torch_expert_parallel.py``)."""
    m = zoo.mnist_mlp(hidden=8, device="cpu")
    with pytest.raises(ValueError, match=f"{knob}=2 does not divide the 1 "
                                         "available devices"):
        SynchronousDistributedTrainer(m, "sgd", device="cpu", **{knob: 2})


def test_zero_refuses_lamb():
    m = zoo.mnist_mlp(hidden=8, device="cpu")
    with pytest.raises(ValueError, match="trust ratio"):
        SynchronousDistributedTrainer(m, "lamb", device="cpu",
                                      shard_opt_state=True)


def test_single_process_initialize_is_a_no_op(monkeypatch):
    for env in (multihost.ENV_COORDINATOR, multihost.ENV_NUM_PROCESSES,
                multihost.ENV_PROCESS_ID):
        monkeypatch.delenv(env, raising=False)
    assert multihost.initialize() is False
    assert (multihost.process_id(), multihost.num_processes()) == (0, 1)
    assert multihost.is_coordinator()
    multihost.shutdown()  # nothing to leave
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.num_workers, mesh.rank, mesh.group) == (1, 0, None)
    assert tmesh.local_devices(device="cpu") == [torch.device("cpu")]


# ------------------------------------------------------------- on the card


@pytest.mark.gpu
@pytest.mark.parametrize("shard_opt_state", [False, True])
def test_one_rank_nccl_equals_single_trainer_on_card(shard_opt_state):
    """20a at a small width: one NCCL rank over a TCPStore runs the
    kernels (B3 on the ZeRO slices, B4-B8 through the hooks) and equals
    SingleTrainer bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    import datetime

    import torch.distributed as dist

    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    x = np.random.default_rng(0).integers(0, 61, (32, 32)).astype(np.int32)

    def run(cls, **kw):
        lm = zoo.transformer_lm(**LM, seed=0)
        attach_flash_attention(lm)
        attach_fused_layernorm(lm)
        t = cls(lm, "pallas_adam", "next_token_crossentropy", **LM_TRAIN,
                **kw)
        return t, t.train(Dataset({"features": x, "label": x}))

    st, sres = run(SingleTrainer)
    store = dist.TCPStore("127.0.0.1", _free_port(), 1, True,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("nccl", store=store, world_size=1, rank=0)
    try:
        kernels.reset_launch_counts()
        t, res = run(SynchronousDistributedTrainer,
                     shard_opt_state=shard_opt_state)
        counts = kernels.launch_counts()
    finally:
        dist.destroy_process_group()
    assert t.mesh.group is not None
    assert t.get_history() == st.get_history()
    assert all(torch.equal(a, b) for a, b in zip(res.parameters(),
                                                 sres.parameters()))
    assert counts["adam_fused"] == 4 and counts["flash_bwd_dq"] == 4 * 2
