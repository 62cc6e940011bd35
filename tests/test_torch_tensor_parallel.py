"""The port's tensor parallelism vs the JAX package on the CPU.

``SynchronousDistributedTrainer(model_parallel=k)`` runs one process per
rank of a (data, model) grid over ``torch.distributed``. Here the ranks are
gloo processes on the CPU, launched through ``Job.run_local`` (one
module-scoped launch per world size); each rank writes its results to an
``.npz`` that this process holds against the JAX trainer at the same grid
on the conftest's 8-device CPU mesh. Same data (numpy, seeded) and bridged
weights on both sides. Tolerances are ``tests/test_torch_sync_dp.py``'s:
f32 throughout, only the summation order differs — 1e-4 relative on
losses and 1e-4 absolute on weights. A resumed run against a straight one,
rank against rank and the weight bridge against the whole leaves are bit
for bit.
"""

import socket
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import SynchronousDistributedTrainer, zoo
from distkeras_tpu_torch.job_deployment import Job
from distkeras_tpu_torch.parallel import mesh as tmesh
from distkeras_tpu_torch.parallel import tensor_parallel as ttp

torch.set_num_threads(2)

#: every launch joins within this many seconds or fails
LAUNCH_TIMEOUT = 110
SGD = dict(loss="categorical_crossentropy", learning_rate=0.05,
           batch_size=16, num_epoch=1, label_col="label_onehot", seed=0)
ADAM = {**SGD, "learning_rate": 1e-3}
LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)
LM_TRAIN = dict(metrics=["next_token_accuracy"], batch_size=8, window=2,
                learning_rate=1e-3, seed=0)

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
    from distkeras_tpu_torch.ops import flash_attention as tfa
    from distkeras_tpu_torch.ops import fused_layernorm as tln
    from distkeras_tpu_torch.parallel import tensor_parallel as tp
    from distkeras_tpu_torch.utils.convert import params_from_jax

    inputs = np.load(sys.argv[1])
    kind, out_dir = sys.argv[2], sys.argv[3]
    rank = multihost.process_id()
    results = {}

    def whole(prefix):
        return {k[len(prefix):]: inputs[k] for k in inputs.files
                if k.startswith(prefix)}

    def dataset(x, y, label="label_onehot"):
        return Dataset({"features": inputs[x], label: inputs[y]})

    def run(tag, model, optimizer, data, resume=False, **kw):
        trainer = SynchronousDistributedTrainer(
            model, optimizer, device="cpu", **kw)
        res = trainer.train(data, shuffle=True, resume=resume)
        assert all(l.model_group is None for l in res.modules()
                   if hasattr(l, "model_group"))
        results[tag + "/loss"] = np.array(
            [h["loss"] for h in trainer.get_history()])
        for name, t in res.state_dict().items():
            results[tag + "/" + name] = t.numpy()
        return trainer

    def shards(tag, model, k):
        # what a rank stores: the bridge loads the whole JAX leaves into
        # this rank's shards, and gathering them gives the leaves back
        grid = tp.make_dp_tp_mesh(int(inputs["data"]), k, device="cpu")
        n = tp.attach_model_group(model, grid)
        params_from_jax(model, whole(tag + "/"))
        results[tag + "_split/n"] = np.array(n)
        for name, p in model.named_parameters():
            results[tag + "_split/" + name] = p.detach().numpy().copy()
        for name, p in tp.whole_named_parameters(model).items():
            results[tag + "_whole/" + name] = p.numpy()
        tp.detach_model_group(model)

    if kind == "grid":
        mnist = dataset("x", "y")

        def mlp():
            return params_from_jax(zoo.mnist_mlp(hidden=64, device="cpu"),
                                   whole("mlp/"))

        shards("mlp", zoo.mnist_mlp(hidden=64, device="cpu"), 2)
        run("pallas_sgd", mlp(), "pallas_sgd", mnist, num_workers=2,
            model_parallel=2, **SGD)
        run("adam", mlp(), "adam", mnist, num_workers=2, model_parallel=2,
            **ADAM)
        ckpt = dict(num_workers=2, model_parallel=2,
                    checkpoint_dir=sys.argv[4])
        run("straight", mlp(), "adam", mnist, num_workers=2,
            model_parallel=2, **{**ADAM, "num_epoch": 2})
        run("first", mlp(), "adam", mnist, **ckpt, **ADAM)
        run("resumed", mlp(), "adam", mnist, resume=True, **ckpt,
            **{**ADAM, "num_epoch": 2})
    else:
        seqs = dataset("tokens", "tokens", label="label")
        lm = params_from_jax(zoo.transformer_lm(**LM, device="cpu"),
                             whole("lm/"))
        tln.attach_fused_layernorm(lm)
        tfa.attach_flash_attention(lm)
        shards("lm", zoo.transformer_lm(**LM, device="cpu"), 2)
        t = run("lm", lm, "pallas_adam", seqs, model_parallel=2,
                loss="next_token_crossentropy", **LM_TRAIN)
        assert t.mesh.shape == {"data": 1, "model": 2}
        assert t.num_workers == 1
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
    consts = (f"SGD = {SGD!r}\nADAM = {ADAM!r}\nLM = {LM!r}\n"
              f"LM_TRAIN = {LM_TRAIN!r}\n")
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


def _jax_tp(jmodel, opt, data, **kw):
    from distkeras_tpu.data.dataset import Dataset as JDataset
    from distkeras_tpu.trainers import SynchronousDistributedTrainer as JSync

    t = JSync(jmodel, opt, **kw)
    assert dict(t.mesh.shape) == {"data": kw["num_workers"],
                                  "model": kw["model_parallel"]}
    res = t.train(JDataset(data), shuffle=True)
    return [h["loss"] for h in t.get_history()], res


def _case(results, tag):
    return {k[len(tag) + 1:]: v for k, v in results.items()
            if k.startswith(tag + "/")}


def _assert_matches_jax(port, jax_run):
    jlosses, jres = jax_run
    np.testing.assert_allclose(port["loss"], jlosses, rtol=1e-4)
    for name, v in _flat_jax(jres.params).items():
        np.testing.assert_allclose(port[name], v, atol=1e-4, rtol=0,
                                   err_msg=name)


@pytest.fixture(scope="module")
def grid_ranks(tmp_path_factory):
    """One 4-rank launch on the (data 2, model 2) grid, and JAX's
    ``SynchronousDistributedTrainer(num_workers=2, model_parallel=2)``."""
    from distkeras_tpu.models import zoo as jzoo

    tmp = tmp_path_factory.mktemp("tp4")
    x, y = _mnist()
    weights = _flat_jax(jzoo.mnist_mlp(hidden=64, seed=0).params)
    inputs = {"x": x, "y": y, "data": np.array(2)}
    inputs.update({f"mlp/{k}": v for k, v in weights.items()})
    ranks = _launch(tmp, 4, "grid", inputs, extra=[str(tmp / "ckpt")])
    data = {"features": x, "label_onehot": y}
    tp = dict(num_workers=2, model_parallel=2)
    jax_runs = {
        opt: _jax_tp(jzoo.mnist_mlp(hidden=64, seed=0), opt, data, **tp,
                     **(SGD if opt == "pallas_sgd" else ADAM))
        for opt in ("pallas_sgd", "adam")
    }
    return ranks, jax_runs, weights


@pytest.fixture(scope="module")
def model_ranks(tmp_path_factory):
    """One 2-rank launch on the (data 1, model 2) grid: the small LM with
    both kernel hooks (their plain versions on the CPU) and pallas_adam,
    against JAX's trainer at the same grid (adam: the same update)."""
    from distkeras_tpu.models import zoo as jzoo

    tmp = tmp_path_factory.mktemp("tp2")
    tokens = np.random.default_rng(0).integers(0, 61, (32, 32)).astype(
        np.int32)
    weights = _flat_jax(jzoo.transformer_lm(**LM, seed=0).params)
    inputs = {"tokens": tokens, "data": np.array(1)}
    inputs.update({f"lm/{k}": v for k, v in weights.items()})
    ranks = _launch(tmp, 2, "model", inputs)
    jax_run = _jax_tp(jzoo.transformer_lm(**LM, seed=0), "adam",
                      {"features": tokens, "label": tokens},
                      loss="next_token_crossentropy", num_workers=1,
                      model_parallel=2, **LM_TRAIN)
    return ranks, jax_run, weights


# ------------------------------------------------------------ the rule


SHAPES = [(), (1,), (2,), (3,), (10,), (64,), (784, 64), (784, 10),
          (3, 3, 8, 32), (3, 3, 3, 6), (5, 7), (8, 1), (1, 8), (61, 32),
          (32, 96), (2, 3, 5)]


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_leaf_partition_spec_matches_jax(shape, k):
    from distkeras_tpu.parallel.tensor_parallel import leaf_partition_spec

    want = tuple(leaf_partition_spec(shape, k))
    got = ttp.leaf_partition_spec(shape, k)
    assert isinstance(got, ttp.PartitionSpec) and tuple(got) == want


@pytest.mark.parametrize("which", ["mnist_mlp", "transformer_lm"])
def test_describe_shardings_matches_jax(which):
    """{leaf: spec} of the whole model at model width 2, JAX's keys
    (``['1']['mhsa']['wq']``) read as the port's ``state_dict`` names."""
    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.parallel.tensor_parallel import (
        describe_shardings, make_dp_tp_mesh)

    if which == "mnist_mlp":
        jm, m = jzoo.mnist_mlp(hidden=64), zoo.mnist_mlp(hidden=64,
                                                          device="cpu")
    else:
        jm = jzoo.transformer_lm(**LM)
        m = zoo.transformer_lm(**LM, device="cpu")
    want = {
        key.replace("']['", ".").strip("[']"): tuple(spec)
        for key, spec in describe_shardings(jm.params,
                                            make_dp_tp_mesh(4, 2)).items()
    }
    group = tmesh.DataMesh(2, 0, None, torch.device("cpu"))
    got = {k: tuple(v) for k, v in ttp.describe_shardings(m, group).items()}
    assert got == want
    assert ("model",) in got.values() and (None, "model") in got.values()


# ------------------------------------------------- (data 2, model 2) grid


def test_each_rank_stores_only_its_shard(grid_ranks):
    """Every leaf the rule splits is held as this rank's contiguous shard
    (the model index's slice of the trailing dimension, the same on both
    data ranks); the bridge cut it from JAX's whole leaf and gathering the
    shards gives the leaf back bit for bit."""
    ranks, _, weights = grid_ranks
    for r, res in enumerate(ranks):
        i = r % 2  # the model index: rank d * 2 + i
        split = _case(res, "mlp_split")
        assert int(split.pop("n")) == len(weights)  # every leaf divides
        held = sum(v.nbytes for v in split.values())
        assert held * 2 == sum(v.nbytes for v in weights.values())
        for name, w in weights.items():
            c = w.shape[-1] // 2
            np.testing.assert_array_equal(split[name],
                                          w[..., i * c:(i + 1) * c])
            np.testing.assert_array_equal(_case(res, "mlp_whole")[name], w)


@pytest.mark.parametrize("optimizer", ["pallas_sgd", "adam"])
def test_grid_matches_jax(grid_ranks, optimizer):
    ranks, jax_runs, _ = grid_ranks
    port = _case(ranks[0], optimizer)
    assert len(port["loss"]) == 256 // 32
    _assert_matches_jax(port, jax_runs[optimizer])


def test_grid_ranks_end_bit_equal(grid_ranks):
    ranks, _, _ = grid_ranks
    for other in ranks[1:]:
        assert other.keys() == ranks[0].keys()
        for k in ranks[0]:
            if "_split/" not in k:
                np.testing.assert_array_equal(other[k], ranks[0][k],
                                              err_msg=k)


def test_grid_checkpoint_resumes_straight_trajectory(grid_ranks):
    """One epoch, its checkpoint (the shards and their Adam moments
    gathered whole, rank 0 writes), then a resumed second epoch on every
    rank (re-sharded): bit for bit two epochs straight."""
    ranks, _, _ = grid_ranks
    straight = _case(ranks[0], "straight")
    first, resumed = _case(ranks[0], "first"), _case(ranks[0], "resumed")
    half = len(straight["loss"]) // 2
    np.testing.assert_array_equal(first["loss"], straight["loss"][:half])
    np.testing.assert_array_equal(resumed["loss"], straight["loss"][half:])
    for k in straight:
        if k != "loss":
            np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)


# ------------------------------------------------- (data 1, model 2) grid


def test_lm_through_every_seam_matches_jax(model_ranks):
    """The LM's Embedding, attention projections, LayerNorms and head
    split over the model group (flash and LN hooks on, pallas_adam), at
    JAX's (1, 2) grid."""
    from distkeras_tpu.parallel.tensor_parallel import leaf_partition_spec

    ranks, jax_run, weights = model_ranks
    split = _case(ranks[0], "lm_split")
    cut = {k for k, w in weights.items() if leaf_partition_spec(w.shape, 2)}
    assert int(split.pop("n")) == len(cut) == len(weights) - 2
    for name, w in weights.items():  # the 61-way head stays whole
        c = w.shape[-1] // 2 if name in cut else w.shape[-1]
        assert split[name].shape == (*w.shape[:-1], c), name
    _assert_matches_jax(_case(ranks[0], "lm"), jax_run)
    for k in ranks[0]:
        if "_split/" not in k:
            np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)


# ------------------------------------------------------------ refusals


def _fake_grid(k=2):
    """A (1, k) grid whose groups run no collective: enough to construct
    a trainer in one process."""
    cpu = torch.device("cpu")
    return tmesh.GridMesh(("data", "model"), tmesh.DataMesh(1, 0, None, cpu),
                          tmesh.DataMesh(k, 0, None, cpu),
                          tmesh.DataMesh(k, 0, None, cpu))


def test_bad_model_parallel_configs_rejected():
    m = zoo.mnist_mlp(hidden=16, device="cpu")
    kw = dict(loss="categorical_crossentropy", label_col="label_onehot",
              device="cpu")
    with pytest.raises(ValueError, match="devices"):
        SynchronousDistributedTrainer(m, model_parallel=16, **kw)
    with pytest.raises(ValueError, match="divide"):
        SynchronousDistributedTrainer(m, model_parallel=3, **kw)
    with pytest.raises(ValueError, match="'model' axis of size 2"):
        SynchronousDistributedTrainer(
            m, mesh=tmesh.make_mesh(device="cpu"), model_parallel=2, **kw)
    with pytest.raises(ValueError, match="cannot combine"):
        SynchronousDistributedTrainer(m, model_parallel=2,
                                      expert_parallel=2, **kw)
    with pytest.raises(ValueError, match="ZeRO-1"):
        SynchronousDistributedTrainer(m, model_parallel=2,
                                      shard_opt_state=True, **kw)
    with pytest.raises(ValueError, match="trust ratio"):
        SynchronousDistributedTrainer(m, "lamb", mesh=_fake_grid(),
                                      model_parallel=2, **kw)
    t = SynchronousDistributedTrainer(m, mesh=_fake_grid(), model_parallel=2,
                                      **kw)
    assert t.mesh.shape == {"data": 1, "model": 2} and t.num_workers == 1


def test_moe_layer_refuses_a_model_group():
    """``MoE`` takes a model group now: its router, ``wi`` and ``wo`` are
    split along their trailing dimension like every other leaf (JAX's
    placement; ``tests/test_torch_expert_parallel.py`` trains it against
    JAX's ``model_parallel=2``), and a layer without a tensor-parallel
    forward is still refused before anything changes."""
    m = zoo.moe_transformer_lm(61, 32, 32, 2, 1, num_experts=2,
                               device="cpu")
    whole = {n: tuple(p.shape) for n, p in m.named_parameters()}
    assert ttp.attach_model_group(m, _fake_grid()) == len(whole) - 2
    moe = m.layers[2]
    assert moe.model_split == {"router": (32, 2), "wi": (2, 32, 128),
                               "wo": (2, 128, 32)}
    assert tuple(moe.router.shape) == (32, 1)
    assert tuple(moe.wi.shape) == (2, 32, 64)
    assert tuple(moe.wo.shape) == (2, 128, 16)
    assert ttp.whole_shapes(m) == whole
    ttp.detach_model_group(m, gather=False)
    assert all(getattr(l, "model_group", None) is None for l in m.modules())

    from distkeras_tpu_torch.models.layers import Dense
    from distkeras_tpu_torch.models.sequential import Sequential

    class Odd(Dense):
        pass

    odd = Sequential([Odd(4)]).build((8,), device="cpu")
    with pytest.raises(NotImplementedError, match="Odd has no tensor-"
                                                  "parallel forward"):
        ttp.attach_model_group(odd, _fake_grid())
    assert odd.layers[0].model_group is None
