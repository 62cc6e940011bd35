"""The port's pipeline parallelism vs the JAX package on the CPU.

``pipeline_apply`` and ``PipelineParallelTrainer`` run one process per
rank of a pipe group (and of a (pipe, data) grid) over
``torch.distributed``. Here the ranks are gloo processes on the CPU,
launched through ``Job.run_local`` (one module-scoped launch per world
size, 2 and 4); each rank writes its results to an ``.npz`` that this
process holds against JAX's ``pipeline_apply`` and trainer at the same
mesh on the conftest's 8-device CPU mesh. Same inputs (numpy, seeded) and
bridged weights on both sides. Tolerances: ``pipeline_apply`` outputs
1e-5 and gradients 2e-4 absolute (``tests/test_pipeline_parallel.py``'s);
trainer losses 1e-4 relative and weights 1e-4 absolute
(``tests/test_torch_sync_dp.py``'s): f32, another summation order. A
resumed run against a straight one and rank against rank are bit for bit.
Plain SGD shows a gradient counted S times or on one stage only, which
Adam's normalization would hide.
"""

import socket
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import PipelineParallelTrainer, SingleTrainer, zoo
from distkeras_tpu_torch.job_deployment import Job
from distkeras_tpu_torch.parallel import mesh as tmesh
from distkeras_tpu_torch.parallel import pipeline_parallel as tpp
from distkeras_tpu_torch.utils import convert

torch.set_num_threads(2)

#: every launch joins within this many seconds or fails
LAUNCH_TIMEOUT = 110
D, DEPTH = 16, 8  # pipeline_apply's blocks: tanh(h @ w + b) + h
LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=4)
LM_TRAIN = dict(loss="next_token_crossentropy",
                metrics=["next_token_accuracy"], batch_size=16, window=2,
                seed=0, num_micro=4)
HYPER = {"pallas_adam": dict(learning_rate=1e-3),
         "pallas_sgd": dict(learning_rate=0.05)}
#: (tag, optimizer, pipe width, data width) of each trainer run, per world
RUNS = {
    2: [("pipe2_adam", "pallas_adam", 2, 1),
        ("pipe2_sgd", "pallas_sgd", 2, 1)],
    4: [("pipe4_adam", "pallas_adam", 4, 1),
        ("pipe2x2_sgd", "pallas_sgd", 2, 2)],
}

_RANK_SCRIPT = textwrap.dedent(
    """
    import shutil
    import sys

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from distkeras_tpu_torch.parallel import multihost

    assert multihost.initialize(device="cpu", timeout=60)
    from distkeras_tpu_torch import (
        PipelineParallelTrainer, SingleTrainer, zoo)
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.ops import flash_attention as tfa
    from distkeras_tpu_torch.ops import fused_layernorm as tln
    from distkeras_tpu_torch.parallel import pipeline_parallel as pp
    from distkeras_tpu_torch.parallel.mesh import make_grid
    from distkeras_tpu_torch.utils.convert import params_from_jax

    inputs = np.load(sys.argv[1])
    out_dir = sys.argv[2]
    rank = multihost.process_id()
    world = multihost.num_processes()
    results = {}

    def whole(prefix):
        return {k[len(prefix):]: inputs[k] for k in inputs.files
                if k.startswith(prefix)}

    def block_apply(p, h):
        return torch.tanh(h @ p["w"] + p["b"]) + h

    # pipeline_apply over the whole world, values and the gradients of
    # sum(out ** 2): the rank's stage's, and the input's (on stage 0)
    grid = make_grid(1, world, "pipe", device="cpu", data_axis=False)
    stacked = {n: torch.from_numpy(inputs["blocks_" + n]) for n in "wb"}
    stage = pp.shard_stacked_params(stacked, grid)
    for n in stage:
        stage[n].requires_grad_()
    x = torch.from_numpy(inputs["x"]).requires_grad_()
    out = pp.pipeline_apply(stage, x, block_apply, grid, num_micro=4)
    out.square().sum().backward()
    results["apply/out"] = out.detach().numpy()
    results["apply/dx"] = grid.inner.all_reduce_(x.grad).numpy()
    for n in "wb":
        results["apply/d" + n] = stage[n].grad.numpy()

    data = Dataset({"features": inputs["tokens"], "label": inputs["tokens"]})

    def lm():
        m = params_from_jax(zoo.transformer_lm(**LM, device="cpu"),
                            whole("lm/"))
        tln.attach_fused_layernorm(m)
        tfa.attach_flash_attention(m)
        return m

    def run(tag, opt, pipe, dp, resume=False, cls=PipelineParallelTrainer,
            **kw):
        kw = {**LM_TRAIN, **HYPER[opt], **kw}
        if cls is PipelineParallelTrainer:
            kw.update(num_workers=pipe * dp, data_parallel=dp)
        else:
            kw.pop("num_micro")
        t = cls(lm(), opt, device="cpu", **kw)
        res = t.train(data, shuffle=True, resume=resume)
        assert type(res).__name__ == "Sequential"
        if cls is PipelineParallelTrainer:
            results[tag + "/mesh"] = np.array(
                [t.mesh.shape["pipe"], t.mesh.shape.get("data", 0)])
        results[tag + "/loss"] = np.array(
            [h["loss"] for h in t.get_history()])
        for name, p in res.state_dict().items():
            results[tag + "/" + name] = p.numpy()

    for tag, opt, pipe, dp in RUNS[world]:
        run(tag, opt, pipe, dp)
    if world == 2:
        ckpt = dict(checkpoint_dir=sys.argv[3])
        run("straight", "pallas_adam", 2, 1, num_epoch=2)
        run("first", "pallas_adam", 2, 1, **ckpt)
        # every rank resumes SingleTrainer from its own copy (it writes)
        own = f"{sys.argv[3]}_single{rank}"
        shutil.copytree(sys.argv[3], own)
        run("single", "pallas_adam", 1, 1, resume=True, num_epoch=2,
            cls=SingleTrainer, checkpoint_dir=own)
        run("resumed", "pallas_adam", 2, 1, resume=True, num_epoch=2,
            **ckpt)
        run("accum2", "pallas_sgd", 2, 1, accum_steps=2)
    np.savez(f"{out_dir}/rank{rank}.npz", **results)
    multihost.shutdown()
    print("RANK_OK", rank, flush=True)
    """
)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, n, inputs):
    script = tmp_path / "ranks.py"
    consts = "".join(f"{k} = {v!r}\n" for k, v in (
        ("LM", LM), ("LM_TRAIN", LM_TRAIN), ("HYPER", HYPER),
        ("RUNS", RUNS)))
    script.write_text(consts + _RANK_SCRIPT)
    np.savez(tmp_path / "inputs.npz", **inputs)
    out = tmp_path / "out"
    out.mkdir()
    job = Job(str(script), num_hosts=n,
              coordinator_address=f"127.0.0.1:{_free_port()}",
              script_args=[str(tmp_path / "inputs.npz"), str(out),
                           str(tmp_path / "ckpt")],
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


def _inputs():
    from distkeras_tpu.models import zoo as jzoo

    rng = np.random.default_rng(0)
    out = {
        "blocks_w": (0.3 * rng.standard_normal((DEPTH, D, D))).astype(
            np.float32),
        "blocks_b": (0.1 * rng.standard_normal((DEPTH, D))).astype(
            np.float32),
        "x": np.random.default_rng(1).standard_normal((16, D)).astype(
            np.float32),
        "tokens": np.random.default_rng(0).integers(0, 61, (32, 32)).astype(
            np.int32),
    }
    jm = jzoo.transformer_lm(**LM, seed=0)
    out.update({f"lm/{k}": v for k, v in _flat_jax(jm.params).items()})
    return out


def _jax_apply(inputs, n):
    """JAX's ``pipeline_apply`` on an n-way ("pipe",) mesh: the output and
    the gradients of sum(out ** 2) for the stack and the input."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from distkeras_tpu.parallel.pipeline_parallel import pipeline_apply

    mesh = Mesh(np.array(jax.devices()[:n]), ("pipe",))

    def block_apply(p, h):
        return jnp.tanh(h @ p["w"] + p["b"]) + h

    def loss(stacked, x):
        out = pipeline_apply(stacked, x, block_apply, mesh, num_micro=4)
        return jnp.sum(out ** 2), out

    stacked = {n_: jnp.asarray(inputs["blocks_" + n_]) for n_ in "wb"}
    (_, out), (gs, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stacked, jnp.asarray(inputs["x"]))
    return {"out": np.asarray(out), "dx": np.asarray(gx),
            "dw": np.asarray(gs["w"]), "db": np.asarray(gs["b"])}


def _jax_train(inputs, opt, pipe, dp):
    from distkeras_tpu.data.dataset import Dataset as JDataset
    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.trainers import PipelineParallelTrainer as JPP

    t = JPP(jzoo.transformer_lm(**LM, seed=0), opt, num_workers=pipe * dp,
            data_parallel=dp, **LM_TRAIN, **HYPER[opt])
    assert dict(t.mesh.shape) == ({"pipe": pipe, "data": dp} if dp > 1
                                  else {"pipe": pipe})
    res = t.train(JDataset({"features": inputs["tokens"],
                            "label": inputs["tokens"]}), shuffle=True)
    return [h["loss"] for h in t.get_history()], _flat_jax(res.params)


def _world(tmp_path_factory, n):
    inputs = _inputs()
    ranks = _launch(tmp_path_factory.mktemp(f"pp{n}"), n, inputs)
    trained = {tag: _jax_train(inputs, opt, pipe, dp)
               for tag, opt, pipe, dp in RUNS[n]}
    return ranks, trained, _jax_apply(inputs, n)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _world(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _world(tmp_path_factory, 4)


@pytest.fixture(params=[2, 4])
def world(request):
    return request.getfixturevalue(
        {2: "two_ranks", 4: "four_ranks"}[request.param])


def _case(results, tag):
    return {k[len(tag) + 1:]: v for k, v in results.items()
            if k.startswith(tag + "/")}


# ------------------------------------------------------- pipeline_apply


def test_pipeline_apply_matches_jax(world):
    """Every rank's output equals JAX's (and the sequential blocks'); the
    stage gradients put back together along the block axis, and the
    input's, equal JAX's: the ring's backward and the last stage's
    gather count the loss once."""
    ranks, _, want = world
    n = len(ranks)
    per = DEPTH // n
    seq = np.asarray(_case(ranks[0], "apply")["out"])
    for res in ranks:
        got = _case(res, "apply")
        np.testing.assert_allclose(got["out"], want["out"], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(got["dx"], want["dx"], atol=2e-4, rtol=0)
        np.testing.assert_array_equal(got["out"], seq)
    for name in ("dw", "db"):
        got = np.concatenate([_case(r, "apply")[name] for r in ranks])
        assert got.shape[0] == n * per
        np.testing.assert_allclose(got, want[name], atol=2e-4, rtol=0,
                                   err_msg=name)


def test_pipeline_apply_is_the_sequential_tower(world):
    ranks, _, _ = world
    inputs = _inputs()
    h = inputs["x"]
    for w, b in zip(inputs["blocks_w"], inputs["blocks_b"]):
        h = np.tanh(h @ w + b) + h
    np.testing.assert_allclose(_case(ranks[0], "apply")["out"], h,
                               atol=1e-5, rtol=0)


# ------------------------------------------------------------ the trainer


@pytest.mark.parametrize("tag", [r[0] for r in RUNS[2] + RUNS[4]])
def test_trainer_matches_jax(request, tag):
    """Pipe 2 and pipe 4, and the (pipe 2, data 2) grid, under Adam and
    plain SGD, against JAX's ``PipelineParallelTrainer`` at the same mesh
    (transformer_lm, 4 blocks, 4 microbatches, both kernel hooks)."""
    world = 2 if tag in [r[0] for r in RUNS[2]] else 4
    ranks, trained, _ = request.getfixturevalue(
        {2: "two_ranks", 4: "four_ranks"}[world])
    _, _, pipe, dp = next(r for r in RUNS[world] if r[0] == tag)
    jlosses, jparams = trained[tag]
    for r, res in enumerate(ranks):  # every stage returns the whole model
        port = _case(res, tag)
        assert list(port.pop("mesh")) == [pipe, dp if dp > 1 else 0]
        np.testing.assert_allclose(port["loss"], jlosses, rtol=1e-4,
                                   err_msg=f"{tag} rank {r}")
        for name, v in jparams.items():
            np.testing.assert_allclose(port[name], v, atol=1e-4, rtol=0,
                                       err_msg=f"{tag} rank {r} {name}")


def test_ranks_end_bit_equal(world):
    """The returned model is whole and normal on every rank: the stages
    gathered and unstacked into the blocks."""
    ranks, _, _ = world
    for other in ranks[1:]:
        for k in ranks[0]:
            if not k.startswith("apply/"):
                np.testing.assert_array_equal(other[k], ranks[0][k],
                                              err_msg=k)


def test_checkpoint_resumes_straight_trajectory(two_ranks):
    """One epoch and its checkpoint (the per-layer parameters, the whole
    stacked Adam moments; rank 0 writes), then a resumed second epoch on
    every rank: bit for bit two epochs straight."""
    ranks, _, _ = two_ranks
    straight = _case(ranks[0], "straight")
    first, resumed = _case(ranks[0], "first"), _case(ranks[0], "resumed")
    half = len(straight["loss"]) // 2
    np.testing.assert_array_equal(first["loss"], straight["loss"][:half])
    np.testing.assert_array_equal(resumed["loss"], straight["loss"][half:])
    for k in straight:
        if k not in ("loss", "mesh"):
            np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)


def test_single_trainer_resumes_pipeline_checkpoint(two_ranks):
    """``SingleTrainer`` reads the pipeline checkpoint's per-layer
    parameters and trains the second epoch from the first's weights: its
    first loss is the resumed pipeline run's; the moments' stacked layout
    is not its own, so they restart and the second step differs."""
    ranks, _, _ = two_ranks
    single = _case(ranks[0], "single")
    resumed = _case(ranks[0], "resumed")
    assert len(single["loss"]) == len(resumed["loss"]) == 2
    assert sorted(k for k in single if k != "loss") == sorted(
        k for k in resumed if k not in ("loss", "mesh"))
    np.testing.assert_allclose(single["loss"][0], resumed["loss"][0],
                               rtol=1e-5)
    assert abs(single["loss"][1] - resumed["loss"][1]) > 1e-4


def test_accum_steps_composes_with_the_schedule(two_ranks):
    """Two accumulation microbatches, each through the whole schedule:
    plain SGD's weights are the one-step run's (JAX's bar)."""
    ranks, _, _ = two_ranks
    one, two = _case(ranks[0], "pipe2_sgd"), _case(ranks[0], "accum2")
    for k in one:
        if k not in ("loss", "mesh"):
            np.testing.assert_allclose(two[k], one[k], atol=5e-6, rtol=0,
                                       err_msg=k)


# ------------------------------------------------------- one process


def _fake_pipe(s=4, dp=1):
    cpu = torch.device("cpu")
    if dp == 1:
        group = tmesh.DataMesh(s, 0, None, cpu)
        return tmesh.GridMesh(("pipe",), tmesh.DataMesh(1, 0, None, cpu),
                              group, group)
    return tmesh.GridMesh(("pipe", "data"), tmesh.DataMesh(dp, 0, None, cpu),
                          tmesh.DataMesh(s, 0, None, cpu),
                          tmesh.DataMesh(s * dp, 0, None, cpu))


def _blocks(depth):
    rng = np.random.default_rng(0)
    return [{"w": torch.tensor(rng.standard_normal((D, D)), dtype=torch.float32),
             "b": torch.zeros(D)} for _ in range(depth)]


def test_stack_unstack_roundtrip():
    blocks = _blocks(DEPTH)
    stacked = tpp.stack_block_params(blocks)
    assert stacked["w"].shape == (DEPTH, D, D)
    for a, b in zip(blocks, tpp.unstack_block_params(stacked)):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    stage = tpp.shard_stacked_params(stacked, _fake_pipe(4))
    assert stage.depth == DEPTH and stage["w"].shape == (2, D, D)
    assert torch.equal(stage["w"], stacked["w"][:2])


def test_divisibility_errors():
    def apply(p, h):
        return h @ p["w"]

    with pytest.raises(ValueError, match="block depth 6 not divisible by "
                                         "mesh axis pipe=4"):
        tpp.pipeline_apply(tpp.stack_block_params(_blocks(6)),
                           torch.zeros(8, D), apply, _fake_pipe(4))
    with pytest.raises(ValueError, match="not divisible by num_micro=4"):
        tpp.pipeline_apply(tpp.stack_block_params(_blocks(4)),
                           torch.zeros(6, D), apply, _fake_pipe(4),
                           num_micro=4)
    with pytest.raises(ValueError, match="microbatch 3 not divisible by "
                                         "mesh axis data=2"):
        tpp.pipeline_apply(tpp.stack_block_params(_blocks(2)),
                           torch.zeros(6, D), apply, _fake_pipe(2, 2),
                           num_micro=2, batch_axis="data")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpp.pipeline_apply(tpp.stack_block_params(_blocks(4)),
                           torch.zeros(8, D), apply, _fake_pipe(4),
                           param_specs={})


def _data(n=32):
    from distkeras_tpu_torch.data.dataset import Dataset

    return Dataset({"features": np.zeros((n, 16), np.float32),
                    "label_onehot": np.zeros((n, 2), np.float32)})


def test_trainer_requires_block_tower():
    t = PipelineParallelTrainer(zoo.mnist_mlp(hidden=16, device="cpu"),
                                "sgd", batch_size=32,
                                label_col="label_onehot", mesh=_fake_pipe(4),
                                device="cpu")
    with pytest.raises(ValueError, match="homogeneous block tower"):
        t.train(_data())


def test_trainer_rejects_rng_consuming_block_tower():
    from distkeras_tpu_torch.models.layers import Dense, Dropout
    from distkeras_tpu_torch.models.sequential import Sequential

    model = Sequential(
        [Dense(32, activation="relu"), Dropout(0.5), Dropout(0.5),
         Dropout(0.5), Dropout(0.5), Dense(2, activation="softmax")]
    ).build((16,), seed=0, device="cpu")
    t = PipelineParallelTrainer(model, "sgd", batch_size=32,
                                label_col="label_onehot", mesh=_fake_pipe(4),
                                device="cpu")
    with pytest.raises(ValueError, match="homogeneous block tower"):
        t.train(_data())


def test_trainer_mesh_and_refusals():
    lm = zoo.transformer_lm(**LM, device="cpu")
    kw = dict(loss="next_token_crossentropy", device="cpu")
    t = PipelineParallelTrainer(lm, mesh=_fake_pipe(2, 2), **kw)
    assert t.mesh.shape == {"pipe": 2, "data": 2}
    assert t.num_workers == 2 and t.num_micro == 2
    with pytest.raises(ValueError, match="has no 'pipe' axis"):
        PipelineParallelTrainer(lm, mesh=tmesh.make_mesh(device="cpu"), **kw)
    with pytest.raises(ValueError, match="conflicts with the supplied mesh"):
        PipelineParallelTrainer(lm, mesh=_fake_pipe(4), data_parallel=2, **kw)
    with pytest.raises(ValueError, match="not divisible by data_parallel=2"):
        PipelineParallelTrainer(lm, num_workers=3, data_parallel=2, **kw)
    with pytest.raises(TypeError, match="validation_data"):
        PipelineParallelTrainer(lm, validation_data=object(), **kw)


def test_batch_must_divide_by_micro_and_data():
    from distkeras_tpu_torch.data.dataset import Dataset

    lm = zoo.transformer_lm(**LM, device="cpu")
    t = PipelineParallelTrainer(lm, "sgd", "next_token_crossentropy",
                                batch_size=6, num_micro=4,
                                mesh=_fake_pipe(2), device="cpu")
    tokens = np.zeros((12, 32), np.int32)
    with pytest.raises(ValueError, match="must divide by num_micro"):
        t.train(Dataset({"features": tokens, "label": tokens}))


# ------------------------------------------------------- the weight bridge


def test_bridge_round_trips_jax_stacked_layout():
    """JAX's pipelined params (``"__blocks__"``, stacked by its own
    ``stack_block_params``) unstack to its per-layer params and stack back,
    bit for bit; ``params_from_jax`` loads either layout alike."""
    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.parallel.pipeline_parallel import stack_block_params

    jm = jzoo.transformer_lm(**LM, seed=0)
    blocks = [1, 2, 3, 4]
    normal = {k: v for k, v in jm.params.items()}
    piped = {k: v for k, v in normal.items() if int(k) not in blocks}
    piped["__blocks__"] = stack_block_params([normal[str(i)] for i in blocks])
    back = convert.unstack_blocks(piped, blocks)
    for k, v in _flat_jax(normal).items():
        np.testing.assert_array_equal(_flat_jax(back)[k], v, err_msg=k)
    again = convert.stack_blocks(back, blocks)
    for k, v in _flat_jax(piped).items():
        np.testing.assert_array_equal(_flat_jax(again)[k], v, err_msg=k)
    a = convert.params_from_jax(zoo.transformer_lm(**LM, device="cpu"),
                                normal)
    b = convert.params_from_jax(zoo.transformer_lm(**LM, device="cpu"),
                                piped)
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k


def test_bridge_takes_jax_pipelined_moments():
    """JAX's Adam moments over the pipelined params come into the
    pipeline rank's layout (``"__blocks__.*"`` leaves, whole stacks at one
    stage) bit for bit by name, and round-trip through the per-layer
    layout."""
    import jax
    import jax.numpy as jnp
    import optax
    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.parallel.pipeline_parallel import stack_block_params

    from distkeras_tpu_torch.ops.optimizers import get_optimizer
    from distkeras_tpu_torch.trainers import _PipelineModelShim

    jm = jzoo.transformer_lm(**LM, seed=0)
    blocks = [1, 2, 3, 4]
    piped = {k: v for k, v in jm.params.items() if int(k) not in blocks}
    piped["__blocks__"] = stack_block_params([jm.params[str(i)]
                                              for i in blocks])
    tx = optax.adam(1e-3)
    state = tx.init(piped)
    grads = jax.tree.map(lambda p: jnp.sin(jnp.arange(p.size, dtype=p.dtype)
                                           ).reshape(p.shape), piped)
    _, state = tx.update(grads, state, piped)
    m = convert.params_from_jax(zoo.transformer_lm(**LM, device="cpu"),
                                piped)
    one = tmesh.DataMesh(1, 0, None, torch.device("cpu"))
    shim = _PipelineModelShim(m, [0], blocks, [5, 6], one, 1)
    names = [n for n, _ in shim.named_parameters()]
    assert sum(n.startswith("__blocks__.") for n in names) == len(
        _flat_jax(piped["__blocks__"]))
    for n, p in shim.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _flat_jax(piped)[n], err_msg=n)
    mu, nu, count = convert.opt_state_from_jax(shim, get_optimizer("adam",
                                                                   1e-3),
                                               state)
    flat_mu = _flat_jax(state[0].mu)
    for n, leaf in zip(names, mu):
        np.testing.assert_array_equal(leaf, flat_mu[n], err_msg=n)
    assert int(count) == 1
    # the moments' trees go between the layouts as the parameters do
    for tree in (state[0].mu, state[0].nu):
        again = convert.stack_blocks(convert.unstack_blocks(tree, blocks),
                                     blocks)
        for k, v in _flat_jax(tree).items():
            np.testing.assert_array_equal(_flat_jax(again)[k], v, err_msg=k)
