"""The port's expert mesh and global MoE routing vs the JAX package on the
CPU.

``moe_ffn(mesh=)``, ``attach_expert_mesh`` and
``SynchronousDistributedTrainer(expert_parallel=k)`` run one process per
rank over ``torch.distributed``; so does an MoE model under pure data
parallelism and under ``model_parallel``. Here the ranks are gloo
processes on the CPU, launched through ``Job.run_local`` (one
module-scoped launch per world size, 4 and 2); each rank writes its
results to an ``.npz`` that this process holds against JAX's functions and
trainers at the same mesh on the conftest's 8-device CPU mesh, where GSPMD
routes the global batch. Same inputs (numpy, seeded) and bridged weights
on both sides. Tolerances: ``moe_ffn`` outputs 2e-5 and aux 1e-5 absolute
(``tests/test_expert_parallel.py``'s), its gradients 1e-4; trainer losses
1e-4 relative and weights 1e-4 absolute (``tests/test_torch_sync_dp.py``'s):
f32, another summation order. The kept-token mask is exact. Plain SGD
with ``aux_loss_weight=1.0`` shows a load-balance gradient off by a
constant factor, which Adam's normalization would hide.
"""

import socket
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import SynchronousDistributedTrainer, zoo
from distkeras_tpu_torch.job_deployment import Job
from distkeras_tpu_torch.parallel import expert_parallel as tep
from distkeras_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

#: every launch joins within this many seconds or fails
LAUNCH_TIMEOUT = 110
S_ROWS, S_T, D_MOE, E_MOE = 8, 16, 16, 8  # moe_ffn's (rows, T, D), experts
CF = 0.5  # capacity 8 of 128 global tokens: tokens drop
GRIDS = [(2, 2), (1, 4)]  # moe_ffn's (data, expert) grids
LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2,
          num_experts=4)
LM_TRAIN = dict(loss="next_token_crossentropy",
                metrics=["next_token_accuracy"], batch_size=8, window=2,
                seed=0)
ADAM = dict(learning_rate=1e-3)
SGD_AUX = dict(learning_rate=0.05, aux_loss_weight=1.0)
#: (tag, optimizer, knobs, hyper-parameters) of each trainer run, per world
RUNS = {
    4: [("ep_adam", "pallas_adam", {"expert_parallel": 2}, ADAM),
        ("ep_sgd", "pallas_sgd", {"expert_parallel": 2}, SGD_AUX),
        ("tp_adam", "pallas_adam", {"model_parallel": 2}, ADAM)],
    2: [("dp_adam", "pallas_adam", {}, ADAM),
        ("dp_sgd", "pallas_sgd", {}, SGD_AUX),
        ("dp_accum", "pallas_adam", {}, {**ADAM, "accum_steps": 2})],
}
#: route_global calls recorded in the dp_accum run's first step: 2
#: microbatches x 2 MoE layers, in call order
ACCUM_CALLS = 4

_RANK_SCRIPT = textwrap.dedent(
    """
    import sys

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from distkeras_tpu_torch.parallel import multihost

    assert multihost.initialize(device="cpu", timeout=60)
    from distkeras_tpu_torch import SynchronousDistributedTrainer, zoo
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.ops import flash_attention as tfa
    from distkeras_tpu_torch.ops import fused_layernorm as tln
    from distkeras_tpu_torch.parallel import expert_parallel as ep
    from distkeras_tpu_torch.parallel import tensor_parallel as tp
    from distkeras_tpu_torch.parallel.mesh import make_grid, rank_rows
    from distkeras_tpu_torch.utils.convert import params_from_jax

    inputs = np.load(sys.argv[1])
    out_dir = sys.argv[2]
    rank = multihost.process_id()
    world = multihost.num_processes()
    results = {}

    def whole(prefix):
        return {k[len(prefix):]: inputs[k] for k in inputs.files
                if k.startswith(prefix)}

    def moe_layers(m):
        return [l for l in m.modules() if isinstance(l, ep.MoE)]

    if world == 4:
        # moe_ffn on the rank's rows and experts; the parameter gradients
        # summed over the data group are those of the global loss
        # sum(out * g) + D * aux (every data rank's loss holds the aux)
        moe = whole("moe/")
        for dp, k in GRIDS:
            grid = make_grid(dp, k, "expert", device="cpu")
            x = torch.from_numpy(rank_rows(inputs["moe_x"], grid.data))
            x.requires_grad_()
            g = torch.from_numpy(rank_rows(inputs["moe_g"], grid.data))
            p = {n: torch.from_numpy(v).requires_grad_() for n, v in
                 ep.shard_moe_params(moe, grid).items()}
            out, aux = ep.moe_ffn(p, x, capacity_factor=CF, mesh=grid)
            ((out * g).sum() + aux).backward()
            logits = x.detach().reshape(-1, x.shape[-1]) @ p["router"].detach()
            _, pos, _, cap, _ = ep.route_global(logits, CF, grid.data)
            tag = f"ffn_{dp}x{k}/"
            results[tag + "kept"] = (pos < cap).numpy()
            results[tag + "out"] = out.detach().numpy()
            results[tag + "aux"] = aux.detach().numpy()
            results[tag + "dx"] = x.grad.numpy()
            for n in ("router", "wi", "wo"):
                results[tag + "d" + n] = grid.data.all_reduce_(
                    p[n].grad).numpy()

        # what a rank stores under attach_expert_mesh, and the gather back
        grid = make_grid(2, 2, "expert", device="cpu")
        m = params_from_jax(zoo.moe_transformer_lm(**LM, device="cpu"),
                            whole("lm/"))
        results["shards/n"] = np.array(ep.attach_expert_mesh(m, grid))
        for name, p in m.named_parameters():
            results["shards/" + name] = p.detach().numpy().copy()
        for name, p in tp.whole_named_parameters(m).items():
            results["whole/" + name] = p.numpy()
        assert ep.detach_expert_mesh(m) == LM["depth"]
        for name, p in m.state_dict().items():
            results["detached/" + name] = p.numpy()

    data = Dataset({"features": inputs["tokens"], "label": inputs["tokens"]})

    def lm():
        m = params_from_jax(zoo.moe_transformer_lm(**LM, device="cpu"),
                            whole("lm/"))
        tln.attach_fused_layernorm(m)
        tfa.attach_flash_attention(m)
        return m

    def run(tag, opt, knobs, hyper, resume=False, **kw):
        m = lm()
        t = SynchronousDistributedTrainer(m, opt, device="cpu",
                                          **{**LM_TRAIN, **hyper, **knobs,
                                             **kw})
        res = t.train(data, shuffle=True, resume=resume)
        for layer in moe_layers(m) + moe_layers(res):
            assert layer.expert_group is None and layer.data_group is None
            assert layer.model_group is None
        results[tag + "/mesh"] = np.array(
            [t.mesh.shape.get(a, 0) for a in ("data", "expert", "model")])
        results[tag + "/loss"] = np.array(
            [h["loss"] for h in t.get_history()])
        for name, p in res.state_dict().items():
            results[tag + "/" + name] = p.numpy()

    route_global, calls = ep.route_global, []

    def recording(logits, capacity_factor, data=None):
        out = route_global(logits, capacity_factor, data)
        if len(calls) < ACCUM_CALLS:
            idx, pos, _, cap, _ = out
            calls.append((idx.numpy().copy(), (pos < cap).numpy().copy()))
        return out

    for tag, opt, knobs, hyper in RUNS[world]:
        if tag == "dp_accum":
            ep.route_global = recording
        run(tag, opt, knobs, hyper)
        ep.route_global = route_global
    for i, (idx, kept) in enumerate(calls):
        results[f"route/{i}/idx"], results[f"route/{i}/kept"] = idx, kept
    if world == 4:
        ckpt = dict(checkpoint_dir=sys.argv[3])
        ep2 = {"expert_parallel": 2}
        run("straight", "pallas_adam", ep2, ADAM, num_epoch=2)
        run("first", "pallas_adam", ep2, ADAM, **ckpt)
        run("resumed", "pallas_adam", ep2, ADAM, resume=True, num_epoch=2,
            **ckpt)
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
        ("CF", CF), ("GRIDS", GRIDS), ("LM", LM), ("LM_TRAIN", LM_TRAIN),
        ("ADAM", ADAM), ("RUNS", RUNS), ("ACCUM_CALLS", ACCUM_CALLS)))
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

    rng = np.random.default_rng(2)
    out = {
        "moe_x": rng.standard_normal((S_ROWS, S_T, D_MOE)).astype(np.float32),
        "moe_g": rng.standard_normal((S_ROWS, S_T, D_MOE)).astype(np.float32),
        "moe/router": rng.standard_normal((D_MOE, E_MOE)).astype(np.float32),
        "moe/wi": (0.1 * rng.standard_normal((E_MOE, D_MOE, 32))).astype(
            np.float32),
        "moe/wo": (0.1 * rng.standard_normal((E_MOE, 32, D_MOE))).astype(
            np.float32),
        "tokens": np.random.default_rng(0).integers(0, 61, (32, 32)).astype(
            np.int32),
    }
    jm = jzoo.moe_transformer_lm(**LM, seed=0)
    out.update({f"lm/{k}": v for k, v in _flat_jax(jm.params).items()})
    return out


def _jax_ffn(inputs, dp):
    """JAX's global ``moe_ffn`` (one device: GSPMD's global view), its
    kept mask, and the gradients of sum(out * g) + dp * aux."""
    import jax
    import jax.numpy as jnp
    from distkeras_tpu.parallel.expert_parallel import moe_ffn, switch_route

    params = {n: jnp.asarray(inputs["moe/" + n]) for n in ("router", "wi",
                                                            "wo")}
    x, g = jnp.asarray(inputs["moe_x"]), jnp.asarray(inputs["moe_g"])

    def loss(params, x):
        out, aux = moe_ffn(params, x, capacity_factor=CF)
        return jnp.sum(out * g) + dp * aux, (out, aux)

    (_, (out, aux)), (dp_, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, x)
    tokens = x.reshape(-1, D_MOE)
    cap = max(1, int(CF * tokens.shape[0] / E_MOE))
    dispatch, _, _ = switch_route(tokens @ params["router"], cap)
    return {"out": np.asarray(out), "aux": np.asarray(aux),
            "kept": np.asarray(dispatch.sum(axis=(1, 2))) > 0,
            "dx": np.asarray(dx),
            **{"d" + n: np.asarray(v) for n, v in dp_.items()}}


def _jax_train(inputs, knobs, opt, hyper, num_workers):
    from distkeras_tpu.data.dataset import Dataset as JDataset
    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.trainers import SynchronousDistributedTrainer as JSync

    t = JSync(jzoo.moe_transformer_lm(**LM, seed=0), opt,
              num_workers=num_workers, **LM_TRAIN, **hyper, **knobs)
    res = t.train(JDataset({"features": inputs["tokens"],
                            "label": inputs["tokens"]}), shuffle=True)
    return [h["loss"] for h in t.get_history()], _flat_jax(res.params)


def _world(tmp_path_factory, n):
    inputs = _inputs()
    ranks = _launch(tmp_path_factory.mktemp(f"ep{n}"), n, inputs)
    data = 2 if n == 4 else n
    trained = {tag: _jax_train(inputs, knobs, opt, hyper, data)
               for tag, opt, knobs, hyper in RUNS[n]}
    ffn = {dp: _jax_ffn(inputs, dp) for dp, _ in GRIDS} if n == 4 else {}
    return ranks, trained, ffn, inputs


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _world(tmp_path_factory, 4)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _world(tmp_path_factory, 2)


def _case(results, tag):
    return {k[len(tag) + 1:]: v for k, v in results.items()
            if k.startswith(tag + "/")}


# ------------------------------------------------------------ moe_ffn


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"data{g[0]}_expert{g[1]}")
def test_moe_ffn_routes_the_global_batch(four_ranks, grid):
    """Every rank's kept mask, output rows and aux equal JAX's global
    ``moe_ffn`` at a capacity where tokens drop (per-rank routing at the
    rank's own capacity keeps other tokens); its input gradient and the
    data group's summed parameter gradients equal JAX's."""
    ranks, _, ffn, _ = four_ranks
    dp, k = grid
    want = ffn[dp]
    assert 0 < want["kept"].sum() < want["kept"].size  # tokens drop
    tag = f"ffn_{dp}x{k}"
    rows = S_ROWS // dp
    for r, res in enumerate(ranks):
        d, j = divmod(r, k)
        got = _case(res, tag)
        sl = slice(d * rows * S_T, (d + 1) * rows * S_T)
        np.testing.assert_array_equal(got["kept"], want["kept"][sl])
        np.testing.assert_allclose(got["out"],
                                   want["out"][d * rows:(d + 1) * rows],
                                   atol=2e-5, rtol=0)
        np.testing.assert_allclose(got["aux"], want["aux"], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(got["dx"],
                                   want["dx"][d * rows:(d + 1) * rows],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(got["drouter"], want["drouter"],
                                   atol=1e-4, rtol=0)
        e = E_MOE // k
        for n in ("wi", "wo"):
            np.testing.assert_allclose(got["d" + n],
                                       want["d" + n][j * e:(j + 1) * e],
                                       atol=1e-4, rtol=0, err_msg=n)


def test_each_rank_stores_its_experts(four_ranks):
    """``attach_expert_mesh`` at (data 2, expert 2): rank j keeps experts
    [2j, 2j + 2) of every ``wi``/``wo`` as contiguous leaves, the router
    and every other leaf whole; gathering gives JAX's leaves back bit for
    bit, and so does ``detach_expert_mesh``."""
    ranks, _, _, inputs = four_ranks
    weights = {k[3:]: v for k, v in inputs.items() if k.startswith("lm/")}
    for r, res in enumerate(ranks):
        j = r % 2
        held = _case(res, "shards")
        assert int(held.pop("n")) == LM["depth"]
        for name, w in weights.items():
            leaf = name.rsplit(".", 1)[-1]
            moe = leaf in ("wi", "wo") and w.ndim == 3
            want = w[j * 2:(j + 1) * 2] if moe else w
            np.testing.assert_array_equal(held[name], want, err_msg=name)
            np.testing.assert_array_equal(_case(res, "whole")[name], w)
            np.testing.assert_array_equal(_case(res, "detached")[name], w)


# ------------------------------------------------------------ the trainer


def _assert_matches_jax(ranks, jax_run, tag, mesh):
    """Every rank's losses and returned (whole) weights against JAX's."""
    jlosses, jparams = jax_run
    for r, res in enumerate(ranks):
        port = _case(res, tag)
        assert list(port.pop("mesh")) == mesh
        np.testing.assert_allclose(port["loss"], jlosses, rtol=1e-4,
                                   err_msg=f"{tag} rank {r}")
        for name, v in jparams.items():
            np.testing.assert_allclose(port[name], v, atol=1e-4, rtol=0,
                                       err_msg=f"{tag} rank {r} {name}")


@pytest.mark.parametrize("tag", [r[0] for r in RUNS[4]])
def test_grid_trainer_matches_jax(four_ranks, tag):
    """``expert_parallel=2`` under Adam and under SGD with a large aux
    weight, and ``model_parallel=2`` on the MoE LM, at JAX's (data 2, k 2)
    grids, the routing global over the data group."""
    ranks, trained, _, _ = four_ranks
    want_mesh = [2, 0, 0]
    want_mesh[1 if tag.startswith("ep") else 2] = 2
    _assert_matches_jax(ranks, trained[tag], tag, want_mesh)


@pytest.mark.parametrize("tag", [r[0] for r in RUNS[2]])
def test_pure_data_parallel_matches_jax(two_ranks, tag):
    """Pure data parallelism over two ranks routes the global batch, as
    JAX's ``SynchronousDistributedTrainer(num_workers=2)`` does."""
    ranks, trained, _, _ = two_ranks
    _assert_matches_jax(ranks, trained[tag], tag, [2, 0, 0])


def _jax_accum_routes(inputs, accum=2):
    """JAX's routing of the first step's global accumulation microbatches
    at the initial weights: per (microbatch, MoE layer), in the port's
    call order, each token's expert and whether it is kept. The first
    global batch is JAX's shuffled rows ``[0, 2 * batch_size)``, and
    microbatch j its rows ``[j * B/accum, (j + 1) * B/accum)``."""
    import jax.numpy as jnp
    from distkeras_tpu.data.dataset import Dataset as JDataset
    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.parallel.expert_parallel import switch_route

    jm = jzoo.moe_transformer_lm(**LM, seed=0)
    ds = JDataset({"features": inputs["tokens"]}).shuffle(LM_TRAIN["seed"])
    batch = np.asarray(ds["features"])[: 2 * LM_TRAIN["batch_size"]]
    out = []
    for mb in np.split(batch, accum):
        x = jnp.asarray(mb)
        for i, layer in enumerate(jm.layers):
            if "router" in jm.params[str(i)]:
                logits = x.reshape(-1, x.shape[-1]) @ jm.params[str(i)][
                    "router"]
                cap = max(1, int(layer.capacity_factor * logits.shape[0]
                                 / logits.shape[1]))
                dispatch, _, _ = switch_route(logits, cap)
                out.append((np.asarray(jnp.argmax(logits, -1)),
                            np.asarray(dispatch.sum(axis=(1, 2))) > 0))
            x, _ = layer.apply(jm.params[str(i)], jm.state[str(i)], x)
    return out


def test_accumulation_routes_jax_microbatches(two_ranks):
    """``accum_steps=2`` under a data group of 2: each rank's part of each
    accumulation microbatch is its rows of JAX's GLOBAL microbatch, so the
    first step routes every token as JAX does (the same expert, the same
    capacity drops) in both MoE layers of both microbatches, and the
    losses stay within 1e-5 relative of JAX's 2-worker trainer. Splitting
    each rank's own rows instead routes other token sets."""
    ranks, trained, _, inputs = two_ranks
    want = _jax_accum_routes(inputs)
    t = LM["seq_len"]
    for r, res in enumerate(ranks):
        for i, (widx, wkept) in enumerate(want):
            n = widx.size // 2  # rank r's tokens of the microbatch
            np.testing.assert_array_equal(res[f"route/{i}/idx"],
                                          widx[r * n:(r + 1) * n],
                                          err_msg=f"rank {r} call {i}")
            np.testing.assert_array_equal(res[f"route/{i}/kept"],
                                          wkept[r * n:(r + 1) * n],
                                          err_msg=f"rank {r} call {i}")
        assert n == LM_TRAIN["batch_size"] // 2 * t
        np.testing.assert_allclose(_case(res, "dp_accum")["loss"],
                                   trained["dp_accum"][0], rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_end_bit_equal(request, world):
    ranks = request.getfixturevalue(
        {2: "two_ranks", 4: "four_ranks"}[world])[0]
    for other in ranks[1:]:
        for k in ranks[0]:
            if not k.startswith(("ffn_", "shards/", "route/")):
                np.testing.assert_array_equal(other[k], ranks[0][k],
                                              err_msg=k)


def test_expert_checkpoint_resumes_straight_trajectory(four_ranks):
    """One epoch under ``expert_parallel=2`` and its checkpoint (whole
    experts and Adam moments, rank 0 writes), then a resumed second epoch
    on every rank (re-sharded): bit for bit two epochs straight."""
    ranks, _, _, _ = four_ranks
    straight = _case(ranks[0], "straight")
    first, resumed = _case(ranks[0], "first"), _case(ranks[0], "resumed")
    half = len(straight["loss"]) // 2
    np.testing.assert_array_equal(first["loss"], straight["loss"][:half])
    np.testing.assert_array_equal(resumed["loss"], straight["loss"][half:])
    for k in straight:
        if k not in ("loss", "mesh"):
            np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)


# ------------------------------------------------------- one process


def _fake_grid(k=2, axis="expert"):
    """A (1, k) grid whose groups run no collective: enough to construct
    a trainer in one process."""
    cpu = torch.device("cpu")
    return tmesh.GridMesh(("data", axis), tmesh.DataMesh(1, 0, None, cpu),
                          tmesh.DataMesh(k, 1, None, cpu),
                          tmesh.DataMesh(k, 1, None, cpu))


def test_moe_group_rules_match_jax():
    from distkeras_tpu.parallel import expert_parallel as jep

    for node in ({"router": 1, "wi": 2, "wo": 3}, {"wq": 1, "wo": 2},
                 {"router": 1, "wi": 2}, [1, 2], None):
        assert tep.is_moe_group(node) == jep.is_moe_group(node)
    want = {k: tuple(v) for k, v in jep.moe_group_specs("model").items()}
    got = tep.moe_group_specs("model")
    assert {k: tuple(v) for k, v in got.items()} == want
    assert all(type(v).__name__ == "PartitionSpec" for v in got.values())


def test_shard_moe_params_only_touches_moe_groups():
    """Structural identification: the attention output projection is also
    named ``wo`` and stays whole; only leaves inside a {router, wi, wo}
    group are cut, to rank 1's contiguous half; an unknown container
    raises JAX's ``TypeError``."""
    m = zoo.moe_transformer_lm(**LM, device="cpu")
    tree = {}
    for name, p in m.state_dict().items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p
    placed = tep.shard_moe_params(tree, _fake_grid())
    assert placed["1"]["mhsa"]["wo"] is tree["1"]["mhsa"]["wo"]
    for i in ("2", "4"):
        assert placed[i]["router"] is tree[i]["router"]
        for n in ("wi", "wo"):
            whole = tree[i][n]
            np.testing.assert_array_equal(placed[i][n].numpy(),
                                          whole[2:].numpy())
            assert placed[i][n].is_contiguous()
    with pytest.raises(TypeError, match="container set"):
        tep.shard_moe_params({"a": {1, 2}}, _fake_grid())


def test_attach_rejects_indivisible_experts_before_changing_a_layer():
    m = zoo.moe_transformer_lm(61, 32, 32, 2, 2, num_experts=3,
                               device="cpu")
    before = {k: v.clone() for k, v in m.state_dict().items()}
    with pytest.raises(ValueError, match="num_experts=3 is not divisible by "
                                         "mesh axis expert=2"):
        tep.attach_expert_mesh(m, _fake_grid())
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(getattr(l, "expert_group", None) is None for l in m.modules())


def test_bad_expert_parallel_configs_rejected():
    moe = zoo.moe_transformer_lm(61, 32, 32, 2, 1, num_experts=2,
                                 device="cpu")
    kw = dict(loss="next_token_crossentropy", device="cpu")
    with pytest.raises(ValueError, match="expert_parallel=2 does not divide"):
        SynchronousDistributedTrainer(moe, expert_parallel=2, **kw)
    with pytest.raises(ValueError, match="'expert' axis of size 2"):
        SynchronousDistributedTrainer(moe, mesh=_fake_grid(axis="model"),
                                      expert_parallel=2, **kw)
    with pytest.raises(ValueError, match="ZeRO-1"):
        SynchronousDistributedTrainer(moe, expert_parallel=2,
                                      shard_opt_state=True, **kw)
    with pytest.raises(ValueError, match="trust ratio"):
        SynchronousDistributedTrainer(moe, "lamb", mesh=_fake_grid(),
                                      expert_parallel=2, **kw)
    t = SynchronousDistributedTrainer(moe, mesh=_fake_grid(),
                                      expert_parallel=2, **kw)
    assert t.mesh.shape == {"data": 1, "expert": 2} and t.num_workers == 1


def test_expert_parallel_rejects_moe_free_model():
    from distkeras_tpu_torch.data.dataset import Dataset

    m = zoo.mnist_mlp(hidden=16, device="cpu")
    t = SynchronousDistributedTrainer(m, "sgd", batch_size=8,
                                      label_col="label_onehot",
                                      mesh=_fake_grid(), expert_parallel=2,
                                      device="cpu")
    data = Dataset({"features": np.zeros((16, 784), np.float32),
                    "label_onehot": np.zeros((16, 10), np.float32)})
    with pytest.raises(ValueError, match="MoE"):
        t.train(data)
