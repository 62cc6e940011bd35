"""The port's sequence parallelism vs the JAX package on the CPU.

``ring_attention``, ``ulysses_attention`` and ``SequenceParallelTrainer``
run one process per rank over ``torch.distributed``. Here the ranks are
gloo processes on the CPU, launched through ``Job.run_local`` (one
module-scoped launch per world size, 2 and 4); each rank writes its
results to an ``.npz`` that this process holds against JAX's functions and
trainer at the same mesh on the conftest's 8-device CPU mesh. Same inputs
(numpy, seeded) and bridged weights on both sides. Tolerances: attention
outputs 2e-5 and gradients 3e-4 absolute (``tests/test_ulysses.py``'s),
trainer losses 1e-4 relative and weights 1e-4 absolute
(``tests/test_torch_sync_dp.py``'s): f32, another summation order. The
MoE layer under a sequence group (and a data group beside it) routes the
global tokens in JAX's order: its output 2e-5 and its gradients 3e-4
absolute, its load-balance loss 1e-6 (``tests/test_torch_moe.py``'s
routing bar), and which tokens the capacity keeps exactly.
"""

import socket
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import SequenceParallelTrainer, zoo
from distkeras_tpu_torch.job_deployment import Job
from distkeras_tpu_torch.parallel import mesh as tmesh
from distkeras_tpu_torch.parallel.ring_attention import shard_sequence
from distkeras_tpu_torch.parallel.ulysses import ulysses_attention

torch.set_num_threads(2)

#: every launch joins within this many seconds or fails
LAUNCH_TIMEOUT = 110
B, T, H, D = 2, 32, 4, 8  # attention inputs; H divides by 4 (Ulysses)
BLOCK = 8  # Ulysses' blockwise inner block: T > BLOCK, so it really loops
CLS = dict(vocab_size=16, seq_len=64, d_model=32, num_heads=2, depth=2)
LMC = dict(vocab_size=16, seq_len=64, d_model=32, num_heads=4, depth=2)
CLS_TRAIN = dict(loss="categorical_crossentropy", batch_size=32,
                 num_epoch=1, label_col="label_onehot", seed=0, window=2)
MOE = dict(vocab_size=16, seq_len=16, d_model=16, num_heads=2, depth=1,
           num_experts=2)
MOE_TRAIN = dict(loss="categorical_crossentropy", batch_size=16,
                 num_epoch=1, label_col="label_onehot", seed=0, window=2)
#: the MoE capacity factor of the "moe_drop" runs and of the layer
#: checks: tight enough that the capacity drops tokens, so which ones
#: it keeps is decided by the global order
TIGHT = 0.75
#: the layer checks: (rows, tokens, features, experts, hidden) of the
#: global batch, and the (data, seq) grids per world size
FFN = (4, 16, 8, 4, 16)
FFN_GRIDS = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
#: ``accuracy`` on the LM's logits scores each position against its own
#: token; under a sequence group each rank scores its tokens of the ids
LM_TRAIN = dict(loss="next_token_crossentropy", batch_size=16, num_epoch=1,
                metrics=["next_token_accuracy", "accuracy"], seed=0,
                window=2)
#: (tag, model, sp_mode, data_parallel, optimizer) of each trainer run,
#: per world size; plain SGD shows a gradient off by a constant factor,
#: which Adam's normalization would hide
RUNS = {
    2: [("cls_ring", "cls", "ring", 1, "adam"),
        ("cls_ulysses", "cls", "ulysses", 1, "adam"),
        ("lm_ring", "lm", "ring", 1, "adam"),
        ("lm_ulysses", "lm", "ulysses", 1, "adam"),
        ("cls_sgd", "cls", "ring", 1, "sgd"),
        ("lm_sgd", "lm", "ulysses", 1, "sgd"),
        ("moe_ring", "moe", "ring", 1, "adam"),
        ("moe_drop", "moe_drop", "ulysses", 1, "adam")],
    4: [("cls_ring", "cls", "ring", 1, "adam"),
        ("lm_ulysses", "lm", "ulysses", 1, "adam"),
        ("cls_2d", "cls", "ring", 2, "adam"),
        ("lm_2d", "lm", "ulysses", 2, "sgd"),
        ("moe_2d", "moe_drop", "ring", 2, "adam")],
}
ATTENTION = [("ring", "dense"), ("ulysses", "dense"),
             ("ulysses", "blockwise")]
#: runs that also evaluate per-epoch validation_data: the first VAL_ROWS
#: rows of their data, a ragged last batch included
VALIDATED = {"cls_ring": 48, "lm_ulysses": 24}

_RANK_SCRIPT = textwrap.dedent(
    """
    import sys

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from distkeras_tpu_torch.parallel import multihost

    assert multihost.initialize(device="cpu", timeout=60)
    from distkeras_tpu_torch import SequenceParallelTrainer, zoo
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.models.layers import MultiHeadSelfAttention
    from distkeras_tpu_torch.models.sequential import Sequential, walk_layers
    from distkeras_tpu_torch.ops import fused_layernorm as tln
    from distkeras_tpu_torch.parallel import expert_parallel as ep
    from distkeras_tpu_torch.parallel.mesh import (
        attach_data_group, attach_seq_group, make_grid, rank_rows)
    from distkeras_tpu_torch.parallel.ring_attention import (
        ring_attention, shard_sequence)
    from distkeras_tpu_torch.parallel.ulysses import ulysses_attention
    from distkeras_tpu_torch.utils.convert import params_from_jax

    inputs = np.load(sys.argv[1])
    out_dir = sys.argv[2]
    rank = multihost.process_id()
    world = multihost.num_processes()
    results = {}

    def whole(prefix):
        return {k[len(prefix):]: inputs[k] for k in inputs.files
                if k.startswith(prefix)}

    # the attention functions: this rank's blocks of q, k, v and of the
    # upstream gradient, its block of the output and its q/k/v gradients
    seq = make_grid(1, world, "seq", device="cpu", data_axis=False)
    for mode, inner in ATTENTION:
        for causal in (False, True):
            q, k, v = (shard_sequence(torch.from_numpy(inputs[n]), seq)
                       .clone().requires_grad_() for n in "qkv")
            g = shard_sequence(torch.from_numpy(inputs["g"]), seq)
            if mode == "ring":
                out = ring_attention(q, k, v, seq, causal=causal)
            else:
                out = ulysses_attention(q, k, v, seq, causal=causal,
                                        inner=inner, inner_block_size=BLOCK)
            (out * g).sum().backward()
            tag = f"attn/{mode}_{inner}_{causal}/"
            for name, t in (("out", out), ("dq", q.grad), ("dk", k.grad),
                            ("dv", v.grad)):
                results[tag + name] = t.detach().numpy()

    # the MoE layer on the rank's rows and tokens under its groups: its
    # output, load-balance loss and input gradient, which tokens the
    # capacity keeps, and its weights' gradients summed over every rank
    rows_n, t_n, d_n, e_n, h_n = FFN
    for dp, sp in FFN_GRIDS[world]:
        grid = make_grid(dp, sp, "seq", device="cpu", data_axis=dp > 1)
        t_loc = t_n // sp

        def piece(a):
            a = rank_rows(a, grid.data)
            lo = grid.inner.rank * t_loc
            return torch.from_numpy(a[:, lo:lo + t_loc].copy())

        m = Sequential([ep.MoE(e_n, hidden_ratio=h_n // d_n,
                               capacity_factor=TIGHT)])
        m.build((t_n, d_n), device="cpu")
        layer = m.layers[0]
        with torch.no_grad():
            for n in ("router", "wi", "wo"):
                getattr(layer, n).copy_(torch.from_numpy(inputs["ffn/" + n]))
        attach_data_group(m, grid.data)
        assert attach_seq_group(m, grid.inner) == 1
        x = piece(inputs["ffn/x"]).requires_grad_()
        y = m(x)
        # each rank's loss carries the global aux over the world size, so
        # the ranks' gradients sum to the global loss's
        ((y * piece(inputs["ffn/g"])).sum()
         + layer.take_aux_loss() / world).backward()
        logits = x.detach().reshape(-1, d_n) @ layer.router.detach()
        _, pos, _, cap, _ = ep.route_global(
            logits, TIGHT, ep._live(grid.data), seq=grid.inner,
            rows=x.shape[0])
        tag = f"ffn_{dp}x{sp}/"
        results[tag + "kept"] = (pos < cap).reshape(x.shape[:2]).numpy()
        results[tag + "out"] = y.detach().numpy()
        results[tag + "aux"] = layer.aux_loss.numpy()
        results[tag + "dx"] = x.grad.numpy()
        for n in ("router", "wi", "wo"):
            results[tag + "d" + n] = grid.world.all_reduce_(
                getattr(layer, n).grad).numpy()
        grid.release()

    def model(kind):
        if kind == "cls":
            m = zoo.transformer_classifier(**CLS, device="cpu")
        elif kind.startswith("moe"):
            m = zoo.moe_transformer_classifier(**MOE, device="cpu")
            for layer in walk_layers(m):
                if isinstance(layer, ep.MoE) and kind == "moe_drop":
                    layer.capacity_factor = TIGHT
            kind = "moe"
        else:
            m = zoo.transformer_lm(**LMC, device="cpu")
        params_from_jax(m, whole(kind + "/"))
        tln.attach_fused_layernorm(m)
        return m

    def hooks(m):
        return [l.attention_fn for l in m.modules()
                if isinstance(l, MultiHeadSelfAttention)]

    cls_data = Dataset({"features": inputs["cls_x"],
                        "label_onehot": inputs["cls_y"]})
    lm_data = Dataset({"features": inputs["lm_x"], "label": inputs["lm_x"]})
    moe_data = Dataset({"features": inputs["moe_x"],
                        "label_onehot": inputs["moe_y"]})
    for tag, kind, mode, dp, opt in RUNS[world]:
        m = model(kind)
        data = {"cls": cls_data, "lm": lm_data}.get(kind, moe_data)
        kw = dict({"cls": CLS_TRAIN, "lm": LM_TRAIN}.get(kind, MOE_TRAIN))
        rows = VALIDATED.get(tag) if world == 2 else None
        if rows:
            kw["validation_data"] = data.take(rows)
        t = SequenceParallelTrainer(m, opt, sp_mode=mode,
                                    data_parallel=dp, device="cpu", **kw)
        assert t.num_workers == world
        res = t.train(data, shuffle=True)
        assert all(h is None for h in hooks(m) + hooks(res)), tag
        assert all(getattr(l, "seq_group", None) is None
                   for l in res.modules())
        results[tag + "/mesh"] = np.array(
            [t.mesh.shape.get("data", 0), t.mesh.shape["seq"]])
        hist = t.get_history()
        results[tag + "/loss"] = np.array([h["loss"] for h in hist])
        results[tag + "/hist_keys"] = np.array(sorted(hist[0]))
        results[tag + "/hist"] = np.array(
            [[h[k] for k in sorted(h)] for h in hist])
        if rows:
            hist = t.get_validation_history()
            results[tag + "/val"] = np.array(
                [[v[k] for k in sorted(v)] for v in hist])
            results[tag + "/val_keys"] = np.array(sorted(hist[0]))
        for name, p in res.state_dict().items():
            results[tag + "/" + name] = p.numpy()
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
        ("ATTENTION", ATTENTION), ("BLOCK", BLOCK), ("CLS", CLS),
        ("LMC", LMC), ("CLS_TRAIN", CLS_TRAIN), ("LM_TRAIN", LM_TRAIN),
        ("MOE", MOE), ("MOE_TRAIN", MOE_TRAIN), ("TIGHT", TIGHT),
        ("FFN", FFN), ("FFN_GRIDS", FFN_GRIDS), ("RUNS", RUNS),
        ("VALIDATED", VALIDATED)))
    script.write_text(consts + _RANK_SCRIPT)
    np.savez(tmp_path / "inputs.npz", **inputs)
    out = tmp_path / "out"
    out.mkdir()
    job = Job(str(script), num_hosts=n,
              coordinator_address=f"127.0.0.1:{_free_port()}",
              script_args=[str(tmp_path / "inputs.npz"), str(out)],
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
    from distkeras_tpu.data import loaders as jloaders
    from distkeras_tpu.data.transformers import OneHotTransformer
    from distkeras_tpu.models import zoo as jzoo

    rng = np.random.default_rng(0)
    out = {n: rng.standard_normal((B, T, H, D)).astype(np.float32)
           for n in "qkvg"}
    ds = jloaders.synthetic_sequences(n=128, seq_len=64, vocab=16, seed=0)
    ds = OneHotTransformer(2, output_col="label_onehot").transform(ds)
    out["cls_x"] = np.asarray(ds["features"], np.int32)
    out["cls_y"] = np.asarray(ds["label_onehot"], np.float32)
    starts = np.random.default_rng(4).integers(0, 16, 64)
    out["lm_x"] = ((starts[:, None] + np.arange(64)[None, :]) % 16).astype(
        np.int32)
    moe = jloaders.synthetic_sequences(n=64, seq_len=16, vocab=16, seed=0)
    moe = OneHotTransformer(2, output_col="label_onehot").transform(moe)
    out["moe_x"] = np.asarray(moe["features"], np.int32)
    out["moe_y"] = np.asarray(moe["label_onehot"], np.float32)
    for kind, jm in (("cls", jzoo.transformer_classifier(**CLS, seed=0)),
                     ("lm", jzoo.transformer_lm(**LMC, seed=0)),
                     ("moe", jzoo.moe_transformer_classifier(**MOE, seed=0))):
        out.update({f"{kind}/{k}": v for k, v in _flat_jax(jm.params).items()})
    rows, t, d, e, h = FFN
    ffn = np.random.default_rng(5)
    out["ffn/router"] = ffn.standard_normal((d, e)).astype(np.float32)
    out["ffn/wi"] = (0.3 * ffn.standard_normal((e, d, h))).astype(np.float32)
    out["ffn/wo"] = (0.3 * ffn.standard_normal((e, h, d))).astype(np.float32)
    out["ffn/x"] = ffn.standard_normal((rows, t, d)).astype(np.float32)
    out["ffn/g"] = ffn.standard_normal((rows, t, d)).astype(np.float32)
    return out


def _jax_ffn(inputs):
    """JAX's MoE layer on the global batch at ``TIGHT``: which tokens the
    capacity keeps, the output, the load-balance loss and the gradients of
    sum((x + out) * g) + aux."""
    import jax
    import jax.numpy as jnp
    from distkeras_tpu.parallel import expert_parallel as jep

    p = {n: jnp.asarray(inputs["ffn/" + n]) for n in ("router", "wi", "wo")}
    x, g = jnp.asarray(inputs["ffn/x"]), jnp.asarray(inputs["ffn/g"])

    def loss(p, x):
        o, a = jep.moe_ffn(p, x, capacity_factor=TIGHT)
        return jnp.sum((x + o) * g) + a, (x + o, a)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, x)
    rows, t, d, e, _ = FFN
    capacity = max(1, int(TIGHT * rows * t / e))
    logits = x.reshape(-1, d) @ p["router"]
    dispatch, _, _ = jep.switch_route(logits, capacity)
    return {"kept": np.asarray(dispatch.sum(axis=(1, 2)) > 0).reshape(
                rows, t),
            "out": np.asarray(y), "aux": np.asarray(aux), "dx": np.asarray(gx),
            **{"d" + n: np.asarray(v) for n, v in gp.items()}}


def _jax_attention(inputs, n, mode, inner, causal):
    """JAX's output and q/k/v gradients of sum(out * g) on an n-way
    ("seq",) mesh."""
    import jax
    from jax.sharding import Mesh
    from distkeras_tpu.parallel.ring_attention import ring_attention
    from distkeras_tpu.parallel.ulysses import ulysses_attention as jul

    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))

    def fn(q, k, v):
        if mode == "ring":
            return ring_attention(q, k, v, mesh, causal=causal)
        return jul(q, k, v, mesh, causal=causal, inner=inner,
                   inner_block_size=BLOCK)

    @jax.jit
    def out_and_grads(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(g)

    out, grads = out_and_grads(*(inputs[c] for c in "qkvg"))
    return {"out": np.asarray(out), **{f"d{c}": np.asarray(x)
                                       for c, x in zip("qkv", grads)}}


def _jax_train(inputs, kind, mode, n, dp, opt, val_rows=None):
    from distkeras_tpu.data.dataset import Dataset as JDataset
    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.models.sequential import walk_layers
    from distkeras_tpu.parallel.expert_parallel import MoE as JMoE
    from distkeras_tpu.trainers import SequenceParallelTrainer as JSP

    if kind == "cls":
        jm = jzoo.transformer_classifier(**CLS, seed=0)
        data = JDataset({"features": inputs["cls_x"],
                         "label_onehot": inputs["cls_y"]})
        kw = CLS_TRAIN
    elif kind.startswith("moe"):
        jm = jzoo.moe_transformer_classifier(**MOE, seed=0)
        for layer in walk_layers(jm):
            if isinstance(layer, JMoE) and kind == "moe_drop":
                layer.capacity_factor = TIGHT
        data = JDataset({"features": inputs["moe_x"],
                         "label_onehot": inputs["moe_y"]})
        kw = MOE_TRAIN
    else:
        jm = jzoo.transformer_lm(**LMC, seed=0)
        data = JDataset({"features": inputs["lm_x"], "label": inputs["lm_x"]})
        kw = LM_TRAIN
    mesh = dict(data_parallel=dp) if dp > 1 else dict(num_workers=n)
    if val_rows:
        kw = dict(kw, validation_data=data.take(val_rows))
    t = JSP(jm, opt, sp_mode=mode, **mesh, **kw)
    res = t.train(data, shuffle=True)
    return t.get_history(), res, t.get_validation_history()


def _world(tmp_path_factory, n):
    inputs = _inputs()
    ranks = _launch(tmp_path_factory.mktemp(f"sp{n}"), n, inputs)
    attention = {(mode, inner, causal): _jax_attention(inputs, n, mode,
                                                       inner, causal)
                 for mode, inner in ATTENTION for causal in (False, True)}
    trained = {tag: _jax_train(inputs, kind, mode, n, dp, opt,
                               VALIDATED.get(tag) if n == 2 else None)
               for tag, kind, mode, dp, opt in RUNS[n]}
    trained["ffn"] = _jax_ffn(inputs)
    return ranks, attention, trained


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


# ------------------------------------------------------------ attention


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode,inner", ATTENTION)
def test_attention_matches_jax(world, mode, inner, causal):
    """Each rank's block of the output and its q/k/v gradients, put back
    together along the sequence, are JAX's (the ring's backward sends dK
    and dV back around it; Ulysses' is the reverse all-to-all)."""
    ranks, attention, _ = world
    want = attention[(mode, inner, causal)]
    tag = f"attn/{mode}_{inner}_{causal}"
    for name, ref in want.items():
        got = np.concatenate([_case(r, tag)[name] for r in ranks], axis=1)
        atol = 2e-5 if name == "out" else 3e-4
        np.testing.assert_allclose(got, ref, atol=atol, rtol=0,
                                   err_msg=f"{tag} {name}")


# ------------------------------------------------------------ the trainer


def test_trainer_matches_jax(world):
    """Every run of the launch (the classifier and the causal LM, ring and
    Ulysses, Adam and plain SGD, a (data 2, seq 2) grid at 4 ranks)
    against JAX's ``SequenceParallelTrainer`` at the same mesh: the
    losses, every recorded metric (the LM's ``next_token_accuracy`` and
    ``accuracy``, the classifier's ``accuracy``) and the weights."""
    ranks, _, trained = world
    n = len(ranks)
    for tag, kind, mode, dp, _ in RUNS[n]:
        port = _case(ranks[0], tag)
        want_mesh = [dp, n // dp] if dp > 1 else [0, n]
        assert list(port.pop("mesh")) == want_mesh, tag
        jhist, jres, _ = trained[tag]
        port.pop("val", None)
        port.pop("val_keys", None)
        np.testing.assert_allclose(port["loss"], [h["loss"] for h in jhist],
                                   rtol=1e-4, err_msg=tag)
        keys = sorted(jhist[0])
        assert list(port["hist_keys"]) == keys, tag
        if kind == "lm":
            assert "accuracy" in keys, tag
        np.testing.assert_allclose(port["hist"],
                                   [[h[k] for k in keys] for h in jhist],
                                   rtol=1e-4, err_msg=f"{tag} {keys}")
        for name, v in _flat_jax(jres.params).items():
            np.testing.assert_allclose(port[name], v, atol=1e-4, rtol=0,
                                       err_msg=f"{tag} {name}")


@pytest.mark.parametrize("tag", sorted(VALIDATED))
def test_validation_history_matches_jax(two_ranks, tag):
    """Per-epoch ``validation_data`` (a ragged last batch included), ring
    and Ulysses at seq 2: every rank records JAX's ``val_*`` metrics."""
    ranks, _, trained = two_ranks
    want = trained[tag][2]
    assert len(want) == 1
    names = sorted(want[0])
    for res in ranks:
        got = _case(res, tag)
        assert list(got["val_keys"]) == names
        np.testing.assert_allclose(
            got["val"], [[v[k] for k in names] for v in want], rtol=1e-4,
            err_msg=tag)


def test_moe_layer_routes_the_global_tokens(world):
    """An MoE under a sequence group (beside a data group at 2 x 2) routes
    the global batch in JAX's flatten order, which interleaves the
    sequence ranks within each row: with a capacity that drops tokens,
    each rank keeps exactly JAX's tokens of its piece, and its output, the
    load-balance loss and the gradients are JAX's."""
    ranks, _, trained = world
    want = trained["ffn"]
    n = len(ranks)
    rows, t = FFN[:2]
    assert not want["kept"].all() and want["kept"].any()
    for dp, sp in FFN_GRIDS[n]:
        tag = f"ffn_{dp}x{sp}"
        for name in ("kept", "out", "dx"):
            got = np.concatenate([
                np.concatenate([_case(ranks[d * sp + j], tag)[name]
                                for j in range(sp)], axis=1)
                for d in range(dp)])
            assert got.shape[:2] == (rows, t), (tag, name)
            if name == "kept":
                np.testing.assert_array_equal(got, want[name], err_msg=tag)
            else:
                np.testing.assert_allclose(
                    got, want[name], atol=2e-5 if name == "out" else 3e-4,
                    rtol=0, err_msg=f"{tag} {name}")
        for res in ranks:
            got = _case(res, tag)
            assert abs(float(got["aux"]) - float(want["aux"])) <= 1e-6, tag
            for name in ("drouter", "dwi", "dwo"):
                np.testing.assert_allclose(got[name], want[name], atol=3e-4,
                                           rtol=0, err_msg=f"{tag} {name}")


#: result keys that hold the rank's own piece of a global array
PER_RANK = ("attn/", "ffn_")


def test_ranks_end_bit_equal(world):
    ranks, _, _ = world
    for other in ranks[1:]:
        for k in ranks[0]:
            if not k.startswith(PER_RANK):
                np.testing.assert_array_equal(other[k], ranks[0][k],
                                              err_msg=k)


# ------------------------------------------------------- one process


def test_one_rank_is_dense_and_detaches_hooks():
    """A group of one: the ring over one rank is the model's own forward;
    training leaves neither the caller's model nor the result with a
    hook (the JAX trainer detaches both)."""
    from distkeras_tpu_torch import SingleTrainer
    from distkeras_tpu_torch.data.dataset import Dataset
    from distkeras_tpu_torch.models.layers import MultiHeadSelfAttention
    from distkeras_tpu_torch.ops.flash_attention import attach_flash_attention

    x = np.random.default_rng(1).integers(0, 16, (32, 64)).astype(np.int32)
    data = Dataset({"features": x, "label": x})

    def hooks(m):
        return [l.attention_fn for l in m.modules()
                if isinstance(l, MultiHeadSelfAttention)]

    runs = []
    for cls, kw in ((SingleTrainer, {}), (SequenceParallelTrainer,
                                          {"sp_mode": "ring"})):
        m = zoo.transformer_lm(**LMC, device="cpu")
        attach_flash_attention(m)
        t = cls(m, "adam", device="cpu", **LM_TRAIN, **kw)
        res = t.train(data)
        runs.append(([h["loss"] for h in t.get_history()], res))
        if cls is SequenceParallelTrainer:
            assert t.mesh.shape == {"seq": 1}
            assert all(h is None for h in hooks(m) + hooks(res))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5)
    for a, b in zip(runs[0][1].parameters(), runs[1][1].parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   atol=1e-5, rtol=0)


def _seq_group(n, rank=0):
    return tmesh.DataMesh(n, rank, None, torch.device("cpu"))


def test_seq_group_takes_moe_and_refuses_batchnorm():
    """``attach_seq_group`` gives an MoE the group (its routing goes
    global) and still refuses a BatchNorm, whose statistics under JAX's
    sequence-parallel trainer are not a result to port to."""
    from distkeras_tpu_torch.models.layers import BatchNorm, Dense
    from distkeras_tpu_torch.models.sequential import Sequential

    m = zoo.moe_transformer_classifier(**MOE, device="cpu")
    group = _seq_group(2)
    # Embedding, the block (its residual dropout), the MoE and the pool
    assert tmesh.attach_seq_group(m, group) == 4
    moe = [l for l in m.modules() if type(l).__name__ == "MoE"]
    assert [l.seq_group for l in moe] == [group]
    tmesh.detach_seq_group(m)
    assert moe[0].seq_group is None
    bn = Sequential([Dense(4), BatchNorm()]).build((6,), device="cpu")
    with pytest.raises(NotImplementedError, match="BatchNorm under sequence"):
        tmesh.attach_seq_group(bn, group)


def test_next_token_loss_crosses_the_shard_boundary():
    """Rank r's last position predicts rank r+1's first token and only
    the last rank drops one: the ranks' losses and accuracies, averaged,
    are the whole sequence's."""
    from distkeras_tpu_torch.ops.losses import next_token_crossentropy
    from distkeras_tpu_torch.ops.metrics import next_token_accuracy

    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((3, 12, 7)).astype(
        np.float32))
    ids = torch.from_numpy(rng.integers(0, 7, (3, 12)))
    for fn in (next_token_crossentropy, next_token_accuracy):
        whole = fn(logits, ids)
        for n in (2, 3, 4):
            parts = [fn(shard_sequence(logits, _seq_group(n, r)), ids,
                        seq_group=_seq_group(n, r)) for r in range(n)]
            torch.testing.assert_close(torch.stack(parts).mean(), whole)


def test_token_accuracy_scores_the_ranks_tokens():
    """``accuracy`` on a causal LM's logits (the default metric) under a
    sequence group scores each rank's tokens of the whole ids, so the
    ranks' mean is JAX's ``accuracy`` of the whole sequence (its GSPMD
    run scores the global tokens); pooled outputs are scored as JAX
    scores them."""
    from distkeras_tpu.ops.metrics import accuracy as jax_accuracy

    from distkeras_tpu_torch.ops.losses import with_seq_group
    from distkeras_tpu_torch.ops.metrics import accuracy

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 12, 7)).astype(np.float32)
    ids = rng.integers(0, 7, (3, 12)).astype(np.int32)
    ids[:, ::2] = logits.argmax(-1)[:, ::2]  # some hits
    whole = float(jax_accuracy(logits, ids))
    assert 0 < whole < 1
    tl, ti = torch.from_numpy(logits), torch.from_numpy(ids)
    for n in (2, 3, 4):
        parts = [with_seq_group(accuracy, _seq_group(n, r))(
            shard_sequence(tl, _seq_group(n, r)), ti) for r in range(n)]
        np.testing.assert_allclose(float(torch.stack(parts).mean()), whole,
                                   rtol=1e-6, err_msg=f"seq {n}")
    pooled = logits[:, 0]
    fn = with_seq_group(accuracy, _seq_group(2, 1))
    for labels in (ids[:, 0], np.eye(7, dtype=np.float32)[ids[:, 0]]):
        np.testing.assert_allclose(
            float(fn(torch.from_numpy(pooled), torch.from_numpy(labels))),
            float(jax_accuracy(pooled, labels)), rtol=1e-6)


def test_dropout_keeps_the_ranks_tokens_of_the_global_mask():
    """Under a sequence group (and a data group beside it) each rank draws
    the global batch's mask and keeps its rows and tokens: the ranks'
    outputs put back together are one device's."""
    from distkeras_tpu_torch.models.layers import _dropout

    x = torch.randn(4, 12, 5)
    whole = _dropout(x, 0.3, 99)
    rows = []
    for d in range(2):
        toks = [_dropout(x[2 * d:2 * d + 2, 4 * s:4 * s + 4], 0.3, 99,
                         _seq_group(2, d), _seq_group(3, s))
                for s in range(3)]
        rows.append(torch.cat(toks, dim=1))
    assert torch.equal(torch.cat(rows), whole)


def test_validation_errors():
    m = zoo.transformer_classifier(**CLS, device="cpu")
    kw = dict(loss="categorical_crossentropy", label_col="label_onehot",
              device="cpu")
    with pytest.raises(ValueError, match="sp_mode"):
        SequenceParallelTrainer(m, "adam", sp_mode="megatron", **kw)
    with pytest.raises(ValueError, match="sp_inner"):
        SequenceParallelTrainer(m, "adam", sp_inner="flash", **kw)
    with pytest.raises(ValueError, match="has no 'seq' axis"):
        SequenceParallelTrainer(m, "adam", mesh=tmesh.make_mesh(device="cpu"),
                                **kw)
    seq_only = tmesh.make_grid(1, 1, "seq", device="cpu", data_axis=False)
    with pytest.raises(ValueError, match="conflicts with the supplied mesh"):
        SequenceParallelTrainer(m, "adam", mesh=seq_only, data_parallel=2,
                                **kw)
    with pytest.raises(ValueError, match="not divisible by data_parallel"):
        SequenceParallelTrainer(m, "adam", num_workers=3, data_parallel=2,
                                **kw)
    with pytest.raises(ValueError, match="processes"):
        SequenceParallelTrainer(m, "adam", num_workers=2, **kw)
    from distkeras_tpu_torch.data.dataset import Dataset

    x = np.zeros((8, 64), np.int32)
    y = np.zeros((8, 2), np.float32)
    # a 2-way seq group and a 2-way data group without collectives: the
    # batch and sequence checks run before anything is exchanged
    cpu = torch.device("cpu")
    grid = tmesh.GridMesh(("data", "seq"), _seq_group(2), _seq_group(2),
                          tmesh.DataMesh(4, 0, None, cpu))
    t = SequenceParallelTrainer(m, "adam", mesh=grid, batch_size=3, **kw)
    with pytest.raises(ValueError, match="not divisible by the 'data'"):
        t.train(Dataset({"features": x, "label_onehot": y}))
    odd = tmesh.GridMesh(("seq",), _seq_group(1), _seq_group(3),
                         _seq_group(3))
    t = SequenceParallelTrainer(m, "adam", mesh=odd, batch_size=4, **kw)
    with pytest.raises(ValueError, match="not divisible by the 'seq'"):
        t.train(Dataset({"features": x, "label_onehot": y}))
    mlp = SequenceParallelTrainer(zoo.mnist_mlp(hidden=8, device="cpu"),
                                  "adam", **kw)
    with pytest.raises(ValueError, match="MultiHeadSelfAttention"):
        mlp.train(Dataset({"features": np.zeros((8, 784), np.float32),
                           "label_onehot": np.zeros((8, 10), np.float32)}))
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        shard_sequence(torch.zeros(2, 6), _seq_group(4))
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="num_heads 2 not divisible by 4"):
        ulysses_attention(q, q, q, _seq_group(4))
    with pytest.raises(ValueError, match="inner must be"):
        ulysses_attention(q, q, q, _seq_group(2), inner="flash")
    t = SequenceParallelTrainer(m, "adam", validation_data=object(), **kw)
    assert t.supports_validation and t.validation_data is not None
