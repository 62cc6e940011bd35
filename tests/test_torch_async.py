"""The PyTorch port's asynchronous parameter-server tier vs the JAX package
on the CPU.

Same inputs (numpy, seeded) and bridged weights go through the JAX
trainers and their ports in ``mode="simulated"``, whose seeded numpy
schedule is the same in both packages, so the same pulls and commits
interleave in the same order. The JAX side runs its Pallas kernels as its
own tests run them here (interpret mode); the port runs its kernels' plain
versions, which is what CPU tensors get. Each test states its tolerance
and why.
"""

import functools
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import ADAG as JADAG
from distkeras_tpu import AEASGD as JAEASGD
from distkeras_tpu import DOWNPOUR as JDOWNPOUR
from distkeras_tpu import EAMSGD as JEAMSGD
from distkeras_tpu import DynSGD as JDynSGD
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu.data import loaders as jloaders
from distkeras_tpu.data import transformers as jtf
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.evaluators import AccuracyEvaluator as JAccuracy
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.ops import flash_attention as jfa
from distkeras_tpu.ops import fused_layernorm as jln
from distkeras_tpu.ops.pallas_kernels import FusedSGD as JFusedSGD
from distkeras_tpu.predictors import ModelPredictor as JPredictor
from distkeras_tpu_torch import (
    ADAG,
    AEASGD,
    DOWNPOUR,
    EAMSGD,
    AccuracyEvaluator,
    DynSGD,
    LossEvaluator,
    ModelPredictor,
    SingleTrainer,
    kernels,
    loaders,
    zoo,
)
from distkeras_tpu_torch import parameter_servers as tps
from distkeras_tpu_torch.data import transformers as ttf
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.ops import flash_attention as tfa
from distkeras_tpu_torch.ops import fused_layernorm as tln
from distkeras_tpu_torch.ops.pallas_kernels import FusedAdam, FusedSGD
from distkeras_tpu_torch.utils.convert import params_from_jax

sys.path.insert(0, str(Path(__file__).parent))
from test_pallas_kernels import make_tree  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ASYNC = dict(loss="categorical_crossentropy", learning_rate=0.02,
             batch_size=32, num_epoch=2, num_workers=4,
             communication_window=4, label_col="label_onehot",
             mode="simulated", seed=0)


@pytest.fixture(autouse=True)
def _uncached_jax_cores(monkeypatch):
    """The JAX trainers here build uncached cores (the package's
    ``DKT_DISABLE_CORE_CACHE`` switch): its process-wide ``WorkerCore``
    cache would otherwise keep these runs' cores, and a later JAX test of
    the same model and optimizer in this process would be handed one of
    them instead of a core around its own optimizer."""
    monkeypatch.setenv("DKT_DISABLE_CORE_CACHE", "1")


def _np(t):
    return t.detach().cpu().numpy()


def _jax_data(n=512):
    ds = jloaders.synthetic_mnist(n=n, seed=0)
    ds = jtf.MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    return jtf.OneHotTransformer(10, output_col="label_onehot").transform(ds)


def _port_data(n=512):
    ds = loaders.synthetic_mnist(n=n, seed=0)
    ds = ttf.MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    return ttf.OneHotTransformer(10, output_col="label_onehot").transform(ds)


def _mlps():
    jm = jzoo.mnist_mlp(hidden=16)
    tm = zoo.mnist_mlp(hidden=16, device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, jm.params))
    return jm, tm


# ------------------------------------------------------------- B1, B2


@pytest.mark.parametrize("mu,nesterov", [(0.0, False), (0.9, False),
                                         (0.9, True)],
                         ids=["sgd", "momentum", "nesterov"])
def test_sgd_plain_matches_jax_fused_sgd(mu, nesterov):
    """B1/B2's plain versions (the port's FusedSGD on CPU tensors) vs the
    JAX FusedSGD, 3 steps over ``make_tree``: a (130, 257) leaf takes
    JAX's Pallas kernel (interpret mode), the (257,) and (3, 5) leaves its
    jnp path. The jnp-path leaves agree bit for bit (the same f32
    operations in the same order). On the kernel path XLA:CPU fuses the
    interpreted kernel and contracts mu*m + g and p - lr*u into FMAs (one
    rounding where the port, like the JAX jnp path, rounds twice): at most
    a few ulps, so 4 ulps of the leaf's largest magnitude."""
    p0 = make_tree(0)
    grads = [make_tree(s) for s in (1, 2, 3)]
    jopt = JFusedSGD(0.05, momentum=mu, nesterov=nesterov)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    opt = FusedSGD(0.05, momentum=mu, nesterov=nesterov)
    tp = [torch.from_numpy(a.copy()) for a in jax.tree.leaves(p0)]
    tstate = opt.init(tp)
    assert tstate == () if mu == 0 else len(tstate) == 3
    for g in grads:
        jp, jstate = jopt.fused_apply(jp, jax.tree.map(jnp.asarray, g), jstate)
        opt.fused_apply(tp, [torch.from_numpy(a) for a in jax.tree.leaves(g)],
                        tstate)
    pairs = list(zip(tp, jax.tree.leaves(jp)))
    if mu:
        assert all(m.dtype == torch.float32 for m in tstate)
        pairs += list(zip(tstate, jax.tree.leaves(jstate)))
    for a, b in pairs:
        a, b = _np(a), np.asarray(b)
        if a.size < 1024:  # JAX's jnp path
            np.testing.assert_array_equal(a, b)
        else:
            tol = 4 * np.finfo(np.float32).eps * float(np.abs(b).max())
            np.testing.assert_allclose(a, b, atol=tol, rtol=0)


def test_sgd_plain_equals_the_sgd_optimizer():
    """``pallas_sgd`` and ``"sgd"`` run the same f32 arithmetic
    (p + (-lr*u) == p - lr*u, mu*m + g == g + mu*m): bit-equal, so the
    smoke's plain path (``"sgd"``) is the kernel path's exact reference."""
    from distkeras_tpu_torch.ops.optimizers import Sgd, apply_updates

    rng = np.random.default_rng(3)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((40, 9), (5,))]
    for mu, nesterov in ((0.0, False), (0.9, False), (0.9, True)):
        a = [torch.from_numpy(x.copy()) for x in p0]
        b = [torch.from_numpy(x.copy()) for x in p0]
        fused, plain = FusedSGD(0.03, mu, nesterov), Sgd(0.03, mu, nesterov)
        fs, ps = fused.init(a), plain.init(b)
        for _ in range(3):
            g = [torch.from_numpy(rng.standard_normal(x.shape)
                                  .astype(np.float32)) for x in p0]
            fused.fused_apply(a, g, fs)
            upd, ps = plain.update(g, ps, b)
            apply_updates(b, upd)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("opt", [FusedSGD(0.1), FusedSGD(0.1, momentum=0.9),
                                 FusedAdam(1e-3)],
                         ids=["sgd", "momentum", "adam"])
def test_tables_are_built_once_per_parameter_set(opt):
    """Two workers' parameter sets alternating on one optimizer: two
    tables, each built once, never once per call; a gradient pointer table
    is uploaded again only when the gradients move."""
    sets = []
    for seed in (0, 1):
        params = [torch.randn(8193), torch.randn(3, 5)]
        state = opt.init(params)
        moments = ([] if isinstance(opt, FusedSGD) and not opt.momentum
                   else [state] if isinstance(opt, FusedSGD)
                   else [state[0], state[1]])
        grads = [torch.randn(8193), torch.randn(3, 5)]
        sets.append(((params, *moments), grads))
    for _ in range(3):
        for buffers, grads in sets:
            table, gptrs = opt._tables.get(buffers, grads)
            assert table.n_chunks == 4 and table.leaves.shape == (
                2, len(buffers) + 1)
            assert gptrs.tolist() == [g.data_ptr() for g in grads]
    assert opt._tables.builds == 2 and len(opt._tables) == 2
    assert opt._tables.grad_uploads == 2
    moved = [g.clone() for g in sets[0][1]]
    opt._tables.get(sets[0][0], moved)
    assert opt._tables.builds == 2 and opt._tables.grad_uploads == 3


# ------------------------------------------------------ parameter servers


def _center(seed=0):
    rng = np.random.default_rng(seed)
    return {"0.kernel": rng.standard_normal((4, 3)).astype(np.float32),
            "0.bias": rng.standard_normal(3).astype(np.float32)}


def test_commit_rules_bit_equal_jax():
    """``delta_rule``/``dynsgd_rule`` vs JAX's on the same arrays: the same
    numpy f32 adds (and the same staleness scale) — bit-equal."""
    c, d = _center(0), _center(1)
    jc = {"0": {"kernel": c["0.kernel"], "bias": c["0.bias"]}}
    jd = {"0": {"kernel": d["0.kernel"], "bias": d["0.bias"]}}
    out, meta = tps.delta_rule(c, {"num_updates": 2}, d)
    jout, jmeta = jps.delta_rule(jc, {"num_updates": 2}, jd)
    assert meta == jmeta == {"num_updates": 3}
    for tag in (5, 3, 0):
        dout, dmeta = tps.dynsgd_rule(c, {"version": 5}, d, tag)
        jdout, jdmeta = jps.dynsgd_rule(jc, {"version": 5}, jd, tag)
        assert dmeta == jdmeta
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(dout[f"0.{k}"], jdout["0"][k])
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(out[f"0.{k}"], jout["0"][k])


def test_ps_pull_commit_dedup_and_versions():
    ps = tps.DynSGDParameterServer(_center(0))
    center, tag = ps.pull(worker_id=0)
    assert tag == 0
    center["0.bias"] += 100  # a pull is a copy
    delta = _center(1)
    ps.commit(delta, tag, commit_id=(0, 0))
    ps.commit(delta, tag, commit_id=(0, 0))  # a replay: dropped
    assert ps.num_updates == 1 and ps.num_duplicates == 1
    _, tag = ps.pull(worker_id=1)
    assert tag == 1
    ps.commit(delta, 0, commit_id=(1, 0))  # staleness 1: half the delta
    want = _center(0)["0.bias"] + delta["0.bias"] + 0.5 * delta["0.bias"]
    np.testing.assert_array_equal(ps.get_params()["0.bias"], want)
    with pytest.raises(tps.ParameterServerError, match="bad_delta"):
        ps.commit({"0.bias": delta["0.bias"]}, 0)
    plain = tps.DeltaParameterServer(_center(0))
    assert plain.pull()[1] is None


def test_ps_concurrent_commits_all_land():
    """16 threads x 50 commits with a short switch interval: every commit
    lands exactly once (a lost update under the lock would break the
    sum)."""
    ps = tps.DeltaParameterServer({"w": np.zeros(64, np.float32)})
    one = {"w": np.ones(64, np.float32)}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda w=w: [
            ps.commit(one, commit_id=(w, s)) for s in range(50)])
            for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert ps.num_updates == 800 and ps.num_duplicates == 0
    np.testing.assert_array_equal(ps.get_params()["w"], np.full(64, 800.0))


def test_ps_heartbeats_snapshots_and_listeners():
    ps = tps.DynSGDParameterServer(_center(0))
    ps.pull(worker_id=0)
    ps.commit(_center(1), 0, commit_id=(1, 0), local_snap={"seq": 1})
    ps.commit(_center(1), 1, commit_id=(1, 3))
    now = max(ps._activity.values())
    assert ps.suspected_failures(10.0, now=now + 5) == []
    assert ps.suspected_failures(1.0, now=now + 5) == [0, 1]
    fired = []
    ps.add_snapshot_listener(lambda n, c, m, s: fired.append((n, m["version"])),
                             every=3)
    ps.add_snapshot_listener(lambda *a: 1 / 0)  # logged, never raised
    center, meta = ps.snapshot()
    assert meta["seen_seq"] == {"1": 3} and meta["version"] == 2
    ps.commit(_center(1), 2, commit_id=(1, 4))
    assert fired == [(3, 3)]
    ps.commit(_center(1), 2, commit_id=(1, 4))  # deduped: no listener
    assert fired == [(3, 3)] and ps.num_duplicates == 1
    restored = tps.DynSGDParameterServer(_center(5))
    restored.restore_snapshot(center, meta)
    assert restored.pull()[1] == 2 and restored.num_updates == 2
    restored.commit(_center(1), 2, commit_id=(1, 3))  # seen before: dropped
    assert restored.num_duplicates == 1 and restored.num_updates == 2
    np.testing.assert_array_equal(restored.get_params()["0.bias"],
                                  center["0.bias"])
    assert ps.worker_snapshots() == {1: {"seq": 1}}


# --------------------------------------------------------------- trainers


@pytest.mark.parametrize("port_cls,jax_cls,opt", [
    (DOWNPOUR, JDOWNPOUR, "sgd"),
    (AEASGD, JAEASGD, "sgd"),
    (EAMSGD, JEAMSGD, "sgd"),
    (ADAG, JADAG, "sgd"),
    (DynSGD, JDynSGD, "sgd"),
    (DOWNPOUR, JDOWNPOUR, "pallas_sgd"),
    (DynSGD, JDynSGD, "pallas_sgd_momentum"),
], ids=["DOWNPOUR", "AEASGD", "EAMSGD", "ADAG", "DynSGD",
        "DOWNPOUR-pallas_sgd", "DynSGD-pallas_sgd-momentum"])
def test_trainer_matches_jax_simulated(port_cls, jax_cls, opt):
    """Each trainer in simulated mode vs its JAX counterpart:
    ``mnist_mlp(hidden=16)`` with bridged weights, ``synthetic_mnist(512)``
    through each package's transformers, 4 workers, window 4, lr 0.02,
    batch 32, 2 epochs (8 commits). The same schedule, so only the
    matmul summation order differs: every step's loss within 1e-5
    relative, the final center within 1e-5."""
    jm, tm = _mlps()
    jopt = topt = opt
    if opt == "pallas_sgd_momentum":
        jopt = functools.partial(JFusedSGD, momentum=0.9)
        topt = functools.partial(FusedSGD, momentum=0.9)
    jt = jax_cls(jm, jopt, **ASYNC)
    jres = jt.train(_jax_data())
    kernels.reset_launch_counts()
    tt = port_cls(tm, topt, device="cpu", **ASYNC)
    res = tt.train(_port_data())
    assert set(kernels.launch_counts().values()) == {0}  # plain on CPU
    jh, th = jt.get_history(), tt.get_history()
    assert len(th) == len(jh) == 32
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        assert b["accuracy"] == pytest.approx(a["accuracy"], abs=1e-6)
    assert tt.parameter_server.num_updates == jt.parameter_server.num_updates == 8
    for a, b in zip(res.get_weights(), jres.get_weights()):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    if port_cls is DynSGD:
        assert tt.parameter_server.pull()[1] == 8
    if opt.startswith("pallas"):
        assert isinstance(tt.optimizer, FusedSGD)
    if port_cls is EAMSGD:
        assert tt.optimizer.momentum == 0.9 and tt.optimizer.nesterov
    assert tt.failures == [] and not res.training
    assert all(torch.equal(a, b) for a, b in zip(
        tm.parameters(), _mlps()[1].parameters()))  # the caller's model


def test_hooked_lm_slice_matches_jax():
    """The slice as a whole: ``transformer_lm(61, 32, 32, 2, 2)`` with the
    flash and LayerNorm hooks under DOWNPOUR + ``pallas_sgd``, 2 workers,
    window 2, batch 8, 2 windows per worker, vs JAX with the same hooks
    (its Pallas kernels in interpret mode). f32 throughout: losses within
    1e-4 relative, the center within 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 61, (64, 32)).astype(np.int32)
    kw = dict(metrics=["next_token_accuracy"], learning_rate=0.05,
              batch_size=8, num_workers=2, communication_window=2,
              mode="simulated", seed=0)
    jlm = jzoo.transformer_lm(61, 32, 32, 2, 2, seed=0)
    lm = zoo.transformer_lm(61, 32, 32, 2, 2, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    jln.attach_fused_layernorm(jlm)
    jfa.attach_flash_attention(jlm)
    tln.attach_fused_layernorm(lm)
    tfa.attach_flash_attention(lm)
    jt = JDOWNPOUR(jlm, "pallas_sgd", "next_token_crossentropy", **kw)
    jres = jt.train(JDataset({"features": x, "label": x}), shuffle=True)
    tt = DOWNPOUR(lm, "pallas_sgd", "next_token_crossentropy", device="cpu",
                  **kw)
    res = tt.train(Dataset({"features": x, "label": x}), shuffle=True)
    jh, th = jt.get_history(), tt.get_history()
    assert len(th) == len(jh) == 8
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
    assert tt.parameter_server.num_updates == 4
    for a, b in zip(res.get_weights(), jres.get_weights()):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert res.layers[1].mhsa.attention_fn is tfa.flash_attention


def test_resident_and_streamed_are_bit_identical():
    """The resident feed gathers the streamed windows' batches on the
    device, under the same schedule: the same trajectory to the bit."""
    runs = []
    for resident in (False, True):
        _, tm = _mlps()
        t = DOWNPOUR(tm, "pallas_sgd", device="cpu", device_resident=resident,
                     **ASYNC)
        runs.append((t.train(_port_data()), t))
    (r0, t0), (r1, t1) = runs
    assert len(t0.get_history()) == 32
    assert t0.get_history() == t1.get_history()
    assert all(torch.equal(a, b) for a, b in zip(r0.parameters(),
                                                  r1.parameters()))


def test_downpour_with_one_worker_is_the_single_trainer():
    """One DOWNPOUR worker trains the same batches in the same order as
    ``SingleTrainer`` (its window stream shuffles with seed + worker id +
    epoch): the same losses; the center differs from the trainer's weights
    only by the rounding of center + (replica - center) per commit, 1e-6."""
    _, a = _mlps()
    _, b = _mlps()
    kw = dict(loss="categorical_crossentropy", learning_rate=0.02,
              batch_size=32, num_epoch=2, label_col="label_onehot", seed=0)
    single = SingleTrainer(a, "sgd", window=4, device="cpu", **kw)
    ra = single.train(_port_data(), shuffle=True)
    dp = DOWNPOUR(b, "sgd", num_workers=1, communication_window=4,
                  mode="simulated", device="cpu", **kw)
    rb = dp.train(_port_data())
    ha, hb = single.get_history(), dp.get_history()
    assert len(ha) == len(hb) == 32
    for x, y in zip(ha, hb):
        assert y["loss"] == pytest.approx(x["loss"], rel=1e-6)
    for x, y in zip(ra.get_weights(), rb.get_weights()):
        np.testing.assert_allclose(y, x, atol=1e-6, rtol=0)


def test_threads_mode_every_worker_commits():
    """Four worker threads on one device: every window is committed once,
    every worker trains, nothing fails, and the model learns."""
    _, tm = _mlps()
    t = DOWNPOUR(tm, "pallas_sgd", device="cpu", heartbeat_timeout=30.0,
                 **{**ASYNC, "mode": "threads"})
    res = t.train(_port_data())
    assert t.failures == [] and t.suspicions == []
    assert t.parameter_server.num_updates == 8
    assert {w.worker_id for w in t.workers if w.records} == {0, 1, 2, 3}
    assert all(len(w.splits) == 2 for w in t.workers)
    assert t.optimizer._tables.builds == 0  # CPU tensors: no tables
    snap = t.workers[1].final_snapshot()
    assert snap["seq"] == 2 and snap["opt_state"] == ()
    assert list(snap["params"]) == [n for n, _ in tm.named_parameters()]
    pred = ModelPredictor(res, device="cpu").predict(_port_data())
    acc = AccuracyEvaluator(label_col="label").evaluate(pred)
    jpred = JPredictor(_mlps()[0]).predict(_jax_data())
    assert acc > JAccuracy(label_col="label").evaluate(jpred)
    assert LossEvaluator(label_col="label_onehot").evaluate(pred) < 2.3


class _FlakyPS(tps.DeltaParameterServer):
    """Applies worker 1's second commit, then loses its ack once."""

    def __init__(self, params):
        super().__init__(params)
        self.tripped = False

    def commit(self, delta, tag=None, commit_id=None, local_snap=None):
        super().commit(delta, tag, commit_id=commit_id, local_snap=local_snap)
        if commit_id == (1, 1) and not self.tripped:
            self.tripped = True
            raise tps.CommitNotAcknowledgedError(commit_id)


class _FlakyDOWNPOUR(DOWNPOUR):
    ps_cls = _FlakyPS


@pytest.mark.parametrize("elastic", [False, True], ids=["retry", "elastic"])
def test_worker_retry_and_adoption_stay_exactly_once(elastic):
    """A commit applied whose ack is lost: the worker's retry (or, with no
    retries left and ``elastic``, a survivor adopting its partition)
    replays from scratch, and the PS drops the two replayed commits — each
    window lands exactly once."""
    _, tm = _mlps()
    t = _FlakyDOWNPOUR(tm, "sgd", device="cpu", elastic=elastic,
                       worker_retries=0 if elastic else 1,
                       **{**ASYNC, "mode": "threads"})
    t.train(_port_data())
    ps = t.parameter_server
    assert ps.tripped and ps.num_updates == 8 and ps.num_duplicates == 2
    assert [(f["worker_id"], f["attempt"]) for f in t.failures] == [(1, 0)]
    if elastic:
        assert len(t.adoptions) == 1
        assert t.adoptions[0]["worker_id"] == 1 and t.adoptions[0]["ok"]
    else:
        assert t.adoptions == []


def test_async_refusals_and_device_contract(tmp_path):
    _, tm = _mlps()
    for option, module in (("serve_socket", "networking"),
                           ("remote_ps", "RemoteParameterServerClient"),
                           ("standby", "replication")):
        with pytest.raises(NotImplementedError, match=module):
            DOWNPOUR(tm, "sgd", device="cpu", **{option: "int8"})
    # compress and pull_compress are ported: accepted
    t = DOWNPOUR(tm, "sgd", device="cpu", compress="int8",
                 pull_compress="int8")
    assert (t.compress, t.pull_compress) == ("int8", "int8")
    # checkpoint_dir and metrics_path are ported: accepted
    t = DOWNPOUR(tm, "sgd", device="cpu", checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_every=4, metrics_path=str(tmp_path / "m.jsonl"))
    assert t.checkpointer.directory == str(tmp_path / "ck")
    assert t.checkpoint_every == 4 and t.metrics_logger is not None
    with pytest.raises(TypeError, match="validation_data"):
        DOWNPOUR(tm, "sgd", device="cpu", validation_data=_port_data(8))
    for cls in (AEASGD, ADAG, EAMSGD):
        with pytest.raises(TypeError, match="schedules"):
            cls(tm, "sgd", learning_rate=lambda step: 0.1, device="cpu")
    with pytest.raises(TypeError, match="schedules"):
        FusedSGD(lambda step: 0.1)
    with pytest.raises(ValueError, match="unknown mode"):
        DOWNPOUR(tm, "sgd", mode="nope", device="cpu", num_workers=2,
                 label_col="label_onehot").train(_port_data(64))
    assert tps.DeltaParameterServer(
        _center(), pull_compress="bfloat16").pull_compress == "bfloat16"
    with pytest.raises(NotImplementedError, match="obs/metrics"):
        tps.DeltaParameterServer(_center()).metrics_snapshot()
    with pytest.raises(NotImplementedError, match="SocketParameterServer"):
        tps.DeltaParameterServer(_center()).attach_replica(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DOWNPOUR(tm, "sgd", label_col="label_onehot").train(_port_data(64))


def test_transformers_and_evaluators_match_jax():
    """The numpy transformers and evaluators are copies: equal columns,
    equal scores (the loss in f32 on both sides, 1e-6)."""
    a, b = _port_data(64), _jax_data(64)
    for col in ("features", "label", "label_onehot"):
        np.testing.assert_array_equal(a[col], b[col])
    feats = a["features"][:, :6]
    for name, args, kw in (("StandardScaleTransformer", (), {}),
                           ("DenseTransformer", (["f", "g"], "d"), {}),
                           ("ReshapeTransformer", ("f", "r", (2, 3)), {}),
                           ("LabelIndexTransformer", (), {"input_col": "f"})):
        port = getattr(ttf, name)(*args, **kw)
        jx = getattr(jtf, name)(*args, **kw)
        x = port.transform(Dataset({"features": feats, "f": feats, "g": feats}))
        y = jx.transform(JDataset({"features": feats, "f": feats, "g": feats}))
        for col in x.columns:
            np.testing.assert_array_equal(x[col], y[col])
    probs = np.random.default_rng(1).dirichlet(np.ones(10), 64).astype(np.float32)
    pa = a.with_column("prediction", probs)
    pb = b.with_column("prediction", probs)
    assert AccuracyEvaluator().evaluate(pa) == JAccuracy().evaluate(pb)
    from distkeras_tpu.evaluators import LossEvaluator as JLoss

    assert LossEvaluator(label_col="label_onehot").evaluate(pa) == pytest.approx(
        JLoss(label_col="label_onehot").evaluate(pb), abs=1e-6)


def test_async_tier_runs_without_jax():
    """The new modules import, and a DOWNPOUR run trains, in a process that
    never loads JAX or the JAX package."""
    code = (
        "import sys, distkeras_tpu_torch as p\n"
        "from distkeras_tpu_torch import parameter_servers, evaluators\n"
        "from distkeras_tpu_torch.data import transformers\n"
        "m = p.zoo.mnist_mlp(hidden=8, device='cpu')\n"
        "ds = transformers.OneHotTransformer(10).transform(\n"
        "    p.loaders.synthetic_mnist(n=128))\n"
        "t = p.DOWNPOUR(m, 'pallas_sgd', num_workers=2, batch_size=16,\n"
        "               communication_window=2, label_col='label_onehot',\n"
        "               mode='threads', device='cpu')\n"
        "t.train(ds)\n"
        "assert t.parameter_server.num_updates == 4, t.failures\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'distkeras_tpu' or m.startswith('distkeras_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
