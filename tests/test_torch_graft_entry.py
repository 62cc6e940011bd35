"""The port's graft entry points (``graft_entry_torch.py``) vs the JAX
package's (``__graft_entry__.py``) on the CPU.

``entry(cpu=True)`` on weights bridged from JAX's ``mnist_cnn(seed=0)``
against JAX's ``entry()`` forward, on its zero batch and on a seeded one
(logits 1e-4). ``dryrun_multichip`` runs as gloo CPU rank processes, one
module-scoped launch per topology (8 ranks: every block, the 3-D one
included; 1 rank: the one-card topology). Every rank holds each
step against the same step on one rank itself (``ONE_RANK_TOL``); here
the numpy steps' arrays are also held against JAX's own functions on the
same seeded inputs (``multichip_inputs``) on the conftest's 8 CPU
devices, with the JAX tests' bars: outputs 1e-5 and gradients 2e-4 (absolute up to magnitude 1,
relative to the largest JAX value above it: the pipeline's gradients
reach 1.6e3, where one f32 ulp is 1.2e-4). The JAX package is imported
inside the tests that use it, so the card tests run where JAX is absent.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import graft_entry_torch as ge

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a launch ends within this many seconds or fails
LAUNCH_TIMEOUT = 240
OUT_TOL = 1e-5  # tests/test_ring_attention.py, test_pipeline_parallel.py
GRAD_TOL = 2e-4
LOGIT_TOL = 1e-4


def _close(got, want, tol, what):
    """|got - want| <= tol x max(1, max |want|)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3g}"


# ------------------------------------------------------------------ entry


def _jax_entry(monkeypatch):
    """JAX's ``entry()`` with its out-of-process probe answered here (the
    conftest has already pinned the 8-device CPU platform)."""
    import __graft_entry__

    monkeypatch.setattr(__graft_entry__, "_probe_real_devices",
                        lambda timeout=90.0: ("cpu", 8))
    return __graft_entry__.entry()


def test_entry_matches_jax_on_bridged_weights(monkeypatch):
    import jax

    from distkeras_tpu_torch.utils.convert import (
        params_from_jax,
        state_from_jax,
    )

    jfn, (params, state, jx) = _jax_entry(monkeypatch)
    fn, (model, x) = ge.entry(cpu=True)
    assert x.device.type == "cpu" and tuple(x.shape) == tuple(jx.shape)
    params_from_jax(model, jax.tree.map(np.asarray, params))
    state_from_jax(model, jax.tree.map(np.asarray, state))
    out = fn(model, x)
    assert tuple(out.shape) == (8, 10) and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(jax.jit(jfn)(
        params, state, jx)), atol=LOGIT_TOL, rtol=0)
    # the zero batch gives the uniform 0.1 whatever the weights: a seeded
    # batch tells the bridged weights apart
    xb = np.random.default_rng(0).uniform(0, 1, (5, 28, 28, 1)).astype(
        np.float32)
    want = np.asarray(jax.jit(jfn)(params, state, xb))
    assert np.ptp(want) > 1e-3
    np.testing.assert_allclose(fn(model, torch.from_numpy(xb)).numpy(), want,
                               atol=LOGIT_TOL, rtol=0)


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        ge.entry()
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        ge.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        ge.dryrun_multiprocess(2)


def test_import_loads_no_jax():
    code = ("import sys, graft_entry_torch as g; fn, a = g.entry(cpu=True); "
            "fn(*a); bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'distkeras_tpu')]; print(bad); assert not bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------- multichip, n = 8


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    out = tmp_path_factory.mktemp("multichip8")
    res = ge.dryrun_multichip(8, cpu=True, out_dir=str(out),
                              timeout=LAUNCH_TIMEOUT)
    return res, [dict(np.load(out / f"rank{r}.npz")) for r in range(8)]


def _jax_steps():
    """JAX's blocks of ``dryrun_multichip(8)`` (``__graft_entry__.py:
    196-337``) on the port's inputs, with their outputs and gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from distkeras_tpu.parallel.expert_parallel import (
        moe_ffn,
        shard_moe_params,
    )
    from distkeras_tpu.parallel.pipeline_parallel import (
        pipeline_apply,
        shard_stacked_params,
        stack_block_params,
    )
    from distkeras_tpu.parallel.ring_attention import ring_attention
    from distkeras_tpu.parallel.ulysses import ulysses_attention

    n = 8
    inputs = ge.multichip_inputs(n)
    devices = jax.devices()[:n]
    seq = Mesh(np.array(devices), ("seq",))
    ds = Mesh(np.array(devices).reshape(2, n // 2), ("data", "seq"))

    def qkv(step):
        return [inputs[f"{step}/{c}"] for c in "qkv"]

    out = {"ring": ring_attention(*qkv("ring"), seq, causal=True),
           "ulysses": ulysses_attention(*qkv("ulysses"), seq, causal=True),
           "ring_data": ring_attention(*qkv("ring_data"), ds, causal=True,
                                       batch_axis="data")}
    blocks = ge.blocks_of(inputs, "pipeline", "wb", n)

    def pp_block(p, h):
        return jnp.tanh(h @ p["w"] + p["b"]) + h

    def grads(fn, params, x):
        return fn(params, x), jax.grad(
            lambda p, x: jnp.sum(fn(p, x) ** 2))(params, x)

    pipe = Mesh(np.array(devices), ("pipe",))
    out["pipeline"] = grads(
        jax.jit(lambda p, x: pipeline_apply(p, x, pp_block, pipe)),
        shard_stacked_params(stack_block_params(blocks), pipe),
        inputs["pipeline/x"])
    pd = Mesh(np.array(devices).reshape(n // 2, 2), ("pipe", "data"))
    out["pipe_data"] = grads(
        jax.jit(lambda p, x: pipeline_apply(p, x, pp_block, pd,
                                            batch_axis="data")),
        shard_stacked_params(stack_block_params(blocks[:n // 2]), pd),
        inputs["pipe_data/x"])

    m3 = Mesh(np.array(devices[:8]).reshape(2, 2, 2),
              ("pipe", "data", "model"))
    blocks3 = ge.blocks_of(inputs, "grid_3d", ("wi", "wo"), 2)
    specs3 = {"wi": P("pipe", None, "model"), "wo": P("pipe", "model", None)}

    def tp_block(p, h):
        return h + jax.lax.psum(jnp.tanh(h @ p["wi"]) @ p["wo"], "model")

    out["grid_3d"] = grads(
        jax.jit(lambda p, x: pipeline_apply(
            p, x, tp_block, m3, num_micro=2, batch_axis="data",
            param_specs=specs3)),
        shard_stacked_params(stack_block_params(blocks3), m3,
                             param_specs=specs3),
        inputs["grid_3d/x"])

    ep = Mesh(np.array(devices), ("expert",))
    moe = shard_moe_params({k: inputs["expert/" + k]
                            for k in ("router", "wi", "wo")}, ep)
    xe = inputs["expert/x"]
    ep_out, aux = jax.jit(lambda p, x: moe_ffn(p, x, mesh=ep))(moe, xe)
    ep_grads = jax.jit(jax.grad(lambda p, x: jnp.sum(
        moe_ffn(p, x, mesh=ep)[0] ** 2) + moe_ffn(p, x, mesh=ep)[1]))(
            moe, xe)
    out["expert"] = (ep_out, aux, ep_grads)
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def jax_steps():
    return _jax_steps()


def test_eight_ranks_run_every_step_within_one_rank(eight):
    res, _ = eight
    names = ge.multichip_step_names(8)
    assert names == ["sync_dp", "zero1", "tensor", "ring", "ulysses",
                     "ring_data", "pipeline", "pipe_data", "grid_3d",
                     "expert", "lm_window"]
    assert list(res["steps"]) == names
    for step, recs in res["steps"].items():
        assert [r["rank"] for r in recs] == list(range(8)), step
        for rec in recs:
            assert rec["n"] == 8 and rec["device"] == "cpu"
            assert all(e <= ge.ONE_RANK_TOL for e in rec["err"].values())
            assert rec["replicated"] == recs[0]["replicated"], step
    assert [t["backend"] for t in res["ranks"]] == ["gloo"] * 8
    # JAX's finite-loss checks, and the steps whose loss is replicated
    for step in ("sync_dp", "zero1", "tensor", "lm_window"):
        assert np.isfinite(res["steps"][step][0]["replicated"]["loss"])


@pytest.mark.parametrize("step", ["ring", "ulysses"])
def test_sequence_blocks_match_jax(eight, jax_steps, step):
    _, ranks = eight
    for r, arrays in enumerate(ranks):
        _close(arrays[f"{step}/out"], jax_steps[step][:, r * 8:(r + 1) * 8],
               OUT_TOL, f"{step} rank {r}")


def test_ring_inside_a_data_group_matches_jax(eight, jax_steps):
    _, ranks = eight
    for r, arrays in enumerate(ranks):
        d, i = arrays["ring_data/coords"]
        _close(arrays["ring_data/out"],
               jax_steps["ring_data"][d:d + 1, i * 8:(i + 1) * 8], OUT_TOL,
               f"ring_data rank {r}")


@pytest.mark.parametrize("step", ["pipeline", "pipe_data"])
def test_pipeline_grads_match_jax(eight, jax_steps, step):
    """Each rank's stage gradients (summed over its data group) are JAX's
    at the rank's blocks; the output is whole on every rank."""
    _, ranks = eight
    out, grads = jax_steps[step]
    for r, arrays in enumerate(ranks):
        p = r if step == "pipeline" else arrays["pipe_data/coords"][0]
        _close(arrays[f"{step}/out"], out, OUT_TOL, f"{step} out")
        for k in ("w", "b"):
            _close(arrays[f"{step}/grad_{k}"], grads[k][p:p + 1], GRAD_TOL,
                   f"{step} rank {r} {k}")


def test_grid_3d_grads_match_jax(eight, jax_steps):
    _, ranks = eight
    out, grads = jax_steps["grid_3d"]
    for r, arrays in enumerate(ranks):
        p, _, m = arrays["grid_3d/coords"]
        assert (p, m) == (r // 4, r % 2)  # rank (p * D + d) * M + m
        _close(arrays["grid_3d/out"], out, OUT_TOL, "grid_3d out")
        _close(arrays["grid_3d/grad_wi"],
               grads["wi"][p:p + 1, :, m * 8:(m + 1) * 8], GRAD_TOL,
               f"grid_3d rank {r} wi")
        _close(arrays["grid_3d/grad_wo"],
               grads["wo"][p:p + 1, m * 8:(m + 1) * 8], GRAD_TOL,
               f"grid_3d rank {r} wo")


def test_expert_step_matches_jax(eight, jax_steps):
    _, ranks = eight
    out, aux, grads = jax_steps["expert"]
    for r, arrays in enumerate(ranks):
        _close(arrays["expert/out"], out, OUT_TOL, "expert out")
        _close(arrays["expert/aux"], aux, OUT_TOL, "expert aux")
        _close(arrays["expert/grad_router"], grads["router"], GRAD_TOL,
               f"expert rank {r} router")
        for k in ("wi", "wo"):
            _close(arrays[f"expert/grad_{k}"], grads[k][r:r + 1], GRAD_TOL,
                   f"expert rank {r} {k}")


# ---------------------------------------------------- one card, n = 1


def test_one_rank_runs_the_one_card_steps():
    res = ge.dryrun_multichip(1, cpu=True, timeout=LAUNCH_TIMEOUT)
    assert list(res["steps"]) == ["sync_dp", "zero1", "ring", "ulysses",
                                  "pipeline", "expert", "lm_window"]
    for step, (rec,) in res["steps"].items():
        assert rec["n"] == 1 and rec["err"], step
        assert all(e <= ge.ONE_RANK_TOL for e in rec["err"].values()), step
    (times,) = res["ranks"]
    assert times["backend"] == "gloo" and times["steps_s"] > 0


def test_a_failing_rank_fails_the_dryrun_with_its_output(tmp_path):
    """A rank that raises (here at writing its arrays into a directory
    that is not there) ends the launch, which raises with its output."""
    missing = tmp_path / "missing"
    with pytest.raises(RuntimeError, match=r"(?s)rank \d of 2 exited.*"
                       r"No such file or directory"):
        ge.dryrun_multichip(2, cpu=True, out_dir=str(missing),
                            timeout=LAUNCH_TIMEOUT)
    with pytest.raises(ValueError, match="3-D block"):
        ge.dryrun_multichip(16, cpu=True)


def test_step_names_follow_jax_size_conditions():
    assert ge.multichip_step_names(2) == [
        "sync_dp", "zero1", "ring", "ulysses", "pipeline", "expert",
        "lm_window"]
    assert ge.multichip_step_names(4) == [
        "sync_dp", "zero1", "tensor", "ring", "ulysses", "ring_data",
        "pipeline", "pipe_data", "expert", "lm_window"]
    assert "grid_3d" not in ge.multichip_step_names(6)


def test_inputs_keep_jax_weights_and_seed_the_data():
    """The weights are JAX's draws (``default_rng(0)`` pipeline blocks,
    then the expert's; ``default_rng(1)`` 3-D blocks); the data is seeded
    and differs by row and by operand, where JAX's is ones and zeros."""
    inputs = ge.multichip_inputs(8)
    rng = np.random.default_rng(0)
    for i in range(8):
        np.testing.assert_array_equal(
            inputs[f"pipeline/w{i}"],
            rng.standard_normal((8, 8)).astype(np.float32) * 0.3)
    np.testing.assert_array_equal(
        inputs["expert/router"], rng.standard_normal((8, 8)).astype(
            np.float32))
    np.testing.assert_array_equal(
        inputs["grid_3d/wi0"], np.random.default_rng(1).standard_normal(
            (8, 16)).astype(np.float32) * 0.3)
    for step in ("ring", "ulysses", "ring_data"):
        q, k = inputs[f"{step}/q"], inputs[f"{step}/k"]
        assert q.shape[1] % 8 == 0 and not np.array_equal(q, k), step
        assert np.ptp(q, axis=1).min() > 0, step
    for key in ("mnist/x", "pipeline/x", "grid_3d/x", "expert/x", "lm/x"):
        a = inputs[key]
        rows = a.reshape(-1, a.shape[-1]) if key != "mnist/x" else a[0]
        assert len({r.tobytes() for r in rows}) == len(rows), key
    assert len(np.unique(inputs["mnist/y"][0].argmax(-1))) > 1
    np.testing.assert_array_equal(ge.multichip_inputs(8)["lm/x"],
                                  inputs["lm/x"])


def test_steps_restore_the_callers_tf32_flags(monkeypatch):
    """``multichip_steps`` turns TF32 off for its own steps only."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    (port,) = ge._free_ports(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        recs = ge.multichip_steps("cpu")
    finally:
        dist.destroy_process_group()
    assert [r["step"] for r in recs] == ge.multichip_step_names(1)
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32


def test_check_multichip_refuses_ranks_that_disagree():
    rec = {"step": "ring", "rank": 0, "replicated": {"out": 1.0},
           "err": {"out": 0.0}}
    names = ge.multichip_step_names(1)
    ok = [[dict(rec, step=s) for s in names]]
    assert list(ge.check_multichip(ok)) == names
    two = [[dict(rec, step=s, rank=r) for s in ge.multichip_step_names(2)]
           for r in range(2)]
    two[1][3]["replicated"] = {"out": 2.0}
    with pytest.raises(RuntimeError, match="ulysses: rank 1"):
        ge.check_multichip(two)
    two[1][3]["replicated"] = {"out": 1.0}
    two[0][0]["err"] = {"loss": 2 * ge.ONE_RANK_TOL}
    with pytest.raises(RuntimeError, match="sync_dp: rank 0"):
        ge.check_multichip(two)
    with pytest.raises(RuntimeError, match="rank 0 ran"):
        ge.check_multichip([ok[0][:-1]])


# ------------------------------------------------------------- multiprocess


def test_multiprocess_ranks_agree_and_commit():
    res = ge.dryrun_multiprocess(2, cpu=True, timeout=LAUNCH_TIMEOUT)
    assert res["digests"][0] == res["digests"][1]
    assert np.isfinite(res["digests"][0]) and res["digests"][0] > 0
    assert min(res["commits"]) >= 1
    with pytest.raises(RuntimeError, match="2 processes"):
        ge.dryrun_multiprocess(3, cpu=True)


# ------------------------------------------------------------- on the card


@pytest.mark.gpu
def test_entry_on_the_card_equals_the_cpu():
    """The card's forward equals the CPU's on the example batch and on a
    seeded one (f32 convolutions, no TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    fn, (model, x) = ge.entry()
    cfn, (cmodel, cx) = ge.entry(cpu=True)
    out = fn(model, x)
    assert out.device.type == "cuda" and tuple(out.shape) == (8, 10)
    torch.testing.assert_close(out.cpu(), cfn(cmodel, cx), atol=1e-5, rtol=0)
    xb = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (5, 28, 28, 1)).astype(np.float32))
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = fn(model, xb.cuda()).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
    torch.testing.assert_close(got, cfn(cmodel, xb), atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_one_rank_dryrun_on_the_card():
    """The one-card topology: one NCCL rank on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    res = ge.dryrun_multichip(1, timeout=LAUNCH_TIMEOUT)
    assert list(res["steps"]) == ge.multichip_step_names(1)
    (times,) = res["ranks"]
    assert times["backend"] == "nccl" and times["device"] == "cuda:0"
    print(json.dumps(res["ranks"]))
