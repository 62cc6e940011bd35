"""The port's 3-D composition (pipeline x data x tensor) vs the JAX package
on the CPU.

``pipeline_apply(..., param_specs=)`` and ``shard_stacked_params(...,
param_specs=)`` on a ``parallel.mesh.Grid3D`` of 2 x 2 x 2 gloo rank
processes (("pipe", "data", "model"), launched once through
``Job.run_local_all``), held against JAX's on the conftest's 8 CPU devices
with ``tests/test_3d_mesh.py``'s blocks and specs: w_in split by column
and w_out by row over "model", the bias replicated, the batch split over
"data", 2 microbatches. Each rank writes an ``.npz`` that this process
compares. Tolerances are JAX's own test's: outputs 1e-5 and gradients
2e-4 absolute (f32, another summation order). Each rank's gradients are
summed over its data group before they are compared (JAX's gradient of a
leaf replicated over "data" is the sum over the batch shards).
"""

import textwrap

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.job_deployment import Job, local_address
from distkeras_tpu_torch.parallel import pipeline_parallel as tpp
from distkeras_tpu_torch.parallel.mesh import make_grid_3d
from distkeras_tpu_torch.parallel.tensor_parallel import PartitionSpec

from tests.test_3d_mesh import BATCH, D, DEPTH, HID, _blocks

torch.set_num_threads(2)

#: the launch joins within this many seconds or fails
LAUNCH_TIMEOUT = 110
GRID = (2, 2, 2)  # pipe x data x model
WORLD = 8
LEAVES = ("w_in", "w_out", "b")

_RANK_SCRIPT = textwrap.dedent(
    """
    import sys

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from distkeras_tpu_torch.parallel import multihost

    assert multihost.initialize(device="cpu", timeout=60)
    from distkeras_tpu_torch.parallel import pipeline_parallel as pp
    from distkeras_tpu_torch.parallel.mesh import make_grid_3d
    from distkeras_tpu_torch.parallel.tensor_parallel import PartitionSpec

    inputs = np.load(sys.argv[1])
    out_dir = sys.argv[2]
    rank = multihost.process_id()
    grid = make_grid_3d(*GRID, device="cpu")
    model = grid.model
    results = {"coords": np.array([grid.pipe.rank, grid.data.rank,
                                   model.rank])}
    P = PartitionSpec
    SPECS = {"w_in": P("pipe", None, "model"),
             "w_out": P("pipe", "model", None), "b": P("pipe")}
    TUPLES = {k: tuple(v) for k, v in SPECS.items()}

    def block_tp(p, h):
        # Megatron's MLP: the split branch reads h through copy_in and
        # its row products sum through reduce_out (JAX: lax.psum)
        part = torch.tanh(model.copy_in(h) @ p["w_in"]) @ p["w_out"]
        return h + model.reduce_out(part) + p["b"]

    def stacked(tag):
        return {k: torch.from_numpy(inputs[f"{tag}_{k}"]) for k in LEAVES}

    def apply(stage, x, specs=SPECS):
        return pp.pipeline_apply(stage, x, block_tp, grid, num_micro=2,
                                 batch_axis="data", param_specs=specs)

    # forward: the rank's stage from shard_stacked_params, then the same
    # with plain tuples as specs
    stage = pp.shard_stacked_params(stacked("fwd"), grid, param_specs=SPECS)
    for k in LEAVES:
        results["shape/" + k] = np.array(stage[k].shape)
        results["held/" + k] = stage[k].numpy()
    x = torch.from_numpy(inputs["fwd_x"])
    results["fwd/out"] = apply(stage, x).numpy()
    tup = pp.shard_stacked_params(stacked("fwd"), grid, param_specs=TUPLES)
    results["fwd/out_tuples"] = apply(tup, x, TUPLES).numpy()

    # gradients of sum(out ** 2): the stage's, summed over the data group
    stage = pp.shard_stacked_params(stacked("grad"), grid, param_specs=SPECS)
    for k in LEAVES:
        stage[k].requires_grad_()
    apply(stage, torch.from_numpy(inputs["grad_x"])).square().sum().backward()
    for k in LEAVES:
        results["grad/" + k] = grid.data.all_reduce_(stage[k].grad).numpy()

    # the whole stack passed in: the rank's shards are views of it, so
    # its gradient lands at the rank's slots only
    whole = {k: v.clone().requires_grad_() for k, v in stacked("grad").items()}
    apply(whole, torch.from_numpy(inputs["grad_x"])).square().sum().backward()
    for k in LEAVES:
        results["whole/" + k] = whole[k].grad.numpy()

    # a spec that does not lead with the pipe axis, before any collective
    bad = dict(SPECS, w_in=P(None, None, "model"))
    try:
        apply(stacked("fwd"), x, bad)
    except ValueError as e:
        results["bad_specs"] = np.array(str(e))
    np.savez(f"{out_dir}/rank{rank}.npz", **results)
    multihost.shutdown()
    print("RANK_OK", rank, flush=True)
    """
)


def _inputs():
    out = {}
    for tag, seed, x_seed in (("fwd", 0, 1), ("grad", 2, 3)):
        blocks = _blocks(seed)
        for k in LEAVES:
            out[f"{tag}_{k}"] = np.stack([b[k] for b in blocks])
        out[f"{tag}_x"] = np.random.default_rng(x_seed).standard_normal(
            (BATCH, D)).astype(np.float32)
    return out


def _launch(tmp_path, inputs):
    script = tmp_path / "ranks.py"
    consts = f"GRID = {GRID!r}\nLEAVES = {LEAVES!r}\n"
    script.write_text(consts + _RANK_SCRIPT)
    np.savez(tmp_path / "inputs.npz", **inputs)
    out = tmp_path / "out"
    out.mkdir()
    job = Job(str(script), num_hosts=WORLD,
              coordinator_address=local_address(),
              script_args=[str(tmp_path / "inputs.npz"), str(out)],
              backend="gloo")
    procs = job.run_local_all(str(tmp_path / "ranks"), timeout=LAUNCH_TIMEOUT)
    for i, proc in enumerate(procs):
        assert f"RANK_OK {i}" in proc.stdout
    return [dict(np.load(out / f"rank{i}.npz")) for i in range(WORLD)]


def _jax(inputs):
    """JAX's ``pipeline_apply(param_specs=)`` on the 2 x 2 x 2 mesh: the
    forward output and the gradients of sum(out ** 2)."""
    import jax
    import jax.numpy as jnp

    from distkeras_tpu.parallel.pipeline_parallel import (
        pipeline_apply,
        shard_stacked_params,
    )
    from tests.test_3d_mesh import _block_tp, _dense_reference, _mesh_3d
    from tests.test_3d_mesh import _tp_specs

    mesh = _mesh_3d()
    specs = _tp_specs()

    def stack(tag):
        return shard_stacked_params(
            {k: jnp.asarray(inputs[f"{tag}_{k}"]) for k in LEAVES}, mesh,
            param_specs=specs)

    def fn(p, x):
        return pipeline_apply(p, x, _block_tp, mesh, num_micro=2,
                              batch_axis="data", param_specs=specs)

    out = jax.jit(fn)(stack("fwd"), inputs["fwd_x"])
    grads = jax.jit(jax.grad(lambda p, x: jnp.sum(fn(p, x) ** 2)))(
        stack("grad"), inputs["grad_x"])
    dense = _dense_reference(_blocks(0), inputs["fwd_x"])
    return {"out": np.asarray(out), "dense": np.asarray(dense),
            **{"grad/" + k: np.asarray(grads[k]) for k in LEAVES}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = _inputs()
    ranks = _launch(tmp_path_factory.mktemp("grid3d"), inputs)
    return inputs, ranks, _jax(inputs)


def _shard(a, leaf, p, m):
    """JAX's shard of a whole stacked leaf at pipe index p, model index
    m: ``(DEPTH // 2, ...)`` blocks, w_in's columns or w_out's rows."""
    per = DEPTH // GRID[0]
    a = a[p * per:(p + 1) * per]
    cut = HID // GRID[2]
    if leaf == "w_in":
        return a[:, :, m * cut:(m + 1) * cut]
    if leaf == "w_out":
        return a[:, m * cut:(m + 1) * cut, :]
    return a


def test_grid_rank_layout(world):
    """Rank r sits at the row-major index of ``reshape(P, D, M)``."""
    _, ranks, _ = world
    want = np.stack(np.unravel_index(np.arange(WORLD), GRID), -1)
    got = np.stack([r["coords"] for r in ranks])
    np.testing.assert_array_equal(got, want)


def test_3d_forward_matches_jax(world):
    _, ranks, want = world
    np.testing.assert_allclose(want["out"], want["dense"], atol=1e-5)
    for res in ranks:
        np.testing.assert_allclose(res["fwd/out"], want["out"], atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(res["fwd/out_tuples"], res["fwd/out"])


def test_3d_gradients_match_jax(world):
    _, ranks, want = world
    for res in ranks:
        p, _, m = res["coords"]
        for k in LEAVES:
            np.testing.assert_allclose(
                res["grad/" + k], _shard(want["grad/" + k], k, p, m),
                atol=2e-4, rtol=0, err_msg=k)


def test_3d_weight_placement(world):
    """Each rank holds ``depth / S`` blocks and ``1 / M`` of each split
    matrix (JAX's ``shard_shape``), the values of JAX's shard."""
    inputs, ranks, _ = world
    shapes = {"w_in": (DEPTH // 2, D, HID // 2),
              "w_out": (DEPTH // 2, HID // 2, D), "b": (DEPTH // 2, D)}
    for res in ranks:
        p, _, m = res["coords"]
        for k in LEAVES:
            assert tuple(res["shape/" + k]) == shapes[k], k
            np.testing.assert_array_equal(
                res["held/" + k], _shard(inputs["fwd_" + k], k, p, m))


def test_3d_whole_stack_gradient_lands_in_the_rank_slots(world):
    """A whole stack passed to ``pipeline_apply`` is cut into views: its
    gradient is the rank's shard gradient at the rank's slots, zero
    elsewhere."""
    inputs, ranks, _ = world
    for res in ranks:
        p, d, m = res["coords"]
        group = [r for r in ranks if r["coords"][0] == p
                 and r["coords"][2] == m]
        for k in LEAVES:
            total = sum(r["whole/" + k] for r in group)
            np.testing.assert_allclose(_shard(total, k, p, m),
                                       res["grad/" + k], atol=1e-6, rtol=0)
            mask = np.ones_like(total, bool)
            _shard(mask, k, p, m)[...] = False
            assert not np.any(res["whole/" + k][mask]), k


def test_param_specs_must_lead_with_pipe(world):
    _, ranks, _ = world
    for res in ranks:
        assert "must lead with the 'pipe' block axis" in str(res["bad_specs"])
    grid = make_grid_3d(1, 1, 1, device="cpu")
    stacked = {k: torch.from_numpy(v) for k, v in
               zip(LEAVES, (np.zeros((DEPTH, D, HID), np.float32),
                            np.zeros((DEPTH, HID, D), np.float32),
                            np.zeros((DEPTH, D), np.float32)))}
    P = PartitionSpec
    for bad in ({"w_in": P(None, None, "model"), "w_out": P("pipe"),
                 "b": P("pipe")},
                {"w_in": ("model",), "w_out": ("pipe",), "b": ()}):
        with pytest.raises(ValueError, match="lead with"):
            tpp.shard_stacked_params(stacked, grid, param_specs=bad)
        with pytest.raises(ValueError, match="lead with"):
            tpp.pipeline_apply(stacked, torch.zeros(BATCH, D),
                               lambda p, h: h, grid, param_specs=bad)
