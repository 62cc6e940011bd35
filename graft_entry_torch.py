"""The PyTorch port's graft entry points, beside the JAX package's
``__graft_entry__.py``.

``entry()`` returns the eval forward of the flagship model (the MNIST CNN,
BASELINE config 2) and its example batch. ``dryrun_multichip(n)`` runs one
step of every parallelism the port has — sync-DP, ZeRO-1, tensor, ring,
Ulysses, pipeline, 3-D, expert and a sequence-sharded causal-LM window —
over ``n`` rank processes, each step held against the same step on one
rank, on seeded inputs (``multichip_inputs``). ``dryrun_multiprocess(2)`` crosses a process boundary twice: a
sync-DP run over two ranks, then a commit from rank 1 to rank 0's socket
parameter server.

Everything runs on the card unless the caller passes ``cpu=True``; without
a card a default call raises (``utils.device.resolve_device``), it never
falls back to the CPU. Ranks are placed on ``cuda:(rank % device_count)``:
one rank a card joins over NCCL, ranks that share a card over gloo (NCCL
refuses two ranks on one device), CPU ranks over gloo.

    python graft_entry_torch.py [--cpu] [--multiproc]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

#: a sharded step against the same step on one rank (f32, another
#: summation order; the meshes' bar): losses relative; parameters,
#: gradients and outputs absolute up to magnitude 1 and relative to the
#: largest reference value above it (``_max_err``: the pipeline's
#: gradients reach 1.6e3, where one f32 ulp is 1.2e-4)
ONE_RANK_TOL = 1e-4
#: seconds a launch of the dryruns may take, rank start-up included
MULTICHIP_TIMEOUT = 600
MULTIPROC_TIMEOUT = 420
#: seconds a rank waits for a peer in a collective
GROUP_TIMEOUT = 300
#: the line a rank prints for each step, and for its start-up
STEP_MARK = "MULTICHIP_STEP"
TIMES_MARK = "MULTICHIP_TIMES"
GRID_3D = (2, 2, 2)  # pipe x data x model


def _device(cpu):
    from distkeras_tpu_torch.utils.device import resolve_device

    return resolve_device("cpu" if cpu else None)


def entry(cpu=False):
    """(fn, example_args): the eval forward of ``mnist_cnn(seed=0)`` (dropout
    off) and an (8, 28, 28, 1) f32 zero batch; ``fn(*example_args)`` is the
    (8, 10) softmax output. ``fn(model, x)`` takes any (B, 28, 28, 1) batch
    ``x``. On the card unless ``cpu=True``."""
    import torch

    from distkeras_tpu_torch.models.zoo import mnist_cnn

    dev = _device(cpu)
    model = mnist_cnn(seed=0, device=dev)

    def forward(model, x):
        model.eval()
        with torch.no_grad():
            return model(x)

    x = torch.zeros((8, 28, 28, 1), dtype=torch.float32, device=dev)
    return forward, (model, x)


# ---------------------------------------------------------------- launching


def _free_ports(n):
    """n distinct free ports, probed with all sockets open at once (probes
    one after another can hand the same port back twice)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _backend(n, cpu):
    """The ``Job`` backend of n local ranks: gloo for CPU ranks and for
    ranks that share a card; None (``multihost`` picks NCCL and the rank's
    card) for one rank a card. Raises without a card unless ``cpu``."""
    import torch

    if _device(cpu).type == "cpu" or n > torch.cuda.device_count():
        return "gloo"
    return None


def _launch(n, rank_args, cpu, timeout, coord):
    """This file as ``n`` rank processes through ``Job.run_local_all``, the
    group's coordinator on port ``coord`` (each rank gets ``rank_args``);
    returns (the CompletedProcesses, the launch's start on the wall clock,
    its wall seconds). A rank that fails, or the timeout, ends every rank
    and raises with the failed rank's output tail."""
    from distkeras_tpu_torch.job_deployment import Job

    job = Job(os.path.abspath(__file__), num_hosts=n,
              coordinator_address=f"127.0.0.1:{coord}",
              script_args=list(rank_args) + (["--cpu"] if cpu else []),
              backend=_backend(n, cpu))
    start = time.time()
    procs = job.run_local_all(timeout=timeout)
    return procs, start, time.time() - start


def _join(cpu):
    """Join the job's group from the ``DKT_*`` env ``Job`` sets. A job of
    one rank still gets a group of one, so its collectives run through
    the backend (NCCL on a card)."""
    import datetime

    import torch.distributed as dist

    from distkeras_tpu_torch.parallel import multihost

    device = "cpu" if cpu else None
    if multihost.initialize(device=device, timeout=GROUP_TIMEOUT):
        return
    backend = os.environ.get(multihost.ENV_BACKEND) or (
        "gloo" if cpu else "nccl")
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ[multihost.ENV_COORDINATOR]}",
        world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))


def _lines(procs, mark):
    """Every rank's ``mark`` lines as JSON, in rank order."""
    return [[json.loads(line.split(" ", 1)[1])
             for line in p.stdout.splitlines() if line.startswith(mark + " ")]
            for p in procs]


# -------------------------------------------------------- the multichip steps


def multichip_step_names(n):
    """The steps ``dryrun_multichip(n)`` runs, in order (JAX's blocks and
    their size conditions)."""
    even4 = n >= 4 and n % 2 == 0
    return ["sync_dp", "zero1", *(["tensor"] if even4 else []), "ring",
            "ulysses", *(["ring_data"] if even4 else []), "pipeline",
            *(["pipe_data"] if even4 else []),
            *(["grid_3d"] if n >= 8 and n % 8 == 0 else []), "expert",
            "lm_window"]


def multichip_inputs(n):
    """The numpy inputs of ``dryrun_multichip(n)``'s steps: JAX's shapes,
    JAX's ``default_rng(0)`` pipeline and expert weights and
    ``default_rng(1)`` 3-D blocks, and seeded data (``default_rng(2)``)
    where JAX feeds ones and zeros. On ones a causal attention gives 1
    whatever the ring exchanges, and on zero images only the last bias
    gets a gradient, the same on every rank: such inputs cannot tell a
    missing exchange or all-reduce from a right one."""
    import numpy as np

    names = multichip_step_names(n)
    rng, data = np.random.default_rng(0), np.random.default_rng(2)
    f32 = np.float32

    def normal(*shape):
        return data.standard_normal(shape).astype(f32)

    rows = 2 * n
    out = {"mnist/x": data.uniform(0, 1, (1, rows, 28, 28, 1)).astype(f32),
           "mnist/y": np.eye(10, dtype=f32)[data.integers(0, 10, (1, rows))]}
    t = 8 * n
    for step, shape in (("ring", (1, t, 2, 8)), ("ulysses", (1, t, n, 8)),
                        ("ring_data", (2, 8 * (n // 2), 2, 8))):
        if step in names:
            out.update({f"{step}/{c}": normal(*shape) for c in "qkv"})
    for i in range(n):
        out[f"pipeline/w{i}"] = rng.standard_normal((8, 8)).astype(f32) * 0.3
        out[f"pipeline/b{i}"] = np.zeros(8, f32)
    out["pipeline/x"] = normal(2 * n, 8)
    if "pipe_data" in names:
        out["pipe_data/x"] = normal(4 * (n // 2), 8)
    if "grid_3d" in names:
        rng3 = np.random.default_rng(1)
        for i in range(2):
            out[f"grid_3d/wi{i}"] = rng3.standard_normal((8, 16)).astype(
                f32) * 0.3
            out[f"grid_3d/wo{i}"] = rng3.standard_normal((16, 8)).astype(
                f32) * 0.3
        out["grid_3d/x"] = normal(8, 8)
    out["expert/router"] = rng.standard_normal((8, n)).astype(f32)
    out["expert/wi"] = 0.1 * rng.standard_normal((n, 8, 16)).astype(f32)
    out["expert/wo"] = 0.1 * rng.standard_normal((n, 16, 8)).astype(f32)
    out["expert/x"] = normal(4, 4 * n, 8)
    out["lm/x"] = data.integers(0, 32, (1, 2, t)).astype(np.int32)
    return out


def blocks_of(inputs, step, keys, depth):
    """The ``depth`` blocks {key: array} of ``step`` in ``inputs``."""
    return [{k: inputs[f"{step}/{k}{i}"] for k in keys} for i in range(depth)]


def _check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _digest(tensors):
    """sum |x| over the tensors, in f64: one number a replicated result
    must give on every rank."""
    return float(sum(t.detach().double().abs().sum().item() for t in tensors))


def _max_err(got, want):
    """max |a - b| / max(1, max |b|) over the pairs."""
    err = 0.0
    for a, b in zip(got, want):
        a, b = a.detach().double(), b.detach().double()
        err = max(err, float((a - b).abs().max())
                  / max(1.0, float(b.abs().max())))
    return err


def _finite(tensors):
    import torch

    return all(bool(torch.isfinite(t).all()) for t in tensors)


def _tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensors(v)]
    return [tree] if hasattr(tree, "shape") else []


class _Rank:
    """One rank's run of the steps: the job's group (``world``), the
    rank's device, and what each step reports."""

    def __init__(self, device, arrays):
        import torch

        from distkeras_tpu_torch.parallel.mesh import make_mesh

        self.torch = torch
        self.world = make_mesh(None, device)
        self.n, self.rank = self.world.num_workers, self.world.rank
        self.dev = self.world.device
        self.arrays = arrays
        self.inputs = multichip_inputs(self.n)
        self.records = []

    def t(self, a):
        """A host array on the rank's device."""
        import numpy as np

        return self.torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def keep(self, step, **arrays):
        if self.arrays is not None:
            for k, v in arrays.items():
                self.arrays[f"{step}/{k}"] = (
                    v.detach().cpu().numpy() if hasattr(v, "detach") else v)

    def report(self, step, t0, finite, replicated, errs):
        """The step's line: ``replicated`` (numbers every rank must give
        alike) and ``errs`` (each against one rank's); raises when a value
        is not finite or an error is past ``ONE_RANK_TOL``."""
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)
        _check(finite, f"{step}: a value is not finite on rank {self.rank}")
        for k, e in errs.items():
            _check(e <= ONE_RANK_TOL, f"{step}: {k} {e:.3e} from one rank's "
                   f"(bar {ONE_RANK_TOL}) on rank {self.rank}")
        rec = {"step": step, "rank": self.rank, "n": self.n,
               "device": str(self.dev),
               "seconds": time.perf_counter() - t0,
               "replicated": replicated, "err": errs}
        self.records.append(rec)
        print(STEP_MARK, json.dumps(rec), flush=True)


def _window(r, make, optimizer, lr, loss, x, y, place=None):
    """One window of one step of a ``WorkerCore`` on a fresh model, over
    the ranks ``place(model, core)`` puts it on (it returns the params the
    optimizer runs on and the rank's x and y), or on this rank alone.
    Returns (model, loss, the gradient the optimizer applied, in
    ``model.parameters()`` order)."""
    from distkeras_tpu_torch.ops.optimizers import get_optimizer
    from distkeras_tpu_torch.utils.rng import RngSeq
    from distkeras_tpu_torch.workers import WorkerCore

    model = make()
    core = WorkerCore(model, get_optimizer(optimizer, lr), loss)
    params, xs, ys = list(model.parameters()), x, y
    if place is not None:
        params, xs, ys = place(model, core)
    opt = core.init_opt_state(params)
    _, mets, grads = core.grad_window(model, opt, RngSeq(0), r.t(xs),
                                      r.t(ys))
    return model, mets["loss"][0], grads


def _one_rank_update(make, optimizer, lr, grads):
    """A fresh model's parameters after one step of ``optimizer`` on
    ``grads``, on this rank alone."""
    import torch

    from distkeras_tpu_torch.ops.optimizers import (
        apply_updates,
        get_optimizer,
    )

    params = list(make().parameters())
    opt = get_optimizer(optimizer, lr)
    with torch.no_grad():
        updates, _ = opt.update(list(grads), opt.init(params), params)
        apply_updates(params, updates)
    return params


def _model_report(r, step, t0, got, want, params=None, update=None):
    """A model step's line: its loss against one rank's, and the step
    against one rank's. Without ``update`` (SGD, whose step is lr times
    the gradient) the parameters hold the step. With it (Adam) the step
    is held in two parts: the gradient the optimizer applied against one
    rank's, and the parameters against ``update(that gradient)``, one
    rank's step from it. Adam's first step moves a parameter by
    lr g / (|g| + eps), whose slope at g = 0 is lr / eps = 1e5, so f32
    gradients summed in another order (the card's convolutions pick
    their algorithm by batch size) put a parameter near g = 0 up to
    1e-3 from one rank's."""
    (model, loss, grads), (ref, ref_loss, ref_grads) = got, want
    params = list(model.parameters()) if params is None else params
    errs = {"loss": abs(float(loss) - float(ref_loss))
            / max(abs(float(ref_loss)), 1e-30)}
    if update is None:
        errs["params"] = _max_err(params, list(ref.parameters()))
    else:
        errs["grads"] = _max_err(grads, ref_grads)
        errs["params"] = _max_err(params, update(grads))
    r.report(step, t0, _finite([loss, *params, *grads]),
             {"loss": float(loss), "params": _digest(params)}, errs)


def _mnist_batch(r, rows):
    """The first ``rows`` rows of the seeded MNIST batch: a window of one
    step (JAX's: zero images, class 0)."""
    return r.inputs["mnist/x"][:, :rows], r.inputs["mnist/y"][:, :rows]


def _sync_steps(r):
    """Sync-DP with "sgd" 0.01 and ZeRO-1 with "adam" 1e-3 on
    ``mnist_cnn``, 2 rows a rank (``__graft_entry__.py:116-171``)."""
    from distkeras_tpu_torch.models.zoo import mnist_cnn
    from distkeras_tpu_torch.parallel.mesh import (
        ZeroShards,
        rank_rows,
        shard_opt_state_zero,
    )
    from distkeras_tpu_torch.trainers import place_data_parallel

    world = r.world
    x, y = _mnist_batch(r, 2 * r.n)

    def make():
        return mnist_cnn(seed=0, device=r.dev)

    def data(model, core):
        place_data_parallel(core, model, world)
        return (list(model.parameters()), rank_rows(x, world, axis=1),
                rank_rows(y, world, axis=1))

    def zero(model, core):
        params, xs, ys = data(model, core)
        # an Adam core on purpose: SGD has no moments, and ZeRO-1 would
        # shard nothing
        whole = core.init_opt_state(params)
        cut = shard_opt_state_zero(whole, world)
        _check(r.n == 1 or any(
            a.shape != b.shape for a, b in zip(_tensors(cut), _tensors(whole))),
            "ZeRO block sharded nothing")
        core.zero = ZeroShards(params, world)
        return core.zero.local, xs, ys

    for step, opt, lr, place in (("sync_dp", "sgd", 0.01, data),
                                 ("zero1", "adam", 1e-3, zero)):
        t0 = time.perf_counter()
        got = _window(r, make, opt, lr, "categorical_crossentropy", x, y,
                      place)
        want = _window(r, make, opt, lr, "categorical_crossentropy", x, y)
        _model_report(r, step, t0, got, want, update=(
            lambda g: _one_rank_update(make, "adam", lr, g))
            if opt == "adam" else None)


def _tensor_step(r, device):
    """TP on a (n/2 data x 2 model) grid, one "sgd" step on ``mnist_cnn``
    (``:173-194``)."""
    from distkeras_tpu_torch.models.zoo import mnist_cnn
    from distkeras_tpu_torch.parallel.mesh import rank_rows
    from distkeras_tpu_torch.parallel.tensor_parallel import (
        make_dp_tp_mesh,
        shard_params,
        whole_named_parameters,
    )
    from distkeras_tpu_torch.trainers import place_data_parallel

    t0 = time.perf_counter()
    grid = make_dp_tp_mesh(r.n // 2, 2, device=device)
    x, y = _mnist_batch(r, 2 * (r.n // 2))

    def make():
        return mnist_cnn(seed=0, device=r.dev)

    def place(model, core):
        shard_params(model, grid)
        place_data_parallel(core, model, grid.data)
        return (list(model.parameters()), rank_rows(x, grid.data, axis=1),
                rank_rows(y, grid.data, axis=1))

    got = _window(r, make, "sgd", 0.01, "categorical_crossentropy", x, y,
                  place)
    want = _window(r, make, "sgd", 0.01, "categorical_crossentropy", x, y)
    whole = list(whole_named_parameters(got[0]).values())
    _model_report(r, "tensor", t0, got, want, params=whole)


def _attention_steps(r, device):
    """The ring and Ulysses (heads = n) over the job, causal at T = 8n,
    and the ring inside a data group at 2 x n/2 (``:196-229``), on seeded
    q, k, v: each rank's block of the output against one rank's dense
    attention."""
    import numpy as np

    from distkeras_tpu_torch.parallel.mesh import make_grid, rank_rows
    from distkeras_tpu_torch.parallel.ring_attention import (
        dense_attention,
        ring_attention,
        shard_sequence,
    )
    from distkeras_tpu_torch.parallel.ulysses import ulysses_attention

    def run(step, fn, mesh, rows=None):
        t0 = time.perf_counter()
        qkv = [r.inputs[f"{step}/{c}"] for c in "qkv"]
        mine = [r.t(shard_sequence(a if rows is None else rank_rows(a, rows),
                                   mesh, axis=1)) for a in qkv]
        out = fn(*mine, mesh, causal=True)
        full = dense_attention(*map(r.t, qkv), causal=True)
        want = shard_sequence(full if rows is None else rank_rows(full, rows),
                              mesh, axis=1)
        _check(tuple(out.shape) == tuple(want.shape),
               f"{step}: output {tuple(out.shape)}, not {tuple(want.shape)}")
        r.keep(step, out=out)
        r.report(step, t0, _finite([out]), {}, {"out": _max_err([out],
                                                                 [want])})

    run("ring", ring_attention, r.world)
    run("ulysses", ulysses_attention, r.world)
    if "ring_data" in multichip_step_names(r.n):
        grid = make_grid(2, r.n // 2, "seq", device=device)
        r.keep("ring_data", coords=np.array([grid.data.rank,
                                             grid.inner.rank]))
        run("ring_data", ring_attention, grid, rows=grid.data)


def _pp_block(p, h):
    import torch

    return torch.tanh(h @ p["w"] + p["b"]) + h


def _tower(blocks, x, block=_pp_block):
    for p in blocks:
        x = block(p, x)
    return x


def _stage_report(r, step, t0, stage, whole, out, ref_out, group=None,
                  cut=None):
    """A pipeline step's line: the output (whole on every rank) and the
    stage's gradients (summed over ``group``, the data ranks that split
    the batch) against one rank's gradients of the whole stack, cut to
    the stage by ``cut(leaf name, whole gradient)``."""
    grads = {k: v.grad if group is None else group.all_reduce_(v.grad)
             for k, v in stage.items()}
    r.keep(step, out=out, **{"grad_" + k: g for k, g in grads.items()})
    want = [cut(k, whole[k].grad) for k in grads]
    r.report(step, t0, _finite([out, *grads.values()]),
             {"out": _digest([out])},
             {"out": _max_err([out], [ref_out]),
              "grads": _max_err(list(grads.values()), want)})


def _pipeline_steps(r, device):
    """The pipeline's grad step on ``default_rng(0)`` tanh-residual blocks
    over the job, then pipe x data at n/2 x 2 (``:231-282``), on seeded
    rows."""
    import numpy as np

    from distkeras_tpu_torch.parallel.mesh import make_grid
    from distkeras_tpu_torch.parallel.pipeline_parallel import (
        pipeline_apply,
        shard_stacked_params,
        stack_block_params,
    )

    n = r.n
    blocks = blocks_of(r.inputs, "pipeline", "wb", n)

    def run(step, mesh, depth, batch_axis=None, group=None):
        t0 = time.perf_counter()
        stacked = stack_block_params(blocks[:depth])
        stage = shard_stacked_params(
            {k: r.t(v) for k, v in stacked.items()}, mesh)
        for v in stage.values():
            v.requires_grad_()
        x = r.t(r.inputs[f"{step}/x"])
        out = pipeline_apply(stage, x, _pp_block, mesh,
                             batch_axis=batch_axis)
        out.square().sum().backward()
        whole = {k: r.t(v).requires_grad_() for k, v in stacked.items()}
        ref = _tower([{k: v[i] for k, v in whole.items()}
                      for i in range(depth)], x)
        ref.square().sum().backward()
        pipe = mesh if batch_axis is None else mesh.inner
        per = depth // pipe.num_workers
        _stage_report(r, step, t0, stage, whole, out.detach(), ref.detach(),
                      group, lambda k, g: g[pipe.rank * per:
                                            (pipe.rank + 1) * per])

    run("pipeline", r.world, n)
    if "pipe_data" in multichip_step_names(n):
        grid = make_grid(2, n // 2, "pipe", device=device)
        r.keep("pipe_data", coords=np.array([grid.inner.rank,
                                             grid.data.rank]))
        run("pipe_data", grid, n // 2, batch_axis="data", group=grid.data)


def _grid_3d_step(r, device):
    """The 3-D composition on a 2 x 2 x 2 ``Grid3D`` with
    ``default_rng(1)`` ``wi``/``wo`` blocks, JAX's specs and 2
    microbatches (``:284-316``), on seeded rows."""
    import numpy as np

    from distkeras_tpu_torch.parallel.mesh import make_grid_3d
    from distkeras_tpu_torch.parallel.pipeline_parallel import (
        pipeline_apply,
        shard_stacked_params,
        stack_block_params,
    )
    from distkeras_tpu_torch.parallel.tensor_parallel import PartitionSpec

    torch = r.torch
    t0 = time.perf_counter()
    grid = make_grid_3d(*GRID_3D, device=device)
    blocks = blocks_of(r.inputs, "grid_3d", ("wi", "wo"), 2)
    P = PartitionSpec
    specs = {"wi": P("pipe", None, "model"), "wo": P("pipe", "model", None)}
    model = grid.model

    def tp_block(p, h):
        # Megatron's pair: the split branch reads h through copy_in, its
        # row products sum through reduce_out (JAX: lax.psum over "model")
        part = torch.tanh(model.copy_in(h) @ p["wi"]) @ p["wo"]
        return h + model.reduce_out(part)

    def dense_block(p, h):
        return h + torch.tanh(h @ p["wi"]) @ p["wo"]

    stacked = stack_block_params(blocks)
    stage = shard_stacked_params({k: r.t(v) for k, v in stacked.items()},
                                 grid, param_specs=specs)
    for v in stage.values():
        v.requires_grad_()
    x = r.t(r.inputs["grid_3d/x"])
    out = pipeline_apply(stage, x, tp_block, grid, num_micro=2,
                         batch_axis="data", param_specs=specs)
    out.square().sum().backward()
    whole = {k: r.t(v).requires_grad_() for k, v in stacked.items()}
    ref = _tower([{k: v[i] for k, v in whole.items()} for i in range(2)], x,
                 dense_block)
    ref.square().sum().backward()
    p, m = grid.pipe.rank, model.rank

    def cut(k, g):
        g = g[p:p + 1]
        return g[..., m * 8:(m + 1) * 8] if k == "wi" else g[:, m * 8:
                                                            (m + 1) * 8]

    r.keep("grid_3d", coords=np.array([p, grid.data.rank, m]))
    _stage_report(r, "grid_3d", t0, stage, whole, out.detach(),
                  ref.detach(), grid.data, cut)


def _expert_step(r):
    """Switch-MoE over an expert group of n experts, forward and grad of
    sum(out ** 2) + aux (``:318-337``), on seeded tokens: the output, the
    aux loss and the router's gradient are every rank's, ``wi``/``wo`` the
    rank's experts."""
    from distkeras_tpu_torch.parallel.expert_parallel import (
        moe_ffn,
        shard_moe_params,
    )

    t0 = time.perf_counter()
    params = {k: r.inputs["expert/" + k] for k in ("router", "wi", "wo")}
    x = r.t(r.inputs["expert/x"])

    def grads(p, mesh=None):
        p = {k: v.requires_grad_() for k, v in p.items()}
        out, aux = moe_ffn(p, x, mesh=mesh)
        (out.square().sum() + aux).backward()
        return out.detach(), aux.detach(), {k: v.grad for k, v in p.items()}

    out, aux, got = grads({k: r.t(v) for k, v in
                           shard_moe_params(params, r.world).items()},
                          r.world)
    ref_out, ref_aux, want = grads({k: r.t(v) for k, v in params.items()})
    r.keep("expert", out=out, aux=aux,
           **{"grad_" + k: g for k, g in got.items()})
    e = slice(r.rank, r.rank + 1)  # the rank's one expert of n
    r.report("expert", t0, _finite([out, aux, *got.values()]),
             {"out": _digest([out]), "aux": float(aux),
              "grad_router": _digest([got["router"]])},
             {"out": _max_err([out, aux], [ref_out, ref_aux]),
              "grads": _max_err([got["router"], got["wi"], got["wo"]],
                                [want["router"], want["wi"][e],
                                 want["wo"][e]])})


def _lm_step(r):
    """The causal-LM window: ``transformer_lm(32, 8n, 16, 2, 1)`` with the
    ring attached, "adam" 1e-3 and the next-token loss, the token axis
    split over the job, the shift by one crossing the ranks (``:339-367``),
    placed as ``SequenceParallelTrainer`` places it, on seeded ids."""
    from distkeras_tpu_torch.models.zoo import transformer_lm
    from distkeras_tpu_torch.parallel.mesh import make_grid
    from distkeras_tpu_torch.parallel.ring_attention import shard_sequence
    from distkeras_tpu_torch.trainers import place_seq_parallel

    t0 = time.perf_counter()
    t = 8 * r.n
    grid = make_grid(1, r.n, "seq", device=r.dev, data_axis=False)
    x = r.inputs["lm/x"]

    def make():
        return transformer_lm(vocab_size=32, seq_len=t, d_model=16,
                              num_heads=2, depth=1, seed=0, device=r.dev)

    def place(model, core):
        _check(place_seq_parallel(core, model, grid) == 1,
               "the ring did not attach to the one attention layer")
        # the labels keep the whole sequence: the loss reads the token
        # after the rank's last
        return (list(model.parameters()), shard_sequence(x, grid.inner,
                                                         axis=2), x)

    got = _window(r, make, "adam", 1e-3, "next_token_crossentropy", x, x,
                  place)
    want = _window(r, make, "adam", 1e-3, "next_token_crossentropy", x, x)
    grid.release()
    _model_report(r, "lm_window", t0, got, want, update=lambda g: (
        _one_rank_update(make, "adam", 1e-3, g)))


def multichip_steps(device=None, arrays=None):
    """Every step of ``dryrun_multichip`` on this rank of a joined job (the
    world size is n): each step's line goes to stdout and into the returned
    records. ``device=None`` means the card ``rank % device_count``;
    ``arrays``: a dict that takes each step's outputs and gradients."""
    import torch

    # the one-rank bar is an f32 bar: no TF32 in the convolutions and
    # matmuls of either side, for these steps only
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        r = _Rank(device, arrays)
        names = multichip_step_names(r.n)
        _sync_steps(r)
        if "tensor" in names:
            _tensor_step(r, device)
        _attention_steps(r, device)
        _pipeline_steps(r, device)
        if "grid_3d" in names:
            _grid_3d_step(r, device)
        _expert_step(r)
        _lm_step(r)
        r.world.release()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return r.records


def check_multichip(records):
    """The parent's checks on every rank's step records (a list a rank, in
    rank order): each rank ran every step, every error is within the bar,
    and every replicated number is the same on every rank. Returns
    {step: [record a rank]}."""
    n = len(records)
    names = multichip_step_names(n)
    steps = {}
    for rank, recs in enumerate(records):
        got = [rec["step"] for rec in recs]
        _check(got == names, f"rank {rank} ran {got}, not {names}")
        for rec in recs:
            steps.setdefault(rec["step"], []).append(rec)
    for step, recs in steps.items():
        for rec in recs:
            _check(all(e <= ONE_RANK_TOL for e in rec["err"].values()),
                   f"{step}: rank {rec['rank']} {rec['err']} past "
                   f"{ONE_RANK_TOL}")
            _check(rec["replicated"] == recs[0]["replicated"],
                   f"{step}: rank {rec['rank']} {rec['replicated']} != rank "
                   f"0's {recs[0]['replicated']}")
    return steps


def _multichip_rank(cpu, out_dir):
    """A rank of ``dryrun_multichip``: join, run the steps, print the
    lines, write the arrays to ``out_dir`` when given."""
    t0 = time.perf_counter()
    import numpy as np
    import torch  # noqa: F401

    t_torch = time.perf_counter()
    import distkeras_tpu_torch  # noqa: F401

    t_port = time.perf_counter()
    _join(cpu)
    t_join = time.perf_counter()
    import torch.distributed as dist

    from distkeras_tpu_torch.parallel import multihost

    arrays = {} if out_dir else None
    records = multichip_steps("cpu" if cpu else None, arrays)
    if out_dir:
        np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"),
                 **arrays)
    print(TIMES_MARK, json.dumps({
        "started": time.time() - (time.perf_counter() - t0),
        "import_torch_s": t_torch - t0, "import_port_s": t_port - t_torch,
        "join_s": t_join - t_port, "steps_s": time.perf_counter() - t_join,
        "backend": dist.get_backend(), "device": records[0]["device"]}),
        flush=True)
    multihost.shutdown()


def dryrun_multichip(n, cpu=False, out_dir=None,
                     timeout=MULTICHIP_TIMEOUT):
    """One step of every parallelism over ``n`` rank processes on this
    host (``Job.run_local_all``, at most ``timeout`` seconds), each held
    against the same step on one rank within ``ONE_RANK_TOL``; raises
    with a failed rank's output tail. Ranks go on ``cuda:(rank %
    device_count)`` (gloo where they share a card, NCCL otherwise), or
    are gloo CPU ranks with ``cpu=True``. ``out_dir``: each rank writes
    its outputs and gradients there as ``rank<r>.npz``. Returns {"steps":
    {step: [record a rank]}, "ranks": [start-up record a rank], "wall_s":
    the launch's wall seconds}."""
    n = int(n)
    _check(n >= 1, f"n={n}")
    if n > 8 and n % 8 == 0:
        # JAX's 3-D block takes the first 8 of n devices; a Grid3D spans
        # the whole job
        raise ValueError(
            f"n={n}: the 3-D block runs on 8 of the ranks, and the port's "
            "Grid3D spans every rank of its job; use n <= 8 or n % 8 != 0")
    args = ["--multichip-rank"] + (["--out", os.path.abspath(out_dir)]
                                   if out_dir else [])
    procs, start, wall = _launch(n, args, cpu, timeout, *_free_ports(1))
    times = [t[0] for t in _lines(procs, TIMES_MARK)]
    for t in times:
        t["spawn_s"] = t.pop("started") - start
    return {"steps": check_multichip(_lines(procs, STEP_MARK)),
            "ranks": times, "wall_s": wall}


# ------------------------------------------------------ the multiprocess run


def _multiproc_rank(ps_port, cpu):
    """A rank of ``dryrun_multiprocess``: the sync-DP run across the two
    processes, then the socket PS (rank 0 hosts, rank 1 commits)."""
    import numpy as np

    from distkeras_tpu_torch import (
        MinMaxTransformer,
        OneHotTransformer,
        SynchronousDistributedTrainer,
    )
    from distkeras_tpu_torch.data import loaders
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.optimizers import get_optimizer
    from distkeras_tpu_torch.parallel import multihost
    from distkeras_tpu_torch.parameter_servers import (
        DeltaParameterServer,
        RemoteParameterServerClient,
        SocketParameterServer,
    )
    from distkeras_tpu_torch.workers import DOWNPOURWorker, WorkerCore

    device = "cpu" if cpu else None
    _check(multihost.initialize(device=device, timeout=GROUP_TIMEOUT),
           "the DKT_* env did not make a job")
    _check(multihost.num_processes() == 2, "not a job of two processes")
    t0 = time.perf_counter()
    ds = loaders.synthetic_mnist(n=128, seed=0)
    ds = MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    ds = OneHotTransformer(10, output_col="label_onehot").transform(ds)
    t = SynchronousDistributedTrainer(
        zoo.mnist_mlp(hidden=8, seed=0, device=device), "sgd",
        "categorical_crossentropy", learning_rate=0.05, batch_size=16,
        num_epoch=1, num_workers=2, label_col="label_onehot", seed=0,
        device=device)
    model = t.train(ds, shuffle=True)
    digest = float(sum(float(np.abs(w).sum()) for w in model.get_weights()))
    print("SYNC_DIGEST", repr(digest), flush=True)
    t_sync = time.perf_counter()

    if multihost.is_coordinator():
        ps = DeltaParameterServer(dict(zip(model._leaf_order(),
                                           model.get_weights())))
        srv = SocketParameterServer(ps, host="127.0.0.1", port=ps_port)
        srv.start()
        deadline = time.time() + 120
        while ps.num_updates < 1 and time.time() < deadline:
            time.sleep(0.2)
        commits = ps.num_updates
        srv.stop()
        _check(commits >= 1, "no commit arrived over the socket")
    else:
        client = None
        for _ in range(300):
            try:
                client = RemoteParameterServerClient("127.0.0.1", ps_port)
                break
            except OSError:
                time.sleep(0.2)
        _check(client is not None, "the parameter server never came up")
        core = WorkerCore(model, get_optimizer("sgd", 0.05),
                          "categorical_crossentropy")
        w = DOWNPOURWorker(core, client, 0, "features", "label_onehot", 4,
                           device=device)
        w.train(ds, batch_size=16, num_epoch=1)
        client.close()
        commits = w._seq
    print("PS_COMMITS", commits, flush=True)
    print("MULTIPROC_TIMES", json.dumps({
        "sync_s": t_sync - t0, "ps_s": time.perf_counter() - t_sync}),
        flush=True)
    print("MULTIPROC_OK", flush=True)
    multihost.shutdown()


def dryrun_multiprocess(n_processes=2, cpu=False,
                        timeout=MULTIPROC_TIMEOUT):
    """Two rank processes from ``Job`` (distinct free ports for the group
    and the PS): a ``SynchronousDistributedTrainer`` run across them, then
    one ``DOWNPOURWorker`` on rank 1 committing over TCP to rank 0's
    ``SocketParameterServer``. Asserts both ranks exit 0 and print
    ``MULTIPROC_OK``, their parameter digests are equal and the PS took
    at least one commit; returns {"digests", "commits", "times",
    "wall_s"}."""
    _check(n_processes == 2,
           "the dryrun topology is 2 processes (a PS and a worker)")
    coord, ps_port = _free_ports(2)
    procs, _, wall = _launch(2, ["--multiproc-rank", str(ps_port)], cpu,
                             timeout, coord)
    digests, commits, times = [], [], []
    for i, proc in enumerate(procs):
        _check("MULTIPROC_OK" in proc.stdout, f"rank {i}:\n{proc.stdout}")
        fields = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                      if line.startswith(("SYNC_DIGEST ", "PS_COMMITS ",
                                          "MULTIPROC_TIMES ")))
        digests.append(float(fields["SYNC_DIGEST"]))
        commits.append(int(fields["PS_COMMITS"]))
        times.append(json.loads(fields["MULTIPROC_TIMES"]))
    _check(digests[0] == digests[1], f"rank digests diverged: {digests}")
    _check(min(commits) >= 1, f"commits {commits}")
    return {"digests": digests, "commits": commits, "times": times,
            "wall_s": wall}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (gloo CPU ranks)")
    ap.add_argument("--multiproc", action="store_true",
                    help="also run dryrun_multiprocess(2)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="dryrun_multichip's rank count (default: the "
                         "card count, 1 with --cpu)")
    ap.add_argument("--multichip-rank", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--multiproc-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.multichip_rank:
        return _multichip_rank(args.cpu, args.out)
    if args.multiproc_rank is not None:
        return _multiproc_rank(args.multiproc_rank, args.cpu)
    import torch

    fn, example = entry(cpu=args.cpu)
    print("entry ok:", tuple(fn(*example).shape), flush=True)
    n = args.ranks or (1 if args.cpu else torch.cuda.device_count())
    dryrun_multichip(n, cpu=args.cpu)
    print(f"dryrun_multichip ok ({n} ranks)", flush=True)
    if args.multiproc:
        dryrun_multiprocess(2, cpu=args.cpu)
        print("dryrun_multiprocess ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
