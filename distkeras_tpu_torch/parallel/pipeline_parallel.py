"""Pipeline parallelism: GPipe microbatching over a "pipe" group (PyTorch
port of ``distkeras_tpu.parallel.pipeline_parallel``).

The JAX package stacks a homogeneous block tower's parameters on a
leading block axis sharded over a ``"pipe"`` mesh axis and runs the
schedule under ``shard_map``: at tick t every stage applies its blocks to
the microbatch it holds and passes the activation one hop down the ring
(``lax.ppermute``); after ``num_micro + S - 1`` ticks every microbatch has
crossed every stage, and a masked ``psum`` returns the last stage's
outputs on every device. Gradients flow back through the ring (the
reverse hop).

The port runs one process per rank of the pipe group and keeps JAX's
lockstep schedule: every stage computes at every tick (the bubble ticks
on inputs that are masked out), so every rank builds the same autograd
graph and calls each collective's backward in the same order. Stage 0
takes microbatch t through a ``torch.where`` on a rank flag (the other
stages take what arrived), the hop is ``DataMesh.ring_step`` (its backward
is the reverse hop), and the last stage's outputs reach every rank through
an all-gather over the group of which every rank keeps the last stage's
part: its backward hands each rank the gradient of its own part only, so
the loss every rank computes from the outputs counts once, as JAX's
replicated output does. Each rank holds ``depth / S`` consecutive blocks
(``shard_stacked_params``).

Left out: ``param_specs`` (3-D pipeline x data x tensor composition,
which JAX's trainer never passes; ROADMAP Queue A).
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.parallel.mesh import _tree_map

_PARAM_SPECS = (
    "param_specs (pipeline x tensor composition) is not ported; see "
    "ROADMAP Queue A"
)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def stack_block_params(block_params: list):
    """List of per-block param trees (one structure; tensors or arrays)
    -> one tree with a leading block axis."""
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack([np.asarray(x) for x in xs])

    return _tree_map(stack, *block_params)


def unstack_block_params(stacked) -> list:
    """Inverse of :func:`stack_block_params`."""
    depth = _leaves(stacked)[0].shape[0]
    return [_tree_map(lambda a, i=i: a[i], stacked) for i in range(depth)]


class StageParams(dict):
    """One rank's stage of a stacked block tree: the tree's leaves cut to
    the rank's ``depth / S`` consecutive blocks, with the whole tower's
    ``depth``."""

    depth: int = 0


def _pipe_group(mesh, axis_name):
    """The group the blocks are split over: a ``GridMesh``'s inner group
    (its inner axis must be ``axis_name``) or a ``DataMesh`` itself."""
    if hasattr(mesh, "inner"):
        if mesh.inner_name != axis_name:
            raise ValueError(f"mesh {mesh.shape} has no {axis_name!r} axis")
        return mesh.inner
    return mesh


def _check_depth(depth, size, axis_name):
    if depth % size:
        raise ValueError(
            f"block depth {depth} not divisible by mesh axis "
            f"{axis_name}={size}"
        )


def shard_stacked_params(stacked_params, mesh, axis_name="pipe",
                         param_specs=None):
    """This rank's stage of a stacked block tree: rank i of the pipe
    group keeps blocks ``[i*depth/S, (i+1)*depth/S)``, each leaf a
    contiguous copy (a ``StageParams`` that remembers ``depth``)."""
    if param_specs is not None:
        raise NotImplementedError(_PARAM_SPECS)
    group = _pipe_group(mesh, axis_name)
    depth = _leaves(stacked_params)[0].shape[0]
    _check_depth(depth, group.num_workers, axis_name)
    n = depth // group.num_workers

    def cut(a):
        part = a[group.rank * n:(group.rank + 1) * n]
        if isinstance(part, torch.Tensor):
            return part.contiguous()
        return np.ascontiguousarray(part)

    out = StageParams(_tree_map(cut, dict(stacked_params)))
    out.depth = depth
    return out


def pipeline_stage(stage_params, x, block_apply, group, num_micro):
    """The GPipe schedule on one rank of the pipe ``group`` (module
    docstring): ``stage_params`` is this rank's (depth/S, ...) block stack,
    ``x`` the batch (B, ...) with B divisible by ``num_micro``; every rank
    passes the same x (stage 0 reads it). Returns the (B, ...) outputs of
    the whole tower on every rank."""
    s, stage = group.num_workers, group.rank
    batch = x.shape[0]
    if batch % num_micro:
        raise ValueError(
            f"batch {batch} not divisible by num_micro={num_micro}"
        )
    x_micro = x.reshape(num_micro, batch // num_micro, *x.shape[1:])
    local = _leaves(stage_params)[0].shape[0]
    blocks = [_tree_map(lambda a, i=i: a[i], stage_params)
              for i in range(local)]
    first = torch.tensor(stage == 0, device=x.device)
    ticks = num_micro + s - 1
    h = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(ticks):
        # stage 0 injects microbatch t; the others take what arrived
        h = torch.where(first, x_micro[min(t, num_micro - 1)], h)
        for p in blocks:
            h = block_apply(p, h)
        if t >= s - 1:  # the last stage finished microbatch t - S + 1
            outs.append(h)
        if t < ticks - 1:
            h = group.ring_step(h)
    out = torch.stack(outs)
    # every rank's outputs gathered, the last stage's kept: the backward
    # gives the last stage the gradient of the loss once
    out = group.gather(out[None], 0)[s - 1]
    return out.reshape(batch, *out.shape[2:])


def pipeline_apply(stacked_params, x, block_apply, mesh, axis_name="pipe",
                   num_micro=None, batch_axis=None, param_specs=None):
    """Run ``x`` through the stacked block tower, pipelined over the pipe
    group of ``mesh`` (a ``GridMesh`` with a ``axis_name`` axis, or the
    group itself); every rank of the job calls it.

    stacked_params: the whole stack (leading block axis ``depth``,
    divisible by the group size S; each rank runs its depth/S blocks) or
    this rank's ``shard_stacked_params`` stage. x: (batch, ...), the same
    on every rank; batch must be divisible by ``num_micro`` (default S).
    block_apply: ``block_apply(one_block_params, h) -> h``. Returns
    (batch, ...) on every rank, the values of applying the blocks in
    sequence (GPipe is a schedule, not an approximation).

    ``batch_axis``: the mesh's data axis (2-D pipeline x data): each data
    rank pipelines its part of every microbatch through its own ring and
    the outputs are gathered over the data group (the whole batch again
    on every rank)."""
    if param_specs is not None:
        raise NotImplementedError(_PARAM_SPECS)
    group = _pipe_group(mesh, axis_name)
    if isinstance(stacked_params, StageParams):
        depth, stage = stacked_params.depth, stacked_params
    else:
        depth, stage = _leaves(stacked_params)[0].shape[0], None
    _check_depth(depth, group.num_workers, axis_name)
    num_micro = int(num_micro or group.num_workers)
    batch = x.shape[0]
    if batch % num_micro:
        raise ValueError(
            f"batch {batch} not divisible by num_micro={num_micro}"
        )
    mb = batch // num_micro
    data = mesh.data if batch_axis is not None else None
    if data is not None and mb % data.num_workers:
        raise ValueError(
            f"microbatch {mb} not divisible by mesh axis "
            f"{batch_axis}={data.num_workers}"
        )
    if stage is None:
        n = depth // group.num_workers
        stage = _tree_map(lambda a: a[group.rank * n:(group.rank + 1) * n],
                          stacked_params)
    if data is None:
        return pipeline_stage(stage, x, block_apply, group, num_micro)
    part = mb // data.num_workers
    x_micro = x.reshape(num_micro, mb, *x.shape[1:])
    mine = x_micro[:, data.rank * part:(data.rank + 1) * part]
    out = pipeline_stage(stage, mine.reshape(num_micro * part, *x.shape[1:]),
                         block_apply, group, num_micro)
    out = data.gather(out.reshape(num_micro, part, *out.shape[1:]), 1)
    return out.reshape(batch, *out.shape[2:])
