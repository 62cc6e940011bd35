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

The 3-D composition (pipeline x data x tensor, ``param_specs=``) runs on
a ``mesh.Grid3D``: every spec leads with the pipe axis, and a weight
dimension a spec names ``"model"`` is cut to the rank's ``1 / M`` slice
in model-rank order (JAX's ``shard_shape``). ``block_apply`` then sees
the rank's weight shards and owns the model group's collectives, as
JAX's block calls ``lax.psum(..., "model")``: every model rank computes
the same loss, so the block's split branch reads its input through
``model.copy_in`` and returns through ``model.reduce_out`` (Megatron's
pair; ``DataMesh.sum``, whose backward sums the gradients again, would
count them M times). The model ranks of a stage run the lockstep
schedule together, so they call those collectives at every tick, the
bubble ticks too. Each rank's gradients are then JAX's for its shards
over its data rank's rows: summed over the data group they are JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.parallel.mesh import Grid3D, _tree_map


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
    """The group the blocks are split over: a ``Grid3D``'s group of that
    name, a ``GridMesh``'s inner group (its inner axis must be
    ``axis_name``) or a ``DataMesh`` itself."""
    if isinstance(mesh, Grid3D):
        return mesh.axis(axis_name)
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


def _check_specs(param_specs, axis_name, stacked_params):
    """JAX's check: every spec leads with the pipe block axis; and the
    spec tree has the stack's structure."""
    if not _same_tree(stacked_params, param_specs):
        raise ValueError(
            "param_specs must give one spec for each leaf of the stacked "
            "params, in the same tree"
        )
    for spec in _spec_leaves(param_specs):
        if not spec or spec[0] != axis_name:
            raise ValueError(
                f"param_specs must lead with the {axis_name!r} block "
                f"axis, got {spec}"
            )


def _spec_leaves(specs):
    """The specs of a spec tree: a tuple of axis names (or None) is one
    spec (a ``PartitionSpec`` or a plain tuple), dicts and lists nest."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    if isinstance(specs, list) or (
            isinstance(specs, tuple)
            and any(isinstance(v, (dict, list, tuple)) for v in specs)):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def _same_tree(tree, specs):
    if isinstance(tree, dict):
        return (isinstance(specs, dict) and specs.keys() == tree.keys()
                and all(_same_tree(tree[k], specs[k]) for k in tree))
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return (isinstance(specs, (list, tuple)) and len(specs) == len(tree)
                and all(_same_tree(t, x) for t, x in zip(tree, specs)))
    return _spec_leaves(specs) == [specs]


def _stage_of(stacked_params, mesh, axis_name, param_specs, copy):
    """This rank's part of the whole stack: its ``depth / S`` blocks and,
    on each later dimension a leaf's spec names a mesh axis, its slice in
    that group's rank order. ``copy``: contiguous copies, else views (the
    gradients then land in the whole stack)."""
    group = _pipe_group(mesh, axis_name)
    depth = _leaves(stacked_params)[0].shape[0]
    _check_depth(depth, group.num_workers, axis_name)
    n = depth // group.num_workers

    def cut(a, spec=()):
        part = a[group.rank * n:(group.rank + 1) * n]
        for dim, name in enumerate(tuple(spec)[1:], start=1):
            if name is None:
                continue
            if not isinstance(mesh, Grid3D):
                raise ValueError(
                    f"param_specs name the {name!r} axis: pass a Grid3D "
                    "(parallel.mesh.make_grid_3d)"
                )
            g = mesh.axis(name)
            if part.shape[dim] % g.num_workers:
                raise ValueError(
                    f"dimension {dim} of a leaf of shape {tuple(a.shape)} "
                    f"not divisible by mesh axis {name}={g.num_workers}"
                )
            k = part.shape[dim] // g.num_workers
            part = part[(slice(None),) * dim + (slice(g.rank * k,
                                                      (g.rank + 1) * k),)]
        if not copy:
            return part
        if isinstance(part, torch.Tensor):
            return part.contiguous()
        return np.ascontiguousarray(part)

    if param_specs is None:
        return _tree_map(cut, stacked_params), depth
    return _tree_map(cut, stacked_params, param_specs), depth


def shard_stacked_params(stacked_params, mesh, axis_name="pipe",
                         param_specs=None):
    """This rank's stage of a stacked block tree: rank i of the pipe
    group keeps blocks ``[i*depth/S, (i+1)*depth/S)``, each leaf a
    contiguous copy (a ``StageParams`` that remembers ``depth``).
    ``param_specs`` (a tree of ``PartitionSpec``s or tuples matching the
    stack, each leading with ``axis_name``): the 3-D composition, each
    leaf also cut to the rank's slice on every dimension its spec names
    a mesh axis (module docstring)."""
    if param_specs is not None:
        _check_specs(param_specs, axis_name, stacked_params)
    stage, depth = _stage_of(stacked_params, mesh, axis_name, param_specs,
                             copy=True)
    out = StageParams(stage)
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
    on every rank).

    ``param_specs``: the 3-D composition on a ``Grid3D`` (module
    docstring): every spec must lead with ``axis_name`` (a ``ValueError``
    before any collective); a whole stack is cut to the rank's shards,
    and ``block_apply`` sees them and owns the model group's
    collectives."""
    if param_specs is not None:
        _check_specs(param_specs, axis_name, stacked_params)
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
        stage, _ = _stage_of(stacked_params, mesh, axis_name, param_specs,
                             copy=False)
    if data is None:
        return pipeline_stage(stage, x, block_apply, group, num_micro)
    part = mb // data.num_workers
    x_micro = x.reshape(num_micro, mb, *x.shape[1:])
    mine = x_micro[:, data.rank * part:(data.rank + 1) * part]
    out = pipeline_stage(stage, mine.reshape(num_micro * part, *x.shape[1:]),
                         block_apply, group, num_micro)
    out = data.gather(out.reshape(num_micro, part, *out.shape[1:]), 1)
    return out.reshape(batch, *out.shape[2:])
