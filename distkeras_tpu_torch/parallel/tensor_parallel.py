"""Tensor parallelism (TP) for training: parameters split over a "model"
group (PyTorch port of the training half of
``distkeras_tpu.parallel.tensor_parallel``).

The JAX package annotates each leaf with a ``PartitionSpec`` and lets
GSPMD insert the activation collectives. The port runs one process per
rank of a 2-D (data, model) grid (``make_dp_tp_mesh``) and makes them
explicit: each rank stores ONLY its shard of every leaf the rule splits
(``leaf_partition_spec``: the trailing dimension), as a contiguous
parameter of its own, so the fused optimizer kernels see plain leaves and
the optimizer moments live on the shards. ``Dense``, ``Conv2D``,
``Embedding`` and the attention projections then compute their own output
columns and gather them over the model group; the input enters through a
copy whose backward sums the ranks' input gradients; a split 1-D leaf a
layer needs whole (``LayerNorm``'s, ``BatchNorm``'s ``gamma``/``beta``)
is gathered at use (``models.layers``). ``MoE`` computes its columns of
the router logits, of the experts' hidden activations and of their
output, and gathers each (``parallel.expert_parallel``). Everything after a gather is
computed alike on every rank of the model group, so each holds the whole
gradient of what it stores: the trainer reduces gradients over the data
group only.

The serving placement (``decode_param_specs``, ``shard_decode_params``,
Megatron's paired column/row split) is ROADMAP A13 item 5.
"""

from __future__ import annotations

import torch
from torch import nn

from distkeras_tpu_torch.models.sequential import walk_layers
from distkeras_tpu_torch.parallel.mesh import GridMesh, make_grid


class PartitionSpec(tuple):
    """The sharding of one leaf: one entry per dimension, an axis name or
    None (replicated) — JAX's ``PartitionSpec`` as a plain tuple, without
    trailing Nones (``P()`` replicates)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def make_dp_tp_mesh(data_parallel, model_parallel, device=None) -> GridMesh:
    """The (data, model) grid of ``data_parallel * model_parallel`` ranks
    (the job's world size; rank ``d * model_parallel + i``)."""
    return make_grid(data_parallel, model_parallel, "model", device)


def leaf_partition_spec(shape, axis_size, axis_name="model", min_elems=2):
    """Sharding rule for one parameter leaf: shard the trailing (output)
    dimension over the model axis when divisible and at least
    ``min_elems``, else replicate. Covers Dense kernels (in, out), conv
    kernels (H, W, in, out) and their bias vectors (out,), so a layer's
    output and its bias carry the same split."""
    shape = tuple(shape)
    if len(shape) >= 2 and shape[-1] % axis_size == 0 and shape[-1] >= min_elems:
        return P(*([None] * (len(shape) - 1)), axis_name)
    if len(shape) == 1 and shape[0] % axis_size == 0 and shape[0] >= min_elems:
        return P(axis_name)
    return P()


def _model_group(mesh, axis_name="model"):
    if isinstance(mesh, GridMesh):
        if mesh.axis_names[-1] != axis_name:
            raise ValueError(f"mesh {mesh.shape} has no {axis_name!r} axis")
        return mesh.inner
    return mesh


def _owner(model, name):
    """(layer, leaf name) of a parameter name."""
    prefix, _, leaf = name.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), leaf


def whole_shapes(model):
    """{parameter name: whole shape}, leaves split over a model group
    (``model_split``) or an expert group (``MoE.expert_split``) at their
    whole shape."""
    out = {}
    for name, p in model.named_parameters():
        layer, leaf = _owner(model, name)
        split = {**getattr(layer, "model_split", {}),
                 **getattr(layer, "expert_split", {})}
        out[name] = tuple(split.get(leaf, p.shape))
    return out


def describe_shardings(model, mesh, axis_name="model"):
    """{parameter name: spec} of a model, whole or split — introspection
    and tests."""
    size = _model_group(mesh, axis_name).num_workers
    return {name: leaf_partition_spec(shape, size, axis_name)
            for name, shape in whole_shapes(model).items()}


def shard_leaf(whole, group):
    """This rank's shard (the trailing dimension's i-th of K parts) of a
    whole leaf, contiguous."""
    c = whole.shape[-1] // group.num_workers
    return whole[..., group.rank * c:(group.rank + 1) * c].contiguous()


#: the layers whose forward computes from split leaves (``models.layers``)
_SPLIT_LAYERS = frozenset({"Dense", "Conv2D", "Embedding", "LayerNorm",
                           "BatchNorm", "MultiHeadSelfAttention", "MoE"})


def attach_model_group(model, mesh, axis_name="model") -> int:
    """Split the model over the model group of ``mesh`` in place: every
    leaf ``leaf_partition_spec`` shards is replaced by this rank's shard
    (a contiguous parameter of its own) and its layer computes through
    the group. Returns the number of leaves split; ``detach_model_group``
    gathers them back whole. Raises for a layer that holds a split leaf
    and has no tensor-parallel forward before it changes anything."""
    group = _model_group(mesh, axis_name)
    if group.num_workers <= 1:
        return 0
    plan = []
    for layer in walk_layers(model):
        names = [name for name, p in layer.named_parameters(recurse=False)
                 if leaf_partition_spec(p.shape, group.num_workers,
                                        axis_name) != P()]
        if names:
            kind = type(layer).__name__
            if kind not in _SPLIT_LAYERS:
                raise NotImplementedError(
                    f"{kind} has no tensor-parallel forward")
            plan.append((layer, names))
    for layer, names in plan:
        split = {}
        for name in names:
            p = getattr(layer, name)
            split[name] = tuple(p.shape)
            setattr(layer, name, nn.Parameter(shard_leaf(p.detach(), group)))
        layer.model_group, layer.model_split = group, split
    return sum(len(names) for _, names in plan)


def detach_model_group(model, gather=True):
    """Undo ``attach_model_group``: with ``gather`` every split leaf is
    all-gathered back whole (every rank of the group must call it, in
    the same order); without, the groups are only dropped (after a failed
    run, when the peers may be gone)."""
    for layer in walk_layers(model):
        group = getattr(layer, "model_group", None)
        if group is None:
            continue
        if gather:
            with torch.no_grad():
                for name in layer.model_split:
                    whole = group.gather(getattr(layer, name).detach(), -1)
                    setattr(layer, name, nn.Parameter(whole))
        layer.model_group, layer.model_split = None, {}


def whole_named_parameters(model):
    """{name: whole tensor} of a (possibly split) model, leaves split over
    a model group all-gathered along their trailing dimension and those
    split over an expert group along their leading one (collectives
    every rank of the group joins)."""
    out = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            layer, leaf = _owner(model, name)
            p = p.detach()
            if leaf in getattr(layer, "model_split", {}):
                p = layer.model_group.gather(p, -1)
            elif leaf in getattr(layer, "expert_split", {}):
                p = layer.expert_group.gather(p, 0)
            out[name] = p
    return out


def shard_params(model, mesh, axis_name="model"):
    """Place a model on the grid with TP shardings
    (``attach_model_group``); returns the model."""
    attach_model_group(model, mesh, axis_name)
    return model
