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

The serving half places a causal LM for tensor-parallel decode over a
``ServingMesh`` (``parallel.mesh.serving_mesh``), ONE process driving N
shard devices: Megatron's pairs, QKV by column (so by head) with the
output projection by row, and the MLP's ``fc1`` by column with ``fc2`` by
row (``decode_param_specs``); MoE expert stacks split their expert axis
over the same mesh. ``shard_decode_params`` makes the decode path's own
copies of each shard's leaves on its device; each pair then runs shard by
shard and its row products are summed on the home device (the psum JAX's
partitioner inserts, made explicit in ``predictors.CachedSequenceGenerator``).
"""

from __future__ import annotations

import torch
from torch import nn

from distkeras_tpu_torch.models.sequential import walk_layers
from distkeras_tpu_torch.ops.quantization import Int4Weight, params_tree
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


# -- serving: the decode placement -------------------------------------------
#
# QKV column-sharded (equivalently head-sharded: their output dimension is
# heads x head_dim) with the output projection row-sharded, and the MLP's
# fc1 by column with fc2 by row, so each block runs shard-local until one
# sum of partials per pair returns the activations to the home device.
# Embeddings, LayerNorms and the vocabulary head stay whole, read on the
# home device. MoE expert stacks split their expert axis over the same
# axis (``expert_parallel.moe_group_specs``).


def _pair_specs(spec, leaf, axis_size, axis_name):
    """The spec of one weight of a pair (``spec`` "col" or "row"): an int8
    ``{"q", "s"}`` group shards ``q`` like the f32 matrix, its
    per-output-column scales following a column shard and staying whole
    under a row shard; a packed ``Int4Weight`` stays whole (its two
    values a byte along the in dimension do not split over a row shard).
    A dimension the axis does not divide stays whole rather than raise:
    the head count, the one constraint correctness needs, is checked by
    the stepper before any placement."""
    if isinstance(leaf, Int4Weight):
        return P()
    mat = leaf["q"] if isinstance(leaf, dict) else leaf
    shape = tuple(mat.shape)
    if len(shape) != 2:
        return P()
    d = shape[1] if spec == "col" else shape[0]
    if d % axis_size or d < axis_size:
        return P()
    qspec = P(None, axis_name) if spec == "col" else P(axis_name, None)
    if isinstance(leaf, dict):  # int8 {"q", "s"}
        return {"q": qspec, "s": P(axis_name) if spec == "col" else P()}
    return qspec


def decode_param_specs(params, axis_size, axis_name="model"):
    """Partition specs of a causal LM's params tree (the JAX package's
    layout, ``ops.quantization.params_tree``; a model is read through it)
    under serving tensor parallelism: a tree shaped like ``params`` whose
    leaves are ``PartitionSpec``s (an int8 group expands to per-field
    specs)."""
    from distkeras_tpu_torch.parallel.expert_parallel import (
        is_moe_group,
        moe_group_specs,
    )

    if isinstance(params, nn.Module):
        params = params_tree(params)

    def vec_spec(leaf):
        n = tuple(leaf.shape)
        if len(n) == 1 and n[0] % axis_size == 0 and n[0] >= axis_size:
            return P(axis_name)
        return P()

    def group(node, kind):
        out = {}
        for k, v in node.items():
            if kind == "mhsa" and k in ("wq", "wk", "wv"):
                out[k] = _pair_specs("col", v, axis_size, axis_name)
            elif kind == "mhsa" and k == "wo":
                out[k] = _pair_specs("row", v, axis_size, axis_name)
            elif kind == "fc1" and k == "kernel":
                out[k] = _pair_specs("col", v, axis_size, axis_name)
            elif kind == "fc1" and k == "bias":
                out[k] = vec_spec(v)
            elif kind == "fc2" and k == "kernel":
                out[k] = _pair_specs("row", v, axis_size, axis_name)
            else:
                out[k] = P()  # bo, fc2's bias, anything unrecognized
        return out

    def moe_specs(node):
        tmpl = moe_group_specs(axis_name)
        out = {}
        for k, v in node.items():
            spec = tmpl.get(k, P())
            if spec != P():
                e = v.shape[0] if v.ndim else 0
                if e % axis_size or e < axis_size:
                    spec = P()
            out[k] = spec
        return out

    def walk(node):
        if is_moe_group(node):
            return moe_specs(node)
        if isinstance(node, dict):
            return {k: (group(v, k) if k in ("mhsa", "fc1", "fc2")
                        and isinstance(v, dict) else walk(v))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return P()  # embeddings, LayerNorms, the head, biases: whole

    return walk(params)


def _shard_of(leaf, spec, i, n, device):
    """Shard ``i`` of ``n`` of one leaf under ``spec`` (whole when the spec
    names no axis), a contiguous copy of its own on ``device``."""
    part = leaf.detach()
    for dim, axis in enumerate(spec):
        if axis is not None:
            c = part.shape[dim] // n
            part = part.narrow(dim, i * c, c)
    return part.to(device, copy=True, memory_format=torch.contiguous_format)


def shard_decode_params(model, mesh, axis_name="model"):
    """Place a causal LM for serving decode over ``mesh`` (a
    ``ServingMesh``): one params tree per shard, in the JAX package's
    layout, holding the decode path's OWN contiguous copy of the shard's
    part of every leaf ``decode_param_specs`` splits, on the shard's
    device (a split int8 group's whole scales are copied there too).
    Leaves that stay whole are the model's own, read on the home device.
    The model's parameters, and the predict path reading them, are not
    touched."""
    tree = params_tree(model)
    n = mesh.shape[axis_name]
    specs = decode_param_specs(tree, n, axis_name)

    def place(node, spec, i, dev, split):
        if isinstance(spec, P):
            if spec == P() and not split:
                return node
            return _shard_of(node, spec, i, n, dev)
        if isinstance(node, dict) and "q" in node and "s" in node:
            return {k: place(node[k], spec[k], i, dev, True) for k in node}
        if isinstance(node, dict):
            return {k: place(node[k], spec[k], i, dev, False) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(place(v, s, i, dev, False)
                              for v, s in zip(node, spec))
        return node

    return [place(tree, specs, i, dev, False)
            for i, dev in enumerate(mesh.devices)]


def describe_decode_shardings(params, mesh, axis_name="model"):
    """{"/"-joined path: spec} over ``decode_param_specs`` (tests, docs);
    ``params`` a params tree or a model."""
    specs = decode_param_specs(params, mesh.shape[axis_name], axis_name)
    out = {}

    def walk(node, path):
        if isinstance(node, P):  # before tuple: P subclasses tuple
            out[path] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            out[path] = node

    walk(specs, "")
    return out
