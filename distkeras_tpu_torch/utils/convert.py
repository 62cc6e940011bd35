"""Weight bridge: load the JAX package's ``model.params`` and
``model.state`` into the port.

The JAX trees are nested dicts keyed ``"0".."N"`` then by layer (and
``main_{i}``/``short_{i}`` inside a ``Residual``) and leaf name; the
port's ``state_dict`` keys are the same path joined with dots — the params
tree maps onto ``named_parameters``, the state tree (``BatchNorm``'s
``mean``/``var``) onto ``named_buffers``. Layouts are the JAX ones,
unchanged: ``Dense.kernel`` stays ``(in, out)`` (the port multiplies
``x @ kernel``, it is not an ``nn.Linear``), ``Conv2D.kernel`` stays HWIO,
attention projections stay ``(d, heads*head_dim)`` and
``(heads*head_dim, d)``. So both packages compute the same function on the
same numbers. Quantized leaves are not bridged.

The pipeline trainers keep a homogeneous run of blocks stacked on a
leading block axis under the key ``"__blocks__"`` (JAX's
``PipelineParallelTrainer`` layout); ``stack_blocks`` and
``unstack_blocks`` convert a tree between that layout and the per-layer
one, and ``params_from_jax`` takes either.

``opt_state_from_jax`` brings a JAX optimizer state — optax's chains, as
the port's codec decodes them (anonymous namedtuples), or the fused
optimizers' plain tuples — into the layout the port's optimizer exports
(``export_state``), its leaves in ``model.parameters()`` order, so a
checkpoint the JAX trainers wrote resumes in the port.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            if "q" in v and "s" in v:
                raise NotImplementedError(
                    f"{key}: quantized weights are not bridged; bridge the "
                    "f32 tree and quantize in the port"
                )
            yield from _flatten(v, key + ".")
        else:
            yield key, np.asarray(v)


def _load(own, tree, what, cuts=None):
    """Copy the leaves of ``tree`` into the tensors ``own`` ({name:
    tensor}) in place; keys and shapes must match exactly, after each
    array named in ``cuts`` ({name: fn}) is cut by its function."""
    flat = dict(_flatten(tree))
    for name, cut in (cuts or {}).items():
        if name in flat:
            flat[name] = cut(flat[name])
    missing, extra = sorted(set(own) - set(flat)), sorted(set(flat) - set(own))
    if missing or extra:
        raise ValueError(
            f"{what} do not match the model: missing {missing}, "
            f"unexpected {extra}"
        )
    with torch.no_grad():
        for name, t in own.items():
            arr = flat[name]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(
                    f"{name}: shape {tuple(arr.shape)} != {tuple(t.shape)}"
                )
            host = np.array(arr, dtype=np.float32 if t.is_floating_point()
                            else None)
            t.copy_(torch.from_numpy(host).to(t.dtype))


def _shard_cuts(model):
    """{parameter name: fn} cutting a whole leaf to this rank's shard, for
    each leaf a tensor-parallel model holds split
    (``parallel.tensor_parallel.attach_model_group``: the trailing
    dimension's i-th of K parts)."""
    cuts = {}
    for prefix, layer in model.named_modules():
        group = getattr(layer, "model_group", None)
        for leaf in getattr(layer, "model_split", {}) if group else ():
            def cut(a, k=group.num_workers, i=group.rank):
                a = np.asarray(a)
                c = a.shape[-1] // k
                return a[..., i * c:(i + 1) * c]
            cuts[f"{prefix}.{leaf}" if prefix else leaf] = cut
    return cuts


#: the key of the stacked block run in the pipeline layout
BLOCKS = "__blocks__"


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stacked_depth(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.shape(tree)[0]


def stack_blocks(tree, block_idx):
    """A per-layer tree (``{"0": ..., "1": ...}``, the JAX package's params
    or state layout) -> the pipeline layout: layers ``block_idx`` (one
    structure) stacked on a leading block axis under ``"__blocks__"`` (numpy
    leaves), every other layer as it is."""
    block_idx = [int(i) for i in block_idx]
    parts = [tree[str(i)] for i in block_idx]

    def stack(*leaves):
        return np.stack([np.asarray(a) for a in leaves])

    def zip_map(first, *rest):
        if isinstance(first, dict):
            return {k: zip_map(first[k], *(r[k] for r in rest))
                    for k in first}
        return stack(first, *rest)

    out = {k: v for k, v in tree.items() if int(k) not in block_idx}
    out[BLOCKS] = zip_map(*parts)
    return out


def unstack_blocks(tree, block_idx):
    """Inverse of ``stack_blocks``: the ``"__blocks__"`` leaves split back
    into layers ``block_idx`` (numpy), every other layer as it is."""
    block_idx = [int(i) for i in block_idx]
    stacked = tree[BLOCKS]
    depth = _stacked_depth(stacked)
    if depth != len(block_idx):
        raise ValueError(
            f"{BLOCKS} holds {depth} blocks, the layout names "
            f"{len(block_idx)}"
        )
    out = {k: v for k, v in tree.items() if k != BLOCKS}
    for j, i in enumerate(block_idx):
        out[str(i)] = _map(lambda a, j=j: np.asarray(a)[j], stacked)
    return out


def params_from_jax(model, params):
    """Copy a JAX params tree (leaves as numpy or anything ``np.asarray``
    takes) into ``model``'s parameters in place; returns the model. Keys
    and shapes must match exactly; a tensor-parallel model takes this
    rank's shard of each whole leaf it holds split. A tree in the
    pipeline layout (``"__blocks__"``, JAX's ``PipelineParallelTrainer``)
    is unstacked into the layers it does not name."""
    if BLOCKS in params:
        params = unstack_blocks(params, [i for i in range(len(model.layers))
                                         if str(i) not in params])
    _load(dict(model.named_parameters()), params, "params",
          _shard_cuts(model))
    return model


def state_from_jax(model, state):
    """Copy a JAX state tree (``model.state``: the moving statistics) into
    ``model``'s buffers in place; returns the model. Keys and shapes must
    match exactly."""
    _load(dict(model.named_buffers()), state, "state")
    return model


def _param_leaves(model, tree):
    """A JAX params-shaped tree -> its leaves in ``model.parameters()``
    order (numpy)."""
    flat = dict(_flatten(tree))
    names = [n for n, _ in model.named_parameters()]
    if set(flat) != set(names):
        raise ValueError(
            "optimizer state leaves do not match the model: missing "
            f"{sorted(set(names) - set(flat))}, unexpected "
            f"{sorted(set(flat) - set(names))}"
        )
    return [flat[n] for n in names]


def _optax_fields(state, out):
    """Every field of the namedtuples in an optax chain's state, by name
    (the first of a name wins: the Adam count precedes the schedule's,
    and the two are equal)."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        for name, value in zip(state._fields, state):
            if isinstance(value, tuple) and hasattr(value, "_fields"):
                _optax_fields(value, out)
            else:
                out.setdefault(name, value)
    elif isinstance(state, (list, tuple)):
        for value in state:
            _optax_fields(value, out)
    return out


def opt_state_from_jax(model, optimizer, state):
    """The JAX package's optimizer state for ``model`` in the layout the
    port's ``optimizer`` exports: optax ``sgd`` (its trace), ``adam`` and
    the adamw/adagrad/adadelta/rmsprop/nadam/lamb chains (their moments,
    and the step count where the port keeps one), ``FusedAdam``'s ``(m,
    v, count)`` and ``FusedSGD``'s momenta. Load it with
    ``optimizer.load_state`` or store it as a checkpoint's
    ``opt_state``."""
    from distkeras_tpu_torch.ops import optimizers as opt
    from distkeras_tpu_torch.ops.pallas_kernels import FusedAdam, FusedSGD

    def leaves(tree):
        return _param_leaves(model, tree)

    if isinstance(optimizer, FusedAdam):
        m, v, count = state
        return leaves(m), leaves(v), np.asarray(count)
    if isinstance(optimizer, FusedSGD):
        return leaves(state) if optimizer.momentum else ()
    fields = _optax_fields(state, {})
    if isinstance(optimizer, opt.Adam):
        return (leaves(fields["mu"]), leaves(fields["nu"]),
                np.asarray(fields["count"]))
    if isinstance(optimizer, opt.Sgd):
        inner = leaves(fields["trace"]) if optimizer.momentum else ()
    elif isinstance(optimizer, opt.Adagrad):
        inner = leaves(fields["sum_of_squares"])
    elif isinstance(optimizer, opt.Adadelta):
        inner = leaves(fields["e_g"]), leaves(fields["e_x"])
    elif isinstance(optimizer, opt.RMSProp):
        inner = (leaves(fields["nu"]),
                 () if optimizer.momentum is None else leaves(fields["trace"]))
    else:
        raise TypeError(f"no JAX state layout for {type(optimizer).__name__}")
    if callable(optimizer.learning_rate):
        return inner, np.asarray(fields["count"])
    return inner
