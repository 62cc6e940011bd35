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


def _load(own, tree, what):
    """Copy the leaves of ``tree`` into the tensors ``own`` ({name:
    tensor}) in place; keys and shapes must match exactly."""
    flat = dict(_flatten(tree))
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


def params_from_jax(model, params):
    """Copy a JAX params tree (leaves as numpy or anything ``np.asarray``
    takes) into ``model``'s parameters in place; returns the model. Keys
    and shapes must match exactly."""
    _load(dict(model.named_parameters()), params, "params")
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
