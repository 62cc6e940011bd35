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
