"""Worker-optimizer resolution (PyTorch port of
``distkeras_tpu.ops.optimizers``): Keras-style names -> update rules.

The JAX package resolves names to ``optax`` transforms. Here each name
resolves to an object with the same two-step protocol — ``init(params)``
and ``update(grads, state, params) -> (updates, state)``, applied by
``apply_updates`` — whose arithmetic is optax's, operation for operation
(not ``torch.optim``'s, which differs in where eps sits, in the bias
correction and in the momentum convention). Fused-apply optimizers
(``FusedAdam``) expose ``fused_apply`` instead, as in the JAX package.
Parameters, grads and states are lists of tensors in one order; step
counts live on the device as int32, as optax keeps them.

Ported: "sgd" (momentum, nesterov), "adam", "pallas_adam". The other names
of the table and ``get_schedule`` raise until they are ported.
"""

from __future__ import annotations

import torch


class GradientTransformation:
    """The port's counterpart of ``optax.GradientTransformation``."""

    def init(self, params):
        raise NotImplementedError

    def update(self, grads, state, params=None):
        raise NotImplementedError


def apply_updates(params, updates):
    """p <- p + u in place (``optax.apply_updates``: the sum in the
    parameter's dtype)."""
    with torch.no_grad():
        for p, u in zip(params, updates, strict=True):
            p.add_(u.to(p.dtype))
    return params


class Sgd(GradientTransformation):
    """``optax.sgd``: ``trace(momentum, nesterov)`` then ``scale(-lr)``;
    without momentum just ``scale(-lr)``. State: the trace list (or
    ``()``)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, nesterov=False):
        self.learning_rate = float(learning_rate)
        self.momentum = float(momentum or 0.0)
        self.nesterov = bool(nesterov)

    def init(self, params):
        if not self.momentum:
            return ()
        return [torch.zeros_like(p) for p in params]

    def update(self, grads, state, params=None):
        lr = self.learning_rate
        if not self.momentum:
            return [-lr * g for g in grads], state
        mu = self.momentum
        trace = [g + mu * t for g, t in zip(grads, state)]
        if self.nesterov:
            upd = [g + mu * t for g, t in zip(grads, trace)]
        else:
            upd = trace
        return [-lr * u for u in upd], trace


class Adam(GradientTransformation):
    """``optax.adam`` (``scale_by_adam`` then ``scale(-lr)``, eps_root 0):
    mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, count += 1,
    u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps).
    State: (mu list, nu list, count int32 device scalar)."""

    def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8):
        self.learning_rate = float(learning_rate)
        self.b1 = float(b1)
        self.b2 = float(b2)
        self.eps = float(eps)

    def init(self, params):
        params = list(params)
        return (
            [torch.zeros_like(p) for p in params],
            [torch.zeros_like(p) for p in params],
            torch.zeros((), dtype=torch.int32, device=params[0].device),
        )

    def update(self, grads, state, params=None):
        mus, nus, count = state
        b1, b2 = self.b1, self.b2
        mus = [(1 - b1) * g + b1 * m for g, m in zip(grads, mus)]
        nus = [(1 - b2) * (g * g) + b2 * n for g, n in zip(grads, nus)]
        count = count + 1
        t = count.to(torch.float32)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        upd = [
            -self.learning_rate
            * ((m / bc1) / (torch.sqrt(n / bc2) + self.eps))
            for m, n in zip(mus, nus)
        ]
        return upd, (mus, nus, count)


def _sgd(learning_rate=0.01, momentum=0.0, nesterov=False):
    return Sgd(learning_rate, momentum=momentum, nesterov=nesterov)


def _pallas_sgd(learning_rate=0.01, momentum=0.0, nesterov=False):
    """Kernels B1/B2: ``FusedSGD`` raises until they are ported."""
    from distkeras_tpu_torch.ops.pallas_kernels import FusedSGD

    return FusedSGD(learning_rate, momentum=momentum, nesterov=nesterov)


def _pallas_adam(learning_rate=1e-3, **kwargs):
    """Fused single-pass Adam, kernel B3 (see ops/pallas_kernels.py);
    numerically identical to "adam" up to rounding."""
    from distkeras_tpu_torch.ops.pallas_kernels import FusedAdam

    return FusedAdam(learning_rate, **kwargs)


def _not_ported(name):
    def make(*args, **kwargs):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet; ported: sgd, adam, "
            "pallas_adam"
        )

    return make


_OPTIMIZERS = {
    "sgd": _sgd,
    "pallas_sgd": _pallas_sgd,
    "pallas_adam": _pallas_adam,
    "adam": Adam,
    **{name: _not_ported(name) for name in (
        "adamw", "adagrad", "adadelta", "rmsprop", "nadam", "lamb",
    )},
}

_DEFAULT_LR = {"sgd": 0.01, "pallas_sgd": 0.01, "pallas_adam": 1e-3,
               "adam": 1e-3, "adamw": 1e-3,
               "adagrad": 1e-2, "adadelta": 1e-3, "rmsprop": 1e-3,
               "nadam": 1e-3, "lamb": 1e-3}


def get_schedule(name, **kwargs):
    """Named learning-rate schedules: not ported yet (a callable passes
    through, as in the JAX package)."""
    if callable(name):
        return name
    raise NotImplementedError(
        f"learning-rate schedule {name!r} is not ported yet"
    )


def effective_learning_rate(name, learning_rate=None) -> float:
    """The lr the resolved optimizer will actually run with.

    Algorithms whose PS/elastic rules scale by the learning rate (AEASGD's
    alpha = rho*lr, ADAG's commit -lr/W) must use the same value the local
    optimizer steps with. A schedule contributes its step-0 value. For
    callables/ready-made transforms the lr cannot be introspected; fall
    back to 0.01 (callers should pass learning_rate explicitly then).
    """
    if learning_rate is not None:
        if callable(learning_rate):  # a schedule
            return float(learning_rate(0))
        return float(learning_rate)
    if isinstance(name, str) and name.lower() in _DEFAULT_LR:
        return _DEFAULT_LR[name.lower()]
    return 0.01


def get_optimizer(name, learning_rate=None, **kwargs):
    """Resolve a name/transform to an update rule. Ready-made objects with
    the ``init``/``update`` or ``init``/``fused_apply`` protocol pass
    through; a callable is called with the learning rate."""
    if hasattr(name, "init") and (hasattr(name, "update")
                                  or hasattr(name, "fused_apply")):
        return name
    if callable(name):
        return name(learning_rate, **kwargs) if learning_rate is not None else name(**kwargs)
    key = str(name).lower()
    if key not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; known: {sorted(_OPTIMIZERS)}")
    lr = learning_rate if learning_rate is not None else _DEFAULT_LR[key]
    return _OPTIMIZERS[key](lr, **kwargs)
