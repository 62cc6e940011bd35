"""Worker-optimizer resolution (PyTorch port of
``distkeras_tpu.ops.optimizers``): Keras-style names -> update rules, and
the named learning-rate schedules.

The JAX package resolves names to ``optax`` transforms. Here each name
resolves to an object with the same two-step protocol — ``init(params)``
and ``update(grads, state, params) -> (updates, state)``, applied by
``apply_updates`` — whose arithmetic is optax's, operation for operation
(not ``torch.optim``'s, which differs in where eps sits, in the bias
correction, in adagrad's initial accumulator, in nadam's momentum form
and in the momentum convention). Fused-apply optimizers (``FusedSGD``,
``FusedAdam``) expose ``fused_apply`` instead, as in the JAX package.
Parameters, grads and states are lists of tensors in one order; step
counts live on the device as int32, as optax keeps them.

A learning rate is a float or a schedule — a function of the step count,
evaluated at the count before it is incremented (optax's
``scale_by_learning_rate``: the first step uses ``schedule(0)``). Each
rule's state gains a count only where it needs one: the Adam family has
its own; the others carry ``(state, count)`` under a schedule and their
float-lr layout otherwise.

Every optimizer exports its state for a checkpoint (``export_state``) and
loads a saved one into its live buffers in place (``load_state``), so
kernels that keep pointers to those buffers stay valid across a resume.
"""

from __future__ import annotations

import math

import torch

from distkeras_tpu_torch.utils.tree import copy_tree_


class StateIO:
    """Checkpoint face of an optimizer state: the saved layout is the live
    one unless a subclass says otherwise."""

    def export_state(self, state):
        """The state as a checkpoint stores it."""
        return state

    def load_state(self, state, saved):
        """Copy an exported state into the live ``state``'s buffers in
        place; returns ``state``."""
        copy_tree_(state, saved)
        return state


class GradientTransformation(StateIO):
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


def _learning_rate(learning_rate):
    """A float, or a schedule kept as given."""
    return learning_rate if callable(learning_rate) else float(learning_rate)


def _count(params):
    """A fresh int32 step count on the parameters' device."""
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def _scale(lr, updates):
    """``scale(-lr)``: -lr times each update (lr a float or a 0-d tensor)."""
    return [-lr * u for u in updates]


class _Scheduled(GradientTransformation):
    """A rule whose updates end in ``scale(-lr)``; under a schedule the
    state is ``(inner, count)``, else ``inner``. Subclasses give
    ``_init(params) -> inner`` and ``_update(grads, inner, params, lr) ->
    (lr-scaled updates, inner)``."""

    def __init__(self, learning_rate):
        self.learning_rate = _learning_rate(learning_rate)

    def init(self, params):
        params = list(params)
        inner = self._init(params)
        if callable(self.learning_rate):
            return inner, _count(params)
        return inner

    def update(self, grads, state, params=None):
        if not callable(self.learning_rate):
            return self._update(grads, state, params, self.learning_rate)
        inner, count = state
        upd, inner = self._update(grads, inner, params,
                                  self.learning_rate(count))
        return upd, (inner, count + 1)


def _trace(grads, trace, mu, nesterov):
    """``optax.trace``: t' = g + mu t; the update is g + mu t' (Nesterov)
    or t'. Returns (updates, t')."""
    trace = [g + mu * t for g, t in zip(grads, trace)]
    if nesterov:
        return [g + mu * t for g, t in zip(grads, trace)], trace
    return trace, trace


class Sgd(_Scheduled):
    """``optax.sgd``: ``trace(momentum, nesterov)`` then ``scale(-lr)``;
    without momentum just ``scale(-lr)``. Inner state: the trace list (or
    ``()``)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, nesterov=False):
        super().__init__(learning_rate)
        self.momentum = float(momentum or 0.0)
        self.nesterov = bool(nesterov)

    def _init(self, params):
        if not self.momentum:
            return ()
        return [torch.zeros_like(p) for p in params]

    def _update(self, grads, trace, params, lr):
        if not self.momentum:
            return _scale(lr, grads), trace
        upd, trace = _trace(grads, trace, self.momentum, self.nesterov)
        return _scale(lr, upd), trace


class Adam(GradientTransformation):
    """``optax.scale_by_adam`` (eps_root 0) then ``scale(-lr)``:
    mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, count += 1,
    u = mu_hat / (sqrt(nu / (1 - b2^count)) + eps) with
    mu_hat = mu / (1 - b1^count). State: (mu list, nu list, count int32
    device scalar); a schedule is evaluated at the count before the step.

    The Adam family shares it: ``nesterov`` is nadam's
    mu_hat = b1 mu / (1 - b1^(count+1)) + (1-b1) g / (1 - b1^count);
    ``weight_decay`` (adamw, lamb) adds wd * p after the Adam scaling
    (``add_decayed_weights``); ``trust_ratio`` (lamb) then scales each
    leaf's update by ||p|| / ||u|| (1 where either norm is 0,
    ``scale_by_trust_ratio``)."""

    def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 nesterov=False, weight_decay=None, trust_ratio=False):
        self.learning_rate = _learning_rate(learning_rate)
        self.b1 = float(b1)
        self.b2 = float(b2)
        self.eps = float(eps)
        self.nesterov = bool(nesterov)
        self.weight_decay = (None if weight_decay is None
                             else float(weight_decay))
        self.trust_ratio = bool(trust_ratio)

    def init(self, params):
        params = list(params)
        return (
            [torch.zeros_like(p) for p in params],
            [torch.zeros_like(p) for p in params],
            _count(params),
        )

    def update(self, grads, state, params=None):
        mus, nus, count = state
        lr = (self.learning_rate(count) if callable(self.learning_rate)
              else self.learning_rate)
        b1, b2 = self.b1, self.b2
        mus = [(1 - b1) * g + b1 * m for g, m in zip(grads, mus)]
        nus = [(1 - b2) * (g * g) + b2 * n for g, n in zip(grads, nus)]
        count = count + 1
        t = count.to(torch.float32)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        if self.nesterov:
            bc1_next = 1 - b1 ** (count + 1).to(torch.float32)
            m_hat = [b1 * (m / bc1_next) + (1 - b1) * (g / bc1)
                     for m, g in zip(mus, grads)]
        else:
            m_hat = [m / bc1 for m in mus]
        upd = [m / (torch.sqrt(n / bc2) + self.eps)
               for m, n in zip(m_hat, nus)]
        if self.weight_decay is not None:
            upd = [u + self.weight_decay * p for u, p in zip(upd, params)]
        if self.trust_ratio:
            upd = [u * _trust_ratio(p, u) for u, p in zip(upd, params)]
        return _scale(lr, upd), (mus, nus, count)


def _trust_ratio(p, u):
    """||p|| / ||u||, or 1 where either norm is 0."""
    pn = torch.sqrt(torch.sum(p * p))
    un = torch.sqrt(torch.sum(u * u))
    return torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)


class Adagrad(_Scheduled):
    """``optax.adagrad`` (``scale_by_rss``): s = g^2 + s (from
    ``initial_accumulator_value``, 0.1 — torch.optim starts at 0),
    u = g * rsqrt(s + eps) where s > 0, else 0; then ``scale(-lr)``.
    Inner state: the accumulator list."""

    def __init__(self, learning_rate=1e-2, initial_accumulator_value=0.1,
                 eps=1e-7):
        super().__init__(learning_rate)
        self.initial_accumulator_value = float(initial_accumulator_value)
        self.eps = float(eps)

    def _init(self, params):
        return [torch.full_like(p, self.initial_accumulator_value)
                for p in params]

    def _update(self, grads, sums, params, lr):
        sums = [g * g + s for g, s in zip(grads, sums)]
        upd = [torch.where(s > 0, torch.rsqrt(s + self.eps),
                           torch.zeros_like(s)) * g
               for s, g in zip(sums, grads)]
        return _scale(lr, upd), sums


class Adadelta(_Scheduled):
    """``optax.adadelta``: ``add_decayed_weights(weight_decay)`` (g + wd p),
    then ``scale_by_adadelta``: e_g = (1-rho) g^2 + rho e_g,
    u = sqrt(e_x + eps) / sqrt(e_g + eps) * g, e_x = (1-rho) u^2 + rho e_x;
    then ``scale(-lr)``. Inner state: (e_g list, e_x list)."""

    def __init__(self, learning_rate=1e-3, rho=0.9, eps=1e-6,
                 weight_decay=0.0):
        super().__init__(learning_rate)
        self.rho = float(rho)
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)

    def _init(self, params):
        return ([torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params])

    def _update(self, grads, state, params, lr):
        e_g, e_x = state
        rho, eps = self.rho, self.eps
        grads = [g + self.weight_decay * p for g, p in zip(grads, params)]
        e_g = [(1 - rho) * (g * g) + rho * e for g, e in zip(grads, e_g)]
        upd = [(torch.sqrt(x + eps) / torch.sqrt(e + eps)) * g
               for g, e, x in zip(grads, e_g, e_x)]
        e_x = [(1 - rho) * (u * u) + rho * x for u, x in zip(upd, e_x)]
        return _scale(lr, upd), (e_g, e_x)


class RMSProp(_Scheduled):
    """``optax.rmsprop`` (not centered, no bias correction):
    nu = (1-decay) g^2 + decay nu (from ``initial_scale``),
    u = g * rsqrt(nu + eps) — eps inside the root (``eps_in_sqrt``; False
    gives g / (sqrt(nu) + eps)) — then ``scale(-lr)``, then
    ``trace(momentum, nesterov)`` when a momentum is given (on the scaled
    update, as optax chains it). Inner state: (nu list, trace list or
    ``()``)."""

    def __init__(self, learning_rate=1e-3, decay=0.9, eps=1e-8,
                 initial_scale=0.0, eps_in_sqrt=True, momentum=None,
                 nesterov=False):
        super().__init__(learning_rate)
        self.decay = float(decay)
        self.eps = float(eps)
        self.initial_scale = float(initial_scale)
        self.eps_in_sqrt = bool(eps_in_sqrt)
        self.momentum = None if momentum is None else float(momentum)
        self.nesterov = bool(nesterov)

    def _init(self, params):
        nu = [torch.full_like(p, self.initial_scale) for p in params]
        trace = (() if self.momentum is None
                 else [torch.zeros_like(p) for p in params])
        return nu, trace

    def _update(self, grads, state, params, lr):
        nu, trace = state
        d = self.decay
        nu = [(1 - d) * (g * g) + d * n for g, n in zip(grads, nu)]
        if self.eps_in_sqrt:
            scaling = [torch.rsqrt(n + self.eps) for n in nu]
        else:
            scaling = [1 / (torch.sqrt(n) + self.eps) for n in nu]
        upd = _scale(lr, [s * g for s, g in zip(scaling, grads)])
        if self.momentum is not None:
            upd, trace = _trace(upd, trace, self.momentum, self.nesterov)
        return upd, (nu, trace)


def _sgd(learning_rate=0.01, momentum=0.0, nesterov=False):
    return Sgd(learning_rate, momentum=momentum, nesterov=nesterov)


def _pallas_sgd(learning_rate=0.01, momentum=0.0, nesterov=False):
    """Fused single-pass SGD, kernels B1 (no momentum) and B2 (momentum,
    plain or Nesterov; see ops/pallas_kernels.py); the same arithmetic as
    "sgd"."""
    from distkeras_tpu_torch.ops.pallas_kernels import FusedSGD

    return FusedSGD(learning_rate, momentum=momentum, nesterov=nesterov)


def _pallas_adam(learning_rate=1e-3, **kwargs):
    """Fused single-pass Adam, kernel B3 (see ops/pallas_kernels.py);
    numerically identical to "adam" up to rounding."""
    from distkeras_tpu_torch.ops.pallas_kernels import FusedAdam

    return FusedAdam(learning_rate, **kwargs)


def _adamw(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8,
           weight_decay=1e-4):
    return Adam(learning_rate, b1, b2, eps, weight_decay=weight_decay)


def _nadam(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    return Adam(learning_rate, b1, b2, eps, nesterov=True)


def _lamb(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0):
    return Adam(learning_rate, b1, b2, eps, weight_decay=weight_decay,
                trust_ratio=True)


_OPTIMIZERS = {
    "sgd": _sgd,
    "pallas_sgd": _pallas_sgd,
    "pallas_adam": _pallas_adam,
    "adam": Adam,
    "adamw": _adamw,
    "adagrad": Adagrad,
    "adadelta": Adadelta,
    "rmsprop": RMSProp,
    "nadam": _nadam,
    "lamb": _lamb,
}

_DEFAULT_LR = {"sgd": 0.01, "pallas_sgd": 0.01, "pallas_adam": 1e-3,
               "adam": 1e-3, "adamw": 1e-3,
               "adagrad": 1e-2, "adadelta": 1e-3, "rmsprop": 1e-3,
               "nadam": 1e-3, "lamb": 1e-3}


# ------------------------------------------------------------------ schedules
# Each is a function of the step count — a Python number or an int32
# tensor (on the count's device: the optimizers call it there) — with
# optax's formula, computed in f32.


def _steps(count):
    return torch.as_tensor(count).to(torch.float32)


def constant_schedule(value):
    def schedule(count):
        return value

    return schedule


def exponential_decay(init_value, transition_steps, decay_rate,
                      transition_begin=0, staircase=False, end_value=None):
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        decreased = _steps(count) - transition_begin
        p = decreased / transition_steps
        if staircase:
            p = torch.floor(p)
        value = torch.where(decreased <= 0, init_value,
                            init_value * torch.pow(decay_rate, p))
        if end_value is not None:
            clip = torch.maximum if decay_rate < 1.0 else torch.minimum
            value = clip(value, torch.tensor(end_value, dtype=value.dtype,
                                             device=value.device))
        return value

    return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0, exponent=1.0):
    if not decay_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={decay_steps}."
        )

    def schedule(count):
        count = torch.clamp(_steps(count), max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def linear_schedule(init_value, end_value, transition_steps,
                    transition_begin=0):
    """``optax.polynomial_schedule`` with power 1."""
    if transition_steps <= 0:
        return constant_schedule(init_value)
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        count = torch.clamp(_steps(count) - transition_begin, 0,
                            transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps,
                                 decay_steps, end_value=0.0, exponent=1.0):
    """A linear warmup to ``peak_value`` over ``warmup_steps``, then a
    cosine decay to ``end_value`` at ``decay_steps`` (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha=alpha, exponent=exponent)

    def schedule(count):
        step = _steps(count)
        return torch.where(step < warmup_steps, warmup(step),
                           decay(step - warmup_steps))

    return schedule


_SCHEDULES = {
    "constant": constant_schedule,
    "exponential_decay": exponential_decay,
    "cosine_decay": cosine_decay_schedule,
    "linear": linear_schedule,
    "warmup_cosine": warmup_cosine_decay_schedule,
}


def get_schedule(name, **kwargs):
    """A named learning-rate schedule (pass the result as a trainer's
    ``learning_rate``; every optimizer but the fused ones accepts a
    schedule wherever it accepts a float); a callable passes through.

        get_schedule("warmup_cosine", init_value=0.0, peak_value=1e-3,
                     warmup_steps=100, decay_steps=2000)
    """
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _SCHEDULES:
        raise ValueError(
            f"unknown schedule {name!r}; available: {sorted(_SCHEDULES)}"
        )
    return _SCHEDULES[key](**kwargs)


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


def export_state(optimizer, state):
    """``optimizer.export_state(state)``, or the state itself for an
    optimizer without the checkpoint face."""
    fn = getattr(optimizer, "export_state", None)
    return state if fn is None else fn(state)


def load_state(optimizer, state, saved):
    """Load an exported state into ``state``'s buffers in place."""
    fn = getattr(optimizer, "load_state", None)
    if fn is None:
        copy_tree_(state, saved)
        return state
    return fn(state, saved)
