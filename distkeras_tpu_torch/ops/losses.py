"""Loss functions, resolvable by Keras-style string names (PyTorch port of
``distkeras_tpu.ops.losses``; same names, same math).

Trainers accept either a name or a callable ``loss(y_pred, y_true) ->
scalar``. Cross-entropy takes softmax *probabilities* (computed via a
clipped log); models emitting logits use the ``*_from_logits`` forms or
``next_token_crossentropy``.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def categorical_crossentropy(y_pred, y_true):
    """Mean CE; y_pred = probabilities (B, C); y_true = one-hot (B, C)."""
    p = torch.clamp(y_pred, _EPS, 1.0)
    return -torch.mean(torch.sum(y_true * torch.log(p), dim=-1))


def categorical_crossentropy_from_logits(y_pred, y_true):
    return -torch.mean(
        torch.sum(y_true * torch.log_softmax(y_pred, dim=-1), dim=-1)
    )


def sparse_categorical_crossentropy(y_pred, y_true):
    """y_true = integer class ids (B,)."""
    p = torch.clamp(y_pred, _EPS, 1.0)
    ll = torch.gather(torch.log(p), -1, y_true.long()[:, None])
    return -torch.mean(ll)


def next_token_crossentropy(y_pred, y_true):
    """Causal-LM loss: y_pred = logits (B, T, V); y_true = token ids (B, T).

    Position t's logits predict token t+1; the last position has no target
    and is dropped. Mean over B*(T-1) predictions, log-softmax in f32.
    Requires T >= 2: with a single position there is no (input,
    next-token) pair and the mean would reduce an empty slice to NaN."""
    if y_pred.shape[1] < 2:
        raise ValueError(
            "next_token_crossentropy needs seq_len >= 2 (got "
            f"{y_pred.shape[1]}): the shifted loss has no targets at T=1"
        )
    logp = torch.log_softmax(y_pred[:, :-1].float(), dim=-1)
    targets = y_true[:, 1:].long()
    ll = torch.gather(logp, -1, targets[..., None])
    return -torch.mean(ll)


def binary_crossentropy(y_pred, y_true):
    p = torch.clamp(y_pred, _EPS, 1.0 - _EPS)
    return -torch.mean(y_true * torch.log(p) + (1.0 - y_true) * torch.log(1.0 - p))


def _check_regression_shapes(y_pred, y_true):
    """(B, 1) predictions against a (B,) target would silently broadcast to
    a (B, B) residual matrix. Require identical shapes."""
    if y_pred.shape != y_true.shape:
        raise ValueError(
            f"regression loss needs matching shapes; got y_pred "
            f"{tuple(y_pred.shape)} vs y_true {tuple(y_true.shape)} — "
            "reshape the target to the prediction's shape (loaders.diabetes "
            "ships its target as (n, 1))"
        )


def mse(y_pred, y_true):
    _check_regression_shapes(y_pred, y_true)
    return torch.mean((y_pred - y_true) ** 2)


def mae(y_pred, y_true):
    _check_regression_shapes(y_pred, y_true)
    return torch.mean(torch.abs(y_pred - y_true))


_LOSSES = {
    "categorical_crossentropy": categorical_crossentropy,
    "categorical_crossentropy_from_logits": categorical_crossentropy_from_logits,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "next_token_crossentropy": next_token_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mse": mse,
    "mean_squared_error": mse,
    "mae": mae,
    "mean_absolute_error": mae,
}


def get_loss(name):
    if callable(name):
        return name
    if name not in _LOSSES:
        raise ValueError(f"unknown loss {name!r}; known: {sorted(_LOSSES)}")
    return _LOSSES[name]
