"""Loss functions, resolvable by Keras-style string names (PyTorch port of
``distkeras_tpu.ops.losses``; same names, same math).

Trainers accept either a name or a callable ``loss(y_pred, y_true) ->
scalar``. Cross-entropy takes softmax *probabilities* (computed via a
clipped log); models emitting logits use the ``*_from_logits`` forms or
``next_token_crossentropy``.
"""

from __future__ import annotations

import functools

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


def _token_targets(y_pred, y_true, seq_group):
    """(positions, targets): the logits that have a next token and the
    ids they predict. Under a sequence group of N ranks ``y_pred`` holds
    the rank's T/N positions and ``y_true`` the global (B, T) ids, so the
    shift crosses the shard boundary: rank r's last position predicts
    rank r+1's first token, and only the last rank drops one."""
    t = y_pred.shape[1]
    off = 0 if seq_group is None else seq_group.rank * t
    targets = y_true[:, off + 1:off + t + 1]
    return y_pred[:, :targets.shape[1]], targets


def _token_mean(per_token, y_true, seq_group):
    """The mean over the B*(T-1) global predictions; under a sequence
    group of N ranks, this rank's sum times N over the global count, so
    that the mean over the ranks (the trainer's reduction) is the global
    mean."""
    if seq_group is None:
        return torch.mean(per_token)
    b, t = y_true.shape[:2]
    return per_token.sum() * (seq_group.num_workers / (b * (t - 1)))


def next_token_crossentropy(y_pred, y_true, seq_group=None):
    """Causal-LM loss: y_pred = logits (B, T, V); y_true = token ids (B, T).

    Position t's logits predict token t+1; the last position has no target
    and is dropped. Mean over B*(T-1) predictions, log-softmax in f32.
    Requires T >= 2: with a single position there is no (input,
    next-token) pair and the mean would reduce an empty slice to NaN.
    ``seq_group``: the token axis of ``y_pred`` is split over that group
    (``_token_targets``, ``_token_mean``)."""
    if y_true.shape[1] < 2:
        raise ValueError(
            "next_token_crossentropy needs seq_len >= 2 (got "
            f"{y_true.shape[1]}): the shifted loss has no targets at T=1"
        )
    logits, targets = _token_targets(y_pred, y_true, seq_group)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])
    return -_token_mean(ll, y_true, seq_group)


next_token_crossentropy.scores_tokens = True


def with_seq_group(fn, seq_group):
    """``fn`` bound to the sequence group of a run whose token axis is
    split over it, when ``fn`` scores tokens (the next-token loss and
    accuracy); else ``fn`` itself (a loss or metric over pooled outputs
    sees the same values on every rank)."""
    if (seq_group is None or seq_group.num_workers == 1
            or not getattr(fn, "scores_tokens", False)):
        return fn
    return functools.partial(fn, seq_group=seq_group)


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
