"""Metrics (PyTorch port of ``distkeras_tpu.ops.metrics``). Each returns a
0-d f32 tensor on the inputs' device, so a training window reads its
metrics from the device once, not once per step."""

from __future__ import annotations

import torch

from distkeras_tpu_torch.ops.losses import _token_mean, _token_targets


def accuracy(y_pred, y_true):
    """Fraction of argmax matches. y_true may be one-hot or integer ids."""
    pred_ids = torch.argmax(y_pred, dim=-1)
    true_ids = (y_true if y_true.ndim == y_pred.ndim - 1
                else torch.argmax(y_true, dim=-1))
    return torch.mean((pred_ids == true_ids).float())


def next_token_accuracy(y_pred, y_true, seq_group=None):
    """Causal-LM companion to ``losses.next_token_crossentropy``: position
    t's logits (B, T, V) are scored against token t+1 (B, T); under a
    sequence group as the loss is."""
    logits, targets = _token_targets(y_pred, y_true, seq_group)
    pred_ids = torch.argmax(logits, dim=-1)
    hits = (pred_ids == targets.to(pred_ids.dtype)).float()
    return _token_mean(hits, y_true, seq_group)


next_token_accuracy.scores_tokens = True


_METRICS = {
    "accuracy": accuracy,
    "acc": accuracy,
    "next_token_accuracy": next_token_accuracy,
}


def get_metric(name):
    if callable(name):
        return name
    if name not in _METRICS:
        raise ValueError(f"unknown metric {name!r}")
    return _METRICS[name]
