"""Evaluation over Datasets (PyTorch port of ``distkeras_tpu.evaluators``;
reference: distkeras/evaluators.py -> AccuracyEvaluator.evaluate compares
prediction vs label columns). Plain numpy over the prediction column;
``LossEvaluator`` runs the port's loss on CPU tensors."""

from __future__ import annotations

import numpy as np

import torch

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.ops.losses import get_loss


class Evaluator:
    def evaluate(self, ds: Dataset) -> float:
        raise NotImplementedError


class AccuracyEvaluator(Evaluator):
    """Fraction of rows where prediction matches the label.

    ``prediction_col`` may hold class ids (from LabelIndexTransformer) or
    probability vectors (argmax is taken); ``label_col`` may be ids or
    one-hot.
    """

    def __init__(self, prediction_col="prediction", label_col="label"):
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, ds: Dataset) -> float:
        pred = ds[self.prediction_col]
        if pred.ndim > 1:
            pred = np.argmax(pred, axis=-1)
        label = ds[self.label_col]
        if label.ndim > 1:
            label = np.argmax(label, axis=-1)
        return float(np.mean(pred.astype(np.int64) == label.astype(np.int64)))


class LossEvaluator(Evaluator):
    """Mean loss of a prediction column against a (one-hot) label column."""

    def __init__(self, loss="categorical_crossentropy",
                 prediction_col="prediction", label_col="label"):
        self.loss_fn = get_loss(loss)
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, ds: Dataset) -> float:
        return float(
            self.loss_fn(
                torch.as_tensor(ds[self.prediction_col]),
                torch.as_tensor(ds[self.label_col]),
            )
        )


class RSquaredEvaluator(Evaluator):
    """Coefficient of determination R² = 1 - SS_res/SS_tot of a
    continuous prediction column against a continuous target — the
    regression counterpart of ``AccuracyEvaluator`` (the reference
    evaluated whatever its compiled Keras model emitted; reference:
    distkeras/evaluators.py). 1.0 is a perfect fit; 0.0 is the
    predict-the-mean baseline; negative is worse than that baseline."""

    def __init__(self, prediction_col="prediction", label_col="label"):
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, ds: Dataset) -> float:
        pred = np.asarray(ds[self.prediction_col], np.float64).reshape(-1)
        y = np.asarray(ds[self.label_col], np.float64).reshape(-1)
        ss_res = float(np.sum((y - pred) ** 2))
        ss_tot = float(np.sum((y - np.mean(y)) ** 2))
        if ss_tot == 0.0:
            return 1.0 if ss_res == 0.0 else 0.0
        return 1.0 - ss_res / ss_tot


class PerplexityEvaluator(Evaluator):
    """Causal-LM perplexity: exp(mean next-token cross-entropy) of an LM's
    logits column against the token column. No reference counterpart
    (SURVEY §5.7: no sequence models upstream); pairs with
    ``zoo.transformer_lm`` + ``ModelPredictor`` (the prediction column
    holds (T, V) logits per row) the way AccuracyEvaluator pairs with the
    classifier families.
    """

    def __init__(self, prediction_col="prediction", label_col="label"):
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, ds: Dataset) -> float:
        logits = np.asarray(ds[self.prediction_col])
        tokens = np.asarray(ds[self.label_col])
        if logits.ndim != 3 or tokens.ndim != 2:
            raise ValueError(
                "perplexity expects logits (N, T, V) and tokens (N, T); "
                f"got {logits.shape} and {tokens.shape}"
            )
        ce = LossEvaluator(
            "next_token_crossentropy", self.prediction_col, self.label_col
        ).evaluate(ds)
        return float(np.exp(ce))
