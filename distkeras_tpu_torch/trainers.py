"""Trainer orchestration (PyTorch port of the parts of
``distkeras_tpu.trainers`` the training slice runs: ``Trainer`` and
``SingleTrainer``).

Same constructor vocabulary (``worker_optimizer``, ``loss``, ``metrics``,
``learning_rate``, ``batch_size``, ``num_epoch``, ``seed``, ...) and the
same contract: ``trainer.train(dataset) -> trained model``, a new model;
the caller's keeps its weights. ``checkpoint_dir=``, ``profile_dir=`` and
``metrics_path=`` raise until ``utils/checkpoint.py`` and
``utils/profiling.py`` are ported; the distributed trainers come with the
data-parallel and parameter-server slices.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.ops.optimizers import (
    effective_learning_rate,
    get_optimizer,
)
from distkeras_tpu_torch.ops.quantization import count_quantized
from distkeras_tpu_torch.utils.history import TrainingHistory
from distkeras_tpu_torch.workers import SingleTrainerWorker, WorkerCore


def _not_ported(option, module):
    raise NotImplementedError(
        f"{option}= is not ported yet (it needs {module})"
    )


class Trainer:
    """Base trainer: model + optimizer/loss spec + history bookkeeping
    (reference: distkeras/trainers.py -> Trainer)."""

    def __init__(
        self,
        model,
        worker_optimizer="sgd",
        loss="categorical_crossentropy",
        metrics=("accuracy",),
        learning_rate=None,
        features_col="features",
        label_col="label",
        batch_size=32,
        num_epoch=1,
        seed=0,
        compute_dtype=None,
        remat=False,
        accum_steps=1,
        aux_loss_weight=0.01,
        profile_dir=None,
        metrics_path=None,
        validation_data=None,
    ):
        if getattr(model, "output_shape", None) is None:
            raise ValueError("model must be built (call model.build(input_shape))")
        if count_quantized(model):
            raise ValueError(
                "model holds quantized weights (ops.quantization) — "
                "training cannot differentiate through round(); train the "
                "f32 master and quantize a serving copy instead"
            )
        if profile_dir is not None:
            _not_ported("profile_dir", "utils/profiling.py")
        if metrics_path is not None:
            _not_ported("metrics_path", "utils/profiling.MetricsLogger")
        # accum_steps=k: each optimizer step processes its batch as k
        # sequential microbatches of B/k, averaging the gradients. B must
        # divide by k.
        self.accum_steps = int(accum_steps)
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1; got {accum_steps}")
        if batch_size % self.accum_steps:
            raise ValueError(
                f"batch_size {batch_size} not divisible by accum_steps "
                f"{accum_steps}"
            )
        self.model = model
        # the lr the optimizer actually runs with
        self.learning_rate = effective_learning_rate(worker_optimizer, learning_rate)
        self.worker_optimizer = worker_optimizer
        self.optimizer = get_optimizer(worker_optimizer, learning_rate)
        self.loss = loss
        self.metrics = tuple(metrics)
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)
        self.seed = int(seed)
        self.compute_dtype = compute_dtype
        self.remat = bool(remat)
        # weight on layer-emitted "aux_loss" tensors
        self.aux_loss_weight = float(aux_loss_weight)
        self.history = TrainingHistory()
        # held-out set evaluated at each epoch end (Keras-style val_*
        # metrics in the history); None disables
        self.validation_data = validation_data

    def _make_core(self) -> WorkerCore:
        return WorkerCore(
            self.model,
            self.optimizer,
            self.loss,
            metrics=self.metrics,
            compute_dtype=self.compute_dtype,
            remat=self.remat,
            accum_steps=self.accum_steps,
            aux_loss_weight=self.aux_loss_weight,
        )

    def _finish(self, model):
        """The result model: the worker's trained copy, in eval mode (the
        mode a built model starts in). The caller's model was never
        touched."""
        return model.eval()

    # -- bookkeeping parity -------------------------------------------------

    def get_history(self, worker_id=None):
        return self.history.get_history(worker_id)

    def get_training_time(self):
        return self.history.get_training_time()

    def get_averaged_metrics(self):
        return self.history.averages()

    def get_validation_history(self):
        return self.history.get_validation_history()

    def _run_validation(self, core, model, epoch):
        """Evaluate ``validation_data`` with the current weights and record
        Keras-style ``val_*`` metrics for this epoch: sample-weighted means
        over all validation batches (ragged tail included). Per-batch
        results stay on the device until one read at the end."""
        if self.validation_data is None:
            return None
        device = next(model.parameters()).device
        results, sizes = [], []
        for batch in self.validation_data.batches(
            self.batch_size,
            columns=[self.features_col, self.label_col],
            drop_remainder=False,
        ):
            x, y = (torch.as_tensor(batch[c], device=device)
                    for c in (self.features_col, self.label_col))
            results.append(core.eval_step(model, x, y))
            sizes.append(len(x))
        if not results:
            return None
        names = list(results[0])
        host = torch.stack(
            [torch.stack([r[k].float() for k in names]) for r in results]
        ).cpu().numpy()
        totals = dict.fromkeys(names, 0.0)
        for row, b in zip(host, sizes):
            for k, v in zip(names, row):
                totals[k] += float(v) * b
        n = int(np.sum(sizes))
        avg = {f"val_{k}": v / n for k, v in totals.items()}
        self.history.record_validation(epoch, avg)
        return avg

    def train(self, dataset, shuffle=False):
        """Train on ``dataset`` (``shuffle``: reshuffle every epoch with
        ``seed + epoch``); returns the trained model."""
        return self._train(dataset, shuffle=shuffle)

    def _train(self, dataset, shuffle=False):
        raise NotImplementedError


class SingleTrainer(Trainer):
    """One worker, one device — the correctness anchor (reference:
    distkeras/trainers.py -> SingleTrainer).

    ``device=None`` means CUDA (raises without a GPU; the model must live
    on the device asked for). ``window``: steps between host reads of the
    metrics. ``prefetch``: windows staged ahead on a background thread
    (default 0: synchronous). ``device_resident``: the dataset is copied to
    the device once and each step gathers its batch by index;
    bit-identical to the streamed path."""

    def __init__(
        self,
        *args,
        window=8,
        device=None,
        prefetch=0,
        device_resident=False,
        checkpoint_dir=None,
        **kwargs,
    ):
        if checkpoint_dir is not None:
            _not_ported("checkpoint_dir", "utils/checkpoint.py")
        super().__init__(*args, **kwargs)
        self.window = int(window)
        self.device = device
        self.prefetch = int(prefetch)
        self.device_resident = bool(device_resident)

    def _train(self, dataset, shuffle=False):
        self.history.record_training_start()
        core = self._make_core()
        worker = SingleTrainerWorker(
            core,
            self.features_col,
            self.label_col,
            seed=self.seed,
            device=self.device,
        )
        on_epoch_end = None
        if self.validation_data is not None:
            def on_epoch_end(epoch, model, opt_state, rng):
                self._run_validation(core, model, epoch + 1)

        model, records = worker.train(
            dataset,
            self.batch_size,
            num_epoch=self.num_epoch,
            window=self.window,
            shuffle_seed=self.seed if shuffle else None,
            on_epoch_end=on_epoch_end,
            prefetch=self.prefetch,
            device_resident=self.device_resident,
        )
        self.history.extend(0, records)
        for s, dt in worker.timings:
            self.history.record_window(0, s, dt)
        self.history.record_training_end()
        return self._finish(model)
