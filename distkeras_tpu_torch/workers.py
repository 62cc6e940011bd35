"""Worker runtime: the per-device training loop (PyTorch port of the parts
of ``distkeras_tpu.workers`` that ``SingleTrainer`` runs).

The JAX package compiles a window of W minibatches into one ``lax.scan``
program; here a window is W eager steps — forward, ``autograd.grad``, the
optimizer update — enqueued back to back on the device, with the metrics
kept on the device and read by the host once per window, never per step.
The parameters are a model's own ``nn.Parameter``s, updated in place: the
worker trains a copy of the caller's model (``Sequential.copy``), so the
caller's weights never move.

Left out of the port: ``_window_unroll`` (an XLA:CPU while-loop
workaround) and the core cache (``WorkerCore.cached`` saves jit retrace
time, which eager PyTorch does not pay). The async workers come with the
parameter-server tier.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from distkeras_tpu_torch.data.prefetch import Prefetcher
from distkeras_tpu_torch.models.sequential import walk_layers
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.metrics import get_metric
from distkeras_tpu_torch.ops.optimizers import apply_updates
from distkeras_tpu_torch.utils.device import check_model_device
from distkeras_tpu_torch.utils.rng import RngSeq, split_seed


class WorkerCore:
    """The train/eval step for a model + optimizer + loss, shared by the
    workers of a trainer. Steps take the model (the parameter holder) the
    way the JAX core's programs take the params tree."""

    def __init__(
        self,
        model,
        optimizer,
        loss,
        metrics=("accuracy",),
        compute_dtype=None,
        remat=False,
        accum_steps=1,
        aux_loss_weight=0.01,
    ):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = get_loss(loss)
        self.metric_names = list(metrics)
        self.metric_fns = [get_metric(m) for m in metrics]
        self.compute_dtype = compute_dtype
        # rematerialize the whole forward in the backward (the JAX core's
        # jax.checkpoint around train_fwd): activations are recomputed
        # instead of kept, at ~1/3 extra FLOPs
        self.remat = bool(remat)
        # gradient accumulation: each optimizer step runs its batch as
        # accum_steps sequential microbatches, averaging the gradients
        self.accum_steps = int(accum_steps)
        self.aux_loss_weight = float(aux_loss_weight)

    def init_opt_state(self, params):
        return self.optimizer.init(params)

    def _compute_loss(self, model, seed, x, y):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if self.remat:
            y_pred = checkpoint(model, x, seed, use_reentrant=False)
        else:
            y_pred = model(x, rng=seed)
        y_pred = y_pred.float()
        loss = self.loss_fn(y_pred, y)
        # layers that emit a differentiable regularizer (the JAX package's
        # "aux_loss" state leaves) add aux_loss_weight times its sum
        aux = _collect_aux_losses(model)
        if aux is not None:
            loss = loss + self.aux_loss_weight * aux
        return loss, y_pred

    def _batch_grads(self, model, params, seed, x, y):
        """(loss, y_pred, grads) for one optimizer step — the whole batch at
        once, or accumulated over ``accum_steps`` microbatches (grads and
        loss averaged, so numerics match the full-batch step up to
        summation order)."""
        k = self.accum_steps
        if k == 1:
            loss, y_pred = self._compute_loss(model, seed, x, y)
            grads = torch.autograd.grad(loss, params)
            return loss.detach(), y_pred.detach(), grads
        b = x.shape[0]
        xs = x.reshape(k, b // k, *x.shape[1:])
        ys = y.reshape(k, b // k, *y.shape[1:])
        gacc, lsum, preds = None, 0.0, []
        for i, sub in enumerate(split_seed(seed, k)):
            loss, y_pred = self._compute_loss(model, sub, xs[i], ys[i])
            grads = torch.autograd.grad(loss, params)
            gacc = (list(grads) if gacc is None
                    else [a + g for a, g in zip(gacc, grads)])
            lsum = lsum + loss.detach()
            preds.append(y_pred.detach())
        return lsum / k, torch.cat(preds), [g / k for g in gacc]

    def _apply_opt(self, params, grads, opt_state):
        # fused-apply optimizers (ops/pallas_kernels.py) update the params
        # in one kernel launch; otherwise the two-step update + apply
        if hasattr(self.optimizer, "fused_apply"):
            _, opt_state = self.optimizer.fused_apply(params, grads, opt_state)
            return opt_state
        updates, opt_state = self.optimizer.update(grads, opt_state, params)
        apply_updates(params, updates)
        return opt_state

    def _train_step(self, model, params, opt_state, rng, x, y):
        loss, y_pred, grads = self._batch_grads(model, params, rng.next(), x, y)
        with torch.no_grad():
            mets = {"loss": loss}
            for name, fn in zip(self.metric_names, self.metric_fns):
                mets[name] = fn(y_pred, y)
            opt_state = self._apply_opt(params, grads, opt_state)
        return opt_state, mets

    def _steps(self, model, opt_state, rng, batches):
        params = list(model.parameters())
        model.train()
        per_step = []
        for x, y in batches:
            opt_state, mets = self._train_step(model, params, opt_state, rng,
                                               x, y)
            per_step.append(mets)
        stacked = {k: torch.stack([m[k] for m in per_step])
                   for k in per_step[0]}
        return opt_state, stacked

    def window(self, model, opt_state, rng, xs, ys):
        """W steps over stacked minibatches ``xs``/``ys`` (W, B, ...) on the
        device; ``rng`` is the worker's ``RngSeq``. Returns (opt_state,
        {metric: (W,) device tensor})."""
        return self._steps(model, opt_state, rng,
                           ((xs[i], ys[i]) for i in range(xs.shape[0])))

    def indexed_window(self, model, opt_state, rng, data_x, data_y, idx):
        """Device-resident window: the full dataset lives on the device and
        each step gathers its minibatch by index (``idx``: (W, B) int64 on
        the device). The host ships 8 bytes/sample of indices per window
        instead of the samples. Batch contents match the streamed path
        exactly for the same permutation, so trajectories are bit-identical
        either way."""
        return self._steps(
            model, opt_state, rng,
            ((data_x.index_select(0, ix), data_y.index_select(0, ix))
             for ix in idx),
        )

    def eval_step(self, model, x, y):
        """Loss and metrics of one batch in eval mode, without gradients
        (so no backward kernel runs); returns 0-d device tensors."""
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                if self.compute_dtype is not None:
                    x = x.to(self.compute_dtype)
                y_pred = model(x).float()
                mets = {"loss": self.loss_fn(y_pred, y)}
                for name, fn in zip(self.metric_names, self.metric_fns):
                    mets[name] = fn(y_pred, y)
        finally:
            model.train(was_training)
        return mets


def _collect_aux_losses(model):
    """Sum of the ``aux_loss`` tensors the model's layers set in their
    forward (the channel through which a layer surfaces a differentiable
    regularizer to the training loss), or None when no layer has one."""
    total = None
    for layer in walk_layers(model):
        aux = getattr(layer, "aux_loss", None)
        if aux is not None:
            aux = aux.float().sum()
            total = aux if total is None else total + aux
    return total


def _metrics_to_records(mets) -> list:
    """Device metrics {name: (W,)} -> list of per-step float dicts, with one
    read from the device for the whole window."""
    names = list(mets)
    host = torch.stack([mets[k].float() for k in names]).cpu().numpy()
    return [{k: float(host[j, i]) for j, k in enumerate(names)}
            for i in range(host.shape[1])]


def stack_window(batches: list, features_col: str, label_col: str):
    """List of W batch dicts -> stacked (W, B, ...) arrays."""
    xs = np.stack([b[features_col] for b in batches])
    ys = np.stack([b[label_col] for b in batches])
    return xs, ys


def iter_windows(dataset, batch_size: int, columns: list, window: int):
    """Group a dataset's batches into window-sized lists, flushing the
    ragged remainder window at the end — THE windowing semantics for every
    windowed trainer."""
    pend = []
    for batch in dataset.batches(batch_size, columns=columns):
        pend.append(batch)
        if len(pend) == window:
            yield pend
            pend = []
    if pend:
        yield pend


def epoch_index_windows(n, batch_size, window, shuffle_seed, epoch):
    """(W, B) int32 index matrices for one epoch of device-resident training.

    The row order is exactly ``Dataset.shuffle(seed + epoch)``'s
    permutation (``np.random.default_rng``), batches cut sequentially,
    remainder rows dropped (``Dataset.batches`` drop_remainder semantics),
    so the resident path stays bit-identical to the streamed one."""
    perm = (
        np.random.default_rng(shuffle_seed + epoch).permutation(n)
        if shuffle_seed is not None
        else np.arange(n)
    )
    nb = n // batch_size
    idx_all = perm[: nb * batch_size].astype(np.int32).reshape(nb, batch_size)
    for w0 in range(0, nb, window):
        yield idx_all[w0 : w0 + window]


def resident_arrays(dataset, features_col, label_col):
    """Materialize the two training columns for device residency, with a
    clear error for datasets that cannot be indexed by column."""
    try:
        return (
            np.asarray(dataset[features_col]),
            np.asarray(dataset[label_col]),
        )
    except TypeError as exc:
        raise TypeError(
            "device_resident=True requires an in-memory Dataset whose "
            f"columns can be materialized; got {type(dataset).__name__}. "
            "Use device_resident=False to stream it."
        ) from exc


class SingleTrainerWorker:
    """Sequential minibatch loop on one device (reference:
    distkeras/workers.py -> SingleTrainerWorker.train)."""

    def __init__(self, core: WorkerCore, features_col, label_col, seed=0,
                 device=None):
        self.core = core
        self.features_col = features_col
        self.label_col = label_col
        self.rng = RngSeq(seed)
        # device=None means CUDA (raises without a GPU); the model must
        # already live there
        self.device = check_model_device(core.model, device)
        # (samples, seconds) per window, each ending in the metrics read
        self.timings = []

    def train(
        self,
        dataset,
        batch_size,
        num_epoch=1,
        window=8,
        shuffle_seed=None,
        on_epoch_end=None,
        prefetch=2,
        device_resident=False,
    ):
        """Train a copy of the core's model; returns (trained model,
        per-step records).

        ``on_epoch_end(epoch, model, opt_state, rng)`` is called after each
        epoch's last window. ``prefetch``: windows staged (stack, pinned
        copy to the device) by a background thread while the device
        computes the previous window; 0 stages synchronously. Window order
        is preserved either way, so results are bit-identical.
        ``device_resident``: ship the whole dataset to the device once and
        drive ``WorkerCore.indexed_window`` with per-epoch shuffled index
        matrices — same permutation, same batch contents, bit-identical
        trajectories — instead of streaming sample windows."""
        model = self.core.model.copy()
        opt_state = self.core.init_opt_state(list(model.parameters()))
        if device_resident:
            return self._train_resident(
                model, dataset, batch_size, num_epoch, window, shuffle_seed,
                opt_state, on_epoch_end,
            )
        records = []
        cols = [self.features_col, self.label_col]
        for epoch in range(num_epoch):
            ds = (
                dataset.shuffle(shuffle_seed + epoch)
                if shuffle_seed is not None
                else dataset
            )
            with Prefetcher(
                iter_windows(ds, batch_size, cols, window),
                self._stage_window,
                depth=prefetch,
            ) as staged:
                for xs, ys in staged:
                    t0 = time.perf_counter()
                    opt_state, mets = self.core.window(
                        model, opt_state, self.rng, xs, ys
                    )
                    self._record(records, mets, xs.shape[0] * xs.shape[1], t0)
            if on_epoch_end is not None:
                on_epoch_end(epoch, model, opt_state, self.rng)
        return model, records

    def _train_resident(self, model, dataset, batch_size, num_epoch, window,
                        shuffle_seed, opt_state, on_epoch_end):
        """Device-resident epoch loop: dataset on the device, indices from
        the host, batch assembly exactly as the streamed path's."""
        n = len(dataset)
        data_x, data_y = resident_arrays(dataset, self.features_col,
                                         self.label_col)
        if n // batch_size > 0:  # don't ship a dataset no window will touch
            data_x, data_y = (torch.from_numpy(np.ascontiguousarray(a))
                              .to(self.device) for a in (data_x, data_y))
        records = []
        for epoch in range(num_epoch):
            for idx in epoch_index_windows(
                n, batch_size, window, shuffle_seed, epoch
            ):
                t0 = time.perf_counter()
                ix = torch.from_numpy(idx.astype(np.int64)).to(self.device)
                opt_state, mets = self.core.indexed_window(
                    model, opt_state, self.rng, data_x, data_y, ix
                )
                self._record(records, mets, idx.size, t0)
            if on_epoch_end is not None:
                on_epoch_end(epoch, model, opt_state, self.rng)
        return model, records

    def _record(self, records, mets, samples, t0):
        records.extend(_metrics_to_records(mets))  # the window has finished
        self.timings.append((samples, time.perf_counter() - t0))

    def _stage_window(self, batches):
        """Host-side window prep (runs on the prefetch thread): stack the W
        batch dicts and copy them to the device from pinned memory."""
        return tuple(self._to_device(a) for a in stack_window(
            batches, self.features_col, self.label_col))

    def _to_device(self, arr):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t
