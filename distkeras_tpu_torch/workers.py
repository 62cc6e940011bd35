"""Worker runtime: the per-device training loops (PyTorch port of
``distkeras_tpu.workers``: the core step, ``SingleTrainerWorker`` and the
asynchronous parameter-server workers).

The JAX package compiles a window of W minibatches into one ``lax.scan``
program; here a window is W eager steps — forward, ``autograd.grad``, the
optimizer update — enqueued back to back on the device, with the metrics
kept on the device and read by the host once per window, never per step.
The parameters are a model's own ``nn.Parameter``s, updated in place: a
worker trains a copy of the caller's model (``Sequential.copy``), so the
caller's weights never move.

Async workers split each window into ``begin_window`` (pull + enqueue the
window) and ``finish_window`` (read the metrics, which waits for the
window, then delta + commit), so that thread mode calls them back to back
per worker thread and the deterministic simulator interleaves them across
workers on a seeded schedule (reproducible staleness). Each async worker
trains a replica of its own; a pull copies the center into it in place,
so the fused optimizers' pointer tables stay valid from window to window,
and the pulled center stays on the device, so the delta is computed there
and crosses to the host once per commit.

A checkpoint resume hands ``SingleTrainerWorker.train`` its restore
point (``initial_full``, ``start_epoch``); an async worker adopts its
saved local state (``restore_snapshot``) and skips the windows the
restored center already holds. Either way the saved values are copied
into the live parameters, buffers and optimizer state in place, so the
fused optimizers' tables keep pointing at them.

With ``compress=`` an async worker's commits ride int8-quantized or
top-k-sparsified (``utils/compression.py``, host numpy after the one
device-to-host copy), the error-feedback residual carried from commit to
commit and in the worker's snapshots; a pulled center encoded by the
parameter server's ``pull_compress`` is decoded on receipt.

Left out of the port: ``_window_unroll`` (an XLA:CPU while-loop
workaround) and the core cache (``WorkerCore.cached`` saves jit retrace
time, which eager PyTorch does not pay).
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from distkeras_tpu_torch.data.prefetch import Prefetcher
from distkeras_tpu_torch.models.layers import remat
from distkeras_tpu_torch.models.sequential import walk_layers
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.metrics import get_metric
from distkeras_tpu_torch.ops.optimizers import (
    apply_updates,
    export_state,
    load_state,
)
from distkeras_tpu_torch.utils.compression import (
    compress_with_feedback,
    is_compressed,
    is_topk,
    maybe_decode_pull,
    parse_compress_spec,
    quantize_tree,
    topk_compress,
    topk_compress_with_feedback,
)
from distkeras_tpu_torch.utils.convert import params_from_jax, state_from_jax
from distkeras_tpu_torch.utils.device import check_model_device
from distkeras_tpu_torch.utils.rng import RngSeq, split_seed
from distkeras_tpu_torch.utils.tree import copy_tree_, to_host


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
        # the dtype the input is cast to ("bfloat16", torch.bfloat16, ...);
        # every layer casts its weights to the input's dtype
        self.compute_dtype = _resolve_dtype(compute_dtype)
        # rematerialize the whole forward in the backward (the JAX core's
        # jax.checkpoint around train_fwd): activations are recomputed
        # instead of kept, at ~1/3 extra FLOPs; BatchNorm updates its
        # moving statistics in the first forward only
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
            y_pred = remat(model, x, seed)
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

    def _train_step(self, model, params, opt_state, rng, x, y, acc=None):
        loss, y_pred, grads = self._batch_grads(model, params, rng.next(), x, y)
        with torch.no_grad():
            mets = {"loss": loss}
            for name, fn in zip(self.metric_names, self.metric_fns):
                mets[name] = fn(y_pred, y)
            opt_state = self._apply_opt(params, grads, opt_state)
            if acc is not None:  # the raw gradients, summed (ADAG)
                torch._foreach_add_(acc, list(grads))
        return opt_state, mets

    def _steps(self, model, opt_state, rng, batches, acc=None):
        params = list(model.parameters())
        model.train()
        per_step = []
        for x, y in batches:
            opt_state, mets = self._train_step(model, params, opt_state, rng,
                                               x, y, acc)
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

    def grad_window(self, model, opt_state, rng, xs, ys):
        """Like ``window``, but also sums the raw gradients of the W steps
        (ADAG's commit); returns (opt_state, metrics, summed gradients in
        ``model.parameters()`` order)."""
        acc = [torch.zeros_like(p) for p in model.parameters()]
        opt_state, mets = self._steps(
            model, opt_state, rng,
            ((xs[i], ys[i]) for i in range(xs.shape[0])), acc)
        return opt_state, mets, acc

    def indexed_grad_window(self, model, opt_state, rng, data_x, data_y,
                            idx):
        """``grad_window`` over the device-resident feed (the contract of
        ``indexed_window``)."""
        acc = [torch.zeros_like(p) for p in model.parameters()]
        opt_state, mets = self._steps(
            model, opt_state, rng,
            ((data_x.index_select(0, ix), data_y.index_select(0, ix))
             for ix in idx), acc)
        return opt_state, mets, acc

    def member_window(self, models, opt_state, rngs, xs, ys):
        """One joint window of member training (``EnsembleTrainer`` and
        ``AveragingTrainer`` with ``vmapped=True``; the JAX package's
        ``vmap`` of the window program): W steps over minibatches stacked
        (m, W, B, ...) on the member axis. Each step runs every member's
        forward and backward in turn on one stream, member ``i`` drawing
        from ``rngs[i]``, then ONE optimizer apply over the members'
        parameters concatenated member by member — on CUDA one launch of
        the fused kernel over a table of m x leaves. ``opt_state`` is the
        state of that concatenated list (``init_opt_state`` of it): every
        rule updates leaf by leaf and the members share one step count,
        so it steps each member exactly as m separate states would.
        Returns (opt_state, {metric: (m, W) device tensor})."""
        params = [list(mm.parameters()) for mm in models]
        flat = [p for ps in params for p in ps]
        for mm in models:
            mm.train()
        per_step = []
        for j in range(xs.shape[1]):
            grads, mets = [], []
            for i, mm in enumerate(models):
                x, y = xs[i, j], ys[i, j]
                loss, y_pred, g = self._batch_grads(mm, params[i],
                                                    rngs[i].next(), x, y)
                grads.extend(g)
                with torch.no_grad():
                    met = {"loss": loss}
                    for name, fn in zip(self.metric_names, self.metric_fns):
                        met[name] = fn(y_pred, y)
                mets.append(met)
            with torch.no_grad():
                opt_state = self._apply_opt(flat, grads, opt_state)
            per_step.append(mets)
        stacked = {
            k: torch.stack([torch.stack([step[i][k] for step in per_step])
                            for i in range(len(models))])
            for k in per_step[0][0]
        }
        return opt_state, stacked

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


def _resolve_dtype(dtype):
    """A compute dtype given by name (as the JAX package takes it) or as a
    ``torch.dtype``; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    resolved = getattr(torch, str(dtype), None)
    if not isinstance(resolved, torch.dtype):
        raise ValueError(f"unknown compute dtype {dtype!r}")
    return resolved


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


def to_device(arr, device):
    """A host array on ``device``: through pinned memory, asynchronously,
    on CUDA (the prefetch threads' staging copy); a zero-copy view on the
    CPU."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def reset_opt_state(core, opt_state, params):
    """A fresh optimizer state copied into ``opt_state`` in place, so the
    fused kernels' tables keep pointing at its buffers."""
    opt = core.optimizer
    load_state(opt, opt_state, export_state(opt, core.init_opt_state(params)))


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
    clear error for datasets that cannot be indexed by column (e.g.
    ``StreamingDataset``, which exists for data that does not fit in
    memory: stream it with device_resident=False)."""
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
        initial_full=None,
        start_epoch=0,
        on_epoch_end=None,
        prefetch=2,
        device_resident=False,
    ):
        """Train a copy of the core's model; returns (trained model,
        per-step records).

        ``initial_full``: optional (params, state, opt_state, rng state) —
        the restore point a checkpoint resume supplies (params and state as
        ``{state_dict name: array}`` or a JAX tree, opt_state as the
        optimizer exports it or None for a fresh one, rng None to keep the
        worker's seed); with ``start_epoch`` the continuation is
        bit-identical to an uninterrupted run.
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
        if initial_full is not None:
            params, state, saved_opt, rng_state = initial_full
            params_from_jax(model, params)
            state_from_jax(model, state)
            if saved_opt is not None:
                load_state(self.core.optimizer, opt_state, saved_opt)
            if rng_state is not None:
                self.rng.set_state(rng_state)
        if device_resident:
            return self._train_resident(
                model, dataset, batch_size, num_epoch, window, shuffle_seed,
                opt_state, start_epoch, on_epoch_end,
            )
        records = []
        cols = [self.features_col, self.label_col]
        for epoch in range(start_epoch, num_epoch):
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
                        shuffle_seed, opt_state, start_epoch, on_epoch_end):
        """Device-resident epoch loop: dataset on the device, indices from
        the host, batch assembly exactly as the streamed path's."""
        n = len(dataset)
        data_x, data_y = resident_arrays(dataset, self.features_col,
                                         self.label_col)
        if n // batch_size > 0:  # don't ship a dataset no window will touch
            data_x, data_y = (torch.from_numpy(np.ascontiguousarray(a))
                              .to(self.device) for a in (data_x, data_y))
        records = []
        for epoch in range(start_epoch, num_epoch):
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
        return tuple(to_device(a, self.device) for a in stack_window(
            batches, self.features_col, self.label_col))


# -------------------------------------------------------------- async workers


class AsyncWorker:
    """Base async worker: owns one partition, one device, one PS connection
    and one model replica.

    Lifecycle per window (reference: distkeras/workers.py -> NetworkWorker
    pull/commit cadence):
      begin_window(batches): pull from the PS, copy the center onto the
        device, let the algorithm set the replica from it (``on_pull``),
        enqueue the window's steps;
      finish_window(): read the window's metrics (waits for the device),
        compute the delta on the device (``make_delta``), commit it.
    """

    uses_grad_window = False

    def __init__(
        self,
        core: WorkerCore,
        ps,
        worker_id: int,
        features_col,
        label_col,
        communication_window: int,
        seed=0,
        device=None,
        compress=None,
    ):
        self.core = core
        self.ps = ps
        self.worker_id = worker_id
        self.features_col = features_col
        self.label_col = label_col
        self.window_size = int(communication_window)
        # kinds: None | "int8" | "topk" (the fraction rides the spec
        # string, e.g. "topk:0.05" — utils/compression.parse_compress_spec)
        self._compress_kind, self._compress_frac = parse_compress_spec(compress)
        self.compress = compress
        self._q_residual = None  # error-feedback state (host numpy)
        self._rng_seed = split_seed(seed, int(worker_id) + 1)[-1]
        self.rng = RngSeq(self._rng_seed)
        self.device = check_model_device(core.model, device)
        self.records = []
        self.timings = []  # (samples, pull-to-commit seconds) per window
        # per window: host seconds in the pull (PS copy + H2D), the window
        # (enqueue until its metrics are read) and the commit (delta, D2H,
        # PS add)
        self.splits = []
        self._seq = 0  # per-worker commit sequence (exactly-once at the PS)
        self._start_seq = 0  # windows to skip on resume (already absorbed)
        # checkpoints: with keep_snapshot, every snapshot_stride-th commit
        # hands host copies of this worker's local state (replica, buffers,
        # optimizer state, rng, seq) to the PS, which stores them in the
        # commit's locked section — so a checkpoint never holds a worker
        # state ahead of its center (behind is safe: the replayed windows
        # dedup at the PS)
        self.keep_snapshot = False
        self.snapshot_stride = 1
        self._snap = None  # the latest committed local state
        self._restore_point = None  # the snapshot adopted at resume
        self._model = None  # the replica, made at first use
        self._center = None  # the pulled center on the device
        self._opt_state = None
        self._adopted = False  # the replica has taken the center once
        self._pending = None
        self._resident = None  # (data_x, data_y) on the device
        self._resident_n = 0

    @property
    def ps_failovers(self) -> int:
        """How many times this worker's PS client rotated endpoints (0 for
        an in-process or single-endpoint PS)."""
        return int(getattr(self.ps, "failovers", 0))

    def reset_for_retry(self, retry=None):
        """Restart this worker's training after a failure: from its resume
        restore point when it has one, else from scratch. From scratch the
        commit sequence restarts at 0, so the PS deduplicates the re-run's
        commits up to the last one it absorbed — a retry cannot
        double-apply work, across a PS failover too (the promoted standby's
        dedup table rode the replication stream); the replica keeps its
        parameter buffers (re-adopting the center at the next pull), so the
        fused optimizers' tables stay valid, and the optimizer state and
        the moving statistics start anew. After a resume the scratch seqs
        may predate the restored dedup table, so the retry goes back to the
        restore point instead.

        A remote PS is redialed (a crashed stream may be desynced), under
        ``retry`` (a ``networking.RetryPolicy``) when given; a
        multi-endpoint client's redial rotates to whichever replica
        serves."""
        self.records = []
        self.timings = []
        self.splits = []
        self._pending = None
        if self._restore_point is not None:
            self._adopt(self._restore_point)
        else:
            self.rng = RngSeq(self._rng_seed)
            self._seq = 0
            self._start_seq = 0
            self._opt_state = None
            self._q_residual = None
            self._adopted = False
            if self._model is not None:
                self._reset_buffers()
        if hasattr(self.ps, "reconnect"):
            if retry is not None:
                retry.call(self.ps.reconnect)
            else:
                self.ps.reconnect()

    # -- worker-local checkpoint/resume --------------------------------------

    def restore_snapshot(self, snap):
        """Adopt a worker-local checkpoint (see ``keep_snapshot``): replica
        parameters, buffers, optimizer state, rng position, commit
        sequence and, in a compressed run, the error-feedback residual. ``train`` then skips the first ``seq`` windows of the
        partition's stream — the ones whose commits the restored center
        already holds."""
        self._restore_point = snap
        self._snap = snap  # checkpoints before the first post-resume commit
        self._adopt(snap)

    def _adopt(self, snap):
        """Copy a snapshot into the replica, its buffers and the optimizer
        state in place (the fused optimizers' tables stay valid)."""
        self._ensure_replica()
        copy_tree_(self._params, [snap["params"][n] for n in self._names])
        copy_tree_(dict(self._model.named_buffers()), snap["state"])
        load_state(self.core.optimizer, self._opt_state, snap["opt_state"])
        self.rng = RngSeq(self._rng_seed)
        self.rng.set_state(snap["rng"])
        self._seq = self._start_seq = int(snap["seq"])
        # the residual stays host-side (commit-path state)
        residual = snap.get("q_residual")
        self._q_residual = (None if residual is None
                            else {k: np.array(v, copy=True)
                                  for k, v in residual.items()})
        # the replica holds its trained state: AEASGD must not re-adopt
        # the center at the next pull
        self._adopted = True

    def _make_snap(self, seq):
        """Host copies of this worker's local state, labelled ``seq``; a
        compressed run's error-feedback residual rides along, so a resumed
        run keeps carrying the same quantization error."""
        snap = {
            "params": to_host(dict(zip(self._names, self._params))),
            "state": to_host(dict(self._model.named_buffers())),
            "opt_state": to_host(export_state(self.core.optimizer,
                                              self._opt_state)),
            "rng": to_host(self.rng.get_state()),
            "seq": np.int64(seq),
        }
        if self._q_residual is not None:
            snap["q_residual"] = to_host(self._q_residual)
        return snap

    # -- algorithm hooks ----------------------------------------------------

    def on_pull(self, tag):
        """Set the replica from the pulled center (``self._center``).
        Override per algorithm."""
        raise NotImplementedError

    def make_delta(self, acc):
        """The delta to commit, ``{name: device tensor}`` (or a compressed
        host payload, see ``AEASGDWorker``), from the trained replica, the
        pulled center and (grad windows) the summed gradients ``acc``.
        Override per algorithm."""
        raise NotImplementedError

    # -- window machinery ---------------------------------------------------

    def _ensure_replica(self):
        if self._model is None:
            self._model = self.core.model.copy().to(self.device)
            self._names = [n for n, _ in self._model.named_parameters()]
            self._params = list(self._model.parameters())
            self._center = [torch.empty_like(p) for p in self._params]
            self._leaf_order = self._model._leaf_order()
        if self._opt_state is None:
            self._opt_state = self.core.init_opt_state(self._params)

    def _reset_buffers(self):
        """The replica's buffers (moving statistics) := the caller's
        model's, in place: the state a JAX worker starts from."""
        with torch.no_grad():
            for b, src in zip(self._model.buffers(),
                              self.core.model.buffers(), strict=True):
                b.copy_(src)

    def _load_center(self):
        """The replica's parameters := the pulled center, in place."""
        torch._foreach_copy_(self._params, self._center)

    def _pull(self):
        center_host, tag = self.ps.pull(worker_id=self.worker_id)
        center_host = maybe_decode_pull(center_host)
        self._ensure_replica()
        with torch.no_grad():
            for c, name in zip(self._center, self._names):
                c.copy_(torch.from_numpy(center_host[name]))
            self.on_pull(tag)
        self._adopted = True
        return tag

    def _window_fns(self):
        """(streamed, indexed) window functions of this algorithm."""
        core = self.core
        if self.uses_grad_window:
            return core.grad_window, core.indexed_grad_window
        return core.window, core.indexed_window

    def _begin(self, samples, t0, tag, run):
        t1 = time.perf_counter()
        out = run(*self._window_fns())
        acc = None
        if self.uses_grad_window:
            self._opt_state, mets, acc = out
        else:
            self._opt_state, mets = out
        self._pending = {"tag": tag, "mets": mets, "acc": acc,
                         "samples": samples, "t0": t0, "t1": t1}

    def begin_window(self, batches):
        t0 = time.perf_counter()
        tag = self._pull()
        xs, ys = (torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                  for a in stack_window(batches, self.features_col,
                                        self.label_col))
        self._begin(xs.shape[0] * xs.shape[1], t0, tag,
                    lambda window, _: window(self._model, self._opt_state,
                                             self.rng, xs, ys))

    def warmup(self, part, batch_size, device_resident=False):
        """Run one window before training starts, on this worker's own
        replica and optimizer state (reset afterwards), with zero batches:
        the kernels are built, cuBLAS and the allocator are warm, and the
        fused optimizers' tables are the ones training reuses. Without it
        every worker's first window would start in that gap, pull the
        identical initial center, and commit full deltas on top of each
        other — a maximal-staleness burst."""
        batch = next(
            part.batches(batch_size,
                         columns=[self.features_col, self.label_col]),
            None,
        )
        if batch is None:  # partition smaller than one batch
            return
        self._ensure_replica()
        window, indexed = self._window_fns()
        if device_resident:
            self.stage_resident(part)
            idx = torch.zeros((self.window_size, batch_size),
                              dtype=torch.int64, device=self.device)
            out = indexed(self._model, self._opt_state, RngSeq(0),
                          *self._resident, idx)
        else:
            zeros = {k: np.zeros_like(v) for k, v in batch.items()}
            xs, ys = (torch.from_numpy(a).to(self.device) for a in
                      stack_window([zeros] * self.window_size,
                                   self.features_col, self.label_col))
            out = window(self._model, self._opt_state, RngSeq(0), xs, ys)
        _metrics_to_records(out[1])  # waits for the window
        if self._restore_point is not None:
            self._adopt(self._restore_point)
            return
        reset_opt_state(self.core, self._opt_state, self._params)
        self._reset_buffers()
        self._adopted = False

    def stage_resident(self, dataset):
        """Ship this worker's partition to device memory once; later windows
        send only the (W, B) index matrices (``begin_window_indexed``)."""
        if self._resident is not None and self._resident_n == len(dataset):
            return  # already staged (warmup or a retry)
        data_x, data_y = resident_arrays(dataset, self.features_col,
                                         self.label_col)
        self._resident_n = data_x.shape[0]
        self._resident = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (data_x, data_y))

    def iter_index_windows(self, num_epoch, batch_size, shuffle_seed):
        """The resident twin of ``iter_window_batches``: (W, B) index
        matrices, one per commit, across all epochs — the same batches as
        the streamed window stream."""
        for epoch in range(num_epoch):
            yield from epoch_index_windows(
                self._resident_n, batch_size, self.window_size,
                shuffle_seed, epoch,
            )

    def begin_window_indexed(self, idx):
        """``begin_window`` over the device-resident pool: pull + enqueue,
        shipping only the index matrix for this window."""
        t0 = time.perf_counter()
        tag = self._pull()
        ix = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        self._begin(int(idx.size), t0, tag,
                    lambda _, indexed: indexed(self._model, self._opt_state,
                                               self.rng, *self._resident,
                                               ix))

    def finish_window(self):
        pend = self._pending
        self._pending = None
        self.records.extend(_metrics_to_records(pend["mets"]))
        t2 = time.perf_counter()
        with torch.no_grad():
            delta = self.make_delta(pend["acc"])
        if is_compressed(delta) or is_topk(delta):
            delta_np = delta  # elastic workers compress in make_delta
        else:
            delta_np = {n: delta[n].cpu().numpy() for n in self._leaf_order}
            # fold the last commit's compression error in, compress, keep
            # the new residual for the next commit (error feedback) —
            # BEFORE the snapshot below, so a checkpoint carries THIS
            # commit's residual: a snapshot of the previous one would make
            # a resume re-apply that window's error and drop this one's
            if self._compress_kind == "topk":
                delta_np, self._q_residual = topk_compress_with_feedback(
                    delta_np, self._q_residual, self._compress_frac)
            elif self._compress_kind == "int8":
                delta_np, self._q_residual = compress_with_feedback(
                    delta_np, self._q_residual)
        local_snap = None
        if self.keep_snapshot and (self._seq + 1) % self.snapshot_stride == 0:
            local_snap = self._make_snap(self._seq + 1)
        self.ps.commit(delta_np, pend["tag"],
                       commit_id=(self.worker_id, self._seq),
                       local_snap=local_snap)
        self._seq += 1
        if local_snap is not None:
            self._snap = local_snap
        t3 = time.perf_counter()
        self.timings.append((pend["samples"], t3 - pend["t0"]))
        self.splits.append({"pull": pend["t1"] - pend["t0"],
                            "window": t2 - pend["t1"], "commit": t3 - t2})

    def final_snapshot(self):
        """Fresh host-copy snapshot of the worker's end-of-run state (after
        the threads joined, so no window is in flight): the replica's
        parameters and buffers, the optimizer state, the RNG state and the
        commit sequence. None if the worker never trained a window and
        was not restored."""
        if not self._adopted:
            return self._snap
        return self._make_snap(self._seq)

    def iter_window_batches(self, dataset, batch_size, num_epoch, shuffle_seed):
        """The worker's window stream: lists of batches, one list per commit
        (full windows plus each epoch's ragged tail), across all epochs.
        Deterministic given the seed."""
        cols = [self.features_col, self.label_col]
        for epoch in range(num_epoch):
            ds = (
                dataset.shuffle(shuffle_seed + epoch)
                if shuffle_seed is not None
                else dataset
            )
            yield from iter_windows(ds, batch_size, cols, self.window_size)

    def train(self, dataset, batch_size, num_epoch=1, shuffle_seed=None,
              device_resident=False):
        """Thread-mode entry: run all windows of this worker's partition,
        skipping the first ``_start_seq`` after a resume (their commits are
        in the restored center). ``device_resident``: ship the partition to
        the device once and drive the indexed windows; the window stream
        (same shuffles, same batch contents, same ragged tails) is the
        streamed one, so commit sequences — and with them the resume skip
        and the PS dedup — stay aligned across the two feeds."""
        if device_resident:
            self.stage_resident(dataset)
            windows = self.iter_index_windows(num_epoch, batch_size,
                                              shuffle_seed)
            for idx in itertools.islice(windows, self._start_seq, None):
                self.begin_window_indexed(idx)
                self.finish_window()
            return self.records
        windows = self.iter_window_batches(dataset, batch_size, num_epoch,
                                           shuffle_seed)
        for pend in itertools.islice(windows, self._start_seq, None):
            self.begin_window(pend)
            self.finish_window()
        return self.records


class DOWNPOURWorker(AsyncWorker):
    """Pull the center, run W local steps, commit the weight delta
    (reference: distkeras/workers.py -> DOWNPOURWorker)."""

    def on_pull(self, tag):
        self._load_center()  # the replica restarts from the center

    def make_delta(self, acc):
        return {n: p - c for n, p, c in
                zip(self._names, self._params, self._center)}


class ADAGWorker(AsyncWorker):
    """Accumulated Gradient Normalization (Hermans): run W local steps,
    commit -lr * (sum of gradients) / W (reference: distkeras/workers.py ->
    ADAGWorker; the PS adds the pre-normalized delta)."""

    uses_grad_window = True

    def __init__(self, *args, learning_rate=0.01, **kwargs):
        super().__init__(*args, **kwargs)
        self.learning_rate = float(learning_rate)

    def on_pull(self, tag):
        self._load_center()

    def make_delta(self, acc):
        scale = -self.learning_rate / float(self.window_size)
        return {n: a * scale for n, a in zip(self._names, acc)}


class DynSGDWorker(DOWNPOURWorker):
    """DOWNPOUR cadence against the versioned PS: the pull tag (PS update
    counter) rides along with the commit so the server can scale by
    1/(staleness+1) (reference: distkeras/workers.py -> DynSGDWorker)."""


class AEASGDWorker(AsyncWorker):
    """Asynchronous Elastic Averaging SGD (Zhang et al.).

    The local replica persists across windows (it does NOT reset to the
    center). Every window: train W steps, then with elastic force
    e = rho * lr * (x_local - x_center): x_local -= e; commit(e)
    (reference: distkeras/workers.py -> AEASGDWorker).
    """

    def __init__(self, *args, rho=5.0, learning_rate=0.01, **kwargs):
        super().__init__(*args, **kwargs)
        self.rho = float(rho)
        self.learning_rate = float(learning_rate)

    def on_pull(self, tag):
        if not self._adopted:
            self._load_center()  # first window: adopt the center

    def make_delta(self, acc):
        alpha = self.rho * self.learning_rate
        elastic = {n: (p - c) * alpha for n, p, c in
                   zip(self._names, self._params, self._center)}
        if self._compress_kind is not None:
            # the elastic rule applies the displacement on BOTH sides
            # (x_local -= e, center += e); compress BEFORE the local
            # subtraction so both apply the identical reconstructed value
            # — raw locally and reconstructed at the PS would make replica
            # and center drift apart. No residual: the unshipped remainder
            # stays in x_local and re-enters the next elastic difference.
            host = {n: elastic[n].cpu().numpy() for n in self._leaf_order}
            if self._compress_kind == "topk":
                payload, deq = topk_compress(host, self._compress_frac)
            else:
                payload, deq = quantize_tree(host)
            for n, p in zip(self._names, self._params):
                p.sub_(torch.from_numpy(deq[n]).to(p.device))
            return payload
        for n, p in zip(self._names, self._params):
            p.sub_(elastic[n])
        return elastic


class EAMSGDWorker(AEASGDWorker):
    """Elastic averaging with momentum: identical elastic rule; the momentum
    lives in the worker's local optimizer (the trainer builds it with
    Nesterov momentum — reference: distkeras/workers.py -> EAMSGDWorker)."""
