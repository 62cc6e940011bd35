"""Trainer orchestration (PyTorch port of the parts of
``distkeras_tpu.trainers`` that run on one card: ``Trainer``,
``SingleTrainer``, the member trainers ``EnsembleTrainer`` and
``AveragingTrainer``, and the asynchronous parameter-server trainers —
``DistributedTrainer`` and ``DOWNPOUR``, ``AEASGD``, ``EAMSGD``, ``ADAG``,
``DynSGD``).

Same constructor vocabulary (``worker_optimizer``, ``loss``, ``metrics``,
``learning_rate``, ``batch_size``, ``num_epoch``, ``seed``, ...) and the
same contract: ``trainer.train(dataset) -> trained model``, a new model;
the caller's keeps its weights. ``checkpoint_dir=`` with
``train(..., resume=True)``, ``profile_dir=`` (a ``torch.profiler`` Chrome
trace) and ``metrics_path=`` (JSONL rows) work as in the JAX package, and
so do the async trainers' commit and pull compression, their socket tier
(``serve_socket``, ``remote_ps``) and warm-standby failover
(``standby``). The synchronous data-parallel and other multi-card
strategies come with a machine of more than one card.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from distkeras_tpu_torch.data.prefetch import Prefetcher
from distkeras_tpu_torch.networking import RetryPolicy

from distkeras_tpu_torch.ops.optimizers import (
    effective_learning_rate,
    export_state,
    get_optimizer,
)
from distkeras_tpu_torch.ops.quantization import count_quantized
from distkeras_tpu_torch.parameter_servers import (
    ADAGParameterServer,
    DeltaParameterServer,
    DynSGDParameterServer,
    RemoteParameterServerClient,
    SocketParameterServer,
)
from distkeras_tpu_torch.utils.checkpoint import Checkpointer
from distkeras_tpu_torch.utils.compression import (
    parse_compress_spec,
    validate_pull_compress,
)
from distkeras_tpu_torch.utils.device import (
    check_model_device,
    local_devices,
    resolve_device,
)
from distkeras_tpu_torch.utils.history import TrainingHistory
from distkeras_tpu_torch.utils.profiling import MetricsLogger
from distkeras_tpu_torch.utils.profiling import trace as profiler_trace
from distkeras_tpu_torch.utils.rng import RngSeq, split_seed
from distkeras_tpu_torch.utils.tree import (
    copy_tree_,
    to_host,
    tree_mean,
    tree_signature,
)
from distkeras_tpu_torch.workers import (
    ADAGWorker,
    AEASGDWorker,
    DOWNPOURWorker,
    DynSGDWorker,
    EAMSGDWorker,
    SingleTrainerWorker,
    WorkerCore,
    _metrics_to_records,
    iter_windows,
    reset_opt_state,
    stack_window,
    to_device,
)

logger = logging.getLogger(__name__)


def _maybe_len(dataset):
    try:
        return len(dataset)
    except TypeError:
        return None


class Trainer:
    """Base trainer: model + optimizer/loss spec + history bookkeeping
    (reference: distkeras/trainers.py -> Trainer)."""

    supports_validation = True  # see validation_data handling in __init__

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
        # metrics in the history); None disables. Trainers without a
        # global epoch boundary (async: workers own their partitions for
        # all epochs) reject it loudly rather than record nothing
        if validation_data is not None and not self.supports_validation:
            raise TypeError(
                f"{type(self).__name__} does not support per-epoch "
                "validation_data — evaluate the returned model with "
                "ModelPredictor/AccuracyEvaluator instead"
            )
        self.validation_data = validation_data
        # observability: a torch.profiler trace of train() into
        # profile_dir, JSONL rows (validation, failures, the train_end
        # summary) into metrics_path
        self.profile_dir = profile_dir
        self.metrics_logger = MetricsLogger(metrics_path) if metrics_path else None
        self.checkpointer = None
        self.checkpoint_every = 0

    def _make_core(self, model=None) -> WorkerCore:
        """The trainer's step core around ``model`` (default: the caller's
        model, which the workers copy before they train)."""
        return WorkerCore(
            self.model if model is None else model,
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

    def _finish_center(self, center, buffers):
        """The result model: a copy of the caller's with the center's
        weights and the aggregated buffers, in eval mode."""
        result = self.model.copy()
        result.set_weights([center[n] for n in result._leaf_order()])
        own = dict(result.named_buffers())
        with torch.no_grad():
            for name, value in buffers.items():
                own[name].copy_(torch.from_numpy(value))
        return self._finish(result)

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
        if self.metrics_logger is not None:
            self.metrics_logger.log(event="validation", epoch=epoch, **avg)
        return avg

    # -- checkpointing ------------------------------------------------------

    def _init_checkpointing(self, checkpoint_dir, checkpoint_every, max_to_keep):
        self.checkpointer = (
            Checkpointer(checkpoint_dir, max_to_keep=max_to_keep)
            if checkpoint_dir
            else None
        )
        self.checkpoint_every = int(checkpoint_every)

    def _restore_latest(self):
        """(step, trees, meta) of the latest checkpoint, or None."""
        if self.checkpointer is None or self.checkpointer.latest_step() is None:
            return None
        return self.checkpointer.restore()

    def _should_checkpoint(self, done: int) -> bool:
        """THE epoch-snapshot policy: every ``checkpoint_every`` epochs
        (0 = final only) and always at the last epoch."""
        every = self.checkpoint_every
        return (every > 0 and done % every == 0) or done == self.num_epoch

    def _epoch_end(self, core, epoch, model, opt_state, rng):
        """THE per-epoch finalization: validate, then checkpoint (both
        no-ops when unconfigured)."""
        self._run_validation(core, model, epoch + 1)
        self._save_epoch_checkpoint(epoch + 1, model, opt_state, rng)

    def _reconcile_opt_state(self, candidate, core):
        """The restored optimizer state, or None when the checkpoint holds
        another layout (another optimizer, or a JAX optax state not yet
        converted by ``utils.convert.opt_state_from_jax``). The reference
        layout is built on the meta device: no moment is allocated."""
        meta_params = [torch.empty_like(p, device="meta")
                       for p in core.model.parameters()]
        reference = export_state(core.optimizer,
                                 core.init_opt_state(meta_params))
        if tree_signature(candidate) == tree_signature(reference):
            return candidate
        logger.warning(
            "checkpoint opt_state layout does not match this trainer; "
            "reinitializing optimizer state"
        )
        return None

    def _save_epoch_checkpoint(self, done, model, opt_state, rng):
        """Epoch-granular snapshot (policy: ``_should_checkpoint``): the
        parameters and buffers by ``state_dict`` name, the optimizer's
        exported state and the rng."""
        if self.checkpointer is None or not self._should_checkpoint(done):
            return
        self.checkpointer.save(
            done,
            {
                "params": dict(model.named_parameters()),
                "state": dict(model.named_buffers()),
                "opt_state": export_state(self.optimizer, opt_state),
                "rng": rng.get_state(),
            },
            {"epoch": done},
        )

    def train(self, dataset, shuffle=False, resume=False):
        """Train on ``dataset`` (``shuffle``: reshuffle every epoch with
        ``seed + epoch``); returns the trained model. ``resume``: continue
        from the latest checkpoint in ``checkpoint_dir``. With
        ``profile_dir`` the run is traced; with ``metrics_path`` a
        ``train_end`` summary row closes it."""
        if self.profile_dir:
            device = getattr(self, "device", None)
            with profiler_trace(self.profile_dir,
                                cuda=resolve_device(device).type == "cuda"):
                result = self._train(dataset, shuffle=shuffle, resume=resume)
        else:
            result = self._train(dataset, shuffle=shuffle, resume=resume)
        self._log_summary()
        return result

    def _log_summary(self):
        if self.metrics_logger is None:
            return
        avg = {f"avg_{k}": v for k, v in self.get_averaged_metrics().items()}
        self.metrics_logger.log(
            event="train_end",
            trainer=type(self).__name__,
            training_time=self.get_training_time(),
            num_updates=self.history.num_updates(),
            total_samples=self.history.total_samples(),
            samples_per_sec=self.history.samples_per_second(),
            **avg,
        )

    def _train(self, dataset, shuffle=False, resume=False):
        raise NotImplementedError


class SingleTrainer(Trainer):
    """One worker, one device — the correctness anchor (reference:
    distkeras/trainers.py -> SingleTrainer).

    ``device=None`` means CUDA (raises without a GPU; the model must live
    on the device asked for). ``window``: steps between host reads of the
    metrics. ``prefetch``: windows staged ahead on a background thread
    (default 0: synchronous). ``device_resident``: the dataset is copied to
    the device once and each step gathers its batch by index;
    bit-identical to the streamed path. ``checkpoint_dir``: a checkpoint
    every ``checkpoint_every`` epochs (0: the last only) and at the last,
    ``max_to_keep`` of them kept; ``train(..., resume=True)`` runs the
    remaining epochs from the latest one."""

    def __init__(
        self,
        *args,
        window=8,
        device=None,
        prefetch=0,
        device_resident=False,
        checkpoint_dir=None,
        checkpoint_every=1,
        max_to_keep=3,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.window = int(window)
        self.device = device
        self.prefetch = int(prefetch)
        self.device_resident = bool(device_resident)
        self._init_checkpointing(checkpoint_dir, checkpoint_every, max_to_keep)

    def _train(self, dataset, shuffle=False, resume=False):
        self.history.record_training_start()
        core = self._make_core()
        worker = SingleTrainerWorker(
            core,
            self.features_col,
            self.label_col,
            seed=self.seed,
            device=self.device,
        )
        initial_full, start_epoch = None, 0
        if resume:
            restored = self._restore_latest()
            if restored is not None:
                _, trees, meta = restored
                initial_full = (
                    trees["params"],
                    trees.get("state", {}),
                    self._reconcile_opt_state(trees["opt_state"], core),
                    trees.get("rng"),
                )
                start_epoch = int(meta["epoch"])

        on_epoch_end = None
        if self.checkpointer is not None or self.validation_data is not None:
            def on_epoch_end(epoch, model, opt_state, rng):
                self._epoch_end(core, epoch, model, opt_state, rng)

        model, records = worker.train(
            dataset,
            self.batch_size,
            num_epoch=self.num_epoch,
            window=self.window,
            shuffle_seed=self.seed if shuffle else None,
            initial_full=initial_full,
            start_epoch=start_epoch,
            on_epoch_end=on_epoch_end,
            prefetch=self.prefetch,
            device_resident=self.device_resident,
        )
        self.history.extend(0, records)
        for s, dt in worker.timings:
            self.history.record_window(0, s, dt)
        self.history.record_training_end()
        return self._finish(model)


def _build_member(model, seed):
    """A member of the member trainers: a copy of the caller's model (its
    layers and hooks) built anew from ``seed`` on the device it lives on —
    the JAX package's ``model_i.build(model.input_shape, seed=seed + i)``.
    The port's ``build`` draws from a torch generator, not a JAX key, so
    the members' inits are the port's own."""
    member = model.copy()
    member.build(model.input_shape, seed=seed,
                 device=next(model.parameters()).device)
    return member


def _joint_member_windows(parts, batch_size, cols, window):
    """Joint window stream for vmapped member training: per step, one
    window from EVERY member's partition, truncated to the shortest
    (members must step with identical shapes; tails differ by at most one
    batch across near-equal partitions)."""
    streams = [iter_windows(p, batch_size, cols, window) for p in parts]
    while True:
        wnds = [next(s, None) for s in streams]
        if any(w is None for w in wnds):
            return
        depth = min(len(w) for w in wnds)
        yield [w[:depth] for w in wnds]


def _member_prepare(cols, device):
    """Host-staging closure for the prefetch thread: stack the member axis
    and ship it to the device while the device computes."""

    def prepare(wnds):
        staged = [stack_window(w, *cols) for w in wnds]
        return tuple(to_device(np.stack([s[k] for s in staged]), device)
                     for k in (0, 1))

    return prepare


def _record_member_step(history, m, mets, xs, dt):
    """Per-joint-step bookkeeping shared by the vmapped member trainers:
    split the (member, window) metric tensors into per-member history
    records (one read from the device) and attribute the step's wall time
    across members."""
    names = list(mets)
    host = torch.stack([mets[k].float() for k in names]).cpu().numpy()
    for i in range(m):
        history.extend(i, [{k: float(host[a, i, j])
                            for a, k in enumerate(names)}
                           for j in range(host.shape[2])])
        history.record_window(i, xs.shape[1] * xs.shape[2], dt / m)


def _run_threads(fn, n):
    """``fn(i)`` for i < n, each in its own thread; the first exception a
    thread raised is re-raised here once all have joined."""
    errors = []

    def run(i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


class EnsembleTrainer(Trainer):
    """Train ``num_models`` independent models on disjoint partitions; return
    the list (reference: distkeras/trainers.py -> EnsembleTrainer).

    Member ``i`` is the caller's model built anew from ``seed + i``, trained
    with ``SingleTrainerWorker`` seeded ``seed + i``. By default each
    member trains in a Python thread of its own, all on the one card.
    ``vmapped=True`` is the single-card counterpart of the JAX package's
    one ``vmap`` program: the members step together, each joint step
    running every member's forward and backward in turn and then ONE
    optimizer apply over all members' parameters (``WorkerCore.
    member_window``; on CUDA one fused-kernel launch per step for all
    members). Members see the same per-partition window streams as the
    threaded path; each joint step truncates to the SHORTEST member's
    window, so batches past the shortest tail are dropped — size
    partitions to tile evenly for exact thread-mode parity. ``prefetch``:
    joint windows staged ahead by a background thread (vmapped path).
    ``device=None`` means CUDA (the model must live there)."""

    supports_validation = False

    def __init__(
        self, *args, num_models=2, window=8, vmapped=False, prefetch=0,
        device=None, **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.num_models = int(num_models)
        self.window = int(window)
        self.vmapped = bool(vmapped)
        self.prefetch = int(prefetch)
        self.device = device

    def _train(self, dataset, shuffle=False, resume=False):
        if resume:
            raise ValueError("EnsembleTrainer does not support resume")
        check_model_device(self.model, self.device)
        if self.vmapped:
            return self._train_vmapped(dataset, shuffle)
        self.history.record_training_start()
        parts = (dataset.shuffle(self.seed) if shuffle else dataset).partition(
            self.num_models
        )
        devices = local_devices(self.device)
        results = [None] * self.num_models

        def run(i):
            # independent init per ensemble member
            member = _build_member(self.model, self.seed + i)
            worker = SingleTrainerWorker(
                self._make_core(member),
                self.features_col,
                self.label_col,
                seed=self.seed + i,
                device=devices[i % len(devices)],
            )
            model_i, records = worker.train(
                parts[i],
                self.batch_size,
                num_epoch=self.num_epoch,
                window=self.window,
            )
            self.history.extend(i, records)
            for s, dt in worker.timings:
                self.history.record_window(i, s, dt)
            results[i] = self._finish(model_i)

        _run_threads(run, self.num_models)
        self.history.record_training_end()
        return results

    def _train_vmapped(self, dataset, shuffle=False):
        self.history.record_training_start()
        m = self.num_models
        core = self._make_core()
        parts = (dataset.shuffle(self.seed) if shuffle else dataset).partition(m)
        device = local_devices(self.device)[0]
        # independent init per member (the threaded path's contract), one
        # optimizer state over the members' concatenated parameters
        members = [_build_member(self.model, self.seed + i) for i in range(m)]
        opt_state = core.init_opt_state(
            [p for mm in members for p in mm.parameters()])
        rngs = [RngSeq(self.seed + i) for i in range(m)]
        cols = [self.features_col, self.label_col]
        for _epoch in range(self.num_epoch):
            with Prefetcher(
                _joint_member_windows(parts, self.batch_size, cols,
                                      self.window),
                _member_prepare(cols, device),
                depth=self.prefetch,
            ) as staged_windows:
                for xs, ys in staged_windows:
                    t0 = time.perf_counter()
                    opt_state, mets = core.member_window(
                        members, opt_state, rngs, xs, ys)
                    _record_member_step(self.history, m, mets, xs,
                                        time.perf_counter() - t0)
        self.history.record_training_end()
        return [self._finish(mm) for mm in members]


class AveragingTrainer(Trainer):
    """Per epoch: train a replica per partition from the current center, then
    average the replicas' weights (reference: distkeras/trainers.py ->
    AveragingTrainer).

    Every replica restarts each epoch from the center with a fresh
    optimizer and the rng ``seed + epoch`` forked for its index; the new
    center is the mean of the replicas' parameters and replica 0's buffers
    (e.g. BatchNorm's moving statistics) its state. Threaded by default
    (one Python thread per replica on the one card, the mean taken on the
    host); ``vmapped=True`` steps the replicas together as
    ``EnsembleTrainer(vmapped=True)`` does (one optimizer apply for all per
    step, joint steps truncated to the shortest replica window) and takes
    the epoch-end mean on the device, only the 1/m-sized result going to
    the host. ``device=None`` means CUDA (the model must live there)."""

    supports_validation = False

    def __init__(
        self, *args, num_workers=2, window=8, vmapped=False, prefetch=0,
        device=None, **kwargs,
    ):
        super().__init__(*args, **kwargs)
        self.num_workers = int(num_workers)
        self.window = int(window)
        self.vmapped = bool(vmapped)
        self.prefetch = int(prefetch)
        self.device = device

    def _replica_rng(self, epoch, i):
        """Replica ``i``'s seed stream for ``epoch``: the port's fork of
        ``seed + epoch`` for index ``i`` (the role of JAX's
        ``fold_in(PRNGKey(seed + epoch), i)``)."""
        return RngSeq(split_seed(self.seed + epoch, i + 1)[-1])

    def _train(self, dataset, shuffle=False, resume=False):
        if resume:
            raise ValueError("AveragingTrainer does not support resume")
        check_model_device(self.model, self.device)
        if self.vmapped:
            return self._train_vmapped(dataset, shuffle)
        self.history.record_training_start()
        core = self._make_core()
        parts = (dataset.shuffle(self.seed) if shuffle else dataset).partition(
            self.num_workers
        )
        devices = local_devices(self.device)
        cols = [self.features_col, self.label_col]
        center = to_host(dict(self.model.named_parameters()))
        state = to_host(dict(self.model.named_buffers()))
        # one replica (model + optimizer state) per worker, kept across
        # epochs and reset in place, so the fused kernels' tables stay valid
        replicas = [None] * self.num_workers

        for epoch in range(self.num_epoch):
            results = [None] * self.num_workers

            def run(i, epoch=epoch, center=center, state=state):
                dev = devices[i % len(devices)]
                if replicas[i] is None:
                    model = self.model.copy().to(dev)
                    params = list(model.parameters())
                    replicas[i] = (model, params,
                                   core.init_opt_state(params))
                model, params, opt_i = replicas[i]
                copy_tree_(dict(model.named_parameters()), center)
                copy_tree_(dict(model.named_buffers()), state)
                reset_opt_state(core, opt_i, params)
                rng = self._replica_rng(epoch, i)
                records = []
                for pend in iter_windows(parts[i], self.batch_size, cols,
                                         self.window):
                    t0 = time.perf_counter()
                    xs, ys = (to_device(a, dev)
                              for a in stack_window(pend, *cols))
                    opt_i, mets = core.window(model, opt_i, rng, xs, ys)
                    records.extend(_metrics_to_records(mets))
                    self.history.record_window(
                        i, xs.shape[0] * xs.shape[1], time.perf_counter() - t0
                    )
                self.history.extend(i, records)
                results[i] = (to_host(dict(model.named_parameters())),
                              to_host(dict(model.named_buffers())))

            _run_threads(run, self.num_workers)
            center = tree_mean([r[0] for r in results])
            state = results[0][1]

        self.history.record_training_end()
        return self._finish_center(center, state)

    def _train_vmapped(self, dataset, shuffle=False):
        self.history.record_training_start()
        m = self.num_workers
        core = self._make_core()
        parts = (dataset.shuffle(self.seed) if shuffle else dataset).partition(m)
        device = local_devices(self.device)[0]
        cols = [self.features_col, self.label_col]
        replicas = [self.model.copy() for _ in range(m)]
        params = [list(r.parameters()) for r in replicas]
        flat = [p for ps in params for p in ps]
        opt_state = core.init_opt_state(flat)
        with torch.no_grad():
            center = [p.detach().clone() for p in self.model.parameters()]
        center_state = dict(self.model.named_buffers())

        for epoch in range(self.num_epoch):
            # every replica restarts the epoch from the shared center with
            # a fresh optimizer, exactly like the threaded path
            with torch.no_grad():
                for ps in params:
                    torch._foreach_copy_(ps, center)
            for r in replicas:
                copy_tree_(dict(r.named_buffers()), center_state)
            reset_opt_state(core, opt_state, flat)
            rngs = [self._replica_rng(epoch, i) for i in range(m)]
            with Prefetcher(
                _joint_member_windows(parts, self.batch_size, cols,
                                      self.window),
                _member_prepare(cols, device),
                depth=self.prefetch,
            ) as staged_windows:
                for xs, ys in staged_windows:
                    t0 = time.perf_counter()
                    opt_state, mets = core.member_window(
                        replicas, opt_state, rngs, xs, ys)
                    _record_member_step(self.history, m, mets, xs,
                                        time.perf_counter() - t0)
            # epoch-end averaging on the device; state follows the threaded
            # path's convention (replica 0's)
            with torch.no_grad():
                center = [torch.stack(leaf).mean(0) for leaf in zip(*params)]
            center_state = {k: v.detach().clone()
                            for k, v in replicas[0].named_buffers()}

        names = [n for n, _ in self.model.named_parameters()]
        self.history.record_training_end()
        return self._finish_center(dict(zip(names, to_host(center))),
                                   to_host(center_state))


class DistributedTrainer(Trainer):
    """Template for PS-based distributed training (reference:
    distkeras/trainers.py -> DistributedTrainer): partition the data, start
    the PS, launch the workers, collect, read the center back.

    ``mode``: "threads" (true async: one thread per worker, workers mapped
    round-robin onto ``local_devices(device)``, all on one card in this
    port) or "simulated" (a seeded deterministic interleaving of pulls and
    commits across workers — reproducible staleness, bit for bit the JAX
    package's schedule). ``device=None`` means CUDA (raises without a GPU;
    the model must live there). The PS is host numpy in this process;
    ``serve_socket`` also serves it over TCP (``SocketParameterServer``),
    ``remote_ps`` makes the workers reach it through that socket
    (``RemoteParameterServerClient``, loopback on one host) and
    ``standby`` runs a warm standby that follows every commit and, with
    ``remote_ps``, promotes on the primary's loss while the workers'
    clients fail over to it (both imply ``serve_socket``). ``compress``
    ("int8", "topk", "topk:<frac>") compresses the commits,
    ``pull_compress`` ("bfloat16", "int8") the pulled center.

    ``checkpoint_dir``: a checkpoint every ``checkpoint_every`` PS commits
    (0: the final snapshot only) and at the end of the run, ``max_to_keep``
    of them kept — the center, the PS meta (update count, DynSGD's version,
    the exactly-once dedup table) and each worker's local state (replica,
    buffers, optimizer state, rng, commit seq; handed to the PS every
    ``worker_snapshot_stride`` commits). ``train(..., resume=True)``
    restores them, and each worker skips the windows the restored center
    already absorbed; a checkpoint of another window stream (batch size,
    workers, window, seed, shuffle, rows) is refused.
    """

    supports_validation = False

    worker_cls = None
    ps_cls = DeltaParameterServer

    def __init__(
        self,
        *args,
        num_workers=2,
        communication_window=5,
        mode="threads",
        serve_socket=False,
        remote_ps=False,
        standby=False,
        checkpoint_dir=None,
        checkpoint_every=0,
        max_to_keep=3,
        worker_snapshot_stride=1,
        worker_retries=1,
        heartbeat_timeout=None,
        elastic=False,
        device_resident=False,
        compress=None,
        pull_compress=None,
        device=None,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        # compress="int8": commit deltas ride quantized with error feedback
        # (utils/compression), ~4x fewer commit bytes; "topk" /
        # "topk:<frac>": only the k = ceil(frac*n) largest-|x| entries per
        # leaf, the unshipped mass carried by the same residual. The PS
        # reconstructs either before its rule.
        parse_compress_spec(compress)  # validate the spec (raises early)
        self.compress = compress
        # pull_compress="bfloat16" / "int8": the pulled center ships
        # encoded (half / a quarter of the pull bytes); workers decode on
        # receipt
        self.pull_compress = validate_pull_compress(pull_compress)
        self.num_workers = int(num_workers)
        self.communication_window = int(communication_window)
        self.mode = mode
        self.device = device
        # device_resident: each worker ships its partition to the device
        # once and sends only (W, B) index matrices per window; the window
        # stream is the streamed one, bit for bit
        self.device_resident = bool(device_resident)
        # fault tolerance: a crashed worker thread is retried up to
        # worker_retries times (commit-seq dedup at the PS makes the replay
        # exactly-once); heartbeat_timeout (seconds) starts a monitor that
        # flags workers gone silent; elastic=True lets a worker that
        # finished its own partition adopt one whose owner gave up
        self.worker_retries = int(worker_retries)
        self.heartbeat_timeout = heartbeat_timeout
        self.elastic = bool(elastic)
        # remote_ps: the workers reach the PS through the TCP socket
        # protocol (the cross-host path) even on one host. standby: a warm
        # standby PS follows the primary's snapshot and every post-dedup
        # commit and promotes on primary loss; the remote workers' clients
        # carry both endpoints and fail over with exactly-once commit
        # resend. Both ride the socket protocol, so both imply serve_socket
        # (in-process workers with a standby get replication, not
        # transparent failover: they hold the primary object)
        self.remote_ps = bool(remote_ps)
        self.standby = bool(standby)
        self.serve_socket = bool(serve_socket) or self.remote_ps or self.standby
        self.service = None
        self.standby_service = None
        # failover ledger: client endpoint rotations and standby promotions
        self.ps_failovers = 0
        self.ps_promotions = []
        self._failover_lock = threading.Lock()
        # checkpoint_every counts PS commits here; every
        # worker_snapshot_stride-th commit hands the worker's local state
        # to the PS (a resumed worker replays at most stride-1 windows,
        # which the PS dedup absorbs)
        self._init_checkpointing(checkpoint_dir, checkpoint_every, max_to_keep)
        self.worker_snapshot_stride = int(worker_snapshot_stride)
        self._stream_fp = None
        self.parameter_server = None
        # the last run's workers: their records, timings and per-window
        # host splits (pull / window / commit seconds)
        self.workers = []
        self.failures = []
        self.suspicions = []
        self.adoptions = []  # [{worker_id, adopted_by, ok}]

    # -- template hooks -----------------------------------------------------

    def allocate_parameter_server(self):
        """The PS over the caller's weights, in the JAX leaf order (with
        ``pull_compress`` when one is set)."""
        kw = {"pull_compress": self.pull_compress} if self.pull_compress else {}
        return self.ps_cls(dict(zip(self.model._leaf_order(),
                                    self.model.get_weights())), **kw)

    def worker_kwargs(self) -> dict:
        return {}

    def allocate_worker(self, core, worker_id, device):
        ps = self.parameter_server
        if self.remote_ps:
            # the policy paces reconnect() redials AND the client's
            # in-operation failover: one refused connection must not burn a
            # whole worker_retries attempt
            endpoints = [("127.0.0.1", self.service.port)]
            if self.standby_service is not None:
                # primary first (sticky), standby second
                endpoints.append(("127.0.0.1", self.standby_service.port))
            ps = RemoteParameterServerClient(
                endpoints=endpoints,
                retry=RetryPolicy(max_attempts=8, base_delay=0.05,
                                  budget=30.0),
                on_failover=self._note_failover,
            )
        w = self.worker_cls(
            core,
            ps,
            worker_id,
            self.features_col,
            self.label_col,
            self.communication_window,
            seed=self.seed,
            device=device,
            compress=self.compress,
            **self.worker_kwargs(),
        )
        # periodic checkpoints need the workers' local state at each
        # commit; with checkpoint_every=0 only the end-of-run save reads
        # it (fresh, from final_snapshot), so the copies are skipped
        w.keep_snapshot = (self.checkpointer is not None
                           and self.checkpoint_every > 0)
        w.snapshot_stride = self.worker_snapshot_stride
        return w

    # -- the socket tier ----------------------------------------------------

    def start_service(self):
        """Start the PS and, with ``serve_socket``, its socket server; with
        ``standby``, a warm standby of the same class synced from the
        primary's consistent snapshot (a resumed primary's restored state
        replicates too). With ``remote_ps`` the durability gate is armed on
        both (no commit acked without a live replica; the promoted sole
        survivor relaxes it): only the remote client's policy-paced resend
        rides out a re-sync window, and the standby promotes only when the
        workers can follow it."""
        self.parameter_server.start()
        if self.serve_socket:
            self.service = SocketParameterServer(self.parameter_server,
                                                 host="127.0.0.1")
            self.service.start()
        if self.standby:
            standby_ps = self.allocate_parameter_server()
            if self.remote_ps:
                self.parameter_server.require_replicas(1)
                standby_ps.require_replicas(1)
            self.standby_service = SocketParameterServer(
                standby_ps, host="127.0.0.1",
                standby_of=("127.0.0.1", self.service.port),
                on_promote=self._on_standby_promote,
                auto_promote=self.remote_ps,
            )
            self.standby_service.start()

    def stop_service(self):
        if self.standby_service is not None:
            self.standby_service.stop()
        if self.service is not None:
            self.service.stop()
            self.service = None
        self.parameter_server.stop()

    def active_parameter_server(self):
        """The PS whose state is authoritative now: the promoted standby's
        after a failover, the primary's otherwise. Remote mode only:
        in-process workers commit to the primary object to the end, so a
        promotion never outranks it."""
        if (self.remote_ps and self.standby_service is not None
                and self.standby_service.promoted):
            return self.standby_service.ps
        return self.parameter_server

    def _note_failover(self, endpoint):
        with self._failover_lock:
            self.ps_failovers += 1
        if self.metrics_logger is not None:
            self.metrics_logger.log(event="ps_failover",
                                    endpoint=list(endpoint))

    def _on_standby_promote(self, service):
        """Checkpointing re-attaches to the promoted standby's PS (its dedup
        table and worker snapshots rode the replication stream, so its
        snapshots restore like the primary's)."""
        self.ps_promotions.append(
            {"port": service.port, "reason": service.promote_reason})
        self._attach_checkpointing(service.ps)
        if self.metrics_logger is not None:
            self.metrics_logger.log(event="ps_promoted", port=service.port,
                                    reason=service.promote_reason)

    # -- checkpointing ------------------------------------------------------

    def _attach_checkpointing(self, ps):
        """A checkpoint every ``checkpoint_every`` commits, from the copies
        the PS takes inside the commit's locked section: the checkpoint
        labelled n is exactly the n-update center, and each worker state
        it holds is at or behind that center, never ahead."""
        if self.checkpointer is None or self.checkpoint_every <= 0:
            return

        def on_snapshot(n, center, meta, worker_snaps):
            trees = {"center": center}
            workers = {str(wid): snap for wid, snap in worker_snaps.items()
                       if snap is not None}
            if workers:
                trees["workers"] = workers
            self.checkpointer.save(
                n, trees, {"ps_meta": meta, "stream": self._stream_fp})

        ps.add_snapshot_listener(on_snapshot, every=self.checkpoint_every)

    def _restore_run(self):
        """Restore the PS from the latest checkpoint; returns the saved
        worker states ({worker id as str: snapshot}), empty when there is
        none. Refuses a checkpoint of another window stream: the resume
        skip maps commit seqs back to positions in it."""
        restored = self._restore_latest()
        if restored is None:
            return {}
        _, trees, meta = restored
        saved_fp = meta.get("stream")
        if saved_fp is not None and saved_fp != self._stream_fp:
            raise ValueError(
                "resume config does not match the checkpoint's window "
                f"stream: checkpoint {saved_fp}, current {self._stream_fp}. "
                "Resuming with a different batch_size/num_workers/"
                "communication_window/seed/shuffle/dataset misaligns the "
                "skip positions; start fresh or restore the config."
            )
        self.parameter_server.restore_snapshot(trees["center"],
                                               meta.get("ps_meta", {}))
        workers = trees.get("workers", {})
        # checkpoints taken before a worker's first post-resume commit
        # keep its restored state
        self.parameter_server.restore_worker_snapshots(workers)
        return workers

    def _save_final_checkpoint(self, workers):
        """The end-of-run checkpoint, at the final commit count: the workers
        are idle, so each one's fresh snapshot is exact even where the
        stride skipped its last commits. ``overwrite``: a periodic snapshot
        at the same count holds staler worker states."""
        center, meta = self.active_parameter_server().snapshot()
        trees = {"center": center}
        snaps = {str(w.worker_id): w.final_snapshot() for w in workers}
        snaps = {k: v for k, v in snaps.items() if v is not None}
        if snaps:
            trees["workers"] = snaps
        self.checkpointer.save(
            meta.get("num_updates", 0), trees,
            {"ps_meta": meta, "stream": self._stream_fp}, overwrite=True)

    # -- run ----------------------------------------------------------------

    def _train(self, dataset, shuffle=False, resume=False):
        self.history.record_training_start()
        self.failures, self.suspicions, self.adoptions = [], [], []
        self.ps_failovers, self.ps_promotions = 0, []
        check_model_device(self.model, self.device)
        core = self._make_core()
        self.parameter_server = self.allocate_parameter_server()
        # the window-stream fingerprint: everything that fixes which
        # windows a worker's commit seqs stand for
        self._stream_fp = {
            "batch_size": self.batch_size,
            "num_workers": self.num_workers,
            "communication_window": self.communication_window,
            "seed": self.seed,
            "shuffle": bool(shuffle),
            "rows": _maybe_len(dataset),
        }
        restored_workers = self._restore_run() if resume else {}
        self._attach_checkpointing(self.parameter_server)
        self.start_service()
        self.workers = workers = []
        try:
            parts = (dataset.shuffle(self.seed) if shuffle
                     else dataset).partition(self.num_workers)
            devices = local_devices(self.device)
            workers.extend(
                self.allocate_worker(core, i, devices[i % len(devices)])
                for i in range(self.num_workers)
            )
            for w in workers:
                snap = restored_workers.get(str(w.worker_id))
                if snap is not None:
                    w.restore_snapshot(snap)
            if self.mode == "threads":
                self._warmup(core, workers[0], parts[0])
                self._run_threads(workers, parts)
            elif self.mode == "simulated":
                self._run_simulated(workers, parts)
            else:
                raise ValueError(f"unknown mode {self.mode!r}")
            for w in workers:
                self.history.extend(w.worker_id, w.records)
                for s, dt in w.timings:
                    self.history.record_window(w.worker_id, s, dt)
        finally:
            # sockets and threads must not outlive a failed train()
            if self.remote_ps:
                for w in workers:
                    w.ps.close()
            self.stop_service()
        if self.checkpointer is not None:
            self._save_final_checkpoint(workers)
        self.history.record_training_end()
        # after a failover the promoted standby's center is the run's
        return self._finish_center(self.active_parameter_server().get_params(),
                                   self._aggregate_worker_states(workers))

    def _aggregate_worker_states(self, workers):
        """Mutable model state (the replicas' buffers, e.g. moving
        statistics) to pair with the center: per leaf over every worker
        that trained a window — ``aux_loss`` leaves (transient per-step
        outputs) pass the first worker's through, integer and bool leaves
        (progress markers) take the elementwise max, float leaves the
        elementwise mean in f32 cast back to their dtype. Empty when the
        model has no buffers or no worker trained."""
        states = [dict(w._model.named_buffers()) for w in workers
                  if w._adopted]
        out = {}
        for name in states[0] if states else ():
            xs = [s[name].detach().cpu().numpy() for s in states]
            if name.rsplit(".", 1)[-1] == "aux_loss":
                out[name] = xs[0]
            elif xs[0].dtype.kind in ("i", "u", "b"):
                out[name] = np.maximum.reduce(xs)
            else:
                out[name] = np.mean(np.stack(
                    [x.astype(np.float32) for x in xs]), axis=0
                ).astype(xs[0].dtype)
        return out

    def _warmup(self, core, worker, part):
        """One window before the worker threads start (``AsyncWorker.
        warmup``): kernels built, cuBLAS warm, tables made — so the first
        windows do not all start together from the initial center."""
        worker.warmup(part, self.batch_size, self.device_resident)

    def _run_threads(self, workers, parts):
        done = set()  # worker ids that exited (finished or gave up) — a
        done_lock = threading.Lock()  # completed worker is not a failure
        orphans = []  # [(worker, part)] partitions whose owner gave up

        def attempt_partition(w, part, adopted_by=None, reset_first=False):
            """Run one partition to completion with the retry budget; True
            on success. Every ``reset_for_retry`` runs inside the crash
            boundary."""
            for attempt in range(self.worker_retries + 1):
                try:
                    if attempt > 0 or reset_first:
                        w.reset_for_retry()
                    w.train(
                        part,
                        self.batch_size,
                        num_epoch=self.num_epoch,
                        shuffle_seed=self.seed + w.worker_id,
                        device_resident=self.device_resident,
                    )
                    return True
                except Exception as e:  # noqa: BLE001 — crash boundary
                    failure = {
                        "worker_id": w.worker_id,
                        "attempt": attempt,
                        "error": repr(e),
                    }
                    if adopted_by is not None:
                        failure["adopted_by"] = adopted_by
                    self.failures.append(failure)
                    if self.metrics_logger is not None:
                        self.metrics_logger.log(event="worker_failure",
                                                **failure)
                    if attempt == self.worker_retries:
                        return False  # give up; others keep training

        def run(w, part):
            ok = False
            try:
                ok = attempt_partition(w, part)
                if not ok and self.elastic:
                    with done_lock:
                        orphans.append((w, part))
                    if self.metrics_logger is not None:
                        self.metrics_logger.log(event="partition_orphaned",
                                                worker_id=w.worker_id)
            finally:
                # done BEFORE any adoption: this worker never commits under
                # its own id again, so the monitor must not suspect it
                with done_lock:
                    done.add(w.worker_id)
            # only a worker that FINISHED its own partition adopts
            while ok and self.elastic and try_adopt(w.worker_id):
                pass

        def try_adopt(adopter_id):
            """Pop and re-run one orphaned partition with the dead worker
            OBJECT (same id, same commit seqs, so PS dedup keeps its landed
            windows exactly-once); False when there is none. A failed
            adoption abandons the partition."""
            with done_lock:
                if not orphans:
                    return False
                dead_w, dead_part = orphans.pop()
                done.discard(dead_w.worker_id)
            try:
                adopted_ok = attempt_partition(
                    dead_w, dead_part, adopted_by=adopter_id,
                    reset_first=True,
                )
            finally:
                with done_lock:
                    done.add(dead_w.worker_id)
            adoption = {
                "worker_id": dead_w.worker_id,
                "adopted_by": adopter_id,
                "ok": bool(adopted_ok),
            }
            self.adoptions.append(adoption)
            if self.metrics_logger is not None:
                self.metrics_logger.log(
                    event=("partition_adopted" if adopted_ok
                           else "partition_abandoned"),
                    **adoption)
            return True

        stop_monitor = threading.Event()
        monitor = None
        if self.heartbeat_timeout is not None:
            monitor = threading.Thread(
                target=self._monitor_heartbeats,
                args=(stop_monitor, done, done_lock),
                daemon=True,
            )
            monitor.start()
        threads = [
            threading.Thread(target=run, args=(w, p))
            for w, p in zip(workers, parts)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # straggler orphans: a survivor that finished before the owner gave
        # up saw an empty queue — drain what is left here
        if self.elastic:
            while try_adopt("main"):
                pass
        stop_monitor.set()
        if monitor is not None:
            monitor.join()

    def _monitor_heartbeats(self, stop: threading.Event, done, done_lock):
        """Flag workers whose last PS pull/commit is older than
        heartbeat_timeout; workers that already exited are not suspects."""
        timeout = float(self.heartbeat_timeout)
        while not stop.wait(timeout / 2):
            suspects = self.parameter_server.suspected_failures(timeout)
            with done_lock:
                suspects = [wid for wid in suspects if wid not in done]
            for wid in suspects:
                suspicion = {"worker_id": wid, "timeout": timeout}
                if suspicion not in self.suspicions:
                    self.suspicions.append(suspicion)
                    if self.metrics_logger is not None:
                        self.metrics_logger.log(event="worker_suspected",
                                                **suspicion)

    def _run_simulated(self, workers, parts):
        """Deterministic async: repeatedly pick a worker with a seeded numpy
        generator; begin its next window if idle, else finish the one in
        flight. Staleness varies 0..num_workers-1 as thread interleavings
        produce, but the seed makes every run bit-identical, and the
        schedule (the JAX package's, same generator) depends only on the
        queue lengths, so streamed and resident feeds replay the same
        interleaving."""
        queues = []
        for w, part in zip(workers, parts):
            if self.device_resident:
                w.stage_resident(part)
                windows = list(w.iter_index_windows(
                    self.num_epoch, self.batch_size, self.seed + w.worker_id))
            else:
                windows = list(w.iter_window_batches(
                    part, self.batch_size, self.num_epoch,
                    self.seed + w.worker_id))
            # a resumed worker skips the windows whose commits the
            # restored center already holds (the same seeded shuffles, so
            # the same stream)
            queues.append(windows[w._start_seq:])
        rng = np.random.default_rng(self.seed)
        inflight = [False] * len(workers)
        while any(queues) or any(inflight):
            candidates = [i for i in range(len(workers))
                          if inflight[i] or queues[i]]
            i = int(rng.choice(candidates))
            if inflight[i]:
                workers[i].finish_window()
                inflight[i] = False
            elif self.device_resident:
                workers[i].begin_window_indexed(queues[i].pop(0))
                inflight[i] = True
            else:
                workers[i].begin_window(queues[i].pop(0))
                inflight[i] = True


class AsynchronousDistributedTrainer(DistributedTrainer):
    """Marker base for the async trainers (reference:
    distkeras/trainers.py -> AsynchronousDistributedTrainer); the
    ``communication_window`` commit cadence lives on DistributedTrainer."""


def _reject_schedule_lr(args, kwargs, trainer_name):
    """Algorithms whose update rules consume the lr as a SCALAR (AEASGD's
    elastic force rho*lr, EAMSGD likewise, ADAG's -lr/W commit) cannot run
    a schedule: fail loudly instead of freezing it at step 0. ``args``
    covers the positional spelling (learning_rate is Trainer.__init__'s
    5th parameter)."""
    lr = kwargs.get("learning_rate")
    if lr is None and len(args) >= 5:
        lr = args[4]
    if callable(lr):
        raise TypeError(
            f"{trainer_name} consumes the learning rate as a scalar in its "
            "update rule and does not accept schedules; pass a float (or "
            "use SingleTrainer / the sync trainer / DOWNPOUR / DynSGD, "
            "which run schedules inside the local optimizer)"
        )


class DOWNPOUR(AsynchronousDistributedTrainer):
    """Downpour-SGD (Dean et al.): workers restart from the pulled center
    every window and commit weight deltas; the PS adds them (reference:
    distkeras/trainers.py -> DOWNPOUR)."""

    worker_cls = DOWNPOURWorker
    ps_cls = DeltaParameterServer


class AEASGD(AsynchronousDistributedTrainer):
    """Async Elastic Averaging SGD (reference: distkeras/trainers.py ->
    AEASGD): persistent local replicas, elastic force toward/from the
    center."""

    worker_cls = AEASGDWorker
    ps_cls = DeltaParameterServer

    def __init__(self, *args, rho=5.0, **kwargs):
        _reject_schedule_lr(args, kwargs, type(self).__name__)
        super().__init__(*args, **kwargs)
        self.rho = float(rho)

    def worker_kwargs(self):
        return {"rho": self.rho, "learning_rate": self.learning_rate}


class EAMSGD(AEASGD):
    """Elastic averaging with Nesterov momentum on the local optimizer
    (reference: distkeras/trainers.py -> EAMSGD): the plain ``"sgd"`` with
    Nesterov momentum replaces the worker optimizer, as in the JAX
    package."""

    worker_cls = EAMSGDWorker

    def __init__(self, *args, momentum=0.9, **kwargs):
        super().__init__(*args, **kwargs)
        self.momentum = float(momentum)
        self.optimizer = get_optimizer(
            "sgd", self.learning_rate, momentum=self.momentum, nesterov=True
        )


class ADAG(AsynchronousDistributedTrainer):
    """Accumulated Gradient Normalization (Hermans; reference:
    distkeras/trainers.py -> ADAG): commit -lr * mean-of-window gradients."""

    worker_cls = ADAGWorker
    ps_cls = ADAGParameterServer

    def __init__(self, *args, **kwargs):
        _reject_schedule_lr(args, kwargs, type(self).__name__)
        super().__init__(*args, **kwargs)

    def worker_kwargs(self):
        return {"learning_rate": self.learning_rate}


class DynSGD(AsynchronousDistributedTrainer):
    """Staleness-aware async SGD (reference: distkeras/trainers.py ->
    DynSGD): the versioned PS scales commits by 1/(staleness+1)."""

    worker_cls = DynSGDWorker
    ps_cls = DynSGDParameterServer
