"""Trainer orchestration (PyTorch port of the parts of
``distkeras_tpu.trainers`` the training slices run: ``Trainer``,
``SingleTrainer`` and the asynchronous parameter-server trainers —
``DistributedTrainer`` and ``DOWNPOUR``, ``AEASGD``, ``EAMSGD``, ``ADAG``,
``DynSGD``).

Same constructor vocabulary (``worker_optimizer``, ``loss``, ``metrics``,
``learning_rate``, ``batch_size``, ``num_epoch``, ``seed``, ...) and the
same contract: ``trainer.train(dataset) -> trained model``, a new model;
the caller's keeps its weights. ``checkpoint_dir=``, ``profile_dir=`` and
``metrics_path=`` raise until ``utils/checkpoint.py`` and
``utils/profiling.py`` are ported; the async trainers' socket tier,
standby replication and compression raise until their modules are. The
synchronous data-parallel and other multi-card strategies come with a
machine of more than one card.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from distkeras_tpu_torch.ops.optimizers import (
    effective_learning_rate,
    get_optimizer,
)
from distkeras_tpu_torch.ops.quantization import count_quantized
from distkeras_tpu_torch.parameter_servers import (
    ADAGParameterServer,
    DeltaParameterServer,
    DynSGDParameterServer,
)
from distkeras_tpu_torch.utils.device import check_model_device, local_devices
from distkeras_tpu_torch.utils.history import TrainingHistory
from distkeras_tpu_torch.workers import (
    ADAGWorker,
    AEASGDWorker,
    DOWNPOURWorker,
    DynSGDWorker,
    EAMSGDWorker,
    SingleTrainerWorker,
    WorkerCore,
)


def _not_ported(option, module):
    raise NotImplementedError(
        f"{option}= is not ported yet (it needs {module})"
    )


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


class DistributedTrainer(Trainer):
    """Template for PS-based distributed training (reference:
    distkeras/trainers.py -> DistributedTrainer): partition the data, start
    the PS, launch the workers, collect, read the center back.

    ``mode``: "threads" (true async: one thread per worker, workers mapped
    round-robin onto ``local_devices(device)``, all on one card in this
    port) or "simulated" (a seeded deterministic interleaving of pulls and
    commits across workers — reproducible staleness, bit for bit the JAX
    package's schedule). ``device=None`` means CUDA (raises without a GPU;
    the model must live there). The PS is in-process; ``serve_socket``,
    ``remote_ps``, ``standby``, ``compress``, ``pull_compress`` and
    ``checkpoint_dir`` raise until their modules are ported.
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
        checkpoint_every=0,  # checkpoint_every, max_to_keep and
        max_to_keep=3,  # worker_snapshot_stride act only with
        worker_snapshot_stride=1,  # checkpoint_dir, which raises
        worker_retries=1,
        heartbeat_timeout=None,
        elastic=False,
        device_resident=False,
        compress=None,
        pull_compress=None,
        device=None,
        **kwargs,
    ):
        for option, value, module in (
            ("serve_socket", serve_socket,
             "networking.py and SocketParameterServer"),
            ("remote_ps", remote_ps,
             "networking.py, RemoteParameterServerClient and "
             "utils/serialization.py"),
            ("standby", standby,
             "SocketParameterServer replication and utils/serialization.py"),
            ("compress", compress, "utils/compression.py"),
            ("pull_compress", pull_compress, "utils/compression.py"),
            ("checkpoint_dir", checkpoint_dir, "utils/checkpoint.py"),
        ):
            if value:
                _not_ported(option, module)
        super().__init__(*args, **kwargs)
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
        self.parameter_server = None
        # the last run's workers: their records, timings and per-window
        # host splits (pull / window / commit seconds)
        self.workers = []
        self.failures = []
        self.suspicions = []
        self.adoptions = []  # [{worker_id, adopted_by, ok}]

    # -- template hooks -----------------------------------------------------

    def allocate_parameter_server(self):
        """The PS over the caller's weights, in the JAX leaf order."""
        return self.ps_cls(dict(zip(self.model._leaf_order(),
                                    self.model.get_weights())))

    def worker_kwargs(self) -> dict:
        return {}

    def allocate_worker(self, core, worker_id, device):
        return self.worker_cls(
            core,
            self.parameter_server,
            worker_id,
            self.features_col,
            self.label_col,
            self.communication_window,
            seed=self.seed,
            device=device,
            **self.worker_kwargs(),
        )

    # -- run ----------------------------------------------------------------

    def _train(self, dataset, shuffle=False):
        self.history.record_training_start()
        self.failures, self.suspicions, self.adoptions = [], [], []
        check_model_device(self.model, self.device)
        core = self._make_core()
        self.parameter_server = self.allocate_parameter_server()
        self.parameter_server.start()
        self.workers = workers = []
        try:
            parts = (dataset.shuffle(self.seed) if shuffle
                     else dataset).partition(self.num_workers)
            devices = local_devices(self.device)
            workers.extend(
                self.allocate_worker(core, i, devices[i % len(devices)])
                for i in range(self.num_workers)
            )
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
            self.parameter_server.stop()
        self.history.record_training_end()
        return self._finish_center(self.parameter_server.get_params(),
                                   self._aggregate_worker_states(workers))

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
                    if attempt == self.worker_retries:
                        return False  # give up; others keep training

        def run(w, part):
            ok = False
            try:
                ok = attempt_partition(w, part)
                if not ok and self.elastic:
                    with done_lock:
                        orphans.append((w, part))
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
            self.adoptions.append({
                "worker_id": dead_w.worker_id,
                "adopted_by": adopter_id,
                "ok": bool(adopted_ok),
            })
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
            queues.append(windows)
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
