"""Multi-process runtime bootstrap (PyTorch port of
``distkeras_tpu.parallel.multihost``).

One process per rank, the ``torchrun`` model: every process runs the same
program and joins one ``torch.distributed`` process group, whose
collectives carry the synchronous trainer's gradient all-reduce — NCCL
between CUDA ranks, gloo between CPU ranks.

``initialize()`` reads the coordinator env vars (as emitted by
``job_deployment.Job``) or explicit kwargs and calls
``torch.distributed.init_process_group``. Safe to call single-process
(no-op, returns False). ``shutdown()`` leaves the group: call it before
the process exits (a gloo group still alive at interpreter exit can
abort the process).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from distkeras_tpu_torch.utils.device import resolve_device

ENV_COORDINATOR = "DKT_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "DKT_NUM_PROCESSES"
ENV_PROCESS_ID = "DKT_PROCESS_ID"
ENV_BACKEND = "DKT_BACKEND"


def _backend(backend, device, process_id):
    """explicit ``backend`` > ``DKT_BACKEND`` > the rank's device: NCCL for
    CUDA (the process takes card ``process_id % device_count``), gloo for
    the CPU."""
    backend = backend or os.environ.get(ENV_BACKEND)
    if backend:
        return backend
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "gloo"
    if dev.index is None:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    return "nccl"


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None, device=None, timeout=None):
    """Join the multi-process job (no-op when single-process).

    Resolution order: explicit kwargs > ``DKT_*`` env vars >
    single-process. ``device=None`` means CUDA (raises without a GPU, as
    every entry point of the port does); pass ``device="cpu"`` or
    ``backend="gloo"`` for CPU ranks. ``timeout``: seconds the group waits
    for a peer. Returns True if ``init_process_group`` was called."""
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    if process_id is None:
        process_id = int(os.environ.get(ENV_PROCESS_ID, "0"))
    if coordinator_address is None or int(num_processes) <= 1:
        return False
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(
        _backend(backend, device, int(process_id)),
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
        **kw,
    )
    return True


def process_id() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def num_processes() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on rank 0: it writes the checkpoints, and in the asynchronous
    tier it hosts the parameter server."""
    return process_id() == 0


def shutdown() -> None:
    """Wait for every rank, then leave the group (no-op without one)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
