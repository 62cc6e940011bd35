"""The examples' backend bootstrap (PyTorch port of
``distkeras_tpu.parallel.backend``).

The JAX package probes its accelerator out of process and, when the probe
fails or hangs, degrades to a virtual CPU mesh, so that an example always
runs somewhere. The port does not degrade: it runs on the card unless the
caller asks for the CPU, and without a card it raises (the device
contract of ``utils.device.resolve_device``). A run that silently moved
to the CPU would report CPU numbers as if they were the card's. There is
no out-of-process probe either: ``torch.cuda.is_available()`` does not
hang. The port's CPU ranks are processes (``job_deployment.Job``), so
there is no virtual mesh to widen.
"""

from __future__ import annotations

from distkeras_tpu_torch.utils.device import resolve_device


def setup_backend(cpu: bool = False, cpu_devices: int = 1,
                  fallback_cpu_devices: int | None = None) -> str:
    """Pick the device an example runs on: the CPU when ``cpu`` is true,
    else CUDA, raising ``RuntimeError`` without a card. Returns ``"cpu"``
    or ``"gpu"`` (JAX's platform names). ``cpu_devices`` and
    ``fallback_cpu_devices`` are JAX's keywords, taken so that a caller's
    arguments carry over; they size JAX's virtual CPU mesh and act on
    nothing here."""
    del cpu_devices, fallback_cpu_devices
    dev = resolve_device("cpu" if cpu else None)
    return "gpu" if dev.type == "cuda" else "cpu"

