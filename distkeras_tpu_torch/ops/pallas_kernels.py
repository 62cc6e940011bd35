"""Fused optimizer updates (PyTorch port of
``distkeras_tpu.ops.pallas_kernels``; the module keeps its name so each
counterpart is easy to find, though nothing here is Pallas).

``FusedAdam`` ("pallas_adam") exposes the ``init``/``fused_apply``
protocol ``WorkerCore`` prefers over the two-step ``update`` +
``apply_updates``. On CUDA parameters one launch of the hand-written Hopper
kernel ``kernels/csrc/adam_fused.cu`` updates every leaf in place (the
port updates in place where the JAX package returned new arrays: the old
ones are dead after the step, so this saves a copy of every buffer); on CPU
parameters ``_adam_math``, the plain version, runs leaf by leaf. The step
count lives on the device and the bias corrections are computed there from
it, in f32 as the JAX package computes them, so a step never waits on the
host.

``FusedSGD`` ("pallas_sgd") is kernels B1/B2, which are not ported yet: it
raises rather than run plain math under the kernel's name.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch import kernels

#: elements per chunk of the multi-tensor table (a multiple of 4: float4)
ADAM_CHUNK = 4096
#: most blocks the Adam kernel launches; they walk the chunks grid-stride
ADAM_MAX_BLOCKS = 1024


def _adam_math(p32, g32, m32, v32, lr, b1, b2, eps, c1, c2):
    """The one copy of the Adam update (c1/c2 are the bias-correction
    factors 1/(1-b^t)); the kernel repeats it operation for operation."""
    m_new = b1 * m32 + (1.0 - b1) * g32
    v_new = b2 * v32 + (1.0 - b2) * g32 * g32
    p_new = p32 - lr * (m_new * c1) / (torch.sqrt(v_new * c2) + eps)
    return p_new, m_new, v_new


def _bias_corrections(count, b1, b2):
    """(c1, c2) as f32 device scalars from the int32 count, the way
    ``FusedAdam.fused_apply`` computes them in JAX: t = f32(count + 1)."""
    t = (count + 1).to(torch.float32)
    return 1.0 / (1.0 - b1 ** t), 1.0 / (1.0 - b2 ** t)


def adam_step_plain(params, grads, ms, vs, step, lr, b1, b2, eps):
    """Plain version of the kernel: the same update in place, leaf by leaf,
    and the count advanced on the device."""
    c1, c2 = _bias_corrections(step[0], b1, b2)
    for p, g, m, v in zip(params, grads, ms, vs):
        p_new, m_new, v_new = _adam_math(
            p.float(), g.float(), m, v, lr, b1, b2, eps, c1, c2
        )
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
    step[0] += 1


class _AdamTable:
    """The device tables the kernel walks: leaves (L, 4) int64 [p, m, v, n]
    and chunks (C, 2) int64 [leaf, start], built once per set of
    parameter and moment buffers (``builds`` counts them), and the
    gradients' pointers (L,) int64, uploaded without a host sync when
    autograd hands out gradient buffers at new addresses
    (``grad_uploads`` counts them)."""

    def __init__(self):
        self.key = self.grad_key = None
        self.builds = self.grad_uploads = 0

    def get(self, params, grads, ms, vs):
        key = tuple(t.data_ptr() for group in (params, ms, vs) for t in group)
        dev = params[0].device
        if key != self.key:
            sizes = [p.numel() for p in params]
            self.leaves = torch.tensor(
                [[p.data_ptr(), m.data_ptr(), v.data_ptr(), n]
                 for p, m, v, n in zip(params, ms, vs, sizes)],
                dtype=torch.int64).to(dev)
            starts = [np.arange(0, n, ADAM_CHUNK) for n in sizes]
            chunks = np.stack([
                np.repeat(np.arange(len(sizes)), [len(s) for s in starts]),
                np.concatenate(starts),
            ], axis=1)
            self.chunks = torch.from_numpy(chunks.astype(np.int64)).to(dev)
            self.n_chunks = len(chunks)
            self.key, self.grad_key = key, None
            self.builds += 1
        grad_key = tuple(g.data_ptr() for g in grads)
        if grad_key != self.grad_key:
            self.grads = torch.tensor(grad_key, dtype=torch.int64) \
                .pin_memory().to(dev, non_blocking=True)
            self.grad_key = grad_key
            self.grad_uploads += 1
        return self.leaves, self.grads, self.chunks, self.n_chunks


def adam_fused(params, grads, ms, vs, step, lr, b1, b2, eps, table):
    """Launch the multi-tensor CUDA kernel: every leaf updated in place in
    one launch, ``step`` [count, 0] (int32, on the device) advanced by
    the kernel itself. Raises on anything the kernel does not take."""
    if not params:
        raise ValueError("adam_fused needs at least one parameter")
    dev = params[0].device
    if not (dev.type == "cuda" and step.device == dev):
        raise ValueError("adam_fused launches on CUDA tensors only")
    if step.dtype != torch.int32 or tuple(step.shape) != (2,):
        raise ValueError("adam_fused wants step as int32 [count, 0]")
    dtype = params[0].dtype
    for p, g, m, v in zip(params, grads, ms, vs, strict=True):
        if (p.dtype != dtype or g.dtype != dtype or m.dtype != torch.float32
                or v.dtype != torch.float32):
            raise ValueError(
                "adam_fused wants p and g of one dtype for every leaf and "
                f"f32 moments; got p {p.dtype}, g {g.dtype}, m {m.dtype}, "
                f"v {v.dtype}"
            )
        if not all(t.device == dev and t.is_contiguous() and t.numel() ==
                   p.numel() for t in (g, m, v)) or not p.is_contiguous():
            raise ValueError(
                "adam_fused wants contiguous p, g, m, v of one size on one "
                "device"
            )
    code = kernels.cuda_dtype_code(dtype)
    leaves, gptrs, chunks, n_chunks = table.get(params, grads, ms, vs)
    from distkeras_tpu_torch.kernels.build import kernel

    fn = kernel("adam_fused")
    with torch.cuda.device(dev):
        err = fn(
            leaves.data_ptr(), gptrs.data_ptr(), chunks.data_ptr(),
            n_chunks, ADAM_CHUNK,
            min(n_chunks, ADAM_MAX_BLOCKS), float(lr), float(b1),
            float(1.0 - b1), float(b2), float(1.0 - b2), float(eps),
            step.data_ptr(), code, torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check_launch("adam_fused", err)


class FusedSGD:
    """Kernels B1/B2 (``pallas_sgd``): not ported yet (the sync-DP and
    parameter-server slice). Refuses construction rather than run plain
    math under the kernel's name."""

    def __init__(self, learning_rate=0.01, momentum=0.0, nesterov=False):
        raise NotImplementedError(
            "pallas_sgd is kernels B1/B2 (ops/pallas_kernels.py "
            "_sgd_kernel/_sgd_momentum_kernel), not ported yet; use "
            "optimizer 'sgd'"
        )


class FusedAdam:
    """Fused-apply Adam: moments, bias correction, and the parameter write
    in one pass; numerically matches ``optax.adam`` (the JAX package's
    ``FusedAdam``).

    State is ``(m_list, v_list, step)``: f32 moments shaped like the
    parameters, and ``step`` an int32 device tensor ``[count, 0]`` — the
    optax step counter (first apply uses t = 1) and the kernel's scratch
    counter of arrived blocks, which is 0 between launches.
    """

    def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8):
        if callable(learning_rate):
            raise TypeError(
                "pallas_adam bakes the learning rate into the kernel and "
                "does not accept schedules; use optimizer 'adam' with a "
                "schedule instead"
            )
        self.learning_rate = float(learning_rate)
        self.b1 = float(b1)
        self.b2 = float(b2)
        self.eps = float(eps)
        self._table = _AdamTable()

    def init(self, params):
        params = list(params)
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in params]
        return (
            zeros,
            [z.clone() for z in zeros],
            torch.zeros(2, dtype=torch.int32, device=params[0].device),
        )

    def fused_apply(self, params, grads, state):
        """Update ``params`` in place from ``grads``; returns (params,
        state), the state's tensors updated in place too."""
        ms, vs, step = state
        args = (self.learning_rate, self.b1, self.b2, self.eps)
        with torch.no_grad():
            if step.is_cuda:
                adam_fused(params, grads, ms, vs, step, *args, self._table)
            else:
                adam_step_plain(params, grads, ms, vs, step, *args)
        return params, state
