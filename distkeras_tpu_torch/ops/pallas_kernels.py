"""Fused optimizer updates (PyTorch port of
``distkeras_tpu.ops.pallas_kernels``; the module keeps its name so each
counterpart is easy to find, though nothing here is Pallas).

``FusedSGD`` ("pallas_sgd") and ``FusedAdam`` ("pallas_adam") expose the
``init``/``fused_apply`` protocol ``WorkerCore`` prefers over the two-step
``update`` + ``apply_updates``. On CUDA parameters one launch of a
hand-written Hopper kernel updates every leaf in place —
``kernels/csrc/sgd_fused.cu`` (B1 without momentum, B2 with it) and
``kernels/csrc/adam_fused.cu`` (B3). The port updates in place where the
JAX package returned new arrays: the old ones are dead after the step, so
this saves a copy of every buffer. On CPU parameters the plain versions
(``sgd_step_plain``, ``sgd_momentum_step_plain``, ``adam_step_plain``) run
leaf by leaf with the same arithmetic. Adam's step count lives on the
device and the bias corrections are computed there from it, in f32 as the
JAX package computes them, so a step never waits on the host.

Each kernel walks device tables of the leaves and of their chunks. An
optimizer keeps one set of tables per parameter set (``_TableCache``), so
workers that share the optimizer but train replicas of their own — the
asynchronous trainers' threads — each build theirs once, never once per
call.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.ops.optimizers import StateIO
from distkeras_tpu_torch.utils.tree import copy_tree_

#: elements per chunk of B3's tables (a multiple of 4: float4)
CHUNK = 4096
#: most blocks B3 launches; they walk the chunks grid-stride (B1 and B2
#: size their persistent grids to the card themselves)
MAX_BLOCKS = 1024
#: bytes of p in one chunk of B1's and B2's tables: 256 threads x 4 packs
#: of 16 bytes. It is ``sgd_fused.cu``'s ``kChunkBytes`` and changes with
#: it: the launch passes the chunk only for the kernel to check it
SGD_CHUNK_BYTES = 16384
#: parameter sets whose tables one optimizer keeps; the least recently used
#: beyond this is dropped (a trainer has one set per worker)
MAX_TABLES = 16


def sgd_chunk(dtype) -> int:
    """Elements per chunk of B1's and B2's tables for parameters of
    ``dtype``: ``SGD_CHUNK_BYTES`` of it (4096 f32, 8192 bf16 or f16)."""
    return SGD_CHUNK_BYTES // torch.empty((), dtype=dtype).element_size()


class _LeafTable:
    """The device tables a multi-tensor kernel walks for one parameter set:
    leaves (L, k + 1) int64 — the pointers of the k stable buffers of each
    leaf (p, then its moments) and its length — and chunks (C, 2) int64
    [leaf, start] of at most ``chunk`` elements. The gradients' pointers
    (L,) int64 sit apart: autograd hands out gradient buffers at new
    addresses, and only those 8 bytes per leaf are uploaded again, without
    a host sync."""

    def __init__(self, buffers, chunk=CHUNK):
        params = buffers[0]
        dev = params[0].device
        sizes = [p.numel() for p in params]
        self.leaves = torch.tensor(
            [[*(t.data_ptr() for t in leaf), n]
             for *leaf, n in zip(*buffers, sizes)],
            dtype=torch.int64).to(dev)
        starts = [np.arange(0, n, chunk) for n in sizes]
        chunks = np.stack([
            np.repeat(np.arange(len(sizes)), [len(s) for s in starts]),
            np.concatenate(starts),
        ], axis=1)
        self.chunk = chunk
        self.chunks = torch.from_numpy(chunks.astype(np.int64)).to(dev)
        self.n_chunks = len(chunks)
        self.grid = min(self.n_chunks, MAX_BLOCKS)
        self.grad_key = self.grads = None

    def grad_pointers(self, grads):
        """The gradients' pointer table; True beside it when it had to be
        uploaded (pinned and asynchronous on CUDA)."""
        key = tuple(g.data_ptr() for g in grads)
        if key == self.grad_key:
            return self.grads, False
        host = torch.tensor(key, dtype=torch.int64)
        dev = self.leaves.device
        if dev.type == "cuda":
            host = host.pin_memory()
        self.grads = host.to(dev, non_blocking=True)
        self.grad_key = key
        return self.grads, True


class _TableCache:
    """One optimizer's ``_LeafTable``s, one per parameter set, keyed by the
    chunk size and the stable buffers' pointers and sizes under a lock.
    ``builds`` counts the tables built and ``grad_uploads`` the
    gradient-pointer uploads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tables = OrderedDict()
        self.builds = self.grad_uploads = 0

    def get(self, buffers, grads, chunk=CHUNK):
        """(table, gradient pointers) for ``buffers`` — a tuple of leaf
        lists, the parameters first, then each moment — and ``grads``,
        cut into chunks of ``chunk`` elements."""
        key = (chunk, *((t.data_ptr(), t.numel()) for group in buffers
                        for t in group))
        with self._lock:
            table = self._tables.get(key)
            if table is None:
                table = self._tables[key] = _LeafTable(buffers, chunk)
                self.builds += 1
                while len(self._tables) > MAX_TABLES:
                    self._tables.popitem(last=False)
            else:
                self._tables.move_to_end(key)
            gptrs, uploaded = table.grad_pointers(grads)
            self.grad_uploads += uploaded
        return table, gptrs

    def __len__(self):
        with self._lock:
            return len(self._tables)


def _check_leaves(name, params, grads, moments=()):
    """The device and dtype code of a multi-tensor launch; raises on what
    the kernel does not take: non-CUDA tensors, mixed devices or dtypes,
    moments other than f32, non-contiguous or mismatched buffers."""
    if not params:
        raise ValueError(f"{name} needs at least one parameter")
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors only")
    dtype = params[0].dtype
    for p, g, *ms in zip(params, grads, *moments, strict=True):
        if (p.dtype != dtype or g.dtype != dtype
                or any(m.dtype != torch.float32 for m in ms)):
            raise ValueError(
                f"{name} wants p and g of one dtype for every leaf and f32 "
                f"moments; got p {p.dtype}, g {g.dtype}, moments "
                f"{[m.dtype for m in ms]}"
            )
        if not all(t.device == dev and t.is_contiguous()
                   and t.numel() == p.numel() for t in (p, g, *ms)):
            raise ValueError(
                f"{name} wants contiguous p, g and moments of one size on "
                "one device"
            )
    return dev, kernels.cuda_dtype_code(dtype)


def _launch(name, dev, *args):
    from distkeras_tpu_torch.kernels.build import kernel

    fn = kernel(name)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(name, err)


# ------------------------------------------------------------- B1, B2: SGD


def sgd_step_plain(params, grads, lr):
    """Plain version of B1, in place: p' = p - lr*g in f32, cast back to
    p's dtype (``_leaf_sgd``'s math)."""
    for p, g in zip(params, grads, strict=True):
        p.copy_(p.float() - lr * g.float())


def sgd_momentum_step_plain(params, grads, ms, lr, mu, nesterov):
    """Plain version of B2, in place: m' = mu*m + g; u = g + mu*m'
    (Nesterov) or m'; p' = p - lr*u, all in f32, m kept in f32
    (``_leaf_sgd_momentum``'s math)."""
    for p, g, m in zip(params, grads, ms, strict=True):
        g32 = g.float()
        m_new = mu * m + g32
        u = g32 + mu * m_new if nesterov else m_new
        p.copy_(p.float() - lr * u)
        m.copy_(m_new)


def sgd_fused(params, grads, lr, tables):
    """Launch B1: every leaf updated in place in one launch, over chunks of
    ``sgd_chunk`` elements on the card's persistent grid. Raises on
    anything the kernel does not take."""
    dev, code = _check_leaves("sgd_fused", params, grads)
    table, gptrs = tables.get((params,), grads, sgd_chunk(params[0].dtype))
    _launch("sgd_fused", dev, table.leaves.data_ptr(), gptrs.data_ptr(),
            table.chunks.data_ptr(), table.n_chunks, table.chunk, float(lr),
            code)


def sgd_momentum_fused(params, grads, ms, lr, mu, nesterov, tables):
    """Launch B2: every leaf and its f32 momentum updated in place in one
    launch, chunked as B1. Raises on anything the kernel does not take."""
    dev, code = _check_leaves("sgd_momentum_fused", params, grads, (ms,))
    table, gptrs = tables.get((params, ms), grads,
                              sgd_chunk(params[0].dtype))
    _launch("sgd_momentum_fused", dev, table.leaves.data_ptr(),
            gptrs.data_ptr(), table.chunks.data_ptr(), table.n_chunks,
            table.chunk, float(lr), float(mu), int(bool(nesterov)), code)


class FusedSGD(StateIO):
    """Fused-apply SGD, kernels B1 (momentum 0) and B2 (momentum > 0, plain
    or Nesterov): the update and the parameter write in one pass.

    State is ``()`` without momentum, else a list of f32 momenta shaped
    like the parameters (the JAX ``FusedSGD``'s)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, nesterov=False):
        if callable(learning_rate):
            raise TypeError(
                "pallas_sgd bakes the learning rate into the kernel and "
                "does not accept schedules; use optimizer 'sgd' with a "
                "schedule instead"
            )
        self.learning_rate = float(learning_rate)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)
        self._tables = _TableCache()

    def init(self, params):
        if self.momentum == 0.0:
            return ()
        return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in params]

    def fused_apply(self, params, grads, state):
        """Update ``params`` (and the momenta) in place from ``grads``;
        returns (params, state)."""
        lr, mu = self.learning_rate, self.momentum
        with torch.no_grad():
            on_card = params[0].is_cuda
            if mu == 0.0:
                if on_card:
                    sgd_fused(params, grads, lr, self._tables)
                else:
                    sgd_step_plain(params, grads, lr)
            elif on_card:
                sgd_momentum_fused(params, grads, state, lr, mu,
                                   self.nesterov, self._tables)
            else:
                sgd_momentum_step_plain(params, grads, state, lr, mu,
                                        self.nesterov)
        return params, state


# -------------------------------------------------------------- B3: Adam


def _adam_math(p32, g32, m32, v32, lr, b1, b2, eps, c1, c2):
    """The one copy of the Adam update (c1/c2 are the bias-correction
    factors 1/(1-b^t)); the kernel repeats it operation for operation.

    The square root is taken in f64 and rounded back to f32: ATen's
    vectorised f32 ``sqrt`` is not correctly rounded on every host (on
    AVX512 about 15% of values land 1 ulp off), while JAX's update and the
    kernel's ``__fsqrt_rn`` are. f64 carries more than 2 x 24 + 2 bits, so
    rounding its root to f32 gives the correctly rounded f32 root."""
    m_new = b1 * m32 + (1.0 - b1) * g32
    v_new = b2 * v32 + (1.0 - b2) * g32 * g32
    root = torch.sqrt((v_new * c2).double()).float()
    p_new = p32 - lr * (m_new * c1) / (root + eps)
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


def adam_fused(params, grads, ms, vs, step, lr, b1, b2, eps, tables):
    """Launch the multi-tensor CUDA kernel: every leaf updated in place in
    one launch, ``step`` [count, 0] (int32, on the device) advanced by
    the kernel itself. Raises on anything the kernel does not take."""
    dev, code = _check_leaves("adam_fused", params, grads, (ms, vs))
    if step.device != dev:
        raise ValueError("adam_fused launches on CUDA tensors only")
    if step.dtype != torch.int32 or tuple(step.shape) != (2,):
        raise ValueError("adam_fused wants step as int32 [count, 0]")
    table, gptrs = tables.get((params, ms, vs), grads)
    _launch("adam_fused", dev, table.leaves.data_ptr(), gptrs.data_ptr(),
            table.chunks.data_ptr(), table.n_chunks, CHUNK, table.grid,
            float(lr), float(b1), float(1.0 - b1), float(b2),
            float(1.0 - b2), float(eps), step.data_ptr(), code)


class FusedAdam(StateIO):
    """Fused-apply Adam: moments, bias correction, and the parameter write
    in one pass; numerically matches ``optax.adam`` (the JAX package's
    ``FusedAdam``).

    State is ``(m_list, v_list, step)``: f32 moments shaped like the
    parameters, and ``step`` an int32 device tensor ``[count, 0]`` — the
    optax step counter (first apply uses t = 1) and the kernel's scratch
    counter of arrived blocks, which is 0 between launches. A checkpoint
    holds the JAX ``FusedAdam``'s ``(m, v, count)``: the scalar count,
    without the scratch counter.
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
        self._tables = _TableCache()

    def init(self, params):
        params = list(params)
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in params]
        return (
            zeros,
            [z.clone() for z in zeros],
            torch.zeros(2, dtype=torch.int32, device=params[0].device),
        )

    def export_state(self, state):
        ms, vs, step = state
        return ms, vs, step[0]

    def load_state(self, state, saved):
        """Copy a saved ``(m, v, count)`` into the live buffers (the ones
        the kernel's tables point at), the scratch counter set to 0."""
        ms, vs, step = state
        m_saved, v_saved, count = saved
        copy_tree_((ms, vs), (m_saved, v_saved))
        with torch.no_grad():
            step.copy_(torch.tensor([int(count), 0], dtype=torch.int32))
        return state

    def fused_apply(self, params, grads, state):
        """Update ``params`` in place from ``grads``; returns (params,
        state), the state's tensors updated in place too."""
        ms, vs, step = state
        args = (self.learning_rate, self.b1, self.b2, self.eps)
        with torch.no_grad():
            if step.is_cuda:
                adam_fused(params, grads, ms, vs, step, *args, self._tables)
            else:
                adam_step_plain(params, grads, ms, vs, step, *args)
        return params, state
