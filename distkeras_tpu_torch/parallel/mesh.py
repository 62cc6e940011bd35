"""The data-parallel group and its placement helpers (PyTorch port of
``distkeras_tpu.parallel.mesh``).

The JAX package's synchronous trainer replicates the params over a 1-D
``Mesh(("data",))``, shards each batch along "data" and lets XLA insert
the gradient ``psum``. The port runs one process per rank (the
``torchrun`` model) and makes every collective explicit: a ``DataMesh``
is the rank's view of the group — its size, its rank, the
``torch.distributed`` group and the rank's device — and the helpers here
place the model, cut each rank's rows out of a global batch, all-reduce
the gradients in one flat bucket and shard the optimizer state (ZeRO-1).

Collectives go through the ``DataMesh`` methods. Gloo takes CUDA tensors
itself (it stages them through the host), so two ranks can share one
card over gloo, where NCCL refuses two ranks on one device.

Left out: ``force_cpu_mesh`` (a JAX virtual-device knob: the port's CPU
ranks are processes) and ``serving_mesh`` (tensor-parallel serving).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from distkeras_tpu_torch.models.sequential import walk_layers
from distkeras_tpu_torch.utils.device import resolve_device
from distkeras_tpu_torch.utils.tree import to_host


def local_devices(n=None, device=None):
    """The devices of this host a rank can take: every CUDA card, or the
    CPU. ``device=None`` means CUDA (raises without a GPU)."""
    dev = resolve_device(device)
    devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [torch.device("cpu")])
    if n is None:
        return devs
    if n > len(devs) and dev.type == "cuda":
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return devs[:n]


@dataclass(eq=False)
class DataMesh:
    """One rank's view of the data-parallel group: ``num_workers`` ranks,
    this one ``rank``, the process ``group`` (None when the job is one
    process and no group was initialized: every collective is then the
    identity) and the rank's ``device``."""

    num_workers: int
    rank: int
    group: object
    device: torch.device
    _buffers: dict = field(default_factory=dict, repr=False)

    def buffer(self, key, numel, dtype):
        """A flat buffer kept for reuse under ``key`` (the gradient bucket
        and the ZeRO gather land at the same addresses every step, so the
        fused optimizers' pointer tables stay valid); zeros when new."""
        buf = self._buffers.get(key)
        if buf is None or buf.numel() != numel or buf.dtype != dtype:
            buf = torch.zeros(numel, dtype=dtype, device=self.device)
            self._buffers[key] = buf
        return buf

    def release(self):
        """Drop the reusable buffers (a trainer calls it after its run)."""
        self._buffers.clear()

    def all_reduce_(self, t):
        """Sum ``t`` over the group in place."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather_(self, out, t):
        """``out`` (flat, ``num_workers * t.numel()``) <- every rank's
        ``t`` in rank order."""
        if self.group is None:
            out.copy_(t.reshape(-1))
            return out
        dist.all_gather(list(out.view(self.num_workers, -1).unbind(0)),
                        t.reshape(-1), group=self.group)
        return out

    def broadcast_(self, t, src=0):
        if self.group is not None:
            dist.broadcast(t, src, group=self.group)
        return t

    def barrier(self):
        if self.group is not None:
            dist.barrier(group=self.group)


def make_mesh(num_workers=None, device=None) -> DataMesh:
    """The data group over every process of the job
    (``torch.distributed``'s default group). ``num_workers=None`` means the
    job's world size; 1 without an initialized group is a group of one
    whose collectives are the identity. A CUDA rank takes card
    ``rank % device_count`` unless ``device`` names one (``device=None``:
    CUDA)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    n = world if num_workers is None else int(num_workers)
    if group is None and n > 1:
        raise ValueError(
            f"num_workers={n} needs a process group: start one process per "
            "rank and call distkeras_tpu_torch.parallel.multihost."
            "initialize() in each (job_deployment.Job does both)"
        )
    if n != world:
        raise ValueError(
            f"num_workers={n} but the job has {world} processes; the port "
            "runs one process per rank"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return DataMesh(n, rank, group, dev)


def replicate(model, mesh: DataMesh):
    """Broadcast the model's parameters and buffers from rank 0 in place,
    so every rank starts from rank 0's weights; returns the model."""
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            mesh.broadcast_(t.data)
    return model


def rank_rows(arr, mesh: DataMesh, axis=0):
    """Rank r's rows ``[r*B, (r+1)*B)`` of a global batch along ``axis``
    (the rows GSPMD gives device r under ``P("data")``)."""
    n = arr.shape[axis]
    if n % mesh.num_workers:
        raise ValueError(
            f"global batch of {n} rows does not split over "
            f"{mesh.num_workers} ranks"
        )
    b = n // mesh.num_workers
    index = [slice(None)] * arr.ndim
    index[axis] = slice(mesh.rank * b, (mesh.rank + 1) * b)
    return arr[tuple(index)]


def shard_batch(batch: dict, mesh: DataMesh, axis=0):
    """A host batch dict -> this rank's rows of each column on its device
    (through pinned memory on CUDA)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(rank_rows(v, mesh, axis)))
        if mesh.device.type == "cuda":
            t = t.pin_memory().to(mesh.device, non_blocking=True)
        out[k] = t
    return out


def all_reduce_mean(tensors, mesh: DataMesh):
    """The mean over the group of each tensor in ``tensors``: one flat
    bucket per dtype, summed and divided by N (gloo has no
    ``ReduceOp.AVG``). Returns views of the bucket, which the next call
    overwrites; a group of one returns ``tensors`` as they are."""
    tensors = list(tensors)
    if mesh.group is None:
        return tensors
    out = [None] * len(tensors)
    for dtype, idx in _by_dtype(tensors).items():
        offsets, numel = _offsets(tensors[i].numel() for i in idx)
        flat = mesh.buffer(("all_reduce", dtype), numel, dtype)
        pad = mesh.buffer(("zeros", dtype), _ALIGN, dtype)
        pieces = []
        for i in idx:
            n = tensors[i].numel()
            pieces.append(tensors[i].reshape(-1))
            if _aligned(n) > n:
                pieces.append(pad[:_aligned(n) - n])
        torch.cat(pieces, out=flat)
        mesh.all_reduce_(flat)
        flat.div_(mesh.num_workers)
        for i, o in zip(idx, offsets):
            out[i] = flat[o:o + tensors[i].numel()].view(tensors[i].shape)
    return out


#: bucket entries start on 16-byte boundaries (f32), where the fused
#: optimizer kernels take their float4 path
_ALIGN = 4


def _aligned(n):
    return -(-n // _ALIGN) * _ALIGN


def _offsets(sizes):
    """Aligned start offsets of consecutive entries, and the total."""
    offsets, off = [], 0
    for n in sizes:
        offsets.append(off)
        off += _aligned(n)
    return offsets, off


def _by_dtype(tensors):
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def zero_leaf_sharding(mesh: DataMesh, leaf):
    """ZeRO-1 placement rule for one optimizer-state leaf (JAX's rule): the
    FIRST dimension divisible by the group size and at least as large;
    None (replicated) when no dimension qualifies. ``leaf``: anything with
    a ``shape``, or a shape."""
    n = mesh.num_workers
    shape = tuple(getattr(leaf, "shape", leaf))
    for i, d in enumerate(shape):
        if d % n == 0 and d >= n:
            return i
    return None


def _rank_slice(t, dim, mesh):
    k = t.shape[dim] // mesh.num_workers
    return t[(slice(None),) * dim + (slice(mesh.rank * k, (mesh.rank + 1) * k),)]


def shard_opt_state_zero(opt_state, mesh: DataMesh):
    """This rank's slice of every leaf of a full optimizer-state tree
    (``zero_leaf_sharding`` per leaf; tensors or host arrays, sliced as
    views)."""
    def cut(x):
        if not hasattr(x, "shape"):
            return x
        dim = zero_leaf_sharding(mesh, x)
        return x if dim is None else _rank_slice(x, dim, mesh)

    return _tree_map(cut, opt_state)


def host_gather(tree, mesh: DataMesh | None = None, like=None):
    """The tree as host numpy arrays, leaves sharded over the group
    gathered whole first: a leaf whose shape differs from its counterpart
    in ``like`` (the full-shaped tree, e.g. on the meta device) is
    all-gathered along ``zero_leaf_sharding`` of the full shape. Every rank
    must call it (it runs collectives)."""
    if like is None:
        return to_host(tree)

    def fix(x, ref):
        if not isinstance(x, torch.Tensor) or tuple(x.shape) == tuple(ref.shape):
            return x
        dim = zero_leaf_sharding(mesh, ref)
        part = x.contiguous()
        out = torch.empty(mesh.num_workers * part.numel(), dtype=part.dtype,
                          device=part.device)
        mesh.all_gather_(out, part)
        pieces = out.view(mesh.num_workers, *part.shape).unbind(0)
        return torch.cat(pieces, dim=dim)

    return to_host(_tree_map(fix, tree, like))


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        vals = [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(tree, *rest)


class ZeroShards:
    """ZeRO-1 for one parameter list on one rank: each leaf that
    ``zero_leaf_sharding`` shards is represented by this rank's slice, a
    view into one flat buffer per dtype that persists from step to step
    (the master copy of the slice), and the others by the leaf itself.
    The optimizer runs on ``local`` (its moments are slice-shaped), with
    the slices of the all-reduced gradient (``grads``); ``gather`` then
    all-gathers the buffers and writes every rank's slice back into the
    full parameters. A slice along a dimension other than the first is not
    contiguous: its gradient is staged through a persistent contiguous
    buffer, since the multi-tensor kernels take contiguous leaves."""

    def __init__(self, params, mesh: DataMesh):
        self.mesh = mesh
        self.params = list(params)
        self.dims = [zero_leaf_sharding(mesh, p) for p in self.params]
        self.local = list(self.params)
        self._gstage = {}
        self._groups = []
        live = [i for i, d in enumerate(self.dims) if d is not None]
        for dtype, idx in _by_dtype([self.params[i] for i in live]).items():
            sizes = [self.params[live[j]].numel() // mesh.num_workers
                     for j in idx]
            offsets, total = _offsets(sizes)
            items = [(live[j], o, n) for j, o, n in zip(idx, offsets, sizes)]
            send = mesh.buffer(("zero_send", dtype), total, dtype)
            gathered = mesh.buffer(("zero_gather", dtype),
                                   total * mesh.num_workers, dtype)
            for i, o, n in items:
                part = _rank_slice(self.params[i].detach(), self.dims[i], mesh)
                view = send[o:o + n].view(part.shape)
                view.copy_(part)
                self.local[i] = view
            self._groups.append((send, gathered, items))

    def grads(self, grads):
        """The optimizer's gradients: each sharded leaf's slice of the
        full gradient, contiguous."""
        out = list(grads)
        for i, d in enumerate(self.dims):
            if d is None:
                continue
            g = _rank_slice(grads[i], d, self.mesh)
            if not g.is_contiguous():
                buf = self._gstage.get(i)
                if buf is None:
                    buf = self._gstage[i] = torch.empty(
                        g.shape, dtype=g.dtype, device=g.device)
                buf.copy_(g)
                g = buf
            out[i] = g
        return out

    def gather(self):
        """Rebuild every sharded parameter from all ranks' slices: one
        all-gather per dtype, one strided copy per leaf."""
        n = self.mesh.num_workers
        with torch.no_grad():
            for send, gathered, items in self._groups:
                self.mesh.all_gather_(gathered, send)
                rows = gathered.view(n, -1)
                for i, o, numel in items:
                    p, d = self.params[i], self.dims[i]
                    pre = math.prod(p.shape[:d])
                    k_post = numel // pre
                    src = rows[:, o:o + numel].view(n, pre, k_post)
                    p.detach().view(pre, n, k_post).copy_(src.transpose(0, 1))


# ------------------------------------------------------ layers under a group


def attach_data_group(model, mesh: DataMesh):
    """Give the layers whose result depends on the whole batch the group
    for a run: ``BatchNorm`` takes its statistics over the global batch,
    ``Dropout`` and the residual dropout of ``TransformerBlock`` draw the
    global batch's mask and keep the rank's rows. A group of one attaches
    nothing. Returns the number of layers attached; ``detach_data_group``
    undoes it."""
    if mesh.num_workers <= 1:
        return 0
    n = 0
    for layer in walk_layers(model):
        if type(layer).__name__ == "MoE":
            raise NotImplementedError(
                "a mixture-of-experts model under data parallelism routes "
                "each rank's tokens with the capacity of its own rows, "
                "where the JAX package routes the global batch; the expert "
                "mesh comes with ROADMAP A13"
            )
        if hasattr(layer, "data_group"):
            layer.data_group = mesh
            n += 1
    return n


def detach_data_group(model):
    for layer in walk_layers(model):
        if getattr(layer, "data_group", None) is not None:
            layer.data_group = None
