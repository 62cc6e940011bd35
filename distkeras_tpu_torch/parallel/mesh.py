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
itself for the all-reduce, the broadcast, the all-gather and the
all-to-all (it stages them through the host), so two ranks can share one
card over gloo, where NCCL refuses two ranks on one device; the ring's
send/recv, which gloo refuses CUDA tensors for, goes through pinned host
buffers (``HOST_STAGED``).

The 2-D grids of tensor, sequence, expert and pipeline parallelism are a
``GridMesh``: a data group beside a model, sequence, expert or pipe
group, rank ``d * K + i`` at data index d and inner index i (the order
``np.array(devs).reshape(D, K)`` gives devices in the JAX package). Layers and the attention exchanges
call the autograd-aware collectives on a group (``DataMesh.copy_in``,
``gather``, ``sum``, ``ring_step``, ``all_to_all``), whose backward is
the transpose the loss needs.

The serving mesh is another thing: ``serving_mesh`` names the N devices
ONE process drives for tensor-parallel decode (``ServingEngine(mesh=
"tp:N")``), a ``ServingMesh``; no process group is involved.

Left out: ``force_cpu_mesh`` (a JAX virtual-device knob: the port's CPU
ranks are processes, and a serving mesh repeats one device instead).
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

    axis_names = ("data",)

    @property
    def shape(self):
        return {"data": self.num_workers}

    @property
    def backend(self):
        """The group's ``torch.distributed`` backend ("gloo", "nccl"), or
        None for a group of one."""
        return None if self.group is None else dist.get_backend(self.group)

    def stages(self, op, t):
        """True when collective ``op`` of this group goes through host
        buffers for ``t``: a CUDA tensor on a backend listed in
        ``HOST_STAGED`` for ``op``."""
        return t.is_cuda and op in HOST_STAGED.get(self.backend, ())

    def host_buffer(self, key, shape, dtype):
        """A pinned host buffer kept for reuse under ``key`` (the staging
        of an exchange that goes through the host)."""
        key = ("host", key)
        buf = self._buffers.get(key)
        if buf is None or buf.shape != tuple(shape) or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype,
                              pin_memory=torch.cuda.is_available())
            self._buffers[key] = buf
        return buf

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

    def send_recv_(self, out, t, shift=1):
        """One hop around the ring: ``t`` goes to rank ``rank + shift`` and
        ``out`` receives rank ``rank - shift``'s (both mod the group
        size), in one ``batch_isend_irecv``."""
        if self.group is None:
            return out.copy_(t)
        n = self.num_workers
        dst = dist.get_global_rank(self.group, (self.rank + shift) % n)
        src = dist.get_global_rank(self.group, (self.rank - shift) % n)
        staged = self.stages("send_recv", t)
        if staged:
            send = self.host_buffer("send", t.shape, t.dtype)
            send.copy_(t)
            recv = self.host_buffer("recv", t.shape, t.dtype)
        else:
            send, recv = t.contiguous(), out
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, self.group),
            dist.P2POp(dist.irecv, recv, src, self.group),
        ])
        for req in reqs:
            req.wait()
        if staged:
            out.copy_(recv)
        return out

    def all_to_all_(self, out, t):
        """``out[j]`` <- rank j's ``t[rank]``: ``t`` and ``out`` are (n, ...)
        and contiguous, row j going to and coming from rank j."""
        if self.group is None:
            return out.copy_(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    # -- autograd-aware collectives (identities in a group of one) ---------

    def copy_in(self, x):
        """``x`` entering a computation split over the group: the
        identity forward, the sum of the ranks' gradients backward."""
        return x if self.group is None else _CopyIn.apply(x, self)

    def gather(self, x, dim):
        """Every rank's ``x`` concatenated along ``dim`` in rank order;
        backward keeps the rank's slice of the gradient."""
        return x if self.group is None else _Gather.apply(x, self, dim)

    def sum(self, x):
        """The sum of every rank's ``x``; backward sums the gradients too
        (each rank's copy of the result feeds that rank's loss)."""
        return x if self.group is None else _Sum.apply(x, self)

    def ring_step(self, x):
        """Rank ``rank - 1``'s ``x`` (one hop forward around the ring);
        backward sends the gradient one hop back."""
        return x if self.group is None else _RingStep.apply(x, self)

    def all_to_all(self, x, split_dim, concat_dim):
        """JAX's tiled ``all_to_all``: ``x`` split in n chunks along
        ``split_dim``, chunk j sent to rank j, the chunks received
        concatenated along ``concat_dim`` in rank order; backward is the
        reverse exchange."""
        if self.group is None:
            return x
        return _AllToAll.apply(x, self, split_dim, concat_dim)


#: the collectives a backend does not take CUDA tensors for: with such a
#: group they go through pinned host buffers. Chosen per backend up
#: front, never by catching an error. Gloo takes CUDA tensors for the
#: all-reduce, the broadcast, the all-gather and ``all_to_all_single``,
#: and refuses them for send/recv (``gloo_probe.py`` on an H100, torch
#: 2.11: "writev ... Bad address").
HOST_STAGED = {"gloo": frozenset({"send_recv"})}


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone()), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        dim = dim % x.ndim
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, x.shape[dim]
        part = x.contiguous()
        out = torch.empty(mesh.num_workers * part.numel(), dtype=x.dtype,
                          device=x.device)
        mesh.all_gather_(out, part)
        return torch.cat(out.view(mesh.num_workers, *part.shape).unbind(0),
                         dim=dim)

    @staticmethod
    def backward(ctx, g):
        piece = g.narrow(ctx.dim, ctx.mesh.rank * ctx.size, ctx.size)
        return piece.contiguous(), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone()), None


class _RingStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        x = x.contiguous()
        return mesh.send_recv_(torch.empty_like(x), x, 1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return ctx.mesh.send_recv_(torch.empty_like(g), g, -1), None


def _exchange(x, mesh, split_dim, concat_dim):
    n = mesh.num_workers
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = mesh.all_to_all_(torch.empty_like(send), send)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, split_dim, concat_dim):
        ctx.mesh, ctx.dims = mesh, (split_dim, concat_dim)
        return _exchange(x, mesh, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _exchange(g, ctx.mesh, concat_dim, split_dim), None, None, None


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


@dataclass(frozen=True, eq=False)
class ServingMesh:
    """A tensor-parallel serving mesh: the ``devices`` ONE process drives
    over one axis (``axis_name``). Shard i of every split leaf and of the
    K/V lives on ``devices[i]``; the replicated work runs once on
    ``home``, ``devices[0]``. A pool may repeat one device (N shards on
    one card, or on the CPU): the port's counterpart of the JAX
    package's virtual devices (``force_cpu_mesh``), which exercises
    every sharded code path on one device."""

    devices: tuple
    axis_name: str = "model"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.size}

    @property
    def axis_names(self) -> tuple:
        return (self.axis_name,)

    @property
    def home(self) -> torch.device:
        return self.devices[0]


def sum_shards(parts, home):
    """The sum of per-shard partials on ``home``, in shard order: the one
    collective of a serving-mesh pair (the psum JAX's partitioner
    inserts). One part is returned as it is."""
    out = parts[0].to(home)
    for part in parts[1:]:
        out = out + part.to(home)
    return out


def serving_mesh(spec, *, devices=None, axis_name="model", device=None
                 ) -> ServingMesh:
    """THE serving-mesh constructor (``ServingEngine``, ``DecodeStepper``
    and the tests resolve their tensor-parallel mesh here). ``spec``
    forms: ``"tp:N"`` (N-way tensor parallelism over the first N devices
    of the pool), an int N (the same), or a ``ServingMesh``, passed
    through once it carries ``axis_name``. The pool is ``devices`` (a
    list of ``torch.device``s, which may repeat one device), else every
    CUDA card of this host (``local_devices``; ``device="cpu"`` makes it
    the one CPU device, ``device=None`` means CUDA and raises without a
    GPU). Validation is loud and happens here, at construction: an
    unknown spec, fewer than one device, or more ways than the pool has
    devices (naming both numbers) raise ``ValueError``, so a misplaced
    replica fails its boot instead of its first step. A training mesh
    (``DataMesh``, ``GridMesh``: process groups) is refused too."""
    if hasattr(spec, "axis_names"):
        if axis_name not in spec.axis_names:
            raise ValueError(
                f"serving mesh must carry a {axis_name!r} axis; got "
                f"axes {spec.axis_names}"
            )
        if not isinstance(spec, ServingMesh):
            raise ValueError(
                f"{type(spec).__name__} is a mesh of processes; a serving "
                "mesh is one process's devices (serving_mesh('tp:N'))"
            )
        return spec
    if isinstance(spec, str):
        kind, sep, num = spec.partition(":")
        if kind != "tp" or not sep or not num.isdigit():
            raise ValueError(
                f"unrecognized serving mesh spec {spec!r}; expected "
                f"'tp:N', an int, or a ServingMesh"
            )
        n = int(num)
    else:
        n = int(spec)
    if n < 1:
        raise ValueError(f"serving mesh needs >= 1 device; got tp:{n}")
    devs = list(devices) if devices is not None else local_devices(
        None, device)
    if n > len(devs):
        raise ValueError(
            f"serving mesh 'tp:{n}' needs {n} devices but only "
            f"{len(devs)} are available — shrink the mesh or run on a "
            f"host with more devices"
        )
    return ServingMesh(tuple(torch.device(d) for d in devs[:n]), axis_name)


#: the inner axes of a ``GridMesh``: tensor, sequence, expert and
#: pipeline parallelism
GRID_AXES = ("model", "seq", "expert", "pipe")


@dataclass(eq=False)
class GridMesh:
    """One rank's view of a 2-D grid of D x K ranks: ``axis_names`` is
    ("data", inner) with inner "model" (tensor parallelism), "seq"
    (sequence parallelism) or "expert" (expert parallelism), ("pipe",
    "data") for pipeline parallelism (JAX's axis order), or (inner,)
    alone for a grid without a data axis (D = 1). ``data`` is the rank's
    data group (the D ranks of its inner index), ``inner`` its inner
    group (the K ranks of its data index) and ``world`` every rank, each
    a ``DataMesh``."""

    axis_names: tuple
    data: DataMesh
    inner: DataMesh
    world: DataMesh

    @property
    def inner_name(self):
        return next(a for a in self.axis_names if a != "data")

    @property
    def shape(self):
        return {a: (self.data if a == "data" else self.inner).num_workers
                for a in self.axis_names}

    @property
    def device(self):
        return self.world.device

    def release(self):
        for m in (self.data, self.inner, self.world):
            m.release()


def make_grid(data_parallel, inner_size, inner_name, device=None,
              data_axis=True) -> GridMesh:
    """The (data, ``inner_name``) grid over every process of the job:
    ``data_parallel * inner_size`` must be the world size (one process
    per rank). Every rank creates every subgroup, in the same order;
    a group of one has no process group (its collectives are the
    identity). ``data_axis=False`` names only the inner axis (D = 1).
    ``inner_name``: one of ``GRID_AXES``."""
    if inner_name not in GRID_AXES:
        raise ValueError(
            f"inner axis must be one of {GRID_AXES}; got {inner_name!r}"
        )
    world = make_mesh(None, device) if dist.is_initialized() else None
    d_n, k = int(data_parallel), int(inner_size)
    n = 1 if world is None else world.num_workers
    if world is None and d_n * k > 1:
        raise ValueError(
            f"a {d_n} x {k} grid needs {d_n * k} processes: start one "
            "process per rank and call distkeras_tpu_torch.parallel."
            "multihost.initialize() in each (job_deployment.Job does both)"
        )
    if d_n * k != n:
        raise ValueError(
            f"a data={d_n} x {inner_name}={k} grid needs {d_n * k} ranks, "
            f"the job has {n}; the port runs one process per rank"
        )
    if world is None:
        world = make_mesh(1, device)
    d, i = divmod(world.rank, k)
    inner_groups = [_new_group([dd * k + j for j in range(k)])
                    for dd in range(d_n)]
    data_groups = [_new_group([dd * k + j for dd in range(d_n)])
                   for j in range(k)]
    if not (data_axis or d_n > 1):
        names = (inner_name,)
    elif inner_name == "pipe":
        names = ("pipe", "data")
    else:
        names = ("data", inner_name)
    return GridMesh(
        names,
        data=DataMesh(d_n, d, data_groups[i], world.device),
        inner=DataMesh(k, i, inner_groups[d], world.device),
        world=world,
    )


def _new_group(ranks):
    """A process group over ``ranks`` (every process calls this for every
    group); None for a group of one."""
    return dist.new_group(ranks) if len(ranks) > 1 else None


def replicate(model, mesh: DataMesh):
    """Broadcast the model's parameters and buffers from rank 0 in place,
    so every rank starts from rank 0's weights; returns the model."""
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            mesh.broadcast_(t.data)
    return model


def rank_rows(arr, mesh: DataMesh, axis=0, accum=1):
    """Rank r's rows ``[r*B, (r+1)*B)`` of a global batch along ``axis``
    (the rows GSPMD gives device r under ``P("data")``). With ``accum=k``
    the global batch is k accumulation microbatches of consecutive rows
    (the JAX worker's ``reshape(k, B // k)``), each sharded over the
    ranks on its own: the rank takes its rows of microbatch 0, then of
    microbatch 1, ..., so that splitting its rows into k consecutive
    parts (``WorkerCore._batch_grads``) gives it its rows of each global
    microbatch."""
    n, d = arr.shape[axis], mesh.num_workers
    if n % (d * accum):
        raise ValueError(
            f"global batch of {n} rows does not split over "
            f"{d} ranks" + (f" x {accum} microbatches" if accum > 1 else "")
        )
    b = n // (d * accum)
    index = [slice(None)] * arr.ndim
    if accum == 1:
        index[axis] = slice(mesh.rank * b, (mesh.rank + 1) * b)
        return arr[tuple(index)]
    starts = np.arange(accum) * (n // accum) + mesh.rank * b
    index[axis] = (starts[:, None] + np.arange(b)[None, :]).ravel()
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


def host_gather(tree, mesh: DataMesh | None = None, like=None, dim=None):
    """The tree as host numpy arrays, leaves sharded over the group
    gathered whole first: a leaf whose shape differs from its counterpart
    in ``like`` (the full-shaped tree, e.g. on the meta device) is
    all-gathered along ``dim``, or by default along
    ``zero_leaf_sharding`` of the full shape. Every rank must call it (it
    runs collectives)."""
    if like is None:
        return to_host(tree)

    def fix(x, ref):
        if not isinstance(x, torch.Tensor) or tuple(x.shape) == tuple(ref.shape):
            return x
        axis = zero_leaf_sharding(mesh, ref) if dim is None else dim
        part = x.contiguous()
        out = torch.empty(mesh.num_workers * part.numel(), dtype=part.dtype,
                          device=part.device)
        mesh.all_gather_(out, part)
        pieces = out.view(mesh.num_workers, *part.shape).unbind(0)
        return torch.cat(pieces, dim=axis)

    return to_host(_tree_map(fix, tree, like))


def shard_like(tree, whole, held, group: DataMesh):
    """This rank's parts of a tree of whole leaves (a restored optimizer
    state) for leaves split over ``group``: each leaf whose shape in
    ``whole`` (the tree's layout at whole shapes) differs from its shape
    in ``held`` (at the shapes this rank holds) is cut along the one
    dimension where they differ to the group rank's part; every other
    leaf is kept as it is."""
    def cut(x, w, h):
        if not hasattr(x, "shape") or tuple(w.shape) == tuple(h.shape):
            return x
        dim = next(i for i, (a, b) in enumerate(zip(w.shape, h.shape))
                   if a != b)
        c = h.shape[dim]
        index = [slice(None)] * len(w.shape)
        index[dim] = slice(group.rank * c, (group.rank + 1) * c)
        return x[tuple(index)]

    return _tree_map(cut, tree, whole, held)


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
    global batch's mask and keep the rank's rows, and ``MoE`` routes the
    global batch (its capacity and each token's place in its expert's
    queue over every rank's tokens, and the load-balance loss over the
    global batch). A group of one attaches nothing. Returns the number of
    layers attached; ``detach_data_group`` undoes it."""
    if mesh.num_workers <= 1:
        return 0
    n = 0
    for layer in walk_layers(model):
        if hasattr(layer, "data_group"):
            layer.data_group = mesh
            n += 1
    return n


def detach_data_group(model):
    for layer in walk_layers(model):
        if getattr(layer, "data_group", None) is not None:
            layer.data_group = None


def attach_seq_group(model, mesh: DataMesh):
    """Give the layers whose result depends on the whole sequence the
    sequence group of a run whose token axis is split over ``mesh``:
    ``Embedding`` adds the positions at the rank's offset,
    ``GlobalAvgPool1D`` takes the mean over the global sequence, and
    ``Dropout`` and the residual dropout of ``TransformerBlock`` keep the
    rank's tokens of the global mask. A group of one attaches nothing.
    Returns the number of layers attached; ``detach_seq_group`` undoes
    it."""
    if mesh.num_workers <= 1:
        return 0
    n = 0
    for layer in walk_layers(model):
        name = type(layer).__name__
        if name in ("BatchNorm", "MoE"):
            raise NotImplementedError(
                f"{name} under sequence parallelism would take its "
                "statistics or its routing capacity over the rank's "
                "tokens alone; the port splits the token axis of "
                "attention models without them"
            )
        if hasattr(layer, "seq_group"):
            layer.seq_group = mesh
            n += 1
    return n


def detach_seq_group(model):
    for layer in walk_layers(model):
        if getattr(layer, "seq_group", None) is not None:
            layer.seq_group = None
