"""Switch-routed mixture-of-experts, on one device and over
``torch.distributed`` groups (PyTorch port of
``distkeras_tpu.parallel.expert_parallel``).

- ``switch_route``: top-1 routing with a fixed per-expert capacity.
  Tokens claim places in their expert's queue in token order; a token
  past the capacity is dropped (it contributes zero and passes through
  the residual). Returns the (S, E, C) one-hot ``dispatch`` and the
  gate-weighted ``combine`` tensors and the switch load-balance loss
  (E * sum over experts of fraction-routed x mean router probability).
- ``moe_ffn``: the feed-forward over tokens. The JAX package moves tokens
  to expert batches and back with one-hot einsums over (S, E, C); here
  each kept token is placed by an ``index_copy`` into the expert rows
  and gathered back, which gives the same values (each expert's
  feed-forward is per token, so any distinct slot does) and the same
  gradients without the (S, E, C) tensors.
- ``MoE``: the registered layer (``x + moe_ffn(x)``). Its forward writes
  the load-balance loss to the ``aux_loss`` buffer (detached; the JAX
  state tree's layout) and hands the differentiable value to the
  training loss through ``take_aux_loss``.

Under groups (one process per rank) the layer computes what the JAX
package computes over its global view:

- a data group (``parallel.mesh.attach_data_group``, ``data_group``):
  the GLOBAL batch is routed. The capacity counts every rank's tokens,
  and a token's place in its expert's queue is its exclusive running
  count over the global token order (rank 0's rows, then rank 1's, as
  ``parallel.mesh.rank_rows`` cuts them): each rank all-gathers the
  per-expert counts of its tokens and offsets its own places by the
  counts of the ranks before it. The load-balance loss is a product of
  two global means: the counts and the router probabilities are summed
  over the group (the probabilities with autograd) before the product.
- a sequence group (``parallel.mesh.attach_seq_group``, ``seq_group``):
  each rank holds a contiguous piece of every row's tokens, and the
  global batch is routed in JAX's flatten order of the global (rows,
  tokens) array, which interleaves the ranks within each row: the ranks
  gather their per-(row, expert) counts, and a token's place counts the
  earlier rows and, within its row, the earlier ranks' pieces
  (``route_global``). Beside a data group the two compose, the data
  ranks' rows coming one rank after another. Experts stay replicated.
- an expert group (``attach_expert_mesh``, ``expert_group``): rank j of
  k holds experts ``[j*E/k, (j+1)*E/k)`` of ``wi`` and ``wo`` as
  contiguous leaves of their own (``shard_moe_params``) and computes
  them on its kept tokens; the expert outputs are gathered over the
  group, and the tokens enter the experts through a copy whose backward
  sums the group's input gradients, so every rank holds the whole
  gradient of what it stores (the router is whole on every rank).
- a model group (``parallel.tensor_parallel.attach_model_group``): the
  trailing dimensions of ``router`` (D, E), ``wi`` (E, D, H) and ``wo``
  (E, H, D) are split; each rank computes its columns of the router
  logits, of the hidden activations and of the output, and gathers them
  over the group.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from distkeras_tpu_torch.models.layers import (
    Layer,
    _glorot_uniform,
    _normal,
    _param,
    get_activation,
    recomputing,
    register_layer,
)

_gelu = get_activation("gelu")  # jax.nn.gelu: the tanh approximation


def _top1(logits):
    """Router softmax in f32, the top-1 expert (the first on a tie, as
    ``jnp.argmax``) and its gate probability."""
    probs = torch.softmax(logits.float(), dim=-1)
    idx = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, idx[:, None])[:, 0]
    return probs, idx, gate


def _route(logits, capacity: int):
    """(idx, pos, gate, aux): each token's expert, its place in that
    expert's queue (an exclusive running count in token order, so a
    token's keep/drop never depends on later tokens), its gate and the
    load-balance loss. A token is kept where ``pos < capacity``."""
    e = logits.shape[1]
    probs, idx, gate = _top1(logits)
    onehot = F.one_hot(idx, e)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    fraction = onehot.float().mean(dim=0)
    aux = e * torch.sum(fraction * probs.mean(dim=0))
    return idx, pos, gate, aux


def switch_route(router_logits, capacity: int):
    """Top-1 (switch) routing with fixed capacity. ``router_logits``: (S,
    E). Returns (dispatch (S, E, C) one-hot, combine (S, E, C)
    gate-weighted, aux_loss scalar); a dropped token's rows are zero."""
    idx, pos, gate, aux = _route(router_logits, capacity)
    e = router_logits.shape[1]
    keep = (F.one_hot(idx, e) * (pos < capacity)[:, None]).float()
    # a place >= capacity matches no column: a zero row, as jax.nn.one_hot
    slots = torch.arange(capacity, device=pos.device)
    pos_onehot = (pos[:, None] == slots[None, :]).float()
    dispatch = keep[:, :, None] * pos_onehot[:, None, :]
    combine = dispatch * gate[:, None, None]
    return dispatch, combine, aux


def moe_ffn(params, x, capacity_factor=1.25, mesh=None, axis_name="expert"):
    """Switch-MoE feed-forward over tokens.

    params: {"router": (D, E), "wi": (E, D, H), "wo": (E, H, D)} tensors.
    x: (..., D); the leading axes flatten into the token axis. Returns
    (the output, x's shape and dtype, and the f32 aux_loss scalar). The
    router logits are f32 whatever x's dtype; the experts compute in x's
    dtype.

    ``mesh``: run on this rank's part of a group (every rank of the job
    calls it): a ``parallel.mesh.GridMesh`` with an ``axis_name`` axis
    (its data group routes the global batch, x being the rank's rows;
    its ``axis_name`` group splits the experts, ``wi`` and ``wo`` being
    this rank's ``shard_moe_params`` slices) or a ``DataMesh``, the
    expert group alone. The output is the rank's rows, the aux loss the
    global batch's."""
    if mesh is None:
        return _moe(params, x, capacity_factor)
    from distkeras_tpu_torch.parallel.mesh import DataMesh, GridMesh

    if not isinstance(mesh, (DataMesh, GridMesh)):
        raise TypeError(
            "mesh must be a parallel.mesh.GridMesh or DataMesh; got "
            f"{type(mesh).__name__}"
        )
    data = mesh.data if isinstance(mesh, GridMesh) else None
    return _moe(params, x, capacity_factor, data=_live(data),
                expert=_live(_expert_group(mesh, axis_name)))


def _live(group):
    """``group``, or None for a group of one (its collectives are the
    identity and the layer computes as on one device)."""
    return group if group is not None and group.num_workers > 1 else None


def route_global(logits, capacity_factor, data=None, seq=None, rows=1):
    """Top-1 routing of the global batch from this rank's logits (S, E):
    (idx, pos, gate, capacity, aux). ``pos`` is each local token's place
    in its expert's queue over the global token order, ``capacity`` the
    global batch's, ``aux`` the global load-balance loss. ``data``: the
    data group, whose ranks hold consecutive rows, rank by rank (None:
    this rank's rows are the batch). ``seq``: the sequence group, whose
    ranks hold consecutive pieces of every row's tokens; the S tokens are
    then ``rows`` rows of S / rows tokens each (None: the rank holds its
    rows' whole sequences)."""
    s, e = logits.shape
    probs, idx, gate = _top1(logits)
    onehot = F.one_hot(idx, e)
    psum = probs.sum(dim=0)
    n = 1
    if seq is None:
        pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
        counts = onehot.sum(dim=0)
    else:
        pos, counts = _seq_places(onehot, idx, seq, rows)
        psum = seq.sum(psum)
        n = seq.num_workers
    if data is not None:
        every = torch.empty(data.num_workers * e, dtype=counts.dtype,
                            device=counts.device)
        every = data.all_gather_(every, counts).view(data.num_workers, e)
        pos = pos + every[:data.rank].sum(dim=0)[idx]
        counts = every.sum(dim=0)
        psum = data.sum(psum)
        n *= data.num_workers
    s_global = n * s
    capacity = max(1, int(capacity_factor * s_global / e))
    aux = e * torch.sum((counts.float() / s_global) * (psum / s_global))
    return idx, pos, gate, capacity, aux


def _seq_places(onehot, idx, seq, rows):
    """(pos, counts) of this rank's tokens under a sequence group: JAX
    routes the global (rows, tokens) batch flattened row by row, which
    interleaves the group's pieces within each row. A token's place counts
    its expert's tokens in every earlier row (on every rank of the group),
    in the earlier ranks' pieces of its own row, and before it in its own
    piece; the ranks gather their per-(row, expert) counts for it.
    ``counts``: the group's per-expert totals over these rows."""
    s, e = onehot.shape
    by_row = onehot.view(rows, s // rows, e)
    pos = ((torch.cumsum(by_row, dim=1) - 1) * by_row).sum(dim=-1)
    n = seq.num_workers
    every = torch.empty(n * rows * e, dtype=onehot.dtype,
                        device=onehot.device)
    every = seq.all_gather_(every, by_row.sum(dim=1)).view(n, rows, e)
    row_counts = every.sum(dim=0)
    offset = (torch.cumsum(row_counts, dim=0) - row_counts
              + every[:seq.rank].sum(dim=0))
    pos = pos + offset.gather(1, idx.view(rows, -1))
    return pos.view(-1), row_counts.sum(dim=0)


def _moe(params, x, capacity_factor, data=None, expert=None, model=None,
         split=(), seq=None):
    """``moe_ffn`` on this rank's part of its groups (module docstring),
    or on one device when none is given: ``data`` routes the global
    batch, ``seq`` the global sequence of every row (x is (..., T/N, D),
    the rank's piece of each row), ``expert`` splits the experts (``wi``
    and ``wo`` hold this rank's E/k), ``model`` splits the trailing
    dimension of each leaf named in ``split``. A token's slot in its
    expert's batch is its place among the rank's kept tokens of that
    expert, at most min(capacity, S) of them; the dropped tokens land past
    the expert rows."""
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    s = tokens.shape[0]
    router, wi, wo = params["router"], params["wi"], params["wo"]
    if "router" in split:
        logits = model.gather(model.copy_in(tokens).float() @ router, -1)
    else:
        logits = tokens.float() @ router
    e = logits.shape[1]
    if seq is None:
        routed = route_global(logits, capacity_factor, data)
    else:
        if x.dim() < 3:
            raise ValueError(
                "MoE under a sequence group wants (..., tokens, features) "
                f"inputs; got {tuple(x.shape)}"
            )
        routed = route_global(logits, capacity_factor, data, seq,
                              s // x.shape[-2])
    idx, pos, gate, capacity, aux = routed
    kept = pos < capacity
    onehot = F.one_hot(idx, e) * kept[:, None]
    slot = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    cap = min(capacity, s)
    e_loc = wi.shape[0]
    lo = 0 if expert is None else expert.rank * e_loc
    mine = kept & (idx >= lo) & (idx < lo + e_loc)
    rows = torch.where(mine, (idx - lo) * cap + slot,
                       e_loc * cap + torch.arange(s, device=x.device))
    src = tokens
    if expert is not None:
        src = expert.copy_in(src)
    if "wi" in split:
        src = model.copy_in(src)
    placed = torch.index_copy(tokens.new_zeros(e_loc * cap + s, d), 0, rows,
                              src)
    h = _gelu(torch.bmm(placed[: e_loc * cap].view(e_loc, cap, d),
                        wi.to(x.dtype)))
    if "wi" in split:
        h = model.gather(h, -1)
    if "wo" in split:
        out = model.gather(torch.bmm(model.copy_in(h), wo.to(x.dtype)), -1)
    else:
        out = torch.bmm(h, wo.to(x.dtype))
    if expert is not None:
        out = expert.gather(out, 0)
    out = out.reshape(e * cap, d)
    picked = out[torch.where(kept, idx * cap + slot, torch.zeros_like(idx))]
    weight = torch.where(kept, gate, torch.zeros_like(gate)).to(x.dtype)
    return (picked * weight[:, None]).reshape(x.shape), aux


def moe_nodrop(params, x):
    """The switch-MoE branch for serving: top-1 routing with no capacity,
    every token getting its expert's gated output. All E experts run on
    every token and the routed one is selected (E x the FFN's FLOPs); the
    result does not depend on padding or batch composition and equals
    ``moe_ffn``'s wherever that drops nothing. The gate is cast to x's
    dtype. Returns the branch alone (the caller adds the residual)."""
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    _, idx, gate = _top1(tokens.float() @ params["router"])
    h = _gelu(torch.matmul(tokens, params["wi"].to(x.dtype)))  # (E, S, H)
    out_all = torch.matmul(h, params["wo"].to(x.dtype))  # (E, S, D)
    sel = out_all[idx, torch.arange(tokens.shape[0], device=x.device)]
    return (sel * gate.to(x.dtype)[:, None]).reshape(x.shape)


def moe_nodrop_shards(router, experts, x):
    """``moe_nodrop`` with the experts split over a serving mesh:
    ``experts`` holds, per shard, its ``(wi, wo, first)`` (experts
    ``[first, first + len(wi))``, on the shard's device). The router runs
    once on x's (home) device; each shard computes its experts on every
    token and keeps the tokens routed to them, and the shards' partials
    are summed on home in shard order, where each token holds exactly one
    nonzero part: ``moe_nodrop``'s value. Returns the branch alone."""
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    _, idx, gate = _top1(tokens.float() @ router)
    parts = []
    for wi, wo, first in experts:
        t = tokens.to(wi.device)
        h = _gelu(torch.matmul(t, wi.to(x.dtype)))  # (E/N, S, H)
        out = torch.matmul(h, wo.to(x.dtype))  # (E/N, S, D)
        local = idx.to(wi.device) - first
        mine = (local >= 0) & (local < wi.shape[0])
        sel = out[local.clamp(0, wi.shape[0] - 1),
                  torch.arange(t.shape[0], device=t.device)]
        g = gate.to(wi.device).to(x.dtype)[:, None]
        parts.append(torch.where(mine[:, None], sel * g, 0.0))
    from distkeras_tpu_torch.parallel.mesh import sum_shards

    return sum_shards(parts, x.device).reshape(x.shape)


@register_layer
class MoE(Layer):
    """Mixture-of-experts FFN layer (a drop-in Dense-pair replacement):
    ``x + moe_ffn(x)``. Parameters ``router`` (D, E), ``wi`` (E, D, H),
    ``wo`` (E, H, D) with H = hidden_ratio * D: glorot for the router,
    0.02 * normal for the stacks, drawn in that order from the build's
    generator. Each forward writes the switch load-balance loss,
    detached, to the f32 buffer ``aux_loss`` (once per forward, never in
    a ``remat`` replay), and keeps the differentiable value for
    ``take_aux_loss``: ``WorkerCore`` adds ``aux_loss_weight`` times the
    sum of every layer's to the training loss.

    ``data_group``, ``seq_group``, ``expert_group`` and ``model_group``
    are the groups of a multi-rank run (module docstring), set and cleared
    by ``parallel.mesh.attach_data_group``, ``attach_seq_group``,
    ``attach_expert_mesh`` and ``parallel.tensor_parallel.
    attach_model_group``; ``expert_split`` holds the whole shapes of the
    leaves this rank holds a slice of."""

    data_group = None
    seq_group = None
    expert_group = None
    expert_split = {}

    def __init__(self, num_experts, hidden_ratio=4, capacity_factor=1.25):
        super().__init__()
        self.num_experts = int(num_experts)
        self.hidden_ratio = int(hidden_ratio)
        self.capacity_factor = float(capacity_factor)
        self._aux = None

    def init(self, gen, in_shape):
        d, e = in_shape[-1], self.num_experts
        h = self.hidden_ratio * d
        self.router = _param(_glorot_uniform(gen, (d, e), d, e))
        self.wi = _param(_normal(gen, (e, d, h), 0.02))
        self.wo = _param(_normal(gen, (e, h, d), 0.02))
        self.register_buffer("aux_loss", torch.zeros(()))
        return in_shape

    def expert_params(self) -> dict:
        return {"router": self.router, "wi": self.wi, "wo": self.wo}

    def forward(self, x):
        out, aux = _moe(self.expert_params(), x, self.capacity_factor,
                        _live(self.data_group), _live(self.expert_group),
                        _live(self.model_group),
                        split=frozenset(self.model_split),
                        seq=_live(self.seq_group))
        if not recomputing():
            with torch.no_grad():
                self.aux_loss.copy_(aux)
            self._aux = aux if aux.requires_grad else None
        return x + out

    def take_aux_loss(self):
        aux, self._aux = self._aux, None
        return aux

    def __getstate__(self):
        # copies and pickles never carry a forward's autograd graph
        state = self.__dict__.copy()
        state["_aux"] = None
        return state

    def get_config(self):
        return {
            "layer": "MoE",
            "num_experts": self.num_experts,
            "hidden_ratio": self.hidden_ratio,
            "capacity_factor": self.capacity_factor,
        }


# ------------------------------------------------------------ the expert mesh


def is_moe_group(node) -> bool:
    """Whether ``node`` is an MoE param group — {"router", "wi", "wo"},
    the layout ``MoE`` holds. Structural: other layers also name weights
    ``wo`` (the attention output projection), and splitting those over
    the expert axis would be wrong."""
    return isinstance(node, dict) and {"router", "wi", "wo"} <= set(node)


def moe_group_specs(axis_name: str = "expert") -> dict:
    """Partition specs for one MoE param group: the (E, ...) expert
    stacks split their leading (expert) dimension over ``axis_name``,
    the router is whole on every rank."""
    from distkeras_tpu_torch.parallel.tensor_parallel import PartitionSpec as P

    return {"router": P(), "wi": P(axis_name), "wo": P(axis_name)}


def _expert_group(mesh, axis_name):
    if hasattr(mesh, "inner"):
        if axis_name not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.shape} has no {axis_name!r} axis")
        return mesh.inner
    return mesh


def _expert_slice(leaf, group):
    """Rank j's experts ``[j*E/k, (j+1)*E/k)`` of an (E, ...) stack, a
    contiguous leaf of its own (tensor or numpy)."""
    k = leaf.shape[0] // group.num_workers
    part = leaf[group.rank * k:(group.rank + 1) * k]
    if isinstance(part, torch.Tensor):
        return part.contiguous()
    return np.ascontiguousarray(part)


def _is_leaf(node):
    return isinstance(node, (torch.Tensor, np.ndarray, np.generic, int,
                             float, complex, bool))


def shard_moe_params(params, mesh, axis_name: str = "expert"):
    """This rank's part of a params tree (nested dicts, lists and tuples
    of tensors or arrays, the JAX package's ``model.params`` layout):
    every MoE expert stack (``is_moe_group``) cut to the rank's E/k
    experts of the ``axis_name`` group, contiguous; everything else as
    it is."""
    group = _expert_group(mesh, axis_name)

    def place_tree(node):
        if node is None:
            return None
        if is_moe_group(node):
            return {k: (_expert_slice(v, group) if k in ("wi", "wo") else v)
                    for k, v in node.items()}
        if isinstance(node, dict):
            return {k: place_tree(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(place_tree(v) for v in node)
        if not _is_leaf(node):
            # an unrecognized container could hide an expert stack; fail
            # loudly rather than leave it whole
            raise TypeError(
                "shard_moe_params only understands dict/list/tuple param "
                f"trees; got container {type(node).__name__}"
            )
        return node

    return place_tree(params)


def attach_expert_mesh(model, mesh, axis_name: str = "expert") -> int:
    """Split every MoE layer of ``model`` over the ``axis_name`` group of
    ``mesh`` (a ``GridMesh`` with that axis, or the group itself) in
    place: the layer keeps this rank's E/k experts of ``wi`` and ``wo``
    (contiguous parameters of their own) and computes them through the
    group. Raises before any layer changes when a layer's ``num_experts``
    does not divide over the group. Returns how many layers were
    attached; ``detach_expert_mesh`` gathers the experts back."""
    from torch import nn

    from distkeras_tpu_torch.models.sequential import walk_layers

    group = _expert_group(mesh, axis_name)
    layers = [layer for layer in walk_layers(model) if isinstance(layer, MoE)]
    for layer in layers:
        if layer.num_experts % group.num_workers:
            raise ValueError(
                f"num_experts={layer.num_experts} is not divisible by "
                f"mesh axis {axis_name}={group.num_workers}"
            )
    for layer in layers:
        split = {}
        part = shard_moe_params(
            {k: p.detach() for k, p in layer.expert_params().items()}, group)
        for name in ("wi", "wo"):
            split[name] = tuple(getattr(layer, name).shape)
            setattr(layer, name, nn.Parameter(part[name]))
        layer.expert_group, layer.expert_split = group, split
    return len(layers)


def detach_expert_mesh(model, gather=True) -> int:
    """Undo ``attach_expert_mesh``: with ``gather`` each layer's experts
    are all-gathered back whole (every rank of the group calls it, in the
    same order); without, the groups are only dropped (after a failed
    run, when the peers may be gone). Returns how many layers were
    detached."""
    from torch import nn

    from distkeras_tpu_torch.models.sequential import walk_layers

    count = 0
    for layer in walk_layers(model):
        group = getattr(layer, "expert_group", None)
        if not isinstance(layer, MoE) or group is None:
            continue
        if gather:
            with torch.no_grad():
                for name in layer.expert_split:
                    whole = group.gather(getattr(layer, name).detach(), 0)
                    setattr(layer, name, nn.Parameter(whole))
        layer.expert_group, layer.expert_split = None, {}
        count += 1
    return count
