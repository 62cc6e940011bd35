"""Switch-routed mixture-of-experts on one device (PyTorch port of the
single-device half of ``distkeras_tpu.parallel.expert_parallel``).

- ``switch_route``: top-1 routing with a fixed per-expert capacity.
  Tokens claim places in their expert's queue in token order; a token
  past the capacity is dropped (it contributes zero and passes through
  the residual). Returns the (S, E, C) one-hot ``dispatch`` and the
  gate-weighted ``combine`` tensors and the switch load-balance loss
  (E * sum over experts of fraction-routed x mean router probability).
- ``moe_ffn``: the feed-forward over tokens. The JAX package moves tokens
  to expert batches and back with one-hot einsums over (S, E, C); here
  the same placement is an ``index_copy`` into the (E * C, D) expert
  rows and a gather back, which gives the same values (each kept token
  fills exactly one slot) and the same gradients without the (S, E, C)
  tensors.
- ``MoE``: the registered layer (``x + moe_ffn(x)``). Its forward writes
  the load-balance loss to the ``aux_loss`` buffer (detached; the JAX
  state tree's layout) and hands the differentiable value to the
  training loss through ``take_aux_loss``.

The expert mesh (``attach_expert_mesh``, ``shard_moe_params``) is not
ported: it needs more than one card, and no function here takes a mesh.
"""

from __future__ import annotations

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


def moe_ffn(params, x, capacity_factor=1.25):
    """Switch-MoE feed-forward over tokens.

    params: {"router": (D, E), "wi": (E, D, H), "wo": (E, H, D)} tensors.
    x: (..., D); the leading axes flatten into the token axis. Returns
    (the output, x's shape and dtype, and the f32 aux_loss scalar). The
    router logits are f32 whatever x's dtype; the experts compute in x's
    dtype."""
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    s = tokens.shape[0]
    router, wi, wo = params["router"], params["wi"], params["wo"]
    e = router.shape[1]
    capacity = max(1, int(capacity_factor * s / e))
    idx, pos, gate, aux = _route(tokens.float() @ router, capacity)
    kept = pos < capacity
    # a distinct row for every token: kept ones at their expert slot, the
    # dropped ones past the E * C expert rows
    rows = torch.where(kept, idx * capacity + pos,
                       e * capacity + torch.arange(s, device=x.device))
    placed = torch.index_copy(tokens.new_zeros(e * capacity + s, d), 0,
                              rows, tokens)
    expert_in = placed[: e * capacity].view(e, capacity, d)
    h = _gelu(torch.bmm(expert_in, wi.to(x.dtype)))
    expert_out = torch.bmm(h, wo.to(x.dtype)).reshape(e * capacity, d)
    picked = expert_out[torch.where(kept, rows, torch.zeros_like(rows))]
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
    sum of every layer's to the training loss."""

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
        out, aux = moe_ffn(self.expert_params(), x, self.capacity_factor)
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
