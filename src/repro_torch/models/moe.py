"""Mixture-of-Experts layer (llama4-scout top-1 + shared expert; qwen3
top-8) — port of ``repro/models/moe.py``.

Capacity-based dispatch / combine in the einsum form, so every shape is
static and a decode step with MoE layers captures into one CUDA graph:

    dispatch (G, g, E, C) one-hot  ->  expert_in  = einsum('bsec,bsd->becd')
    expert FFN (G, E, C, d)        ->  expert_out = gated MLP per expert
    combine  (G, g, E, C) weights  ->  y          = einsum('bsec,becd->bsd')

Tokens are dispatched in groups of ``min(MOE_GROUP, S)`` (the whole row when
S is not a multiple), each expert taking at most C tokens of a group in
token-major order; tokens past capacity are dropped (Switch behaviour).
The expert products are batched matmuls over the expert axis: every
expert's weights are read whatever the routing.

Under a sharding context a DTensor ``x`` runs the reference's expert
parallelism on local blocks (:func:`_moe_sharded`): each rank routes and
dispatches whole groups of its own, an all-to-all over the expert axis
(``model``) hands every rank the slots of its own experts, the expert FFN
runs there, and the reverse all-to-all brings the outputs back for the
combine.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.models.layers import (MLP, frozen_param, mlp_apply, mlp_specs,
                                       truncated_normal_)

CAPACITY_FACTOR = 1.25
MOE_GROUP = 256     # tokens per dispatch group


class MoE(nn.Module):
    """Router (d, E) f32; experts w_gate / w_up (E, d, f) and w_down
    (E, f, d) in the model dtype; the shared expert a gated MLP of width
    ``n_shared_experts · d_ff``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts

        def t(*shape, dt=dtype):
            return frozen_param(torch.empty(shape, dtype=dt, device=device))

        self.router = t(d, e, dt=torch.float32)
        self.w_gate = t(e, d, f)
        self.w_up = t(e, d, f)
        self.w_down = t(e, f, d)
        self.shared = MLP(cfg, dtype, device,
                          d_ff=cfg.n_shared_experts * cfg.d_ff) \
            if cfg.n_shared_experts else None

    def init_(self, generator: torch.Generator) -> None:
        d, f = self.w_gate.shape[1:]
        truncated_normal_(self.router.data, d ** -0.5, generator)
        truncated_normal_(self.w_gate.data, d ** -0.5, generator)
        truncated_normal_(self.w_up.data, d ** -0.5, generator)
        truncated_normal_(self.w_down.data, f ** -0.5, generator)
        if self.shared is not None:
            self.shared.init_(generator)


def moe_specs(cfg: ModelConfig) -> dict:
    specs = {
        "router": P(None, None),
        "w_gate": P("model", None, None),   # expert parallelism
        "w_up": P("model", None, None),
        "w_down": P("model", None, None),
    }
    if cfg.n_shared_experts:
        specs["shared"] = mlp_specs()
    return specs


def _capacity(n_tokens: int, n_experts: int, top_k: int,
              factor: float) -> int:
    c = int(n_tokens * top_k * factor / n_experts)
    return max(4, -(-c // 4) * 4)  # round up to 4


def moe_apply(params: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux_loss ()).  Routing in f32; top-k
    by a stable descending sort, so of equal probabilities the lower
    expert index wins (``jax.lax.top_k``'s order)."""
    if shd.is_dtensor(x):
        return _moe_sharded(params, x, cfg)
    b, s, d = x.shape
    xg = x.reshape(-1, _group_tokens(s), d)
    y, probs, top1 = _experts(xg, params.router, params.w_gate, params.w_up,
                              params.w_down, cfg)
    # Switch-style load-balance aux loss: E * <f_e, p_e>
    aux_loss = cfg.n_experts * torch.sum(top1.mean(dim=(0, 1))
                                         * probs.mean(dim=(0, 1)))
    if params.shared is not None:
        y = y + mlp_apply(params.shared, xg, cfg.mlp_act)
    return y.reshape(b, s, d), aux_loss


def _group_tokens(s: int) -> int:
    """Tokens per dispatch group for a sequence of ``s``: ``MOE_GROUP``,
    or the whole sequence when it is shorter or not a multiple."""
    g = min(MOE_GROUP, s)
    return s if s % g else g


def _route(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    """Routing and capacity over whole groups ``x`` (G, g, d): returns
    (probs (G, g, E) f32, the top-1 one-hot (G, g, E) f32, the dispatch
    and combine tensors (G, g, E, C)); positions past capacity match no
    column."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(x.float() @ router, dim=-1)           # (G, g, E)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]  # (G, g, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)          # renormalize
    onehot = (gate_idx[..., None] == torch.arange(e, device=x.device)
              ).to(torch.int32)                                 # (G,g,k,E)
    cap = _capacity(s, e, k, cfg.moe_capacity_factor)
    # position of each (token, slot) within its expert's group buffer
    flat = onehot.reshape(b, s * k, e)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(dim=-1) \
        .reshape(b, s, k)
    keep = pos < cap                                            # (G, g, k)
    cap_onehot = pos[..., None] == torch.arange(cap, device=x.device)
    disp = torch.einsum("bske,bskc->bsec", (onehot * keep[..., None]).to(
        x.dtype), cap_onehot.to(x.dtype))
    comb = torch.einsum("bske,bskc->bsec",
                        onehot.float() * (gate_vals * keep.float())[..., None],
                        cap_onehot.float()).to(x.dtype)
    return probs, onehot[:, :, 0].float(), disp, comb


def _experts(xg, router, w_gate, w_up, w_down, cfg: ModelConfig,
             mesh=None, e_dim=None, exchange=False):
    """Route, dispatch, run the experts and combine over whole groups
    ``xg`` (G, g, d).  Returns (y (G, g, d), probs, top-1 one-hot).

    The expert products are batched over experts, (E, G·C, d) @ (E, d,
    f).  With ``e_dim`` (a mesh dim) the weights are this rank's E_l
    experts: ``exchange`` sends each rank's (G, E, C, d) dispatch over
    that dim to the ranks of its experts (an all-to-all) and the outputs
    back; without it the groups are the same on every rank of the dim,
    which takes its own experts' slots and returns their partial sum."""
    probs, top1, disp, comb = _route(router, xg, cfg)
    d = xg.shape[-1]
    ex = torch.einsum("bsec,bsd->becd", disp, xg)               # (G,E,C,d)
    ng, e, cap, _ = ex.shape
    el = w_gate.shape[0]
    m = e // el
    if e_dim is not None and not exchange:
        j = mesh.get_local_rank(e_dim)
        ex = ex[:, j * el:(j + 1) * el]
        comb = comb[:, :, j * el:(j + 1) * el]
    if exchange:                                    # groups -> experts
        t = ex.reshape(ng, m, el, cap, d).transpose(0, 1)
        t = shd.all_to_all(t.reshape(m * ng, el, cap, d), mesh, e_dim)
        xe = t.reshape(m, ng, el, cap, d).permute(2, 0, 1, 3, 4) \
            .reshape(el, m * ng * cap, d)
    else:
        xe = ex.transpose(0, 1).reshape(el, ng * cap, d)
    gate = torch.bmm(xe, w_gate)
    up = torch.bmm(xe, w_up)
    act = F.gelu(gate, approximate="tanh") if cfg.mlp_act == "geglu" \
        else F.silu(gate)
    out = torch.bmm(act * up, w_down)                           # (E_l,·,d)
    if exchange:                                    # experts -> groups
        t = out.reshape(el, m, ng, cap, d).permute(1, 2, 0, 3, 4)
        t = shd.all_to_all(t.reshape(m * ng, el, cap, d), mesh, e_dim)
        out = t.reshape(m, ng, el, cap, d).transpose(0, 1) \
            .reshape(ng, e, cap, d)
    else:
        out = out.reshape(el, ng, cap, d).transpose(0, 1)
    return torch.einsum("bsec,becd->bsd", comb, out), probs, top1


def _regrouped(x: torch.Tensor, g_tok: int, e_dims) -> tuple:
    """Placements of DTensor ``x`` (B, S, d) under which each rank holds
    whole dispatch groups of ``g_tok`` tokens.  The sequence stays split
    where the groups are shard-local; where a group straddles the
    sequence shards, the split moves to the batch rows where they divide,
    else the sequence is whole.  On an expert mesh dim where ``x`` is
    whole, the rows are split too where they divide, so that the groups
    go through the all-to-all rather than being routed on every rank."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = x.device_mesh.shape
    b, s = x.shape[:2]
    pl = [p if p in (Shard(0), Shard(1)) else Replicate()
          for p in x.placements]
    n_seq = rows = 1
    for i, p in enumerate(pl):
        n_seq *= sizes[i] if p == Shard(1) else 1
        rows *= sizes[i] if p == Shard(0) else 1
    straddle = (s // n_seq) % g_tok != 0
    for i, p in enumerate(pl):
        if (p == Shard(1) and straddle) or (p == Replicate()
                                            and i in e_dims):
            if (b // rows) % sizes[i] == 0:
                pl[i] = Shard(0)
                rows *= sizes[i]
            else:
                pl[i] = Replicate()
    return tuple(pl)


def _moe_sharded(params: MoE, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_apply` of a DTensor ``x`` under a sharding context, on
    local blocks (``local_map``).

    Each rank routes and dispatches whole groups (:func:`_regrouped`), so
    capacity and drops are the reference's.  The experts are split over
    the ``experts`` rule's mesh axis (at most one): where the groups
    differ along it, :func:`_experts` exchanges them by all-to-all;
    where they are the same, the combine leaves a partial sum.  The
    load-balance loss sums the per-expert terms over every group (a
    reduction) before it forms the product; along an expert dim with the
    same groups on every rank, its rank 0 alone counts them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    e, d = cfg.n_experts, x.shape[-1]
    ax = shd.sanitize_pspecs(shd.logical_spec(("experts",)), (e,), mesh)[0]
    e_dims = [mesh.mesh_dim_names.index(a) for a in shd._axes(ax)]
    if len(e_dims) > 1:
        raise ValueError(f"experts over {ax}: one mesh axis at most")
    e_dim = e_dims[0] if e_dims else None
    g_tok = _group_tokens(x.shape[1])
    xpl = _regrouped(x, g_tok, e_dims)
    rep = Replicate()
    split = [p != rep for p in xpl]                 # the groups differ
    same_e = [i for i in e_dims if not split[i]]
    ypl = tuple(Partial() if i in same_e else xpl[i]
                for i in range(mesh.ndim))
    spl = tuple(Partial() if split[i] or i in same_e else rep
                for i in range(mesh.ndim))
    wpl = tuple(Shard(0) if i in e_dims else rep for i in range(mesh.ndim))
    wgrad = tuple(Shard(0) if i in e_dims else
                  (Partial() if split[i] else rep) for i in range(mesh.ndim))

    def body(xl, router, w_gate, w_up, w_down):
        bl, sl, _ = xl.shape
        y, probs, top1 = _experts(
            xl.reshape(bl * sl // g_tok, g_tok, d), router, w_gate, w_up,
            w_down, cfg, mesh, e_dim, exchange=e_dim is not None
            and split[e_dim])
        psum, fsum = probs.sum(dim=(0, 1)), top1.sum(dim=(0, 1))
        if any(mesh.get_local_rank(i) for i in same_e):
            psum, fsum = psum * 0, fsum * 0
        return y.reshape(bl, sl, d), psum, fsum

    y, psum, fsum = shd.local_map(
        body, (ypl, spl, spl), (xpl, (rep,) * mesh.ndim, wpl, wpl, wpl),
        mesh, in_grad_placements=(ypl, spl, wgrad, wgrad, wgrad))(
        x, params.router, params.w_gate, params.w_up, params.w_down)
    n = x.shape[0] * x.shape[1]
    aux = e * torch.sum((fsum / n) * (psum / n))
    if params.shared is not None:
        # redistributed before the add, not in it (see
        # ``transformer._residual_add``)
        y = y + mlp_apply(params.shared, x, cfg.mlp_act).redistribute(
            mesh, y.placements)
    return y, aux
