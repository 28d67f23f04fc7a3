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
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import P, constrain
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
    b_orig, s_orig, d = x.shape
    g_tok = min(MOE_GROUP, s_orig)
    if s_orig % g_tok:
        g_tok = s_orig
    x = x.reshape(b_orig * (s_orig // g_tok), g_tok, d)
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token

    logits = x.float() @ params.router                          # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]  # (B, S, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)          # renormalize

    # Switch-style load-balance aux loss: E * <f_e, p_e>
    experts = torch.arange(e, device=x.device)
    onehot = (gate_idx[..., None] == experts).to(torch.int32)   # (B,S,k,E)
    me = probs.mean(dim=(0, 1))                                 # (E,)
    fe = onehot[:, :, 0].float().mean(dim=(0, 1))
    aux_loss = e * torch.sum(fe * me)

    cap = _capacity(s, e, k, cfg.moe_capacity_factor)
    # position of each (token, slot) within its expert's group buffer
    flat = onehot.reshape(b, s * k, e)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat            # (B,S*k,E)
    pos_in_expert = (pos_in_expert * flat).sum(dim=-1).reshape(b, s, k)
    keep = pos_in_expert < cap                                  # (B, S, k)

    # dispatch / combine tensors (B, S, E, C); positions past capacity
    # match no column
    cap_onehot = pos_in_expert[..., None] == torch.arange(cap,
                                                          device=x.device)
    sel = onehot * keep[..., None]
    disp = torch.einsum("bske,bskc->bsec", sel.to(x.dtype),
                        cap_onehot.to(x.dtype))
    comb = torch.einsum("bske,bskc->bsec",
                        onehot.float() * (gate_vals * keep.float())[..., None],
                        cap_onehot.float()).to(x.dtype)

    expert_in = constrain(torch.einsum("bsec,bsd->becd", disp, x),
                          ("batch", "experts", None, "embed"))  # (B,E,C,d)
    # batched over experts: (E, B·C, d) @ (E, d, f)
    xe = expert_in.transpose(0, 1).reshape(e, b * cap, d)
    gate = torch.bmm(xe, params.w_gate)
    up = torch.bmm(xe, params.w_up)
    act = F.gelu(gate, approximate="tanh") if cfg.mlp_act == "geglu" \
        else F.silu(gate)
    h = constrain(act * up, ("experts", None, None))            # (E,B·C,f)
    expert_out = torch.bmm(h, params.w_down)                    # (E,B·C,d)
    expert_out = constrain(expert_out.reshape(e, b, cap, d).transpose(0, 1),
                           ("batch", "experts", None, "embed"))

    y = torch.einsum("bsec,becd->bsd", comb, expert_out)
    if params.shared is not None:
        y = y + mlp_apply(params.shared, x, cfg.mlp_act)
    return y.reshape(b_orig, s_orig, d), aux_loss
