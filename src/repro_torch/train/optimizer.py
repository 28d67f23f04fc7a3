"""AdamW with f32 master weights (port of ``repro/train/optimizer.py``).

The state is a dict parallel to the parameters, keyed by parameter name
(``nn.Module.named_parameters``): ``mu`` / ``nu`` in ``moment_dtype``,
``count`` a device int32 scalar, and ``master`` (f32 copies of every
leaf) when any parameter is not f32.  The update is the reference's,
written by hand and applied in place under ``torch.no_grad()`` — the
counterpart of its donated ``jit``: ``m ← m − lr·(m̂/(√v̂ + 1e-8) + wd·m)``
on every leaf (norms and embeddings included), which is not
``torch.optim.AdamW``'s decoupled ``p ← p·(1 − lr·wd)``.  The schedule and
the bias corrections are computed in f32 on the device from ``count``,
as ``jnp`` computes them, so a step reads nothing back to the host.

Over DTensor parameters (a sharded train state, ``launch/specs.py``) the
moments and master copies take each parameter's placement, ``count`` is
a replicated DTensor, each gradient is redistributed to its parameter's
placement, and the global norm's sums reduce across the ranks.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch
from torch import nn

from repro_torch.config import TrainConfig
from repro_torch.distributed.sharding import is_dtensor, replicate_like

Params = Union[nn.Module, Dict[str, torch.Tensor]]


def _named(params: Params) -> Dict[str, torch.Tensor]:
    """Parameter name -> tensor, for a module or a plain dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def lr_schedule(step: torch.Tensor, tcfg: TrainConfig) -> torch.Tensor:
    """Linear warmup to ``lr`` then cosine to 10% (f32, on ``step``'s
    device)."""
    step = step.float()
    warm = torch.clamp(step / max(tcfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tcfg.warmup_steps)
                       / max(tcfg.steps - tcfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tcfg.lr * warm * (0.1 + 0.9 * cos)


def adamw_init(params: Params, moment_dtype=torch.float32) -> dict:
    """``moment_dtype=torch.bfloat16`` halves mu / nu (the update math
    still runs in f32)."""
    leaves = _named(params)
    first = next(iter(leaves.values()))
    state = {
        "mu": {k: torch.zeros_like(p, dtype=moment_dtype)
               for k, p in leaves.items()},
        "nu": {k: torch.zeros_like(p, dtype=moment_dtype)
               for k, p in leaves.items()},
        "count": replicate_like(torch.zeros((), dtype=torch.int32,
                                            device=first.device), first),
    }
    if any(p.dtype != torch.float32 for p in leaves.values()):
        state["master"] = {k: p.detach().float().clone()
                           for k, p in leaves.items()}
    return state


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every gradient leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], opt_state: dict,
                 params: Params, tcfg: TrainConfig
                 ) -> Tuple[Params, dict, dict]:
    """One AdamW step on ``params`` and ``opt_state``, both updated in
    place.  ``grads`` maps parameter name -> gradient.  Returns (params,
    opt_state, metrics {"lr", "grad_norm"}), ``grad_norm`` the raw norm
    before the clip."""
    leaves = _named(params)
    count = opt_state["count"]
    count.add_(1)
    lr = lr_schedule(count, tcfg)
    gnorm = global_norm(grads)
    if tcfg.grad_clip > 0:
        clip = torch.clamp(tcfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                           max=1.0)
    else:
        clip = torch.ones_like(gnorm)
    b1, b2 = tcfg.b1, tcfg.b2
    cf = count.float()
    c1 = 1.0 - torch.pow(torch.full_like(cf, b1), cf)
    c2 = 1.0 - torch.pow(torch.full_like(cf, b2), cf)
    master = opt_state.get("master", leaves)
    for k, p in leaves.items():
        g = grads[k]
        if is_dtensor(g) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        g = g.float() * clip
        mu, nu, m = opt_state["mu"][k], opt_state["nu"][k], master[k]
        mu32 = b1 * mu.float() + (1 - b1) * g
        nu32 = b2 * nu.float() + (1 - b2) * torch.square(g)
        step_dir = (mu32 / c1) / (torch.sqrt(nu32 / c2) + 1e-8)
        m_new = m - lr * (step_dir + tcfg.weight_decay * m)
        mu.copy_(mu32)
        nu.copy_(nu32)
        m.copy_(m_new)
        if m is not p:
            p.copy_(m_new)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
