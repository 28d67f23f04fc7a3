"""int8 error-feedback gradient compression over ``torch.distributed``
(port of ``repro/distributed/compression.py``).

The data-parallel gradient reduction, done by hand so that the wire
carries int8 codes:

    local grad -> (+ EF residual) -> per-tensor symmetric int8 quantize
    -> all_gather int8 codes + f32 scales over the group   (about 4x fewer
       bytes on the wire than an f32 ring all-reduce)
    -> dequantize + mean locally -> new residual = local - dequant(local)

The residual carries this step's quantization error into the next step
(error feedback).  Tensors smaller than ``MIN_COMPRESS`` elements ride a
plain all-reduce mean with a zero residual.

A "tensor" is the reference's pytree leaf: a block parameter of every
layer together (its layer-stacked array), under one scale
(:func:`leaf_groups`).

With no process group (``torch.distributed`` not initialized) or a group
of one, the gather is the rank's own codes: the reference's one-device
mesh, where every large leaf is still quantized.  ``group=None`` with
``torch.distributed`` initialized is the world.  Quantize and dequantize
are plain tensor ops, as the reference's are XLA ops (no Pallas kernel).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch import nn

MIN_COMPRESS = 4096

Grads = Dict[str, torch.Tensor]


def group_size(group=None) -> int:
    """Ranks in ``group``; 1 when ``torch.distributed`` is not
    initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _scale(tensors) -> torch.Tensor:
    """max(max|t| / 127, 1e-12) over every tensor (f32)."""
    a = torch.stack([t.abs().max() for t in tensors]).max()
    return torch.clamp_min(a / 127.0, 1e-12)


def _codes(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: scale max(max|g| / 127, 1e-12) (f32),
    codes rounded half to even and clipped to ±127."""
    scale = _scale([g])
    return _codes(g, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def mean_over(x: torch.Tensor, group=None) -> torch.Tensor:
    """The f32 mean of ``x`` over the group's ranks (``x`` itself on one)."""
    x = x.float()
    n = group_size(group)
    if n == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x / n


def _gather(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t``, in rank order."""
    if n == 1:
        return t[None]
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def leaf_groups(names) -> Dict[str, List[str]]:
    """Parameter names by the reference's pytree leaf.  The reference
    stacks every block parameter on a layer axis, so ``blocks.<l>.attn.wq``
    of every layer is one leaf, ``blocks.attn.wq``, quantized under ONE
    scale and held to ``MIN_COMPRESS`` by its stacked size; any other name
    is a leaf of its own."""
    groups: Dict[str, List[str]] = {}
    for k in names:
        p = k.split(".")
        stacked = p[0] == "blocks" and len(p) > 2 and p[1].isdigit()
        groups.setdefault(".".join(p[:1] + p[2:]) if stacked else k,
                          []).append(k)
    return groups


@torch.no_grad()
def compressed_mean_grads(grads: Grads, residual: Grads, group=None
                          ) -> Tuple[Grads, Grads]:
    """Mean-reduce ``grads`` over ``group`` with int8 codes on the wire.
    ``grads`` / ``residual``: {parameter name: tensor} (the residual f32),
    quantized per reference leaf (:func:`leaf_groups`).  Returns (mean
    grads f32 keyed as ``grads``, the new residual).  The residual is
    updated IN PLACE and returned, as the port's train state is (no second
    copy of it lives at once)."""
    n = group_size(group)
    mean = {}
    for members in leaf_groups(grads).values():
        if sum(grads[k].numel() for k in members) < MIN_COMPRESS:
            for k in members:
                mean[k] = mean_over(grads[k], group)
                residual[k].zero_()
            continue
        gcs = [grads[k].float() + residual[k] for k in members]  # feedback
        scale = _scale(gcs)
        sg = _gather(scale.reshape(1), n, group)
        for k, gc in zip(members, gcs):
            q = _codes(gc, scale)
            # the local quantization error
            torch.sub(gc, dequantize_int8(q, scale), out=residual[k])
            qg = _gather(q, n, group)
            mean[k] = torch.mean(
                qg.float() * sg.reshape(n, *([1] * gc.dim())), dim=0)
        del gcs
    return mean, residual


def _leaves(params) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) \
        else dict(params)


def init_residual(params) -> Grads:
    """A zero f32 residual per parameter (a module or {name: tensor}), on
    the parameter's device."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in _leaves(params).items()}


def wire_bytes(params, axis_size: int) -> Tuple[int, int]:
    """(compressed, uncompressed) bytes moved per reduction over
    ``axis_size`` ranks — bookkeeping."""
    comp = unc = 0
    leaves = _leaves(params)
    for members in leaf_groups(leaves).values():
        n = sum(leaves[k].numel() for k in members)
        unc += 2 * n * 4                      # ring all-reduce ≈ 2N f32
        if n >= MIN_COMPRESS:
            comp += (axis_size - 1) * (n + 4)  # all_gather int8 + scale
        else:
            comp += 2 * n * 4
    return comp, unc
