"""Carry the reference's parameters and projectors over to the port.

The reference's ``tf.init_params`` pytree (converted to numpy arrays, e.g.
with ``jax.tree.map(np.asarray, params)``) stacks every block leaf on a
leading layer axis for ``scan``; :func:`params_from_numpy` unstacks it into
the port's :class:`~repro_torch.models.transformer.Transformer`, leaf by
leaf under the same names (``attn.wq``, ``moe.router``, ``mamba.a_log``,
``rwkv.w_lora_a`` ...).  Each leaf takes its port parameter's dtype: the
model dtype, or f32 for the leaves the reference keeps f32 in any model
(the MoE router, the Mamba ``w_dt`` / ``dt_bias`` / ``a_log`` /
``d_skip``, the RWKV ``mu`` / ``w0`` / ``w_lora_*`` / ``bonus_u`` /
``mu_cm``).  bf16 arrays (numpy's ``ml_dtypes.bfloat16``) travel through
f32 exactly.
Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.transformer import Transformer, init_params, torch_dtype

__all__ = ["tensor_from_numpy", "params_from_numpy", "projectors_from_numpy",
           "init_params"]


def tensor_from_numpy(a, device="cuda", dtype=None) -> torch.Tensor:
    """numpy array (bf16 included) -> tensor on ``device``; keeps the
    array's dtype unless ``dtype`` is given."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32))
        t = t.to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(params_np: dict, cfg: ModelConfig, device="cuda",
                      dtype=None) -> Transformer:
    """Reference pytree {"embed", "blocks" (layer-stacked), "final_norm"} ->
    port module.  ``dtype`` (the model dtype) defaults to the embedding's
    own."""
    emb = params_np["embed"]["embedding"]
    dtype = torch_dtype(dtype) if dtype is not None else \
        tensor_from_numpy(np.asarray(emb)[:1], "cpu").dtype
    out = Transformer(cfg, dtype, device)

    def put(dst: torch.nn.Parameter, src) -> None:
        t = tensor_from_numpy(src, device, dst.dtype)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(dst.shape)}")
        dst.data.copy_(t)

    def leaf(tree: dict, name: str):
        for part in name.split("."):
            tree = tree[part]
        return tree

    put(out.embed.embedding, emb)
    if out.embed.lm_head is not None:
        put(out.embed.lm_head, params_np["embed"]["lm_head"])
    put(out.final_norm.scale, params_np["final_norm"]["scale"])
    blocks = params_np["blocks"]
    for l, blk in enumerate(out.blocks):
        for name, p in blk.named_parameters():
            put(p, leaf(blocks, name)[l])
    return out


def projectors_from_numpy(proj_np: dict, device="cuda",
                          dtype: Optional[torch.dtype] = None) -> dict:
    """{"u": (L, kvd, r)[, "eigvals"]} -> tensors (u keeps its dtype, bf16
    from the reference's calibration, unless ``dtype`` is given)."""
    out = {"u": tensor_from_numpy(proj_np["u"], device, dtype)}
    if "eigvals" in proj_np:
        out["eigvals"] = tensor_from_numpy(proj_np["eigvals"], device)
    return out
