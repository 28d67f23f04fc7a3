"""Carry the reference's parameters, projectors and train state over to the
port, and the port's back.

The reference's ``tf.init_params`` pytree (converted to numpy arrays, e.g.
with ``jax.tree.map(np.asarray, params)``) stacks every block leaf on a
leading layer axis for ``scan``; :func:`params_from_numpy` unstacks it into
the port's :class:`~repro_torch.models.transformer.Transformer`, leaf by
leaf under the same names (``attn.wq``, ``moe.router``, ``mamba.a_log``,
``rwkv.w_lora_a`` ...); :func:`params_to_numpy` stacks them back.  Each leaf
takes its port parameter's dtype: the
model dtype, or f32 for the leaves the reference keeps f32 in any model
(the MoE router, the Mamba ``w_dt`` / ``dt_bias`` / ``a_log`` /
``d_skip``, the RWKV ``mu`` / ``w0`` / ``w_lora_*`` / ``bonus_u`` /
``mu_cm``).  bf16 arrays (numpy's ``ml_dtypes.bfloat16``) travel through
f32 exactly, and the port writes its bf16 leaves as f32 (numpy without
``ml_dtypes`` has no bf16).

The train state (``train/trainer.py``) carries ``opt`` {"mu", "nu",
"master"} dicts keyed by parameter name and a ``count`` scalar (and, for
the compressed step, an ``ef`` residual dict keyed by parameter name);
:func:`state_to_numpy` / :func:`state_load_` map any such tree to the
reference's pytree layout (``{"params": {"blocks": {"attn": {"wq": (L, d,
qd)}}}, "opt": {"mu": ..., "count": ()}}``) and back, which is what the
checkpoint store writes.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import is_dtensor, place
from repro_torch.models.transformer import Transformer, init_params, torch_dtype
from repro_torch.train.trainer import state_for

__all__ = ["tensor_from_numpy", "params_from_numpy", "projectors_from_numpy",
           "init_params", "params_to_numpy", "state_to_numpy",
           "state_from_numpy", "state_load_"]


def tensor_from_numpy(a, device="cuda", dtype=None) -> torch.Tensor:
    """numpy array (bf16 included) -> tensor on ``device``; keeps the
    array's dtype unless ``dtype`` is given."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        # bf16: ml_dtypes' bfloat16, or its raw 2-byte records (saved by
        # numpy with ml_dtypes, loaded without); exact through f32
        bits = a.view(np.uint16).astype(np.uint32) << 16
        t = torch.from_numpy(bits.view(np.float32)).to(torch.bfloat16)
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


# ---------------------------------------------------------------------------
# port -> reference layout (and back, in place)
# ---------------------------------------------------------------------------

def _ref_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """Port parameter name -> (reference path, layer or None):
    ``blocks.3.attn.wq`` -> (("blocks", "attn", "wq"), 3)."""
    parts = tuple(name.split("."))
    if parts[0] == "blocks":
        return ("blocks",) + parts[2:], int(parts[1])
    return parts, None


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy (a DTensor gathered whole: a collective)."""
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _set(tree: dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _get(tree: dict, path):
    for p in path:
        tree = tree[p]
    return tree


def _named_to_numpy(named: Dict[str, torch.Tensor]) -> dict:
    """{port parameter name: tensor} -> the reference's nested pytree,
    block leaves stacked on a leading layer axis."""
    out: dict = {}
    layers: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    for name, t in named.items():
        path, layer = _ref_path(name)
        if layer is None:
            _set(out, path, _numpy(t))
        else:
            layers.setdefault(path, {})[layer] = _numpy(t)
    for path, by_layer in layers.items():
        _set(out, path, np.stack([by_layer[i] for i in range(len(by_layer))]))
    return out


def params_to_numpy(module: nn.Module) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's
    layer-stacked pytree (bf16 leaves as f32)."""
    return _named_to_numpy(dict(module.named_parameters()))


def _is_named(d: dict) -> bool:
    """A dict keyed by port parameter names (every name is dotted)."""
    return bool(d) and all("." in k for k in d)


def state_to_numpy(tree):
    """A port tree — a train state {"params", "opt": {"mu", "nu", "count"[,
    "master"]}}, or any tree of modules, dicts (parameter-name dicts
    included) and tensors — in the reference's pytree layout, as numpy
    arrays."""
    if isinstance(tree, nn.Module):
        return params_to_numpy(tree)
    if isinstance(tree, torch.Tensor):
        return _numpy(tree)
    if isinstance(tree, dict):
        if _is_named(tree):
            return _named_to_numpy(tree)
        return {k: state_to_numpy(v) for k, v in tree.items()}
    raise TypeError(f"no reference layout for {type(tree).__name__}")


def _leaves(tree, prefix=()):
    """(reference path, layer or None, tensor) for every tensor of a port
    tree, in the layout of :func:`state_to_numpy`."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, torch.Tensor):
        yield prefix, None, tree
    elif _is_named(tree):
        for name, t in tree.items():
            path, layer = _ref_path(name)
            yield prefix + path, layer, t
    else:
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))


@torch.no_grad()
def state_load_(tree, arrays: dict) -> None:
    """Copy a reference-layout numpy tree into the port tree's tensors IN
    PLACE, each cast to its tensor's dtype (a DTensor takes its own
    block).  Raises KeyError naming what is missing."""
    for path, layer, t in _leaves(tree):
        try:
            a = _get(arrays, path)
        except (KeyError, TypeError):
            raise KeyError("/".join(path)) from None
        a = np.asarray(a) if layer is None else np.asarray(a)[layer]
        src = tensor_from_numpy(a, t.device, t.dtype)
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(src.shape)} "
                             f"!= {tuple(t.shape)}")
        if is_dtensor(t):            # this rank's block of the whole array
            t.to_local().copy_(place(src, t.device_mesh,
                                     tuple(t.placements)).to_local())
        else:
            t.copy_(src)


def state_from_numpy(state_np: dict, cfg: ModelConfig, device="cuda",
                     dtype=None, moment_dtype=torch.float32) -> dict:
    """The reference's train state (numpy) -> a port train state: its
    weights, moments, master copies and count, and its error-feedback
    residual ``ef`` when it has one."""
    params = params_from_numpy(state_np["params"], cfg, device, dtype)
    state = state_for(params, moment_dtype, ef_residual="ef" in state_np)
    state_load_({k: state[k] for k in state if k != "params"},
                {k: state_np[k] for k in state if k != "params"})
    return state
