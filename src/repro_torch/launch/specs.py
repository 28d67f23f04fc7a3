"""Per-(arch × shape × mesh) step assembly (port of
``repro/launch/specs.py``).

Three step kinds (the shape grid's):

  train   — ``step(state, batch)``: fwd + chunked CE + AdamW.  Sharding:
            FSDP('data') × TP('model') params, DP batch over ('pod',
            'data'), sequence-parallel residual, remat=block.
  prefill — ``prefill(params, projectors, batch)``: build the decode cache
            (SALS latent projection + value quantization on the fly).
  decode  — ``decode(params, projectors, cache, tokens, pos)``: one new
            token against a seq_len cache (SALS sparse attention).

:func:`input_specs` returns meta-device stand-ins (no allocation); each
``build_*`` returns ``(fn, args_like, in_placements, out_placements)``:
``args_like`` holds meta tensors (parameters as a meta
:class:`~repro_torch.models.transformer.Transformer`, the train state's
moments and the caches too), the placements are trees of DTensor
placement tuples (:func:`~repro_torch.distributed.sharding.placements`) of
the same structure, and ``fn`` runs the port's ``make_train_step`` /
``prefill`` / ``decode_step`` inside :func:`use_sharding` on arguments
placed by :func:`~repro_torch.distributed.sharding.place`.  The sharded
steps run eagerly.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import (MeshConfig, ModelConfig, SALSConfig,
                                ShapeConfig, TrainConfig)
from repro_torch.core import calibration as cal
from repro_torch.distributed.sharding import (P, axis_names, axis_sizes,
                                              default_rules, fsdp_specs,
                                              mesh_size, sanitize_pspecs,
                                              tree_shardings, use_sharding)
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import cache_pspecs, torch_dtype
from repro_torch.train import trainer

__all__ = ["sals_for_shape", "input_specs", "batch_pspecs", "cache_pspecs",
           "train_state_pspecs", "train_rules", "serve_param_pspecs",
           "build_train", "build_prefill", "build_decode", "build_step",
           "decode_n_groups", "cell_status"]

BIG_PARAMS = 20e9        # above this: bf16 Adam moments
P_REP = P()


# ---------------------------------------------------------------------------
# SALS settings per shape (paper §5.1/§5.2 scaling)
# ---------------------------------------------------------------------------

def sals_for_shape(cfg: ModelConfig, shape: ShapeConfig,
                   rank_ratio: float = 0.25,
                   k_latent_dtype: str = "bfloat16") -> Optional[SALSConfig]:
    if not (cfg.has_attention and cfg.is_decoder):
        return None
    s = shape.seq_len
    if s <= 4096:
        n_crit, n_recent = 432, 64          # paper: x=16, y=432, z=64
    elif s <= 32768:
        n_crit, n_recent = 1024, 128        # paper doubles at 32k
    else:
        n_crit, n_recent = 2048, 128        # 500k: constant working set
    return SALSConfig(
        rank_ratio=rank_ratio,
        v_bits=8 if rank_ratio >= 0.25 else 4,
        n_critical=n_crit, n_sink=16, n_recent=n_recent,
        v_group=min(64, cfg.kv_dim),
        k_latent_dtype=k_latent_dtype,
    )


# ---------------------------------------------------------------------------
# input_specs — meta stand-ins for every model input
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Model inputs for one grid cell (no cache / state — see build_*)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    act = torch_dtype(cfg.dtype)
    if shape.kind == "decode":
        return {"tokens": _meta((b,), i32)}
    if cfg.family == "encoder":
        batch = {"frames": _meta((b, s, cfg.d_model), act)}
        if shape.kind == "train":
            batch["labels"] = _meta((b, s), i32)
        return batch
    batch = {"tokens": _meta((b, s), i32)}
    if cfg.family == "vlm":
        batch["patches"] = _meta((b, cfg.vision_patches, cfg.d_model), act)
    if shape.kind == "train":
        batch["labels"] = _meta((b, s), i32)
    return batch


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, rules: dict) -> dict:
    ba = rules["batch"]
    sp = {}
    for name in input_specs(cfg, shape):
        if name == "tokens" and shape.kind == "decode":
            sp[name] = P(ba)
        elif name in ("tokens", "labels"):
            sp[name] = P(ba, None)
        else:  # frames / patches
            sp[name] = P(ba, None, None)
    return sp


# ---------------------------------------------------------------------------
# Param / state specs
# ---------------------------------------------------------------------------

def _param_shapes(params) -> Dict[str, tuple]:
    return {k: tuple(p.shape) for k, p in params.named_parameters()}


def _fsdp(cfg: ModelConfig, psp: dict, shapes: dict, mesh, axis) -> dict:
    """:func:`fsdp_specs` as the reference derives it over its
    layer-stacked leaves: a block parameter takes the spec of its
    (n_layers, ...) stack with the layer entry dropped, so where the
    stack's FSDP axis fell on the layer dim the parameter stays
    replicated over it."""
    def stacked(name) -> bool:
        return name.startswith("blocks.")

    out = fsdp_specs(
        {k: P(None, *v) if stacked(k) else v for k, v in psp.items()},
        {k: (cfg.n_layers,) + shapes[k] if stacked(k) else shapes[k]
         for k in psp}, mesh, axis)
    return {k: P(*v[1:]) if stacked(k) else v for k, v in out.items()}


def train_state_pspecs(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                       state_shapes, *, strategy: str = "tp_sp") -> dict:
    """Specs of a train state (``trainer.state_for``'s structure, over a
    meta :class:`Transformer` or any state with the same names)."""
    shapes = _param_shapes(state_shapes["params"])
    if strategy == "fsdp":
        # pure ZeRO-3: no TP placements; shard every param's largest dim
        # over ALL mesh axes
        base = {k: P(*([None] * len(s))) for k, s in shapes.items()}
        psp = _fsdp(cfg, base, shapes, mesh, axis_names(mesh))
    elif strategy == "ep_dp":
        # MoE: experts stay EP('model'); every DENSE weight drops its TP
        # placement and is FSDP('data')-streamed instead
        psp = {}
        for name, spec in tf.param_specs(cfg).items():
            keys = name.split(".")
            if "moe" in keys and keys[-1] in ("w_gate", "w_up", "w_down"):
                psp[name] = spec                  # keep EP placement
            else:
                psp[name] = P(*([None] * len(spec)))
        psp = sanitize_pspecs(psp, shapes, mesh)
        psp = _fsdp(cfg, psp, shapes, mesh, "data")
    else:
        psp = sanitize_pspecs(tf.param_specs(cfg), shapes, mesh)
        if "data" in axis_names(mesh):
            psp = _fsdp(cfg, psp, shapes, mesh, "data")
    out = {"params": psp, "opt": {"mu": psp, "nu": psp, "count": P_REP}}
    if "master" in state_shapes["opt"]:
        out["opt"]["master"] = psp
    if "ef" in state_shapes:
        out["ef"] = psp
    return out


def train_rules(cfg: ModelConfig, shape: ShapeConfig, mesh,
                mesh_cfg: MeshConfig, strategy: str) -> dict:
    """Logical-axis rules per train parallelism strategy.

    tp_sp — Megatron TP('model') + sequence-parallel residual + FSDP('data')
            weights: per-layer activation collectives on the model axis.
    fsdp  — ZeRO-3 over ALL mesh axes, batch spread over every axis; no
            per-layer activation collectives, weights stream instead.
            When the global batch can't cover the mesh, batch covers the
            data axes and the residual seq shards over 'model'.
    ep_dp — MoE: experts EP('model'), the dense weights FSDP('data').
    """
    rules = default_rules(mesh_cfg, shape)
    names = axis_names(mesh)
    if strategy == "ep_dp":
        data_axes = tuple(a for a in names if a != "model")
        rules["batch"] = data_axes if len(data_axes) > 1 else data_axes[0]
        rules.update(residual_seq="model", heads=None, kv_heads=None,
                     mlp=None, experts="model", seq=None, vocab="model")
        return rules
    if strategy != "fsdp":
        return rules
    if shape.global_batch % mesh_size(mesh) == 0:
        # one (or more) whole sequences per rank: no per-layer activation
        # collectives
        rules["batch"] = tuple(names)
        rules["residual_seq"] = None
    else:
        rules["batch"] = tuple(a for a in names if a != "model")
        rules["residual_seq"] = "model"
    rules.update(heads=None, kv_heads=None, mlp=None, experts=None,
                 seq=None, vocab=None)
    return rules


SERVE_TP_BUDGET = 4 * 2**30   # bf16 param bytes per rank before adding FSDP


def serve_param_pspecs(cfg: ModelConfig, param_shapes, mesh) -> dict:
    """Serve weights: TP('model'), plus FSDP('data') only when TP alone
    leaves more than ~4 GiB of weights per rank."""
    shapes = param_shapes if isinstance(param_shapes, dict) \
        else _param_shapes(param_shapes)
    psp = sanitize_pspecs(tf.param_specs(cfg), shapes, mesh)
    tp_bytes = 2 * cfg.param_count() / axis_sizes(mesh).get("model", 1)
    if "data" in axis_names(mesh) and tp_bytes > SERVE_TP_BUDGET:
        psp = _fsdp(cfg, psp, shapes, mesh, "data")
    return psp


# ---------------------------------------------------------------------------
# Step builders — each returns (fn, args_like, in_placements, out_placements)
# ---------------------------------------------------------------------------

def _meta_params(cfg: ModelConfig) -> tf.Transformer:
    return tf.Transformer(cfg, torch_dtype(cfg.dtype), "meta")


def build_train(cfg: ModelConfig, shape: ShapeConfig, mesh,
                mesh_cfg: MeshConfig, *, microbatches: int = 1,
                remat: str = "block", strategy: str = "tp_sp",
                tcfg: Optional[TrainConfig] = None):
    """``tcfg`` (default: the reference's, 1000 steps at the cell's batch
    and length) sets the optimizer; its microbatches must match."""
    tcfg = tcfg or TrainConfig(steps=1000, batch_size=shape.global_batch,
                               seq_len=shape.seq_len,
                               microbatches=microbatches)
    rules = train_rules(cfg, shape, mesh, mesh_cfg, strategy)
    moment_dtype = torch.bfloat16 if cfg.param_count() > BIG_PARAMS \
        else torch.float32
    state_like = trainer.state_for(_meta_params(cfg), moment_dtype)
    batch_like = input_specs(cfg, shape)

    state_sp = train_state_pspecs(cfg, tcfg, mesh, state_like,
                                  strategy=strategy)
    batch_sp = batch_pspecs(cfg, shape, rules)
    metrics_sp = {k: P_REP for k in ("loss", "ce", "aux", "lr", "grad_norm")}

    step = trainer.make_train_step(cfg, tcfg, remat=remat)

    def fn(state, batch):
        with use_sharding(mesh, rules):
            return step(state, batch)

    return (fn, (state_like, batch_like),
            (tree_shardings(mesh, state_sp), tree_shardings(mesh, batch_sp)),
            (tree_shardings(mesh, state_sp),
             tree_shardings(mesh, metrics_sp)))


def _cache_like(cfg, sals, batch, max_seq, n_groups: int = 1):
    return tf.init_cache(cfg, sals, batch, max_seq, torch_dtype(cfg.dtype),
                         n_groups, device="meta")


def decode_n_groups(mesh, rules: dict, s: int, dist_mode: Optional[str],
                    sals) -> int:
    """Grouped-selection fan-out for ``dist_mode="local"``: one group per
    kv_seq shard (1 when the seq len doesn't divide, or for "global").
    Shared by build_prefill and build_decode so the cache's ``n_groups``
    matches across the prefill->decode pipeline."""
    if dist_mode != "local" or sals is None:
        return 1
    sizes = axis_sizes(mesh)
    sa = rules["kv_seq"]
    n = 1
    for a in ((sa,) if isinstance(sa, str) else tuple(sa or ())):
        n *= sizes[a]
    if n > 1 and s % n:
        n = 1
    return n


def _logits_pspec(cfg: ModelConfig, b: int, rules: dict, mesh) -> P:
    return sanitize_pspecs(P(rules["batch"], rules["vocab"]),
                           (b, cfg.vocab_size), mesh)


def _cache_pspecs(cache_like, rules: dict, mesh) -> dict:
    return sanitize_pspecs(cache_pspecs(cache_like, rules),
                           tf.cache_shapes(cache_like), mesh)


def _projector_stand_ins(cfg: ModelConfig, sals: Optional[SALSConfig]):
    if sals is None:
        return None, None
    kvd = cfg.kv_dim
    r = sals.rank(kvd)
    like = {"u": _meta((cfg.n_layers, kvd, r), cal.U_DTYPE),
            "eigvals": _meta((cfg.n_layers, kvd), torch.float32)}
    return like, cal.projector_specs()


def _serve_cell(cfg, shape, mesh, mesh_cfg, rank_ratio, sals_enabled,
                dist_mode, k_latent_dtype):
    rules = default_rules(mesh_cfg, shape)
    sals = sals_for_shape(cfg, shape, rank_ratio, k_latent_dtype) \
        if sals_enabled else None
    dist_mode = dist_mode or mesh_cfg.dist_mode
    params_like = _meta_params(cfg)
    param_sp = serve_param_pspecs(cfg, params_like, mesh)
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        s += cfg.vision_patches          # patch prefix occupies cache slots
    return rules, sals, dist_mode, params_like, param_sp, b, s


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  mesh_cfg: MeshConfig, *, rank_ratio: float = 0.25,
                  sals_enabled: bool = True, dist_mode: Optional[str] = None,
                  k_latent_dtype: str = "bfloat16"):
    rules, sals, dist_mode, params_like, param_sp, b, s = _serve_cell(
        cfg, shape, mesh, mesh_cfg, rank_ratio, sals_enabled, dist_mode,
        k_latent_dtype)
    batch_like = input_specs(cfg, shape)
    batch_sp = batch_pspecs(cfg, shape, rules)

    if cfg.family == "encoder":
        def fn(params, batch):
            with use_sharding(mesh, rules):
                return tf.hidden(params, cfg, batch)[0]
        return (fn, (params_like, batch_like),
                (tree_shardings(mesh, param_sp),
                 tree_shardings(mesh, batch_sp)),
                tree_shardings(mesh, P(rules["batch"], None, None)))

    proj_like, proj_sp = _projector_stand_ins(cfg, sals)
    # the produced cache carries the decode step's grouped layout
    n_groups = decode_n_groups(mesh, rules, s, dist_mode, sals)
    cache_like = _cache_like(cfg, sals, b, s, n_groups)
    cache_sp = _cache_pspecs(cache_like, rules, mesh)

    def fn(params, projectors, batch):
        with use_sharding(mesh, rules):
            return tf.prefill(params, projectors, cfg, sals, batch, s,
                              n_groups=n_groups)

    return (fn, (params_like, proj_like, batch_like),
            (tree_shardings(mesh, param_sp),
             None if proj_sp is None else tree_shardings(mesh, proj_sp),
             tree_shardings(mesh, batch_sp)),
            (tree_shardings(mesh, _logits_pspec(cfg, b, rules, mesh)),
             tree_shardings(mesh, cache_sp)))


def build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 mesh_cfg: MeshConfig, *, rank_ratio: float = 0.25,
                 sals_enabled: bool = True, dist_mode: Optional[str] = None,
                 k_latent_dtype: str = "bfloat16"):
    rules, sals, dist_mode, params_like, param_sp, b, s = _serve_cell(
        cfg, shape, mesh, mesh_cfg, rank_ratio, sals_enabled, dist_mode,
        k_latent_dtype)
    if shape.global_batch == 1 and sals is not None:
        # long-context b=1: the skip-layer full caches can't batch-shard;
        # shard their seq over 'model' only when replicated they would
        # exceed ~4 GiB per rank
        n_skip = sals.skip_layers_front + sals.skip_layers_back
        repl = 2 * shape.seq_len * cfg.kv_dim * 2 * n_skip
        if repl > 4 * 2**30:
            rules["kv_seq_full"] = "model"
    proj_like, proj_sp = _projector_stand_ins(cfg, sals)
    # local top-k groups = number of kv_seq shards; rides as metadata on
    # the cache's LatentKVCache segments
    n_groups = decode_n_groups(mesh, rules, s, dist_mode, sals)
    cache_like = _cache_like(cfg, sals, b, s, n_groups)
    cache_sp = _cache_pspecs(cache_like, rules, mesh)
    tok_like = _meta((b,), torch.int32)

    def fn(params, projectors, cache, tokens, pos):
        with use_sharding(mesh, rules):
            return tf.decode_step(params, projectors, cache, tokens, pos,
                                  cfg, sals)

    return (fn, (params_like, proj_like, cache_like, tok_like,
                 _meta((), torch.int32)),
            (tree_shardings(mesh, param_sp),
             None if proj_sp is None else tree_shardings(mesh, proj_sp),
             tree_shardings(mesh, cache_sp),
             tree_shardings(mesh, P(rules["batch"])),
             tree_shardings(mesh, P_REP)),
            (tree_shardings(mesh, _logits_pspec(cfg, b, rules, mesh)),
             tree_shardings(mesh, cache_sp)))


def build_step(kind: str, cfg: ModelConfig, shape: ShapeConfig, mesh,
               mesh_cfg: MeshConfig, **kw):
    if kind == "train":
        return build_train(cfg, shape, mesh, mesh_cfg, **kw)
    if kind == "prefill":
        return build_prefill(cfg, shape, mesh, mesh_cfg, **kw)
    if kind == "decode":
        return build_decode(cfg, shape, mesh, mesh_cfg, **kw)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Grid / skip logic
# ---------------------------------------------------------------------------

def cell_status(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason)."""
    if shape.kind == "decode" and not cfg.is_decoder:
        return False, "encoder-only: no decode step"
    return True, ""
