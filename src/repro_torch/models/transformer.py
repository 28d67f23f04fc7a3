"""Model assembly for the decoder families — dense, vlm, moe, hybrid and
ssm: init / train forward / prefill / decode — and the encoder family's
init and training forward (port of ``repro/models/transformer.py``).

Parameters are an ``nn.Module`` tree (:class:`Transformer`) whose tensors
keep the reference's per-layer layouts; ``convert.params_from_numpy``
carries the reference's layer-stacked pytree over.  The reference scans
over layers; here a Python loop walks them.

Blocks.  dense / vlm: attention + gated MLP; moe: attention + the
mixture-of-experts layer (``models/moe.py``); hybrid: attention ∥ Mamba
heads on the same normed input, merged as (a + s) / 2, + gated MLP; ssm:
RWKV6 time-mix + channel-mix (``models/ssm.py``), no attention; encoder
(hubert): the dense block over precomputed frame embeddings
({"frames": (B, S, d)}), bidirectional and without RoPE, so its
attention reaches the flash kernels non-causal (at head_dim 80 for
hubert-xlarge).  The encoder has no decode phase: its caches, prefill and
decode raise ``ValueError`` as the reference's do.

Segments.  The SALS layer mask is front/back-contiguous, so the stack
splits into up to three segments ``full | sals | full``, each with its own
cache: ``{"k", "v"}`` tensors of shape (ls, B, S, Hkv, dh) for the full
segments and a layer-stacked :class:`LatentKVCache` for the SALS segment
(the dense slot arena, or page pools when ``page_size`` > 0).  The ssm
family has one segment of RWKV state ``{"wkv": (ls, B, H, hs, hs), "tm_x":
(ls, B, d), "cm_x": (ls, B, d)}`` (f32); the hybrid family's segments
carry the Mamba state ``{"ssm": (ls, B, H, P, N), "conv": (ls, B, K-1,
inner)}`` (f32) beside their K/V, as ``seg["ssm"]`` or
``LatentKVCache.ssm``.  Decode writes every state in place, so a captured
decode step keeps its key.  A vlm prompt is {"patches": (B, P, d),
"tokens": (B, S)}: the patch embeddings come first, attend each other
bidirectionally (prefix-LM) and hold cache positions 0 .. P-1, so decode
continues at P + S; chunked prefill and the serving engine take tokens
only, as the reference's do.  Prefill is monolithic (:func:`prefill`, the
recurrent families' only prefill) or chunked (:func:`prefill_chunk`, which
serving uses for the attention families); decode and chunked prefill
update the caches in place.  Speculative decode runs Q tokens through
:func:`decode_window` and commits the accepted prefix with
:func:`commit_window` (attention families only: a rejected draft would
need the recurrent state rolled back).

The SALS segments carry the decode selection layout (``n_groups``, see
``core/latent_cache.py``) as metadata: :func:`init_cache` and
:func:`prefill` stamp it, :func:`prefill_chunk` writes into a cache that
already carries it, and the decode entries read it back from the cache.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.config import ModelConfig, SALSConfig
from repro_torch.core.latent_cache import LATENT_FIELDS, LatentKVCache
from repro_torch.core.sparse_attention import (sals_decode_attend,
                                               sals_window_attend)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P, constrain
from repro_torch.models.layers import (MLP, Embedding, RMSNorm, embed_apply,
                                       embedding_specs, mlp_apply, mlp_specs,
                                       rmsnorm_apply, rmsnorm_specs,
                                       unembed_apply)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[name]


RECURRENT = ("ssm", "hybrid")
# families whose layers run on DTensors under a sharding context
SHARDED = ("dense", "vlm", "encoder")


def _check_sharded(cfg: ModelConfig) -> None:
    if cfg.family not in SHARDED:
        raise ValueError(f"{cfg.family}: sharded runs support the "
                         f"{', '.join(SHARDED)} families")


def _check_unsharded(tokens, what: str) -> None:
    if shd.is_dtensor(tokens):
        raise ValueError(f"{what} runs unsharded: no DTensor inputs")


# ---------------------------------------------------------------------------
# Segment plan
# ---------------------------------------------------------------------------

def segment_plan(cfg: ModelConfig, sals: Optional[SALSConfig]
                 ) -> List[Tuple[int, int, str]]:
    """[(start, stop, mode)] with mode in {"full", "sals"}."""
    l = cfg.n_layers
    if (sals is None or not sals.enabled or not cfg.has_attention
            or not cfg.is_decoder):
        return [(0, l, "full")]
    f = min(sals.skip_layers_front, l)
    b = min(sals.skip_layers_back, l - f)
    segs = []
    if f:
        segs.append((0, f, "full"))
    if l - f - b > 0:
        segs.append((f, l - b, "sals"))
    if b:
        segs.append((l - b, l, "full"))
    return segs


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One block: ``norm1`` / ``norm2`` / ``rwkv`` (ssm), else
    ``attn_norm`` / ``attn`` / ``mlp_norm`` and ``moe`` (moe) or ``mlp``,
    plus ``mamba`` (hybrid)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        if cfg.family == "ssm":
            self.norm1 = RMSNorm(cfg.d_model, dtype, device)
            self.norm2 = RMSNorm(cfg.d_model, dtype, device)
            self.rwkv = ssm_mod.RWKV(cfg, dtype, device)
            return
        self.attn_norm = RMSNorm(cfg.d_model, dtype, device)
        self.attn = attn.Attention(cfg, dtype, device)
        self.mlp_norm = RMSNorm(cfg.d_model, dtype, device)
        if cfg.family == "moe":
            self.moe = moe_mod.MoE(cfg, dtype, device)
        else:
            self.mlp = MLP(cfg, dtype, device)
        if cfg.family == "hybrid":
            self.mamba = ssm_mod.Mamba(cfg, dtype, device)

    def init_(self, generator: torch.Generator) -> None:
        for name in ("rwkv", "attn", "moe", "mlp", "mamba"):
            sub = getattr(self, name, None)
            if sub is not None:
                sub.init_(generator)


class Transformer(nn.Module):
    """Model parameters: embed, blocks[L], final_norm.  The encoder's embed
    holds the unused token table and its untied unembed (``lm_head``), as
    the reference's does."""

    def __init__(self, cfg: ModelConfig, dtype=None, device="cuda"):
        super().__init__()
        dtype = torch_dtype(dtype or cfg.dtype)
        self.embed = Embedding(cfg, dtype, device)
        self.blocks = nn.ModuleList(Block(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device="cuda", dtype=None, seed: int = 0) -> Transformer:
    """Seeded random parameters (the reference's initializer and scales;
    the numbers differ from ``jax.random``'s).  ``generator`` must live on
    ``device``; without one, a generator seeded with ``seed`` is made."""
    params = Transformer(cfg, dtype, device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    params.embed.init_(generator)
    for blk in params.blocks:
        blk.init_(generator)
    return params


def block_specs(cfg: ModelConfig) -> dict:
    """Specs of one block's parameters, nested as the :class:`Block`'s
    submodules (the reference's stacked-block specs without the layer
    axis)."""
    if cfg.family == "ssm":
        return {"norm1": rmsnorm_specs(), "norm2": rmsnorm_specs(),
                "rwkv": ssm_mod.rwkv_specs(cfg)}
    sp = {
        "attn_norm": rmsnorm_specs(),
        "attn": attn.attention_specs(cfg),
        "mlp_norm": rmsnorm_specs(),
    }
    if cfg.family == "moe":
        sp["moe"] = moe_mod.moe_specs(cfg)
    else:
        sp["mlp"] = mlp_specs()
    if cfg.family == "hybrid":
        sp["mamba"] = ssm_mod.mamba_specs(cfg)
    return sp


def _flat(tree: dict, prefix: str) -> Dict[str, P]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, P):
            out[prefix + k] = v
        else:
            out.update(_flat(v, f"{prefix}{k}."))
    return out


def param_specs(cfg: ModelConfig) -> Dict[str, P]:
    """Parameter name (``Transformer.named_parameters``) -> :class:`P`."""
    out = _flat(embedding_specs(cfg), "embed.")
    blk = _flat(block_specs(cfg), "")
    for i in range(cfg.n_layers):
        out.update({f"blocks.{i}.{k}": v for k, v in blk.items()})
    out.update(_flat(rmsnorm_specs(), "final_norm."))
    return out


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def _block_fwd(bp: Block, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, prefix_len: int, collect_kv: bool):
    """One block over a full sequence.  Returns (x, aux_loss, extras):
    with ``collect_kv`` (prefill), extras = {"k_pre", "v"[, "ssm"]} (the
    hybrid's Mamba state), or the ssm family's {"wkv", "tm_x", "cm_x"};
    without it (training), extras is None and attention is
    ``attend_train``.  aux_loss is the MoE router's load-balance loss (0
    elsewhere)."""
    aux = shd.replicate_like(
        torch.zeros((), dtype=torch.float32, device=x.device), x)
    extras = None
    if cfg.family == "ssm":
        h = rmsnorm_apply(bp.norm1, x, cfg.norm_eps)
        tm, wkv, tm_x = ssm_mod.rwkv_time_mix(bp.rwkv, h, cfg, None)
        x = x + tm
        h2 = rmsnorm_apply(bp.norm2, x, cfg.norm_eps)
        cm, cm_x = ssm_mod.rwkv_channel_mix(bp.rwkv, h2, None)
        x = x + cm
        if collect_kv:
            extras = {"wkv": wkv, "tm_x": tm_x, "cm_x": cm_x}
        return x, aux, extras
    h = rmsnorm_apply(bp.attn_norm, x, cfg.norm_eps)
    if collect_kv:
        a, k_pre, v = attn.attend_prefill(bp.attn, h, cfg, positions,
                                          prefix_len)
        extras = {"k_pre": k_pre, "v": v}
    else:
        a = attn.attend_train(bp.attn, h, cfg, positions, prefix_len)
    if cfg.family == "hybrid":
        if collect_kv:
            s_out, extras["ssm"] = ssm_mod.mamba_apply(bp.mamba, h, cfg,
                                                       return_state=True)
        else:
            s_out = ssm_mod.mamba_apply(bp.mamba, h, cfg)
        a = (a + s_out) * 0.5
    x = constrain(x + a, ("batch", "residual_seq", "embed"))
    h2 = rmsnorm_apply(bp.mlp_norm, x, cfg.norm_eps)
    if cfg.family == "moe":
        m, aux = moe_mod.moe_apply(bp.moe, h2, cfg)
    else:
        m = mlp_apply(bp.mlp, h2, cfg.mlp_act)
    return constrain(x + m, ("batch", "residual_seq", "embed")), aux, extras


def embed_inputs(params: Transformer, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """Returns (x (B,S,d), prefix_len) from {"tokens": (B, S)}; for the
    vlm family {"patches": (B, P, d), "tokens": (B, S)}: the patch
    embeddings, cast to the token embedding's dtype and not scaled, then
    the tokens' (P + S positions, prefix_len P); for the encoder family
    {"frames": (B, S, d)}: the frame embeddings (the frontend stub's),
    cast to the params' compute dtype (``final_norm``'s), prefix_len 0."""
    if cfg.family == "encoder":
        x = batch["frames"].to(params.final_norm.scale.dtype)
        return constrain(x, ("batch", "seq", "embed")), 0
    tok_emb = embed_apply(params.embed, batch["tokens"], cfg)
    if cfg.family == "vlm" and "patches" in batch:
        patches = batch["patches"].to(tok_emb.dtype)
        x = torch.cat([patches, tok_emb], dim=1)
        return constrain(x, ("batch", "seq", "embed")), patches.shape[1]
    return tok_emb, 0


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

REMAT = ("none", "block", "save_dots")
# what "save_dots" keeps (the reference: dots_with_no_batch_dims_saveable)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.aten.bmm.default)


def _save_dots_policy(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS \
        else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn, remat: str, *args):
    """``fn(*args)`` under the remat policy: "none" runs it as is; "block"
    keeps only its inputs and recomputes the rest in the backward; and
    "save_dots" also keeps the outputs of its matmuls."""
    if remat == "none":
        return fn(*args)
    if remat == "block":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    if remat == "save_dots":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: ckpt.create_selective_checkpoint_contexts(
                _save_dots_policy))
    raise ValueError(f"remat must be one of {REMAT}, not {remat!r}")


def hidden(params: Transformer, cfg: ModelConfig,
           batch: Dict[str, torch.Tensor], *, remat: str = "none"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward up to the final norm.  Returns (hidden (B, S,
    d), aux_loss): aux_loss () f32 is the MoE load-balance losses summed
    over layers."""
    x, prefix_len = embed_inputs(params, cfg, batch)
    if shd.is_dtensor(x):
        _check_sharded(cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = shd.replicate_like(
        torch.zeros((), dtype=torch.float32, device=x.device), x)
    for bp in params.blocks:
        x, a = _checkpointed(
            lambda x_in, bp=bp: _block_fwd(bp, x_in, cfg, positions,
                                           prefix_len, False)[:2],
            remat, x)
        aux = aux + a
    return rmsnorm_apply(params.final_norm, x, cfg.norm_eps), aux


def forward(params: Transformer, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, remat: str = "none"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B, S, V) f32, aux_loss)."""
    x, aux = hidden(params, cfg, batch, remat=remat)
    return unembed_apply(params.embed, x, cfg), aux


def _gold_nll_sharded(logits, labels):
    """:func:`_gold_nll` of DTensor logits, without gathering a
    vocab-sharded last dim: each rank's local log-sum-exp and the gold
    logit of the shard that holds the label (``local_map``), then the
    log-sum-exp of the per-shard ones and the sum of the gold partials
    (small all-reduces over the vocab axes)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    vd = logits.ndim - 1
    pl = tuple(logits.placements)
    on_vocab = [i for i, p in enumerate(pl) if p == Shard(vd)]
    vocab_axes = tuple(mesh.mesh_dim_names[i] for i in on_vocab)
    lab_pl = tuple(Replicate() if i in on_vocab else p
                   for i, p in enumerate(pl))
    lse_pl = pl                                       # (..., 1) per shard
    gold_pl = tuple(Partial() if i in on_vocab else p
                    for i, p in enumerate(pl))

    def body(lg, lab):
        v_loc = lg.shape[-1]
        rel = lab.long() - shd.axis_index(mesh, vocab_axes) * v_loc
        mine = (rel >= 0) & (rel < v_loc)
        gold = torch.gather(lg, -1, rel.clamp(0, v_loc - 1)[..., None])
        return (torch.logsumexp(lg, dim=-1, keepdim=True),
                torch.where(mine, gold[..., 0], torch.zeros_like(gold[..., 0])))

    lse, gold = shd.local_map(body, (lse_pl, gold_pl), (pl, lab_pl), mesh)(
        logits, labels)
    m = lse.detach().amax(dim=-1, keepdim=True)
    logz = (m + torch.log(torch.sum(torch.exp(lse - m), dim=-1,
                                    keepdim=True)))[..., 0]
    return logz - gold


def _gold_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, S) logsumexp(logits) − logits[label]."""
    if shd.is_dtensor(logits):
        return _gold_nll_sharded(logits, labels)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def forward_loss(params: Transformer, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor], *, remat: str = "none",
                 ce_chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward + chunked cross entropy (the training loss,
    :func:`head_loss`).  vlm: the loss is over the text suffix.  Returns
    (mean NLL () f32, aux)."""
    x, aux = hidden(params, cfg, batch, remat=remat)
    return head_loss(params.embed, cfg, x, batch["labels"], ce_chunk), aux


def head_loss(embed, cfg: ModelConfig, x: torch.Tensor,
              labels: torch.Tensor, ce_chunk: int = 512) -> torch.Tensor:
    """Mean NLL of ``labels`` under the final-normed hidden ``x`` (B, S,
    d) through ``embed``'s unembedding.  The unembed and logsumexp run per
    sequence chunk of ``ce_chunk`` under a checkpoint, so the (B, S, V)
    f32 logits are never held whole: peak memory holds one (B, chunk, V)
    tile.  One chunk when S is not a multiple of ``ce_chunk``; a longer
    ``x`` (vlm) is cut to its last S positions."""
    if x.shape[1] != labels.shape[1]:        # vlm: loss over the text suffix
        x = x[:, -labels.shape[1]:]
    b, s, _ = x.shape
    c = min(ce_chunk, s)
    if s % c:
        c = s

    def chunk_nll(x_c, y_c):
        return _gold_nll(unembed_apply(embed, x_c, cfg), y_c).sum()

    total = shd.replicate_like(
        torch.zeros((), dtype=torch.float32, device=x.device), x)
    for c0 in range(0, s, c):
        total = total + ckpt.checkpoint(chunk_nll, x[:, c0:c0 + c],
                                        labels[:, c0:c0 + c],
                                        use_reentrant=False)
    return total / (b * s)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE.  logits (B, S, V) f32; labels (B, S) int; mask
    optional (B, S)."""
    nll = _gold_nll(logits, labels)
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _finish_block(bp: Block, x, h, a, cfg: ModelConfig,
                  ssm: Optional[dict] = None):
    """Shared tail of a decode / chunk block: the hybrid's Mamba merge (its
    state ``ssm``, one layer's views, updated in place) and the MLP or MoE
    residual."""
    if cfg.family == "hybrid":
        s_out, new = ssm_mod.mamba_decode(bp.mamba, h, cfg, ssm)
        a = (a + s_out) * 0.5
        for name, t in new.items():
            ssm[name].copy_(t)
    x = x + a
    h2 = rmsnorm_apply(bp.mlp_norm, x, cfg.norm_eps)
    if cfg.family == "moe":
        m, _ = moe_mod.moe_apply(bp.moe, h2, cfg)
    else:
        m = mlp_apply(bp.mlp, h2, cfg.mlp_act)
    return x + m


def _layer_state(tree: dict, l: int) -> dict:
    """Layer ``l`` of a layer-stacked state dict, as views."""
    return {name: t[l] for name, t in tree.items()}


# ---------------------------------------------------------------------------
# Cache init / prefill
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, sals: Optional[SALSConfig], batch: int,
               max_seq: int, dtype=None, n_groups: int = 1,
               page_size: int = 0, n_pages: int = 0, hbm_pages: int = 0,
               device="cuda") -> dict:
    """Zero caches for every segment (see the module docstring), the SALS
    segments in the selection layout ``n_groups``.  ``page_size`` > 0 backs the SALS segments with ``n_pages`` physical
    pages instead of the dense (B, max_seq, ·) arena; the full segments
    keep their dense per-slot caches.  ``hbm_pages`` > 0 makes the pool
    two-tier: payload pools of that many device slots (+1 trash), while
    the r* score pool and the page table keep all ``n_pages``.  The
    recurrent families' state (see the module docstring) is zeroed too;
    their caches cannot be paged."""
    dtype = torch_dtype(dtype or cfg.dtype)
    if not cfg.is_decoder:
        raise ValueError("encoder family has no decode cache")
    if page_size and cfg.family in RECURRENT:
        raise ValueError(f"{cfg.family} state is recurrent — the paged "
                         "latent cache needs an attention family")

    def stacked(state: dict, ls: int) -> dict:
        return {k: torch.zeros((ls, *t.shape), dtype=t.dtype, device=device)
                for k, t in state.items()}

    cache: Dict[str, Any] = {}
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        ls = i1 - i0
        if cfg.family == "ssm":
            seg = stacked(ssm_mod.rwkv_state_init(cfg, batch, "meta"), ls)
        elif mode == "full":
            shape = (ls, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
            seg = {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)}
        elif page_size:
            seg = LatentKVCache.init_paged(
                cfg, sals, ls, batch, max_seq, n_pages, page_size, dtype,
                n_groups=n_groups, hbm_pages=hbm_pages, device=device)
        else:
            seg = LatentKVCache.init(
                cfg, sals, ls, batch, max_seq, dtype, n_groups=n_groups,
                device=device)
        if cfg.family == "hybrid":
            st = stacked(ssm_mod.mamba_state_init(cfg, batch, "meta"), ls)
            if mode == "sals":
                seg.ssm = st
            else:
                seg["ssm"] = st
        cache[f"seg{si}"] = seg
    return cache


def cache_pspecs(cache: dict, rules: dict) -> dict:
    """:class:`P` tree of an :func:`init_cache` tree, by leaf name: a SALS
    segment's :class:`LatentKVCache` becomes {field: P} (its hybrid state
    under "ssm"), the other segments keep their dict structure."""
    ba, sa = rules["batch"], rules["kv_seq"]

    def by_name(name: str, nd: int) -> P:
        if name in ("k_lat", "v_q", "v_scale", "v_zero"):
            return P(None, ba, sa, *([None] * (nd - 3)))
        if name == "k_scale":
            return P(None, ba, sa)
        if name in ("sink_k", "sink_v", "recent_k", "recent_v"):
            return P(None, ba, None, None, None)
        if name == "lengths":                # per-slot token counts (L, B)
            return P(None, ba)
        if name in ("k", "v"):               # full-precision skip layers:
            # seq-sharded, each rank writes the rows it owns
            return P(None, ba, sa if isinstance(sa, str) else None,
                     None, None)
        if name == "wkv":                    # rwkv6 (L,B,H,hs,hs)
            return P(None, ba, None, None, None)
        if name in ("tm_x", "cm_x"):
            return P(None, ba, None)
        if name == "ssm":                    # hybrid (L,B,H,P,N)
            return P(None, ba, *([None] * (nd - 2)))
        if name == "conv":                   # hybrid (L,B,K-1,inner)
            return P(None, ba, None, None)
        return P(*([None] * nd))

    def walk(node) -> dict:
        if isinstance(node, LatentKVCache):
            out = {f: by_name(f, getattr(node, f).dim())
                   for f in LATENT_FIELDS if getattr(node, f) is not None}
            if node.ssm is not None:
                out["ssm"] = walk(node.ssm)
            return out
        return {k: walk(v) if isinstance(v, (dict, LatentKVCache))
                else by_name(k, v.dim()) for k, v in node.items()}

    return walk(cache)


def init_prefill_scratch(cfg: ModelConfig, sals: Optional[SALSConfig],
                         batch: int, max_seq: int, dtype=None,
                         device="cuda") -> dict:
    """Full-precision prompt-K/V scratch for the SALS segments of a chunked
    prefill: chunk queries attend exactly to every earlier prompt token,
    which the SALS layers store only compressed, so each SALS layer keeps a
    transient post-RoPE K/V buffer until the prompt is done (the full
    segments use their own decode cache).  Returns {"seg{i}": {"k": (ls,
    B, S, Hkv, dh), "v": ...}} for the SALS segments only."""
    dtype = torch_dtype(dtype or cfg.dtype)
    scratch: Dict[str, Any] = {}
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        if mode == "sals":
            shape = (i1 - i0, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
            scratch[f"seg{si}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return scratch


def prefill(params: Transformer, projectors: Optional[dict],
            cfg: ModelConfig, sals: Optional[SALSConfig],
            batch: Dict[str, torch.Tensor], max_seq: int, n_groups: int = 1,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Process the prompt monolithically and build the decode cache.

    ``lengths`` (B,): per-row true token lengths of a right-padded ragged
    batch (windows hold each row's real positions; logits are taken at
    each row's last real token).  A vlm batch's patches come first: a
    row's cache span is prefix_len + its token length, and ``max_seq``
    must hold P + S and the tokens to decode.  The recurrent families'
    state absorbs every position, pads included: their serving layout is
    uniform-length (``ServeEngine.generate``).  Under a sharding context
    the blocks run on DTensors and the cache is :func:`placed_cache`'s:
    each layer's cache is built from the rank's own batch rows, whole
    along S, and the rank keeps the slab its placement gives it.
    Returns (last-position logits (B, V) f32, cache)."""
    sharded = shd.current_ctx() is not None
    if sharded:
        if lengths is not None:
            raise ValueError("a sharded prefill takes uniform-length rows")
        _check_sharded(cfg)
    dtype = torch_dtype(cfg.dtype)
    x, prefix_len = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    dev = x.device
    positions = torch.arange(s, device=dev)[None, :]
    len_v = None if lengths is None else \
        torch.as_tensor(lengths, device=dev).to(torch.int32)
    # cache positions include any vision prefix
    cache_len = None if len_v is None else prefix_len + len_v
    cache = (placed_cache if sharded else init_cache)(
        cfg, sals, b, max_seq, dtype, n_groups, device=dev)
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        seg = cache[f"seg{si}"]
        for li in range(i0, i1):
            x, _, ex = _block_fwd(params.blocks[li], x, cfg, positions,
                                  prefix_len, True)
            if cfg.family == "ssm":
                for name, t in _layer_state(seg, li - i0).items():
                    t.copy_(ex[name])
                continue
            if mode == "sals":
                u = projectors["u"][li]
                rows = seg.layer_view(li - i0).sink_k
                layer = LatentKVCache.prefill_layer(
                    cfg, sals, u.to_local() if shd.is_dtensor(u) else u,
                    shd.rows_like(ex["k_pre"], rows),
                    shd.rows_like(ex["v"], rows), max_seq, dtype,
                    n_groups=n_groups, lengths=cache_len)
                layer.ssm = ex.get("ssm")
                _put_layer(seg, li - i0, layer)
            else:
                dst = seg["k"][li - i0]
                k_r = shd.rows_like(ex["k_pre"], dst)
                if cfg.use_rope:
                    k_r = attn.apply_rope(k_r, positions, cfg.rope_theta)
                _put_seq_block(dst, k_r.to(dtype))
                _put_seq_block(seg["v"][li - i0],
                               shd.rows_like(ex["v"], dst).to(dtype))
                if "ssm" in ex:
                    for name, t in _layer_state(seg["ssm"],
                                                li - i0).items():
                        t.copy_(ex["ssm"][name])
    x = rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    x = constrain(x, ("batch", "seq", "embed"))
    if len_v is None:
        last = x[:, -1:, :]
    else:
        last_idx = (cache_len - 1).long()
        last = x[torch.arange(b, device=dev), last_idx][:, None]
    return unembed_apply(params.embed, last, cfg)[:, 0], cache


def cache_shapes(cache) -> dict:
    """The shape tree of an :func:`init_cache` tree, in the structure of
    :func:`cache_pspecs`."""
    if isinstance(cache, LatentKVCache):
        out = {f: tuple(getattr(cache, f).shape)
               for f in LATENT_FIELDS if getattr(cache, f) is not None}
        if cache.ssm is not None:
            out["ssm"] = cache_shapes(cache.ssm)
        return out
    return {k: tuple(v.shape) if isinstance(v, torch.Tensor)
            else cache_shapes(v) for k, v in cache.items()}


def placed_cache(cfg: ModelConfig, sals: Optional[SALSConfig], batch: int,
                 max_seq: int, dtype, n_groups: int, device) -> dict:
    """:func:`init_cache`'s zeros as DTensors placed by the sharding
    context's rules (:func:`cache_pspecs`, sanitized to the mesh)."""
    ctx = shd.current_ctx()
    like = init_cache(cfg, sals, batch, max_seq, dtype, n_groups,
                      device="meta")
    spec = shd.sanitize_pspecs(cache_pspecs(like, ctx.rules),
                               cache_shapes(like), ctx.mesh)
    return shd.zeros_placed(like, ctx.mesh,
                            shd.tree_shardings(ctx.mesh, spec), device)


def _put_seq_block(dst, src: torch.Tensor) -> None:
    """Write ``src`` (this rank's rows, positions 0 .. S_src-1) into
    ``dst`` (B, S, ·): a plain tensor takes it whole; a DTensor's rank
    writes the positions of its own slab, at slab-local rows."""
    if not shd.is_dtensor(dst):
        dst[:, :src.shape[1]].copy_(src)
        return
    s0, ns = shd.shard_range(dst, 1)
    loc = dst.to_local()
    n = max(0, min(ns, src.shape[1] - s0))
    loc[:, :n].copy_(src[:, s0:s0 + n])


def _put_layer(seg: LatentKVCache, l: int, layer: LatentKVCache) -> None:
    """Copy the single-layer cache ``layer`` (this rank's rows, whole
    along S) into layer ``l`` of ``seg``; a sequence-sharded ``seg``
    keeps each per-token field's own slab."""
    if not shd.is_dtensor(seg.sink_k):
        seg.set_layer(l, layer)
        return
    lay = seg.layer_view(l)
    for f in LATENT_FIELDS:
        dst = getattr(lay, f)
        if dst is None:
            continue
        if f in ("k_lat", "k_scale", "v_q", "v_scale", "v_zero"):
            _put_seq_block(dst, getattr(layer, f))
        else:
            dst.to_local().copy_(getattr(layer, f))


def prefill_chunk(params: Transformer, projectors: Optional[dict],
                  cfg: ModelConfig, sals: Optional[SALSConfig], cache: dict,
                  scratch: dict, batch: Dict[str, torch.Tensor], off,
                  lengths: torch.Tensor) -> Tuple[torch.Tensor, dict, dict]:
    """One chunked-prefill step: prompt tokens [off, off+C) against the
    cache so far.

    ``batch`` {"tokens": (B, C)} is one chunk of the right-padded prompt;
    ``off`` the chunk's first position, a 0-d integer tensor on the
    device (as the reference's traced offset; a Python int from a direct
    caller), which no step reads on the host, so one captured program
    (``ServeEngine._prefill_chunk``) serves every chunk;
    ``lengths`` (B,) the true prompt lengths.  ``cache`` (from
    :func:`init_cache`, dense) and ``scratch`` (:func:`init_prefill_scratch`)
    are updated in place: each layer LSE-merges a history partial with the
    intra-chunk causal partial (``attention.attend_prefill_chunk``) and
    appends the chunk's K/V — full layers into their decode cache, SALS
    layers into the scratch plus the latent / ring / sink writes of
    ``LatentKVCache.append_chunk``.  Returns (logits (B, V) f32 at each
    row's last real token covered so far (index clip(lengths-1-off, 0,
    C-1) in the chunk: the chunk holding position lengths-1 returns the
    prompt's next-token logits), cache, scratch).  Tokens only: a vlm
    model's chunks carry no patches, as the reference's.  The recurrent
    families have no chunked prefill (their state spans chunk
    boundaries)."""
    if cfg.family in RECURRENT:
        raise ValueError(f"{cfg.family} prefill is recurrent — chunked "
                         "prefill supports attention-only families")
    if not cfg.is_decoder:
        raise ValueError("encoder family has no decode cache to prefill")
    _check_unsharded(batch["tokens"], "chunked prefill")
    x = embed_apply(params.embed, batch["tokens"], cfg)
    b, c, _ = x.shape
    dev = x.device
    len_v = torch.as_tensor(lengths, device=dev).to(torch.int64) \
        .reshape(-1).expand(b)
    off = torch.as_tensor(off, device=dev)
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        seg = cache[f"seg{si}"]
        kv = scratch[f"seg{si}"] if mode == "sals" else seg
        for li in range(i0, i1):
            bp = params.blocks[li]
            h = rmsnorm_apply(bp.attn_norm, x, cfg.norm_eps)
            a, k_pre, v, _, _ = attn.attend_prefill_chunk(
                bp.attn, h, cfg, off, kv["k"][li - i0], kv["v"][li - i0])
            if mode == "sals":
                seg.layer_view(li - i0).append_chunk(
                    cfg, sals, projectors["u"][li], off, k_pre, v, len_v)
            x = _finish_block(bp, x, h, a, cfg)
    x = rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    last = (len_v - 1 - off).clamp(0, c - 1)
    x_last = x[torch.arange(b, device=dev), last][:, None]
    return unembed_apply(params.embed, x_last, cfg)[:, 0], cache, scratch


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_step(params: Transformer, projectors: Optional[dict], cache: dict,
                tokens: torch.Tensor, pos, cfg: ModelConfig,
                sals: Optional[SALSConfig], collect_selection: bool = False):
    """One decode step.  tokens: (B,) int; pos: scalar or (B,) per-row
    positions (the recurrent state is position-free).  Updates ``cache``
    in place, recurrent state included; returns (logits (B, V) f32,
    cache).  With ``collect_selection`` (paged SALS caches only) it also
    returns {seg_name: (ls, B, max_pages) bool}: which LOGICAL pages each
    SALS layer's selection reconstructed from, the tiered scheduler's
    fetch oracle."""
    if not cfg.is_decoder:
        raise ValueError("encoder family has no decode step")
    if shd.is_dtensor(tokens):
        _check_sharded(cfg)
        if shd.is_dtensor(pos):
            pos = pos.full_tensor()
    x = embed_apply(params.embed, tokens[:, None], cfg)       # (B,1,d)
    touched: Dict[str, Any] = {}
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        seg = cache[f"seg{si}"]
        seg_touch = []
        for li in range(i0, i1):
            bp = params.blocks[li]
            if cfg.family == "ssm":
                st = _layer_state(seg, li - i0)
                h = rmsnorm_apply(bp.norm1, x, cfg.norm_eps)
                tm, wkv, tm_x = ssm_mod.rwkv_time_mix(bp.rwkv, h, cfg, st)
                x = x + tm
                h2 = rmsnorm_apply(bp.norm2, x, cfg.norm_eps)
                cm, cm_x = ssm_mod.rwkv_channel_mix(bp.rwkv, h2, st)
                x = x + cm
                st["wkv"].copy_(wkv)
                st["tm_x"].copy_(tm_x)
                st["cm_x"].copy_(cm_x)
                continue
            h = rmsnorm_apply(bp.attn_norm, x, cfg.norm_eps)
            if mode == "sals":
                view = seg.layer_view(li - i0)
                a, _, *t = sals_decode_attend(
                    bp.attn, projectors["u"][li], view, h, pos, cfg, sals,
                    collect=collect_selection)
                seg_touch += t
                ssm = view.ssm
            else:
                a, _, _ = attn.attend_decode_full(
                    bp.attn, h, cfg, seg["k"][li - i0], seg["v"][li - i0],
                    pos)
                ssm = _layer_state(seg["ssm"], li - i0) \
                    if "ssm" in seg else None
            x = _finish_block(bp, x, h, a, cfg, ssm)
        if seg_touch:
            touched[f"seg{si}"] = torch.stack(seg_touch)
    x = rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    logits = unembed_apply(params.embed, x, cfg)[:, 0]
    if collect_selection:
        return logits, cache, touched
    return logits, cache


def decode_window(params: Transformer, projectors: Optional[dict],
                  cache: dict, tokens: torch.Tensor, pos, cfg: ModelConfig,
                  sals: Optional[SALSConfig]) -> Tuple[torch.Tensor, dict]:
    """Speculative verify window: Q tokens through one forward.

    tokens: (B, Q) — the pending token plus Q−1 drafts at positions
    pos..pos+Q−1 (``pos`` scalar or (B,) window base).  The SALS layers
    only read their caches (one latent selection per layer for the whole
    window, ``sals_window_attend``); the full-precision layers write the
    window's K/V in place at positions ≥ the committed length, where no
    committed read looks.  Returns (logits (B, Q, V) f32, aux) —
    ``aux["seg{i}"]`` holds each SALS segment's pre-RoPE window K/V
    ((ls, B, Q, Hkv, dh)) for :func:`commit_window`."""
    if not cfg.is_decoder:
        raise ValueError("encoder family has no decode step")
    if cfg.family in RECURRENT:
        raise ValueError(f"{cfg.family} decode carries recurrent state — a "
                         "rejected draft would need a state rollback; "
                         "speculative windows support attention families")
    _check_unsharded(tokens, "the verify window")
    x = embed_apply(params.embed, tokens, cfg)                # (B,Q,d)
    aux: Dict[str, Any] = {}
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        seg = cache[f"seg{si}"]
        ks, vs = [], []
        for li in range(i0, i1):
            bp = params.blocks[li]
            h = rmsnorm_apply(bp.attn_norm, x, cfg.norm_eps)
            if mode == "sals":
                a, k_pre, v = sals_window_attend(
                    bp.attn, projectors["u"][li], seg.layer_view(li - i0), h,
                    pos, cfg, sals)
                ks.append(k_pre)
                vs.append(v)
            else:
                a = attn.attend_decode_full_window(
                    bp.attn, h, cfg, seg["k"][li - i0], seg["v"][li - i0],
                    pos)
            x = _finish_block(bp, x, h, a, cfg)
        if mode == "sals":
            aux[f"seg{si}"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    x = rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    return unembed_apply(params.embed, x, cfg), aux


def commit_window(projectors: Optional[dict], cache: dict, aux: dict, pos,
                  n_accept, cfg: ModelConfig, sals: Optional[SALSConfig]
                  ) -> dict:
    """Commit a verify window's ACCEPTED prefix into the decode cache, in
    place: window slot t of row b commits at pos + t iff t < n_accept[b]
    ((B,) counts, a device tensor or a host array).  Each SALS segment
    projects its window keys to the latent space with the (B, kv_dim) ·
    U_r product sequential decode uses, one slot and layer at a time (so
    the stored bytes are those sequential decode would store for the same
    keys), and appends them through :meth:`LatentKVCache.write_window`,
    all its layers at once.  The full-precision segments already hold the
    window's K/V (:func:`decode_window`); the advanced positions make the
    accepted prefix committed."""
    for si, (i0, i1, mode) in enumerate(segment_plan(cfg, sals)):
        if mode != "sals":
            continue
        seg, ax = cache[f"seg{si}"], aux[f"seg{si}"]
        k_pre, v = ax["k"], ax["v"]                  # (ls, B, Q, Hkv, dh)
        ls, b, ql = k_pre.shape[:3]
        k_flat = k_pre.reshape(ls, b, ql, cfg.kv_dim)
        k_lat = torch.stack([torch.stack(
            [k_flat[l, :, t].float() @ projectors["u"][i0 + l].float()
             for t in range(ql)], dim=1) for l in range(ls)])
        seg.write_window(sals, pos, k_lat, v.reshape(ls, b, ql, cfg.kv_dim),
                         k_pre, v, n_accept)
    return cache
