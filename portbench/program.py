"""The system under test: the port (``repro_torch``), built from a
configuration and the benchmark's weights.

This is the only module of the harness that imports the port.  It hands
the port the benchmark's tensors as its parameters (no copy) and fits the
port's projectors through the port's own calibration path, from the
calibration tokens the benchmark draws.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict

import torch

from portbench.spec import ModelSpec

SRC = Path(__file__).resolve().parents[1] / "src"


def import_port():
    """Put the checkout's ``src`` on the path; the port must be there."""
    if not (SRC / "repro_torch" / "__init__.py").exists():
        raise FileNotFoundError(f"the port is not in this checkout "
                                f"({SRC / 'repro_torch'} is missing)")
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import repro_torch
    return repro_torch


def model_config(spec: ModelSpec):
    import_port()
    from repro_torch.config import ModelConfig
    return ModelConfig(
        name=spec.name, family="dense", n_layers=spec.n_layers,
        d_model=spec.d_model, n_heads=spec.n_heads,
        n_kv_heads=spec.n_kv_heads, head_dim=spec.head_dim,
        d_ff=spec.d_ff, vocab_size=spec.vocab_size,
        rope_theta=spec.rope_theta, tie_embeddings=False,
        norm_eps=spec.norm_eps, dtype=spec.dtype)


def sals_config(spec: ModelSpec):
    import_port()
    from repro_torch.config import SALSConfig
    s = spec.sals
    return SALSConfig(
        rank_ratio=s.rank_ratio, score_ratio=s.score_ratio,
        n_critical=s.n_critical, n_sink=s.n_sink, n_recent=s.n_recent,
        v_bits=s.v_bits, v_group=s.v_group, k_latent_dtype=s.k_latent_dtype,
        skip_layers_front=s.skip_layers_front,
        skip_layers_back=s.skip_layers_back)


def build_params(spec: ModelSpec, w: Dict[str, torch.Tensor]):
    """The port's ``Transformer`` whose parameters ARE the benchmark's
    tensors (views, no copy)."""
    import_port()
    from repro_torch.models import transformer as tf
    params = tf.Transformer(model_config(spec), device="meta")

    def put(mod, name, t):
        mod._parameters[name] = torch.nn.Parameter(t, requires_grad=False)

    put(params.embed, "embedding", w["embed"])
    put(params.embed, "lm_head", w["lm_head"])
    for l, blk in enumerate(params.blocks):
        put(blk.attn_norm, "scale", w["attn_norm"][l])
        put(blk.mlp_norm, "scale", w["mlp_norm"][l])
        for name in ("wq", "wk", "wv", "wo"):
            put(blk.attn, name, w[name][l])
        for name in ("w_gate", "w_up", "w_down"):
            put(blk.mlp, name, w[name][l])
    put(params.final_norm, "scale", w["final_norm"])
    return params


@torch.inference_mode()
def calibrate(params, spec: ModelSpec, cal_tokens: torch.Tensor) -> dict:
    """The port's projectors fitted by its own path (pre-RoPE keys of the
    full prefill stack, f64 covariance, eigh) over the calibration rows
    (B, S), one row at a time."""
    import_port()
    from repro_torch.core import calibration as cal
    from repro_torch.launch.serve import collect_pre_rope_keys
    cfg = model_config(spec)

    def key_fn(tokens):
        return collect_pre_rope_keys(params, cfg, {"tokens": tokens})

    rows = [cal_tokens[i:i + 1] for i in range(cal_tokens.shape[0])]
    cov = cal.accumulate_covariance(key_fn, rows,
                                    max_tokens=cal_tokens.numel())
    return {"u": cal.fit_layer_projectors_from_cov(cov, spec.r)["u"]}
