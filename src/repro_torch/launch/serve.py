"""Calibration of the SALS projectors from the model's own pre-RoPE keys
(port of ``repro/launch/serve.py::calibrate`` / ``collect_pre_rope_keys``).

The covariance of each layer's keys is accumulated on the model's device in
float64 and eigendecomposed there (``core.calibration``).
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import calibration as cal
from repro_torch.data import CalibrationSampler
from repro_torch.models import transformer as tf


@torch.inference_mode()
def collect_pre_rope_keys(params, cfg, batch) -> torch.Tensor:
    """(L, B, S, kvd) pre-RoPE keys — runs the full prefill stack."""
    x, prefix_len = tf.embed_inputs(params, cfg, batch)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    keys = []
    for bp in params.blocks:
        x, ex = tf._block_fwd(bp, x, cfg, positions, prefix_len, True)
        b, s_, hkv, dh = ex["k_pre"].shape
        keys.append(ex["k_pre"].reshape(b, s_, hkv * dh))
    return torch.stack(keys)


def calibrate(params, cfg, sals, corpus, n_sequences: int = 16,
              seq_len: int = 128, batch_size: int = 4) -> dict:
    """Fit per-layer projectors from pre-RoPE keys (paper §4.2).  Returns
    {"u": (L, kvd, r) bf16, "eigvals": (L, kvd) f32, "seconds": wall time}
    on the params' device."""
    dev = params.embed.embedding.device
    t0 = time.perf_counter()
    sampler = CalibrationSampler(corpus, n_sequences=n_sequences,
                                 seq_len=seq_len, batch_size=batch_size)

    def key_fn(tokens):
        return collect_pre_rope_keys(
            params, cfg, {"tokens": torch.as_tensor(tokens, device=dev)})

    cov = cal.accumulate_covariance(key_fn, sampler.batches(),
                                    max_tokens=n_sequences * seq_len)
    out = cal.fit_layer_projectors_from_cov(cov, sals.rank(cfg.kv_dim))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["seconds"] = time.perf_counter() - t0
    return out
