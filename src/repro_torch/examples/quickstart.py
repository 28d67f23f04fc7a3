"""Quickstart: the SALS pipeline end to end on a tiny model, in one file
(port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. build a reduced llama-family model (yi-9b geometry, tiny dims; on the
   card at head_dim 64, the smallest the kernels take)
2. calibrate the latent projector on synthetic pre-RoPE keys (paper §4.2)
3. prefill a prompt into the ``LatentKVCache`` (its compression
   bookkeeping derives from its field shapes and dtypes)
4. decode with sparse attention in latent space (paper Algorithm 1) — both
   the paper-faithful global top-k and the grouped (sequence-sharded)
   layout, which run through the SAME fused decode path
5. compare against the uncompressed full-attention decode
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.config import SALSConfig, ServeConfig
from repro_torch.core.latent_cache import LatentKVCache, cache_bytes_per_token
from repro_torch.data import SyntheticCorpus
from repro_torch.examples import dtype_name, sync
from repro_torch.launch import add_device_args, device_and_dtype, model_config
from repro_torch.launch.serve import calibrate
from repro_torch.models import transformer as tf
from repro_torch.serve import ServeEngine

# SALS-25%: rank r = kv_dim/4, scores on r* = r/2, top-16 tokens
SALS = SALSConfig(rank_ratio=0.25, score_ratio=0.5, n_critical=16,
                  n_sink=2, n_recent=8, v_bits=8, v_group=32,
                  skip_layers_front=1, skip_layers_back=1)


def main(argv=None, *, params=None) -> dict:
    """``params``: the model's weights (default: seeded from 0 on the
    device).  Returns each engine's tokens, the calibration's and each
    engine's seconds and the wall seconds."""
    ap = argparse.ArgumentParser()
    add_device_args(ap)
    args = ap.parse_args(argv)
    dev, dtype = device_and_dtype(args)
    t_start = time.perf_counter()
    cfg = model_config("yi-9b", True, dev, who="quickstart")
    print(f"model: {cfg.name} ({cfg.n_layers}L d={cfg.d_model} "
          f"H={cfg.n_heads}/{cfg.n_kv_heads}kv)")
    if params is None:
        params = tf.init_params(cfg, device=dev, dtype=dtype, seed=0)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)

    sals = SALS
    projectors = calibrate(params, cfg, sals, corpus, n_sequences=8,
                           seq_len=64)
    r = sals.rank(cfg.kv_dim)
    print(f"calibrated U_r: rank {r}/{cfg.kv_dim} per layer, "
          f"stored {dtype_name(projectors['u'].dtype)} "
          f"({projectors['seconds']:.1f}s)")
    # bookkeeping derives from the cache's field shapes/dtypes
    bpt = cache_bytes_per_token(cfg, sals)
    print(f"cache: {bpt:.0f} B/token/layer vs {4 * cfg.kv_dim} B full  "
          f"(={4 * cfg.kv_dim / bpt:.1f}x)")
    shapes = LatentKVCache.init(cfg, sals, 1, 1, 128, device="meta")
    print(f"LatentKVCache fields: k_lat{tuple(shapes.k_lat.shape[1:])} "
          f"{dtype_name(shapes.k_lat.dtype)}, "
          f"v_q{tuple(shapes.v_q.shape[1:])} {dtype_name(shapes.v_q.dtype)} "
          f"(+ scales, sink/recent rings)")

    prompts = [corpus.batch(100 + i, 1, 48)["tokens"][0] for i in range(2)]
    engines = {
        "full": ServeEngine(params, None, cfg, ServeConfig(
            max_seq_len=128, sals=SALSConfig(enabled=False)), device=dev),
        "sals": ServeEngine(params, projectors, cfg, ServeConfig(
            max_seq_len=128, sals=sals), device=dev),
        # grouped layout (n_groups rides as cache metadata): what a
        # kv_seq-sharded deployment runs, same fused kernels per slab
        "sals-g2": ServeEngine(params, projectors, cfg, ServeConfig(
            max_seq_len=128, sals=sals), n_groups=2, device=dev),
    }
    outs, seconds = {}, {}
    for name, eng in engines.items():
        t0 = time.perf_counter()
        outs[name] = eng.generate(prompts, max_new_tokens=12)
        sync(dev)
        seconds[name] = time.perf_counter() - t0
        print(f"{name}: {[r.tokens.tolist() for r in outs[name]]} "
              f"({seconds[name]:.1f}s)")
    agreement = {}
    for name in ("sals", "sals-g2"):
        agreement[name] = float(np.mean([
            np.mean(a.tokens == b.tokens)
            for a, b in zip(outs["full"], outs[name])]))
        print(f"token agreement full vs {name}: {agreement[name]:.0%} "
              f"(random weights -> diffuse attention; see "
              f"examples/train_then_serve.py for the trained-model run)")
    return {"tokens": {k: [r.tokens.tolist() for r in v]
                       for k, v in outs.items()},
            "agreement": agreement, "bytes_per_token": bpt,
            "calibration_s": projectors["seconds"], "seconds": seconds,
            "wall_s": time.perf_counter() - t_start}


if __name__ == "__main__":
    main()
