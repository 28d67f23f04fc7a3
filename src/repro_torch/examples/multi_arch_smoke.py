"""Run one reduced train step + (decoders) one SALS decode step for EVERY
assigned architecture — the '--arch' selector demo (port of
``examples/multi_arch_smoke.py``).

    PYTHONPATH=src python -m repro_torch.examples.multi_arch_smoke \
        [--arch yi-9b] [--device cpu]

On the card the reduced configs take head_dim 64, the smallest the flash
and recon kernels take (``launch.model_config``).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.config import ModelConfig, SALSConfig, TrainConfig
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.core import calibration as cal
from repro_torch.examples import sync
from repro_torch.launch import add_device_args, device_and_dtype, model_config
from repro_torch.models import transformer as tf
from repro_torch.train import trainer

BATCH, SEQ = 2, 64


def sals_for(cfg: ModelConfig) -> Optional[SALSConfig]:
    """The example's SALS settings, None for a family without attention."""
    if not cfg.has_attention:
        return None
    return SALSConfig(rank_ratio=0.25, n_critical=8, n_sink=2, n_recent=4,
                      v_group=32, skip_layers_front=1, skip_layers_back=1)


def random_batch(cfg: ModelConfig, device) -> dict:
    """The step's batch, drawn on ``device`` from generators seeded 0 and 1
    (the reference draws its own from ``jax.random.PRNGKey(0)``)."""
    g0 = torch.Generator(device=device).manual_seed(0)
    g1 = torch.Generator(device=device).manual_seed(1)

    def ints(g):
        return torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g,
                             dtype=torch.int32, device=device)

    def normal(shape):
        return torch.randn(shape, generator=g0, device=device) * 0.1

    if cfg.family == "encoder":
        return {"frames": normal((BATCH, SEQ, cfg.d_model)),
                "labels": ints(g1)}
    batch = {"tokens": ints(g0), "labels": ints(g1)}
    if cfg.family == "vlm":
        batch["patches"] = normal((BATCH, cfg.vision_patches, cfg.d_model))
    return batch


def run_arch(arch: str, device, dtype, params=None, batch=None,
             projectors=None) -> dict:
    """One train step, then for a decoder ``prefill(max_seq=512)`` and one
    ``decode_step``.  ``params`` / ``batch`` / ``projectors`` replace the
    seeded weights, the drawn batch (numpy or tensors) and the random
    projectors.  Prints the reference's line; returns the loss and the
    decode's mode and finiteness."""
    cfg = model_config(arch, True, device, who="multi_arch_smoke")
    t0 = time.perf_counter()
    tcfg = TrainConfig(steps=1, batch_size=BATCH, seq_len=SEQ)
    state = trainer.init_state(cfg, tcfg, device=device, dtype=dtype) \
        if params is None else trainer.state_for(params)
    batch = random_batch(cfg, device) if batch is None else \
        trainer.batch_to(batch, device)
    state, m = trainer.make_train_step(cfg, tcfg)(state, batch)
    out = {"arch": arch, "family": cfg.family, "loss": float(m["loss"]),
           "decode": None}
    line = f"{arch:26s} [{cfg.family:7s}] train loss={out['loss']:7.3f}"

    if cfg.is_decoder:
        sals = sals_for(cfg)
        proj = None
        if sals is not None:
            proj = projectors if projectors is not None else \
                cal.random_layer_projectors(cfg, sals, cfg.n_layers,
                                            device=device)
        pf_batch = {k: v for k, v in batch.items() if k != "labels"}
        pos = SEQ + (cfg.vision_patches if cfg.family == "vlm" else 0)
        with torch.inference_mode():
            last, cache = tf.prefill(state["params"], proj, cfg, sals,
                                     pf_batch, max_seq=512)
            nxt = torch.argmax(last, -1).to(torch.int32)
            lg, _ = tf.decode_step(
                state["params"], proj, cache, nxt,
                torch.full((BATCH,), pos, dtype=torch.int32, device=device),
                cfg, sals)
            out["decode_finite"] = bool(torch.isfinite(lg).all())
        out["decode"] = "sals" if sals else "recurrent"
        line += f"  decode[{out['decode']}] ok"
    else:
        line += "  (encoder: no decode)"
    sync(device)
    out["seconds"] = time.perf_counter() - t0
    print(line + f"  ({out['seconds']:.1f}s)")
    return out


def main(argv=None, *, params=None, batches=None, projectors=None) -> list:
    """``params`` / ``batches`` / ``projectors``: {arch: ...} overriding
    the seeded weights, the drawn batch and the random projectors per
    architecture.  Returns each architecture's :func:`run_arch` result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="", choices=[""] + ASSIGNED_ARCHS)
    add_device_args(ap)
    args = ap.parse_args(argv)
    dev, dtype = device_and_dtype(args)
    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    return [run_arch(a, dev, dtype, (params or {}).get(a),
                     (batches or {}).get(a), (projectors or {}).get(a))
            for a in archs]


if __name__ == "__main__":
    main()
