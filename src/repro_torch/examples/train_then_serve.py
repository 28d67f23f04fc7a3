"""End-to-end driver: train a ~100M-param model for a few hundred steps on
the synthetic corpus (with checkpointing + straggler monitoring), calibrate
SALS post-training, and serve batched requests through the scheduler with
the compressed cache — comparing quality and tokens/s against the
uncompressed engine (port of ``examples/train_then_serve.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_then_serve \
        [--steps 300] [--d-model 512] [--layers 8] [--device cpu]

~100M params needs d_model=512, 8 layers, vocab 32k (embeddings dominate);
the defaults train a smaller variant; pass --full-100m for the real thing.
A checkpoint directory that already holds checkpoints resumes from its
newest.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import checkpoint as ckpt
from repro_torch.config import ModelConfig, SALSConfig, ServeConfig, TrainConfig
from repro_torch.core.latent_cache import cache_bytes_per_token
from repro_torch.data import SyntheticCorpus, make_batches
from repro_torch.examples import dtype_name, sync
from repro_torch.ft import StragglerMonitor
from repro_torch.launch import add_device_args, device_and_dtype
from repro_torch.launch.serve import calibrate
from repro_torch.serve import Request, RequestScheduler, ServeEngine
from repro_torch.train import trainer


def sals_for(cfg: ModelConfig) -> SALSConfig:
    """The example's SALS-25% settings for post-training serving."""
    return SALSConfig(rank_ratio=0.25, score_ratio=0.5, n_critical=48,
                      n_sink=4, n_recent=16, v_bits=8,
                      v_group=min(64, cfg.kv_dim),
                      skip_layers_front=1, skip_layers_back=1)


def main(argv=None, *, params=None, on_step=None) -> dict:
    """``params``: the untrained weights (default: seeded from 0 on the
    device); ``on_step(step, metrics, seconds)`` sees every training step.
    Returns the trained state, the calibration's seconds, each engine's
    tokens, tokens/s and finished requests, and the greedy agreements."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt/e2e")
    add_device_args(ap)
    args = ap.parse_args(argv)
    if args.full_100m:
        args.d_model, args.layers, args.vocab = 512, 8, 32768
    dev, dtype = device_and_dtype(args)

    cfg = ModelConfig(
        name="e2e-demo", family="dense", n_layers=args.layers,
        d_model=args.d_model, n_heads=args.d_model // 64, n_kv_heads=2,
        head_dim=64, d_ff=args.d_model * 3, vocab_size=args.vocab)
    print(f"params: {cfg.param_count() / 1e6:.1f}M")

    tcfg = TrainConfig(steps=args.steps, batch_size=args.batch_size,
                       seq_len=args.seq_len, lr=3e-3, warmup_steps=20,
                       checkpoint_every=100, log_every=25)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    print(f"corpus unigram entropy: {corpus.unigram_entropy():.3f} nats")

    state = trainer.init_state(cfg, tcfg, device=dev, dtype=dtype) \
        if params is None else trainer.state_for(params)
    start = ckpt.latest_step(args.ckpt_dir) or 0
    if start:
        state, start = ckpt.restore(args.ckpt_dir, state)
        print(f"resumed from checkpoint step {start}")
    mon = StragglerMonitor()
    t0 = time.perf_counter()
    state = trainer.train_loop(
        cfg, tcfg, state=state, step_fn=trainer.make_train_step(cfg, tcfg),
        batches=make_batches(corpus, tcfg.batch_size, tcfg.seq_len, start),
        start_step=start, ckpt_dir=args.ckpt_dir, straggler=mon,
        on_step=on_step)
    sync(dev)
    train_s = time.perf_counter() - t0
    steps_run = tcfg.steps - start
    print(f"trained {steps_run} steps in {train_s:.0f}s; "
          f"stragglers flagged: {len(mon.flags)}")

    # ---- post-training SALS calibration (paper §5.1) -----------------------
    sals = sals_for(cfg)
    projectors = calibrate(state["params"], cfg, sals, corpus,
                           n_sequences=16, seq_len=args.seq_len)
    print(f"SALS calibrated: rank {sals.rank(cfg.kv_dim)}/{cfg.kv_dim}, "
          f"U_r stored {dtype_name(projectors['u'].dtype)}; LatentKVCache "
          f"stores {cache_bytes_per_token(cfg, sals):.0f} B/token/layer "
          f"vs {4 * cfg.kv_dim} full")

    # ---- serve through the batched scheduler -------------------------------
    # "sals25-g2" runs the grouped decode layout (per-slab top-k + LSE
    # merge — what a sequence-sharded mesh runs), via the same fused path
    results, tok_s = {}, {}
    for name, proj, s, groups in (
            ("full", None, SALSConfig(enabled=False), 1),
            ("sals25", projectors, sals, 1),
            ("sals25-g2", projectors, sals, 2)):
        eng = ServeEngine(state["params"], proj, cfg,
                          ServeConfig(max_seq_len=2 * args.seq_len,
                                      max_batch=4, sals=s), n_groups=groups,
                          device=dev)
        sched = RequestScheduler(eng)
        for i in range(8):
            sched.submit(Request(corpus.batch(70_000 + i, 1, 64)["tokens"][0],
                                 max_new_tokens=24))
        t0 = time.perf_counter()
        done = sched.run()
        sync(dev)
        dt = time.perf_counter() - t0
        toks = sum(r.result.steps for r in done)
        results[name] = done
        tok_s[name] = toks / dt
        print(f"{name}: {toks} tokens in {dt:.1f}s -> {toks / dt:.1f} tok/s")

    agreement = {}
    for name in ("sals25", "sals25-g2"):
        agreement[name] = float(np.mean([
            np.mean(a.result.tokens == b.result.tokens)
            for a, b in zip(results["full"], results[name])]))
        print(f"greedy token agreement ({name} vs full): "
              f"{agreement[name]:.1%}")
    return {"state": state, "train_s": train_s, "steps_run": steps_run,
            "stragglers": len(mon.flags),
            "calibration_s": projectors["seconds"],
            "tokens": {k: [r.result.tokens.tolist() for r in v]
                       for k, v in results.items()},
            "requests_done": {k: len(v) for k, v in results.items()},
            "tok_s": tok_s, "agreement": agreement}


if __name__ == "__main__":
    main()
