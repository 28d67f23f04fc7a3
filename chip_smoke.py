#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SALS on one NVIDIA card and check it.

    python3 chip_smoke.py            # every phase (needs one CUDA card)

Phases, each printing one JSON line:

1. device   — the card, as ``nvidia-smi`` reports its name and power limit;
2. build    — nvcc builds ``src/repro_torch/csrc/*.cu`` into ``build/``;
3. kernels  — each CUDA kernel against its plain PyTorch twin on the card,
              at the llama2-7b slice shapes, a GQA case at mistral-7b
              widths and an int4-value case: max error against a stated
              tolerance, median kernel / twin / library times, and the
              least time the card could take (``bound_ms``);
4. serve    — seeded paper-llama2-7b at full width and depth (bf16):
              calibrate U_r on the synthetic corpus, then
              ``ServeEngine.generate`` for 4 ragged prompts (4096, 3584,
              3072, 2560 tokens) x 32 new tokens with SALS-25% and with
              SALS disabled; launch counters are zeroed just before each
              run and read just after;
5. whole    — a full-width 2-layer model (SALS on layer 1) decoded on the
              card (kernels) and on the CPU (twins) from the same weights
              and a 1024-token prompt (so top-k really selects), per-step
              logits compared under teacher forcing.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero; it also exits non-zero without a CUDA card, and
outside a checkout of the repository (it imports ``src/repro_torch``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM data-sheet peaks (dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

PHASES = ("device", "build", "kernels", "serve", "whole")
# "profile" (not run by default) adds a torch.profiler pass over three
# decode steps of each serve run; tables go to chiprun_out/


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int, warmup: int = 2, flush=None) -> float:
    """Median CUDA-event time of ``fn`` (ms), L2 flushed before each run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: kernels vs twins
# ---------------------------------------------------------------------------

def topk_case(torch, name, b, s, r, r_star, n_c, k_dtype, seed, flush):
    """latent_topk at a main-path shape.  Integer-valued latents and query
    make every score exact in f32 (ties included), so indices must match
    the twin exactly — tie-breaks too."""
    from repro_torch.kernels import latent_score as ls
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q_lat = torch.randint(-3, 4, (b, r_star), generator=g, device=dev).float()
    k_scale = None
    if k_dtype == "int8":
        k_lat = torch.randint(-3, 4, (b, s, r), generator=g, device=dev,
                              dtype=torch.int8)
        k_scale = torch.full((b, s), 0.5, device=dev, dtype=torch.bfloat16)
    else:
        k_lat = torch.randint(-3, 4, (b, s, r), generator=g,
                              device=dev).to(torch.bfloat16)
    # ragged decode positions as on the main path's last step
    pos = torch.tensor([s - 65 - 512 * i for i in range(b)], device=dev,
                       dtype=torch.int32).clamp_min(1)
    kw = dict(n_critical=n_c, n_sink=16, n_recent=64)
    idx_k, val_k = ls.latent_topk_cuda(q_lat, k_lat, k_scale, pos, **kw)
    idx_t, val_t = ref.latent_topk_ref(q_lat, k_lat, k_scale, pos, **kw)
    torch.cuda.synchronize()
    scores = ref.latent_score_ref(q_lat, k_lat, k_scale)
    sel_k = torch.gather(scores, 1, idx_k.long().clamp(0, s - 1))
    sel_t = torch.gather(scores, 1, idx_t.long().clamp(0, s - 1))
    err = float(((sel_k - sel_t).abs() * val_t).max())
    exact = bool(torch.equal(val_k, val_t)) and bool(
        torch.equal(torch.where(val_t, idx_k, 0), torch.where(val_t, idx_t, 0)))
    kern_ms = time_ms(torch, lambda: ls.latent_topk_cuda(
        q_lat, k_lat, k_scale, pos, **kw), 20, flush=flush)
    plain_ms = time_ms(torch, lambda: ref.latent_topk_ref(
        q_lat, k_lat, k_scale, pos, **kw), 5, flush=flush)
    kb = k_lat.element_size()
    nbytes = b * r_star * 4 + b * s * r_star * kb + 2 * b * 4 \
        + b * n_c * 5 + (b * s * 2 if k_scale is not None else 0)
    b_ms, b_by = bound(nbytes, 2.0 * b * s * r_star, F32_FLOP_PER_S)
    return dict(case=name, exact_idx=exact, max_abs_err=err, tol=0.0,
                ms=kern_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by,
                ok=exact and err <= 0.0)


def sra_case(torch, name, b, h, n_kv, dh, s, r, n_c, k_dtype, v_bits,
             softcap, seed, flush):
    """sparse_recon_attention on selected sets shaped like the main path's
    (ascending valid indices, invalid slots last; one all-invalid row)."""
    from repro_torch.core import quantization as qz
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_recon_attention as sra
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    kvd = n_kv * dh
    q = torch.randn((b, h, dh), generator=g, device=dev).to(torch.bfloat16)
    lat = torch.randn((b, s, r), generator=g, device=dev)
    k_scale = None
    if k_dtype == "int8":
        k_lat, k_scale = qz.quantize_latent_int8(lat)
    else:
        k_lat = lat.to(torch.bfloat16)
    vq = qz.quantize(torch.randn((b, s, kvd), generator=g, device=dev),
                     v_bits, 64)
    u = (torch.randn((kvd, r), generator=g, device=dev)
         * r ** -0.5).to(torch.bfloat16)
    idx = torch.zeros((b, n_c), dtype=torch.int32, device=dev)
    valid = torch.zeros((b, n_c), dtype=torch.bool, device=dev)
    n_valid = [n_c, n_c, n_c // 3, 0][:b] + [n_c] * max(0, b - 4)
    for i in range(b):
        perm = torch.randperm(s - 80, generator=g, device=dev)[:n_valid[i]]
        idx[i, :n_valid[i]] = torch.sort(perm + 16).values.int()
        idx[i, n_valid[i]:] = torch.randint(0, s, (n_c - n_valid[i],),
                                            generator=g, device=dev).int()
        valid[i, :n_valid[i]] = True
    q_pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    args = (q, k_lat, k_scale, vq["q"], vq["scale"], vq["zero"], u, idx,
            valid, q_pos)
    kw = dict(n_kv=n_kv, v_bits=v_bits, v_group=64, theta=10_000.0,
              softcap=softcap)
    m_k, l_k, o_k = sra.sparse_recon_attention_cuda(*args, **kw)
    m_t, l_t, o_t = ref.sparse_recon_attention_fused_ref(*args, **kw)
    torch.cuda.synchronize()
    live = l_t > 0
    err = max(float((m_k - m_t)[live].abs().max()),
              float(((l_k - l_t) / l_t.clamp_min(1.0))[live].abs().max()),
              float((o_k / l_k.clamp_min(1e-30)[..., None]
                     - o_t / l_t.clamp_min(1e-30)[..., None])[live].abs().max()))
    dead = ~live
    dead_ok = bool((m_k[dead] == ref.NEG_INF).all() and (l_k[dead] == 0).all()
                   and (o_k[dead] == 0).all() and torch.isfinite(o_k).all())
    tol = 2e-3
    kern_ms = time_ms(torch, lambda: sra.sparse_recon_attention_cuda(
        *args, **kw), 10, flush=flush)
    plain_ms = time_ms(torch, lambda: ref.sparse_recon_attention_fused_ref(
        *args, **kw), 5, flush=flush)
    nv = int(valid.sum())
    code_w = kvd if v_bits == 8 else kvd // 2
    row_bytes = r * k_lat.element_size() + (2 if k_scale is not None else 0) \
        + code_w + 2 * 2 * (kvd // 64)
    nbytes = q.numel() * 2 + nv * row_bytes + u.numel() * 2 \
        + b * n_c * 5 + b * 4 + b * h * (2 + dh) * 4
    flops = 2.0 * nv * kvd * r + 4.0 * nv * (h // n_kv) * kvd
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    return dict(case=name, max_abs_err=err, tol=tol, all_invalid_row_ok=dead_ok,
                ms=kern_ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, ok=err <= tol and dead_ok)


# Flash output check: per (b, q, h) row, the largest |kernel - f32 twin|
# over dh over the row's largest |f32 twin|, against 2 bf16 ulps.  Scaling
# by the row keeps long rows (|o| ~ 0.03 at S=4096) as strict as short ones.
FLASH_TOL = 2.0 ** -7


def row_rel_err(out, ref) -> float:
    diff = (out.float() - ref).abs().amax(-1)
    return float((diff / ref.abs().amax(-1).clamp_min(1e-30)).max())


def flash_case(torch, name, b, sq, sk, h, hkv, dh, softcap, seed, flush):
    """flash_attention against the twin run in f32 on the same bf16 inputs.
    Two planted faults on the longest quarter of the rows (one 64-key tile
    dropped, the logit scale off by 1%) must fail the same check."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, h, dh), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b, sk, hkv, dh), generator=g, device=dev) \
        .to(torch.bfloat16)
    v = torch.randn((b, sk, hkv, dh), generator=g, device=dev) \
        .to(torch.bfloat16)
    out_k = fa.flash_attention_cuda(q, k, v, causal=True, softcap=softcap)
    q32, k32, v32 = q.float(), k.float(), v.float()
    out_t = ref.attention_ref(q32, k32, v32, causal=True, softcap=softcap)
    err = row_rel_err(out_k, out_t)
    long_rows = slice(sq - sq // 4, sq)
    tile = sk // 2 // 64 * 64
    keep = torch.ones((1, sq, sk), dtype=torch.bool, device=dev)
    keep[0, long_rows, tile:tile + 64] = False
    planted = {
        "skip_kv_tile": ref.attention_ref(q32, k32, v32, causal=True,
                                          softcap=softcap, mask=keep),
        "scale_1pct": ref.attention_ref(q32 * 1.01, k32, v32, causal=True,
                                        softcap=softcap),
    }
    fault_err = {f: row_rel_err(o.to(torch.bfloat16)[:, long_rows],
                                out_t[:, long_rows])
                 for f, o in planted.items()}
    long_err = row_rel_err(out_k[:, long_rows], out_t[:, long_rows])
    abs_err = float((out_k.float() - out_t).abs().max())
    del planted, keep, out_t
    torch.cuda.synchronize()
    kern_ms = time_ms(torch, lambda: fa.flash_attention_cuda(
        q, k, v, causal=True, softcap=softcap), 5, flush=flush)
    plain_ms = time_ms(torch, lambda: ref.attention_ref(
        q, k, v, causal=True, softcap=softcap), 2, warmup=1, flush=flush)
    library_ms = None
    if not softcap:
        # the library call takes (B, H, S, dh); GQA K/V are expanded first
        qt, kt, vt = (torch.repeat_interleave(x, h // x.shape[2], dim=2)
                      .transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None
        if sq != sk:    # decode-style alignment: the library's is_causal
            mask = (torch.arange(sq, device=dev)[:, None] + (sk - sq)
                    >= torch.arange(sk, device=dev)[None, :])
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None), 5,
            flush=flush)
    q_off = sk - sq
    pairs = sum(min(sk, q_off + i + 1) for i in range(sq))
    flops = 4.0 * b * h * dh * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    faults_caught = all(e > FLASH_TOL for e in fault_err.values())
    return dict(case=name, max_abs_err=abs_err, max_row_rel_err=err,
                long_rows_rel_err=long_err, tol=FLASH_TOL,
                planted_fault_rel_err=fault_err, faults_caught=faults_caught,
                ms=kern_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by,
                ok=err <= FLASH_TOL and faults_caught)


def phase_kernels(torch):
    flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device="cuda")
    res = {
        "latent_topk": [
            topk_case(torch, "llama2-7b B4 S4160 r1024 r*512 bf16", 4, 4160,
                      1024, 512, 432, "bf16", 1, flush),
            topk_case(torch, "mistral-7b GQA r256 r*128 int8", 4, 4160, 256,
                      128, 432, "int8", 2, flush),
        ],
        "sparse_recon_attention": [
            sra_case(torch, "llama2-7b B4 H32 S4160 r1024 int8-V", 4, 32, 32,
                     128, 4160, 1024, 432, "bf16", 8, 0.0, 3, flush),
            sra_case(torch, "mistral-7b GQA n_kv8 r256 int8-lat", 4, 32, 8,
                     128, 4160, 256, 432, "int8", 8, 0.0, 4, flush),
            sra_case(torch, "llama2-7b int4-V softcap30", 4, 32, 32, 128,
                     4160, 1024, 432, "bf16", 4, 30.0, 5, flush),
        ],
        "flash_attention": [
            flash_case(torch, "llama2-7b B4 S4096 H32", 4, 4096, 4096, 32,
                       32, 128, 0.0, 6, flush),
            flash_case(torch, "mistral-7b GQA B2 S2048 Hkv8", 2, 2048, 2048,
                       32, 8, 128, 0.0, 7, flush),
            flash_case(torch, "Sq1000<Sk3000 softcap50", 1, 1000, 3000, 32,
                       32, 128, 50.0, 8, flush),
        ],
    }
    for name, cases in res.items():
        for c in cases:
            emit({"phase": "kernels", "kernel": name, **c})
    bad = [(n, c["case"]) for n, cs in res.items() for c in cs if not c["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their twins: {bad}")
    return res


# ---------------------------------------------------------------------------
# phase 4: the serving main path
# ---------------------------------------------------------------------------

def profile_decode(torch, params, proj, cfg, sals, prompts, name,
                   steps: int = 3):
    """torch.profiler over a few steady decode steps (after prefill and one
    warm step): device time by kernel, and the device's busy share of the
    window.  The full table goes to chiprun_out/."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tf
    b = len(prompts)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device="cuda")
    toks = np.zeros((b, max(len(p) for p in prompts)), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    with torch.inference_mode():
        logits, cache = tf.prefill(params, proj, cfg, sals,
                                   {"tokens": torch.as_tensor(toks,
                                                              device="cuda")},
                                   4160, lengths=lens)
        tok = logits.argmax(-1).int()
        logits, cache = tf.decode_step(params, proj, cache, tok, lens, cfg,
                                       sals)
        tok = logits.argmax(-1).int()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(steps):
                logits, cache = tf.decode_step(params, proj, cache, tok,
                                               lens + 1 + t, cfg, sals)
                tok = logits.argmax(-1).int()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    ka = prof.key_averages()
    # device-side kernel events only (operator rows repeat their kernels)
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)
    (OUT_DIR / f"profile_decode_{name}.txt").write_text(ka.table(
        sort_by="self_device_time_total", row_limit=40))
    emit({"phase": "profile", "run": name, "steps": steps,
          "wall_ms_per_step": 1e3 * wall / steps,
          "device_ms_per_step": dev_us / 1e3 / steps,
          "device_busy_share": dev_us / 1e6 / wall,
          "top_device_ms_per_step": [
              [e.key[:70], e.self_device_time_total / 1e3 / steps,
               e.count / steps] for e in top[:10]]})
    del cache


def phase_serve(torch, n_new: int = 32, prof: bool = False):
    from repro_torch.config import SALSConfig, ServeConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import calibrate
    from repro_torch.models.transformer import init_params, segment_plan
    from repro_torch.serve import ServeEngine

    cfg = get_config("paper-llama2-7b")
    sals = SALSConfig()                    # SALS-25% at the paper defaults
    t0 = time.perf_counter()
    params = init_params(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    proj = calibrate(params, cfg, sals, corpus, n_sequences=16, seq_len=512)
    lens = [4096, 3584, 3072, 2560]
    prompts = [corpus.batch(100 + i, 1, n)["tokens"][0]
               for i, n in enumerate(lens)]
    n_sals = sum(i1 - i0 for i0, i1, m in segment_plan(cfg, sals)
                 if m == "sals")
    runs = {}
    for name, sc in (("sals", sals), ("full", SALSConfig(enabled=False))):
        eng = ServeEngine(params, proj, cfg, ServeConfig(
            max_seq_len=4160, max_batch=4, sals=sc), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out = eng.generate(prompts, max_new_tokens=n_new)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        timing = eng.last_timing
        toks = np.stack([r.tokens for r in out])
        steps = timing["decode_steps"]
        row = dict(phase="serve", run=name, prompts=lens, new_tokens=n_new,
                   prefill_s=timing["prefill_s"],
                   decode_tok_s=len(lens) * steps / timing["decode_s"],
                   decode_ms_per_step=1e3 * timing["decode_s"] / steps,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   launches=counts, decode_steps=steps)
        if not (toks.shape == (4, n_new) and (toks >= 0).all()
                and (toks < cfg.vocab_size).all()):
            raise AssertionError(f"{name}: generated tokens out of range")
        want_sals = n_sals * steps if name == "sals" else 0
        if counts["latent_topk"] != want_sals or \
                counts["sparse_recon_attention"] != want_sals:
            raise AssertionError(f"{name}: SALS kernel launches {counts}, "
                                 f"expected {want_sals} each")
        if counts["flash_attention"] < cfg.n_layers:
            raise AssertionError(f"{name}: prefill launched flash "
                                 f"{counts['flash_attention']} times")
        runs[name] = (row, toks)
        if prof:
            profile_decode(torch, params, proj, cfg, eng.sals, prompts, name)
        del eng, out
        torch.cuda.empty_cache()
    agree = float((runs["sals"][1] == runs["full"][1]).mean())
    for name, (row, _) in runs.items():
        row["token_agreement_vs_full"] = agree
        emit(row)
    emit({"phase": "serve", "init_params_s": init_s,
          "calibration_s": proj["seconds"], "sals_layers": n_sals})
    counts = runs["sals"][0]["launches"]
    del params, proj
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 5: whole path, card vs CPU
# ---------------------------------------------------------------------------

def phase_whole(torch, n_new: int = 12, prompt_len: int = 1024):
    """The prompt is longer than n_sink + n_recent + N_c, so latent_topk
    picks N_c of ~945 selectable tokens at every step and a ranking that
    differs between kernel and twin shows in the logits."""
    from repro_torch.config import SALSConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.serve import calibrate
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_config("paper-llama2-7b"), n_layers=2)
    sals = SALSConfig(skip_layers_front=1, skip_layers_back=0)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=1)
    p_gpu = tf.init_params(cfg, device="cuda", seed=1)
    proj = calibrate(p_gpu, cfg, sals, corpus, n_sequences=8, seq_len=512)
    p_cpu = tf.Transformer(cfg, device="cpu")
    p_cpu.load_state_dict(p_gpu.state_dict())
    u = {"gpu": {"u": proj["u"]}, "cpu": {"u": proj["u"].cpu()}}
    selectable = prompt_len - sals.n_recent - sals.n_sink + 1
    if selectable <= sals.n_critical:
        raise AssertionError("whole-path prompt too short to select")
    prompt = corpus.batch(7, 1, prompt_len)["tokens"]
    max_seq = prompt_len + 16
    logits = {}
    tokens = None
    with torch.inference_mode():
        for dev_name, params, device in (("gpu", p_gpu, "cuda"),
                                         ("cpu", p_cpu, "cpu")):
            t0 = time.perf_counter()
            lens = torch.tensor([prompt_len], dtype=torch.int32,
                                device=device)
            lg, cache = tf.prefill(params, u[dev_name], cfg, sals,
                                   {"tokens": torch.as_tensor(
                                       prompt, device=device)},
                                   max_seq, lengths=lens)
            steps = [lg.float().cpu()]
            if tokens is None:      # teacher forcing: the card's greedy ids
                tokens = [int(lg.argmax(-1))]
            for t in range(n_new - 1):
                tok = torch.tensor([tokens[t]], dtype=torch.int32,
                                   device=device)
                lg, cache = tf.decode_step(params, u[dev_name], cache, tok,
                                           lens + t, cfg, sals)
                steps.append(lg.float().cpu())
                if dev_name == "gpu":
                    tokens.append(int(lg.argmax(-1)))
            logits[dev_name] = torch.cat(steps)
            emit({"phase": "whole", "device": dev_name,
                  "seconds": time.perf_counter() - t0})
    diff = (logits["gpu"] - logits["cpu"]).abs().max(dim=-1).values
    scale = logits["cpu"].abs().max(dim=-1).values
    rel = (diff / scale).tolist()
    greedy_cpu = logits["cpu"].argmax(-1).tolist()
    tol = 0.05   # bf16 through two layers, two devices' summation orders
    row = dict(phase="whole", prompt_len=prompt_len, steps=n_new,
               selectable_first_step=selectable, n_critical=sals.n_critical,
               max_rel_logit_err_per_step=rel, tol=tol,
               greedy_agreement=float(np.mean(
                   [a == b for a, b in zip(tokens, greedy_cpu)])),
               finite=bool(torch.isfinite(logits["gpu"]).all()))
    emit(row)
    if not row["finite"] or max(rel) > tol:
        raise AssertionError("card and CPU disagree on the whole path")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (add 'profile' for a decode profile)")
    phases = ap.parse_args().phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build   # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(8)
    OUT_DIR.mkdir(exist_ok=True)
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds})
    (OUT_DIR / "build.log").write_text(_build.build_log)

    kern = phase_kernels(torch) if "kernels" in phases else {}
    counts = phase_serve(torch, prof="profile" in phases) \
        if "serve" in phases else {}
    if "whole" in phases:
        phase_whole(torch)

    replaces = {
        "latent_topk": ("src/repro_torch/csrc/latent_topk.cu",
                        "src/repro/kernels/latent_score.py:374"),
        "sparse_recon_attention": (
            "src/repro_torch/csrc/sparse_recon_attention.cu",
            "src/repro/kernels/sparse_recon_attention.py:747"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:93"),
    }
    rows = []
    for name, (src, rep) in replaces.items():
        main_case = kern[name][0] if name in kern else {}
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": counts.get(name),
                     "max_abs_err": main_case.get("max_abs_err"),
                     "ms": main_case.get("ms"),
                     "plain_ms": main_case.get("plain_ms"),
                     "bound_ms": main_case.get("bound_ms"),
                     "bound_by": main_case.get("bound_by"),
                     "library_ms": main_case.get("library_ms")})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
