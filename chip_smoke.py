#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SALS on one NVIDIA card and check it.

    python3 chip_smoke.py            # every phase (needs one CUDA card)

Phases, each printing one JSON line:

1. device   — the card, as ``nvidia-smi`` reports its name and power limit;
2. build    — nvcc builds ``src/repro_torch/csrc/*.cu`` into ``build/``
              (registers, shared memory and spills of the flash forward
              and backward and the recon kernels as ``-Xptxas -v``
              reports them);
3. kernels  — each CUDA kernel against its plain PyTorch twin on the card,
              at the llama2-7b slice shapes, a GQA case at mistral-7b
              widths and an int4-value case (flash also at dh 64 and
              non-causal; the recon body also with f32 latents and with an
              f32 ``u`` beside int8 latents): max error against a
              stated tolerance, median kernel / twin / library times of
              one eager call (``ms``; the kernels and the library call
              also as CUDA-graph replays, ``graph_ms``, timed in turns with
              the eager call; the top-k's score pass and selection also
              alone), the least time the card could take (``bound_ms``) and
              the share of it or of the peak that the replay reached.  The
              top-k also runs adversarial cases (all scores equal, fewer
              selectable rows than N_c, S < N_c, B 1, r* 500, rows loaded
              element by element, a tiered score pool, pos_base, S > 8192,
              N_c 20 and 1000) for exact indices and validity.  The paged
              kernels run over a shuffled page table whose unmapped tail
              holds ids outside the pool (pages of 8, 16 and 64 tokens),
              and must also equal the dense kernels bit for bit on the
              same logical contents; the dense kernel is timed there too,
              in turns with the paged one (paged, dense, dense, paged), so
              paged and dense cost compare at one shape.  The verify-window
              kernels (Q = 1, 2, 4, 8; dense and paged) must also equal the
              single-token kernel bit for bit at Q = 1 and, query by query,
              on each query's gated set; ``latent_score``'s scores, masked
              and stable-sorted, must give ``latent_topk``'s indices.  The
              recon and window kernels also run one slab of the grouped
              fold (``pos_base`` != 0), and the grouped fold itself runs
              rows 1 and 2 at G 4 (B 4 -> 16 rows of S/4, k_loc 108) at
              llama2-7b's and paligemma-3b's shapes: exact indices, the
              recon within tolerance, empty slabs exact no-ops, the merge
              against the twins', and at 64-token pages the paged fold
              equal to the dense fold bit for bit (timed in turns);
              rows 1, 2, 4-7 also at the families' shapes (hymba-1.5b:
              25 heads over 5, dh 64, r 80, r* 40; llama4-scout: 40 over
              8, r 256; qwen3-moe: 64 over 4, r 128) and flash at 25 / 5
              heads dh 64 and 64 / 4 heads dh 128, and at hubert-xlarge's
              B 8 S 1024 16 heads dh 80 non-causal; the flash backward
              (D pass, dK/dV and dQ kernels) against ``attention_bwd_ref``
              at qwen2-1.5b's training shape, llama2-7b's, dh 64 at 25 / 5
              heads, dh 256 prefix-LM at 8 / 1, softcap, Sq < Sk, and
              non-causal dh 80 at hubert's shape and ragged (B 2 S 1000):
              relative error of dq, dk, dv within 1e-2 of each tensor's
              max, two planted faults caught, two runs bitwise equal, the
              library backward timed in turns, and the forward with its
              LSE output in turns with the plain forward (O bitwise
              equal, LSE within 1e-5 of the twin's);
4. serve    — seeded paper-llama2-7b at full width and depth (bf16):
              calibrate U_r on the synthetic corpus, then
              ``ServeEngine.generate`` for 4 ragged prompts (4096, 3584,
              3072, 2560 tokens) x 32 new tokens with SALS-25% and with
              SALS disabled; launch counters are zeroed just before each
              run and read just after.  Its decode steps replay the
              engine's step program (a CUDA graph); then the same prompts
              are decoded in turns — eager (``tf.decode_step`` called
              directly), graph (``ServeEngine.decode``), graph, eager —
              and every step's logits, the tokens and the launch counts
              must equal the eager ones bit for bit; ms per step of each
              turn, capture time, graph nodes, peak memory;
5. sched    — the same model and U_r through ``RequestScheduler``
              (continuous batching, 64-token chunked prefill, 4 slots): 8
              requests sharing a 512-token system prompt (4000 ... 640
              tokens) x 32 new tokens, once on the paged latent cache
              (64-token pages, prefix sharing) and once on the dense slot
              arena; tokens must match, each replayed step of the dense
              run must equal the eager step on a copy of the arena (logits
              and arena bitwise), and each run must have launched only its
              layout's SALS kernels, once per SALS layer and decode step;
              each run captures the chunked-prefill program once (a CUDA
              graph over the engine's prefill workspace) and replays it
              for every other chunk, and every chunk of the dense run's
              first request and of the paged run's first resumed request
              must equal the eager chunk on a copy of the workspace
              (logits, cache and scratch bitwise); the chunked-prefill
              share of the wall time, the replayed chunks' median ms;
              then one request's chunks in turns eager / replayed /
              replayed / eager (median ms, peak memory, logits equal);
6. tier     — the sched traffic, paged, through the TWO-TIER pool,
              keeping every prompt's prefix entry: once with a hot tier as
              large as the pool (it measures each step's touched pages and
              the peak of live pages), then with a hot tier of the largest
              touched set + a write page per slot + 1 (+ 2 first, and the
              smallest size only if that never spills), below that peak.
              Tokens must equal the untiered paged run's, with zero
              evictions and a clean audit, and the small tier must spill
              and miss; spills, fetches, prefetch hits, reruns, PCIe bytes,
              wall time, device memory, the chunk program's one capture;
7. quality  — (run right after ``serve``) ``metrics.overlap_score``
              for all 32 layers at position 4095 of two
              4096-token prompts (one ``latent_score`` launch per layer and
              prompt, nothing else), each layer's kernel scores against the
              twin, and the effective rank of the keys before / after RoPE
              and ``latent_mse`` on four layers.  Random weights: not the
              paper's numbers;
8. spec     — speculative decode (verify window of 4) on the same weights
              and U_r: (a) 4 prompts of 300-420 tokens from a repeated
              base, where N_c covers every selectable position, through
              ``generate`` and ``generate_speculative`` in bf16: token
              agreement, the window's logits against teacher-forced decode
              steps slot by slot, and two controls of the card's
              shape-dependent bf16 rounding; (c) 8 requests sharing a
              256-token system prompt (also saturated) through the
              scheduler in float32, paged (64-token pages, prefix sharing)
              and dense: tokens must equal the sequential scheduler's (run
              eagerly, chunked prefill included), and each run must
              launch one window kernel and one top-k of its layout per
              SALS layer and round, and no single-token recon; (b) the
              serve phase's prompts in bf16: rounds, acceptance, tokens
              per round, ms per round replayed and eager, beside the
              sequential decode; (a) and (b) must
              also give the eager ``generate_speculative``'s tokens;
9. slo      — the scheduler's SLO half on the same weights and U_r (4
              slots, 64-token chunks, budget 512, audited every step): four
              priority-0 requests of 1,536 tokens, then, once all four
              decode, two priority-1 requests of 512 (32 new tokens each),
              through (a) one class on 64-token pages (the gold tokens),
              (b) park, (c) evict, (d) park on a two-tier pool below the
              peak of live pages, (e) evict on the dense arena: tokens
              equal (a)'s, park resumes every victim with no re-prefill
              (24 chunks each), evict re-prefills, (d) spills parked pages
              cold and pins none, one decode and one chunk capture a run,
              only the layout's SALS kernels; the interactive requests'
              wait, park / resume ms and bytes, evict's re-prefill s.  Then
              temperature sampling: ``generate`` at T 0.7 reproducible per
              seed, ``_sample`` over 65,536 rows against softmax(l / T) by
              a chi-square test, T 0 equal to the plain argmax;
10. obs     — telemetry (``repro_torch.obs``) on the same weights and U_r:
              (a) the sched traffic on 64-token pages (audited every
              step) in turns with telemetry off / on / on / off, the "on"
              runs with the registry, the tracer and the byte accountant:
              tokens equal across the four runs (and the sched phase's),
              zero drift with every decode step reconciled, spans
              balanced with no open track (the Chrome trace validates and
              goes to ``chiprun_out/``), both metric exports valid,
              submitted == done + failures + timeouts + cancellations, one
              decode and one chunk capture a run, each run's paged SALS
              launches once per SALS layer and step, and equal counts of
              synchronizing CUDA calls (``torch.cuda.set_sync_debug_mode``
              "warn") with telemetry off and on; each run's wall time,
              the median span times, and the step programs' own medians
              (host ms in stage / key / launch, device ms a replay); (b)
              the slo phase's run (d), park on a two-tier pool below the
              peak of live pages, with the accountant on: measured fetch,
              spill and park-spill bytes equal to the ledger's, tokens
              equal (a)'s of the slo phase; (c) what the step programs'
              always-on counters cost a call, from their own calls' µs,
              and a small step program's calls all recorded;
11. grouped — the grouped selection layout (``n_groups``) on the serve
              phase's model cut to its first 8 layers (5 SALS layers;
              ``depth_view``, no copy): (1) ``generate`` at G 1, 2, 4, 8 on the serve
              prompts (16 new tokens), replayed and eager in turns (logits
              bitwise equal), rows 1 and 2 once per SALS layer and step,
              ms per step, ten replays back to back, the kernels' device
              ms; (2) ``RequestScheduler`` at G 4 (4 requests sharing a
              512-token system prompt, 1536 ... 768 tokens, max_seq_len
              4096) paged (64-token pages), dense and two-tier, with the
              byte accountant on (0 drifts, every step reconciled): tokens
              paged == dense and two-tier == untiered, one decode capture,
              only the layout's SALS kernels, audit clean; (3) the Q 4
              verify window through the scheduler, paged == dense tokens,
              one window kernel and top-k per SALS layer and round; (4)
              ``mode="static"``, 8 requests in batches of 4: tokens equal
              ``generate`` on the same batches;
12. mesh    — the sharding layer (``distributed/sharding.py``,
              ``launch/specs.py``) at world 1: a one-rank NCCL process
              group on a file store and a (1, 1) ("data", "model")
              ``DeviceMesh`` on the card.  (a) ``build_train``'s step on
              qwen2-1.5b at full width and depth (B 4 x S 4096, block
              remat, 3 steps) from the plain step's initial state: per-step
              losses within 1e-5 relative of ``make_train_step``'s, 56 + 28
              flash launches a step, the max parameter delta, ms a step
              and peak memory of both; (b) ``build_prefill`` +
              ``build_decode`` (eager) on paper-llama2-7b at full width
              and depth with ``sals_for_shape``'s SALS-25% at
              ShapeConfig("d4k", "decode", 4096, 4): 32 greedy tokens of 4
              prompts equal to ``ServeEngine.generate``'s from the same
              weights and U_r, in both ``dist_mode``s, rows 1 and 2 once
              per SALS layer and step, ms a step; (c) the shard-local slab
              body (``sparse_attention.shard_partials``) once per slab as
              rank r of G would call it, at the grouped phase's llama2
              shape for G 2 and 4: (m, l, o) bitwise equal to the fold's.
              The group is destroyed and the memory freed after it;
13. pipe    — GPipe (``distributed/pipeline.py``) at P = 1 over the same
              world-1 NCCL group (one card holds one stage; multi-stage
              runs are held on CPU ranks by the tests): qwen2-1.5b at full
              width and depth, bf16, 4 microbatches of B 1 x S 4096,
              blocks under block remat, against the plain path's mean
              ``forward_loss`` and its gradients (loss within 1e-5
              relative, every gradient within 1e-2 of its max); flash
              launches a step, ms a step, peak memory, the bubble fraction;
14. roofline — ``analysis.analyze_step`` over the plain qwen2-1.5b train
              step (B 4 x S 4096, block remat) and the serve model's
              SALS-25% decode step at the serve phase's shape: per-device
              flops, bytes, the three roofline terms on the H100 constants
              (``analysis/roofline.py``), the bound and its share, then
              each step timed without the counter over the bound;
15. dryrun  — ``python -m repro_torch.launch.dryrun --arch qwen2-1.5b
              --shape decode_32k`` with no CUDA device visible (a fake
              256-rank process group, meta tensors): status ``ok``;
16. vlm     — seeded paligemma-3b at full width (18 layers, d 2048, MQA
              with head_dim 256, vocab 257,216; bf16), SALS-25% (r 64, r*
              32, 15 SALS layers), U_r calibrated on tokens: (a) prefill of
              4 rows of 256 patch embeddings + 3840 ... 2304 tokens through
              the flash kernel's prefix-LM mask at dh 256, then 32 greedy
              decode steps, SALS on and off, the prefill's logits held
              against the same prefill with the twin's attention on the
              card; (b) ``ServeEngine.generate`` on tokens only at the
              serve phase's prompts, replayed and eager in turns, as the
              serve phase, and at G 4 as the grouped phase's (1); (c)
              ``RequestScheduler``, 4 requests on 64-token pages and on the
              dense arena (tokens equal); every path's launch counts;
17. families — the moe, hybrid and ssm families at full width, bf16,
              seeded, SALS-25% at the defaults where the family has
              attention (U_r calibrated on the synthetic corpus): (a)
              hymba-1.5b at full depth (32 layers, 29 SALS): ``generate``
              on a uniform-length batch (1280 ... 2048 tokens, left-
              filled) x 32, SALS on and off, replayed then eager (tokens
              and launch counts equal, one decode capture a call), the
              scheduler falling back to static (tokens == ``generate``'s),
              a paged cache and a verify window refused; (b) rwkv6-7b at
              full depth: the same on 4 x 1024 tokens (no attention, no
              kernel), its prefill profiled on 64-token prompts; (c)
              llama4-scout-17b-a16e with its depth cut to 13 of 48
              layers (10 SALS) and (d) qwen3-moe-235b-a22b cut to 12 of
              94 (9 SALS), so that their weights fit on the card: the
              serve phase's checks on the serve prompts, then the
              scheduler (4 requests, 1024 ... 640 tokens x 16, 64-token
              chunks) paged == dense, and for llama4 the verify window of
              4 paged == dense.  Each model: parameter bytes, peak memory,
              prefill s, replayed and eager ms a step, launches of rows
              1-7 a step, a profiled replayed step by kernel and the share
              of it that the MoE layers or the recurrences take (one
              layer's call captured alone at the step's shapes, times the
              layers); (e) on the mesh phase's world-1 NCCL group and
              (1, 1) mesh: each of (a)-(d) served through
              ``build_prefill`` + ``build_decode`` (eager, both
              ``dist_mode``s) on 4 prompts of 1024 tokens x 16 greedy
              tokens (a 1056-token cache), tokens equal to its
              ``generate``'s from the same weights, U_r and
              ``sals_for_shape``'s SALS, ms a step and the launches of rows
              1-3; then two ``build_train`` steps against the plain
              ``make_train_step`` from the same seeded state (bf16
              weights, f32 master, the full config's moment dtype) for
              hymba-1.5b at full depth (B 4 x S 64), llama4-scout at 1 of
              48 layers and vocabulary 32,768 under ``tp_sp`` and
              ``ep_dp`` (B 2 x S 512) and rwkv6-7b at 4 of 32 layers (B 2 x
              S 128): the first step's loss within 1e-5 relative, which
              parameters are equal bit for bit after the second (and the
              largest difference of the rest), the second step's ms, peak
              memory, 2 flash forward + 1 backward launches a layer and
              step;
18. train   — qwen2-1.5b at full width and depth (bf16 weights, f32
              master and moments, seed 0) through the launcher's
              functions (``trainer.init_state``, ``make_train_step``,
              ``train_loop`` over the corpus's batches): (a) B 4 x S 4096,
              block remat, 20 steps at lr 3e-4 (warmup 5): loss, ce, grad
              norm, lr and ms a step, tokens/s, peak memory, and 2 flash
              forward + 1 backward launches a layer and step; the loss
              must fall; (e) a profiled step of (a); (b) B 4 x S 2048
              without remat, 3 steps; (c) 2 layers at full width, S 1024:
              loss and gradients through the kernels against the twins'
              attention on the card (loss within 1e-2, every gradient's
              cosine >= 0.99); (d) the reduced config at head_dim 64
              through ``run_with_restarts`` with a fault after the first
              checkpoint: losses equal to an uninterrupted run's bit for
              bit; (g) ``launch.serve.main`` on the card with its defaults
              (``--arch yi-9b``, reduced: head_dim 64) and with ``--ckpt``
              at (d)'s checkpoints: every request ok, the restored step
              printed; (f) hubert-xlarge at full width and depth (48
              layers, d 1280, 16 heads of dh 80, non-causal) on the
              frontend stub's frames, B 8 x S 1024, block remat, 10 steps:
              the loss must fall, every step launch the dh-80 flash
              forward 2 x 48 times and its backward 48; a profiled step,
              two layers' gradients against the twins'; (h) qwen2-1.5b as
              (a), at (a)'s lr 3e-4 and at 1e-4: 10 steps of
              ``make_train_step`` then 10 of ``make_compressed_train_step``
              (int8 error-feedback, one rank) from the same seed: per-step
              loss and ms, peak memory of each (the compressed one carries
              the f32 ``ef`` residual), the device time of
              ``compressed_mean_grads`` over one step's gradients
              (profiled), ``wire_bytes`` for a world of 1 and 8; every
              compressed loss must fall, and at 1e-4 (no loss spike) end
              within 2% of the uncompressed one;
19. examples — the port's examples (``repro_torch.examples``) through
              their ``main`` on the card, bf16: (a) ``quickstart``
              (reduced yi-9b at head_dim 64: tokens of ``full``, ``sals``
              and ``sals-g2``, calibration and wall seconds); (b)
              ``multi_arch_smoke`` over all ten assigned architectures
              (loss, decode ok, finite logits; any exception fails the
              phase); (c) ``train_then_serve --full-100m`` at 300 steps
              (d 512, 8 layers, vocab 32,768: loss first and last, ms a
              step, peak memory, calibration seconds, tok/s of ``full``,
              ``sals25`` and ``sals25-g2`` through the scheduler and each
              SALS engine's greedy agreement with ``full`` on the trained
              weights); (d) ``fault_tolerant_train`` (two crashes: the
              restarts, the kept checkpoints and the max parameter delta
              against the uninterrupted run, below the example's 1e-5);
              launch counts of each run, zeroed just before it;
20. whole   — a full-width 2-layer model (SALS on layer 1) decoded on the
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
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense), defined once in the port's roofline;
# this import fails outside a checkout of the repository
from repro_torch.analysis.roofline import (  # noqa: E402
    F32_PEAK_FLOPS as F32_FLOP_PER_S, HBM_BW as HBM_BYTES_PER_S,
    PEAK_FLOPS as BF16_FLOP_PER_S)
from repro_torch.kernels import cost  # noqa: E402

PHASES = ("device", "build", "kernels", "serve", "sched", "tier", "quality",
          "spec", "slo", "obs", "grouped", "mesh", "pipe", "roofline",
          "dryrun", "vlm", "families", "train", "examples", "whole")
# "profile" (not run by default) adds torch.profiler passes over four
# chunked-prefill steps after the sched phase (replayed and eager, and the
# host's issue time of a chunk), and over three
# decode steps of each serve run (and of the vlm phase's generate runs,
# as profile_decode_vlm_*); tables go to chiprun_out/.  "scan" (not
# run by default) adds recon cases over N_c x r to the kernels phase, to
# show where the recon body's time goes


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, flops: float, peak_flops: float):
    """(ms, "bytes" | "operations"): the larger of the bytes over the HBM
    rate and the operations over ``peak_flops``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ptxas_stats(log: str, names=("flash_fwd_kernel", "sra_kernel",
                                   "sra_f32_kernel", "fb_dot_kernel",
                                   "fb_dkdv_kernel", "fb_dq_kernel")) -> dict:
    """Registers, spills and shared memory that ``nvcc -Xptxas -v`` reports
    for each instance of the named kernels (mangled name -> counts)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            cur = name[:name.find("Ev") + 1] if any(
                re.search(rf"\d{n}I", name) for n in names) else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[cur]["static_smem"] = int(m.group(1)) if m else 0
    return out


def as_graph(torch, fn):
    """``fn`` captured into a CUDA graph; returns its replay."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        fn()
    torch.cuda.synchronize()
    return g.replay


def eager_graph_ms(torch, fn, iters: int, flush) -> dict:
    """Median CUDA-event times of one eager call of ``fn`` (``ms``, as a
    serving step pays it: the card may wait for the wrapper's Python) and
    of its CUDA-graph replay (``graph_ms``, the launches alone), taken in
    turns — eager, replay, replay, eager, ... — with L2 flushed before each
    run, so that an order or clock drift weighs on both alike."""
    replay = as_graph(torch, fn)
    fn()
    replay()
    times = {"ms": [], "graph_ms": []}
    for i in range(2 * iters):
        key = "ms" if i % 4 in (0, 3) else "graph_ms"
        run = fn if key == "ms" else replay
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times[key].append(start.elapsed_time(end))
    return {k: statistics.median(v) for k, v in times.items()}


def kernel_device_ms(torch, fn, iters: int, flush, mode: str = "zero"
                     ) -> dict:
    """Mean device time per call of ``fn`` by kernel (CUPTI durations
    through torch.profiler, launch gaps excluded).  ``mode`` says how L2
    is emptied before each call: "zero" fills the 96 MB ``flush`` buffer
    (as every other timing here; its dirty lines are written back while
    ``fn`` runs), "read" reads it (clean lines), "none" leaves L2 as the
    last call left it (inputs that fit stay hot).  The flush's own kernel
    (and the reduction's memset) is left out.  Keys: kernel names cut at
    the template arguments."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prep, own = {"zero": (flush.zero_, ("FillFunctor",)),
                 "read": (flush.max, ("reduce_kernel", "Memset")),
                 "none": (lambda: None, ())}[mode]
    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            prep()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or any(o in e.key for o in own):
            continue
        short = e.key.split("<")[0].split("(")[0].strip()[:60]
        out[short] = out.get(short, 0.0) \
            + e.self_device_time_total / 1e3 / iters
    return out


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

def paged_pool(torch, g, b, s, ps, live_tokens):
    """A shuffled page table (B, S/ps) over a pool with spare pages: row
    b's first ceil(live_tokens[b]/ps) entries are distinct pool pages in
    random order, the unmapped tail holds ids outside the pool (the kernel
    must clamp them and its position mask keep them unselectable)."""
    dev = "cuda"
    mp = s // ps
    n_pages = b * mp + 9
    perm = torch.randperm(n_pages - 1, generator=g, device=dev) + 1
    pt = torch.randint(-40, n_pages + 40, (b, mp), generator=g, device=dev,
                       dtype=torch.int32)
    at = 0
    for i in range(b):
        n = -(-live_tokens[i] // ps)
        pt[i, :n] = perm[at:at + n].int()
        at += n
    return pt, n_pages


def topk_parts_ms(torch, q_lat, k_lat, k_scale, pos, kw, pg, flush):
    """The two halves of one ``latent_topk_cuda`` call, each timed alone
    (eager and graph replay, in turns): the score pass and the selection.
    L2 is flushed before each run, so the second half reads its input from
    device memory, not L2."""
    from repro_torch.kernels import latent_score as ls
    launch = ls.topk_launcher(q_lat, k_lat, k_scale, pos, **kw, **pg)[0]
    launch(ls.TOPK_SCORE)
    return {"score_pass": eager_graph_ms(
                torch, lambda: launch(ls.TOPK_SCORE), 20, flush),
            "select": eager_graph_ms(
                torch, lambda: launch(ls.TOPK_SELECT), 20, flush)}


def topk_case(torch, name, b, s, r, r_star, n_c, k_dtype, seed, flush,
              ps=0, pos=None, pos_base=None, zero_q=False, timed=True):
    """latent_topk at a main-path shape, or an adversarial one (untimed).
    Integer-valued latents and query make every score exact in f32 (ties
    included), so indices and validity must equal the twin's exactly,
    tie-breaks and invalid slots too; ``zero_q``: every score is 0, so the
    N_c come purely by lowest index.  ``pos`` defaults to ragged decode
    positions as on the main path's last step; ``pos_base`` shifts row b's
    positions.  ``ps`` > 0: the latents are a page pool behind a shuffled
    table (``paged_pool``), and the paged kernel must also equal the dense
    kernel bit for bit on the same logical contents.  A case with r = r*
    (a tiered score pool's shape) must also select as the same columns
    inside a wider cache (r* + 256) do.  Timed cases: the whole call (eager
    ``ms`` and replay ``graph_ms`` in turns), its two halves alone
    (``parts``), paged against dense in turns (paged, dense, dense, paged)."""
    from repro_torch.kernels import latent_score as ls
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q_lat = torch.randint(-3, 4, (b, r_star), generator=g, device=dev).float()
    if zero_q:
        q_lat.zero_()
    base = [0] * b if pos_base is None else list(pos_base)
    if pos is None:
        pos = [base[i] + max(1, s - 65 - 512 * i) for i in range(b)]
    pg, rows = {}, (b, s)
    if ps:
        pt, n_pages = paged_pool(torch, g, b, s, ps, [
            min(s, max(0, p - q + 1)) for p, q in zip(pos, base)])
        pg, rows = dict(page_table=pt, page_size=ps), (n_pages, ps)
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}
    k_scale = None
    wide = r + 256 if r == r_star else r
    if k_dtype == "int8":
        k_full = torch.randint(-3, 4, (*rows, wide), generator=g, device=dev,
                               dtype=torch.int8)
        k_scale = torch.full(rows, 0.5, device=dev, dtype=torch.bfloat16)
    else:
        k_full = torch.randint(-3, 4, (*rows, wide), generator=g,
                               device=dev).to(dtype[k_dtype])
    k_lat = k_full if wide == r else k_full[..., :r].contiguous()
    pos = torch.tensor(pos, device=dev, dtype=torch.int32)
    kw = dict(n_critical=n_c, n_sink=16, n_recent=64,
              pos_base=torch.tensor(base, device=dev, dtype=torch.int32))
    twin = ref.latent_topk_paged_ref if ps else ref.latent_topk_ref
    idx_k, val_k = ls.latent_topk_cuda(q_lat, k_lat, k_scale, pos, **kw, **pg)
    idx_t, val_t = twin(q_lat, k_lat, k_scale, pos, **kw, **pg)
    pins = {}
    if wide != r:
        idx_w, val_w = ls.latent_topk_cuda(q_lat, k_full, k_scale, pos, **kw,
                                           **pg)
        pins["equals_wider_cache"] = bool(torch.equal(idx_k, idx_w)
                                          and torch.equal(val_k, val_w))
    k_log, s_log = k_lat, k_scale
    if ps:
        k_log = ref.paged_logical_view(k_lat, pt, ps).contiguous()
        s_log = None if k_scale is None else \
            ref.paged_logical_view(k_scale, pt, ps).contiguous()
        idx_d, val_d = ls.latent_topk_cuda(q_lat, k_log, s_log, pos, **kw)
        pins["bitwise_vs_dense"] = bool(torch.equal(idx_k, idx_d)
                                        and torch.equal(val_k, val_d))
    torch.cuda.synchronize()
    scores = ref.latent_score_ref(q_lat, k_log, s_log)
    sel_k = torch.gather(scores, 1, idx_k.long().clamp(0, s - 1))
    sel_t = torch.gather(scores, 1, idx_t.long().clamp(0, s - 1))
    err = float(((sel_k - sel_t).abs() * val_t).max()) if n_c else 0.0
    exact = bool(torch.equal(val_k, val_t) and torch.equal(idx_k, idx_t))
    out = dict(case=name, exact_idx=exact, valid=int(val_t.sum()),
               max_abs_err=err, tol=0.0, **pins,
               ok=exact and err <= 0.0 and all(pins.values()))
    if not timed:
        return out

    def kern():
        ls.latent_topk_cuda(q_lat, k_lat, k_scale, pos, **kw, **pg)

    def dense():
        ls.latent_topk_cuda(q_lat, k_log, s_log, pos, **kw)

    if ps:
        whole, dense_t, turns = paired_times(torch, kern, dense, 20, flush)
        out.update(dense_fields(dense_t, turns))
    else:
        whole = eager_graph_ms(torch, kern, 20, flush)
    parts = topk_parts_ms(torch, q_lat, k_lat, k_scale, pos, kw, pg, flush)
    device, device_read, device_warm = (
        kernel_device_ms(torch, kern, 20, flush, m)
        for m in ("zero", "read", "none"))
    plain_ms = time_ms(torch, lambda: twin(
        q_lat, k_lat, k_scale, pos, **kw, **pg), 5, flush=flush)
    # the bytes the function needs: the selectable rows' r* columns (and
    # scales), the query, positions, the outputs and the page table
    j = torch.arange(s, device=dev)[None, :] + kw["pos_base"][:, None]
    n_sel = int(((j >= kw["n_sink"])
                 & (j <= pos[:, None] - kw["n_recent"])).sum())
    flops, nbytes = cost.latent_topk_work(q_lat, k_lat, k_scale, pos, **kw,
                                          **pg, selectable_rows=n_sel)
    b_ms, b_by = bound(nbytes, flops, F32_FLOP_PER_S)
    out.update(ms=whole["ms"], graph_ms=whole["graph_ms"], parts=parts,
               device_ms=device, device_ms_sum=sum(device.values()),
               device_ms_read_flush=device_read,
               device_ms_no_flush=device_warm,
               plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, selectable_rows=n_sel,
               share_of_bound=b_ms / whole["graph_ms"])
    return out


def sra_case(torch, name, b, h, n_kv, dh, s, r, n_c, k_dtype, v_bits,
             softcap, seed, flush, ps=0, u_dtype="bf16", pos_base=None):
    """sparse_recon_attention on selected sets shaped like the main path's
    (ascending valid indices, invalid slots last; one all-invalid row).
    f32 latents or an f32 ``u`` take the CUDA-core body, whose bound is
    set at the float32 peak.
    ``ps`` > 0: every cache operand is a page pool behind a shuffled table
    whose last page per row is unmapped, and the paged kernel must also
    equal the dense kernel bit for bit on the same logical contents.
    ``pos_base`` (B,): row b's cache row j sits at position pos_base[b] +
    j, as a slab of the grouped fold (RoPE at that position), and the
    query at pos_base[b] + S - 1."""
    from repro_torch.core import quantization as qz
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_recon_attention as sra
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    kvd = n_kv * dh
    pg, rows = {}, (b, s)
    if ps:
        pt, n_pages = paged_pool(torch, g, b, s, ps, [s - ps] * b)
        pg, rows = dict(page_table=pt, page_size=ps), (n_pages, ps)
    q = torch.randn((b, h, dh), generator=g, device=dev).to(torch.bfloat16)
    lat = torch.randn((*rows, r), generator=g, device=dev)
    k_scale = None
    if k_dtype == "int8":
        k_lat, k_scale = qz.quantize_latent_int8(lat)
    else:
        k_lat = lat.to({"bf16": torch.bfloat16, "f32": torch.float32}
                       [k_dtype])
    vq = qz.quantize(torch.randn((*rows, kvd), generator=g, device=dev),
                     v_bits, 64)
    u = (torch.randn((kvd, r), generator=g, device=dev) * r ** -0.5).to(
        {"bf16": torch.bfloat16, "f32": torch.float32}[u_dtype])
    idx = torch.zeros((b, n_c), dtype=torch.int32, device=dev)
    valid = torch.zeros((b, n_c), dtype=torch.bool, device=dev)
    n_valid = [n_c, n_c, n_c // 3, 0][:b] + [n_c] * max(0, b - 4)
    for i in range(b):
        perm = torch.randperm(s - 80, generator=g, device=dev)[:n_valid[i]]
        idx[i, :n_valid[i]] = torch.sort(perm + 16).values.int()
        idx[i, n_valid[i]:] = torch.randint(0, s, (n_c - n_valid[i],),
                                            generator=g, device=dev).int()
        valid[i, :n_valid[i]] = True
    base = None if pos_base is None else torch.tensor(
        pos_base, dtype=torch.int32, device=dev)
    q_pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    if base is not None:
        q_pos = q_pos + base
    cache = (k_lat, k_scale, vq["q"], vq["scale"], vq["zero"])

    def args(c):
        return (q, *c, u, idx, valid, q_pos)

    kw = dict(n_kv=n_kv, v_bits=v_bits, v_group=64, theta=10_000.0,
              softcap=softcap, pos_base=base)
    twin = ref.sparse_recon_attention_paged_ref if ps \
        else ref.sparse_recon_attention_fused_ref
    m_k, l_k, o_k = sra.sparse_recon_attention_cuda(*args(cache), **kw, **pg)
    m_t, l_t, o_t = twin(*args(cache), **kw, **pg)
    bitwise = None
    if ps:
        logical = tuple(None if a is None else
                        ref.paged_logical_view(a, pt, ps).contiguous()
                        for a in cache)
        dense = sra.sparse_recon_attention_cuda(*args(logical), **kw)
        bitwise = all(bool(torch.equal(x, y))
                      for x, y in zip((m_k, l_k, o_k), dense))
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
    kern = lambda: sra.sparse_recon_attention_cuda(*args(cache), **kw, **pg)
    if ps:
        order, dense_t, turns = paired_times(
            torch, kern, lambda: sra.sparse_recon_attention_cuda(
                *args(logical), **kw), 10, flush)
    else:
        order = eager_graph_ms(torch, kern, 10, flush)
    device = kernel_device_ms(torch, kern, 10, flush)
    kern_ms = order["ms"]
    plain_ms = time_ms(torch, lambda: twin(*args(cache), **kw, **pg), 5,
                       flush=flush)
    flops, nbytes = cost.recon_work(*args(cache), n_kv=n_kv, **pg,
                                    valid_rows=int(valid.sum()))
    b_ms, b_by = bound(nbytes, flops, F32_FLOP_PER_S if "f32" in (
        k_dtype, u_dtype) else BF16_FLOP_PER_S)
    out = dict(case=name, max_abs_err=err, tol=tol, all_invalid_row_ok=dead_ok,
               ms=kern_ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, graph_ms=order["graph_ms"], device_ms=device,
               splits=sra.query_split(r, dh, h // n_kv, 1,
                                      k_dtype=k_lat.dtype, u_dtype=u.dtype,
                                      v_bits=v_bits)[0],
               share_of_bound=b_ms / order["graph_ms"],
               ok=err <= tol and dead_ok and bitwise is not False)
    if ps:
        out.update(bitwise_vs_dense=bitwise, **dense_fields(dense_t, turns))
    return out


def score_case(torch, name, b, s, r, r_star, k_dtype, seed, flush):
    """latent_score (plain (B, S) scores over the leading r* columns)
    against its twin: max |kernel - twin| over the score scale (max |twin|)
    within 1e-5 (the same f32 products summed in another order).  The
    library yardstick is one ``torch.bmm`` of the r* columns with the query
    (a bf16 or int8 cache needs a cast to f32 first, which is timed too),
    timed in turns with the kernel (kernel, library, library, kernel)."""
    from repro_torch.kernels import latent_score as ls
    from repro_torch.kernels import ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    q_lat = torch.randn((b, r_star), generator=g, device=dev)
    lat = torch.randn((b, s, r), generator=g, device=dev)
    k_scale = None
    if k_dtype == "int8":
        from repro_torch.core import quantization as qz
        k_lat, k_scale = qz.quantize_latent_int8(lat)
    else:
        k_lat = lat.to({"bf16": torch.bfloat16, "f32": torch.float32}
                       [k_dtype])
    got = ls.latent_score_cuda(q_lat, k_lat, k_scale)
    want = ref.latent_score_ref(q_lat, k_lat, k_scale)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / max(scale, 1e-30)
    tol = 1e-5

    def kernel():
        return ls.latent_score_cuda(q_lat, k_lat, k_scale)

    plain_ms = time_ms(torch, lambda: ref.latent_score_ref(q_lat, k_lat,
                                                           k_scale), 5,
                       flush=flush)

    def library():
        k = k_lat[..., :r_star]
        out = torch.bmm(k if k.dtype == torch.float32 else k.float(),
                        q_lat[..., None])[..., 0]
        return out if k_scale is None else out * k_scale.float()

    kern, lib, _ = paired_times(torch, kernel, library, 20, flush)
    device, device_read, device_warm = (
        kernel_device_ms(torch, kernel, 20, flush, m)
        for m in ("zero", "read", "none"))
    lib_device, lib_read, lib_warm = (
        kernel_device_ms(torch, library, 20, flush, m)
        for m in ("zero", "read", "none"))
    flops, nbytes = cost.latent_score_work(q_lat, k_lat, k_scale)
    b_ms, b_by = bound(nbytes, flops, F32_FLOP_PER_S)
    return dict(case=name, max_abs_err=err, tol=tol, ms=kern["ms"],
                graph_ms=kern["graph_ms"], plain_ms=plain_ms,
                library_ms=lib["ms"], library_graph_ms=lib["graph_ms"],
                device_ms=device, library_device_ms=lib_device,
                device_ms_read_flush=device_read,
                library_device_ms_read_flush=lib_read,
                device_ms_no_flush=device_warm,
                library_device_ms_no_flush=lib_warm,
                library_casts=k_lat.dtype != torch.float32, bound_ms=b_ms,
                bound_by=b_by, share_of_bound=b_ms / kern["graph_ms"],
                ok=err <= tol)


def score_topk_pin(torch, name, b, s, r, r_star, n_c, k_dtype, seed):
    """latent_score's scores, masked by ``selection.selectable_mask`` and
    stable-sorted to the top N_c (``selection.topk_global``), must give
    latent_topk's indices and validity exactly: the two kernels score
    through one device function."""
    from repro_torch.config import SALSConfig
    from repro_torch.core import quantization as qz
    from repro_torch.core import selection as sel
    from repro_torch.kernels import latent_score as ls
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    sals = SALSConfig(n_critical=n_c)
    q_lat = torch.randn((b, r_star), generator=g, device=dev)
    lat = torch.randn((b, s, r), generator=g, device=dev)
    k_scale = None
    if k_dtype == "int8":
        k_lat, k_scale = qz.quantize_latent_int8(lat)
    else:
        k_lat = lat.to({"bf16": torch.bfloat16, "f32": torch.float32}
                       [k_dtype])
    pos = torch.tensor([max(1, s - 65 - 700 * i) for i in range(b)],
                       dtype=torch.int32, device=dev)
    idx_t, val_t = ls.latent_topk_cuda(q_lat, k_lat, k_scale, pos,
                                       n_critical=n_c, n_sink=sals.n_sink,
                                       n_recent=sals.n_recent)
    scores = ls.latent_score_cuda(q_lat, k_lat, k_scale)
    mask = sel.selectable_mask(torch.arange(s, device=dev)[None, :],
                               pos[:, None], sals)
    idx_s, val_s = sel.topk_global(scores, mask, n_c)
    torch.cuda.synchronize()
    same = bool(torch.equal(val_s, val_t)) and bool(torch.equal(
        torch.where(val_t, idx_s, 0), torch.where(val_t, idx_t, 0)))
    return dict(case=name, n_critical=n_c, valid=int(val_t.sum()),
                indices_equal=same, ok=same)


def paired_times(torch, kern, other, iters: int, flush):
    """``kern`` and ``other`` (the dense kernel on the same logical
    contents, or a library call) each timed by :func:`eager_graph_ms`, in
    turns — kern, other, other, kern — so that an order effect or a clock
    drift weighs on both alike, and shows between the first and the last
    turn.  Returns (kern's mean, other's mean, the four turns)."""
    turns = [eager_graph_ms(torch, f, iters, flush)
             for f in (kern, other, other, kern)]
    mean = lambda a, b: {k: (a[k] + b[k]) / 2 for k in a}
    return mean(turns[0], turns[3]), mean(turns[1], turns[2]), turns


def dense_fields(dense, turns) -> dict:
    """A paged kernel's line: the dense kernel's times from
    :func:`paired_times`, and the paged kernel's first and last turn."""
    return dict(dense_ms=dense["ms"], dense_graph_ms=dense["graph_ms"],
                paged_ms_first_last=[turns[0]["ms"], turns[3]["ms"]],
                paged_graph_ms_first_last=[turns[0]["graph_ms"],
                                           turns[3]["graph_ms"]])


def window_case(torch, name, b, ql, h, n_kv, dh, s, r, n_c, k_dtype, v_bits,
                softcap, seed, flush, ps=0, n_recent=64, pos_base=None):
    """sparse_recon_attention_window on selected sets shaped like a verify
    window's (ascending valid indices at positions <= q_pos + Q - 1 -
    n_recent, invalid slots last, one all-invalid row), ragged window bases
    q_pos.  Against the twin (tolerance as the single kernel's); and bit
    for bit: a Q = 1 window equals the single-token kernel, query t equals
    the single-token kernel at q_pos + t on valid ∧ idx <= q_pos + t -
    n_recent, and (``ps`` > 0) the paged window equals the dense window on
    the same logical contents.  Also times the single-token kernel at the
    same shape (``single_ms``).  ``pos_base`` (B,) shifts row b's cache
    rows and window base by pos_base[b], as a slab of the grouped fold."""
    from repro_torch.core import quantization as qz
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_recon_attention as sra
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    kvd = n_kv * dh
    q_pos = torch.tensor([s - ql - 64 * i for i in range(b)],
                         dtype=torch.int32, device=dev)
    pg, rows = {}, (b, s)
    if ps:
        pt, n_pages = paged_pool(torch, g, b, s, ps,
                                 [int(p) + ql for p in q_pos])
        pg, rows = dict(page_table=pt, page_size=ps), (n_pages, ps)
    q = torch.randn((b, ql, h, dh), generator=g, device=dev) \
        .to(torch.bfloat16)
    lat = torch.randn((*rows, r), generator=g, device=dev)
    k_scale = None
    if k_dtype == "int8":
        k_lat, k_scale = qz.quantize_latent_int8(lat)
    else:
        k_lat = lat.to({"bf16": torch.bfloat16, "f32": torch.float32}
                       [k_dtype])
    vq = qz.quantize(torch.randn((*rows, kvd), generator=g, device=dev),
                     v_bits, 64)
    u = (torch.randn((kvd, r), generator=g, device=dev)
         * r ** -0.5).to(torch.bfloat16)
    idx = torch.zeros((b, n_c), dtype=torch.int32, device=dev)
    valid = torch.zeros((b, n_c), dtype=torch.bool, device=dev)
    n_valid = [n_c, n_c, n_c // 3, 0][:b] + [n_c] * max(0, b - 4)
    for i in range(b):
        # selectable: [16, q_pos + Q - 1 - n_recent], as the window's top-k
        hi = int(q_pos[i]) + ql - 1 - n_recent
        perm = torch.randperm(hi - 15, generator=g, device=dev)[:n_valid[i]]
        idx[i, :n_valid[i]] = torch.sort(perm + 16).values.int()
        idx[i, n_valid[i]:] = torch.randint(0, s, (n_c - n_valid[i],),
                                            generator=g, device=dev).int()
        valid[i, :n_valid[i]] = True
    cache = (k_lat, k_scale, vq["q"], vq["scale"], vq["zero"])
    base = torch.tensor([0] * b if pos_base is None else pos_base,
                        dtype=torch.int32, device=dev)
    q_pos = q_pos + base              # row indices stay, positions shift
    kw = dict(n_kv=n_kv, v_bits=v_bits, v_group=64, theta=10_000.0,
              softcap=softcap, pos_base=None if pos_base is None else base)

    def win(c, qq=q, nr=n_recent, **p):
        return sra.sparse_recon_attention_window_cuda(
            qq, *c, u, idx, valid, q_pos, n_recent=nr, **kw, **p)

    def single(c, t, vd, **p):
        return sra.sparse_recon_attention_cuda(
            q[:, t].contiguous(), *c, u, idx, vd, q_pos + t, **kw, **p)

    twin = ref.sparse_recon_attention_window_paged_ref if ps \
        else ref.sparse_recon_attention_fused_window_ref
    m_k, l_k, o_k = win(cache, **pg)
    m_t, l_t, o_t = twin(q, *cache, u, idx, valid, q_pos, n_recent=n_recent,
                         **kw, **pg)
    same = lambda xs, ys: all(bool(torch.equal(x, y)) for x, y in zip(xs, ys))
    q1 = same([a[:, 0] for a in win(cache, q[:, :1].contiguous(), 0, **pg)],
              single(cache, 0, valid, **pg))
    advance = all(same([a[:, t] for a in (m_k, l_k, o_k)], single(
        cache, t, valid & (idx + base[:, None]
                           <= (q_pos + t)[:, None] - n_recent), **pg))
        for t in range(ql))
    bitwise = None
    logical = cache
    if ps:
        logical = tuple(None if a is None else
                        ref.paged_logical_view(a, pt, ps).contiguous()
                        for a in cache)
        bitwise = same((m_k, l_k, o_k), win(logical))
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
    if ps:
        order, dense_t, turns = paired_times(
            torch, lambda: win(cache, **pg), lambda: win(logical), 10, flush)
        order.update(dense_fields(dense_t, turns))
    else:
        order = eager_graph_ms(torch, lambda: win(cache, **pg), 10, flush)
    order["device_ms"] = kernel_device_ms(torch, lambda: win(cache, **pg),
                                          10, flush)
    plain_ms = time_ms(torch, lambda: twin(
        q, *cache, u, idx, valid, q_pos, n_recent=n_recent, **kw, **pg), 3,
        warmup=1, flush=flush)
    single_ms = time_ms(torch, lambda: single(cache, 0, valid, **pg), 10,
                        flush=flush)
    b_ms, b_by = window_bound(b, ql, h, n_kv, dh, r, n_c, int(valid.sum()),
                              k_lat.element_size(), k_scale is not None,
                              v_bits, s // ps if ps else 0)
    out = dict(case=name, q_len=ql, splits=sra.query_split(
                   r, dh, h // n_kv, ql, k_dtype=k_lat.dtype,
                   v_bits=v_bits)[0], max_abs_err=err, tol=tol,
               all_invalid_row_ok=dead_ok, q1_equals_single=q1,
               mask_advance_bitwise=advance, plain_ms=plain_ms,
               single_ms=single_ms, library_ms=None, bound_ms=b_ms,
               bound_by=b_by, share_of_bound=b_ms / order["graph_ms"],
               **order,
               ok=err <= tol and dead_ok and q1 and advance
               and bitwise is not False)
    if ps:
        out["bitwise_vs_dense"] = bitwise
    return out


def window_bound(b, ql, h, n_kv, dh, r, n_c, nv, lat_bytes, scaled, v_bits,
                 pages_per_row=0):
    """Least time of one verify-window launch: the bf16 q, the ``nv`` valid
    selected rows, U_r, indices and outputs moved once; one reconstruction
    of the selected keys plus Q times the scoring, at the bf16 peak (the
    float32 one for f32 latents, the CUDA-core body; the gate drops no
    operation the kernel does)."""
    import torch
    kvd = n_kv * dh

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    lat = {4: torch.float32, 2: torch.bfloat16, 1: torch.int8}[lat_bytes]
    grp = meta(b, 1, kvd // 64)
    flops, nbytes = cost.recon_work(
        meta(b, ql, h, dh), meta(b, 1, r, dtype=lat),
        meta(b, 1) if scaled else None,
        meta(b, 1, kvd if v_bits == 8 else kvd // 2, dtype=torch.int8),
        grp, grp, meta(kvd, r), meta(b, n_c, dtype=torch.int32),
        meta(b, n_c, dtype=torch.bool), None, n_kv=n_kv,
        page_table=meta(b, pages_per_row, dtype=torch.int32)
        if pages_per_row else None, valid_rows=nv)
    return bound(nbytes, flops,
                 F32_FLOP_PER_S if lat_bytes == 4 else BF16_FLOP_PER_S)


def grouped_case(torch, name, b, h, n_kv, dh, s, r, r_star, n_c, g, seed,
                 flush, ps=0):
    """The grouped fold of the decode path (``core/sparse_attention.py``:
    ``_per_slab``, ``_slab_base``, ``_fold``) through rows 1 and 2 (paged:
    4 and 5): B·G rows of S/G positions, k_loc = ceil(N_c/G) slots, slab g
    at pos_base g·S/G, bf16 latents and int8 V; decode positions as the
    serve phase's ragged rows, so later slabs of the shorter rows hold
    nothing selectable.  The top-k against its twin exactly (integer
    latents: exact scores), the recon against its twin (the single case's
    tolerance), each empty slab an exact no-op, and the slabs' LSE merge
    against the twins'.  ``ps`` > 0: the same logical rows in a page pool
    behind a shuffled table viewed as (B·G, mp/G) must give the dense
    fold's indices and partials bit for bit, timed in turns with it.
    Returns the top-k line and the recon line."""
    from repro_torch.core import quantization as qz
    from repro_torch.core import selection as sel
    from repro_torch.core import sparse_attention as sa
    from repro_torch.kernels import latent_score as ls
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_recon_attention as sra
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    kvd = n_kv * dh
    k_loc, s_loc = -(-n_c // g), s // g
    pos = torch.tensor([s - 1 - 512 * i for i in range(b)],
                       dtype=torch.int32, device=dev)
    k_lat = torch.randint(-3, 4, (b, s, r), generator=gen, device=dev) \
        .to(torch.bfloat16)
    vq = qz.quantize(torch.randn((b, s, kvd), generator=gen, device=dev),
                     8, 64)
    u = (torch.randn((kvd, r), generator=gen, device=dev)
         * r ** -0.5).to(torch.bfloat16)
    q = torch.randn((b, h, dh), generator=gen, device=dev).to(torch.bfloat16)
    q_lat = torch.randint(-3, 4, (b, r_star), generator=gen,
                          device=dev).float()
    base = sa._slab_base(b, g, s_loc, dev)
    qg, qlg, pos_g = (sa._per_slab(x, g) for x in (q, q_lat, pos))
    arena = (k_lat, None, vq["q"], vq["scale"], vq["zero"])
    kv = tuple(sa._fold(a, g) for a in arena)
    shared = all(a is None or a.data_ptr() == f.data_ptr()
                 for a, f in zip(arena, kv))
    tkw = dict(n_critical=k_loc, n_sink=16, n_recent=64, pos_base=base)
    rkw = dict(n_kv=n_kv, v_bits=8, v_group=64, theta=10_000.0,
               softcap=0.0, pos_base=base)

    def topk(c=kv, **pg):
        return ls.latent_topk_cuda(qlg, c[0], None, pos_g, **tkw, **pg)

    idx_k, val_k = topk()
    idx_t, val_t = ref.latent_topk_ref(qlg, kv[0], None, pos_g, **tkw)
    idx_s, val_s = sel.sort_selected(idx_k, val_k)

    def recon(c=kv, **pg):
        return sra.sparse_recon_attention_cuda(qg, *c, u, idx_s, val_s,
                                               pos_g, **rkw, **pg)

    m_k, l_k, o_k = recon()
    m_t, l_t, o_t = ref.sparse_recon_attention_fused_ref(
        qg, *kv, u, idx_s, val_s, pos_g, **rkw)
    bitwise = None
    if ps:
        # the same logical rows in a shuffled pool, the table folded
        pt, n_pages = paged_pool(torch, gen, b, s, ps, [s] * b)
        mp = s // ps
        pools = tuple(None if a is None else torch.zeros(
            (n_pages, ps, *a.shape[2:]), dtype=a.dtype, device=dev)
            for a in arena)
        for pool, a in zip(pools, arena):
            if pool is not None:
                pool[pt.long().view(-1)] = a.reshape(b * mp, ps,
                                                     *a.shape[2:])
        pg = dict(page_table=sa._fold(pt, g), page_size=ps)
        ip, vp = topk(pools, **pg)
        mp_, lp, op = recon(pools, **pg)
        bitwise = all(bool(torch.equal(x, y)) for x, y in zip(
            (idx_k, val_k, m_k, l_k, o_k), (ip, vp, mp_, lp, op)))
    torch.cuda.synchronize()
    exact = bool(torch.equal(idx_k, idx_t) and torch.equal(val_k, val_t))
    live = l_t > 0
    err = max(float((m_k - m_t)[live].abs().max()),
              float(((l_k - l_t) / l_t.clamp_min(1.0))[live].abs().max()),
              float((o_k / l_k.clamp_min(1e-30)[..., None]
                     - o_t / l_t.clamp_min(1e-30)[..., None])[live]
                    .abs().max()))
    dead = ~live
    dead_ok = bool((m_k[dead] == ref.NEG_INF).all()
                   and (l_k[dead] == 0).all() and (o_k[dead] == 0).all())

    def merged(m, l, o):
        m, l, o = (x.view(b, g, *x.shape[1:]) for x in (m, l, o))
        w = torch.exp(m - m.max(dim=1, keepdim=True).values)
        return (w[..., None] * o).sum(1) / (w * l).sum(1).clamp_min(
            1e-30)[..., None]

    merge_err = float((merged(m_k, l_k, o_k)
                       - merged(m_t, l_t, o_t)).abs().max())
    tol = 2e-3
    lines = []
    for kind, kern, twin in (
            ("topk", topk, lambda: ref.latent_topk_ref(
                qlg, kv[0], None, pos_g, **tkw)),
            ("recon", recon, lambda: ref.sparse_recon_attention_fused_ref(
                qg, *kv, u, idx_s, val_s, pos_g, **rkw))):
        row = dict(case=name, groups=g, rows=b * g, slab=s_loc, k_loc=k_loc,
                   views_share_arena=shared)
        if ps:
            paged = (lambda: topk(pools, **pg)) if kind == "topk" \
                else (lambda: recon(pools, **pg))
            order, dense_t, turns = paired_times(torch, paged, kern, 10,
                                                 flush)
            row.update(bitwise_vs_dense_fold=bitwise,
                       **dense_fields(dense_t, turns))
            timed = paged
        else:
            order = eager_graph_ms(torch, kern, 10, flush)
            timed = kern
        row.update(ms=order["ms"], graph_ms=order["graph_ms"],
                   device_ms=kernel_device_ms(torch, timed, 10, flush),
                   plain_ms=time_ms(torch, twin, 3, warmup=1, flush=flush),
                   library_ms=None)
        lines.append(row)
    # bounds from this run's inputs: the selectable rows' r* columns and
    # the valid selected rows, as topk_case and sra_case count them
    j = torch.arange(s_loc, device=dev)[None, :] + base[:, None]
    n_sel = int(((j >= 16) & (j <= pos_g[:, None] - 64)).sum())
    fpg = pg if ps else {}
    flops, nbytes = cost.latent_topk_work(qlg, kv[0], None, pos_g, **tkw,
                                          **fpg, selectable_rows=n_sel)
    t_ms, t_by = bound(nbytes, flops, F32_FLOP_PER_S)
    flops, nbytes = cost.recon_work(qg, *kv, u, idx_s, val_s, pos_g,
                                    n_kv=n_kv, **fpg,
                                    valid_rows=int(val_s.sum()))
    r_ms, r_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    ok = exact and err <= tol and dead_ok and merge_err <= tol and shared \
        and bitwise is not False
    lines[0].update(exact_idx=exact, valid=int(val_t.sum()),
                    selectable_rows=n_sel, max_abs_err=0.0, tol=0.0,
                    bound_ms=t_ms, bound_by=t_by,
                    share_of_bound=t_ms / lines[0]["graph_ms"], ok=ok)
    lines[1].update(max_abs_err=err, merged_max_abs_err=merge_err, tol=tol,
                    empty_slabs=int(dead.all(dim=-1).sum()),
                    empty_slabs_noop=dead_ok, bound_ms=r_ms, bound_by=r_by,
                    share_of_bound=r_ms / lines[1]["graph_ms"], ok=ok)
    return lines


# Flash output check: per (b, q, h) row, the largest |kernel - f32 twin|
# over dh over the row's largest |f32 twin|, against 2 bf16 ulps.  Scaling
# by the row keeps long rows (|o| ~ 0.03 at S=4096) as strict as short ones.
FLASH_TOL = 2.0 ** -7


def row_rel_err(out, ref) -> float:
    diff = (out.float() - ref).abs().amax(-1)
    return float((diff / ref.abs().amax(-1).clamp_min(1e-30)).max())


def flash_case(torch, name, b, sq, sk, h, hkv, dh, softcap, seed, flush,
               causal=True, prefix_len=0):
    """flash_attention against the twin run in f32 on the same bf16 inputs.
    Two planted faults on the longest quarter of the rows (one 64-key tile
    dropped, the logit scale off by 1%) must fail the same check.
    ``prefix_len`` > 0: prefix-LM (the first ``prefix_len`` keys visible
    to every query, the rest causal); the library call then takes the
    boolean mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dev = "cuda"
    causal = causal or prefix_len > 0
    mk = dict(causal=causal, softcap=softcap, prefix_len=prefix_len)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, h, dh), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((b, sk, hkv, dh), generator=g, device=dev) \
        .to(torch.bfloat16)
    v = torch.randn((b, sk, hkv, dh), generator=g, device=dev) \
        .to(torch.bfloat16)
    out_k = fa.flash_attention_cuda(q, k, v, **mk)
    q32, k32, v32 = q.float(), k.float(), v.float()
    out_t = ref.attention_ref(q32, k32, v32, **mk)
    err = row_rel_err(out_k, out_t)
    long_rows = slice(sq - sq // 4, sq)
    tile = sk // 2 // 64 * 64
    keep = torch.ones((1, sq, sk), dtype=torch.bool, device=dev)
    keep[0, long_rows, tile:tile + 64] = False
    planted = {
        "skip_kv_tile": ref.attention_ref(q32, k32, v32, **mk, mask=keep),
        "scale_1pct": ref.attention_ref(q32 * 1.01, k32, v32, **mk),
    }
    fault_err = {f: row_rel_err(o.to(torch.bfloat16)[:, long_rows],
                                out_t[:, long_rows])
                 for f, o in planted.items()}
    long_err = row_rel_err(out_k[:, long_rows], out_t[:, long_rows])
    abs_err = float((out_k.float() - out_t).abs().max())
    del planted, keep, out_t
    torch.cuda.synchronize()
    kern = lambda: fa.flash_attention_cuda(q, k, v, **mk)
    times = eager_graph_ms(torch, kern, 10, flush)
    device = kernel_device_ms(torch, kern, 10, flush)
    plain_ms = time_ms(torch, lambda: ref.attention_ref(q, k, v, **mk), 2,
                       warmup=1, flush=flush)
    library = {"ms": None, "graph_ms": None}
    if not softcap:
        # the library call takes (B, H, S, dh); GQA K/V are expanded first
        qt, kt, vt = (torch.repeat_interleave(x, h // x.shape[2], dim=2)
                      .transpose(1, 2).contiguous() for x in (q, k, v))
        mask = None
        if causal and (sq != sk or prefix_len):
            # decode-style alignment or a prefix: a boolean mask
            kp = torch.arange(sk, device=dev)[None, :]
            mask = torch.arange(sq, device=dev)[:, None] + (sk - sq) >= kp
            if prefix_len:
                mask = mask | (kp < prefix_len)
        library = eager_graph_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None), 10, flush)
    flops, nbytes = cost.flash_work(q, k, v, causal=causal,
                                    prefix_len=prefix_len)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    faults_caught = all(e > FLASH_TOL for e in fault_err.values())
    return dict(case=name, max_abs_err=abs_err, max_row_rel_err=err,
                long_rows_rel_err=long_err, tol=FLASH_TOL,
                planted_fault_rel_err=fault_err, faults_caught=faults_caught,
                prefix_len=prefix_len, ms=times["ms"],
                graph_ms=times["graph_ms"], device_ms=device,
                plain_ms=plain_ms, library_ms=library["ms"],
                library_graph_ms=library["graph_ms"], bound_ms=b_ms,
                bound_by=b_by,
                achieved_tflops=flops / times["graph_ms"] * 1e-9,
                share_of_peak=flops / times["graph_ms"] * 1e3
                / BF16_FLOP_PER_S,
                ok=err <= FLASH_TOL and faults_caught)


# Backward check: per tensor, max |kernel - twin| over the tensor's max
# |twin| (the twin on the same bf16 inputs, rounding P and dS to bf16 as
# the kernel does), against 1e-2; planted faults must exceed it.
FLASH_BWD_TOL = 1e-2
FLASH_LSE_TOL = 1e-5


def rel_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30))


def flash_bwd_case(torch, name, b, sq, sk, h, hkv, dh, softcap, seed, flush,
                   causal=True, prefix_len=0):
    """The flash backward (D pass, dK/dV and dQ kernels: TMA-fed wgmma,
    no atomics) against the twin ``attention_bwd_ref`` on the card from the
    same bf16 q, k, v, dO and the forward kernel's O and LSE; each
    kernel's device ms (``kernel_device_ms``, every one must be there).
    Two runs must be bitwise equal; two
    planted faults (the logit scale off by 5%, the D term dropped) must
    fail the check.  The forward with the LSE output runs in turns with
    the plain forward: O bitwise equal, LSE within 1e-5 of the twin's.
    The library yardstick is ``scaled_dot_product_attention``'s backward
    (``enable_gqa``; a boolean mask for Sq < Sk or a prefix), timed in
    turns with the kernel, eager only."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dev = "cuda"
    causal = causal or prefix_len > 0
    mk = dict(causal=causal, softcap=softcap, prefix_len=prefix_len)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16) for shape in (
                       (b, sq, h, dh), (b, sk, hkv, dh), (b, sk, hkv, dh),
                       (b, sq, h, dh)))
    o_plain = fa.flash_attention_cuda(q, k, v, **mk)
    o, lse = fa.flash_attention_cuda(q, k, v, **mk, return_lse=True)
    _, lse_t = ref.attention_lse_ref(q, k, v, **mk)
    lse_err = float((lse - lse_t).abs().max())
    o_equal = bool(torch.equal(o, o_plain))
    del lse_t
    bwd = lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **mk)
    got, again = bwd(), bwd()
    torch.cuda.synchronize()
    bitwise = all(bool(torch.equal(a, c)) for a, c in zip(got, again))
    del again
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, **mk)
    errs = {n: rel_err(a, r) for n, a, r in zip(("dq", "dk", "dv"), got,
                                                want)}
    abs_err = max(float((a.float() - r.float()).abs().max())
                  for a, r in zip(got, want))
    faults = {
        "scale_5pct": ref.attention_bwd_ref(
            (q.float() * 1.05).to(torch.bfloat16), k, v, o, lse, do, **mk),
        "no_D_term": ref.attention_bwd_ref(q, k, v, torch.zeros_like(o),
                                           lse, do, **mk),
    }
    fault_err = {f: max(rel_err(a, r) for a, r in zip(fg, want))
                 for f, fg in faults.items()}
    del faults, want, got
    torch.cuda.synchronize()
    times = eager_graph_ms(torch, bwd, 10, flush)
    device = kernel_device_ms(torch, bwd, 10, flush)
    plain_ms = time_ms(torch, lambda: ref.attention_bwd_ref(
        q, k, v, o, lse, do, **mk), 2, warmup=1, flush=flush)
    fwd_turns = paired_times(
        torch, lambda: fa.flash_attention_cuda(q, k, v, **mk,
                                               return_lse=True),
        lambda: fa.flash_attention_cuda(q, k, v, **mk), 10, flush)
    library_ms = None
    if not softcap:
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        mask = None
        if causal and (sq != sk or prefix_len):
            kp = torch.arange(sk, device=dev)[None, :]
            mask = torch.arange(sq, device=dev)[:, None] + (sk - sq) >= kp
            if prefix_len:
                mask = mask | (kp < prefix_len)
        out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=hkv != h)
        dot = do.transpose(1, 2).contiguous()
        lib = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                          retain_graph=True)
        turns = [time_ms(torch, f, 5, warmup=1, flush=flush)
                 for f in (bwd, lib, lib, bwd)]
        library_ms = (turns[1] + turns[2]) / 2
        del out, qt, kt, vt
    flops, nbytes = cost.flash_bwd_work(q, k, v, o, lse, do, causal=causal,
                                        prefix_len=prefix_len)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    faults_caught = all(e > FLASH_BWD_TOL for e in fault_err.values())
    # each kernel's own device time (a rename must not hide one)
    parts = {part: sum(v for k, v in device.items() if kname in k)
             for part, kname in (("D", "fb_dot_kernel"),
                                 ("dK/dV", "fb_dkdv_kernel"),
                                 ("dQ", "fb_dq_kernel"))}
    ok = (max(errs.values()) <= FLASH_BWD_TOL and faults_caught and bitwise
          and o_equal and lse_err <= FLASH_LSE_TOL
          and all(v > 0 for v in parts.values()))
    return dict(case=name, max_abs_err=abs_err, rel_err=errs,
                tol=FLASH_BWD_TOL, planted_fault_rel_err=fault_err,
                faults_caught=faults_caught, bitwise_equal_runs=bitwise,
                fwd_lse_o_bitwise_equal=o_equal, fwd_lse_abs_err=lse_err,
                fwd_lse_tol=FLASH_LSE_TOL,
                fwd_lse_ms=fwd_turns[0]["ms"],
                fwd_lse_graph_ms=fwd_turns[0]["graph_ms"],
                fwd_plain_ms=fwd_turns[1]["ms"],
                fwd_plain_graph_ms=fwd_turns[1]["graph_ms"],
                prefix_len=prefix_len, ms=times["ms"],
                graph_ms=times["graph_ms"], device_ms=device,
                kernel_device_ms=parts,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by, share_of_bound=b_ms / times["graph_ms"],
                achieved_tflops=flops / times["graph_ms"] * 1e-9, ok=ok)


def phase_kernels(torch, scan: bool = False):
    flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device="cuda")
    # the grouped fold (G 4, k_loc 108): llama2-7b and paligemma-3b (MQA,
    # dh 256), dense at S 4160 and paged (64-token pages) at S 4096
    grouped = [grouped_case(torch, *args, flush, ps=ps) for *args, ps in (
        ("llama2-7b G4 B4 S4160 r1024 r*512 int8-V", 4, 32, 32, 128, 4160,
         1024, 512, 432, 4, 71, 0),
        ("paligemma-3b G4 MQA dh256 r64 r*32 int8-V", 4, 8, 1, 256, 4160,
         64, 32, 432, 4, 72, 0),
        ("llama2-7b G4 S4096 ps64 (paged fold == dense fold)", 4, 32, 32,
         128, 4096, 1024, 512, 432, 4, 73, 64),
        ("paligemma-3b G4 S4096 ps64 (paged fold == dense fold)", 4, 8, 1,
         256, 4096, 64, 32, 432, 4, 74, 64))]
    res = {
        "latent_topk": [
            topk_case(torch, "llama2-7b B4 S4160 r1024 r*512 bf16", 4, 4160,
                      1024, 512, 432, "bf16", 1, flush),
            topk_case(torch, "mistral-7b GQA r256 r*128 int8", 4, 4160, 256,
                      128, 432, "int8", 2, flush),
            # adversarial cases, untimed: exact indices and validity
            topk_case(torch, "all scores equal (zero query)", 4, 4160, 1024,
                      512, 432, "bf16", 40, flush, zero_q=True, timed=False),
            topk_case(torch, "fewer than N_c selectable (short pos)", 4,
                      4160, 1024, 512, 432, "bf16", 41, flush,
                      pos=[300, 200, 100, 90], timed=False),
            topk_case(torch, "S 300 < N_c", 4, 300, 1024, 512, 432, "bf16",
                      42, flush, pos=[299, 250, 200, 150], timed=False),
            topk_case(torch, "B 1", 1, 4160, 1024, 512, 432, "bf16", 43,
                      flush, timed=False),
            topk_case(torch, "f32 r* 500", 3, 4000, 1024, 500, 432, "f32",
                      44, flush, timed=False),
            topk_case(torch, "bf16 r 1020 r* 500 (element loads)",
                      3, 4000, 1020, 500, 432, "bf16", 45, flush,
                      timed=False),
            topk_case(torch, "tiered score pool r = r* 512", 4, 4160, 512,
                      512, 432, "bf16", 46, flush, timed=False),
            topk_case(torch, "pos_base != 0", 4, 4160, 1024, 512, 432,
                      "bf16", 47, flush, pos_base=[0, 512, 1024, 2048],
                      timed=False),
            topk_case(torch, "S 10000 > 8192 (keys re-read from L2) int8", 2,
                      10000, 256, 128, 432, "int8", 48, flush, timed=False),
            topk_case(torch, "N_c 1000 > 512 (block bitonic sort)", 3, 4160,
                      1024, 512, 1000, "bf16", 50, flush, timed=False),
            topk_case(torch, "N_c 20 (one run)", 3, 4160, 1024, 512, 20,
                      "bf16", 51, flush, timed=False),
            topk_case(torch, "paligemma-3b B4 S4160 r64 r*32 (kv_dim 256)",
                      4, 4160, 64, 32, 432, "bf16", 52, flush),
            # the families' shapes: hymba (kv_dim 320), llama4, qwen3
            topk_case(torch, "hymba-1.5b B4 S4160 r80 r*40", 4, 4160, 80,
                      40, 432, "bf16", 80, flush),
            topk_case(torch, "llama4-scout B4 S4160 r256 r*128", 4, 4160,
                      256, 128, 432, "bf16", 81, flush),
            topk_case(torch, "qwen3-moe B4 S4160 r128 r*64", 4, 4160, 128,
                      64, 432, "bf16", 82, flush),
        ] + [c[0] for c in grouped[:2]],
        "sparse_recon_attention": [
            sra_case(torch, "llama2-7b B4 H32 S4160 r1024 int8-V", 4, 32, 32,
                     128, 4160, 1024, 432, "bf16", 8, 0.0, 3, flush),
            sra_case(torch, "mistral-7b GQA n_kv8 r256 int8-lat", 4, 32, 8,
                     128, 4160, 256, 432, "int8", 8, 0.0, 4, flush),
            sra_case(torch, "llama2-7b int4-V softcap30", 4, 32, 32, 128,
                     4160, 1024, 432, "bf16", 4, 30.0, 5, flush),
            sra_case(torch, "llama2-7b f32 latents (CUDA-core body)", 4, 32,
                     32, 128, 4160, 1024, 432, "f32", 8, 0.0, 10, flush),
            sra_case(torch, "dh64 GQA int8-lat int4-V", 4, 16, 4, 64, 2100,
                     256, 300, "int8", 4, 0.0, 18, flush),
            sra_case(torch, "f32 u int8-lat (CUDA-core body)", 4, 32, 8, 128,
                     4160, 256, 432, "int8", 8, 0.0, 31, flush,
                     u_dtype="f32"),
            sra_case(torch, "paligemma-3b dh256 MQA group 8 r64 int8-V", 4,
                     8, 1, 256, 4160, 64, 432, "bf16", 8, 0.0, 53, flush),
            sra_case(torch, "paligemma-3b dh256 int4-V", 4, 8, 1, 256, 4160,
                     64, 432, "bf16", 4, 0.0, 54, flush),
            sra_case(torch, "dh256 f32 latents (CUDA-core body)", 4, 8, 1,
                     256, 4160, 64, 432, "f32", 8, 0.0, 55, flush),
            sra_case(torch, "llama2-7b S1040 pos_base (a grouped slab)", 4,
                     32, 32, 128, 1040, 1024, 108, "bf16", 8, 0.0, 75, flush,
                     pos_base=[0, 1040, 2080, 3120]),
            sra_case(torch, "hymba-1.5b group 5 dh64 r80 int8-V", 4, 25, 5,
                     64, 4160, 80, 432, "bf16", 8, 0.0, 83, flush),
            sra_case(torch, "llama4-scout group 5 r256 int8-V", 4, 40, 8,
                     128, 4160, 256, 432, "bf16", 8, 0.0, 84, flush),
            sra_case(torch, "qwen3-moe group 16 r128 int8-V", 4, 64, 4, 128,
                     4160, 128, 432, "bf16", 8, 0.0, 85, flush),
        ] + [c[1] for c in grouped[:2]] + ([
            # where the recon body's time goes: passes x ring stages
            sra_case(torch, f"scan N_c {n_c} r {r}", 4, 32, 32, 128, 4160, r,
                     n_c, "bf16", 8, 0.0, 3, flush)
            for n_c in (128, 432) for r in (256, 1024)] if scan else []),
        "latent_topk_paged": [
            topk_case(torch, "llama2-7b B4 S4096 r1024 r*512 bf16 ps64", 4,
                      4096, 1024, 512, 432, "bf16", 11, flush, ps=64),
            topk_case(torch, "mistral-7b GQA r256 r*128 int8 S4160 ps16 "
                      "(ragged last block)", 4, 4160, 256, 128, 432, "int8",
                      12, flush, ps=16),
            topk_case(torch, "llama2-7b B4 S4096 r1024 r*512 bf16 ps8", 4,
                      4096, 1024, 512, 432, "bf16", 16, flush, ps=8),
            topk_case(torch, "tiered score pool r = r* 512 ps16, pos_base",
                      4, 4096, 512, 512, 432, "bf16", 49, flush, ps=16,
                      pos_base=[0, 64, 128, 192], timed=False),
            topk_case(torch, "hymba-1.5b r80 r*40 ps64", 4, 4096, 80, 40,
                      432, "bf16", 86, flush, ps=64),
            topk_case(torch, "llama4-scout r256 r*128 ps64", 4, 4096, 256,
                      128, 432, "bf16", 87, flush, ps=64),
            topk_case(torch, "qwen3-moe r128 r*64 ps64", 4, 4096, 128, 64,
                      432, "bf16", 88, flush, ps=64),
        ] + [c[0] for c in grouped[2:]],
        "sparse_recon_attention_paged": [
            sra_case(torch, "llama2-7b B4 H32 S4096 r1024 int8-V ps64", 4,
                     32, 32, 128, 4096, 1024, 432, "bf16", 8, 0.0, 13, flush,
                     ps=64),
            sra_case(torch, "mistral-7b GQA n_kv8 r256 int8-lat ps64", 4, 32,
                     8, 128, 4096, 256, 432, "int8", 8, 0.0, 14, flush,
                     ps=64),
            sra_case(torch, "llama2-7b int4-V softcap30 ps64", 4, 32, 32,
                     128, 4096, 1024, 432, "bf16", 4, 30.0, 15, flush,
                     ps=64),
            sra_case(torch, "llama2-7b B4 H32 S4096 r1024 int8-V ps8", 4,
                     32, 32, 128, 4096, 1024, 432, "bf16", 8, 0.0, 17, flush,
                     ps=8),
            sra_case(torch, "f32 latents ps16 (CUDA-core body)", 4, 32, 8,
                     128, 4096, 256, 432, "f32", 8, 0.0, 19, flush, ps=16),
            sra_case(torch, "paligemma-3b dh256 int8-V ps64", 4, 8, 1, 256,
                     4096, 64, 432, "bf16", 8, 0.0, 56, flush, ps=64),
            sra_case(torch, "paligemma-3b dh256 int8-lat int4-V ps16", 4, 8,
                     1, 256, 4096, 64, 432, "int8", 4, 0.0, 57, flush,
                     ps=16),
            sra_case(torch, "llama2-7b S1024 ps64 pos_base (a grouped slab)",
                     4, 32, 32, 128, 1024, 1024, 108, "bf16", 8, 0.0, 76,
                     flush, ps=64, pos_base=[0, 1024, 2048, 3072]),
            sra_case(torch, "hymba-1.5b group 5 dh64 r80 ps64", 4, 25, 5,
                     64, 4096, 80, 432, "bf16", 8, 0.0, 89, flush, ps=64),
            sra_case(torch, "llama4-scout group 5 r256 ps64", 4, 40, 8, 128,
                     4096, 256, 432, "bf16", 8, 0.0, 90, flush, ps=64),
            sra_case(torch, "qwen3-moe group 16 r128 ps64", 4, 64, 4, 128,
                     4096, 128, 432, "bf16", 8, 0.0, 91, flush, ps=64),
        ] + [c[1] for c in grouped[2:]],
        "sparse_recon_attention_window": [
            window_case(torch, "llama2-7b B4 Q4 H32 S4160 r1024 int8-V", 4, 4,
                        32, 32, 128, 4160, 1024, 432, "bf16", 8, 0.0, 21,
                        flush),
            window_case(torch, "llama2-7b Q1", 4, 1, 32, 32, 128, 4160, 1024,
                        432, "bf16", 8, 0.0, 22, flush),
            window_case(torch, "llama2-7b Q2", 4, 2, 32, 32, 128, 4160, 1024,
                        432, "bf16", 8, 0.0, 23, flush),
            window_case(torch, "llama2-7b Q8", 4, 8, 32, 32, 128, 4160, 1024,
                        432, "bf16", 8, 0.0, 24, flush),
            window_case(torch, "mistral-7b GQA Q8 n_kv8 r256 int8-lat", 4, 8,
                        32, 8, 128, 4160, 256, 432, "int8", 8, 0.0, 25,
                        flush),
            window_case(torch, "llama2-7b Q4 int4-V softcap30", 4, 4, 32, 32,
                        128, 4160, 1024, 432, "bf16", 4, 30.0, 26, flush),
            window_case(torch, "f32 latents Q4 GQA (CUDA-core body)", 4, 4,
                        32, 8, 128, 4160, 256, 432, "f32", 8, 0.0, 30, flush),
            window_case(torch, "paligemma-3b dh256 Q1 int8-V", 4, 1, 8, 1,
                        256, 4160, 64, 432, "bf16", 8, 0.0, 58, flush),
            window_case(torch, "paligemma-3b dh256 Q4 int8-V (2 blocks)", 4,
                        4, 8, 1, 256, 4160, 64, 432, "bf16", 8, 0.0, 59,
                        flush),
            window_case(torch, "paligemma-3b dh256 Q8 int8-V (3 blocks)", 4,
                        8, 8, 1, 256, 4160, 64, 432, "bf16", 8, 0.0, 60,
                        flush),
            window_case(torch, "paligemma-3b dh256 Q4 int4-V", 4, 4, 8, 1,
                        256, 4160, 64, 432, "bf16", 4, 0.0, 61, flush),
            window_case(torch, "paligemma-3b dh256 Q8 int4-V", 4, 8, 8, 1,
                        256, 4160, 64, 432, "bf16", 4, 0.0, 68, flush),
            window_case(torch, "dh256 f32 latents Q8 (CUDA-core body, 3 "
                        "blocks)", 4, 8, 8, 1, 256, 4160, 64, 432, "f32", 8,
                        0.0, 62, flush),
            window_case(torch, "llama2-7b Q4 S1040 pos_base (a grouped slab)",
                        4, 4, 32, 32, 128, 1040, 1024, 108, "bf16", 8, 0.0,
                        77, flush, pos_base=[0, 1040, 2080, 3120]),
            window_case(torch, "hymba-1.5b Q4 group 5 dh64 r80", 4, 4, 25,
                        5, 64, 4160, 80, 432, "bf16", 8, 0.0, 92, flush),
            window_case(torch, "llama4-scout Q4 group 5 r256", 4, 4, 40, 8,
                        128, 4160, 256, 432, "bf16", 8, 0.0, 93, flush),
            window_case(torch, "qwen3-moe Q4 group 16 r128", 4, 4, 64, 4,
                        128, 4160, 128, 432, "bf16", 8, 0.0, 94, flush),
        ],
        "sparse_recon_attention_window_paged": [
            window_case(torch, "llama2-7b B4 Q4 S4096 r1024 int8-V ps64", 4,
                        4, 32, 32, 128, 4096, 1024, 432, "bf16", 8, 0.0, 27,
                        flush, ps=64),
            window_case(torch, "mistral-7b GQA Q4 r256 int8-lat ps16", 4, 4,
                        32, 8, 128, 4096, 256, 432, "int8", 8, 0.0, 28, flush,
                        ps=16),
            window_case(torch, "llama2-7b Q4 int8-V ps8", 4, 4, 32, 32, 128,
                        4096, 1024, 432, "bf16", 8, 0.0, 29, flush, ps=8),
            window_case(torch, "paligemma-3b dh256 Q4 int8-V ps64", 4, 4, 8,
                        1, 256, 4096, 64, 432, "bf16", 8, 0.0, 63, flush,
                        ps=64),
            window_case(torch, "paligemma-3b dh256 Q8 int8-lat int4-V ps64",
                        4, 8, 8, 1, 256, 4096, 64, 432, "int8", 4, 0.0, 64,
                        flush, ps=64),
            window_case(torch, "paligemma-3b dh256 Q8 int8-V ps16", 4, 8, 8,
                        1, 256, 4096, 64, 432, "bf16", 8, 0.0, 69, flush,
                        ps=16),
            window_case(torch, "paligemma-3b dh256 Q4 int4-V ps64", 4, 4, 8,
                        1, 256, 4096, 64, 432, "bf16", 4, 0.0, 70, flush,
                        ps=64),
            window_case(torch, "llama2-7b Q4 S1024 ps64 pos_base (a grouped "
                        "slab)", 4, 4, 32, 32, 128, 1024, 1024, 108, "bf16",
                        8, 0.0, 78, flush, ps=64,
                        pos_base=[0, 1024, 2048, 3072]),
            window_case(torch, "hymba-1.5b Q4 group 5 dh64 r80 ps64", 4, 4,
                        25, 5, 64, 4096, 80, 432, "bf16", 8, 0.0, 95, flush,
                        ps=64),
            window_case(torch, "llama4-scout Q4 group 5 r256 ps64", 4, 4, 40,
                        8, 128, 4096, 256, 432, "bf16", 8, 0.0, 96, flush,
                        ps=64),
            window_case(torch, "qwen3-moe Q4 group 16 r128 ps64", 4, 4, 64,
                        4, 128, 4096, 128, 432, "bf16", 8, 0.0, 97, flush,
                        ps=64),
        ],
        "latent_score": [
            score_case(torch, "overlap_score path: f32 B2 S4096 r1024 r*512",
                       2, 4096, 1024, 512, "f32", 31, flush),
            score_case(torch, "llama2-7b B4 S4160 r1024 r*512 bf16", 4,
                       4160, 1024, 512, "bf16", 32, flush),
            score_case(torch, "llama2-7b B4 S4160 int8 + scale", 4, 4160,
                       1024, 512, "int8", 33, flush),
            score_case(torch, "f32 ragged S4000 r*500 (scalar loads)", 3,
                       4000, 1024, 500, "f32", 34, flush),
        ],
        "latent_score_vs_topk": [
            score_topk_pin(torch, "dense bf16 B4 S4160 N_c 432", 4, 4160,
                           1024, 512, 432, "bf16", 35),
            score_topk_pin(torch, "dense int8 B4 S4160 N_c 432", 4, 4160,
                           1024, 512, 432, "int8", 36),
        ],
        "flash_attention": [
            flash_case(torch, "llama2-7b B4 S4096 H32", 4, 4096, 4096, 32,
                       32, 128, 0.0, 6, flush),
            flash_case(torch, "mistral-7b GQA B2 S2048 Hkv8", 2, 2048, 2048,
                       32, 8, 128, 0.0, 7, flush),
            flash_case(torch, "Sq1000<Sk3000 softcap50", 1, 1000, 3000, 32,
                       32, 128, 50.0, 8, flush),
            flash_case(torch, "dh64 B4 S4096 H32", 4, 4096, 4096, 32, 32, 64,
                       0.0, 9, flush),
            flash_case(torch, "dh64 MQA Sq1000 non-causal Sk1500", 2, 1000,
                       1500, 16, 1, 64, 0.0, 10, flush, causal=False),
            flash_case(torch, "paligemma-3b B4 S4096 H8 Hkv1 dh256 prefix "
                       "256", 4, 4096, 4096, 8, 1, 256, 0.0, 65, flush,
                       prefix_len=256),
            flash_case(torch, "dh256 MQA B4 S4096 causal", 4, 4096, 4096, 8,
                       1, 256, 0.0, 66, flush),
            flash_case(torch, "llama2-7b B4 S4096 H32 prefix 256", 4, 4096,
                       4096, 32, 32, 128, 0.0, 67, flush, prefix_len=256),
            flash_case(torch, "hymba-1.5b B4 S2048 H25 Hkv5 dh64", 4, 2048,
                       2048, 25, 5, 64, 0.0, 98, flush),
            flash_case(torch, "qwen3-moe B4 S4096 H64 Hkv4", 4, 4096, 4096,
                       64, 4, 128, 0.0, 99, flush),
            flash_case(torch, "hubert-xlarge B8 S1024 H16 dh80 non-causal",
                       8, 1024, 1024, 16, 16, 80, 0.0, 106, flush,
                       causal=False),
        ],
        "flash_attention_bwd": [
            flash_bwd_case(torch, "qwen2-1.5b training B4 S4096 H12 Hkv2",
                           4, 4096, 4096, 12, 2, 128, 0.0, 100, flush),
            flash_bwd_case(torch, "llama2-7b B4 S4096 H32", 4, 4096, 4096,
                           32, 32, 128, 0.0, 101, flush),
            flash_bwd_case(torch, "hymba-1.5b dh64 B4 S2048 H25 Hkv5", 4,
                           2048, 2048, 25, 5, 64, 0.0, 102, flush),
            flash_bwd_case(torch, "paligemma-3b dh256 S4096 H8 Hkv1 prefix "
                           "256", 2, 4096, 4096, 8, 1, 256, 0.0, 103, flush,
                           prefix_len=256),
            flash_bwd_case(torch, "softcap50 B2 S2048 H8 Hkv2", 2, 2048,
                           2048, 8, 2, 128, 50.0, 104, flush),
            flash_bwd_case(torch, "Sq1000<Sk3000 H8 Hkv8", 1, 1000, 3000, 8,
                           8, 128, 0.0, 105, flush),
            flash_bwd_case(torch, "hubert-xlarge B8 S1024 H16 dh80 "
                           "non-causal", 8, 1024, 1024, 16, 16, 80, 0.0, 107,
                           flush, causal=False),
            flash_bwd_case(torch, "dh80 ragged B2 S1000 H16 non-causal", 2,
                           1000, 1000, 16, 16, 80, 0.0, 108, flush,
                           causal=False),
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

def eager_chunk_program(torch, eng):
    """The chunk program of ``eng`` run op by op: ``_prefill_chunk_impl``
    called directly on inputs made by ``torch.as_tensor``, as the engine
    ran a chunk before its step program."""
    def chunk(tokens, off, lengths, cache, scratch):
        return eng._prefill_chunk_impl(
            *(torch.as_tensor(np.asarray(a, np.int32), device=eng.device)
              for a in (tokens, off, lengths)), cache, scratch)
    return chunk


def eager_entries(torch, eng):
    """``eng`` with its decode entries and its chunk program run op by op:
    ``decode``, ``decode_window`` and ``commit_window`` call the
    transformer's step functions directly, as the engine did before its
    step programs, with inputs made by ``torch.as_tensor``, and
    ``prefill_chunk_step`` runs :func:`eager_chunk_program`.  ``generate``,
    ``generate_speculative`` and the scheduler go through these entries, so
    this is the eager side of every graph-against-eager check."""
    from repro_torch.models import transformer as tf

    def dev(a):
        return a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a, np.int32), device=eng.device)

    def decode(tokens, cache, positions):
        return tf.decode_step(eng.params, eng.projectors, cache, dev(tokens),
                              dev(positions), eng.cfg, eng.sals)

    def decode_window(tokens, cache, positions):
        return tf.decode_window(eng.params, eng.projectors, cache,
                                dev(tokens), dev(positions), eng.cfg,
                                eng.sals)

    def commit_window(cache, aux, positions, n_accept):
        return tf.commit_window(eng.projectors, cache, aux, dev(positions),
                                dev(n_accept), eng.cfg, eng.sals)

    eng.decode, eng.decode_window = decode, decode_window
    eng.commit_window = commit_window
    eng._prefill_chunk = eager_chunk_program(torch, eng)
    return eng


def eager_step_check(torch, eng) -> dict:
    """Hold every ``eng.decode`` (a replay of the step program) against
    the eager step — ``tf.decode_step`` called directly on a copy of the
    arena taken just before it: logits and the arena after the step must
    be bitwise equal.  Returns the running counts {steps, logits_equal,
    cache_equal} and ``spans``, (end, seconds) of each check's own work
    (the copy, the eager step, the comparison; the replay is synchronized
    before and after it, as the step's host read would).  The eager steps'
    kernel launches are taken back out of the launch counters: they check
    the path, they are not on it."""
    from repro_torch.core.latent_cache import LatentKVCache
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    def tensors(cache):
        for k in sorted(cache):
            seg = cache[k]
            if isinstance(seg, LatentKVCache):
                for f in dataclasses.fields(seg):
                    if isinstance(getattr(seg, f.name), torch.Tensor):
                        yield getattr(seg, f.name)
            else:
                yield from (seg[n] for n in sorted(seg))

    def clone(cache):
        return {k: dataclasses.replace(seg, **{
                    f.name: getattr(seg, f.name).clone()
                    for f in dataclasses.fields(seg)
                    if isinstance(getattr(seg, f.name), torch.Tensor)})
                if isinstance(seg, LatentKVCache)
                else {n: a.clone() for n, a in seg.items()}
                for k, seg in cache.items()}

    stats = dict(steps=0, logits_equal=0, cache_equal=0, spans=[])
    decode = eng.decode

    def checked(tokens, cache, positions):
        t0 = time.perf_counter()
        twin = clone(cache)
        tok, pos = (torch.as_tensor(np.asarray(a, np.int32), device="cuda")
                    for a in (tokens, positions))
        torch.cuda.synchronize()
        spent = time.perf_counter() - t0
        logits, cache = decode(tokens, cache, positions)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = ops.launch_counts()
        want, twin = tf.decode_step(eng.params, eng.projectors, twin, tok,
                                    pos, eng.cfg, eng.sals)
        after = ops.launch_counts()
        ops.add_launch_counts({k: before[k] - after[k] for k in after})
        stats["steps"] += 1
        stats["logits_equal"] += bool(torch.equal(logits, want))
        stats["cache_equal"] += all(torch.equal(a, b) for a, b in
                                    zip(tensors(cache), tensors(twin)))
        end = time.perf_counter()
        stats["spans"].append((end, spent + end - t0))
        return logits, cache

    eng.decode = checked
    return stats


def chunk_timer(torch, eng) -> list:
    """Time every ``eng.prefill_chunk_step`` between two synchronizations:
    appends (seconds, replayed) to the list it returns; ``replayed``: the
    call replayed the chunk program (not its capture, not an eager
    chunk)."""
    rows = []
    step = eng.prefill_chunk_step

    def timed(task):
        replays = getattr(eng._prefill_chunk, "replays", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = step(task)
        torch.cuda.synchronize()
        rows.append((time.perf_counter() - t0,
                     getattr(eng._prefill_chunk, "replays", 0) > replays))
        return done

    eng.prefill_chunk_step = timed
    return rows


# the engine's cache upkeep, which runs eagerly; the reference compiles
# all but the page-table install (repro/serve/engine.py:170-183)
UPKEEP = ("admit", "admit_paged", "admit_tiered", "copy_page",
          "copy_score_page", "load_page", "release_slot",
          "with_page_tables")


def upkeep_timer(eng) -> dict:
    """Host seconds of every call of the engine's upkeep entries
    (``UPKEEP``), no synchronization: what the host spends issuing each.
    Returns {name: [seconds, ...]}, filled as the run goes."""
    times = {}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            times.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return timed

    for name in UPKEEP:
        setattr(eng, name, wrap(name, getattr(eng, name)))
    return times


def upkeep_fields(times) -> dict:
    return {"upkeep_host_ms": {
        k: dict(calls=len(v), ms_per_call=1e3 * sum(v) / len(v),
                ms_median=1e3 * statistics.median(v))
        for k, v in sorted(times.items())}}


def chunk_fields(name, eng, chunks) -> dict:
    """A scheduler run's chunk program: captures (exactly 1 when the run
    went through the program: raises otherwise), capture seconds, nodes,
    replays, and the median ms of its replayed chunks."""
    g = eng._prefill_chunk
    replayed = [sec for sec, rep in chunks if rep]
    if not hasattr(g, "captures"):          # eager_entries: no program
        return dict(prefill_graph=None, prefill_chunk_ms_replayed=None)
    if g.captures != 1 or g.replays != len(chunks) - 1:
        raise AssertionError(f"{name}: the chunk program was captured "
                             f"{g.captures} times, replayed {g.replays} "
                             f"times over {len(chunks)} chunks")
    return dict(prefill_graph=dict(captures=g.captures,
                                   capture_s=g.capture_s, nodes=g.nodes,
                                   replays=g.replays),
                prefill_chunk_ms_replayed=1e3 * statistics.median(replayed)
                if replayed else None)


def eager_chunk_check(torch, eng, pick) -> dict:
    """Hold every chunk of one task — the first that ``pick(task)``
    accepts — against the eager chunk: ``_prefill_chunk_impl`` called
    directly on a copy of the prefill workspace taken just before it, on
    inputs made by ``torch.as_tensor``; logits, cache and scratch after
    the chunk must be bitwise equal.  Returns the running counts {chunks,
    equal} and ``spans``, (end, seconds) of each check's own work (the
    copy, the eager chunk, the comparison), as :func:`eager_step_check`."""
    from repro_torch.kernels import ops
    from repro_torch.serve.step_graph import tree_tensors

    stats = dict(chunks=0, equal=0, spans=[])
    step, eager = eng.prefill_chunk_step, eager_chunk_program(torch, eng)
    target = []

    def checked(task):
        if not target and pick(task):
            target.append(task)
        if not target or task is not target[0]:
            return step(task)
        t0 = time.perf_counter()
        c, j = eng.scfg.prefill_chunk, task.next_chunk
        twin = eng.prefill_state_copy(task)
        torch.cuda.synchronize()
        spent = time.perf_counter() - t0
        done = step(task)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = ops.launch_counts()
        want = eager(task.tokens[:, j * c:(j + 1) * c], j * c,
                     [task.prompt_len], *twin)
        after = ops.launch_counts()
        ops.add_launch_counts({k: before[k] - after[k] for k in after})
        stats["chunks"] += 1
        stats["equal"] += bool(torch.equal(task.logits, want)) and all(
            torch.equal(a, b) for a, b in
            zip(tree_tensors((task.cache, task.scratch)),
                tree_tensors(twin)))
        end = time.perf_counter()
        stats["spans"].append((end, spent + end - t0))
        return done

    eng.prefill_chunk_step = checked
    return stats


def chunk_turns(torch, model, prompt) -> dict:
    """One request's chunks on a fresh dense engine at the sched phase's
    settings, in turns eager / replayed / replayed / eager
    (:func:`eager_chunk_program` against the engine's chunk program): the
    median ms of a chunk between two synchronizations in each turn (the
    replayed turns without the capture call) and each turn's peak device
    memory; every turn's next-token logits must be bitwise equal."""
    from repro_torch.config import ServeConfig
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(model["params"], model["proj"], model["cfg"],
                      ServeConfig(max_seq_len=4096, max_batch=4,
                                  prefill_chunk=64, sals=model["sals"]),
                      device="cuda")
    graph, eager = eng._prefill_chunk, eager_chunk_program(torch, eng)
    chunks = chunk_timer(torch, eng)
    turns, logits = [], []
    with torch.inference_mode():
        for mode in ("eager", "graph", "graph", "eager"):
            eng._prefill_chunk = graph if mode == "graph" else eager
            del chunks[:]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            task = eng.start_prefill(prompt)
            while not task.done:
                eng.prefill_chunk_step(task)
            logits.append(task.logits.clone())
            sec = [s for s, rep in chunks if rep or mode == "eager"]
            turns.append(dict(mode=mode, chunks=len(sec),
                              ms_median=1e3 * statistics.median(sec),
                              max_memory_allocated=
                              torch.cuda.max_memory_allocated()))
    row = dict(phase="sched", run="chunk_turns", prompt=len(prompt),
               chunks=task.n_chunks, turns=turns,
               logits_equal=all(torch.equal(x, logits[0]) for x in logits),
               prefill_graph=dict(captures=graph.captures,
                                  capture_s=graph.capture_s,
                                  nodes=graph.nodes, replays=graph.replays))
    emit(row)
    if not row["logits_equal"] or graph.captures != 1:
        raise AssertionError(f"sched chunk turns: {row}")
    return row


def prefill_batch(torch, eng, prompts):
    """Monolithic prefill of right-padded ``prompts``: (logits, cache,
    host lengths)."""
    from repro_torch.models import transformer as tf
    lens = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((len(prompts), lens.max()), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    logits, cache = tf.prefill(
        eng.params, eng.projectors, eng.cfg, eng.sals,
        {"tokens": torch.as_tensor(toks, device="cuda")},
        eng.scfg.max_seq_len, n_groups=eng.n_groups,
        lengths=torch.as_tensor(lens, device="cuda"))
    return logits, cache, lens


def decode_turn(torch, eng, prompts, n_new: int, graph: bool) -> dict:
    """Prefill, then ``n_new`` - 1 greedy decode steps through the engine's
    step program (``eng.decode``: its first step captures it) or through
    ``tf.decode_step`` called directly.  Returns the tokens, every step's
    logits (kept on the card), each step's host ms (a step ends in the host
    read of its tokens), the peak device memory of the decode steps and
    their launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    with torch.inference_mode():
        logits, cache, lens = prefill_batch(torch, eng, prompts)
        tok = logits.argmax(-1).to(torch.int32)
        out = [tok.cpu().numpy()]
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        cap0 = eng._decode.capture_s
        steps, ms = [], []
        for t in range(n_new - 1):
            t0 = time.perf_counter()
            if graph:
                logits, _ = eng.decode(tok, cache, lens + t)
            else:
                logits, _ = tf.decode_step(
                    eng.params, eng.projectors, cache, tok,
                    torch.as_tensor(lens + t, device="cuda"), eng.cfg,
                    eng.sals)
            steps.append(logits.clone())
            tok = logits.argmax(-1).to(torch.int32)
            out.append(tok.cpu().numpy())
            ms.append(1e3 * (time.perf_counter() - t0))
        counts = ops.launch_counts()
    del cache
    return dict(tokens=np.stack(out, 1), logits=steps, ms=ms,
                capture_s=eng._decode.capture_s - cap0, launches=counts,
                peak_memory=torch.cuda.max_memory_allocated())


def profile_decode(torch, eng, prompts, name, steps: int = 3):
    """torch.profiler over a few steady decode steps (after prefill and one
    warm step, which captures the step program), replayed and eager:
    device time by kernel, and the device's busy share of the window.  The
    full tables go to chiprun_out/.  Then the next step, ten times back to
    back with no host read between (each run writes the same bytes at the
    same positions): CUDA-event ms per call, the replay's pace with the
    host out of the way, and the host's own ms per call (the key, the
    input copies and the graph launch, which the card runs behind)."""
    from repro_torch.models import transformer as tf
    with torch.inference_mode():
        for graph in (True, False):
            logits, cache, lens = prefill_batch(torch, eng, prompts)
            tok = logits.argmax(-1).to(torch.int32)

            def step(t):
                nonlocal tok
                if graph:
                    lg, _ = eng.decode(tok, cache, lens + t)
                else:
                    lg, _ = tf.decode_step(
                        eng.params, eng.projectors, cache, tok,
                        torch.as_tensor(lens + t, device="cuda"), eng.cfg,
                        eng.sals)
                tok = lg.argmax(-1).to(torch.int32)
                tok.cpu()       # the host read that ends a serving step

            step(0)
            torch.cuda.synchronize()
            profile_steps(torch, lambda t: step(1 + t), steps,
                          f"decode_{name}_{'graph' if graph else 'eager'}")
            if graph:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                # positions on the card, so that no call waits for the
                # staging buffer's previous copy, which queues behind the
                # previous replay
                pos = torch.as_tensor(lens + steps + 1, device="cuda")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                for _ in range(10):
                    eng.decode(tok, cache, pos)
                end.record()
                host = time.perf_counter() - t0
                end.synchronize()
                emit({"phase": "profile", "run": f"decode_{name}_graph",
                      "back_to_back_ms_per_replay":
                      start.elapsed_time(end) / 10,
                      "host_ms_per_call": 1e3 * host / 10})
            del cache


def profile_steps(torch, step, steps: int, name: str) -> None:
    """torch.profiler over ``steps`` calls of ``step(t)``: device time by
    kernel and the device's busy share of the window; the full table goes
    to chiprun_out/profile_<name>.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(steps):
            step(t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # device-side kernel events only (operator rows repeat their kernels)
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)
    (OUT_DIR / f"profile_{name}.txt").write_text(ka.table(
        sort_by="self_device_time_total", row_limit=40))
    emit({"phase": "profile", "run": name, "steps": steps,
          "wall_ms_per_step": 1e3 * wall / steps,
          "device_ms_per_step": dev_us / 1e3 / steps,
          "device_launches_per_step": sum(e.count for e in kernels) / steps,
          "device_busy_share": dev_us / 1e6 / wall,
          "top_device_ms_per_step": [
              [e.key[:70], e.self_device_time_total / 1e3 / steps,
               e.count / steps] for e in top[:25]]})


def build_model(torch, arch: str = "paper-llama2-7b", n_layers: int = 0,
                phase: str = "model"):
    """Seeded full-width ``arch`` (bf16) and U_r calibrated on the
    synthetic corpus (tokens only), shared by the serve and sched phases
    (paper-llama2-7b) or used by the vlm phase (paligemma-3b) and the
    families phase.  ``n_layers`` > 0 cuts the depth; an attention-free
    family is not calibrated (it has no SALS)."""
    from repro_torch.config import SALSConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.serve import calibrate
    from repro_torch.models.transformer import init_params, segment_plan

    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    sals = SALSConfig()                    # SALS-25% at the paper defaults
    t0 = time.perf_counter()
    params = init_params(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    proj = calibrate(params, cfg, sals, corpus, n_sequences=16,
                     seq_len=512) if cfg.has_attention else None
    n_sals = sum(i1 - i0 for i0, i1, m in segment_plan(cfg, sals)
                 if m == "sals")
    emit({"phase": phase, "arch": arch, "n_layers": cfg.n_layers,
          "init_params_s": init_s,
          "calibration_s": proj["seconds"] if proj else None,
          "sals_layers": n_sals,
          "param_bytes": sum(p.numel() * p.element_size()
                             for p in params.parameters()),
          "memory_allocated": torch.cuda.memory_allocated(),
          "rank": sals.rank(cfg.kv_dim),
          "score_rank": sals.score_rank(cfg.kv_dim)})
    return dict(cfg=cfg, sals=sals, params=params, proj=proj,
                corpus=corpus, n_sals=n_sals)


def depth_view(torch, model, n_layers: int) -> dict:
    """``model`` cut to its first ``n_layers`` layers without a copy: the
    same embedding, blocks and final norm, U_r's first rows (a path that
    needs the time of a full-depth run elsewhere runs on this)."""
    from repro_torch.models.transformer import Transformer, segment_plan
    cfg = dataclasses.replace(model["cfg"], n_layers=n_layers)
    full = model["params"]
    params = Transformer.__new__(Transformer)
    torch.nn.Module.__init__(params)
    params.embed, params.final_norm = full.embed, full.final_norm
    params.blocks = torch.nn.ModuleList(list(full.blocks)[:n_layers])
    proj = dict(model["proj"], u=model["proj"]["u"][:n_layers])
    n_sals = sum(i1 - i0 for i0, i1, m in segment_plan(cfg, model["sals"])
                 if m == "sals")
    return dict(model, cfg=cfg, params=params, proj=proj, n_sals=n_sals)


def phase_serve(torch, model, n_new: int = 32, prof: bool = False,
                phase: str = "serve"):
    """``ServeEngine.generate`` (its decode steps replay the step program)
    with SALS-25% and with SALS off; then decode steps taken in turns —
    eager, graph, graph, eager — from the same prompts: the replayed
    tokens and every step's logits must equal the eager ones bit for bit,
    and so must ``generate``'s tokens and each turn's launch counts.
    ``phase`` labels the lines (the vlm phase runs it on paligemma-3b,
    tokens only)."""
    from repro_torch.config import SALSConfig, ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine

    cfg, sals, params, proj = (model[k] for k in ("cfg", "sals", "params",
                                                  "proj"))
    n_sals = model["n_sals"]
    lens = [4096, 3584, 3072, 2560]
    prompts = [model["corpus"].batch(100 + i, 1, n)["tokens"][0]
               for i, n in enumerate(lens)]
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
        captures = eng._decode.captures
        toks = np.stack([r.tokens for r in out])
        steps = timing["decode_steps"]
        turns = [decode_turn(torch, eng, prompts, n_new, graph)
                 for graph in (False, True, True, False)]
        eager, graph = turns[0], turns[1]
        same_logits = [all(torch.equal(a, b) for a, b in
                           zip(eager["logits"], t["logits"]))
                       for t in turns[1:]]
        first_diff = next((i for i, (a, b) in enumerate(
            zip(eager["logits"], graph["logits"])) if not torch.equal(a, b)),
            None)

        def med(t):     # a turn's ms per step, the capture step left out
            return statistics.median(t["ms"][1:])

        row = dict(phase=phase, run=name, prompts=lens, new_tokens=n_new,
                   prefill_s=timing["prefill_s"],
                   decode_tok_s=len(lens) * steps / timing["decode_s"],
                   decode_ms_per_step=1e3 * timing["decode_s"] / steps,
                   capture_s=timing["capture_s"],
                   decode_captures=captures,
                   graph_nodes=eng._decode.nodes,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   launches=counts, decode_steps=steps,
                   turn_ms_per_step=[med(t) for t in turns],
                   turn_first_step_ms=[t["ms"][0] for t in turns],
                   turn_capture_s=[t["capture_s"] for t in turns],
                   turn_peak_memory=[t["peak_memory"] for t in turns],
                   eager_ms_per_step=statistics.median(
                       [med(turns[0]), med(turns[3])]),
                   graph_ms_per_step=statistics.median(
                       [med(turns[1]), med(turns[2])]),
                   logits_bitwise_equal_eager=same_logits,
                   first_differing_step=first_diff,
                   tokens_equal_eager=[bool(np.array_equal(
                       t["tokens"], eager["tokens"])) for t in turns[1:]]
                   + [bool(np.array_equal(toks, eager["tokens"]))])
        if first_diff is not None:
            a, b = eager["logits"][first_diff], graph["logits"][first_diff]
            row["first_diff_max_abs"] = float((a - b).abs().max())
        if not (toks.shape == (4, n_new) and (toks >= 0).all()
                and (toks < cfg.vocab_size).all()):
            raise AssertionError(f"{name}: generated tokens out of range")
        if captures != 1:
            raise AssertionError(f"{phase} {name}: generate captured its "
                                 f"decode step {captures} times")
        want_sals = n_sals * steps if name == "sals" else 0
        if counts["latent_topk"] != want_sals or \
                counts["sparse_recon_attention"] != want_sals:
            raise AssertionError(f"{name}: SALS kernel launches {counts}, "
                                 f"expected {want_sals} each")
        if counts["flash_attention"] < cfg.n_layers:
            raise AssertionError(f"{name}: prefill launched flash "
                                 f"{counts['flash_attention']} times")
        if any(t["launches"] != eager["launches"] for t in turns):
            raise AssertionError(f"{name}: the turns' launch counts differ: "
                                 f"{[t['launches'] for t in turns]}")
        runs[name] = (row, toks)
        if prof:
            profile_decode(torch, eng, prompts, name if phase == "serve"
                           else f"{phase}_{name}")
        del eng, out, turns, eager, graph
        gc.collect()
        torch.cuda.empty_cache()
    agree = float((runs["sals"][1] == runs["full"][1]).mean())
    for name, (row, _) in runs.items():
        row["token_agreement_vs_full"] = agree
        emit(row)
    for name, (row, _) in runs.items():
        if not (all(row["logits_bitwise_equal_eager"])
                and all(row["tokens_equal_eager"])):
            raise AssertionError(f"{phase} {name}: the replayed step "
                                 "differs from the eager one")
    return runs["sals"]


def sched_prompts(model):
    """8 requests sharing a 512-token system prompt, 4000 ... 640 tokens."""
    corpus = model["corpus"]
    system = corpus.batch(300, 1, 512)["tokens"][0]     # 8 pages of 64
    lens = [4000, 3584, 3072, 2560, 2048, 1536, 1024, 640]
    return [np.concatenate([system, corpus.batch(310 + i, 1, n - 512)
                            ["tokens"][0]]).astype(np.int32)
            for i, n in enumerate(lens)]


def phase_sched(torch, model, n_new: int = 32, prof: bool = False):
    """The serving entry point: ``RequestScheduler`` over the paged latent
    cache and over the dense slot arena, same requests, same weights; the
    tokens must be equal.  Every replayed decode step of the dense run is
    held against the eager step on a copy of the arena taken before it
    (``eager_step_check``): logits and arena bitwise equal, so both runs'
    tokens are the eager path's.  So is every chunk of the dense run's
    first request and of the paged run's first request resumed from a
    prefix entry, against the eager chunk on a copy of the prefill
    workspace (``eager_chunk_check``).  The checks' own seconds are left
    out of the wall time and step times.  Each run captures the chunk
    program once and replays it for every other chunk.  The
    chunked-prefill share of wall time is each chunk's time between two
    synchronizations.  Then one request's chunks in turns, eager and
    replayed (``chunk_turns``).  ``prof``: afterwards, torch.profiler
    passes over four chunks (chunks 8-11 of the 4000-token prompt),
    replayed and eager, and the host's issue time of a chunk."""
    from repro_torch.config import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, RequestScheduler, ServeEngine

    cfg, sals, params, proj = (model[k] for k in ("cfg", "sals", "params",
                                                  "proj"))
    n_sals = model["n_sals"]
    prompts = sched_prompts(model)
    lens = [len(p) for p in prompts]
    runs = {}
    for name, ps in (("paged", 64), ("dense", 0)):
        eng = ServeEngine(params, proj, cfg, ServeConfig(
            max_seq_len=4096, max_batch=4, prefill_chunk=64, page_size=ps,
            prefill_token_budget=512, sals=sals), device="cuda")
        checked = None if ps else eager_step_check(torch, eng)
        chunks = chunk_timer(torch, eng)
        upkeep = upkeep_timer(eng)
        # dense: the first request; paged: the first resumed from an entry
        chunk_check = eager_chunk_check(
            torch, eng, (lambda t: t.start_chunk > 0) if ps
            else (lambda t: True))
        sched = RequestScheduler(eng)
        reqs = [Request(p, max_new_tokens=n_new) for p in prompts]
        for r in reqs:
            sched.submit(r)
        ticks = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sched.run(on_step=lambda s_, step: ticks.append(
            (step, time.perf_counter())))
        torch.cuda.synchronize()
        spans = chunk_check["spans"] + (checked["spans"] if checked else [])

        def check_s(a=-np.inf, b=np.inf):   # the check's seconds in (a, b]
            return sum(sec for end, sec in spans if a < end <= b)

        wall = time.perf_counter() - t0 - check_s()
        counts = ops.launch_counts()
        # decode ms per step: on_step intervals of the iterations that ran
        # no prefill chunk (ledger step k-1 holds iteration k's chunks)
        chunk_steps = {c[0] for c in sched.prefill_chunks}
        gaps = [(t1 - t0_ - check_s(t0_, t1)) * 1e3 for (k0, t0_), (k1, t1)
                in zip(ticks, ticks[1:]) if k1 - 1 not in chunk_steps]
        toks = [r.result.tokens if r.done else None for r in reqs]
        n_tok = sum(len(t) for t in toks if t is not None)
        chunk_s = sum(sec for sec, _ in chunks)
        row = dict(phase="sched", run=name, prompts=lens, new_tokens=n_new,
                   wall_s=wall, tok_s=n_tok / wall,
                   decode_ms_per_step=statistics.median(gaps) if gaps
                   else None, decode_only_iterations=len(gaps),
                   decode_steps=sched.steps,
                   prefill_chunks=len(sched.prefill_chunks),
                   prefill_chunk_s=chunk_s,
                   prefill_share=chunk_s / wall,
                   **chunk_fields(f"sched {name}", eng, chunks),
                   eager_chunk_check={k: v for k, v in chunk_check.items()
                                      if k != "spans"},
                   **upkeep_fields(upkeep),
                   capture_s=eng._decode.capture_s,
                   graph_nodes=eng._decode.nodes,
                   graph_replays=eng._decode.replays,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   launches=counts, prefix_hits=sched.prefix_hits,
                   evictions=sched.evictions,
                   admission_stalls=sched.admission_stalls,
                   states=[r.state.value for r in reqs])
        if ps:
            row["pool_high_water_pages"] = max(
                g["pages_in_use"] for g in sched.pool_gauges)
            row["pool_pages"] = eng.scfg.pool_pages
        else:
            row["eager_step_check"] = {k: v for k, v in checked.items()
                                       if k != "spans"}
        row["eager_check_s"] = check_s()
        emit(row)
        if checked and not (checked["steps"] == sched.steps
                            == checked["logits_equal"]
                            == checked["cache_equal"]):
            raise AssertionError(f"sched {name}: replayed steps differ from "
                                 f"eager ones: {row['eager_step_check']}")
        if not 0 < chunk_check["chunks"] == chunk_check["equal"]:
            raise AssertionError(f"sched {name}: replayed chunks differ from "
                                 f"eager ones: {row['eager_chunk_check']}")
        if not all(r.done for r in reqs):
            raise AssertionError(f"sched {name}: not every request is DONE")
        sched.audit_serving_state()
        want = n_sals * sched.steps
        mine = ("latent_topk_paged", "sparse_recon_attention_paged") if ps \
            else ("latent_topk", "sparse_recon_attention")
        other = ("latent_topk", "sparse_recon_attention") if ps \
            else ("latent_topk_paged", "sparse_recon_attention_paged")
        if any(counts[k] != want for k in mine) or \
                any(counts[k] != 0 for k in other):
            raise AssertionError(f"sched {name}: SALS launches {counts}, "
                                 f"expected {want} of {mine} and no {other}")
        if ps and sched.prefix_hits < 1:
            raise AssertionError("sched paged: no prefix hit")
        runs[name] = (counts, toks, wall)
        del eng, sched, reqs
        gc.collect()
        torch.cuda.empty_cache()
    same = all(np.array_equal(a, b) for a, b in
               zip(runs["paged"][1], runs["dense"][1]))
    emit({"phase": "sched", "paged_tokens_equal_dense": same})
    if not same:
        raise AssertionError("sched: paged tokens differ from the dense "
                             "arena's")
    chunk_turns(torch, model, prompts[6])
    gc.collect()
    torch.cuda.empty_cache()
    if prof:
        profile_chunks(torch, model, prompts[0])
    return runs["paged"]


def profile_chunks(torch, model, prompt):
    """torch.profiler over four chunks (8-11) of ``prompt``, replayed and
    eager, on a fresh dense engine (tables to chiprun_out/); then the host's
    issue time of a chunk: the next 8 chunks back to back through
    ``prefill_chunk_step`` (one scheduler iteration's budget: host inputs
    staged, each stage waits for the previous call's copy), and one chunk
    replayed ten times with its inputs already on the card (each run
    writes the same bytes at the same positions); CUDA-event ms and host
    ms per call."""
    from repro_torch.config import ServeConfig
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(model["params"], model["proj"], model["cfg"],
                      ServeConfig(max_seq_len=4096, max_batch=4,
                                  prefill_chunk=64, sals=model["sals"]),
                      device="cuda")
    graph, eager = eng._prefill_chunk, eager_chunk_program(torch, eng)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(n, call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            call()
        end.record()
        host = time.perf_counter() - t0
        end.synchronize()
        return start.elapsed_time(end) / n, 1e3 * host / n

    with torch.inference_mode():
        for mode in ("graph", "eager"):
            eng._prefill_chunk = graph if mode == "graph" else eager
            task = eng.start_prefill(prompt)
            for _ in range(8):
                eng.prefill_chunk_step(task)
            torch.cuda.synchronize()
            profile_steps(torch, lambda t: eng.prefill_chunk_step(task), 4,
                          f"prefill_chunk_{mode}")
        eng._prefill_chunk = graph
        staged = timed(8, lambda: eng.prefill_chunk_step(task))
        c, j = eng.scfg.prefill_chunk, task.next_chunk
        inputs = [torch.as_tensor(np.asarray(a, np.int32), device="cuda")
                  for a in (task.tokens[:, j * c:(j + 1) * c], j * c,
                            [task.prompt_len])]
        on_card = timed(10, lambda: graph(*inputs, task.cache, task.scratch))
    emit({"phase": "profile", "run": "prefill_chunk_issue",
          "staged_back_to_back_ms_per_chunk": staged[0],
          "staged_host_ms_per_chunk": staged[1],
          "back_to_back_ms_per_replay": on_card[0],
          "host_ms_per_call": on_card[1], "nodes": graph.nodes})
    del eng, task
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the selection-quality path (paper Fig. 2 / Fig. 4)
# ---------------------------------------------------------------------------

QUALITY_RANK_LAYERS = (0, 1, 16, 31)


def phase_quality(torch, model, seq: int = 4096):
    """``metrics.overlap_score`` for every layer at position seq-1 of two
    ``SyntheticCorpus`` prompts, on the full-width model and its calibrated
    U_r: one ``latent_score`` launch per layer and prompt (counts zeroed
    just before, read just after; no ``latent_topk``).  Then each layer's
    kernel scores against the twin on the same CUDA tensors, and the
    effective rank before / after RoPE and ``latent_mse`` on
    QUALITY_RANK_LAYERS.  Random weights: these are not the paper's
    numbers."""
    from repro_torch.core import metrics
    from repro_torch.core import selection as sel
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import qkv_proj
    from repro_torch.models.layers import rmsnorm_apply

    cfg, sals, params, u = (model["cfg"], model["sals"], model["params"],
                            model["proj"]["u"])
    r_star = sals.score_rank(cfg.kv_dim)
    pos = seq - 1
    qs, ks = [], []                     # per prompt: per layer q, k_pre
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i in range(2):
            toks = torch.as_tensor(model["corpus"].batch(400 + i, 1, seq)
                                   ["tokens"], device="cuda")
            x, prefix_len = tf.embed_inputs(params, cfg, {"tokens": toks})
            positions = torch.arange(seq, device="cuda")[None, :]
            q_l, k_l = [], []
            for bp in params.blocks:
                h = rmsnorm_apply(bp.attn_norm, x[:, -1:], cfg.norm_eps)
                q_l.append(qkv_proj(bp.attn, h, cfg)[0][:, 0])  # (1,H,dh)
                x, _, ex = tf._block_fwd(bp, x, cfg, positions,
                                         prefix_len, True)
                k_l.append(ex["k_pre"])              # (1, S, Hkv, dh)
            qs.append(q_l)
            ks.append(k_l)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        overlap = [[float(metrics.overlap_score(qs[i][l], ks[i][l], u[l],
                                                cfg, sals, pos)[0])
                    for l in range(cfg.n_layers)] for i in range(2)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()

        # the kernel's scores against the twin, layer by layer (after the
        # counts were read: these launches compare, they do not count)
        errs = []
        for i in range(2):
            for l in range(cfg.n_layers):
                q_lat = sel.latent_query(sel.group_query(qs[i][l], cfg),
                                         u[l], r_star)
                k_lat = ks[i][l].reshape(1, seq, cfg.kv_dim).float() \
                    @ u[l].float()
                got = ops.latent_score(q_lat, k_lat)
                want = ref.latent_score_ref(q_lat, k_lat)
                errs.append(float((got - want).abs().max())
                            / max(float(want.abs().max()), 1e-30))
        ranks = {}
        for l in QUALITY_RANK_LAYERS:
            r_pre, r_post, _, _ = metrics.rank_pre_post_rope(
                ks[0][l][0].float(), cfg)
            ranks[l] = dict(rank_pre_rope=r_pre, rank_post_rope=r_post,
                            latent_mse=float(metrics.latent_mse(ks[0][l],
                                                                u[l])))
        torch.cuda.synchronize()
    want_n = cfg.n_layers * 2
    row = dict(phase="quality", prompts=2, seq=seq, pos=pos,
               note="random weights: not the paper's numbers",
               overlap_per_layer=[(a + b) / 2 for a, b in zip(*overlap)],
               overlap_per_prompt=overlap, setup_s=setup_s,
               overlap_wall_s=wall, launches=counts,
               max_rel_score_err_vs_twin=max(errs), tol=1e-5,
               rank_layers=ranks)
    emit(row)
    others = {k: v for k, v in counts.items() if k != "latent_score"}
    if counts["latent_score"] != want_n or any(others.values()):
        raise AssertionError(f"quality: launches {counts}, expected "
                             f"{want_n} of latent_score and nothing else")
    if max(errs) > 1e-5:
        raise AssertionError(f"quality: kernel vs twin {max(errs)}")
    flat = [v for o in overlap for v in o]
    if not all(0.0 < v <= 1.0 + 1e-6 for v in flat):
        raise AssertionError(f"quality: overlap out of (0, 1]: {flat}")
    del qs, ks
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the two-tier page pool under the sched traffic
# ---------------------------------------------------------------------------

def phase_tier(torch, model, untiered_tokens, untiered_wall: float,
               n_new: int = 32):
    """The sched phase's traffic, paged, through a TWO-TIER pool.  A first
    run with the hot tier as large as the pool measures each step's
    touched set (distinct pages the selection reconstructs from) and the
    peak of live pages.  The next run's hot tier is the largest touched
    set plus a pinned write page per slot, one slot to fetch into and 2
    more; if it never spills, one more run at the smallest safe size.
    Every run must give the untiered paged run's tokens (equal to the
    dense run's, which the sched phase held step by step to the eager
    path's) with zero evictions and a clean audit; the last must sit below
    the peak of live pages, spill and miss."""
    from repro_torch.config import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, RequestScheduler, ServeEngine

    cfg, sals, params, proj = (model[k] for k in ("cfg", "sals", "params",
                                                  "proj"))
    prompts = sched_prompts(model)
    # every prompt's prefix entry is kept (the sched phase keeps 4): the
    # finished prompts' pages stay live, which a host tier is for, so the
    # pool holds more live pages than the steps touch
    base = dict(max_seq_len=4096, max_batch=4, prefill_chunk=64,
                page_size=64, prefill_token_budget=512, sals=sals,
                prefix_cache_entries=len(prompts), audit_every=8)
    pool_pages = ServeConfig(**base).pool_pages

    def nbytes(tree) -> int:
        return sum(int(t.numel() * t.element_size())
                   for fl in tree.values() for t in fl.values())

    def run(hbm_pages):
        eng = ServeEngine(params, proj, cfg, ServeConfig(
            hbm_pages=hbm_pages, **base), device="cuda")
        stats = dict(decode_runs=0, max_touched=0, h2d_bytes=0,
                     d2h_bytes=0)
        decode_sel, load, read, extract = (eng.decode_sel, eng.load_page,
                                           eng.read_page_payload,
                                           eng.extract_page_payload_dense)

        def spy_decode(tokens, cache, positions):
            logits, cache, touched = decode_sel(tokens, cache, positions)
            table = next(iter(eng._latent_segs(cache).values())) \
                .page_table[0]
            pids = torch.unique(table[touched])
            stats["decode_runs"] += 1
            stats["max_touched"] = max(stats["max_touched"],
                                       int((pids > 0).sum()))
            return logits, cache, touched

        def spy_load(cache, slot, payload):
            stats["h2d_bytes"] += nbytes(payload)
            return load(cache, slot, payload)

        def spy_read(cache, slot):
            out = read(cache, slot)
            stats["d2h_bytes"] += nbytes(out)
            return out

        def spy_extract(one, page):
            out = extract(one, page)
            stats["d2h_bytes"] += nbytes(out)
            return out

        eng.decode_sel, eng.load_page = spy_decode, spy_load
        eng.read_page_payload = spy_read
        eng.extract_page_payload_dense = spy_extract
        chunks = chunk_timer(torch, eng)
        upkeep = upkeep_timer(eng)
        sched = RequestScheduler(eng)
        reqs = [Request(p, max_new_tokens=n_new) for p in prompts]
        for r in reqs:
            sched.submit(r)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        toks = [r.result.tokens if r.done else None for r in reqs]
        g = sched.pool_gauges
        row = dict(phase="tier", hbm_pages=hbm_pages, pool_pages=pool_pages,
                   wall_s=wall, untiered_wall_s=untiered_wall,
                   decode_steps=sched.steps,
                   reruns=stats["decode_runs"] - sched.steps,
                   max_touched_pages=stats["max_touched"],
                   peak_live_pages=max(x["pages_in_use"] for x in g),
                   host_high_water_pages=max(x["host_pages"] for x in g),
                   spills=sched.pool.spills, fetches=sched.pool.fetches,
                   fetch_hits=sched.fetch_hits,
                   prefetch_hits=sched.prefetch_hits,
                   cold_misses=sched.cold_misses, evictions=sched.evictions,
                   failures=sched.failures,
                   pcie_h2d_bytes=stats["h2d_bytes"],
                   pcie_d2h_bytes=stats["d2h_bytes"],
                   prefill_chunks=len(chunks),
                   prefill_chunk_s=sum(sec for sec, _ in chunks),
                   **chunk_fields(f"tier {hbm_pages}", eng, chunks),
                   **upkeep_fields(upkeep),
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   launches=counts,
                   tokens_equal_untiered=all(
                       a is not None and np.array_equal(a, b)
                       for a, b in zip(toks, untiered_tokens)),
                   graph_replays=eng._decode_sel.replays,
                   capture_s=eng._decode_sel.capture_s,
                   states=[r.state.value for r in reqs])
        sched.audit_serving_state()
        del eng, sched, reqs
        gc.collect()
        torch.cuda.empty_cache()
        return row

    big = run(pool_pages)
    emit(big)
    # a step fits when its touched pages, the pinned write pages and one
    # slot to fetch into are hot: the smallest safe tier is touched + B + 1;
    # two slots more first, the smallest if that one never has to spill
    page_bytes = cache_page_bytes(cfg, sals, base["page_size"], model)
    need = big["max_touched_pages"] + base["max_batch"] + 1
    rows = [big]
    for hot in (need + 2, need):
        small = run(min(hot, pool_pages))
        small["hot_tier_below_peak_live"] = hot < big["peak_live_pages"]
        # device bytes of the payload pools this hot tier does not hold
        # (the score pool it adds shows in max_memory_allocated)
        small["payload_bytes_per_page"] = page_bytes
        small["payload_pool_bytes_saved"] = (pool_pages - hot) * page_bytes
        emit(small)
        rows.append(small)
        if small["spills"] > 0:
            break
    for row in rows:
        if not (row["tokens_equal_untiered"] and row["evictions"] == 0
                and row["failures"] == 0):
            raise AssertionError(f"tier {row['hbm_pages']}: tokens / "
                                 "evictions / failures")
        # every run of a step (reruns too) goes through both paged kernels
        # on the score pool / hot table, once per SALS layer
        want = model["n_sals"] * (row["decode_steps"] + row["reruns"])
        mine = ("latent_topk_paged", "sparse_recon_attention_paged")
        if any(row["launches"][k] != want for k in mine) or any(
                v for k, v in row["launches"].items() if k not in mine):
            raise AssertionError(f"tier {row['hbm_pages']}: launches "
                                 f"{row['launches']}, expected {want} of "
                                 f"{mine} and nothing else")
    if not (small["hot_tier_below_peak_live"] and small["spills"] > 0
            and small["cold_misses"] > 0):
        raise AssertionError("tier: the small hot tier did not engage")
    return small


def cache_page_bytes(cfg, sals, page_size: int, model) -> int:
    """Payload bytes (full-r latents + quantized V) of one page over every
    SALS layer, from ``cache_bytes_per_token``."""
    from repro_torch.core.latent_cache import cache_bytes_per_token
    return int(cache_bytes_per_token(cfg, sals) * page_size
               * model["n_sals"])


# ---------------------------------------------------------------------------
# phase 6: speculative decode through the verify window
# ---------------------------------------------------------------------------

SPEC_Q = 4


def check_spec_launches(name, counts, rounds, n_sals, paged: bool):
    """A speculative run launches, per verify round, one window kernel and
    one top-k of its layout per SALS layer, and no single-token recon."""
    win = "sparse_recon_attention_window" + ("_paged" if paged else "")
    other = "sparse_recon_attention_window" + ("" if paged else "_paged")
    topk = "latent_topk" + ("_paged" if paged else "")
    want = n_sals * rounds
    bad = (counts[win] != want or counts[topk] != want or counts[other]
           or counts["sparse_recon_attention"]
           or counts["sparse_recon_attention_paged"])
    if bad:
        raise AssertionError(f"spec {name}: launches {counts}, expected "
                             f"{want} of {win} and {topk}, no {other} and "
                             "no single-token recon")


def window_vs_step(torch, cfg, params, proj, sals, prompts, forced, q,
                   max_seq, controls: bool = False):
    """Teacher-forced logits of one verify window (the first q forced
    tokens at the prompts' ends) against q sequential decode steps on the
    same tokens: max |window - step| over max |step|, per window slot.
    ``controls``: also a one-query window against the first step, and the
    first step at batch 4·B (each row repeated) against batch B — the
    shape-only difference the card's GEMMs show at the same inputs."""
    from repro_torch.models import transformer as tf

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    lens = [len(p) for p in prompts]
    toks = np.stack([np.pad(p, (0, max(lens) - len(p))) for p in prompts])

    def prefill(rep=1):
        pos = torch.tensor(lens * rep, dtype=torch.int32, device="cuda")
        batch = {"tokens": torch.as_tensor(np.tile(toks, (rep, 1)),
                                           device="cuda")}
        return pos, tf.prefill(params, proj, cfg, sals, batch, max_seq,
                               lengths=pos)[1]

    out = {}
    with torch.inference_mode():
        pos, c_seq = prefill()
        _, c_win = prefill()
        wt = torch.as_tensor(forced[:, :q], device="cuda")
        steps = [tf.decode_step(params, proj, c_seq, wt[:, t], pos + t, cfg,
                                sals)[0] for t in range(q)]
        win, _ = tf.decode_window(params, proj, c_win, wt, pos, cfg, sals)
        out["window_vs_step_max_rel_logit_err"] = [
            rel(win[:, t], steps[t]) for t in range(q)]
        if controls:
            # the SALS caches are untouched by the window and query 0 sees
            # no full-layer position past pos: c_win still serves a window
            # at pos
            one, _ = tf.decode_window(params, proj, c_win, wt[:, :1], pos,
                                      cfg, sals)
            out["q1_window_vs_step_rel_err"] = rel(one[:, 0], steps[0])
            del c_seq, c_win
            pos4, c4 = prefill(4)
            wide, _ = tf.decode_step(params, proj, c4, wt[:, 0].repeat(4),
                                     pos4, cfg, sals)
            out["batch4x_vs_batch_step_rel_err"] = rel(wide[:len(lens)],
                                                       steps[0])
    return out


def phase_spec(torch, model, serve_sals, n_new: int = 32,
               prof: bool = False):
    """(a) saturated regime, bf16 through ``generate`` /
    ``generate_speculative``: every selectable position is selected, so the
    window's one selection is exact; the token agreement and the window's
    per-slot logit error against teacher-forced steps are reported, beside
    two controls of the card's shape-dependent bf16 rounding.  (c)
    exactness: the scheduler in float32 (the same weights and U_r; chunked
    prefill, so no bf16-only flash kernel), paged and dense arena, must
    give the sequential scheduler's tokens on the same saturated requests,
    with exact launch counts.  (b) the serve phase's long prompts (bf16):
    the cost of a round and the tokens it commits, beside that phase's
    sequential decode.  Every decode entry replays its step program; the
    eager side (``eager_entries``) must give the same tokens: (a) and (b)
    run ``generate_speculative`` eagerly too, and (c)'s sequential
    scheduler runs eagerly.  ``prof``: a torch.profiler pass over three
    verify rounds (window forward + commit of one token) at the (b)
    shapes, replayed and eager."""
    from repro_torch.config import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Request, RequestScheduler, ServeEngine

    cfg, sals, params, proj = (model[k] for k in ("cfg", "sals", "params",
                                                  "proj"))
    n_sals, corpus = model["n_sals"], model["corpus"]
    q = SPEC_Q
    out = {}

    # ---- (a) saturated, bf16: prompts 300-420 tokens from a repeated base -
    base = corpus.batch(500, 1, 60)["tokens"][0]
    lens = [300, 340, 380, 420]
    prompts = [np.tile(base, 8)[:n].astype(np.int32) for n in lens]
    selectable = max(lens) + n_new - sals.n_recent - sals.n_sink + 1
    if selectable > sals.n_critical:
        raise AssertionError("spec (a): prompts too long to saturate")
    scfg = dict(max_seq_len=512, max_batch=4, sals=sals)
    seq = ServeEngine(params, proj, cfg, ServeConfig(**scfg), device="cuda")
    want = np.stack([r.tokens for r in seq.generate(prompts,
                                                    max_new_tokens=n_new)])
    eng = ServeEngine(params, proj, cfg, ServeConfig(spec_window=q, **scfg),
                      device="cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = np.stack([r.tokens for r in eng.generate_speculative(
        prompts, max_new_tokens=n_new)])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check_spec_launches("saturated", counts, eng.spec_stats["rounds"],
                        n_sals, paged=False)
    eager = np.stack([r.tokens for r in eager_entries(torch, ServeEngine(
        params, proj, cfg, ServeConfig(spec_window=q, **scfg),
        device="cuda")).generate_speculative(prompts,
                                             max_new_tokens=n_new)])
    row = dict(phase="spec", run="saturated_bf16", prompts=lens,
               new_tokens=n_new, q=q, selectable_max=selectable,
               n_critical=sals.n_critical,
               tokens_equal_sequential=bool(np.array_equal(got, want)),
               tokens_equal_eager=bool(np.array_equal(got, eager)),
               token_agreement=float((got == want).mean()),
               first_divergence=[int(np.argmax(g != w)) if (g != w).any()
                                 else None for g, w in zip(got, want)],
               launches=counts, **eng.spec_stats,
               **window_vs_step(torch, cfg, params, proj, sals, prompts, want,
                                q, 512, controls=True))
    emit(row)
    if not (got.shape == want.shape and (got >= 0).all()
            and (got < cfg.vocab_size).all()):
        raise AssertionError("spec (a): generated tokens out of range")
    if not row["tokens_equal_eager"]:
        raise AssertionError("spec (a): replayed windows give other tokens "
                             "than eager ones")
    del seq, eng
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tf.Transformer(cfg32, device="cuda")
    p32.load_state_dict(params.state_dict())       # bf16 values, exactly

    # ---- (c) the scheduler, paged and dense, vs the sequential scheduler --
    system = corpus.batch(600, 1, 256)["tokens"][0]     # 4 pages of 64
    suffix = [64, 160, 96, 128, 80, 144, 112, 72]
    prompts = [np.concatenate([system, corpus.batch(610 + i, 1, n)
                               ["tokens"][0]]).astype(np.int32)
               for i, n in enumerate(suffix)]
    runs = {}
    for name, ps, spec in (("sequential", 64, 0), ("paged", 64, q),
                           ("dense", 0, q)):
        eng = ServeEngine(p32, proj, cfg32, ServeConfig(
            max_seq_len=512, max_batch=4, prefill_chunk=64, page_size=ps,
            prefill_token_budget=512, sals=sals, spec_window=spec,
            audit_every=16), device="cuda")
        if not spec:        # the reference stream: eager, sequential
            eager_entries(torch, eng)
        chunks = chunk_timer(torch, eng)
        sched = RequestScheduler(eng)
        reqs = [Request(p, max_new_tokens=n_new) for p in prompts]
        for r in reqs:
            sched.submit(r)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        toks = [r.result.tokens if r.done else None for r in reqs]
        row = dict(phase="spec", run=f"sched_{name}_float32", q=spec,
                   eager=not spec,
                   prompts=[len(p) for p in prompts], new_tokens=n_new,
                   wall_s=wall, steps=sched.steps,
                   spec_rounds=sched.spec_rounds,
                   spec_proposed=sched.spec_proposed,
                   spec_accepted=sched.spec_accepted,
                   spec_committed=sched.spec_committed,
                   prefill_chunks=len(sched.prefill_chunks),
                   prefill_chunk_s=sum(sec for sec, _ in chunks),
                   **chunk_fields(f"spec sched {name}", eng, chunks),
                   prefix_hits=sched.prefix_hits, launches=counts,
                   states=[r.state.value for r in reqs])
        emit(row)
        if not all(r.done for r in reqs):
            raise AssertionError(f"spec sched {name}: not every request is "
                                 "DONE")
        sched.audit_serving_state()
        if spec:
            check_spec_launches(f"sched {name}", counts, sched.spec_rounds,
                                n_sals, paged=bool(ps))
            if sched.spec_rounds != sched.steps:
                raise AssertionError(f"spec sched {name}: a decode step ran "
                                     "outside a verify window")
        runs[name] = (toks, counts)
        del eng, sched, reqs
        gc.collect()
        torch.cuda.empty_cache()
    same = {k: all(np.array_equal(a, b) for a, b in
                   zip(runs[k][0], runs["sequential"][0]))
            for k in ("paged", "dense")}
    emit({"phase": "spec", "sched_tokens_equal_sequential": same})
    if not all(same.values()):
        raise AssertionError(f"spec sched: tokens differ from the "
                             f"sequential scheduler's: {same}")
    out["paged"] = runs["paged"][1]
    del p32
    torch.cuda.empty_cache()

    # ---- (b) long context: the serve phase's prompts, bf16 ---------------
    lens = [4096, 3584, 3072, 2560]
    prompts = [corpus.batch(100 + i, 1, n)["tokens"][0]
               for i, n in enumerate(lens)]
    long_cfg = ServeConfig(max_seq_len=4160, max_batch=4, sals=sals,
                           spec_window=q)
    eager_eng = eager_entries(torch, ServeEngine(params, proj, cfg, long_cfg,
                                                 device="cuda"))
    ops.reset_launch_counts()
    eager = np.stack([r.tokens for r in eager_eng.generate_speculative(
        prompts, max_new_tokens=n_new)])
    torch.cuda.synchronize()
    eager_counts, eager_tm = ops.launch_counts(), eager_eng.last_timing
    del eager_eng
    eng = ServeEngine(params, proj, cfg, long_cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = eng.generate_speculative(prompts, max_new_tokens=n_new)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    st, tm = eng.spec_stats, eng.last_timing
    check_spec_launches("long", counts, st["rounds"], n_sals, paged=False)
    toks = np.stack([r.tokens for r in res])
    row_rounds = st["proposed"] / (q - 1)
    # every row has more than N_c selectable positions: all slots valid
    if min(lens) - sals.n_recent - sals.n_sink < sals.n_critical:
        raise AssertionError("spec (b): prompts too short for a full N_c")
    win_ms, win_by = window_bound(
        4, q, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        sals.rank(cfg.kv_dim), sals.n_critical, 4 * sals.n_critical, 2,
        sals.k_latent_dtype == "int8", sals.v_bits)
    seq_row = serve_sals[0] if serve_sals else {}
    row = dict(phase="spec", run="long", prompts=lens, new_tokens=n_new, q=q,
               rounds=st["rounds"], acceptance=st["accepted_drafts"]
               / max(1, st["proposed"]),
               committed_per_row_round=st["committed"] / row_rounds,
               committed_per_round=st["committed"] / st["rounds"],
               ms_per_round=1e3 * tm["decode_s"] / st["rounds"],
               eager_ms_per_round=1e3 * eager_tm["decode_s"]
               / eager_tm["rounds"],
               capture_s=tm["capture_s"],
               graph_nodes=[eng._decode_window.nodes,
                            eng._commit_window.nodes],
               tokens_equal_eager=bool(np.array_equal(toks, eager)),
               eager_launches_equal=eager_counts == counts,
               decode_tok_s=st["committed"] / tm["decode_s"],
               prefill_s=tm["prefill_s"],
               sequential_decode_ms_per_step=seq_row.get(
                   "decode_ms_per_step"),
               sequential_decode_tok_s=seq_row.get("decode_tok_s"),
               token_agreement_vs_sequential=float(
                   (toks == serve_sals[1]).mean()) if serve_sals else None,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               window_bound_ms=win_ms, window_bound_by=win_by,
               window_bound_ms_per_committed_token=win_ms * st["rounds"]
               / st["committed"], launches=counts)
    emit(row)
    if not (toks.shape == (4, n_new) and (toks >= 0).all()
            and (toks < cfg.vocab_size).all()):
        raise AssertionError("spec (b): generated tokens out of range")
    if not (row["tokens_equal_eager"] and row["eager_launches_equal"]):
        raise AssertionError("spec (b): replayed rounds differ from eager "
                             "ones")
    out["long"] = (row, counts)
    if prof:
        with torch.inference_mode():
            pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
            toks = np.zeros((4, max(lens)), np.int32)
            for i, p in enumerate(prompts):
                toks[i, :len(p)] = p
            _, cache = tf.prefill(params, proj, cfg, sals, {"tokens":
                                  torch.as_tensor(toks, device="cuda")},
                                  4160, lengths=pos)
            wt = torch.ones((4, q), dtype=torch.int32, device="cuda")
            one = torch.ones(4, dtype=torch.int32, device="cuda")

            def rnd(t, graph):
                if graph:
                    lg, aux = eng.decode_window(wt, cache, pos + t)
                    eng.commit_window(cache, aux, pos + t, one)
                else:
                    lg, aux = tf.decode_window(params, proj, cache, wt,
                                               pos + t, cfg, sals)
                    tf.commit_window(proj, cache, aux, pos + t, one, cfg,
                                     sals)
                lg.argmax(-1).cpu()     # the host read that ends a round

            for graph in (True, False):
                rnd(0, graph)
                torch.cuda.synchronize()
                profile_steps(torch, lambda t: rnd(1 + t, graph), 3,
                              "verify_round_" + ("graph" if graph
                                                 else "eager"))
            del cache
    del eng, res
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase: SLO scheduling (priority preemption, park / resume, evict) and
# temperature sampling
# ---------------------------------------------------------------------------

SLO_LOW, SLO_HIGH, SLO_NEW, SLO_PS = 1536, 512, 32, 64


def slo_traffic(model):
    """Four batch requests of 1,536 tokens, then two interactive ones of
    512 (a chat front end whose interactive requests must cut ahead)."""
    corpus = model["corpus"]
    return ([corpus.batch(400 + i, 1, SLO_LOW)["tokens"][0]
             for i in range(4)],
            [corpus.batch(410 + i, 1, SLO_HIGH)["tokens"][0]
             for i in range(2)])


def slo_run(torch, model, name, classes, policy, page_size=SLO_PS,
            hbm_pages=0) -> dict:
    """One scheduler run of the slo traffic: the four low-priority
    requests submitted first, the two priority-1 ones through ``on_step``
    once all four are decoding (priority 0 when ``classes`` is 1).  Every
    park and resume is timed between two synchronizations, with its
    snapshot's bytes; each request's chunks (``chunk_timer``, in the order
    of ``prefill_chunks``) give an evicted victim's re-prefill seconds;
    the high-priority requests' wait runs from their submission to their
    first token.  Tiered: each step, every parked record's exclusively
    parked pages that are cold and its pages that are pinned."""
    from repro_torch.config import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, RequestScheduler, ServeEngine

    cfg, sals, params, proj = (model[k] for k in ("cfg", "sals", "params",
                                                  "proj"))
    low_p, high_p = slo_traffic(model)
    eng = ServeEngine(params, proj, cfg, ServeConfig(
        max_seq_len=4096, max_batch=4, prefill_chunk=64,
        prefill_token_budget=512, page_size=page_size, hbm_pages=hbm_pages,
        audit_every=1, priority_classes=classes, preempt_policy=policy,
        sals=sals), device="cuda")
    chunks = chunk_timer(torch, eng)
    moves = {"park": [], "resume": []}
    decode_runs = [0]

    def timed(kind, fn):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            snap = out if kind == "park" else args[2]
            moves[kind].append((time.perf_counter() - t0, sum(
                t.numel() * t.element_size()
                for fl in snap.values() for t in fl.values())))
            return out
        return call

    eng.detach_slot = timed("park", eng.detach_slot)
    eng.attach_slot = timed("resume", eng.attach_slot)
    for entry in ("decode", "decode_sel"):
        def counted(*args, _fn=getattr(eng, entry)):
            decode_runs[0] += 1
            return _fn(*args)
        setattr(eng, entry, counted)
    sched = RequestScheduler(eng)
    low = [Request(p, max_new_tokens=SLO_NEW) for p in low_p]
    first_tok = {}
    high = [Request(p, max_new_tokens=SLO_NEW, priority=min(1, classes - 1),
                    on_token=lambda t, i, k=k: first_tok.setdefault(
                        k, time.perf_counter()))
            for k, p in enumerate(high_p)]
    submitted = {}
    parked_log = []

    def on_step(sch, step):
        if not submitted and sum(r.state.value == "decoding"
                                 for r in low) == 4:
            for r in high:
                sch.submit(r)
            submitted.update(step=step, t=time.perf_counter())
        if sch.tiered:
            pool = sch.pool
            for rec in sch.parked:
                excl = [p for p in rec.ptab.pages if pool.refcount(p)
                        == rec.ptab.pages.count(p)]
                parked_log.append((sum(p in pool.cold for p in excl),
                                   sum(bool(pool.pins.get(p))
                                       for p in rec.ptab.pages)))

    for r in low:
        sched.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sched.run(on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    reqs = low + high
    if not submitted or not all(r.done for r in reqs):
        raise AssertionError(f"slo {name}: {[r.state.value for r in reqs]}")
    per_req = {}
    for (_s, rid, _c, _n), (sec, _rep) in zip(sched.prefill_chunks, chunks):
        per_req.setdefault(rid, []).append(sec)
    n_first = -(-SLO_LOW // 64)
    admitted = {}
    for step, _slot, rid in sched.admissions:
        admitted.setdefault(rid, step)
    graph = eng._decode_sel if hbm_pages else eng._decode
    row = dict(
        phase="slo", run=name, priority_classes=classes, policy=policy,
        page_size=page_size, hbm_pages=hbm_pages, wall_s=wall,
        decode_steps=sched.steps, decode_runs=decode_runs[0],
        parks=sched.parks, resumes=sched.resumes,
        preemptions=sched.preemptions, evictions=sched.evictions,
        low_chunks=[len(per_req[r.req_id]) for r in low],
        high_wait_steps=[admitted[r.req_id] - submitted["step"]
                         for r in high],
        high_wait_ms=[1e3 * (first_tok[k] - submitted["t"])
                      for k in range(len(high))],
        park_ms=[1e3 * s for s, _ in moves["park"]],
        resume_ms=[1e3 * s for s, _ in moves["resume"]],
        park_bytes=[b for _, b in moves["park"]],
        resume_bytes=[b for _, b in moves["resume"]],
        reprefill_s=[sum(per_req[r.req_id][n_first:]) for r in low
                     if len(per_req[r.req_id]) > n_first],
        decode_graph=dict(captures=graph.captures, replays=graph.replays,
                          nodes=graph.nodes),
        **chunk_fields(f"slo {name}", eng, chunks),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=counts)
    if page_size:
        row["pool_high_water_pages"] = max(
            g["pages_in_use"] for g in sched.pool_gauges)
        row["pool_pages"] = eng.scfg.pool_pages
    if hbm_pages:
        row.update(spills=sched.pool.spills, fetches=sched.pool.fetches,
                   cold_misses=sched.cold_misses,
                   parked_pages_cold_max=max((c for c, _ in parked_log),
                                             default=0),
                   parked_pages_pinned_max=max((p for _, p in parked_log),
                                               default=0))
    sched.audit_serving_state()
    emit(row)
    # the layout's SALS kernels once per SALS layer and decode run (the
    # tiered reruns too), nothing else
    mine = ("latent_topk_paged", "sparse_recon_attention_paged") \
        if page_size else ("latent_topk", "sparse_recon_attention")
    want = model["n_sals"] * decode_runs[0]
    if any(counts[k] != want for k in mine) or any(
            v for k, v in counts.items() if k not in mine):
        raise AssertionError(f"slo {name}: launches {counts}, expected "
                             f"{want} of {mine} and nothing else")
    if graph.captures != 1:
        raise AssertionError(f"slo {name}: {graph.captures} decode "
                             "captures")
    toks = [r.result.tokens for r in reqs]
    del eng, sched, reqs, low, high
    gc.collect()
    torch.cuda.empty_cache()
    return row, toks


def slo_sampling(torch, model, n_draws: int = 65536, vocab: int = 256,
                 temperature: float = 0.7) -> dict:
    """Temperature sampling on the card: ``generate`` at ``temperature``
    on four 1,024-token prompts (32 new tokens) twice with one seed and
    once with another (the first call's seconds beside a greedy engine's
    first call); ``_sample`` over ``n_draws`` rows of fixed
    (·, ``vocab``) logits against ``softmax(logits / T)`` by a chi-square
    test (ids expected fewer than 5 times share a bin); and temperature 0
    against the plain argmax."""
    from repro_torch.config import ServeConfig
    from repro_torch.serve import ServeEngine

    cfg, sals, params, proj = (model[k] for k in ("cfg", "sals", "params",
                                                  "proj"))
    prompts = [model["corpus"].batch(420 + i, 1, 1024)["tokens"][0]
               for i in range(4)]

    def engine(t, seed=0):
        return ServeEngine(params, proj, cfg, ServeConfig(
            max_seq_len=1088, max_batch=4, sals=sals, temperature=t,
            seed=seed), device="cuda")

    def gen(eng):
        return np.stack([r.tokens for r in eng.generate(
            prompts, max_new_tokens=SLO_NEW)])

    eng = engine(temperature)
    t0 = time.perf_counter()
    a = gen(eng)
    gen_s = time.perf_counter() - t0
    b = gen(eng)
    c = gen(engine(temperature, seed=1))
    # the sampler alone: draws of fixed logits on the card
    g = torch.Generator(device=eng.device)
    g.manual_seed(5)
    rows = 4
    logits = 2.0 * torch.randn(rows, vocab, generator=g, device=eng.device)
    tiled = logits.repeat_interleave(n_draws // rows, dim=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draws = eng._sample(tiled)
    torch.cuda.synchronize()
    sample_ms = 1e3 * (time.perf_counter() - t0)
    draws = draws.view(rows, -1)
    probs = torch.softmax(logits.double() / temperature, dim=-1)
    pvals = []
    for i in range(rows):
        obs = torch.bincount(draws[i].long(), minlength=vocab).double()
        exp = probs[i] * draws.shape[1]
        small = exp < 5
        obs = torch.cat([obs[~small], obs[small].sum()[None]])
        exp = torch.cat([exp[~small], exp[small].sum()[None]])
        stat = ((obs - exp) ** 2 / exp).sum()
        dof = len(exp) - 1
        pvals.append(float(torch.special.gammaincc(
            torch.tensor(dof / 2.0, dtype=torch.float64),
            stat.cpu() / 2.0)))
    greedy = engine(0.0)
    t0 = time.perf_counter()
    z = gen(greedy)
    greedy_s = time.perf_counter() - t0
    greedy._sample = lambda l: torch.argmax(l, dim=-1).to(torch.int32)
    plain = gen(greedy)
    row = dict(phase="slo", run="sampling", temperature=temperature,
               prompts=[1024] * 4, new_tokens=SLO_NEW,
               generate_s=gen_s, greedy_generate_s=greedy_s,
               same_seed_equal=bool(np.array_equal(a, b)),
               other_seed_differs=not np.array_equal(a, c),
               other_seed_agreement=float((a == c).mean()),
               draws=n_draws, vocab=vocab, chi2_p=pvals,
               sample_ms=sample_ms,
               greedy_equal_argmax=bool(np.array_equal(z, plain)),
               sampled_agreement_with_greedy=float((a == z).mean()))
    emit(row)
    del eng, greedy
    gc.collect()
    torch.cuda.empty_cache()
    if not (row["same_seed_equal"] and row["other_seed_differs"]
            and min(pvals) > 1e-3 and row["greedy_equal_argmax"]):
        raise AssertionError(f"slo sampling: {row}")
    return row


def phase_slo(torch, model) -> dict:
    """The scheduler's SLO half at full width: (a) the six requests in one
    class on the paged pool (the gold tokens); (b) two classes, park; (c)
    two classes, evict; (d) two classes, park, on a two-tier pool whose
    hot tier holds every resident's pages, its pins and a fetch slot but
    not the peak of live pages; (e) the dense arena, evict.  Every run's
    tokens must equal (a)'s; park parks and resumes each victim with no
    re-prefill, evict re-prefills; (d) spills parked pages cold and pins
    none.  Then temperature sampling (``slo_sampling``)."""
    gold_row, gold = slo_run(torch, model, "a_one_class", 1, "none")
    rows = {"a_one_class": gold_row}
    pages_low = -(-(SLO_LOW + SLO_NEW) // SLO_PS)
    hot = 4 * pages_low + 4 + 1 + 2
    for name, classes, policy, ps, hbm in (
            ("b_park", 2, "park", SLO_PS, 0),
            ("c_evict", 2, "evict", SLO_PS, 0),
            ("d_tiered_park", 2, "park", SLO_PS, hot),
            ("e_dense_evict", 2, "evict", 0, 0)):
        row, toks = slo_run(torch, model, name, classes, policy, ps, hbm)
        row["tokens_equal_a"] = all(np.array_equal(x, y)
                                    for x, y in zip(toks, gold))
        rows[name] = row
        emit({"phase": "slo", "run": name,
              "tokens_equal_a": row["tokens_equal_a"]})
    n_first = -(-SLO_LOW // 64)
    for name, row in rows.items():
        if name == "a_one_class":
            continue
        if not row["tokens_equal_a"]:
            raise AssertionError(f"slo {name}: tokens differ from (a)'s")
        if row["policy"] == "park":
            if not (row["parks"] >= 1 and row["resumes"] == row["parks"]
                    and row["preemptions"] >= 1 and row["evictions"] == 0
                    and row["low_chunks"] == [n_first] * 4):
                raise AssertionError(f"slo {name}: parks / resumes / "
                                     f"chunks {row}")
        elif not (row["preemptions"] >= 1 and row["parks"] == 0
                  and sum(row["low_chunks"]) > 4 * n_first):
            raise AssertionError(f"slo {name}: evict did not re-prefill "
                                 f"{row}")
    d = rows["d_tiered_park"]
    if not (d["parked_pages_cold_max"] > 0
            and d["parked_pages_pinned_max"] == 0
            and hot < d["pool_high_water_pages"]):
        raise AssertionError(f"slo d_tiered_park: parked pages not spilled "
                             f"cold, pinned, or hot tier not below the "
                             f"live peak: {d}")
    rows["sampling"] = slo_sampling(torch, model)
    return rows, gold


# ---------------------------------------------------------------------------
# phase: telemetry (the metrics registry, the span tracer, the byte
# accountant) on the serving path
# ---------------------------------------------------------------------------

SYNC_WARNING = "synchronizing"      # torch's sync-debug warning text


def obs_sched_run(torch, model, prompts, on: bool, n_new: int = 32,
                  name: str = "") -> dict:
    """One paged scheduler run of ``prompts``, telemetry ``on`` or off
    (installed before the scheduler is built), audited every step.
    Counts the synchronizing CUDA calls of ``run`` under
    ``torch.cuda.set_sync_debug_mode("warn")`` and the launches; the wall
    time runs from ``run`` to the synchronization after it."""
    from repro_torch import obs
    from repro_torch.config import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, RequestScheduler, ServeEngine
    from repro_torch.serve import step_graph

    cfg, sals, params, proj = (model[k] for k in ("cfg", "sals", "params",
                                                  "proj"))
    eng = ServeEngine(params, proj, cfg, ServeConfig(
        max_seq_len=4096, max_batch=4, prefill_chunk=64, page_size=64,
        prefill_token_budget=512, audit_every=1, sals=sals), device="cuda")
    handles = obs.enable(cfg=cfg, sals=sals, with_traffic=True) if on \
        else None
    try:
        sched = RequestScheduler(eng)
        reqs = [Request(p, max_new_tokens=n_new) for p in prompts]
        for r in reqs:
            sched.submit(r)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        step_graph.reset_program_stats()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                sched.run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
        row = dict(phase="obs", run=name or ("on" if on else "off"),
                   wall_s=wall,
                   decode_steps=sched.steps,
                   prefill_chunks=len(sched.prefill_chunks),
                   sync_calls=syncs,
                   decode_captures=eng._decode.captures,
                   chunk_captures=eng._prefill_chunk.captures,
                   launches={k: v for k, v in counts.items() if v},
                   programs={k: program_medians(k) for k in
                             ("decode", "prefill_chunk")},
                   states=[r.state.value for r in reqs])
        if not all(r.done for r in reqs):
            raise AssertionError(f"obs {row['run']}: {row['states']}")
        if not (row["decode_captures"] == row["chunk_captures"] == 1):
            raise AssertionError(f"obs {row['run']}: captures {row}")
        want = model["n_sals"] * sched.steps
        if any(counts[k] != want for k in ("latent_topk_paged",
                                           "sparse_recon_attention_paged")):
            raise AssertionError(f"obs {row['run']}: launches {counts}, "
                                 f"expected {want} of each paged kernel")
        if handles is not None:
            row.update(obs_checks(sched, handles))
        toks = [r.result.tokens for r in reqs]
    finally:
        if handles is not None:
            obs.disable()
    del eng, sched, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return row, toks


def program_medians(name: str) -> dict:
    """The median ms a call of step program ``name`` spends in each host
    phase and a replay on the device (``serve/step_graph.py``'s own
    records), with its calls and untimed replays."""
    from repro_torch.serve import step_graph
    st = step_graph.program_stats(name)
    if st is None:
        return {}
    out = {k[:-2] + "_ms": statistics.median(r[k] for r in st["host"])
           * 1e3 for k in ("stage_s", "key_s", "launch_s")}
    if st["device"]:
        out["device_ms"] = statistics.median(
            r["device_s"] for r in st["device"]) * 1e3
    return dict(out, calls=st["calls"], untimed=st["untimed"])


def obs_checks(sched, handles) -> dict:
    """The telemetry of a finished run: the byte ledger reconciled on
    every decode step with zero drift, spans balanced with no open track
    and a valid Chrome trace, both metric exports valid, requests
    conserved.  Returns the figures (median span ms by name, bytes by
    term); writes the trace and the exports to ``chiprun_out/``."""
    from repro_torch.obs.metrics import (snapshot_to_json,
                                         validate_prometheus,
                                         validate_snapshot)
    from repro_torch.obs.trace import validate_chrome_trace
    reg, tr, acct = (handles[k] for k in ("registry", "tracer", "traffic"))
    rep = acct.report()
    trace = tr.chrome_trace()
    snap = reg.snapshot()
    prom = reg.to_prometheus()
    errs = dict(trace=validate_chrome_trace(trace),
                snapshot=validate_snapshot(snap),
                prometheus=validate_prometheus(prom))
    spans = {}
    for ev in tr.events:
        spans.setdefault(ev["name"], []).append(1e3 * (ev["t1"] - ev["t0"]))
    conserved = sched.submitted == (sched.done + sched.failures
                                    + sched.timeouts + sched.cancellations)
    out = dict(drifts=rep["drifts"], reconciled=rep["reconciled"],
               spans_balanced=tr.balanced(), open_tracks=tr.open_tracks(),
               spans=tr.ended, conserved=conserved,
               export_errors={k: v[:3] for k, v in errs.items() if v},
               span_ms_median={k: statistics.median(v)
                               for k, v in sorted(spans.items())},
               span_counts={k: len(v) for k, v in sorted(spans.items())},
               measured_bytes=rep["measured"], modeled_bytes=rep["modeled"])
    (OUT_DIR / "obs_trace.json").write_text(json.dumps(trace))
    (OUT_DIR / "obs_metrics.json").write_text(snapshot_to_json(reg))
    (OUT_DIR / "obs_metrics.prom").write_text(prom)
    if not (rep["drifts"] == 0 and rep["reconciled"] == sched.steps > 0
            and out["spans_balanced"] and not out["open_tracks"]
            and not out["export_errors"] and conserved):
        raise AssertionError(f"obs: telemetry checks failed {out}")
    return out


def step_counter_cost(torch, n_calls: int = 500) -> dict:
    """What ``serve/step_graph.py``'s always-on counters cost a call on
    the card, from the counters' own calls, µs each (median of 2,000):
    four ``perf_counter`` reads, the current stream's handle, two event
    records, the query of the pair due for reuse and its read (elapsed
    time and the ring), and the host record; their sum is the cost of a
    timed replay.  Also a small step program (two integer inputs, one
    matrix-vector product of 1024 x 1024) called ``n_calls`` times: every
    call after the capture recorded, timed or counted untimed, and its
    replays' median device ms."""
    from repro_torch.serve import step_graph

    w = torch.randn(1024, 1024, device="cuda")

    def fn(tok, pos):
        return w @ (tok.float() + pos.float()).repeat(512)

    g = step_graph.StepGraph("counter_cost", fn, "cuda", (0, 1))
    tok, pos = np.array([1, 2], np.int32), np.array([3, 4], np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_calls):
        g(tok, pos)
    torch.cuda.synchronize()
    call_us = (time.perf_counter() - t0) / n_calls * 1e6

    def each(call, n=2000) -> float:
        times = []
        for _ in range(n):
            a = time.perf_counter()
            call()
            times.append(time.perf_counter() - a)
        return statistics.median(times) * 1e6

    scratch = step_graph._Program()
    tm = step_graph._Timing()
    stream = torch.cuda.current_stream()
    tm.start.record(stream)
    tm.end.record(stream)
    torch.cuda.synchronize()

    def read():
        tm.t = 0.0
        scratch.read(tm)

    dev = torch.cuda.current_device()
    parts = dict(perf_counter=each(time.perf_counter),
                 raw_stream=each(
                     lambda: torch._C._cuda_getCurrentRawStream(dev)),
                 record=each(lambda: tm.start.record(stream)),
                 query=each(tm.end.query), read=each(read),
                 note=each(lambda: scratch.note(0.0, 0.0, 0.0, 0.0)))
    tm.end.record(stream)
    torch.cuda.synchronize()
    counts = dict(perf_counter=4, raw_stream=1, record=2, query=1, read=1,
                  note=1)
    st = step_graph.program_stats("counter_cost")
    row = dict(phase="obs", run="c_counter_cost", calls=n_calls,
               call_us=call_us, parts_us=parts,
               cost_us=sum(parts[k] * n for k, n in counts.items()),
               device_ms_median=statistics.median(
                   r["device_s"] for r in st["device"]) * 1e3,
               timed=st["timed"], untimed=st["untimed"])
    if not (st["timed"] > 0 and st["calls"] == n_calls - 1
            and st["calls"] == st["timed"] + st["untimed"]):
        raise AssertionError(f"obs c_counter_cost: {row}")
    return row


def phase_obs(torch, model, sched_toks=None, slo_gold=None) -> dict:
    """Telemetry on the serving path: (a) the sched traffic off / on / on /
    off (``obs_sched_run``); (b) the slo phase's run (d) with the byte
    accountant on: fetch, spill and park-spill bytes equal to the ledger;
    (c) the step programs' counters' cost a call
    (``step_counter_cost``)."""
    from repro_torch import obs
    from repro_torch.obs import ledger

    cfg, sals, params, proj = (model[k] for k in ("cfg", "sals", "params",
                                                  "proj"))
    prompts = sched_prompts(model)
    # a process's first scheduler run makes synchronizing calls that no
    # later run makes (two, on an H100): a short warm-up first, so that
    # the turns compare telemetry and nothing else
    warm, _ = obs_sched_run(torch, model, prompts[-1:], False, n_new=4,
                            name="warmup")
    emit(warm)
    runs = [obs_sched_run(torch, model, prompts, on)
            for on in (False, True, True, False)]
    for row, _ in runs:
        emit(row)
    toks = [t for _, t in runs]
    same = all(np.array_equal(a, b) for t in toks[1:]
               for a, b in zip(toks[0], t))
    same_sched = None if sched_toks is None else all(
        np.array_equal(a, b) for a, b in zip(toks[0], sched_toks))
    off = [r["wall_s"] for r, _ in runs if r["run"] == "off"]
    on = [r["wall_s"] for r, _ in runs if r["run"] == "on"]
    syncs = {r["sync_calls"] for r, _ in runs}
    summary = dict(phase="obs", run="a_summary", tokens_equal=same,
                   tokens_equal_sched=same_sched, wall_off_s=off,
                   wall_on_s=on, cost=statistics.median(on)
                   / statistics.median(off) - 1.0,
                   sync_calls=sorted(syncs))
    emit(summary)
    if not same or same_sched is False:
        raise AssertionError(f"obs: tokens differ across runs {summary}")
    if len(syncs) != 1 or 0 in syncs:
        raise AssertionError(f"obs: synchronizing calls differ with "
                             f"telemetry on and off (or none was seen): "
                             f"{summary}")

    # (b) park on a two-tier pool below the peak of live pages
    pages_low = -(-(SLO_LOW + SLO_NEW) // SLO_PS)
    hot = 4 * pages_low + 4 + 1 + 2
    with obs.enabled(cfg=cfg, sals=sals, with_traffic=True) as h:
        row, slo_toks = slo_run(torch, model, "obs_tiered_park", 2, "park",
                                SLO_PS, hot)
        acct, tr = h["traffic"], h["tracer"]
        rep = acct.report()
        page = ledger.tier_page_bytes(cfg, sals, SLO_PS)
        park = [e["args"]["bytes"] for e in tr.events
                if e["name"] == "tier_spill" and e["args"].get("parked")]
        b = dict(phase="obs", run="b_tiered_park", page_bytes=page,
                 decode_steps=row["decode_steps"], drifts=rep["drifts"],
                 reconciled=rep["reconciled"], spills=row["spills"],
                 fetches=row["fetches"], parks=row["parks"],
                 fetch_bytes=[rep["measured"]["fetch_bytes"],
                              rep["modeled"]["fetch_bytes"]],
                 spill_bytes=[rep["measured"]["spill_bytes"],
                              rep["modeled"]["spill_bytes"]],
                 park_spills=len(park), park_spill_bytes=sum(park),
                 spans_balanced=tr.balanced(),
                 tokens_equal_slo=None if slo_gold is None else all(
                     np.array_equal(x, y) for x, y in zip(slo_toks,
                                                          slo_gold)))
    emit(b)
    if not (b["drifts"] == 0 and b["reconciled"] == b["decode_steps"]
            and b["spill_bytes"][0] == b["spill_bytes"][1]
            == row["spills"] * page > 0
            and b["fetch_bytes"][0] == b["fetch_bytes"][1]
            == row["fetches"] * page
            and b["park_spills"] > 0
            and b["park_spill_bytes"] == b["park_spills"] * page
            and b["spans_balanced"] and b["tokens_equal_slo"] is not False):
        raise AssertionError(f"obs b_tiered_park: {b}")

    # (c) what the step programs' always-on counters cost
    c = step_counter_cost(torch)
    emit(c)
    return dict(a=summary, b=b, c=c)


# ---------------------------------------------------------------------------
# phase: the grouped selection layout and static batching
# ---------------------------------------------------------------------------

SALS_KERNELS = ("latent_score_pass", "topk_select", "sra_")


def grouped_generate(torch, model, g: int, prompts, n_new: int, flush,
                     phase: str = "grouped") -> dict:
    """``ServeEngine.generate`` at ``n_groups`` g (its steps replay the
    step program), then the same prompts decoded eager and replayed: every
    replayed step's logits and the tokens must equal the eager ones bit
    for bit, and each SALS layer must launch rows 1 and 2 once a step.
    Then ten replays of one step back to back (CUDA events) and the
    kernels' device time a step (CUPTI, L2 as the last step left it)."""
    from repro_torch.config import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine
    cfg, sals, params, proj = (model[k] for k in ("cfg", "sals", "params",
                                                  "proj"))
    eng = ServeEngine(params, proj, cfg, ServeConfig(
        max_seq_len=4160, max_batch=4, sals=sals), n_groups=g,
        device="cuda")
    ops.reset_launch_counts()
    out = eng.generate(prompts, max_new_tokens=n_new)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    timing = eng.last_timing
    steps = timing["decode_steps"]
    toks = np.stack([r.tokens for r in out])
    eager = decode_turn(torch, eng, prompts, n_new, graph=False)
    graph = decode_turn(torch, eng, prompts, n_new, graph=True)
    same = all(torch.equal(a, b) for a, b in zip(eager["logits"],
                                                 graph["logits"]))
    with torch.inference_mode():
        logits, cache, lens = prefill_batch(torch, eng, prompts)
        tok = logits.argmax(-1).to(torch.int32)
        pos = torch.as_tensor(lens, device="cuda")
        eng.decode(tok, cache, pos)              # this cache's capture
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            eng.decode(tok, cache, pos)
        end.record()
        end.synchronize()
        device = kernel_device_ms(torch, lambda: eng.decode(tok, cache, pos),
                                  5, flush, mode="none")
        del cache
    row = dict(phase=phase, run=f"generate_G{g}", groups=g,
               k_loc=-(-sals.n_critical // g), slab=4160 // g,
               prompts=[len(p) for p in prompts], new_tokens=n_new,
               decode_ms_per_step=1e3 * timing["decode_s"] / steps,
               prefill_s=timing["prefill_s"], decode_steps=steps,
               sals_launches_per_step={
                   k: counts[k] / steps for k in ("latent_topk",
                                                  "sparse_recon_attention")},
               graph_ms_per_step=statistics.median(graph["ms"][1:]),
               eager_ms_per_step=statistics.median(eager["ms"][1:]),
               back_to_back_ms_per_replay=start.elapsed_time(end) / 10,
               device_ms_per_step=sum(device.values()),
               sals_device_ms_per_step={
                   k: v for k, v in device.items()
                   if any(n in k for n in SALS_KERNELS)},
               launches=counts, decode_captures=eng._decode.captures,
               logits_bitwise_equal_eager=same,
               tokens_equal_eager=bool(np.array_equal(graph["tokens"],
                                                      eager["tokens"])),
               generate_tokens_equal_eager=bool(np.array_equal(
                   toks, eager["tokens"])))
    emit(row)
    want = model["n_sals"] * steps
    if counts["latent_topk"] != want or \
            counts["sparse_recon_attention"] != want:
        raise AssertionError(f"{phase} G{g}: SALS launches {counts}, "
                             f"expected {want} each")
    if not (same and row["tokens_equal_eager"]
            and row["generate_tokens_equal_eager"]):
        raise AssertionError(f"{phase} G{g}: the replayed step differs from "
                             "the eager one")
    # at most one capture per arena (generate's, the graph turn's, the
    # timing's); an arena at a freed one's addresses replays its graph
    if not 1 <= eng._decode.captures <= 3:
        raise AssertionError(f"{phase} G{g}: {eng._decode.captures} decode "
                             "captures for 3 arenas")
    del eng, out, eager, graph
    gc.collect()
    torch.cuda.empty_cache()
    return row


def grouped_sched_prompts(model):
    """Four requests sharing a 512-token system prompt, 1536 ... 768
    tokens (the sched phase's traffic, shortened)."""
    corpus = model["corpus"]
    system = corpus.batch(600, 1, 512)["tokens"][0]
    return [np.concatenate([system, corpus.batch(610 + i, 1, n - 512)
                            ["tokens"][0]]).astype(np.int32)
            for i, n in enumerate((1536, 1280, 1024, 768))]


def grouped_tier_prompts(model):
    """Eight requests on the grouped traffic's 512-token system prompt:
    its four, three more (1408 ... 896 tokens), and last the first prompt
    extended by 256 tokens, whose prefix hit lands on pages that went
    cold while the others ran."""
    corpus = model["corpus"]
    first = grouped_sched_prompts(model)
    more = [np.concatenate([first[0][:512], corpus.batch(620 + i, 1, n - 512)
                            ["tokens"][0]]).astype(np.int32)
            for i, n in enumerate((1408, 1152, 896))]
    ext = np.concatenate([first[0], corpus.batch(630, 1, 256)["tokens"][0]])
    return first + more + [ext.astype(np.int32)]


def grouped_sched_run(torch, model, name, g, n_new=16, prompts=None,
                      **skw) -> tuple:
    """One ``RequestScheduler`` run at ``n_groups`` g (64-token chunks, 4
    slots, max_seq_len 4096, audited every step; ``prompts`` default
    :func:`grouped_sched_prompts`) with the byte accountant on: every
    request DONE, 0 drifts and every decode step reconciled, one decode
    capture, and only the layout's SALS kernels (a verify window's: one
    window and one top-k per SALS layer and round).  Two-tier: the most
    pages one step's selection touched, and the peak of live pages."""
    from repro_torch import obs
    from repro_torch.config import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, RequestScheduler, ServeEngine
    cfg, sals, params, proj = (model[k] for k in ("cfg", "sals", "params",
                                                  "proj"))
    eng = ServeEngine(params, proj, cfg, ServeConfig(
        max_seq_len=4096, max_batch=4, prefill_chunk=64,
        prefill_token_budget=256, audit_every=1, sals=sals, **skw),
        n_groups=g, device="cuda")
    decode_runs, max_touched = [0], [0]
    for entry in ("decode", "decode_sel", "decode_window"):
        def counted(*args, _fn=getattr(eng, entry), _sel=entry ==
                    "decode_sel"):
            decode_runs[0] += 1
            out = _fn(*args)
            if _sel:              # (logits, cache, touched (B, mp))
                table = next(iter(eng._latent_segs(out[1]).values())) \
                    .page_table[0]
                pids = torch.unique(table[out[2]])
                max_touched[0] = max(max_touched[0], int((pids > 0).sum()))
            return out
        setattr(eng, entry, counted)
    with obs.enabled(cfg=cfg, sals=sals, with_traffic=True) as h:
        sched = RequestScheduler(eng)
        reqs = [Request(p, max_new_tokens=n_new)
                for p in (prompts or grouped_sched_prompts(model))]
        for r in reqs:
            sched.submit(r)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        traffic = h["traffic"].report()
    counts = ops.launch_counts()
    spec = skw.get("spec_window", 0) > 1
    entry = eng._decode_window if spec else (
        eng._decode_sel if eng.tiered else eng._decode)
    row = dict(phase="grouped", run=name, groups=g, wall_s=wall,
               decode_steps=sched.steps, decode_runs=decode_runs[0],
               launches=counts, decode_captures=entry.captures,
               traffic_reconciled=traffic["reconciled"],
               traffic_drifts=traffic["drifts"],
               prefix_hits=sched.prefix_hits)
    if spec:
        row.update(spec_rounds=sched.spec_rounds,
                   spec_committed=sched.spec_committed)
    if eng.tiered:
        row.update(hbm_pages=eng.scfg.hbm_pages, spills=sched.pool.spills,
                   fetches=sched.pool.fetches, cold_misses=sched.cold_misses,
                   reruns=decode_runs[0] - sched.steps,
                   evictions=sched.evictions,
                   max_touched_pages=max_touched[0],
                   peak_live_pages=max(x["pages_in_use"]
                                       for x in sched.pool_gauges))
    emit(row)
    if not all(r.done for r in reqs):
        raise AssertionError(f"grouped {name}: not every request DONE")
    sched.audit_serving_state()
    if traffic["drifts"] or traffic["reconciled"] != sched.steps:
        raise AssertionError(f"grouped {name}: byte ledger {traffic}")
    if entry.captures != 1:
        raise AssertionError(f"grouped {name}: {entry.captures} captures")
    paged = eng.paged
    if spec:
        check_spec_launches(f"grouped {name}", counts, sched.spec_rounds,
                            model["n_sals"], paged)
    else:
        mine = ("latent_topk_paged", "sparse_recon_attention_paged") \
            if paged else ("latent_topk", "sparse_recon_attention")
        want = model["n_sals"] * decode_runs[0]
        if any(counts[k] != want for k in mine) or any(
                v for k, v in counts.items()
                if k not in mine and k != "flash_attention"):
            raise AssertionError(f"grouped {name}: launches {counts}, "
                                 f"expected {want} of {mine}")
    toks = [r.result.tokens for r in reqs]
    del eng, sched, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return row, toks


def grouped_static(torch, model, g: int, n_new: int = 16) -> dict:
    """``RequestScheduler(mode="static")`` at ``n_groups`` g: 8 requests
    (1408 ... 512 tokens) in batches of 4, shortest first; each request's
    tokens must equal ``generate`` on the same batch."""
    from repro_torch.config import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, RequestScheduler, ServeEngine
    cfg, sals, params, proj = (model[k] for k in ("cfg", "sals", "params",
                                                  "proj"))
    lens = [1408 - 128 * i for i in range(8)]
    prompts = [model["corpus"].batch(700 + i, 1, n)["tokens"][0]
               for i, n in enumerate(lens)]
    eng = ServeEngine(params, proj, cfg, ServeConfig(
        max_seq_len=4096, max_batch=4, sals=sals), n_groups=g,
        device="cuda")
    sched = RequestScheduler(eng, mode="static")
    reqs = [Request(p, max_new_tokens=n_new) for p in prompts]
    for r in reqs:
        sched.submit(r)
    batches = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sched.run(on_batch=lambda b: batches.append([len(r.prompt) for r in b]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    ordered, want = sorted(prompts, key=len), {}
    for b in batches:
        batch, ordered = ordered[:len(b)], ordered[len(b):]
        for p, res in zip(batch, eng.generate(batch, max_new_tokens=n_new)):
            want[len(p)] = res.tokens
    same = all(r.done and np.array_equal(r.result.tokens,
                                         want[len(r.prompt)]) for r in reqs)
    row = dict(phase="grouped", run="static", groups=g, prompts=lens,
               new_tokens=n_new, batches=batches, wall_s=wall,
               launches=counts, tokens_equal_generate=same,
               decode_steps=sched.steps)
    emit(row)
    if not same or [len(b) for b in batches] != [4, 4]:
        raise AssertionError(f"grouped static: tokens {same}, batches "
                             f"{batches}")
    del eng, sched
    gc.collect()
    torch.cuda.empty_cache()
    return row


def grouped_tiered(torch, model) -> dict:
    """The two-tier pool at G 4 on :func:`grouped_tier_prompts` (every
    prompt's prefix entry kept, so the pool holds more live pages than a
    step touches): untiered; a pool-sized hot tier, which measures the
    touched sets; then the touched set plus a write page per slot, a
    fetch slot and 2 more (the smallest safe size if that never spills).
    Both two-tier runs give the untiered tokens with 0 evictions; the last
    sits below the live peak, spills, and fetches cold pages back."""
    prompts = grouped_tier_prompts(model)
    kw = dict(prompts=prompts, page_size=64,
              prefix_cache_entries=len(prompts))
    runs = {"tier_untiered": grouped_sched_run(torch, model,
                                               "tier_untiered", 4, **kw)}
    pool = 4 * 4096 // 64
    big = runs["tiered_pool"] = grouped_sched_run(
        torch, model, "tiered_pool", 4, hbm_pages=pool, **kw)
    need = big[0]["max_touched_pages"] + 4 + 1
    for hot in (need + 2, need):
        runs["tiered"] = grouped_sched_run(torch, model, "tiered", 4,
                                           hbm_pages=hot, **kw)
        if runs["tiered"][0]["spills"] > 0:
            break
    want = runs["tier_untiered"][1]
    for name in ("tiered_pool", "tiered"):
        row, toks = runs[name]
        row["tokens_equal_untiered"] = all(
            np.array_equal(a, b) for a, b in zip(toks, want))
        if not (row["tokens_equal_untiered"] and row["evictions"] == 0):
            raise AssertionError(f"grouped {name}: tokens / evictions "
                                 f"{row}")
    tight = runs["tiered"][0]
    if not (tight["hbm_pages"] < big[0]["peak_live_pages"]
            and tight["spills"] > 0 and tight["fetches"] > 0):
        raise AssertionError(f"grouped tiered: hot tier not below the "
                             f"live peak, or no spill / fetch: {tight}")
    emit(dict(phase="grouped", run="tier_summary",
              hbm_pages=tight["hbm_pages"],
              peak_live_pages=big[0]["peak_live_pages"],
              max_touched_pages=big[0]["max_touched_pages"],
              spills=tight["spills"], fetches=tight["fetches"],
              cold_misses=tight["cold_misses"], reruns=tight["reruns"],
              tokens_equal_untiered=True))
    return tight


GROUPED_LAYERS = 8


def phase_grouped(torch, model, n_new: int = 16) -> dict:
    """The grouped layout on the serve phase's model: (1) ``generate`` at
    G 1, 2, 4, 8 on the serve prompts; (2) the scheduler at G 4, paged
    (64-token pages) == dense tokens, then two-tier == untiered tokens on
    a pool that spills (:func:`grouped_tiered`); (3) the
    Q 4 verify window at G 4 through the scheduler, paged == dense tokens;
    (4) static batching at G 4, tokens == ``generate``'s.  Returns the
    launch counts of rows 1, 2, 4-7 on these paths."""
    flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device="cuda")
    lens = [4096, 3584, 3072, 2560]
    prompts = [model["corpus"].batch(100 + i, 1, n)["tokens"][0]
               for i, n in enumerate(lens)]
    gen = {g: grouped_generate(torch, model, g, prompts, n_new, flush)
           for g in (1, 2, 4, 8)}
    runs = {name: grouped_sched_run(torch, model, name, 4, **skw)
            for name, skw in (
                ("paged", dict(page_size=64)), ("dense", {}),
                ("spec_paged", dict(page_size=64, spec_window=4)),
                ("spec_dense", dict(spec_window=4)))}
    toks = {k: v[1] for k, v in runs.items()}
    eq = lambda a, b: all(np.array_equal(x, y)       # noqa: E731
                          for x, y in zip(toks[a], toks[b]))
    summary = dict(phase="grouped", run="summary",
                   paged_tokens_equal_dense=eq("paged", "dense"),
                   spec_paged_tokens_equal_dense=eq("spec_paged",
                                                    "spec_dense"),
                   decode_ms_per_step={g: r["decode_ms_per_step"]
                                       for g, r in gen.items()},
                   back_to_back_ms_per_replay={
                       g: r["back_to_back_ms_per_replay"]
                       for g, r in gen.items()},
                   sals_device_ms_per_step={
                       g: sum(r["sals_device_ms_per_step"].values())
                       for g, r in gen.items()})
    tiered = grouped_tiered(torch, model)
    summary.update(tiered_spills=tiered["spills"],
                   tiered_fetches=tiered["fetches"])
    static = grouped_static(torch, model, 4)
    summary["static_tokens_equal_generate"] = static["tokens_equal_generate"]
    emit(summary)
    bad = [k for k, v in summary.items() if v is False]
    if bad:
        raise AssertionError(f"grouped: {bad}")
    counts = {k: gen[4]["launches"][k] for k in ("latent_topk",
                                                 "sparse_recon_attention")}
    for name, keys in (("paged", ("latent_topk_paged",
                                  "sparse_recon_attention_paged")),
                       ("spec_dense", ("sparse_recon_attention_window",)),
                       ("spec_paged",
                        ("sparse_recon_attention_window_paged",))):
        counts.update({k: runs[name][0]["launches"][k] for k in keys})
    return counts


# ---------------------------------------------------------------------------
# phase 7: whole path, card vs CPU
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase: the vlm family (paligemma-3b at full width)
# ---------------------------------------------------------------------------

VLM_TEXT = [3840, 3328, 2816, 2304]     # text tokens after the 256 patches
VLM_SCHED_TEXT = (1024, 896, 768, 640)  # the scheduler run's prompts


def twin_prefill(torch, fn):
    """``fn()`` with prefill attention through the plain twin
    (``ref.attention_ref``, prefix-LM mask included) on the card, in place
    of the flash kernel: a yardstick of the kernel's effect on the logits,
    not a path of the port."""
    from repro_torch.kernels import ops, ref
    kernel = ops.flash_attention

    def twin(q, k, v, *, causal=True, softcap=0.0, prefix_len=0):
        return ref.attention_ref(q, k, v, causal=causal or prefix_len > 0,
                                 softcap=softcap, prefix_len=prefix_len)

    ops.flash_attention = twin
    try:
        return fn()
    finally:
        ops.flash_attention = kernel


def vlm_prefill_decode(torch, model, n_new: int) -> dict:
    """(a) ``tf.prefill`` of 4 rows of 256 patch embeddings (N(0, 1) x 0.1
    from seed 0) + 3840 ... 2304 text tokens, then ``n_new`` greedy
    ``tf.decode_step``s (called directly), SALS-25% and SALS off; the
    SALS-off prefill's last logits against the same prefill with the
    twin's attention on the card (max |diff| over the logit scale, the
    whole phase's bound)."""
    from repro_torch.config import SALSConfig
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    cfg, params, proj, corpus = (model[k] for k in ("cfg", "params", "proj",
                                                    "corpus"))
    p, d = cfg.vision_patches, cfg.d_model
    dev = params.embed.embedding.device
    text = VLM_TEXT
    g = torch.Generator(device=dev).manual_seed(0)
    patches = torch.randn((4, p, d), generator=g, device=dev) * 0.1
    toks = np.zeros((4, max(text)), np.int32)
    for i, n in enumerate(text):
        toks[i, :n] = corpus.batch(200 + i, 1, n)["tokens"][0]
    batch = {"patches": patches, "tokens": torch.as_tensor(toks, device=dev)}
    lens = torch.as_tensor(text, dtype=torch.int32, device=dev)
    max_seq = p + max(text) + n_new
    rows, last = {}, {}
    for name, sals in (("sals", model["sals"]),
                       ("full", SALSConfig(enabled=False))):
        u = proj if sals.enabled else None
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits, cache = tf.prefill(params, u, cfg, sals, batch, max_seq,
                                       lengths=lens)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            prefill_counts = ops.launch_counts()
            last[name] = logits.float()
            tok = logits.argmax(-1).to(torch.int32)
            out, ms = [tok.cpu().numpy()], []
            ops.reset_launch_counts()
            for t in range(n_new):
                t0 = time.perf_counter()
                logits, cache = tf.decode_step(params, u, cache, tok,
                                               p + lens + t, cfg, sals)
                tok = logits.argmax(-1).to(torch.int32)
                out.append(tok.cpu().numpy())
                ms.append(1e3 * (time.perf_counter() - t0))
            counts = ops.launch_counts()
            del cache
        toks_out = np.stack(out, 1)
        finite = bool(torch.isfinite(logits).all())
        rows[name] = dict(
            phase="vlm", part="prefill_decode", run=name, patches=p,
            text_tokens=text, max_seq=max_seq, prefill_s=prefill_s,
            prefill_launches=prefill_counts, decode_steps=n_new,
            eager_ms_per_step=statistics.median(ms[1:]),
            first_step_ms=ms[0], decode_launches=counts,
            tokens_in_range=bool((toks_out >= 0).all()
                                 and (toks_out < cfg.vocab_size).all()),
            finite=finite,
            max_memory_allocated=torch.cuda.max_memory_allocated())
        want = model["n_sals"] * n_new if sals.enabled else 0
        if prefill_counts["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"vlm {name}: prefill launched flash "
                                 f"{prefill_counts['flash_attention']} times")
        if counts["latent_topk"] != want or \
                counts["sparse_recon_attention"] != want:
            raise AssertionError(f"vlm {name}: SALS launches {counts}, "
                                 f"expected {want} each")
        if not (finite and rows[name]["tokens_in_range"]):
            raise AssertionError(f"vlm {name}: logits or tokens out of range")
    with torch.inference_mode():
        twin = twin_prefill(torch, lambda: tf.prefill(
            params, None, cfg, SALSConfig(enabled=False), batch, max_seq,
            lengths=lens)[0].float())
    tol = 0.05   # as the whole phase: bf16 through the stack, two orders
    rel = float((last["full"] - twin).abs().max() / twin.abs().max())
    for name, row in rows.items():
        row.update(prefill_logits_rel_err_vs_twin=rel, tol=tol,
                   greedy_first_token_equal_twin=bool(torch.equal(
                       last["full"].argmax(-1), twin.argmax(-1))))
        emit(row)
    if rel > tol:
        raise AssertionError(f"vlm: prefix-LM prefill logits {rel} from the "
                             "twin's")
    return {"flash_attention": rows["sals"]["prefill_launches"][
                "flash_attention"],
            "latent_topk": rows["sals"]["decode_launches"]["latent_topk"],
            "sparse_recon_attention": rows["sals"]["decode_launches"][
                "sparse_recon_attention"]}


def vlm_sched(torch, model, n_new: int = 16) -> dict:
    """(c) ``RequestScheduler`` on tokens only: 4 requests (1024 ... 640
    tokens) x ``n_new``, 64-token chunks, on 64-token pages and on the
    dense arena: tokens equal, and each run launches only its layout's
    SALS kernels, once per SALS layer and step."""
    from repro_torch.config import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, RequestScheduler, ServeEngine
    cfg, sals, params, proj = (model[k] for k in ("cfg", "sals", "params",
                                                  "proj"))
    prompts = [model["corpus"].batch(400 + i, 1, n)["tokens"][0]
               for i, n in enumerate(VLM_SCHED_TEXT)]
    runs = {}
    for name, ps in (("paged", 64), ("dense", 0)):
        eng = ServeEngine(params, proj, cfg, ServeConfig(
            max_seq_len=1152, max_batch=4, prefill_chunk=64, page_size=ps,
            prefill_token_budget=256, sals=sals),
            device=params.embed.embedding.device)
        sched = RequestScheduler(eng)
        reqs = [Request(p_, max_new_tokens=n_new) for p_ in prompts]
        for r in reqs:
            sched.submit(r)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        toks = [r.result.tokens if r.done else None for r in reqs]
        emit(dict(phase="vlm", part="sched", run=name,
                  prompts=[len(p_) for p_ in prompts], new_tokens=n_new,
                  wall_s=wall, decode_steps=sched.steps,
                  prefill_chunks=len(sched.prefill_chunks),
                  chunk_captures=eng._prefill_chunk.captures,
                  launches=counts))
        if not all(r.done for r in reqs):
            raise AssertionError(f"vlm sched {name}: not every request DONE")
        sched.audit_serving_state()
        want = model["n_sals"] * sched.steps
        mine = ("latent_topk_paged", "sparse_recon_attention_paged") if ps \
            else ("latent_topk", "sparse_recon_attention")
        if any(counts[k] != want for k in mine):
            raise AssertionError(f"vlm sched {name}: SALS launches {counts}, "
                                 f"expected {want} of {mine}")
        runs[name] = (counts, toks)
        del eng, sched
        gc.collect()
        torch.cuda.empty_cache()
    same = all(np.array_equal(a, b) for a, b in
               zip(runs["paged"][1], runs["dense"][1]))
    emit({"phase": "vlm", "part": "sched", "paged_tokens_equal_dense": same})
    if not same:
        raise AssertionError("vlm sched: paged tokens differ from dense")
    return {k: runs["paged"][0][k] for k in ("latent_topk_paged",
                                             "sparse_recon_attention_paged")}


def phase_vlm(torch, n_new: int = 32, prof: bool = False) -> dict:
    """paligemma-3b at full width (18 layers, d 2048, 8 heads over one kv
    head of dh 256, GeGLU, vocab 257,216), random bf16 weights from seed
    0, SALS-25% at the defaults (r 64, r* 32, N_c 432, 15 SALS layers), U_r
    calibrated on tokens: (a) prefix-LM prefill + greedy decode; (b)
    ``ServeEngine.generate`` on tokens only, the serve phase's prompts, in
    turns eager / replayed; (c) the paged scheduler.  Returns the launch
    counts of rows 1-5 on these paths."""
    model = build_model(torch, "paligemma-3b")
    counts = vlm_prefill_decode(torch, model, n_new)
    gc.collect()
    torch.cuda.empty_cache()
    serve_row, _ = phase_serve(torch, model, n_new, prof, phase="vlm")
    counts["generate"] = {k: serve_row["launches"][k] for k in (
        "flash_attention", "latent_topk", "sparse_recon_attention")}
    # (b) at G 4: 16 recon blocks (4 rows x 4 slabs) in place of 4
    prompts = [model["corpus"].batch(100 + i, 1, n)["tokens"][0]
               for i, n in enumerate([4096, 3584, 3072, 2560])]
    flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device="cuda")
    g4 = grouped_generate(torch, model, 4, prompts, 16, flush, phase="vlm")
    counts["generate_G4"] = {k: g4["launches"][k] for k in (
        "latent_topk", "sparse_recon_attention")}
    del flush
    counts.update(vlm_sched(torch, model))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# families: moe, hybrid and ssm at full width
# ---------------------------------------------------------------------------

# (arch, depth: 0 = the published depth); llama4-scout and qwen3-moe are
# cut so that their weights (4.41 / 4.98 GB a layer) fit on one card
FAMILY_RUNS = (("hymba-1.5b", 0), ("rwkv6-7b", 0),
               ("llama4-scout-17b-a16e", 13), ("qwen3-moe-235b-a22b", 12))
FAMILY_SCHED_LENS = (1024, 896, 768, 640)
ROWS_1_7 = ("latent_topk", "sparse_recon_attention", "latent_topk_paged",
            "sparse_recon_attention_paged", "sparse_recon_attention_window",
            "sparse_recon_attention_window_paged", "flash_attention")


def _short(arch: str) -> str:
    return arch.split("-")[0]


def family_generate(torch, model, prompts, name, sc, n_new, max_seq,
                    eager=False):
    """One ``ServeEngine.generate`` (replayed, or eager through
    :func:`eager_entries`): (tokens, row) with the launches, the decode
    captures of the call, prefill seconds and ms a step."""
    from repro_torch.config import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model["params"], model["proj"], model["cfg"],
                      ServeConfig(max_seq_len=max_seq, max_batch=4, sals=sc),
                      device="cuda")
    if eager:
        eager_entries(torch, eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = eng.generate(prompts, max_new_tokens=n_new)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    t = eng.last_timing
    steps = t["decode_steps"]
    toks = np.stack([r.tokens for r in out])
    row = dict(run=name, eager=eager, prompts=[len(p) for p in prompts],
               new_tokens=n_new, prefill_s=t["prefill_s"],
               ms_per_step=1e3 * t["decode_s"] / steps, decode_steps=steps,
               capture_s=t["capture_s"],
               decode_captures=0 if eager else eng._decode.captures,
               launches_per_step={k: counts[k] / steps for k in ROWS_1_7
                                  if k != "flash_attention"},
               launches=counts,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    if not (toks.shape == (len(prompts), n_new) and (toks >= 0).all()
            and (toks < model["cfg"].vocab_size).all()):
        raise AssertionError(f"families {name}: tokens out of range")
    if not eager and row["decode_captures"] != 1:
        raise AssertionError(f"families {name}: {row['decode_captures']} "
                             "decode captures in one generate")
    del eng, out
    gc.collect()
    return toks, row


def family_shares(torch, model, prompts, max_seq) -> dict:
    """Where a replayed decode step's time goes: torch.profiler over one
    replayed step (by kernel, to chiprun_out/), and the share of the step
    that the MoE layers or the recurrences take — each timed alone as a
    CUDA graph of one layer's call at the step's shapes (L2 flushed
    first), times the layers, over the replayed step's own ms."""
    from repro_torch.config import ServeConfig
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ServeEngine
    cfg, params = model["cfg"], model["params"]
    eng = ServeEngine(params, model["proj"], cfg, ServeConfig(
        max_seq_len=max_seq, max_batch=4, sals=model["sals"]),
        device="cuda")
    out = {}
    with torch.inference_mode():
        b = len(prompts)
        n = min(len(p) for p in prompts)
        toks = torch.as_tensor(np.stack([p[:n] for p in prompts]),
                               device="cuda")
        logits, cache = tf.prefill(params, model["proj"], cfg, eng.sals,
                                   {"tokens": toks}, max_seq)
        tok = logits.argmax(-1).to(torch.int32)
        pos = np.full((b,), n, np.int32)
        eng.decode(tok, cache, pos)               # the capture
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        pos_d = torch.as_tensor(pos + 1, device="cuda")
        eng.decode(tok, cache, pos_d)
        start.record()
        for _ in range(5):
            eng.decode(tok, cache, pos_d)
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / 5
        profile_steps(torch, lambda t: eng.decode(tok, cache, pos_d), 1,
                      f"families_{_short(cfg.name)}_decode_graph")
        x = torch.randn((b, 1, cfg.d_model), device="cuda").to(
            params.embed.embedding.dtype)
        blk = params.blocks[0]
        parts = {}
        if cfg.family == "moe":
            parts["moe"] = lambda: moe_mod.moe_apply(blk.moe, x, cfg)
        if cfg.family == "hybrid":
            st = ssm_mod.mamba_state_init(cfg, b, "cuda")
            parts["mamba"] = lambda: ssm_mod.mamba_decode(blk.mamba, x, cfg,
                                                          st)
        if cfg.family == "ssm":
            st = ssm_mod.rwkv_state_init(cfg, b, "cuda")
            parts["rwkv_time_mix"] = lambda: ssm_mod.rwkv_time_mix(
                blk.rwkv, x, cfg, st)
            parts["rwkv_channel_mix"] = lambda: ssm_mod.rwkv_channel_mix(
                blk.rwkv, x, st)
        # the step reads each layer's weights once, cold: flush L2 first
        flush = torch.empty(96 * 2 ** 20, dtype=torch.uint8, device="cuda")
        for name, fn in parts.items():
            replay = as_graph(torch, fn)
            ms = time_ms(torch, replay, 10, flush=flush)
            out[name] = dict(layer_ms=ms, step_ms=ms * cfg.n_layers,
                             share=ms * cfg.n_layers / step_ms)
        del cache, logits
    emit({"phase": "families", "arch": cfg.name, "part": "decode_shares",
          "replayed_step_ms": step_ms, "components": out})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_sched(torch, model, name, page_size, spec=0, n_new=16):
    """``RequestScheduler`` over the moe family: 4 requests (1024 ... 640
    tokens) x ``n_new``, 64-token chunks (the MoE groups are the chunks),
    4 slots, on 64-token pages or the dense arena, a verify window of
    ``spec`` or sequential: every request DONE, one decode capture, and
    only the layout's SALS kernels."""
    from repro_torch.config import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, RequestScheduler, ServeEngine
    cfg = model["cfg"]
    prompts = [model["corpus"].batch(700 + i, 1, n)["tokens"][0]
               for i, n in enumerate(FAMILY_SCHED_LENS)]
    eng = ServeEngine(model["params"], model["proj"], cfg, ServeConfig(
        max_seq_len=1152, max_batch=4, prefill_chunk=64, page_size=page_size,
        prefill_token_budget=256, spec_window=spec, audit_every=1,
        sals=model["sals"]), device="cuda")
    sched = RequestScheduler(eng)
    reqs = [Request(p, max_new_tokens=n_new) for p in prompts]
    for r in reqs:
        sched.submit(r)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    entry = eng._decode_window if spec else eng._decode
    row = dict(phase="families", arch=cfg.name, part="sched", run=name,
               mode=sched.mode, wall_s=wall, decode_steps=sched.steps,
               prefill_chunks=len(sched.prefill_chunks),
               decode_captures=entry.captures,
               chunk_captures=eng._prefill_chunk.captures, launches=counts,
               launches_per_step={k: counts[k] / max(1, sched.steps)
                                  for k in ROWS_1_7
                                  if k != "flash_attention"})
    if spec:
        row.update(spec_rounds=sched.spec_rounds,
                   spec_committed=sched.spec_committed)
    emit(row)
    if not all(r.done for r in reqs):
        raise AssertionError(f"families {name}: not every request DONE")
    sched.audit_serving_state()
    if entry.captures != 1:
        raise AssertionError(f"families {name}: {entry.captures} captures")
    if spec:
        check_spec_launches(f"families {name}", counts, sched.spec_rounds,
                            model["n_sals"], bool(page_size))
    else:
        mine = ("latent_topk_paged", "sparse_recon_attention_paged") \
            if page_size else ("latent_topk", "sparse_recon_attention")
        want = model["n_sals"] * sched.steps
        if any(counts[k] != want for k in mine):
            raise AssertionError(f"families {name}: launches {counts}, "
                                 f"expected {want} of {mine}")
    toks = [r.result.tokens for r in reqs]
    del eng, sched, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return counts, toks


def family_moe(torch, model, n_new: int) -> dict:
    """(c) / (d): ``generate`` on the serve prompts, SALS on and off, in
    turns replayed / eager (:func:`phase_serve`); the scheduler paged ==
    dense; llama4-scout also a verify window of 4, paged == dense."""
    label = f"families_{_short(model['cfg'].name)}"
    serve_row, _ = phase_serve(torch, model, n_new, phase=label)
    counts = {k: serve_row["launches"][k] for k in (
        "flash_attention", "latent_topk", "sparse_recon_attention")}
    steps = serve_row["decode_steps"]
    emit({"phase": "families", "arch": model["cfg"].name, "part": "summary",
          "prefill_s": serve_row["prefill_s"],
          "replayed_ms_per_step": serve_row["graph_ms_per_step"],
          "eager_ms_per_step": serve_row["eager_ms_per_step"],
          "peak_memory": serve_row["max_memory_allocated"],
          "prefill_flash_launches": counts["flash_attention"],
          "launches_per_step": {k: serve_row["launches"][k] / steps
                                for k in ROWS_1_7
                                if k != "flash_attention"}})
    gc.collect()
    torch.cuda.empty_cache()
    runs = [("paged", 64, 0), ("dense", 0, 0)]
    if model["cfg"].name.startswith("llama4"):
        runs += [("spec_paged", 64, SPEC_Q), ("spec_dense", 0, SPEC_Q)]
    toks = {}
    for name, ps, q in runs:
        c, toks[name] = family_sched(torch, model, f"{label} {name}", ps, q)
        for k, v in c.items():
            if v and k != "flash_attention":
                counts[k] = counts.get(k, 0) + v
    for a, b in (("paged", "dense"), ("spec_paged", "spec_dense")):
        if a in toks:
            same = all(np.array_equal(x, y) for x, y in zip(toks[a],
                                                            toks[b]))
            emit({"phase": "families", "arch": model["cfg"].name,
                  "part": "sched", f"{a}_tokens_equal_{b}": same})
            if not same:
                raise AssertionError(f"{label}: {a} tokens differ from {b}")
    return counts


def family_recurrent(torch, model, n_new: int) -> dict:
    """(a) / (b): ``generate`` on a uniform-length batch (left-filled),
    SALS on and off where the family has attention, replayed then eager
    (tokens equal); the scheduler falls back to static batching (tokens
    equal ``generate``'s); a paged cache and a verify window are refused.
    rwkv6: its prefill profiled on 64-token prompts."""
    from repro_torch.config import SALSConfig, ServeConfig
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Request, RequestScheduler, ServeEngine
    cfg = model["cfg"]
    hybrid = cfg.family == "hybrid"
    # ascending, so the static scheduler's batch is generate's
    lens = (1280, 1536, 1792, 2048) if hybrid else (1024,) * 4
    max_seq = max(lens) + 64
    prompts = [model["corpus"].batch(600 + i, 1, n)["tokens"][0]
               for i, n in enumerate(lens)]
    label = f"families_{_short(cfg.name)}"
    runs = [("sals", model["sals"]), ("full", SALSConfig(enabled=False))] \
        if hybrid else [("full", model["sals"])]
    counts, rows, gold = {}, [], None
    for name, sc in runs:
        toks, row = family_generate(torch, model, prompts, name, sc, n_new,
                                    max_seq)
        rows.append(row)
        if gold is None:
            gold = toks
            counts = {k: v for k, v in row["launches"].items() if v}
            etoks, erow = family_generate(torch, model, prompts, name, sc,
                                          n_new, max_seq, eager=True)
            rows.append(erow)
            row["tokens_equal_eager"] = bool(np.array_equal(toks, etoks))
            row["launches_equal_eager"] = erow["launches"] == row["launches"]
            eng = ServeEngine(model["params"], model["proj"], cfg,
                              ServeConfig(max_seq_len=max_seq, max_batch=4,
                                          sals=sc), device="cuda")
            sched = RequestScheduler(eng)
            reqs = [Request(p, max_new_tokens=n_new) for p in prompts]
            for r in reqs:
                sched.submit(r)
            t0 = time.perf_counter()
            sched.run()
            torch.cuda.synchronize()
            row["static_wall_s"] = time.perf_counter() - t0
            row["sched_mode"] = sched.mode
            row["static_tokens_equal_generate"] = all(
                r.done and np.array_equal(r.result.tokens, gold[i])
                for i, r in enumerate(reqs))
            refused = {}
            for key, kw in (("page_size", dict(page_size=64)),
                            ("spec_window", dict(spec_window=4))):
                try:
                    ServeEngine(model["params"], model["proj"], cfg,
                                ServeConfig(max_seq_len=max_seq, sals=sc,
                                            **kw), device="cuda")
                except ValueError as e:
                    refused[key] = str(e)
            row["refused"] = refused
            del eng, sched, reqs
            gc.collect()
    for r in rows:
        emit({"phase": "families", "arch": cfg.name, **r})
    main = rows[0]
    if not (main["tokens_equal_eager"] and main["launches_equal_eager"]
            and main["static_tokens_equal_generate"]
            and main["sched_mode"] == "static"
            and set(main["refused"]) == {"page_size", "spec_window"}):
        raise AssertionError(f"{label}: {main}")
    steps = main["decode_steps"]
    if hybrid:
        want = model["n_sals"] * steps
        if counts.get("latent_topk", 0) != want or \
                counts.get("sparse_recon_attention", 0) != want or \
                counts.get("flash_attention", 0) < cfg.n_layers:
            raise AssertionError(f"{label}: launches {counts}")
    elif counts:
        raise AssertionError(f"{label}: attention-free, launched {counts}")
    else:
        short = [p[:64] for p in prompts]
        toks = torch.as_tensor(np.stack(short), device="cuda")
        with torch.inference_mode():
            profile_steps(torch, lambda t: tf.prefill(
                model["params"], None, cfg, None, {"tokens": toks}, 128), 1,
                f"{label}_prefill_64")
    # an rwkv step's cost does not depend on the context: prefill 64 tokens
    family_shares(torch, model, prompts if hybrid
                  else [p[:64] for p in prompts], max_seq)
    return counts


# (e) on the (1, 1) mesh: serving 4 x (1024 + 16) tokens in a 1056-token
# cache (the hybrid's prompts are multiples of 128, the engine's cache of
# its 32-token prefill chunk); training (arch, layers (0: all), vocabulary
# (0: the config's), B, S, strategies): hymba at S 64 (at its 128-token SSD
# chunk the zero-initialised decay overflows exp and both paths' gradients
# are NaN); llama4-scout at 1 of 48 layers with its vocabulary cut from
# 202,048 to 32,768 (at the full vocabulary one layer is 4.27e9 parameters,
# and the step's f32 copies of the gradients put it past 80 GB); rwkv6-7b at
# 4 of 32 layers and S 128 (the per-token loop)
FAMILY_MESH_SEQ, FAMILY_MESH_PROMPT, FAMILY_MESH_NEW = 1056, 1024, 16
FAMILY_MESH_KERNELS = ("latent_topk", "sparse_recon_attention",
                       "flash_attention", "flash_attention_bwd")
FAMILY_MESH_TRAIN = (("hymba-1.5b", 0, 0, 4, 64, ("tp_sp",)),
                     ("llama4-scout-17b-a16e", 1, 32768, 2, 512,
                      ("tp_sp", "ep_dp")),
                     ("rwkv6-7b", 4, 0, 2, 128, ("tp_sp",)))


def family_mesh_train(torch, mesh, arch: str, layers: int, vocab: int,
                      b: int, s: int, strategies, steps: int = 2) -> dict:
    """(e) ``steps`` ``build_train`` steps of ``arch`` at full width on the
    (1, 1) mesh per strategy, each against the plain ``make_train_step``
    from the same seeded state (bf16 weights, f32 master, the full
    config's moment dtype) and batches: the first step's loss (from the
    same state) within 1e-5 relative; which parameters are equal bit for
    bit after the last step and the largest difference of the others
    (later losses differ as far as the parameters do); the last step's ms
    (the first carries the warm-up), peak memory, flash forward / backward
    launches a step.  Returns the mesh runs' launch counts."""
    from repro_torch.config import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.launch.train import batches_for
    from repro_torch.train import trainer
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers or full.n_layers,
                              vocab_size=vocab or full.vocab_size)
    moments = torch.bfloat16 if full.param_count() > specs.BIG_PARAMS \
        else torch.float32
    tcfg = TrainConfig(steps=steps, batch_size=b, seq_len=s, lr=3e-4,
                       warmup_steps=5)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    batches = [trainer.batch_to(next(batches_for(cfg, corpus, tcfg, i)),
                                "cuda") for i in range(steps)]
    mc = MeshConfig(shape=(1, 1), axis_names=("data", "model"))
    shape = ShapeConfig("t", "train", s, b)
    runs, counts = {}, {}
    for name in ("plain", *strategies):
        state = trainer.init_state(cfg, tcfg, device="cuda", seed=0,
                                   moment_dtype=moments)
        if name == "plain":
            step, bts = trainer.make_train_step(cfg, tcfg, remat="block"), \
                batches
        else:
            step, _, in_pl, _ = specs.build_train(
                cfg, shape, mesh, mc, remat="block", tcfg=tcfg,
                strategy=name)
            state = {k: shd.place(v, mesh, in_pl[0][k])
                     for k, v in state.items()}
            bts = [shd.place(bt, mesh, in_pl[1]) for bt in batches]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses, ms = [], []
        for bt in bts:
            t0 = time.perf_counter()
            state, m = step(state, bt)
            losses.append(float(m["loss"].to_local()
                                if shd.is_dtensor(m["loss"])
                                else m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        c = ops.launch_counts()
        runs[name] = dict(losses=losses, ms=ms, counts=c,
                          peak_memory=torch.cuda.max_memory_allocated(),
                          params={k: (p.to_local() if shd.is_dtensor(p)
                                      else p).detach().cpu()
                                  for k, p in
                                  state["params"].named_parameters()})
        if name != "plain":
            for k, v in c.items():
                counts[k] = counts.get(k, 0) + v
        del state, m
        gc.collect()
        torch.cuda.empty_cache()
    plain = runs.pop("plain")
    rows = []
    for name, r in runs.items():
        unequal = [k for k, p in plain["params"].items()
                   if not torch.equal(p, r["params"][k])]
        row = dict(phase="families", run=f"e_mesh_train_{name}", arch=arch,
                   n_layers=cfg.n_layers, vocab=cfg.vocab_size,
                   param_count=cfg.param_count(), batch=b, seq=s,
                   remat="block", moment_dtype=str(moments),
                   losses=r["losses"], plain_losses=plain["losses"],
                   rel_loss_diff=[abs(x - y) / abs(y) for x, y in zip(
                       r["losses"], plain["losses"])],
                   params_bitwise_equal=len(plain["params"]) - len(unequal),
                   params=len(plain["params"]),
                   params_not_bitwise_equal=unequal,
                   max_param_delta=max((float((r["params"][k].float()
                                               - plain["params"][k].float())
                                              .abs().max())
                                        for k in unequal), default=0.0),
                   params_finite=all(bool(torch.isfinite(p).all())
                                     for p in r["params"].values()),
                   ms=r["ms"][-1], plain_ms=plain["ms"][-1],
                   step_ms=r["ms"], plain_step_ms=plain["ms"],
                   peak_memory=r["peak_memory"],
                   plain_peak_memory=plain["peak_memory"],
                   flash_fwd=r["counts"]["flash_attention"] / steps,
                   flash_bwd=r["counts"]["flash_attention_bwd"] / steps)
        emit(row)
        rows.append(row)
    for row in rows:
        if not row["rel_loss_diff"][0] <= 1e-5:
            raise AssertionError(f"families (e) {row['run']} {arch}: losses "
                                 f"{row['losses']} vs plain "
                                 f"{row['plain_losses']}")
        n_att = cfg.n_layers if cfg.has_attention else 0
        if row["flash_fwd"] != 2 * n_att or row["flash_bwd"] != n_att:
            raise AssertionError(f"families (e) {row['run']} {arch}: flash "
                                 f"launches {row['flash_fwd']} + "
                                 f"{row['flash_bwd']}")
    return counts


def _add(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def phase_families(torch, n_new: int = 32) -> tuple:
    """hymba-1.5b, rwkv6-7b, llama4-scout (13 of 48 layers) and qwen3-moe
    (12 of 94 layers) at full width, bf16, seeded, SALS-25% at the
    defaults where the family has attention (U_r calibrated on the
    synthetic corpus); then (e) each model served through ``build_prefill``
    / ``build_decode`` on the world-1 NCCL group's (1, 1) mesh against its
    ``generate`` (:func:`mesh_serve`), and the sharded train steps of
    :data:`FAMILY_MESH_TRAIN` (:func:`family_mesh_train`).  Returns (the
    launch counts of rows 1-7 on the unsharded paths, the launches of
    (e))."""
    import shutil
    import torch.distributed as dist
    counts, on_mesh = {}, {}
    mesh, store = mesh_start(torch)
    try:
        for arch, depth in FAMILY_RUNS:
            t0 = time.perf_counter()
            model = build_model(torch, arch, n_layers=depth,
                                phase="families")
            if model["cfg"].family == "moe":
                c = family_moe(torch, model, n_new)
                family_shares(torch, model, [p[:2048] for p in (
                    model["corpus"].batch(100 + i, 1, 2048)["tokens"][0]
                    for i in range(4))], 4160)
            else:
                c = family_recurrent(torch, model, n_new)
            _add(counts, c)
            t1 = time.perf_counter()
            _add(on_mesh, mesh_serve(torch, model, mesh, FAMILY_MESH_NEW,
                                     FAMILY_MESH_SEQ, "families",
                                     "e_mesh_serve", FAMILY_MESH_PROMPT))
            emit({"phase": "families", "arch": arch, "n_layers":
                  model["cfg"].n_layers, "depth_cut": bool(depth),
                  "seconds": time.perf_counter() - t0,
                  "mesh_serve_seconds": time.perf_counter() - t1})
            del model
            gc.collect()
            torch.cuda.empty_cache()
        for run in FAMILY_MESH_TRAIN:
            t0 = time.perf_counter()
            _add(on_mesh, family_mesh_train(torch, mesh, *run))
            emit({"phase": "families", "arch": run[0], "part": "e_train",
                  "seconds": time.perf_counter() - t0})
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return counts, on_mesh


# ---------------------------------------------------------------------------
# phase 14: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2-1.5b"


def train_run(torch, cfg, tcfg, state, remat: str, name: str,
              start_step: int = 0, step_fn=None) -> dict:
    """``train_loop`` over ``step_fn`` (default ``make_train_step``) from
    ``start_step`` on the corpus's batches (seed 0), launch counters zeroed
    just before and read just after; per step loss, ce, grad norm, lr and
    ms."""
    from repro_torch.data import SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch.train import batches_for
    from repro_torch.train import trainer
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    steps = []

    def on_step(i, m, dt):
        steps.append({"step": i, **{k: float(v) for k, v in m.items()},
                      "ms": dt * 1e3})

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    trainer.train_loop(cfg, tcfg, state=state,
                       step_fn=step_fn or trainer.make_train_step(
                           cfg, tcfg, remat=remat),
                       batches=batches_for(cfg, corpus, tcfg, start_step,
                                           device="cuda"),
                       start_step=start_step, log=lambda *_: None,
                       on_step=on_step)
    counts = ops.launch_counts()
    n = len(steps)
    warm = [st["ms"] for st in steps[1:]] or [steps[0]["ms"]]
    step_ms = statistics.median(warm)
    row = dict(phase="train", run=name, arch=cfg.name,
               n_layers=cfg.n_layers, batch=tcfg.batch_size,
               seq=tcfg.seq_len, remat=remat, steps=steps,
               median_step_ms=step_ms,
               tokens_per_s=tcfg.batch_size * tcfg.seq_len / step_ms * 1e3,
               peak_memory=torch.cuda.max_memory_allocated(),
               launches=counts,
               flash_fwd_per_step=counts["flash_attention"] / n,
               flash_bwd_per_step=counts["flash_attention_bwd"] / n)
    emit(row)
    return row


def train_profile(torch, cfg, tcfg, state, batch, remat: str,
                  run: str = "profile") -> dict:
    """torch.profiler over one step of a run, in its two parts (the
    forward and backward, then the AdamW update): device busy share, the
    top kernels, and the shares of the flash forward, the flash backward
    (D pass, dK/dV, dQ) and the update.  Tables go to
    ``chiprun_out/{run}_train_{part}.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import optimizer, trainer
    parts = {}
    grads = None
    for part in ("grads", "adamw"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if part == "grads":
                _, _, grads = trainer.loss_and_grads(state["params"], cfg,
                                                     batch, remat)
            else:
                optimizer.adamw_update(grads, state["opt"], state["params"],
                                       tcfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        parts[part] = (wall, kern)
        (OUT_DIR / f"{run}_train_{part}.txt").write_text(
            prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40))
    wall = sum(w for w, _ in parts.values())
    by_name = {}
    for _, kern in parts.values():
        for e in kern:
            by_name[e.key] = by_name.get(e.key, 0.0) \
                + e.self_device_time_total / 1e3
    dev_ms = sum(by_name.values())
    share = lambda keys: sum(v for k, v in by_name.items()
                             if any(x in k for x in keys)) / dev_ms
    adamw_ms = sum(e.self_device_time_total for e in parts["adamw"][1]) / 1e3
    row = dict(phase="train", run=run, arch=cfg.name, wall_ms=wall * 1e3,
               device_ms=dev_ms, device_busy_share=dev_ms / 1e3 / wall,
               flash_fwd_share=share(("flash_fwd_kernel",)),
               flash_bwd_share=share(("fb_dot_kernel", "fb_dkdv_kernel",
                                      "fb_dq_kernel")),
               flash_bwd_ms={k.split("<")[0].split("(")[0].strip()[-16:]: v
                             for k, v in by_name.items() if "fb_" in k},
               adamw_ms=adamw_ms, adamw_share=adamw_ms / dev_ms,
               top_device_ms=[[k[:70], v] for k, v in sorted(
                   by_name.items(), key=lambda kv: -kv[1])[:20]])
    emit(row)
    return row


def train_twin_check(torch, cfg, seq: int = 1024, batch: int = 4) -> dict:
    """2 of the model's layers at full width, one step's loss and
    gradients through the kernels, then through the twin's attention on
    the card (``twin_prefill``: autograd through ``attention_ref``): the
    losses within 1e-2 relative, every gradient's cosine >= 0.99, a
    gradient that is zero in the twin's run zero in the kernels'."""
    from repro_torch.config import TrainConfig
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.train import batches_for
    from repro_torch.models.transformer import init_params
    from repro_torch.train import trainer
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = init_params(cfg2, device="cuda", seed=1).requires_grad_(True)
    b = trainer.batch_to(next(batches_for(
        cfg2, SyntheticCorpus(cfg.vocab_size, seed=0),
        TrainConfig(batch_size=batch, seq_len=seq), 0, device="cuda")),
        "cuda")
    res = {}
    step = lambda: trainer.loss_and_grads(params, cfg2, b, "block")
    for name, run in (("kernel", lambda f: f()),
                      ("twin", lambda f: twin_prefill(torch, f))):
        loss, _, grads = run(step)
        res[name] = (float(loss), grads)
    lk, gk = res["kernel"]
    lt, gt = res["twin"]
    # a parameter the loss does not read (the encoder's token table) has a
    # zero gradient in both: equal, and no cosine
    unused = sorted(k for k in gk if not gt[k].any())
    unused_equal = all(not gk[k].any() for k in unused)
    cos = {k: float(torch.nn.functional.cosine_similarity(
        gk[k].float().flatten(), gt[k].float().flatten(), dim=0))
        for k in gk if k not in unused}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:5]
    row = dict(phase="train", run="kernel_vs_twin", arch=cfg.name,
               head_dim=cfg.head_dim, causal=cfg.causal, n_layers=2, seq=seq,
               batch=batch, loss_kernel=lk, loss_twin=lt,
               loss_rel_err=abs(lk - lt) / abs(lt), loss_tol=1e-2,
               min_grad_cosine=min(cos.values()), cosine_tol=0.99,
               worst_grad_cosines=worst, zero_grads=unused,
               zero_grads_equal=unused_equal,
               ok=abs(lk - lt) <= 1e-2 * abs(lt)
               and min(cos.values()) >= 0.99 and unused_equal)
    emit(row)
    return row


def train_restart_check(torch, cfg, root: str, steps: int = 8,
                        fault_at: int = 5, every: int = 3) -> dict:
    """``run_with_restarts`` around ``train_loop`` on ``cfg`` (bf16), a
    fault injected after the first checkpoint: the losses after the
    restart equal the uninterrupted run's, bit for bit.  The runs
    checkpoint under ``root`` (``root``/faulted, ``root``/clean), which
    the caller removes."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.config import TrainConfig
    from repro_torch.data import SyntheticCorpus
    from repro_torch.ft import run_with_restarts
    from repro_torch.launch.train import batches_for
    from repro_torch.train import trainer
    tcfg = TrainConfig(steps=steps, batch_size=4, seq_len=256, lr=1e-3,
                       warmup_steps=2, checkpoint_every=every, log_every=100)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)

    def run(fault: int, d: str) -> dict:
        losses, faulted = {}, []

        def on_step(i, m, _):
            if i == fault and not faulted:
                faulted.append(i)
                raise RuntimeError("injected fault")
            losses[i] = float(m["loss"])

        def train_once(start):
            state = trainer.init_state(cfg, tcfg, device="cuda")
            if start:
                state, start = ckpt.restore(d, state)
            return trainer.train_loop(
                cfg, tcfg, state=state,
                step_fn=trainer.make_train_step(cfg, tcfg),
                batches=batches_for(cfg, corpus, tcfg, start),
                start_step=start, ckpt_dir=d, log=lambda *_: None,
                on_step=on_step)

        run_with_restarts(train_once, d, log=lambda *_: None)
        return dict(losses=losses, faulted=faulted)

    faulted = run(fault_at, os.path.join(root, "faulted"))
    clean = run(-1, os.path.join(root, "clean"))
    equal = faulted["losses"] == clean["losses"] and \
        sorted(clean["losses"]) == list(range(steps))
    row = dict(phase="train", run="restart", arch=cfg.name,
               head_dim=cfg.head_dim, steps=steps, checkpoint_every=every,
               fault_at=fault_at, restarted=bool(faulted["faulted"]),
               losses_clean=[clean["losses"][i] for i in range(steps)],
               losses_resumed=[faulted["losses"].get(i)
                               for i in range(steps)],
               bitwise_equal=equal, ok=equal and bool(faulted["faulted"]))
    emit(row)
    return row


H_STABLE_LR = 1e-4


def train_compressed(torch, cfg, tcfg) -> dict:
    """(h) qwen2-1.5b at (a)'s shape, at two peak learning rates: (a)'s
    3e-4, and ``H_STABLE_LR``.  At each, 10 steps of ``make_train_step``,
    then 10 of ``make_compressed_train_step`` (int8 error-feedback
    gradients over this one rank), each from a fresh seeded state (bf16
    weights, f32 master and moments; the compressed one also an f32 ``ef``
    residual): per-step loss and ms, peak memory of each run.  Then the
    device time of ``compressed_mean_grads`` over one step's gradients,
    profiled, and ``wire_bytes`` for a world of 1 and of 8.  Every
    compressed loss must fall.  At (a)'s lr a 10-step schedule spikes the
    loss at step 4 in both runs (15.2 and 15.7 on an H100), so the two
    runs compare spike recovery, not convergence; the convergence check
    (the compressed last loss within 2% of the uncompressed one) is made
    at the stable lr, where neither spikes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import SyntheticCorpus
    from repro_torch.distributed import compression as gcomp
    from repro_torch.launch.train import batches_for
    from repro_torch.train import trainer
    rows, comp = [], None
    for lr in (tcfg.lr, H_STABLE_LR):
        tc = dataclasses.replace(tcfg, steps=10, lr=lr)
        runs = {}
        for compressed in (False, True):
            name = f"h_{'compressed' if compressed else 'plain'}_lr{lr:g}"
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            state = trainer.init_state(cfg, tc, device="cuda",
                                       dtype=torch.bfloat16,
                                       ef_residual=compressed)
            state_bytes = torch.cuda.memory_allocated()
            step_fn = (trainer.make_compressed_train_step if compressed
                       else trainer.make_train_step)(cfg, tc, remat="block")
            runs[compressed] = train_run(torch, cfg, tc, state, "block",
                                         name, step_fn=step_fn)
            runs[compressed]["state_bytes"] = state_bytes
            if compressed and comp is None:
                batch = trainer.batch_to(next(batches_for(
                    cfg, SyntheticCorpus(cfg.vocab_size, seed=0), tc,
                    tc.steps)), "cuda")
                _, _, grads = trainer.loss_and_grads(state["params"], cfg,
                                                     batch, "block")
                del batch
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    gcomp.compressed_mean_grads(grads, state["ef"])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                kern = [e for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA]
                (OUT_DIR / "h_compression_profile.txt").write_text(
                    prof.key_averages().table(
                        sort_by="self_device_time_total", row_limit=30))
                comp = dict(
                    wall_ms=wall * 1e3,
                    device_ms=sum(e.self_device_time_total
                                  for e in kern) / 1e3,
                    top_device_ms=[[e.key[:60],
                                    e.self_device_time_total / 1e3]
                                   for e in sorted(
                                       kern, key=lambda e:
                                       -e.self_device_time_total)[:8]],
                    wire_bytes={str(n): gcomp.wire_bytes(state["params"], n)
                                for n in (1, 8)})
                del grads
            del state, step_fn
        plain, cmp_ = runs[False], runs[True]
        lp = [st["loss"] for st in plain["steps"]]
        lc = [st["loss"] for st in cmp_["steps"]]
        rows.append(dict(
            phase="train", run=f"h_compression_lr{lr:g}", arch=cfg.name,
            lr=lr, batch=tc.batch_size, seq=tc.seq_len,
            loss_plain=lp, loss_compressed=lc,
            last_loss_rel_diff=abs(lc[-1] - lp[-1]) / abs(lp[-1]),
            median_step_ms_plain=plain["median_step_ms"],
            median_step_ms_compressed=cmp_["median_step_ms"],
            peak_memory_plain=plain["peak_memory"],
            peak_memory_compressed=cmp_["peak_memory"],
            peak_memory_extra=cmp_["peak_memory"] - plain["peak_memory"],
            state_bytes_plain=plain["state_bytes"],
            state_bytes_compressed=cmp_["state_bytes"],
            loss_falls=statistics.fmean(lc[-5:]) < lc[0],
            last_loss_within_2pct=abs(lc[-1] - lp[-1]) <= 0.02 * abs(lp[-1])))
    row = dict(phase="train", run="h_compression", arch=cfg.name,
               compression=comp, runs=rows)
    emit(row)
    bad = [r["run"] for r in rows if not r["loss_falls"]]
    if not rows[-1]["last_loss_within_2pct"]:
        bad.append(rows[-1]["run"] + ": last loss not within 2%")
    if bad:
        raise AssertionError(f"train (h) compression checks failed: {bad}")
    return row


ENCODER_ARCH = "hubert-xlarge"


def train_encoder(torch) -> dict:
    """(f) hubert-xlarge at full width and depth (48 layers, d 1280, 16 MHA
    heads of dh 80, d_ff 5120, vocab 504, non-causal, no RoPE), seeded,
    bf16 weights with f32 master and moments, through the launcher's own
    functions, on the reference's frontend stub (frames = rows of an
    N(0, 0.02) table at the corpus's tokens): B 8 x S 1024 frames (about
    20 s of 50 Hz audio a row), remat "block", 10 steps at lr 5e-5, warmup
    3; then a profiled step and 2 layers' kernel-vs-twin gradients.  The
    loss must fall, and a step must launch the flash forward 2 x 48 times
    and its backward 48 times, all of them the dh-80 instances."""
    from repro_torch.config import TrainConfig
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch import model_config
    from repro_torch.launch.train import batches_for
    from repro_torch.train import trainer
    cfg = model_config(ENCODER_ARCH, False, torch.device("cuda"))
    # a 48-layer model's first AdamW steps move every weight by about the
    # lr: at 1.5e-4 the first step took the loss from 6.57 to 10.61 on an
    # H100, so the peak is 5e-5 after 3 warmup steps
    tcfg = TrainConfig(steps=10, batch_size=8, seq_len=1024, lr=5e-5,
                       warmup_steps=3, log_every=100, checkpoint_every=10**9)
    t0 = time.perf_counter()
    state = trainer.init_state(cfg, tcfg, device="cuda",
                               dtype=torch.bfloat16)
    torch.cuda.synchronize()
    emit({"phase": "train", "arch": cfg.name,
          "params": sum(p.numel() for p in state["params"].parameters()),
          "init_s": time.perf_counter() - t0,
          "state_bytes": torch.cuda.memory_allocated()})
    f = train_run(torch, cfg, tcfg, state, "block", "f_hubert_block_S1024")
    losses = [st["loss"] for st in f["steps"]]
    falls = statistics.fmean(losses[-5:]) < losses[0]
    n = len(f["steps"])
    dh80 = (f["launches"]["flash_attention_dh80"] / n,
            f["launches"]["flash_attention_bwd_dh80"] / n)
    launches_ok = (f["flash_fwd_per_step"] == dh80[0] == 2 * cfg.n_layers
                   and f["flash_bwd_per_step"] == dh80[1] == cfg.n_layers)
    emit({"phase": "train", "run": "f_hubert_block_S1024",
          "first_loss": losses[0],
          "last5_mean_loss": statistics.fmean(losses[-5:]),
          "loss_drop": losses[0] - statistics.fmean(losses[-5:]),
          "loss_falls": falls, "head_dim": cfg.head_dim,
          "flash_dh80_fwd_per_step": dh80[0],
          "flash_dh80_bwd_per_step": dh80[1], "launches_ok": launches_ok})
    batch = trainer.batch_to(next(batches_for(
        cfg, SyntheticCorpus(cfg.vocab_size, seed=0), tcfg, tcfg.steps,
        device="cuda")), "cuda")
    prof = train_profile(torch, cfg, tcfg, state, batch, "block",
                         run="profile_hubert")
    del batch, state
    gc.collect()
    torch.cuda.empty_cache()
    twin = train_twin_check(torch, cfg, seq=1024, batch=8)
    bad = [k for k, ok in (("loss_falls", falls),
                           ("flash_launches", launches_ok),
                           ("kernel_vs_twin", twin["ok"]),
                           ("flash_bwd_share", prof["flash_bwd_share"] > 0))
           if not ok]
    if bad:
        raise AssertionError(f"train (f) hubert checks failed: {bad}")
    return f


def train_launchers(torch, ckpt_dir: str) -> dict:
    """(g) the launchers on the card: ``launch.serve.main`` with its
    defaults (reduced, ``--device cuda``) on yi-9b, then on the reduced
    qwen2-1.5b with ``--ckpt`` at (d)'s checkpoints: every request ends
    ok, and the second prints the restored step."""
    import contextlib
    import io
    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import serve
    runs = {}
    step = ckpt.latest_step(ckpt_dir)
    for name, argv in (("serve_defaults", ["--arch", "yi-9b"]),
                       ("serve_ckpt", ["--arch", TRAIN_ARCH, "--ckpt",
                                       ckpt_dir])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
        out = buf.getvalue().splitlines()
        summary = next((ln for ln in out if "requests ok" in ln), "")
        m = re.search(r"(\d+)/(\d+) requests ok", summary)
        ok = bool(m) and m.group(1) == m.group(2) != "0"
        if name == "serve_ckpt":
            ok = ok and f"[serve] loaded checkpoint step {step}" in out
        runs[name] = dict(argv=argv, seconds=time.perf_counter() - t0,
                          output=out, ok=ok)
        emit({"phase": "train", "run": f"g_{name}", **runs[name]})
    bad = [k for k, r in runs.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"train (g) launcher runs failed: {bad}")
    return runs


def phase_train(torch) -> dict:
    """qwen2-1.5b at full width and depth (28 layers, d 1536, 12 / 2 heads
    of dh 128, d_ff 8960, vocab 151,936, tied embeddings, QKV bias), seeded,
    bf16 weights with f32 master and moments, through the launcher's own
    functions.  (a) B 4 x S 4096, remat "block", 20 steps at lr 3e-4,
    warmup 5: per step loss, ce, grad norm, lr and ms, tokens/s, peak
    memory, flash launches a step; the loss must fall (the mean of the
    last five below the first).  (b) B 4 x S 2048, remat "none", 3 steps.
    (c) 2 layers at full width: kernels against twins.  (d) the reduced
    config (head_dim 64) through ``run_with_restarts`` with a fault after
    the first checkpoint: the resumed losses bit for bit.  (e) a profile
    of one step of (a).  (g) the serving launcher on the card: its
    defaults, then ``--ckpt`` at (d)'s checkpoints.  (f) hubert-xlarge at
    full width and depth (``train_encoder``).  (h) the compressed step
    against the plain one (``train_compressed``).  Returns the flash
    launches of runs (a) and (f)."""
    import shutil
    import tempfile
    from repro_torch.config import TrainConfig
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch import model_config
    from repro_torch.launch.train import batches_for
    from repro_torch.train import trainer
    cfg = model_config(TRAIN_ARCH, False, torch.device("cuda"))
    tcfg = TrainConfig(steps=20, batch_size=4, seq_len=4096, lr=3e-4,
                       warmup_steps=5, log_every=100, checkpoint_every=10**9)
    t0 = time.perf_counter()
    state = trainer.init_state(cfg, tcfg, device="cuda",
                               dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].parameters())
    emit({"phase": "train", "arch": cfg.name, "params": n_params,
          "init_s": time.perf_counter() - t0,
          "state_bytes": torch.cuda.memory_allocated()})
    a = train_run(torch, cfg, tcfg, state, "block", "a_block_S4096")
    losses = [st["loss"] for st in a["steps"]]
    falls = statistics.fmean(losses[-5:]) < losses[0]
    emit({"phase": "train", "run": "a_block_S4096", "first_loss": losses[0],
          "last5_mean_loss": statistics.fmean(losses[-5:]),
          "loss_drop": losses[0] - statistics.fmean(losses[-5:]),
          "loss_falls": falls})
    batch = trainer.batch_to(next(batches_for(
        cfg, SyntheticCorpus(cfg.vocab_size, seed=0), tcfg, tcfg.steps)),
        "cuda")
    prof = train_profile(torch, cfg, tcfg, state, batch, "block")
    del batch
    tcfg_b = dataclasses.replace(tcfg, steps=3, seq_len=2048)
    b = train_run(torch, cfg, tcfg_b, state, "none", "b_none_S2048")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    h = train_compressed(torch, cfg, tcfg)
    gc.collect()
    torch.cuda.empty_cache()
    twin = train_twin_check(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(dir=OUT_DIR)
    try:
        restart = train_restart_check(torch, model_config(
            TRAIN_ARCH, True, torch.device("cuda"), log=lambda *_: None),
            root)
        launchers = train_launchers(torch, os.path.join(root, "clean"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    bad = [n for n, ok in (("loss_falls", falls), ("kernel_vs_twin",
                                                   twin["ok"]),
                           ("restart", restart["ok"]),
                           ("flash_launches", a["flash_fwd_per_step"] ==
                            2 * cfg.n_layers and a["flash_bwd_per_step"]
                            == cfg.n_layers),
                           # the profile names the backward's kernels: a
                           # launched backward must not read as 0
                           ("flash_bwd_share", prof["flash_bwd_share"] > 0
                            or not a["flash_bwd_per_step"])) if not ok]
    if bad:
        raise AssertionError(f"train phase checks failed: {bad}")
    f = train_encoder(torch)
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_bwd": a["launches"]["flash_attention_bwd"],
            "flash_attention": a["launches"]["flash_attention"],
            "flash_attention_dh80": f["launches"]["flash_attention_dh80"],
            "flash_attention_bwd_dh80":
                f["launches"]["flash_attention_bwd_dh80"],
            "profile": prof, "b": b, "h": h, "launchers": launchers}


EXAMPLE_KERNELS = ("latent_topk", "sparse_recon_attention", "flash_attention",
                   "flash_attention_bwd")


def example_run(torch, name: str, fn) -> tuple:
    """``fn()`` (an example's ``main``) with its printed lines kept in
    ``chiprun_out/examples_{name}.txt``, the launch counters zeroed just
    before and read just after, and the peak device memory.  Returns (its
    result, a row of those)."""
    import contextlib
    import io
    from repro_torch.kernels import ops
    buf = io.StringIO()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
        torch.cuda.synchronize()
    finally:
        (OUT_DIR / f"examples_{name}.txt").write_text(buf.getvalue())
    row = dict(phase="examples", run=name,
               seconds=time.perf_counter() - t0,
               peak_memory=torch.cuda.max_memory_allocated(),
               launches={k: v for k, v in ops.launch_counts().items() if v},
               printed=buf.getvalue().splitlines()[-12:])
    return out, row


def phase_examples(torch) -> dict:
    """The port's examples through their ``main`` on the card (bf16, seeded
    weights): (a) quickstart, (b) multi_arch_smoke over the ten assigned
    architectures, (c) train_then_serve --full-100m at its 300 steps, (d)
    fault_tolerant_train.  Any exception fails the phase.  Returns the
    phase's launches of each kernel of its path, summed over the runs."""
    import shutil
    import tempfile
    from repro_torch.examples import (fault_tolerant_train,
                                      multi_arch_smoke, quickstart,
                                      train_then_serve)
    total = {}
    bad = []

    def add(row):
        for k, v in row["launches"].items():
            total[k] = total.get(k, 0) + v

    a, row = example_run(torch, "a_quickstart", lambda: quickstart.main([]))
    row.update(tokens=a["tokens"], agreement=a["agreement"],
               calibration_s=a["calibration_s"], engine_s=a["seconds"],
               wall_s=a["wall_s"], bytes_per_token=a["bytes_per_token"])
    emit(row)
    add(row)
    if any(len(t) != 12 for rows in a["tokens"].values() for t in rows):
        bad.append("a_tokens")

    b, row = example_run(torch, "b_multi_arch_smoke",
                         lambda: multi_arch_smoke.main([]))
    row.update(archs=b)
    emit(row)
    add(row)
    if [o["arch"] for o in b] != multi_arch_smoke.ASSIGNED_ARCHS or not all(
            np.isfinite(o["loss"]) and o.get("decode_finite", True)
            for o in b):
        bad.append("b_archs")

    # checkpoints of a 100M model: under build/, which no call brings back
    (ROOT / "build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(dir=ROOT / "build")
    try:
        steps = []
        c, row = example_run(torch, "c_train_then_serve", lambda: (
            train_then_serve.main(
                ["--full-100m", "--ckpt-dir", os.path.join(root, "e2e")],
                on_step=lambda i, m, dt: steps.append(
                    (float(m["loss"]), dt * 1e3)))))
        losses = [l for l, _ in steps]
        row.update(steps_run=c["steps_run"], train_s=c["train_s"],
                   first_loss=losses[0], last_loss=losses[-1],
                   last10_mean_loss=statistics.fmean(losses[-10:]),
                   median_step_ms=statistics.median(
                       [ms for _, ms in steps[1:]]),
                   stragglers=c["stragglers"],
                   calibration_s=c["calibration_s"], tok_s=c["tok_s"],
                   agreement=c["agreement"],
                   requests_done=c["requests_done"])
        del c
        emit(row)
        add(row)
        if row["steps_run"] != 300 \
                or not row["last10_mean_loss"] < losses[0] \
                or set(row["requests_done"].values()) != {8}:
            bad.append("c_train_then_serve")

        d, row = example_run(torch, "d_fault_tolerant_train", lambda: (
            fault_tolerant_train.main(
                [], ckpt_dir=os.path.join(root, "ft"))))
        row.update(restarts=d["restarts"], checkpoints=d["checkpoints"],
                   max_param_delta=d["max_delta"],
                   exact_recovery=d["max_delta"] < 1e-5)
        del d
        emit(row)
        add(row)
        if row["restarts"] != 2 or row["checkpoints"] != [25, 30] \
                or not row["exact_recovery"]:
            bad.append("d_fault_tolerant_train")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"examples phase checks failed: {bad}")
    return total


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


# ---------------------------------------------------------------------------
# mesh: the sharding layer (launch/specs.py over a DeviceMesh) at world 1
# ---------------------------------------------------------------------------

def mesh_start(torch):
    """A world-1 NCCL process group on a FileStore (no network) and the
    (1, 1) ("data", "model") mesh on the card.  Returns (mesh, store
    directory)."""
    import tempfile
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    d = tempfile.mkdtemp(prefix="mesh_store_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(d, "store"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    return DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model")), d


def mesh_train(torch, mesh) -> dict:
    """(a) qwen2-1.5b at full width and depth, B 4 x S 4096, block remat, 3
    steps: the plain ``make_train_step`` from seed 0, then ``build_train``'s
    step on the mesh from the same initial state (placed by its
    placements): per-step losses within 1e-5 relative, 56 + 28 flash
    launches a step, the max parameter delta, ms a step and peak memory
    of each."""
    from repro_torch.config import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.launch.train import batches_for
    from repro_torch.train import trainer
    cfg = get_config("qwen2-1.5b")
    shape = ShapeConfig("train_a", "train", 4096, 4)
    tcfg = TrainConfig(steps=3, batch_size=4, seq_len=4096, lr=3e-4,
                       warmup_steps=5)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    batches = [trainer.batch_to(b, "cuda") for b in
               (next(batches_for(cfg, corpus, tcfg, i)) for i in range(3))]
    mc = MeshConfig(shape=(1, 1), axis_names=("data", "model"),
                    seq_parallel=False)
    fn, like, in_pl, _ = specs.build_train(cfg, shape, mesh, mc,
                                           remat="block", tcfg=tcfg)
    runs = {}
    for name in ("plain", "mesh"):
        state = trainer.init_state(cfg, tcfg, device="cuda", seed=0)
        if name == "mesh":
            state = {k: shd.place(v, mesh, in_pl[0][k])
                     for k, v in state.items()}
            step = fn
            batch_pl = in_pl[1]
        else:
            step = trainer.make_train_step(cfg, tcfg, remat="block")
        losses, ms = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        for b in batches:
            t0 = time.perf_counter()
            state, m = step(state, shd.place(b, mesh, batch_pl)
                            if name == "mesh" else b)
            losses.append(float(m["loss"].to_local()
                                if shd.is_dtensor(m["loss"])
                                else m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        params = {k: (p.to_local() if shd.is_dtensor(p) else p).detach()
                  for k, p in state["params"].named_parameters()}
        runs[name] = dict(losses=losses, ms=ms, counts=counts,
                          peak_memory=torch.cuda.max_memory_allocated(),
                          params=params)
        del state, m
        gc.collect()
        torch.cuda.empty_cache()
    plain, mesh_run = runs["plain"], runs["mesh"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(mesh_run["losses"],
                                                  plain["losses"]))
    delta = max(float((mesh_run["params"][k].float()
                       - plain["params"][k].float()).abs().max())
                for k in plain["params"])
    fwd = mesh_run["counts"]["flash_attention"] / 3
    bwd = mesh_run["counts"]["flash_attention_bwd"] / 3
    row = dict(phase="mesh", run="a_train", arch=cfg.name, batch=4,
               seq=4096, remat="block", losses=mesh_run["losses"],
               plain_losses=plain["losses"], max_rel_loss_diff=rel,
               max_param_delta=delta, flash_fwd_per_step=fwd,
               flash_bwd_per_step=bwd,
               ms_per_step=statistics.median(mesh_run["ms"][1:]),
               plain_ms_per_step=statistics.median(plain["ms"][1:]),
               step_ms=mesh_run["ms"], plain_step_ms=plain["ms"],
               peak_memory=mesh_run["peak_memory"],
               plain_peak_memory=plain["peak_memory"],
               placements_at_rest=sorted({str(v) for v in
                                          in_pl[0]["params"].values()}))
    emit(row)
    if rel > 1e-5:
        raise AssertionError(f"mesh (a): losses {mesh_run['losses']} vs "
                             f"plain {plain['losses']}")
    if fwd != 2 * cfg.n_layers or bwd != cfg.n_layers:
        raise AssertionError(f"mesh (a): flash launches a step {fwd} + "
                             f"{bwd}, expected {2 * cfg.n_layers} + "
                             f"{cfg.n_layers}")
    return mesh_run["counts"]


def mesh_serve(torch, model, mesh, n_new: int = 32, seq: int = 4096,
               phase: str = "mesh", run: str = "b_serve",
               prompt: int = 0) -> dict:
    """(b) paper-llama2-7b at full width and depth with ``sals_for_shape``'s
    SALS at ShapeConfig("d4k", "decode", 4096, 4): ``build_prefill`` +
    ``build_decode`` (eager) on 4 prompts of 4096 - 32 tokens, 32 greedy
    tokens in both ``dist_mode``s, against ``ServeEngine.generate`` from
    the same weights, U_r and SALS config; launches of rows 1 and 2 (and
    the prefill's flash), ms a step.  The families phase's (e) runs it on
    its models at ``seq`` with ``prompt``-token prompts (an attention-free
    model: no SALS, no kernel).  Returns the "local" run's launch
    counts."""
    from repro_torch.config import MeshConfig, ServeConfig, ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import specs
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve import ServeEngine
    cfg, params, proj = model["cfg"], model["params"], model["proj"]
    shape = ShapeConfig("d", "decode", seq, 4)
    sals = specs.sals_for_shape(cfg, shape)
    plen = prompt or shape.seq_len - n_new
    prompts = [model["corpus"].batch(300 + i, 1, plen)["tokens"][0]
               for i in range(4)]
    eng = ServeEngine(params, proj, cfg, ServeConfig(
        max_seq_len=shape.seq_len, max_batch=4, sals=sals), device="cuda")
    want = np.stack([r.tokens for r in eng.generate(prompts,
                                                    max_new_tokens=n_new)])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    mc = MeshConfig(shape=(1, 1), axis_names=("data", "model"))
    tokens = torch.as_tensor(np.stack(prompts), device="cuda")
    out, counts = {}, {}
    for mode in ("local", "global"):
        pf = specs.build_prefill(cfg, shape, mesh, mc, dist_mode=mode)
        dc = specs.build_decode(cfg, shape, mesh, mc, dist_mode=mode)
        # a module over the same tensors, placed (the serve model stays)
        mod = Transformer(cfg, params.final_norm.scale.dtype, "meta")
        mod.load_state_dict(params.state_dict(), assign=True)
        pp = shd.place(mod, mesh, pf[2][0])
        pj = None if proj is None else shd.place(
            {k: proj[k] for k in ("u", "eigvals")}, mesh, pf[2][1])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ms = []
        with torch.no_grad():
            t0 = time.perf_counter()
            lg, cache = pf[0](pp, pj, shd.place({"tokens": tokens}, mesh,
                                                pf[2][2]))
            tok = lg.full_tensor().argmax(-1)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            toks = [tok]
            for t in range(n_new - 1):
                t0 = time.perf_counter()
                lg, cache = dc[0](pp, pj, cache,
                                  shd.place(tok, mesh, dc[2][3]),
                                  torch.tensor(plen + t, dtype=torch.int32,
                                               device="cuda"))
                tok = lg.full_tensor().argmax(-1)
                toks.append(tok)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        counts[mode] = ops.launch_counts()
        got = torch.stack(toks, 1).cpu().numpy()
        steps = n_new - 1
        row = dict(phase=phase, run=f"{run}_{mode}", arch=cfg.name,
                   n_layers=cfg.n_layers, batch=4, prompt=plen,
                   new_tokens=n_new, n_groups=next(
                       (v.n_groups for v in cache.values()
                        if hasattr(v, "n_groups")), None),
                   tokens_equal_generate=bool(np.array_equal(got, want)),
                   first_differing_step=next(
                       (i for i in range(n_new)
                        if not np.array_equal(got[:, i], want[:, i])), None),
                   prefill_s=prefill_s, ms_per_step=statistics.median(ms),
                   latent_topk_per_step=counts[mode]["latent_topk"] / steps,
                   recon_per_step=counts[mode]["sparse_recon_attention"]
                   / steps,
                   flash_prefill=counts[mode]["flash_attention"],
                   peak_memory=torch.cuda.max_memory_allocated())
        emit(row)
        out[mode] = row
        del pp, pj, cache, mod, lg
        gc.collect()
        torch.cuda.empty_cache()
    for mode, row in out.items():
        if not row["tokens_equal_generate"]:
            raise AssertionError(f"{phase} {run} {mode} {cfg.name}: tokens "
                                 f"differ from generate's at step "
                                 f"{row['first_differing_step']}")
        if row["latent_topk_per_step"] != model["n_sals"] or \
                row["recon_per_step"] != model["n_sals"] or \
                row["flash_prefill"] != (cfg.n_layers if cfg.has_attention
                                         else 0):
            raise AssertionError(f"{phase} {run} {mode}: launches {row}")
    return counts["local"]


def mesh_slabs(torch) -> dict:
    """(c) the shard-local body (``sparse_attention.shard_partials``) once
    per slab, as rank r of G would call it — slab-local operands (B, S/G,
    ·), base r·S/G — at the grouped phase's llama2-7b shape (B 4, S 4096,
    32 heads of dh 128, r 1024, r* 512, N_c 432), G 2 and 4: the stacked
    (m, l, o) bitwise equal to the folded plan's (``_grouped_partials``)."""
    from repro_torch.config import SALSConfig
    from repro_torch.configs import get_config
    from repro_torch.core import quantization as qz
    from repro_torch.core import selection as sel
    from repro_torch.core import sparse_attention as sa
    from repro_torch.core.latent_cache import LatentKVCache
    cfg = get_config("paper-llama2-7b")
    sals = SALSConfig()
    b, s, h, dh = 4, 4096, cfg.n_heads, cfg.head_dim
    kvd, r = cfg.kv_dim, sals.rank(cfg.kv_dim)
    gen = torch.Generator(device="cuda").manual_seed(81)
    pos = torch.tensor([s - 1 - 512 * i for i in range(b)],
                       dtype=torch.int32, device="cuda")
    k_lat = torch.randn((b, s, r), generator=gen, device="cuda").to(
        torch.bfloat16)
    vq = qz.quantize(torch.randn((b, s, kvd), generator=gen,
                                 device="cuda"), 8, 64)
    u = (torch.randn((kvd, r), generator=gen, device="cuda")
         * r ** -0.5).to(torch.bfloat16)
    q0 = torch.randn((b, h, dh), generator=gen, device="cuda").to(
        torch.bfloat16)
    q_bar = sel.group_query(q0, cfg)
    rows = []
    for g in (2, 4):
        cache = LatentKVCache(
            k_lat=k_lat, v_q=vq["q"], v_scale=vq["scale"], v_zero=vq["zero"],
            sink_k=None, sink_v=None, recent_k=None, recent_v=None,
            n_groups=g)
        fold = sa._grouped_partials(q0, q_bar, u, cache, pos, cfg, sals)
        s_loc = s // g
        parts = [sa.shard_partials(
            q0, q_bar, u, k_lat[:, i * s_loc:(i + 1) * s_loc].contiguous(),
            None, *(vq[k][:, i * s_loc:(i + 1) * s_loc].contiguous()
                    for k in ("q", "scale", "zero")),
            pos, i * s_loc, cfg, sals, g) for i in range(g)]
        stacked = [torch.cat([p[j] for p in parts], dim=1) for j in range(3)]
        torch.cuda.synchronize()
        equal = all(bool(torch.equal(x, y)) for x, y in zip(stacked, fold))
        row = dict(phase="mesh", run=f"c_slabs_G{g}", case=(
            f"llama2-7b B{b} S{s} r{r} r*{sals.score_rank(kvd)} "
            f"N_c {sals.n_critical}"), groups=g, slab=s_loc,
            k_loc=-(-sals.n_critical // g), bitwise_equal_fold=equal,
            max_abs_diff=max(float((x - y).abs().max())
                             for x, y in zip(stacked, fold)))
        emit(row)
        rows.append(row)
    bad = [r["groups"] for r in rows if not r["bitwise_equal_fold"]]
    if bad:
        raise AssertionError(f"mesh (c): shard-local slabs differ from the "
                             f"fold at G {bad}")
    return rows


def phase_mesh(torch, model) -> dict:
    """The sharding layer on the card at world 1 (see the module
    docstring, phase ``mesh``).  Returns the launches of the paths it
    drove: the flash forward and backward of (a), rows 1 and 2 and the
    prefill's flash of (b)."""
    import shutil
    import torch.distributed as dist
    mesh, store = mesh_start(torch)
    try:
        train = mesh_train(torch, mesh)
        serve = mesh_serve(torch, model, mesh)
        mesh_slabs(torch)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return {"flash_attention": train["flash_attention"]
            + serve["flash_attention"],
            "flash_attention_bwd": train["flash_attention_bwd"],
            "latent_topk": serve["latent_topk"],
            "sparse_recon_attention": serve["sparse_recon_attention"]}


def phase_pipe(torch) -> dict:
    """GPipe (``distributed/pipeline.py``) at P = 1 on the card: the
    world-1 NCCL group of ``mesh_start`` (one card holds one stage: NCCL
    refuses two ranks on one device, and gloo sends no CUDA tensors;
    multi-stage runs are held on CPU ranks by the tests).  qwen2-1.5b at
    full width and depth, bf16, M 4 microbatches of B 1 x S 4096,
    ``block_fn`` the stage's blocks under block remat, against the plain
    path (the mean over microbatches of ``forward_loss``, then
    ``torch.autograd.grad``): the loss within 1e-5 relative, every
    gradient within ``FLASH_BWD_TOL`` of its tensor's max; flash forward
    and backward launches a step, ms a step (median of 3), peak memory,
    ``bubble_fraction(4, 1)``.  Returns the pipelined steps' launches."""
    import shutil
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.distributed.pipeline import (bubble_fraction, gpipe_loss,
                                                  stage_slice)
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import embed_apply, rmsnorm_apply
    cfg = get_config("qwen2-1.5b")
    n_micro, b, s = 4, 1, 4096
    params = tf.init_params(cfg, device="cuda", seed=0)
    params.requires_grad_(True)
    leaves = list(params.parameters())
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    mbs = [corpus.batch(i, b, s) for i in range(n_micro)]
    batch = {k: torch.as_tensor(np.stack([m[k] for m in mbs]),
                                device="cuda") for k in ("tokens", "labels")}
    positions = torch.arange(s, device="cuda")[None, :]

    def plain():
        loss = sum(tf.forward_loss(params, cfg, {k: v[i] for k, v in
                                                 batch.items()},
                                   remat="block")[0]
                   for i in range(n_micro)) / n_micro
        return loss, torch.autograd.grad(loss, leaves)

    def block_fn(blocks, x):
        for bp in blocks:
            x = tf._checkpointed(lambda x_in, bp=bp: tf._block_fwd(
                bp, x_in, cfg, positions, 0, False)[0], "block", x)
        return x

    def embed_fn(io, mb):
        return embed_apply(io["embed"], mb["tokens"], cfg)

    def head_loss_fn(io, x, mb):
        return tf.head_loss(io["embed"], cfg, rmsnorm_apply(
            io["final_norm"], x, cfg.norm_eps), mb["labels"])

    _, store = mesh_start(torch)
    try:
        p = dist.get_world_size()
        blocks = stage_slice(params.blocks, dist.get_rank(), p, cfg.n_layers)
        io = {"embed": params.embed, "final_norm": params.final_norm}
        loss_fn = gpipe_loss(block_fn, embed_fn, head_loss_fn)

        def piped():
            loss = loss_fn(blocks, io, batch)
            return loss, torch.autograd.grad(loss, leaves)

        want_loss, want = plain()
        got_loss, got = piped()                 # also the warm-up
        torch.cuda.synchronize()
        got_loss, want_loss = (float(x.detach()) for x in (got_loss,
                                                           want_loss))
        rel = abs(got_loss - want_loss) / abs(want_loss)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        del got, want
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            piped()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    fwd, bwd = (counts[k] / 3 for k in ("flash_attention",
                                         "flash_attention_bwd"))
    row = dict(phase="pipe", arch=cfg.name, stages=p, microbatches=n_micro,
               batch=b, seq=s, remat="block", loss=got_loss,
               plain_loss=want_loss, rel_loss_diff=rel,
               loss_tol=1e-5, max_grad_rel_err=max(errs),
               grad_tol=FLASH_BWD_TOL, flash_fwd_per_step=fwd,
               flash_bwd_per_step=bwd, ms_per_step=statistics.median(ms),
               step_ms=ms, peak_memory=peak,
               bubble_fraction=bubble_fraction(n_micro, p))
    emit(row)
    del params, leaves, batch
    gc.collect()
    torch.cuda.empty_cache()
    if rel > 1e-5 or max(errs) > FLASH_BWD_TOL:
        raise AssertionError(f"pipe: loss {rel} / gradients {max(errs)} "
                             f"against the plain path")
    if fwd != 2 * n_micro * cfg.n_layers or bwd != n_micro * cfg.n_layers:
        raise AssertionError(f"pipe: flash launches a step {fwd} + {bwd}")
    return {k: counts[k] for k in ("flash_attention", "flash_attention_bwd")}


def roofline_row(name, rep, cost, ms) -> dict:
    """A roofline report's terms beside the measured step ms."""
    bound_ms = rep.step_seconds * 1e3
    return dict(phase="roofline", run=name, arch=rep.arch, shape=rep.shape,
                flops=rep.hlo_flops, bytes=rep.hlo_bytes,
                collective_bytes=rep.collective_bytes,
                t_compute_ms=rep.t_compute * 1e3,
                t_memory_ms=rep.t_memory * 1e3,
                t_collective_ms=rep.t_collective * 1e3, bound=rep.bound,
                bound_ms=bound_ms, roofline_fraction=rep.roofline_fraction,
                model_flops=rep.model_flops, useful_ratio=rep.useful_ratio,
                mfu=rep.mfu, memory=cost.memory,
                kernels={k: v for k, v in cost.ops.items()
                         if not k.startswith(("aten.", "_c10d", "c10d"))},
                ms=ms, median_ms=statistics.median(ms),
                measured_over_bound=statistics.median(ms) / bound_ms)


def phase_roofline(torch, model) -> list:
    """``analysis.analyze_step`` once on the card over (1) the plain
    qwen2-1.5b train step (B 4 x S 4096, block remat, f32 master and
    moments) and (2) the serve model's SALS-25% paper-llama2-7b decode step
    at the serve phase's replayed shape (4 rows after prefills of 4096 ...
    2560 tokens, max_seq 4160), eager; each step's per-device flops,
    bytes, three terms, bound and ``roofline_fraction`` on the H100
    constants of ``analysis/roofline.py``, then the step timed without the
    counter (median of 3; the decode step also replayed through the
    engine's CUDA graph) over the bound."""
    from repro_torch.analysis import analyze_step, roofline
    from repro_torch.config import ServeConfig, ShapeConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.train import batches_for
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ServeEngine
    from repro_torch.train import trainer

    def timed(fn, n=3):
        ms = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    rows = []
    cfg = get_config("qwen2-1.5b")
    tcfg = TrainConfig(steps=4, batch_size=4, seq_len=4096, lr=3e-4,
                       warmup_steps=5)
    state = trainer.init_state(cfg, tcfg, device="cuda", seed=0)
    batch = trainer.batch_to(next(batches_for(
        cfg, SyntheticCorpus(cfg.vocab_size, seed=0), tcfg, 0)), "cuda")
    step = trainer.make_train_step(cfg, tcfg, remat="block")
    cost, _ = analyze_step(step, state, batch)
    rep = roofline(cfg.name, cfg, ShapeConfig("train_a", "train", 4096, 4),
                   "single", 1, cost, cost.memory["peak_bytes"])
    rows.append(roofline_row("train", rep, cost,
                             timed(lambda: step(state, batch))))
    emit(rows[-1])
    del state, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    cfg, sals = model["cfg"], model["sals"]
    lens = [4096, 3584, 3072, 2560]
    prompts = [model["corpus"].batch(100 + i, 1, n)["tokens"][0]
               for i, n in enumerate(lens)]
    eng = ServeEngine(model["params"], model["proj"], cfg, ServeConfig(
        max_seq_len=4160, max_batch=4, sals=sals), device="cuda")
    with torch.inference_mode():
        logits, cache, host_lens = prefill_batch(torch, eng, prompts)
        args = (eng.params, eng.projectors, cache,
                logits.argmax(-1).to(torch.int32),
                torch.as_tensor(host_lens, device="cuda"), cfg, sals)
        cost, _ = analyze_step(tf.decode_step, *args)
        rep = roofline(cfg.name, cfg, ShapeConfig("d4k", "decode", 4096, 4),
                       "single", 1, cost, cost.memory["peak_bytes"])
        row = roofline_row("decode_sals25", rep, cost,
                           timed(lambda: tf.decode_step(*args)))
        tok = args[3]
        eng.decode(tok, cache, host_lens)       # captures the step program
        replay = timed(lambda: eng.decode(tok, cache, host_lens))
    row.update(replayed_ms=replay,
               replayed_over_bound=statistics.median(replay)
               / row["bound_ms"])
    rows.append(row)
    emit(row)
    del eng, cache, logits, args
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_dryrun(torch) -> dict:
    """``python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape
    decode_32k`` with no CUDA device visible: the fake 256-rank process
    group and the meta step on this machine's torch; it must exit 0 with
    status ``ok``."""
    out = OUT_DIR / "dryrun"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", "qwen2-1.5b", "--shape", "decode_32k",
                           "--out", str(out)], capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(ROOT))
    path = out / "qwen2-1.5b.decode_32k.pod16x16.json"
    rec = json.loads(path.read_text()) if path.exists() else {}
    row = dict(phase="dryrun", returncode=proc.returncode,
               status=rec.get("status"), error=rec.get("error"),
               wall_s=time.perf_counter() - t0, run_s=rec.get("run_s"),
               roofline=rec.get("roofline"),
               memory_analysis=rec.get("memory_analysis"),
               stdout=proc.stdout.strip().splitlines()[:5])
    emit(row)
    if proc.returncode != 0 or rec.get("status") != "ok":
        raise AssertionError(f"dryrun: rc {proc.returncode}, "
                             f"{rec.get('status')}: {proc.stderr[-2000:]}")
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (add 'profile' for decode and prefill-chunk profiles,"
                    " 'scan' for the recon body over N_c x r)")
    phases = ap.parse_args().phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

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
          "nvcc_seconds": _build.build_seconds,
          "ptxas": ptxas_stats(_build.build_log)})
    (OUT_DIR / "build.log").write_text(_build.build_log)

    seconds = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()

    def lap(name):      # wall seconds of the phase that just ended
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    kern = phase_kernels(torch, scan="scan" in phases) \
        if "kernels" in phases else {}
    lap("kernels")
    counts, grouped = {}, {}
    if "tier" in phases and "sched" not in phases:
        raise SystemExit("the tier phase compares with the sched phase's "
                         "untiered paged run: add sched")
    mesh, pipe = {}, {}
    if any(p in phases for p in ("serve", "sched", "quality", "spec",
                                 "slo", "obs", "grouped", "mesh", "pipe",
                                 "roofline")):
        model = build_model(torch)
        lap("model")
        serve_sals = None
        if "serve" in phases:
            serve_sals = phase_serve(torch, model, prof="profile" in phases)
            for k in ("latent_topk", "sparse_recon_attention",
                      "flash_attention"):
                counts[k] = serve_sals[0]["launches"][k]
            lap("serve")
        if "quality" in phases:
            counts["latent_score"] = phase_quality(torch, model)[
                "latent_score"]
            lap("quality")
        if "sched" in phases:
            # the paged kernels' launches come from the sched paged run
            paged, paged_toks, paged_wall = phase_sched(
                torch, model, prof="profile" in phases)
            for k in ("latent_topk_paged", "sparse_recon_attention_paged"):
                counts[k] = paged[k]
            lap("sched")
            if "tier" in phases:
                phase_tier(torch, model, paged_toks, paged_wall)
                lap("tier")
        if "spec" in phases:
            # the window kernels' launches: generate_speculative at long
            # context (dense), the speculative scheduler's paged run
            spec = phase_spec(torch, model, serve_sals,
                              prof="profile" in phases)
            counts["sparse_recon_attention_window"] = \
                spec["long"][1]["sparse_recon_attention_window"]
            counts["sparse_recon_attention_window_paged"] = \
                spec["paged"]["sparse_recon_attention_window_paged"]
            lap("spec")
        slo_gold = None
        if "slo" in phases:
            slo_gold = phase_slo(torch, model)[1]
            lap("slo")
        if "obs" in phases:
            phase_obs(torch, model, paged_toks if "sched" in phases
                      else None, slo_gold)
            lap("obs")
        if "grouped" in phases:
            # at 8 of 32 layers (5 SALS layers), so that the families
            # phase fits the run's time
            grouped = phase_grouped(torch, depth_view(torch, model,
                                                      GROUPED_LAYERS))
            lap("grouped")
        if "mesh" in phases:
            mesh = phase_mesh(torch, model)
            lap("mesh")
        if "pipe" in phases:
            pipe = phase_pipe(torch)
            lap("pipe")
        if "roofline" in phases:
            phase_roofline(torch, model)
            lap("roofline")
        del model, serve_sals
        gc.collect()      # engines and step graphs hold reference cycles
        torch.cuda.empty_cache()
    if "dryrun" in phases:
        phase_dryrun(torch)
        lap("dryrun")
    vlm = {}
    if "vlm" in phases:
        vlm = phase_vlm(torch, prof="profile" in phases)
        lap("vlm")
    fam, fam_mesh = {}, {}
    if "families" in phases:
        fam, fam_mesh = phase_families(torch)
        lap("families")
    train = {}
    if "train" in phases:
        train = phase_train(torch)
        # the dh-80 instances' path is hubert-xlarge's training run (f)
        for k in ("flash_attention_bwd", "flash_attention_dh80",
                  "flash_attention_bwd_dh80"):
            counts[k] = train[k]
        lap("train")
    examples = {}
    if "examples" in phases:
        examples = phase_examples(torch)
        lap("examples")
    if "whole" in phases:
        phase_whole(torch)
        lap("whole")
    emit({"phase": "seconds", **seconds})

    replaces = {
        "latent_topk": ("src/repro_torch/csrc/latent_topk.cu",
                        "src/repro/kernels/latent_score.py:374"),
        "sparse_recon_attention": (
            "src/repro_torch/csrc/sparse_recon_attention.cu",
            "src/repro/kernels/sparse_recon_attention.py:747"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:93"),
        "latent_topk_paged": ("src/repro_torch/csrc/latent_topk.cu",
                              "src/repro/kernels/latent_score.py:281"),
        "sparse_recon_attention_paged": (
            "src/repro_torch/csrc/sparse_recon_attention.cu",
            "src/repro/kernels/sparse_recon_attention.py:462"),
        "sparse_recon_attention_window": (
            "src/repro_torch/csrc/sparse_recon_attention.cu",
            "src/repro/kernels/sparse_recon_attention.py:273"),
        "sparse_recon_attention_window_paged": (
            "src/repro_torch/csrc/sparse_recon_attention.cu",
            "src/repro/kernels/sparse_recon_attention.py:644"),
        "latent_score": ("src/repro_torch/csrc/latent_topk.cu",
                         "src/repro/kernels/latent_score.py:164"),
        # the reference's custom VJP of its training attention (XLA)
        "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                "src/repro/kernels/ops.py:161"),
        # the head_dim 80 instances (hubert-xlarge's training path)
        "flash_attention_dh80": ("src/repro_torch/csrc/flash_attention.cu",
                                 "src/repro/kernels/flash_attention.py:93"),
        "flash_attention_bwd_dh80": (
            "src/repro_torch/csrc/flash_attention_bwd_dh80.cu",
            "src/repro/kernels/ops.py:161"),
    }
    training_only = ("latent_score", "flash_attention_bwd",
                     "flash_attention_dh80", "flash_attention_bwd_dh80")
    rows = []
    for name, (src, rep) in replaces.items():
        if name.endswith("_dh80"):      # its case at hubert-xlarge's shape
            main_case = next((c for c in kern.get(name[:-5], [])
                              if "hubert" in c["case"]), {})
        else:
            main_case = kern[name][0] if name in kern else {}
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": counts.get(name),
                     "max_abs_err": main_case.get("max_abs_err"),
                     "ms": main_case.get("ms"),
                     "graph_ms": main_case.get("graph_ms"),
                     "plain_ms": main_case.get("plain_ms"),
                     "bound_ms": main_case.get("bound_ms"),
                     "bound_by": main_case.get("bound_by"),
                     "library_ms": main_case.get("library_ms"),
                     # paligemma-3b's paths (the vlm phase), dh 256
                     "vlm_launches": vlm.get(name),
                     # the grouped layout's paths (G 4, the grouped phase)
                     "grouped_launches": grouped.get(name),
                     # the moe / hybrid paths (the families phase)
                     "families_launches": fam.get(name, 0 if fam and name
                                                  not in training_only
                                                  else None),
                     # qwen2-1.5b's training run (a), hubert-xlarge's (f)
                     # for the dh-80 rows (the train phase)
                     "train_launches": train.get(name),
                     # the port's examples (the examples phase)
                     "examples_launches": examples.get(name, 0)
                     if examples and name in EXAMPLE_KERNELS else None,
                     # the sharding layer's steps on the (1, 1) mesh
                     "mesh_launches": mesh.get(name),
                     # GPipe's pipelined steps (the pipe phase)
                     "pipe_launches": pipe.get(name),
                     # the families' sharded serving and training on the
                     # (1, 1) mesh (the families phase's (e)): rows 1-3b
                     "families_mesh_launches": fam_mesh.get(name, 0)
                     if fam_mesh and name in FAMILY_MESH_KERNELS else None})
    emit({"kernels": rows})
    idle = [r["name"] for r in rows if r["launches"] == 0
            or r["vlm_launches"] == 0 or r["grouped_launches"] == 0
            or r["families_launches"] == 0 or r["train_launches"] == 0
            or r["examples_launches"] == 0 or r["mesh_launches"] == 0
            or r["pipe_launches"] == 0 or r["families_mesh_launches"] == 0]
    if idle:    # None: its path did not run; 0: it ran without the kernel
        raise AssertionError(f"kernels never launched on their path: {idle}")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
