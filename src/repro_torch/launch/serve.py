"""Serving launcher of the port: SALS-compressed continuous batching on the
card (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --requests 8 --max-new-tokens 32 [--sals 0.25|0.125|off] \
        [--page-size 16] [--spec-window 4] [--full] [--device cpu] \
        [--temperature 0.7] [--priority-classes 2 --preempt-policy park] \
        [--metrics-out m.prom|m.json] [--trace-out t.json] [--stream]

Weights are random, from ``--seed``.  Calibrates the SALS projectors on the
synthetic corpus (paper §5.1), builds the engine, runs the requests through
``RequestScheduler`` and reports tokens/s.  ``--reduced`` (the default) is
the tiny same-family configuration; ``--full`` the published widths.
Requests round-robin the priority classes and two demo tenants, so the SLO
machinery runs when its flags enable it.  ``--metrics-out``,
``--trace-out`` or ``--obs-snapshot-every`` turn telemetry on
(``repro_torch.obs``: the metrics registry, the span tracer and, with
SALS, the byte accountant) before the scheduler is built; ``--stream``
stamps each request's tokens as a streaming client sees them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import SALSConfig, ServeConfig
from repro_torch.configs import _ARCH_MODULES, get_config
from repro_torch.core import calibration as cal
from repro_torch.data import CalibrationSampler, SyntheticCorpus
from repro_torch.models import transformer as tf
from repro_torch import obs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import RequestTimeline
from repro_torch.serve import Request, RequestScheduler, ServeEngine
from repro_torch.serve.engine import resolve_device


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


def write_metrics(registry, path: str) -> None:
    """Write ``registry`` to ``path``: the JSON snapshot for a ``.json``
    path, Prometheus text exposition otherwise."""
    with open(path, "w") as f:
        f.write(obs_metrics.snapshot_to_json(registry)
                if path.endswith(".json") else registry.to_prometheus())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(_ARCH_MODULES),
                    help="a vlm arch (paligemma-3b) serves tokens only, as "
                         "the reference's launcher does")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--sals", default="0.25",
                    choices=("0.25", "0.125", "off"))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="chunked-prefill width; --max-seq must be a "
                         "multiple of it")
    ap.add_argument("--prefill-budget", type=int, default=256,
                    help="prefill tokens spent between decode steps")
    ap.add_argument("--page-size", type=int, default=0,
                    help="tokens per page of the paged latent cache (0 = "
                         "dense slot arena); must divide --max-seq and be "
                         "a multiple of --prefill-chunk")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="page-pool size (0 = max-batch·max-seq/page-size)")
    ap.add_argument("--hbm-pages", type=int, default=0,
                    help="two-tier page pool: device payload slots of the "
                         "hot tier (0 = every page resident).  Needs "
                         "--page-size; >= max-batch + 1 (each resident "
                         "pins its write page hot) and <= the pool size.  "
                         "Score columns stay resident for every page; "
                         "other payloads spill to pinned host mirrors")
    ap.add_argument("--no-tier-prefetch", dest="tier_prefetch",
                    action="store_false", default=True,
                    help="two-tier pool: no selection-driven prefetch; cold "
                         "pages are fetched on demand only, inside the "
                         "fetch-and-rerun decode step")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false", default=True,
                    help="disable copy-on-write prefix sharing (paged)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded pending queue (0 = unbounded)")
    ap.add_argument("--queue-policy", default="reject",
                    choices=("reject", "shed-oldest"))
    ap.add_argument("--request-timeout-steps", type=int, default=0)
    ap.add_argument("--request-timeout-ms", type=float, default=0.0)
    ap.add_argument("--max-request-retries", type=int, default=2)
    ap.add_argument("--spec-window", type=int, default=0,
                    help="speculative decoding: verify-window width Q in "
                         "[2, 8] (0/1 = off); each decode step drafts Q-1 "
                         "tokens per row by n-gram prompt lookup and "
                         "verifies them in one windowed forward (greedy)")
    ap.add_argument("--priority-classes", type=int, default=1,
                    help="SLO scheduling: number of priority classes; "
                         "requests carry priority in [0, N) and admission "
                         "always serves the highest eligible class first.  "
                         ">1 with --preempt-policy park needs --page-size "
                         "(parked victims keep pages)")
    ap.add_argument("--preempt-policy", default="park",
                    choices=("park", "evict", "none"),
                    help="what a strictly higher waiting class does to the "
                         "lowest resident when no slot is free: park = "
                         "host-snapshot the victim's rows and HOLD its "
                         "pages (resume is token-exact, no re-prefill); "
                         "evict = requeue and re-prefill later; none = "
                         "priority orders admission only")
    ap.add_argument("--tenant-quantum", type=int, default=256,
                    help="deficit-round-robin quantum (tokens) for "
                         "admission across tenant_ids within one priority "
                         "class — one burst-happy tenant cannot monopolize "
                         "slots")
    ap.add_argument("--tenant-rate", type=float, default=0.0,
                    help="per-tenant admission rate limit: tokens of "
                         "credit accrued per scheduler iteration (0 = "
                         "unlimited); admission debits prompt + decode "
                         "budget, pacing bursts instead of rejecting them")
    ap.add_argument("--tenant-max-inflight", type=int, default=0,
                    help="per-tenant cap on requests holding serving "
                         "resources (resident + parked + admitting); "
                         "0 = uncapped")
    ap.add_argument("--gauge-history", type=int, default=0,
                    help="ring-buffer cap on the observability ledgers "
                         "(admissions / prefill chunks / pool gauges) and "
                         "the tenant gauges; 0 = unbounded")
    ap.add_argument("--audit-every", type=int, default=0,
                    help="run the pager invariant audit every N steps")
    ap.add_argument("--stream", action="store_true",
                    help="attach an on_token callback to every request "
                         "and report per-request TTFT + p99 inter-token "
                         "gap as a streaming client would observe them")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics registry at drain: a path "
                         "ending in .json gets the JSON snapshot, anything "
                         "else Prometheus text exposition")
    ap.add_argument("--trace-out", default="",
                    help="write per-request lifecycle spans as Chrome-"
                         "trace-event JSON (load in Perfetto)")
    ap.add_argument("--obs-snapshot-every", type=int, default=0,
                    help="re-export --metrics-out every N scheduler steps "
                         "while serving (0 = only at drain); implies "
                         "telemetry on")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = tf.init_params(cfg, device=dev, seed=args.seed)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=args.seed)
    sals, projectors = None, None
    if args.sals != "off":
        sals = SALSConfig(
            rank_ratio=float(args.sals),
            v_bits=8 if args.sals == "0.25" else 4,
            n_critical=64, n_sink=4, n_recent=16,
            v_group=min(32, cfg.kv_dim),
            skip_layers_front=min(2, cfg.n_layers - 1), skip_layers_back=1)
        projectors = calibrate(params, cfg, sals, corpus)
        print(f"[serve] calibrated projectors in {projectors['seconds']:.1f}s "
              f"(rank {sals.rank(cfg.kv_dim)}/{cfg.kv_dim})")
    if args.page_size and sals is None:
        raise SystemExit("--page-size needs SALS latent segments "
                         "(--sals 0.25|0.125)")
    scfg = ServeConfig(max_seq_len=args.max_seq, max_batch=args.max_batch,
                       max_new_tokens=args.max_new_tokens,
                       prefill_chunk=args.prefill_chunk,
                       prefill_token_budget=args.prefill_budget,
                       page_size=args.page_size, n_pages=args.n_pages,
                       hbm_pages=args.hbm_pages,
                       tier_prefetch=args.tier_prefetch,
                       prefix_cache=args.prefix_cache,
                       max_queue=args.max_queue,
                       queue_policy=args.queue_policy,
                       request_timeout_steps=args.request_timeout_steps,
                       request_timeout_ms=args.request_timeout_ms,
                       max_request_retries=args.max_request_retries,
                       audit_every=args.audit_every,
                       spec_window=args.spec_window,
                       temperature=args.temperature,
                       priority_classes=args.priority_classes,
                       preempt_policy=args.preempt_policy,
                       tenant_quantum=args.tenant_quantum,
                       tenant_rate=args.tenant_rate,
                       tenant_max_inflight=args.tenant_max_inflight,
                       gauge_history=args.gauge_history,
                       sals=sals or SALSConfig(enabled=False))
    engine = ServeEngine(params, projectors, cfg, scfg, device=dev)
    # telemetry goes in BEFORE the scheduler is built: it adopts the
    # active registry, tracer and accountant in __init__
    obs_handles = None
    if args.metrics_out or args.trace_out or args.obs_snapshot_every:
        obs_handles = obs.enable(gauge_history=args.gauge_history, cfg=cfg,
                                 sals=sals, with_traffic=sals is not None)
    try:
        _serve(args, engine, corpus, obs_handles)
    finally:
        if obs_handles is not None:
            obs.disable()


def _serve(args, engine: ServeEngine, corpus, obs_handles) -> None:
    """Submit the requests, run the scheduler, report; ``obs_handles`` is
    what ``obs.enable`` returned, or None with telemetry off."""
    dev = engine.device
    sched = RequestScheduler(engine)
    timeline = None
    if args.stream:
        timeline = RequestTimeline(
            registry=obs_handles["registry"] if obs_handles else None)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = max(4, args.prompt_len + int(rng.integers(-8, 8)))
        prompt = corpus.batch(50_000 + i, 1, plen)["tokens"][0]
        # round-robin the priority classes and two demo tenants
        req = Request(prompt, max_new_tokens=args.max_new_tokens,
                      priority=i % args.priority_classes,
                      tenant_id=f"tenant{i % 2}")
        if timeline is not None:
            timeline.submitted(req.req_id)
            timeline.attach(req)
        sched.submit(req)
    on_step = None
    if args.obs_snapshot_every and args.metrics_out:
        def on_step(_sched, step, _every=args.obs_snapshot_every):
            if step % _every == 0:
                write_metrics(obs_handles["registry"], args.metrics_out)
    t0 = time.perf_counter()
    done = sched.run(on_step=on_step)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    ok = [r for r in done if r.done]
    total_new = sum(r.result.steps for r in ok)
    print(f"[serve] {len(ok)}/{len(done)} requests ok, {total_new} tokens "
          f"in {dt:.2f}s -> {total_new / dt:.1f} tok/s (sals={args.sals}, "
          f"arch={args.arch}, page_size={args.page_size}, device={dev}, "
          f"{sched.steps} decode steps, {len(sched.prefill_chunks)} prefill "
          f"chunks, prefix hits {sched.prefix_hits})")
    if sched.tiered:
        hh = max((g["host_pages"] for g in sched.pool_gauges), default=0)
        print(f"[serve] two-tier: {args.hbm_pages} hot slots, "
              f"host high-water {hh} pages, spills={sched.pool.spills} "
              f"fetch_hits={sched.fetch_hits} "
              f"prefetch_hits={sched.prefetch_hits} "
              f"cold_misses={sched.cold_misses}")
    if args.spec_window > 1 and sched.spec_rounds:
        acc = sched.spec_accepted / max(1, sched.spec_proposed)
        print(f"[serve] speculative: window {args.spec_window}, "
              f"{sched.spec_rounds} verify rounds, "
              f"{sched.spec_committed} tokens committed "
              f"({sched.spec_committed / sched.spec_rounds:.2f}/round), "
              f"draft acceptance {acc:.1%}")
    if args.priority_classes > 1:
        print(f"[serve] slo: {args.priority_classes} classes "
              f"(policy={args.preempt_policy}), parks={sched.parks} "
              f"resumes={sched.resumes} preemptions={sched.preemptions}")
    if args.tenant_rate or args.tenant_max_inflight or \
            len(sched.tenant_gauges) > 1:
        for tenant, g in sorted(sched.tenant_gauges.items()):
            print(f"[serve] tenant {tenant}: {g['admitted']}/"
                  f"{g['submitted']} admitted "
                  f"({g['admitted_tokens']} tokens), deferrals "
                  f"rate={g['rate_deferrals']} cap={g['cap_deferrals']}, "
                  f"max wait {g['max_wait_steps']} steps")
    bad = [r for r in done if not r.done]
    if bad:
        print("[serve] terminal non-success: "
              + ", ".join(f"req {r.req_id}={r.state.value}" for r in bad))
    if timeline is not None:
        s = timeline.summary()
        if s["ttft_p50_ms"] is not None:
            print(f"[serve] streaming: p50 ttft {s['ttft_p50_ms']:.1f}ms, "
                  f"p99 inter-token {s['inter_token_p99_ms'] or 0:.1f}ms "
                  f"(client-observed, includes queueing)")
    if obs_handles is None:
        return
    if args.metrics_out:
        write_metrics(obs_handles["registry"], args.metrics_out)
        print(f"[serve] metrics -> {args.metrics_out}")
    if args.trace_out:
        tracer = obs_handles["tracer"]
        tracer.dump(args.trace_out)
        print(f"[serve] trace -> {args.trace_out} ({tracer.ended} spans, "
              f"{'balanced' if tracer.balanced() else 'UNBALANCED'})")
    traffic = obs_handles["traffic"]
    if traffic is not None and traffic.reconciled:
        rep = traffic.report()
        meas = sum(rep["measured"].values())
        print(f"[serve] traffic: {rep['reconciled']} steps reconciled vs "
              f"repro_torch/obs/ledger.py, {meas / 1e6:.1f} MB measured, "
              f"drifts={rep['drifts']}")


if __name__ == "__main__":
    main()
