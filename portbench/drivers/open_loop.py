"""The ``open_loop`` driver: requests sent on a fixed schedule through the
port's continuous-batching scheduler.

Set-up: the weights and the port's projectors from the seed; the engine
over the paged latent cache (``page_size``, ``max_batch`` slots,
``max_seq_len``, chunked prefill of ``prefill_chunk`` tokens with
``prefill_token_budget`` a sweep, the prefix cache on); then, inside the
same ``RequestScheduler.run`` (continuous) as the window, a few warm-up
requests (two sharing a system prompt) that capture the chunk program
and the decode step on the arena the window uses.

Window: it opens the step after the warm-up's last request finishes.  The
requests due in it (``traffic.open_loop``) are submitted from ``on_step``
as the wall clock passes their due times; when nothing is in flight the
client sleeps to the next due time, as an idle server would wait.  After
the window the same arrival process goes on, uncounted, until every
counted request is done, then the uncounted ones are cancelled.  Each
token is stamped when the scheduler commits it (``Request.on_token``):
time to first token is taken from the request's DUE time, so a late
submission counts; the gaps are between consecutive tokens.

Check: ``check_requests`` finished requests (the longest among them, the
rest drawn from the seed), teacher-forced through the reference; the
widest logit gap.
"""
from __future__ import annotations

import math
import time
from typing import List

import numpy as np
import torch

from portbench import bench, program, traffic, weights
from portbench.reference import load as load_reference
from portbench.yardstick import compare, devtrace

NEVER = 1e12          # ms: the latency of a request that never answered


class Client:
    """Sends the warm-up, then the schedule; stamps the tokens.

    The warm-up requests go through the same ``run`` as the window, so the
    step programs are captured on the arena the window uses; the window
    opens (``t0``) the step after the last of them finishes."""

    def __init__(self, schedule: List[traffic.Arrival], warmup, on_open,
                 trace_steps=None):
        from repro_torch.serve.scheduler import Request
        self._request = Request
        self.sched = None
        self.schedule = schedule
        self.warmup = [Request(prompt=p, max_new_tokens=8) for p in warmup]
        self.on_open = on_open
        self.t0 = None
        self.next = 0
        self.reqs = []           # (arrival, Request, stamps, submitted at)
        self.open = []           # in flight
        self.closing = False
        self.trace_cfg = trace_steps   # steps traced after the window
        self.prof = None
        self.prof_steps = 0

    def _submit_due(self, now: float) -> None:
        while self.next < len(self.schedule) and not self.closing:
            a = self.schedule[self.next]
            if self.t0 + a.due_s > now:
                break
            stamps = {}

            def on_token(tok, idx, stamps=stamps):
                stamps.setdefault(idx, time.perf_counter())

            req = self._request(prompt=a.prompt,
                                max_new_tokens=a.max_new_tokens,
                                on_token=on_token)
            self.sched.submit(req)
            self.reqs.append((a, req, stamps, now))
            self.open.append(req)
            self.next += 1

    def start(self, sched) -> None:
        self.sched = sched
        for req in self.warmup:
            sched.submit(req)

    def on_step(self, sched, step) -> None:
        now = time.perf_counter()
        if self.t0 is None:
            if not all(r.finished for r in self.warmup):
                return
            self.t0 = now
            self.on_open(now)
        self._submit_due(now)
        self.open = [r for r in self.open if not r.finished]
        if not self.closing and all(r.finished for a, r, _, _ in self.reqs
                                    if a.counted) \
                and self.next >= sum(a.counted for a in self.schedule) \
                and not self._profiling():
            self.closing = True            # the window's requests are done
            for r in self.open:
                r.cancel()
        if not self.open and not self.closing \
                and self.next < len(self.schedule):
            # nothing in flight: wait for the next request, as a server does
            due = self.t0 + self.schedule[self.next].due_s
            time.sleep(max(0.0, due - time.perf_counter()))
            self._submit_due(time.perf_counter())

    def _profiling(self) -> bool:
        """After the window's requests are done, with tracing on: trace
        ``trace_steps`` steps of the same arrival process going on (a
        profiler started or stopped inside the window would stall the
        scheduler and back the window's requests up); True while that
        slice is open."""
        if self.trace_cfg is None:
            return False
        if self.prof is None:
            self.prof = devtrace.Profile()
            self.prof.start()
            return True
        if self.prof.t1_host is None:
            self.prof_steps += 1
            if self.prof_steps >= self.trace_cfg:
                self.prof.stop()
                return False
            return True
        return False


def _engine(ctx: bench.Ctx, params, proj):
    from repro_torch.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine
    m = ctx.mix
    scfg = ServeConfig(
        max_seq_len=m["max_seq_len"], max_batch=m["max_batch"],
        page_size=m["page_size"], prefill_chunk=m["prefill_chunk"],
        prefill_token_budget=m["prefill_token_budget"],
        prefix_cache=True, max_new_tokens=m["output"]["max"],
        sals=program.sals_config(ctx.spec))
    return ServeEngine(params, proj, program.model_config(ctx.spec), scfg,
                       device=ctx.device)


def warmup_prompts(mix, vocab, seed) -> list:
    """Every shape of the window once: chunked prefill, a prefix-cache
    resume, admission, decode."""
    r = traffic.rng(seed, "warmup")
    system = traffic.tokens(r, mix["shared"]["prefix_len"], vocab)
    short = mix["prompt"]["min"]
    return [np.concatenate([system, traffic.tokens(r, short // 2, vocab)]),
            np.concatenate([system, traffic.tokens(r, short, vocab)]),
            traffic.tokens(r, short, vocab)]


def _latencies(client: Client):
    ttft, gaps, failed = [], [], 0
    for a, req, stamps, _ in client.reqs:
        if not a.counted:
            continue
        if not req.done:
            failed += 1
            ttft.append(NEVER)
            continue
        t = [stamps[i] for i in sorted(stamps)]
        ttft.append((t[0] - (client.t0 + a.due_s)) * 1e3)
        gaps += list(np.diff(t) * 1e3)
    return ttft, gaps, failed


@torch.inference_mode()
def prepare(ctx: bench.Ctx):
    """Set-up: (engine, weights, calibration tokens), warmed up."""
    program.import_port()
    spec, dev = ctx.spec, ctx.device
    bench.log(ctx, "the port imported, the card ready")
    w = weights.make_weights(spec, ctx.seed, dev)
    params = program.build_params(spec, w)
    cal = torch.as_tensor(traffic.calibration_tokens(
        ctx.config["calibration"], spec.vocab_size, ctx.seed), device=dev)
    proj = program.calibrate(params, spec, cal)
    bench.log(ctx, "weights made, projectors fitted")
    return _engine(ctx, params, proj), w, cal


@torch.inference_mode()
def window(ctx: bench.Ctx, eng, schedule: List[traffic.Arrival]) -> dict:
    """The warm-up, then one window, through one fresh scheduler run:
    {client, t0, t_end, opened (perf_counter at the window's start),
    recaptures, spans, trace}."""
    from repro_torch import obs
    from repro_torch.serve.scheduler import RequestScheduler
    mix, dev = ctx.mix, ctx.device
    handles = obs.enable() if ctx.trace else None
    sched = RequestScheduler(eng)
    graphs = (eng._decode, eng._prefill_chunk)
    opened = {}

    def on_open(t0):
        opened["captures"] = sum(g.captures for g in graphs)
        bench.log(ctx, "warm-up done; window opens")

    client = Client(schedule,
                    warmup_prompts(mix, ctx.spec.vocab_size, ctx.seed),
                    on_open, mix["trace_steps"] if ctx.trace else None)
    client.start(sched)
    sched.run(on_step=client.on_step)
    t_end = time.perf_counter()
    bench.log(ctx, f"window closed; last request done at "
              f"{t_end - client.t0:.2f}s")
    spans, trace = [], None
    if handles is not None:
        obs.disable()
        spans = [(e["name"], e["t0"], e["t1"], e.get("args") or {})
                 for e in handles["tracer"].events if e["t0"] >= client.t0]
    if client.prof is not None and client.prof.t1_host is None:
        client.prof.stop()
    if client.prof is not None:
        trace = client.prof.read([(n, a, b) for n, a, b, _ in spans
                                  if n in ("decode_step", "prefill_chunk")])
    return {"client": client, "t0": client.t0, "t_end": t_end,
            "spans": spans, "trace": trace,
            "recaptures": sum(g.captures for g in graphs)
            - opened["captures"]}


@torch.inference_mode()
def run(ctx: bench.Ctx) -> bench.Outcome:
    spec, mix, dev = ctx.spec, ctx.mix, ctx.device
    eng, w, cal = prepare(ctx)
    schedule = traffic.open_loop(mix, spec.vocab_size, ctx.seed, ctx.seconds)
    win = window(ctx, eng, schedule)
    setup_s = win["t0"] - ctx.t_start
    client, t0, t_end, spans, trace, recaptures = (
        win[k] for k in ("client", "t0", "t_end", "spans", "trace",
                         "recaptures"))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ttft, gaps, failed = _latencies(client)
    counted = [(a, req) for a, req, _, _ in client.reqs if a.counted]
    unsent = sum(a.counted for a in schedule) - len(counted)
    data = {"window_s": ctx.seconds, "t0": t0, "t_end": t_end,
            "spans": spans,
            "requests": [{"id": req.req_id, "due": t0 + a.due_s,
                          "counted": a.counted} for a, req, _, _ in
                         client.reqs],
            "submit_lag_ms": [(sub - (t0 + a.due_s)) * 1e3
                              for a, _, _, sub in client.reqs if a.counted]}
    del eng, win
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the longest finished request and a sample of the rest
    done = [(a, req) for a, req in counted if req.done]
    r = traffic.rng(ctx.seed, "check")
    gap = math.inf
    if done:
        longest = max(range(len(done)), key=lambda i: len(done[i][0].prompt)
                      + len(done[i][1].result.tokens))
        rest = [i for i in r.permutation(len(done)) if i != longest]
        pick = [longest] + rest[:mix["check_requests"] - 1]
        ref = load_reference(spec, w)
        ref.fit_projectors(cal)
        gap, items = 0.0, []
        for i in pick:
            a, req = done[i]
            cont = torch.as_tensor(req.result.tokens, dtype=torch.long)
            items.append((torch.as_tensor(a.prompt), [cont]))
            lg = ref.serve_logits(*items[-1])
            gap = max(gap, compare.widest_gap(lg, [cont]))
        bench.log(ctx, f"{len(pick)} requests checked")
        data["check_inputs"] = {"weights": w, "cal": cal, "items": items}
    bench.log(ctx, "ttft p50 / p75 / p90 ms " + " / ".join(
        f"{traffic.percentile(ttft, p):.1f}" for p in (50, 75, 90))
        + f" over {len(ttft)}; itl p50 / p95 ms " + " / ".join(
        f"{traffic.percentile(gaps, p):.1f}" for p in (50, 95))
        + f" over {len(gaps)}")
    checks = [bench.Check("max_logit_gap", gap, ctx.limits["max_logit_gap"]),
              bench.Check("captures_in_window", float(recaptures), 0.0)]
    return bench.Outcome(
        attempted=len(counted) + unsent, failed=failed + unsent,
        end_to_end={"ttft_p75_ms": traffic.percentile(ttft, 75),
                    "itl_p95_ms": traffic.percentile(gaps, 95),
                    "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
        data=data, checks=checks, memory_peak_bytes=peak, trace=trace)
