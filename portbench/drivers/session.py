"""The ``session`` driver: one batch of long prompts decoded together.

Set-up: the weights and the port's projectors from the seed; each row's
prompt through the port's monolithic prefill (``models/transformer.
prefill``: flash, then projection and quantization into the latent
cache), admitted into one slot of the engine's dense arena; a snapshot of
the per-slot windows (the sink and recent rings and the slot lengths);
one captured decode step and one replay.

Window: ``ServeEngine.decode`` (the captured step graph) greedily, every
step ending in the host read of its tokens, in rounds of
``round_steps``.  Before each round the windows are restored in place and
every row starts again at its prompt's end, so the context stays in
[prompt_len, prompt_len + round_steps) whatever the speed.  Positions
past a row's own are never read (every cache write is a set at its
position and every read is masked by position), so restoring the
windows restores the state the step reads; the check covers it, since
it replays the last round through the reference.

Check: the rows ``check_rows`` drawn from the seed, their first round and
their last, teacher-forced through the reference: the widest logit gap
of the served tokens, and the largest relative error of what the last
round wrote into the cache (each SALS layer's latent keys, rebuilt in
key space by the program's projector, its dequantized values and its
recent ring; each full layer's keys and values) against what the
reference says the cache holds for the same tokens.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import bench, program, traffic, weights
from portbench.reference import load as load_reference
from portbench.yardstick import compare, devtrace, flops

WINDOW_FIELDS = ("sink_k", "sink_v", "recent_k", "recent_v", "lengths")


def _windows(cache: dict) -> list:
    """The (tensor) fields a decode step rewrites at fixed slots."""
    return [getattr(seg, f) for seg in cache.values()
            if not isinstance(seg, dict) for f in WINDOW_FIELDS
            if getattr(seg, f) is not None]


def cache_bytes(cache: dict) -> int:
    from repro_torch.serve.step_graph import tree_tensors
    return sum(t.numel() * t.element_size() for t in tree_tensors(cache))


@torch.inference_mode()
def setup(ctx: bench.Ctx):
    """The engine with its arena prefilled: (engine, cache, windows
    snapshot, first tokens (rows,) int32, the inputs, the weights,
    calibration tokens, the program's projectors (L, kv_dim, r))."""
    program.import_port()
    from repro_torch.config import ServeConfig
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine
    spec, mix, dev = ctx.spec, ctx.mix, ctx.device
    bench.log(ctx, "the port imported, the card ready")
    w = weights.make_weights(spec, ctx.seed, dev)
    params = program.build_params(spec, w)
    bench.log(ctx, "weights made")
    cal = torch.as_tensor(traffic.calibration_tokens(
        ctx.config["calibration"], spec.vocab_size, ctx.seed), device=dev)
    proj = program.calibrate(params, spec, cal)
    bench.log(ctx, "projectors fitted")
    cfg, sals = program.model_config(spec), program.sals_config(spec)
    rows = mix["rows"]
    eng = ServeEngine(params, proj, cfg,
                      ServeConfig(max_seq_len=mix["max_seq_len"],
                                  max_batch=rows, sals=sals), device=dev)
    inp = traffic.session_inputs(mix, spec.vocab_size, ctx.seed)
    cache = eng.init_slot_cache()
    first = torch.zeros((rows,), dtype=torch.int32, device=dev)
    for r in range(rows):
        logits, one = tf.prefill(
            params, proj, cfg, sals,
            {"tokens": torch.as_tensor(inp.prompts[r:r + 1], device=dev)},
            mix["max_seq_len"])
        first[r] = eng.sample_checked(logits)[0][0]
        eng.admit(cache, one, r)
        del one, logits
    snap = [t.clone() for t in _windows(cache)]
    bench.log(ctx, f"{rows} rows prefilled")
    return eng, cache, snap, first, inp, w, cal, proj["u"]


def dequantize(codes, scale, zero, bits: int, group: int) -> torch.Tensor:
    """The port's stored values (int8 codes - 128, or two 4-bit codes a
    byte, low nibble first; a bf16 scale and zero per group) as (n,
    channels) f32."""
    if bits == 8:
        vals = codes.float() + 128.0
    else:
        c = codes.to(torch.int32)
        vals = torch.stack([(c & 0x0F), (c >> 4) & 0x0F], dim=-1) \
            .reshape(*codes.shape[:-1], -1).float()
    vg = vals.reshape(*vals.shape[:-1], -1, group)
    return (vg * scale[..., None].float() + zero[..., None].float()) \
        .reshape(vals.shape)


def written(cache: dict, row: int, p0: int, n: int) -> list:
    """Per layer, in layer order, what the cache holds of ``row`` at the
    positions [p0, p0 + n) a round wrote (copies): a SALS layer's stored
    latents, values and the ring slots of the last of those positions, a
    full layer's keys and values."""
    out = []
    for seg in cache.values():
        if isinstance(seg, dict):
            for li in range(seg["k"].shape[0]):
                out.append({f: seg[f][li, row, p0:p0 + n].clone()
                            for f in ("k", "v")})
            continue
        w = seg.recent_k.shape[2]
        slots = torch.arange(max(p0, p0 + n - w), p0 + n,
                             device=seg.recent_k.device) % w
        for li in range(seg.k_lat.shape[0]):
            d = {f: getattr(seg, f)[li, row, p0:p0 + n].clone()
                 for f in ("k_lat", "k_scale", "v_q", "v_scale", "v_zero")
                 if getattr(seg, f) is not None}
            d["ring_k"] = seg.recent_k[li, row, slots].clone()
            d["ring_v"] = seg.recent_v[li, row, slots].clone()
            out.append(d)
    return out


def held_by_program(spec, got: dict, u: torch.Tensor) -> dict:
    """A layer's :func:`written` copies as the fields
    ``compare.held`` names, (n, kv_dim) f32; ``u`` the program's
    projector of the layer (kv_dim, r)."""
    if "k" in got:
        return {"k_rot": got["k"].float().flatten(1),
                "v": got["v"].float().flatten(1)}
    lat = got["k_lat"].float()
    if "k_scale" in got:
        lat = lat * got["k_scale"].float()[:, None]
    sl = spec.sals
    return {"k_rec": lat @ u.float().T,
            "v_deq": dequantize(got["v_q"], got["v_scale"], got["v_zero"],
                                sl.v_bits, sl.v_group),
            "ring_k": got["ring_k"].float().flatten(1),
            "ring_v": got["ring_v"].float().flatten(1)}


def _captures(eng) -> int:
    """Captures of the engine's decode step graph so far."""
    return eng._decode.captures


def _restore(cache, snap) -> None:
    for dst, src in zip(_windows(cache), snap):
        dst.copy_(src)


@torch.inference_mode()
def run(ctx: bench.Ctx) -> bench.Outcome:
    spec, mix, dev = ctx.spec, ctx.mix, ctx.device
    eng, cache, snap, first, inp, w, cal, u = setup(ctx)
    rows, p_len, round_steps = mix["rows"], mix["prompt_len"], \
        mix["round_steps"]
    start_pos = np.full((rows,), p_len, np.int32)

    def step(tok, pos):
        logits, _ = eng.decode(tok, cache, pos)
        tok, ok = eng.sample_checked(logits)
        return tok, ok, tok.cpu().numpy()

    # warm-up: the capture, then one replay; then the arena as prefilled
    for i in range(2):
        step(first, start_pos + i)
    _restore(cache, snap)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    captures0 = _captures(eng)
    setup_s = time.perf_counter() - ctx.t_start
    bench.log(ctx, "decode step captured; window opens")

    rounds, cur = [], []
    tok, pos = first, start_pos.copy()
    bad = np.zeros((rows,), bool)
    host, call_s, traced_pos = [], [], []
    steps, n_rounds = 0, 1
    prof, prof_s = None, 0.0
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    while True:
        if ctx.trace and prof is None and steps == mix["trace_skip"]:
            prof_begin = time.perf_counter()
            prof = devtrace.Profile()
            prof.start()
        tracing = prof is not None and prof.t1_host is None
        if tracing:
            traced_pos.append(pos.copy())
        a = time.perf_counter()
        logits, _ = eng.decode(tok, cache, pos)
        b = time.perf_counter()
        tok, ok = eng.sample_checked(logits)
        toks = tok.cpu().numpy()
        c = time.perf_counter()
        call_s.append(b - a)
        if tracing:
            host += [("decode_call", a, b), ("sample_and_read", b, c)]
            if len(traced_pos) == mix["trace_steps"]:
                prof.stop()
                prof_s = time.perf_counter() - prof_begin
        bad |= ~ok
        cur.append(toks)
        pos += 1
        steps += 1
        if time.perf_counter() >= end:
            break
        if len(cur) == round_steps:
            r0 = time.perf_counter()
            rounds.append(np.stack(cur, axis=1))
            cur = []
            _restore(cache, snap)
            tok, pos = first, start_pos.copy()
            n_rounds += 1
            if tracing:
                host.append(("restore", r0, time.perf_counter()))
    elapsed = time.perf_counter() - t0
    if cur:
        rounds.append(np.stack(cur, axis=1))
    recaptures = _captures(eng) - captures0
    trace = None
    if prof is not None:
        if prof.t1_host is None:
            prof.stop()
            prof_s = time.perf_counter() - prof_begin
        trace = prof.read(host)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    first_h = first.cpu().numpy()
    per_pos = [flops.decode_step_flops(spec, [p_len + i]) * rows
               for i in range(max(len(rd[0]) for rd in rounds))]
    data = {
        "steps": steps, "rows": rows, "window_s": elapsed,
        "decode_call_s": call_s, "traced_positions": traced_pos,
        # the whole step's share of the peak leaves the traced steps out
        # (the profiler's start and stop stall the host there)
        "model_flops": sum(sum(per_pos[:len(rd[0])]) for rd in rounds)
        - sum(per_pos[int(p[0]) - p_len] for p in traced_pos),
        "model_seconds": elapsed - prof_s,
        "cache_bytes": cache_bytes(cache),
        "cache_tokens": rows * mix["max_seq_len"],
    }
    n_last = len(rounds[-1][0])
    wrote = {r: written(cache, r, p_len, n_last) for r in inp.check_rows}
    del eng, cache, snap, logits, tok
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check: first and last round of the rows drawn from the seed
    bench.log(ctx, f"window closed: {steps} steps in {len(rounds)} rounds")
    ref = load_reference(spec, w)
    ref.fit_projectors(cal)
    bench.log(ctx, "reference projectors fitted")
    gaps, items, errs = [], [], []
    w_ring = spec.sals.n_recent
    for r in inp.check_rows:
        conts = [rounds[0][r]]
        last = rounds[-1][r]
        if len(rounds) > 1 and not np.array_equal(
                last, rounds[0][r][:len(last)]):
            conts.append(last)
        conts = [torch.as_tensor(np.concatenate([[first_h[r]], c]),
                                 dtype=torch.long) for c in conts]
        items.append((torch.as_tensor(inp.prompts[r]), conts))
        row_errs = []

        def judge(l, state, got=wrote.pop(r), row_errs=row_errs):
            # the last continuation is what the last round fed
            row_errs.append(compare.state_err(
                held_by_program(spec, got[l], u[l]),
                compare.held(state, n_last, w_ring)))
        lg = ref.serve_logits(*items[-1], on_state=judge)
        gaps.append(compare.widest_gap(lg, conts))
        errs.append(row_errs)
        bench.log(ctx, f"row {r} checked: widest gap {gaps[-1]!r}, "
                  f"cache error {compare.worst(row_errs)!r}")
    data["check_inputs"] = {"weights": w, "cal": cal, "items": items,
                            "state_n": n_last}
    data["cache_err_by_layer"] = [compare.worst(e) for e in zip(*errs)]
    checks = [bench.Check("max_logit_gap", max(gaps),
                          ctx.limits["max_logit_gap"]),
              bench.Check("max_cache_err",
                          compare.worst(data["cache_err_by_layer"]),
                          ctx.limits["max_cache_err"]),
              bench.Check("nonfinite_rows", float(bad.sum()), 0.0),
              bench.Check("captures_in_window", float(recaptures), 0.0)]
    return bench.Outcome(
        attempted=rows * n_rounds, failed=int(bad.sum()),
        end_to_end={"decode_tok_s": rows * steps / elapsed,
                    "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
        data=data, checks=checks, memory_peak_bytes=peak, trace=trace)
