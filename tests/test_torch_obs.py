"""Port parity for telemetry (``repro_torch.obs``): the metrics registry,
the span tracer and the byte accountant, and their wiring through the
pager, the tier pool, the scheduler, the engine and the launcher — the
port of ``tests/test_obs.py``, held against the JAX package.

Both packages serve reduced qwen2-1.5b (3 layers, vocab 128, float32) from
the same weights and projectors, with the reference fixture's SALS
settings.  The parity cases run the same requests through both schedulers
with telemetry on (registry + tracer) and hold equal, exactly: every
counter's value by name and labels, every gauge, every histogram's count,
and the sequence of span names on every track (timestamps left out).  The
byte accountant reconciles the port's runs against the port's own ledger
(``obs/ledger.py``), which is held against ``benchmarks/memory_access.py``
term by term.  The reference's accountant cannot run on the float32
parity model (its ledger fixes the cache width at bf16), so the measured
bytes of both accountants are compared at bf16 caches, the reference
fixture's own dtype."""
import dataclasses
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# the reference's ledger lives in the repository root's ``benchmarks``
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import memory_access
from repro import obs as jobs
from repro.config import SALSConfig as JSALS
from repro.config import ServeConfig as JServe
from repro.configs import get_config as jax_get_config
from repro.core import calibration as jcal
from repro.kernels.latent_score import topk_candidate_shape
from repro.models import transformer as jtf
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.trace import SpanTracer as JTracer
from repro.serve import Request as JRequest
from repro.serve import RequestScheduler as JScheduler
from repro.serve import ServeEngine as JEngine
from repro.serve import faults as jfaults
from repro_torch import obs
from repro_torch.config import SALSConfig, ServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, projectors_from_numpy
from repro_torch.core import latent_cache as lc
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.obs import ledger
from repro_torch.obs.metrics import (MetricsRegistry, validate_prometheus,
                                     validate_snapshot)
from repro_torch.obs.trace import (STEP_SPANS, RequestTimeline, SpanTracer,
                                   validate_chrome_trace)
from repro_torch.obs.traffic import TrafficAccountant, TrafficDriftError
from repro_torch.serve import Request, RequestScheduler, ServeEngine
from repro_torch.serve import faults

torch.set_num_threads(1)

SALS_KW = dict(rank_ratio=0.5, score_ratio=0.5, n_critical=16, n_sink=2,
               n_recent=8, v_bits=8, v_group=32, skip_layers_front=1,
               skip_layers_back=1)
BASE = dict(max_seq_len=128, max_new_tokens=8, max_batch=3,
            prefill_chunk=8, prefill_token_budget=8)
PAGED = dict(BASE, page_size=16, audit_every=1)
TIERED = dict(PAGED, hbm_pages=4)
SPEC = dict(PAGED, spec_window=4, max_batch=2, temperature=0.0)
PARK = dict(PAGED, max_batch=2, priority_classes=2, preempt_policy="park")
EVICT = dict(PARK, preempt_policy="evict")
PKGS = {"jax": (jobs, JRequest, JScheduler, jfaults),
        "torch": (obs, Request, RequestScheduler, faults)}


@pytest.fixture(scope="module")
def model():
    over = dict(n_layers=3, vocab_size=128, dtype="float32")
    jcfg = jax_get_config("qwen2-1.5b").reduced(**over)
    cfg = get_config("qwen2-1.5b").reduced(**over)
    key = jax.random.PRNGKey(0)
    jsals, sals = JSALS(**SALS_KW), SALSConfig(**SALS_KW)
    jp = jtf.init_params(key, jcfg, jnp.float32)
    ju = jcal.random_layer_projectors(key, jcfg, jsals, jcfg.n_layers)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tu = projectors_from_numpy({"u": np.asarray(ju["u"])}, device="cpu")
    return dict(j=(jp, ju, jcfg, jsals), t=(tp, tu, cfg, sals), engines={})


def _engine(model, pkg: str, **skw):
    """One engine per (package, ServeConfig), built once per module (the
    JAX engine compiles on its first run)."""
    key = (pkg, tuple(sorted(skw.items())))
    if key not in model["engines"]:
        if pkg == "jax":
            jp, ju, jcfg, jsals = model["j"]
            eng = JEngine(jp, ju, jcfg, JServe(sals=jsals, **skw))
        else:
            tp, tu, cfg, sals = model["t"]
            eng = ServeEngine(tp, tu, cfg, ServeConfig(sals=sals, **skw),
                              device="cpu")
        model["engines"][key] = eng
    return model["engines"][key]


def _prompts(seed=42, n=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, size=int(rng.integers(10, 30)))
            .astype(np.int32) for _ in range(n)]


def _drain(eng, reqs, sched_cls=RequestScheduler, flt=faults,
           schedule=None, on_step=None):
    sched = sched_cls(eng, mode="continuous")
    for r in reqs:
        sched.submit(r)
    if schedule is None:
        sched.run(on_step=on_step)
    else:
        with flt.injected(schedule):
            sched.run(on_step=on_step)
    return sched


# ---------------------------------------------------------------------------
# (a) registry + exporters
# ---------------------------------------------------------------------------

def _registry_ops(reg):
    c = reg.counter("req_total", "requests", labelnames=("tenant",))
    c.inc(tenant="a")
    c.inc(2.0, tenant="b")
    g = reg.gauge("depth")
    g.set(5.0)
    g.dec(2.0)
    h = reg.histogram("lat_ms", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    reg.counter("a_total", "help text", labelnames=("k",)).inc(k='q"uote')
    reg.gauge("b").set(-1.5)
    reg.histogram("c_ms").observe(3.0)
    return c, g, h


def test_registry_typed_instruments():
    reg = MetricsRegistry()
    c, g, h = _registry_ops(reg)
    assert c.value(tenant="a") == 1.0 and c.value(tenant="b") == 2.0
    with pytest.raises(ValueError):
        c.inc(-1.0, tenant="a")                 # counters are monotonic
    with pytest.raises(ValueError):
        c.inc(tenant="a", extra="x")            # undeclared label
    assert g.value() == 3.0
    assert h.count() == 4 and h.sum() == 555.5
    # idempotent re-registration returns the same instrument; a type or
    # label mismatch is a bug, not a merge
    assert reg.counter("req_total", labelnames=("tenant",)) is c
    with pytest.raises(ValueError):
        reg.gauge("req_total")
    with pytest.raises(ValueError):
        reg.counter("req_total", labelnames=("other",))
    with pytest.raises(ValueError):
        reg.counter("bad name!")


def test_registry_series_lru_cap():
    """max_series is the registry-side twin of the gauge_history ring: the
    least-recently-touched label set is evicted past the cap."""
    for cls in (MetricsRegistry, JRegistry):
        reg = cls(max_series=3)
        c = reg.counter("x_total", labelnames=("t",))
        for t in "abcd":
            c.inc(t=t)
        c.inc(t="b")                            # refresh b
        kept = [s["labels"]["t"]
                for s in reg.snapshot()["metrics"][0]["series"]]
        assert kept == ["c", "d", "b"]          # a was LRU


def test_exporters_validate_and_equal_reference():
    """Both exporters validate, reject garbage, and equal the reference's
    output for the same operations (one schema, one text format)."""
    reg, jreg = MetricsRegistry(), JRegistry()
    _registry_ops(reg)
    _registry_ops(jreg)
    snap = reg.snapshot()
    assert validate_snapshot(snap) == []
    assert validate_snapshot(json.loads(json.dumps(snap))) == []
    assert validate_prometheus(reg.to_prometheus()) == []
    assert snap == jreg.snapshot()
    assert reg.to_prometheus() == jreg.to_prometheus()
    assert obs.metrics.snapshot_to_json(reg) == \
        jobs.metrics.snapshot_to_json(jreg)
    assert validate_snapshot({"schema": "nope", "metrics": 3})
    assert validate_prometheus('bad{-}line 1\n')


def test_core_hook_contract():
    """core.pager._metrics_hook follows the _fault_hook contract: None
    when disabled, wired by install(), counting page events under
    core_events_total when enabled (on refcount -> 0 only for a free)."""
    from repro_torch.core import pager
    assert pager._metrics_hook is None
    pool = pager.PagePool(4, 4, n_reserved=1)
    pool.free(pool.alloc())                     # no registry: nothing breaks
    with obs.metrics.installed(MetricsRegistry()) as reg:
        assert pager._metrics_hook is not None
        pid = pool.alloc()
        pool.share(pid)
        pool.free(pid)
        pool.free(pid)
        ev = reg.counter("core_events_total", labelnames=("point",))
        assert ev.value(point="page_alloc") == 1
        assert ev.value(point="page_share") == 1
        assert ev.value(point="page_free") == 1
    assert pager._metrics_hook is None


def test_tier_hook_events():
    """The tier pool reports finished fetches and spills as tier_fetch /
    tier_spill through the same hook."""
    from repro_torch.core.tiering import TieredPagePool
    pool = TieredPagePool(6, 4, hbm_slots=2, n_reserved=1)
    with obs.metrics.installed(MetricsRegistry()) as reg:
        pid = pool.alloc()
        pool.set_hot(pid, pool.take_slot())
        pool.begin_spill(pid)
        pool.finish_spill(pid, {"m": 1})
        slot = pool.take_slot()
        pool.begin_fetch(pid)
        pool.finish_fetch(pid, slot)
        ev = reg.counter("core_events_total", labelnames=("point",))
        assert ev.value(point="tier_spill") == 1
        assert ev.value(point="tier_fetch") == 1


# ---------------------------------------------------------------------------
# (b) span tracer
# ---------------------------------------------------------------------------

def _counting_clock():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]
    return clock


def test_tracer_balance_and_ring_cap():
    """Balance survives the ring cap, a double close raises, and the
    Chrome trace equals the reference tracer's on the same clock."""
    payloads = []
    for cls in (SpanTracer, JTracer):
        tr = cls(max_events=2, clock=_counting_clock())
        sids = [tr.begin("a", "r1"), tr.begin("b", "r1"),
                tr.begin("c", "r2")]
        assert tr.open_count == 3 and tr.open_tracks() == ["r1", "r2"]
        assert tr.end(sids[2]) > 0
        with pytest.raises(ValueError):
            tr.end(sids[2])                     # double close is the bug
        assert tr.end_track("r1") == 2          # newest-first unwind
        assert tr.balanced()
        assert len(tr.events) == 2 and tr.begun == tr.ended == 3
        tr.instant("marker", "r1")
        payload = tr.chrome_trace()
        assert validate_chrome_trace(payload) == []
        payloads.append(payload)
    assert payloads[0] == payloads[1]
    names = {e["name"] for e in payloads[0]["traceEvents"]}
    assert "marker" in names and "thread_name" in names


def test_tracer_span_ctx_tolerates_end_track():
    tr = SpanTracer()
    with tr.span("outer", "req1"):
        tr.begin("inner", "req1")
        tr.end_track("req1")                    # teardown closed everything
    assert tr.balanced()


def test_request_timeline_feeds_histograms():
    t = [0.0]

    def clock():
        t[0] += 0.010
        return t[0]

    reg = MetricsRegistry()
    tl = RequestTimeline(clock=clock, registry=reg)
    tl.submitted(7)
    tl.stamp(7)                                 # first token -> ttft
    tl.stamp(7)                                 # second -> inter-token
    assert tl.ttft_ms(7) == pytest.approx(10.0)
    assert tl.gaps_ms(7) == [pytest.approx(10.0)]
    assert reg.get("obs_ttft_ms").count() == 1
    assert reg.get("obs_inter_token_ms").count() == 1
    s = tl.summary()
    assert s["n"] == 1 and s["ttft_p50_ms"] == pytest.approx(10.0)


def test_timeline_attach_chains_two_arg_callback():
    """The scheduler calls on_token(tok, idx): the chained wrapper must
    forward both arguments to the client's callback."""
    tl = RequestTimeline()
    seen = []
    req = Request(np.array([1, 2], np.int32))
    req.on_token = lambda tok, idx: seen.append((tok, idx))
    tl.submitted(req.req_id)
    tl.attach(req)
    req.on_token(5, 0)
    req.on_token(6, 1)
    assert seen == [(5, 0), (6, 1)]
    assert len(tl.stamps[req.req_id]) == 3      # submit + 2 tokens


# ---------------------------------------------------------------------------
# the ledger against benchmarks/memory_access.py
# ---------------------------------------------------------------------------

LEDGER_CASES = [
    # (arch, cfg overrides, SALS overrides): int8 and bf16 latents, v_bits
    # 4 and 8, GQA (mistral-7b) and MHA (llama2-7b) at published widths
    ("paper-llama2-7b", {}, {}),
    ("paper-llama2-7b", {}, dict(k_latent_dtype="int8")),
    ("paper-mistral-7b", {}, dict(v_bits=4)),
    ("paper-mistral-7b", {}, dict(k_latent_dtype="int8", v_bits=4,
                                  rank_ratio=0.125)),
    ("qwen2-1.5b", dict(n_layers=3, vocab_size=128), SALS_KW),
    ("qwen2-1.5b", dict(n_layers=3, vocab_size=128),
     dict(SALS_KW, k_latent_dtype="int8", v_bits=4)),
]


@pytest.mark.parametrize("arch,over,sals_over", LEDGER_CASES)
def test_ledger_matches_reference_model(arch, over, sals_over):
    """Every term the two ledgers share is equal exactly; the score term
    differs by exactly the scratch-vs-candidates amount the ledger's
    docstring states: 8·S + 5·N_c − 16·nb·kb."""
    jcfg = jax_get_config(arch)
    cfg = get_config(arch)
    if over:
        jcfg, cfg = jcfg.reduced(**over), cfg.reduced(**over)
    jsals, sals = JSALS(**sals_over), SALSConfig(**sals_over)
    for max_seq, ps in ((4096, 0), (4096, 64), (128, 16)):
        rows = ledger.score_rows(max_seq, ps)
        for s in (1, 17, 200, 1023, 1024, 1025, 4000):
            if s > max_seq:
                continue
            ref = memory_access.decode_stage_bytes(jcfg, jsals, s, fused=True)
            mine = ledger.decode_stage_bytes(cfg, sals, s, rows)
            for term in ("selected_bytes", "window_bytes", "u_bytes"):
                assert mine[term] == ref[term], (term, s)
            nb, kb = topk_candidate_shape(s, sals.n_critical)
            assert mine["score_bytes"] - ref["score_bytes"] == \
                8 * rows + 5 * sals.n_critical - 16 * nb * kb, s
            spec = memory_access.speculative_traffic_model(
                jcfg, jsals, s, 4, acceptance=0.0)
            assert ledger.spec_window_bytes(cfg, 4) == \
                spec["window_kv_bytes"]
    tier = memory_access.tiered_capacity_model(
        jcfg, jsals, 64, live_pages=10, hbm_pages=4, pages_touched=3,
        cold_miss_rate=0.5)
    assert ledger.bytes_per_token(cfg, sals) == \
        tier["payload_bytes_per_token"]
    assert ledger.bytes_per_token(cfg, sals) == \
        lc.cache_bytes_per_token(cfg, sals)
    n_sals = sum(jsals.sals_layer_mask(jcfg.n_layers))
    assert ledger.tier_page_bytes(cfg, sals, 64) == \
        64 * tier["payload_bytes_per_token"] * n_sals


# ---------------------------------------------------------------------------
# (c) traffic accountant: measured == modeled on every serving path
# ---------------------------------------------------------------------------

def _reconciled_run(eng, model, reqs, schedule=None, on_step=None):
    _, _, cfg, sals = model["t"]
    with obs.enabled(cfg=cfg, sals=sals, with_traffic=True) as h:
        sched = _drain(eng, reqs, schedule=schedule, on_step=on_step)
        acct = h["traffic"]
        assert acct.reconciled > 0, "accountant never saw a decode step"
        assert acct.drifts == 0
        rep = acct.report()
        for term, meas in rep["measured"].items():
            mod = rep["modeled"][term]
            assert abs(meas - mod) <= 0.01 * max(meas, mod, 1.0), \
                (term, meas, mod)
        return sched, rep, h


def test_traffic_reconciles_dense(model):
    eng = _engine(model, "torch", **BASE)
    reqs = [Request(p, max_new_tokens=4) for p in _prompts()]
    sched, rep, _ = _reconciled_run(eng, model, reqs)
    for term in ("score_bytes", "selected_bytes", "window_bytes", "u_bytes"):
        assert rep["measured"][term] > 0
    # one reconciliation per committed decode step
    assert rep["reconciled"] == rep["steps"] == sched.steps


def test_traffic_reconciles_paged(model):
    eng = _engine(model, "torch", **PAGED)
    reqs = [Request(p, max_new_tokens=4) for p in _prompts(43)]
    sched, rep, h = _reconciled_run(eng, model, reqs)
    assert sched.paged and rep["measured"]["score_bytes"] > 0
    # the scratch spans the page table: max_pages · page_size rows
    assert h["traffic"].widths["rows"] == 128
    assert rep["reconciled"] == sched.steps


def test_traffic_reconciles_tiered(model):
    """The PCIe terms: every fetch/spill's host-mirror bytes must equal
    pages x page_size x payload-bytes-per-token x SALS layers."""
    eng = _engine(model, "torch", **TIERED)
    rng = np.random.default_rng(44)
    reqs = [Request(rng.integers(1, 128, size=30).astype(np.int32),
                    max_new_tokens=8) for _ in range(5)]
    sched, rep, h = _reconciled_run(eng, model, reqs)
    assert sched.tiered
    assert sched.pool.spills > 0 and sched.pool.fetches > 0
    _, _, cfg, sals = model["t"]
    page = ledger.tier_page_bytes(cfg, sals, 16)
    assert rep["measured"]["spill_bytes"] == sched.pool.spills * page
    assert rep["measured"]["fetch_bytes"] == sched.pool.fetches * page
    spans = [e for e in h["tracer"].events
             if e["name"] in ("tier_fetch", "tier_spill")]
    assert len(spans) == sched.pool.spills + sched.pool.fetches
    assert all(e["args"]["bytes"] == page for e in spans)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_traffic_reconciles_grouped(model, layout):
    """A grouped decode step (G 4) reconciles with 0 drifts: the
    accountant reads the layout off the arena (measured) and the engine
    (modeled); G·k_loc selection slots, at most min(s_g, k_loc) rows
    reconstructed per slab."""
    tp, tu, cfg, sals = model["t"]
    skw = PAGED if layout == "paged" else BASE
    eng = ServeEngine(tp, tu, cfg, ServeConfig(sals=sals, **skw),
                      n_groups=4, device="cpu")
    rng = np.random.default_rng(46)
    reqs = [Request(rng.integers(1, 128, size=n).astype(np.int32),
                    max_new_tokens=6) for n in (70, 40, 12)]
    sched, rep, h = _reconciled_run(eng, model, reqs)
    assert h["traffic"].widths["n_groups"] == 4
    assert rep["reconciled"] == sched.steps > 0
    # the grouped selection reads less than the global one at these
    # lengths: slabs past a row's length select nothing
    flat = ledger.decode_stage_bytes(cfg, sals, 70, 128)
    grouped = ledger.decode_stage_bytes(cfg, sals, 70, 128, 4)
    assert grouped["selected_bytes"] < flat["selected_bytes"]


@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_ledger_grouped_terms(g):
    """At G = 1 every term is the global ledger's (min(s, N_c) rows); at
    G > 1 the stream and scratch keep their totals, the outputs are
    5·G·k_loc, the selected rows Σ_g min(s_g, k_loc)."""
    cfg = get_config("paper-llama2-7b")
    sals = SALSConfig()
    rows, nc = 4160, sals.n_critical
    k_loc = -(-nc // g)
    for s in (1, 100, 520, 1040, 1500, 3000, 4159):
        one = ledger.decode_stage_bytes(cfg, sals, s, rows)
        mine = ledger.decode_stage_bytes(cfg, sals, s, rows, g)
        slab = rows // g
        fills = [min(max(0, s - i * slab), slab) for i in range(g)]
        want_rows = sum(min(f, k_loc) for f in fills)
        assert ledger.selected_rows(s, rows, nc, g) == want_rows
        assert ledger.selected_rows(s, rows, nc, 1) == min(s, nc)
        for term in ("score_stream_bytes", "score_scratch_bytes",
                     "window_bytes", "u_bytes"):
            assert mine[term] == one[term], (term, s)
        assert mine["score_output_bytes"] == 5 * g * k_loc
        per_row = one["selected_bytes"] // max(1, min(s, nc))
        assert mine["selected_bytes"] == per_row * want_rows
        if g == 1:
            assert mine == one


def test_grouped_selected_rows_bound_the_folded_selection(model,
                                                          monkeypatch):
    """The grouped selected-rows term held to the folded selection itself:
    a decode step's valid slots over a row's G slabs never exceed
    ``ledger.selected_rows`` and equal it where every filled slab holds
    k_loc selectable rows, where the global count (G 1) does not."""
    tp, tu, cfg, sals = model["t"]
    g, rows = 4, BASE["max_seq_len"]
    eng = ServeEngine(tp, tu, cfg, ServeConfig(sals=sals, **BASE),
                      n_groups=g, device="cpu")
    seen, topk = [], ops.latent_topk

    def spy(q_lat, k, scale, pos, **kw):
        idx, valid = topk(q_lat, k, scale, pos, **kw)
        seen.append((pos.view(-1, g)[:, 0].tolist(),
                     valid.view(pos.shape[0] // g, -1).sum(1).tolist()))
        return idx, valid

    monkeypatch.setattr(ops, "latent_topk", spy)
    rng = np.random.default_rng(47)
    _drain(eng, [Request(rng.integers(1, 128, size=n).astype(np.int32),
                         max_new_tokens=6) for n in (50, 20, 100)])
    slab, k_loc = rows // g, -(-sals.n_critical // g)
    exact = global_differs = 0
    for positions, counts in seen:
        for p, c in zip(positions, counts):
            want = ledger.selected_rows(p, rows, sals.n_critical, g)
            assert c <= want, (p, c, want)
            # every filled slab selects k_loc: the sink (slab 0) and the
            # recent window (the last slab) leave at least k_loc over
            if p % slab >= sals.n_sink + sals.n_recent + k_loc + 2:
                assert c == want, (p, c, want)
                exact += 1
                global_differs += c != ledger.selected_rows(
                    p, rows, sals.n_critical, 1)
    assert seen and exact >= 10 and global_differs > 0


@pytest.mark.parametrize("told", [1, 2])
def test_traffic_drifts_when_the_layout_is_misreported(model, told):
    """The measured side reads the slab geometry off the arena, the
    modeled side the engine's ``n_groups``: an arena at G 4 reported as G
    ``told`` drifts on the selected rows."""
    tp, tu, cfg, sals = model["t"]
    eng = ServeEngine(tp, tu, cfg, ServeConfig(sals=sals, **BASE),
                      n_groups=4, device="cpu")
    cache = eng.init_slot_cache()

    class Misreported:                  # the engine, but for its layout
        n_groups = told

        def __getattr__(self, name):
            return getattr(eng, name)

    positions = [20, 50, 100]
    honest = TrafficAccountant(cfg, sals)
    honest.observe_decode(eng, cache, positions)
    assert honest.drifts == 0 and honest.widths["n_groups"] == 4
    with pytest.raises(TrafficDriftError, match="selected_bytes"):
        TrafficAccountant(cfg, sals).observe_decode(Misreported(), cache,
                                                    positions)


def test_traffic_reconciles_speculative(model):
    """Verify windows reconcile the EXTRA in-flight window K/V term."""
    eng = _engine(model, "torch", **SPEC)
    rng = np.random.default_rng(45)
    base = rng.integers(1, 128, size=8).astype(np.int32)
    reqs = [Request(np.tile(base, 4)[:20 + 6 * i], max_new_tokens=8)
            for i in range(2)]
    sched, rep, _ = _reconciled_run(eng, model, reqs)
    assert sched.spec_rounds > 0 and rep["reconciled"] == sched.spec_rounds
    assert rep["measured"]["spec_window_bytes"] > 0


@pytest.fixture(scope="module")
def model_bf16(model):
    """The reference fixture's bf16 serving dtype (f32 weights, bf16
    caches), where the reference's own accountant reconciles."""
    over = dict(n_layers=3, vocab_size=128)
    jcfg = jax_get_config("qwen2-1.5b").reduced(**over)
    cfg = get_config("qwen2-1.5b").reduced(**over)
    jp, ju, _, jsals = model["j"]
    tp, tu, _, sals = model["t"]
    return dict(j=(jp, ju, jcfg, jsals), t=(tp, tu, cfg, sals), engines={})


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_traffic_bytes_equal_reference(model_bf16, layout):
    """At bf16, both packages' accountants reconcile the same traffic, and
    the port's MEASURED bytes equal the reference's on every shared term;
    its score term exceeds the reference's by exactly the stated
    scratch-vs-candidates amount at every observed row."""
    skw = BASE if layout == "dense" else PAGED
    seen, reps = [], {}
    for pkg, (o, Req, Sched, flt) in PKGS.items():
        eng = _engine(model_bf16, pkg, **skw)
        _, _, cfg, sals = model_bf16["j" if pkg == "jax" else "t"]
        with o.enabled(cfg=cfg, sals=sals, with_traffic=True) as h:
            acct = h["traffic"]
            if pkg == "torch":          # the rows' positions, as observed
                observe = acct.observe_decode

                def spy(engine, cache, positions, **kw):
                    seen.extend(positions)
                    return observe(engine, cache, positions, **kw)
                acct.observe_decode = spy
            _drain(eng, [Req(p, max_new_tokens=4) for p in _prompts(54)],
                   Sched, flt)
            assert acct.drifts == 0 and acct.reconciled > 0
            reps[pkg] = acct.report()["measured"]
    j, t = reps["jax"], reps["torch"]
    for term in ("selected_bytes", "window_bytes", "u_bytes"):
        assert t[term] == j[term], term
    _, _, cfg, sals = model_bf16["t"]
    n_sals = ledger.n_sals_layers(cfg, sals)
    rows = ledger.score_rows(128, skw.get("page_size", 0))
    extra = 0
    for s in seen:
        nb, kb = topk_candidate_shape(s, sals.n_critical)
        extra += 8 * rows + 5 * sals.n_critical - 16 * nb * kb
    assert t["score_bytes"] - j["score_bytes"] == extra * n_sals


def test_traffic_drift_error_on_layout_tamper(model):
    """Change the (believed) cache layout without updating the ledger and
    the NEXT decode step raises a typed TrafficDriftError out of run()."""
    _, _, cfg, sals = model["t"]
    eng = _engine(model, "torch", **BASE)
    reqs = [Request(p, max_new_tokens=6) for p in _prompts(46, n=2)]

    def tamper(s, step):
        acct = obs.traffic.active()
        if step == 1 and acct.widths:
            acct.widths["win_tokens"] += 5      # phantom window rows

    with obs.enabled(cfg=cfg, sals=sals, with_traffic=True):
        with pytest.raises(TrafficDriftError) as ei:
            _drain(eng, reqs, on_step=tamper)
    assert ei.value.term == "window_bytes"
    assert ei.value.measured > ei.value.modeled
    # the score scratch is measured from the arena too
    with obs.enabled(cfg=cfg, sals=sals, with_traffic=True):
        def tamper_rows(s, step):
            if step == 1:
                obs.traffic.active().widths["rows"] += 4096
        with pytest.raises(TrafficDriftError) as ei:
            _drain(eng, [Request(p, max_new_tokens=6)
                         for p in _prompts(46, n=2)], on_step=tamper_rows)
    assert ei.value.term == "score_bytes"


def test_traffic_accountant_empty_scope(model):
    """A model whose every layer is a skip layer has an empty ledger: the
    accountant observes nothing rather than erroring."""
    _, _, cfg, sals = model["t"]
    all_skip = dataclasses.replace(sals, skip_layers_front=2,
                                   skip_layers_back=1)
    acct = TrafficAccountant(cfg, all_skip)

    class _FakeEngine:
        def _latent_segs(self, cache):
            return {}

    acct.observe_decode(_FakeEngine(), {}, [10, 20])
    assert acct.reconciled == 0 and acct.drifts == 0


# ---------------------------------------------------------------------------
# scheduler integration: views, conservation, LRU cap, lifecycle spans
# ---------------------------------------------------------------------------

def test_counter_views_are_registry_backed(model):
    """The public fields stay readable / writable, with the registry as
    the single store."""
    _, _, cfg, sals = model["t"]
    eng = _engine(model, "torch", **BASE)
    with obs.enabled(cfg=cfg, sals=sals) as h:
        sched = RequestScheduler(eng, mode="continuous")
        assert sched.metrics is h["registry"]
        sched.prefix_hits += 3
        assert sched.prefix_hits == 3
        assert h["registry"].counter(
            "serve_prefix_hits_total").value() == 3.0
    assert RequestScheduler(eng).metrics is not h["registry"]


def _conservation_scenario(flt, Req, Sched, eng):
    rng = np.random.default_rng(47)
    reqs = [Req(rng.integers(1, 128, size=12).astype(np.int32),
                max_new_tokens=6) for _ in range(3)]
    reqs.append(Req(rng.integers(1, 128, size=12).astype(np.int32),
                    max_new_tokens=30, timeout_steps=3))
    victim = Req(rng.integers(1, 128, size=12).astype(np.int32),
                 max_new_tokens=30)
    reqs.append(victim)

    def on_step(s, step):
        if step == 2:
            victim.cancel()

    return _drain(eng, reqs, Sched, flt, on_step=on_step), reqs


def test_metrics_conservation_and_terminal_counters(model):
    """submitted == done + failures + timeouts + cancellations at drain,
    in the public views AND the registry series they proxy."""
    _, _, cfg, sals = model["t"]
    eng = _engine(model, "torch", **BASE)
    with obs.enabled(cfg=cfg, sals=sals) as h:
        sched, reqs = _conservation_scenario(faults, Request,
                                             RequestScheduler, eng)
        assert all(r.finished for r in reqs)
        assert sched.submitted == 5
        assert sched.submitted == (sched.done + sched.failures
                                   + sched.timeouts + sched.cancellations)
        assert sched.timeouts == 1 and sched.cancellations == 1
        reg = h["registry"]
        assert reg.counter("serve_requests_submitted_total").value() == 5.0
        assert reg.counter("serve_requests_done_total").value() == 3.0
        assert reg.gauge("serve_pending").value() == 0
        assert reg.gauge("serve_residents").value() == 0


def test_tenant_gauges_lru_capped(model):
    """The per-tenant gauges follow the gauge_history ring policy (0 =
    unbounded)."""
    eng = _engine(model, "torch", **BASE)
    eng2 = ServeEngine.__new__(ServeEngine)
    eng2.__dict__.update(eng.__dict__)
    eng2.scfg = dataclasses.replace(eng.scfg, gauge_history=4)
    sched = RequestScheduler(eng2, mode="continuous")
    for i in range(10):
        sched._tenant_gauge(f"tenant{i}")
    assert set(sched.tenant_gauges) == {f"tenant{i}" for i in range(6, 10)}
    sched._tenant_gauge("tenant6")              # refresh 6
    sched._tenant_gauge("tenant99")             # evicts 7 (LRU), not 6
    assert "tenant6" in sched.tenant_gauges
    assert "tenant7" not in sched.tenant_gauges
    sched0 = RequestScheduler(eng, mode="continuous")
    for i in range(10):
        sched0._tenant_gauge(f"t{i}")
    assert len(sched0.tenant_gauges) == 10
    # the registry's label sets share the cap
    assert sched.metrics.max_series == 4 and sched0.metrics.max_series == 0


def _episode(prompts, policy_fault):
    """Two long priority-0 residents, three short priority-1 arrivals at
    steps 2, 4, 6 on a 2-slot arena (with a NaN-logits fault at the first
    decode pick under park)."""
    def scenario(flt, Req, Sched, eng):
        sched = Sched(eng, mode="continuous")
        lo = [Req(p, max_new_tokens=8, priority=0) for p in prompts[:2]]
        hi = [Req(p, max_new_tokens=4, priority=1) for p in prompts[2:]]
        for r in lo:
            sched.submit(r)
        arrivals = [(2, hi[0]), (4, hi[1]), (6, hi[2])]

        def on_step(s, step):
            while arrivals and step >= arrivals[0][0]:
                s.submit(arrivals.pop(0)[1])

        if policy_fault:
            with flt.injected(flt.FaultSchedule(at={"nan_logits": [1]})):
                sched.run(on_step=on_step)
        else:
            sched.run(on_step=on_step)
        return sched, lo + hi
    return scenario


def test_spans_balance_park_evict_fault_episode(model):
    """A park + evict + fault episode ends with every span closed and a
    valid Chrome trace covering the whole lifecycle vocabulary, the byte
    ledger reconciled throughout."""
    _, _, cfg, sals = model["t"]
    prompts = _prompts(48, n=5)
    with obs.enabled(cfg=cfg, sals=sals, with_traffic=True) as h:
        sched, reqs = _episode(prompts, True)(
            faults, Request, RequestScheduler, _engine(model, "torch",
                                                       **PARK))
        assert sched.parks >= 1 and sched.retries >= 1
        assert all(r.finished for r in reqs)
        tr = h["tracer"]
        assert tr.balanced(), (tr.open_tracks(), tr.begun, tr.ended)
        payload = tr.chrome_trace()
        assert validate_chrome_trace(payload) == []
        names = {e["name"] for e in payload["traceEvents"]}
        for want in ("queue_wait", "prefill", "prefill_chunk", "decode",
                     "decode_step", "parked", "teardown"):
            assert want in names, f"missing lifecycle span {want!r}"
        assert h["traffic"].drifts == 0
        assert h["traffic"].reconciled == sched.steps
    with obs.enabled(cfg=cfg, sals=sals) as h:
        sched, _ = _episode(prompts, False)(
            faults, Request, RequestScheduler, _engine(model, "torch",
                                                       **EVICT))
        assert sched.preemptions >= 1
        assert h["tracer"].balanced()
        assert validate_chrome_trace(h["tracer"].chrome_trace()) == []


def test_disabled_mode_is_invisible(model):
    """With nothing installed the scheduler runs as before: no tracer, no
    accountant, the public views still count, and the tokens equal an
    enabled run's (telemetry never perturbs decoding)."""
    from repro_torch.core import pager
    _, _, cfg, sals = model["t"]
    eng = _engine(model, "torch", **PAGED)
    prompts = _prompts(49, n=2)

    def run():
        reqs = [Request(p, max_new_tokens=4) for p in prompts]
        return _drain(eng, reqs), [r.result.tokens.copy() for r in reqs]

    assert obs.metrics.active() is None and pager._metrics_hook is None
    sched_off, toks_off = run()
    assert sched_off.tracer is None and sched_off.traffic is None
    assert sched_off.done == 2                  # the private registry
    with obs.enabled(cfg=cfg, sals=sals, with_traffic=True):
        sched_on, toks_on = run()
    for a, b in zip(toks_off, toks_on):
        np.testing.assert_array_equal(a, b)
    assert sched_on.steps == sched_off.steps
    assert obs.metrics.active() is None and pager._metrics_hook is None


def test_launcher_style_export_roundtrip(model, tmp_path):
    """The --metrics-out / --trace-out shapes: both files written at drain
    validate, and the JSON snapshot round-trips."""
    _, _, cfg, sals = model["t"]
    eng = _engine(model, "torch", **BASE)
    with obs.enabled(cfg=cfg, sals=sals, with_traffic=True) as h:
        _drain(eng, [Request(p, max_new_tokens=4)
                     for p in _prompts(50, n=2)])
        launch_serve.write_metrics(h["registry"], str(tmp_path / "m.prom"))
        launch_serve.write_metrics(h["registry"], str(tmp_path / "m.json"))
        h["tracer"].dump(tmp_path / "trace.json")
        snap = h["registry"].snapshot()
    assert validate_prometheus((tmp_path / "m.prom").read_text()) == []
    back = json.loads((tmp_path / "m.json").read_text())
    assert validate_snapshot(back) == [] and back == snap
    assert validate_chrome_trace(
        json.loads((tmp_path / "trace.json").read_text())) == []


def test_launcher_cli_writes_telemetry(tmp_path, capsys):
    """``launch.serve`` with the four telemetry flags on the CPU: the
    exports validate, the snapshot is re-written mid-run, the trace
    balances, and telemetry is uninstalled afterwards."""
    from repro_torch.core import pager
    prom, trace = tmp_path / "m.prom", tmp_path / "t.json"
    launch_serve.main(["--arch", "qwen2-1.5b", "--device", "cpu",
                       "--requests", "3", "--max-new-tokens", "5",
                       "--prompt-len", "24", "--max-seq", "128",
                       "--page-size", "32", "--audit-every", "1",
                       "--stream", "--metrics-out", str(prom),
                       "--trace-out", str(trace),
                       "--obs-snapshot-every", "2"])
    out = capsys.readouterr().out
    assert "[serve] streaming:" in out and "balanced" in out
    assert validate_prometheus(prom.read_text()) == []
    assert "serve_requests_done_total 3.0" in prom.read_text()
    assert "obs_ttft_ms_count 3" in prom.read_text()
    assert validate_chrome_trace(json.loads(trace.read_text())) == []
    assert obs.metrics.active() is None and pager._metrics_hook is None


# ---------------------------------------------------------------------------
# parity with the JAX scheduler: counters, gauges, histogram counts, spans
# ---------------------------------------------------------------------------

def _flat(reg, kinds) -> dict:
    """{(name, sorted labels): value (count for a histogram)}."""
    out = {}
    for m in reg.snapshot()["metrics"]:
        if m["type"] not in kinds:
            continue
        for s in m["series"]:
            key = (m["name"], tuple(sorted(s["labels"].items())))
            out[key] = s["count"] if m["type"] == "histogram" \
                else s["value"]
    return out


def _span_names(tracer, reqs) -> dict:
    """{track: [span names in begin order]}; a request's track is named by
    its index in ``reqs`` (the two packages number requests apart).  The
    port's iteration phases (``STEP_SPANS``) are left out: the reference
    has none."""
    idx = {f"req{r.req_id}": f"req#{k}" for k, r in enumerate(reqs)}
    out = {}
    for ev in sorted(tracer.events, key=lambda e: (e["t0"], e["t1"])):
        if ev["name"] in STEP_SPANS:
            continue
        out.setdefault(idx.get(ev["track"], ev["track"]), []).append(
            ev["name"])
    return out


def _assert_step_spans_nest(tracer) -> None:
    """The port's iteration phases: each one closed, carrying its
    iteration's ``step`` and ordinal ``it``, and the ``scheduler``
    track's spans properly nested (any two disjoint or one inside the
    other)."""
    evs = sorted((e for e in tracer.events if e["track"] == "scheduler"
                  and e["t1"] > e["t0"]), key=lambda e: (e["t0"], -e["t1"]))
    assert any(e["name"] in STEP_SPANS for e in evs)
    stack = []
    for e in evs:
        if e["name"] in STEP_SPANS:
            args = e["args"] or {}
            assert isinstance(args.get("step"), int), e
            assert isinstance(args.get("it"), int), e
        while stack and stack[-1]["t1"] <= e["t0"]:
            stack.pop()
        assert not stack or e["t1"] <= stack[-1]["t1"], (stack[-1], e)
        stack.append(e)


def _plain(flt, Req, Sched, eng, prompts, mnt=4):
    reqs = [Req(p, max_new_tokens=mnt) for p in prompts]
    return _drain(eng, reqs, Sched, flt), reqs


def _faulted(flt, Req, Sched, eng, prompts):
    reqs = [Req(p, max_new_tokens=5) for p in prompts]
    sched = _drain(eng, reqs, Sched, flt, schedule=flt.FaultSchedule(
        at={"prefill_chunk": [1], "decode_step": [2], "nan_logits": [0]}))
    return sched, reqs


PARITY = {
    "dense": (BASE, lambda f, R, S, e: _plain(f, R, S, e, _prompts(51))),
    "paged_faults": (PAGED,
                     lambda f, R, S, e: _faulted(f, R, S, e, _prompts(52))),
    "tiered": (TIERED, lambda f, R, S, e: _plain(
        f, R, S, e, [np.random.default_rng(44).integers(
            1, 128, size=30).astype(np.int32) for _ in range(5)], mnt=8)),
    "spec": (SPEC, lambda f, R, S, e: _plain(
        f, R, S, e, [np.tile(np.arange(3, 11, dtype=np.int32), 4)[:20 + 6 * i]
                     for i in range(2)], mnt=8)),
    "park_fault": (PARK, _episode(_prompts(48, n=5), True)),
    "evict": (EVICT, _episode(_prompts(48, n=5), False)),
    "conservation": (BASE, _conservation_scenario),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_telemetry_equals_reference(model, case):
    """The same requests through both schedulers with telemetry on give
    equal counters (by name and labels), gauges and histogram counts, and
    the same span names on every track; the port's own iteration phases,
    left out of that comparison, are closed and nest."""
    skw, scenario = PARITY[case]
    got = {}
    for pkg, (o, Req, Sched, flt) in PKGS.items():
        eng = _engine(model, pkg, **skw)
        with o.enabled() as h:
            sched, reqs = scenario(flt, Req, Sched, eng)
            tl = h["tracer"]
            assert tl.balanced(), (pkg, tl.open_tracks())
            got[pkg] = dict(
                tokens=[None if r.result is None else r.result.tokens.tolist()
                        for r in reqs],
                states=[r.state.value for r in reqs],
                counters=_flat(h["registry"], ("counter",)),
                gauges=_flat(h["registry"], ("gauge",)),
                hist=_flat(h["registry"], ("histogram",)),
                spans=_span_names(tl, reqs))
            if pkg == "torch":
                _assert_step_spans_nest(tl)
    j, t = got["jax"], got["torch"]
    assert t["states"] == j["states"] and t["tokens"] == j["tokens"]
    assert t["counters"] == j["counters"]
    assert t["gauges"] == j["gauges"]
    assert t["hist"] == j["hist"]
    assert t["spans"] == j["spans"]
    assert any(k[0] == "core_events_total" for k in t["counters"]) \
        == (skw.get("page_size", 0) > 0)


def test_timeline_histograms_equal_reference(model):
    """The streaming path: a RequestTimeline on every request feeds the
    TTFT / inter-token histograms with equal counts in both packages."""
    counts = {}
    for pkg, (o, Req, Sched, flt) in PKGS.items():
        eng = _engine(model, pkg, **PAGED)
        with o.enabled() as h:
            tl = o.RequestTimeline(registry=h["registry"])
            reqs = []
            sched = Sched(eng, mode="continuous")
            for p in _prompts(53):
                r = Req(p, max_new_tokens=5)
                tl.submitted(r.req_id)
                tl.attach(r)
                sched.submit(r)
                reqs.append(r)
            sched.run()
            counts[pkg] = _flat(h["registry"], ("histogram",))
    assert counts["torch"] == counts["jax"]
    assert counts["torch"][("obs_ttft_ms", ())] == 4
    assert counts["torch"][("obs_inter_token_ms", ())] == 16
