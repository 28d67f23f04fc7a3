"""Port parity for the serving substrate: the port's ``RequestScheduler``
against the JAX one (default "xla" backend) on reduced paper-llama2-7b
(MHA) and yi-9b (GQA), from the same weights and projectors, with the SALS
settings of ``tests/test_paged.py``'s model.  Per request the tokens must
match exactly; the admissions ledger, the prefix / COW / eviction / stall
counters and the ``pool_gauges`` rows must be equal; after every decode
step the page tables and lengths must be equal and the pool contents at
mapped pages agree (floats within 1e-4 of the field's scale, the engine
test's logits tolerance; integer codes equal but for values on a rounding
boundary, see ``_assert_pools_equal``).  Port-only cases: paged
== dense arena, recycled pages never reach top-k, injected faults fail
only their request, cancellation and step deadlines."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SALSConfig as JSALS
from repro.config import ServeConfig as JServe
from repro.configs import get_config as jax_get_config
from repro.core import calibration as jcal
from repro.models import transformer as jtf
from repro.serve import Request as JRequest
from repro.serve import RequestScheduler as JScheduler
from repro.serve import ServeEngine as JEngine
from repro_torch.config import SALSConfig, ServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, projectors_from_numpy
from repro_torch.core.latent_cache import LatentKVCache
from repro_torch.serve import Request, RequestScheduler, ServeEngine
from repro_torch.serve import faults
from repro_torch.serve.lifecycle import RequestState

torch.set_num_threads(1)

SALS_KW = dict(rank_ratio=0.5, score_ratio=0.5, n_critical=16, n_sink=2,
               n_recent=8, v_bits=8, v_group=32, skip_layers_front=1,
               skip_layers_back=1)
ARCHS = {"llama2-mha": ("paper-llama2-7b", {"n_kv_heads": 4}),
         "yi-gqa": ("yi-9b", {})}
POOLS = ("k_lat", "k_scale", "v_q", "v_scale", "v_zero")


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    arch, over = ARCHS[request.param]
    over = dict(dtype="float32", n_layers=4, **over)
    jcfg = jax_get_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    jsals, sals = JSALS(**SALS_KW), SALSConfig(**SALS_KW)
    jp = jtf.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    ju = jcal.random_layer_projectors(jax.random.PRNGKey(2), jcfg, jsals,
                                      jcfg.n_layers)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tu = projectors_from_numpy({"u": np.asarray(ju["u"])}, device="cpu")
    return dict(j=(jp, ju, jcfg, jsals), t=(tp, tu, cfg, sals))


def _prompts(vocab, seed=3):
    """Three prompts sharing a 3-page (48-token) head, two unique ones."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, vocab, 48).astype(np.int32)
    shared = [np.concatenate([head, rng.integers(1, vocab, k)
                              .astype(np.int32)]) for k in (5, 20, 13)]
    return shared + [rng.integers(1, vocab, n).astype(np.int32)
                     for n in (6, 30)]


def _snap_jax(cache):
    return {k: {f: np.asarray(getattr(seg, f)).astype(np.float64)
                for f in POOLS + ("page_table", "lengths")
                if getattr(seg, f) is not None}
            for k, seg in cache.items() if hasattr(seg, "page_size")}


def _snap_torch(cache):
    return {k: {f: getattr(seg, f).double().numpy().copy()
                for f in POOLS + ("page_table", "lengths")
                if getattr(seg, f) is not None}
            for k, seg in cache.items() if isinstance(seg, LatentKVCache)}


def _run_jax(model, prompts, mnt, snaps, **skw):
    jp, ju, jcfg, jsals = model["j"]
    eng = JEngine(jp, ju, jcfg, JServe(sals=jsals, **skw))
    decode = eng._decode

    def spy(tokens, cache, pos):
        logits, cache = decode(tokens, cache, pos)
        snaps.append(_snap_jax(cache))
        return logits, cache

    eng._decode = spy
    sched = JScheduler(eng)
    reqs = [JRequest(p, max_new_tokens=mnt, req_id=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return sched, reqs


def _engine(model, **skw):
    tp, tu, cfg, sals = model["t"]
    return ServeEngine(tp, tu, cfg, ServeConfig(sals=sals, **skw),
                       device="cpu")


def _run_torch(model, prompts, mnt, snaps=None, **skw):
    eng = _engine(model, **skw)
    if snaps is not None:
        decode = eng.decode

        def spy(tokens, cache, pos):
            logits, cache = decode(tokens, cache, pos)
            snaps.append(_snap_torch(cache))
            return logits, cache

        eng.decode = spy
    sched = RequestScheduler(eng)
    reqs = [Request(p, max_new_tokens=mnt, req_id=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return sched, reqs


def _assert_pools_equal(jsnaps, tsnaps):
    assert len(jsnaps) == len(tsnaps)
    for step, (js, ts) in enumerate(zip(jsnaps, tsnaps)):
        assert js.keys() == ts.keys()
        for seg in js:
            j, t = js[seg], ts[seg]
            assert j.keys() == t.keys()
            np.testing.assert_array_equal(j["lengths"], t["lengths"])
            if "page_table" not in j:
                continue
            np.testing.assert_array_equal(j["page_table"], t["page_table"],
                                          err_msg=f"{seg} table @{step}")
            mapped = np.unique(j["page_table"][0])
            mapped = mapped[mapped > 0].astype(int)     # page 0 is trash
            for f in POOLS:
                if f not in j:
                    continue
                a, b = j[f][:, mapped], t[f][:, mapped]
                msg = f"{seg} {f} @{step}"
                if f == "v_q" or (f == "k_lat" and "k_scale" in j):
                    # integer codes of values that went through the model's
                    # f32 matmuls: XLA and torch sum in different orders, so
                    # a value on a rounding boundary may land one code
                    # apart; nothing else may differ
                    diff = np.abs(a - b)
                    assert diff.max() <= 1, msg
                    assert np.count_nonzero(diff) <= 1e-3 * diff.size, msg
                else:       # 1e-4 of the field's scale
                    tol = 1e-4 * max(1.0, float(np.abs(a).max()))
                    np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                               err_msg=msg)


def _assert_same_run(js, jr, ts, tr):
    for a, b in zip(jr, tr):
        assert a.state.value == b.state.value == "done"
        np.testing.assert_array_equal(a.result.tokens, b.result.tokens)
    assert list(js.admissions) == list(ts.admissions)
    assert list(js.prefill_chunks) == list(ts.prefill_chunks)
    for name in ("prefix_hits", "cow_copies", "evictions",
                 "admission_stalls", "steps", "submitted", "done"):
        assert getattr(js, name) == getattr(ts, name), name
    assert len(js.pool_gauges) == len(ts.pool_gauges)
    for jg, tg in zip(js.pool_gauges, ts.pool_gauges):
        assert {k: jg[k] for k in tg} == tg
        # the reference's park / preemption gauges stay at zero here
        assert all(jg[k] == 0 for k in jg.keys() - tg.keys())
    ts.audit_serving_state()


@pytest.mark.parametrize("page_size", [0, 16], ids=["dense", "paged"])
def test_scheduler_matches_reference(model, page_size):
    """Dense slot arena and paged pool with prefix sharing (three prompts
    share a 3-page head), mid-stream slot recycling (5 requests, 3 slots)."""
    skw = dict(max_seq_len=128, max_batch=3, prefill_chunk=8,
               page_size=page_size, audit_every=1)
    prompts = _prompts(model["t"][2].vocab_size)
    jsn, tsn = [], []
    js, jr = _run_jax(model, prompts, 6, jsn, **skw)
    ts, tr = _run_torch(model, prompts, 6, tsn, **skw)
    _assert_same_run(js, jr, ts, tr)
    _assert_pools_equal(jsn, tsn)
    if page_size:
        assert ts.prefix_hits == 2 and ts.pool_gauges


def test_pool_pressure_matches_reference(model):
    """A 9-page pool (8 tokens a page) for three 30-token prompts: the third
    stalls on pages, decode growth evicts a resident to the queue head, and
    every request still completes with the reference's tokens."""
    skw = dict(max_seq_len=64, max_batch=3, prefill_chunk=8, page_size=8,
               n_pages=9, audit_every=1)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, model["t"][2].vocab_size, 30)
               .astype(np.int32) for _ in range(3)]
    jsn, tsn = [], []
    js, jr = _run_jax(model, prompts, 8, jsn, **skw)
    ts, tr = _run_torch(model, prompts, 8, tsn, **skw)
    _assert_same_run(js, jr, ts, tr)
    _assert_pools_equal(jsn, tsn)
    assert ts.evictions >= 1 and ts.admission_stalls >= 1


# ---------------------------------------------------------------------------
# port only
# ---------------------------------------------------------------------------

def test_paged_equals_dense_arena(model):
    prompts = _prompts(model["t"][2].vocab_size, seed=5)
    skw = dict(max_seq_len=128, max_batch=2, prefill_chunk=8)
    _, dense = _run_torch(model, prompts, 7, **skw)
    _, paged = _run_torch(model, prompts, 7, page_size=16, **skw)
    for a, b in zip(dense, paged):
        np.testing.assert_array_equal(a.result.tokens, b.result.tokens)


def test_recycled_pages_never_reach_topk(model):
    """Freeing is metadata only, so a recycled page still holds an earlier
    request's bytes: a later, shorter request in those pages decodes as on
    a pristine pool."""
    rng = np.random.default_rng(9)
    vocab = model["t"][2].vocab_size
    wave1 = [rng.integers(1, vocab, 60).astype(np.int32) for _ in range(2)]
    wave2 = [rng.integers(1, vocab, 12).astype(np.int32) for _ in range(2)]
    skw = dict(max_seq_len=128, max_batch=2, prefill_chunk=8, page_size=16,
               prefix_cache=False)
    sched = RequestScheduler(_engine(model, **skw))
    reqs2 = [Request(p, max_new_tokens=6) for p in wave2]
    for r in [Request(p, max_new_tokens=4) for p in wave1] + reqs2:
        sched.submit(r)
    sched.run()
    _, fresh = _run_torch(model, wave2, 6, **skw)
    for r, ref in zip(reqs2, fresh):
        np.testing.assert_array_equal(r.result.tokens, ref.result.tokens)


@pytest.mark.parametrize("point", ["prefill_chunk", "admit"])
def test_injected_fault_fails_only_its_request(model, point):
    skw = dict(max_seq_len=128, max_batch=2, prefill_chunk=8, page_size=16,
               max_request_retries=0, audit_every=1)
    prompts = _prompts(model["t"][2].vocab_size, seed=7)[:3]
    _, clean = _run_torch(model, prompts, 4, **skw)
    sched = RequestScheduler(_engine(model, **skw))
    reqs = [Request(p, max_new_tokens=4) for p in prompts]
    for r in reqs:
        sched.submit(r)
    with faults.injected(faults.FaultSchedule(at={point: {1}})):
        sched.run()
    states = [r.state for r in reqs]
    assert states.count(RequestState.FAILED) == 1
    for r, ref in zip(reqs, clean):
        if r.state is RequestState.DONE:
            np.testing.assert_array_equal(r.result.tokens, ref.result.tokens)
        else:
            assert isinstance(r.error, faults.InjectedFault)
    assert sched.failures == 1 and sched.done == 2
    sched.audit_serving_state()
    for e in sched.prefix_index.entries:
        sched.prefix_index.evict(e)
    assert sched.pool.pages_in_use == 0


def test_cancel_and_step_deadline(model):
    skw = dict(max_seq_len=128, max_batch=2, prefill_chunk=8, page_size=16,
               audit_every=1)
    prompts = _prompts(model["t"][2].vocab_size, seed=13)[:3]
    sched = RequestScheduler(_engine(model, **skw))
    slow = Request(prompts[0], max_new_tokens=20, timeout_steps=5)
    victim = Request(prompts[1], max_new_tokens=20)
    keep = Request(prompts[2], max_new_tokens=6)
    streamed = []
    keep.on_token = lambda tok, i: streamed.append((i, tok))
    for r in (slow, victim, keep):
        sched.submit(r)

    def on_step(s, step):
        if step == 2:
            victim.cancel()

    sched.run(on_step=on_step)
    assert slow.state is RequestState.TIMED_OUT
    assert victim.state is RequestState.CANCELLED
    assert keep.state is RequestState.DONE
    assert [t for _, t in streamed] == keep.result.tokens.tolist()
    assert [i for i, _ in streamed] == list(range(6))
    assert sched.submitted == sched.done + sched.timeouts \
        + sched.cancellations
    sched.audit_serving_state()


def test_wall_clock_deadline(model):
    """``request_timeout_ms`` read through an injected clock that advances
    one second per decode step: the config's 3 s deadline fires on the
    resident and on the request still queued behind it; the per-request
    override outlives both."""
    skw = dict(max_seq_len=128, max_batch=2, prefill_chunk=8, page_size=16,
               request_timeout_ms=3000.0, audit_every=1)
    prompts = _prompts(model["t"][2].vocab_size, seed=17)[:3]
    now = [0.0]
    sched = RequestScheduler(_engine(model, **skw), clock=lambda: now[0])
    slow = Request(prompts[0], max_new_tokens=20)
    keep = Request(prompts[1], max_new_tokens=8, timeout_ms=60_000.0)
    queued = Request(prompts[2], max_new_tokens=4)
    for r in (slow, keep, queued):
        sched.submit(r)
    assert slow.deadline_time == queued.deadline_time == 3.0
    assert slow.deadline_step is None

    def on_step(s, step):
        now[0] += 1.0

    sched.run(on_step=on_step)
    assert keep.state is RequestState.DONE
    assert len(keep.result.tokens) == 8
    for r in (slow, queued):
        assert r.state is RequestState.TIMED_OUT
        assert "wall-clock" in str(r.error)
    assert sched.timeouts == 2 and sched.steps < 20
    assert sched.submitted == sched.done + sched.timeouts
    sched.audit_serving_state()


@pytest.mark.parametrize("use_sals", [False, True], ids=["full", "sals"])
def test_continuous_matches_static_token_exact(model, use_sals):
    """A request decoded inside the continuous batch (co-residents,
    recycled slots) gives the tokens of the static batcher (length-sorted
    fixed batches through ``generate``), which gives the JAX static
    scheduler's; ``on_batch`` sees each batch."""
    jp, ju, jcfg, jsals = model["j"]
    tp, tu, cfg, sals = model["t"]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(6, 30)))
               .astype(np.int32) for _ in range(7)]
    skw = dict(max_seq_len=128, max_batch=3, max_new_tokens=8)
    if not use_sals:
        jsals, sals = JSALS(enabled=False), SALSConfig(enabled=False)
        ju = tu = None
    runs = {}
    for name, mode in (("continuous", "continuous"), ("static", "static")):
        eng = ServeEngine(tp, tu, cfg, ServeConfig(sals=sals, **skw),
                          device="cpu")
        sched = RequestScheduler(eng, mode=mode)
        reqs = [Request(p, max_new_tokens=4 + i % 3)
                for i, p in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        batches = []
        done = sched.run(on_batch=lambda b: batches.append(
            [r.req_id for r in b]))
        assert all(r.done for r in reqs) and len(done) == 7
        runs[name] = ([r.result.tokens.tolist() for r in reqs], batches,
                      sched)
    jeng = JEngine(jp, ju, jcfg, JServe(sals=jsals, **skw))
    js = JScheduler(jeng, mode="static")
    jr = [JRequest(p, max_new_tokens=4 + i % 3)
          for i, p in enumerate(prompts)]
    for r in jr:
        js.submit(r)
    jbatches = []
    js.run(on_batch=lambda b: jbatches.append(len(b)))
    assert runs["continuous"][0] == runs["static"][0] == \
        [r.result.tokens.tolist() for r in jr]
    for r, n in zip(jr, (4 + i % 3 for i in range(7))):
        assert len(r.result.tokens) == n
    static = runs["static"][2]
    assert [len(b) for b in runs["static"][1]] == jbatches == [3, 3, 1]
    assert runs["continuous"][1] == []          # on_batch: static only
    assert static.done == static.submitted == 7 and static.steps == 0


def test_static_honours_cancellation_before_a_batch(model):
    """A cancellation requested before its batch starts ends the request
    CANCELLED without running it; the others are served."""
    eng = _engine(model, max_seq_len=64, max_batch=2)
    sched = RequestScheduler(eng, mode="static")
    rng = np.random.default_rng(4)
    reqs = [Request(rng.integers(1, 100, n).astype(np.int32),
                    max_new_tokens=3) for n in (9, 12, 15, 18)]
    for r in reqs:
        sched.submit(r)

    def cancel_last(batch):
        reqs[3].cancel()

    done = sched.run(on_batch=cancel_last)
    assert [r.state for r in reqs[:3]] == [RequestState.DONE] * 3
    assert reqs[3].state is RequestState.CANCELLED and reqs[3].result is None
    assert sched.cancellations == 1 and sched.done == 3
    assert {r.req_id for r in done} == {r.req_id for r in reqs}


def test_unported_options_raise(model):
    # static batching is ported: refused only where the reference refuses
    # it (the paged cache), and unknown modes are refused
    eng = _engine(model, max_seq_len=64, max_batch=2, prefill_chunk=8)
    assert RequestScheduler(eng, mode="static").mode == "static"
    with pytest.raises(ValueError, match="mode"):
        RequestScheduler(eng, mode="fifo")
    paged = _engine(model, max_seq_len=64, max_batch=2, prefill_chunk=8,
                    page_size=16)
    with pytest.raises(ValueError, match="continuous"):
        RequestScheduler(paged, mode="static")
