"""The port's two-tier page pool: the ``TieredPagePool`` state machine
(residency lifecycle, LRU with pinned write pages and thrash, free guards,
the tier audit, fault points firing before any state change, config
validation — the cases of ``tests/test_tiering.py``), the tiered
``RequestScheduler`` end to end (tokens equal to the untiered paged pool,
live pages past the hot tier with zero evictions, thrash shedding load,
prefetch off), parity with the reference's tiered scheduler on the same
weights and stream (tokens exact; tier counters, admissions and
``pool_gauges`` equal), and the fetch-and-rerun invariant: a decode step
run first with a selected page cold and then again leaves every cache
tensor and the logits bit for bit as one clean step does."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses

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
from repro_torch.core.pager import PagerInvariantError
from repro_torch.core.tiering import HotTierThrash, TieredPagePool
from repro_torch.serve import Request, RequestScheduler, ServeEngine, faults

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# TieredPagePool: the residency state machine
# ---------------------------------------------------------------------------

def test_tiered_pool_residency_lifecycle():
    pool = TieredPagePool(8, 4, hbm_slots=3, n_reserved=1)
    a = pool.alloc()
    assert pool.residency(a) == "fresh"
    pool.set_hot(a, pool.take_slot())
    assert pool.residency(a) == "hot" and pool.slots_free == 2
    b = pool.alloc()
    pool.set_cold(b, {"seg": 1})
    assert pool.residency(b) == "cold" and pool.host_pages == 1
    pool.audit_tiers()
    slot = pool.begin_spill(a)                 # hot -> in_flight -> cold
    assert pool.residency(a) == "in_flight" and slot >= 1
    pool.audit_tiers()                         # in-flight spill slot counted
    pool.finish_spill(a, {"seg": 2})
    assert pool.residency(a) == "cold"
    assert pool.spills == 1 and pool.slots_free == 3
    pool.audit_tiers()
    mirror = pool.begin_fetch(b)               # cold -> in_flight -> hot
    assert mirror == {"seg": 1}
    pool.finish_fetch(b, pool.take_slot())
    assert pool.residency(b) == "hot" and pool.fetches == 1
    pool.begin_fetch(a)                        # an abort restores the tier
    pool.abort_fetch(a)
    assert pool.residency(a) == "cold" and not pool.in_flight
    pool.audit_tiers()
    pool.free(b)
    pool.free(a)
    assert pool.pages_in_use == 0
    assert pool.slots_free == 3 and pool.host_pages == 0
    pool.audit_tiers()
    pool.check()


def test_tiered_pool_lru_pins_and_thrash():
    pool = TieredPagePool(8, 4, hbm_slots=3, n_reserved=1)
    p0, p1, p2 = (pool.alloc() for _ in range(3))
    for p in (p0, p1, p2):
        pool.set_hot(p, pool.take_slot())
    pool.touch([p0])                           # p1 becomes least recent
    assert pool.spill_victim() == p1
    pool.pin(p1)                               # the write page
    assert pool.spill_victim() == p2
    assert pool.spill_victim(exclude=[p0, p2]) is None      # thrash
    with pytest.raises(PagerInvariantError, match="pinned"):
        pool.begin_spill(p1)
    pool.audit_tiers()
    pool.unpin(p1)
    with pytest.raises(PagerInvariantError, match="unpinned"):
        pool.unpin(p1)
    with pytest.raises(PagerInvariantError, match="non-hot"):
        pool.pin(pool.alloc())                 # fresh pages can't be pinned
    assert issubclass(HotTierThrash, RuntimeError) and HotTierThrash.transient


def test_tiered_pool_free_guards():
    pool = TieredPagePool(8, 4, hbm_slots=2, n_reserved=1)
    a = pool.alloc()
    pool.set_hot(a, pool.take_slot())
    pool.pin(a)
    with pytest.raises(PagerInvariantError, match="pinned"):
        pool.free(a)
    pool = TieredPagePool(8, 4, hbm_slots=2, n_reserved=1)
    b = pool.alloc()
    pool.set_cold(b, {})
    pool.begin_fetch(b)
    with pytest.raises(PagerInvariantError, match="mid-transfer"):
        pool.free(b)
    with pytest.raises(ValueError, match="hbm_slots"):
        TieredPagePool(8, 4, hbm_slots=0)


def test_tiered_audit_detects_corruption():
    pool = TieredPagePool(8, 4, hbm_slots=3, n_reserved=1)
    a, b = pool.alloc(), pool.alloc()
    pool.set_hot(a, pool.take_slot())
    pool.set_cold(b, {})
    pool.audit_tiers(gauges={"host_pages": 1})
    pool.cold[a] = {}                          # in two tiers at once
    with pytest.raises(PagerInvariantError, match="both hot"):
        pool.audit_tiers()
    del pool.cold[a]
    pool.fresh.add(7)                          # residency without a ref
    with pytest.raises(PagerInvariantError, match="census"):
        pool.audit_tiers()
    pool.fresh.discard(7)
    c = pool.alloc()
    pool.set_hot(c, pool.hot[a])               # one slot for two pages
    with pytest.raises(PagerInvariantError, match="duplicate"):
        pool.audit_tiers()
    pool.hot[c] = pool.take_slot()
    pool.audit_tiers()
    pool._slots_free.append(pool.hot[a])       # assigned and free
    with pytest.raises(PagerInvariantError, match="slot conservation"):
        pool.audit_tiers()
    pool._slots_free.pop()
    pool.pins[b] = 1                           # a pin on a cold page
    with pytest.raises(PagerInvariantError, match="non-hot"):
        pool.audit_tiers()
    del pool.pins[b]
    with pytest.raises(PagerInvariantError, match="host_pages"):
        pool.audit_tiers(gauges={"host_pages": 99})


def test_tier_fault_points_fire_before_state_change():
    pool = TieredPagePool(8, 4, hbm_slots=3, n_reserved=1)
    a, b = pool.alloc(), pool.alloc()
    pool.set_hot(a, pool.take_slot())
    pool.set_cold(b, {"seg": 1})
    schedule = faults.FaultSchedule(at={"host_fetch": [0], "spill": [0]})
    with faults.injected(schedule):
        with pytest.raises(faults.InjectedFault):
            pool.begin_fetch(b)
        assert pool.residency(b) == "cold" and not pool.in_flight
        with pytest.raises(faults.InjectedFault):
            pool.begin_spill(a)
        assert pool.residency(a) == "hot" and not pool.in_flight
        pool.audit_tiers()
        pool.finish_fetch(b, (pool.begin_fetch(b), pool.take_slot())[1])
        assert pool.residency(b) == "hot"
    assert [p for p, *_ in schedule.log] == ["host_fetch", "spill"]
    pool.audit_tiers()


def test_tiered_config_validation():
    with pytest.raises(ValueError, match="needs the paged"):
        ServeConfig(max_seq_len=128, hbm_pages=4)
    with pytest.raises(ValueError, match=">= 0"):
        ServeConfig(max_seq_len=128, hbm_pages=-1)
    with pytest.raises(ValueError, match="max_batch"):
        ServeConfig(max_seq_len=128, page_size=16, prefill_chunk=16,
                    max_batch=3, hbm_pages=3)
    with pytest.raises(ValueError, match="exceeds the pool"):
        ServeConfig(max_seq_len=128, page_size=16, prefill_chunk=16,
                    max_batch=1, hbm_pages=99)
    with pytest.raises(ValueError, match="untiered"):
        ServeConfig(max_seq_len=128, page_size=16, prefill_chunk=16,
                    max_batch=2, hbm_pages=4, spec_window=4)


# ---------------------------------------------------------------------------
# end to end: the port's tiered scheduler
# ---------------------------------------------------------------------------

SALS_KW = dict(rank_ratio=0.5, score_ratio=0.5, n_critical=16, n_sink=2,
               n_recent=8, v_bits=8, v_group=32, skip_layers_front=1,
               skip_layers_back=1)
SKW = dict(max_seq_len=128, max_new_tokens=8, max_batch=3, prefill_chunk=8,
           page_size=16, audit_every=1)
ARCHS = {"llama2-mha": ("paper-llama2-7b", {"n_kv_heads": 4}),
         "yi-gqa": ("yi-9b", {})}


def _build(arch_key, n_layers=4, **sals_over):
    arch, over = ARCHS[arch_key]
    over = dict(dtype="float32", n_layers=n_layers, vocab_size=128, **over)
    jcfg = jax_get_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    kw = dict(SALS_KW, **sals_over)
    jsals, sals = JSALS(**kw), SALSConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    ju = jcal.random_layer_projectors(jax.random.PRNGKey(2), jcfg, jsals,
                                      jcfg.n_layers)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tu = projectors_from_numpy({"u": np.asarray(ju["u"])}, device="cpu")
    return dict(j=(jp, ju, jcfg, jsals), t=(tp, tu, cfg, sals))


@pytest.fixture(scope="module")
def model():
    return _build("yi-gqa")


@pytest.fixture(scope="module")
def demo():
    """Shared-prefix workload whose LIVE pages exceed the hot tier while
    each step's working set still fits: two groups of three requests
    sharing an 80-token prefix; n_critical 8 keeps the touched set small
    and retained prefix-cache entries accumulate cold pages."""
    m = _build("yi-gqa", n_critical=8)
    rng = np.random.default_rng(11)
    groups = [rng.integers(1, 128, size=80).astype(np.int32)
              for _ in range(2)]
    prompts = [np.concatenate([groups[k // 3],
                               rng.integers(1, 128, size=10).astype(np.int32)])
               for k in range(6)]
    return m, prompts


def _engine(model, hbm_pages, **skw):
    tp, tu, cfg, sals = model["t"]
    return ServeEngine(tp, tu, cfg, ServeConfig(
        sals=sals, hbm_pages=hbm_pages, **dict(SKW, **skw)), device="cpu")


def _run(eng, prompts, mnt=8):
    sched = RequestScheduler(eng)
    reqs = [Request(np.asarray(p, np.int32), max_new_tokens=mnt, req_id=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return reqs, sched


def _same_tokens(ra, rb):
    for a, b in zip(ra, rb):
        assert b.result is not None, (b.req_id, b.state, b.error)
        np.testing.assert_array_equal(a.result.tokens, b.result.tokens)


def _drain_tiers(sched):
    """Once the prefix-cache entries release their pins, both tiers drain
    to zero and every hot slot is free again."""
    pool = sched.pool
    assert not pool.in_flight
    assert len(pool.hot) + pool.host_pages + len(pool.fresh) \
        == pool.pages_in_use
    pool.audit_tiers(gauges=sched.pool_gauges[-1])
    if sched.prefix_index is not None:
        for e in list(sched.prefix_index.entries):
            sched.prefix_index.evict(e)
    assert pool.pages_in_use == 0
    assert pool.slots_free == pool.hbm_slots and pool.host_pages == 0
    pool.audit_tiers()
    pool.check()


def test_tiered_decode_token_exact_vs_untiered(model):
    """The same stream through a 6-slot hot tier gives the all-resident
    paged pool's greedy tokens: fetch-and-rerun and prefetch change
    placement, never results."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 128, size=int(n)).astype(np.int32)
               for n in (6, 19, 30, 11, 25, 9)]
    ru, _ = _run(_engine(model, 0), prompts)
    rt, st = _run(_engine(model, 6), prompts)
    _same_tokens(ru, rt)
    assert st.pool.spills >= 1                 # the tier engaged
    assert st.pool_gauges[-1]["evictions"] == 0
    _drain_tiers(st)


def test_tiered_over_capacity_zero_evictions(demo):
    """More live pages than device slots: the run completes with zero
    evictions (spill / fetch traffic replaces capacity pressure), audited
    every step, token-exact."""
    m, prompts = demo
    ru, _ = _run(_engine(m, 0), prompts)
    rt, st = _run(_engine(m, 10), prompts)
    _same_tokens(ru, rt)
    assert max(g["pages_in_use"] for g in st.pool_gauges) > 10
    assert st.pool_gauges[-1]["evictions"] == 0
    assert st.pool.spills > 0 and st.cold_misses > 0 and st.fetch_hits > 0
    assert max(g["host_pages"] for g in st.pool_gauges) > 0
    _drain_tiers(st)


def test_tiered_thrash_sheds_load_not_requests(demo):
    """A hot tier too small for the co-residents' working sets: a
    resident evicts itself to the queue (no retry spent) and every request
    still completes token-exact."""
    m, prompts = demo
    ru, _ = _run(_engine(m, 0), prompts)
    rt, st = _run(_engine(m, 8), prompts)
    _same_tokens(ru, rt)
    assert st.pool_gauges[-1]["evictions"] > 0
    assert st.failures == 0
    _drain_tiers(st)


def test_tiered_exact_without_prefetch(demo):
    """``tier_prefetch`` is a latency knob, not a correctness one: demand
    fetches alone give the same tokens."""
    m, prompts = demo
    ru, _ = _run(_engine(m, 0), prompts[:3])
    rt, st = _run(_engine(m, 10, tier_prefetch=False), prompts[:3])
    _same_tokens(ru, rt)
    assert st.prefetch_hits == 0
    _drain_tiers(st)


def test_tiered_fetch_fault_fails_only_its_request(demo):
    """An injected host_fetch fault fails the row that demanded the page;
    the others finish with the fault-free tokens."""
    m, prompts = demo
    clean, _ = _run(_engine(m, 10), prompts)
    eng = _engine(m, 10, max_request_retries=0)
    with faults.injected(faults.FaultSchedule(at={"host_fetch": {0}})):
        reqs, st = _run(eng, prompts)
    states = [r.state.value for r in reqs]
    assert states.count("failed") == 1 and st.failures == 1
    for r, ref in zip(reqs, clean):
        if r.state.value == "done":
            np.testing.assert_array_equal(r.result.tokens, ref.result.tokens)
        else:
            assert isinstance(r.error, faults.InjectedFault)
    _drain_tiers(st)


# ---------------------------------------------------------------------------
# parity with the reference's tiered scheduler
# ---------------------------------------------------------------------------

TIER_COUNTERS = ("fetch_hits", "prefetch_hits", "cold_misses", "evictions",
                 "prefix_hits", "cow_copies", "admission_stalls", "steps",
                 "failures", "done")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tiered_scheduler_matches_reference(arch):
    """Same weights, projectors and stream (shared prefixes, more live
    pages than the 8-slot hot tier) through both tiered schedulers."""
    m = _build(arch, n_critical=8)
    rng = np.random.default_rng(5)
    head = rng.integers(1, 128, size=48).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(1, 128, size=k)
                               .astype(np.int32)]) for k in (5, 20, 13)] \
        + [rng.integers(1, 128, size=n).astype(np.int32) for n in (30, 61)]
    jp, ju, jcfg, jsals = m["j"]
    jeng = JEngine(jp, ju, jcfg, JServe(sals=jsals, hbm_pages=8, **SKW))
    js = JScheduler(jeng, mode="continuous")
    jr = [JRequest(p, max_new_tokens=8, req_id=i)
          for i, p in enumerate(prompts)]
    for r in jr:
        js.submit(r)
    js.run()
    tr, ts = _run(_engine(m, 8), prompts)
    for a, b in zip(jr, tr):
        assert a.state.value == b.state.value == "done"
        np.testing.assert_array_equal(a.result.tokens, b.result.tokens)
    assert ts.pool.spills == js.pool.spills > 0
    assert ts.pool.fetches == js.pool.fetches
    for name in TIER_COUNTERS:
        assert getattr(ts, name) == getattr(js, name), name
    assert list(ts.admissions) == list(js.admissions)
    assert len(ts.pool_gauges) == len(js.pool_gauges)
    for jg, tg in zip(js.pool_gauges, ts.pool_gauges):
        assert {k: jg[k] for k in tg} == tg
        assert all(jg[k] == 0 for k in jg.keys() - tg.keys())
    assert ts.cold_misses > 0
    _drain_tiers(ts)


# ---------------------------------------------------------------------------
# fetch-and-rerun on in-place caches
# ---------------------------------------------------------------------------

def _clone_cache(cache):
    out = {}
    for k, seg in cache.items():
        if isinstance(seg, LatentKVCache):
            out[k] = dataclasses.replace(seg, **{
                f.name: getattr(seg, f.name).clone()
                for f in dataclasses.fields(seg)
                if isinstance(getattr(seg, f.name), torch.Tensor)})
        else:
            out[k] = {n: a.clone() for n, a in seg.items()}
    return out


def _tensors(cache):
    for k, seg in sorted(cache.items()):
        if isinstance(seg, LatentKVCache):
            for f in dataclasses.fields(seg):
                t = getattr(seg, f.name)
                if isinstance(t, torch.Tensor):
                    yield f"{k}.{f.name}", t
        else:
            for n, a in sorted(seg.items()):
                yield f"{k}.{n}", a


def test_rerun_step_equals_one_clean_step(model):
    """Two rows admitted with every page hot.  One decode step runs with a
    selected, not-written page made cold (its hot-table entry 0: the recon
    reads the trash slot, whose bytes are garbage), then the entry is
    restored and the same step runs again.  Every cache tensor (full
    layers' K/V, payload and score pools, ring, sink, lengths, tables) and
    the logits must equal one clean step's, bit for bit."""
    eng = _engine(model, 8, max_batch=2, n_pages=16)
    ps, mp = eng.scfg.page_size, eng.scfg.max_seq_len // eng.scfg.page_size
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 128, size=n).astype(np.int32)
               for n in (70, 45)]
    cache = eng.init_slot_cache()
    table = np.zeros((2, mp), np.int32)
    hot = np.zeros((2, mp), np.int32)
    tokens, positions = np.zeros(2, np.int32), np.zeros(2, np.int32)
    nxt = 1
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            logits, one = eng.prefill_one(p)
            n = -(-(len(p) + 1) // ps)
            table[i, :n] = np.arange(nxt, nxt + n)
            hot[i, :n] = np.arange(nxt, nxt + n)
            nxt += n
            eng.admit_tiered(cache, one, i, table[i, :n], hot[i, :n], 0,
                             len(p))
            tokens[i] = int(logits.argmax())
            positions[i] = len(p)
        eng.with_page_tables(cache, table, hot)
        for seg in eng._latent_segs(cache).values():
            seg.k_lat[:, 0].fill_(77)          # garbage in the trash slot
            seg.v_q[:, 0].fill_(-5)
        clean = _clone_cache(cache)
        want, _, touched = eng.decode_sel(tokens, clean, positions)
        write_page = positions[0] // ps
        cold = [j for j in np.nonzero(touched[0].numpy())[0]
                if j != write_page]
        assert cold, "the selection must touch a page besides the write page"
        miss = hot.copy()
        miss[0, cold[0]] = 0
        eng.with_page_tables(cache, table, miss)
        wrong, _, _ = eng.decode_sel(tokens, cache, positions)
        assert not torch.equal(wrong, want)    # the miss did matter
        eng.with_page_tables(cache, table, hot)
        got, _, _ = eng.decode_sel(tokens, cache, positions)
    assert torch.equal(got, want)
    for (name, a), (_, b) in zip(_tensors(cache), _tensors(clean)):
        assert torch.equal(a, b), name
