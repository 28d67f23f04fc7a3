"""Port parity for SLO scheduling: the port's ``RequestScheduler`` against
the JAX one on the reference's SLO cases (``tests/test_slo_sched.py``) —
priority classes, park / evict preemption, parked pages held, released
and spilled cold, tenant deficit round robin, in-flight caps, rate
credits and the ``tenant_gauges`` LRU cap — and on the park / resume fault
points (``tests/test_chaos.py``).

Both packages serve reduced qwen2-1.5b (3 layers, vocab 128, float32) from
the same weights and projectors, with the reference fixture's SALS
settings.  Every case runs the same traffic through both schedulers and
holds them equal: each request's state, tokens and park count, the
``admissions`` and ``prefill_chunks`` ledgers, every counter, the
``tenant_gauges`` and the ``pool_gauges`` rows."""
import collections
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
from repro.serve import faults as jfaults
from repro_torch.config import SALSConfig, ServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, projectors_from_numpy
from repro_torch.serve import Request, RequestScheduler, ServeEngine
from repro_torch.serve import faults
from repro_torch.serve.lifecycle import RequestState

torch.set_num_threads(1)

SALS_KW = dict(rank_ratio=0.5, score_ratio=0.5, n_critical=16, n_sink=2,
               n_recent=8, v_bits=8, v_group=32, skip_layers_front=1,
               skip_layers_back=1)
# the reference's contention recipe: 2 slots, one 8-token chunk a sweep,
# audited every step
PAGED = dict(max_seq_len=128, max_batch=2, max_new_tokens=8,
             prefill_chunk=8, page_size=16, prefill_token_budget=8,
             audit_every=1)
PKGS = {"jax": (JRequest, JScheduler, jfaults),
        "torch": (Request, RequestScheduler, faults)}
COUNTERS = ("steps", "submitted", "done", "failures", "timeouts",
            "cancellations", "retries", "step_faults", "evictions", "parks",
            "resumes", "preemptions", "admission_stalls", "prefix_hits",
            "cow_copies", "fetch_hits", "prefetch_hits", "cold_misses")


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


def _engines(model, **skw) -> dict:
    """{"jax": engine, "torch": engine} for ``ServeConfig(**skw)``, built
    once per module (the JAX engine compiles on its first run)."""
    key = tuple(sorted(skw.items()))
    if key not in model["engines"]:
        jp, ju, jcfg, jsals = model["j"]
        tp, tu, cfg, sals = model["t"]
        model["engines"][key] = {
            "jax": JEngine(jp, ju, jcfg, JServe(sals=jsals, **skw)),
            "torch": ServeEngine(tp, tu, cfg, ServeConfig(sals=sals, **skw),
                                 device="cpu")}
    return model["engines"][key]


def _both(model, scenario, **skw) -> dict:
    """``scenario(Request, RequestScheduler, faults, engine)`` -> (sched,
    requests) through each package's scheduler."""
    engs = _engines(model, **skw)
    return {pkg: scenario(*PKGS[pkg], engs[pkg]) for pkg in PKGS}


def _prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 127, size=n).astype(np.int32) for n in sizes]


def _admitted_order(sched):
    """req_ids in first-admission order (re-admissions dropped)."""
    seen, order = set(), []
    for _step, _slot, rid in sched.admissions:
        if rid not in seen:
            seen.add(rid)
            order.append(rid)
    return order


def _assert_same(runs) -> None:
    (js, jr), (ts, tr) = runs["jax"], runs["torch"]
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        assert a.state.value == b.state.value, (a.req_id, a.state, b.state,
                                                b.error)
        assert (a.result is None) == (b.result is None)
        if a.result is not None:
            np.testing.assert_array_equal(a.result.tokens, b.result.tokens)
            assert a.result.complete == b.result.complete
        assert a.parks == b.parks and a.attempts == b.attempts
    assert list(js.admissions) == list(ts.admissions)
    assert list(js.prefill_chunks) == list(ts.prefill_chunks)
    for name in COUNTERS:
        assert getattr(js, name) == getattr(ts, name), name
    assert list(js.tenant_gauges.items()) == list(ts.tenant_gauges.items())
    assert list(js.pool_gauges) == list(ts.pool_gauges)
    if ts.tiered:
        assert (ts.pool.spills, ts.pool.fetches) == (js.pool.spills,
                                                     js.pool.fetches)
    ts.audit_serving_state()


def _drain(sched) -> None:
    """Nothing leaked at drain: once the prefix entries release their pins
    the pool holds no live page (tiered: both tiers empty)."""
    sched.audit_serving_state()
    if sched.prefix_index is not None:
        for e in list(sched.prefix_index.entries):
            sched.prefix_index.evict(e)
    if sched.pool is not None:
        assert sched.pool.pages_in_use == 0
        sched.pool.check()
        if sched.tiered:
            assert not sched.pool.hot and sched.pool.host_pages == 0


# ---------------------------------------------------------------- priority


def test_priority_class_admission_order(model):
    """With a full backlog admission drains strictly by class, highest
    first, even with preemption off."""
    prompts = _prompts([10, 11, 12])

    def scenario(R, S, _f, eng):
        reqs = [R(p, max_new_tokens=4, priority=prio, req_id=i)
                for i, (p, prio) in enumerate(zip(prompts, (0, 1, 2)))]
        sched = S(eng)
        for r in reqs:
            sched.submit(r)
        sched.run()
        return sched, reqs

    runs = _both(model, scenario, max_seq_len=128, max_batch=1,
                 priority_classes=3, preempt_policy="none")
    _assert_same(runs)
    ts, tr = runs["torch"]
    assert all(r.done for r in tr)
    assert _admitted_order(ts) == [2, 1, 0]
    assert ts.preemptions == 0 and ts.parks == 0


def test_priority_out_of_range_rejected(model):
    engs = _engines(model, max_seq_len=128, max_batch=2, priority_classes=2,
                    preempt_policy="none")
    for pkg, (R, S, _f) in PKGS.items():
        sched = S(engs[pkg])
        for prio in (2, -1):
            with pytest.raises(ValueError):
                sched.submit(R(np.arange(1, 9, dtype=np.int32),
                               priority=prio))
        assert sched.submitted == 0 and not sched.tenant_gauges


def test_park_preemption_requires_paged_cache():
    for cls in (JServe, ServeConfig):
        with pytest.raises(ValueError):
            cls(max_seq_len=128, priority_classes=2, preempt_policy="park")


def _preempt_scenario(prompts, tenants=("a", "b", "c")):
    """Two low-priority residents fill the arena; a priority-1 request
    arrives on step 2 — the canonical preemption case."""
    def scenario(R, S, _f, eng):
        sched = S(eng)
        low = [R(prompts[i], max_new_tokens=8, priority=0,
                 tenant_id=tenants[i], req_id=i) for i in range(2)]
        hi = R(prompts[2], max_new_tokens=8, priority=1,
               tenant_id=tenants[2], req_id=2)
        for r in low:
            sched.submit(r)
        fired = []

        def on_step(sch, step):
            if step == 2 and not fired:
                fired.append(1)
                sch.submit(hi)

        sched.run(on_step=on_step)
        return sched, low + [hi]
    return scenario


def _gold(model, prompts, budgets=None):
    """The port's uncontended paged run (one class): the tokens every
    preemption flavour must give."""
    eng = _engines(model, **PAGED)["torch"]
    sched = RequestScheduler(eng)
    reqs = [Request(p, max_new_tokens=n)
            for p, n in zip(prompts, budgets or [8] * len(prompts))]
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert all(r.done for r in reqs)
    return [r.result.tokens.tolist() for r in reqs]


def test_preempt_park_round_trip_token_exact(model):
    """A parked-then-resumed victim gives the tokens of the uncontended
    run, never re-prefills, and the decode program keeps ONE capture key
    through every park and resume (attach writes the arena in place)."""
    prompts = _prompts([20, 18, 22])
    eng = _engines(model, priority_classes=2, preempt_policy="park",
                   **PAGED)["torch"]
    keys, first = [], eng._decode._first

    def spy_first(args, key):       # a new capture key (the card captures)
        keys.append(key)
        first(args, key)

    eng._decode._first = spy_first
    try:
        runs = _both(model, _preempt_scenario(prompts), priority_classes=2,
                     preempt_policy="park", **PAGED)
    finally:
        eng._decode._first = first
    _assert_same(runs)
    ts, tr = runs["torch"]
    assert ts.parks >= 1 and ts.resumes == ts.parks
    assert ts.preemptions >= 1
    assert [r.result.tokens.tolist() for r in tr] == _gold(model, prompts)
    assert len(_admitted_order(ts)) == len(ts.admissions) == 3
    chunks = collections.Counter(rid for _s, rid, _c, _n
                                 in ts.prefill_chunks)
    for r, p in zip(tr, prompts):
        assert chunks[r.req_id] == -(-len(p) // 8)
    # the counterpart of the reference's "detach/attach trace once each":
    # one run, one arena, one decode capture key through every park/resume
    assert len(keys) == 1


def test_preempt_evict_policy_re_prefills(model):
    """``evict`` trades held pages for a re-prefill: the same tokens, but
    the victim is admitted twice."""
    prompts = _prompts([20, 18, 22])
    runs = _both(model, _preempt_scenario(prompts), priority_classes=2,
                 preempt_policy="evict", **PAGED)
    _assert_same(runs)
    ts, tr = runs["torch"]
    assert ts.parks == 0 and ts.preemptions >= 1 and ts.evictions >= 1
    assert [r.result.tokens.tolist() for r in tr] == _gold(model, prompts)
    victims = collections.Counter(rid for _s, _i, rid in ts.admissions)
    assert max(victims.values()) >= 2


def test_parked_pages_stay_held_and_audited(model):
    """While a record sits parked its pages keep nonzero refcounts, probed
    every step beside the audit run() does every step."""
    prompts = _prompts([20, 18, 22])
    observed = {}

    def probe_run(R, S, f, eng):
        held = observed.setdefault(S.__module__, [])
        sched = S(eng)
        low = [R(prompts[i], max_new_tokens=8, req_id=i) for i in range(2)]
        hi = R(prompts[2], max_new_tokens=8, priority=1, req_id=2)
        for r in low:
            sched.submit(r)
        fired = []

        def on_step(sch, step):
            if step == 2 and not fired:
                fired.append(1)
                sch.submit(hi)
            for rec in sch.parked:
                held.append([sch.pool.refcount(p) for p in rec.ptab.pages])

        sched.run(on_step=on_step)
        return sched, low + [hi]

    runs = _both(model, probe_run, priority_classes=2, preempt_policy="park",
                 **PAGED)
    _assert_same(runs)
    jheld, theld = observed.values()
    assert theld == jheld
    assert theld and all(rc >= 1 for h in theld for rc in h)
    _drain(runs["torch"][0])


def test_parked_request_cancel_releases_pages(model):
    """cancel() of a PARKED request ends it from the parked set, flushes
    nothing it did not stream, and releases its page table."""
    prompts = _prompts([20, 18, 22])

    def scenario(R, S, _f, eng):
        sched = S(eng)
        low = [R(prompts[i], max_new_tokens=8, req_id=i) for i in range(2)]
        hi = R(prompts[2], max_new_tokens=8, priority=1, req_id=2)
        for r in low:
            sched.submit(r)
        state = {"submitted": False, "cancelled": False}

        def on_step(sch, step):
            if step == 2 and not state["submitted"]:
                state["submitted"] = True
                sch.submit(hi)
            if sch.parked and not state["cancelled"]:
                state["cancelled"] = True
                sch.parked[0].req.cancel()

        sched.run(on_step=on_step)
        assert state["cancelled"]
        return sched, low + [hi]

    runs = _both(model, scenario, priority_classes=2, preempt_policy="park",
                 **PAGED)
    _assert_same(runs)
    ts, tr = runs["torch"]
    cancelled = [r for r in tr if r.state is RequestState.CANCELLED]
    assert len(cancelled) == 1 and tr[2].done
    assert ts.cancellations == 1
    _drain(ts)


def test_tiered_park_spills_cold_never_pins(model):
    """Park on the two-tier pool: pages held ONLY by parked records drain
    to the cold tier and are never write-pinned; the victim still ends
    token-exact, its first steps after resume fetching its pages back."""
    prompts = _prompts([20, 18, 22])
    seen = {}

    def scenario(R, S, _f, eng):
        log = seen.setdefault(S.__module__, [])
        sched = S(eng)
        low = [R(prompts[i], max_new_tokens=8, req_id=i) for i in range(2)]
        hi = R(prompts[2], max_new_tokens=8, priority=1, req_id=2)
        for r in low:
            sched.submit(r)
        fired = []

        def on_step(sch, step):
            if step == 2 and not fired:
                fired.append(1)
                sch.submit(hi)
            pool = sch.pool
            for rec in sch.parked:
                excl = [p for p in rec.ptab.pages if pool.refcount(p)
                        == sum(q == p for q in rec.ptab.pages)]
                log.append((len(excl), sum(p in pool.cold for p in excl),
                            sum(bool(pool.pins.get(p))
                                for p in rec.ptab.pages)))

        sched.run(on_step=on_step)
        return sched, low + [hi]

    runs = _both(model, scenario, priority_classes=2, preempt_policy="park",
                 hbm_pages=6, **PAGED)
    _assert_same(runs)
    ts, tr = runs["torch"]
    jlog, tlog = seen.values()
    assert tlog == jlog
    assert ts.parks >= 1 and ts.resumes >= 1
    assert tlog and all(p == 0 for _e, _c, p in tlog)       # never pinned
    assert any(e == c > 0 for e, c, _p in tlog)             # went cold
    assert [r.result.tokens.tolist() for r in tr] == _gold(model, prompts)
    _drain(ts)


# ------------------------------------------------------------ fault points


def _park_fault_scenario(prompts, at):
    """Two long low-priority residents, three short priority-1 arrivals
    (steps >= 2, 4, 6) under a fault schedule ``at``."""
    def scenario(R, S, f, eng):
        reqs = ([R(p, max_new_tokens=8, priority=0, req_id=i)
                 for i, p in enumerate(prompts[:2])]
                + [R(p, max_new_tokens=4, priority=1, req_id=2 + i)
                   for i, p in enumerate(prompts[2:])])
        sched = S(eng)
        for r in reqs[:2]:
            sched.submit(r)
        arrivals = [(2, reqs[2]), (4, reqs[3]), (6, reqs[4])]

        def on_step(sch, step):
            while arrivals and step >= arrivals[0][0]:
                sch.submit(arrivals.pop(0)[1])

        schedule = f.FaultSchedule(at=at)
        with f.injected(schedule):
            sched.run(on_step=on_step)
        assert not arrivals
        assert (next(iter(at)), 0) in schedule.log, "point never visited"
        return sched, reqs
    return scenario


@pytest.mark.parametrize("point", ["park", "resume"])
def test_park_resume_fault_points(model, point):
    """``park`` fires before the snapshot read: the victim stays resident
    and the preemption is retried.  ``resume`` fires before the splice:
    the parked pages release and the request restarts through the retry
    policy.  Either way every request ends DONE with the fault-free
    tokens, and both packages take the same path."""
    prompts = _prompts([26, 23, 9, 12, 10], seed=3)
    runs = _both(model, _park_fault_scenario(prompts, {point: [0]}),
                 priority_classes=2, preempt_policy="park", **PAGED)
    _assert_same(runs)
    ts, tr = runs["torch"]
    assert all(r.state is RequestState.DONE for r in tr)
    assert [r.result.tokens.tolist() for r in tr] == _gold(
        model, prompts, [r.max_new_tokens for r in tr])
    assert ts.parks >= 1
    if point == "resume":
        assert ts.retries >= 1
    _drain(ts)


# ----------------------------------------------------------------- tenancy


def test_drr_interleaves_tenants_within_class(model):
    """A tenant's burst ahead of another's does not monopolize admission:
    deficit round robin alternates the tenant heads."""
    prompts = _prompts([10] * 6, seed=5)
    tenants = ("a", "a", "a", "b", "b", "b")

    def scenario(R, S, _f, eng):
        reqs = [R(p, max_new_tokens=4, tenant_id=t, req_id=i)
                for i, (p, t) in enumerate(zip(prompts, tenants))]
        sched = S(eng)
        for r in reqs:
            sched.submit(r)
        sched.run()
        return sched, reqs

    runs = _both(model, scenario, max_seq_len=128, max_batch=1)
    _assert_same(runs)
    ts, tr = runs["torch"]
    assert all(r.done for r in tr)
    assert [tenants[rid] for rid in _admitted_order(ts)] == \
        ["a", "b", "a", "b", "a", "b"]
    for t in ("a", "b"):
        assert ts.tenant_gauges[t]["submitted"] == 3
        assert ts.tenant_gauges[t]["admitted"] == 3


def test_tenant_max_inflight_cap(model):
    """tenant_max_inflight=1 keeps a tenant at one resident with a slot
    free, and the deferral gauge records the waits."""
    prompts = _prompts([10, 11, 12], seed=7)
    peaks = {}

    def scenario(R, S, _f, eng):
        peak = peaks.setdefault(S.__module__, [])
        reqs = [R(p, max_new_tokens=4, tenant_id="greedy", req_id=i)
                for i, p in enumerate(prompts)]
        sched = S(eng)
        for r in reqs:
            sched.submit(r)
        sched.run(on_step=lambda sch, step: peak.append(sum(
            1 for s in sch._slots if s is not None)))
        return sched, reqs

    runs = _both(model, scenario, max_seq_len=128, max_batch=2,
                 tenant_max_inflight=1)
    _assert_same(runs)
    ts, tr = runs["torch"]
    assert all(r.done for r in tr)
    assert max(peaks[RequestScheduler.__module__]) == 1
    assert ts.tenant_gauges["greedy"]["cap_deferrals"] > 0


def test_tenant_rate_limit_paces_admission(model):
    """A small tenant_rate paces a burst over iterations, counts the
    deferrals and drops nothing."""
    prompts = _prompts([10, 10, 10], seed=9)

    def scenario(R, S, _f, eng):
        reqs = [R(p, max_new_tokens=4, tenant_id="bursty", req_id=i)
                for i, p in enumerate(prompts)]
        sched = S(eng)
        for r in reqs:
            sched.submit(r)
        sched.run()
        return sched, reqs

    runs = _both(model, scenario, max_seq_len=128, max_batch=2,
                 tenant_rate=4.0)
    _assert_same(runs)
    ts, tr = runs["torch"]
    assert all(r.done for r in tr)
    g = ts.tenant_gauges["bursty"]
    assert g["admitted"] == 3 and g["rate_deferrals"] > 0
    steps = sorted(s for s, _i, _r in ts.admissions)
    assert steps[-1] > steps[0]


def test_tenant_gauges_lru_capped(model):
    """``gauge_history`` caps the tenant gauges: past the cap the least
    recently touched tenant's row goes (and the ring ledgers keep only
    the newest rows)."""
    prompts = _prompts([9, 10, 11, 12, 13], seed=11)
    tenants = ("t0", "t1", "t2", "t0", "t3")

    def scenario(R, S, _f, eng):
        reqs = [R(p, max_new_tokens=3, tenant_id=t, req_id=i)
                for i, (p, t) in enumerate(zip(prompts, tenants))]
        sched = S(eng)
        for r in reqs:
            sched.submit(r)
        sched.run()
        return sched, reqs

    runs = _both(model, scenario, max_seq_len=128, max_batch=2,
                 gauge_history=2)
    _assert_same(runs)
    ts, tr = runs["torch"]
    assert all(r.done for r in tr)
    assert len(ts.tenant_gauges) == 2
    assert len(ts.admissions) == 2
