"""Fault-tolerant serving of the port under chaos (the port of
``tests/test_chaos.py``), held to the JAX scheduler's fault-free tokens.

Under seeded fault schedules (exact-occurrence regressions and randomized
sweeps) the port's serving tier must satisfy the reference's three
properties:

  (a) ``audit_serving_state()`` passes after every scheduler step (the
      engines audit every step, so a violation raises out of ``run``);
  (b) every request that ends DONE — faulted, retried or untouched — has
      exactly the tokens the JAX scheduler gives the same requests with no
      fault, from the same weights;
  (c) no deadlock or livelock: every run drains within a step bound, every
      request reaches a terminal state, and the drain leaves zero live
      pages (both tiers empty on the two-tier pool).

Both packages serve the reference's chaos model, reduced qwen2-1.5b (3
layers, vocab 128) with its SALS settings, in float32 (the port's parity
rule: the reference's bf16 caches round apart from the port's).  The
reference's speculative stream is not deterministic on this JAX, so the
speculative case holds the port to the JAX scheduler's SEQUENTIAL tokens
(always deterministic) and to its own fault-free speculative run.  Beyond
the reference's suite, the seeded sweeps also run through the JAX
scheduler under the same schedule (both packages' ``FaultSchedule`` draw
the same numbers): the same faults must fire at the same occurrences, with
equal states, tokens and counters.  The last section re-runs the sweeps
with telemetry on and checks that the metrics conserve."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:                       # optional dev extra: property tests skip without
    from hypothesis import given, settings, strategies as st
    from hypothesis import stateful
    HAVE_HYPOTHESIS = True
except ImportError:
    from conftest import given, settings, st  # noqa: F401
    HAVE_HYPOTHESIS = False

from repro.config import SALSConfig as JSALS
from repro.config import ServeConfig as JServe
from repro.configs import get_config as jax_get_config
from repro.core import calibration as jcal
from repro.models import transformer as jtf
from repro.serve import Request as JRequest
from repro.serve import RequestScheduler as JScheduler
from repro.serve import ServeEngine as JEngine
from repro.serve import faults as jfaults
from repro_torch import obs
from repro_torch.config import SALSConfig, ServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, projectors_from_numpy
from repro_torch.core.pager import (PagePool, PageTable, PagerInvariantError,
                                    PrefixIndex, audit_pager)
from repro_torch.obs.metrics import validate_prometheus, validate_snapshot
from repro_torch.obs.trace import validate_chrome_trace
from repro_torch.serve import Request, RequestScheduler, ServeEngine
from repro_torch.serve import faults
from repro_torch.serve.lifecycle import (LifecycleError, NanLogitsError,
                                         QueueFull, RequestState, transition)

torch.set_num_threads(1)

SALS_KW = dict(rank_ratio=0.5, score_ratio=0.5, n_critical=16, n_sink=2,
               n_recent=8, v_bits=8, v_group=32, skip_layers_front=1,
               skip_layers_back=1)
# the reference's chaos engine: paged, one 8-token chunk a sweep (prefill
# stays observable mid-flight), audited every step
CHAOS = dict(max_seq_len=128, max_new_tokens=8, max_batch=3,
             prefill_chunk=8, page_size=16, prefill_token_budget=8,
             audit_every=1)


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
    return dict(j=(jp, ju, jcfg, jsals), t=(tp, tu, cfg, sals), gold={})


def _port_engine(model, **skw):
    tp, tu, cfg, sals = model["t"]
    return ServeEngine(tp, tu, cfg, ServeConfig(sals=sals, **skw),
                       device="cpu")


@pytest.fixture(scope="module")
def eng(model):
    """ONE paged engine shared by most tests."""
    return _port_engine(model, **CHAOS)


@pytest.fixture(scope="module")
def jeng(model):
    """The JAX engine whose fault-free scheduler gives the gold tokens."""
    jp, ju, jcfg, jsals = model["j"]
    return JEngine(jp, ju, jcfg, JServe(sals=jsals, **CHAOS))


def _reqs(prompts, mnt=4, cls=Request, **kw):
    return [cls(np.asarray(p, np.int32), max_new_tokens=mnt, **kw)
            for p in prompts]


def _run(eng, reqs, schedule=None, on_step=None):
    sched = RequestScheduler(eng, mode="continuous")
    for r in reqs:
        sched.submit(r)
    if schedule is None:
        sched.run(on_step=on_step)
    else:
        with faults.injected(schedule):
            sched.run(on_step=on_step)
    return sched


def _drain_check(sched):
    """No leak at drain: audit passes, and once the prefix-cache entries
    release their pins the pool holds zero live pages."""
    sched.audit_serving_state()
    if sched.prefix_index is not None:
        for e in list(sched.prefix_index.entries):
            sched.prefix_index.evict(e)
    if sched.pool is not None:
        assert sched.pool.pages_in_use == 0
        sched.pool.check()


PROMPTS = None


def _workload():
    """The reference's fixed request stream, with a shared 2-page prefix
    (the prefix-resume and pin paths run under faults)."""
    global PROMPTS
    if PROMPTS is None:
        rng = np.random.default_rng(42)
        head = rng.integers(1, 128, size=32).astype(np.int32)
        PROMPTS = [
            rng.integers(1, 128, size=11).astype(np.int32),
            np.concatenate([head,
                            rng.integers(1, 128, size=7).astype(np.int32)]),
            rng.integers(1, 128, size=26).astype(np.int32),
            np.concatenate([head,
                            rng.integers(1, 128, size=13).astype(np.int32)]),
            rng.integers(1, 128, size=18).astype(np.int32),
        ]
    return PROMPTS


def _gold(model, jeng, name, prompts, mnts):
    """The JAX scheduler's fault-free greedy tokens for ``prompts`` with
    ``mnts`` new tokens each (computed once per name)."""
    if name not in model["gold"]:
        reqs = [JRequest(np.asarray(p, np.int32), max_new_tokens=n)
                for p, n in zip(prompts, mnts)]
        sched = JScheduler(jeng, mode="continuous")
        for r in reqs:
            sched.submit(r)
        sched.run()
        assert all(r.done for r in reqs)
        model["gold"][name] = [r.result.tokens.copy() for r in reqs]
    return model["gold"][name]


def _reference(model, jeng):
    return _gold(model, jeng, "workload", _workload(), [4] * 5)


def _assert_done_exact(reqs, ref):
    for r, want in zip(reqs, ref):
        assert r.state is RequestState.DONE, (r.req_id, r.state, r.error)
        np.testing.assert_array_equal(r.result.tokens, want)


# ---------------------------------------------------------------------------
# hooks are no-ops when disabled
# ---------------------------------------------------------------------------

def test_fault_hooks_noop_when_disabled(eng, jeng, model):
    """With no schedule installed, and with an empty one, the hooks change
    nothing: the JAX tokens, no retry, and the pager hook unwired."""
    from repro_torch.core import pager
    assert faults.active() is None and pager._fault_hook is None
    ref = _reference(model, jeng)
    for schedule in (None, faults.FaultSchedule(seed=1)):
        reqs = _reqs(_workload())
        sched = _run(eng, reqs, schedule=schedule)
        _assert_done_exact(reqs, ref)
        assert sched.failures == sched.retries == sched.step_faults == 0
        _drain_check(sched)
    assert faults.active() is None and pager._fault_hook is None


# ---------------------------------------------------------------------------
# per-point regressions: isolation + retry + teardown
# ---------------------------------------------------------------------------

def test_nan_logits_fails_only_victim(eng, jeng, model):
    """One poisoned decode row: the victim retries (greedy re-run, token-
    exact) and every other resident never notices."""
    ref = _reference(model, jeng)
    reqs = _reqs(_workload())
    sched = _run(eng, reqs,
                 schedule=faults.FaultSchedule(at={"nan_logits": [0]}))
    _assert_done_exact(reqs, ref)
    assert sched.retries == 1 and sched.failures == 0
    _drain_check(sched)


def test_nan_logits_exhausts_retries_into_failed(eng):
    """A row that poisons on every attempt ends FAILED with the error
    attached: never an infinite retry loop, never a crashed loop."""
    rng = np.random.default_rng(3)
    reqs = _reqs([rng.integers(1, 128, size=10).astype(np.int32)], mnt=6)
    sched = _run(eng, reqs,
                 schedule=faults.FaultSchedule(at={"nan_logits": [0, 1, 2]}))
    (r,) = reqs
    assert r.state is RequestState.FAILED
    assert isinstance(r.error, NanLogitsError)
    assert r.result is None and r.retries == 2
    assert sched.failures == 1 and sched.retries == 2
    _drain_check(sched)


# (fault point, occurrences, retries the run must grant): a prefill chunk,
# a torn admission splice (shared-prefix refcounts released), the prefix-
# resume branch (no pin leak), and page allocation mid-reservation (the
# partial table torn down all or nothing)
RETRY_CASES = [("prefill_chunk", [1], 1), ("admit", [0, 2], 2),
               ("prefix_resume", [0], 1), ("page_alloc", [2, 9], None)]


@pytest.mark.parametrize("point,at,retries", RETRY_CASES,
                         ids=[c[0] for c in RETRY_CASES])
def test_request_fault_retries_token_exact(eng, jeng, model, point, at,
                                           retries):
    ref = _reference(model, jeng)
    reqs = _reqs(_workload())
    schedule = faults.FaultSchedule(at={point: at})
    sched = _run(eng, reqs, schedule=schedule)
    assert [p for p, _ in schedule.log] == [point] * len(at)
    _assert_done_exact(reqs, ref)
    if retries is None:
        assert sched.retries >= 1
    else:
        assert sched.retries == retries
    _drain_check(sched)


def test_decode_step_fault_retries_step(eng, jeng, model):
    """Batch-wide decode faults retry the STEP (no request pays), bounded
    so a saturated schedule raises instead of spinning."""
    ref = _reference(model, jeng)
    reqs = _reqs(_workload())
    sched = _run(eng, reqs,
                 schedule=faults.FaultSchedule(at={"decode_step": [1]}))
    _assert_done_exact(reqs, ref)
    assert sched.step_faults == 1 and sched.failures == 0
    _drain_check(sched)
    reqs = _reqs(_workload()[:1])
    with pytest.raises(faults.InjectedFault):
        _run(eng, reqs,
             schedule=faults.FaultSchedule(at={"decode_step": [0, 1, 2]}))


def _share_write_page(sched, step):
    """At step 2, give the first resident's WRITE page a second owner: a
    prefix entry over its pages up to that one (tokens no prompt can
    match), so the row's next write must copy on write."""
    if step != 2:
        return
    ps = sched.engine.scfg.page_size
    for s_, tab in zip(sched._slots, sched._tables):
        if s_ is None:
            continue
        pos = len(s_.req.prompt) + len(s_.out) - 1
        n = pos // ps + 1
        sched.prefix_index.insert(np.zeros((n * ps,), np.int32),
                                  list(tab.pages[:n]), {}, None, None)
        return


@pytest.mark.parametrize("tier", ["paged", "tiered"])
@pytest.mark.parametrize("fault", [False, True], ids=["clean", "fault"])
def test_cow_copy_of_shared_write_page(eng, eng_tiered, jeng, model, tier,
                                       fault):
    """A resident whose write page gains a second owner copies it on its
    next write and decodes on token-exact (on the two-tier pool through
    the score-pool copy and a hot slot).  An injected ``cow_copy`` fault
    there fails only the writing row, which retries token-exact."""
    ref = _reference(model, jeng)
    reqs = _reqs(_workload())
    schedule = faults.FaultSchedule(at={"cow_copy": [0]} if fault else {})
    sched = _run(eng if tier == "paged" else eng_tiered, reqs,
                 schedule=schedule,
                 on_step=_share_write_page)
    assert sched.cow_copies == (0 if fault else 1)
    assert schedule.log == ([("cow_copy", 0)] if fault else [])
    assert sched.retries == int(fault) and sched.failures == 0
    _assert_done_exact(reqs, ref)
    (_drain_check_tiered if tier == "tiered" else _drain_check)(sched)


def test_draft_verify_fault_retries_round_token_exact(model, jeng):
    """``draft_verify`` fires before the window's forward, so an injected
    fault retries the whole round: the run stays token-exact with the
    fault-free speculative run and with the JAX scheduler's sequential
    tokens, the cache audited every step."""
    eng_s = _port_engine(model, **dict(CHAOS, max_batch=2, spec_window=4,
                                       temperature=0.0))
    rng = np.random.default_rng(31)
    base = rng.integers(1, 128, size=8).astype(np.int32)
    prompts = [np.tile(base, 4)[:20], np.tile(base, 4)[:26]]
    gold = _gold(model, jeng, "spec_sequential", prompts, [9, 9])

    def run(schedule=None):
        reqs = _reqs(prompts, mnt=9)
        sched = _run(eng_s, reqs, schedule=schedule)
        for r in reqs:
            assert r.state is RequestState.DONE, (r.req_id, r.state, r.error)
        _drain_check(sched)
        return [r.result.tokens.copy() for r in reqs], sched

    want, s0 = run()
    assert s0.step_faults == 0 and s0.spec_rounds > 0
    for w, g in zip(want, gold):
        np.testing.assert_array_equal(w, g)
    got, s1 = run(faults.FaultSchedule(at={"draft_verify": [1]}))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert s1.step_faults == 1 and s1.retries == 0 and s1.failures == 0
    assert s1.spec_rounds > 0
    assert s1.spec_committed == sum(len(t) for t in got) - len(got)
    reqs = _reqs(prompts[:1], mnt=6)
    with pytest.raises(faults.InjectedFault):
        _run(eng_s, reqs,
             schedule=faults.FaultSchedule(at={"draft_verify": [0, 1, 2]}))


# ---------------------------------------------------------------------------
# deadlines / cancellation / backpressure
# ---------------------------------------------------------------------------

def test_request_timeout_tears_down(eng):
    rng = np.random.default_rng(5)
    slow = Request(rng.integers(1, 128, size=9).astype(np.int32),
                   max_new_tokens=30, timeout_steps=4)
    ok = Request(rng.integers(1, 128, size=9).astype(np.int32),
                 max_new_tokens=6)
    sched = RequestScheduler(eng, mode="continuous")
    sched.submit(slow)
    sched.submit(ok)
    sched.run()
    assert slow.state is RequestState.TIMED_OUT and slow.result is None
    assert ok.state is RequestState.DONE and len(ok.result.tokens) == 6
    assert sched.timeouts == 1
    _drain_check(sched)


def test_cancel_mid_decode_spares_others(eng, jeng, model):
    ref = _reference(model, jeng)
    reqs = _reqs(_workload())
    victim = reqs[0]

    def on_step(s, step):
        if step == 2:
            victim.cancel()

    sched = _run(eng, reqs, on_step=on_step)
    assert victim.state is RequestState.CANCELLED and victim.result is None
    _assert_done_exact(reqs[1:], ref[1:])
    assert sched.cancellations == 1
    _drain_check(sched)


def test_cancel_mid_prefill_no_pinned_entry_leak(eng):
    """Cancelling a request whose prefix-hit prefill is still chunking
    releases its shared-page refcounts and registers NO entry."""
    rng = np.random.default_rng(7)
    head = rng.integers(1, 128, size=32).astype(np.int32)     # 2 pages
    first = Request(np.concatenate(
        [head, rng.integers(1, 128, size=6).astype(np.int32)]),
        max_new_tokens=20)
    follower = Request(np.concatenate(
        [head, rng.integers(1, 128, size=80).astype(np.int32)]),
        max_new_tokens=4)
    sched = RequestScheduler(eng, mode="continuous")
    sched.submit(first)
    sched.submit(follower)
    cancelled_in = {}

    def on_step(s, step):
        if s._active is not None and s._active.req is follower:
            cancelled_in["state"] = follower.state
            follower.cancel()

    sched.run(on_step=on_step)
    assert cancelled_in.get("state") is RequestState.PREFILLING
    assert follower.state is RequestState.CANCELLED
    assert first.state is RequestState.DONE
    assert len(sched.prefix_index.entries) == 1
    _drain_check(sched)


def test_bounded_queue_reject_and_shed(model):
    """submit() backpressure is typed and immediate: no engine run, no
    silent drop."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 128, size=8).astype(np.int32)
               for _ in range(4)]
    base = dict(max_seq_len=128, max_batch=2, prefill_chunk=8, max_queue=2)
    sched = RequestScheduler(_port_engine(model, **base,
                                          queue_policy="reject"))
    r1, r2, r3, _ = _reqs(prompts)
    sched.submit(r1)
    sched.submit(r2)
    with pytest.raises(QueueFull):
        sched.submit(r3)
    assert r3.state is RequestState.QUEUED      # caller still owns it
    sched = RequestScheduler(_port_engine(model, **base,
                                          queue_policy="shed-oldest"))
    q1, q2, q3, q4 = _reqs(prompts)
    sched.submit(q1)
    sched.submit(q2)
    sched.submit(q3)                            # sheds q1
    sched.submit(q4)                            # sheds q2
    assert q1.state is RequestState.CANCELLED
    assert isinstance(q1.error, QueueFull)
    assert q2.state is RequestState.CANCELLED
    assert [r.req_id for r in sched.pending] == [q3.req_id, q4.req_id]
    assert sched.shed == 2 and sched.cancellations == 2


# ---------------------------------------------------------------------------
# prefix-pin accounting and the pager state machine
# ---------------------------------------------------------------------------

def test_entry_eviction_with_live_sharer_keeps_pages():
    """Evicting an entry whose pages a live resident still shares drops
    only the ENTRY's refcounts: the resident's pages survive and the audit
    stays clean throughout."""
    pool = PagePool(8, 4, n_reserved=1)
    idx = PrefixIndex(pool)
    reg = PageTable(pool, 4)                   # the registrant's table
    reg.append_page()
    reg.append_page()
    toks = np.arange(8, dtype=np.int32)
    entry = idx.insert(toks, list(reg.pages), {1: None, 2: None}, None, None)
    live = PageTable(pool, 4)                  # a follower shares both pages
    live.append_shared(entry.page_ids[0])
    live.append_shared(entry.page_ids[1])
    reg.release_all()                          # registrant finished
    audit_pager(pool, [live], idx.entries)
    idx.evict(entry)                           # entry evicted under pressure
    audit_pager(pool, [live], [])
    for pid in live.pages:                     # sharer's pages still live
        assert pool.refcount(pid) == 1
    live.release_all()
    assert pool.pages_in_use == 0
    pool.check()


class _Census:
    """Pool + tables + prefix index driven by named ops, audited after
    every op: the body of the hypothesis state machine and its seeded
    replay."""

    def __init__(self):
        self.pool = PagePool(16, 4, n_reserved=1)
        self.tables = [PageTable(self.pool, 8) for _ in range(3)]
        self.idx = PrefixIndex(self.pool)
        self.serial = 0

    def grow(self, t):
        tab = self.tables[t]
        if self.pool.pages_free and tab.n_pages < tab.max_pages:
            tab.append_page()

    def share(self, src, dst):
        ts, td = self.tables[src], self.tables[dst]
        if ts.pages and td.n_pages < td.max_pages:
            td.append_shared(ts.pages[-1])

    def register(self, t):
        tab = self.tables[t]
        if tab.n_pages == 0:
            return
        self.serial += 1
        toks = np.arange(self.serial * 1000,
                         self.serial * 1000 + tab.n_pages * 4, dtype=np.int32)
        self.idx.insert(toks, list(tab.pages), {}, None, None)

    def evict(self, k):
        entries = self.idx.entries
        if entries:
            self.idx.evict(entries[k % len(entries)])

    def release(self, t):
        self.tables[t].release_all()

    def audit(self):
        audit_pager(self.pool, self.tables, self.idx.entries)

    def drain(self):
        for e in list(self.idx.entries):
            self.idx.evict(e)
        for t in self.tables:
            t.release_all()
        self.audit()
        assert self.pool.pages_in_use == 0


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
def test_chaos_pager_state_machine():
    """Random alloc / share / register / evict / release interleavings with
    the cross-structure audit as the invariant after EVERY rule."""

    class AuditMachine(stateful.RuleBasedStateMachine):
        def __init__(self):
            super().__init__()
            self.c = _Census()

        @stateful.rule(t=st.integers(0, 2))
        def grow(self, t):
            self.c.grow(t)

        @stateful.rule(src=st.integers(0, 2), dst=st.integers(0, 2))
        def share(self, src, dst):
            self.c.share(src, dst)

        @stateful.rule(t=st.integers(0, 2))
        def register(self, t):
            self.c.register(t)

        @stateful.rule(k=st.integers(0, 7))
        def evict(self, k):
            self.c.evict(k)

        @stateful.rule(t=st.integers(0, 2))
        def release(self, t):
            self.c.release(t)

        @stateful.invariant()
        def audited(self):
            self.c.audit()

    stateful.run_state_machine_as_test(
        AuditMachine, settings=settings(max_examples=25,
                                        stateful_step_count=50,
                                        deadline=None))


def test_chaos_pager_census_deterministic():
    """Seeded replay of the state-machine rules, ending in a full drain to
    zero live pages."""
    rng = np.random.default_rng(13)
    c = _Census()
    ops = [lambda: c.grow(int(rng.integers(3))),
           lambda: c.share(int(rng.integers(3)), int(rng.integers(3))),
           lambda: c.register(int(rng.integers(3))),
           lambda: c.evict(int(rng.integers(8))),
           lambda: c.release(int(rng.integers(3)))]
    for _ in range(300):
        ops[int(rng.integers(len(ops)))]()
        c.audit()
    c.drain()


# ---------------------------------------------------------------------------
# lifecycle + auditor units
# ---------------------------------------------------------------------------

def test_lifecycle_transition_table():
    r = Request(np.array([1], np.int32))
    assert r.state is RequestState.QUEUED and not r.finished
    transition(r, RequestState.PREFILLING)
    transition(r, RequestState.QUEUED)         # retry requeue
    transition(r, RequestState.PREFILLING)
    transition(r, RequestState.DECODING)
    transition(r, RequestState.DONE)
    assert r.done and r.finished
    for bad in (RequestState.QUEUED, RequestState.DONE,
                RequestState.FAILED):          # terminal states are frozen
        with pytest.raises(LifecycleError):
            transition(r, bad)
    f = Request(np.array([1], np.int32))
    boom = RuntimeError("boom")
    transition(f, RequestState.FAILED, boom)
    assert f.error is boom and f.finished and not f.done
    with pytest.raises(LifecycleError):
        transition(f, RequestState.DECODING)   # no resurrection


def test_auditor_detects_hand_corruption():
    """The auditor raises TYPED errors for each broken conservation
    invariant."""
    pool = PagePool(6, 4, n_reserved=1)
    t = PageTable(pool, 4)
    t.append_page()
    t.append_page()
    audit_pager(pool, [t], [])
    pool._ref[t.pages[0]] += 1                 # orphaned pool ref (leak)
    with pytest.raises(PagerInvariantError, match="leaked"):
        audit_pager(pool, [t], [])
    pool._ref[t.pages[0]] -= 1
    ghost = PageTable(pool, 4)
    ghost.pages = [t.pages[1]]                 # duplicate claim, no share()
    with pytest.raises(PagerInvariantError, match="over-referenced"):
        audit_pager(pool, [t, ghost], [])
    ghost.pages = [0]                          # maps the reserved trash page
    with pytest.raises(PagerInvariantError, match="reserved"):
        audit_pager(pool, [t, ghost], [])
    ghost.pages = []
    with pytest.raises(PagerInvariantError, match="gauge"):
        audit_pager(pool, [t], [], gauges={"pages_in_use": 99})
    pool._free.append(t.pages[0])              # live page on the free stack
    with pytest.raises(PagerInvariantError):
        pool.check()
    pool._free.pop()
    t.release_all()
    audit_pager(pool, [], [])


def test_scheduler_audit_catches_external_corruption(eng):
    """Corrupting the pool mid-run makes the NEXT step's audit raise
    PagerInvariantError out of run(): the auditor is live."""
    rng = np.random.default_rng(11)
    reqs = _reqs([rng.integers(1, 128, size=10).astype(np.int32)], mnt=8)

    def on_step(s, step):
        if step == 2:
            pid = next(t for t in s._tables if t is not None).pages[0]
            s.pool._ref[pid] += 1              # a lost free

    sched = RequestScheduler(eng, mode="continuous")
    for r in reqs:
        sched.submit(r)
    with pytest.raises(PagerInvariantError):
        sched.run(on_step=on_step)


# ---------------------------------------------------------------------------
# randomized arrival x fault sweeps (seeded seeds always run; hypothesis
# widens the seed space, bounded as the reference bounds it)
# ---------------------------------------------------------------------------

RATES = {"page_alloc": 0.04, "prefill_chunk": 0.04, "admit": 0.04,
         "decode_step": 0.02, "nan_logits": 0.03, "prefix_resume": 0.1,
         "cow_copy": 0.02}
STEP_BOUND = 400


def _check_episode(sched, reqs, ref):
    assert sched.steps <= STEP_BOUND, "livelock: step bound exceeded"
    for r, want in zip(reqs, ref):
        assert r.finished, (r.req_id, r.state)
        if r.state is RequestState.DONE:       # (b) token-exactness
            np.testing.assert_array_equal(r.result.tokens, want)
        else:
            assert r.state is RequestState.FAILED
            assert r.error is not None


def _chaos_run(eng, ref, seed, rates=RATES, drain=_drain_check):
    """One randomized episode: the three acceptance properties."""
    reqs = _reqs(_workload())
    schedule = faults.FaultSchedule(seed=seed, rates=rates)
    try:
        sched = _run(eng, reqs, schedule=schedule)
    except faults.InjectedFault:
        # the only legal escape: a decode_step streak past the retry bound
        assert schedule.log[-1][0] == "decode_step"
        return
    _check_episode(sched, reqs, ref)
    drain(sched)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chaos_sweep_deterministic(eng, jeng, model, seed):
    _chaos_run(eng, _reference(model, jeng), seed)


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2 ** 16))
def test_chaos_sweep_randomized(eng, jeng, model, seed):
    _chaos_run(eng, _reference(model, jeng), seed)


# ---------------------------------------------------------------------------
# two-tier pool chaos: the tier-transfer fault points ride the same
# schedules; tier conservation is audited every step
# ---------------------------------------------------------------------------

TIERED_RATES = dict(RATES, host_fetch=0.05, spill=0.05)


@pytest.fixture(scope="module")
def eng_tiered(model):
    """The chaos engine with the hot tier at its floor (max_batch + 1):
    every episode sees demand fetches, spills, prefetches and thrash
    shedding, and their fault points."""
    return _port_engine(model, **dict(CHAOS, hbm_pages=4))


def _drain_check_tiered(sched):
    """On top of zero live pages: BOTH tiers empty, nothing mid-transfer,
    every hot slot back on the free list."""
    _drain_check(sched)
    pool = sched.pool
    assert not pool.in_flight
    assert not pool.hot and pool.host_pages == 0 and not pool.fresh
    assert pool.slots_free == pool.hbm_slots
    pool.audit_tiers()


@pytest.mark.parametrize("point", ["host_fetch", "spill"])
def test_tiered_transfer_faults_retry_token_exact(eng_tiered, jeng, model,
                                                  point):
    """One injected fault on each tier-transfer point: the page stays in
    its prior tier, only the demanding row pays a transient retry, and the
    run ends token-exact with the UNTIERED fault-free JAX tokens."""
    ref = _reference(model, jeng)
    reqs = _reqs(_workload())
    schedule = faults.FaultSchedule(at={point: [0]})
    sched = _run(eng_tiered, reqs, schedule=schedule)
    assert schedule.log == [(point, 0)], f"{point} never fired"
    _assert_done_exact(reqs, ref)
    _drain_check_tiered(sched)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tiered_chaos_sweep_deterministic(eng_tiered, jeng, model, seed):
    _chaos_run(eng_tiered, _reference(model, jeng), seed, TIERED_RATES,
               _drain_check_tiered)


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2 ** 16))
def test_tiered_chaos_sweep_randomized(eng_tiered, jeng, model, seed):
    _chaos_run(eng_tiered, _reference(model, jeng), seed, TIERED_RATES,
               _drain_check_tiered)


# ---------------------------------------------------------------------------
# preempt-park chaos: park / resume fault points under mixed-priority
# arrivals; parked-page conservation is audited every step
# ---------------------------------------------------------------------------

PARK_RATES = dict(RATES, park=0.1, resume=0.1)
TIERED_PARK_RATES = dict(PARK_RATES, host_fetch=0.05, spill=0.05)
PRIO = dict(CHAOS, max_batch=2, priority_classes=2, preempt_policy="park")


@pytest.fixture(scope="module")
def eng_prio(model):
    """2-slot prioritized paged engine: every high-priority arrival finds
    a full arena, so parks and resumes are routine."""
    return _port_engine(model, **PRIO)


@pytest.fixture(scope="module")
def eng_prio_tiered(model):
    """The prioritized engine over a small hot tier: parked pages must
    also drain cold and never hold write pins."""
    return _port_engine(model, **dict(PRIO, hbm_pages=6))


def _park_reqs(priorities=False, cls=Request):
    """Two long low-priority residents and three short high-priority
    arrivals (priority 0 everywhere for the gold run)."""
    ps = _workload()
    lo, hi = (0, 1) if priorities else (0, 0)
    return ([cls(p, max_new_tokens=8, priority=lo) for p in ps[:2]]
            + [cls(p, max_new_tokens=4, priority=hi) for p in ps[2:]])


def _park_reference(model, jeng):
    """The JAX scheduler's fault-free FIFO tokens of the park workload."""
    ps = _workload()
    return _gold(model, jeng, "park", ps, [8, 8, 4, 4, 4])


def _staged_park_run(eng_p, reqs, schedule):
    """The two low-priority requests up front, the three high-priority ones
    at steps >= 2, 4, 6 (robust to the backoff fast-forward)."""
    sched = RequestScheduler(eng_p)
    for r in reqs[:2]:
        sched.submit(r)
    arrivals = [(2, reqs[2]), (4, reqs[3]), (6, reqs[4])]

    def on_step(sch, step):
        while arrivals and step >= arrivals[0][0]:
            sch.submit(arrivals.pop(0)[1])

    if schedule is None:
        sched.run(on_step=on_step)
    else:
        with faults.injected(schedule):
            sched.run(on_step=on_step)
    assert not arrivals
    return sched


@pytest.mark.parametrize("point", [None, "park", "resume"])
def test_park_round_trip_and_faults(eng_prio, jeng, model, point):
    """Fault-free, parks AND resumes happen; an injected ``park`` fault
    leaves the victim resident (the preemption retried later); an injected
    ``resume`` fault releases the parked pages and restarts the request
    through the retry policy.  Every request ends token-exact."""
    ref = _park_reference(model, jeng)
    reqs = _park_reqs(priorities=True)
    schedule = None if point is None else \
        faults.FaultSchedule(at={point: [0]})
    sched = _staged_park_run(eng_prio, reqs, schedule)
    if point is None:
        assert sched.parks >= 1 and sched.resumes >= 1
    else:
        assert (point, 0) in schedule.log, f"{point} never exercised"
    if point == "resume":
        assert sched.parks >= 1 and sched.retries >= 1
    _assert_done_exact(reqs, ref)
    _drain_check(sched)


def _park_chaos_run(eng_p, ref, seed, rates, tiered=False):
    reqs = _park_reqs(priorities=True)
    schedule = faults.FaultSchedule(seed=seed, rates=rates)
    try:
        sched = _staged_park_run(eng_p, reqs, schedule)
    except faults.InjectedFault:
        assert schedule.log[-1][0] == "decode_step"
        return
    _check_episode(sched, reqs, ref)
    (_drain_check_tiered if tiered else _drain_check)(sched)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_park_chaos_sweep_deterministic(eng_prio, jeng, model, seed):
    _park_chaos_run(eng_prio, _park_reference(model, jeng), seed, PARK_RATES)


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2 ** 16))
def test_park_chaos_sweep_randomized(eng_prio, jeng, model, seed):
    _park_chaos_run(eng_prio, _park_reference(model, jeng), seed, PARK_RATES)


@pytest.mark.parametrize("seed", [0, 1])
def test_tiered_park_chaos_sweep(eng_prio_tiered, jeng, model, seed):
    _park_chaos_run(eng_prio_tiered, _park_reference(model, jeng), seed,
                    TIERED_PARK_RATES, tiered=True)


# ---------------------------------------------------------------------------
# the sweeps against the JAX scheduler: one seeded schedule (the two
# packages' FaultSchedule draw the same numbers) through both schedulers
# fires the same faults at the same occurrences, and every request ends in
# the same state with the same tokens and counters
# ---------------------------------------------------------------------------

SWEEPS = {"plain": (CHAOS, RATES, False),
          "tiered": (dict(CHAOS, hbm_pages=4), TIERED_RATES, False),
          "park": (PRIO, PARK_RATES, True),
          "tiered_park": (dict(PRIO, hbm_pages=6), TIERED_PARK_RATES, True)}
SWEEP_COUNTERS = ("steps", "retries", "failures", "step_faults",
                  "evictions", "parks", "resumes", "preemptions",
                  "prefix_hits", "cow_copies", "fetch_hits", "prefetch_hits",
                  "cold_misses")


def _sweep_episode(pkg, eng, rates, park, seed) -> dict:
    if pkg == "jax":
        Req, Sched, flt = JRequest, JScheduler, jfaults
    else:
        Req, Sched, flt = Request, RequestScheduler, faults
    ps = _workload()
    if park:
        reqs = [Req(p, max_new_tokens=8, priority=0) for p in ps[:2]] \
            + [Req(p, max_new_tokens=4, priority=1) for p in ps[2:]]
        arrivals = [(2, reqs[2]), (4, reqs[3]), (6, reqs[4])]
    else:
        reqs, arrivals = _reqs(ps, cls=Req), []
    schedule = flt.FaultSchedule(seed=seed, rates=rates)
    sched = Sched(eng, mode="continuous")
    for r in reqs[:2] if park else reqs:
        sched.submit(r)

    def on_step(sch, step):
        while arrivals and step >= arrivals[0][0]:
            sch.submit(arrivals.pop(0)[1])

    escaped = None
    try:
        with flt.injected(schedule):
            sched.run(on_step=on_step)
    except flt.InjectedFault as exc:
        escaped = (exc.point, exc.occurrence)
    return dict(log=schedule.log, escaped=escaped,
                states=[r.state.value for r in reqs],
                tokens=[None if r.result is None else r.result.tokens.tolist()
                        for r in reqs],
                counters={k: getattr(sched, k) for k in SWEEP_COUNTERS})


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_fault_sweep_equals_reference(model, jeng, case, seed):
    skw, rates, park = SWEEPS[case]
    key = f"jax_{case}"
    if key not in model:
        jp, ju, jcfg, jsals = model["j"]
        model[key] = jeng if skw == CHAOS else \
            JEngine(jp, ju, jcfg, JServe(sals=jsals, **skw))
        model[f"torch_{case}"] = _port_engine(model, **skw)
    want = _sweep_episode("jax", model[key], rates, park, seed)
    got = _sweep_episode("torch", model[f"torch_{case}"], rates, park, seed)
    assert got == want


# ---------------------------------------------------------------------------
# telemetry conservation: the sweeps with the whole obs stack installed
# (registry + tracer + byte accountant) — the metrics conserve: submitted
# == the terminal counters' sum, every span balanced with no dangling
# track at drain, both exporters valid, and the byte ledger reconciled on
# every committed step
# ---------------------------------------------------------------------------

def _obs_conservation_check(sched, handles):
    assert sched.submitted == (sched.done + sched.failures + sched.timeouts
                               + sched.cancellations), \
        "a request left the system without hitting a terminal counter"
    reg = handles["registry"]
    assert reg.counter("serve_requests_submitted_total").value() == \
        sched.submitted
    tr = handles["tracer"]
    assert tr.balanced(), (tr.begun, tr.ended, tr.open_tracks())
    assert tr.open_tracks() == []                # zero dangling at drain
    assert validate_chrome_trace(tr.chrome_trace()) == []
    assert validate_snapshot(reg.snapshot()) == []
    assert validate_prometheus(reg.to_prometheus()) == []
    acct = handles["traffic"]
    assert acct.drifts == 0
    assert acct.reconciled == acct.steps > 0
    decode_spans = sum(1 for e in tr.events if e["name"] == "decode_step"
                       and not (e["args"] or {}).get("aborted"))
    assert acct.reconciled == decode_spans


def _obs_run(model, run):
    _, _, cfg, sals = model["t"]
    with obs.enabled(cfg=cfg, sals=sals, with_traffic=True) as handles:
        try:
            sched = run()
        except faults.InjectedFault:
            return None
        _obs_conservation_check(sched, handles)
    return sched


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_obs_chaos_conservation(eng, jeng, model, seed):
    """The fault sweep with telemetry on: the sweep's properties plus
    metric conservation, and telemetry perturbs no token."""
    ref = _reference(model, jeng)
    reqs = _reqs(_workload())
    schedule = faults.FaultSchedule(seed=seed, rates=RATES)
    sched = _obs_run(model, lambda: _run(eng, reqs, schedule=schedule))
    if sched is None:
        assert schedule.log[-1][0] == "decode_step"
        return
    _check_episode(sched, reqs, ref)
    _drain_check(sched)


@pytest.mark.parametrize("seed", [0, 1])
def test_obs_tiered_chaos_conservation(eng_tiered, jeng, model, seed):
    """Tiered: fetch / spill fault points fire mid-transfer while the
    accountant reconciles every page transfer; spans of aborted transfers
    still close."""
    ref = _reference(model, jeng)
    reqs = _reqs(_workload())
    schedule = faults.FaultSchedule(seed=seed, rates=TIERED_RATES)
    sched = _obs_run(model, lambda: _run(eng_tiered, reqs,
                                         schedule=schedule))
    if sched is None:
        assert schedule.log[-1][0] == "decode_step"
        return
    _check_episode(sched, reqs, ref)
    _drain_check_tiered(sched)


@pytest.mark.parametrize("seed", [0, 1])
def test_obs_park_chaos_conservation(eng_prio, jeng, model, seed):
    """Park / resume: a parked request holds an open ``parked`` span while
    off the arena; every park / resume / retry path hands it back before
    the drain."""
    ref = _park_reference(model, jeng)
    reqs = _park_reqs(priorities=True)
    schedule = faults.FaultSchedule(seed=seed, rates=PARK_RATES)
    sched = _obs_run(model, lambda: _staged_park_run(eng_prio, reqs,
                                                     schedule))
    if sched is None:
        assert schedule.log[-1][0] == "decode_step"
        return
    _check_episode(sched, reqs, ref)
    _drain_check(sched)
