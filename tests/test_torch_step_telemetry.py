"""The step programs' own records and the scheduler's iteration spans.

(a) ``serve/step_graph.py``'s always-on counters: every call after a
    capture adds its host phases (``stage``, ``key``, ``launch``) to a
    table keyed by the program's name, which sums the calls of every
    engine and outlives them; the ring keeps the last ``RING`` calls; on
    the CPU no replay has a device time; the timing pools of program
    objects that are gone leave the table.
(b) The scheduler's own host work in each iteration of the continuous
    loop, ``obs/trace.py``'s ``STEP_SPANS`` on the ``scheduler`` track:
    closed, each with its iteration's ``step`` and ordinal ``it``, in
    their iteration (``decode_commit`` inside ``decode_step``).
(c) The profiler mirror: while a ``torch.profiler`` records, each
    ``scheduler``-track span begun is a ``user_annotation`` range of the
    same name; without a tracer, or without a profiler, there is none.
(d) On the card (``requires_cuda``): the replays' device times from the
    programs' own events, and no synchronizing call beyond the caller's
    reads.  This file does not import JAX, so (d) runs on a machine
    without it: ``python -m pytest --noconftest -m requires_cuda
    tests/test_torch_step_telemetry.py``.
"""
import collections
import gc
import inspect
import json
import time
import warnings
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.config import SALSConfig, ServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import projectors_from_numpy
from repro_torch.models import transformer as ttf
from repro_torch.obs.trace import STEP_SPANS
from repro_torch.serve import Request, RequestScheduler, ServeEngine
from repro_torch.serve import step_graph

torch.set_num_threads(1)

SALS_KW = dict(rank_ratio=0.5, score_ratio=0.5, n_critical=16, n_sink=2,
               n_recent=8, v_bits=8, v_group=32, skip_layers_front=1,
               skip_layers_back=1)
PAGED = dict(max_seq_len=128, max_new_tokens=4, max_batch=2,
             prefill_chunk=8, prefill_token_budget=16, page_size=16)


def _model(device="cpu", dtype="float32", **over):
    cfg = get_config("yi-9b").reduced(dtype=dtype, n_layers=4,
                                      vocab_size=128, **over)
    sals = SALSConfig(**SALS_KW)
    params = ttf.init_params(cfg, device=device, seed=0)
    r = sals.rank(cfg.kv_dim)
    rng = np.random.default_rng(2)
    u = np.stack([np.linalg.qr(rng.standard_normal((cfg.kv_dim, r)))[0]
                  for _ in range(cfg.n_layers)]).astype(np.float32)
    proj = projectors_from_numpy({"u": u}, device=device)
    if dtype != "float32":
        proj = {"u": proj["u"].to(ttf.torch_dtype(dtype))}
    return params, proj, cfg, sals


@pytest.fixture(scope="module")
def model():
    return _model()


def _engine(model, device="cpu", **skw):
    params, proj, cfg, sals = model
    skw = {"max_seq_len": 64, "max_batch": 2, **skw}
    return ServeEngine(params, proj, cfg, ServeConfig(sals=sals, **skw),
                       device=device)


def _decode(eng, n, device_inputs=False):
    """``n`` decode steps of the engine's empty arena (both rows from
    position 0), each ending in the host read of its tokens; the first
    call for the arena is its capture."""
    cache = eng.init_slot_cache()
    tok = np.array([3, 5], np.int32)
    with torch.inference_mode():
        for p in range(n):
            pos = np.full((2,), p, np.int32)
            if device_inputs:
                tok, pos = (torch.as_tensor(a, device=eng.device)
                            for a in (tok, pos))
            logits, _ = eng.decode(tok, cache, pos)
            tok = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
    return cache


def _prompts(seed=11, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, size=int(rng.integers(20, 40)))
            .astype(np.int32) for _ in range(n)]


def _serve(model, on_step=None):
    eng = _engine(model, **PAGED)
    sched = RequestScheduler(eng)
    reqs = [Request(p, max_new_tokens=4) for p in _prompts()]
    for r in reqs:
        sched.submit(r)
    sched.run(on_step=on_step)
    assert all(r.done for r in reqs)
    return sched


# ---------------------------------------------------------------------------
# (a) the programs' counters
# ---------------------------------------------------------------------------

def test_phase_counters_sum_by_name_across_engines_and_outlive_them(model):
    step_graph.reset_program_stats()
    engines = [_engine(model), _engine(model)]
    for eng, n in zip(engines, (4, 3)):
        _decode(eng, n)
    # the first call for each arena runs for its key, the others replay
    assert sum(e._decode.calls - 1 for e in engines) == 5
    del engines, eng
    gc.collect()
    st = step_graph.program_stats("decode")
    assert st["calls"] == len(st["host"]) == 5
    for k in ("stage_s", "key_s", "launch_s"):
        assert st[k] > 0 and st[k] == pytest.approx(
            sum(r[k] for r in st["host"]))
    assert all(min(r["stage_s"], r["key_s"], r["launch_s"]) >= 0
               for r in st["host"])
    assert [r["t"] for r in st["host"]] == sorted(r["t"] for r in st["host"])
    assert step_graph.program_stats("decode_window") is None


def test_device_ring_stays_empty_on_the_cpu(model):
    step_graph.reset_program_stats()
    _decode(_engine(model), 4)
    st = step_graph.program_stats("decode")
    assert st["calls"] == 3
    assert st["device"] == [] and st["device_s"] == 0.0
    assert st["timed"] == st["untimed"] == 0


def test_ring_keeps_the_last_calls(model, monkeypatch):
    monkeypatch.setattr(step_graph, "RING", 4)
    step_graph.reset_program_stats()
    t = time.perf_counter()
    _decode(_engine(model), 7)
    st = step_graph.program_stats("decode")
    assert st["calls"] == 6 and len(st["host"]) == 4
    assert st["key_s"] > sum(r["key_s"] for r in st["host"])
    assert all(r["t"] > t for r in st["host"])
    step_graph.reset_program_stats()


def test_each_engine_program_keeps_its_name(model):
    eng = _engine(model, **PAGED)
    assert {g.name for g in (eng._prefill_chunk, eng._decode,
                             eng._decode_sel, eng._decode_window,
                             eng._commit_window)} == {
        "prefill_chunk", "decode", "decode_sel", "decode_window",
        "commit_window"}


def test_scheduler_run_records_chunk_and_decode_programs(model):
    step_graph.reset_program_stats()
    sched = _serve(model)
    dec = step_graph.program_stats("decode")
    chunk = step_graph.program_stats("prefill_chunk")
    assert dec["calls"] == sched.steps - 1      # one capture
    assert chunk["calls"] == len(sched.prefill_chunks) - 1
    assert dec["timed"] == chunk["timed"] == 0                   # no card


class _Owner:
    """Stands for a program object (weakly referenced)."""


class _Pair:
    """Stands for a timing pair: pending while ``t`` is set, complete
    once ``done``."""

    def __init__(self, t, done):
        self.t, self.start = t, self
        self.end = self
        self._done = done

    def query(self):
        return self._done

    def elapsed_time(self, end):
        return 2.0


def test_pools_of_programs_gone_leave_the_table():
    """A pool stays while its program object lives; once the object is
    gone its completed pairs are read and the pool dropped, and a pool
    with a pair still pending stays until the pair completes."""
    prog = step_graph._Program()
    live, dead, busy = _Owner(), _Owner(), _Owner()
    prog.pools = [(weakref.ref(live), [_Pair(None, True)]),
                  (weakref.ref(dead), [_Pair(1.0, True), _Pair(None, True)]),
                  (weakref.ref(busy), [_Pair(2.0, False)])]
    del dead, busy
    gc.collect()
    prog.prune()
    assert [len(p) for _, p in prog.pools] == [1, 1]
    assert prog.timed == 1 and prog.device[-1] == (1.0, 2e-3)
    prog.pools[1][1][0]._done = True
    prog.prune()
    assert len(prog.pools) == 1 and prog.pools[0][0]() is live
    assert prog.timed == 2


# ---------------------------------------------------------------------------
# (b) the iteration's spans
# ---------------------------------------------------------------------------

def _iterations(tracer):
    """The ``scheduler`` track's spans grouped by the iteration they lie
    in, in begin order: each ``STEP_SPANS`` span names its ``it``, and
    any other span belongs to the iteration whose ``sweep`` began last
    before it."""
    evs = sorted((e for e in tracer.events if e["track"] == "scheduler"),
                 key=lambda e: (e["t0"], -e["t1"]))
    its, cur = collections.defaultdict(list), None
    for e in evs:
        if e["name"] == "sweep":
            cur = e["args"]["it"]
        its[e["args"]["it"] if e["name"] in STEP_SPANS else cur].append(e)
    return [its[k] for k in sorted(its)]


def test_step_spans_are_closed_and_nest_in_their_iteration(model):
    with obs.enabled() as h:
        sched = _serve(model, on_step=lambda s, step: None)
        tr = h["tracer"]
        assert tr.balanced() and tr.open_tracks() == []
    its = _iterations(tr)
    assert [it[0]["args"]["it"] for it in its] == list(range(len(its)))
    names = {e["name"] for it in its for e in it}
    assert set(STEP_SPANS) <= names
    n_decode = 0
    for it in its:
        assert it[0]["name"] == "sweep"
        step = it[0]["args"]["step"]
        for e in it:
            if e["name"] in STEP_SPANS:
                assert e["args"]["step"] == step, e
        dec = [e for e in it if e["name"] == "decode_step"]
        if not dec:
            assert not any(e["name"] == "decode_commit" for e in it)
            continue
        n_decode += 1
        (d,) = dec
        assert d["args"]["step"] == step
        (c,) = [e for e in it if e["name"] == "decode_commit"]
        assert d["t0"] <= c["t0"] and c["t1"] <= d["t1"]
        for e in it:
            if e["name"] in ("admit", "page_upkeep", "prefill_chunk"):
                assert e["t1"] <= d["t0"], e
    assert n_decode == sched.steps


def test_iterations_that_share_a_step_are_told_apart(model):
    """The first prompt's prefill takes several sweeps with the arena
    empty, all at step 0: each is an iteration of its own."""
    with obs.enabled() as h:
        _serve(model)
    sweeps = [e["args"] for e in h["tracer"].events if e["name"] == "sweep"]
    at0 = [a["it"] for a in sweeps if a["step"] == 0]
    assert len(at0) >= 2 and len(set(at0)) == len(at0)
    assert [a["it"] for a in sweeps] == list(range(len(sweeps)))


def test_admission_read_is_kept_apart_from_admit(model, monkeypatch):
    """The read of an admitted request's first token waits for its
    chunks on the device: it lies outside every ``admit`` span."""
    reads = []
    real = ServeEngine.sample_checked

    def spy(self, logits):
        t0 = time.perf_counter()
        out = real(self, logits)
        reads.append((t0, time.perf_counter(), logits.shape[0]))
        return out

    monkeypatch.setattr(ServeEngine, "sample_checked", spy)
    with obs.enabled() as h:
        sched = _serve(model)
    admits = [e for e in h["tracer"].events if e["name"] == "admit"]
    firsts = [(a, b) for a, b, rows in reads if rows == 1]
    assert len(firsts) == len(sched.admissions) == 3
    for a, b in firsts:
        assert any(e["t1"] <= a for e in admits)
        assert any(e["t0"] >= b for e in admits)
        assert not any(e["t0"] < b and a < e["t1"] for e in admits)


def test_no_tracer_no_spans(model):
    sched = _serve(model)
    assert sched.tracer is None


# ---------------------------------------------------------------------------
# (c) the profiler mirror
# ---------------------------------------------------------------------------

def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return collections.Counter(e["name"] for e in events
                               if e.get("cat") == "user_annotation")


def test_profiler_mirrors_the_scheduler_track(model, tmp_path):
    """The profiler started and stopped inside ``on_step``, as the
    benchmark's serve driver does: every ``scheduler``-track span begun
    while it recorded is one range of its name."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    at = {}

    def on_step(sched, step):
        if step == 2:
            prof.start()
            at["t0"] = time.perf_counter()
        elif step == 5:
            at["t1"] = time.perf_counter()
            prof.stop()

    with obs.enabled() as h:
        _serve(model, on_step=on_step)
    want = collections.Counter(
        e["name"] for e in h["tracer"].events
        if e["track"] == "scheduler" and at["t0"] < e["t0"] < at["t1"])
    assert set(want) >= set(STEP_SPANS) | {"decode_step"}
    assert _annotations(prof, tmp_path) == want
    assert not any("range" in e for e in h["tracer"].events)


def test_no_tracer_no_ranges(model, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(model)
    assert _annotations(prof, tmp_path) == {}


def test_no_profiler_no_ranges(model):
    opened = []
    real = torch.autograd.profiler.record_function

    class Spy(real):
        def __enter__(self):
            opened.append(self.name)
            return super().__enter__()

    torch.autograd.profiler.record_function = Spy
    try:
        with obs.enabled():
            _serve(model)
    finally:
        torch.autograd.profiler.record_function = real
    assert opened == []


# ---------------------------------------------------------------------------
# (d) on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (graph replay and timing events)")
    return torch.device("cuda")


def _card_engine(cuda):
    model = _model(device=cuda, dtype="bfloat16", d_model=256, n_heads=4,
                   n_kv_heads=2, head_dim=64)
    return _engine(model, device=cuda)


@pytest.mark.requires_cuda
def test_replays_have_device_times_after_drain(cuda):
    step_graph.reset_program_stats()
    eng = _card_engine(cuda)
    _decode(eng, 9)
    assert eng._decode.replays == 8
    st = step_graph.program_stats("decode")
    assert st["calls"] == st["timed"] == len(st["device"]) == 8
    assert st["untimed"] == 0
    assert all(r["device_s"] > 0 for r in st["device"])
    assert st["device_s"] == pytest.approx(
        sum(r["device_s"] for r in st["device"]))
    host = {r["t"] for r in st["host"]}
    assert all(r["t"] in host for r in st["device"])


def _syncs_of_16_replays(eng, cache, cuda, device_inputs):
    """Where the synchronizing calls of 16 replays, each followed by the
    read of its tokens, were made (``file:line``), after three such steps
    and one more with the debug mode on, outside the count (what runs
    once in a process, or once the mode is on, runs there)."""
    tok = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    host = tok.cpu().numpy()

    def step(p):
        nonlocal tok, host
        if device_inputs:
            pos = torch.full((2,), p, dtype=torch.int32, device=cuda)
            logits, _ = eng.decode(tok, cache, pos)
        else:
            logits, _ = eng.decode(host, cache, np.full((2,), p, np.int32))
        tok = logits.argmax(dim=-1).to(torch.int32)
        host = tok.cpu().numpy()                    # the read

    with torch.inference_mode():
        for p in range(4, 7):
            step(p)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                torch.cuda.set_sync_debug_mode("warn")
                step(7)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for p in range(8, 24):
                    step(p)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


@pytest.mark.requires_cuda
def test_timing_adds_no_synchronizing_call(cuda):
    """16 replays with their tokens and positions on the device, each
    followed by the read of its tokens: exactly 16 synchronizing calls,
    the reads'.  The events are read when they have completed, at later
    calls, never waited for."""
    step_graph.reset_program_stats()
    eng = _card_engine(cuda)
    cache = _decode(eng, 4)                     # capture and warm replays
    where = _syncs_of_16_replays(eng, cache, cuda, device_inputs=True)
    assert len(where) == 16, where
    st = step_graph.program_stats("decode")
    assert st["calls"] == st["timed"] == 23 and st["untimed"] == 0


@pytest.mark.requires_cuda
def test_host_inputs_synchronize_only_in_the_reads_and_staging(cuda):
    """The same with host tokens and positions (the scheduler's path): a
    synchronizing call in ``serve/step_graph.py`` can only be the staging
    of the inputs, none in the counters."""
    step_graph.reset_program_stats()
    eng = _card_engine(cuda)
    cache = _decode(eng, 4)
    where = _syncs_of_16_replays(eng, cache, cuda, device_inputs=False)
    src, first = inspect.getsourcelines(step_graph.StepGraph._stage)
    staging = {f"step_graph.py:{first + i}" for i in range(len(src))}
    mine = [w for w in where if w.startswith("step_graph.py:")]
    assert set(mine) <= staging, where
    assert len(where) - len(mine) == 16, where
