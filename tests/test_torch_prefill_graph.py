"""The compiled chunked-prefill program: ``ServeEngine._prefill_chunk``, a
``serve/step_graph.py`` ``StepGraph`` over the engine's prefill workspace,
with the chunk offset on the device (the reference's ``jax.jit`` of
``_prefill_chunk_impl`` with its traced offset).

(a) No host value in the chunk program: ``tf.prefill_chunk`` runs under
    the dispatch guard of ``test_torch_step_graph.py`` for a dense, a
    paged, a two-tier engine and a task resumed from a prefix entry.
(b) A tensor offset gives bitwise what an int offset gives, and the
    guard sees no host read of it outside inference mode either.
(c) The workspace is reset in place: a request prefilled after a longer
    one gives, bitwise, the state of the same request on a fresh engine
    (also resumed from a prefix entry); a reset equals ``tf.init_cache``.
(d) A scheduler run keys the chunk program once; its prefix entries keep
    their own copies, unchanged by later prefills, and every read of a
    finished task's workspace (admission, cold mirrors) comes before the
    next ``start_prefill``.
(e) ``prefill_one``'s logits are the caller's; a task's are the program's.
(f) Replayed chunks equal eager chunks bitwise (logits, cache, scratch):
    dense, resumed, and with a decode replay between two chunks, on the
    CPU and on the card (``requires_cuda``).  This file imports no JAX:
    ``python -m pytest --noconftest -m requires_cuda
    tests/test_torch_prefill_graph.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.config import ServeConfig
from repro_torch.models import transformer as ttf
from repro_torch.serve import Request, RequestScheduler, ServeEngine
from test_torch_step_graph import (LAYOUTS, HostValueGuard, _assert_same,
                                   _clone, _guarded, _model, _tensors)

torch.set_num_threads(1)

CHUNK = 8


@pytest.fixture(scope="module")
def model():
    return _model()


def _engine(model, layout, device="cpu", **kw):
    params, proj, cfg, sals = model
    skw = dict(max_seq_len=64, max_batch=2, prefill_chunk=CHUNK, sals=sals)
    skw.update(LAYOUTS[layout], **kw)
    return ServeEngine(params, proj, cfg, ServeConfig(**skw), device=device)


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, n).astype(np.int32)


def _drain(eng, prompt, resume=None):
    task = eng.start_prefill(prompt, resume=resume)
    while not task.done:
        eng.prefill_chunk_step(task)
    return task


def _entry(eng, prompt):
    """A prefix-cache entry of ``prompt`` as the scheduler registers one
    (paged engine): the finished task's state copied, its boundary
    rings."""
    task = _drain(eng, prompt)
    cache, scratch = eng.prefill_state_copy(task)
    return SimpleNamespace(cache=cache, scratch=scratch,
                           boundary_rings=dict(task.boundary_rings))


def _resumed_prompt(cfg, head):
    """A prompt sharing ``head``'s first two 16-token pages."""
    return np.concatenate([head[:32], _prompt(cfg, 18, 2)])


# ---------------------------------------------------------------------------
# (a) no host-made tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("setup", ["dense", "paged", "tiered", "resumed"])
def test_chunk_program_builds_no_host_tensors(model, setup):
    cfg = model[2]
    eng = _engine(model, "paged" if setup == "resumed" else setup)
    with torch.inference_mode():
        resume, prompt = None, _prompt(cfg, 37, 1)
        if setup == "resumed":
            head = _prompt(cfg, 45, 1)
            resume, prompt = (_entry(eng, head), 2), \
                _resumed_prompt(cfg, head)
        guard = HostValueGuard()
        _guarded(eng._prefill_chunk, guard)
        calls = eng._prefill_chunk.calls
        task = _drain(eng, prompt, resume)
    assert guard.hits == []
    assert eng._prefill_chunk.calls - calls == task.n_chunks \
        - task.start_chunk > 0
    assert task.start_chunk == (4 if resume else 0)


# ---------------------------------------------------------------------------
# (b) tensor offset == int offset
# ---------------------------------------------------------------------------

def test_tensor_offset_equals_int_offset(model):
    """A ragged batch of two through every chunk, the offset a Python int
    and a 0-d int32 tensor: logits, cache and scratch bitwise equal.  The
    tensor form runs under the guard OUTSIDE inference mode, where the
    guard also sees a tensor read on the host as a Python index (a slice
    bound), which inference mode hides from it."""
    params, proj, cfg, sals = model
    lens = np.array([37, 22], np.int32)
    toks = np.zeros((2, 40), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = _prompt(cfg, n, 10 + i)
    len_t, state, guard = torch.from_numpy(lens), {}, HostValueGuard()
    for form in ("int", "tensor"):
        cache = ttf.init_cache(cfg, sals, 2, 64, device="cpu")
        scratch = ttf.init_prefill_scratch(cfg, sals, 2, 64, device="cpu")
        logits = []
        for j in range(toks.shape[1] // CHUNK):
            chunk = torch.from_numpy(toks[:, j * CHUNK:(j + 1) * CHUNK])
            if form == "int":
                lg, cache, scratch = ttf.prefill_chunk(
                    params, proj, cfg, sals, cache, scratch,
                    {"tokens": chunk}, j * CHUNK, len_t)
            else:
                off = torch.tensor(j * CHUNK, dtype=torch.int32)
                with guard:
                    lg, cache, scratch = ttf.prefill_chunk(
                        params, proj, cfg, sals, cache, scratch,
                        {"tokens": chunk}, off, len_t)
            logits.append(lg)
        state[form] = (logits, cache, scratch)
    assert guard.hits == []
    _assert_same(state["int"], state["tensor"])


# ---------------------------------------------------------------------------
# (c) the reused workspace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resumed", [False, True])
def test_reused_workspace_equals_fresh_engine(model, resumed):
    cfg = model[2]
    layout = "paged" if resumed else "dense"
    reused, fresh = _engine(model, layout), _engine(model, layout)
    prompt, resume = _prompt(cfg, 29, 4), None
    with torch.inference_mode():
        if resumed:
            head = _prompt(cfg, 45, 1)
            resume, prompt = (_entry(reused, head), 2), \
                _resumed_prompt(cfg, head)
        _drain(reused, _prompt(cfg, 61, 3))      # longer: every chunk
        if not resumed:
            # the reset: exactly a new single-slot cache and scratch
            task = reused.start_prefill(prompt)
            _assert_same(
                (task.cache, task.scratch),
                (ttf.init_cache(cfg, model[3], 1, 64, device="cpu"),
                 ttf.init_prefill_scratch(cfg, model[3], 1, 64,
                                          device="cpu")))
        a, b = _drain(reused, prompt, resume), _drain(fresh, prompt, resume)
    _assert_same((a.logits, a.cache, a.scratch),
                 (b.logits, b.cache, b.scratch))
    assert a.cache is reused._workspace[0]


# ---------------------------------------------------------------------------
# (d) a scheduler run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["paged", "tiered"])
def test_scheduler_keys_chunk_program_once(model, layout):
    """Four requests of four lengths (two share a 32-token head: a prefix
    hit) through one engine: the chunk program is keyed once, each prefix
    entry's state is its own and unchanged by the prefills after it, and
    every admission and cold mirror reads the task that just finished."""
    cfg = model[2]
    eng = _engine(model, layout, max_seq_len=128, max_batch=3)
    head = _prompt(cfg, 32, 9)
    prompts = [np.concatenate([head, _prompt(cfg, k, 20 + k)])
               for k in (5, 20)] + [_prompt(cfg, n, 30 + n) for n in (6, 30)]
    graph = eng._prefill_chunk
    keyed, last, reads, snaps = [], [None], [0], []
    first, start = graph._first, eng.start_prefill

    def spy_first(args, key):
        keyed.append(key)
        return first(args, key)

    def spy_start(prompt, resume=None):
        last[0] = start(prompt, resume=resume)
        return last[0]

    def reader(fn):
        def read(*args):
            # the workspace of the task that just finished: no
            # start_prefill came between its last chunk and this read
            task = last[0]
            assert task.done and any(a is task.cache for a in args)
            reads[0] += 1
            return fn(*args)
        return read

    graph._first, eng.start_prefill = spy_first, spy_start
    for name in ("admit", "admit_paged", "admit_tiered",
                 "extract_page_payload_dense"):
        setattr(eng, name, reader(getattr(eng, name)))
    sched = RequestScheduler(eng)
    insert = sched.prefix_index.insert

    def spy_insert(*args):
        entry = insert(*args)
        if entry is not None:
            snaps.append((entry, _clone(entry.cache), _clone(entry.scratch)))
        return entry

    sched.prefix_index.insert = spy_insert
    reqs = [Request(p, max_new_tokens=6, req_id=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert all(r.done for r in reqs) and sched.prefix_hits >= 1
    assert len(keyed) == 1 and graph.calls == len(sched.prefill_chunks)
    assert reads[0] >= len(prompts)
    assert len(snaps) >= 2
    ws = {t.data_ptr() for _, t in _tensors(eng._workspace)}
    for entry, cache, scratch in snaps:
        _assert_same((entry.cache, entry.scratch), (cache, scratch))
        assert ws.isdisjoint(t.data_ptr() for _, t in
                             _tensors((entry.cache, entry.scratch)))


# ---------------------------------------------------------------------------
# (e) logits
# ---------------------------------------------------------------------------

def test_prefill_one_logits_survive_next_chunk(model):
    cfg = model[2]
    eng = _engine(model, "dense")
    with torch.inference_mode():
        la, _ = eng.prefill_one(_prompt(cfg, 29, 5))
        snap = la.clone()
        task = _drain(eng, _prompt(cfg, 21, 6))
    assert task.logits is eng._prefill_chunk._out      # the program's
    assert torch.equal(la, snap) and not torch.equal(la, task.logits)


# ---------------------------------------------------------------------------
# (f) replayed chunk == eager chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.requires_cuda)])
@pytest.mark.parametrize("setup", ["dense", "resumed", "decode_between"])
def test_replayed_chunks_equal_eager(device, setup):
    """Every chunk of a prompt through ``prefill_chunk_step`` against
    ``_prefill_chunk_impl`` called directly on a clone of the workspace
    taken before it: logits, cache and scratch bitwise equal.
    ``decode_between``: a decode step of the slot arena (replayed, held
    to the eager step on a clone of the arena) after every chunk."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (graph capture and replay)")
    dev = torch.device(device)
    model = _model() if device == "cpu" else _model(
        device=dev, dtype="bfloat16", d_model=256, n_heads=4, n_kv_heads=2,
        head_dim=64)
    cfg = model[2]
    eng = _engine(model, "paged" if setup == "resumed" else "dense",
                  device=dev)
    graph = eng._prefill_chunk

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    with torch.inference_mode():
        resume, prompt = None, _prompt(cfg, 61, 7)
        if setup == "resumed":
            head = _prompt(cfg, 45, 1)
            resume, prompt = (_entry(eng, head), 2), \
                _resumed_prompt(cfg, head)
        if setup == "decode_between":
            arena = eng.init_slot_cache()
            first, one = eng.prefill_one(_prompt(cfg, 37, 8))
            eng.admit(arena, one, 0)
            tokens = np.array([int(first.argmax()), 0], np.int32)
            positions = np.array([37, 0], np.int32)
        task = eng.start_prefill(prompt, resume=resume)
        while not task.done:
            j = task.next_chunk
            twin = _clone(task.cache), _clone(task.scratch)
            want = eng._prefill_chunk_impl(
                t(task.tokens[:, j * CHUNK:(j + 1) * CHUNK]),
                t(j * CHUNK), t([task.prompt_len]), *twin)
            eng.prefill_chunk_step(task)
            _assert_same((task.logits, task.cache, task.scratch),
                         (want, *twin))
            if setup == "decode_between":
                twin = _clone(arena)
                want = ttf.decode_step(eng.params, eng.projectors, twin,
                                       t(tokens), t(positions), cfg,
                                       eng.sals)[0]
                logits, _ = eng.decode(tokens, arena, positions)
                _assert_same((logits, arena), (want, twin))
                tokens = logits.argmax(-1).to(torch.int32).cpu().numpy()
                positions = positions + 1
    n_chunks = task.n_chunks - task.start_chunk
    assert graph.calls == n_chunks + (
        {"resumed": 6, "decode_between": 5}.get(setup, 0))
    if device == "cuda":
        assert graph.captures == 1 and graph.nodes > 0
        assert graph.replays == graph.calls - 1
