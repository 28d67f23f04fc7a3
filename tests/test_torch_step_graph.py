"""The compiled decode programs: ``ServeEngine._decode``, ``_decode_sel``,
``_decode_window`` and ``_commit_window`` as ``serve/step_graph.py``
``StepGraph``\\ s.

(a) No step builds a tensor from a host value (what a CUDA graph capture
    refuses): each step function runs under a dispatch guard on the dense
    arena, the paged pool and the two-tier pool.
(b) Re-run invariance: each entry run twice over its own writes leaves
    the cache (and its outputs) bitwise equal to one run — what makes a
    warm-up before capture and the tiered fetch-and-rerun safe.
(c) The static-buffer wrapper: consecutive calls with other tokens and
    positions give what direct calls of ``tf.decode_step`` give, and the
    outputs are the program's own tensors, overwritten by the next call.
(d) Token-exact with the JAX engine and scheduler through the wrapped
    entries (dense and paged).
(e) On the card (``requires_cuda``): each entry's replay equals its eager
    step bitwise, logits and cache.  This file imports JAX only inside (d),
    so (e) runs on a machine without it:
    ``python -m pytest --noconftest -m requires_cuda
    tests/test_torch_step_graph.py``.
"""
import dataclasses
import os
import traceback

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config import SALSConfig, ServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import projectors_from_numpy
from repro_torch.core.latent_cache import LatentKVCache
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttf
from repro_torch.serve import Request, RequestScheduler, ServeEngine

torch.set_num_threads(1)

SALS_KW = dict(rank_ratio=0.5, score_ratio=0.5, n_critical=16, n_sink=2,
               n_recent=8, v_bits=8, v_group=32, skip_layers_front=1,
               skip_layers_back=1)
LAYOUTS = {"dense": {}, "paged": dict(page_size=16, n_pages=24),
           "tiered": dict(page_size=16, n_pages=24, hbm_pages=12)}
Q = 4
aten = torch.ops.aten


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

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


def _arena(model, layout, device="cpu", n_groups=1):
    """An engine of ``layout`` (selection layout ``n_groups``) with two
    admitted rows (prompts 37 and 22 tokens, more than n_sink + n_recent +
    N_c: the top-k selects), and the next step's host tokens and
    positions."""
    params, proj, cfg, sals = model
    eng = ServeEngine(params, proj, cfg, ServeConfig(
        max_seq_len=64, max_batch=2, prefill_chunk=8, sals=sals,
        **LAYOUTS[layout]), n_groups=n_groups, device=device)
    ps = eng.scfg.page_size
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (37, 22)]
    cache = eng.init_slot_cache()
    tokens = np.zeros(2, np.int32)
    positions = np.zeros(2, np.int32)
    if ps:
        mp = eng.scfg.max_seq_len // ps
        table = np.zeros((2, mp), np.int32)
        nxt = 1
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            logits, one = eng.prefill_one(p)
            if not ps:
                eng.admit(cache, one, i)
            else:
                # every page the row's prompt, next step and a window of Q
                # may write, mapped (hot) up front
                n = -(-(len(p) + Q) // ps)
                table[i, :n] = np.arange(nxt, nxt + n)
                nxt += n
                if eng.tiered:
                    eng.admit_tiered(cache, one, i, table[i, :n],
                                     table[i, :n], 0, len(p))
                else:
                    eng.admit_paged(cache, one, i, table[i, :n], 0, len(p))
            tokens[i] = int(logits.argmax())
            positions[i] = len(p)
        if ps:
            eng.with_page_tables(cache, table,
                                 table if eng.tiered else None)
    return eng, cache, tokens, positions


def _clone(cache):
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


def _tensors(tree):
    """(name, tensor) of a cache or an output tree, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield "", tree
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            for n, t in _tensors(v):
                yield f"{i}.{n}", t
    elif isinstance(tree, dict):
        for k in sorted(tree):
            for n, t in _tensors(tree[k]):
                yield f"{k}.{n}", t
    elif isinstance(tree, LatentKVCache):
        for f in dataclasses.fields(tree):
            t = getattr(tree, f.name)
            if isinstance(t, torch.Tensor):
                yield f.name, t


def _assert_same(a, b):
    ta, tb = list(_tensors(a)), list(_tensors(b))
    assert [n for n, _ in ta] == [n for n, _ in tb]
    for (name, x), (_, y) in zip(ta, tb):
        assert torch.equal(x, y), name


def _graphs(eng):
    """The engine's four step programs by entry name."""
    return {e: getattr(eng, f"_{e}") for e in
            ("decode", "decode_sel", "decode_window", "commit_window")}


def _window_tokens(tokens, cfg, seed=7):
    rng = np.random.default_rng(seed)
    wt = rng.integers(1, cfg.vocab_size, (len(tokens), Q)).astype(np.int32)
    wt[:, 0] = tokens
    return wt


# ---------------------------------------------------------------------------
# (a) no host-made tensors
# ---------------------------------------------------------------------------

class HostValueGuard(TorchDispatchMode):
    """Records every op that a CUDA stream capture refuses or that reads
    the device on the host: a tensor built from host data
    (``torch.tensor`` / ``torch.as_tensor`` on non-tensor data, and an
    index assignment of a Python scalar: ``aten.lift_fresh``), a host read
    (``.item()``, ``bool(t)``), and a shape that depends on values
    (``nonzero``, boolean-mask indexing, ``masked_select``, ``unique``)."""

    FLAGGED = {aten.lift_fresh.default, aten.lift_fresh_copy.default,
               aten._local_scalar_dense.default, aten.nonzero.default,
               aten.masked_select.default, aten._unique2.default,
               aten.unique_consecutive.default}
    INDEXING = {aten.index.Tensor, aten.index_put.default,
                aten.index_put_.default, aten._index_put_impl_.default}

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        bad = func in self.FLAGGED
        if func in self.INDEXING:
            bad = any(i is not None and i.dtype == torch.bool
                      for i in args[1])
        if bad:
            here = [f"{f.filename.split('src/')[-1]}:{f.lineno}"
                    for f in traceback.extract_stack()
                    if "repro_torch" in f.filename]
            self.hits.append((str(func), here[-1:]))
        return func(*args, **(kwargs or {}))


def _guarded(graph, guard):
    fn = graph.fn

    def run(*args):
        with guard:
            return fn(*args)

    graph.fn = run


def test_guard_flags_host_values():
    """The guard sees what it is meant to see."""
    guard = HostValueGuard()
    t = torch.zeros(4)
    with guard:
        torch.tensor(1.0)
        t[torch.arange(2)] = 1.0
        t[t > 0].sum().item()
        torch.where(t > 0, t, -1.0)             # a scalar operand: fine
        torch.full((2,), 3.0)
    assert [h[0] for h in guard.hits] == [
        "aten.lift_fresh.default", "aten.lift_fresh.default",
        "aten.index.Tensor", "aten._local_scalar_dense.default"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_steps_build_no_host_tensors(model, layout):
    _check_no_host_tensors(model, layout, 1)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_grouped_steps_build_no_host_tensors(model, layout):
    """The grouped fold (G 4: the per-slab queries and positions, the
    slab base, the folded tables) is made of device ops too."""
    _check_no_host_tensors(model, layout, 4)


def _check_no_host_tensors(model, layout, n_groups):
    eng, cache, tokens, positions = _arena(model, layout, n_groups=n_groups)
    guard = HostValueGuard()
    for g in _graphs(eng).values():
        _guarded(g, guard)
    cfg = model[2]
    with torch.inference_mode():
        if eng.paged:
            eng.decode_sel(tokens, cache, positions)
        if not eng.tiered:      # a verify window needs the untiered cache
            _, aux = eng.decode_window(_window_tokens(tokens, cfg), cache,
                                       positions)
            eng.commit_window(cache, aux, positions, np.array([2, 1]))
            positions = positions + np.array([2, 1])
        eng.decode(tokens, cache, positions)
    assert guard.hits == []
    calls = {k: g.calls for k, g in _graphs(eng).items()}
    assert calls == {"decode": 1, "decode_sel": int(eng.paged),
                     "decode_window": int(not eng.tiered),
                     "commit_window": int(not eng.tiered)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_grouped_scheduler_keeps_one_decode_key(model, layout):
    """A scheduler run at G 2 keys its decode program once: the fold's
    views and per-slab operands leave the arena's addresses alone."""
    params, proj, cfg, sals = model
    eng = ServeEngine(params, proj, cfg, ServeConfig(
        max_seq_len=64, max_batch=2, prefill_chunk=8, sals=sals,
        **LAYOUTS[layout]), n_groups=2, device="cpu")
    entry = eng._decode_sel if eng.tiered else eng._decode
    keys, first = [], entry._first

    def spy_first(args, key):       # a new capture key (the card captures)
        keys.append(key)
        first(args, key)

    entry._first = spy_first
    rng = np.random.default_rng(11)
    sched = RequestScheduler(eng)
    reqs = [Request(rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=6) for n in (37, 22, 30)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert all(r.done for r in reqs) and sched.steps > 6
    assert len(keys) == 1


def test_launch_counts_add_and_take_back():
    """What a replay adds and a capture takes back (``ops``)."""
    ops.reset_launch_counts()
    ops.add_launch_counts({"latent_topk": 29, "sparse_recon_attention": 29})
    ops.add_launch_counts({"latent_topk": 29, "sparse_recon_attention": 29})
    ops.add_launch_counts({"latent_topk": -29})
    counts = ops.launch_counts()
    assert counts["latent_topk"] == 29
    assert counts["sparse_recon_attention"] == 58
    assert sum(counts.values()) == 87
    ops.reset_launch_counts()


# ---------------------------------------------------------------------------
# (b) re-run invariance
# ---------------------------------------------------------------------------

ENTRIES = [("dense", "decode"), ("dense", "decode_window"),
           ("dense", "commit_window"), ("paged", "decode"),
           ("paged", "decode_sel"), ("paged", "decode_window"),
           ("paged", "commit_window"), ("tiered", "decode_sel")]


def _run_entry(eng, entry, cache, tokens, positions, times):
    """``entry`` ``times`` times over ``cache``; returns clones of the last
    call's outputs."""
    cfg = eng.cfg
    out = None
    if entry == "commit_window":
        _, aux = eng.decode_window(_window_tokens(tokens, cfg), cache,
                                   positions)
    for _ in range(times):
        if entry == "decode":
            out = eng.decode(tokens, cache, positions)[0]
        elif entry == "decode_sel":
            logits, _, union = eng.decode_sel(tokens, cache, positions)
            out = (logits, union)
        elif entry == "decode_window":
            out = eng.decode_window(_window_tokens(tokens, cfg), cache,
                                    positions)
        else:
            eng.commit_window(cache, aux, positions, np.array([3, 1]))
        out = [t.clone() for _, t in _tensors(out)]
    return out


@pytest.mark.parametrize("layout,entry", ENTRIES)
def test_rerun_equals_one_run(model, layout, entry):
    eng, cache, tokens, positions = _arena(model, layout)
    once, twice = _clone(cache), _clone(cache)
    with torch.inference_mode():
        a = _run_entry(eng, entry, once, tokens, positions, 1)
        b = _run_entry(eng, entry, twice, tokens, positions, 2)
    _assert_same(a, b)
    _assert_same(once, twice)
    if entry != "decode_window":      # the window only reads SALS caches
        assert any(not torch.equal(x, y) for (_, x), (_, y)
                   in zip(_tensors(once), _tensors(cache)))


# ---------------------------------------------------------------------------
# (c) the static-buffer wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_consecutive_calls_equal_direct_steps(model, layout):
    """Two steps through ``ServeEngine.decode`` (host arrays, then device
    tensors) against two direct ``tf.decode_step`` calls on a clone."""
    eng, cache, tokens, positions = _arena(model, layout)
    params, proj, cfg, sals = model
    direct = _clone(cache)
    steps = [(tokens, positions),
             (np.array([5, 9], np.int32), positions + 1)]
    with torch.inference_mode():
        got, snaps = [], []
        for i, (tok, pos) in enumerate(steps):
            if i:       # the second step from tensors on the device
                tok, pos = torch.from_numpy(tok), torch.from_numpy(pos)
            logits, _ = eng.decode(tok, cache, pos)
            got.append(logits)
            snaps.append(logits.clone())
        want = [ttf.decode_step(params, proj, direct, torch.from_numpy(t),
                                torch.from_numpy(p), cfg, sals)[0]
                for t, p in steps]
    # the outputs are the program's: the second call overwrote the first's
    assert got[0] is got[1]
    for snap, w in zip(snaps, want):
        assert torch.equal(snap, w)
    assert not torch.equal(want[0], want[1])
    _assert_same(cache, direct)
    tok_buf = eng._decode._bufs[0]
    assert tok_buf.dtype == torch.int32 and tok_buf.tolist() == [5, 9]


def test_window_outputs_alias_and_commit_reads_them(model):
    """A window's aux is the program's output: a second window overwrites
    it, and the commit of the second window equals the direct commit."""
    eng, cache, tokens, positions = _arena(model, "paged")
    params, proj, cfg, sals = model
    direct = _clone(cache)
    wt0, wt1 = _window_tokens(tokens, cfg, 1), _window_tokens(tokens, cfg, 2)
    n = np.array([2, 3], np.int32)
    with torch.inference_mode():
        l0, aux0 = eng.decode_window(wt0, cache, positions)
        l1, aux1 = eng.decode_window(wt1, cache, positions)
        eng.commit_window(cache, aux1, positions, n)
        wl, waux = ttf.decode_window(params, proj, direct,
                                     torch.from_numpy(wt1),
                                     torch.from_numpy(positions), cfg, sals)
        ttf.commit_window(proj, direct, waux, torch.from_numpy(positions),
                          torch.from_numpy(n), cfg, sals)
    assert l0 is l1 and aux0 is aux1
    assert torch.equal(l1, wl)
    _assert_same(cache, direct)


# ---------------------------------------------------------------------------
# (d) token-exact with the JAX engine and scheduler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_model():
    import jax
    import jax.numpy as jnp
    from repro.config import SALSConfig as JSALS
    from repro.configs import get_config as jax_get_config
    from repro.core import calibration as jcal
    from repro.models import transformer as jtf
    from repro_torch.convert import params_from_numpy

    over = dict(dtype="float32", n_layers=4, vocab_size=128)
    jcfg = jax_get_config("yi-9b").reduced(**over)
    cfg = get_config("yi-9b").reduced(**over)
    jsals, sals = JSALS(**SALS_KW), SALSConfig(**SALS_KW)
    jp = jtf.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    ju = jcal.random_layer_projectors(jax.random.PRNGKey(2), jcfg, jsals,
                                      jcfg.n_layers)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tu = projectors_from_numpy({"u": np.asarray(ju["u"])}, device="cpu")
    return dict(j=(jp, ju, jcfg, jsals), t=(tp, tu, cfg, sals))


def test_generate_twice_token_exact_with_reference(jax_model):
    """Two ``generate`` calls on one engine (a new cache each: the step
    program is keyed anew) against the JAX engine."""
    from repro.config import ServeConfig as JServe
    from repro.serve import ServeEngine as JEngine
    jp, ju, jcfg, jsals = jax_model["j"]
    tp, tu, cfg, sals = jax_model["t"]
    jeng = JEngine(jp, ju, jcfg, JServe(max_seq_len=64, sals=jsals))
    teng = ServeEngine(tp, tu, cfg, ServeConfig(max_seq_len=64, sals=sals),
                       device="cpu")
    rng = np.random.default_rng(8)
    for lens in ((37, 22, 6), (30, 41)):
        prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                   for n in lens]
        jres = jeng.generate(prompts, max_new_tokens=10)
        tres = teng.generate(prompts, max_new_tokens=10)
        for a, b in zip(jres, tres):
            np.testing.assert_array_equal(a.tokens, b.tokens)
    assert teng._decode.calls == 2 * 9
    assert teng.last_timing["capture_s"] == 0.0     # no capture on the CPU


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_scheduler_token_exact_with_reference(jax_model, layout):
    from repro.config import ServeConfig as JServe
    from repro.serve import Request as JRequest
    from repro.serve import RequestScheduler as JScheduler
    from repro.serve import ServeEngine as JEngine
    jp, ju, jcfg, jsals = jax_model["j"]
    tp, tu, cfg, sals = jax_model["t"]
    skw = dict(max_seq_len=128, max_batch=3, prefill_chunk=16,
               page_size=16 if layout == "paged" else 0)
    rng = np.random.default_rng(9)
    head = rng.integers(1, cfg.vocab_size, 32).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(1, cfg.vocab_size, k)
                               .astype(np.int32)]) for k in (5, 20)] \
        + [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
           for n in (6, 30)]
    jeng = JEngine(jp, ju, jcfg, JServe(sals=jsals, **skw))
    teng = ServeEngine(tp, tu, cfg, ServeConfig(sals=sals, **skw),
                       device="cpu")
    toks = []
    for eng, sched_cls, req_cls in ((jeng, JScheduler, JRequest),
                                    (teng, RequestScheduler, Request)):
        sched = sched_cls(eng)
        reqs = [req_cls(p, max_new_tokens=8, req_id=i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        sched.run()
        toks.append([r.result.tokens for r in reqs])
    for a, b in zip(*toks):
        np.testing.assert_array_equal(a, b)
    assert teng._decode.calls == sched.steps > 0
    assert teng._decode._key is not None


# ---------------------------------------------------------------------------
# (e) on the card: replay == eager, bitwise
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (graph capture and replay)")
    return torch.device("cuda")


def _eager(eng, entry, cache, tokens, positions, aux=None, n=None):
    """The transformer's step functions on device tensors, op by op."""
    params, proj, cfg, sals = eng.params, eng.projectors, eng.cfg, eng.sals
    dev = eng.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    if entry == "decode":
        return ttf.decode_step(params, proj, cache, t(tokens), t(positions),
                               cfg, sals)[0]
    if entry == "decode_sel":
        return eng._decode_sel_impl(t(tokens), cache, t(positions))
    if entry == "decode_window":
        return ttf.decode_window(params, proj, cache, t(tokens),
                                 t(positions), cfg, sals)
    ttf.commit_window(proj, cache, aux, t(positions), t(n), cfg, sals)
    return None


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout,entry", ENTRIES)
def test_replay_equals_eager_on_card(cuda, layout, entry):
    """Three calls of the entry's program (the capture call, then two
    replays, each a new step) against its step function called directly,
    op by op, on a clone: outputs and cache bitwise equal after each, and
    the launch counters equal too."""
    _replay_vs_eager(cuda, layout, entry, 1)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout,entry", ENTRIES)
def test_grouped_replay_equals_eager_on_card(cuda, layout, entry):
    """As above in the grouped layout (G 4)."""
    _replay_vs_eager(cuda, layout, entry, 4)


def _replay_vs_eager(cuda, layout, entry, n_groups):
    model = _model(device=cuda, dtype="bfloat16", d_model=256, n_heads=4,
                   n_kv_heads=2, head_dim=64)
    eng, cache, tokens, positions = _arena(model, layout, device=cuda,
                                           n_groups=n_groups)
    eager = _clone(cache)
    graph, impl = _graphs(eng)[entry], getattr(eng, f"_{entry}_impl")
    n = np.array([2, 1], np.int32)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=cuda)

    with torch.inference_mode():
        for step in range(3):
            pos = positions + step
            tok = (tokens + step) % eng.cfg.vocab_size
            wt = _window_tokens(tok, eng.cfg, step)
            if entry == "commit_window":
                _, aux = eng._decode_window(wt, cache, pos)
                _, eaux = eng._decode_window_impl(dev(wt), eager, dev(pos))
                args, eargs = (cache, aux, pos, n), (eager, eaux, dev(pos),
                                                     dev(n))
            else:
                x = wt if entry == "decode_window" else tok
                args, eargs = (x, cache, pos), (dev(x), eager, dev(pos))
            ops.reset_launch_counts()
            got = graph(*args)
            counts = ops.launch_counts()
            ops.reset_launch_counts()
            want = impl(*eargs)
            torch.cuda.synchronize()
            assert counts == ops.launch_counts(), step
            _assert_same(got, want)
            _assert_same(cache, eager)
    assert graph.captures == 1 and graph.replays == 2 and graph.nodes > 0
