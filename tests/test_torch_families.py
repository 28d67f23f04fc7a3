"""Port parity for the moe, hybrid and ssm families (llama4-scout,
qwen3-moe, hymba, rwkv6) against the JAX reference on the same seeded
weights, at ``reduced(dtype="float32")``:

* the registry: all twelve configs (hubert's too) equal the reference's
  field for field, full and reduced, ``all_configs`` has its keys, and
  ``param_count`` / ``active_param_count`` are its numbers; the
  reference's range checks (``tests/test_archs.py``) on the port's
  configs;
* ``prefill`` then ``decode_step`` s (two with SALS on, where the
  latent cache grows, one with it off), SALS off and on (one SALS
  layer): logits within rtol = atol = 1e-4, the engine tests' tolerance —
  a ragged batch for the moe family, a uniform one for the recurrent
  families — and a moe case at capacity factor 1.0 that drops tokens;
* ``ServeEngine.generate`` token-exact with the JAX engine (the recurrent
  families' uniform-length layout: left-filled with the first real
  token), every step's logits within 1e-4 (a recurrent family's
  left-filled rows: tokens only, see the test), and one decode capture
  key per ``generate`` (the recurrent state changes in place);
* ``RequestScheduler``: the moe family dense and paged token-exact with
  the JAX scheduler; its speculative decode equal to the sequential
  scheduler; the recurrent families fall back to static batching with
  the JAX scheduler's tokens;
* every ``ValueError`` the reference raises for a recurrent family (a
  paged cache, chunked prefill, a verify window, speculative decoding,
  an SSD chunk the prompt does not fill), raised here for the same
  reason; the encoder family's serving engine and decode cache refuse
  it as the reference's do;
* the serving CLI on the CPU for hymba (static) and qwen3-moe (paged)."""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SALSConfig as JSALS
from repro.config import ServeConfig as JServe
from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.core import calibration as jcal
from repro.models import transformer as jtf
from repro.serve import Request as JRequest
from repro.serve import RequestScheduler as JScheduler
from repro.serve import ServeEngine as JEngine
from repro_torch.config import SALSConfig, ServeConfig
from repro_torch.configs import (ASSIGNED_ARCHS, PAPER_ARCHS, all_configs,
                                 get_config)
from repro_torch.convert import params_from_numpy, projectors_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as ttf
from repro_torch.serve import Request, RequestScheduler, ServeEngine

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
SALS_KW = dict(n_critical=10, n_sink=2, n_recent=8, v_group=16,
               skip_layers_front=1, skip_layers_back=1)
FAMILIES = ["llama4-scout-17b-a16e", "qwen3-moe-235b-a22b", "hymba-1.5b",
            "rwkv6-7b"]
MAX_SEQ = 64
_MODELS = {}
# the reference's entry points, compiled once per shape
_jinit = jax.jit(jtf.init_params, static_argnums=(1, 2))


def _model(arch, **over):
    """(jax side, port side) at reduced f32 from one seed, cached: each is
    (params, projectors or None, cfg, sals or None)."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        jcfg = jax_get_config(arch).reduced(dtype="float32", **over)
        cfg = get_config(arch).reduced(dtype="float32", **over)
        jp = _jinit(jax.random.PRNGKey(1), jcfg, jnp.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
        js = ts = ju = tu = None
        if cfg.has_attention:
            js, ts = JSALS(**SALS_KW), SALSConfig(**SALS_KW)
            ju = jcal.random_layer_projectors(jax.random.PRNGKey(2), jcfg,
                                              js, jcfg.n_layers)
            tu = projectors_from_numpy({"u": np.asarray(ju["u"])},
                                       device="cpu")
        _MODELS[key] = ((jp, ju, jcfg, js), (tp, tu, cfg, ts))
    return _MODELS[key]


def _prompts(vocab, lens=(37, 22, 6), seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_all_configs_equal_reference():
    """Every config of the reference, hubert's included, field for field,
    full and reduced; ``all_configs`` has the reference's keys."""
    mine, ref = all_configs(), jax_all_configs()
    assert list(mine) == list(ref) == ASSIGNED_ARCHS + PAPER_ARCHS
    for arch, cfg in mine.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref[arch])
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(ref[arch].reduced())
    # module names resolve to the canonical configs
    assert get_config("hymba_1p5b") == get_config("hymba-1.5b")
    assert get_config("rwkv6_7b") == get_config("rwkv6-7b")


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + PAPER_ARCHS)
def test_param_counts_equal_reference(arch):
    cfg, ref = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cfg.expert_d_ff == ref.expert_d_ff


def test_configs_well_formed_and_in_range():
    """The reference's range checks (``tests/test_archs.py``) on the port's
    own configs."""
    for name, cfg in all_configs().items():
        assert cfg.n_heads % max(cfg.n_kv_heads, 1) == 0, name
        assert cfg.param_count() > 0
        assert cfg.active_param_count() <= cfg.param_count()
        if cfg.family == "moe":
            assert cfg.active_param_count() < cfg.param_count()
    expect = {
        "yi-9b": (8e9, 10e9), "qwen2-1.5b": (1.2e9, 2.0e9),
        "gemma-2b": (2.0e9, 3.2e9), "granite-3-8b": (7e9, 10e9),
        "rwkv6-7b": (6e9, 9e9), "qwen3-moe-235b-a22b": (200e9, 260e9),
        "llama4-scout-17b-a16e": (90e9, 120e9),
        "hubert-xlarge": (0.8e9, 1.3e9), "hymba-1.5b": (1.2e9, 2.2e9),
        "paligemma-3b": (2.0e9, 3.5e9),
    }
    for arch, (lo, hi) in expect.items():
        n = get_config(arch).param_count()
        assert lo <= n <= hi, f"{arch}: {n:.2e} not in [{lo:.0e},{hi:.0e}]"
    active = get_config("qwen3-moe-235b-a22b").active_param_count()
    assert 15e9 <= active <= 30e9, f"{active:.2e}"


def test_f32_leaves_stay_f32_in_a_bf16_model():
    """In a bf16 model the leaves the reference's initializer makes f32
    stay f32 — through ``init_params`` and through ``params_from_numpy``
    of f32 arrays into a bf16 model — and the others are bf16."""
    for arch in FAMILIES:
        jcfg = jax_get_config(arch).reduced()
        ref = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                     jcfg))["blocks"]
        cfg = get_config(arch).reduced()
        (jp, _, _, _), _ = _model(arch)             # f32 arrays
        conv = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu", dtype="bfloat16")
        mine = ttf.init_params(cfg, device="cpu")
        for tree in (conv, mine):
            for name, p in tree.blocks[0].named_parameters():
                leaf = ref
                for part in name.split("."):
                    leaf = leaf[part]
                want = torch.float32 if leaf.dtype == jnp.float32 \
                    else torch.bfloat16
                assert p.dtype == want, (arch, name, p.dtype)


# ---------------------------------------------------------------------------
# Prefill / decode logits
# ---------------------------------------------------------------------------

CASES = [(a, s) for a in FAMILIES for s in (False, True)
         if not (a == "rwkv6-7b" and s)] + [("qwen3-moe-235b-a22b-cf1", True)]


@pytest.mark.parametrize("arch,sals_on", CASES,
                         ids=[f"{a}-{'sals' if s else 'full'}"
                              for a, s in CASES])
def test_prefill_and_decode_match_reference(arch, sals_on):
    """Prefill, then decode steps of the greedy tokens: logits within
    1e-4 of the reference's.  The moe family takes a ragged batch (per-row
    lengths); the recurrent families a uniform one.  ``-cf1``: capacity
    factor 1.0 (qwen3's own is 1.25), so the 40-token prompt drops tokens
    past capacity in prefill."""
    over = {}
    if arch.endswith("-cf1"):
        arch, over = arch[:-4], dict(moe_capacity_factor=1.0)
    (jp, ju, jcfg, js), (tp, tu, cfg, ts) = _model(arch, **over)
    if not sals_on:
        ju = tu = js = ts = None
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, (3, 40)).astype(np.int32)
    lens = np.array([40, 25, 7], np.int32) if cfg.family == "moe" else None
    # compiled as the JAX engine compiles them: weights closed over
    jprefill = jax.jit(lambda t, n: jtf.prefill(
        jp, ju, jcfg, js, {"tokens": t}, MAX_SEQ, lengths=n))
    jdecode = jax.jit(lambda c, t, p: jtf.decode_step(jp, ju, c, t, p, jcfg,
                                                       js))
    jl, jc = jprefill(jnp.asarray(toks),
                      None if lens is None else jnp.asarray(lens))
    with torch.inference_mode():
        tl, tc = ttf.prefill(tp, tu, cfg, ts, {"tokens": torch.from_numpy(
            toks)}, MAX_SEQ, lengths=None if lens is None
            else torch.from_numpy(lens))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), **TOL)
    pos = np.full((3,), 40, np.int32) if lens is None else lens.copy()
    for _ in range(2 if sals_on else 1):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jdecode(jc, jnp.asarray(nxt), jnp.asarray(pos))
        with torch.inference_mode():
            tl, tc = ttf.decode_step(tp, tu, tc, torch.from_numpy(nxt),
                                     torch.from_numpy(pos), cfg, ts)
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), **TOL)
        pos += 1
    assert np.isfinite(tl.numpy()).all()


# ---------------------------------------------------------------------------
# ServeEngine.generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_token_exact_one_capture(arch):
    """``generate`` (SALS on where the family has attention) gives the JAX
    engine's tokens, every step's logits within 1e-4, and the decode step
    program keeps one key for the whole call: the caches, recurrent state
    included, are written in place."""
    (jp, ju, jcfg, js), (tp, tu, cfg, ts) = _model(arch)
    prompts = _prompts(cfg.vocab_size)
    jeng = JEngine(jp, ju, jcfg, JServe(
        max_seq_len=MAX_SEQ, sals=js or JSALS(enabled=False)))
    teng = ServeEngine(tp, tu, cfg, ServeConfig(
        max_seq_len=MAX_SEQ, sals=ts or SALSConfig(enabled=False)),
        device="cpu")
    jlog, tlog, keys = [], [], []
    jdecode, tdecode, first = jeng._decode, teng.decode, \
        teng._decode._first

    def jspy(tokens, cache, pos):
        logits, cache = jdecode(tokens, cache, pos)
        jlog.append(np.asarray(logits))
        return logits, cache

    def tspy(tokens, cache, pos):
        logits, cache = tdecode(tokens, cache, pos)
        tlog.append(logits.numpy().copy())
        return logits, cache

    def spy_first(args, key):
        keys.append(key)
        first(args, key)

    jeng._decode, teng.decode, teng._decode._first = jspy, tspy, spy_first
    jres = jeng.generate(prompts, max_new_tokens=8)
    tres = teng.generate(prompts, max_new_tokens=8)
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert len(b.tokens) == 8
    assert len(jlog) == len(tlog) == 7
    # a recurrent family's short prompt is left-filled with copies of one
    # token, whose near-equal latent scores the two packages may rank
    # apart in the last f32 bit: its logits then move by ~1e-2 while the
    # greedy tokens stay equal.  Logits are held for the unfilled rows.
    rows = [i for i, p in enumerate(prompts)
            if teng.ragged_ok or len(p) == max(map(len, prompts))]
    for a, b in zip(jlog, tlog):
        np.testing.assert_allclose(a[rows], b[rows], **TOL)
    assert len(keys) == 1


# ---------------------------------------------------------------------------
# RequestScheduler
# ---------------------------------------------------------------------------

def _sched_prompts(vocab):
    """Three prompts sharing a 16-token head (one page), two unique."""
    rng = np.random.default_rng(5)
    head = rng.integers(1, vocab, 16).astype(np.int32)
    return [np.concatenate([head, rng.integers(1, vocab, k).astype(
        np.int32)]) for k in (5, 20, 13)] + _prompts(vocab, (6, 30), 6)


def _run(sched_cls, req_cls, eng, prompts, mnt=6):
    sched = sched_cls(eng)
    reqs = [req_cls(p, max_new_tokens=mnt, req_id=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    assert all(r.done for r in reqs)
    return sched, [r.result.tokens.tolist() for r in reqs]


MOE_SCHED = dict(max_seq_len=MAX_SEQ, max_batch=2, prefill_chunk=8,
                 prefill_token_budget=16)


@pytest.mark.parametrize("page_size", [0, 16], ids=["dense", "paged"])
def test_moe_scheduler_token_exact(page_size):
    """qwen3-moe through continuous batching (8-token chunks: the MoE
    dispatch groups are the chunks), on the dense arena and on 16-token
    pages with prefix sharing: the JAX scheduler's tokens."""
    (jp, ju, jcfg, js), (tp, tu, cfg, ts) = _model("qwen3-moe-235b-a22b")
    prompts = _sched_prompts(cfg.vocab_size)
    skw = dict(MOE_SCHED, page_size=page_size)
    jsched, jt = _run(JScheduler, JRequest,
                      JEngine(jp, ju, jcfg, JServe(sals=js, **skw)), prompts)
    tsched, tt = _run(RequestScheduler, Request, ServeEngine(
        tp, tu, cfg, ServeConfig(sals=ts, **skw), device="cpu"), prompts)
    assert tsched.mode == jsched.mode == "continuous"
    assert tt == jt
    if page_size:
        assert tsched.prefix_hits == jsched.prefix_hits > 0


@pytest.mark.parametrize("page_size", [0, 16], ids=["dense", "paged"])
def test_moe_speculative_equals_sequential(page_size):
    """llama4-scout's verify window of 4 through the scheduler commits the
    sequential scheduler's tokens.  As in the dense family's spec tests,
    N_c covers every selectable position: a window query's selection is
    then the one its sequential step makes."""
    _, (tp, tu, cfg, ts) = _model("llama4-scout-17b-a16e")
    ts = dataclasses.replace(ts, n_critical=64)
    prompts = _sched_prompts(cfg.vocab_size)

    def run(q):
        return _run(RequestScheduler, Request, ServeEngine(
            tp, tu, cfg, ServeConfig(sals=ts, page_size=page_size,
                                     spec_window=q, **MOE_SCHED),
            device="cpu"), prompts)

    spec, st = run(4)
    _, seq = run(0)
    assert st == seq
    assert spec.spec_rounds > 0


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b"])
def test_recurrent_scheduler_falls_back_to_static(arch):
    """Asked for continuous batching, both schedulers run the recurrent
    families static (fixed batches through ``generate``): the same
    tokens."""
    (jp, ju, jcfg, js), (tp, tu, cfg, ts) = _model(arch)
    prompts = _prompts(cfg.vocab_size, (37, 22, 6, 30, 12), 7)
    skw = dict(max_seq_len=MAX_SEQ, max_batch=2)
    jsched, jt = _run(JScheduler, JRequest, JEngine(
        jp, ju, jcfg, JServe(sals=js or JSALS(enabled=False), **skw)),
        prompts)
    tsched, tt = _run(RequestScheduler, Request, ServeEngine(
        tp, tu, cfg, ServeConfig(sals=ts or SALSConfig(enabled=False),
                                 **skw), device="cpu"), prompts)
    assert tsched.mode == jsched.mode == "static"
    assert tt == jt


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def _raises_both(exc, match, jfn, tfn):
    with pytest.raises(exc, match=match):
        jfn()
    with pytest.raises(exc, match=match):
        tfn()


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-7b"])
def test_recurrent_refusals_match_reference(arch):
    (jp, ju, jcfg, js), (tp, tu, cfg, ts) = _model(arch)
    jsals = js or JSALS(enabled=False)
    tsals = ts or SALSConfig(enabled=False)
    # a paged cache
    _raises_both(ValueError, "recurrent — the paged latent cache",
                 lambda: jtf.init_cache(jcfg, js, 1, 64, page_size=32,
                                        n_pages=4),
                 lambda: ttf.init_cache(cfg, ts, 1, 64, page_size=32,
                                        n_pages=4, device="cpu"))
    paged_msg = ("recurrent — the paged latent cache needs chunked"
                 if cfg.has_attention else "page_size > 0 needs SALS")
    _raises_both(ValueError, paged_msg,
                 lambda: JEngine(jp, ju, jcfg, JServe(
                     max_seq_len=MAX_SEQ, page_size=32, sals=jsals)),
                 lambda: ServeEngine(tp, tu, cfg, ServeConfig(
                     max_seq_len=MAX_SEQ, page_size=32, sals=tsals),
                     device="cpu"))
    # speculative decoding / a verify window
    _raises_both(ValueError, "decode carries recurrent state",
                 lambda: JEngine(jp, ju, jcfg, JServe(
                     max_seq_len=MAX_SEQ, spec_window=4, sals=jsals)),
                 lambda: ServeEngine(tp, tu, cfg, ServeConfig(
                     max_seq_len=MAX_SEQ, spec_window=4, sals=tsals),
                     device="cpu"))
    jcache = jtf.init_cache(jcfg, js, 1, 32)
    tcache = ttf.init_cache(cfg, ts, 1, 32, device="cpu")
    win = np.zeros((1, 2), np.int32)
    _raises_both(ValueError, "rejected draft would need a state rollback",
                 lambda: jtf.decode_window(jp, ju, jcache, jnp.asarray(win),
                                           0, jcfg, js),
                 lambda: ttf.decode_window(tp, tu, tcache,
                                           torch.from_numpy(win), 0, cfg,
                                           ts))
    # chunked prefill
    _raises_both(ValueError, "prefill is recurrent — chunked prefill",
                 lambda: jtf.prefill_chunk(
                     jp, ju, jcfg, js, jcache,
                     jtf.init_prefill_scratch(jcfg, js, 1, 32),
                     {"tokens": jnp.asarray(win)}, 0, jnp.asarray([2])),
                 lambda: ttf.prefill_chunk(
                     tp, tu, cfg, ts, tcache,
                     ttf.init_prefill_scratch(cfg, ts, 1, 32, device="cpu"),
                     {"tokens": torch.from_numpy(win)}, 0,
                     torch.tensor([2])))
    teng = ServeEngine(tp, tu, cfg, ServeConfig(max_seq_len=MAX_SEQ,
                                                sals=tsals), device="cpu")
    jeng = JEngine(jp, ju, jcfg, JServe(max_seq_len=MAX_SEQ, sals=jsals))
    _raises_both(ValueError, "chunked prefill needs an attention family",
                 lambda: jeng.start_prefill(np.arange(1, 5, dtype=np.int32)),
                 lambda: teng.start_prefill(np.arange(1, 5, dtype=np.int32)))
    assert not teng.ragged_ok and not jeng.ragged_ok


def test_hybrid_ssd_chunk_needs_whole_chunks():
    """A uniform hymba batch over 128 tokens that is not a multiple of 128
    cannot run the SSD chunk scan: the reference asserts in its prefill,
    the port raises there too."""
    (jp, ju, jcfg, js), (tp, tu, cfg, ts) = _model("hymba-1.5b")
    prompts = _prompts(cfg.vocab_size, (200, 150), 8)
    jeng = JEngine(jp, ju, jcfg, JServe(max_seq_len=256, sals=js))
    teng = ServeEngine(tp, tu, cfg, ServeConfig(max_seq_len=256, sals=ts),
                       device="cpu")
    with pytest.raises(AssertionError, match="not divisible by chunk"):
        jeng.generate(prompts, max_new_tokens=2)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        teng.generate(prompts, max_new_tokens=2)


def test_encoder_family_not_ported():
    """hubert has no decode phase (its training forward is ported, see
    ``tests/test_torch_encoder.py``): the port's serving engine and
    decode cache refuse it as the reference's do."""
    cfg = get_config("hubert-xlarge").reduced(dtype="float32")
    jcfg = jax_get_config("hubert-xlarge").reduced(dtype="float32")
    _raises_both(ValueError, "encoder models cannot be served",
                 lambda: JEngine(None, None, jcfg, JServe()),
                 lambda: ServeEngine(None, None, cfg, ServeConfig(),
                                     device="cpu"))
    _raises_both(ValueError, "encoder family has no decode cache",
                 lambda: jtf.init_cache(jcfg, None, 1, 8),
                 lambda: ttf.init_cache(cfg, None, 1, 8, device="cpu"))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_serve_cli_families(capsys):
    """``launch.serve`` on the CPU: hymba through the static fallback,
    qwen3-moe on 16-token pages; rwkv6 with ``--page-size`` is refused
    (no SALS), hymba with ``--spec-window`` by the engine."""
    common = ["--device", "cpu", "--requests", "3", "--prompt-len", "24",
              "--max-new-tokens", "4", "--max-seq", "64",
              "--prefill-chunk", "16"]
    serve_cli.main(["--arch", "hymba-1.5b", *common])
    out = capsys.readouterr().out
    assert "3/3 requests ok" in out and "scheduler=static" in out
    serve_cli.main(["--arch", "qwen3-moe-235b-a22b", "--page-size", "32",
                    *common])
    out = capsys.readouterr().out
    assert "3/3 requests ok" in out and "page_size=32" in out \
        and "scheduler=continuous" in out
    with pytest.raises(SystemExit, match="on an attention family"):
        serve_cli.main(["--arch", "rwkv6-7b", "--page-size", "32", *common])
    with pytest.raises(ValueError, match="decode carries recurrent state"):
        serve_cli.main(["--arch", "hymba-1.5b", "--spec-window", "4",
                        *common])
