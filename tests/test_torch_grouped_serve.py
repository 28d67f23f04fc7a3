"""The grouped selection layout (``n_groups`` G > 1) through the serving
entry points, held to the JAX reference from the same weights and
projectors (reduced paper-llama2-7b, MHA, and yi-9b, GQA; float32):

- ``ServeEngine(n_groups=2).generate`` token-exact with the JAX engine at
  G 2; per-step logits teacher-forced within 1e-4;
- ``RequestScheduler`` at G 2, dense arena and paged pool (prefix
  sharing), token-exact with the JAX scheduler (admissions and counters
  equal), paged == dense;
- the two-tier pool at G 2 against the JAX tiered grouped scheduler
  (spills, fetches, cold misses and tokens);
- the speculative scheduler at G 2 token-exact with the port's sequential
  grouped scheduler (N_c covers every slab: ROADMAP C1's rule, the port
  held to the sequential stream), dense and paged;
- the engine's divisibility ``ValueError`` s where the reference raises.
"""
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
from repro_torch.models import transformer as ttf
from repro_torch.serve import Request, RequestScheduler, ServeEngine

torch.set_num_threads(1)

G = 2
SALS_KW = dict(rank_ratio=0.5, score_ratio=0.5, n_critical=16, n_sink=2,
               n_recent=8, v_bits=8, v_group=32, skip_layers_front=1,
               skip_layers_back=1)
ARCHS = {"llama2-mha": ("paper-llama2-7b", {"n_kv_heads": 4}),
         "yi-gqa": ("yi-9b", {})}
SKW = dict(max_seq_len=128, max_batch=3, prefill_chunk=8, audit_every=1)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    arch, over = ARCHS[request.param]
    over = dict(dtype="float32", n_layers=4, vocab_size=128, **over)
    jcfg = jax_get_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    jsals, sals = JSALS(**SALS_KW), SALSConfig(**SALS_KW)
    jp = jtf.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    ju = jcal.random_layer_projectors(jax.random.PRNGKey(2), jcfg, jsals,
                                      jcfg.n_layers)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tu = projectors_from_numpy({"u": np.asarray(ju["u"])}, device="cpu")
    return dict(j=(jp, ju, jcfg, jsals), t=(tp, tu, cfg, sals))


def _engines(model, g=G, sals_over=None, **skw):
    jp, ju, jcfg, jsals = model["j"]
    tp, tu, cfg, sals = model["t"]
    if sals_over:
        jsals = dataclasses.replace(jsals, **sals_over)
        sals = dataclasses.replace(sals, **sals_over)
    return (JEngine(jp, ju, jcfg, JServe(sals=jsals, **skw), n_groups=g),
            ServeEngine(tp, tu, cfg, ServeConfig(sals=sals, **skw),
                        n_groups=g, device="cpu"))


def _prompts(seed=3, vocab=128):
    """Three prompts sharing a 3-page (48-token) head, two unique ones:
    every slab of a 128-token row fills past k_loc."""
    rng = np.random.default_rng(seed)
    head = rng.integers(1, vocab, 48).astype(np.int32)
    return [np.concatenate([head, rng.integers(1, vocab, k)
                            .astype(np.int32)]) for k in (25, 20, 13)] + \
        [rng.integers(1, vocab, n).astype(np.int32) for n in (6, 70)]


def _drain(eng, prompts, mnt, req_cls=Request, sched_cls=RequestScheduler):
    sched = sched_cls(eng)
    reqs = [req_cls(p, max_new_tokens=mnt, req_id=i)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    return sched, reqs


def _tokens(reqs):
    assert all(r.state.value == "done" for r in reqs)
    return [r.result.tokens.tolist() for r in reqs]


@pytest.mark.parametrize("arch,over,v_bits,lat_dtype", [
    ("paper-llama2-7b", {"n_kv_heads": 4}, 8, "bfloat16"),   # MHA
    ("yi-9b", {}, 4, "int8"),                                 # GQA
])
def test_generate_grouped_token_exact_and_logits(arch, over, v_bits,
                                                 lat_dtype):
    """The settings of ``tests/test_torch_engine.py``'s G 1 test, at G 2:
    k_loc 5 of slabs of 32 positions."""
    over = dict(dtype="float32", n_layers=4, **over)
    jcfg = jax_get_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    kw = dict(n_critical=10, n_sink=2, n_recent=8, v_group=16,
              skip_layers_front=1, skip_layers_back=1, v_bits=v_bits,
              k_latent_dtype=lat_dtype)
    jsals, sals = JSALS(**kw), SALSConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    ju = jcal.random_layer_projectors(jax.random.PRNGKey(2), jcfg, jsals,
                                      jcfg.n_layers)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tu = projectors_from_numpy({"u": np.asarray(ju["u"])}, device="cpu")
    jeng = JEngine(jp, ju, jcfg, JServe(max_seq_len=64, sals=jsals),
                   n_groups=G)
    teng = ServeEngine(tp, tu, cfg, ServeConfig(max_seq_len=64, sals=sals),
                       n_groups=G, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (37, 22, 6)]            # 6 < n_sink + n_recent
    n_new = 12
    jres = jeng.generate(prompts, max_new_tokens=n_new)
    tres = teng.generate(prompts, max_new_tokens=n_new)
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert len(b.tokens) == n_new
    # per-step logits, teacher-forced with the reference's tokens, through
    # a cache that carries the layout (decode_step reads it back)
    lens = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((3, lens.max()), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    forced = np.stack([r.tokens for r in jres])
    jl, jcache = jeng._prefill({"tokens": jnp.asarray(toks)},
                               jnp.asarray(lens))
    jdecode = jax.jit(lambda c, t, pos: jtf.decode_step(jp, ju, c, t, pos,
                                                        jcfg, jsals))
    with torch.inference_mode():
        tl, tcache = ttf.prefill(tp, tu, cfg, sals,
                                 {"tokens": torch.from_numpy(toks)}, 64,
                                 n_groups=G, lengths=torch.from_numpy(lens))
        assert tcache["seg1"].n_groups == G
        for t in range(n_new):
            np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {t}")
            if t == n_new - 1:
                break
            nxt = forced[:, t]
            jl, jcache = jdecode(jcache, jnp.asarray(nxt),
                                 jnp.asarray(lens + t))
            tl, tcache = ttf.decode_step(tp, tu, tcache,
                                         torch.from_numpy(nxt),
                                         torch.from_numpy(lens + t), cfg,
                                         sals)


def test_scheduler_grouped_matches_reference_paged_equals_dense(model):
    """Dense arena and paged pool (16-token pages: 8 per row, 4 per slab;
    three prompts share a 3-page head) at G 2, 5 requests over 3 slots."""
    prompts = _prompts()
    jeng, teng = _engines(model, **SKW)
    js, jr = _drain(jeng, prompts, 6, JRequest, JScheduler)
    ts, tr = _drain(teng, prompts, 6)
    assert _tokens(tr) == _tokens(jr)
    assert list(ts.admissions) == list(js.admissions)
    assert ts.steps == js.steps
    _, peng = _engines(model, page_size=16, **SKW)
    ps_, pr = _drain(peng, prompts, 6)
    assert _tokens(pr) == _tokens(tr)
    assert ps_.prefix_hits == 2
    ps_.audit_serving_state()
    # and the reference's own paged grouped run agrees
    jpeng, _ = _engines(model, page_size=16, **SKW)
    jps, jpr = _drain(jpeng, prompts, 6, JRequest, JScheduler)
    assert _tokens(jpr) == _tokens(pr)
    assert ps_.prefix_hits == jps.prefix_hits


def test_tiered_grouped_scheduler_matches_reference(model):
    """A two-tier pool of 8 hot slots below the live pages: scores through
    the page table from the resident r* pool, reconstruction through the
    folded hot table; spills, fetches and cold misses as the reference's."""
    prompts = _prompts(seed=5)
    kw = dict(SKW, page_size=16, hbm_pages=8)
    jeng, teng = _engines(model, sals_over=dict(n_critical=8), **kw)
    js, jr = _drain(jeng, prompts, 8, JRequest, JScheduler)
    ts, tr = _drain(teng, prompts, 8)
    assert _tokens(tr) == _tokens(jr)
    assert ts.pool.spills == js.pool.spills > 0
    assert ts.pool.fetches == js.pool.fetches
    for name in ("fetch_hits", "prefetch_hits", "cold_misses", "evictions",
                 "steps", "done"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.cold_misses > 0
    # two-tier == untiered tokens at the same layout
    _, ueng = _engines(model, sals_over=dict(n_critical=8), page_size=16,
                       **SKW)
    _, ur = _drain(ueng, prompts, 8)
    assert _tokens(ur) == _tokens(tr)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_spec_grouped_scheduler_equals_sequential(model, paged):
    """Verify windows of 4 at G 2 (one top-k_loc per slab a round) commit
    the sequential grouped scheduler's tokens when k_loc covers every
    slab (N_c 128: k_loc 64 = the slab)."""
    kw = dict(SKW, prefill_token_budget=32)
    if paged:
        kw.update(page_size=16, n_pages=40)
    rng = np.random.default_rng(7)
    base = rng.integers(1, 128, 8)
    prompts = [np.tile(base, 8).astype(np.int32)[:30 + 9 * i]
               for i in range(3)] + [rng.integers(1, 128, 40)
                                     .astype(np.int32)]
    over = dict(n_critical=128)
    _, seq = _engines(model, sals_over=over, **kw)
    _, spec = _engines(model, sals_over=over, spec_window=4, **kw)
    ss, sr = _drain(seq, prompts, 17)
    ps_, pr = _drain(spec, prompts, 17)
    assert _tokens(pr) == _tokens(sr)
    assert ps_.spec_rounds == ps_.steps > 0 and ps_.spec_accepted > 0
    assert ps_.spec_committed > ps_.spec_rounds
    ps_.audit_serving_state()


def test_engine_divisibility_errors_match_reference(model):
    jp, ju, jcfg, jsals = model["j"]
    tp, tu, cfg, sals = model["t"]
    cases = [(dict(max_seq_len=96), 5),             # 96 % 5
             (dict(max_seq_len=96, page_size=32, prefill_chunk=8), 2)]
    for skw, g in cases:                                    # 3 pages % 2
        with pytest.raises(ValueError) as j_err:
            JEngine(jp, ju, jcfg, JServe(sals=jsals, **skw), n_groups=g)
        with pytest.raises(ValueError) as t_err:
            ServeEngine(tp, tu, cfg, ServeConfig(sals=sals, **skw),
                        n_groups=g, device="cpu")
        assert str(t_err.value) == str(j_err.value)
    eng = ServeEngine(tp, tu, cfg, ServeConfig(sals=sals, max_seq_len=96,
                                               page_size=32, prefill_chunk=8),
                      n_groups=3, device="cpu")
    cache = eng.init_slot_cache()
    assert all(seg.n_groups == 3 for seg in eng._latent_segs(cache).values())


@pytest.mark.parametrize("argv,want", [
    (["--groups", "2", "--page-size", "32", "--audit-every", "1"],
     "groups=2, scheduler=continuous"),
    (["--groups", "4", "--scheduler", "static"], "groups=4, scheduler=static"),
])
def test_serve_cli_groups_and_scheduler(capsys, argv, want):
    from repro_torch.launch import serve
    serve.main(["--arch", "yi-9b", "--device", "cpu", "--requests", "3",
                "--max-new-tokens", "4", *argv])
    out = capsys.readouterr().out
    assert "3/3 requests ok" in out and want in out
    with pytest.raises(ValueError, match="n_groups"):       # 512 % 3
        serve.main(["--arch", "yi-9b", "--device", "cpu", "--groups", "3"])
