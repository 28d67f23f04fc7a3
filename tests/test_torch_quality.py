"""Port parity for the selection-quality path: ``ops.latent_score`` (its
plain twin here, the CUDA kernel on the card), ``selection.latent_scores``
/ ``selectable_mask`` / ``topk_global``, ``core/metrics.py``,
``projection.captured_energy`` / ``effective_rank`` and
``core/baselines.py``, each against the JAX reference on the same seeded
numpy inputs (reduced paper-llama2-7b for MHA, yi-9b for GQA, f32).

Tolerances: latent scores 1e-5 of the score scale (max |score|): the same
f32 products summed in another order; overlap scores 1e-5 absolute (f32
softmax masses); eigenvalues 1e-6 of the largest (f64); indices, ranks and
byte counts exact.  The ``requires_cuda`` case holds the CUDA kernel
against the twin and skips without a card."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SALSConfig as JSALS
from repro.configs import get_config as jax_get_config
from repro.core import baselines as jbl
from repro.core import metrics as jmetrics
from repro.core import projection as jpj
from repro.core import selection as jsel
from repro.kernels import latent_score as jls
from repro.kernels import ref as jref
from repro_torch.config import SALSConfig
from repro_torch.configs import get_config
from repro_torch.core import baselines as bl
from repro_torch.core import metrics, projection, selection
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

ARCHS = {"llama2-mha": ("paper-llama2-7b", {"n_kv_heads": 4}),
         "yi-gqa": ("yi-9b", {})}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs twin)")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=sorted(ARCHS))
def cfgs(request):
    arch, over = ARCHS[request.param]
    over = dict(dtype="float32", **over)
    return jax_get_config(arch).reduced(**over), get_config(arch).reduced(
        **over)


def _orthonormal(rng, n, r):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return q[:, :r].astype(np.float32)


def _assert_scores(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# latent_score: twin vs Pallas (interpret) and the reference's ref
# ---------------------------------------------------------------------------

def _score_inputs(seed, b, s, r, r_star, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, r_star)).astype(np.float32)
    k = rng.standard_normal((b, s, r)).astype(np.float32)
    scale = None
    if dtype == "int8":
        k = np.clip(np.round(k * 40), -127, 127).astype(np.int8)
        scale = rng.uniform(0.005, 0.05, (b, s)).astype(np.float32)
    return q, k, scale


def _as(dtype):
    return {"f32": (torch.float32, jnp.float32),
            "bf16": (torch.bfloat16, jnp.bfloat16),
            "int8": (torch.int8, jnp.int8)}[dtype]


@pytest.mark.parametrize("s", [300, 1500], ids=["S300", "S1500"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_latent_score_twin_matches_reference(dtype, s):
    """r* = 24 < r = 40; S = 300 (one ragged block) and 1500 (> 1024, two
    blocks, the second ragged); int8 latents carry their bf16 scale."""
    b, r, r_star = 2, 40, 24
    q, k, scale = _score_inputs(4, b, s, r, r_star, dtype)
    tdt, jdt = _as(dtype)
    kt = torch.from_numpy(k).to(tdt) if dtype != "int8" \
        else torch.from_numpy(k)
    st = None if scale is None else \
        torch.from_numpy(scale).to(torch.bfloat16)
    kj = jnp.asarray(k, jdt)
    sj = None if scale is None else jnp.asarray(scale, jnp.bfloat16)
    got = ops.latent_score(torch.from_numpy(q), kt, st)
    assert got.shape == (b, s) and got.dtype == torch.float32
    pallas = jls.latent_score_pallas(jnp.asarray(q), kj, sj)
    oracle = jref.latent_score_ref(jnp.asarray(q), kj, sj)
    _assert_scores(got.numpy(), pallas)
    _assert_scores(got.numpy(), oracle)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_latent_score_kernel_vs_twin(cuda, dtype):
    b, s, r, r_star = 3, 1500, 64, 32
    q, k, scale = _score_inputs(5, b, s, r, r_star, dtype)
    tdt, _ = _as(dtype)
    qt = torch.from_numpy(q)
    kt = torch.from_numpy(k).to(tdt)
    st = None if scale is None else \
        torch.from_numpy(scale).to(torch.bfloat16)
    want = ops.latent_score(qt, kt, st)
    got = ops.latent_score(qt.to(cuda), kt.to(cuda),
                           None if st is None else st.to(cuda))
    _assert_scores(got.cpu().numpy(), want.numpy())


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

def test_selectable_mask_and_topk_global_exact():
    """Integer scores plant ties (also between a masked and a kept token);
    indices must equal ``lax.top_k``'s, lower index first on ties, and
    slots past the selectable set come back invalid."""
    rng = np.random.default_rng(6)
    b, s, n_c = 3, 90, 40
    sals, jsals = (SALSConfig(n_sink=4, n_recent=8),
                   JSALS(n_sink=4, n_recent=8))
    scores = rng.integers(-3, 4, (b, s)).astype(np.float32)
    for pos in (89, 30, 12):
        m = selection.selectable_mask(torch.arange(s), pos, sals)
        jm = jsel.selectable_mask(jnp.arange(s), pos, jsals)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        mask = m[None].expand(b, s)
        idx, valid = selection.topk_global(torch.from_numpy(scores), mask,
                                           n_c)
        jidx, jvalid = jsel.topk_global(jnp.asarray(scores),
                                        jnp.broadcast_to(jm[None], (b, s)),
                                        n_c)
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert int(valid.sum(-1)[0]) == min(n_c, int(m.sum()))


def test_latent_scores_matches_reference(cfgs):
    jcfg, cfg = cfgs
    rng = np.random.default_rng(7)
    b, s, r, r_star = 2, 70, cfg.kv_dim // 2, cfg.kv_dim // 4
    q_bar = rng.standard_normal((b, cfg.kv_dim)).astype(np.float32)
    u = _orthonormal(rng, cfg.kv_dim, r)
    k_lat = rng.standard_normal((b, s, r)).astype(np.float32)
    got = selection.latent_scores(torch.from_numpy(q_bar),
                                  torch.from_numpy(u),
                                  torch.from_numpy(k_lat), r_star)
    want = jsel.latent_scores(jnp.asarray(q_bar), jnp.asarray(u),
                              jnp.asarray(k_lat), r_star)
    _assert_scores(got.numpy(), want)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _qk(seed, cfg, b, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, cfg.n_heads, cfg.head_dim)) \
        .astype(np.float32)
    k = rng.standard_normal((b, s, cfg.n_kv_heads, cfg.head_dim)) \
        .astype(np.float32)
    return q, k, rng


@pytest.mark.parametrize("s,pos", [(200, 199), (160, 180)],
                         ids=["full-context", "pos-past-context"])
def test_overlap_score_matches_reference(cfgs, s, pos):
    jcfg, cfg = cfgs
    kw = dict(rank_ratio=0.5, score_ratio=0.5, n_critical=24, n_sink=4,
              n_recent=16)
    q, k, rng = _qk(8, cfg, 2, s)
    u = _orthonormal(rng, cfg.kv_dim, SALSConfig(**kw).rank(cfg.kv_dim))
    got = metrics.overlap_score(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(u), cfg, SALSConfig(**kw),
                                pos)
    want = jmetrics.overlap_score(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(u), jcfg, JSALS(**kw), pos)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert np.all(got.numpy() > 0) and np.all(got.numpy() <= 1 + 1e-6)


def test_overlap_score_full_budget_is_one(cfgs):
    _, cfg = cfgs
    sals = SALSConfig(rank_ratio=1.0, score_ratio=1.0, n_critical=64,
                      n_sink=2, n_recent=4)
    q, k, rng = _qk(9, cfg, 2, 32)
    u = _orthonormal(rng, cfg.kv_dim, cfg.kv_dim)
    got = metrics.overlap_score(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(u), cfg, sals, 31)
    np.testing.assert_allclose(got.numpy(), 1.0, atol=1e-5)


def test_overlap_score_partial_budget_in_unit_interval(cfgs):
    _, cfg = cfgs
    sals = SALSConfig(rank_ratio=0.25, score_ratio=0.5, n_critical=2,
                      n_sink=1, n_recent=2)
    q, k, rng = _qk(10, cfg, 2, 64)
    u = _orthonormal(rng, cfg.kv_dim, sals.rank(cfg.kv_dim))
    got = metrics.overlap_score(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(u), cfg, sals, 63).numpy()
    assert np.all(got <= 1.0 + 1e-6) and np.all(got > 0.0)


def _lowrank_keys(n, dim, true_rank, noise, seed):
    rng = np.random.default_rng(seed)
    basis = rng.normal(size=(true_rank, dim))
    coef = rng.normal(size=(n, true_rank))
    return coef @ basis + noise * rng.normal(size=(n, dim))


@pytest.mark.parametrize("lowrank", [True, False], ids=["lowrank", "noise"])
def test_rank_pre_post_rope_matches_reference(cfgs, lowrank):
    jcfg, cfg = cfgs
    n = 256
    if lowrank:
        flat = _lowrank_keys(n, cfg.kv_dim, 6, 0.002, 3)
    else:
        flat = np.random.default_rng(11).standard_normal((n, cfg.kv_dim))
    k_pre = flat.reshape(n, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
    r_pre, r_post, ev_pre, ev_post = metrics.rank_pre_post_rope(
        torch.from_numpy(k_pre), cfg)
    jr_pre, jr_post, jev_pre, jev_post = jmetrics.rank_pre_post_rope(
        k_pre, jcfg)
    assert (r_pre, r_post) == (jr_pre, jr_post)
    for a, b in ((ev_pre, jev_pre), (ev_post, jev_post)):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * float(np.abs(b).max()))
    if lowrank:             # paper §3.1 / appendix A: RoPE raises the rank
        assert r_post > r_pre, (r_pre, r_post)


def test_latent_mse_captured_energy_effective_rank(cfgs):
    jcfg, cfg = cfgs
    rng = np.random.default_rng(12)
    k = rng.standard_normal((40, cfg.n_kv_heads, cfg.head_dim)) \
        .astype(np.float32)
    for r in (cfg.kv_dim // 4, cfg.kv_dim):
        u = _orthonormal(rng, cfg.kv_dim, r)
        got = metrics.latent_mse(torch.from_numpy(k), torch.from_numpy(u))
        want = jmetrics.latent_mse(jnp.asarray(k), jnp.asarray(u))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-6)
    ev = np.sort(rng.uniform(0, 5, (3, cfg.kv_dim)))[:, ::-1].copy()
    for rank in (1, 7, cfg.kv_dim):
        np.testing.assert_allclose(
            projection.captured_energy(torch.from_numpy(ev), rank).numpy(),
            np.asarray(jpj.captured_energy(jnp.asarray(ev), rank)),
            rtol=1e-6)
    for v in (50.0, 90.0, 99.0):
        assert projection.effective_rank(torch.from_numpy(ev[0]), v) \
            == jpj.effective_rank(ev[0], v)
    assert projection.effective_rank(np.zeros(4)) == 4


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

def test_baseline_modes_match_reference():
    for mine, ref_mode in ((bl.palu_mode(4096), jbl.palu_mode(4096)),
                           (bl.palu_mode(512, 0.125),
                            jbl.palu_mode(512, 0.125)),
                           (bl.kivi_mode(432), jbl.kivi_mode(432)),
                           (bl.kivi_mode(100, 8), jbl.kivi_mode(100, 8))):
        for f in ("rank_ratio", "score_ratio", "n_critical", "n_sink",
                  "n_recent", "v_bits", "v_group", "k_latent_dtype",
                  "skip_layers_front", "skip_layers_back"):
            assert getattr(mine, f) == getattr(ref_mode, f), f


def test_quest_matches_reference_and_finds_aligned_page():
    rng = np.random.default_rng(0)
    b, s, d = 2, 64, 32
    k = rng.normal(size=(b, s, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    k[:, 2 * bl.PAGE + 3] = 5.0 * q          # a strongly aligned key
    kmin, kmax = bl.quest_page_summaries(torch.from_numpy(k))
    jmin, jmax = jbl.quest_page_summaries(jnp.asarray(k))
    np.testing.assert_array_equal(kmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(kmax.numpy(), np.asarray(jmax))
    scores = bl.quest_scores(torch.from_numpy(q), torch.from_numpy(k))
    _assert_scores(scores.numpy(),
                   jbl.quest_scores(jnp.asarray(q), jnp.asarray(k)))
    assert np.all(scores.argmax(1).numpy() // bl.PAGE == 2)
    with pytest.raises(ValueError):
        bl.quest_page_summaries(torch.zeros(1, 20, 4))


def test_ds_matches_reference_and_scores_needle():
    rng = np.random.default_rng(1)
    s, d = 128, 64
    calib = rng.normal(size=(1024, d)) * np.linspace(3, 0.1, d)
    ch = bl.ds_label_channels(torch.from_numpy(calib), 8)
    np.testing.assert_array_equal(ch, jbl.ds_label_channels(calib, 8))
    assert set(ch.tolist()) == set(range(8))   # highest-energy channels
    k = rng.normal(size=(1, s, d)).astype(np.float32)
    q = np.zeros((1, d), np.float32)
    q[0, :8] = 1.0
    k[0, 42, :8] = 10.0
    sc = bl.ds_scores(torch.from_numpy(q), torch.from_numpy(k), ch)
    _assert_scores(sc.numpy(), jbl.ds_scores(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(ch)))
    assert int(sc[0].argmax()) == 42


def test_traffic_per_step_matches_reference_and_table4_order():
    """Every method's bytes equal the reference's; the ordering of paper
    Table 4: SALS < Quest / KIVI / Palu, SALS-12.5% < Double Sparsity."""
    cfg, jcfg = get_config("paper-llama2-7b"), \
        jax_get_config("paper-llama2-7b")
    s, budget = 4096, 512
    t = {}
    for rr, name in ((0.25, "sals25"), (0.125, "sals125")):
        kw = dict(rank_ratio=rr, n_critical=budget, n_sink=16, n_recent=64,
                  v_bits=8 if rr == 0.25 else 4, v_group=64)
        t[name] = bl.traffic_per_step("sals", cfg, s, budget,
                                      SALSConfig(**kw))
        assert t[name] == jbl.traffic_per_step("sals", jcfg, s, budget,
                                               JSALS(**kw))
    for m, n_sel in (("quest", budget), ("ds", budget), ("palu", s),
                     ("kivi", s), ("full", s)):
        t[m] = bl.traffic_per_step(m, cfg, s, n_sel)
        assert t[m] == jbl.traffic_per_step(m, jcfg, s, n_sel), m
    assert t["sals25"] < t["quest"] < 1.0
    assert t["sals25"] < t["kivi"] < 1.0
    assert t["sals25"] < t["palu"]
    assert t["sals125"] < t["ds"] < 1.0
    with pytest.raises(ValueError):
        bl.traffic_per_step("nope", cfg, s, budget)
