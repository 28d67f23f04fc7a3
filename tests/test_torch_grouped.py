"""Port parity for the grouped selection layout (``n_groups`` G > 1): the
per-slab top-⌈N_c/G⌉ with the group axis folded into the kernel batch,
held to the JAX reference on the same seeded numpy inputs.

- ``selection.topk_grouped`` equals the reference's exactly;
  ``projection.fit_projector_grouped`` to 1e-5 (eigenvalues relative, each
  block of ``u`` up to column sign); ``LatentKVCache.group_view`` equals the
  reference's and raises where it does, as do the caches' divisibility
  checks.
- The folded kernels (``ops.latent_topk`` / ``ops.sparse_recon_attention``
  on (B·G, S/G) slabs with ``pos_base``) against the reference's "xla"
  oracle in the cases of ``tests/test_kernels.py``'s grouped test and a
  hypothesis sweep: indices and validity exact (integer-valued latents make
  every score exact and ties deliberate), partials and the merged output
  within 1e-5; an empty slab is an exact no-op (m = NEG_INF, l = 0, o = 0).
- The paged fold (the page table viewed as (B·G, mp/G), pools untouched)
  equals the dense fold bit for bit, touched pages included, and both
  equal the reference's paged "xla" oracle.
- ``sals_decode_attend`` / ``sals_window_attend`` at G 2 and 4 on dense and
  paged caches against the reference's (1e-5); a grouped Q = 1 window
  equals the grouped single step bit for bit.
- The fold copies nothing: the kernels get views of the arena (shared
  storage) and no (·, k_loc, ·) gathered buffer.
- ``requires_cuda``: the folded kernels against their twins on the card.
"""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:                       # optional dev extra, as tests/test_fused_property
    from hypothesis import given, settings, strategies as st
except ImportError:        # the property sweep skips; the rest still runs
    from conftest import given, settings, st  # noqa: F401

from repro.config import SALSConfig as JSALS
from repro.configs import get_config as jax_get_config
from repro.core import latent_cache as jlc
from repro.core import projection as jproj
from repro.core import selection as jsel
from repro.core import sparse_attention as jsa
from repro.kernels import ops as jops
from repro_torch.config import SALSConfig
from repro_torch.configs import get_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import latent_cache as tlc
from repro_torch.core import projection as tproj
from repro_torch.core import selection as tsel
from repro_torch.core import sparse_attention as tsa
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import Attention

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("k_lat", "v_q", "v_scale", "v_zero", "sink_k", "sink_v",
          "recent_k", "recent_v", "k_scale", "lengths")
POOL_FIELDS = ("k_lat", "k_scale", "v_q", "v_scale", "v_zero")


def _t(a, dtype=None):
    """numpy -> torch, via f32 for bf16 (exact)."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _j(a, dtype=None):
    return jnp.asarray(a, dtype) if dtype is not None else jnp.asarray(a)


def _merge(m, l, o):
    """(B·G, H[, dh]) slab partials -> the (B, H, dh) merged output over a
    G axis of ``m.shape[0] // B`` (as the decode step's LSE merge)."""
    m, l, o = (np.asarray(x, np.float64) for x in (m, l, o))
    mx = m.max(axis=1, keepdims=True)
    w = np.exp(m - mx)
    den = (w * l).sum(axis=1)
    return (w[..., None] * o).sum(axis=1) / np.maximum(den, 1e-30)[..., None]


# ---------------------------------------------------------------------------
# selection, projection, cache metadata
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,nc", [(1, 24), (2, 24), (4, 24), (4, 7),
                                  (8, 100)])
def test_topk_grouped_matches_reference(g, nc):
    """Integer scores make ties deliberate: (value desc, index asc) on
    both sides, masked slots invalid, k_loc > S/G padded invalid."""
    rng = np.random.default_rng(10 + g)
    b, s = 3, 96
    scores = rng.integers(-3, 4, (b, s)).astype(np.float32)
    mask = rng.random((b, s)) < 0.7
    mask[2] = False                              # a row with nothing
    j_idx, j_val = jsel.topk_grouped(_j(scores), _j(mask), nc, g)
    t_idx, t_val = tsel.topk_grouped(_t(scores), _t(mask), nc, g)
    assert t_idx.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(j_idx), t_idx.numpy())
    np.testing.assert_array_equal(np.asarray(j_val), t_val.numpy())
    assert not t_val[2].any()
    with pytest.raises(ValueError, match="divisible"):
        tsel.topk_grouped(_t(scores[:, :95]), _t(mask[:, :95]), nc, 2)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_fit_projector_grouped_matches_reference(g):
    rng = np.random.default_rng(20 + g)
    kvd, rank = 64, 16
    keys = (rng.standard_normal((500, kvd))
            * np.linspace(3, 0.1, kvd)).astype(np.float32)
    j = jproj.fit_projector_grouped(keys, rank, g)
    t = tproj.fit_projector_grouped(torch.from_numpy(keys), rank, g)
    assert t["u"].dtype == torch.float32 and t["u"].shape == (kvd, rank)
    je, te = np.asarray(j["eigvals"], np.float64), t["eigvals"].double()
    np.testing.assert_allclose(te.numpy(), je, rtol=1e-5,
                               atol=1e-5 * je.max())
    ju, tu = np.asarray(j["u"], np.float64), t["u"].double().numpy()
    gd, gr = kvd // g, rank // g
    for i in range(g):
        rows, cols = slice(i * gd, (i + 1) * gd), slice(i * gr, (i + 1) * gr)
        jb, tb = ju[rows, cols], tu[rows, cols]
        sign = np.sign((jb * tb).sum(axis=0))    # eigenvector signs free
        np.testing.assert_allclose(tb * sign, jb, atol=1e-5)
    assert np.count_nonzero(tu[~_block_mask(kvd, rank, g)]) == 0
    with pytest.raises(ValueError, match="divisible"):
        tproj.fit_projector_grouped(keys, 15, 2)


def _block_mask(kvd, rank, g):
    m = np.zeros((kvd, rank), bool)
    gd, gr = kvd // g, rank // g
    for i in range(g):
        m[i * gd:(i + 1) * gd, i * gr:(i + 1) * gr] = True
    return m


def _cfgs(arch="yi-9b", **over):
    over = dict(dtype="float32", n_layers=4, **over)
    return jax_get_config(arch).reduced(**over), get_config(arch).reduced(
        **over)


SALS_KW = dict(n_critical=12, n_sink=2, n_recent=8, v_group=16,
               skip_layers_front=1, skip_layers_back=1)


def _layer_cache(jcfg, jsals, rng, b, s, max_seq, g, lens, u):
    """One reference layer cache from seeded prefill tensors, and the
    port's copy of it field by field."""
    k_pre = rng.standard_normal((b, s, jcfg.n_kv_heads, jcfg.head_dim)) \
        .astype(np.float32)
    v = rng.standard_normal(k_pre.shape).astype(np.float32)
    jc = jlc.LatentKVCache.prefill_layer(
        jcfg, jsals, jnp.asarray(u), jnp.asarray(k_pre), jnp.asarray(v),
        max_seq, jnp.float32, n_groups=g, lengths=jnp.asarray(lens))
    tc = tlc.LatentKVCache(**{
        f: None if getattr(jc, f) is None
        else tensor_from_numpy(getattr(jc, f), "cpu") for f in FIELDS},
        n_groups=g)
    return jc, tc


def test_group_view_matches_reference_and_raises():
    jcfg, cfg = _cfgs()
    kw = dict(SALS_KW, k_latent_dtype="int8")
    jsals, sals = JSALS(**kw), SALSConfig(**kw)
    rng = np.random.default_rng(30)
    r = sals.rank(cfg.kv_dim)
    u = np.linalg.qr(rng.standard_normal((cfg.kv_dim, r)))[0] \
        .astype(np.float32)
    lens = np.array([40, 23], np.int32)
    jc, tc = _layer_cache(jcfg, jsals, rng, 2, 40, 48, 4, lens, u)
    jg, tg = jc.group_view(), tc.group_view()
    for f in POOL_FIELDS:
        want = np.asarray(getattr(jg, f)).astype(np.float32)
        got = getattr(tg, f)
        assert got.shape == want.shape and got.shape[1:3] == (4, 12), f
        assert got.data_ptr() == getattr(tc, f).data_ptr(), f   # a view
        np.testing.assert_array_equal(got.float().numpy(), want, err_msg=f)
    assert dataclasses.replace(tc, n_groups=2).group_view().k_lat.shape \
        == (2, 2, 24, r)
    # where the reference raises, so does the port
    stack = tlc.LatentKVCache.init(cfg, sals, 2, 2, 48, n_groups=4,
                                   device="cpu")
    with pytest.raises(ValueError, match="single-layer"):
        stack.group_view()
    paged = tlc.LatentKVCache.init_paged(cfg, sals, 1, 2, 64, 9, 16,
                                         n_groups=4, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        paged.layer_view(0).group_view()
    jstack = jlc.LatentKVCache.init(jcfg, jsals, 2, 2, 48, n_groups=4)
    with pytest.raises(ValueError, match="single-layer"):
        jstack.group_view()


def _divisible_calls(pkg, cfg, sals):
    """The cache constructors at layouts G does not divide: max_seq 48 %
    5, 3 pages per sequence % 2, max_seq 50 % 4."""
    if pkg is tlc:
        zeros, kw = (lambda *shape: torch.zeros(shape)), {"device": "cpu"}
    else:
        zeros, kw = (lambda *shape: np.zeros(shape, np.float32)), {}
    c = pkg.LatentKVCache
    kv = (1, 8, cfg.n_kv_heads, cfg.head_dim)
    return {
        "init": lambda: c.init(cfg, sals, 1, 2, 48, n_groups=5, **kw),
        "init_paged": lambda: c.init_paged(cfg, sals, 1, 2, 48, 9, 16,
                                           n_groups=2, **kw),
        "prefill_layer": lambda: c.prefill_layer(
            cfg, sals, zeros(cfg.kv_dim, sals.rank(cfg.kv_dim)), zeros(*kv),
            zeros(*kv), 50, n_groups=4)}


@pytest.mark.parametrize("where", ["init", "init_paged", "prefill_layer"])
def test_cache_divisibility_errors_match_reference(where):
    jcfg, cfg = _cfgs()
    jsals, sals = JSALS(**SALS_KW), SALSConfig(**SALS_KW)
    with pytest.raises(ValueError, match="n_groups") as j_err:
        _divisible_calls(jlc, jcfg, jsals)[where]()
    with pytest.raises(ValueError, match="n_groups") as t_err:
        _divisible_calls(tlc, cfg, sals)[where]()
    assert str(t_err.value) == str(j_err.value)
    # the layout rides as metadata through every constructor and view
    ok = tlc.LatentKVCache.init_paged(cfg, sals, 2, 2, 64, 9, 16,
                                      n_groups=4, hbm_pages=4, device="cpu")
    assert ok.n_groups == 4 and ok.layer_view(1).n_groups == 4
    assert tsa.plan_decode(ok.layer_view(0)) == tsa.DecodePlan(4)


# ---------------------------------------------------------------------------
# the folded kernels against the reference's grouped oracle
# ---------------------------------------------------------------------------

def _fold_np(a, g):
    return None if a is None else \
        a.reshape(a.shape[0] * g, a.shape[1] // g, *a.shape[2:])


def _kernel_inputs(seed, b, h, n_kv, dh, s, r, r_star, k_int8, vg):
    rng = np.random.default_rng(seed)
    kvd = n_kv * dh
    k = rng.integers(-2, 3, (b, s, r)).astype(np.float32)
    scale = (rng.integers(1, 4, (b, s)) * 0.25).astype(np.float32) \
        if k_int8 else None
    return dict(
        q=rng.standard_normal((b, h, dh)).astype(np.float32),
        k=k.astype(np.int8) if k_int8 else k, scale=scale,
        vq=rng.integers(-128, 128, (b, s, kvd)).astype(np.int8),
        vs=(rng.random((b, s, kvd // vg)) * 0.05).astype(np.float32),
        vz=rng.standard_normal((b, s, kvd // vg)).astype(np.float32),
        u=(rng.standard_normal((kvd, r)) * r ** -0.5).astype(np.float32),
        q_lat=rng.integers(-2, 3, (b, r_star)).astype(np.float32))


def _folded_both(x, g, pos_v, nc, n_kv, vg, k_int8):
    """The folded top-k and recon through the reference ("xla") and the
    port (CPU twins) on the same inputs; returns both (idx, valid, m, l,
    o) and the slab rows' base."""
    b, s = x["k"].shape[:2]
    s_loc, k_loc = s // g, -(-nc // g)
    base = np.tile(np.arange(g, dtype=np.int32) * s_loc, b)
    kg, ksg, vqg, vsg, vzg = (_fold_np(x[n], g) for n in
                              ("k", "scale", "vq", "vs", "vz"))
    qg, qlg = np.repeat(x["q"], g, 0), np.repeat(x["q_lat"], g, 0)
    pos = np.int32(pos_v)
    jk = jnp.int8 if k_int8 else jnp.bfloat16
    tk = torch.int8 if k_int8 else torch.bfloat16
    kw = dict(n_critical=k_loc, n_sink=2, n_recent=8)
    rk = dict(n_kv=n_kv, v_bits=8, v_group=vg)
    j_idx, j_val = jops.latent_topk(
        _j(qlg), _j(kg, jk), None if ksg is None else _j(ksg, jnp.bfloat16),
        _j(pos), pos_base=_j(base), backend="xla", **kw)
    jm, jl, jo = jops.sparse_recon_attention(
        _j(qg), _j(kg, jk), None if ksg is None else _j(ksg, jnp.bfloat16),
        _j(vqg), _j(vsg, jnp.bfloat16), _j(vzg, jnp.bfloat16), _j(x["u"]),
        j_idx, j_val, _j(pos), pos_base=_j(base), backend="xla", **rk)
    t_idx, t_val = ops.latent_topk(
        _t(qlg), _t(kg, tk), None if ksg is None else _t(ksg, torch.bfloat16),
        _t(pos), pos_base=_t(base), **kw)
    tm, tl, to = ops.sparse_recon_attention(
        _t(qg), _t(kg, tk), None if ksg is None else _t(ksg, torch.bfloat16),
        _t(vqg), _t(vsg, torch.bfloat16), _t(vzg, torch.bfloat16),
        _t(x["u"]), t_idx, t_val, _t(pos), pos_base=_t(base), **rk)
    j = [np.asarray(a) for a in (j_idx, j_val, jm, jl, jo)]
    t = [a.numpy() for a in (t_idx, t_val, tm, tl, to)]
    return j, t


def _assert_folded_equal(j, t, b, g):
    np.testing.assert_array_equal(j[0], t[0])        # indices exact
    np.testing.assert_array_equal(j[1], t[1])        # validity exact
    live = t[3] > 0
    for a, c in zip(j[2:], t[2:]):
        np.testing.assert_allclose(a[live], c[live], **TOL)
    dead = ~live                                     # exact no-op slabs
    assert (t[2][dead] == ref.NEG_INF).all() and (t[3][dead] == 0).all()
    assert (t[4][dead] == 0).all()
    shape = lambda a: a.reshape(b, g, *a.shape[1:])
    np.testing.assert_allclose(_merge(*map(shape, j[2:])),
                               _merge(*map(shape, t[2:])), **TOL)


@pytest.mark.parametrize("h,n_kv,dh", [(4, 2, 64), (8, 2, 32), (4, 1, 64)],
                         ids=["gqa2", "gqa4", "mqa"])
@pytest.mark.parametrize("k_int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("g,s,pos_v", [
    (2, 160, 159),   # full cache
    (4, 256, 100),   # later slabs partly or wholly in the future
    (2, 96, 30),     # early decode
    (4, 128, 7),     # nothing selectable
])
def test_folded_kernels_match_reference_oracle(h, n_kv, dh, k_int8, g, s,
                                               pos_v):
    b, nc, vg = 2, 24, 16
    x = _kernel_inputs(17 * g + s, b, h, n_kv, dh, s, 16, 8, k_int8, vg)
    j, t = _folded_both(x, g, pos_v, nc, n_kv, vg, k_int8)
    _assert_folded_equal(j, t, b, g)
    if pos_v < 10:
        assert not t[1].any()


@given(st.integers(0, 2 ** 31 - 1), st.sampled_from([2, 4]),
       st.booleans(), st.integers(8, 158))
@settings(max_examples=15, deadline=None)
def test_folded_kernels_property(seed, g, k_int8, pos_v):
    """Arbitrary decode positions through the fold (as
    ``tests/test_fused_property.py``'s grouped sweep)."""
    b, nc, vg = 2, 24, 16
    x = _kernel_inputs(seed, b, 4, 2, 32, 160, 16, 8, k_int8, vg)
    j, t = _folded_both(x, g, pos_v, nc, 2, vg, k_int8)
    _assert_folded_equal(j, t, b, g)


# ---------------------------------------------------------------------------
# the decode path: _grouped_partials, sals_decode_attend, sals_window_attend
# ---------------------------------------------------------------------------

def _page_layer(tc, jc, ps, seed):
    """Both packages' PAGED copies of a dense layer cache: the per-token
    fields scattered into a pool behind a shuffled table (page 0 the
    trash page, spare pages), same logical contents."""
    b, s = tc.k_lat.shape[:2]
    mp = s // ps
    rng = np.random.default_rng(seed)
    n_pages = b * mp + 5
    table = (rng.permutation(n_pages - 1)[:b * mp] + 1).reshape(b, mp) \
        .astype(np.int32)
    t_out, j_out = {}, {}
    for f in POOL_FIELDS:
        a = getattr(tc, f)
        if a is None:
            continue
        pool = torch.zeros((n_pages, ps, *a.shape[2:]), dtype=a.dtype)
        pool[torch.from_numpy(table).long().reshape(-1)] = \
            a.reshape(b * mp, ps, *a.shape[2:])
        t_out[f] = pool
        j_out[f] = jnp.asarray(np.asarray(pool.float().numpy()),
                               getattr(jc, f).dtype)
    tp = tlc.LatentKVCache(**{f: getattr(tc, f) for f in FIELDS
                              if f not in POOL_FIELDS}, **t_out,
                           page_table=torch.from_numpy(table),
                           page_size=ps, n_groups=tc.n_groups)
    jp = jc.replace(**j_out, page_table=jnp.asarray(table), page_size=ps)
    return tp, jp


def _attend_setup(g, lat_dtype="int8", seed=40, b=3, s=40, max_seq=64,
                  lens=(40, 23, 6)):
    jcfg, cfg = _cfgs()
    kw = dict(SALS_KW, k_latent_dtype=lat_dtype)
    jsals, sals = JSALS(**kw), SALSConfig(**kw)
    rng = np.random.default_rng(seed)
    r = sals.rank(cfg.kv_dim)
    u = np.linalg.qr(rng.standard_normal((cfg.kv_dim, cfg.kv_dim)))[0][:, :r]
    u = np.asarray(jnp.asarray(u, jnp.bfloat16))           # stored bf16
    lens = np.array(lens, np.int32)
    jc, tc = _layer_cache(jcfg, jsals, rng, b, s, max_seq, g, lens, u)
    w = {k: (rng.standard_normal(shape) * 0.2).astype(np.float32)
         for k, shape in (("wq", (128, cfg.q_dim)), ("wk", (128, cfg.kv_dim)),
                          ("wv", (128, cfg.kv_dim)),
                          ("wo", (cfg.q_dim, 128)))}
    ta = Attention(cfg, torch.float32, "cpu")
    for k, val in w.items():
        getattr(ta, k).data.copy_(torch.from_numpy(val))
    jw = {k: jnp.asarray(val) for k, val in w.items()}
    return dict(jcfg=jcfg, cfg=cfg, jsals=jsals, sals=sals, u=u, lens=lens,
                jc=jc, tc=tc, jw=jw, ta=ta, rng=rng)


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_fold_equals_dense_fold_and_reference(g, ps):
    """The paged fold reads the same logical rows as the dense fold, so
    partials and (union of) touched pages are bitwise equal; both equal
    the reference's grouped partials (its paged "xla" oracle)."""
    e = _attend_setup(g)
    cfg, sals, jcfg, jsals = e["cfg"], e["sals"], e["jcfg"], e["jsals"]
    tp, jp = _page_layer(e["tc"], e["jc"], ps, seed=g + ps)
    rng = e["rng"]
    b = 3
    q0 = rng.standard_normal((b, cfg.n_heads, cfg.head_dim)) \
        .astype(np.float32)
    q_bar = q0.reshape(b, cfg.n_kv_heads, -1, cfg.head_dim).sum(2) \
        .reshape(b, cfg.kv_dim)
    pos = e["lens"]
    tu = tensor_from_numpy(e["u"], "cpu")
    args = (torch.from_numpy(q0), torch.from_numpy(q_bar), tu)
    assert tsa.plan_decode(e["tc"]) == tsa.plan_decode(tp) \
        == tsa.DecodePlan(g)
    dense = tsa._grouped_partials(*args, e["tc"], torch.from_numpy(pos),
                                  cfg, sals)
    paged = tsa._grouped_partials(*args, tp, torch.from_numpy(pos), cfg,
                                  sals, collect=True)
    for a, c in zip(dense, paged[:3]):
        assert torch.equal(a, c)
    jout = jsa._grouped_partials(
        _j(q0), _j(q_bar), _j(e["u"]), jp, _j(pos), jcfg, jsals,
        jsa.DecodePlan(g, "xla"), collect=True)
    for a, c in zip(jout[:3], paged[:3]):
        np.testing.assert_allclose(np.asarray(a), c.numpy(), **TOL)
    np.testing.assert_array_equal(np.asarray(jout[3]), paged[3].numpy())
    # the slabs' union covers exactly the pages of the selected rows
    assert paged[3].shape == (b, 64 // ps) and paged[3][:2].any()
    with pytest.raises(ValueError, match="paged"):
        tsa._grouped_partials(*args, e["tc"], torch.from_numpy(pos), cfg,
                              sals, collect=True)


def _attend_both(e, g, layout, x, pos, window=False):
    jc, tc = e["jc"], e["tc"]
    if layout == "paged":
        tc, jc = _page_layer(tc, jc, 8, seed=g)
    plan = jsa.DecodePlan(g, "xla")
    jfn = jsa.sals_window_attend if window else jsa.sals_decode_attend
    tfn = tsa.sals_window_attend if window else tsa.sals_decode_attend
    jout = jax.jit(lambda p, u_, c, x_, q: jfn(
        p, u_, c, x_, q, e["jcfg"], e["jsals"], plan=plan))(
        e["jw"], _j(e["u"]), jc, _j(x), _j(pos))
    tout = tfn(e["ta"], tensor_from_numpy(e["u"], "cpu"), tc,
               torch.from_numpy(x), torch.from_numpy(pos), e["cfg"],
               e["sals"])
    return jout, tout, jc, tc


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sals_decode_attend_matches_reference(g, layout):
    e = _attend_setup(g)
    x = e["rng"].standard_normal((3, 1, 128)).astype(np.float32)
    (jy, jc2), (ty, tc2), _, _ = _attend_both(e, g, layout, x, e["lens"])
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), **TOL)
    np.testing.assert_array_equal(np.asarray(jc2.lengths),
                                  tc2.lengths.numpy())
    np.testing.assert_array_equal(np.asarray(jc2.v_q), tc2.v_q.numpy())


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sals_window_attend_matches_reference(g, layout):
    e = _attend_setup(g)
    x = e["rng"].standard_normal((3, 4, 128)).astype(np.float32)
    (jy, jk, jv), (ty, tk, tv), _, _ = _attend_both(e, g, layout, x,
                                                    e["lens"], window=True)
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jk), tk.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), **TOL)


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_grouped_window_q1_equals_single_step(g, layout):
    """A Q = 1 verify window is the grouped single step bit for bit (the
    window reads the cache; the single step writes its token first, so the
    window runs on the written cache at the same position)."""
    e = _attend_setup(g, lat_dtype="bfloat16")
    tc = e["tc"]
    if layout == "paged":
        tc, _ = _page_layer(tc, e["jc"], 8, seed=g)
    x = torch.from_numpy(e["rng"].standard_normal((3, 1, 128))
                         .astype(np.float32))
    pos = torch.from_numpy(e["lens"])
    u = tensor_from_numpy(e["u"], "cpu")
    y1, _ = tsa.sals_decode_attend(e["ta"], u, tc, x, pos, e["cfg"],
                                   e["sals"])
    yw, _, _ = tsa.sals_window_attend(e["ta"], u, tc, x, pos, e["cfg"],
                                      e["sals"])
    assert torch.equal(y1, yw)


def test_fold_shares_storage_and_gathers_nothing(monkeypatch):
    """The kernels get views of the arena (shared storage, slab shapes);
    no operand is a gathered (·, k_loc, ·) buffer; the only (B·G, ·)
    tensors made are the per-slab queries, positions and base."""
    e = _attend_setup(4)
    tc, sals, cfg = e["tc"], e["sals"], e["cfg"]
    seen = []
    for name in ("latent_topk", "sparse_recon_attention"):
        fn = getattr(ops, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            seen.append((_name, a))
            return _fn(*a, **kw)

        monkeypatch.setattr(ops, name, spy)
    x = torch.from_numpy(e["rng"].standard_normal((3, 1, 128))
                         .astype(np.float32))
    tsa.sals_decode_attend(e["ta"], tensor_from_numpy(e["u"], "cpu"), tc, x,
                           torch.from_numpy(e["lens"]), cfg, sals)
    (_, topk), (_, recon) = seen
    arena = {f: getattr(tc, f).untyped_storage().data_ptr()
             for f in POOL_FIELDS}
    k_loc = -(-sals.n_critical // 4)
    assert topk[1].shape == (12, 16, sals.rank(cfg.kv_dim))
    assert topk[1].untyped_storage().data_ptr() == arena["k_lat"]
    assert topk[2].untyped_storage().data_ptr() == arena["k_scale"]
    for f, a in zip(POOL_FIELDS, recon[1:6]):
        assert a.shape[:2] == (12, 16), f
        assert a.untyped_storage().data_ptr() == arena[f], f
    for a in (*topk, *recon):
        if torch.is_tensor(a) and a.dim() == 3:
            assert a.shape[1] != k_loc or a.shape[0] != 12


# ---------------------------------------------------------------------------
# on the card: the folded kernels against their twins
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs twin)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("g", [2, 4])
def test_folded_kernels_vs_twin_on_card(cuda, g):
    b, nc, vg, n_kv, dh = 2, 24, 16, 2, 64
    x = _kernel_inputs(50 + g, b, 8, n_kv, dh, 256, 16, 8, True, vg)
    s_loc, k_loc = 256 // g, -(-nc // g)
    base = _t(np.tile(np.arange(g, dtype=np.int32) * s_loc, b))
    kg, ksg, vqg, vsg, vzg = (_fold_np(x[n], g) for n in
                              ("k", "scale", "vq", "vs", "vz"))
    cpu = dict(q_lat=_t(np.repeat(x["q_lat"], g, 0)), k=_t(kg, torch.int8),
               ks=_t(ksg, torch.bfloat16),
               q=_t(np.repeat(x["q"], g, 0)).to(torch.bfloat16),
               vq=_t(vqg), vs=_t(vsg, torch.bfloat16),
               vz=_t(vzg, torch.bfloat16), u=_t(x["u"]).to(torch.bfloat16))
    pos = torch.tensor(200, dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda):
        a = {k: v.to(dev) for k, v in cpu.items()}
        idx, val = ops.latent_topk(a["q_lat"], a["k"], a["ks"], pos.to(dev),
                                   n_critical=k_loc, n_sink=2, n_recent=8,
                                   pos_base=base.to(dev))
        idx, val = tsel.sort_selected(idx, val)
        m, l, o = ops.sparse_recon_attention(
            a["q"], a["k"], a["ks"], a["vq"], a["vs"], a["vz"], a["u"], idx,
            val, pos.to(dev), n_kv=n_kv, v_bits=8, v_group=vg,
            pos_base=base.to(dev))
        out[str(dev)] = [t.cpu() for t in (idx, val, m, l, o)]
    c, k = out["cpu"], out[str(cuda)]
    assert torch.equal(c[0], k[0]) and torch.equal(c[1], k[1])
    for a, b_ in zip(c[2:], k[2:]):
        torch.testing.assert_close(b_, a, rtol=1e-4, atol=1e-4)
