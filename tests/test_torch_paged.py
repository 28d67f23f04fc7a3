"""Port parity for the paged latent cache: the paged kernel twins of
``repro_torch.kernels`` against the JAX reference's xla oracles
(``repro.kernels.ref.latent_topk_paged_ref`` /
``sparse_recon_attention_paged_ref``; the reference's paged Pallas kernels
do not trace in interpret mode on the installed jax), the paged twins
against the dense twins on the same logical contents, and the cache's
paged / chunked / slot-arena writes against ``repro.core.latent_cache``.
Tolerances: top-k indices exact (integer-valued data makes ties
deliberate), m/l/o within 1e-5, cache fields exact (the projector is a
column selection of the identity, so the latent projection is exact).  The
``requires_cuda`` cases hold the paged CUDA kernels against their twins and
bitwise against the dense kernels, and run only where a card exists."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SALSConfig as JSALS
from repro.configs import get_config as jax_get_config
from repro.core import latent_cache as jlc
from repro.kernels import ops as jops
from repro_torch.config import SALSConfig
from repro_torch.configs import get_config
from repro_torch.core import latent_cache as tlc
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("k_lat", "k_scale", "v_q", "v_scale", "v_zero", "sink_k", "sink_v",
          "recent_k", "recent_v", "lengths", "page_table")
JD = {"bf16": jnp.bfloat16, "int8": jnp.int8}
TD = {"bf16": torch.bfloat16, "int8": torch.int8,
      "f32": torch.float32}


def _t(a, dtype=None):
    if dtype is not None:
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
    return torch.from_numpy(np.array(a))


def _j(a, dtype=None):
    return jnp.asarray(a, dtype) if dtype is not None else jnp.asarray(a)


def _f(a):
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(a).astype(np.float32).astype(np.float64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (paged kernel vs twin)")
    return torch.device("cuda")


def _table(rng, b, mp, n_pages, n_live, garbage):
    """(B, mp) int32: each row's first n_live[b] pages distinct, shuffled
    pool pages; the tail holds stale in-pool ids, or (``garbage`` =
    "wild") ids outside the pool too."""
    pt = np.zeros((b, mp), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    at = 0
    for i in range(b):
        pt[i, :n_live[i]] = perm[at:at + n_live[i]]
        at += n_live[i]
        tail = mp - n_live[i]
        if garbage == "wild":
            pt[i, n_live[i]:] = rng.integers(-5, n_pages + 9, tail)
        else:
            pt[i, n_live[i]:] = rng.integers(0, n_pages, tail)
    return pt


def _paged_inputs(seed, ps, lat_dtype, v_bits, garbage="stale", b=3, mp=4,
                  r=32, r_star=16, n_kv=2, dh=16, n_c=12):
    rng = np.random.default_rng(seed)
    n_pages = b * mp + 3
    s = mp * ps
    kvd = n_kv * dh
    n_live = [mp, mp - 1, 1]
    pt = _table(rng, b, mp, n_pages, n_live, garbage)
    q_lat = rng.integers(-2, 3, (b, r_star)).astype(np.float32)
    lat = rng.integers(-2, 3, (n_pages, ps, r)).astype(np.float32)
    scale = None
    if lat_dtype == "int8":
        lat = lat.astype(np.int8)
        scale = (rng.integers(1, 4, (n_pages, ps)) * 0.25).astype(np.float32)
    code_w = kvd if v_bits == 8 else kvd // 2
    vq = (rng.integers(-128, 128, (n_pages, ps, code_w)).astype(np.int8)
          if v_bits == 8 else
          rng.integers(0, 256, (n_pages, ps, code_w)).astype(np.uint8))
    g = kvd // 16
    vs = (rng.random((n_pages, ps, g)) * 0.05).astype(np.float32)
    vz = rng.standard_normal((n_pages, ps, g)).astype(np.float32)
    # ragged decode positions inside each row's live pages
    pos = np.array([n * ps - 1 - i for i, n in enumerate(n_live)], np.int32)
    q = rng.standard_normal((b, 4, dh)).astype(np.float32)
    u = (rng.standard_normal((kvd, r)) * r ** -0.5).astype(np.float32)
    idx = np.zeros((b, n_c), np.int32)
    valid = np.zeros((b, n_c), bool)
    for i in range(b):
        k = min(n_c, max(0, int(pos[i]) - 4))
        idx[i, :k] = np.sort(rng.choice(int(pos[i]) - 3, k, replace=False))
        idx[i, k:] = rng.integers(0, s, n_c - k)
        valid[i, :k] = True
    return dict(pt=pt, q_lat=q_lat, lat=lat, scale=scale, vq=vq, vs=vs,
                vz=vz, pos=pos, q=q, u=u, idx=idx, valid=valid, ps=ps,
                n_kv=n_kv, v_bits=v_bits, lat_dtype=lat_dtype)


def _torch_args(d):
    sc = None if d["scale"] is None else _t(d["scale"], torch.bfloat16)
    return dict(q_lat=_t(d["q_lat"]), lat=_t(d["lat"], TD[d["lat_dtype"]]),
                scale=sc, vq=_t(d["vq"]), vs=_t(d["vs"], torch.bfloat16),
                vz=_t(d["vz"], torch.bfloat16), q=_t(d["q"]),
                u=_t(d["u"], torch.bfloat16), idx=_t(d["idx"]),
                valid=_t(d["valid"]), pos=_t(d["pos"]), pt=_t(d["pt"]))


TOPK_KW = dict(n_critical=12, n_sink=2, n_recent=4)


def _topk(a, page_table):
    return ops.latent_topk(a["q_lat"], a["lat"], a["scale"], a["pos"],
                           page_table=page_table, page_size=a["ps"],
                           **TOPK_KW)


def _sra(a, page_table, d):
    return ops.sparse_recon_attention(
        a["q"], a["lat"], a["scale"], a["vq"], a["vs"], a["vz"], a["u"],
        a["idx"], a["valid"], a["pos"], page_table=page_table,
        page_size=a["ps"], n_kv=d["n_kv"], v_bits=d["v_bits"], v_group=16)


@pytest.mark.parametrize("ps", [8, 16, 64])
@pytest.mark.parametrize("lat_dtype,v_bits", [("bf16", 8), ("int8", 4)])
def test_paged_twins_match_reference(ps, lat_dtype, v_bits):
    d = _paged_inputs(ps, ps, lat_dtype, v_bits)
    a = dict(_torch_args(d), ps=ps)
    js = None if d["scale"] is None else _j(d["scale"], jnp.bfloat16)
    ji, jv = jops.latent_topk(
        _j(d["q_lat"]), _j(d["lat"], JD[lat_dtype]), js, _j(d["pos"]),
        page_table=_j(d["pt"]), page_size=ps, backend="xla", **TOPK_KW)
    ti, tv = _topk(a, a["pt"])
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())

    j = jops.sparse_recon_attention(
        _j(d["q"]), _j(d["lat"], JD[lat_dtype]), js, _j(d["vq"]),
        _j(d["vs"], jnp.bfloat16), _j(d["vz"], jnp.bfloat16),
        _j(d["u"], jnp.bfloat16), _j(d["idx"]), _j(d["valid"]),
        _j(d["pos"]), page_table=_j(d["pt"]), page_size=ps, n_kv=d["n_kv"],
        v_bits=v_bits, v_group=16, backend="xla")
    t = _sra(a, a["pt"], d)
    for x, y in zip(j, t):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), **TOL)


@pytest.mark.parametrize("ps", [8, 64])
def test_paged_twin_equals_dense_twin(ps):
    """Same logical contents, table tails holding ids outside the pool:
    the paged twins give the dense twins' outputs exactly."""
    d = _paged_inputs(40 + ps, ps, "int8", 8, garbage="wild")
    a = dict(_torch_args(d), ps=ps)
    view = {k: None if a[k] is None else
            ref.paged_logical_view(a[k], a["pt"], ps)
            for k in ("lat", "scale", "vq", "vs", "vz")}
    dense = dict(a, **view)
    for x, y in zip(_topk(a, a["pt"]), _topk(dense, None)):
        assert torch.equal(x, y)
    for x, y in zip(_sra(a, a["pt"], d), _sra(dense, None, d)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# cache writes: append_chunk, paged write, prefill_into_slot, free_slot
# ---------------------------------------------------------------------------

def _setup(lat_dtype, v_bits, seed=2):
    jcfg = jax_get_config("yi-9b").reduced(n_layers=3)
    cfg = get_config("yi-9b").reduced(n_layers=3)
    kw = dict(n_critical=8, n_sink=3, n_recent=8, v_bits=v_bits, v_group=16,
              k_latent_dtype=lat_dtype)
    rng = np.random.default_rng(seed)
    kvd, r = cfg.kv_dim, SALSConfig(**kw).rank(cfg.kv_dim)
    u = np.eye(kvd, dtype=np.float32)[:, rng.permutation(kvd)[:r]]
    return jcfg, cfg, JSALS(**kw), SALSConfig(**kw), u, rng


def _assert_same(jc, tc):
    for name in FIELDS:
        ja, ta = getattr(jc, name), getattr(tc, name)
        assert (ja is None) == (ta is None), name
        if ja is not None:
            assert tuple(ja.shape) == tuple(ta.shape), name
            np.testing.assert_array_equal(_f(ja), _f(ta), err_msg=name)


def _kv(rng, cfg, *lead):
    k = rng.standard_normal((*lead, cfg.n_kv_heads, cfg.head_dim)) \
        .astype(np.float32)
    return k, rng.standard_normal(k.shape).astype(np.float32)


@pytest.mark.parametrize("lat_dtype,v_bits", [("bfloat16", 8), ("int8", 4)])
def test_append_chunk(lat_dtype, v_bits):
    """Three 8-token chunks of a ragged batch (true lengths 20, 11, 2):
    latents, codes, ring, sink and lengths after every chunk."""
    jcfg, cfg, jsals, sals, u, rng = _setup(lat_dtype, v_bits)
    b, c, max_seq = 3, 8, 32
    lens = np.array([20, 11, 2], np.int32)
    jc = jlc.LatentKVCache.init(jcfg, jsals, 1, b, max_seq).layer_view(0)
    stack = tlc.LatentKVCache.init(cfg, sals, 1, b, max_seq, device="cpu")
    tc = stack.layer_view(0)
    for off in (0, 8, 16):
        k, v = _kv(rng, cfg, b, c)
        jc = jc.append_chunk(jcfg, jsals, jnp.asarray(u), off,
                             jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lens))
        out = tc.append_chunk(cfg, sals, torch.from_numpy(u), off,
                              torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(lens))
        assert out is tc
        _assert_same(jc, tc)
    assert stack.lengths.tolist() == [[20, 11, 2]]     # wrote through


@pytest.mark.parametrize("lat_dtype,v_bits", [("bfloat16", 8), ("int8", 4)])
def test_paged_write_resolves_pages(lat_dtype, v_bits):
    """Decode writes through a shuffled page table (an idle row's table row
    is 0: its write lands in the trash page)."""
    jcfg, cfg, jsals, sals, u, rng = _setup(lat_dtype, v_bits)
    b, ps, max_seq, n_pages = 3, 4, 16, 10
    pt = np.zeros((1, b, max_seq // ps), np.int32)
    pt[0, 0] = [7, 2, 9, 4]
    pt[0, 1, :2] = [3, 8]
    jc = jlc.LatentKVCache.init_paged(jcfg, jsals, 1, b, max_seq, n_pages,
                                      ps)
    jc = jc.replace(page_table=jnp.asarray(pt)).layer_view(0)
    stack = tlc.LatentKVCache.init_paged(cfg, sals, 1, b, max_seq, n_pages,
                                         ps, device="cpu")
    stack.page_table.copy_(torch.from_numpy(pt))
    tc = stack.layer_view(0)
    _assert_same(jc, tc)
    for pos in ([5, 2, 0], [13, 7, 0]):
        pos = np.array(pos, np.int32)
        k, v = _kv(rng, cfg, b)
        lat = k.reshape(b, -1) @ u
        jc = jc.write(jsals, jnp.asarray(pos), jnp.asarray(lat),
                      jnp.asarray(v.reshape(b, -1)), jnp.asarray(k),
                      jnp.asarray(v))
        tc.write(sals, torch.from_numpy(pos), torch.from_numpy(lat),
                 torch.from_numpy(v.reshape(b, -1)), torch.from_numpy(k),
                 torch.from_numpy(v))
        _assert_same(jc, tc)
    assert float(stack.k_lat[0, 4, 1].abs().float().sum()) > 0  # 13: page 4


def test_prefill_into_slot_and_free_slot():
    jcfg, cfg, jsals, sals, u, rng = _setup("int8", 8)
    layers, b, max_seq = 2, 3, 16
    jarena = jlc.LatentKVCache.init(jcfg, jsals, layers, b, max_seq)
    tarena = tlc.LatentKVCache.init(cfg, sals, layers, b, max_seq,
                                    device="cpu")
    one_t = tlc.LatentKVCache.init(cfg, sals, layers, 1, max_seq,
                                   device="cpu")
    fill = {}
    for name in FIELDS:
        arr = getattr(one_t, name)
        if arr is None:
            continue
        if arr.dtype in (torch.int8, torch.uint8, torch.int32):
            vals = rng.integers(0, 100, arr.shape)
        else:
            vals = rng.standard_normal(arr.shape)
        fill[name] = vals.astype(np.float32)
        arr.copy_(torch.from_numpy(fill[name]).to(arr.dtype))
    jd = {torch.int8: jnp.int8, torch.uint8: jnp.uint8,
          torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16}
    jone = jlc.LatentKVCache.init(jcfg, jsals, layers, 1, max_seq).replace(
        **{k: jnp.asarray(v, jd[getattr(one_t, k).dtype])
           for k, v in fill.items()})
    jarena = jarena.prefill_into_slot(1, jone)
    assert tarena.prefill_into_slot(1, one_t) is tarena
    _assert_same(jarena, tarena)
    jarena = jarena.free_slot(1)
    tarena.free_slot(1)
    _assert_same(jarena, tarena)
    assert float(tarena.k_lat[:, 1].abs().sum()) > 0      # metadata only

    # paged: the slot's length and page-table row reset
    jp = jlc.LatentKVCache.init_paged(jcfg, jsals, layers, b, max_seq, 9, 4)
    tp = tlc.LatentKVCache.init_paged(cfg, sals, layers, b, max_seq, 9, 4,
                                      device="cpu")
    pt = rng.integers(1, 9, (layers, b, max_seq // 4)).astype(np.int32)
    lens = rng.integers(1, 16, (layers, b)).astype(np.int32)
    jp = jp.replace(page_table=jnp.asarray(pt), lengths=jnp.asarray(lens))
    tp.page_table.copy_(torch.from_numpy(pt))
    tp.lengths.copy_(torch.from_numpy(lens))
    _assert_same(jp.free_slot(2), tp.free_slot(2))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.requires_cuda
@pytest.mark.parametrize("ps,lat_dtype,v_bits", [(8, "bf16", 8),
                                                 (64, "int8", 4),
                                                 (16, "f32", 8),
                                                 (16, "bf16", 4)])
def test_paged_kernels_vs_twin_and_dense_kernel(cuda, ps, lat_dtype, v_bits):
    d = _paged_inputs(60 + ps, ps, lat_dtype, v_bits, garbage="wild")
    a = dict(_torch_args(d), ps=ps)
    g = {k: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
         for k, v in a.items()}
    view = {k: None if g[k] is None else
            ref.paged_logical_view(g[k], g["pt"], ps).contiguous()
            for k in ("lat", "scale", "vq", "vs", "vz")}
    dense = dict(g, **view)
    ti, tv = _topk(a, a["pt"])
    ci, cv = _topk(g, g["pt"])
    di, dv = _topk(dense, None)
    assert torch.equal(cv.cpu(), tv) and torch.equal(ci.cpu(), ti)
    assert torch.equal(ci, di) and torch.equal(cv, dv)
    t = _sra(a, a["pt"], d)
    c = _sra(g, g["pt"], d)
    dd = _sra(dense, None, d)
    for x, y, z in zip(c, t, dd):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-4, atol=1e-4)
        assert torch.equal(x, z)
