"""Port parity: the plain PyTorch twins of the three ported kernels against
the JAX reference — its ``ref`` oracles (backend "xla") and its Pallas
kernels in interpret mode (backend "pallas") — on the same seeded numpy
inputs.  Tolerances: f32 outputs allclose(rtol=1e-5, atol=1e-5); top-k
indices exact (integer-valued inputs make ties deliberate and every score
exact).  The ``requires_cuda`` cases hold each CUDA kernel against its twin
and run only where a card exists."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, dtype=None):
    """numpy -> torch, via f32 for bf16 (exact)."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _j(a, dtype=None):
    return jnp.asarray(a, dtype) if dtype is not None else jnp.asarray(a)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs twin)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# latent_topk
# ---------------------------------------------------------------------------

def _topk_inputs(seed, b, s, r, r_star, lat_dtype, integer):
    rng = np.random.default_rng(seed)
    if integer:
        q = rng.integers(-2, 3, (b, r_star)).astype(np.float32)
        k = rng.integers(-2, 3, (b, s, r)).astype(np.float32)
    else:
        q = rng.standard_normal((b, r_star)).astype(np.float32)
        k = rng.standard_normal((b, s, r)).astype(np.float32)
    scale = None
    if lat_dtype == "int8":
        k = np.clip(np.round(k * (1 if integer else 20)), -127, 127) \
            .astype(np.int8)
        scale = (rng.integers(1, 4, (b, s)) * 0.25).astype(np.float32)
    return q, k, scale


def _topk_both(q, k, scale, pos, base, lat_dtype, backend, **kw):
    jd = {"bf16": jnp.bfloat16, "int8": jnp.int8, "f32": jnp.float32}
    td = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}
    j_out = jops.latent_topk(
        _j(q), _j(k, jd[lat_dtype]),
        None if scale is None else _j(scale, jnp.bfloat16), _j(pos),
        pos_base=None if base is None else _j(base), backend=backend, **kw)
    t_out = ops.latent_topk(
        _t(q), _t(k, td[lat_dtype]),
        None if scale is None else _t(scale, torch.bfloat16), _t(pos),
        pos_base=None if base is None else _t(base), **kw)
    return [np.asarray(a) for a in j_out], [a.numpy() for a in t_out]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("lat_dtype,integer,ragged,with_base", [
    ("bf16", True, True, False),
    ("int8", True, True, True),
    ("f32", True, False, False),
])
def test_latent_topk_exact(backend, lat_dtype, integer, ragged, with_base):
    b, s, r, r_star = 3, 96, 32, 16
    q, k, scale = _topk_inputs(5, b, s, r, r_star, lat_dtype, integer)
    pos = np.array([95, 60, 20] if ragged else [95] * b, np.int32)
    base = np.array([0, 32, 64], np.int32) if with_base else None
    kw = dict(n_critical=16, n_sink=2, n_recent=8)
    (ji, jv), (ti, tv) = _topk_both(q, k, scale, pos, base, lat_dtype,
                                    backend, **kw)
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(np.where(jv, ji, 0), np.where(tv, ti, 0))
    if backend == "xla":           # the oracle's invalid slots too
        np.testing.assert_array_equal(ji, ti)


def test_latent_topk_all_invalid_and_block_merge():
    """A row with nothing selectable, and a cache longer than one 1024-token
    block (candidates merged across blocks), against the Pallas kernel."""
    b, s, r, r_star = 2, 1100, 16, 8
    q, k, scale = _topk_inputs(6, b, s, r, r_star, "bf16", True)
    pos = np.array([1099, 50], np.int32)
    kw = dict(n_critical=24, n_sink=16, n_recent=64)
    (ji, jv), (ti, tv) = _topk_both(q, k, scale, pos, None, "bf16", "pallas",
                                    **kw)
    assert not tv[1].any()
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(np.where(jv, ji, 0), np.where(tv, ti, 0))


def test_latent_topk_random_near_ties_compare_scores():
    """Random inputs: where two scores differ by < 1e-5 the chosen index may
    differ, so compare the selected scores instead."""
    b, s, r, r_star = 2, 200, 32, 16
    q, k, _ = _topk_inputs(7, b, s, r, r_star, "f32", False)
    pos = np.array([199, 150], np.int32)
    kw = dict(n_critical=20, n_sink=4, n_recent=8)
    (ji, jv), (ti, tv) = _topk_both(q, k, None, pos, None, "f32", "xla", **kw)
    np.testing.assert_array_equal(jv, tv)
    scores = np.einsum("br,bsr->bs", q, k[..., :r_star])
    np.testing.assert_allclose(np.take_along_axis(scores, ji, 1) * jv,
                               np.take_along_axis(scores, ti, 1) * tv, **TOL)


def _paged_table(rng, b, s, ps, live):
    """A shuffled (B, S/ps) page table over a pool with spare pages; each
    row's unmapped tail holds ids outside the pool (clamped by the kernel,
    kept unselectable by the position mask)."""
    mp = s // ps
    n_pages = b * mp + 5
    perm = rng.permutation(n_pages)
    pt = rng.integers(-30, n_pages + 30, (b, mp)).astype(np.int32)
    at = 0
    for i in range(b):
        n = -(-min(s, live[i]) // ps)
        pt[i, :n] = perm[at:at + n]
        at += n
    return pt, n_pages


# (b, s, r, r*, N_c, latents, pos, pos_base, zero query, page size)
_TOPK_KERNEL_CASES = {
    "base": (3, 2100, 64, 32, 100, "bf16", [2099, 1500, 40], None, False, 0),
    "all scores equal": (2, 1500, 64, 32, 100, "bf16", [1499, 900], None,
                         True, 0),
    "fewer selectable than N_c": (2, 1500, 64, 32, 100, "bf16", [150, 90],
                                  None, False, 0),
    "S < N_c": (2, 60, 64, 32, 100, "int8", [59, 40], None, False, 0),
    "B 1": (1, 2100, 64, 32, 100, "bf16", [2099], None, False, 0),
    "f32 r* 500": (2, 700, 512, 500, 64, "f32", [699, 500], None, False, 0),
    "bf16 r* 500 (element loads)": (2, 700, 512, 500, 64, "bf16",
                                    [699, 500], None, False, 0),
    "tiered pool r = r*": (2, 1500, 32, 32, 100, "bf16", [1499, 900], None,
                           False, 0),
    "pos_base": (3, 1500, 64, 32, 100, "int8", [1499, 2000, 2600],
                 [0, 512, 1024], False, 0),
    "S > 8192": (2, 9000, 32, 16, 300, "bf16", [8999, 6000], None, False, 0),
    "N_c 20": (2, 1500, 64, 32, 20, "bf16", [1499, 900], None, False, 0),
    "N_c 700 > 512": (2, 1500, 64, 32, 700, "bf16", [1499, 900], None, False,
                      0),
    "paged 8": (3, 1024, 64, 32, 100, "bf16", [1023, 700, 300], None, False,
                8),
    "paged 16 pos_base": (3, 1024, 64, 32, 100, "int8", [1023, 900, 700],
                          [0, 64, 128], False, 16),
    "paged 64": (2, 2048, 64, 32, 100, "bf16", [2047, 1100], None, False,
                 64),
    # paligemma-3b: kv_dim 256 (one kv head), SALS-25% r 64, r* 32
    "paligemma r64 r*32 N_c 432": (4, 4160, 64, 32, 432, "bf16",
                                   [4159, 3647, 3135, 2623], None, False, 0),
    "paligemma r64 r*32 paged 64": (4, 4096, 64, 32, 432, "bf16",
                                    [4095, 3583, 3071, 2559], None, False,
                                    64),
}


# The dense edge cases the kernel test pins exactly, held here against the
# reference, invalid slots included.  The xla oracle's ``lax.top_k`` refuses
# N_c > S, so "S < N_c" (padding with (NEG_INF, index 0)) is held against
# the Pallas kernel only.
_TOPK_EDGE_VS_REFERENCE = [
    (case, backend)
    for case in ("all scores equal", "fewer selectable than N_c", "S < N_c",
                 "N_c 700 > 512")
    for backend in ("xla", "pallas")
    if not (case == "S < N_c" and backend == "xla")]


@pytest.mark.parametrize("case,backend", _TOPK_EDGE_VS_REFERENCE)
def test_latent_topk_edge_cases_vs_reference(case, backend):
    """The twin's tie order, padding and invalid-slot indices on the
    kernel test's edge cases equal the reference's, so the kernel is pinned
    to the reference's contract and not only to the twin's."""
    b, s, r, r_star, n_c, lat, pos, base, zero_q, ps = \
        _TOPK_KERNEL_CASES[case]
    assert ps == 0 and base is None
    q, k, scale = _topk_inputs(8, b, s, r, r_star, lat, True)
    if zero_q:
        q = np.zeros_like(q)
    (ji, jv), (ti, tv) = _topk_both(q, k, scale, np.array(pos, np.int32),
                                    None, lat, backend, n_critical=n_c,
                                    n_sink=16, n_recent=64)
    assert ti.shape == (b, n_c)
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(ji, ti)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(_TOPK_KERNEL_CASES))
def test_latent_topk_kernel_vs_twin(cuda, case):
    """The score pass + selection against the twin: exact indices and
    validity (integer-valued inputs: ties are deliberate), invalid slots
    too; paged kernels also bit for bit the dense kernel on the same
    logical contents; r = r* (a tiered score pool) selects as the same
    columns inside a wider cache."""
    b, s, r, r_star, n_c, lat, pos, base, zero_q, ps = \
        _TOPK_KERNEL_CASES[case]
    rng = np.random.default_rng(8)
    pt = None
    if ps:
        live = [p + 1 - (0 if base is None else base[i])
                for i, p in enumerate(pos)]
        pt, n_pages = _paged_table(rng, b, s, ps, live)
        q, k, scale = _topk_inputs(8, 1, n_pages * ps, r, r_star, lat, True)
        k = k.reshape(n_pages, ps, r)
        scale = None if scale is None else scale.reshape(n_pages, ps)
        q = rng.integers(-2, 3, (b, r_star)).astype(np.float32)
    else:
        q, k, scale = _topk_inputs(8, b, s, r, r_star, lat, True)
    if zero_q:
        q = np.zeros_like(q)
    td = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}
    qt, kt = _t(q), _t(k, td[lat])
    st = None if scale is None else _t(scale, torch.bfloat16)
    kw = dict(n_critical=n_c, n_sink=16, n_recent=64,
              pos_base=None if base is None else torch.tensor(
                  base, dtype=torch.int32))
    pos = torch.tensor(pos, dtype=torch.int32)
    pg = {} if pt is None else dict(page_table=torch.from_numpy(pt),
                                    page_size=ps)

    def on(dev, x):
        return None if x is None else x.to(dev)

    ti, tv = ops.latent_topk(qt, kt, st, pos, **kw, **pg)
    dkw = {**kw, "pos_base": on(cuda, kw["pos_base"])}
    dpg = {k_: on(cuda, v) if k_ == "page_table" else v
           for k_, v in pg.items()}
    ci, cv = ops.latent_topk(qt.to(cuda), kt.to(cuda), on(cuda, st),
                             pos.to(cuda), **dkw, **dpg)
    assert torch.equal(cv.cpu(), tv)
    assert torch.equal(ci.cpu(), ti)
    if pt is not None:
        view = ref.paged_logical_view
        di, dv = ops.latent_topk(
            qt.to(cuda), view(kt, pg["page_table"], ps).contiguous().to(cuda),
            None if st is None else view(st, pg["page_table"], ps)
            .contiguous().to(cuda), pos.to(cuda), **dkw)
        assert torch.equal(di, ci) and torch.equal(dv, cv)
    if r == r_star:
        wide = torch.cat([kt, torch.ones_like(kt)], dim=-1)
        wi, wv = ops.latent_topk(qt.to(cuda), wide.to(cuda), on(cuda, st),
                                 pos.to(cuda), **dkw, **dpg)
        assert torch.equal(wi, ci) and torch.equal(wv, cv)


# ---------------------------------------------------------------------------
# sparse_recon_attention
# ---------------------------------------------------------------------------

def _sra_inputs(seed, b, h, n_kv, dh, s, r, n_c, lat_dtype, v_bits,
                ragged=True):
    rng = np.random.default_rng(seed)
    kvd = n_kv * dh
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    lat = rng.standard_normal((b, s, r)).astype(np.float32)
    scale = None
    if lat_dtype == "int8":
        lat = np.clip(np.round(lat * 30), -127, 127).astype(np.int8)
        scale = (rng.integers(1, 5, (b, s)) / 64).astype(np.float32)
    code_w = kvd if v_bits == 8 else kvd // 2
    if v_bits == 8:
        vq = rng.integers(-128, 128, (b, s, code_w)).astype(np.int8)
    else:
        vq = rng.integers(0, 256, (b, s, code_w)).astype(np.uint8)
    g = kvd // 16
    vs = (rng.random((b, s, g)) * 0.05).astype(np.float32)
    vz = rng.standard_normal((b, s, g)).astype(np.float32)
    u = (rng.standard_normal((kvd, r)) * r ** -0.5).astype(np.float32)
    idx = np.zeros((b, n_c), np.int32)
    valid = np.zeros((b, n_c), bool)
    counts = [n_c, n_c // 2, 0] if ragged else [n_c] * b
    for i in range(b):
        sel = np.sort(rng.choice(s, counts[i], replace=False))
        idx[i, :counts[i]] = sel
        idx[i, counts[i]:] = rng.integers(0, s, n_c - counts[i])
        valid[i, :counts[i]] = True
    q_pos = np.array([s - 1, s - 7, s - 30][:b], np.int32)
    return q, lat, scale, vq, vs, vz, u, idx, valid, q_pos


def _sra_both(inputs, lat_dtype, backend, pos_base=None, **kw):
    q, lat, scale, vq, vs, vz, u, idx, valid, q_pos = inputs
    jl = {"bf16": jnp.bfloat16, "int8": jnp.int8}[lat_dtype]
    tlat = {"bf16": torch.bfloat16, "int8": torch.int8}[lat_dtype]
    j = jops.sparse_recon_attention(
        _j(q), _j(lat, jl), None if scale is None else _j(scale, jnp.bfloat16),
        _j(vq), _j(vs, jnp.bfloat16), _j(vz, jnp.bfloat16),
        _j(u, jnp.bfloat16), _j(idx), _j(valid), _j(q_pos),
        pos_base=None if pos_base is None else _j(pos_base), backend=backend,
        **kw)
    t = ops.sparse_recon_attention(
        _t(q), _t(lat, tlat),
        None if scale is None else _t(scale, torch.bfloat16), _t(vq),
        _t(vs, torch.bfloat16), _t(vz, torch.bfloat16),
        _t(u, torch.bfloat16), _t(idx), _t(valid), _t(q_pos),
        pos_base=None if pos_base is None else _t(pos_base), **kw)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("h,n_kv,lat_dtype,v_bits,softcap,with_base", [
    (4, 4, "bf16", 8, 0.0, False),      # MHA
    (4, 2, "int8", 8, 0.0, True),       # GQA, int8 latents, pos_base
    (8, 2, "bf16", 4, 20.0, False),     # GQA group 4, int4 values, softcap
])
def test_sparse_recon_attention(backend, h, n_kv, lat_dtype, v_bits, softcap,
                                with_base):
    inputs = _sra_inputs(11, 3, h, n_kv, 16, 64, 16, 12, lat_dtype, v_bits)
    base = np.array([0, 100, 7], np.int32) if with_base else None
    (jm, jl, jo), (tm, tl, to) = _sra_both(
        inputs, lat_dtype, backend, pos_base=base, n_kv=n_kv, v_bits=v_bits,
        v_group=16, theta=10_000.0, softcap=softcap)
    np.testing.assert_allclose(jm, tm, **TOL)
    np.testing.assert_allclose(jl, tl, **TOL)
    np.testing.assert_allclose(jo, to, **TOL)
    # the all-invalid row (prompt shorter than n_sink + n_recent)
    assert (tm[2] == ref.NEG_INF).all() and (tl[2] == 0).all() \
        and (to[2] == 0).all()


@pytest.mark.requires_cuda
def test_sparse_recon_attention_kernel_vs_twin(cuda):
    inputs = _sra_inputs(12, 3, 8, 2, 64, 300, 64, 40, "int8", 4)
    q, lat, scale, vq, vs, vz, u, idx, valid, q_pos = inputs
    args = [_t(q), _t(lat, torch.int8), _t(scale, torch.bfloat16), _t(vq),
            _t(vs, torch.bfloat16), _t(vz, torch.bfloat16),
            _t(u, torch.bfloat16), _t(idx), _t(valid), _t(q_pos)]
    kw = dict(n_kv=2, v_bits=4, v_group=16, softcap=20.0)
    tm, tl, to = ops.sparse_recon_attention(*args, **kw)
    cm, cl, co = ops.sparse_recon_attention(*[a.to(cuda) for a in args],
                                            **kw)
    torch.testing.assert_close(cm.cpu(), tm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cl.cpu(), tl, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(co.cpu(), to, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("sq,sk,h,hkv,softcap", [
    (40, 40, 4, 4, 0.0),
    (24, 56, 4, 2, 0.0),        # Sq < Sk (decode-style alignment), GQA
    (33, 33, 4, 1, 25.0),       # MQA, softcap, ragged block edge
])
def test_flash_attention(backend, sq, sk, h, hkv, softcap):
    _flash_both(backend, sq, sk, h, hkv, softcap, causal=True, dh=16)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("sq,sk,h,hkv,softcap,causal,dh", [
    (40, 72, 4, 2, 0.0, False, 16),     # non-causal, Sq < Sk, GQA
    (33, 33, 4, 1, 25.0, False, 64),    # non-causal dh 64, MQA, softcap
    (24, 56, 4, 2, 0.0, True, 64),      # causal dh 64, Sq < Sk
    (1, 37, 2, 1, 0.0, True, 128),      # one query, dh 128
])
def test_flash_attention_shape_classes(backend, sq, sk, h, hkv, softcap,
                                       causal, dh):
    """The shape classes the CUDA kernel's own cases cover (non-causal,
    dh 64 and 128, a single query): the twin against the JAX reference."""
    _flash_both(backend, sq, sk, h, hkv, softcap, causal=causal, dh=dh)


def _flash_both(backend, sq, sk, h, hkv, softcap, *, causal, dh):
    rng = np.random.default_rng(13)
    q = rng.standard_normal((2, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((2, sk, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((2, sk, hkv, dh)).astype(np.float32)
    kk, vv = np.repeat(k, h // hkv, 2), np.repeat(v, h // hkv, 2)
    if backend == "pallas":
        from repro.kernels.flash_attention import flash_attention_pallas
        jo = flash_attention_pallas(_j(q), _j(kk), _j(vv), causal=causal,
                                    softcap=softcap)
    else:
        jo = jops.flash_attention(_j(q), _j(kk), _j(vv), causal=causal,
                                  softcap=softcap, backend=backend)
    to = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             softcap=softcap)
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), **TOL)


def test_flash_attention_prefix_lm_not_ported():
    """Ported since the vlm slice (the name is the older check's): a
    prefix no longer raises, and, as in the reference's Pallas kernel, it
    turns the causal mask on — causal=False with a prefix equals
    causal=True with it, and differs from plain non-causal attention."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((1, 6, 2, 16))
                         .astype(np.float32))
    a = ops.flash_attention(x, x, x, causal=False, prefix_len=2)
    b = ops.flash_attention(x, x, x, causal=True, prefix_len=2)
    c = ops.flash_attention(x, x, x, causal=False)
    assert torch.equal(a, b) and not torch.allclose(a, c)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("sq,sk,h,hkv,dh,prefix", [
    (40, 40, 4, 1, 64, 16),      # MQA, prefix inside the sequence
    (24, 56, 4, 2, 64, 20),      # Sq < Sk (decode-style alignment), GQA
    (64, 64, 2, 1, 256, 48),     # dh 256 MQA: paligemma's head shape
    (33, 33, 4, 1, 256, 40),     # prefix past the end: all bidirectional
])
def test_flash_attention_prefix_lm(backend, sq, sk, h, hkv, dh, prefix):
    """The prefix-LM twin (keys below ``prefix_len`` visible to every
    query, the rest causal) against ``flash_attention_pallas(...,
    prefix_len=P, causal=False)`` in interpret mode and against the
    reference's ``ops.flash_attention`` (its materialized mask), within
    the reference's own 2e-5."""
    rng = np.random.default_rng(dh + prefix)
    q = rng.standard_normal((2, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((2, sk, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((2, sk, hkv, dh)).astype(np.float32)
    kk, vv = np.repeat(k, h // hkv, 2), np.repeat(v, h // hkv, 2)
    if backend == "pallas":
        from repro.kernels.flash_attention import flash_attention_pallas
        jo = flash_attention_pallas(_j(q), _j(kk), _j(vv), causal=False,
                                    prefix_len=prefix)
    else:
        jo = jops.flash_attention(_j(q), _j(kk), _j(vv), causal=False,
                                  prefix_len=prefix, backend=backend)
    to = ops.flash_attention(_t(q), _t(k), _t(v), causal=False,
                             prefix_len=prefix)
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.requires_cuda
def test_flash_attention_kernel_vs_twin(cuda):
    rng = np.random.default_rng(14)
    q = _t(rng.standard_normal((2, 100, 4, 64)).astype(np.float32),
           torch.bfloat16)
    k = _t(rng.standard_normal((2, 130, 2, 64)).astype(np.float32),
           torch.bfloat16)
    v = _t(rng.standard_normal((2, 130, 2, 64)).astype(np.float32),
           torch.bfloat16)
    to = ops.flash_attention(q.float(), k.float(), v.float(), causal=True,
                             softcap=30.0)
    co = ops.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), causal=True,
                             softcap=30.0)
    # per (b, q, h) row: worst |error| within 2 bf16 ulps of the row's
    # largest output
    diff = (co.cpu().float() - to).abs().amax(-1)
    assert float((diff / to.abs().amax(-1)).max()) <= 2.0 ** -7


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dh,b,sq,sk,h,hkv,softcap,causal", [
    (64, 2, 300, 300, 4, 1, 0.0, True),      # MQA, Sq not a multiple of 128
    (128, 1, 200, 520, 8, 2, 0.0, True),     # GQA, Sq < Sk
    (128, 2, 129, 129, 4, 4, 30.0, True),    # softcap, one row past a tile
    (64, 1, 100, 333, 4, 2, 0.0, False),     # non-causal, ragged Sk
    (128, 1, 256, 256, 2, 2, 0.0, False),
    (64, 1, 1, 77, 2, 1, 0.0, True),         # one query at the end
])
def test_flash_attention_kernel_cases(cuda, dh, b, sq, sk, h, hkv, softcap,
                                      causal):
    """Every shape class of the TMA + wgmma kernel against the f32 twin:
    per-row error within 2 bf16 ulps of the row's largest output."""
    rng = np.random.default_rng(dh + sq + sk)
    q = _t(rng.standard_normal((b, sq, h, dh)).astype(np.float32),
           torch.bfloat16)
    k = _t(rng.standard_normal((b, sk, hkv, dh)).astype(np.float32),
           torch.bfloat16)
    v = _t(rng.standard_normal((b, sk, hkv, dh)).astype(np.float32),
           torch.bfloat16)
    to = ops.flash_attention(q.float(), k.float(), v.float(), causal=causal,
                             softcap=softcap)
    co = ops.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             causal=causal, softcap=softcap)
    diff = (co.cpu().float() - to).abs().amax(-1)
    assert float((diff / to.abs().amax(-1)).max()) <= 2.0 ** -7


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dh,b,sq,sk,h,hkv,causal,prefix", [
    (256, 2, 300, 300, 8, 1, True, 0),       # dh 256 MQA, 64-key tiles
    (256, 1, 100, 333, 4, 2, False, 0),      # dh 256 non-causal, ragged Sk
    (256, 2, 300, 300, 8, 1, True, 100),     # paligemma: MQA with a prefix
    (128, 1, 200, 200, 4, 2, True, 64),      # prefix of half a tile
    (64, 1, 130, 330, 4, 2, True, 250),      # Sq < Sk, prefix past q_off
])
def test_flash_attention_kernel_prefix_and_dh256(cuda, dh, b, sq, sk, h, hkv,
                                                 causal, prefix):
    """The dh-256 plan (64-key tiles) and the prefix-LM mask against the
    f32 twin: per-row error within 2 bf16 ulps of the row's largest
    output."""
    rng = np.random.default_rng(dh + sq + prefix)
    q, k, v = (_t(rng.standard_normal(shape).astype(np.float32),
                  torch.bfloat16)
               for shape in ((b, sq, h, dh), (b, sk, hkv, dh),
                             (b, sk, hkv, dh)))
    to = ops.flash_attention(q.float(), k.float(), v.float(), causal=causal,
                             prefix_len=prefix)
    co = ops.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             causal=causal, prefix_len=prefix)
    diff = (co.cpu().float() - to).abs().amax(-1)
    assert float((diff / to.abs().amax(-1)).max()) <= 2.0 ** -7


def _pool_of(dense, table, ps):
    """Scatter a dense (B, S, ...) operand into a page pool (n_pages, ps,
    ...) with page table ``table`` (B, S / ps): the paged kernel reads the
    same logical contents as the dense one."""
    if dense is None:
        return None
    b, s = dense.shape[:2]
    pool = torch.zeros((int(table.max()) + 1, ps, *dense.shape[2:]),
                       dtype=dense.dtype)
    pool[table.reshape(-1).long()] = dense.reshape(b * s // ps, ps,
                                                   *dense.shape[2:])
    return pool


@pytest.mark.requires_cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("v_bits", [8, 4])
@pytest.mark.parametrize("ql", [1, 4, 8])
def test_sparse_recon_attention_kernel_dh256_mqa(cuda, ql, v_bits, paged):
    """The recon body at paligemma's head shape (dh 256, one kv head,
    group 8, r 64), a window of 1, 4 or 8 queries (the 8 · ql query rows
    split over blocks where they do not fit in one): against the twin,
    a one-query window equal to the single-token kernel bit for bit, and
    (paged) equal to the dense kernel on the same logical contents."""
    from repro_torch.core import quantization as qz
    b, h, dh, s, r, n_c = 3, 8, 256, 640, 64, 300
    g = torch.Generator().manual_seed(40 + ql + v_bits)
    q = torch.randn((b, ql, h, dh), generator=g).to(torch.bfloat16)
    k_lat = torch.randn((b, s, r), generator=g).to(torch.bfloat16)
    vq = qz.quantize(torch.randn((b, s, dh), generator=g), v_bits, 64)
    u = (torch.randn((dh, r), generator=g) * r ** -0.5).to(torch.bfloat16)
    q_pos = torch.tensor([s - ql, s - 100, s - 300], dtype=torch.int32)
    idx = torch.zeros((b, n_c), dtype=torch.int32)
    valid = torch.zeros((b, n_c), dtype=torch.bool)
    for i, n in enumerate((n_c, n_c // 2, 0)):
        hi = int(q_pos[i]) + ql - 1 - 8
        idx[i, :n] = torch.sort(torch.randperm(hi - 15, generator=g)[:n]
                                + 16).values.int()
        valid[i, :n] = True
    cache = [k_lat, None, vq["q"], vq["scale"], vq["zero"]]
    kw = dict(n_kv=1, n_recent=8, v_bits=v_bits, v_group=64)
    pg, dpg = {}, {}
    if paged:
        ps = 64
        table = (torch.randperm(b * s // ps, generator=g) + 2).int()             .reshape(b, s // ps)
        cache = [_pool_of(a, table, ps) for a in cache]
        pg = dict(page_table=table, page_size=ps)
        dpg = dict(page_table=table.to(cuda), page_size=ps)
    dev_args = [None if a is None else a.to(cuda)
                for a in (q, *cache, u, idx, valid, q_pos)]
    tw = ops.sparse_recon_attention_window(q, *cache, u, idx, valid, q_pos,
                                           **kw, **pg)
    kern = ops.sparse_recon_attention_window(*dev_args, **kw, **dpg)
    for a, b_ in zip(kern, tw):
        torch.testing.assert_close(a.cpu(), b_, rtol=1e-4, atol=1e-4)
    qd, rest, idd, vd, pd = (dev_args[0], dev_args[1:7], dev_args[7],
                             dev_args[8], dev_args[9])
    kw1 = {k_: v_ for k_, v_ in kw.items() if k_ != "n_recent"}
    one = ops.sparse_recon_attention_window(qd[:, :1].contiguous(), *rest,
                                            idd, vd, pd, **dict(kw, n_recent=0),
                                            **dpg)
    single = ops.sparse_recon_attention(qd[:, 0].contiguous(), *rest, idd,
                                        vd, pd, **kw1, **dpg)
    for a, b_ in zip(one, single):
        assert torch.equal(a[:, 0], b_)
    if paged:
        dense = [None if a is None else
                 ref.paged_logical_view(a, dpg["page_table"], 64).contiguous()
                 for a in rest[:5]]
        kd = ops.sparse_recon_attention_window(qd, *dense, rest[5], idd, vd,
                                               pd, **kw)
        for a, b_ in zip(kern, kd):
            assert torch.equal(a, b_)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("lat_dtype,u_dtype", [
    ("bf16", "bf16"), ("int8", "bf16"), ("f32", "bf16"),
    ("int8", "f32"), ("bf16", "f32")])
@pytest.mark.parametrize("dh,v_bits", [(128, 8), (64, 4)])
def test_sparse_recon_attention_kernel_instances(cuda, lat_dtype, u_dtype,
                                                 dh, v_bits):
    """Each instance of the recon body (tensor cores for bf16 / int8
    latents with a bf16 u, CUDA cores for f32 latents or an f32 u — a
    float32 model's int8 cache) against its twin, over three passes of
    128 slots (the last partial) and a ragged, an empty row."""
    inputs = _sra_inputs(16, 3, 8, 2, dh, 400, 128, 300,
                         "bf16" if lat_dtype == "f32" else lat_dtype, v_bits)
    q, lat, scale, vq, vs, vz, u, idx, valid, q_pos = inputs
    tl = {"bf16": torch.bfloat16, "int8": torch.int8,
          "f32": torch.float32}[lat_dtype]
    args = [_t(q), _t(lat, tl),
            None if scale is None else _t(scale, torch.bfloat16), _t(vq),
            _t(vs, torch.bfloat16), _t(vz, torch.bfloat16),
            _t(u, {"bf16": torch.bfloat16, "f32": torch.float32}[u_dtype]),
            _t(idx), _t(valid), _t(q_pos)]
    kw = dict(n_kv=2, v_bits=v_bits, v_group=16, softcap=0.0)
    tm, tl_, to = ops.sparse_recon_attention(*args, **kw)
    dev = [None if a is None else a.to(cuda) for a in args]
    cm, cl, co = ops.sparse_recon_attention(*dev, **kw)
    torch.testing.assert_close(cm.cpu(), tm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cl.cpu(), tl_, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(co.cpu(), to, rtol=1e-4, atol=1e-4)
    assert (cm[2] == ref.NEG_INF).all() and (cl[2] == 0).all() \
        and (co[2] == 0).all()
