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


@pytest.mark.requires_cuda
def test_latent_topk_kernel_vs_twin(cuda):
    b, s, r, r_star = 3, 2100, 64, 32
    q, k, scale = _topk_inputs(8, b, s, r, r_star, "bf16", True)
    pos = torch.tensor([2099, 1500, 40], dtype=torch.int32)
    kw = dict(n_critical=100, n_sink=16, n_recent=64)
    qt, kt = _t(q), _t(k, torch.bfloat16)
    ti, tv = ops.latent_topk(qt, kt, None, pos, **kw)
    ci, cv = ops.latent_topk(qt.to(cuda), kt.to(cuda), None, pos.to(cuda),
                             **kw)
    assert torch.equal(cv.cpu(), tv)
    assert torch.equal(torch.where(tv, ci.cpu(), 0), torch.where(tv, ti, 0))


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
    rng = np.random.default_rng(13)
    q = rng.standard_normal((2, sq, h, 16)).astype(np.float32)
    k = rng.standard_normal((2, sk, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, sk, hkv, 16)).astype(np.float32)
    kk, vv = np.repeat(k, h // hkv, 2), np.repeat(v, h // hkv, 2)
    if backend == "pallas":
        from repro.kernels.flash_attention import flash_attention_pallas
        jo = flash_attention_pallas(_j(q), _j(kk), _j(vv), causal=True,
                                    softcap=softcap)
    else:
        jo = jops.flash_attention(_j(q), _j(kk), _j(vv), causal=True,
                                  softcap=softcap, backend=backend)
    to = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                             softcap=softcap)
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), **TOL)


def test_flash_attention_prefix_lm_not_ported():
    x = torch.zeros((1, 4, 2, 16))
    with pytest.raises(NotImplementedError):
        ops.flash_attention(x, x, x, prefix_len=2)


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
