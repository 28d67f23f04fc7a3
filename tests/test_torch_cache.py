"""Port parity: value quantization and the latent cache of
``repro_torch.core`` against the JAX reference.  Quantization codes, scales
and every cache field must match exactly (the projector is a column
selection of the identity, so the latent projection itself is exact)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SALSConfig as JSALS
from repro.configs import get_config as jax_get_config
from repro.core import latent_cache as jlc
from repro.core import quantization as jqz
from repro_torch.config import SALSConfig
from repro_torch.configs import get_config
from repro_torch.core import latent_cache as tlc
from repro_torch.core import quantization as tqz

torch.set_num_threads(1)

FIELDS = ("k_lat", "k_scale", "v_q", "v_scale", "v_zero", "sink_k", "sink_v",
          "recent_k", "recent_v", "lengths")


def _f(a):
    """Any array/tensor (bf16 included) -> float64 numpy for exact compares."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy().astype(np.float64)
    return np.asarray(a).astype(np.float32).astype(np.float64)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_codes_exact(bits):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 4
    x[0, 0, :16] = 0.0                     # a constant group (scale floor)
    jq = jqz.quantize(jnp.asarray(x), bits, 16)
    tq = tqz.quantize(torch.from_numpy(x), bits, 16)
    assert tq["q"].dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(np.asarray(jq["q"]), tq["q"].numpy())
    for k in ("scale", "zero"):
        np.testing.assert_array_equal(_f(jq[k]), _f(tq[k]))
    np.testing.assert_allclose(
        _f(jqz.dequantize(jq, bits, 16, jnp.float32)),
        _f(tqz.dequantize(tq, bits, 16, torch.float32)), rtol=1e-6, atol=1e-6)


def test_quantize_half_to_even():
    """x - lo lands exactly on .5 code steps: both round half to even."""
    x = np.tile(np.array([0.0, 0.5, 1.5, 2.5, 3.5, 15.0], np.float32), 2)
    x = np.concatenate([x, np.zeros(4, np.float32)])[None]
    for bits in (8, 4):
        jq = jqz.quantize(jnp.asarray(x), bits, 16)
        tq = tqz.quantize(torch.from_numpy(x), bits, 16)
        np.testing.assert_array_equal(np.asarray(jq["q"]), tq["q"].numpy())


def test_quantize_latent_int8_exact():
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, 7, 32)).astype(np.float32)
    jq, js = jqz.quantize_latent_int8(jnp.asarray(lat))
    tq, ts = tqz.quantize_latent_int8(torch.from_numpy(lat))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(_f(js), _f(ts))


def _setup(lat_dtype, v_bits, seed=2):
    over = dict(n_layers=3)
    jcfg = jax_get_config("yi-9b").reduced(**over)
    cfg = get_config("yi-9b").reduced(**over)
    kw = dict(n_critical=8, n_sink=3, n_recent=8, v_bits=v_bits, v_group=16,
              k_latent_dtype=lat_dtype, skip_layers_front=1,
              skip_layers_back=1)
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


@pytest.mark.parametrize("lat_dtype,v_bits,ragged", [
    ("bfloat16", 8, True), ("int8", 8, True), ("bfloat16", 4, False),
    ("int8", 4, True)])
def test_prefill_layer_and_write(lat_dtype, v_bits, ragged):
    jcfg, cfg, jsals, sals, u, rng = _setup(lat_dtype, v_bits)
    b, s, max_seq = 3, 20, 32
    k_pre = rng.standard_normal((b, s, cfg.n_kv_heads, cfg.head_dim)) \
        .astype(np.float32)
    v = rng.standard_normal(k_pre.shape).astype(np.float32)
    lens = np.array([20, 13, 2], np.int32) if ragged else None
    jc = jlc.LatentKVCache.prefill_layer(
        jcfg, jsals, jnp.asarray(u), jnp.asarray(k_pre), jnp.asarray(v),
        max_seq, jnp.bfloat16,
        lengths=None if lens is None else jnp.asarray(lens))
    tc = tlc.LatentKVCache.prefill_layer(
        cfg, sals, torch.from_numpy(u), torch.from_numpy(k_pre),
        torch.from_numpy(v), max_seq, torch.bfloat16,
        lengths=None if lens is None else torch.from_numpy(lens))
    _assert_same(jc, tc)

    # one decode write per row at its own position
    pos = lens if ragged else np.full((b,), s, np.int32)
    kn = rng.standard_normal((b, cfg.n_kv_heads, cfg.head_dim)) \
        .astype(np.float32)
    vn = rng.standard_normal(kn.shape).astype(np.float32)
    lat_new = kn.reshape(b, -1) @ u
    jc = jc.write(jsals, jnp.asarray(pos), jnp.asarray(lat_new),
                  jnp.asarray(vn.reshape(b, -1)), jnp.asarray(kn),
                  jnp.asarray(vn))
    out = tc.write(sals, torch.from_numpy(pos), torch.from_numpy(lat_new),
                   torch.from_numpy(vn.reshape(b, -1)), torch.from_numpy(kn),
                   torch.from_numpy(vn))
    assert out is tc                       # in place
    _assert_same(jc, tc)


def test_stacked_init_layer_view_writes_through():
    jcfg, cfg, jsals, sals, u, rng = _setup("bfloat16", 8)
    tc = tlc.LatentKVCache.init(cfg, sals, 2, 2, 16, device="cpu")
    jc = jlc.LatentKVCache.init(jcfg, jsals, 2, 2, 16)
    for name in FIELDS:
        ja, ta = getattr(jc, name), getattr(tc, name)
        assert (ja is None) == (ta is None)
        if ja is not None:
            assert tuple(ja.shape) == tuple(ta.shape), name
            assert str(ja.dtype) == str(ta.dtype).replace("torch.", ""), name
    view = tc.layer_view(1)
    kn = torch.ones((2, cfg.n_kv_heads, cfg.head_dim))
    view.write(sals, torch.tensor([0, 5]), torch.ones((2, u.shape[1])),
               kn.reshape(2, -1), kn, kn)
    assert tc.lengths.tolist() == [[0, 0], [1, 6]]
    assert float(tc.k_lat[1, 1, 5, 0]) == 1.0


@pytest.mark.parametrize("lat_dtype,v_bits", [("bfloat16", 8), ("int8", 4)])
def test_cache_bytes_per_token(lat_dtype, v_bits):
    jcfg, cfg, jsals, sals, _, _ = _setup(lat_dtype, v_bits)
    assert tlc.cache_bytes_per_token(cfg, sals) == \
        jlc.cache_bytes_per_token(jcfg, jsals)
