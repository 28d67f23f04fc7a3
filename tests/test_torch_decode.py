"""Port parity: one SALS decode attend and one whole decode step of
``repro_torch`` against the JAX reference from the SAME cache (the
reference's cache carried over field by field), and calibration.

Tolerances: f32 attention outputs allclose(1e-5); decode-step logits
allclose(rtol=1e-4, atol=1e-4); cache integer fields exact.  Calibration
compares the projector U Uᵀ (eigenvector signs are free): from identical
keys within 1e-5, end to end through the bf16-stored U within 2e-2."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SALSConfig as JSALS
from repro.configs import get_config as jax_get_config
from repro.core import calibration as jcal
from repro.core import latent_cache as jlc
from repro.core import projection as jproj
from repro.core.sparse_attention import DecodePlan as JPlan
from repro.core.sparse_attention import sals_decode_attend as j_attend
from repro.data import SyntheticCorpus as JCorpus
from repro.launch import serve as jserve
from repro.models import transformer as jtf
from repro_torch.config import SALSConfig
from repro_torch.configs import get_config
from repro_torch.convert import (params_from_numpy, projectors_from_numpy,
                                 tensor_from_numpy)
from repro_torch.core import latent_cache as tlc
from repro_torch.core import projection as tproj
from repro_torch.core.sparse_attention import sals_decode_attend as t_attend
from repro_torch.data import SyntheticCorpus
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)

SALS_KW = dict(n_critical=12, n_sink=2, n_recent=8, v_group=16,
               skip_layers_front=1, skip_layers_back=1)
CACHE_FIELDS = ("k_lat", "v_q", "v_scale", "v_zero", "sink_k", "sink_v",
                "recent_k", "recent_v", "k_scale", "lengths")


def _cfgs(arch, **over):
    over = dict(dtype="float32", n_layers=4, **over)
    return jax_get_config(arch).reduced(**over), get_config(arch).reduced(
        **over)


def _cache_to_torch(jcache):
    """A reference cache dict (full segments + LatentKVCache) -> the
    port's, field by field."""
    out = {}
    for name, seg in jcache.items():
        if isinstance(seg, jlc.LatentKVCache):
            out[name] = tlc.LatentKVCache(**{
                f: (None if getattr(seg, f) is None
                    else tensor_from_numpy(getattr(seg, f), "cpu"))
                for f in CACHE_FIELDS})
        else:
            out[name] = {k: tensor_from_numpy(v, "cpu")
                         for k, v in seg.items()}
    return out


def _model(arch, seed=0, **over):
    jcfg, cfg = _cfgs(arch, **over)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    jsals, sals = JSALS(**SALS_KW), SALSConfig(**SALS_KW)
    ju = jcal.random_layer_projectors(jax.random.PRNGKey(seed + 1), jcfg,
                                      jsals, jcfg.n_layers)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tu = projectors_from_numpy({"u": np.asarray(ju["u"])}, device="cpu")
    return jcfg, cfg, jsals, sals, jp, ju, tp, tu


@pytest.mark.parametrize("arch,lat_dtype,v_bits,backend", [
    ("paper-llama2-7b", "bfloat16", 8, "xla"),
    ("yi-9b", "int8", 4, "xla"),
    ("yi-9b", "bfloat16", 8, "pallas"),
])
def test_sals_decode_attend_same_cache(arch, lat_dtype, v_bits, backend):
    over = {"n_kv_heads": 4} if arch == "paper-llama2-7b" else {}
    jcfg, cfg = _cfgs(arch, **over)
    kw = dict(SALS_KW, k_latent_dtype=lat_dtype, v_bits=v_bits)
    jsals, sals = JSALS(**kw), SALSConfig(**kw)
    rng = np.random.default_rng(3)
    b, s, max_seq = 3, 30, 40
    kvd, r = cfg.kv_dim, sals.rank(cfg.kv_dim)
    u = np.linalg.qr(rng.standard_normal((kvd, kvd)))[0][:, :r]
    u = np.asarray(jnp.asarray(u, jnp.bfloat16))          # stored bf16
    k_pre = rng.standard_normal((b, s, cfg.n_kv_heads, cfg.head_dim)) \
        .astype(np.float32)
    v = rng.standard_normal(k_pre.shape).astype(np.float32)
    lens = np.array([30, 17, 6], np.int32)     # last row: nothing selectable
    jc = jlc.LatentKVCache.prefill_layer(
        jcfg, jsals, jnp.asarray(u), jnp.asarray(k_pre), jnp.asarray(v),
        max_seq, jnp.float32, lengths=jnp.asarray(lens))
    tc = _cache_to_torch({"c": jc})["c"]
    w = {k: (rng.standard_normal(shape) * 0.2).astype(np.float32)
         for k, shape in (("wq", (128, cfg.q_dim)), ("wk", (128, kvd)),
                          ("wv", (128, kvd)), ("wo", (cfg.q_dim, 128)))}
    from repro_torch.models.attention import Attention
    ta = Attention(cfg, torch.float32, "cpu")
    for k, val in w.items():
        getattr(ta, k).data.copy_(torch.from_numpy(val))
    x = rng.standard_normal((b, 1, 128)).astype(np.float32)
    attend = jax.jit(lambda p, u_, c, x_, pos: j_attend(
        p, u_, c, x_, pos, jcfg, jsals, plan=JPlan(1, backend)))
    jy, jc2 = attend({k: jnp.asarray(val) for k, val in w.items()},
                     jnp.asarray(u), jc, jnp.asarray(x), jnp.asarray(lens))
    ty, tc2 = t_attend(ta, tensor_from_numpy(u, "cpu"), tc,
                       torch.from_numpy(x), torch.from_numpy(lens), cfg, sals)
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=1e-5,
                               atol=1e-5)
    for f in CACHE_FIELDS:          # integer fields exact, floats 1e-5
        ja, ta_ = getattr(jc2, f), getattr(tc2, f)
        if ja is None:
            continue
        if ta_.dtype.is_floating_point:
            np.testing.assert_allclose(np.asarray(ja).astype(np.float32),
                                       ta_.float().numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(np.asarray(ja), ta_.numpy(),
                                          err_msg=f)


@pytest.mark.parametrize("arch", ["paper-llama2-7b", "yi-9b"])
def test_decode_step_same_cache(arch):
    over = {"n_kv_heads": 4} if arch == "paper-llama2-7b" else {}
    jcfg, cfg, jsals, sals, jp, ju, tp, tu = _model(arch, **over)
    rng = np.random.default_rng(4)
    lens = np.array([28, 11, 5], np.int32)
    toks = np.zeros((3, 28), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, 512, n)
    _, jcache = jtf.prefill(jp, ju, jcfg, jsals, {"tokens": jnp.asarray(toks)},
                            48, lengths=jnp.asarray(lens))
    tcache = _cache_to_torch(jcache)
    nxt = rng.integers(1, 512, 3).astype(np.int32)
    jl, jcache2 = jax.jit(lambda c, t, pos: jtf.decode_step(
        jp, ju, c, t, pos, jcfg, jsals))(jcache, jnp.asarray(nxt),
                                         jnp.asarray(lens))
    with torch.inference_mode():
        tl, tcache2 = ttf.decode_step(tp, tu, tcache, torch.from_numpy(nxt),
                                      torch.from_numpy(lens), cfg, sals)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-4,
                               atol=1e-4)
    seg = tcache2["seg1"]
    np.testing.assert_array_equal(np.asarray(jcache2["seg1"].lengths),
                                  seg.lengths.numpy())
    np.testing.assert_array_equal(np.asarray(jcache2["seg1"].v_q),
                                  seg.v_q.numpy())


def test_prefill_cache_matches_reference():
    jcfg, cfg, jsals, sals, jp, ju, tp, tu = _model("yi-9b", seed=5)
    rng = np.random.default_rng(6)
    lens = np.array([25, 9], np.int32)
    toks = np.zeros((2, 25), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, 512, n)
    jl, jcache = jtf.prefill(jp, ju, jcfg, jsals,
                             {"tokens": jnp.asarray(toks)}, 32,
                             lengths=jnp.asarray(lens))
    with torch.inference_mode():
        tl, tcache = ttf.prefill(tp, tu, cfg, sals,
                                 {"tokens": torch.from_numpy(toks)}, 32,
                                 lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-4,
                               atol=1e-4)
    ref = _cache_to_torch(jcache)
    for name, seg in ref.items():
        got = tcache[name]
        if isinstance(seg, dict):
            for k in seg:
                torch.testing.assert_close(got[k], seg[k], rtol=1e-5,
                                           atol=1e-5)
            continue
        for f in ("lengths", "v_q"):
            assert torch.equal(getattr(got, f), getattr(seg, f)), f
        for f in ("k_lat", "sink_k", "recent_v", "v_scale"):
            torch.testing.assert_close(getattr(got, f).float(),
                                       getattr(seg, f).float(), rtol=1e-5,
                                       atol=1e-5)


def test_fit_projector_same_keys():
    rng = np.random.default_rng(7)
    keys = (rng.standard_normal((400, 64))
            * np.linspace(3, 0.1, 64)).astype(np.float32)
    j = jproj.fit_projector(keys, 16)
    t = tproj.fit_projector(keys, 16)
    ju, tu = np.asarray(j["u"], np.float64), t["u"].double().numpy()
    np.testing.assert_allclose(ju @ ju.T, tu @ tu.T, atol=1e-5)
    np.testing.assert_allclose(np.asarray(j["eigvals"]), t["eigvals"].numpy(),
                               rtol=1e-5)


def test_calibrate_projector():
    jcfg, cfg, jsals, sals, jp, ju, tp, tu = _model("yi-9b", seed=8)
    jcorpus, corpus = JCorpus(cfg.vocab_size, seed=0), \
        SyntheticCorpus(cfg.vocab_size, seed=0)
    jout = jserve.calibrate(jp, jcfg, jsals, jcorpus, n_sequences=8,
                            seq_len=32)
    tout = tserve.calibrate(tp, cfg, sals, corpus, n_sequences=8,
                            seq_len=32)
    assert tout["u"].dtype == torch.bfloat16
    assert tuple(tout["u"].shape) == tuple(jout["u"].shape)
    jkeys = jserve.collect_pre_rope_keys(
        jp, jcfg, {"tokens": jnp.asarray(corpus.batch(3, 2, 16)["tokens"])})
    tkeys = tserve.collect_pre_rope_keys(
        tp, cfg, {"tokens": torch.from_numpy(corpus.batch(3, 2, 16)
                                             ["tokens"])})
    np.testing.assert_allclose(np.asarray(jkeys), tkeys.numpy(), rtol=1e-4,
                               atol=1e-4)
    for l in range(cfg.n_layers):
        a = np.asarray(jout["u"][l], np.float64)
        b = tout["u"][l].double().numpy()
        np.testing.assert_allclose(a @ a.T, b @ b.T, atol=2e-2)
    np.testing.assert_allclose(np.asarray(jout["eigvals"]),
                               tout["eigvals"].numpy(), rtol=1e-4, atol=1e-3)
    # the materialized path (collect_keys + fit_layer_projectors) gives the
    # same fit as the on-device covariance path calibrate takes
    from repro_torch.core import calibration as tcal
    from repro_torch.data import CalibrationSampler
    sampler = CalibrationSampler(corpus, n_sequences=8, seq_len=32,
                                 batch_size=4)
    keys = tcal.collect_keys(
        lambda t: tserve.collect_pre_rope_keys(
            tp, cfg, {"tokens": torch.from_numpy(t)}),
        sampler.batches(), max_tokens=8 * 32)
    fit = tcal.fit_layer_projectors(keys, sals.rank(cfg.kv_dim))
    torch.testing.assert_close(fit["eigvals"], tout["eigvals"], rtol=1e-5,
                               atol=1e-4)
    for a, b in zip(fit["u"].double(), tout["u"].double()):
        torch.testing.assert_close(a @ a.T, b @ b.T, rtol=0, atol=1e-2)
