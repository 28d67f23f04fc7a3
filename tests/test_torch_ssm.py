"""Port parity for the state-space mixers (``models/ssm.py``) against the
JAX reference's functions on the same seeded weights and inputs, in
float32, within 1e-4 (the engine tests' tolerance) of each output's scale
(at least 1):

* Mamba2 SSD: ``_ssd_chunk_scan`` from a non-zero state at S 96 (one
  chunk) and S 256 (two chunks: the state carries over the boundary);
  ``mamba_apply`` with and without an incoming state, its returned state
  ({"ssm", "conv"}); ``mamba_decode`` step by step from that state; the
  chunk-divisibility error the reference asserts;
* RWKV6: ``rwkv_time_mix`` / ``rwkv_channel_mix`` without a state and with
  one carried from a first half of the sequence (the halves equal the
  whole), and one-token steps as decode runs them;
* the small helpers: the causal conv with a carried tail, ``_conv_tail``
  shorter than the kernel, the per-head group norm."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
# the reference's functions, compiled once per shape
_ssd = jax.jit(jssm._ssd_chunk_scan)
_mamba_apply = jax.jit(jssm.mamba_apply, static_argnums=(2, 4))
_mamba_decode = jax.jit(jssm.mamba_decode, static_argnums=2)
_time_mix = jax.jit(jssm.rwkv_time_mix, static_argnums=2)
_channel_mix = jax.jit(jssm.rwkv_channel_mix)


def _configs(arch):
    return (jax_get_config(arch).reduced(dtype="float32"),
            get_config(arch).reduced(dtype="float32"))


def _carry(jp: dict, mod: torch.nn.Module, seed: int = 0) -> dict:
    """Copy the reference's parameters into ``mod``; the zero / one
    initialized ones (dt_bias, a_log, d_skip, norm scales) get random
    values first so that they bite."""
    rng = np.random.default_rng(seed)
    jp = dict(jp)
    for name in ("dt_bias", "a_log", "d_skip", "norm_scale", "ln_scale"):
        if name in jp:
            jp[name] = jnp.asarray(
                1.0 + 0.3 * rng.standard_normal(jp[name].shape), jnp.float32)
    for name, p in mod.named_parameters():
        p.data.copy_(tensor_from_numpy(np.asarray(jp[name]), "cpu"))
    return jp


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(j, t):
    """Within TOL of the output's scale (at least 1): the two packages sum
    a chunk's up to 128 terms in different f32 orders, and the Mamba
    output's RMS norm scales those differences up on small rows."""
    j = np.asarray(j)
    scale = max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(j / scale, t.numpy() / scale, **TOL)


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    jcfg, cfg = _configs("hymba-1.5b")
    jp = jssm.mamba_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    mod = tssm.Mamba(cfg, torch.float32, "cpu")
    return jcfg, cfg, _carry(jp, mod), mod


@pytest.mark.parametrize("s", [96, 256])
def test_ssd_chunk_scan(s):
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 8, 5
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = (0.3 * rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    jy, jh = _ssd(*(jnp.asarray(a) for a in (x, dt, a_log, bm, cm, h0)))
    ty, th = tssm._ssd_chunk_scan(*(_t(a) for a in
                                    (x, dt, a_log, bm, cm, h0)))
    _close(jy, ty)
    _close(jh, th)


def test_ssd_chunk_scan_refuses_ragged_chunks():
    """S over 128 and not a multiple of it: the reference asserts, the
    port raises."""
    args = [np.zeros(sh, np.float32) for sh in
            ((1, 200, 2, 4), (1, 200, 2), (2,), (1, 200, 3), (1, 200, 3),
             (1, 2, 4, 3))]
    with pytest.raises(AssertionError):
        jssm._ssd_chunk_scan(*(jnp.asarray(a) for a in args))
    with pytest.raises(ValueError, match="not divisible by chunk"):
        tssm._ssd_chunk_scan(*(_t(a) for a in args))


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("s", [96, 256])
def test_mamba_apply_and_decode(mamba, s, with_state):
    """The full-sequence SSD with its returned state, then three decode
    steps carrying it: outputs and states equal the reference's."""
    jcfg, cfg, jp, mod = mamba
    rng = np.random.default_rng(s + with_state)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jst = tst = None
    if with_state:
        st = {"ssm": rng.standard_normal((2, cfg.ssm_heads, cfg.head_dim,
                                          cfg.ssm_state)),
              "conv": rng.standard_normal((2, cfg.ssm_conv - 1,
                                           cfg.ssm_heads * cfg.head_dim))}
        jst = {k: jnp.asarray(v, jnp.float32) for k, v in st.items()}
        tst = {k: _t(v) for k, v in st.items()}
    jy, jnew = _mamba_apply(jp, jnp.asarray(x), jcfg, jst, True)
    with torch.inference_mode():
        ty, tnew = tssm.mamba_apply(mod, _t(x), cfg, tst, return_state=True)
    _close(jy, ty)
    for k in ("ssm", "conv"):
        _close(jnew[k], tnew[k])
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jnew = _mamba_decode(jp, jnp.asarray(xt), jcfg, jnew)
        with torch.inference_mode():
            ty, tnew = tssm.mamba_decode(mod, _t(xt), cfg, tnew)
        _close(jy, ty)
        for k in ("ssm", "conv"):
            _close(jnew[k], tnew[k])


def test_mamba_state_init_matches_reference(mamba):
    jcfg, cfg, _, _ = mamba
    j = jssm.mamba_state_init(jcfg, 3)
    t = tssm.mamba_state_init(cfg, 3, "cpu")
    assert {k: v.shape for k, v in j.items()} == \
        {k: tuple(v.shape) for k, v in t.items()}
    assert all(v.dtype == torch.float32 for v in t.values())


def test_conv_helpers():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    _close(jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(st)),
           tssm._causal_conv(_t(x), _t(w), _t(st)))
    _close(jssm._causal_conv(jnp.asarray(x), jnp.asarray(w)),
           tssm._causal_conv(_t(x), _t(w)))
    for prev in (None, st):
        _close(jssm._conv_tail(jnp.asarray(x[:, :2]), 4,
                               None if prev is None else jnp.asarray(prev)),
               tssm._conv_tail(_t(x[:, :2]), 4,
                               None if prev is None else _t(prev)))


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rwkv():
    jcfg, cfg = _configs("rwkv6-7b")
    jp = jssm.rwkv_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    mod = tssm.RWKV(cfg, torch.float32, "cpu")
    return jcfg, cfg, _carry(jp, mod, seed=1), mod


def _mix_both(rwkv, x, jst, tst):
    jcfg, cfg, jp, mod = rwkv
    jy, jwkv, jlast = _time_mix(jp, jnp.asarray(x), jcfg, jst)
    jc, jclast = _channel_mix(jp, jnp.asarray(x), jst)
    with torch.inference_mode():
        ty, twkv, tlast = tssm.rwkv_time_mix(mod, _t(x), cfg, tst)
        tc, tclast = tssm.rwkv_channel_mix(mod, _t(x), tst)
    for j, t in ((jy, ty), (jwkv, twkv), (jlast, tlast), (jc, tc),
                 (jclast, tclast)):
        _close(j, t)
    return ({"wkv": jwkv, "tm_x": jlast, "cm_x": jclast},
            {"wkv": twkv, "tm_x": tlast, "cm_x": tclast}, ty)


def test_rwkv_mixes_with_carried_state(rwkv):
    """The whole sequence, then its halves with the state of the first
    carried into the second, then one-token steps as decode runs them:
    each equal to the reference's, and the halves' output equal to the
    whole's."""
    _, cfg, _, _ = rwkv
    x = np.random.default_rng(4).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    _, _, whole = _mix_both(rwkv, x, None, None)
    jst, tst, first = _mix_both(rwkv, x[:, :24], None, None)
    jst, tst, second = _mix_both(rwkv, x[:, 24:], jst, tst)
    torch.testing.assert_close(torch.cat([first, second], 1), whole, **TOL)
    for t in range(3):
        xt = np.random.default_rng(10 + t).standard_normal(
            (2, 1, cfg.d_model)).astype(np.float32)
        jst, tst, _ = _mix_both(rwkv, xt, jst, tst)


def test_rwkv_state_init_and_groupnorm(rwkv):
    jcfg, cfg, _, _ = rwkv
    j = jssm.rwkv_state_init(jcfg, 2)
    t = tssm.rwkv_state_init(cfg, 2, "cpu")
    assert {k: v.shape for k, v in j.items()} == \
        {k: tuple(v.shape) for k, v in t.items()}
    y = np.random.default_rng(6).standard_normal((2, 3, 8, 16)) \
        .astype(np.float32)
    scale = np.random.default_rng(7).standard_normal(128).astype(np.float32)
    _close(jssm._groupnorm_heads(jnp.asarray(y), jnp.asarray(scale)),
           tssm._groupnorm_heads(_t(y), _t(scale)))
    assert tssm.RWKV_LORA == jssm.RWKV_LORA
    assert tssm.SSD_CHUNK == jssm.SSD_CHUNK
