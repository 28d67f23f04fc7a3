"""Port parity: the basic layers of ``repro_torch.models`` against the JAX
reference on the same seeded numpy inputs (f32, allclose 1e-5)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), **(tol or TOL))


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32)
    norm = tl.RMSNorm(16, torch.float32, "cpu")
    norm.scale.data.copy_(torch.from_numpy(scale))
    _close(jl.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                            1e-5),
           tl.rmsnorm_apply(norm, torch.from_numpy(x), 1e-5))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    _close(jl.rope_freqs(32, theta), tl.rope_freqs(32, theta))
    _close(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_mlp(act):
    cfg = get_config("paper-llama2-7b").reduced()
    rng = np.random.default_rng(2)
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("w_gate", (128, 256)), ("w_up", (128, 256)),
                      ("w_down", (256, 128)))}
    x = rng.standard_normal((2, 4, 128)).astype(np.float32)
    mlp = tl.MLP(cfg, torch.float32, "cpu")
    for k, v in w.items():
        getattr(mlp, k).data.copy_(torch.from_numpy(v))
    _close(jl.mlp_apply({k: jnp.asarray(v) for k, v in w.items()},
                        jnp.asarray(x), act),
           tl.mlp_apply(mlp, torch.from_numpy(x), act), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("tie,softcap", [(True, 0.0), (False, 0.0),
                                         (False, 30.0)])
def test_embed_unembed(tie, softcap):
    over = dict(tie_embeddings=tie, attn_logit_softcap=softcap)
    jcfg = jax_get_config("paper-llama2-7b").reduced(**over)
    cfg = get_config("paper-llama2-7b").reduced(**over)
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((512, 128)).astype(np.float32) * 0.1
    head = rng.standard_normal((128, 512)).astype(np.float32) * 0.1
    toks = rng.integers(0, 512, (2, 6)).astype(np.int32)
    e = tl.Embedding(cfg, torch.float32, "cpu")
    e.embedding.data.copy_(torch.from_numpy(emb))
    jp = {"embedding": jnp.asarray(emb)}
    if not tie:
        e.lm_head.data.copy_(torch.from_numpy(head))
        jp["lm_head"] = jnp.asarray(head)
    jx = jl.embed_apply(jp, jnp.asarray(toks), jcfg)
    tx = tl.embed_apply(e, torch.from_numpy(toks), cfg)
    _close(jx, tx)
    _close(jl.unembed_apply(jp, jx, jcfg), tl.unembed_apply(e, tx, cfg),
           rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("arch,bias", [("paper-llama2-7b", False),
                                       ("yi-9b", True)])
def test_qkv_out_proj(arch, bias):
    jcfg = jax_get_config(arch).reduced(qkv_bias=bias)
    cfg = get_config(arch).reduced(qkv_bias=bias)
    rng = np.random.default_rng(4)
    shapes = {"wq": (128, cfg.q_dim), "wk": (128, cfg.kv_dim),
              "wv": (128, cfg.kv_dim), "wo": (cfg.q_dim, 128)}
    if bias:
        shapes.update(bq=(cfg.q_dim,), bk=(cfg.kv_dim,), bv=(cfg.kv_dim,))
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in shapes.items()}
    a = tattn.Attention(cfg, torch.float32, "cpu")
    for k, v in w.items():
        getattr(a, k).data.copy_(torch.from_numpy(v))
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    jq = jattn.qkv_proj({k: jnp.asarray(v) for k, v in w.items()},
                        jnp.asarray(x), jcfg)
    tq = tattn.qkv_proj(a, torch.from_numpy(x), cfg)
    for jt, tt in zip(jq, tq):
        assert tuple(jt.shape) == tuple(tt.shape)
        _close(jt, tt, rtol=1e-5, atol=1e-4)
    _close(jattn.out_proj({k: jnp.asarray(v) for k, v in w.items()}, jq[0],
                          jcfg),
           tattn.out_proj(a, tq[0], cfg), rtol=1e-5, atol=1e-4)
    _close(jattn.repeat_kv(jq[1], 2), tattn.repeat_kv(tq[1], 2), **TOL)
