"""Port parity for the gemma-style dense configs and the vlm family
(gemma-2b, qwen2-1.5b, granite-3-8b, paligemma-3b) against the JAX
reference on the same seeded weights, at ``reduced(dtype="float32")``:

* every ported config, full and reduced, equals the reference's field for
  field (the vlm branch of ``reduced()``: 16 patches);
* ``prefill`` (paligemma: 16 patch embeddings before the tokens, the
  prefix-LM mask) then one ``decode_step``, SALS off and on: logits within
  rtol = atol = 1e-4, the engine tests' tolerance;
* ``ServeEngine.generate`` (tokens only): greedy tokens equal to the JAX
  engine's;
* inside the port, as the reference's ``test_prefill_decode_consistency``:
  a vlm prefill then a decode step equals the prefill over the extended
  sequence, exactly attended (SALS off) and through SALS at full rank and
  a budget covering every position."""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

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
from repro.serve import ServeEngine as JEngine
from repro_torch.config import SALSConfig, ServeConfig
from repro_torch.configs import _ARCH_MODULES, get_config
from repro_torch.convert import params_from_numpy, projectors_from_numpy
from repro_torch.models import transformer as ttf
from repro_torch.serve import ServeEngine

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
SALS_KW = dict(n_critical=10, n_sink=2, n_recent=8, v_group=16,
               skip_layers_front=1, skip_layers_back=1)
ARCHS = ["gemma-2b", "qwen2-1.5b", "granite-3-8b", "paligemma-3b"]
MAX_SEQ = 64


@pytest.mark.parametrize("arch", sorted(_ARCH_MODULES))
def test_config_equals_reference(arch):
    """The port's copy of each config, and its ``reduced()``, are the
    reference's field for field."""
    full, jfull = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert dataclasses.asdict(full.reduced()) == \
        dataclasses.asdict(jfull.reduced())
    if full.family == "vlm":
        assert full.reduced().vision_patches == 16


def _model(arch, lat_dtype="bfloat16", v_bits=8, seed=1):
    jcfg = jax_get_config(arch).reduced(dtype="float32")
    cfg = get_config(arch).reduced(dtype="float32")
    kw = dict(SALS_KW, k_latent_dtype=lat_dtype, v_bits=v_bits)
    jsals, sals = JSALS(**kw), SALSConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if cfg.qkv_bias:        # the initializer zeroes the biases: make them bite
        rng = np.random.default_rng(seed)
        attn = dict(jp["blocks"]["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(
                rng.standard_normal(attn[name].shape) * 0.1, jnp.float32)
        jp = dict(jp, blocks=dict(jp["blocks"], attn=attn))
    ju = jcal.random_layer_projectors(jax.random.PRNGKey(seed + 1), jcfg,
                                      jsals, jcfg.n_layers)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tu = projectors_from_numpy({"u": np.asarray(ju["u"])}, device="cpu")
    return jcfg, cfg, jsals, sals, jp, ju, tp, tu


def _prompt_batch(cfg, seed=3, lens=(37, 22, 6)):
    """Right-padded ragged tokens (+ 16 patch embeddings for a vlm)."""
    rng = np.random.default_rng(seed)
    lens = np.array(lens, np.int32)
    toks = np.zeros((len(lens), lens.max()), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patches"] = (rng.standard_normal(
            (len(lens), cfg.vision_patches, cfg.d_model)) * 0.1
        ).astype(np.float32)
    return batch, lens


@pytest.mark.parametrize("sals_on", [False, True], ids=["full", "sals"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, sals_on):
    """Prefill of a ragged batch (paligemma: patches first, prefix-LM),
    then one decode step at each row's next position (after the patches):
    logits within 1e-4 of the reference's."""
    jcfg, cfg, jsals, sals, jp, ju, tp, tu = _model(arch)
    if not sals_on:
        jsals, sals, ju, tu = None, None, None, None
    batch, lens = _prompt_batch(cfg)
    prefix = batch["patches"].shape[1] if "patches" in batch else 0
    jl, jcache = jtf.prefill(jp, ju, jcfg, jsals,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             MAX_SEQ, lengths=jnp.asarray(lens))
    with torch.inference_mode():
        tl, tcache = ttf.prefill(
            tp, tu, cfg, sals,
            {k: torch.from_numpy(v) for k, v in batch.items()}, MAX_SEQ,
            lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), **TOL)
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = (prefix + lens).astype(np.int32)
    jl2, _ = jtf.decode_step(jp, ju, jcache, jnp.asarray(nxt),
                             jnp.asarray(pos), jcfg, jsals)
    with torch.inference_mode():
        tl2, _ = ttf.decode_step(tp, tu, tcache, torch.from_numpy(nxt),
                                 torch.from_numpy(pos), cfg, sals)
    np.testing.assert_allclose(np.asarray(jl2), tl2.numpy(), **TOL)
    assert np.isfinite(tl2.numpy()).all()


@pytest.mark.parametrize("arch,v_bits,lat_dtype", [
    ("gemma-2b", 8, "bfloat16"),
    ("qwen2-1.5b", 4, "int8"),
    ("granite-3-8b", 8, "int8"),
    ("paligemma-3b", 8, "bfloat16"),
])
def test_generate_token_exact(arch, v_bits, lat_dtype):
    """``ServeEngine.generate`` on tokens only (a vlm too: the engine takes
    no patches, as the reference's) is token-exact with the JAX engine."""
    jcfg, cfg, jsals, sals, jp, ju, tp, tu = _model(arch, lat_dtype, v_bits,
                                                    seed=2)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (37, 22, 6)]            # 6 < n_sink + n_recent
    jeng = JEngine(jp, ju, jcfg, JServe(max_seq_len=MAX_SEQ, sals=jsals))
    teng = ServeEngine(tp, tu, cfg, ServeConfig(max_seq_len=MAX_SEQ,
                                                sals=sals), device="cpu")
    jres = jeng.generate(prompts, max_new_tokens=10)
    tres = teng.generate(prompts, max_new_tokens=10)
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert len(b.tokens) == 10


@pytest.mark.parametrize("sals_on", [False, True], ids=["full", "sals"])
def test_vlm_prefill_then_decode_equals_extended_prefill(sals_on):
    """paligemma-3b: prefill (patches + tokens) then one decode step of
    the greedy token gives the last logits of a prefill over the extended
    sequence.  SALS at full rank with N_c covering every position reads
    the same keys and int8 values, so it stays within the reference's own
    bound for that case (2e-2 of the logit scale); exact attention within
    1e-4."""
    cfg = get_config("paligemma-3b").reduced(dtype="float32", n_layers=4)
    sals = None
    tu = None
    if sals_on:
        sals = SALSConfig(rank_ratio=1.0, score_ratio=1.0, n_critical=96,
                          n_sink=2, n_recent=4, v_bits=8, v_group=32,
                          skip_layers_front=1, skip_layers_back=1)
        g = torch.Generator().manual_seed(5)
        kvd = cfg.kv_dim
        tu = {"u": torch.stack([torch.linalg.qr(torch.randn(
            kvd, kvd, generator=g))[0] for _ in range(cfg.n_layers)])}
    tp = ttf.init_params(cfg, device="cpu", seed=5)
    batch, lens = _prompt_batch(cfg, seed=6, lens=(30, 30))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    p = cfg.vision_patches
    with torch.inference_mode():
        last, cache = ttf.prefill(tp, tu, cfg, sals, batch, MAX_SEQ)
        nxt = last.argmax(-1).to(torch.int32)
        got, _ = ttf.decode_step(tp, tu, cache, nxt,
                                 torch.tensor(p + 30), cfg, sals)
        ext = dict(batch, tokens=torch.cat([batch["tokens"], nxt[:, None]],
                                           dim=1))
        want, _ = ttf.prefill(tp, None, cfg, None, ext, MAX_SEQ)
    err = float((got - want).abs().max() / want.abs().max())
    assert err < (2e-2 if sals_on else 1e-4), err
