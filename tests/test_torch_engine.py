"""Port parity for the slice as a whole: torch ``ServeEngine.generate`` is
token-exact with JAX ``ServeEngine.generate`` from the same weights and
projectors (reduced llama2-7b, MHA, and reduced yi-9b, GQA), on ragged
prompts including one shorter than n_sink + n_recent; per-step logits
agree within rtol = atol = 1e-4 under teacher forcing."""
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
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, projectors_from_numpy
from repro_torch.models import transformer as ttf
from repro_torch.serve import ServeEngine

torch.set_num_threads(1)

SALS_KW = dict(n_critical=10, n_sink=2, n_recent=8, v_group=16,
               skip_layers_front=1, skip_layers_back=1)
N_NEW = 12


@pytest.mark.parametrize("arch,over,v_bits,lat_dtype", [
    ("paper-llama2-7b", {"n_kv_heads": 4}, 8, "bfloat16"),   # MHA
    ("yi-9b", {}, 4, "int8"),                                 # GQA
])
def test_generate_token_exact_and_logits(arch, over, v_bits, lat_dtype):
    over = dict(dtype="float32", n_layers=4, **over)
    jcfg = jax_get_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    kw = dict(SALS_KW, v_bits=v_bits, k_latent_dtype=lat_dtype)
    jsals, sals = JSALS(**kw), SALSConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    ju = jcal.random_layer_projectors(jax.random.PRNGKey(2), jcfg, jsals,
                                      jcfg.n_layers)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tu = projectors_from_numpy({"u": np.asarray(ju["u"])}, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (37, 22, 6)]            # 6 < n_sink + n_recent
    jeng = JEngine(jp, ju, jcfg, JServe(max_seq_len=64, sals=jsals))
    teng = ServeEngine(tp, tu, cfg, ServeConfig(max_seq_len=64, sals=sals),
                       device="cpu")
    jres = jeng.generate(prompts, max_new_tokens=N_NEW)
    tres = teng.generate(prompts, max_new_tokens=N_NEW)
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert len(b.tokens) == N_NEW

    # per-step logits, teacher-forced with the reference's tokens
    lens = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((3, lens.max()), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    forced = np.stack([r.tokens for r in jres])
    jl, jcache = jeng._prefill({"tokens": jnp.asarray(toks)},
                               jnp.asarray(lens))
    jdecode = jax.jit(lambda c, t, pos: jtf.decode_step(jp, ju, c, t, pos,
                                                        jcfg, jsals))
    with torch.inference_mode():
        tl, tcache = ttf.prefill(tp, tu, cfg, sals,
                                 {"tokens": torch.from_numpy(toks)}, 64,
                                 lengths=torch.from_numpy(lens))
        for t in range(N_NEW):
            np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {t}")
            assert np.isfinite(tl.numpy()).all()
            if t == N_NEW - 1:
                break
            nxt = forced[:, t]
            jl, jcache = jdecode(jcache, jnp.asarray(nxt),
                                 jnp.asarray(lens + t))
            tl, tcache = ttf.decode_step(tp, tu, tcache,
                                         torch.from_numpy(nxt),
                                         torch.from_numpy(lens + t), cfg,
                                         sals)


def test_generate_sals_off_and_eos():
    cfg = get_config("yi-9b").reduced(dtype="float32")
    tp = ttf.init_params(cfg, device="cpu", seed=0)
    eng = ServeEngine(tp, None, cfg, ServeConfig(
        max_seq_len=32, sals=SALSConfig(enabled=False)), device="cpu")
    prompts = [np.arange(1, 9, dtype=np.int32), np.arange(3, 6,
                                                          dtype=np.int32)]
    full = eng.generate(prompts, max_new_tokens=6)
    eos = int(full[0].tokens[2])
    cut = eng.generate(prompts, max_new_tokens=6, eos_id=eos)
    assert cut[0].tokens.tolist() == full[0].tokens[:3].tolist()
    assert eng.last_timing["decode_steps"] >= 2


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = get_config("yi-9b").reduced(dtype="float32")
    tp = ttf.init_params(cfg, device="cpu", seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tp, None, cfg, ServeConfig(
            max_seq_len=32, sals=SALSConfig(enabled=False)))


def test_unported_options_raise():
    cfg = get_config("yi-9b").reduced(dtype="float32")
    tp = ttf.init_params(cfg, device="cpu", seed=0)
    off = SALSConfig(enabled=False)
    with pytest.raises(NotImplementedError):
        ServeEngine(tp, None, cfg, ServeConfig(max_seq_len=32, sals=off),
                    n_groups=2, device="cpu")
    with pytest.raises(NotImplementedError):
        ServeEngine(tp, None, cfg, ServeConfig(max_seq_len=32, sals=off,
                                               page_size=16,
                                               prefill_chunk=16),
                    device="cpu")
    eng = ServeEngine(tp, None, cfg, ServeConfig(max_seq_len=32, sals=off,
                                                 temperature=0.7),
                      device="cpu")
    with pytest.raises(NotImplementedError):
        eng.generate([np.arange(1, 5, dtype=np.int32)], max_new_tokens=2)
