"""``repro_torch.examples.multi_arch_smoke`` against
``examples/multi_arch_smoke.py`` on the CPU, one architecture per family
(dense gemma-2b, moe qwen3-moe, encoder hubert-xlarge, hybrid hymba-1.5b,
vlm paligemma-3b, ssm rwkv6-7b; the reference takes about 105 s for all
ten, over this file's budget): the reference runs with ``--arch`` into
``capsys``, then the port's ``run_arch`` on the reference's weights, its
``jax.random`` batch and (attention families) its random projectors, all
carried over through numpy.  The printed line equal but for the timing
(the train loss to its three decimals, the decode mode), the decode's
logits finite."""
import importlib.util
import os
import re

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core import calibration as jcal
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.examples import multi_arch_smoke

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY_ARCHS = ["gemma-2b", "qwen3-moe-235b-a22b", "hubert-xlarge",
                "hymba-1.5b", "paligemma-3b", "rwkv6-7b"]


def _reference_inputs(arch):
    """The reference example's weights, batch and projectors (its own
    draws from ``jax.random.PRNGKey(0)``), as numpy."""
    cfg = jax_get_config(arch).reduced()
    key = jax.random.PRNGKey(0)
    state = jtrainer.init_state(key, cfg, JTrainConfig(steps=1, batch_size=2,
                                                       seq_len=64),
                                jnp.float32)
    if cfg.family == "encoder":
        batch = {"frames": jax.random.normal(key, (2, 64, cfg.d_model)) * .1,
                 "labels": jax.random.randint(key, (2, 64), 0,
                                              cfg.vocab_size)}
    else:
        batch = {"tokens": jax.random.randint(key, (2, 64), 0,
                                              cfg.vocab_size),
                 "labels": jax.random.randint(jax.random.fold_in(key, 1),
                                              (2, 64), 0, cfg.vocab_size)}
        if cfg.family == "vlm":
            batch["patches"] = jax.random.normal(
                key, (2, cfg.vision_patches, cfg.d_model)) * 0.1
    proj = None
    if cfg.is_decoder and cfg.has_attention:
        from repro.config import SALSConfig
        sals = SALSConfig(rank_ratio=0.25, n_critical=8, n_sink=2,
                          n_recent=4, v_group=32, skip_layers_front=1,
                          skip_layers_back=1)
        proj = jcal.random_layer_projectors(key, cfg, sals, cfg.n_layers)
    to_np = lambda t: jax.tree.map(np.array, t)
    return to_np(state["params"]), to_np(batch), \
        None if proj is None else to_np(proj)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_multi_arch_smoke_reproduces_reference(arch, capsys, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "reference_multi_arch_smoke",
        os.path.join(ROOT, "examples", "multi_arch_smoke.py"))
    ref_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_mod)
    monkeypatch.setattr("sys.argv", ["multi_arch_smoke", "--arch", arch])
    ref_mod.main()
    ref = capsys.readouterr().out.strip()

    jparams, batch, jproj = _reference_inputs(arch)
    cfg = get_config(arch).reduced()
    params = convert.params_from_numpy(jparams, cfg, device="cpu",
                                       dtype=torch.float32)
    proj = None if jproj is None else \
        convert.projectors_from_numpy(jproj, device="cpu")
    out = multi_arch_smoke.main(
        ["--arch", arch, "--device", "cpu"], params={arch: params},
        batches={arch: batch}, projectors={arch: proj})
    mine = capsys.readouterr().out.strip()
    untimed = lambda s: re.sub(r"\(\d+\.\ds\)$", "", s)
    assert untimed(mine) == untimed(ref)
    assert len(out) == 1 and out[0]["arch"] == arch
    if cfg.is_decoder:
        assert out[0]["decode_finite"]
        assert out[0]["decode"] == ("sals" if cfg.has_attention
                                    else "recurrent")
    else:
        assert out[0]["decode"] is None


def test_multi_arch_smoke_every_arch_runs_seeded():
    """All ten architectures on the port's own seeded weights and draws:
    a finite loss each, every decoder's decode finite."""
    out = multi_arch_smoke.main(["--device", "cpu"])
    assert [o["arch"] for o in out] == multi_arch_smoke.ASSIGNED_ARCHS
    for o in out:
        assert np.isfinite(o["loss"]), o
        assert o.get("decode_finite", True), o
