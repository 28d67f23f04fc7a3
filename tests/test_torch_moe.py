"""Port parity for the mixture-of-experts layer (``models/moe.py``) against
the JAX reference's ``moe_apply`` on the same seeded weights and inputs,
in float32:

* y and the aux loss within 1e-5, at the reduced llama4-scout (top-1 +
  the shared expert) and qwen3-moe (top-2) configs, over one dispatch
  group, two groups of 256 tokens, a row that is not a multiple of 256
  (one group of the whole row), and decode's one-token rows;
* a capacity factor of 1.0, which drops tokens past capacity: equal to
  the reference, and different from the drop-free result;
* ties between experts (duplicated router columns): the lower index wins
  as in ``jax.lax.top_k``;
* ``_capacity`` equal to the reference's over a grid of sizes."""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
_jmoe_apply = jax.jit(jmoe.moe_apply, static_argnums=2)


def _configs(arch, **over):
    over = dict(dtype="float32", **over)
    return (jax_get_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


def _layer(jcfg, cfg, seed=0, tie=False):
    """The reference's initializer, carried into the port's module; with
    ``tie`` expert 2's router column is expert 1's (a tie at every
    token)."""
    jp = jax.jit(jmoe.moe_init, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if tie:
        jp = dict(jp, router=jp["router"].at[:, 2].set(jp["router"][:, 1]))
    mod = tmoe.MoE(cfg, torch.float32, "cpu")
    for name, p in mod.named_parameters():
        src = jp
        for part in name.split("."):
            src = src[part]
        p.data.copy_(tensor_from_numpy(np.asarray(src), "cpu"))
    return jp, mod


def _both(jcfg, cfg, jp, mod, x):
    jy, jaux = _jmoe_apply(jp, jnp.asarray(x), jcfg)
    with torch.inference_mode():
        ty, taux = tmoe.moe_apply(mod, torch.from_numpy(x), cfg)
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


@pytest.mark.parametrize("b,s", [(2, 40), (1, 512), (2, 300), (4, 1)],
                         ids=["one-group", "two-groups", "whole-row",
                              "decode"])
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "qwen3-moe-235b-a22b"])
def test_moe_apply_matches_reference(arch, b, s):
    jcfg, cfg = _configs(arch)
    jp, mod = _layer(jcfg, cfg)
    x = np.random.default_rng(s).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    (jy, jaux), (ty, taux) = _both(jcfg, cfg, jp, mod, x)
    np.testing.assert_allclose(jy, ty, **TOL)
    np.testing.assert_allclose(jaux, taux, **TOL)
    if arch.startswith("llama4"):     # the shared expert contributes
        assert mod.shared is not None


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "qwen3-moe-235b-a22b"])
def test_moe_apply_drops_past_capacity(arch):
    """At capacity factor 1.0 a 64-token group routes past some expert's
    capacity: the dropped (token, slot) pairs contribute nothing, in the
    reference's cumsum order."""
    jcfg, cfg = _configs(arch, moe_capacity_factor=1.0)
    jp, mod = _layer(jcfg, cfg, seed=3)
    x = np.random.default_rng(5).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    (jy, jaux), (ty, taux) = _both(jcfg, cfg, jp, mod, x)
    np.testing.assert_allclose(jy, ty, **TOL)
    np.testing.assert_allclose(jaux, taux, **TOL)
    free = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    with torch.inference_mode():
        y_free, _ = tmoe.moe_apply(mod, torch.from_numpy(x), free)
    assert not np.allclose(y_free.numpy(), ty, **TOL)


def test_moe_apply_ties_pick_lower_expert():
    """Experts 1 and 2 score alike at every token: top-k must rank them as
    ``jax.lax.top_k`` does (the lower index first), so y and the aux loss
    (which counts each token's first choice) equal the reference's."""
    jcfg, cfg = _configs("qwen3-moe-235b-a22b", moe_capacity_factor=1.0)
    jp, mod = _layer(jcfg, cfg, seed=7, tie=True)
    x = np.random.default_rng(9).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32)
    (jy, jaux), (ty, taux) = _both(jcfg, cfg, jp, mod, x)
    np.testing.assert_allclose(jy, ty, **TOL)
    np.testing.assert_allclose(jaux, taux, **TOL)
    with torch.inference_mode():
        probs = torch.softmax(torch.from_numpy(x) @ mod.router, dim=-1)
    _, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    pair = idx[..., :2].sort(dim=-1).values
    assert ((pair == torch.tensor([1, 2])).all(-1)).any()  # ties did bite


def test_capacity_matches_reference():
    for n in (1, 7, 64, 256, 4096):
        for e, k in ((4, 1), (4, 2), (16, 1), (128, 8)):
            for cf in (1.0, 1.25, 8.0):
                assert tmoe._capacity(n, e, k, cf) == \
                    jmoe._capacity(n, e, k, cf)
    assert tmoe.MOE_GROUP == jmoe.MOE_GROUP
    assert tmoe.CAPACITY_FACTOR == jmoe.CAPACITY_FACTOR
