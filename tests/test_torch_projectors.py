"""The uncalibrated projector helpers and the layer-adaptive ranks against
the JAX reference (``repro.core.projection.random_projector``,
``repro.core.calibration.random_layer_projectors`` / ``adaptive_ranks``).

* ``orthonormal_projector`` on the reference's Gaussian matrix: the QR's
  columns within 1e-5 of the reference's up to column sign, all-one
  eigenvalues; ``random_projector`` from a generator: orthonormal,
  reproducible per seed, on the asked device;
* ``random_layer_projectors`` on the reference's per-layer Gaussians:
  (L, kvd, r) bf16 and (L, kvd) f32 ones, each layer's columns within 1e-5
  of the reference's up to sign before the bf16 cast and within one bf16
  step after it; from a generator: orthonormal, layers distinct,
  reproducible;
* ``adaptive_ranks``: integer for integer the reference's over seeded
  eigenvalue spectra (decaying, flat, with zeros and negatives), energy
  targets and rounding steps, from numpy and from tensors."""
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
from repro.core import projection as jproj
from repro_torch.config import SALSConfig
from repro_torch.configs import get_config
from repro_torch.core import calibration as cal
from repro_torch.core import projection as proj

torch.set_num_threads(1)


def _signs_aligned(u, ref):
    """``u`` with each column's sign flipped to the reference's."""
    s = np.sign(np.sum(u * ref, axis=0))
    s[s == 0] = 1
    return u * s


@pytest.mark.parametrize("kvd,rank,seed", [(64, 16, 0), (128, 32, 1),
                                           (256, 64, 2), (40, 8, 3)])
def test_orthonormal_projector_equals_reference_qr(kvd, rank, seed):
    key = jax.random.PRNGKey(seed)
    ref = jproj.random_projector(key, kvd, rank)
    g = np.array(jax.random.normal(key, (kvd, kvd), jnp.float32))
    mine = proj.orthonormal_projector(torch.from_numpy(g), rank)
    u = mine["u"].numpy()
    assert u.shape == (kvd, rank) and mine["u"].dtype == torch.float32
    np.testing.assert_allclose(_signs_aligned(u, np.asarray(ref["u"])),
                               np.asarray(ref["u"]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(mine["eigvals"].numpy(),
                                  np.asarray(ref["eigvals"]))


def test_random_projector_from_a_generator():
    a = proj.random_projector(96, 24, torch.Generator().manual_seed(5))
    b = proj.random_projector(96, 24, torch.Generator().manual_seed(5))
    c = proj.random_projector(96, 24, torch.Generator().manual_seed(6))
    u = a["u"].double()
    torch.testing.assert_close(u.T @ u, torch.eye(24, dtype=torch.float64),
                               atol=1e-5, rtol=0)
    assert torch.equal(a["u"], b["u"]) and not torch.equal(a["u"], c["u"])
    assert a["u"].device.type == "cpu" and a["eigvals"].shape == (96,)
    assert torch.equal(a["eigvals"], torch.ones(96))


@pytest.mark.parametrize("arch,ratio", [("yi-9b", 0.25), ("gemma-2b", 0.25),
                                        ("hymba-1.5b", 0.125),
                                        ("qwen2-1.5b", 0.5)])
def test_random_layer_projectors_equal_reference(arch, ratio):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jsals, sals = JSALS(rank_ratio=ratio), SALSConfig(rank_ratio=ratio)
    key = jax.random.PRNGKey(4)
    n = cfg.n_layers
    ref = jcal.random_layer_projectors(key, jcfg, jsals, n)
    gauss = np.stack([np.asarray(jax.random.normal(k, (jcfg.kv_dim,) * 2,
                                                   jnp.float32))
                      for k in jax.random.split(key, n)])
    mine = cal.random_layer_projectors(cfg, sals, n,
                                       gaussians=torch.from_numpy(gauss))
    r = sals.rank(cfg.kv_dim)
    assert mine["u"].dtype == torch.bfloat16 == cal.U_DTYPE
    assert tuple(mine["u"].shape) == tuple(ref["u"].shape) == \
        (n, cfg.kv_dim, r)
    np.testing.assert_array_equal(mine["eigvals"].numpy(),
                                  np.asarray(ref["eigvals"]))
    assert mine["eigvals"].dtype == torch.float32
    ref_u = np.asarray(ref["u"].astype(jnp.float32))
    for l in range(n):
        f32 = proj.orthonormal_projector(torch.from_numpy(gauss[l]), r)
        q_ref = np.asarray(jnp.linalg.qr(jnp.asarray(gauss[l]))[0][:, :r])
        np.testing.assert_allclose(
            _signs_aligned(f32["u"].numpy(), q_ref), q_ref, atol=1e-5,
            rtol=0)
        # after the bf16 cast: within one bf16 step of the reference's
        u = _signs_aligned(mine["u"][l].float().numpy(), ref_u[l])
        np.testing.assert_allclose(u, ref_u[l], rtol=2.0 ** -7, atol=1e-6)


def test_random_layer_projectors_from_a_generator():
    cfg = get_config("yi-9b").reduced()
    sals = SALSConfig()
    a = cal.random_layer_projectors(cfg, sals, 3,
                                    torch.Generator().manual_seed(0))
    b = cal.random_layer_projectors(cfg, sals, 3)        # default seed 0
    assert torch.equal(a["u"], b["u"])
    assert not torch.equal(a["u"][0], a["u"][1])
    for l in range(3):
        u = a["u"][l].double()
        torch.testing.assert_close(u.T @ u, torch.eye(u.shape[1],
                                                      dtype=torch.float64),
                                   atol=2e-2, rtol=0)     # bf16 storage
    g = cal.layer_gaussians(cfg.kv_dim, 3)
    assert g.shape == (3, cfg.kv_dim, cfg.kv_dim) and g.dtype == torch.float32
    c = cal.random_layer_projectors(cfg, sals, 3, gaussians=g)
    assert torch.equal(a["u"], c["u"])


def _spectra(seed):
    rng = np.random.default_rng(seed)
    kvd = int(rng.choice([32, 64, 100, 256]))
    decay = np.sort(rng.exponential(1.0, (4, kvd)) ** 3, axis=1)[:, ::-1]
    flat = np.ones((1, kvd))
    mixed = np.sort(rng.standard_normal((2, kvd)), axis=1)[:, ::-1]
    zeros = np.zeros((1, kvd))
    return np.concatenate([decay, flat, mixed, zeros]).astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("energy,round_to", [(0.9, 8), (0.5, 8), (0.99, 16),
                                             (0.75, 1), (1.0, 8)])
def test_adaptive_ranks_equal_reference(seed, energy, round_to):
    ev = _spectra(seed)
    ref = jcal.adaptive_ranks(jnp.asarray(ev), energy, round_to)
    mine = cal.adaptive_ranks(ev, energy, round_to)
    assert mine == ref and all(type(r) is int for r in mine)
    assert cal.adaptive_ranks(torch.from_numpy(ev), energy, round_to) == ref
