"""Temperature sampling in the port: ``ServeEngine._sample`` draws from
``softmax(logits / T)`` (chi-square over 2**16 draws, the test itself
checked on ``jax.random.categorical``'s draws from the same logits), the
engine's generator makes ``generate`` and scheduler runs reproducible per
seed, ``temperature == 0`` stays the greedy argmax, ``sample_checked``
still flags non-finite rows, and an eviction under sampling warns.  The
streams differ from ``jax.random``'s, so only distributions are compared
across the packages."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.config import SALSConfig as JSALS
from repro.config import ServeConfig as JServe
from repro.configs import get_config as jax_get_config
from repro.core import calibration as jcal
from repro.models import transformer as jtf
from repro.serve import ServeEngine as JEngine
from repro_torch.config import SALSConfig, ServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, projectors_from_numpy
from repro_torch.serve import Request, RequestScheduler, ServeEngine

torch.set_num_threads(1)

SALS_KW = dict(rank_ratio=0.5, score_ratio=0.5, n_critical=16, n_sink=2,
               n_recent=8, v_bits=8, v_group=32, skip_layers_front=1,
               skip_layers_back=1)
N_DRAWS = 2 ** 16
P_MIN = 1e-3


@pytest.fixture(scope="module")
def model():
    over = dict(n_layers=3, vocab_size=128, dtype="float32")
    jcfg = jax_get_config("qwen2-1.5b").reduced(**over)
    cfg = get_config("qwen2-1.5b").reduced(**over)
    key = jax.random.PRNGKey(0)
    jsals, sals = JSALS(**SALS_KW), SALSConfig(**SALS_KW)
    jp = jtf.init_params(key, jcfg, jnp.float32)
    ju = jcal.random_layer_projectors(key, jcfg, jsals, jcfg.n_layers)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tu = projectors_from_numpy({"u": np.asarray(ju["u"])}, device="cpu")
    return dict(j=(jp, ju, jcfg, jsals), t=(tp, tu, cfg, sals))


def _engine(model, **skw) -> ServeEngine:
    tp, tu, cfg, sals = model["t"]
    return ServeEngine(tp, tu, cfg, ServeConfig(sals=sals, **skw),
                       device="cpu")


def _prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 127, size=n).astype(np.int32) for n in sizes]


def chi2_p(draws: np.ndarray, probs: np.ndarray) -> float:
    """p-value of a chi-square goodness-of-fit test of ``draws`` (ids)
    against ``probs``; ids whose expected count is below 5 share one
    bin."""
    n = len(draws)
    counts = np.bincount(draws, minlength=len(probs)).astype(np.float64)
    exp = probs * n
    small = exp < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(exp[~small], exp[small].sum())
    if exp[-1] == 0:
        assert obs[-1] == 0, "a draw of zero probability"
        obs, exp = obs[:-1], exp[:-1]
    stat = float(((obs - exp) ** 2 / exp).sum())
    return float(stats.chi2.sf(stat, len(exp) - 1))


def _logits(v: int = 64, seed: int = 4) -> np.ndarray:
    return (2.0 * np.random.default_rng(seed).standard_normal(v)) \
        .astype(np.float32)


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_sample_matches_softmax(model, temperature):
    """2**16 draws of ``_sample`` from one fixed row of logits, tiled,
    pass a chi-square test against ``softmax(logits / T)``; so do
    ``jax.random.categorical``'s draws from the same numpy logits."""
    row = _logits()
    probs = np.exp((row - row.max()) / temperature)
    probs /= probs.sum()
    eng = _engine(model, max_seq_len=64, temperature=temperature)
    tiled = torch.as_tensor(np.tile(row, (N_DRAWS, 1)))
    draws = eng._sample(tiled).numpy()
    assert draws.dtype == np.int32 and draws.shape == (N_DRAWS,)
    assert chi2_p(draws, probs) > P_MIN
    jdraws = np.asarray(jax.random.categorical(
        jax.random.PRNGKey(int(10 * temperature)),
        jnp.asarray(np.tile(row, (N_DRAWS, 1))) / temperature, axis=-1))
    assert chi2_p(jdraws, probs) > P_MIN
    # the test has power: a draw from a sharper distribution fails it
    sharper = eng._sample(tiled * 1.25).numpy()
    assert chi2_p(sharper, probs) < P_MIN


def test_zero_temperature_is_greedy(model):
    """temperature 0: ``_sample`` is the argmax bit for bit (ties to the
    first id) and ``generate`` gives the JAX engine's greedy tokens."""
    eng = _engine(model, max_seq_len=64)
    logits = torch.as_tensor(np.stack([_logits(seed=s) for s in range(8)]))
    logits[3, 10] = logits[3, 20] = logits[3].max() + 1.0     # a tie
    assert torch.equal(eng._sample(logits),
                       torch.argmax(logits, dim=-1).to(torch.int32))
    assert int(eng._sample(logits)[3]) == 10
    jp, ju, jcfg, jsals = model["j"]
    jeng = JEngine(jp, ju, jcfg, JServe(max_seq_len=64, sals=jsals,
                                        temperature=0.0))
    prompts = _prompts([20, 14])
    want = [r.tokens for r in jeng.generate(prompts, max_new_tokens=6)]
    got = [r.tokens for r in eng.generate(prompts, max_new_tokens=6)]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_generate_reproducible_per_seed(model):
    """``generate`` reseeds the engine's generator at each call: the same
    seed twice gives the same tokens, another seed other ones."""
    prompts = _prompts([20, 14, 9])
    eng = _engine(model, max_seq_len=64, temperature=1.0, seed=7)
    a = [r.tokens for r in eng.generate(prompts, max_new_tokens=12)]
    b = [r.tokens for r in eng.generate(prompts, max_new_tokens=12)]
    c = [r.tokens for r in _engine(model, max_seq_len=64, temperature=1.0,
                                   seed=8).generate(prompts,
                                                    max_new_tokens=12)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    greedy = [r.tokens for r in _engine(model, max_seq_len=64)
              .generate(prompts, max_new_tokens=12)]
    assert not all(np.array_equal(x, y) for x, y in zip(a, greedy))


@pytest.mark.parametrize("page_size", [0, 16], ids=["dense", "paged"])
def test_scheduler_reproducible_per_seed(model, page_size):
    """Each scheduler run reseeds the generator (the reference's
    ``PRNGKey(seed)`` per run): two runs of one engine give the same
    sampled tokens."""
    eng = _engine(model, max_seq_len=128, max_batch=2, prefill_chunk=8,
                  page_size=page_size, temperature=0.8, seed=3,
                  audit_every=1)
    prompts = _prompts([20, 11, 17], seed=2)

    def run():
        sched = RequestScheduler(eng)
        reqs = [Request(p, max_new_tokens=8) for p in prompts]
        for r in reqs:
            sched.submit(r)
        sched.run()
        assert all(r.done for r in reqs)
        return [r.result.tokens for r in reqs]

    a, b = run(), run()
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_sample_checked_flags_nonfinite_rows(model):
    """Under T > 0 a NaN or inf row still samples an in-vocab id and is
    flagged; the finite rows are not."""
    eng = _engine(model, max_seq_len=64, temperature=0.7)
    logits = torch.as_tensor(np.stack([_logits(v=128, seed=s)
                                       for s in range(4)]))
    logits[1, 5] = float("nan")
    logits[2, 7] = float("inf")
    tok, ok = eng.sample_checked(logits)
    assert ok.tolist() == [True, False, False, True]
    assert ((tok >= 0) & (tok < 128)).all()


def test_eviction_warns_under_temperature(model):
    """Pool exhaustion evicts a resident; under temperature > 0 its re-run
    resamples, which the scheduler warns of (the reference's warning)."""
    eng = _engine(model, max_seq_len=64, max_batch=3, prefill_chunk=8,
                  page_size=8, n_pages=9, audit_every=1, temperature=0.7)
    rng = np.random.default_rng(11)
    sched = RequestScheduler(eng)
    reqs = [Request(rng.integers(1, 128, 30).astype(np.int32),
                    max_new_tokens=8) for _ in range(3)]
    for r in reqs:
        sched.submit(r)
    with pytest.warns(RuntimeWarning, match="temperature > 0"):
        sched.run()
    assert sched.evictions >= 1 and all(r.done for r in reqs)
