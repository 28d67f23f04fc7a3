"""The port's examples (``repro_torch.examples``) against the repository's
``examples/*.py`` on the CPU: each reference example is loaded from its
file and run into ``capsys``, then the port's ``main`` runs on the
reference's weights (carried over by ``convert``).

* ``quickstart``: every printed line but the timings equal, the greedy
  token lists of ``full``, ``sals`` and ``sals-g2`` exactly;
* ``train_then_serve`` (6 steps, d 128, 3 layers, vocab 256): the printed
  losses, the calibration line and the agreements equal, the scheduler's
  greedy tokens for ``full``, ``sals25`` and ``sals25-g2`` exactly;
* ``fault_tolerant_train``: the printed losses, restarts and checkpoints
  equal; the port's recovery bit for bit (delta 0), its final state within
  ``tests/test_torch_train.py``'s tolerances of the reference's;
* the examples' SALS settings at their configs on the card pass every check
  the top-k and recon wrappers make before their device check.

``multi_arch_smoke`` is held to its reference in
``tests/test_torch_examples_archs.py``."""
import importlib.util
import os
import re

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf
from repro.serve import RequestScheduler as JScheduler
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.examples import (fault_tolerant_train, multi_arch_smoke,
                                  quickstart, train_then_serve)
from repro_torch.kernels import latent_score as ls
from repro_torch.kernels import sparse_recon_attention as sra
from repro_torch.launch import model_config

from test_torch_train import _assert_state_close, _flat

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUDA = torch.device("cuda")


def load_reference(name: str):
    """``examples/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(ROOT, "examples",
                                                  f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TIMING = re.compile(r"\(\d+(\.\d+)?s\)|in \d+(\.\d+)?s|-> [\d.]+ tok/s")


def _untimed(out: str) -> list:
    """Printed lines with the wall-clock figures blanked."""
    return [TIMING.sub("<t>", ln) for ln in out.splitlines()]


def _port_params(jparams, cfg):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_reproduces_reference(capsys):
    load_reference("quickstart").main()
    ref = capsys.readouterr().out
    jp = jtf.init_params(KEY, jax_get_config("yi-9b").reduced(), jnp.float32)
    out = quickstart.main(["--device", "cpu"], params=_port_params(
        jp, get_config("yi-9b").reduced()))
    mine = capsys.readouterr().out
    assert _untimed(mine) == _untimed(ref)
    for name in ("full", "sals", "sals-g2"):
        line = next(ln for ln in ref.splitlines()
                    if ln.startswith(f"{name}: "))
        tokens = eval(line[len(name) + 2:line.rindex(" (")])
        assert out["tokens"][name] == tokens, name
    assert "cache: 104 B/token/layer vs 256 B full" in mine


# ---------------------------------------------------------------------------
# train_then_serve
# ---------------------------------------------------------------------------

TTS_ARGV = ["--steps", "6", "--d-model", "128", "--layers", "3", "--vocab",
            "256", "--batch-size", "4", "--seq-len", "64"]


def test_train_then_serve_reproduces_reference(tmp_path, capsys,
                                               monkeypatch):
    ref_mod = load_reference("train_then_serve")
    served = []

    class Recording(JScheduler):
        def run(self, *a, **kw):
            done = super().run(*a, **kw)
            served.append([r.result.tokens.tolist() for r in done])
            return done

    monkeypatch.setattr(ref_mod, "RequestScheduler", Recording)
    monkeypatch.setattr("sys.argv", ["train_then_serve"] + TTS_ARGV + [
        "--ckpt-dir", str(tmp_path / "ref")])
    ref_mod.main()
    ref = capsys.readouterr().out

    kw = dict(name="e2e-demo", family="dense", n_layers=3, d_model=128,
              n_heads=2, n_kv_heads=2, head_dim=64, d_ff=384,
              vocab_size=256)
    jstate = jtrainer.init_state(KEY, JModelConfig(**kw), JTrainConfig(),
                                 jnp.float32)
    out = train_then_serve.main(
        TTS_ARGV + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"],
        params=_port_params(jstate["params"], ModelConfig(**kw)))
    mine = capsys.readouterr().out
    assert _untimed(mine) == _untimed(ref)
    assert [out["tokens"][k] for k in ("full", "sals25", "sals25-g2")] == \
        served
    assert out["requests_done"] == {"full": 8, "sals25": 8, "sals25-g2": 8}


def test_train_then_serve_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--steps", "4", "--d-model", "128", "--layers", "2", "--vocab",
            "256", "--batch-size", "2", "--seq-len", "64", "--ckpt-dir",
            str(tmp_path), "--device", "cpu"]
    from repro_torch import checkpoint as ckpt
    from repro_torch.config import TrainConfig
    from repro_torch.train import trainer
    cfg = ModelConfig(name="e2e-demo", family="dense", n_layers=2,
                      d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
                      d_ff=384, vocab_size=256)
    ckpt.save(str(tmp_path), 3, trainer.init_state(
        cfg, TrainConfig(), device="cpu", dtype=torch.float32))
    out = train_then_serve.main(argv)
    printed = capsys.readouterr().out
    assert "resumed from checkpoint step 3" in printed
    assert out["steps_run"] == 1 and "trained 1 steps" in printed


# ---------------------------------------------------------------------------
# fault_tolerant_train
# ---------------------------------------------------------------------------

def test_fault_tolerant_train_reproduces_reference(tmp_path, capsys,
                                                   monkeypatch):
    ref_mod = load_reference("fault_tolerant_train")
    recovered = []

    class Recording(ref_mod.Supervisor):
        def run(self, *a, **kw):
            state = super().run(*a, **kw)
            recovered.append(state)
            return state

    monkeypatch.setattr(ref_mod, "CKPT", str(tmp_path / "ref"))
    monkeypatch.setattr(ref_mod, "Supervisor", Recording)
    ref_mod.main()
    ref = capsys.readouterr().out

    over = dict(n_layers=2, vocab_size=512)
    jstate = jtrainer.init_state(
        KEY, jax_get_config("qwen2-1.5b").reduced(**over), JTrainConfig(),
        jnp.float32)
    out = fault_tolerant_train.main(
        ["--device", "cpu"], ckpt_dir=str(tmp_path / "port"),
        params=_port_params(jstate["params"],
                            get_config("qwen2-1.5b").reduced(**over)))
    mine = capsys.readouterr().out

    def summary(text):
        keep = ("  step ", "  -> resumed", "finished with", "max param")
        return [ln for ln in _untimed(text) if ln.startswith(keep)]

    assert summary(mine) == summary(ref)
    assert "EXACT RECOVERY" in mine and out["max_delta"] == 0.0
    assert out["restarts"] == 2 and out["checkpoints"] == [25, 30]
    # the port's recovery is bit for bit: every tensor of the state
    a, b = (_flat(convert.state_to_numpy(s))
            for s in (out["state"], out["uninterrupted"]))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # against the reference's recovered state after 30 steps
    _assert_state_close(a, _flat(jax.tree.map(np.asarray, recovered[0])),
                        1e-4, "fault_tolerant_train")


# ---------------------------------------------------------------------------
# The examples' SALS settings on the card
# ---------------------------------------------------------------------------

def _card_cases():
    tts = ModelConfig(name="e2e-demo", family="dense", n_layers=8,
                      d_model=512, n_heads=8, n_kv_heads=2, head_dim=64,
                      d_ff=1536, vocab_size=32768)          # --full-100m
    yield "quickstart", model_config("yi-9b", True, CUDA, log=len), \
        quickstart.SALS
    yield "train_then_serve", tts, train_then_serve.sals_for(tts)
    for arch in multi_arch_smoke.ASSIGNED_ARCHS:
        cfg = model_config(arch, True, CUDA, log=lambda *_: None)
        if cfg.is_decoder and cfg.has_attention:
            yield f"multi_arch_smoke-{arch}", cfg, \
                multi_arch_smoke.sals_for(cfg)


@pytest.mark.parametrize("case", [c[0] for c in _card_cases()])
def test_example_sals_on_the_card_passes_the_wrappers(case):
    """Computed without a card: at head_dim 64 the top-k and recon
    wrappers run every check they make before the device check (r % 8,
    r* bounds, N_c, the value groups, the shared memory of the query
    split) and stop only there (the tensors lie on the CPU)."""
    _, cfg, sals = next(c for c in _card_cases() if c[0] == case)
    assert cfg.head_dim == 64
    b, s, kvd = 2, 512, cfg.kv_dim
    r, r_star = sals.rank(kvd), sals.score_rank(kvd)
    k_lat = torch.zeros((b, s, r), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        ls.latent_topk_cuda(torch.zeros((b, r_star)), k_lat, None, s - 1,
                            n_critical=sals.n_critical, n_sink=sals.n_sink,
                            n_recent=sals.n_recent)
    code_w = kvd if sals.v_bits == 8 else kvd // 2
    code = torch.int8 if sals.v_bits == 8 else torch.uint8
    groups = torch.zeros((b, s, kvd // sals.v_group), dtype=torch.bfloat16)
    q = torch.zeros((b, 1, cfg.n_heads, cfg.head_dim), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        sra.sparse_recon_attention_window_cuda(
            q, k_lat, None, torch.zeros((b, s, code_w), dtype=code),
            groups, groups.clone(),
            torch.zeros((kvd, r), dtype=torch.bfloat16),
            torch.zeros((b, sals.n_critical), dtype=torch.int32),
            torch.zeros((b, sals.n_critical), dtype=torch.bool), s - 1,
            n_kv=cfg.n_kv_heads, n_recent=sals.n_recent,
            v_bits=sals.v_bits, v_group=sals.v_group)
