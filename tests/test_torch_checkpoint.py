"""Checkpoints, restarts and the training launcher: the reference's
checkpoint / supervisor / straggler cases (``tests/test_system.py``)
against the port's modules, the on-disk layout shared with the reference,
and a trained module handed to the serving engine.

* atomic save / restore with keep-N pruning, a partial ``.tmp`` ignored, a
  torn and a dangling ``LATEST`` pointer, the resume step passed through
  the supervisor, exponential backoff with a cap, a crash mid-training
  resumed to the uninterrupted run's weights, the straggler flags;
* a checkpoint written by the reference restores into the port equal, and
  one written by the port restores into the reference equal (same keys,
  same manifest ``tree_hash``; the port's bf16 leaves travel as f32);
* ``launch/train.py --device cpu`` runs, and with ``--ckpt-dir --resume``
  it continues from the newest checkpoint;
* a module trained two steps serves through ``ServeEngine.generate``
  (the decode step programs) with no autograd graph recorded, equal to
  an engine over a frozen copy of the same weights."""
import os
import shutil

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.train import trainer as jtrainer
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.config import SALSConfig, ServeConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus
from repro_torch.ft import RestartsExhausted, StragglerMonitor, Supervisor
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as ttf
from repro_torch.serve import ServeEngine
from repro_torch.train import trainer

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)


def _cfg():
    return get_config("qwen2-1.5b").reduced(n_layers=2, vocab_size=256,
                                            dtype="float32")


def _state(cfg=None, seed=0, dtype=None):
    cfg = cfg or _cfg()
    return trainer.init_state(cfg, TrainConfig(), device="cpu", seed=seed,
                              dtype=dtype)


def _leaves(state):
    """Every tensor of a train state, in a fixed order."""
    out = [p.detach().clone() for p in state["params"].parameters()]
    opt = state["opt"]
    for name in ("mu", "nu", "master"):
        out += [t.clone() for t in opt.get(name, {}).values()]
    return out + [opt["count"].clone()]


def _assert_states_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The reference's checkpoint / supervisor / straggler cases
# ---------------------------------------------------------------------------

def test_checkpoint_atomic_save_restore(tmp_path):
    state = _state()
    state["opt"]["count"].fill_(7)
    d = str(tmp_path / "ck")
    for step in (10, 20, 30):
        ckpt.save(d, step, state, keep=2)
    assert ckpt.list_checkpoints(d) == [20, 30]      # keep-N pruning
    other = _state(seed=1)
    restored, step = ckpt.restore(d, other)
    assert step == 30 and restored is other
    _assert_states_equal(restored, state)


def test_checkpoint_bf16_state_restores_exactly(tmp_path):
    """bf16 weights with f32 master and moments: written as f32, restored
    to the same bits."""
    state = _state(dtype=torch.bfloat16)
    assert "master" in state["opt"]
    with torch.no_grad():
        for t in state["opt"]["mu"].values():
            t.normal_()
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, state)
    with np.load(os.path.join(d, "step_000000001", "arrays.npz")) as z:
        assert z["params/embed/embedding"].dtype == np.float32
    other = _state(seed=2, dtype=torch.bfloat16)
    ckpt.restore(d, other)
    _assert_states_equal(other, state)


def test_checkpoint_ignores_partial_tmp(tmp_path):
    state = {"params": _state()["params"]}
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, state)
    os.makedirs(os.path.join(d, "step_000000009.tmp"))  # simulated crash
    assert ckpt.latest_step(d) == 5
    _, step = ckpt.restore(d, state)
    assert step == 5


def test_checkpoint_latest_survives_torn_pointer(tmp_path):
    state = {"params": _state()["params"]}
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, state)
    ckpt.save(d, 7, state)
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("step_garbage\x00\x00")          # torn/corrupt pointer
    assert ckpt.latest_step(d) == 7
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("")                              # truncated to empty
    assert ckpt.latest_step(d) == 7
    _, step = ckpt.restore(d, state)
    assert step == 7


def test_checkpoint_latest_survives_dangling_pointer(tmp_path):
    state = {"params": _state()["params"]}
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, state)
    ckpt.save(d, 9, state)
    shutil.rmtree(os.path.join(d, "step_000000009"))   # pruned behind LATEST
    assert ckpt.latest_step(d) == 3
    _, step = ckpt.restore(d, state)
    assert step == 3
    os.makedirs(os.path.join(d, "step_000000011"))     # manifest never landed
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("step_000000011")
    assert ckpt.latest_step(d) == 3
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with open(os.path.join(empty, "LATEST"), "w") as f:
        f.write("step_000000001")
    assert ckpt.latest_step(empty) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(empty, state)


def test_restore_names_missing_keys(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"params": _state()["params"]})
    with pytest.raises(KeyError, match="opt/mu"):
        ckpt.restore(d, _state())


def test_supervisor_passes_resume_step_through():
    seen, attempts = [], {"n": 0}

    def work(resume_step):
        seen.append(resume_step)
        attempts["n"] += 1
        if attempts["n"] < 3:
            raise RuntimeError(f"boom {attempts['n']}")
        return "done"

    sup = Supervisor(max_restarts=3, log=lambda *_: None)
    out = sup.run(work, resume=lambda: 40 + attempts["n"] * 2)
    assert out == "done"
    assert seen == [None, 42, 44]
    assert sup.restarts == 2


def test_supervisor_backoff_exponential_with_cap(monkeypatch):
    import time as _time
    sleeps = []
    monkeypatch.setattr(_time, "sleep", sleeps.append)

    def work(_):
        raise RuntimeError("always down")

    sup = Supervisor(max_restarts=4, backoff_s=1.0, backoff_cap_s=5.0,
                     log=lambda *_: None)
    with pytest.raises(RestartsExhausted) as ei:
        sup.run(work)
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert sleeps == [1.0, 2.0, 4.0, 5.0]
    assert sup.restarts == 5


def test_supervisor_restarts_and_resumes(tmp_path):
    """Crash mid-training; the supervisor resumes from the checkpoint and
    the final state equals an uninterrupted run's, bit for bit."""
    cfg = _cfg()
    tcfg = TrainConfig(steps=10, batch_size=4, seq_len=32, lr=1e-3,
                       checkpoint_every=2, log_every=100)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=3)
    d = str(tmp_path / "ck")
    crashed = {"done": False}

    def train_once(start_step):
        state = trainer.init_state(cfg, tcfg, device="cpu")
        if start_step:
            state, start_step = ckpt.restore(d, state)
        step = trainer.make_train_step(cfg, tcfg)
        for i in range(start_step, tcfg.steps):
            if i == 5 and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("simulated node failure")
            state, _ = step(state, trainer.batch_to(
                corpus.batch(i, 4, 32), "cpu"))
            if (i + 1) % tcfg.checkpoint_every == 0:
                ckpt.save(d, i + 1, state, keep=2)
        return state

    sup = Supervisor(max_restarts=2, log=lambda *_: None)
    state_r = sup.run(lambda _: train_once(ckpt.latest_step(d) or 0))
    assert sup.restarts == 1 and crashed["done"]
    state_ref = trainer.init_state(cfg, tcfg, device="cpu")
    step = trainer.make_train_step(cfg, tcfg)
    for i in range(tcfg.steps):
        state_ref, _ = step(state_ref, trainer.batch_to(
            corpus.batch(i, 4, 32), "cpu"))
    _assert_states_equal(state_r, state_ref)


def test_run_with_restarts_through_train_loop(tmp_path):
    """``ft.run_with_restarts`` around ``train_loop`` with a fault after
    the first checkpoint: the losses after the restart equal the
    uninterrupted run's."""
    from repro_torch.ft import run_with_restarts
    cfg = _cfg()
    tcfg = TrainConfig(steps=6, batch_size=2, seq_len=32, lr=1e-3,
                       checkpoint_every=2, log_every=100)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    d = str(tmp_path / "ck")

    def run(fault_at):
        losses = {}

        def on_step(i, m, _):
            if i == fault_at and not losses.get("faulted"):
                losses["faulted"] = True
                raise RuntimeError("injected fault")
            losses[i] = float(m["loss"])

        def train_once(start):
            state = trainer.init_state(cfg, tcfg, device="cpu")
            if start:
                state, start = ckpt.restore(d, state)
            return trainer.train_loop(
                cfg, tcfg, state=state,
                step_fn=trainer.make_train_step(cfg, tcfg),
                batches=train_cli.batches_for(cfg, corpus, tcfg, start),
                start_step=start, ckpt_dir=d, log=lambda *_: None,
                on_step=on_step)

        run_with_restarts(train_once, d, log=lambda *_: None)
        return losses

    faulted = run(3)
    shutil.rmtree(d)
    clean = run(-1)
    assert faulted.pop("faulted") and "faulted" not in clean
    assert faulted == clean and sorted(clean) == list(range(6))


def test_straggler_monitor_flags_tail():
    mon = StragglerMonitor(window=20, threshold=1.5, patience=3)
    for i in range(20):
        mon.record(i, 0.10 + 0.001 * (i % 3))
    assert not mon.flags
    assert mon.record(20, 0.30)
    mon.record(21, 0.31)
    mon.record(22, 0.32)
    assert mon.should_mitigate()
    mon.record(23, 0.10)
    assert not mon.should_mitigate()


# ---------------------------------------------------------------------------
# The on-disk layout, shared with the reference
# ---------------------------------------------------------------------------

def _jstate():
    jcfg = jax_get_config("qwen2-1.5b").reduced(n_layers=2, vocab_size=256,
                                                dtype="float32")
    jt = JTrainConfig(steps=4, batch_size=2, seq_len=16, lr=1e-3)
    state = jtrainer.init_state(KEY, jcfg, jt, jnp.float32)
    batch = jax.tree.map(jnp.asarray, SyntheticCorpus(256).batch(0, 2, 16))
    state, _ = jax.jit(jtrainer.make_train_step(jcfg, jt))(state, batch)
    return state                      # nonzero moments, count 1


def _manifest(d, step):
    import json
    with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
        return json.load(f)


def test_reference_checkpoint_restores_into_port(tmp_path):
    jstate = _jstate()
    d = str(tmp_path / "ref")
    jckpt.save(d, 4, jstate)
    state = _state()
    _, step = ckpt.restore(d, state)
    assert step == 4 and int(state["opt"]["count"]) == 1
    mine = convert.state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jstate)),
                    jax.tree.leaves(mine), strict=True):
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_restores_into_reference(tmp_path):
    jstate = _jstate()
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                     _cfg(), device="cpu")
    d_port, d_ref = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(d_port, 4, state)
    jckpt.save(d_ref, 4, jstate)
    mine, ref = _manifest(d_port, 4), _manifest(d_ref, 4)
    for k in ("keys", "shapes", "dtypes", "tree_hash"):
        assert mine[k] == ref[k], k
    zeroed = jax.tree.map(jnp.zeros_like, jstate)
    restored, step = jckpt.restore(d_port, zeroed)
    assert step == 4
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_bf16_leaves_restore_into_port(tmp_path):
    """A reference checkpoint of bf16 weights (numpy stores them as raw
    2-byte records) restores into a bf16 port model bit for bit."""
    jcfg = jax_get_config("qwen2-1.5b").reduced(n_layers=2, vocab_size=256)
    from repro.models import transformer as jtf
    jp = jtf.init_params(KEY, jcfg, jnp.bfloat16)
    d = str(tmp_path / "ref")
    jckpt.save(d, 1, {"params": jp})
    cfg = get_config("qwen2-1.5b").reduced(n_layers=2, vocab_size=256)
    params = ttf.Transformer(cfg, torch.bfloat16, "cpu")
    ckpt.restore(d, {"params": params})
    want = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")
    for a, b in zip(params.parameters(), want.parameters(), strict=True):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The launcher on the CPU
# ---------------------------------------------------------------------------

def test_train_cli_runs_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    common = ["--arch", "qwen2-1.5b", "--device", "cpu", "--batch-size",
              "2", "--seq-len", "32", "--ckpt-dir", d,
              "--checkpoint-every", "2"]
    train_cli.main(common + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "step 0: loss=" in out and "step 2: loss=" in out
    assert ckpt.list_checkpoints(d) == [2]
    train_cli.main(common + ["--steps", "5", "--resume"])
    out = capsys.readouterr().out
    assert "[train] restored step 2" in out and "step 4: loss=" in out
    assert "step 0:" not in out
    assert ckpt.list_checkpoints(d) == [2, 4]


def test_train_cli_vlm_and_remat(capsys):
    train_cli.main(["--arch", "paligemma-3b", "--device", "cpu", "--steps",
                    "2", "--batch-size", "2", "--seq-len", "16", "--remat",
                    "block", "--microbatches", "2"])
    out = capsys.readouterr().out
    assert "step 1: loss=" in out


# ---------------------------------------------------------------------------
# A trained module serves
# ---------------------------------------------------------------------------

def test_trained_module_serves_without_autograd_graph():
    """Two train steps, then ``ServeEngine.generate`` with the decode step
    programs: autograd saves no tensor during the run (no graph is
    recorded), and the tokens equal an engine's over a frozen copy of the
    weights."""
    cfg = get_config("qwen2-1.5b").reduced(dtype="float32")
    tcfg = TrainConfig(steps=2, batch_size=2, seq_len=32, lr=1e-3)
    state = trainer.init_state(cfg, tcfg, device="cpu")
    step = trainer.make_train_step(cfg, tcfg)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    for i in range(2):
        state, _ = step(state, trainer.batch_to(corpus.batch(i, 2, 32),
                                                "cpu"))
    trained = state["params"]
    assert all(p.requires_grad for p in trained.parameters())
    frozen = ttf.Transformer(cfg, device="cpu")
    frozen.load_state_dict(trained.state_dict())
    assert not any(p.requires_grad for p in frozen.parameters())

    sals = SALSConfig(n_critical=10, n_sink=2, n_recent=8, v_group=16,
                      skip_layers_front=1, skip_layers_back=1)
    rng = np.random.default_rng(0)
    u = torch.from_numpy(np.stack([np.linalg.qr(rng.standard_normal(
        (cfg.kv_dim, sals.rank(cfg.kv_dim))))[0] for _ in range(
            cfg.n_layers)]).astype(np.float32))
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (30, 21)]
    outs, saved = [], []
    for params in (trained, frozen):
        eng = ServeEngine(params, {"u": u}, cfg,
                          ServeConfig(max_seq_len=64, sals=sals),
                          device="cpu")
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.shape) or t, lambda t: t):
            outs.append(eng.generate(prompts, max_new_tokens=4))
    assert not saved
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.tokens, b.tokens)
