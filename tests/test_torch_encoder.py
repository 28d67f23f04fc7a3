"""The encoder family (hubert-xlarge) against the JAX reference on the CPU:
the reduced config in f32 (3 layers, d 128, 4 / 2 heads of dh 32, vocab
512), weights carried over from the reference's ``tf.init_params``.

* ``forward`` on frame embeddings: logits within 1e-4 (non-causal, no
  RoPE, the untied unembed);
* ``forward_loss`` at remat "none" and "block" within 1e-5 relative;
* two ``make_train_step`` steps from the same state on the reference's
  frontend-stub frames (its ``jax.random`` table, handed to the port's
  ``batches_for``): metrics within 1e-5 relative, every weight and
  moment within 1e-5 after one step and 1e-4 after two, but for weights
  whose gradient is at f32 noise level (``tests/test_torch_train.py``'s
  tolerances and its ``_assert_state_close``);
* ``convert`` carries the encoder's parameters and train state across
  and back (embed with its untied unembed of vocab 504, blocks,
  final_norm);
* the frontend stub: frames are rows of an N(0, 0.02) table at the
  tokens, labels mod vocab; ``launch.train`` runs the encoder."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as ttf
from repro_torch.train import trainer
from test_torch_train import _assert_state_close

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
ARCH = "hubert-xlarge"
METRICS = ("loss", "ce", "aux", "grad_norm", "lr")


def _pair(**over):
    return (jax_get_config(ARCH).reduced(dtype="float32", **over),
            get_config(ARCH).reduced(dtype="float32", **over))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _pair()
    jp = jtf.init_params(KEY, jcfg, jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu")
    return jp, jcfg, tp, cfg


def _frames_batch(cfg, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.normal(0, 0.5, (b, s, cfg.d_model))
            .astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s))
            .astype(np.int32)}


def _t(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _ref_table(cfg) -> np.ndarray:
    """The reference launcher's frontend-stub table (``to_frames``)."""
    return np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (cfg.vocab_size, cfg.d_model),
        jnp.float32) * 0.02)


def test_config_is_the_references(model):
    _, jcfg, _, cfg = model
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.vocab_size) == (3, 128, 4, 2, 32, 512)
    full = get_config(ARCH)
    assert (full.family, full.head_dim, full.causal, full.use_rope,
            full.tie_embeddings) == ("encoder", 80, False, False, False)
    assert full.param_count() == jax_get_config(ARCH).param_count()


def test_forward_equals_reference(model):
    """Logits on the same frames within 1e-4; prefix_len 0, the frames
    cast to the params' dtype."""
    jp, jcfg, tp, cfg = model
    batch = _frames_batch(cfg)
    j_logits, _ = jtf.forward(jp, jcfg, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        x, prefix = ttf.embed_inputs(tp, cfg, _t(batch))
        logits, aux = ttf.forward(tp, cfg, _t(batch))
    assert prefix == 0 and x.dtype == torch.float32
    assert logits.shape == (2, 32, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)


def test_encoder_attention_is_bidirectional(model):
    """A change to the last frame moves the first position's logits: no
    causal mask."""
    _, _, tp, cfg = model
    batch = _t(_frames_batch(cfg, b=1))
    with torch.no_grad():
        base, _ = ttf.forward(tp, cfg, batch)
        moved = dict(batch, frames=batch["frames"].clone())
        moved["frames"][:, -1] += 1.0
        after, _ = ttf.forward(tp, cfg, moved)
    assert float((after[:, 0] - base[:, 0]).abs().max()) > 1e-4


@pytest.mark.parametrize("remat", ["none", "block"])
def test_forward_loss_equals_reference(model, remat):
    jp, jcfg, tp, cfg = model
    batch = _frames_batch(cfg, seed=1)
    jce, _ = jtf.forward_loss(jp, jcfg, jax.tree.map(jnp.asarray, batch),
                              remat=remat, ce_chunk=16)
    ce, _ = ttf.forward_loss(tp, cfg, _t(batch), remat=remat, ce_chunk=16)
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-5)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def test_train_steps_equal_reference():
    """Two steps from the reference's state on its stub frames: the same
    batches reach both steps (the port's ``batches_for`` given the
    reference's table), metrics within 1e-5, state within 1e-5 after one
    step and 1e-4 after two."""
    jcfg, cfg = _pair()
    kw = dict(steps=10, batch_size=4, seq_len=32, lr=1e-3, warmup_steps=1)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = jtrainer.init_state(KEY, jcfg, jtcfg, jnp.float32)
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                     device="cpu")
    table = _ref_table(cfg)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    batches = train_cli.batches_for(cfg, corpus, tcfg, 0,
                                    table=torch.tensor(table))
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jtcfg))
    step = trainer.make_train_step(cfg, tcfg)
    for i in range(2):
        batch = next(batches)
        raw = corpus.batch(i, tcfg.batch_size, tcfg.seq_len)
        # the reference's to_frames on the same step's corpus batch
        jbatch = {"frames": jnp.asarray(table[raw["tokens"]]),
                  "labels": jnp.asarray(raw["labels"] % cfg.vocab_size)}
        np.testing.assert_array_equal(batch["frames"].numpy(),
                                      np.asarray(jbatch["frames"]))
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, trainer.batch_to(batch, "cpu"))
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        mine = _flat(convert.state_to_numpy(state))
        ref = _flat(jax.tree.map(np.asarray, jstate))
        assert sorted(mine) == sorted(ref)
        _assert_state_close(mine, ref, 1e-5 if i == 0 else 1e-4,
                            f"step {i}")


def test_convert_carries_the_encoder_across():
    """The structure is the decoder's — embed (the unused token table and
    an untied unembed of the real vocab, 504), blocks, final_norm — and
    params and train state go across and back exactly."""
    jcfg, cfg = _pair(vocab_size=504)
    jstate = jtrainer.init_state(KEY, jcfg, JTrainConfig(), jnp.float32)
    np_state = jax.tree.map(np.asarray, jstate)
    tp = convert.params_from_numpy(np_state["params"], cfg, device="cpu")
    assert tp.embed.lm_head.shape == (cfg.d_model, 504)
    assert sorted(_flat(convert.params_to_numpy(tp))) == \
        sorted(_flat(np_state["params"]))
    state = convert.state_from_numpy(np_state, cfg, device="cpu")
    back = _flat(convert.state_to_numpy(state))
    ref = _flat(np_state)
    assert sorted(back) == sorted(ref)
    for key, r in ref.items():
        np.testing.assert_array_equal(back[key], r, err_msg=key)


def test_frontend_stub_frames_and_labels():
    """``frame_table`` is (vocab, d) N(0, 0.02) from a seeded CPU
    generator; an encoder batch is {"frames": its rows at the tokens,
    "labels": labels mod vocab}, and carries no tokens."""
    cfg = get_config(ARCH).reduced()
    table = train_cli.frame_table(cfg)
    assert table.shape == (cfg.vocab_size, cfg.d_model)
    assert table.dtype == torch.float32
    assert abs(float(table.std()) - 0.02) < 1e-3
    assert torch.equal(table, train_cli.frame_table(cfg))
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    tcfg = TrainConfig(batch_size=2, seq_len=16)
    b = next(train_cli.batches_for(cfg, corpus, tcfg, 3))
    raw = corpus.batch(3, 2, 16)
    assert sorted(b) == ["frames", "labels"]
    assert torch.equal(b["frames"], table[torch.as_tensor(raw["tokens"])
                                          .long()])
    np.testing.assert_array_equal(b["labels"], raw["labels"] % cfg.vocab_size)


def test_train_cli_runs_the_encoder(capsys):
    train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "step 0:" in out and "step 1:" in out
