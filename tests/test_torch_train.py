"""Training parity: the port's optimizer, train step and training forward
against the JAX reference (``repro.train``, ``repro.models.transformer``)
on the same seeded weights and batches, f32 at reduced widths.

* the reference's ``tests/test_train_substrate.py`` cases run against the
  port: the lr schedule's shape, AdamW on a quadratic, bf16 moments close
  to f32, the clip (raw norm reported), microbatches 1 == 4, remat
  ``none == block == save_dots``, chunked CE == the full one; plus
  ``lr_schedule`` equal to the reference's at every step (1e-7 absolute,
  1e-6 relative: the two packages' f32 ``cos`` differ by an ulp), and
  ``adamw_update`` with a bf16 leaf (its f32 master) equal to the
  reference's;
* ``make_train_step`` one step, then three, against the reference's jitted
  step from the same state (``convert.state_from_numpy``): loss, ce, aux,
  grad_norm and lr within 1e-5 relative; every updated weight, mu and nu
  (read back with ``convert.state_to_numpy``) within 1e-5 after one step
  and 1e-4 after three (a weight whose gradient is at f32 noise level in
  both packages, which Adam's normalisation turns into a step of noise,
  is left out: ``_assert_state_close`` says how); for the dense
  (qwen2-1.5b: QKV bias, tied embeddings), vlm (paligemma-3b: patches,
  prefix-LM, the loss over the text suffix), moe (llama4-scout: the aux
  loss), hybrid (hymba-1.5b) and ssm (rwkv6-7b) families (the encoder's are in
  ``tests/test_torch_encoder.py``); ``--grad-compression`` trains and
  checkpoints its residual ``ef`` (``tests/test_torch_compression.py``
  holds the compressed step to the reference's);
* the reference's system check (``tests/test_system.py::trained``): a
  small qwen2 trained by the port learns (loss falls by more than 0.5),
  and the port's calibrated projector reconstructs its keys better than a
  random orthonormal basis."""
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
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.config import SALSConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus, make_batches
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import calibrate, collect_pre_rope_keys
from repro_torch.models import transformer as ttf
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)


def _pair(arch, **over):
    """(reference cfg, port cfg) at reduced f32."""
    return (jax_get_config(arch).reduced(dtype="float32", **over),
            get_config(arch).reduced(dtype="float32", **over))


def _t(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The reference's substrate cases, against the port
# ---------------------------------------------------------------------------

def test_lr_schedule_shape():
    tcfg = TrainConfig(steps=100, warmup_steps=10, lr=1e-3)
    lrs = [float(opt.lr_schedule(torch.tensor(s, dtype=torch.int32), tcfg))
           for s in range(100)]
    assert lrs[0] < lrs[9] <= lrs[10] * 1.01
    assert abs(max(lrs) - 1e-3) < 1e-9
    assert lrs[-1] < 0.2 * 1e-3 + 1e-9 or lrs[-1] >= 0.1 * 1e-3


@pytest.mark.parametrize("steps,warmup", [(100, 10), (300, 20), (5, 0),
                                          (1, 1)])
def test_lr_schedule_equals_reference(steps, warmup):
    kw = dict(steps=steps, warmup_steps=warmup, lr=3e-4)
    tcfg, jtcfg = TrainConfig(**kw), JTrainConfig(**kw)
    for s in range(steps + 5):
        mine = float(opt.lr_schedule(torch.tensor(s, dtype=torch.int32),
                                     tcfg))
        ref = float(jopt.lr_schedule(jnp.int32(s), jtcfg))
        # 1e-7 absolute; relative, a few f32 ulps (the two cos differ)
        assert abs(mine - ref) <= 1e-7, s
        assert abs(mine - ref) <= 1e-6 * abs(ref), s


def test_adamw_converges_quadratic():
    tcfg = TrainConfig(steps=200, lr=0.1, warmup_steps=0, weight_decay=0.0,
                       grad_clip=0)
    params = {"w": torch.ones(4) * 5}
    state = opt.adamw_init(params)
    target = torch.tensor([1.0, -2.0, 0.5, 3.0])
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = opt.adamw_update(g, state, params, tcfg)
    torch.testing.assert_close(params["w"], target, atol=0.05, rtol=0)


def test_adamw_bf16_moments_close_to_f32():
    tcfg = TrainConfig(lr=1e-2, warmup_steps=0, weight_decay=0.0)
    p32, p16 = {"w": torch.ones(64)}, {"w": torch.ones(64)}
    s32 = opt.adamw_init(p32, torch.float32)
    s16 = opt.adamw_init(p16, torch.bfloat16)
    assert s16["mu"]["w"].dtype == torch.bfloat16
    for i in range(10):
        g = {"w": torch.sin(torch.arange(64.0) + i)}
        opt.adamw_update(g, s32, p32, tcfg)
        opt.adamw_update(g, s16, p16, tcfg)
    torch.testing.assert_close(p16["w"], p32["w"], atol=5e-3, rtol=0)


def test_grad_clip_bounds_update():
    tcfg = TrainConfig(lr=1.0, warmup_steps=0, grad_clip=1.0,
                       weight_decay=0.0)
    params = {"w": torch.zeros(8)}
    state = opt.adamw_init(params)
    g = {"w": torch.full((8,), 1e6)}
    _, state, m = opt.adamw_update(g, state, params, tcfg)
    assert float(m["grad_norm"]) > 1e6          # raw norm reported
    # clipped: mu after one step = (1 - b1) * clipped grad, of norm 1
    assert abs(float(torch.linalg.norm(state["mu"]["w"])) - 0.1) < 1e-6


def test_adamw_update_equals_reference_bf16_master():
    """bf16 leaves keep an f32 master; the update of every leaf is the
    reference's (master, moments and the bf16 cast)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    tcfg = TrainConfig(lr=1e-2, warmup_steps=2, steps=10)
    jt = JTrainConfig(lr=1e-2, warmup_steps=2, steps=10)
    jp = {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b)}
    tp = {"w": torch.from_numpy(w).bfloat16(), "b": torch.from_numpy(b)}
    js, ts = jopt.adamw_init(jp), opt.adamw_init(tp)
    assert "master" in js and "master" in ts
    for i in range(3):
        g = rng.standard_normal((3, 5)).astype(np.float32)
        gb = rng.standard_normal((5,)).astype(np.float32)
        jp, js, jm = jopt.adamw_update(
            {"w": jnp.asarray(g, jnp.bfloat16), "b": jnp.asarray(gb)}, js,
            jp, jt)
        _, _, tm = opt.adamw_update(
            {"w": torch.from_numpy(g).bfloat16(), "b": torch.from_numpy(gb)},
            ts, tp, tcfg)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(
            np.asarray(js["master"][k]), ts["master"][k].numpy(),
            rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(
            np.asarray(jnp.asarray(jp[k], jnp.float32)), tp[k].float().numpy())
    assert int(ts["count"]) == int(js["count"]) == 3


def _small(arch="qwen2-1.5b"):
    return get_config(arch).reduced(n_layers=2, vocab_size=256,
                                    dtype="float32")


def test_microbatch_grad_accum_equals_full_batch():
    cfg = _small()
    batch = _t(SyntheticCorpus(cfg.vocab_size, seed=0).batch(0, 8, 32))
    outs = {}
    for mb in (1, 4):
        tcfg = TrainConfig(steps=1, batch_size=8, seq_len=32, lr=1e-3,
                           microbatches=mb)
        state = trainer.init_state(cfg, tcfg, device="cpu", seed=0)
        s, m = trainer.make_train_step(cfg, tcfg)(state, batch)
        outs[mb] = (s, float(m["loss"]))
    assert abs(outs[1][1] - outs[4][1]) < 1e-4
    d = max(float((a - b).abs().max()) for a, b in zip(
        outs[1][0]["params"].parameters(), outs[4][0]["params"].parameters()))
    assert d < 1e-4, d


def test_remat_matches_no_remat():
    cfg = _small()
    batch = _t(SyntheticCorpus(cfg.vocab_size, seed=0).batch(0, 4, 32))
    tcfg = TrainConfig(steps=1, batch_size=4, seq_len=32)
    params = trainer.init_state(cfg, tcfg, device="cpu", seed=0)["params"]
    grads = {}
    for remat in ("none", "block", "save_dots"):
        loss, _ = trainer.loss_fn(params, cfg, batch, remat)
        g = torch.autograd.grad(loss, list(params.parameters()))
        grads[remat] = (float(loss), g)
    for r in ("block", "save_dots"):
        assert abs(grads["none"][0] - grads[r][0]) < 1e-5
        d = max(float((a - b).abs().max())
                for a, b in zip(grads["none"][1], grads[r][1]))
        assert d < 1e-4, (r, d)


def test_chunked_ce_matches_full():
    cfg = _small()
    batch = _t(SyntheticCorpus(cfg.vocab_size, seed=0).batch(0, 4, 64))
    params = ttf.init_params(cfg, device="cpu", seed=0)
    with torch.no_grad():
        logits, _ = ttf.forward(params, cfg, batch)
        full = ttf.cross_entropy(logits, batch["labels"])
        for chunk in (16, 32, 64, 48):      # 48: not a divisor, one chunk
            ce, _ = ttf.forward_loss(params, cfg, batch, ce_chunk=chunk)
            np.testing.assert_allclose(float(ce), float(full), rtol=1e-5)


def test_forward_and_cross_entropy_equal_reference():
    jcfg, cfg = _pair("qwen2-1.5b", n_layers=2, vocab_size=256)
    jp = jtf.init_params(KEY, jcfg, jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu")
    batch = SyntheticCorpus(cfg.vocab_size, seed=0).batch(0, 2, 32)
    mask = (np.arange(32)[None, :] < np.array([[20], [32]])).astype(
        np.float32)
    j_logits, _ = jtf.forward(jp, jcfg, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        logits, _ = ttf.forward(tp, cfg, _t(batch))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=1e-4, atol=1e-4)
    for m in (None, mask):
        ref = jtf.cross_entropy(j_logits, jnp.asarray(batch["labels"]),
                                None if m is None else jnp.asarray(m))
        mine = ttf.cross_entropy(torch.from_numpy(np.asarray(j_logits)),
                                 torch.as_tensor(batch["labels"]),
                                 None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(mine), float(ref), rtol=1e-6)


# ---------------------------------------------------------------------------
# make_train_step against the reference's jitted step, by family
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["qwen2-1.5b", "paligemma-3b", "llama4-scout-17b-a16e",
                "hymba-1.5b", "rwkv6-7b"]
METRICS = ("loss", "ce", "aux", "grad_norm", "lr")


def _family_batches(cfg, n, b=4, s=32):
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    tcfg = TrainConfig(batch_size=b, seq_len=s)
    return [next(train_cli.batches_for(cfg, corpus, tcfg, i))
            for i in range(n)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def _assert_state_close(mine: dict, ref: dict, tol: float, what: str):
    """Every leaf within ``tol`` (rtol = atol), but for one case.  Adam
    normalises each gradient element by its own size, so an element whose
    gradient sits at f32 noise level takes a step of noise in either
    package (qwen2's key bias along RoPE's slowest dimensions: a
    gradient of 1e-9 against the leaf's 1e-3).  A weight (or master copy)
    may differ only where the two gradients, read through mu, disagree by
    more than 1e-3 and the gradient is below 1e-3 of its leaf's largest,
    and at under 5% of the leaf's elements; a real gradient fault breaks
    one of the three."""
    for key, r in ref.items():
        bad = ~np.isclose(mine[key], r, rtol=tol, atol=tol)
        if not bad.any():
            continue
        assert key.startswith(("params/", "opt/master/")), (what, key)
        leaf = key.split("/", 2 if key.startswith("opt/") else 1)[-1]
        gm, gr = mine["opt/mu/" + leaf], ref["opt/mu/" + leaf]
        noisy = (np.abs(gm - gr) > 1e-3 * np.abs(gr)) \
            & (np.abs(gr) <= 1e-3 * np.abs(gr).max())
        assert np.all(noisy[bad]), (what, key, r[bad & ~noisy][:4],
                                    mine[key][bad & ~noisy][:4])
        assert bad.mean() < 0.05, (what, key, bad.mean())


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_step_equals_reference(arch):
    jcfg, cfg = _pair(arch)
    kw = dict(steps=10, batch_size=4, seq_len=32, lr=1e-3, warmup_steps=1)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = jtrainer.init_state(KEY, jcfg, jtcfg, jnp.float32)
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                     device="cpu")
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jtcfg))
    step = trainer.make_train_step(cfg, tcfg)
    batches = _family_batches(cfg, 3)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, _t(batch))
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{arch} step {i} {k}")
        if i in (0, 2):
            mine = _flat(convert.state_to_numpy(state))
            ref = _flat(jax.tree.map(np.asarray, jstate))
            assert sorted(mine) == sorted(ref)
            _assert_state_close(mine, ref, 1e-5 if i == 0 else 1e-4,
                                f"{arch} step {i}")


def test_train_cli_grad_compression_trains_and_checkpoints_ef(tmp_path,
                                                              capsys):
    """``launch.train --grad-compression`` trains reduced qwen2-1.5b on
    one rank (the int8 error-feedback step) and checkpoints the residual
    ``ef`` beside the weights and moments, in the reference's layout."""
    d = str(tmp_path / "ck")
    train_cli.main(["--arch", "qwen2-1.5b", "--device", "cpu", "--steps",
                    "2", "--batch-size", "2", "--seq-len", "32",
                    "--grad-compression", "--ckpt-dir", d,
                    "--checkpoint-every", "2"])
    out = capsys.readouterr().out
    assert "int8 error-feedback gradients over 1 rank" in out
    assert "step 0: loss=" in out and "step 1: loss=" in out
    with np.load(os.path.join(d, "step_000000002", "arrays.npz")) as z:
        ef = sorted(k for k in z.files if k.startswith("ef/"))
        params = sorted(k for k in z.files if k.startswith("params/"))
        assert [k[3:] for k in ef] == [k[7:] for k in params]
        assert any(z[k].any() for k in ef)


# ---------------------------------------------------------------------------
# The reference's system check: training learns, calibration beats random
# ---------------------------------------------------------------------------

def test_training_learns_and_calibration_beats_random():
    cfg = get_config("qwen2-1.5b").reduced(n_layers=3, vocab_size=512,
                                           dtype="float32")
    tcfg = TrainConfig(steps=40, batch_size=8, seq_len=64, lr=5e-3,
                       warmup_steps=5, log_every=100)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    state = trainer.init_state(cfg, tcfg, device="cpu", seed=0)
    losses = []
    state = trainer.train_loop(
        cfg, tcfg, state=state, step_fn=trainer.make_train_step(cfg, tcfg),
        batches=make_batches(corpus, 8, 64), log=lambda *_: None,
        on_step=lambda i, m, dt: losses.append(float(m["loss"])))
    assert len(losses) == 40
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])

    params = state["params"]
    sals = SALSConfig(rank_ratio=0.25, v_group=32)
    proj = calibrate(params, cfg, sals, corpus, n_sequences=8, seq_len=64)
    r = sals.rank(cfg.kv_dim)
    keys = collect_pre_rope_keys(
        params, cfg, {"tokens": torch.as_tensor(
            corpus.batch(99, 4, 64)["tokens"])}).numpy()
    rng = np.random.default_rng(0)
    rnd = np.stack([np.linalg.qr(rng.standard_normal((cfg.kv_dim, r)))[0]
                    for _ in range(cfg.n_layers)])

    def recon_err(u_all):
        err = 0.0
        for layer in range(cfg.n_layers):
            k = keys[layer].reshape(-1, cfg.kv_dim).astype(np.float64)
            u = np.asarray(u_all[layer], np.float64)
            err += np.linalg.norm((k @ u) @ u.T - k) / np.linalg.norm(k)
        return err / cfg.n_layers

    assert recon_err(proj["u"].float().numpy()) < recon_err(rnd) * 0.9
