"""The port's GPipe (``repro_torch.distributed.pipeline``) held to the JAX
reference.

* the reference's ``test_core.py::test_pipeline_bubble_fraction`` cases
  and ``stage_slice`` on a ``ModuleList`` and on a list of layer trees;
* the reference's ``test_gpipe_matches_reference_loss_and_grads`` setup —
  reduced qwen2-1.5b (4 layers, vocab 256, f32), M 4 microbatches of B 2 x
  S 32 — on 2 and 4 gloo ranks (each its contiguous layers) and at P = 1
  in this process: the loss, every block gradient and the embedding
  gradient within 1e-4 (the reference test's tolerance) of the reference's
  single-device ``ref_loss`` and ``jax.value_and_grad`` (the reference's
  own pipelined run fails on jax 0.9.0).

The ranks run in a subprocess (``python worker.py``, written into
``tmp_path``; it imports ``repro_torch`` and never JAX) under its own
timeout, forked by ``torch.multiprocessing`` over an ``init_method=file://``
store in ``tmp_path``; the parent hands the reference's weights and batch
over in an ``.npz`` and each rank writes its gradients back to one.
"""
import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import SyntheticCorpus
from repro.distributed.pipeline import bubble_fraction as jax_bubble
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.distributed.pipeline import (bubble_fraction, gpipe_loss,
                                              stage_slice)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
M, B, S = 4, 2, 32
TOL = 1e-4

# the model, the pipelined loss and its gradients, as a rank builds them
PIPE = r'''
import numpy as np
import torch


def unflat(npz, prefix):
    tree = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *head, last = key[len(prefix) + 1:].split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = npz[key]
    return tree


def pipelined(ref, stage, n_stages, group=None):
    """(loss, {parameter name: gradient}) of this stage's blocks and the
    io parameters through gpipe_loss."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import gpipe_loss, stage_slice
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import embed_apply, rmsnorm_apply
    cfg = get_config("qwen2-1.5b").reduced(n_layers=4, vocab_size=256,
                                           dtype="float32")
    params = convert.params_from_numpy(unflat(ref, "params"), cfg, "cpu")
    batch = {k: torch.as_tensor(ref["batch/" + k]) for k in
             ("tokens", "labels")}
    s = batch["tokens"].shape[-1]
    positions = torch.arange(s)[None, :]
    per = cfg.n_layers // n_stages
    blocks = stage_slice(params.blocks, stage, n_stages, cfg.n_layers)
    io = {"embed": params.embed, "final_norm": params.final_norm}

    def block_fn(stage_blocks, x):
        for bp in stage_blocks:
            x = tf._block_fwd(bp, x, cfg, positions, 0, False)[0]
        return x

    def embed_fn(io_params, mb):
        return embed_apply(io_params["embed"], mb["tokens"], cfg)

    def head_loss_fn(io_params, x, mb):
        x = rmsnorm_apply(io_params["final_norm"], x, cfg.norm_eps)
        return tf.head_loss(io_params["embed"], cfg, x, mb["labels"],
                            ce_chunk=s)

    names = {f"blocks.{stage * per + i}.{k}": p
             for i, bp in enumerate(blocks) for k, p in bp.named_parameters()}
    names.update({f"{m}.{k}": p for m, mod in io.items()
                  for k, p in mod.named_parameters()})
    for p in names.values():
        p.requires_grad_(True)
    loss = gpipe_loss(block_fn, embed_fn, head_loss_fn, group)(
        blocks, io, batch)
    grads = torch.autograd.grad(loss, list(names.values()))
    return float(loss.detach()), {k: g.numpy() for k, g in zip(names, grads)}
'''

WORKER = PIPE + r'''
import os, sys
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, world, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        d, "store"), rank=rank, world_size=world)
    try:
        loss, grads = pipelined(np.load(os.path.join(d, "ref.npz")), rank,
                                world)
        np.savez(os.path.join(d, f"out_{rank}.npz"), loss=loss, **grads)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, d = int(sys.argv[1]), sys.argv[2]
    import repro_torch.distributed.pipeline, repro_torch.convert
    mp.start_processes(run, args=(world, d), nprocs=world,
                       start_method="fork")
'''


def test_bubble_fraction_matches_reference():
    for m, p in ((8, 2), (1, 4), (100, 2), (4, 1), (4, 4)):
        assert bubble_fraction(m, p) == jax_bubble(m, p)
    assert bubble_fraction(8, 2) == 1 / 9
    assert bubble_fraction(1, 4) == 3 / 4
    assert bubble_fraction(100, 2) < 0.01


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_stage_slice_contiguous_layers(n_stages):
    cfg = get_config("qwen2-1.5b").reduced(n_layers=4, vocab_size=256,
                                           dtype="float32")
    params = convert.init_params(cfg, device="cpu")
    per = 4 // n_stages
    for st in range(n_stages):
        got = stage_slice(params.blocks, st, n_stages, 4)
        assert isinstance(got, torch.nn.ModuleList)
        assert [id(b) for b in got] == \
            [id(b) for b in params.blocks[st * per:(st + 1) * per]]
        trees = [{"w": i} for i in range(4)]
        assert stage_slice(trees, st, n_stages, 4) == \
            trees[st * per:(st + 1) * per]


@pytest.fixture(scope="module")
def reference():
    """The reference test's model and batch, and its single-device loss
    and gradients (port parameter names -> arrays)."""
    cfg = jax_get_config("qwen2-1.5b").reduced(n_layers=4, vocab_size=256)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jax.tree.map(jnp.asarray, corpus.batch(i, B, S)) for i in range(M)])

    def ref_loss(params):
        losses = []
        for i in range(M):
            mb = jax.tree.map(lambda a: a[i], batch)
            ce, _ = jtf.forward_loss(params, cfg, mb, ce_chunk=S)
            losses.append(ce)
        return jnp.mean(jnp.stack(losses))

    loss, grads = jax.value_and_grad(ref_loss)(params)
    pcfg = get_config("qwen2-1.5b").reduced(n_layers=4, vocab_size=256,
                                            dtype="float32")
    g = convert.params_from_numpy(jax.tree.map(np.asarray, grads), pcfg,
                                  "cpu")
    npz = {"batch/" + k: np.asarray(v) for k, v in batch.items()}
    npz.update(_flat(jax.tree.map(np.asarray, params), "params"))
    return {"loss": float(loss), "npz": npz,
            "grads": {k: p.detach().numpy()
                      for k, p in g.named_parameters()}}


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def _check(loss, grads, ref, n_layers_seen):
    assert abs(loss - ref["loss"]) < TOL, (loss, ref["loss"])
    blocks = [k for k in grads if k.startswith("blocks.")]
    assert len({k.split(".")[1] for k in blocks}) == n_layers_seen
    d_blocks = max(float(np.abs(grads[k] - ref["grads"][k]).max())
                   for k in blocks)
    d_emb = float(np.abs(grads["embed.embedding"]
                         - ref["grads"]["embed.embedding"]).max())
    d_norm = float(np.abs(grads["final_norm.scale"]
                          - ref["grads"]["final_norm.scale"]).max())
    assert d_blocks < TOL and d_emb < TOL and d_norm < TOL, \
        (d_blocks, d_emb, d_norm)


def test_gpipe_one_stage_matches_reference(reference, tmp_path):
    """P = 1 (no process group): the identity push, no collective."""
    ns = {}
    exec(compile(PIPE, "pipe", "exec"), ns)
    np.savez(tmp_path / "ref.npz", **reference["npz"])
    loss, grads = ns["pipelined"](np.load(tmp_path / "ref.npz"), 0, 1)
    _check(loss, grads, reference, 4)


@pytest.mark.parametrize("world", [2, 4])
def test_gpipe_matches_reference_loss_and_grads(reference, tmp_path, world):
    np.savez(tmp_path / "ref.npz", **reference["npz"])
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(script), str(world),
                           str(tmp_path)], capture_output=True, text=True,
                          timeout=TIMEOUT, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    outs = [np.load(tmp_path / f"out_{r}.npz") for r in range(world)]
    # every rank returns the same loss and the same summed io gradients
    for o in outs:
        assert float(o["loss"]) == float(outs[0]["loss"])
        for k in ("embed.embedding", "final_norm.scale"):
            np.testing.assert_array_equal(o[k], outs[0][k])
    grads = {k: o[k] for o in outs for k in o.files if k != "loss"}
    _check(float(outs[0]["loss"]), grads, reference, 4)
