"""The port's sharding layer on 2 and 4 gloo ranks on the CPU, held to the
JAX reference's single-device results.

The ranks run in a subprocess (``python worker.py``, written into
``tmp_path``; it imports ``repro_torch`` and never JAX) under its own
timeout, started with ``torch.multiprocessing`` over an
``init_method=file://`` store in ``tmp_path``.  The parent computes the
reference's numbers with JAX and hands them over in an ``.npz``; the ranks
write theirs back to one.

* (i) the reference's ``test_sharded_train_step_matches_single_device``:
  ``build_train`` on a (2, 2) ("data", "model") mesh, reduced qwen2-1.5b
  (2 layers, vocab 512), B 8 S 64, lr 1e-3 — loss and every parameter
  within 1e-4 of the reference's single-device jitted step and of the
  port's unsharded step; the parameters at rest carry
  the placements of the reference's ``train_state_pspecs`` on the same
  mesh, the stacked layer entry dropped;
* (ii) ``build_prefill`` + ``build_decode`` on (2, 2), reduced yi-9b
  (vocab 512, f32), B 8, S 512, a 496-token prompt, 8 greedy steps:
  "local" (n_groups 2, shard-local slabs) — tokens exact and logits
  within 1e-4 of the reference's single-device decode at n_groups 2;
  "global" — within 1e-4 of n_groups 1; the prefilled cache's codes
  within one step of the reference's on at most 0.1% of entries; the
  tokens written at positions 496.. (in the second kv_seq shard) read
  back from the sharded caches.  4 layers and S 512, not the reference
  test's 3 and 256: with ``sals_for_shape``'s skip 2 + 1 layers, 3 leave
  no SALS layer, and its N_c 432 needs S >= 432 (the reference's own
  top-k raises below);
* (iii) the reference's ``test_elastic_restore_across_device_counts``,
  2 -> 4 ranks: delta 0, each leaf split into the right number of
  shards;
* (iv) ``python -m torch.distributed.run --standalone --nproc-per-node 2
  -m repro_torch.launch.train --device cpu --steps 2``: the logged losses
  within 1e-4 of the one-process run's;
* (v) each ``ops`` wrapper raises on a DTensor.
"""
import json
import os
import re
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec

from repro.config import ShapeConfig as JShapeConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core import calibration as jcal
from repro.data import SyntheticCorpus
from repro.launch import specs as jsp
from repro.models import transformer as jtf
from repro.train import trainer as jtrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300

WORKER = r'''
import os, sys, json
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


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


def flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def mesh22():
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def case_train(rank, d):
    from repro_torch import convert
    from repro_torch.config import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as sp
    from repro_torch.train import trainer
    ref = np.load(os.path.join(d, "ref.npz"))
    cfg = get_config("qwen2-1.5b").reduced(n_layers=2, vocab_size=512)
    tcfg = TrainConfig(steps=2, batch_size=8, seq_len=64, lr=1e-3)
    mesh = mesh22()
    mc = MeshConfig(shape=(2, 2), axis_names=("data", "model"),
                    seq_parallel=False)
    fn, like, in_pl, out_pl = sp.build_train(
        cfg, ShapeConfig("t", "train", 64, 8), mesh, mc, remat="block",
        tcfg=tcfg)
    batch = {k: torch.as_tensor(ref["batch/" + k]) for k in ("tokens", "labels")}
    state_np = unflat(ref, "state")
    plain = convert.state_from_numpy(state_np, cfg, device="cpu")
    plain, m0 = trainer.make_train_step(cfg, tcfg, remat="block")(plain, batch)
    st = convert.state_from_numpy(state_np, cfg, device="cpu")
    st = {k: sh.place(v, mesh, in_pl[0][k]) for k, v in st.items()}
    # the reference's train-state specs on this mesh, its layer entry
    # dropped from each block leaf
    with open(os.path.join(d, "ref_specs.json")) as f:
        ref_specs = json.load(f)

    def ref_spec(name):
        parts = name.split(".")
        if parts[0] != "blocks":
            return ref_specs["/".join(parts)]
        return ref_specs["/".join(["blocks"] + parts[2:])][1:]

    want = {k: sh.placements(sh.P(*(tuple(e) if isinstance(e, list) else e
                                    for e in ref_spec(k))), mesh)
            for k, _ in like[0]["params"].named_parameters()}
    at_rest = all(tuple(p.placements) == want[k]
                  for k, p in st["params"].named_parameters())
    st, m1 = fn(st, sh.place(batch, mesh, in_pl[1]))
    placed_after = all(tuple(p.placements) == want[k]
                       for k, p in st["params"].named_parameters())
    out = flat(convert.state_to_numpy(sh.gather(st["params"])), "sharded")
    out.update(flat(convert.params_to_numpy(plain["params"]), "plain"))
    if rank == 0:
        np.savez(os.path.join(d, "out.npz"), **out,
                 loss_sharded=float(m1["loss"].to_local()),
                 loss_plain=float(m0["loss"]),
                 at_rest=at_rest and placed_after,
                 n_sharded=sum(any(not p.is_replicate() for p in v)
                               for v in want.values()))


def case_serve(rank, d):
    from repro_torch import convert
    from repro_torch.config import MeshConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as sp
    ref = np.load(os.path.join(d, "ref.npz"))
    cfg = get_config("yi-9b").reduced(n_layers=4, vocab_size=512,
                                      dtype="float32")
    shape = ShapeConfig("d", "decode", 512, 8)
    mesh = mesh22()
    mc = MeshConfig(shape=(2, 2), axis_names=("data", "model"))
    params = convert.params_from_numpy(unflat(ref, "params"), cfg, "cpu")
    proj = convert.projectors_from_numpy(unflat(ref, "proj"), "cpu")
    prompt = torch.as_tensor(ref["prompt"])
    p0 = prompt.shape[1]
    out = {}
    for mode in ("local", "global"):
        pf = sp.build_prefill(cfg, shape, mesh, mc, dist_mode=mode)
        dc = sp.build_decode(cfg, shape, mesh, mc, dist_mode=mode)
        pp = sh.place(params, mesh, pf[2][0])
        pj = sh.place(dict(proj), mesh, pf[2][1])
        with torch.no_grad():
            lg, cache = pf[0](pp, pj, sh.place({"tokens": prompt}, mesh,
                                               pf[2][2]))
            seg = cache["seg1"]
            out[f"{mode}/n_groups"] = seg.n_groups
            out[f"{mode}/plan_axes"] = len(
                sh.dim_axes(seg.k_lat, 2)) if mode == "local" else 0
            out[f"{mode}/prefill_vq"] = seg.v_q.full_tensor().numpy()
            logits = [lg.full_tensor().numpy()]
            tok = lg.full_tensor().argmax(-1)
            for t in range(8):
                lg, cache = dc[0](pp, pj, cache,
                                  sh.place(tok, mesh, dc[2][3]),
                                  torch.tensor(p0 + t, dtype=torch.int32))
                logits.append(lg.full_tensor().numpy())
                tok = lg.full_tensor().argmax(-1)
            out[f"{mode}/logits"] = np.stack(logits)
            seg = cache["seg1"]
            out[f"{mode}/k_lat"] = seg.k_lat.full_tensor()[0].numpy()
            out[f"{mode}/full_k"] = cache["seg0"]["k"].full_tensor()[0].numpy()
            out[f"{mode}/lengths"] = seg.lengths.full_tensor().numpy()
            s0, ns = sh.shard_range(seg.k_lat[0], 1)
            out[f"{mode}/slab"] = np.array([s0, ns])
    out.update(bf16_pair(unflat(ref, "params"), proj, prompt, shape, mesh))
    out.update(append_chunk_pair(cfg, shape, mesh, mc, proj))
    if rank == 0:
        np.savez(os.path.join(d, "out.npz"), **out)


def bf16_pair(params_np, proj, prompt, shape, mesh, steps=8):
    """bf16 prefill + greedy decode with the caches split along S over
    'model' (n_groups 2, shard-local slabs; the skip layers' full caches
    split too) and every weight and batch row replicated, so that the
    split of the caches is the only difference from the port's
    unsharded run at the same n_groups, which runs beside it: both runs'
    logits, and the full caches' slab length."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch import convert
    from repro_torch.config import MeshConfig
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as sp
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    cfg = get_config("yi-9b").reduced(n_layers=4, vocab_size=512,
                                      dtype="bfloat16")
    sals = sp.sals_for_shape(cfg, shape)
    rules = {k: None for k in sh.default_rules(MeshConfig())}
    rules.update(kv_seq="model", kv_seq_full="model")
    rep = (Replicate(),) * mesh.ndim
    # place() turns a module's own parameters into DTensors: the plain run
    # takes a second copy
    pp = convert.params_from_numpy(params_np, cfg, "cpu", "bfloat16")
    pp = sh.place(pp, mesh, {k: rep for k, _ in pp.named_parameters()})
    pj = {k: sh.place(v, mesh, rep) for k, v in proj.items()}
    params = convert.params_from_numpy(params_np, cfg, "cpu", "bfloat16")
    p0, out = prompt.shape[1], {}
    with torch.no_grad():
        lg, cache = tf.prefill(params, proj, cfg, sals, {"tokens": prompt},
                               shape.seq_len, n_groups=2)
        logits = [lg]
        for t in range(steps):
            lg, cache = tf.decode_step(params, proj, cache,
                                       logits[-1].argmax(-1), p0 + t, cfg,
                                       sals)
            logits.append(lg)
        out["bf16/plain"] = torch.stack(logits).float().numpy()
        toks = out["bf16/plain"].argmax(-1)
        with sh.use_sharding(mesh, rules):
            lg, cache = tf.prefill(pp, pj, cfg, sals, {
                "tokens": sh.place(prompt, mesh, rep)}, shape.seq_len,
                n_groups=2)
            out["bf16/full_slab"] = sh.shard_range(
                cache["seg0"]["k"][0], 1)[1]
            logits = [lg.full_tensor()]
            for t in range(steps):
                # fed the plain run's tokens: a near-tie flip does not
                # carry into the later steps
                tok = sh.place(torch.as_tensor(toks[t]), mesh, rep)
                lg, cache = tf.decode_step(pp, pj, cache, tok, p0 + t, cfg,
                                           sals)
                logits.append(lg.full_tensor())
        out["bf16/sharded"] = torch.stack(logits).float().numpy()
        # one full-cache decode attention on its own, rows at positions
        # on both sides of the slab boundary (256)
        gen = torch.Generator().manual_seed(3)
        x = torch.randn(8, 1, cfg.d_model, generator=gen).bfloat16()
        kv = [torch.randn(8, shape.seq_len, cfg.n_kv_heads, cfg.head_dim,
                          generator=gen).bfloat16() for _ in range(2)]
        pos = torch.arange(8) * 30 + 250
        y = attn.attend_decode_full(params.blocks[0].attn, x, cfg,
                                    *[t.clone() for t in kv], pos)[0]
        out["bf16/attn_plain"] = y.float().numpy()
        seq = (Replicate(), Shard(1))
        with sh.use_sharding(mesh, rules):
            y = attn.attend_decode_full(
                pp.blocks[0].attn, sh.place(x, mesh, rep), cfg,
                *[sh.place(t.clone(), mesh, seq) for t in kv], pos)[0]
        out["bf16/attn_sharded"] = y.full_tensor().float().numpy()
    return out


def append_chunk_pair(cfg, shape, mesh, mc, proj):
    """One 16-token chunk at 248 (across the kv_seq shards' boundary at
    256) appended into a plain single-layer cache and into a
    sequence-sharded one: every field, gathered."""
    from repro_torch.core.latent_cache import LatentKVCache
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as sp
    from repro_torch.models import transformer as tf
    sals = sp.sals_for_shape(cfg, shape)
    gen = torch.Generator().manual_seed(5)
    kv = [torch.randn(8, 16, cfg.n_kv_heads, cfg.head_dim, generator=gen)
          for _ in range(2)]
    lengths = torch.full((8,), 260)
    caches = [LatentKVCache.init(cfg, sals, 1, 8, 512, torch.float32,
                                 device="cpu") for _ in range(2)]
    rules = sh.default_rules(mc, shape)
    spec = sh.sanitize_pspecs(tf.cache_pspecs({"s": caches[1]}, rules)["s"],
                              tf.cache_shapes({"s": caches[1]})["s"], mesh)
    sh.place(caches[1], mesh, sh.tree_shardings(mesh, spec))
    for c in caches:
        c.layer_view(0).append_chunk(cfg, sals, proj["u"][2], 248, *kv,
                                     lengths)
    out = {}
    for f in ("k_lat", "v_q", "v_scale", "v_zero", "sink_k", "recent_k",
              "recent_v", "lengths"):
        out[f"append/{f}"] = getattr(caches[0], f).float().numpy()
        out[f"append_sharded/{f}"] = \
            getattr(caches[1], f).full_tensor().float().numpy()
    return out


def case_save(rank, d):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    cfg = get_config("qwen2-1.5b").reduced(n_layers=2, vocab_size=256)
    params = tf.init_params(cfg, device="cpu", dtype=torch.float32, seed=7)
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        pl = [Shard(0) if p.shape[0] % 2 == 0 else Replicate()]
        params.get_submodule(owner).register_parameter(leaf, torch.nn.Parameter(
            distribute_tensor(p.detach(), mesh, pl), requires_grad=False))
    ckpt.save(os.path.join(d, "ck"), 1, {"params": params})


def case_restore(rank, d):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    cfg = get_config("qwen2-1.5b").reduced(n_layers=2, vocab_size=256)
    like = {"params": tf.Transformer(cfg, torch.float32, "cpu")}
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    shard = {name: (mesh, [Shard(0) if p.shape[0] % 4 == 0 else Replicate()])
             for name, p in like["params"].named_parameters()}
    restored, step = ckpt.restore(os.path.join(d, "ck"), like,
                                  shardings={"params": shard})
    ref = tf.init_params(cfg, device="cpu", dtype=torch.float32, seed=7)
    refs = dict(ref.named_parameters())
    delta, shards_ok = 0.0, True
    for name, p in restored["params"].named_parameters():
        delta = max(delta, float((p.full_tensor() - refs[name]).abs().max()))
        n = 4 if p.shape[0] % 4 == 0 else 1
        shards_ok &= p.to_local().shape[0] * n == p.shape[0]
        shards_ok &= tuple(p.placements) == tuple(shard[name][1])
    if rank == 0:
        np.savez(os.path.join(d, "out.npz"), delta=delta, step=step,
                 shards_ok=shards_ok)
    check_ops(rank, d, mesh)


def check_ops(rank, d, mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import ops
    dt = lambda t: distribute_tensor(t, mesh, [Replicate()])
    q = torch.zeros(1, 4, 2, 64)
    ql, kl = torch.zeros(1, 8), torch.zeros(1, 16, 8)
    calls = {
        "flash_attention": lambda: ops.flash_attention(dt(q), q, q),
        "FlashAttentionFn": lambda: ops.FlashAttentionFn.apply(
            dt(q), dt(q), dt(q), True, 0.0, 0),
        "latent_score": lambda: ops.latent_score(ql, dt(kl)),
        "latent_topk": lambda: ops.latent_topk(
            ql, dt(kl), None, 15, n_critical=4, n_sink=1, n_recent=2),
        "sparse_recon_attention": lambda: ops.sparse_recon_attention(
            dt(torch.zeros(1, 2, 64)), kl, None, None, None, None, None,
            None, None, None, n_kv=1),
        "sparse_recon_attention_window": lambda:
            ops.sparse_recon_attention_window(
                dt(torch.zeros(1, 1, 2, 64)), kl, None, None, None, None,
                None, None, None, None, n_kv=1),
    }
    raised = {}
    for name, call in calls.items():
        try:
            call()
            raised[name] = False
        except TypeError as e:
            raised[name] = "DTensor" in str(e)
    if rank == 0:
        with open(os.path.join(d, "out.json"), "w") as f:
            json.dump(raised, f)


def run(rank, case, world, d):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        d, "store_" + case), rank=rank, world_size=world)
    try:
        globals()["case_" + case](rank, d)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    case, world, d = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    # the ranks fork from a parent that has imported the port once
    import repro_torch.launch.specs, repro_torch.checkpoint, repro_torch.convert
    mp.start_processes(run, args=(case, world, d), nprocs=world,
                       start_method="fork")
'''


def _ranks(tmp_path, case: str, world: int) -> None:
    """Run ``case`` on ``world`` gloo ranks in a subprocess."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, str(script), case, str(world),
                           str(tmp_path)], capture_output=True, text=True,
                          timeout=TIMEOUT, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def test_sharded_train_step_matches_single_device(tmp_path):
    jcfg = jax_get_config("qwen2-1.5b").reduced(n_layers=2, vocab_size=512)
    tcfg = JTrainConfig(steps=2, batch_size=8, seq_len=64, lr=1e-3)
    batch = SyntheticCorpus(jcfg.vocab_size, seed=0).batch(0, 8, 64)
    state = jtrainer.init_state(jax.random.PRNGKey(0), jcfg, tcfg,
                                jnp.float32)
    s1, m1 = jax.jit(jtrainer.make_train_step(jcfg, tcfg))(
        state, jax.tree.map(jnp.asarray, batch))
    np.savez(tmp_path / "ref.npz", **_flat(jax.tree.map(np.asarray, state),
                                           "state"),
             **{f"batch/{k}": np.asarray(v) for k, v in batch.items()})
    mesh = Mesh(np.array(jax.devices()[:1] * 4).reshape(2, 2),
                ("data", "model"))
    specs = jsp.train_state_pspecs(jcfg, tcfg, mesh, jax.eval_shape(
        lambda: state), strategy="tp_sp")["params"]
    (tmp_path / "ref_specs.json").write_text(json.dumps({
        "/".join(str(getattr(p, "key", p)) for p in path):
            [list(e) if isinstance(e, tuple) else e for e in spec]
        for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}))
    _ranks(tmp_path, "train", 4)
    out = np.load(tmp_path / "out.npz")
    assert bool(out["at_rest"])
    assert int(out["n_sharded"]) > 0
    loss_ref = float(m1["loss"])
    assert abs(float(out["loss_sharded"]) - loss_ref) < 1e-4
    assert abs(float(out["loss_sharded"]) - float(out["loss_plain"])) < 1e-4
    ref = _flat(jax.tree.map(np.asarray, s1["params"]), "")
    n = 0
    for key, want in ref.items():
        got = out["sharded" + key]
        assert np.abs(got - want).max() < 1e-4, key
        assert np.abs(got - out["plain" + key]).max() < 1e-4, key
        n += 1
    assert n == len(ref) > 0


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    """The reference's single-device prefill + 8 greedy decode steps at
    n_groups 1 and 2, and the ranks' sharded runs of the same: (ranks'
    out.npz, reference numbers)."""
    tmp_path = tmp_path_factory.mktemp("serve")
    jcfg = jax_get_config("yi-9b").reduced(n_layers=4, vocab_size=512,
                                           dtype="float32")
    shape = JShapeConfig("d", "decode", 512, 8)
    sals = jsp.sals_for_shape(jcfg, shape)
    key = jax.random.PRNGKey(0)
    params = jtf.init_params(key, jcfg, jnp.float32)
    proj = jcal.random_layer_projectors(key, jcfg, sals, jcfg.n_layers)
    prompt = np.random.default_rng(0).integers(0, 512, (8, 496)).astype(
        np.int32)
    ref = {}
    for g in (1, 2):
        lg, cache = jtf.prefill(params, proj, jcfg, sals,
                                {"tokens": jnp.asarray(prompt)}, 512,
                                n_groups=g)
        ref[g] = {"vq": np.asarray(cache["seg1"].v_q)}
        logits, toks = [np.asarray(lg)], [np.argmax(np.asarray(lg), -1)]
        step = jax.jit(lambda p, pr, c, t, pos: jtf.decode_step(
            p, pr, c, t, pos, jcfg, sals))
        for t in range(8):
            lg, cache = step(params, proj, cache,
                             jnp.asarray(toks[-1], jnp.int32),
                             jnp.int32(496 + t))
            logits.append(np.asarray(lg))
            toks.append(np.argmax(logits[-1], -1))
        ref[g].update(logits=np.stack(logits), toks=np.stack(toks),
                      k_lat=np.asarray(cache["seg1"].k_lat[0]),
                      full_k=np.asarray(cache["seg0"]["k"][0]))
    np.savez(tmp_path / "ref.npz",
             **_flat(jax.tree.map(np.asarray, params), "params"),
             **_flat(jax.tree.map(np.asarray, proj), "proj"), prompt=prompt)
    _ranks(tmp_path, "serve", 4)
    return np.load(tmp_path / "out.npz"), ref


def test_sharded_prefill_decode_matches_reference(serve_run):
    out, ref = serve_run
    assert int(out["local/n_groups"]) == 2 and int(out["local/plan_axes"]) == 1
    assert int(out["global/n_groups"]) == 1
    for mode, g in (("local", 2), ("global", 1)):
        logits = out[f"{mode}/logits"]
        np.testing.assert_allclose(logits, ref[g]["logits"], atol=1e-4,
                                   rtol=0)
        assert (np.argmax(logits, -1) == ref[g]["toks"]).all()
        # codes of the prefilled cache: at most 0.1% one step apart
        d = np.abs(out[f"{mode}/prefill_vq"].astype(np.int32)
                   - ref[g]["vq"].astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        # the written tokens (positions 496..503, the second kv_seq shard)
        s0, ns = out[f"{mode}/slab"]           # rank 0's slab
        assert s0 == 0 and 496 // ns == 1
        for name in ("k_lat", "full_k"):
            got = out[f"{mode}/{name}"][:, 496:504]
            assert (np.abs(got).reshape(*got.shape[:2], -1).max(-1)
                    > 0).all()
            np.testing.assert_allclose(got, ref[g][name][:, 496:504],
                                       atol=1e-4, rtol=0)
        assert (out[f"{mode}/lengths"][0] == 504).all()


def _bf16_ulp(x):
    """The bf16 spacing at |x|."""
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


def test_sharded_bf16_decode_matches_unsharded_tokens(serve_run):
    """bf16, the caches (the skip layers' full ones too) split along S
    over 2 ranks and nothing else sharded, fed the port's unsharded run's
    greedy tokens.  A split sum along S reassociates in f32, so the
    logits may move by a bf16 step or two: the tokens are equal wherever
    the unsharded run's top two logits are more than 4 bf16 steps apart,
    and the logits within 2 steps of the largest.  One full-cache
    attention on its own (rows on both sides of the slab boundary) gives
    the unsharded output but for at most 1% of elements, one bf16 step
    apart: the probabilities are rounded as the plain path rounds them."""
    out, _ = serve_run
    assert int(out["bf16/full_slab"]) == 256          # S 512 over 2 ranks
    sharded, plain = out["bf16/sharded"], out["bf16/plain"]
    top2 = np.sort(plain, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 4 * _bf16_ulp(top2[..., 1])
    assert clear.mean() >= 0.5           # 51 of the 72 here
    assert (np.argmax(sharded, -1) == np.argmax(plain, -1))[clear].all()
    np.testing.assert_allclose(sharded, plain, rtol=0,
                               atol=2 * _bf16_ulp(np.abs(plain).max()))
    a, b = out["bf16/attn_sharded"], out["bf16/attn_plain"]
    assert (a != b).mean() <= 0.01
    assert (np.abs(a - b) <= _bf16_ulp(b)).all()


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """A checkpoint saved by 2 ranks, restored by 4 (which then also try
    each kernel wrapper on a DTensor): the run's directory."""
    d = tmp_path_factory.mktemp("elastic")
    _ranks(d, "save", 2)
    _ranks(d, "restore", 4)
    return d


def test_append_chunk_into_sequence_sharded_cache(serve_run):
    """A chunk across the shards' boundary lands in both slabs, bit for
    bit where the plain cache has it (the silent-write pitfall)."""
    out, _ = serve_run
    for f in ("k_lat", "v_q", "v_scale", "v_zero", "sink_k", "recent_k",
              "recent_v", "lengths"):
        np.testing.assert_array_equal(out[f"append_sharded/{f}"],
                                      out[f"append/{f}"], err_msg=f)
    written = np.abs(out["append_sharded/k_lat"][0, :, 248:264]).max(-1)
    assert (written > 0).all()
    assert (out["append/lengths"] == 260).all()


def test_elastic_restore_across_device_counts(elastic):
    assert os.path.isdir(elastic / "ck" / "step_000000001")
    out = np.load(elastic / "out.npz")
    assert float(out["delta"]) == 0.0
    assert int(out["step"]) == 1
    assert bool(out["shards_ok"])


def _losses(text: str):
    return [float(x) for x in re.findall(r"step \d+: loss=([0-9.]+)", text)]


def test_torchrun_launcher_matches_one_process(tmp_path, capsys):
    from repro_torch.launch import train as train_cli
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    args = ["--arch", "qwen2-1.5b", "--device", "cpu", "--steps", "2",
            "--batch-size", "4", "--seq-len", "64"]
    two = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc-per-node", "2", "-m",
                          "repro_torch.launch.train", *args],
                         capture_output=True, text=True, timeout=TIMEOUT,
                         env=env, cwd=str(tmp_path))
    assert two.returncode == 0, two.stderr[-3000:]
    assert "mesh (1, 2)" in two.stdout
    train_cli.main(args)                       # the one-process run
    want = _losses(capsys.readouterr().out)
    got = _losses(two.stdout)
    assert len(want) == 2 and len(got) == 4        # both ranks log
    for i, loss in enumerate(got):
        assert abs(loss - want[i // 2]) <= 1e-4 + 1e-9


def test_ops_wrappers_raise_on_dtensor(elastic):
    raised = json.loads((elastic / "out.json").read_text())
    assert raised == {k: True for k in raised} and len(raised) == 6
