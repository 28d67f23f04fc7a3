"""int8 error-feedback gradient compression: the port's
``distributed/compression.py`` and ``trainer.make_compressed_train_step``
against the JAX reference on the same inputs.

* ``quantize_int8`` / ``dequantize_int8``: codes and scales exactly the
  reference's, an exact ``.5`` after the division rounded to even in both,
  an all-zero tensor at the 1e-12 scale floor;
* ``compressed_mean_grads`` with no process group against the reference's
  under a one-device ``shard_map``: the codes and scales of ``g + r``
  exact, the mean and the new residual within 1e-6 relative; leaves below
  ``MIN_COMPRESS`` take the plain mean and a zero residual; the residual
  is updated in place;
* ``wire_bytes`` and ``init_residual`` exactly the reference's;
* a world of 4 ``gloo`` ranks (``torch.multiprocessing`` spawn) against
  the reference over 4 host devices in a subprocess: each rank's codes
  and scales exact, the mean and residuals within 1e-6 relative (the mean
  to within f32 associativity);
* two steps of ``make_compressed_train_step`` on reduced qwen2-1.5b
  against the reference's over ``jax.make_mesh((1,), ("data",))``: loss
  within 1e-4, the weights, moments and ``ef`` leaves within
  ``tests/test_torch_train.py``'s tolerances;
* a checkpoint with ``ef`` restored across the two packages, and the
  training launcher's ``--grad-compression`` resumed from one."""
import os
import subprocess
import sys
import textwrap
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import checkpoint as jckpt
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.distributed import compression as jgc
from repro.models import transformer as jtf
from repro.train import trainer as jtrainer
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus
from repro_torch.distributed import compression as gc
from repro_torch.launch import train as train_cli
from repro_torch.train import trainer

from test_torch_train import _assert_state_close, _flat

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"w": (64, 128), "emb": (300, 40), "bias": (16,), "norm": (63, 64)}


def _grads(seed, scale=1.0):
    """Seeded f32 gradients and residuals of SHAPES (two leaves at or over
    MIN_COMPRESS, two under)."""
    rng = np.random.default_rng(seed)
    g = {k: (rng.standard_normal(s) * scale).astype(np.float32)
         for k, s in SHAPES.items()}
    r = {k: (rng.standard_normal(s) * 1e-3).astype(np.float32)
         for k, s in SHAPES.items()}
    return g, r


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _ref_one_device(g, r):
    """The reference's ``compressed_mean_grads`` on a one-device mesh."""
    mesh = jax.make_mesh((1,), ("data",))
    fn = jax.shard_map(
        lambda a, b: jgc.compressed_mean_grads(a, b, ("data",)), mesh=mesh,
        in_specs=(P(), P()), out_specs=(P(), P()), axis_names={"data"},
        check_vma=False)
    mean, res = fn(g, r)
    return ({k: np.asarray(v) for k, v in mean.items()},
            {k: np.asarray(v) for k, v in res.items()})


def _assert_rel(mine, ref, tol=1e-6, what=""):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(mine) - ref).max())
    assert err <= tol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# quantize / dequantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-6), (2, 3e4)])
def test_quantize_codes_and_scales_exact(seed, scale):
    g, _ = _grads(seed, scale)
    for k, a in g.items():
        jq, js = jgc.quantize_int8(jnp.asarray(a))
        q, s = gc.quantize_int8(torch.from_numpy(a))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq), err_msg=k)
        assert float(s) == float(js), k
        np.testing.assert_array_equal(
            gc.dequantize_int8(q, s).numpy(),
            np.asarray(jgc.dequantize_int8(jq, js)), err_msg=k)


def test_quantize_rounds_ties_to_even_and_floors_the_scale():
    # max 127 -> scale exactly 1: the codes are the values rounded
    a = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 126.5, -127.0],
                 np.float32)
    q, s = gc.quantize_int8(torch.from_numpy(a))
    jq, js = jgc.quantize_int8(jnp.asarray(a))
    assert float(s) == float(js) == 1.0
    assert q.tolist() == np.asarray(jq).tolist() == \
        [127, 0, 2, 2, -2, 0, 126, -127]
    z = np.zeros(8, np.float32)
    q, s = gc.quantize_int8(torch.from_numpy(z))
    jq, js = jgc.quantize_int8(jnp.asarray(z))
    assert float(s) == float(js) == float(np.float32(1e-12))
    assert not q.any() and not np.asarray(jq).any()


# ---------------------------------------------------------------------------
# compressed_mean_grads with no group: the reference on a one-device mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_compressed_mean_grads_no_group_equals_reference(seed):
    g, r = _grads(seed)
    jmean, jres = _ref_one_device(g, r)
    res = _t(r)
    mean, out = gc.compressed_mean_grads(_t(g), res)
    assert out is res                          # updated in place
    for k in SHAPES:
        if g[k].size < gc.MIN_COMPRESS:
            # plain mean over one rank, zero residual
            np.testing.assert_array_equal(mean[k].numpy(), g[k])
            assert not res[k].any() and not jres[k].any()
            continue
        q, s = gc.quantize_int8(torch.from_numpy(g[k] + r[k]))
        jq, js = jgc.quantize_int8(jnp.asarray(g[k]) + jnp.asarray(r[k]))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        _assert_rel(mean[k].numpy(), jmean[k], what=k)
        _assert_rel(res[k].numpy(), jres[k], what=k)
        assert mean[k].dtype == res[k].dtype == torch.float32


def test_block_leaves_share_the_layer_stacked_scale():
    """The reference stacks a block parameter's layers into one leaf: one
    scale over every layer, ``MIN_COMPRESS`` on the stacked size (two
    layers of 3,000 elements are compressed, of 1,500 are not)."""
    rng = np.random.default_rng(7)
    big = [rng.standard_normal((60, 50)).astype(np.float32) * (l + 1)
           for l in range(2)]
    small = [rng.standard_normal((30, 50)).astype(np.float32)
             for _ in range(2)]
    res = [rng.standard_normal((60, 50)).astype(np.float32) * 1e-3
           for _ in range(2)]
    g = {f"blocks.{l}.attn.wq": big[l] for l in range(2)}
    g.update({f"blocks.{l}.attn.bq": small[l] for l in range(2)})
    g["final_norm.scale"] = small[0][0]
    r = {k: np.zeros_like(v) for k, v in g.items()}
    r.update({f"blocks.{l}.attn.wq": res[l] for l in range(2)})
    assert gc.leaf_groups(g) == {
        "blocks.attn.wq": ["blocks.0.attn.wq", "blocks.1.attn.wq"],
        "blocks.attn.bq": ["blocks.0.attn.bq", "blocks.1.attn.bq"],
        "final_norm.scale": ["final_norm.scale"]}
    tres = _t(r)
    mean, _ = gc.compressed_mean_grads(_t(g), tres)
    jg = {"wq": np.stack(big), "bq": np.stack(small),
          "scale": small[0][0]}
    jr = {"wq": np.stack(res), "bq": np.zeros((2, 30, 50), np.float32),
          "scale": np.zeros(50, np.float32)}
    jmean, jres = _ref_one_device(jg, jr)
    for l in range(2):
        _assert_rel(mean[f"blocks.{l}.attn.wq"].numpy(), jmean["wq"][l])
        _assert_rel(tres[f"blocks.{l}.attn.wq"].numpy(), jres["wq"][l])
        np.testing.assert_array_equal(mean[f"blocks.{l}.attn.bq"].numpy(),
                                      small[l])
    # the joint scale: layer 0's codes are not its own per-tensor codes
    q, s = gc.quantize_int8(torch.from_numpy(np.stack(big) + np.stack(res)))
    np.testing.assert_allclose(
        mean["blocks.0.attn.wq"].numpy(), q[0].float().numpy() * float(s),
        rtol=0, atol=1e-7)
    _, s0 = gc.quantize_int8(torch.from_numpy(big[0] + res[0]))
    assert float(s0) < float(s)


def test_small_leaves_take_the_plain_mean_and_bf16_grads_are_upcast():
    g, r = _grads(5)
    small = {k: v for k, v in g.items() if v.size < gc.MIN_COMPRESS}
    assert small and len(small) < len(g)
    grads = {k: torch.from_numpy(v).bfloat16() for k, v in g.items()}
    res = _t(r)
    mean, _ = gc.compressed_mean_grads(grads, res)
    up = {k: v.float().numpy() for k, v in grads.items()}
    jmean, jres = _ref_one_device(up, r)
    for k in g:
        _assert_rel(mean[k].numpy(), jmean[k], what=k)
        _assert_rel(res[k].numpy(), jres[k], what=k)
    for k in small:
        np.testing.assert_array_equal(mean[k].numpy(), up[k])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("ranks", [1, 4, 8])
def test_wire_bytes_and_init_residual_equal_reference(arch, ranks):
    jcfg = jax_get_config(arch).reduced(dtype="float32")
    cfg = get_config(arch).reduced(dtype="float32")
    jp = jtf.init_params(KEY, jcfg, jnp.float32)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                       device="cpu")
    assert gc.wire_bytes(params, ranks) == jgc.wire_bytes(jp, ranks)
    res = gc.init_residual(params)
    mine = _flat(convert.state_to_numpy({"ef": res}))
    ref = _flat({"ef": jax.tree.map(np.asarray, jgc.init_residual(jp))})
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].shape == ref[k].shape and not mine[k].any(), k
    assert all(t.dtype == torch.float32 for t in res.values())


# ---------------------------------------------------------------------------
# A world of 4 gloo ranks against the reference over 4 host devices
# ---------------------------------------------------------------------------

WORLD = 4


def _rank_body(rank, world, port, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        g, r = _grads(100 + rank)
        res = _t(r)
        assert gc.group_size() == world
        mean, _ = gc.compressed_mean_grads(_t(g), res)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{f"mean/{k}": v.numpy() for k, v in mean.items()},
                 **{f"res/{k}": v.numpy() for k, v in res.items()})
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launcher_rank(rank, world, port, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        state = train_cli.main([
            "--arch", "qwen2-1.5b", "--device", "cpu", "--steps", "2",
            "--batch-size", "4", "--seq-len", "32", "--grad-compression",
            "--ckpt-dir", os.path.join(out_dir, "ck"),
            "--checkpoint-every", "2"])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **_flat(convert.state_to_numpy(state)))
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, out_dir, timeout=120):
    ctx = torch.multiprocessing.spawn(
        fn, args=(world, _free_port(), str(out_dir)), nprocs=world,
        join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} gloo ranks did not finish in {timeout} s")


def test_train_cli_grad_compression_over_two_gloo_ranks(tmp_path):
    """The launcher under an initialized group of 2: each rank trains on
    its half of every batch, both end with the same weights and moments
    (their residuals are their own), rank 0 alone writes the checkpoint,
    and the run differs from one rank on the whole batch."""
    _spawn(_launcher_rank, 2, tmp_path)
    a, b = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    for k in a.files:
        if not k.startswith("ef/"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert any(not np.array_equal(a[k], b[k]) for k in a.files
               if k.startswith("ef/"))
    assert ckpt.list_checkpoints(str(tmp_path / "ck")) == [2]
    one = train_cli.main([
        "--arch", "qwen2-1.5b", "--device", "cpu", "--steps", "2",
        "--batch-size", "4", "--seq-len", "32", "--grad-compression"])
    mine = _flat(convert.state_to_numpy(one))
    assert not np.array_equal(mine["params/blocks/attn/wq"],
                              a["params/blocks/attn/wq"])


def test_world_of_four_gloo_equals_reference_on_four_devices(tmp_path):
    _spawn(_rank_body, WORLD, tmp_path)
    # the reference: rank i's gradients on host device i
    stacked = [_grads(100 + i) for i in range(WORLD)]
    np.savez(tmp_path / "in.npz",
             **{f"g/{k}": np.stack([s[0][k] for s in stacked])
                for k in SHAPES},
             **{f"r/{k}": np.stack([s[1][k] for s in stacked])
                for k in SHAPES})
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={WORLD}"
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.distributed import compression as gc
        z = np.load({str(tmp_path / "in.npz")!r})
        names = sorted({{k.split("/")[1] for k in z.files}})
        g = {{k: z["g/" + k] for k in names}}
        r = {{k: z["r/" + k] for k in names}}
        mesh = jax.make_mesh(({WORLD},), ("data",))

        def body(a, b):
            m, nr = gc.compressed_mean_grads(
                {{k: v[0] for k, v in a.items()}},
                {{k: v[0] for k, v in b.items()}}, ("data",))
            return m, {{k: v[None] for k, v in nr.items()}}

        mean, res = jax.shard_map(
            body, mesh=mesh, in_specs=(P("data"), P("data")),
            out_specs=(P(), P("data")), axis_names={{"data"}},
            check_vma=False)(g, r)
        np.savez({str(tmp_path / "ref.npz")!r},
                 **{{"mean/" + k: np.asarray(v) for k, v in mean.items()}},
                 **{{"res/" + k: np.asarray(v) for k, v in res.items()}})
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ,
                               "PYTHONPATH": os.path.join(ROOT, "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(tmp_path / "ref.npz")
    exact = {k: np.mean(np.stack([s[0][k] for s in stacked]), 0)
             for k in SHAPES}
    for rank in range(WORLD):
        mine = np.load(tmp_path / f"rank{rank}.npz")
        for k in SHAPES:
            _assert_rel(mine[f"mean/{k}"], ref[f"mean/{k}"], what=(rank, k))
            _assert_rel(mine[f"res/{k}"], ref[f"res/{k}"][rank],
                        what=(rank, k))
            # every rank holds the same mean, close to the exact mean
            rel = np.linalg.norm(mine[f"mean/{k}"] - exact[k]) / \
                np.linalg.norm(exact[k])
            assert rel < 0.02, (k, rel)
            if np.prod(SHAPES[k]) < gc.MIN_COMPRESS:
                assert not mine[f"res/{k}"].any()
    # each rank's codes and scales of g + r, exactly the reference's
    for g, r in stacked:
        for k in SHAPES:
            q, s = gc.quantize_int8(torch.from_numpy(g[k] + r[k]))
            jq, js = jgc.quantize_int8(jnp.asarray(g[k]) + jnp.asarray(r[k]))
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            assert float(s) == float(js)


# ---------------------------------------------------------------------------
# make_compressed_train_step against the reference's on a one-device mesh
# ---------------------------------------------------------------------------

def _pair():
    over = dict(n_layers=2, vocab_size=512, dtype="float32")
    return (jax_get_config("qwen2-1.5b").reduced(**over),
            get_config("qwen2-1.5b").reduced(**over))


def _states(jcfg, cfg, jtcfg):
    jstate = jtrainer.init_state(KEY, jcfg, jtcfg, jnp.float32,
                                 ef_residual=True)
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                     device="cpu")
    assert "ef" in state and all(not t.any() for t in state["ef"].values())
    return jstate, state


def test_compressed_train_step_equals_reference_one_device_mesh():
    jcfg, cfg = _pair()
    kw = dict(steps=10, batch_size=4, seq_len=32, lr=1e-3, warmup_steps=1)
    jtcfg, tcfg = JTrainConfig(**kw), TrainConfig(**kw)
    jstate, state = _states(jcfg, cfg, jtcfg)
    jstep = jax.jit(jtrainer.make_compressed_train_step(
        jcfg, jtcfg, jax.make_mesh((1,), ("data",)), ("data",)))
    step = trainer.make_compressed_train_step(cfg, tcfg)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    flips = {}
    for i in range(2):
        batch = corpus.batch(i, 4, 32)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, trainer.batch_to(batch, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        for k in ("ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=f"step {i} {k}")
        mine = _flat(convert.state_to_numpy(state))
        ref = _flat(jax.tree.map(np.asarray, jstate))
        assert sorted(mine) == sorted(ref)
        assert any(k.startswith("ef/") for k in ref)
        for k in [k for k in ref if k.startswith("ef/")]:
            flips[k[3:]] = _code_flips(
                mine[k], ref[k], flips.get(k[3:], np.zeros(ref[k].shape,
                                                          bool)), k)
        # an element whose code flipped takes a gradient one scale step
        # apart into its moments (and, through them, its weight): held out
        # of the train tolerances, everything else held to them
        for k in ref:
            leaf = k.split("/", 2 if k.startswith("opt/") else 1)[-1]
            if leaf in flips and not k.startswith("ef/"):
                mine[k] = np.where(flips[leaf], ref[k], mine[k])
        _assert_state_close({k: v for k, v in mine.items()
                             if not k.startswith("ef/")},
                            {k: v for k, v in ref.items()
                             if not k.startswith("ef/")},
                            1e-5 if i == 0 else 1e-4, f"step {i}")


def _code_flips(mine, ref, earlier, what):
    """Where the residuals differ: a code of ``g + r`` on a rounding
    boundary, rounded one way in one package and the other way in the
    other (their f32 gradients differ in the last bits), moves the
    residual by one whole scale step, about twice its largest magnitude;
    an element that flipped at an earlier step (``earlier``) carries that
    difference on, within one step.  Anything else within 1e-4 relative;
    at most 0.1% of a leaf.  Returns the flips so far."""
    flip = ~np.isclose(mine, ref, rtol=1e-4, atol=1e-6)
    step = 2 * max(float(np.abs(ref).max()), float(np.abs(mine).max()))
    d = np.abs(mine - ref)
    assert np.all(d[flip] <= 1.01 * step), (what, d[flip])
    assert np.all(d[flip & ~earlier] > 0.49 * step), (what, d[flip])
    flip |= earlier
    assert flip.mean() < 1e-3, (what, int(flip.sum()))
    return flip


def test_compressed_step_without_group_quantizes_every_large_leaf():
    """One rank: the mean is each leaf's own dequantized code, so the
    update differs from the uncompressed step's, and ef + mean == grad."""
    _, cfg = _pair()
    tcfg = TrainConfig(steps=4, batch_size=2, seq_len=32, lr=1e-3)
    state = trainer.init_state(cfg, tcfg, device="cpu", ef_residual=True)
    batch = trainer.batch_to(SyntheticCorpus(cfg.vocab_size).batch(0, 2, 32),
                             "cpu")
    _, _, grads = trainer.loss_and_grads(state["params"], cfg, batch, "none")
    mean, res = gc.compressed_mean_grads(grads, state["ef"])
    large = [k for k, g in grads.items() if g.numel() >= gc.MIN_COMPRESS]
    assert large
    for k in large:
        assert not torch.equal(mean[k], grads[k])
        torch.testing.assert_close(mean[k] + res[k], grads[k], rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# ef in checkpoints, across the two packages; the launcher's flag
# ---------------------------------------------------------------------------

def test_checkpoint_with_ef_crosses_packages(tmp_path):
    jcfg, cfg = _pair()
    jt = JTrainConfig(steps=4, batch_size=2, seq_len=16, lr=1e-3)
    jstate, _ = _states(jcfg, cfg, jt)
    jstep = jax.jit(jtrainer.make_compressed_train_step(
        jcfg, jt, jax.make_mesh((1,), ("data",)), ("data",)))
    jstate, _ = jstep(jstate, jax.tree.map(
        jnp.asarray, SyntheticCorpus(512).batch(0, 2, 16)))
    assert any(np.asarray(v).any() for v in jax.tree.leaves(jstate["ef"]))
    # reference -> port
    d_ref = str(tmp_path / "ref")
    jckpt.save(d_ref, 1, jstate)
    state = trainer.init_state(cfg, TrainConfig(), device="cpu",
                               ef_residual=True)
    _, step = ckpt.restore(d_ref, state)
    assert step == 1
    ref_np = jax.tree.map(np.asarray, jstate)
    mine = _flat(convert.state_to_numpy(state))
    for k, v in _flat(ref_np).items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    # port -> reference
    d_port = str(tmp_path / "port")
    ckpt.save(d_port, 1, state)
    restored, _ = jckpt.restore(d_port, jax.tree.map(jnp.zeros_like, jstate))
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a checkpoint without ef cannot fill a state that has one
    d_plain = str(tmp_path / "plain")
    ckpt.save(d_plain, 1, trainer.init_state(cfg, TrainConfig(),
                                             device="cpu"))
    with pytest.raises(KeyError, match="ef/"):
        ckpt.restore(d_plain, state)


def test_train_cli_grad_compression_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    common = ["--arch", "qwen2-1.5b", "--device", "cpu", "--batch-size",
              "2", "--seq-len", "32", "--ckpt-dir", d,
              "--checkpoint-every", "2", "--grad-compression"]
    train_cli.main(common + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "over 1 rank" in out and "step 1: loss=" in out
    train_cli.main(common + ["--steps", "4", "--resume"])
    out = capsys.readouterr().out
    assert "[train] restored step 2" in out and "step 3: loss=" in out
    assert ckpt.list_checkpoints(d) == [2, 4]
    with np.load(os.path.join(d, "step_000000004", "arrays.npz")) as z:
        ef = [k for k in z.files if k.startswith("ef/")]
        assert ef and any(z[k].any() for k in ef)
