"""The moe, hybrid and ssm families sharded on 4 gloo ranks ((2, 2)
("data", "model") mesh) on the CPU, held to the JAX reference's
single-device results.

As in ``tests/test_torch_distributed.py``, the ranks run in one
subprocess (``python worker.py``, written into a temp dir; it imports
``repro_torch`` and never JAX) under its own timeout, forked from a parent
that imported the port once; the parent computes the reference's numbers
with JAX and hands them over in ``ref.npz``, and the ranks write theirs
into ``out.npz``.  Every rank case runs in that one start.

* (i) ``build_train``, reduced f32 configs (2 layers, vocab 512), B 8, lr
  1e-3: the loss and every parameter within 1e-4 of the reference's
  jitted single-device step, and the parameters at rest in the
  placements of the reference's ``train_state_pspecs`` for the strategy
  (its layer entry dropped):
  qwen3-moe at capacity factor 1.0 (so that tokens drop) under
  ``tp_sp`` and ``ep_dp`` at S 64, where a 64-token group straddles the
  two ``model`` shards of the sequence, under ``ep_dp`` at S 512, where
  each shard holds whole 256-token groups (the all-to-all path), and
  under ``fsdp`` at S 64; hymba-1.5b (S 64: at a 128-token SSD chunk the
  zero-initialised decay overflows ``exp`` and both packages' gradients
  are NaN) and rwkv6-7b (S 32) under ``tp_sp``;
* (ii) ``build_prefill`` + ``build_decode``, 8 greedy steps, B 8:
  llama4-scout and hymba-1.5b (4 layers, f32) with ``sals_for_shape``'s
  SALS at S 512 (a 496- / 384-token prompt: the hybrid's SSD takes
  multiples of 128) in both ``dist_mode``s, against the reference at
  n_groups 2 ("local") and 1 ("global"); rwkv6-7b without SALS at S 64
  (a 48-token prompt).  Tokens exact, logits within 1e-4, and every
  recurrent state leaf of the final cache, gathered, within 1e-4;
* (iii) ``python -m repro_torch.launch.dryrun`` on the fake 256-rank
  group at ``decode_32k`` for qwen3-moe, hymba-1.5b and rwkv6-7b: status
  ``ok``; llama4-scout at ``prefill_32k`` (each rank holds whole 256-token
  groups): a nonzero all-to-all byte count.  At ``decode_32k`` every
  ``model`` rank holds the same one-token groups (8 rows a data rank, 16
  ``model`` ranks), so the experts take their own slots with no
  exchange, as the reference's layout does there;
* (iv) ``python -m torch.distributed.run --nproc-per-node 2 -m
  repro_torch.launch.train --arch qwen3-moe-235b-a22b``: the logged
  losses within 1e-4 of the one-process run's;
* (v) the paths that stay unsharded (a paged pool's decode, chunked
  prefill, the verify window) refuse DTensor tokens with a message
  naming the path;
* (vi) ``sharding.keep_ctx`` carries the sharding context to another
  thread (a recomputation in the backward on a GPU).
"""
import json
import os
import re
import subprocess
import sys
import tempfile

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
QWEN3, LLAMA4 = "qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"
HYMBA, RWKV = "hymba-1.5b", "rwkv6-7b"
# (name, arch, strategy, S); the reference step is per (arch, S)
TRAIN = [("moe_tp_sp_straddle", QWEN3, "tp_sp", 64),
         ("moe_ep_dp_straddle", QWEN3, "ep_dp", 64),
         ("moe_ep_dp_local", QWEN3, "ep_dp", 512),
         ("moe_fsdp", QWEN3, "fsdp", 64),
         ("hybrid_tp_sp", HYMBA, "tp_sp", 64),
         ("ssm_tp_sp", RWKV, "tp_sp", 32)]
# (name, arch, S, prompt length, reference n_groups, dist_mode)
SERVE = [("llama4_local", LLAMA4, 512, 496, 2, "local"),
         ("llama4_global", LLAMA4, 512, 496, 1, "global"),
         ("hymba_local", HYMBA, 512, 384, 2, "local"),
         ("hymba_global", HYMBA, 512, 384, 1, "global"),
         ("rwkv", RWKV, 64, 48, 1, "global")]
DRYRUN = [(QWEN3, "decode_32k"), (HYMBA, "decode_32k"), (RWKV, "decode_32k"),
          (LLAMA4, "prefill_32k")]

WORKER = r'''
import os, sys, json
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TRAIN = json.loads(sys.argv[3])
SERVE = json.loads(sys.argv[4])


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


def train_cfg(arch):
    from repro_torch.configs import get_config
    kw = {"moe_capacity_factor": 1.0} if "qwen3" in arch else {}
    return get_config(arch).reduced(n_layers=2, vocab_size=512, **kw)


def case_train(rank, d, mesh, ref, name, arch, strategy, s):
    from repro_torch import convert
    from repro_torch.config import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as sp
    cfg = train_cfg(arch)
    tcfg = TrainConfig(steps=2, batch_size=8, seq_len=s, lr=1e-3)
    mc = MeshConfig(shape=(2, 2), axis_names=("data", "model"))
    fn, like, in_pl, _ = sp.build_train(
        cfg, ShapeConfig("t", "train", s, 8), mesh, mc, remat="block",
        tcfg=tcfg, strategy=strategy)
    key = f"{arch}_{s}"
    batch = {k: torch.as_tensor(ref[f"{key}/batch/{k}"])
             for k in ("tokens", "labels")}
    st = convert.state_from_numpy(unflat(ref, f"{key}/state"), cfg,
                                  device="cpu")
    st = {k: sh.place(v, mesh, in_pl[0][k]) for k, v in st.items()}
    with open(os.path.join(d, f"specs_{name}.json")) as f:
        ref_specs = json.load(f)

    def ref_spec(n):
        parts = n.split(".")
        if parts[0] != "blocks":
            return ref_specs["/".join(parts)]
        return ref_specs["/".join(["blocks"] + parts[2:])][1:]

    want = {k: sh.placements(sh.P(*(tuple(e) if isinstance(e, list) else e
                                    for e in ref_spec(k))), mesh)
            for k, _ in like[0]["params"].named_parameters()}
    at_rest = all(tuple(p.placements) == want[k]
                  for k, p in st["params"].named_parameters())
    st, m = fn(st, sh.place(batch, mesh, in_pl[1]))
    at_rest &= all(tuple(p.placements) == want[k]
                   for k, p in st["params"].named_parameters())
    out = flat(convert.state_to_numpy(sh.gather(st["params"])),
               f"{name}/params")
    out[f"{name}/loss"] = float(m["loss"].to_local())
    out[f"{name}/at_rest"] = at_rest
    out[f"{name}/n_sharded"] = sum(any(not p.is_replicate() for p in v)
                                   for v in want.values())
    return out


def recurrent(cache):
    """{segment/name: tensor} of a cache's recurrent state leaves."""
    from repro_torch.core.latent_cache import LatentKVCache
    out = {}
    for sname, seg in cache.items():
        if isinstance(seg, LatentKVCache):
            tree = seg.ssm or {}
        else:
            tree = seg.get("ssm", {k: v for k, v in seg.items()
                                   if k in ("wkv", "tm_x", "cm_x")})
        out.update({f"{sname}/{k}": v for k, v in tree.items()})
    return out


def case_serve(rank, d, mesh, ref, name, arch, s, p0, n_groups, mode):
    from repro_torch import convert
    from repro_torch.config import MeshConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as sp
    cfg = get_config(arch).reduced(n_layers=4, vocab_size=512,
                                   dtype="float32")
    shape = ShapeConfig("d", "decode", s, 8)
    mc = MeshConfig(shape=(2, 2), axis_names=("data", "model"))
    params = convert.params_from_numpy(unflat(ref, f"{arch}/params"), cfg,
                                       "cpu")
    proj_np = unflat(ref, f"{arch}/proj")
    proj = convert.projectors_from_numpy(proj_np, "cpu") if proj_np \
        else None
    prompt = torch.as_tensor(ref[f"{arch}/prompt"])
    pf = sp.build_prefill(cfg, shape, mesh, mc, dist_mode=mode)
    dc = sp.build_decode(cfg, shape, mesh, mc, dist_mode=mode)
    pp = sh.place(params, mesh, pf[2][0])
    pj = None if proj is None else sh.place(dict(proj), mesh, pf[2][1])
    out = {}
    with torch.no_grad():
        lg, cache = pf[0](pp, pj, sh.place({"tokens": prompt}, mesh,
                                           pf[2][2]))
        logits = [lg.full_tensor().numpy()]
        for t in range(8):
            tok = torch.as_tensor(logits[-1].argmax(-1))
            lg, cache = dc[0](pp, pj, cache, sh.place(tok, mesh, dc[2][3]),
                              torch.tensor(p0 + t, dtype=torch.int32))
            logits.append(lg.full_tensor().numpy())
        out[f"{name}/logits"] = np.stack(logits)
        for k, v in recurrent(cache).items():
            out[f"{name}/state/{k}"] = v.full_tensor().numpy()
        seg = cache.get("seg1")
        out[f"{name}/n_groups"] = getattr(seg, "n_groups", 1)
    return out


def unsharded_paths(mesh):
    """Each path that stays unsharded, called with DTensor tokens: the
    message it raises."""
    from torch.distributed.tensor import Replicate
    from repro_torch.configs import get_config
    from repro_torch.config import SALSConfig
    from repro_torch.core import calibration as cal
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tf
    cfg = get_config("yi-9b").reduced(n_layers=3, vocab_size=512,
                                      dtype="float32")
    sals = SALSConfig(n_critical=8, n_sink=2, n_recent=4, v_group=32,
                      skip_layers_front=1, skip_layers_back=1)
    params = tf.init_params(cfg, device="cpu", seed=0)
    proj = cal.random_layer_projectors(cfg, sals, cfg.n_layers,
                                       torch.Generator().manual_seed(0))
    rep = (Replicate(),) * mesh.ndim
    tok = sh.place(torch.zeros(2, dtype=torch.int32), mesh, rep)
    calls = {
        "paged": lambda: tf.decode_step(
            params, proj, tf.init_cache(cfg, sals, 2, 64, page_size=16,
                                        n_pages=8, device="cpu"),
            tok, 0, cfg, sals),
        "chunked": lambda: tf.prefill_chunk(
            params, proj, cfg, sals, tf.init_cache(cfg, sals, 2, 64,
                                                   device="cpu"),
            tf.init_prefill_scratch(cfg, sals, 2, 64, device="cpu"),
            {"tokens": sh.place(torch.zeros(2, 8, dtype=torch.int32), mesh,
                                rep)}, 0, torch.full((2,), 8)),
        "window": lambda: tf.decode_window(
            params, proj, tf.init_cache(cfg, sals, 2, 64, device="cpu"),
            sh.place(torch.zeros(2, 4, dtype=torch.int32), mesh, rep), 0,
            cfg, sals),
    }
    said = {}
    with torch.no_grad():
        for name, call in calls.items():
            try:
                call()
                said[name] = ""
            except ValueError as e:
                said[name] = str(e)
    return said


def run(rank, world, d):
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        d, "store"), rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        ref = np.load(os.path.join(d, "ref.npz"))
        out = {}
        for case in TRAIN:
            out.update(case_train(rank, d, mesh, ref, *case))
        for case in SERVE:
            out.update(case_serve(rank, d, mesh, ref, *case))
        said = unsharded_paths(mesh)
        if rank == 0:
            np.savez(os.path.join(d, "out.npz"), **out)
            with open(os.path.join(d, "said.json"), "w") as f:
                json.dump(said, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    d = sys.argv[2]
    import repro_torch.launch.specs, repro_torch.convert
    mp.start_processes(run, args=(int(sys.argv[1]), d), nprocs=int(
        sys.argv[1]), start_method="fork")
'''


def _env():
    return {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
            "OMP_NUM_THREADS": "1"}


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def _spec_json(specs) -> str:
    return json.dumps({
        "/".join(str(getattr(p, "key", p)) for p in path):
            [list(e) if isinstance(e, tuple) else e for e in spec]
        for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]})


def _jax_train_cfg(arch):
    kw = {"moe_capacity_factor": 1.0} if arch == QWEN3 else {}
    return jax_get_config(arch).reduced(n_layers=2, vocab_size=512, **kw)


def _reference_train(d, ref: dict) -> dict:
    """The reference's single-device step per (arch, S) into ``ref``; its
    train-state specs per case into ``d``.  Returns {case: (loss, params
    after the step)}."""
    mesh = Mesh(np.array(jax.devices()[:1] * 4).reshape(2, 2),
                ("data", "model"))
    steps, out = {}, {}
    for name, arch, strategy, s in TRAIN:
        jcfg = _jax_train_cfg(arch)
        tcfg = JTrainConfig(steps=2, batch_size=8, seq_len=s, lr=1e-3)
        key = f"{arch}_{s}"
        if key not in steps:
            batch = SyntheticCorpus(512, seed=0).batch(0, 8, s)
            state = jtrainer.init_state(jax.random.PRNGKey(0), jcfg, tcfg,
                                        jnp.float32)
            s1, m1 = jax.jit(jtrainer.make_train_step(jcfg, tcfg,
                                                      remat="block"))(
                state, jax.tree.map(jnp.asarray, batch))
            ref.update(_flat(jax.tree.map(np.asarray, state),
                             f"{key}/state"))
            ref.update({f"{key}/batch/{k}": np.asarray(v)
                        for k, v in batch.items()})
            steps[key] = (float(m1["loss"]),
                          _flat(jax.tree.map(np.asarray, s1["params"]), ""),
                          state)
        loss, params, state = steps[key]
        specs = jsp.train_state_pspecs(jcfg, tcfg, mesh, jax.eval_shape(
            lambda: state), strategy=strategy)["params"]
        with open(os.path.join(d, f"specs_{name}.json"), "w") as f:
            f.write(_spec_json(specs))
        out[name] = (loss, params)
    return out


def _state_leaves(cache) -> dict:
    """{segment/name: array} of a reference cache's recurrent state."""
    out = {}
    for sname, seg in cache.items():
        if isinstance(seg, dict):
            tree = seg.get("ssm", {k: v for k, v in seg.items()
                                   if k in ("wkv", "tm_x", "cm_x")})
        else:
            tree = seg.ssm or {}
        out.update({f"{sname}/{k}": np.asarray(v) for k, v in tree.items()})
    return out


def _reference_serve(ref: dict) -> dict:
    """The reference's single-device prefill + 8 greedy decode steps per
    serve case.  Returns {case: {"logits", "toks", "state"}}."""
    out, made = {}, set()
    for name, arch, s, p0, n_groups, _ in SERVE:
        jcfg = jax_get_config(arch).reduced(n_layers=4, vocab_size=512,
                                            dtype="float32")
        sals = jsp.sals_for_shape(jcfg, JShapeConfig("d", "decode", s, 8))
        key = jax.random.PRNGKey(0)
        params = jtf.init_params(key, jcfg, jnp.float32)
        proj = None if sals is None else \
            jcal.random_layer_projectors(key, jcfg, sals, jcfg.n_layers)
        prompt = np.random.default_rng(0).integers(0, 512, (8, p0)) \
            .astype(np.int32)
        if arch not in made:
            made.add(arch)
            ref.update(_flat(jax.tree.map(np.asarray, params),
                             f"{arch}/params"))
            if proj is not None:
                ref.update(_flat(jax.tree.map(np.asarray, proj),
                                 f"{arch}/proj"))
            ref[f"{arch}/prompt"] = prompt
        lg, cache = jtf.prefill(params, proj, jcfg, sals,
                                {"tokens": jnp.asarray(prompt)}, s,
                                n_groups=n_groups)
        step = jax.jit(lambda p, pr, c, t, pos: jtf.decode_step(
            p, pr, c, t, pos, jcfg, sals))
        logits = [np.asarray(lg)]
        for t in range(8):
            lg, cache = step(params, proj, cache,
                             jnp.asarray(np.argmax(logits[-1], -1),
                                         jnp.int32), jnp.int32(p0 + t))
            logits.append(np.asarray(lg))
        logits = np.stack(logits)
        out[name] = {"logits": logits, "toks": np.argmax(logits, -1),
                     "state": _state_leaves(cache)}
    return out


def _dryrun(out: str):
    """The dry-run cells as concurrent subprocesses, each logging into
    ``out``."""
    procs = []
    for arch, shape in DRYRUN:
        with open(os.path.join(out, f"{arch}.{shape}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--out", out], stdout=log,
                stderr=subprocess.STDOUT, env=_env(), cwd=out))
    return procs


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """Everything at once: the dry-run cells start first and run beside
    the reference's steps and the ranks.  Returns (ranks' out.npz, the
    paths' messages, the reference's train and serve numbers, the
    dry-run records and their exit codes)."""
    d = tmp_path_factory.mktemp("families")
    dr = d / "dryrun"
    dr.mkdir()
    procs = _dryrun(str(dr))
    try:
        ref = {}
        train_ref = _reference_train(d, ref)
        serve_ref = _reference_serve(ref)
        np.savez(d / "ref.npz", **ref)
        (d / "worker.py").write_text(WORKER)
        proc = subprocess.run(
            [sys.executable, str(d / "worker.py"), "4", str(d),
             json.dumps(TRAIN), json.dumps(SERVE)], capture_output=True,
            text=True, timeout=TIMEOUT, env=_env(), cwd=str(d))
        assert proc.returncode == 0, proc.stderr[-4000:]
        rcs = [p.wait(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    records = {}
    for arch, shape in DRYRUN:
        with open(dr / f"{arch}.{shape}.pod16x16.json") as f:
            records[(arch, shape)] = json.load(f)
    return (np.load(d / "out.npz"), json.loads((d / "said.json").read_text()),
            train_ref, serve_ref, records, rcs)


@pytest.mark.parametrize("case", [c[0] for c in TRAIN])
def test_sharded_train_step_matches_single_device(families, case):
    out, _, train_ref, *_ = families
    loss, params = train_ref[case]
    assert bool(out[f"{case}/at_rest"])
    assert int(out[f"{case}/n_sharded"]) > 0
    assert np.isfinite(loss)
    assert abs(float(out[f"{case}/loss"]) - loss) <= 1e-4 * abs(loss)
    n = 0
    for key, want in params.items():
        got = out[f"{case}/params{key}"]
        assert np.abs(got - want).max() < 1e-4, key
        n += 1
    assert n == len(params) > 0


@pytest.mark.parametrize("case", [c[0] for c in SERVE])
def test_sharded_prefill_decode_matches_reference(families, case):
    out, _, _, serve_ref, *_ = families
    want = serve_ref[case]
    n_groups = next(c[4] for c in SERVE if c[0] == case)
    assert int(out[f"{case}/n_groups"]) == n_groups
    logits = out[f"{case}/logits"]
    np.testing.assert_allclose(logits, want["logits"], atol=1e-4, rtol=0)
    assert (np.argmax(logits, -1) == want["toks"]).all()
    assert bool(want["state"]) == (not case.startswith("llama4"))
    for key, state in want["state"].items():
        np.testing.assert_allclose(out[f"{case}/state/{key}"], state,
                                   atol=1e-4, rtol=0, err_msg=key)


@pytest.mark.parametrize("cell", DRYRUN[:3], ids=lambda c: c[0])
def test_dryrun_new_family_cells(families, cell):
    *_, records, rcs = families
    rec = records[cell]
    assert rcs[DRYRUN.index(cell)] == 0
    assert rec["status"] == "ok", rec.get("error")
    assert rec["roofline"]["collective_bytes"] > 0


def test_moe_step_counts_its_all_to_all(families):
    """Whole groups on every rank (llama4-scout, prefill_32k): the expert
    exchange is an all-to-all over ``model`` and the counter sees it."""
    *_, records, rcs = families
    rec = records[(LLAMA4, "prefill_32k")]
    assert rcs[-1] == 0 and rec["status"] == "ok", rec.get("error")
    assert rec["roofline"]["collective_breakdown"].get("all-to-all", 0) > 0


@pytest.mark.parametrize("path", ["paged", "chunked", "window"])
def test_unsharded_paths_refuse_dtensors(families, path):
    said = families[1][path]
    name = {"paged": "the paged pool", "chunked": "chunked prefill",
            "window": "the verify window"}[path]
    assert said.startswith(f"{name} is not sharded"), said


def test_every_family_runs_sharded():
    from repro_torch.configs import all_configs
    from repro_torch.models import transformer as tf
    assert {c.family for c in all_configs().values()} <= set(tf.SHARDED)


def test_keep_ctx_carries_the_context_to_another_thread():
    """A checkpointed block's recomputation runs on autograd's device
    thread on a GPU: ``keep_ctx`` binds the sharding context to it."""
    import threading
    from repro_torch.distributed import sharding as shd
    seen = []
    with shd.use_sharding("mesh", {"batch": "data"}):
        bound = shd.keep_ctx(lambda: seen.append(shd.current_ctx()))
        bare = lambda: seen.append(shd.current_ctx())      # noqa: E731
    for fn in (bound, bare):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    assert seen[0] is not None and seen[0].rules == {"batch": "data"}
    assert seen[1] is None
    assert shd.keep_ctx(bare) is bare                # no context: as is


def _losses(text: str):
    return [float(x) for x in re.findall(r"step \d+: loss=([0-9.]+)", text)]


def test_torchrun_launcher_moe_matches_one_process(capsys):
    from repro_torch.launch import train as train_cli
    args = ["--arch", QWEN3, "--device", "cpu", "--steps", "2",
            "--batch-size", "4", "--seq-len", "64"]
    with tempfile.TemporaryDirectory() as d:
        two = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                              "--standalone", "--nproc-per-node", "2", "-m",
                              "repro_torch.launch.train", *args],
                             capture_output=True, text=True,
                             timeout=TIMEOUT, env=_env(), cwd=d)
    assert two.returncode == 0, two.stderr[-3000:]
    assert "mesh (1, 2)" in two.stdout
    train_cli.main(args)                       # the one-process run
    want = _losses(capsys.readouterr().out)
    got = _losses(two.stdout)
    assert len(want) == 2 and len(got) == 4        # both ranks log
    for i, loss in enumerate(got):
        assert abs(loss - want[i // 2]) <= 1e-4 + 1e-9
