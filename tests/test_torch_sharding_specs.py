"""Spec parity: the port's sharding layer (``repro_torch.distributed.
sharding``, the ``*_specs`` functions, ``repro_torch.launch.specs``)
against the JAX reference's, with no process group.

* For every config of ``ASSIGNED_ARCHS`` + ``PAPER_ARCHS`` on the (2, 4),
  (16, 16) and (2, 16, 16) meshes (the reference's ``Mesh`` over one
  repeated CPU device, the port's ``MeshConfig`` of the same names and
  sizes): ``param_specs``, ``train_state_pspecs`` (tp_sp / fsdp / ep_dp),
  ``train_rules``, ``serve_param_pspecs``, ``decode_n_groups`` equal the
  reference's entry by entry, the reference's stacked layer axis dropped
  (the port keeps per-layer modules).  Where the reference's FSDP puts
  the data axis on that layer axis (a (L, n) leaf whose L is its largest
  divisible dim), the port's per-layer leaf is replicated over it: the
  reference's spec with the layer entry dropped.
* ``cache_pspecs`` for the dense, grouped, hybrid and ssm caches;
  ``default_rules`` for each of ``SHAPES``; ``sals_for_shape``,
  ``input_specs``' shapes and dtypes and ``cell_status`` per cell.
* The cases of the reference's ``tests/test_sharding_specs.py``, and
  ``tree_shardings``' placements (composites on both mesh dims; a
  composite out of mesh order raises).
"""
import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.config import MeshConfig as JMeshConfig
from repro.config import SALSConfig as JSALSConfig
from repro.config import SHAPES as JSHAPES
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsh
from repro.launch import mesh as jmesh_mod
from repro.launch import specs as jsp
from repro.models import transformer as jtf
from repro.train import trainer as jtrainer
from repro_torch.config import SHAPES, MeshConfig, SALSConfig, ShapeConfig
from repro_torch.config import TrainConfig
from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ARCHS, get_config
from repro_torch.core import calibration as cal
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch import mesh as pmesh_mod
from repro_torch.launch import specs as sp
from repro_torch.models import transformer as tf
from repro_torch.train import trainer

ARCHS = ASSIGNED_ARCHS + PAPER_ARCHS
MESHES = {(2, 4): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}


def _jmesh(shape):
    dev = np.array(jax.devices()[:1] * int(np.prod(shape))).reshape(shape)
    return Mesh(dev, MESHES[shape])


def _pmesh(shape, **kw):
    return MeshConfig(shape=shape, axis_names=MESHES[shape], **kw)


def _norm(spec, nd=None) -> tuple:
    """A reference or port spec as a tuple padded to ``nd`` entries, each
    None, a name or a tuple of names."""
    parts = [None if p is None else (p if isinstance(p, str) else tuple(p))
             for p in tuple(spec)]
    if nd is not None:
        parts += [None] * (nd - len(parts))
    return tuple(parts)


def _ref_flat(tree, prefix=()):
    """Reference spec / shape tree -> {path tuple: leaf}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]:
        out[tuple(str(getattr(p, "key", getattr(p, "name", p)))
                  for p in path)] = leaf
    return out


@functools.lru_cache(maxsize=None)
def _ref_state_shapes(arch):
    cfg = jax_get_config(arch)
    tcfg = JTrainConfig(steps=1000, batch_size=8, seq_len=64)
    return jax.eval_shape(
        lambda k: jtrainer.init_state(k, cfg, tcfg, moment_dtype=jnp.float32),
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_state_like(arch):
    cfg = get_config(arch)
    return trainer.state_for(tf.Transformer(cfg, tf.torch_dtype(cfg.dtype),
                                            "meta"))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    port = tf.param_specs(cfg)
    ref = _ref_flat(jtf.param_specs(jcfg))
    for name, spec in port.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            r = ref[("blocks",) + tuple(parts[2:])]
            assert _norm(r)[0] is None
            assert _norm(spec) == _norm(r)[1:], name
        else:
            assert _norm(spec) == _norm(ref[tuple(parts)]), name
    assert _norm(cal.projector_specs()["u"]) == (None, None, None)


def _check_state_specs(arch, mesh_shape, strategy):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jmesh, pmesh = _jmesh(mesh_shape), _pmesh(mesh_shape)
    rshapes = _ref_state_shapes(arch)
    ref = jsp.train_state_pspecs(jcfg, None, jmesh, rshapes,
                                 strategy=strategy)
    like = _port_state_like(arch)
    port = sp.train_state_pspecs(cfg, TrainConfig(), pmesh, like,
                                 strategy=strategy)
    pshapes = {k: tuple(p.shape) for k, p in like["params"].named_parameters()}
    n_layer_axis = 0
    rflat = _ref_flat(ref["params"])
    for name, pspec in port["params"].items():
        parts = name.split(".")
        nd = len(pshapes[name])
        if parts[0] != "blocks":
            assert _norm(pspec, nd) == _norm(rflat[tuple(parts)], nd), name
            continue
        r = _norm(rflat[("blocks",) + tuple(parts[2:])], nd + 1)
        # where the reference's FSDP took the stacked layer axis, the
        # port's per-layer leaf is replicated over that axis
        n_layer_axis += r[0] is not None
        assert _norm(pspec, nd) == r[1:], (name, pspec, r)
    assert port["opt"]["mu"] is port["params"]
    assert _norm(port["opt"]["count"]) == ()
    assert ("master" in port["opt"]) == ("master" in ref["opt"])
    return n_layer_axis


@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("strategy", ["tp_sp", "fsdp", "ep_dp"])
def test_train_state_pspecs_match_reference(strategy, mesh_shape):
    n_layer_axis = sum(_check_state_specs(arch, mesh_shape, strategy)
                       for arch in ARCHS)
    assert n_layer_axis > 0


@pytest.mark.parametrize("mesh_shape", list(MESHES))
def test_rules_and_serve_specs_match_reference(mesh_shape):
    jmesh, pmesh = _jmesh(mesh_shape), _pmesh(mesh_shape)
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for name, shp in SHAPES.items():
            jshp = JSHAPES[name]
            jmc = JMeshConfig(shape=mesh_shape, axis_names=MESHES[mesh_shape])
            for strategy in ("tp_sp", "fsdp", "ep_dp"):
                assert sp.train_rules(cfg, shp, pmesh, pmesh, strategy) \
                    == jsp.train_rules(jcfg, jshp, jmesh, jmc, strategy)
            rules = sh.default_rules(pmesh, shp)
            for mode in ("local", "global", None):
                assert sp.decode_n_groups(
                    pmesh, rules, shp.seq_len, mode,
                    sp.sals_for_shape(cfg, shp)) == jsp.decode_n_groups(
                    jmesh, rules, jshp.seq_len, mode,
                    jsp.sals_for_shape(jcfg, jshp))
        rshapes = _ref_state_shapes(arch)["params"]
        ref = _ref_flat(jsp.serve_param_pspecs(jcfg, rshapes, jmesh))
        like = _port_state_like(arch)["params"]
        port = sp.serve_param_pspecs(cfg, like, pmesh)
        shapes = {k: tuple(p.shape) for k, p in like.named_parameters()}
        for name, pspec in port.items():
            parts = name.split(".")
            nd = len(shapes[name])
            if parts[0] == "blocks":
                r = _norm(ref[("blocks",) + tuple(parts[2:])], nd + 1)
                assert _norm(pspec, nd) == r[1:], (arch, name)
            else:
                assert _norm(pspec, nd) == _norm(ref[tuple(parts)], nd), name


@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_default_rules_match_reference(shape_name, mesh_shape):
    for seq_parallel in (True, False):
        pm = _pmesh(mesh_shape, seq_parallel=seq_parallel)
        jm = JMeshConfig(shape=mesh_shape, axis_names=MESHES[mesh_shape],
                         seq_parallel=seq_parallel)
        assert sh.default_rules(pm, SHAPES[shape_name]) \
            == jsh.default_rules(jm, JSHAPES[shape_name])
    assert sh.default_rules(_pmesh(mesh_shape)) \
        == jsh.default_rules(JMeshConfig(shape=mesh_shape,
                                          axis_names=MESHES[mesh_shape]))


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_inputs_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shp in SHAPES.items():
        jshp = JSHAPES[name]
        a, b = sp.sals_for_shape(cfg, shp), jsp.sals_for_shape(jcfg, jshp)
        assert (a is None) == (b is None)
        if a is not None:
            import dataclasses
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert sp.cell_status(cfg, shp) == jsp.cell_status(jcfg, jshp)
        if not sp.cell_status(cfg, shp)[0]:
            continue
        port, ref = sp.input_specs(cfg, shp), jsp.input_specs(jcfg, jshp)
        assert set(port) == set(ref)
        for k in ref:
            assert tuple(port[k].shape) == tuple(ref[k].shape)
            assert str(port[k].dtype).split(".")[-1] == str(ref[k].dtype)
        rules = sh.default_rules(_pmesh((16, 16)), shp)
        assert {k: _norm(v) for k, v in
                sp.batch_pspecs(cfg, shp, rules).items()} == \
            {k: _norm(v) for k, v in jsp.batch_pspecs(jcfg, jshp,
                                                       rules).items()}


CACHE_CASES = {
    "dense": ("yi-9b", dict(skip_layers_front=1, skip_layers_back=1), 1),
    "grouped": ("yi-9b", dict(skip_layers_front=1, skip_layers_back=1), 4),
    "hybrid": ("hymba-1.5b", dict(skip_layers_front=1, skip_layers_back=0),
               2),
    "ssm": ("rwkv6-7b", {}, 1),
}


@pytest.mark.parametrize("kind", list(CACHE_CASES))
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_pspecs_match_reference(kind, shape_name):
    arch, over, g = CACHE_CASES[kind]
    cfg = get_config(arch).reduced(n_layers=4)
    jcfg = jax_get_config(arch).reduced(n_layers=4)
    kw = dict(n_critical=8, v_group=32, **over)
    shapes = jax.eval_shape(lambda: jtf.init_cache(
        jcfg, JSALSConfig(**kw), 2, 64, jnp.float32, g))
    port_cache = tf.init_cache(cfg, SALSConfig(**kw), 2, 64, torch.float32,
                               g, device="meta")
    for mesh_shape in MESHES:
        rules = sh.default_rules(_pmesh(mesh_shape), SHAPES[shape_name])
        ref = _ref_flat(jsp.cache_pspecs(shapes, rules))
        port = sp.cache_pspecs(port_cache, rules)
        flat = {}

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    flat[path + (k,)] = v
        walk(port, ())
        assert set(flat) == set(ref), set(flat) ^ set(ref)
        for k in ref:
            assert _norm(flat[k]) == _norm(ref[k]), (k, flat[k], ref[k])


# ---------------------------------------------------------------------------
# The reference's tests/test_sharding_specs.py cases
# ---------------------------------------------------------------------------

MESH_24 = MeshConfig(shape=(2, 4), axis_names=("data", "model"))


@pytest.mark.parametrize("case", [
    ("sanitize", P("model", None), (49155, 4096), P(None, None)),
    ("sanitize", P(None, "model"), (49155, 4096), P(None, "model")),
    ("sanitize", P(("data", "model"), None), (6, 128), P("data", None)),
    ("fsdp", P(None, "model"), (512, 64), P("data", "model"), "data"),
    ("fsdp", P(None, None), (64, 16), P(("data", "model"), None),
     ("data", "model")),
    ("fsdp", P("model", None), (8, 16), P("model", "data"),
     ("data", "model")),
], ids=["drops_nondivisible", "keeps_divisible", "composite_prefix",
        "largest_free_dim", "composite_axes", "skips_used_axes"])
def test_reference_spec_cases(case):
    kind, spec, shape, want = case[:4]
    jmesh = _jmesh((2, 4))
    jshape = jax.ShapeDtypeStruct(shape, jnp.float32)
    jspec = JP(*spec)
    if kind == "sanitize":
        got = sh.sanitize_pspecs(spec, shape, MESH_24)
        ref = jsh.sanitize_pspecs(jspec, jshape, jmesh)
    else:
        got = sh.fsdp_specs({"w": spec}, {"w": shape}, MESH_24, case[4])["w"]
        ref = jsh.fsdp_specs({"w": jspec}, {"w": jshape}, jmesh,
                             case[4])["w"]
    assert got == want
    assert _norm(got) == _norm(ref, len(shape))


def test_decode_rules_replicate_heads():
    rules = sh.default_rules(MESH_24, ShapeConfig("d", "decode", 256, 8))
    assert rules["heads"] is None
    assert rules["kv_seq"] == "model"
    rules_long = sh.default_rules(MESH_24, ShapeConfig("l", "decode", 512, 1))
    assert rules_long["batch"] is None
    assert rules_long["kv_seq"] == ("data", "model")


def test_cache_pspecs_by_leaf_name():
    cfg = get_config("yi-9b").reduced()
    sals = SALSConfig(n_critical=8, v_group=32, skip_layers_front=1,
                      skip_layers_back=1)
    cache = tf.init_cache(cfg, sals, 2, 64, torch.float32, device="meta")
    rules = sh.default_rules(MESH_24, ShapeConfig("d", "decode", 64, 8))
    specs = sp.cache_pspecs(cache, rules)
    assert specs["seg1"]["k_lat"] == P(None, "data", "model", None)
    assert specs["seg1"]["sink_k"] == P(None, "data", None, None, None)
    assert specs["seg0"]["k"][2] == "model"   # skip-layer cache seq-sharded


def test_prefill_and_decode_cache_trees_match():
    """The prefill step's output cache has the decode step's structure and
    placements (the grouped layout's n_groups included)."""
    cfg = get_config("yi-9b").reduced(n_layers=6)
    mc = MeshConfig(shape=(2, 4), axis_names=("data", "model"),
                    dist_mode="local")
    pf = sp.build_prefill(cfg, ShapeConfig("p", "prefill", 64, 8), mc, mc)
    dc = sp.build_decode(cfg, ShapeConfig("d", "decode", 64, 8), mc, mc)
    pf_cache_pl = pf[3][1]
    assert pf_cache_pl == dc[2][2] == dc[3][1]
    assert dc[1][2]["seg1"].n_groups == 4
    assert pf_cache_pl["seg1"]["k_lat"] == (Shard(1), Shard(2))


def test_sals_for_shape_scaling():
    cfg = get_config("yi-9b")
    s4k = sp.sals_for_shape(cfg, ShapeConfig("t", "decode", 4096, 8))
    s32k = sp.sals_for_shape(cfg, ShapeConfig("t", "decode", 32768, 8))
    s500k = sp.sals_for_shape(cfg, ShapeConfig("t", "decode", 524288, 1))
    assert s4k.n_critical == 432 and s4k.n_recent == 64
    assert s32k.n_critical == 1024
    assert s500k.n_critical == 2048
    assert sp.sals_for_shape(get_config("rwkv6-7b"),
                             ShapeConfig("t", "decode", 4096, 8)) is None


def test_cell_status_skips():
    hubert = get_config("hubert-xlarge")
    ok, reason = sp.cell_status(hubert, ShapeConfig("d", "decode", 256, 8))
    assert not ok and "encoder" in reason
    assert sp.cell_status(hubert, ShapeConfig("t", "train", 256, 8))[0]


# ---------------------------------------------------------------------------
# tree_shardings: specs -> DTensor placements
# ---------------------------------------------------------------------------

def test_tree_shardings_placements():
    m3 = _pmesh((2, 16, 16))
    got = sh.tree_shardings(m3, {
        "w": P(("data", "model"), None), "b": P(None, "model"),
        "all": P(("pod", "data", "model")), "rep": P(None, None),
        "mix": P("model", ("pod", "data"))})
    assert got["w"] == (Replicate(), Shard(0), Shard(0))
    assert got["b"] == (Replicate(), Replicate(), Shard(1))
    assert got["all"] == (Shard(0), Shard(0), Shard(0))
    assert got["rep"] == (Replicate(),) * 3
    assert got["mix"] == (Shard(1), Shard(1), Shard(0))


@pytest.mark.parametrize("bad", [P(("model", "data")), P("data", "data"),
                                 P("nope")])
def test_tree_shardings_rejects_bad_specs(bad):
    with pytest.raises(ValueError):
        sh.tree_shardings(MESH_24, {"w": bad})


def test_constrain_is_identity_without_context():
    x = torch.ones(2, 3)
    assert sh.constrain(x, ("batch", "embed")) is x
    with sh.use_sharding(None, sh.default_rules(MESH_24)):
        assert sh.constrain(x, ("batch", "embed")) is x    # plain tensor
        assert sh.logical_spec(("batch", "vocab")) == P("data", "model")
    assert sh.current_ctx() is None
    assert sh.logical_spec(("batch",)) == P(None)


# ---------------------------------------------------------------------------
# launch/mesh.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("dist_mode,seq_parallel",
                         [("local", True), ("global", False)])
def test_make_mesh_config_matches_reference(multi_pod, dist_mode,
                                            seq_parallel):
    import dataclasses
    got = pmesh_mod.make_mesh_config(multi_pod=multi_pod, dist_mode=dist_mode,
                                     seq_parallel=seq_parallel)
    want = jmesh_mod.make_mesh_config(multi_pod=multi_pod,
                                      dist_mode=dist_mode,
                                      seq_parallel=seq_parallel)
    got_d, want_d = dataclasses.asdict(got), dataclasses.asdict(want)
    # the reference's pipeline_stages and remat are read nowhere in its
    # sharding layer (remat is build_train's argument); the port has
    # neither field
    assert set(want_d) - set(got_d) == {"pipeline_stages", "remat"}
    assert got_d == {k: want_d[k] for k in got_d}
    assert got.n_devices == (512 if multi_pod else 256)
    assert got.data_axes == want.data_axes and got.model_axis == "model"


@pytest.mark.parametrize("multi_pod,need", [(False, 256), (True, 512)])
def test_make_production_mesh_names_the_world_it_needs(multi_pod, need):
    with pytest.raises(ValueError, match=str(need)):
        pmesh_mod.make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_make_host_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        pmesh_mod.make_host_mesh(device="cpu")
