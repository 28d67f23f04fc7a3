"""The port's step cost counter (``analysis.analyze_step``) and roofline
(``analysis.roofline``) held to the reference's HLO walker
(``repro.analysis.hlo_cost.analyze_hlo``) and roofline on the same
programs — the reference's ``tests/test_analysis.py`` cases:

* a 128×512 @ 512×64 matmul: exactly 2·M·N·K flops in both;
* ten 256³ products: the port's loop and the reference's ``scan`` each
  within 5% of 2·256³·10;
* ``a * 2 + 1`` on 1024² f32: the port counts exactly 4 × 4 MiB (two
  eager ops, each reading and writing 4 MiB), the reference's fused figure
  lies in its own [4e6, 4e7];
* ``model_flops_for`` equal to the reference's for every config of
  ``ASSIGNED_ARCHS + PAPER_ARCHS`` × ``SHAPES`` (1e-12 relative);
* ``roofline`` gives the reference's terms from the same cost numbers,
  scaled by the two packages' constants;
* collective bytes: the reference's walker on a ``psum`` of a (1024, 1024)
  f32 over 4 XLA CPU devices equals the port's count of an ``all_reduce``
  of the same tensor on a fake 4-rank process group: 8 MiB;
* a fully sharded matmul on a fake (2, 2) mesh counts the local product's
  flops (``FlopCounterMode`` would count the global op's).

The process groups live in subprocesses: a group is process-global.
"""
import importlib
import json
import os
import subprocess
import sys
import textwrap

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis.hlo_cost import analyze_hlo
from repro.config import SHAPES as JSHAPES
from repro.configs import ASSIGNED_ARCHS, PAPER_ARCHS
from repro.configs import get_config as jax_get_config
from repro_torch.analysis import CostReport, analyze_step, roofline
from repro_torch.config import SHAPES
from repro_torch.configs import get_config

# the modules (each package's __init__ exports a function of this name)
jroof = importlib.import_module("repro.analysis.roofline")
proof = importlib.import_module("repro_torch.analysis.roofline")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _hlo(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


def _run(code: str, env_extra=None) -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1", **(env_extra or {})}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=TIMEOUT,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_matmul_flops_exact_in_both():
    want = 2 * 128 * 512 * 64
    ref = analyze_hlo(_hlo(lambda a, b: a @ b, jnp.ones((128, 512)),
                           jnp.ones((512, 64))))
    rep, _ = analyze_step(lambda a, b: a @ b, torch.ones(128, 512),
                          torch.ones(512, 64))
    assert ref.flops == want and rep.flops == want


def test_ten_products_loop_and_scan():
    want = 2 * 256 ** 3 * 10

    def scanned(x, w):
        def body(c, _):
            return c @ w, None
        return jax.lax.scan(body, x, None, length=10)[0]

    def loop(x, w):
        for _ in range(10):
            x = x @ w
        return x

    ones = jnp.ones((256, 256), jnp.float32)
    ref = analyze_hlo(_hlo(scanned, ones, ones)).flops
    rep, _ = analyze_step(loop, torch.ones(256, 256), torch.ones(256, 256))
    assert abs(ref - want) / want < 0.05
    assert abs(rep.flops - want) / want < 0.05


def test_elementwise_bytes():
    ref = analyze_hlo(_hlo(lambda a: a * 2.0 + 1.0,
                           jnp.ones((1024, 1024), jnp.float32)))
    rep, _ = analyze_step(lambda a: a * 2 + 1, torch.ones(1024, 1024))
    assert 4e6 <= ref.bytes_accessed <= 4e7
    assert rep.bytes_accessed == 4 * 4 * 2 ** 20
    assert rep.ops == {"aten.mul": [1, 0.0, 8 * 2 ** 20],
                       "aten.add": [1, 0.0, 8 * 2 ** 20]}
    # 4 MiB argument, a 4 MiB temporary live beside the 4 MiB output
    assert rep.memory == {"argument_bytes": 4 * 2 ** 20,
                          "output_bytes": 4 * 2 ** 20,
                          "temp_bytes": 8 * 2 ** 20,
                          "peak_bytes": 12 * 2 ** 20}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + PAPER_ARCHS)
def test_model_flops_for_matches_reference(arch):
    for name, shape in SHAPES.items():
        want = jroof.model_flops_for(jax_get_config(arch), JSHAPES[name])
        got = proof.model_flops_for(get_config(arch), shape)
        assert abs(got - want) <= 1e-12 * abs(want), (arch, name)


def test_roofline_terms_match_reference():
    x = jnp.ones((256, 512), jnp.float32)
    text = _hlo(lambda a: jnp.tanh(a @ a.T) * 3.0, x)
    ref_cost = analyze_hlo(text)
    for arch, shape in (("yi-9b", "train_4k"), ("qwen2-1.5b", "decode_32k")):
        ref = jroof.roofline(arch, jax_get_config(arch), JSHAPES[shape],
                             "pod16x16", 256, text, peak_bytes=123.0)
        cost = CostReport(flops=ref_cost.flops,
                          bytes_accessed=ref_cost.bytes_accessed,
                          collective_bytes=5e6,
                          collective_breakdown={"all-reduce": 5e6})
        got = roofline(arch, get_config(arch), SHAPES[shape], "pod16x16",
                       256, cost, peak_bytes=123.0)
        assert got.hlo_flops == ref.hlo_flops
        assert got.hlo_bytes == ref.hlo_bytes
        assert got.t_compute * proof.PEAK_FLOPS == pytest.approx(
            ref.t_compute * jroof.PEAK_FLOPS, rel=1e-12)
        assert got.t_memory * proof.HBM_BW == pytest.approx(
            ref.t_memory * jroof.HBM_BW, rel=1e-12)
        assert got.t_collective * proof.LINK_BW == pytest.approx(
            5e6, rel=1e-12)
        assert got.model_flops == pytest.approx(ref.model_flops, rel=1e-12)
        assert got.useful_ratio == pytest.approx(ref.useful_ratio,
                                                 rel=1e-12)
        assert got.peak_bytes_per_dev == 123.0
        terms = {"compute": got.t_compute, "memory": got.t_memory,
                 "collective": got.t_collective}
        assert got.bound == max(terms, key=terms.get)
        assert got.step_seconds == max(terms.values())
        assert got.mfu == pytest.approx(got.model_flops / (
            got.step_seconds * 256 * proof.PEAK_FLOPS))
        j = got.to_json()
        assert set(j) == set(ref.to_json())


FAKE_GROUP = """
    import json, torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis import analyze_step
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    t = torch.empty(1024, 1024, device="meta")
    ar, _ = analyze_step(lambda t: funcol.all_reduce(t, "sum",
                                                     dist.group.WORLD), t)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    a = DTensor.from_local(torch.empty(32, 512, device="meta"), mesh,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(512, 128, device="meta"), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    mm, out = analyze_step(lambda a, w: a @ w, a, w)
    with FlopCounterMode(display=False) as fc:
        a @ w
    print(json.dumps({"ar_bytes": ar.collective_bytes,
                      "ar_breakdown": ar.collective_breakdown,
                      "ar_counts": ar.collective_counts,
                      "mm_flops": mm.flops, "mm_coll": mm.collective_bytes,
                      "local_shape": list(out.to_local().shape),
                      "global_counter": fc.get_total_flops()}))
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def fake_group():
    return _run(FAKE_GROUP)


def test_all_reduce_bytes_match_reference_psum(fake_group):
    ref = _run("""
        import json
        import jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from repro.analysis.hlo_cost import analyze_hlo
        mesh = jax.make_mesh((4,), ("x",))
        f = jax.shard_map(lambda a: jax.lax.psum(a, "x"), mesh=mesh,
                          in_specs=P(), out_specs=P())
        rep = analyze_hlo(jax.jit(f).lower(
            jnp.ones((1024, 1024), jnp.float32)).compile().as_text())
        print(json.dumps({"bytes": rep.collective_bytes,
                          "breakdown": rep.collective_breakdown}))
    """, {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
          "JAX_PLATFORMS": "cpu"})
    assert ref["bytes"] == 8 * 2 ** 20
    assert fake_group["ar_bytes"] == ref["bytes"]
    assert fake_group["ar_breakdown"] == ref["breakdown"]
    assert fake_group["ar_counts"] == {"all-reduce": 1}


def test_sharded_matmul_counts_local_product(fake_group):
    # a (64, 512) Shard(0) over data x W (512, 256) Shard(1) over model:
    # each rank multiplies (32, 512) by (512, 128), no collective
    assert fake_group["mm_flops"] == 2 * 32 * 512 * 128
    assert fake_group["global_counter"] == 2 * 64 * 512 * 256
    assert fake_group["local_shape"] == [32, 128]
    assert fake_group["mm_coll"] == 0
