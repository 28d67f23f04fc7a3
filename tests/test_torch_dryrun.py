"""The port's dry-run (``repro_torch.launch.dryrun``) and grid runner
(``repro_torch.launch.rungrid``) on a fake process group, held to the
reference's records, skip rules and ``model_flops_for``.

Each run is a subprocess under its own timeout (a process group is
process-global), writing its records into ``tmp_path``:

* ``--arch qwen2-1.5b --shape decode_32k``: status ``ok`` on 256 ranks,
  ``collective_bytes > 0``, ``model_flops`` equal to the reference's
  ``model_flops_for``, 0 < ``useful_ratio`` <= 1.05, exit 0;
* ``--arch hubert-xlarge --shape decode_32k``: ``skipped`` with the
  reference's ``cell_status`` reason, exit 0;
* the record's keys are the reference's (read from its ``run_cell``
  source, which this test does not import: the module sets ``XLA_FLAGS``
  on import) but for the differences the port's docstring lists;
* ``rungrid`` over qwen2-1.5b × decode_32k × {single, multi} writes both
  records and exits 0, and ``--retry-failed`` then runs 0 cells;
* a head split over more ranks than divide the heads (12 over 16, on a
  fake 16-rank group), forward and in the head merge's backward.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest

from repro.analysis.roofline import model_flops_for
from repro.config import SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch.specs import cell_status

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 180
# the port's record differs from the reference's here (its docstring)
RENAMED = {"lower_s": "run_s", "compile_s": "run_s",
           "xla_cost_analysis": "cost", "hlo_path": "ops_path"}


def _run(args, out: Path) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", *args, "--out", str(out)],
                          capture_output=True, text=True, timeout=TIMEOUT,
                          env=env, cwd=str(out.parent))


def _record_keys(path: Path) -> set:
    """Every key ``run_cell`` writes into ``record`` (its dict literal and
    its ``record["k"] = ...`` assignments)."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.AnnAssign) and isinstance(n.value, ast.Dict):
            keys |= {k.value for k in n.value.keys}
        if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store) \
                and getattr(n.value, "id", None) == "record":
            keys.add(n.slice.value)
    return keys


@pytest.fixture(scope="module")
def qwen2_decode(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "records"
    proc = _run(["repro_torch.launch.dryrun", "--arch", "qwen2-1.5b",
                 "--shape", "decode_32k"], out)
    return proc, out


def test_qwen2_decode_cell_ok(qwen2_decode):
    proc, out = qwen2_decode
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    rec = json.loads((out / "qwen2-1.5b.decode_32k.pod16x16.json")
                     .read_text())
    assert rec["status"] == "ok", rec.get("error")
    r = rec["roofline"]
    assert r["chips"] == 256 and r["mesh"] == "pod16x16"
    assert r["collective_bytes"] > 0 and r["hlo_flops"] > 0
    want = model_flops_for(jax_get_config("qwen2-1.5b"), SHAPES["decode_32k"])
    assert rec["model_flops"] == pytest.approx(want, rel=1e-12)
    assert r["model_flops"] == rec["model_flops"]
    assert 0 < r["useful_ratio"] <= 1.05
    mem = rec["memory_analysis"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["argument_bytes"] > 0
    assert "[dryrun] qwen2-1.5b × decode_32k × pod16x16: OK" in proc.stdout


def test_record_keys_are_the_reference_keys(qwen2_decode):
    ref = _record_keys(ROOT / "src/repro/launch/dryrun.py")
    port = _record_keys(ROOT / "src/repro_torch/launch/dryrun.py")
    assert port == {RENAMED.get(k, k) for k in ref}
    _, out = qwen2_decode
    rec = json.loads((out / "qwen2-1.5b.decode_32k.pod16x16.json")
                     .read_text())
    ok_ref = ref - {"reason", "strategy", "error", "traceback", "hlo_path"}
    assert set(rec) == {RENAMED.get(k, k) for k in ok_ref}


def test_encoder_decode_cell_skipped(tmp_path):
    out = tmp_path / "records"
    proc = _run(["repro_torch.launch.dryrun", "--arch", "hubert-xlarge",
                 "--shape", "decode_32k"], out)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads((out / "hubert-xlarge.decode_32k.pod16x16.json")
                     .read_text())
    ok, reason = cell_status(jax_get_config("hubert-xlarge"),
                             SHAPES["decode_32k"])
    assert not ok
    assert rec["status"] == "skipped" and rec["reason"] == reason
    assert "SKIPPED" in proc.stdout


def test_rungrid_writes_records_and_retries_none(tmp_path):
    out = tmp_path / "records"
    args = ["repro_torch.launch.rungrid", "--archs", "qwen2-1.5b",
            "--shapes", "decode_32k", "--meshes", "single,multi",
            "--jobs", "2"]
    proc = _run(args, out)
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert "[rungrid] 2 cells" in proc.stdout
    for mesh in ("pod16x16", "pod2x16x16"):
        rec = json.loads((out / f"qwen2-1.5b.decode_32k.{mesh}.json")
                         .read_text())
        assert rec["status"] == "ok"
    assert json.loads((out / "qwen2-1.5b.decode_32k.pod2x16x16.json")
                      .read_text())["roofline"]["chips"] == 512
    again = _run(args + ["--retry-failed"], out)
    assert again.returncode == 0
    assert "[rungrid] 0 cells" in again.stdout


UNEVEN_HEADS = """
    import json, torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models.attention import _MergeHeads, _heads
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    mesh = init_device_mesh("cpu", (1, 16), mesh_dim_names=("data", "model"))
    # 12 heads of dh 8, the flat projection split 16 ways along H·dh
    flat = DTensor.from_local(torch.empty(2, 4, 6, device="meta"), mesh,
                              [Replicate(), Shard(2)], run_check=False)
    try:
        flat.reshape(2, 4, 12, 8)
        plain_split = "ok"
    except RuntimeError as e:
        plain_split = str(e).splitlines()[0]
    q = _heads(flat, 12, 8)
    # the merge's gradient comes back split along H·dh by the wo matmul
    h = DTensor.from_local(torch.empty(2, 4, 12, 8, device="meta"), mesh,
                           [Replicate(), Replicate()], run_check=False)
    h.requires_grad_(True)
    wo = DTensor.from_local(torch.empty(6, 32, device="meta"), mesh,
                            [Replicate(), Shard(0)], run_check=False)
    out = _MergeHeads.apply(h) @ wo
    g, = torch.autograd.grad(out.sum(), [h])
    try:
        gp, = torch.autograd.grad((h.reshape(2, 4, 96) @ wo).sum(), [h])
        plain_grad = "ok"
    except RuntimeError as e:
        plain_grad = str(e).splitlines()[0]
    print(json.dumps({"q": list(q.shape), "g": list(g.shape),
                      "plain_split": plain_split, "plain_grad": plain_grad}))
    dist.destroy_process_group()
"""


def test_uneven_head_split_on_a_16_wide_model_axis():
    """qwen2-1.5b's 12 heads over the production mesh's 16-wide model
    axis: DTensor refuses to view the split projection as heads, forward
    and in the backward of the head merge; ``attention._heads`` and
    ``_MergeHeads`` make the split dim whole first."""
    import textwrap
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c",
                           textwrap.dedent(UNEVEN_HEADS)],
                          capture_output=True, text=True, timeout=TIMEOUT,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["q"] == [2, 4, 12, 8] and got["g"] == [2, 4, 12, 8]
    assert "unevenly" in got["plain_split"]
    assert "unevenly" in got["plain_grad"]
