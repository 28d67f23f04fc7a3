"""Multi-pod dry-run (port of ``repro/launch/dryrun.py``): run one step of
an (arch × shape) cell on the production mesh, on meta tensors, and record
its per-device cost, memory and roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape decode_32k [--multi-pod] [--out artifacts/dryrun_torch]

No card is touched.  ``run_cell`` starts a process group with PyTorch's
``fake`` backend (``FakeStore``: every collective returns at once) at
world 256 — 512 with ``--multi-pod`` — as rank 0, builds the production
``DeviceMesh`` over it on the CPU, places ``launch.specs.build_step``'s
stand-ins as DTensors over meta local blocks (each rank's block shapes,
no data, no collective), and runs the step once under
``analysis.hlo_cost.analyze_step``: the cost and memory are rank 0's, on
its local blocks, as the reference's are those of its partitioned module.

The record is the reference's, but where a quantity has no counterpart:

* ``lower_s`` / ``compile_s`` -> ``run_s``: nothing is lowered or
  compiled; the step runs once, eagerly;
* ``xla_cost_analysis`` -> ``cost``: the counter's totals (``flops``,
  ``bytes accessed``, ``collective bytes``), as the reference reports
  XLA's own analysis beside its walker's;
* ``--save-hlo`` writes the counted op table (op or kernel, calls, flops,
  bytes) to ``<cell>.ops.txt``, recorded as ``ops_path``, in place of
  the HLO text and ``hlo_path``.

A cell whose step raises records ``failed`` with the error (and exits
1); a cell ``launch.specs.cell_status`` rules out records ``skipped``.
The default ``--out`` is ``artifacts/dryrun_torch``, apart from the
reference's records.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from repro_torch.analysis.hlo_cost import analyze_step
from repro_torch.analysis.roofline import model_flops_for, roofline
from repro_torch.config import SHAPES
from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ARCHS, get_config
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_mesh_config, make_production_mesh

OUT = "artifacts/dryrun_torch"


def _start_fake_group(world: int) -> None:
    import torch.distributed as dist
    # importing fake_pg registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _placed_meta(args_like, in_placements, mesh):
    """``build_step``'s stand-ins as DTensors over meta local blocks."""
    from repro_torch.distributed.sharding import zeros_placed
    return tuple(zeros_placed(a, mesh, pl, "meta")
                 for a, pl in zip(args_like, in_placements))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: str = OUT, rank_ratio: float = 0.25,
             sals_enabled: bool = True, dist_mode: str = "local",
             seq_parallel: bool = True, microbatches: int = 1,
             remat: str = "block", save_hlo: bool = False,
             k_latent_dtype: str = "bfloat16", strategy: str = "tp_sp",
             tag: str = "") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "multi_pod": multi_pod, "sals": sals_enabled,
                    "rank_ratio": rank_ratio, "dist_mode": dist_mode,
                    "tag": tag}

    ok, reason = sp.cell_status(cfg, shape)
    if not ok:
        record["status"] = "skipped"
        record["reason"] = reason
        _write(out_dir, record, tag)
        return record

    import torch
    import torch.distributed as dist
    n_dev = 512 if multi_pod else 256
    _start_fake_group(n_dev)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        mesh_cfg = make_mesh_config(multi_pod=multi_pod, dist_mode=dist_mode,
                                    seq_parallel=seq_parallel)
        chips = mesh.size()

        kw: dict = {}
        if shape.kind == "train":
            if strategy == "auto":
                # fsdp wins for dense models whose batch covers the mesh;
                # MoE keeps EP + tp_sp; multi-pod (batch 256 < 512 ranks)
                # keeps tp_sp
                strategy = "fsdp" if (cfg.family != "moe"
                                      and shape.global_batch % n_dev == 0) \
                    else "tp_sp"
            kw = {"microbatches": microbatches, "remat": remat,
                  "strategy": strategy}
            record["strategy"] = strategy
        else:
            kw = {"rank_ratio": rank_ratio, "sals_enabled": sals_enabled,
                  "k_latent_dtype": k_latent_dtype}
            if shape.kind == "decode":
                kw["dist_mode"] = dist_mode

        t0 = time.time()
        try:
            fn, args_like, in_pl, _ = sp.build_step(
                shape.kind, cfg, shape, mesh, mesh_cfg, **kw)
            args = _placed_meta(args_like, in_pl, mesh)
            grad = torch.enable_grad() if shape.kind == "train" \
                else torch.no_grad()
            with grad:
                cost, _ = analyze_step(fn, *args)
        except Exception as e:  # noqa: BLE001 — a cell's failure is its record
            record["status"] = "failed"
            record["error"] = f"{type(e).__name__}: {e}"
            record["traceback"] = traceback.format_exc(limit=8)
            _write(out_dir, record, tag)
            return record
        t_run = time.time() - t0
    finally:
        dist.destroy_process_group()

    record["status"] = "ok"
    record["run_s"] = round(t_run, 1)
    record["cost"] = {"flops": cost.flops,
                      "bytes accessed": cost.bytes_accessed,
                      "collective bytes": cost.collective_bytes}
    record["memory_analysis"] = dict(cost.memory)
    peak = cost.memory["peak_bytes"]

    rep = roofline(arch, cfg, shape, mesh_name, chips, cost, peak)
    record["roofline"] = rep.to_json()
    record["model_flops"] = model_flops_for(cfg, shape)
    if save_hlo:
        opath = _path(out_dir, record, tag) + ".ops.txt"
        with open(opath, "w") as f:
            f.write("op\tcalls\tflops\tbytes\n")
            for name, (calls, flops, nbytes) in sorted(
                    cost.ops.items(), key=lambda kv: -kv[1][2]):
                f.write(f"{name}\t{calls}\t{flops:.6e}\t{nbytes:.6e}\n")
        record["ops_path"] = opath
    _write(out_dir, record, tag)
    return record


def _path(out_dir: str, record: dict, tag: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    t = f".{tag}" if tag else ""
    return os.path.join(out_dir, f"{record['arch']}.{record['shape']}."
                                 f"{record['mesh']}{t}")


def _write(out_dir: str, record: dict, tag: str) -> None:
    with open(_path(out_dir, record, tag) + ".json", "w") as f:
        json.dump(record, f, indent=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True,
                    choices=ASSIGNED_ARCHS + PAPER_ARCHS)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--rank-ratio", type=float, default=0.25)
    ap.add_argument("--no-sals", action="store_true",
                    help="baseline: full-attention decode, no compression")
    ap.add_argument("--dist-mode", default="local",
                    choices=("local", "global"))
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="block",
                    choices=("none", "block", "save_dots"))
    ap.add_argument("--strategy", default="auto",
                    choices=("auto", "tp_sp", "fsdp", "ep_dp"),
                    help="train parallelism: Megatron TP+SP or pure ZeRO-3")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write the counted op table (no HLO in eager "
                    "PyTorch)")
    ap.add_argument("--latent-int8", action="store_true",
                    help="beyond-paper: int8-quantized latent key cache")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   out_dir=args.out, rank_ratio=args.rank_ratio,
                   sals_enabled=not args.no_sals, dist_mode=args.dist_mode,
                   seq_parallel=not args.no_seq_parallel,
                   microbatches=args.microbatches, remat=args.remat,
                   save_hlo=args.save_hlo,
                   k_latent_dtype="int8" if args.latent_int8 else "bfloat16",
                   strategy=args.strategy, tag=args.tag)
    status = rec["status"]
    if status == "ok":
        r = rec["roofline"]
        mem = rec.get("memory_analysis", {})
        print(f"[dryrun] {rec['arch']} × {rec['shape']} × {rec['mesh']}: OK "
              f"(run {rec['run_s']}s)")
        print(f"  per-dev: flops={r['hlo_flops']:.3e} bytes={r['hlo_bytes']:.3e} "
              f"coll={r['collective_bytes']:.3e}")
        print(f"  terms(s): compute={r['t_compute']:.4f} "
              f"memory={r['t_memory']:.4f} collective={r['t_collective']:.4f}"
              f"  bound={r['bound']}  useful={r['useful_ratio']:.2f}")
        if mem:
            print(f"  memory_analysis: args={_gb(mem['argument_bytes'])} "
                  f"temps={_gb(mem['temp_bytes'])} "
                  f"peak≈{_gb(mem['peak_bytes'])} per device")
        return 0
    if status == "skipped":
        print(f"[dryrun] {rec['arch']} × {rec['shape']}: SKIPPED — "
              f"{rec['reason']}")
        return 0
    print(f"[dryrun] {rec['arch']} × {rec['shape']} × {rec['mesh']}: FAILED\n"
          f"{rec['error']}\n{rec.get('traceback', '')}")
    return 1


def _gb(x) -> str:
    return f"{x / 2**30:.2f}GiB" if x is not None else "?"


if __name__ == "__main__":
    sys.exit(main())
