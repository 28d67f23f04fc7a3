"""Three-term roofline model (port of ``repro/analysis/roofline.py``).

    compute    = flops_per_dev / peak_FLOPs
    memory     = bytes_per_dev / HBM_bw
    collective = wire_bytes_per_dev / link_bw

All three in seconds per step; the max is the bound.  The terms come from
``analysis/hlo_cost.py``'s count of one step's ops on each device's local
blocks.

Hardware constants: NVIDIA H100 SXM, from its data sheet (dense rates at
the 700 W limit) — 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32
outside them, 3.35 TB/s HBM3, and NVLink 4 at 450 GB/s per direction per
GPU.  ``LINK_BW`` is the rate inside one 8-GPU node.  On 8-GPU nodes the
production mesh's 16-wide ``model`` axis crosses a node boundary, where
the links are InfiniBand at about 50 GB/s per GPU: the collective term
is a lower bound.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

from repro_torch.analysis.hlo_cost import CostReport
from repro_torch.config import ModelConfig, ShapeConfig

PEAK_FLOPS = 989e12          # bf16 per GPU (tensor cores, dense)
F32_PEAK_FLOPS = 67e12       # f32 per GPU (outside the tensor cores)
HBM_BW = 3.35e12             # bytes/s per GPU
LINK_BW = 450e9              # bytes/s per GPU per direction (NVLink 4)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device per-step
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collective_breakdown: Dict[str, float]
    # terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    bound: str
    # usefulness
    model_flops: float           # global 6·N·D (or decode equivalent)
    useful_ratio: float          # model_flops / (hlo_flops × chips)
    unknown_trip_counts: int = 0
    peak_bytes_per_dev: Optional[float] = None

    @property
    def step_seconds(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step spent at the dominant term — how close the
        *other* terms are to free.  1.0 = perfectly overlapped single bound."""
        s = self.t_compute + self.t_memory + self.t_collective
        return self.step_seconds / s if s else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization bound implied by the roofline terms."""
        t = self.step_seconds
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * PEAK_FLOPS)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["step_seconds"] = self.step_seconds
        d["mfu"] = self.mfu
        return d


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful model FLOPs per step: 6·N·D train, 2·N·D prefill,
    2·N·B decode (N = active params)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    return 2.0 * n * shape.global_batch      # decode: one token per stream


def roofline(arch: str, cfg: ModelConfig, shape: ShapeConfig, mesh_name: str,
             chips: int, cost: CostReport,
             peak_bytes: Optional[float] = None) -> RooflineReport:
    t_c = cost.flops / PEAK_FLOPS
    t_m = cost.bytes_accessed / HBM_BW
    t_x = cost.collective_bytes / LINK_BW
    bound = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    mflops = model_flops_for(cfg, shape)
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes_accessed,
        collective_bytes=cost.collective_bytes,
        collective_breakdown=cost.collective_breakdown,
        t_compute=t_c, t_memory=t_m, t_collective=t_x, bound=bound,
        model_flops=mflops,
        useful_ratio=mflops / (cost.flops * chips) if cost.flops else 0.0,
        unknown_trip_counts=cost.unknown_trip_counts,
        peak_bytes_per_dev=peak_bytes,
    )


def save_report(path: str, rep: RooflineReport) -> None:
    with open(path, "w") as f:
        json.dump(rep.to_json(), f, indent=1)
