from repro_torch.analysis.hlo_cost import CostReport, analyze_step
from repro_torch.analysis.roofline import RooflineReport, roofline

__all__ = ["CostReport", "RooflineReport", "analyze_step", "roofline"]
