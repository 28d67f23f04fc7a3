"""The whole decode step's share of the card's bf16 peak, %: model FLOPs
of every step in the window (``yardstick/flops.py``) over the window's
wall time times 989 TFLOP/s, the traced steps and the profiler's start
and stop left out of both."""
from portbench.yardstick.peaks import PEAK_BF16_FLOPS


def read(ctx, out):
    d = out.data
    if not d.get("model_flops") or not d.get("model_seconds"):
        return None
    return 100.0 * d["model_flops"] / (d["model_seconds"] * PEAK_BF16_FLOPS)
