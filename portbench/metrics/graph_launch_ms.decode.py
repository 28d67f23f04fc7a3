"""Median host ms a call of the port's ``decode`` step program spends
staging its inputs (the wait on the previous call's staging included)
and replaying its CUDA graph, over the window's calls before the
profiled slice (the program's own counters)."""
import statistics

from portbench.yardstick import programs


def read(ctx, out):
    calls = programs.before_profile(ctx, out, "decode")
    return statistics.median(r["stage_s"] + r["launch_s"]
                             for r in calls) * 1e3 if calls else None
