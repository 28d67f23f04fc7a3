"""Median host ms a call of the port's ``decode`` step program spends on
the graph's key (``serve/step_graph.py``'s ``_signature``: every
parameter, projector and cache tensor), over the window's calls before
the profiled slice (the program's own counters)."""
import statistics

from portbench.yardstick import programs


def read(ctx, out):
    calls = programs.before_profile(ctx, out, "decode")
    return statistics.median(r["key_s"] for r in calls) * 1e3 \
        if calls else None
