"""Median device ms of a replay of the port's ``decode`` step program (one
step of the whole paged arena) begun in the window, from the program's
own timing events; none on the CPU."""
import statistics

from portbench.yardstick import programs


def read(ctx, out):
    d = out.data
    calls = programs.records("decode", device=True, t0=d.get("t0"),
                             t1=d.get("t_end"))
    return statistics.median(r["device_s"] for r in calls) * 1e3 \
        if calls else None
