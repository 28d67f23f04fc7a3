"""Median device ms of a replay of the port's ``decode`` step program:
the program's own timing events just before and after ``graph.replay()``
on the stream, over the window's replays; none on the CPU."""
import statistics

from portbench.yardstick import programs


def read(ctx, out):
    win = programs.window(out, "decode")
    calls = programs.records("decode", device=True, t0=win[0]["t"]) \
        if win else []
    return statistics.median(r["device_s"] for r in calls) * 1e3 \
        if calls else None
