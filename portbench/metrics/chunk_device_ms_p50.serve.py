"""Median device ms of a replay of the port's ``prefill_chunk`` step
program (one 64-token chunk over the request's history) begun in the
window, from the program's own timing events; none on the CPU."""
import statistics

from portbench.yardstick import programs


def read(ctx, out):
    d = out.data
    calls = programs.records("prefill_chunk", device=True, t0=d.get("t0"),
                             t1=d.get("t_end"))
    return statistics.median(r["device_s"] for r in calls) * 1e3 \
        if calls else None
