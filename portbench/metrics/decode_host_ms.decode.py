"""Median host time from the call of ``ServeEngine.decode`` to its return
(before the sampling and the host read that wait for the device), ms:
the host's own cost of a replayed step."""
import statistics


def read(ctx, out):
    d = out.data.get("decode_call_s")
    return statistics.median(d) * 1e3 if d else None
