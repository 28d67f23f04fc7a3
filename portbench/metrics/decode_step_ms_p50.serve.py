"""Median host duration of the port's ``decode_step`` spans (one replayed
decode step of the arena, ending in the host read of its tokens), ms."""
import statistics


def read(ctx, out):
    d = [(t1 - t0) * 1e3 for name, t0, t1, _ in out.data.get("spans", [])
         if name == "decode_step"]
    return statistics.median(d) if d else None
