"""Median wait of a request from its due time to its first prefill chunk
(the port's ``prefill_chunk`` spans, which name the request), ms."""
import statistics


def read(ctx, out):
    first = {}
    for name, t0, _, args in out.data.get("spans", []):
        if name == "prefill_chunk" and "req" in args:
            first[args["req"]] = min(t0, first.get(args["req"], t0))
    waits = [(first[r["id"]] - r["due"]) * 1e3
             for r in out.data.get("requests", [])
             if r["counted"] and r["id"] in first]
    return statistics.median(waits) if waits else None
