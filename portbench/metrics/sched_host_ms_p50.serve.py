"""Median host ms of the scheduler's own work in an iteration that ran a
decode step: the port's ``sweep``, ``admit``, ``page_upkeep`` and
``decode_commit`` spans of the iteration (their ``it``), summed (its
reads, chunk and step programs and client callback left out)."""
import statistics
from collections import defaultdict

HOST = ("sweep", "admit", "page_upkeep", "decode_commit")


def read(ctx, out):
    host, decoded = defaultdict(float), set()
    for name, t0, t1, args in out.data.get("spans", []):
        if name in HOST and "it" in args:
            host[args["it"]] += t1 - t0
            if name == "decode_commit":
                decoded.add(args["it"])
    ms = [host[i] * 1e3 for i in decoded]
    return statistics.median(ms) if ms else None
