"""The knee of an open-loop cell: one set-up, then one window at each of
a few fixed rates through a fresh scheduler, on the card.  A rate is
sustained when the window's requests finish about as fast as they
arrive: the backlog (requests due but not yet started at the window's
close) stays small and the time to first token does not grow from the
window's first half to its second.  One JSON line a rate.

    python3 portbench/tools/knee.py --workload mistral.serve4k \\
        --rates 1,1.5,2,2.5,3 --seconds 30
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import bench, traffic  # noqa: E402
from portbench.drivers import open_loop  # noqa: E402


def summary(win: dict, seconds: float) -> dict:
    client, t0 = win["client"], win["t0"]
    rows = []
    for a, req, stamps, _ in client.reqs:
        if a.counted and req.done:
            rows.append((a.due_s, (stamps[0] - t0 - a.due_s) * 1e3))
    half = [[t for d, t in rows if (d < seconds / 2) == first]
            for first in (True, False)]
    started_late = sum(1 for a, req, stamps, _ in client.reqs
                       if a.counted and (not stamps or
                                         min(stamps.values()) - t0 > seconds))
    ttft = [t for _, t in rows]
    return {"done": len(rows),
            "sent": sum(a.counted for a in client.schedule),
            "ttft_p50_ms": statistics.median(ttft) if ttft else None,
            "ttft_p90_ms": traffic.percentile(ttft, 90),
            "ttft_p50_first_half_ms": statistics.median(half[0])
            if half[0] else None,
            "ttft_p50_second_half_ms": statistics.median(half[1])
            if half[1] else None,
            "first_token_after_close": started_late,
            "drain_s": win["t_end"] - t0 - seconds,
            "recaptures": win["recaptures"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    dev = torch.device("cuda", 0)
    ctx = bench.context(args.workload, args.seed, args.seconds, False, dev,
                        T_START)
    eng, _, _ = open_loop.prepare(ctx)
    for rate in (float(r) for r in args.rates.split(",")):
        sched = traffic.open_loop(ctx.mix, ctx.spec.vocab_size, args.seed,
                                  args.seconds, rate=rate)
        win = open_loop.window(ctx, eng, sched)
        print(json.dumps({"rate_per_s": rate,
                          **summary(win, args.seconds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
