"""The control of a cell's output check, on the card at the cell's own
size: for each seed, a run of the cell (a short window) gives the
program's readings (every number its check compares), and the reference
run again in fp8 over the same prompts and tokens gives the control's:
at each position, the reference's gap of the token the fp8 run puts
first, and where the cell judges its cache, the relative error of what
the fp8 reference's cache would hold against the reference's.  fp8 is
the precision below the configuration's bf16, as a faster step would
take it: the weights (``weights.fp8_weights``) and every linear layer's
input in e4m3.  The control must read far above the program: its
smallest reading is the upper end the cell's limit is set below.
``--fault`` plants a fault of ``faults.py`` in the timed path instead,
and ``--control 0`` leaves the control out.  One JSON line a seed.

    python3 portbench/tools/control.py --workload mistral.decode32k \\
        --seeds 11,12,13 --seconds 10
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import bench, faults, weights  # noqa: E402
from portbench.reference import load as load_reference  # noqa: E402
from portbench.yardstick import compare  # noqa: E402


def control_reading(ctx, check_inputs) -> dict:
    """The fp8 control's readings over a run's checked tokens: its widest
    gap, and (where the run judged its cache) the largest relative error
    of what the fp8 reference's cache would hold against the
    reference's."""
    import torch
    w, cal = check_inputs["weights"], check_inputs["cal"]
    ref = load_reference(ctx.spec, w)
    ref.fit_projectors(cal)
    low = load_reference(ctx.spec, weights.fp8_weights(w), fp8=True)
    low.fit_projectors(cal)
    n, ring = check_inputs.get("state_n"), ctx.spec.sals.n_recent
    gap, errs = 0.0, []
    with torch.no_grad():
        for prompt, conts in check_inputs["items"]:
            lows = {}

            def keep(l, state):
                lows[l] = compare.held(state, n, ring)

            def judge(l, state):
                errs.append((l, compare.state_err(
                    lows[l], compare.held(state, n, ring))))
            low_lg = low.serve_logits(prompt, conts, on_state=keep
                                      if n else None)
            gap = max(gap, compare.control_gap(
                ref.serve_logits(prompt, conts, on_state=judge
                                 if n else None), low_lg))
    out = {"max_logit_gap": gap}
    if errs:
        out["max_cache_err"] = compare.worst(e for _, e in errs)
        out["cache_err_by_layer"] = [
            compare.worst(e for l, e in errs if l == layer)
            for layer in range(ctx.spec.n_layers)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", choices=faults.NAMES, default=None,
                    help="plant a fault in the timed path: its reading "
                         "must fail the limit")
    ap.add_argument("--control", type=int, choices=(0, 1), default=1,
                    help="0: the program's readings alone")
    args = ap.parse_args(argv)
    import torch
    from portbench import program
    program.import_port()
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = bench.context(args.workload, seed, args.seconds, False, dev, t0)
        with (faults.planted(args.fault) if args.fault
              else contextlib.nullcontext()):
            out = bench.drive(ctx)
        prog = {c.name: c.value for c in out.checks}
        ctl = control_reading(ctx, out.data["check_inputs"]) \
            if args.control else None
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault, "correct": out.correct,
                          "program": prog, "control": ctl,
                          "program_cache_err_by_layer":
                          out.data.get("cache_err_by_layer"),
                          "seconds": time.perf_counter() - t0}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
