"""Run one cell of the port's benchmark once and print one result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (a ``workloads`` entry of ``BENCHMARK.json``) is set up from the
seed, measured for ``--seconds``, checked against the plain reference, and
reported as the last line of standard output: one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end
metrics, or with ``--trace 1`` the per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit (also the last lines of standard error).  It exits
non-zero, printing no result, without a CUDA card, in a checkout without
the port, or when JAX or the JAX package got loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache of the program inside the checkout,
    at fixed paths (the port's CUDA library already builds into
    ``build/kernels/``); nothing loads JAX through a library."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(REPO / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(REPO / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(REPO))
    from portbench import bench, program
    try:
        program.import_port()
    except (FileNotFoundError, ImportError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    import torch
    man = bench.manifest()
    chips = bench.workload(man, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx = bench.context(args.workload, args.seed, args.seconds,
                        bool(args.trace), dev, T_START, man)
    out = bench.drive(ctx)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": chips, "memory_peak_bytes": out.memory_peak_bytes,
              "power_limit": _power_limit()}
    if args.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
    res, lines = bench.result_line(man, ctx, out, device)
    bad = bench.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
