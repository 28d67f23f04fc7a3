"""Drive the full dry-run grid: every (arch × shape) × {single-pod,
multi-pod} (port of ``repro/launch/rungrid.py``).

Each cell runs in its own subprocess (a process holds one process group,
and the cells are independent), ``--jobs`` cells at a time, each under
``--timeout`` seconds.  On the CPU only: ``launch.dryrun`` touches no
card.

    PYTHONPATH=src python -m repro_torch.launch.rungrid [--jobs 4] \\
        [--out artifacts/dryrun_torch] [--archs a,b] [--shapes s1,s2] \\
        [--meshes single,multi] [--retry-failed]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.launch.dryrun import OUT

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cell_cmd(arch: str, shape: str, multi_pod: bool, out: str,
             extra: list) -> list:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out]
    if multi_pod:
        cmd.append("--multi-pod")
    return cmd + extra


def run_one(arch: str, shape: str, multi_pod: bool, out: str, extra: list,
            timeout: int) -> dict:
    mesh = "pod2x16x16" if multi_pod else "pod16x16"
    t0 = time.time()
    try:
        proc = subprocess.run(
            cell_cmd(arch, shape, multi_pod, out, extra),
            capture_output=True, text=True, timeout=timeout,
            env={**os.environ, "PYTHONPATH": SRC})
        ok = proc.returncode == 0
        tail = (proc.stdout + proc.stderr).strip().splitlines()[-3:]
    except subprocess.TimeoutExpired:
        ok, tail = False, ["TIMEOUT"]
    return {"arch": arch, "shape": shape, "mesh": mesh, "ok": ok,
            "wall_s": round(time.time() - t0, 1), "tail": tail}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--archs", default=",".join(ASSIGNED_ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPE_ORDER))
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--retry-failed", action="store_true",
                    help="only run cells whose artifact is missing/failed")
    ap.add_argument("--extra", default="",
                    help="extra dryrun args, e.g. '--no-sals --tag nosals'")
    args = ap.parse_args()

    archs = [a for a in args.archs.split(",") if a]
    shapes = [s for s in args.shapes.split(",") if s]
    meshes = [m for m in args.meshes.split(",") if m]
    extra = args.extra.split() if args.extra else []

    cells = []
    for arch in archs:
        for shape in shapes:
            for m in meshes:
                multi = m == "multi"
                if args.retry_failed:
                    mesh = "pod2x16x16" if multi else "pod16x16"
                    tag = ""
                    for e in extra:
                        if e.startswith("--tag"):
                            tag = "." + extra[extra.index(e) + 1]
                    p = os.path.join(args.out,
                                     f"{arch}.{shape}.{mesh}{tag}.json")
                    if os.path.exists(p):
                        with open(p) as f:
                            if json.load(f).get("status") in ("ok", "skipped"):
                                continue
                cells.append((arch, shape, multi))

    print(f"[rungrid] {len(cells)} cells, {args.jobs} concurrent")
    failed = []
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        futs = {ex.submit(run_one, a, s, m, args.out, extra, args.timeout):
                (a, s, m) for a, s, m in cells}
        done = 0
        for fut in as_completed(futs):
            r = fut.result()
            done += 1
            mark = "ok " if r["ok"] else "FAIL"
            print(f"[{done}/{len(cells)}] {mark} {r['arch']} {r['shape']} "
                  f"{r['mesh']} ({r['wall_s']}s)", flush=True)
            if not r["ok"]:
                failed.append(r)
                for line in r["tail"]:
                    print("   ", line[:160])
    print(f"[rungrid] done: {len(cells) - len(failed)} ok, "
          f"{len(failed)} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
