"""One run of one cell: find its files by name, drive it, check it,
report it.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration's file is ``configs/<config>.json``, the mix's
``traffic/<mix>.json`` (whose ``driver`` names the module under
``drivers/`` that runs that kind of traffic), the limits its outputs are
held to ``limits/<workload>.json``, and each per-layer metric's reader
``metrics/<metric>.py``.  Adding a cell, a mix of a known kind or a
metric adds files and entries; it edits none.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from portbench import spec as spec_mod
from portbench import traffic

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def log(ctx: "Ctx", msg: str) -> None:
    """A progress line on standard error, stamped with the run's clock."""
    print(f"[portbench {time.perf_counter() - ctx.t_start:8.2f}s] {msg}",
          file=sys.stderr, flush=True)


def manifest(repo: Path = REPO) -> dict:
    with open(repo / "BENCHMARK.json") as f:
        return json.load(f)


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in man['workloads'])})")


def metrics_for(man: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    tracing, the per-layer ones with it, each where its ``workloads``
    (when given) list the cell."""
    rows = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in rows if cell in m.get("workloads", [cell])]


def load_reader(name: str, root: Path = ROOT) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_limits(cell: str, root: Path = ROOT) -> dict:
    with open(root / "limits" / f"{cell}.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell and its files, the run's arguments."""
    cell: str
    spec: spec_mod.ModelSpec
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float                 # perf_counter at process start


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    data: Dict[str, Any]           # what the per-layer readers read
    checks: List[Check]
    memory_peak_bytes: int
    trace: Any = None              # a yardstick.devtrace.DeviceTrace

    @property
    def correct(self) -> bool:
        return self.failed == 0 and self.attempted > 0 \
            and all(c.ok for c in self.checks)


def context(cell: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, man: Optional[dict] = None) -> Ctx:
    man = man or manifest()
    w = workload(man, cell)
    config = spec_mod.load_config(w["config"])
    return Ctx(cell=cell, spec=spec_mod.spec_from_dict(config),
               config=config, mix=traffic.load_mix(w["traffic"]),
               limits=load_limits(cell), seed=seed, seconds=seconds,
               trace=trace, device=device, t_start=t_start)


def drive(ctx: Ctx) -> Outcome:
    mod = importlib.import_module(f"portbench.drivers.{ctx.mix['driver']}")
    return mod.run(ctx)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def result_line(man: dict, ctx: Ctx, out: Outcome, device: dict
                ) -> Tuple[dict, List[str]]:
    """The last line's object, and the compared numbers for stderr."""
    metrics = {}
    for m in metrics_for(man, ctx.cell, ctx.trace):
        if ctx.trace:
            value = load_reader(m["name"])(ctx, out)
        else:
            value = out.end_to_end.get(m["name"])
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    res: Dict[str, Any] = {"correct": out.correct,
                           "attempted": out.attempted,
                           "failed": out.failed, "metrics": metrics,
                           "device": device}
    if ctx.trace and out.trace is not None:
        res["breakdown"] = {"device_ops": out.trace.top_ops(10),
                            "idle_gaps": out.trace.idle_gaps(10)}
    res["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in out.checks}
    lines = [f"check {c.name} = {c.value!r} (limit {c.limit!r}): "
             f"{'ok' if c.ok else 'FAILED'}" for c in out.checks]
    return res, lines
