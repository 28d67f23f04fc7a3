"""The port's step programs' own records of their calls, read after a run.

``serve/step_graph.py`` keeps them, always on and past the engine's life:
per call after the capture, host seconds in ``stage`` (the input copies),
``key`` (the graph's key) and ``launch`` (the replay), and on the card the
replay's device seconds from a pair of timing events around it.  An older
port, which keeps none, reads as no records.

In a traced run of the ``session`` driver the host phases are read over
the window's calls before its profiled slice: once a ``torch.profiler``
has recorded, the host runs the calls after it two to three times slower
(it stays attached), and the profiled calls themselves slower still.  The
device times do not move with it, and are read over the whole window.
"""
from __future__ import annotations

import importlib
from typing import List, Optional

from portbench import program


def step_graph_module():
    """The port's ``serve/step_graph.py``, through the harness's one way
    into the port."""
    port = program.import_port()
    return importlib.import_module(f"{port.__name__}.serve.step_graph")


def records(name: str, device: bool = False, t0: Optional[float] = None,
            t1: Optional[float] = None) -> List[dict]:
    """The last calls of step program ``name`` (``decode``,
    ``prefill_chunk``, ...): host records (dicts of ``t``, ``stage_s``,
    ``key_s``, ``launch_s``) or with ``device`` the timed
    replays (dicts of ``t``, ``device_s``), those whose call began in
    [t0, t1) (``time.perf_counter``) where given; [] where the port keeps
    none."""
    step_graph = step_graph_module()
    stats = getattr(step_graph, "program_stats", None)
    st = stats(name) if stats is not None else None
    if not st:
        return []
    return [r for r in st["device" if device else "host"]
            if (t0 is None or r["t"] >= t0) and (t1 is None or r["t"] < t1)]


def window(out, name: str) -> List[dict]:
    """The ``session`` driver's window calls of step program ``name``
    (its last ``steps`` calls), as :func:`records` gives them; [] where
    the records do not reach back to the window's start."""
    steps = out.data.get("steps", 0)
    host = records(name)
    return host[-steps:] if steps and len(host) >= steps else []


def before_profile(ctx, out, name: str) -> List[dict]:
    """The window's calls of step program ``name`` before the driver's
    profiler started: its first ``trace_skip``."""
    return window(out, name)[:ctx.mix["trace_skip"]]
