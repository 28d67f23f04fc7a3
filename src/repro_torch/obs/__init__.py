"""Telemetry for the port's serving stack (port of ``repro/obs``).

Three instruments, one install contract (the ``serve/faults.py``
nullable-singleton pattern: a disabled instrument costs one ``is None``
check on the hot path):

* :mod:`repro_torch.obs.metrics` — typed Counter/Gauge/Histogram registry,
  Prometheus-text + JSON snapshot exporters, reachable from ``core/``
  through ``core.pager._metrics_hook``.
* :mod:`repro_torch.obs.trace` — per-request lifecycle span tracer with
  Chrome-trace (Perfetto) export, plus :class:`RequestTimeline`, the one
  TTFT / inter-token stamping path.
* :mod:`repro_torch.obs.traffic` — measured-vs-modeled byte accountant
  that enforces the port's byte ledger (:mod:`repro_torch.obs.ledger`) at
  runtime (:class:`TrafficDriftError`).

Every hook sits in host code around the engine's step programs (the
scheduler, the pager, the tier pool), never inside a captured CUDA graph,
so spans, counters and byte accounting see every replay.  ``enable()``
wires all three for a scheduler run; ``enabled()`` is the context-manager
form the tests use.
"""
from __future__ import annotations

from contextlib import contextmanager

from repro_torch.obs import metrics, trace, traffic
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import RequestTimeline, SpanTracer
from repro_torch.obs.traffic import TrafficAccountant, TrafficDriftError

__all__ = [
    "MetricsRegistry", "RequestTimeline", "SpanTracer",
    "TrafficAccountant", "TrafficDriftError",
    "enable", "disable", "enabled", "metrics", "trace", "traffic",
]


def enable(gauge_history: int = 0, cfg=None, sals=None,
           tol: float = 0.01, with_traffic: bool = False,
           clock=None) -> dict:
    """Install a fresh registry + tracer (+ traffic accountant when
    ``with_traffic`` and a (cfg, sals) pair are given).  Returns the
    handles; ``disable()`` reverses it.  Install it before building the
    scheduler, which adopts the active instruments in ``__init__``."""
    reg = MetricsRegistry(max_series=gauge_history)
    kw = {"clock": clock} if clock is not None else {}
    tr = SpanTracer(max_events=gauge_history, **kw)
    metrics.install(reg)
    trace.install(tr)
    acct = None
    if with_traffic:
        if cfg is None or sals is None:
            raise ValueError("with_traffic=True needs cfg and sals")
        acct = TrafficAccountant(cfg, sals, tol=tol, registry=reg)
        traffic.install(acct)
    return {"registry": reg, "tracer": tr, "traffic": acct}


def disable():
    traffic.uninstall()
    trace.uninstall()
    metrics.uninstall()


@contextmanager
def enabled(**kw):
    handles = enable(**kw)
    try:
        yield handles
    finally:
        disable()
