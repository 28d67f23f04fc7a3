"""Typed metrics registry: Counter / Gauge / fixed-bucket Histogram (port
of ``repro/obs/metrics.py``; plain Python, no torch).

One registry unifies the serving tier's telemetry (scheduler counters,
pool gauges, tenant quotas, spec-decode stats) behind three typed
instruments, each optionally labeled (tenant / request class / fault point
/ ledger term).  Two exporters: Prometheus text exposition and a JSON
snapshot (schema-validated by :func:`validate_snapshot`).  The snapshot's
schema tag is the reference's, so one validator reads both packages'.

Reachability from ``core/`` follows the ``core.pager._fault_hook``
contract exactly (see ``serve/faults.py``): core modules hold a nullable
module-level hook and pay ONE ``is None`` check when telemetry is off —
core never imports this package.  :func:`install` wires the hook via a
late import; :func:`uninstall` (or ``install(None)``) severs it.

Label-set growth is bounded by the same policy as the scheduler's
``gauge_history`` ring buffers: ``max_series`` keeps the most recently
*touched* label sets per metric and drops the LRU one beyond the cap
(0 = unbounded).  This is the registry-side twin of the
``RequestScheduler.tenant_gauges`` LRU cap.
"""
from __future__ import annotations

import json
import re
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, Iterable, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "active", "install", "installed", "uninstall",
    "validate_prometheus", "validate_snapshot",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

DEFAULT_MS_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
                      250.0, 500.0, 1000.0, 2500.0, 5000.0)


class _Metric:
    """Shared series bookkeeping: ``OrderedDict[label-values -> state]``
    with LRU eviction past ``max_series`` (0 = unbounded), mirroring the
    ``gauge_history`` ring policy."""

    kind = "abstract"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = (), max_series: int = 0):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"bad label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = max_series
        self._series: "OrderedDict[Tuple[str, ...], object]" = OrderedDict()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _touch(self, key: Tuple[str, ...]):
        """Return the series state for ``key``, creating it and evicting
        the least-recently-touched series beyond ``max_series``."""
        st = self._series.get(key)
        if st is None:
            st = self._new_state()
            self._series[key] = st
        else:
            self._series.move_to_end(key)
        if self.max_series and len(self._series) > self.max_series:
            self._series.popitem(last=False)
        return st

    def _new_state(self):
        raise NotImplementedError

    def series(self):
        """[(labels-dict, state)] in LRU order (oldest first)."""
        return [(dict(zip(self.labelnames, k)), v)
                for k, v in self._series.items()]


class Counter(_Metric):
    """Monotonic count.  ``set_to`` exists ONLY so the public int fields
    (``RequestScheduler.prefix_hits`` et al.) can stay writable as thin
    views over the registry, and so cumulative counts kept elsewhere (the
    tier pool's spills) can be mirrored — new code must use :meth:`inc`."""

    kind = "counter"

    def _new_state(self):
        return [0.0]

    def inc(self, value: float = 1.0, **labels):
        if value < 0:
            raise ValueError(f"{self.name}: counter increment {value} < 0")
        self._touch(self._key(labels))[0] += value

    def set_to(self, value: float, **labels):
        self._touch(self._key(labels))[0] = value

    def value(self, **labels) -> float:
        st = self._series.get(self._key(labels))
        return st[0] if st is not None else 0.0


class Gauge(_Metric):
    kind = "gauge"

    def _new_state(self):
        return [0.0]

    def set(self, value: float, **labels):
        self._touch(self._key(labels))[0] = value

    def inc(self, value: float = 1.0, **labels):
        self._touch(self._key(labels))[0] += value

    def dec(self, value: float = 1.0, **labels):
        self.inc(-value, **labels)

    def value(self, **labels) -> float:
        st = self._series.get(self._key(labels))
        return st[0] if st is not None else 0.0


class Histogram(_Metric):
    """Fixed cumulative buckets (Prometheus ``le`` semantics) plus
    sum/count; buckets are frozen at construction."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), max_series=0,
                 buckets: Tuple[float, ...] = DEFAULT_MS_BUCKETS):
        super().__init__(name, help, labelnames, max_series)
        bk = tuple(sorted(float(b) for b in buckets))
        if not bk:
            raise ValueError(f"{name}: histogram needs >= 1 bucket")
        self.buckets = bk

    def _new_state(self):
        # [counts per finite bucket..., +Inf count, sum]
        return [0] * (len(self.buckets) + 1) + [0.0]

    def observe(self, value: float, **labels):
        st = self._touch(self._key(labels))
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):
            if value <= b:
                i = j
                break
        st[i] += 1
        st[-1] += value

    def count(self, **labels) -> int:
        st = self._series.get(self._key(labels))
        return sum(st[:-1]) if st is not None else 0

    def sum(self, **labels) -> float:
        st = self._series.get(self._key(labels))
        return st[-1] if st is not None else 0.0


class MetricsRegistry:
    """Name -> typed metric.  Re-registering an existing name returns the
    existing instrument (declared type/labels must match — a mismatch is
    a bug, not a merge)."""

    def __init__(self, max_series: int = 0):
        self.max_series = max_series
        self._metrics: "OrderedDict[str, _Metric]" = OrderedDict()

    def _register(self, cls, name, help, labelnames, **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered as {cls.kind}"
                    f"{tuple(labelnames)}, was {m.kind}{m.labelnames}")
            return m
        m = cls(name, help, tuple(labelnames),
                max_series=self.max_series, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_MS_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def get(self, name) -> Optional[_Metric]:
        return self._metrics.get(name)

    def metrics(self) -> Iterable[_Metric]:
        return list(self._metrics.values())

    # -- exporters ---------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able snapshot; schema enforced by :func:`validate_snapshot`."""
        out = []
        for m in self._metrics.values():
            series = []
            for labels, st in m.series():
                if m.kind == "histogram":
                    buckets = {str(b): int(c)
                               for b, c in zip(m.buckets, st)}
                    buckets["+Inf"] = int(st[len(m.buckets)])
                    series.append({"labels": labels, "buckets": buckets,
                                   "sum": float(st[-1]),
                                   "count": int(sum(st[:-1]))})
                else:
                    series.append({"labels": labels, "value": float(st[0])})
            out.append({"name": m.name, "type": m.kind, "help": m.help,
                        "series": series})
        return {"schema": "repro.obs.metrics/v1", "metrics": out}

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        def fmt_labels(labels, extra=()):
            items = list(labels.items()) + list(extra)
            if not items:
                return ""
            body = ",".join(
                '%s="%s"' % (k, str(v).replace("\\", "\\\\")
                             .replace('"', '\\"').replace("\n", "\\n"))
                for k, v in items)
            return "{" + body + "}"

        lines = []
        for m in self._metrics.values():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for labels, st in m.series():
                if m.kind == "histogram":
                    acc = 0
                    for b, c in zip(m.buckets, st):
                        acc += c
                        lines.append(
                            f"{m.name}_bucket"
                            f"{fmt_labels(labels, [('le', repr(b))])} {acc}")
                    acc += st[len(m.buckets)]
                    lines.append(
                        f"{m.name}_bucket"
                        f"{fmt_labels(labels, [('le', '+Inf')])} {acc}")
                    lines.append(
                        f"{m.name}_sum{fmt_labels(labels)} {st[-1]}")
                    lines.append(
                        f"{m.name}_count{fmt_labels(labels)} {acc}")
                else:
                    lines.append(f"{m.name}{fmt_labels(labels)} {st[0]}")
        return "\n".join(lines) + "\n"


# -- schema validation ------------------------------------------------------

def validate_snapshot(payload: dict) -> list:
    """Return a list of schema violations ([] == valid) for a
    :meth:`MetricsRegistry.snapshot` payload."""
    errs = []
    if not isinstance(payload, dict):
        return ["snapshot is not an object"]
    if payload.get("schema") != "repro.obs.metrics/v1":
        errs.append(f"bad schema tag {payload.get('schema')!r}")
    metrics = payload.get("metrics")
    if not isinstance(metrics, list):
        return errs + ["'metrics' is not a list"]
    seen = set()
    for m in metrics:
        name = m.get("name") if isinstance(m, dict) else None
        where = f"metric {name!r}"
        if not isinstance(m, dict) or not isinstance(name, str) \
                or not _NAME_RE.match(name):
            errs.append(f"{where}: bad name")
            continue
        if name in seen:
            errs.append(f"{where}: duplicate")
        seen.add(name)
        kind = m.get("type")
        if kind not in ("counter", "gauge", "histogram"):
            errs.append(f"{where}: bad type {kind!r}")
            continue
        if not isinstance(m.get("series"), list):
            errs.append(f"{where}: 'series' is not a list")
            continue
        for s in m["series"]:
            if not isinstance(s, dict) or \
                    not isinstance(s.get("labels"), dict):
                errs.append(f"{where}: series missing labels")
                continue
            if kind == "histogram":
                bk = s.get("buckets")
                if not isinstance(bk, dict) or "+Inf" not in bk:
                    errs.append(f"{where}: histogram missing +Inf bucket")
                elif not all(isinstance(c, int) and c >= 0
                             for c in bk.values()):
                    errs.append(f"{where}: negative/non-int bucket count")
                if not isinstance(s.get("count"), int) or \
                        not isinstance(s.get("sum"), (int, float)):
                    errs.append(f"{where}: histogram missing sum/count")
                elif isinstance(bk, dict) and \
                        sum(bk.values()) != s["count"]:
                    errs.append(f"{where}: bucket counts != count")
            else:
                if not isinstance(s.get("value"), (int, float)):
                    errs.append(f"{where}: series missing numeric value")
        if kind == "counter":
            for s in m["series"]:
                v = s.get("value")
                if isinstance(v, (int, float)) and v < 0:
                    errs.append(f"{where}: negative counter")
    return errs


_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="
    r"\"(?:[^\"\\]|\\.)*\"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*\})?"
    r" [0-9eE+.\-]+(?: [0-9]+)?$")


def validate_prometheus(text: str) -> list:
    """Line-level validation of the text exposition format ([] == valid)."""
    errs = []
    for i, line in enumerate(text.splitlines()):
        if not line or line.startswith("# HELP ") or \
                line.startswith("# TYPE "):
            continue
        if not _PROM_LINE.match(line):
            errs.append(f"line {i + 1}: malformed sample {line!r}")
    return errs


def snapshot_to_json(reg: MetricsRegistry) -> str:
    return json.dumps(reg.snapshot(), indent=1, sort_keys=True)


# -- install / uninstall: the serve/faults.py contract ---------------------

_ACTIVE: Optional[MetricsRegistry] = None


def active() -> Optional[MetricsRegistry]:
    return _ACTIVE


def _core_event(point: str, value: float = 1.0):
    """Target of ``core.pager._metrics_hook``: core modules report page /
    tier events by name; the registry buckets them under one labeled
    counter.  Only ever installed non-None alongside a live registry."""
    reg = _ACTIVE
    if reg is not None:
        reg.counter("core_events_total",
                    "page-pool and tier events fired from core/",
                    labelnames=("point",)).inc(value, point=point)


def install(reg: Optional[MetricsRegistry]):
    """Make ``reg`` the process-wide registry and wire the core hook.
    ``install(None)`` disables: core hot paths go back to a single
    ``is None`` check (the serve/faults.py zero-cost contract)."""
    global _ACTIVE
    _ACTIVE = reg
    from repro_torch.core import pager   # late: core never imports obs
    pager._metrics_hook = None if reg is None else _core_event


def uninstall():
    install(None)


@contextmanager
def installed(reg: MetricsRegistry):
    prev = _ACTIVE
    install(reg)
    try:
        yield reg
    finally:
        install(prev)
