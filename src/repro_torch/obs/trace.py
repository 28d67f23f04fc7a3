"""Per-request span tracer + the one shared latency-stamping code path (port
of ``repro/obs/trace.py``; plain Python, no torch).

:class:`SpanTracer` records begin/end span pairs for every lifecycle
phase the scheduler drives (queue wait, prefill chunks, decode steps,
park/resume, tier fetch/spill transfers, speculative verify rounds,
teardown) and exports them as Chrome-trace-event JSON (the ``X``
complete-event form — load the file in Perfetto / chrome://tracing).

Balance is an invariant, not a hope: ``begun``/``ended`` are cumulative
counters that survive the ring cap, and :meth:`SpanTracer.end_track`
closes every open span on a request's track so the teardown / retry
paths (fail, timeout, cancel, shed, evict-to-requeue) can never leak an
open span.  Completed events ride a deque ring-capped by the same
``gauge_history`` policy as the scheduler's gauges (0 = unbounded).

:class:`RequestTimeline` is the single TTFT / inter-token stamping path:
``launch/serve.py --stream`` and any live deployment chain it onto
``Request.on_token``, and it feeds the registry's latency histograms when
one is attached, so a benchmark and live metrics cannot disagree about
what "TTFT" means.

Times are HOST times (``time.perf_counter``).  On the card a span closes
when the host returns, which is before the kernels it issued finish,
unless the span ends in a host read of device data: see the README's
telemetry section for which spans include device time.

Install contract matches ``serve/faults.py``: module-level nullable
singleton, one ``is None`` check when disabled.
"""
from __future__ import annotations

import itertools
import json
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = ["SpanTracer", "RequestTimeline", "active", "install",
           "installed", "uninstall", "validate_chrome_trace"]


class SpanTracer:
    """Begin/end span recording with per-track bookkeeping.

    ``track`` is the trace row a span renders on — the scheduler uses
    request ids for lifecycle spans and ``"scheduler"`` for step-scoped
    work.  ``max_events`` ring-caps COMPLETED events only (policy twin of
    ``ServeConfig.gauge_history``); open spans and the cumulative
    ``begun``/``ended`` counters are never dropped, so balance checks stay
    exact even after eviction.
    """

    def __init__(self, max_events: int = 0, clock=time.perf_counter):
        self.clock = clock
        self.events = deque(maxlen=max_events or None)
        self.begun = 0
        self.ended = 0
        self._open: Dict[int, dict] = {}
        self._ids = itertools.count(1)
        self._t0 = clock()

    # -- recording ---------------------------------------------------------

    def begin(self, name: str, track: str = "main", **args) -> int:
        sid = next(self._ids)
        self._open[sid] = {"name": name, "track": str(track),
                           "t0": self.clock(), "args": args or None}
        self.begun += 1
        return sid

    def end(self, sid: int, **args) -> float:
        """Close span ``sid``; returns its duration in seconds.  Ending an
        unknown/already-closed id raises — that is exactly the imbalance
        bug this class exists to surface."""
        sp = self._open.pop(sid, None)
        if sp is None:
            raise ValueError(f"span id {sid} is not open")
        t1 = self.clock()
        if args:
            sp["args"] = {**(sp["args"] or {}), **args}
        sp["t1"] = t1
        self.events.append(sp)
        self.ended += 1
        return t1 - sp["t0"]

    def end_track(self, track: str, **args) -> int:
        """Close EVERY open span on ``track`` (newest first, so nested
        spans unwind inside-out).  The teardown paths call this; returns
        how many spans it had to close."""
        track = str(track)
        sids = [sid for sid, sp in self._open.items()
                if sp["track"] == track]
        for sid in reversed(sids):
            self.end(sid, **args)
        return len(sids)

    @contextmanager
    def span(self, name: str, track: str = "main", **args):
        sid = self.begin(name, track, **args)
        try:
            yield sid
        finally:
            if sid in self._open:       # an inner end_track may have won
                self.end(sid)

    def instant(self, name: str, track: str = "main", **args):
        """Zero-duration marker (token emitted, fault injected, ...)."""
        t = self.clock()
        self.events.append({"name": name, "track": str(track),
                            "t0": t, "t1": t, "args": args or None})

    # -- inspection --------------------------------------------------------

    @property
    def open_count(self) -> int:
        return len(self._open)

    def open_tracks(self) -> List[str]:
        return sorted({sp["track"] for sp in self._open.values()})

    def balanced(self) -> bool:
        return self.begun == self.ended and not self._open

    # -- export ------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """Chrome-trace-event JSON (``X`` complete events, ts/dur in µs).
        Open spans are NOT exported — export at a drain point and assert
        :meth:`balanced` first."""
        tids, events = {}, []
        for sp in self.events:
            tid = tids.setdefault(sp["track"], len(tids))
            ev = {"name": sp["name"], "ph": "X", "pid": 0, "tid": tid,
                  "ts": (sp["t0"] - self._t0) * 1e6,
                  "dur": (sp["t1"] - sp["t0"]) * 1e6}
            if sp["args"]:
                ev["args"] = {k: v for k, v in sp["args"].items()}
            events.append(ev)
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": track}} for track, tid in tids.items()]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def dump(self, path):
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)


def validate_chrome_trace(payload: dict) -> list:
    """Schema check for :meth:`SpanTracer.chrome_trace` output
    ([] == valid Chrome-trace JSON)."""
    errs = []
    if not isinstance(payload, dict) or \
            not isinstance(payload.get("traceEvents"), list):
        return ["missing 'traceEvents' list"]
    for i, ev in enumerate(payload["traceEvents"]):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M", "B", "E", "i"):
            errs.append(f"event {i}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or "pid" not in ev \
                or "tid" not in ev:
            errs.append(f"event {i}: missing name/pid/tid")
        if ph == "X" and (not isinstance(ev.get("ts"), (int, float))
                          or not isinstance(ev.get("dur"), (int, float))
                          or ev["dur"] < 0 or ev["ts"] < 0):
            errs.append(f"event {i}: bad ts/dur")
    return errs


class RequestTimeline:
    """The one code path for client-observed latency.

    Stamp ``submitted(rid)`` when the request enters the queue and chain
    :meth:`attach` onto ``Request.on_token``; TTFT (submit -> first
    token) and inter-token gaps fall out.  When a
    :class:`~repro_torch.obs.metrics.MetricsRegistry` is attached the
    stamps also feed ``obs_ttft_ms`` / ``obs_inter_token_ms`` histograms,
    so a benchmark and a live ``--metrics-out`` scrape report the same
    numbers by construction.
    """

    def __init__(self, clock=time.perf_counter, registry=None):
        self.clock = clock
        self.stamps: Dict[object, List[float]] = {}
        self.registry = registry
        if registry is not None:
            self._ttft = registry.histogram(
                "obs_ttft_ms", "submit -> first emitted token")
            self._gap = registry.histogram(
                "obs_inter_token_ms", "gap between streamed tokens")
        else:
            self._ttft = self._gap = None

    def submitted(self, rid):
        self.stamps[rid] = [self.clock()]

    def stamp(self, rid):
        st = self.stamps.get(rid)
        if st is None:                          # never submitted(): the
            st = self.stamps[rid] = [self.clock()]   # stamp opens the track
        st.append(self.clock())
        if self._ttft is not None:
            gap_ms = (st[-1] - st[-2]) * 1e3
            (self._ttft if len(st) == 2 else self._gap).observe(gap_ms)

    def attach(self, req):
        """Chain onto ``req.on_token`` (keeps any existing callback)."""
        prev = req.on_token
        rid = req.req_id

        def on_token(*a, _prev=prev, _rid=rid):
            self.stamp(_rid)
            if _prev is not None:
                _prev(*a)

        req.on_token = on_token
        return req

    # -- derived latencies (ms) -------------------------------------------

    def ttft_ms(self, rid) -> Optional[float]:
        st = self.stamps.get(rid)
        return (st[1] - st[0]) * 1e3 if st and len(st) >= 2 else None

    def gaps_ms(self, rid) -> List[float]:
        st = self.stamps.get(rid, [])
        return [(b - a) * 1e3 for a, b in zip(st[1:], st[2:])]

    def summary(self) -> dict:
        def pct(xs, q):
            if not xs:
                return None
            xs = sorted(xs)
            return xs[min(len(xs) - 1, int(q * len(xs)))]
        ttfts = [t for r in self.stamps if (t := self.ttft_ms(r)) is not None]
        gaps = [g for r in self.stamps for g in self.gaps_ms(r)]
        return {"n": len(self.stamps),
                "ttft_p50_ms": pct(ttfts, 0.50),
                "ttft_p99_ms": pct(ttfts, 0.99),
                "inter_token_p50_ms": pct(gaps, 0.50),
                "inter_token_p99_ms": pct(gaps, 0.99)}


# -- install / uninstall: the serve/faults.py contract ---------------------

_ACTIVE: Optional[SpanTracer] = None


def active() -> Optional[SpanTracer]:
    return _ACTIVE


def install(tracer: Optional[SpanTracer]):
    global _ACTIVE
    _ACTIVE = tracer


def uninstall():
    install(None)


@contextmanager
def installed(tracer: SpanTracer):
    prev = _ACTIVE
    install(tracer)
    try:
        yield tracer
    finally:
        install(prev)
