"""Device time from a ``torch.profiler`` trace of a slice of the window.

The profiler's Chrome trace holds every kernel, copy and fill the device
ran (kernels replayed from a CUDA graph included) on the same clock as
the host annotations.  The traced window is the host annotation
:data:`WINDOW`; its start is also stamped with ``time.perf_counter`` so
that host intervals from other sources (the harness's own, the port's
spans) can be laid over the device timeline.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "portbench.traced_window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Profile:
    """Start and stop a device trace around a slice of the run (which may
    open and close in different callbacks)."""

    def __init__(self):
        import torch
        self._torch = torch
        act = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            act.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=act)
        self._rf = None
        self.t0_host: Optional[float] = None
        self.t1_host: Optional[float] = None

    def start(self) -> None:
        self.prof.start()
        self._rf = self._torch.profiler.record_function(WINDOW)
        self._rf.__enter__()
        self.t0_host = time.perf_counter()

    def stop(self) -> None:
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        self.t1_host = time.perf_counter()
        self._rf.__exit__(None, None, None)
        self.prof.stop()

    def read(self, host: Sequence[Tuple[str, float, float]] = ()
             ) -> "DeviceTrace":
        """The trace, with ``host`` intervals (label, perf_counter start,
        end) laid over it."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return DeviceTrace.from_events(events, self.t0_host, host)


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    """Device operations (name, start s, end s) inside the traced window
    [w0, w1] (seconds on the trace clock), and host intervals on the same
    clock."""

    def __init__(self, ops, window, host):
        self.ops = ops
        self.w0, self.w1 = window
        self.host = host

    @classmethod
    def from_events(cls, events, t0_host: float, host) -> "DeviceTrace":
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
        if not win:
            raise ValueError("the trace has no traced-window annotation")
        w0 = win[0]["ts"] * 1e-6
        w1 = w0 + win[0]["dur"] * 1e-6
        ops = []
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS:
                a = e["ts"] * 1e-6
                b = a + e.get("dur", 0) * 1e-6
                if b > w0 and a < w1:
                    ops.append((e.get("name", "?"), max(a, w0), min(b, w1)))
        shift = w0 - t0_host
        return cls(ops, (w0, w1),
                   [(lab, a + shift, b + shift) for lab, a, b in host
                    if b + shift > w0 and a + shift < w1])

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in _union([(a, b) for _, a, b in self.ops]))

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, a, b in self.ops:
            out[name] += b - a
        return dict(out)

    def seconds_matching(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(b - a for name, a, b in self.ops if rx.search(name))

    def top_ops(self, n: int = 10) -> List[list]:
        by = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])
        return [[name[:200], s] for name, s in by[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle device time inside the window, summed by what the host was
        doing when each gap began (the innermost host interval holding
        it; "host" where none does), longest first."""
        busy = _union([(a, b) for _, a, b in self.ops])
        gaps, t = [], self.w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.w1 > t:
            gaps.append((t, self.w1))
        out: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            holding = [(ha, lab) for lab, ha, hb in self.host if ha <= a < hb]
            out[max(holding)[1] if holding else "host"] += b - a
        by = sorted(out.items(), key=lambda kv: -kv[1])
        return [[lab, s] for lab, s in by[:n]]
