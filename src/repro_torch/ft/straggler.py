"""Straggler detection from per-step wall times (a copy of
``repro/ft/straggler.py``, which the port may not import).

At pod scale the fleet moves at the speed of its slowest participant; the
monitor keeps a rolling window of step times, flags steps slower than
``threshold × p50`` (p95-style tail detection), and exposes a mitigation
decision: after ``patience`` consecutive flags the caller should checkpoint
and rebuild the mesh without the slow host (see ft/supervisor + elastic
restore).  In a single-process run this is exercised by the tests with
synthetic timings.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple


@dataclasses.dataclass
class StragglerMonitor:
    window: int = 50
    threshold: float = 1.8      # step flagged when > threshold * median
    patience: int = 5           # consecutive flags before mitigation

    def __post_init__(self):
        self._times: Deque[float] = deque(maxlen=self.window)
        self._flags: List[Tuple[int, float]] = []
        self._consecutive = 0

    def record(self, step: int, seconds: float) -> bool:
        """Returns True when this step is flagged as a straggler."""
        med = self.median()
        self._times.append(seconds)
        if med is None or len(self._times) < 8:
            return False
        flagged = seconds > self.threshold * med
        if flagged:
            self._flags.append((step, seconds))
            self._consecutive += 1
        else:
            self._consecutive = 0
        return flagged

    def median(self) -> Optional[float]:
        if not self._times:
            return None
        s = sorted(self._times)
        return s[len(s) // 2]

    @property
    def flags(self) -> List[Tuple[int, float]]:
        return list(self._flags)

    def should_mitigate(self) -> bool:
        """True after ``patience`` consecutive slow steps — the caller should
        checkpoint and re-form the mesh without the slow participant."""
        return self._consecutive >= self.patience
