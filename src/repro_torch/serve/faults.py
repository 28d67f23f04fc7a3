"""Deterministic fault injection for the serving tier (a copy of
``repro/serve/faults.py``, which imports no JAX).

A seeded :class:`FaultSchedule` decides — reproducibly — whether each visit
to a named injection point raises an :class:`InjectedFault`.  The points
the port's scheduler/engine/pager path visits:

    ``page_alloc``     PagePool.alloc, before a page leaves the free stack
    ``prefill_chunk``  ServeEngine.prefill_chunk_step, before the chunk
    ``admit``          ServeEngine.admit / admit_paged, before the splice
    ``cow_copy``       ServeEngine.copy_page, before the copy
    ``decode_step``    RequestScheduler decode loop, before the step
    ``nan_logits``     after decode: corrupt one live row's logits
    ``prefix_resume``  ServeEngine.start_prefill, on the prefix-hit branch
    ``host_fetch``     TieredPagePool.begin_fetch, before the host -> device
                       copy (the page stays cold)
    ``spill``          TieredPagePool.begin_spill, before the device -> host
                       copy (the page stays hot)
    ``park``           ServeEngine.detach_slot, before the snapshot read
    ``resume``         ServeEngine.attach_slot, before the splice
    ``draft_verify``   RequestScheduler speculative loop, before the verify
                       window's forward — the cache is still whole and
                       drafting is pure host work, so the whole round
                       retries like a ``decode_step`` fault

The two preemption points follow the same placement rule: a ``park``
fault fires before any state is touched, so the victim simply stays
resident (the preemption is retried on a later step); a ``resume`` fault
fires before the parked snapshot is spliced back, so the parked record is
still whole — the scheduler releases its held pages and routes the request
through the standard retry/FAIL policy (restart from scratch).

Placement rule that makes injected faults *retryable*: every point fires
BEFORE the call that changes the cache, so the arena, the page tables and
the prefill task are still whole when the fault propagates.

Two scheduling modes, combinable per point:

* ``at={"point": {3, 7}}`` — fire on those 0-based visit occurrences
  (exact-step chaos regressions);
* ``rates={"point": 0.05}`` — fire each visit with that probability from a
  ``numpy`` Generator seeded at construction (randomized sweeps; the seed
  makes any failing sweep replayable).

Disabled cost: the module-level ``maybe_fault`` is a single ``is None``
check, and ``core.pager`` only calls through ``_fault_hook`` when
:func:`install` has wired it — the pager never imports this module (that
import would be cyclic through ``serve.__init__``).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np


class InjectedFault(RuntimeError):
    """A deliberately injected fault.  ``transient=True``: the same visit
    will not re-fire on retry (occurrence counters advance), which is what
    lets bounded retry drain a finite schedule."""

    transient = True

    def __init__(self, point: str, occurrence: int):
        super().__init__(f"injected fault at {point}#{occurrence}")
        self.point = point
        self.occurrence = occurrence


class FaultSchedule:
    """Seeded, replayable decision source for every injection point."""

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 at: Optional[Dict[str, Iterable[int]]] = None):
        self.seed = seed
        self.rates = dict(rates or {})
        self.at = {k: frozenset(v) for k, v in (at or {}).items()}
        self._rng = np.random.default_rng(seed)
        self._visits: Dict[str, int] = {}
        self.log: list = []          # (point, occurrence) of every firing

    def _should_fire(self, point: str) -> Optional[int]:
        n = self._visits.get(point, 0)
        self._visits[point] = n + 1
        if n in self.at.get(point, ()):  # frozenset lookup
            return n
        rate = self.rates.get(point, 0.0)
        # draw only for rate-scheduled points so exact-occurrence runs stay
        # bit-identical regardless of which rates dict accompanies them
        if rate > 0.0 and self._rng.random() < rate:
            return n
        return None

    def visit(self, point: str) -> None:
        """Raise InjectedFault if this visit is scheduled to fail."""
        n = self._should_fire(point)
        if n is not None:
            self.log.append((point, n))
            raise InjectedFault(point, n)

    def pick(self, point: str, n: int) -> Optional[int]:
        """Like visit, but instead of raising returns a deterministic index
        in [0, n) when firing (used by ``nan_logits`` to choose the victim
        row), else None."""
        occ = self._should_fire(point)
        if occ is None or n <= 0:
            return None
        self.log.append((point, occ))
        return int(self._rng.integers(n)) if n > 1 else 0


_ACTIVE: Optional[FaultSchedule] = None


def maybe_fault(point: str) -> None:
    """Hot-path hook: no-op (one None check) unless a schedule is active."""
    if _ACTIVE is not None:
        _ACTIVE.visit(point)


def maybe_pick(point: str, n: int) -> Optional[int]:
    if _ACTIVE is not None:
        return _ACTIVE.pick(point, n)
    return None


def install(schedule: Optional[FaultSchedule]) -> None:
    """Activate ``schedule`` globally (None deactivates) and wire/unwire
    the pager's import-cycle-free callback."""
    global _ACTIVE
    _ACTIVE = schedule
    from repro_torch.core import pager
    pager._fault_hook = maybe_fault if schedule is not None else None


def active() -> Optional[FaultSchedule]:
    return _ACTIVE


class injected:
    """Context manager: ``with faults.injected(FaultSchedule(...)):``."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule

    def __enter__(self) -> FaultSchedule:
        install(self.schedule)
        return self.schedule

    def __exit__(self, *exc) -> None:
        install(None)
