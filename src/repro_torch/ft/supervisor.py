"""Fault-tolerance supervisor: checkpoint/restart with bounded retries (a
copy of ``repro/ft/supervisor.py``, which the port may not import; it
reads the port's checkpoint store).

At 1000+ nodes some host *will* fail mid-run; the recovery contract here is

  1. training checkpoints atomically every N steps (checkpoint/store.py),
  2. the supervisor catches the failure, reloads the LATEST complete
     checkpoint, and re-enters the loop at that step,
  3. data order is deterministic per (seed, step) (data/corpus.py), so the
     replayed steps are bit-identical and no batch is skipped or repeated.

Nothing in a checkpoint refers to the devices that wrote it: restore
copies into whatever tensors the restoring job built.
"""
from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Any, Callable, Optional

from repro_torch import checkpoint as ckpt


class RestartsExhausted(RuntimeError):
    """The supervisor's retry budget ran out; ``__cause__`` is the last
    worker fault."""


@dataclasses.dataclass
class Supervisor:
    """Retry policy around a resumable unit of work.

    Backoff is exponential with a cap: retry ``i`` sleeps
    ``min(backoff_s · 2^(i-1), backoff_cap_s)`` — linear backoff recovers
    too slowly from short blips and hammers shared storage on long ones.
    """

    max_restarts: int = 3
    backoff_s: float = 0.0
    backoff_cap_s: float = 60.0
    log: Callable = print

    restarts: int = 0

    def run(self, work: Callable[[Optional[int]], Any],
            resume: Optional[Callable[[], Optional[int]]] = None) -> Any:
        """``work(resume_step)`` runs until done or raises.

        The first attempt gets ``resume_step=None`` (fresh start).  On an
        exception the supervisor retries up to ``max_restarts`` times,
        passing the RESTORED STEP through: ``resume()`` is consulted per
        retry (e.g. ``lambda: latest_step(dir)``) so work doesn't have to
        re-derive where to restart; without a ``resume`` callable retries
        also get None and work re-reads the store itself.  Exhaustion
        raises :class:`RestartsExhausted` from the last worker fault.
        """
        attempt = 0
        while True:
            try:
                if attempt == 0:
                    return work(None)
                return work(resume() if resume is not None else None)
            except KeyboardInterrupt:
                raise
            except Exception as exc:  # noqa: BLE001 — worker faults retry
                attempt += 1
                self.restarts = attempt
                self.log(f"[supervisor] attempt {attempt} failed:\n"
                         f"{traceback.format_exc(limit=3)}")
                if attempt > self.max_restarts:
                    raise RestartsExhausted(
                        f"gave up after {self.max_restarts} restarts"
                    ) from exc
                if self.backoff_s:
                    time.sleep(min(self.backoff_s * 2 ** (attempt - 1),
                                   self.backoff_cap_s))


def run_with_restarts(train_once: Callable[[int], Any], ckpt_dir: str,
                      max_restarts: int = 3, log: Callable = print) -> Any:
    """Convenience wrapper: ``train_once(start_step)`` resumes from the
    newest complete checkpoint after each crash."""
    sup = Supervisor(max_restarts=max_restarts, log=log)

    def work(resume_step):
        start = resume_step if resume_step is not None else 0
        if resume_step is not None:
            log(f"[supervisor] resuming from step {start}")
        return train_once(start)

    return sup.run(work, resume=lambda: ckpt.latest_step(ckpt_dir) or 0)
