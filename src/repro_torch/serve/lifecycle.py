"""Request lifecycle: the terminal state machine of one serving request
(a copy of ``repro/serve/lifecycle.py``, which imports no JAX).

Every request moves through

    QUEUED -> PREFILLING -> DECODING -> DONE
                 |    \\      ^ |  \\
                 |     \\     | v    \\
                 |      \\  PARKED ---+--> FAILED / CANCELLED / TIMED_OUT
                 |       `------+----+     (terminal)
                 `<-------------'
            (retry / evict-to-requeue / parked-page reclaim: back to QUEUED)

PARKED is the non-terminal preemption state: a DECODING resident
displaced by a higher priority class gives up its batch slot but KEEPS its
pages (refcounts held, page-table row detached into a parked record).
Resume re-attaches the row and the per-slot window snapshot and continues
DECODING token-exact — no re-prefill.  A parked request can still be
cancelled, time out, or fail (resume fault), and under page pressure its
pages can be reclaimed destructively, sending it back to QUEUED like an
evict-to-requeue.

and the scheduler only ever mutates that state through :func:`transition`,
which validates the move against :data:`_ALLOWED` — an illegal transition
(double-finish, resurrecting a terminal request, skipping teardown) raises
:class:`LifecycleError` instead of silently corrupting the arena.  The four
terminal states are frozen: once a request is DONE / FAILED / CANCELLED /
TIMED_OUT it never changes again, and its ``error`` field (for the three
failure flavors) records why.

Why a typed state machine instead of the old ``result is not None`` flag:
fault isolation needs one idempotent teardown path shared by faults,
deadlines, cancellation and eviction, and that path needs to know — cheaply
and unambiguously — whether a request still owns pages/slots/pins.  The
state IS that ownership ledger's key.

Backpressure errors also live here (:class:`QueueFull`) so clients can
catch one typed exception family (:class:`ServingError`) for everything the
serving tier throws at them on purpose.
"""
from __future__ import annotations

import enum
from typing import Optional


class RequestState(enum.Enum):
    """One serving request's lifecycle state (terminal ones are frozen)."""

    QUEUED = "queued"            # in the pending queue (incl. retry/evict)
    PREFILLING = "prefilling"    # reserved pages/slot, chunk loop running
    DECODING = "decoding"        # resident in the slot arena
    PARKED = "parked"            # preempted; pages held, slot released
    DONE = "done"                # full budget generated, result delivered
    FAILED = "failed"            # a per-request fault exhausted its retries
    CANCELLED = "cancelled"      # client cancel() honored at a safe point
    TIMED_OUT = "timed_out"      # request_timeout_steps deadline expired

    @property
    def terminal(self) -> bool:
        return self in _TERMINAL


_TERMINAL = frozenset((RequestState.DONE, RequestState.FAILED,
                       RequestState.CANCELLED, RequestState.TIMED_OUT))

# legal moves; QUEUED -> QUEUED is the (no-op) retry requeue of a request
# that faulted before its reservation finished.
_ALLOWED = {
    RequestState.QUEUED: frozenset((
        RequestState.QUEUED, RequestState.PREFILLING, RequestState.FAILED,
        RequestState.CANCELLED, RequestState.TIMED_OUT)),
    RequestState.PREFILLING: frozenset((
        RequestState.DECODING, RequestState.QUEUED, RequestState.FAILED,
        RequestState.CANCELLED, RequestState.TIMED_OUT)),
    RequestState.DECODING: frozenset((
        RequestState.DONE, RequestState.QUEUED, RequestState.PARKED,
        RequestState.FAILED, RequestState.CANCELLED,
        RequestState.TIMED_OUT)),
    RequestState.PARKED: frozenset((
        RequestState.DECODING, RequestState.QUEUED, RequestState.FAILED,
        RequestState.CANCELLED, RequestState.TIMED_OUT)),
    RequestState.DONE: frozenset(),
    RequestState.FAILED: frozenset(),
    RequestState.CANCELLED: frozenset(),
    RequestState.TIMED_OUT: frozenset(),
}


class ServingError(RuntimeError):
    """Base of every typed error the serving tier raises on purpose."""


class LifecycleError(ServingError):
    """Illegal request-state transition (a scheduler bug, not user error)."""


class QueueFull(ServingError):
    """Bounded-queue backpressure: ``submit`` rejected the request.

    Raised when ``ServeConfig.max_queue`` > 0, the pending queue is at
    capacity, and ``queue_policy`` is "reject" (with "shed-oldest" the
    OLDEST pending request is cancelled instead and the new one accepted).
    """


class NanLogitsError(ServingError):
    """Decode/prefill sampling saw non-finite logits or an out-of-vocab
    token for this request's row.  Transient by policy: an injected or
    hardware-flake NaN goes away on retry; a deterministic model NaN fails
    again and exhausts the retry budget into FAILED."""

    transient = True


class RequestTimeout(ServingError):
    """The per-request deadline (``request_timeout_steps``) expired."""


class RequestCancelled(ServingError):
    """The client called ``Request.cancel()``."""


def transition(req, new: RequestState,
               error: Optional[BaseException] = None) -> None:
    """Validated state move; records ``error`` on failure-flavored states.

    Idempotence guard: moving a terminal request anywhere (including to
    its own state) raises — teardown must check ``req.state.terminal``
    first, which is what makes the teardown path safely re-enterable.
    """
    cur = req.state
    if new not in _ALLOWED[cur]:
        raise LifecycleError(
            f"req {req.req_id}: illegal transition {cur.value} -> "
            f"{new.value}")
    req.state = new
    if error is not None:
        req.error = error
