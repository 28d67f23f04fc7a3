"""Request scheduler: continuous batching with decode-interleaved chunked
prefill over the engine's slot arena, and static batching (port of
``repro/serve/scheduler.py``).

The batch axis is a SLOT ARENA.  Each loop iteration first spends at most
``ServeConfig.prefill_token_budget`` tokens (whole chunks, at least one)
advancing the head-of-queue request's CHUNKED prefill
(``engine.prefill_chunk_step``), admits it into a free slot the moment its
prompt completes (``engine.admit`` / ``engine.admit_paged``), then runs ONE
ragged decode step for the whole arena.  Resident sequences never stall
behind an arriving prompt for more than the budget; a finished request's
slot is recycled immediately.

PAGED mode (``ServeConfig.page_size > 0``): the SALS segments live in a
refcounted page pool (``core/pager.py``) and this scheduler is its memory
manager:

  * admission is a PAGE RESERVATION — a request is admitted when the pool
    has pages for its prompt (suffix); on shortfall it stalls at the head
    of the queue (``admission_stalls``) after LRU prefix-cache entries
    have been evicted;
  * prompts sharing a registered prefix map their leading page-table
    entries to the SAME physical pages (``prefix_hits``) and resume their
    chunked prefill at the page boundary;
  * decode growth allocates one page per ``page_size`` generated tokens; a
    write landing on a still-shared page triggers copy-on-write
    (``cow_copies``);
  * pool exhaustion mid-decode evicts the resident that could not map its
    write page back onto the queue head (``evictions``; greedy decoding
    makes the re-run token-identical);
  * every decode step appends a row to ``pool_gauges``.

FAULT TOLERANCE.  Every request carries the state machine of
``serve/lifecycle.py`` (QUEUED → PREFILLING → DECODING → {DONE, FAILED,
CANCELLED, TIMED_OUT}).  A fault in one request's prefill chunk, admission,
page upkeep or logits fails that request only, through one teardown;
transient faults requeue it with exponential backoff in scheduler steps up
to ``max_request_retries``; step and wall-clock deadlines and
``Request.cancel()`` go through the same teardown; ``max_queue`` bounds
the pending queue ("reject" raises ``QueueFull``, "shed-oldest" cancels a
pending request); ``audit_serving_state()`` proves page conservation and
slot↔state coherence, every ``audit_every`` steps and on every teardown
when auditing is on.  ``Request.on_token`` streams each token the step it
commits.

SPECULATIVE DECODING (``ServeConfig.spec_window`` = Q > 1): the arena's
decode step becomes a VERIFY WINDOW — each resident's pending token plus
Q−1 prompt-lookup drafts (``serve/draft.py``, per-slot ``_Slot.drafter``,
rebuilt from prompt + output on every admission) run through one windowed
forward (``engine.decode_window``: one latent selection per SALS layer,
each selected token reconstructed once for the window); greedy verify
keeps each row's longest matching draft prefix plus the model's own next
token, and the masked ``engine.commit_window`` writes only those
positions.  Paged rows map (and copy-on-write) every page the commit span
min(Q, tokens left) can touch before the round.  ``on_token`` fires once
per ACCEPTED token with contiguous indices; the ``draft_verify`` fault
point fires before the window's forward, so the round retries like a
``decode_step`` fault.  Counters: ``spec_rounds`` / ``spec_proposed`` /
``spec_accepted`` / ``spec_committed``.

TWO-TIER pool (``ServeConfig.hbm_pages`` > 0, paged only): the pool is a
:class:`~repro_torch.core.tiering.TieredPagePool` — live-page capacity
stays ``pool_pages`` while only ``hbm_pages`` payload slots live on the
device; the r* score pool keeps every live page resident, so selection
always runs on true data:

  * each resident's WRITE page is pinned hot (a growth page takes a slot
    at once; a write into a spilled page fetches it);
  * before each step the previous step's selected pages are fetched hot
    (``tier_prefetch``: the paper's step-to-step selection stability);
  * FETCH-AND-RERUN: the step runs with selection collection; if any
    selected page was cold (its reconstruction read the trash slot), the
    scheduler fetches it and reruns the SAME step.  Every cache write is
    a set at a fixed position, so the final run leaves the bytes and the
    logits of an all-resident step;
  * a slot is found by spilling the least recently touched unpinned hot
    page to a host mirror;
  * when a row's working set (pins + this step's pages) cannot fit the
    hot tier (:class:`~repro_torch.core.tiering.HotTierThrash`), the
    scheduler sheds LOAD, not the request: the row evicts itself to the
    queue head (``shed_thrash``); a sole thrashing resident fails through
    the retry budget;
  * counters ``spills`` (on the pool), ``fetch_hits``, ``prefetch_hits``,
    ``cold_misses``; ``host_pages`` rides on ``pool_gauges``; the audit
    checks tier conservation.

SLO SCHEDULING.  The front door is not plain FIFO:

  * PRIORITY CLASSES — ``Request.priority`` in [0, priority_classes);
    admission serves the highest eligible class first, and with
    ``preempt_policy != "none"`` a strictly higher waiting class preempts
    the lowest-priority (most recently admitted) resident when no slot is
    free.  Under ``"park"`` the victim keeps its PAGES: its per-slot state
    goes to host memory (``engine.detach_slot``), its page table moves
    into a parked record (refcounts held), and resume writes the snapshot
    back into any free slot (``engine.attach_slot``, in place) and goes on
    DECODING token-exact with no re-prefill.  Under tiering a park drops
    the write pin and spills exclusively-parked pages cold, so the
    preemption frees hot slots.  ``"evict"`` requeues the victim, which
    re-prefills.  A page-stalled admission may reclaim a
    strictly-lower-priority parked victim's pages (a destructive requeue).
  * TENANT FAIRNESS — ``Request.tenant_id`` keys deficit-round-robin
    admission WITHIN a priority class (``tenant_quantum`` tokens per
    rotation turn; a request costs prompt + budget tokens), plus optional
    per-tenant token-rate credits (``tenant_rate`` per iteration, debited
    at admission) and in-flight caps (``tenant_max_inflight``).
    ``tenant_gauges`` holds per-tenant starvation counters, LRU-capped by
    ``gauge_history``.
  * SAMPLING — at ``temperature`` > 0 the admission and decode sample
    points draw from the engine's generator, reseeded at the start of
    every run; an evict-to-requeue then warns, because the re-run
    resamples.

TELEMETRY (``repro_torch.obs``).  The public counters (``prefix_hits``,
``failures``, ``parks``, ...) are views over a metrics registry
(``_CounterView``): the one installed by ``obs.enable`` when there is one
at construction, else a private registry.  With a tracer installed each
request's track carries its lifecycle phases (``queue_wait``, ``prefill``,
``decode``, ``parked``, then ``teardown``), and the ``scheduler`` track
its work (``prefill_chunk``, ``decode_step`` / ``verify_window``,
``tier_fetch`` / ``tier_spill`` with their bytes, and the phases of each
iteration of the continuous loop, ``obs/trace.py``'s ``STEP_SPANS``, each
with the iteration's ``step`` and its ordinal ``it``: ``sweep``,
``admit``, ``page_upkeep``, and ``decode_commit`` inside
``decode_step``).  With a traffic
accountant installed every committed decode step and verify round is
reconciled against the byte ledger at the rows' host-side positions, and
every page transfer at its mirror's bytes.  Every hook is host code
around the engine's step programs, so each one fires on every replay of a
captured step; disabled, each costs one ``is None`` check.

STATIC mode (``mode="static"``, the GPT-fast-style baseline the paper's
throughput claim is measured against): the queue is sorted by prompt
length and drained in fixed batches of ``max_batch`` back to back, each
through :meth:`~ServeEngine.generate` (:meth:`~ServeEngine.
generate_speculative` when ``spec_window`` > 1).  Cancellations requested
before a batch starts are honoured; states move QUEUED → PREFILLING →
DECODING → DONE around each batch, and ``run(on_batch=...)`` fires after
each.  It needs the dense arena (paged + static is refused).  It is
also the mode of every scheduler over a recurrent family (ssm, hybrid:
``ServeEngine.ragged_ok`` is False), whatever mode was asked for.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.pager import (PagePool, PageTable, PrefixIndex,
                                    audit_pager, PagerInvariantError)
from repro_torch.core.tiering import HotTierThrash, TieredPagePool
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs import traffic as obs_traffic
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import faults
from repro_torch.serve.draft import NgramDrafter
from repro_torch.serve.engine import GenerationResult, PrefillTask, ServeEngine
from repro_torch.serve.lifecycle import (NanLogitsError, QueueFull,
                                         RequestCancelled, RequestState,
                                         RequestTimeout, transition)

_req_ids = itertools.count()
_NO_SPAN = contextlib.nullcontext()     # a step span with tracing off


@dataclasses.dataclass
class Request:
    prompt: np.ndarray
    max_new_tokens: int = 32
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    result: Optional[GenerationResult] = None
    state: RequestState = RequestState.QUEUED
    error: Optional[BaseException] = None
    timeout_steps: Optional[int] = None   # None = ServeConfig default
    timeout_ms: Optional[float] = None    # None = ServeConfig default
    retries: int = 0                      # transient-fault retries consumed
    deadline_step: Optional[int] = None   # set at submit
    deadline_time: Optional[float] = None  # wall-clock deadline
    not_before_step: int = 0              # retry backoff gate
    cancel_requested: bool = False
    priority: int = 0                     # class index; higher = urgent
    tenant_id: str = "default"            # fairness / rate-limit key
    # called as on_token(token_id, index) the step each token commits
    # (index 0 = the first token, emitted at admission); re-emitted from 0
    # after an evict-to-requeue or a retry, never after a park/resume.  A
    # raising callback fails THIS request.
    on_token: Optional[Callable[[int, int], None]] = None
    submit_step: Optional[int] = None
    attempts: int = 0                     # times prefill started
    parks: int = 0                        # times preempt-parked

    def cancel(self) -> None:
        """Client cancellation, honored at the next step boundary."""
        self.cancel_requested = True

    @property
    def done(self) -> bool:
        return self.state is RequestState.DONE

    @property
    def finished(self) -> bool:
        return self.state.terminal


@dataclasses.dataclass
class _Slot:
    """One resident sequence of the continuous batch."""
    req: Request
    out: List[int]                 # generated token ids so far
    seq: int = 0                   # admission order (preemption tie-break)
    # speculative decoding: prompt-lookup draft state, built from prompt +
    # out at every admission (evictions and retries need no bookkeeping)
    drafter: Optional[NgramDrafter] = None


@dataclasses.dataclass
class _Admission:
    """Head-of-queue request being chunk-prefilled into a reserved slot.
    Paged: ``ptab`` is its page reservation (shared prefix pages + fresh
    suffix pages) and ``shared_pages`` how many came from ``entry``."""
    req: Request
    slot: int
    task: PrefillTask
    ptab: Optional[PageTable] = None
    shared_pages: int = 0
    entry: object = None


@dataclasses.dataclass
class _Parked:
    """A preempt-parked resident: everything needed to resume DECODING
    token-exact in any free slot.  The record OWNS the request's page
    table — refcounts stay held across the park, so resume is a window
    splice, not a re-prefill."""
    req: Request
    out: List[int]                 # tokens committed before the park
    position: int                  # next decode position
    ptab: PageTable                # held pages (ownership moved from slot)
    snapshot: dict                 # engine.detach_slot host snapshot
    parked_step: int               # FIFO resume order within a class


class _CounterView:
    """A public int counter (``sched.prefix_hits`` et al.) that is a thin
    view over the scheduler's :class:`~repro_torch.obs.metrics.
    MetricsRegistry`: reads and ``+= 1`` writes behave as plain ints did,
    and the registry is the single store, so the exporters can never
    disagree with the public fields."""

    __slots__ = ("metric",)

    def __init__(self, metric: str):
        self.metric = metric

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return int(obj.metrics.counter(self.metric).value())

    def __set__(self, obj, value):
        obj.metrics.counter(self.metric).set_to(float(value))


class RequestScheduler:
    """Continuous-batching scheduler over ``engine``'s slot arena.

    Ledgers the tests read: ``admissions`` — (decode step, slot, req_id)
    per admission; ``prefill_chunks`` — (decode step, req_id, chunk index,
    n_resident) per chunk run; ``pool_gauges`` — one row per decode step
    (paged)."""

    # the public counters, each a view over the metrics registry
    prefix_hits = _CounterView("serve_prefix_hits_total")
    cow_copies = _CounterView("serve_cow_copies_total")
    admission_stalls = _CounterView("serve_admission_stalls_total")
    evictions = _CounterView("serve_evictions_total")
    failures = _CounterView("serve_requests_failed_total")
    timeouts = _CounterView("serve_requests_timed_out_total")
    cancellations = _CounterView("serve_requests_cancelled_total")
    retries = _CounterView("serve_retries_total")
    step_faults = _CounterView("serve_step_faults_total")
    shed = _CounterView("serve_shed_total")
    fetch_hits = _CounterView("serve_fetch_hits_total")
    prefetch_hits = _CounterView("serve_prefetch_hits_total")
    cold_misses = _CounterView("serve_cold_misses_total")
    spec_rounds = _CounterView("serve_spec_rounds_total")
    spec_proposed = _CounterView("serve_spec_proposed_total")
    spec_accepted = _CounterView("serve_spec_accepted_total")
    spec_committed = _CounterView("serve_spec_committed_total")
    parks = _CounterView("serve_parks_total")
    resumes = _CounterView("serve_resumes_total")
    preemptions = _CounterView("serve_preemptions_total")
    submitted = _CounterView("serve_requests_submitted_total")
    done = _CounterView("serve_requests_done_total")

    def __init__(self, engine: ServeEngine, max_batch: Optional[int] = None,
                 mode: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None):
        """``max_batch`` (default the engine's ``scfg.max_batch``) is the
        static mode's batch; continuous mode batches over the engine's slot
        arena and refuses another value when it runs."""
        scfg = engine.scfg
        self.max_batch = max_batch or scfg.max_batch
        mode = mode or scfg.scheduler
        if mode not in ("continuous", "static"):
            raise ValueError(f"unknown scheduler mode {mode!r}")
        if not engine.ragged_ok:
            mode = "static"        # recurrent state can't right-pad or chunk
        if engine.paged and mode != "continuous":
            raise ValueError("the paged latent cache requires the "
                             "continuous scheduler (admission = page "
                             "reservation)")
        self.engine = engine
        self.mode = mode
        # source of request_timeout_ms deadlines; tests inject a fake one
        self._clock: Callable[[], float] = clock or time.monotonic
        self.pending: collections.deque = collections.deque()
        self.completed: Dict[int, Request] = {}
        hist = scfg.gauge_history or None
        self.admissions: collections.deque = collections.deque(maxlen=hist)
        self.prefill_chunks: collections.deque = collections.deque(
            maxlen=hist)
        self.pool_gauges: collections.deque = collections.deque(maxlen=hist)
        self.steps = 0
        # the registry behind every public counter: the installed one
        # (``obs.enable``), so exporters see this scheduler, else a private
        # one; label sets share the gauge_history cap.  Gauges are
        # published only to an installed registry (someone is scraping).
        self.metrics: MetricsRegistry = (
            obs_metrics.active() or MetricsRegistry(max_series=hist or 0))
        self._metrics_installed = obs_metrics.active() is not None
        self.tracer = obs_trace.active()        # None = spans disabled
        self.traffic = obs_traffic.active()     # None = no byte accounting
        for view in (
                "prefix_hits",       # admissions reusing prefix pages
                "cow_copies",        # copy-on-write page duplicates
                "admission_stalls",  # sweeps blocked on pages
                "evictions",         # evict-to-requeue events
                "failures",          # requests ending FAILED
                "timeouts",          # requests ending TIMED_OUT
                "cancellations",     # requests ending CANCELLED
                "retries",           # transient requeues granted
                "step_faults",       # batch-wide decode retries
                "shed",              # queue-policy sheds
                "fetch_hits",        # touched pages already hot
                "prefetch_hits",     # ... warmed by the prefetcher
                "cold_misses",       # demand host -> device fetches
                "spec_rounds",       # verify windows executed
                "spec_proposed",     # draft tokens proposed
                "spec_accepted",     # draft tokens accepted
                "spec_committed",    # tokens committed through windows
                "parks",             # preempt-park events
                "resumes",           # successful park resumes
                "preemptions",       # park + evict preemptions
                # submitted == done + failures + timeouts + cancellations
                # once drained
                "submitted", "done"):
            setattr(self, view, 0)
        self.parked: List[_Parked] = []          # live parked records
        # per-tenant starvation / fairness gauges (see _tenant_gauge),
        # insertion-ordered for the gauge_history LRU cap
        self.tenant_gauges: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._drr_rot: Dict[int, List[str]] = {}      # DRR rotation / class
        self._drr_deficit: Dict[int, Dict[str, float]] = {}
        self._rate_credit: Dict[str, float] = {}      # tenant token credit
        self.paged = engine.paged
        self.tiered = engine.tiered
        self.pool: Optional[PagePool] = None
        self.prefix_index: Optional[PrefixIndex] = None
        if self.tiered:
            # +1 / n_reserved=1: physical page 0 is the trash page
            self.pool = TieredPagePool(scfg.pool_pages + 1, scfg.page_size,
                                       hbm_slots=scfg.hbm_pages,
                                       n_reserved=1)
        elif self.paged:
            self.pool = PagePool(scfg.pool_pages + 1, scfg.page_size,
                                 n_reserved=1)
        if self.paged and scfg.prefix_cache:
            self.prefix_index = PrefixIndex(self.pool)
        if self.paged and self.traffic is not None:
            self.traffic.bind_page_size(scfg.page_size)
        # live loop state, mirrored so audit_serving_state sees it mid-run
        self._slots: List[Optional[_Slot]] = []
        self._tables: List[Optional[PageTable]] = []
        self._active: Optional[_Admission] = None

    def submit(self, req: Request) -> int:
        scfg = self.engine.scfg
        if req.max_new_tokens < 1:
            raise ValueError(f"req {req.req_id}: max_new_tokens must be >= 1 "
                             "(prefill always emits the first token)")
        if len(req.prompt) + req.max_new_tokens > scfg.max_seq_len:
            raise ValueError(
                f"req {req.req_id}: prompt {len(req.prompt)} + new "
                f"{req.max_new_tokens} exceeds max_seq {scfg.max_seq_len}")
        if self.paged:
            need = -(-(len(req.prompt) + req.max_new_tokens)
                     // scfg.page_size)
            if need > scfg.pool_pages:
                raise ValueError(
                    f"req {req.req_id}: needs {need} pages at its longest; "
                    f"the pool has {scfg.pool_pages}")
        if not 0 <= req.priority < scfg.priority_classes:
            raise ValueError(
                f"req {req.req_id}: priority {req.priority} outside "
                f"[0, {scfg.priority_classes})")
        if scfg.max_queue and len(self.pending) >= scfg.max_queue:
            if scfg.queue_policy == "reject":
                raise QueueFull(
                    f"pending queue at max_queue={scfg.max_queue}")
            idx = self._shed_victim_index()
            victim = self.pending[idx]
            del self.pending[idx]
            self._terminate(victim, RequestState.CANCELLED,
                            QueueFull("shed for newer request"))
            self.shed += 1
        timeout = (req.timeout_steps if req.timeout_steps is not None
                   else scfg.request_timeout_steps)
        if timeout:
            req.deadline_step = self.steps + timeout
        timeout_ms = (req.timeout_ms if req.timeout_ms is not None
                      else scfg.request_timeout_ms)
        if timeout_ms:
            req.deadline_time = self._clock() + timeout_ms / 1000.0
        req.submit_step = self.steps
        self._tenant_gauge(req.tenant_id)["submitted"] += 1
        self.submitted += 1
        if self.tracer is not None:
            self.tracer.begin("queue_wait", f"req{req.req_id}",
                              tenant=req.tenant_id, priority=req.priority)
        self.pending.append(req)
        return req.req_id

    def _shed_victim_index(self) -> int:
        """shed-oldest victim: the oldest cancel-requested pending request,
        else the oldest never-started one, else the oldest."""
        for idx, r in enumerate(self.pending):
            if r.cancel_requested:
                return idx
        for idx, r in enumerate(self.pending):
            if r.attempts == 0 and r.retries == 0:
                return idx
        return 0

    # ----------------------------------------------------------- lifecycle

    def _trace_phase(self, req: Request, name: str, **args) -> None:
        """Move ``req`` to lifecycle phase ``name`` on its trace track.  A
        request has AT MOST ONE open span, its current phase, so closing
        the previous one first keeps begin/end balanced through every
        teardown, retry, eviction and park.  No-op when tracing is off."""
        tr = self.tracer
        if tr is not None:
            track = f"req{req.req_id}"
            tr.end_track(track)
            tr.begin(name, track, **args)

    def _terminate(self, req: Request, state: RequestState,
                   error: Optional[BaseException] = None,
                   issued: Optional[List[Request]] = None,
                   partial: Optional[tuple] = None) -> None:
        """Move ``req`` to a terminal state (its resources are already
        released).  ``partial`` (tokens so far, prompt_len) of a streaming
        request dying mid-decode becomes a ``complete=False`` result."""
        transition(req, state, error)
        if state is RequestState.FAILED:
            self.failures += 1
        elif state is RequestState.TIMED_OUT:
            self.timeouts += 1
        elif state is RequestState.CANCELLED:
            self.cancellations += 1
        elif state is RequestState.DONE:
            self.done += 1
        if self.tracer is not None:
            # close whatever phase was open (teardown may come from any),
            # then record the teardown itself
            track = f"req{req.req_id}"
            self.tracer.end_track(track)
            self.tracer.end(self.tracer.begin("teardown", track,
                                              state=state.name))
        if partial is not None and state is not RequestState.DONE \
                and req.on_token is not None \
                and req.result is None and partial[0]:
            toks, plen = partial
            req.result = GenerationResult(np.asarray(toks, np.int32), plen,
                                          len(toks), complete=False)
        self.completed[req.req_id] = req
        if issued is not None:
            issued.append(req)

    def _backoff(self, retries: int) -> int:
        scfg = self.engine.scfg
        return min(scfg.retry_backoff_steps * (2 ** max(0, retries - 1)),
                   scfg.retry_backoff_cap_steps)

    def _fail_or_retry(self, req: Request, exc: BaseException,
                       issued: List[Request],
                       partial: Optional[tuple] = None) -> None:
        """Transient faults requeue with exponential backoff (in steps)
        while the retry budget lasts; anything else FAILS the request.  A
        backoff gate at or past the request's deadline fails fast as
        TIMED_OUT, the fault chained as ``__cause__``."""
        scfg = self.engine.scfg
        if getattr(exc, "transient", False) \
                and req.retries < scfg.max_request_retries:
            gate = self.steps + self._backoff(req.retries + 1)
            if req.deadline_step is not None and gate >= req.deadline_step:
                err = RequestTimeout(
                    f"req {req.req_id}: retry backoff gate (step {gate}) "
                    f"cannot beat deadline step {req.deadline_step}")
                err.__cause__ = exc
                self._terminate(req, RequestState.TIMED_OUT, err, issued,
                                partial=partial)
                return
            req.retries += 1
            req.not_before_step = gate
            transition(req, RequestState.QUEUED)
            self.retries += 1
            self._trace_phase(req, "queue_wait", retry=req.retries)
            self.pending.append(req)
        else:
            self._terminate(req, RequestState.FAILED, exc, issued,
                            partial=partial)

    def _overdue(self, req: Request) -> Optional[RequestState]:
        if req.cancel_requested:
            return RequestState.CANCELLED
        if req.deadline_step is not None and self.steps >= req.deadline_step:
            return RequestState.TIMED_OUT
        if req.deadline_time is not None \
                and self._clock() >= req.deadline_time:
            return RequestState.TIMED_OUT
        return None

    def _overdue_error(self, req: Request, state: RequestState):
        if state is RequestState.CANCELLED:
            return RequestCancelled(f"req {req.req_id} cancelled")
        if req.deadline_step is not None and self.steps >= req.deadline_step:
            return RequestTimeout(f"req {req.req_id} missed deadline step "
                                  f"{req.deadline_step}")
        ms = (req.timeout_ms if req.timeout_ms is not None
              else self.engine.scfg.request_timeout_ms)
        return RequestTimeout(
            f"req {req.req_id} missed wall-clock deadline ({ms:g} ms)")

    # ------------------------------------------------------ tenant fairness

    @staticmethod
    def _cost(req: Request) -> int:
        """A request's admission cost in tokens: prompt + decode budget."""
        return len(req.prompt) + req.max_new_tokens

    def _tenant_gauge(self, tenant: str) -> dict:
        """Per-tenant starvation / fairness counters (created on first
        touch): submissions, admissions (+tokens), deferrals by cause, and
        the worst admission wait seen, in steps.  LRU-capped by
        ``gauge_history`` (0 = unbounded): every touch refreshes recency;
        past the cap the least recently touched tenant's gauges go."""
        g = self.tenant_gauges.get(tenant)
        if g is None:
            g = {"submitted": 0, "admitted": 0, "admitted_tokens": 0,
                 "rate_deferrals": 0, "cap_deferrals": 0,
                 "max_wait_steps": 0}
            self.tenant_gauges[tenant] = g
        else:
            self.tenant_gauges.move_to_end(tenant)
        cap = self.engine.scfg.gauge_history
        while cap and len(self.tenant_gauges) > cap:
            self.tenant_gauges.popitem(last=False)
        return g

    def _tenant_inflight(self, tenant: str) -> int:
        """Requests of ``tenant`` holding serving resources: residents +
        parked + the in-flight admission."""
        n = sum(1 for s in self._slots
                if s is not None and s.req.tenant_id == tenant)
        n += sum(1 for rec in self.parked if rec.req.tenant_id == tenant)
        if self._active is not None \
                and self._active.req.tenant_id == tenant:
            n += 1
        return n

    def _refill_rate_credits(self) -> None:
        """Accrue ``tenant_rate`` tokens of admission credit per iteration
        for each tenant with pending work, capped at 32 iterations' worth.
        Admission debits the request's cost; credit may go negative, which
        paces a burst instead of rejecting it."""
        rate = self.engine.scfg.tenant_rate
        if not rate:
            return
        for t in {r.tenant_id for r in self.pending}:
            self._rate_credit[t] = min(
                self._rate_credit.get(t, 0.0) + rate, rate * 32)

    def _eligible(self, r: Request, count: bool = False) -> bool:
        """Admission gates of one pending request: retry backoff elapsed,
        tenant in-flight cap, tenant rate credit.  ``count=True`` records
        deferrals in the tenant gauges (admission-sweep probes only)."""
        if r.not_before_step > self.steps:
            return False
        scfg = self.engine.scfg
        if scfg.tenant_max_inflight and self._tenant_inflight(r.tenant_id) \
                >= scfg.tenant_max_inflight:
            if count:
                self._tenant_gauge(r.tenant_id)["cap_deferrals"] += 1
            return False
        if scfg.tenant_rate \
                and self._rate_credit.get(r.tenant_id, 0.0) <= 0.0:
            if count:
                self._tenant_gauge(r.tenant_id)["rate_deferrals"] += 1
            return False
        return True

    def _note_admission(self, req: Request) -> None:
        """Fairness bookkeeping of a popped request: rate-credit debit and
        tenant gauges."""
        g = self._tenant_gauge(req.tenant_id)
        g["admitted"] += 1
        g["admitted_tokens"] += self._cost(req)
        if req.submit_step is not None:
            g["max_wait_steps"] = max(g["max_wait_steps"],
                                      self.steps - req.submit_step)
        if self.engine.scfg.tenant_rate:
            self._rate_credit[req.tenant_id] = \
                self._rate_credit.get(req.tenant_id, 0.0) - self._cost(req)

    def _drr_pick(self, prio: int, heads: Dict[str, int]) -> int:
        """Deficit round robin within priority class ``prio``: ``heads``
        maps tenant -> pending index of its FIFO head.  Each rotation turn
        banks ``tenant_quantum`` tokens for the tenant at the rotation
        head; the first whose head request costs <= its deficit is served
        and debited.  Tenants rotate in first-seen order; a tenant with no
        eligible work loses its bank.  Returns the chosen pending index."""
        rot = self._drr_rot.setdefault(prio, [])
        for t in heads:
            if t not in rot:
                rot.append(t)
        defc = self._drr_deficit.setdefault(prio, {})
        q = self.engine.scfg.tenant_quantum
        costs = {t: self._cost(self.pending[i]) for t, i in heads.items()}
        # enough turns that the costliest head MUST accumulate its cost
        turns = len(rot) * (max(costs.values()) // q + 2)
        for _ in range(turns):
            t = rot.pop(0)
            rot.append(t)
            if t not in heads:
                defc[t] = 0.0
                continue
            defc[t] = defc.get(t, 0.0) + q
            if costs[t] <= defc[t]:
                defc[t] -= costs[t]
                return heads[t]
        return min(heads.values())    # unreachable bound: FIFO head

    # --------------------------------------------------------------- static

    def _run_static(self, on_batch) -> List[Request]:
        """Drain fixed batches back to back (GPT-fast style), shortest
        prompts first; see the module docstring."""
        issued: List[Request] = []
        self.pending = collections.deque(
            sorted(self.pending, key=lambda r: len(r.prompt)))
        while self.pending:
            for idx in range(len(self.pending) - 1, -1, -1):
                req = self.pending[idx]
                if req.cancel_requested:
                    del self.pending[idx]
                    self._terminate(req, RequestState.CANCELLED,
                                    RequestCancelled(
                                        f"req {req.req_id} cancelled"),
                                    issued)
            batch: List[Request] = []
            while self.pending and len(batch) < self.max_batch:
                batch.append(self.pending.popleft())
            if not batch:
                break
            for req in batch:
                req.attempts += 1
                transition(req, RequestState.PREFILLING)
                transition(req, RequestState.DECODING)
            gen = (self.engine.generate_speculative
                   if self.engine.scfg.spec_window > 1
                   else self.engine.generate)
            results = gen([r.prompt for r in batch],
                          max_new_tokens=max(r.max_new_tokens
                                             for r in batch))
            for req, res in zip(batch, results):
                req.result = GenerationResult(
                    res.tokens[:req.max_new_tokens], res.prompt_len,
                    min(res.steps, req.max_new_tokens))
                self._terminate(req, RequestState.DONE, issued=issued)
            if on_batch:
                on_batch(batch)
        return issued

    # ------------------------------------------------------------------ run

    @torch.inference_mode()
    def run(self, on_batch: Optional[Callable[[List[Request]], None]] = None,
            on_step: Optional[Callable[["RequestScheduler", int], None]]
            = None) -> List[Request]:
        """Drain the queue; returns the requests that reached a terminal
        state, in completion order.  ``on_step(scheduler, step)``
        (continuous mode) fires after every decode step (clients submit
        mid-generation from it); ``on_batch(batch)`` (static mode) after
        each drained batch."""
        if self.mode == "static":
            return self._run_static(on_batch)
        eng = self.engine
        scfg = eng.scfg
        if self.max_batch != scfg.max_batch:
            raise ValueError("continuous mode uses the engine's slot arena: "
                             f"max_batch {self.max_batch} != "
                             f"engine {scfg.max_batch}")
        b = scfg.max_batch
        ps = scfg.page_size
        mp = scfg.max_seq_len // ps if self.paged else 0
        chunks_per_sweep = max(1, scfg.prefill_token_budget
                               // scfg.prefill_chunk)
        audit_on = bool(scfg.audit_every)
        cache = eng.init_slot_cache()
        eng.reset_sampler()        # the reference's PRNGKey(seed) per run
        admit_seq = itertools.count()   # admission order (preempt tie-break)
        prio_on = (scfg.priority_classes > 1
                   and scfg.preempt_policy != "none")
        slots: List[Optional[_Slot]] = [None] * b
        self._slots = slots
        self._active = None
        tokens = np.zeros((b,), np.int32)
        positions = np.zeros((b,), np.int32)
        issued: List[Request] = []
        tables: List[Optional[PageTable]] = [None] * b
        self._tables = tables
        host_table = np.zeros((b, mp), np.int32) if self.paged else None
        dirty = False              # host_table differs from the device's
        fault_streak = 0           # consecutive batch-wide decode faults
        pool = self.pool
        # width of the verify window; 0 = sequential decode
        spec_q = scfg.spec_window if scfg.spec_window > 1 else 0
        # tiered: the host mirror of the device hot-slot table, each row's
        # pinned write page, each row's previous selection (the prefetch
        # oracle)
        host_hot = np.zeros((b, mp), np.int32) if self.tiered else None
        hot_dirty = False
        write_pin: List[Optional[int]] = [None] * b
        prev_selected: List[set] = [set() for _ in range(b)]

        def clear_slot(i: int):
            """The idempotent slot teardown every exit path shares: frees
            the row (idle at position 0; paged: the trash page), its pages
            and its table row.  Request state is the caller's job."""
            nonlocal dirty, hot_dirty
            slots[i] = None
            tokens[i] = 0
            positions[i] = 0
            if self.tiered:
                # unpin BEFORE release_all: freeing a pinned page is an
                # invariant violation by design (it catches leaked pins)
                if write_pin[i] is not None:
                    pool.unpin(write_pin[i])
                    write_pin[i] = None
                prev_selected[i] = set()
                host_hot[i] = 0
                hot_dirty = True
            if self.paged:
                if tables[i] is not None:
                    tables[i].release_all()
                    tables[i] = None
                host_table[i] = 0
                dirty = True
                eng.release_slot(cache, i)       # metadata only
            if audit_on:
                self.audit_serving_state()

        def teardown_admission(adm: _Admission):
            """Release an in-flight admission's page reservation."""
            if adm.ptab is not None:
                adm.ptab.release_all()
                adm.ptab = None
            if audit_on:
                self.audit_serving_state()

        def finish(i: int):
            slot = slots[i]
            slot.req.result = GenerationResult(
                np.asarray(slot.out, np.int32), len(slot.req.prompt),
                len(slot.out))
            clear_slot(i)
            self._terminate(slot.req, RequestState.DONE, issued=issued)

        def fail_resident(i: int, exc: BaseException):
            """Row ``i`` alone pays for its fault: teardown, then
            retry-or-fail; the other residents keep decoding."""
            req = slots[i].req
            out = list(slots[i].out)
            clear_slot(i)
            self._fail_or_retry(req, exc, issued,
                                partial=(out, len(req.prompt)))

        def drop_entries(n_needed: int, protect_entry=None) -> bool:
            """Evict least-recently-used prefix-cache entries until
            ``n_needed`` pages are free (``protect_entry`` is spared)."""
            while pool.pages_free < n_needed and self.prefix_index:
                victim = self.prefix_index.lru_entry(exclude=protect_entry)
                if victim is None:
                    break
                self.prefix_index.evict(victim)
            return pool.pages_free >= n_needed

        def evict_to_requeue(i: int):
            """Pool exhausted and row ``i`` cannot map its next write page:
            evict the row ITSELF to the queue head.  Survivors keep every
            page they own, so at least one resident always completes
            between evictions (no livelock)."""
            if scfg.temperature > 0.0:
                # sampled decoding: the restart draws from later numbers of
                # the stream, so the regenerated completion will differ
                warnings.warn(
                    "paged pool exhausted: evicting a resident under "
                    "temperature > 0 — its re-run resamples and may "
                    "produce different tokens", RuntimeWarning,
                    stacklevel=2)
            req = slots[i].req
            clear_slot(i)
            transition(req, RequestState.QUEUED)
            req.not_before_step = 0
            self._trace_phase(req, "queue_wait", evicted=True)
            self.pending.appendleft(req)
            self.evictions += 1

        def pop_eligible() -> Optional[Request]:
            """Pop the next request to admit: the highest eligible
            PRIORITY class first; within it, deficit round robin across
            tenants (FIFO within one tenant, so one class and one tenant
            is plain FIFO).  Eligibility: ``_eligible``."""
            heads: Dict[str, int] = {}
            prio: Optional[int] = None
            for idx, r in enumerate(self.pending):
                if not self._eligible(r, count=True):
                    continue
                if prio is None or r.priority > prio:
                    prio, heads = r.priority, {}
                if r.priority == prio and r.tenant_id not in heads:
                    heads[r.tenant_id] = idx
            if prio is None:
                return None
            idx = next(iter(heads.values())) if len(heads) == 1 \
                else self._drr_pick(prio, heads)
            req = self.pending[idx]
            del self.pending[idx]
            self._note_admission(req)
            return req

        def try_reserve(req: Request) -> Optional[_Admission]:
            """Paged admission = page reservation: shared prefix pages +
            fresh suffix pages, or None (stall) when the pool cannot cover
            the suffix.  All or nothing: a fault mid-reservation releases
            the partial table before propagating."""
            prompt = np.asarray(req.prompt, np.int32)
            plen = len(prompt)
            entry, shared = None, 0
            if self.prefix_index is not None:
                entry, shared = self.prefix_index.match(prompt)
                # leave >= 1 suffix token; never deeper than the
                # boundary-ring snapshots reach
                shared = min(shared, (plen - 1) // ps,
                             scfg.prefix_share_pages)
            n_new = -(-plen // ps) - shared
            if pool.pages_free < n_new and \
                    not drop_entries(n_new, protect_entry=entry):
                if entry is not None:
                    # sharing is an optimization: if protecting the match
                    # starves the reservation, retry unshared so that
                    # entry becomes evictable too
                    entry, shared = None, 0
                    n_new = -(-plen // ps)
                if pool.pages_free < n_new and not drop_entries(n_new):
                    self.admission_stalls += 1
                    return None
            free = next(i for i in range(b) if slots[i] is None)
            ptab = PageTable(pool, mp)
            try:
                for j in range(shared):
                    ptab.append_shared(entry.page_ids[j])
                for _ in range(n_new):
                    ptab.append_page()
                task = eng.start_prefill(
                    prompt, resume=(entry, shared) if shared else None)
            except BaseException:
                ptab.release_all()
                raise
            if shared:
                self.prefix_hits += 1
                self.prefix_index.touch(entry)
            return _Admission(req, free, task, ptab=ptab,
                              shared_pages=shared, entry=entry)

        # ---- two-tier helpers ---------------------------------------------

        def shed_thrash(i: int, exc: HotTierThrash):
            """Hot-tier thrash on row ``i``: shed load, not the request.
            With other residents live, row i evicts itself to the queue head
            (its pins and hot pages free at once; greedy decode keeps its
            re-run token-identical).  A SOLE thrashing resident cannot fit
            its own per-step selection, and self-eviction would livelock,
            so it goes through the transient retry budget."""
            if sum(s is not None for s in slots) > 1:
                evict_to_requeue(i)
            else:
                fail_resident(i, exc)

        def claim_slot(exclude) -> int:
            """A free hot payload slot, spilling the least recently touched
            unpinned hot page not in ``exclude`` (pages this step reads or
            writes) if none is free.  Raises HotTierThrash when there is no
            such page."""
            nonlocal hot_dirty
            slot = pool.take_slot()
            if slot is None:
                victim = pool.spill_victim(exclude)
                if victim is None:
                    raise HotTierThrash(
                        f"no spillable hot page among {len(pool.hot)} "
                        f"({len(pool.pins)} pinned)")
                vslot = pool.begin_spill(victim)   # fires "spill" first
                sid = None if self.tracer is None else self.tracer.begin(
                    "tier_spill", "scheduler", page=victim)
                mirror = eng.read_page_payload(cache, vslot)
                pool.finish_spill(victim, mirror)
                self._note_transfer("spill", mirror, sid)
                hot_dirty = True
                slot = pool.take_slot()
            return slot

        def fetch_page(pid: int, exclude) -> None:
            """Host -> device fetch of cold page ``pid``.  The fault points
            fire before any state change or copy, so an injected host_fetch
            / spill fault leaves both tiers intact."""
            nonlocal hot_dirty
            slot = claim_slot(exclude)
            try:
                payload = pool.begin_fetch(pid)    # fires "host_fetch" first
            except BaseException:
                pool.give_slot(slot)
                raise
            sid = None if self.tracer is None else self.tracer.begin(
                "tier_fetch", "scheduler", page=pid)
            try:
                eng.load_page(cache, slot, payload)
            except BaseException:
                if sid is not None:
                    self.tracer.end(sid, aborted=True)
                pool.abort_fetch(pid)
                pool.give_slot(slot)
                raise
            pool.finish_fetch(pid, slot)
            self._note_transfer("fetch", payload, sid)
            hot_dirty = True

        def ensure_write_pin(i: int):
            """Pin row i's current write page hot: the decode write lands in
            it through the hot table every step.  A growth page takes a slot
            at once, its bytes garbage until written (position masks keep
            them unselectable)."""
            nonlocal hot_dirty
            pid = tables[i].pages[int(positions[i]) // ps]
            if write_pin[i] == pid:
                return
            if write_pin[i] is not None:
                pool.unpin(write_pin[i])
                write_pin[i] = None
            if pid in pool.fresh:          # growth page: slot, no transfer
                pool.set_hot(pid, claim_slot({pid}))
            elif pid in pool.cold:         # write into a spilled page
                fetch_page(pid, {pid})
                self.cold_misses += 1
            pool.pin(pid)
            write_pin[i] = pid
            hot_dirty = True

        def push_tables():
            """Push the host page table — and, tiered, the hot-slot table
            rebuilt from the pool's residency — to the device cache."""
            nonlocal dirty, hot_dirty
            if self.tiered and (dirty or hot_dirty):
                slot_of = np.zeros((pool.n_pages,), np.int32)
                for pid, sl in pool.hot.items():
                    slot_of[pid] = sl
                host_hot[:] = slot_of[host_table]
                eng.with_page_tables(cache, host_table, host_hot)
                dirty = hot_dirty = False
            elif dirty:
                eng.with_page_tables(cache, host_table)
                dirty = False

        def assign_residency(adm: _Admission) -> List[int]:
            """First residency of an admission's FRESH pages: hot while free
            slots last, cold past them (mirror taken from the task's dense
            cache; those pages never touch the device payload pools).
            Admission never spills residents.  Returns the hot-slot row of
            the reservation (shared pages keep their residency)."""
            nonlocal hot_dirty
            hot_row = []
            for j, pid in enumerate(adm.ptab.pages):
                if pid in pool.fresh:
                    slot = pool.take_slot()
                    if slot is not None:
                        pool.set_hot(pid, slot)
                    else:
                        pool.set_cold(pid, eng.extract_page_payload_dense(
                            adm.task.cache, j))
                hot_row.append(pool.hot.get(pid, 0))
            hot_dirty = True
            return hot_row

        def tiered_decode(prefetched: set):
            """The tiered decode step: FETCH-AND-RERUN.  Run the step with
            selection collection; if a selected page was cold, fetch it hot
            and rerun the same step on the same cache.  Every cache write
            of a step is a set at a fixed position (latents, score pool,
            ring, sink, the full layers' K/V; ``lengths`` by maximum), so
            the last run is bit-identical to an all-resident step.  It
            converges because the score pool is always true: each rerun
            fixes at least one more layer.  Returns the final logits, or
            None when fetch faults tore every resident down."""
            rounds = 0
            while True:
                logits, _, touched = eng.decode_sel(tokens, cache,
                                                    positions)
                tnp = touched.cpu().numpy()
                touched_all: set = set()
                new_prev: Dict[int, set] = {}
                demand: List[tuple] = []
                for i in range(b):
                    if slots[i] is None:
                        continue
                    pids = {int(host_table[i, j])
                            for j in np.nonzero(tnp[i])[0]}
                    pids.discard(0)
                    new_prev[i] = pids
                    touched_all |= pids
                    for pid in sorted(pids):
                        if pid in pool.cold:
                            demand.append((i, pid))
                pool.touch(p for p in sorted(touched_all) if p in pool.hot)
                if rounds == 0:
                    self.fetch_hits += sum(
                        1 for p in touched_all if p in pool.hot)
                    self.prefetch_hits += len(touched_all & prefetched)
                if not demand:
                    for i, pids in new_prev.items():
                        prev_selected[i] = pids
                    return logits
                rounds += 1
                if rounds > eng.cfg.n_layers + 2:
                    raise PagerInvariantError(
                        "tiered fetch-and-rerun did not converge in "
                        f"{rounds} rounds")
                for i, pid in demand:
                    if slots[i] is None:       # row died earlier this pass
                        continue
                    if pid not in pool.cold:   # fetched for an earlier row
                        continue
                    try:
                        fetch_page(pid, touched_all)
                        self.cold_misses += 1
                    except faults.InjectedFault as exc:
                        fail_resident(i, exc)
                    except HotTierThrash as exc:
                        shed_thrash(i, exc)
                if not any(s is not None for s in slots):
                    return None
                push_tables()

        def ensure_writable(i: int, span: int = 1):
            """Map every page row i's next ``span`` writes land in
            (allocating on page crossings: a verify window commits up to
            min(Q, tokens left) tokens in one round, which can cross into
            the next page) and copy-on-write any that is still shared; evict
            the row itself when the pool is exhausted even after dropping
            prefix entries.  Tiered: also pins the write page hot."""
            nonlocal dirty, hot_dirty
            ptab = tables[i]
            lo = int(positions[i]) // ps
            hi = (int(positions[i]) + span - 1) // ps
            for p in range(lo, hi + 1):
                if p >= ptab.n_pages:
                    if pool.pages_free < 1 and not drop_entries(1):
                        evict_to_requeue(i)
                        return
                    ptab.ensure_for_position(p * ps)
                    host_table[i, :ptab.n_pages] = ptab.pages
                    dirty = True
                elif pool.refcount(ptab.pages[p]) > 1:
                    if pool.pages_free < 1 and not drop_entries(1):
                        evict_to_requeue(i)
                        return
                    old, new = ptab.ensure_exclusive(p)
                    if self.tiered:
                        # score page by physical id; payload by hot slot,
                        # or a host-mirror copy of a cold source
                        eng.copy_score_page(cache, old, new)
                        if old in pool.hot:
                            slot = claim_slot({old, new})
                            try:       # fires "cow_copy" before the copy
                                eng.copy_page(cache, pool.hot[old], slot)
                            except BaseException:
                                pool.give_slot(slot)
                                raise
                            pool.set_hot(new, slot)
                        else:
                            faults.maybe_fault("cow_copy")
                            pool.set_cold(new, eng.clone_payload(
                                pool.cold[old]))
                        hot_dirty = True
                    else:
                        eng.copy_page(cache, old, new)
                    host_table[i, p] = new
                    dirty = True
                    self.cow_copies += 1
            if self.tiered:
                ensure_write_pin(i)

        def emit_tokens(i: int, n_new: int) -> bool:
            """Stream row i's ``n_new`` newest tokens through ``on_token``;
            a raising callback fails that request alone.  False when the
            row was torn down."""
            req = slots[i].req
            if req.on_token is None:
                return True
            base = len(slots[i].out) - n_new
            for k in range(n_new):
                try:
                    req.on_token(int(slots[i].out[base + k]), base + k)
                except Exception as exc:
                    fail_resident(i, exc)
                    return False
            return True

        # ---- preemption: park / resume / evict ---------------------------

        def spill_parked_cold():
            """The hot-tier half of a park: spill every page whose ONLY
            owners are parked tables (hot, unpinned, refcount == parked
            multiplicity) to a host mirror, so the preemption frees device
            slots.  Pages shared with a resident, an admission or a prefix
            entry keep their residency.  Runs after each park and once per
            iteration: an injected ``spill`` fault leaves the page hot
            until the next sweep retries it."""
            nonlocal hot_dirty
            if not (self.tiered and self.parked):
                return
            counts = collections.Counter()
            for rec in self.parked:
                counts.update(rec.ptab.pages)
            for pid, n in sorted(counts.items()):
                if pid in pool.hot and not pool.pins.get(pid) \
                        and pool.refcount(pid) == n:
                    try:
                        vslot = pool.begin_spill(pid)  # fires "spill" first
                    except faults.InjectedFault:
                        return         # retried next iteration
                    sid = None if self.tracer is None else self.tracer.begin(
                        "tier_spill", "scheduler", page=pid, parked=True)
                    mirror = eng.read_page_payload(cache, vslot)
                    pool.finish_spill(pid, mirror)
                    self._note_transfer("spill", mirror, sid)
                    hot_dirty = True

        def park_resident(i: int):
            """Preempt-PARK row ``i``: its per-slot state to host memory
            (``engine.detach_slot``, which fires the ``park`` fault point
            before any read, so an injected fault leaves the victim
            resident), its page table into a parked record WITHOUT
            releasing a page, its batch slot freed.  Tiered: the write pin
            drops and exclusively-parked pages spill cold."""
            nonlocal dirty, hot_dirty
            req = slots[i].req
            snap = eng.detach_slot(cache, i)
            rec = _Parked(req=req, out=slots[i].out,
                          position=int(positions[i]), ptab=tables[i],
                          snapshot=snap, parked_step=self.steps)
            slots[i] = None
            tokens[i] = 0
            positions[i] = 0
            tables[i] = None        # ownership moved to rec: NOT released
            host_table[i] = 0
            dirty = True
            if self.tiered:
                if write_pin[i] is not None:
                    pool.unpin(write_pin[i])
                    write_pin[i] = None
                prev_selected[i] = set()
                host_hot[i] = 0
                hot_dirty = True
            eng.release_slot(cache, i)             # metadata only
            transition(req, RequestState.PARKED)
            self._trace_phase(req, "parked")
            self.parked.append(rec)
            req.parks += 1
            self.parks += 1
            spill_parked_cold()
            if audit_on:
                self.audit_serving_state()

        def resume_parked(rec: _Parked, i: int) -> bool:
            """Resume a parked record into free slot ``i``: the snapshot
            goes back in place (``engine.attach_slot``, which fires the
            ``resume`` fault point first), the table row is reinstalled,
            and the request goes on DECODING token-exact.  On a resume
            fault the park is abandoned: the held pages release and the
            request restarts from scratch through the retry policy."""
            nonlocal dirty, hot_dirty
            try:
                eng.attach_slot(cache, i, rec.snapshot)
            except Exception as exc:
                rec.ptab.release_all()
                self._fail_or_retry(rec.req, exc, issued,
                                    partial=(rec.out, len(rec.req.prompt)))
                if audit_on:
                    self.audit_serving_state()
                return False
            tables[i] = rec.ptab
            host_table[i] = 0
            host_table[i, :rec.ptab.n_pages] = rec.ptab.pages
            dirty = True
            if self.tiered:
                hot_dirty = True   # hot rows rebuild from pool residency
            slots[i] = _Slot(rec.req, out=rec.out, seq=next(admit_seq),
                             drafter=NgramDrafter(
                                 list(rec.req.prompt) + rec.out)
                             if spec_q else None)
            tokens[i] = rec.out[-1]
            positions[i] = rec.position
            transition(rec.req, RequestState.DECODING)
            self._trace_phase(rec.req, "decode", resumed=True)
            self.resumes += 1
            if audit_on:
                self.audit_serving_state()
            return True

        def best_incoming_priority() -> Optional[int]:
            """Highest priority among eligible pending and parked
            requests: what a resident must be strictly below to be
            preempted."""
            best = None
            for r in self.pending:
                if self._eligible(r) and (best is None or r.priority > best):
                    best = r.priority
            for rec in self.parked:
                if best is None or rec.req.priority > best:
                    best = rec.req.priority
            return best

        def preempt_for_priority():
            """Park (or evict, per ``preempt_policy``) the lowest-priority,
            most recently admitted resident while a strictly higher
            eligible class waits and no slot is free.  Never below the
            incoming class, and never while an admission is in flight (it
            owns the next free slot)."""
            if self._active is not None:
                return
            while True:
                if any(s is None for s in slots):
                    return
                best = best_incoming_priority()
                if best is None:
                    return
                vict = None
                for i in range(b):
                    s_ = slots[i]
                    if s_ is None or s_.req.priority >= best:
                        continue
                    if vict is None or (s_.req.priority, -s_.seq) < \
                            (slots[vict].req.priority, -slots[vict].seq):
                        vict = i
                if vict is None:
                    return
                if scfg.preempt_policy == "evict":
                    evict_to_requeue(vict)
                else:
                    try:
                        park_resident(vict)
                    except faults.InjectedFault:
                        return   # victim stays resident; retried next time
                self.preemptions += 1

        def resume_ready_parked():
            """Fill free slots with parked records, highest priority first
            (earliest parked within a class), unless a STRICTLY higher
            pending class is eligible: parked work outranks new admissions
            of its own class.  The slot an in-flight admission reserved is
            not up for grabs."""
            while self.parked:
                reserved = self._active.slot \
                    if self._active is not None else -1
                free = next((i for i in range(b)
                             if slots[i] is None and i != reserved), None)
                if free is None:
                    return
                best_pend = None
                for r in self.pending:
                    if self._eligible(r) and (best_pend is None
                                              or r.priority > best_pend):
                        best_pend = r.priority
                rec = min(self.parked,
                          key=lambda rc: (-rc.req.priority, rc.parked_step))
                if best_pend is not None and best_pend > rec.req.priority:
                    return
                self.parked.remove(rec)
                resume_parked(rec, free)

        def reclaim_parked_pages(req: Request) -> bool:
            """A page-stalled admission may reclaim the pages of a PARKED
            victim of strictly lower priority, or of ANY parked record
            when nothing is resident (held pages with an empty arena would
            deadlock the queue).  Destructive: the victim's pages release
            and it requeues from scratch, as an evict-to-requeue."""
            none_resident = not any(s is not None for s in slots)
            cands = [rec for rec in self.parked
                     if rec.req.priority < req.priority or none_resident]
            if not cands:
                return False
            rec = min(cands, key=lambda rc: (rc.req.priority,
                                             -rc.parked_step))
            self.parked.remove(rec)
            rec.ptab.release_all()
            transition(rec.req, RequestState.QUEUED)
            rec.req.not_before_step = 0
            self.pending.append(rec.req)
            self.evictions += 1
            if audit_on:
                self.audit_serving_state()
            return True

        def sweep_deadlines_and_cancels():
            """Honor cancel() and expired deadlines in every phase through
            the one teardown path, at each iteration boundary."""
            for idx in range(len(self.pending) - 1, -1, -1):
                req = self.pending[idx]
                state = self._overdue(req)
                if state is not None:
                    del self.pending[idx]
                    self._terminate(req, state,
                                    self._overdue_error(req, state), issued)
            adm = self._active
            if adm is not None:
                state = self._overdue(adm.req)
                if state is not None:
                    teardown_admission(adm)
                    self._active = None
                    self._terminate(adm.req, state,
                                    self._overdue_error(adm.req, state),
                                    issued)
            # a parked request's teardown is releasing its held pages (no
            # slot, no pins) and flushing the partial stream
            for idx in range(len(self.parked) - 1, -1, -1):
                rec = self.parked[idx]
                state = self._overdue(rec.req)
                if state is not None:
                    del self.parked[idx]
                    rec.ptab.release_all()
                    self._terminate(rec.req, state,
                                    self._overdue_error(rec.req, state),
                                    issued,
                                    partial=(rec.out, len(rec.req.prompt)))
                    if audit_on:
                        self.audit_serving_state()
            for i in range(b):
                if slots[i] is None:
                    continue
                req = slots[i].req
                state = self._overdue(req)
                if state is not None:
                    out = list(slots[i].out)
                    clear_slot(i)
                    self._terminate(req, state,
                                    self._overdue_error(req, state), issued,
                                    partial=(out, len(req.prompt)))

        def admit_active(active: _Admission, step: int, it: int) -> None:
            """Splice a finished prefill into its slot and emit its first
            token (or tear it down on a fault).  Runs before the next
            ``start_prefill``: the task's cache (cold mirrors included)
            and logits live in the engine's prefill workspace and chunk
            program, which the next request rewrites.  The first token's
            read, which waits for the chunks queued on the device, lies
            between its two ``admit`` spans."""
            nonlocal dirty
            i = active.slot
            with self._step_span("admit", step, it):
                try:
                    if self.tiered:
                        # residency first: the cold mirrors read the
                        # task's dense cache
                        hot_row = assign_residency(active)
                        eng.admit_tiered(cache, active.task.cache, i,
                                         active.ptab.pages, hot_row,
                                         active.shared_pages,
                                         active.task.prompt_len)
                    elif self.paged:
                        eng.admit_paged(cache, active.task.cache, i,
                                        active.ptab.pages,
                                        active.shared_pages,
                                        active.task.prompt_len)
                    else:
                        eng.admit(cache, active.task.cache, i)
                except Exception as exc:      # fault before the splice
                    teardown_admission(active)
                    self._active = None
                    self._fail_or_retry(active.req, exc, issued)
                    return
                if self.paged:
                    tables[i] = active.ptab
                    host_table[i] = 0
                    host_table[i, :active.ptab.n_pages] = active.ptab.pages
                    dirty = True
                    self._register_prefix(active)
                # ownership of ptab moved to tables[i]: drop the admission
                # now so an audit cannot count the same table twice
                self._active = None
                transition(active.req, RequestState.DECODING)
                self._trace_phase(active.req, "decode")
            tok_arr, ok = eng.sample_checked(active.task.logits)
            tok0 = int(tok_arr[0])
            with self._step_span("admit", step, it):
                if not ok[0]:
                    slots[i] = _Slot(active.req, out=[], seq=next(admit_seq))
                    fail_resident(i, NanLogitsError(
                        f"req {active.req.req_id}: non-finite prefill "
                        "logits"))
                    return
                slots[i] = _Slot(active.req, out=[tok0], seq=next(admit_seq),
                                 drafter=NgramDrafter(
                                     list(active.req.prompt) + [tok0])
                                 if spec_q else None)
                tokens[i] = tok0
                positions[i] = len(active.req.prompt)
                self.admissions.append((self.steps, i, active.req.req_id))
                if emit_tokens(i, 1) and \
                        len(slots[i].out) >= active.req.max_new_tokens:
                    finish(i)

        def decode_step(prefetched: set, live_pos, step: int,
                        it: int) -> bool:
            """One ragged decode step of the whole arena, one token per
            live row (empty slots idle at position 0; paged: the trash
            page).  Tiered: through fetch-and-rerun; False when its fetch
            faults tore every resident down (no step was taken).
            ``live_pos``: the live rows' positions before the step, for the
            traffic accountant (None when it is off).  The rows'
            bookkeeping and callbacks after the host read of the tokens
            are its ``decode_commit`` span."""
            if self.tiered:
                logits = tiered_decode(prefetched)
                if logits is None:
                    return False
            else:
                logits, _ = eng.decode(tokens, cache, positions)
            live = [i for i in range(b) if slots[i] is not None]
            pick = faults.maybe_pick("nan_logits", len(live))
            if pick is not None:
                logits[live[pick]] = float("nan")
            tok_arr, ok = eng.sample_checked(logits)
            new_toks = tok_arr.cpu().numpy()
            with self._step_span("decode_commit", step, it):
                self.steps += 1
                if self.traffic is not None:
                    # per COMMITTED step: tiered reruns re-stream the same
                    # terms, and the transfers are accounted where they
                    # happen
                    self.traffic.observe_decode(eng, cache, live_pos)
                for i in range(b):
                    if slots[i] is None:
                        continue
                    if not ok[i]:
                        fail_resident(i, NanLogitsError(
                            f"req {slots[i].req.req_id}: non-finite logits "
                            f"or out-of-vocab token at step {self.steps}"))
                        continue
                    slots[i].out.append(int(new_toks[i]))
                    tokens[i] = new_toks[i]
                    positions[i] += 1
                    if not emit_tokens(i, 1):
                        continue
                    if len(slots[i].out) >= slots[i].req.max_new_tokens:
                        finish(i)
            return True

        def verify_round(live_pos) -> None:
            """One speculative verify window of the whole arena: greedy
            verify keeps each live row's longest matching draft prefix plus
            the model's next token; the masked commit writes exactly those
            positions (rejected, failed and idle rows none)."""
            wt = np.zeros((b, spec_q), np.int32)
            for i in range(b):
                if slots[i] is not None:
                    wt[i, 0] = tokens[i]
                    wt[i, 1:] = slots[i].drafter.propose(spec_q - 1)
            win_logits, aux = eng.decode_window(wt, cache, positions)
            live = [i for i in range(b) if slots[i] is not None]
            pick = faults.maybe_pick("nan_logits", len(live))
            if pick is not None:
                win_logits[live[pick]] = float("nan")
            preds, finite = eng.verify_checked(win_logits)
            n_matched = np.cumprod(wt[:, 1:] == preds[:, :-1],
                                   axis=1).sum(axis=1)
            n_commit = np.zeros((b,), np.int32)
            emitted: List[List[int]] = [[] for _ in range(b)]
            for i in live:
                if not finite[i]:
                    continue
                left = slots[i].req.max_new_tokens - len(slots[i].out)
                n_emit = int(min(n_matched[i] + 1, left))
                emitted[i] = [int(t) for t in wt[i, 1:n_emit]] \
                    + [int(preds[i, n_emit - 1])]
                n_commit[i] = n_emit
            # the committed slots are the pending token plus the accepted
            # drafts; the last emitted token is the next pending token
            eng.commit_window(cache, aux, positions, n_commit)
            self.steps += 1
            self.spec_rounds += 1
            if self.traffic is not None:
                self.traffic.observe_decode(eng, cache, live_pos,
                                            q_len=spec_q)
            for i in live:
                if not finite[i]:
                    fail_resident(i, NanLogitsError(
                        f"req {slots[i].req.req_id}: non-finite window "
                        f"logits at step {self.steps}"))
                    continue
                row = emitted[i]
                self.spec_proposed += spec_q - 1
                self.spec_accepted += min(int(n_matched[i]), len(row) - 1)
                self.spec_committed += len(row)
                slots[i].out.extend(row)
                slots[i].drafter.extend(row)
                tokens[i] = row[-1]
                positions[i] += len(row)
                if not emit_tokens(i, len(row)):
                    continue
                if len(slots[i].out) >= slots[i].req.max_new_tokens:
                    finish(i)

        iterations = itertools.count()    # the loop's, on its spans
        while self.pending or self._active or self.parked \
                or any(s is not None for s in slots):
            # several iterations may share a step (prefill sweeps with an
            # empty arena): ``it`` tells them apart
            step, it = self.steps, next(iterations)
            with self._step_span("sweep", step, it):
                sweep_deadlines_and_cancels()
                self._refill_rate_credits()
                if prio_on:
                    preempt_for_priority()
                resume_ready_parked()
                spill_parked_cold()

            # ---- prefill sweep: <= budget tokens of chunk work; priority
            # classes first, DRR across tenants within a class -------------
            spent = 0
            while spent < chunks_per_sweep:
                if self._active is None:
                    with self._step_span("admit", step, it):
                        free = next((i for i in range(b) if slots[i] is None),
                                    None)
                        if free is None:
                            break
                        req = pop_eligible()
                        if req is None:
                            break
                        if self.paged:
                            try:
                                self._active = try_reserve(req)
                            except Exception as exc:   # torn reservation
                                self._fail_or_retry(req, exc, issued)
                                continue
                            if self._active is None:  # stalled on pages: back
                                # to the head, after trying to reclaim a
                                # lower-priority parked victim's pages
                                self.pending.appendleft(req)
                                if reclaim_parked_pages(req):
                                    continue   # pages freed: retry right away
                                break
                        else:
                            self._active = _Admission(
                                req, free, eng.start_prefill(req.prompt))
                        req.attempts += 1
                        transition(req, RequestState.PREFILLING)
                        self._trace_phase(req, "prefill", attempt=req.attempts)
                active = self._active
                self.prefill_chunks.append(
                    (self.steps, active.req.req_id, active.task.next_chunk,
                     sum(s is not None for s in slots)))
                csid = None if self.tracer is None else self.tracer.begin(
                    "prefill_chunk", "scheduler", req=active.req.req_id,
                    chunk=active.task.next_chunk)
                try:
                    eng.prefill_chunk_step(active.task)
                except Exception as exc:
                    # the task is lost but the arena is untouched
                    if csid is not None:
                        self.tracer.end(csid, faulted=True)
                    teardown_admission(active)
                    self._active = None
                    self._fail_or_retry(active.req, exc, issued)
                    spent += 1
                    continue
                if csid is not None:
                    self.tracer.end(csid)
                spent += 1
                if active.task.done:
                    admit_active(active, step, it)

            if not any(s is not None for s in slots):
                if not (self.pending or self._active or self.parked):
                    break
                if self._active is None and self.pending:
                    # empty arena and every pending request backing off:
                    # fast-forward the step clock to the earliest gate
                    nxt = min(r.not_before_step for r in self.pending)
                    if nxt > self.steps:
                        self.steps = nxt
                continue

            # ---- paged upkeep: map / COW every row's write page, then push
            # the host table to the device ------------------------------------
            prefetched: set = set()
            if self.paged:
                with self._step_span("page_upkeep", step, it):
                    for i in range(b):
                        if slots[i] is not None:
                            span = 1 if not spec_q else min(
                                spec_q, slots[i].req.max_new_tokens
                                - len(slots[i].out))
                            try:
                                ensure_writable(i, span)
                            except HotTierThrash as exc:
                                shed_thrash(i, exc)    # load, not the request
                            except Exception as exc:   # alloc/COW fault
                                fail_resident(i, exc)
                    # ---- selection-driven prefetch: warm each row's
                    # previous selection (the next one mostly repeats it)
                    if self.tiered and scfg.tier_prefetch:
                        for i in range(b):
                            if slots[i] is None:
                                continue
                            try:
                                for pid in sorted(prev_selected[i]):
                                    if pid in pool.cold:
                                        fetch_page(pid, prev_selected[i])
                                        prefetched.add(pid)
                            except HotTierThrash:
                                break   # hot tier saturated: best effort only
                            except faults.InjectedFault as exc:
                                fail_resident(i, exc)
                    push_tables()
                if not any(s is not None for s in slots):
                    continue

            # ---- one ragged decode step, or verify window, for the whole
            # arena (empty slots idle at position 0; paged: the trash page)
            try:
                faults.maybe_fault("decode_step")
                if spec_q:
                    faults.maybe_fault("draft_verify")
            except faults.InjectedFault:
                self.step_faults += 1
                fault_streak += 1
                if fault_streak > scfg.max_request_retries:
                    raise
                continue
            fault_streak = 0
            # the step's span, and the live rows' positions read from the
            # host arrays BEFORE the step commits (the accountant reconciles
            # at the positions the selection ran at)
            tr = self.tracer
            dsid = None if tr is None else tr.begin(
                "verify_window" if spec_q else "decode_step", "scheduler",
                step=self.steps, n_live=sum(s is not None for s in slots))
            live_pos = None if self.traffic is None else [
                int(positions[i]) for i in range(b) if slots[i] is not None]
            if spec_q:
                verify_round(live_pos)
            elif not decode_step(prefetched, live_pos, step, it):
                if dsid is not None:
                    tr.end(dsid, aborted=True)
                continue
            if dsid is not None:
                tr.end(dsid)
            if self.paged:
                row = {
                    "step": self.steps,
                    "pages_in_use": pool.pages_in_use,
                    "pages_free": pool.pages_free,
                    "prefix_hits": self.prefix_hits,
                    "cow_copies": self.cow_copies,
                    "admission_stalls": self.admission_stalls,
                    "evictions": self.evictions,
                    "parked": len(self.parked),
                    "parks": self.parks,
                    "resumes": self.resumes,
                    "preemptions": self.preemptions,
                    "prefix_entries": len(self.prefix_index.entries)
                    if self.prefix_index else 0,
                }
                if self.tiered:
                    row.update({"host_pages": pool.host_pages,
                                "fetch_hits": self.fetch_hits,
                                "prefetch_hits": self.prefetch_hits,
                                "cold_misses": self.cold_misses,
                                "spills": pool.spills})
                self.pool_gauges.append(row)
            # gauges are point-in-time samples: published every 4 steps,
            # and once at drain below, so end-state reads are exact
            if self._metrics_installed and self.steps % 4 == 0:
                self._publish_gauges()
            if audit_on and self.steps % scfg.audit_every == 0:
                self.audit_serving_state(
                    self.pool_gauges[-1] if self.pool_gauges else None)
            if on_step:
                on_step(self, self.steps)
        self._publish_gauges()
        return issued

    # ------------------------------------------------------------ telemetry

    def _step_span(self, name: str, step: int, it: int):
        """A span of one phase of the loop's iteration ``it`` (at step
        ``step``) on the ``scheduler`` track (``obs/trace.py``'s
        ``STEP_SPANS``); a shared no-op context when tracing is off."""
        tr = self.tracer
        return _NO_SPAN if tr is None else tr.span(name, "scheduler",
                                                   step=step, it=it)

    @staticmethod
    def _mirror_nbytes(mirror: dict) -> int:
        """Bytes of a host page mirror ({seg: {field: tensor}}): the
        ``numel() * element_size()`` of exactly the tensors the copy
        moves, the measured side of the tier transfer term."""
        return sum(t.numel() * t.element_size()
                   for seg in mirror.values() for t in seg.values())

    def _note_transfer(self, kind: str, mirror: dict,
                       sid: Optional[int]) -> None:
        """Account one host <-> device page transfer: close its span with
        the measured byte count and feed the traffic accountant."""
        if self.tracer is None and self.traffic is None:
            return
        nbytes = self._mirror_nbytes(mirror)
        if sid is not None:
            self.tracer.end(sid, bytes=nbytes)
        if self.traffic is not None:
            self.traffic.observe_transfer(kind, 1, nbytes)

    def _publish_gauges(self) -> None:
        """Refresh the registry's point-in-time gauges (occupancy, queue
        depths, tenant fairness) from host state.  Cumulative counts live
        in the counters behind the ``_CounterView`` fields."""
        g = self.metrics
        g.gauge("serve_steps", "decode steps executed").set(self.steps)
        g.gauge("serve_pending", "requests waiting in queue").set(
            len(self.pending))
        g.gauge("serve_residents", "slots running decode").set(
            sum(s is not None for s in self._slots))
        g.gauge("serve_parked_requests", "preempt-parked residents").set(
            len(self.parked))
        if self.pool is not None:
            g.gauge("serve_pages_in_use", "refcounted pool pages").set(
                self.pool.pages_in_use)
            g.gauge("serve_pages_free", "allocatable pool pages").set(
                self.pool.pages_free)
            if self.tiered:
                g.gauge("serve_host_pages", "cold (host-mirror) pages").set(
                    self.pool.host_pages)
                g.counter("serve_tier_spills_total",
                          "device -> host page spills").set_to(
                    self.pool.spills)
                g.counter("serve_tier_fetches_total",
                          "host -> device page fetches").set_to(
                    self.pool.fetches)
        if self.prefix_index is not None:
            g.gauge("serve_prefix_entries", "live prefix-cache entries").set(
                len(self.prefix_index.entries))
        if self.tenant_gauges:
            tg = g.gauge("serve_tenant_stat",
                         "per-tenant fairness/starvation gauges",
                         labelnames=("tenant", "stat"))
            for t, gd in self.tenant_gauges.items():
                for k, v in gd.items():
                    tg.set(v, tenant=t, stat=k)

    # ---------------------------------------------------------------- audit

    def audit_serving_state(self, gauges: Optional[dict] = None) -> None:
        """Cross-structure invariant audit: the pool, every live page
        table (residents, parked records, in-flight admission), the prefix
        index's pins and the exported gauges agree (page conservation, no
        use-after-free, no leak; tiered: tier conservation, parked pages
        never pinned nor fresh), every resident is DECODING and every
        parked record PARKED with pages.  Raises
        :class:`PagerInvariantError`.  Host-side only."""
        for i, s in enumerate(self._slots):
            if s is not None and s.req.state is not RequestState.DECODING:
                raise PagerInvariantError(
                    f"slot {i} resident req {s.req.req_id} in state "
                    f"{s.req.state.value}, expected decoding")
            if self.paged and s is None and i < len(self._tables) \
                    and self._tables[i] is not None:
                raise PagerInvariantError(
                    f"slot {i} is empty but still owns a page table")
        for rec in self.parked:
            if rec.req.state is not RequestState.PARKED:
                raise PagerInvariantError(
                    f"parked req {rec.req.req_id} in state "
                    f"{rec.req.state.value}, expected parked")
            if rec.ptab is None or rec.ptab.n_pages == 0:
                raise PagerInvariantError(
                    f"parked req {rec.req.req_id} holds no pages — a park "
                    "is only legal for a paged resident")
        if not self.paged:
            return
        # parked tables join the census: a park HOLDS pages
        tables = [t for t in self._tables if t is not None]
        parked_pids: List[int] = []
        for rec in self.parked:
            tables.append(rec.ptab)
            parked_pids.extend(rec.ptab.pages)
        adm = self._active
        if adm is not None and adm.ptab is not None:
            tables.append(adm.ptab)
        entries = self.prefix_index.entries if self.prefix_index else []
        audit_pager(self.pool, tables, entries, gauges=gauges,
                    parked=parked_pids)

    def _register_prefix(self, adm: _Admission) -> None:
        """Register a finished prefill's whole-page prefix for sharing: the
        entry keeps a copy of the task's final cache/scratch (append-only
        resume state, which the next task's prefill rewrites in the
        engine's workspace) and its boundary ring snapshots — a resumed
        registrant inherits the ones it skipped from ITS entry."""
        if self.prefix_index is None:
            return
        task = adm.task
        if task.prompt_len < self.engine.scfg.page_size:
            return
        rings = dict(task.boundary_rings or {})
        if adm.entry is not None:
            for d, snap in adm.entry.boundary_rings.items():
                if d <= adm.shared_pages:
                    rings.setdefault(d, snap)
        prompt = np.asarray(task.tokens[0, :task.prompt_len], np.int32)
        entry = self.prefix_index.insert(prompt, list(adm.ptab.pages), rings,
                                         task.cache, task.scratch)
        if entry is None:
            return
        cap = max(1, self.engine.scfg.prefix_cache_entries)
        while len(self.prefix_index.entries) > cap:
            self.prefix_index.evict(self.prefix_index.lru_entry(
                exclude=entry))
        # the entry's own copy, taken once the entries over the cap are
        # gone: no more state is alive than when each task owned its own
        entry.cache, entry.scratch = self.engine.prefill_state_copy(task)
