"""Two-tier page pool: device hot tier + host-memory cold tier (a copy of
``repro/core/tiering.py``, which imports no JAX: the port keeps its own,
without the telemetry hook, which comes with its slice).

SALS's structure makes offload cheap:

* the score pass only ever reads the leading ``r*`` latent columns of
  every live token — a dedicated ``k_score`` device pool keeps those
  columns resident for EVERY live page, so ``latent_topk`` is oblivious to
  tiering and selection is always computed from true data;
* the reconstruct pass touches only the top-k pages, so only those pages'
  full-``r`` latent + quantized-V payloads need to be hot, and the payload
  pool shrinks to ``hbm_pages`` device slots however many pages are live;
* the paper's stability insight (latent representations persist across
  layers ⇒ the selected set persists across steps, measured by
  ``core.metrics.overlap_score``) makes the PREVIOUS step's selection a
  prefetch oracle for the next one.

:class:`TieredPagePool` extends the refcounted :class:`PagePool` with
per-page residency.  Every live page is in exactly ONE of four states:

``fresh``      allocated, no payload written yet (reserved-ahead pages of
               an in-flight admission, or a growth page before its first
               token) — occupies no device slot and no host mirror;
``hot``        payload resident in device slot ``hot[pid]`` (1-based —
               slot 0 of the device payload pools is the trash slot,
               mirroring physical page 0 of the score pool);
``cold``       payload spilled to the host mirror ``cold[pid]`` (an
               opaque per-segment dict of pinned host tensors owned by the
               serving engine);
``in_flight``  mid-transfer between tiers (transient within one
               scheduler operation; empty at every audit point).

Tier moves are split into ``begin_*`` / ``finish_*`` pairs so the fault
hook (``core.pager._fault_hook``, wired by ``serve.faults.install``) fires
in plain Python BEFORE any state change or device transfer — an injected
``host_fetch`` / ``spill`` fault leaves the page in its prior tier, so
both points are retry-safe.  A finished fetch / spill reports
``tier_fetch`` / ``tier_spill`` through the telemetry hook
(``core.pager._metrics_hook``, wired by ``obs.metrics.install``), one
``is None`` check when telemetry is off.

The pool never touches device memory itself: the engine owns the copies
(``ServeEngine.load_page`` / ``read_page_payload``); this class is the
host-side state machine + spill policy (LRU clock over ``touch``-ed pages,
write pages pinned hot).  ``audit_tiers`` extends ``audit_pager`` with
tier conservation: hot ⊎ cold ⊎ fresh ⊎ in-flight == live pages, hot-slot
uniqueness + conservation, pins only on hot pages.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.core import pager as _pager
from repro_torch.core.pager import PagePool, PagerInvariantError


class HotTierThrash(RuntimeError):
    """Every hot payload slot is pinned or needed by the current step —
    there is no spill victim.  TRANSIENT: the scheduler fails only the
    row that demanded the slot; its retry lands after other residents
    release pins (config guarantees hbm_pages >= max_batch + 1, so a
    sole resident can always pin its write page AND demand-fetch)."""

    transient = True


class TieredPagePool(PagePool):
    """Refcounted page pool with HBM-hot / host-cold payload residency."""

    def __init__(self, n_pages: int, page_size: int, hbm_slots: int,
                 n_reserved: int = 0):
        """``hbm_slots`` is the number of USABLE device payload slots —
        the engine sizes the device payload pools ``hbm_slots + 1`` deep
        (slot 0 = trash, never assigned).  ``n_pages`` stays the full
        logical capacity: the score pool and the page table are sized by
        it, so live pages are bounded by host RAM, not HBM."""
        super().__init__(n_pages, page_size, n_reserved)
        if hbm_slots < 1:
            raise ValueError(f"need hbm_slots >= 1, got {hbm_slots}")
        self.hbm_slots = hbm_slots
        self.hot: Dict[int, int] = {}            # pid -> device slot
        self.cold: Dict[int, Any] = {}           # pid -> host mirror
        self.fresh: Set[int] = set()             # allocated, unwritten
        # pid -> ("fetch", mirror) | ("spill", slot) during a transfer
        self.in_flight: Dict[int, Tuple[str, Any]] = {}
        self.pins: Dict[int, int] = {}           # pid -> pin count (hot only)
        self._slots_free: List[int] = list(range(hbm_slots, 0, -1))
        self._lru: Dict[int, int] = {}
        self._tick = 0
        self.spills = 0                          # cumulative tier moves
        self.fetches = 0

    # -- allocation (residency-aware) ---------------------------------------

    def alloc(self) -> int:
        pid = super().alloc()
        self.fresh.add(pid)
        return pid

    def free(self, pid: int) -> None:
        super().free(pid)
        if self._ref[pid] == 0:
            if self.pins.get(pid):
                raise PagerInvariantError(
                    f"page {pid} freed while write-pinned")
            if pid in self.in_flight:
                raise PagerInvariantError(f"page {pid} freed mid-transfer")
            slot = self.hot.pop(pid, None)
            if slot is not None:
                self._slots_free.append(slot)
            self.cold.pop(pid, None)
            self.fresh.discard(pid)
            self._lru.pop(pid, None)

    # -- residency queries --------------------------------------------------

    @property
    def host_pages(self) -> int:
        return len(self.cold)

    @property
    def slots_free(self) -> int:
        return len(self._slots_free)

    def residency(self, pid: int) -> str:
        if pid in self.hot:
            return "hot"
        if pid in self.cold:
            return "cold"
        if pid in self.fresh:
            return "fresh"
        if pid in self.in_flight:
            return "in_flight"
        raise PagerInvariantError(f"page {pid} has no residency state")

    # -- LRU / pinning ------------------------------------------------------

    def touch(self, pids: Iterable[int]) -> None:
        """Record a use of hot pages (this step's selected set)."""
        self._tick += 1
        for pid in pids:
            self._lru[pid] = self._tick

    def pin(self, pid: int) -> None:
        """Pin a hot page against spilling (the per-row WRITE page — the
        decode write path lands in it via the hot table every step)."""
        if pid not in self.hot:
            raise PagerInvariantError(f"pin of non-hot page {pid}")
        self.pins[pid] = self.pins.get(pid, 0) + 1

    def unpin(self, pid: int) -> None:
        n = self.pins.get(pid, 0)
        if n <= 0:
            raise PagerInvariantError(f"unpin of unpinned page {pid}")
        if n == 1:
            del self.pins[pid]
        else:
            self.pins[pid] = n - 1

    def spill_victim(self, exclude: Iterable[int] = ()) -> Optional[int]:
        """Least-recently-touched hot page that is neither pinned nor in
        ``exclude`` (the set about to be read).  None ⇒ hot tier thrash —
        the caller degrades (transient per-row failure), never evicts."""
        skip = set(exclude)
        cands = [p for p in self.hot
                 if p not in self.pins and p not in skip]
        if not cands:
            return None
        return min(cands, key=lambda p: self._lru.get(p, 0))

    # -- slot management ----------------------------------------------------

    def take_slot(self) -> Optional[int]:
        """Pop a free device payload slot (1-based), or None."""
        return self._slots_free.pop() if self._slots_free else None

    def give_slot(self, slot: int) -> None:
        """Return a slot taken with :meth:`take_slot` but never assigned
        (the fetch it was claimed for faulted before any state change)."""
        self._slots_free.append(slot)

    def set_hot(self, pid: int, slot: int) -> None:
        """First residency of a fresh page: device slot, no transfer
        (admission scatter or a growth page whose bytes arrive via the
        pinned decode write path — garbage until then, unselectable by
        the per-row position masks, as with recycled pages)."""
        self.fresh.remove(pid)
        self.hot[pid] = slot
        self.touch([pid])

    def set_cold(self, pid: int, mirror: Any) -> None:
        """First residency of a fresh page: host mirror, no device slot
        (admission overflow past the hot tier, or a COW copy of a cold
        source)."""
        self.fresh.remove(pid)
        self.cold[pid] = mirror

    # -- tier transfers (fault points fire BEFORE any state change) ---------

    def begin_fetch(self, pid: int) -> Any:
        """Start a host→HBM fetch: returns the mirror payload the engine
        must load into a device slot.  Fires the ``host_fetch`` fault
        point first — an injected fault leaves the page cold."""
        if _pager._fault_hook is not None:
            _pager._fault_hook("host_fetch")
        if pid not in self.cold:
            raise PagerInvariantError(f"fetch of non-cold page {pid}")
        mirror = self.cold.pop(pid)
        self.in_flight[pid] = ("fetch", mirror)
        return mirror

    def finish_fetch(self, pid: int, slot: int) -> None:
        kind, _ = self.in_flight.pop(pid)
        if kind != "fetch":
            raise PagerInvariantError(f"finish_fetch of {kind} page {pid}")
        self.hot[pid] = slot
        self.fetches += 1
        if _pager._metrics_hook is not None:
            _pager._metrics_hook("tier_fetch")
        self.touch([pid])

    def abort_fetch(self, pid: int) -> None:
        kind, mirror = self.in_flight.pop(pid)
        if kind != "fetch":
            raise PagerInvariantError(f"abort_fetch of {kind} page {pid}")
        self.cold[pid] = mirror

    def begin_spill(self, pid: int) -> int:
        """Start an HBM→host spill: returns the device slot the engine
        must read the payload from.  Fires the ``spill`` fault point
        first — an injected fault leaves the page hot."""
        if _pager._fault_hook is not None:
            _pager._fault_hook("spill")
        if pid not in self.hot:
            raise PagerInvariantError(f"spill of non-hot page {pid}")
        if self.pins.get(pid):
            raise PagerInvariantError(f"spill of pinned page {pid}")
        slot = self.hot.pop(pid)
        self.in_flight[pid] = ("spill", slot)
        return slot

    def finish_spill(self, pid: int, mirror: Any) -> None:
        kind, slot = self.in_flight.pop(pid)
        if kind != "spill":
            raise PagerInvariantError(f"finish_spill of {kind} page {pid}")
        self._slots_free.append(slot)
        self.cold[pid] = mirror
        self.spills += 1
        if _pager._metrics_hook is not None:
            _pager._metrics_hook("tier_spill")

    # -- audit ---------------------------------------------------------------

    def audit_tiers(self, gauges=None, parked=None) -> None:
        """Tier conservation, called by :func:`~repro_torch.core.pager.
        audit_pager` after the refcount census:

          1. hot / cold / fresh / in-flight are pairwise disjoint and
             their union is EXACTLY the live (refcounted) pages;
          2. hot slots are unique, in ``[1, hbm_slots]``, and
             used + free + in-flight-spill slots == hbm_slots;
          3. pins only on hot pages, with positive counts;
          4. the ``host_pages`` gauge matches the cold tier.

        ``parked``: page ids (with multiplicity) held by PARKED requests.
        A parked request owns no batch slot, so its pages must never carry
        a write pin, and must not be fresh (a fresh page has never been
        written — a parked page holds committed tokens).  The scheduler
        also spills exclusively-parked pages cold so the preemption frees
        hot slots, but that is a LIVENESS property (a spill fault can leave
        a page hot until the next sweep retries it): the auditor checks
        only the safety rules.
        """
        tiers = (set(self.hot), set(self.cold), self.fresh,
                 set(self.in_flight))
        names = ("hot", "cold", "fresh", "in_flight")
        for i in range(len(tiers)):
            for j in range(i + 1, len(tiers)):
                both = tiers[i] & tiers[j]
                if both:
                    raise PagerInvariantError(
                        f"pages {sorted(both)} are both {names[i]} "
                        f"and {names[j]}")
        live = {pid for pid in range(self.n_reserved, self.n_pages)
                if self._ref[pid] > 0}
        union = set().union(*tiers)
        if union != live:
            raise PagerInvariantError(
                f"tier census broken: residency for {sorted(union - live)} "
                f"without refs, live pages {sorted(live - union)} without "
                f"residency")
        slots = list(self.hot.values()) + \
            [s for kind, s in self.in_flight.values() if kind == "spill"]
        if len(slots) != len(set(slots)):
            raise PagerInvariantError("duplicate hot-slot assignment")
        for s in slots:
            if not (1 <= s <= self.hbm_slots):
                raise PagerInvariantError(f"hot slot {s} out of range")
        if len(slots) + len(self._slots_free) != self.hbm_slots:
            raise PagerInvariantError(
                f"slot conservation broken: {len(slots)} used + "
                f"{len(self._slots_free)} free != {self.hbm_slots}")
        for pid, n in self.pins.items():
            if n <= 0:
                raise PagerInvariantError(f"page {pid} has pin count {n}")
            if pid not in self.hot:
                raise PagerInvariantError(f"non-hot page {pid} is pinned")
        if parked:
            for pid in set(parked):
                if self.pins.get(pid):
                    raise PagerInvariantError(
                        f"parked page {pid} is write-pinned (pins follow "
                        f"batch slots; a parked request owns none)")
                if pid in self.fresh:
                    raise PagerInvariantError(
                        f"parked page {pid} is fresh (never written) — a "
                        f"parked request holds only committed tokens")
        if gauges is not None and "host_pages" in gauges:
            if gauges["host_pages"] != len(self.cold):
                raise PagerInvariantError(
                    f"gauge host_pages={gauges['host_pages']} drifted "
                    f"from cold tier {len(self.cold)}")
