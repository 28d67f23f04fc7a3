"""Paged latent-cache block-pool allocator + prefix index (a copy of
``repro/core/pager.py``, which imports no JAX: the port keeps its own).

The dense slot arena preallocates ``(L, B, max_seq, ·)`` for every
slot: a 128-token request pins the same HBM as a 4k one, and N requests
sharing a system prompt each store their own copy of its compressed cache.
This module is the HOST-side memory manager that replaces it:

``PagePool``
    A refcounted fixed-size block-pool allocator over ``n_pages`` physical
    pages of ``page_size`` tokens each.  Free pages live on a stack —
    O(1) alloc and free, no fragmentation (every page is interchangeable).
    Refcounts implement copy-on-write prefix sharing: a page referenced by
    k sequences has refcount k and is only recycled when the last reference
    drops.  The pool never touches device memory — the device side is the
    ``(L, n_pages, page_size, ·)`` pool arrays carried by
    :class:`~repro_torch.core.latent_cache.LatentKVCache` and indexed through
    per-sequence page tables.

``PageTable``
    One sequence's logical→physical page map: ``pages[j]`` is the physical
    page holding logical positions ``[j·ps, (j+1)·ps)``.  Appending a token
    past the mapped range allocates exactly one page (fragmentation-free
    append); releasing returns every page to the pool (decref — shared
    prefix pages survive until their other owners release them).

``PrefixIndex``
    A token-id radix/prefix trie at PAGE granularity.  Each edge is one
    page's worth of token ids; a node registered by an admitted request
    records the physical page chain of its prefix plus the prefill-resume
    state (SALS ring snapshot at the page boundary, captured during the
    registrant's own chunked prefill).  A later request whose prompt shares
    the prefix maps its leading page-table entries to the SAME physical
    pages (refcount bump — one stored copy of the prefix) and resumes its
    chunked prefill at the boundary — one prefill of the shared pages,
    total.  Divergence only ever writes into fresh or exclusive pages by
    construction (sharing is whole-page and capped below the last prompt
    token), so COW (:meth:`PageTable.ensure_exclusive`) stays a guarded
    safety net rather than a hot path: it fires only if a future sharing
    policy ever maps a writable page to multiple owners.

Sizing rule (also documented on ``ServeConfig``): page-table overhead is
4 bytes per page = ``4 / page_size`` bytes/token — at the paper config
(r=1024 bf16 latents ≈ 2 KiB/token) even page_size=16 costs < 0.02%.
Small pages waste less tail (half a page per sequence on average) and
share prefixes at finer granularity; the floor is DMA efficiency of the
reconstruct pass (one page = one DMA burst).  ``page_size`` must divide
``max_seq_len`` and be a multiple of ``prefill_chunk`` (prefix-resume
boundaries are chunk-aligned).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class PoolExhausted(RuntimeError):
    """No free page: admission must stall or a resident must be evicted."""


class PagerInvariantError(RuntimeError):
    """A pager bookkeeping invariant is broken (page leak, double free,
    refcount drift, gauge mismatch).  Typed — unlike the ``assert``-based
    checks it replaces, it survives ``python -O`` and can be caught and
    reported by the serving loop's auditor."""


# Fault-injection callback, wired by ``repro_torch.serve.faults.install`` (the
# pager must not import that module — the import would be cyclic through
# ``serve.__init__``).  None when injection is off: alloc pays one ``is
# not None`` check and nothing else.
_fault_hook = None


class PagePool:
    """Refcounted block-pool allocator (host-side bookkeeping only)."""

    def __init__(self, n_pages: int, page_size: int, n_reserved: int = 0):
        """``n_reserved`` pages at the bottom are never allocated — the
        serving path reserves physical page 0 as the TRASH page: unmapped
        page-table entries are 0, so an idle slot's parked write (position
        0) and an unmapped logical page's masked read both land there
        without touching any live page."""
        if n_pages < 1 or page_size < 1:
            raise ValueError(f"need n_pages >= 1 and page_size >= 1, got "
                             f"{n_pages}/{page_size}")
        if n_reserved >= n_pages:
            raise ValueError(f"n_reserved {n_reserved} >= n_pages {n_pages}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_reserved = n_reserved
        self._free: List[int] = list(range(n_pages - 1, n_reserved - 1, -1))
        self._ref = np.zeros((n_pages,), np.int32)

    # -- alloc / free -------------------------------------------------------

    def alloc(self) -> int:
        """Pop a free page (refcount 1).  O(1).  Raises PoolExhausted."""
        if _fault_hook is not None:
            _fault_hook("page_alloc")
        if not self._free:
            raise PoolExhausted(f"all {self.n_pages} pages in use")
        pid = self._free.pop()
        if self._ref[pid] != 0:
            raise PagerInvariantError(f"free-stack page {pid} has refcount "
                                      f"{int(self._ref[pid])}")
        self._ref[pid] = 1
        return pid

    def try_alloc(self) -> Optional[int]:
        return self.alloc() if self._free else None

    def share(self, pid: int) -> int:
        """Add a reference to a live page (prefix sharing).  O(1)."""
        if self._ref[pid] <= 0:
            raise ValueError(f"share of free page {pid}")
        self._ref[pid] += 1
        return pid

    def free(self, pid: int) -> None:
        """Drop one reference; the page returns to the pool at zero.  O(1)."""
        if self._ref[pid] <= 0:
            raise ValueError(f"double free of page {pid}")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)

    def refcount(self, pid: int) -> int:
        return int(self._ref[pid])

    # -- accounting ---------------------------------------------------------

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Live (allocated) pages — reserved/trash pages don't count."""
        return self.n_pages - self.n_reserved - len(self._free)

    @property
    def token_capacity_free(self) -> int:
        """Live-token headroom: tokens storable without any eviction."""
        return self.pages_free * self.page_size

    def check(self) -> None:
        """Internal consistency: refcounts vs the free list.  Raises
        :class:`PagerInvariantError` (not ``assert`` — ``python -O`` must
        not strip the serving loop's safety net)."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise PagerInvariantError("free list has duplicates")
        for pid in range(self.n_reserved, self.n_pages):
            if pid in free:
                if self._ref[pid] != 0:
                    raise PagerInvariantError(
                        f"free page {pid} has {int(self._ref[pid])} refs")
            elif self._ref[pid] <= 0:
                raise PagerInvariantError(f"live page {pid} has no refs")
        for pid in range(self.n_reserved):
            if self._ref[pid] != 0 or pid in free:
                raise PagerInvariantError(
                    f"reserved page {pid} leaked into circulation")


class PageTable:
    """One sequence's logical→physical page map over a shared PagePool."""

    def __init__(self, pool: PagePool, max_pages: int):
        self.pool = pool
        self.max_pages = max_pages
        self.pages: List[int] = []

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    def pages_for_tokens(self, n_tokens: int) -> int:
        return -(-n_tokens // self.pool.page_size)

    def append_page(self) -> int:
        """Map the next logical page to a fresh physical page."""
        if len(self.pages) >= self.max_pages:
            raise ValueError(f"sequence exceeds {self.max_pages} pages")
        pid = self.pool.alloc()
        self.pages.append(pid)
        return pid

    def append_shared(self, pid: int) -> int:
        """Map the next logical page to an EXISTING page (prefix sharing)."""
        if len(self.pages) >= self.max_pages:
            raise ValueError(f"sequence exceeds {self.max_pages} pages")
        self.pages.append(self.pool.share(pid))
        return pid

    def ensure_for_position(self, pos: int) -> List[int]:
        """Allocate through the page containing ``pos``; returns new pids."""
        need = pos // self.pool.page_size + 1
        fresh = []
        while len(self.pages) < need:
            fresh.append(self.append_page())
        return fresh

    def ensure_exclusive(self, logical_page: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write: make ``logical_page`` safe to mutate.

        If the mapped physical page is shared (refcount > 1), allocate a
        fresh page, remap, and drop the old reference.  Returns
        ``(old_pid, new_pid)`` when a copy is needed (the CALLER must copy
        the device bytes old→new before writing), else None.
        """
        pid = self.pages[logical_page]
        if self.pool.refcount(pid) <= 1:
            return None
        new = self.pool.alloc()
        self.pool.free(pid)
        self.pages[logical_page] = new
        return pid, new

    def release_all(self) -> None:
        for pid in self.pages:
            self.pool.free(pid)
        self.pages = []

    def as_row(self, fill: int = 0) -> np.ndarray:
        """Device-table row: (max_pages,) int32, unmapped entries ``fill``
        (kernels clamp + mask unmapped logical pages, so 0 is safe)."""
        row = np.full((self.max_pages,), fill, np.int32)
        row[:len(self.pages)] = self.pages
        return row


# ---------------------------------------------------------------------------
# Prefix sharing: page-granular token-id radix trie
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class PrefixEntry:
    """One registered prompt prefix (inserted at admission).

    ``eq=False``: entries are IDENTITY objects.  Field-wise dataclass
    equality would compare the numpy ``tokens`` arrays elementwise —
    ``PrefixIndex.evict``'s ``list.remove`` walks the entry list comparing
    candidates, and two entries with different prefix lengths would raise
    a broadcast ValueError before the victim is even reached (found by
    the chaos census in tests/test_chaos.py).

    ``page_ids``       physical pages of the whole-page prefix; the entry
                       holds its OWN refcount on each (released on evict).
    ``boundary_rings`` {n_pages -> per-SALS-seg (recent_k, recent_v) device
                       snapshots} captured at page boundaries during the
                       registrant's chunked prefill — the only prefill
                       state that is NOT append-only, so the only piece a
                       resumed prefill cannot take from the final snapshot.
    ``cache``/``scratch``  the registrant's finished single-request cache +
                       SALS prompt-K/V scratch (append-only: a resume at
                       boundary d reads only positions < d·ps, which are
                       identical at every later boundary).
    """
    tokens: np.ndarray
    page_ids: Tuple[int, ...]
    boundary_rings: Dict[int, Any]
    cache: Any
    scratch: Any
    hits: int = 0
    last_used: int = 0           # PrefixIndex use-clock (LRU eviction)


class PrefixIndex:
    """Token-id radix trie, one edge per PAGE of token ids.

    ``match`` returns the deepest registered entry sharing whole pages with
    the prompt and how many of its pages are usable; ``insert`` registers a
    finished prefill.  Entries pin their pages via pool refcounts, so a
    registrant's slot can be freed without un-sharing the prefix.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._root: dict = {}
        self._entries: List[PrefixEntry] = []
        self._clock = 0

    @property
    def entries(self) -> List[PrefixEntry]:
        return list(self._entries)

    def lru_entry(self, exclude: Optional[PrefixEntry] = None
                  ) -> Optional[PrefixEntry]:
        """Least-recently-USED entry — the eviction victim under pool
        pressure (a hot shared system prompt outlives one-shot prefixes).
        ``exclude`` shields one entry (an in-flight reservation's match)."""
        return min((e for e in self._entries if e is not exclude),
                   key=lambda e: e.last_used, default=None)

    def touch(self, entry: PrefixEntry) -> None:
        """Record a use (prefix hit): bumps the LRU clock + hit count."""
        self._clock += 1
        entry.last_used = self._clock
        entry.hits += 1

    def _key(self, tokens: np.ndarray, j: int) -> bytes:
        ps = self.page_size
        return np.asarray(tokens[j * ps:(j + 1) * ps], np.int32).tobytes()

    def insert(self, tokens: np.ndarray, page_ids: List[int],
               boundary_rings: Dict[int, Any], cache, scratch
               ) -> Optional[PrefixEntry]:
        """Register a finished prefill.  Takes its OWN reference on every
        whole-page page id.  Returns the entry (None for sub-page prompts
        or exact duplicates)."""
        n_whole = len(tokens) // self.page_size
        if n_whole == 0:
            return None
        node = self._root
        for j in range(n_whole):
            node = node.setdefault(self._key(tokens, j), {})
        if "entry" in node:
            return None                       # identical prefix already held
        self._clock += 1
        entry = PrefixEntry(
            tokens=np.asarray(tokens[:n_whole * self.page_size], np.int32),
            page_ids=tuple(page_ids[:n_whole]),
            boundary_rings=boundary_rings, cache=cache, scratch=scratch,
            last_used=self._clock)
        for pid in entry.page_ids:
            self.pool.share(pid)
        node["entry"] = entry
        self._entries.append(entry)
        return entry

    def match(self, tokens: np.ndarray) -> Tuple[Optional[PrefixEntry], int]:
        """Deepest whole-page prefix of ``tokens`` shared with any
        registered entry.

        Returns ``(entry, n_pages)``: the prompt's leading ``n_pages``
        pages are token-identical to ``entry.page_ids[:n_pages]``.  The
        entry need not sit exactly at that depth — any entry in the
        subtree BELOW the deepest matched trie node works, because its
        prefix extends the matched path and page contents derive
        deterministically from the token prefix (same tokens → same
        bytes), and every entry carries boundary rings for each of its
        page boundaries.  This is what makes N same-system-prompt requests
        with multi-page unique suffixes still share the system pages.
        The caller caps the shared count below its last prompt token.
        """
        node = self._root
        depth = 0
        n_whole = len(tokens) // self.page_size
        for j in range(n_whole):
            nxt = node.get(self._key(tokens, j))
            if nxt is None:
                break
            node, depth = nxt, j + 1
        if depth == 0:
            return None, 0
        entry = self._subtree_entry(node)
        return (entry, depth) if entry is not None else (None, 0)

    def _subtree_entry(self, node: dict) -> Optional[PrefixEntry]:
        """Any entry at or below ``node`` (most-recently-used preferred)."""
        best = node.get("entry")
        for key, child in node.items():
            if key == "entry":
                continue
            cand = self._subtree_entry(child)
            if cand is not None and (best is None
                                     or cand.last_used > best.last_used):
                best = cand
        return best

    def evict(self, entry: PrefixEntry) -> None:
        """Drop an entry: release its page references + trie path."""
        self._entries.remove(entry)
        for pid in entry.page_ids:
            self.pool.free(pid)
        node, path = self._root, []
        n_whole = len(entry.tokens) // self.page_size
        for j in range(n_whole):
            key = self._key(entry.tokens, j)
            path.append((node, key))
            node = node[key]
        node.pop("entry", None)
        for parent, key in reversed(path):    # prune childless nodes
            if not parent[key]:
                parent.pop(key)


# ---------------------------------------------------------------------------
# Cross-structure invariant auditor
# ---------------------------------------------------------------------------

def audit_pager(pool: PagePool, tables, entries, gauges=None,
                parked=None) -> None:
    """Prove page conservation across every structure that holds pages.

    ``tables``   iterable of live :class:`PageTable` (one per resident or
                 in-flight admission, INCLUDING the detached tables of
                 parked requests — a park holds pages, it does not hide
                 them from conservation);
    ``entries``  iterable of live :class:`PrefixEntry` (each pins its
                 ``page_ids`` with its own refcounts);
    ``gauges``   optional dict with ``pages_in_use`` / ``pages_free`` as
                 exported by the scheduler's ``pool_gauges`` rows;
    ``parked``   optional iterable of page ids (with multiplicity) held by
                 PARKED requests' tables.  Each must be a live,
                 non-reserved page; under tiering the parked multiset is
                 forwarded to ``audit_tiers`` for the park residency rules
                 (parked pages are never pinned and never fresh).

    Invariants (each failure raises :class:`PagerInvariantError`):
      1. pool-internal: free stack vs refcounts (:meth:`PagePool.check`);
      2. per-page conservation: for every non-reserved page, the pool
         refcount equals (table references) + (prefix-entry pins) — no
         orphaned refs (leak) and no structure referencing a freed page
         (use-after-free);
      3. global conservation: free + live == n_pages − n_reserved (implied
         by 1, restated over the external census so a drifted gauge or a
         table row pointing at a reserved page is caught here);
      4. gauge consistency with the pool;
      5. tier conservation when the pool is a
         :class:`~repro_torch.core.tiering.TieredPagePool` (hot ⊎ cold ⊎
         fresh ⊎ in-flight == live pages, hot-slot uniqueness, pins
         hot-only — see its ``audit_tiers``).
    """
    pool.check()
    held = np.zeros((pool.n_pages,), np.int64)
    for t in tables:
        for pid in t.pages:
            if not (0 <= pid < pool.n_pages):
                raise PagerInvariantError(f"table maps bogus page {pid}")
            if pid < pool.n_reserved:
                raise PagerInvariantError(
                    f"table maps reserved/trash page {pid}")
            held[pid] += 1
    for e in entries:
        for pid in e.page_ids:
            if not (pool.n_reserved <= pid < pool.n_pages):
                raise PagerInvariantError(
                    f"prefix entry pins bogus page {pid}")
            held[pid] += 1
    free = set(pool._free)
    for pid in range(pool.n_reserved, pool.n_pages):
        ref = pool.refcount(pid)
        if held[pid] != ref:
            kind = "leaked (pool ref without owner)" if ref > held[pid] \
                else "over-referenced (owner without pool ref)"
            raise PagerInvariantError(
                f"page {pid} {kind}: pool refcount {ref}, "
                f"table refs + prefix pins {int(held[pid])}")
        if held[pid] > 0 and pid in free:
            raise PagerInvariantError(
                f"page {pid} is on the free stack but referenced")
    n_live = int(np.count_nonzero(held[pool.n_reserved:]))
    if pool.pages_free + n_live != pool.n_pages - pool.n_reserved:
        raise PagerInvariantError(
            f"conservation broken: {pool.pages_free} free + {n_live} live "
            f"!= {pool.n_pages} - {pool.n_reserved} reserved")
    if gauges is not None:
        for key, want in (("pages_in_use", pool.pages_in_use),
                          ("pages_free", pool.pages_free)):
            if key in gauges and gauges[key] != want:
                raise PagerInvariantError(
                    f"gauge {key}={gauges[key]} drifted from pool {want}")
    if parked:
        for pid in parked:
            if not (pool.n_reserved <= pid < pool.n_pages):
                raise PagerInvariantError(
                    f"parked request holds bogus/reserved page {pid}")
            if pid in free or pool.refcount(pid) == 0:
                raise PagerInvariantError(
                    f"parked request holds freed page {pid}")
    # duck-typed so this module never imports core.tiering (which imports
    # the fault hook from here — the same acyclicity rule as serve.faults)
    audit_tiers = getattr(pool, "audit_tiers", None)
    if audit_tiers is not None:
        audit_tiers(gauges, parked=parked)
