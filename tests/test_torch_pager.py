"""Port parity for the host-side page allocator: the same seeded random
sequences of alloc, share, free, page-table growth, copy-on-write, release
and prefix insert / match / touch / evict go through ``repro.core.pager``
and the port's copy ``repro_torch.core.pager``.  After every operation the
result (or the class of the exception raised), the free list, the
refcounts, every table, the prefix entries with their LRU clocks and the
auditor's verdict must be identical."""
import numpy as np
import pytest

from repro.core import pager as jpager
from repro_torch.core import pager as tpager

PS, N_PAGES, MAX_PAGES = 4, 13, 6
OPS = ("alloc", "free", "new_table", "append", "share_into", "ensure_pos",
       "cow", "release", "insert", "match", "touch", "evict_lru", "audit")


def _drive(mod, seed: int, n_ops: int = 300):
    """Apply a seeded random op sequence; return the observable trace."""
    rng = np.random.default_rng(seed)
    pool = mod.PagePool(N_PAGES, PS, n_reserved=1)
    index = mod.PrefixIndex(pool)
    tables, loose = [], []             # page tables; bare alloc()ed pages
    head = rng.integers(1, 50, 3 * PS)
    trace = []
    for _ in range(n_ops):
        op = OPS[int(rng.integers(len(OPS)))]
        t = tables[int(rng.integers(len(tables)))] if tables else None
        try:
            if op == "alloc":
                out = pool.alloc()
                loose.append(out)
            elif op == "free":
                out = pool.free(loose.pop()) if loose else None
            elif op == "new_table":
                tables.append(mod.PageTable(pool, MAX_PAGES))
                out = len(tables)
            elif op == "append" and t is not None:
                out = t.append_page()
            elif op == "share_into" and t is not None:
                live = [p for tb in tables for p in tb.pages]
                out = t.append_shared(live[int(rng.integers(len(live)))]) \
                    if live else None
            elif op == "ensure_pos" and t is not None:
                out = t.ensure_for_position(int(rng.integers(MAX_PAGES * PS)))
            elif op == "cow" and t is not None and t.pages:
                out = t.ensure_exclusive(int(rng.integers(t.n_pages)))
            elif op == "release" and t is not None:
                out = t.release_all()
            elif op == "insert" and t is not None:
                toks = np.concatenate([head[:int(rng.integers(1, 3)) * PS],
                                       rng.integers(1, 50, 2 * PS)])
                toks = toks[:t.n_pages * PS + int(rng.integers(PS))]
                e = index.insert(toks, list(t.pages), {}, None, None)
                out = None if e is None else e.page_ids
            elif op == "match":
                toks = np.concatenate([head, rng.integers(1, 50, PS)])
                e, depth = index.match(toks[:int(rng.integers(1, 4 * PS))])
                out = (None if e is None else e.page_ids, depth)
            elif op == "touch" and index.entries:
                es = index.entries
                index.touch(es[int(rng.integers(len(es)))])
                out = None
            elif op == "evict_lru":
                e = index.lru_entry()
                out = None if e is None else e.page_ids
                if e is not None:
                    index.evict(e)
            elif op == "audit":
                mod.audit_pager(pool, tables, index.entries)
                out = "ok"
            else:
                out = None
        except Exception as exc:        # compared by class name
            out = type(exc).__name__
        trace.append((op, out, list(pool._free), pool._ref.tolist(),
                      [list(tb.pages) for tb in tables],
                      [(e.page_ids, e.last_used, e.hits, e.tokens.tolist())
                       for e in index.entries]))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pager_sequences_match_reference(seed):
    ref, port = _drive(jpager, seed), _drive(tpager, seed)
    for step, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"step {step}: {a[0]}"
    # the sequences reach the interesting states
    assert any(o == "PoolExhausted" for _, o, *_ in ref)
    assert any(op == "match" and o[1] > 0 for op, o, *_ in ref)


def test_pool_exhaustion_and_reserved_trash_page():
    pool = tpager.PagePool(3, PS, n_reserved=1)
    got = {pool.alloc(), pool.alloc()}
    assert got == {1, 2}                   # page 0 is never handed out
    with pytest.raises(tpager.PoolExhausted):
        pool.alloc()
    table = tpager.PageTable(pool, 4)
    table.append_shared(1)
    with pytest.raises(tpager.PagerInvariantError):
        tpager.audit_pager(pool, [table], [])   # page 2 leaked, 1 over-held
