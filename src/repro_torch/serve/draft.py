"""Self-speculative drafting: n-gram prompt lookup (a copy of
``repro/serve/draft.py``, which imports no JAX).

The verify window needs Q−1 cheap draft tokens per decode round.  They are
drafted WITHOUT a second model: the request's own token history (prompt +
everything committed so far) is scanned for the most recent earlier
occurrence of its trailing n-gram, and the tokens that followed it are
proposed as the continuation — "prompt lookup" decoding.  On repetitive
spans (code, quotations, structured output) the acceptance rate is high; on
novel text the drafts are rejected and the engine degrades to sequential
decode at one extra verify per round.

Drafting is host-side, pure Python, deterministic, and O(history) per
proposal.  Correctness never depends on draft quality: the windowed verify
commits only the longest prefix whose greedy continuations match, so any
proposal (even garbage) yields token-exact output.
"""
from __future__ import annotations

from typing import Iterable, List


class NgramDrafter:
    """Per-request prompt-lookup draft state.

    ``history`` accumulates the prompt followed by every token the request
    has emitted (including the current pending token).  :meth:`propose`
    returns draft continuations for the verify window; :meth:`extend`
    appends newly committed tokens after each verify round.
    """

    def __init__(self, history: Iterable[int], max_order: int = 3):
        if max_order < 1:
            raise ValueError("max_order must be >= 1")
        self.history: List[int] = [int(t) for t in history]
        self.max_order = max_order

    def extend(self, tokens: Iterable[int]) -> None:
        self.history.extend(int(t) for t in tokens)

    def propose(self, n_draft: int) -> List[int]:
        """Propose ``n_draft`` tokens continuing ``history``.

        Longest-match first: for order n = max_order..1, find the LATEST
        earlier position whose preceding n tokens equal the history's
        trailing n-gram, and copy the tokens that followed it.  If the
        copied span runs off the end of history, the remainder falls
        through to lower orders and finally to repeating the last token
        (an always-available guess that keeps the window full — rejection
        costs nothing but the already-amortized verify slot).
        """
        if n_draft <= 0:
            return []
        h = self.history
        if not h:
            return [0] * n_draft
        for n in range(min(self.max_order, len(h) - 1), 0, -1):
            tail = h[-n:]
            # latest earlier occurrence: scan right-to-left over starts of
            # n-grams that are followed by at least one token
            for i in range(len(h) - n - 1, -1, -1):
                if h[i:i + n] == tail:
                    cont = h[i + n:i + n + n_draft]
                    if cont:
                        pad = cont[-1]
                        return (cont + [pad] * (n_draft - len(cont)))[:n_draft]
        return [h[-1]] * n_draft
