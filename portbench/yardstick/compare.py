"""The comparison that decides ``correct`` for a served model.

Each served token is judged by the reference's logits at its position:
its gap is how far its logit lies below the reference's best there.  A
greedy server that computes what the reference computes serves the
reference's argmax or a near tie of it, so every gap is rounding; a
server that computes something else serves tokens the reference ranks
lower.  The number compared is the widest gap over every served token
checked.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def token_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """logits (n, V) of the reference at the positions that served
    ``tokens`` (n,): max(logits) - logits[token], f32 (n,)."""
    lg = logits.float()
    picked = lg.gather(1, tokens.long().to(lg.device)[:, None])[:, 0]
    return lg.max(dim=1).values - picked


def widest_gap(logits: Sequence[torch.Tensor],
               tokens: Sequence[torch.Tensor]) -> float:
    """The widest gap over every (logits, tokens) pair."""
    return max(float(token_gaps(lg, t).max()) for lg, t in zip(logits, tokens))


def control_gap(ref_logits: Sequence[torch.Tensor],
                low_logits: Sequence[torch.Tensor]) -> float:
    """The control's reading: at each position, the gap in the reference's
    logits of the token that the lower-precision run puts first."""
    return widest_gap(ref_logits, [lg.argmax(dim=1) for lg in low_logits])


# -- the cache a run wrote ------------------------------------------------------
#
# The served tokens alone barely see a step's state at long context: over
# 32k positions the last thousand tokens carry little of any attention
# row, so a step that wrote nothing moves few argmaxes.  A run's cache is
# therefore judged too, at the positions its steps wrote: each field as
# the reference says the cache holds it for the same tokens (see
# ``DenseSals.state``), by its relative error.


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in f32 (nan where ``got`` is not
    finite)."""
    want = want.float()
    diff = got.float().to(want.device) - want
    return float(diff.norm() / want.norm().clamp_min(1e-30))


def worst(values) -> float:
    """The largest of ``values``, nan if any is nan."""
    values = [float(v) for v in values]
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def held(state: dict, n: int, ring: int) -> dict:
    """What a layer's cache holds of a reference state
    (``DenseSals.state``) after its first ``n`` tokens are written: each
    field at those n positions, and for a SALS layer its recent ring, the
    keys and values at full precision of the last ``ring`` of them (in
    position order)."""
    if "k_rec" in state:
        m = min(n, ring)
        return {"k_rec": state["k_rec"][:n], "v_deq": state["v_deq"][:n],
                "ring_k": state["k_pre"][n - m:n],
                "ring_v": state["v"][n - m:n]}
    return {"k_rot": state["k_rot"][:n], "v": state["v"][:n]}


def state_err(got: dict, want: dict) -> float:
    """The largest relative error over the fields of ``got`` (each held
    to the field of the same name in ``want``)."""
    return worst(rel_err(t, want[name]) for name, t in got.items())
