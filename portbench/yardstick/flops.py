"""Model FLOPs of a decode step, from a configuration's sizes: the matrix
products at the step's rows, and the attention over the tokens each
layer attends (every earlier token in a full-precision layer; the sink,
the recent window and the top n_critical of the selectable tokens in a
SALS layer).  This is the work the model needs, not what any kernel
does: the numerator of ``decode_mfu``."""
from __future__ import annotations

from typing import Iterable

from portbench.spec import ModelSpec


def attended(spec: ModelSpec, pos: int, sals_layer: bool) -> int:
    """Tokens a decode query at position ``pos`` attends in one layer."""
    if not sals_layer:
        return pos + 1
    s = spec.sals
    selectable = max(0, pos - s.n_recent - s.n_sink + 1)
    return min(s.n_sink, pos + 1) + min(s.n_recent, pos + 1) \
        + min(s.n_critical, selectable)


def decode_step_flops(spec: ModelSpec, positions: Iterable[int]) -> float:
    """FLOPs of one decode step whose rows sit at ``positions``."""
    d, f = spec.d_model, spec.d_ff
    per_layer = d * spec.q_dim + 2 * d * spec.kv_dim + spec.q_dim * d \
        + 3 * d * f
    gemm = 2.0 * (spec.n_layers * per_layer + d * spec.vocab_size)
    total = 0.0
    for pos in positions:
        att = sum(attended(spec, int(pos), spec.sals_layer(l))
                  for l in range(spec.n_layers))
        total += gemm + 4.0 * spec.n_heads * spec.head_dim * att
    return total
