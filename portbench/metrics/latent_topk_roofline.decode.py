"""The latent top-k's share of its roofline, %: the least time the card
could take for every launch of the traced steps (``yardstick/cost.py``'s
``latent_topk_work`` at each launch's operands, the selectable rows as
the launch sees them, over ``yardstick/peaks.py``) over the device time
of its two kernels (the score pass and the selection)."""
import torch

from portbench.yardstick import cost, peaks

KERNELS = r"latent_score_pass|topk_select_kernel"


def read(ctx, out):
    steps = out.data.get("traced_positions") or []
    if out.trace is None or not steps:
        return None
    busy = out.trace.seconds_matching(KERNELS)
    if busy <= 0:
        return None
    s, m = ctx.spec, ctx.mix
    meta = dict(device="meta")
    b = m["rows"]
    q_lat = torch.empty((b, s.r_star), dtype=torch.float32, **meta)
    k_lat = torch.empty((b, m["max_seq_len"], s.r),
                        dtype=getattr(torch, s.sals.k_latent_dtype), **meta)
    bound = 0.0
    for pos in steps:
        sel = sum(max(0, int(p) - s.sals.n_recent - s.sals.n_sink + 1)
                  for p in pos)
        f, nb = cost.latent_topk_work(q_lat, k_lat, None,
                                      n_critical=s.sals.n_critical,
                                      selectable_rows=sel)
        bound += s.n_sals_layers * peaks.bound_seconds(f, nb)
    return 100.0 * bound / busy
