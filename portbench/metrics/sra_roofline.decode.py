"""The sparse reconstruction attention's share of its roofline, %: the
least time the card could take for every launch of the traced steps
(``yardstick/cost.py``'s ``recon_work`` at each launch's operands, the
valid selected rows as the launch sees them, over ``yardstick/peaks.py``)
over the device time of ``sra_kernel``."""
import torch

from portbench.yardstick import cost, peaks

KERNELS = r"sra_kernel|sra_f32_kernel"


def read(ctx, out):
    steps = out.data.get("traced_positions") or []
    if out.trace is None or not steps:
        return None
    busy = out.trace.seconds_matching(KERNELS)
    if busy <= 0:
        return None
    s, m = ctx.spec, ctx.mix
    sl = s.sals
    dt = s.torch_dtype
    b, n = m["rows"], m["max_seq_len"]

    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    groups = s.kv_dim // sl.v_group
    ops = (t((b, s.n_heads, s.head_dim), dt),
           t((b, n, s.r), getattr(torch, sl.k_latent_dtype)), None,
           t((b, n, s.kv_dim if sl.v_bits == 8 else s.kv_dim // 2),
             torch.int8 if sl.v_bits == 8 else torch.uint8),
           t((b, n, groups), torch.bfloat16), t((b, n, groups), torch.bfloat16),
           t((s.kv_dim, s.r), torch.bfloat16),
           t((b, sl.n_critical), torch.int32))
    bound = 0.0
    for pos in steps:
        valid = sum(min(sl.n_critical,
                        max(0, int(p) - sl.n_recent - sl.n_sink + 1))
                    for p in pos)
        f, nb = cost.recon_work(*ops, n_kv=s.n_kv_heads, valid_rows=valid)
        bound += s.n_sals_layers * peaks.bound_seconds(f, nb)
    return 100.0 * bound / busy
