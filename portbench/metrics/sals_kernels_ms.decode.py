"""Device ms a decode step in the SALS kernels (the latent score pass, the
top-k selection, the sparse reconstruction attention), from the trace."""
SALS = r"latent_score_pass|topk_select_kernel|sra_kernel|sra_f32_kernel"


def read(ctx, out):
    n = len(out.data.get("traced_positions", []))
    if out.trace is None or not n:
        return None
    s = out.trace.seconds_matching(SALS)
    return s / n * 1e3 if s > 0 else None
