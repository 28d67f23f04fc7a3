"""Share of the window's wall time under the port's ``prefill_chunk``
spans (the chunk program and its staging wait), %."""


def read(ctx, out):
    d = out.data
    if not d.get("spans"):
        return None
    a, b = d["t0"], d["t0"] + d["window_s"]
    inside = sum(max(0.0, min(t1, b) - max(t0, a))
                 for name, t0, t1, _ in d["spans"] if name == "prefill_chunk")
    return 100.0 * inside / (b - a)
