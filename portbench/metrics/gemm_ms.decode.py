"""Device ms a decode step in the library's bf16 matrix products (the
cuBLAS / cuBLASLt GEMM and GEMV kernels of the projections, the MLP and
the unembedding), from the trace.  The f32 products of the full layers'
attention over their upcast cache are not projections and are left
out."""
import re

GEMM = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|splitKreduce")
F32 = re.compile(r"<float|f32f32|sgemm")


def read(ctx, out):
    n = len(out.data.get("traced_positions", []))
    if out.trace is None or not n:
        return None
    s = sum(b - a for name, a, b in out.trace.ops
            if GEMM.search(name) and not F32.search(name))
    return s / n * 1e3 if s > 0 else None
