"""Bytes of the decode cache's tensors (latent keys, quantized values and
their scales, the sink and recent windows, the full-precision layers'
K/V, the lengths) over the tokens the arena holds, from tensor sizes."""


def read(ctx, out):
    d = out.data
    if not d.get("cache_bytes"):
        return None
    return d["cache_bytes"] / d["cache_tokens"]
