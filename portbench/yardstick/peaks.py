"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit).  A frozen copy: the
benchmark divides by these, and no later change to the program moves
them.  A card set below 700 W runs slower under load, so every share
reported against these is reported beside the card's ``power.limit``."""

PEAK_BF16_FLOPS = 989e12     # tensor cores, bf16 / fp16
PEAK_F32_FLOPS = 67e12       # CUDA cores, float32
HBM_BYTES_PER_S = 3.35e12    # HBM3


def bound_seconds(flops: float, nbytes: float,
                  peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take for this work: the larger of
    operations over the peak rate and bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)
