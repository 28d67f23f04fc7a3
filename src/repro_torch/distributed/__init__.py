"""Data-parallel pieces of the port (port of ``repro/distributed/``): so far
the int8 error-feedback gradient compression."""
from repro_torch.distributed.compression import (MIN_COMPRESS,
                                                 compressed_mean_grads,
                                                 dequantize_int8,
                                                 init_residual, quantize_int8,
                                                 wire_bytes)

__all__ = ["MIN_COMPRESS", "compressed_mean_grads", "dequantize_int8",
           "init_residual", "quantize_int8", "wire_bytes"]
