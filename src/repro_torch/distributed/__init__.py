"""Distributed pieces of the port (port of ``repro/distributed/``): the
logical-axis sharding layer over a ``DeviceMesh`` and the int8
error-feedback gradient compression."""
from repro_torch.distributed.compression import (MIN_COMPRESS,
                                                 compressed_mean_grads,
                                                 dequantize_int8,
                                                 init_residual, quantize_int8,
                                                 wire_bytes)
from repro_torch.distributed.sharding import (P, ShardingCtx, constrain,
                                              current_ctx, default_rules,
                                              logical_spec, use_sharding)

__all__ = ["MIN_COMPRESS", "P", "ShardingCtx", "compressed_mean_grads",
           "constrain", "current_ctx", "default_rules", "dequantize_int8",
           "init_residual", "logical_spec", "quantize_int8", "use_sharding",
           "wire_bytes"]
