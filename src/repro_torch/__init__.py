"""PyTorch/CUDA port of the SALS serving stack (the JAX package ``repro``
is the reference it is held against).  Importing this package loads no
kernel and imports neither JAX nor ``repro``."""
