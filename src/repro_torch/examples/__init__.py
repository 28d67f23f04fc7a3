"""The port's examples (ports of the repository's ``examples/*.py``), each
run as ``python -m repro_torch.examples.<name>``:

* ``quickstart`` — calibrate U_r, prefill, SALS decode against full decode
  on a reduced yi-9b;
* ``multi_arch_smoke`` — one train step and (decoders) one decode step for
  every assigned architecture;
* ``train_then_serve`` — train a small dense model with checkpoints,
  calibrate SALS on its weights and serve requests through the scheduler;
* ``fault_tolerant_train`` — a run that crashes twice and recovers from
  its checkpoints to the uninterrupted run's weights.

Each keeps its reference's arguments and printed lines and adds the
launchers' ``--device`` (the card unless ``cpu``) and ``--dtype`` (bf16 on
the card, where the flash kernels take bf16; f32 on the CPU, as the
reference's examples).  ``main(argv=None, *, params=None, ...)`` takes its
weights as a Python argument, so a test can hand it the reference's, and
returns what it printed as numbers.
"""
from __future__ import annotations

import torch


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``bfloat16``, as the reference prints it."""
    return str(dtype).removeprefix("torch.")


def sync(device: torch.device) -> None:
    """Wait for the card's queued work before reading a wall clock."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
