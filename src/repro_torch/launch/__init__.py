"""Launchers of the port (``launch.train``, ``launch.serve``) and the
config rule they share."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import HEAD_DIMS


def model_config(arch: str, reduced: bool, device: torch.device,
                 log=print, who: str = "train") -> ModelConfig:
    """The architecture's config, or with ``reduced`` its tiny same-family
    one.  On the card a reduced head_dim below what the kernels take (the
    reduced configs' 32) is raised to 64, the smallest of the flash
    kernels' ``HEAD_DIMS`` (the recon kernel takes 64 too), and logged
    with the launcher's tag ``who``; the CPU keeps the reference's."""
    cfg = get_config(arch)
    if not reduced:
        return cfg
    small = cfg.reduced()
    if device.type == "cuda" and small.head_dim < min(HEAD_DIMS):
        small = cfg.reduced(head_dim=min(HEAD_DIMS))
        log(f"[{who}] --reduced on the card: head_dim {small.head_dim} "
            f"(the kernels take {', '.join(map(str, HEAD_DIMS))})")
    return small
