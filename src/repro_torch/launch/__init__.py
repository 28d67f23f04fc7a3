"""Launchers of the port (``launch.train``, ``launch.serve``) and the
config and device rules they and the examples share."""
from __future__ import annotations

import argparse

import torch

from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models.transformer import torch_dtype
from repro_torch.serve.engine import resolve_device


def add_device_args(ap: argparse.ArgumentParser) -> None:
    """``--device`` (the card unless ``cpu``) and ``--dtype`` (the
    weights': bf16 on the card, where the flash kernels take bf16; f32 on
    the CPU)."""
    ap.add_argument("--device", default="cuda",
                    help="the card unless 'cpu' is asked for")
    ap.add_argument("--dtype", default=None,
                    choices=("bfloat16", "float32"),
                    help="bfloat16 on the card, float32 on the CPU")


def device_and_dtype(args) -> tuple:
    """(torch.device, weights' torch.dtype) from :func:`add_device_args`'
    flags."""
    dev = resolve_device(args.device)
    return dev, torch_dtype(args.dtype or ("bfloat16" if dev.type == "cuda"
                                           else "float32"))


def model_config(arch: str, reduced: bool, device: torch.device,
                 log=print, who: str = "train", **overrides) -> ModelConfig:
    """The architecture's config, or with ``reduced`` its tiny same-family
    one (``overrides`` passed to ``reduced()``, e.g. ``n_layers=2``).  On
    the card a reduced head_dim below what the kernels take (the reduced
    configs' 32) is raised to 64, the smallest of the flash kernels'
    ``HEAD_DIMS`` (the recon kernel takes 64 too), and logged with the
    launcher's tag ``who``; the CPU keeps the reference's."""
    cfg = get_config(arch)
    if not reduced:
        if overrides:
            raise ValueError("overrides apply to the reduced config only")
        return cfg
    small = cfg.reduced(**overrides)
    if device.type == "cuda" and small.head_dim < min(HEAD_DIMS):
        small = cfg.reduced(**{**overrides, "head_dim": min(HEAD_DIMS)})
        log(f"[{who}] --reduced on the card: head_dim {small.head_dim} "
            f"(the kernels take {', '.join(map(str, HEAD_DIMS))})")
    return small
