"""Mesh construction (port of ``repro/launch/mesh.py``).

Single node:  (data, model) over the ranks of the process group
Production:   (data=16, model=16) — 256 ranks; (pod=2, data=16, model=16)
              — 512 ranks

The 'model' axis carries TP/EP/SP collectives, 'data' the FSDP all-gather
/ reduce-scatter, 'pod' only the plain DP gradient all-reduce.  A mesh is
a ``torch.distributed`` ``DeviceMesh`` over an INITIALIZED process group:
nothing here starts one (``torchrun`` or the caller does, with its
address, world size and rank).
"""
from __future__ import annotations

import torch

from repro_torch.config import MeshConfig


def _world() -> int:
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group: start one "
                           "(torchrun, or init_process_group with an "
                           "address, world size and rank) before building "
                           "a mesh")
    return dist.get_world_size()


def _device_type(device) -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{need} ranks, not {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_mesh_config(*, multi_pod: bool = False, dist_mode: str = "local",
                     seq_parallel: bool = True) -> MeshConfig:
    return MeshConfig(
        shape=(2, 16, 16) if multi_pod else (16, 16),
        axis_names=("pod", "data", "model") if multi_pod
        else ("data", "model"),
        dist_mode=dist_mode,
        seq_parallel=seq_parallel,
    )


def make_host_mesh(max_devices: int = 0, device=None):
    """Degenerate (1, n) ("data", "model") mesh over the first n ranks of
    the initialized process group (n = the world, or ``max_devices``);
    ``device`` "cuda" (the default with a card) or "cpu" (gloo)."""
    n = _world()
    if max_devices:
        n = min(n, max_devices)
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(_device_type(device), torch.arange(n).reshape(1, n),
                      mesh_dim_names=("data", "model"))
