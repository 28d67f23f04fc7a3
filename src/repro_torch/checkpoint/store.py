"""Atomic checkpointing in the reference's on-disk layout (port of
``repro/checkpoint/store.py``).

Layout (one directory per step):

    <dir>/step_000123/
        manifest.json     — step, flat key list, shapes/dtypes, tree hash
        arrays.npz        — flattened pytree leaves keyed by path string
    <dir>/LATEST          — text file naming the newest complete step dir

The keys are the reference's pytree paths with layer-stacked arrays
(``params/blocks/attn/wq`` (L, d, qd), ``opt/mu/...``, ``opt/count``;
``convert.state_to_numpy``), so either package restores the other's
checkpoints.  bf16 leaves are written as f32 (exact; numpy without
``ml_dtypes`` has no bf16) and cast back to each tensor's dtype on
restore.

Write protocol: serialize into ``step_X.tmp/``, fsync, ``os.rename`` to the
final name (atomic on POSIX), then update LATEST.  A crash mid-write leaves
only a ``.tmp`` dir that restore ignores and the next save garbage-collects.
Restore copies into the tensors of ``like`` in place, on whatever device
they live, and with ``shardings`` places each leaf on a mesh.

Sharded trees: ``save`` gathers every DTensor leaf whole (a collective
each, so every rank calls it), rank 0 writes and the other ranks wait at a
barrier; ``restore(..., shardings=)`` lays each restored leaf out with
``distribute_tensor`` against its (mesh, placements), whatever mesh wrote
the checkpoint (elastic restore across world sizes).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np

import torch

from repro_torch.convert import state_load_, state_to_numpy
from repro_torch.distributed.sharding import gather, is_dtensor


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested numpy dict -> {"a/b/c": array}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, a in flat.items():
        node = tree
        *head, last = key.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = a
    return tree


def save(directory: str, step: int, tree, *, keep: int = 3,
         extra_meta: Optional[dict] = None) -> str:
    """Atomically write ``tree`` as checkpoint ``step``; prune to ``keep``.
    A tree with DTensor leaves is saved by every rank of the world: each
    leaf is gathered, rank 0 writes, the others wait at a barrier."""
    final = os.path.join(directory, f"step_{step:09d}")
    if _sharded(tree):
        import torch.distributed as dist
        arrays = _flatten(state_to_numpy(gather(tree)))
        if dist.get_rank() == 0:
            _write(directory, final, step, arrays, keep, extra_meta)
        dist.barrier()
        return final
    _write(directory, final, step, _flatten(state_to_numpy(tree)), keep,
           extra_meta)
    return final


def _sharded(tree) -> bool:
    if isinstance(tree, torch.nn.Module):
        return any(is_dtensor(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return any(_sharded(v) for v in tree.values())
    return is_dtensor(tree)


def _write(directory: str, final: str, step: int, arrays: dict, keep: int,
           extra_meta: Optional[dict]) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": {k: str(a.dtype) for k, a in arrays.items()},
        "tree_hash": hashlib.sha256(
            json.dumps(sorted(arrays.keys())).encode()).hexdigest()[:16],
        **(extra_meta or {}),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)

    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.rename(os.path.join(directory, "LATEST.tmp"),
              os.path.join(directory, "LATEST"))
    _gc(directory, keep)


def _gc(directory: str, keep: int) -> None:
    steps = list_checkpoints(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)
    for name in os.listdir(directory):
        if name.endswith(".tmp"):
            p = os.path.join(directory, name)
            (shutil.rmtree if os.path.isdir(p) else os.remove)(p)


def list_checkpoints(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, name, "manifest.json")):
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    """Newest COMPLETE checkpoint step.

    Fast path: the ``LATEST`` pointer (one read instead of a directory
    scan).  The pointer is advisory, never trusted: if it is missing,
    unparseable (a torn write), or DANGLING (it names a step dir that was
    pruned or never completed its manifest), fall back to scanning
    ``list_checkpoints`` — the manifest-verified ground truth.
    """
    pointer = os.path.join(directory, "LATEST")
    try:
        with open(pointer) as f:
            name = f.read().strip()
        if name.startswith("step_"):
            step = int(name[5:])
            if os.path.exists(os.path.join(directory, name,
                                           "manifest.json")):
                return step
    except (OSError, ValueError):
        pass                      # missing/corrupt pointer: scan instead
    steps = list_checkpoints(directory)
    return steps[-1] if steps else None


def restore(directory: str, like, step: Optional[int] = None,
            shardings=None):
    """Load checkpoint ``step`` (default: latest) into the tensors of
    ``like`` (a port tree: a train state, ``{"params": module}``, ...), in
    place.  ``shardings``: a tree over ``like`` whose leaves are (mesh,
    placements) pairs — a module's a {parameter name: pair} dict — each
    restored leaf then becomes a DTensor placed by its pair
    (``distribute_tensor``; every rank calls restore).  Returns (like,
    step), ``like`` with its placed leaves."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}
    try:
        state_load_(like, _unflatten(arrays))
    except KeyError as e:
        raise KeyError(f"checkpoint {path} missing keys: {e.args[0]}") \
            from None
    return _distribute(like, shardings), step


def _distribute(tree, shardings):
    """``tree``'s leaves placed by ``shardings`` (see :func:`restore`)."""
    if shardings is None:
        return tree
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, torch.nn.Module):
        for name, p in list(tree.named_parameters()):
            if name not in shardings:
                continue
            mesh, pl = shardings[name]
            owner_name, _, leaf = name.rpartition(".")
            owner = tree.get_submodule(owner_name) if owner_name else tree
            owner.register_parameter(leaf, torch.nn.Parameter(
                distribute_tensor(p.detach(), mesh, pl),
                requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, torch.Tensor):
        mesh, pl = shardings
        return distribute_tensor(tree.detach(), mesh, pl)
    return {k: _distribute(v, shardings.get(k)) for k, v in tree.items()}
