"""Logical-axis sharding (port of ``repro/distributed/sharding.py``): models
annotate activations with *logical* axis names; a context installed by the
launcher maps them to mesh axes of a ``torch.distributed`` ``DeviceMesh``.

This keeps model code mesh-agnostic (the same ``mlp_apply`` runs on one
GPU or across a node) while the launcher controls the parallelism layout
per (arch × shape) cell.  Parameters, optimizer state and caches are
``DTensor``s placed by these rules; DTensor's sharding propagation takes
the place of GSPMD between the annotated points, and :func:`constrain`
redistributes at them.

Logical axes
------------
  batch         global batch                  -> ("pod","data") / ("data",)
  seq           in-block sequence             -> None (full within TP block)
  residual_seq  residual stream between blocks-> "model" (Megatron SP) | None
  embed         d_model                       -> None
  heads         query heads                   -> "model"
  kv_heads      kv heads                      -> "model" when divisible
  mlp           FFN hidden                    -> "model"
  experts       MoE expert dim                -> "model"
  vocab         vocabulary                    -> "model"
  kv_seq        cached sequence (decode)      -> "model" | ("data","model")
  latent        SALS latent rank r            -> None

A spec (:class:`P`) has one entry per tensor dim: None, a mesh-axis name,
or a tuple of names (a composite, sharded over those mesh axes in mesh
order, row-major as JAX's).  :func:`placements` turns a spec into one
DTensor ``Placement`` per mesh dim.  The pure functions (:func:`fsdp_specs`,
:func:`sanitize_pspecs`, :func:`default_rules`, :func:`tree_shardings`)
read axis names and sizes from a ``DeviceMesh`` or a :class:`MeshConfig`,
so they need no process group.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import local_map as _lm

from repro_torch.config import MeshConfig, ShapeConfig

_state = threading.local()


class P(tuple):
    """Partition spec: one entry per tensor dim — None, a mesh-axis name,
    or a tuple of names (the port's ``PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _axes(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes: () for None."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def tree_map(fn, tree, *rest):
    """``fn`` over the spec leaves of nested dicts / lists (a port spec
    tree), with matching leaves of ``rest`` trees."""
    if _is_spec(tree) or not isinstance(tree, (dict, list)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return [tree_map(fn, v, *(r[i] for r in rest))
            for i, v in enumerate(tree)]


# ---------------------------------------------------------------------------
# Mesh geometry (DeviceMesh or MeshConfig)
# ---------------------------------------------------------------------------

def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, MeshConfig):
        return tuple(mesh.axis_names)
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh-axis name -> size."""
    if isinstance(mesh, MeshConfig):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_size(mesh) -> int:
    n = 1
    for s in axis_sizes(mesh).values():
        n *= s
    return n


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

@dataclass
class ShardingCtx:
    mesh: object                  # DeviceMesh
    rules: dict

    def spec(self, logical: Tuple[Optional[str], ...]) -> P:
        return P(*(None if name is None else self.rules.get(name)
                   for name in logical))


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, rules: dict):
    prev = current_ctx()
    _state.ctx = ShardingCtx(mesh, rules)
    try:
        yield _state.ctx
    finally:
        _state.ctx = prev


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def constrain(x, logical: Tuple[Optional[str], ...]):
    """Redistribute a DTensor to the placements the rules give
    ``logical``; the identity outside a context and on a plain tensor."""
    ctx = current_ctx()
    if ctx is None or not is_dtensor(x):
        return x
    if x.ndim != len(logical):
        raise ValueError(f"rank mismatch: {tuple(x.shape)} vs logical "
                         f"{logical}")
    spec = sanitize_pspecs(ctx.spec(logical), tuple(x.shape), ctx.mesh)
    want = placements(spec, ctx.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(ctx.mesh, want)


def logical_spec(logical) -> P:
    ctx = current_ctx()
    if ctx is None:
        return P(*([None] * len(logical)))
    return ctx.spec(logical)


def axis_size(ax, mesh=None) -> int:
    """Combined size of mesh axis ``ax`` (a name or a tuple of names) of
    ``mesh`` (default: the context's; 1 outside a context)."""
    if mesh is None:
        ctx = current_ctx()
        if ctx is None:
            return 1
        mesh = ctx.mesh
    sizes = axis_sizes(mesh)
    n = 1
    for a in _axes(ax):
        n *= sizes[a]
    return n


def mesh_axes_for(logical: str) -> Tuple[Tuple[str, ...], int]:
    """Physical mesh axes a logical axis maps to, and their combined size.

    Returns ((), 1) outside a sharding context or for an unsharded axis.
    The grouped decode plan reads it to decide whether the per-group
    kernels run shard-locally."""
    ctx = current_ctx()
    if ctx is None:
        return (), 1
    axes = _axes(ctx.rules.get(logical))
    return axes, axis_size(axes, ctx.mesh)


def axis_index(mesh, axes) -> int:
    """This rank's row-major index along ``axes`` (a name or tuple of
    names) of ``mesh``: the shard a composite placement gives it."""
    coord = mesh.get_coordinate()
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    i = 0
    for a in _axes(axes):
        i = i * sizes[a] + coord[names.index(a)]
    return i


# ---------------------------------------------------------------------------
# Default rule sets per run kind
# ---------------------------------------------------------------------------

def default_rules(mesh_cfg: MeshConfig,
                  shape_cfg: Optional[ShapeConfig] = None) -> dict:
    """Logical->physical mapping for one (mesh, shape) cell."""
    axes = mesh_cfg.axis_names
    data_axes = tuple(a for a in axes if a not in ("model",))
    batch = data_axes if len(data_axes) > 1 else \
        (data_axes[0] if data_axes else None)

    rules = {
        "batch": batch,
        "seq": None,
        "residual_seq": "model" if mesh_cfg.seq_parallel else None,
        "embed": None,
        "heads": "model",
        "kv_heads": None,
        "mlp": "model",
        "experts": "model",
        "vocab": "model",
        "kv_seq": "model",
        "kv_seq_full": None,   # skip-layer full-precision cache seq axis
        "latent": None,
    }

    if shape_cfg is not None and shape_cfg.kind == "decode":
        # decode: one-token steps — residual SP is pure overhead, and the
        # query heads are REPLICATED: the SALS cache is sequence-sharded
        # (single-head latents), so head-sharded q would gather every
        # selected-K block; one small q gather per layer replaces them
        rules["residual_seq"] = None
        rules["heads"] = None
        if shape_cfg.global_batch == 1:
            # long-context single stream: spread the cache over everything
            rules["batch"] = None
            rules["kv_seq"] = tuple(axes)
            rules["kv_seq_full"] = None    # build_decode overrides to
            # 'model' when the replicated skip cache would not fit
        else:
            rules["kv_seq"] = "model"
            rules["kv_seq_full"] = "model"
    return rules


# ---------------------------------------------------------------------------
# Spec derivation (pure)
# ---------------------------------------------------------------------------

def _shape(shaped) -> tuple:
    return tuple(shaped.shape) if hasattr(shaped, "shape") else \
        tuple(shaped)


def fsdp_specs(spec_tree, shape_tree, mesh, fsdp_axis="data"):
    """ZeRO-3-style weight sharding: for every param, shard the largest
    still-unsharded dim over ``fsdp_axis`` (when divisible).  DTensor then
    all-gathers each weight where it is used and reduce-scatters its
    gradient, and the optimizer state inherits the placement.

    spec_tree: tree of :class:`P` (TP placements from the ``*_specs``
    functions, or all-replicated for the pure-FSDP strategy);
    shape_tree: the matching tree of shapes (tensors, meta tensors or
    tuples); fsdp_axis: one mesh axis name or a tuple (composite, e.g.
    ("data", "model")), which degrades to its divisible prefix per
    param."""
    sizes = axis_sizes(mesh)
    axes = _axes(fsdp_axis)

    def one(spec: P, shaped) -> P:
        shape = _shape(shaped)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for p in parts for a in _axes(p)}
        free = tuple(a for a in axes if a not in used)
        best = None
        for i, (p, s) in enumerate(zip(parts, shape)):
            if p is not None:
                continue
            ax = list(free)
            while ax:                      # largest divisible prefix
                n = 1
                for a in ax:
                    n *= sizes[a]
                if s % n == 0 and s >= n:
                    break
                ax.pop()
            if ax and (best is None or s > shape[best[0]]):
                best = (i, ax)
        if best is not None:
            i, ax = best
            parts[i] = ax[0] if len(ax) == 1 else tuple(ax)
        return P(*parts)

    return tree_map(one, spec_tree, shape_tree)


def sanitize_pspecs(spec_tree, shape_tree, mesh):
    """Drop mesh axes from placements that don't divide the array dim:
    each placement is trimmed from the right until the dim divides,
    falling back to replication (granite's 49155 vocab on a 16-way axis
    stays whole)."""
    sizes = axis_sizes(mesh)

    def fix(spec: P, shaped) -> P:
        shape = _shape(shaped)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        for dim, p in zip(shape, parts):
            axes = _axes(p)
            while axes:
                n = 1
                for a in axes:
                    n *= sizes[a]
                if dim % n == 0:
                    break
                axes = axes[:-1]
            out.append(None if not axes else
                       axes[0] if len(axes) == 1 else tuple(axes))
        return P(*out)

    return tree_map(fix, spec_tree, shape_tree)


def placements(spec: P, mesh) -> tuple:
    """One DTensor ``Placement`` per mesh dim for ``spec``: ``Shard(d)`` on
    every mesh axis that tensor dim d's entry names (a composite
    ("data", "model") shards d on both, data-major as JAX's), else
    ``Replicate()``.  A composite out of mesh-axis order, or a mesh axis
    named twice, raises."""
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    seen = set()
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: no mesh axis {a!r} in "
                                 f"{names}")
            if a in seen:
                raise ValueError(f"spec {spec}: mesh axis {a!r} used twice")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: composite {axes} is out of "
                             f"mesh-axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def tree_shardings(mesh, spec_tree):
    """:class:`P` tree -> tree of placement tuples (one ``Placement`` per
    mesh dim, :func:`placements`)."""
    return tree_map(lambda s: placements(s, mesh), spec_tree)


# ---------------------------------------------------------------------------
# Placing tensors
# ---------------------------------------------------------------------------

def _placed(t: torch.Tensor, mesh, pl: tuple):
    if is_dtensor(t):
        return t.redistribute(mesh, tuple(pl))
    rep = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, tuple(pl))


def place(tree, mesh, pl_tree):
    """A port tree (the same full values on every rank) placed on ``mesh``
    by ``pl_tree``, a tree of placement tuples of the same structure
    (:func:`tree_shardings`; a module's is {parameter name: placements},
    a cache dataclass's {field: placements}).  Each rank keeps its own
    chunk; no collective.  Modules and dataclasses are updated in place
    (a parameter keeps its ``requires_grad``); returns the placed tree."""
    import dataclasses
    if pl_tree is None or tree is None:
        return tree
    if isinstance(tree, torch.nn.Module):
        for name, p in list(tree.named_parameters()):
            owner_name, _, leaf = name.rpartition(".")
            owner = tree.get_submodule(owner_name) if owner_name else tree
            owner.register_parameter(leaf, torch.nn.Parameter(
                _placed(p.detach(), mesh, pl_tree[name]),
                requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, torch.Tensor):
        return _placed(tree, mesh, pl_tree)
    if dataclasses.is_dataclass(tree):
        for f, pl in pl_tree.items():
            setattr(tree, f, place(getattr(tree, f), mesh, pl))
        return tree
    return {k: place(v, mesh, pl_tree[k]) if k in pl_tree else v
            for k, v in tree.items()}


def zeros_placed(like, mesh, pl_tree, device):
    """Zeros shaped as the meta tree ``like`` (dicts, cache dataclasses,
    tensors, modules) as DTensors placed by ``pl_tree``: each rank
    allocates its own block only (on ``device`` "meta", nothing).  A
    module's parameters are replaced in place, each keeping its
    ``requires_grad``."""
    import dataclasses
    if like is None:
        return None
    if isinstance(like, torch.nn.Module):
        for name, p in list(like.named_parameters()):
            owner_name, _, leaf = name.rpartition(".")
            owner = like.get_submodule(owner_name) if owner_name else like
            owner.register_parameter(leaf, torch.nn.Parameter(
                zeros_placed(p.detach(), mesh, pl_tree[name], device),
                requires_grad=p.requires_grad))
        return like
    if isinstance(like, torch.Tensor):
        shape = list(like.shape)
        for i, p in enumerate(pl_tree):
            if isinstance(p, Shard):
                shape[p.dim] //= mesh.shape[i]
        return DTensor.from_local(
            torch.zeros(shape, dtype=like.dtype, device=device), mesh,
            pl_tree, run_check=False)
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f: zeros_placed(getattr(like, f), mesh, pl, device)
            for f, pl in pl_tree.items()})
    return {k: zeros_placed(v, mesh, pl_tree[k], device)
            for k, v in like.items()}


def gather(tree):
    """Every DTensor of a port tree (modules, dicts, cache dataclasses) as
    its full tensor (a collective on each); plain tensors as they are.
    Returns a new tree of plain tensors (a module becomes {parameter
    name: tensor})."""
    import dataclasses
    if isinstance(tree, torch.nn.Module):
        return {k: gather(p.detach()) for k, p in tree.named_parameters()}
    if is_dtensor(tree):
        return tree.full_tensor()
    if isinstance(tree, torch.Tensor) or tree is None:
        return tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: gather(getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), (torch.Tensor, dict))})
    return {k: gather(v) for k, v in tree.items()}


def replicate_like(t: torch.Tensor, ref):
    """``t`` as a replicated DTensor on ``ref``'s mesh when ``ref`` is a
    DTensor (every rank makes the same ``t``), else ``t``: for tensors
    made fresh inside a function that meet DTensor operands."""
    if not is_dtensor(ref):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def replicated(t):
    """A DTensor made whole on every rank (Partial sums reduced); a plain
    tensor as it is."""
    if not is_dtensor(t):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def local_map(fn, out_placements, in_placements, mesh,
              in_grad_placements=None):
    """``torch.distributed.tensor.experimental.local_map`` with its
    inputs redistributed to ``in_placements`` (None entries pass plain
    values through); ``out_placements`` is one placement tuple (one
    output) or a tuple of them."""
    # local_map reads a tuple as one entry per output: one output's
    # placements go as a list
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = list(out_placements)
    else:
        out_placements = tuple(list(p) for p in out_placements)
    return _lm(fn, out_placements=out_placements,
               in_placements=in_placements,
               in_grad_placements=in_grad_placements, device_mesh=mesh,
               redistribute_inputs=True)


def dim_axes(dt, dim: int) -> Tuple[str, ...]:
    """Mesh axes (in mesh order) along which DTensor ``dt`` splits
    tensor dim ``dim``."""
    names = dt.device_mesh.mesh_dim_names
    return tuple(names[i] for i, p in enumerate(dt.placements)
                 if p == Shard(dim % dt.ndim))


def shard_range(dt, dim: int) -> Tuple[int, int]:
    """(start, length) of this rank's block of DTensor ``dt`` along
    ``dim`` (even splits, as sanitized specs give)."""
    axes = dim_axes(dt, dim)
    n = dt.shape[dim] // axis_size(axes, dt.device_mesh)
    return axis_index(dt.device_mesh, axes) * n, n


def rows_like(x, ref):
    """This rank's rows (dim 0) of DTensor ``x`` that match its block of
    ``ref``'s dim 0, every other dim whole, as a local tensor; a plain
    ``x`` as it is."""
    if not is_dtensor(x):
        return x
    want = tuple(Shard(0) if p == Shard(0) else Replicate()
                 for p in ref.placements)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return x.to_local()
