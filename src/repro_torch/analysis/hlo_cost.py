"""Per-device cost of one step, counted as its ops run (port of
``repro/analysis/hlo_cost.py``).

Eager PyTorch has no HLO: nothing is compiled ahead, so there is no module
text to walk.  :func:`analyze_step` runs the step once under a
``TorchDispatchMode`` and counts every aten op as it runs, on whatever the
arguments live on (meta tensors cost nothing).  The accounting mirrors the
reference's walker:

  flops             ``torch.utils.flop_counter``'s per-op formulas, applied
                    to every matmul, convolution and attention op.
  bytes             operand bytes + result bytes of every aten op.  Eager
                    PyTorch fuses nothing, so every op reads its inputs and
                    writes its outputs through memory, as a top-level HLO
                    instruction does.  Views and ops that return no tensor
                    (metadata) count 0.
  collective_bytes  per-device wire traffic of every ``c10d_functional`` /
                    ``_c10d_functional`` (and ``c10d``) collective: result
                    bytes × 2 for all-reduce, × 1 otherwise.
  kernel wrappers   the work each ``kernels/ops.py`` wrapper records
                    (``kernels/cost.py``); the tensor ops inside a wrapper
                    (a twin on the CPU, its allocations) are not counted
                    again.

DTensor ops are handed back to DTensor (``NotImplemented``), whose local
ops and collectives then reach the mode on each rank's blocks: every
figure is PER DEVICE, as the reference's partitioned module is.  There
are no loops to multiply (``unknown_trip_counts`` is always 0).

The mode also follows the storages the step allocates (a weak reference
each) and reports the live bytes as the reference's ``memory_analysis``
keys: ``argument_bytes`` (the arguments' local tensors),
``output_bytes``, ``temp_bytes`` (the highest live total of the step's
own allocations) and ``peak_bytes`` (arguments + temps).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost

# collective op name -> (the reference's key, wire factor): result bytes
# x 2 for all-reduce (a ring sends and receives each shard twice), else 1.
# A point-to-point exchange is the reference's collective-permute, counted
# once, at the receive.
_COLLECTIVES = {
    "all_reduce": ("all-reduce", 2.0),
    "all_reduce_coalesced": ("all-reduce", 2.0),
    "allreduce_": ("all-reduce", 2.0),
    "allreduce_coalesced_": ("all-reduce", 2.0),
    "all_gather_into_tensor": ("all-gather", 1.0),
    "all_gather_into_tensor_coalesced": ("all-gather", 1.0),
    "allgather_": ("all-gather", 1.0),
    "_allgather_base_": ("all-gather", 1.0),
    "allgather_into_tensor_coalesced_": ("all-gather", 1.0),
    "reduce_scatter_tensor": ("reduce-scatter", 1.0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 1.0),
    "reduce_scatter_": ("reduce-scatter", 1.0),
    "_reduce_scatter_base_": ("reduce-scatter", 1.0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1.0),
    "all_to_all_single": ("all-to-all", 1.0),
    "alltoall_": ("all-to-all", 1.0),
    "alltoall_base_": ("all-to-all", 1.0),
    "broadcast": ("broadcast", 1.0),
    "broadcast_": ("broadcast", 1.0),
    "recv_": ("collective-permute", 1.0),
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
# ops that move no bytes of their own: allocation without a write, and
# the collectives' wait / autograd wrappers (aliases of their input)
_FREE = ("empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "wait_tensor", "_wrap_tensor_autograd")


@dataclasses.dataclass
class CostReport:
    flops: float = 0.0              # per-device
    bytes_accessed: float = 0.0     # per-device memory traffic estimate
    collective_bytes: float = 0.0   # per-device wire traffic
    collective_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    unknown_trip_counts: int = 0
    # analyze_step's: the memory_analysis keys, and the counted ops
    # {op or kernel name: [calls, flops, bytes]}
    memory: Dict[str, int] = dataclasses.field(default_factory=dict)
    ops: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def merged(self, other: "CostReport", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes_accessed += other.bytes_accessed * mult
        self.collective_bytes += other.collective_bytes * mult
        for k, v in other.collective_breakdown.items():
            self.collective_breakdown[k] = \
                self.collective_breakdown.get(k, 0.0) + v * mult
        for k, v in other.collective_counts.items():
            self.collective_counts[k] = \
                self.collective_counts.get(k, 0) + int(v * mult)
        self.unknown_trip_counts += other.unknown_trip_counts


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _tensors(tree):
    """Every tensor of a port tree (modules' parameters and buffers,
    dataclasses' fields, dicts, lists, tuples), DTensors as their local
    blocks."""
    if isinstance(tree, torch.Tensor):
        yield _local(tree)
    elif isinstance(tree, torch.nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            yield _local(t.detach())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _unique_bytes(tree) -> Tuple[int, set]:
    seen, total = set(), 0
    for t in _tensors(tree):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += _nbytes(t)
    return total, seen


class _OpCounter(TorchDispatchMode):
    """Counts each aten op's flops, bytes and collective bytes on plain
    (local) tensors; follows the storages it allocates."""

    def __init__(self, arg_storages: set):
        super().__init__()
        self.rep = CostReport()
        self.args = arg_storages
        self.live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.args or key in self.live:
                continue
            n = st.nbytes()
            self.live[key] = n
            self.live_bytes += n
            self.peak = max(self.peak, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _op(self, name: str, flops: float, nbytes: float) -> None:
        row = self.rep.ops.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs its local ops here
        out = func(*args, **kwargs)
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in leaves + tree_leaves(out)):
            return out      # DTensor's shape propagation, on global shapes
        self._track(out)
        if kcost.in_kernel():
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        name = func._opname
        if not outs or func.is_view or name in _FREE:
            return out
        pkt = func._overloadpacket
        flops = float(flop_registry[pkt](*args, **kwargs, out_val=out)) \
            if pkt in flop_registry else 0.0
        nbytes = sum(_nbytes(t) for t in outs) + sum(
            _nbytes(t) for t in leaves if isinstance(t, torch.Tensor))
        rep = self.rep
        rep.flops += flops
        rep.bytes_accessed += nbytes
        coll = _COLLECTIVES.get(name) \
            if func.namespace in _COLLECTIVE_NAMESPACES else None
        if coll is not None:
            key, factor = coll
            b = sum(_nbytes(t) for t in outs) * factor
            rep.collective_bytes += b
            rep.collective_breakdown[key] = \
                rep.collective_breakdown.get(key, 0.0) + b
            rep.collective_counts[key] = rep.collective_counts.get(key, 0) + 1
        self._op(str(pkt), flops, nbytes)
        return out


def analyze_step(fn, *args, **kw):
    """Run ``fn(*args, **kw)`` once, counting its work per device.  Returns
    (:class:`CostReport`, fn's output).  The backward of an autograd
    graph the step builds runs on the calling thread, so the kernel
    wrappers' records there reach this count too."""
    arg_bytes, arg_storages = _unique_bytes((args, kw))
    counter = kcost.Counter()
    mode = _OpCounter(arg_storages)
    with torch.autograd.set_multithreading_enabled(False), \
            kcost.counting(counter), mode:
        out = fn(*args, **kw)
    rep = mode.rep
    rep.flops += counter.flops
    rep.bytes_accessed += counter.bytes
    for name, (calls, flops, nbytes) in counter.by_kernel.items():
        rep.ops[name] = [calls, flops, nbytes]
    out_bytes, _ = _unique_bytes(out)
    rep.memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                  "temp_bytes": mode.peak,
                  "peak_bytes": arg_bytes + mode.peak}
    return rep, out
