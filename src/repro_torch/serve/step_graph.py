"""One step program, captured once and replayed: the port's counterpart
of the reference's ``jax.jit(fn, donate_argnums=...)`` around
``ServeEngine._decode_impl``, its three siblings and
``_prefill_chunk_impl`` (``repro/serve/engine.py``).

``jax.jit`` compiles a step into one program that runs with one launch, and
``donate_argnums`` lets that program update the donated cache in place.
Here a step is Python that issues some 5,500 kernels one at a time
(``models/transformer.py``); on the card :class:`StepGraph` captures the
whole step into one CUDA graph and replays it.  The port's caches are
updated in place anyway, so what donation buys the reference the graph has
by construction: it writes the arena it was captured on.

A graph holds addresses, not tensors.  So:

* **inputs** — the small integer arguments (tokens, positions,
  ``n_accept``; a prefill chunk's tokens, offset and lengths) — are copied
  before each replay into int32 buffers the graph owns: from a pinned host
  staging buffer (a host array) or from the device tensor the caller
  passed.
* **state** — every other argument (the cache, a window's ``aux``) and
  what ``state()`` returns (the params and projectors) — keys the graph:
  the address, shape, stride and dtype of each tensor, and each other leaf
  (a page size).  A call whose key differs captures again.  The scheduler
  updates its arena in place, so one capture serves a whole run, and the
  chunk program's state is the engine's prefill workspace, so one capture
  serves every chunk of every request; ``generate`` builds a new cache per
  call, so it captures once per call.
* **outputs** are tensors the graph owns, overwritten by its next replay:
  a caller reads (samples) them before it calls again, and a window's
  ``aux`` stays untouched until the commit that reads it (only the window
  graph writes it).

The first call for a key runs the step eagerly on the capture stream.
That run is the call's own step, and the warm-up that makes everything
lazy exist before capture: the kernel library, cuBLAS's workspace on that
stream, ``kernels/sparse_recon_attention.py::rope_inv_freqs``'s cache.
Then the step is captured (a capture records, it runs nothing) and the
eager outputs are copied into the graph's, so a capture call leaves the
bytes of one eager step.  A replay repeats a step only where a caller
repeats it (the tiered fetch-and-rerun), which is safe because every write
of a step is a set at a fixed position (``core/latent_cache.py::
_put_token``).

Each graph has a memory pool of its own: a pool shared by graphs whose
replays interleave in another order than their captures could hand one
graph's intermediates the memory of another's live output.

Launch counters: the kernel wrappers count in Python, so a replay would
count nothing.  A capture takes back what its wrappers counted (nothing
ran) and each replay adds it (``kernels/ops.py::add_launch_counts``).

On the CPU the same object does all of it but the capture: it copies the
inputs into its buffers, runs the step on them and copies the results into
the outputs of the key's first call, so the CPU tests exercise the buffers
and the output aliasing.  A failed capture raises; nothing falls back to
eager.

Every program times its own calls, always (these are counters, not
``obs`` hooks).  Each call after the capture (on the CPU: after the key's
first call) records its host seconds in three phases: ``stage`` (the input
copies, the wait on the previous call's staging event included), ``key``
(:func:`_signature`) and
``launch`` (``graph.replay()`` and the launch counts; on the CPU the eager
step).  On the card a pair of timing events on the current stream, just
before and just after ``graph.replay()`` and outside the graph, gives the
replay's device time.  Each program object cycles through a pool of
:data:`EVENT_PAIRS` pairs; a pair is read when it comes round again, if
its end event has completed (never waited for), and a replay whose pair
is still pending goes untimed (``untimed`` counts them).  A program
object's pool leaves the table once the object is gone and its pairs are
read.
:func:`program_stats` (which first waits for and reads the pending pairs)
reads the records of a program by name, from a module-level table that
outlives the engines, as ``kernels/ops.py``'s launch counts do:
cumulative sums and the last :data:`RING` calls.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import time
import weakref
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops

_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}

RING = 4096           # calls a program's records keep (more than a window)
EVENT_PAIRS = 8       # timing event pairs a program object cycles through


class _Timing:
    """A pair of timing events around one replay; ``t`` (the call's
    ``perf_counter`` at its start) while it is pending, else None."""
    __slots__ = ("start", "end", "t")

    def __init__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.t: Optional[float] = None


class _Program:
    """One step program's records: sums over every call after its capture
    and the last :data:`RING` calls (host phases and device times), and
    the timing pairs of its program objects (each pool beside a weak
    reference to its object)."""

    def __init__(self):
        self.calls = self.timed = self.untimed = 0
        self.stage_s = self.key_s = self.launch_s = self.device_s = 0.0
        # (t, stage_s, key_s, launch_s); (t, device_s)
        self.host: Deque[tuple] = collections.deque(maxlen=RING)
        self.device: Deque[tuple] = collections.deque(maxlen=RING)
        self.pools: List[tuple] = []    # (weakref to a StepGraph, pool)

    def note(self, t: float, stage: float, key: float,
             launch: float) -> None:
        self.calls += 1
        self.host.append((t, stage, key, launch))
        self.stage_s += stage
        self.key_s += key
        self.launch_s += launch

    def read(self, tm: _Timing) -> None:
        """Read a completed pair and free it."""
        d = tm.start.elapsed_time(tm.end) * 1e-3
        self.device_s += d
        self.timed += 1
        self.device.append((tm.t, d))
        tm.t = None

    def drain(self) -> None:
        """Wait for each pending pair and read it, oldest first."""
        pending = sorted((tm for _, pool in self.pools for tm in pool
                          if tm.t is not None), key=lambda tm: tm.t)
        for tm in pending:
            tm.end.synchronize()
            self.read(tm)
        self.prune()

    def prune(self) -> None:
        """Read the completed pairs of program objects that are gone, and
        drop their pools once nothing of them is pending (never waits)."""
        kept = []
        for owner, pool in self.pools:
            if owner() is None:
                for tm in pool:
                    if tm.t is not None and tm.end.query():
                        self.read(tm)
                if all(tm.t is None for tm in pool):
                    continue
            kept.append((owner, pool))
        self.pools = kept


_PROGRAMS: Dict[str, _Program] = {}


def program_stats(name: str) -> Optional[dict]:
    """The records of step program ``name`` (None before its first call
    after a capture): ``calls``, ``timed`` and ``untimed`` replays, the
    sums in seconds (``stage_s``, ``key_s``, ``launch_s``, ``device_s``),
    and the last calls, ``host`` (dicts of ``t``, the call's
    ``perf_counter`` at its start, and the three host phases) and ``device`` (dicts of ``t`` and ``device_s``; empty on the
    CPU).  It first waits for the pending timing events: a reader after
    the work, never the hot path."""
    prog = _PROGRAMS.get(name)
    if prog is None:
        return None
    prog.drain()
    host_keys = ("t", "stage_s", "key_s", "launch_s")
    return {"calls": prog.calls, "timed": prog.timed,
            "untimed": prog.untimed,
            **{k: getattr(prog, k) for k in host_keys[1:] + ("device_s",)},
            "host": [dict(zip(host_keys, r)) for r in prog.host],
            "device": [{"t": t, "device_s": d} for t, d in prog.device]}


def reset_program_stats() -> None:
    """Forget every program's records (pending pairs are dropped)."""
    _PROGRAMS.clear()


def _leaves(tree, out: Optional[List[Any]] = None) -> List[Any]:
    """Leaves of a state tree (dicts, lists, tuples, dataclasses such as
    ``LatentKVCache``, ``nn.Module``s) in a fixed order, dict keys
    included.  (Plain recursion: a closure that calls itself is a
    reference cycle, which would hold every leaf until a garbage
    collection.)"""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, torch.nn.Module):
        out.extend(tree.parameters())
        out.extend(tree.buffers())
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out.append(k)
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _leaves(getattr(tree, f.name), out)
    else:
        out.append(tree)
    return out


def tree_tensors(tree) -> List[torch.Tensor]:
    """The tensors of a state tree, in :func:`_leaves`' order."""
    return [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]


def _signature(tree) -> tuple:
    """What a graph over ``tree`` depends on: each tensor's address, shape,
    stride and dtype, and every other leaf."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 if isinstance(t, torch.Tensor) else t
                 for t in _leaves(tree))


def copy_tree(dst, src) -> None:
    """Copy the tensors of ``src`` into those of ``dst`` (same tree)."""
    d, s = tree_tensors(dst), tree_tensors(src)
    if len(d) != len(s):
        raise RuntimeError(f"copy between trees of {len(d)} and {len(s)} "
                           "tensors")
    for a, b in zip(d, s):
        a.copy_(b)


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """Nodes of a captured graph (kept with ``keep_graph=True``), through
    ``cuGraphGetNodes`` of ``libcuda``."""
    lib = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                              ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes: CUDA error {err}")
    return n.value


class StepGraph:
    """``fn(*args)`` as one CUDA graph per key, replayed (see the module
    docstring).  ``name``: the program's name in :func:`program_stats`;
    ``inputs``: the positions of the integer arguments copied into the
    graph's buffers; ``state()``: what keys the graph besides the other
    arguments.

    Statistics: ``calls``, ``captures``, ``capture_s`` (host seconds spent
    capturing and instantiating, the eager step excluded), ``nodes`` (the
    current graph's), ``replays``."""

    def __init__(self, name: str, fn: Callable, device: torch.device,
                 inputs: Sequence[int],
                 state: Callable[[], Any] = lambda: None):
        self.name = name
        self.fn = fn
        self.device = torch.device(device)
        if self.on_cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.inputs = tuple(inputs)
        self.state = state
        self._bufs: Dict[int, torch.Tensor] = {}
        self._staging: Dict[int, torch.Tensor] = {}
        self._staged: Optional[torch.cuda.Event] = None
        self._key = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out = None
        self._counts: Dict[str, int] = {}
        self.calls = 0
        self.captures = 0
        self.capture_s = 0.0
        self.nodes = 0
        self.replays = 0
        self._pool: List[_Timing] = []  # timing pairs, cycled through
        self._pool_of: Optional[_Program] = None
        self._turn = 0                 # the timing pair due next
        self._raw_stream = None        # the current stream, cached
        self._stream: Optional[torch.cuda.Stream] = None

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    @torch.inference_mode()
    def __call__(self, *args):
        t0 = time.perf_counter()
        self.calls += 1
        args = list(args)
        for i in self.inputs:
            args[i] = self._stage(i, args[i])
        if self.on_cuda and self._staged is not None:
            self._staged.record()
        t1 = time.perf_counter()
        key = _signature((args, self.state()))
        t2 = time.perf_counter()
        if key != self._key:
            self._first(args, key)
            return self._out
        prog = _PROGRAMS.get(self.name)
        if prog is None:
            prog = _PROGRAMS[self.name] = _Program()
        if self.on_cuda:
            tm = self._timing(prog)
            if tm is not None:
                stream = self._current_stream()
                tm.start.record(stream)
            self._graph.replay()
            if tm is not None:
                tm.end.record(stream)
                tm.t = t0
            ops.add_launch_counts(self._counts)
            self.replays += 1
        else:
            copy_tree(self._out, self.fn(*args))
        prog.note(t0, t1 - t0, t2 - t1, time.perf_counter() - t2)
        return self._out

    def _timing(self, prog: _Program) -> Optional[_Timing]:
        """The pair of timing events due for this replay, the replay that
        last used it read first; None (the replay goes untimed) when that
        replay has not run yet.  A new pool for a new table, where the
        pools of program objects that are gone are pruned first."""
        if prog is not self._pool_of:
            self._pool = [_Timing() for _ in range(EVENT_PAIRS)]
            self._pool_of = prog
            prog.prune()
            prog.pools.append((weakref.ref(self), self._pool))
        tm = self._pool[self._turn % EVENT_PAIRS]
        if tm.t is not None:
            if not tm.end.query():
                prog.untimed += 1
                return None
            prog.read(tm)
        self._turn += 1
        return tm

    def _current_stream(self) -> torch.cuda.Stream:
        """The current stream of the program's device (the one a replay
        runs on), its object cached while the stream stays the same
        (``torch.cuda.current_stream`` took about 8 µs a call on an H100
        host, the raw handle a fraction of that)."""
        raw = torch._C._cuda_getCurrentRawStream(self.device.index)
        if raw != self._raw_stream:
            self._stream = torch.cuda.current_stream(self.device)
            self._raw_stream = raw
        return self._stream

    def _stage(self, i: int, value) -> torch.Tensor:
        """Copy integer input ``i`` (a host array, or a tensor on the
        engine's device) into its int32 buffer; returns the buffer."""
        on_dev = isinstance(value, torch.Tensor) and \
            value.device == self.device
        host = None if on_dev else np.asarray(value, np.int32)
        shape = tuple(value.shape) if on_dev else host.shape
        buf = self._bufs.get(i)
        if buf is None or tuple(buf.shape) != shape:
            buf = self._bufs[i] = torch.empty(shape, dtype=torch.int32,
                                              device=self.device)
            if self.on_cuda:
                self._staging[i] = torch.empty(shape, dtype=torch.int32,
                                               pin_memory=True)
        if on_dev:
            buf.copy_(value)
        elif not self.on_cuda:
            buf.copy_(torch.from_numpy(host))
        else:
            if self._staged is None:
                self._staged = torch.cuda.Event()
            else:
                # the copy out of the staging buffer from the previous call
                # must have run before the buffer is written again.  Each
                # step's caller reads the step's tokens on the host first,
                # so it has; the event makes it hold for any caller
                self._staged.synchronize()
            self._staging[i].numpy()[...] = host
            buf.copy_(self._staging[i], non_blocking=True)
        return buf

    def _first(self, args: list, key) -> None:
        """The first call for ``key``: the eager step, then (on the card)
        the capture.  The previous key's graph and outputs go first."""
        self._graph = self._out = self._key = None
        if not self.on_cuda:
            self._out = self.fn(*args)
            self._key = key
            return
        cur = torch.cuda.current_stream(self.device)
        cs = _CAPTURE_STREAMS.get(self.device)
        if cs is None:
            cs = _CAPTURE_STREAMS[self.device] = torch.cuda.Stream(
                self.device)
        cs.wait_stream(cur)
        with torch.cuda.stream(cs):
            eager = self.fn(*args)
        t0 = time.perf_counter()
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.stream(cs):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self.fn(*args)
                except BaseException:
                    # end the capture the error invalidated; the error is
                    # the one to report
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        finally:
            after = ops.launch_counts()
            self._counts = {k: after[k] - before[k] for k in after}
            ops.add_launch_counts({k: -v for k, v in self._counts.items()})
        self.nodes = graph_nodes(graph)
        graph.instantiate()
        with torch.cuda.stream(cs):
            copy_tree(out, eager)
        cur.wait_stream(cs)
        self._graph, self._out, self._key = graph, out, key
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
